"""The numbers that decide `correct`, each held to the limit the cell's
file states (`limits`), and the switch to the reference's precision.

Serve cells: `edit_rel_err`, over every image of the sampled batches, the
largest ||out - ref|| / ||ref - x||: the served image's distance from the
reference's, against the size of the edit the reference made to the input
x (the attention blend keeps most of x, which a plain relative error
would count as agreement).

Train cells (the first three steps, which set-up runs and the reference
follows), over the trainable leaves: `grad1_med`, the median leaf's gap
between the norms of the first gradient as Adam got it (from its first
moment after one step, the coupled decay taken off), against the
reference's norm of that leaf or of the median leaf, whichever is larger;
`change3_med`, the same for each leaf's change over the three steps (the
nets and their EMA copies), leaving out leaves whose reference gradient is
under a thousandth of the median leaf's (a conv bias before an instance
norm: Adam moves it by round-off alone).  The worst leaf's gaps (`grad1`,
`change3`) and the losses' (`loss`, `loss1`) are read too, for
calibration, with how the worst change's leaf differs in its first
gradient (`sign_flips`); a cell compares the numbers its `limits` name.
"""

from __future__ import annotations

import contextlib
import statistics
from typing import Dict, Iterable, Tuple

import torch

SMALL_GRAD = 1e-3


@contextlib.contextmanager
def plain_fp32():
    """TF32 off for the reference's float32 products and convolutions."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def edit_rel_err(out: torch.Tensor, ref: torch.Tensor, x: torch.Tensor) -> float:
    """The largest per-image ||out - ref|| / ||ref - x|| (NHWC batches)."""
    n = out.shape[0]
    num = (out.float() - ref.float()).reshape(n, -1).norm(dim=1)
    den = (ref.float() - x.float()).reshape(n, -1).norm(dim=1).clamp(min=1e-6)
    return float((num / den).max())


def norm_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              names: Iterable[str]) -> Dict[str, float]:
    """{leaf: the gap of its two norms over max(its reference norm, the
    median leaf's)}."""
    names = list(names)
    pn = {k: float(prog[k].float().norm()) for k in names}
    rn = {k: float(ref[k].float().norm()) for k in names}
    med = statistics.median(rn.values())
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in names}


def moved_leaves(grads: Dict[str, torch.Tensor]) -> list:
    """Leaves whose (reference) gradient is at least SMALL_GRAD of the
    median leaf's norm."""
    norms = {k: float(v.float().norm()) for k, v in grads.items()}
    med = statistics.median(norms.values())
    return [k for k, v in norms.items() if v >= SMALL_GRAD * med]


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """The train cells' numbers (module docstring) and the two worst
    leaves' names, from two records of {"losses": [{name: float}] per
    step, "grad1": {leaf: tensor}, "change3": {leaf: tensor}} (the change
    holds "ema:<leaf>" keys beside the nets' leaves)."""
    gaps = [max(abs(lp[k] - lr[k]) / max(abs(lr[k]), 1e-30) for k in lr)
            for lp, lr in zip(prog["losses"], ref["losses"])]
    g = norm_gaps(prog["grad1"], ref["grad1"], ref["grad1"].keys())
    moved = set(moved_leaves(ref["grad1"]))
    c = norm_gaps(prog["change3"], ref["change3"],
                  [k for k in ref["change3"] if k.split(":", 1)[-1] in moved])
    worst = lambda d: max(d, key=d.get)
    leaf = worst(c).split(":", 1)[-1]
    return {"loss": max(gaps), "loss1": gaps[0],
            "grad1": max(g.values()), "grad1_med": statistics.median(g.values()),
            "change3": max(c.values()), "change3_med": statistics.median(c.values()),
            "grad1_leaf": worst(g), "change3_leaf": worst(c),
            **{f"change3_leaf_{k}": v
               for k, v in sign_flips(prog["grad1"][leaf], ref["grad1"][leaf]).items()}}


def sign_flips(prog: torch.Tensor, ref: torch.Tensor) -> Dict[str, float]:
    """How one leaf's first gradient differs: its elements (`n`), the share
    whose sign the program has other than the reference (`flips`), the
    gap ||prog - ref|| / ||ref|| (`gap`), and the median |ref| of the
    flipped elements over the gap's root mean square (`flip_g_over_noise`:
    under 1, the flips sit where the gradient is under the precision's
    noise).  Adam's first steps move each element by about lr times the
    sign of its gradient, so a flip moves it the other way."""
    p, r = prog.float().flatten(), ref.float().flatten()
    noise = float((p - r).norm()) / max(r.numel(), 1) ** 0.5
    flipped = torch.sign(p) != torch.sign(r)
    out = {"n": float(r.numel()), "flips": float(flipped.float().mean()),
           "gap": float((p - r).norm() / r.norm().clamp(min=1e-30))}
    if flipped.any():
        out["flip_g_over_noise"] = float(r[flipped].abs().median()) / max(noise, 1e-30)
    return out


def held(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    """(every number within its limit, {name: {value, limit}})."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(v["value"] <= v["limit"] for v in checks.values()) and \
        all(v["value"] == v["value"] for v in checks.values())   # NaN fails
    return ok, checks
