"""The text encoder's recurrence kernels (`csrc/lstm_kernels.cu`,
`ops/cuda/kernels.py::lstm`, `lstm_bwd`) and the route to them
(`ops/lstm.py::MaskedBiLSTM.kernel_route`).

On the CPU: the plan's arithmetic at every shipped shape, the route (the
loop on the CPU and under a model axis), the wrappers' checks, and the
kernel route's arithmetic around the kernels, with their plain versions
(`recurrence_plain`, `recurrence_plain_bwd`) in the kernels' place, held
against the loop.  Marked `cuda` (they skip without a card), on a machine
with one (`--noconftest`: the suite's conftest imports JAX, which that
machine need not have):

    python -m pytest tests/test_torch_lstm_kernel.py -m cuda --noconftest -p no:cacheprovider

the kernel route against the loop at 1, 16, 32 and 40 rows (two clusters a
direction), 2 layers, H 300, input 364 (the flagship text encoder), lengths
up to 40, bf16 and fp32: outputs, final h and c, and the gradients of x,
w_ih, w_hh and the biases; the kernels against their plain versions; the
card-side bound on the loop (steps padded past the longest length)
bit-equal to the steps cut to it; two runs bit-equal; the ops dispatched at the served batch's shape; the launch
counters and the span's count; the plan's bytes against the kernels'.
"""

import copy
import math

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from dwcgan_tpu_torch.models import generator as generator_mod
from dwcgan_tpu_torch.ops import lstm as lstm_mod
from dwcgan_tpu_torch.ops.cuda import kernels
from dwcgan_tpu_torch.ops.lstm import (MaskedBiLSTM, recurrence_plain,
                                       recurrence_plain_bwd)

IN, HID, LAYERS = 364, 300, 2          # the flagship text encoder
SMEM_LIMIT = 227 * 1024                # a block's shared memory on the H100


def _lstm(seed: int, d_in=IN, hid=HID, layers=LAYERS) -> MaskedBiLSTM:
    """Weights of the scale the encoder trains at, with nonzero biases."""
    torch.manual_seed(seed)
    m = MaskedBiLSTM(d_in, hid, layers, dropout=0.0)
    with torch.no_grad():
        for name, p in m.named_parameters():
            p.normal_(0.0, 0.08 if "weight" in name else 0.2)
    return m


def _lengths(kind: str, rows: int, steps: int) -> torch.Tensor:
    """'mixed': some of length 1, the shortest below the longest; 'equal'."""
    if kind == "equal":
        return torch.full((rows,), steps, dtype=torch.int64)
    lens = [steps, 1] + [(7 * i) % steps + 1 for i in range(2, rows)]
    return torch.tensor(lens[:rows] if rows > 1 else [steps], dtype=torch.int64)


def _run(m: MaskedBiLSTM, x: torch.Tensor, lens: torch.Tensor, route=None):
    """Forward and backward of a fixed loss of all three outputs: the
    outputs, h, c, then the gradients of x and of every parameter."""
    m = copy.deepcopy(m).to(x.device)
    if route is not None:
        m.kernel_route = lambda device: route
    x = x.detach().clone().requires_grad_(True)
    out, h, c = m(x, lens)
    gen = torch.Generator().manual_seed(5)
    loss = sum((t.float() * torch.randn(t.shape, generator=gen).to(t.device)).sum()
               for t in (out, h, c))
    loss.backward()
    return [t.detach() for t in
            [out, h, c, x.grad] + [p.grad for _, p in m.named_parameters()]]


NAMES = ["out", "h", "c", "dx"] + [n for n, _ in _lstm(0, 4, 8, 2).named_parameters()]


# ----------------------------------------------------------------- the CPU

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows", [1, 2, 16, 17, 32, 64])
def test_plan_fits_at_every_shipped_shape(rows, dtype):
    """1 row (an edit) to 32 (a served batch) and beyond: the units cover H
    in whole 16-byte vectors, each pair of a cluster has its thread, and a
    block's shared memory stays within the H100's 227 KB."""
    plan = kernels.lstm_plan(rows, HID, dtype)
    align = 8 if dtype == torch.bfloat16 else 4
    assert plan.units % align == 0
    assert plan.k * plan.units >= HID > (plan.k - 1) * plan.units
    assert plan.k <= 16 and plan.rows in (16, 32) and plan.rows * plan.units <= 5 * 256
    assert plan.groups == math.ceil(rows / plan.rows)
    assert max(plan.smem, plan.smem_bwd) <= SMEM_LIMIT
    assert (plan.k, plan.units) == ((8, 40) if dtype == torch.bfloat16 else (15, 20))


def test_plan_shared_memory_by_hand():
    """bf16 at 32 rows: w [160][312], h [2][32][312], gates [32][168] fp32,
    the staged h [32][40]; the backward's w [304][168], dg [32][168] and
    the parts [2][8][32][40] fp32."""
    plan = kernels.lstm_plan(32, HID, torch.bfloat16)
    assert plan.smem == 160 * 312 * 2 + 2 * 32 * 312 * 2 + 32 * 168 * 4 + 32 * 40 * 2
    assert plan.smem_bwd == 304 * 168 * 2 + 32 * 168 * 2 + 2 * 8 * 32 * 40 * 4


def test_plan_refuses_what_it_cannot_take():
    with pytest.raises(TypeError):
        kernels.lstm_plan(4, HID, torch.float16)
    with pytest.raises(ValueError):
        kernels.lstm_plan(4, 2048, torch.bfloat16)   # w_hh rows past 227 KB
    with pytest.raises(ValueError):
        kernels.lstm_plan(0, HID, torch.bfloat16)


def test_route_follows_the_device_and_the_model_axis(monkeypatch):
    """CUDA without a model axis takes the kernels; the CPU and a model
    axis take the loop (decided without a card: nothing runs)."""
    m = _lstm(0, 4, 8)
    assert m.kernel_route(torch.device("cuda", 0)) and m.kernel_route("cuda")
    assert not m.kernel_route(torch.device("cpu"))
    monkeypatch.setattr(lstm_mod, "module_group", lambda module: object())
    assert not m.kernel_route(torch.device("cuda", 0))


def test_cpu_runs_the_loop(monkeypatch):
    """On the CPU the kernels are never called: the loop is unchanged."""
    def refuse(*args, **kw):
        raise AssertionError("the kernel route ran on the CPU")
    monkeypatch.setattr(kernels, "lstm", refuse)
    monkeypatch.setattr(kernels, "lstm_bwd", refuse)
    m = _lstm(1, 4, 8)
    got = _run(m, torch.randn(3, 6, 4), torch.tensor([6, 1, 4]))
    assert all(torch.isfinite(t).all() for t in got)


def test_encode_txt_span_counts_the_route():
    """`gen.encode_txt` carries `lstm_kernel`: 0 where the loop runs."""
    from dwcgan_tpu_torch.config import load_config
    from dwcgan_tpu_torch.utils import profiling
    cfg = load_config("configs/smoke.yaml")
    gen = generator_mod.build_generator(cfg, 40, device="cpu")
    with torch.no_grad():
        gen.encode_txt(torch.zeros(2, cfg.gen.style_dim),
                       torch.ones(2, 5, dtype=torch.int64), torch.tensor([5, 2]))
    span = [s for s in profiling.RECORDER.spans() if s.name == "gen.encode_txt"][-1]
    assert span.counts == {"lstm_kernel": 0}


def _cpu_tensors(dtype=torch.float32, b=3, steps=4, hid=8):
    return (torch.zeros(b, steps, 8 * hid, dtype=dtype),
            torch.zeros(2, 4 * hid, hid, dtype=dtype),
            torch.full((b,), steps, dtype=torch.int32))


@pytest.mark.parametrize("case,error", [
    ("float16", TypeError), ("mixed dtypes", TypeError), ("proj width", ValueError),
    ("w_hh shape", ValueError), ("int64 lengths", ValueError),
    ("lengths shape", ValueError), ("not contiguous", ValueError),
    ("cpu", ValueError)])
def test_wrapper_refuses_what_the_kernel_does_not_take(case, error):
    """Dtype and shape are checked before the device, so every refusal
    shows here; a tensor that passes them all is refused for the CPU."""
    proj, w_hh, lens = _cpu_tensors()
    if case == "float16":
        proj, w_hh = proj.half(), w_hh.half()
    elif case == "mixed dtypes":
        w_hh = w_hh.bfloat16()
    elif case == "proj width":
        proj = proj[..., :-8].contiguous()
    elif case == "w_hh shape":
        w_hh = w_hh[:, :-1].contiguous()
    elif case == "int64 lengths":
        lens = lens.long()
    elif case == "lengths shape":
        lens = lens[:-1]
    elif case == "not contiguous":
        proj = torch.zeros(proj.shape[::-1]).permute(2, 1, 0)
    with pytest.raises(error):
        kernels.lstm(proj, w_hh, lens)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lengths", [[9, 1, 4, 9, 6], [9, 9, 9, 9, 9], [3, 1, 2, 2, 1]])
def test_kernel_route_arithmetic_matches_the_loop(monkeypatch, dtype, lengths):
    """The kernel route with the kernels' plain versions in their place:
    both directions' input projections as one product, the reverse
    direction read in place, the gradient of proj and w_hh's one product
    over every (row, step).  Its outputs are bit-equal to the loop's (the
    same ops in the same order); fp32 gradients within 1e-6 of the largest
    (w_hh's summed over the steps in another order); bf16 gradients within
    4 ulps of the largest: the loop rounds w_hh's gradient at every step and
    x's once a direction before adding the two, the route each once."""
    monkeypatch.setattr(kernels, "lstm", recurrence_plain)
    monkeypatch.setattr(kernels, "lstm_bwd", recurrence_plain_bwd)
    m = _lstm(2, 7, 6)
    x = torch.randn(5, 11, 7).to(dtype)
    lens = torch.tensor(lengths)
    ref = _run(m, x, lens, route=False)
    got = _run(m, x, lens, route=True)
    tol = 1e-6 if dtype == torch.float32 else 2 ** -6
    for name, a, b in zip(NAMES, got, ref):
        if name in ("out", "h", "c"):
            assert torch.equal(a, b), name
        else:
            scale = b.float().abs().max()
            assert (a.float() - b.float()).abs().max() <= tol * scale, name


# ---------------------------------------------------------------- the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _dist(a: torch.Tensor, ref: torch.Tensor) -> float:
    ref = ref.double()
    return float((a.double() - ref).norm() / ref.norm().clamp_min(1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mixed", "equal"])
@pytest.mark.parametrize("rows", [1, 16, 32, 40])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_route_matches_the_loop(card, dtype, rows, kind):
    """40 rows take two clusters a direction.  fp32: every tensor within
    1e-5 of its largest element of the fp32 loop's (the recurrent product's
    sums in another order).  bf16: the
    kernel route and the loop both round at every op, at different points
    of the product's sums, so neither is held to the other's bits; each is
    held to the fp32 loop on the same inputs, and the kernel route may be no
    more than 1.1 times as far from it as the bf16 loop is (relative L2)."""
    steps = 40
    m = _lstm(3)
    gen = torch.Generator().manual_seed(rows)
    x = torch.randn(rows, steps + 3, IN, generator=gen).to(dtype).to(card)
    lens = _lengths(kind, rows, steps)
    got = _run(m, x, lens, route=True)
    loop = _run(m, x, lens, route=False)
    if dtype == torch.float32:
        for name, a, b in zip(NAMES, got, loop):
            err = float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
            assert err <= 1e-5, (name, err)
        return
    ref = _run(m, x.float(), lens, route=False)
    for name, a, b, r in zip(NAMES, got, loop, ref):
        dk, dl = _dist(a, r), _dist(b, r)
        assert dk <= 1.1 * dl, (name, dk, dl)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_their_plain_versions(card, dtype):
    """One step (h_0 = 0, so the product adds nothing): every output and
    saved tensor bit-equal to the plain version, whose cell rounds at the
    same ops; the backward within one rounding of it (torch's
    tanh_backward may round its inner product).  Forty steps: fp32 within
    1e-5 of the largest element; bf16 within the bf16 loop's own distance
    from fp32 of the same layer."""
    torch.manual_seed(4)
    b = 32
    w_hh = (torch.randn(2, 4 * HID, HID, device=card) * 0.08).to(dtype)
    for steps in (1, 40):
        proj = torch.randn(b, steps, 8 * HID, device=card).to(dtype)
        lens = torch.tensor(_lengths("mixed", b, steps).tolist(), dtype=torch.int32,
                            device=card)
        got = kernels.lstm(proj, w_hh, lens, save=True)
        want = recurrence_plain(proj, w_hh, lens, save=True)
        grads = [torch.randn(t.shape, device=card).to(dtype) for t in got[:3]]
        dk = kernels.lstm_bwd(w_hh, lens, got[3], got[4], *grads)
        dp = recurrence_plain_bwd(w_hh, lens, want[3], want[4], *grads)
        if steps == 1:
            for a, w in zip(got, want):
                assert torch.equal(a, w)
            torch.testing.assert_close(dk, dp, rtol=2 ** -7, atol=1e-6)
            continue
        if dtype == torch.float32:   # (acts and cs past a length are not written)
            for a, w in zip(got[:3] + (dk,), want[:3] + (dp,)):
                assert (a - w).abs().max() <= 1e-5 * w.abs().max()
            continue
        ref = recurrence_plain(proj.float(), w_hh.float(), lens, save=True)
        dref = recurrence_plain_bwd(w_hh.float(), lens, ref[3], ref[4],
                                    *[g.float() for g in grads])
        for a, w, r in zip(got[:3] + (dk,), want[:3] + (dp,), ref[:3] + (dref,)):
            assert _dist(a, r) <= 1.1 * _dist(w, r)


@pytest.mark.cuda
@pytest.mark.parametrize("rows, longest", [(16, 25), (32, 37), (40, 37)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_card_side_bound_matches_the_longest_length(card, dtype, rows, longest):
    """proj padded to 82 steps (the flagship text's width, what the graphed
    training step passes): each cluster stops at its rows' longest length,
    read on the card, so out, h, c, the saved acts and cs of every running
    (step, row) and proj's gradient are bit-equal to the call cut to the
    batch's longest length, and out and the gradient are zero past it.  At
    40 rows the second cluster's rows end earlier than the first's."""
    torch.manual_seed(6)
    width = 82
    w_hh = (torch.randn(2, 4 * HID, HID, device=card) * 0.08).to(dtype)
    proj = torch.randn(rows, width, 8 * HID, device=card).to(dtype)
    lens = torch.tensor(_lengths("mixed", rows, longest).tolist(), dtype=torch.int32,
                        device=card)
    d_out = torch.randn(rows, width, 2 * HID, device=card).to(dtype)
    d_h, d_c = (torch.randn(2, rows, HID, device=card).to(dtype) for _ in range(2))
    cut = kernels.lstm(proj[:, :longest].contiguous(), w_hh, lens, save=True)
    pad = kernels.lstm(proj, w_hh, lens, save=True)
    assert torch.equal(pad[0][:, :longest], cut[0]) and not pad[0][:, longest:].any()
    assert torch.equal(pad[1], cut[1]) and torch.equal(pad[2], cut[2])
    running = torch.arange(longest, device=card)[:, None] < lens[None, :]
    for a, b in zip(pad[3:], cut[3:]):
        assert torch.equal(a[:, :longest][:, running], b[:, running])
    dcut = kernels.lstm_bwd(w_hh, lens, cut[3], cut[4],
                            d_out[:, :longest].contiguous(), d_h, d_c)
    dpad = kernels.lstm_bwd(w_hh, lens, pad[3], pad[4], d_out, d_h, d_c)
    assert torch.equal(dpad[:, :longest], dcut) and not dpad[:, longest:].any()


@pytest.mark.cuda
def test_two_runs_are_bit_equal(card):
    """No atomics: forward and backward repeat bit for bit."""
    m = _lstm(5)
    x = torch.randn(32, 37, IN).bfloat16().to(card)
    lens = _lengths("mixed", 32, 37)
    first, second = _run(m, x, lens, route=True), _run(m, x, lens, route=True)
    for name, a, b in zip(NAMES, first, second):
        assert torch.equal(a, b), name


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.cuda
def test_ops_do_not_grow_with_the_length(card):
    """At the served batch's shape (32 rows, bf16, no gradient) the kernel
    route dispatches the same ops at 18 steps and at 37, 40 or fewer a
    layer (the loop: about a dozen a step)."""
    m = copy.deepcopy(_lstm(6)).to(card).eval()
    counts = []
    for steps in (18, 37):
        x = torch.randn(32, 40, IN, device=card).bfloat16()
        lens = torch.full((32,), steps)
        lens[::3] = max(1, steps - 9)
        with torch.inference_mode(), _Count() as count:
            m(x, lens)
        counts.append(count.ops)
    assert counts[0] == counts[1] <= 40 * LAYERS, counts


@pytest.mark.cuda
def test_launch_counters_tick_per_layer(card):
    """Two launches of `lstm` a forward (one a layer), two of `lstm_bwd` a
    backward."""
    m = _lstm(7)
    x = torch.randn(16, 25, IN).bfloat16().to(card)
    lens = _lengths("mixed", 16, 25)
    before = dict(kernels.LAUNCHES)
    with torch.no_grad():
        copy.deepcopy(m).to(card)(x, lens)
    assert kernels.LAUNCHES["lstm"] - before["lstm"] == 2
    assert kernels.LAUNCHES["lstm_bwd"] == before["lstm_bwd"]
    _run(m, x, lens)
    assert kernels.LAUNCHES["lstm"] - before["lstm"] == 4
    assert kernels.LAUNCHES["lstm_bwd"] - before["lstm_bwd"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [12, 100, HID])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_shared_memory_is_the_kernels(card, dtype, hidden):
    """`lstm_plan`'s bytes are what the kernels carve (csrc `Geo`)."""
    for rows in (1, 32):
        plan = kernels.lstm_plan(rows, hidden, dtype)
        code = int(dtype == torch.bfloat16)
        for bwd, want in ((0, plan.smem), (1, plan.smem_bwd)):
            got = kernels._lib().dwc_lstm_smem(hidden, plan.units, plan.rows, plan.k,
                                               code, bwd)
            assert got == want, (rows, bwd)


@pytest.mark.cuda
def test_encode_txt_span_counts_the_kernel_route(card):
    """On the card `gen.encode_txt` carries `lstm_kernel` 1, and launches
    the recurrence once a layer."""
    from dwcgan_tpu_torch.config import load_config
    from dwcgan_tpu_torch.utils import profiling
    cfg = load_config("configs/smoke.yaml")
    gen = generator_mod.build_generator(cfg, 40, device=card)
    before = kernels.LAUNCHES["lstm"]
    with torch.no_grad():
        gen.encode_txt(torch.zeros(2, cfg.gen.style_dim, device=card),
                       torch.ones(2, 5, dtype=torch.int64, device=card),
                       torch.tensor([5, 2]))
    span = [s for s in profiling.RECORDER.spans() if s.name == "gen.encode_txt"][-1]
    assert span.counts == {"lstm_kernel": 1}
    assert kernels.LAUNCHES["lstm"] - before == cfg.gen.num_layers


@pytest.mark.cuda
def test_card_refuses_what_the_kernel_does_not_take(card):
    """A CUDA tensor the kernel does not take raises; nothing falls back."""
    m = copy.deepcopy(_lstm(8, 12, 16)).to(card)
    with pytest.raises(TypeError):
        m(torch.zeros(2, 3, 12, device=card, dtype=torch.float16), torch.tensor([3, 1]))
    proj, w_hh, lens = (t.to(card) for t in _cpu_tensors())
    with pytest.raises(ValueError):
        kernels.lstm(proj, w_hh, lens[:-1])
