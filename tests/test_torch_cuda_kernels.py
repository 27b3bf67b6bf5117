"""The hand-written CUDA norm kernels against their plain PyTorch versions,
on the card.  Marked `cuda`: without a card every test here skips.  On a
machine with one (`--noconftest`: the suite's conftest imports JAX, which
that machine need not have):

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda --noconftest -p no:cacheprovider

fp32 within atol 1e-4 (summation order only); bf16 within 2 bf16 ulps of
the rounded fp32 plain result plus that atol.  Shapes are small and ragged
(rows not a multiple of a block's row chunk; channel counts 8 to 256); the
cluster kernels (the instance norm, AdaIN and the reference LayerNorm,
forward and backward) are also held at every shape of the flagship serving
batch and training step, run twice (bit-equal), one CUDA kernel a call,
with the backward's recomputed ReLU mask counted against the forward's
y > 0; the LayerNorm also bit-equal across CUDA-graph replays.
"""

import pytest
import torch

from dwcgan_tpu_torch.ops import norms
from dwcgan_tpu_torch.ops.cuda import kernels

pytestmark = pytest.mark.cuda

SHAPES = [(3, 64, 12, 12), (2, 256, 5, 7), (1, 8, 33, 3)]
OPS = ["instance_norm", "adain", "adain_residual", "layer_norm_ref"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _args(op, shape, dtype, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    n, c = shape[:2]

    def act():
        x = torch.randn(shape, generator=g, device=dev) * 1.5 + \
            torch.randn(n, c, 1, 1, generator=g, device=dev)
        return x.to(dtype).contiguous(memory_format=torch.channels_last)

    vec = lambda *s: torch.randn(*s, generator=g, device=dev)
    return {"instance_norm": lambda: (act(),),
            "adain": lambda: (act(), 1 + 0.2 * vec(n, c), 0.2 * vec(n, c)),
            "adain_residual": lambda: (act(), act(), 1 + 0.2 * vec(n, c),
                                       0.2 * vec(n, c)),
            "layer_norm_ref": lambda: (act(), vec(c).abs(), vec(c))}[op]()


def _call(table, op, args, relu, stats):
    if op in ("instance_norm", "adain"):
        return table[op](*args, relu=relu, stats=stats)
    return table[op](*args, stats=stats)


PUBLIC = {"instance_norm": norms.instance_norm, "adain": norms.adain,
          "adain_residual": norms.adain_residual,
          "layer_norm_ref": norms.layer_norm_ref}
# the kernels themselves, (y, stats), with `stats` as the public ops take it
KERNEL_CALLS = {
    "instance_norm": lambda x, relu, stats: kernels.instance_norm(
        x, relu=relu, two_pass=stats == "2pass"),
    "adain": lambda x, s, b, relu, stats: kernels.adain(
        x, s, b, relu=relu, two_pass=stats == "2pass"),
    "adain_residual": lambda x, y, s, b, stats: kernels.adain_residual(
        x, y, s, b, two_pass=stats == "2pass"),
    "layer_norm_ref": lambda x, g, b, stats: kernels.layer_norm_ref(
        x, g, b, two_pass=stats == "2pass")}
PLAIN = {"instance_norm": norms.instance_norm_plain, "adain": norms.adain_plain,
         "adain_residual": norms.adain_residual_plain,
         "layer_norm_ref": norms.layer_norm_ref_plain}


def _ulp(r):
    _, e = torch.frexp(r.float().abs())
    ulp = torch.ldexp(torch.ones_like(r, dtype=torch.float32), (e - 8).float())
    return torch.where(r == 0, torch.zeros_like(ulp), ulp)


@pytest.mark.parametrize("stats", ["2pass", "1pass"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("op,relu", [(op, False) for op in OPS]
                         + [("instance_norm", True), ("adain", True)])
def test_kernel_matches_plain(card, op, relu, shape, dtype, stats):
    args = _args(op, shape, dtype, card, 0)
    before = kernels.LAUNCHES[op]
    out = _call(PUBLIC, op, args, relu, stats)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[op] == before + 1
    _assert_forward_close(op, args, out, relu, stats)


def _assert_forward_close(op, args, out, relu, stats):
    """A forward kernel's output against its plain version in fp32, within
    the tolerances of the module's docstring."""
    dtype = args[0].dtype
    assert out.dtype == dtype and out.is_contiguous(memory_format=torch.channels_last)
    args32 = tuple(a.float() for a in args)
    ref = _call(PLAIN, op, args32, relu, stats)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
    else:
        extra = 0.0
        if op == "adain_residual":
            # the reference adds AdaIN(y) already rounded to bf16; the
            # kernel's fp32 AdaIN(y), summed in another order, may round to
            # the neighbouring bf16 value: one ulp of it more
            t = norms.adain_plain(*args32[1:], stats=stats).to(torch.bfloat16)
            ref, extra = args32[0] + t.float(), _ulp(t)
        r = ref.to(torch.bfloat16)
        err = (out.float() - r.float()).abs()
        assert bool((err <= 2 * _ulp(r) + 1e-4 + extra).all()), float(err.max())


def test_wrappers_refuse_what_they_do_not_take(card):
    x = _args("instance_norm", (2, 64, 4, 4), torch.float32, card, 1)[0]
    with pytest.raises(ValueError, match="channels_last"):
        kernels.instance_norm(x.contiguous())
    with pytest.raises(TypeError):
        kernels.instance_norm(x.half())
    with pytest.raises(ValueError, match="channels"):
        kernels.instance_norm(torch.zeros(2, 6, 4, 4, device=card).contiguous(
            memory_format=torch.channels_last))
    s = torch.ones(2, 64, device=card)
    with pytest.raises(ValueError, match="parameter"):
        kernels.adain(x, s.double(), s)
    g = torch.zeros_like(x)
    st = kernels.instance_norm(x)[1]
    with pytest.raises(ValueError, match="match"):
        kernels.instance_norm_bwd(x, g[:1].contiguous(memory_format=torch.channels_last), st)
    with pytest.raises(ValueError, match="parameter"):
        kernels.instance_norm_bwd(x, g, st[:1])


def test_generator_on_the_card_matches_the_cpu(card):
    from dwcgan_tpu_torch.config import load_config
    from dwcgan_tpu_torch.models.generator import build_generator
    from dwcgan_tpu_torch.train.sampler import make_infer_fn
    torch.backends.cudnn.allow_tf32 = False
    try:
        cfg = load_config("configs/smoke.yaml")
        cpu = build_generator(cfg, 102, device="cpu", seed=0)
        gpu = build_generator(cfg, 102, device=card, seed=0)
        g = torch.Generator().manual_seed(0)
        x = torch.rand(3, 32, 32, 3, generator=g) * 2 - 1
        ids = torch.randint(4, 102, (3, 9), generator=g)
        lens = torch.tensor([9, 4, 1])
        want = make_infer_fn(cfg, cpu)(x, ids, lens)
        got = make_infer_fn(cfg, gpu)(x.to(card), ids.to(card), lens)
        torch.testing.assert_close(got.cpu(), want, atol=2e-3, rtol=0)
    finally:
        torch.backends.cudnn.allow_tf32 = True


BWD = {"instance_norm": "instance_norm_bwd", "adain": "adain_bwd",
       "adain_residual": "adain_residual_bwd",
       "layer_norm_ref": "layer_norm_ref_bwd"}


def _plain_grads(op, args, relu, stats, y, g):
    """The plain backward of `op` at fp32 copies of `args`, with the ReLU
    mask taken from the kernel's forward output `y` (as the kernel does)."""
    a = [t.float() for t in args]
    mask = y.float() if relu else None
    if op == "instance_norm":
        return (norms.instance_norm_bwd_plain(a[0], g.float(), mask, stats),)
    if op == "adain":
        return norms.adain_bwd_plain(a[0], a[1], g.float(), mask, stats)
    if op == "adain_residual":
        dy, ds, db = norms.adain_bwd_plain(a[1], a[2], g.float(), None, stats)
        return g.float(), dy, ds, db
    return norms.layer_norm_ref_bwd_plain(a[0], a[1], g.float(), stats)


@pytest.mark.parametrize("stats", ["2pass", "1pass"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("op,relu", [(op, False) for op in OPS]
                         + [("instance_norm", True), ("adain", True)])
def test_backward_kernel_matches_plain(card, op, relu, shape, dtype, stats):
    """Gradients through the public op (the backward kernel) against the
    plain backward: fp32 within 1e-4 of the largest gradient of each
    output (summation order only), bf16 within 2 % of it (the incoming
    gradient and dx round to bf16; the plain side is fp32 throughout)."""
    args = [a.detach().requires_grad_() for a in _args(op, shape, dtype, card, 1)]
    out = _call(PUBLIC, op, args, relu, stats)
    g = torch.randn(out.shape, device=card).to(dtype).contiguous(
        memory_format=torch.channels_last)
    before = kernels.LAUNCHES[BWD[op]]
    got = torch.autograd.grad(out, args, g)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[BWD[op]] == before + 1
    want = _plain_grads(op, args, relu, stats, out.detach(), g)
    rel = 1e-4 if dtype == torch.float32 else 2e-2
    for a, w in zip(got, want):
        scale = float(w.abs().max())
        err = float((a.float() - w.float()).abs().max())
        assert err <= rel * scale + 1e-6, (err, scale)


# -------------------------------- the instance-norm and AdaIN backward kernel

# (n, c, h, w): the instance-norm and AdaIN backward sites of one flagship
# training step at batch 16 (chip_smoke.py's BWD_SITES), then ragged shapes:
# one sample, 7 x 9 pixels, fewer pixels than blocks in a cluster (5, 6, 1),
# 8 and 16 channels
CLUSTER_SHAPES = [(16, 64, 128, 128), (48, 64, 128, 128), (16, 128, 64, 64),
                  (48, 128, 64, 64), (16, 256, 32, 32), (48, 256, 32, 32),
                  (64, 256, 32, 32), (16, 512, 16, 16), (1, 64, 12, 12),
                  (2, 16, 7, 9), (3, 8, 1, 5), (1, 8, 2, 3), (2, 16, 1, 1)]
# (forward op, fused relu): the ReLU on and off, and the residual form
CLUSTER_OPS = [("instance_norm", True), ("instance_norm", False), ("adain", True),
               ("adain", False), ("adain_residual", False)]


def _cluster_case(op, relu, shape, dtype, stats, dev, seed):
    """The forward kernel's output and statistics at `shape`, an incoming
    gradient, and a function that runs the backward kernel on them."""
    args = _args(op, shape, dtype, dev, seed)
    two_pass = stats == "2pass"
    if op == "instance_norm":
        out, st = kernels.instance_norm(args[0], relu=relu, two_pass=two_pass)
        run = lambda g: (kernels.instance_norm_bwd(args[0], g, st, relu=relu),)
    elif op == "adain":
        out, st = kernels.adain(*args, relu=relu, two_pass=two_pass)
        run = lambda g: kernels.adain_bwd(args[0], g, st, args[1], args[2], relu=relu)
    else:
        out, st = kernels.adain_residual(*args, two_pass=two_pass)
        run = lambda g: kernels.adain_bwd(args[1], g, st, args[2], residual=True)
    g = torch.randn(out.shape, generator=torch.Generator(device=dev).manual_seed(seed + 1),
                    device=dev).to(dtype).contiguous(memory_format=torch.channels_last)
    return args, out, st, g, run


@pytest.mark.parametrize("stats", ["2pass", "1pass"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op,relu", CLUSTER_OPS)
@pytest.mark.parametrize("shape", CLUSTER_SHAPES)
def test_cluster_backward_matches_plain(card, shape, op, relu, dtype, stats):
    """The one-launch backward against the plain backward (the mask from the
    forward kernel's y > 0): fp32 within 1e-4 of each gradient's largest
    magnitude, bf16 within 2 %, as chip_smoke.py's phase 5; a second run
    bit-equal, dx and dscale / dbias; the mask the kernel recomputes from x
    agrees with y > 0 at every element."""
    args, out, st, g, run = _cluster_case(op, relu, shape, dtype, stats, card, 3)
    counter = BWD[op]
    before = kernels.LAUNCHES[counter]
    got = run(g)
    again = run(g)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[counter] == before + 2
    want = _plain_grads(op, args, relu, stats, out, g)
    if op == "adain_residual":
        want = want[1:]   # the kernel's are y's; x's gradient is g itself
    rel = 1e-4 if dtype == torch.float32 else 2e-2
    for a, b, w in zip(got, again, want):
        assert torch.equal(a, b)
        scale = float(w.abs().max())
        err = float((a.float() - w.float()).abs().max())
        assert torch.isfinite(a).all() and err <= rel * scale + 1e-6, (err, scale)
    if relu:
        affine = args[1:3] if op == "adain" else ()
        assert kernels.relu_mask_mismatches(args[0], out, st, *affine) == 0


def test_cluster_backward_is_one_kernel_per_call(card):
    """One call of each backward at a training-step shape launches exactly
    one CUDA kernel (chip_smoke.py's count of the kernel nodes of a CUDA
    graph of one call), the LayerNorm's too, in both dtypes."""
    import chip_smoke
    for op, relu in CLUSTER_OPS:
        _, _, _, g, run = _cluster_case(op, relu, (16, 256, 32, 32), torch.bfloat16,
                                        "1pass", card, 4)
        assert chip_smoke.kernels_per_call(lambda: run(g)) == 1, (op, relu)
    for dtype in (torch.float32, torch.bfloat16):
        x, gamma, beta = _args("layer_norm_ref", (16, 128, 64, 64), dtype, card, 4)
        _, st = kernels.layer_norm_ref(x, gamma, beta)
        assert chip_smoke.kernels_per_call(
            lambda: kernels.layer_norm_ref_bwd(x, x, st, gamma)) == 1, dtype


# the serving batch's shapes of rows 1-3 (chip_smoke.py's SITES), then the
# training step's and the ragged ones of the backward
FWD_CLUSTER_SHAPES = [(32, 64, 128, 128), (32, 128, 64, 64),
                      (32, 256, 32, 32)] + CLUSTER_SHAPES


@pytest.mark.parametrize("stats", ["2pass", "1pass"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op,relu", CLUSTER_OPS)
@pytest.mark.parametrize("shape", FWD_CLUSTER_SHAPES)
def test_cluster_forward_matches_plain(card, shape, op, relu, dtype, stats):
    """The one-launch forward of rows 1-3 against its plain version, as
    `test_kernel_matches_plain`; a second run bit-equal, y and the
    statistics."""
    args = _args(op, shape, dtype, card, 5)
    got = _call(KERNEL_CALLS, op, args, relu, stats)
    again = _call(KERNEL_CALLS, op, args, relu, stats)
    torch.cuda.synchronize()
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    _assert_forward_close(op, args, got[0], relu, stats)


def test_cluster_forward_is_one_kernel_per_call(card):
    """One call of each forward of rows 1-4 at a serving and a training
    shape launches exactly one CUDA kernel, in both stats modes; the
    LayerNorm's also in fp32."""
    import chip_smoke
    for shape in ((32, 64, 128, 128), (16, 256, 32, 32)):
        for op, relu in CLUSTER_OPS + [("layer_norm_ref", False)]:
            for stats in ("1pass", "2pass"):
                args = _args(op, shape, torch.bfloat16, card, 6)
                assert chip_smoke.kernels_per_call(
                    lambda: _call(KERNEL_CALLS, op, args, relu, stats)) == 1, (op, relu)
    args = _args("layer_norm_ref", (16, 128, 64, 64), torch.float32, card, 6)
    for stats in ("1pass", "2pass"):
        assert chip_smoke.kernels_per_call(
            lambda: _call(KERNEL_CALLS, "layer_norm_ref", args, False, stats)) == 1


def test_cluster_forward_phase_trace(card):
    """`kernels.fwd_trace`: six readings of the card's clock per block of
    one forward call, in order; the call's output is the untraced one's."""
    x = _args("instance_norm", (4, 64, 16, 16), torch.bfloat16, card, 8)[0]
    traced = []
    t = kernels.fwd_trace(lambda: traced.extend(kernels.instance_norm(x, relu=True)), x)
    assert t.shape == (4, kernels.fwd_plan(4, 256, 64, torch.bfloat16).k, 6)
    assert bool((t[..., 0] > 0).all()) and bool((t[..., 1:] >= t[..., :-1]).all())
    y, st = kernels.instance_norm(x, relu=True)
    assert torch.equal(y, traced[0]) and torch.equal(st, traced[1])


def test_cluster_forward_refuses_what_its_plan_cannot_take(card):
    n, c = 70000, 8   # more samples than a grid's second dimension takes
    x = torch.zeros(n, c, 1, 1, device=card).contiguous(memory_format=torch.channels_last)
    s = torch.ones(n, c, device=card)
    with pytest.raises(ValueError, match="plan"):
        kernels.instance_norm(x)
    with pytest.raises(ValueError, match="plan"):
        kernels.adain(x, s, s)
    with pytest.raises(ValueError, match="plan"):
        kernels.adain_residual(x, x, s, s)
    with pytest.raises(ValueError, match="plan"):
        kernels.layer_norm_ref(x, s[0], s[0])


def test_cluster_backward_refuses_what_its_plan_cannot_take(card):
    n, c = 70000, 8   # more samples than a grid's second dimension takes
    x = torch.zeros(n, c, 1, 1, device=card).contiguous(memory_format=torch.channels_last)
    st = torch.zeros(n, 2, c, device=card)
    with pytest.raises(ValueError, match="plan"):
        kernels.instance_norm_bwd(x, x, st)
    with pytest.raises(ValueError, match="plan"):
        kernels.adain_bwd(x, x, st, torch.ones(n, c, device=card))
    with pytest.raises(ValueError, match="plan"):
        kernels.layer_norm_ref_bwd(x, x, st, torch.ones(c, device=card))


# ------------------------------------- the reference LayerNorm's cluster kernels

# (n, c, h, w, dtype): the LayerNorm's serving sites (batch 32) and training
# sites (decode at 4n, the cycle at n, n 16), both dtypes; then ragged ones:
# rows not a multiple of a cluster's blocks, fewer pixels than blocks, one
# sample, c 8 in bf16 (one 16-byte group) and c 4 in fp32
LN_SITES = [(32, 128, 64, 64), (32, 64, 128, 128), (64, 128, 64, 64),
            (64, 64, 128, 128), (16, 128, 64, 64), (16, 64, 128, 128)]
LN_CASES = [s + (d,) for s in LN_SITES for d in (torch.float32, torch.bfloat16)] + [
    (1, 8, 7, 9, torch.bfloat16), (2, 8, 33, 3, torch.float32), (3, 4, 5, 7, torch.float32),
    (2, 16, 1, 5, torch.bfloat16), (1, 64, 13, 11, torch.float32), (5, 256, 5, 7, torch.bfloat16)]


def _ln_case(shape, dtype, stats, dev, seed):
    x, gamma, beta = _args("layer_norm_ref", shape, dtype, dev, seed)
    g = torch.randn(shape, generator=torch.Generator(device=dev).manual_seed(seed + 1),
                    device=dev).to(dtype).contiguous(memory_format=torch.channels_last)
    return x, gamma, beta, g


@pytest.mark.parametrize("stats", ["2pass", "1pass"])
@pytest.mark.parametrize("n,c,h,w,dtype", LN_CASES)
def test_layer_norm_cluster_matches_plain(card, n, c, h, w, dtype, stats):
    """The LayerNorm's one-launch forward and backward against their plain
    versions (the forward as `test_kernel_matches_plain`, the backward as
    `test_cluster_backward_matches_plain`); the statistics per sample at
    every channel, their mean and factor the plain forward's within 1e-5
    relative (the mean within 1e-5 where it is near 0); a second run of
    each bit-equal (y, stats, dx, dgamma, dbeta)."""
    x, gamma, beta, g = _ln_case((n, c, h, w), dtype, stats, card, 11)
    two_pass = stats == "2pass"
    before = dict(kernels.LAUNCHES)
    y, st = kernels.layer_norm_ref(x, gamma, beta, two_pass=two_pass)
    y2, st2 = kernels.layer_norm_ref(x, gamma, beta, two_pass=two_pass)
    grads = kernels.layer_norm_ref_bwd(x, g, st, gamma)
    grads2 = kernels.layer_norm_ref_bwd(x, g, st, gamma)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["layer_norm_ref"] == before["layer_norm_ref"] + 2
    assert kernels.LAUNCHES["layer_norm_ref_bwd"] == before["layer_norm_ref_bwd"] + 2
    assert torch.equal(y, y2) and torch.equal(st, st2)
    for a, b in zip(grads, grads2):
        assert torch.equal(a, b)
    _assert_forward_close("layer_norm_ref", (x, gamma, beta), y, False, stats)
    assert torch.equal(st, st[:, :, :1].expand_as(st))
    x32 = x.float()
    mean = x32.mean(dim=(1, 2, 3))
    m = c * h * w
    if stats == "1pass":
        var = torch.clamp(x32.square().sum(dim=(1, 2, 3)) - m * mean * mean, min=0) / max(m - 1, 1)
    else:
        var = (x32 - mean[:, None, None, None]).square().sum(dim=(1, 2, 3)) / max(m - 1, 1)
    torch.testing.assert_close(st[:, 0, 0], mean, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(st[:, 1, 0], 1 / (var.sqrt() + 1e-5), rtol=1e-5, atol=0)
    want = _plain_grads("layer_norm_ref", (x, gamma, beta), False, stats, y, g)
    rel = 1e-4 if dtype == torch.float32 else 2e-2
    for a, w_ in zip(grads, want):
        scale = float(w_.abs().max())
        err = float((a.float() - w_.float()).abs().max())
        assert torch.isfinite(a).all() and err <= rel * scale + 1e-6, (err, scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_cluster_is_the_same_across_graph_replays(card, dtype):
    """Forward and backward captured in one CUDA graph and replayed three
    times give the eager calls' bits (y, stats, dx, dgamma, dbeta), and an
    eager call after the replays still does: the backward's count of
    finished samples is back at 0 after every call."""
    x, gamma, beta, g = _ln_case((16, 64, 128, 128), dtype, "1pass", card, 12)

    def run():
        y, st = kernels.layer_norm_ref(x, gamma, beta, two_pass=False)
        return (y, st) + kernels.layer_norm_ref_bwd(x, g, st, gamma)

    eager = run()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = run()
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(out, eager):
            assert torch.equal(a, b)
    for a, b in zip(run(), eager):
        assert torch.equal(a, b)
    torch.cuda.synchronize()


@pytest.mark.parametrize("per_sm,k", [(1, 12), (1, 16), (2, 4), (2, 8)])
def test_layer_norm_backward_other_plans_match(card, per_sm, k):
    """The backward under other layouts that `chip_smoke.sweep_ln_plans`
    tries (12 and 16 blocks: non-portable clusters) gives the default
    plan's dx within bf16 rounding and its dgamma and dbeta within 1e-5
    relative."""
    x, gamma, beta, g = _ln_case((16, 64, 128, 128), torch.bfloat16, "1pass", card, 13)
    _, st = kernels.layer_norm_ref(x, gamma, beta, two_pass=False)
    want = kernels.layer_norm_ref_bwd(x, g, st, gamma)
    plan = kernels.ln_bwd_plan(16, 128 * 128, 64, torch.bfloat16, per_sm=per_sm, k=k)
    got = kernels.layer_norm_ref_bwd(x, g, st, gamma, plan=plan)
    torch.cuda.synchronize()
    assert plan.k == k
    assert float((got[0].float() - want[0].float()).abs().max()) <= 2e-2 * float(
        want[0].float().abs().max())
    for a, b in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * float(b.abs().max()))


# ------------------------------------------------------------------ the stem

from dwcgan_tpu_torch.ops import stem  # noqa: E402

# (N, H, W, C, pad): one flagship shape, and small ragged shapes of each pad
# type (rows and columns not multiples of the 8 x 32 tile, nor of the bf16
# dX kernel's 16 x 48 padded tile); C 8, 24, 40, 56 leave half a 16-channel
# step of the bf16 kernels empty; N 1
STEM_SHAPES = [(16, 128, 128, 64, "reflect"), (2, 13, 37, 8, "reflect"),
               (3, 9, 40, 16, "replicate"), (2, 21, 6, 24, "zero"),
               (1, 45, 70, 40, "reflect"), (1, 11, 53, 56, "replicate")]
MMA_KERNELS = ("stem_tile_mma_kernel", "stem_dw_mma_kernel", "stem_dxp_mma_kernel")
# (norm, act, stats): both stats modes where there are statistics
STEM_MODES = [("in", "relu", "1pass"), ("in", "relu", "2pass"),
              ("in", "none", "1pass"), ("in", "none", "2pass"),
              ("none", "relu", "1pass"), ("none", "none", "1pass")]


def _stem_inputs(shape, dtype, dev, seed):
    n, h, w, c, _ = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(n, h, w, 3, generator=g, device=dev).to(dtype)
    wt = 0.2 * torch.randn(c, 3, 7, 7, generator=g, device=dev)
    b = 0.1 * torch.randn(c, generator=g, device=dev)
    ct = torch.randn(n, h, w, c, generator=g, device=dev).to(dtype)
    return x, wt, b, ct


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", STEM_SHAPES)
@pytest.mark.parametrize("norm,act,stats", STEM_MODES)
def test_stem_kernels_match_plain(card, norm, act, stats, shape, dtype):
    torch.backends.cudnn.allow_tf32 = False
    pad = shape[-1]
    x, w, b, ct = _stem_inputs(shape, dtype, card, 7)
    before = dict(kernels.LAUNCHES)
    xr, wr, br = (t.clone().requires_grad_() for t in (x, w, b))
    y = stem.stem_conv7(xr, wr, br, norm, act, pad, stats)
    y.backward(ct)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["stem_conv7"] == before["stem_conv7"] + 1
    assert kernels.LAUNCHES["stem_conv7_bwd"] == before["stem_conv7_bwd"] + 1
    want = stem.stem_conv7_plain(x, w, b, norm, act, pad, stats)
    err = (y.detach().float() - want.float()).abs()
    tol = 1e-4 if dtype == torch.float32 else 2 * _ulp(want) + 1e-4
    assert y.dtype == dtype and bool((err <= tol).all()), float(err.max())
    # the ReLU mask from the kernel's own output: a value at zero within
    # rounding must not count as a difference of the backward
    grads = stem.stem_conv7_bwd_plain(x, w, b, ct, norm, act, pad, stats,
                                      out=y.detach())
    rel = 1e-4 if dtype == torch.float32 else 2e-2
    # db is row 147 of the one [148, C] weight gradient: measured against the
    # largest magnitude of that matrix (with the norm, db is zero up to
    # rounding)
    wscale = max(float(grads[1].abs().max()), float(grads[2].abs().max()))
    for name, got, ref in zip(("dx", "dw", "db"), (xr.grad, wr.grad, br.grad), grads):
        scale = float(ref.abs().max()) if name == "dx" else wscale
        diff = float((got.float() - ref.float()).abs().max())
        assert got.dtype == ref.dtype and diff <= rel * scale + 1e-6, (name, diff, scale)
    torch.backends.cudnn.allow_tf32 = True


def test_stem_backward_skips_dx_without_an_image_gradient(card):
    x, w, b, ct = _stem_inputs((2, 16, 16, 8, "reflect"), torch.float32, card, 8)
    x2p = stem.pack_weights(w, b, torch.float32)
    xc = x.permute(0, 3, 1, 2)
    y, st = kernels.stem_conv7(xc, x2p, "in", "relu", "reflect")
    dx, dw, db = kernels.stem_conv7_bwd(xc, x2p, ct.permute(0, 3, 1, 2), st,
                                        "in", "relu", "reflect", need_dx=False)
    assert dx is None and dw.shape == (8, 3, 7, 7) and db.shape == (8,)
    wr = w.clone().requires_grad_()
    stem.stem_conv7(x, wr, b).backward(ct)
    torch.testing.assert_close(wr.grad, dw, rtol=0, atol=0)


@pytest.mark.parametrize("norm,act", [("in", "relu"), ("none", "relu")])
def test_stem_bf16_backward_is_the_same_every_run(card, norm, act):
    """No atomics: two bf16 backward calls on the same inputs give the same
    bits in dx, dw and db."""
    x, w, b, ct = _stem_inputs((3, 40, 70, 64, "reflect"), torch.bfloat16, card, 9)
    w2p = stem.pack_weights(w, b, torch.bfloat16)
    xc, gc = x.permute(0, 3, 1, 2), ct.permute(0, 3, 1, 2)
    _, st = kernels.stem_conv7(xc, w2p, norm, act, "reflect")
    first = kernels.stem_conv7_bwd(xc, w2p, gc, st, norm, act, "reflect")
    second = kernels.stem_conv7_bwd(xc, w2p, gc, st, norm, act, "reflect")
    torch.cuda.synchronize()
    bits = lambda t: t.view(torch.int16 if t.element_size() == 2 else torch.int32)
    for a, c in zip(first, second):
        assert torch.equal(bits(a), bits(c))


@pytest.mark.parametrize("norm,act", [("in", "relu"), ("none", "relu")])
def test_stem_bf16_forward_is_the_same_every_run(card, norm, act):
    """Two bf16 forward calls on the same inputs give the same bits in y and
    the statistics: the backward's recomputed mask and x-hat rely on it."""
    x, w, b, _ = _stem_inputs((3, 40, 70, 64, "reflect"), torch.bfloat16, card, 10)
    w2p = stem.pack_weights(w, b, torch.bfloat16)
    xc = x.permute(0, 3, 1, 2)
    first = kernels.stem_conv7(xc, w2p, norm, act, "reflect")
    second = kernels.stem_conv7(xc, w2p, norm, act, "reflect")
    torch.cuda.synchronize()
    assert torch.equal(first[0].view(torch.int16), second[0].view(torch.int16))
    if norm == "in":
        assert torch.equal(first[1].view(torch.int32), second[1].view(torch.int32))


@pytest.mark.parametrize("norm,act,stats", [("in", "relu", "1pass"), ("in", "relu", "2pass"),
                                            ("none", "relu", "1pass")])
@pytest.mark.parametrize("c", [8, 24, 40, 56])
@pytest.mark.parametrize("pad", ["reflect", "replicate", "zero"])
def test_stem_bf16_forward_every_width_and_pad(card, pad, c, norm, act, stats):
    """The bf16 forward (the tensor-core tile) at the widths that leave an
    n8 tile pair half empty, N 1, ragged against the 8 x 32 tile, every pad
    type: within 2 bf16 ulps of the plain forward, as phase 8 holds it."""
    x, w, b, _ = _stem_inputs((1, 45, 70, c, pad), torch.bfloat16, card, 11)
    y = stem.stem_conv7(x, w, b, norm, act, pad, stats)
    torch.cuda.synchronize()
    want = stem.stem_conv7_plain(x, w, b, norm, act, pad, stats)
    err = (y.float() - want.float()).abs()
    assert bool((err <= 2 * _ulp(want) + 1e-4).all()), float(err.max())


def test_stem_bf16_contractions_run_on_the_tensor_cores(card):
    """The bf16 conv tile, dW and dX kernels of the built library hold HMMA
    (tensor core) instructions: cuobjdump of the same toolkit that built
    it."""
    from dwcgan_tpu_torch.ops.cuda import build
    counts = build.hmma_counts(MMA_KERNELS)
    assert all(counts[k] > 0 for k in MMA_KERNELS), counts


def test_stem_wrappers_refuse_what_they_do_not_take(card):
    x = torch.zeros(2, 3, 16, 16, device=card).contiguous(memory_format=torch.channels_last)
    w2p = torch.zeros(148, 64, device=card)
    with pytest.raises(ValueError, match="channels_last"):
        kernels.stem_conv7(x.contiguous(), w2p)
    with pytest.raises(ValueError, match="output channels"):
        kernels.stem_conv7(x, torch.zeros(148, 72, device=card))
    with pytest.raises(ValueError, match="image"):
        kernels.stem_conv7(torch.zeros(2, 4, 16, 16, device=card).contiguous(
            memory_format=torch.channels_last), w2p)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.stem_conv7(x.cpu(), w2p)


def test_to_device_goes_through_pinned_memory(card):
    """The training feed's copy to the card: pinned host tensors, copied
    `non_blocking`; the lengths stay on the host."""
    import numpy as np

    from dwcgan_tpu_torch.data.pipeline import Batch, pin_batch, to_device
    b = Batch(np.ones((2, 4, 4, 3), np.float32), np.zeros((2, 8), np.float32),
              np.ones((2, 8), np.float32), np.ones((2, 6), np.int32),
              np.full((2,), 3, np.int32))
    pinned = pin_batch(b)
    assert all(t.is_pinned() for t in pinned[:4]) and not pinned.txt_len.is_pinned()
    t = to_device(b, card)
    torch.cuda.synchronize()
    assert all(x.is_cuda for x in t[:4]) and t.txt_len.device.type == "cpu"
    for x, y in zip(t, b):
        np.testing.assert_array_equal(x.cpu().numpy(), np.asarray(y))


# ------------------------------- norm_compute bf16: the kernels' arith mode

ARITH_SHAPES = [(32, 64, 128, 128), (16, 256, 32, 32), (64, 256, 32, 32),
                (2, 16, 7, 9), (1, 8, 2, 3)]


def _arith_case(op, relu, shape, stats, dev, seed):
    """Rows 1-3 with arith on, bf16: the forward's (y, statistics), an
    incoming gradient and a function running the backward with arith on."""
    args = _args(op, shape, torch.bfloat16, dev, seed)
    two_pass = stats == "2pass"
    if op == "instance_norm":
        y, st = kernels.instance_norm(args[0], relu=relu, two_pass=two_pass, arith=True)
        run = lambda g: (kernels.instance_norm_bwd(args[0], g, st, relu=relu, arith=True),)
    elif op == "adain":
        y, st = kernels.adain(*args, relu=relu, two_pass=two_pass, arith=True)
        run = lambda g: kernels.adain_bwd(args[0], g, st, args[1], args[2], relu=relu,
                                          arith=True)
    else:
        y, st = kernels.adain_residual(*args, two_pass=two_pass, arith=True)
        run = lambda g: kernels.adain_bwd(args[1], g, st, args[2], residual=True,
                                          arith=True)
    g = torch.randn(y.shape, generator=torch.Generator(device=dev).manual_seed(seed + 1),
                    device=dev).to(torch.bfloat16).contiguous(
                        memory_format=torch.channels_last)
    return args, y, st, g, run


@pytest.mark.parametrize("stats", ["2pass", "1pass"])
@pytest.mark.parametrize("op,relu", CLUSTER_OPS)
@pytest.mark.parametrize("shape", ARITH_SHAPES)
def test_bf16_arith_forward_matches_plain(card, shape, op, relu, stats):
    """Rows 1-3 with `arith` on: y bit-equal to the plain bf16 chain fed
    the kernel's own statistics (every rounding at its point, no
    contraction); the statistics within fp32 summation order of the plain
    ones; y within 2 bf16 ulps (plus 1e-4) of the plain bf16-arithmetic
    forward wherever the two sides' statistics round to the same bf16
    values; a second run bit-equal; fp32 data with arith on bit-equal to
    arith off."""
    args, y, st, _, _ = _arith_case(op, relu, shape, stats, card, 7)
    again = _arith_case(op, relu, shape, stats, card, 7)[1]
    torch.cuda.synchronize()
    assert torch.equal(y, again)
    x = args[1] if op == "adain_residual" else args[0]
    affine = tuple(args[-2:]) if op != "instance_norm" else (None, None)
    res = args[0] if op == "adain_residual" else None
    assert torch.equal(y, norms.bf16_chain_plain(x, st, *affine, relu=relu, residual=res))
    mean, var = norms._moments_hw(x.float(), stats)
    mean, rstd = mean.flatten(1), torch.rsqrt(var + norms.EPS).flatten(1)
    torch.testing.assert_close(st[:, 0], mean, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(st[:, 1], rstd, atol=1e-5, rtol=1e-5)
    if op == "instance_norm":
        plain = norms.instance_norm_plain(x, relu, stats, "bf16")
    elif op == "adain":
        plain = norms.adain_plain(*args, relu=relu, stats=stats, arith="bf16")
    else:
        plain = norms.adain_residual_plain(*args, stats=stats, arith="bf16")
    bf = lambda t: t.to(torch.bfloat16)
    same = (bf(st[:, 0]) == bf(mean)) & (bf(st[:, 1]) == bf(rstd))
    err = (y.float() - plain.float()).abs()[same[:, :, None, None].expand_as(y)]
    tol = (2 * _ulp(plain) + 1e-4)[same[:, :, None, None].expand_as(y)]
    assert bool((err <= tol).all()), float(err.max())
    x32 = [a.float().contiguous(memory_format=torch.channels_last) if a.dim() == 4 else a
           for a in args]
    two = stats == "2pass"
    calls = {"instance_norm": lambda arith: kernels.instance_norm(
        *x32, relu=relu, two_pass=two, arith=arith),
        "adain": lambda arith: kernels.adain(*x32, relu=relu, two_pass=two, arith=arith),
        "adain_residual": lambda arith: kernels.adain_residual(*x32, two_pass=two,
                                                               arith=arith)}[op]
    off, on = calls(False), calls(True)
    assert torch.equal(off[0], on[0]) and torch.equal(off[1], on[1])


@pytest.mark.parametrize("stats", ["2pass", "1pass"])
@pytest.mark.parametrize("op,relu", CLUSTER_OPS)
@pytest.mark.parametrize("shape", ARITH_SHAPES)
def test_bf16_arith_backward_matches_plain(card, shape, op, relu, stats):
    """Rows 5-6 with `arith` on against the plain bf16-arithmetic backward
    (`ops/norms.py::_bwd_lowp`, the mask from the forward kernel's y > 0):
    within 2 % of each gradient's largest magnitude (phase 5's bf16
    tolerance); a second run bit-equal; the recomputed ReLU mask agrees
    with y > 0 at every element."""
    args, y, st, g, run = _arith_case(op, relu, shape, stats, card, 9)
    got, again = run(g), run(g)
    torch.cuda.synchronize()
    x = args[1] if op == "adain_residual" else args[0]
    mask = y if relu else None
    if op == "instance_norm":
        want = (norms.instance_norm_bwd_plain(x, g, mask, stats, "bf16"),)
    else:
        scale = args[2] if op == "adain_residual" else args[1]
        want = norms.adain_bwd_plain(x, scale, g, mask, stats, "bf16")
    for a, b, w in zip(got, again, want):
        assert torch.equal(a, b)
        scale_ = float(w.abs().max())
        err = float((a.float() - w.float()).abs().max())
        assert torch.isfinite(a).all() and err <= 2e-2 * scale_ + 1e-6, (err, scale_)
    if relu:
        affine = args[1:3] if op == "adain" else ()
        assert kernels.relu_mask_mismatches(args[0], y, st, *affine, arith=True) == 0
