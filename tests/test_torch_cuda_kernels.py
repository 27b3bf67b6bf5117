"""The hand-written CUDA norm kernels against their plain PyTorch versions,
on the card.  Marked `cuda`: without a card every test here skips.  On a
machine with one (`--noconftest`: the suite's conftest imports JAX, which
that machine need not have):

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda --noconftest -p no:cacheprovider

fp32 within atol 1e-4 (summation order only); bf16 within 2 bf16 ulps of
the rounded fp32 plain result plus that atol.  Shapes are small and ragged
(rows not a multiple of a block's row chunk; channel counts 8 to 256).
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
    assert out.dtype == dtype and out.is_contiguous(memory_format=torch.channels_last)
    ref = _call(PLAIN, op, tuple(a.float() for a in args), relu, stats)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
    else:
        r = ref.to(torch.bfloat16)
        err = (out.float() - r.float()).abs()
        assert bool((err <= 2 * _ulp(r) + 1e-4).all()), float(err.max())


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
    with pytest.raises(NotImplementedError):
        norms.instance_norm(x.clone().requires_grad_())


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
