"""The block options of the config schema in the port against the JAX
package: PReLU, batch norm and spectral norm, in the blocks, the
discriminator, the generator and one training step.

On the CPU, one thread, `configs/smoke.yaml` widths, 32 px.  JAX runs its
jnp path (its Pallas AdaIN branch cannot take PReLU, and `build_models`
turns Pallas off on the CPU).  Parameters go across through the port's
JAX mappings (`load_jax_params`, `load_jax_dis_params` and the same
`_Mapper.block` for the single blocks); every bias, norm affine and PReLU
slope gets N(0, 0.1) noise first, so none sits at its init constant.  The
models' trees come from `jax.eval_shape` of their `init`, filled with
seeded numpy (`_random_params`): flax's eager init of a spectral norm
takes seconds per layer.

Tolerances and why:

- `jax_normal_key0(n)`: the uniform draw and the normal bit-equal to
  `jax.random.normal(PRNGKey(0), (n,))` (ulp bound 0, measured 0 up to
  n = 2^20);
- `spectral_sigma` / `spectral_normalize` against `_spectral_normalize`:
  sigma and the normalised kernel within rtol 1e-5 (measured 2e-7);
- the blocks in fp32: the output within 2e-5 of its largest magnitude,
  the input and parameter gradients within 1e-4 of the block's largest
  gradient (summation order; a conv bias in front of a norm has a true
  gradient of zero, so its gradient is rounding noise on both sides);
- the blocks in bf16: the output and the input gradient by their mean
  absolute difference from JAX bf16, within half of JAX's own
  fp32-vs-bf16 gap on the same input (a port that computed in fp32 would
  be the whole gap away; measured: the outputs bit-equal, the input
  gradients at most 0.17 of the gap); a parameter gradient, a sum over
  the batch that both round in bf16 but accumulate in other orders, by
  its L2 difference, within JAX's own gap plus 4 bf16 ulps of the block's
  largest gradient per element (measured: the PReLU slope's up to 2 ulps
  of its value);
- the discriminator and the generator in fp32 at the atol of
  `test_torch_discriminator.py` (1e-5) and `test_torch_generator.py`
  (1e-4);
- the step, fp32: every metric within rtol 1e-4, the Adam first moments
  and the updated parameters by `test_torch_train_step.py`'s rules; bf16:
  every metric no farther from the JAX bf16 step than the JAX fp32 step
  is, plus 2.5e-3 (`test_torch_train_step.py`'s bf16 rtol; 5e-3 for the
  gradient norms, measured 4.5e-3 for the discriminator's), and the losses'
  summed relative difference within 3/4 of the JAX step's own summed
  fp32-vs-bf16 gap, measured in the same test (0.56 on an x86 CPU; a port step in fp32 is
  the whole gap away).  Both bounds are looser than the flagship's bf16
  test: the content encoder's IN ResBlocks turn 1-ulp summation-order
  differences into up to 1e-2 in the content code, more than JAX's own
  fp32/bf16 gap with these weights.  The gradient norms stay out of the
  share: JAX on the CPU sums the gradient of a bias added in bf16 in bf16,
  one element after another (2-5 % from fp32; ROADMAP F9), the port in
  fp32, rounding once.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dwcgan_tpu.config import load_config as jax_load_config
from dwcgan_tpu.data.pipeline import synthetic_batch as jax_synthetic_batch
from dwcgan_tpu.models.discriminator import MsImageDis as JaxDis
from dwcgan_tpu.models.generator import Generator as JaxGenerator
from dwcgan_tpu.ops import blocks as jblocks
from dwcgan_tpu.ops import norms as jnorms
from dwcgan_tpu.text.vocab import Vocab as JaxVocab, encode_commands
from dwcgan_tpu.train.state import TrainState, build_models, make_optimizer
from dwcgan_tpu.train.step import make_train_step as jax_make_train_step
from dwcgan_tpu_torch.config import load_config
from dwcgan_tpu_torch.data.pipeline import synthetic_batch, to_device
from dwcgan_tpu_torch.interop.jax_params import (_Leaves, _Mapper, flatten_params,
                                                 jax_dis_to_state_dict,
                                                 jax_to_state_dict,
                                                 load_jax_dis_params,
                                                 load_jax_params)
from dwcgan_tpu_torch.models.discriminator import MsImageDis, build_discriminator
from dwcgan_tpu_torch.models.generator import Generator, build_generator
from dwcgan_tpu_torch.ops import blocks as tblocks
from dwcgan_tpu_torch.ops.norms import batch_norm_stats_free
from dwcgan_tpu_torch.ops.prng import jax_normal_key0, jax_uniform_key0
from dwcgan_tpu_torch.train.state import create_train_state as port_create_state
from dwcgan_tpu_torch.train.step import make_train_step

torch.set_num_threads(1)

CONFIG = "configs/smoke.yaml"
VOCAB, BATCH = 102, 2
BLOCK_FWD_REL, BLOCK_GRAD_REL = 2e-5, 1e-4
GAP_SHARE = 0.5
BF16_PARAM_ULPS = 4
DIS_ATOL, GEN_ATOL = 1e-5, 1e-4
METRIC_RTOL = 1e-4
MOMENT_REL, MOMENT_FLOOR = 5e-3, 1e-6
PARAM_ATOL, FLIP_SHARE = 1e-6, 0.01
BF16_METRIC_RTOL = 2.5e-3
GRAD_NORMS = ("grad_gen_norm", "grad_dis_norm")
BF16_LOSS_SHARE = 0.75
# the JAX steps compile at LLVM's lowest optimisation level: 10 s instead
# of 25 s each here, the same XLA program
FAST_COMPILE = {"xla_backend_optimization_level": 0}
DT = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _noisy(params, seed):
    """Every leaf that is not a kernel or an embedding, plus N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def f(path, v):
        v = np.asarray(v, np.float32)
        leaf = jax.tree_util.keystr(path)
        if not any(k in leaf for k in ("kernel", "embedding", "_w_x", "_w_h")):
            v = v + rng.normal(0.0, 0.1, v.shape).astype(np.float32)
        return v
    return jax.tree_util.tree_map_with_path(f, params)


def _random_params(init, seed, *args, kernel_std=None):
    """The parameter tree `init(key, *args)` would make (from
    `jax.eval_shape`, no compile), filled from `seed` with numpy: kernels
    N(0, kernel_std) (default: kaiming's sqrt(2 / fan_in), the generator's
    init; the discriminator's is 0.02), LSTM weights U(+-1/sqrt(H)), embeddings N(0, 1),
    LayerNorm gamma U(0, 1), batch-norm gamma 1 and PReLU slopes 0.25,
    then `_noisy`."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0), *args)["params"]

    def f(path, sd):
        leaf, shape = jax.tree_util.keystr(path), sd.shape
        if "kernel" in leaf:
            std = kernel_std or np.sqrt(2.0 / np.prod(shape[:-1]))
            v = rng.normal(0.0, std, shape)
        elif "_w_x" in leaf or "_w_h" in leaf:
            b = 1.0 / np.sqrt(shape[-1] // 4)
            v = rng.uniform(-b, b, shape)
        elif "embedding" in leaf or "ln_gamma" in leaf:
            v = rng.normal(0.0, 1.0, shape) if "embedding" in leaf else rng.uniform(0, 1, shape)
        elif "bn_gamma" in leaf:
            v = np.ones(shape)
        elif "slope" in leaf:
            v = np.full(shape, 0.25)
        else:
            v = np.zeros(shape)
        return v.astype(np.float32)
    return _noisy(jax.tree_util.tree_map_with_path(f, shapes), seed + 1)


# ------------------------------------------------------------- the PRNG

@pytest.mark.parametrize("n", [1, 3, 8, 64, 256, 512, 1000, 4096])
def test_start_vector_is_jaxs_normal_draw(n):
    key = jax.random.PRNGKey(0)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    uni = np.asarray(jax.random.uniform(key, (n,), jnp.float32, lo, 1.0))
    np.testing.assert_array_equal(jax_uniform_key0(n), uni)
    want = np.asarray(jax.random.normal(key, (n,), jnp.float32))
    got = jax_normal_key0(n)
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert int(ulps.max()) == 0, int(ulps.max())
    assert got is jax_normal_key0(n) and not got.flags.writeable


# ------------------------------------------------------- spectral norm

@pytest.mark.parametrize("shape", [(4, 4, 16, 32), (3, 3, 8, 8), (64, 24), (300, 8)],
                         ids=["conv4x4", "conv3x3", "dense", "dense_tall"])
def test_spectral_normalize_matches_jax(shape):
    w = np.random.default_rng(2).normal(0, 0.02, shape).astype(np.float32)
    want = np.asarray(jblocks._spectral_normalize(jnp.asarray(w)))
    sigma_j = float(np.linalg.norm(w) / np.linalg.norm(want))
    out = shape[-1]
    wt = torch.from_numpy(w)
    if len(shape) == 4:   # the port's OIHW kernel
        oihw = wt.permute(3, 2, 0, 1)
        got = tblocks.sn_conv_weight(oihw).permute(2, 3, 1, 0).numpy()
        sigma = float(tblocks.spectral_sigma(oihw.permute(2, 3, 1, 0).reshape(-1, out)))
    else:
        got = tblocks.spectral_normalize(wt).numpy()
        sigma = float(tblocks.spectral_sigma(wt))
    np.testing.assert_allclose(sigma, sigma_j, rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_spectral_normalize_gradient_matches_jax():
    rng = np.random.default_rng(3)
    w = rng.normal(0, 0.02, (48, 16)).astype(np.float32)
    r = rng.normal(size=w.shape).astype(np.float32)
    want = np.asarray(jax.grad(lambda a: jnp.sum(jblocks._spectral_normalize(a) * r))(w))
    wt = torch.from_numpy(w).requires_grad_(True)
    (tblocks.spectral_normalize(wt) * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(wt.grad.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


# --------------------------------------------------------------- blocks

def _cotangent(shape, seed=4):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_prelu_matches_jax_with_exact_zeros():
    x = np.random.default_rng(5).normal(size=(2, 3, 4, 4)).astype(np.float32)
    x[0, 0, :2] = 0.0
    r = _cotangent(x.shape)
    for jd, td in DT.values():
        p = {"slope": np.float32(0.3)}
        mod = jblocks.PReLU()
        jf = lambda pp, xx: jnp.sum(mod.apply({"params": pp}, xx).astype(jnp.float32) * r)
        want = np.asarray(mod.apply({"params": p}, jnp.asarray(x, jd)), np.float32)
        gp, gx = jax.grad(jf, argnums=(0, 1))(p, jnp.asarray(x, jd))
        port = tblocks.PReLU()
        with torch.no_grad():
            port.weight.fill_(0.3)
        xt = torch.from_numpy(x).to(td).requires_grad_(True)
        y = port(xt)
        (y.float() * torch.from_numpy(r)).sum().backward()
        np.testing.assert_array_equal(y.detach().float().numpy(), want)
        np.testing.assert_array_equal(xt.grad.float().numpy(), np.asarray(gx, np.float32))
        np.testing.assert_allclose(float(port.weight.grad[0]), float(gp["slope"]),
                                   rtol=1e-5 if td == torch.float32 else 1e-2)
        assert float(port.weight.grad[0]) != 0.0
    with pytest.raises(ValueError, match="prelu"):
        tblocks.activation("prelu")
    with pytest.raises(ValueError, match="prelu"):
        jblocks.activation("prelu")


CONV_CASES = [("bn", "relu"), ("bn", "prelu"), ("sn", "lrelu"), ("sn", "prelu"),
              ("in", "prelu"), ("adain", "prelu"), ("ln", "prelu"), ("none", "prelu")]
LINEAR_CASES = [("ln", "relu"), ("ln", "prelu"), ("bn", "lrelu"), ("sn", "relu"),
                ("sn", "prelu"), ("none", "prelu")]


def _block_pair(kind, norm, activ, jd, td):
    """(jax module, jax params, input, port module, extra args)."""
    rng = np.random.default_rng(6)
    if kind == "conv":
        x = rng.normal(size=(3, 8, 8, 4)).astype(np.float32)
        jm = jblocks.Conv2dBlock(6, 3, 1, 1, norm=norm, activ=activ,
                                 pad_type="reflect", dtype=jd)
        pm = tblocks.Conv2dBlock(4, 6, 3, 1, 1, norm, activ, "reflect")
        extra = ()
        if norm == "adain":
            extra = (rng.normal(1, 0.2, (3, 6)).astype(np.float32),
                     rng.normal(0, 0.2, (3, 6)).astype(np.float32))
    else:
        x = rng.normal(size=(5, 12)).astype(np.float32)
        jm = jblocks.LinearBlock(7, norm=norm, activ=activ, dtype=jd)
        pm = tblocks.LinearBlock(12, 7, norm, activ)
        extra = ()
    init = {"params": jax.random.PRNGKey(7)}
    params = jm.init(init, jnp.asarray(x), *extra)["params"]
    params = _noisy(jax.tree_util.tree_map(np.asarray, params), 8)
    m = _Mapper(_Leaves({"blk": params}))
    m.block("blk", "blk")
    sd = m.p.done(m.sd)
    pm.load_state_dict({k[4:]: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return jm, params, x, pm, extra


@functools.lru_cache(maxsize=None)
def _run_block(kind, norm, activ, dtype):
    """((y, dx, dparams by port name) of JAX, of the port) in fp32 numpy."""
    jd, td = DT[dtype]
    jm, params, x, pm, extra = _block_pair(kind, norm, activ, jd, td)
    y_shape = jax.eval_shape(lambda p, xx: jm.apply({"params": p}, xx, *extra),
                             params, jnp.asarray(x)).shape
    r = _cotangent(y_shape)

    def f(p, xx):
        y = jm.apply({"params": p}, xx, *extra)
        return jnp.sum(y.astype(jnp.float32) * r), y
    (_, y), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x, jd))
    m = _Mapper(_Leaves({"blk": jax.tree_util.tree_map(np.asarray, gp)}))
    m.block("blk", "blk")
    jgrads = {k[4:]: v for k, v in m.p.done(m.sd).items()}
    want = (np.asarray(y, np.float32), np.asarray(gx, np.float32), jgrads)

    xt = torch.from_numpy(x).to(td)
    if kind == "conv":
        xt = xt.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    xt.requires_grad_(True)
    ex = [torch.from_numpy(e) for e in extra]
    yt = pm(xt, *ex) if kind == "conv" else pm(xt)
    rt = torch.from_numpy(r)
    if kind == "conv":
        rt = rt.permute(0, 3, 1, 2)
    (yt.float() * rt).sum().backward()
    back = (lambda t: t.permute(0, 2, 3, 1)) if kind == "conv" else (lambda t: t)
    got = (back(yt.detach()).float().numpy(), back(xt.grad).float().numpy(),
           {n: p.grad.numpy() for n, p in pm.named_parameters()})
    return want, got


@pytest.mark.parametrize("dtype", list(DT))
@pytest.mark.parametrize("kind,norm,activ",
                         [("conv",) + c for c in CONV_CASES]
                         + [("linear",) + c for c in LINEAR_CASES],
                         ids=lambda v: str(v))
def test_block_matches_jax(kind, norm, activ, dtype):
    want, got = _run_block(kind, norm, activ, dtype)
    assert sorted(got[2]) == sorted(want[2])
    pairs = [("y", got[0], want[0]), ("dx", got[1], want[1])] + [
        (k, got[2][k], want[2][k]) for k in sorted(want[2])]
    if dtype == "fp32":
        # a bias in front of a norm has a true gradient of zero: its
        # rounding noise is held to the largest gradient of the block
        gscale = max(float(np.abs(w).max()) for name, _, w in pairs[1:])
        for name, g, w in pairs:
            atol = (BLOCK_FWD_REL * np.abs(w).max() if name == "y"
                    else BLOCK_GRAD_REL * gscale)
            assert g.shape == w.shape, name
            np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=name)
        return
    want32, _ = _run_block(kind, norm, activ, "fp32")
    ref32 = [want32[0], want32[1]] + [want32[2][k] for k in sorted(want32[2])]
    gscale = max(float(np.abs(w).max()) for _, _, w in pairs[1:])
    for (name, g, w), w32 in zip(pairs, ref32):
        assert np.isfinite(g).all(), name
        if name in ("y", "dx"):
            gap = np.abs(w32 - w).mean()
            assert np.abs(g - w).mean() <= GAP_SHARE * gap, (name, np.abs(g - w).mean(), gap)
        else:
            err, gap = np.linalg.norm(g - w), np.linalg.norm(w32 - w)
            floor = BF16_PARAM_ULPS * 2.0 ** -8 * gscale * np.sqrt(w.size)
            assert err <= gap + floor, (name, err, gap, floor)


def test_batch_norm_takes_a_channels_last_tensor():
    x = torch.randn(4, 3, 5, 6)
    g, b = torch.rand(3), torch.randn(3)
    cl = x.contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(batch_norm_stats_free(cl, g, b),
                               batch_norm_stats_free(x, g, b), rtol=0, atol=1e-6)
    want = np.asarray(jnorms.batch_norm_stats_free(
        jnp.asarray(x.permute(0, 2, 3, 1).numpy()), jnp.asarray(g.numpy()),
        jnp.asarray(b.numpy())))
    np.testing.assert_allclose(batch_norm_stats_free(cl, g, b).permute(0, 2, 3, 1).numpy(),
                               want, atol=1e-5)


def test_rejections_match_jax():
    x = jnp.zeros((2, 4))
    with pytest.raises(NotImplementedError, match="ill-defined"):
        jblocks.LinearBlock(3, norm="in").init(jax.random.PRNGKey(0), x)
    with pytest.raises(NotImplementedError, match="ill-defined"):
        tblocks.LinearBlock(4, 3, norm="in")
    for norm in ("gn", "adain"):
        with pytest.raises(ValueError, match="Unsupported normalization"):
            jblocks.LinearBlock(3, norm=norm).init(jax.random.PRNGKey(0), x)
        with pytest.raises(ValueError, match="Unsupported normalization"):
            tblocks.LinearBlock(4, 3, norm=norm)
    with pytest.raises(ValueError, match="Unsupported normalization: gn"):
        jblocks.Conv2dBlock(3, 3, norm="gn").init(jax.random.PRNGKey(0),
                                                   jnp.zeros((1, 4, 4, 2)))
    with pytest.raises(ValueError, match="Unsupported normalization: gn"):
        tblocks.Conv2dBlock(2, 3, 3, norm="gn")


# ------------------------------------------- discriminator and generator

@pytest.mark.parametrize("norm,activ", [("sn", "lrelu"), ("bn", "lrelu"),
                                        ("none", "prelu"), ("sn", "prelu")])
def test_discriminator_matches_jax(norm, activ):
    jcfg, tcfg = jax_load_config(CONFIG), load_config(CONFIG)
    for c in (jcfg, tcfg):
        c.dis.norm, c.dis.activ = norm, activ
    images = np.random.default_rng(9).uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
    jdis = JaxDis(cfg=jcfg.dis, dtype=jnp.float32)
    params = _random_params(jdis.init, 10, jnp.zeros((1, 32, 32, 3)), kernel_std=0.02)
    want = jax.jit(jdis.apply)({"params": params}, images)
    port = MsImageDis(tcfg.dis)
    load_jax_dis_params(port, params)
    with torch.no_grad():
        got = port(torch.from_numpy(images))
    for (gs, gc), (ws, wc) in zip(got, want):
        np.testing.assert_allclose(gs.numpy(), np.asarray(ws), atol=DIS_ATOL, rtol=0)
        np.testing.assert_allclose(gc.numpy(), np.asarray(wc), atol=DIS_ATOL, rtol=0)
    sd = port.state_dict()
    if norm == "sn":   # the raw kernel, as JAX keeps sn_kernel
        np.testing.assert_array_equal(
            sd["cnns_feat.0.1.conv.weight"].numpy(),
            params["scale_0"]["Conv2dBlock_1"]["sn_kernel"].transpose(3, 2, 0, 1))
    if activ == "prelu":
        assert sd["cnns_feat.0.0.activation.weight"].shape == (1,)


def test_generator_with_prelu_matches_jax():
    jcfg, tcfg = jax_load_config(CONFIG), load_config(CONFIG)
    jcfg.gen.activ = tcfg.gen.activ = "prelu"
    vocab = JaxVocab(jcfg.dataset)
    gen = JaxGenerator(cfg=jcfg.gen, input_dim=3, vocab_size=vocab.size,
                       dtype=jnp.float32)
    params = _random_params(gen.init, 11, jnp.zeros((1, 32, 32, 3)))
    rng = np.random.default_rng(0)
    images = rng.uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
    style = rng.normal(size=(3, jcfg.gen.style_dim)).astype(np.float32)
    ids, lens = encode_commands(["make her smile", "add glasses", "older"], vocab,
                                jcfg.max_text_len)
    v = {"params": params}
    apply = jax.jit(gen.apply, static_argnames="method")
    ref = (apply(v, images, method="encode"),
           apply(v, style, np.asarray(ids), np.asarray(lens), method="encode_txt"))
    content = np.asarray(ref[0][0])
    ref += (apply(v, content, style, method="decode"),)
    port = Generator(tcfg.gen, vocab_size=vocab.size)
    load_jax_params(port, params)
    port.eval()
    with torch.no_grad():
        got = (port.encode(torch.from_numpy(images)),
               port.encode_txt(torch.from_numpy(style), torch.from_numpy(np.asarray(ids)),
                               torch.from_numpy(np.asarray(lens))),
               port.decode(torch.from_numpy(content), torch.from_numpy(style)))
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(ref)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GEN_ATOL, rtol=0)
    slopes = [n for n in port.state_dict() if n.endswith("activation.weight")]
    # style 4 + content 3 + resblocks 2 + adain 2 + upsample 2 + mlp 2
    assert len(slopes) == 15, slopes


def test_weight_init_fills_the_constant_parameters():
    cfg = load_config(CONFIG)
    cfg.gen.activ = cfg.dis.activ = "prelu"
    cfg.dis.norm = "bn"
    gen = build_generator(cfg, VOCAB, device="cpu")
    dis = build_discriminator(cfg, device="cpu")
    for name, p in list(gen.named_parameters()) + list(dis.named_parameters()):
        if name.endswith("activation.weight"):
            assert p.shape == (1,) and float(p) == 0.25, name
        elif name.endswith("norm.weight"):
            assert float(p.min()) == float(p.max()) == 1.0, name
        elif name.endswith("norm.bias"):
            assert float(p.abs().max()) == 0.0, name


# ----------------------------------------------------------------- step

def _cfgs(dtype):
    jc, tc = jax_load_config(CONFIG), load_config(CONFIG)
    for c in (jc, tc):
        c.batch_size = BATCH
        c.gen.activ, c.dis.activ, c.dis.norm = "prelu", "prelu", "sn"
        c.compute_dtype = dtype
    return jc, tc


def _adam_mu(opt_state):
    found = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    return jax.tree_util.tree_map(np.asarray, found[0].mu)


def _draws(rng, n, k, c):
    key = jax.random.fold_in(rng, 0)
    _, k_g = jax.random.split(key)
    keys = jax.random.split(k_g, 8)
    as_t = lambda kk: torch.from_numpy(np.array(jax.random.normal(kk, (n, k, c))))
    return {"style1": as_t(keys[3]), "style2": as_t(keys[4])}


@pytest.fixture(scope="module")
def jax_state():
    jcfg, _ = _cfgs("float32")
    gen, dis = build_models(jcfg, VOCAB)
    x = jnp.zeros((1, 32, 32, 3))
    g, d = _random_params(gen.init, 12, x), _random_params(dis.init, 13, x, kernel_std=0.02)
    return TrainState(step=jnp.zeros((), jnp.int32), gen_params=g, dis_params=d,
                      ema_gen_params=g, ema_dis_params=d, gen_opt_state=None,
                      dis_opt_state=None, rng=jax.random.PRNGKey(14))


def _step_pair(state0, dtype):
    jcfg, tcfg = _cfgs(dtype)
    gen, dis = build_models(jcfg, VOCAB)
    gen_tx = make_optimizer(jcfg, state0.gen_params)
    dis_tx = make_optimizer(jcfg, state0.dis_params)
    state = state0.replace(gen_opt_state=gen_tx.init(state0.gen_params),
                           dis_opt_state=dis_tx.init(state0.dis_params))
    batch = jax_synthetic_batch(BATCH, 32, 8, jcfg.max_text_len, seed=3)
    try:
        fn = jax.jit(jax_make_train_step(jcfg, gen, dis, gen_tx, dis_tx,
                                         _deterministic=True))
        state, m = fn.lower(state, batch).compile(FAST_COMPILE)(state, batch)
    finally:
        jnorms.set_stats_mode("2pass")
    ts = port_create_state(tcfg, VOCAB, device="cpu")
    for mod in (ts.gen, ts.ema_gen):
        load_jax_params(mod, state0.gen_params)
    for mod in (ts.dis, ts.ema_dis):
        load_jax_dis_params(mod, state0.dis_params)
    step = make_train_step(tcfg, ts.gen, ts.dis, ts.gen_opt, ts.dis_opt,
                           _deterministic=True)
    b = to_device(synthetic_batch(BATCH, 32, 8, tcfg.max_text_len, seed=3), "cpu")
    got = step(ts, b, draws=_draws(state0.rng, BATCH, 8, tcfg.c_dim))
    return dict(jax={k: float(v) for k, v in m.items()},
                port={k: float(v) for k, v in got.items()},
                jstate=state, ts=ts, cfg=jcfg)


@pytest.fixture(scope="module")
def steps(jax_state):
    return {d: _step_pair(jax_state, d) for d in ("float32", "bfloat16")}


def test_step_metrics_match_jax_fp32(steps):
    want, got = steps["float32"]["jax"], steps["float32"]["port"]
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=METRIC_RTOL, atol=1e-6,
                                   err_msg=k)


def test_step_metrics_match_jax_bf16(steps):
    w32, want, got = (steps["float32"]["jax"], steps["bfloat16"]["jax"],
                      steps["bfloat16"]["port"])
    keys = [k for k in want if want[k] != 0]
    assert all(got[k] == 0.0 for k in want if want[k] == 0)
    rel = {k: abs(got[k] - want[k]) / abs(want[k]) for k in keys}
    jgap = {k: abs(w32[k] - want[k]) / abs(want[k]) for k in keys}
    for k in keys:
        slack = BF16_METRIC_RTOL * (2 if k in GRAD_NORMS else 1)
        assert rel[k] <= jgap[k] + slack, (k, rel[k], jgap[k])
    losses = [k for k in keys if k not in GRAD_NORMS]
    share = sum(rel[k] for k in losses) / sum(jgap[k] for k in losses)
    assert share <= BF16_LOSS_SHARE, (share, rel, jgap)
    for k in ("loss_gen_total", "loss_dis_all"):
        assert np.isfinite(got[k])


def _moments_close(got, want):
    gmax = max(float(np.abs(v).max()) for v in want.values())
    for k, w in want.items():
        err = np.linalg.norm(got[k] - w)
        tol = MOMENT_REL * np.linalg.norm(w) + MOMENT_FLOOR * gmax * np.sqrt(w.size)
        assert err <= tol, (k, err, tol)


def test_step_moments_and_parameters_match_jax(steps):
    run = steps["float32"]
    ts, state, cfg = run["ts"], run["jstate"], run["cfg"]
    gen_mu = jax_to_state_dict(_adam_mu(state.gen_opt_state), cfg.gen)
    dis_mu = jax_dis_to_state_dict(_adam_mu(state.dis_opt_state), cfg.dis)
    port_gen = {n: ts.gen_opt.state[p]["exp_avg"].numpy()
                for n, p in ts.gen.named_parameters() if p in ts.gen_opt.state}
    port_dis = {n: ts.dis_opt.state[p]["exp_avg"].numpy()
                for n, p in ts.dis.named_parameters()}
    _moments_close(port_gen, {k: v for k, v in gen_mu.items() if k in port_gen})
    assert set(port_gen) == {k for k in gen_mu if ".bias_hh" not in k}
    _moments_close(port_dis, dis_mu)
    lr = cfg.lr
    for got, want in ((ts.gen.state_dict(), jax_to_state_dict(state.gen_params, cfg.gen)),
                      (ts.dis.state_dict(), jax_dis_to_state_dict(state.dis_params, cfg.dis))):
        flips = total = 0
        for k, w in want.items():
            d = np.abs(got[k].numpy() - w)
            assert d.max() <= 2 * lr + PARAM_ATOL, (k, d.max())
            flips += int((d > PARAM_ATOL).sum())
            total += d.size
        assert flips <= FLIP_SHARE * total, (flips, total)


def test_step_moves_the_slopes_and_spectral_kernels(steps, jax_state):
    for run in steps.values():
        ts = run["ts"]
        g0 = jax_to_state_dict(jax_state.gen_params, run["cfg"].gen)
        d0 = jax_dis_to_state_dict(jax_state.dis_params, run["cfg"].dis)
        gsd, dsd = ts.gen.state_dict(), ts.dis.state_dict()
        moved = [k for k in g0 if k.endswith("activation.weight")
                 and not np.array_equal(gsd[k].numpy(), g0[k])]
        assert len(moved) == 15, moved
        sn = [k for k in d0 if ".conv.weight" in k and ".0.conv" not in k]
        assert sn and all(not np.array_equal(dsd[k].numpy(), d0[k]) for k in sn)
        assert all(not np.array_equal(dsd[k].numpy(), d0[k])
                   for k in d0 if k.endswith("activation.weight"))


def test_bn_discriminator_step_is_rejected_in_both_packages(jax_state):
    jcfg, tcfg = _cfgs("float32")
    jcfg.dis.norm = tcfg.dis.norm = "bn"
    gen, dis = build_models(jcfg, VOCAB)
    with pytest.raises(ValueError, match="bn"):
        jax_make_train_step(jcfg, gen, dis, optax.adam(1e-4), optax.adam(1e-4))
    ts = port_create_state(tcfg, VOCAB, device="cpu")
    with pytest.raises(ValueError, match="bn"):
        make_train_step(tcfg, ts.gen, ts.dis, ts.gen_opt, ts.dis_opt)


def test_mapping_reads_every_jax_leaf(jax_state):
    """A leaf the mapping does not know raises instead of loading silently."""
    cfg, _ = _cfgs("float32")
    p = flatten_params(jax_state.dis_params)
    p["scale_0/Conv2dBlock_1/unknown"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="unknown"):
        jax_dis_to_state_dict(p, cfg.dis)
