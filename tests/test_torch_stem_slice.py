"""The stem-on path (`stem_pallas: True`) of the port against the JAX
package, at `configs/smoke.yaml` widths (32 px, gen dim 8), fp32, 1pass.

- A JAX `Generator(stem_pallas=True)`, built directly so that both 7x7
  encoder stems run the Pallas stem kernel in interpret mode
  (`build_models` would switch it off on the CPU), against the port built
  with `cfg.stem_pallas = True`: `encode`, `decode` and `infer` within
  1e-4, as tests/test_torch_generator.py holds the stem-off path.
- The gradients of a fixed scalar of `encode`'s outputs (content, mu,
  logvar against seeded weights), with respect to both stems' weights and
  biases and to the images, against `jax.grad` of the same (dropout off):
  within 1e-4 of each gradient's largest magnitude (a bias: of its stem's
  weight gradient, whose last row it is).
- One port training step with the stems on against the same step with the
  stems off (same seed, same batch, same style draws, dropout off): every
  metric within rtol 1e-4.  The stem-off step is held against the JAX
  `make_train_step` by tests/test_torch_train_step.py.
- Where the JAX block does not take its stem (`stem_fits_vmem`: under 8 px,
  or above 128 px at 64 channels), the port's block does not either: in
  bf16 against the JAX `Conv2dBlock(stem_pallas=True)` (the block both
  encoders' stems are, and where the JAX package asks the predicate) at 6
  px and 144 px, both stem kinds.  The two plain paths agree but for the
  convolutions' summation order (6 px bit-equal; 144 px 229 of 2.65 M
  elements apart, by up to 2^-6); a port that runs its stem there normalises
  the fp32 conv output instead, 13 % of the elements apart at 144 px.  The
  predicate itself against JAX's on a grid, the flagship's 128 px, 64
  channels in it.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwcgan_tpu.config import load_config as jax_load_config
from dwcgan_tpu.models.generator import Generator as JaxGenerator
from dwcgan_tpu.ops import norms as jnorms
from dwcgan_tpu.ops.blocks import Conv2dBlock as JaxConv2dBlock
from dwcgan_tpu.ops.pallas import stem_kernels as jstem
from dwcgan_tpu.text.vocab import Vocab as JaxVocab, encode_commands
from dwcgan_tpu.train.sampler import make_infer_fn as jax_make_infer_fn
from dwcgan_tpu_torch.cli.train import synthetic_batches
from dwcgan_tpu_torch.config import load_config
from dwcgan_tpu_torch.interop.jax_params import jax_to_state_dict, load_jax_params
from dwcgan_tpu_torch.models.generator import build_generator
from dwcgan_tpu_torch.ops import stem
from dwcgan_tpu_torch.ops.blocks import Conv2dBlock
from dwcgan_tpu_torch.ops.cuda import kernels
from dwcgan_tpu_torch.train.sampler import make_infer_fn
from dwcgan_tpu_torch.train.state import create_train_state
from dwcgan_tpu_torch.train.step import make_train_step

torch.set_num_threads(1)

CONFIG = "configs/smoke.yaml"
BATCH = 3
ATOL = 1e-4
GRAD_REL = 1e-4
STEP_RTOL = 1e-4
STEMS = ("enc_content.model.0.conv", "enc_style.model.0.conv")
COMMANDS = ["make her smile", "add glasses and remove the beard . make him older",
            "keep it unchanged!"]


def _inputs(cfg, vocab):
    rng = np.random.default_rng(0)
    s = cfg.image_size
    ids, lens = encode_commands(COMMANDS, vocab, cfg.max_text_len)
    return dict(
        images=rng.uniform(-1, 1, (BATCH, s, s, 3)).astype(np.float32),
        ids=np.asarray(ids), lens=np.asarray(lens),
        style=rng.normal(size=(BATCH, cfg.gen.style_dim)).astype(np.float32),
        content=rng.normal(size=(BATCH, s // 4, s // 4, 4 * cfg.gen.dim)).astype(np.float32),
        weights=[rng.normal(size=shape).astype(np.float32) for shape in (
            (BATCH, s // 4, s // 4, 4 * cfg.gen.dim),
            (BATCH, cfg.gen.num_cls, cfg.gen.c_dim),
            (BATCH, cfg.gen.num_cls, cfg.gen.c_dim))])


@pytest.fixture(scope="module")
def both():
    cfg = jax_load_config(CONFIG)
    cfg.norm_stats, cfg.stem_pallas = "1pass", True
    vocab = JaxVocab(cfg.dataset)
    inp = _inputs(cfg, vocab)
    gen = JaxGenerator(cfg=cfg.gen, input_dim=cfg.input_dim,
                       vocab_size=vocab.size, dtype=jnp.float32, stem_pallas=True)
    params = jax.jit(gen.init)({"params": jax.random.PRNGKey(1),
                                "dropout": jax.random.PRNGKey(2)},
                               jnp.zeros((1,) + inp["images"].shape[1:]))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    v = {"params": params}

    def scalar(p, images):
        out = gen.apply({"params": p}, images, method="encode")
        return sum(jnp.sum(o * w) for o, w in zip(out, inp["weights"]))

    try:
        infer = jax_make_infer_fn(cfg, gen)   # sets the JAX stats mode
        ref = dict(
            encode=gen.apply(v, inp["images"], method="encode"),
            decode=gen.apply(v, inp["content"], inp["style"], method="decode"),
            infer=infer(params, inp["images"], inp["ids"], inp["lens"]),
            grads=jax.grad(scalar, argnums=(0, 1))(params, jnp.asarray(inp["images"])))
    finally:
        jnorms.set_stats_mode("2pass")
    ref = jax.tree_util.tree_map(np.asarray, ref)

    tcfg = load_config(CONFIG)
    tcfg.norm_stats, tcfg.stem_pallas = "1pass", True
    port = build_generator(tcfg, vocab.size, device="cpu")
    load_jax_params(port, params)
    return dict(ref=ref, inp=inp, port=port, cfg=tcfg)


def _close(got, want):
    got = [g.detach().numpy() if isinstance(g, torch.Tensor) else g for g in got]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)


def test_both_stems_run_the_stem(both):
    port = both["port"]
    assert all(port.get_submodule(name.rsplit(".", 1)[0]).stem for name in STEMS)


def test_encode(both):
    with torch.inference_mode():
        got = both["port"].encode(torch.from_numpy(both["inp"]["images"]))
    _close(got, both["ref"]["encode"])


def test_decode(both):
    inp = both["inp"]
    with torch.inference_mode():
        got = both["port"].decode(torch.from_numpy(inp["content"]),
                                  torch.from_numpy(inp["style"]))
    _close(got, both["ref"]["decode"])


def test_infer(both):
    inp = both["inp"]
    got = make_infer_fn(both["cfg"], both["port"])(
        torch.from_numpy(inp["images"]), torch.from_numpy(inp["ids"]),
        torch.from_numpy(inp["lens"]))
    _close([got], [both["ref"]["infer"]])


def test_encode_gradients(both):
    port, inp = both["port"], both["inp"]
    port.eval()
    images = torch.from_numpy(inp["images"]).requires_grad_()
    port.zero_grad()
    out = port.encode(images)
    sum((o * torch.from_numpy(w)).sum() for o, w in zip(out, inp["weights"])).backward()
    jgrads, jimg = both["ref"]["grads"]
    want = jax_to_state_dict(jgrads, port.cfg)
    pairs = [(images.grad, jimg, "images", float(np.abs(jimg).max()))]
    for stem in STEMS:
        # the bias is row 147 of the stem's one [148, C] weight gradient, and
        # is measured against it: in front of the instance norm its true
        # gradient is zero and both sides hold rounding noise
        scale = float(np.abs(want[f"{stem}.weight"]).max())
        for leaf in ("weight", "bias"):
            name = f"{stem}.{leaf}"
            pairs.append((port.get_parameter(name).grad, want[name], name, scale))
    for got, ref, name, scale in pairs:
        diff = float(np.abs(got.numpy() - ref).max())
        assert scale > 0 and diff <= GRAD_REL * scale, (name, diff, scale)


def _step_metrics(stem_on):
    cfg = load_config(CONFIG)
    cfg.batch_size, cfg.norm_stats, cfg.stem_pallas = 2, "1pass", stem_on
    state = create_train_state(cfg, 102, device="cpu", seed=3)
    step = make_train_step(cfg, state.gen, state.dis, state.gen_opt,
                           state.dis_opt, _deterministic=True)
    batch = synthetic_batches(cfg, "cpu", n=1, seed=4)[0]
    g = torch.Generator().manual_seed(5)
    shape = (2, cfg.gen.num_cls, cfg.c_dim)
    draws = {"style1": torch.randn(shape, generator=g),
             "style2": torch.randn(shape, generator=g)}
    before = kernels.LAUNCHES["stem_conv7"]
    m = step(state, batch, draws=draws)
    assert kernels.LAUNCHES["stem_conv7"] == before   # the CPU runs the plain stem
    return {k: float(v) for k, v in m.items()}


def test_training_step_with_stems_matches_without():
    off, on = _step_metrics(False), _step_metrics(True)
    assert sorted(on) == sorted(off)
    for k in off:
        assert abs(on[k] - off[k]) <= STEP_RTOL * abs(off[k]) + 1e-6, (k, on[k], off[k])


def test_stem_fits_vmem_matches_jax():
    for h, w, f in itertools.product((4, 6, 7, 8, 32, 128, 129, 144, 200),
                                     (6, 8, 128, 144), (8, 16, 64)):
        assert stem.stem_fits_vmem(h, w, f) == jstem.stem_fits_vmem((1, h, w, 3), f), (h, w, f)
    assert stem.stem_fits_vmem(128, 128, 64) and not stem.stem_fits_vmem(144, 144, 64)


FIT_SHARE = 1e-3   # of the elements that may differ (by the conv's summation order)
FIT_ATOL = 2.0 ** -5   # measured: 2^-6 at values of about 2


@pytest.mark.parametrize("norm", ["in", "none"])
@pytest.mark.parametrize("px", [6, 144])
def test_block_skips_the_stem_where_jax_does(px, norm):
    """bf16, C 64, 1pass: the port's stem block against the JAX block with
    `stem_pallas`, where `stem_fits_vmem` is false."""
    jnorms.set_stats_mode("1pass")
    try:
        blk = JaxConv2dBlock(64, 7, 1, 3, norm=norm, activ="relu", pad_type="reflect",
                             dtype=jnp.bfloat16, stem_pallas=True)
        x = np.random.default_rng(1).uniform(-1, 1, (2, px, px, 3)).astype(np.float32)
        params = blk.init(jax.random.PRNGKey(3), jnp.asarray(x, jnp.bfloat16))["params"]
        want = np.asarray(blk.apply({"params": params}, jnp.asarray(x, jnp.bfloat16)),
                          np.float32)
    finally:
        jnorms.set_stats_mode("2pass")
    port = Conv2dBlock(3, 64, 7, 1, 3, norm, "relu", "reflect", stem=True)
    port.stats = "1pass"
    kernel, bias = (np.array(params["Conv_0"][k]) for k in ("kernel", "bias"))
    with torch.no_grad():
        port.conv.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()))
        port.conv.bias.copy_(torch.from_numpy(bias))
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2).bfloat16().contiguous(
            memory_format=torch.channels_last))
    assert port.stem and not stem.stem_fits_vmem(px, px, 64)
    got = got.permute(0, 2, 3, 1).float().numpy()
    err = np.abs(got - want)
    # a conv output 1 ulp apart moves its normalised value by that times rstd
    assert float(err.max()) <= FIT_ATOL, float(err.max())
    assert np.count_nonzero(err) <= FIT_SHARE * err.size, np.count_nonzero(err)
