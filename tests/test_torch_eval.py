"""The port's FID/IS evaluation against the JAX package's, on the CPU.

- metrics: `feature_stats`, `fid_from_stats` and `inception_score` are a
  copy of the JAX math and bit-equal to it on seeded features and logits;
- preprocessing: `preprocess_for_inception` against `jax.image.resize` at
  128 -> 299 (upsampling) within 1e-6, and 512 -> 299 (antialiased, as
  JAX's) within 1e-5;
- InceptionV3: JAX variables from `jax.eval_shape` of `init`, filled with
  seeded numpy (He-scaled kernels, BN statistics and affine away from the
  identity), carried across by `load_jax_inception`.  `BasicConv2d` at
  every kernel shape of the trunk and each of the five block types hold
  the eps 1e-3 BN, the asymmetric paddings, the pools and the branch
  order; the whole trunk on 2 images at 299 px: features and logits within
  2e-5 of the largest (summation order only; 5e-7 measured);
- the harness: `compute_fid_is` against JAX's on the same seeded batches
  and weights, FID and IS within rtol 1e-4 (measured: FID 3e-7, IS 3e-9,
  its std 2e-6); `generate_fakes` against
  JAX's on PIL-written PNGs at `configs/smoke.yaml` widths (the JAX
  parameters from the port's `state_dict` through
  `convert_reference_generator`), atol 1e-4 as tests/test_torch_generator.py.

The JAX trunk runs under `jax.jit` (about 3 s to compile here; an eager
`apply` takes 7-9 s).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dwcgan_tpu.config import load_config as jax_load_config
from dwcgan_tpu.eval import harness as jharness
from dwcgan_tpu.eval import inception as jinc
from dwcgan_tpu.eval import metrics as jmetrics
from dwcgan_tpu.interop.torch_import import convert_reference_generator
from dwcgan_tpu.models.generator import Generator as JaxGenerator
from dwcgan_tpu.ops import norms as jnorms
from dwcgan_tpu.text.vocab import Vocab as JaxVocab
from dwcgan_tpu.train.sampler import make_infer_fn as jax_make_infer_fn
from dwcgan_tpu_torch.config import load_config
from dwcgan_tpu_torch.eval import harness, inception, metrics
from dwcgan_tpu_torch.interop.jax_params import (jax_inception_to_state_dict,
                                                 load_jax_inception)
from dwcgan_tpu_torch.models.generator import build_generator
from dwcgan_tpu_torch.text.vocab import Vocab
from dwcgan_tpu_torch.train.sampler import make_infer_fn

torch.set_num_threads(1)

TRUNK_REL = 2e-5      # of the largest feature / logit
SCORE_RTOL = 1e-4
FAKES_ATOL = 1e-4


def fill_inception(tree, seed):
    """Seeded numpy values for a tree of JAX shapes: He-scaled conv
    kernels, BN mean / var / gamma / beta off the identity, lecun fc."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['kernel']"):
            fan_in = int(np.prod(s.shape[:-1]))
            gain = 2.0 if "conv" in name else 1.0
            return rng.normal(scale=math.sqrt(gain / fan_in), size=s.shape)
        if "bn_var" in name:
            return rng.uniform(0.5, 1.5, s.shape)
        if "bn_gamma" in name:
            return rng.uniform(0.8, 1.2, s.shape)
        return rng.normal(scale=0.1, size=s.shape)   # bn_mean, bn_beta, fc bias

    return jax.tree_util.tree_map_with_path(
        lambda p, s: np.asarray(leaf(p, s), np.float32), tree)


def jax_variables(module, x, seed):
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), x)
    return fill_inception(shapes, seed)


@pytest.fixture(scope="module")
def trunk():
    """(JAX variables, the JIT-compiled JAX trunk, the port's trunk)."""
    variables = jax_variables(jinc.InceptionV3(), jnp.zeros((1, 299, 299, 3)), 0)
    model = inception.InceptionV3()
    load_jax_inception(model, variables)
    return variables, jax.jit(lambda v, x: jinc.InceptionV3().apply(v, x)), model


# ------------------------------------------------------------------ metrics

@pytest.mark.parametrize("n_a,n_b,d", [(64, 80, 16), (40, 40, 48), (12, 30, 64)])
def test_fid_is_bit_equal_to_jax(n_a, n_b, d):
    rng = np.random.default_rng(n_a + d)
    a = rng.normal(size=(n_a, d)).astype(np.float32)
    b = (rng.normal(size=(n_b, d)) * 1.3 + 0.2).astype(np.float32)
    sa, sb = metrics.feature_stats(a), metrics.feature_stats(b)
    for got, want in zip(sa + sb, jmetrics.feature_stats(a) + jmetrics.feature_stats(b)):
        np.testing.assert_array_equal(got, want)
    fid = metrics.fid_from_stats(*sa, *sb)
    assert isinstance(fid, float) and fid == jmetrics.fid_from_stats(*sa, *sb)
    logits = (rng.normal(size=(n_b, 10)) * 3).astype(np.float32)
    for splits in (1, 4, 10):
        assert metrics.inception_score(logits, splits) == \
            jmetrics.inception_score(logits, splits)


def test_fid_of_identical_sets_is_zero_and_grows_with_a_shift():
    rng = np.random.default_rng(5)
    a, b = rng.normal(size=(400, 8)), rng.normal(size=(400, 8)) + 1.0
    st = metrics.feature_stats(a)
    assert abs(metrics.fid_from_stats(*st, *st)) < 1e-6
    assert metrics.fid_from_stats(*st, *metrics.feature_stats(b)) > 7.0


# ------------------------------------------------------------ preprocessing

@pytest.mark.parametrize("size,atol", [(128, 1e-6), (512, 1e-5)])
def test_preprocess_matches_jax(size, atol):
    x = np.random.default_rng(size).uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    want = np.asarray(jinc.preprocess_for_inception(jnp.asarray(x)))
    got = inception.preprocess_for_inception(torch.from_numpy(x))
    assert got.shape == (2, 3, 299, 299) and got.dtype == torch.float32
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=atol, rtol=0)


def test_preprocess_leaves_299_alone():
    x = torch.rand(1, 299, 299, 3) * 2 - 1
    assert torch.equal(inception.preprocess_for_inception(x), x.permute(0, 3, 1, 2))


# ------------------------------------------------------------- InceptionV3

# (features, kernel, stride, padding): every BasicConv2d shape of the trunk
CONVS = [(8, (3, 3), 2, (0, 0)), (8, (3, 3), 1, (1, 1)), (8, (1, 1), 1, (0, 0)),
         (8, (5, 5), 1, (2, 2)), (8, (1, 7), 1, (0, 3)), (8, (7, 1), 1, (3, 0)),
         (8, (1, 3), 1, (0, 1)), (8, (3, 1), 1, (1, 0))]


@pytest.mark.parametrize("conv", CONVS, ids=lambda c: f"k{c[1][0]}x{c[1][1]}s{c[2]}")
def test_basic_conv2d_matches_jax(conv):
    """Small BN variances make eps (1e-3, not 1e-5) show."""
    feats, kernel, stride, padding = conv
    x = np.random.default_rng(1).normal(size=(2, 11, 13, 5)).astype(np.float32)
    jmod = jinc.BasicConv2d(feats, kernel, stride=stride, padding=padding)
    v = jax_variables(jmod, jnp.asarray(x), 2)
    v["params"]["bn_var"] = np.linspace(1e-4, 2.0, feats, dtype=np.float32)
    want = np.asarray(jmod.apply(v, jnp.asarray(x)))
    mod = inception.BasicConv2d(5, feats, kernel, stride, padding)
    mod.load_state_dict({k: torch.from_numpy(a) for k, a in
                         jax_inception_to_state_dict(v).items()})
    got = mod(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=2e-5, rtol=1e-5)


BLOCKS = [("A", lambda: jinc.InceptionA(32), lambda: inception.InceptionA(24, 32)),
          ("B", lambda: jinc.InceptionB(), lambda: inception.InceptionB(24)),
          ("C", lambda: jinc.InceptionC(40), lambda: inception.InceptionC(24, 40)),
          ("D", lambda: jinc.InceptionD(), lambda: inception.InceptionD(24)),
          ("E", lambda: jinc.InceptionE(), lambda: inception.InceptionE(24))]


@pytest.mark.parametrize("block", BLOCKS, ids=lambda b: b[0])
def test_block_matches_jax(block):
    """Branch order, the pools (max VALID, average counting the padded
    zeros) and InceptionE's split branches, at a ragged 9 x 10."""
    _, make_j, make_t = block
    x = np.random.default_rng(3).normal(size=(2, 9, 10, 24)).astype(np.float32)
    jmod = make_j()
    v = jax_variables(jmod, jnp.asarray(x), 4)
    want = np.asarray(jmod.apply(v, jnp.asarray(x)))
    mod = make_t()
    mod.load_state_dict({k: torch.from_numpy(a) for k, a in
                         jax_inception_to_state_dict(v).items()})
    got = mod(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want,
                               atol=2e-5 * np.abs(want).max(), rtol=0)


def test_trunk_matches_jax(trunk):
    variables, japply, model = trunk
    x = np.random.default_rng(6).uniform(-1, 1, (2, 299, 299, 3)).astype(np.float32)
    jf, jl = (np.asarray(a) for a in japply(variables, jnp.asarray(x)))
    with torch.inference_mode(), inception.fp32_precision():
        tf, tl = model(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    assert tf.shape == (2, 2048) and tl.shape == (2, 1000)
    assert float(np.abs(jf).std()) > 0.05          # features that discriminate
    np.testing.assert_allclose(tf.numpy(), jf, atol=TRUNK_REL * np.abs(jf).max(), rtol=0)
    np.testing.assert_allclose(tl.numpy(), jl, atol=TRUNK_REL * np.abs(jl).max(), rtol=0)


def test_names_are_torchvisions_and_frozen(trunk):
    model = trunk[2]
    sd = model.state_dict()
    for name in ("Conv2d_1a_3x3.conv.weight", "Mixed_5b.branch1x1.bn.running_mean",
                 "Mixed_7c.branch3x3dbl_3b.bn.running_var", "Mixed_6e.branch7x7dbl_5.bn.bias",
                 "fc.weight", "fc.bias"):
        assert name in sd
    assert sd["Conv2d_1a_3x3.conv.weight"].shape == (32, 3, 3, 3)
    assert sd["fc.weight"].shape == (1000, 2048)
    assert not any(p.requires_grad for p in model.parameters())
    assert len(sd) == len(jax.tree_util.tree_leaves(trunk[0]))


def test_random_init_draws_the_jax_distribution():
    model = inception.init_random_inception(0)
    w = model.Mixed_6b.branch7x7_2.conv.weight
    fan_in = w[0].numel()
    assert abs(float(w.std()) / math.sqrt(2.0 / fan_in) - 1) < 0.05
    assert float(w.abs().max()) <= 2 * math.sqrt(2.0 / fan_in) / 0.87962566 + 1e-6
    bn = model.Mixed_6b.branch7x7_2.bn
    one, zero = torch.ones(128), torch.zeros(128)        # c7 of Mixed_6b
    assert torch.equal(bn.weight, one) and torch.equal(bn.running_var, one)
    assert torch.equal(bn.bias, zero) and torch.equal(bn.running_mean, zero)
    assert abs(float(model.fc.weight.std()) * math.sqrt(2048) - 1) < 0.05
    assert float(model.fc.bias.abs().max()) == 0.0
    again = inception.init_random_inception(0)
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                  again.state_dict().values()))
    x = torch.rand(2, 3, 299, 299) * 2 - 1
    with torch.inference_mode():
        f, _ = model(x)
    assert float(f.std()) > 0.05                  # He scaling: the signal survives


def test_fp32_precision_restores_the_flags():
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        with inception.fp32_precision():
            assert not torch.backends.cudnn.allow_tf32
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


# ------------------------------------------------------------------ harness

def test_compute_fid_is_matches_jax(trunk):
    variables, _, model = trunk
    rng = np.random.default_rng(7)
    real = [rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32) for _ in range(2)]
    # 24 fakes: IS's 10 splits of 2-3 images each (a split of one scores 1)
    fake = [np.clip(rng.normal(0.2, 0.6, (8, 32, 32, 3)), -1, 1).astype(np.float32)
            for _ in range(3)]
    want = jharness.compute_fid_is(iter(real), iter(fake), variables)
    got = harness.compute_fid_is(iter(real), iter(fake), model)
    assert got.keys() == want.keys() == {"fid", "is_mean", "is_std", "n_real", "n_fake"}
    assert (got["n_real"], got["n_fake"]) == (8, 24) and got["is_mean"] > 1.0
    for k in ("fid", "is_mean", "is_std"):
        assert math.isfinite(got[k])
        np.testing.assert_allclose(got[k], want[k], rtol=SCORE_RTOL, err_msg=k)


def test_feature_extractor_returns_host_arrays(trunk):
    ex = harness.FeatureExtractor(trunk[2], "cpu")
    x = np.zeros((3, 32, 32, 3), np.float32)
    f, l = ex.run([x, torch.from_numpy(x[:1])])
    assert isinstance(f, np.ndarray) and f.shape == (4, 2048) and l.shape == (4, 1000)


def test_read_lists_match_jax(tmp_path):
    (tmp_path / "trg.lst").write_text("a.png\n\nb.png\n  \nc.png")
    (tmp_path / "s2t.lst").write_text("a.png\tmake her smile\nb.png\n\nc.png\tadd glasses\t!\n")
    assert harness.read_list(str(tmp_path / "trg.lst")) == \
        jharness.read_list(str(tmp_path / "trg.lst"))
    assert harness.read_src2trg(str(tmp_path / "s2t.lst")) == \
        jharness.read_src2trg(str(tmp_path / "s2t.lst"))


def test_generate_fakes_matches_jax(tmp_path):
    rng = np.random.default_rng(8)
    for name, size in (("a.png", (44, 48)), ("b.png", (40, 40)), ("c.png", (52, 41))):
        Image.fromarray(rng.integers(0, 256, size + (3,), dtype=np.uint8)).save(
            tmp_path / name)
    pairs = [("a.png", "make her smile"), ("b.png", "add eyeglasses"),
             ("c.png", "remove the beard . make him older")]
    tcfg = load_config("configs/smoke.yaml")
    vocab = Vocab(tcfg.dataset)
    gen = build_generator(tcfg, vocab.size, device="cpu", seed=11)
    got = list(harness.generate_fakes(make_infer_fn(tcfg, gen), str(tmp_path), pairs,
                                      vocab, tcfg.image_size, tcfg.crop_size, 2,
                                      tcfg.max_text_len, "cpu"))

    cfg = jax_load_config("configs/smoke.yaml")
    jvocab = JaxVocab(cfg.dataset)
    jgen = JaxGenerator(cfg=cfg.gen, input_dim=cfg.input_dim, vocab_size=jvocab.size,
                        dtype=jnp.float32)
    params = convert_reference_generator(gen.state_dict(), cfg.gen, jvocab.size)["params"]
    try:
        infer = jax.jit(jax_make_infer_fn(cfg, jgen))
        want = list(jharness.generate_fakes(
            lambda p, x, i, l: infer(p, x, i, l), params, str(tmp_path), pairs, jvocab,
            cfg.image_size, cfg.crop_size, 2, cfg.max_text_len))
    finally:
        jnorms.set_stats_mode("2pass")
    assert [g.shape for g in got] == [np.asarray(w).shape for w in want] == \
        [(2, 32, 32, 3), (1, 32, 32, 3)]
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray) and g.dtype == np.float32
        np.testing.assert_allclose(g, np.asarray(w), atol=FAKES_ATOL, rtol=0)
