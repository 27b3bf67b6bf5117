"""The port's legacy (v1) model family and the library's leftover helpers
against the JAX package.

The five legacy modules of `dwcgan_tpu/models/legacy.py` are built at
small widths (dim 8, style_dim 8, 2 downsamples, 2 residual blocks,
mlp_dim 16, a 2-layer LSTM of 12, 32 px, batch 3), initialised by flax with
N(0, 0.1) noise added to every bias (flax draws zero biases, which would
hide how a bias is mapped or rounded), and loaded into the port through
`load_jax_legacy_params`.  Both sides get the same numpy inputs.

- fp32: every output within atol 1e-4, as the v2 generator's parity test
  holds it (summation order only).
- bf16: both compute in bf16.  The port cannot be bit-equal where an
  instance norm of a 1-ulp different convolution feeds the next layer (the
  content encoders, as in the v2 bf16 step), so each output is held
  within half of JAX's own fp32-vs-bf16 gap on the same input (mean
  absolute difference; a port that computed in fp32 would be the whole gap
  away).  Measured on an x86 CPU: 0.23 of it for `VAEGen`'s image, 0.12-0.15
  for the content codes, 0.014 for `AdaINGenV1.decode`'s image; the style
  encoder is bit-equal.
  The text encoder is bit-equal, as the v2 one is in bf16.  The decoders
  take the content code in bf16, as `encode` hands it on.

The flat GMM losses, `focal_loss` in its four forms, the two constraints,
`sample_style_flat` with injected draws, the interpolation helpers and the
label helpers are held to their JAX counterparts on seeded inputs: the
numpy ones bit-equal, the torch ones within rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwcgan_tpu.data import labels as jlabels
from dwcgan_tpu.losses import gan as jgan
from dwcgan_tpu.losses import gmm as jgmm
from dwcgan_tpu.models import legacy as jlegacy
from dwcgan_tpu.train.sampling import sample_style_flat as j_sample_style_flat
from dwcgan_tpu.utils import interp as jinterp
from dwcgan_tpu_torch.data import labels as tlabels
from dwcgan_tpu_torch.interop.jax_params import (jax_legacy_to_state_dict,
                                                 load_jax_legacy_params)
from dwcgan_tpu_torch.losses import gan as tgan
from dwcgan_tpu_torch.losses import gmm as tgmm
from dwcgan_tpu_torch.models import legacy as tlegacy
from dwcgan_tpu_torch.train.sampling import sample_style_flat
from dwcgan_tpu_torch.utils import interp as tinterp

torch.set_num_threads(1)

N, S, VOCAB, T = 3, 32, 102, 6
ATOL = 1e-4
BF16_GAP_SHARE = 0.5
GEN = dict(dim=8, style_dim=8, n_downsample=2, n_res=2, mlp_dim=16,
           embed_dim=12, hidden_size=12, num_layers=2, vocab_size=VOCAB)
TXT = dict(vocab_size=VOCAB, style_dim=8, embed_dim=12, hidden_size=12,
           num_layers=2)
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs():
    rng = np.random.default_rng(0)
    lens = np.array([T, 3, 1], np.int32)
    ids = rng.integers(4, VOCAB, (N, T)).astype(np.int32)
    ids[np.arange(T)[None, :] >= lens[:, None]] = 0
    return dict(images=rng.uniform(-1, 1, (N, S, S, 3)).astype(np.float32),
                style=rng.normal(size=(N, 8)).astype(np.float32),
                content=rng.normal(size=(N, S // 4, S // 4, 32)).astype(np.float32),
                ids=ids, lens=lens)


def _with_biases(params, seed):
    rng = np.random.default_rng(seed)

    def f(path, v):
        v = np.asarray(v, np.float32)
        leaf = jax.tree_util.keystr(path)
        if leaf.endswith("'bias']") or leaf.endswith("_b']"):
            v = v + rng.normal(0.0, 0.1, v.shape).astype(np.float32)
        return v
    return jax.tree_util.tree_map_with_path(f, params)


def _init(module, *args):
    params = module.init(jax.random.PRNGKey(0), *args)["params"]
    return _with_biases(params, 1)


@pytest.fixture(scope="module")
def inp():
    return _inputs()


@pytest.fixture(scope="module")
def params(inp):
    x = jnp.asarray(inp["images"])
    style = jnp.asarray(inp["style"])
    return {
        "AdaINGenV1": _init(jlegacy.AdaINGenV1(**GEN), x),
        "VAEGen": _init(jlegacy.VAEGen(dim=8, n_downsample=2, n_res=2), x),
        "StyleEncoderV1": _init(jlegacy.StyleEncoderV1(dim=8, style_dim=8), x),
        "ContentEncoderOld": _init(jlegacy.ContentEncoderOld(dim=8, n_res=2), x),
        "TxtEncoderV1": _init(jlegacy.TxtEncoderV1(**TXT), style,
                              jnp.asarray(inp["ids"]), jnp.asarray(inp["lens"])),
    }


def _port(kind, dtype):
    if kind == "AdaINGenV1":
        return tlegacy.AdaINGenV1(dtype=dtype, **GEN)
    if kind == "VAEGen":
        return tlegacy.VAEGen(dim=8, n_downsample=2, n_res=2, dtype=dtype)
    if kind == "StyleEncoderV1":
        return tlegacy.StyleEncoderV1(dim=8, style_dim=8)
    if kind == "ContentEncoderOld":
        return tlegacy.ContentEncoderOld(dim=8, n_res=2)
    return tlegacy.TxtEncoderV1(dtype=dtype, **TXT)


def _jax(kind, dtype):
    if kind == "AdaINGenV1":
        return jlegacy.AdaINGenV1(dtype=dtype, **GEN)
    if kind == "VAEGen":
        return jlegacy.VAEGen(dim=8, n_downsample=2, n_res=2, dtype=dtype)
    if kind == "StyleEncoderV1":
        return jlegacy.StyleEncoderV1(dim=8, style_dim=8, dtype=dtype)
    if kind == "ContentEncoderOld":
        return jlegacy.ContentEncoderOld(dim=8, n_res=2, dtype=dtype)
    return jlegacy.TxtEncoderV1(dtype=dtype, **TXT)


def _nchw(x, dtype):
    return torch.from_numpy(x).permute(0, 3, 1, 2).to(dtype).contiguous(
        memory_format=torch.channels_last)


def _run_port(kind, method, model, inp, tdtype, noise=None):
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    with torch.inference_mode():
        if kind == "StyleEncoderV1":
            return model(_nchw(inp["images"], tdtype))
        if kind == "ContentEncoderOld":
            return (model(_nchw(inp["images"], tdtype)).permute(0, 2, 3, 1),)
        if kind == "TxtEncoderV1":
            return model(t["style"], t["ids"], t["lens"])
        if kind == "VAEGen":
            if method == "noise":
                return model(t["images"], deterministic=False, noise=noise)
            return model(t["images"])
        if method == "encode":
            return model.encode(t["images"])
        if method == "encode_txt":
            return model.encode_txt(t["style"], t["ids"], t["lens"])
        return model.decode(t["content"], t["style"])


def _run_jax(kind, method, jdtype, p, inp, key=None):
    m = _jax(kind, jdtype)
    v = {"params": p}
    if kind in ("StyleEncoderV1", "ContentEncoderOld"):
        out = m.apply(v, inp["images"])
        return out if isinstance(out, tuple) else (out,)
    if kind == "TxtEncoderV1":
        return m.apply(v, inp["style"], inp["ids"], inp["lens"])
    if kind == "VAEGen":
        if method == "noise":
            return m.apply(v, inp["images"], key=key, deterministic=False)
        return m.apply(v, inp["images"])
    if method == "encode":
        return m.apply(v, inp["images"], method="encode")
    if method == "encode_txt":
        return m.apply(v, inp["style"], inp["ids"], inp["lens"], method="encode_txt")
    # the content code in the compute dtype, as `encode` hands it on (a
    # JAX residual stack fed fp32 would keep its sum in fp32)
    return m.apply(v, jnp.asarray(inp["content"], jdtype), inp["style"],
                   method="decode")


CASES = [("AdaINGenV1", "encode"), ("AdaINGenV1", "encode_txt"),
         ("AdaINGenV1", "decode"), ("VAEGen", "forward"), ("VAEGen", "noise"),
         ("StyleEncoderV1", "forward"), ("ContentEncoderOld", "forward"),
         ("TxtEncoderV1", "forward")]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind,method", CASES, ids=[f"{k}-{m}" for k, m in CASES])
def test_legacy_module_matches_jax(kind, method, dtype, params, inp):
    jdtype, tdtype = DTYPES[dtype]
    p = params[kind]
    key = jax.random.PRNGKey(5)
    want = [np.asarray(w, np.float32) for w in
            jax.tree_util.tree_leaves(_run_jax(kind, method, jdtype, p, inp, key))]
    noise = None
    if method == "noise":   # JAX's draw, in the hiddens' dtype
        hid = _run_jax(kind, "forward", jdtype, p, inp)[1]
        noise = torch.from_numpy(np.array(
            jax.random.normal(key, hid.shape, hid.dtype), np.float32))
    model = _port(kind, tdtype)
    load_jax_legacy_params(model, p)
    model.eval()
    got = [g.float().numpy() for g in _run_port(kind, method, model, inp, tdtype, noise)
           if g is not None]
    assert len(got) == len(want)
    if dtype == "fp32":
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)
        return
    ref32 = [np.asarray(w, np.float32) for w in jax.tree_util.tree_leaves(
        _run_jax(kind, method, jnp.float32, p, inp, key))]
    for g, w, w32 in zip(got, want, ref32):
        assert g.shape == w.shape and np.isfinite(g).all()
        gap = np.abs(w32 - w).mean()
        if kind == "TxtEncoderV1" or method == "encode_txt":
            np.testing.assert_array_equal(g, w)
        else:
            assert np.abs(g - w).mean() <= BF16_GAP_SHARE * gap, (
                np.abs(g - w).mean(), gap)


def test_vae_noise_from_a_generator_changes_the_output(params, inp):
    model = tlegacy.VAEGen(dim=8, n_downsample=2, n_res=2)
    load_jax_legacy_params(model, params["VAEGen"])
    x = torch.from_numpy(inp["images"])
    with torch.inference_mode():
        det, h = model(x)
        g = torch.Generator().manual_seed(0)
        noisy, h2 = model(x, deterministic=False, generator=g)
    assert det.shape == x.shape and h.shape == (N, 8, 8, 32)
    assert not torch.allclose(det, noisy) and not torch.equal(h, h2)


def test_legacy_mapping_is_strict(params):
    """Every JAX leaf lands on one port parameter, and a stray leaf raises."""
    p = dict(params["StyleEncoderV1"])
    sd = jax_legacy_to_state_dict(p, "StyleEncoderV1", n_downsample=5, use_map=True)
    assert set(sd) == set(tlegacy.StyleEncoderV1(dim=8, style_dim=8).state_dict())
    p["extra"] = {"kernel": np.zeros((1, 1))}
    with pytest.raises(KeyError, match="extra"):
        jax_legacy_to_state_dict(p, "StyleEncoderV1", n_downsample=5, use_map=True)
    with pytest.raises(ValueError, match="legacy"):
        jax_legacy_to_state_dict(p, "Generator")


def test_txt_encoder_v1_head_rows_at_one_class(params):
    """At num_cls 1 the head's rows still go from the JAX order [h all
    layers, c all layers] to the port's per-layer [h_l, c_l]."""
    p = params["TxtEncoderV1"]
    sd = jax_legacy_to_state_dict(p, "TxtEncoderV1", **tlegacy.TxtEncoderV1(**TXT).dims)
    k = np.asarray(p["inner"]["head_mu"]["kernel"])       # [L*4*H, 8]
    H = TXT["hidden_size"]
    w = sd["inner.fcs.0.weight"].T                         # port rows
    # port block order per layer: h_fwd, h_bwd, c_fwd, c_bwd
    np.testing.assert_array_equal(w[2 * H:4 * H], k[4 * H:6 * H])  # c of layer 0
    np.testing.assert_array_equal(w[4 * H:6 * H], k[2 * H:4 * H])  # h of layer 1


def test_build_legacy_generator_on_the_cpu():
    gen = tlegacy.build_legacy_generator("AdaINGenV1", device="cpu", seed=3, **GEN)
    again = tlegacy.build_legacy_generator("AdaINGenV1", device="cpu", seed=3, **GEN)
    for (n, a), b in zip(gen.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), n
    assert not gen.training
    assert not any(p.requires_grad for n, p in gen.named_parameters()
                   if ".bias_hh" in n)
    vae = tlegacy.build_legacy_generator("VAEGen", device="cpu", dim=8, n_res=2)
    with torch.inference_mode():
        out, _ = vae(torch.zeros(1, 16, 16, 3))
    assert out.shape == (1, 16, 16, 3) and torch.isfinite(out).all()
    with pytest.raises(ValueError, match="legacy"):
        tlegacy.build_legacy_generator("Generator", device="cpu")


# ------------------------------------------------------- leftover helpers

def _t(x):
    return torch.from_numpy(np.asarray(x))


def _rng_arrays():
    r = np.random.default_rng(7)
    mu = r.normal(size=(4, 8)).astype(np.float32)
    var = np.exp(r.normal(size=(4, 8))).astype(np.float32)
    m = np.sign(r.normal(size=(4, 8))).astype(np.float32)
    return mu, var, m


def test_gmm_flat_losses_match_jax():
    mu, var, m = _rng_arrays()
    np.testing.assert_allclose(float(tgmm.gmm_kl_flat(_t(mu), _t(var), _t(m), 0.25)),
                               float(jgmm.gmm_kl_flat(mu, var, m, 0.25)), rtol=1e-6)
    np.testing.assert_allclose(float(tgmm.gmm_emd_flat(_t(mu), _t(m))),
                               float(jgmm.gmm_emd_flat(mu, m)), rtol=1e-6)


@pytest.mark.parametrize("logits", [True, False])
@pytest.mark.parametrize("use_reduce", [True, False])
def test_focal_loss_matches_jax(logits, use_reduce):
    r = np.random.default_rng(8)
    x = r.normal(size=(5, 8)).astype(np.float32)
    if not logits:
        x = 1.0 / (1.0 + np.exp(-x))
    t = (r.uniform(size=(5, 8)) > 0.5).astype(np.float32)
    got = tgan.focal_loss(_t(x), _t(t), alpha=0.75, gamma=2.0, logits=logits,
                          use_reduce=use_reduce).numpy()
    want = np.asarray(jgan.focal_loss(x, t, alpha=0.75, gamma=2.0, logits=logits,
                                      use_reduce=use_reduce))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_isometry_and_mode_seeking_constraints_match_jax():
    r = np.random.default_rng(9)
    z1, z2, r1, r2 = (r.normal(size=(3, 8)).astype(np.float32) for _ in range(4))
    im1, im2 = (r.normal(size=(3, 4, 4, 3)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(
        float(tgan.isometry_constraint(_t(z1), _t(z2), _t(r1), _t(r2))),
        float(jgan.isometry_constraint(z1, z2, r1, r2)), rtol=1e-5)
    np.testing.assert_allclose(
        float(tgan.mode_seeking_constraint(_t(im1), _t(im2), _t(z1), _t(z2))),
        float(jgan.mode_seeking_constraint(im1, im2, z1, z2)), rtol=1e-6)


@pytest.mark.parametrize("v_dim", [1, 3])
def test_sample_style_flat_takes_jax_layout(v_dim):
    mu = np.random.default_rng(10).normal(size=(4, 6)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want = np.asarray(j_sample_style_flat(key, mu, v_dim, 0.5))
    eps = torch.from_numpy(np.asarray(jax.random.normal(key, (4, 6, v_dim))))
    got = sample_style_flat(_t(mu), v_dim, 0.5, eps=eps)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    drawn = sample_style_flat(_t(mu), v_dim, 0.5,
                              generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (4, 6 * v_dim)


def test_slerp_and_interp_grid_bit_equal_to_jax():
    r = np.random.default_rng(12)
    low, high = r.normal(size=5), r.normal(size=5)
    for v in (0.0, 0.3, 1.0):
        np.testing.assert_array_equal(tinterp.slerp(v, low, high),
                                      jinterp.slerp(v, low, high))
    np.testing.assert_array_equal(tinterp.slerp(0.4, low, 2 * low),
                                  jinterp.slerp(0.4, low, 2 * low))
    np.testing.assert_array_equal(tinterp.get_slerp_interp(2, 3, 8, seed=4),
                                  jinterp.get_slerp_interp(2, 3, 8, seed=4))


def test_label_helpers_bit_equal_to_jax():
    idx = np.array([0, 3, 1, 2])
    np.testing.assert_array_equal(tlabels.label2onehot(idx, 5),
                                  jlabels.label2onehot(idx, 5))
    binary = np.array([[1, 0, 1], [0, 0, 1]], np.float32)
    for mode, lab, c_dim in (("CelebA", binary, None), ("CUB200", binary, None),
                             ("RaFD", idx, 5)):
        for norm in (True, False):
            np.testing.assert_array_equal(
                tlabels.assign_label(lab, c_dim, mode, norm),
                jlabels.assign_label(lab, c_dim, mode, norm))
    attrs = ["Black_Hair", "Blond_Hair", "Brown_Hair", "Male", "Young"]
    c_org = np.random.default_rng(13).integers(0, 2, (4, 5)).astype(np.float32)
    for dataset in ("CelebA", "RaFD"):
        got = tlabels.create_labels(c_org, 5, dataset, attrs)
        want = jlabels.create_labels(c_org, 5, dataset, attrs)
        assert len(got) == len(want) == 5
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
