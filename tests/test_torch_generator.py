"""The port's generator and serving path against the JAX package.

A JAX `Generator` is built directly (so `use_pallas=True` really runs the
Pallas kernels, in interpret mode on the CPU; `build_models` would switch
them off here) at `configs/smoke.yaml` widths, 32 px, fp32, batch 3.  Its
parameters go into the port through `load_jax_params`; both sides get the
same numpy inputs.  `encode`, `encode_txt`, `decode` and the whole `infer`
agree within atol 1e-4:

- with the jnp norms, in both stats modes;
- with the Pallas norm kernels (2pass, the only mode they have).

`load_jax_params` is also checked by a round trip through the JAX package's
own reference-checkpoint importer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwcgan_tpu.config import load_config as jax_load_config
from dwcgan_tpu.interop.torch_import import convert_reference_generator
from dwcgan_tpu.models.generator import Generator as JaxGenerator
from dwcgan_tpu.ops import norms as jnorms
from dwcgan_tpu.text.vocab import Vocab as JaxVocab, encode_commands
from dwcgan_tpu.train.sampler import make_infer_fn as jax_make_infer_fn
from dwcgan_tpu_torch.config import load_config
from dwcgan_tpu_torch.interop.jax_params import flatten_params, load_jax_params
from dwcgan_tpu_torch.models.generator import build_generator
from dwcgan_tpu_torch.train.sampler import make_infer_fn

torch.set_num_threads(1)

CONFIG = "configs/smoke.yaml"
BATCH = 3
ATOL = 1e-4
COMMANDS = ["make her smile", "add glasses and remove the beard . make him older",
            "keep it unchanged!"]
# (use_pallas on the JAX side, norm_stats)
VARIANTS = [(False, "2pass"), (False, "1pass"), (True, "2pass")]


def _inputs(cfg, vocab):
    rng = np.random.default_rng(0)
    s = cfg.image_size
    images = rng.uniform(-1, 1, (BATCH, s, s, 3)).astype(np.float32)
    ids, lens = encode_commands(COMMANDS, vocab, cfg.max_text_len)
    style = rng.normal(size=(BATCH, cfg.gen.style_dim)).astype(np.float32)
    content = rng.normal(size=(BATCH, s // 4, s // 4, 4 * cfg.gen.dim)).astype(np.float32)
    return dict(images=images, ids=np.asarray(ids), lens=np.asarray(lens),
                style=style, content=content)


@pytest.fixture(scope="module")
def jax_params():
    cfg = jax_load_config(CONFIG)
    vocab = JaxVocab(cfg.dataset)
    gen = JaxGenerator(cfg=cfg.gen, input_dim=cfg.input_dim,
                       vocab_size=vocab.size, dtype=jnp.float32)
    dummy = jnp.zeros((1, cfg.image_size, cfg.image_size, 3), jnp.float32)
    params = jax.jit(gen.init)({"params": jax.random.PRNGKey(1),
                                "dropout": jax.random.PRNGKey(2)}, dummy)["params"]
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module", params=VARIANTS, ids=lambda v: f"pallas{int(v[0])}-{v[1]}")
def both(request, jax_params):
    """JAX outputs (computed here, with the stats mode set while tracing)
    and the port generator loaded with the same parameters."""
    use_pallas, stats = request.param
    cfg = jax_load_config(CONFIG)
    cfg.norm_stats = stats
    vocab = JaxVocab(cfg.dataset)
    inp = _inputs(cfg, vocab)
    gen = JaxGenerator(cfg=cfg.gen, input_dim=cfg.input_dim,
                       vocab_size=vocab.size, dtype=jnp.float32,
                       use_pallas=use_pallas)
    v = {"params": jax_params}
    try:
        infer = jax_make_infer_fn(cfg, gen)   # sets the JAX stats mode
        ref = dict(
            encode=gen.apply(v, inp["images"], method="encode"),
            encode_txt=gen.apply(v, inp["style"], inp["ids"], inp["lens"],
                                 method="encode_txt"),
            decode=gen.apply(v, inp["content"], inp["style"], method="decode"),
            infer=infer(jax_params, inp["images"], inp["ids"], inp["lens"]),
        )
    finally:
        jnorms.set_stats_mode("2pass")
    ref = jax.tree_util.tree_map(np.asarray, ref)

    tcfg = load_config(CONFIG)
    tcfg.norm_stats = stats
    port = build_generator(tcfg, vocab.size, device="cpu")
    load_jax_params(port, jax_params)
    return dict(ref=ref, inp=inp, port=port, cfg=tcfg)


def _close(got, want):
    got = [g.detach().numpy() if isinstance(g, torch.Tensor) else g for g in got]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)


def test_encode(both):
    inp, port = both["inp"], both["port"]
    with torch.inference_mode():
        got = port.encode(torch.from_numpy(inp["images"]))
    _close(got, both["ref"]["encode"])


def test_encode_txt(both):
    inp, port = both["inp"], both["port"]
    with torch.inference_mode():
        got = port.encode_txt(torch.from_numpy(inp["style"]),
                              torch.from_numpy(inp["ids"]),
                              torch.from_numpy(inp["lens"]))
    _close(got, both["ref"]["encode_txt"])


def test_decode(both):
    inp, port = both["inp"], both["port"]
    with torch.inference_mode():
        got = port.decode(torch.from_numpy(inp["content"]),
                          torch.from_numpy(inp["style"]))
    _close(got, both["ref"]["decode"])


def test_infer(both):
    inp = both["inp"]
    infer = make_infer_fn(both["cfg"], both["port"])
    got = infer(torch.from_numpy(inp["images"]), torch.from_numpy(inp["ids"]),
                torch.from_numpy(inp["lens"]))
    assert got.dtype == torch.float32
    _close([got], [both["ref"]["infer"]])


def test_load_jax_params_round_trip(jax_params):
    """JAX params -> port -> state_dict -> the JAX package's importer ->
    the same JAX params, exactly (names, shapes and values)."""
    cfg = jax_load_config(CONFIG)
    vocab = JaxVocab(cfg.dataset)
    port = build_generator(load_config(CONFIG), vocab.size, device="cpu", seed=5)
    load_jax_params(port, jax_params)
    back = convert_reference_generator(port.state_dict(), cfg.gen, vocab.size)
    want, got = flatten_params(jax_params), flatten_params(back)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_load_jax_params_accepts_a_flat_dict(jax_params):
    cfg = load_config(CONFIG)
    vocab = JaxVocab(cfg.dataset)
    a = build_generator(cfg, vocab.size, device="cpu", seed=1)
    b = build_generator(cfg, vocab.size, device="cpu", seed=2)
    load_jax_params(a, jax_params)
    load_jax_params(b, {"params/" + k: v for k, v in flatten_params(jax_params).items()})
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)


def test_seeded_weights_are_reproducible():
    cfg = load_config(CONFIG)
    a = build_generator(cfg, 102, device="cpu", seed=3).state_dict()
    b = build_generator(cfg, 102, device="cpu", seed=3).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_bf16_compute_runs_and_stays_close():
    """compute_dtype bfloat16 on the CPU: finite, NHWC, near the fp32 run."""
    cfg = load_config(CONFIG)
    vocab = JaxVocab(cfg.dataset)
    inp = _inputs(jax_load_config(CONFIG), vocab)
    outs = []
    for dtype in ("float32", "bfloat16"):
        cfg.compute_dtype = dtype
        gen = build_generator(cfg, vocab.size, device="cpu", seed=4)
        outs.append(make_infer_fn(cfg, gen)(
            torch.from_numpy(inp["images"]), torch.from_numpy(inp["ids"]),
            torch.from_numpy(inp["lens"])))
    assert outs[1].shape == (BATCH, 32, 32, 3) and torch.isfinite(outs[1]).all()
    assert float((outs[0] - outs[1]).abs().max()) < 0.1


def test_norm_compute_bf16_is_rejected():
    """`norm_compute: bf16` is ported: it builds, every in / adain block
    normalising in bf16 (`tests/test_torch_norm_compute.py` holds it
    against JAX); a value outside the schema is still rejected."""
    cfg = load_config(CONFIG)
    cfg.norm_compute = "bf16"
    gen = build_generator(cfg, 102, device="cpu")
    arith = {m.arith for m in gen.modules() if hasattr(m, "arith")}
    assert arith == {"bf16"}
    cfg.norm_compute = "fp16"
    with pytest.raises(ValueError, match="arith"):
        build_generator(cfg, 102, device="cpu")
