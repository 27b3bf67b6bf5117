"""The port's text encoder in bf16 against the JAX text encoder in bf16.

The JAX `TxtEncoder` computes in the compute dtype: the embedding output,
the style broadcast, the LSTM's input projection, its recurrence with `h`
and `c`, and the heads (dwcgan_tpu/ops/lstm.py:121-150,
models/generator.py:184-202).  The port must compute the same function.
At `configs/smoke.yaml` widths (embed 12, hidden 12, two layers, batch 3)
the JAX encoder in fp32 and in bf16 differ by up to 0.0168 (mu) and 0.0253
(logvar), values up to 2.7; an encoder that computes in fp32 is that far
from the bf16 reference.  The tolerance below, 2e-3, is under a tenth of
that gap: only an encoder that rounds where the JAX one rounds stays inside
it (the port's loop is bit-equal to it on this CPU).

Two styles go in: a seeded random one, and the style `infer` feeds the text
encoder (the JAX bf16 `encode` of seeded images), so the check covers
`encode_txt` as the serving path calls it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwcgan_tpu.config import load_config as jax_load_config
from dwcgan_tpu.models.generator import Generator as JaxGenerator
from dwcgan_tpu.text.vocab import Vocab as JaxVocab, encode_commands
from dwcgan_tpu_torch.config import load_config
from dwcgan_tpu_torch.interop.jax_params import load_jax_params
from dwcgan_tpu_torch.models.generator import build_generator

torch.set_num_threads(1)

CONFIG = "configs/smoke.yaml"
ATOL = 2e-3     # the fp32-vs-bf16 gap of the JAX encoder here: 0.0168 / 0.0253
COMMANDS = ["make her smile", "add glasses and remove the beard . make him older",
            "keep it unchanged!"]


@pytest.fixture(scope="module")
def setup():
    cfg = jax_load_config(CONFIG)
    vocab = JaxVocab(cfg.dataset)
    gen = JaxGenerator(cfg=cfg.gen, input_dim=cfg.input_dim,
                       vocab_size=vocab.size, dtype=jnp.bfloat16)
    rng = np.random.default_rng(0)
    images = rng.uniform(-1, 1, (3, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    params = jax.jit(gen.init)({"params": jax.random.PRNGKey(1),
                                "dropout": jax.random.PRNGKey(2)},
                               jnp.zeros((1,) + images.shape[1:]))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    v = {"params": params}
    _, mu, _ = gen.apply(v, images, method="encode")
    styles = {"random": rng.normal(size=(3, cfg.gen.style_dim)).astype(np.float32),
              "from_encode": np.asarray(mu, np.float32).reshape(3, -1)}
    ids, lens = encode_commands(COMMANDS, vocab, cfg.max_text_len)
    ids, lens = np.asarray(ids), np.asarray(lens)
    ref = {k: [np.asarray(a, np.float32) for a in gen.apply(
        v, s, ids, lens, method="encode_txt")] for k, s in styles.items()}

    tcfg = load_config(CONFIG)
    tcfg.compute_dtype = "bfloat16"
    port = build_generator(tcfg, vocab.size, device="cpu")
    load_jax_params(port, params)
    return dict(port=port, styles=styles, ids=ids, lens=lens, ref=ref)


@pytest.mark.parametrize("style", ["random", "from_encode"])
def test_encode_txt_bf16_matches_jax_bf16(setup, style):
    port = setup["port"]
    with torch.inference_mode():
        got = port.encode_txt(torch.from_numpy(setup["styles"][style]),
                              torch.from_numpy(setup["ids"]),
                              torch.from_numpy(setup["lens"]))
    for g, w in zip(got, setup["ref"][style]):
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.float().numpy(), w, atol=ATOL, rtol=0)
