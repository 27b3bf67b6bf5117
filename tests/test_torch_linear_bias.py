"""A Linear layer's bias in bf16, against the JAX package on the CPU.

flax's `nn.Dense(dtype=bfloat16)` computes the product in bf16 and then
adds the bias cast to bf16: two roundings (dwcgan_tpu/ops/blocks.py:271-272,
the style encoder's mapping at dwcgan_tpu/models/generator.py:125-128).  A
bias passed into `F.linear` is added to the fp32 sum and rounds once, which
puts about a quarter of the outputs one ulp apart ([16, 64] @ [64, 48]^T,
bias N(0, 0.5)).  The JAX init draws zero biases, so every other parity
test is blind to it; here the biases are N(0, 0.5) from a numpy seed and
reach the port through `load_jax_params`.

Each case is bit-equal to JAX bf16: `LinearBlock` (ReLU and none), the
style encoder with its mapping on (every bias of it drawn: convolutions,
mapping and heads) and the decoder's style MLP.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwcgan_tpu.config import load_config as jax_load_config
from dwcgan_tpu.models.generator import Generator as JaxGenerator
from dwcgan_tpu.ops.blocks import LinearBlock as JaxLinearBlock
from dwcgan_tpu.text.vocab import Vocab as JaxVocab
from dwcgan_tpu_torch.config import load_config
from dwcgan_tpu_torch.interop.jax_params import load_jax_params
from dwcgan_tpu_torch.models.generator import build_generator
from dwcgan_tpu_torch.ops.blocks import LinearBlock

torch.set_num_threads(1)

CONFIG = "configs/smoke.yaml"
BIAS_STD = 0.5


def _biased(params, seed, keep=lambda path: True):
    """`params` with every bias (whose path `keep` accepts) drawn from
    N(0, BIAS_STD) by a numpy generator."""
    rng = np.random.default_rng(seed)

    def draw(path, v):
        key = jax.tree_util.keystr(path)
        if key.endswith("['bias']") and keep(key):
            return (BIAS_STD * rng.standard_normal(v.shape)).astype(np.float32)
        return np.asarray(v)
    return jax.tree_util.tree_map_with_path(draw, params)


def _bit_equal(got, want):
    want = np.asarray(want, np.float32)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("activ", ["relu", "none"])
def test_linear_block_bias_rounds_as_flax(activ):
    """64 -> 48 features on [16, 64]."""
    x = np.random.default_rng(0).standard_normal((16, 64)).astype(np.float32)
    block = JaxLinearBlock(48, "none", activ, dtype=jnp.bfloat16)
    params = _biased(block.init(jax.random.PRNGKey(0), jnp.zeros((1, 64)))["params"], 1)
    want = block.apply({"params": params}, jnp.asarray(x, jnp.bfloat16))
    port = LinearBlock(64, 48, "none", activ)
    dense = params["Dense_0"]
    port.load_state_dict({"fc.weight": torch.from_numpy(dense["kernel"].T.copy()),
                          "fc.bias": torch.from_numpy(dense["bias"])})
    with torch.no_grad():
        got = port(torch.from_numpy(x).bfloat16())
    _bit_equal(got, want)


def _generators(seed, keep):
    """The JAX bf16 generator of `configs/smoke.yaml` with the biases that
    `keep` accepts drawn N(0, 0.5), and the port's bf16 generator with the
    same parameters."""
    cfg = jax_load_config(CONFIG)
    vocab = JaxVocab(cfg.dataset)
    gen = JaxGenerator(cfg=cfg.gen, input_dim=cfg.input_dim,
                       vocab_size=vocab.size, dtype=jnp.bfloat16)
    shape = (1, cfg.image_size, cfg.image_size, 3)
    params = jax.jit(gen.init)({"params": jax.random.PRNGKey(seed),
                                "dropout": jax.random.PRNGKey(seed + 1)},
                               jnp.zeros(shape))["params"]
    params = _biased(params, seed + 2, keep)
    tcfg = load_config(CONFIG)
    tcfg.compute_dtype = "bfloat16"
    port = build_generator(tcfg, vocab.size, device="cpu")
    load_jax_params(port, params)
    return cfg, gen, {"params": params}, port


def test_style_encoder_mapping_bias_rounds_as_flax():
    """The style encoder, mapping on, every bias of it N(0, 0.5): mu and
    logvar of three images."""
    cfg, gen, v, port = _generators(3, keep=lambda k: "enc_style" in k)
    assert cfg.gen.use_map
    images = np.random.default_rng(4).uniform(
        -1, 1, (3, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    _, mu, logvar = gen.apply(v, images, method="encode")
    with torch.inference_mode():
        _, got_mu, got_logvar = port.encode(torch.from_numpy(images))
    _bit_equal(got_mu, mu)
    _bit_equal(got_logvar, logvar)


def test_decoder_style_mlp_bias_rounds_as_flax():
    """The decoder's style MLP (its three LinearBlocks), every bias N(0,
    0.5), on four styles: the AdaIN parameters it hands the decoder."""
    cfg, gen, v, port = _generators(5, keep=lambda k: "mlp" in k)
    style = np.random.default_rng(6).standard_normal(
        (4, cfg.gen.num_cls * cfg.gen.c_dim)).astype(np.float32)
    want = gen.apply(v, jnp.asarray(style, jnp.bfloat16),
                     method=lambda m, s: m.mlp(s))
    with torch.inference_mode():
        got = port.mlp(torch.from_numpy(style).bfloat16())
    _bit_equal(got, want)
