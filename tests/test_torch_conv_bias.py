"""A convolution's bias in bf16, against the JAX package on the CPU.

flax's `nn.Conv(dtype=bfloat16)` and the decoder's fused heads compute the
convolution in bf16 and then add the bias cast to bf16: two roundings
(dwcgan_tpu/ops/blocks.py:216, dwcgan_tpu/models/generator.py:295-300,
discriminator.py:46, vgg.py:45).  A bias passed into `F.conv2d` is added to
the fp32 sum and rounds once, which puts about a third of the outputs one
ulp apart (3 x 3 conv, 32 -> 32, [2, 16, 16], bias N(0, 0.5)).  The JAX
init draws zero biases, so every other parity test is blind to it; here
the biases are N(0, 0.5) from a numpy seed.

Each case is bit-equal to JAX bf16: `Conv2dBlock`, the decoder's image and
attention heads (fed the JAX decoder's own input to them), the whole bf16
discriminator (every bias, the `src` heads' too) and one VGG16 layer.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwcgan_tpu.config import load_config as jax_load_config
from dwcgan_tpu.models.discriminator import MsImageDis as JaxDis
from dwcgan_tpu.models.generator import Generator as JaxGenerator
from dwcgan_tpu.models.vgg import init_random_vgg
from dwcgan_tpu.ops.blocks import Conv2dBlock as JaxConv2dBlock
from dwcgan_tpu.text.vocab import Vocab as JaxVocab
from dwcgan_tpu_torch.config import load_config
from dwcgan_tpu_torch.interop.jax_params import (jax_vgg_to_state_dict,
                                                 load_jax_dis_params,
                                                 load_jax_params)
from dwcgan_tpu_torch.models.discriminator import MsImageDis
from dwcgan_tpu_torch.models.generator import build_generator
from dwcgan_tpu_torch.models.vgg import Vgg16Features
from dwcgan_tpu_torch.ops.blocks import Conv2dBlock

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


def _nchw(a, dtype=torch.bfloat16):
    """NHWC numpy -> NCHW channels_last torch tensor of `dtype`."""
    t = torch.from_numpy(np.asarray(a, np.float32)).permute(0, 3, 1, 2)
    return t.to(dtype).contiguous(memory_format=torch.channels_last)


def _bit_equal(got, want):
    want = np.asarray(want, np.float32)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("activ", ["none", "lrelu"])
def test_conv2d_block_bias_rounds_as_flax(activ):
    """3 x 3, 32 -> 32 channels, [2, 16, 16] in, zero padding."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 16, 32)).astype(np.float32)
    block = JaxConv2dBlock(32, 3, 1, 1, norm="none", activ=activ,
                           pad_type="zero", dtype=jnp.bfloat16)
    params = _biased(block.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 32)))
                     ["params"], 1)
    want = block.apply({"params": params}, jnp.asarray(x, jnp.bfloat16))
    port = Conv2dBlock(32, 32, 3, 1, 1, "none", activ, "zero")
    port.load_state_dict({
        "conv.weight": torch.from_numpy(params["Conv_0"]["kernel"].transpose(3, 2, 0, 1).copy()),
        "conv.bias": torch.from_numpy(params["Conv_0"]["bias"])})
    with torch.no_grad():
        got = port(_nchw(x))
    _bit_equal(got.permute(0, 2, 3, 1), want)


def test_decoder_heads_bias_rounds_as_flax():
    """The decoder's fused image and attention heads, with N(0, 0.5)
    biases, on the bf16 tensor that the JAX decoder feeds them."""
    cfg = jax_load_config(CONFIG)
    vocab = JaxVocab(cfg.dataset)
    gen = JaxGenerator(cfg=cfg.gen, input_dim=cfg.input_dim,
                       vocab_size=vocab.size, dtype=jnp.bfloat16)
    rng = np.random.default_rng(2)
    images = rng.uniform(-1, 1, (3, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    params = jax.jit(gen.init)({"params": jax.random.PRNGKey(1),
                                "dropout": jax.random.PRNGKey(2)},
                               jnp.zeros((1,) + images.shape[1:]))["params"]
    params = _biased(params, 3, keep=lambda k: "_head" in k)
    v = {"params": params}
    content, mu, _ = gen.apply(v, images, method="encode")
    style = np.asarray(mu, np.float32).reshape(3, -1)
    last = f"Conv2dBlock_{cfg.gen.content_downsample - 1}"   # the last upsample stage
    (image, att), state = gen.apply(
        v, content, style, method="decode",
        capture_intermediates=lambda m, _: isinstance(m, JaxConv2dBlock) and m.name == last)
    heads_in = state["intermediates"]["dec"][last]["__call__"][0]

    tcfg = load_config(CONFIG)
    tcfg.compute_dtype = "bfloat16"
    port = build_generator(tcfg, vocab.size, device="cpu")
    load_jax_params(port, params)
    hook = port.dec.model[-1].register_forward_hook(lambda m, i, out: _nchw(heads_in))
    with torch.inference_mode():
        got_image, got_att = port.decode(
            torch.from_numpy(np.asarray(content, np.float32)).bfloat16(),
            torch.from_numpy(style))
    hook.remove()
    _bit_equal(got_image, image)
    _bit_equal(got_att, att)


@pytest.mark.parametrize("multiscale", [True, False])
def test_discriminator_bias_rounds_as_flax(multiscale):
    """`configs/smoke.yaml`'s discriminator in bf16 with every bias
    N(0, 0.5): its Conv2dBlocks and its `src` heads."""
    jcfg = jax_load_config(CONFIG)
    images = np.random.default_rng(4).uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
    jdis = JaxDis(cfg=jcfg.dis, dtype=jnp.bfloat16)
    params = _biased(jdis.init(jax.random.PRNGKey(4), jnp.zeros((1, 32, 32, 3)))
                     ["params"], 5)
    want = jdis.apply({"params": params}, images, multiscale)
    port = MsImageDis(load_config(CONFIG).dis, torch.bfloat16)
    load_jax_dis_params(port, params)
    with torch.no_grad():
        got = port(torch.from_numpy(images), multiscale)
    assert len(got) == len(want)
    for (gs, gc), (ws, wc) in zip(got, want):
        _bit_equal(gs, ws)
        _bit_equal(gc, wc)


def test_vgg_layer_bias_rounds_as_flax():
    """VGG16's conv1_2 (64 -> 64, 3 x 3, padding 1) and its ReLU, as the
    JAX trunk runs each layer: flax `nn.Conv(dtype=bfloat16)`, `nn.relu`."""
    params = _biased(jax.tree_util.tree_map(np.asarray, init_random_vgg(0)), 6)
    layer = params["params"]["conv1_2"]
    x = np.random.default_rng(7).standard_normal((2, 16, 16, 64)).astype(np.float32)
    conv = fnn.Conv(64, (3, 3), padding=1, dtype=jnp.bfloat16,
                    param_dtype=jnp.float32)
    want = jax.nn.relu(conv.apply({"params": layer}, jnp.asarray(x, jnp.bfloat16)))
    port = Vgg16Features(torch.bfloat16)
    port.load_state_dict({k: torch.from_numpy(v) for k, v in
                          jax_vgg_to_state_dict(params["params"]).items()})
    with torch.no_grad():
        got = port.layer("conv1_2", _nchw(x))
    _bit_equal(got.permute(0, 2, 3, 1), want)
