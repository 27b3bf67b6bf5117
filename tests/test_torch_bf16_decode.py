"""The port's decoder in bf16 against the JAX decoder in bf16.

The JAX `Decoder` computes in the compute dtype: each AdaIN output is a
bf16 tensor before the residual add `x + y` (dwcgan_tpu/ops/blocks.py:
387-398), and the attention head's `jax.nn.sigmoid` is XLA's
1 / (1 + exp(-x)), rounded after each op.  The port must compute the same
function.  At `configs/smoke.yaml` widths (content 32 x 8 x 8, two AdaIN
resblocks, 32 px, batch 3) the JAX decoder's image in fp32 and in bf16
differ by up to 0.0124 (mean 1.9e-3) and its attention map by up to 5.9e-3.
A port that adds the residual in fp32 and rounds once is 0.0625 off in the
resblock stack at 2824 of 6144 elements, and `torch.sigmoid` is 1 ulp off
in about a third of the attention map.

So: the resblock stack and the attention map bit-equal; the image within 1
bf16 ulp of the JAX image everywhere, and different at under 1 % of its
elements (on this CPU: 9 of 9216, from the convolutions' summation order).
Near zero the image, tanh of a bf16 conv output plus bias, carries the
rounding of those larger operands: there the ulp is taken at 2^-6 (6.1e-5;
measured: up to 4.6e-5 at values near 2e-3).
The input is the JAX bf16 `encode` of seeded images, as serving feeds the
decoder.  The port's sigmoid gradient is JAX's rule, bit-equal to
`jax.grad` in bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwcgan_tpu.config import load_config as jax_load_config
from dwcgan_tpu.models.generator import AdaINResBlocks
from dwcgan_tpu.models.generator import Generator as JaxGenerator
from dwcgan_tpu.text.vocab import Vocab as JaxVocab
from dwcgan_tpu_torch.config import load_config
from dwcgan_tpu_torch.interop.jax_params import load_jax_params
from dwcgan_tpu_torch.models.generator import build_generator
from dwcgan_tpu_torch.ops.blocks import sigmoid

torch.set_num_threads(1)

CONFIG = "configs/smoke.yaml"
IMAGE_ULPS = 1
IMAGE_ULP_FLOOR = 2.0 ** -6   # the ulp near zero: that of this magnitude
IMAGE_SHARE = 0.01   # of the image's elements that may differ at all


def _ulp(r):
    """Spacing of bf16 values at each element of the fp32 array r."""
    _, e = np.frexp(np.abs(r))
    return np.where(r == 0, 0.0, np.ldexp(1.0, e - 8))


@pytest.fixture(scope="module")
def decoded():
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
    content, mu, _ = gen.apply(v, images, method="encode")
    style = np.asarray(mu, np.float32).reshape(3, -1)
    (image, att), state = gen.apply(
        v, content, style, method="decode",
        capture_intermediates=lambda m, _: isinstance(m, AdaINResBlocks))
    stack = state["intermediates"]["dec"]["AdaINResBlocks_0"]["__call__"][0]

    tcfg = load_config(CONFIG)
    tcfg.compute_dtype = "bfloat16"
    port = build_generator(tcfg, vocab.size, device="cpu")
    load_jax_params(port, params)
    got = {}
    hook = port.dec.model[0].register_forward_hook(
        lambda m, i, out: got.__setitem__("stack", out.permute(0, 2, 3, 1)))
    with torch.inference_mode():
        got["image"], got["att"] = port.decode(
            torch.from_numpy(np.asarray(content, np.float32)).bfloat16(),
            torch.from_numpy(style))
    hook.remove()
    want = {"stack": stack, "image": image, "att": att}
    return {k: (got[k], np.asarray(want[k], np.float32)) for k in want}


@pytest.mark.parametrize("part", ["stack", "att"])
def test_bit_equal_to_jax_bf16(decoded, part):
    got, want = decoded[part]
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_image_within_one_ulp_of_jax_bf16(decoded):
    got, want = decoded["image"]
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    err = np.abs(got.float().numpy() - want)
    tol = IMAGE_ULPS * _ulp(np.maximum(np.abs(want), IMAGE_ULP_FLOOR))
    assert np.all(err <= tol), float((err - tol).max())
    assert np.count_nonzero(err) <= IMAGE_SHARE * err.size, np.count_nonzero(err)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_sigmoid_and_its_gradient_match_jax(dtype):
    rng = np.random.default_rng(1)
    x = (4 * rng.standard_normal((64, 96))).astype(np.float32)
    w = rng.standard_normal((64, 96)).astype(np.float32)
    jd = jnp.dtype(dtype)
    xj, wj = jnp.asarray(x, jd), jnp.asarray(w, jd)
    want_y = np.asarray(jax.nn.sigmoid(xj), np.float32)
    want_g = np.asarray(jax.grad(lambda a: jnp.sum(jax.nn.sigmoid(a) * wj))(xj),
                        np.float32)
    td = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(td).requires_grad_()
    y = sigmoid(xt)
    (y * torch.from_numpy(w).to(td)).sum().backward()
    assert y.dtype == xt.grad.dtype == td
    # bf16: bit-equal; fp32: exp's own implementations differ in the last bits
    close = (np.testing.assert_array_equal if dtype == "bfloat16" else
             lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7))
    close(y.detach().float().numpy(), want_y)
    close(xt.grad.float().numpy(), want_g)
    with torch.no_grad():   # the same forward without the Function
        np.testing.assert_array_equal(sigmoid(xt).float().numpy(),
                                      y.detach().float().numpy())
