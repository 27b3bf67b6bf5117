"""How a bias gradient below fp32 is summed: JAX's CPU backend against the
port (ROADMAP queue 3, F9).

A bias added in bf16 (flax `nn.Conv`/`nn.Dense` with `dtype=bfloat16`,
dwcgan_tpu/ops/blocks.py:207-213 and :271-272) has as its gradient the sum
of the bf16 cotangent g over every other axis.  On the same bf16 g (numpy,
seeded), with 1024 terms per bias element, for one `Conv2dBlock` (norm
none) and one `LinearBlock`:

1. JAX's bias gradient (`jax.vjp` on the CPU) equals a serial bf16 sum of g,
   each partial rounded to bf16 (ml_dtypes), bit for bit: for the
   convolution over (N, H, W) in row-major order, element after element;
   for the Dense layer (a reduction over the rows of [1024, F]) in blocks of
   32 rows, each block summed serially, then the block sums serially;
2. the port's (autograd, `ops/blocks.py::conv2d` and `linear`) equals g
   summed in fp32 and rounded once to bf16, within one bf16 ulp (fp32
   summation orders may differ in the last bit before the rounding; the
   test reports how many elements are bit-equal);
3. `jnp.sum(g)` on the same backend accumulates in fp32 and rounds once: it
   agrees with (2) to the same ulp and not with (1).

So the rule of the port: a bf16 reduction accumulates in fp32 and rounds
once, as `jnp.sum` does and as XLA does on the TPU; only the CPU
transpose of a broadcast add sums serially in bf16.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dwcgan_tpu.ops.blocks import Conv2dBlock as JaxConv2dBlock
from dwcgan_tpu.ops.blocks import LinearBlock as JaxLinearBlock
from dwcgan_tpu_torch.ops.blocks import Conv2dBlock, LinearBlock

torch.set_num_threads(1)

BF16 = ml_dtypes.bfloat16
N, H, W, CIN, COUT = 4, 16, 16, 8, 16     # conv: 4 * 16 * 16 = 1024 terms
ROWS, FIN, FOUT = 1024, 32, 24            # linear: 1024 terms
# the rows of one serial block of the CPU backend's Dense bias reduction
# (measured: bit-equal at 96, 512, 1024 rows; 1536 and other sizes that
# are not a power of two times 32 group otherwise)
DENSE_BLOCK = 32


def _serial(rows):
    """The row-major sum of `rows` [R, C], each partial rounded to bf16
    (float32 add, then bf16)."""
    s = np.zeros(rows.shape[1], BF16)
    for row in rows:
        s = (s.astype(np.float32) + row.astype(np.float32)).astype(BF16)
    return s


def _serial_bf16(g, block=None):
    """Per last-axis element, the sum of g over its other axes in bf16:
    serial in row-major order, or (`block`) serial within blocks of that
    many rows and then serial over the blocks' sums."""
    flat = np.asarray(g).reshape(-1, g.shape[-1])
    if block:
        flat = np.stack([_serial(flat[i:i + block])
                         for i in range(0, len(flat), block)])
    return _serial(flat).astype(np.float32)


def _f32_once(g):
    flat = np.asarray(g).astype(np.float32).reshape(-1, g.shape[-1])
    return flat.sum(0, dtype=np.float32).astype(BF16).astype(np.float32)


def _ulp(v):
    """The bf16 spacing at each (bf16-representable) value of v."""
    _, e = np.frexp(np.abs(v).astype(np.float32))
    return np.ldexp(np.float32(1.0), e - 8).astype(np.float32)


def _case(kind):
    """(g as bf16 numpy, JAX's bias gradient, the port's bias gradient)."""
    rng = np.random.default_rng(0 if kind == "conv" else 1)
    if kind == "conv":
        x = rng.standard_normal((N, H, W, CIN)).astype(np.float32)
        g = rng.standard_normal((N, H, W, COUT)).astype(BF16)
        block = JaxConv2dBlock(COUT, 3, 1, 1, norm="none", activ="none",
                               dtype=jnp.bfloat16)
        name = "Conv_0"
    else:
        x = rng.standard_normal((ROWS, FIN)).astype(np.float32)
        g = rng.standard_normal((ROWS, FOUT)).astype(BF16)
        block = JaxLinearBlock(FOUT, "none", "none", dtype=jnp.bfloat16)
        name = "Dense_0"
    variables = block.init(jax.random.PRNGKey(0), x)
    _, vjp = jax.vjp(lambda v: block.apply(v, x), variables)
    want = np.asarray(vjp(jnp.asarray(g))[0]["params"][name]["bias"], np.float32)
    kern = np.asarray(variables["params"][name]["kernel"])

    if kind == "conv":
        port = Conv2dBlock(CIN, COUT, 3, 1, 1, norm="none", activ="none")
        port.conv.weight.data = torch.from_numpy(kern.transpose(3, 2, 0, 1).copy())
        xt = torch.from_numpy(x).permute(0, 3, 1, 2).bfloat16()
        gt = torch.from_numpy(g.astype(np.float32)).permute(0, 3, 1, 2).bfloat16()
        bias = port.conv.bias
    else:
        port = LinearBlock(FIN, FOUT, "none", "none")
        port.fc.weight.data = torch.from_numpy(kern.T.copy())
        xt = torch.from_numpy(x).bfloat16()
        gt = torch.from_numpy(g.astype(np.float32)).bfloat16()
        bias = port.fc.bias
    bias.data.zero_()
    y = port(xt)
    assert y.dtype == torch.bfloat16
    y.backward(gt)
    return g, want, bias.grad.numpy().astype(np.float32)


@pytest.mark.parametrize("kind", ["conv", "linear"])
def test_bias_gradient_summation(kind):
    g, jax_grad, port_grad = _case(kind)
    serial = _serial_bf16(g, DENSE_BLOCK if kind == "linear" else None)
    once = _f32_once(g)
    # 1. JAX's CPU backend: a serial bf16 sum, bit for bit
    np.testing.assert_array_equal(jax_grad, serial)
    # 2. the port: fp32 accumulation, one rounding, within one bf16 ulp
    ulp = _ulp(once)
    assert np.all(np.abs(port_grad - once) <= ulp), (port_grad, once)
    port_bit_equal = int((port_grad == once).sum())
    # 3. jnp.sum on the same backend upcasts: within the same ulp of (2),
    #    and not the serial sum
    js = np.asarray(jnp.sum(jnp.asarray(g), axis=tuple(range(g.ndim - 1))),
                    np.float32)
    assert np.all(np.abs(js - once) <= ulp)
    assert not np.array_equal(js, serial)
    # the serial bf16 sum is further from the exact sum than one rounding
    exact = np.asarray(g).astype(np.float64).reshape(-1, g.shape[-1]).sum(0)
    rel = lambda v: float(np.linalg.norm(v - exact) / np.linalg.norm(exact))
    assert rel(serial) > rel(once)
    print(f"{kind}: {g.size // g.shape[-1]} terms per bias element; port "
          f"bit-equal to the fp32 sum rounded once at {port_bit_equal} of "
          f"{g.shape[-1]}; relative L2 error vs exact: serial bf16 "
          f"{rel(serial):.3e}, fp32 rounded once {rel(once):.3e}")
