"""A frozen copy of the port's `ops/prng.py`, so the reference makes the
spectral norm's start vector itself.  Its text follows.

JAX's standard-normal draw from `PRNGKey(0)`, in numpy.

The spectral norm of the JAX package (`dwcgan_tpu/ops/blocks.py:86-113`)
starts its power iteration from `jax.random.normal(PRNGKey(0), (out,))`
on every call, and 30 iterations do not converge on random kernels, so
sigma depends on that start vector.  `jax_normal_key0(n)` makes the same
vector without JAX:

- threefry2x32 (Salmon et al. 2011, the 20-round form of JAX's
  `_threefry2x32_lowering`) on the counters (0, i), key (0, 0), the two
  output words xor-ed, as `jax_threefry_partitionable` draws 32-bit words;
- the uniform transform of `jax.random.uniform`: the top 23 bits as the
  mantissa of a float in [1, 2), minus 1, scaled to [lo, 1) with
  lo = nextafter(-1, 0), and clamped below at lo;
- sqrt(2) * erfinv(u) with XLA's float32 ErfInv (Giles 2010, two
  polynomials of degree 8 in w = -log1p(-u^2), the break at w = 5) on top
  of XLA's CPU log1p (a Cephes rational near 0, else log(1 + x) by the
  Cephes logf polynomial that XLA takes from Eigen), each step rounded to
  float32 and every multiply-add fused, as LLVM contracts them (a float64
  product of two float32 values is exact, so one rounding to float32
  stands for the fused one).

Both draws equal JAX 0.9's on the CPU bit for bit (checked up to n = 2^20
by `tests/test_torch_block_options.py`'s sizes and a wider scan).  scipy's
`erfinv` or numpy's `log1p` would not: they round otherwise in up to 44
and 3 ulps.
"""

from __future__ import annotations

import functools

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)

_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _rotl(v: np.ndarray, d: int) -> np.ndarray:
    return (v << np.uint32(d)) | (v >> np.uint32(32 - d))


def threefry2x32(key: tuple, x0: np.ndarray, x1: np.ndarray):
    """The threefry2x32 hash of the counter pairs (x0, x1) under `key`
    (two uint32 words), 20 rounds; uint32 arithmetic wraps."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = x0.astype(np.uint32) + ks[0]
    x1 = x1.astype(np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def jax_uniform_key0(n: int) -> np.ndarray:
    """`jax.random.uniform(PRNGKey(0), (n,), float32, lo, 1.0)` with
    lo = nextafter(-1, 0): the draw under `jax.random.normal`."""
    with np.errstate(over="ignore"):
        b0, b1 = threefry2x32((0, 0), np.zeros(n, np.uint32),
                              np.arange(n, dtype=np.uint32))
    bits = ((b0 ^ b1) >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    hi = np.float32(1.0)
    return np.maximum(lo, floats * (hi - lo) + lo).astype(np.float32)


def _fma32(a, b, c):
    """a * b + c rounded once to float32 (the product is exact in float64)."""
    return (np.asarray(a, np.float32).astype(np.float64)
            * np.asarray(b, np.float32).astype(np.float64)
            + np.asarray(c, np.float32).astype(np.float64)).astype(np.float32)


def _horner(x, coeffs):
    """sum c_i x^(n-i), highest degree first, one fused step per term."""
    p = np.zeros_like(x)
    for c in coeffs:
        p = _fma32(p, x, np.float32(c))
    return p


_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)


def log_f32(v: np.ndarray) -> np.ndarray:
    """XLA's CPU float32 log for positive normal v: the Cephes logf
    polynomial (via Eigen) with its multiply-adds fused."""
    f32 = np.float32
    v = np.maximum(np.asarray(v, f32), np.array(0x00800000, np.uint32).view(f32))
    bits = v.view(np.uint32)
    e = (f32(1) + ((bits >> np.uint32(23)).astype(np.int32) - 0x7F).astype(f32))
    m = ((bits & np.uint32(0x807FFFFF)) | np.uint32(0x3F000000)).view(f32)
    small = m < f32(0.707106781186547524)
    t = (m - f32(1)) + np.where(small, m, f32(0))
    e = e - np.where(small, f32(1), f32(0))
    x2 = t * t
    x3 = x2 * t
    y = _fma32(_fma32(t, _LOG_P[0], _LOG_P[1]), t, _LOG_P[2])
    y1 = _fma32(_fma32(t, _LOG_P[3], _LOG_P[4]), t, _LOG_P[5])
    y2 = _fma32(_fma32(t, _LOG_P[6], _LOG_P[7]), t, _LOG_P[8])
    y = _fma32(_fma32(y, x3, y1), x3, y2)
    y = _fma32(y, x3, f32(_LOG_Q1) * e)
    t = _fma32(f32(-0.5), x2, t) + y
    return _fma32(f32(_LOG_Q2), e, t)


def log1p_f32(x: np.ndarray) -> np.ndarray:
    """XLA's float32 log1p: a Cephes rational for |x| < sqrt(2) - 1, else
    log(1 + x)."""
    f32 = np.float32
    x = np.asarray(x, f32)
    x2 = x * x
    r = _horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN)
    near0 = x + (f32(-0.5) * x2 + (x * x2) * r)
    return np.where(np.abs(x) < f32(0.41421356237309504880), near0,
                    log_f32(x + f32(1)))


def erfinv_f32(x: np.ndarray) -> np.ndarray:
    """XLA's float32 ErfInv (`ErfInv32`): +-inf at +-1."""
    f32 = np.float32
    x = np.asarray(x, f32)
    with np.errstate(invalid="ignore", divide="ignore"):
        w = -log1p_f32(-(x * x))
        lt = w < f32(5.0)
        w = np.where(lt, w - f32(2.5), np.sqrt(w) - f32(3.0))
    p = np.where(lt, f32(_ERFINV_LT5[0]), f32(_ERFINV_GE5[0]))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma32(p, w, np.where(lt, f32(a), f32(b)))
    return np.where(np.abs(x) == 1, x * np.finfo(f32).max, p * x)


@functools.lru_cache(maxsize=None)
def _normal_key0(n: int) -> np.ndarray:
    out = (np.float32(np.sqrt(2)) * erfinv_f32(jax_uniform_key0(n)))
    out = out.astype(np.float32)
    out.setflags(write=False)
    return out


def jax_normal_key0(n: int) -> np.ndarray:
    """`jax.random.normal(jax.random.PRNGKey(0), (n,), float32)` (a
    read-only array, cached per n)."""
    return _normal_key0(int(n))
