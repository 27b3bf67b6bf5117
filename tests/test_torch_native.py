"""The port's host preprocessing library (`dwcgan_tpu_torch/native/`,
`csrc/image_ops.cpp`, built into `build/host/`) against the JAX package's
(`dwcgan_tpu/native/`, `native/image_ops.cpp` built by its Makefile), on
the CPU.

- `preprocess_batch` bit-equal to JAX's library path at 218 x 178, crop
  178 -> 128 and 64 (CelebA's), an upscale (crop 40 -> 48, where the
  sampling is clamped to the full image, not the crop), an odd `w - crop`
  with flips (where mirroring the output is not mirroring the source),
  each at n 1 and 16, with and without flips;
- `dwc_normalize_u8` bit-equal;
- the library against its NumPy oracle (`data/preprocess.py`) within
  `tests/test_native.py`'s 1e-4, the largest difference printed;
  `force_fallback=True` is that oracle;
- a compiler that is missing or fails raises, with its output: no quiet
  fallback; the build takes the `g++` on PATH whatever `CXX` says;
- `eval/harness.py::load_images` bit-equal to the JAX harness's
  preprocessing (`_center_crop_resize`, `auto`).
"""

import ctypes

import numpy as np
import pytest
from PIL import Image

from dwcgan_tpu import native as jax_native
from dwcgan_tpu.data.celeba import _center_crop_resize as jax_crop_resize
from dwcgan_tpu_torch import native
from dwcgan_tpu_torch.data import preprocess
from dwcgan_tpu_torch.eval import harness

NUMPY_ATOL = 1e-4      # tests/test_native.py's, library against NumPy
# (h, w, crop, out): CelebA down to 128 and 64; an upscale; an odd w - crop
SHAPES = [(218, 178, 178, 128), (218, 178, 178, 64), (50, 46, 40, 48),
          (38, 45, 36, 32)]


def jax_library():
    """JAX's library, loaded: its loader settles on NumPy for the process
    where `make` fails, which would make a comparison with it no test."""
    assert jax_native.available(), "the JAX package's native library did not build"
    return jax_native.load_library()


def _images(n, h, w, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8),
            rng.integers(0, 2, n).astype(np.int32))


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("n", [1, 16])
@pytest.mark.parametrize("h,w,crop,out", SHAPES)
def test_preprocess_batch_bit_equal_to_jax(h, w, crop, out, n, flip):
    jax_library()
    images, flips = _images(n, h, w, seed=h * w + crop + out + n)
    flips = flips if flip else None
    got = native.preprocess_batch(images, crop, out, flips)
    assert got.shape == (n, out, out, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jax_native.preprocess_batch(images, crop, out,
                                                                   flips))


def test_normalize_u8_bit_equal_to_jax():
    rng = np.random.default_rng(2)
    src = np.ascontiguousarray(rng.integers(0, 256, (4099,), dtype=np.uint8))
    outs = []
    for lib in (native.load_library(), jax_library()):
        dst = np.empty(src.shape, dtype=np.float32)
        lib.dwc_normalize_u8(src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                             src.size, dst.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        outs.append(dst)
    np.testing.assert_array_equal(*outs)
    assert outs[0].min() == -1.0 and outs[0].max() == 1.0


def test_library_against_its_numpy_oracle():
    images, flips = _images(16, 218, 178, seed=0)
    got = native.preprocess_batch(images, 178, 128, flips)
    want = native.preprocess_batch(images, 178, 128, flips, force_fallback=True)
    np.testing.assert_array_equal(want, preprocess.preprocess_batch(images, 178, 128,
                                                                    flips))
    err = np.abs(got - want)
    print(f"library vs NumPy oracle at 218x178 -> 128: max abs {err.max():.3e}, "
          f"{(err > 0).mean():.1%} of the elements differ")
    assert err.max() <= NUMPY_ATOL
    assert native.available() and native.omp_threads() >= 1


@pytest.mark.parametrize("cxx,match", [("/nonexistent/g++", "not found"),
                                       ("false", r"failed \(1\)")])
def test_a_compiler_that_cannot_build_raises(tmp_path, monkeypatch, cxx, match):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "host")
    monkeypatch.setattr(native, "CXX", cxx)
    native.load_library.cache_clear()
    try:
        assert not native.available()
        with pytest.raises(RuntimeError, match=match):
            native.preprocess_batch(np.zeros((1, 8, 8, 3), np.uint8), 8, 4)
        # the oracle needs no compiler
        assert native.preprocess_batch(np.zeros((1, 8, 8, 3), np.uint8), 8, 4,
                                       force_fallback=True).shape == (1, 4, 4, 3)
    finally:
        native.load_library.cache_clear()
    assert not any((tmp_path / "host").glob("*.so"))


def test_the_build_takes_the_g_plus_plus_on_path_not_cxx(tmp_path, monkeypatch):
    """A host may set CXX to a compiler without the OpenMP runtime that
    -fopenmp links: the build ignores it."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "host")
    monkeypatch.setenv("CXX", "/nonexistent/g++")
    assert native.build().is_file()


def test_malformed_input_raises():
    with pytest.raises(ValueError, match="expected"):
        native.preprocess_batch(np.zeros((8, 8, 3), np.uint8), 8, 4)
    with pytest.raises(ValueError, match="hflips"):
        native.preprocess_batch(np.zeros((2, 8, 8, 3), np.uint8), 8, 4, np.zeros(3))


def test_load_images_bit_equal_to_jax_harness(tmp_path):
    jax_library()
    rng = np.random.default_rng(8)
    names = []
    for i, size in enumerate(((44, 48), (40, 40), (52, 41))):
        names.append(f"{i}.png")
        Image.fromarray(rng.integers(0, 256, size + (3,), dtype=np.uint8)).save(
            tmp_path / names[-1])
    got = harness.load_images(str(tmp_path), names, 40, 32)
    # as dwcgan_tpu/eval/harness.py::generate_fakes preprocesses
    want = np.stack([jax_crop_resize(Image.open(tmp_path / n).convert("RGB"), 40, 32)
                     for n in names])
    np.testing.assert_array_equal(got, want)
