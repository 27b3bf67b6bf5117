"""The host preprocessing library: the counterpart of
`dwcgan_tpu/native/__init__.py`, whose fused C++ kernel the JAX CLIs, eval
harness and CelebA feed run by default.

`csrc/image_ops.cpp`, the port's own copy of that kernel, is built at
first use by the `g++` on PATH with the flags of the JAX package's
Makefile, into
`build/host/libdwc_image_ops_<hash>.so` at the root of the checkout (the
hash covers the source and the flags, so an edited source is rebuilt), and
bound with `ctypes`.  Those flags neither contract nor reorder float
operations, so the library is bit-equal to the JAX package's build.

Unlike the JAX module this one has no quiet fallback: a library that
cannot be built raises with the compiler's output.  The NumPy version
(`data/preprocess.py`) is the plain version the tests hold it against; only
`preprocess_batch(..., force_fallback=True)` runs it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

from dwcgan_tpu_torch.data import preprocess

ROOT = Path(__file__).resolve().parents[2]
SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "image_ops.cpp"
BUILD_DIR = ROOT / "build" / "host"
# the `g++` on PATH, not `$CXX`: a host may point CXX at a compiler without
# the OpenMP runtime that -fopenmp links
CXX = "g++"
# native/Makefile's; no -march=native or -ffast-math, which could contract
# or reorder the kernel's float operations
FLAGS = ("-O3", "-fPIC", "-fopenmp", "-Wall", "-shared")
BUILD_TIMEOUT = 300


def _compiler() -> str:
    found = shutil.which(CXX)
    if found is None:
        raise RuntimeError(f"C++ compiler {CXX!r} not found on PATH: the host "
                           "preprocessing library is built with it")
    return found


def library_path() -> Path:
    """Where the library for the current source lives (built or not)."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libdwc_image_ops_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless this version is built already; return
    its path.  Builds in a fresh directory and renames the result, so
    processes that build at once each see all of it or nothing."""
    out = library_path()
    if out.exists():
        return out
    cmd = [_compiler(), *FLAGS]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        cmd += ["-o", str(tmp / "lib.so"), str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=BUILD_TIMEOUT)
        if proc.returncode:
            raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp / "lib.so", out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """The library, built if needed; raises where it cannot be built."""
    lib = ctypes.CDLL(str(build()))
    lib.dwc_preprocess_batch.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
    ]
    lib.dwc_preprocess_batch.restype = None
    lib.dwc_normalize_u8.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.dwc_normalize_u8.restype = None
    lib.dwc_omp_threads.argtypes = []
    lib.dwc_omp_threads.restype = ctypes.c_int
    return lib


def available() -> bool:
    """Whether the library builds and loads here.  The preprocessing never
    falls back on it: `preprocess_batch` raises where this is False."""
    try:
        load_library()
    except (RuntimeError, OSError, subprocess.TimeoutExpired):
        return False
    return True


def preprocess_batch(images: np.ndarray, crop: int, out_size: int,
                     hflips: Optional[np.ndarray] = None,
                     force_fallback: bool = False) -> np.ndarray:
    """Fused centre crop + horizontal flip + half-pixel bilinear resize +
    [-1, 1] normalisation.

    images: [N, H, W, 3] uint8 (same size); hflips: [N] 0/1, each flip
    mirroring the output (the source mirrored only where `W - crop` is
    even).  Returns [N, out_size, out_size, 3] float32.  `force_fallback`:
    the NumPy version (`data/preprocess.py`, which mirrors the source)."""
    if force_fallback:
        return preprocess.preprocess_batch(images, crop, out_size, hflips)
    images = np.ascontiguousarray(images, dtype=np.uint8)
    if images.ndim != 4 or images.shape[-1] != 3:
        raise ValueError(f"expected [N, H, W, 3] images, got {images.shape}")
    if crop < 1 or out_size < 1:
        raise ValueError(f"crop {crop} and out_size {out_size} must be positive")
    n, h, w, _ = images.shape
    flips_ptr = None
    if hflips is not None:
        hflips = np.ascontiguousarray(hflips, dtype=np.int32)
        if hflips.shape != (n,):
            raise ValueError(f"hflips of shape {hflips.shape} for {n} images")
        flips_ptr = hflips.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    out = np.empty((n, out_size, out_size, 3), dtype=np.float32)
    load_library().dwc_preprocess_batch(
        images.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n, h, w, crop,
        out_size, flips_ptr, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


def omp_threads() -> int:
    """The OpenMP threads a call of the library may use."""
    return int(load_library().dwc_omp_threads())
