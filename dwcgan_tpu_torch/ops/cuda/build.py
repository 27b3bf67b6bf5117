"""Build the port's CUDA kernels with nvcc into a shared library.

The sources under `dwcgan_tpu_torch/csrc/` have a plain C interface, so one
`nvcc -shared` call builds them in seconds (no PyTorch headers) and `ctypes`
loads the result.  The library goes to `build/kernels/` at the root of the
checkout; its name carries a hash of the sources and flags, so an edited
source is rebuilt and an unchanged one is reused.

    python -m dwcgan_tpu_torch.ops.cuda.build     # build now, print the path
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
CSRC = Path(__file__).resolve().parents[2] / "csrc"
SOURCES = (CSRC / "norm_kernels.cu",)
BUILD_DIR = ROOT / "build" / "kernels"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found (on PATH or under CUDA_HOME): the CUDA "
                       "kernels are built only where the CUDA toolkit is")


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libdwc_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless this version is built already; return the
    library's path.  The ptxas report (registers, shared memory, spills) is
    kept beside it as `<library>.log`."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *FLAGS, "-o", tmp, *map(str, SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = out.with_suffix(".log")
    log.write_text(f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
                   f"[{time.perf_counter() - t0:.1f} s]\n")
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)   # atomic: a concurrent build sees all or nothing
    return out


if __name__ == "__main__":
    print(build())
