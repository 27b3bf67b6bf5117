"""Build the port's CUDA kernels with nvcc into a shared library.

The sources under `dwcgan_tpu_torch/csrc/` have a plain C interface, so
nvcc builds them in seconds (no PyTorch headers) and `ctypes` loads the
result: one `nvcc -c` per source, all started together, then one link into
a shared library.  The library goes to `build/kernels/` at the root of the
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
SOURCES = (CSRC / "norm_kernels.cu", CSRC / "stem_kernels.cu")
BUILD_DIR = ROOT / "build" / "kernels"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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
    library's path.  The compiler's report (ptxas: registers, shared memory,
    spills) is kept beside it as `<library>.log`."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    nvcc = _nvcc()
    t0 = time.perf_counter()
    cmds = [[nvcc, *FLAGS, "-c", "-o", str(tmp / f"{src.stem}.o"), str(src)]
            for src in SOURCES]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    results = [(cmd, p.communicate()[0], p.returncode)
               for cmd, p in zip(cmds, procs)]
    link = [nvcc, "-shared", "-o", str(tmp / "lib.so"),
            *(str(tmp / f"{src.stem}.o") for src in SOURCES)]
    if all(rc == 0 for _, _, rc in results):
        proc = subprocess.run(link, capture_output=True, text=True)
        results.append((link, proc.stdout + proc.stderr, proc.returncode))
    log = "".join(f"$ {' '.join(cmd)}\n{text}" for cmd, text, _ in results)
    out.with_suffix(".log").write_text(
        f"{log}[{time.perf_counter() - t0:.1f} s]\n")
    failed = [(cmd, text, rc) for cmd, text, rc in results if rc != 0]
    if failed:
        shutil.rmtree(tmp)
        cmd, text, rc = failed[0]
        raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{text}")
    os.replace(tmp / "lib.so", out)   # atomic: a concurrent build sees all or nothing
    shutil.rmtree(tmp)
    return out


def count_hmma(sass: str, names) -> dict:
    """HMMA (tensor-core) instructions in `cuobjdump --dump-sass` output, per
    kernel: {name: count} summed over the functions whose mangled name
    contains `name` (0 where none does)."""
    counts = {name: 0 for name in names}
    current = ()
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            current = [name for name in names if name in fn]
            continue
        # "        /*0a30*/   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;", maybe
        # with a predicate ("@P0 ") before the opcode
        tokens = line.split("*/", 1)[-1].split() if "*/" in line else []
        if tokens and tokens[0].startswith("@"):
            tokens = tokens[1:]
        if tokens and tokens[0].startswith("HMMA"):
            for name in current:
                counts[name] += 1
    return counts


def hmma_counts(names) -> dict:
    """`count_hmma` over the built library's SASS, by the cuobjdump beside
    `_nvcc()` (the same toolkit that built it)."""
    tool = Path(_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "--dump-sass", str(build())],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    return count_hmma(sass, names)


if __name__ == "__main__":
    print(build())
