"""Nothing the benchmark runs loads the JAX stack or the JAX package, and
the reference loads nothing of the port: top-level module names compared
whole (`dwcgan_tpu_torch` is the port, `dwcgan_tpu` the JAX package)."""

import ast
import subprocess
import sys

import pytest

import _smoke  # noqa: F401
from _smoke import ROOT
from port_bench import core


@pytest.mark.parametrize("names, bad", [
    (["dwcgan_tpu_torch", "dwcgan_tpu_torch.ops.norms", "torch", "numpy"], []),
    (["dwcgan_tpu.models.generator"], ["dwcgan_tpu"]),
    (["jax", "jax._src.core", "jaxlib.xla_client"], ["jax", "jaxlib"]),
    (["flax.linen", "optax", "orbax.checkpoint"], ["flax", "optax", "orbax"]),
    (["jaxtyping", "flaxen", "dwcgan_tpu_tools"], []),
])
def test_forbidden_names_compared_whole(names, bad):
    assert core.forbidden_modules(names) == sorted(bad)


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def _sources(sub=""):
    return sorted(p for p in (core.BENCH_DIR / sub).rglob("*.py") if "tests" not in p.parts)


def test_harness_sources_import_no_jax():
    for path in _sources():
        assert core.forbidden_modules(_imports(path)) == [], path


def test_reference_and_yardstick_import_nothing_of_the_port():
    for sub in ("reference", "yardstick", "traffic"):
        for path in _sources(sub):
            tops = {n.split(".")[0] for n in _imports(path)}
            assert "dwcgan_tpu_torch" not in tops and not core.forbidden_modules(tops), path


def test_a_run_loads_no_jax():
    """A process that drives a cell (serve, smoke widths, on the CPU) and
    reads its metrics holds no forbidden module afterwards."""
    code = ("import sys, tempfile; sys.path.insert(0, 'port_bench/tests'); "
            "from _smoke import smoke_run; from port_bench import run, core; "
            "d = tempfile.mkdtemp(); run.execute(smoke_run('serve', d, trace=True), 0.0); "
            "print(core.forbidden_modules(sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
