"""The port stands alone: importing it (and `chip_smoke.py`) loads no JAX
module and nothing of `dwcgan_tpu`, and its entry points refuse to run on a
card that is not there instead of drifting to the CPU."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "dwcgan_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "dwcgan_tpu")

IMPORT_ALL = """
import importlib, pkgutil, sys
import dwcgan_tpu_torch
names = [m.name for m in pkgutil.walk_packages(dwcgan_tpu_torch.__path__,
                                               "dwcgan_tpu_torch.")]
for name in names + ["dwcgan_tpu_torch.cli.translate", "chip_smoke"]:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in {forbidden!r})
print(len(names), "modules;", "loaded:", bad)
sys.exit(1 if bad or len(names) < 15 else 0)
""".format(forbidden=set(FORBIDDEN))


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_importing_the_port_loads_no_jax_and_no_jax_package():
    proc = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_statement_names_jax_or_the_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), \
            f"{path}:{node.lineno} imports {names}"


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: these check the no-card path")


def test_cuda_device_without_a_card_raises(no_card):
    from dwcgan_tpu_torch.device import resolve_device
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_build_generator_defaults_to_the_card(no_card):
    from dwcgan_tpu_torch.config import load_config
    from dwcgan_tpu_torch.models.generator import build_generator
    with pytest.raises(RuntimeError, match="cuda"):
        build_generator(load_config(str(ROOT / "configs/smoke.yaml")), 102)


def test_translate_cli_defaults_to_the_card(no_card, tmp_path):
    from dwcgan_tpu_torch.cli import translate
    with pytest.raises(RuntimeError, match="cuda"):
        translate.main(["--config", str(ROOT / "configs/smoke.yaml"),
                        "--weights", str(tmp_path / "w.npz"),
                        "--list", str(tmp_path / "l.tsv"),
                        "--image_dir", str(tmp_path),
                        "--out_dir", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()


def test_chip_smoke_fails_without_a_card(no_card, capsys):
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    assert chip_smoke.main() == 1
    assert capsys.readouterr().out == ""


def test_chip_smoke_alone_in_a_directory_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
