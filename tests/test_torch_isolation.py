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
for name in names + ["dwcgan_tpu_torch.cli.translate", "dwcgan_tpu_torch.cli.train",
                     "dwcgan_tpu_torch.train.step", "chip_smoke"]:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in {forbidden!r})
print(len(names), "modules;", "loaded:", bad)
sys.exit(1 if bad or len(names) < 30 else 0)
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


# the modules of the training CLI's slice, which the scans above must reach
TRAINING_CLI_MODULES = (
    "data/drawkey.py", "data/procedural.py", "data/celeba.py", "data/pipeline.py",
    "utils/guard.py", "utils/logging.py", "utils/images.py", "utils/html.py",
    "utils/timer.py", "train/sampling.py", "train/sampler.py",
    "models/generator.py", "train/checkpoint.py", "cli/train.py",
    "cli/translate.py")
# and those of the evaluation and offline tools
EVAL_MODULES = (
    "eval/metrics.py", "eval/inception.py", "eval/harness.py", "cli/evaluate.py",
    "cli/convert_inception.py", "cli/convert_vgg.py", "cli/build_embeddings.py",
    "cli/import_reference.py", "interop/reference.py", "interop/jax_params.py")


def test_the_scans_cover_the_training_cli_modules():
    scanned = {p.relative_to(PACKAGE).as_posix() for p in PACKAGE.rglob("*.py")}
    assert set(TRAINING_CLI_MODULES) <= scanned
    assert (PACKAGE / "utils" / "__init__.py").exists()   # walk_packages finds utils/


def test_the_scans_cover_the_eval_modules():
    scanned = {p.relative_to(PACKAGE).as_posix() for p in PACKAGE.rglob("*.py")}
    assert set(EVAL_MODULES) <= scanned
    assert (PACKAGE / "eval" / "__init__.py").exists()    # walk_packages finds eval/


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


def test_train_cli_defaults_to_the_card(no_card):
    from dwcgan_tpu_torch.cli import train
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--config", str(ROOT / "configs/smoke.yaml"),
                    "--synthetic_data", "--max_steps", "1"])


def test_trainer_parts_default_to_the_card(no_card):
    from dwcgan_tpu_torch.config import load_config
    from dwcgan_tpu_torch.models.discriminator import build_discriminator
    from dwcgan_tpu_torch.train.state import create_train_state
    cfg = load_config(str(ROOT / "configs/smoke.yaml"))
    with pytest.raises(RuntimeError, match="cuda"):
        build_discriminator(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        create_train_state(cfg, 102)


def test_translate_cli_defaults_to_the_card(no_card, tmp_path):
    from dwcgan_tpu_torch.cli import translate
    with pytest.raises(RuntimeError, match="cuda"):
        translate.main(["--config", str(ROOT / "configs/smoke.yaml"),
                        "--weights", str(tmp_path / "w.npz"),
                        "--list", str(tmp_path / "l.tsv"),
                        "--image_dir", str(tmp_path),
                        "--out_dir", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()


def test_train_cli_on_procedural_data_defaults_to_the_card(no_card, tmp_path):
    from dwcgan_tpu_torch.cli import train
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--config", str(ROOT / "configs/smoke.yaml"), "--procedural_data",
                    "--output_path", str(tmp_path / "run")])
    assert not (tmp_path / "run").exists()


def test_translate_checkpoint_defaults_to_the_card(no_card, tmp_path):
    from dwcgan_tpu_torch.cli import translate
    with pytest.raises(RuntimeError, match="cuda"):
        translate.main(["--config", str(ROOT / "configs/smoke.yaml"),
                        "--checkpoint", str(tmp_path / "checkpoints"),
                        "--list", str(tmp_path / "l.tsv"),
                        "--image_dir", str(tmp_path),
                        "--out_dir", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()


def test_evaluate_cli_defaults_to_the_card(no_card, tmp_path):
    from dwcgan_tpu_torch.cli import evaluate
    argv = ["--config", str(ROOT / "configs/smoke.yaml"),
            "--checkpoint", str(tmp_path / "checkpoints"),
            "--real_list", str(tmp_path / "trg.lst"),
            "--src2trg_list", str(tmp_path / "s2t.lst")]
    with pytest.raises(RuntimeError, match="cuda"):
        evaluate.main(argv)
    # with --device cpu it gets as far as the (missing) checkpoint
    with pytest.raises(FileNotFoundError, match="checkpoint"):
        evaluate.main(argv + ["--device", "cpu"])


def test_import_reference_defaults_to_the_card(no_card, tmp_path):
    from dwcgan_tpu_torch.cli import import_reference
    from dwcgan_tpu_torch.config import load_config
    from dwcgan_tpu_torch.models.generator import build_generator
    cfg = load_config(str(ROOT / "configs/smoke.yaml"))
    torch.save({"a": build_generator(cfg, 102, device="cpu").state_dict()},
               tmp_path / "gen.pt")
    argv = ["--config", str(ROOT / "configs/smoke.yaml"),
            "--gen_pt", str(tmp_path / "gen.pt"), "--out", str(tmp_path / "ck")]
    with pytest.raises(RuntimeError, match="cuda"):
        import_reference.main(argv)
    assert not (tmp_path / "ck").exists()
    assert import_reference.main(argv + ["--device", "cpu"]).endswith("ckpt_00000000.pt")


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


def test_the_build_compiles_every_kernel_source():
    """Every CUDA source of the port goes into the one library, the stem's
    included; finding them needs no JAX."""
    from dwcgan_tpu_torch.ops.cuda import build
    assert sorted(build.SOURCES) == sorted((PACKAGE / "csrc").glob("*.cu"))
    assert any(s.name == "stem_kernels.cu" for s in build.SOURCES)
    assert build.library_path().parent == ROOT / "build" / "kernels"


def test_hmma_counts_read_each_kernels_own_instructions():
    """The tensor-core check counts HMMA lines per function of cuobjdump's
    listing (predicated ones too), and 0 for a kernel it does not find."""
    from dwcgan_tpu_torch.ops.cuda import build
    sass = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_118stem_dw_mma_kernelEPK13__nv_bfloat16S2_Pf4Geom
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0a30*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        /*0a40*/               @P0 HMMA.16816.F32.BF16 R16, R8, R14, R16 ;
\t\tFunction : _ZN12_GLOBAL__N_114stem_dw_kernelIfEEvPKT_S3_Pf4Geom
        /*0010*/                   FFMA R4, R8, R12, R4 ;
"""
    names = ("stem_dw_mma_kernel", "stem_dw_kernel", "stem_dxp_mma_kernel")
    assert build.count_hmma(sass, names) == {
        "stem_dw_mma_kernel": 2, "stem_dw_kernel": 0, "stem_dxp_mma_kernel": 0}


def test_stem_wrappers_take_only_card_tensors():
    """The stem kernel wrappers raise on a CPU tensor before any library is
    loaded: nothing falls back to the plain version behind the caller."""
    from dwcgan_tpu_torch.ops import stem
    from dwcgan_tpu_torch.ops.cuda import kernels
    x = torch.zeros(1, 3, 8, 8).contiguous(memory_format=torch.channels_last)
    w2p = stem.pack_weights(torch.zeros(8, 3, 7, 7), torch.zeros(8), torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.stem_conv7(x, w2p)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.stem_conv7_bwd(x, w2p, torch.zeros(1, 8, 8, 8), None, "none")


def test_stem_generator_defaults_to_the_card(no_card):
    from dwcgan_tpu_torch.config import load_config
    from dwcgan_tpu_torch.models.generator import build_generator
    cfg = load_config(str(ROOT / "configs/smoke.yaml"))
    cfg.stem_pallas = True
    with pytest.raises(RuntimeError, match="cuda"):
        build_generator(cfg, 102)
