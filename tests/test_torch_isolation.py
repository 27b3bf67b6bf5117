"""The port stands alone: importing it (and `chip_smoke.py`) loads no JAX
module and nothing of `dwcgan_tpu`, and its entry points refuse to run on a
card that is not there instead of drifting to the CPU."""

import ast
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "dwcgan_tpu_torch"
# `tools`: the JAX repo's scripts (tools/quality_eval.py imports the JAX
# package)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "dwcgan_tpu", "tools")

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


# and those of the block options and the legacy family
LEGACY_MODULES = ("ops/prng.py", "models/legacy.py", "utils/interp.py",
                  "data/labels.py", "losses/gmm.py", "losses/gan.py")


# and those of data-parallel training
PARALLEL_MODULES = ("parallel/__init__.py", "parallel/mesh.py", "device.py")
# and those of tensor parallelism
TP_MODULES = ("parallel/rules.py", "parallel/tensor.py")


def test_the_scans_cover_the_parallel_modules():
    scanned = {p.relative_to(PACKAGE).as_posix() for p in PACKAGE.rglob("*.py")}
    assert set(PARALLEL_MODULES) <= scanned


def test_the_scans_cover_the_tensor_parallel_modules():
    scanned = {p.relative_to(PACKAGE).as_posix() for p in PACKAGE.rglob("*.py")}
    assert set(TP_MODULES) <= scanned
    proc = subprocess.run(
        [sys.executable, "-c", "import sys, dwcgan_tpu_torch.parallel.rules, "
         "dwcgan_tpu_torch.parallel.tensor; print(sorted(m for m in sys.modules "
         f"if m.split('.')[0] in {set(FORBIDDEN)!r}))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "[]", proc.stdout + proc.stderr


# and those of the host preprocessing library
NATIVE_MODULES = ("native/__init__.py", "data/preprocess.py")
# a string of the port's code (not a docstring) naming the JAX package's
# native library: a path through the root `native/` directory, its `.so`,
# or the module ("native" alone is also a resize backend's name)
JAX_NATIVE = re.compile(r"(^|[/\\])native[/\\]|[/\\]native$|dwcgan_tpu[./]native|"
                        r"libdwc_image_ops\.so")


def _joins_native(node) -> bool:
    """`path / "native"` or `os.path.join(..., "native", ...)`."""
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
        parts = [node.right]
    elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "join":
        parts = node.args
    else:
        return False
    return any(isinstance(p, ast.Constant) and p.value == "native" for p in parts)


def _code_strings(tree):
    """The string constants of a module's code, its docstrings left out."""
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(first.value, ast.Constant):
                docs.add(id(first.value))
    return [n for n in ast.walk(tree) if isinstance(n, ast.Constant)
            and isinstance(n.value, str) and id(n) not in docs]


def test_the_scans_cover_the_native_library():
    """The host library is the port's own: its module and source are
    scanned like every other, importing and running it loads nothing of
    JAX, it builds from `csrc/` into `build/host/`, and no code of the port
    names the JAX package's native library."""
    from dwcgan_tpu_torch import native
    scanned = {p.relative_to(PACKAGE).as_posix() for p in PACKAGE.rglob("*.py")}
    assert set(NATIVE_MODULES) <= scanned
    assert native.SOURCE == PACKAGE / "csrc" / "image_ops.cpp"
    assert native.library_path().parent == ROOT / "build" / "host"
    proc = subprocess.run(
        [sys.executable, "-c", "import sys, numpy as np; "
         "from dwcgan_tpu_torch import native; "
         "native.preprocess_batch(np.zeros((1, 8, 8, 3), np.uint8), 8, 4); "
         "print(sorted(m for m in sys.modules "
         f"if m.split('.')[0] in {set(FORBIDDEN)!r}))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "[]", proc.stdout + proc.stderr
    for path in sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in _code_strings(tree):
            assert not JAX_NATIVE.search(node.value), \
                f"{path}:{node.lineno} names the JAX native library: {node.value!r}"
        joins = [n.lineno for n in ast.walk(tree) if _joins_native(n)]
        assert not joins, f"{path}:{joins} joins a path through native/"
    for src in sorted((PACKAGE / "csrc").iterdir()):
        includes = [ln for ln in src.read_text().splitlines()
                    if ln.lstrip().startswith("#include")]
        assert not any(JAX_NATIVE.search(ln) for ln in includes), (src, includes)


def test_the_scans_cover_the_legacy_modules():
    scanned = {p.relative_to(PACKAGE).as_posix() for p in PACKAGE.rglob("*.py")}
    assert set(LEGACY_MODULES) <= scanned


def test_build_legacy_generator_defaults_to_the_card(no_card):
    from dwcgan_tpu_torch.models.legacy import build_legacy_generator
    for kind in ("AdaINGenV1", "VAEGen"):
        with pytest.raises(RuntimeError, match="cuda"):
            build_legacy_generator(kind, dim=8, n_res=1)
        assert not build_legacy_generator(kind, device="cpu", dim=8, n_res=1).training


def test_the_scans_cover_the_training_cli_modules():
    scanned = {p.relative_to(PACKAGE).as_posix() for p in PACKAGE.rglob("*.py")}
    assert set(TRAINING_CLI_MODULES) <= scanned
    assert (PACKAGE / "utils" / "__init__.py").exists()   # walk_packages finds utils/


def test_the_scans_cover_the_eval_modules():
    scanned = {p.relative_to(PACKAGE).as_posix() for p in PACKAGE.rglob("*.py")}
    assert set(EVAL_MODULES) <= scanned
    assert (PACKAGE / "eval" / "__init__.py").exists()    # walk_packages finds eval/


# the quality protocol and what it runs
QUALITY_MODULES = ("cli/quality_eval.py", "data/procedural.py", "eval/harness.py",
                   "eval/inception.py", "utils/images.py", "train/checkpoint.py")


def test_the_scans_cover_the_quality_protocol():
    scanned = {p.relative_to(PACKAGE).as_posix() for p in PACKAGE.rglob("*.py")}
    assert set(QUALITY_MODULES) <= scanned
    tree = ast.parse((PACKAGE / "cli" / "quality_eval.py").read_text())
    roots = {(a.name if isinstance(node, ast.Import) else node.module or "").split(".")[0]
             for node in ast.walk(tree) if isinstance(node, (ast.Import, ast.ImportFrom))
             for a in node.names}
    assert roots & set(FORBIDDEN) == set() and "dwcgan_tpu_torch" in roots


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


def test_quality_eval_cli_defaults_to_the_card(no_card, tmp_path):
    from dwcgan_tpu_torch.cli import quality_eval
    argv = ["--config", str(ROOT / "configs/smoke.yaml"), "--run_dir", str(tmp_path),
            "--out", str(tmp_path / "out")]
    with pytest.raises(RuntimeError, match="cuda"):
        quality_eval.main(argv)
    # with --device cpu it gets as far as the (missing) checkpoints
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        quality_eval.main(argv + ["--device", "cpu"])
    assert not (tmp_path / "out").exists()


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
