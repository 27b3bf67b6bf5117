"""The harness: finding a cell's files by name, the run's context, the
check of what the process imported, and the result line.

Everything of one configuration, traffic mix or per-layer metric sits in
files of its own, found by name under the benchmark's directory:

- `configs/<config>.json`: the configuration as run (`config`), with its
  source, the yaml it starts from, the keys it overrides, `reduced` and
  `assumed`;
- `workloads/<cell>.json`: the names of the configuration and the
  traffic mix, the chips, the metrics the cell reports and the limits of
  its correctness check;
- `traffic/<mix>.json`: the mix's parameters (sizes, pool, sampling) and
  the driver that generates and serves it (`drivers/<driver>.py`);
- `metrics/<metric>.py`: every metric, end-to-end and per-layer, is a
  reader `read(rec) -> float | None` of the run's records with its `UNIT`
  (None: nothing to read, the metric is left out of the line).
"""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
# top-level module names no run may load, compared whole: the JAX stack
# and the JAX package (the port, `dwcgan_tpu_torch`, is another name)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "dwcgan_tpu")


def load_json(kind: str, name: str, base: Path = BENCH_DIR) -> dict:
    path = Path(base) / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_cell(name: str, base: Path = BENCH_DIR):
    """(cell, config): the workload file, its traffic file's parameters
    under `traffic`, and the configuration as run."""
    cell = load_json("workloads", name, base)
    cell = {**cell, "traffic_name": cell["traffic"],
            "traffic": load_json("traffic", cell["traffic"], base)}
    return cell, load_json("configs", cell["config"], base)["config"]


def load_metric(name: str, base: Path = BENCH_DIR):
    """The module of `metrics/<name>.py` (the file name may hold dots):
    `UNIT` and `read(rec) -> float | None`."""
    path = Path(base) / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "port_bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no metric reader named {name!r} ({path})")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_driver(name: str, base: Path = BENCH_DIR):
    path = Path(base) / "drivers" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"port_bench_driver_{name}", path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no driver named {name!r} ({path})")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules(names: Iterable[str]) -> List[str]:
    """The forbidden top-level names among module names (whole names:
    `dwcgan_tpu_torch.x` is allowed, `dwcgan_tpu.x` and `jax` are not)."""
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


@dataclass
class Run:
    """One run of one cell."""
    cell_name: str
    cell: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    cache: Path = BENCH_DIR / "cache"
    base: Path = BENCH_DIR
    # test hooks: wrap the program's timed call (identity in a run)
    wrap: Callable = field(default=lambda f: f)
    control: bool = False       # also read the control (calibration only)

    def sub_seeds(self, k: int = 4) -> List[int]:
        """Independent 32-bit seeds from the run's seed (weights, the
        step's generator, the data's order and draws, the sample)."""
        import numpy as np
        return [int(s) for s in np.random.SeedSequence(self.seed).generate_state(k)]


def result(correct: bool, attempted: int, failed: int, metrics: Dict[str, tuple],
           device: dict, checks: Dict[str, dict], breakdown: Optional[dict] = None) -> dict:
    """The contract's last line; `checks` last."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": {k: {"value": v, "unit": u} for k, (v, u) in metrics.items()},
           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out


def emit(line: dict, checks: Dict[str, dict]) -> None:
    """Print the result line last on stdout and the checks last on stderr."""
    print(json.dumps(line), flush=True)
    for k, v in checks.items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
