"""Run one cell of the port's benchmark once, on the card.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the port (`dwcgan_tpu_torch/`).
The cell's driver makes the weights and the traffic from `--seed`, warms
up, measures for `--seconds`, and, with `--trace 1`, profiles a short
slice after the window; then the plain reference decides `correct`.  The
last line of standard output is one JSON object (`correct`, `attempted`,
`failed`, `metrics`, `device`, with `--trace 1` `breakdown`, and last
`checks`: each number compared beside its limit, also the last lines of
standard error).  `--trace 0` prints the cell's end-to-end metrics,
`--trace 1` its per-layer ones.

Exits 2 without a CUDA card (or with fewer than the cell asks for), 1 when
the port cannot be imported, 3 when the process loaded the JAX stack or the
JAX package; in each case it prints no result.
"""

from __future__ import annotations

import time

T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# the process's settings, made before torch or the port's native library
# loads: one OpenMP thread for PyTorch's CPU operations and for each call
# of the feed's resize, so that no idle OpenMP team spins on the host cores
# that the dispatching thread and the feed's workers share
ENV = {"OMP_NUM_THREADS": "1"}


def process_start() -> float:
    """perf_counter() at the process's start (Linux: its start tick in
    /proc), else at this module's import."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return T_IMPORT


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if args.seconds <= 0:
        p.error("--seconds must be positive")
    return args


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def execute(run, t_start: float) -> dict:
    """Drive the cell, read its metrics, decide `correct`; the result
    line (core.result) or raise."""
    from port_bench import compare, core

    rec = core.load_driver(run.cell["traffic"]["driver"], run.base).run(run)
    rec.update(config=run.config, cell=run.cell, setup_s=rec["t0"] - t_start)
    names = run.cell["per_layer"] if run.trace else run.cell["end_to_end"]
    metrics = {}
    for name in names:
        module = core.load_metric(name, run.base)
        value = module.read(rec)
        if value is not None:
            metrics[name] = (value, module.UNIT)
    ok, checks = compare.held(rec["numbers"], run.cell["limits"])
    device = {"platform": "gpu" if run.device == "cuda" else run.device,
              "kind": _device_name(run.device), "count": run.cell["chips"],
              "memory_peak_bytes": int(rec["memory_peak_bytes"])}
    breakdown = None
    if run.trace:
        from port_bench.yardstick import readers
        tr = rec["trace"]
        # the window's wall, and its busy time as the trace measures it per
        # step or batch (the profiled slice's own wall is slowed by the
        # profiler), capped at the window within `readers.SATURATED_UP_TO`:
        # the driver's idle share is `device_idle_share.*`, the uncapped
        # time per unit `device_busy_ms.*`
        device.update(busy_s=readers.window_busy_s(rec), window_s=rec["window_s"])
        breakdown = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    line = core.result(ok, rec["attempted"], rec["failed"], metrics, device, checks, breakdown)
    if run.control:
        line["control"] = rec["control"]
    return line


def _device_name(device: str) -> str:
    import torch
    return torch.cuda.get_device_name(0) if device == "cuda" else device


def main(argv=None) -> int:
    t_start = process_start()
    args = parse_args(argv)
    os.environ.update(ENV)
    # every cache of the program and its libraries inside the checkout
    cache = BENCH / "cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    if sys.path and Path(sys.path[0]).resolve() == BENCH:
        sys.path.pop(0)
    sys.path.insert(0, str(ROOT))
    from port_bench import core

    cell, config = core.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"port_bench: the cell needs {cell['chips']} CUDA card(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"device_count() = {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        import dwcgan_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"port_bench: the port is not importable here: {e}", file=sys.stderr)
        return 1
    run = core.Run(args.workload, cell, config, args.seed, args.seconds, bool(args.trace),
                   cache=cache)
    line = execute(run, t_start)
    bad = core.forbidden_modules(sys.modules)
    if bad:
        print(f"port_bench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    line = {**{k: v for k, v in line.items() if k != "checks"}, "card": card_line(),
            "checks": line["checks"]}
    core.emit(line, line["checks"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
