"""Readings that a cell's correctness limits are set from, on the card:
for each seed, the numbers the cell compares for the program (`numbers`)
and for the control (`control`: the plain reference with every
convolution and matrix product on float8 e4m3 operands, put in the
program's place), all seeds in one process.

    python3 port_bench/calibrate.py --workload <cell> --seeds 1,2,3 [--seconds 2]
        [--fault half_batch] [--fp32 1] [--out chiprun_out/calib.jsonl]

`--fp32 1` runs the program as a witness in float32 with TF32 off (the
configuration's `compute_dtype` set to float32), where the gaps that
bf16 rounding makes should vanish.  The benchmark's own runs never run
the control.  One JSON line per seed.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--control", type=int, default=1)
    p.add_argument("--fault", default=None, help="a name of faults.FAULTS, "
                   "planted under the program (the control is then not read)")
    p.add_argument("--fp32", type=int, default=0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if sys.path and Path(sys.path[0]).resolve() == BENCH:
        sys.path.pop(0)
    sys.path.insert(0, str(BENCH.parent))
    import torch
    from port_bench import compare, core, faults

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell, config = core.load_cell(args.workload)
    if args.fp32:
        config = {**config, "compute_dtype": "float32"}
    driver = core.load_driver(cell["traffic"]["driver"])
    out = open(args.out, "a") if args.out else None
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            t = time.perf_counter()
            run = core.Run(args.workload, cell, config, seed, args.seconds, False,
                           cache=BENCH / "cache",
                           control=bool(args.control) and not args.fault)
            if args.fault:
                run.wrap = faults.FAULTS[args.fault]
            with compare.plain_fp32() if args.fp32 else contextlib.nullcontext():
                rec = driver.run(run)
            row = {"workload": args.workload, "seed": seed, "fault": args.fault,
                   "fp32": bool(args.fp32),
                   "numbers": rec["numbers"],
                   "control": rec.get("control"), "setup_s": rec["t0"] - t,
                   "seconds": time.perf_counter() - t}
            print(json.dumps(row), flush=True)
            if out:
                out.write(json.dumps(row) + "\n")
                out.flush()
            del rec, run
            torch.cuda.empty_cache()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
