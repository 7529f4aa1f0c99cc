"""The readings a cell's limits are set from (not part of a benchmark run):

    python3 bench_torch/calibrate.py --workload NAME --seeds S1,S2,... \
        [--control-seeds C1,C2,C3] [--fault-seeds F1,F2,F3] [--seconds 3]

In one process: for each of ``--seeds`` a run of the cell at its own size
with a short window, and the numbers its check compares (the program's
readings, whose largest is a limit's lower reading); for each of
``--control-seeds`` the same numbers for the control, the reference in the
precision below the configuration's against the reference (the upper
reading); for each of ``--fault-seeds`` a run with each fault of
``harness/faults.py`` planted.  A training cell's readings come also
split into its first steps (``first.``) and the steps after the window
(``after.``).  One JSON line a reading on standard
output, and a summary last.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT)]


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args()
    import torch
    from harness import drive, faults
    from harness.cell import load_cell

    cell = load_cell(ROOT, args.workload)
    device = torch.device("cuda", 0)
    flow = drive.FLOWS[cell.traffic["kind"]]
    seeds = lambda s: [int(v) for v in s.split(",") if v]  # noqa: E731
    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    for seed in seeds(args.seeds):
        o = flow(cell, seed, args.seconds, False, device, time.perf_counter())
        emit({"who": "program", "seed": seed, **o.numbers,
              "failed": o.failed, "attempted": o.attempted})
        torch.cuda.empty_cache()
    for seed in seeds(args.control_seeds):
        emit({"who": "control", "seed": seed,
              **drive.control_numbers(cell, seed, device)})
        torch.cuda.empty_cache()
    for seed in seeds(args.fault_seeds):
        for name, fault in faults.for_kind(cell.traffic["kind"]).items():
            o = flow(cell, seed, args.seconds, False, device,
                     time.perf_counter(), fault)
            emit({"who": f"fault.{name}", "seed": seed, **o.numbers})
            torch.cuda.empty_cache()
    summary = {}
    for row in rows:
        for k, v in row.items():
            if k.rsplit(".", 1)[-1] in cell.limits:
                s = summary.setdefault(row["who"], {}).setdefault(k, [])
                s.append(v)
    print(json.dumps({"summary": {who: {k: [min(v), max(v), len(v)]
                                        for k, v in d.items()}
                                  for who, d in summary.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
