"""The port's benchmark: one run of one cell.

    python3 bench_torch/run.py --workload NAME --seed N --seconds S --trace {0,1}

from the root of a checkout, on a machine with the card(s) the cell asks
for.  It builds the cell's program (``ultrasound_modeling_tpu_torch``) with
weights and inputs made from ``--seed``, warms its shapes (set-up), drives
the cell's traffic for ``--seconds`` (the window), with ``--trace 1``
profiles a further stretch, then compares what the timed path produced
with the plain reference, and prints one JSON line last on standard
output: the cell's end-to-end metrics (``--trace 0``) or its per-layer
metrics (``--trace 1``), the device, and each number compared with its
limit (also the last lines on standard error).  Without the card it exits
with status 2 and prints no result.
"""

import time

T0 = time.perf_counter()      # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT)]


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run(cell, seed: int, seconds: float, traced: bool, device, t0: float,
        fault=None) -> dict:
    """One run on ``device``; returns the result line."""
    from harness import check, drive, report
    outcome = drive.FLOWS[cell.traffic["kind"]](cell, seed, seconds, traced,
                                                device, t0, fault)
    correct, checks = check.judge(outcome.numbers, cell.limits)
    return report.line(cell, outcome, traced, device, correct, checks)


def main(argv=None) -> int:
    args = parse(argv)
    # build and kernel caches stay inside the checkout, at fixed paths
    cache = ROOT / ".bench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    import torch
    from harness.cell import load_cell

    cell = load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    result = run(cell, args.seed, args.seconds, bool(args.trace), device, T0)
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
