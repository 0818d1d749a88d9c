"""Run one cell of the benchmark once and print its result line.

  python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell, its configuration, traffic and
metrics are found by the names in BENCHMARK.json.  Diagnostics go to
standard error, each compared number beside its limit last; the last line
of standard output is the result as one JSON object.  Exits non-zero, with
no result, where there is no CUDA card or fewer than the cell needs, or
where the process has loaded JAX or the JAX package by the window's close.
"""

from __future__ import annotations

import os
import sys
import time


def _process_start() -> float:
    """The wall-clock time this process started (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


STARTED = _process_start()
BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
CACHE = os.path.join(ROOT, ".bench_cache")


def main(argv=None) -> int:
    import argparse
    import json

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # every cache of the run inside the checkout, at fixed paths
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [BENCH_DIR, ROOT]
    import torch

    from harness.core import forbidden_modules, run_cell
    from harness.record import Context, log
    from harness.spec import load_cell

    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"needs {cell.chips} CUDA card(s), found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    line, _ = run_cell(cell, args.seed, args.seconds, bool(args.trace), Context(started=STARTED))
    bad = forbidden_modules()
    if bad:
        log(f"the run loaded {bad}: JAX or the JAX package")
        return 3
    for name, c in line["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
