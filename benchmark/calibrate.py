"""Readings that a cell's correctness limits are set from, on the card at
the cell's own size; never run by run.py.

  python benchmark/calibrate.py --workload <name> --mode program|control|<fault> \
      --seeds 1 2 3 [--seconds 5]

program  sound runs of the system (its window, then the comparison), one
         seed after another in this process
control  the reference in fp8 put in the system's place, judged against
         the f32 reference exactly as the system's output is, on the
         calls, streams or steps a run at that seed would compare (for
         training, a sound run whose compared steps, the set-up's and the
         window's last, are then the fp8 reference's from the same states)
<fault>  the system with a fault planted under its timed path:
         answer_altered (one-shot and live), unchanged or half_batch
         (training)
Prints one JSON line of compared numbers per seed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
sys.path[:0] = [BENCH_DIR, ROOT]


def control(cell, seed: int, seconds: float, device: str = "cuda") -> dict:
    import torch

    from harness import traffic
    from harness.drivers import batch, live
    from harness.record import Run
    from harness.spec import model_of
    from reference.precision import ieee_f32, rounder

    c, tr, model = cell.config, cell.traffic, model_of(cell)
    dev = torch.device(device)
    out = Run(c, tr, cell.chips)
    W = model.weights(c, model.config(c), seed, dev)
    if tr["kind"] == "batch":
        calls = [t for cyc in traffic.batch_cycles(tr, seed, 3, cell.laws_dir) for t in cyc]
        picks = batch.sample([(0, 0, t, None) for t in calls], tr["check_calls"], seed)
        with ieee_f32():
            results = [(0, 0, calls[i], model.reference_batch(W, c, calls[i], rounder("fp8"),
                                                              dev))
                       for i in picks]
        batch.check(out, results, model, W, c, dict(tr, check_calls=len(results)),
                    seed, dev, "f32")
        return out.checks
    arrivals = traffic.arrivals(tr, seed, seconds, cell.laws_dir)
    chosen = live.picks(arrivals, list(range(len(arrivals))), tr["check_streams"], seed)
    with ieee_f32():
        chunks = model.reference_stream(W, c, [arrivals[i][1] for i in chosen],
                                        tr["chunk_frames"], tr["context_frames"], rounder("fp8"),
                                        dev)
    results = [(0.0, [])] * len(arrivals)
    for i, ch in zip(chosen, chunks):
        results[i] = (0.0, ch)
    live.check(out, arrivals, results, model, W, c, tr, seed, dev, "f32")
    return out.checks


def readings(cell, mode: str, seed: int, seconds: float, device: str = "cuda") -> dict:
    """One seed's line: the compared numbers, and a run's correctness and
    metrics where the mode runs the system."""
    if mode == "control" and cell.traffic["kind"] != "train":
        return {"seed": seed, "mode": mode, "checks": control(cell, seed, seconds, device)}
    from harness.core import run_cell
    from harness.record import Context

    fault = None if mode == "program" else mode
    res, _ = run_cell(cell, seed, seconds, False, Context(device=device, fault=fault))
    return {"seed": seed, "mode": mode, "correct": res["correct"],
            "checks": {k: v["value"] for k, v in res["checks"].items()},
            "metrics": {k: v["value"] for k, v in res["metrics"].items()}}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    args = p.parse_args()
    from harness.spec import load_cell

    cell = load_cell(args.workload)
    for seed in args.seeds:
        print(json.dumps(readings(cell, args.mode, seed, args.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
