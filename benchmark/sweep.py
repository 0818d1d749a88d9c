"""The open-loop sweep that fixes a live mix's rate: one pipeline and
batcher, then the mix at each rate in turn, on the card.

  python benchmark/sweep.py --workload tts-live --rates 6 8 10 12 14 --seconds 20

For each rate: the time to first audio (median, p95), the p95 of the
first and of the second half of the arrivals (a backlog that grows shows
as a second half far above the first), and how long the last streams
took to end after the last arrival.  A cell's rate is four fifths of the
highest rate whose p95 meets the mix's limit with no growing backlog."""

from __future__ import annotations

import argparse
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
sys.path[:0] = [BENCH_DIR, ROOT]


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args()
    import numpy as np
    import torch

    from harness import port, traffic
    from harness.common import dtype_of
    from harness.drivers.live import _open_loop, p95
    from harness.record import Context
    from harness.spec import load_cell, model_of
    from reference import frontend

    cell = load_cell(args.workload)
    c, tr, model = cell.config, cell.traffic, model_of(cell)
    cfg = model.config(c)
    dev = torch.device("cuda")
    port.build_kernels()
    W = model.weights(c, cfg, args.seed, dev)
    pipe = model.pipeline(cfg, W, [dev], dtype_of(c))
    batcher = port.batcher(pipe, tr["max_batch"], tr["max_wait_ms"])
    warm = {}
    for _, text in traffic.arrivals(tr, args.seed, args.seconds, cell.laws_dir):
        warm.setdefault(frontend.pick_bucket(frontend.phoneme_count(text),
                                             c["phoneme_buckets"]), text)
    for text in warm.values():
        for _ in batcher.synthesize_stream(text, tr["chunk_frames"], tr["context_frames"]):
            pass
    for rate in args.rates:
        arrivals = traffic.arrivals(dict(tr, rate_per_s=rate), args.seed, args.seconds,
                                    cell.laws_dir)
        results, late, wall = _open_loop(batcher, arrivals, tr, Context())
        ms = [1e6 if t is None else t * 1e3 for t, _ in results]
        half = len(ms) // 2
        print(json.dumps({"rate_per_s": rate, "streams": len(ms),
                          "failed": sum(t is None for t, _ in results),
                          "ttfa_p50_ms": float(np.median(ms)), "ttfa_p95_ms": p95(ms),
                          "p95_first_half_ms": p95(ms[:half]),
                          "p95_second_half_ms": p95(ms[half:]),
                          "drain_s": wall - arrivals[-1][0], "late_ms": late * 1e3}),
              flush=True)
    batcher.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
