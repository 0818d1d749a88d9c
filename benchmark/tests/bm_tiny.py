"""Each cell cut to a size the CPU runs in seconds: the program in f32,
where its kernels' plain versions compute the f32 reference's arithmetic.
A one-shot or live cell takes its model's `TINY` sizes."""

from __future__ import annotations

import dataclasses
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)

TINY_GAN = dict(upsample_initial_channel=16, channel_div=64, dtype="float32")
TINY_TRAFFIC = {
    "batch": dict(batch=4, cycle=2, check_calls=2,
                  text_chars=dict(law="lognormal", median=4, sigma=0.5, min=2, max=12)),
    "live": dict(rate_per_s=20.0, chunk_frames=4, context_frames=2, trace_seconds=0.1,
                 check_streams=3,
                 text_chars=dict(law="lognormal", median=4, sigma=0.5, min=2, max=10)),
    "train": dict(batch=2, segment_frames=5, pool_batches=4, setup_steps=3, check_steps=2,
                  trace_steps=1),
}


def tiny(cell):
    """The cell at the CPU tests' size."""
    from harness.spec import model_of

    kind = cell.traffic["kind"]
    kind = kind if kind in TINY_TRAFFIC else "batch"  # a kind the tests add, of one-shot calls
    over = TINY_GAN if kind == "train" else model_of(cell).TINY
    return dataclasses.replace(cell, config={**cell.config, **over},
                               traffic={**cell.traffic, **TINY_TRAFFIC[kind]})


def train_cell():
    """The vocoder-train cell, built from its files: its driver, traffic,
    configuration and reference are kept and tested, but it is not a cell
    of BENCHMARK.json (PERF.md, Open questions)."""
    from harness.spec import Cell

    def load(*rel):
        with open(os.path.join(BENCH_DIR, *rel)) as f:
            return json.load(f)
    config = load("configs", "hifigan-v1-gan.json")
    return Cell("vocoder-train", 1, config, load("traffic", "vocoder-train.json"),
                [dict(name="train_steps_per_s", unit="steps/s"), dict(name="setup_s", unit="s")],
                [], {}, config["limits"])


def cell(name: str, root=ROOT):
    """A cell of BENCHMARK.json, or the vocoder-train cell."""
    from harness.spec import load_cell

    return train_cell() if name == "vocoder-train" else load_cell(name, root)
