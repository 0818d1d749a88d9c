"""The one traffic generator: a traffic file's parameters and a seed ->
the inputs of a run.

A distribution in a traffic file is a group with a `law`, the name of a
file `traffic/laws/<law>.py` whose `draw(params, n)` gives n values
without a seed; a new law is a new file there.  Text lengths are rounded
and clipped to the group's `min` and `max`.  A law with `ORDERED = False`
gives a set of values (its quantiles), which the generator puts in one
fixed order; one with `ORDERED = True` gives a sequence (on/off bursts),
kept as it is.

Every seed gets the same sizes and the same arrival gaps, so runs of
different seeds do the same work; the seed orders a closed loop's batches
and rows and draws the characters.

Kinds of mix (the traffic file's "kind", which names the driver):
  batch  closed loop of one-shot calls of `batch` texts.  The pool of
         batch x cycle lengths, sorted, is dealt round-robin into `cycle`
         batches, so every cycle holds the same batches; the seed orders
         the batches of each cycle and the rows of each batch.
  live   open loop of streams: `rate_per_s` x seconds arrivals, each one
         text, their gaps drawn from the `gaps` law at that rate, on one
         schedule for every seed.
  train  closed loop of train steps on `batch` segments of
         `segment_frames` frames (the data is made by the driver).
"""

from __future__ import annotations

from pathlib import Path
from typing import List

import numpy as np

from .spec import load_module

CJK_FIRST, CJK_LAST = 0x4E00, 0x9FA5  # the common CJK ideographs
LAWS_DIR = Path(__file__).resolve().parent.parent / "traffic" / "laws"


def law(name: str, laws_dir: Path = LAWS_DIR):
    """The module of the law `name`, found by file name."""
    return load_module(laws_dir, name, "traffic law", f"benchmark_law_{name}")


def draw(group: dict, n: int, laws_dir: Path = LAWS_DIR) -> List[float]:
    """n values of a distribution group, in the generator's order."""
    module = law(group["law"], laws_dir)
    values = list(module.draw(group, n))
    if len(values) != n:
        raise ValueError(f"law {group['law']!r} gave {len(values)} values, not {n}")
    return values


def lengths(group: dict, n: int, laws_dir: Path = LAWS_DIR) -> List[int]:
    """n text lengths in characters, rounded and clipped."""
    return [int(min(max(round(v), group["min"]), group["max"]))
            for v in draw(group, n, laws_dir)]


def text(rng: np.random.Generator, n: int) -> str:
    return "".join(chr(c) for c in rng.integers(CJK_FIRST, CJK_LAST + 1, n))


def batch_cycles(spec: dict, seed: int, cycles: int,
                 laws_dir: Path = LAWS_DIR) -> List[List[List[str]]]:
    """`cycles` cycles, each a list of `cycle` batches of `batch` texts."""
    rng = np.random.default_rng(seed)
    b, c = spec["batch"], spec["cycle"]
    pool = sorted(lengths(spec["text_chars"], b * c, laws_dir))
    batches = [pool[j::c] for j in range(c)]
    out = []
    for _ in range(cycles):
        cyc = []
        for j in rng.permutation(c):
            rows = [batches[j][i] for i in rng.permutation(b)]
            cyc.append([text(rng, n) for n in rows])
        out.append(cyc)
    return out


def arrivals(spec: dict, seed: int, seconds: float, laws_dir: Path = LAWS_DIR):
    """[(due seconds from the window's start, text)] of an open loop.  The
    schedule, gaps and sizes in their order, is the same for every seed
    (a tail latency moves with where the bursts and the long texts fall);
    the seed draws the characters."""
    n = max(1, round(spec["rate_per_s"] * seconds))
    gap_law = dict(spec["gaps"], rate_per_s=spec["rate_per_s"])
    gaps = draw(gap_law, n, laws_dir)
    sizes = lengths(spec["text_chars"], n, laws_dir)
    order = np.random.default_rng(n)  # one fixed order of a law's set of values
    for values, group in ((gaps, gap_law), (sizes, spec["text_chars"])):
        perm = order.permutation(n)
        if not law(group["law"], laws_dir).ORDERED:
            values[:] = [values[i] for i in perm]
    rng = np.random.default_rng(seed)
    due, t = [], 0.0
    for g, s in zip(gaps, sizes):
        due.append((t, text(rng, s)))
        t += g
    return due
