"""A short stretch under torch.profiler, reduced in memory: the device's
busy time (the union of kernel intervals on each card, averaged over the
cards), kernel time and count by name, and the longest idle gaps labelled
with the host operator that was running.  Nothing is written to disk."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple


def union_seconds(intervals: List[Tuple[float, float]]) -> float:
    """Seconds covered by the union of (start_us, end_us) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e6


def gaps(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The idle (start_us, end_us) stretches between merged intervals."""
    out, end = [], None
    for s, e in sorted(intervals):
        if end is not None and s > end:
            out.append((end, s))
        end = e if end is None else max(end, e)
    return out


@dataclass
class Trace:
    wall_s: float  # the traced stretch on the host clock
    busy_s: float  # union of kernel intervals, mean over the cards used
    kernels: Dict[str, Tuple[float, int]] = field(default_factory=dict)  # name: (s, count)
    launches: int = 0
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)

    def seconds_of(self, *names: str) -> float:
        """Device seconds of the kernels whose name contains any of `names`."""
        return sum(s for k, (s, _) in self.kernels.items() if any(n in k for n in names))

    def top(self, n: int = 10) -> List[Tuple[str, float]]:
        return [[k, s] for k, (s, _) in sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:n]]


def _is_kernel(name: str) -> bool:
    return not (name.startswith("Memcpy") or name.startswith("Memset"))


def capture(fn: Callable[[], None], cards: int) -> Trace:
    """fn() under the profiler; fn ends in a device synchronize."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
    dev_type = torch.autograd.DeviceType.CUDA
    events = prof.events()
    device, host = [], []
    for e in events:
        if getattr(e, "is_user_annotation", False):
            continue
        (device if e.device_type == dev_type else host).append(e)
    by_card: Dict[int, List[Tuple[float, float]]] = {}
    kernels: Dict[str, Tuple[float, int]] = {}
    launches = 0
    for e in device:
        s, t = e.time_range.start, e.time_range.end
        by_card.setdefault(getattr(e, "device_index", 0), []).append((s, t))
        sec, n = kernels.get(e.name, (0.0, 0))
        kernels[e.name] = (sec + (t - s) / 1e6, n + 1)
        launches += _is_kernel(e.name)
    busy = sum(union_seconds(v) for v in by_card.values()) / max(cards, 1)
    merged = [iv for v in by_card.values() for iv in v]
    longest = sorted(gaps(merged), key=lambda g: g[0] - g[1])[:10]
    labelled = [[_host_label(host, s, e), (e - s) / 1e6] for s, e in longest]
    return Trace(wall, busy, kernels, launches, labelled)


def _host_label(host, start: float, end: float) -> str:
    """What the host was doing in a gap: the innermost operator spanning
    its middle, else the last one that began before it ("after <op>")."""
    mid = (start + end) / 2
    best, width, last, last_start = None, None, None, None
    for e in host:
        s, t = e.time_range.start, e.time_range.end
        if s <= mid <= t and (width is None or t - s < width):
            best, width = e.name, t - s
        if s <= mid and (last_start is None or s > last_start):
            last, last_start = e.name, s
    return best or (f"after {last}" if last else "host")
