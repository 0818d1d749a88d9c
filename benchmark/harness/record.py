"""What a run hands the metric readers and the result line."""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .trace import Trace


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


@dataclass
class Context:
    """How a driver runs: the device ("cuda", or "cpu" in the tests), a
    fault to plant under the timed path (tests and calibration only), and
    the clock that ends set-up."""

    device: str = "cuda"
    fault: Optional[str] = None
    started: float = field(default_factory=time.time)
    setup_s: Optional[float] = None

    def setup_done(self) -> None:
        self.setup_s = time.time() - self.started


@dataclass
class Run:
    config: dict
    traffic: dict
    chips: int
    attempted: int = 0
    failed: int = 0
    window_s: float = 0.0
    e2e: Dict[str, float] = field(default_factory=dict)
    # one-shot calls of the window, and of the traced stretch: each a list
    # of (phonemes, frames returned) per row
    calls: List[List[tuple]] = field(default_factory=list)
    traced_calls: List[List[tuple]] = field(default_factory=list)
    traced_wall_s: float = 0.0  # the traced work's wall time without the profiler
    steps: int = 0
    traced_steps: int = 0
    samples: Dict[str, List[float]] = field(default_factory=dict)
    trace: Optional[Trace] = None
    checks: Dict[str, float] = field(default_factory=dict)
    memory_peak_bytes: int = 0
    notes: Dict[str, object] = field(default_factory=dict)

