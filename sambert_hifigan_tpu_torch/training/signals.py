"""Failure detection and graceful shutdown for long training runs.

* `GracefulShutdown` turns SIGTERM/SIGINT into a polled flag, so that the
  training loop finishes its step, saves a resumable checkpoint and exits
  (`--resume` continues from it).  A second signal restores the previous
  handler's behaviour (die now).
* `check_finite_metrics` raises `TrainingDiverged` when a logged metric is
  not finite.  Trainers call it where the metrics come to the host anyway
  (the log step), so it adds no device sync; the trainer then saves an
  emergency checkpoint and exits non-zero.

In a process group both are agreed across the ranks: `GracefulShutdown.
agreed()` is a MAX of the flag over the host group, taken by every rank at
the top of each step, so a rank signalled one step before its peers does
not leave them blocked in a collective; and the metrics are global, so
every rank reads the same divergence.
"""

from __future__ import annotations

import math
import signal
import sys
from typing import Mapping

from ..parallel import mesh


class TrainingDiverged(RuntimeError):
    """A logged metric went NaN/Inf; the training loop should stop."""


def check_finite_metrics(host_metrics: Mapping[str, float], step: int) -> None:
    """Raise TrainingDiverged naming every non-finite metric at `step`."""
    bad = [k for k, v in host_metrics.items() if not math.isfinite(float(v))]
    if bad:
        raise TrainingDiverged(
            f"non-finite metrics at step {step}: {', '.join(sorted(bad))}"
        )


class GracefulShutdown:
    """Poll `requested` in the training loop; SIGTERM/SIGINT sets it.

    The first signal only sets the flag (the loop saves and exits at the
    next iteration boundary); a second signal re-raises via the original
    handler, so a stuck run can still be killed with a repeated Ctrl-C.
    """

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.requested = False
        self._signalled = False  # this process's own signal
        self._prev = {}
        for sig in signals:
            self._prev[sig] = signal.signal(sig, self._handle)

    def _handle(self, signum, frame):
        if self._signalled:  # second signal: defer to the original behavior
            prev = self._prev.get(signum)
            signal.signal(signum, prev if callable(prev) else signal.SIG_DFL)
            raise KeyboardInterrupt
        self._signalled = self.requested = True
        print(
            f"[signal] {signal.Signals(signum).name} received — finishing the "
            "current step, saving a checkpoint, then exiting (signal again to "
            "die immediately)",
            file=sys.stderr,
            flush=True,
        )

    def agreed(self) -> bool:
        """Whether any rank has been signalled; sets `requested` on every
        rank if so.  Every rank must call it at the same point (in one
        process, the local flag).  The flag is read from `_signalled`, which
        only the handler sets: a signal that lands while the reduction runs
        sets `requested`, which the assignment below overwrites, but is
        still read at the next call."""
        self.requested = mesh.any_rank(self._signalled or self.requested)
        return self.requested

    def restore(self) -> None:
        """Reinstall the original handlers (for tests / nested use)."""
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
