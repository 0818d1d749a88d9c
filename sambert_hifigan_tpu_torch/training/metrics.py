"""Metrics logging: one JSONL record per log step (machine-readable,
append-only) and a console summary line.  The step's metrics stay on the
device; `write` brings them to the host in one copy, at the log step only.
`tensorboard=True` mirrors every scalar into TensorBoard event files when
torch's SummaryWriter can be imported, and is silently off otherwise; the
JSONL file stays the record.  In a process group the metrics are global
(the train steps reduce them), and only rank 0 writes them."""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Mapping, Optional

import torch

from ..parallel import mesh


def to_host(metrics: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    """{name: float} from 0-dim tensors, fetched in one device-to-host copy."""
    values = torch.stack([v.detach().float() for v in metrics.values()]).cpu()
    return dict(zip(metrics, values.tolist()))


class MetricsWriter:
    def __init__(self, log_dir: str, name: str = "train", tensorboard: bool = False):
        self.path = Path(log_dir)
        self.writes = mesh.is_main()
        if self.writes:
            self.path.mkdir(parents=True, exist_ok=True)
        self.file = self.path / f"{name}_metrics.jsonl"
        self._t0 = time.monotonic()
        self._tb = None
        if tensorboard and self.writes:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=str(self.path / f"tb_{name}"))
            except ImportError:  # TensorBoard is optional; JSONL is the record
                self._tb = None

    def write(self, step: int, metrics: Mapping[str, torch.Tensor], **extra) -> Dict[str, float]:
        """Fetch the metrics and append one JSONL record (rank 0); returns
        them."""
        host = to_host(metrics)
        if not self.writes:
            return host
        record = {"step": int(step), "wall_time_s": round(time.monotonic() - self._t0, 3),
                  **host, **extra}
        with open(self.file, "a", encoding="utf-8") as f:
            f.write(json.dumps(record) + "\n")
        if self._tb is not None:
            for k, v in host.items():
                self._tb.add_scalar(k, v, int(step))
        return host

    def close(self) -> None:
        if self._tb is not None:
            self._tb.flush()
            self._tb.close()

    @staticmethod
    def summary_line(step: int, host_metrics: Mapping[str, float],
                     keys: Optional[list] = None) -> str:
        keys = keys or sorted(host_metrics)
        parts = " ".join(f"{k}={host_metrics[k]:.4f}" for k in keys if k in host_metrics)
        return f"step {step}: {parts}"
