"""What every driver sets up alike: the cards a run uses, the precision,
and the device's synchronisation and peak memory."""

from __future__ import annotations

import torch

from .record import Context


def devices_for(ctx: Context, chips: int):
    if ctx.device == "cpu":
        return [torch.device("cpu")] * chips
    return [torch.device("cuda", i) for i in range(chips)]


def dtype_of(c: dict):
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[c["dtype"]]


def sync(devs) -> None:
    for d in devs:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def peak_bytes(devs) -> int:
    return max((torch.cuda.max_memory_allocated(d) for d in devs if d.type == "cuda"),
               default=0)
