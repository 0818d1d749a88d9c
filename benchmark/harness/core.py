"""One run of one cell: the driver of its traffic's kind, then the result
line's parts.  A traffic file's `kind` names its driver, the module
`harness/drivers/<kind>.py` with `run(cell, seed, seconds, trace, ctx) ->
Run`; a new kind of mix is a new file there."""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Callable, Optional

from .record import Context, Run, log
from .spec import BENCH_DIR, Cell, load_module, stems

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "sambert_hifigan_tpu")


def kinds(bench_dir: Path = BENCH_DIR) -> list:
    """The kinds of mix there are drivers for in a benchmark directory."""
    return stems(Path(bench_dir) / "harness" / "drivers")


def driver(kind: str, bench_dir: Path = BENCH_DIR) -> Callable:
    """The `run` of the driver of a traffic kind, found by file name."""
    return load_module(Path(bench_dir) / "harness" / "drivers", kind, "traffic kind",
                       f"{__package__}.drivers.{kind}").run


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def device_info(ctx: Context, cell: Cell, run: Run, trace: bool) -> dict:
    import torch

    on_card = ctx.device != "cpu"
    info = {"platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
            "count": cell.chips, "memory_peak_bytes": int(run.memory_peak_bytes)}
    if trace and run.trace is not None:
        info["busy_s"] = run.trace.busy_s
        info["window_s"] = run.trace.wall_s
    return info


def result(cell: Cell, run: Run, ctx: Context, trace: bool) -> dict:
    """The result line's object, the compared numbers last."""
    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = cell.readers[m["name"]](run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {}
        for m in cell.end_to_end:
            v = ctx.setup_s if m["name"] == "setup_s" else run.e2e[m["name"]]
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    checks = {k: {"value": v, "limit": cell.limits[k]} for k, v in run.checks.items()}
    correct = run.failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    line = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
            "metrics": metrics, "device": device_info(ctx, cell, run, trace)}
    if trace and run.trace is not None:
        line["breakdown"] = {"device_ops": run.trace.top(10), "idle_gaps": run.trace.idle_gaps}
    line["checks"] = checks
    return line


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, ctx: Optional[Context] = None):
    """(the result object, the Run) of one run."""
    ctx = ctx or Context()
    run = driver(cell.traffic["kind"], cell.bench_dir)(cell, seed, seconds, trace, ctx)
    for k, v in run.notes.items():
        log(f"{k}: {v}")
    return result(cell, run, ctx, trace), run
