"""What one cell is, found by the names in BENCHMARK.json: its
configuration file (with the limits of its compared numbers), its traffic
file (traffic/<traffic>.json, whose laws are traffic/laws/<law>.py), the
end-to-end metrics it reports and the readers of its per-layer metrics
(metrics/<name>.py, each with `read(run) -> float or None`)."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    readers: Dict[str, Callable]
    limits: Dict[str, float]
    bench_dir: Path = BENCH_DIR

    @property
    def laws_dir(self) -> Path:
        return self.bench_dir / "traffic" / "laws"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reader(name: str, bench_dir: Path = BENCH_DIR) -> Callable:
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell named `workload` of the checkout at `root`; raises KeyError
    for an unknown one."""
    root = Path(root)
    bench_dir = root / BENCH_DIR.name
    bench = load_json(root / "BENCHMARK.json")
    w = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if w is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = load_json(root / conf["file"])
    traffic = load_json(bench_dir / "traffic" / f"{w['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if _reports(m, workload)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e_names)]
    return Cell(workload, int(w["chips"]), config, traffic, e2e, per_layer,
                {m["name"]: reader(m["name"], bench_dir) for m in per_layer}, config["limits"],
                bench_dir)
