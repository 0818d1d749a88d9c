"""What one cell is, found by the names in BENCHMARK.json: its
configuration file (with the limits of its compared numbers), the model
that file names (harness/models/<model>.py), its traffic file
(traffic/<traffic>.json, whose laws are traffic/laws/<law>.py), the
end-to-end metrics it reports and the readers of its per-layer metrics
(metrics/<name>.py, each with `read(run) -> float or None`)."""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional

HARNESS_DIR = Path(__file__).resolve().parent
BENCH_DIR = HARNESS_DIR.parent
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
    model: Optional[ModuleType] = None

    @property
    def laws_dir(self) -> Path:
        return self.bench_dir / "traffic" / "laws"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def stems(directory: Path) -> list:
    """The names of the modules in a directory."""
    return sorted(p.stem for p in Path(directory).glob("*.py") if p.stem != "__init__")


def load_module(directory: Path, name: str, what: str, qualified: str) -> ModuleType:
    """The module `<directory>/<name>.py`, found by file name, so that one
    added to another checkout's benchmark runs against this harness; a
    ValueError that lists the names there are where `name` is not one of
    them (which keeps it inside `directory`).  A module of this harness
    itself is imported under `qualified`, once."""
    if name not in stems(directory):
        raise ValueError(f"{what} {name!r} is not one of {stems(directory)}")
    path = (Path(directory) / f"{name}.py").resolve()
    if path.is_relative_to(HARNESS_DIR):
        return importlib.import_module(qualified)
    spec = importlib.util.spec_from_file_location(qualified, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(name: str, bench_dir: Path = BENCH_DIR) -> Callable:
    return load_module(Path(bench_dir) / "metrics", name, "per-layer metric",
                       f"benchmark_metric_{name}").read


def model(name: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    """The module of the model a configuration names."""
    return load_module(Path(bench_dir) / "harness" / "models", name, "model",
                       f"{__package__}.models.{name}")


def model_of(cell: Cell) -> ModuleType:
    """The model of a cell whose kind runs one (one-shot calls, live
    streams); a KeyError where its configuration names none."""
    if cell.model is None:
        there = stems(cell.bench_dir / "harness" / "models")
        raise KeyError(f"the configuration of {cell.name} names no model (one of {there})")
    return cell.model


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell named `workload` of the checkout at `root`; raises KeyError
    for an unknown one, ValueError for a model that has no module.  A
    configuration that names no model (the vocoder trainer's) loads with
    `model` None: the kinds that run a model take it by `model_of`."""
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
                bench_dir, model(config["model"], bench_dir) if "model" in config else None)
