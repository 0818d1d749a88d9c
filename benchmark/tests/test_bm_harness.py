"""The harness on the CPU: every cell resolves and runs end to end at a
tiny size, faults planted under the timed path come out as not correct, a
cell can be added with files and an entry alone, and no run loads JAX."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

import bm_tiny
from bm_tiny import BENCH_DIR, ROOT, tiny
from harness import traffic
from harness.core import FORBIDDEN, forbidden_modules, kinds, run_cell
from harness.record import Context
from harness.spec import load_cell, load_json

BENCH = load_json(os.path.join(ROOT, "BENCHMARK.json"))
CELLS = [w["name"] for w in BENCH["workloads"]]
RUNNABLE = CELLS + ["vocoder-train"]
SEED = 2 ** 31 + 12345
FAULTS = {"batch": ["answer_altered"], "live": ["answer_altered"],
          "train": ["unchanged", "half_batch"]}


def run_tiny(name, fault=None, root=ROOT):
    cell = tiny(bm_tiny.cell(name, root))
    return run_cell(cell, SEED, 0.2, False, Context(device="cpu", fault=fault))


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    cell = load_cell(name)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer and set(cell.readers) == {m["name"] for m in cell.per_layer}
    assert all(m["moves"] in e2e for m in cell.per_layer)
    assert cell.traffic["kind"] in kinds()
    assert {"length_mismatch", "wav_max_abs_err"} <= set(cell.limits) or \
        {"loss_gap", "change_gap"} <= set(cell.limits)


def test_benchmark_json_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(ROOT, c["file"]))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert m["better"] in ("lower", "higher")
    assert all(m["bound"] <= 0.25 for m in BENCH["end_to_end"])


@pytest.mark.parametrize("name", RUNNABLE)
def test_cell_runs_on_cpu(name):
    line, run = run_tiny(name)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    cell = bm_tiny.cell(name)
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert set(line["checks"]) <= set(cell.limits)
    json.loads(json.dumps(line))


@pytest.mark.parametrize("name,fault", [(n, f) for n in RUNNABLE
                                        for f in FAULTS[bm_tiny.cell(n).traffic["kind"]]])
def test_planted_fault_is_not_correct(name, fault):
    line, _ = run_tiny(name, fault)
    assert line["correct"] is False, line["checks"]


def test_same_work_for_every_seed():
    spec = load_cell("tts-batch").traffic
    a, b = (traffic.batch_cycles(spec, s, 2) for s in (1, 2 ** 31 + 5))
    lens = [sorted(sorted(len(t) for t in batch) for batch in cyc) for cyc in a + b]
    assert all(x == lens[0] for x in lens) and a != b
    live = load_cell("tts-live").traffic
    x, y = (traffic.arrivals(live, s, 10.0) for s in (3, 2 ** 31 + 4))
    assert [(d, len(t)) for d, t in x] == [(d, len(t)) for d, t in y] and x != y
    assert len(x) == round(live["rate_per_s"] * 10)


def test_forbidden_names_compared_whole():
    fake = ["jax_helpers", "sambert_hifigan_tpu_torch.x", "flaxen"]
    for m in fake:
        sys.modules.setdefault(m, None)
    try:
        assert not set(forbidden_modules()) & {"jax_helpers", "flaxen"}
        assert "sambert_hifigan_tpu_torch" not in forbidden_modules()
    finally:
        for m in fake:
            if sys.modules.get(m) is None:
                sys.modules.pop(m, None)


def test_run_loads_no_jax():
    code = ("import sys; sys.path[:0] = [%r, %r, %r]; import bm_tiny; "
            "from harness.spec import load_cell; from harness.core import run_cell, "
            "forbidden_modules; from harness.record import Context; "
            "run_cell(bm_tiny.tiny(load_cell('tts-batch')), 7, 0.1, False, "
            "Context(device='cpu')); print(forbidden_modules())"
            % (os.path.join(BENCH_DIR, "tests"), BENCH_DIR, ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
    assert set(FORBIDDEN) >= {"jax", "jaxlib", "flax", "optax", "sambert_hifigan_tpu"}


def test_run_refuses_without_card_and_prints_nothing():
    if _has_card():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, os.path.join(BENCH_DIR, "run.py"), "--workload",
                          "tts-batch", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_refuses_without_the_program(tmp_path):
    """A checkout of only BENCHMARK.json and the benchmark's files: the run
    fails before it prints anything."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path[:0] = [%r, %r, %r]; import bm_tiny; "
            "from harness.spec import load_cell; from harness.core import run_cell; "
            "from harness.record import Context; import json; "
            "line, _ = run_cell(bm_tiny.tiny(load_cell('tts-batch', %r)), 7, 0.1, False, "
            "Context(device='cpu')); print(json.dumps(line))"
            % (str(tmp_path / "benchmark" / "tests"), str(tmp_path / "benchmark"),
               str(tmp_path), str(tmp_path)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "sambert_hifigan_tpu_torch" in out.stderr


def _copy_with(tmp_path, files: dict, workloads: list, end_to_end=(), per_layer=()):
    """A copy of the benchmark with `files` added and cells, end-to-end
    metrics ((cell, metric): a new metric, or the name of one the cell
    reports too) and per-layer metrics appended."""
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel, text in files.items():
        (tmp_path / "benchmark" / rel).write_text(text)
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"] += workloads
    for name, metric in end_to_end:
        have = next((m for m in bench["end_to_end"] if m["name"] == metric["name"]), None)
        if have is None:
            bench["end_to_end"].append(dict(metric, workloads=[name]))
        else:
            have["workloads"].append(name)
    bench["per_layer"] += list(per_layer)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))


def test_new_cell_from_files_and_an_entry(tmp_path):
    """A cell, a traffic mix and a metric added as new files and entries
    run with no edit to any file that is there."""
    mix = dict(load_cell("tts-batch").traffic,
               text_chars=dict(law="lognormal", median=8, sigma=0.3, min=4, max=16))
    _copy_with(tmp_path, {"traffic/tts-batch-short.json": json.dumps(mix),
                          "metrics/calls.short.py":
                              "def read(run):\n    return float(len(run.calls)) or None\n"},
               [dict(name="tts-batch-short", config="sambert-hifigan-v1",
                     traffic="tts-batch-short", chips=1, why="short texts")],
               [("tts-batch-short", {"name": "audio_s_per_s"})],
               [dict(name="calls.short", unit="calls", better="higher",
                     source="program_counter", layer="one-shot pipeline",
                     moves="audio_s_per_s", workloads=["tts-batch-short"])])
    cell = load_cell("tts-batch-short", tmp_path)
    assert set(cell.readers) == {"calls.short"}
    line, run = run_cell(tiny(cell), SEED, 0.2, False, Context(device="cpu"))
    assert line["correct"] and "audio_s_per_s" in line["metrics"]
    assert cell.readers["calls.short"](run) == len(run.calls)


ONOFF = '''"""On/off bursts: `burst` arrivals `within_s` apart, then an off gap that
keeps the mix's mean rate."""

ORDERED = True


def draw(params, n):
    b, w, rate = params["burst"], params["within_s"], params["rate_per_s"]
    off = b / rate - (b - 1) * w
    return [off if (i + 1) % b == 0 else w for i in range(n)]
'''


def test_new_arrival_law_from_files(tmp_path):
    """A new arrival law (on/off bursts), a mix that names it and a cell run
    with no edit to any file that is there; the law keeps its order."""
    live = load_cell("tts-live").traffic
    mix = dict(live, gaps=dict(law="onoff", burst=4, within_s=0.01))
    _copy_with(tmp_path, {"traffic/laws/onoff.py": ONOFF,
                          "traffic/tts-live-burst.json": json.dumps(mix)},
               [dict(name="tts-live-burst", config="sambert-hifigan-v1",
                     traffic="tts-live-burst", chips=1, why="bursts of four streams")],
               [("tts-live-burst", {"name": "ttfa_p95_ms"})])
    cell = load_cell("tts-live-burst", tmp_path)
    due = [d for d, _ in traffic.arrivals(cell.traffic, SEED, 10.0, cell.laws_dir)]
    gaps = [round(b - a, 6) for a, b in zip(due, due[1:])]
    assert gaps[:4] == [0.01, 0.01, 0.01, round(4 / live["rate_per_s"] - 0.03, 6)]
    line, run = run_cell(tiny(cell), SEED, 0.2, False, Context(device="cpu"))
    assert line["correct"] and "ttfa_p95_ms" in line["metrics"] and run.attempted == 4


DRIVER = '''"""Closed loop of one-shot calls, reported as calls a second."""

from .batch import run as batch_run


def run(cell, seed, seconds, trace, ctx):
    out = batch_run(cell, seed, seconds, trace, ctx)
    out.e2e["calls_per_s"] = len(out.calls) / out.window_s
    return out
'''


def test_new_driver_kind_from_files(tmp_path):
    """A new kind of mix: its driver, a mix of that kind and a cell with a
    new end-to-end metric, added as files and entries alone."""
    mix = dict(load_cell("tts-batch").traffic, kind="calls")
    _copy_with(tmp_path, {"harness/drivers/calls.py": DRIVER,
                          "traffic/tts-calls.json": json.dumps(mix)},
               [dict(name="tts-calls", config="sambert-hifigan-v1", traffic="tts-calls",
                     chips=1, why="calls a second")],
               [("tts-calls", {"name": "calls_per_s", "unit": "calls/s", "better": "higher",
                               "bound": 0.05, "source": "host_clock"})])
    cell = load_cell("tts-calls", tmp_path)
    line, _ = run_cell(tiny(cell), SEED, 0.2, False, Context(device="cpu"))
    assert line["correct"] and set(line["metrics"]) == {"calls_per_s", "setup_s"}
    assert line["metrics"]["calls_per_s"]["value"] > 0


def _has_card() -> bool:
    import torch

    return torch.cuda.is_available()


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_traced_run_on_card(name):
    """A short traced run of every cell on the card (run it there with
    `pytest benchmark/tests -m cuda`)."""
    if not _has_card():
        pytest.skip("needs a CUDA card")
    cell = load_cell(name)
    out = subprocess.run([sys.executable, os.path.join(BENCH_DIR, "run.py"), "--workload",
                          name, "--seed", str(SEED), "--seconds", "5", "--trace", "1"],
                         capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and set(line["metrics"]) == {m["name"] for m in cell.per_layer}
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
