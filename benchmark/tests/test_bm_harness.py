"""The harness on the CPU: every cell resolves and runs end to end at a
tiny size, faults planted under the timed path come out as not correct, a
cell, a law, a kind of mix or a model can be added with files and entries
alone, and no run loads JAX."""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest

import bm_tiny
from bm_tiny import BENCH_DIR, ROOT, tiny
from harness import traffic
from harness import weights as harness_weights
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


def _copy_with(tmp_path, files: dict, workloads: list, end_to_end=(), per_layer=(),
               configs=()):
    """A copy of the benchmark with `files` added and cells, end-to-end
    metrics ((cell, metric): a new metric, or the name of one the cell
    reports too), per-layer metrics and configurations appended."""
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel, text in files.items():
        (tmp_path / "benchmark" / rel).write_text(text)
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"] += workloads
    bench["configs"] += list(configs)
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


SCALED_MODEL = '''"""SAM-BERT and HiFi-GAN with the wav scaled by 2 + a drawn gain, a tensor
of a family the weights module does not know."""

from reference import scaled as ref

from .. import weights as init
from . import sambert_hifigan as base

config, TINY = base.config, base.TINY


def family(name, shape):
    return ("uniform", 0.5) if name == "gain.alpha" else init._family(name, shape)


def weights(c, cfg, seed, device):
    gain = init.make([("gain.alpha", (1,))], seed + 2, device, family)
    return (*base.weights(c, cfg, seed, device), gain)


def pipeline(cfg, W, devices, dtype):
    pipe = base.pipeline(cfg, W[:2], devices, dtype)
    vocode, gain = pipe._vocode, 2.0 + W[2]["gain.alpha"]
    pipe._vocode = lambda mel: vocode(mel) * gain
    return pipe


def reference_batch(W, c, texts, q, device):
    return ref.synthesize_batch(W, c, texts, q, device)


def reference_stream(W, c, texts, chunk, context, q, device):
    return ref.stream_chunks(W, c, texts, chunk, context, q, device)
'''

SCALED_REFERENCE = '''"""The scaled model's reference: SAM-BERT, then HiFi-GAN times 2 + the gain."""

from . import acoustic
from .generator import generator


def _vocode(W, c, q):
    gain = 2.0 + W[2]["gain.alpha"]
    return lambda mel: generator(W[1], "", mel, c, q) * gain


def synthesize_batch(W, c, texts, q, device):
    return acoustic.synthesize_batch(W[0], _vocode(W, c, q), c, texts, q, device)


def stream_chunks(W, c, texts, chunk, context, q, device):
    return acoustic.stream_chunks(W[0], _vocode(W, c, q), c, texts, chunk, context, q, device)
'''

SCALED_RUNS = '''
import dataclasses, json, sys, types
sys.path[:0] = [%r, %r, %r]
import bm_tiny
from harness.core import run_cell
from harness.models import sambert_hifigan
from harness.record import Context
from harness.spec import load_cell

out = {}
for name in ("scaled-batch", "scaled-live"):
    cell = bm_tiny.tiny(load_cell(name, %r))
    assert cell.model.__name__ == "harness.models.scaled" and "gain.alpha" not in cell.config
    for fault in (None, "answer_altered"):
        line, _ = run_cell(cell, %d, 0.2, False, Context(device="cpu", fault=fault))
        out[f"{name} {fault}"] = line["correct"]
    # the program's gain against the reference without it
    plain = types.SimpleNamespace(**dict(vars(cell.model), reference_batch=lambda W, *a:
        sambert_hifigan.reference_batch(W[:2], *a), reference_stream=lambda W, *a:
        sambert_hifigan.reference_stream(W[:2], *a)))
    line, _ = run_cell(dataclasses.replace(cell, model=plain), %d, 0.2, False,
                       Context(device="cpu"))
    out[f"{name} unscaled reference"] = line["correct"]
print(json.dumps(out))
'''


def _digests(directory):
    return {os.path.relpath(os.path.join(d, f), directory):
            hashlib.sha256(open(os.path.join(d, f), "rb").read()).hexdigest()
            for d, dirs, files in os.walk(directory) if "__pycache__" not in d for f in files}


def test_new_model_from_files(tmp_path):
    """A model the harness did not know (SAM-BERT and HiFi-GAN with the wav
    scaled by a gain drawn in a family of its own), its reference, its
    configuration and a one-shot and a live cell, added as files and
    entries alone: both cells run correct, a planted fault and the
    reference without the gain do not, no file that was there changes, an
    unknown model is refused as the cell loads and a one-shot cell whose
    configuration names none as it runs; the vocoder trainer's
    configuration, which names none, comes back as a cell by entries
    alone."""
    files = {"harness/models/scaled.py": SCALED_MODEL, "reference/scaled.py": SCALED_REFERENCE,
             "configs/scaled.json": json.dumps(dict(load_cell("tts-batch").config,
                                                    name="scaled", model="scaled"))}
    assert not any(os.path.exists(os.path.join(BENCH_DIR, f)) for f in files)
    _copy_with(tmp_path, files,
               [dict(name="scaled-batch", config="scaled", traffic="tts-batch", chips=1,
                     why="one-shot calls of the scaled model"),
                dict(name="scaled-live", config="scaled", traffic="tts-live", chips=1,
                     why="live streams of the scaled model")],
               [("scaled-batch", {"name": "audio_s_per_s"}),
                ("scaled-live", {"name": "ttfa_p95_ms"})],
               configs=[dict(name="scaled", source="a test", file="benchmark/configs/scaled.json",
                             reduced=[], why="a model from files")])
    with pytest.raises(TypeError):  # the gain's family is not one weights.py knows
        harness_weights.make([("gain.alpha", (1,))], 1, "cpu")
    copy = tmp_path / "benchmark"
    code = SCALED_RUNS % (str(copy / "tests"), str(copy), ROOT, str(tmp_path), SEED, SEED)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {
        "scaled-batch None": True, "scaled-batch answer_altered": False,
        "scaled-batch unscaled reference": False, "scaled-live None": True,
        "scaled-live answer_altered": False, "scaled-live unscaled reference": False}
    had, now = _digests(BENCH_DIR), _digests(copy)
    assert {f: now.get(f) for f in had} == had

    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    for name, model in (("typo", "scaled_typo"), ("odd", "../scaled"), ("none", None)):
        conf = dict(load_cell("tts-batch").config, name=name, model=model)
        if model is None:
            del conf["model"]
        (copy / "configs" / f"{name}.json").write_text(json.dumps(conf))
        bench["configs"].append(dict(name=name, source="a test", reduced=[], why="refused",
                                     file=f"benchmark/configs/{name}.json"))
        bench["workloads"].append(dict(name=f"{name}-batch", config=name, traffic="tts-batch",
                                       chips=1, why="refused"))
    bench["configs"].append(dict(name="hifigan-v1-gan", source="a test", reduced=[],
                                 why="GAN steps", file="benchmark/configs/hifigan-v1-gan.json"))
    bench["workloads"].append(dict(name="vocoder-train", config="hifigan-v1-gan",
                                   traffic="vocoder-train", chips=1, why="GAN steps"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    for name in ("typo", "odd"):
        with pytest.raises(ValueError, match=r"is not one of \['sambert_hifigan', 'scaled'\]"):
            load_cell(f"{name}-batch", tmp_path)
    unnamed = load_cell("none-batch", tmp_path)
    with pytest.raises(KeyError, match="none-batch names no model"):
        run_cell(unnamed, SEED, 0.2, False, Context(device="cpu"))
    train, parked = load_cell("vocoder-train", tmp_path), bm_tiny.train_cell()
    assert train.model is None
    assert (train.config, train.traffic, train.limits) == (parked.config, parked.traffic,
                                                            parked.limits)


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
