"""Multi-process data parallelism, executed for real: N ranks train on one
global batch and are held against a single-process control.

  python -m sambert_hifigan_tpu_torch.multiprocess_dp [--nproc 2] [--steps 4]
      [--batch-size 8] [--model acoustic|vocoder] [--config small|default]
      [--device cpu|cuda]

The counterpart of the JAX package's `scripts/multiprocess_dp.py`.  The
launcher first trains a single-process control in its own process, then
spawns N worker processes (`--worker`) that join one process group through
a `file://` rendezvous (`parallel/mesh.py:initialize_distributed`), each on
the same device type (all on cuda:0 when the host has fewer cards than
ranks: gloo then, since nccl refuses two ranks on one card).  Each worker
replicates the state from rank 0, builds the same global batch per step,
keeps its rows, trains, and writes its per-step metrics, its step times,
the reduction's share, its peak memory and a digest of its parameters.

The launcher passes when every rank's metrics are within 5e-3 (relative)
of the control's at every step (the JAX script's bound: a sum over the
global batch against a sum of per-rank partial sums rounds differently)
and every rank's digest is equal (bit-equal replicas).  It prints one JSON
summary, then PASS or FAIL, and exits non-zero on FAIL.

A run's `model_parallel` M lays the ranks out as data N/M x model M and
stores each rank's state sharded over the model axis (tensor parallelism):
the ranks of a model group share their rows, so there is no lockstep run;
instead every rank's whole (replicated) leaves must be bit-equal to rank
0's and its slices to those of the first rank of its model index, and the
gathered parameters equal on all.

`--config small` is the JAX script's tiny acoustic model (d_model 32, one
encoder and one decoder layer of 4 heads, FFN 64) and, for the vocoder, the
generator at 32 initial channels with discriminators at 1/16 width;
`default` is the full-width default config; either runs without dropout
and in IEEE float32 (`comparable`; TF32 off in every process).  The acoustic batches are
`synthetic_batch(tph=16, tfrm=64)`, the vocoder's random (mel, wav) pairs
of 32 frames in the config's loss mode (adv_mel_fm), all from seed 0.
Worker output goes to files, not pipes (`run_procs`).

`run_plan` and `launch` are the pieces the tests drive with their own
weights and batches (a plan is a pickle of runs: config, steps, optional
initial state dict and global batches).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple


REL_TOL = 5e-3
CPU_THREADS = 2  # torch threads of a worker on the CPU


def small_config(cfg):
    """The JAX script's tiny_config (acoustic), with a narrow vocoder."""
    from .config import AcousticModelConfig, DecoderConfig, EncoderConfig

    am = AcousticModelConfig(
        d_model=32, encoder=EncoderConfig(n_layers=1, n_heads=4, d_ff=64),
        decoder=DecoderConfig(n_layers=1, n_heads=4, d_ff=64, max_len=128))
    voc = dataclasses.replace(
        cfg.vocoder,
        generator=dataclasses.replace(cfg.vocoder.generator, upsample_initial_channel=32),
        discriminator=dataclasses.replace(cfg.vocoder.discriminator, channel_div=16))
    return dataclasses.replace(cfg, acoustic_model=am, vocoder=voc)


def comparable(cfg):
    """`cfg` as a run against one process is held: every dropout at 0 and
    both stages in float32.  The ranks fold their rank into the dropout
    seed (shards must not share masks), so N ranks draw other masks than
    one process; and bf16 rounds at ~4e-3, within reach of the 5e-3 bound,
    where two batch sizes pick different convolution algorithms."""
    am = cfg.acoustic_model
    am = dataclasses.replace(
        am, dropout=0.0, encoder=dataclasses.replace(am.encoder, dropout=0.0),
        decoder=dataclasses.replace(am.decoder, dropout=0.0),
        variance_adaptor=dataclasses.replace(am.variance_adaptor, predictor_dropout=0.0))
    tr = cfg.training
    tr = dataclasses.replace(
        tr, acoustic=dataclasses.replace(tr.acoustic, mixed_precision=False),
        vocoder=dataclasses.replace(tr.vocoder, mixed_precision=False))
    return dataclasses.replace(cfg, acoustic_model=am, training=tr)


def make_run(model: str, cfg, steps: int, batch_size: int, seed: int = 0, **kw) -> dict:
    """One run of a plan.  kw: tph, tfrm (acoustic), segment_frames,
    loss_mode (vocoder), init (a state dict of the model, or of HiFiGAN),
    batches (the global batches, one per step), scheduled_sampling (one p
    per step), local_digests (record a digest of each all_reduce_'s input),
    lockstep (rank 0 also runs each step as one process, from a copy of the
    state it is about to step, on the whole global batch), params (return
    the trained model's state dict, on the host), control_steps (the steps
    held to the control's trajectory; default `gated_steps`), model_parallel
    (the model axis's size in a process group: the state is stored sharded
    over it, and the ranks of a model group share their rows; a run in one
    process, the control, trains whole; no lockstep above 1), deterministic
    (cuDNN's deterministic algorithms and torch's deterministic mode, warn
    only: the ops that have no deterministic form are reported, by their
    warnings, in the result's `nondeterministic`)."""
    run = dict(model=model, cfg=cfg, steps=steps, batch_size=batch_size, seed=seed, tph=16,
               tfrm=64, segment_frames=32, loss_mode=None, init=None, batches=None,
               scheduled_sampling=None, local_digests=False, lockstep=True, params=False,
               control_steps=None, model_parallel=1, deterministic=False)
    unknown = set(kw) - set(run)
    if unknown:
        raise TypeError(f"unknown run options: {sorted(unknown)}")
    run.update(kw)
    return run


def _digests_of_reductions(record: List[str]):
    """Wrap mesh.all_reduce_ so each call's input digest lands in `record`."""
    from .parallel import mesh

    inner = mesh.all_reduce_

    def spy(tensors):
        tensors = list(tensors)
        h = hashlib.sha256()
        for t in tensors:
            h.update(t.detach().float().cpu().numpy().tobytes())
        record.append(h.hexdigest())
        return inner(tensors)

    return inner, spy


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def _tp_digests(state) -> Tuple[str, str]:
    """(digest of what this rank holds whole, digest of its slices) of a
    sharded state: its parameters, their Adam moments, its EMA copies and
    its buffers (spectral u, v: whole)."""
    whole, sliced = list(state.model.buffers()), []
    for opt, ema in state.parts():
        emas = [None] * len(opt.params) if ema is None else list(ema.parameters())
        for p, e, d in zip(opt.params, emas, opt.dims):
            st = opt.adamw.state.get(p, {})
            held = [p] + [st[k] for k in ("exp_avg", "exp_avg_sq") if k in st] + \
                ([] if e is None else [e])
            (whole if d is None else sliced).extend(held)
    return _digest(whole), _digest(sliced)


def _whole_params(state) -> Dict:
    """The model's whole state dict (gathered where sharded: a collective)."""
    payload = state.state_dict()
    if "model" in payload:
        return payload["model"]
    return {f"{m}.{k}": v for m in ("generator", "msd", "mpd") for k, v in payload[m].items()}


@contextlib.contextmanager
def _deterministic(on: bool):
    """torch's deterministic mode (warn only) and cuDNN's deterministic
    algorithms inside, when `on`; yields the set of the warnings of ops
    without a deterministic form."""
    import warnings

    import torch

    found: set = set()
    if not on:
        yield found
        return
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(), torch.backends.cudnn.deterministic)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield found
        found.update(str(w.message)[:160] for w in caught
                     if "deterministic" in str(w.message))
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        torch.backends.cudnn.deterministic = prev[2]


def _single_process_step(train, state, i: int, rng) -> Dict[str, float]:
    """Step `i` as one process on the whole global batch, from a copy of
    `state` (and of the host generator); `state` is left as it was."""
    import copy

    import torch

    from .parallel import mesh
    from .training.metrics import to_host

    twin = copy.deepcopy(state)
    gen = None
    if rng is not None:
        gen = torch.Generator()
        gen.set_state(rng.get_state())
    with mesh.local():
        metrics = to_host(train(twin, i, gen))
    del twin
    return metrics


def execute(run: dict, device) -> dict:
    """Train one run in the current process group (or none) on `device`;
    returns its history and the rank's measurements."""
    import torch

    from .data.dataset import batch_to_device, synthetic_batch, to_device
    from .parallel import mesh
    from .pipeline import _ieee_f32
    from .training.metrics import to_host
    from .training.train_state import persistent_numel

    cfg, steps, seed = run["cfg"], run["steps"], run["seed"]
    tp = run["model_parallel"] if mesh.is_distributed() else 1
    mesh.set_model_parallel(tp)
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    if run["model"] == "acoustic":
        from .training.acoustic_trainer import init_acoustic_state, make_acoustic_step
        from .weights import random_acoustic_model

        model = random_acoustic_model(cfg, torch.Generator().manual_seed(seed))
        if run["init"] is not None:
            model.load_state_dict(run["init"])
        state = init_acoustic_state(model.to(device), cfg)
        step_fn = make_acoustic_step(cfg)
        rng = torch.Generator().manual_seed(seed + 1)
        batches = run["batches"] or [
            synthetic_batch(cfg, run["batch_size"], tph=run["tph"], tfrm=run["tfrm"],
                            seed=seed + i) for i in range(steps)]
        ss = run["scheduled_sampling"]

        def train(st, i, gen):
            kw = {} if ss is None else {"scheduled_sampling": ss[i]}
            return step_fn(st, batch_to_device(mesh.shard_batch(batches[i]), device), gen, **kw)
    elif run["model"] == "vocoder":
        from .train_vocoder import synthetic_pairs
        from .training.vocoder_trainer import init_vocoder_state, make_vocoder_step

        state = init_vocoder_state(cfg, torch.Generator().manual_seed(seed), device)
        if run["init"] is not None:
            state.model.load_state_dict(run["init"])
        step_fn = make_vocoder_step(cfg, loss_mode=run["loss_mode"])
        pairs = run["batches"]
        if pairs is None:
            source = synthetic_pairs(run["batch_size"], run["segment_frames"],
                                     cfg.audio.hop_length, cfg.audio.n_mels, seed)
            pairs = [next(source) for _ in range(steps)]
        rng = None  # the vocoder step draws nothing

        def train(st, i, gen):
            mel, wav = (to_device(a, device) for a in mesh.shard_batch(pairs[i]))
            return step_fn(st, mel, wav)
    else:
        raise ValueError(f"unknown model {run['model']!r}")

    mesh.replicate(state)
    if tp > 1:
        state.shard_()
    record: List[str] = []
    inner = None
    if run["local_digests"]:
        inner, mesh.all_reduce_ = _digests_of_reductions(record)
    for stats in (mesh.reduce_stats, mesh.gather_stats):
        stats.update(calls=0, seconds=0.0, bytes=0, sync=cuda)
    history, step_ms, reduce_ms, gather_ms, lockstep = [], [], [], [], []
    try:
        # TF32 off: every process computes the same arithmetic
        with _ieee_f32(), _deterministic(run["deterministic"]) as nondeterministic:
            for i in range(steps):
                if run["lockstep"] and tp == 1 and mesh.is_distributed() and mesh.is_main():
                    lockstep.append(_single_process_step(train, state, i, rng))
                if cuda:
                    torch.cuda.synchronize(device)
                mesh.barrier()  # every rank starts the timed step together
                t0, r0 = time.perf_counter(), mesh.reduce_stats["seconds"]
                g0 = mesh.gather_stats["seconds"]
                metrics = train(state, i, rng)
                if cuda:
                    torch.cuda.synchronize(device)
                step_ms.append((time.perf_counter() - t0) * 1e3)
                reduce_ms.append((mesh.reduce_stats["seconds"] - r0) * 1e3)
                gather_ms.append((mesh.gather_stats["seconds"] - g0) * 1e3)
                history.append(to_host(metrics))
    finally:
        if inner is not None:
            mesh.all_reduce_ = inner
    stats, gathered = dict(mesh.reduce_stats), dict(mesh.gather_stats)
    numel = persistent_numel(state)
    if tp > 1:
        whole_digest, shard_digest = _tp_digests(state)
        params = _whole_params(state)  # every rank gathers
        digest = _digest(params.values())
    else:
        whole_digest = shard_digest = None
        params = state.model.state_dict()
        digest = mesh.params_digest(state)
    return dict(
        history=history, step_ms=step_ms, reduce_ms=reduce_ms, gather_ms=gather_ms,
        digest=digest, whole_digest=whole_digest, shard_digest=shard_digest,
        persistent_numel=numel, model_parallel=tp,
        reduce_calls=stats["calls"], reduce_mb_per_step=stats["bytes"] / 1e6 / steps,
        gather_calls=gathered["calls"], gather_mb_per_step=gathered["bytes"] / 1e6 / steps,
        params={k: v.detach().cpu().clone() for k, v in params.items()}
        if run["params"] else None,
        peak_mib=torch.cuda.max_memory_allocated(device) / 2 ** 20 if cuda else None,
        lockstep=lockstep, local_digests=record, rank=mesh.rank(), world=mesh.world_size(),
        device=str(device), nondeterministic=sorted(nondeterministic))


def run_plan(runs: List[dict], device) -> List[dict]:
    return [execute(run, device) for run in runs]


# ---- worker -------------------------------------------------------------------


def worker_main(args) -> int:
    import torch

    from .parallel import mesh

    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", args.rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    mesh.initialize_distributed(args.init_method, world_size=args.world, rank=args.rank,
                                device=device, local_world_size=args.world)
    try:
        with open(args.plan, "rb") as f:
            runs = pickle.load(f)
        results = run_plan(runs, device)
        with open(args.out, "wb") as f:
            pickle.dump(results, f)
    finally:
        mesh.destroy()
    return 0


# ---- launcher -----------------------------------------------------------------

REPO = Path(__file__).resolve().parent.parent
# a process group's variables, which a child of a rank must not inherit
DIST_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def clean_env(**extra) -> Dict[str, str]:
    """This process's environment without a process group's variables, gloo
    on the loopback interface, and `extra` on top."""
    env = {k: v for k, v in os.environ.items() if k not in DIST_ENV}
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")  # rendezvous and collectives over loopback
    env.update(extra)
    return env


def run_procs(cmds: List[List[str]], logs: List[Path], timeout: float,
              env: Optional[Dict[str, str]] = None) -> List[Tuple[int, str]]:
    """Start every command at once from the repo's root (`env` default
    `clean_env()`), each one's output to its log file, and wait for all;
    returns [(return code, output)].  Files, not pipes: a process blocked on
    a full unread pipe in the middle of a collective would stall its peers.
    What outlives `timeout` is killed (-9): no process outlives the call."""
    env = clean_env() if env is None else env
    procs = []
    try:
        for cmd, log in zip(cmds, logs):
            with open(log, "w") as f:
                procs.append(subprocess.Popen(cmd, cwd=REPO, env=env, stdout=f,
                                              stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, Path(log).read_text()) for p, log in zip(procs, logs)]


def launch(runs: List[dict], nproc: int, device: str, workdir: Path,
           timeout: float = 600.0) -> List[List[dict]]:
    """Spawn `nproc` workers on the plan and return each rank's results;
    raises RuntimeError (with every worker's output) if any fails.  No
    worker outlives the call."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    plan = workdir / "plan.pkl"
    with open(plan, "wb") as f:
        pickle.dump(runs, f)
    rdv = workdir / "rendezvous"
    rdv.unlink(missing_ok=True)
    env = clean_env(**({"OMP_NUM_THREADS": str(CPU_THREADS)} if device == "cpu" else {}))
    cmds = [[sys.executable, "-m", "sambert_hifigan_tpu_torch.multiprocess_dp", "--worker",
             "--plan", str(plan), "--rank", str(r), "--world", str(nproc),
             "--init-method", f"file://{rdv}", "--device", device,
             "--out", str(workdir / f"rank{r}.pkl")] for r in range(nproc)]
    outs = run_procs(cmds, [workdir / f"rank{r}.log" for r in range(nproc)], timeout, env)
    if any(rc for rc, _ in outs):
        raise RuntimeError("worker failed: " + "\n".join(
            f"--- rank {r} (rc={rc}) ---\n{out[-4000:]}" for r, (rc, out) in enumerate(outs)))
    results = []
    for r in range(nproc):
        with open(workdir / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


def departures(ours: Dict[str, float], theirs: Dict[str, float]) -> Dict[str, float]:
    return {k: abs(ours[k] - v) / (abs(v) + 1e-9) for k, v in theirs.items()}


def gated_steps(run: dict) -> int:
    """The steps of the control's trajectory held to REL_TOL: every one for
    the acoustic model; the first for the vocoder, whose trajectories part
    after it (Adam's first updates are ~lr sign(g), and the GAN's many
    gradients near zero flip sign between two reduction orders: measured
    ~1% on the losses by the third step, tiny config on the CPU), unless
    the run's `control_steps` says otherwise.  Every step of every run is
    held by the lockstep check besides."""
    if run["control_steps"] is not None:
        return run["control_steps"]
    return run["steps"] if run["model"] == "acoustic" else 1


def compare(runs: List[dict], control: List[dict], ranks: List[List[dict]],
            rel: float = REL_TOL) -> Tuple[List[str], List[List[float]]]:
    """(every mismatch, the control's largest departure per run and step).
    A mismatch is a metric of a rank beyond `rel` of the control's at a
    gated step, a distributed step beyond `rel` of rank 0's lockstep
    single-process step, or a rank whose (whole) parameters differ from
    rank 0's; with a model axis, also a rank whose whole leaves differ from
    rank 0's or whose slices differ from those of the first rank of its
    model index."""
    bad, worst = [], []
    for i, (run, c) in enumerate(zip(runs, control)):
        m = ranks[0][i]["model_parallel"]
        for r, res in enumerate(ranks[1:], 1):
            if m > 1 and res[i]["whole_digest"] != ranks[0][i]["whole_digest"]:
                bad.append(f"run {i}: rank {r}'s whole leaves differ from rank 0's")
            if m > 1 and res[i]["shard_digest"] != ranks[r % m][i]["shard_digest"]:
                bad.append(f"run {i}: rank {r}'s slices differ from rank {r % m}'s")
        worst.append([])
        for r, res in enumerate(ranks):
            d = res[i]
            for step, (md, mc) in enumerate(zip(d["history"], c["history"])):
                dep = departures(md, mc)
                if r == 0:
                    worst[i].append(max(dep.values()))
                if step < gated_steps(run):
                    bad += [f"run {i} rank {r} step {step} {k}: {md[k]} vs control {mc[k]}"
                            for k, v in dep.items() if v > rel]
            if d["digest"] != ranks[0][i]["digest"]:
                bad.append(f"run {i}: rank {r}'s parameters differ from rank 0's")
        lock = ranks[0][i]["lockstep"]
        if run["lockstep"] and m == 1 and len(lock) != run["steps"]:
            bad.append(f"run {i}: {len(lock)} lockstep steps of {run['steps']}")
        for step, (md, ml) in enumerate(zip(ranks[0][i]["history"], lock)):
            bad += [f"run {i} step {step} {k}: {md[k]} vs the same step in one process {ml[k]}"
                    for k, v in departures(md, ml).items() if v > rel]
    return bad, worst


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--nproc", type=int, default=2)
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--model", choices=["acoustic", "vocoder"], default="acoustic")
    p.add_argument("--config", choices=["small", "default"], default="small")
    p.add_argument("--device", type=str, default=None,
                   help="cpu or cuda (default: cuda); every rank on this device type")
    # worker mode (spawned by the launcher)
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--plan", type=str, help=argparse.SUPPRESS)
    p.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    p.add_argument("--world", type=int, help=argparse.SUPPRESS)
    p.add_argument("--init-method", type=str, help=argparse.SUPPRESS)
    p.add_argument("--out", type=str, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def launcher_main(args) -> Dict:
    """Control, workers, comparison; returns the summary (with "match")."""
    from .config import default_config
    from .kernels import resolve_device

    device = resolve_device(args.device)
    cfg = default_config()
    cfg = comparable(small_config(cfg) if args.config == "small" else cfg)
    run = make_run(args.model, cfg, args.steps, args.batch_size)
    control = run_plan([run], device)
    with tempfile.TemporaryDirectory() as tmp:
        ranks = launch([run], args.nproc, device.type, Path(tmp))
    bad, worst = compare([run], control, ranks)
    for line in bad:
        print("MISMATCH " + line)
    last = ranks[0][0]
    return {
        "model": args.model, "config": args.config, "nproc": args.nproc,
        "steps": args.steps, "global_batch": args.batch_size, "device": device.type,
        "final_dist": last["history"][-1], "final_control": control[0]["history"][-1],
        "control_departure": worst[0], "control_gated_steps": gated_steps(run),
        "lockstep_departure": [max(departures(d, l).values())
                               for d, l in zip(last["history"], last["lockstep"])],
        "step_ms": [r[0]["step_ms"] for r in ranks], "control_step_ms": control[0]["step_ms"],
        "reduce_ms": [r[0]["reduce_ms"] for r in ranks],
        "reduce_mb_per_step": last["reduce_mb_per_step"],
        "peak_mib": [r[0]["peak_mib"] for r in ranks], "control_peak_mib": control[0]["peak_mib"],
        "replicas_equal": len({r[0]["digest"] for r in ranks}) == 1,
        "match": not bad,
    }


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.worker:
        return worker_main(args)
    summary = launcher_main(args)
    print(json.dumps(summary))
    print("PASS" if summary["match"] else "FAIL")
    return 0 if summary["match"] else 1


if __name__ == "__main__":
    sys.exit(main())
