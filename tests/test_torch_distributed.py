"""Data parallelism across processes (parallel/mesh.py, the trainers in a
process group, `multiprocess_dp`) against one process and against the JAX
step on a 2-device mesh, float32 on the CPU with gloo, 2 ranks.

The parent process builds the JAX states and writes the port's initial
state dicts and the global batches into a plan (`multiprocess_dp.launch`);
the ranks load them and import no JAX.  Every dropout is 0 (the ranks fold
their rank into the dropout seed, so their masks are not one process's).
The acoustic batches are the tiny model's (tests/test_torch_acoustic_model.py)
at B = 4 global, 2 rows a rank, whose rank-0 rows hold ~4x the valid
frames of rank 1's, so that per-rank means, averaged, are not the global
mean (asserted).

Bounds: every metric of every step within 5e-3 (relative) of the
single-process control's and of the JAX mesh step's, and within 5e-3 of
rank 0's own single-process run of the same step from the same state
(lockstep); for the vocoder the trajectories are compared at the first
step only (later steps part at the GAN's sign-flipped near-zero gradients,
multiprocess_dp.gated_steps) and the lockstep holds every step.
Parameters after one applied update: within 1e-5 wherever the gradient is
above 1e-5 of its global norm, and within 2 lr everywhere, against the
control and JAX (the convention of tests/test_torch_*_train.py); every
rank's parameters are bit-equal.  The trainers' command lines run under
torchrun; rank 0 alone writes checkpoints and metrics; a SIGTERM to one
rank stops both at the same step.
"""

# bind the stdlib `profile` before a test puts scripts/ (and its profile.py) on
# sys.path: torch.optim imports torch._dynamo, and so cProfile, at first use
import cProfile  # noqa: F401
import dataclasses
import json
import signal
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sambert_hifigan_tpu.parallel.mesh import create_mesh
from sambert_hifigan_tpu.training.acoustic_trainer import make_jitted_acoustic_step
from sambert_hifigan_tpu.training.vocoder_trainer import make_jitted_vocoder_step

from sambert_hifigan_tpu_torch import config as pcfg
from sambert_hifigan_tpu_torch import multiprocess_dp as mp
from sambert_hifigan_tpu_torch.data.dataset import batch_to_device
from sambert_hifigan_tpu_torch.losses.acoustic import acoustic_loss
from sambert_hifigan_tpu_torch.models.layers import draw_seed
from sambert_hifigan_tpu_torch.training.acoustic_trainer import sampling_mask
from sambert_hifigan_tpu_torch.training.checkpoint import CheckpointManager
from tests.test_torch_acoustic_model import make_batch
from tests.test_torch_acoustic_train import Pair as AcousticPair
from tests.test_torch_acoustic_train import assert_params_match
from tests.test_torch_discriminators import one_torch_thread  # noqa: F401 (a fixture)
from tests.test_torch_vocoder_train import Pair as VocoderPair
from tests.test_torch_vocoder_train import assert_params_match as assert_vocoder_params_match
from tests.test_torch_vocoder_train import batches as vocoder_batches

REPO = Path(__file__).resolve().parent.parent
REL = 5e-3
SEED = 1  # the pairs' host generator seed; a plan run's is seed + 1
SS = [0.0, 0.5, 0.0]  # scheduled sampling of the three acoustic steps
VALID = (8, 8, 2, 2)  # valid phonemes a row, 5 frames each: rank 0's rows hold 4x the frames
TIMEOUT = 240


def _env():
    return mp.clean_env(OMP_NUM_THREADS="1")


def _mesh2():
    return create_mesh(data=2, devices=jax.devices()[:2])


def _acoustic_batches(cfg):
    batches = [make_batch(cfg, b=4, seed=20 + i, valid=VALID) for i in range(3)]
    for b in batches:
        b["dur_gt"] = (5 * b["phoneme_mask"]).astype(np.int32)
    return batches


def _sampling_seed(step):
    """The sampling seed the port's step `step` draws from the host
    generator (two draws a step: dropout, then sampling)."""
    gen = torch.Generator().manual_seed(SEED)
    for _ in range(2 * step + 1):
        draw_seed(gen)
    return draw_seed(gen)


def _host(metrics):
    return {k: float(v) for k, v in jax.device_get(metrics).items()}


def _close(ours, theirs, what):
    for k, v in theirs.items():
        assert abs(ours[k] - v) <= REL * max(abs(v), 1e-8), (what, k, ours[k], v)


class Acoustic:
    """The JAX step on a 2-device mesh and the port's control (one process,
    the gradients it applied recorded) from the same weights, over the
    three steps (`reference`); `stage` overrides training.acoustic."""

    def __init__(self, **stage):
        self.pair = pair = AcousticPair(seed=SEED, **stage)
        self.init = {k: v.clone() for k, v in pair.state_p.model.state_dict().items()}
        self.batches = _acoustic_batches(pair.cfg_p)
        self.ss = SS if not stage else [0.0] * 3
        self.run = mp.make_run("acoustic", pair.cfg_p, 3, 4, seed=SEED - 1, init=self.init,
                               batches=self.batches, scheduled_sampling=self.ss, params=True)

    def reference(self, monkeypatch):
        pair, mesh = self.pair, _mesh2()
        self.jax, self.control = [], []
        steps_j = {}
        for i, (batch, p) in enumerate(zip(self.batches, self.ss)):
            if p not in steps_j:
                tr = dataclasses.replace(pair.cfg_j.training.acoustic, scheduled_sampling=p)
                cfg_j = dataclasses.replace(pair.cfg_j, training=dataclasses.replace(
                    pair.cfg_j.training, acoustic=tr))
                steps_j[p] = make_jitted_acoustic_step(pair.model_j, cfg_j, mesh=mesh)
            if p > 0:  # JAX draws its own Bernoulli mask (at trace time): give it the port's
                mask = sampling_mask(_sampling_seed(i), batch["mel_gt"].shape, p, "cpu")
                monkeypatch.setattr(jax.random, "bernoulli",
                                    lambda key, prob, shape: jnp.asarray(mask.numpy()))
            step_j = steps_j[p]
            pair.state_j, mj = step_j(jax.tree.map(jnp.array, pair.state_j),
                                      {k: jnp.asarray(v) for k, v in batch.items()},
                                      jax.random.PRNGKey(1))
            monkeypatch.undo()
            self.jax.append(_host(mj))
            mp_ = pair.step_p(pair.state_p, batch_to_device(batch, "cpu"), pair.rng,
                              scheduled_sampling=p)
            self.control.append({k: float(v) for k, v in mp_.items()})


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """Every scenario's JAX and control side, and one 2-rank launch of all
    their runs (plus the dropout probes), which runs while this process
    computes the JAX and control sides."""
    plain, accum = Acoustic(), Acoustic(accumulate_steps=2)
    voc = VocoderPair(spectral=True, seed=3)
    voc_init = {k: v.clone() for k, v in voc.state_p.model.state_dict().items()}
    (_, pair_batch), = vocoder_batches(1, seed=4)
    mel, wav = (np.concatenate([a, a[::-1] * 0.5]) for a in pair_batch)  # B = 4 global
    voc_run = mp.make_run("vocoder", voc.cfg_p, 2, 4, seed=SEED - 1, init=voc_init,
                          batches=[(mel, wav), (mel[::-1].copy(), wav[::-1].copy())],
                          params=True, loss_mode="adv_mel_fm")
    voc_run1 = dict(voc_run, steps=1, lockstep=False)
    # dropout probes: the same rows on both ranks, dropout 0.1 and 0
    probes = []
    for rate in (0.1, 0.0):
        from tests.test_torch_acoustic_model import acoustic_cfg

        cfg = acoustic_cfg(pcfg, dropout=rate)
        rows = make_batch(cfg, b=2, seed=30)
        twice = {k: np.concatenate([v, v]) for k, v in rows.items()}
        probes.append(mp.make_run("acoustic", cfg, 1, 4, seed=5, batches=[twice],
                                  local_digests=True, lockstep=False))
    with ThreadPoolExecutor(1) as pool:
        launched = pool.submit(mp.launch, [plain.run, accum.run, voc_run, voc_run1] + probes,
                               2, "cpu", tmp_path_factory.mktemp("dp"), timeout=TIMEOUT)
        with pytest.MonkeyPatch.context() as monkeypatch:
            plain.reference(monkeypatch)
            accum.reference(monkeypatch)
        step_j = make_jitted_vocoder_step(voc.model_j, voc.cfg_j, mesh=_mesh2(),
                                          loss_mode="adv_mel_fm")
        voc.state_j, mj = step_j(jax.tree.map(jnp.array, voc.state_j), mel, wav)
        voc_jax = _host(mj)
        voc_control = {k: float(v) for k, v in voc.step_p(voc.state_p, torch.from_numpy(mel),
                                                           torch.from_numpy(wav)).items()}
        ranks = launched.result()
    return dict(plain=plain, accum=accum, voc=voc, voc_jax=voc_jax, voc_control=voc_control,
                ranks=ranks)


def test_the_shards_differ_in_valid_frames(dp):
    """Rank 0's rows hold 4x rank 1's valid frames, and the mean of the two
    ranks' own masked means misses the global mean by more than the bound:
    the global denominators are what the test holds."""
    pair = dp["plain"].pair
    from sambert_hifigan_tpu_torch.models.acoustic_model import SAMBERTAcousticModel

    model = SAMBERTAcousticModel(pair.cfg_p.acoustic_model)
    model.load_state_dict(dp["plain"].init)
    batch = batch_to_device(dp["plain"].batches[0], "cpu")

    def losses(rows):
        b = {k: v[rows] for k, v in batch.items()}
        with torch.no_grad():
            out = model(b["ph_ids"], b["tone_ids"], b["boundary_ids"], b["mel_gt"], b["dur_gt"],
                        b["pitch_gt"], b["energy_gt"], b["phoneme_mask"])
        p = out.predictions
        _, m = acoustic_loss(out.mel_pred, b["mel_gt"], p["log_dur_pred"], b["dur_gt"],
                             p["pitch_frm"], b["pitch_gt"], p["energy_frm"], b["energy_gt"],
                             out.frame_mask, b["phoneme_mask"], b["pitch_mask"])
        return {k: float(v) for k, v in m.items()}, int(out.frame_mask.sum())

    full, _ = losses(slice(0, 4))
    (r0, f0), (r1, f1) = losses(slice(0, 2)), losses(slice(2, 4))
    assert 3.0 <= f0 / f1 <= 5.0, (f0, f1)
    averaged = {k: (r0[k] + r1[k]) / 2 for k in full}
    assert max(abs(averaged[k] - v) / abs(v) for k, v in full.items()) > 10 * REL


@pytest.mark.parametrize("name", ["plain", "accum"],
                         ids=["teacher-forcing-then-sampling-0.5", "accumulate-2"])
def test_acoustic_steps_match_control_and_jax_mesh(dp, name):
    """Three steps (teacher forcing, scheduled sampling 0.5, teacher
    forcing; or accumulation over 2 micro-steps): every metric against the
    single-process control, the JAX step on a 2-device mesh and the
    lockstep, on both ranks."""
    case = dp[name]
    idx = ["plain", "accum"].index(name)
    for r, res in enumerate(dp["ranks"]):
        hist = res[idx]["history"]
        assert len(hist) == 3
        for step in range(3):
            _close(hist[step], case.control[step], f"rank {r} step {step} vs control")
            _close(hist[step], case.jax[step], f"rank {r} step {step} vs JAX mesh")
    lock = dp["ranks"][0][idx]["lockstep"]
    assert len(lock) == 3
    for step in range(3):
        _close(dp["ranks"][0][idx]["history"][step], lock[step], f"step {step} vs lockstep")


def test_acoustic_parameters_match_and_replicas_are_bit_equal(dp):
    """After the accumulated run (one applied update): every rank's
    parameters bit-equal, and within the bounds of the control and of JAX."""
    case = dp["accum"]
    ranks = [res[1] for res in dp["ranks"]]
    assert ranks[0]["digest"] == ranks[1]["digest"]
    for a, b in zip(ranks[0]["params"].values(), ranks[1]["params"].values()):
        assert torch.equal(a, b)
    ours = {k: v.numpy() for k, v in ranks[0]["params"].items()}
    grads = case.pair.applied_grads()
    control = {k: v.detach().numpy() for k, v in case.pair.state_p.model.state_dict().items()}
    assert_params_match(ours, control, grads, case.pair.lr)
    assert_params_match(ours, case.pair.jax_state_dict(), grads, case.pair.lr)
    assert dp["ranks"][0][0]["digest"] == dp["ranks"][1][0]["digest"]


def test_vocoder_step_matches_control_and_jax_mesh(dp):
    """adv_mel_fm with spectral norm: the first step's metrics against the
    control and the JAX mesh step, both steps against the lockstep, and
    the replicas (with their u, v) bit-equal after both."""
    res0, res1 = dp["ranks"][0][2], dp["ranks"][1][2]
    for res in (res0, res1):
        _close(res["history"][0], dp["voc_control"], "vocoder vs control")
        _close(res["history"][0], dp["voc_jax"], "vocoder vs JAX mesh")
    assert len(res0["lockstep"]) == 2
    for step in range(2):
        _close(res0["history"][step], res0["lockstep"][step], f"vocoder step {step} lockstep")
    assert res0["digest"] == res1["digest"]
    for a, b in zip(res0["params"].values(), res1["params"].values()):
        assert torch.equal(a, b)


def test_vocoder_parameters_after_one_step_match(dp):
    """After one 2-rank vocoder step from the same weights: the parameters
    (and the spectral u, v) within the bounds of the control's and JAX's,
    and bit-equal on both ranks."""
    voc = dp["voc"]
    res0, res1 = dp["ranks"][0][3], dp["ranks"][1][3]
    ours = {k: v.numpy() for k, v in res0["params"].items()}
    grads = voc.applied_grads()
    control = {k: v.detach().numpy() for k, v in voc.state_p.model.state_dict().items()}
    assert_vocoder_params_match(ours, control, grads, voc.lrs())
    assert_vocoder_params_match(ours, voc.jax_state_dict(), grads, voc.lrs())
    assert res0["digest"] == res1["digest"]


def test_dropout_masks_differ_between_ranks(dp):
    """Both ranks hold the same rows: at dropout 0.1 their gradients before
    the reduction differ (each rank folds its rank into the seed), at 0
    they are bit-equal; the loss-count reduction's input is equal in both."""
    (r0_drop, r0_plain), (r1_drop, r1_plain) = ([res[4], res[5]] for res in dp["ranks"])
    counts0, grads0 = r0_drop["local_digests"]
    counts1, grads1 = r1_drop["local_digests"]
    assert counts0 == counts1 and grads0 != grads1
    assert r0_plain["local_digests"] == r1_plain["local_digests"]


# ---- the command lines -------------------------------------------------------------


def _tiny_yaml(path):
    import yaml

    path.write_text(yaml.safe_dump({
        "acoustic_model": {"d_model": 32, "encoder": {"n_layers": 1, "n_heads": 2, "d_ff": 64},
                           "decoder": {"n_layers": 1, "n_heads": 2, "d_ff": 64}},
        "vocoder": {"generator": {"upsample_initial_channel": 32,
                                  "resblock_kernel_sizes": [3],
                                  "resblock_dilation_sizes": [[1, 3]]},
                    "discriminator": {"channel_div": 16}}}))
    return str(path)


def _torchrun(runs, tmp_path):
    """`torch.distributed.run --standalone --nproc-per-node 2` of each
    (module, args, name) at once; [(return code, output)]."""
    return mp.run_procs(
        [[sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
          "2", "-m", f"sambert_hifigan_tpu_torch.{module}", *args] for module, args, _ in runs],
        [tmp_path / f"{name}.log" for _, _, name in runs], TIMEOUT, _env())


def test_torchrun_trainers_checkpoint_and_resume(tmp_path):
    """`torch.distributed.run --nproc-per-node 2` of train_acoustic and
    train_vocoder (side by side) on the CPU exit 0; rank 0 alone writes the
    checkpoint and the metrics; a 2-rank --resume continues from the
    checkpoint."""
    yml = _tiny_yaml(tmp_path / "tiny.yaml")
    ck, logs = tmp_path / "ck", tmp_path / "logs"
    common = ["--device", "cpu", "--model-config", yml, "--batch-size", "4",
              "--checkpoint-dir", str(ck), "--log-dir", str(logs)]
    (rc, out), (rc_v, out_v) = _torchrun([
        ("train_acoustic", ["--synthetic", "2", *common], "a"),
        ("train_vocoder", ["--synthetic", "2", "--segment-frames", "8", "--device", "cpu",
                           "--model-config", yml, "--batch-size", "4", "--checkpoint-dir",
                           str(tmp_path / "voc"), "--log-dir", str(logs)], "v")], tmp_path)
    assert rc == 0, out
    assert "backend gloo" in out and out.count("done at step 2") == 2
    assert CheckpointManager(ck, pcfg.AudioConfig()).all_steps() == [2]
    assert (logs / "acoustic_metrics.jsonl").read_text().count("\n") == 1  # one writer
    assert rc_v == 0, out_v
    assert out_v.count("done at step 2") == 2
    assert CheckpointManager(tmp_path / "voc", pcfg.AudioConfig()).all_steps() == [2]
    (rc, out), = _torchrun([("train_acoustic", ["--synthetic", "3", "--resume", *common], "b")],
                           tmp_path)
    assert rc == 0, out
    assert out.count("resumed from step 2") == 2 and out.count("done at step 3") == 2
    assert CheckpointManager(ck, pcfg.AudioConfig()).all_steps() == [2, 3]


def test_sigterm_to_one_rank_stops_both_at_the_same_step(tmp_path):
    """Two ranks of train_acoustic (WORLD_SIZE, RANK and a file://
    rendezvous); SIGTERM to rank 1 alone: both finish the same step, rank 0
    saves a checkpoint there, both exit 0, and the checkpoint restores."""
    yml = _tiny_yaml(tmp_path / "tiny.yaml")
    ck = tmp_path / "ck"
    args = ["--synthetic", "100000", "--device", "cpu", "--model-config", yml, "--batch-size",
            "4", "--checkpoint-dir", str(ck), "--log-dir", str(tmp_path / "logs"),
            "--dist-init-method", f"file://{tmp_path / 'rdv'}"]
    logs = [tmp_path / f"rank{r}.log" for r in range(2)]
    procs = []
    try:
        for r in range(2):
            with open(logs[r], "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "sambert_hifigan_tpu_torch.train_acoustic", *args],
                    cwd=REPO, env=dict(_env(), WORLD_SIZE="2", RANK=str(r)), stdout=f,
                    stderr=subprocess.STDOUT))
        deadline = time.monotonic() + TIMEOUT
        while not all("first batch" in log.read_text() for log in logs):
            assert time.monotonic() < deadline and all(p.poll() is None for p in procs), \
                [log.read_text() for log in logs]
            time.sleep(0.2)
        time.sleep(1.0)  # a few steps
        procs[1].send_signal(signal.SIGTERM)
        for p in procs:
            p.wait(timeout=TIMEOUT)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = [log.read_text() for log in logs]
    assert [p.returncode for p in procs] == [0, 0], outs
    steps = [int(o.split("interrupted at step ")[1].split(";")[0]) for o in outs]
    assert steps[0] == steps[1] > 0, outs
    manager = CheckpointManager(ck, pcfg.AudioConfig())
    assert manager.latest_step() == steps[0]
    tree, step = manager.restore_tree()
    assert step == tree["step"] == steps[0]


def test_a_signal_during_the_agreement_is_read_at_the_next_step(monkeypatch):
    """A signal that lands while the ranks reduce the shutdown flag (after
    this rank's flag was read) is not lost to the reduction's result: the
    next step's agreement carries it."""
    from sambert_hifigan_tpu_torch.parallel import mesh
    from sambert_hifigan_tpu_torch.training.signals import GracefulShutdown

    shutdown = GracefulShutdown(signals=(signal.SIGUSR1,))
    flags = []

    def any_rank(flag):
        flags.append(flag)
        if len(flags) == 1:
            shutdown._handle(signal.SIGUSR1, None)  # lands in the middle of the reduction
        return flag  # no peer was signalled

    monkeypatch.setattr(mesh, "any_rank", any_rank)
    try:
        assert not shutdown.agreed()
        assert shutdown.agreed() and shutdown.requested
    finally:
        shutdown.restore()
    assert flags == [False, True]


def test_multiprocess_dp_launcher_passes():
    """`python -m sambert_hifigan_tpu_torch.multiprocess_dp --device cpu`:
    2 workers against a control, PASS and a JSON summary."""
    proc = subprocess.run(
        [sys.executable, "-m", "sambert_hifigan_tpu_torch.multiprocess_dp", "--device", "cpu",
         "--steps", "2", "--batch-size", "4"],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[-1] == "PASS"
    summary = json.loads(lines[-2])
    assert summary["match"] and summary["replicas_equal"] and summary["nproc"] == 2
    assert summary["final_dist"]["total_loss"] > 0
