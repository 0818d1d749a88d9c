"""A single-card forward check and a multi-process dryrun of both train steps.

  python -m sambert_hifigan_tpu_torch.dryrun [N] [--device cpu]

The counterpart of the JAX package's `__graft_entry__.py`.

entry()              -> (fn, args): the teacher-forced forward of the
                        SAM-BERT acoustic model at the default config
                        (B = 2, 32 phonemes, 128 frames), random weights
                        from seed 0; fn(*args) -> mel [2, 128, 80].
dryrun_multichip(n)  -> stage "dp": n ranks in one process group (gloo,
                        `multiprocess_dp.launch`, which spawns them with
                        `run_procs`), each on its rows of one global batch
                        of max(n, 2): one full acoustic AdamW step and one
                        HiFi-GAN two-optimizer GAN step (adv_mel_fm), on a
                        tiny config (d 64, 2 + 2 layers; generator 64
                        channels; all 8 critics at channel_div 8).  The
                        verdict: every rank finished, every metric is
                        finite, and every rank holds the same parameters.
                     -> stage "dp x tp", where n is even and >= 4 (the JAX
                        condition): the same two steps on n ranks laid out
                        as data n/2 x model 2, the train state stored
                        sharded over the model axis, in float32 without
                        dropout (`multiprocess_dp.comparable`).  The
                        verdict: every rank finished, every metric is
                        finite, the whole (replicated) leaves are bit-equal
                        on every rank, each slice is bit-equal across the
                        data groups, and against one process on the same
                        global batch (model = 1) the metrics are within
                        the JAX package's own bounds of its TP step
                        (tests/test_tensor_parallel.py: rtol 2e-4 on the
                        acoustic loss, 2e-3 on its grad norm, 3e-4 on the
                        GAN's losses) and the gathered parameters within
                        2 lr (two Adam first steps from the same weights
                        move an element by at most lr each way).

Ranks run on the CUDA card (all on one card when there are fewer cards
than ranks) unless device='cpu' is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import tempfile
from pathlib import Path


def entry(device=None):
    import numpy as np
    import torch

    from .config import default_config
    from .kernels import resolve_device
    from .weights import random_acoustic_model

    device = resolve_device(device)
    cfg = default_config()
    model = random_acoustic_model(cfg, torch.Generator().manual_seed(0)).to(device).eval()
    b, tph, tfrm = 2, 32, 128
    rng = np.random.default_rng(0)

    def t(a):
        return torch.as_tensor(a, device=device)

    ph = t(rng.integers(4, 300, (b, tph)))
    tone = t(rng.integers(0, 10, (b, tph)))
    bound = t(rng.integers(0, 5, (b, tph)))
    dur = torch.full((b, tph), tfrm // tph, dtype=torch.int64, device=device)
    mel = t(rng.standard_normal((b, tfrm, cfg.audio.n_mels)).astype(np.float32))

    def fn(model, ph, tone, bound, mel, dur):
        return model(ph, tone, bound, mel, dur).mel_pred

    return fn, (model, ph, tone, bound, mel, dur)


def tiny_config():
    """The JAX dryrun's tiny-but-real config: the same step code at d 64."""
    from .config import (AcousticModelConfig, DecoderConfig, DiscriminatorConfig,
                         EncoderConfig, GeneratorConfig, VocoderConfig, default_config)

    return dataclasses.replace(
        default_config(),
        acoustic_model=AcousticModelConfig(
            d_model=64, encoder=EncoderConfig(n_layers=2, n_heads=4, d_ff=128),
            decoder=DecoderConfig(n_layers=2, n_heads=4, d_ff=128, max_len=128)),
        vocoder=VocoderConfig(
            generator=GeneratorConfig(upsample_initial_channel=64, resblock_kernel_sizes=(3,),
                                      resblock_dilation_sizes=((1, 3),)),
            discriminator=DiscriminatorConfig(channel_div=8)),
    )


# the step-1 bounds of tests/test_tensor_parallel.py, JAX's TP step against
# one device in float32
TP_RTOL = {"total_loss": 2e-4, "grad_norm": 2e-3, "gen_loss": 3e-4, "disc_loss": 3e-4,
           "gen_mel_loss": 3e-4, "gen_fm_loss": 3e-4}


def _lrs(cfg, name: str) -> dict:
    """{parameter-name prefix: the learning rate of its optimizer}."""
    if name == "acoustic":
        return {"": cfg.training.acoustic.learning_rate}
    tr = cfg.training.vocoder
    d_lr = tr.learning_rate_discriminator or tr.learning_rate
    return {"generator.": tr.learning_rate, "msd.": d_lr, "mpd.": d_lr}


def stage_dp_tp(n_devices: int, device, timeout: float) -> bool:
    """Stage "dp x tp": data n/2 x model 2 against one process; prints its
    verdict and returns it."""
    import numpy as np

    from . import multiprocess_dp as mp

    cfg = mp.comparable(tiny_config())
    data, model = n_devices // 2, 2
    print(f"[dryrun] stage dp x tp: {n_devices} ranks on {device.type} (gloo), data {data} x "
          f"model {model}, global batch {n_devices}")
    runs = [mp.make_run("acoustic", cfg, 1, n_devices, tph=8, tfrm=16, lockstep=False,
                        params=True, model_parallel=model),
            mp.make_run("vocoder", cfg, 1, n_devices, segment_frames=8, lockstep=False,
                        params=True, model_parallel=model)]
    control = mp.run_plan(runs, device)  # one process: model = 1
    with tempfile.TemporaryDirectory() as tmp:
        ranks = mp.launch(runs, n_devices, device.type, Path(tmp), timeout=timeout)
    ok = True
    for i, name in enumerate(("acoustic", "vocoder GAN")):
        res, ctl = [r[i] for r in ranks], control[i]
        finite = all(math.isfinite(v) for r in res for v in r["history"][0].values())
        whole = len({r["whole_digest"] for r in res}) == 1
        slices = all(r["shard_digest"] == res[j % model]["shard_digest"]
                     for j, r in enumerate(res))
        gathered = len({r["digest"] for r in res}) == 1
        got, want = res[0]["history"][0], ctl["history"][0]
        dep = {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-8) for k in TP_RTOL if k in want}
        metrics_ok = all(v <= TP_RTOL[k] for k, v in dep.items()) and bool(dep)
        lrs = _lrs(cfg, name.split()[0])
        param_dep = max(
            float(np.abs(res[0]["params"][k].numpy() - v.numpy()).max())
            / next(lr for pre, lr in lrs.items() if k.startswith(pre))
            for k, v in ctl["params"].items())
        params_ok = param_dep <= 2.0 + 1e-3
        step_ok = finite and whole and slices and gathered and metrics_ok and params_ok
        shown = dict(list(got.items())[:6]) if i else got
        print(f"[dryrun] stage dp x tp: {name} step {'ok' if step_ok else 'FAILED'}: {shown} "
              f"(finite {finite}, whole leaves equal {whole}, slices equal across data groups "
              f"{slices}; against one process: largest metric departure "
              f"{max(dep.values(), default=float('nan')):.3g}, parameters "
              f"{param_dep:.3g} lr (bound 2); per-rank state {res[0]['persistent_numel']} of "
              f"{ctl['persistent_numel']} elements)")
        ok = ok and step_ok
    print(f"[dryrun] stage dp x tp: {'PASS' if ok else 'FAIL'}")
    return ok


def dryrun_multichip(n_devices: int, device=None, timeout: float = 600.0) -> bool:
    """Stage "dp" on n_devices ranks, then stage "dp x tp" where n_devices
    is even and >= 4; prints each verdict and returns whether all passed."""
    from . import multiprocess_dp as mp
    from .kernels import resolve_device

    device = resolve_device(device)
    cfg = tiny_config()
    batch = max(n_devices, 2)
    print(f"[dryrun] stage dp: {n_devices} ranks on {device.type} (gloo), global batch {batch}")
    runs = [mp.make_run("acoustic", cfg, 1, batch, tph=8, tfrm=16, lockstep=False),
            mp.make_run("vocoder", cfg, 1, batch, segment_frames=8, lockstep=False)]
    with tempfile.TemporaryDirectory() as tmp:
        ranks = mp.launch(runs, n_devices, device.type, Path(tmp), timeout=timeout)
    ok = True
    for i, name in enumerate(("acoustic", "vocoder GAN")):
        metrics = ranks[0][i]["history"][0]
        finite = all(math.isfinite(v) for r in ranks for v in r[i]["history"][0].values())
        same = len({r[i]["digest"] for r in ranks}) == 1
        shown = dict(list(metrics.items())[:6]) if i else metrics
        print(f"[dryrun] stage dp: {name} step {'ok' if finite and same else 'FAILED'}: "
              f"{shown} (finite {finite}, replicas equal {same})")
        ok = ok and finite and same
    print(f"[dryrun] stage dp: {'PASS' if ok else 'FAIL'}")
    if n_devices % 2 == 0 and n_devices >= 4:
        ok = stage_dp_tp(n_devices, device, timeout) and ok
    return ok


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("n", type=int, nargs="?", default=2, help="ranks (default 2)")
    p.add_argument("--device", type=str, default=None,
                   help="cpu or cuda (default: cuda); every rank on this device type")
    args = p.parse_args(argv)
    return 0 if dryrun_multichip(args.n, args.device) else 1


if __name__ == "__main__":
    raise SystemExit(main())
