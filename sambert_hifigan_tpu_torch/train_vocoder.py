"""Train the HiFi-GAN vocoder.

  python -m sambert_hifigan_tpu_torch.train_vocoder --metadata data/train/metadata.csv \
      [--loss-mode adv_mel_fm] [--steps 100000] [--batch-size 16] [--segment-frames 32] \
      [--checkpoint-dir checkpoints/vocoder] [--resume] [--prefetch {auto,on,off}] \
      [--save-precision bf16] [--sync-save] [--model-parallel N] [--device cpu]
  python -m sambert_hifigan_tpu_torch.train_vocoder --synthetic 20    # no corpus
  python -m torch.distributed.run --standalone --nproc-per-node 2 \
      -m sambert_hifigan_tpu_torch.train_vocoder --synthetic 20      # 2 ranks
  python -m torch.distributed.run --standalone --nproc-per-node 4 \
      -m sambert_hifigan_tpu_torch.train_vocoder --synthetic 20 --model-parallel 2

Runs on the CUDA card unless --device cpu is given.  --metadata trains
--steps steps on random (mel, waveform) crops of the corpus, in shuffled
epochs (TTSDataset: features extracted on the training device and cached).
--synthetic N trains N steps on random pairs made from --seed; the weights
are random from --seed too.  --prefetch on crops the next batches and
copies them to the device on a background thread (data/prefetch.py).
Interval saves are written by a background thread from a copy made on the
device (--sync-save writes them in the step loop).  Checkpoints carry the
mel fingerprint: --resume refuses one trained under another mel
configuration.

Under torchrun each rank joins the process group (parallel/mesh.py) on
cuda:(LOCAL_RANK % cards), draws the same global pairs (--batch-size,
rounded down to a multiple of the world size), keeps its rows, and
averages the gradients over the ranks; rank 0 writes checkpoints and
metrics.  Without torchrun it runs as one process.  --model-parallel N lays
the ranks out as (ranks / N) data x N model (parallel/mesh.py): the ranks
of one model group keep the same rows, the batch is rounded to the data
axis, and the train state is stored sharded over the model axis
(parallel/sharding_rules.py), each weight gathered whole for the step.
Checkpoints are whole, so any N resumes from any other's.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from .data.prefetch import add_prefetch_flags
from .parallel.mesh import add_dist_flags
from .training.optim import add_stage_flags, stage_overrides


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--metadata", type=str, default=None)
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--model-config", type=str, default=None)
    p.add_argument("--loss-mode", type=str, default=None,
                   choices=["mel_only", "adv_mel", "adv_mel_fm"])
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--segment-frames", type=int, default=32)
    p.add_argument("--checkpoint-dir", type=str, default=None)
    p.add_argument("--log-dir", type=str, default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--d-lr", dest="learning_rate_discriminator", metavar="LR", type=float,
                   default=None,
                   help="discriminator learning rate override")
    p.add_argument("--d-update-every", dest="d_update_every", metavar="K", type=int,
                   default=None,
                   help="update D every k-th step (default 1)")
    add_stage_flags(p)
    p.add_argument("--steps", type=int, default=100000,
                   help="steps to train from --metadata")
    p.add_argument("--synthetic", type=int, default=0,
                   help="train N steps on synthetic pairs (no corpus)")
    add_prefetch_flags(p)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tensorboard", action="store_true",
                   help="mirror scalars into TensorBoard event files")
    p.add_argument("--save-precision", choices=["f32", "bf16"], default="f32",
                   help="bf16 stores the discriminators and both optimizers' moments in "
                        "bf16; the generator and its EMA stay f32")
    p.add_argument("--sync-save", action="store_true",
                   help="write interval checkpoints in the step loop (default: a "
                        "background thread writes a copy made on the device)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; 'cpu' trains on the CPU)")
    add_dist_flags(p)
    return p.parse_args(argv)


def synthetic_pairs(batch: int, frames: int, hop: int, n_mels: int = 80, seed: int = 0):
    """Endless (mel [B, n_mels, frames], wav [B, 1, frames * hop]) from a seed."""
    rng = np.random.default_rng(seed)
    while True:
        mel = rng.standard_normal((batch, n_mels, frames)).astype(np.float32)
        wav = (rng.standard_normal((batch, 1, frames * hop)) * 0.1).astype(np.float32)
        yield mel, wav


def stage_config(cfg, args):
    """cfg with the command line's overrides of training.vocoder."""
    tr = stage_overrides(cfg.training.vocoder, args,
                         extra=("learning_rate_discriminator", "d_update_every"))
    return dataclasses.replace(cfg, training=dataclasses.replace(cfg.training, vocoder=tr))


def main(argv=None):
    from .kernels import resolve_device
    from .parallel import mesh

    args = parse_args(argv)
    if not (args.synthetic or args.metadata):
        raise SystemExit("--metadata or --synthetic N is required")
    device, own_group = mesh.setup(resolve_device(args.device), args.dist_init_method)
    try:
        state = _train(args, device)
    except BaseException:
        if own_group:
            mesh.destroy(wait=False)
        raise
    if own_group:
        mesh.destroy()
    return state


def _train(args, device):
    import torch

    from .config import default_config, load_config, validate_config
    from .data.dataset import TTSDataset, epochs, to_device, vocoder_batches_from_dataset
    from .data.prefetch import Prefetcher, want_prefetch
    from .parallel import mesh
    from .training.checkpoint import CheckpointManager
    from .training.metrics import MetricsWriter
    from .training.signals import GracefulShutdown, TrainingDiverged, check_finite_metrics
    from .training.vocoder_trainer import init_vocoder_state, make_vocoder_step

    cfg = (load_config(args.config, args.model_config) if args.config or args.model_config
           else default_config())
    cfg = stage_config(cfg, args)
    validate_config(cfg)
    mesh.set_model_parallel(args.model_parallel)  # raises on a world it does not divide
    loss_mode = args.loss_mode or cfg.vocoder.loss_mode
    batch_size = mesh.round_batch(args.batch_size or cfg.training.vocoder.batch_size,
                                  "train_vocoder")

    state = init_vocoder_state(cfg, torch.Generator().manual_seed(args.seed), device)
    ckpt_dir = args.checkpoint_dir or f"{cfg.paths.checkpoint_dir}/vocoder"
    ckpt = CheckpointManager(ckpt_dir, cfg.audio)
    if args.resume and ckpt.latest_step() is not None:
        ckpt.restore(state)
        print(f"[train_vocoder] resumed from step {state.step}")
    mesh.replicate(state)
    n_params = sum(p.numel() for p in state.model.generator.parameters())
    if mesh.model_size() > 1:
        state.shard_()  # params, moments and EMA: this rank's slices from here on
    step_fn = make_vocoder_step(cfg, loss_mode=loss_mode)
    if args.synthetic:
        source = synthetic_pairs(batch_size, args.segment_frames, cfg.audio.hop_length,
                                 cfg.audio.n_mels, args.seed)
        total_steps = args.synthetic
    else:
        ds = TTSDataset(args.metadata, cfg, device=device)
        source = epochs(lambda n: vocoder_batches_from_dataset(
            ds, batch_size, args.segment_frames, seed=args.seed + n))
        total_steps = args.steps
    print(f"[train_vocoder] {loss_mode} on {device}, batch {batch_size} x "
          f"{args.segment_frames} frames, generator {n_params} parameters"
          + (f", rank {mesh.rank()} of {mesh.world_size()} (data {mesh.data_size()} x model "
             f"{mesh.model_size()})" if mesh.is_distributed() else ""))

    writer = MetricsWriter(args.log_dir or cfg.paths.log_dir, "vocoder",
                           tensorboard=args.tensorboard)
    log_interval = cfg.training.vocoder.log_interval
    save_interval = cfg.training.vocoder.save_interval
    save = dict(precision=args.save_precision, background=not args.sync_save)

    def put(pair):
        return tuple(to_device(a, device) for a in mesh.shard_batch(pair))

    # cropping, this rank's rows and the copy to the device, on a background
    # thread if asked
    batches = (Prefetcher(source, transfer=put) if want_prefetch(args.prefetch)
               else map(put, source))
    # SIGTERM/SIGINT -> finish the step, save, exit resumable; non-finite
    # logged metrics -> emergency save, exit non-zero
    shutdown = GracefulShutdown()
    start_step = last_step = state.step
    try:
        for i in range(start_step, total_steps):
            if shutdown.agreed():
                break
            mel, wav = next(batches)
            metrics = step_fn(state, mel, wav)
            last_step = i + 1
            if (i + 1) % log_interval == 0 or i == start_step:
                host = writer.write(i + 1, metrics)
                check_finite_metrics(host, i + 1)  # global metrics: every rank agrees
                if mesh.is_main():
                    print(writer.summary_line(i + 1, host,
                                              ["gen_loss", "gen_mel_loss", "disc_loss"]))
            if (i + 1) % save_interval == 0:
                ckpt.save(i + 1, state, **save)
    except TrainingDiverged as e:
        err = ckpt.drain()  # a failed interval save must not hide the divergence
        if err:
            print(f"[train_vocoder] warning: a background save failed earlier: {err!r}")
        if ckpt.needs_save(last_step):
            ckpt.save(last_step, state, precision=args.save_precision)
        ckpt.finish()
        raise SystemExit(f"[train_vocoder] DIVERGED: {e}; state saved at step {last_step} "
                         f"in {ckpt_dir} for forensics") from e
    finally:
        if isinstance(batches, Prefetcher):
            batches.close()
        shutdown.restore()
        writer.close()
    err = ckpt.drain()
    if err:
        print(f"[train_vocoder] warning: a background save failed earlier: {err!r}")
    if ckpt.needs_save(last_step):
        ckpt.save(last_step, state, precision=args.save_precision)
    ckpt.finish()  # the last save is on disk before any rank goes on
    if shutdown.requested:
        print(f"[train_vocoder] interrupted at step {last_step}; resumable checkpoint in "
              f"{ckpt_dir} (--resume)")
    else:
        print(f"[train_vocoder] done at step {last_step}; checkpoints in {ckpt_dir}")
    return state


if __name__ == "__main__":
    main()
