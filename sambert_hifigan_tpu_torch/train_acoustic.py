"""Train the SAM-BERT acoustic model.

  python -m sambert_hifigan_tpu_torch.train_acoustic --metadata data/train/metadata.csv \
      [--steps 200000] [--batch-size 16] [--checkpoint-dir checkpoints/acoustic] [--resume] \
      [--prefetch {auto,on,off}] [--save-precision bf16] [--sync-save] \
      [--scheduled-sampling 0.2] [--lr-schedule warmup_cosine --warmup-steps 100 \
      --lr-total-steps 20] [--ema-decay 0.999] [--accumulate-steps 2] [--seed 0] [--device cpu]
  python -m sambert_hifigan_tpu_torch.train_acoustic --synthetic 20    # no corpus
  python -m torch.distributed.run --standalone --nproc-per-node 2 \
      -m sambert_hifigan_tpu_torch.train_acoustic --synthetic 20      # 2 ranks
  python -m torch.distributed.run --standalone --nproc-per-node 4 \
      -m sambert_hifigan_tpu_torch.train_acoustic --synthetic 20 --model-parallel 2

Runs on the CUDA card unless --device cpu is given.  --metadata trains
--steps steps on the corpus, in shuffled epochs of batches padded to the
config's phoneme and frame buckets (TTSDataset: features extracted on the
training device and cached; `preprocess` fills the cache first).
--synthetic N trains N steps on random batches made from --seed (16
phonemes, 64 frames each, as the JAX script's synthetic run).  The weights
are random from --seed.  --prefetch on collates the next batches and
copies them to the device on a background thread (data/prefetch.py);
'auto' does so where the process has two or more cores.  Interval saves
are written by a background thread from a copy made on the device
(--sync-save writes them in the step loop).  Checkpoints carry the mel
fingerprint: --resume refuses one trained under another mel
configuration; `inference --acoustic-checkpoint` and `serve
--acoustic-checkpoint` load them.

Under torchrun each rank joins the process group (parallel/mesh.py) on
cuda:(LOCAL_RANK % cards), builds the same global batch (--batch-size,
rounded down to a multiple of the world size), keeps its rows, and reduces
the step explicitly; rank 0 writes checkpoints and metrics.  A SIGTERM to
any rank stops every rank at the same step.  Without torchrun it runs as
one process.  --model-parallel N lays the ranks out as (ranks / N) data x
N model (parallel/mesh.py): the ranks of one model group keep the same
rows, the batch is rounded to the data axis, and the train state (params,
Adam moments, EMA) is stored sharded over the model axis
(parallel/sharding_rules.py), each weight gathered whole for the step.
Checkpoints are whole, so any N resumes from any other's.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools

from .data.prefetch import add_prefetch_flags
from .parallel.mesh import add_dist_flags
from .training.optim import add_stage_flags, stage_overrides


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--metadata", type=str, default=None)
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--model-config", type=str, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--checkpoint-dir", type=str, default=None)
    p.add_argument("--log-dir", type=str, default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--steps", type=int, default=200000,
                   help="steps to train from --metadata")
    p.add_argument("--synthetic", type=int, default=0,
                   help="train N steps on synthetic batches (no corpus)")
    add_prefetch_flags(p)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save-precision", choices=["f32", "bf16"], default="f32",
                   help="bf16 stores the optimizer's moments in bf16; the model and its "
                        "EMA stay f32")
    p.add_argument("--sync-save", action="store_true",
                   help="write interval checkpoints in the step loop (default: a "
                        "background thread writes a copy made on the device)")
    p.add_argument("--tensorboard", action="store_true",
                   help="mirror scalars into TensorBoard event files")
    p.add_argument("--scheduled-sampling", dest="scheduled_sampling", metavar="P", type=float,
                   default=None,
                   help="per-frame probability of feeding the decoder its own pass-1 "
                        "prediction instead of the ground truth (0 = teacher forcing)")
    add_stage_flags(p)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; 'cpu' trains on the CPU)")
    add_dist_flags(p)
    return p.parse_args(argv)


def stage_config(cfg, args):
    """cfg with the command line's overrides of training.acoustic."""
    tr = stage_overrides(cfg.training.acoustic, args, extra=("scheduled_sampling",))
    return dataclasses.replace(cfg, training=dataclasses.replace(cfg.training, acoustic=tr))


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
    from .data.dataset import TTSDataset, batch_to_device, epochs, synthetic_batch
    from .data.prefetch import Prefetcher, want_prefetch
    from .parallel import mesh
    from .training.acoustic_trainer import init_acoustic_state, make_acoustic_step
    from .training.checkpoint import CheckpointManager
    from .training.metrics import MetricsWriter
    from .training.signals import GracefulShutdown, TrainingDiverged, check_finite_metrics
    from .weights import random_acoustic_model

    cfg = (load_config(args.config, args.model_config) if args.config or args.model_config
           else default_config())
    cfg = stage_config(cfg, args)
    validate_config(cfg)
    mesh.set_model_parallel(args.model_parallel)  # raises on a world it does not divide
    tr = cfg.training.acoustic
    batch_size = mesh.round_batch(args.batch_size or tr.batch_size, "train_acoustic")

    model = random_acoustic_model(cfg, torch.Generator().manual_seed(args.seed)).to(device)
    state = init_acoustic_state(model, cfg)
    ckpt_dir = args.checkpoint_dir or f"{cfg.paths.checkpoint_dir}/acoustic"
    ckpt = CheckpointManager(ckpt_dir, cfg.audio)
    if args.resume and ckpt.latest_step() is not None:
        ckpt.restore(state)
        print(f"[train_acoustic] resumed from step {state.step}")
    mesh.replicate(state)
    n_params = sum(p.numel() for p in state.model.parameters())
    if mesh.model_size() > 1:
        state.shard_()  # params, moments and EMA: this rank's slices from here on
    step_fn = make_acoustic_step(cfg)
    if args.synthetic:
        source = (synthetic_batch(cfg, batch_size, tph=16, tfrm=64, seed=args.seed + i)
                  for i in itertools.count(state.step))
        total_steps = args.synthetic
    else:
        ds = TTSDataset(args.metadata, cfg, device=device)
        source = epochs(lambda n: ds.batches(batch_size, seed=args.seed + n))
        total_steps = args.steps
    print(f"[train_acoustic] on {device}, batch {batch_size}, {n_params} parameters, "
          f"{'bf16' if tr.mixed_precision else 'f32'}"
          + (f", rank {mesh.rank()} of {mesh.world_size()} (data {mesh.data_size()} x model "
             f"{mesh.model_size()})" if mesh.is_distributed() else ""))

    writer = MetricsWriter(args.log_dir or cfg.paths.log_dir, "acoustic",
                           tensorboard=args.tensorboard)
    rng = torch.Generator().manual_seed(args.seed + 1)
    save = dict(precision=args.save_precision, background=not args.sync_save)
    # collation, this rank's rows and the copy to the device, on a background
    # thread if asked
    def to_device(global_batch):
        return batch_to_device(mesh.shard_batch(global_batch), device)

    batches = (Prefetcher(source, transfer=to_device) if want_prefetch(args.prefetch)
               else map(to_device, source))
    # SIGTERM/SIGINT -> finish the step, save, exit resumable; non-finite
    # logged metrics -> emergency save, exit non-zero
    shutdown = GracefulShutdown()
    start_step = last_step = state.step
    try:
        for i in range(start_step, total_steps):
            if shutdown.agreed():
                break
            batch = next(batches)
            if i == start_step:
                b, tph = batch["ph_ids"].shape
                print(f"[train_acoustic] first batch: {b} x {tph} phonemes x "
                      f"{batch['mel_gt'].shape[1]} frames")
            metrics = step_fn(state, batch, rng)
            last_step = i + 1
            if (i + 1) % tr.log_interval == 0 or i == start_step:
                host = writer.write(i + 1, metrics)
                check_finite_metrics(host, i + 1)  # global metrics: every rank agrees
                if mesh.is_main():
                    print(writer.summary_line(i + 1, host,
                                              ["total_loss", "mel_loss", "dur_loss"]))
            if (i + 1) % tr.save_interval == 0:
                ckpt.save(i + 1, state, **save)
    except TrainingDiverged as e:
        err = ckpt.drain()  # a failed interval save must not hide the divergence
        if err:
            print(f"[train_acoustic] warning: a background save failed earlier: {err!r}")
        if ckpt.needs_save(last_step):
            ckpt.save(last_step, state, precision=args.save_precision)
        ckpt.finish()
        raise SystemExit(f"[train_acoustic] DIVERGED: {e}; state saved at step {last_step} "
                         f"in {ckpt_dir} for forensics") from e
    finally:
        if isinstance(batches, Prefetcher):
            batches.close()
        shutdown.restore()
        writer.close()
    err = ckpt.drain()
    if err:
        print(f"[train_acoustic] warning: a background save failed earlier: {err!r}")
    if ckpt.needs_save(last_step):
        ckpt.save(last_step, state, precision=args.save_precision)
    ckpt.finish()  # the last save is on disk before any rank goes on
    if shutdown.requested:
        print(f"[train_acoustic] interrupted at step {last_step}; resumable checkpoint in "
              f"{ckpt_dir} (--resume)")
    else:
        print(f"[train_acoustic] done at step {last_step}; checkpoints in {ckpt_dir}")
    return state


if __name__ == "__main__":
    main()
