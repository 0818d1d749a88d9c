"""Closed loop of vocoder train steps: the system's adv_mel_fm step on a
pool of seeded batches, back to back, for at least the run's seconds.

Set-up builds the one train state, drives it through its first
`setup_steps` steps (which warm it up) on batches whose rows all differ,
and records what the reference follows: each step's losses, the first
gradient of every leaf as the optimizer got it (Adam's first moment after
one step is (1 - beta1) g), and every leaf's change after those steps.
The window then continues the same state.  Once its seconds are up it
copies the state (parameters and AdamW's moments and counts) to the host
and runs `check_steps` more steps, which it times and counts with the
rest; the reference follows those steps from that copy.  Their gaps are
printed, not compared: by then the discriminators' loss has fallen to
~0.2 and bf16 moves it by as much as the fp8 control does (PERF.md)."""

from __future__ import annotations

import gc
import math
import time
from typing import Dict, List

import torch

from reference import vocoder as ref
from reference.mel import log_mel
from reference.precision import ieee_f32, rounder

from .. import port, weights
from ..common import devices_for, peak_bytes, sync
from ..record import Context, Run, log
from ..trace import capture


def make_batches(c: dict, tr: dict, seed: int, device) -> List[tuple]:
    """`pool_batches` batches of (mel [B, n_mels, F], wav [B, 1, F * hop]):
    harmonic tones (100-300 Hz, 6 partials of falling amplitude, random
    phases) under a slow random envelope, with noise; their log-mels by
    the benchmark's own mel op, so that mel and audio agree as in a corpus."""
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    n, b, f, hop = tr["pool_batches"], tr["batch"], tr["segment_frames"], c["hop_length"]
    t = f * hop
    rows = n * b
    time_s = torch.arange(t, device=device) / c["sample_rate"]
    f0 = 100.0 + 200.0 * torch.rand(rows, 1, generator=gen, device=device)
    k = torch.arange(1, 7, device=device)
    phase = 2 * math.pi * torch.rand(rows, 6, 1, generator=gen, device=device)
    tones = torch.sin(2 * math.pi * f0[:, None] * k[None, :, None] * time_s + phase)
    wav = (tones / k[None, :, None]).sum(1)
    env = 0.5 + 0.5 * torch.sin(2 * math.pi * 3.0 * torch.rand(rows, 1, generator=gen,
                                                                device=device) * time_s)
    wav = 0.3 * env * wav / wav.abs().amax(dim=1, keepdim=True)
    wav = wav + 0.01 * torch.randn(rows, t, generator=gen, device=device)
    with ieee_f32():
        mel = log_mel(wav, c)[..., :f]
    return [(mel[i * b:(i + 1) * b].contiguous(), wav[i * b:(i + 1) * b, None].contiguous())
            for i in range(n)]


def _step(step, state, batch, ctx: Context, saved=None):
    mel, wav = batch
    if ctx.fault == "half_batch":
        half = mel.shape[0] // 2
        return step(state, mel[:half], wav[:half])
    metrics = step(state, mel, wav)
    if ctx.fault == "unchanged":
        with torch.no_grad():
            for p, s in zip(state.model.parameters(), saved):
                p.copy_(s)
    elif ctx.fault not in (None, "control"):
        raise ValueError(f"fault {ctx.fault!r} does not apply to train steps")
    return metrics


def _moments(state, names) -> Dict[str, tuple]:
    """{name: (exp_avg, exp_avg_sq, step)} of every parameter AdamW holds."""
    out = {}
    for opt in (state.g_opt, state.d_opt):
        for p in opt.params:
            st = opt.adamw.state.get(p) or {"exp_avg": torch.zeros_like(p),
                                            "exp_avg_sq": torch.zeros_like(p),
                                            "step": torch.zeros(())}
            out[names[id(p)]] = (st["exp_avg"], st["exp_avg_sq"], st["step"])
    return out


class Snapshot:
    """Host buffers for the train state, allocated in set-up and filled by
    asynchronous copies in the card's stream order: the parameters, and
    AdamW's moments and step counts."""

    def __init__(self, params: Dict[str, torch.Tensor], moments: Dict[str, tuple]):
        pin = next(iter(params.values())).is_cuda

        def buf(t):
            return torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
        self.params = {k: buf(v) for k, v in params.items()}
        self.moments = {k: tuple(buf(t) for t in m) for k, m in moments.items()}

    def take(self, params: Dict[str, torch.Tensor], moments: Dict[str, tuple]) -> None:
        with torch.no_grad():
            for k, v in params.items():
                self.params[k].copy_(v, non_blocking=True)
            for k, m in moments.items():
                for dst, src in zip(self.moments[k], m):
                    dst.copy_(src, non_blocking=True)

    def adam_state(self) -> Dict[str, tuple]:
        """{name: (exp_avg, exp_avg_sq, step count)} as the reference takes it."""
        return {k: (m, v, float(n)) for k, (m, v, n) in self.moments.items()}


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    vals = torch.stack(torch._foreach_norm([tensors[k].float() for k in names])).tolist()
    return dict(zip(names, vals))


def run(cell, seed: int, seconds: float, trace: bool, ctx: Context) -> Run:
    c, tr = cell.config, cell.traffic
    out = Run(c, tr, cell.chips)
    cfg = port.tts_config(c)
    dev = devices_for(ctx, 1)[0]
    sd = weights.make(port.gan_shapes(cfg), seed, dev)
    state, step, names = port.vocoder_trainer(cfg, sd, dev)
    batches = make_batches(c, tr, seed, dev)
    beta1 = c["betas"][0]
    saved = [p.detach().clone() for p in state.model.parameters()] \
        if ctx.fault == "unchanged" else None
    seen = {"d_loss": [], "g_loss": []}
    for i in range(tr["setup_steps"]):
        m = _step(step, state, batches[i], ctx, saved)
        seen["d_loss"].append(float(m["disc_loss"]))
        seen["g_loss"].append(float(m["gen_loss"]))
        if i == 0:
            seen["grad"] = _norms({k: m1 / (1.0 - beta1)
                                   for k, (m1, _, _) in _moments(state, names).items()})
    params = dict(state.model.named_parameters())
    seen["change"] = _norms({k: params[k].detach() - sd[k] for k in params})
    snap = Snapshot(params, _moments(state, names))
    sync([dev])
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    ctx.setup_done()
    t0 = time.perf_counter()
    n = 0
    while time.perf_counter() - t0 < seconds:
        _step(step, state, batches[(tr["setup_steps"] + n) % len(batches)], ctx, saved)
        n += 1
    snap.take(params, _moments(state, names))
    last, tail = [], []
    for _ in range(tr["check_steps"]):
        b = batches[(tr["setup_steps"] + n) % len(batches)]
        last.append(b)
        tail.append(_step(step, state, b, ctx, saved))
        n += 1
    sync([dev])
    out.window_s = time.perf_counter() - t0
    out.steps = out.attempted = n
    out.e2e["train_steps_per_s"] = n / out.window_s
    out.memory_peak_bytes = peak_bytes([dev])
    with torch.no_grad():
        change = {k: float(torch.linalg.vector_norm(p - snap.params[k].to(dev)))
                  for k, p in params.items()}
    seen_w = {"d_loss": [float(m["disc_loss"]) for m in tail],
              "g_loss": [float(m["gen_loss"]) for m in tail], "change": change}
    log(f"window: {n} steps in {out.window_s:.3f} s; set-up losses d {seen['d_loss']} "
        f"g {seen['g_loss']}; the last {len(tail)} steps' d {seen_w['d_loss']} "
        f"g {seen_w['g_loss']}")
    if trace:
        k = tr["trace_steps"]
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)

        def traced():
            for i in range(k):
                _step(step, state, batches[i % len(batches)], ctx, saved)
            sync([dev])
        out.trace = capture(traced, 1)
        out.traced_steps = k
        out.traced_wall_s = k * out.window_s / n
        out.memory_peak_bytes = max(out.memory_peak_bytes, peak_bytes([dev]))
    del state, step, params, saved
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    check(out, ctx, (seen, sd, batches[:tr["setup_steps"]]), (seen_w, snap, last), c)
    log(f"set-up {ctx.setup_s:.3f} s, the comparison {time.perf_counter() - t_check:.3f} s")
    return out


def gaps(seen: dict, want: dict) -> Dict[str, float]:
    """The worst relative gap of a step's loss; of a leaf's first-gradient
    norm and of its change, each against the reference's norm of that leaf
    or of the median leaf, whichever is larger.  Leaves whose reference
    gradient is under a thousandth of the median leaf's move under Adam by
    round-off alone and are left out of the change."""
    loss = max(abs(a - b) / max(abs(b), 1e-30)
               for k in ("d_loss", "g_loss") for a, b in zip(seen[k], want[k]))
    g = want["grad"]
    g_med = sorted(g.values())[len(g) // 2]
    out = {"loss_gap": loss}
    if "grad" in seen:
        out["grad_gap"] = max(abs(seen["grad"][k] - v) / max(v, g_med, 1e-30)
                              for k, v in g.items())
    moving = [k for k, v in g.items() if v >= 1e-3 * g_med]
    ch = want["change"]
    c_med = sorted(ch[k] for k in moving)[len(moving) // 2]
    out["change_gap"] = max(abs(seen["change"][k] - ch[k]) / max(ch[k], c_med, 1e-30)
                            for k in moving)
    return out


def check(out: Run, ctx: Context, start, window, c) -> None:
    """Compare the set-up's steps from the seed with the f32 reference, and
    print the window's last steps against it, followed from the copy of the
    state.  Under the "control" fault the reference in fp8 takes the
    program's place on both."""
    (seen, sd, first), (seen_w, snap, last) = start, window
    dev = next(iter(sd.values())).device
    with ieee_f32():
        if ctx.fault == "control":
            seen = ref.train(sd, first, c, rounder("fp8"), len(first))
        want = ref.train(sd, first, c, rounder("f32"), len(first))
        found = gaps(seen, want)
        params = {k: v.to(dev) for k, v in snap.params.items()}
        adam = {k: tuple(t.to(dev) if torch.is_tensor(t) else t for t in m)
                for k, m in snap.adam_state().items()}
        if ctx.fault == "control":
            seen_w = ref.train(params, last, c, rounder("fp8"), len(last), adam)
        want_w = ref.train(params, last, c, rounder("f32"), len(last), adam)
        found_w = gaps(seen_w, want_w)
    # the first gradient's gap and the window's gaps are not compared:
    # sound runs and the fp8 control read alike on them (PERF.md), so they
    # are diagnostics
    out.notes["grad_gap"] = found.pop("grad_gap")
    out.notes.update({f"{k}_window": v for k, v in found_w.items()})
    out.checks.update(found)
    med = sorted(want["grad"].values())[len(want["grad"]) // 2]
    out.notes["leaves_left_out"] = sorted(k for k, v in want["grad"].items() if v < 1e-3 * med)
