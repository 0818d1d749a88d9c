"""HiFi-GAN V1 GAN training in plain PyTorch: the reference of the `gan`
configurations (Kong et al. 2020; the adv_mel_fm recipe of the system).

One step: wav_fake = G(mel); the discriminators' LSGAN loss on (real,
fake detached) -> AdamW on MSD + MPD; then the generator's loss against the
updated discriminators (LSGAN adversarial + 2 x feature matching (L1 per
layer, mean over layers, then over critics) + 45 x L1 of log-mels + the
multi-resolution STFT terms (L1 and L2 of log magnitudes, 3 resolutions)),
through the first forward's graph -> AdamW on G.  Every GAN term is the
mean over the 8 critics (3 MSD scales, 5 MPD periods).

Discriminators: weight norm w = g v / sqrt(sum v^2 + 1e-12) over all axes
but the first.  MSD: 7 convs + conv_post per scale, scales 2 and 3 after
AvgPool1d(4, 2, 2); MPD: reflect-pad to a multiple of the period, fold to
[B, 1, T / p, p], 4 convs (5, 1) stride (3, 1), one stride 1, conv_post (3,
1).  LeakyReLU 0.1 after every conv but the last.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from .generator import generator
from .mel import log_mel, stft_magnitude

SLOPE = 0.1
MSD = ((1, 128, 15, 1, 1, 7), (128, 128, 41, 2, 4, 20), (128, 256, 41, 2, 16, 20),
       (256, 512, 41, 4, 16, 20), (512, 1024, 41, 4, 16, 20), (1024, 1024, 41, 1, 16, 20),
       (1024, 1024, 5, 1, 1, 2))
STFT = ((1024, 120, 600), (2048, 240, 1200), (512, 50, 240))


def _wn(P, name):
    v, g = P[name + ".weight_v"], P[name + ".weight_g"]
    n = torch.sqrt(v.square().sum(dim=tuple(range(1, v.dim())), keepdim=True) + 1e-12)
    return g.reshape(-1, *([1] * (v.dim() - 1))) * v / n


def _width(ch: int, c: dict) -> int:
    """A critic's channel count at the configuration's divisor (1 at the
    published widths)."""
    return ch if ch == 1 else max(1, ch // c.get("channel_div", 1))


def msd(P, x, c, q):
    outs, maps = [], []
    for i in range(c["msd_scales"]):
        if i:
            x = F.avg_pool1d(x, 4, 2, 2)
        p = f"msd.discs.{i}"
        h, fm = x, []
        for j, (cin, cout, _, s, g, pad) in enumerate(MSD):
            name = f"{p}.convs.{j}"
            g = math.gcd(g, math.gcd(_width(cin, c), _width(cout, c)))
            h = F.leaky_relu(F.conv1d(q(h), q(_wn(P, name)), P[name + ".bias"], s, pad, 1, g),
                             SLOPE)
            fm.append(h)
        h = F.conv1d(q(h), q(_wn(P, p + ".conv_post")), P[p + ".conv_post.bias"], 1, 1)
        fm.append(h)
        outs.append(h)
        maps.append(fm)
    return outs, maps


def mpd(P, x, c, q):
    outs, maps = [], []
    b, ch, t = x.shape
    for i, period in enumerate(c["mpd_periods"]):
        p = f"mpd.discs.{i}"
        h = x if t % period == 0 else F.pad(x, (0, period - t % period), mode="reflect")
        h = h.reshape(b, ch, -1, period)
        fm = []
        for j in range(5):
            name = f"{p}.convs.{j}"
            stride = (3, 1) if j < 4 else 1
            h = F.leaky_relu(F.conv2d(q(h), q(_wn(P, name)), P[name + ".bias"], stride, (2, 0)),
                             SLOPE)
            fm.append(h)
        h = F.conv2d(q(h), q(_wn(P, p + ".conv_post")), P[p + ".conv_post.bias"], 1, (1, 0))
        fm.append(h)
        outs.append(h)
        maps.append(fm)
    return outs, maps


def discriminators(P, x, c, q):
    (a, fa), (b, fb) = msd(P, x, c, q), mpd(P, x, c, q)
    return a + b, fa + fb


def generator_loss(c, real, fake, d_fake, maps_real, maps_fake):
    adv = sum(torch.mean(torch.square(d - 1.0)) for d in d_fake) / len(d_fake)
    fm = sum(sum(torch.mean(torch.abs(f - r.detach())) for r, f in zip(mr, mf)) / len(mr)
             for mr, mf in zip(maps_real, maps_fake)) / len(maps_real)
    mel = torch.mean(torch.abs(log_mel(fake[:, 0], c) - log_mel(real[:, 0], c)))
    sc = mag = 0.0
    for n_fft, hop, win in STFT:
        lr = torch.log(stft_magnitude(real[:, 0], n_fft, hop, win) + 1e-5)
        lf = torch.log(stft_magnitude(fake[:, 0], n_fft, hop, win) + 1e-5)
        sc = sc + torch.mean(torch.abs(lf - lr))
        mag = mag + torch.mean(torch.square(lf - lr))
    w = c["loss_weights"]
    return (adv + w["feature_matching"] * fm + w["mel"] * mel
            + w["stft"] * (sc + mag) / len(STFT))


def train(P0: Dict[str, torch.Tensor], batches, c: dict, q, steps: int,
          adam: Optional[Dict[str, tuple]] = None):
    """`steps` steps from the state P0 (the system's state_dict names) over
    `batches` [(mel, wav)] -> {"d_loss", "g_loss": [per step], "grad": {name:
    the first step's gradient norm}, "change": {name: ||P_steps - P0||}}.
    AdamW starts fresh, or from `adam` {name: (exp_avg, exp_avg_sq, steps
    taken)} where training is followed from a state in mid-course."""
    P = {k: v.detach().clone().float().requires_grad_(True) for k, v in P0.items()}
    g_names = [k for k in P if k.startswith("generator.")]
    d_names = [k for k in P if not k.startswith("generator.")]
    opt = {part: torch.optim.AdamW([P[k] for k in names], lr=c["learning_rate"],
                                   betas=tuple(c["betas"]), eps=1e-8,
                                   weight_decay=c["weight_decay"])
           for part, names in (("g", g_names), ("d", d_names))}
    for part, names in (("g", g_names), ("d", d_names)):
        for k in names if adam else ():
            m, v, n = adam[k]
            if n:
                opt[part].state[P[k]] = {"step": torch.tensor(float(n)),
                                         "exp_avg": m.detach().clone().float(),
                                         "exp_avg_sq": v.detach().clone().float()}
    out = {"d_loss": [], "g_loss": [], "grad": {}, "change": {}}
    for step in range(steps):
        mel, real = batches[step]
        fake = generator(P, "generator.", mel, c, q)
        d_real, _ = discriminators(P, real, c, q)
        d_fake, _ = discriminators(P, fake.detach(), c, q)
        d_loss = sum(torch.mean(torch.square(r - 1.0)) + torch.mean(torch.square(f))
                     for r, f in zip(d_real, d_fake)) / len(d_real)
        d_grads = torch.autograd.grad(d_loss, [P[k] for k in d_names])
        _apply(opt["d"], [P[k] for k in d_names], d_grads)
        d_fake, maps_fake = discriminators(P, fake, c, q)
        with torch.no_grad():
            _, maps_real = discriminators(P, real, c, q)
        g_loss = generator_loss(c, real, fake, d_fake, maps_real, maps_fake)
        g_grads = torch.autograd.grad(g_loss, [P[k] for k in g_names])
        _apply(opt["g"], [P[k] for k in g_names], g_grads)
        out["d_loss"].append(d_loss.item())
        out["g_loss"].append(g_loss.item())
        if step == 0:
            for k, g in zip(d_names + g_names, list(d_grads) + list(g_grads)):
                out["grad"][k] = float(torch.linalg.vector_norm(g.float()))
    for k in P:
        out["change"][k] = float(torch.linalg.vector_norm((P[k].detach() - P0[k]).float()))
    return out


@torch.no_grad()
def _apply(opt, params: List[torch.Tensor], grads) -> None:
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()
    for p in params:
        p.grad = None
