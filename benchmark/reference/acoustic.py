"""SAM-BERT text -> mel and text -> wav in plain PyTorch: the reference of
the `tts` configurations.

Phoneme, tone and boundary embeddings summed -> BERT encoder (post-norm
layers: self-attention, FFN with ReLU; LayerNorm eps 1e-5; a final
LayerNorm) -> variance adaptor (duration, pitch and energy predictors, each
2 x [conv k 3 -> ReLU -> LayerNorm -> + residual] -> linear; durations
max(round(exp(log d) * scale), 1) on valid phonemes; pitch and energy
quantised into bins whose embeddings are added to the length-regulated
encoding) -> the autoregressive decoder (prenet, sinusoidal positions, 6
post-norm layers of causal self-attention over the frames so far,
cross-attention over the regulated encoding, FFN; a mel projection fed back
as the next input, from a zero frame) -> the vocoder a model's reference
passes as `vocode` (the HiFi-GAN generator's is `hifigan`).

The batch and stream entry points apply the system's documented bucket
rules (frontend.py), since padding is part of what a call computes: the
phoneme bucket decides what the predictors' convolutions see past a text's
end, and the frame bucket where the vocoder's convolutions zero-pad.
"""

from __future__ import annotations

import math
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import frontend
from .generator import generator

NEG_INF = -1e9
Vocode = Callable[[torch.Tensor], torch.Tensor]


def lin(P, name, x, q):
    return F.linear(q(x), q(P[name + ".weight"]), P[name + ".bias"])


def norm(P, name, x):
    return F.layer_norm(x, (x.shape[-1],), P[name + ".weight"], P[name + ".bias"], 1e-5)


def attention(P, name, xq, xkv, heads, q, key_pad=None):
    Q, K, V = (lin(P, f"{name}.w{n}", x, q) for n, x in (("q", xq), ("k", xkv), ("v", xkv)))
    b, t, d = Q.shape
    dh = d // heads
    Q, K, V = (x.reshape(b, -1, heads, dh) for x in (Q, K, V))
    s = torch.einsum("bthd,bshd->bhts", q(Q), q(K)) / math.sqrt(dh)
    if key_pad is not None:
        s = s.masked_fill(key_pad[:, None, None, :], NEG_INF)
    out = torch.einsum("bhts,bshd->bthd", q(torch.softmax(s, dim=-1)), q(V))
    return lin(P, name + ".wo", out.reshape(b, t, d), q)


def predictor(P, name, h, c, q):
    x = h
    k = c["predictor_kernel_size"]
    for i in range(c["predictor_layers"]):
        w, bias = P[f"{name}.convs.{i}.weight"], P[f"{name}.convs.{i}.bias"]
        y = F.conv1d(q(x.transpose(1, 2)), q(w), bias, padding=(k - 1) // 2).transpose(1, 2)
        x = norm(P, f"{name}.norms.{i}", torch.relu(y)) + x
    return lin(P, name + ".linear", x, q).squeeze(-1)


def quantize(v, n_bins, lo, hi, eps):
    v = (torch.clamp(v, lo, hi) - lo) / (hi - lo + eps)
    return torch.clamp((v * (n_bins - 1)).to(torch.int32), 0, n_bins - 1).long()


def encode(P, c, ph, tone, bound, lengths, frames, q):
    """ids [B, Tph] (bucket-padded) -> (hvar [B, frames, d], frame mask,
    totals [B])."""
    pe = "phoneme_embedding."
    h = (P[pe + "ph_emb.weight"][ph] + P[pe + "tone_emb.weight"][tone]
         + P[pe + "boundary_emb.weight"][bound])
    pmask = torch.arange(ph.shape[1], device=ph.device)[None, :] < lengths[:, None]
    for l in range(c["encoder_layers"]):
        p = f"bert_encoder.layers.{l}"
        h = norm(P, p + ".norm1", h + attention(P, p + ".self_attn", h, h, c["encoder_heads"],
                                                q, ~pmask))
        ff = lin(P, p + ".ffn.linear2", torch.relu(lin(P, p + ".ffn.linear1", h, q)), q)
        h = norm(P, p + ".norm2", h + ff)
    h = norm(P, "bert_encoder.final_norm", h)
    va = "variance_adaptor."
    log_dur = predictor(P, va + "duration_predictor", h, c, q)
    dur = torch.clamp(torch.round(torch.exp(log_dur)), min=1).long() * pmask.long()
    pitch = predictor(P, va + "pitch_predictor", h, c, q)
    energy = predictor(P, va + "energy_predictor", h, c, q)
    b, d = h.shape[0], h.shape[2]
    hvar = h.new_zeros(b, frames, d)
    totals = dur.sum(dim=1)
    for r in range(b):
        idx = torch.repeat_interleave(torch.arange(ph.shape[1], device=h.device), dur[r])[:frames]
        n = idx.numel()
        pb = quantize(pitch[r, idx], c["pitch_bins"], c["pitch_min"], c["pitch_max"], 0.0)
        eb = quantize(energy[r, idx], c["energy_bins"], c["energy_min"], c["energy_max"], 1e-8)
        hvar[r, :n] = (h[r, idx] + P[va + "pitch_emb.weight"][pb]
                       + P[va + "energy_emb.weight"][eb])
    fmask = torch.arange(frames, device=h.device)[None, :] < totals[:, None]
    return hvar, fmask, totals


def positions(n: int, d: int, device) -> torch.Tensor:
    pe = np.zeros((n, d), np.float32)
    pos = np.arange(n, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float32) * (-np.log(10000.0) / d))
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return torch.from_numpy(pe).to(device)


def decode(P, c, hvar, fmask, steps: int, q) -> torch.Tensor:
    """The autoregressive decode of `steps` frames -> mel [B, steps, n_mels]."""
    b, s, d = hvar.shape
    L, heads = c["decoder_layers"], c["decoder_heads"]
    dh = d // heads
    dec = "ar_decoder."
    lay = [f"{dec}layers.{l}" for l in range(L)]
    mem_k = [q(lin(P, p + ".cross_attn.wk", hvar, q)).reshape(b, s, heads, dh) for p in lay]
    mem_v = [q(lin(P, p + ".cross_attn.wv", hvar, q)).reshape(b, s, heads, dh) for p in lay]
    bias = torch.where(fmask, 0.0, NEG_INF)[:, None, :]
    pe = positions(steps, d, hvar.device)
    kc = hvar.new_zeros(L, b, steps, heads, dh)
    vc = torch.zeros_like(kc)
    prev = hvar.new_zeros(b, c["n_mels"])
    out = hvar.new_zeros(b, steps, c["n_mels"])
    for t in range(steps):
        x = lin(P, dec + "prenet2", torch.relu(lin(P, dec + "prenet1", prev, q)), q) + pe[t]
        for l, p in enumerate(lay):
            sa = p + ".self_attn"
            kc[l, :, t] = q(lin(P, sa + ".wk", x, q)).reshape(b, heads, dh)
            vc[l, :, t] = q(lin(P, sa + ".wv", x, q)).reshape(b, heads, dh)
            qt = q(lin(P, sa + ".wq", x, q).reshape(b, heads, dh) / math.sqrt(dh))
            w = torch.softmax(torch.einsum("bhd,bshd->bhs", qt, kc[l, :, :t + 1]), dim=-1)
            o = torch.einsum("bhs,bshd->bhd", q(w), vc[l, :, :t + 1]).reshape(b, d)
            x = norm(P, p + ".norm1", x + lin(P, sa + ".wo", o, q))
            ca = p + ".cross_attn"
            qc = q(lin(P, ca + ".wq", x, q).reshape(b, heads, dh) / math.sqrt(dh))
            w = torch.softmax(torch.einsum("bhd,bshd->bhs", qc, mem_k[l]) + bias, dim=-1)
            o = torch.einsum("bhs,bshd->bhd", q(w), mem_v[l]).reshape(b, d)
            x = norm(P, p + ".norm2", x + lin(P, ca + ".wo", o, q))
            ff = lin(P, p + ".ffn.linear2", torch.relu(lin(P, p + ".ffn.linear1", x, q)), q)
            x = norm(P, p + ".norm3", x + ff)
        prev = lin(P, dec + "mel_proj", x, q)
        out[:, t] = prev
    return out


def _ids(texts, c, device):
    tph = frontend.pick_bucket(max(frontend.phoneme_count(t) for t in texts),
                               c["phoneme_buckets"])
    ph, tone, bound, lengths = frontend.batch_ids(texts, c["vocab_size"], c["tone_size"], tph)
    return tph, [torch.from_numpy(a).to(device) for a in (ph, tone, bound, lengths)]


def acoustic(P, c, texts: Sequence[str], q, device):
    """texts -> (mel [B, frames, n_mels] zero past each total, totals [B],
    frames): the frame bucket of a one-shot call, and its one re-run when
    the first bucket overflows."""
    tph, ids = _ids(texts, c, device)
    frames = frontend.initial_frames(tph, c)
    hvar, fmask, totals = encode(P, c, *ids, frames, q)
    refit = frontend.refit_frames(int(totals.max()), frames, c)
    if refit != frames:
        frames = refit
        hvar, fmask, totals = encode(P, c, *ids, frames, q)
    steps = int(totals.clamp(max=frames).max())
    mel = hvar.new_zeros(len(texts), frames, c["n_mels"])
    mel[:, :steps] = decode(P, c, hvar, fmask, steps, q)
    return mel * fmask[:, :, None], totals.clamp(max=frames), frames


def hifigan(P_gen, c, q) -> Vocode:
    """The HiFi-GAN generator of `P_gen` as a `vocode`."""
    return lambda mel: generator(P_gen, "", mel, c, q)


@torch.no_grad()
def synthesize_batch(P_ac, vocode: Vocode, c, texts, q, device) -> List[np.ndarray]:
    """One-shot call: each text's wav, trimmed to its frames; `vocode` maps
    mel [B, n_mels, T] to wav [B, 1, T * hop]."""
    mel, totals, _ = acoustic(P_ac, c, texts, q, device)
    wav = vocode(mel.transpose(1, 2))[:, 0]
    hop = c["hop_length"]
    return [wav[i, :int(totals[i]) * hop].cpu().numpy() for i in range(len(texts))]


@torch.no_grad()
def stream_chunks(P_ac, vocode: Vocode, c, texts, chunk: int, context: int, q,
                  device) -> List[List[np.ndarray]]:
    """Each text's stream as its chunks: the text alone at its own bucket,
    every chunk of `chunk` frames vocoded from a window of `context` frames
    each side that stops at the bucket's end, frames past the total zero.
    `vocode` as `synthesize_batch` takes it."""
    hop = c["hop_length"]
    out = []
    for text in texts:
        mel, totals, frames = acoustic(P_ac, c, [text], q, device)
        total = int(totals[0])
        chunks = []
        for start in range(0, total, chunk):
            lo = max(0, start - context)
            n = min(chunk + 2 * context, frames - lo)
            wav = vocode(mel[:, lo:lo + n].transpose(1, 2))[0, 0]
            s = (start - lo) * hop
            chunks.append(wav[s:s + min(chunk, total - start) * hop].cpu().numpy())
        out.append(chunks)
    return out


def wav_gaps(got: Sequence[np.ndarray], want: Sequence[np.ndarray]) -> Tuple[int, float, float]:
    """(how many outputs differ in length; over those that do not, the
    widest gap |got - want| of any sample, in full-scale units, and the
    largest relative error of the content: each wav with its mean taken
    out, ||got' - want'|| / ||want'||, so that a fault in the content
    cannot hide under the constant offset that random weights give)."""
    mismatched, widest, worst = 0, 0.0, 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            mismatched += 1
            continue
        g, w = g.astype(np.float64), w.astype(np.float64)
        d = g - w
        widest = max(widest, float(np.abs(d).max()) if d.size else 0.0)
        ac = w - w.mean() if w.size else w
        d_ac = d - d.mean() if d.size else d
        worst = max(worst, float(np.linalg.norm(d_ac)) / max(float(np.linalg.norm(ac)), 1e-30))
    return mismatched, widest, worst
