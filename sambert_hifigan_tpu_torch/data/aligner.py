"""Learned forced alignment: phoneme durations from the data itself, the
port of the JAX package's `data/aligner.py`.

  1. A small conv CTC model is trained on the training corpus itself
     (mel [T, n_mels] -> per-frame phoneme posteriors) with the CTC loss:
     a one-shot preprocessing step, on bucket-padded batches.
  2. Durations are read off a blank-free monotonic Viterbi pass through
     each utterance's label sequence: every phoneme gets >= 1 frame and the
     durations sum exactly to the utterance's frame count, the length
     regulator's contract.

Against optax: `F.ctc_loss` takes log-probabilities [T, B, C] and lengths
where `optax.ctc_loss` takes logits and paddings (1.0 = padded) and applies
the log-softmax itself; the port applies it.  An alignment that cannot fit
(more labels, with the blanks that repeats need, than frames) costs
`F.ctc_loss` `inf`, and optax a large finite value from its stand-in for
log(0) (log_epsilon = -1e5), whose gradient then leads the batch.  Such
rows, found on the host from the lengths, take `optax_ctc_loss`, a plain
torch copy of optax's forward recursion; the others keep `F.ctc_loss`.
optax.adamw's weight decay
defaults to 1e-4 (torch's AdamW to 1e-2): it is passed.  The CUDA CTC
backward accumulates with atomics, so card and CPU agree within rounding,
not bit for bit.  The Viterbi decode is host numpy: offline preprocessing,
O(T * N) per utterance, on no training or serving path.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import resolve_device
from ..models.layers import Conv1d, LayerNorm, Linear, init_defaults_

ADAMW_WEIGHT_DECAY = 1e-4  # optax.adamw's default


# The CTC blank is a dedicated class at index vocab_size, not an id of the
# front end: ' ' maps to PAD_ID == 0, so id 0 can appear in label sequences.
def blank_id(vocab_size: int) -> int:
    return vocab_size


class CTCAlignerNet(nn.Module):
    """mel [B, T, n_mels] -> framewise logits [B, T, vocab + 1] (the extra
    class is the CTC blank)."""

    def __init__(self, vocab_size: int = 300, n_mels: int = 80, d_model: int = 192,
                 n_layers: int = 3, kernel_size: int = 5):
        super().__init__()
        pad = (kernel_size - 1) // 2
        self.conv_in = Conv1d(n_mels, d_model, kernel_size, padding=pad)
        self.convs = nn.ModuleList(
            Conv1d(d_model, d_model, kernel_size, padding=pad) for _ in range(n_layers))
        self.norms = nn.ModuleList(LayerNorm(d_model) for _ in range(n_layers))
        self.proj = Linear(d_model, vocab_size + 1)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.conv_in(mel.transpose(1, 2))).transpose(1, 2)  # [B, T, d]
        for conv, norm in zip(self.convs, self.norms):
            y = torch.relu(conv(x.transpose(1, 2))).transpose(1, 2)
            x = x + norm(y)
        return self.proj(x)


def _bucket(n: int, granularity: int) -> int:
    return ((n + granularity - 1) // granularity) * granularity


def _pad_batch(
    mels: Sequence[np.ndarray],
    labels: Sequence[np.ndarray],
    frame_gran: int,
    label_gran: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(mel [B, T, n_mels], labels [B, N], mel_padding [B, T], label_padding
    [B, N]), T and N padded to multiples of the granularities; paddings
    are 1.0 where padded (optax's convention)."""
    t = _bucket(max(m.shape[0] for m in mels), frame_gran)
    n = _bucket(max(len(lab) for lab in labels), label_gran)
    b = len(mels)
    mel_pad = np.zeros((b, t, mels[0].shape[1]), np.float32)
    lab_pad = np.zeros((b, n), np.int32)
    mel_padding = np.ones((b, t), np.float32)
    lab_padding = np.ones((b, n), np.float32)
    for i, (m, lab) in enumerate(zip(mels, labels)):
        mel_pad[i, : m.shape[0]] = m
        lab_pad[i, : len(lab)] = lab
        mel_padding[i, : m.shape[0]] = 0.0
        lab_padding[i, : len(lab)] = 0.0
    return mel_pad, lab_pad, mel_padding, lab_padding


def infeasible_rows(labels: np.ndarray, label_len: np.ndarray,
                    frames: np.ndarray) -> np.ndarray:
    """[B] bool: rows whose labels, with a blank between each adjacent
    repeat, need more frames than they have."""
    need = np.array([n + int((lab[:n][1:] == lab[:n][:-1]).sum())
                     for lab, n in zip(labels, label_len)])
    return need > frames


def optax_ctc_loss(log_probs: torch.Tensor, labels: torch.Tensor,
                   logit_paddings: torch.Tensor, label_paddings: torch.Tensor,
                   blank: int, log_epsilon: float = -1e5) -> torch.Tensor:
    """optax.ctc_loss's forward recursion [B] on log-probabilities [B, T, K]
    (its log-softmax applied), labels [B, N] and paddings (1.0 = padded),
    with the same stand-in for log(0).  Differentiable; one step per frame."""
    b, t_len, _ = log_probs.shape
    n = labels.shape[1]
    label_len = n - label_paddings.sum(dim=1).long()
    repeat = F.pad((labels[:, :-1] == labels[:, 1:]).float(), (0, 1))  # [B, N]
    lp_phi = log_probs[:, :, blank]  # [B, T]
    lp_emit = torch.gather(log_probs, 2, labels.long()[:, None, :].expand(b, t_len, n))
    dev = log_probs.device
    phi = torch.full((b, n + 1), log_epsilon, device=dev)
    phi[:, 0] = 0.0
    emit = torch.full((b, n), log_epsilon, device=dev)

    def update_phi(phi, added):  # phi[:, 1:] += added, in log space
        return torch.cat([phi[:, :1], torch.logaddexp(phi[:, 1:], added)], dim=-1)

    for t in range(t_len):
        prev_phi = update_phi(phi, emit + log_epsilon * repeat)  # emit -> phi
        e, ph = lp_emit[:, t], lp_phi[:, t:t + 1]
        next_emit = torch.logaddexp(prev_phi[:, :-1] + e, emit + e)
        next_phi = update_phi(prev_phi + ph, emit + ph + log_epsilon * (1.0 - repeat))
        pad = logit_paddings[:, t:t + 1]
        emit = pad * emit + (1.0 - pad) * next_emit
        phi = pad * phi + (1.0 - pad) * next_phi
    last = update_phi(phi, emit)
    return -torch.gather(last, 1, label_len[:, None])[:, 0]


def ctc_losses(net: CTCAlignerNet, mel: torch.Tensor, labels: torch.Tensor,
               mel_padding: torch.Tensor, label_padding: torch.Tensor,
               vocab_size: int) -> torch.Tensor:
    """Per-example CTC negative log-likelihood [B] of a padded batch, as
    optax.ctc_loss gives it: `F.ctc_loss` on the rows that can align,
    `optax_ctc_loss` on those that cannot."""
    log_probs = F.log_softmax(net(mel).float(), dim=-1)  # [B, T, C]
    mel_len = (mel_padding == 0).sum(dim=-1)
    lab_len = (label_padding == 0).sum(dim=-1)
    blank = blank_id(vocab_size)
    bad = infeasible_rows(labels.cpu().numpy(), lab_len.cpu().numpy(), mel_len.cpu().numpy())
    if not bad.any():
        return F.ctc_loss(log_probs.transpose(0, 1), labels.long(), mel_len, lab_len,
                          blank=blank, reduction="none")
    dev = log_probs.device
    rows = {flag: torch.as_tensor(np.flatnonzero(bad == flag), device=dev)
            for flag in (False, True)}
    out = torch.zeros(len(bad), device=dev).index_copy(
        0, rows[True], optax_ctc_loss(log_probs[rows[True]], labels[rows[True]],
                                      mel_padding[rows[True]], label_padding[rows[True]],
                                      blank))
    if len(rows[False]):
        g = rows[False]
        out = out.index_copy(0, g, F.ctc_loss(log_probs[g].transpose(0, 1), labels[g].long(),
                                              mel_len[g], lab_len[g], blank=blank,
                                              reduction="none"))
    return out


def aligner_loss(net, mel, labels, mel_padding, label_padding, vocab_size) -> torch.Tensor:
    """The training objective: the mean over the batch of each example's
    CTC loss over its frame count."""
    frames = (1.0 - mel_padding).sum(dim=-1).clamp(min=1.0)
    return (ctc_losses(net, mel, labels, mel_padding, label_padding, vocab_size)
            / frames).mean()


def make_aligner_optimizer(net: CTCAlignerNet, learning_rate: float) -> torch.optim.AdamW:
    return torch.optim.AdamW(net.parameters(), lr=learning_rate,
                             weight_decay=ADAMW_WEIGHT_DECAY)


def aligner_step(net, opt, batch, vocab_size: int) -> torch.Tensor:
    """One AdamW step on a padded batch of tensors (mel, labels,
    mel_padding, label_padding); returns the loss (0-dim, on the device)."""
    opt.zero_grad(set_to_none=True)
    loss = aligner_loss(net, *batch, vocab_size)
    loss.backward()
    opt.step()
    return loss.detach()


def train_ctc_aligner(
    samples: Sequence[Tuple[np.ndarray, np.ndarray]],  # (mel [T, n_mels], ph [N])
    vocab_size: int = 300,
    n_mels: int = 80,
    steps: int = 400,
    batch_size: int = 8,
    learning_rate: float = 2e-3,
    seed: int = 0,
    d_model: int = 192,
    n_layers: int = 3,
    frame_gran: int = 64,
    label_gran: int = 8,
    device=None,
) -> Tuple[CTCAlignerNet, List[float]]:
    """Train the corpus aligner on `device` (default: the card); returns
    (net, loss history).  Batches are the JAX package's draws from
    np.random.default_rng(seed); the weights are torch's default init from
    torch.Generator().manual_seed(seed)."""
    device = resolve_device(device)
    net = CTCAlignerNet(vocab_size, n_mels, d_model, n_layers)
    init_defaults_(net, torch.Generator().manual_seed(seed))
    net = net.to(device).train()
    opt = make_aligner_optimizer(net, learning_rate)
    rng = np.random.default_rng(seed)
    losses = []
    n = len(samples)
    for _ in range(steps):
        idx = rng.choice(n, size=min(batch_size, n), replace=n < batch_size)
        batch = _pad_batch([samples[j][0] for j in idx], [samples[j][1] for j in idx],
                           frame_gran, label_gran)
        losses.append(aligner_step(net, opt, [torch.from_numpy(a).to(device) for a in batch],
                                   vocab_size))
    history = torch.stack(losses).cpu().tolist() if losses else []  # one sync, at the end
    return net.eval(), history


def viterbi_durations(log_probs: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """Blank-free monotonic Viterbi segmentation.

    log_probs [T, K] (log-softmax over classes), labels [N] ints.
    Returns dur [N] int32 with dur >= 1 everywhere and sum(dur) == T.

    DP over (frame t, label n): at each frame the path either stays on the
    current label or advances to the next; every label must be visited.
    """
    lp = np.asarray(log_probs, np.float64)
    labels = np.asarray(labels)
    t_len, n_len = lp.shape[0], labels.shape[0]
    if n_len > t_len:
        raise ValueError(f"{n_len} labels cannot align to {t_len} frames")
    emit = lp[:, labels]  # [T, N]
    neg = -1e18
    dp = np.full((t_len, n_len), neg)
    back = np.zeros((t_len, n_len), np.int8)  # 1 = came from n-1
    dp[0, 0] = emit[0, 0]
    for t in range(1, t_len):
        # feasibility window: n <= t and n >= N - (T - t)
        n_lo = max(0, n_len - (t_len - t))
        n_hi = min(t, n_len - 1)
        stay = dp[t - 1, n_lo: n_hi + 1]
        adv = np.full_like(stay, neg)
        if n_lo == 0:
            adv[1:] = dp[t - 1, n_lo: n_hi]
        else:
            adv[:] = dp[t - 1, n_lo - 1: n_hi]
        better = adv > stay
        dp[t, n_lo: n_hi + 1] = np.where(better, adv, stay) + emit[t, n_lo: n_hi + 1]
        back[t, n_lo: n_hi + 1] = better
    dur = np.zeros(n_len, np.int32)
    n = n_len - 1
    for t in range(t_len - 1, -1, -1):
        dur[n] += 1
        if t > 0 and back[t, n]:
            n -= 1
    if not (n == 0 and dur.sum() == t_len and (dur >= 1).all()):
        raise ValueError(
            f"viterbi backtrack violated the duration contract "
            f"(n={n}, sum={int(dur.sum())}, T={t_len})"
        )
    return dur


def nonblank_log_posteriors(logits: np.ndarray) -> np.ndarray:
    """log p(class | frame, not blank): CTC models are blank-peaky, so the
    blank-free Viterbi runs on posteriors renormalised over the non-blank
    classes (CTC-segmentation practice).  The blank is the last column."""
    x = np.asarray(logits, np.float64)[:, :-1]  # drop the blank class
    x = x - x.max(axis=1, keepdims=True)
    lse = np.log(np.exp(x).sum(axis=1, keepdims=True))
    return x - lse


@torch.no_grad()
def ctc_durations(net: CTCAlignerNet, mel: np.ndarray, ph_ids: np.ndarray) -> np.ndarray:
    """Align one utterance: mel [T, n_mels], ph_ids [N] -> dur [N],
    sum(dur) == T, dur >= 1."""
    device = next(net.parameters()).device
    logits = net(torch.tensor(mel, dtype=torch.float32, device=device)[None])[0]
    return viterbi_durations(nonblank_log_posteriors(logits.float().cpu().numpy()), ph_ids)
