"""Static-shape length regulator: a cumsum and a `<=`-count instead of a
per-sample repeat_interleave.

  cum[b, j] = sum_{i<=j} dur[b, i]
  frame t of sample b belongs to phoneme  idx[b, t] = #{j : cum[b, j] <= t}
  out[b, t] = h[b, idx[b, t]]          for t < cum[b, -1]
  out[b, t] = 0                         otherwise (mask)

`dur = 0` phonemes emit no frames; indices are clamped to Tph - 1.
"""

from __future__ import annotations

from typing import Tuple

import torch


def regulate_indices(
    dur: torch.Tensor, max_frames: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dur [B, Tph] int -> (idx [B, max_frames] int64, mask [B, max_frames]
    bool, total [B] int32)."""
    dur = torch.clamp(dur.to(torch.int32), min=0)
    cum = torch.cumsum(dur, dim=1, dtype=torch.int32)  # [B, Tph]
    total = cum[:, -1]
    t = torch.arange(max_frames, dtype=torch.int32, device=dur.device)
    idx = (cum[:, None, :] <= t[None, :, None]).sum(dim=-1)
    mask = t[None, :] < total[:, None]
    idx = torch.clamp(idx, max=dur.shape[1] - 1)
    return idx, mask, total


def gather_frames(h: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Gather [B, Tph(, d)] along the phoneme axis with precomputed indices,
    zeroing frames outside the mask."""
    if h.dim() == 3:
        out = torch.gather(h, 1, idx[:, :, None].expand(-1, -1, h.shape[-1]))
        return out * mask[:, :, None].to(h.dtype)
    return torch.gather(h, 1, idx) * mask.to(h.dtype)
