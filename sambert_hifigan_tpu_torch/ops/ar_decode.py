"""K1: the autoregressive mel decode, T steps x L layers, in one launch.

`ar_decode_chunk` is the wrapper: it decodes `steps` frames from position
`pos0` and a carry `(prev_mel, k_cache, v_cache)` (`init_carry`, the JAX
package's `init_packed_carry`), so a stream decodes chunk by chunk; the
one-shot `ar_decode` is the single chunk `pos0 = 0, steps = T` from a fresh
carry.  Optional `lengths` (int32 [B] on the decode's device) give the
frames each row keeps: a row does no work at or past its length, its frames
there are 0 and its cache rows there are not written, and a launch stops at
its longest row.  Every kept frame has the bits of the decode without
lengths, and the host never reads them.  A CUDA tensor goes to the
hand-written kernel in `csrc/ar_decode.cu`
(or the call raises); a CPU tensor goes to `ar_decode_plain`, the same
function in plain PyTorch.  There is no switch and no fallback.  The kernel
is one launch for the whole batch on thread-block clusters; `launch_plan`
computes its geometry on the host (the C code refuses a plan that does not
match its own layout), `pack_stream` lays out each CTA's weight slices, and
a cluster the card cannot schedule raises RuntimeError.  The plan spreads
the batch's rows over as many clusters as the card runs at once
(`co_resident_clusters`, asked once per process and device), a few rows
each, rather than packing them into as few as fit: the decode is
latency-bound, and a cluster's step costs with the rows it carries.

Numerics (the contract of the JAX package's Pallas kernel, which this
replaces): matmul inputs and weights bf16 with f32 accumulation, biases,
LayerNorm and softmax in f32, q scaled by 1/sqrt(dh) before its bf16 cast,
each q*k product rounded to bf16 before the f32 sum over the head (the
Pallas kernel's `(keys * q).astype(bf16)` ahead of its head-group matmul),
softmax probabilities cast to bf16 before the value product, bf16 K/V caches
and memory K/V, and a zero frame before step 0.  The residual stream stays
f32.  Given float32 weights the plain version rounds nowhere and is the packed
decode step of the JAX package in f32.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from .. import kernels, tracing

launches = 0  # kernel launches through `ar_decode_chunk` (never the plain version)

NEG_INF = -1e9


class DecodeWeights(NamedTuple):
    """Decoder weights packed once per pipeline: matrices [in, out] in the
    kernel dtype (bf16 on the card), per-layer tensors stacked on a leading L
    axis, self-attention Q/K/V fused into one [L, d, 3d] matrix; biases,
    LayerNorm affine ([L, 3, 2, d]: norm, scale/bias) and the positional
    table in f32."""

    prenet_w1: torch.Tensor  # [n_mels, d]
    prenet_b1: torch.Tensor
    prenet_w2: torch.Tensor  # [d, d]
    prenet_b2: torch.Tensor
    wqkv: torch.Tensor  # [L, d, 3d]
    bqkv: torch.Tensor  # [L, 3d]
    wo: torch.Tensor  # [L, d, d]
    bo: torch.Tensor
    wcq: torch.Tensor
    bcq: torch.Tensor
    wco: torch.Tensor
    bco: torch.Tensor
    w1: torch.Tensor  # [L, d, ff]
    b1: torch.Tensor  # [L, ff]
    w2: torch.Tensor  # [L, ff, d]
    b2: torch.Tensor
    ln: torch.Tensor  # [L, 3, 2, d]
    mel_w: torch.Tensor  # [d, n_mels]
    mel_b: torch.Tensor
    pe: torch.Tensor  # [max_len, d]
    n_heads: int
    stream: Optional[torch.Tensor] = None  # pack_stream(...) for the kernel, bf16 only

    @property
    def matrices(self):
        return (self.prenet_w1, self.prenet_w2, self.wqkv, self.wo, self.wcq,
                self.wco, self.w1, self.w2, self.mel_w)

    @property
    def vectors(self):
        return (self.prenet_b1, self.prenet_b2, self.bqkv, self.bo, self.bcq,
                self.bco, self.b1, self.b2, self.ln, self.mel_b, self.pe)


def pack_stream(w: DecodeWeights, cluster: int) -> torch.Tensor:
    """The kernel's weight stream: [cluster, n] in the weights' dtype, row
    `rank` holding that CTA's slice of every matrix in the order one step
    reads them (prenet1, prenet2, per layer wqkv, wo, wcq, wco, w1, then w2's
    K rows, mel), each slice [K, n] as [K/16][n/8][16][8] (the 16 x 8 tiles
    of mma.sync's B operand, each 256 contiguous bytes, so ldmatrix reads
    them without bank conflicts), so that every chunk of 16-row steps the CTA
    copies is contiguous; rows zero-padded to one length."""
    d, d_ff, n_mels = w.prenet_w2.shape[0], w.w1.shape[-1], w.mel_w.shape[1]
    rows = []
    for rank in range(cluster):
        parts = []

        def tiles(m):
            k, n = m.shape
            parts.append(m.reshape(k // 16, 16, n // 8, 8).transpose(1, 2).reshape(-1))

        def cols(m, n):
            a, b = _col_split(n, rank, cluster)
            tiles(m[:, a:b])

        cols(w.prenet_w1, d)
        cols(w.prenet_w2, d)
        for l in range(w.wqkv.shape[0]):
            cols(w.wqkv[l], 3 * d)
            for m in (w.wo, w.wcq, w.wco):
                cols(m[l], d)
            cols(w.w1[l], d_ff)
            tiles(w.w2[l][rank * d_ff // cluster:(rank + 1) * d_ff // cluster])
        cols(w.mel_w, n_mels)
        rows.append(torch.cat(parts))
    out = torch.zeros(cluster, max(len(r) for r in rows), dtype=w.wqkv.dtype,
                      device=w.wqkv.device)
    for rank, r in enumerate(rows):
        out[rank, :len(r)] = r
    return out


class DecodeCarry(NamedTuple):
    """What one chunk of the decode hands the next: the last frame and the
    self-attention caches, whose length T is the capacity (the frame
    bucket).  A chunk updates the caches in place; the carry it was given
    is consumed."""

    prev_mel: torch.Tensor  # [B, n_mels] f32, zero before the first step
    k_cache: torch.Tensor  # [L, B, T, d] in the weights' dtype
    v_cache: torch.Tensor


def init_carry(w: DecodeWeights, batch: int, max_len: int) -> DecodeCarry:
    """The carry before step 0, on the weights' device: a zero frame and
    zeroed caches of capacity `max_len`."""
    n_layers, d = w.wqkv.shape[:2]
    cache = torch.zeros(n_layers, batch, max_len, d, dtype=w.wqkv.dtype, device=w.wqkv.device)
    return DecodeCarry(torch.zeros(batch, w.mel_w.shape[1], device=w.wqkv.device), cache,
                       torch.zeros_like(cache))


def ar_decode(
    w: DecodeWeights,
    mem_k: torch.Tensor,  # [L, B, S, d], the kernel dtype
    mem_v: torch.Tensor,
    mem_bias: torch.Tensor,  # [B, S] f32: 0 on frames, -1e9 on padding
    max_len: int,
    lengths: Optional[torch.Tensor] = None,  # [B] int32: the frames each row keeps
    plan: Optional["Plan"] = None,
) -> torch.Tensor:
    """Decode `max_len` frames from a zero start frame -> mel [B, max_len,
    n_mels] f32: one chunk over a fresh carry."""
    carry = init_carry(w, mem_k.shape[1], max_len)
    return ar_decode_chunk(w, mem_k, mem_v, mem_bias, carry, 0, max_len, lengths, plan)[1]


def ar_decode_chunk(
    w: DecodeWeights,
    mem_k: torch.Tensor,
    mem_v: torch.Tensor,
    mem_bias: torch.Tensor,
    carry: DecodeCarry,
    pos0: int,
    steps: int,
    lengths: Optional[torch.Tensor] = None,
    plan: Optional["Plan"] = None,
) -> Tuple[DecodeCarry, torch.Tensor]:
    """Decode steps pos0 .. pos0 + steps - 1 from `carry` -> (carry', mel
    [B, steps, n_mels] f32).  Chained chunks give the bits of one decode.
    With `lengths`, frames at or past a row's length are 0 (and so is the
    carried frame of a finished row).  `plan` is the kernel's launch plan,
    by default `card_plan`'s (the kernel refuses one that does not match its
    layout); the plain version has none."""
    cap = carry.k_cache.shape[2]
    if pos0 < 0 or steps < 1 or pos0 + steps > cap:
        raise ValueError(f"ar_decode_chunk: steps [{pos0}, {pos0 + steps}) outside the "
                         f"carry's capacity [0, {cap})")
    if mem_k.device.type == "cpu":
        return ar_decode_plain(w, mem_k, mem_v, mem_bias, carry, pos0, steps, lengths)
    if mem_k.device.type != "cuda":
        raise ValueError(f"ar_decode: unsupported device {mem_k.device}")
    return _ar_decode_cuda(w, mem_k, mem_v, mem_bias, carry, pos0, steps, lengths, plan)


def _rounder(dtype: torch.dtype):
    if dtype == torch.bfloat16:
        return lambda t: t.to(torch.bfloat16).float()
    if dtype == torch.float32:
        return lambda t: t
    raise ValueError(f"unsupported decode weight dtype {dtype}")


def _layer_norm(x: torch.Tensor, scale_bias: torch.Tensor, eps: float = 1e-5):
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.square(x - mean).mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale_bias[0] + scale_bias[1]


def _scores(q: torch.Tensor, keys: torch.Tensor, rnd) -> torch.Tensor:
    """q [B, H, dh] . keys [B, S, H, dh] -> [B, H, S], each product rounded
    (bf16 in the kernel's numerics) before the f32 sum over dh."""
    return rnd(q[:, None] * keys).sum(-1).transpose(1, 2)


def ar_decode_plain(w, mem_k, mem_v, mem_bias, carry: DecodeCarry, pos0: int, steps: int,
                    lengths: Optional[torch.Tensor] = None) -> Tuple[DecodeCarry, torch.Tensor]:
    """Plain PyTorch version of K1: the packed per-frame step in a Python
    loop over steps pos0 .. pos0 + steps - 1, rounding where the kernel
    rounds when the weights are bf16.  The caches hold each K/V row in the
    weights' dtype (bf16 rows are already rounded) and are updated in
    place.  With `lengths` the loop stops at the longest row; a row's
    frames at or past its length are 0 and its cache rows there are left
    as they were."""
    rnd = _rounder(w.wqkv.dtype)
    L, b, s, d = mem_k.shape
    h = w.n_heads
    dh = d // h
    sq = math.sqrt(dh)
    f = lambda t: t.float()  # noqa: E731
    mk = mem_k.float().reshape(L, b, s, h, dh)
    mv = mem_v.float().reshape(L, b, s, h, dh)
    prev, ck, cv = carry
    bias = mem_bias.float()[:, None, :]
    out = torch.zeros(b, steps, w.mel_w.shape[1], device=mem_k.device)
    end = pos0 + steps
    if lengths is not None:
        end = max(pos0, min(end, int(lengths.max())))

    def keep(t, new, old):  # a finished row keeps what it had
        return new if lengths is None else torch.where((t < lengths)[:, None], new, old)

    for t in range(pos0, end):
        x = torch.relu(rnd(prev) @ f(w.prenet_w1) + w.prenet_b1)
        x = rnd(x) @ f(w.prenet_w2) + w.prenet_b2 + w.pe[t]
        for l in range(L):
            qkv = rnd(x) @ f(w.wqkv[l]) + w.bqkv[l]
            q, k_t, v_t = qkv.split(d, dim=-1)
            ck[l, :, t] = keep(t, rnd(k_t), ck[l, :, t].float())
            cv[l, :, t] = keep(t, rnd(v_t), cv[l, :, t].float())
            qs = rnd(q / sq).reshape(b, h, dh)
            sc = _scores(qs, ck[l, :, : t + 1].float().reshape(b, t + 1, h, dh), rnd)
            p = rnd(torch.softmax(sc, dim=-1))
            sa = torch.einsum("bhs,bshd->bhd", p,
                              cv[l, :, : t + 1].float().reshape(b, t + 1, h, dh)).reshape(b, d)
            x = _layer_norm(x + rnd(sa) @ f(w.wo[l]) + w.bo[l], w.ln[l, 0])
            cq = rnd((rnd(x) @ f(w.wcq[l]) + w.bcq[l]) / sq).reshape(b, h, dh)
            cs = _scores(cq, mk[l], rnd) + bias
            cp = rnd(torch.softmax(cs, dim=-1))
            ca = torch.einsum("bhs,bshd->bhd", cp, mv[l]).reshape(b, d)
            x = _layer_norm(x + rnd(ca) @ f(w.wco[l]) + w.bco[l], w.ln[l, 1])
            hid = torch.relu(rnd(x) @ f(w.w1[l]) + w.b1[l])
            x = _layer_norm(x + rnd(hid) @ f(w.w2[l]) + w.b2[l], w.ln[l, 2])
        prev = rnd(x) @ f(w.mel_w) + w.mel_b
        out[:, t - pos0] = keep(t, prev, out[:, t - pos0])
    return DecodeCarry(out[:, -1], ck, cv), out


class Plan(NamedTuple):
    """K1's launch plan: `groups` thread-block clusters of `cluster` CTAs,
    each decoding `rows` batch rows (the last group may hold fewer), a few
    rows over each of the clusters the card runs at once (`launch_plan`);
    keys split over a cluster's CTAs in interleaved tiles of `key_tile`;
    weights streamed through a ring of `stages` x `stage_bytes`; `smem`
    bytes of dynamic shared memory per CTA."""

    cluster: int
    rows: int
    groups: int
    key_tile: int
    stages: int
    stage_bytes: int
    smem: int

    @property
    def grid(self) -> int:
        return self.groups * self.cluster

    def row_groups(self, b: int):
        """[start, stop) of the batch rows of each cluster."""
        return [(g * self.rows, min(b, (g + 1) * self.rows)) for g in range(self.groups)]

    def columns(self, n: int, rank: int) -> Tuple[int, int]:
        """[start, stop) of the output columns of an n-column matrix that CTA
        `rank` computes, in whole 8-column tiles (some CTAs may get none)."""
        return _col_split(n, rank, self.cluster)

    def k_rows(self, n: int, rank: int) -> Tuple[int, int]:
        """[start, stop) of the K rows of w2 (n = d_ff) that CTA `rank`
        multiplies: the slice of the hidden vector its w1 columns made."""
        return rank * n // self.cluster, (rank + 1) * n // self.cluster

    def key_tiles(self, n: int, rank: int):
        """[start, stop) ranges of the keys 0..n-1 that CTA `rank` scores:
        tiles j with j % cluster == rank."""
        kt = self.key_tile
        return [(j * kt, min(n, (j + 1) * kt)) for j in range(rank, -(-n // kt), self.cluster)]


# the geometry of csrc/ar_decode.cu, which checks the plan against its own
THREADS = 512  # per CTA: 16 warps
MAX_ROWS = 16  # batch rows per cluster: the M of mma.sync.m16n8k16
KEY_TILE = 8
RING_STAGES, STAGE_BYTES = (4, 3, 2), 32768  # the deepest ring that fits is taken
CLUSTER_SIZES = (16, 8, 4, 2, 1)
WIDTHS = (32, 64, 128, 256, 512)  # d: a divisor of THREADS, at most 512 per LayerNorm warp
MAX_CTA_COLUMNS = 512  # 4 n-tiles per warp
MASKED = NEG_INF / 2  # a memory key whose bias is at or below this is padding


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _al16(n: int) -> int:
    return (n + 15) // 16 * 16


def _col_split(n: int, rank: int, cluster: int) -> Tuple[int, int]:
    tiles = n // 8
    return 8 * (rank * tiles // cluster), 8 * ((rank + 1) * tiles // cluster)


def _widest(n: int, cluster: int) -> int:
    return max(b - a for a, b in (_col_split(n, r, cluster) for r in range(cluster)))


def _red_bytes(ncols: int, rows: int) -> int:
    """Split-K partials of one product: warps split the CTA's n-tiles first
    (a power of two of them), the K steps over the rest; none when the
    columns take every warp."""
    nwn = 1
    while nwn * 2 <= min(ncols // 8, THREADS // 32):
        nwn *= 2
    nwk = THREADS // 32 // nwn if ncols else 1
    return 0 if nwk == 1 else nwk * rows * ncols * 4


def _cta_columns(d: int, d_ff: int, n_mels: int, cluster: int):
    """Widest slice each product gives one CTA: the column-split matrices
    (prenet and attention outputs, Q/K/V, w1, mel) and w2, split over its K
    rows and so computing all d columns."""
    return [_widest(n, cluster) for n in (d, 3 * d, d_ff, n_mels)] + [d]


def _splits(cluster: int, d: int, d_ff: int, n_mels: int) -> bool:
    """Whether a cluster of this size splits every matrix into whole tiles:
    8-column tiles of d per CTA, 16-row K steps of w2's d_ff rows."""
    return not (d % (8 * cluster) or d_ff % (16 * cluster)) and \
        max(_cta_columns(d, d_ff, n_mels, cluster)) <= MAX_CTA_COLUMNS


def cluster_size(d: int, d_ff: int, n_mels: int) -> int:
    """K1's cluster size for these widths: the largest that splits every
    matrix into whole tiles, 0 when none does.  The plan and the packed
    weight stream both take it (a smaller cluster would only need more
    shared memory per CTA)."""
    return next((c for c in CLUSTER_SIZES if _splits(c, d, d_ff, n_mels)), 0)


def _smem(t: int, s: int, n_layers: int, d: int, h: int, d_ff: int, n_mels: int,
          cluster: int, rows: int, stages: int) -> int:
    """Dynamic shared memory of one CTA (mirrors `layout` in csrc/ar_decode.cu)."""
    kt = KEY_TILE
    lda = max(d, n_mels, d_ff // cluster) + 8
    nloc = max(_cdiv(_cdiv(t, kt), cluster), _cdiv(_cdiv(s, kt), cluster)) * kt
    mtiles = _cdiv(_cdiv(s, kt), cluster)
    vg = max(1, THREADS // (rows * d // 8))
    wd, w3, wff, wm, _ = _cta_columns(d, d_ff, n_mels, cluster)
    xb = _al16(max(4 * rows * d, 6 * rows * d, 8 * cluster * rows * h, 4 * rows * n_mels))
    scores = 4 * rows * h * nloc + (4 * vg * rows * d if vg > 1 else 0)
    red = max(_red_bytes(n, rows) for n in _cta_columns(d, d_ff, n_mels, cluster))
    vb = w3 + 3 * wd + wff + d // cluster  # one layer's bias slices
    vec = 4 * (n_layers * 6 * d + n_layers * vb + 2 * wd + wm)
    small = 8 * (stages + 2) + 4 * (rows * mtiles + rows)  # mbarriers, key tiles
    return (_al16(4 * rows * d) + _al16(2 * 16 * lda) + 2 * xb + _al16(max(scores, red))
            + stages * STAGE_BYTES + _al16(vec) + _al16(small))


def _deepest_ring(b: int, t: int, s: int, n_layers: int, d: int, n_heads: int, d_ff: int,
                  n_mels: int, cluster: int, rows: int) -> Optional[Plan]:
    """The plan of `rows` rows a cluster with the deepest ring that fits, or None."""
    for stages in RING_STAGES:
        smem = _smem(t, s, n_layers, d, n_heads, d_ff, n_mels, cluster, rows, stages)
        if smem <= kernels.MAX_SMEM:
            return Plan(cluster, rows, _cdiv(b, rows), KEY_TILE, stages, STAGE_BYTES, smem)
    return None


def launch_plan(b: int, t: int, s: int, n_layers: int, d: int, n_heads: int, d_ff: int,
                n_mels: int, pe_len: int, max_clusters: int = 1) -> Plan:
    """K1's launch plan for B rows, T steps over S memory frames, on a card
    that runs `max_clusters` clusters at once (`co_resident_clusters`);
    raises ValueError for a shape the kernel does not take.  The cluster is
    `cluster_size`.  The rows spread over the clusters that run at once,
    ceil(B / max_clusters) rows each (at most MAX_ROWS), and the ring
    is as deep as fits in the shared memory the fewer rows free.  The decode
    is latency-bound: a cluster pays its exchanges a step whatever its rows,
    but each phase that loops over a CTA's rows costs with them, so idle SMs
    are worth more than one weight stream shared by more rows.  Where that
    spread needs no fewer rows a cluster than the fewest clusters that fit
    (at most MAX_ROWS rows each), or fits no shared memory, the plan is
    those fewest with the deepest ring that fits.  So it never asks for
    more clusters than max(max_clusters, the fewest), and no cluster waits
    for another's whole decode; at max_clusters 1 it is the fewest."""
    if not 1 <= t <= pe_len:
        raise ValueError(f"ar_decode kernel: max_len {t} outside the PE table (1..{pe_len})")
    if b < 1 or s < 1 or n_layers < 1:
        raise ValueError("ar_decode kernel: needs B, S and n_layers >= 1")
    if max_clusters < 1:
        raise ValueError("ar_decode kernel: needs max_clusters >= 1")
    if d not in WIDTHS:
        raise ValueError(f"ar_decode kernel: d={d} must be one of {WIDTHS}")
    if d % n_heads or (d // n_heads) % 8:
        raise ValueError(f"ar_decode kernel: head width {d}/{n_heads} must be a multiple of 8")
    if n_mels % 16 or d_ff % 16:
        raise ValueError(f"ar_decode kernel: n_mels={n_mels} and d_ff={d_ff} must be "
                         "multiples of 16")
    shape = (b, t, s, n_layers, d, n_heads, d_ff, n_mels)
    c = cluster_size(d, d_ff, n_mels)
    fewest = None
    groups = _cdiv(b, MAX_ROWS)
    while c and fewest is None and groups <= b:
        fewest = _deepest_ring(*shape, c, _cdiv(b, groups))
        groups += 1
    if fewest is None:
        raise ValueError(f"ar_decode kernel: no cluster of {CLUSTER_SIZES} takes d={d}, "
                         f"d_ff={d_ff}, T={t}, S={s}, {n_layers} layers within "
                         f"{kernels.MAX_SMEM} bytes of shared memory")
    spread = min(MAX_ROWS, _cdiv(b, max_clusters))
    for rows in range(spread, fewest.rows):  # ceil(B / rows) <= max_clusters clusters
        plan = _deepest_ring(*shape, c, rows)
        if plan is not None:
            return plan
    return fewest


@functools.lru_cache(maxsize=None)
def co_resident_clusters(device: torch.device, d: int, n_heads: int, d_ff: int,
                         n_mels: int) -> int:
    """How many K1 clusters (of `cluster_size` CTAs) the card runs at once
    for these widths (cudaOccupancyMaxActiveClusters), at the most shared
    memory a plan takes, kernels.MAX_SMEM: one CTA an SM, and a plan's own
    is never more, so at least as many of its clusters fit.  Asked once per
    process, device and widths; at least 1 (1 where no cluster size fits:
    launch_plan then raises)."""
    cluster = cluster_size(d, d_ff, n_mels)
    if not cluster:
        return 1
    lib = kernels.library("ar_decode")
    n = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = lib.ar_decode_max_clusters(d, n_heads, cluster, kernels.MAX_SMEM, ctypes.byref(n))
    kernels.raise_on_error("ar_decode", err, lib)
    return max(1, n.value)


@functools.lru_cache(maxsize=1024)
def card_plan(device: torch.device, b: int, t: int, s: int, n_layers: int, d: int,
              n_heads: int, d_ff: int, n_mels: int, pe_len: int) -> Plan:
    """`launch_plan` on this card (its `co_resident_clusters`), made once
    per process and shape, so a launch of a shape seen before asks the card
    nothing and plans nothing."""
    return launch_plan(b, t, s, n_layers, d, n_heads, d_ff, n_mels, pe_len,
                       max_clusters=co_resident_clusters(device, d, n_heads, d_ff, n_mels))


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"ar_decode kernel: {msg}")


UNSCHEDULABLE = -2  # ar_decode_launch's code for a cluster the card cannot place


def _ar_decode_cuda(w, mem_k, mem_v, mem_bias, carry: DecodeCarry, pos0: int, steps: int,
                    lengths: Optional[torch.Tensor], plan: Optional[Plan]):
    global launches
    L, b, s, d = mem_k.shape
    prev, kcache, vcache = carry
    max_len = kcache.shape[2]
    h = w.n_heads
    d_ff = w.w1.shape[-1]
    n_mels = w.mel_w.shape[1]
    dev = mem_k.device
    bf16 = torch.bfloat16
    for t in w.matrices + (mem_k, mem_v):
        _check(t.device == dev and t.dtype == bf16 and t.is_contiguous(),
               f"weights and memory K/V must be contiguous bf16 on {dev}")
    for t in w.vectors + (mem_bias,):
        _check(t.device == dev and t.dtype == torch.float32 and t.is_contiguous(),
               f"biases, LayerNorm, PE and mask bias must be contiguous f32 on {dev}")
    _check(mem_v.shape == mem_k.shape, "mem_k/mem_v shapes differ")
    _check(tuple(mem_bias.shape) == (b, s), f"mem_bias {tuple(mem_bias.shape)} != {(b, s)}")
    _check(w.wqkv.shape == (L, d, 3 * d), f"wqkv {tuple(w.wqkv.shape)} vs L={L}, d={d}")
    _check(w.w2.shape == (L, d_ff, d) and w.ln.shape == (L, 3, 2, d), "layer shapes")
    _check(w.prenet_w1.shape == (n_mels, d), "prenet shape")
    prev = prev.contiguous()  # the last frame of a chunk's mel is a strided view
    _check(prev.device == dev and prev.dtype == torch.float32 and prev.shape == (b, n_mels),
           f"prev_mel must be f32 [{b}, {n_mels}] on {dev}")
    for t in (kcache, vcache):
        _check(t.device == dev and t.dtype == bf16 and t.is_contiguous()
               and t.shape == (L, b, max_len, d),
               f"the caches must be contiguous bf16 [{L}, {b}, T, {d}] on {dev}")
    if lengths is not None:
        _check(lengths.device == dev and lengths.dtype == torch.int32 and lengths.is_contiguous()
               and tuple(lengths.shape) == (b,), f"lengths must be contiguous int32 [{b}] on {dev}")
    if plan is None:
        plan = card_plan(dev, b, max_len, s, L, d, h, d_ff, n_mels, w.pe.shape[0])

    ws = w.stream
    _check(ws is not None and ws.shape[0] == plan.cluster,
           "no weight stream for this cluster: pack the weights with pack_decoder")
    _check(ws.device == dev and ws.dtype == bf16 and ws.is_contiguous(),
           f"the weight stream must be contiguous bf16 on {dev}")

    out = torch.empty(b, steps, n_mels, dtype=torch.float32, device=dev)
    lib = kernels.library("ar_decode")
    ptrs = [t.data_ptr() for t in (
        ws, w.prenet_b1, w.prenet_b2, w.bqkv, w.bo, w.bcq, w.bco, w.b1, w.b2,
        w.ln, w.mel_b, w.pe, mem_k, mem_v, mem_bias, prev, kcache, vcache, out,
    )] + [None if lengths is None else lengths.data_ptr()]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ar_decode_launch(
            *[ctypes.c_void_p(p) for p in ptrs],
            ws.shape[1], b, max_len, s, L, d, h, d_ff, n_mels, pos0, steps,
            plan.cluster, plan.rows, plan.groups, plan.key_tile, plan.stages,
            plan.stage_bytes, plan.smem, ctypes.c_void_p(stream),
        )
    if err == UNSCHEDULABLE:
        raise RuntimeError(
            f"ar_decode kernel: this card cannot schedule a cluster of {plan.cluster} CTAs "
            f"with {plan.smem} bytes of shared memory each (cudaOccupancyMaxActiveClusters "
            "returned 0)")
    kernels.raise_on_error("ar_decode", err, lib)
    launches += 1
    tracing.count("k1.clusters", plan.groups)
    return DecodeCarry(out[:, -1], kcache, vcache), out
