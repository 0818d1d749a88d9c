"""K2: one whole multi-receptive-field (MRF) block of the HiFi-GAN generator.

`mrf` is the wrapper.  A CUDA tensor goes to the hand-written kernels in
`csrc/mrf.cu`, enqueued by one C call (or the call raises); a CPU tensor goes
to `mrf_plain`, the same function with `F.conv1d`.  There is no switch and no
fallback.  `launch_plan` is the kernels' launch plan, computed on the host:
at C = 32 and 64 one launch per ResBlock runs its 6 convs on chip per time
tile; at C % 64 == 0 (C >= 128) one launch per conv.

The function is the flax `MRF` of the JAX package: 3 ResBlocks, each
3 x [LeakyReLU(0.1) -> conv (dilation d) -> LeakyReLU -> conv (dilation 1)
-> + residual], averaged.  Every conv zero-pads its own input at the
sequence ends.  With bf16 weights the conv inputs (and the block input) are
rounded to bf16 and products accumulate in f32, as in the Pallas kernel; with
f32 weights nothing is rounded.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from .. import kernels

launches = 0  # MRF calls that launched the kernels (never the plain version)

LRELU_SLOPE = 0.1

# the launch geometry of csrc/mrf.cu, which checks the plan against its own
CHAIN_CHANNELS = (32, 64)  # one launch per ResBlock, chained on chip
CONV_CO, CONV_T, CONV_CI = 64, 256, 16  # one launch per conv: block tile, input slice
CONV_SMEM_HALF = 113 * 1024  # the ring of stages fills up to this, two blocks per SM
MAX_DILATIONS = 8  # per ResBlock, in the chain kernel
MAX_GRID_YZ = 65535


class Launch(NamedTuple):
    """One kernel launch of an MRF: the convs it chains, as (kernel size,
    dilation); the halo its input window carries on each side of the output
    tile (the sum of the convs' half-spans); the output tile in samples; its
    dynamic shared memory in bytes; and its grid (time tiles, y, z)."""

    convs: Tuple[Tuple[int, int], ...]
    halo: int
    tile: int
    smem: int
    grid: Tuple[int, int, int]


def half_span(k: int, d: int) -> int:
    """Samples a conv of kernel size k and dilation d reads on each side."""
    return (k - 1) * d // 2


def launch_plan(c: int, kernel_sizes, dilations, b: int, t: int) -> List[Launch]:
    """The launches of one MRF over x [b, c, t], in the order `mrf_launch`
    makes them; raises ValueError for a shape the kernels do not take."""
    if t < 1 or b < 1 or b > MAX_GRID_YZ:
        raise ValueError(f"mrf kernel: needs 1 <= B <= {MAX_GRID_YZ} and T >= 1")
    if any(k % 2 == 0 for k in kernel_sizes):
        raise ValueError("mrf kernel: needs odd kernel sizes")
    plan = []
    if c in CHAIN_CHANNELS:
        if len(dilations) > MAX_DILATIONS:
            raise ValueError(f"mrf kernel: at most {MAX_DILATIONS} dilations per ResBlock")
        window = 3 * 8192 // c  # three warpgroups' rows: y and the accumulators fill the registers
        for k in kernel_sizes:
            convs = tuple(kd for d in dilations for kd in ((k, d), (k, 1)))
            halo = sum(half_span(*kd) for kd in convs)
            tile = window - 2 * halo
            if tile <= 0:
                raise ValueError(f"mrf kernel: the k={k} chain's halo {halo} fills the "
                                 f"{window}-sample window at C={c}")
            padr = max(half_span(*kd) for kd in convs)
            taps = 11 if c == 32 else 4  # taps per weight stage, two stages
            smem = (2 * (window + 2 * padr) * c + 2 * taps * c * c) * 2
            plan.append(Launch(convs, halo, tile, smem, (-(-t // tile), b, 1)))
    elif c % CONV_CO == 0:
        for k in kernel_sizes:
            for d in dilations:
                for kd in ((k, d), (k, 1)):
                    stage = 2 * (CONV_T + 2 * half_span(*kd) + k * CONV_CO) * CONV_CI
                    depth = min(4, max(2, CONV_SMEM_HALF // stage))  # stages in the ring
                    smem = max(depth * stage, 4 * CONV_CO * (CONV_T + 1))
                    plan.append(Launch((kd,), half_span(*kd), CONV_T, smem,
                                       (-(-t // CONV_T), c // CONV_CO, b)))
    else:
        raise ValueError(f"mrf kernel: needs C in {CHAIN_CHANNELS} or C % {CONV_CO} == 0, got {c}")
    # the chain kernel also holds a static f32 bias table for 2 * MAX_DILATIONS convs
    limit = kernels.MAX_SMEM - (8 * MAX_DILATIONS * c if c in CHAIN_CHANNELS else 0)
    for launch in plan:
        if launch.smem > limit:
            raise ValueError(f"mrf kernel: {launch.convs} needs {launch.smem} bytes of shared "
                             f"memory, more than {limit}")
    return plan


class MRFWeights(NamedTuple):
    """One MRF's conv weights, packed once per pipeline.

    `weights` are torch Conv1d weights [C, C, K] in the kernel dtype, in
    (ResBlock, dilation, conv1/conv2) order, `biases` [n_convs, C] f32.
    `packed` is the same weights in bf16 for the kernels, each conv packed
    by `pack_conv_taps` (C = 32, 64) or `pack_conv_tiles` (the per-conv
    kernel's widths), concatenated; None for f32."""

    kernel_sizes: Tuple[int, ...]
    dilations: Tuple[int, ...]
    weights: List[torch.Tensor]
    biases: torch.Tensor
    packed: torch.Tensor = None


def pack_conv_taps(w: torch.Tensor) -> torch.Tensor:
    """Conv1d weight [Cout, Cin, K] -> flat [K, Cout, Cin]: one [co][ci]
    slice per tap, input channels contiguous, as the chain kernel copies them."""
    return w.permute(2, 0, 1).contiguous().reshape(-1)


def pack_conv_tiles(w: torch.Tensor) -> torch.Tensor:
    """Conv1d weight [Cout, Cin, K] -> flat [Cout/64, Cin/16, K, 2, 64, 8]:
    for each (64-channel output tile, 16-channel input slice) the weights of
    one stage of the per-conv kernel, contiguous and in its shared-memory
    layout (input channels in two planes of 8)."""
    co, ci, k = w.shape
    t = w.reshape(co // CONV_CO, CONV_CO, ci // CONV_CI, 2, 8, k)
    return t.permute(0, 2, 5, 3, 1, 4).contiguous().reshape(-1)


def pack_mrf(mrf_module, dtype: torch.dtype) -> MRFWeights:
    """Pack a models.hifigan.MRF for `mrf` (weights in `dtype`)."""
    ks, dils, ws, bs = [], None, [], []
    for rb in mrf_module.resblocks:
        ks.append(rb.kernel_size)
        dils = rb.dilations if dils is None else dils
        if rb.dilations != dils:
            raise ValueError("every ResBlock of an MRF must share one dilation list")
        for c1, c2 in zip(rb.convs1, rb.convs2):
            for conv in (c1, c2):
                ws.append(conv.weight.detach().to(dtype).contiguous())
                bs.append(conv.bias.detach().float())
    packed = None
    if dtype == torch.bfloat16:
        c = ws[0].shape[0]
        pack = pack_conv_tiles if c not in CHAIN_CHANNELS and c % CONV_CO == 0 else pack_conv_taps
        packed = torch.cat([pack(w) for w in ws])
    return MRFWeights(tuple(ks), tuple(dils), ws, torch.stack(bs).contiguous(), packed)


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, LRELU_SLOPE)


def mrf(x: torch.Tensor, w: MRFWeights) -> torch.Tensor:
    """x [B, C, T] -> [B, C, T] f32."""
    if x.device.type == "cpu":
        return mrf_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"mrf: unsupported device {x.device}")
    return _mrf_cuda(x, w)


def mrf_plain(x: torch.Tensor, w: MRFWeights) -> torch.Tensor:
    """Plain PyTorch version of K2."""
    if w.weights[0].dtype == torch.bfloat16:
        rnd = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    else:
        rnd = lambda t: t  # noqa: E731
    x0 = rnd(x.float())
    out = None
    n = 0
    for k in w.kernel_sizes:
        y = x0
        for d in w.dilations:
            t1 = F.conv1d(rnd(_lrelu(y)), w.weights[n].float(), w.biases[n],
                          padding=(k * d - d) // 2, dilation=d)
            t2 = F.conv1d(rnd(_lrelu(t1)), w.weights[n + 1].float(), w.biases[n + 1],
                          padding=(k - 1) // 2)
            y = y + t2
            n += 2
        out = y if out is None else out + y
    return out / len(w.kernel_sizes)


def _mrf_cuda(x: torch.Tensor, w: MRFWeights) -> torch.Tensor:
    global launches
    b, c, t = x.shape
    dev = x.device
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("mrf kernel: x must be contiguous f32 [B, C, T]")
    if w.packed is None or w.packed.device != dev or w.packed.dtype != torch.bfloat16:
        raise ValueError(f"mrf kernel: needs bf16 packed weights on {dev}")
    if w.biases.device != dev or w.biases.dtype != torch.float32:
        raise ValueError(f"mrf kernel: biases must be f32 on {dev}")
    n_convs = 2 * len(w.kernel_sizes) * len(w.dilations)
    expect = sum(2 * len(w.dilations) * c * c * k for k in w.kernel_sizes)
    if w.packed.numel() != expect or tuple(w.biases.shape) != (n_convs, c):
        raise ValueError(f"mrf kernel: weights do not match C={c}")
    plan = launch_plan(c, w.kernel_sizes, w.dilations, b, t)
    out = torch.empty_like(x)
    if c in CHAIN_CHANNELS:  # the chains need no scratch in device memory
        scratch = [None] * 4
    else:  # bf16 conv operands [B, T, C] (block input, t1, y) and the f32 y
        scratch = [torch.empty(b, t, c, dtype=torch.bfloat16, device=dev) for _ in range(3)]
        scratch.append(torch.empty_like(x))
    ints = lambda v: (ctypes.c_int * len(v))(*v)  # noqa: E731
    host = [ints(w.kernel_sizes), ints(w.dilations), ints([p.tile for p in plan]),
            ints([p.smem for p in plan])]
    lib = kernels.library("mrf")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mrf_launch(
            *[ctypes.c_void_p(None if p is None else p.data_ptr())
              for p in (x, w.packed, w.biases, out, *scratch)],
            b, c, t, len(w.kernel_sizes), len(w.dilations),
            *[ctypes.cast(h, ctypes.c_void_p) for h in host],
            ctypes.c_void_p(stream),
        )
    kernels.raise_on_error("mrf", err, lib)
    launches += 1
    return out
