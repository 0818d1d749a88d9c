"""The port's hand-written CUDA kernels against their plain versions, on the
card.  Every test here needs a CUDA card and skips elsewhere.

This file imports only torch, numpy and the port (never JAX), so that it also
runs where JAX is not installed.  The repo's conftest imports JAX, so on such
a machine run it without the conftest:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from sambert_hifigan_tpu_torch.config import DecoderConfig
from sambert_hifigan_tpu_torch.models import ar_decoder as p_ar
from sambert_hifigan_tpu_torch.models.hifigan import MRF
from sambert_hifigan_tpu_torch.models.layers import init_defaults_
from sambert_hifigan_tpu_torch.ops import ar_decode as k1
from sambert_hifigan_tpu_torch.ops import mrf as k2

D, MELS = 32, 80
DEC = dict(n_layers=2, n_heads=4, d_ff=64, dropout=0.0, max_len=64)

pytestmark = pytest.mark.cuda


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _decoder(dev):
    gen = torch.Generator().manual_seed(3)
    dec = p_ar.PNCAARDecoder(D, MELS, DecoderConfig(**DEC))
    init_defaults_(dec, gen)
    dec.init_weights_(gen)
    return dec.to(dev).eval()


def _mrf(c, dev):
    port = MRF(c)
    init_defaults_(port, torch.Generator().manual_seed(2))
    return port.to(dev)


@pytest.mark.parametrize("b", [1, 3])
def test_k1_kernel_matches_plain_on_card(cuda_device, b):
    """Same bf16 rounding points; f32 sums in another order, which the AR
    feedback carries over 24 steps."""
    dec = _decoder(cuda_device)
    t = 24
    hvar = torch.from_numpy(_np(50 + b, b, t, D)).to(cuda_device)
    mask = torch.zeros(b, t, dtype=torch.bool, device=cuda_device)
    mask[0, 20:] = True
    w = p_ar.pack_decoder(dec, torch.bfloat16)
    mk, mv = p_ar.precompute_memory_packed(dec, hvar)
    bias = torch.where(mask, k1.NEG_INF, 0.0).float().contiguous()
    mk, mv = mk.bfloat16().contiguous(), mv.bfloat16().contiguous()
    before = k1.launches
    out = k1.ar_decode(w, mk, mv, bias, t)
    torch.cuda.synchronize()
    assert k1.launches == before + 1
    ref = k1.ar_decode_plain(w, mk, mv, bias, t)
    err = (out - ref).abs()
    assert err.mean() < 5e-3 and err.max() < 5e-2, (err.mean().item(), err.max().item())


@pytest.mark.parametrize("c", [32, 64, 128])
def test_k2_kernel_matches_plain_on_card(cuda_device, c):
    """Same bf16 rounding points, f32 sums in another order; edge samples,
    where every conv zero-pads its own input, are checked on their own."""
    w = k2.pack_mrf(_mrf(c, cuda_device), torch.bfloat16)
    x = torch.from_numpy(_np(60, 2, c, 1000)).to(cuda_device)
    before = k2.launches
    out = k2.mrf(x, w)
    torch.cuda.synchronize()
    assert k2.launches == before + 1
    ref = k2.mrf_plain(x, w)
    err = (out - ref).abs()
    assert err.max() < 2e-3, err.max().item()
    assert err[..., :64].max() < 2e-3 and err[..., -64:].max() < 2e-3


def test_kernels_refuse_what_they_do_not_take(cuda_device):
    port = _mrf(32, cuda_device)
    with pytest.raises(ValueError):  # f32 weights are the CPU packing
        k2.mrf(torch.zeros(1, 32, 128, device=cuda_device), k2.pack_mrf(port, torch.float32))
    w = k2.pack_mrf(_mrf(96, cuda_device), torch.bfloat16)
    with pytest.raises(ValueError):  # 96 channels: neither 32 nor a multiple of 64
        k2.mrf(torch.zeros(1, 96, 128, device=cuda_device), w)
    dec = _decoder(cuda_device)
    w = p_ar.pack_decoder(dec, torch.bfloat16)
    mk = torch.zeros(DEC["n_layers"], 1, 8, D, dtype=torch.bfloat16, device=cuda_device)
    bias = torch.zeros(1, 8, device=cuda_device)
    with pytest.raises(ValueError):  # longer than the positional table
        k1.ar_decode(w, mk, mk, bias, DEC["max_len"] + 1)
    with pytest.raises(ValueError):  # f32 memory K/V
        k1.ar_decode(w, mk.float(), mk.float(), bias, 8)
