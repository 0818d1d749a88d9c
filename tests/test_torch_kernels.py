"""The port's two kernels, K1 (AR decode) and K2 (MRF).

On the CPU: their plain versions in the kernels' bf16 numerics against the
JAX package's Pallas kernels run in interpret mode (the contract), and the
MRF against the flax MRF.  The hand-written kernels themselves are held
against these plain versions on the card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from sambert_hifigan_tpu.config import DecoderConfig, GeneratorConfig
from sambert_hifigan_tpu.models import ar_decoder as j_ar
from sambert_hifigan_tpu.models import hifigan as j_hg
from sambert_hifigan_tpu.ops.pallas.decode_kernel import pallas_ar_decode
from sambert_hifigan_tpu.ops.pallas.mrf_kernel import fused_mrf, plan_mrf

from sambert_hifigan_tpu_torch import kernels
from sambert_hifigan_tpu_torch.config import DecoderConfig as PDecoderConfig, default_config
from sambert_hifigan_tpu_torch.models import ar_decoder as p_ar
from sambert_hifigan_tpu_torch.models.hifigan import MRF
from sambert_hifigan_tpu_torch.ops import mrf as k2
from sambert_hifigan_tpu_torch.weights import decoder_state_dict_from_flax, mrf_state_dict_from_flax

D, MELS = 32, 80
DEC = dict(n_layers=2, n_heads=4, d_ff=64, dropout=0.0, max_len=64)


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module")
def decoder():
    model = j_ar.PNCAARDecoder(D, MELS, DecoderConfig(**DEC))
    params = model.init(jax.random.PRNGKey(3), jnp.zeros((1, 12, D)), jnp.zeros((1, 12, MELS)))
    params = jax.device_get(params)
    port = p_ar.PNCAARDecoder(D, MELS, PDecoderConfig(**DEC))
    port.load_state_dict(decoder_state_dict_from_flax(params))
    return model, params, port.eval()


@pytest.mark.parametrize("b,pads", [(1, {0: 10}), (3, {0: 10, 1: 8}), (2, {0: 0, 1: 9}),
                                    (3, {0: 2, 1: 1, 2: 2})],
                         ids=["B1", "B3", "B2-all-masked-row", "B3-most-masked"])
def test_k1_plain_bf16_matches_pallas_kernel(decoder, b, pads):
    """K1's plain version in bf16 against pallas_ar_decode(interpret=True)
    with the same f32 weights (cast to bf16 by both) and per-row masks.
    Both round at the same points (bf16 q*k products included) and differ
    only in f32 summation order, which the AR feedback carries over 12
    steps.  The JAX package's own bound is mean < 0.05; this holds
    mean < 1e-6 and max < 1e-5 (reached: mean ~8e-9, max ~2.4e-7).  The
    masks the kernel's skip of padded memory must keep: a row whose memory
    is all padding (a uniform softmax in both), and rows with 83-92% of
    their memory padded."""
    model, params, port = decoder
    t = 12
    hvar = _np(11 + b, b, t, D)
    mask = np.zeros((b, t), bool)
    for row, start in pads.items():
        mask[row, start:] = True
    dp = j_ar.extract_decode_params(model, params)
    mk, mv = j_ar.precompute_memory_packed(model, params, jnp.asarray(hvar))
    ref = np.asarray(pallas_ar_decode(dp, mk, mv, t, jnp.asarray(mask), n_heads=4,
                                      n_mels=MELS, interpret=True))
    w = p_ar.pack_decoder(port, torch.bfloat16)
    out = p_ar.ar_decode(port, torch.from_numpy(hvar), t, torch.from_numpy(mask), weights=w).numpy()
    assert out.shape == ref.shape == (b, t, MELS)
    err = np.abs(out - ref)
    assert err.mean() < 1e-6 and err.max() < 1e-5, (err.mean(), err.max())


def test_k1_plain_bf16_rows_are_independent(decoder):
    model, params, port = decoder
    hvar = _np(30, 3, 12, D)
    mask = np.zeros((3, 12), bool)
    mask[1, 7:] = True
    w = p_ar.pack_decoder(port, torch.bfloat16)
    both = p_ar.ar_decode(port, torch.from_numpy(hvar), 12, torch.from_numpy(mask), weights=w)
    solo = p_ar.ar_decode(port, torch.from_numpy(hvar[1:2]), 12, torch.from_numpy(mask[1:2]), weights=w)
    np.testing.assert_allclose(both[1].numpy(), solo[0].numpy(), atol=1e-5, rtol=0)


def _mrf_pair(c, seed=2):
    model = j_hg.MRF(c)
    params = jax.device_get(model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 16, c))))
    port = MRF(c)
    port.load_state_dict(mrf_state_dict_from_flax(params))
    return model, params, port


def test_k2_plain_bf16_matches_flax_mrf_whole_sequence():
    """bf16-rounded K2 plain version vs the f32 flax MRF over the whole
    sequence, edges included: only bf16 input/weight rounding separates them
    (every conv zero-pads its own input on both sides)."""
    c, t = 32, 256
    model, params, port = _mrf_pair(c)
    x = _np(40, 2, t, c)
    ref = np.asarray(model.apply(params, jnp.asarray(x)))
    out = k2.mrf(torch.from_numpy(x).transpose(1, 2).contiguous(), k2.pack_mrf(port, torch.bfloat16))
    err = np.abs(out.transpose(1, 2).numpy() - ref)
    edges = np.concatenate([err[:, :64], err[:, -64:]], axis=1)
    assert err.max() < 3e-2 and err.mean() < 3e-3, (err.max(), err.mean())
    assert edges.max() < 3e-2 and edges.mean() < 3e-3, (edges.max(), edges.mean())


def test_k2_plain_bf16_matches_pallas_kernel_interior():
    """K2's plain version vs fused_mrf(interpret=True) on interior samples.
    The Pallas kernel zero-pads only the block input, not each conv's input
    at the sequence ends (mrf_kernel.py:212 vs :170-177), so within the
    chains' 60-sample receptive margin of either end it departs from the flax
    MRF; the port follows the flax MRF.  Interior: same bf16 rounding points,
    different f32 summation order, so now and then a conv input on a bf16
    rounding boundary rounds the other way (reached: max 8.6e-5, mean 5.4e-6
    under the suite's XLA flags; max 7e-7 without them).  At the edges the
    departure itself shows: well above 1e-2 near either end."""
    c, t, margin = 32, 256, 60
    model, params, port = _mrf_pair(c, seed=5)
    x = _np(41, 1, t, c)
    taps, biases, structure, fold, m = plan_mrf(GeneratorConfig(), c, params["params"])
    ref = np.asarray(fused_mrf(jnp.asarray(x), jnp.asarray(taps), jnp.asarray(biases),
                               structure, fold, m, interpret=True))
    out = k2.mrf(torch.from_numpy(x).transpose(1, 2).contiguous(), k2.pack_mrf(port, torch.bfloat16))
    err = np.abs(out.transpose(1, 2).numpy() - ref)
    inner = err[:, margin:-margin]
    assert inner.max() < 1e-3 and inner.mean() < 1e-5, (inner.max(), inner.mean())
    assert np.concatenate([err[:, :margin], err[:, -margin:]], axis=1).max() > 1e-2


def test_pack_conv_tiles_layout():
    """The per-conv kernel's packing: one contiguous stage per (64-channel
    output tile, 16-channel input slice), taps, then two planes of 8 input
    channels, each [64 out channels][8]."""
    w = torch.arange(128 * 32 * 3, dtype=torch.float32).reshape(128, 32, 3)
    tiles = k2.pack_conv_tiles(w).reshape(2, 2, 3, 2, 64, 8)
    # out tile 1, input slice 1, tap 2, plane 0, out channel 64 + 5, in channel 16 + 7
    assert tiles[1, 1, 2, 0, 5, 7] == w[64 + 5, 16 + 7, 2]
    assert tiles[0, 1, 0, 1, 9, 3] == w[9, 16 + 8 + 3, 0]


def test_pack_conv_taps_layout():
    w = torch.arange(32 * 48 * 3, dtype=torch.float32).reshape(32, 48, 3)
    taps = k2.pack_conv_taps(w).reshape(3, 32, 48)
    # tap 1, out channel 21, in channel 39: one [co][ci] slice per tap
    assert taps[1, 21, 39] == w[21, 39, 1]
    assert torch.equal(taps[2], w[:, :, 2])


def _stage_widths():
    cfg = default_config().vocoder.generator
    return [cfg.upsample_initial_channel // 2 ** (i + 1) for i in range(len(cfg.upsample_rates))]


@pytest.mark.parametrize("t", [1, 40, 1000, 4099, 262144])
@pytest.mark.parametrize("c", _stage_widths())
def test_k2_launch_plan(c, t):
    """For every stage width of the default generator: each launch fits in a
    block's shared memory, carries the sum of its chained convs' half-spans
    as its halo, and its time tiles cover [0, T) exactly."""
    cfg = default_config().vocoder.generator
    ks, dils = cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes[0]
    plan = k2.launch_plan(c, ks, dils, 4, t)
    chained = c in k2.CHAIN_CHANNELS
    assert len(plan) == (len(ks) if chained else 2 * len(ks) * len(dils))
    assert sorted({launch.convs[0][0] for launch in plan}) == sorted(ks)
    for launch in plan:
        k = launch.convs[0][0]
        if chained:
            assert launch.convs == tuple(kd for d in dils for kd in ((k, d), (k, 1)))
            assert launch.halo == sum((k - 1) * d // 2 + (k - 1) // 2 for d in dils)
            assert launch.halo == {3: 12, 7: 36, 11: 60}[k]
        else:
            ((_, d),) = launch.convs
            assert launch.halo == (k - 1) * d // 2
        assert 0 < launch.smem <= kernels.MAX_SMEM
        starts = [i * launch.tile for i in range(launch.grid[0])]
        covered = [s for start in starts for s in range(start, min(start + launch.tile, t))]
        assert covered == list(range(t))
        assert launch.grid[1:] == ((4, 1) if chained else (c // k2.CONV_CO, 4))


def test_k2_launch_plan_refuses():
    with pytest.raises(ValueError):  # neither 32, 64 nor a multiple of 64 from 128
        k2.launch_plan(96, (3, 7, 11), (1, 3, 5), 1, 100)
    with pytest.raises(ValueError):  # the k = 35 chain's halo fills the 384-sample window
        k2.launch_plan(64, (3, 35), (1, 3, 5), 1, 100)
    with pytest.raises(ValueError):  # even kernel size
        k2.launch_plan(128, (4,), (1,), 1, 100)
    with pytest.raises(ValueError):  # a conv whose input windows pass 227 KB
        k2.launch_plan(128, (3,), (3000,), 1, 100)


def test_kernel_build_key_covers_includes_and_command(monkeypatch, tmp_path):
    """The library's name changes with the source, with a csrc header it
    includes, and with the nvcc command, so a stale build is never loaded."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "k.cuh"\n#include <cuda_runtime.h>\n')
    (csrc / "k.cuh").write_text("// v1\n")
    monkeypatch.setattr(kernels, "CSRC", csrc)
    monkeypatch.setattr(kernels, "_nvcc", lambda: "nvcc")
    first = kernels._target("k")
    assert kernels._target("k") == first
    assert [p.name for p in kernels._sources("k")] == ["k.cu", "k.cuh"]
    (csrc / "k.cuh").write_text("// v2\n")
    second = kernels._target("k")
    assert second != first
    cmd = kernels._nvcc_cmd
    monkeypatch.setattr(kernels, "_nvcc_cmd", lambda name, out: cmd(name, out) + ["-DX"])
    assert kernels._target("k") not in (first, second)

