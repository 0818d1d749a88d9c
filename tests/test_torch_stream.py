"""The port's streaming path against the JAX package's on the CPU.

K1 decodes chunk by chunk from a carry: the port's chain of plain chunks
against the JAX package's `ar_decode_chunk` chain over `make_packed_step`
(f32), and bit for bit against the port's own one-shot decode.  Then the
port's `stream` against the JAX `stream` on the small config and carried
weights of tests/test_torch_pipeline.py, whose raised duration bias (~15
frames a phoneme) makes one text overflow its first frame bucket and a longer
one overflow the largest.
"""

import math
import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from sambert_hifigan_tpu import config as jcfg
from sambert_hifigan_tpu.config import DecoderConfig
from sambert_hifigan_tpu.models import ar_decoder as j_ar
from sambert_hifigan_tpu.pipeline import build_pipeline_from_random_init as j_build

from sambert_hifigan_tpu_torch import config as pcfg
from sambert_hifigan_tpu_torch import inference
from sambert_hifigan_tpu_torch import pipeline as pipeline_mod
from sambert_hifigan_tpu_torch.config import DecoderConfig as PDecoderConfig
from sambert_hifigan_tpu_torch.models import ar_decoder as p_ar
from sambert_hifigan_tpu_torch.pipeline import TTSPipeline
from sambert_hifigan_tpu_torch.weights import (
    acoustic_state_dict_from_flax,
    decoder_state_dict_from_flax,
    generator_state_dict_from_flax,
)

from tests.test_torch_pipeline import _small_cfg

D, MELS, HOP = 32, 80, 256
DEC = dict(n_layers=2, n_heads=4, d_ff=64, dropout=0.0, max_len=64)
T, B = 12, 3
FITS = "今天天气"  # 106 frames: over the first bucket (96), within the largest (160)
LONG = "今天天气真好我们去公园"  # over the largest bucket


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module")
def decoder():
    model = j_ar.PNCAARDecoder(D, MELS, DecoderConfig(**DEC))
    params = jax.device_get(
        model.init(jax.random.PRNGKey(3), jnp.zeros((1, T, D)), jnp.zeros((1, T, MELS))))
    port = p_ar.PNCAARDecoder(D, MELS, PDecoderConfig(**DEC))
    port.load_state_dict(decoder_state_dict_from_flax(params))
    hvar = _np(40, B, T, D)
    mask = np.zeros((B, T), bool)
    mask[0, 9:] = True
    mask[2, 5:] = True
    return model, params, port.eval(), hvar, mask


def _port_chain(port, hvar, mask, dtype, chunk):
    """The port's decode chunk by chunk -> (carry, mel [B, T, n_mels])."""
    w = p_ar.pack_decoder(port, dtype)
    memory = p_ar.decode_memory(port, torch.from_numpy(hvar), torch.from_numpy(mask), w)
    carry = p_ar.init_packed_carry(w, hvar.shape[0], T)
    mels = []
    for pos in range(0, T, chunk):
        carry, mel = p_ar.ar_decode_chunk(w, memory, carry, pos, min(chunk, T - pos))
        mels.append(mel)
    return carry, torch.cat(mels, dim=1)


@pytest.mark.parametrize("chunk", [4, 5])
def test_chunk_chain_matches_jax_chunk_chain(decoder, chunk):
    """The JAX package's streaming decode (ar_decode_chunk over
    make_packed_step, f32) against the port's chain of plain chunks: the
    mel and the carry, within the decoder parity test's 1e-4."""
    model, params, port, hvar, mask = decoder
    dp = j_ar.extract_decode_params(model, params)
    mk, mv = j_ar.precompute_memory_packed(model, params, jnp.asarray(hvar))
    step = j_ar.make_packed_step(dp, mk, mv, T, jnp.asarray(mask))
    jcarry = j_ar.init_packed_carry(DEC["n_layers"], B, T, DEC["n_heads"], D // DEC["n_heads"],
                                    MELS)
    jmels = []
    for pos in range(0, T, chunk):
        jcarry, mel = j_ar.ar_decode_chunk(step, jcarry, jnp.int32(pos), min(chunk, T - pos))
        jmels.append(np.asarray(mel))
    carry, mel = _port_chain(port, hvar, mask, torch.float32, chunk)
    assert mel.shape == (B, T, MELS)
    np.testing.assert_allclose(mel.numpy(), np.concatenate(jmels, axis=1), atol=1e-4, rtol=0)
    np.testing.assert_allclose(carry.prev_mel.numpy(), np.asarray(jcarry[0]), atol=1e-4, rtol=0)
    for ours, theirs in zip(carry[1:], jcarry[1:]):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs).reshape(ours.shape),
                                   atol=1e-4, rtol=0)


@pytest.mark.parametrize("chunk", [4, 5], ids=["divides-T", "does-not-divide-T"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_chunk_chain_equals_one_shot_plain_decode(decoder, dtype, chunk):
    """A chain of chunks is the one-shot decode, bit for bit."""
    _, _, port, hvar, mask = decoder
    w = p_ar.pack_decoder(port, dtype)
    one = p_ar.ar_decode(port, torch.from_numpy(hvar), T, torch.from_numpy(mask), weights=w)
    carry, chained = _port_chain(port, hvar, mask, dtype, chunk)
    assert torch.equal(chained, one)
    assert torch.equal(carry.prev_mel, one[:, -1])


def test_chunk_refusals(decoder):
    _, _, port, hvar, mask = decoder
    w = p_ar.pack_decoder(port, torch.float32)
    memory = p_ar.decode_memory(port, torch.from_numpy(hvar), torch.from_numpy(mask), w)
    carry = p_ar.init_packed_carry(w, B, T)
    for pos0, steps in ((T - 2, 3), (0, 0), (-1, 2)):
        with pytest.raises(ValueError, match="capacity"):
            p_ar.ar_decode_chunk(w, memory, carry, pos0, steps)


# ---- the stream ----------------------------------------------------------------


@pytest.fixture(scope="module")
def pipelines():
    jp = j_build(_small_cfg(jcfg), 0)
    ap = jax.device_get(jp.acoustic_params)
    gp = jax.device_get(jp.generator_params)
    lin = ap["params"]["variance_adaptor"]["duration_predictor"]["linear"]
    lin["bias"] = np.full_like(lin["bias"], 2.9)
    lin["kernel"] = lin["kernel"] * 0.1
    jp.acoustic_params = jax.tree.map(jnp.asarray, ap)
    pp = TTSPipeline(
        _small_cfg(pcfg), acoustic_state_dict_from_flax(ap),
        generator_state_dict_from_flax(gp), device="cpu",
    )
    return jp, pp


@pytest.fixture
def run_buckets(monkeypatch):
    """The frame bucket of every _StreamRun a stream starts."""
    seen = []

    class Recording(pipeline_mod._StreamRun):
        def __init__(self, pipe, args, controls, max_frames, *rest):
            seen.append(max_frames)
            super().__init__(pipe, args, controls, max_frames, *rest)

    monkeypatch.setattr(pipeline_mod, "_StreamRun", Recording)
    return seen


def test_stream_matches_jax_stream_chunk_for_chunk(pipelines, run_buckets):
    """Chunk 16, context 8 on a text whose 106 frames overflow its first
    frame bucket: both restart at 160, give 7 chunks of the same lengths,
    each within the slice's wav tolerance."""
    jp, pp = pipelines
    theirs = list(jp.stream(FITS, chunk_frames=16, context_frames=8))
    ours = list(pp.stream(FITS, chunk_frames=16, context_frames=8))
    assert run_buckets == [96, 160]
    assert len(ours) == len(theirs) == math.ceil(106 / 16)
    assert [len(c) for c in ours] == [len(c) for c in theirs]
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-3, rtol=0)


def test_stream_concatenation_matches_synthesize(pipelines, run_buckets):
    """The JAX package's own bound (tests/test_pipeline.py) for streamed
    against one-shot audio; lengths exactly equal."""
    _, pp = pipelines
    full = pp.synthesize(FITS)
    streamed = np.concatenate(list(pp.stream(FITS, chunk_frames=16, context_frames=16)))
    assert streamed.shape == full.shape == (106 * HOP,)
    np.testing.assert_allclose(streamed, full, atol=5e-3, rtol=0)
    assert run_buckets == [96, 160]  # the exact restart, as synthesize's re-run


def test_chunk_sizes(pipelines):
    _, pp = pipelines
    chunks = list(pp.stream("你好", chunk_frames=8))
    total = sum(c.shape[0] for c in chunks) // HOP
    assert total == len(pp.synthesize("你好")) // HOP
    assert len(chunks) == math.ceil(total / 8)
    assert all(c.shape[0] == 8 * HOP for c in chunks[:-1])
    assert 0 < chunks[-1].shape[0] <= 8 * HOP and chunks[-1].shape[0] % HOP == 0


def test_stream_warns_past_the_largest_bucket(pipelines, run_buckets):
    _, pp = pipelines
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        chunks = list(pp.stream(LONG, chunk_frames=32))
    assert any("truncated" in str(c.message) for c in caught)
    assert run_buckets == [160]  # the estimate is already the largest bucket
    assert sum(len(c) for c in chunks) == 160 * HOP
    assert len(chunks) == 5


def test_truncated_stream_matches_synthesize_at_the_bucket_end(pipelines):
    """A text that fills the largest bucket: the last window stops at the
    bucket's end, where synthesize's vocode pads, so the stream keeps to
    5e-3 there too.  (The JAX package's windows fill it with zero frames:
    its last chunk departs from its synthesize by ~0.14 here.)"""
    _, pp = pipelines
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        full = pp.synthesize(LONG)
        streamed = np.concatenate(list(pp.stream(LONG, chunk_frames=32, context_frames=16)))
    assert streamed.shape == full.shape == (160 * HOP,)
    np.testing.assert_allclose(streamed, full, atol=5e-3, rtol=0)


def test_warmup_smoke(pipelines):
    _, pp = pipelines
    pp.warmup(max_frames=96, streaming=True, batch_buckets=True)


def test_stream_entry_points_need_a_card_unless_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        inference.main(["--text", "你好", "--stream", "--output", str(tmp_path / "a.wav")])
    inference.main(["--text", "你好", "--stream", "--chunk-frames", "2", "--device", "cpu",
                    "--output", str(tmp_path / "b.wav")])
    assert (tmp_path / "b.wav").stat().st_size > 44
