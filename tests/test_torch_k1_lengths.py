"""K1's row lengths on the CPU, through its plain version (the contract the
kernel in csrc/ar_decode.cu keeps on the card): a row keeps frames below its
length with the bits of the decode without lengths, its frames at or past it
are exactly 0 and its cache rows there are left as they were; chained chunks
with lengths give the bits of one launch; and `acoustic_inference`, which
passes each row's total, gives the masked mel of the whole-bucket decode.

This file imports only torch, numpy and the port (never JAX)."""

import numpy as np
import pytest
import torch

from sambert_hifigan_tpu_torch import config as c
from sambert_hifigan_tpu_torch import pipeline as pipeline_mod
from sambert_hifigan_tpu_torch.config import DecoderConfig
from sambert_hifigan_tpu_torch.models import ar_decoder as p_ar
from sambert_hifigan_tpu_torch.models.layers import init_defaults_
from sambert_hifigan_tpu_torch.ops import ar_decode as k1
from sambert_hifigan_tpu_torch.pipeline import TTSPipeline
from sambert_hifigan_tpu_torch.weights import random_acoustic_model, random_generator

D, MELS = 32, 80
DEC = dict(n_layers=2, n_heads=4, d_ff=64, dropout=0.0, max_len=64)
T, B = 16, 4
DTYPES = [torch.float32, torch.bfloat16]
DTYPE_IDS = ["f32", "bf16"]


@pytest.fixture(scope="module")
def decoder():
    gen = torch.Generator().manual_seed(3)
    dec = p_ar.PNCAARDecoder(D, MELS, DecoderConfig(**DEC))
    init_defaults_(dec, gen)
    dec.init_weights_(gen)
    return dec.eval()


def _inputs(dec, dtype, b=B, t=T):
    """Packed weights and memory; row r's memory padded from 12 - 2r on."""
    hvar = torch.from_numpy(np.random.default_rng(40 + b).standard_normal((b, t, D))
                            .astype(np.float32))
    mask = torch.zeros(b, t, dtype=torch.bool)
    for r in range(b):
        mask[r, max(1, 12 - 2 * r):] = True
    w = p_ar.pack_decoder(dec, dtype)
    return w, p_ar.decode_memory(dec, hvar * (~mask)[:, :, None], mask, w)


def _decode(w, memory, lengths=None, chunk=T):
    """The decode of T frames in chunks from a fresh carry -> (mel, carry)."""
    b = memory.mem_k.shape[1]
    carry = k1.init_carry(w, b, T)
    mels = []
    for pos in range(0, T, chunk):
        carry, mel = k1.ar_decode_chunk(w, *memory, carry, pos, min(chunk, T - pos), lengths)
        mels.append(mel)
    return torch.cat(mels, dim=1), carry


def _i32(*v):
    return torch.tensor(v, dtype=torch.int32)


@pytest.mark.parametrize("lengths", [None, (T,) * B, (T + 5, T, T + 1, 1000)],
                         ids=["none", "every-row-full", "past-the-end"])
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_full_lengths_give_the_decode_without_lengths(decoder, dtype, lengths):
    """Lengths at or past T change nothing: the mel, the carried frame and
    both caches keep every bit of the decode without lengths."""
    w, memory = _inputs(decoder, dtype)
    want, want_carry = _decode(w, memory)
    got, carry = _decode(w, memory, None if lengths is None else _i32(*lengths))
    assert torch.isfinite(want).all() and want.abs().sum() > 0
    assert torch.equal(got, want)
    for a, b in zip(carry, want_carry):
        assert torch.equal(a, b)
    assert torch.equal(carry.prev_mel, want[:, -1])


@pytest.mark.parametrize("lengths", [(0, 5, T, 9), (T, 1, 0, 3), (7, 7, 7, 7), (0, 0, 0, 0)],
                         ids=["zero-and-full", "one-full-row", "equal", "all-zero"])
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_ragged_lengths_keep_the_kept_frames_bits(decoder, dtype, lengths):
    """Frames below each row's length equal the whole decode's bit for bit;
    those at or past it are exactly 0, and so is the carried frame of a
    finished row; cache rows at or past it are never written (still the
    fresh carry's zeros)."""
    w, memory = _inputs(decoder, dtype)
    full, full_carry = _decode(w, memory)
    got, carry = _decode(w, memory, _i32(*lengths))
    for r, n in enumerate(lengths):
        assert torch.equal(got[r, :n], full[r, :n])
        assert torch.equal(got[r, n:], torch.zeros_like(got[r, n:]))
        for cache, want in ((carry.k_cache, full_carry.k_cache), (carry.v_cache, full_carry.v_cache)):
            assert torch.equal(cache[:, r, :n], want[:, r, :n])
            assert not cache[:, r, n:].any()
    assert torch.equal(carry.prev_mel, got[:, -1])


@pytest.mark.parametrize("chunk", [4, 5, 1], ids=["divides-T", "does-not-divide-T", "one-step"])
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_chained_chunks_with_lengths_equal_one_launch(decoder, dtype, chunk):
    """Chunks from the carry with the same lengths give the one launch's
    bits: mel and caches.  Row 1 ends inside a chunk, row 2 at a chunk's
    start, row 0 never starts."""
    w, memory = _inputs(decoder, dtype)
    lengths = _i32(0, 7, 8, T)
    one, one_carry = _decode(w, memory, lengths)
    chained, carry = _decode(w, memory, lengths, chunk)
    assert torch.equal(chained, one)
    for a, b in zip(carry, one_carry):
        assert torch.equal(a, b)


def _tiny_cfg():
    return c.TTSConfig(
        acoustic_model=c.AcousticModelConfig(
            d_model=32, encoder=c.EncoderConfig(n_layers=1, n_heads=4, d_ff=64),
            decoder=c.DecoderConfig(n_layers=1, n_heads=4, d_ff=64, max_len=256)),
        vocoder=c.VocoderConfig(generator=c.GeneratorConfig(
            upsample_initial_channel=32, resblock_kernel_sizes=(3,),
            resblock_dilation_sizes=((1, 3),))),
        runtime=c.RuntimeConfig(phoneme_buckets=(8, 16), frame_buckets=(96, 160)),
    )


@pytest.fixture(scope="module")
def states():
    """~15 frames a phoneme (the duration bias raised): 你好 76 frames,
    今天天气 113 (114 in bf16), abc 93."""
    cfg = _tiny_cfg()
    gen = torch.Generator().manual_seed(0)
    acoustic, generator = random_acoustic_model(cfg, gen), random_generator(cfg, gen)
    with torch.no_grad():
        lin = acoustic.variance_adaptor.duration_predictor.linear
        lin.bias.fill_(2.9)
        lin.weight.mul_(0.1)
    return cfg, acoustic.state_dict(), generator.state_dict()


@pytest.mark.parametrize("max_frames", [96, 160], ids=["one-row-past-the-bucket", "all-fit"])
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_acoustic_inference_equals_the_masked_whole_bucket_decode(states, monkeypatch, dtype,
                                                                    max_frames):
    """`acoustic_inference` hands K1 each row's total within the bucket, and
    its mel_pred is the whole-bucket decode's masked mel, bit for bit."""
    pipe = TTSPipeline(*states, device="cpu", dtype=dtype)
    _, (args,) = pipe._split_args(["你好", "今天天气", "abc"])
    seen = []
    plain = k1.ar_decode_plain

    def spy(*a):
        seen.append(a[-1])
        return plain(*a)

    monkeypatch.setattr(k1, "ar_decode_plain", spy)
    out = pipe._acoustic(args, max_frames, 1.0, 0.0, 1.0)
    (lengths,) = seen
    totals = out.total_frames.tolist()
    assert lengths.dtype == torch.int32
    assert lengths.tolist() == [min(n, max_frames) for n in totals]
    assert totals[0] < 96 < totals[1] < 160 and len(set(totals)) == 3  # ragged
    va = pipe._encode(args, max_frames, 1.0, 0.0, 1.0)
    with pipeline_mod._ieee_f32():
        full = p_ar.ar_decode(pipe.acoustic.ar_decoder, va.hvar, max_frames, ~va.frame_mask,
                              weights=pipe.decode_weights)
    assert seen[-1] is None
    want = full * va.frame_mask[:, :, None].to(full.dtype)
    assert torch.equal(out.frame_mask, va.frame_mask)
    assert torch.equal(out.mel_pred, want)
    assert out.mel_pred[1, :lengths[1]].abs().sum(-1).gt(0).all()
