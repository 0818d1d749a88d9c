"""The port's bf16 pipeline, `TTSPipeline(dtype=torch.bfloat16)`, against
the JAX bf16 pipeline on the CPU, and the port's own rules in bf16.

The JAX side runs its kernels' own math: `SAMBERT_PALLAS_DECODE=1` takes
`pallas_ar_decode` in interpret mode (on the CPU the JAX decode otherwise
takes its XLA scan, which keeps its activations in bf16, not the kernel's
math), and the vocoder is the JAX `FusedGenerator` with `fused_mrf` in
interpret mode.  The decode kernel needs d_model >= 128, so the config is
tests/test_torch_pipeline.py's small one at d_model 128; its duration bias
of 2.9 makes one text overflow the first frame bucket.  The JAX weights are
carried into the port with `sambert_hifigan_tpu_torch.weights`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sambert_hifigan_tpu.ops.pallas.decode_kernel as j_decode_kernel
from sambert_hifigan_tpu import config as jcfg
from sambert_hifigan_tpu.models.fused_generator import FusedGenerator
from sambert_hifigan_tpu.pipeline import build_pipeline_from_random_init as j_build

from sambert_hifigan_tpu_torch import config as pcfg
from sambert_hifigan_tpu_torch.models.ar_decoder import ar_decode, decode_memory
from sambert_hifigan_tpu_torch.ops import ar_decode as k1
from sambert_hifigan_tpu_torch.pipeline import TTSPipeline, _StreamRun
from sambert_hifigan_tpu_torch.weights import (
    acoustic_state_dict_from_flax,
    generator_state_dict_from_flax,
)

from tests.test_torch_discriminators import one_torch_thread  # noqa: F401 (a fixture)
from tests.test_torch_pipeline import TEXTS

BF16 = torch.bfloat16
HOP = 256
FIRST, SECOND = 96, 160  # the config's frame buckets
PADDED = TEXTS + TEXTS[-1:]  # the batch bucket synthesize_batch pads 3 texts to
EDGE = 8 * HOP  # wav samples at either end of a bucket where fused_mrf departs


def _cfg(c):
    return c.TTSConfig(
        acoustic_model=c.AcousticModelConfig(
            d_model=128,
            encoder=c.EncoderConfig(n_layers=2, n_heads=4, d_ff=64),
            decoder=c.DecoderConfig(n_layers=2, n_heads=4, d_ff=64, max_len=256),
        ),
        vocoder=c.VocoderConfig(generator=c.GeneratorConfig(upsample_initial_channel=64)),
        runtime=c.RuntimeConfig(phoneme_buckets=(8, 16), frame_buckets=(FIRST, SECOND)),
    )


@pytest.fixture(scope="module")
def bf16():
    """(JAX outputs, the port's bf16 pipeline, the port's f32 pipeline on
    the same weights): the JAX bf16 text_to_mel of PADDED at the second
    bucket through pallas_ar_decode, the bf16 hvar its encode gives, the
    launches, and the JAX FusedGenerator's wav of that mel."""
    jp = j_build(_cfg(jcfg), 0, jnp.bfloat16)
    ap = jax.device_get(jp.acoustic_params)
    gp = jax.device_get(jp.generator_params)
    lin = ap["params"]["variance_adaptor"]["duration_predictor"]["linear"]
    lin["bias"] = np.full_like(lin["bias"], 2.9)
    lin["kernel"] = lin["kernel"] * 0.1
    jp.acoustic_params = jax.tree.map(jnp.asarray, ap)
    launches = []
    kernel = j_decode_kernel.pallas_ar_decode
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SAMBERT_PALLAS_DECODE", "1")
        mp.setattr(j_decode_kernel, "pallas_ar_decode",
                   lambda *a, **k: launches.append(a[3]) or kernel(*a, **k))
        jo = jp.text_to_mel(PADDED, max_frames=SECOND)
    tph, args = jp._frontend_args(PADDED, 1.0, 0.0, 1.0)
    hvar = jp._encode_fn(tph, SECOND)(jp.acoustic_params, *args).hvar
    gen = FusedGenerator(jp.cfg.vocoder.generator, gp, dtype=jnp.bfloat16, interpret=True)
    jwav = gen(jnp.swapaxes(jo.mel_pred, 1, 2))
    j = dict(total_frames=np.asarray(jo.total_frames), frame_mask=np.asarray(jo.frame_mask),
             mel=np.asarray(jo.mel_pred.astype(jnp.float32)), wav=np.asarray(jwav),
             hvar=np.array(hvar.astype(jnp.float32)), mel_dtype=jo.mel_pred.dtype,
             launches=launches)
    states = acoustic_state_dict_from_flax(ap), generator_state_dict_from_flax(gp)
    pp = TTSPipeline(_cfg(pcfg), *states, device="cpu", dtype=BF16)
    return j, pp, TTSPipeline(_cfg(pcfg), *states, device="cpu")


def _f32(t):
    return t.float().numpy()


def test_bf16_text_to_mel_matches_jax_pallas_decode(bf16):
    """Durations, totals and masks are JAX's exactly; the port's bf16
    decode of the JAX bf16 encode is JAX's pallas_ar_decode of it within
    bf16 noise; and end to end the two bf16 mels are nearer each other than
    JAX's bf16 mel is to the f32 one.

    End to end they are not equal within bf16 noise: the energy predictor's output lies
    near 1 in these weights, where one bf16 ulp (2^-8) is one of the 256
    energy bins over [0, 1], so an ulp either way picks another embedding
    row; XLA:CPU also keeps some bf16 intermediates in f32 inside its
    fusions (the JAX predictor alone departs from the JAX pipeline's by
    about 0.018), so JAX's own bf16 bins depend on its fusion.  About half
    the frames take another energy bin (174 of 358 measured) while every
    duration, and so every integer output, agrees.  So end to end the test
    holds the two bf16 mels to the departure bf16 itself makes from f32."""
    j, pp, p32 = bf16
    assert j["launches"] == [SECOND], "the JAX side must run pallas_ar_decode"
    assert j["mel_dtype"] == jnp.bfloat16
    po = pp.text_to_mel(PADDED, max_frames=SECOND)
    assert po.mel_pred.dtype == BF16
    np.testing.assert_array_equal(po.total_frames.numpy(), j["total_frames"])
    np.testing.assert_array_equal(po.frame_mask.numpy(), j["frame_mask"])
    assert j["total_frames"].max() > FIRST, "one text must overflow the first frame bucket"
    # the decode alone: bf16 memory K/V projected from the same bf16 hvar,
    # the kernel's rounding points on both sides; oneDNN and XLA:CPU sum in
    # other orders, so now and then a product on a bf16 rounding boundary
    # rounds the other way and the autoregression carries it on (measured:
    # max 0.023, mean 1.9e-3)
    mask = torch.from_numpy(j["frame_mask"])
    with torch.no_grad():
        mel = ar_decode(pp.acoustic.ar_decoder, torch.from_numpy(j["hvar"]).to(BF16), SECOND,
                        ~mask, weights=pp.decode_weights)
    err = np.abs(_f32(mel) * j["frame_mask"][:, :, None] - j["mel"])
    assert err.max() < 0.05 and err.mean() < 5e-3, (err.max(), err.mean())
    # end to end (measured: port bf16 to JAX bf16 0.184 mean, JAX bf16 to
    # f32 0.230, port bf16 to f32 0.258)
    f32 = p32.text_to_mel(PADDED, max_frames=SECOND).mel_pred.numpy()
    between = np.abs(_f32(po.mel_pred) - j["mel"]).mean()
    assert between < np.abs(j["mel"] - f32).mean(), between
    assert np.abs(_f32(po.mel_pred) - f32).mean() < 1.5 * np.abs(j["mel"] - f32).mean()


def test_bf16_vocoder_matches_jax_fused_generator(bf16):
    """The same bf16 mel through the port's generator (K2's plain version
    over bf16 weights) and the JAX FusedGenerator (fused_mrf in interpret
    mode).  fused_mrf zero-pads only its block input, so within EDGE of
    either end of the bucket it departs from the flax MRF, which the port
    follows (the largest departures, ~0.03, lie within 4 samples of the
    start); the interior differs by bf16 rounding flips of the convolutions
    around K2 only (measured: max 1.9e-3, mean 3.4e-4)."""
    j, pp, _ = bf16
    wav = pp.vocode(torch.from_numpy(j["mel"]).to(BF16)).numpy()
    assert wav.dtype == np.float32 and wav.shape == j["wav"].shape == (4, 1, SECOND * HOP)
    err = np.abs(wav - j["wav"])[:, 0]
    inner = err[:, EDGE:-EDGE]
    assert inner.max() < 5e-3 and inner.mean() < 1e-3, (inner.max(), inner.mean())
    assert np.concatenate([err[:, :EDGE], err[:, -EDGE:]], axis=1).max() > inner.max()


def test_bf16_synthesize_matches_jax_end_to_end(bf16):
    """synthesize_batch of the 3 texts, through the overflow re-run: wav
    lengths are the JAX totals, and each wav departs from the JAX bf16 wav
    (its text_to_mel through its FusedGenerator) by no more than 1.5 times
    the departure of that wav from the f32 one, for the energy bins of the
    text_to_mel test (measured ratios 1.10, 0.96, 0.73; each mean ~1e-3)."""
    j, pp, p32 = bf16
    wavs = pp.synthesize_batch(TEXTS)
    assert [len(w) for w in wavs] == [int(t) * HOP for t in j["total_frames"][:3]]
    for i, (w, w32) in enumerate(zip(wavs, p32.synthesize_batch(TEXTS))):
        jw = j["wav"][i, 0, :len(w)]
        assert np.abs(w - jw).mean() < 1.5 * np.abs(jw - w32).mean(), i


def test_bf16_stream_matches_bf16_synthesize(bf16):
    _, pp, _ = bf16
    for text in TEXTS[:2]:
        full = pp.synthesize(text)
        streamed = np.concatenate(list(pp.stream(text, chunk_frames=32, context_frames=16)))
        assert streamed.shape == full.shape
        np.testing.assert_allclose(streamed, full, atol=5e-3, rtol=0)


def test_bf16_chained_chunks_equal_one_shot(bf16):
    """The stream's decode, chunk by chunk from the carry with the text's
    total as its length, gives the bits of the one-shot bf16 decode with
    that length (below it those of the decode without lengths, past it 0),
    and its bf16 chunks those of text_to_mel."""
    _, pp, _ = bf16
    text = TEXTS[1]
    _, args = pp._frontend_args([text])
    run = _StreamRun(pp, args, (1.0, 0.0, 1.0), SECOND, 32, 16)
    run._ensure_decoded(SECOND)
    chained = torch.cat(run.chunks, dim=1)
    assert chained.dtype == BF16 and chained.shape[1] == SECOND
    va = pp._encode(args, SECOND, 1.0, 0.0, 1.0)
    assert va.hvar.dtype == BF16
    memory = decode_memory(pp.acoustic.ar_decoder, va.hvar, ~va.frame_mask, pp.decode_weights)
    one_shot = k1.ar_decode(pp.decode_weights, *memory, SECOND, run.total_dev)
    assert torch.equal(chained, one_shot.to(BF16))
    mel = pp.text_to_mel([text], max_frames=SECOND)
    total = int(mel.total_frames[0])
    assert 0 < total < SECOND and not chained[:, total:].any()
    full = k1.ar_decode(pp.decode_weights, *memory, SECOND)
    assert torch.equal(chained[:, :total], full[:, :total].to(BF16))
    assert torch.equal(chained[:, :total], mel.mel_pred[:, :total])


def test_bf16_replica_rows_equal_direct_calls(bf16):
    """devices=["cpu"] * 2 in bf16: each replica's rows are the bits of a
    single-device bf16 call on those rows at the batch's frame bucket."""
    _, pp, _ = bf16
    split = TTSPipeline(pp.cfg, pp.acoustic.state_dict(), pp.generator.state_dict(),
                        devices=["cpu"] * 2, dtype=BF16)
    assert all(rep.dtype == BF16 and rep.kernel_dtype == BF16 for rep in split.replicas)
    texts = ["你好", "今天天气", "abc", "山水"]
    wavs = split.synthesize_batch(texts)
    assert max(len(w) for w in wavs) > FIRST * HOP
    for r in range(2):
        rows = texts[2 * r:2 * r + 2]
        for got, want in zip(wavs[2 * r:2 * r + 2], pp.synthesize_batch(rows, max_frames=SECOND)):
            np.testing.assert_array_equal(got, want)


def test_f32_stays_the_default(bf16):
    """Without dtype the pipeline is the f32 one: f32 packed weights on the
    CPU, f32 mel, biases exact."""
    _, pp, _ = bf16
    p32 = TTSPipeline(pp.cfg, pp.acoustic.state_dict(), pp.generator.state_dict(), device="cpu")
    assert p32.dtype == torch.float32 and p32.kernel_dtype == torch.float32
    assert p32.decode_weights.bqkv.dtype == torch.float32
    assert torch.equal(p32.decode_weights.b1, torch.stack(
        [layer.ffn.linear1.bias for layer in p32.acoustic.ar_decoder.layers]))
    assert not torch.equal(pp.decode_weights.b1, p32.decode_weights.b1)
    assert torch.equal(pp.decode_weights.b1, p32.decode_weights.b1.to(BF16).float())
    out = p32.text_to_mel(TEXTS[:1])
    assert out.mel_pred.dtype == torch.float32
    with pytest.raises(ValueError, match="dtype"):
        TTSPipeline(pp.cfg, pp.acoustic.state_dict(), pp.generator.state_dict(),
                    device="cpu", dtype=torch.float16)
