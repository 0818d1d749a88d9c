"""VITS in the port (models/vits.py, pipeline.VitsPipeline) against the plain
f32 reference of jaywalnut310/vits's inference (tests/vits_reference.py) on
the CPU, at a tiny size with seeded random weights.  No JAX: VITS has no
JAX counterpart.

Tolerances: the port and the reference compute the same f32 arithmetic in
other orders (relative attention through a band instead of VITS's
pad-and-reshape, the path as a gather instead of a one-hot product, the
spline on every element), so results differ by float32 rounding carried
through ~40 layers (3e-8 and 7e-8 seen on the wav): 1e-5 on the wav (full
scale 1), 1e-5 on logw.  Lengths are integers and must be equal.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from sambert_hifigan_tpu_torch import tracing
from sambert_hifigan_tpu_torch.config import (
    AudioConfig, ConfigError, GeneratorConfig, RuntimeConfig, VitsConfig, VitsModelConfig,
)
from sambert_hifigan_tpu_torch.models import vits as pv
from sambert_hifigan_tpu_torch.models.hifigan import HiFiGANGenerator
from sambert_hifigan_tpu_torch.models.layers import LRELU_SLOPE, conv1d, conv_transpose1d
from sambert_hifigan_tpu_torch.models.layers import init_defaults_
from sambert_hifigan_tpu_torch.ops.mrf import mrf
from sambert_hifigan_tpu_torch.pipeline import VitsPipeline
from sambert_hifigan_tpu_torch.text.frontend import FrontEnd
from sambert_hifigan_tpu_torch.weights import random_vits_state

from tests import vits_reference as ref

TEXTS = ["ab", "hello there", "x"]
WAV_TOL = 1e-5
LOGW_TOL = 1e-5


def tiny_config(**model) -> VitsConfig:
    m = VitsModelConfig(n_vocab=40, inter_channels=8, hidden_channels=16, filter_channels=32,
                        n_layers=2, dp_filter_channels=16, flow_couplings=2, flow_layers=2,
                        **model)
    g = GeneratorConfig(n_mels=8, upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
                        upsample_initial_channel=16, resblock_kernel_sizes=(3, 5),
                        resblock_dilation_sizes=((1, 3), (1, 3)), post_lrelu_slope=0.01,
                        post_bias=False)
    return VitsConfig(audio=AudioConfig(hop_length=4), model=m, generator=g,
                      runtime=RuntimeConfig(phoneme_buckets=(8, 16), frame_buckets=(64, 128, 256),
                                            batch_buckets=(1, 2, 4)))


def ref_config(cfg: VitsConfig) -> dict:
    """The reference's configuration keys for a port config."""
    g, rt = cfg.generator, cfg.runtime
    return {**dataclasses.asdict(cfg.model),
            "upsample_rates": list(g.upsample_rates),
            "upsample_kernel_sizes": list(g.upsample_kernel_sizes),
            "upsample_initial_channel": g.upsample_initial_channel,
            "resblock_kernel_sizes": list(g.resblock_kernel_sizes),
            "resblock_dilation_sizes": [list(d) for d in g.resblock_dilation_sizes],
            "hop_length": cfg.audio.hop_length, "phoneme_buckets": list(rt.phoneme_buckets),
            "frame_buckets": list(rt.frame_buckets)}


def pin(state, frames: float, spread: float):
    """The duration predictor's last affine set so that logw = log(frames)
    + spread x z0."""
    state = dict(state)
    state["dp.flows.0.logs"] = torch.full((2, 1), -math.log(spread))
    state["dp.flows.0.m"] = torch.full((2, 1), -math.log(frames) / spread)
    return state


def weights(cfg, seed=0):
    return random_vits_state(cfg, torch.Generator().manual_seed(seed))


def ref_rows(texts, cfg):
    fe = FrontEnd(cfg.model.n_vocab)
    return [fe.text_to_sequence(t)[0] for t in texts]


@pytest.mark.parametrize("frames,spread", [(3.0, 0.3), (7.5, 0.05)])
def test_pipeline_matches_reference(frames, spread):
    """synthesize_batch (3 texts, padded to batch bucket 4) against the
    reference: every row's length exactly, every sample within WAV_TOL.
    Durations near 3 frames a token vary by row and token; at 7.5 (~15
    frames a phoneme, over the 12 the first bucket assumes) the longest
    text overflows its first frame bucket and both take the re-run."""
    cfg = tiny_config()
    state = pin(weights(cfg), frames, spread)
    pipe = VitsPipeline(cfg, state, device="cpu", noise_seed=11)
    got = pipe.synthesize_batch(TEXTS)
    want = ref.synthesize_batch(state, ref_config(cfg), ref_rows(TEXTS, cfg), ref.identity,
                                torch.device("cpu"), 11)
    assert [len(w) for w in got] == [len(w) for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=WAV_TOL)
    if frames > 6:
        assert len(want[1]) // 4 > 128  # past the first bucket of "hello there" (tph 16)


def test_bf16_pipeline_keeps_lengths_and_stays_near_reference():
    """The bf16 pipeline (the encoder's and flow's convolutions and the
    generator in bf16; the duration predictor in f32): the same lengths as
    the f32 reference, every sample within 1e-2 (bf16's 2^-8 through ~40
    layers; 2.0e-3 seen)."""
    cfg = tiny_config()
    state = pin(weights(cfg), 5.5, 1e-4)
    got = VitsPipeline(cfg, state, device="cpu", dtype=torch.bfloat16).synthesize_batch(TEXTS)
    want = ref.synthesize_batch(state, ref_config(cfg), ref_rows(TEXTS, cfg), ref.identity,
                                torch.device("cpu"), 0)
    assert [len(w) for w in got] == [len(w) for w in want] == [
        4 * 6 * (2 * (len(t) + 2) + 1) for t in TEXTS]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-2)


def test_benchmark_carries_the_same_reference():
    """benchmark/reference/vits.py is this suite's oracle, byte for byte."""
    from pathlib import Path

    here = Path(__file__).resolve().parent
    assert (here / "vits_reference.py").read_bytes() == \
        (here.parent / "benchmark" / "reference" / "vits.py").read_bytes()


def test_unpinned_logw_matches_reference():
    """The duration predictor with every weight random (its affine too):
    logw of the port against the reference's on the same encoding and noise,
    at the valid tokens; the pin of the benchmark would hide a fault here."""
    cfg = tiny_config()
    c = ref_config(cfg)
    state = weights(cfg, 3)
    model = pv.VitsModel(cfg.model)
    model.load_state_dict(pv.load_vits_state(state, cfg.generator)[0])
    gen = torch.Generator().manual_seed(5)
    tokens = torch.randint(1, cfg.model.n_vocab, (3, 17), generator=gen)
    lengths = torch.tensor([17, 9, 4])
    mask = (torch.arange(17)[None, :] < lengths[:, None])[:, None].float()
    z = torch.randn(3, 2, 17, generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        x, _, _ = model.enc_p(tokens, mask)
        got = model.dp.reverse(x, mask, z * cfg.model.noise_scale_w)
        xr, _, _ = ref.text_encoder(state, c, tokens, mask, ref.identity)
        want = ref.duration_reverse(state, c, xr, mask, z, ref.identity)
    assert got.abs().max() > 0.1  # the flows moved the noise
    np.testing.assert_allclose((got * mask).numpy(), (want * mask).numpy(), rtol=0, atol=LOGW_TOL)


def _spline_params(shape, bins, seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(*shape, bins, generator=g) * 2, torch.randn(*shape, bins, generator=g) * 2,
            torch.randn(*shape, bins - 1, generator=g) * 2)


def test_spline_inverse_undoes_forward():
    """The port's rational-quadratic spline: inverse(forward(x)) = x, inside
    the tails and out (the identity there); each direction equals the
    reference's on the same bins."""
    x = torch.linspace(-7.0, 7.0, 301, dtype=torch.float64)[None]
    uw, uh, ud = (t.double() for t in _spline_params(x.shape, 10, 1))
    y = pv.rational_quadratic(x, uw, uh, ud, 5.0, inverse=False)
    back = pv.rational_quadratic(y, uw, uh, ud, 5.0, inverse=True)
    np.testing.assert_allclose(back.numpy(), x.numpy(), atol=1e-9)
    outside = x.abs() > 5.0
    assert torch.equal(y[outside], x[outside]) and bool((y[~outside] != x[~outside]).any())
    for got, inp, inverse in ((y, x, False), (back, y, True)):
        want, _ = ref.spline(inp, uw, uh, ud, inverse, 5.0)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-12)


def _direct_attention(att, x, key_pad):
    """The O(T^2) form: every (i, j) gathers its offset's embeddings."""
    b, c, t = x.shape
    h, dk, w = att.n_heads, att.k_channels, att.window

    def heads(y):
        return y.view(b, h, dk, t).transpose(2, 3)

    q = heads(att.conv_q(x)) / math.sqrt(dk)
    k, v = heads(att.conv_k(x)), heads(att.conv_v(x))
    off = torch.arange(t)[None, :] - torch.arange(t)[:, None]  # j - i
    near = off.abs() <= w
    ek = att.emb_rel_k[0][(off + w).clamp(0, 2 * w)] * near[..., None]  # [T, T, dk]
    ev = att.emb_rel_v[0][(off + w).clamp(0, 2 * w)] * near[..., None]
    scores = q @ k.transpose(2, 3) + torch.einsum("bhid,ijd->bhij", q, ek)
    p = torch.softmax(scores.masked_fill(key_pad, -1e4), dim=-1)
    out = p @ v + torch.einsum("bhij,ijd->bhid", p, ev)
    return att.conv_o(out.transpose(2, 3).reshape(b, c, t))


@pytest.mark.parametrize("t", [1, 3, 5, 9, 14])
def test_relative_attention_matches_direct_gather(t):
    """The port's banded relative attention (window 4) against a direct
    gather of each pair's offset, and VITS's pad-and-reshape form (the
    reference), with the second row's keys padded past 2."""
    torch.manual_seed(t)
    att = pv.RelativeAttention(8, 2, 4)
    for p in att.parameters():
        torch.nn.init.normal_(p, 0.0, 0.5)
    x = torch.randn(2, 8, t)
    lengths = torch.tensor([t, min(t, 2)])
    valid = torch.arange(t)[None, :] < lengths[:, None]
    key_pad = ~valid[:, None, None, :]
    with torch.no_grad():
        got = att(x, key_pad)
        want = _direct_attention(att, x, key_pad)
        P = {f"a.{k}": v for k, v in att.state_dict().items()}
        m = valid[:, None].float()
        vits = ref.attention(P, "a", x, m.unsqueeze(2) * m.unsqueeze(-1),
                             dict(n_heads=2, window_size=4), ref.identity)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    sel = valid[:, None].expand_as(got)  # VITS fills padded query rows apart
    np.testing.assert_allclose(got[sel].numpy(), vits[sel].numpy(), atol=1e-5)


def test_coupling_flow_reverse_undoes_forward():
    """The residual coupling block (mean-only couplings over the WaveNet,
    with flips) run forward then in reverse gives its input back where the
    mask is on, and moves it on the way."""
    cfg = tiny_config()
    model = pv.VitsModel(cfg.model)
    model.init_weights_(torch.Generator().manual_seed(2))
    x = torch.randn(2, 8, 20)
    mask = (torch.arange(20)[None, :] < torch.tensor([20, 13])[:, None])[:, None].float()
    with torch.no_grad():
        y = model.flow(x * mask, mask)
        back = model.flow.reverse(y, mask)
    assert (y - x * mask).abs().max() > 0.1
    np.testing.assert_allclose(back.numpy(), (x * mask).numpy(), atol=1e-5)


def test_row_noise_ignores_neighbours_and_bucket():
    """A text's seed and its noise are the same alone and beside a longer
    text that moves its phoneme bucket (the draw has one shape, and a bucket
    takes its first tokens and frames), and they are the reference's at
    either bucket."""
    cfg = tiny_config()
    pipe = VitsPipeline(cfg, weights(cfg), device="cpu", noise_seed=4)
    alone_tph, (tok_a, _, seed_a) = pipe._features(["ab"])
    mixed_tph, (tok_b, _, seed_b) = pipe._features(["a longer text", "ab"])
    assert alone_tph != mixed_tph and seed_a[0] == seed_b[1]
    assert seed_b[0] != seed_b[1]
    za, ea = pv.noise_buffers(1, 33, 256, 8, "cpu")
    zb, eb = pv.noise_buffers(2, 33, 256, 8, "cpu")
    pv.draw_noise([int(seed_a[0])], za, ea)
    pv.draw_noise([int(s) for s in seed_b], zb, eb)
    assert torch.equal(za[0], zb[1]) and torch.equal(ea[0], eb[1])
    assert not torch.equal(zb[0], zb[1])
    c, cpu = ref_config(cfg), torch.device("cpu")
    for tokens, frames in ((tok_a.shape[1], 64), (tok_b.shape[1], 128)):
        z_r, e_r = ref.noise(int(seed_a[0]), c, tokens, frames, cpu)
        assert torch.equal(z_r, za[0, :tokens].T) and torch.equal(e_r, ea[0, :frames].T)


def test_published_checkpoint_layout_loads():
    """A state_dict in a published checkpoint's layout (weight norm on the
    generator and the WaveNet, the posterior encoder and flows present)
    gives the same audio as its folded form."""
    cfg = tiny_config()
    folded = pin(weights(cfg), 3.0, 0.3)
    published = {}
    for k, v in folded.items():
        normed = k.endswith(".weight") and (".in_layers." in k or ".res_skip_layers." in k
                                            or k.startswith(("dec.ups.", "dec.resblocks.")))
        if normed:
            g = v.square().sum(dim=tuple(range(1, v.dim())), keepdim=True).sqrt()
            published[k[:-6] + "weight_g"], published[k[:-6] + "weight_v"] = g, v * 2.0
        else:
            published[k] = v
    published["enc_q.proj.weight"] = torch.zeros(3)
    published["dp.post_pre.weight"] = torch.zeros(3)
    a = VitsPipeline(cfg, folded, device="cpu").synthesize_batch(TEXTS)
    b = VitsPipeline(cfg, published, device="cpu").synthesize_batch(TEXTS)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y, rtol=0, atol=1e-6)
    gen = pv.generator_state_from_vits(folded, cfg.generator)
    assert "mrfs.1.resblocks.1.convs2.1.weight" in gen and "conv_post.bias" not in gen
    assert pv.vits_state_from_generator(gen, cfg.generator) == {
        k: v for k, v in folded.items() if k.startswith("dec.")}


def test_two_replicas_match_one():
    """Over two CPU replicas the rows split and every wav matches the
    single-device pipeline's."""
    cfg = tiny_config()
    state = pin(weights(cfg), 3.0, 0.3)
    one = VitsPipeline(cfg, state, device="cpu", noise_seed=2).synthesize_batch(TEXTS)
    two = VitsPipeline(cfg, state, devices=["cpu", "cpu"], noise_seed=2).synthesize_batch(TEXTS)
    assert [len(w) for w in one] == [len(w) for w in two]
    for a, b in zip(one, two):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_spans_and_counters_of_a_vits_call():
    """With tracing on, one synthesize_batch records vits.encode,
    vits.duration and vits.flow inside batch.acoustic, vits.tokens (with
    blanks, the padded rows included) and vits.frames per pass, and no
    batch.k1_steps."""
    cfg = tiny_config()
    pipe = VitsPipeline(cfg, pin(weights(cfg), 3.0, 0.3), device="cpu")
    tracing.reset()
    tracing.enable(True)
    try:
        wavs = pipe.synthesize_batch(TEXTS)
        snap = tracing.snapshot()
        spans = tracing.spans()
    finally:
        tracing.enable(False)
        tracing.reset()
    for name in ("vits.encode", "vits.duration", "vits.flow"):
        assert snap["spans"][name]["n"] == 1 and name in snap["device"]
    parent = {s.name: s for s in spans}["batch.acoustic"]
    assert all(s.parent == parent.id for s in spans if s.name.startswith("vits."))
    counters = snap["counters"]
    rows = [2 * (len(t) + 2) + 1 for t in TEXTS]
    assert counters["vits.tokens"] == sum(rows) + rows[-1]  # padded to 4 rows
    returned = sum(len(w) for w in wavs) // 4
    assert counters["vits.frames"] == returned + len(wavs[-1]) // 4
    assert "batch.k1_steps" not in counters


def test_what_vits_does_not_take():
    cfg = tiny_config()
    pipe = VitsPipeline(cfg, weights(cfg), device="cpu")
    with pytest.raises(NotImplementedError, match="does not stream"):
        pipe.stream("ab")
    with pytest.raises(ValueError, match="no pitch or energy"):
        pipe.synthesize_batch(["ab"], pitch_shift=1.0)
    bad = dataclasses.replace(cfg, generator=dataclasses.replace(cfg.generator, n_mels=80))
    with pytest.raises(ConfigError, match="flow's 8 channels"):
        VitsPipeline(bad, weights(cfg), device="cpu")


def test_generator_default_keeps_its_bits():
    """At the default post_lrelu_slope (0.1) and post_bias (on) the
    generator's forward is bit for bit the one with LeakyReLU 0.1 and a
    biased conv_post written out, through K2's plain version as inference
    runs it, f32 and bf16."""
    cfg = GeneratorConfig(n_mels=8, upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
                          upsample_initial_channel=16, resblock_kernel_sizes=(3,),
                          resblock_dilation_sizes=((1, 3),))
    assert (cfg.post_lrelu_slope, cfg.post_bias) == (0.1, True)
    gen = HiFiGANGenerator(cfg)
    init_defaults_(gen, torch.Generator().manual_seed(0))
    mel = torch.randn(2, 8, 12)
    for dtype in (torch.float32, torch.bfloat16):
        packed = gen.pack(torch.float32 if dtype == torch.float32 else torch.bfloat16)
        with torch.no_grad():
            got = gen(mel, packed, dtype)
            x = conv1d(gen.conv_pre, mel, dtype)
            for i, up in enumerate(gen.ups):
                x = conv_transpose1d(up, torch.nn.functional.leaky_relu(x, LRELU_SLOPE), dtype)
                x = mrf(x.float().contiguous(), packed[i]).to(dtype)
            x = torch.nn.functional.conv1d(
                torch.nn.functional.leaky_relu(x, 0.1), gen.conv_post.weight.to(dtype),
                gen.conv_post.bias.to(dtype), padding=3)
        assert torch.equal(got, torch.tanh(x.float()))
