"""The port's hand-written CUDA kernels against their plain versions, on the
card.  Every test here needs a CUDA card and skips elsewhere.

This file imports only torch, numpy and the port (never JAX), so that it also
runs where JAX is not installed.  The repo's conftest imports JAX, so on such
a machine run it without the conftest:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

# bind the stdlib `profile` before a test puts scripts/ (and its profile.py) on
# sys.path: torch.optim imports torch._dynamo, and so cProfile, at first use
import cProfile  # noqa: F401
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
    ref = _plain_one_shot(w, mk, mv, bias, t)
    err = (out - ref).abs()
    assert err.mean() < 5e-3 and err.max() < 5e-2, (err.mean().item(), err.max().item())


def _full_width_inputs(dev, b, t, n_layers):
    """K1's weights and memory at the default decoder's widths (d 256, 8
    heads, d_ff 2048).  Suffix masks leave ~5% of the memory valid, so most
    key tiles are skipped; the last row of B > 1 has all its memory masked (a
    uniform softmax, never skipped)."""
    gen = torch.Generator().manual_seed(7)
    dec = p_ar.PNCAARDecoder(256, MELS, DecoderConfig(n_layers=n_layers, n_heads=8, d_ff=2048,
                                                      dropout=0.0, max_len=max(512, t)))
    init_defaults_(dec, gen)
    dec.init_weights_(gen)
    dec = dec.to(dev).eval()
    mask = torch.zeros(b, t, dtype=torch.bool)
    for row in range(b):
        mask[row, max(1, (t * (3 + row % 5)) // 100):] = True
    if b > 1:
        mask[-1] = True
    hvar = torch.from_numpy(_np(70 + b, b, t, 256)) * (~mask)[:, :, None]
    w = p_ar.pack_decoder(dec, torch.bfloat16)
    mk, mv = p_ar.precompute_memory_packed(dec, hvar.to(dev))
    bias = torch.where(mask, k1.NEG_INF, 0.0).float().to(dev).contiguous()
    return w, mk.bfloat16().contiguous(), mv.bfloat16().contiguous(), bias


def _plain_one_shot(w, mk, mv, bias, t):
    return k1.ar_decode_plain(w, mk, mv, bias, k1.init_carry(w, mk.shape[1], t), 0, t)[1]


def _k1_full_width(dev, b, t, n_layers, plan):
    """K1 on `plan` against its plain version at full width.  Tolerance as
    chip_smoke.py's K1 phase: mean 1e-2, max 0.1."""
    w, mk, mv, bias = _full_width_inputs(dev, b, t, n_layers)
    before = k1.launches
    out = k1.ar_decode(w, mk, mv, bias, t, plan=plan)
    torch.cuda.synchronize()
    assert k1.launches == before + 1
    ref = _plain_one_shot(w, mk, mv, bias, t)
    assert torch.isfinite(out).all()
    err = (out - ref).abs()
    assert err.mean() < 1e-2 and err.max() < 0.1, (err.mean().item(), err.max().item())


def _fewest_clusters(b, t, n_layers):
    """The plan of a card that runs one cluster at once: as few as fit."""
    return k1.launch_plan(b, t, t, n_layers, 256, 8, 2048, MELS, max(512, t), max_clusters=1)


@pytest.mark.parametrize("t", [24, 300])
@pytest.mark.parametrize("b", [1, 4, 16])
def test_k1_kernel_matches_plain_at_full_width(cuda_device, b, t):
    """Two layers: one cluster of 16 CTAs for up to 16 rows."""
    plan = _fewest_clusters(b, t, 2)
    assert (plan.cluster, plan.groups) == (16, 1)
    _k1_full_width(cuda_device, b, t, 2, plan)


@pytest.mark.parametrize("b,t,n_layers", [(19, 24, 2), (16, 2048, 6)],
                         ids=["B19-10+9-rows", "B16-T2048-6-layers"])
def test_k1_kernel_on_two_clusters(cuda_device, b, t, n_layers):
    """Shapes that the fewest clusters split over two, so the second indexes
    the memory, caches and mel at its own first row: 19 rows (10 + 9), and
    the pipeline's largest buckets (16 rows, 2048 frames, 6 layers: 8 + 8)."""
    plan = _fewest_clusters(b, t, n_layers)
    assert plan.groups == 2
    _k1_full_width(cuda_device, b, t, n_layers, plan)


@pytest.mark.parametrize("chunk", [30, 48], ids=["divides-T", "does-not-divide-T"])
@pytest.mark.parametrize("b", [1, 4, 19])
def test_k1_chunk_chain_equals_one_shot(cuda_device, b, chunk):
    """K1 launched chunk by chunk from its carry gives the one-shot launch's
    bits: the same plan (keyed by the caches' capacity T), the same steps,
    and the carried frame is the f32 value the mel exchange held.  B = 19
    runs several clusters (as many as the card runs at once, 3 rows each
    on an H100)."""
    t = 300
    w, mk, mv, bias = _full_width_inputs(cuda_device, b, t, 2)
    one = k1.ar_decode(w, mk, mv, bias, t)
    carry = k1.init_carry(w, b, t)
    before = k1.launches
    mels = []
    for pos in range(0, t, chunk):
        carry, mel = k1.ar_decode_chunk(w, mk, mv, bias, carry, pos, min(chunk, t - pos))
        mels.append(mel)
    torch.cuda.synchronize()
    assert k1.launches == before + len(mels)
    assert torch.isfinite(one).all()
    assert torch.equal(torch.cat(mels, dim=1), one)


def test_k1_refuses_chunks_outside_the_carry(cuda_device):
    w, mk, mv, bias = _full_width_inputs(cuda_device, 2, 40, 2)
    carry = k1.init_carry(w, 2, 40)
    before = k1.launches
    for pos0, steps in ((30, 11), (0, 0), (-1, 4)):
        with pytest.raises(ValueError, match="capacity"):
            k1.ar_decode_chunk(w, mk, mv, bias, carry, pos0, steps)
    assert k1.launches == before


def _ragged(b, t, dev):
    """Row lengths with a row of length 0, one of the full T (the last) and
    the rest spread below T / 2, int32 on dev: at B = 20 every cluster but
    the last ends below T / 2, the last at T."""
    n = [(37 * r) % (t // 2) for r in range(b)]
    n[-1] = t if b > 1 else t // 3
    return torch.tensor(n, dtype=torch.int32, device=dev)


def _kept_frames_are_the_full_decodes(got, full, carry, full_carry, lengths):
    """Frames and cache rows below each row's length are the bits of the
    decode without lengths; frames at or past it are 0, cache rows there
    never written (the fresh carry's zeros)."""
    for r, n in enumerate(lengths.tolist()):
        assert torch.equal(got[r, :n], full[r, :n])
        assert not got[r, n:].any()
        for cache, want in ((carry.k_cache, full_carry.k_cache),
                            (carry.v_cache, full_carry.v_cache)):
            assert torch.equal(cache[:, r, :n], want[:, r, :n])
            assert not cache[:, r, n:].any()
    assert torch.equal(carry.prev_mel, got[:, -1])


@pytest.mark.parametrize("b,n_layers", [(1, 2), (4, 2), (16, 6), (20, 2)],
                         ids=["B1", "B4", "B16-6-layers", "B20-two-clusters"])
def test_k1_lengths_keep_the_kept_frames_bits(cuda_device, b, n_layers):
    """K1 with ragged lengths against K1 without, at full width (B = 16 the
    default decoder's constant-shape instantiation, B = 20 several clusters
    that stop at different steps: two of 10 rows on a card that runs one
    cluster at once, 7 of 3 rows on an H100): one launch each, kept frames and
    cache rows equal bit for bit, the rest 0; lengths of T give the decode
    without lengths.  Then against the plain version with the same lengths,
    at the no-lengths test's tolerance (mean 1e-2, max 0.1) over the kept
    frames, the written cache rows and the carried frame: both leave exact
    zeros past each row's length."""
    t = 300
    w, mk, mv, bias = _full_width_inputs(cuda_device, b, t, n_layers)
    lengths = _ragged(b, t, cuda_device)
    full_carry = k1.init_carry(w, b, t)
    before = k1.launches
    full_carry, full = k1.ar_decode_chunk(w, mk, mv, bias, full_carry, 0, t)
    carry, got = k1.ar_decode_chunk(w, mk, mv, bias, k1.init_carry(w, b, t), 0, t, lengths)
    whole = k1.ar_decode(w, mk, mv, bias, t, torch.full_like(lengths, t))
    torch.cuda.synchronize()
    assert k1.launches == before + 3
    assert torch.isfinite(full).all() and full.abs().sum() > 0
    _kept_frames_are_the_full_decodes(got, full, carry, full_carry, lengths)
    assert torch.equal(whole, full)

    plain_carry, plain = k1.ar_decode_plain(w, mk, mv, bias, k1.init_carry(w, b, t), 0, t,
                                            lengths)
    kept = torch.arange(t, device=cuda_device)[None, :] < lengths[:, None]  # [B, T]
    for name, a, ref, mask in (
            ("mel", got, plain, kept[:, :, None]),
            ("prev_mel", carry.prev_mel, plain_carry.prev_mel, lengths[:, None] == t),
            ("k_cache", carry.k_cache.float(), plain_carry.k_cache.float(), kept[None, :, :, None]),
            ("v_cache", carry.v_cache.float(), plain_carry.v_cache.float(), kept[None, :, :, None])):
        mask = mask.expand_as(a)
        assert not ref[~mask].any() and not a[~mask].any(), name
        err = (a - ref).abs()[mask]
        if err.numel():  # B = 1 keeps no row to T, so its carried frame is 0
            assert err.mean() < 1e-2 and err.max() < 0.1, (name, err.mean().item(),
                                                           err.max().item())


@pytest.mark.parametrize("chunk", [30, 48], ids=["divides-T", "does-not-divide-T"])
@pytest.mark.parametrize("b", [4, 20])
def test_k1_chunk_chain_with_lengths_equals_one_shot(cuda_device, b, chunk):
    """Chunks from the carry with ragged lengths give the one launch's bits
    (mel and caches), whose kept frames are the decode's without lengths:
    a chunk wholly past a cluster's rows still launches and writes zeros."""
    t = 300
    w, mk, mv, bias = _full_width_inputs(cuda_device, b, t, 2)
    lengths = _ragged(b, t, cuda_device)
    full_carry, full = k1.ar_decode_chunk(w, mk, mv, bias, k1.init_carry(w, b, t), 0, t)
    one_carry, one = k1.ar_decode_chunk(w, mk, mv, bias, k1.init_carry(w, b, t), 0, t, lengths)
    carry = k1.init_carry(w, b, t)
    before = k1.launches
    mels = []
    for pos in range(0, t, chunk):
        carry, mel = k1.ar_decode_chunk(w, mk, mv, bias, carry, pos, min(chunk, t - pos), lengths)
        mels.append(mel)
    torch.cuda.synchronize()
    assert k1.launches == before + len(mels)
    assert torch.equal(torch.cat(mels, dim=1), one)
    for a, want in zip(carry, one_carry):
        assert torch.equal(a, want)
    _kept_frames_are_the_full_decodes(one, full, one_carry, full_carry, lengths)


CYCLE_LONGEST = {1024: 610, 2048: 1090}  # tts-batch's longest rows a call, by frame bucket


@pytest.fixture(scope="module")
def cycle_call():
    """A tts-batch call at frame bucket T, made once per T for the module:
    the default decoder (6 layers), 16 rows, one as long as the bucket's
    longest call row and the rest spread below it, each row's valid memory
    frames its length; and the plain decodes with and without the lengths."""
    made = {}

    def make(t):
        if t not in made:
            dev = torch.device("cuda")
            gen = torch.Generator().manual_seed(11)
            dec = p_ar.PNCAARDecoder(256, MELS, DecoderConfig(n_layers=6, n_heads=8, d_ff=2048,
                                                              dropout=0.0, max_len=t))
            init_defaults_(dec, gen)
            dec.init_weights_(gen)
            dec = dec.to(dev).eval()
            n = [CYCLE_LONGEST[t] if r == 5 else CYCLE_LONGEST[t] * (3 + (37 * r) % 11) // 14
                 for r in range(16)]
            lengths = torch.tensor(n, dtype=torch.int32, device=dev)
            mask = torch.arange(t)[None, :] >= lengths.cpu()[:, None]
            hvar = torch.from_numpy(_np(80, 16, t, 256)) * (~mask)[:, :, None]
            w = p_ar.pack_decoder(dec, torch.bfloat16)
            mk, mv = p_ar.precompute_memory_packed(dec, hvar.to(dev))
            mk, mv = mk.bfloat16().contiguous(), mv.bfloat16().contiguous()
            bias = torch.where(mask, k1.NEG_INF, 0.0).float().to(dev).contiguous()
            full, kept = (k1.ar_decode_plain(w, mk, mv, bias, k1.init_carry(w, 16, t), 0, t,
                                             ln)[1] for ln in (None, lengths))
            made[t] = (w, mk, mv, bias, lengths, full, kept)
        return made[t]

    return make


def _traced_clusters(fn):
    """fn()'s result and the k1.clusters it counted, with tracing on."""
    from sambert_hifigan_tpu_torch import tracing

    tracing.reset()
    tracing.enable(True)
    try:
        out = fn()
        torch.cuda.synchronize()
        return out, tracing.snapshot()["counters"].get("k1.clusters", 0)
    finally:
        tracing.enable(False)
        tracing.reset()


@pytest.mark.parametrize("t,rows", [(1024, r) for r in (1, 2, 4, 8, 16)]
                         + [(2048, r) for r in (1, 2, 4, 8)])
def test_k1_rows_per_cluster_match_plain(cuda_device, cycle_call, t, rows):
    """tts-batch's calls (16 rows, the default decoder) on a plan of `rows`
    rows a cluster, as far as the shared memory fits: against the plain
    version with and without lengths (tolerance mean 1e-2, max 0.1 over the
    kept frames), the kept frames and cache rows the bits of the same plan's
    decode without lengths, and one k1.clusters per cluster of a launch."""
    w, mk, mv, bias, lengths, plain_full, plain_kept = cycle_call(t)
    plan = k1.launch_plan(16, t, t, 6, 256, 8, 2048, MELS, w.pe.shape[0],
                          max_clusters=16 // rows)
    assert (plan.rows, plan.groups) == (rows, 16 // rows)
    (full_carry, full), counted = _traced_clusters(
        lambda: k1.ar_decode_chunk(w, mk, mv, bias, k1.init_carry(w, 16, t), 0, t, plan=plan))
    assert counted == plan.groups
    carry, got = k1.ar_decode_chunk(w, mk, mv, bias, k1.init_carry(w, 16, t), 0, t, lengths,
                                    plan=plan)
    torch.cuda.synchronize()
    _kept_frames_are_the_full_decodes(got, full, carry, full_carry, lengths)
    kept = (torch.arange(t, device=cuda_device)[None, :] < lengths[:, None])[:, :, None]
    for name, a, ref, mask in (("no lengths", full, plain_full, torch.ones_like(kept)),
                               ("lengths", got, plain_kept, kept)):
        assert torch.isfinite(a).all(), name
        err = (a - ref).abs()[mask.expand_as(a)]
        assert err.mean() < 1e-2 and err.max() < 0.1, (name, err.mean().item(),
                                                         err.max().item())


def test_k1_spreads_rows_over_the_clusters_the_card_runs(cuda_device):
    """Without a plan K1 takes launch_plan's at the card's count of
    co-resident clusters: 16 rows spread over more than one cluster, no more
    than the card runs at once, and k1.clusters counts them a launch."""
    w, mk, mv, bias = _full_width_inputs(cuda_device, 16, 300, 2)
    card = k1.co_resident_clusters(cuda_device, 256, 8, 2048, MELS)
    assert card >= 1 and k1.co_resident_clusters(cuda_device, 256, 8, 2048, MELS) == card
    plan = k1.launch_plan(16, 300, 300, 2, 256, 8, 2048, MELS, w.pe.shape[0], max_clusters=card)
    assert plan == k1.card_plan(cuda_device, 16, 300, 300, 2, 256, 8, 2048, MELS, w.pe.shape[0])
    assert plan.groups <= card and (plan.groups > 1 or card == 1)
    out, counted = _traced_clusters(lambda: k1.ar_decode(w, mk, mv, bias, 300))
    assert counted == plan.groups
    assert torch.equal(out, k1.ar_decode(w, mk, mv, bias, 300, plan=plan))


def test_k1_refuses_lengths_it_does_not_take(cuda_device):
    w, mk, mv, bias = _full_width_inputs(cuda_device, 2, 40, 2)
    before = k1.launches
    for lengths in (torch.tensor([3, 4], dtype=torch.int64, device=cuda_device),
                    torch.tensor([3, 4], dtype=torch.int32),
                    torch.tensor([3, 4, 5], dtype=torch.int32, device=cuda_device)):
        with pytest.raises(ValueError, match="lengths"):
            k1.ar_decode(w, mk, mv, bias, 40, lengths)
    assert k1.launches == before


@pytest.mark.parametrize("t", [40, 1000, 4099])
@pytest.mark.parametrize("c", [32, 64, 128, 256])
def test_k2_kernel_matches_plain_on_card(cuda_device, c, t):
    """Same bf16 rounding points, f32 sums in another order; edge samples,
    where every conv zero-pads its own input, are checked on their own.
    T = 4099 is no multiple of any tile; T = 40 is shorter than the k = 11
    chain's 60-sample halo."""
    w = k2.pack_mrf(_mrf(c, cuda_device), torch.bfloat16)
    x = torch.from_numpy(_np(60, 2, c, t)).to(cuda_device)
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
    with pytest.raises(ValueError):  # 96 channels: neither 32, 64 nor a multiple of 128
        k2.mrf(torch.zeros(1, 96, 128, device=cuda_device), w)
    port = MRF(64, kernel_sizes=(3, 35), dilation_sizes=((1, 3, 5),) * 2)
    init_defaults_(port, torch.Generator().manual_seed(2))
    w = k2.pack_mrf(port.to(cuda_device), torch.bfloat16)
    with pytest.raises(ValueError):  # the k = 35 chain's 204-sample halo fills the window
        k2.mrf(torch.zeros(1, 64, 128, device=cuda_device), w)
    dec = _decoder(cuda_device)
    w = p_ar.pack_decoder(dec, torch.bfloat16)
    mk = torch.zeros(DEC["n_layers"], 1, 8, D, dtype=torch.bfloat16, device=cuda_device)
    bias = torch.zeros(1, 8, device=cuda_device)
    with pytest.raises(ValueError):  # longer than the positional table
        k1.ar_decode(w, mk, mk, bias, DEC["max_len"] + 1)
    with pytest.raises(ValueError):  # f32 memory K/V
        k1.ar_decode(w, mk.float(), mk.float(), bias, 8)
    odd = p_ar.PNCAARDecoder(D, MELS, DecoderConfig(**{**DEC, "d_ff": 72}))
    init_defaults_(odd, torch.Generator().manual_seed(3))
    w = p_ar.pack_decoder(odd.to(cuda_device), torch.bfloat16)
    with pytest.raises(ValueError):  # d_ff = 72: no launch plan splits it into 16-row K steps
        k1.ar_decode(w, mk, mk, bias, 8)


# ---- vocoder training on the card ------------------------------------------------


def _vocoder_train_cfg(mixed_precision, width=64, channel_div=8):
    import dataclasses

    from sambert_hifigan_tpu_torch.config import default_config

    cfg = default_config()
    voc = cfg.vocoder
    voc = dataclasses.replace(
        voc, generator=dataclasses.replace(voc.generator, upsample_initial_channel=width),
        discriminator=dataclasses.replace(voc.discriminator, channel_div=channel_div))
    tr = dataclasses.replace(cfg.training.vocoder, mixed_precision=mixed_precision)
    return dataclasses.replace(cfg, vocoder=voc,
                               training=dataclasses.replace(cfg.training, vocoder=tr))


def _one_step(cfg, dev, seed=1):
    from sambert_hifigan_tpu_torch.train_vocoder import synthetic_pairs
    from sambert_hifigan_tpu_torch.training.vocoder_trainer import (
        init_vocoder_state,
        make_vocoder_step,
    )

    mel, wav = next(synthetic_pairs(2, 8, cfg.audio.hop_length, cfg.audio.n_mels, seed=seed))
    state = init_vocoder_state(cfg, torch.Generator().manual_seed(seed), dev)
    metrics = make_vocoder_step(cfg)(state, torch.from_numpy(mel).to(dev),
                                     torch.from_numpy(wav).to(dev))
    return state, {k: float(v) for k, v in metrics.items()}


def test_vocoder_step_on_card_matches_cpu(cuda_device):
    """One f32 adv_mel_fm step of a small vocoder (generator 64 channels,
    discriminators at channel_div 8, B = 2, 8 frames) on the card (TF32 off)
    and on the CPU from the same seeded weights: every metric within 1e-3
    (relative), every parameter within 2 lr, all but 1e-3 of them within
    1e-5 (Adam's first step is ~lr sign(g); a near-cancelling gradient may
    take either sign)."""
    cfg = _vocoder_train_cfg(mixed_precision=False)
    card, m_card = _one_step(cfg, cuda_device)
    cpu, m_cpu = _one_step(cfg, torch.device("cpu"))
    assert sorted(m_card) == sorted(m_cpu)
    for k, want in m_cpu.items():
        assert abs(m_card[k] - want) <= 1e-3 * max(abs(want), 1e-8), (k, m_card[k], want)
    lr = cfg.training.vocoder.learning_rate
    flipped = total = 0
    for (k, a), b in zip(card.model.state_dict().items(), cpu.model.state_dict().values()):
        diff = (a.cpu() - b).abs()
        assert diff.max() <= 2 * lr, k
        flipped += int((diff > 1e-5).sum())
        total += diff.numel()
    assert flipped <= 1e-3 * total, (flipped, total)


def test_trained_generator_through_k2_matches_its_plain_forward(cuda_device):
    """One bf16 step of the full-width vocoder (the generator's stages have
    K2's widths: 256, 128, 64, 32), then its weights packed for K2: four
    launches vocode 64 frames, within K2's tolerance (5e-3) of the same
    generator's differentiable f32 forward."""
    from sambert_hifigan_tpu_torch.config import default_config

    cfg = default_config()
    state, metrics = _one_step(cfg, cuda_device)
    assert all(np.isfinite(v) for v in metrics.values())
    gen = state.model.generator.eval()
    mel = torch.from_numpy(_np(9, 1, 80, 64)).to(cuda_device)
    before = k2.launches
    with torch.no_grad():
        wav = gen(mel, gen.pack(torch.bfloat16))
        plain = gen(mel)
    torch.cuda.synchronize()
    assert k2.launches - before == 4
    assert wav.shape == (1, 1, 64 * 256)
    assert (wav - plain).abs().max() < 5e-3


def test_vocoder_checkpoint_restores_on_the_card(cuda_device, tmp_path):
    """A train state on the card saved and restored into a fresh one: every
    tensor equal, the moments on the card and the optimizers' step counts
    on the host, as torch.optim keeps them; the restored state steps on."""
    from sambert_hifigan_tpu_torch.train_vocoder import synthetic_pairs
    from sambert_hifigan_tpu_torch.training.checkpoint import CheckpointManager
    from sambert_hifigan_tpu_torch.training.vocoder_trainer import (
        init_vocoder_state,
        make_vocoder_step,
    )

    cfg = _vocoder_train_cfg(mixed_precision=True)
    state, _ = _one_step(cfg, cuda_device)
    ckpt = CheckpointManager(tmp_path, cfg.audio)
    ckpt.save(1, state)
    fresh = init_vocoder_state(cfg, torch.Generator().manual_seed(5), cuda_device)
    assert ckpt.restore(fresh) == 1
    for a, b in zip(state.model.state_dict().values(), fresh.model.state_dict().values()):
        assert torch.equal(a, b)
    for opt in (fresh.g_opt, fresh.d_opt):
        for st in opt.adamw.state.values():
            assert st["step"].device.type == "cpu"
            assert st["exp_avg"].device.type == "cuda"
    mel, wav = next(synthetic_pairs(2, 8, cfg.audio.hop_length, cfg.audio.n_mels, seed=3))
    metrics = make_vocoder_step(cfg)(fresh, torch.from_numpy(mel).to(cuda_device),
                                     torch.from_numpy(wav).to(cuda_device))
    assert all(np.isfinite(float(v)) for v in metrics.values()) and fresh.step == 2


def _acoustic_train_cfg(dropout=0.0, **stage):
    """The default config with a small acoustic model (d 64, 2 + 2 layers,
    FFN 128) and the stage's overrides (f32 unless given)."""
    import dataclasses

    from sambert_hifigan_tpu_torch import config as c

    cfg = c.default_config()
    am = dataclasses.replace(
        cfg.acoustic_model, d_model=64,
        encoder=c.EncoderConfig(n_layers=2, n_heads=2, d_ff=128, dropout=dropout),
        variance_adaptor=c.VarianceAdaptorConfig(predictor_dropout=dropout),
        decoder=c.DecoderConfig(n_layers=2, n_heads=4, d_ff=128, dropout=dropout, max_len=128))
    tr = dataclasses.replace(cfg.training.acoustic, **{"mixed_precision": False, **stage})
    return dataclasses.replace(cfg, acoustic_model=am,
                               training=dataclasses.replace(cfg.training, acoustic=tr))


def _acoustic_steps(cfg, dev, n=1, seed=0):
    """A seeded acoustic train state on `dev` after n steps on synthetic
    batches (B 2, 16 phonemes, 64 frames) -> (state, the last metrics)."""
    from sambert_hifigan_tpu_torch.data.dataset import batch_to_device, synthetic_batch
    from sambert_hifigan_tpu_torch.training.acoustic_trainer import (
        init_acoustic_state,
        make_acoustic_step,
    )
    from sambert_hifigan_tpu_torch.weights import random_acoustic_model

    model = random_acoustic_model(cfg, torch.Generator().manual_seed(seed)).to(dev)
    state = init_acoustic_state(model, cfg)
    step = make_acoustic_step(cfg)
    rng = torch.Generator().manual_seed(seed + 1)
    metrics = {}
    for i in range(n):
        batch = batch_to_device(synthetic_batch(cfg, 2, tph=16, tfrm=64, seed=seed + i), dev)
        metrics = step(state, batch, rng)
    return state, {k: float(v) for k, v in metrics.items()}


def test_acoustic_step_on_card_matches_cpu(cuda_device):
    """One f32 acoustic step (dropout 0, TF32 off) on the card and on the
    CPU from the same seeded weights and batch: every metric within 1e-4
    (relative), every parameter within 2 lr, all but 1e-3 of them within
    1e-5 (Adam's first step is ~lr sign(g))."""
    cfg = _acoustic_train_cfg()
    card, m_card = _acoustic_steps(cfg, cuda_device)
    cpu, m_cpu = _acoustic_steps(cfg, torch.device("cpu"))
    assert sorted(m_card) == sorted(m_cpu)
    for k, want in m_cpu.items():
        assert abs(m_card[k] - want) <= 1e-4 * max(abs(want), 1e-8), (k, m_card[k], want)
    lr = cfg.training.acoustic.learning_rate
    flipped = total = 0
    for (k, a), b in zip(card.model.state_dict().items(), cpu.model.state_dict().values()):
        diff = (a.cpu() - b).abs()
        assert diff.max() <= 2 * lr, k
        flipped += int((diff > 1e-5).sum())
        total += diff.numel()
    assert flipped <= 1e-3 * total, (flipped, total)


def test_acoustic_checkpoint_restores_on_the_card(cuda_device, tmp_path):
    """bf16 steps with dropout, scheduled sampling and an EMA on the card; a
    background save, then a step that updates the state in place while the
    thread writes: the checkpoint holds the state of the call, restored
    into a fresh state on the card (moments on the card, step counts on
    the host), which steps on."""
    from sambert_hifigan_tpu_torch.training.checkpoint import CheckpointManager

    cfg = _acoustic_train_cfg(dropout=0.1, mixed_precision=True, scheduled_sampling=0.5,
                              ema_decay=0.9)
    state, metrics = _acoustic_steps(cfg, cuda_device, n=2)
    assert all(np.isfinite(v) for v in metrics.values())
    saved = {k: v.clone() for k, v in state.model.state_dict().items()}
    ckpt = CheckpointManager(tmp_path, cfg.audio)
    ckpt.save(2, state, background=True)
    from sambert_hifigan_tpu_torch.data.dataset import batch_to_device, synthetic_batch
    from sambert_hifigan_tpu_torch.training.acoustic_trainer import make_acoustic_step

    step = make_acoustic_step(cfg)
    step(state, batch_to_device(synthetic_batch(cfg, 2, 16, 64, seed=9), cuda_device),
         torch.Generator().manual_seed(9))
    ckpt.wait()
    fresh, _ = _acoustic_steps(cfg, cuda_device, n=0, seed=5)
    assert ckpt.restore(fresh) == 2 and fresh.step == 2
    for k, v in fresh.model.state_dict().items():
        assert torch.equal(v, saved[k]), k
    for st in fresh.opt.adamw.state.values():
        assert st["step"].device.type == "cpu" and st["exp_avg"].device.type == "cuda"
    metrics = step(fresh, batch_to_device(synthetic_batch(cfg, 2, 16, 64, seed=3), cuda_device),
                   torch.Generator().manual_seed(3))
    assert all(np.isfinite(float(v)) for v in metrics.values()) and fresh.step == 3


def test_trained_decoder_through_k1_matches_plain(cuda_device):
    """One bf16 step of the full-width acoustic model (K1's widths), then
    its decoder packed for K1: one launch decodes 48 frames of a padded
    memory, within phase 2's tolerance (mean 1e-2, max 0.1) of K1's plain
    version on the same packed weights."""
    from sambert_hifigan_tpu_torch.config import default_config

    state, metrics = _acoustic_steps(default_config(), cuda_device)
    assert all(np.isfinite(v) for v in metrics.values())
    dec = state.model.ar_decoder.eval()
    w = p_ar.pack_decoder(dec, torch.bfloat16)
    b, t = 2, 48
    hvar = torch.from_numpy(_np(10, b, t, 256)).to(cuda_device)
    pad = torch.zeros(b, t, dtype=torch.bool, device=cuda_device)
    pad[1, 30:] = True
    memory = p_ar.decode_memory(dec, hvar, pad, w)
    before = k1.launches
    out = k1.ar_decode(w, *memory, t)
    torch.cuda.synchronize()
    assert k1.launches - before == 1
    ref = k1.ar_decode_plain(w, *memory, k1.init_carry(w, b, t), 0, t)[1]
    err = (out - ref).abs()
    assert bool(torch.isfinite(out).all())
    assert err.mean() < 1e-2 and err.max() < 0.1, (err.mean(), err.max())


# ---- data-parallel serving: a pipeline over several replicas -----------------------

SERVE_TEXTS = ["你好", "今天天气", "abc", "山水"]


def _serving_pipe(devices):
    """The default generator (K2's widths) behind a small acoustic model (d
    32, 2 + 2 layers: K1's generic path), random weights from seed 0."""
    import dataclasses

    from sambert_hifigan_tpu_torch import config as c
    from sambert_hifigan_tpu_torch.pipeline import build_pipeline_from_random_init

    cfg = c.default_config()
    am = dataclasses.replace(
        cfg.acoustic_model, d_model=D, encoder=c.EncoderConfig(n_layers=2, n_heads=4, d_ff=64),
        decoder=c.DecoderConfig(n_layers=2, n_heads=4, d_ff=64, max_len=256))
    cfg = dataclasses.replace(cfg, acoustic_model=am, runtime=c.RuntimeConfig(
        phoneme_buckets=(8, 16), frame_buckets=(128, 256)))
    return build_pipeline_from_random_init(cfg, seed=0, devices=devices)


def _replica_rows_match_direct_calls(devices):
    """One split synthesize_batch of 4 texts (2 rows a replica): one K1
    launch and 4 K2 launches a replica, each replica's rows the bits of a
    single-device call on cuda:0 at the batch's frame bucket and B."""
    split = _serving_pipe(devices)
    single = _serving_pipe(["cuda:0"])
    before = k1.launches, k2.launches
    wavs = split.synthesize_batch(SERVE_TEXTS)
    for dev in split.devices:
        torch.cuda.synchronize(dev)
    assert k1.launches - before[0] == 2
    assert k2.launches - before[1] == 2 * len(split.mrf_weights)
    bucket = split._initial_bucket(split._features(SERVE_TEXTS)[0], 1.0)
    for r in range(2):
        rows = SERVE_TEXTS[2 * r:2 * r + 2]
        direct = single.synthesize_batch(rows, max_frames=bucket)
        for got, want in zip(wavs[2 * r:2 * r + 2], direct):
            assert got.size > 0 and np.isfinite(got).all()
            np.testing.assert_array_equal(got, want)
    assert [len(w) for w in wavs] == [len(w) for w in single.synthesize_batch(SERVE_TEXTS)]
    return split


def test_synthesize_batch_is_the_same_without_lengths(cuda_device, monkeypatch):
    """The one-shot path hands K1 each row's total and K1 stops each row
    there: the wavs are the bits of the whole-bucket decode's (K1 told no
    lengths), one K1 launch a call either way."""
    from sambert_hifigan_tpu_torch.models import acoustic_model

    pipe = _serving_pipe(["cuda:0"])
    totals = pipe.text_to_mel(SERVE_TEXTS).total_frames.tolist()
    assert len(set(totals)) > 1  # ragged rows
    before = k1.launches
    with_lengths = pipe.synthesize_batch(SERVE_TEXTS)
    decode = acoustic_model.ar_decode
    monkeypatch.setattr(acoustic_model, "ar_decode",
                        lambda *a, lengths=None, **k: decode(*a, **k))
    without = pipe.synthesize_batch(SERVE_TEXTS)
    torch.cuda.synchronize()
    assert k1.launches == before + 2
    for got, want in zip(with_lengths, without):
        assert got.size > 0 and np.isfinite(got).all()
        np.testing.assert_array_equal(got, want)


def test_two_replicas_on_one_card_match_direct_calls(cuda_device):
    split = _replica_rows_match_direct_calls(["cuda:0", "cuda:0"])
    assert split.devices == [torch.device("cuda", 0)] * 2


def _moved(weights, dev):
    """A packed-weights NamedTuple with every tensor (and tensor tuple) on dev."""
    def move(f):
        if isinstance(f, torch.Tensor):
            return f.to(dev)
        if isinstance(f, tuple) and f and isinstance(f[0], torch.Tensor):
            return tuple(t.to(dev) for t in f)
        return f

    return type(weights)(*[move(f) for f in weights])


def test_kernels_launch_on_a_second_card(cuda_device):
    """K1 and K2 launched on cuda:1 (while cuda:0 is the current card) give
    the bits of the same launch on cuda:0, and a pipeline over both cards
    gives each replica's rows the bits of direct calls."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    dev0, dev1 = torch.device("cuda", 0), torch.device("cuda", 1)
    assert torch.cuda.current_device() == 0
    w, mk, mv, bias = _full_width_inputs(dev0, 4, 300, 2)
    before = k1.launches
    one = k1.ar_decode(w, mk, mv, bias, 300)
    two = k1.ar_decode(_moved(w, dev1), mk.to(dev1), mv.to(dev1), bias.to(dev1), 300)
    assert two.device == dev1 and k1.launches == before + 2
    assert torch.equal(one, two.to(dev0))

    wm = k2.pack_mrf(_mrf(128, dev0), torch.bfloat16)
    x = torch.from_numpy(_np(61, 2, 128, 1000)).to(dev0)
    before = k2.launches
    one = k2.mrf(x, wm)
    two = k2.mrf(x.to(dev1), _moved(wm, dev1))
    assert two.device == dev1 and k2.launches == before + 2
    assert torch.equal(one, two.to(dev0))

    split = _replica_rows_match_direct_calls(["cuda:0", "cuda:1"])
    assert [r.decode_weights.stream.device for r in split.replicas] == [dev0, dev1]


# ---- VITS: the acoustic pass without K1, the generator on K2 ------------------------


def _vits_card_config():
    from sambert_hifigan_tpu_torch import config as c

    return c.VitsConfig(
        audio=c.AudioConfig(hop_length=16),
        model=c.VitsModelConfig(inter_channels=16, hidden_channels=32, filter_channels=64,
                                n_layers=2, dp_filter_channels=32, flow_couplings=2,
                                flow_layers=2),
        generator=c.GeneratorConfig(n_mels=16, upsample_rates=(4, 4),
                                    upsample_kernel_sizes=(8, 8), upsample_initial_channel=128,
                                    post_lrelu_slope=0.01, post_bias=False),
        runtime=c.RuntimeConfig(phoneme_buckets=(8, 16), frame_buckets=(64, 128, 256)))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-3), (torch.bfloat16, 3e-2)])
def test_vits_pipeline_on_card_matches_reference(cuda_device, dtype, tol):
    """VITS at a small size (hidden 32, 2 layers, 2 couplings; the generator
    at K2's widths 64 and 32) on the card against the plain f32 reference
    (tests/vits_reference.py) on the card, 6 frames a token: every length
    exactly, no K1 launch and one K2 launch a stage; the f32 pipeline
    within K2's tolerance (5e-3: its bf16 weights), the bf16 one within
    3e-2 (bf16 through the encoder, the flow and the generator)."""
    from sambert_hifigan_tpu_torch.pipeline import VitsPipeline
    from sambert_hifigan_tpu_torch.text.frontend import FrontEnd
    from sambert_hifigan_tpu_torch.weights import random_vits_state
    from tests import vits_reference as ref
    from tests.test_torch_vits import pin, ref_config

    cfg = _vits_card_config()
    state = pin(random_vits_state(cfg, torch.Generator().manual_seed(0)), 5.5, 1e-4)
    state = {k: v.to(cuda_device) for k, v in state.items()}
    pipe = VitsPipeline(cfg, state, device=cuda_device, dtype=dtype, noise_seed=3)
    before = k1.launches, k2.launches
    got = pipe.synthesize_batch(SERVE_TEXTS)
    torch.cuda.synchronize()
    assert k1.launches == before[0] and k2.launches - before[1] == 2
    fe = FrontEnd(cfg.model.n_vocab)
    rows = [fe.text_to_sequence(t)[0] for t in SERVE_TEXTS]
    want = ref.synthesize_batch(state, ref_config(cfg), rows, ref.identity, cuda_device, 3)
    assert [len(w) for w in got] == [len(w) for w in want] == [16 * 6 * (2 * len(r) + 1)
                                                              for r in rows]
    err = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
    print(f"VITS {dtype} on the card: max |port - reference| {err:.3e}")
    assert err < tol, err


def test_vits_captured_pass_equals_op_by_op(cuda_device):
    """On the card the acoustic pass replays CUDA graphs captured at a
    shape's first call: their outputs are the bits of the same pass run op
    by op, and later calls at the same shape with other texts (new tokens,
    lengths and noise in the graphs' inputs) or another duration scale
    reuse the graphs and match again."""
    from sambert_hifigan_tpu_torch.models import vits as pv
    from sambert_hifigan_tpu_torch.pipeline import VitsPipeline, _ieee_f32
    from sambert_hifigan_tpu_torch.weights import random_vits_state

    cfg = _vits_card_config()
    state = random_vits_state(cfg, torch.Generator().manual_seed(1))
    pipe = VitsPipeline(cfg, state, device=cuda_device, dtype=torch.bfloat16, noise_seed=5)
    for texts, scale in ((SERVE_TEXTS, 1.0), (["一二三四五六", "山", "abc", "水"], 1.0),
                         (SERVE_TEXTS, 1.5)):
        tph, parts = pipe._split_args(texts)
        got = pipe._acoustic(parts[0], 128, scale, 0.0, 1.0)
        with _ieee_f32():
            want = pv.vits_inference(pipe.vits, parts[0], 128, 33, 256, scale)
        assert len(pipe.captured) == 1
        for a, b in ((got.mel_pred, want.mel_pred), (got.total_frames, want.total_frames),
                     (got.frame_mask, want.frame_mask),
                     (got.predictions["log_duration"], want.predictions["log_duration"])):
            assert torch.equal(a, b)
        assert got.mel_pred.abs().max() > 0
