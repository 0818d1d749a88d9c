"""K1's launch plan (`ops.ar_decode.launch_plan`), computed on the host and
checked by csrc/ar_decode.cu against its own layout: every column, key and
row has exactly one owner, and every plan fits the card."""

import pytest

from sambert_hifigan_tpu_torch import kernels
from sambert_hifigan_tpu_torch.ops import ar_decode as k1

N_MELS, PE_LEN = 80, 5000
WIDTHS = {32: (4, 64), 256: (8, 2048)}  # d: (heads, d_ff)


def _covers_once(ranges, n):
    keys = [i for start, stop in ranges for i in range(start, stop)]
    return sorted(keys) == list(range(n)) and len(keys) == n


def _owns_everything_once(plan, b, t, d):
    h, d_ff = WIDTHS[d]
    assert plan.cluster in k1.CLUSTER_SIZES and plan.cluster <= 16
    assert 0 < plan.smem <= kernels.MAX_SMEM
    assert 1 <= plan.rows <= k1.MAX_ROWS and plan.grid == plan.groups * plan.cluster
    assert _covers_once(plan.row_groups(b), b)
    assert all(stop > start for start, stop in plan.row_groups(b))
    ranks = range(plan.cluster)
    for n in (d, 3 * d, d_ff, N_MELS):  # the column-split matrices
        cols = [plan.columns(n, r) for r in ranks]
        assert _covers_once(cols, n)
        assert all(start % 8 == 0 and stop % 8 == 0 for start, stop in cols)
    assert _covers_once([plan.k_rows(d_ff, r) for r in ranks], d_ff)
    assert all((stop - start) % 16 == 0 for start, stop in (plan.k_rows(d_ff, r) for r in ranks))
    for n in (t, t // 3 + 1):  # the cache's keys at the last step, a short memory
        assert _covers_once([rng for r in ranks for rng in plan.key_tiles(n, r)], n)


@pytest.mark.parametrize("d", sorted(WIDTHS))
@pytest.mark.parametrize("t", [24, 1024, 2048])
@pytest.mark.parametrize("b", [1, 3, 4, 16, 20])
def test_k1_launch_plan_owns_everything_once(b, t, d):
    h, d_ff = WIDTHS[d]
    _owns_everything_once(k1.launch_plan(b, t, t, 6, d, h, d_ff, N_MELS, PE_LEN), b, t, d)


def _fewest(b, t, d):
    """The plan that packs the rows into as few clusters as fit (at most
    MAX_ROWS each), then takes the deepest ring that fits."""
    h, d_ff = WIDTHS[d]
    c = k1.cluster_size(d, d_ff, N_MELS)
    for groups in range(-(-b // k1.MAX_ROWS), b + 1):
        rows = -(-b // groups)
        for stages in k1.RING_STAGES:
            smem = k1._smem(t, t, 6, d, h, d_ff, N_MELS, c, rows, stages)
            if smem <= kernels.MAX_SMEM:
                return k1.Plan(c, rows, -(-b // rows), k1.KEY_TILE, stages, k1.STAGE_BYTES, smem)
    raise AssertionError("no plan fits")


@pytest.mark.parametrize("d", sorted(WIDTHS))
@pytest.mark.parametrize("max_clusters", [1, 4, 7, 8])
@pytest.mark.parametrize("t", [24, 1024, 2048])
@pytest.mark.parametrize("b", [1, 3, 4, 16, 20])
def test_k1_launch_plan_spreads_rows(b, t, max_clusters, d):
    """The rows spread over the clusters the card runs at once, ceil(B /
    count) each unless the fewest clusters that fit already carry fewer, so
    never over more clusters than max(the card's count, the fewest); on a
    card that runs one cluster the plan is the fewest clusters with the
    deepest ring."""
    h, d_ff = WIDTHS[d]
    plan = k1.launch_plan(b, t, t, 6, d, h, d_ff, N_MELS, PE_LEN, max_clusters=max_clusters)
    _owns_everything_once(plan, b, t, d)
    fewest = _fewest(b, t, d)
    assert plan.groups <= max(max_clusters, fewest.groups)
    assert plan.rows == min(-(-b // max_clusters), fewest.rows)
    if max_clusters == 1 or fewest.groups >= max_clusters:
        assert plan == fewest
    assert plan == k1._deepest_ring(b, t, t, 6, d, h, d_ff, N_MELS, plan.cluster, plan.rows)


@pytest.mark.parametrize("max_clusters", [7, 8, 16, 132])
@pytest.mark.parametrize("t", [1024, 2048])
def test_k1_launch_plan_gives_tts_batch_calls_a_deep_ring(t, max_clusters):
    """16 rows in a 1024- or 2048-frame bucket on a card that runs 7 or more
    16-CTA clusters at once: a few rows a cluster and a 4-stage ring, where
    the fewest clusters take 16 rows and 2 stages (T 1024) or 8 rows and 3
    (T 2048)."""
    plan = k1.launch_plan(16, t, t, 6, 256, 8, 2048, N_MELS, PE_LEN, max_clusters=max_clusters)
    assert plan.stages == 4 and plan.rows <= 3 and plan.groups <= max_clusters
    assert (plan.rows, plan.stages) != (_fewest(16, t, 256).rows, _fewest(16, t, 256).stages)


def test_k1_launch_plan_main_path():
    """The main path's shape, 4 rows: one row a 16-CTA cluster on a card
    that runs 7 clusters at once, one cluster of all 4 on a card that runs
    one."""
    plan = k1.launch_plan(4, 1024, 1024, 6, 256, 8, 2048, N_MELS, PE_LEN, max_clusters=7)
    assert (plan.cluster, plan.rows, plan.groups) == (16, 1, 4)
    one = k1.launch_plan(4, 1024, 1024, 6, 256, 8, 2048, N_MELS, PE_LEN, max_clusters=1)
    assert (one.cluster, one.rows, one.groups) == (16, 4, 1)
    assert plan.columns(256, 3) == (48, 64) and plan.k_rows(2048, 3) == (384, 512)
    assert plan.key_tiles(40, 1) == [(8, 16)]


def test_k1_launch_plan_refuses():
    with pytest.raises(ValueError):  # d not a power of two dividing the CTA's 512 threads
        k1.launch_plan(1, 24, 24, 6, 40, 4, 64, N_MELS, PE_LEN)
    with pytest.raises(ValueError):  # d_ff not a multiple of the 16-row K tile
        k1.launch_plan(1, 24, 24, 6, 256, 8, 2056, N_MELS, PE_LEN)
    with pytest.raises(ValueError):  # n_mels not a multiple of 16
        k1.launch_plan(1, 24, 24, 6, 256, 8, 2048, 84, PE_LEN)
    with pytest.raises(ValueError):  # head width 4
        k1.launch_plan(1, 24, 24, 6, 256, 64, 2048, N_MELS, PE_LEN)
    with pytest.raises(ValueError):  # T beyond the positional table
        k1.launch_plan(1, PE_LEN + 1, 24, 6, 256, 8, 2048, N_MELS, PE_LEN)
    with pytest.raises(ValueError):  # d beyond the 512 a LayerNorm warp holds
        k1.launch_plan(1, 24, 24, 6, 1024, 8, 4096, N_MELS, PE_LEN)
    with pytest.raises(ValueError):  # no cluster runs at once
        k1.launch_plan(1, 24, 24, 6, 256, 8, 2048, N_MELS, PE_LEN, max_clusters=0)


@pytest.mark.parametrize("d_ff,cluster", [(16, 1), (64, 4)])
def test_k1_pack_stream_layout(d_ff, cluster):
    """Each CTA's row of the weight stream holds its slices in step order,
    each as the 16 x 8 tiles of the B operand, K step by K step, so a chunk
    of K rows is one contiguous copy."""
    import torch

    from sambert_hifigan_tpu_torch.config import DecoderConfig
    from sambert_hifigan_tpu_torch.models import ar_decoder as p_ar
    from sambert_hifigan_tpu_torch.models.layers import init_defaults_

    dec = p_ar.PNCAARDecoder(32, 16, DecoderConfig(n_layers=2, n_heads=4, d_ff=d_ff,
                                                   dropout=0.0, max_len=8))
    init_defaults_(dec, torch.Generator().manual_seed(1))
    w = p_ar.pack_decoder(dec, torch.float32)
    assert w.stream is None  # the stream is the kernel's, packed in bf16 only
    stream = k1.pack_stream(w, cluster)
    plan = k1.launch_plan(1, 8, 8, 2, 32, 4, d_ff, 16, 8)
    assert plan.cluster == cluster == k1.cluster_size(32, d_ff, 16)
    for rank in range(cluster):
        expect = []
        for m, n in [(w.prenet_w1, 32), (w.prenet_w2, 32)]:
            a, b = plan.columns(n, rank)
            expect.append(m[:, a:b])
        for l in range(2):
            for m, n in [(w.wqkv[l], 96), (w.wo[l], 32), (w.wcq[l], 32), (w.wco[l], 32),
                         (w.w1[l], d_ff)]:
                a, b = plan.columns(n, rank)
                expect.append(m[:, a:b])
            a, b = plan.k_rows(d_ff, rank)
            expect.append(w.w2[l][a:b])
        a, b = plan.columns(16, rank)
        expect.append(w.mel_w[:, a:b])
        # each [K, n] slice as its 16 x 8 tiles, K step by K step
        flat = torch.cat([e.reshape(e.shape[0] // 16, 16, e.shape[1] // 8, 8).transpose(1, 2)
                          .reshape(-1) for e in expect])
        assert torch.equal(stream[rank, :len(flat)], flat)
        assert not stream[rank, len(flat):].any()
    assert p_ar.pack_decoder(dec, torch.bfloat16).stream.shape[0] == cluster
