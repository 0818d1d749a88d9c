"""Data-parallel serving over several devices, `TTSPipeline(devices=...)`,
against the JAX pipeline over a mesh and against the port's own single
device, on the CPU.

The JAX mesh runs on the conftest's 8 virtual CPU devices; torch has one CPU
device, so the port's list repeats it (`["cpu"] * d`).  The weights are
those of tests/test_torch_pipeline.py: the duration bias of 2.9 makes
"今天天气" need 106 frames, over the 96 of the first frame bucket, so a
batch that holds it takes the overflow re-run.
"""

# bind the stdlib `profile` before a test puts scripts/ (and its profile.py) on
# sys.path: torch imports cProfile lazily
import cProfile  # noqa: F401
import threading

import jax
import numpy as np
import pytest
import torch

from sambert_hifigan_tpu.parallel.mesh import create_mesh
from sambert_hifigan_tpu.pipeline import TTSPipeline as JaxPipeline

from sambert_hifigan_tpu_torch.pipeline import (
    TTSPipeline,
    build_pipeline_from_random_init,
    resolve_devices,
)
from sambert_hifigan_tpu_torch.serving import DynamicBatcher

from tests.test_torch_discriminators import one_torch_thread  # noqa: F401 (a fixture)
from tests.test_torch_pipeline import TEXTS, _small_cfg, pipelines  # noqa: F401 (a fixture)

from sambert_hifigan_tpu_torch import config as pcfg

HOP = 256
FIRST, SECOND = 96, 160  # the small config's frame buckets


def _split(pp, d):
    return TTSPipeline(pp.cfg, pp.acoustic.state_dict(), pp.generator.state_dict(),
                       devices=["cpu"] * d)


def _jax_mesh(jp, d):
    return JaxPipeline(jp.cfg, jp.acoustic_params, jp.generator_params,
                       mesh=create_mesh(devices=jax.devices()[:d]))


@pytest.fixture(scope="module")
def split2(pipelines):
    return _split(pipelines[1], 2)


@pytest.fixture(scope="module")
def jax2(pipelines):
    return _jax_mesh(pipelines[0], 2)


def _spy(monkeypatch, pipe, name):
    """Record, per replica, the calls of its `name` method (the frame
    bucket of each `_acoustic`, the row count of each `_vocode`)."""
    calls = [[] for _ in pipe.replicas]
    for r, rep in enumerate(pipe.replicas):
        fn = getattr(rep, name)

        def call(*args, _fn=fn, _r=r, **kwargs):
            calls[_r].append(args[1] if name == "_acoustic" else args[0].shape[0])
            return _fn(*args, **kwargs)

        monkeypatch.setattr(rep, name, call)
    return calls


def test_batch_matches_jax_mesh_at_data_2(jax2, split2):
    """3 texts, padded to the batch bucket 4, 2 rows a replica, through the
    overflow re-run."""
    jw = jax2.synthesize_batch(TEXTS)
    pw = split2.synthesize_batch(TEXTS)
    assert [len(w) for w in pw] == [len(w) for w in jw]
    assert max(len(w) for w in pw) > FIRST * HOP, "the batch must take the overflow re-run"
    for a, b in zip(pw, jw):
        # tanh waveform through the f32 decode and four generator stages
        np.testing.assert_allclose(a, b, atol=1e-3, rtol=0)


def test_single_text_matches_jax_mesh_at_data_8(pipelines):
    """The counterpart of TestMeshServing.test_sharded_single_text: one
    text padded to 8 rows, one a replica, through the overflow re-run."""
    jp, pp = pipelines
    port = _split(pp, 8)
    assert len(port.replicas) == 8
    jw = _jax_mesh(jp, 8).synthesize(TEXTS[1])
    pw = port.synthesize(TEXTS[1])
    assert len(pw) == len(jw) > FIRST * HOP
    np.testing.assert_allclose(pw, jw, atol=1e-3, rtol=0)


def test_text_to_mel_matches_jax_mesh(pipelines, jax2, split2):
    """The JAX mesh returns the batch padded to a multiple of the data
    axis; so does the port."""
    jo = jax2.text_to_mel(TEXTS)
    po = split2.text_to_mel(TEXTS)
    assert po.mel_pred.shape == tuple(jo.mel_pred.shape) == (4, SECOND, 80)
    np.testing.assert_array_equal(po.total_frames.numpy(), np.asarray(jo.total_frames))
    np.testing.assert_array_equal(po.frame_mask.numpy(), np.asarray(jo.frame_mask))
    np.testing.assert_allclose(po.mel_pred.numpy(), np.asarray(jo.mel_pred), atol=1e-4, rtol=0)
    assert po.mel_pred.device == split2.device
    one = pipelines[1].text_to_mel(TEXTS + TEXTS[-1:])
    assert set(po.predictions) == set(one.predictions)
    for k, v in one.predictions.items():
        assert po.predictions[k].shape == v.shape
    torch.testing.assert_close(po.predictions["dur"], one.predictions["dur"], rtol=0, atol=0)


def test_replica_rows_are_bit_equal_to_direct_calls(pipelines, split2):
    """Each replica's rows are the bits of a single-device call on those
    rows at the batch's frame bucket and B; the whole batch against one
    device at B = 4 within the JAX mesh test's 2e-4."""
    _, pp = pipelines
    texts = ["你好", "今天天气", "abc", "山水"]
    wavs = split2.synthesize_batch(texts)
    for r in range(2):
        rows = texts[2 * r:2 * r + 2]
        assert pp._features(rows)[0] == split2._features(texts)[0]  # one phoneme bucket
        for got, want in zip(wavs[2 * r:2 * r + 2], pp.synthesize_batch(rows, max_frames=SECOND)):
            np.testing.assert_array_equal(got, want)
    for got, want in zip(wavs, pp.synthesize_batch(texts)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)


def test_one_frame_bucket_for_the_batch(pipelines, split2, monkeypatch):
    """Only the last replica's rows overflow the first bucket; both
    replicas re-run at the same new bucket, as the JAX mesh's one program
    does, and the lengths are the single device's."""
    _, pp = pipelines
    texts = ["你好", "abc", "今天天气"]  # padded to 4: replica 1 is "今天天气" twice
    assert int(pp.text_to_mel(texts[:2]).total_frames.max()) <= FIRST
    buckets = _spy(monkeypatch, split2, "_acoustic")
    wavs = split2.synthesize_batch(texts)
    assert buckets == [[FIRST, SECOND], [FIRST, SECOND]]
    want = pp.synthesize_batch(texts)
    assert [len(w) for w in wavs] == [len(w) for w in want]
    assert len(wavs[2]) > FIRST * HOP
    for got, ref in zip(wavs[:2], pp.synthesize_batch(texts[:2], max_frames=SECOND)):
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("rows", [4, 3])
def test_vocode_splits_when_the_rows_divide(pipelines, split2, monkeypatch, rows):
    """4 rows: 2 a replica, each bit-equal to a direct vocode of its rows.
    3 rows: all of them on devices[0], bit-equal to the single device."""
    _, pp = pipelines
    mel = pp.text_to_mel(TEXTS + ["山水"], max_frames=FIRST).mel_pred[:rows]
    counts = _spy(monkeypatch, split2, "_vocode")
    wav = split2.vocode(mel)
    assert wav.shape == (rows, 1, FIRST * HOP) and wav.device == split2.device
    if rows == 4:
        assert counts == [[2], [2]]
        for r in range(2):
            torch.testing.assert_close(wav[2 * r:2 * r + 2], pp.vocode(mel[2 * r:2 * r + 2]),
                                       rtol=0, atol=0)
    else:
        assert counts == [[3], []]
        torch.testing.assert_close(wav, pp.vocode(mel), rtol=0, atol=0)


def test_stream_runs_unsplit_on_the_first_device(pipelines, split2, monkeypatch):
    _, pp = pipelines
    vocode = _spy(monkeypatch, split2, "_vocode")
    got = list(split2.stream(TEXTS[1], chunk_frames=32, context_frames=16))
    want = list(pp.stream(TEXTS[1], chunk_frames=32, context_frames=16))
    assert len(got) == len(want) > 1
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert vocode[0] and not vocode[1]


def test_warmup_runs_every_replica(split2, monkeypatch):
    acoustic = _spy(monkeypatch, split2, "_acoustic")
    vocode = _spy(monkeypatch, split2, "_vocode")
    split2.warmup(max_frames=FIRST, batch_buckets=True)
    # text_to_mel and vocode of each phoneme bucket, then each batch bucket
    legs = len(split2.cfg.runtime.phoneme_buckets) + len(split2.cfg.runtime.batch_buckets)
    assert [len(c) for c in acoustic] == [legs, legs]
    assert [len(c) for c in vocode] == [legs, legs]
    assert set(acoustic[0] + acoustic[1]) == {FIRST}


def test_batcher_answers_concurrent_requests(pipelines, split2):
    """A DynamicBatcher over the split pipeline: 3 concurrent requests get
    the single device's lengths and, within 2e-4, its samples."""
    _, pp = pipelines
    batcher = DynamicBatcher(split2, max_batch=4, max_wait_ms=100)
    results = [None] * len(TEXTS)
    go = threading.Barrier(len(TEXTS))

    def client(i):
        go.wait()
        results[i] = batcher.synthesize(TEXTS[i], timeout=120)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(TEXTS))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
        assert not any(t.is_alive() for t in threads)
    finally:
        batcher.close()
    assert batcher.stats()["requests_served"] == len(TEXTS)
    for text, wav in zip(TEXTS, results):
        want = pp.synthesize(text)
        assert wav is not None and wav.shape == want.shape
        np.testing.assert_allclose(wav, want, atol=2e-4, rtol=0)


def test_one_entry_list_is_the_single_device_pipeline(pipelines):
    _, pp = pipelines
    one = _split(pp, 1)
    assert one.replicas == [one] and one.device == torch.device("cpu")
    for a, b in zip(one.synthesize_batch(TEXTS), pp.synthesize_batch(TEXTS)):
        np.testing.assert_array_equal(a, b)


def test_build_functions_pass_devices_through():
    cfg = _small_cfg(pcfg)
    pipe = build_pipeline_from_random_init(cfg, seed=0, devices=["cpu"] * 3)
    assert [r.device for r in pipe.replicas] == [torch.device("cpu")] * 3
    assert len({id(r.acoustic) for r in pipe.replicas}) == 3
    single = build_pipeline_from_random_init(cfg, seed=0, device="cpu")
    for a, b in zip(pipe.replicas[2].acoustic.state_dict().values(),
                    single.acoustic.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("device, devices, message", [
    (None, [], "empty"),
    (None, ["cpu", "cuda:0"], "one type"),
    ("cuda:0", ["cpu", "cpu"], "disagrees"),
    ("cpu", ["cuda:0"], "disagrees"),
])
def test_bad_device_lists_raise(pipelines, device, devices, message):
    _, pp = pipelines
    with pytest.raises(ValueError, match=message):
        TTSPipeline(pp.cfg, pp.acoustic.state_dict(), pp.generator.state_dict(),
                    device=device, devices=devices)


def test_bare_cuda_resolves_to_the_current_card(monkeypatch):
    """A tensor's device always carries an index, so "cuda" in the list
    becomes cuda:<current>; no card is touched."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    cuda = lambda i: torch.device("cuda", i)  # noqa: E731
    assert resolve_devices(None, ["cuda", "cuda:0", "cuda"]) == [cuda(1), cuda(0), cuda(1)]
    assert resolve_devices("cuda", ["cuda:1"]) == [cuda(1)]
    assert resolve_devices("cpu", ["cpu", "cpu"]) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="disagrees"):
        resolve_devices("cuda", ["cuda:0"])
