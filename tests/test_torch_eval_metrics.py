"""The port's evaluation metrics (utils/eval_metrics.py) against the JAX
package's on the same waveforms, float32 on the CPU: a toy-corpus
utterance against itself plus noise, against a time-warped copy, and
against another utterance; tones for F0.  Bounds: mel-MAE, DTW mel-MAE,
MCD and STFT log-magnitude MAE within 1e-4 (relative) of JAX's (the
log-mels agree to 1e-5 where the signal is loud, 1e-2 at the f32 FFT
noise floor, tests/test_torch_data.py); F0 RMSE within 1e-3 (relative)
and voicing F1 within 1e-3; identical inputs score exactly 0.  Also the
`evaluate` entry point on the CPU, and that it needs a card without
--device cpu.
"""

import numpy as np
import pytest
import torch

from sambert_hifigan_tpu.utils import eval_metrics as je

from sambert_hifigan_tpu_torch import evaluate
from sambert_hifigan_tpu_torch.config import AudioConfig
from sambert_hifigan_tpu_torch.data.audio import load_wav, save_mel, save_wav
from sambert_hifigan_tpu_torch.make_toy_dataset import make_toy_dataset
from sambert_hifigan_tpu_torch.utils import eval_metrics as pe
from tests.test_torch_discriminators import one_torch_thread  # noqa: F401 (a fixture)

SR = 22050
REL, F0_REL, F1_ABS = 1e-4, 1e-3, 1e-3


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    root = tmp_path_factory.mktemp("toy")
    meta = make_toy_dataset(root, n=2, seed=3, verbose=False)
    a, b = (load_wav(root / line.split("|")[0])[0][0]
            for line in meta.read_text(encoding="utf-8").splitlines())
    rng = np.random.default_rng(0)
    noisy = (a + 0.02 * rng.standard_normal(a.shape)).astype(np.float32)
    # a time warp: the second half slowed by 10% (linear interpolation)
    half = a.shape[0] // 2
    pos = np.linspace(half, a.shape[0] - 1, int((a.shape[0] - half) * 1.1))
    warped = np.concatenate([a[:half], np.interp(pos, np.arange(a.shape[0]), a)])
    return {"noisy": (a, noisy), "warped": (a, warped.astype(np.float32)), "other": (a, b),
            "root": root}


PAIRS = ["noisy", "warped", "other"]


def _rel(ours, theirs):
    return abs(ours - theirs) / max(abs(theirs), 1e-12)


@pytest.mark.parametrize("pair", PAIRS)
@pytest.mark.parametrize("name", ["mel_mae", "mel_mae_dtw", "mcd", "stft_logmag_mae"])
def test_scalar_metrics_match_jax(wavs, pair, name):
    a, b = wavs[pair]
    ours = getattr(pe, name)(a, b, device="cpu")
    theirs = getattr(je, name)(a, b)
    assert ours > 0 and _rel(ours, theirs) <= REL, (ours, theirs)
    assert getattr(pe, name)(a, a, device="cpu") == 0.0


def test_mel_mae_from_mels_equals_jax():
    rng = np.random.default_rng(2)
    x, y = rng.standard_normal((80, 50)), rng.standard_normal((80, 47))
    assert pe.mel_mae_from_mels(x, y) == je.mel_mae_from_mels(x, y)


def test_dtw_path_equals_jax(wavs):
    a, b = wavs["warped"]
    ma = pe._log_mel(a, AudioConfig(), "cpu").T
    mb = pe._log_mel(b, AudioConfig(), "cpu").T
    cost, pa, pb = pe._dtw(ma, mb)
    cost_j, pa_j, pb_j = je._dtw(ma, mb)
    assert cost == cost_j
    np.testing.assert_array_equal(pa, pa_j)
    np.testing.assert_array_equal(pb, pb_j)


def _tone(freq, n=11025, amp=0.5):
    return (amp * np.sin(2 * np.pi * freq * np.arange(n) / SR)).astype(np.float32)


@pytest.mark.parametrize("dtw", [False, True])
@pytest.mark.parametrize("pair", ["detuned", "noise", "corpus"])
def test_f0_metrics_match_jax(wavs, pair, dtw):
    a, b = {
        "detuned": (_tone(220.0), _tone(231.0)),
        "noise": (_tone(220.0), np.random.default_rng(1).standard_normal(11025).astype(
            np.float32) * 0.1),
        "corpus": wavs["warped"],
    }[pair]
    fn = "f0_metrics_dtw" if dtw else "f0_metrics"
    ours = getattr(pe, fn)(a, b, device="cpu")
    theirs = getattr(je, fn)(a, b)
    assert abs(ours["voicing_f1"] - theirs["voicing_f1"]) <= F1_ABS
    if np.isnan(theirs["f0_rmse_hz"]):
        assert np.isnan(ours["f0_rmse_hz"])
    else:
        assert _rel(ours["f0_rmse_hz"], theirs["f0_rmse_hz"]) <= F0_REL


def test_evaluate_entry_point(wavs, monkeypatch, capsys):
    root = wavs["root"]
    a, noisy = wavs["noisy"]
    save_wav(root / "noisy.wav", noisy, SR)
    ref = str(root / "wavs/utt_0000.wav")
    out = evaluate.main([ref, str(root / "noisy.wav"), "--device", "cpu"])
    reread = load_wav(root / "noisy.wav")[0][0]  # 16-bit, as the entry point reads it
    assert out["mel_mae"] == pe.mel_mae(a, reread, device="cpu")
    assert out["mcd"] == pe.mcd(a, reread, device="cpu")
    assert "MCD:" in capsys.readouterr().out
    save_mel(np.ones((80, 5)), root / "m1.npy")
    save_mel(np.zeros((80, 4)), root / "m2.npy")
    assert evaluate.main([str(root / "m1.npy"), str(root / "m2.npy")]) == {"mel_mae": 1.0}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate.main([ref, ref])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pe.mel_mae(a, a)
