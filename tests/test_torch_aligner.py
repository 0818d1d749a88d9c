"""The port's CTC aligner (data/aligner.py) against the JAX package's,
float32 on the CPU.

* The host numpy parts equal JAX's: Viterbi durations on random
  log-probabilities, the non-blank renormalisation, the batch padding.
* From carried weights (a flax init, through
  `weights.aligner_state_dict_from_flax`): logits within 1e-5, the
  per-example CTC losses (torch's F.ctc_loss on the port's log-softmax
  against optax.ctc_loss on logits) within 1e-4 relative, and one AdamW
  step (optax.adamw(2e-3), weight decay 1e-4) within 1e-4 in the loss and
  1e-5 in every parameter.
* A batch with one row that cannot align (more labels, with the blanks its
  repeats need, than frames): optax gives that row a large finite loss
  (log(0) stands at -1e5) whose gradient leads the batch; the port's
  per-example losses and the batch loss match it within 1e-4 (relative),
  and one AdamW step's parameters within 1e-5 wherever the gradient is
  above 1e-5 of its global norm and within 2 lr everywhere (Adam's first
  step is ~lr sign(g): one of 5120 weights of convs.0, at a gradient
  near zero, moves either way on either side); the plain-torch copy of
  optax's recursion matches optax on every row of a batch that can
  align.
* `train_ctc_aligner` draws the JAX package's batches, and from the same
  weights its loss history follows JAX's within 1e-4 (relative).
* The duration contract: every `ctc_durations` sums to its frames and is
  >= 1; `TTSDataset.compute_alignments` rewrites the cached durations
  under it; a trained aligner recovers planted durations.
"""

# bind the stdlib `profile` before a test puts scripts/ (and its profile.py) on
# sys.path: torch.optim imports torch._dynamo, and so cProfile, at first use
import cProfile  # noqa: F401

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sambert_hifigan_tpu.data import aligner as ja

from sambert_hifigan_tpu_torch.config import TTSConfig
from sambert_hifigan_tpu_torch.data import aligner as pa
from sambert_hifigan_tpu_torch.data.dataset import TTSDataset
from sambert_hifigan_tpu_torch.make_toy_dataset import make_toy_dataset
from sambert_hifigan_tpu_torch.weights import aligner_state_dict_from_flax
from tests.test_torch_discriminators import one_torch_thread  # noqa: F401 (a fixture)

VOCAB, N_MELS, D, LAYERS = 40, 16, 32, 2
LR = 2e-3


def _samples(seed, n=6):
    """(mel [T, N_MELS], ph [N]) pairs whose labels fit their frames."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t = int(rng.integers(20, 50))
        ph = rng.integers(0, VOCAB, int(rng.integers(3, 8))).astype(np.int32)
        out.append((rng.standard_normal((t, N_MELS)).astype(np.float32), ph))
    return out


def _jax_net_and_params(seed=0):
    net = ja.CTCAlignerNet(VOCAB, N_MELS, D, LAYERS)
    return net, net.init(jax.random.PRNGKey(seed), jnp.zeros((1, 16, N_MELS)))


def _port_net(params):
    net = pa.CTCAlignerNet(VOCAB, N_MELS, D, LAYERS)
    net.load_state_dict(aligner_state_dict_from_flax(jax.device_get(params)))
    return net


def _batch(samples):
    return ja._pad_batch([m for m, _ in samples], [p for _, p in samples], 16, 4)


def _jax_loss(net, vocab):
    def loss_fn(p, mel, lab, mel_p, lab_p, per_example=False):
        per_ex = optax.ctc_loss(net.apply(p, mel), mel_p, lab, lab_p, blank_id=ja.blank_id(vocab))
        if per_example:
            return per_ex
        return jnp.mean(per_ex / jnp.maximum(jnp.sum(1.0 - mel_p, axis=-1), 1.0))
    return loss_fn


# ---- host numpy parts ---------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_viterbi_equals_jax(seed):
    rng = np.random.default_rng(seed)
    t, k = int(rng.integers(10, 80)), 20
    n = int(rng.integers(1, min(t, 12)))
    lp = np.log(rng.dirichlet(np.ones(k), size=t))
    labels = rng.integers(0, k, n)
    ours = pa.viterbi_durations(lp, labels)
    np.testing.assert_array_equal(ours, ja.viterbi_durations(lp, labels))
    assert ours.sum() == t and (ours >= 1).all() and ours.dtype == np.int32


def test_viterbi_hand_crafted_and_refusal():
    lp = np.log(np.array([[0.9, 0.05, 0.05]] * 2 + [[0.05, 0.9, 0.05]] * 3
                         + [[0.05, 0.05, 0.9]]))
    np.testing.assert_array_equal(pa.viterbi_durations(lp, np.array([0, 1, 2])), [2, 3, 1])
    with pytest.raises(ValueError):
        pa.viterbi_durations(np.zeros((2, 4)), np.array([1, 2, 3]))
    assert pa.blank_id(300) == ja.blank_id(300) == 300


def test_nonblank_posteriors_and_padding_equal_jax():
    logits = np.random.default_rng(3).standard_normal((9, 6)) * 4
    np.testing.assert_array_equal(pa.nonblank_log_posteriors(logits),
                                  ja.nonblank_log_posteriors(logits))
    samples = _samples(4)
    mels, labs = [m for m, _ in samples], [p for _, p in samples]
    for ours, theirs in zip(pa._pad_batch(mels, labs, 16, 4), ja._pad_batch(mels, labs, 16, 4)):
        assert ours.dtype == theirs.dtype
        np.testing.assert_array_equal(ours, theirs)


# ---- the net, the loss, one step ------------------------------------------------------


def test_logits_and_ctc_losses_match_optax():
    jnet, params = _jax_net_and_params()
    net = _port_net(params)
    mel, lab, mel_p, lab_p = _batch(_samples(5))
    logits = net(torch.from_numpy(mel)).detach().numpy()
    np.testing.assert_allclose(logits, np.asarray(jnet.apply(params, jnp.asarray(mel))),
                               atol=1e-5, rtol=0)
    theirs = np.asarray(_jax_loss(jnet, VOCAB)(params, mel, lab, mel_p, lab_p, True))
    ours = pa.ctc_losses(net, *(torch.from_numpy(a) for a in (mel, lab, mel_p, lab_p)),
                         VOCAB).detach().numpy()
    assert np.isfinite(ours).all() and (ours > 0).all()
    np.testing.assert_allclose(ours, theirs, rtol=1e-4, atol=0)


def test_one_adamw_step_matches_optax():
    jnet, params = _jax_net_and_params(1)
    net = _port_net(params)
    batch = _batch(_samples(6))
    loss_fn = _jax_loss(jnet, VOCAB)
    opt = optax.adamw(LR)
    j_loss, grads = jax.value_and_grad(loss_fn)(params, *batch)
    updates, _ = opt.update(grads, opt.init(params), params)
    j_after = aligner_state_dict_from_flax(jax.device_get(optax.apply_updates(params, updates)))
    p_loss = pa.aligner_step(net, pa.make_aligner_optimizer(net, LR),
                             [torch.from_numpy(a) for a in batch], VOCAB)
    np.testing.assert_allclose(float(p_loss), float(j_loss), rtol=1e-4)
    for k, v in net.state_dict().items():
        np.testing.assert_allclose(v.numpy(), j_after[k].numpy(), atol=1e-5, rtol=0, err_msg=k)


def _infeasible_batch(seed):
    """_samples(seed) and a last row of 6 frames for 8 labels with a repeat
    (9 frames needed)."""
    rng = np.random.default_rng(seed + 100)
    ph = np.array([3, 7, 7, 1, 9, 2, 5, 4], np.int32)
    samples = _samples(seed, n=5) + [(rng.standard_normal((6, N_MELS)).astype(np.float32), ph)]
    return _batch(samples)


def test_infeasible_rows_are_found_from_the_lengths():
    labels = np.array([[1, 1, 2, 0], [1, 2, 3, 0], [4, 4, 4, 4]])
    assert pa.infeasible_rows(labels, np.array([3, 3, 4]), np.array([3, 3, 7])).tolist() == [
        True, False, False]
    assert pa.infeasible_rows(labels, np.array([3, 3, 4]), np.array([4, 2, 6])).tolist() == [
        False, True, True]


def test_optax_recursion_matches_optax_on_feasible_rows():
    """optax_ctc_loss on every row of a batch that can align (where
    F.ctc_loss serves them) against optax.ctc_loss, within 1e-4."""
    jnet, params = _jax_net_and_params(2)
    net = _port_net(params)
    mel, lab, mel_p, lab_p = _batch(_samples(7))
    log_probs = torch.log_softmax(net(torch.from_numpy(mel)), dim=-1)
    ours = pa.optax_ctc_loss(log_probs, torch.from_numpy(lab), torch.from_numpy(mel_p),
                             torch.from_numpy(lab_p), pa.blank_id(VOCAB)).detach().numpy()
    theirs = np.asarray(_jax_loss(jnet, VOCAB)(params, mel, lab, mel_p, lab_p, True))
    np.testing.assert_allclose(ours, theirs, rtol=1e-4, atol=0)


def test_infeasible_row_matches_optax():
    """Per-example losses of a batch with one row that cannot align: the
    row costs a large finite loss, as in optax, where F.ctc_loss alone
    gives inf (and zero_infinity would drop it)."""
    jnet, params = _jax_net_and_params(3)
    net = _port_net(params)
    mel, lab, mel_p, lab_p = batch = _infeasible_batch(3)
    theirs = np.asarray(_jax_loss(jnet, VOCAB)(params, *batch, True))
    ours = pa.ctc_losses(net, *(torch.from_numpy(a) for a in batch), VOCAB).detach().numpy()
    assert theirs[-1] > 1e4 and np.isfinite(ours).all()
    np.testing.assert_allclose(ours, theirs, rtol=1e-4, atol=0)


def test_one_adamw_step_with_an_infeasible_row_matches_optax():
    jnet, params = _jax_net_and_params(4)
    net = _port_net(params)
    batch = _infeasible_batch(4)
    loss_fn = _jax_loss(jnet, VOCAB)
    opt = optax.adamw(LR)
    j_loss, grads = jax.value_and_grad(loss_fn)(params, *batch)
    updates, _ = opt.update(grads, opt.init(params), params)
    j_after = aligner_state_dict_from_flax(jax.device_get(optax.apply_updates(params, updates)))
    p_loss = pa.aligner_step(net, pa.make_aligner_optimizer(net, LR),
                             [torch.from_numpy(a) for a in batch], VOCAB)
    np.testing.assert_allclose(float(p_loss), float(j_loss), rtol=1e-4)
    j_grads = {k: v.numpy() for k, v in
               aligner_state_dict_from_flax(jax.device_get(grads)).items()}
    norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in j_grads.values()))
    for k, v in net.state_dict().items():
        diff = np.abs(v.numpy() - j_after[k].numpy())
        assert diff.max() <= 2 * LR, (k, diff.max())
        big = np.abs(j_grads[k]) > 1e-5 * norm
        assert diff[big].max(initial=0.0) <= 1e-5, (k, diff[big].max())


def test_training_draws_jax_batches_and_follows_its_losses(monkeypatch):
    """Three steps of each package's train_ctc_aligner from the same weights
    (the port's init replaced by the flax init JAX draws): the same batches
    in the same order, and loss histories within 1e-4 (relative)."""
    samples = _samples(7, n=5)
    _, params = _jax_net_and_params(0)  # what the JAX trainer inits at seed 0, frame_gran 16
    drawn = {"jax": [], "port": []}

    def recorder(side, pad):
        def record(mels, labels, fg, lg):
            drawn[side].append([len(lab) for lab in labels] + [m.shape[0] for m in mels])
            return pad(mels, labels, fg, lg)
        return record

    monkeypatch.setattr(ja, "_pad_batch", recorder("jax", ja._pad_batch))
    monkeypatch.setattr(pa, "_pad_batch", recorder("port", pa._pad_batch))
    flax_sd = aligner_state_dict_from_flax(jax.device_get(params))
    monkeypatch.setattr(pa, "init_defaults_", lambda net, gen: net.load_state_dict(flax_sd))
    kw = dict(vocab_size=VOCAB, n_mels=N_MELS, steps=3, batch_size=3, seed=0, d_model=D,
              n_layers=LAYERS, frame_gran=16, label_gran=4)
    _, _, j_losses = ja.train_ctc_aligner(samples, **kw)
    _, p_losses = pa.train_ctc_aligner(samples, device="cpu", **kw)
    assert drawn["port"] == drawn["jax"] and len(drawn["port"]) == 3
    np.testing.assert_allclose(p_losses, j_losses, rtol=1e-4)


# ---- the duration contract ------------------------------------------------------------


def test_trained_aligner_recovers_planted_durations():
    """tests/test_aligner.py's corpus (each phoneme a distinct mel
    prototype, durations 2-8 frames): the port's aligner converges and
    places boundaries within 2.5 frames on average."""
    rng = np.random.default_rng(1)
    vocab, n_mels = 32, 80
    protos = rng.standard_normal((vocab, n_mels)).astype(np.float32) * 2
    samples, truths = [], []
    for _ in range(10):
        n = int(rng.integers(4, 8))
        ph = rng.integers(4, vocab, n).astype(np.int32)
        dur = rng.integers(2, 9, n)
        mel = np.concatenate([np.tile(protos[p], (d, 1)) for p, d in zip(ph, dur)])
        mel += 0.3 * rng.standard_normal(mel.shape).astype(np.float32)
        samples.append((mel.astype(np.float32), ph))
        truths.append(dur)
    net, losses = pa.train_ctc_aligner(samples, vocab_size=vocab, n_mels=n_mels, steps=200,
                                       d_model=96, n_layers=2, frame_gran=16, label_gran=4,
                                       seed=0, device="cpu")
    assert losses[-1] < losses[0] * 0.1
    errs = []
    for (mel, ph), dur_true in zip(samples, truths):
        dur = pa.ctc_durations(net, mel, ph)
        assert dur.sum() == mel.shape[0] and (dur >= 1).all()
        errs.append(np.abs(dur - dur_true).mean())
    assert float(np.mean(errs)) < 2.5, errs


def test_compute_alignments_rewrites_cached_durations(tmp_path):
    """A 6-utterance toy corpus, an aligner of d_model 32 trained 8 steps:
    every cached and memoised `dur` sums to its frames and is >= 1, and a
    new dataset over the same cache reads the aligned durations."""
    meta = make_toy_dataset(tmp_path / "toy", n=6, seed=1, verbose=False)
    cfg = TTSConfig()
    ds = TTSDataset(str(meta), cfg, cache_dir=str(tmp_path / "cache"), device="cpu")
    before = [ds.load_features(u)["dur"].copy() for u in ds.utterances]
    losses = ds.compute_alignments(steps=8, batch_size=4, seed=0, d_model=32, n_layers=1)
    assert len(losses) == 8 and all(np.isfinite(losses))
    again = TTSDataset(str(meta), cfg, cache_dir=str(tmp_path / "cache"), device="cpu")
    changed = 0
    for u, old in zip(ds.utterances, before):
        f = ds.load_features(u)
        assert f["dur"].dtype == np.int32 and not f["dur"].flags.writeable
        assert f["dur"].sum() == f["mel"].shape[0] and (f["dur"] >= 1).all()
        assert len(f["dur"]) == len(f["ph_ids"])
        np.testing.assert_array_equal(again.load_features(u)["dur"], f["dur"])
        changed += not np.array_equal(f["dur"], old)
    assert changed > 0  # the uniform bootstrap was replaced


def test_preprocess_entry_point(tmp_path, monkeypatch, capsys):
    """`preprocess --aligner uniform` caches the even split; `--aligner ctc
    --aligner-steps 3` rewrites it under the contract; with no card and no
    --device cpu it raises."""
    from sambert_hifigan_tpu_torch import preprocess
    from sambert_hifigan_tpu_torch.data.features import uniform_durations

    meta = str(make_toy_dataset(tmp_path / "toy", n=4, seed=2, verbose=False))
    ds = preprocess.main(["--metadata", meta, "--device", "cpu", "--aligner", "uniform"])
    for u in ds.utterances:
        f = ds.load_features(u)
        np.testing.assert_array_equal(f["dur"], uniform_durations(len(f["ph_ids"]),
                                                                  f["mel"].shape[0]))
    assert "[4/4]" in capsys.readouterr().out
    ds = preprocess.main(["--metadata", meta, "--device", "cpu", "--aligner-steps", "3"])
    assert "CTC loss" in capsys.readouterr().out
    for u in ds.utterances:
        f = ds.load_features(u)
        assert f["dur"].sum() == f["mel"].shape[0] and (f["dur"] >= 1).all()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        preprocess.main(["--metadata", meta])
