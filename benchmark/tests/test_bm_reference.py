"""The yardstick: the plain reference stands apart from the program, the
copied work counts equal the program's own today, the fp8 control is
judged not correct, and the sambert_hifigan model's weights and reference
give the bits they gave before the model became a file."""

from __future__ import annotations

import ast
import hashlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bm_tiny
from bm_tiny import BENCH_DIR, ROOT, tiny
from harness import port, traffic
from harness.spec import load_cell
from work import flops as bm

REF_DIR = os.path.join(BENCH_DIR, "reference")


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("fname", sorted(f for f in os.listdir(REF_DIR) if f.endswith(".py")))
def test_reference_imports_nothing_of_the_program(fname):
    names = {n.split(".")[0] for n in _imports(os.path.join(REF_DIR, fname))}
    assert not names & {"sambert_hifigan_tpu_torch", "sambert_hifigan_tpu", "jax", "harness"}


def test_reference_loads_no_program_module():
    code = ("import sys; sys.path.insert(0, %r); import reference.acoustic, reference.vocoder; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'sambert_hifigan_tpu_torch', 'sambert_hifigan_tpu', 'jax'}))" % BENCH_DIR)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("cfg_name", ["hifigan-v1-gan", "sambert-hifigan-v1"])
def test_copied_flops_equal_the_programs(cfg_name):
    from sambert_hifigan_tpu_torch import flops as prog

    cell = bm_tiny.cell("vocoder-train" if cfg_name == "hifigan-v1-gan" else "tts-batch")
    c = cell.config
    cfg = port.tts_config(c)
    for b, frames in ((1, 32), (16, 1024)):
        assert bm.generator_flops(c, b, frames) == prog._generator_flops(
            cfg.vocoder.generator, c["n_mels"], b, frames)
    if cfg_name == "hifigan-v1-gan":
        for b, t in ((16, 8192), (2, 1280)):
            assert bm.discriminator_flops(c, b, t) == prog._discriminator_flops(
                cfg.vocoder.discriminator, b, t)
        assert bm.vocoder_step_flops(c, 16, 32) == prog.vocoder_step_flops(cfg, 16, 32)
    assert (bm.HBM_BYTES_PER_S, bm.BF16_FLOP_PER_S) == (prog.HBM_BYTES_PER_S,
                                                         prog.BF16_FLOP_PER_S)


@pytest.mark.parametrize("b,t", [(1, 64), (4, 96)])
def test_k1_count_equals_chip_smoke_when_every_frame_is_valid(b, t):
    sys.path.insert(0, ROOT)
    import chip_smoke
    from sambert_hifigan_tpu_torch.models.ar_decoder import pack_decoder
    from sambert_hifigan_tpu_torch.models.acoustic_model import SAMBERTAcousticModel

    c = load_cell("tts-batch").config
    cfg = port.tts_config(c)
    model = SAMBERTAcousticModel(cfg.acoustic_model)
    w = pack_decoder(model.ar_decoder, torch.bfloat16)
    mk = torch.zeros(c["decoder_layers"], b, t, c["d_model"], dtype=torch.bfloat16)
    bias = torch.zeros(b, t)
    assert bm.k1_work(c, [t] * b) == chip_smoke.k1_work(w, mk, bias, t)


def test_k1_count_takes_only_valid_frames():
    c = load_cell("tts-batch").config
    full, part = bm.k1_work(c, [1024] * 16), bm.k1_work(c, [300] * 16)
    assert part[0] < full[0] and part[1] < full[1] / 3


@pytest.mark.parametrize("name", ["tts-batch", "tts-live", "vocoder-train"])
def test_fp8_control_is_not_correct(name):
    """The reference in fp8 in the program's place, at the tests' size,
    fails one of the cell's limits."""
    import calibrate

    cell = tiny(bm_tiny.cell(name))
    checks = calibrate.readings(cell, "control", 2 ** 31 + 99, 0.3, device="cpu")["checks"]
    assert any(v > cell.limits[k] for k, v in checks.items()), checks


GOLDEN = {  # sha256, see test_sambert_hifigan_bits_unchanged
    "weights": "aeb66af4ea95a91f9c5ff830536df40bf2c1025afe4c09695b61cbde8eed333c",
    "batch": "5bf0cc990c2d3c8f3b62ee4d6af8036bb71506b75046c425e20c14a211ac36d4",
    "stream": "90a8325fd9e2870aa8e30e1216283160a056025d7d6b380c1a287ce44f6d5d27",
}


def _sha(arrays) -> str:
    """Of each (header, array): the header, then the array's bytes."""
    h = hashlib.sha256()
    for head, a in arrays:
        h.update(head.encode())
        h.update(a.tobytes())
    return h.hexdigest()


def test_sambert_hifigan_bits_unchanged():
    """The model `sambert_hifigan` at its TINY size on the CPU, seed
    2**31 + 12345: the weights bundle (every tensor's name, shape, dtype
    and bytes, in state_dict order), the f32 reference's wavs of one call
    of four texts (lengths 3, 9, 5, 12, drawn by `traffic.text` from
    numpy's generator at 7) and its stream of them in chunks of 4 frames
    with 2 of context.  The digests were recorded from commit 364a076,
    before the model was a file of its own, by the same computation
    through `common.make_weights`, `reference.acoustic.synthesize_batch`
    and `stream_chunks`, with torch 2.13.0's CPU build on one thread (the
    batch reference's bits differ on 8 threads and more)."""
    if torch.__version__.split("+")[0] != "2.13.0":
        pytest.skip(f"the digests are torch 2.13.0's, this is {torch.__version__}")
    from harness.models import sambert_hifigan as m
    from reference.precision import ieee_f32, rounder

    cpu = torch.device("cpu")
    c = {**load_cell("tts-batch").config, **m.TINY}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        W = m.weights(c, m.config(c), 2 ** 31 + 12345, cpu)
        rng = np.random.default_rng(7)
        texts = [traffic.text(rng, n) for n in (3, 9, 5, 12)]
        with ieee_f32():
            wavs = m.reference_batch(W, c, texts, rounder("f32"), cpu)
            chunks = m.reference_stream(W, c, texts, 4, 2, rounder("f32"), cpu)
    finally:
        torch.set_num_threads(threads)
    got = {"weights": _sha((f"{k}{tuple(v.shape)}{v.dtype}", v.contiguous().numpy())
                           for sd in W for k, v in sd.items()),
           "batch": _sha((str(w.shape), w) for w in wavs),
           "stream": _sha((str(w.shape), w) for s in chunks for w in s)}
    assert got == GOLDEN
