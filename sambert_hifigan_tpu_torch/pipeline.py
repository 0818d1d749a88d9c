"""End-to-end text -> waveform inference, one-shot.

FrontEnd (host numpy) -> acoustic inference (encoder + variance adaptor in
plain PyTorch, the AR decode in kernel K1) -> HiFi-GAN vocoder (convolutions
in plain PyTorch, each MRF in kernel K2).  The acoustic model emits mel
[B, T, n_mels] and the vocoder consumes [B, n_mels, T]; that transpose
happens once, in `vocode`.

Text is padded to a phoneme bucket, the batch to a batch bucket, and decoding
runs to a frame bucket estimated from the text length; a batch whose
predicted frames overflow the estimate is re-run once at the bucket that fits
(durations are deterministic, so the re-run lands on the same totals).

The pipeline runs on the card unless it is given device="cpu"; on the CPU
the kernels' plain versions run with f32 weights (the reference numerics).
The plain-PyTorch layers around the kernels run in IEEE f32 on the card too:
TF32 is off for matmuls and cuDNN convolutions while the pipeline computes.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import List, Optional

import numpy as np
import torch

from .config import TTSConfig
from .kernels import kernel_dtype, resolve_device
from .models.acoustic_model import AcousticOutput, SAMBERTAcousticModel, acoustic_inference
from .models.ar_decoder import pack_decoder
from .models.hifigan import HiFiGANGenerator
from .text.frontend import FrontEnd, pick_bucket
from .weights import random_acoustic_model, random_generator


@contextlib.contextmanager
def _ieee_f32():
    """TF32 off for torch matmuls and cuDNN convolutions (encoder, variance
    adaptor, memory K/V, vocoder convs), restored on exit."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = matmul.allow_tf32, cudnn.allow_tf32
    matmul.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved


class TTSPipeline:
    """Text -> wav.  `acoustic_state` / `generator_state` are the port's
    state_dicts (weights.py carries them over from the JAX package)."""

    def __init__(self, cfg: TTSConfig, acoustic_state, generator_state, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.acoustic = SAMBERTAcousticModel(cfg.acoustic_model)
        self.acoustic.load_state_dict(acoustic_state)
        self.acoustic.to(self.device).eval()
        self.generator = HiFiGANGenerator(cfg.vocoder.generator)
        self.generator.load_state_dict(generator_state)
        self.generator.to(self.device).eval()
        # the kernels' weights, packed once per pipeline
        self.kernel_dtype = kernel_dtype(self.device)
        self.decode_weights = pack_decoder(self.acoustic.ar_decoder, self.kernel_dtype)
        self.mrf_weights = self.generator.pack(self.kernel_dtype)
        fe = cfg.acoustic_model.frontend
        self.frontend = FrontEnd(fe.vocab_size, fe.tone_size, fe.boundary_size)
        self.hop = cfg.audio.hop_length

    def _frontend_args(self, texts):
        """Bucket-padded frontend features as device tensors."""
        feat = self.frontend.batch_forward(texts)
        tph = pick_bucket(feat.ph_ids.shape[1], self.cfg.runtime.phoneme_buckets)
        feat = self.frontend.batch_forward(texts, pad_to=tph)
        args = tuple(
            torch.from_numpy(a).to(self.device)
            for a in (feat.ph_ids.astype(np.int64), feat.tone_ids.astype(np.int64),
                      feat.boundary_ids.astype(np.int64), feat.phoneme_mask)
        )
        return tph, args

    def _initial_bucket(self, tph: int, duration_scale: float) -> int:
        """~12 frames per phoneme scaled by the duration control, clamped into
        the configured frame buckets."""
        buckets = self.cfg.runtime.frame_buckets
        est = int(tph * 12 * max(duration_scale, 1.0))
        return pick_bucket(min(est, max(buckets)), buckets)

    def _acoustic(self, args, max_frames, duration_scale, pitch_shift, energy_scale):
        ph, tone, bound, pmask = args
        with _ieee_f32():
            return acoustic_inference(
                self.acoustic, ph, tone, bound, max_frames, self.decode_weights,
                phoneme_mask=pmask, duration_scale=duration_scale,
                pitch_shift=pitch_shift, energy_scale=energy_scale,
            )

    @staticmethod
    def _warn_truncated(need: int, max_frames: int) -> None:
        if need > max_frames:
            warnings.warn(
                f"predicted {need} frames exceed the largest frame bucket "
                f"({max_frames}); audio will be truncated - split the text "
                "or enlarge runtime.frame_buckets"
            )

    # ---- public API ----------------------------------------------------------

    @torch.no_grad()
    def text_to_mel(
        self,
        texts: List[str],
        duration_scale: float = 1.0,
        pitch_shift: float = 0.0,
        energy_scale: float = 1.0,
        max_frames: Optional[int] = None,
    ) -> AcousticOutput:
        tph, args = self._frontend_args(texts)
        controls = (duration_scale, pitch_shift, energy_scale)
        if max_frames is not None:  # caller pinned the bucket
            return self._acoustic(args, max_frames, *controls)
        buckets = self.cfg.runtime.frame_buckets
        max_frames = self._initial_bucket(tph, duration_scale)
        out = self._acoustic(args, max_frames, *controls)
        need = int(out.total_frames.max())
        if need > max_frames and max_frames < max(buckets):
            max_frames = pick_bucket(min(need, max(buckets)), buckets)
            out = self._acoustic(args, max_frames, *controls)
            need = int(out.total_frames.max())
        self._warn_truncated(need, max_frames)
        return out

    @torch.no_grad()
    def vocode(self, mel_btc: torch.Tensor) -> torch.Tensor:
        """mel [B, T, n_mels] -> wav [B, 1, T * hop]."""
        with _ieee_f32():
            return self.generator(mel_btc.transpose(1, 2), self.mrf_weights)

    def synthesize(
        self,
        text: str,
        duration_scale: float = 1.0,
        pitch_shift: float = 0.0,
        energy_scale: float = 1.0,
    ) -> np.ndarray:
        """text -> waveform [T_wav] float32, trimmed to the true length."""
        return self.synthesize_batch(
            [text], duration_scale=duration_scale, pitch_shift=pitch_shift,
            energy_scale=energy_scale,
        )[0]

    @torch.no_grad()
    def synthesize_batch(
        self,
        texts: List[str],
        duration_scale: float = 1.0,
        pitch_shift: float = 0.0,
        energy_scale: float = 1.0,
        max_frames: Optional[int] = None,
    ) -> List[np.ndarray]:
        """Batch text -> wav with one host sync on the happy path: acoustic
        inference and vocoding are enqueued back to back on the estimated
        frame bucket (or the caller-pinned `max_frames`), then the wavs and
        totals come back together.  Only a bucket overflow pays a second
        pass.  The batch is padded (repeating the last text) up to the next
        runtime.batch_buckets size; outputs are sliced back to len(texts)."""
        n = len(texts)
        bb = self.cfg.runtime.batch_buckets
        if bb and n < max(bb):
            texts = list(texts) + [texts[-1]] * (pick_bucket(n, bb) - n)
        tph, args = self._frontend_args(texts)
        buckets = self.cfg.runtime.frame_buckets
        if max_frames is not None:  # caller pinned the bucket: never re-run
            buckets = (max_frames,)
        else:
            max_frames = self._initial_bucket(tph, duration_scale)
        for _ in range(2):  # optimistic pass + at most one overflow re-run
            out = self._acoustic(args, max_frames, duration_scale, pitch_shift, energy_scale)
            wav = self.vocode(out.mel_pred)
            # the wav copy waits for the device; the totals copy then finds
            # the stream drained
            wav_np = wav.cpu().numpy()
            totals = out.total_frames.cpu().numpy()
            need = int(totals.max())
            if need <= max_frames or max_frames >= max(buckets):
                break
            max_frames = pick_bucket(min(need, max(buckets)), buckets)
        self._warn_truncated(need, max_frames)
        return [
            np.asarray(wav_np[i, 0, : min(int(totals[i]), max_frames) * self.hop])
            for i in range(n)
        ]


def build_pipeline_from_random_init(cfg: TTSConfig, seed: int = 0, device=None) -> TTSPipeline:
    """Random-weight pipeline from a seed (benchmarks and smoke runs)."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    acoustic = random_acoustic_model(cfg, gen)
    generator = random_generator(cfg, gen)
    return TTSPipeline(cfg, acoustic.state_dict(), generator.state_dict(), device=device)
