"""End-to-end text -> waveform inference, one-shot and streaming.

FrontEnd (host numpy) -> acoustic inference (encoder + variance adaptor in
plain PyTorch, the AR decode in kernel K1) -> HiFi-GAN vocoder (convolutions
in plain PyTorch, each MRF in kernel K2).  The acoustic model emits mel
[B, T, n_mels] and the vocoder consumes [B, n_mels, T]; that transpose
happens once, in `vocode`.

Text is padded to a phoneme bucket, the batch to a batch bucket, and decoding
runs to a frame bucket estimated from the text length; a batch whose
predicted frames overflow the estimate is re-run once at the bucket that fits
(durations are deterministic, so the re-run lands on the same totals).

Streaming: `stream()` yields waveform chunks of `chunk_frames` frames as soon
as their mel exists.  The AR decode runs in chunks (one K1 launch each, from
the carry the last chunk left), and each chunk is vocoded from a window of
`context_frames` margin on each side (HiFi-GAN's receptive field is finite),
so the streamed audio matches `synthesize` to windowed-vocoding tolerance.
The chained chunks give the one-shot decode's bits.

The pipeline runs on the card unless it is given device="cpu"; on the CPU
the kernels' plain versions run with f32 weights (the reference numerics).
The plain-PyTorch layers around the kernels run in IEEE f32 on the card too:
TF32 is off for matmuls and cuDNN convolutions while the pipeline computes.

`dtype=torch.bfloat16` is the JAX pipeline's `dtype=jnp.bfloat16`: the
encoder, the variance adaptor, the memory K/V and the generator's
convolutions compute in bf16, the decode's biases are rounded to bf16, the
mel comes back in bf16, and each MRF takes and gives bf16.  The kernels'
weights are bf16 on either device then, so the CPU's plain versions round
where the kernels do.  f32 is the default, as in the JAX package.

Data-parallel serving (`devices=[...]`, the JAX package's `mesh=`): one
replica of the weights per device, the batch padded to a multiple of the
device count and split into contiguous rows, one frame bucket and at most
one overflow re-run for the whole batch; `stream` runs unsplit on the first
device.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import kernels, tracing
from .config import TTSConfig
from .kernels import kernel_dtype, resolve_device
from .models.acoustic_model import AcousticOutput, SAMBERTAcousticModel, acoustic_inference
from .models.ar_decoder import ar_decode_chunk, decode_memory, init_packed_carry, pack_decoder
from .models.hifigan import HiFiGANGenerator
from .parallel.mesh import shard_rows
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


def resolve_devices(device=None, devices=None) -> List[torch.device]:
    """The pipeline's device list: `[resolve_device(device)]` without
    `devices`; otherwise `devices` with each bare "cuda" resolved to the
    current card's index (a tensor's device always carries one, and the
    kernels compare devices).  Raises ValueError on an empty list, a list
    that mixes device types, or a `device` other than `devices[0]`."""
    if devices is None:
        return [resolve_device(device)]

    def indexed(dev) -> torch.device:
        dev = torch.device(dev)
        return torch.device("cuda", torch.cuda.current_device()) \
            if dev.type == "cuda" and dev.index is None else dev

    devs = [indexed(d) for d in devices]
    if not devs:
        raise ValueError("devices: the list is empty")
    types = sorted({d.type for d in devs})
    if len(types) > 1:
        raise ValueError(f"devices: every entry must be of one type, got {types}")
    if device is not None and indexed(device) != devs[0]:
        raise ValueError(f"device {device} disagrees with devices[0] {devs[0]}")
    return devs


class TTSPipeline:
    """Text -> wav.  `acoustic_state` / `generator_state` are the port's
    state_dicts (weights.py carries them over from the JAX package).

    `devices`, a list of torch devices, serves batches data-parallel, as the
    JAX pipeline's `mesh` does over its 'data' axis: each entry gets its own
    replica (acoustic model, generator, K1's and K2's packed weights) on its
    device, `devices[0]` is `self.device`, and `stream` and the calls that do
    not split run there.  An entry may repeat: the CPU is one torch device,
    so a CPU pipeline over d replicas is `["cpu"] * d`, and two replicas on
    one card run the split path where there is one card.  `devices=None` is
    the single-device pipeline.

    `dtype` (torch.float32 or torch.bfloat16) is the compute dtype of every
    path and every replica."""

    def __init__(self, cfg: TTSConfig, acoustic_state, generator_state, device=None,
                 devices=None, dtype: torch.dtype = torch.float32):
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be torch.float32 or torch.bfloat16, got {dtype}")
        self.cfg = cfg
        self.dtype = dtype
        self.devices = resolve_devices(device, devices)
        self.device = self.devices[0]
        self.acoustic = SAMBERTAcousticModel(cfg.acoustic_model)
        self.acoustic.load_state_dict(acoustic_state)
        self.acoustic.to(self.device).eval()
        self.generator = HiFiGANGenerator(cfg.vocoder.generator)
        self.generator.load_state_dict(generator_state)
        self.generator.to(self.device).eval()
        # the kernels' weights, packed once per pipeline
        self.kernel_dtype = torch.bfloat16 if dtype == torch.bfloat16 else kernel_dtype(self.device)
        self.decode_weights = pack_decoder(self.acoustic.ar_decoder, self.kernel_dtype, dtype)
        self.mrf_weights = self.generator.pack(self.kernel_dtype)
        fe = cfg.acoustic_model.frontend
        self.frontend = FrontEnd(fe.vocab_size, fe.tone_size, fe.boundary_size)
        self.hop = cfg.audio.hop_length
        # one replica per entry of `devices`, this pipeline the first
        self.replicas = [self] + [TTSPipeline(cfg, acoustic_state, generator_state, device=dev,
                                              dtype=dtype)
                                  for dev in self.devices[1:]]

    def _features(self, texts):
        """Bucket-padded frontend features on the host: (tph, arrays)."""
        feat = self.frontend.batch_forward(texts)
        tph = pick_bucket(feat.ph_ids.shape[1], self.cfg.runtime.phoneme_buckets)
        feat = self.frontend.batch_forward(texts, pad_to=tph)
        return tph, (feat.ph_ids.astype(np.int64), feat.tone_ids.astype(np.int64),
                     feat.boundary_ids.astype(np.int64), feat.phoneme_mask)

    def _frontend_args(self, texts):
        """Bucket-padded frontend features as tensors on `self.device`."""
        tph, feats = self._features(texts)
        return tph, tuple(torch.from_numpy(a).to(self.device) for a in feats)

    def _split_args(self, texts):
        """The texts padded to a multiple of the replica count (repeating the
        last text), the front end run once for the whole batch (one phoneme
        bucket), and each replica's contiguous rows on its device: (tph,
        [args of each replica])."""
        d = len(self.replicas)
        texts = list(texts) + [texts[-1]] * (-len(texts) % d)
        tph, feats = self._features(texts)
        return tph, [tuple(torch.from_numpy(shard_rows(a, d, r)).to(rep.device) for a in feats)
                     for r, rep in enumerate(self.replicas)]

    def _initial_bucket(self, tph: int, duration_scale: float) -> int:
        """~12 frames per phoneme scaled by the duration control, clamped into
        the configured frame buckets."""
        buckets = self.cfg.runtime.frame_buckets
        est = int(tph * 12 * max(duration_scale, 1.0))
        return pick_bucket(min(est, max(buckets)), buckets)

    def _encode(self, args, max_frames, duration_scale, pitch_shift, energy_scale):
        """Encoder + variance adaptor only (everything before the AR
        decoder): the streaming path runs this, then decodes in chunks."""
        ph, tone, bound, pmask = args
        with _ieee_f32():
            return self.acoustic.encode(ph, tone, bound, max_frames, pmask, duration_scale,
                                        pitch_shift, energy_scale, dtype=self.dtype)

    def _acoustic(self, args, max_frames, duration_scale, pitch_shift, energy_scale):
        ph, tone, bound, pmask = args
        with _ieee_f32():
            return acoustic_inference(
                self.acoustic, ph, tone, bound, max_frames, self.decode_weights,
                phoneme_mask=pmask, duration_scale=duration_scale,
                pitch_shift=pitch_shift, energy_scale=energy_scale, dtype=self.dtype,
            )

    def _dispatch(self, parts, max_frames, controls, vocode: bool):
        """Enqueue every replica's acoustic pass (and vocode) on its own
        device before anything is copied to the host, so the devices run
        together: [(AcousticOutput, wav or None)] in replica order."""
        outs = []
        with _ieee_f32():
            for rep, args in zip(self.replicas, parts):
                with tracing.device_span("batch.acoustic", rep.device):
                    out = rep._acoustic(args, max_frames, *controls)
                wav = None
                if vocode:
                    with tracing.device_span("batch.vocode", rep.device):
                        wav = rep._vocode(out.mel_pred)
                outs.append((out, wav))
        return outs

    def _gather(self, outs) -> AcousticOutput:
        """The replicas' AcousticOutputs as one, in row order on `self.device`."""
        if len(outs) == 1:
            return outs[0]

        def cat(ts):
            return torch.cat([t.to(self.device) for t in ts])

        return AcousticOutput(
            cat(o.mel_pred for o in outs), cat(o.frame_mask for o in outs),
            cat(o.total_frames for o in outs),
            {k: cat(o.predictions[k] for o in outs) for k in outs[0].predictions})

    @staticmethod
    def _warn_truncated(need: int, max_frames: int) -> None:
        if need > max_frames:
            warnings.warn(
                f"predicted {need} frames exceed the largest frame bucket "
                f"({max_frames}); audio will be truncated - split the text "
                "or enlarge runtime.frame_buckets"
            )

    def warmup(
        self,
        max_frames: Optional[int] = None,
        streaming: bool = False,
        batch_buckets: bool = False,
        chunk_frames: int = 32,
        context_frames: int = 16,
    ) -> None:
        """Build the kernels, then run every (phoneme bucket, frame bucket)
        pair once, so that no user request pays a first call (serving calls
        this at startup).  With max_frames given, the one-shot and batch
        legs run only that frame bucket.  streaming=True also streams one
        text per phoneme bucket, at the bucket `stream` estimates for it, as
        a user's stream of that text would run; batch_buckets=True runs
        synthesize_batch at every runtime.batch_buckets size at the smallest
        text bucket.  Nothing in the port compiles per shape, so unlike the
        JAX package's warmup this one has no decode-chunk graph to warm for
        every frame bucket.  Over several devices every leg runs on each of
        them (text_to_mel, vocode and synthesize_batch split), so that a
        card's first launch falls here; the stream legs run on devices[0],
        where `stream` runs."""
        if self.device.type == "cuda":
            kernels.build_all()
        frame_buckets = [max_frames] if max_frames else list(self.cfg.runtime.frame_buckets)
        texts = {
            tph: "预" * max(1, tph - 2)  # fills the bucket exactly with BOS/EOS
            for tph in self.cfg.runtime.phoneme_buckets
        }
        for tph, text in texts.items():
            for tfrm in frame_buckets:
                out = self.text_to_mel([text], max_frames=tfrm)
                self.vocode(out.mel_pred)
            if streaming:
                for _ in self.stream(text, chunk_frames=chunk_frames,
                                     context_frames=context_frames):
                    pass
        if batch_buckets:
            text0 = texts[min(texts)]
            for b in self.cfg.runtime.batch_buckets:
                self.synthesize_batch([text0] * b, max_frames=max_frames)

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
        """texts -> AcousticOutput on `self.device`.  Over d devices the rows
        are the texts padded to a multiple of d, as the JAX mesh returns them
        (callers slice)."""
        tph, parts = self._split_args(texts)
        controls = (duration_scale, pitch_shift, energy_scale)

        def run(frames):
            return [out for out, _ in self._dispatch(parts, frames, controls, vocode=False)]

        if max_frames is not None:  # caller pinned the bucket
            return self._gather(run(max_frames))
        buckets = self.cfg.runtime.frame_buckets
        max_frames = self._initial_bucket(tph, duration_scale)
        outs = run(max_frames)
        need = max(int(o.total_frames.max()) for o in outs)
        if need > max_frames and max_frames < max(buckets):
            max_frames = pick_bucket(min(need, max(buckets)), buckets)
            outs = run(max_frames)
            need = max(int(o.total_frames.max()) for o in outs)
        self._warn_truncated(need, max_frames)
        return self._gather(outs)

    def _vocode(self, mel_btc: torch.Tensor) -> torch.Tensor:
        """This replica's vocoder on its own device."""
        with _ieee_f32():
            return self.generator(mel_btc.transpose(1, 2), self.mrf_weights, self.dtype)

    @torch.no_grad()
    def vocode(self, mel_btc: torch.Tensor) -> torch.Tensor:
        """mel [B, T, n_mels] -> wav [B, 1, T * hop] f32 on `self.device`
        (the generator computes in the pipeline's dtype).  Over
        d devices the rows are split over the replicas when d divides B (as
        the JAX mesh shards the mel), else they all run on devices[0]."""
        d = len(self.replicas)
        if d == 1 or mel_btc.shape[0] % d:
            return self._vocode(mel_btc.to(self.device))
        with _ieee_f32():
            wavs = [rep._vocode(shard_rows(mel_btc, d, r).to(rep.device))
                    for r, rep in enumerate(self.replicas)]
        return torch.cat([w.to(self.device) for w in wavs])

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
        runtime.batch_buckets size; outputs are sliced back to len(texts).

        Over d devices the padded batch is padded again to a multiple of d
        and split; every replica is enqueued before the first copy, and the
        whole batch shares one frame bucket and one overflow decision (the
        largest total of any row), as the JAX mesh's one program does."""
        with tracing.span("batch.call"):
            n = len(texts)
            with tracing.span("batch.frontend"):
                bb = self.cfg.runtime.batch_buckets
                if bb and n < max(bb):
                    texts = list(texts) + [texts[-1]] * (pick_bucket(n, bb) - n)
                tph, parts = self._split_args(texts)
            rows = sum(p[0].shape[0] for p in parts)
            tracing.count("batch.rows_padded", rows - n)
            controls = (duration_scale, pitch_shift, energy_scale)
            buckets = self.cfg.runtime.frame_buckets
            if max_frames is not None:  # caller pinned the bucket: never re-run
                buckets = (max_frames,)
            else:
                max_frames = self._initial_bucket(tph, duration_scale)
            for rerun in range(2):  # optimistic pass + at most one overflow re-run
                tracing.count("batch.overflow_reruns", rerun)
                tracing.count("batch.frames_decoded", rows * max_frames)
                with tracing.span("batch.dispatch"):
                    outs = self._dispatch(parts, max_frames, controls, vocode=True)
                # each wav copy waits for its own device only, and every device's
                # work is already enqueued; the totals copies then find them drained
                with tracing.span("batch.fetch"):
                    wav_np = np.concatenate([wav.cpu().numpy() for _, wav in outs])
                    per_replica = [out.total_frames.cpu().numpy() for out, _ in outs]
                    totals = np.concatenate(per_replica)
                if tracing.enabled():  # K1 ran each replica to its longest row, within the bucket
                    tracing.count("batch.k1_steps",
                                  sum(min(int(t.max()), max_frames) for t in per_replica))
                need = int(totals.max())
                if need <= max_frames or max_frames >= max(buckets):
                    break
                max_frames = pick_bucket(min(need, max(buckets)), buckets)
            self._warn_truncated(need, max_frames)
            frames = [min(int(totals[i]), max_frames) for i in range(n)]
            tracing.count("batch.frames_returned", sum(frames))
            return [np.asarray(wav_np[i, 0, : frames[i] * self.hop]) for i in range(n)]

    # ---- streaming -----------------------------------------------------------

    @torch.no_grad()
    def stream(
        self,
        text: str,
        chunk_frames: int = 32,
        context_frames: int = 16,
        duration_scale: float = 1.0,
        pitch_shift: float = 0.0,
        energy_scale: float = 1.0,
    ) -> Iterator[np.ndarray]:
        """Incremental synthesis: yield waveform chunks of chunk_frames * hop
        samples as soon as their mel frames exist (the last chunk may be
        shorter).

        The first chunk comes after the encode and ~(chunk + context) decode
        steps, with one host sync: the encode, the memory K/V, the first
        decode chunks, the window and the first vocode are enqueued on the
        estimated frame bucket, then the first wav and the total frame count
        come back in one copy.  Only a bucket overflow restarts, exactly, at
        the bucket that fits.  Later chunks cost one copy each.  The text is
        one row, not padded to a batch bucket.  Grad mode is off whichever
        thread resumes the generator."""
        with tracing.span("stream.frontend"):
            tph, args = self._frontend_args([text])
        controls = (duration_scale, pitch_shift, energy_scale)
        buckets = self.cfg.runtime.frame_buckets
        max_frames = self._initial_bucket(tph, duration_scale)
        run = _StreamRun(self, args, controls, max_frames, chunk_frames, context_frames)
        first_wav, need = run.first_fetch()
        restart = need > max_frames and max_frames < max(buckets)
        tracing.count("stream.overflow_restarts", restart)
        if restart:
            # the truncated encode would change the decode: restart cleanly
            max_frames = pick_bucket(min(need, max(buckets)), buckets)
            run = _StreamRun(self, args, controls, max_frames, chunk_frames, context_frames)
            first_wav, need = run.first_fetch()
        self._warn_truncated(need, max_frames)
        total = min(need, max_frames)
        frames = min(chunk_frames, total)
        tracing.count("stream.frames_returned", frames)
        yield first_wav[: frames * self.hop]
        for start in range(chunk_frames, total, chunk_frames):
            wav = run.window_wav(start, total)
            with tracing.span("stream.fetch"):
                wav = wav.cpu().numpy()
            frames = min(chunk_frames, total - start)
            tracing.count("stream.frames_returned", frames)
            yield wav[: frames * self.hop]


class _StreamRun:
    """Device state of one streaming synthesis at a fixed frame bucket.

    Decoded mel chunks stay on the device, vocode windows are assembled there
    (concatenate, slice, zero the frames at or past the total, which also
    stays on the device), so the host only waits for finished wav chunks."""

    def __init__(self, pipe: TTSPipeline, args, controls, max_frames: int,
                 chunk_frames: int, context_frames: int):
        self.pipe = pipe
        self.max_frames = max_frames
        self.chunk = chunk_frames
        self.context = context_frames
        self.window = chunk_frames + 2 * context_frames
        self.hop = pipe.hop
        with tracing.device_span("stream.encode", pipe.device):
            va = pipe._encode(args, max_frames, *controls)
            with _ieee_f32():  # memory K/V projected once per utterance
                self.memory = decode_memory(pipe.acoustic.ar_decoder, va.hvar, ~va.frame_mask,
                                            pipe.decode_weights)
        self.carry = init_packed_carry(pipe.decode_weights, 1, max_frames)
        self.total_frames = va.total_frames
        # masks window tails; K1 stops the row there
        self.total_dev = va.total_frames.clamp(max=max_frames).to(torch.int32)
        self.chunks: List[torch.Tensor] = []  # [1, steps, n_mels] each, the pipeline's dtype
        self.pos = 0  # frames decoded

    def _ensure_decoded(self, need: int) -> None:
        """Decode chunk by chunk until `need` frames exist; the last chunk
        stops at the bucket."""
        while self.pos < min(need, self.max_frames):
            steps = min(self.chunk, self.max_frames - self.pos)
            with tracing.device_span("stream.decode", self.pipe.device):
                self.carry, mel = ar_decode_chunk(self.pipe.decode_weights, self.memory,
                                                  self.carry, self.pos, steps, self.total_dev)
                # the one-shot decode's cast; the carry keeps the f32 frame, which
                # the next chunk's prenet rounds as the one-shot feedback does
                self.chunks.append(mel.to(self.pipe.dtype))
            tracing.count("stream.k1_steps", steps)
            self.pos += steps

    def _window_device(self, start: int) -> torch.Tensor:
        """Vocode the window around [start, start + chunk) on the device;
        returns the chunk's wav.  The window stops at the bucket's end, where
        the one-shot vocode's convolutions pad (the JAX package fills it
        with zero frames instead, which moves the last samples of a text
        that fills its bucket)."""
        with tracing.device_span("stream.vocode", self.pipe.device):
            lo = max(0, start - self.context)
            n = min(self.window, self.max_frames - lo)
            c0, c1 = lo // self.chunk, (lo + n - 1) // self.chunk
            off = lo - c0 * self.chunk
            seg = torch.cat(self.chunks[c0:c1 + 1], dim=1)[:, off:off + n]
            # frames not decoded lie at or past the total: zeros, as the mask makes
            # every frame there in the one-shot path
            seg = F.pad(seg, (0, 0, 0, n - seg.shape[1]))
            idx = lo + torch.arange(n, device=seg.device)
            seg = seg * (idx < self.total_dev).to(seg.dtype)[None, :, None]
            wav = self.pipe._vocode(seg)
            s = (start - lo) * self.hop
            return wav[0, 0, s:s + self.chunk * self.hop]

    def first_fetch(self) -> Tuple[np.ndarray, int]:
        """Enqueue everything up to the first vocoded chunk, then one copy
        of (first wav, total frames)."""
        self._ensure_decoded(self.chunk + self.context)
        wav = self._window_device(0)
        both = torch.cat([wav, self.total_frames.float()])
        with tracing.span("stream.fetch"):
            host = both.cpu().numpy()
        return host[:-1], int(host[-1])

    def window_wav(self, start: int, total: int) -> torch.Tensor:
        """A later chunk: decode as far as its window's right context, then
        vocode on the device."""
        self._ensure_decoded(min(start + self.chunk + self.context, total))
        return self._window_device(start)


def build_pipeline_from_random_init(cfg: TTSConfig, seed: int = 0, device=None,
                                    devices=None, dtype: torch.dtype = torch.float32
                                    ) -> TTSPipeline:
    """Random-weight pipeline from a seed (benchmarks and smoke runs); the
    weights do not depend on `dtype`."""
    resolve_devices(device, devices)  # refuse a bad device before making weights
    gen = torch.Generator().manual_seed(seed)
    acoustic = random_acoustic_model(cfg, gen)
    generator = random_generator(cfg, gen)
    return TTSPipeline(cfg, acoustic.state_dict(), generator.state_dict(), device=device,
                       devices=devices, dtype=dtype)


def build_pipeline(cfg: TTSConfig, seed: int = 0, device=None,
                   acoustic_checkpoint: Optional[str] = None,
                   vocoder_checkpoint: Optional[str] = None, devices=None) -> TTSPipeline:
    """A pipeline over the latest checkpoint of each training directory
    given (`train_acoustic`, `train_vocoder`), its EMA copy where it has
    one; without either, the random-weight pipeline of `seed`, and a model
    without a checkpoint beside one that has one gets random weights from
    `seed`.  The decoder is packed for K1 and the MRFs for K2 from the
    loaded weights.  Refuses a checkpoint trained under another mel
    configuration.  `devices` as in TTSPipeline."""
    from .training.acoustic_trainer import acoustic_params_from_tree
    from .training.checkpoint import CheckpointManager
    from .training.vocoder_trainer import generator_params_from_tree

    if not (acoustic_checkpoint or vocoder_checkpoint):
        return build_pipeline_from_random_init(cfg, seed, device, devices)
    resolve_devices(device, devices)  # refuse a bad device before loading
    if acoustic_checkpoint:
        tree, _ = CheckpointManager(acoustic_checkpoint, cfg.audio).restore_tree()
        acoustic = acoustic_params_from_tree(tree)
    else:
        acoustic = random_acoustic_model(cfg, torch.Generator().manual_seed(seed)).state_dict()
    if vocoder_checkpoint:
        tree, _ = CheckpointManager(vocoder_checkpoint, cfg.audio).restore_tree()
        generator = generator_params_from_tree(tree)
    else:
        generator = random_generator(cfg, torch.Generator().manual_seed(seed)).state_dict()
    return TTSPipeline(cfg, acoustic, generator, device=device, devices=devices)
