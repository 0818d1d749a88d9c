"""SAM-BERT acoustic model: PhonemeEmbedding -> BERTEncoder ->
VarianceAdaptor -> PNCAARDecoder.  Callers give `max_frames` (a frame bucket)
and get a frame mask back with every result.

Training (`forward`, every ground truth given): teacher-forced durations,
pitch, energy and mel in one differentiable forward, in the compute
`dtype` (bf16 under mixed precision: the embedding's output is cast once,
every matrix product and convolution casts its weights at use, LayerNorm
and softmax compute in f32; the caller casts the outputs to f32 for the
losses).  A host `torch.Generator` (`rng`) turns dropout on
(models/layers.py).  Inference (`encode`, `acoustic_inference`) runs in
the compute `dtype` too (f32 by default, bf16 in the bf16 pipeline) up to
the AR decode, which runs over packed weights and gives its mel back in
that dtype.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
from torch import nn

from ..config import AcousticModelConfig
from ..ops.ar_decode import DecodeWeights
from .ar_decoder import PNCAARDecoder, ar_decode
from .encoder import BERTEncoder
from .phoneme_embedding import PhonemeEmbedding
from .variance_adaptor import VarianceAdaptor, VarianceAdaptorOutput


class AcousticOutput(NamedTuple):
    mel_pred: torch.Tensor  # [B, max_frames, n_mels]
    frame_mask: torch.Tensor  # [B, max_frames] bool
    total_frames: torch.Tensor  # [B] int32
    predictions: Dict[str, torch.Tensor]


class SAMBERTAcousticModel(nn.Module):
    def __init__(self, config: AcousticModelConfig = AcousticModelConfig()):
        super().__init__()
        c = config
        self.config = c
        self.phoneme_embedding = PhonemeEmbedding(
            c.frontend.vocab_size, c.frontend.tone_size, c.frontend.boundary_size, c.d_model
        )
        self.bert_encoder = BERTEncoder(c.d_model, c.encoder)
        self.variance_adaptor = VarianceAdaptor(c.d_model, c.variance_adaptor)
        self.ar_decoder = PNCAARDecoder(c.d_model, c.n_mels, c.decoder)

    def encode(
        self,
        ph_ids: torch.Tensor,  # [B, Tph] int
        tone_ids: torch.Tensor,
        boundary_ids: torch.Tensor,
        max_frames: int,
        phoneme_mask: Optional[torch.Tensor] = None,  # [B, Tph] True = valid
        duration_scale: float = 1.0,
        pitch_shift: float = 0.0,
        energy_scale: float = 1.0,
        *,
        dur_gt: Optional[torch.Tensor] = None,
        pitch_gt: Optional[torch.Tensor] = None,
        energy_gt: Optional[torch.Tensor] = None,
        rng: Optional[torch.Generator] = None,
        dtype: torch.dtype = torch.float32,
    ) -> VarianceAdaptorOutput:
        """Embedding -> encoder -> variance adaptor (everything before the AR
        decoder)."""
        h0 = self.phoneme_embedding(ph_ids, tone_ids, boundary_ids).to(dtype)
        key_padding = None if phoneme_mask is None else ~phoneme_mask
        henc = self.bert_encoder(h0, key_padding, rng)
        return self.variance_adaptor(
            henc, max_frames, phoneme_mask, duration_scale, pitch_shift, energy_scale,
            dur_gt=dur_gt, pitch_gt=pitch_gt, energy_gt=energy_gt, rng=rng,
        )

    def forward(
        self,
        ph_ids: torch.Tensor,  # [B, Tph] int
        tone_ids: torch.Tensor,
        boundary_ids: torch.Tensor,
        mel_gt: torch.Tensor,  # [B, max_frames, n_mels]
        dur_gt: torch.Tensor,  # [B, Tph] int
        pitch_gt: Optional[torch.Tensor] = None,  # [B, max_frames]
        energy_gt: Optional[torch.Tensor] = None,  # [B, max_frames]
        phoneme_mask: Optional[torch.Tensor] = None,  # [B, Tph] True = valid
        *,
        rng: Optional[torch.Generator] = None,
        dtype: torch.dtype = torch.float32,
    ) -> AcousticOutput:
        """Teacher-forced training forward; outputs in `dtype` (masks and
        integers as they are)."""
        va = self.encode(
            ph_ids, tone_ids, boundary_ids, mel_gt.shape[1], phoneme_mask,
            dur_gt=dur_gt, pitch_gt=pitch_gt, energy_gt=energy_gt, rng=rng, dtype=dtype,
        )
        mel_pred = self.ar_decoder(va.hvar, mel_gt, ~va.frame_mask, rng)
        return AcousticOutput(mel_pred, va.frame_mask, va.total_frames, va.predictions)


@torch.no_grad()
def acoustic_inference(
    model: SAMBERTAcousticModel,
    ph_ids: torch.Tensor,
    tone_ids: torch.Tensor,
    boundary_ids: torch.Tensor,
    max_frames: int,
    decode_weights: DecodeWeights,
    phoneme_mask: Optional[torch.Tensor] = None,
    duration_scale: float = 1.0,
    pitch_shift: float = 0.0,
    energy_scale: float = 1.0,
    dtype: torch.dtype = torch.float32,
) -> AcousticOutput:
    """Predicted durations + autoregressive mel generation of `max_frames`
    frames over the packed decoder weights (`pack_decoder`); frames beyond
    each sample's predicted total are zeroed.  The decode reads the totals
    on the device and stops each row there (no host sync); the mask still
    zeroes every frame past them.  The encode computes in `dtype` and the
    mel comes back in it."""
    va = model.encode(
        ph_ids, tone_ids, boundary_ids, max_frames, phoneme_mask,
        duration_scale, pitch_shift, energy_scale, dtype=dtype,
    )
    mel = ar_decode(
        model.ar_decoder, va.hvar, max_frames,
        memory_key_padding_mask=~va.frame_mask, weights=decode_weights,
        lengths=va.total_frames.clamp(max=max_frames).to(torch.int32),
    )
    mel = mel * va.frame_mask[:, :, None].to(mel.dtype)
    return AcousticOutput(mel, va.frame_mask, va.total_frames, va.predictions)
