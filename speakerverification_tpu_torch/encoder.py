"""SpeakerEncoder: frontend + backbone + loss head (port of ``encoder.py``).

``wave [B, T]`` (or ``[B, nPerSpeaker, T]``) → embeddings
``[B(, nPerSpeaker), D]``; called with labels, the embeddings are
grouped per speaker (``[B, nPerSpeaker, D]``) and the loss head returns
``(loss, prec1)``. The head sits under ``loss``, as the JAX module keeps
its parameters under ``params["loss"]``. With ``spec_augment`` set, a
training forward runs SpecAugment on the frontend's fp32 features before
the cast, its numbers from the ``rng`` that ``forward`` is given; a
hybrid backbone featurizes in-model and is handed ``rng`` for its own,
and a backbone with dropout (``draws_dropout``, the Conformer family)
is handed it for its masks.

``gather_axis`` (set by ``builder.encoder_from_hparams`` under
``distributed`` with more than one process): inside a data-parallel step
that binds that axis to its process group (``parallel/dp.py``), the
embeddings and labels of every rank are gathered before the loss head,
so that a metric loss sees the global batch; the gather carries the
gradient back to each rank's rows (``parallel.collectives.all_gather_rows``).
Outside such a step the head sees the local batch.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from speakerverification_tpu_torch.ops.frontend import (
    FrontendConfig,
    select_mel_frontend,
)
from speakerverification_tpu_torch.ops.specaugment import (
    SpecAugmentConfig,
    spec_augment,
)
from speakerverification_tpu_torch.parallel.collectives import (
    all_gather_rows,
    bound_group,
)

__all__ = ["SpeakerEncoder"]


class SpeakerEncoder(nn.Module):
    def __init__(self, backbone: nn.Module,
                 loss: Optional[nn.Module] = None,
                 feature_type: str = "melspectrogram",
                 frontend: FrontendConfig = FrontendConfig(),
                 frontend_backend: str = "auto",
                 compute_dtype: Optional[torch.dtype] = None,
                 spec_augment: Optional[SpecAugmentConfig] = None,
                 gather_axis: Optional[str] = None):
        super().__init__()
        self.backbone = backbone
        self.loss = loss
        self.feature_type = feature_type
        self.frontend = frontend
        # 'xla' | 'pallas' | 'auto': 'pallas' runs the mel kernel
        # (ops/mel_frontend.py), 'auto' picks it for CUDA tensors
        self.frontend_backend = frontend_backend
        # features are cast to this dtype before the backbone; the
        # frontend always computes in fp32
        self.compute_dtype = compute_dtype
        self.spec_augment = spec_augment
        self.gather_axis = gather_axis

    def _frontend_fn(self, wave: torch.Tensor):
        return select_mel_frontend(self.frontend, self.feature_type,
                                   self.frontend_backend, wave)

    def _embed(self, wave: torch.Tensor, rng) -> torch.Tensor:
        if self.feature_type == "raw" and hasattr(self.backbone, "frontend"):
            # hybrids featurize in-model from the uncast fp32 wave
            return self.backbone(wave.float(), rng)
        feats = self._frontend_fn(wave)(wave.float())
        if self.training and self.spec_augment is not None and \
                feats.dim() == 3:
            feats = spec_augment(feats, self.spec_augment, rng)
        if self.compute_dtype is not None:
            feats = feats.to(self.compute_dtype)
        if getattr(self.backbone, "draws_dropout", False):
            return self.backbone(feats, rng=rng)
        return self.backbone(feats)

    def forward(self, wave: torch.Tensor,
                label: Optional[torch.Tensor] = None, rng=None):
        """``wave``: ``[B, T]`` or ``[B, nPerSpeaker, T]`` audio. Returns
        the embeddings, or ``(loss, prec1)`` when ``label`` is given.
        ``rng`` (a ``torch.Generator`` on the wave's device, or a
        ``SpecAugmentDraw``) feeds SpecAugment and dropout in training."""
        if label is not None and self.loss is None:
            raise ValueError("SpeakerEncoder built without a loss head")
        grouped = wave.dim() == 3
        n_per = wave.shape[1] if grouped else 1
        emb = self._embed(wave.reshape(-1, wave.shape[-1]), rng)
        if label is None:
            return emb.reshape(-1, n_per, emb.shape[-1]) if grouped else emb
        emb = emb.reshape(-1, n_per, emb.shape[-1])
        group = bound_group(self.gather_axis)
        if group is not None:
            emb = all_gather_rows(emb, group)
            label = all_gather_rows(label, group)
        return self.loss(emb, label)
