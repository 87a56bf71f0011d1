"""Build the port's objects from the YAML schema (port of ``builder.py``).

The embedding path only: frontend config, compute dtype and the
``SpeakerEncoder`` for ``Raw3_ECAPA`` and ``ECAPA_TDNN`` (and the other
registered names). ``frontend_backend`` and ``model.conv_backend`` take
``'auto' | 'xla' | 'pallas'``: ``'pallas'`` selects the port's
hand-written kernel, ``'xla'`` the plain PyTorch path, ``'auto'`` the
kernel on CUDA.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch

from speakerverification_tpu_torch.encoder import SpeakerEncoder
from speakerverification_tpu_torch.ops.frontend import FrontendConfig
from speakerverification_tpu_torch.registry import MODELS

__all__ = ["compute_dtype_from_hparams", "frontend_from_hparams",
           "encoder_from_hparams", "build_model", "eval_normalize_from_hparams"]

_BACKENDS = ("auto", "xla", "pallas")

# loss heads whose embeddings are scored unnormalized (``test_normalize``
# in speakerverification_tpu/losses/*.py); every other head normalizes
_UNNORMALIZED_HEADS = frozenset({"Prototypical"})


def eval_normalize_from_hparams(hparams: Mapping) -> bool:
    """Whether the configured loss head (``criterion.name``, default
    ``AAmSoftmax``) L2-normalizes embeddings at evaluation."""
    name = (hparams.get("criterion") or {}).get("name", "AAmSoftmax")
    return name not in _UNNORMALIZED_HEADS


def compute_dtype_from_hparams(hparams: Mapping) -> Optional[torch.dtype]:
    """bf16 when ``mixedprec`` or ``precision: bf16`` is set, else None."""
    if hparams.get("mixedprec") or str(
            hparams.get("precision", "")).lower() in ("bf16", "bfloat16"):
        return torch.bfloat16
    return None


def frontend_from_hparams(hparams: Mapping,
                          feature_type: str = "melspectrogram",
                          ) -> FrontendConfig:
    return FrontendConfig.from_hparams(dict(hparams), feature_type)


def build_model(name: str, **kwargs):
    # importing the model modules fills the registry
    from speakerverification_tpu_torch.models import (  # noqa: F401
        ecapa_tdnn,
        hybrids,
    )
    return MODELS.get(name)(**kwargs)


def encoder_from_hparams(hparams: Mapping) -> SpeakerEncoder:
    """Build the embedding ``SpeakerEncoder`` from a config (loss heads
    come with the training slice)."""
    model_cfg = dict(hparams.get("model", {}))
    name = model_cfg.pop("name", "ECAPA_TDNN")
    n_out = int(model_cfg.pop("nOut", 192))
    feature_type = model_cfg.pop("feature_type",
                                 hparams.get("features", "melspectrogram"))
    if feature_type == "raw" and name == "ECAPA_TDNN":
        # ECAPA always consumes mel features
        feature_type = "melspectrogram"
    if isinstance(name, (list, tuple)):
        raise NotImplementedError("multi-encoder models are not ported yet")
    conv_backend = str(model_cfg.get("conv_backend", "xla"))
    if conv_backend not in _BACKENDS:
        raise ValueError(f"model.conv_backend must be one of {_BACKENDS}, "
                         f"got {conv_backend!r}")

    # audio/frontend parameters reach every model build (the hybrids size
    # their in-model featurizers from them); model-level keys win
    for k in ("audio_spec", "sample_rate", "n_fft", "win_length",
              "hop_length", "fmin", "fmax", "n_mfcc"):
        if k in hparams and k not in model_cfg:
            model_cfg[k] = hparams[k]
    backbone = build_model(name, nOut=n_out, feature_type=feature_type,
                           n_mels=int(hparams.get("n_mels", 80)), **model_cfg)

    compute_dtype = compute_dtype_from_hparams(hparams)
    fe_backend = str(hparams.get("frontend_backend", "auto"))
    if fe_backend not in _BACKENDS:
        raise ValueError(f"frontend_backend must be one of {_BACKENDS}, "
                         f"got {fe_backend!r}")
    if hasattr(backbone, "frontend") and hasattr(backbone, "frontend_backend"):
        # backbones that featurize in-model take the dtype and backend
        backbone.compute_dtype = compute_dtype
        backbone.frontend_backend = fe_backend

    return SpeakerEncoder(backbone=backbone, feature_type=feature_type,
                          frontend=frontend_from_hparams(hparams, feature_type),
                          frontend_backend=fe_backend,
                          compute_dtype=compute_dtype)
