"""Two-branch hybrid encoders (port of ``models/hybrids.py``): a raw-wave
branch ∥ ECAPA-192 on in-model mel features, embeddings concatenated
``[ecapa, raw]``. ``Raw3_ECAPA`` (RawNet3), the ``Raw_ECAPA`` family
(RawNet2Custom: ``Raw_ECAPA``, ``Raw_ECAPA_sinc_asp``,
``Raw_ECAPA_conv_asp``, ``Raw_ECAPA_sinc_gru``) and ``Raw_ECAPA_hype``
(a channel-attention head over the concatenation).

The hybrid's ECAPA branch consumes linear-power mel (``log_input`` off,
instance norm on). In training, with ``spec_augment`` set (the builder
sets it when ``augment_chain`` has ``spec_domain``), the mel features go
through SpecAugment before the cast, drawn from the generator that
``forward`` is given. Its Res2Net cascade runs as plain convs, as in the
JAX hybrid, which does not thread ``conv_backend`` into that branch;
``Raw3_ECAPA`` alone takes ``model.conv_backend`` for it (default
``'xla'``, JAX's behaviour), so that its eval forward, and the program
``export.py`` writes, can run the cascade kernel K2. The
yaml key ``model.remat`` reaches the ECAPA branch, which then recomputes
its SE-Res2Net blocks in the backward pass.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from speakerverification_tpu_torch.models.ecapa_tdnn import ECAPA_TDNN
from speakerverification_tpu_torch.models.layers import (
    batch_norm,
    bn_module,
    promoted,
)
from speakerverification_tpu_torch.models.rawnet2 import crop_samples
from speakerverification_tpu_torch.models.rawnet2_custom import RawNet2Custom
from speakerverification_tpu_torch.models.rawnet_blocks import leaky_relu_03
from speakerverification_tpu_torch.models.rawnet3 import RawNet3
from speakerverification_tpu_torch.ops.frontend import (
    FrontendConfig,
    select_mel_frontend,
)
from speakerverification_tpu_torch.ops.specaugment import (
    SpecAugmentConfig,
    spec_augment,
)
from speakerverification_tpu_torch.registry import MODELS

__all__ = ["RawECAPAHybrid", "RawECAPAHype", "hybrid_featurize",
           "hybrid_cast", "build_raw3_ecapa"]


def hybrid_featurize(x: torch.Tensor, kind: str, frontend: FrontendConfig,
                     compute_dtype: Optional[torch.dtype],
                     backend: str = "auto",
                     spec_cfg: Optional[SpecAugmentConfig] = None,
                     rng=None, train: bool = False) -> torch.Tensor:
    """In-model featurization: the frontend pinned to fp32 (the mel
    kernel where ``backend`` selects it), SpecAugment in training when
    ``spec_cfg`` is set (its numbers from ``rng``, a ``torch.Generator``
    or a ``SpecAugmentDraw``), features cast to the compute dtype."""
    f = select_mel_frontend(frontend, kind, backend, x)(x.float())
    if train and spec_cfg is not None:
        f = spec_augment(f, spec_cfg, rng)
    return f if compute_dtype is None else f.to(compute_dtype)


def hybrid_cast(x: torch.Tensor, compute_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """Cast the raw-wave branch input to the compute dtype."""
    return x if compute_dtype is None else x.to(compute_dtype)


class RawECAPAHybrid(nn.Module):
    def __init__(self, raw_branch: nn.Module, ecapa: nn.Module,
                 frontend: FrontendConfig = FrontendConfig(),
                 compute_dtype: Optional[torch.dtype] = None,
                 frontend_backend: str = "auto",
                 spec_augment: Optional[SpecAugmentConfig] = None):
        super().__init__()
        self.raw_branch = raw_branch
        self.ecapa = ecapa
        self.frontend = frontend
        self.compute_dtype = compute_dtype
        self.frontend_backend = frontend_backend
        self.spec_augment = spec_augment

    def forward(self, x: torch.Tensor, rng=None) -> torch.Tensor:
        """``x``: raw waveform ``[B, T]`` → ``[B, 192 + raw nOut]``;
        ``rng`` feeds SpecAugment in training."""
        mel = hybrid_featurize(x, "melspectrogram", self.frontend,
                               self.compute_dtype, self.frontend_backend,
                               self.spec_augment, rng, self.training)
        out1 = self.ecapa(mel)
        out2 = self.raw_branch(hybrid_cast(x, self.compute_dtype))
        return torch.cat([out1, out2], dim=-1)


def _hybrid_ecapa(n_mels: int, input_norm: bool, remat: bool = False,
                  conv_backend: str = "xla") -> ECAPA_TDNN:
    return ECAPA_TDNN(n_mels=n_mels, lin_neurons=192,
                      channels=(512, 512, 512, 512, 1536),
                      conv_backend=conv_backend,
                      feature_type="melspectrogram",
                      log_input=False, input_norm=input_norm, remat=remat)


@MODELS.register("Raw3_ECAPA")
def build_raw3_ecapa(nOut: int = 512, **kwargs) -> RawECAPAHybrid:
    """The default model: RawNet3(nOut−192, C) ∥ ECAPA-192. The in-model
    frontend is always ``melspectrogram``."""
    cfg = FrontendConfig.from_hparams(dict(kwargs), "melspectrogram")
    raw = RawNet3(nOut=nOut - 192, C=int(kwargs.get("C", 1024)),
                  model_scale=8, sinc_stride=10, sample_rate=cfg.sample_rate)
    return RawECAPAHybrid(raw_branch=raw,
                          ecapa=_hybrid_ecapa(
                              cfg.n_mels, input_norm=True,
                              remat=bool(kwargs.get("remat")),
                              conv_backend=str(kwargs.get("conv_backend",
                                                          "xla"))),
                          frontend=cfg)


def _rawnet2_hybrid(nOut: int, front: str, agg: str, kwargs,
                    input_norm: bool) -> RawECAPAHybrid:
    cfg = FrontendConfig.from_hparams(dict(kwargs), "melspectrogram")
    raw = RawNet2Custom(nOut=nOut - 192, front_proc=front, aggregate=agg,
                        att_dim=128, sample_rate=cfg.sample_rate,
                        n_samples=crop_samples(kwargs))
    return RawECAPAHybrid(raw_branch=raw,
                          ecapa=_hybrid_ecapa(cfg.n_mels, input_norm,
                                              bool(kwargs.get("remat"))),
                          frontend=cfg)


@MODELS.register("Raw_ECAPA")
def build_raw_ecapa(nOut: int = 512, **kwargs) -> RawECAPAHybrid:
    """Sinc front, ASP aggregation, the ECAPA branch with instance norm."""
    return _rawnet2_hybrid(nOut, "sinc", "asp", kwargs, input_norm=True)


@MODELS.register("Raw_ECAPA_sinc_asp")
def build_raw_ecapa_sinc_asp(nOut: int = 512, **kwargs) -> RawECAPAHybrid:
    """``Raw_ECAPA`` with the ECAPA branch's instance norm off."""
    return _rawnet2_hybrid(nOut, "sinc", "asp", kwargs, input_norm=False)


@MODELS.register("Raw_ECAPA_conv_asp")
def build_raw_ecapa_conv_asp(nOut: int = 512, **kwargs) -> RawECAPAHybrid:
    """Strided-conv front, ASP aggregation, instance norm on."""
    return _rawnet2_hybrid(nOut, "conv", "asp", kwargs, input_norm=True)


@MODELS.register("Raw_ECAPA_sinc_gru")
def build_raw_ecapa_sinc_gru(nOut: int = 512, **kwargs) -> RawECAPAHybrid:
    """Sinc front, GRU aggregation, instance norm off."""
    return _rawnet2_hybrid(nOut, "sinc", "gru", kwargs, input_norm=False)


class RawECAPAHype(nn.Module):
    """ECAPA-192 ∥ a raw branch, then a channel-attention head over the
    concatenation: BN → lrelu(0.3) → softmax over channels of a SiLU
    bottleneck's output → the weighted value and its std (a single time
    step) → BN → linear."""

    def __init__(self, raw_branch: nn.Module, ecapa: nn.Module,
                 raw_out: int, nOut: int = 512, att_size: int = 128,
                 frontend: FrontendConfig = FrontendConfig(),
                 compute_dtype: Optional[torch.dtype] = None,
                 frontend_backend: str = "auto",
                 spec_augment: Optional[SpecAugmentConfig] = None):
        super().__init__()
        self.raw_branch = raw_branch
        self.ecapa = ecapa
        self.frontend = frontend
        self.compute_dtype = compute_dtype
        self.frontend_backend = frontend_backend
        self.spec_augment = spec_augment
        width = 192 + raw_out
        self.BatchNorm_0 = bn_module(width)
        self.Dense_0 = nn.Linear(width, att_size)
        self.BatchNorm_1 = bn_module(att_size)
        self.Dense_1 = nn.Linear(att_size, width)
        self.BatchNorm_2 = bn_module(2 * width)
        self.Dense_2 = nn.Linear(2 * width, nOut)

    def forward(self, x: torch.Tensor, rng=None) -> torch.Tensor:
        mel = hybrid_featurize(x, "melspectrogram", self.frontend,
                               self.compute_dtype, self.frontend_backend,
                               self.spec_augment, rng, self.training)
        out = torch.cat([self.ecapa(mel),
                         self.raw_branch(hybrid_cast(x, self.compute_dtype))],
                        dim=-1)
        out = leaky_relu_03(batch_norm(self.BatchNorm_0, out))
        h = batch_norm(self.BatchNorm_1, F.silu(promoted(self.Dense_0, out)))
        w = torch.softmax(promoted(self.Dense_1, h), dim=-1)
        m = out * w
        s = torch.sqrt(torch.clamp(out * out * w - m * m, min=1e-9))
        pooled = batch_norm(self.BatchNorm_2, torch.cat([m, s], dim=-1))
        return promoted(self.Dense_2, pooled)


@MODELS.register("Raw_ECAPA_hype")
def build_raw_ecapa_hype(nOut: int = 512, **kwargs) -> RawECAPAHype:
    """ECAPA-192 (instance norm on) ∥ RawNet2Custom(512, sinc, GRU)."""
    cfg = FrontendConfig.from_hparams(dict(kwargs), "melspectrogram")
    raw = RawNet2Custom(nOut=512, front_proc="sinc", aggregate="gru",
                        att_dim=128, sample_rate=cfg.sample_rate,
                        n_samples=crop_samples(kwargs))
    return RawECAPAHype(raw_branch=raw,
                        ecapa=_hybrid_ecapa(cfg.n_mels, input_norm=True,
                                            remat=bool(kwargs.get("remat"))),
                        raw_out=512, nOut=nOut, frontend=cfg)
