"""More hybrid encoders (port of ``models/hybrids2.py``).

* ``Tita_ECAPA``: ECAPA-192 (512 channels, instance norm) ∥ TitaNet-M
  (nOut − 192), both on the in-model mel features, embeddings
  concatenated ``[ecapa, titanet]``.
* ``Raw_tita``: TitaNet-M(192) on the in-model mel features ∥
  RawNet2Custom(nOut − 192, sinc front, ASP) on the wave.
* ``Res_ECAPA``: an SE-ResNet trunk over the feature image (filters 32,
  64; two ``RootSEBasicBlock``s each; a stride-(2, 1) conv at each end,
  which halves the frequency axis), flattened ``[B, C·F/4, T]`` into an
  ECAPA core with ReLU (512…/1536 channels). ``[B, frames, F] -> [B,
  nOut]``.

The two in-model featurizers run the mel kernel on CUDA
(``hybrid_featurize``). No ECAPA here takes ``conv_backend``, as in the
JAX package: their Res2Net cascades run as plain convs.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from speakerverification_tpu_torch.models.ecapa_tdnn import ECAPA_TDNN
from speakerverification_tpu_torch.models.hybrids import (
    _hybrid_ecapa,
    hybrid_cast,
    hybrid_featurize,
)
from speakerverification_tpu_torch.models.layers import (
    batch_norm,
    bn_module,
    feature_dim,
    promoted,
)
from speakerverification_tpu_torch.models.rawnet2 import crop_samples
from speakerverification_tpu_torch.models.rawnet2_custom import RawNet2Custom
from speakerverification_tpu_torch.models.resnetse import (
    SELayer,
    _Shortcut,
    conv3x3,
)
from speakerverification_tpu_torch.models.titanet import (
    SIZES,
    TitaNet,
    find_n_mega_blocks,
)
from speakerverification_tpu_torch.ops.frontend import FrontendConfig
from speakerverification_tpu_torch.ops.specaugment import SpecAugmentConfig
from speakerverification_tpu_torch.registry import MODELS

__all__ = ["TitaECAPA", "RawTita", "RootSEBasicBlock", "ResECAPA"]


class _MelHybrid(nn.Module):
    """A hybrid that featurizes the wave in-model: its frontend config,
    compute dtype, frontend backend and SpecAugment (set by the builder)."""

    def __init__(self, frontend: FrontendConfig,
                 compute_dtype: Optional[torch.dtype] = None,
                 frontend_backend: str = "auto",
                 spec_augment: Optional[SpecAugmentConfig] = None):
        super().__init__()
        self.frontend = frontend
        self.compute_dtype = compute_dtype
        self.frontend_backend = frontend_backend
        self.spec_augment = spec_augment

    def mel(self, x: torch.Tensor, rng) -> torch.Tensor:
        return hybrid_featurize(x, "melspectrogram", self.frontend,
                                self.compute_dtype, self.frontend_backend,
                                self.spec_augment, rng, self.training)


class TitaECAPA(_MelHybrid):
    def __init__(self, ecapa: nn.Module, titanet: TitaNet,
                 frontend: FrontendConfig = FrontendConfig(), **kwargs):
        super().__init__(frontend, **kwargs)
        self.ecapa = ecapa
        self.titanet = titanet

    def forward(self, x: torch.Tensor, rng=None) -> torch.Tensor:
        """``x``: waves ``[B, T]`` → ``[B, 192 + titanet nOut]``; ``rng``
        (a ``torch.Generator``) feeds SpecAugment and TitaNet's dropout
        in training."""
        mel = self.mel(x, rng)
        return torch.cat([self.ecapa(mel), self.titanet(mel, rng)], dim=-1)


class RawTita(_MelHybrid):
    def __init__(self, titanet: TitaNet, raw_branch: nn.Module,
                 frontend: FrontendConfig = FrontendConfig(), **kwargs):
        super().__init__(frontend, **kwargs)
        self.titanet = titanet
        self.raw_branch = raw_branch

    def forward(self, x: torch.Tensor, rng=None) -> torch.Tensor:
        """``x``: waves ``[B, T]`` → ``[B, 192 + raw nOut]``."""
        out1 = self.titanet(self.mel(x, rng), rng)
        out2 = self.raw_branch(hybrid_cast(x, self.compute_dtype))
        return torch.cat([out1, out2], dim=-1)


def _titanet_m(n_mels: int, nOut: int) -> TitaNet:
    hidden, kernel = SIZES["m"]
    return TitaNet(n_mels=n_mels, nOut=nOut, hidden_size=hidden,
                   mega_block_kernel=kernel,
                   n_mega_blocks=find_n_mega_blocks(nOut, n_mels, "m"))


@MODELS.register("Tita_ECAPA")
def build_tita_ecapa(nOut: int = 512, **kwargs) -> TitaECAPA:
    """ECAPA-192 ∥ TitaNet-M(nOut − 192), whose depth is searched at
    that width; the in-model frontend is ``melspectrogram``."""
    cfg = FrontendConfig.from_hparams(dict(kwargs), "melspectrogram")
    return TitaECAPA(ecapa=_hybrid_ecapa(cfg.n_mels, input_norm=True,
                                         remat=bool(kwargs.get("remat"))),
                     titanet=_titanet_m(cfg.n_mels, nOut - 192),
                     frontend=cfg)


@MODELS.register("Raw_tita")
def build_raw_tita(nOut: int = 512, **kwargs) -> RawTita:
    """TitaNet-M(192) ∥ RawNet2Custom(nOut − 192, sinc, ASP), its sample
    LayerNorm sized to the config's crops."""
    cfg = FrontendConfig.from_hparams(dict(kwargs), "melspectrogram")
    raw = RawNet2Custom(nOut=nOut - 192, front_proc="sinc", aggregate="asp",
                        att_dim=128, sample_rate=cfg.sample_rate,
                        n_samples=crop_samples(kwargs))
    return RawTita(titanet=_titanet_m(cfg.n_mels, 192), raw_branch=raw,
                   frontend=cfg)


class RootSEBasicBlock(_Shortcut):
    """Res_ECAPA's trunk block: conv3×3(stride) → ReLU → BN (ReLU before
    the norm) → conv3×3 → BN → SE(16, biased), plus the shortcut, ReLU."""

    def __init__(self, inplanes: int, planes: int, stride=1):
        super().__init__()
        self.Conv_0 = conv3x3(inplanes, planes, stride)
        self.BatchNorm_0 = bn_module(planes)
        self.Conv_1 = conv3x3(planes, planes)
        self.BatchNorm_1 = bn_module(planes)
        self.SELayer_0 = SELayer(planes, internal=16, use_bias=True)
        self._shortcut(2, inplanes, planes, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = batch_norm(self.BatchNorm_0,
                         torch.relu(promoted(self.Conv_0, x)))
        out = batch_norm(self.BatchNorm_1, promoted(self.Conv_1, out))
        out = self.SELayer_0(out)
        return torch.relu(out + self.residual(x))


class ResECAPA(nn.Module):
    def __init__(self, n_mels: int = 80, nOut: int = 128,
                 num_filters: Sequence[int] = (32, 64),
                 num_layers: Sequence[int] = (2, 2),
                 ecapa_channels: Sequence[int] = (512, 512, 512, 512, 1536),
                 feature_type: str = "melspectrogram"):
        super().__init__()
        self.feature_type = feature_type
        self.inorm_scale = nn.Parameter(torch.ones(n_mels))
        self.inorm_bias = nn.Parameter(torch.zeros(n_mels))
        # stride (2, 1) with torch's padding of 1 on both axes
        self.Conv_0 = conv3x3(1, num_filters[0], (2, 1), bias=True)
        self.BatchNorm_0 = bn_module(num_filters[0])
        self.blocks = []
        cin = num_filters[0]
        for planes, n_blocks in zip(num_filters, num_layers):
            for _ in range(n_blocks):
                name = f"RootSEBasicBlock_{len(self.blocks)}"
                self.add_module(name, RootSEBasicBlock(cin, planes))
                self.blocks.append(name)
                cin = planes
        self.Conv_1 = conv3x3(cin, num_filters[-1], (2, 1), bias=True)
        self.BatchNorm_1 = bn_module(num_filters[-1])
        freq = -(-(-(-n_mels // 2)) // 2)
        self.ECAPA_TDNN_0 = ECAPA_TDNN(
            n_mels=num_filters[-1] * freq, lin_neurons=nOut,
            channels=tuple(ecapa_channels), activation=torch.relu,
            log_input=False)

    def forward(self, x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``x``: features ``[B, frames, F]`` → ``[B, nOut]``."""
        if self.feature_type == "melspectrogram":
            x = torch.log(torch.clamp(x, min=0.0) + 1e-6)
            x = x - x.mean(dim=1, keepdim=True)
        mean = x.mean(dim=1, keepdim=True)
        var = x.var(dim=1, unbiased=False, keepdim=True)
        x = (x - mean) / torch.sqrt(var + 1e-5) * self.inorm_scale \
            + self.inorm_bias
        h = promoted(self.Conv_0, x.transpose(1, 2)[:, None])  # [B,C,F,T]
        h = batch_norm(self.BatchNorm_0, torch.relu(h))
        for name in self.blocks:
            h = getattr(self, name)(h)
        h = batch_norm(self.BatchNorm_1, torch.relu(promoted(self.Conv_1, h)))
        B, C, F_, T = h.shape
        # [B, C·F/4, T], F fastest: the core's [B, T, C·F/4] features
        return self.ECAPA_TDNN_0(h.reshape(B, C * F_, T).transpose(1, 2),
                                 lengths)


@MODELS.register("Res_ECAPA")
def build_res_ecapa(nOut: int = 128, **kwargs) -> ResECAPA:
    """Res_ECAPA at the reference's widths; log + CMN for
    ``melspectrogram`` features."""
    feature_type = kwargs.get("feature_type",
                              kwargs.get("features", "melspectrogram"))
    return ResECAPA(n_mels=feature_dim(kwargs), nOut=nOut,
                    feature_type=feature_type)
