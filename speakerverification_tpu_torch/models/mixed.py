"""Multi-encoder composition for a list-valued ``model.name`` (port of
``models/mixed.py``): N registered backbones side by side on one
waveform, their embeddings concatenated ``[B, Σ nOuts]``.

Config keys under ``model:``: ``name`` (the list), ``nOuts`` (per-branch
widths summing to ``nOut``; default an even split, the remainder to the
first), ``feature_types`` (per branch; default ``raw`` for the families
that take the wave, ``_WAVE_INPUT``, else the shared feature type, where
``raw`` means ``melspectrogram``), ``branch_options`` (per-branch keys
over the shared ones).

Each non-raw feature kind is computed once per forward and shared by
the branches that take it (the frontend pinned to fp32, the mel kernel on
CUDA, SpecAugment in training when set, then the compute dtype), each
kind with its own frontend config (an mfcc branch keeps mfcc's band
edges under a mel-keyed config). A hybrid nested as a branch (one with
its own ``frontend``) gets the uncast wave and featurizes itself.
Branches sit under ``branches_0``, ``branches_1``, ..., the flax names.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from speakerverification_tpu_torch.models.hybrids import (
    hybrid_cast,
    hybrid_featurize,
)
from speakerverification_tpu_torch.ops.frontend import FrontendConfig
from speakerverification_tpu_torch.ops.specaugment import SpecAugmentConfig
from speakerverification_tpu_torch.registry import MODELS

__all__ = ["MixedModel", "build_mixed_model"]

# registered names whose modules take the raw waveform [B, T]
_WAVE_INPUT = frozenset({
    "RawNet2", "RawNet_baseline", "RawNet2_custom", "RawNet3", "RawNeXt",
    "Raw3_ECAPA", "Raw_ECAPA", "Raw_ECAPA_conv_asp", "Raw_ECAPA_sinc_asp",
    "Raw_ECAPA_sinc_gru", "Raw_ECAPA_hype", "Raw_tita", "Tita_ECAPA",
})


class MixedModel(nn.Module):
    def __init__(self, branches: Sequence[nn.Module],
                 input_kinds: Sequence[str],
                 frontend: FrontendConfig = FrontendConfig(),
                 frontends: Tuple[Tuple[str, FrontendConfig], ...] = (),
                 spec_augment: Optional[SpecAugmentConfig] = None,
                 compute_dtype: Optional[torch.dtype] = None,
                 frontend_backend: str = "auto"):
        super().__init__()
        if len(branches) != len(input_kinds):
            raise ValueError("one input kind per branch")
        self.n_branches = len(branches)
        for i, b in enumerate(branches):
            self.add_module(f"branches_{i}", b)
        self.input_kinds = tuple(input_kinds)
        self.frontend = frontend
        self.frontends = tuple(frontends)
        self.spec_augment = spec_augment
        self.compute_dtype = compute_dtype
        self.frontend_backend = frontend_backend

    @property
    def branches(self) -> list:
        return [getattr(self, f"branches_{i}")
                for i in range(self.n_branches)]

    def forward(self, x: torch.Tensor, rng=None) -> torch.Tensor:
        """``x``: raw waveform ``[B, T]`` → ``[B, Σ nOuts]``; ``rng`` (a
        ``torch.Generator``) feeds SpecAugment and the branches' dropout
        in training."""
        cfg_by_kind = dict(self.frontends)
        feats = {}
        outs = []
        for mod, kind in zip(self.branches, self.input_kinds):
            if kind == "raw":
                # a nested hybrid featurizes the uncast wave itself
                if hasattr(mod, "frontend"):
                    outs.append(mod(x, rng))
                    continue
                inp = hybrid_cast(x, self.compute_dtype)
            else:
                if kind not in feats:
                    feats[kind] = hybrid_featurize(
                        x, kind, cfg_by_kind.get(kind, self.frontend),
                        self.compute_dtype, self.frontend_backend,
                        self.spec_augment, rng, self.training)
                inp = feats[kind]
            if getattr(mod, "draws_dropout", False):
                outs.append(mod(inp, rng=rng))
            else:
                outs.append(mod(inp))
        return torch.cat(outs, dim=-1)


def build_mixed_model(names: Sequence[str], nOut: int,
                      frontend: Optional[FrontendConfig] = None,
                      **kwargs) -> MixedModel:
    """The branches of ``names`` with their widths, input kinds and
    per-kind frontend configs (see the module)."""
    names = list(names)
    if len(names) < 2:
        raise ValueError(
            f"a list-valued model name needs >= 2 entries, got {names!r}")

    n_outs = kwargs.pop("nOuts", None)
    if n_outs is None:
        base = nOut // len(names)
        n_outs = [base] * len(names)
        n_outs[0] += nOut - base * len(names)
    n_outs = [int(n) for n in n_outs]
    if len(n_outs) != len(names) or sum(n_outs) != int(nOut):
        raise ValueError(
            f"nOuts {n_outs} must have one entry per model name and sum "
            f"to nOut={nOut}")

    shared_ft = kwargs.pop("feature_type",
                           kwargs.pop("features", "melspectrogram"))
    if shared_ft == "raw":
        # 'raw' marks the hybrid wave models, not a feature kind
        shared_ft = "melspectrogram"
    feature_types = kwargs.pop("feature_types", None)
    if feature_types is None:
        feature_types = ["raw" if n in _WAVE_INPUT else shared_ft
                         for n in names]
    feature_types = [str(f) for f in feature_types]
    if len(feature_types) != len(names):
        raise ValueError(
            f"feature_types {feature_types} must have one entry per name")

    branch_options = kwargs.pop("branch_options", None) or [{}] * len(names)
    if len(branch_options) != len(names):
        raise ValueError("branch_options must have one entry per name")

    from speakerverification_tpu_torch.builder import (
        build_model,
        fill_registry,
    )
    fill_registry()
    branches = []
    for name, n_o, ft, opts in zip(names, n_outs, feature_types,
                                   branch_options):
        if name not in MODELS:
            raise KeyError(
                f"unknown model {name!r} in mixed config; registered: "
                f"{MODELS.names()}")
        branches.append(build_model(name, nOut=n_o, feature_type=ft,
                                    **{**kwargs, **dict(opts)}))

    # each non-raw kind gets its own kind's defaults; a caller's
    # ``frontend`` wins for the shared kind
    fe_pairs = []
    for kind in dict.fromkeys(feature_types):       # ordered, unique
        if kind == "raw":
            continue
        if frontend is not None and kind == shared_ft:
            cfg = frontend
        else:
            cfg = FrontendConfig.from_hparams(dict(kwargs), kind)
        fe_pairs.append((kind, cfg))
    if frontend is None:
        frontend = fe_pairs[0][1] if fe_pairs else FrontendConfig()
    return MixedModel(branches, feature_types, frontend=frontend,
                      frontends=tuple(fe_pairs))
