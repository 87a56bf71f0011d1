"""Build the port's objects from the YAML schema (port of ``builder.py``).

Frontend config, compute dtype, the ``SpeakerEncoder`` for a registered
model (every name of the JAX package's registry: ``ECAPA_TDNN``, the
hybrids, the RawNet2 and RawNet3 families, the Conformer family, the
ResNetSE, SE-ResNet and TitaNet families, the mel-image encoders and
RawNeXt/ResNeXt), or for a list of them (``models/mixed.py``), with its
loss head (``criterion``), the optimizer (``optimizer``) and the learning-rate
schedule (``callbacks``). ``frontend_backend`` and
``model.conv_backend`` take ``'auto' | 'xla' | 'pallas'``: ``'pallas'``
selects the port's hand-written kernel, ``'xla'`` the plain PyTorch
path, ``'auto'`` the kernel on CUDA. SpecAugment (``ops/specaugment.py``)
joins the training forward when ``augment`` is on and ``augment_options.
augment_chain`` has ``spec_domain``. Under ``distributed`` with more
than one process (``num_devices``), the encoder gathers the embeddings
over the ``data`` axis before the head (``gather_metric_embeddings``,
on by default); with ``model_parallel > 1`` the head ``AAmSoftmax``
becomes its class-sharded twin ``ShardedAAmSoftmax``.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch

from speakerverification_tpu_torch.encoder import SpeakerEncoder
from speakerverification_tpu_torch.losses import build_loss
from speakerverification_tpu_torch.ops.frontend import FrontendConfig
from speakerverification_tpu_torch.ops.specaugment import SpecAugmentConfig
from speakerverification_tpu_torch.registry import MODELS

__all__ = ["compute_dtype_from_hparams", "frontend_from_hparams",
           "encoder_from_hparams", "build_model", "fill_registry",
           "eval_normalize_from_hparams",
           "optimizer_from_hparams", "scheduler_from_hparams"]

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


def fill_registry() -> None:
    """Import every model module, which registers its builders."""
    from speakerverification_tpu_torch.models import (  # noqa: F401
        conformer,
        ecapa_tdnn,
        hybrids,
        hybrids2,
        image_encoders,
        next as next_family,
        rawnet2,
        rawnet2_custom,
        rawnet3,
        resnetse,
        senet,
        titanet,
    )


def build_model(name: str, **kwargs):
    fill_registry()
    return MODELS.get(name)(**kwargs)


def encoder_from_hparams(hparams: Mapping,
                         with_loss: bool = False,
                         num_devices: Optional[int] = None) -> SpeakerEncoder:
    """Build the ``SpeakerEncoder`` from a config; ``with_loss`` adds the
    loss head that ``criterion`` names (default ``AAmSoftmax``) over
    ``nClasses``. The inference engine and the server build without
    one: the embedding path does not run it. ``num_devices``: the ranks
    the train step runs over (default: the process group's size), which
    gates the gather of the embeddings."""
    model_cfg = dict(hparams.get("model", {}))
    name = model_cfg.pop("name", "ECAPA_TDNN")
    n_out = int(model_cfg.pop("nOut", 192))
    feature_type = model_cfg.pop("feature_type",
                                 hparams.get("features", "melspectrogram"))
    if feature_type == "raw" and name == "ECAPA_TDNN":
        # ECAPA always consumes mel features
        feature_type = "melspectrogram"
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
    if isinstance(name, (list, tuple)):
        # a list-valued name: the branches side by side on the wave, each
        # featurized in-model from this config's frontend
        from speakerverification_tpu_torch.models.mixed import (
            build_mixed_model,
        )
        backbone = build_mixed_model(
            name, nOut=n_out, feature_type=feature_type,
            frontend=frontend_from_hparams(hparams, feature_type),
            n_mels=int(hparams.get("n_mels", 80)), **model_cfg)
        feature_type = "raw"
    else:
        backbone = build_model(name, nOut=n_out, feature_type=feature_type,
                               n_mels=int(hparams.get("n_mels", 80)),
                               **model_cfg)

    compute_dtype = compute_dtype_from_hparams(hparams)
    fe_backend = str(hparams.get("frontend_backend", "auto"))
    if fe_backend not in _BACKENDS:
        raise ValueError(f"frontend_backend must be one of {_BACKENDS}, "
                         f"got {fe_backend!r}")
    spec_aug = None
    aug_opts = hparams.get("augment_options", {}) or {}
    if hparams.get("augment") and "spec_domain" in (
            aug_opts.get("augment_chain", []) or []):
        spec_aug = SpecAugmentConfig()
    # backbones that featurize in-model take the dtype, the backend and
    # SpecAugment, and so do the hybrids nested in a MixedModel
    for m in [backbone, *getattr(backbone, "branches", ())]:
        if hasattr(m, "frontend") and hasattr(m, "frontend_backend"):
            m.compute_dtype = compute_dtype
            m.frontend_backend = fe_backend
            m.spec_augment = spec_aug

    loss = None
    if with_loss:
        crit = dict(hparams.get("criterion", {}))
        crit_name = crit.pop("name", "AAmSoftmax")
        if int(hparams.get("model_parallel", 1) or 1) > 1:
            # the class-sharded head over the model axis (parallel/tp.py):
            # the plain margin head maps onto its sharded twin, other
            # heads must opt in
            if crit_name == "AAmSoftmax":
                crit_name = "ShardedAAmSoftmax"
            elif crit_name != "ShardedAAmSoftmax":
                raise ValueError(
                    f"model_parallel > 1 requires a class-sharded loss "
                    f"head (ShardedAAmSoftmax), got {crit_name}")
        loss = build_loss(crit_name, nOut=n_out,
                          nClasses=int(hparams.get("nClasses", 2)), **crit)

    if num_devices is None:
        from speakerverification_tpu_torch.parallel.mesh import world_size
        num_devices = world_size()
    gather_axis = None
    if hparams.get("distributed") and num_devices > 1 and hparams.get(
            "gather_metric_embeddings", True):
        gather_axis = "data"

    return SpeakerEncoder(backbone=backbone, loss=loss,
                          feature_type=feature_type,
                          frontend=frontend_from_hparams(hparams, feature_type),
                          frontend_backend=fe_backend,
                          compute_dtype=compute_dtype,
                          spec_augment=spec_aug, gather_axis=gather_axis)


def optimizer_from_hparams(hparams: Mapping):
    """The ``optimizer`` section's optimizer (default ``adam``) at ``lr``."""
    from speakerverification_tpu_torch.optim import build_optimizer
    opt = dict(hparams.get("optimizer", {}))
    name = opt.pop("name", "adam")
    return build_optimizer(name,
                           learning_rate=float(hparams.get("lr", 1e-3)),
                           weight_decay=float(opt.pop("weight_decay", 0.0)),
                           **opt)


def scheduler_from_hparams(hparams: Mapping, steps_per_epoch: int):
    """``(schedule, unit)`` of the ``callbacks`` section (default
    ``steplr``); ``T_max`` defaults to the steps per epoch.
    ``reduceOnPlateau`` gives a :class:`ReduceOnPlateau` and ``'plateau'``."""
    from speakerverification_tpu_torch.optim import (
        ReduceOnPlateau,
        build_scheduler,
    )
    cb = dict(hparams.get("callbacks", {}) or {})
    name = cb.pop("name", "steplr")
    opt = hparams.get("optimizer", {}) or {}
    if name == "reduceOnPlateau":
        pl = ReduceOnPlateau(lr=float(hparams.get("lr", 1e-3)),
                             patience=int(cb.get("step_size", 5)),
                             min_lr=float(cb.get("base_lr", 1e-6)),
                             factor=0.95)
        return pl, "plateau"
    kwargs = dict(
        T_max=int(hparams.get("T_max", steps_per_epoch) or steps_per_epoch),
        lr_decay=float(opt.get("lr_decay", 0.95)),
        step_size=int(cb.get("step_size", hparams.get("step_size", 10) or 10)),
        eta_min=float(cb.get("base_lr", hparams.get("base_lr", 1e-6) or 1e-6)),
        base_lr=float(cb.get("base_lr", hparams.get("base_lr", 1e-8) or 1e-8)),
        max_lr=float(cb.get("max_lr", hparams.get("max_lr",
                                                  hparams.get("lr", 1e-3)))),
    )
    return build_scheduler(name, lr=float(hparams.get("lr", 1e-3)), **kwargs)
