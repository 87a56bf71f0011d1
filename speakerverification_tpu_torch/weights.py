"""Weights for the port's modules.

:func:`params_from_jax` turns the JAX package's flax variables (as numpy
arrays) into a ``state_dict`` of the port. The port's modules carry the
flax scope names, so a key is the flax path joined with dots; only the
leaves change layout:

* conv ``kernel [k, in, out]`` → ``weight [out, in, k]``, and a Conv2d
  ``kernel [kh, kw, in, out]`` → ``weight [out, in, kh, kw]`` (grouped
  and depthwise ones alike: ``in`` is a group's);
* a transposed conv (a ``ConvTranspose_*`` scope) ``kernel [k, in, out]``
  → ``ConvTranspose1d.weight [in, out, k]`` with the tap axis flipped:
  flax's ``nn.ConvTranspose`` does not flip its kernel, torch's does;
* Dense ``kernel [in, out]`` → Linear ``weight [out, in]``;
* BatchNorm ``scale``/``bias`` and ``batch_stats`` ``mean``/``var`` →
  ``weight``/``bias``/``running_mean``/``running_var``; a LayerNorm
  (a ``LayerNorm_*`` scope, no statistics) ``scale``/``bias`` →
  ``weight``/``bias``;
* ``input_norm_*``, ``inorm_*``, ``low_hz``/``band_hz``, AFMS
  ``alpha``, ``sap_v``, the relative attention's ``u_bias``/
  ``v_bias`` and TDFbanks' ``gabor_kernel`` keep their names and
  layouts, and so do, only
  under the scopes that own them, a ``SampleLayerNorm_*``'s
  ``gamma``/``beta``, the metric heads' 0-d ``w``/``b`` and the margin
  heads' ``W``/``weight`` and proxy heads' ``proxies`` (under ``loss``,
  or a head of it: ``loss/AAmSoftmax_0/weight``, ``loss/MMP_0/proxies``)
  and the attention poolings' ``v``/``u`` and the graph attention's
  ``a_src``/``a_dst`` (``models/pooling_extra.py``);
* a GRU cell's six Dense products (``GRUCell_0/ir``, ..., ``hn``) are
  Linears of the same names.

:func:`params_to_jax` is its inverse: a ``state_dict`` back to flax
``params``/``batch_stats`` numpy trees, which ``checkpoint.py`` writes
in the JAX package's msgpack layout. The round trip through both gives
the ``state_dict`` back bit for bit. :func:`flax_axes` is the axis
permutation of one parameter under these rules, and :func:`flax_path`
its flax path (for optimizers whose arithmetic depends on the layout,
and the optimizer states that are keyed by parameter but shaped
otherwise).

:func:`init_weights_` gives a module random weights from a seeded
generator, drawn from the distributions flax initializes with (the
draws differ), for a model trained from scratch or served without a
weights file. :func:`cast_copy` makes the low-precision copy
an embed function runs, and :func:`act_scales_from_jax` carries the JAX
package's int8 activation scales over.
"""

from __future__ import annotations

from typing import Mapping, Optional

import copy
import re

import numpy as np
import torch
import torch.nn as nn

__all__ = ["params_from_jax", "params_to_jax", "init_weights_", "cast_copy",
           "act_scales_from_jax", "flax_axes", "flax_path"]

_SAME_NAME = {"alpha", "low_hz", "band_hz", "inorm_scale", "inorm_bias",
              "input_norm_scale", "input_norm_bias", "W", "sap_v", "u_bias",
              "v_bias", "gabor_kernel"}
# flax's LayerNorm scopes: ``scale``/``bias`` and no statistics
_LAYER_NORM = re.compile(r"^(.*\.)?LayerNorm_\d+$")
# flax's transposed convs: an unflipped ``kernel [k, in, out]``
_CONV_T = re.compile(r"^(.*\.)?ConvTranspose_\d+$")
# the margin heads' own matrices (AmSoftmax/ARmSoftmax/AngularPenaltySM
# ``W [nOut, nClasses]``, AAmSoftmax ``weight [nClasses, nOut]``) at the
# encoder's ``loss`` scope or one margin head below it (the summed
# heads'), and the proxy heads' ``proxies [nClasses, nOut]`` at ``loss``
# or MMP_Balance_MTL's ``MMP_0``: stored as they are, not as a Dense
# kernel (a plain Softmax's ``Dense_0`` is one)
_HEAD_LEAF = re.compile(
    r"^loss(\.(AmSoftmax|AAmSoftmax|ARmSoftmax)_\d+)?\.(W|weight)$"
    r"|^loss(\.MMP_\d+)?\.proxies$")
# common names kept as they are only under the scopes that own them: the
# sample LayerNorm's ``gamma``/``beta`` (at the root: a LayerNorm's own
# tree), and the metric heads' 0-d ``w``/``b`` at ``loss`` or one head
# below it (AAmSoftmaxAP's ``AngularProto_0``, GE2ELoss_fusion's
# ``GE2ELossV2_*``, MMP_Balance_MTL's ``MMP_0``)
_OWNED_LEAF = re.compile(
    r"^((.*\.)?SampleLayerNorm_\d+\.)?(gamma|beta)$"
    r"|^loss(\.(AngularProto|GE2ELossV2|MMP)_\d+)?\.(w|b)$"
    r"|^((.*\.)?(AttentionPooling|MultiHeadAttentionPooling|DoubleMHA)"
    r"_\d+\.)?(v|u)$"
    r"|^((.*\.)?GraphAttentionLayer_\d+\.)?(a_src|a_dst)$")
_STATS = {"mean": "running_mean", "var": "running_var"}


def _as_numpy(v) -> np.ndarray:
    """A leaf as numpy; a bf16 tensor (how ``checkpoint.py`` decodes a
    bfloat16 leaf) widens to fp32 exactly."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return np.asarray(v)


def _flatten(tree: Mapping, prefix: tuple = ()) -> dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = _as_numpy(v)
    return out


def params_from_jax(params: Mapping, batch_stats: Optional[Mapping] = None,
                    *, like: Optional[nn.Module | Mapping] = None,
                    ) -> dict[str, torch.Tensor]:
    """Convert flax ``params``/``batch_stats`` trees to a ``state_dict``.

    Raises ``KeyError`` on a leaf it cannot place and on a BatchNorm
    whose parameters or statistics are missing. With ``like`` (a module
    or a ``state_dict``), also raises when a key is missing, left over
    or of another shape."""
    state: dict[str, torch.Tensor] = {}
    bn_scopes = set()
    for path, arr in _flatten(params).items():
        scope, name = ".".join(path[:-1]), path[-1]
        key = f"{scope}.{{}}" if scope else "{}"
        if name == "kernel" and arr.ndim == 3 and _CONV_T.match(scope):
            state[key.format("weight")] = arr[::-1].transpose(1, 2, 0)
        elif name == "kernel" and arr.ndim == 4:
            state[key.format("weight")] = arr.transpose(3, 2, 0, 1)
        elif name == "kernel" and arr.ndim == 3:
            state[key.format("weight")] = arr.transpose(2, 1, 0)
        elif name == "kernel" and arr.ndim == 2:
            state[key.format("weight")] = arr.T
        elif name == "bias":
            state[key.format("bias")] = arr
        elif name == "scale" and _LAYER_NORM.match(scope):
            state[key.format("weight")] = arr
        elif name == "scale":
            state[key.format("weight")] = arr
            bn_scopes.add(scope)
        elif (name in _SAME_NAME or _HEAD_LEAF.match(".".join(path))
              or _OWNED_LEAF.match(".".join(path))):
            state[key.format(name)] = arr
        else:
            raise KeyError(f"flax leaf {'/'.join(path)} has no port "
                           "counterpart")
    stat_scopes = set()
    for path, arr in _flatten(batch_stats or {}).items():
        scope, name = ".".join(path[:-1]), path[-1]
        if name not in _STATS:
            raise KeyError(f"batch_stats leaf {'/'.join(path)} has no port "
                           "counterpart")
        state[f"{scope}.{_STATS[name]}"] = arr
        stat_scopes.add(scope)
    for scope in bn_scopes | stat_scopes:
        for k in ("weight", "bias", "running_mean", "running_var"):
            if f"{scope}.{k}" not in state:
                raise KeyError(f"BatchNorm {scope.replace('.', '/')} lacks "
                               f"its {k}")
        state[f"{scope}.num_batches_tracked"] = torch.tensor(0)
    # (reshaped: ascontiguousarray makes a 0-d leaf 1-d)
    out = {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32)
                               .reshape(v.shape))
           if isinstance(v, np.ndarray) else v for k, v in state.items()}

    if like is not None:
        ref = like.state_dict() if isinstance(like, nn.Module) else like
        missing = sorted(set(ref) - set(out))
        extra = sorted(set(out) - set(ref))
        shapes = sorted(k for k in set(ref) & set(out)
                        if tuple(ref[k].shape) != tuple(out[k].shape))
        if missing or extra or shapes:
            raise KeyError(f"state_dict mismatch: missing {missing}, "
                           f"left over {extra}, shape differs {shapes}")
    return out


# torch → flax axes of a conv or Dense ``weight``, by rank
_KERNEL_AXES = {4: (2, 3, 1, 0), 3: (2, 1, 0), 2: (1, 0)}


def flax_axes(key: str, ndim: int) -> tuple:
    """The permutation ``perm`` with ``flax_leaf = port_leaf.permute(perm)``
    for the parameter ``key`` (a ``state_dict`` key) of rank ``ndim``:
    a conv or Dense ``weight`` is transposed, every other leaf (the
    heads' ``W``/``weight``/``proxies``, biases, norms) keeps its axes.
    A transposed conv's taps are also reversed, which no permutation
    says; the optimizers that read these axes treat the taps of an axis
    alike."""
    scope, _, name = key.rpartition(".")
    if name == "weight" and ndim == 3 and _CONV_T.match(scope):
        return (2, 0, 1)
    if name == "weight" and ndim >= 2 and not _HEAD_LEAF.match(key):
        return _KERNEL_AXES[ndim]
    return tuple(range(ndim))


def flax_path(key: str, ndim: int) -> tuple:
    """The flax ``params`` path of the trainable parameter ``key``: a
    conv or Dense ``weight`` is a ``kernel``, a 1-D ``weight`` (a
    BatchNorm's or LayerNorm's) a ``scale``."""
    scope, _, name = key.rpartition(".")
    if name == "weight" and not _HEAD_LEAF.match(key):
        name = "kernel" if ndim >= 2 else "scale"
    return tuple(scope.split(".")) + (name,) if scope else (name,)


def _nest(tree: dict, key: str, value: np.ndarray) -> None:
    *scopes, name = key.split(".")
    for s in scopes:
        tree = tree.setdefault(s, {})
    tree[name] = value


def params_to_jax(state: Mapping[str, torch.Tensor]) -> tuple[dict, dict]:
    """A port ``state_dict`` as flax ``(params, batch_stats)`` numpy
    trees, the inverse of :func:`params_from_jax`: a BatchNorm (a scope
    with ``running_mean``) gives ``scale``/``bias`` and ``mean``/``var``,
    a LayerNorm's (``LayerNorm_*``) ``weight`` its ``scale``, a 4-D
    ``weight`` a Conv2d ``kernel [kh, kw, in, out]``, a 3-D one a conv
    ``kernel [k, in, out]``, a 2-D one a Dense ``kernel [in, out]``;
    ``num_batches_tracked`` has no flax leaf."""
    params: dict = {}
    stats: dict = {}
    for key, t in state.items():
        scope, _, name = key.rpartition(".")
        arr = t.detach().cpu().numpy()
        bn = f"{scope}.running_mean" in state
        if name == "num_batches_tracked":
            continue
        if _HEAD_LEAF.match(key):
            _nest(params, key, arr.copy())
        elif bn and name in ("running_mean", "running_var"):
            _nest(stats, f"{scope}.{name[len('running_'):]}", arr.copy())
        elif name == "weight" and (bn or _LAYER_NORM.match(scope)):
            _nest(params, f"{scope}.scale", arr.copy())
        elif name == "weight" and arr.ndim == 3 and _CONV_T.match(scope):
            _nest(params, f"{scope}.kernel", np.ascontiguousarray(
                arr.transpose(2, 0, 1)[::-1]))
        elif name == "weight" and arr.ndim in _KERNEL_AXES:
            _nest(params, f"{scope}.kernel", np.ascontiguousarray(
                arr.transpose(_KERNEL_AXES[arr.ndim])))
        elif name == "bias" or name in _SAME_NAME or _OWNED_LEAF.match(key):
            _nest(params, key, arr.copy())
        else:
            raise KeyError(f"state_dict entry {key} has no flax counterpart")
    return params, stats


def _truncated_normal_(w: torch.Tensor, std: float,
                       generator: torch.Generator) -> None:
    """flax's truncated normal: a standard normal cut at ±2, scaled so
    that the variance is ``std²`` (1/.8796… undoes the cut's shrink)."""
    t = torch.empty(w.shape)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    w.copy_((t * (std / .87962566103423978)).to(w.device, w.dtype))


@torch.no_grad()
def init_weights_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw ``module``'s weights from ``generator`` (a CPU generator) as
    flax initializes the JAX modules: conv (1-D, depthwise, 2-D,
    transposed) and Dense kernels ``lecun_normal`` (a truncated normal of
    variance 1/fan_in, fan_in the taps times the in-channels of one
    group),
    biases zero, BatchNorm scale 1 and bias 0 with running mean 0 and
    variance 1, LayerNorm scale 1 and bias 0, the loss heads' matrices
    (``xavier_normal_params``) ``xavier_normal``, the relative
    attention's ``u_bias``/``v_bias`` (``xavier_uniform_params``)
    ``xavier_uniform``, ``lecun_normal_params`` (a ``[fan_in, fan_out]``
    matrix) ``lecun_normal``, ``normal_std_params`` (name → std) a
    normal of that std, a GRU's recurrent kernels (``orthogonal_params``)
    ``orthogonal`` and ``normal_params`` a standard normal; the sinc,
    AFMS, norm and metric-head parameters keep their constructed values,
    which are flax's."""
    for m in module.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d,
                          nn.Linear)):
            # a transposed conv's weight is [in, out, k]: flax's fan-in
            # is k·in
            fan_in = (m.weight.shape[0] * m.weight.shape[2]
                      if isinstance(m, nn.ConvTranspose1d)
                      else m.weight[0].numel())
            _truncated_normal_(m.weight, fan_in ** -0.5, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm1d):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        for name in getattr(m, "xavier_normal_params", ()):
            w = getattr(m, name)
            std = (2.0 / (w.shape[0] + w.shape[1])) ** 0.5
            w.copy_((torch.randn(w.shape, generator=generator) * std)
                    .to(w.device, w.dtype))
        for name in getattr(m, "lecun_normal_params", ()):
            # a [fan_in, fan_out] matrix
            _truncated_normal_(getattr(m, name), m.get_parameter(name)
                               .shape[0] ** -0.5, generator)
        for name, std in getattr(m, "normal_std_params", {}).items():
            w = getattr(m, name)
            w.copy_((torch.randn(w.shape, generator=generator) * std)
                    .to(w.device, w.dtype))
        for name in getattr(m, "xavier_uniform_params", ()):
            # flax: fan_in the leading axis, fan_out the last
            w = getattr(m, name)
            limit = (6.0 / (w.shape[0] + w.shape[1])) ** 0.5
            w.copy_(((torch.rand(w.shape, generator=generator) * 2 - 1)
                     * limit).to(w.device, w.dtype))
    # after the loop above, which draws the Linears these name
    for m in module.modules():
        for name in getattr(m, "orthogonal_params", ()):
            w = m.get_parameter(name)
            t = torch.empty(w.shape)
            nn.init.orthogonal_(t, generator=generator)
            w.copy_(t.to(w.device, w.dtype))
        for name in getattr(m, "normal_params", ()):
            w = m.get_parameter(name)
            w.copy_(torch.randn(w.shape, generator=generator)
                    .to(w.device, w.dtype))
    return module


def cast_copy(module: nn.Module, dtype: Optional[torch.dtype]) -> nn.Module:
    """A deep copy of ``module`` whose floating parameters (not the
    BatchNorm statistics, which are buffers) are cast to ``dtype``;
    ``None`` keeps their dtype."""
    module = copy.deepcopy(module)
    if dtype is not None:
        for p in module.parameters():
            if p.is_floating_point():
                p.data = p.data.to(dtype)
    return module


# ECAPA's attentive pooling with global context calls its attention conv
# once on zeros only to bind the weights it then reads directly
# (speakerverification_tpu/models/layers.py), so JAX calibration records
# a max of 0.0 under this key; the port never calls that conv
_DEAD_ASP_KEY = "AttentiveStatisticsPooling_0/TDNNBlock_0/Conv1d_0/Conv_0"


def act_scales_from_jax(scales: Mapping[str, float], model: nn.Module,
                        config=None) -> dict[str, float]:
    """The JAX package's ``calibrate_act_scales`` result as the port's.

    Keys stay the flax paths. The dead attention-conv key (value 0.0) is
    dropped; any other key must name a module of ``model`` that
    ``config`` (default ``QuantConfig()``) quantizes, or ``KeyError``."""
    from speakerverification_tpu_torch.quant import QuantConfig, quantizable
    cfg = config or QuantConfig()
    known = {n.replace(".", "/") for n, m in model.named_modules()
             if quantizable(m, cfg)}
    out = {}
    for key, value in scales.items():
        if key.endswith(_DEAD_ASP_KEY) and float(value) == 0.0:
            continue
        if key not in known:
            raise KeyError(f"int8 scale {key!r} names no quantizable module "
                           "of the port")
        out[key] = float(value)
    return out
