"""Reference torch checkpoints into the port (``compat/torch_port.py``).

The reference ships ``.pt`` state dicts of its torch modules, wrapped as
``module.`` (DDP), ``__S__.`` (backbone) and ``__L__.`` (loss head).
Each porter below maps one family's state-dict layout onto the JAX
package's flax tree, ``(params, batch_stats)`` of numpy arrays, with
layout operations alone (transposes, reshapes, slices; the GRU's r/z
biases are the one sum). The trees are the JAX porters', leaf for leaf,
so a converted checkpoint is an ordinary checkpoint in the JAX layout:
:func:`state_dict_from_reference` carries it on through
``weights.params_from_jax`` into a port model's ``state_dict``, and the
converter CLI (``python -m speakerverification_tpu_torch.compat.torch_port``)
writes it as flax msgpack, which ``--do_infer`` (``initial_model_infer``)
and the trainer's ``load_params_only`` take as they are.

Conventions: torch conv1d weights are ``[out, in, k]`` → flax ``[k, in,
out]``; BN ``weight/bias`` → ``scale/bias`` params and
``running_mean/var`` → ``batch_stats``; the final 1×1 conv fc maps to
``Dense`` with kernel ``weight[:, :, 0].T``.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Mapping, Tuple

import numpy as np

__all__ = ["ecapa_from_torch_state_dict", "rawnet3_from_torch_state_dict",
           "raw3_ecapa_from_torch_state_dict",
           "resnetse_from_torch_state_dict", "se_resnet_from_torch_state_dict",
           "repvgg_from_torch_state_dict", "titanet_from_torch_state_dict",
           "rawnet2_from_torch_state_dict", "scnet_from_torch_state_dict",
           "efficientnet_from_torch_state_dict",
           "rawnext_from_torch_state_dict",
           "conformer_from_torch_state_dict",
           "ecapa_conformer_from_torch_state_dict",
           "rawnet2_custom_from_torch_state_dict",
           "raw_ecapa2_from_torch_state_dict",
           "raw_ecapa_hype_from_torch_state_dict",
           "tita_ecapa_from_torch_state_dict",
           "raw_tita_from_torch_state_dict",
           "res_ecapa_from_torch_state_dict",
           "dpn_from_torch_state_dict",
           "effnetv2_from_torch_state_dict",
           "load_reference_checkpoint", "read_reference_checkpoint",
           "porter_args", "port_reference", "state_dict_from_reference"]


def read_reference_checkpoint(path) -> dict:
    """The state dict of a reference ``.pt`` file (a bare dict or one
    under ``"state_dict"``), tensors read on the CPU."""
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return sd


def load_reference_checkpoint(path, n_blocks: int = 4,
                              res2net_scale: int = 8) -> Tuple[dict, dict]:
    """Load a reference ``.pt`` training checkpoint into ECAPA trees.

    Reference checkpoints store the whole ``SpeakerEncoder`` state dict
    with ``module.`` (DDP) and ``__S__.`` (backbone) / ``__L__.`` (loss)
    prefixes. The backbone entries are extracted and mapped; loss-head
    entries are ignored (the converter CLI ports the margin heads').
    """
    return ecapa_from_torch_state_dict(
        _strip_reference_prefixes(read_reference_checkpoint(path)),
        n_blocks, res2net_scale)


def _set(tree: dict, path: str, value: np.ndarray) -> None:
    keys = path.split("/")
    node = tree
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def _conv(params, stats, torch_prefix, flax_prefix, sd) -> None:
    w = np.asarray(sd[f"{torch_prefix}.weight"])
    _set(params, f"{flax_prefix}/Conv_0/kernel", w.transpose(2, 1, 0))
    if f"{torch_prefix}.bias" in sd:
        _set(params, f"{flax_prefix}/Conv_0/bias",
             np.asarray(sd[f"{torch_prefix}.bias"]))


def _bn(params, stats, torch_prefix, flax_prefix, sd) -> None:
    _set(params, f"{flax_prefix}/BatchNorm_0/scale",
         np.asarray(sd[f"{torch_prefix}.weight"]))
    _set(params, f"{flax_prefix}/BatchNorm_0/bias",
         np.asarray(sd[f"{torch_prefix}.bias"]))
    _set(stats, f"{flax_prefix}/BatchNorm_0/mean",
         np.asarray(sd[f"{torch_prefix}.running_mean"]))
    _set(stats, f"{flax_prefix}/BatchNorm_0/var",
         np.asarray(sd[f"{torch_prefix}.running_var"]))


def _tdnn(params, stats, tp, fp, sd) -> None:
    _conv(params, stats, f"{tp}.conv.conv", f"{fp}/Conv1d_0", sd)
    _bn(params, stats, f"{tp}.norm.norm", f"{fp}/BatchNorm1d_0", sd)


def ecapa_from_torch_state_dict(sd: Mapping, n_blocks: int = 4,
                                res2net_scale: int = 8,
                                ) -> Tuple[dict, dict]:
    """Reference ECAPA state dict → (params, batch_stats) trees.

    ``n_blocks`` = len(channels) - 1 (initial TDNN + SE-Res2 blocks).
    """
    params: dict = {}
    stats: dict = {}

    sd = {k: np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach")
                        else v) for k, v in sd.items()}

    # initial TDNN (blocks.0)
    _tdnn(params, stats, "blocks.0", "TDNNBlock_0", sd)

    # SE-Res2Net blocks (blocks.1..n-1)
    for i in range(1, n_blocks):
        tp = f"blocks.{i}"
        fp = f"SERes2NetBlock_{i - 1}"
        if f"{tp}.shortcut.conv.weight" in sd:
            _conv(params, stats, f"{tp}.shortcut.conv", f"{fp}/Conv1d_0", sd)
        _tdnn(params, stats, f"{tp}.tdnn1", f"{fp}/TDNNBlock_0", sd)
        for j in range(res2net_scale - 1):
            _tdnn(params, stats, f"{tp}.res2net_block.blocks.{j}",
                  f"{fp}/Res2NetBlock_0/TDNNBlock_{j}", sd)
        _tdnn(params, stats, f"{tp}.tdnn2", f"{fp}/TDNNBlock_1", sd)
        _conv(params, stats, f"{tp}.se_block.conv1.conv",
              f"{fp}/SEBlock_0/Conv1d_0", sd)
        _conv(params, stats, f"{tp}.se_block.conv2.conv",
              f"{fp}/SEBlock_0/Conv1d_1", sd)

    # MFA, ASP, asp_bn, fc
    _tdnn(params, stats, "mfa", "TDNNBlock_1", sd)
    _tdnn(params, stats, "asp.tdnn", "AttentiveStatisticsPooling_0/TDNNBlock_0",
          sd)
    _conv(params, stats, "asp.conv.conv",
          "AttentiveStatisticsPooling_0/Conv1d_0", sd)
    _bn(params, stats, "asp_bn.norm", "BatchNorm1d_0", sd)

    fc_w = np.asarray(sd["fc.conv.weight"])            # [out, in, 1]
    _set(params, "Dense_0/kernel", fc_w[:, :, 0].T)
    if "fc.conv.bias" in sd:
        _set(params, "Dense_0/bias", np.asarray(sd["fc.conv.bias"]))

    # instance norm (input_norm=True models)
    if "instance_norm.weight" in sd:
        _set(params, "input_norm_scale", np.asarray(sd["instance_norm.weight"]))
        _set(params, "input_norm_bias", np.asarray(sd["instance_norm.bias"]))

    return params, stats


def _np(sd, key):
    v = sd[key]
    return np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v)


def _conv1d_at(params, stats, sd, tkey, fkey, bias=True):
    """torch Conv1d [out, in, k] → flax Conv kernel [k, in, out]."""
    _set(params, f"{fkey}/kernel", _np(sd, f"{tkey}.weight").transpose(2, 1, 0))
    if bias and f"{tkey}.bias" in sd:
        _set(params, f"{fkey}/bias", _np(sd, f"{tkey}.bias"))


def _conv2d_at(params, sd, tkey, fkey):
    """torch Conv2d [out, in, kh, kw] → flax Conv kernel [kh, kw, in, out]."""
    _set(params, f"{fkey}/kernel",
         _np(sd, f"{tkey}.weight").transpose(2, 3, 1, 0))
    if f"{tkey}.bias" in sd:
        _set(params, f"{fkey}/bias", _np(sd, f"{tkey}.bias"))


def _bn_at(params, stats, sd, tkey, fkey):
    _set(params, f"{fkey}/scale", _np(sd, f"{tkey}.weight"))
    _set(params, f"{fkey}/bias", _np(sd, f"{tkey}.bias"))
    _set(stats, f"{fkey}/mean", _np(sd, f"{tkey}.running_mean"))
    _set(stats, f"{fkey}/var", _np(sd, f"{tkey}.running_var"))


def _bottle2neck(params, stats, sd, tp, fp, scale, has_residual):
    """Reference Bottle2neck (RawNet_baseline.py:71-160) → Bottle2neckRaw.

    Flax @nn.compact ordering: the 1×1 residual conv (only when
    inplanes≠planes) is declared first, so conv indices shift by one.
    """
    idx = 0
    if has_residual:
        _conv1d_at(params, stats, sd, f"{tp}.residual.0", f"{fp}/Conv_0",
                   bias=False)
        idx = 1
    _conv1d_at(params, stats, sd, f"{tp}.conv1", f"{fp}/Conv_{idx}")
    _bn_at(params, stats, sd, f"{tp}.bn1", f"{fp}/BatchNorm_0")
    for j in range(scale - 1):
        _conv1d_at(params, stats, sd, f"{tp}.convs.{j}",
                   f"{fp}/Conv_{idx + 1 + j}")
        _bn_at(params, stats, sd, f"{tp}.bns.{j}", f"{fp}/BatchNorm_{1 + j}")
    _conv1d_at(params, stats, sd, f"{tp}.conv3", f"{fp}/Conv_{idx + scale}")
    _bn_at(params, stats, sd, f"{tp}.bn3", f"{fp}/BatchNorm_{scale}")
    _set(params, f"{fp}/AFMS_0/Dense_0/kernel",
         _np(sd, f"{tp}.afms.fc.weight").T)
    _set(params, f"{fp}/AFMS_0/Dense_0/bias", _np(sd, f"{tp}.afms.fc.bias"))
    _set(params, f"{fp}/AFMS_0/alpha",
         _np(sd, f"{tp}.afms.alpha").reshape(-1))


def rawnet3_from_torch_state_dict(sd: Mapping, model_scale: int = 8,
                                  out_bn: bool = False) -> Tuple[dict, dict]:
    """Reference RawNet3 state dict (src/models/RawNet3.py:10-146) →
    our (params, batch_stats).

    The sinc frontend ports the learnable (low_hz_, band_hz_) cutoff
    pairs; our SincConv materializes SincNet-style band-passes from them
    (ops/sinc.py). asteroid's ParamSincFB builds cos/sin analytic pairs
    from its cutoffs — that pairing is NOT reproduced (the package is
    unavailable to verify against); the shapes are accepted either way
    and everything downstream of the sinc layer ports exactly.
    """
    params: dict = {}
    stats: dict = {}

    _set(params, "inorm_scale", _np(sd, "preprocess.1.weight").reshape(-1))
    _set(params, "inorm_bias", _np(sd, "preprocess.1.bias").reshape(-1))

    for lk in ("conv1.filterbank.low_hz_", "conv1.low_hz_"):
        if lk in sd:
            _set(params, "SincConv_0/low_hz", _np(sd, lk).reshape(-1))
            _set(params, "SincConv_0/band_hz",
                 _np(sd, lk.replace("low_hz_", "band_hz_")).reshape(-1))
            break

    _bottle2neck(params, stats, sd, "layer1", "Bottle2neckRaw_0",
                 model_scale, has_residual=True)     # C/4 → C
    _bottle2neck(params, stats, sd, "layer2", "Bottle2neckRaw_1",
                 model_scale, has_residual=False)
    _bottle2neck(params, stats, sd, "layer3", "Bottle2neckRaw_2",
                 model_scale, has_residual=False)

    _conv1d_at(params, stats, sd, "layer4", "Conv_0")           # MFA 1×1
    _conv1d_at(params, stats, sd, "attention.0", "Conv_1")
    _bn_at(params, stats, sd, "attention.2", "BatchNorm_0")
    _conv1d_at(params, stats, sd, "attention.3", "Conv_2")
    _bn_at(params, stats, sd, "bn5", "BatchNorm_1")
    _set(params, "Dense_0/kernel", _np(sd, "fc6.weight").T)
    _set(params, "Dense_0/bias", _np(sd, "fc6.bias"))
    if out_bn and "bn6.weight" in sd:
        _bn_at(params, stats, sd, "bn6", "BatchNorm_2")
    return params, stats


def raw3_ecapa_from_torch_state_dict(sd: Mapping, model_scale: int = 8,
                                     ecapa_res2net_scale: int = 8,
                                     ) -> Tuple[dict, dict]:
    """Reference Raw3_ECAPA (src/models/Raw3_ECAPA.py:9-60 ``Raw_ECAPA``:
    ECAPA_TDNN branch ∥ RawNet3 branch) → our RawECAPAHybrid trees
    (submodule scopes ``ecapa`` / ``raw_branch``)."""
    sd = {k: v for k, v in sd.items()}
    ecapa_sd = {k.removeprefix("ECAPA_TDNN."): v for k, v in sd.items()
                if k.startswith("ECAPA_TDNN.")}
    raw_sd = {k.removeprefix("rawnet."): v for k, v in sd.items()
              if k.startswith("rawnet.")}
    e_params, e_stats = ecapa_from_torch_state_dict(
        ecapa_sd, n_blocks=4, res2net_scale=ecapa_res2net_scale)
    r_params, r_stats = rawnet3_from_torch_state_dict(
        raw_sd, model_scale=model_scale)
    return ({"ecapa": e_params, "raw_branch": r_params},
            {"ecapa": e_stats, "raw_branch": r_stats})


def raw_ecapa2_from_torch_state_dict(sd: Mapping, front_proc: str = "sinc",
                                     aggregate: str = "asp",
                                     ) -> Tuple[dict, dict]:
    """Reference Raw_ECAPA / Raw_ECAPA_{sinc_asp,conv_asp,sinc_gru}
    (src/models/Raw_ECAPA.py:20-33 and siblings: ECAPA_TDNN-192 branch ∥
    RawNet2_custom branch, embeddings concatenated) → our RawECAPAHybrid
    trees (submodule scopes ``ecapa`` / ``raw_branch``)."""
    ecapa_sd = {k.removeprefix("ECAPA_TDNN."): v for k, v in sd.items()
                if k.startswith("ECAPA_TDNN.")}
    raw_sd = {k.removeprefix("rawnet2v2."): v for k, v in sd.items()
              if k.startswith("rawnet2v2.")}
    e_params, e_stats = ecapa_from_torch_state_dict(
        ecapa_sd, n_blocks=4, res2net_scale=8)
    r_params, r_stats = rawnet2_custom_from_torch_state_dict(
        raw_sd, front_proc=front_proc, aggregate=aggregate)
    return ({"ecapa": e_params, "raw_branch": r_params},
            {"ecapa": e_stats, "raw_branch": r_stats})


def raw_ecapa_hype_from_torch_state_dict(sd: Mapping) -> Tuple[dict, dict]:
    """Reference Raw_ECAPA_hype (src/models/Raw_ECAPA_hype.py:18-88):
    the two branches of Raw_ECAPA (rawnet2v2 at a FIXED nOut=512,
    sinc/gru) plus a channel-attention head over the concatenated
    704-dim embedding — bn_before_agg, 1×1-conv attention MLP (a Dense
    pair here: the convs act on a singleton time axis), bn_final, fc."""
    params, stats = raw_ecapa2_from_torch_state_dict(
        sd, front_proc="sinc", aggregate="gru")

    def dense_from_conv1x1(tk, fk):
        _set(params, f"{fk}/kernel", _np(sd, f"{tk}.weight")[:, :, 0].T)
        _set(params, f"{fk}/bias", _np(sd, f"{tk}.bias"))

    _bn_at(params, stats, sd, "bn_before_agg", "BatchNorm_0")
    dense_from_conv1x1("attention.0", "Dense_0")
    _bn_at(params, stats, sd, "attention.2", "BatchNorm_1")
    dense_from_conv1x1("attention.3", "Dense_1")
    _bn_at(params, stats, sd, "bn_final", "BatchNorm_2")
    _set(params, "Dense_2/kernel", _np(sd, "fc.weight").T)
    _set(params, "Dense_2/bias", _np(sd, "fc.bias"))
    return params, stats


def tita_ecapa_from_torch_state_dict(sd: Mapping) -> Tuple[dict, dict]:
    """Reference Tita_ECAPA (src/models/Tita_ECAPA.py:20-52: ECAPA-192 ∥
    TitaNet-M, both on mel) → our TitaECAPA trees (scopes ``ecapa`` /
    ``titanet``)."""
    ecapa_sd = {k.removeprefix("ECAPA_TDNN."): v for k, v in sd.items()
                if k.startswith("ECAPA_TDNN.")}
    tita_sd = {k.removeprefix("titaNet."): v for k, v in sd.items()
               if k.startswith("titaNet.")}
    e_params, e_stats = ecapa_from_torch_state_dict(
        ecapa_sd, n_blocks=4, res2net_scale=8)
    t_params, t_stats = titanet_from_torch_state_dict(tita_sd)
    return ({"ecapa": e_params, "titanet": t_params},
            {"ecapa": e_stats, "titanet": t_stats})


def raw_tita_from_torch_state_dict(sd: Mapping) -> Tuple[dict, dict]:
    """Reference Raw_tita (src/models/Raw_tita.py:20-49: TitaNet-M-192
    on mel ∥ RawNet2_custom sinc/ASP on raw) → our RawTita trees (scopes
    ``titanet`` / ``raw_branch``)."""
    tita_sd = {k.removeprefix("titaNet."): v for k, v in sd.items()
               if k.startswith("titaNet.")}
    raw_sd = {k.removeprefix("RawNet."): v for k, v in sd.items()
              if k.startswith("RawNet.")}
    t_params, t_stats = titanet_from_torch_state_dict(tita_sd)
    r_params, r_stats = rawnet2_custom_from_torch_state_dict(
        raw_sd, front_proc="sinc", aggregate="asp")
    return ({"titanet": t_params, "raw_branch": r_params},
            {"titanet": t_stats, "raw_branch": r_stats})


def res_ecapa_from_torch_state_dict(sd: Mapping, layers=(2, 2),
                                    ) -> Tuple[dict, dict]:
    """Reference Res_ECAPA (src/models/Res_ECAPA.py:11-260:
    nn.Sequential of a headless SE-ResNet trunk ['0.'] and an ECAPA core
    ['1.']) → our ResECAPA trees. The trunk uses the ROOT
    ResNetBlocks.py SEBasicBlock (conv→relu→bn first stage, biased
    fixed-16 SE) and stride-(2,1) p1 convs at both ends."""
    params: dict = {}
    stats: dict = {}

    def conv2d(tk, fk):
        _conv2d_at(params, sd, tk, fk)

    _set(params, "inorm_scale", _np(sd, "0.instance_norm.weight"))
    _set(params, "inorm_bias", _np(sd, "0.instance_norm.bias"))
    conv2d("0.conv1", "Conv_0")
    _bn_at(params, stats, sd, "0.bn1", "BatchNorm_0")

    bi = 0
    for g, n in enumerate(layers):
        for i in range(n):
            tp, fp = f"0.resnet_se_module.{g}.{i}", f"RootSEBasicBlock_{bi}"
            conv2d(f"{tp}.conv1", f"{fp}/Conv_0")
            _bn_at(params, stats, sd, f"{tp}.bn1", f"{fp}/BatchNorm_0")
            conv2d(f"{tp}.conv2", f"{fp}/Conv_1")
            _bn_at(params, stats, sd, f"{tp}.bn2", f"{fp}/BatchNorm_1")
            _set(params, f"{fp}/SELayer_0/Dense_0/kernel",
                 _np(sd, f"{tp}.se.fc.0.weight").T)
            _set(params, f"{fp}/SELayer_0/Dense_0/bias",
                 _np(sd, f"{tp}.se.fc.0.bias"))
            _set(params, f"{fp}/SELayer_0/Dense_1/kernel",
                 _np(sd, f"{tp}.se.fc.2.weight").T)
            _set(params, f"{fp}/SELayer_0/Dense_1/bias",
                 _np(sd, f"{tp}.se.fc.2.bias"))
            if f"{tp}.downsample.0.weight" in sd:
                conv2d(f"{tp}.downsample.0", f"{fp}/Conv_2")
                _bn_at(params, stats, sd, f"{tp}.downsample.1",
                       f"{fp}/BatchNorm_2")
            bi += 1

    conv2d("0.conv2", "Conv_1")
    _bn_at(params, stats, sd, "0.bn2", "BatchNorm_1")

    core_sd = {k.removeprefix("1."): v for k, v in sd.items()
               if k.startswith("1.")}
    c_params, c_stats = ecapa_from_torch_state_dict(
        core_sd, n_blocks=4, res2net_scale=8)
    params["ECAPA_TDNN_0"] = c_params
    stats["ECAPA_TDNN_0"] = c_stats
    return params, stats


def resnetse_from_torch_state_dict(sd: Mapping, layers=(3, 4, 6, 3),
                                  block: str = "basic"):
    """Port a reference ResNetSE (SEBasicBlock trunk) state dict.

    Reference: src/models/ResNetBaseline.py:141-301 with
    src/models/blocks/ResNetBlocks.py:178-213 basic blocks (conv-bn-relu,
    conv-bn, SE with bias-free c/16 excitation, optional 1x1+BN
    downsample) or :255-298 SEBottleneck (1x1 / 3x3-stride / 1x1 x4,
    ``block="bottleneck"`` — ResNetSE50/101/152). Flax child order in models/resnetse.py::ResNetSE:
    stem Conv_0/BatchNorm_0, SEBasicBlock_0..N (Conv_0, BatchNorm_0,
    Conv_1, BatchNorm_1, SELayer_0{Dense_0,Dense_1}, downsample
    Conv_2/BatchNorm_2), attention Conv_1/BatchNorm_1/Conv_2, fc Dense_0.
    """
    params: dict = {}
    stats: dict = {}

    def conv2d(tk, fk):
        _conv2d_at(params, sd, tk, fk)

    def conv1d(tk, fk):
        _conv1d_at(params, stats, sd, tk, fk)

    def bn(tk, fk):
        _bn_at(params, stats, sd, tk, fk)

    conv2d("conv1", "Conv_0")
    bn("bn1", "BatchNorm_0")

    n_convs = {"basic": 2, "basicv2": 2, "bottleneck": 3}[block]
    block_cls = {"basic": "SEBasicBlock", "basicv2": "SEBasicBlockV2",
                 "bottleneck": "SEBottleneck"}[block]
    bi = 0
    for g in range(4):
        for i in range(layers[g]):
            tp, fp = f"layer{g + 1}.{i}", f"{block_cls}_{bi}"
            for c in range(n_convs):
                conv2d(f"{tp}.conv{c + 1}", f"{fp}/Conv_{c}")
                bn(f"{tp}.bn{c + 1}", f"{fp}/BatchNorm_{c}")
            if block == "basic":       # blocks/-file SE: bias-free
                _set(params, f"{fp}/SELayer_0/Dense_0/kernel",
                     _np(sd, f"{tp}.se.excitation.0.weight").T)
                _set(params, f"{fp}/SELayer_0/Dense_1/kernel",
                     _np(sd, f"{tp}.se.excitation.2.weight").T)
            else:                       # root-file SE: biased, se.fc.*
                for j, dn in ((0, "Dense_0"), (2, "Dense_1")):
                    _set(params, f"{fp}/SELayer_0/{dn}/kernel",
                         _np(sd, f"{tp}.se.fc.{j}.weight").T)
                    _set(params, f"{fp}/SELayer_0/{dn}/bias",
                         _np(sd, f"{tp}.se.fc.{j}.bias"))
            if f"{tp}.downsample.0.weight" in sd:
                conv2d(f"{tp}.downsample.0", f"{fp}/Conv_{n_convs}")
                bn(f"{tp}.downsample.1", f"{fp}/BatchNorm_{n_convs}")
            bi += 1

    conv1d("attention.0", "Conv_1")
    bn("attention.2", "BatchNorm_1")
    conv1d("attention.3", "Conv_2")
    _set(params, "Dense_0/kernel", _np(sd, "fc.weight").T)
    _set(params, "Dense_0/bias", _np(sd, "fc.bias"))
    return params, stats


def se_resnet_from_torch_state_dict(sd: Mapping, layers=(2, 2, 2, 2),
                                    block: str = "basic"):
    """Port a vendored-senet se_resnet{18,34,50,101,152} state dict
    (src/models/senet/se_resnet.py:11-146 — torchvision ResNet trunks of
    SEBasicBlock/SEBottleneck with the BIAS-FREE c/16 senet SELayer,
    se_module.py:4-19) into our ``SEResNet`` (models/senet.py).

    torchvision names: conv1/bn1 stem, layer{1-4}.{i}.conv{1-n}/bn{1-n},
    se.fc.{0,2} (Linear, no bias), downsample.{0,1}, fc head. Flax child
    order: Conv_0/BatchNorm_0 stem, SEBasicBlock_i|SENetBottleneck_i
    (Conv_0.., SELayer_0{Dense_0,Dense_1}, downsample Conv_n/BatchNorm_n),
    Dense_0 head."""
    params: dict = {}
    stats: dict = {}

    _conv2d_at(params, sd, "conv1", "Conv_0")
    _bn_at(params, stats, sd, "bn1", "BatchNorm_0")

    n_convs = {"basic": 2, "bottleneck": 3}[block]
    block_cls = {"basic": "SEBasicBlock",
                 "bottleneck": "SENetBottleneck"}[block]
    bi = 0
    for g in range(4):
        for i in range(layers[g]):
            tp, fp = f"layer{g + 1}.{i}", f"{block_cls}_{bi}"
            for c in range(n_convs):
                _conv2d_at(params, sd, f"{tp}.conv{c + 1}", f"{fp}/Conv_{c}")
                _bn_at(params, stats, sd, f"{tp}.bn{c + 1}",
                       f"{fp}/BatchNorm_{c}")
            for j, dn in ((0, "Dense_0"), (2, "Dense_1")):   # bias-free SE
                _set(params, f"{fp}/SELayer_0/{dn}/kernel",
                     _np(sd, f"{tp}.se.fc.{j}.weight").T)
            if f"{tp}.downsample.0.weight" in sd:
                _conv2d_at(params, sd, f"{tp}.downsample.0",
                           f"{fp}/Conv_{n_convs}")
                _bn_at(params, stats, sd, f"{tp}.downsample.1",
                       f"{fp}/BatchNorm_{n_convs}")
            bi += 1

    _set(params, "Dense_0/kernel", _np(sd, "fc.weight").T)
    _set(params, "Dense_0/bias", _np(sd, "fc.bias"))
    return params, stats


def repvgg_from_torch_state_dict(sd: Mapping, num_blocks=(8, 14, 24, 1)):
    """Port a reference RepVGG train-mode state dict
    (src/models/RepVGG.py:27-207). Torch modules per block:
    ``rbr_dense.{conv,bn}``, ``rbr_1x1.{conv,bn}``, optional
    ``rbr_identity`` (BN only, shape-preserving blocks), optional
    ``se.{down,up}`` 1×1 convs; head ``linear``. Flax children
    (models/image_encoders.py::RepVGGBlock): rbr_dense/BatchNorm_0,
    rbr_1x1/BatchNorm_1, BatchNorm_2, Dense_0/Dense_1, head Dense_0."""
    params: dict = {}
    stats: dict = {}

    def block(tp, fp):
        _set(params, f"{fp}/rbr_dense/kernel",
             _np(sd, f"{tp}.rbr_dense.conv.weight").transpose(2, 3, 1, 0))
        _bn_at(params, stats, sd, f"{tp}.rbr_dense.bn", f"{fp}/BatchNorm_0")
        _set(params, f"{fp}/rbr_1x1/kernel",
             _np(sd, f"{tp}.rbr_1x1.conv.weight").transpose(2, 3, 1, 0))
        _bn_at(params, stats, sd, f"{tp}.rbr_1x1.bn", f"{fp}/BatchNorm_1")
        if f"{tp}.rbr_identity.weight" in sd:
            _bn_at(params, stats, sd, f"{tp}.rbr_identity",
                   f"{fp}/BatchNorm_2")
        if f"{tp}.se.down.weight" in sd:
            for tk, fk in (("down", "Dense_0"), ("up", "Dense_1")):
                _set(params, f"{fp}/{fk}/kernel",
                     _np(sd, f"{tp}.se.{tk}.weight")[:, :, 0, 0].T)
                _set(params, f"{fp}/{fk}/bias", _np(sd, f"{tp}.se.{tk}.bias"))

    block("stage0", "RepVGGBlock_0")
    bi = 1
    for g, n in enumerate(num_blocks):
        for i in range(n):
            block(f"stage{g + 1}.{i}", f"RepVGGBlock_{bi}")
            bi += 1
    _set(params, "Dense_0/kernel", _np(sd, "linear.weight").T)
    _set(params, "Dense_0/bias", _np(sd, "linear.bias"))
    return params, stats


def titanet_from_torch_state_dict(sd: Mapping, n_mega_blocks: int = None,
                                  n_sub_blocks: int = 3):
    """Port a reference TitaNet state dict (src/models/TitaNet.py:10-443,
    blocks/titanet_blocks.py). Torch layout: ``encoder.prolog/epilog``
    ConvBlock1d (conv_block.0 conv, .1 BN), ``encoder.mega_blocks.N``
    (sub_blocks.J depthwise+pointwise+BN, sub_blocks.<last> bias-free SE,
    skip_connection 1×1+BN), ``decoder.pool.0`` ASP linears, ``.1`` BN,
    ``decoder.linear`` Linear+BN. Flax children (models/titanet.py):
    ConvBlock1d_0, MegaBlock_*, ConvBlock1d_1, Dense_0/1 (ASP),
    BatchNorm_0, Dense_2, BatchNorm_1. ``n_mega_blocks=None`` infers the
    depth from the state dict (the reference resolves it by a
    parameter-count search that depends on the embedding size)."""
    if n_mega_blocks is None:
        n_mega_blocks = 1 + max(
            int(k.split(".")[2]) for k in sd
            if k.startswith("encoder.mega_blocks."))
    params: dict = {}
    stats: dict = {}

    def convblock(tp, fp):
        _conv1d_at(params, stats, sd, f"{tp}.conv_block.0", f"{fp}/Conv_0")
        _bn_at(params, stats, sd, f"{tp}.conv_block.1", f"{fp}/BatchNorm_0")

    convblock("encoder.prolog", "ConvBlock1d_0")
    for m in range(n_mega_blocks):
        tp, fp = f"encoder.mega_blocks.{m}", f"MegaBlock_{m}"
        _conv1d_at(params, stats, sd, f"{tp}.skip_connection.0",
                   f"{fp}/Conv_0")
        _bn_at(params, stats, sd, f"{tp}.skip_connection.1",
               f"{fp}/BatchNorm_0")
        for j in range(n_sub_blocks):
            sp = f"{tp}.sub_blocks.{j}.conv_block"
            fsp = f"{fp}/ConvBlock1d_{j}"
            _conv1d_at(params, stats, sd, f"{sp}.0.conv.0", f"{fsp}/Conv_0")
            _conv1d_at(params, stats, sd, f"{sp}.0.conv.1", f"{fsp}/Conv_1")
            _bn_at(params, stats, sd, f"{sp}.1", f"{fsp}/BatchNorm_0")
        se = f"{tp}.sub_blocks.{n_sub_blocks}.excitation"
        _set(params, f"{fp}/Dense_0/kernel", _np(sd, f"{se}.0.weight").T)
        _set(params, f"{fp}/Dense_1/kernel", _np(sd, f"{se}.2.weight").T)
    convblock("encoder.epilog", "ConvBlock1d_1")

    # flax names submodules in CONSTRUCTION order: in Dense(out)(tanh(
    # Dense(hidden)(h))) the outer Dense is constructed first → Dense_0
    # is out_linear, Dense_1 is in_linear
    _set(params, "Dense_0/kernel",
         _np(sd, "decoder.pool.0.out_linear.weight").T)
    _set(params, "Dense_0/bias", _np(sd, "decoder.pool.0.out_linear.bias"))
    _set(params, "Dense_1/kernel", _np(sd, "decoder.pool.0.in_linear.weight").T)
    _set(params, "Dense_1/bias", _np(sd, "decoder.pool.0.in_linear.bias"))
    _bn_at(params, stats, sd, "decoder.pool.1", "BatchNorm_0")
    _set(params, "Dense_2/kernel", _np(sd, "decoder.linear.0.weight").T)
    _set(params, "Dense_2/bias", _np(sd, "decoder.linear.0.bias"))
    _bn_at(params, stats, sd, "decoder.linear.1", "BatchNorm_1")
    return params, stats


def rawnet2_from_torch_state_dict(sd: Mapping, n_blocks: int = 6):
    """Port a reference RawNet2 (SincNet baseline) state dict
    (src/models/RawNet_baseline.py:485-571). Torch: ``ln`` sample
    LayerNorm, ``first_conv`` SincConv_fast, ``first_bn``, six
    ``blockN.0`` Residual_block_wFRM (bn1 absent on the first), ``
    bn_before_gru``, one-layer ``gru``, ``fc1_gru`` (the embedding —
    fc2_gru/sig are dead code in forward). Flax children
    (models/rawnet2.py): SampleLayerNorm_0, SincConv_0, BatchNorm_0,
    ResidualBlockFRM_*, BatchNorm_1, GRUCell_0, Dense_0."""
    params: dict = {}
    stats: dict = {}

    _set(params, "SampleLayerNorm_0/gamma", _np(sd, "ln.gamma"))
    _set(params, "SampleLayerNorm_0/beta", _np(sd, "ln.beta"))
    _set(params, "SincConv_0/low_hz", _np(sd, "first_conv.low_hz_")[:, 0])
    _set(params, "SincConv_0/band_hz", _np(sd, "first_conv.band_hz_")[:, 0])
    _bn_at(params, stats, sd, "first_bn", "BatchNorm_0")

    for i in range(n_blocks):
        tp, fp = f"block{i}.0", f"ResidualBlockFRM_{i}"
        first = i == 0
        if not first:
            _bn_at(params, stats, sd, f"{tp}.bn1", f"{fp}/BatchNorm_0")
        _conv1d_at(params, stats, sd, f"{tp}.conv1", f"{fp}/Conv_0")
        _bn_at(params, stats, sd, f"{tp}.bn2",
               f"{fp}/BatchNorm_0" if first else f"{fp}/BatchNorm_1")
        _conv1d_at(params, stats, sd, f"{tp}.conv2", f"{fp}/Conv_1")
        if f"{tp}.conv_downsample.weight" in sd:
            _conv1d_at(params, stats, sd, f"{tp}.conv_downsample",
                       f"{fp}/Conv_2")
        _set(params, f"{fp}/FRM_0/Dense_0/kernel",
             _np(sd, f"{tp}.frm.fc.weight").T)
        _set(params, f"{fp}/FRM_0/Dense_0/bias", _np(sd, f"{tp}.frm.fc.bias"))

    _bn_at(params, stats, sd, "bn_before_gru", "BatchNorm_1")
    _gru_at(params, sd, "gru", "GRUCell_0")
    _set(params, "Dense_0/kernel", _np(sd, "fc1_gru.weight").T)
    _set(params, "Dense_0/bias", _np(sd, "fc1_gru.bias"))
    return params, stats


def _gru_at(params, sd, tkey, fkey):
    """torch GRU gates stack (r|z|n) rows; flax GRUCell keeps them as
    separate Dense's with input-side bias only for r/z (so the two
    torch biases fold into one) and the hidden-side n bias kept
    separate (it sits inside the reset gate product). Torch stacks
    layers as ``weight_*_l{n}`` in one module; our models stack
    single-layer ``nn.RNN(nn.GRUCell)``s, so layer n maps to the
    auto-numbered sibling of ``fkey`` (GRUCell_0 → GRUCell_n)."""
    base = fkey.rsplit("_", 1)[0]
    layer = 0
    while f"{tkey}.weight_ih_l{layer}" in sd:
        fk = fkey if layer == 0 else f"{base}_{layer}"
        w_ih = _np(sd, f"{tkey}.weight_ih_l{layer}")
        w_hh = _np(sd, f"{tkey}.weight_hh_l{layer}")
        b_ih = _np(sd, f"{tkey}.bias_ih_l{layer}")
        b_hh = _np(sd, f"{tkey}.bias_hh_l{layer}")
        H = w_hh.shape[1]
        for j, g in enumerate(("r", "z", "n")):
            wi = w_ih[j * H:(j + 1) * H].T
            wh = w_hh[j * H:(j + 1) * H].T
            bi = b_ih[j * H:(j + 1) * H]
            bh = b_hh[j * H:(j + 1) * H]
            _set(params, f"{fk}/i{g}/kernel", wi)
            _set(params, f"{fk}/h{g}/kernel", wh)
            if g == "n":
                _set(params, f"{fk}/in/bias", bi)
                _set(params, f"{fk}/hn/bias", bh)
            else:
                _set(params, f"{fk}/i{g}/bias", bi + bh)
        layer += 1


def rawnet2_custom_from_torch_state_dict(sd: Mapping, layers=None,
                                         front_proc: str = None,
                                         aggregate: str = None):
    """Port a reference RawNet2_custom state dict
    (src/models/RawNet2_custom.py:18-253): 'sinc' (sample LayerNorm +
    SincConv_fast + first_bn) or 'conv' front, six pre-activation
    RawNetBasicBlock groups (bn1/conv1/bn2/conv2, optional shortcut.0,
    AFMS), and a 'gru' / 'asp' / 'sap' aggregation head. ``None``
    config values are inferred from the state-dict keys, so checkpoints
    from any front/aggregate combination convert without flags."""
    if front_proc is None:
        front_proc = "sinc" if "first_conv.low_hz_" in sd else "conv"
    if aggregate is None:
        aggregate = ("gru" if "gru.weight_ih_l0" in sd
                     else "sap" if "attention_sap.v" in sd else "asp")
    if layers is None:
        counts = {}
        for k in sd:
            if k.startswith("layer"):
                g, i = k.split(".")[0], int(k.split(".")[1])
                counts[g] = max(counts.get(g, 0), i + 1)
        layers = tuple(counts[f"layer{g + 1}"] for g in range(len(counts)))
    params: dict = {}
    stats: dict = {}

    if front_proc == "conv":
        _conv1d_at(params, stats, sd, "conv1", "Conv_0")
        bn_i, cv_i = 0, 1
    else:
        _set(params, "SampleLayerNorm_0/gamma", _np(sd, "ln.gamma"))
        _set(params, "SampleLayerNorm_0/beta", _np(sd, "ln.beta"))
        _set(params, "SincConv_0/low_hz", _np(sd, "first_conv.low_hz_")[:, 0])
        _set(params, "SincConv_0/band_hz",
             _np(sd, "first_conv.band_hz_")[:, 0])
        _bn_at(params, stats, sd, "first_bn", "BatchNorm_0")
        bn_i, cv_i = 1, 0

    bi = 0
    for g, n in enumerate(layers):
        for i in range(n):
            tp, fp = f"layer{g + 1}.{i}", f"RawNetBasicBlock_{bi}"
            _bn_at(params, stats, sd, f"{tp}.bn1", f"{fp}/BatchNorm_0")
            ci = 0
            if f"{tp}.shortcut.0.weight" in sd:
                _conv1d_at(params, stats, sd, f"{tp}.shortcut.0",
                           f"{fp}/Conv_0", bias=False)
                ci = 1
            _conv1d_at(params, stats, sd, f"{tp}.conv1", f"{fp}/Conv_{ci}",
                       bias=False)
            _bn_at(params, stats, sd, f"{tp}.bn2", f"{fp}/BatchNorm_1")
            _conv1d_at(params, stats, sd, f"{tp}.conv2", f"{fp}/Conv_{ci + 1}",
                       bias=False)
            _set(params, f"{fp}/AFMS_0/Dense_0/kernel",
                 _np(sd, f"{tp}.afms.fc.weight").T)
            _set(params, f"{fp}/AFMS_0/Dense_0/bias",
                 _np(sd, f"{tp}.afms.fc.bias"))
            _set(params, f"{fp}/AFMS_0/alpha",
                 _np(sd, f"{tp}.afms.alpha").reshape(-1))
            bi += 1

    if aggregate == "gru":
        _bn_at(params, stats, sd, "bn_before_gru", f"BatchNorm_{bn_i}")
        _gru_at(params, sd, "gru", "GRUCell_0")
        _set(params, "Dense_0/kernel", _np(sd, "fc_after_gru.weight").T)
        _set(params, "Dense_0/bias", _np(sd, "fc_after_gru.bias"))
    elif aggregate == "sap":
        _bn_at(params, stats, sd, "bn_before_agg", f"BatchNorm_{bn_i}")
        _set(params, "Dense_0/kernel",
             _np(sd, "attention_sap.lin_proj.weight").T)
        _set(params, "Dense_0/bias", _np(sd, "attention_sap.lin_proj.bias"))
        _set(params, "sap_v", _np(sd, "attention_sap.v"))
        _set(params, "Dense_1/kernel", _np(sd, "fc.weight").T)
        _set(params, "Dense_1/bias", _np(sd, "fc.bias"))
    else:
        _bn_at(params, stats, sd, "bn_before_agg", f"BatchNorm_{bn_i}")
        _conv1d_at(params, stats, sd, "attention.0", f"Conv_{cv_i}")
        _bn_at(params, stats, sd, "attention.2", f"BatchNorm_{bn_i + 1}")
        _conv1d_at(params, stats, sd, "attention.3", f"Conv_{cv_i + 1}")
        _set(params, "Dense_0/kernel", _np(sd, "fc.weight").T)
        _set(params, "Dense_0/bias", _np(sd, "fc.bias"))
    return params, stats


def scnet_from_torch_state_dict(sd: Mapping, layers=(3, 4, 6, 3)):
    """Port a reference SCNet-50 state dict (src/models/SCnet.py +
    utils/SCnet_utils.py). Torch per-block modules: conv1_a/bn1_a,
    conv1_b/bn1_b, k1.{0,1}, scconv.k2.{1,2} (index 0 is the AvgPool),
    scconv.k3.{0,1}, scconv.k4.{0,1}, conv3/bn3, downsample.{0,1}.
    Flax children (models/image_encoders.py::SCBottleneck, construction
    order): Conv_0/BN_0 = 1×1a, Conv_1/BN_1 = k1, Conv_2/BN_2 = 1×1b,
    Conv_3/BN_3 = k2, Conv_4/BN_4 = k3, Conv_5/BN_5 = k4,
    Conv_6/BN_6 = conv3, Conv_7/BN_7 = downsample."""
    params: dict = {}
    stats: dict = {}

    def conv2d(tk, fk):
        _conv2d_at(params, sd, tk, fk)

    def bn(tk, fk):
        _bn_at(params, stats, sd, tk, fk)

    conv2d("conv1", "Conv_0")
    bn("bn1", "BatchNorm_0")
    bi = 0
    pairs = [("conv1_a", 0), ("k1.0", 1), ("conv1_b", 2),
             ("scconv.k2.1", 3), ("scconv.k3.0", 4), ("scconv.k4.0", 5),
             ("conv3", 6)]
    bns = [("bn1_a", 0), ("k1.1", 1), ("bn1_b", 2), ("scconv.k2.2", 3),
           ("scconv.k3.1", 4), ("scconv.k4.1", 5), ("bn3", 6)]
    for g in range(4):
        for i in range(layers[g]):
            tp, fp = f"layer{g + 1}.{i}", f"SCBottleneck_{bi}"
            for tk, ci in pairs:
                conv2d(f"{tp}.{tk}", f"{fp}/Conv_{ci}")
            for tk, ci in bns:
                bn(f"{tp}.{tk}", f"{fp}/BatchNorm_{ci}")
            if f"{tp}.downsample.0.weight" in sd:
                conv2d(f"{tp}.downsample.0", f"{fp}/Conv_7")
                bn(f"{tp}.downsample.1", f"{fp}/BatchNorm_7")
            bi += 1
    _set(params, "Dense_0/kernel", _np(sd, "fc.weight").T)
    _set(params, "Dense_0/bias", _np(sd, "fc.bias"))
    return params, stats


def efficientnet_from_torch_state_dict(sd: Mapping, width_coeff=1.4,
                                       depth_coeff=1.8,
                                       aggregate: str = "ASP"):
    """Port a reference EfficientNet state dict (src/models/
    EfficientNet.py + Efficient_utils.py). Torch per-block modules
    (``blocks.{stage}.layers.{i}``): expand_conv.{0,1} (absent when
    expand==1), depth_wise_conv.{0,1}, se.se.{1,3} 1×1 convs,
    project_conv.{0,1}; stem/head conv_bn_act pairs; fc / fc_attn heads.
    The ``attention.*`` weights are skipped — with the head's global
    pool the ASP softmax runs over one step and they cannot affect the
    output (EfficientNet.py:132-139,184-192). ``width_coeff`` is
    accepted for symmetry with the model ctor but unused: keys map by
    name, and every channel count comes from the state dict itself."""
    import math

    params: dict = {}
    stats: dict = {}

    def conv2d(tk, fk):
        _conv2d_at(params, sd, tk, fk)

    def bn(tk, fk):
        _bn_at(params, stats, sd, tk, fk)

    conv2d("stem.0", "Conv_0")
    bn("stem.1", "BatchNorm_0")

    specs = [(16, 1, 1), (24, 6, 2), (40, 6, 2), (80, 6, 3),
             (112, 6, 3), (192, 6, 4), (320, 6, 1)]
    mb = 0
    for stage, (out, expand, rep) in enumerate(specs):
        for i in range(int(math.ceil(rep * depth_coeff))):
            tp = f"blocks.{stage}.layers.{i}"
            fp = f"MBConv_{mb}"
            ci = 0
            if expand != 1:
                conv2d(f"{tp}.expand_conv.0", f"{fp}/Conv_0")
                bn(f"{tp}.expand_conv.1", f"{fp}/BatchNorm_0")
                ci = 1
            conv2d(f"{tp}.depth_wise_conv.0", f"{fp}/Conv_{ci}")
            bn(f"{tp}.depth_wise_conv.1", f"{fp}/BatchNorm_{ci}")
            _set(params, f"{fp}/Dense_0/kernel",
                 _np(sd, f"{tp}.se.se.1.weight")[:, :, 0, 0].T)
            _set(params, f"{fp}/Dense_0/bias", _np(sd, f"{tp}.se.se.1.bias"))
            _set(params, f"{fp}/Dense_1/kernel",
                 _np(sd, f"{tp}.se.se.3.weight")[:, :, 0, 0].T)
            _set(params, f"{fp}/Dense_1/bias", _np(sd, f"{tp}.se.se.3.bias"))
            conv2d(f"{tp}.project_conv.0", f"{fp}/Conv_{ci + 1}")
            bn(f"{tp}.project_conv.1", f"{fp}/BatchNorm_{ci + 1}")
            mb += 1

    conv2d("head.0", "Conv_1")
    bn("head.1", "BatchNorm_1")
    fck = "fc" if aggregate == "flatten" else "fc_attn"
    _set(params, "Dense_0/kernel", _np(sd, f"{fck}.weight").T)
    _set(params, "Dense_0/bias", _np(sd, f"{fck}.bias"))
    return params, stats


def dpn_from_torch_state_dict(sd: Mapping, k_sec=(3, 4, 8, 3)):
    """Port a reference DPN state dict (src/models/DPN.py:90-159).

    Torch layout: ``features.conv1.{0,1}`` stem; per block
    ``features.conv{s+2}_{i+1}`` with ``c1x1_w.{norm,conv}`` (proj/down
    only) and ``layers.c1x1_{a,c}/c3x3_b.{norm,conv}``; ``classifier``.
    Flax @nn.compact ordering inside DualPathBlock: the proj BN/conv
    declare first, so a/b/c indices shift by one in proj blocks."""
    params: dict = {}
    stats: dict = {}

    _conv2d_at(params, sd, "features.conv1.0", "Conv_0")
    _bn_at(params, stats, sd, "features.conv1.1", "BatchNorm_0")

    blk = 0
    for stage, n in enumerate(k_sec):
        for i in range(n):
            tp = f"features.conv{stage + 2}_{i + 1}"
            fp = f"DualPathBlock_{blk}"
            ci = 0
            if i == 0:                                 # proj / down
                _bn_at(params, stats, sd, f"{tp}.c1x1_w.norm",
                       f"{fp}/BatchNorm_0")
                _conv2d_at(params, sd, f"{tp}.c1x1_w.conv", f"{fp}/Conv_0")
                ci = 1
            for j, leg in enumerate(("c1x1_a", "c3x3_b", "c1x1_c")):
                _bn_at(params, stats, sd, f"{tp}.layers.{leg}.norm",
                       f"{fp}/BatchNorm_{ci + j}")
                _conv2d_at(params, sd, f"{tp}.layers.{leg}.conv",
                           f"{fp}/Conv_{ci + j}")
            blk += 1

    _set(params, "Dense_0/kernel", _np(sd, "classifier.weight").T)
    _set(params, "Dense_0/bias", _np(sd, "classifier.bias"))
    return params, stats


def effnetv2_from_torch_state_dict(sd: Mapping, cfgs=None):
    """Port a reference EffNetV2 state dict (src/models/
    EfficientNetv2.py:122-170). Torch layout: ``features.0.{0,1}`` stem,
    then one ``features.{j}.conv.{idx}`` Sequential per block — fused:
    0 conv/1 bn/3 conv/4 bn; use_se: 0/1 pw, 3/4 dw, 6 SELayer
    (``fc.{0,2}`` Linears), 7/8 pw-linear — and ``conv.{0,1}`` head +
    ``classifier``. Flax blocks are numbered per class (FusedMBConv_k /
    MBConvV2_k)."""
    if cfgs is None:                                  # effnetv2-s
        cfgs = [(1, 24, 2, 1, 0), (4, 48, 4, 2, 0), (4, 64, 4, 2, 0),
                (4, 128, 6, 2, 1), (6, 160, 9, 1, 1), (6, 256, 15, 2, 1)]
    params: dict = {}
    stats: dict = {}

    _conv2d_at(params, sd, "features.0.0", "Conv_0")
    _bn_at(params, stats, sd, "features.0.1", "BatchNorm_0")

    j = 1
    fused_k = se_k = 0
    for t, c, n, s, use_se in cfgs:
        for _ in range(n):
            tp = f"features.{j}.conv"
            if use_se:
                fp = f"MBConvV2_{se_k}"
                _conv2d_at(params, sd, f"{tp}.0", f"{fp}/Conv_0")
                _bn_at(params, stats, sd, f"{tp}.1", f"{fp}/BatchNorm_0")
                _conv2d_at(params, sd, f"{tp}.3", f"{fp}/Conv_1")
                _bn_at(params, stats, sd, f"{tp}.4", f"{fp}/BatchNorm_1")
                _set(params, f"{fp}/Dense_0/kernel",
                     _np(sd, f"{tp}.6.fc.0.weight").T)
                _set(params, f"{fp}/Dense_0/bias",
                     _np(sd, f"{tp}.6.fc.0.bias"))
                _set(params, f"{fp}/Dense_1/kernel",
                     _np(sd, f"{tp}.6.fc.2.weight").T)
                _set(params, f"{fp}/Dense_1/bias",
                     _np(sd, f"{tp}.6.fc.2.bias"))
                _conv2d_at(params, sd, f"{tp}.7", f"{fp}/Conv_2")
                _bn_at(params, stats, sd, f"{tp}.8", f"{fp}/BatchNorm_2")
                se_k += 1
            else:
                fp = f"FusedMBConv_{fused_k}"
                _conv2d_at(params, sd, f"{tp}.0", f"{fp}/Conv_0")
                _bn_at(params, stats, sd, f"{tp}.1", f"{fp}/BatchNorm_0")
                _conv2d_at(params, sd, f"{tp}.3", f"{fp}/Conv_1")
                _bn_at(params, stats, sd, f"{tp}.4", f"{fp}/BatchNorm_1")
                fused_k += 1
            j += 1

    _conv2d_at(params, sd, "conv.0", "Conv_1")
    _bn_at(params, stats, sd, "conv.1", "BatchNorm_1")
    _set(params, "Dense_0/kernel", _np(sd, "classifier.weight").T)
    _set(params, "Dense_0/bias", _np(sd, "classifier.bias"))
    return params, stats


def _convt1d_at(params, sd, tkey, fkey):
    """torch ConvTranspose1d [in, out, k] → flax ConvTranspose kernel:
    spatially FLIPPED [k, in, out] (flax transpose_kernel=False computes
    the fractionally-strided conv with an unflipped kernel; verified
    numerically against torch)."""
    w = _np(sd, f"{tkey}.weight")
    _set(params, f"{fkey}/kernel", w.transpose(2, 0, 1)[::-1].copy())
    if f"{tkey}.bias" in sd:
        _set(params, f"{fkey}/bias", _np(sd, f"{tkey}.bias"))


def rawnext_from_torch_state_dict(sd: Mapping, levels=(1, 1, 1, 2, 2, 1),
                                  tree: bool = True):
    """Port a reference RawNeXt state dict (src/models/RawNeXt.py +
    NeXt_utils.py). Per elastic block: conv1/bn1/conv2/bn2/conv3 +
    _d and _u branch triples, conv_t / conv_t_u transposed convs,
    gate_moduel.attention.{0,2,3}, the SHARED bn3, optional shortcut.0.
    DLA trees recurse tree1/tree2(/root); the dead ``project``/
    ``downsample`` members (never used in Tree.forward, RawNeXt.py:65-80)
    are skipped. ``tree=False`` ports ResNeXt (src/models/ResNeXt.py:
    9-125) — the same trunk with plain ``level{N}.{i}`` block stacks."""
    params: dict = {}
    stats: dict = {}

    def block(tp, fp):
        ci = 0
        if f"{tp}.shortcut.0.weight" in sd:
            _conv1d_at(params, stats, sd, f"{tp}.shortcut.0", f"{fp}/Conv_0",
                       bias=False)
            ci = 1
        grid = [("conv1", "bn1"), ("conv2", "bn2"), ("conv3", None),
                ("conv1_d", "bn1_d"), ("conv2_d", "bn2_d"), ("conv3_d", None),
                ("conv1_u", "bn1_u"), ("conv2_u", "bn2_u"), ("conv3_u", None)]
        bi = 0
        for conv_k, bn_k in grid:
            _conv1d_at(params, stats, sd, f"{tp}.{conv_k}", f"{fp}/Conv_{ci}")
            ci += 1
            if bn_k is not None:
                _bn_at(params, stats, sd, f"{tp}.{bn_k}",
                       f"{fp}/BatchNorm_{bi}")
                bi += 1
        _convt1d_at(params, sd, f"{tp}.conv_t", f"{fp}/ConvTranspose_0")
        _convt1d_at(params, sd, f"{tp}.conv_t_u", f"{fp}/ConvTranspose_1")
        gm = f"{tp}.gate_moduel.attention"
        _conv1d_at(params, stats, sd, f"{gm}.0", f"{fp}/GateModule_0/Conv_0")
        _bn_at(params, stats, sd, f"{gm}.2", f"{fp}/GateModule_0/BatchNorm_0")
        _conv1d_at(params, stats, sd, f"{gm}.3", f"{fp}/GateModule_0/Conv_1")
        _bn_at(params, stats, sd, f"{tp}.bn3", f"{fp}/BatchNorm_{bi}")

    def walk_tree(tp, fp, lv):
        if lv == 1:
            block(f"{tp}.tree1", f"{fp}/ElasticBottleneck_0")
            block(f"{tp}.tree2", f"{fp}/ElasticBottleneck_1")
            _conv1d_at(params, stats, sd, f"{tp}.root.conv",
                       f"{fp}/Root_0/Conv_0", bias=False)
            _bn_at(params, stats, sd, f"{tp}.root.bn",
                   f"{fp}/Root_0/BatchNorm_0")
        else:
            walk_tree(f"{tp}.tree1", f"{fp}/Tree_0", lv - 1)
            walk_tree(f"{tp}.tree2", f"{fp}/Tree_1", lv - 1)

    _conv1d_at(params, stats, sd, "base_layer.0", "Conv_0", bias=False)
    _bn_at(params, stats, sd, "base_layer.1", "BatchNorm_0")
    _conv1d_at(params, stats, sd, "level0.0", "Conv_1", bias=False)
    _bn_at(params, stats, sd, "level0.1", "BatchNorm_1")
    _conv1d_at(params, stats, sd, "level1.0", "Conv_2", bias=False)
    _bn_at(params, stats, sd, "level1.1", "BatchNorm_2")
    if tree:
        for i, li in enumerate(range(2, 6)):
            walk_tree(f"level{li}", f"Tree_{i}", levels[li])
    else:
        bi = 0
        for li in range(2, 6):
            for i in range(levels[li]):
                block(f"level{li}.{i}", f"ElasticBottleneck_{bi}")
                bi += 1
    _conv1d_at(params, stats, sd, "attention.0", "Conv_3")
    _bn_at(params, stats, sd, "attention.2", "BatchNorm_3")
    _conv1d_at(params, stats, sd, "attention.3", "Conv_4")
    _bn_at(params, stats, sd, "bn_agg", "BatchNorm_4")
    _set(params, "Dense_0/kernel", _np(sd, "fc.weight").T)
    _set(params, "Dense_0/bias", _np(sd, "fc.bias"))
    _bn_at(params, stats, sd, "bn_code", "BatchNorm_5")
    return params, stats


def _ln_at(params, sd, tkey, fkey):
    _set(params, f"{fkey}/scale", _np(sd, f"{tkey}.weight"))
    _set(params, f"{fkey}/bias", _np(sd, f"{tkey}.bias"))


def _conformer_encoder_port(params, stats, sd, tenc: str, enc: str,
                            num_layers: int, input_dim: int):
    """Vendored ConformerEncoder → our ConformerEncoder_* subtree:
    conv_subsample (two VALID 3×3-s2 conv2d), input_projection Linear
    over the (C-major, freq-minor) flatten — reordered to our
    (freq-major, C-minor) NHWC flatten — N FFN/MHSA/conv/FFN/LN
    blocks."""
    # subsampling convs: torch [out, in, kh, kw] → flax [kh, kw, in, out]
    for i, t in ((0, "0"), (1, "2")):
        _set(params, f"{enc}/Conv_{i}/kernel",
             _np(sd, f"{tenc}.conv_subsample.sequential.{t}.weight"
                 ).transpose(2, 3, 1, 0))
        _set(params, f"{enc}/Conv_{i}/bias",
             _np(sd, f"{tenc}.conv_subsample.sequential.{t}.bias"))

    # input projection: torch flattens [B, T', C, D'] as C-major
    # (encoder.py:180-181); our NHWC reshape is D'-major — permute cols
    w = _np(sd, f"{tenc}.input_projection.0.linear.weight")   # [E, C*D']
    dsub = ((input_dim - 1) // 2 - 1) // 2
    n_ch = w.shape[1] // dsub
    idx = np.arange(w.shape[1]).reshape(n_ch, dsub).T.reshape(-1)
    _set(params, f"{enc}/Dense_0/kernel", w[:, idx].T)
    _set(params, f"{enc}/Dense_0/bias",
         _np(sd, f"{tenc}.input_projection.0.linear.bias"))

    def linear(tk, fk, bias=True):
        _set(params, f"{fk}/kernel", _np(sd, f"{tk}.weight").T)
        if bias and f"{tk}.bias" in sd:
            _set(params, f"{fk}/bias", _np(sd, f"{tk}.bias"))

    for li in range(num_layers):
        tp = f"{tenc}.layers.{li}.sequential"
        fp = f"{enc}/ConformerBlock_{li}"
        for si, ff in ((0, "_FeedForward_0"), (3, "_FeedForward_1")):
            _ln_at(params, sd, f"{tp}.{si}.module.sequential.0",
                   f"{fp}/{ff}/LayerNorm_0")
            linear(f"{tp}.{si}.module.sequential.1.linear",
                   f"{fp}/{ff}/Dense_0")
            linear(f"{tp}.{si}.module.sequential.4.linear",
                   f"{fp}/{ff}/Dense_1")
        mh = f"{tp}.1.module"
        fmh = f"{fp}/MHSAModule_0"
        _ln_at(params, sd, f"{mh}.layer_norm", f"{fmh}/LayerNorm_0")
        att = f"{fmh}/RelativeMultiHeadAttention_0"
        linear(f"{mh}.attention.query_proj.linear", f"{att}/Dense_0")
        linear(f"{mh}.attention.key_proj.linear", f"{att}/Dense_1")
        linear(f"{mh}.attention.value_proj.linear", f"{att}/Dense_2")
        linear(f"{mh}.attention.pos_proj.linear", f"{att}/Dense_3",
               bias=False)
        linear(f"{mh}.attention.out_proj.linear", f"{att}/Dense_4")
        _set(params, f"{att}/u_bias", _np(sd, f"{mh}.attention.u_bias"))
        _set(params, f"{att}/v_bias", _np(sd, f"{mh}.attention.v_bias"))
        cv = f"{tp}.2.module.sequential"
        fcv = f"{fp}/_ConvModule_0"
        _ln_at(params, sd, f"{cv}.0", f"{fcv}/LayerNorm_0")
        # pointwise convs [out, in, 1] → Dense
        _set(params, f"{fcv}/Dense_0/kernel",
             _np(sd, f"{cv}.2.conv.weight")[:, :, 0].T)
        _set(params, f"{fcv}/Dense_0/bias", _np(sd, f"{cv}.2.conv.bias"))
        _conv1d_at(params, stats, sd, f"{cv}.4.conv", f"{fcv}/Conv_0")
        _bn_at(params, stats, sd, f"{cv}.5", f"{fcv}/BatchNorm_0")
        _set(params, f"{fcv}/Dense_1/kernel",
             _np(sd, f"{cv}.7.conv.weight")[:, :, 0].T)
        _set(params, f"{fcv}/Dense_1/bias", _np(sd, f"{cv}.7.conv.bias"))
        _ln_at(params, sd, f"{tp}.4", f"{fp}/LayerNorm_0")


def conformer_from_torch_state_dict(sd: Mapping, num_layers: int = 6,
                                    n_mels: int = 80):
    """Port a reference Conformer_ state dict (src/models/Conformer.py +
    the vendored conformer package): instance_norm, the conformer
    encoder (see _conformer_encoder_port), the ASP attention head +
    attention_norm, and the 1×1-conv fc. The dead ``asp``/``asp_bn``
    modules (created but bypassed in forward, Conformer.py:106-120) are
    skipped."""
    params: dict = {}
    stats: dict = {}

    _set(params, "inorm_scale", _np(sd, "instance_norm.weight"))
    _set(params, "inorm_bias", _np(sd, "instance_norm.bias"))
    _conformer_encoder_port(params, stats, sd, "conformer_block",
                            "ConformerEncoder_0", num_layers, n_mels)
    _conv1d_at(params, stats, sd, "attention.0", "Conv_0")
    _bn_at(params, stats, sd, "attention.2", "BatchNorm_0")
    _conv1d_at(params, stats, sd, "attention.3", "Conv_1")
    _bn_at(params, stats, sd, "attention_norm", "BatchNorm_1")
    _set(params, "Dense_0/kernel", _np(sd, "fc.conv.weight")[:, :, 0].T)
    if "fc.conv.bias" in sd:
        _set(params, "Dense_0/bias", _np(sd, "fc.conv.bias"))
    return params, stats


def ecapa_conformer_from_torch_state_dict(sd: Mapping, n_blocks: int = 4,
                                          res2net_scale: int = 8,
                                          num_layers: int = 16,
                                          encoder_input_dim: int = 1536):
    """Port a reference ECAPA_Conformer state dict
    (src/models/ECAPA_Conformer.py:40-192): the ECAPA trunk (GELU
    activation) reuses ecapa_from_torch_state_dict's mapping
    (blocks/mfa/asp/asp_bn/fc share names), the affine instance norm
    moves to ECAPAConformer's ``inorm_*`` params, and the 16-layer
    conformer encoder rides _conformer_encoder_port with the trunk's
    1536-dim features as the subsampled axis."""
    sd = {k: _np(sd, k) for k in sd}
    params, stats = ecapa_from_torch_state_dict(sd, n_blocks, res2net_scale)
    params["inorm_scale"] = params.pop("input_norm_scale")
    params["inorm_bias"] = params.pop("input_norm_bias")
    _conformer_encoder_port(params, stats, sd, "conformer_block",
                            "ConformerEncoder_0", num_layers,
                            encoder_input_dim)
    return params, stats


def _strip_reference_prefixes(sd: Mapping) -> dict:
    """Unwrap DDP/SpeakerEncoder prefixes from a reference checkpoint
    (src/model.py:24-33 WrappedModel ``module.``; ``__S__.`` backbone /
    ``__L__.`` loss; loadParameters tolerance, :718-746)."""
    out = {}
    for k, v in sd.items():
        k = k.removeprefix("module.")
        if k.startswith("__S__."):
            k = k.removeprefix("__S__.")
        if k.startswith("__L__.") or k.startswith("compute_features"):
            continue
        out[k] = v
    return out


_PORTERS = {
    "ECAPA_TDNN": lambda sd, a: ecapa_from_torch_state_dict(
        sd, n_blocks=a.n_blocks, res2net_scale=a.res2net_scale),
    "RawNet3": lambda sd, a: rawnet3_from_torch_state_dict(
        sd, model_scale=a.model_scale),
    "Raw3_ECAPA": lambda sd, a: raw3_ecapa_from_torch_state_dict(
        sd, model_scale=a.model_scale,
        ecapa_res2net_scale=a.res2net_scale),
    "ResNetSE34": lambda sd, a: resnetse_from_torch_state_dict(sd),
    "ResNetSE50": lambda sd, a: resnetse_from_torch_state_dict(
        sd, block="bottleneck"),
    # ResNetSE50V2's reference MainModel is broken (references
    # un-imported SEBottleneck, src/models/ResNetSE50V2.py:8) — were it
    # fixed as written it would be plain SEBottleneck, mapped here
    "ResNetSE50V2": lambda sd, a: resnetse_from_torch_state_dict(
        sd, block="bottleneck"),
    "ResNetSE100m2": lambda sd, a: resnetse_from_torch_state_dict(
        sd, layers=(6, 16, 24, 3), block="bottleneck"),
    "ResNetSE101": lambda sd, a: resnetse_from_torch_state_dict(
        sd, layers=(3, 4, 23, 3), block="bottleneck"),
    "ResNetSE152": lambda sd, a: resnetse_from_torch_state_dict(
        sd, layers=(3, 8, 36, 3), block="bottleneck"),
    "ResNetSE34V2": lambda sd, a: resnetse_from_torch_state_dict(
        sd, block="basicv2"),
    "RepVGG": lambda sd, a: repvgg_from_torch_state_dict(sd),
    "TitaNet": lambda sd, a: titanet_from_torch_state_dict(
        sd, n_mega_blocks=getattr(a, "n_mega_blocks", None)),
    "RawNet2": lambda sd, a: rawnet2_from_torch_state_dict(sd),
    "SCnet": lambda sd, a: scnet_from_torch_state_dict(sd),
    "EfficientNet": lambda sd, a: efficientnet_from_torch_state_dict(sd),
    "RawNeXt": lambda sd, a: rawnext_from_torch_state_dict(sd),
    "Conformer": lambda sd, a: conformer_from_torch_state_dict(sd),
    "ResNeXt": lambda sd, a: rawnext_from_torch_state_dict(sd, tree=False),
    "ECAPA_Conformer": lambda sd, a: ecapa_conformer_from_torch_state_dict(
        sd, n_blocks=a.n_blocks, res2net_scale=a.res2net_scale),
    "RawNet2_custom": lambda sd, a: rawnet2_custom_from_torch_state_dict(sd),
    "Raw_ECAPA": lambda sd, a: raw_ecapa2_from_torch_state_dict(
        sd, "sinc", "asp"),
    "Raw_ECAPA_sinc_asp": lambda sd, a: raw_ecapa2_from_torch_state_dict(
        sd, "sinc", "asp"),
    "Raw_ECAPA_conv_asp": lambda sd, a: raw_ecapa2_from_torch_state_dict(
        sd, "conv", "asp"),
    "Raw_ECAPA_sinc_gru": lambda sd, a: raw_ecapa2_from_torch_state_dict(
        sd, "sinc", "gru"),
    "Raw_ECAPA_hype": lambda sd, a: raw_ecapa_hype_from_torch_state_dict(sd),
    "Tita_ECAPA": lambda sd, a: tita_ecapa_from_torch_state_dict(sd),
    "Raw_tita": lambda sd, a: raw_tita_from_torch_state_dict(sd),
    "Res_ECAPA": lambda sd, a: res_ecapa_from_torch_state_dict(sd),
    "DPN": lambda sd, a: dpn_from_torch_state_dict(sd),
    "EfficientNetv2": lambda sd, a: effnetv2_from_torch_state_dict(sd),
}


def porter_args(**overrides) -> SimpleNamespace:
    """Family kwargs with the converter CLI's defaults."""
    base = dict(n_blocks=4, res2net_scale=8, model_scale=8,
                n_mega_blocks=None)
    base.update(overrides)
    return SimpleNamespace(**base)


def port_reference(sd: Mapping, arch: str,
                   **kw) -> Tuple[dict, dict]:
    """``(params, batch_stats)`` of a reference state dict (wrapper
    prefixes allowed; the loss head is left out) through the ``arch``
    porter, with ``kw`` over :func:`porter_args`'s defaults."""
    if arch not in _PORTERS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_PORTERS)}")
    return _PORTERS[arch](_strip_reference_prefixes(sd), porter_args(**kw))


def state_dict_from_reference(sd: Mapping, arch: str, *, like=None,
                              **kw) -> dict:
    """A port model's ``state_dict`` from a reference state dict: the
    ``arch`` porter, then ``weights.params_from_jax`` (``like``, a module
    or a ``state_dict``, makes it raise on a missing, extra or reshaped
    key). Load it with ``model.load_state_dict(sd, strict=True)``."""
    from speakerverification_tpu_torch.weights import params_from_jax

    params, stats = port_reference(sd, arch, **kw)
    return params_from_jax(params, stats, like=like)


def _main(argv=None) -> None:
    """Checkpoint converter CLI:

        python -m speakerverification_tpu_torch.compat.torch_port \\
            --arch ECAPA_TDNN --input best_state.pt --output best.msgpack

    Reads a reference torch checkpoint (full SpeakerEncoder state dict
    with ``module.``/``__S__.`` prefixes, or a bare MainModel dict),
    maps the backbone (and the margin-family loss head's class centers,
    ``__L__.weight``/``__L__.W``) onto the JAX layout, and writes a
    msgpack file that ``initial_model_infer:`` / ``load_params_only``
    consume directly, so both inference and a resumed training run keep
    the reference's trained weights. Beside it goes
    ``<output>.torch_shapes.json``, the torch keys and shapes that
    ``compat/torch_export.py --shapes`` inverts the conversion with."""
    import argparse
    import json
    from pathlib import Path

    from speakerverification_tpu_torch.checkpoint import msgpack_serialize
    from speakerverification_tpu_torch.utils.summary import count_params

    p = argparse.ArgumentParser(description=_main.__doc__)
    p.add_argument("--arch", required=True, choices=sorted(_PORTERS))
    p.add_argument("--input", required=True, help="reference .pt checkpoint")
    p.add_argument("--output", required=True, help="msgpack output path")
    p.add_argument("--n_blocks", type=int, default=4)
    p.add_argument("--res2net_scale", type=int, default=8)
    p.add_argument("--model_scale", type=int, default=8)
    p.add_argument("--n_mega_blocks", type=int, default=None,
                   help="TitaNet only; default auto-detects from the "
                        "state dict's mega-block depth")
    args = p.parse_args(argv)

    sd = read_reference_checkpoint(args.input)
    # keep the loss-head entries before stripping: margin heads store
    # their class centers as __L__.weight ([nClasses, nOut], AAmSoftmax)
    # or __L__.W ([nOut, nClasses], AmSoftmax) — the names the heads
    # use, so resuming training keeps the trained class centers
    loss_params = {
        k.removeprefix("module.").removeprefix("__L__."): _np(sd, k)
        for k in sd
        if k.removeprefix("module.").startswith("__L__.")}
    sd = _strip_reference_prefixes(sd)
    params, stats = _PORTERS[args.arch](sd, args)
    tree = {"params": {"backbone": params}, "batch_stats":
            {"backbone": stats}}
    ported_head = {k: v for k, v in loss_params.items()
                   if k in ("weight", "W")}
    if ported_head:
        tree["params"]["loss"] = ported_head
    if set(loss_params) - set(ported_head):
        print(f"note: loss-head entries not ported (unknown layout): "
              f"{sorted(set(loss_params) - set(ported_head))[:5]}")
    out = Path(args.output)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_bytes(msgpack_serialize(tree))
    (out.parent / (out.name + ".torch_shapes.json")).write_text(
        json.dumps({k: list(_np(sd, k).shape) for k in sd}, indent=0))
    n = count_params(tree["params"])
    print(f"wrote {out} ({n:,} params, arch {args.arch}"
          f"{', loss head ported' if ported_head else ''})")


if __name__ == "__main__":
    _main()
