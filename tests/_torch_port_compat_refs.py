"""Reference-layout state dicts for the checkpoint-converter tests.

The reference's torch modules are not in this repository, so the tests
make their state-dict layout themselves. The JAX package's forward
porters (``speakerverification_tpu/compat/torch_port.py``) are the
judge of that layout: :func:`make_manifest` runs a porter on probe
values that record which torch key each flax leaf is read from and
through which layout operations (transpose, ``.T``, indexing,
``reshape(-1)``), and inverts those operations on the flax leaf's shape
(from ``jax.eval_shape`` of the JAX model's init) to get the torch
key's shape. A key the porter asks about with ``in`` counts as present
until a write lands on a flax path the model lacks; then the last such
key is taken back and the porter runs again. The GRU (whose porter
slices by the hidden size) is written out from the flax tree directly.

``tests/test_torch_port_compat.py`` proves each manifest: JAX's porter,
fed arrays of the manifest's shapes, yields exactly the keys and shapes
of the model's ``jax.eval_shape``. Run as a script, this module writes
``tests/data/torch_port_manifests.json`` (every arch at its test widths,
which the reverse-port tests read) and
``tests/data/raw3_ecapa.torch_shapes.json``, the full-width
``Raw3_ECAPA`` of ``yaml/raw3_ecapa.yaml`` that ``chip_smoke.py``'s
path P builds its reference checkpoint from:

    JAX_PLATFORMS=cpu python tests/_torch_port_compat_refs.py
"""

from __future__ import annotations

import contextlib
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

MEL = "melspectrogram"

# arch -> (model kwargs, frontend, porter_args overrides, backbone
# overrides). Widths are cut where the builder takes them, or else by
# overriding the backbone's fields (a flax ``clone`` in JAX, the port's
# class built with the same fields); depths are the ones each porter
# assumes.
_SE = dict(num_filters=(4, 8, 8, 16), att_dim=8)
ARCHS = {
    "ECAPA_TDNN": (dict(nOut=48, channels=(32, 32, 32, 32, 96),
                        attention_channels=16, se_channels=16,
                        res2net_scale=4), MEL, dict(res2net_scale=4), {}),
    "RawNet3": (dict(nOut=48, C=64, model_scale=8, context_dim=96), "raw",
                dict(), {}),
    "Raw3_ECAPA": (dict(nOut=512, C=128), "raw", dict(), {}),
    "ResNetSE34": (dict(nOut=48), MEL, dict(), _SE),
    "ResNetSE50": (dict(nOut=48), MEL, dict(), _SE),
    "ResNetSE50V2": (dict(nOut=48), MEL, dict(), _SE),
    "ResNetSE100m2": (dict(nOut=48), MEL, dict(), _SE),
    "ResNetSE101": (dict(nOut=48), MEL, dict(), _SE),
    "ResNetSE152": (dict(nOut=48), MEL, dict(), _SE),
    "ResNetSE34V2": (dict(nOut=48), MEL, dict(), _SE),
    "RepVGG": (dict(nOut=48), MEL, dict(),
               dict(width=(0.125, 0.125, 0.125, 0.25))),
    "TitaNet": (dict(nOut=48, model_size="s"), MEL, dict(),
                dict(hidden_size=32, encoder_output_size=96,
                     attention_hidden_size=16)),
    "RawNet2": (dict(nOut=48), "raw", dict(), {}),
    "SCnet": (dict(nOut=48), MEL, dict(), {}),
    "EfficientNet": (dict(nOut=48), MEL, dict(), dict(width_coeff=0.25)),
    "RawNeXt": (dict(nOut=48), "raw", dict(),
                dict(channels=(32, 32, 64, 64, 64, 64))),
    "Conformer": (dict(nOut=48, encoder_dim=32), MEL, dict(), {}),
    "ResNeXt": (dict(nOut=48), "raw", dict(),
                dict(channels=(32, 32, 64, 64, 64, 64))),
    "ECAPA_Conformer": (dict(nOut=48), MEL, dict(), dict(encoder_dim=16)),
    "RawNet2_custom": (dict(nOut=48, att_dim=16), "raw", dict(), {}),
    "Raw_ECAPA": (dict(nOut=256), "raw", dict(), {}),
    "Raw_ECAPA_sinc_asp": (dict(nOut=256), "raw", dict(), {}),
    "Raw_ECAPA_conv_asp": (dict(nOut=256), "raw", dict(), {}),
    "Raw_ECAPA_sinc_gru": (dict(nOut=256), "raw", dict(), {}),
    "Raw_ECAPA_hype": (dict(nOut=256), "raw", dict(), {}),
    "Tita_ECAPA": (dict(nOut=256), "raw", dict(), {}),
    "Raw_tita": (dict(nOut=256), "raw", dict(), {}),
    "Res_ECAPA": (dict(nOut=48), MEL, dict(), dict(num_filters=(4, 8))),
    "DPN": (dict(nOut=48, k_r=32, groups=8, inc_sec=(8, 8, 8, 16),
                 num_init_features=16), MEL, dict(), {}),
    "EfficientNetv2": (dict(nOut=48, width_mult=0.25), MEL, dict(), {}),
}


def hparams(arch: str, model_kw: dict | None = None,
            features: str | None = None) -> dict:
    """``yaml/ecapa_tdnn.yaml``'s keys with the model swapped for
    ``arch`` at its test widths."""
    from speakerverification_tpu_torch.config import read_config

    kw, feat, _, _ = ARCHS.get(arch, ({}, MEL, {}, {}))
    kw = dict(kw if model_kw is None else model_kw)
    feat = features or feat
    h = read_config(ROOT / "yaml" / "ecapa_tdnn.yaml")
    return {**h, "features": feat,
            "model": {"name": arch, "feature_type": feat, **kw}}


def porter_kw(arch: str) -> dict:
    return dict(ARCHS[arch][2])


def jax_encoder(h: dict, overrides: dict | None = None):
    """The JAX package's embedding ``SpeakerEncoder`` of ``h``, its
    backbone's fields overridden by a flax ``clone``."""
    from speakerverification_tpu import builder as JB

    jm = JB.encoder_from_hparams(h, with_loss=False, num_devices=1)
    if overrides:
        jm = jm.clone(backbone=jm.backbone.clone(**overrides))
    return jm


def port_encoder(h: dict, overrides: dict | None = None):
    """The port's ``SpeakerEncoder`` of ``h``; with ``overrides`` its
    backbone is the port class built from the JAX backbone's fields."""
    import inspect

    from speakerverification_tpu_torch import builder as TB

    model = TB.encoder_from_hparams(h)
    if overrides:
        jb = jax_encoder(h, overrides).backbone
        cls = type(model.backbone)
        names = inspect.signature(cls.__init__).parameters
        model.backbone = cls(**{n: getattr(jb, n) for n in names
                                if n != "self" and hasattr(jb, n)})
    return model


def arch_encoders(arch: str):
    h = hparams(arch)
    return h, ARCHS[arch][3]


def jax_init_shapes(h: dict, overrides: dict | None = None
                    ) -> tuple[dict, dict]:
    """``(params, batch_stats)`` of the JAX backbone as nested dicts of
    shape tuples, traced with ``jax.eval_shape`` (nothing compiled)."""
    import jax
    import jax.numpy as jnp

    from speakerverification_tpu_torch.data.audio import AudioSpec

    T = AudioSpec(h["audio_spec"]).max_audio
    jm = jax_encoder(h, overrides)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((2, 2, T)))

    def plain(node):
        if hasattr(node, "items"):
            return {str(k): plain(v) for k, v in node.items()}
        return tuple(node.shape)

    return (plain(shapes["params"]["backbone"]),
            plain(shapes.get("batch_stats", {}).get("backbone", {})))


def leaf_shapes(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(leaf_shapes(v, path))
        else:
            out[path] = tuple(np.shape(v)) if not isinstance(v, tuple) \
                else v
    return out


# ----------------------------------------------------------------------
# probing the JAX porters
# ----------------------------------------------------------------------
class _Probe:
    """A torch value that records the layout operations applied to it."""

    def __init__(self, key, ops=()):
        self.key, self.ops = key, ops

    def _with(self, op):
        return _Probe(self.key, self.ops + (op,))

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], tuple):
            axes = axes[0]
        return self._with(("transpose", axes))

    @property
    def T(self):
        return self._with(("T",))

    def __getitem__(self, idx):
        return self._with(("index", idx if isinstance(idx, tuple)
                           else (idx,)))

    def reshape(self, *shape):
        return self._with(("reshape", shape))

    def copy(self):
        return self


# reshape(-1) hides the torch rank: these keys are [n, 1] in the
# reference (asteroid's / SincConv_fast's cutoffs, AFMS's alpha)
_COLUMN_SUFFIXES = ("low_hz_", "band_hz_", ".alpha")


def _torch_shape(probe: _Probe, shape: tuple) -> tuple:
    shape = tuple(shape)
    for op in reversed(probe.ops):
        if op[0] == "T":
            shape = shape[::-1]
        elif op[0] == "transpose":
            prev = [0] * len(op[1])
            for i, a in enumerate(op[1]):
                prev[a] = shape[i]
            shape = tuple(prev)
        elif op[0] == "index":
            prev, j = [], 0
            for e in op[1]:
                if isinstance(e, int):
                    prev.append(1)
                else:
                    prev.append(shape[j])
                    j += 1
            shape = tuple(prev) + shape[j:]
        elif op[0] == "reshape":
            assert op[1] in ((-1,),), op
            n = int(np.prod(shape))
            shape = (n, 1) if probe.key.endswith(_COLUMN_SUFFIXES) else (n,)
        else:
            raise AssertionError(op)
    return shape


class _Restart(Exception):
    pass


class _LazySD(dict):
    """A state dict whose keys appear as the porter reads them; ``in``
    answers yes to an unknown key until the write it leads to misses the
    model (then the key is taken back)."""

    def __init__(self, run):
        super().__init__()
        self.run = run
        for k in run.known:
            dict.__setitem__(self, k, run.value(k))

    def __contains__(self, k):
        run = self.run
        if k in run.absent:
            return False
        if dict.__contains__(self, k) and k not in run.assumed:
            return True
        run.tentative.append(k)
        run.assumed.add(k)
        run.known.add(k)
        dict.__setitem__(self, k, run.value(k))
        return True

    def __missing__(self, k):
        self.run.known.add(k)
        v = self.run.value(k)
        dict.__setitem__(self, k, v)
        return v

    def __getitem__(self, k):
        if not dict.__contains__(self, k):
            return self.__missing__(k)
        return dict.__getitem__(self, k)

    def get(self, k, default=None):
        return self[k] if k in self else default


class _NpShim:
    """``numpy`` for the porter module, passing probes through
    ``asarray``."""

    def __getattr__(self, name):
        return getattr(np, name)

    @staticmethod
    def asarray(x, *a, **k):
        return x if isinstance(x, _Probe) else np.asarray(x, *a, **k)


class _Run:
    def __init__(self, target_params, target_stats, hints=None, seeds=()):
        self.tp = leaf_shapes(target_params)
        self.ts = leaf_shapes(target_stats)
        self.hints = dict(hints or {})
        self.known = set(seeds) | set(self.hints)
        self.absent: set = set()
        self.tentative: list = []
        self.assumed: set = set()
        self.writes: dict = {}
        self.grus: list = []

    def value(self, k):
        if k in self.hints:
            return np.zeros(self.hints[k], np.float32)
        return _Probe(k)


@contextlib.contextmanager
def _patched(run, P):
    saved = {n: getattr(P, n) for n in ("_np", "_set", "np", "_gru_at")}

    def _np(sd, key):
        if key in run.hints:
            return np.zeros(run.hints[key], np.float32)
        if not isinstance(sd, _LazySD) and key not in sd:
            raise KeyError(key)
        run.known.add(key)
        return _Probe(key)

    def _set(tree, path, value):
        if path not in run.tp and path not in run.ts:
            if not run.tentative:
                raise AssertionError(f"porter writes {path}, which the "
                                     "model lacks")
            k = run.tentative.pop()
            run.known.discard(k)
            run.assumed.discard(k)
            run.absent.add(k)
            raise _Restart(k)
        if isinstance(value, _Probe):
            run.writes[path] = value
        saved["_set"](tree, path, value)

    def _gru_at(params, sd, tkey, fkey):
        run.grus.append((tkey, fkey))

    P._np, P._set, P.np, P._gru_at = _np, _set, _NpShim(), _gru_at
    try:
        yield
    finally:
        for n, v in saved.items():
            setattr(P, n, v)


def _probe_porter(fn, target_params, target_stats, hints=None, seeds=(),
                  bias_seeds=False) -> dict:
    """The torch keys and shapes that ``fn(sd)`` reads to build the
    given flax trees."""
    from speakerverification_tpu.compat import torch_port as P

    run = _Run(target_params, target_stats, hints, seeds)
    for _ in range(100000):
        run.tentative, run.writes, run.grus = [], {}, []
        try:
            with _patched(run, P):
                fn(_LazySD(run))
        except _Restart:
            continue
        except KeyError as e:
            key = e.args[0]
            if key in run.known:
                raise
            run.known.add(key)
            continue
        if bias_seeds:
            # a plain-dict porter only sees a bias it is given: a
            # kernel read from K.weight whose flax sibling has a bias
            new = {w.key[:-len("weight")] + "bias"
                   for path, w in run.writes.items()
                   if path.endswith("/kernel") and w.key.endswith(".weight")
                   and path[:-len("kernel")] + "bias" in run.tp}
            if not new <= run.known:
                run.known |= new
                continue
        break
    else:
        raise AssertionError("the porter probe does not settle")

    out = {}
    for path, probe in run.writes.items():
        shape = run.tp.get(path, run.ts.get(path))
        out[probe.key] = list(_torch_shape(probe, shape))
    for key, shape in run.hints.items():
        out[key] = list(shape)
    for tkey, fkey in run.grus:
        base, layer = fkey.rsplit("_", 1)[0], 0
        while True:
            fk = fkey if layer == 0 else f"{base}_{layer}"
            if f"{fk}/ir/kernel" not in run.tp:
                break
            n_in, H = run.tp[f"{fk}/ir/kernel"]
            out[f"{tkey}.weight_ih_l{layer}"] = [3 * H, n_in]
            out[f"{tkey}.weight_hh_l{layer}"] = [3 * H, H]
            out[f"{tkey}.bias_ih_l{layer}"] = [3 * H]
            out[f"{tkey}.bias_hh_l{layer}"] = [3 * H]
            layer += 1
    for key in list(out):
        if key.endswith(".running_mean"):
            out[key[:-len("running_mean")] + "num_batches_tracked"] = []
    return out


def _ecapa_keys(p, s, res2net_scale=None, rename_inorm=False):
    """The ECAPA trunk's keys (the porter reads a plain dict: its
    optional keys are seeded from the flax tree)."""
    from speakerverification_tpu.compat import torch_port as P

    p = dict(p)
    if rename_inorm:
        p = {("input_norm_" + k[len("inorm_"):] if k.startswith("inorm_")
              else k): v for k, v in p.items()
             if not k.startswith("ConformerEncoder")}
    n_blocks = 1 + sum(1 for k in p if k.startswith("SERes2NetBlock_"))
    if res2net_scale is None:
        res2net_scale = 1 + sum(
            1 for k in p["SERes2NetBlock_0"]["Res2NetBlock_0"])
    seeds = set()
    for i in range(1, n_blocks):
        if "Conv1d_0" in p[f"SERes2NetBlock_{i - 1}"]:
            seeds.add(f"blocks.{i}.shortcut.conv.weight")
    if "bias" in p.get("Dense_0", {}):
        seeds.add("fc.conv.bias")
    if "input_norm_scale" in p:
        seeds |= {"instance_norm.weight", "instance_norm.bias"}
    return _probe_porter(
        lambda sd: P.ecapa_from_torch_state_dict(sd, n_blocks,
                                                 res2net_scale),
        p, s, seeds=seeds, bias_seeds=True)


def _prefixed(prefix, keys):
    return {prefix + k: v for k, v in keys.items()}


def _conformer_hints(p, tenc, enc):
    w = p[enc]["Dense_0"]["kernel"]
    return {f"{tenc}.input_projection.0.linear.weight": [w[1], w[0]]}


def _counts(p, stem):
    return sum(1 for k in p if k.startswith(stem))


def make_manifest(arch: str, params: dict, stats: dict,
                  model_kw: dict | None = None) -> dict:
    """``{torch key: shape}`` of ``arch``'s reference state dict (wrapper
    prefixes stripped, as the converter CLI writes its manifest) for the
    flax trees ``params``/``batch_stats`` (of shape tuples)."""
    from speakerverification_tpu.compat import torch_port as P

    kw = {} if model_kw is None else dict(model_kw)
    if model_kw is None and arch in ARCHS:
        kw = {**ARCHS[arch][0], **ARCHS[arch][3]}
    pa = P.__dict__  # the unpatched porters (their helpers are patched)

    def base(fn, p=params, s=stats, **k):
        return _probe_porter(fn, p, s, **k)

    def raw2c(p, s, front, agg):
        groups = kw.get("layers", (1, 1, 1, 2, 1, 2))
        return base(lambda sd: pa["rawnet2_custom_from_torch_state_dict"](
            sd, layers=tuple(groups), front_proc=front, aggregate=agg),
            p, s)

    def titanet(p, s):
        return base(lambda sd: pa["titanet_from_torch_state_dict"](
            sd, n_mega_blocks=_counts(p, "MegaBlock_")), p, s)

    def sub(name):
        return params[name], stats.get(name, {})

    if arch == "ECAPA_TDNN":
        out = _ecapa_keys(params, stats)
    elif arch == "RawNet3":
        out = base(lambda sd: pa["rawnet3_from_torch_state_dict"](
            sd, model_scale=kw.get("model_scale", 8)))
        out["preprocess.0.flipped_filter"] = [1, 1, 2]
    elif arch == "Raw3_ECAPA":
        r = base(lambda sd: pa["rawnet3_from_torch_state_dict"](sd),
                 *sub("raw_branch"))
        r["preprocess.0.flipped_filter"] = [1, 1, 2]
        out = {**_prefixed("ECAPA_TDNN.", _ecapa_keys(*sub("ecapa"))),
               **_prefixed("rawnet.", r)}
    elif arch.startswith("ResNetSE"):
        block, layers = {
            "ResNetSE34": ("basic", (3, 4, 6, 3)),
            "ResNetSE34V2": ("basicv2", (3, 4, 6, 3)),
            "ResNetSE50": ("bottleneck", (3, 4, 6, 3)),
            "ResNetSE50V2": ("bottleneck", (3, 4, 6, 3)),
            "ResNetSE100m2": ("bottleneck", (6, 16, 24, 3)),
            "ResNetSE101": ("bottleneck", (3, 4, 23, 3)),
            "ResNetSE152": ("bottleneck", (3, 8, 36, 3))}[arch]
        out = base(lambda sd: pa["resnetse_from_torch_state_dict"](
            sd, layers=layers, block=block))
    elif arch == "RepVGG":
        out = base(lambda sd: pa["repvgg_from_torch_state_dict"](sd))
    elif arch == "TitaNet":
        out = titanet(params, stats)
    elif arch == "RawNet2":
        out = base(lambda sd: pa["rawnet2_from_torch_state_dict"](sd))
    elif arch == "SCnet":
        out = base(lambda sd: pa["scnet_from_torch_state_dict"](sd))
    elif arch == "EfficientNet":
        out = base(lambda sd: pa["efficientnet_from_torch_state_dict"](sd))
    elif arch in ("RawNeXt", "ResNeXt"):
        out = base(lambda sd: pa["rawnext_from_torch_state_dict"](
            sd, tree=arch == "RawNeXt"))
    elif arch == "Conformer":
        out = base(lambda sd: pa["conformer_from_torch_state_dict"](sd),
                   hints=_conformer_hints(params, "conformer_block",
                                          "ConformerEncoder_0"))
    elif arch == "ECAPA_Conformer":
        out = _ecapa_keys(params, stats, rename_inorm=True)
        out.update(base(lambda sd: pa["_conformer_encoder_port"](
            {}, {}, sd, "conformer_block", "ConformerEncoder_0",
            _counts(params["ConformerEncoder_0"], "ConformerBlock_"), 1536),
            hints=_conformer_hints(params, "conformer_block",
                                   "ConformerEncoder_0")))
    elif arch == "RawNet2_custom":
        out = raw2c(params, stats, kw.get("front_proc", "sinc"),
                    kw.get("aggregate", "gru"))
    elif arch.startswith("Raw_ECAPA"):
        front, agg = {"Raw_ECAPA": ("sinc", "asp"),
                      "Raw_ECAPA_sinc_asp": ("sinc", "asp"),
                      "Raw_ECAPA_conv_asp": ("conv", "asp"),
                      "Raw_ECAPA_sinc_gru": ("sinc", "gru"),
                      "Raw_ECAPA_hype": ("sinc", "gru")}[arch]
        out = {**_prefixed("ECAPA_TDNN.", _ecapa_keys(*sub("ecapa"))),
               **_prefixed("rawnet2v2.", raw2c(*sub("raw_branch"), front,
                                                agg))}
        if arch == "Raw_ECAPA_hype":
            top_p = {k: v for k, v in params.items()
                     if k not in ("ecapa", "raw_branch")}
            top_s = {k: v for k, v in stats.items()
                     if k not in ("ecapa", "raw_branch")}
            saved = pa["raw_ecapa2_from_torch_state_dict"]
            P.raw_ecapa2_from_torch_state_dict = lambda *a, **k: ({}, {})
            try:
                out.update(base(
                    lambda sd: pa["raw_ecapa_hype_from_torch_state_dict"](sd),
                    top_p, top_s))
            finally:
                P.raw_ecapa2_from_torch_state_dict = saved
    elif arch == "Tita_ECAPA":
        out = {**_prefixed("ECAPA_TDNN.", _ecapa_keys(*sub("ecapa"))),
               **_prefixed("titaNet.", titanet(*sub("titanet")))}
    elif arch == "Raw_tita":
        out = {**_prefixed("titaNet.", titanet(*sub("titanet"))),
               **_prefixed("RawNet.", raw2c(*sub("raw_branch"), "sinc",
                                             "asp"))}
    elif arch == "Res_ECAPA":
        top_p = {k: v for k, v in params.items() if k != "ECAPA_TDNN_0"}
        top_s = {k: v for k, v in stats.items() if k != "ECAPA_TDNN_0"}
        saved = pa["ecapa_from_torch_state_dict"]
        P.ecapa_from_torch_state_dict = lambda *a, **k: ({}, {})
        try:
            out = base(lambda sd: pa["res_ecapa_from_torch_state_dict"](
                sd, layers=tuple(kw.get("num_layers", (2, 2)))),
                top_p, top_s)
        finally:
            P.ecapa_from_torch_state_dict = saved
        out.update(_prefixed("1.", _ecapa_keys(*sub("ECAPA_TDNN_0"))))
    elif arch == "DPN":
        out = base(lambda sd: pa["dpn_from_torch_state_dict"](sd))
    elif arch == "EfficientNetv2":
        out = base(lambda sd: pa["effnetv2_from_torch_state_dict"](sd))
    else:
        raise KeyError(arch)
    return dict(sorted(out.items()))


# ----------------------------------------------------------------------
# values
# ----------------------------------------------------------------------
def reference_arrays(manifest: dict, seed: int) -> dict:
    """Seeded float32 values of the manifest's shapes: weights of rank ≥ 2
    scaled by their fan-in, norm scales near 1, BatchNorm variances
    positive, ``num_batches_tracked`` int64 zeros, the
    pre-emphasis filter its constant."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, shape in manifest.items():
        if k.endswith("num_batches_tracked"):
            out[k] = np.zeros(shape, np.int64)
        elif k.endswith("flipped_filter"):
            out[k] = np.array([-0.97, 1.0], np.float32).reshape(shape)
        elif k.endswith("running_var"):
            out[k] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        elif len(shape) >= 2:      # fan-in scaled: deep nets stay finite
            std = 1.0 / np.sqrt(np.prod(shape[1:]))
            out[k] = (rng.standard_normal(shape) * std).astype(np.float32)
        elif k.endswith(".weight"):    # norm scales
            out[k] = (1 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        else:
            out[k] = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    return out


def wrapped(sd: dict, head: np.ndarray | None = None) -> dict:
    """A reference training checkpoint's layout: ``module.__S__.`` on the
    backbone, ``module.__L__.weight`` for a margin head's centres."""
    import torch

    out = {f"module.__S__.{k}": torch.from_numpy(
        np.ascontiguousarray(v).reshape(np.shape(v))) for k, v in sd.items()}
    if head is not None:
        out["module.__L__.weight"] = torch.from_numpy(head)
    return out


MANIFESTS = ROOT / "tests" / "data" / "torch_port_manifests.json"
FULL_WIDTH = ROOT / "tests" / "data" / "raw3_ecapa.torch_shapes.json"


def small_manifests() -> dict:
    """The committed ``{arch: manifest}`` of :data:`ARCHS` at their test
    widths (``tests/test_torch_port_compat.py`` proves each)."""
    return json.loads(MANIFESTS.read_text())


def _write_manifests() -> list:
    from speakerverification_tpu_torch.config import read_config

    small = {}
    for arch in sorted(ARCHS):
        h, over = arch_encoders(arch)
        small[arch] = make_manifest(arch, *jax_init_shapes(h, over))
    MANIFESTS.parent.mkdir(parents=True, exist_ok=True)
    MANIFESTS.write_text(json.dumps(small, separators=(",", ":"),
                                    sort_keys=True) + "\n")
    h = read_config(ROOT / "yaml" / "raw3_ecapa.yaml")
    full = make_manifest("Raw3_ECAPA", *jax_init_shapes(h), model_kw={})
    FULL_WIDTH.write_text(json.dumps(full, indent=0) + "\n")
    return [MANIFESTS, FULL_WIDTH]


if __name__ == "__main__":
    import os

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    print(*_write_manifests(), sep="\n")
