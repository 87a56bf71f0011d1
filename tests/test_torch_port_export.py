"""``--do_export`` in the port (``export.py``) against the JAX package's,
and K1 and K2 as registered operators, on the CPU at small widths.

* A small ``Raw3_ECAPA`` and a small ``ECAPA_TDNN`` export with the
  kernels' routes selected (``frontend_backend`` and ``conv_backend``
  ``pallas``): the graph holds one ``mel_frontend`` node and three
  ``res2net_cascade`` nodes, and the replay and ``load_exported`` give
  the live engine's embeddings within rtol 1e-4, atol 1e-5 (JAX's
  self-check tolerance).
* The port's ``params.msgpack``, read by ``flax.serialization`` and run
  through the JAX engine, gives the port's embeddings within 1e-4.
* ``config.json`` equals JAX's ``export_model`` output key for key.
* A bf16 export (``mixedprec``) replays the live bf16 engine bit for bit.
* Every yaml of ``yaml/`` exports, at a small width and short crops.
* ``quant: int8``: JAX's ``export_model`` fails with ``TypeError``; the
  port refuses by name (ROADMAP C.15). ONNX is refused in both.
* ``torch.library.opcheck`` of both operators on CPU tensors, and
  ``FlopCounterMode`` counts the same work through each operator as
  through the plain path.
"""

import json
from pathlib import Path

import flax.serialization as fser
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from speakerverification_tpu import export as jexport
from speakerverification_tpu.inference import InferenceEngine as JEngine
from speakerverification_tpu_torch import export as texport
from speakerverification_tpu_torch.config import read_config
from speakerverification_tpu_torch.inference import InferenceEngine
from speakerverification_tpu_torch.models.layers import Res2NetBlock
from speakerverification_tpu_torch.ops import mel_frontend as mf
from speakerverification_tpu_torch.ops import res2net_cascade as rc
from speakerverification_tpu_torch.ops.frontend import (
    FrontendConfig,
    make_frontend,
    mel_constants,
    pre_emphasis,
    reflect_pad,
    window_rows,
)

ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-4, 1e-5
OPS = ("speakerverification_tpu_torch.mel_frontend.default",
       "speakerverification_tpu_torch.res2net_cascade.default")

SMALL = {
    "Raw3_ECAPA": {"name": "Raw3_ECAPA", "feature_type": "raw", "nOut": 256,
                   "C": 64},
    "ECAPA_TDNN": {"name": "ECAPA_TDNN", "feature_type": "melspectrogram",
                   "nOut": 32, "channels": [64, 64, 64, 64, 192]},
}


def _hparams(tmp_path, model, sr=8000, seconds=0.5, **extra):
    return {"seed": 3, "save_folder": str(tmp_path / "save"),
            "audio_spec": {"sample_rate": sr, "sentence_len": seconds,
                           "win_len": 0.025, "hop_len": 0.01},
            "n_mels": 40, "features": model["feature_type"],
            "model": {**model, "conv_backend": "pallas"},
            "frontend_backend": "pallas", "num_eval": 3, "nClasses": 6,
            "criterion": {"name": "AAmSoftmax"}, **extra}


def _randomize_bn(model, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                n = m.num_features
                m.running_mean.copy_(0.1 * torch.randn(n, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(n, generator=gen))
                m.weight.copy_(0.8 + 0.4 * torch.rand(n, generator=gen))
                m.bias.copy_(0.1 * torch.randn(n, generator=gen))


def _xla(h):
    """``h`` with the plain routes: the JAX package runs its Pallas
    kernels on the CPU only in interpret mode, which its engine does not
    select."""
    return {**h, "frontend_backend": "xla",
            "model": {**h["model"], "conv_backend": "xla"}}


def _weights(tmp_path, h):
    """A ``.pt`` of the seeded model with random BN statistics."""
    engine = InferenceEngine(h, device="cpu")
    _randomize_bn(engine.model, 5)
    path = tmp_path / "weights.pt"
    torch.save(engine.model.state_dict(), path)
    return str(path)


def _op_counts(program):
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    return {op: targets.count(op) for op in OPS}


def _waves(h, seed=0):
    n = h["num_eval"]
    T = int(h["audio_spec"]["sentence_len"] * h["audio_spec"]["sample_rate"])
    return np.random.default_rng(seed).normal(0, 0.1, (n, T)).astype(
        np.float32)


@pytest.fixture(scope="module", params=sorted(SMALL))
def exported(request, tmp_path_factory):
    torch.set_num_threads(2)
    tmp = tmp_path_factory.mktemp(request.param)
    h = _hparams(tmp, SMALL[request.param])
    h["initial_model_infer"] = _weights(tmp, h)
    return h, texport.export_model(h, device="cpu")


def test_export_writes_the_artifacts_with_the_kernel_ops(exported):
    h, out = exported
    assert set(out) == {"dir", "params", "program", "config"}
    assert {p.name for p in Path(out["dir"]).iterdir()} == {
        "params.msgpack", "config.json", "model.pt2"}
    program = torch.export.load(out["program"])
    assert _op_counts(program) == {OPS[0]: 1, OPS[1]: 3}
    sig = program.graph_signature.user_inputs
    assert len(sig) == 1
    wave = [n for n in program.graph.nodes if n.name == sig[0]][0]
    assert tuple(wave.meta["val"].shape) == _waves(h).shape


def test_replay_and_load_exported_match_the_live_engine(exported):
    h, out = exported
    live = InferenceEngine(h, device="cpu")
    for seed in (0, 1):
        x = _waves(h, seed)
        ref = live.embed_fn(x).numpy()
        got = texport.load_exported(out["dir"])(x).numpy()
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
        replay = torch.export.load(out["program"]).module()(
            torch.from_numpy(x)).detach().numpy()
        np.testing.assert_allclose(replay, ref, rtol=RTOL, atol=ATOL)


def test_params_msgpack_runs_in_the_jax_engine(exported, tmp_path):
    h, out = exported
    jh = {**_xla(h), "save_folder": str(tmp_path / "jax")}
    jh.pop("initial_model_infer")
    jeng = JEngine(jh)
    target = {"params": {k: v for k, v in jeng.state.params.items()
                         if k != "loss"},
              "batch_stats": jeng.state.batch_stats}
    tree = fser.from_bytes(target, Path(out["params"]).read_bytes())
    params = {**tree["params"], "loss": jeng.state.params["loss"]}
    x = _waves(h, 2)
    ref = np.asarray(jeng._embed(params, tree["batch_stats"], x))
    got = texport.load_exported(out["dir"])(x).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_bf16_export_replays_the_live_bf16_engine(tmp_path):
    """``mixedprec``: the program runs the cascade's bf16 route and gives
    the live bf16 engine's embeddings bit for bit."""
    torch.set_num_threads(2)
    h = {**_hparams(tmp_path, SMALL["ECAPA_TDNN"]), "mixedprec": True}
    out = texport.export_model(h, device="cpu")
    assert _op_counts(torch.export.load(out["program"])) == {
        OPS[0]: 1, OPS[1]: 3}
    x = _waves(h, 4)
    ref = InferenceEngine(h, device="cpu").embed_fn(x).numpy()
    np.testing.assert_array_equal(texport.load_exported(out["dir"])(x)
                                  .numpy(), ref)


def test_config_json_equals_jax(tmp_path):
    h = _xla(_hparams(tmp_path, SMALL["ECAPA_TDNN"]))
    ours = texport.export_model(h, out_dir=tmp_path / "port", device="cpu")
    theirs = jexport.export_model(h, out_dir=tmp_path / "jax")
    a = json.loads(Path(ours["config"]).read_text())
    b = json.loads(Path(theirs["config"]).read_text())
    assert list(a) == list(b)
    for key in b:
        assert a[key] == b[key], key


def test_int8_export_refused_by_name_where_jax_fails(tmp_path):
    h = {**_xla(_hparams(tmp_path, SMALL["ECAPA_TDNN"])), "quant": "int8"}
    with pytest.raises(TypeError):
        jexport.export_model(h, out_dir=tmp_path / "jax")
    with pytest.raises(NotImplementedError, match="C.15"):
        texport.export_model(h, out_dir=tmp_path / "port", device="cpu")
    assert not (tmp_path / "port").exists()


def test_onnx_refused():
    with pytest.raises(RuntimeError, match="export_model"):
        texport.export_onnx({})


YAMLS = sorted(p.name for p in (ROOT / "yaml").glob("*.yaml"))
# the width knobs each builder takes, cut small
NARROW = {"ECAPA_TDNN": {"channels": [64, 64, 64, 64, 192]},
          "Raw3_ECAPA": {"C": 64},
          "Conformer": {"encoder_dim": 64, "num_layers": 2}}
HYBRIDS = ("Raw3_ECAPA", "Raw_ECAPA", "Raw_ECAPA_conv_asp",
           "Raw_ECAPA_sinc_gru", "Raw_ECAPA_sinc_asp", "Raw_ECAPA_hype")


def test_every_yaml_is_listed():
    assert len(YAMLS) == 12


@pytest.mark.parametrize("name", YAMLS)
def test_every_yaml_exports_at_a_small_width(name, tmp_path):
    torch.set_num_threads(2)
    h = read_config(ROOT / "yaml" / name)
    model = h["model"]["name"]
    sr = int(h["audio_spec"]["sample_rate"])
    h = {**h, "save_folder": str(tmp_path / "save"), "num_eval": 2,
         "frontend_backend": "pallas",
         "audio_spec": {**h["audio_spec"], "sentence_len": 4000 / sr},
         "model": {**h["model"], **NARROW.get(model, {}),
                   "conv_backend": "pallas"}}
    out = texport.export_model(h, device="cpu")
    mel = int(model in HYBRIDS or h["model"]["feature_type"]
              == "melspectrogram")
    cascade = 3 if model in ("ECAPA_TDNN", "Raw3_ECAPA") else 0
    assert _op_counts(torch.export.load(out["program"])) == {
        OPS[0]: mel, OPS[1]: cascade}


# ----------------------------------------------------------------------
# the operators
# ----------------------------------------------------------------------
def _mel_args():
    cfg = FrontendConfig()
    g = torch.Generator().manual_seed(0)
    padded = reflect_pad(pre_emphasis(0.3 * torch.randn(3, 4000, generator=g)),
                         cfg.n_fft // 2).contiguous()
    cs, fb = mel_constants(cfg, "cpu")
    return cfg, (padded, cs, fb, cfg.hop_length, *window_rows(cfg))


def _cascade_args(hidden=16, T=50):
    g = torch.Generator().manual_seed(1)
    return (torch.randn(2, 8 * hidden, T, generator=g),
            torch.randn(7, 3, hidden, hidden, generator=g) / hidden,
            0.1 * torch.randn(7, hidden, generator=g),
            0.5 + torch.rand(7, hidden, generator=g),
            0.1 * torch.randn(7, hidden, generator=g), 2)


def test_opcheck_on_cpu_tensors():
    for op, args in ((torch.ops.speakerverification_tpu_torch.mel_frontend,
                      _mel_args()[1]),
                     (torch.ops.speakerverification_tpu_torch.res2net_cascade,
                      _cascade_args())):
        result = torch.library.opcheck(op.default, args)
        assert set(result.values()) == {"SUCCESS"}, result


def test_flop_count_through_the_ops_equals_the_plain_path():
    cfg, args = _mel_args()
    wave = 0.3 * torch.randn(3, 4000)
    counts = []
    for frontend in (mf.make_mel_frontend(cfg), make_frontend(cfg)):
        with FlopCounterMode(display=False) as fc:
            frontend(wave)
        counts.append(fc.get_total_flops())
    B, frames = 3, 1 + 4000 // cfg.hop_length
    K = cfg.n_fft // 2 + 1
    assert counts[0] == counts[1] == 2 * B * frames * (
        cfg.n_fft * 2 * K + K * cfg.n_mels)

    x, w, cb, s, sh, d = _cascade_args()
    counts = []
    for fn in (lambda: rc.res2net_cascade(x, w, cb, s, sh, dilation=d),
               lambda: rc.res2net_cascade_plain(x, w, cb, s, sh, d)):
        with FlopCounterMode(display=False) as fc:
            fn()
        counts.append(fc.get_total_flops())
    assert counts[0] == counts[1] == 2 * 2 * 50 * 16 * 16 * 3 * 7
    # and through a whole block: the kernel's route against the convs
    blk = Res2NetBlock(8 * 16, dilation=2, backend="pallas").eval()
    plain = Res2NetBlock(8 * 16, dilation=2, backend="xla").eval()
    plain.load_state_dict(blk.state_dict())
    got = []
    for b in (blk, plain):
        with torch.no_grad(), FlopCounterMode(display=False) as fc:
            b(x)
        got.append(fc.get_total_flops())
    assert got[0] == got[1] == counts[0]


def test_the_ops_run_the_plain_versions_on_cpu_and_route_gradients_around():
    cfg, (padded, cs, fb, hop, lo, hi) = _mel_args()
    before = (mf.launches, rc.launches)
    torch.testing.assert_close(
        torch.ops.speakerverification_tpu_torch.mel_frontend(
            padded, cs, fb, hop, lo, hi),
        mf.mel_frontend_plain(padded, cs, fb, hop, (lo, hi)))
    args = _cascade_args()
    torch.testing.assert_close(
        torch.ops.speakerverification_tpu_torch.res2net_cascade(*args),
        rc.res2net_cascade_plain(*args))
    assert (mf.launches, rc.launches) == before
    # a CPU call that needs a gradient takes the plain version, which
    # has one (the operators register none)
    x = args[0].clone().requires_grad_(True)
    rc.res2net_cascade(x, *args[1:5], dilation=2).sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
    wave = padded.clone().requires_grad_(True)
    mf.mel_frontend(wave, cs, fb, hop, (lo, hi)).sum().backward()
    assert wave.grad is not None


def test_fake_implementations_make_the_kernels_checks_on_cuda_tensors():
    """Under fake tensors on a CUDA device (nothing runs), the operators
    refuse what the kernels cannot take, so an export fails at the
    trace, and accept the rest."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg, (padded, cs, fb, hop, lo, hi) = _mel_args()
    x, w, cb, s, sh, d = _cascade_args(hidden=32)
    with FakeTensorMode():
        def cuda(t):
            return torch.empty(t.shape, dtype=t.dtype, device="cuda")
        mel = torch.ops.speakerverification_tpu_torch.mel_frontend
        out = mel(cuda(padded), cuda(cs), cuda(fb), hop, lo, hi)
        assert out.shape == (3, 1 + (padded.shape[1] - 512) // hop, 80)
        big = torch.empty(fb.shape[0], 136, device="cuda")
        with pytest.raises(ValueError, match="n_mels"):
            mel(cuda(padded), cuda(cs), big, hop, lo, hi)
        with pytest.raises(ValueError, match="float32"):
            mel(cuda(padded).double(), cuda(cs), cuda(fb), hop, lo, hi)
        casc = torch.ops.speakerverification_tpu_torch.res2net_cascade
        with pytest.raises(ValueError, match="hidden widths"):
            casc(cuda(x), cuda(w), cuda(cb), cuda(s), cuda(sh), d)
        x64, w64 = (torch.empty(2, 8 * 64, 300, device="cuda"),
                    torch.empty(7, 3, 64, 64, device="cuda"))
        v = torch.empty(7, 64, device="cuda")
        assert casc(x64, w64, v, v, v, 2).shape == x64.shape
        with pytest.raises(ValueError, match="too wide"):
            casc(x64, w64, v, v, v, 11)
    # on CPU tensors the plain versions take these shapes
    assert torch.ops.speakerverification_tpu_torch.res2net_cascade(
        x, w, cb, s, sh, d).shape == x.shape
