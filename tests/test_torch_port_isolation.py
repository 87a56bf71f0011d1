"""The port imports neither JAX nor anything of the JAX package.

A fresh interpreter imports every module of ``speakerverification_tpu_torch``
and then lists what it has loaded. The names share a prefix, so the
check is ``name == "speakerverification_tpu"`` or
``name.startswith("speakerverification_tpu.")``. The port's WAV reader
loads the port's own native library, built into its ``_build/``, and
never the JAX package's ``libsvwav.so``.
"""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PROBE = r"""
import importlib, json, pkgutil, sys
import speakerverification_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
print(json.dumps({"modules": names, "loaded": sorted(sys.modules)}))
"""


def test_port_imports_no_jax_and_no_jax_package():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    for expected in ("config", "registry", "ops.frontend", "ops.mel_frontend",
                     "ops.res2net_cascade", "ops.sinc", "models.layers",
                     "models.ecapa_tdnn", "models.rawnet_blocks",
                     "models.rawnet3", "models.hybrids", "encoder", "builder",
                     "inference", "weights", "data.audio", "serving",
                     "quant", "ops.quant_matmul", "data.loader",
                     "evaluation.metrics", "evaluation.scoring",
                     "evaluation.reports", "evaluation.evaluator",
                     "evaluation.bank", "checkpoint", "cli.main",
                     "losses", "losses.common", "losses.margin",
                     "losses.margin_extra", "optim", "optim.custom",
                     "optim.schedulers", "training", "training.state",
                     "training.train_step", "training.checkpoint",
                     "training.trainer", "data.manifest", "data.sampler",
                     "models.recurrent", "models.rawnet2",
                     "models.rawnet2_custom", "losses.proto",
                     "losses.combined", "data.augment", "ops.phase_vocoder",
                     "ops.specaugment", "ops.device_augment",
                     "ops.timeaugment", "data.wavio", "data.shards",
                     "data.vad", "data.wav_conversion", "data.quality",
                     "data.dataprep", "cli.dataprep", "models.conformer",
                     "models.resnetse", "models.senet", "models.titanet",
                     "models.hybrids2", "losses.adaptive",
                     "losses.proxy", "losses.similarity", "losses.triplet",
                     "optim.second_order", "ops.signal",
                     "ops.features_extra", "ops.filteraugment", "export",
                     "utils.sysinfo", "utils.summary", "utils.plotting",
                     "evaluation.benchmark", "parallel", "parallel.mesh",
                     "parallel.multihost", "parallel.dp", "parallel.tp",
                     "parallel.collectives", "losses.sharded",
                     "training.checkpoint_sharded", "compat",
                     "compat.torch_port", "compat.torch_export",
                     "training.orbax_read"):
        assert f"speakerverification_tpu_torch.{expected}" in res["modules"]
    loaded = res["loaded"]
    # the GPU host has neither msgpack, ml_dtypes, PyYAML, matplotlib,
    # orbax, tensorstore nor zstandard: the codec, the orbax reader and
    # the zstd decoder are the port's own, the CLI reads YAML lazily and
    # the plots import matplotlib when they draw
    for banned in ("jax", "flax", "optax", "msgpack", "ml_dtypes", "yaml",
                   "matplotlib", "orbax", "tensorstore", "zstandard"):
        assert not [m for m in loaded
                    if m == banned or m.startswith(banned + ".")], banned
    assert not [m for m in loaded if m == "speakerverification_tpu"
                or m.startswith("speakerverification_tpu.")]
    # and the prefix check really sees the port's own modules
    assert "speakerverification_tpu_torch.serving" in loaded


SMOKE_PROBE = r"""
import importlib.util, json, sys, tempfile
from pathlib import Path
import numpy as np, torch
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
from speakerverification_tpu_torch import checkpoint, inference, serving
from speakerverification_tpu_torch.evaluation.bank import SpeakerBank
from speakerverification_tpu_torch.weights import params_from_jax, params_to_jax
# path D's checkpoint round trip and bank, on the CPU at a small size
model = torch.nn.Sequential(torch.nn.Conv1d(2, 3, 3), torch.nn.BatchNorm1d(3))
params, stats = params_to_jax(model.state_dict())
tree = {"step": np.asarray(1, np.int32), "params": params,
        "batch_stats": stats,
        "opt_state": {"0": {}, "1": {"ema": params}},
        "half": torch.ones(3, dtype=torch.bfloat16)}
path = Path(tempfile.mkdtemp()) / "best_state.msgpack"
checkpoint.save_checkpoint(path, tree, {"epoch": 1})
back = checkpoint.load_checkpoint(path)
params_from_jax(back["params"], back["batch_stats"], like=model)
SpeakerBank(np.eye(4, dtype=np.float32), device="cpu").identify(np.ones(4))
print(json.dumps({"loaded": sorted(sys.modules)}))
"""


def test_chip_smoke_path_imports_no_msgpack_flax_ml_dtypes_or_yaml():
    """``chip_smoke.py`` and path D's code (the checkpoint codec, the
    weight bridge, the bank, the server and the engine) import none of
    what the GPU host lacks: ``msgpack``, ``flax``, ``ml_dtypes``,
    ``yaml``, and nothing of JAX."""
    out = subprocess.run([sys.executable, "-c", SMOKE_PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])["loaded"]
    for banned in ("jax", "flax", "optax", "msgpack", "ml_dtypes", "yaml",
                   "speakerverification_tpu"):
        assert not [m for m in loaded
                    if m == banned or m.startswith(banned + ".")], banned


def test_chip_smoke_fails_without_a_gpu_and_alone(tmp_path):
    """``chip_smoke.py`` exits non-zero and prints no result line where
    there is no CUDA device, and where the repository is not beside it."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, alone)):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=300,
                             env={"PATH": "/usr/bin:/bin",
                                  "CUDA_VISIBLE_DEVICES": ""})
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


NATIVE_PROBE = r"""
import json, sys
from speakerverification_tpu_torch.data import wavio
from speakerverification_tpu_torch.data.dataprep import vad_on_dataset
assert wavio.native_available(), wavio.native_error()
names = [line.split()[-1] for line in open("/proc/self/maps")
         if len(line.split()) >= 6]
libs = sorted({n for n in names if n.endswith(".so") or ".so." in n})
print(json.dumps({"libs": libs, "loaded": sorted(sys.modules)}))
"""


def test_port_loads_its_own_native_reader():
    out = subprocess.run([sys.executable, "-c", NATIVE_PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    build = str(ROOT / "speakerverification_tpu_torch" / "_build") + "/"
    ours = [lib for lib in res["libs"] if lib.startswith(build)]
    assert len(ours) == 1 and Path(ours[0]).name.startswith("libwavio-"), \
        res["libs"]
    assert not [lib for lib in res["libs"] if "libsvwav" in lib
                or "/speakerverification_tpu/" in lib]
    assert not [m for m in res["loaded"] if m == "speakerverification_tpu"
                or m.startswith(("speakerverification_tpu.", "jax"))]
