"""Model export: weights, a config and a ``torch.export`` program
(port of ``export.py``).

The JAX package lowers its eval-mode embedding function to StableHLO;
the port exports the same function with ``torch.export`` into a
``.pt2`` file, beside the weights in the JAX layout (``params.msgpack``,
which ``flax.serialization`` reads) and the architecture config
(``config.json``, the JAX keys). The fixed signature is the reference's
dummy input ``[num_eval, sample_rate * sentence_len]``. A self-check
replays the program against the live engine.

The hand-written kernels on the eval path, K1 (the mel frontend) and K2
(the Res2Net cascade), are registered operators
(``torch.ops.speakerverification_tpu_torch.*``), so the exported graph
holds them as single nodes: on a CUDA program they launch the kernels,
on a CPU program they run the plain versions. A program exported on the
card holds CUDA tensors and loads on a card. ``quant: int8`` is
refused: the JAX engine calibrates its int8 embed function on the first
batch, so JAX's own export of it fails before it writes anything.
"""

from __future__ import annotations

import copy
import json
import keyword
from pathlib import Path
from typing import Callable, Mapping

import numpy as np
import torch
import torch.nn as nn

__all__ = ["export_model", "export_onnx", "load_exported", "INT8_REFUSAL"]

INT8_REFUSAL = (
    "export of quant: int8 is not supported (ROADMAP C.15): the int8 "
    "embed function is calibrated on the first batch it sees, and the "
    "JAX package's export of it fails with TypeError before it writes "
    "anything (speakerverification_tpu/export.py:58-63); export the "
    "float model (fp32, or bf16 with mixedprec)")


def _keyword_safe(module: nn.Module) -> nn.Module:
    """``module``, or a copy of it whose submodules named after a Python
    keyword (the GRU cell's flax name ``in``) are renamed ``<name>_``:
    torch.fx writes a parameter's path as attribute accesses, which a
    keyword cannot be."""
    if not any(keyword.iskeyword(name) for m in module.modules()
               for name in m._modules):
        return module
    module = copy.deepcopy(module)
    for m in module.modules():
        for name in [n for n in m._modules if keyword.iskeyword(n)]:
            m._modules[name + "_"] = m._modules.pop(name)
    return module


def _signature(hparams: Mapping) -> tuple[int, int]:
    spec = hparams.get("audio_spec", {})
    sr = int(spec.get("sample_rate", 8000))
    return int(hparams.get("num_eval", 10)), int(
        spec.get("sentence_len", 2.0) * sr)


def export_model(hparams: Mapping, out_dir: str | Path | None = None,
                 device=None) -> dict:
    """Export the eval-mode embedding extraction to ``out_dir`` (default
    ``<run>/model/export``) on ``device`` (default CUDA). Returns the
    artifacts' paths: ``{"dir", "params", "program", "config"}``."""
    # here, not at the top: load_exported needs only the kernels' modules
    from speakerverification_tpu_torch.checkpoint import msgpack_serialize
    from speakerverification_tpu_torch.inference import InferenceEngine
    from speakerverification_tpu_torch.models.layers import folded_constants
    if hparams.get("quant") == "int8":
        raise NotImplementedError(INT8_REFUSAL)
    engine = InferenceEngine(hparams, device=device)
    num_eval, T = _signature(hparams)
    out_dir = Path(out_dir) if out_dir else engine.dirs["model"] / "export"
    out_dir.mkdir(parents=True, exist_ok=True)

    # 1. weights in the JAX layout, and the architecture config
    state = engine._state()
    (out_dir / "params.msgpack").write_bytes(msgpack_serialize(
        {"params": state["params"], "batch_stats": state["batch_stats"]}))
    arch = {"model": hparams.get("model", {}),
            "features": hparams.get("features", "melspectrogram"),
            "n_mels": hparams.get("n_mels", 80),
            "audio_spec": dict(hparams.get("audio_spec", {})),
            "num_eval": num_eval,
            "embedding_normalized": engine._normalize}
    (out_dir / "config.json").write_text(json.dumps(arch, indent=2))

    # 2. the program at the fixed signature. The live forward runs first:
    # it builds the frontend's constants and folds the cascade's weights
    # on real tensors, which the trace takes in as constants
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(0, 0.1, (num_eval, T)).astype(
        np.float32)).to(engine.device)
    live = engine._embed(x).cpu().numpy()
    module = _keyword_safe(engine._embed.module)
    example = torch.zeros((num_eval, T), device=engine.device)
    with folded_constants(module), torch.no_grad():
        program = torch.export.export(module, (example,), strict=False)
    torch.export.save(program, out_dir / "model.pt2")

    # 3. self-check: the program against the live engine
    with torch.no_grad():
        replay = program.module()(x).cpu().numpy()
    np.testing.assert_allclose(replay, live, rtol=1e-4, atol=1e-5)

    print(f"[INFO] exported to {out_dir} (embedding dim {live.shape[-1]})")
    return {"dir": str(out_dir),
            "params": str(out_dir / "params.msgpack"),
            "program": str(out_dir / "model.pt2"),
            "config": str(out_dir / "config.json")}


def export_onnx(hparams: Mapping, out_dir: str | Path | None = None):
    """ONNX export: refused, as in the JAX package.

    The reference exports through ``torch.onnx.export``
    (src/model.py:748-781) and notes in its own comment
    (src/model.py:756) that the export is broken for every
    torchaudio/mel-frontend model. Neither ``onnx`` nor ``onnxruntime``
    is installed to validate an artifact against, and the port's eval
    path runs two hand-written CUDA kernels as custom operators that ONNX
    has no counterpart for. ``export_model`` writes the ``torch.export``
    program (``model.pt2``), the JAX-layout weights and the config.
    """
    try:
        import onnx  # noqa: F401
    except ImportError:
        raise RuntimeError(
            "ONNX export is not supported: the 'onnx' package is not "
            "installed, and the reference's own ONNX export is broken for "
            "mel-frontend models (src/model.py:756). Use export_model() for "
            "the torch.export program (model.pt2) with the JAX-layout "
            "weights and config.json.") from None
    raise NotImplementedError(
        "ONNX export is not supported even when 'onnx' is importable: it "
        "cannot be validated here (no onnxruntime), the reference's "
        "exporter it would mirror is itself broken for mel-frontend models "
        "(src/model.py:756), and the eval path's hand-written kernels are "
        "custom operators with no ONNX counterpart. Use export_model().")


def load_exported(out_dir: str | Path) -> Callable:
    """Load an exported program -> callable ``wave -> embeddings``.

    Imports the port's kernel wrappers first, which register the custom
    operators the program calls."""
    from speakerverification_tpu_torch.ops import (  # noqa: F401
        mel_frontend,
        res2net_cascade,
    )
    module = torch.export.load(Path(out_dir) / "model.pt2").module()
    device = next((t.device for t in (*module.parameters(),
                                      *module.buffers())),
                  torch.device("cpu"))

    @torch.no_grad()
    def embed(wave) -> torch.Tensor:
        return module(torch.as_tensor(wave, dtype=torch.float32)
                      .to(device))

    return embed
