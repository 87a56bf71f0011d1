"""Model summary: parameter counts by module, feature-shape math and
FLOPs (port of ``utils/summary.py``).

The reference's model-plot tool (src/model.py:797-833: a torchsummary
dump with the parameter counts and the mel frame count of the
``audio_spec``). Parameter trees are the flax ``params`` trees that the
port's modules map to (``weights.params_to_jax``), so the table's
module names and counts are the JAX package's. ``forward_flops`` counts
one eval forward with ``FlopCounterMode``; the hand-written kernels'
operators carry FLOP formulas of their plain versions' work, so the count
is the same through the kernels as through the plain path.

    python -m speakerverification_tpu_torch.utils.summary [--config yaml/model_plot.yaml]
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
import torch.nn as nn

from speakerverification_tpu_torch.weights import params_to_jax

__all__ = ["count_params", "summarize_params", "mel_frames_for_spec",
           "forward_flops"]


def _leaves(tree, path=()):
    if isinstance(tree, Mapping):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (str(k),))
    else:
        yield path, tree


def _param_tree(params):
    """A module's flax ``params`` tree; a tree is returned as it is."""
    if isinstance(params, nn.Module):
        return params_to_jax(params.state_dict())[0]
    return params


def count_params(params) -> int:
    """Parameters of a module or of a flax ``params`` tree (BatchNorm
    statistics are not parameters)."""
    return sum(int(np.prod(np.shape(leaf)))
               for _, leaf in _leaves(_param_tree(params)))


def summarize_params(params, max_depth: int = 2) -> str:
    """Tabulated parameter counts per module (grouped to ``max_depth``)."""
    tree = _param_tree(params)
    groups: dict[str, int] = {}
    for path, leaf in _leaves(tree):
        group = "/".join(path[:max_depth])
        groups[group] = groups.get(group, 0) + int(np.prod(np.shape(leaf)))
    width = max((len(g) for g in groups), default=10) + 2
    lines = [f"{'module':<{width}}{'params':>12}"]
    for g in sorted(groups):
        lines.append(f"{g:<{width}}{groups[g]:>12,}")
    lines.append("-" * (width + 12))
    lines.append(f"{'total':<{width}}{count_params(tree):>12,}")
    return "\n".join(lines)


def mel_frames_for_spec(audio_spec: Mapping, center: bool = True) -> int:
    """Number of mel frames of a crop (parity: src/model.py:820-833)."""
    sr = int(audio_spec["sample_rate"])
    samples = int(audio_spec["sentence_len"] * sr)
    hop = int(round(audio_spec.get("hop_len", 0.01) * sr))
    if center:
        return 1 + samples // hop
    win = int(round(audio_spec.get("win_len", 0.025) * sr))
    return 1 + (samples - win) // hop


def forward_flops(model: nn.Module, x: torch.Tensor) -> float:
    """FLOPs of one eval forward of ``model`` on ``x``, counted by
    ``FlopCounterMode`` (matmuls, convolutions, attention and the
    kernels' operators; elementwise work is not counted). The model is
    put back in the mode it was in."""
    from torch.utils.flop_counter import FlopCounterMode
    training = model.training
    model.eval()
    try:
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            model(x)
    finally:
        model.train(training)
    return float(counter.get_total_flops())


def _main() -> None:
    """Model-plot CLI (parity: the reference's ``python src/model.py``,
    src/model.py:797-833): build the model from the config on the CPU,
    print the parameter table, the mel frame count of the configured
    ``audio_spec`` and the forward's GFLOPs per utterance."""
    import argparse

    from speakerverification_tpu_torch.builder import encoder_from_hparams
    from speakerverification_tpu_torch.config import read_config
    from speakerverification_tpu_torch.weights import init_weights_

    p = argparse.ArgumentParser(description="model summary / plot tool")
    p.add_argument("--config", type=str, default="yaml/model_plot.yaml")
    p.add_argument("--max_depth", type=int, default=2)
    args = p.parse_args()

    hparams = read_config(args.config)
    model = encoder_from_hparams(hparams, with_loss=False)
    init_weights_(model, torch.Generator().manual_seed(0))
    spec = hparams.get("audio_spec", {})
    sr = int(spec.get("sample_rate", 16000))
    t = int(float(spec.get("sentence_len", 2.0)) * sr)
    print(summarize_params(model, max_depth=args.max_depth))
    flops = forward_flops(model, torch.zeros(1, t))
    print(f"\ninput: {t} samples @ {sr} Hz -> "
          f"{mel_frames_for_spec(spec)} mel frames")
    print(f"forward: {flops / 1e9:.2f} GFLOPs/utt (FlopCounterMode)")


if __name__ == "__main__":
    _main()
