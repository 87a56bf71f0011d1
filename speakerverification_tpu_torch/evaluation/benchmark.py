"""Benchmark harness: checkpoint sweeps and all-pairs dataset checks
(port of ``evaluation/benchmark.py``).

* ``benchmark_models`` (src/benchmark/benmark_model.py:25-60): every
  checkpoint of a run's directory against a trial list, the threshold
  tuned, EER and minDCF per checkpoint.
* ``benchmark_dataset`` (src/benchmark/benchmark_dataset.py:20-32):
  all-pairs speaker matching over a labeled set with per-speaker
  accuracy, as one ``E @ E.T`` product.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Mapping, Optional

import numpy as np

from speakerverification_tpu_torch.evaluation.evaluator import (
    evaluate_from_list,
    extract_embeddings,
)
from speakerverification_tpu_torch.evaluation.metrics import (
    compute_error_rates,
    compute_min_dcf,
    tune_threshold_from_score,
)
from speakerverification_tpu_torch.evaluation.scoring import l2_normalize

__all__ = ["benchmark_models", "benchmark_dataset"]


def benchmark_models(make_embed_fn: Callable[[Path], Callable],
                     checkpoint_dir: str | Path, trial_file: str | Path,
                     audio_spec: Mapping, num_eval: int = 10,
                     save_json: Optional[str | Path] = None) -> list:
    """Evaluate every ``*.msgpack`` checkpoint of ``checkpoint_dir``;
    ``make_embed_fn(path)`` returns the batched embed function of that
    checkpoint's weights."""
    results = []
    for ckpt in sorted(Path(checkpoint_dir).glob("*.msgpack")):
        embed_fn = make_embed_fn(ckpt)
        scores, labels, _ = evaluate_from_list(embed_fn, trial_file,
                                               audio_spec, num_eval=num_eval)
        res = tune_threshold_from_score(scores, labels, [1, 0.1])
        fnrs, fprs, thr = compute_error_rates(scores, labels)
        mindcf, _ = compute_min_dcf(fnrs, fprs, thr)
        results.append({"checkpoint": str(ckpt), "eer": res["roc"][1],
                        "min_dcf": mindcf, "threshold": res["roc"][3]})
    if save_json:
        Path(save_json).write_text(json.dumps(results, indent=2))
    return results


def benchmark_dataset(embed_fn: Callable, files: list, labels: list,
                      audio_spec: Mapping, num_eval: int = 5) -> dict:
    """All-pairs cosine speaker matching with per-speaker accuracy: each
    file's nearest neighbour (itself excluded) must share its speaker."""
    emb = l2_normalize(extract_embeddings(embed_fn, files, audio_spec,
                                          num_eval)).mean(dim=1)
    emb = l2_normalize(emb).cpu().numpy()
    sim = emb @ emb.T
    np.fill_diagonal(sim, -np.inf)
    nn_idx = np.argmax(sim, axis=1)
    labels = np.asarray(labels)
    correct = labels[nn_idx] == labels
    per_speaker = {str(spk): float(np.mean(correct[labels == spk]))
                   for spk in sorted(set(labels.tolist()))}
    return {"overall_accuracy": float(np.mean(correct)),
            "per_speaker": per_speaker, "n_files": len(files)}
