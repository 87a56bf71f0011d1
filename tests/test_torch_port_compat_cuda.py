"""A converted reference checkpoint served on the card against the same
weights on the CPU's plain path (``cuda`` marker: skips without a CUDA
device). No JAX here, so the GPU host runs it:

    python -m pytest --noconftest tests/test_torch_port_compat_cuda.py -q

The full-width ``Raw3_ECAPA`` of ``yaml/raw3_ecapa.yaml`` (its serving
keys below), from a seeded reference checkpoint with the keys and shapes
of ``tests/data/raw3_ecapa.torch_shapes.json``, through the converter
CLI's ``_main``, served with ``conv_backend: pallas``: K1 once and K2 3
times a forward, embeddings at cosine ≥ 0.9999 to the CPU's.
"""

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_port_compat_refs as R
from speakerverification_tpu_torch.compat import torch_port as TP
from speakerverification_tpu_torch.inference import (
    InferenceEngine,
    make_eval_embed_fn,
)
from speakerverification_tpu_torch.ops import mel_frontend, res2net_cascade

RAW3_ECAPA = {"seed": 20220709,
              "audio_spec": {"sample_rate": 8000, "channels": 1,
                             "sentence_len": 2.0, "win_len": 0.025,
                             "hop_len": 0.01},
              "n_mfcc": 80, "n_mels": 80, "features": "raw",
              "model": {"name": "Raw3_ECAPA", "feature_type": "raw",
                        "nOut": 512, "conv_backend": "pallas"},
              "num_eval": 20}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_a_converted_reference_serves_on_the_card_as_on_the_cpu(tmp_path,
                                                                cuda):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    manifest = json.loads(R.FULL_WIDTH.read_text())
    torch.save(R.wrapped(R.reference_arrays(manifest, seed=3)),
               tmp_path / "ref.pt")
    out = tmp_path / "raw3_ecapa.msgpack"
    TP._main(["--arch", "Raw3_ECAPA", "--input", str(tmp_path / "ref.pt"),
              "--output", str(out)])
    h = {**RAW3_ECAPA, "save_folder": str(tmp_path / "save"),
         "initial_model_infer": str(out)}
    engine = InferenceEngine(h)
    assert engine.device.type == "cuda" and engine.weights_path == Path(out)
    waves = (0.1 * np.random.default_rng(2).standard_normal((16, 16000))
             ).astype(np.float32)
    before = (mel_frontend.launches, res2net_cascade.launches)
    got = engine.embed_fn(waves).cpu().numpy()
    assert (mel_frontend.launches - before[0],
            res2net_cascade.launches - before[1]) == (1, 3)
    ref = make_eval_embed_fn(copy.deepcopy(engine.model).cpu())(
        torch.from_numpy(waves)).numpy()
    cos = (got * ref).sum(1) / np.linalg.norm(got, axis=1) \
        / np.linalg.norm(ref, axis=1)
    assert np.isfinite(got).all() and cos.min() >= 0.9999, cos.min()
