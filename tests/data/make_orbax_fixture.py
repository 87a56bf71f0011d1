"""Write ``tests/data/orbax_ecapa/``: a JAX ``ECAPA_TDNN`` eval state saved
as an orbax directory by the JAX package's ``save_sharded``, and the JAX
engine's fp32 embeddings of 8 seeded waves served from it.

The port reads the directory with its own OCDBT/zarr/zstd reader
(``speakerverification_tpu_torch/training/orbax_read.py``):
``tests/test_torch_port_orbax.py`` on the CPU and ``chip_smoke.py``'s
path P3 on the GPU hold the port's embeddings of the same waves to the
stored ones. The model is ``yaml/ecapa_tdnn.yaml``'s with the widths in
``fixture.json`` (C 128 at Res2Net scale 2, so each group is 64 wide,
which the port's K2 kernel takes); its weights are the JAX init of
``seed`` moved by seeded noise, with positive running variances. The
waves are ``0.1 · N(0, 1)`` from ``numpy.random.default_rng(wave_seed)``
of shape ``wave_shape``. Run from the repository root (written with orbax
0.11.32):

    JAX_PLATFORMS=cpu python tests/data/make_orbax_fixture.py
"""

import json
import os
import shutil
import sys
import tempfile
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

OUT = ROOT / "tests" / "data" / "orbax_ecapa"
FIXTURE = {
    "model": {"name": "ECAPA_TDNN", "nOut": 64,
              "channels": [128, 128, 128, 128, 256],
              "attention_channels": 64, "se_channels": 64,
              "res2net_scale": 2},
    "seed": 3,
    "step": 1200,
    "wave_seed": 1234,
    "wave_shape": [8, 32000],
}


def waves(fixture: dict):
    import numpy as np
    rng = np.random.default_rng(fixture["wave_seed"])
    return (0.1 * rng.standard_normal(fixture["wave_shape"])
            ).astype(np.float32)


def hparams(fixture: dict, save_folder: str) -> dict:
    from speakerverification_tpu.config import read_config
    h = read_config(ROOT / "yaml" / "ecapa_tdnn.yaml")
    return {**h, "save_folder": save_folder, "seed": fixture["seed"],
            "model": {**fixture["model"], "feature_type": "melspectrogram"}}


def main() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from speakerverification_tpu.builder import encoder_from_hparams
    from speakerverification_tpu.inference import InferenceEngine
    from speakerverification_tpu.training.checkpoint_sharded import (
        save_sharded,
    )
    from speakerverification_tpu.training.state import create_train_state

    jax.config.update("jax_platforms", "cpu")
    with tempfile.TemporaryDirectory() as tmp:
        h = hparams(FIXTURE, tmp)
        model = encoder_from_hparams(h)
        T = waves(FIXTURE).shape[1]
        state = create_train_state(model, optax.sgd(1e-3),
                                   jax.random.PRNGKey(FIXTURE["seed"]),
                                   jnp.zeros((2, T)))
        rng = np.random.default_rng(FIXTURE["seed"])
        state = state.replace(
            step=jnp.asarray(FIXTURE["step"], jnp.int32),
            params=jax.tree.map(
                lambda a: jnp.asarray(np.asarray(a) + rng.normal(
                    0, 0.02, a.shape).astype(np.float32)), state.params),
            batch_stats=jax.tree.map(
                lambda a: jnp.asarray(rng.uniform(
                    0.5, 1.5, a.shape).astype(np.float32)),
                state.batch_stats))
        if OUT.exists():
            shutil.rmtree(OUT)
        OUT.mkdir(parents=True)
        save_sharded(OUT / "state", state)
        engine = InferenceEngine({**h, "initial_model_infer":
                                  str(OUT / "state")})
        emb = np.asarray(engine.embed_fn(waves(FIXTURE)), np.float32)
    np.save(OUT / "embeddings.npy", emb)
    (OUT / "fixture.json").write_text(json.dumps(FIXTURE, indent=1) + "\n")
    size = sum(p.stat().st_size for p in OUT.rglob("*") if p.is_file())
    print(f"wrote {OUT} ({size:,} bytes), embeddings {emb.shape}")


if __name__ == "__main__":
    main()
