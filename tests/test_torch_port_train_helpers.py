"""Shared helpers of the ``test_torch_port_train*`` parity tests (no tests
here): the same config, weights and batches through the JAX train step
and the port's, each port step started from the JAX step's incoming
state, which crosses over through a JAX-written checkpoint."""

from __future__ import annotations

import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax.traverse_util import flatten_dict

from speakerverification_tpu import builder as JB
from speakerverification_tpu.training.state import (
    create_train_state as j_create_train_state,
)
from speakerverification_tpu.training.train_step import (
    make_train_step as j_make_train_step,
)
from speakerverification_tpu_torch import builder as TB
from speakerverification_tpu_torch.training import checkpoint as tckpt
from speakerverification_tpu_torch.training.state import (
    TrainState,
    model_state,
)
from speakerverification_tpu_torch.training.train_step import (
    make_train_step as t_make_train_step,
)
from speakerverification_tpu_torch.weights import params_to_jax

# fp32 parity: no TF32 in PyTorch's products and convolutions
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def batches(rng: np.random.Generator, n: int, B: int, n_per: int, T: int,
            n_classes: int) -> list:
    """``n`` batches of ``[B, n_per, T]`` waves (0.1 · N(0, 1)) and ``B``
    distinct labels."""
    return [((0.1 * rng.normal(0, 1, (B, n_per, T))).astype(np.float32),
             rng.permutation(n_classes)[:B].astype(np.int32))
            for _ in range(n)]


class Pair:
    """One config built in both packages: the JAX model, optimizer, state
    and jitted step; the port's model (CPU), optimizer and step."""

    def __init__(self, hparams: dict, first_batch, accum_steps: int = 1,
                 compute_dtype=None):
        self.h = hparams
        self.jmodel = JB.encoder_from_hparams(hparams, with_loss=True,
                                              num_devices=1)
        self.jtx = JB.optimizer_from_hparams(hparams)
        wave, label = first_batch
        self.jstate = j_create_train_state(
            self.jmodel, self.jtx, jax.random.PRNGKey(0), jnp.asarray(wave),
            jnp.asarray(label))
        self.jstep = jax.jit(j_make_train_step(
            self.jmodel, self.jtx, accum_steps=accum_steps,
            compute_dtype=JB.compute_dtype_from_hparams(hparams)))
        self.tmodel = TB.encoder_from_hparams(hparams, with_loss=True)
        self.ttx = TB.optimizer_from_hparams(hparams)
        params, stats = model_state(self.tmodel)
        self.tstate = TrainState(0, params, stats, self.ttx.init(
            {k: p.detach() for k, p in params.items()}), self.tmodel)
        self.tstep = t_make_train_step(
            self.tmodel, self.ttx, accum_steps=accum_steps,
            compute_dtype=TB.compute_dtype_from_hparams(hparams))

    def load_jax_state(self, tmp_path) -> TrainState:
        """The port's state set to the JAX state, through a checkpoint
        file the JAX package writes and the port restores whole."""
        path = tmp_path / "jax_state.msgpack"
        path.write_bytes(fser.to_bytes(self.jstate))
        return tckpt.load_checkpoint(path, self.tstate)

    def steps(self, data, lr: float, tmp_path):
        """Each batch through both steps, the port's starting from the JAX
        state (whose checkpoint is ``tmp_path / "jax_state.msgpack"``
        during the iteration); yields ``(j_metrics, t_metrics, j_state,
        port trees)``."""
        for i, (wave, label) in enumerate(data):
            self.load_jax_state(tmp_path)
            self.jstate, jm = self.jstep(
                self.jstate, jnp.asarray(wave), jnp.asarray(label),
                jax.random.PRNGKey(i), jnp.float32(lr))
            self.tstate, tm = self.tstep(
                self.tstate, torch.from_numpy(wave), torch.from_numpy(label),
                lr)
            yield jm, tm, self.jstate, self.port_trees()

    def port_trees(self):
        """The port's ``(params, batch_stats)`` as flat flax-path dicts."""
        params, stats = params_to_jax(self.tmodel.state_dict())
        return flatten_dict(params), flatten_dict(stats)


def flat(tree) -> dict:
    return flatten_dict(jax.tree.map(np.asarray, tree))


def rel_errors(got: dict, ref: dict) -> dict:
    """Per leaf ``max|got - ref| / max|ref|``."""
    return {"/".join(k): float(np.max(np.abs(got[k] - ref[k]))
                               / max(float(np.max(np.abs(ref[k]))), 1e-30))
            for k in ref}


def update_cosines(after: dict, before: dict, ref_after: dict,
                   skip=()) -> tuple[float, dict]:
    """Cosine between the update ``after - before`` and ``ref_after -
    before``: over all leaves (but ``skip``) and per leaf."""
    keep = [k for k in before if not any("/".join(k).endswith(s)
                                          for s in skip)]
    per = {}
    for k in keep:
        a = (after[k] - before[k]).ravel().astype(np.float64)
        b = (ref_after[k] - before[k]).ravel().astype(np.float64)
        per["/".join(k)] = float(a @ b / max(np.linalg.norm(a)
                                             * np.linalg.norm(b), 1e-300))
    a = np.concatenate([(after[k] - before[k]).ravel() for k in keep])
    b = np.concatenate([(ref_after[k] - before[k]).ravel() for k in keep])
    a, b = a.astype(np.float64), b.astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b))), per


class Float64Port:
    """The port's model, optimizer and step in float64 (the frontend stays
    fp32, its features and the raw wave cast to float64): the exact
    reference that the fp32 steps of both packages are measured from."""

    def __init__(self, pair: Pair, accum_steps: int = 1):
        self.model = TB.encoder_from_hparams(pair.h, with_loss=True).double()
        inner = self.model.backbone if hasattr(self.model.backbone,
                                               "frontend") else self.model
        inner.compute_dtype = torch.float64
        params, stats = model_state(self.model)
        self.state = TrainState(0, params, stats, pair.ttx.init(
            {k: p.detach() for k, p in params.items()}), self.model)
        self.step = t_make_train_step(self.model, pair.ttx,
                                      accum_steps=accum_steps)

    def run(self, jax_ckpt, wave, label, lr: float):
        """One step from the state in the JAX-written ``jax_ckpt``;
        returns ``(loss, params, batch_stats)`` as float64 flax-path
        dicts."""
        tckpt.load_checkpoint(jax_ckpt, self.state)
        self.state, m = self.step(self.state, torch.from_numpy(wave),
                                  torch.from_numpy(label), lr)
        params, stats = params_to_jax(self.model.state_dict())
        return float(m["loss"]), flatten_dict(params), flatten_dict(stats)


# the default stack at full width (yaml/raw3_ecapa.yaml's model, head and
# optimizer) on 0.5 s crops
RAW3 = {"seed": 0, "audio_spec": {"sample_rate": 8000, "sentence_len": 0.5},
        "features": "raw", "n_mels": 80, "n_mfcc": 80,
        "model": {"name": "Raw3_ECAPA", "feature_type": "raw", "nOut": 512},
        "criterion": {"name": "ARmSoftmax", "margin": 0.2, "scale": 30},
        "nClasses": 13103, "lr": 0.003,
        "optimizer": {"name": "AdaBelief", "weight_decay": 2e-5,
                      "lr_decay": 0.95}}
# parameters whose gradient is zero, or zero but for the log-sinc's 1e-6,
# by construction: a softmax over time ignores a per-channel shift
# (ECAPA's attention bias; RawNet3's attention conv bias and the BN bias
# before it), and the instance norm's scale and offset are undone by the
# log-magnitude's mean over time and the band-pass sinc filters
RAW3_ZERO_GRAD = ("AttentiveStatisticsPooling_0/Conv1d_0/Conv_0/bias",
                  "raw_branch/Conv_2/bias", "raw_branch/BatchNorm_0/bias",
                  "raw_branch/inorm_scale", "raw_branch/inorm_bias")


def raw3_steps(tmp_path, accum_steps: int = 1, mixedprec: bool = False,
               f64_steps: int = 1, n_steps: int = 3, stack: dict = RAW3,
               zero_grad: tuple = RAW3_ZERO_GRAD,
               samples: int = 4000) -> list:
    """Teacher-forced steps of a full-width stack (``stack``, by default
    the default one; 4 speakers × 2 crops of ``samples``, seeded) in both
    packages; the first ``f64_steps`` also through the float64 port.
    Update cosines leave out ``zero_grad``. Returns one dict of
    measurements per step."""
    torch.set_num_threads(2)
    h = {**stack, "mixedprec": True} if mixedprec else stack
    data = batches(np.random.default_rng(0), n_steps, 4, 2, samples,
                   h["nClasses"])
    pair = Pair(h, data[0], accum_steps=accum_steps)
    ref = Float64Port(pair, accum_steps) if f64_steps else None
    before = flat(pair.jstate.params)
    out = []
    for i, (jm, tm, js, (tp, ts)) in enumerate(pair.steps(data, h["lr"],
                                                          tmp_path)):
        jp, jst = flat(js.params), flat(js.batch_stats)
        jl, tl = float(jm["loss"]), float(tm["loss"])
        row = {"loss_jax": jl, "loss_port": tl,
               "stats_port_jax": max(rel_errors(ts, jst).values()),
               "cos_port_jax": update_cosines(tp, before, jp,
                                              zero_grad)[0]}
        if i < f64_steps:
            rl, rp, rs = ref.run(tmp_path / "jax_state.msgpack", *data[i],
                                 h["lr"])
            row.update({
                "loss_ref": rl,
                "stats_port_ref": max(rel_errors(ts, rs).values()),
                "stats_jax_ref": max(rel_errors(jst, rs).values()),
                "cos_port_ref": update_cosines(tp, before, rp,
                                               zero_grad)[0],
                "cos_jax_ref": update_cosines(jp, before, rp,
                                              zero_grad)[0]})
        print(f"step {i}: " + ", ".join(f"{k} {v:.6g}"
                                        for k, v in row.items()))
        out.append(row)
        before = jp
    return out
