"""Shared helpers of the ``test_torch_port_*`` parity tests (no tests here).

Inputs are made with numpy from a seed and handed to both packages.
Weights are the JAX init carried across by ``weights.params_from_jax``,
with BatchNorm running statistics and affines randomized so that the
eval-mode BatchNorm (and the cascade's folded BN) is not the identity.
"""

from __future__ import annotations

import jax
import numpy as np
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from speakerverification_tpu_torch.weights import params_from_jax

# fp32 parity: no TF32 in PyTorch's products and convolutions
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def randomized_variables(variables, seed: int = 0) -> dict:
    """numpy copy of flax ``variables`` with BN statistics drawn at
    random (mean ~ N(0, 0.2), var ~ U(0.5, 1.5)) and BN scale/bias
    perturbed."""
    rng = np.random.default_rng(seed)
    out = {}
    for col, tree in variables.items():
        flat = {}
        for path, leaf in flatten_dict(tree).items():
            a = np.asarray(leaf, np.float32).copy()
            is_bn = any(p.startswith("BatchNorm") for p in path)
            if col == "batch_stats" and path[-1] == "mean":
                a = rng.normal(0.0, 0.2, a.shape).astype(np.float32)
            elif col == "batch_stats" and path[-1] == "var":
                a = rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
            elif col == "params" and is_bn and path[-1] == "scale":
                a = rng.uniform(0.7, 1.3, a.shape).astype(np.float32)
            elif col == "params" and is_bn and path[-1] == "bias":
                a = rng.normal(0.0, 0.1, a.shape).astype(np.float32)
            flat[path] = a
        out[col] = unflatten_dict(flat)
    return out


def init_pair(flax_module, torch_module, *inputs, seed: int = 0, **apply_kw):
    """Init ``flax_module`` on ``inputs``, randomize BN, load the result
    into ``torch_module`` (checked key by key), return the variables."""
    variables = flax_module.init(jax.random.PRNGKey(seed), *inputs, **apply_kw)
    variables = randomized_variables(variables, seed)
    state = params_from_jax(variables["params"],
                            variables.get("batch_stats"), like=torch_module)
    torch_module.load_state_dict(state, strict=True)
    torch_module.eval()
    return variables


def close(got, ref, rel: float, what: str = "") -> None:
    """``max|got - ref| <= rel * max|ref|`` (with a floor of 1e-6)."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.all(np.isfinite(got)), what
    err = np.max(np.abs(got - ref))
    scale = max(np.max(np.abs(ref)), 1e-6)
    assert err <= rel * scale, f"{what}: max err {err:.3e} > {rel:g} * {scale:.3e}"


def t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def nlc_to_ncl(x: np.ndarray) -> torch.Tensor:
    """JAX ``[B, T, C]`` activations → the port's ``[B, C, T]``."""
    return t(np.transpose(x, (0, 2, 1)))


def ncl_to_nlc(x: torch.Tensor) -> np.ndarray:
    return x.detach().numpy().transpose(0, 2, 1)


def port_variables(tm, seed: int = 0) -> dict:
    """``tm``'s weights redrawn (seeded normals of variance 1/fan-in),
    BatchNorm randomized, loaded back and returned as JAX variables
    (``params_to_jax``): the JAX side needs no init of its own."""
    from speakerverification_tpu_torch.weights import params_to_jax
    torch.manual_seed(seed)
    tm.load_state_dict({k: (torch.randn_like(p) / max(p[0].numel(), 1)
                            ** 0.5 if k.endswith("weight") and p.dim() > 1
                            else p) for k, p in tm.state_dict().items()})
    params, stats = params_to_jax(tm.state_dict())
    v = randomized_variables({"params": params, "batch_stats": stats}, seed)
    tm.load_state_dict(params_from_jax(v["params"], v["batch_stats"],
                                       like=tm), strict=True)
    tm.eval()
    return v


def jax_tree_and_quant_keys(jm, x, config=None, **apply_kw):
    """Shapes of the JAX module's init tree ``{(col, path): shape}`` and
    the flax paths of the layers JAX's int8 rule quantizes in one apply
    on ``x``, both from one ``jax.eval_shape`` (no compile, no FLOPs)."""
    import flax.linen as fnn
    from flax.traverse_util import flatten_dict as _flat

    from speakerverification_tpu import quant as jq
    cfg = config or jq.QuantConfig()
    keys = set()

    def recorder(next_fun, args, kwargs, context):
        mod = context.module
        if context.method_name == "__call__" and not mod.is_initializing():
            if (jq._dense_kernel_if_quantizable(mod, args, cfg) is not None
                    or jq._conv_kernel_if_quantizable(mod, args, cfg)
                    is not None):
                keys.add(jq._module_key(mod))
        return next_fun(*args, **kwargs)

    def run(x):
        v = jm.init(jax.random.PRNGKey(0), x)
        with fnn.intercept_methods(recorder):
            jm.apply(v, x, **apply_kw)
        return v

    shapes = jax.eval_shape(run, x)
    tree = {(col,) + k: tuple(a.shape) for col, t_ in shapes.items()
            for k, a in _flat(t_).items()}
    return tree, keys


def port_tree(tm) -> dict:
    """The port module's tree as ``{(col, path): shape}`` in flax's
    layout (``params_to_jax``)."""
    from flax.traverse_util import flatten_dict as _flat

    from speakerverification_tpu_torch.weights import params_to_jax
    params, stats = params_to_jax(tm.state_dict())
    return {(col,) + k: tuple(a.shape)
            for col, t_ in (("params", params), ("batch_stats", stats))
            for k, a in _flat(t_).items()}
