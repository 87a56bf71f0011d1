"""Reverse weight port: a JAX-layout msgpack tree → a torch ``state_dict``
(port of ``compat/torch_export.py``).

The forward converter (``compat/torch_port.py``) maps a reference torch
checkpoint onto the JAX layout with pure LAYOUT operations (transposes,
reshapes, slices — no arithmetic but the GRU's r/z bias fold). This
module inverts any registered porter mechanically, without per-family
inverse code, by *id tracing*:

1. build a probe state dict with the torch-side key/shape manifest where
   every element holds a globally unique float64 integer id,
2. run the forward porter on the probe — each flax leaf now carries the
   ids of exactly the torch elements it was built from,
3. scatter the real checkpoint's leaf values back through those ids.

Because porters are value-permutations, the reconstruction is exact (and
is verified by re-running the forward porter on the result). Torch keys
a porter never consumes (``num_batches_tracked``) are synthesized.

The reference exports ONNX with ``torch.onnx.export`` on its own torch
modules; this tool is the route back there: weights trained or
fine-tuned here land in the reference's ``MainModel`` through
``load_state_dict``.

The torch-side shape manifest comes from ``--like`` (any reference
checkpoint of the family) or a ``--shapes`` JSON (the forward converter
CLI writes one next to its output).
"""

from __future__ import annotations

import json
from pathlib import Path
from types import SimpleNamespace
from typing import Mapping, Sequence

import numpy as np

from speakerverification_tpu_torch.compat.torch_port import (
    _PORTERS,
    _strip_reference_prefixes,
    porter_args,
    read_reference_checkpoint,
)

__all__ = ["reverse_port", "shapes_of_state_dict", "porter_args"]


def shapes_of_state_dict(sd: Mapping) -> dict:
    """``key -> list(shape)`` manifest from a (prefixed or bare) torch
    state dict; strips the reference's wrapper prefixes first."""
    return {k: list(np.asarray(
        v.detach().cpu().numpy() if hasattr(v, "detach") else v).shape)
        for k, v in _strip_reference_prefixes(sd).items()}


def _leaves(tree, prefix="") -> list:
    out = []
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.extend(_leaves(v, path))
        else:
            out.append((path, np.asarray(v)))
    return out


# Constant buffers the reference registers but no porter consumes
# (they are fixed values, not learned state): synthesized when no
# ``fill_from`` checkpoint is available. Keyed by key SUFFIX.
_CONSTANT_BUFFERS = {
    # PreEmphasis conv kernel (src/utils.py PreEmphasis: coefficient
    # 0.97, kernel [-coef, 1] in a [1, 1, 2] conv buffer)
    "flipped_filter": lambda shape: np.array(
        [-0.97, 1.0], dtype=np.float32).reshape(shape),
}


def reverse_port(tree: Mapping, torch_shapes: Mapping[str, Sequence[int]],
                 arch: str, args: SimpleNamespace | None = None,
                 verify: bool = True,
                 fill_from: Mapping | None = None,
                 allow_zero_fill: bool = False) -> dict:
    """Invert the ``arch`` porter: Flax ``tree`` (the converter's
    ``{"params": {"backbone": ...}, "batch_stats": {"backbone": ...}}``
    layout, loss head optional) → bare torch-key ``state_dict`` of
    float32 numpy arrays (wrap in torch tensors to ``load_state_dict``).

    ``fill_from``: source for torch keys the porter never consumes —
    constant buffers (PreEmphasis ``flipped_filter``, precomputed
    filterbanks) and dead modules. With the CLI's ``--like`` checkpoint
    these inherit the reference values; without one, KNOWN constant
    buffers are synthesized (``_CONSTANT_BUFFERS``) and anything else
    unfilled raises unless ``allow_zero_fill`` — a zero-filled
    functional buffer would load ``strict=True`` and then silently
    compute garbage.
    """
    if arch not in _PORTERS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_PORTERS)}")
    args = args or porter_args()

    # 1. probe TWICE: ids 1..N and their squares (shifted by 1 so id 0
    #    is distinguishable inside sums). A pure-layout porter gives
    #    every output element (v1, v2) with v2 == v1². A porter that
    #    FOLDS two torch elements a+b (the GRU r/z bias fold,
    #    torch_port._gru_at) gives power sums s1 = a+b, s2 = a²+b² —
    #    exactly solvable: a, b are the integer roots of
    #    t² − s1·t + (s1²−s2)/2. float64 is exact here far beyond any
    #    checkpoint's element count (ids < 2^26, squares < 2^52).
    keys = [k for k in torch_shapes if not k.endswith("num_batches_tracked")]
    sizes = np.array([int(np.prod(torch_shapes[k])) for k in keys],
                     dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    total = int(offsets[-1])

    def run_probe(values: np.ndarray) -> dict:
        probe = {k: values[offsets[i]:offsets[i] + sizes[i]]
                 .reshape(torch_shapes[k]) for i, k in enumerate(keys)}
        pp, ps = _PORTERS[arch](probe, args)
        return dict(_leaves({"params": {"backbone": pp},
                             "batch_stats": {"backbone": ps}}))

    base = np.arange(1, total + 1, dtype=np.float64)
    id_leaves = run_probe(base)
    sq_leaves = run_probe(base * base)

    # 2. align the real tree's leaves with the probe leaves
    val_leaves = dict(_leaves({
        "params": {"backbone": tree["params"]["backbone"]},
        "batch_stats": {"backbone": tree.get("batch_stats", {})
                        .get("backbone", {})}}))
    missing = set(id_leaves) - set(val_leaves)
    if missing:
        raise ValueError(
            f"checkpoint lacks leaves the {arch} porter produces "
            f"(wrong family?): {sorted(missing)[:5]}")

    flat = np.full(total, np.nan, dtype=np.float64)

    def scatter(idx, vals64):
        prev = flat[idx]
        dup = ~np.isnan(prev)
        if dup.any() and not np.array_equal(prev[dup], vals64[dup]):
            raise ValueError(
                "inconsistent values for shared torch elements")
        flat[idx] = vals64

    for path, ids in id_leaves.items():
        vals = val_leaves[path]
        if tuple(vals.shape) != tuple(ids.shape):
            raise ValueError(
                f"shape mismatch at {path}: checkpoint "
                f"{tuple(vals.shape)} vs porter {tuple(ids.shape)}")
        v1 = np.asarray(ids, np.float64).ravel()
        v2 = np.asarray(sq_leaves[path], np.float64).ravel()
        vals64 = np.asarray(vals, np.float64).ravel()
        ints = np.rint(v1)
        single = (v1 == ints) & (ints >= 1) & (ints <= total) \
            & (v2 == v1 * v1)
        if single.all():
            scatter(ints.astype(np.int64) - 1, vals64)
            continue
        # 2-term folds: solve the power sums for {a, b}
        rest = ~single
        s1, s2 = v1[rest], v2[rest]
        disc = 2.0 * s2 - s1 * s1          # (a-b)^2
        root = np.sqrt(np.maximum(disc, 0.0))
        a = np.rint((s1 + root) / 2.0)
        b = np.rint((s1 - root) / 2.0)
        ok = ((a + b == s1) & (a * a + b * b == s2)
              & (a >= 1) & (a <= total) & (b >= 1) & (b <= total)
              & (a != b))
        if not ok.all():
            raise ValueError(
                f"porter for {arch!r} applies a transform at {path} that "
                f"is neither a layout map nor a 2-term fold — cannot "
                f"invert mechanically")
        scatter(ints[single].astype(np.int64) - 1, vals64[single])
        # underdetermined by construction (torch only ever uses the
        # SUM of the folded pair): put the full value in the first
        # source and zero in the second — functionally exact, and the
        # verify pass below re-checks through the forward porter
        scatter(a.astype(np.int64) - 1, vals64[rest])
        scatter(b.astype(np.int64) - 1, np.zeros_like(vals64[rest]))

    # 3. slice back into torch keys; synthesize never-consumed entries
    fill = dict(_strip_reference_prefixes(fill_from)) if fill_from else {}
    sd, dropped = {}, []
    for i, k in enumerate(keys):
        chunk = flat[offsets[i]:offsets[i + 1]]
        holes = np.isnan(chunk)
        if holes.all():
            if k in fill:
                v = fill[k]
                sd[k] = np.asarray(
                    v.detach().cpu().numpy() if hasattr(v, "detach") else v,
                    np.float32).reshape(torch_shapes[k])
                continue
            suffix = k.rsplit(".", 1)[-1]
            if suffix in _CONSTANT_BUFFERS:
                sd[k] = _CONSTANT_BUFFERS[suffix](tuple(torch_shapes[k]))
                continue
            dropped.append(k)
            chunk = np.zeros_like(chunk)
        elif holes.any():
            raise ValueError(
                f"torch key {k} only partially reconstructed "
                f"({int(holes.sum())}/{chunk.size} elements missing)")
        sd[k] = chunk.reshape(torch_shapes[k]).astype(np.float32)
    for k in torch_shapes:
        if k.endswith("num_batches_tracked"):
            sd[k] = np.zeros(torch_shapes[k], dtype=np.int64)
    if dropped and not (fill_from or allow_zero_fill):
        # Without a donor checkpoint we cannot tell dead modules from
        # load-bearing constant buffers — a zero-filled buffer would
        # load strict=True and then silently compute garbage (review
        # finding r5). Make the user choose.
        raise ValueError(
            f"{len(dropped)} torch keys are never read by the {arch} "
            f"porter and have no known constant value: "
            f"{sorted(dropped)[:8]}. Re-run with --like "
            f"<reference checkpoint> to inherit their values, or pass "
            f"--zero_fill_missing / allow_zero_fill=True if you know "
            f"they are dead modules (e.g. out_bn=False BN layers).")
    if dropped:
        print(f"note: zero-filled torch keys the porter never reads: "
              f"{sorted(dropped)[:8]}")

    # loss head (margin-family class centers) if present in the tree
    loss = tree.get("params", {}).get("loss", {})
    for name in ("weight", "W"):
        if name in loss:
            sd[f"__L__.{name}"] = np.asarray(loss[name], np.float32)

    if verify:
        r_params, r_stats = _PORTERS[arch](
            {k: v for k, v in sd.items() if not k.startswith("__L__.")},
            args)
        for path, vals in _leaves({"params": {"backbone": r_params},
                                   "batch_stats": {"backbone": r_stats}}):
            np.testing.assert_array_equal(
                vals.astype(np.float32),
                np.asarray(val_leaves[path], np.float32),
                err_msg=f"round-trip mismatch at {path}")
    return sd


def _main(argv=None) -> None:
    """Reverse checkpoint converter CLI:

        python -m speakerverification_tpu_torch.compat.torch_export \\
            --arch ECAPA_TDNN --input ours.msgpack \\
            --like reference_best_state.pt --output state_dict.pt

    Writes a torch ``state_dict`` (``--prefix __S__.`` etc. available
    for WrappedModel-shaped consumers) that the reference's MainModel
    loads directly — the supported route to ``torch.onnx.export``."""
    import argparse

    import torch

    from speakerverification_tpu_torch.checkpoint import msgpack_restore

    p = argparse.ArgumentParser(description=_main.__doc__)
    p.add_argument("--arch", required=True, choices=sorted(_PORTERS))
    p.add_argument("--input", required=True, help="our msgpack checkpoint")
    p.add_argument("--output", required=True, help=".pt state_dict output")
    p.add_argument("--like", help="torch checkpoint to take key/shapes from")
    p.add_argument("--shapes", help="key->shape JSON manifest "
                   "(written by the forward converter CLI)")
    p.add_argument("--prefix", default="",
                   help="prepend to backbone keys (e.g. '__S__.')")
    p.add_argument("--n_blocks", type=int, default=4)
    p.add_argument("--res2net_scale", type=int, default=8)
    p.add_argument("--model_scale", type=int, default=8)
    p.add_argument("--n_mega_blocks", type=int, default=None)
    p.add_argument("--no_verify", action="store_true")
    p.add_argument("--zero_fill_missing", action="store_true",
                   help="with --shapes: zero-fill torch keys the porter "
                        "never reads instead of erroring (only safe when "
                        "they are dead modules)")
    a = p.parse_args(argv)

    if bool(a.like) == bool(a.shapes):
        p.error("exactly one of --like / --shapes is required")
    ref = None
    if a.like:
        ref = read_reference_checkpoint(a.like)
        torch_shapes = shapes_of_state_dict(ref)
    else:
        torch_shapes = json.loads(Path(a.shapes).read_text())

    tree = msgpack_restore(Path(a.input).read_bytes())
    sd = reverse_port(tree, torch_shapes, a.arch,
                      porter_args(n_blocks=a.n_blocks,
                                  res2net_scale=a.res2net_scale,
                                  model_scale=a.model_scale,
                                  n_mega_blocks=a.n_mega_blocks),
                      verify=not a.no_verify, fill_from=ref,
                      allow_zero_fill=a.zero_fill_missing)

    # (reshaped: ascontiguousarray makes a 0-d num_batches_tracked 1-d)
    out = {a.prefix + k if not k.startswith("__L__.") else k:
           torch.from_numpy(np.ascontiguousarray(v).reshape(np.shape(v)))
           for k, v in sd.items()}
    Path(a.output).parent.mkdir(parents=True, exist_ok=True)
    torch.save(out, a.output)
    n = sum(v.numel() for v in out.values())
    print(f"wrote {a.output} ({n:,} elements, arch {a.arch}, "
          f"{'verified round-trip' if not a.no_verify else 'unverified'})")


if __name__ == "__main__":
    _main()
