"""YAML configuration with ``!ref`` interpolation and CLI overlay.

The port's own copy of ``speakerverification_tpu/config.py``: the same
subset of HyperPyYAML, so one yaml file drives both packages.

* ``!ref <key>`` — substitute the value of a top-level key.
* ``!ref <a[b]>`` / ``<a[b][c]>`` — indexing into nested mappings/lists.
* ``!ref prefix/<key>/suffix`` — string interpolation.
* ``!ref <a> * 3`` — arithmetic over resolved numeric values.

PyYAML is imported inside :func:`load_yaml` and :func:`dump_config`
only: the serving path can run from hparams built in code on a machine
without it.
"""

from __future__ import annotations

import ast
import copy
import operator
import re
from pathlib import Path
from typing import Any, Mapping

__all__ = ["read_config", "load_yaml", "resolve_refs", "dump_config"]

_REF_TOKEN = re.compile(r"<([^<>]+)>")

_BINOPS = {
    ast.Add: operator.add,
    ast.Sub: operator.sub,
    ast.Mult: operator.mul,
    ast.Div: operator.truediv,
    ast.FloorDiv: operator.floordiv,
    ast.Mod: operator.mod,
    ast.Pow: operator.pow,
}
_UNARYOPS = {ast.USub: operator.neg, ast.UAdd: operator.pos}


class _Ref(str):
    """Marker type: a raw ``!ref`` string awaiting resolution."""


def _safe_eval(expr: str) -> Any:
    """Evaluate a numeric arithmetic expression without ``eval``."""

    def ev(node: ast.AST) -> Any:
        if isinstance(node, ast.Expression):
            return ev(node.body)
        if isinstance(node, ast.Constant):
            return node.value
        if isinstance(node, ast.BinOp) and type(node.op) in _BINOPS:
            return _BINOPS[type(node.op)](ev(node.left), ev(node.right))
        if isinstance(node, ast.UnaryOp) and type(node.op) in _UNARYOPS:
            return _UNARYOPS[type(node.op)](ev(node.operand))
        raise ValueError(f"unsupported expression in !ref: {expr!r}")

    return ev(ast.parse(expr, mode="eval"))


def _lookup(root: Mapping[str, Any], path: str) -> Any:
    """Resolve ``a[b][c]`` paths against the top-level mapping."""
    m = re.match(r"^([^\[\]]+)((\[[^\[\]]+\])*)$", path.strip())
    if m is None:
        raise KeyError(f"bad !ref path: {path!r}")
    key, idx_part = m.group(1), m.group(2)
    if key not in root:
        raise KeyError(f"!ref to unknown key: {key!r}")
    value = root[key]
    for idx in re.findall(r"\[([^\[\]]+)\]", idx_part or ""):
        if isinstance(value, Mapping):
            value = value[idx]
        else:
            value = value[int(idx)]
    return value


def _resolve_value(value: Any, root: Mapping[str, Any], depth: int = 0) -> Any:
    if depth > 32:
        raise RecursionError("circular !ref chain")
    if isinstance(value, _Ref):
        return _resolve_ref(str(value), root, depth)
    if isinstance(value, dict):
        return {k: _resolve_value(v, root, depth) for k, v in value.items()}
    if isinstance(value, list):
        return [_resolve_value(v, root, depth) for v in value]
    return value


def _resolve_ref(text: str, root: Mapping[str, Any], depth: int) -> Any:
    tokens = _REF_TOKEN.findall(text)
    if not tokens:
        return text

    # pure single-token reference: return the referenced value natively
    stripped = text.strip()
    if stripped.startswith("<") and stripped.endswith(">") and len(tokens) == 1 \
            and _REF_TOKEN.fullmatch(stripped):
        return _resolve_value(_lookup(root, tokens[0]), root, depth + 1)

    resolved = {t: _resolve_value(_lookup(root, t), root, depth + 1) for t in tokens}

    # arithmetic over numbers, e.g. `cohort_size: !ref <nClasses> * 3`
    if all(isinstance(v, (int, float)) and not isinstance(v, bool)
           for v in resolved.values()):
        expr = _REF_TOKEN.sub(lambda m: repr(resolved[m.group(1)]), text)
        if re.fullmatch(r"[\d\s\.\+\-\*/%\(\)eE]+", expr) and any(
                op in expr for op in "+-*/%") and not re.search(r"[a-df-zA-DF-Z]", expr):
            try:
                return _safe_eval(expr)
            except (ValueError, SyntaxError):
                pass

    # string interpolation, e.g. `!ref <output_folder>/save`
    return _REF_TOKEN.sub(lambda m: str(resolved[m.group(1)]), text)


def resolve_refs(raw: Mapping[str, Any]) -> dict:
    """Resolve all ``!ref`` placeholders against the top-level namespace."""
    return {k: _resolve_value(v, raw) for k, v in raw.items()}


def load_yaml(path: str | Path) -> dict:
    import yaml

    class _ConfigLoader(yaml.SafeLoader):
        pass

    _ConfigLoader.add_constructor(
        "!ref", lambda loader, node: _Ref(loader.construct_scalar(node)))
    with open(path) as fin:
        raw = yaml.load(fin, Loader=_ConfigLoader)
    if raw is None:
        return {}
    if not isinstance(raw, dict):
        raise TypeError(f"top-level YAML in {path} must be a mapping")
    return resolve_refs(raw)


def read_config(config_path: str | Path, args: Any = None,
                overrides: Mapping[str, Any] | None = None) -> dict:
    """Load a YAML config and overlay CLI arguments on top: every
    attribute of ``args`` (an argparse ``Namespace`` or mapping), then
    every key of ``overrides``, overwrites the YAML key."""
    hparams = load_yaml(config_path)
    if args is not None:
        items = args.items() if isinstance(args, Mapping) else vars(args).items()
        for k, v in items:
            hparams[k] = v
    if overrides:
        for k, v in overrides.items():
            hparams[k] = v
    return hparams


def dump_config(config: Mapping[str, Any], path: str | Path) -> None:
    """Freeze the resolved config beside a run's directories."""
    import yaml
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as fout:
        yaml.safe_dump(_plain(config), fout, sort_keys=False)


def _plain(obj: Any) -> Any:
    if isinstance(obj, Mapping):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if isinstance(obj, Path):
        return str(obj)
    return copy.copy(obj)
