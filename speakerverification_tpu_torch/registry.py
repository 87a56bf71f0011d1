"""Explicit registries keyed by the YAML names (``model.name`` etc.).

The port's own copy of ``speakerverification_tpu/registry.py``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

__all__ = ["Registry", "MODELS", "LOSSES", "OPTIMIZERS", "SCHEDULERS"]


class Registry:
    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, Any] = {}

    def register(self, name: str | None = None, aliases: tuple[str, ...] = ()):
        def deco(obj: Callable) -> Callable:
            key = name or obj.__name__
            for k in (key, *aliases):
                if k in self._entries:
                    raise KeyError(f"{self.kind} {k!r} already registered")
                self._entries[k] = obj
            return obj
        return deco

    def get(self, name: str) -> Any:
        try:
            return self._entries[name]
        except KeyError:
            known = ", ".join(sorted(self._entries))
            raise KeyError(
                f"unknown {self.kind} {name!r}; registered: {known}") from None

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def names(self) -> list[str]:
        return sorted(self._entries)


MODELS = Registry("model")
LOSSES = Registry("loss")
OPTIMIZERS = Registry("optimizer")
SCHEDULERS = Registry("scheduler")
