"""Case-insensitive component registries.

Mirrors the reference's model registry semantics
(separation/look2hear/models/__init__.py:28-60: ``register_model`` +
case-insensitive ``get(identifier)``), generalized for models/losses/metrics.
"""

from __future__ import annotations

from typing import Any, Callable


class Registry:
    def __init__(self, kind: str):
        self.kind = kind
        self._items: dict[str, Any] = {}

    def register(self, obj: Any = None, *, name: str | None = None):
        def _do(o):
            key = (name or o.__name__).lower()
            if key in self._items and self._items[key] is not o:
                raise ValueError(f"duplicate {self.kind} name {key!r}")
            self._items[key] = o
            return o

        return _do(obj) if obj is not None else _do

    def get(self, identifier: str | Any) -> Any:
        if not isinstance(identifier, str):
            if callable(identifier):
                return identifier
            raise ValueError(f"cannot resolve {self.kind}: {identifier!r}")
        try:
            return self._items[identifier.lower()]
        except KeyError:
            raise KeyError(
                f"unknown {self.kind} {identifier!r}; known: {sorted(self._items)}"
            ) from None

    def names(self) -> list[str]:
        return sorted(self._items)
