"""Config system: YAML + ``${a.b}`` interpolation + ``_target_`` instantiation.

A copy of ``sonicsim_tpu.utils.config`` for the port. The repo's configs
name JAX-package targets (``_target_: sonicsim_tpu.models.ConvTasNet``);
``import_target`` maps each to the port's module of the same path and never
imports the JAX package, so one YAML file drives either package. A target
the port lacks raises ``ImportError``. PyYAML is imported only by
``load_config`` and ``save_config``: the package imports without it.
"""

from __future__ import annotations

import importlib
import re
from pathlib import Path
from typing import Any

_INTERP_RE = re.compile(r"\$\{([^}]+)\}")
_JAX_PACKAGE = "sonicsim_tpu."
_PORT_PACKAGE = "sonicsim_tpu_torch."


def _lookup(root: Any, dotted: str) -> Any:
    node = root
    for part in dotted.split("."):
        if isinstance(node, dict):
            node = node[part]
        else:
            node = node[int(part)]
    return node


def _resolve(node: Any, root: Any) -> Any:
    if isinstance(node, dict):
        return {k: _resolve(v, root) for k, v in node.items()}
    if isinstance(node, list):
        return [_resolve(v, root) for v in node]
    if isinstance(node, str):
        full = _INTERP_RE.fullmatch(node)
        if full:  # whole-string interpolation keeps the referenced type
            return _resolve(_lookup(root, full.group(1)), root)
        return _INTERP_RE.sub(
            lambda m: str(_resolve(_lookup(root, m.group(1)), root)), node
        )
    return node


def load_config(path: str | Path) -> dict:
    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f)
    return _resolve(cfg, cfg)


def save_config(cfg: dict, path: str | Path) -> None:
    import yaml

    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)


def port_target(target: str) -> str:
    """``sonicsim_tpu.a.B`` → ``sonicsim_tpu_torch.a.B``; other paths as
    they are."""
    if target.startswith(_JAX_PACKAGE):
        return _PORT_PACKAGE + target[len(_JAX_PACKAGE):]
    return target


def import_target(target: str) -> Any:
    """Import ``pkg.module.Attr`` (tries progressively shorter module paths),
    with a JAX-package path read as the port's (:func:`port_target`)."""
    target = port_target(target)
    parts = target.split(".")
    for split in range(len(parts) - 1, 0, -1):
        name = ".".join(parts[:split])
        try:
            mod = importlib.import_module(name)
        except ModuleNotFoundError as e:
            # Only "this prefix isn't a module" should fall through to a
            # shorter prefix; a module that EXISTS but fails to import
            # (missing dependency, syntax error) must surface as-is.
            if e.name and not name.startswith(e.name):
                raise
            continue
        obj: Any = mod
        try:
            for attr in parts[split:]:
                obj = getattr(obj, attr)
        except AttributeError:
            continue
        return obj
    raise ImportError(f"cannot import target {target!r}")


def instantiate(node: Any, **overrides: Any) -> Any:
    """Recursively build objects from ``_target_`` nodes (hydra-style)."""
    if isinstance(node, list):
        return [instantiate(v) for v in node]
    if not isinstance(node, dict):
        return node
    if "_target_" not in node:
        return {k: instantiate(v) for k, v in node.items()}
    kwargs = {
        k: instantiate(v) for k, v in node.items() if k not in ("_target_", "_partial_")
    }
    kwargs.update(overrides)
    cls = import_target(node["_target_"])
    if node.get("_partial_"):
        import functools

        return functools.partial(cls, **kwargs)
    return cls(**kwargs)
