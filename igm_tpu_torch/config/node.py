"""Attribute-access config container (OmegaConf-DictConfig stand-in).

The port's own copy of ``igm_tpu/config/node.py``: the port imports nothing
of ``igm_tpu``.  It keeps the subset of ``DictConfig`` behaviour the config
tree relies on: attribute access, ``get``, ``in``, deep-merge, and
dotted-path select/update.
"""
from __future__ import annotations

from typing import Any, Iterator


class ConfigNode(dict):
    """dict with attribute access; missing attribute raises AttributeError."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    # OmegaConf-ism used by reference models: cfg.get("key", default)
    # (dict.get already does this).

    def copy(self) -> "ConfigNode":
        return to_node({k: v for k, v in self.items()})


def to_node(obj: Any) -> Any:
    """Recursively convert dicts to ConfigNode (lists converted in place)."""
    if isinstance(obj, dict):
        return ConfigNode({k: to_node(v) for k, v in obj.items()})
    if isinstance(obj, list):
        return [to_node(v) for v in obj]
    return obj


def to_plain(obj: Any) -> Any:
    """Inverse of to_node: plain dicts/lists (for yaml dump / orbax metadata)."""
    if isinstance(obj, dict):
        return {k: to_plain(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [to_plain(v) for v in obj]
    return obj


def deep_merge(base: Any, overlay: Any) -> Any:
    """Merge ``overlay`` onto ``base`` (overlay wins; dicts merge recursively).

    Mirrors OmegaConf.merge semantics for the cases the config tree uses:
    a dict merged onto a dict merges per-key; anything else replaces.
    """
    if isinstance(base, dict) and isinstance(overlay, dict):
        out = ConfigNode(dict(base))
        for k, v in overlay.items():
            if k in out:
                out[k] = deep_merge(out[k], v)
            else:
                out[k] = to_node(v)
        return out
    return to_node(overlay)


def select(cfg: Any, path: str, default: Any = ...) -> Any:
    """Fetch ``a.b.c`` from nested config. Raises KeyError unless default given."""
    node = cfg
    for part in path.split("."):
        if isinstance(node, dict) and part in node:
            node = node[part]
        elif isinstance(node, list) and part.lstrip("-").isdigit():
            node = node[int(part)]
        else:
            if default is ...:
                raise KeyError(path)
            return default
    return node


def update(cfg: Any, path: str, value: Any) -> None:
    """Set ``a.b.c`` in nested config, creating intermediate nodes."""
    parts = path.split(".")
    node = cfg
    for part in parts[:-1]:
        if isinstance(node, dict):
            if part not in node or not isinstance(node[part], (dict, list)):
                node[part] = ConfigNode()
            node = node[part]
        elif isinstance(node, list):
            node = node[int(part)]
        else:
            raise TypeError(f"cannot descend into {type(node)} at {part!r} of {path!r}")
    last = parts[-1]
    if isinstance(node, list):
        node[int(last)] = to_node(value)
    else:
        node[last] = to_node(value)


def walk_strings(cfg: Any, path: tuple = ()) -> Iterator[tuple]:
    """Yield (path_tuple, value) for every string leaf."""
    if isinstance(cfg, dict):
        for k, v in cfg.items():
            yield from walk_strings(v, path + (k,))
    elif isinstance(cfg, list):
        for i, v in enumerate(cfg):
            yield from walk_strings(v, path + (i,))
    elif isinstance(cfg, str):
        yield path, cfg
