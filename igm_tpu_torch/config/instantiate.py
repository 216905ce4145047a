"""``_target_``-based object instantiation (hydra.utils.instantiate stand-in).

The port's own copy of ``igm_tpu/config/instantiate.py``.  Instantiation is
non-recursive: nested configs are passed through as plain config, and the
model instantiates its networks itself.

The shared ``configs/`` tree names ``igm_tpu.*`` targets, and reference-style
trees name ``src.*`` ones; both resolve to this package, so the same YAML
builds port objects.
"""
from __future__ import annotations

import importlib
from typing import Any

# target prefix -> port module path
_TARGET_ALIASES = {
    "src.models": "igm_tpu_torch.models",
    "src.networks": "igm_tpu_torch.networks",
    "src.datamodules": "igm_tpu_torch.data",
    "src.callbacks": "igm_tpu_torch.callbacks",
    "src.utils": "igm_tpu_torch.utils",
    "igm_tpu": "igm_tpu_torch",
}


def resolve_target(target: str) -> Any:
    for prefix, repl in _TARGET_ALIASES.items():
        if target == prefix:
            target = repl
            break
        if target.startswith(prefix + "."):
            target = repl + target[len(prefix):]
            break
    module_path, _, attr = target.rpartition(".")
    if not module_path:
        raise ImportError(f"bad target: {target!r}")
    module = importlib.import_module(module_path)
    try:
        return getattr(module, attr)
    except AttributeError as e:
        raise ImportError(f"{target!r}: module {module_path!r} has no {attr!r}") from e


def instantiate(cfg: Any, /, **kwargs: Any) -> Any:
    """Instantiate ``cfg['_target_']`` with the config's keys as kwargs.

    Non-recursive: nested ConfigNode values are passed through untouched.
    Explicit ``kwargs`` override config keys.
    """
    if cfg is None:
        raise TypeError("instantiate(None)")
    if not isinstance(cfg, dict):
        raise TypeError(f"instantiate expects a config mapping, got {type(cfg)}")
    if "_target_" not in cfg:
        raise ValueError(f"config has no _target_: {list(cfg.keys())}")
    cls = resolve_target(str(cfg["_target_"]))
    call_kwargs = {
        k: v
        for k, v in cfg.items()
        if k not in ("_target_", "_recursive_", "_convert_", "defaults")
    }
    call_kwargs.update(kwargs)
    return cls(**call_kwargs)
