from .node import ConfigNode, deep_merge, select, to_node, to_plain, update
from .composer import Composer, ComposeError, compose, resolve_interpolations
from .instantiate import instantiate, resolve_target

__all__ = [
    "ConfigNode", "deep_merge", "select", "to_node", "to_plain", "update",
    "Composer", "ComposeError", "compose", "resolve_interpolations",
    "instantiate", "resolve_target",
]
