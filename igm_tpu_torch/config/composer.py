"""Hydra-compatible YAML config composition.

The port's own copy of ``igm_tpu/config/composer.py`` (the port imports
nothing of ``igm_tpu``), so the same ``configs/`` tree composes for both
packages: a root config with a defaults list of config groups,
``# @package _global_`` experiment overlays that override group selections,
``${...}`` interpolation, and CLI overrides of the form
``experiment=ddpm/cifar10 model.lr=1e-3``.

It implements the subset of Hydra 1.1 behaviour the config tree exercises:

- root defaults list with group selections, ``_self_`` position, and a
  trailing ``experiment`` group;
- nested defaults in group configs: sibling includes
  (``callbacks/default.yaml`` pulls eval_fid/sample/...) and
  ``override /group[@pkg]: name`` entries (datamodule configs force a
  networks choice; experiments force model/networks/datamodule);
- ``# @package _global_`` headers (datamodule + experiment configs);
- ``${a.b.c}`` / ``${now:%fmt}`` / ``${hydra:runtime.cwd}`` interpolation
  (lenient: unresolvable references are left as literal text — the reference
  tree contains dangling ones, e.g. ``configs/experiment/age/*.yaml``
  referencing ``model.recon_z_weight``);
- CLI group overrides (``networks=mlp``) and dotted value overrides
  (``model.lr=1e-3``, ``+new.key=v``, ``~key`` to delete).

Override precedence for group selections (highest wins):
  CLI (3)  >  experiment defaults (2)  >  other group defaults (1)  >  root (0)
which reproduces Hydra's positional semantics for this tree (the experiment
entry sits after every other group in the root defaults list).
"""
from __future__ import annotations

import datetime
import os
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import yaml

from .node import ConfigNode, deep_merge, select, to_node, update

_PACKAGE_RE = re.compile(r"^#\s*@package\s+(\S+)\s*$", re.MULTILINE)


class _YamlLoader(yaml.SafeLoader):
    """SafeLoader + OmegaConf-style floats (``2e-4`` without a dot)."""


_YamlLoader.add_implicit_resolver(
    "tag:yaml.org,2002:float",
    re.compile(
        r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
            |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
            |\.[0-9_]+(?:[eE][-+][0-9]+)?
            |[-+]?\.(?:inf|Inf|INF)
            |\.(?:nan|NaN|NAN))$""",
        re.X,
    ),
    list("-+0123456789."),
)


def _yaml_load(text: str) -> Any:
    return yaml.load(text, Loader=_YamlLoader)
_INTERP_RE = re.compile(r"\$\{([^${}]+)\}")

# Groups owned by Hydra's own machinery.  Logging-color groups have no
# equivalent here and are ignored; the launcher/sweeper plugin groups the
# config tree declares (`configs/config.yaml:18`)
# ARE honoured - they select from the built-in plugin configs below (a
# `configs/hydra/<sub>/<name>.yaml` file, if present, overrides the
# built-in), composing into the `hydra.<sub>` package like real Hydra.
_PLUGIN_GROUPS = ("hydra/launcher", "hydra/sweeper")
_PLUGIN_BUILTINS: Dict[Tuple[str, str], Dict[str, Any]] = {
    ("launcher", "basic"): {"_target_": "basic"},
    # n_jobs: null == 1 worker (joblib.Parallel's own default) - safe on
    # a single card, where concurrent jobs cannot share the device;
    # opt into parallelism with hydra.launcher.n_jobs=N (CPU runs only).
    ("launcher", "joblib"): {"_target_": "joblib", "n_jobs": None,
                             "backend": "processes", "verbose": 0},
    ("sweeper", "basic"): {"_target_": "basic"},
    ("sweeper", "optuna"): {"_target_": "optuna", "direction": "minimize",
                            "study_name": None, "storage": None,
                            "n_trials": 20, "n_jobs": 1, "sampler": "tpe",
                            "seed": None, "n_startup_trials": 10,
                            "search_space": {}},
}


def _is_ignored_group(group: str) -> bool:
    return group.startswith("hydra/") and group not in _PLUGIN_GROUPS


class ComposeError(RuntimeError):
    pass


def _load_yaml(path: Path) -> Tuple[ConfigNode, Optional[str]]:
    """Load a YAML file, returning (body, package header or None)."""
    text = path.read_text()
    m = _PACKAGE_RE.search(text)
    package = m.group(1) if m else None
    data = _yaml_load(text)
    if data is None:
        data = {}
    if not isinstance(data, dict):
        raise ComposeError(f"{path}: top level must be a mapping")
    return to_node(data), package


class _DefaultsEntry:
    """One entry of a defaults list."""

    def __init__(self, raw: Any):
        self.is_self = False
        self.is_override = False
        self.group: Optional[str] = None
        self.name: Optional[str] = None
        self.package: Optional[str] = None
        if isinstance(raw, str):
            if raw == "_self_":
                self.is_self = True
            else:
                # sibling include: "- sample" inside callbacks/default.yaml
                self.name = raw
        elif isinstance(raw, dict):
            if len(raw) != 1:
                raise ComposeError(f"bad defaults entry: {raw!r}")
            key, value = next(iter(raw.items()))
            key = str(key)
            if key.startswith("override "):
                self.is_override = True
                key = key[len("override "):].strip()
            key = key.lstrip("/")
            if "@" in key:
                key, self.package = key.split("@", 1)
            self.group = key
            self.name = None if value in (None, "null") else str(value)
        else:
            raise ComposeError(f"bad defaults entry: {raw!r}")


def _parse_defaults(body: ConfigNode) -> List[_DefaultsEntry]:
    raw = body.get("defaults", [])
    return [_DefaultsEntry(e) for e in raw]


def _parse_cli_value(value: str) -> Any:
    """Parse a CLI override value: YAML, plus bare-exponent floats (5e-4).

    PyYAML follows YAML 1.1 and leaves ``5e-4`` as a string; Hydra/OmegaConf
    accept it as a float, and the reference README uses that form.
    """
    if value == "":
        return ""
    parsed = _yaml_load(value)
    if isinstance(parsed, str):
        try:
            return int(parsed)
        except ValueError:
            pass
        try:
            return float(parsed)
        except ValueError:
            pass
    return parsed


class Composer:
    def __init__(self, config_dir: str | Path, config_name: str = "config"):
        self.config_dir = Path(config_dir)
        self.config_name = config_name
        if not self.config_dir.is_dir():
            raise ComposeError(f"config dir not found: {self.config_dir}")

    # ---------------------------------------------------------------- helpers
    def _group_file(self, group: str, name: str) -> Path:
        return self.config_dir / group / f"{name}.yaml"

    def _is_group(self, token: str) -> bool:
        return (self.config_dir / token).is_dir()

    # ------------------------------------------------------------- selections
    def _resolve_selections(
        self,
        root_entries: List[_DefaultsEntry],
        cli_groups: Dict[str, Optional[str]],
    ) -> Dict[str, Optional[str]]:
        # group -> (name, rank)
        sel: Dict[str, Tuple[Optional[str], int]] = {}
        order: List[str] = []
        for e in root_entries:
            if e.is_self or e.group is None:
                continue
            if _is_ignored_group(e.group):
                continue
            sel[e.group] = (e.name, 0)
            order.append(e.group)
        for g, n in cli_groups.items():
            if g not in sel:
                order.append(g)
            sel[g] = (n, 3)

        def propose(group: str, name: Optional[str], rank: int) -> None:
            if _is_ignored_group(group):
                return
            cur = sel.get(group)
            if cur is None or rank >= cur[1]:
                sel[group] = (name, rank)
                if group not in order:
                    order.append(group)

        # Iterate to fixpoint: a selected config's own defaults may override
        # other selections (datamodule -> networks; experiment -> everything).
        for _ in range(10):
            before = dict(sel)
            for group in list(order):
                name = sel[group][0]
                if name is None or group in _PLUGIN_GROUPS:
                    continue  # plugin configs carry no nested defaults
                path = self._group_file(group, name)
                if not path.exists():
                    raise ComposeError(f"missing config: {path}")
                body, _pkg = _load_yaml(path)
                rank = 2 if group == "experiment" else 1
                for e in _parse_defaults(body):
                    if e.group is not None and e.name is not None:
                        propose(e.group, e.name, rank)
            if sel == before:
                break
        return {g: sel[g][0] for g in order}

    # ------------------------------------------------------------------ merge
    def _merge_plugin_group(self, result: ConfigNode, group: str,
                            name: str) -> ConfigNode:
        sub = group.split("/", 1)[1]  # launcher | sweeper
        path = self._group_file(group, name)
        if path.exists():
            body, _pkg = _load_yaml(path)
            body.pop("defaults", None)
        else:
            builtin = _PLUGIN_BUILTINS.get((sub, name))
            if builtin is None:
                raise ComposeError(
                    f"unknown hydra/{sub} plugin {name!r} "
                    f"(no {path} and no built-in)")
            body = to_node(builtin)
        target = ConfigNode()
        target["hydra"] = ConfigNode({sub: body})
        return deep_merge(result, target)

    def _merge_group(self, result: ConfigNode, group: str, name: str) -> ConfigNode:
        path = self._group_file(group, name)
        body, package = _load_yaml(path)
        # sibling includes first (e.g. callbacks/default.yaml -> sample, tqdm)
        for e in _parse_defaults(body):
            if not e.is_override and e.group is None and e.name and not e.is_self:
                result = self._merge_group(result, group, e.name)
        body.pop("defaults", None)
        if package == "_global_":
            return deep_merge(result, body)
        target = ConfigNode()
        node = target
        parts = (package or group).split(".")
        for p in parts[:-1]:
            node[p] = ConfigNode()
            node = node[p]
        node[parts[-1]] = body
        return deep_merge(result, target)

    # ---------------------------------------------------------------- compose
    def compose(self, overrides: Optional[List[str]] = None) -> ConfigNode:
        overrides = list(overrides or [])
        cli_groups: Dict[str, Optional[str]] = {}
        cli_values: List[Tuple[str, str, Any]] = []  # (mode, path, value)
        for ov in overrides:
            if ov.startswith("~"):
                cli_values.append(("del", ov[1:], None))
                continue
            mode = "set"
            if ov.startswith("+"):
                mode = "add"
                ov = ov[1:]
            if "=" not in ov:
                raise ComposeError(f"override must be key=value: {ov!r}")
            key, value = ov.split("=", 1)
            if key in _PLUGIN_GROUPS or (
                    "." not in key and self._is_group(key)):
                cli_groups[key] = None if value in ("null", "None") else value
            else:
                cli_values.append((mode, key, _parse_cli_value(value)))

        root_body, _ = _load_yaml(self.config_dir / f"{self.config_name}.yaml")
        root_entries = _parse_defaults(root_body)
        selections = self._resolve_selections(root_entries, cli_groups)

        result = ConfigNode()
        merged_groups = set()
        for e in root_entries:
            if e.is_self:
                self_body = root_body.copy()
                self_body.pop("defaults", None)
                result = deep_merge(result, self_body)
            elif e.group and not _is_ignored_group(e.group):
                name = selections.get(e.group)
                merged_groups.add(e.group)
                if name is not None:
                    if e.group in _PLUGIN_GROUPS:
                        result = self._merge_plugin_group(result, e.group, name)
                    else:
                        result = self._merge_group(result, e.group, name)
        # CLI-added groups not present in the root list
        for g, name in selections.items():
            if g not in merged_groups and name is not None:
                if g in _PLUGIN_GROUPS:
                    result = self._merge_plugin_group(result, g, name)
                else:
                    result = self._merge_group(result, g, name)

        for mode, path, value in cli_values:
            if mode == "del":
                parent_path, _, leaf = path.rpartition(".")
                parent = select(result, parent_path) if parent_path else result
                parent.pop(leaf, None)
            else:
                update(result, path, value)

        resolve_interpolations(result)
        return result


def resolve_interpolations(cfg: ConfigNode, max_passes: int = 20) -> None:
    """Resolve ``${...}`` references in place (lenient on dangling refs)."""
    runtime_cwd = os.getcwd()

    def resolve_token(token: str) -> Tuple[bool, Any]:
        token = token.strip()
        if token.startswith("now:"):
            return True, datetime.datetime.now().strftime(token[len("now:"):])
        if token == "hydra:runtime.cwd":
            return True, runtime_cwd
        if token.startswith("hydra:"):
            return False, None
        if token.startswith("env:"):
            name = token[len("env:"):]
            return (name in os.environ), os.environ.get(name)
        try:
            value = select(cfg, token)
        except KeyError:
            return False, None
        if isinstance(value, str) and _INTERP_RE.search(value):
            return False, None  # not yet resolved; retry next pass
        return True, value

    for _ in range(max_passes):
        changed = False

        def visit(node: Any) -> Any:
            nonlocal changed
            if isinstance(node, dict):
                for k in list(node.keys()):
                    node[k] = visit(node[k])
                return node
            if isinstance(node, list):
                for i in range(len(node)):
                    node[i] = visit(node[i])
                return node
            if isinstance(node, str):
                m = _INTERP_RE.fullmatch(node)
                if m:  # whole-string interpolation keeps the value's type
                    ok, value = resolve_token(m.group(1))
                    if ok:
                        changed = True
                        return value
                    return node

                def sub(mm: "re.Match[str]") -> str:
                    nonlocal changed
                    ok, value = resolve_token(mm.group(1))
                    if ok:
                        changed = True
                        return str(value)
                    return mm.group(0)

                return _INTERP_RE.sub(sub, node)
            return node

        visit(cfg)
        if not changed:
            break


def compose(
    config_dir: str | Path,
    overrides: Optional[List[str]] = None,
    config_name: str = "config",
) -> ConfigNode:
    return Composer(config_dir, config_name).compose(overrides)
