"""Hydra sweep-override syntax -> search-space distributions: the port's own
copy of ``igm_tpu/sweep/space.py`` (the same grammar, the same grids).

The override grammar of the hydra-optuna-sweeper and hydra-joblib-launcher
plugins the reference declares, for ``python -m igm_tpu_torch.train -m``:

    model.lr=interval(1e-4,1e-1)          continuous uniform
    model.lr=tag(log, interval(1e-4,1e-1))  log-uniform
    model.hidden=range(32,256,32)         int grid (choice for TPE)
    model.act=choice(relu,tanh)           categorical
    model.lr=1e-3,5e-4                    plain comma list == choice

`parse_override` classifies one `key=value` CLI token; values that match
none of the sweep forms are fixed overrides.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

_FUNC_RE = re.compile(r"^(interval|range|choice|tag)\((.*)\)$")


def _split_args(body: str) -> List[str]:
    """Split a top-level comma list, respecting nested parentheses."""
    parts, depth, cur = [], 0, []
    for ch in body:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    if cur or parts:
        parts.append("".join(cur).strip())
    return parts


def _scalar(text: str) -> Any:
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            continue
    if text in ("true", "True"):
        return True
    if text in ("false", "False"):
        return False
    return text


@dataclass
class Dist:
    """One search dimension.

    kind: 'float' (uniform, optionally log), 'int' (inclusive range) or
    'categorical'.
    """

    kind: str
    low: float = 0.0
    high: float = 1.0
    log: bool = False
    step: Optional[float] = None
    choices: List[Any] = field(default_factory=list)

    def grid(self) -> List[Any]:
        """Expansion for the basic (cartesian) sweeper; interval() has none."""
        if self.kind == "categorical":
            return list(self.choices)
        if self.kind == "int":
            step = int(self.step or 1)
            return list(range(int(self.low), int(self.high) + 1, step))
        if self.step:  # stepped float range(): enumerable like Hydra's
            n = int(round((self.high - self.low) / self.step))
            vals = [round(self.low + i * self.step, 12) for i in range(n + 1)]
            return [v for v in vals if v <= self.high + 1e-12]
        raise ValueError(
            "a continuous interval() has no finite grid - use "
            "hydra/sweeper=optuna to search it")


def _parse_value(value: str, log: bool = False) -> Optional[Dist]:
    value = value.strip()
    if value.startswith(("[", "{")):
        return None  # YAML list/dict value, not a sweep form
    m = _FUNC_RE.match(value)
    if not m:
        if "," in value:
            return Dist(kind="categorical",
                        choices=[_scalar(v) for v in _split_args(value)])
        return None
    func, body = m.group(1), m.group(2)
    args = _split_args(body)
    if func == "tag":
        tags = [a for a in args if not _FUNC_RE.match(a)]
        inner = [a for a in args if _FUNC_RE.match(a)]
        if len(inner) != 1:
            raise ValueError(f"tag() needs one distribution: {value!r}")
        return _parse_value(inner[0], log=log or ("log" in tags))
    if func == "interval":
        if len(args) != 2:
            raise ValueError(f"interval(lo,hi) expects 2 args: {value!r}")
        lo, hi = (float(_scalar(a)) for a in args)
        return Dist(kind="float", low=lo, high=hi, log=log)
    if func == "range":
        if not 2 <= len(args) <= 3:
            raise ValueError(f"range(lo,hi[,step]) expects 2-3 args: {value!r}")
        nums = [_scalar(a) for a in args]
        step = nums[2] if len(nums) == 3 else 1
        if all(isinstance(n, int) for n in nums):
            # Hydra's range() upper bound is exclusive.
            return Dist(kind="int", low=nums[0], high=nums[1] - 1, step=step)
        lo, hi = float(nums[0]), float(nums[1])
        return Dist(kind="float", low=lo, high=hi, log=log, step=float(step))
    if func == "choice":
        return Dist(kind="categorical", choices=[_scalar(a) for a in args])
    return None


def parse_override(token: str) -> Tuple[str, Optional[Dist]]:
    """`key=value` -> (key, Dist) if value is a sweep form, else (key, None).

    `+key=a,b` sweeps too (Hydra does); the returned key keeps its `+` so
    formatted job overrides stay append-mode.  `~key` is never a sweep.
    """
    if "=" not in token or token.startswith("~"):
        return token, None
    key, value = token.split("=", 1)
    return key, _parse_value(value)


def dist_from_config(node: Any) -> Dist:
    """hydra-optuna `search_space` config entry -> Dist.

    Supported shapes (hydra-optuna-sweeper 1.1 schema):
      {type: float|int, low, high, log: bool, step}
      {type: categorical, choices: [...]}
    """
    kind = str(node.get("type", "float"))
    if kind == "categorical":
        return Dist(kind="categorical", choices=list(node["choices"]))
    return Dist(kind=kind, low=float(node["low"]), high=float(node["high"]),
                log=bool(node.get("log", False)),
                step=node.get("step"))


def format_value(v: Any) -> str:
    """Render a sampled value back into a CLI override string."""
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float):
        return repr(v)
    return str(v)
