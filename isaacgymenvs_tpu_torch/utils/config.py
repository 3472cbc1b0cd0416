"""Hydra/OmegaConf-compatible config loading (no external deps).

The port's own copy of isaacgymenvs_tpu/utils/config.py; it reads the yaml
files under this package's `cfg/` (config.yaml, task/, train/, pbt/). A
task whose yaml is not there raises FileNotFoundError. The schema is the
IsaacGymEnvs one (Hydra + OmegaConf resolvers); the subset those configs
use is implemented:

  * `${path.to.key}` absolute interpolation from the config root;
  * `${.key}` / `${..key}` relative interpolation (OmegaConf dot rules:
    one dot = containing node, each extra dot = one parent up);
  * resolvers `${resolve_default:default,${...key}}`, `${eq:a,b}`,
    `${contains:a,b}`, `${if:cond,then,else}`;
  * `key.path=value` CLI overrides, `task=Ant` config-group selection,
    `train` defaulting to `${task}PPO`;
  * the env-subtask group of the AllegroKuka configs (`cfg/task/env/`):
    the subtask named by the task yaml's `env.subtask` or by a
    `task.env.subtask=` override has its group file's keys merged into the
    env block; CLI overrides still win.
"""
from __future__ import annotations

import copy
import os
import re
from typing import Any, Dict, List, Optional

import yaml

_CFG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "cfg")

# innermost ${...} (no nested '${' inside)
_INTERP = re.compile(r"\$\{([^${}]*)\}")
_MISSING = "???"


def cfg_dir() -> str:
    return _CFG_DIR


def _load_yaml(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return yaml.safe_load(f) or {}


def _parse_scalar(s: str) -> Any:
    try:
        return yaml.safe_load(s)
    except yaml.YAMLError:
        return s


def _get(root: Dict[str, Any], path: List[str]) -> Any:
    node: Any = root
    for p in path:
        if not isinstance(node, dict) or p not in node:
            raise KeyError(".".join(path))
        node = node[p]
    return node


def _set(root: Dict[str, Any], path: List[str], value: Any) -> None:
    node = root
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def _truthy(v: Any) -> bool:
    if isinstance(v, str):
        return v.lower() not in ("", "false", "0", "none", "null")
    return bool(v)


def _eval_expr(expr: str, root: Dict[str, Any], node_path: List[str]) -> Any:
    """Evaluate the inside of one ${...}."""
    if ":" in expr and not expr.lstrip(".").split(":")[0].count("."):
        name, _, argstr = expr.partition(":")
        if name in ("resolve_default", "eq", "contains", "if"):
            args = [a.strip() for a in argstr.split(",")]
            if name == "resolve_default":
                default, value = args[0], args[1] if len(args) > 1 else ""
                v = _parse_scalar(value)
                return _parse_scalar(default) if v in (None, "", _MISSING) else v
            if name == "eq":
                a, b = (_parse_scalar(x) for x in args[:2])
                return a == b
            if name == "contains":
                a, b = (str(_parse_scalar(x)) for x in args[:2])
                return a in b
            if name == "if":
                cond = _truthy(_parse_scalar(args[0]))
                branch = args[1] if cond else (args[2] if len(args) > 2 else "")
                return _parse_scalar(branch)
    # path reference
    ref = expr
    ndots = len(ref) - len(ref.lstrip("."))
    keys = [k for k in ref.lstrip(".").split(".") if k]
    if ndots == 0:
        base: List[str] = []
    else:
        # one dot: containing node; each extra dot: one parent up
        container = node_path[:-1]
        up = ndots - 1
        base = container[: len(container) - up] if up else container
    return _get(root, base + keys)


def _resolve_str(s: str, root: Dict[str, Any], node_path: List[str]) -> Any:
    """Resolve all interpolations in string s (innermost-first)."""
    for _ in range(50):
        m = _INTERP.search(s)
        if m is None:
            return _parse_scalar(s) if s != _MISSING else None
        val = _eval_expr(m.group(1), root, node_path)
        if m.span() == (0, len(s)):
            return val  # full-string interpolation keeps the value's type
        sval = "" if val is None else str(val)
        s = s[: m.start()] + sval + s[m.end() :]
    raise ValueError(f"interpolation too deep: {s!r}")


def _resolve_tree(node: Any, root: Dict[str, Any], path: List[str]) -> Any:
    if isinstance(node, dict):
        for k in list(node.keys()):
            node[k] = _resolve_tree(node[k], root, path + [k])
        return node
    if isinstance(node, list):
        return [_resolve_tree(v, root, path + [str(i)]) for i, v in enumerate(node)]
    if isinstance(node, str) and "${" in node:
        return _resolve_str(node, root, path)
    if node == _MISSING:
        return None
    return node


def resolve(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """Resolve interpolations in-place (iterated to a fixpoint so refs to
    not-yet-resolved nodes work)."""
    for _ in range(10):
        before = repr(cfg)
        _resolve_tree(cfg, cfg, [])
        if repr(cfg) == before:
            return cfg
    return cfg


# short forms of override keys: the task yaml keeps its domain-randomization
# switch under its own `task:` block, so the full path is task.task.randomize
_OVERRIDE_ALIASES = {"task.randomize": "task.task.randomize"}


def apply_overrides(cfg: Dict[str, Any], overrides: List[str]) -> Dict[str, Any]:
    """`a.b.c=value` CLI overrides (Hydra syntax subset; `+a.b=v` adds).
    `task.randomize=True` is short for `task.task.randomize=True`."""
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override {ov!r} is not key=value")
        key, _, value = ov.partition("=")
        key = key.lstrip("+")
        key = _OVERRIDE_ALIASES.get(key, key)
        _set(cfg, key.split("."), _parse_scalar(value))
    return cfg


def _deep_merge(base: Dict[str, Any], over: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _load_group_yaml(group_dir: str, name: str) -> Dict[str, Any]:
    """Load one config-group yaml, honoring a Hydra-style `defaults:` list
    (base names from the same group merged in order, `_self_` = this
    file's own keys -- the mechanism the reference's thin variant configs
    like AntSAC.yaml / AllegroHandFF.yaml are built on)."""
    cfg = _load_yaml(os.path.join(group_dir, f"{name}.yaml"))
    defaults = cfg.pop("defaults", None)
    if not defaults:
        return cfg
    merged: Dict[str, Any] = {}
    self_done = False
    for entry in defaults:
        if entry == "_self_":
            merged = _deep_merge(merged, cfg)
            self_done = True
        else:
            merged = _deep_merge(merged, _load_group_yaml(group_dir, str(entry)))
    if not self_done:
        merged = _deep_merge(merged, cfg)
    return merged


def load_config(
    overrides: Optional[List[str]] = None,
    config_dir: Optional[str] = None,
) -> Dict[str, Any]:
    """Compose the full config the way the reference's train.py does:
    global config.yaml + cfg/task/<Task>.yaml + cfg/train/<Task>PPO.yaml,
    then CLI overrides, then interpolation resolution."""
    overrides = list(overrides or [])
    cdir = config_dir or _CFG_DIR
    cfg = _load_yaml(os.path.join(cdir, "config.yaml"))

    # pre-scan overrides for the config-group selections
    pre = dict(
        o.partition("=")[::2] for o in overrides if "=" in o
    )
    task_name = pre.get("task", cfg.get("task_name", cfg.get("task", "Cartpole")))
    if isinstance(task_name, dict):
        task_name = "Cartpole"
    train_name = pre.get("train", f"{task_name}PPO")

    task_path = os.path.join(cdir, "task", f"{task_name}.yaml")
    if not os.path.exists(task_path):
        raise FileNotFoundError(
            f"unknown task {task_name!r} (no {task_path})"
        )
    cfg["task"] = _load_group_yaml(os.path.join(cdir, "task"), task_name)
    cfg["task_name"] = task_name
    train_dir = os.path.join(cdir, "train")
    # <Task>PPO.yaml, falling back to <Task>.yaml (e.g. AntSAC)
    if not os.path.exists(os.path.join(train_dir, f"{train_name}.yaml")) and (
        "train" not in pre
        and os.path.exists(os.path.join(train_dir, f"{task_name}.yaml"))
    ):
        train_name = task_name
    train_path = os.path.join(train_dir, f"{train_name}.yaml")
    cfg["train"] = (
        _load_group_yaml(train_dir, train_name)
        if os.path.exists(train_path)
        else {}
    )

    # pbt config group (reference cfg/config.yaml defaults: pbt: no_pbt)
    pbt_name = pre.get("pbt", "no_pbt")
    pbt_path = os.path.join(cdir, "pbt", f"{pbt_name}.yaml")
    cfg["pbt"] = _load_yaml(pbt_path) if os.path.exists(pbt_path) else {"enabled": False}

    # the env-subtask group (cfg/task/env/<subtask>.yaml): its keys go into
    # the env block before the CLI overrides, which still win
    subtask = pre.get("task.env.subtask") or (cfg["task"].get("env") or {}).get("subtask")
    if subtask:
        group_path = os.path.join(cdir, "task", "env", f"{subtask}.yaml")
        if os.path.exists(group_path):
            cfg["task"].setdefault("env", {}).update(_load_yaml(group_path))

    overrides = [
        o for o in overrides if o.partition("=")[0] not in ("task", "train", "pbt")
    ]
    apply_overrides(cfg, overrides)
    return resolve(copy.deepcopy(cfg))
