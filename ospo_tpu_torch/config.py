"""Config system: YAML file + dot-list CLI overrides (copy of the
``build_config``, ``compose_config`` and ``save_config`` parts of
``ospo_tpu/config.py``; PyYAML is imported where a file or an override is
parsed).

Replicates the contract of the reference's ``build_config``
(``ospo/utils/common.py:74-100``): load a YAML file, optionally re-merge a
nested ``cfg_path``, then merge ``key.sub=value`` CLI overrides, and expose
the result with attribute access.  Implemented without OmegaConf/Hydra:
plain PyYAML plus a small merge/interpolation engine.
"""

from __future__ import annotations

import copy
import json
import os
import re
from typing import Any, Iterable, Mapping, Optional


class Config(dict):
    """A dict with attribute access, nested-aware (``cfg.a.b.c``).

    Missing keys resolve to ``None`` on attribute access — the reference
    pipeline relies on absent YAML keys reading as null (e.g. optional
    ``ckpt_path``).
    """

    def __getattr__(self, name: str) -> Any:
        if name.startswith("__"):
            raise AttributeError(name)
        return self.get(name)

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError as e:  # pragma: no cover
            raise AttributeError(name) from e

    @classmethod
    def from_nested(cls, data: Any) -> Any:
        if isinstance(data, Mapping):
            return cls({k: cls.from_nested(v) for k, v in data.items()})
        if isinstance(data, list):
            return [cls.from_nested(v) for v in data]
        return data


def _parse_scalar(text: str) -> Any:
    """Parse a CLI override value with YAML scalar semantics."""
    import yaml

    try:
        return yaml.safe_load(text)
    except yaml.YAMLError:
        return text


def _deep_merge(base: dict, override: Mapping) -> dict:
    out = dict(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], Mapping) and isinstance(v, Mapping):
            out[k] = _deep_merge(dict(out[k]), v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _set_by_dotted(tree: dict, dotted: str, value: Any) -> None:
    keys = dotted.split(".")
    node = tree
    for k in keys[:-1]:
        nxt = node.get(k)
        if not isinstance(nxt, dict):
            nxt = {}
            node[k] = nxt
        node = nxt
    node[keys[-1]] = value


_INTERP_RE = re.compile(r"\$\{([a-zA-Z0-9_.]+)\}")


def _interpolate(tree: dict) -> dict:
    """Resolve ``${dotted.key}`` references against the root config.

    OmegaConf semantics: chained references (``a: ${b}``, ``b: ${c}``)
    resolve transitively, a missing key RAISES (a typo'd reference must
    not flow downstream as None/'None'), and cycles are detected."""

    resolving: set = set()

    def lookup(dotted: str) -> Any:
        if dotted in resolving:
            raise ValueError(
                f"circular config interpolation through ${{{dotted}}}")
        node: Any = tree
        for part in dotted.split("."):
            if not isinstance(node, Mapping) or part not in node:
                raise KeyError(
                    f"config interpolation ${{{dotted}}} does not resolve "
                    f"(no key {part!r})")
            node = node[part]
        resolving.add(dotted)
        try:
            return resolve(node)  # the target may itself interpolate
        finally:
            resolving.discard(dotted)

    def resolve(value: Any) -> Any:
        if isinstance(value, str):
            m = _INTERP_RE.fullmatch(value.strip())
            if m:
                return lookup(m.group(1))
            return _INTERP_RE.sub(
                lambda mm: str(lookup(mm.group(1))), value
            ) if _INTERP_RE.search(value) else value
        if isinstance(value, Mapping):
            return {k: resolve(v) for k, v in value.items()}
        if isinstance(value, list):
            return [resolve(v) for v in value]
        return value

    return resolve(tree)


def from_cli(argv: Optional[Iterable[str]] = None) -> dict:
    """Parse ``a.b=c`` dot-list overrides (OmegaConf.from_cli equivalent)."""
    import sys

    if argv is None:
        argv = [a for a in sys.argv[1:] if "=" in a and not a.startswith("--")]
    tree: dict = {}
    for item in argv:
        if "=" not in item:
            continue
        key, _, raw = item.partition("=")
        _set_by_dotted(tree, key.strip(), _parse_scalar(raw))
    return tree


def load_yaml(path: str) -> dict:
    import yaml

    with open(path, "r") as f:
        data = yaml.safe_load(f)
    return data or {}


def build_config(
    cfg_path: str,
    overrides: Optional[Iterable[str]] = None,
    use_cli: bool = True,
) -> Config:
    """Load ``cfg_path``, merge nested ``cfg_path`` re-loads and CLI dot-list
    overrides, resolve ``${...}`` interpolations, and wrap in :class:`Config`.
    """
    if cfg_path is None:
        raise ValueError("No cfg_path given.")
    cfg = load_yaml(cfg_path)
    # A config may point at a BASE config via its own ``cfg_path`` key:
    # the base loads first and the pointing file's keys override it —
    # small specializations (configs/quota_1h.yaml) extend a full stage
    # config without duplicating it.
    if cfg.get("cfg_path"):
        base = load_yaml(cfg["cfg_path"])
        # make shadowing visible in run logs (ADVICE r4): a stage config
        # silently overridden by its specialization is hard to audit
        shadowed = sorted(k for k in cfg if k != "cfg_path" and k in base)
        if shadowed:
            print(f"# config: {cfg_path} overrides base "
                  f"{cfg['cfg_path']} keys: {shadowed}")
        cfg = _deep_merge(base, cfg)
    if overrides:
        cfg = _deep_merge(cfg, from_cli(list(overrides)))
    if use_cli:
        cfg = _deep_merge(cfg, from_cli())
    cfg = _interpolate(cfg)
    return Config.from_nested(cfg)


def compose_config(config_dir: str, base_name: str, overrides=None) -> Config:
    """Hydra-style composition for the inference entry point
    (``ospo_tpu/config.py:192-227``).

    The base YAML's ``defaults: [{group: name}, ..., _self_]`` list loads
    ``<config_dir>/<group>/<name>.yaml`` under key ``<group>`` in order; a
    ``null`` name is skipped.  ``_self_`` merges the base file at its place
    in the list; without it the base file merges last.  ``overrides=None``
    reads ``a.b=c`` dot-list overrides from the command line, an explicit
    list (or ``()``) is used instead of it.  Interpolations resolve last."""
    base = load_yaml(os.path.join(config_dir, f"{base_name}.yaml"))
    defaults = base.pop("defaults", [])
    tree: dict = {}
    saw_self = False
    for entry in defaults:
        if isinstance(entry, Mapping):
            for group, name in entry.items():
                if name is None:
                    continue
                sub = load_yaml(os.path.join(config_dir, str(group),
                                             f"{name}.yaml"))
                tree = _deep_merge(tree, {str(group): sub})
        elif entry == "_self_":
            saw_self = True
            tree = _deep_merge(tree, base)
    if not saw_self:
        tree = _deep_merge(tree, base)
    if overrides is None:
        tree = _deep_merge(tree, from_cli())
    elif overrides:
        tree = _deep_merge(tree, from_cli(list(overrides)))
    return Config.from_nested(_interpolate(tree))


def save_config(save_path: str, config: Mapping) -> None:
    """Persist the run config as ``config.yaml`` beside logs and checkpoints,
    JSON-formatted like the reference (``ospo/utils/common.py:102-108``)."""
    os.makedirs(save_path, exist_ok=True)
    with open(os.path.join(save_path, "config.yaml"), "w") as f:
        json.dump(dict(config), f, indent=4, default=str)
