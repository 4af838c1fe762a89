"""Config system: YAML + dotted-target instantiation + CLI overrides.

Port of ``cvvae_tpu/utils/config.py`` (the reference's OmegaConf plumbing
on plain PyYAML + dataclasses).  Every object is declared as
``{"target": "pkg.mod.Name", "params": {...}}``.  The shipped configs name
the JAX package's targets (``cvvae_tpu.models.vae_sd3.VAESD3Config``):
``resolve_target`` maps each to the same path under ``cvvae_tpu_torch``,
so one config file drives both packages; nothing of the JAX package is
imported.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict, List, Optional

import yaml


JAX_PACKAGE = "cvvae_tpu"
PORT_PACKAGE = "cvvae_tpu_torch"


def resolve_target(path: str) -> str:
    """A target of the JAX package -> the same path in the port."""
    if path == JAX_PACKAGE or path.startswith(JAX_PACKAGE + "."):
        return PORT_PACKAGE + path[len(JAX_PACKAGE):]
    return path


def get_obj_from_str(path: str):
    module, _, name = resolve_target(path).rpartition(".")
    return getattr(importlib.import_module(module), name)


def instantiate_from_config(cfg: Dict) -> Any:
    if "target" not in cfg:
        raise KeyError(f"config needs a 'target': {cfg}")
    cls = get_obj_from_str(cfg["target"])
    params = dict(cfg.get("params") or {})
    # nested {"target": ...} dicts instantiate recursively
    for k, v in list(params.items()):
        if isinstance(v, dict) and "target" in v:
            params[k] = instantiate_from_config(v)
    if dataclasses.is_dataclass(cls):
        # dataclass configs want tuples for list fields
        fields = {f.name: f for f in dataclasses.fields(cls)}
        for k, v in list(params.items()):
            if isinstance(v, list) and k in fields:
                params[k] = tuple(v)
    return cls(**params)


def deep_merge(base: Dict, override: Dict) -> Dict:
    out = dict(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def load_configs(paths: List[str], dotlist: Optional[List[str]] = None) -> Dict:
    """Merge --base yamls left-to-right, then apply key=value dotlist
    overrides (main.py:639-641)."""
    cfg: Dict = {}
    for path in paths:
        with open(path) as f:
            cfg = deep_merge(cfg, yaml.safe_load(f) or {})
    for item in dotlist or []:
        key, _, raw = item.partition("=")
        value = yaml.safe_load(raw)
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return cfg


def save_config(cfg: Dict, path: str) -> None:
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
