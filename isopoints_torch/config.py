"""YAML configs with recursive `inherit_from` (own copy of
isopoints_tpu/config.py, which the port may not import).

`inherit_from` resolves relative to the config's directory, then the
working directory, then the repo root, so the port's configs can inherit
`configs/default.yaml` unchanged from wherever they are run.
"""

import os
from typing import Any, Dict, Optional

import yaml

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class AttrDict(dict):
    """dict with attribute access, recursively."""

    def __init__(self, d: Optional[Dict] = None):
        super().__init__()
        for k, v in (d or {}).items():
            self[k] = _wrap(v)

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = _wrap(v)

    def to_dict(self) -> Dict[str, Any]:
        return {k: _unwrap(v) for k, v in self.items()}


def _unwrap(v):
    if isinstance(v, AttrDict):
        return v.to_dict()
    if isinstance(v, (list, tuple)):
        return type(v)(_unwrap(x) for x in v)
    return v


def _wrap(v):
    if isinstance(v, dict) and not isinstance(v, AttrDict):
        return AttrDict(v)
    if isinstance(v, (list, tuple)):
        return type(v)(_wrap(x) for x in v)
    return v


def update_recursive(dst: Dict, src: Dict) -> None:
    """Deep-merge src into dst."""
    for k, v in src.items():
        if isinstance(v, dict):
            if not isinstance(dst.get(k), dict):
                dst[k] = AttrDict()
            update_recursive(dst[k], v)
        else:
            dst[k] = v


def _resolve(base: str, path: str) -> str:
    if os.path.isabs(base):
        return base
    for root in (os.path.dirname(os.path.abspath(path)), os.getcwd(), REPO_ROOT):
        cand = os.path.join(root, base)
        if os.path.exists(cand):
            return cand
    raise FileNotFoundError(f"inherit_from base {base!r} not found relative "
                            f"to {path!r}, the working directory or {REPO_ROOT}")


def load_config(path: str, default_path: Optional[str] = None) -> AttrDict:
    """Load a YAML config, following `inherit_from` chains; without one,
    `default_path` (if given) is the base."""
    with open(path) as f:
        special = yaml.safe_load(f) or {}
    base = special.get("inherit_from")
    if base is not None:
        cfg = load_config(_resolve(base, path), default_path)
    elif default_path is not None and \
            os.path.abspath(default_path) != os.path.abspath(path):
        cfg = load_config(default_path)
    else:
        cfg = AttrDict()
    update_recursive(cfg, special)
    return AttrDict(cfg)


def save_config(path: str, cfg: Dict) -> None:
    """Write the fully resolved config (no `inherit_from`)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    data = cfg.to_dict() if isinstance(cfg, AttrDict) else dict(cfg)
    data.pop("inherit_from", None)
    with open(path, "w") as f:
        yaml.safe_dump(data, f, default_flow_style=False, sort_keys=False)


def default_config_path() -> str:
    return os.path.join(REPO_ROOT, "configs", "default.yaml")
