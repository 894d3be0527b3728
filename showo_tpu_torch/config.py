"""YAML configs with CLI dotted-key overrides (PyYAML only).

Counterpart of ``showo_tpu/config.py``, with the same files and UX:

    python -m showo_tpu_torch.inference_t2i \
        config=configs/showo_demo_512x512.yaml mode=t2i batch_size=2

CLI keys override YAML keys (values are parsed as YAML); a value that is
exactly ``${a.b}`` takes the type of ``a.b``, and ``${a.b}`` inside a
longer string is substituted as text.
"""

from __future__ import annotations

import re
import sys
from typing import Any, List, Optional

import yaml

_INTERP = re.compile(r"^\$\{([^}]+)\}$")
_INTERP_SUB = re.compile(r"\$\{([^}]+)\}")


class Config(dict):
    """Nested dict with attribute access."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def get_path(self, dotted: str, default: Any = None) -> Any:
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def set_path(self, dotted: str, value: Any) -> None:
        *parents, last = dotted.split(".")
        node = self
        for p in parents:
            if not isinstance(node.get(p), dict):
                node[p] = Config()
            node = node[p]
        node[last] = _wrap(value)


def _wrap(obj: Any) -> Any:
    if isinstance(obj, dict):
        return Config({k: _wrap(v) for k, v in obj.items()})
    if isinstance(obj, list):
        return [_wrap(v) for v in obj]
    return obj


def _resolve(node: Any, root: Config) -> Any:
    if isinstance(node, dict):
        for k in list(node.keys()):
            node[k] = _resolve(node[k], root)
        return node
    if isinstance(node, list):
        return [_resolve(v, root) for v in node]
    if isinstance(node, str):
        m = _INTERP.match(node)
        if m:
            return _resolve(root.get_path(m.group(1)), root)
        return _INTERP_SUB.sub(
            lambda m: str(_resolve(root.get_path(m.group(1)), root)), node)
    return node


def load_config(path: str, overrides: Optional[List[str]] = None) -> Config:
    """``path`` (YAML) with ``key.sub=value`` overrides applied."""
    with open(path) as f:
        conf = _wrap(yaml.safe_load(f) or {})
    for item in overrides or []:
        key, _, val = item.partition("=")
        conf.set_path(key.strip(), yaml.safe_load(val))
    _resolve(conf, conf)
    return conf


def get_config(argv: Optional[List[str]] = None) -> Config:
    """``config=<yaml> a.b=v ...`` from the command line."""
    args = list(sys.argv[1:] if argv is None else argv)
    paths = [a.split("=", 1)[1] for a in args if a.startswith("config=")]
    if not paths:
        raise SystemExit("usage: <tool> config=<yaml> [dotted.key=value ...]")
    conf = load_config(paths[-1],
                       [a for a in args if not a.startswith("config=")])
    conf["config"] = paths[-1]
    return conf


def snapshot_config(cfg: Any, output_dir: str) -> str:
    """Write the merged config to ``<output_dir>/config.yaml`` (the
    reference snapshots its run config the same way); returns the path."""
    import os

    def plain(x):
        if isinstance(x, dict):
            return {k: plain(v) for k, v in x.items()}
        if isinstance(x, list):
            return [plain(v) for v in x]
        return x

    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, "config.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(plain(cfg), f, sort_keys=False)
    return path
