"""Python-file config system with `_base_` inheritance and dotted-key
overrides: a copy of fastervit_tpu/utils/pyconfig.py (the JAX package runs
jax when any of its modules is imported, so the port keeps its own), which
rebuilds the reference's SLConfig
(downstream/object_detection/dino/util/slconfig.py: BASE_KEY/_delete_
semantics :16-17, _merge_a_into_b :143-185, merge_from_dict :360-389).

A config file is a plain python module; every non-underscore top-level name
becomes a config entry. `_base_ = ['other.py', ...]` inherits (child wins,
dicts deep-merge, `_delete_=True` inside a child dict replaces instead of
merging). CLI overrides arrive as dotted keys: `lr=1e-4 model.dim=256`.
"""
from __future__ import annotations

import ast
import copy
from pathlib import Path
from typing import Any, Dict, Iterable, List, Mapping, Union

BASE_KEY = "_base_"
DELETE_KEY = "_delete_"


def _exec_config_file(path: Path) -> Dict[str, Any]:
    source = path.read_text()
    # syntax check with a helpful filename before exec
    ast.parse(source, filename=str(path))
    ns: Dict[str, Any] = {"__file__": str(path)}
    exec(compile(source, str(path), "exec"), ns)
    return {k: v for k, v in ns.items()
            if not k.startswith("__") and not callable(v)
            and not isinstance(v, type(ast))}


def _merge(child: Any, base: Any) -> Any:
    """Child wins; dicts deep-merge unless the child dict carries
    `_delete_: True` (reference _merge_a_into_b)."""
    if not isinstance(child, Mapping):
        return child
    child = dict(child)
    if child.pop(DELETE_KEY, False) or not isinstance(base, Mapping):
        return {k: _merge(v, None) for k, v in child.items()}
    out = dict(base)
    for k, v in child.items():
        out[k] = _merge(v, base.get(k)) if isinstance(v, Mapping) else v
    return out


class PyConfig(dict):
    """dict with attribute access (cfg.lr == cfg['lr'])."""

    def __getattr__(self, name: str) -> Any:
        try:
            v = self[name]
        except KeyError:
            raise AttributeError(name) from None
        return PyConfig(v) if isinstance(v, dict) and not isinstance(
            v, PyConfig) else v

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    @classmethod
    def fromfile(cls, filename: Union[str, Path]) -> "PyConfig":
        path = Path(filename).resolve()
        cfg = _exec_config_file(path)
        bases = cfg.pop(BASE_KEY, [])
        if isinstance(bases, str):
            bases = [bases]
        merged: Dict[str, Any] = {}
        for b in bases:
            base_cfg = cls.fromfile(path.parent / b)
            dup = set(merged) & set(base_cfg)
            if dup:
                raise KeyError(f"duplicate keys across _base_ files: {dup}")
            merged.update(base_cfg)
        out = cls(_merge(cfg, merged))
        out.__dict__["filename"] = str(path)
        return out

    def merge_from_dict(self, options: Mapping[str, Any]) -> None:
        """Dotted-key overrides: {'a.b.c': v} (reference merge_from_dict)."""
        tree: Dict[str, Any] = {}
        for full_key, v in options.items():
            d = tree
            *parents, leaf = full_key.split(".")
            for p in parents:
                d = d.setdefault(p, {})
            d[leaf] = v
        merged = _merge(tree, self)
        self.clear()
        self.update(merged)

    def merge_from_list(self, pairs: Iterable[str]) -> None:
        """'key=value' strings (values parsed as python literals when
        possible) — the CLI `--options` form (reference main.py)."""
        options = {}
        for item in pairs:
            key, _, val = item.partition("=")
            try:
                options[key] = ast.literal_eval(val)
            except (ValueError, SyntaxError):
                options[key] = val
        self.merge_from_dict(options)

    def copy(self) -> "PyConfig":
        return PyConfig(copy.deepcopy(dict(self)))

    def dump(self) -> str:
        lines: List[str] = []
        for k in sorted(self):
            lines.append(f"{k} = {self[k]!r}")
        return "\n".join(lines) + "\n"
