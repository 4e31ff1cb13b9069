"""Nested configuration with dotted-key overrides.

Mirrors the semantics of the reference config layer
(``feature_extraction/code/args.py:11-96`` and ``*/code/config.py``):

* defaults are a nested dict;
* CLI/keyword overrides use dotted keys (``data.path=...``) and are merged
  recursively;
* unknown keys are rejected by default (the reference's feature_extraction
  variant) but can be allowed (the subset_selection variant silently creates
  them);
* keys ending in ``_file``/``_dir``/``_path`` are resolved to
  ``pathlib.Path``;
* missing attribute reads return ``None`` rather than raising — the
  reference wraps its config in ``DefaultMunch(None)``.

Unlike the reference there is exactly ONE config system shared by every
stage.
"""

from __future__ import annotations

import copy
import json
from pathlib import Path
from typing import Any, Dict, Iterator, Mapping, Optional

_PATH_SUFFIXES = ("_file", "_dir", "_path")


class Config:
    """Attribute-accessible nested dict; missing keys read as ``None``."""

    __slots__ = ("_data",)

    def __init__(self, data: Optional[Mapping[str, Any]] = None):
        object.__setattr__(self, "_data", {})
        if data:
            for key, val in data.items():
                self._data[key] = Config(val) if isinstance(val, Mapping) else val

    # -- mapping protocol -------------------------------------------------
    def __getattr__(self, key: str) -> Any:
        if key.startswith("__"):
            raise AttributeError(key)
        return self._data.get(key)

    def __setattr__(self, key: str, value: Any) -> None:
        self._data[key] = Config(value) if isinstance(value, Mapping) else value

    def __getitem__(self, key: str) -> Any:
        return self._data.get(key)

    def __setitem__(self, key: str, value: Any) -> None:
        self.__setattr__(key, value)

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __eq__(self, other: object) -> bool:
        if isinstance(other, Config):
            return self.to_dict() == other.to_dict()
        if isinstance(other, Mapping):
            return self.to_dict() == dict(other)
        return NotImplemented

    def __repr__(self) -> str:
        return f"Config({self.to_dict()!r})"

    def get(self, key: str, default: Any = None) -> Any:
        val = self._data.get(key, default)
        return default if val is None else val

    def keys(self):
        return self._data.keys()

    def items(self):
        return self._data.items()

    def values(self):
        return self._data.values()

    def to_dict(self) -> Dict[str, Any]:
        out = {}
        for key, val in self._data.items():
            if isinstance(val, Config):
                out[key] = val.to_dict()
            elif isinstance(val, Path):
                out[key] = str(val)
            else:
                out[key] = val
        return out

    def copy(self) -> "Config":
        return Config(copy.deepcopy(self.to_dict()))


def _merge(base: Dict[str, Any], key_path: str, value: Any, strict: bool) -> None:
    parts = key_path.split(".")
    node = base
    for i, part in enumerate(parts[:-1]):
        if part not in node:
            if strict:
                prefix = ".".join(parts[: i + 1])
                raise KeyError(f"unknown config key: {prefix!r}")
            node[part] = {}
        if not isinstance(node[part], dict):
            raise KeyError(
                f"config key {'.'.join(parts[: i + 1])!r} is a leaf, cannot nest"
            )
        node = node[part]
    leaf = parts[-1]
    if strict and leaf not in node:
        raise KeyError(f"unknown config key: {key_path!r}")
    node[leaf] = value


def _resolve_paths(data: Dict[str, Any]) -> None:
    for key, val in data.items():
        if isinstance(val, dict):
            _resolve_paths(val)
        elif isinstance(val, str) and key.endswith(_PATH_SUFFIXES) and val:
            data[key] = Path(val).expanduser()


def _coerce(value: str) -> Any:
    """Best-effort typed parse of a CLI string value (json first)."""
    if not isinstance(value, str):
        return value
    lowered = value.lower()
    if lowered in ("true", "false"):
        return lowered == "true"
    if lowered in ("none", "null"):
        return None
    try:
        return json.loads(value)
    except (json.JSONDecodeError, ValueError):
        return value


def build_config(
    defaults: Mapping[str, Any],
    overrides: Optional[Mapping[str, Any]] = None,
    strict: bool = True,
    resolve_paths: bool = True,
) -> Config:
    """Merge dotted-key ``overrides`` into nested ``defaults`` -> ``Config``.

    ``strict=True`` rejects unknown keys (reference
    ``feature_extraction/code/args.py:29-60``); ``strict=False`` creates
    them (reference ``subset_selection/code/args.py:43-58``).
    """
    data = copy.deepcopy(dict(defaults))
    # defaults may themselves be shallow-nested Mappings
    data = json.loads(json.dumps(_plain(data)))
    if overrides:
        for key, val in overrides.items():
            _merge(data, key, _coerce(val) if isinstance(val, str) else val, strict)
    if resolve_paths:
        _resolve_paths(data)
    return Config(data)


def _plain(obj: Any) -> Any:
    if isinstance(obj, Config):
        return obj.to_dict()
    if isinstance(obj, Mapping):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if isinstance(obj, Path):
        return str(obj)
    return obj


def parse_overrides(argv) -> Dict[str, Any]:
    """Parse ``--key=value`` / ``key=value`` CLI tokens into an override map."""
    out: Dict[str, Any] = {}
    for tok in argv:
        tok = tok.lstrip("-")
        if "=" not in tok:
            raise ValueError(f"override must look like key=value, got {tok!r}")
        key, val = tok.split("=", 1)
        out[key] = val
    return out
