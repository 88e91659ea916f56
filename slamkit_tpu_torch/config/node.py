"""Config containers with OmegaConf-like ergonomics.

A copy of `slamkit_tpu/config/node.py` (`ConfigNode`, `ConfigList`, `MISSING`,
`${a.b}` interpolation, `to_container`), which the port cannot import: the
JAX package's modules pull jax in through their package. `to_yaml` is left
out, since it needs PyYAML and nothing calls it. `tests/test_torch_config.py`
holds the copy equal to the original.
"""
from __future__ import annotations

import copy
import json
import re
from typing import Any, Iterator


class MissingMandatoryValue(Exception):
    """Raised when a `???` value is accessed before being provided."""


class _Missing:
    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self):
        return "???"

    def __bool__(self):
        return False

    def __eq__(self, other):
        return isinstance(other, _Missing) or other == "???"

    def __hash__(self):
        return hash("???")


MISSING = _Missing()

_INTERP_RE = re.compile(r"\$\{([^}]+)\}")


def _wrap(value: Any) -> Any:
    if isinstance(value, ConfigNode) or isinstance(value, ConfigList):
        return value
    if isinstance(value, dict):
        return ConfigNode(value)
    if isinstance(value, (list, tuple)):
        return ConfigList(value)
    if value == "???":
        return MISSING
    return value


def _unwrap(value: Any) -> Any:
    if isinstance(value, ConfigNode):
        return {k: _unwrap(v) for k, v in value._data.items()}
    if isinstance(value, ConfigList):
        return [_unwrap(v) for v in value._data]
    if value is MISSING:
        return "???"
    return value


class ConfigList:
    """A list wrapper so nested dicts stay ConfigNodes. Interpolations in
    items resolve against the root config at access time (like
    omegaconf ListConfig)."""

    def __init__(self, data=()):
        self._data = [_wrap(v) for v in data]
        self._root = None

    def _resolve_item(self, value):
        if isinstance(value, str) and "${" in value and self._root is not None:
            return self._root._resolve(value)
        return value

    def __getitem__(self, idx):
        return self._resolve_item(self._data[idx])

    def __setitem__(self, idx, value):
        self._data[idx] = _wrap(value)

    def __len__(self):
        return len(self._data)

    def __iter__(self):
        return (self._resolve_item(v) for v in self._data)

    def __contains__(self, item):
        return item in self._data

    def __eq__(self, other):
        if isinstance(other, ConfigList):
            return self._data == other._data
        if isinstance(other, (list, tuple)):
            return self._data == [_wrap(v) for v in other]
        return NotImplemented

    def __repr__(self):
        return repr(_unwrap(self))

    def append(self, value):
        self._data.append(_wrap(value))


class ConfigNode:
    """Dict-like config with attribute access, `???` handling and interpolation.

    Mirrors the subset of omegaconf.DictConfig the reference code uses:
    `cfg.a.b`, `cfg['a']`, `cfg.get('a', default)`, `'a' in cfg`, iteration,
    `to_container`. Interpolations of the form ``${a.b}`` resolve against the
    root node at access time.
    """

    def __init__(self, data: dict | None = None):
        object.__setattr__(self, "_data", {})
        object.__setattr__(self, "_root", None)
        if data:
            for k, v in data.items():
                self._data[str(k)] = _wrap(v)

    # -- root tracking for interpolation ------------------------------------
    def _set_root(self, root: "ConfigNode"):
        object.__setattr__(self, "_root", root)
        for v in self._data.values():
            if isinstance(v, ConfigNode):
                v._set_root(root)
            elif isinstance(v, ConfigList):
                v._root = root
                for item in v._data:
                    if isinstance(item, ConfigNode):
                        item._set_root(root)

    def _resolve(self, value: Any) -> Any:
        if isinstance(value, str) and "${" in value:
            root = self._root or self

            def repl(m):
                out = root
                for part in m.group(1).split("."):
                    out = out[part]
                return out

            full = _INTERP_RE.fullmatch(value)
            if full:
                return repl(full)
            return _INTERP_RE.sub(lambda m: str(repl(m)), value)
        return value

    # -- mapping protocol ----------------------------------------------------
    def __getitem__(self, key):
        key = str(key)
        if key not in self._data:
            raise KeyError(key)
        value = self._data[key]
        if value is MISSING:
            raise MissingMandatoryValue(
                f"Missing mandatory value: {key}\n    full_key: {key}"
            )
        return self._resolve(value)

    def __setitem__(self, key, value):
        self._data[str(key)] = _wrap(value)

    def __delitem__(self, key):
        del self._data[str(key)]

    def __getattr__(self, key):
        if key.startswith("_"):
            raise AttributeError(key)
        try:
            return self[key]
        except KeyError:
            raise AttributeError(
                f"Key '{key}' is not in struct\n    full_key: {key}"
            ) from None

    def __setattr__(self, key, value):
        if key.startswith("_"):
            object.__setattr__(self, key, value)
        else:
            self[key] = value

    def __contains__(self, key):
        return str(key) in self._data

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self):
        return len(self._data)

    def __eq__(self, other):
        if isinstance(other, ConfigNode):
            return self._data == other._data
        if isinstance(other, dict):
            return _unwrap(self) == other
        return NotImplemented

    def __repr__(self):
        return repr(_unwrap(self))

    def __deepcopy__(self, memo):
        node = ConfigNode()
        object.__setattr__(node, "_data", copy.deepcopy(self._data, memo))
        return node

    # -- omegaconf-like helpers ---------------------------------------------
    def get(self, key, default=None):
        key = str(key)
        if key not in self._data:
            return default
        value = self._data[key]
        if value is MISSING:
            return default
        return self._resolve(value)

    def keys(self):
        return self._data.keys()

    def values(self):
        return [self._resolve(v) for v in self._data.values()]

    def items(self):
        return [(k, self._resolve(v)) for k, v in self._data.items()]

    def setdefault(self, key, default=None):
        if key not in self._data:
            self[key] = default
        return self.get(key)

    def pop(self, key, *default):
        key = str(key)
        if key in self._data:
            value = self._data.pop(key)
            return self._resolve(value) if value is not MISSING else MISSING
        if default:
            return default[0]
        raise KeyError(key)

    # -- selection by dotted path -------------------------------------------
    def select(self, path: str, default=None):
        node: Any = self
        for part in path.split("."):
            if not isinstance(node, ConfigNode) or part not in node:
                return default
            node = node.get(part)
        return node

    def update_path(self, path: str, value: Any, *, create: bool = True):
        parts = path.split(".")
        node = self
        for part in parts[:-1]:
            if part not in node._data or not isinstance(node._data[part], ConfigNode):
                if not create:
                    raise KeyError(path)
                node._data[part] = ConfigNode()
            node = node._data[part]
        node[parts[-1]] = value

    def delete_path(self, path: str):
        parts = path.split(".")
        node = self
        for part in parts[:-1]:
            node = node._data[part]
        del node._data[parts[-1]]

    def merge_with(self, other: "ConfigNode | dict"):
        """Deep merge: dict values merge recursively, everything else replaces.
        A '???' (MISSING) value never clobbers an existing concrete value
        (OmegaConf merge semantics — schema files declare mandatory keys
        without destroying values provided earlier)."""
        if isinstance(other, dict):
            other = ConfigNode(other)
        for key, value in other._data.items():
            if (
                key in self._data
                and isinstance(self._data[key], ConfigNode)
                and isinstance(value, ConfigNode)
            ):
                self._data[key].merge_with(value)
            elif value is MISSING and key in self._data \
                    and self._data[key] is not MISSING:
                continue
            else:
                self._data[key] = copy.deepcopy(value)

    def to_container(self, resolve: bool = True) -> dict:
        if not resolve:
            return _unwrap(self)

        def go(node):
            if isinstance(node, ConfigNode):
                return {k: go(node._resolve(v)) for k, v in node._data.items()}
            if isinstance(node, ConfigList):
                return [go(v) for v in node]  # iteration resolves interpolations
            if node is MISSING:
                return "???"
            return node

        return go(self)

    def to_json(self) -> str:
        return json.dumps(self.to_container(), indent=2)


def to_container(cfg, resolve: bool = True):
    """Module-level helper mirroring OmegaConf.to_container."""
    if isinstance(cfg, ConfigNode):
        return cfg.to_container(resolve=resolve)
    if isinstance(cfg, ConfigList):
        return _unwrap(cfg)
    return cfg
