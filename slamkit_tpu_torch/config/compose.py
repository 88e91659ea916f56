"""Hydra-1.3-compatible config composition, without PyYAML.

A copy of `slamkit_tpu/config/compose.py` (the defaults-list semantics with
`override`, `optional` and `# @package`; the command-line grammar `k=v`,
`group=opt`, `+k`, `++k`, `~k`; `--config-name` / `-cn`, `--config-path` /
`-cp` and the `-m` sweep), which the port cannot import: the JAX package's
modules pull jax in through their package. Two changes: the YAML is read by
`yaml_subset` (the card's host has no PyYAML), and `main` sets no
`JAX_PLATFORMS`. `tests/test_torch_config.py` holds every composition of the
repo's `config/` tree equal to the original's.
"""
from __future__ import annotations

import functools
import os
import sys
from dataclasses import dataclass
from typing import Any

from . import yaml_subset
from .node import ConfigNode, MISSING, MissingMandatoryValue, to_container

__all__ = [
    "compose",
    "main",
    "ConfigNode",
    "MISSING",
    "MissingMandatoryValue",
    "to_container",
]


def _parse_value(text: str) -> Any:
    """Parse a CLI override value with yaml scalar/sequence rules."""
    return yaml_subset.parse_value(text)


def _read_package_directive(path: str) -> str | None:
    """Return the value of a leading `# @package <pkg>` comment, if present."""
    with open(path, "r") as f:
        for line in f:
            stripped = line.strip()
            if not stripped:
                continue
            if stripped.startswith("#"):
                body = stripped.lstrip("#").strip()
                if body.startswith("@package"):
                    return body.split(None, 1)[1].strip()
                continue
            break
    return None


def _load_yaml(path: str) -> dict:
    return yaml_subset.load_file(path) or {}


@dataclass
class _DefaultEntry:
    group: str | None  # group path relative to config root ('' for bare sibling)
    option: str | None
    is_self: bool = False
    is_override: bool = False
    optional: bool = False

    @classmethod
    def parse(cls, raw: Any) -> "_DefaultEntry":
        if raw == "_self_":
            return cls(group=None, option=None, is_self=True)
        if isinstance(raw, str):
            # bare sibling reference, e.g. `- default` inside config/model/slam.yaml
            return cls(group="", option=raw)
        if isinstance(raw, dict):
            if len(raw) != 1:
                raise ValueError(f"Malformed defaults entry: {raw!r}")
            key, option = next(iter(raw.items()))
            key = str(key)
            is_override = False
            optional = False
            if key.startswith("override "):
                is_override = True
                key = key[len("override "):].strip()
            if key.startswith("optional "):
                optional = True
                key = key[len("optional "):].strip()
            return cls(group=key, option=option, is_override=is_override,
                       optional=optional)
        raise ValueError(f"Malformed defaults entry: {raw!r}")


class _Composer:
    def __init__(self, config_dir: str):
        self.config_dir = config_dir
        # group path -> chosen option (from `override` entries and CLI choices)
        self.choices: dict[str, str | None] = {}

    # -- path resolution -----------------------------------------------------
    def _group_path(self, entry: _DefaultEntry, current_group: str) -> str:
        """Absolute (config-root-relative) group path for a defaults entry."""
        g = entry.group or ""
        if g.startswith("/"):
            return g.strip("/")
        if g == "":
            return current_group  # bare sibling
        if current_group:
            return f"{current_group}/{g}"
        return g

    def _file_for(self, group: str, option: str) -> str:
        return os.path.join(self.config_dir, group, f"{option}.yaml")

    # -- phase 1: collect override choices ------------------------------------
    def collect_choices(self, group: str, option: str, seen: set | None = None):
        seen = seen if seen is not None else set()
        path = self._file_for(group, option)
        if not os.path.exists(path) or path in seen:
            return
        seen.add(path)
        data = _load_yaml(path)
        for raw in data.get("defaults", []):
            entry = _DefaultEntry.parse(raw)
            if entry.is_self:
                continue
            gpath = self._group_path(entry, group)
            if entry.is_override:
                # CLI choices (pre-seeded) win over file-level overrides
                if gpath not in self.choices:
                    self.choices[gpath] = entry.option
            # Choice substitution applies to group selections only; a bare
            # sibling entry (`- default` inside a group file) is a direct
            # file include, not a re-selectable choice.
            if entry.group == "":
                opt = entry.option
            else:
                opt = self.choices.get(gpath, entry.option)
            if opt is not None:
                self.collect_choices(gpath, opt, seen)

    # -- phase 2: compose ------------------------------------------------------
    def compose_file(self, group: str, option: str, package: str | None,
                     target: ConfigNode):
        """Compose `group/option.yaml` into `target` under `package`."""
        path = self._file_for(group, option)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"Cannot find config '{option}' in group '{group or '.'}' "
                f"(searched {path})"
            )
        directive = _read_package_directive(path)
        if directive is not None:
            if directive == "_global_":
                package = ""
            elif directive == "_group_":
                pass  # keep derived package
            else:
                package = directive.replace("/", ".")
        if package is None:
            package = group.replace("/", ".")

        data = _load_yaml(path)
        defaults = [_DefaultEntry.parse(raw) for raw in data.get("defaults", [])]
        body = {k: v for k, v in data.items() if k != "defaults"}

        merged_self = False
        for entry in defaults:
            if entry.is_self:
                self._merge_into(target, package, body)
                merged_self = True
                continue
            if entry.is_override:
                continue  # consumed in phase 1
            gpath = self._group_path(entry, group)
            if entry.group == "":
                opt = entry.option  # bare sibling: direct include, no choice
            else:
                opt = self.choices.get(gpath, entry.option)
            if opt is None:
                continue  # `group: null` → nothing composed
            # Package for a nested default: bare siblings inherit the parent's
            # package; group entries derive from their group path.
            child_package = package if entry.group == "" else None
            try:
                self.compose_file(gpath, opt, child_package, target)
            except FileNotFoundError:
                if not entry.optional:
                    raise
        if not merged_self:
            self._merge_into(target, package, body)

    @staticmethod
    def _merge_into(target: ConfigNode, package: str, body: dict):
        if not body:
            return
        node = ConfigNode(body)
        if package:
            wrapper = ConfigNode()
            wrapper.update_path(package, node)
            target.merge_with(wrapper)
        else:
            target.merge_with(node)


def _is_choice_override(key: str, config_dir: str) -> bool:
    """`model=slam` / `tokeniser/feature_extractor=x` are group choices iff
    the matching config subdirectory exists. Hydra semantics: a DOTTED key
    (`a.b=v`) is always a value-path override, never a group choice — so
    `tokeniser.feature_extractor=/local/ckpt` sets the value even though
    config/tokeniser/feature_extractor/ is a group directory."""
    if "." in key:
        return False
    return os.path.isdir(os.path.join(config_dir, key.strip("/")))


def compose(config_dir: str, config_name: str,
            overrides: list[str] | None = None) -> ConfigNode:
    """Compose a config exactly like `hydra.main` would for the reference CLIs."""
    overrides = list(overrides or [])
    composer = _Composer(config_dir)

    value_overrides: list[tuple[str, str, Any]] = []  # (mode, key, value)
    for item in overrides:
        item = item.strip()
        if not item:
            continue
        if item.startswith("~"):
            value_overrides.append(("del", item[1:].split("=")[0], None))
            continue
        mode = "set"
        if item.startswith("++"):
            mode, item = "force", item[2:]
        elif item.startswith("+"):
            mode, item = "add", item[1:]
        if "=" not in item:
            raise ValueError(f"Override '{item}' must contain '='")
        key, _, raw_value = item.partition("=")
        key = key.strip()
        if mode == "set" and _is_choice_override(key, config_dir):
            composer.choices[key.replace(".", "/").strip("/")] = (
                None if raw_value in ("null", "None") else raw_value
            )
        else:
            value_overrides.append((mode, key, _parse_value(raw_value)))

    composer.collect_choices("", config_name)
    cfg = ConfigNode()
    composer.compose_file("", config_name, package="", target=cfg)

    for mode, key, value in value_overrides:
        if mode == "del":
            try:
                cfg.delete_path(key)
            except KeyError:
                pass
        else:
            cfg.update_path(key, value)

    cfg._set_root(cfg)
    return cfg


def _split_sweep(value: str) -> list[str]:
    """Split a hydra choice-sweep value on TOP-LEVEL commas only — commas
    inside brackets/quotes belong to list/str literals (`mesh_shape=[4,2]`
    must not fan out)."""
    parts, buf, depth, quote = [], [], 0, None
    for ch in value:
        if quote:
            buf.append(ch)
            if ch == quote:
                quote = None
            continue
        if ch in "\"'":
            quote = ch
        elif ch in "[{(":
            depth += 1
        elif ch in "]})":
            depth -= 1
        elif ch == "," and depth == 0:
            parts.append("".join(buf))
            buf = []
            continue
        buf.append(ch)
    parts.append("".join(buf))
    return parts


def main(config_name: str, config_path: str = "../config", version_base: str | None = None):
    """Decorator mirroring `@hydra.main` for CLI entry points.

    `config_path` is resolved relative to the decorated function's file, exactly
    like Hydra does (reference cli/train.py:16). `-m`/`--multirun` runs the
    cartesian product of comma-swept overrides sequentially (hydra's basic
    launcher semantics; jobs share the process — give swept runs distinct
    output paths, e.g. by sweeping `training_args.output_dir` too).
    """

    def decorator(fn):
        @functools.wraps(fn)
        def wrapper(overrides: list[str] | None = None):
            if overrides is None:
                overrides = sys.argv[1:]
            # hydra's --config-name/-cn and --config-path/-cp flags
            overrides = list(overrides)
            chosen_name, chosen_path = config_name, config_path
            i = 0
            while i < len(overrides):
                item = overrides[i]
                for flag, is_name in (("--config-name", True), ("-cn", True),
                                      ("--config-path", False), ("-cp", False)):
                    if item == flag and i + 1 < len(overrides):
                        value = overrides[i + 1]
                        del overrides[i:i + 2]
                        break
                    if item.startswith(flag + "="):
                        value = item.split("=", 1)[1]
                        del overrides[i]
                        break
                else:
                    i += 1
                    continue
                if is_name:
                    chosen_name = value
                else:
                    chosen_path = value
            multirun = False
            for flag in ("-m", "--multirun"):
                while flag in overrides:
                    overrides.remove(flag)
                    multirun = True
            fn_dir = os.path.dirname(os.path.abspath(sys.modules[fn.__module__].__file__))
            config_dir = os.path.normpath(os.path.join(fn_dir, chosen_path))
            if not multirun:
                cfg = compose(config_dir, chosen_name, overrides)
                return fn(cfg)
            # hydra -m: expand comma sweeps into the cartesian product and
            # launch each job sequentially (basic launcher)
            import itertools

            axes = []
            for item in overrides:
                key, sep, raw = item.partition("=")
                vals = _split_sweep(raw) if sep else [None]
                if sep and len(vals) > 1:
                    axes.append([f"{key}={v}" for v in vals])
                else:
                    axes.append([item])
            jobs = list(itertools.product(*axes))
            results = []
            for i, job in enumerate(jobs):
                print(f"[multirun] job {i}/{len(jobs)}: "
                      f"{' '.join(job) or '(no overrides)'}", flush=True)
                cfg = compose(config_dir, chosen_name, list(job))
                results.append(fn(cfg))
            return results

        wrapper.__wrapped_config__ = (config_name, config_path)
        return wrapper

    return decorator
