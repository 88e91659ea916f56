"""Hydra-style config composition over the repo's `config/` tree, without
PyYAML (copies of `slamkit_tpu/config`, with a YAML reader of their own)."""
from .node import ConfigList, ConfigNode, MISSING, MissingMandatoryValue, to_container
from .compose import compose, main

__all__ = ["ConfigNode", "ConfigList", "MISSING", "MissingMandatoryValue", "to_container",
           "compose", "main"]
