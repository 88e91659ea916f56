"""The `//reference` path macro: a copy of `slamkit_tpu/utils/path_utils.py`
(the port imports nothing of the JAX package)."""
from __future__ import annotations

import os
from typing import Optional


def resolve_reference_path(path: str, reference_path: Optional[str] = None) -> str:
    """$SLAM_REFERENCE_PATH takes precedence; the config value is the
    FALLBACK (reference semantics: env-var override of benchmark roots)."""
    if path.startswith("//reference"):
        root = os.environ.get("SLAM_REFERENCE_PATH", reference_path)
        if root is None:
            raise ValueError(
                "Path starts with //reference but $SLAM_REFERENCE_PATH is not "
                "set and no reference_path given in the config")
        return path.replace("//reference", root, 1)
    return path
