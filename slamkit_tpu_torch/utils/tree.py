"""Parameter trees (nested dicts and lists of arrays) between numpy and torch.

The JAX package keeps the HuBERT and CodeHiFiGAN weights as pytrees of
arrays; the port keeps the same trees with torch tensors, so a tree of numpy
arrays (what the JAX package's converters return, or `np.asarray` of its
params) crosses over leaf by leaf.
"""
from __future__ import annotations

import numpy as np
import torch


def to_torch(tree, device="cpu", dtype=torch.float32):
    """numpy (or array-like) leaves -> tensors on `device`; floating leaves in
    `dtype`, integer leaves kept; None stays None."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v, device, dtype) for v in tree)
    if tree is None:
        return None
    t = torch.as_tensor(np.asarray(tree))
    return t.to(device=device, dtype=dtype if t.is_floating_point() else t.dtype)
