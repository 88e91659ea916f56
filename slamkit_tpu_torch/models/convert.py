"""JAX parameter layout <-> the port's `Decoder`.

The JAX package saves its params pytree flat (`unit_lm.py::_flatten`): top-level
arrays under their own names (`embed`, `final_norm_scale`, ...) and the
per-layer arrays stacked on a leading layer axis under `layers/<name>`
(`layers/q_w` is [L, D, q_dim]). The port keeps the same names and the same
[in, out] layout, one `DecoderLayer` per layer, so converting is stacking.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .transformer import Decoder


def _expected_shapes(decoder: Decoder) -> dict[str, tuple]:
    shapes = {name: tuple(p.shape) for name, p in decoder.named_parameters(recurse=False)}
    L = len(decoder.layers)
    for name, p in decoder.layers[0].named_parameters():
        shapes[f"layers/{name}"] = (L, *p.shape)
    return shapes


def to_flat(decoder: Decoder) -> dict[str, np.ndarray]:
    """The decoder's weights as the JAX package's flat `params.npz` dict."""
    flat = {name: p.detach().float().cpu().numpy()
            for name, p in decoder.named_parameters(recurse=False)}
    for name, _ in decoder.layers[0].named_parameters():
        flat[f"layers/{name}"] = torch.stack(
            [getattr(lp, name).detach().float() for lp in decoder.layers]).cpu().numpy()
    return flat


@torch.no_grad()
def load_flat(decoder: Decoder, flat: Mapping[str, np.ndarray]) -> Decoder:
    """Copy a flat JAX params dict into `decoder` (on its device). The key set
    and every shape must match the decoder's configuration exactly."""
    expected = _expected_shapes(decoder)
    missing = sorted(set(expected) - set(flat))
    unexpected = sorted(set(flat) - set(expected))
    if missing or unexpected:
        raise ValueError(f"params do not match the decoder config: missing "
                         f"{missing}, unexpected {unexpected}")
    for key, shape in expected.items():
        arr = np.asarray(flat[key])
        if tuple(arr.shape) != shape:
            raise ValueError(f"{key}: shape {arr.shape}, config expects {shape}")
        src = torch.from_numpy(np.array(arr, dtype=np.float32))   # a writable copy
        if key.startswith("layers/"):
            name = key.split("/", 1)[1]
            for i, lp in enumerate(decoder.layers):
                getattr(lp, name).copy_(src[i])
        else:
            getattr(decoder, key).copy_(src)
    return decoder
