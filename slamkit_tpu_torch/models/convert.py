"""JAX parameter layout <-> the port's `Decoder`.

The JAX package saves its params pytree flat (`unit_lm.py::_flatten`): top-level
arrays under their own names (`embed`, `final_norm_scale`, ...) and the
per-layer arrays stacked on a leading layer axis under `layers/<name>`
(`layers/q_w` is [L, D, q_dim]). The port keeps the same names and the same
[in, out] layout, one `DecoderLayer` per layer, so converting is stacking.
The same mapping carries gradients out (`grads_to_flat`), so a test can hold
them against `jax.grad` leaf by leaf.
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from ..parallel.tensor import whole_of
from .transformer import Decoder


def whole(t: torch.Tensor) -> torch.Tensor:
    """A tensor sharded over ranks (a DTensor) gathered whole; any other as
    it is."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def _expected_shapes(decoder: Decoder) -> dict[str, tuple]:
    shapes = {name: tuple(p.shape) for name, p in decoder.named_parameters(recurse=False)}
    L = len(decoder.layers)
    for name, p in decoder.layers[0].named_parameters():
        shapes[f"layers/{name}"] = (L, *p.shape)
    return shapes


def to_flat(decoder: Decoder, tensors: Optional[Mapping[str, torch.Tensor]] = None
            ) -> dict[str, np.ndarray]:
    """The decoder's weights as the JAX package's flat `params.npz` dict.

    tensors: stand-ins for the parameters, keyed by the decoder's
    `named_parameters()` names (a snapshot of them, or their gradients).
    Sharded tensors (`parallel/fsdp.py`), a tensor-parallel rank's slices
    (`parallel/tensor.py`) and the shards of its slices are gathered whole
    (`whole_of`), so every rank must call it then."""
    params = dict(decoder.named_parameters())
    if tensors is None:
        tensors = params
    get = lambda name: whole_of(params[name], tensors[name].detach()).float()
    flat = {name: get(name).cpu().numpy()
            for name, _ in decoder.named_parameters(recurse=False)}
    for name, _ in decoder.layers[0].named_parameters():
        flat[f"layers/{name}"] = torch.stack(
            [get(f"layers.{i}.{name}") for i in range(len(decoder.layers))]).cpu().numpy()
    return flat


def grads_to_flat(decoder: Decoder) -> dict[str, np.ndarray]:
    """The parameters' `.grad`s under the JAX names and layout (a parameter
    that received no gradient counts as zeros, as `jax.grad` gives them)."""
    return to_flat(decoder, {name: p.grad if p.grad is not None else torch.zeros_like(p)
                             for name, p in decoder.named_parameters()})


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
