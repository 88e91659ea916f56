"""ZeRO-3 parameter sharding over the mesh's 'data' axis (fsdp).

Counterpart of `slamkit_tpu/parallel/mesh.py`'s `param_shardings(fsdp=True)`
(`:93-100`) and `opt_state_shardings` (`:175-214`). The JAX package places
every parameter with `fsdp_spec` and lets XLA gather and scatter; here torch's
FSDP2 (`torch.distributed.fsdp.fully_shard`) does it around module calls:

  * `shard_decoder(decoder, mesh)` shards each `DecoderLayer` as a group of
    its own, then the root (embeddings, final norm, learned positions, the
    projections and the head; a tied embedding stays one parameter in that
    group). Each parameter is sharded on the dim `fsdp_spec` picks, the
    largest that divides the 'data' size; one that no dim divides (JAX
    replicates it) is sharded on dim 0 with FSDP2's padding, and saved whole
    all the same. A layer's weights are all-gathered in float32 when its
    forward starts and freed when it ends; the backward gathers them again
    and reduce-scatters the gradients, summed over the ranks (JAX sums; FSDP2
    would average). Under a ('data', 'seq') mesh every 'seq' coordinate
    shards over its own 'data' group, and the trainer sums the sharded
    gradients over 'seq' after the backward (`mesh.all_reduce_grads` on the
    'seq' group), as JAX replicates over 'seq'.
  * `ParamShard` is what the optimizers, the checkpoints and the int8
    decode copy need of a sharded parameter: its 'data' group (or the
    'model' group of a tensor-parallel slice, `parallel/tensor.py`), the dim and
    the rows [lo, hi) of it that this rank holds. It gathers a tensor of the
    parameter's shape (a moment, a gradient) whole, narrows a whole one to
    this rank's slice, and takes means over whole rows and columns (the
    factored Adafactor statistics, which stay whole on every rank, as JAX
    replicates them).

One rank (or a 'data' axis of 1) shards nothing: the unsharded run, as JAX's
fsdp on one device is.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import Mesh, fsdp_spec


def _dtensor():
    from torch.distributed.tensor import DTensor

    return DTensor


def is_sharded(module: torch.nn.Module) -> bool:
    """Whether `module` was sharded by `shard_decoder` (an FSDP2 module)."""
    from torch.distributed.fsdp import FSDPModule

    return isinstance(module, FSDPModule)


def inference_forward(module_of):
    """Decorate a function whose forwards of the module `module_of(*args,
    **kwargs)` run without gradients: under `torch.inference_mode()`, or,
    where the module is sharded, under `torch.no_grad()` (the parameters
    FSDP2 gathers must stay ordinary tensors, and a gather inside inference
    mode makes inference tensors) and then `reshard` (the root keeps its
    gathered parameters after a forward without a backward)."""
    def decorate(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            module = module_of(*args, **kwargs)
            if not is_sharded(module):
                with torch.inference_mode():
                    return fn(*args, **kwargs)
            try:
                with torch.no_grad():
                    return fn(*args, **kwargs)
            finally:
                reshard(module)
        return wrapper
    return decorate


def reshard(module: torch.nn.Module):
    """Free a sharded module's gathered parameters and register its shards
    again (a no-op unsharded): what `named_parameters()` then yields are the
    shards, which the optimizer, the checkpoints and a restore work on."""
    if is_sharded(module):
        module.reshard()


def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's part of a sharded parameter or gradient (the tensor
    itself when it is not sharded): a view, so in-place updates land in the
    parameter."""
    return t.to_local() if isinstance(t, _dtensor()) else t


def placement(shape, n: int):
    """The FSDP2 placement of a parameter of `shape` over `n` ranks:
    `fsdp_spec`'s dim, or dim 0 (padded) where no dim divides `n`."""
    from torch.distributed.tensor import Shard

    spec = fsdp_spec(shape, Mesh(("data",), (n,)))
    return Shard(spec.index("data") if spec else 0)


def shard_decoder(decoder: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Shard `decoder`'s parameters over `mesh`'s 'data' axis in place (see
    the module docstring) and return it; with one rank on 'data' it stays
    as it is. The weights must already agree on every rank."""
    n = mesh.shape["data"]
    if n == 1 or is_sharded(decoder):
        return decoder
    from torch.distributed.fsdp import FSDPModule, fully_shard

    data_mesh = mesh.device_mesh["data"]
    place = lambda p: placement(tuple(p.shape), n)
    for layer in decoder.layers:
        fully_shard(layer, mesh=data_mesh, shard_placement_fn=place)
    fully_shard(decoder, mesh=data_mesh, shard_placement_fn=place)
    for module in decoder.modules():
        if isinstance(module, FSDPModule):
            # summed, never averaged: reduce-scatter with SUM, no scaling
            module.set_gradient_divide_factor(1.0)
            if hasattr(module, "set_force_sum_reduction_for_comms"):
                module.set_force_sum_reduction_for_comms(True)
    return decoder


@dataclasses.dataclass(frozen=True)
class ParamShard:
    """Which part of a parameter of global `shape` this rank holds: rows
    [lo, hi) of `dim` (torch.chunk's split over the `group`'s `size` ranks,
    the last ones possibly short or empty). `group` None: the whole."""
    shape: tuple
    dim: int = 0
    lo: int = 0
    hi: int = 0
    size: int = 1
    rank: int = 0
    group: Optional[object] = None

    @classmethod
    def of(cls, p: torch.Tensor) -> "ParamShard":
        """p's shard: over 'data' for an FSDP2 parameter, over 'model' for
        one that `parallel.tensor.shard_decoder_tp` split (its
        `param_shard`), else the whole."""
        tagged = getattr(p, "param_shard", None)
        if tagged is not None:
            return tagged
        shape = tuple(p.shape)
        if not isinstance(p, _dtensor()):
            return cls(shape, hi=shape[0] if shape else 0)
        (place,) = p.placements
        mesh = p.device_mesh
        size, rank = mesh.size(), mesh.get_local_rank()
        dim = place.dim
        chunk = -(-shape[dim] // size)
        lo, hi = min(rank * chunk, shape[dim]), min((rank + 1) * chunk, shape[dim])
        if tuple(p.to_local().shape) != tuple(hi - lo if i == dim else n
                                              for i, n in enumerate(shape)):
            raise RuntimeError(f"local shard {tuple(p.to_local().shape)} of {shape} is not "
                               f"rows [{lo}, {hi}) of dim {dim}")
        return cls(shape, dim, lo, hi, size, rank, mesh.get_group())

    @property
    def sharded(self) -> bool:
        return self.group is not None

    def narrow(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a tensor of the parameter's whole shape."""
        return full.narrow(self.dim, self.lo, self.hi - self.lo) if self.sharded else full

    def gather(self, part: torch.Tensor, dim: Optional[int] = None) -> torch.Tensor:
        """Every rank's `part` (this rank's slice along `dim`, the shard dim
        by default) joined whole along it, on every rank: one all-gather."""
        if not self.sharded:
            return part
        dim = self.dim if dim is None else dim
        chunk = -(-self.shape[self.dim] // self.size)
        moved = part.movedim(dim, 0)
        padded = moved.new_zeros((chunk, *moved.shape[1:]))
        padded[:moved.shape[0]] = moved
        out = moved.new_empty((chunk * self.size, *moved.shape[1:]))
        dist.all_gather_into_tensor(out, padded.contiguous(), group=self.group)
        return out[:self.shape[self.dim]].movedim(0, dim)

    def to_host(self, part: torch.Tensor, keep: bool) -> Optional[torch.Tensor]:
        """`gather(part)` copied to the host where `keep` (one rank), else
        None; every rank of the group must call it."""
        whole = self.gather(part)
        return whole.cpu() if keep else None

    def mean(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The mean over `dim` of the whole tensor that `x` is this rank's
        slice of, whole on every rank (a sum all-reduced over the shard dim,
        else this rank's means gathered)."""
        if not self.sharded:
            return x.mean(dim=dim)
        if dim == self.dim:
            total = x.sum(dim=dim)
            dist.all_reduce(total, group=self.group)
            return total / self.shape[dim]
        return self.gather(x.mean(dim=dim), self.dim - (self.dim > dim))

    def slice_of(self, stat: torch.Tensor, dropped: int) -> torch.Tensor:
        """This rank's part of a whole statistic that `dropped` reduced away
        (its shard dim shifted past it; a statistic without it is whole)."""
        if not self.sharded or dropped == self.dim:
            return stat
        d = self.dim - (self.dim > dropped)
        return stat.narrow(d, self.lo, self.hi - self.lo)
