"""ZeRO-3 parameter sharding over the mesh's 'data' axis (fsdp).

Counterpart of `slamkit_tpu/parallel/mesh.py`'s `param_shardings(fsdp=True)`
(`:93-100`), the fsdp part of `tp_shardings(fsdp=True)` (`:130-162`) and
`opt_state_shardings` (`:175-214`). The JAX package places every parameter
with a PartitionSpec and lets XLA gather and scatter; here torch's FSDP2
(`torch.distributed.fsdp.fully_shard`) does it around module calls:

  * `shard_decoder(decoder, mesh)` shards each `DecoderLayer` as a group of
    its own, then the root (embeddings, final norm, learned positions, the
    projections and the head; a tied embedding stays one parameter in that
    group), over this rank's 'data' line (`mesh.device_mesh["data"]`: on a
    2-D mesh the ranks that share its 'model' or 'seq' coordinate). Each
    parameter is sharded on the dim `tensor.tp_fsdp_plan` gives it
    (`data_dim`'s: the largest that divides the 'data' size); one that no
    dim divides (JAX replicates it) is sharded on dim 0 with FSDP2's
    padding, and saved whole all the same. A layer's
    weights are all-gathered in float32 when its forward starts and freed
    when it ends; the backward gathers them again and reduce-scatters the
    gradients, summed over the ranks (JAX sums; FSDP2 would average). Under
    a ('data', 'seq') mesh every 'seq' coordinate shards over its own 'data'
    group, and the trainer sums the sharded gradients over 'seq' after the
    backward (`mesh.all_reduce_grads` on the 'seq' group), as JAX replicates
    over 'seq'.
  * Beside tensor parallelism (`parallel/tensor.py`, split first) the
    parameters FSDP2 shards are each rank's 'model' slices: the 'data' dim
    is picked by JAX `tp_shardings(fsdp=True)`'s rule, the largest of the
    dims 'model' left alone, by its whole size, that the 'data' size
    divides (the plan's, `data_dim`'s `skip`), and the slice's
    `param_shard` tag is carried onto the sharded parameter.
  * `ParamShard` is what the optimizers, the checkpoints and the int8
    decode copy need of a sharded parameter: the group (its `axis`, 'data'
    or 'model'), the dim and the rows [lo, hi) of it that this rank holds,
    and, split on both axes, the 'data' shard of the 'model' slice
    (`inner`). It gathers a tensor of the parameter's shape (a moment, a
    gradient) whole, narrows a whole one to this rank's part, and takes
    means over whole rows and columns (the factored Adafactor statistics,
    which stay whole on every rank, as JAX replicates them).

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


def data_dim(shape, n: int, skip: Optional[int] = None) -> Optional[int]:
    """The dim JAX's fsdp rule (`fsdp_spec`) puts 'data' on for a parameter
    of whole `shape` over `n` ranks, leaving out `skip` (the dim 'model'
    splits, JAX `tp_shardings(fsdp=True)`); None where no dim divides `n`
    (JAX replicates)."""
    spec = fsdp_spec([0 if i == skip else d for i, d in enumerate(shape)],
                     Mesh(("data",), (n,)))
    return spec.index("data") if spec else None


def shard_decoder(decoder: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Shard `decoder`'s parameters over `mesh`'s 'data' axis in place (see
    the module docstring) and return it; with one rank on 'data' it stays
    as it is. The weights must already agree on every rank of a 'data'
    line (split over 'model' first, where they are)."""
    n = mesh.shape["data"]
    if n == 1 or is_sharded(decoder):
        return decoder
    from torch.distributed.fsdp import FSDPModule, fully_shard
    from torch.distributed.tensor import Shard

    from .tensor import tp_fsdp_plan   # tensor.py imports this module

    # fully_shard replaces every parameter: the 'model' tags go across
    named = dict(decoder.named_parameters())
    tags = {name: p.param_shard for name, p in named.items()
            if getattr(p, "param_shard", None) is not None}
    tp = getattr(decoder, "tp", None)
    plan = tp_fsdp_plan({name: tags[name].shape if name in tags else tuple(p.shape)
                         for name, p in named.items()}, tp.size if tp else None, n)
    dims = {id(p): plan[name][1] for name, p in named.items()}
    place = lambda p: Shard(dims[id(p)] or 0)   # None: dim 0, padded
    data_mesh = mesh.device_mesh["data"]
    for layer in decoder.layers:
        fully_shard(layer, mesh=data_mesh, shard_placement_fn=place)
    fully_shard(decoder, mesh=data_mesh, shard_placement_fn=place)
    for name, p in decoder.named_parameters():
        if name in tags:
            p.param_shard = tags[name]
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
    [lo, hi) of `dim` (torch.chunk's split over the `group`'s `size` ranks
    of the mesh's `axis`, the last ones possibly short or empty), and, where
    that part is split again over 'data', its own `ParamShard` (`inner`,
    whose `shape` is the part's). `group` None: the whole."""
    shape: tuple
    dim: int = 0
    lo: int = 0
    hi: int = 0
    size: int = 1
    rank: int = 0
    group: Optional[object] = None
    axis: str = "data"
    inner: Optional["ParamShard"] = None

    @classmethod
    def of(cls, p: torch.Tensor) -> "ParamShard":
        """p's shard: over 'data' for an FSDP2 parameter, over 'model' for
        one that `parallel.tensor.shard_decoder_tp` split (its
        `param_shard`), both for a 'model' slice FSDP2 sharded, else the
        whole."""
        tagged = getattr(p, "param_shard", None)
        shape = tuple(p.shape)
        if not isinstance(p, _dtensor()):
            return tagged if tagged is not None else cls(shape, hi=shape[0] if shape else 0)
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
        data = cls(shape, dim, lo, hi, size, rank, mesh.get_group())
        return data if tagged is None else dataclasses.replace(tagged, inner=data)

    @property
    def sharded(self) -> bool:
        return self.group is not None

    @property
    def levels(self) -> tuple:
        """The splits from the whole to this rank's part: this one, then
        `inner`'s (none for the whole)."""
        if not self.sharded:
            return ()
        return (self,) + (self.inner.levels if self.inner is not None else ())

    @property
    def axes(self) -> tuple:
        """The mesh axes the parameter is split over, outermost first."""
        return tuple(level.axis for level in self.levels)

    def narrow(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's part of a tensor of the parameter's whole shape."""
        for level in self.levels:
            full = full.narrow(level.dim, level.lo, level.hi - level.lo)
        return full

    def _gather(self, part: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's `part` of this split (its slice along `dim`) joined
        whole along it, on every rank of the group: one all-gather."""
        chunk = -(-self.shape[self.dim] // self.size)
        moved = part.movedim(dim, 0)
        padded = moved.new_zeros((chunk, *moved.shape[1:]))
        padded[:moved.shape[0]] = moved
        out = moved.new_empty((chunk * self.size, *moved.shape[1:]))
        dist.all_gather_into_tensor(out, padded.contiguous(), group=self.group)
        return out[:self.shape[self.dim]].movedim(0, dim)

    def gather(self, part: torch.Tensor) -> torch.Tensor:
        """The whole tensor whose part on this rank is `part`, on every rank:
        one all-gather a split, the innermost first."""
        for level in reversed(self.levels):
            part = level._gather(part, level.dim)
        return part

    def to_host(self, part: torch.Tensor, keep: bool) -> Optional[torch.Tensor]:
        """`gather(part)` copied to the host where `keep` (one rank), else
        None; every rank of the groups must call it."""
        whole = self.gather(part)
        return whole.cpu() if keep else None

    def mean(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The mean over `dim` of the whole tensor that `x` is this rank's
        part of, whole on every rank: over a split of `dim` a sum
        all-reduced over its group, over a split of another dim the means
        gathered, the innermost split first."""
        levels = self.levels
        split = any(level.dim == dim for level in levels)
        out = x.sum(dim=dim) if split else x.mean(dim=dim)
        for level in reversed(levels):
            if level.dim == dim:
                dist.all_reduce(out, group=level.group)
            else:
                out = level._gather(out, level.dim - (level.dim > dim))
        return out / self.shape[dim] if split else out

    def slice_of(self, stat: torch.Tensor, dropped: int) -> torch.Tensor:
        """This rank's part of a whole statistic that `dropped` reduced away
        (the split dims shifted past it; a split of `dropped` itself leaves
        the statistic whole along it)."""
        for level in self.levels:
            if level.dim != dropped:
                d = level.dim - (level.dim > dropped)
                stat = stat.narrow(d, level.lo, level.hi - level.lo)
        return stat
