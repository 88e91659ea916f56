"""The process mesh: several processes, one card each, over NCCL (gloo on the CPU).

Counterpart of `slamkit_tpu/parallel/mesh.py`. The JAX package places one
global array on a `jax.sharding.Mesh` of devices and lets XLA insert the
collectives; here every rank is a process that torchrun starts, holds its own
tile of the global batch and calls the collectives itself:

  * `topology()` reads where torchrun put this process (`RANK`,
    `WORLD_SIZE`, `LOCAL_RANK`, `LOCAL_WORLD_SIZE`, `GROUP_RANK`: its node);
  * `init_distributed(device)` joins torchrun's process group: NCCL on the
    card `LOCAL_RANK` of its node, gloo on the CPU;
  * `make_mesh(shape, axis_names)` keeps the JAX rules and messages
    (`mesh.py:28-52`) over the world's ranks, built on
    `torch.distributed.device_mesh.init_device_mesh` (rank = row-major
    position in the mesh, as JAX lays devices out). torchrun numbers ranks
    node by node, so an axis's groups stay inside a node when the product of
    its size and the sizes after it divides the ranks of a node
    (`Mesh.cross_node_axes`): rank 0 logs which axes cross nodes, with a
    warning where a 'model' or 'seq' group does (JAX allows it too);
  * `local_tile(batch, mesh)` is the slice of a global [B, T] batch that JAX's
    `shard_batch` / `batch_sharding` (`:60-71`, `:217-236`) place on a device:
    rows over 'data', the time chunk over 'seq';
  * `Mesh.shard(...)` describes that tile to the model (`Shard`): the ring's
    process group and the global shape the dropout masks are drawn at
    (the 'model' ranks of one 'data' and 'seq' coordinate hold the same
    tile);
    `Mesh.pair_shard(...)` is DPO's tile of a [2B, T] batch of chosen rows
    over rejected rows: a rank's pairs, both halves; `Mesh.row_tile(n)` is
    an evaluation batch's (`RowTile`): any n rows, padded as JAX's
    `UnitLM._pad_rows` pads them, and gathered back without the pads;
  * `all_reduce_grads(module)` sums the ranks' gradients in flat buckets,
    the one collective of a training step (JAX sums; DistributedDataParallel
    would average).

A 'model' axis (tensor parallelism, `parallel/tensor.py`) splits each
layer's weights, never the batch: `Mesh.batch_group()` is the group that
holds different tiles, over which gradients and losses are summed: on a
('data', 'model', 'seq') mesh, in any order of the names, the 'data' x
'seq' plane of the rank's 'model' coordinate (one group a plane, built by
`make_mesh`). `fsdp_spec` is the JAX rule as a plain function, which
`parallel/fsdp.py` shards parameters by.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import logging
import os
from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

#: Mesh axes the trainers understand: 'data' (the batch axis, always
#: present), 'model' (tensor parallelism), 'seq' (context parallelism: the
#: time dim of batches is split over it and attention runs the ring).
KNOWN_AXES = ("data", "model", "seq")

#: gradients are all-reduced in flat buckets of at most this many elements
BUCKET_ELEMENTS = 1 << 26


@dataclasses.dataclass(frozen=True)
class Topology:
    """Where torchrun put this process: global `rank` of `world`,
    `local_rank` of the `local_world` ranks on its `node`."""
    rank: int = 0
    world: int = 1
    local_rank: int = 0
    local_world: int = 1
    node: int = 0

    @property
    def nodes(self) -> int:
        return self.world // self.local_world


def topology(env=None) -> Topology:
    """This process's `Topology` from torchrun's environment (`env`, default
    `os.environ`). Without `LOCAL_WORLD_SIZE` every rank is on one node (a
    launch that sets only RANK / WORLD_SIZE / LOCAL_RANK); without
    `LOCAL_RANK` the rank is its own local rank, but only on one node: a
    second node would pick a card its host does not have. Nodes hold equal
    numbers of ranks, numbered node by node, as torchrun numbers them."""
    env = os.environ if env is None else env
    rank, world = int(env.get("RANK", "0")), int(env.get("WORLD_SIZE", "1"))
    local_world = int(env.get("LOCAL_WORLD_SIZE", str(world)))
    if local_world < 1 or world % local_world:
        raise ValueError(f"WORLD_SIZE={world} is not a whole number of nodes of "
                         f"LOCAL_WORLD_SIZE={local_world} ranks: start every node with the "
                         f"same --nproc_per_node")
    if "LOCAL_RANK" in env:
        local = int(env["LOCAL_RANK"])
    elif local_world < world:
        raise RuntimeError(f"rank {rank}: LOCAL_RANK is not set, and WORLD_SIZE={world} spans "
                           f"{world // local_world} nodes of {local_world} ranks, so RANK "
                           f"names no card of this host: start every node with torchrun")
    else:
        local = rank
    node = int(env.get("GROUP_RANK", str(rank // local_world)))
    if node != rank // local_world or local != rank % local_world:
        raise ValueError(f"rank {rank} is local rank {local} of node {node}, but torchrun "
                         f"numbers ranks node by node ({local_world} a node)")
    return Topology(rank, world, local, local_world, node)


def init_distributed(device, init_method: Optional[str] = None,
                     timeout: Optional[float] = None) -> torch.device:
    """Join the process group of torchrun's `topology()` and return the
    rank's device: on "cuda" the card `LOCAL_RANK` of its node (made current
    before any model is built, so the port's `resolve_device("cuda")` finds
    it) over NCCL, on "cpu" gloo. init_method defaults to torchrun's
    `env://` (a test passes a `file://` store); `timeout` (seconds) bounds
    every collective, so a rank whose peer on another node died fails
    instead of waiting out the backend's default. A rank without its card,
    or a failed init, raises."""
    topo = topology()
    rank, world, local = topo.rank, topo.world, topo.local_rank
    dev = torch.device(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if local >= count:
            raise RuntimeError(f"rank {rank} (local rank {local} of node {topo.node}) has no "
                               f"CUDA card: {count} visible on this host")
        torch.cuda.set_device(local)
        dev = torch.device("cuda", local)
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"the mesh runs on cuda or cpu, not {dev}")
    if dist.is_initialized():
        if dist.get_world_size() != world or dist.get_rank() != rank:
            raise RuntimeError(f"a process group of rank {dist.get_rank()} / "
                               f"{dist.get_world_size()} exists; the environment says "
                               f"{rank} / {world}")
        return dev
    extra = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    # device_id binds NCCL to the card at once, so a failed init raises here
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world,
                            device_id=dev if backend == "nccl" else None, **extra)
    return dev


@contextlib.contextmanager
def process_group(device):
    """The rank's device (`init_distributed`) inside torchrun's process
    group, left at the end; a process already in one keeps it (a caller
    that runs several entry points in one group)."""
    joined = not dist.is_initialized()
    dev = init_distributed(device)
    try:
        yield dev
    finally:
        if joined:
            dist.destroy_process_group()


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def check_mesh(shape: Optional[Sequence[int]], axis_names: Optional[Sequence[str]],
               n_devices: int) -> tuple:
    """(shape, axis_names) of a mesh over `n_devices` ranks, by the JAX
    `make_mesh` rules and messages: shape None is every rank on 'data'; the
    product must be the rank count; the default names are ('data',
    'model')[:rank]; names come from `KNOWN_AXES` and include 'data'."""
    if shape is None:
        shape = (n_devices,)
    shape = tuple(int(s) for s in shape)
    if int(np.prod(shape)) != n_devices:
        raise ValueError(f"mesh shape {shape} != device count {n_devices}")
    if axis_names is None:
        axis_names = ("data", "model")[:len(shape)]
    axis_names = tuple(axis_names)
    if len(axis_names) != len(shape):
        raise ValueError(f"mesh_axes {axis_names} rank != mesh shape {shape}")
    unknown = [a for a in axis_names if a not in KNOWN_AXES]
    if unknown or "data" not in axis_names:
        raise ValueError(
            f"mesh axes must be drawn from {KNOWN_AXES} and include 'data'; "
            f"got {axis_names}")
    return shape, axis_names


@dataclasses.dataclass(frozen=True)
class Shard:
    """What one rank's forward sees of a global [batch, time] batch: its
    `rows` (a slice, or the row indices in order), the logical position of
    each of its columns (`cols`: a contiguous chunk, or zigzag's two
    half-chunks), and the 'seq' group (`group`, this rank's `rank` in it,
    its `size`) the ring runs over."""
    batch: int
    time: int
    rows: Union[slice, np.ndarray]
    cols: np.ndarray
    group: Optional[object]
    rank: int
    size: int
    schedule: str = "contiguous"

    def tile(self, full: torch.Tensor, time_dim: int = 1) -> torch.Tensor:
        """This rank's tile of a tensor drawn at the global shape: its rows
        of dim 0, its columns of dim `time_dim`."""
        cols = torch.from_numpy(self.cols).to(full.device)
        rows = (full[self.rows] if isinstance(self.rows, slice)
                else full.index_select(0, torch.from_numpy(self.rows).to(full.device)))
        return rows.index_select(time_dim, cols)


@dataclasses.dataclass(frozen=True)
class RowTile:
    """This rank's rows [lo, hi) of an evaluation batch of `total` rows,
    padded at the end to an equal share on each rank of the 'data' `group`
    (JAX `unit_lm.py:178-192` pads, `:372` drops the pads)."""
    lo: int
    hi: int
    total: int
    group: Optional[object]

    def mine(self, full: torch.Tensor, fill) -> torch.Tensor:
        """This rank's rows of a [total, ...] tensor; rows past `total` (the
        pads) hold `fill`."""
        part = full[self.lo:min(self.hi, self.total)]
        missing = self.hi - self.lo - part.shape[0]
        if missing:
            part = torch.cat([part, part.new_full((missing, *full.shape[1:]), fill)])
        return part

    def gather(self, part: torch.Tensor) -> torch.Tensor:
        """Every rank's [hi - lo, ...] rows, in rank order, without the pads:
        [total, ...] on every rank (one all-gather)."""
        parts = [torch.empty_like(part) for _ in range(dist.get_world_size(self.group))]
        dist.all_gather(parts, part.contiguous(), group=self.group)
        return torch.cat(parts)[:self.total]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A mesh of `sizes` over the world's ranks, named `axis_names`; this
    process is `rank` (row-major over the mesh). `device_mesh` is torch's
    DeviceMesh where the world has several ranks, else None. `local_size`
    is the ranks of a node (0: every rank on one node). `plane_group` is
    this rank's 'data' x 'seq' plane where 'model' and both other axes are
    above 1 (`make_mesh` builds it), else None."""
    axis_names: tuple
    sizes: tuple
    rank: int = 0
    device_mesh: Optional[object] = None
    local_size: int = 0
    plane_group: Optional[object] = None

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def nodes(self) -> int:
        return self.size // self.local_size if self.local_size else 1

    @property
    def node(self) -> int:
        return self.rank // self.local_size if self.local_size else 0

    @property
    def cross_node_axes(self) -> tuple:
        """The axes some of whose groups hold ranks of several nodes (ranks
        numbered node by node, groups row-major as `init_device_mesh` forms
        them)."""
        if self.nodes == 1:
            return ()
        ranks = np.arange(self.size).reshape(self.sizes)
        crossing = []
        for i, name in enumerate(self.axis_names):
            nodes = np.moveaxis(ranks, i, -1).reshape(-1, self.sizes[i]) // self.local_size
            if (nodes != nodes[:, :1]).any():
                crossing.append(name)
        return tuple(crossing)

    @property
    def size(self) -> int:
        return int(np.prod(self.sizes))

    @property
    def coordinate(self) -> dict:
        return dict(zip(self.axis_names,
                        (int(i) for i in np.unravel_index(self.rank, self.sizes))))

    def group(self, axis: str):
        """The process group of this rank's line along `axis` (None on one rank)."""
        return None if self.device_mesh is None else self.device_mesh.get_group(axis)

    def batch_group(self):
        """The group whose ranks hold different tiles of a batch, over which
        gradients, losses and evaluation sums add up: the world (None) without
        a 'model' axis above 1; beside one, which gives each tile to the
        ranks of a 'model' line, the 'data' x 'seq' plane of this rank's
        'model' coordinate: the 'data' line, the 'seq' line where 'data' is
        1, or `plane_group` where both are above 1."""
        if self.shape.get("model", 1) == 1:
            return None
        if seq_axis_size(self) == 1:
            return self.group("data")
        return self.group("seq") if self.shape["data"] == 1 else self.plane_group

    def shard(self, batch: int, time: int, schedule: str = "contiguous") -> Shard:
        """The `Shard` of this rank in a global [batch, time] batch; under
        zigzag the columns are the logical positions of its half-chunks."""
        from ..ops.ring_attention import zigzag_permutation

        n_data, n_seq = self.shape["data"], seq_axis_size(self)
        at = self.coordinate
        rows = batch // n_data
        chunk = time // n_seq
        order = (zigzag_permutation(time, n_seq) if schedule == "zigzag" and n_seq > 1
                 else np.arange(time))
        r = at.get("seq", 0)
        return Shard(batch=batch, time=time,
                     rows=slice(at["data"] * rows, (at["data"] + 1) * rows),
                     cols=np.ascontiguousarray(order[r * chunk:(r + 1) * chunk]),
                     group=self.group("seq") if n_seq > 1 else None,
                     rank=r, size=n_seq, schedule=schedule)

    def row_tile(self, rows: int) -> RowTile:
        """This rank's `RowTile` of an evaluation batch of `rows` rows over
        'data' (the 'model' ranks of a 'data' coordinate hold the same
        rows; a 'seq' axis above 1 raises)."""
        n_data = self.shape["data"]
        if seq_axis_size(self) > 1:
            raise ValueError(f"a row tile splits rows over 'data' only; the mesh is {self.shape}")
        per = -(-rows // n_data)
        at = self.coordinate["data"]
        return RowTile(lo=at * per, hi=(at + 1) * per, total=rows, group=self.group("data"))

    def pair_shard(self, pairs: int, time: int) -> Shard:
        """This rank's `Shard` of a [2 pairs, time] DPO batch (chosen rows
        over rejected rows, row i paired with row pairs + i): the pairs
        [lo, hi) of its 'data' coordinate, rows [lo, hi) then [pairs + lo,
        pairs + hi), every column. The mesh has no 'seq' axis above 1."""
        n_data = self.shape["data"]
        if seq_axis_size(self) > 1:
            raise ValueError("a pair shard splits rows only: the mesh has a 'seq' axis")
        if pairs % n_data:
            raise ValueError(f"{pairs} pairs do not divide over 'data' = {n_data}")
        per = pairs // n_data
        mine = np.arange(self.coordinate["data"] * per, (self.coordinate["data"] + 1) * per)
        return Shard(batch=2 * pairs, time=time, rows=np.concatenate([mine, pairs + mine]),
                     cols=np.arange(time), group=None, rank=0, size=1)


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Optional[Sequence[str]] = None) -> Mesh:
    """The mesh over the world's ranks (one, without a process group).

    shape=None -> every rank on a 1-D 'data' axis (data parallelism);
    shape=[d, m] -> ('data', 'model'): tensor parallelism over 'model'
    (`parallel/tensor.py`), the rank's 'model' line one group;
    shape=[d, s] with axis_names=('data', 'seq') -> context parallelism
    (the ring over 'seq'); shape=[d, m, s] with the three names in any
    order -> both beside 'data', as JAX's `make_mesh` takes them, with one
    group a 'data' x 'seq' plane (`Mesh.batch_group`) where all three axes
    are above 1: every rank builds every plane's group, in the same order.
    A process that torchrun started as one of several ranks raises before
    it has joined their group (`init_distributed`): it would train alone."""
    launched = int(os.environ.get("WORLD_SIZE", "1"))
    if launched > 1 and not dist.is_initialized():
        raise RuntimeError(f"WORLD_SIZE={launched} but this process has joined no process "
                           f"group: call parallel.init_distributed first")
    n = world_size()
    shape, axis_names = check_mesh(shape, axis_names, n)
    if n == 1:
        return Mesh(axis_names, shape)
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    topo = topology()
    mesh = Mesh(axis_names, shape, dist.get_rank(),
                init_device_mesh(device_type, shape, mesh_dim_names=axis_names),
                local_size=topo.local_world if topo.nodes > 1 else 0,
                plane_group=_plane_group(axis_names, shape, dist.get_rank()))
    if mesh.nodes > 1 and mesh.rank == 0:
        _log_layout(mesh)
    return mesh


def planes(axis_names: Sequence[str], shape: Sequence[int]) -> np.ndarray:
    """The ranks of each 'data' x 'seq' plane of a mesh with a 'model'
    axis (row-major rank numbering), one row a 'model' coordinate, in the
    order of the plane's ranks."""
    ranks = np.arange(int(np.prod(shape))).reshape(shape)
    return np.moveaxis(ranks, list(axis_names).index("model"), 0).reshape(
        shape[list(axis_names).index("model")], -1)


def _plane_group(axis_names: Sequence[str], shape: Sequence[int], rank: int):
    """This rank's 'data' x 'seq' plane as a process group where 'model',
    'data' and 'seq' are all above 1, else None. Every rank creates every
    plane's group, in the same order, as `dist.new_group` requires."""
    sizes = dict(zip(axis_names, shape))
    if min(sizes.get(a, 1) for a in KNOWN_AXES) == 1:
        return None
    mine = None
    for plane in planes(axis_names, shape):
        group = dist.new_group(plane.tolist())
        if rank in plane:
            mine = group
    return mine


def _log_layout(mesh: Mesh):
    """Which axes of a mesh over several nodes cross them: 'data' may (its
    collectives are one gradient all-reduce a step); a 'model' or 'seq'
    group that does runs each layer's collectives over the slow link, which
    is allowed, as in JAX, and warned of."""
    crossing = mesh.cross_node_axes
    logger.info("mesh %s over %d nodes of %d ranks: %s", mesh.shape, mesh.nodes,
                mesh.local_size, f"{', '.join(crossing)} cross nodes" if crossing
                else "every axis stays inside a node")
    for axis in ("model", "seq"):
        if axis in crossing and mesh.shape[axis] > 1:
            logger.warning("mesh %s: the '%s' groups (%d ranks) cross nodes (%d ranks a "
                           "node): each layer's collectives over '%s' leave the node; an "
                           "axis size that divides the ranks of a node keeps them inside",
                           mesh.shape, axis, mesh.shape[axis], mesh.local_size, axis)


def seq_axis_size(mesh: Mesh) -> int:
    """Size of the 'seq' (context-parallel) axis; 1 when absent."""
    return int(mesh.shape.get("seq", 1))


def local_tile(batch: dict, mesh: Mesh) -> dict:
    """This rank's tile of a global host batch, as JAX's `shard_batch`
    places it: arrays of rank >= 2 split their leading dim over 'data'; a
    [B, T] array whose T divides a 'seq' axis also its time dim over 'seq';
    arrays of rank < 2 stay whole. Works on numpy arrays and tensors."""
    n_data, n_seq = mesh.shape["data"], seq_axis_size(mesh)
    at = mesh.coordinate
    out = {}
    for key, v in batch.items():
        if np.ndim(v) < 2:
            out[key] = v
            continue
        if v.shape[0] % n_data:
            raise ValueError(f"{key}: batch dim {v.shape[0]} does not divide over "
                             f"'data' = {n_data}")
        rows = v.shape[0] // n_data
        x = v[at["data"] * rows:(at["data"] + 1) * rows]
        if n_seq > 1 and np.ndim(v) == 2 and v.shape[1] % n_seq == 0:
            chunk = v.shape[1] // n_seq
            x = x[:, at["seq"] * chunk:(at["seq"] + 1) * chunk]
        out[key] = x
    return out


def all_reduce_grads(module: torch.nn.Module, group=None):
    """Sum every rank's gradients of `module`'s parameters in place: one
    all-reduce over `group` (the world by default) per flat bucket of one
    dtype; sharded gradients (`parallel/fsdp.py`, `parallel/tensor.py`) by
    their local shards."""
    from .fsdp import local

    def reduce(bucket):
        flat = torch.cat([g.reshape(-1) for g in bucket])
        dist.all_reduce(flat, group=group)
        for g, part in zip(bucket, flat.split([g.numel() for g in bucket])):
            g.copy_(part.view_as(g))

    grads = [local(p.grad) for p in module.parameters() if p.grad is not None]
    for dtype in sorted({g.dtype for g in grads}, key=str):
        bucket, size = [], 0
        for g in (g for g in grads if g.dtype == dtype):
            if bucket and size + g.numel() > BUCKET_ELEMENTS:
                reduce(bucket)
                bucket, size = [], 0
            bucket.append(g)
            size += g.numel()
        reduce(bucket)


def fsdp_spec(shape: Sequence[int], mesh: Mesh, axis: str = "data") -> tuple:
    """The partition spec (one axis name or None per dim) that shards the
    largest dim divisible by the axis size (the ZeRO-3 rule of the JAX
    package); scalars and indivisible arrays stay replicated (())."""
    n = mesh.shape[axis]
    dims = list(shape)
    for i in sorted(range(len(dims)), key=lambda i: -dims[i]):
        if dims[i] % n == 0 and dims[i] >= n:
            spec = [None] * len(dims)
            spec[i] = axis
            return tuple(spec)
    return ()
