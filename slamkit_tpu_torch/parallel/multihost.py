"""Training across several hosts: torchrun on every node, one process group.

Counterpart of `cli/train.py:33-38` (`training_args.multihost` calls
`jax.distributed.initialize()`) and of what the JAX package's orbax saves
assume. The port's ranks are already processes, so the collectives carry
over; what a second host adds is checked here:

  * `check_launch(multihost)`: `training_args.multihost=true` needs a
    process group (WORLD_SIZE 1 raises, naming `torchrun --nnodes N
    --node_rank k`, as `jax.distributed.initialize()` raises without a
    cluster), and a launch whose ranks span several nodes needs the flag (JAX
    would train each host alone; the port refuses);
  * `every_node(ok, what, mesh, device)`: one all-reduce of the nodes'
    failures, after which every rank raises together, naming the nodes that
    failed, so no rank is left waiting in a collective;
  * `check_shared_dir(path, ...)`: rank 0 writes a marker under `path`
    (the hidden `.multihost/`, which checkpoint discovery and rotation
    ignore) and every rank must read it back: one directory that every node
    sees, as orbax's collective save assumes of its path;
  * `agree_on_checkpoint(resume, output_dir, ...)`: rank 0 alone resolves
    the checkpoint to resume from and broadcasts it; every rank must read
    its state there;
  * `check_data_paths(cfg.data, ...)`: the corpora (a path or a glob each)
    every node must see.

A failure that is not such a check (a rank that dies) leaves its peers in a
collective until the process group's timeout: `init_distributed(timeout=)`
bounds it, and `tools/multinode.py` stops every node's launch once one
fails.
"""
from __future__ import annotations

import contextlib
import glob
import os
import uuid
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import Mesh, topology

#: the hidden directory of `check_shared_dir`'s markers
MARKER_DIR = ".multihost"
LAUNCH = ("python -m torch.distributed.run --nnodes N --node_rank k --nproc_per_node G "
          "--master_addr <node 0's address> --master_port <port> -m <module> ...")


def check_launch(multihost: bool):
    """Refuse `training_args.multihost=true` without a process group, and a
    launch over several nodes without it."""
    topo = topology()
    if multihost and topo.world == 1:
        raise RuntimeError("training_args.multihost=true trains one process group over "
                           "several hosts, and this process was not started as one of its "
                           f"ranks (WORLD_SIZE=1): start every host with `{LAUNCH}`")
    if topo.nodes > 1 and not multihost:
        raise RuntimeError(f"this torchrun launch spans {topo.nodes} nodes of "
                           f"{topo.local_world} ranks: set training_args.multihost=true to "
                           f"train one model over them")


def every_node(ok: bool, what: str, mesh: Mesh, device):
    """Raise on every rank of `mesh` unless every rank's `ok` holds: one
    all-reduce of a flag a node, the message naming the nodes where it did
    not."""
    if mesh.size == 1:
        if not ok:
            raise RuntimeError(what)
        return
    failed = torch.zeros(mesh.nodes, dtype=torch.int32, device=device)
    failed[mesh.node] = int(not ok)
    dist.all_reduce(failed)
    nodes = [i for i, n in enumerate(failed.tolist()) if n]
    if nodes:
        raise RuntimeError(f"{what}: failed on node{'s' if len(nodes) > 1 else ''} "
                           f"{', '.join(map(str, nodes))} of {mesh.nodes}"
                           + ("" if ok else f" (this is rank {mesh.rank} on node {mesh.node})"))


def check_shared_dir(path: str, mesh: Mesh, device, what: str = "training_args.output_dir"):
    """Every rank must read the marker rank 0 writes under `path` (created
    if missing): one directory shared by every node, or every rank raises."""
    marks = os.path.join(path, MARKER_DIR)
    sent = [None]
    if mesh.rank == 0:
        name = uuid.uuid4().hex
        try:
            os.makedirs(marks, exist_ok=True)
            with open(os.path.join(marks, name), "w") as f:
                f.write(name)
            sent = [name]
        except OSError as e:
            sent = [f"node 0 could not write under {path}: {e}"]
    dist.broadcast_object_list(sent, src=0)
    if not sent[0].isalnum():   # every rank got node 0's error
        raise RuntimeError(f"{what}: {sent[0]}")
    try:
        with open(os.path.join(marks, sent[0])) as f:
            ok = f.read() == sent[0]
    except OSError:
        ok = False
    try:
        every_node(ok, f"{what} {path} must be one directory that every node shares (rank "
                   f"0 wrote {MARKER_DIR}/{sent[0]} there; a node that cannot read it has a "
                   f"directory of its own)", mesh, device)
    finally:
        if mesh.rank == 0:
            os.remove(os.path.join(marks, sent[0]))
            with contextlib.suppress(OSError):
                os.rmdir(marks)


def check_data_paths(data, mesh: Mesh, device):
    """The corpora every node reads, each of `data.train_path` / `val_path`
    (a path, a glob or a list of them), must exist on every node, or every
    rank raises."""
    paths = []
    for key in ("train_path", "val_path"):
        value = data.get(key, None)
        paths += [] if value is None else [str(value)] if isinstance(value, str) else \
            [str(v) for v in value]
    missing = [p for p in paths if not glob.glob(p)]
    every_node(not missing, f"data.train_path / val_path ({', '.join(paths)}) must exist on "
               f"every node" + (f"; this rank finds no {', '.join(missing)}" if missing else ""),
               mesh, device)


def agree_on_checkpoint(resume, output_dir: str, mesh: Mesh, device) -> Optional[str]:
    """The checkpoint a resume reads: `resume` when it is a path, else the
    newest complete one in `output_dir`, resolved by rank 0 alone and
    broadcast, so every rank resumes from the same step; every rank must
    find its state there (or every rank raises). None when there is none."""
    from ..trainer import checkpoint

    path = [resume if isinstance(resume, str) else
            checkpoint.latest_checkpoint(output_dir) if mesh.rank == 0 else None]
    if mesh.size == 1:
        return path[0]
    dist.broadcast_object_list(path, src=0)
    if path[0] is None:
        return None
    readable = all(os.path.isfile(os.path.join(path[0], *parts)) for parts in
                   ((checkpoint.STATE_DIR, checkpoint.STATE_FILE), ("trainer_state.json",)))
    every_node(readable, f"the checkpoint {path[0]} to resume from (its "
               f"{checkpoint.STATE_DIR}/{checkpoint.STATE_FILE} and trainer_state.json) must "
               f"be readable on every node", mesh, device)
    return path[0]
