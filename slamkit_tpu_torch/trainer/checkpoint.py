"""Checkpoint layout, discovery, rotation and the background writer.

Counterpart of `slamkit_tpu/trainer/checkpoint.py`. A checkpoint is
`<output_dir>/checkpoint-<step>/` holding

  * `state/train_state.pt`: `torch.save` of the train state (parameters by
    name, the optimizer's kind, state and step count, the dropout stream's
    state where the model uses dropout), written into a temporary
    directory and renamed into place (orbax, which the JAX package uses, is
    not on the card's host);
  * `unit_lm_config.json` + `params.npz`: the model export through
    `UnitLM.save_pretrained`, loadable by either package's `from_pretrained`;
  * `trainer_state.json`, written last and atomically: the completeness
    marker. `latest_checkpoint` counts a directory only when both `state/`
    and `trainer_state.json` exist, so a run killed mid-save resumes from the
    previous complete checkpoint.

`AsyncSaver` writes in a worker thread from a device-side snapshot
(`snapshot`, a `clone()` of every tensor) taken before the next step
updates the parameters in place; over several nodes (`async_allowed`)
saves are synchronous, as the JAX package's are with several processes.

A model sharded over 'data' (`parallel/fsdp.py`) saves in the same one-rank
format: `train_state` gathers each parameter and each parameter-shaped
optimizer tensor whole, one at a time, to rank 0's host (every rank takes
part), so a run may resume on another number of ranks. `restore` reads the
file on the host (memory-mapped) and copies each rank's slice into its
shards, the whole state never on a card. A model split over 'model'
(`parallel/tensor.py`) is gathered and restored the same way over its
'model' groups, and one split over 'model' and sharded over 'data' over
both (each part's 'data' line first, then its 'model' line).
"""
from __future__ import annotations

import json
import logging
import os
import shutil
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import torch

from ..parallel.fsdp import ParamShard, is_sharded, local, reshard
from ..parallel.tensor import is_tp

logger = logging.getLogger(__name__)

CKPT_PREFIX = "checkpoint-"
STATE_DIR = "state"
STATE_FILE = "train_state.pt"


def ckpt_dir(output_dir: str, step: int) -> str:
    return os.path.join(output_dir, f"{CKPT_PREFIX}{step}")


def _step_of(dirname: str) -> Optional[int]:
    if dirname.startswith(CKPT_PREFIX) and dirname[len(CKPT_PREFIX):].isdigit():
        return int(dirname[len(CKPT_PREFIX):])
    return None


def latest_checkpoint(output_dir: str) -> Optional[str]:
    """Newest complete checkpoint directory: `state/` and `trainer_state.json`."""
    if not os.path.isdir(output_dir):
        return None
    cands = [(s, d) for d in os.listdir(output_dir)
             if (s := _step_of(d)) is not None
             and os.path.isdir(os.path.join(output_dir, d, STATE_DIR))
             and os.path.isfile(os.path.join(output_dir, d, "trainer_state.json"))]
    return os.path.join(output_dir, max(cands)[1]) if cands else None


def rotate_checkpoints(output_dir: str, limit: Optional[int]):
    """Keep the newest `limit` checkpoint directories (all when falsy)."""
    if not limit:
        return
    steps = sorted(s for d in os.listdir(output_dir) if (s := _step_of(d)) is not None)
    for step in steps[:-limit]:
        shutil.rmtree(ckpt_dir(output_dir, step), ignore_errors=True)


def snapshot(train_state):
    """Device-side copy of a train state (dicts, lists, tensors, numbers):
    the next step updates the live tensors in place, so a background save
    writes from this copy."""
    if isinstance(train_state, torch.Tensor):
        return train_state.detach().clone()
    if isinstance(train_state, dict):
        return {k: snapshot(v) for k, v in train_state.items()}
    if isinstance(train_state, (list, tuple)):
        return type(train_state)(snapshot(v) for v in train_state)
    return train_state


class AsyncSaver:
    """One-slot background checkpoint writer: submitting (or `wait()`)
    first drains the previous save, so writes land in order and a failed
    save surfaces at the next checkpoint boundary."""

    def __init__(self):
        self._pool = ThreadPoolExecutor(1, thread_name_prefix="ckpt-save")
        self._inflight = None

    def wait(self):
        if self._inflight is not None:
            fut, self._inflight = self._inflight, None
            fut.result()

    def submit(self, fn):
        self.wait()
        self._inflight = self._pool.submit(fn)


def async_allowed(requested: bool, nodes: int) -> bool:
    """Whether saves run on the writer thread: as requested on one node,
    never over several (JAX `checkpoint.py:137-147` turns them off with
    more than one process). The port's writer thread issues no collective
    (a sharded state is gathered on the main thread first), but a save over
    several hosts lands on a file system they share, and a synchronous save
    is on disk before any rank goes on."""
    if requested and nodes > 1:
        logger.warning("async_save disabled on multihost (%d nodes): the checkpoint is "
                       "written before the next step", nodes)
        return False
    return requested


def save_state(path: str, train_state: dict):
    """`path/state/train_state.pt`, renamed into place whole; a stale
    checkpoint directory at `path` is cleared first."""
    path = os.path.abspath(path)
    if os.path.isdir(path):
        shutil.rmtree(path)
    tmp = os.path.join(path, "." + STATE_DIR + ".tmp")
    os.makedirs(tmp)
    torch.save(train_state, os.path.join(tmp, STATE_FILE))
    os.replace(tmp, os.path.join(path, STATE_DIR))


def load_state(path: str, device) -> dict:
    return torch.load(os.path.join(path, STATE_DIR, STATE_FILE), map_location=device,
                      weights_only=True)


def train_state(model, optimizer, dropout_stream: Optional[torch.Generator] = None,
                copy: bool = False, keep: bool = True) -> Optional[dict]:
    """The state a checkpoint holds: the decoder's parameters by name, the
    optimizer's kind, state and step count, and the dropout stream's state
    where the model uses dropout (so a resume repeats the masks). The live
    tensors, or with `copy` a snapshot the next step leaves alone. A sharded
    model's state is gathered whole to the host of the rank that passes
    `keep` (the others get None); every rank must call it then."""
    if is_sharded(model.decoder) or is_tp(model.decoder):
        return _gathered_state(model, optimizer, dropout_stream, keep)
    state = {"params": dict(model.decoder.named_parameters()), **optimizer.state_dict()}
    if dropout_stream is not None:
        state["dropout_rng"] = dropout_stream.get_state()
    return snapshot(state) if copy else state


def _gathered_state(model, optimizer, dropout_stream, keep: bool) -> Optional[dict]:
    """`train_state` of a sharded model: one tensor at a time gathered on
    the card and copied to the keeping rank's host."""
    reshard(model.decoder)
    params = {name: ParamShard.of(p).to_host(local(p.detach()), keep)
              for name, p in model.decoder.named_parameters()}
    state = optimizer.state_dict()
    for key in optimizer.SHARDED_KEYS:
        state[key] = [None if t is None else shard.to_host(t, keep)
                      for t, shard in zip(state[key], optimizer.shards)]
    if not keep:
        return None
    state = {"params": params, **{k: (v.cpu() if isinstance(v, torch.Tensor) else
                                      [None if t is None else t.cpu() for t in v]
                                      if isinstance(v, list) else v)
                                  for k, v in state.items()}}
    if dropout_stream is not None:
        state["dropout_rng"] = dropout_stream.get_state()
    return state


@torch.no_grad()
def restore(path: str, model, optimizer,
            dropout_stream: Optional[torch.Generator] = None):
    """Load `path`'s train state into the model's parameters, the optimizer
    and the dropout stream, in place: read on the host, memory-mapped, and
    copied tensor by tensor (this rank's slice of each into a sharded
    model). A checkpoint without a stream (written by a run without
    dropout) leaves `dropout_stream` as seeded."""
    state = torch.load(os.path.join(path, STATE_DIR, STATE_FILE), map_location="cpu",
                       weights_only=True, mmap=True)
    reshard(model.decoder)
    params = dict(model.decoder.named_parameters())
    if sorted(state["params"]) != sorted(params):
        raise ValueError(f"{path} holds other parameters than this model")
    for name, p in params.items():
        local(p).copy_(ParamShard.of(p).narrow(state["params"][name]))
    optimizer.load_state_dict(state)
    if dropout_stream is not None:
        if "dropout_rng" in state:
            dropout_stream.set_state(state["dropout_rng"].cpu())
        else:
            logger.warning("%s holds no dropout stream: the masks restart from the seed",
                           path)


def save_host_artifacts(path: str, trainer_json: dict, model, train_state: dict):
    """The model export from the state's parameters, then trainer_state.json
    by rename, last: the marker never points at a half-written export. Runs
    on the saver thread and leaves the live model untouched."""
    model.save_pretrained(path, params=train_state["params"])
    tmp = os.path.join(path, ".trainer_state.json.tmp")
    with open(tmp, "w") as f:
        json.dump(trainer_json, f)
    os.replace(tmp, os.path.join(path, "trainer_state.json"))
