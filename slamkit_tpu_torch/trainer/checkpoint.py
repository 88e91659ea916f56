"""Checkpoint layout, discovery, rotation and the background writer.

Counterpart of `slamkit_tpu/trainer/checkpoint.py`. A checkpoint is
`<output_dir>/checkpoint-<step>/` holding

  * `state/train_state.pt`: `torch.save` of the train state (parameters by
    name, the AdamW moments and step count), written into a temporary
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
updates the parameters in place.
"""
from __future__ import annotations

import json
import logging
import os
import shutil
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import torch

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


def save_host_artifacts(path: str, trainer_json: dict, model, train_state: dict):
    """The model export from the state's parameters, then trainer_state.json
    by rename, last: the marker never points at a half-written export. Runs
    on the saver thread and leaves the live model untouched."""
    model.save_pretrained(path, params=train_state["params"])
    tmp = os.path.join(path, ".trainer_state.json.tmp")
    with open(tmp, "w") as f:
        json.dump(trainer_json, f)
    os.replace(tmp, os.path.join(path, "trainer_state.json"))
