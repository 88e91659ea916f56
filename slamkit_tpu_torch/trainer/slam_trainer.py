"""SLAMTrainer: the pretraining loop on one device.

Counterpart of `slamkit_tpu/trainer/slam_trainer.py`, the call
`cli/train.py:90-103` makes: `SLAMTrainer(model, args, train_dataset,
eval_dataset, callbacks, packing, context_len, packing_strategy).train()`.
`args` is a mapping with the keys of `config/training_args/default.yaml` and
`pretrain_training_args.yaml` (a dict or the composed config node).

  * gradient accumulation: the group's microbatches run forward and backward
    one at a time (activation memory freed per microbatch), the gradients
    add up in `.grad`, and every microbatch's loss is divided by the group's
    global valid-token count, so the sum is the group's mean loss;
  * `num_input_tokens_seen` counts labels in [min_token_id_count,
    max_token_id_count];
  * eval and save fire when the step reaches the next due multiple of
    eval_steps / save_steps, also after an off-grid resume;
  * checkpoints save the exact data-stream position (`data_pos`), resume
    replays from it, and a changed packing strategy is refused;
  * `max_steps` or `num_train_epochs` sets the schedule's length; the run
    ends with a final eval and save;
  * `profile_steps` > 0 traces steps [profile_start, profile_start +
    profile_steps) with `torch.profiler` (CUDA activity on the card, CPU
    activity always) into `<output_dir>/profile/trace.json.gz`, where the
    `train/forward`, `train/backward` and `train/optimizer` ranges name the
    step's parts.

The loop runs synchronously on the model's device (no mesh, no upload or
metrics threads); a checkpoint may be written in the background from a
snapshot. Knobs of the JAX trainer that the port does not implement raise.
"""
from __future__ import annotations

import json
import logging
import os
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from ..data.dataset import IGNORE_INDEX, Batcher, TokenDataset
from ..utils.calculation_utils import token_nll
from . import checkpoint
from .callbacks import TrainerCallback, TrainerControl, TrainerState
from .optim import make_optimizer

logger = logging.getLogger(__name__)

BATCH_KEYS = ("input_ids", "labels", "segment_ids", "positions")


def _refuse_unported(args):
    """The JAX trainer's mesh and multihost knobs wait for a later ROADMAP
    item; a non-default value raises rather than being ignored."""
    def bad(key, what, item):
        raise NotImplementedError(f"training_args.{key}={args.get(key)!r}: {what} is not "
                                  f"ported yet (ROADMAP {item})")

    if args.get("fsdp", False):
        bad("fsdp", "parameter sharding", "queue 1 item 14")
    mesh_shape = args.get("mesh_shape", None)
    if mesh_shape is not None and int(np.prod(list(mesh_shape))) != 1:
        bad("mesh_shape", "a multi-device mesh", "queue 1 item 14")
    if "seq" in list(args.get("mesh_axes", None) or []):
        bad("mesh_axes", "context parallelism", "queue 1 item 14")
    if (args.get("cp_schedule", "contiguous") or "contiguous") != "contiguous":
        bad("cp_schedule", "the ring-attention schedule", "queue 1 item 14")
    if args.get("multihost", False):
        bad("multihost", "multi-host training", "queue 1 item 14")


class SLAMTrainer:
    def __init__(self, model, args, train_dataset: TokenDataset,
                 eval_dataset: Optional[TokenDataset] = None,
                 callbacks: Optional[List[TrainerCallback]] = None,
                 packing: bool = False, context_len: Optional[int] = None,
                 log_fn=None, packing_strategy: str = "bestfit"):
        _refuse_unported(args)
        self.model = model
        self.args = args
        self.device = model.device
        self.callbacks = callbacks or []
        self.log_fn = log_fn
        self.accum = int(args.get("gradient_accumulation_steps", 1) or 1)
        self.global_batch = int(args["per_device_train_batch_size"])
        self.context_len = int(context_len or model.decoder.cfg.max_position_embeddings)
        self.state = TrainerState()
        self.control = TrainerControl()
        self._data_pos = (0, 0)  # (epoch, microbatches consumed in epoch)
        # (epoch, index) of every microbatch consumed but not yet stepped
        self._pending_positions = deque()
        self._async_save = bool(args.get("async_save", True))
        self._saver = checkpoint.AsyncSaver()
        pad = model.config.pad_token_id
        self.train_batcher = Batcher(train_dataset, self.global_batch, self.context_len,
                                     pad_id=pad, packing=packing, shuffle=True,
                                     seed=int(args.get("seed", 0)),
                                     packing_strategy=packing_strategy)
        self.eval_batcher = None
        if eval_dataset is not None and len(eval_dataset):
            self.eval_batcher = Batcher(
                eval_dataset,
                int(args.get("per_device_eval_batch_size", self.global_batch)),
                self.context_len, pad_id=pad, packing=packing, shuffle=False,
                packing_strategy=packing_strategy)

        max_steps = int(args.get("max_steps", -1) or -1)
        if max_steps > 0:
            # an explicit budget: estimate steps/epoch from the token count
            # instead of a dry pass over the packed stream
            if packing:
                est = max(train_dataset.num_tokens // (self.global_batch * self.context_len), 1)
            else:
                est = max((len(train_dataset) + self.global_batch - 1) // self.global_batch, 1)
            self.steps_per_epoch = max(est // self.accum, 1)
            self.total_steps = max_steps
        else:
            batches_per_epoch = self.train_batcher.batches_per_epoch()
            self.steps_per_epoch = max(batches_per_epoch // self.accum, 1)
            epochs = float(args.get("num_train_epochs", 1))
            self.total_steps = max(int(epochs * self.steps_per_epoch), 1)
        self.state.max_steps = self.total_steps
        self.optimizer, self.schedule = make_optimizer(args, model.parameters(),
                                                       self.total_steps)

    # ------------------------------------------------------------------ #
    # compute
    # ------------------------------------------------------------------ #
    def _count_tokens(self, labels: np.ndarray) -> int:
        valid = labels != IGNORE_INDEX
        lo = self.args.get("min_token_id_count", None)
        hi = self.args.get("max_token_id_count", None)
        if lo is not None:
            valid &= labels >= lo
        if hi is not None:
            valid &= labels <= hi
        return int(valid.sum())

    def _to_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(batch[k]).to(self.device, non_blocking=True)
                for k in BATCH_KEYS}

    def _train_step(self, group: List[Dict[str, np.ndarray]]):
        """Forward and backward over the group's microbatches, then one
        optimizer update; returns (summed loss tensor, tokens counted). The
        three parts are named ranges in a `torch.profiler` trace
        (`tools/profile_train.py` reads them)."""
        num_items = sum(int((mb["labels"] != IGNORE_INDEX).sum()) for mb in group)
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        for mb in group:
            with record_function("train/forward"):
                loss = self.model.loss_fn({**self._to_device(mb),
                                           "num_items_in_batch": num_items})
            with record_function("train/backward"):
                loss.backward()
            loss_sum += loss.detach()
        with record_function("train/optimizer"):
            self.optimizer.step()
            self.optimizer.zero_grad()
        return loss_sum, sum(self._count_tokens(mb["labels"]) for mb in group)

    @torch.inference_mode()
    def evaluate(self) -> Dict[str, float]:
        if self.eval_batcher is None:
            return {}
        total_nll = torch.zeros((), dtype=torch.float64, device=self.device)
        total_tokens = 0
        for batch in self.eval_batcher.epoch(0):
            b = self._to_device(batch)
            logits, _ = self.model.decoder(b["input_ids"], positions=b["positions"],
                                           segment_ids=b["segment_ids"])
            labels = b["labels"][..., 1:]
            valid = labels != IGNORE_INDEX
            total_nll += (token_nll(logits[..., :-1, :], labels) * valid).sum()
            total_tokens += int((batch["labels"][..., 1:] != IGNORE_INDEX).sum())
        loss = float(total_nll) / max(total_tokens, 1)
        metrics = {"eval_loss": loss, "eval_ppl": float(np.exp(min(loss, 30.0)))}
        self._log({**metrics, "step": self.state.global_step})
        return metrics

    # ------------------------------------------------------------------ #
    # checkpointing
    # ------------------------------------------------------------------ #
    def train_state(self) -> dict:
        """The live state a checkpoint holds: parameters by name, the AdamW
        moments and step count."""
        return {"params": dict(self.model.decoder.named_parameters()),
                **self.optimizer.state_dict()}

    def save_checkpoint(self):
        path = os.path.abspath(checkpoint.ckpt_dir(self.args["output_dir"],
                                                   self.state.global_step))
        # resume replays from the oldest consumed-but-unstepped microbatch
        data_pos = (tuple(self._pending_positions[0]) if self._pending_positions
                    else self._data_pos)
        trainer_json = {
            "global_step": self.state.global_step,
            "epoch": self.state.epoch,
            "data_pos": list(data_pos),
            # the resume fast-forward replays the same stream; another
            # packing strategy would skip or repeat data (load_checkpoint)
            "packing_strategy": (self.train_batcher.packing_strategy
                                 if self.train_batcher.packing else None),
            "num_input_tokens_seen": self.state.num_input_tokens_seen,
            "log_history": self.state.log_history[-50:]}
        self._saver.wait()
        state = self.train_state()
        if self._async_save:
            state = checkpoint.snapshot(state)
        output_dir, limit = self.args["output_dir"], self.args.get("save_total_limit", None)

        def write():
            checkpoint.save_state(path, state)
            checkpoint.save_host_artifacts(path, trainer_json, self.model, state)
            checkpoint.rotate_checkpoints(output_dir, limit)
            logger.info("Saved checkpoint %s", path)

        if self._async_save:
            self._saver.submit(write)
        else:
            write()

    @torch.no_grad()
    def load_checkpoint(self, path: str):
        self._saver.wait()   # never restore past an in-flight save
        with open(os.path.join(path, "trainer_state.json")) as f:
            st = json.load(f)
        saved_strategy = st.get("packing_strategy")
        if (saved_strategy is not None and self.train_batcher.packing
                and saved_strategy != self.train_batcher.packing_strategy):
            raise ValueError(
                f"Checkpoint was trained with packing_strategy={saved_strategy!r} but "
                f"this run uses {self.train_batcher.packing_strategy!r}: the resume "
                f"fast-forward would replay a different batch stream (skipped or "
                f"duplicated data). Set data.packing_strategy={saved_strategy} to "
                f"continue this run.")
        state = checkpoint.load_state(path, self.device)
        params = dict(self.model.decoder.named_parameters())
        if sorted(state["params"]) != sorted(params):
            raise ValueError(f"{path} holds other parameters than this model")
        for name, p in params.items():
            p.copy_(state["params"][name])
        self.optimizer.load_state_dict(state)
        self.state.global_step = st["global_step"]
        self.state.epoch = st["epoch"]
        self.state.num_input_tokens_seen = st["num_input_tokens_seen"]
        self.state.log_history = st.get("log_history", [])
        self._data_pos = tuple(st["data_pos"])
        logger.info("Resumed from %s at step %d", path, self.state.global_step)

    # ------------------------------------------------------------------ #
    # profiling
    # ------------------------------------------------------------------ #
    def _start_profiler(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()
        return profiler

    def _stop_profiler(self, profiler):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        profiler.stop()
        out = os.path.join(self.args["output_dir"], "profile")
        os.makedirs(out, exist_ok=True)
        profiler.export_chrome_trace(os.path.join(out, "trace.json.gz"))
        logger.info("Saved profiler trace to %s", out)

    # ------------------------------------------------------------------ #
    # loop
    # ------------------------------------------------------------------ #
    def _log(self, record: dict):
        self.state.log_history.append(record)
        logger.info("%s", record)
        if self.log_fn is not None:
            self.log_fn(record)

    def train(self, resume_from_checkpoint=False):
        args, state, control = self.args, self.state, self.control
        if resume_from_checkpoint:
            path = (resume_from_checkpoint if isinstance(resume_from_checkpoint, str)
                    else checkpoint.latest_checkpoint(args["output_dir"]))
            if not path:
                raise ValueError(f"No valid checkpoint found in {args['output_dir']} "
                                 f"(resume_from_checkpoint was requested)")
            self.load_checkpoint(path)

        for cb in self.callbacks:
            cb.on_train_begin(args, state, control)

        # steps [profile_start, profile_start + profile_steps) are traced
        # into <output_dir>/profile (the JAX trainer's window and defaults)
        profile_steps = int(args.get("profile_steps", 0) or 0)
        profile_start = int(args.get("profile_start", 3) or 3)
        profiler = None
        logging_steps = int(args.get("logging_steps", 50) or 50)
        save_steps = int(args.get("save_steps", 0) or 0)
        eval_steps = int(args.get("eval_steps", 0) or 0)
        do_eval = args.get("eval_strategy", "no") == "steps" and self.eval_batcher is not None

        def next_due(step: int, interval: int) -> int:
            return (step // interval + 1) * interval if interval else 0

        save_due = next_due(state.global_step, save_steps)
        eval_due = next_due(state.global_step, eval_steps)
        window_loss, window_t0, window_tokens = [], time.time(), 0
        last_eval_step = last_save_step = -1

        def step(group):
            nonlocal save_due, eval_due, window_loss, window_t0, window_tokens
            nonlocal last_eval_step, last_save_step, profiler
            for _ in group:
                self._pending_positions.popleft()
            if profile_steps and state.global_step == profile_start and profiler is None:
                profiler = self._start_profiler()
            loss_sum, tokens = self._train_step(group)
            if profiler is not None and state.global_step >= profile_start + profile_steps - 1:
                self._stop_profiler(profiler)
                profiler = None
            state.global_step += 1
            state.epoch = state.global_step / self.steps_per_epoch
            step_no = state.global_step
            state.num_input_tokens_seen += tokens
            window_loss.append(float(loss_sum))
            window_tokens += tokens
            if step_no % logging_steps == 0:
                dt = time.time() - window_t0
                self._log({"loss": float(np.mean(window_loss)),
                           "learning_rate": float(self.schedule(step_no)),
                           "num_input_tokens_seen": state.num_input_tokens_seen,
                           "tokens_per_sec": window_tokens / max(dt, 1e-9),
                           "epoch": round(step_no / self.steps_per_epoch, 4),
                           "step": step_no})
                window_loss, window_t0, window_tokens = [], time.time(), 0
            for cb in self.callbacks:
                cb.on_step_end(args, state, control)
            if do_eval and eval_steps and step_no >= eval_due:
                control.should_evaluate = True
                eval_due = next_due(step_no, eval_steps)
            if save_steps and step_no >= save_due:
                control.should_save = True
                save_due = next_due(step_no, save_steps)
            if control.should_evaluate:
                control.should_evaluate = False
                self.evaluate()
                last_eval_step = state.global_step
            if control.should_save:
                control.should_save = False
                self.save_checkpoint()
                last_save_step = state.global_step

        epoch, skip = self._data_pos
        # pending accumulates across epochs: a corpus smaller than one group
        # still makes progress
        pending: List[dict] = []
        while state.global_step < self.total_steps and not control.should_training_stop:
            yielded = 0
            for batch in self.train_batcher.epoch(epoch, skip_batches=skip):
                yielded += 1
                pending.append(batch)
                self._pending_positions.append((epoch, self._data_pos[1]))
                self._data_pos = (epoch, self._data_pos[1] + 1)
                if len(pending) < self.accum:
                    continue
                group, pending = pending, []
                step(group)
                if control.should_training_stop or state.global_step >= self.total_steps:
                    break
            else:  # epoch exhausted: roll to the next one
                if yielded == 0 and not pending and skip == 0:
                    raise RuntimeError("training dataset produced no batches (empty after "
                                       "filters?): cannot make progress")
                epoch += 1
                skip = 0
                self._data_pos = (epoch, 0)
                continue
            break

        if profiler is not None:   # the run ended inside the window
            self._stop_profiler(profiler)
        # final evaluate + save, unless a stop callback just did both
        if do_eval and last_eval_step != state.global_step:
            self.evaluate()
        if last_save_step != state.global_step:
            self.save_checkpoint()
        self._saver.wait()   # train() returns with the final save on disk
        for cb in self.callbacks:
            cb.on_train_end(args, state, control)
        return state
