"""SLAMTrainer: the pretraining loop, on one card or on a mesh of ranks.

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
  * a model with dropout draws one dropout seed a microbatch from a stream
    seeded by `seed` (`dropout_stream`); the stream's state rides in the
    checkpoint, so a resumed run repeats the uninterrupted run's masks, and
    evaluation draws none;
  * `max_steps` or `num_train_epochs` sets the schedule's length; the run
    ends with a final eval and save;
  * `profile_steps` > 0 traces steps [profile_start, profile_start +
    profile_steps) with `torch.profiler` (CUDA activity on the card, CPU
    activity always) into `<output_dir>/profile/trace.json.gz`, where the
    `train/forward`, `train/backward` and `train/optimizer` ranges name the
    step's parts.

Under torchrun (`parallel.init_distributed`) the trainer runs on the mesh of
`training_args.mesh_shape` / `mesh_axes` (JAX `slam_trainer.py:55-70`,
`:229-284`; `mesh_shape: null` is every rank on 'data'):

  * the global batch is per_device_train_batch_size x the 'data' size;
    every rank iterates the same seeded stream and keeps its tile
    (`parallel.local_tile`); num_items comes from the raw global labels;
  * under a 'seq' axis the labels are shifted over the global row before
    chunking (a chunk's last position keeps its target), `cp_schedule:
    zigzag` then permutes every per-token array, and attention runs the
    ring (`ops/ring_attention.py`) or, on the plain route, gathers k / v;
  * each rank's loss is its share of the global sum over num_items, so after
    the accumulation group the gradients get one all-reduce (SUM) over the
    world, in flat buckets (JAX sums; DistributedDataParallel would
    average), and clipping sees the global gradient on every rank;
  * dropout masks are drawn at the global batch's shape and tiled;
  * the logged loss and the eval sums are all-reduced; rank 0 alone logs,
    traces and writes checkpoints, and every rank waits for it at a
    barrier; every rank resumes from the checkpoint rank 0 resolves
    (`parallel.multihost.agree_on_checkpoint`), which every rank must read.

`training_args.multihost: true` trains one process group over several
hosts (torchrun on each, `parallel/multihost.py`; JAX `cli/train.py:33-38`):
without a process group it raises, and a launch over several nodes without
it raises. Over several nodes `output_dir` must be one directory every node
shares (checked before step 1, every rank raising together where a node
does not see rank 0's marker) and saves are synchronous
(`checkpoint.async_allowed`).

`training_args.fsdp: true` shards the parameters, the gradients and the
optimizer state over 'data' (ZeRO-3, `parallel/fsdp.py`; JAX
`slam_trainer.py:229`, `:285-301`): rank 0's weights are broadcast, then
sharded; each layer is gathered around its forward and its backward, and
each microbatch's gradients are reduce-scattered (summed) in the backward,
so the all-reduce above does not run; under a 'seq' axis the sharded
gradients are then all-reduced over 'seq'. The optimizer updates the local
shards (`trainer/optim.py`), and a checkpoint is gathered to rank 0 in the
one-rank format, so a run may resume on another number of ranks. With one
rank on 'data' nothing is sharded: the unsharded run, as in JAX.

A 'model' axis (`mesh_shape: [d, m]`, `mesh_axes: [data, model]`) trains
with the decoder's weights split over it (Megatron tensor parallelism,
`parallel/tensor.py`; JAX `slam_trainer.py:284-291`): rank 0's weights are
broadcast, then each rank keeps its slice; the batch goes over 'data' only,
so the ranks of a 'model' line hold the same tile, and the loss is the
vocab-parallel NLL of the rank's logit columns. The gradients, the loss and
the eval sums are summed over 'data' alone (`Mesh.batch_group`); the
optimizer's global norm and Adafactor's statistics take their sums over
'model' (`trainer/optim.py`), and checkpoints are gathered over 'model' to
rank 0 in the one-rank format. With `fsdp: true` beside it (JAX
`tp_shardings(fsdp=True)`, `slam_trainer.py:284-291`) each rank's slices are
then sharded over its 'model' coordinate's 'data' line
(`parallel.fsdp.shard_decoder`, by `parallel.tensor.tp_fsdp_plan`): the reduce-scatter sums each microbatch's
gradients over 'data' (a parameter replicated over 'model' has its whole
gradient on every rank of the line, through `copy_in`), the optimizer's
sums run over each parameter's groups, and checkpoints are gathered over
both axes.

A 'model' axis beside 'seq' (`mesh_shape: [d, m, s]`, `mesh_axes` the
three names in any order; JAX `slam_trainer.py:229-317`) runs both: each
rank holds its 'data' rows and its 'seq' chunk of the batch and its
'model' slices of the weights, and the ring (or the plain route's k / v
gathers) runs over its 'seq' line on the rank's heads. The ranks that hold
different tiles are the 'data' x 'seq' plane of a 'model' coordinate
(`Mesh.batch_group`): the gradients (without fsdp), the loss and the eval
sums are summed over it, never over 'model'. With `fsdp: true` the slices
are sharded over each ('model', 'seq') coordinate's 'data' line, and the
sharded gradients are then all-reduced over 'seq' as above. The 'seq'
replicas of a slice stay bitwise equal; the optimizers' sums run over the
'model' (and 'data') groups alone, so a 'seq' replica is never counted
twice, and checkpoints are gathered as for TP, the 'seq' replicas writing
nothing.

With one rank (no torchrun) nothing of this runs. The loop runs
synchronously on the model's device (no upload or metrics threads); a
checkpoint may be written in the background from a snapshot.
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
import torch.distributed as dist
from torch.profiler import record_function

from ..data.dataset import IGNORE_INDEX, Batcher, TokenDataset
from ..ops.ring_attention import SCHEDULES, check_chunk, zigzag_permutation
from ..parallel import fsdp, multihost
from ..parallel.mesh import Mesh, all_reduce_grads, local_tile, make_mesh, seq_axis_size
from ..parallel.tensor import shard_decoder_tp
from ..utils.calculation_utils import masked_sum, token_nll
from . import checkpoint
from .callbacks import TrainerCallback, TrainerControl, TrainerState
from .optim import make_optimizer

logger = logging.getLogger(__name__)

BATCH_KEYS = ("input_ids", "labels", "segment_ids", "positions")


def agree(control, world: int, device):
    """On a mesh, a stop, save or eval that any rank's callbacks ask for (a
    run-time stopper reads its own clock) holds on every rank."""
    if world == 1:
        return
    flags = torch.tensor([control.should_training_stop, control.should_save,
                          control.should_evaluate], dtype=torch.int32, device=device)
    dist.all_reduce(flags, op=dist.ReduceOp.MAX)
    control.should_training_stop, control.should_save, control.should_evaluate = (
        bool(f) for f in flags.tolist())


def dropout_stream(model, args) -> Optional[torch.Generator]:
    """The trainer's dropout stream where the model uses dropout (JAX: the
    `rng` of the train state): a CPU generator seeded from
    training_args.seed; its state rides in the checkpoint."""
    if not getattr(model, "uses_dropout", False):
        return None
    return torch.Generator().manual_seed(int(args.get("seed", 0) or 0))


def next_seed(stream: Optional[torch.Generator]) -> Optional[int]:
    """One microbatch's dropout seed from the stream (None without one)."""
    if stream is None:
        return None
    return int(torch.randint(1 << 62, (), generator=stream))


class SLAMTrainer:
    def __init__(self, model, args, train_dataset: TokenDataset,
                 eval_dataset: Optional[TokenDataset] = None,
                 callbacks: Optional[List[TrainerCallback]] = None,
                 packing: bool = False, context_len: Optional[int] = None,
                 log_fn=None, packing_strategy: str = "bestfit", mesh: Optional[Mesh] = None):
        multihost.check_launch(bool(args.get("multihost", False)))
        self.model = model
        self.args = args
        self.device = model.device
        self.callbacks = callbacks or []
        self.log_fn = log_fn
        self.mesh = mesh or make_mesh(args.get("mesh_shape", None), args.get("mesh_axes", None))
        self.world = self.mesh.size
        n_data = self.mesh.shape["data"]
        # ranks holding different tiles of a batch: the 'data' x 'seq' plane
        self.n_tiles = self.world // self.mesh.shape.get("model", 1)
        self.accum = int(args.get("gradient_accumulation_steps", 1) or 1)
        self.global_batch = int(args["per_device_train_batch_size"]) * n_data
        self.context_len = int(context_len or model.decoder.cfg.max_position_embeddings)
        self._setup_seq_axis()
        self.tp = self.mesh.shape.get("model", 1) > 1
        if self.tp:   # broadcasts rank 0's weights, then keeps the rank's slices
            shard_decoder_tp(model.decoder, self.mesh)
        elif self.world > 1:
            # every rank starts from rank 0's weights
            with torch.no_grad():
                for p in model.decoder.parameters():
                    dist.broadcast(p, src=0)
        if args.get("fsdp", False):   # the slices, under a 'model' axis
            fsdp.shard_decoder(model.decoder, self.mesh)
        self.sharded = fsdp.is_sharded(model.decoder)
        self.state = TrainerState()
        self.control = TrainerControl()
        self._data_pos = (0, 0)  # (epoch, microbatches consumed in epoch)
        # (epoch, index) of every microbatch consumed but not yet stepped
        self._pending_positions = deque()
        self._async_save = checkpoint.async_allowed(bool(args.get("async_save", True)),
                                                    self.mesh.nodes)
        self._saver = checkpoint.AsyncSaver()
        pad = model.config.pad_token_id
        self.train_batcher = Batcher(train_dataset, self.global_batch, self.context_len,
                                     pad_id=pad, packing=packing, shuffle=True,
                                     seed=int(args.get("seed", 0)),
                                     packing_strategy=packing_strategy)
        self.eval_batcher = None
        if eval_dataset is not None and len(eval_dataset):
            per_device = args.get("per_device_eval_batch_size",
                                  args["per_device_train_batch_size"])
            self.eval_batcher = Batcher(
                eval_dataset, int(per_device) * n_data,
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
        self.optimizer, self.schedule = make_optimizer(
            args, model.parameters(), self.total_steps,
            names=[n for n, _ in model.decoder.named_parameters()])
        self.dropout_stream = dropout_stream(model, args)

    def _setup_seq_axis(self):
        """Context parallelism over a 'seq' axis, checked as the JAX trainer
        checks it (`slam_trainer.py:244-260`): the context divides over the
        axis; where training or evaluation takes the flash route (the ring)
        each chunk suits the schedule; zigzag needs the flash route in
        training."""
        from ..models.transformer import _flash_route

        self.n_seq = seq_axis_size(self.mesh)
        self.cp_schedule = str(self.args.get("cp_schedule", "contiguous") or "contiguous")
        if self.cp_schedule not in SCHEDULES:
            raise ValueError(f"unknown ring schedule {self.cp_schedule!r}")
        self._zz_idx = None
        if self.n_seq == 1:
            return
        cfg = self.model.decoder.cfg
        if self.context_len % self.n_seq:
            raise ValueError(f"context_len {self.context_len} not divisible by seq axis "
                             f"{self.n_seq}")
        train_ring = _flash_route(cfg, self.device, cfg.attention_dropout > 0.0)
        if train_ring or _flash_route(cfg, self.device, False):
            try:
                check_chunk(self.context_len // self.n_seq, self.n_seq, self.cp_schedule)
            except ValueError as e:
                raise ValueError(
                    f"ring-attention context parallelism: {e}; use the plain attention "
                    f"(model.config_args.attn_implementation=xla) for smaller chunks") from e
        if not train_ring and self.cp_schedule != "contiguous":
            raise ValueError("cp_schedule=zigzag needs the flash attention path (ring "
                             "attention); the XLA CP path has no ring schedule")
        if self.cp_schedule == "zigzag":
            self._zz_idx = zigzag_permutation(self.context_len, self.n_seq)

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
        return {k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(self.device,
                                                                       non_blocking=True)
                for k in BATCH_KEYS}

    def _local(self, batch: Dict[str, np.ndarray]):
        """(this rank's tile of a global host batch on the device, its
        `parallel.Shard`, whether its labels are pre-shifted). One rank:
        the batch itself, None, False."""
        if self.world == 1:
            return self._to_device(batch), None, False
        batch = {k: batch[k] for k in BATCH_KEYS}
        if self.n_seq > 1:
            # the next-token targets, over the global row, before chunking
            lab = batch["labels"]
            batch["labels"] = np.concatenate(
                [lab[:, 1:], np.full_like(lab[:, :1], IGNORE_INDEX)], axis=1)
            if self._zz_idx is not None:
                batch = {k: v[:, self._zz_idx] for k, v in batch.items()}
        shard = self.mesh.shard(len(batch["input_ids"]), self.context_len, self.cp_schedule)
        return self._to_device(local_tile(batch, self.mesh)), shard, self.n_seq > 1

    def _train_step(self, group: List[Dict[str, np.ndarray]]):
        """Forward and backward over the group's microbatches, then one
        optimizer update; returns (summed loss tensor, tokens counted). The
        three parts are named ranges in a `torch.profiler` trace
        (`tools/profile_train.py` reads them); on a mesh the gradients' and
        the loss's all-reduce is `train/all_reduce`, over the ranks that
        hold different tiles (`Mesh.batch_group`)."""
        num_items = sum(int((mb["labels"] != IGNORE_INDEX).sum()) for mb in group)
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        for mb in group:
            with record_function("train/forward"):
                batch, shard, pre_shifted = self._local(mb)
                loss = self.model.loss_fn({**batch, "num_items_in_batch": num_items},
                                          dropout_seed=next_seed(self.dropout_stream),
                                          pre_shifted=pre_shifted, shard=shard)
            with record_function("train/backward"):
                loss.backward()
            loss_sum += loss.detach()
        if self.n_tiles > 1:
            with record_function("train/all_reduce"):
                if not self.sharded:
                    all_reduce_grads(self.model.decoder, self.mesh.batch_group())
                elif self.n_seq > 1:   # the shards are replicated over 'seq'
                    all_reduce_grads(self.model.decoder, self.mesh.group("seq"))
                dist.all_reduce(loss_sum, group=self.mesh.batch_group())
        with record_function("train/optimizer"):
            self.optimizer.step()
            self.optimizer.zero_grad()
        return loss_sum, sum(self._count_tokens(mb["labels"]) for mb in group)

    @fsdp.inference_forward(lambda self: self.model.decoder)
    def evaluate(self) -> Dict[str, float]:
        if self.eval_batcher is None:
            return {}
        total_nll = torch.zeros((), dtype=torch.float64, device=self.device)
        total_tokens = 0
        for batch in self.eval_batcher.epoch(0):
            b, shard, pre_shifted = self._local(batch)
            logits, _ = self.model.decoder(b["input_ids"], positions=b["positions"],
                                           segment_ids=b["segment_ids"], shard=shard)
            if pre_shifted:
                labels = b["labels"]
            else:
                logits, labels = logits[..., :-1, :], b["labels"][..., 1:]
            valid = labels != IGNORE_INDEX
            total_nll += masked_sum(token_nll(logits, labels, self.model.decoder.tp), valid)
            total_tokens += int((batch["labels"][..., 1:] != IGNORE_INDEX).sum())
        if self.n_tiles > 1:
            dist.all_reduce(total_nll, group=self.mesh.batch_group())
        loss = float(total_nll) / max(total_tokens, 1)
        metrics = {"eval_loss": loss, "eval_ppl": float(np.exp(min(loss, 30.0)))}
        self._log({**metrics, "step": self.state.global_step})
        return metrics

    # ------------------------------------------------------------------ #
    # checkpointing
    # ------------------------------------------------------------------ #
    def save_checkpoint(self):
        """Rank 0 writes the checkpoint (in the background under async_save);
        on a mesh every rank then waits for it at a barrier. Sharded (fsdp
        or 'model'), every rank first helps gather the state to rank 0."""
        if self.mesh.rank == 0 or self.sharded or self.tp:
            self._write_checkpoint()
        if self.world > 1:
            dist.barrier()

    def _write_checkpoint(self):
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
        state = checkpoint.train_state(self.model, self.optimizer, self.dropout_stream,
                                       copy=self._async_save, keep=self.mesh.rank == 0)
        if state is None:
            return
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
        checkpoint.restore(path, self.model, self.optimizer, self.dropout_stream)
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
        if self.mesh.rank:
            return
        logger.info("%s", record)
        if self.log_fn is not None:
            self.log_fn(record)

    def train(self, resume_from_checkpoint=False):
        args, state, control = self.args, self.state, self.control
        if self.mesh.nodes > 1:
            multihost.check_shared_dir(args["output_dir"], self.mesh, self.device)
        if resume_from_checkpoint:
            path = multihost.agree_on_checkpoint(resume_from_checkpoint, args["output_dir"],
                                                 self.mesh, self.device)
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
            if (profile_steps and state.global_step == profile_start and profiler is None
                    and self.mesh.rank == 0):
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
            agree(control, self.world, self.device)
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
        if self.world > 1:
            dist.barrier()
        for cb in self.callbacks:
            cb.on_train_end(args, state, control)
        return state
