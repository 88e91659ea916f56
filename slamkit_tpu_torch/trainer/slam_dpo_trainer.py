"""SLAMDPOTrainer: Direct Preference Optimization, on one card or on the
'data' axis of a mesh of ranks.

Counterpart of `slamkit_tpu/trainer/slam_dpo_trainer.py`, the call
`cli/preference_alignment_train.py` makes: `SLAMDPOTrainer(model, tokenizer,
args, train_dataset, eval_dataset, callbacks).train()`. `args` is a mapping
with the keys of `config/training_args/dpo_training_args.yaml` (a dict or the
composed config node).

    loss = -log sigmoid(beta [(log pi(chosen) - log pi(rejected))
                              - (log ref(chosen) - log ref(rejected))])

  * `tokenize_row`: prompt = [bos] + ids, each completion gets a trailing
    eos; the prompt is truncated from the left, completions from the right;
  * a batch is [2B, T]: chosen rows over rejected rows, one segment (0) and
    a -1 tail, `completion_mask` on the answer tokens; T is the smallest of
    `length_buckets` length-quantile targets that covers the batch;
  * the reference is a frozen float32 copy of the policy the trainer was
    built from (`requires_grad_(False)`, run under `torch.no_grad`); a
    resume restores the policy and the optimizer, never the reference;
  * the data order is `np.random.default_rng(seed).permutation` per epoch
    (rows tiled when fewer than a batch), a resume replays the completed
    epochs' draws and skips the current epoch's batches;
  * saves fire at the next due multiple of save_steps; the run ends with an
    evaluation (the eval rows wrapped round to fill the last batch) and a
    save, whose export `cli.eval` and either package's `from_pretrained`
    load.

The attention of every forward (policy, reference, evaluation) follows the
model's attn_implementation (`models/transformer.py`), and the policy's
backward on the flash path is the flash backward. A model with dropout
(dropout, attention_dropout, layerdrop) draws one dropout seed a step for
the policy's forward from a stream seeded by `seed`, whose state rides in
the checkpoint (exact resume); the reference and evaluation forwards stay
deterministic, as trl keeps the reference in eval mode. The loop runs
synchronously on the model's device.

Under torchrun (`parallel.init_distributed`) the trainer runs on the mesh of
`training_args.mesh_shape` / `mesh_axes` (JAX `slam_dpo_trainer.py:65-117`,
`:219-259`; `mesh_shape: null` is every rank on 'data'):

  * the global batch is per_device_train_batch_size x the 'data' size of
    pairs; every rank draws the same permutation and collates the global
    [2B, T] batch (T the bucket of its longest row), then keeps its pairs,
    rows [lo, hi) and [B + lo, B + hi) (`Mesh.pair_shard`), so chosen and
    rejected rows of a pair stay on one rank;
  * each rank's loss and reward metrics are its pairs' sums over the global
    B, its share of the global means; the reference's forward runs on the
    rank's pairs; after the backward the gradients get one all-reduce (SUM)
    over the world (`parallel.all_reduce_grads`), so every rank steps with
    the one-process gradient;
  * the policy's dropout masks are drawn at the global [2B, T] shape and
    tiled by the pair shard;
  * the logged loss and metrics and the evaluation's per-batch loss and
    accuracy are all-reduced; rank 0 alone logs and writes checkpoints (in
    the one-rank format), every rank waits for it at a barrier, and every
    rank resumes from the checkpoint rank 0 resolves.

`training_args.fsdp: true` shards the policy's parameters, gradients and
optimizer state over 'data' (`parallel/fsdp.py`), and the frozen reference
is copied from the policy before and sharded as it is (JAX
`slam_dpo_trainer.py:219-246` gives both the same shardings); the
gradients are reduce-scattered in the backward instead of all-reduced, and
checkpoints are gathered to rank 0 in the one-rank format.

On a ('data', 'model') mesh the trainer does what the JAX DPO trainer does
(`slam_dpo_trainer.py:219-246` takes `param_shardings` without tp): the
parameters stay whole on every rank, the pairs go over 'data', the ranks of
a 'model' line compute the same pairs, and the gradients and the logged
sums are summed over 'data' alone (`Mesh.batch_group`). With `fsdp: true`
there (JAX's `param_shardings(fsdp=True)` on that mesh) the policy and the
reference are sharded over each 'model' coordinate's 'data' line, whole
across 'model': every line reduce-scatters the same gradients.

A 'seq' axis above 1 raises the JAX trainer's NotImplementedError.
`training_args.multihost: true` spans several hosts as `SLAMTrainer` does
(JAX `slam_dpo_trainer.py:83-90` reads the process count): it needs a
process group, a launch over several nodes needs it, `output_dir` must be
shared by every node, the checkpoint to resume from is rank 0's, and saves
are synchronous over several nodes.
"""
from __future__ import annotations

import copy
import json
import logging
import os
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..parallel import fsdp, multihost
from ..parallel.mesh import Mesh, all_reduce_grads, make_mesh, seq_axis_size
from ..utils.calculation_utils import token_nll
from . import checkpoint
from .callbacks import TrainerCallback, TrainerControl, TrainerState
from .optim import make_optimizer
from .slam_trainer import agree, dropout_stream, next_seed

logger = logging.getLogger(__name__)

BATCH_KEYS = ("input_ids", "completion_mask", "segment_ids")


def tokenize_row(features: dict, processing_class, max_prompt_length: Optional[int],
                 max_completion_length: Optional[int], add_special_tokens: bool):
    """{prompt, chosen, rejected} (representation dicts or unit strings) ->
    {prompt,chosen,rejected}_input_ids."""
    tokenizer = processing_class

    def enc(x):
        ids = tokenizer(x, add_special_tokens=False)["input_ids"]
        return list(ids[0]) if ids and isinstance(ids[0], (list, np.ndarray)) else list(ids)

    prompt_input_ids = [tokenizer.bos_token_id] + enc(features["prompt"])
    chosen_input_ids = enc(features["chosen"])
    rejected_input_ids = enc(features["rejected"])
    if add_special_tokens and tokenizer.eos_token_id is not None:
        prompt_input_ids = prompt_input_ids + [tokenizer.eos_token_id]
    chosen_input_ids = chosen_input_ids + [tokenizer.eos_token_id]
    rejected_input_ids = rejected_input_ids + [tokenizer.eos_token_id]
    if max_prompt_length is not None:
        prompt_input_ids = prompt_input_ids[-max_prompt_length:]
    if max_completion_length is not None:
        chosen_input_ids = chosen_input_ids[:max_completion_length]
        rejected_input_ids = rejected_input_ids[:max_completion_length]
    return {"prompt_input_ids": prompt_input_ids,
            "chosen_input_ids": chosen_input_ids,
            "rejected_input_ids": rejected_input_ids}


def row_len(r) -> int:
    """A tokenised row's longer sequence: prompt + the longer completion."""
    return (len(r["prompt_input_ids"]) +
            max(len(r["chosen_input_ids"]), len(r["rejected_input_ids"])))


def collate(rows: List[dict], bucket_lens: List[int], pad_id: int) -> Dict[str, np.ndarray]:
    """Tokenised rows -> [2B, T]: chosen rows then rejected rows, each one
    segment (0) and a -1 tail of pads; `completion_mask` marks the answer
    tokens. T is the smallest of `bucket_lens` that covers the longest row."""
    batch_max = max(row_len(r) for r in rows)
    b = len(rows)
    t = next(x for x in bucket_lens if x >= batch_max)
    ids = np.full((2 * b, t), pad_id, np.int32)
    comp = np.zeros((2 * b, t), np.float32)
    seg = np.full((2 * b, t), -1, np.int32)
    for i, r in enumerate(rows):
        p = r["prompt_input_ids"]
        for j, c in enumerate((r["chosen_input_ids"], r["rejected_input_ids"])):
            row = (p + c)[:t]
            ids[i + j * b, :len(row)] = row
            seg[i + j * b, :len(row)] = 0
            comp[i + j * b, len(p):len(row)] = 1.0
    return {"input_ids": ids, "completion_mask": comp, "segment_ids": seg}


def sequence_logps(decoder, batch: Dict[str, torch.Tensor],
                   dropout_seed: Optional[int] = None, shard=None) -> torch.Tensor:
    """[2B] float32: each row's summed log-probability of its completion
    tokens (the targets under `completion_mask`); dropout_seed turns on the
    decoder's dropout rates; shard: the rows' `parallel.Shard` of the global
    batch (where the masks are drawn), or None."""
    logits, _ = decoder(batch["input_ids"], segment_ids=batch["segment_ids"],
                        dropout_seed=dropout_seed, shard=shard)
    lp = -token_nll(logits[:, :-1], batch["input_ids"][:, 1:])
    return (lp * batch["completion_mask"][:, 1:]).sum(-1)


def dpo_objective(lp: torch.Tensor, ref_lp: torch.Tensor, beta: float,
                  pairs: Optional[int] = None):
    """(loss, metrics) from the policy's and the reference's [2B] completion
    log-probabilities, chosen rows first: each a sum over these B pairs
    divided by `pairs` (default B: the means), so that a rank holding B of
    the global batch's `pairs` gets its share of the global means."""
    b = lp.shape[0] // 2
    n = b if pairs is None else pairs
    logits = beta * ((lp[:b] - lp[b:]) - (ref_lp[:b] - ref_lp[b:]))
    loss = -F.logsigmoid(logits).sum() / n
    metrics = {
        "rewards/chosen": (beta * (lp[:b] - ref_lp[:b])).sum() / n,
        "rewards/rejected": (beta * (lp[b:] - ref_lp[b:])).sum() / n,
        "rewards/accuracies": (logits > 0).float().sum() / n,
        "rewards/margins": logits.sum() / n,
    }
    return loss, metrics


class SLAMDPOTrainer:
    def __init__(self, model, tokenizer, args, train_dataset: List[dict],
                 eval_dataset: Optional[List[dict]] = None,
                 callbacks: Optional[List[TrainerCallback]] = None, log_fn=None,
                 mesh: Optional[Mesh] = None):
        multihost.check_launch(bool(args.get("multihost", False)))
        self.mesh = mesh or make_mesh(args.get("mesh_shape", None), args.get("mesh_axes", None))
        if seq_axis_size(self.mesh) > 1:
            raise NotImplementedError(
                "context parallelism ('seq' mesh axis) is a pretrain-trainer "
                "feature; DPO batches are short prompt+completion rows")
        self.world = self.mesh.size
        self.model = model
        self.args = args
        self.device = model.device
        if self.world > 1:
            # every rank starts from rank 0's weights (and so does the reference)
            with torch.no_grad():
                for p in model.decoder.parameters():
                    dist.broadcast(p, src=0)
        self.callbacks = callbacks or []
        self.log_fn = log_fn
        self.beta = float(args.get("beta", 0.1))
        self.state = TrainerState()
        self.control = TrainerControl()
        self._async_save = checkpoint.async_allowed(bool(args.get("async_save", True)),
                                                    self.mesh.nodes)
        self._saver = checkpoint.AsyncSaver()

        # the unit tokeniser carries bos / eos and __call__ itself (DPO
        # refuses the interleaving one, as the JAX CLI does)
        tok_kwargs = dict(processing_class=tokenizer,
                          max_prompt_length=args.get("max_prompt_length", None),
                          max_completion_length=args.get("max_completion_length", None),
                          add_special_tokens=False)
        self.train_rows = [tokenize_row(r, **tok_kwargs) for r in train_dataset]
        self.eval_rows = ([tokenize_row(r, **tok_kwargs) for r in eval_dataset]
                          if eval_dataset else None)
        all_rows = self.train_rows + (self.eval_rows or [])
        self.max_len = max(row_len(r) for r in all_rows)
        self.bucket_lens = self._bucket_lens(all_rows, int(args.get("length_buckets", 1) or 1),
                                             self.max_len)

        # the global batch, in pairs
        self.batch_size = int(args["per_device_train_batch_size"]) * self.mesh.shape["data"]
        epochs = float(args.get("num_train_epochs", 1))
        self.steps_per_epoch = max(len(self.train_rows) // self.batch_size, 1)
        max_steps = int(args.get("max_steps", -1) or -1)
        self.total_steps = (max_steps if max_steps > 0
                            else max(int(epochs * self.steps_per_epoch), 1))
        self.state.max_steps = self.total_steps
        # the frozen reference: the policy as built, before any step
        self.ref_decoder = copy.deepcopy(model.decoder).requires_grad_(False).eval()
        if args.get("fsdp", False):
            fsdp.shard_decoder(model.decoder, self.mesh)
            fsdp.shard_decoder(self.ref_decoder, self.mesh)
        self.sharded = fsdp.is_sharded(model.decoder)
        self.optimizer, self.schedule = make_optimizer(
            args, model.parameters(), self.total_steps,
            names=[n for n, _ in model.decoder.named_parameters()])
        self.dropout_stream = dropout_stream(model, args)

    # ------------------------------------------------------------------ #
    # batches
    # ------------------------------------------------------------------ #
    @staticmethod
    def _bucket_lens(rows, n_buckets: int, max_len: int) -> List[int]:
        """Ascending pad targets: the (i/K)-quantiles of the row lengths
        rounded up to a multiple of 8, topped by the corpus max."""
        if n_buckets <= 1:
            return [max_len]
        lens = sorted(row_len(r) for r in rows)
        qs = {lens[(len(lens) * (i + 1)) // n_buckets - 1] for i in range(n_buckets - 1)}
        return sorted({min(-8 * (-q // 8), max_len) for q in qs} | {max_len})

    def _collate(self, rows: List[dict]) -> Dict[str, np.ndarray]:
        return collate(rows, self.bucket_lens, self.model.config.pad_token_id)

    def _to_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(self.device,
                                                                       non_blocking=True)
                for k in BATCH_KEYS}

    def _local(self, batch: Dict[str, np.ndarray]):
        """(this rank's pairs of a global [2B, T] host batch on the device,
        their `parallel.Shard`). One rank: the batch itself and None."""
        if self.world == 1:
            return self._to_device(batch), None
        ids = batch["input_ids"]
        shard = self.mesh.pair_shard(ids.shape[0] // 2, ids.shape[1])
        return self._to_device({k: batch[k][shard.rows] for k in BATCH_KEYS}), shard

    def _all_reduce(self, values: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Each value summed over the ranks that hold different pairs (one
        all-reduce); one rank: as is."""
        if self.world == 1:
            return values
        flat = torch.stack([v.float() for v in values.values()])
        dist.all_reduce(flat, group=self.mesh.batch_group())
        return dict(zip(values, flat.unbind()))

    # ------------------------------------------------------------------ #
    # compute
    # ------------------------------------------------------------------ #
    def dpo_loss(self, batch: Dict[str, torch.Tensor], dropout_seed: Optional[int] = None,
                 shard=None):
        """(loss, metrics) of one device batch: the policy under autograd
        (with dropout when `dropout_seed` is given), the reference without
        either. Under a pair `shard` of a global batch, each is this rank's
        share of the global means."""
        lp = sequence_logps(self.model.decoder, batch, dropout_seed, shard)
        with torch.no_grad():
            ref_lp = sequence_logps(self.ref_decoder, batch, shard=shard)
        fsdp.reshard(self.ref_decoder)
        return dpo_objective(lp, ref_lp, self.beta,
                             None if shard is None else shard.batch // 2)

    def _train_step(self, rows: List[dict]) -> Dict[str, torch.Tensor]:
        batch, shard = self._local(self._collate(rows))
        loss, metrics = self.dpo_loss(batch, next_seed(self.dropout_stream), shard)
        loss.backward()
        if self.world > 1 and not self.sharded:
            all_reduce_grads(self.model.decoder, self.mesh.batch_group())
        self.optimizer.step()
        self.optimizer.zero_grad()
        return self._all_reduce({"loss": loss.detach(),
                                 **{k: v.detach() for k, v in metrics.items()}})

    @fsdp.inference_forward(lambda self: self.model.decoder)
    def evaluate(self) -> Dict[str, float]:
        if not self.eval_rows:
            return {}
        losses, accs = [], []
        rows = self.eval_rows
        # wrap round so that the tail fills the last batch
        rem = (-len(rows)) % self.batch_size
        if rem:
            rows = rows + rows[:rem] if rem <= len(rows) else \
                (rows * (-(-self.batch_size // len(rows))))[:self.batch_size]
        for start in range(0, len(rows) - self.batch_size + 1, self.batch_size):
            batch, shard = self._local(self._collate(rows[start:start + self.batch_size]))
            loss, metrics = self.dpo_loss(batch, shard=shard)
            got = self._all_reduce({"loss": loss, "acc": metrics["rewards/accuracies"]})
            losses.append(float(got["loss"]))
            accs.append(float(got["acc"]))
        out = {"eval_loss": float(np.mean(losses)) if losses else float("nan"),
               "eval_rewards/accuracies": float(np.mean(accs)) if accs else float("nan")}
        self._log({**out, "step": self.state.global_step})
        return out

    # ------------------------------------------------------------------ #
    # checkpointing
    # ------------------------------------------------------------------ #
    def save_checkpoint(self):
        """Rank 0 writes the checkpoint (in the background under async_save);
        on a mesh every rank then waits for it at a barrier. Sharded, every
        rank first helps gather the state to rank 0."""
        if self.mesh.rank == 0 or self.sharded:
            self._write_checkpoint()
        if self.world > 1:
            dist.barrier()

    def _write_checkpoint(self):
        path = os.path.abspath(checkpoint.ckpt_dir(self.args["output_dir"],
                                                   self.state.global_step))
        trainer_json = {"global_step": self.state.global_step, "epoch": self.state.epoch,
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
            logger.info("Saved DPO checkpoint %s", path)

        if self._async_save:
            self._saver.submit(write)
        else:
            write()

    def load_checkpoint(self, path: str):
        """The policy, the optimizer and the dropout stream from `path`; the
        reference stays."""
        self._saver.wait()   # never restore past an in-flight save
        checkpoint.restore(path, self.model, self.optimizer, self.dropout_stream)
        with open(os.path.join(path, "trainer_state.json")) as f:
            st = json.load(f)
        self.state.global_step = st["global_step"]
        self.state.epoch = st.get("epoch", 0.0)
        self.state.log_history = st.get("log_history", [])
        logger.info("Resumed DPO from %s at step %d", path, self.state.global_step)

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

    def train(self, resume_from_checkpoint=None):
        args, state, control = self.args, self.state, self.control
        if self.mesh.nodes > 1:
            multihost.check_shared_dir(args["output_dir"], self.mesh, self.device)
        if resume_from_checkpoint:
            path = multihost.agree_on_checkpoint(resume_from_checkpoint, args["output_dir"],
                                                 self.mesh, self.device)
            if path:
                self.load_checkpoint(path)
            else:
                logger.warning("No checkpoint found in %s: training from the start",
                               args["output_dir"])
        for cb in self.callbacks:
            cb.on_train_begin(args, state, control)
        logging_steps = int(args.get("logging_steps", 50) or 50)
        save_steps = int(args.get("save_steps", 0) or 0)
        # a step that slips past its multiple (an off-grid resume) saves at
        # the next step, not never
        save_due = (state.global_step // save_steps + 1) * save_steps if save_steps else 0
        rng = np.random.default_rng(int(args.get("seed", 0)))
        n_rows, bsz = len(self.train_rows), self.batch_size
        order_len = n_rows if n_rows >= bsz else -(-bsz // n_rows) * n_rows
        spe = max(order_len // bsz, 1)
        epoch = int(state.epoch)
        # replay the completed epochs' draws so a resume continues the stream
        for _ in range(epoch):
            rng.permutation(n_rows)
        first_skip = round((state.epoch - epoch) * spe)

        while state.global_step < self.total_steps and not control.should_training_stop:
            order = rng.permutation(n_rows)
            if n_rows < bsz:
                order = np.tile(order, order_len // n_rows)
            for b_idx, start in enumerate(range(0, len(order) - bsz + 1, bsz)):
                if b_idx < first_skip:
                    continue
                metrics = self._train_step([self.train_rows[i]
                                            for i in order[start:start + bsz]])
                state.global_step += 1
                state.epoch = epoch + (b_idx + 1) / spe
                if state.global_step % logging_steps == 0:
                    self._log({k: float(v) for k, v in metrics.items()} |
                              {"learning_rate": float(self.schedule(state.global_step)),
                               "step": state.global_step})
                for cb in self.callbacks:
                    cb.on_step_end(args, state, control)
                agree(control, self.world, self.device)
                if save_steps and state.global_step >= save_due:
                    save_due = (state.global_step // save_steps + 1) * save_steps
                    self.save_checkpoint()
                if control.should_training_stop or state.global_step >= self.total_steps:
                    break
            first_skip = 0
            epoch += 1

        self.evaluate()
        self.save_checkpoint()
        self._saver.wait()   # train() returns with the final save on disk
        if self.world > 1:
            dist.barrier()
        for cb in self.callbacks:
            cb.on_train_end(args, state, control)
        return state
