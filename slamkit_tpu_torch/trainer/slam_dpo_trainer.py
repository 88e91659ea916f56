"""SLAMDPOTrainer: Direct Preference Optimization on one device.

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

The attention of every forward (policy, reference, evaluation) goes through
`ops.flash_attention`, and the policy's backward through the flash backward.
The loop runs synchronously on the model's device. Knobs of the JAX trainer
that the port does not implement (fsdp, a multi-device mesh, a 'seq' axis,
multihost) raise, and a model with dropout is refused by the decoder.
"""
from __future__ import annotations

import copy
import json
import logging
import os
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.calculation_utils import token_nll
from . import checkpoint
from .callbacks import TrainerCallback, TrainerControl, TrainerState
from .optim import make_optimizer
from .slam_trainer import _refuse_unported

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


def sequence_logps(decoder, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """[2B] float32: each row's summed log-probability of its completion
    tokens (the targets under `completion_mask`)."""
    logits, _ = decoder(batch["input_ids"], segment_ids=batch["segment_ids"])
    lp = -token_nll(logits[:, :-1], batch["input_ids"][:, 1:])
    return (lp * batch["completion_mask"][:, 1:]).sum(-1)


def dpo_objective(lp: torch.Tensor, ref_lp: torch.Tensor, beta: float):
    """(loss, metrics) from the policy's and the reference's [2B] completion
    log-probabilities, chosen rows first."""
    b = lp.shape[0] // 2
    logits = beta * ((lp[:b] - lp[b:]) - (ref_lp[:b] - ref_lp[b:]))
    loss = -F.logsigmoid(logits).mean()
    metrics = {
        "rewards/chosen": (beta * (lp[:b] - ref_lp[:b])).mean(),
        "rewards/rejected": (beta * (lp[b:] - ref_lp[b:])).mean(),
        "rewards/accuracies": (logits > 0).float().mean(),
        "rewards/margins": logits.mean(),
    }
    return loss, metrics


class SLAMDPOTrainer:
    def __init__(self, model, tokenizer, args, train_dataset: List[dict],
                 eval_dataset: Optional[List[dict]] = None,
                 callbacks: Optional[List[TrainerCallback]] = None, log_fn=None):
        _refuse_unported(args)
        self.model = model
        self.args = args
        self.device = model.device
        self.callbacks = callbacks or []
        self.log_fn = log_fn
        self.beta = float(args.get("beta", 0.1))
        self.state = TrainerState()
        self.control = TrainerControl()
        self._async_save = bool(args.get("async_save", True))
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

        self.batch_size = int(args["per_device_train_batch_size"])
        epochs = float(args.get("num_train_epochs", 1))
        self.steps_per_epoch = max(len(self.train_rows) // self.batch_size, 1)
        max_steps = int(args.get("max_steps", -1) or -1)
        self.total_steps = (max_steps if max_steps > 0
                            else max(int(epochs * self.steps_per_epoch), 1))
        self.state.max_steps = self.total_steps
        self.optimizer, self.schedule = make_optimizer(args, model.parameters(),
                                                       self.total_steps)
        # the frozen reference: the policy as built, before any step
        self.ref_decoder = copy.deepcopy(model.decoder).requires_grad_(False).eval()

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
        return {k: torch.from_numpy(batch[k]).to(self.device, non_blocking=True)
                for k in BATCH_KEYS}

    # ------------------------------------------------------------------ #
    # compute
    # ------------------------------------------------------------------ #
    def dpo_loss(self, batch: Dict[str, torch.Tensor]):
        """(loss, metrics) of one device batch: the policy under autograd,
        the reference without."""
        lp = sequence_logps(self.model.decoder, batch)
        with torch.no_grad():
            ref_lp = sequence_logps(self.ref_decoder, batch)
        return dpo_objective(lp, ref_lp, self.beta)

    def _train_step(self, rows: List[dict]) -> Dict[str, torch.Tensor]:
        loss, metrics = self.dpo_loss(self._to_device(self._collate(rows)))
        loss.backward()
        self.optimizer.step()
        self.optimizer.zero_grad()
        return {"loss": loss.detach(), **{k: v.detach() for k, v in metrics.items()}}

    @torch.inference_mode()
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
            loss, metrics = self.dpo_loss(
                self._to_device(self._collate(rows[start:start + self.batch_size])))
            losses.append(float(loss))
            accs.append(float(metrics["rewards/accuracies"]))
        out = {"eval_loss": float(np.mean(losses)) if losses else float("nan"),
               "eval_rewards/accuracies": float(np.mean(accs)) if accs else float("nan")}
        self._log({**out, "step": self.state.global_step})
        return out

    # ------------------------------------------------------------------ #
    # checkpointing
    # ------------------------------------------------------------------ #
    def save_checkpoint(self):
        path = os.path.abspath(checkpoint.ckpt_dir(self.args["output_dir"],
                                                   self.state.global_step))
        trainer_json = {"global_step": self.state.global_step, "epoch": self.state.epoch,
                        "log_history": self.state.log_history[-50:]}
        self._saver.wait()
        state = checkpoint.train_state(self.model, self.optimizer)
        if self._async_save:
            state = checkpoint.snapshot(state)
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
        """The policy and the optimizer from `path`; the reference stays."""
        self._saver.wait()   # never restore past an in-flight save
        checkpoint.restore(path, self.model, self.optimizer)
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
        logger.info("%s", record)
        if self.log_fn is not None:
            self.log_fn(record)

    def train(self, resume_from_checkpoint=None):
        args, state, control = self.args, self.state, self.control
        if resume_from_checkpoint:
            path = (resume_from_checkpoint if isinstance(resume_from_checkpoint, str)
                    else checkpoint.latest_checkpoint(args["output_dir"]))
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
        for cb in self.callbacks:
            cb.on_train_end(args, state, control)
        return state
