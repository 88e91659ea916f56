"""What the fsdp tests share (`test_torch_fsdp.py`, `test_torch_fsdp_jax.py`):
the tiny decoders, the corpora, the training arguments and the one-process
reference run."""
import pathlib

import numpy as np

from slamkit_tpu_torch.config import compose, to_container
from slamkit_tpu_torch.data import TokenDataset
from slamkit_tpu_torch.models import UnitLM, UnitLMConfig, to_flat
from slamkit_tpu_torch.trainer import SLAMTrainer

import torch_mesh_workers

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
GLOBAL_ROWS, CONTEXT = 4, 256
NARROW = dict(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
              num_key_value_heads=2, head_dim=16, intermediate_size=128)
# two axes of >= 128: Adafactor factors q_w [128, 128] (sharded on its
# second-largest axis, dim 0) and up_w [128, 256] (on its largest, dim 1)
WIDE = dict(NARROW, hidden_size=128, head_dim=32, intermediate_size=256)
CONFIG = dict(base_model_name="Qwen/Qwen2.5-0.5B", vocab_size=502, twist_init=False,
              torch_dtype="float32", rope_theta=10000, dropout=0.1, config_overrides=NARROW)


def seqs(n, seed, vocab=502):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, vocab, size=rng.integers(20, 200)).tolist() for _ in range(n)]


TRAIN, EVAL = seqs(60, 0), seqs(8, 1)


def args_node(out, **overrides):
    ov = [f"training_args.output_dir={out}", "training_args.max_steps=2",
          "training_args.gradient_accumulation_steps=2", "training_args.logging_steps=1",
          "training_args.save_steps=1", "training_args.eval_strategy=steps",
          "training_args.eval_steps=1", "training_args.async_save=false",
          "data.train_path=/dev/null", "data.val_path=/dev/null"]
    ov += [f"training_args.{k}={v}" for k, v in overrides.items()]
    return compose(str(REPO_ROOT / "config"), "train", ov).training_args


def train_args(out, **overrides) -> dict:
    return to_container(args_node(out, **overrides))


def one_process(out, config, params=None, resume=False, train=TRAIN, evals=EVAL,
                context=CONTEXT, **overrides):
    """The one-process run of the global batch: its losses, eval losses,
    each step's gradients and its final parameters (resumed from `resume`,
    a checkpoint, when given; `train` / `evals`: the corpora; `context`:
    the packed rows' length)."""
    args = train_args(out, per_device_train_batch_size=GLOBAL_ROWS,
                      per_device_eval_batch_size=GLOBAL_ROWS, **overrides)
    model = UnitLM(UnitLMConfig(**config), params=params, seed=0, device="cpu")
    tr = SLAMTrainer(model, args, TokenDataset.from_lists(train),
                     eval_dataset=TokenDataset.from_lists(evals), packing=True,
                     context_len=context)
    grads = torch_mesh_workers.record_grads(tr)
    history = tr.train(resume_from_checkpoint=resume).log_history
    return ([r["loss"] for r in history if "loss" in r],
            [r["eval_loss"] for r in history if "eval_loss" in r],
            grads, to_flat(model.decoder))


def save_params(tmp_path, flat) -> str:
    path = tmp_path / "params.npz"
    np.savez(path, **flat)
    return str(path)


