"""The Slam pretraining recipe as `chip_smoke.py` and `profile_train` drive it.

  * `slam_config()` — config/model/slam.yaml at full width, random init;
  * `slam_training_args(output_dir, **overrides)` — the training args of
    config/training_args/default.yaml + pretrain_training_args.yaml with the
    Slam recipe, cut to a 4-step schedule;
  * `write_markov_corpus(path, n_rows)` — a seeded synthetic tokens.jsonl;
  * `write_preference_rows(path, n_rows)` — a seeded synthetic preference
    jsonl for DPO;
  * `nvidia_smi()` — the card's name and power limit, to print beside every
    measurement.
"""
from __future__ import annotations

import json
import pathlib
import subprocess

import numpy as np


def slam_config():
    """config/model/slam.yaml at full width, random init (twist_init=false)."""
    from ..models import UnitLMConfig

    return UnitLMConfig(base_model_name="Qwen/Qwen2.5-0.5B", vocab_size=502,
                        twist_init=False, rope_theta=10000, torch_dtype="bfloat16")


def slam_training_args(output_dir: str, **overrides) -> dict:
    """config/training_args/default.yaml + pretrain_training_args.yaml with the
    Slam recipe (docs/SLAM.md, bench.py:119-161): B=8 x accumulation 16,
    cosine_with_min_lr to 5e-5 from 1e-3, clip 0.5, bf16 AdamW moments; a
    2-step warmup and a 4-step schedule."""
    args = {"output_dir": output_dir, "eval_strategy": "no", "eval_steps": 1000,
            "warmup_steps": 2, "warmup_ratio": 0.0,
            "lr_scheduler_type": "cosine_with_min_lr", "learning_rate": 1e-3,
            "lr_scheduler_kwargs": {"min_lr": 5e-5}, "max_grad_norm": 0.5,
            "num_train_epochs": 1, "per_device_train_batch_size": 8,
            "per_device_eval_batch_size": 8, "gradient_accumulation_steps": 16,
            "save_total_limit": 2, "optim": "adamw_torch", "logging_steps": 1,
            "save_steps": 3, "max_steps": 4, "seed": 0, "fsdp": False,
            "mesh_shape": None, "mesh_axes": None, "cp_schedule": "contiguous",
            "optim_state_dtype": "bfloat16", "profile_steps": 0, "multihost": False,
            "async_save": True, "min_token_id_count": None, "max_token_id_count": None}
    args.update(overrides)
    return args


def write_markov_corpus(path: pathlib.Path, n_rows: int, lengths=(100, 1001),
                        seed: int = 0, n_units: int = 500):
    """A tokens.jsonl of low-entropy unit strings, as scripts/demo_markov.py
    builds them: a first-order Markov chain in which every unit has 4
    successors (entropy floor ln 4 = 1.386 nats a unit)."""
    rng = np.random.default_rng(seed)
    nxt = np.stack([rng.choice(n_units, 4, replace=False) for _ in range(n_units)])
    lens = rng.integers(*lengths, n_rows)
    units = np.empty((n_rows, int(lens.max())), np.int64)
    units[:, 0] = rng.integers(0, n_units, n_rows)
    picks = rng.integers(0, 4, units.shape)
    for i in range(1, units.shape[1]):
        units[:, i] = nxt[units[:, i - 1], picks[:, i]]
    with open(path, "w") as f:
        for r in range(n_rows):
            f.write(json.dumps({"file_name": f"m{r}", "audio_repr": "".join(
                f"<Un{u}>" for u in units[r, :lens[r]])}) + "\n")


def write_preference_rows(path: pathlib.Path, n_rows: int, prompt_len: int = 100,
                          completion_len: int = 50, seed: int = 0, n_units: int = 500):
    """A preference jsonl as scripts/rehearse_dpo.py::gen_rows builds it: the
    chosen completion continues the prompt through a first-order Markov chain
    (4 successors a unit), the rejected one is uniform random units; unit
    dicts as the preference extractor writes them, and prompt_text /
    chosen_text of distinct words, which the default repetition filter
    keeps."""
    rng = np.random.default_rng(seed)
    succ = rng.integers(0, n_units, size=(n_units, 4))
    with open(path, "w") as f:
        for _ in range(n_rows):
            s = int(rng.integers(0, n_units))
            seq = [s]
            for _ in range(prompt_len + completion_len - 1):
                s = int(succ[s, rng.integers(0, 4)])
                seq.append(s)
            parts = {"prompt": seq[:prompt_len], "chosen": seq[prompt_len:],
                     "rejected": rng.integers(0, n_units, completion_len).tolist()}
            row = {k: {"units": v, "duration": [1] * len(v)} for k, v in parts.items()}
            words = rng.choice(100000, 16, replace=False)
            row.update(prompt_text=" ".join(f"w{w}" for w in words[:8]),
                       chosen_text=" ".join(f"w{w}" for w in words[8:]))
            f.write(json.dumps(row) + "\n")


def nvidia_smi() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
