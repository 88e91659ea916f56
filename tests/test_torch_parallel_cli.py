"""`cli.train` under torchrun: two gloo ranks on the CPU (`torchrun
--standalone`, which picks a free port, so parallel test files share none)
train the Slam recipe's decoder at 2 layers, 64 wide, with
`training_args.mesh_shape=[1,2] mesh_axes=[data,seq] cp_schedule=zigzag`,
and their logged losses and eval loss equal the one-process `cli.train` run
of the same global batch within 1e-5 (float32; the ring and the all-reduce
sum in another order), its checkpoint written once, by rank 0.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np

from slamkit_tpu_torch.tools.slam_recipe import write_markov_corpus

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _overrides(tokens, out):
    return ["model=slam", "model.context_len=512", "model.config_args.torch_dtype=float32",
            "+model.config_args.num_hidden_layers=2", "+model.config_args.hidden_size=64",
            "+model.config_args.intermediate_size=128", "+model.config_args.num_attention_heads=4",
            "+model.config_args.num_key_value_heads=2", "+model.config_args.head_dim=16",
            f"data.train_path={tokens}", f"data.val_path={tokens}", "data.packing=true",
            f"training_args.output_dir={out}",
            "training_args.max_steps=2", "training_args.per_device_train_batch_size=2",
            "training_args.per_device_eval_batch_size=2", "training_args.eval_steps=2",
            "training_args.logging_steps=1", "training_args.use_cpu=true"]


def _history(out):
    return json.loads((out / "checkpoint-2" / "trainer_state.json").read_text())["log_history"]


def test_train_cli_under_torchrun_equals_one_process(tmp_path):
    tokens = tmp_path / "tokens.jsonl"
    write_markov_corpus(tokens, 40)
    env = {**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
           "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}
    cli = ["-m", "slamkit_tpu_torch.cli.train"]
    mesh = ["training_args.mesh_shape=[1,2]", "training_args.mesh_axes=[data,seq]",
            "training_args.cp_schedule=zigzag"]
    runs = {
        "mesh": [sys.executable, "-m", "torch.distributed.run", "--standalone",
                 "--nproc_per_node", "2", *cli, *_overrides(tokens, tmp_path / "mesh"), *mesh],
        "one": [sys.executable, *cli, *_overrides(tokens, tmp_path / "one")],
    }
    for name, cmd in runs.items():
        proc = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True, text=True,
                              timeout=300)
        assert proc.returncode == 0, (name, proc.stderr[-4000:])
    got, want = _history(tmp_path / "mesh"), _history(tmp_path / "one")
    pick = lambda h, key: [r[key] for r in h if key in r]
    assert len(pick(want, "loss")) == 2 and len(pick(want, "eval_loss")) == 1
    for key in ("loss", "eval_loss"):
        np.testing.assert_allclose(pick(got, key), pick(want, key), rtol=1e-5, atol=1e-5)
    assert pick(got, "num_input_tokens_seen") == pick(want, "num_input_tokens_seen")
    assert sorted(p.name for p in (tmp_path / "mesh").iterdir()) == ["checkpoint-2"]
