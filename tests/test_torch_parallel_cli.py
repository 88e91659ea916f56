"""`cli.train` and `cli.preference_alignment_train` under torchrun: two gloo
ranks on the CPU (`torchrun --standalone`, which picks a free port, so
parallel test files share none).

`cli.train` trains the Slam recipe's decoder at 2 layers, 64 wide, with
`training_args.mesh_shape=[1,2] mesh_axes=[data,seq] cp_schedule=zigzag`,
and its logged losses and eval loss equal the one-process `cli.train` run
of the same global batch within 1e-5 (float32; the ring and the all-reduce
sum in another order), its checkpoint written once, by rank 0.

Under `mesh_shape=[1,2] mesh_axes=[data,model]` `cli.train` splits the
decoder's weights over 'model' (tensor parallelism) and equals the
one-process run the same way; so does `mesh_shape=[2,2]` with
`training_args.fsdp=true` on 4 ranks (each slice also sharded over 'data'),
and `mesh_shape=[1,2,2] mesh_axes=[data,model,seq] cp_schedule=zigzag` on 4
ranks (the ring over 'seq' on each rank's heads).

`cli.preference_alignment_train` runs DPO on 'data' (`mesh_shape: null`, 2
pairs a rank) from a 2-layer pythia-14m-shaped checkpoint: its logged
losses, reward metrics and eval loss equal the one-process run of the same
4-pair global batch within 1e-5, and rank 0 alone writes its checkpoints.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np

from slamkit_tpu_torch.models import UnitLM, UnitLMConfig
from slamkit_tpu_torch.tools.slam_recipe import write_markov_corpus, write_preference_rows

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


def _env():
    return {**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
            "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}


def test_train_cli_under_torchrun_equals_one_process(tmp_path):
    tokens = tmp_path / "tokens.jsonl"
    write_markov_corpus(tokens, 40)
    env = _env()
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


def _dpo_overrides(d, out, per_device):
    return [f"model.pretrained_model={d / 'ckpt'}", "model.config_args.torch_dtype=float32",
            f"data.train_path={d / 'pref.jsonl'}", f"data.val_path={d / 'pref.jsonl'}",
            f"training_args.output_dir={out}", "training_args.max_steps=2",
            f"training_args.per_device_train_batch_size={per_device}",
            "training_args.logging_steps=1", "training_args.save_steps=1",
            "training_args.use_cpu=true"]


def test_dpo_cli_under_torchrun_equals_one_process(tmp_path):
    UnitLM(UnitLMConfig(base_model_name="EleutherAI/pythia-14m", vocab_size=502,
                        twist_init=False, torch_dtype="float32",
                        config_overrides=dict(num_hidden_layers=2)),
           seed=0, device="cpu").save_pretrained(str(tmp_path / "ckpt"))
    write_preference_rows(tmp_path / "pref.jsonl", 12, prompt_len=20, completion_len=10)
    cli = ["-m", "slamkit_tpu_torch.cli.preference_alignment_train"]
    runs = {
        "mesh": [sys.executable, "-m", "torch.distributed.run", "--standalone",
                 "--nproc_per_node", "2", *cli, *_dpo_overrides(tmp_path, tmp_path / "mesh", 2)],
        "one": [sys.executable, *cli, *_dpo_overrides(tmp_path, tmp_path / "one", 4)],
    }
    for name, cmd in runs.items():
        proc = subprocess.run(cmd, cwd=tmp_path, env=_env(), capture_output=True, text=True,
                              timeout=300)
        assert proc.returncode == 0, (name, proc.stderr[-4000:])
    got, want = _history(tmp_path / "mesh"), _history(tmp_path / "one")
    pick = lambda h, key: [r[key] for r in h if key in r]
    assert len(pick(want, "loss")) == 2 and len(pick(want, "eval_loss")) == 1
    for key in ("loss", "rewards/chosen", "rewards/rejected", "rewards/accuracies",
                "rewards/margins", "eval_loss", "eval_rewards/accuracies"):
        np.testing.assert_allclose(pick(got, key), pick(want, key), rtol=1e-5, atol=1e-5,
                                   err_msg=key)
    assert sorted(p.name for p in (tmp_path / "mesh").iterdir()) == ["checkpoint-1",
                                                                      "checkpoint-2"]


def _torchrun_and_one(tmp_path, cli, mesh_args, one_args, nproc=2):
    """Run `cli` under `torchrun --standalone --nproc_per_node nproc` and in
    one process."""
    runs = {"mesh": [sys.executable, "-m", "torch.distributed.run", "--standalone",
                     "--nproc_per_node", str(nproc), *cli, *mesh_args],
            "one": [sys.executable, *cli, *one_args]}
    for name, cmd in runs.items():
        proc = subprocess.run(cmd, cwd=tmp_path, env=_env(), capture_output=True, text=True,
                              timeout=300)
        assert proc.returncode == 0, (name, proc.stderr[-4000:])


def test_train_cli_fsdp_under_torchrun_equals_one_process(tmp_path):
    """`cli.train training_args.fsdp=true` on [2] (parameters, gradients and
    moments sharded) logs the one-process run's losses and eval loss of the
    same 4-row global batch within 1e-5, and its checkpoint-2 holds the
    one-process parameters in the one-rank layout."""
    tokens = tmp_path / "tokens.jsonl"
    write_markov_corpus(tokens, 40)
    cli = ["-m", "slamkit_tpu_torch.cli.train"]
    mesh = [*_overrides(tokens, tmp_path / "mesh"), "training_args.fsdp=true",
            "training_args.mesh_shape=[2]"]
    one = [*_overrides(tokens, tmp_path / "one"), "training_args.per_device_train_batch_size=4",
           "training_args.per_device_eval_batch_size=4"]
    _torchrun_and_one(tmp_path, cli, mesh, one)
    got, want = _history(tmp_path / "mesh"), _history(tmp_path / "one")
    pick = lambda h, key: [r[key] for r in h if key in r]
    assert len(pick(want, "loss")) == 2 and len(pick(want, "eval_loss")) == 1
    for key in ("loss", "eval_loss"):
        np.testing.assert_allclose(pick(got, key), pick(want, key), rtol=1e-5, atol=1e-5)
    with np.load(tmp_path / "mesh" / "checkpoint-2" / "params.npz") as a, \
            np.load(tmp_path / "one" / "checkpoint-2" / "params.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-5, err_msg=k)


def test_train_cli_tp_under_torchrun_equals_one_process(tmp_path):
    """`cli.train training_args.mesh_shape=[1,2] mesh_axes=[data,model]`
    (the decoder's weights split over 'model', the vocabulary too) logs the
    one-process run's losses and eval loss of the same global batch within
    1e-5, and its checkpoint-2, gathered over 'model', holds the one-process
    parameters in the one-rank layout."""
    tokens = tmp_path / "tokens.jsonl"
    write_markov_corpus(tokens, 40)
    cli = ["-m", "slamkit_tpu_torch.cli.train"]
    mesh = [*_overrides(tokens, tmp_path / "mesh"), "training_args.mesh_shape=[1,2]",
            "training_args.mesh_axes=[data,model]"]
    one = _overrides(tokens, tmp_path / "one")
    _torchrun_and_one(tmp_path, cli, mesh, one)
    got, want = _history(tmp_path / "mesh"), _history(tmp_path / "one")
    pick = lambda h, key: [r[key] for r in h if key in r]
    assert len(pick(want, "loss")) == 2 and len(pick(want, "eval_loss")) == 1
    for key in ("loss", "eval_loss"):
        np.testing.assert_allclose(pick(got, key), pick(want, key), rtol=1e-5, atol=1e-5)
    with np.load(tmp_path / "mesh" / "checkpoint-2" / "params.npz") as a, \
            np.load(tmp_path / "one" / "checkpoint-2" / "params.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            assert a[k].shape == b[k].shape, k
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-5, err_msg=k)


def test_train_cli_tp_fsdp_under_torchrun_equals_one_process(tmp_path):
    """`cli.train training_args.mesh_shape=[2,2] mesh_axes=[data,model]
    training_args.fsdp=true` on 4 ranks (the weights split over 'model',
    each slice sharded over 'data') logs the one-process run's losses and
    eval loss of the same 4-row global batch within 1e-5, and its
    checkpoint-2, gathered over both axes, holds the one-process parameters
    in the one-rank layout."""
    tokens = tmp_path / "tokens.jsonl"
    write_markov_corpus(tokens, 40)
    cli = ["-m", "slamkit_tpu_torch.cli.train"]
    mesh = [*_overrides(tokens, tmp_path / "mesh"), "training_args.mesh_shape=[2,2]",
            "training_args.mesh_axes=[data,model]", "training_args.fsdp=true"]
    one = [*_overrides(tokens, tmp_path / "one"), "training_args.per_device_train_batch_size=4",
           "training_args.per_device_eval_batch_size=4"]
    _torchrun_and_one(tmp_path, cli, mesh, one, nproc=4)
    got, want = _history(tmp_path / "mesh"), _history(tmp_path / "one")
    pick = lambda h, key: [r[key] for r in h if key in r]
    assert len(pick(want, "loss")) == 2 and len(pick(want, "eval_loss")) == 1
    for key in ("loss", "eval_loss"):
        np.testing.assert_allclose(pick(got, key), pick(want, key), rtol=1e-5, atol=1e-5)
    with np.load(tmp_path / "mesh" / "checkpoint-2" / "params.npz") as a, \
            np.load(tmp_path / "one" / "checkpoint-2" / "params.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            assert a[k].shape == b[k].shape, k
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-5, err_msg=k)


def test_train_cli_tp_seq_under_torchrun_equals_one_process(tmp_path):
    """`cli.train training_args.mesh_shape=[1,2,2]
    mesh_axes=[data,model,seq] cp_schedule=zigzag` on 4 ranks (each
    layer's heads split over 'model', the zigzag ring over 'seq' on the
    rank's heads) logs the one-process run's losses and eval loss within
    1e-5, and its checkpoint-2, gathered over 'model', holds the one-process
    parameters in the one-rank layout."""
    tokens = tmp_path / "tokens.jsonl"
    write_markov_corpus(tokens, 40)
    cli = ["-m", "slamkit_tpu_torch.cli.train"]
    mesh = [*_overrides(tokens, tmp_path / "mesh"), "training_args.mesh_shape=[1,2,2]",
            "training_args.mesh_axes=[data,model,seq]", "training_args.cp_schedule=zigzag"]
    _torchrun_and_one(tmp_path, cli, mesh, _overrides(tokens, tmp_path / "one"), nproc=4)
    got, want = _history(tmp_path / "mesh"), _history(tmp_path / "one")
    pick = lambda h, key: [r[key] for r in h if key in r]
    assert len(pick(want, "loss")) == 2 and len(pick(want, "eval_loss")) == 1
    for key in ("loss", "eval_loss"):
        np.testing.assert_allclose(pick(got, key), pick(want, key), rtol=1e-5, atol=1e-5)
    assert pick(got, "num_input_tokens_seen") == pick(want, "num_input_tokens_seen")
    with np.load(tmp_path / "mesh" / "checkpoint-2" / "params.npz") as a, \
            np.load(tmp_path / "one" / "checkpoint-2" / "params.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            assert a[k].shape == b[k].shape, k
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-5, err_msg=k)


def test_dpo_cli_fsdp_under_torchrun_equals_one_process(tmp_path):
    """`cli.preference_alignment_train training_args.fsdp=true` on 'data'
    (policy and reference sharded, 2 pairs a rank) logs the one-process
    run's losses, reward metrics and eval loss within 1e-5."""
    UnitLM(UnitLMConfig(base_model_name="EleutherAI/pythia-14m", vocab_size=502,
                        twist_init=False, torch_dtype="float32",
                        config_overrides=dict(num_hidden_layers=2)),
           seed=0, device="cpu").save_pretrained(str(tmp_path / "ckpt"))
    write_preference_rows(tmp_path / "pref.jsonl", 12, prompt_len=20, completion_len=10)
    cli = ["-m", "slamkit_tpu_torch.cli.preference_alignment_train"]
    _torchrun_and_one(tmp_path, cli,
                      [*_dpo_overrides(tmp_path, tmp_path / "mesh", 2), "training_args.fsdp=true"],
                      _dpo_overrides(tmp_path, tmp_path / "one", 4))
    got, want = _history(tmp_path / "mesh"), _history(tmp_path / "one")
    pick = lambda h, key: [r[key] for r in h if key in r]
    assert len(pick(want, "loss")) == 2 and len(pick(want, "eval_loss")) == 1
    for key in ("loss", "rewards/chosen", "rewards/rejected", "rewards/accuracies",
                "rewards/margins", "eval_loss", "eval_rewards/accuracies"):
        np.testing.assert_allclose(pick(got, key), pick(want, key), rtol=1e-5, atol=1e-5,
                                   err_msg=key)
