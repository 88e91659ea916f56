"""The port's SLAMDPOTrainer on the 'data' axis of gloo ranks on the CPU,
against the one-process run of the same global batch.

Two steps of 4 preference pairs a global batch (DP [2]: 2 pairs a rank, DP
[4]: 1), dropout 0.1 and `length_buckets` 2, then the final evaluation over
6 rows wrapped round to two batches; each rank process is started as
torchrun starts it (`torch_mesh_workers.launch`). A rank holds its pairs'
chosen and rejected rows, draws the policy's dropout masks at the global
[2B, T] shape and keeps its rows, and its loss is its share of the global
mean, so after the one all-reduce of the gradients every rank steps with
the one-process gradient. The logged loss and the four reward metrics, the
evaluation's loss and accuracy, the global gradient each optimizer step
reads (within 1e-5 of the tensor's largest entry) and every parameter equal
the one-process run within 1e-5 (float32: the all-reduce sums in another
order than one process). A second trainer resuming from step 1 repeats
step 2 and the weights bit for bit. The one-process run equals the JAX
SLAMDPOTrainer on a 2-device CPU mesh on the same weights and global batch
within 1e-4 relative at dropout 0 (the two packages draw their masks from
different generators; `tests/test_torch_dropout.py` holds the masks). A
'seq' axis raises the JAX trainer's message.
"""
import pathlib

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from slamkit_tpu.config import compose, to_container
from slamkit_tpu.models.unit_lm import UnitLM as JaxUnitLM
from slamkit_tpu.models.unit_lm import UnitLMConfig as JaxUnitLMConfig
from slamkit_tpu.models.unit_lm import _flatten
from slamkit_tpu.tokeniser.unit_tokeniser import UnitTokeniser as JaxUnitTokeniser
from slamkit_tpu.trainer.slam_dpo_trainer import SLAMDPOTrainer as JaxSLAMDPOTrainer
from slamkit_tpu_torch.models import UnitLM, UnitLMConfig, to_flat
from slamkit_tpu_torch.parallel import Mesh
from slamkit_tpu_torch.tokeniser import UnitTokeniser
from slamkit_tpu_torch.trainer import SLAMDPOTrainer

import torch_mesh_workers
from torch_mesh_workers import DPO_KEYS

torch.set_num_threads(1)

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
GLOBAL_PAIRS = 4
CONFIG = dict(base_model_name="EleutherAI/pythia-14m", vocab_size=64, twist_init=False,
              torch_dtype="float32", dropout=0.1,
              config_overrides=dict(num_hidden_layers=2))


def unit_str(ids):
    return "".join(f"<Un{i}>" for i in ids)


def pref_rows(n, seed):
    """Preference rows over 60 units with ragged prompts and completions."""
    rng = np.random.default_rng(seed)
    return [{k: unit_str(rng.integers(0, 60, int(rng.integers(lo, hi))))
             for k, (lo, hi) in (("prompt", (3, 30)), ("chosen", (2, 20)),
                                 ("rejected", (2, 20)))} for _ in range(n)]


TRAIN, EVAL = pref_rows(16, seed=0), pref_rows(6, seed=1)


def _args_node(out, jax_side=False, **overrides):
    ov = [f"training_args.output_dir={out}", "training_args.max_steps=2",
          "training_args.logging_steps=1", "training_args.save_steps=1",
          "training_args.async_save=false", "training_args.length_buckets=2",
          "data.train_path=/dev/null", "data.val_path=/dev/null"]
    ov += [f"training_args.{k}={v}" for k, v in overrides.items()]
    node = compose(str(REPO_ROOT / "config"), "preference_alignment_train", ov).training_args
    return node if jax_side else to_container(node)


def one_process(out, config, params=None):
    """The one-process run of the global batch: its logged `DPO_KEYS`, each
    step's gradients and its final parameters."""
    model = UnitLM(UnitLMConfig(**config), params=params, seed=0, device="cpu")
    tr = SLAMDPOTrainer(model, UnitTokeniser(num_units=60),
                        _args_node(out, per_device_train_batch_size=GLOBAL_PAIRS), TRAIN,
                        eval_dataset=EVAL)
    grads = torch_mesh_workers.record_grads(tr)
    history = tr.train().log_history
    return ({key: [r[key] for r in history if key in r] for key in DPO_KEYS}, grads,
            to_flat(model.decoder))


@pytest.mark.parametrize("ranks", [2, 4])
def test_data_mesh_equals_one_process_and_resumes_exactly(tmp_path, ranks):
    args = _args_node(tmp_path / "mesh", per_device_train_batch_size=GLOBAL_PAIRS // ranks,
                      mesh_shape=f"[{ranks}]")
    got = torch_mesh_workers.launch("dpo", ranks, tmp_path / "ranks", config=CONFIG,
                                    args=args, train_rows=TRAIN, eval_rows=EVAL)
    want, want_grads, want_params = one_process(tmp_path / "one", CONFIG)
    assert [len(want[k]) for k in DPO_KEYS] == [2] * 5 + [1] * 2 and len(want_grads) == 2
    for rank in got:
        for key in DPO_KEYS:
            np.testing.assert_allclose(rank[f"a/{key}"], want[key], rtol=1e-5, atol=1e-5,
                                       err_msg=key)
        for i, grads in enumerate(want_grads):
            for k, g in grads.items():
                np.testing.assert_allclose(rank[f"a/grad{i}/{k}"], g, rtol=0,
                                           atol=1e-5 * np.abs(g).max(), err_msg=f"{k} step {i}")
        for k, v in want_params.items():
            np.testing.assert_allclose(rank[f"a/param/{k}"], v, rtol=1e-5, atol=1e-5,
                                       err_msg=k)
        # the resumed run (its log carries step 1's record) repeats step 2,
        # the evaluation and the weights bit for bit
        for key in DPO_KEYS:
            np.testing.assert_array_equal(rank[f"b/{key}"], rank[f"a/{key}"], err_msg=key)
        for k in want_params:
            np.testing.assert_array_equal(rank[f"b/param/{k}"], rank[f"a/param/{k}"],
                                          err_msg=k)
            np.testing.assert_array_equal(rank[f"a/param/{k}"], got[0][f"a/param/{k}"])


def test_one_process_equals_jax_trainer_on_two_devices(tmp_path):
    """The reference the mesh runs are held to, against the JAX trainer on a
    2-device CPU mesh (2 pairs a device), on the same weights and global
    batch, at dropout 0."""
    cfg = {**CONFIG, "dropout": 0.0}
    jax_model = JaxUnitLM(JaxUnitLMConfig(**cfg), seed=0)
    flat = _flatten(jax_model.params)
    mesh = JaxMesh(np.array(jax.devices()[:2]), ("data",))
    want = JaxSLAMDPOTrainer(
        jax_model, JaxUnitTokeniser(load_fe=False, num_units=60),
        _args_node(tmp_path / "jax", jax_side=True,
                   per_device_train_batch_size=GLOBAL_PAIRS // 2),
        TRAIN, eval_dataset=EVAL, mesh=mesh).train().log_history
    got, _, _ = one_process(tmp_path / "port", cfg, params=flat)
    for key in DPO_KEYS:
        np.testing.assert_allclose(got[key], [r[key] for r in want if key in r], rtol=1e-4,
                                   atol=1e-6, err_msg=key)


def test_seq_axis_raises_the_jax_message(tmp_path):
    """DPO takes no 'seq' axis, in either package's words."""
    model = UnitLM(UnitLMConfig(**CONFIG), seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match=r"context parallelism \('seq' mesh axis\) "
                                                  r"is a pretrain-trainer feature"):
        SLAMDPOTrainer(model, UnitTokeniser(num_units=60), _args_node(tmp_path), TRAIN,
                       mesh=Mesh(("data", "seq"), (1, 2)))


def test_pair_shard_keeps_each_pair_on_one_rank():
    """A rank's rows of a [2B, T] batch: its pairs' chosen rows, then the same
    pairs' rejected rows; the tiles of all ranks cover every row once."""
    rows = [Mesh(("data",), (4,), rank=r).pair_shard(8, 5).rows for r in range(4)]
    assert rows[1].tolist() == [2, 3, 10, 11]
    assert sorted(np.concatenate(rows).tolist()) == list(range(16))
    shard = Mesh(("data",), (4,), rank=3).pair_shard(8, 5)
    full = torch.arange(16 * 5).view(16, 5)
    assert torch.equal(shard.tile(full), full[[6, 7, 14, 15]])
    with pytest.raises(ValueError, match="do not divide"):
        Mesh(("data",), (4,), rank=0).pair_shard(6, 5)
