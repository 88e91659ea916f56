"""The port's SLAMTrainer on a mesh of gloo ranks on the CPU, against the
one-process run of the same global batch.

Two steps of accumulation 2 over 2 best-fit-packed rows at context 256 (512
under zigzag, whose half-chunks must be 128), with dropout 0.1, under DP [2], CP [1, 2] contiguous (full remat), CP [1, 2]
zigzag (remat qkv), DP x CP [2, 2] (full remat), and CP [1, 2] on the plain
attention with attention dropout 0.1 (k / v gathered; remat qkv). Each rank
process is started as torchrun starts it (`torch_mesh_workers.launch`).
The losses, the eval loss, the global gradient each optimizer step reads
(within 1e-5 of the tensor's largest entry) and every parameter equal the
one-process run of the same global batch within 1e-5 (float32: the
all-reduce and the ring sum in another order than one process). The
learning rate is the stock warmup's (1e-5 and 2e-5 in these two steps):
AdamW's early updates, lr g / (|g| + 1e-8), scale float32 noise of a
gradient entry near 1e-8 by lr / 1e-8, so at lr 1e-3 single entries of a
matrix move ~1e-5 apart however right the gradient is; the gradient check
holds the mesh itself. A second trainer resuming from step 1 repeats step 2
and the weights bit for bit. Finally the one-process run
equals the JAX trainer on the same global batch and weights (attn xla on
the JAX side) within 1e-4 relative, at dropout 0: the two packages draw
their masks from different generators (`tests/test_torch_dropout.py` holds
the masks themselves).
"""
import pathlib

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from slamkit_tpu.config import compose, to_container
from slamkit_tpu.data.dataset import TokenDataset as JaxTokenDataset
from slamkit_tpu.models.unit_lm import UnitLM as JaxUnitLM
from slamkit_tpu.models.unit_lm import UnitLMConfig as JaxUnitLMConfig
from slamkit_tpu.models.unit_lm import _flatten
from slamkit_tpu.trainer import SLAMTrainer as JaxSLAMTrainer
from slamkit_tpu_torch.data import TokenDataset
from slamkit_tpu_torch.models import UnitLM, UnitLMConfig, to_flat
from slamkit_tpu_torch.trainer import SLAMTrainer

import torch_mesh_workers

torch.set_num_threads(1)

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
GLOBAL_ROWS = 2
CONFIG = dict(base_model_name="Qwen/Qwen2.5-0.5B", vocab_size=502, twist_init=False,
              torch_dtype="float32", rope_theta=10000, dropout=0.1,
              config_overrides=dict(num_hidden_layers=2, hidden_size=64,
                                    num_attention_heads=4, num_key_value_heads=2,
                                    head_dim=16, intermediate_size=128))

# name: (ranks, 'data' size, context, mesh overrides, model overrides)
CASES = {
    "dp": (2, 2, 256, dict(mesh_shape="[2]"), {}),
    "cp_contiguous": (2, 1, 256, dict(mesh_shape="[1,2]", mesh_axes="[data,seq]"),
                      dict(remat=True)),
    "cp_zigzag": (2, 1, 512, dict(mesh_shape="[1,2]", mesh_axes="[data,seq]",
                                  cp_schedule="zigzag"),
                  dict(remat=True, remat_policy="qkv")),
    "dp_cp": (4, 2, 256, dict(mesh_shape="[2,2]", mesh_axes="[data,seq]"), dict(remat=True)),
    "cp_plain": (2, 1, 256, dict(mesh_shape="[1,2]", mesh_axes="[data,seq]"),
                 dict(attn_implementation="xla", attention_dropout=0.1, remat=True,
                      remat_policy="qkv")),
}


def seqs(n, seed, vocab=502):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, vocab, size=rng.integers(20, 200)).tolist() for _ in range(n)]


TRAIN, EVAL = seqs(60, 0), seqs(8, 1)


def _args_node(out, **overrides):
    ov = [f"training_args.output_dir={out}", "training_args.max_steps=2",
          "training_args.gradient_accumulation_steps=2", "training_args.logging_steps=1",
          "training_args.save_steps=1", "training_args.eval_strategy=steps",
          "training_args.eval_steps=2", "training_args.async_save=false",
          "data.train_path=/dev/null", "data.val_path=/dev/null"]
    ov += [f"training_args.{k}={v}" for k, v in overrides.items()]
    return compose(str(REPO_ROOT / "config"), "train", ov).training_args


def train_args(out, **overrides) -> dict:
    return to_container(_args_node(out, **overrides))


def one_process(out, model_over, context, params=None):
    """The one-process run of the global batch: its losses, eval losses,
    each step's gradients and its final parameters."""
    args = train_args(out, per_device_train_batch_size=GLOBAL_ROWS,
                      per_device_eval_batch_size=GLOBAL_ROWS)
    model = UnitLM(UnitLMConfig(**{**CONFIG, **model_over}), params=params, seed=0,
                   device="cpu")
    tr = SLAMTrainer(model, args, TokenDataset.from_lists(TRAIN),
                     eval_dataset=TokenDataset.from_lists(EVAL), packing=True,
                     context_len=context)
    grads = torch_mesh_workers.record_grads(tr)
    history = tr.train().log_history
    return ([r["loss"] for r in history if "loss" in r],
            [r["eval_loss"] for r in history if "eval_loss" in r],
            grads, to_flat(model.decoder))


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_equals_one_process_and_resumes_exactly(tmp_path, case):
    ranks, n_data, context, mesh_over, model_over = CASES[case]
    args = train_args(tmp_path / "mesh", per_device_train_batch_size=GLOBAL_ROWS // n_data,
                      per_device_eval_batch_size=GLOBAL_ROWS // n_data, **mesh_over)
    got = torch_mesh_workers.launch(
        "train", ranks, tmp_path / "ranks", config={**CONFIG, **model_over}, args=args,
        train_seqs=TRAIN, eval_seqs=EVAL, context_len=context)
    want_loss, want_eval, want_grads, want_params = one_process(tmp_path / "one", model_over,
                                                                context)
    assert len(want_loss) == 2 and len(want_eval) == 1 and len(want_grads) == 2
    for rank in got:
        np.testing.assert_allclose(rank["a/loss"], want_loss, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(rank["a/eval_loss"], want_eval, rtol=1e-5, atol=1e-5)
        for i, grads in enumerate(want_grads):
            for k, g in grads.items():
                np.testing.assert_allclose(rank[f"a/grad{i}/{k}"], g, rtol=0,
                                           atol=1e-5 * np.abs(g).max(), err_msg=f"{k} step {i}")
        for k, v in want_params.items():
            np.testing.assert_allclose(rank[f"a/param/{k}"], v, rtol=1e-5, atol=1e-5,
                                       err_msg=k)
        # the resumed run (its log carries step 1's record) repeats step 2
        # and its weights bit for bit
        assert list(rank["b/loss"]) == list(rank["a/loss"])
        for k in want_params:
            np.testing.assert_array_equal(rank[f"b/param/{k}"], rank[f"a/param/{k}"],
                                          err_msg=k)
        np.testing.assert_array_equal(rank["a/param/embed"], got[0]["a/param/embed"])


def test_one_process_equals_jax_trainer(tmp_path):
    """The reference the mesh runs are held to, against the JAX trainer on
    one device (attn xla), on the same weights and global batch, at dropout 0."""
    cfg = {**CONFIG, "dropout": 0.0}
    jax_model = JaxUnitLM(JaxUnitLMConfig(**{**cfg, "attn_implementation": "xla"}), seed=0)
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    jax_args = _args_node(tmp_path / "jax", per_device_train_batch_size=GLOBAL_ROWS,
                          per_device_eval_batch_size=GLOBAL_ROWS)
    flat = _flatten(jax_model.params)
    want = JaxSLAMTrainer(jax_model, jax_args, JaxTokenDataset.from_lists(TRAIN),
                          eval_dataset=JaxTokenDataset.from_lists(EVAL), packing=True,
                          context_len=256, mesh=mesh).train().log_history
    got_loss, got_eval, _, _ = one_process(tmp_path / "port", {"dropout": 0.0}, 256,
                                           params=flat)
    np.testing.assert_allclose(got_loss, [r["loss"] for r in want if "loss" in r], rtol=1e-4)
    np.testing.assert_allclose(got_eval, [r["eval_loss"] for r in want if "eval_loss" in r],
                               rtol=1e-4)
