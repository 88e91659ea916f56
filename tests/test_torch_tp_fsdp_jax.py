"""Tensor parallelism with fsdp on one ('data', 'model') mesh, on gloo ranks
on the CPU, against the JAX package (`slamkit_tpu/parallel/mesh.py`
`tp_shardings(fsdp=True)`, its trainers with `fsdp=true` on the suite's
CPU devices) from the same numpy weights, in float32.

  * The plan: `tp_fsdp_plan` gives every parameter the 'model' dim and the
    'data' dim that JAX `tp_shardings(fsdp=True)` gives its leaf on
    `make_mesh([4, 2])`, the stacked layer axis dropped (the decoders of
    `test_torch_tp_jax.py`, and a Qwen-shaped one of 4 layers). Where JAX
    puts 'data' on that layer axis (a TP-split bias at 4 layers: nothing
    else is free) the port's per-layer parameter has none, and the plan
    holds the port's rule: the largest other free dim that 'data' divides,
    else None (FSDP2 then pads dim 0; ROADMAP queue 3).
  * Training: the port's `SLAMTrainer` on TP + fsdp [2, 2] equals the JAX
    `SLAMTrainer` on [4, 2] with `fsdp=true` and the same global batch
    within rtol 2e-4, losses and eval losses, for AdamW and for Adafactor
    at 128 wide, with max_grad_norm 0.05 so that clipping fires on every
    step (dropout 0, JAX on its plain attention).
  * DPO on [2, 2] with `fsdp=true` (policy and reference sharded over each
    'model' coordinate's 'data' line, whole across 'model') equals one
    process within 1e-5 at dropout 0.1 (losses, reward metrics, gradients,
    parameters) and resumes bit for bit; at dropout 0 it equals the JAX
    `SLAMDPOTrainer` on [4, 2] with `fsdp=true` within rtol 2e-4.
"""
import jax
import numpy as np
import pytest
import torch

from slamkit_tpu.data.dataset import TokenDataset as JaxTokenDataset
from slamkit_tpu.models.unit_lm import UnitLM as JaxUnitLM
from slamkit_tpu.models.unit_lm import UnitLMConfig as JaxUnitLMConfig
from slamkit_tpu.models.unit_lm import _flatten
from slamkit_tpu.parallel.mesh import make_mesh as jax_make_mesh
from slamkit_tpu.parallel.mesh import tp_shardings
from slamkit_tpu.tokeniser.unit_tokeniser import UnitTokeniser as JaxUnitTokeniser
from slamkit_tpu.trainer import SLAMTrainer as JaxSLAMTrainer
from slamkit_tpu.trainer.slam_dpo_trainer import SLAMDPOTrainer as JaxSLAMDPOTrainer
from slamkit_tpu_torch.models import UnitLM, UnitLMConfig, to_flat
from slamkit_tpu_torch.parallel.fsdp import data_dim
from slamkit_tpu_torch.parallel.tensor import tp_fsdp_plan
from slamkit_tpu_torch.tokeniser import UnitTokeniser
from slamkit_tpu_torch.trainer import SLAMDPOTrainer

import torch_mesh_workers
from test_torch_fsdp_jax import (DPO_CONFIG, DPO_EVAL, DPO_TRAIN, GLOBAL_PAIRS, _dpo_args,
                                 _jax_args_node)
from test_torch_tp_jax import DECODERS, QWEN
from torch_fsdp_cases import (CONFIG, CONTEXT, EVAL, GLOBAL_ROWS, TRAIN, WIDE, save_params,
                              train_args)
from torch_mesh_workers import DPO_KEYS

torch.set_num_threads(1)

PLAN_DECODERS = {**DECODERS, "qwen_4_layers": {
    **QWEN, "config_overrides": {**QWEN["config_overrides"], "num_hidden_layers": 4}}}


def _axis_dim(spec, axis: str, stacked: bool):
    """The dim of a port parameter that a JAX spec puts `axis` on (the
    stacked layer axis dropped: -1 where `axis` is on it), or None."""
    dims = [i for i, a in enumerate(spec) if a == axis]
    return None if not dims else dims[0] - int(stacked)


@pytest.mark.parametrize("decoder", list(PLAN_DECODERS))
def test_tp_fsdp_plan_is_jax_tp_shardings_fsdp(decoder):
    cfg = PLAN_DECODERS[decoder]
    jax_model = JaxUnitLM(JaxUnitLMConfig(**{**cfg, "attn_implementation": "xla"}), seed=0)
    flat = _flatten(jax_model.params)
    tree = tp_shardings(jax_model.params, jax_make_mesh([4, 2]), fsdp=True)
    specs = {"/".join(p.key for p in path): sh.spec
             for path, sh in jax.tree_util.tree_flatten_with_path(tree)[0]}
    L = jax_model.decoder.num_layers
    shapes = {(f"layers.{i}.{k[7:]}" if k.startswith("layers/") else k):
              tuple(v.shape[1:] if k.startswith("layers/") else v.shape)
              for k, v in flat.items() for i in (range(L) if k.startswith("layers/") else [0])}
    plan = tp_fsdp_plan(shapes, 2, 4)
    parted = set()
    for name, (model, data) in plan.items():
        stacked = name.startswith("layers.")
        key = f"layers/{name.split('.', 2)[2]}" if stacked else name
        assert model == _axis_dim(specs[key], "model", stacked), name
        want = _axis_dim(specs[key], "data", stacked)
        if want == -1:   # JAX shards the layer axis the port does not have
            parted.add(key)
            assert data == data_dim(shapes[name], 4, skip=model), name
        else:
            assert data == want, name
    # the split parameters are both sharded somewhere; where the layer axis
    # takes 'data', it is on the TP-split biases alone
    assert any(m is not None and d is not None for m, d in plan.values())
    if decoder == "qwen_4_layers":
        assert parted == {"layers/q_b", "layers/k_b", "layers/v_b"}
        assert all(plan[f"layers.0.{k[7:]}"][1] is None for k in parted)
    else:
        assert not parted


@pytest.mark.parametrize("optim", ["adamw_torch", "adafactor"])
def test_tp_fsdp_losses_match_the_jax_trainer(tmp_path, optim):
    """The port on TP + fsdp [2, 2] and the JAX SLAMTrainer with mesh_shape
    [4, 2] and fsdp=true (attn xla), same weights and global batch,
    dropout 0, max_grad_norm 0.05; Adafactor at 128 wide."""
    cfg = {**CONFIG, "dropout": 0.0}
    if optim == "adafactor":
        cfg["config_overrides"] = WIDE
    extra = dict(optim=optim, max_grad_norm="0.05", fsdp="true")
    jax_model = JaxUnitLM(JaxUnitLMConfig(**{**cfg, "attn_implementation": "xla"}), seed=0)
    flat = _flatten(jax_model.params)
    jax_rows = GLOBAL_ROWS // 4
    want = JaxSLAMTrainer(jax_model, _jax_args_node(tmp_path / "jax", mesh_shape="[4,2]",
                                                    per_device_train_batch_size=jax_rows,
                                                    per_device_eval_batch_size=jax_rows,
                                                    **extra),
                          JaxTokenDataset.from_lists(TRAIN),
                          eval_dataset=JaxTokenDataset.from_lists(EVAL), packing=True,
                          context_len=CONTEXT).train().log_history
    rows = GLOBAL_ROWS // 2
    args = train_args(tmp_path / "mesh", mesh_shape="[2,2]", mesh_axes="[data,model]",
                      per_device_train_batch_size=rows, per_device_eval_batch_size=rows,
                      **extra)
    got = torch_mesh_workers.launch("train_runs", 4, tmp_path / "ranks", config=cfg,
                                    runs=[["tpf", args, None]], train_seqs=TRAIN,
                                    eval_seqs=EVAL, context_len=CONTEXT,
                                    params_path=save_params(tmp_path, flat))
    want_loss = [r["loss"] for r in want if "loss" in r]
    want_eval = [r["eval_loss"] for r in want if "eval_loss" in r]
    assert len(want_loss) == 2 and len(want_eval) == 2
    # clipping fires on both steps: the global norm of the gradients the
    # port's optimizer read (gathered whole) is above max_grad_norm
    for i in range(2):
        norm = np.sqrt(sum(float((v.astype(np.float64) ** 2).sum())
                           for k, v in got[0].items() if k.startswith(f"tpf/grad{i}/")))
        assert norm > 0.05
    for rank in got:
        np.testing.assert_allclose(rank["tpf/loss"], want_loss, rtol=2e-4)
        np.testing.assert_allclose(rank["tpf/eval_loss"], want_eval, rtol=2e-4)


def _dpo_mesh_args(out, **overrides):
    return _dpo_args(out, per_device_train_batch_size=GLOBAL_PAIRS // 2, mesh_shape="[2,2]",
                     mesh_axes="[data,model]", fsdp="true", **overrides)


def test_tp_mesh_fsdp_dpo_equals_one_process_and_resumes_exactly(tmp_path):
    got = torch_mesh_workers.launch("dpo", 4, tmp_path / "ranks", config=DPO_CONFIG,
                                    args=_dpo_mesh_args(tmp_path / "mesh"),
                                    train_rows=DPO_TRAIN, eval_rows=DPO_EVAL)
    model = UnitLM(UnitLMConfig(**DPO_CONFIG), seed=0, device="cpu")
    tr = SLAMDPOTrainer(model, UnitTokeniser(num_units=60),
                        _dpo_args(tmp_path / "one", per_device_train_batch_size=GLOBAL_PAIRS),
                        DPO_TRAIN, eval_dataset=DPO_EVAL)
    want_grads = torch_mesh_workers.record_grads(tr)
    history = tr.train().log_history
    want = {key: [r[key] for r in history if key in r] for key in DPO_KEYS}
    want_params = to_flat(model.decoder)
    for rank in got:
        for key in DPO_KEYS:
            np.testing.assert_allclose(rank[f"a/{key}"], want[key], rtol=1e-5, atol=1e-5,
                                       err_msg=key)
            np.testing.assert_array_equal(rank[f"b/{key}"], rank[f"a/{key}"], err_msg=key)
        for i, grads in enumerate(want_grads):
            for k, g in grads.items():
                np.testing.assert_allclose(rank[f"a/grad{i}/{k}"], g, rtol=0,
                                           atol=1e-5 * np.abs(g).max(), err_msg=f"{k} step {i}")
        for k, v in want_params.items():
            np.testing.assert_allclose(rank[f"a/param/{k}"], v, rtol=1e-5, atol=1e-5,
                                       err_msg=k)
            np.testing.assert_array_equal(rank[f"b/param/{k}"], rank[f"a/param/{k}"],
                                          err_msg=k)
            # the 'model' coordinates hold replicas
            np.testing.assert_array_equal(rank[f"a/param/{k}"], got[0][f"a/param/{k}"])


def test_tp_mesh_fsdp_dpo_matches_the_jax_trainer(tmp_path):
    cfg = {**DPO_CONFIG, "dropout": 0.0}
    jax_model = JaxUnitLM(JaxUnitLMConfig(**cfg), seed=0)
    flat = _flatten(jax_model.params)
    want = JaxSLAMDPOTrainer(
        jax_model, JaxUnitTokeniser(load_fe=False, num_units=60),
        _dpo_args(tmp_path / "jax", jax_side=True, fsdp="true",
                  per_device_train_batch_size=GLOBAL_PAIRS // 4),
        DPO_TRAIN, eval_dataset=DPO_EVAL, mesh=jax_make_mesh([4, 2])).train().log_history
    got = torch_mesh_workers.launch("dpo", 4, tmp_path / "ranks", config=cfg,
                                    args=_dpo_mesh_args(tmp_path / "mesh"),
                                    train_rows=DPO_TRAIN, eval_rows=DPO_EVAL,
                                    params_path=save_params(tmp_path, flat))
    for key in DPO_KEYS:
        want_key = [r[key] for r in want if key in r]
        assert len(want_key) == len(got[0][f"a/{key}"]) > 0, key
        np.testing.assert_allclose(got[0][f"a/{key}"], want_key, rtol=2e-4, atol=1e-6,
                                   err_msg=key)
