"""Tensor parallelism over 'model' with fsdp over 'data' on one mesh
(`parallel/tensor.py`, `parallel/fsdp.py`) on 4 gloo ranks on the CPU,
against the port's one process and its own TP [2, 2] without fsdp.

  * Training: `SLAMTrainer` on ('data', 'model') [2, 2] with
    `training_args.fsdp=true` equals the one-process run of the same 4-row
    global batch within the tolerances of `test_torch_fsdp.py` (losses and
    eval losses 1e-5, the global gradient each optimizer step reads,
    gathered over both axes, within 1e-5 of its largest entry, every
    parameter 1e-5) and TP [2, 2] without fsdp within 1e-5, for AdamW with
    dropout 0.1 and full remat and for Adafactor at 128 wide with
    max_grad_norm 0.05; each rank holds the part of every parameter that
    `tp_fsdp_plan` names ('model' slice, then 'data' shard); a second
    trainer resuming from checkpoint-1 on the same mesh repeats step 2 and
    the weights bit for bit.
  * Checkpoints across layouts: one process continuing the [2, 2] run's
    checkpoint-1 equals the [2, 2] run within 1e-5, and [2, 2] continuing
    the one-process checkpoint-1 equals the one-process run within 1e-5.
  * `UnitLM.shard(mesh, fsdp=True)` on [2, 2] (tp=False: fsdp over each
    'model' coordinate's 'data' line, 'model' replicas) scores, samples and
    decodes as one process does.
"""
import numpy as np
import pytest
import torch

from slamkit_tpu_torch.models import UnitLM, UnitLMConfig
from slamkit_tpu_torch.parallel.tensor import tp_fsdp_plan

import torch_mesh_workers
from torch_fsdp_cases import (CONFIG, CONTEXT, EVAL, GLOBAL_ROWS, TRAIN, WIDE, one_process,
                              train_args)

torch.set_num_threads(1)

# case: (config, training_args overrides)
CASES = {
    "adamw_remat": ({**CONFIG, "remat": True}, {}),
    "adafactor": ({**CONFIG, "config_overrides": WIDE},
                  dict(optim="adafactor", max_grad_norm="0.05")),
}


def _local_shape(whole, dims):
    """A rank's part of a parameter of `whole` shape: the 'model' dim
    halved, then the 'data' dim (dim 0 where none: FSDP2's padded rows)
    split in two by torch.chunk (rank 0's part, the larger)."""
    model, data = dims
    shape = [n // 2 if i == model else n for i, n in enumerate(whole)]
    d = 0 if data is None else data
    shape[d] = -(-shape[d] // 2)
    return tuple(shape)


def _layout(out):
    """Every tensor's (shape, dtype) in `out`'s checkpoint-1 train state."""
    def layout(x):
        if isinstance(x, torch.Tensor):
            return (tuple(x.shape), x.dtype)
        if isinstance(x, dict):
            return {k: layout(v) for k, v in x.items()}
        if isinstance(x, list):
            return [layout(v) for v in x]
        return type(x)

    return layout(torch.load(out / "checkpoint-1" / "state" / "train_state.pt",
                             weights_only=True))


@pytest.mark.parametrize("case", list(CASES))
def test_tp_fsdp_equals_one_process_tp_and_resumes_exactly(tmp_path, case):
    config, over = CASES[case]
    mesh_args = lambda out, **kw: train_args(
        out, per_device_train_batch_size=GLOBAL_ROWS // 2,
        per_device_eval_batch_size=GLOBAL_ROWS // 2, mesh_shape="[2,2]",
        mesh_axes="[data,model]", **over, **kw)
    one = tmp_path / "one"
    want_loss, want_eval, want_grads, want_params = one_process(one, config, **over)
    runs = [["tpf", mesh_args(tmp_path / "tpf", fsdp="true"), None],
            ["tpf_b", mesh_args(tmp_path / "tpf_b", fsdp="true"),
             str(tmp_path / "tpf" / "checkpoint-1")],
            ["tp", mesh_args(tmp_path / "tp"), None],
            ["from_one", mesh_args(tmp_path / "from_one", fsdp="true"),
             str(one / "checkpoint-1")]]
    got = torch_mesh_workers.launch("train_runs", 4, tmp_path / "ranks", config=config,
                                    runs=runs, train_seqs=TRAIN, eval_seqs=EVAL,
                                    context_len=CONTEXT)
    # one process resuming the [2, 2] run's gathered checkpoint-1
    loss_c, eval_c, _, params_c = one_process(tmp_path / "c", config,
                                              resume=str(tmp_path / "tpf" / "checkpoint-1"),
                                              **over)
    model = UnitLM(UnitLMConfig(**config), seed=0, device="cpu")
    shapes = {n: tuple(p.shape) for n, p in model.decoder.named_parameters()}
    plan = tp_fsdp_plan(shapes, 2, 2)
    assert any(m is not None and d is not None for m, d in plan.values())
    close = dict(rtol=1e-5, atol=1e-5)
    for rank in got:
        for name in ("tpf", "tp"):
            np.testing.assert_allclose(rank[f"{name}/loss"], want_loss, **close)
            np.testing.assert_allclose(rank[f"{name}/eval_loss"], want_eval, **close)
        np.testing.assert_allclose(rank["tpf/loss"], rank["tp/loss"], **close)
        np.testing.assert_allclose(rank["tpf/eval_loss"], rank["tp/eval_loss"], **close)
        # the resume on the same mesh repeats step 2 bit for bit (a resumed
        # run's history starts with the checkpoint's)
        np.testing.assert_array_equal(rank["tpf_b/loss"], rank["tpf/loss"])
        np.testing.assert_array_equal(rank["tpf_b/eval_loss"][-1:], rank["tpf/eval_loss"][-1:])
        # across layouts: [2, 2] from one process's checkpoint, and the reverse
        np.testing.assert_allclose(rank["from_one/loss"][-1:], want_loss[-1:], **close)
        np.testing.assert_allclose(rank["from_one/eval_loss"][-1:], want_eval[-1:], **close)
        np.testing.assert_allclose(loss_c[-1:], rank["tpf/loss"][-1:], **close)
        np.testing.assert_allclose(eval_c[-1:], rank["tpf/eval_loss"][-1:], **close)
        for i, grads in enumerate(want_grads):
            for k, g in grads.items():
                tol = dict(rtol=0, atol=1e-5 * np.abs(g).max(), err_msg=f"{k} step {i}")
                np.testing.assert_allclose(rank[f"tpf/grad{i}/{k}"], g, **tol)
                np.testing.assert_allclose(rank[f"tp/grad{i}/{k}"], g, **tol)
        for k, v in want_params.items():
            np.testing.assert_allclose(rank[f"tpf/param/{k}"], v, err_msg=k, **close)
            np.testing.assert_allclose(rank[f"from_one/param/{k}"], v, err_msg=k, **close)
            np.testing.assert_allclose(rank[f"tpf/param/{k}"], rank[f"tp/param/{k}"],
                                       err_msg=k, **close)
            np.testing.assert_allclose(params_c[k], rank[f"tpf/param/{k}"], err_msg=k,
                                       **close)
            np.testing.assert_array_equal(rank[f"tpf_b/param/{k}"], rank[f"tpf/param/{k}"],
                                          err_msg=k)
    # the checkpoint is the one-rank one: keys, shapes, dtypes
    assert _layout(tmp_path / "tpf") == _layout(one)
    # rank 0 ('data' 0, 'model' 0) holds the plan's part of every parameter
    for name, dims in plan.items():
        assert got[0][f"tpf/local/{name}"].shape == _local_shape(shapes[name], dims), name


def test_shard_fsdp_without_tp_on_a_model_mesh_equals_one_process(tmp_path):
    """`UnitLM.shard(make_mesh([2, 2], [data, model]), fsdp=True)`: every
    rank's scores within 1e-6 of one process, its greedy, int8 greedy,
    sampled and penalised tokens equal."""
    from test_torch_fsdp_jax import TINY_LM, _eval_batches

    ckpt = tmp_path / "ckpt"
    UnitLM(UnitLMConfig(**TINY_LM), seed=0, device="cpu").save_pretrained(str(ckpt))
    tokens, prompts = _eval_batches()
    got = torch_mesh_workers.launch("eval_mesh", 4, tmp_path / "ranks", ckpt=str(ckpt),
                                    tokens=tokens.tolist(), prompts=prompts.tolist(), fsdp=True,
                                    tp_shape=[2, 2], tp=False)
    want = torch_mesh_workers.eval_calls(UnitLM.from_pretrained(str(ckpt), device="cpu"),
                                         tokens, prompts, int8=True)
    for rank in got:
        assert sorted(rank) == sorted(want)
        for k in ("ll", "ll_sum", "ll_ignore"):
            np.testing.assert_allclose(rank[k], want[k], rtol=0, atol=1e-6, err_msg=k)
        for k in ("greedy", "int8", "sampled", "penalised"):
            np.testing.assert_array_equal(rank[k], want[k], err_msg=k)
