"""Parameters sharded over 'data' (fsdp, ZeRO-3; `parallel/fsdp.py`) on gloo
ranks on the CPU, against the one-process run and JAX's placement.

  * Placement: each rank's local shard of every parameter is the slice that
    JAX's `param_shardings(fsdp=True)` puts on the device at its position
    (`devices_indices_map`, per layer of JAX's stacked leaves), at 2 and 4
    ranks; at 3 ranks the parameters no dim divides (JAX replicates them)
    are rows of dim 0 as `torch.chunk` splits it, the recorded difference.
  * Training: `SLAMTrainer` with `training_args.fsdp=true` on [2] (also
    with the qkv remat policy inside each sharded layer), [4],
    ('data', 'seq') [2, 2] with full remat, the ring (contiguous) and the
    plain route's k / v gather, and
    Adafactor on [2] at 128 wide (factored statistics of parameters
    sharded on either factored dim) with clipping on every step, equal the
    one-process run of the same 4-row global batch within the tolerances
    of `test_torch_parallel_training.py` (losses and eval losses 1e-5, the
    global gradient each optimizer step reads within 1e-5 of its largest
    entry, every parameter 1e-5), dropout 0.1 and an evaluation after each
    step included; a second trainer resuming from checkpoint-1 repeats
    step 2 and the weights bit for bit.
  * A checkpoint written under fsdp [2] holds the one-process checkpoint's
    keys, shapes and dtypes, and one process resuming from it lands within
    1e-5 of the one-process run.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from slamkit_tpu.models.unit_lm import UnitLM as JaxUnitLM
from slamkit_tpu.models.unit_lm import UnitLMConfig as JaxUnitLMConfig
from slamkit_tpu.models.unit_lm import _flatten
from slamkit_tpu.parallel.mesh import param_shardings
from slamkit_tpu_torch.parallel.fsdp import data_dim
from slamkit_tpu_torch.trainer.optim import _factored_dims

import torch_mesh_workers
from torch_fsdp_cases import (CONFIG, EVAL, GLOBAL_ROWS, CONTEXT, TRAIN, WIDE, one_process,
                              save_params, train_args)

torch.set_num_threads(1)


# --------------------------------------------------------------------------- #
# placement
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("ranks", [2, 3, 4])
def test_local_shards_are_jax_param_shardings(tmp_path, ranks):
    cfg = {**CONFIG, "dropout": 0.0}
    jax_model = JaxUnitLM(JaxUnitLMConfig(**cfg), seed=0)
    flat = _flatten(jax_model.params)
    got = torch_mesh_workers.launch("fsdp_placement", ranks, tmp_path / "ranks", config=cfg,
                                    params_path=save_params(tmp_path, flat))
    devices = jax.devices()[:ranks]
    tree = param_shardings(jax_model.params, JaxMesh(np.array(devices), ("data",)), fsdp=True)
    shardings = {"/".join(p.key for p in path): sh
                 for path, sh in jax.tree_util.tree_flatten_with_path(tree)[0]}
    replicated = 0
    for key, whole in flat.items():
        layers = key.startswith("layers/")
        index = shardings[key].devices_indices_map(whole.shape)
        names = ([f"layers.{i}.{key.split('/', 1)[1]}" for i in range(len(whole))]
                 if layers else [key])
        parts = list(whole) if layers else [whole]
        for rank, dev in enumerate(devices):
            idx = index[dev]
            if layers:   # JAX stacks the layers on dim 0, which it never shards here
                assert idx[0] == slice(None), key
                idx = idx[1:]
            for name, part in zip(names, parts):
                mine = got[rank][name]
                if part[idx].shape == part.shape:
                    # no dim divides the ranks: JAX replicates, the port
                    # holds rows of dim 0 (torch.chunk's split, padded)
                    replicated += 1
                    chunk = -(-part.shape[0] // ranks)
                    assert data_dim(part.shape, ranks) is None
                    np.testing.assert_array_equal(mine, part[rank * chunk:(rank + 1) * chunk],
                                                  err_msg=name)
                else:
                    np.testing.assert_array_equal(mine, part[idx], err_msg=f"{name} rank {rank}")
    assert (replicated > 0) == (ranks == 3)


# --------------------------------------------------------------------------- #
# training
# --------------------------------------------------------------------------- #
# name: (ranks, 'data' size, mesh and optimizer overrides, model config)
CASES = {
    "dp2": (2, 2, dict(mesh_shape="[2]"), CONFIG),
    "dp2_remat_qkv": (2, 2, dict(mesh_shape="[2]"),
                      {**CONFIG, "remat": True, "remat_policy": "qkv"}),
    "dp4": (4, 4, dict(mesh_shape="[4]"), CONFIG),
    "dp_cp": (4, 2, dict(mesh_shape="[2,2]", mesh_axes="[data,seq]"),
              {**CONFIG, "remat": True}),
    "dp_cp_plain": (4, 2, dict(mesh_shape="[2,2]", mesh_axes="[data,seq]"),
                    {**CONFIG, "remat": True, "attn_implementation": "xla"}),
    "adafactor": (2, 2, dict(mesh_shape="[2]", optim="adafactor", max_grad_norm="0.05"),
                  {**CONFIG, "config_overrides": WIDE}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fsdp_equals_one_process_and_resumes_exactly(tmp_path, case):
    ranks, n_data, over, config = CASES[case]
    optim = {k: v for k, v in over.items() if k in ("optim", "max_grad_norm")}
    args = train_args(tmp_path / "mesh", per_device_train_batch_size=GLOBAL_ROWS // n_data,
                      per_device_eval_batch_size=GLOBAL_ROWS // n_data, fsdp="true", **over)
    got = torch_mesh_workers.launch("train", ranks, tmp_path / "ranks", config=config,
                                    args=args, train_seqs=TRAIN, eval_seqs=EVAL,
                                    context_len=CONTEXT)
    want_loss, want_eval, want_grads, want_params = one_process(tmp_path / "one", config,
                                                                **optim)
    assert len(want_loss) == 2 and len(want_eval) == 2 and len(want_grads) == 2
    if case == "adafactor":
        # clipping fires on both steps, and a factored parameter is sharded
        # on each of its factored dims
        for grads in want_grads:
            assert np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                               for g in grads.values())) > 0.05
        for shape in ((128, 128), (128, 256)):
            assert data_dim(shape, 2) in _factored_dims(shape)
        assert {data_dim(s, 2) for s in ((128, 128), (128, 256))} == {0, 1}
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
        # the resumed run repeats step 2, its evaluation and the weights
        # bit for bit
        assert list(rank["b/loss"]) == list(rank["a/loss"])
        assert list(rank["b/eval_loss"][-1:]) == list(rank["a/eval_loss"][-1:])
        for k in want_params:
            np.testing.assert_array_equal(rank[f"b/param/{k}"], rank[f"a/param/{k}"],
                                          err_msg=k)
            np.testing.assert_array_equal(rank[f"a/param/{k}"], got[0][f"a/param/{k}"])


@pytest.mark.parametrize("optim", ["adamw_torch", "adafactor"])
def test_fsdp_checkpoint_has_the_one_rank_layout_and_resumes_on_one_process(tmp_path, optim):
    config = {**CONFIG, "config_overrides": WIDE} if optim == "adafactor" else CONFIG
    args = train_args(tmp_path / "mesh", per_device_train_batch_size=GLOBAL_ROWS // 2,
                      per_device_eval_batch_size=GLOBAL_ROWS // 2, fsdp="true",
                      mesh_shape="[2]", optim=optim)
    torch_mesh_workers.launch("train", 2, tmp_path / "ranks", config=config, args=args,
                              train_seqs=TRAIN, eval_seqs=EVAL, context_len=CONTEXT)
    want_loss, want_eval, _, want_params = one_process(tmp_path / "one", config, optim=optim)
    load = lambda out: torch.load(out / "checkpoint-1" / "state" / "train_state.pt",
                                  weights_only=True)
    sharded, single = load(tmp_path / "mesh"), load(tmp_path / "one")

    def layout(x):
        if isinstance(x, torch.Tensor):
            return (tuple(x.shape), x.dtype, x.device.type)
        if isinstance(x, dict):
            return {k: layout(v) for k, v in x.items()}
        if isinstance(x, list):
            return [layout(v) for v in x]
        return type(x)

    assert layout(sharded) == layout(single)
    assert sharded["kind"] == optim.split("_")[0] and sharded["step"] == 1
    for k, v in single["params"].items():
        np.testing.assert_allclose(sharded["params"][k].numpy(), v.detach().numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    # one process resumes the sharded run's checkpoint-1 and takes step 2
    got_loss, got_eval, _, got_params = one_process(
        tmp_path / "resumed", config, resume=str(tmp_path / "mesh" / "checkpoint-1"),
        optim=optim)
    np.testing.assert_allclose(got_loss[-1], want_loss[-1], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_eval[-1], want_eval[-1], rtol=1e-5, atol=1e-5)
    for k, v in want_params.items():
        np.testing.assert_allclose(got_params[k], v, rtol=1e-5, atol=1e-5, err_msg=k)
