"""Tensor parallelism over 'model' beside the ring over 'seq' on one
('data', 'model', 'seq') mesh, on gloo ranks on the CPU, against the
one-process run of the same global batch (float32, the kernels' plain
versions).

  * Training: `SLAMTrainer` on [1, 2, 2] equals the one-process run within
    the tolerances of `test_torch_tp.py` and `test_torch_parallel_training.py`
    (losses and eval losses 1e-5, the global gradient each optimizer step
    reads, gathered whole, within 1e-5 of its largest entry, every
    parameter 1e-5), at dropout 0.1: the ring in both schedules and both
    axis orders, ('data', 'model', 'seq') and ('data', 'seq', 'model') (whose
    'seq' groups are strided: {0, 2} and {1, 3}), under full and qkv remat,
    the plain route with attention dropout 0.1 (k / v gathered over
    'seq', the probabilities' mask drawn at the global heads, tiled, then
    narrowed to the rank's), and Adafactor at 128 wide with clipping on
    both steps (the global norm and the factored statistics summed over
    'model' alone, each 'seq' replica counted once). A second trainer resuming from checkpoint-1
    repeats step 2 and the weights bit for bit; after two steps the two
    'seq' replicas of every parameter (a 'model' slice or a whole one) are
    bitwise equal, and so is every replicated parameter across a 'model'
    line. One process resuming the mesh's gathered checkpoint-1 takes step
    2 within 1e-5 of the one-process run.
  * The groups: on 8 ranks of [2, 2, 2], in both orders, `batch_group()`
    holds the 'data' x 'seq' plane of the rank's 'model' coordinate; on 4
    ranks of [1, 2, 2] its 'seq' line. `cross_node_axes` names the axes of
    a 3-D mesh whose groups cross two nodes.
"""
import numpy as np
import pytest
import torch

from slamkit_tpu_torch.parallel import mesh as port_mesh

import torch_mesh_workers
from test_torch_tp import _replicated
from torch_fsdp_cases import CONFIG, EVAL, GLOBAL_ROWS, TRAIN, WIDE, one_process, train_args

torch.set_num_threads(1)

DMS, DSM = "[data,model,seq]", "[data,seq,model]"
# case: (axes, context, training_args overrides, model overrides)
CASES = {
    "contiguous": (DMS, 256, {}, dict(remat=True)),
    "zigzag": (DMS, 512, dict(cp_schedule="zigzag"), dict(remat=True, remat_policy="qkv")),
    "contiguous_seq_model": (DSM, 256, {}, dict(remat=True, remat_policy="qkv")),
    "zigzag_seq_model": (DSM, 512, dict(cp_schedule="zigzag"), dict(remat=True)),
    "plain": (DMS, 256, {}, dict(attn_implementation="xla", attention_dropout=0.1,
                                 remat=True, remat_policy="qkv")),
    "adafactor": (DMS, 256, dict(optim="adafactor", max_grad_norm="0.05"),
                  dict(config_overrides=WIDE)),
}


def _pairs(axes: str, axis: str) -> list:
    """The rank pairs of the [1, 2, 2] mesh's lines along `axis`."""
    names = axes.strip("[]").split(",")
    ranks = np.arange(4).reshape(1, 2, 2)
    return np.moveaxis(ranks, names.index(axis), -1).reshape(-1, 2).tolist()


@pytest.mark.parametrize("case", list(CASES))
def test_tp_seq_equals_one_process_and_resumes_exactly(tmp_path, case):
    axes, context, over, model_over = CASES[case]
    config = {**CONFIG, **model_over}
    args = train_args(tmp_path / "mesh", per_device_train_batch_size=GLOBAL_ROWS,
                      per_device_eval_batch_size=GLOBAL_ROWS, mesh_shape="[1,2,2]",
                      mesh_axes=axes, **over)
    got = torch_mesh_workers.launch("train", 4, tmp_path / "ranks", config=config, args=args,
                                    train_seqs=TRAIN, eval_seqs=EVAL, context_len=context)
    optim = {k: v for k, v in over.items() if k in ("optim", "max_grad_norm")}
    want_loss, want_eval, want_grads, want_params = one_process(tmp_path / "one", config,
                                                                context=context, **optim)
    assert len(want_loss) == 2 and len(want_eval) == 2 and len(want_grads) == 2
    if optim:   # clipping fires on both steps: the global norm is held too
        for grads in want_grads:
            assert np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                               for g in grads.values())) > 0.05
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
        assert list(rank["b/loss"]) == list(rank["a/loss"])
        assert list(rank["b/eval_loss"][-1:]) == list(rank["a/eval_loss"][-1:])
        for k in want_params:
            np.testing.assert_array_equal(rank[f"b/param/{k}"], rank[f"a/param/{k}"],
                                          err_msg=k)
    local = [k for k in got[0] if k.startswith("a/local/")]
    for a, b in _pairs(axes, "seq"):   # 'seq' replicas: every parameter
        for k in local:
            np.testing.assert_array_equal(got[a][k], got[b][k], err_msg=f"{k} ranks {a}, {b}")
    for a, b in _pairs(axes, "model"):   # a 'model' line: the whole ones
        for k in _replicated(config, 2):
            np.testing.assert_array_equal(got[a][f"a/local/{k}"], got[b][f"a/local/{k}"],
                                          err_msg=k)
        assert not np.array_equal(got[a]["a/local/layers.0.q_w"],
                                  got[b]["a/local/layers.0.q_w"])
    if case == "contiguous":   # one process resumes the gathered checkpoint
        got_loss, got_eval, _, got_params = one_process(
            tmp_path / "resumed", config, resume=str(tmp_path / "mesh" / "checkpoint-1"))
        np.testing.assert_allclose(got_loss[-1], want_loss[-1], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got_eval[-1], want_eval[-1], rtol=1e-5, atol=1e-5)
        for k, v in want_params.items():
            np.testing.assert_allclose(got_params[k], v, rtol=1e-5, atol=1e-5, err_msg=k)


def test_batch_group_is_the_data_seq_plane_of_a_model_coordinate(tmp_path):
    orders = [["data", "model", "seq"], ["data", "seq", "model"], ["model", "data", "seq"]]
    got = torch_mesh_workers.launch("mesh_groups", 8, tmp_path, shape=[2, 2, 2],
                                    orders=orders)
    for i, axes in enumerate(orders):
        ranks = np.arange(8).reshape(2, 2, 2)
        for rank, out in enumerate(got):
            at = dict(zip(axes, out[f"{i}/coordinate"].tolist()))
            assert at == dict(zip(axes, np.unravel_index(rank, (2, 2, 2)))), (axes, rank)
            plane = np.take(ranks, at["model"], axis=axes.index("model")).reshape(-1)
            assert sorted(out[f"{i}/batch"].tolist()) == sorted(plane.tolist()), (axes, rank)
            for axis in ("model", "seq"):
                line = [r for r in range(8)
                        if all(np.unravel_index(r, (2, 2, 2))[j] == at[a]
                               for j, a in enumerate(axes) if a != axis)]
                assert out[f"{i}/{axis}"].tolist() == line, (axes, axis, rank)
    # ('data', 'seq', 'model'): the 'seq' lines are strided, {0, 2} / {1, 3} ...
    assert got[0]["1/seq"].tolist() == [0, 2] and got[1]["1/seq"].tolist() == [1, 3]
    # ... and the plane of 'model' coordinate 0 is every even rank
    assert sorted(got[0]["1/batch"].tolist()) == [0, 2, 4, 6]


def test_batch_group_on_one_data_coordinate_is_the_seq_line(tmp_path):
    got = torch_mesh_workers.launch("mesh_groups", 4, tmp_path, shape=[1, 2, 2],
                                    orders=[["data", "model", "seq"], ["data", "seq", "model"]])
    assert [r["0/batch"].tolist() for r in got] == [[0, 1], [0, 1], [2, 3], [2, 3]]
    assert [r["1/batch"].tolist() for r in got] == [[0, 2], [1, 3], [0, 2], [1, 3]]
    assert [r["0/seq"].tolist() for r in got] == [r["0/batch"].tolist() for r in got]


@pytest.mark.parametrize("axes,local_size,crossing", [
    (("data", "model", "seq"), 4, ("data",)),
    (("data", "model", "seq"), 2, ("data", "model")),
    (("model", "data", "seq"), 4, ("model",)),
    (("data", "seq", "model"), 2, ("data", "seq")),
])
def test_cross_node_axes_of_a_3d_mesh_over_two_nodes(axes, local_size, crossing):
    nodes = 8 // local_size
    for rank in range(8):
        mesh = port_mesh.Mesh(axes, (2, 2, 2), rank=rank, local_size=local_size)
        assert (mesh.nodes, mesh.node) == (nodes, rank // local_size)
        assert mesh.cross_node_axes == crossing


def test_planes_hold_every_rank_once_by_model_coordinate():
    for axes in (("data", "model", "seq"), ("seq", "data", "model"), ("model", "seq", "data")):
        planes = port_mesh.planes(axes, (2, 2, 2))
        assert sorted(planes.reshape(-1).tolist()) == list(range(8))
        for m, plane in enumerate(planes):
            assert all(np.unravel_index(r, (2, 2, 2))[axes.index("model")] == m for r in plane)
