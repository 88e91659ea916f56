"""The nodes legs of `tools/parallel_smoke.py` (what `tools/multinode.py`
runs on two torchrun nodes of two cards) rehearsed on 4 gloo ranks on the
CPU in torchrun's environment of two nodes of two ranks, with
`training_args.multihost=true`, JAX and the other packages the card's host
lacks blocked, at a 2-layer, 64-wide Slam decoder in float32, 4 rows of
256: `nodes` runs DP [4], TP [2, 2] ('model' inside each node) and fsdp
[4], `nodes_dp` (the socket run's) DP [4] alone, each mesh with the step-1
checks against the one-process run, the exact resume and the one-process
resume of its checkpoint-3, and the axes that cross the nodes; no kernel
launch."""
import json

import pytest

import torch_mesh_workers


@pytest.mark.parametrize("leg,meshes", [("nodes", ["dp", "tp", "fsdp"]), ("nodes_dp", ["dp"])])
def test_nodes_legs_rehearsal_on_two_gloo_nodes_without_jax(tmp_path, leg, meshes):
    ranks = torch_mesh_workers.launch("parallel_smoke", 4, tmp_path, timeout=400, block=True,
                                      per_node=2, context=256, rows=4, n_rows=80,
                                      lengths=[50, 300], multihost=True, legs=[leg])
    assert all(json.loads(str(r["loaded"])) == [] for r in ranks)
    result = json.loads(str(ranks[0]["result"]))
    assert result["device"] == "cpu" and result["world"] == 4
    rows = result["nodes"]
    assert list(rows) == meshes
    for name, row in rows.items():
        assert row["nodes"] == 2 and row["cross_node_axes"] == ["data"], (name, row)
        assert row["resume_exact"] and len(row["losses"]) == 4, (name, row)
        assert row["loss_err"] <= 1e-5 and row["grad_norm_rel_err"] <= 1e-5, (name, row)
        assert row["one_card_resume"]["loss_err"] <= 1e-5, (name, row)
        assert row["launches_by_rank"] == [{"flash_fwd": 0, "flash_bwd": 0}] * 4
        assert {"all_reduce_share", "wall_ms"} <= set(row["profiled_step"])
    assert not rows["dp"]["fsdp"]
    if leg == "nodes":
        assert rows["tp"]["mesh_shape"] == [2, 2] and rows["tp"]["replicated_bitwise_equal"]
        assert rows["fsdp"]["fsdp"]
    assert not (tmp_path / "work" / "dp_a").exists()
