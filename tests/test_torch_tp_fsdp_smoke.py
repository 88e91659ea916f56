"""The tp_fsdp legs of `tools/parallel_smoke.py` rehearsed on 4 gloo ranks on
the CPU, JAX and the other packages the card's host lacks blocked, at a
2-layer, 64-wide Slam decoder in float32, 4 rows of 256: TP + fsdp [2, 2]
beside TP [2, 2] and fsdp [4], with the step-1 checks and all four losses
against the one-process run, the exact resume, the one-process resume of
the gathered checkpoint and the replicated parameters' shards bitwise equal
across each 'model' line (tp_fsdp); and the sims7b leg on TP + fsdp [2, 2]
beside fsdp [4] and TP [1, 4] from the 7B base directory cut to 2 layers of
64 with 4 / 4 heads (tp_fsdp_sims7b); no kernel launch."""
import json

import numpy as np

import torch_mesh_workers
from test_torch_tp_smoke import SIMS_TP


def test_tp_fsdp_legs_rehearsal_on_gloo_ranks_without_jax(tmp_path):
    ranks = torch_mesh_workers.launch("parallel_smoke", 4, tmp_path, timeout=400, block=True,
                                      context=256, rows=4, n_rows=80, lengths=[50, 300],
                                      legs=["tp_fsdp", "tp_fsdp_sims7b"], sims=SIMS_TP)
    assert all(json.loads(str(r["loaded"])) == [] for r in ranks)
    result = json.loads(str(ranks[0]["result"]))
    assert result["device"] == "cpu" and result["world"] == 4
    assert len(result["one_card"]["losses"]) == 4
    row = result["tp_fsdp"]
    for name, shape, fsdp in (("tp", [2, 2], False), ("fsdp", [4], True),
                              ("tp_fsdp", [2, 2], True)):
        mesh = row[name]
        assert mesh["mesh_shape"] == shape and mesh["fsdp"] == fsdp, (name, mesh)
        assert mesh["resume_exact"] and len(mesh["losses"]) == 4, (name, mesh)
        assert mesh["loss_err"] <= 1e-5 and mesh["grad_norm_rel_err"] <= 1e-5, (name, mesh)
        assert mesh["losses_max_err"] <= 1e-5, (name, mesh)
        assert mesh["one_card_resume"]["loss_err"] <= 1e-5, (name, mesh)
        assert mesh["launches_by_rank"] == [{"flash_fwd": 0, "flash_bwd": 0}] * 4
    tpf = row["tp_fsdp"]
    assert tpf["mesh_axes"] == ["data", "model"] and tpf["replicated_bitwise_equal"]
    assert {"all_reduce_share", "all_gather_share", "reduce_scatter_share"} <= \
        set(tpf["profiled_step"])
    sims = result["tp_fsdp_sims7b"]
    for name, shape, fsdp, rows in (("fsdp", [4], True, 8), ("tp", [1, 4], False, 2),
                                    ("tp_fsdp", [2, 2], True, 4)):
        got = sims[name]
        assert got["mesh_shape"] == shape and got["fsdp"] == fsdp, (name, got)
        assert got["rows_a_step"] == rows and len(got["losses"]) == 3, (name, got)
        assert all(np.isfinite(got["losses"])) and got["loss_err"] <= 1e-5, (name, got)
        assert got["unmoved_parameters"] == [] and got["grad_norm_step1"] > 0, (name, got)
        assert got["launches_by_rank"] == [{"flash_fwd": 0, "flash_bwd": 0}] * 4
        assert got["mfu"] is None and got["checkpoint"] is None
    assert not (tmp_path / "work" / "sims7b").exists()
