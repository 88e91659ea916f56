"""The fsdp leg of `tools/parallel_smoke.py` rehearsed on 2 gloo ranks on
the CPU, JAX and the other packages the card's host lacks blocked, at a
2-layer, 64-wide Slam decoder in float32, 2 rows of 256: DP [2] beside fsdp
[2] and fsdp [2, 1], each with its step-1 checks against the one-process
run and its exact resume, fsdp [2]'s checkpoint resumed in one process,
DPO and the evaluation (16 rows, 4
prompts of 24 new tokens) with the weights sharded, and no kernel launch.
(4 ranks and ('data', 'seq') [2, 2] are held by `test_torch_fsdp.py`.)"""
import json

import torch_mesh_workers

#: the evaluation at 16 rows scored in batches of 5, 4 prompts x 24 tokens
EVAL_SIZES = dict(pairs=8, batch=5, n_prompts=4, new_tokens=24)


def test_fsdp_leg_rehearsal_on_gloo_ranks_without_jax(tmp_path):
    ranks = torch_mesh_workers.launch("parallel_smoke", 2, tmp_path, timeout=400, block=True,
                                      context=256, rows=2, n_rows=30, lengths=[50, 300],
                                      legs=["fsdp"], eval_sizes=EVAL_SIZES)
    assert all(json.loads(str(r["loaded"])) == [] for r in ranks)
    result = json.loads(str(ranks[0]["result"]))
    assert result["device"] == "cpu" and result["world"] == 2
    row = result["fsdp"]
    assert set(row["meshes"]) == {"fsdp", "fsdp_dp_cp"} and not row["dp"]["fsdp"]
    for name, mesh in [*row["meshes"].items(), ("dp", row["dp"])]:
        assert mesh["resume_exact"] and len(mesh["losses"]) == 4, (name, mesh)
        assert mesh["loss_err"] <= 1e-5 and mesh["grad_norm_rel_err"] <= 1e-5, (name, mesh)
        assert mesh["launches_by_rank"] == [{"flash_fwd": 0, "flash_bwd": 0}] * 2
        assert mesh["max_memory_allocated"] == [None, None]
    fsdp = row["meshes"]["fsdp"]
    assert fsdp["fsdp"] and fsdp["one_card_resume"]["loss_err"] <= 1e-5
    assert {"all_gather_share", "reduce_scatter_share",
            "nccl_overlapped_share"} <= set(fsdp["profiled_step"])
    dpo = row["dpo"]
    assert dpo["fsdp"] and dpo["resume_exact"] and len(dpo["losses"]) == 3, dpo
    assert dpo["loss_err"] <= 1e-5 and dpo["grad_norm_rel_err"] <= 1e-5, dpo
    ev = row["eval"]
    assert ev["fsdp"] and ev["ll_max_abs_err"] <= 1e-6, ev
    assert ev["greedy_bitwise"] and ev["int8_greedy_bitwise"], ev
    assert ev["sampled_token_agreement"] == 1.0, ev
