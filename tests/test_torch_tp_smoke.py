"""The tp legs of `tools/parallel_smoke.py` rehearsed on 4 gloo ranks on the
CPU, JAX and the other packages the card's host lacks blocked, at a 2-layer,
64-wide Slam decoder in float32, 4 rows of 256: DP [4] beside TP [2, 2]
over ('data', 'model') with the step-1 checks against the one-process run,
the exact resume, the one-process resume of the gathered checkpoint and the
replicated parameters bitwise equal across each 'model' line (tp); the
evaluation through `UnitLM.shard(mesh, tp=True)` (tp_eval: 16 rows, 4
prompts of 24 new tokens); and the sims7b leg on TP [1, 4] from the 7B base
directory cut to 2 layers of 64 with 4 / 4 heads (tp_sims7b); no kernel
launch."""
import json

import numpy as np

import torch_mesh_workers

#: the evaluation at 16 rows scored in batches of 5, 4 prompts x 24 tokens
EVAL_SIZES = dict(pairs=8, batch=5, n_prompts=4, new_tokens=24)
#: the sims7b leg's rehearsal on TP [1, 4]: 4 kv heads, so whole heads split
SIMS_TP = dict(arch=dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                         num_key_value_heads=4, intermediate_size=128),
               entries=804, context=256)


def test_tp_leg_rehearsal_on_gloo_ranks_without_jax(tmp_path):
    ranks = torch_mesh_workers.launch("parallel_smoke", 4, tmp_path, timeout=400, block=True,
                                      context=256, rows=4, n_rows=80, lengths=[50, 300],
                                      legs=["tp", "tp_eval", "tp_sims7b"],
                                      eval_sizes=EVAL_SIZES, sims=SIMS_TP)
    assert all(json.loads(str(r["loaded"])) == [] for r in ranks)
    result = json.loads(str(ranks[0]["result"]))
    assert result["device"] == "cpu" and result["world"] == 4
    row = result["tp"]
    for name in ("dp", "tp"):
        mesh = row[name]
        assert mesh["resume_exact"] and len(mesh["losses"]) == 4, (name, mesh)
        assert mesh["loss_err"] <= 1e-5 and mesh["grad_norm_rel_err"] <= 1e-5, (name, mesh)
        assert mesh["launches_by_rank"] == [{"flash_fwd": 0, "flash_bwd": 0}] * 4
    tp = row["tp"]
    assert tp["mesh_shape"] == [2, 2] and tp["mesh_axes"] == ["data", "model"]
    assert tp["replicated_bitwise_equal"] and tp["one_card_resume"]["loss_err"] <= 1e-5
    assert {"all_reduce_share", "nccl_overlapped_share"} <= set(tp["profiled_step"])
    ev = result["tp_eval"]
    assert ev["tp"] and ev["dtype"] == "float32" and ev["mesh_shape"] == [2, 2], ev
    assert ev["ll_max_abs_err"] <= 1e-5 and ev["greedy_bitwise"] and ev["sampled_bitwise"], ev
    assert ev["int8_prefill_max_abs_err"] <= ev["int8_prefill_bound"], ev
    assert ev["launches_by_rank"] == [{"flash_fwd": 0, "dq_matmul": 0}] * 4
    sims = result["tp_sims7b"]
    assert sims["mesh_shape"] == [1, 4] and not sims["fsdp"] and sims["rows_a_step"] == 2
    assert len(sims["losses"]) == 3 and all(np.isfinite(sims["losses"]))
    assert sims["loss_err"] <= 1e-5 and sims["unmoved_parameters"] == [], sims
    assert np.isfinite(sims["grad_norm_step1"]) and sims["grad_norm_step1"] > 0
