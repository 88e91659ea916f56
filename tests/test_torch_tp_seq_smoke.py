"""The tp_seq leg of `tools/parallel_smoke.py` rehearsed on 4 gloo ranks on
the CPU, JAX and the other packages the card's host lacks blocked, at a
2-layer, 64-wide Slam decoder in float32, 4 rows of 512: [1, 2, 2] over
('data', 'model', 'seq') in both schedules beside TP [2, 2] and CP [1, 4]
contiguous, with the step-1 checks and all four losses against the
one-process run, the exact resume, the one-process resume of the gathered
checkpoint, the replicated parameters bitwise equal across each 'model'
line, every parameter bitwise equal across each 'seq' line, and the ring on
each rank's heads and chunk against one call; no kernel launch. And
`chip_smoke.py` phase 17's ring sequence at the mesh's local heads, cut
small."""
import json
import pathlib
import sys

import torch

import torch_mesh_workers

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_tp_seq_leg_rehearsal_on_gloo_ranks_without_jax(tmp_path):
    ranks = torch_mesh_workers.launch("parallel_smoke", 4, tmp_path, timeout=400, block=True,
                                      context=512, rows=4, n_rows=80, lengths=[50, 600],
                                      legs=["tp_seq"])
    assert all(json.loads(str(r["loaded"])) == [] for r in ranks)
    result = json.loads(str(ranks[0]["result"]))
    assert result["device"] == "cpu" and result["world"] == 4
    assert len(result["one_card"]["losses"]) == 4
    row = result["tp_seq"]
    for name, shape, axes, schedule in (
            ("tp", [2, 2], ["data", "model"], "contiguous"),
            ("cp_contiguous", [1, 4], ["data", "seq"], "contiguous"),
            ("tp_seq_contiguous", [1, 2, 2], ["data", "model", "seq"], "contiguous"),
            ("tp_seq_zigzag", [1, 2, 2], ["data", "model", "seq"], "zigzag")):
        mesh = row[name]
        assert (mesh["mesh_shape"], mesh["mesh_axes"], mesh["cp_schedule"]) == \
            (shape, axes, schedule), (name, mesh)
        assert mesh["resume_exact"] and len(mesh["losses"]) == 4, (name, mesh)
        assert mesh["loss_err"] <= 1e-5 and mesh["grad_norm_rel_err"] <= 1e-5, (name, mesh)
        assert mesh["losses_max_err"] <= 1e-5, (name, mesh)
        assert mesh["launches_by_rank"] == [{"flash_fwd": 0, "flash_bwd": 0}] * 4
        if "seq" in axes:
            assert set(mesh["ring"]["max_abs_err"]) == {"out", "dq", "dk", "dv"}, (name, mesh)
            assert max(mesh["ring"]["max_abs_err"].values()) <= 1e-5, (name, mesh)
        if name.startswith("tp_seq"):
            assert mesh["replicated_bitwise_equal"], (name, mesh)
            assert mesh["seq_replicas_bitwise_equal"], (name, mesh)
            assert mesh["one_card_resume"]["loss_err"] <= 1e-5, (name, mesh)
            assert {"p2p_share", "all_reduce_share"} <= set(mesh["profiled_step"])


def test_phase_17_local_heads_rehearsal_on_the_cpu(capsys):
    """`chip_smoke.py` phase 17's ring at the ('data', 'model', 'seq')
    mesh's local heads, cut to [2, 2/1, 512, 16] over 2 'seq' chunks (the
    card's is [8, 7/1, 1024, 64]): both schedules in bf16 beside the Slam
    shape's four checks, held to one call and the plain version, no launch
    counted and nothing timed on the CPU."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    result = chip_smoke.run_ring_kernels(torch.device("cpu"), shape=(2, 4, 2, 1024, 16),
                                         tp_shape=(2, 2, 1, 512, 16))
    assert all(v == 0 for v in result["launches"].values())
    assert [(r["dtype"], r["schedule"], r["n"], r["heads"]) for r in result["checks"]][4:] == [
        ("bfloat16", "contiguous", 2, [2, 1]), ("bfloat16", "zigzag", 2, [2, 1])]
    assert len(result["checks"]) == 6 and result["calls"] == []
    assert all(r["ok"] for r in result["checks"])
    out = capsys.readouterr().out
    assert "tp_seq ring bfloat16 zigzag [2,2/1,512,16] n=2" in out
