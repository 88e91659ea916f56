"""Tensor parallelism beside the ring over 'seq', on gloo ranks on the CPU,
against the JAX package on the suite's CPU devices, from the same numpy
weights and inputs, in float32.

  * Training: the port's `SLAMTrainer` on [2, 2, 2] ('data', 'model',
    'seq'), 8 ranks, equals the JAX `SLAMTrainer` with the same mesh_shape
    and mesh_axes on 8 devices (attention xla: GSPMD gathers k / v over
    'seq' on each device's heads; the port runs its ring on the rank's
    heads) and the same global batch, dropout 0, max_grad_norm 0.05 so that
    clipping fires: losses and eval losses within rtol 2e-4, as
    `test_torch_tp_fsdp_jax.py` holds TP + fsdp, with and without
    `fsdp=true`.
  * The ring on local heads: `ring_flash_attention` on 4 gloo ranks of a
    (1, 2, 2) ('data', 'model', 'seq') mesh, each rank holding its 'model'
    coordinate's heads (GQA 4 / 2 split to 2 / 1) and its 'seq' chunk,
    equals JAX's `ring_flash_attention(..., interpret=True)` on the same
    mesh of CPU devices, forward and dq / dk / dv, in both schedules, within
    the 2e-5 of `test_torch_ring_attention.py`.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from slamkit_tpu.data.dataset import TokenDataset as JaxTokenDataset
from slamkit_tpu.models.unit_lm import UnitLM as JaxUnitLM
from slamkit_tpu.models.unit_lm import UnitLMConfig as JaxUnitLMConfig
from slamkit_tpu.models.unit_lm import _flatten
from slamkit_tpu.ops.ring_attention import ring_flash_attention as jax_ring
from slamkit_tpu.trainer import SLAMTrainer as JaxSLAMTrainer
from slamkit_tpu_torch.ops.ring_attention import zigzag_permutation

import torch_mesh_workers
from test_torch_fsdp_jax import _jax_args_node
from test_torch_ring_attention import TOL, packed_segments
from torch_fsdp_cases import CONFIG, CONTEXT, EVAL, GLOBAL_ROWS, TRAIN, save_params, train_args

torch.set_num_threads(1)

MESH = dict(mesh_shape="[2,2,2]", mesh_axes="[data,model,seq]")
#: the ring's 'seq' size on the (1, 2, 2) mesh
N_SEQ = 2


@pytest.mark.parametrize("fsdp", ["false", "true"])
def test_tp_seq_losses_match_the_jax_trainer(tmp_path, fsdp):
    cfg = {**CONFIG, "dropout": 0.0}
    rows = GLOBAL_ROWS // 2
    extra = dict(max_grad_norm="0.05", fsdp=fsdp, per_device_train_batch_size=rows,
                 per_device_eval_batch_size=rows, **MESH)
    jax_model = JaxUnitLM(JaxUnitLMConfig(**{**cfg, "attn_implementation": "xla"}), seed=0)
    flat = _flatten(jax_model.params)
    want = JaxSLAMTrainer(jax_model, _jax_args_node(tmp_path / "jax", **extra),
                          JaxTokenDataset.from_lists(TRAIN),
                          eval_dataset=JaxTokenDataset.from_lists(EVAL), packing=True,
                          context_len=CONTEXT).train().log_history
    args = train_args(tmp_path / "mesh", **extra)
    got = torch_mesh_workers.launch("train_runs", 8, tmp_path / "ranks", config=cfg,
                                    runs=[["tps", args, None]], train_seqs=TRAIN,
                                    eval_seqs=EVAL, context_len=CONTEXT,
                                    params_path=save_params(tmp_path, flat))
    want_loss = [r["loss"] for r in want if "loss" in r]
    want_eval = [r["eval_loss"] for r in want if "eval_loss" in r]
    assert len(want_loss) == 2 and len(want_eval) == 2
    for i in range(2):   # clipping fires on both steps
        norm = np.sqrt(sum(float((v.astype(np.float64) ** 2).sum())
                           for k, v in got[0].items() if k.startswith(f"tps/grad{i}/")))
        assert norm > 0.05
    for rank in got:
        np.testing.assert_allclose(rank["tps/loss"], want_loss, rtol=2e-4)
        np.testing.assert_allclose(rank["tps/eval_loss"], want_eval, rtol=2e-4)


def _inputs(schedule, seed, b=2, hq=4, hkv=2, d=16):
    """q, k, v, do over a sequence of N_SEQ chunks (the zigzag-permuted one
    under that schedule), packed segments with a -1 tail, the scale."""
    t = (256 if schedule == "zigzag" else 128) * N_SEQ
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((b, hq, t, d)).astype(np.float32) * 0.3 for _ in range(2))
    k, v = (rng.standard_normal((b, hkv, t, d)).astype(np.float32) * 0.3 for _ in range(2))
    g = dict(q=q, k=k, v=v, do=do, seg=packed_segments(rng, b, t, mean_len=150))
    if schedule == "zigzag":
        idx = zigzag_permutation(t, N_SEQ)
        g = {k: np.take(x, idx, axis=x.ndim - 2 if x.ndim == 4 else 1) for k, x in g.items()}
    return dict(g, scale=np.float32(d ** -0.5))


def _jax_ring(g, schedule):
    """JAX's ring on (1, 2, 2) ('data', 'model', 'seq') of the CPU devices
    (q, k, v sharded by heads over 'model', by time over 'seq'): out and the
    vjp of do."""
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(1, 2, N_SEQ), ("data", "model", "seq"))
    f = functools.partial(jax_ring, segment_ids=jnp.asarray(g["seg"]), mesh=mesh,
                          schedule=schedule, sm_scale=float(g["scale"]), interpret=True)

    @jax.jit
    def both(q, k, v, do):
        out, vjp = jax.vjp(lambda q_, k_, v_: f(q_, k_, v_), q, k, v)
        return (out,) + vjp(do)

    return dict(zip(("out", "dq", "dk", "dv"),
                    (np.asarray(x) for x in both(g["q"], g["k"], g["v"], g["do"]))))


@pytest.mark.parametrize("schedule", ["contiguous", "zigzag"])
def test_ring_on_local_heads_matches_the_jax_ring(tmp_path, schedule):
    g = _inputs(schedule, seed=5 if schedule == "contiguous" else 6)
    np.savez(tmp_path / "inputs.npz", **g)
    ranks = torch_mesh_workers.launch("ring_tp", 4, tmp_path, inputs=str(tmp_path / "inputs.npz"),
                                      schedule=schedule, mesh_shape=[1, 2, N_SEQ],
                                      mesh_axes=["data", "model", "seq"])
    at = {(int(r["model"]), int(r["seq"])): r for r in ranks}
    assert sorted(at) == [(m, s) for m in range(2) for s in range(N_SEQ)]
    # each rank's heads and chunk, put back in place: heads over 'model', time over 'seq'
    got = {name: np.concatenate([np.concatenate([at[m, s][name] for s in range(N_SEQ)], axis=2)
                                 for m in range(2)], axis=1)
           for name in ("out", "dq", "dk", "dv")}
    assert ranks[0]["dk"].shape[1] == 1 and ranks[0]["dq"].shape[1] == 2   # 2 / 1 a rank
    ref = _jax_ring(g, schedule)
    for name in ("out", "dq", "dk", "dv"):
        assert got[name].shape == ref[name].shape, name
        assert np.isfinite(got[name]).all()
        np.testing.assert_allclose(got[name], ref[name], err_msg=f"{name} vs JAX ring", **TOL)
