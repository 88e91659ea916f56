"""The port's ring flash attention (`slamkit_tpu_torch/ops/ring_attention.py`)
on 4 gloo ranks, one 'seq' group, on the CPU (the flash kernels' plain
versions run every ring step).

Forward and dq / dk / dv, for both schedules, over packed segments with a
-1 tail and GQA 4/2, against two references on the same inputs (a numpy
seed): the port's single plain flash call over the whole sequence, and the
JAX package's `ring_flash_attention(..., interpret=True)` on a (1, 4)
('data', 'seq') mesh of the suite's CPU devices. `merge_pair` against JAX
`_merge_pair`, dead rows included. `ring_on_one_device` (the same steps,
rotated in memory: what the one-card smoke runs) equals the gloo ring bit
for bit. Tolerance 2e-5 (absolute and relative) in
float32: the ring sums its partial products in another order than one call.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from slamkit_tpu.ops.ring_attention import _merge_pair as jax_merge_pair
from slamkit_tpu.ops.ring_attention import ring_flash_attention as jax_ring
from slamkit_tpu_torch.ops import flash_attention_fwd, merge_pair, ring_flash_attention
from slamkit_tpu_torch.ops.attention_ref import LSE_SENTINEL
from slamkit_tpu_torch.ops.ring_attention import (check_chunk, ring_on_one_device,
                                                  zigzag_permutation)

import torch_mesh_workers

torch.set_num_threads(1)

N = 4
B, HQ, HKV, D = 2, 4, 2, 16
TOL = dict(atol=2e-5, rtol=2e-5)


def packed_segments(rng, b, t, mean_len):
    """Monotone per-row segment ids with a -1 tail, as the Batcher packs."""
    seg = np.full((b, t), -1, np.int32)
    for r in range(b):
        pos, s = 0, 0
        tail = int(rng.integers(8, 40))
        while pos < t - tail:
            ln = min(int(rng.integers(mean_len // 2, mean_len * 2)), t - tail - pos)
            seg[r, pos:pos + ln] = s
            pos += ln
            s += 1
    return seg


def inputs(schedule, seed):
    t = (256 if schedule == "zigzag" else 128) * N
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((B, HQ, t, D)).astype(np.float32) * 0.3 for _ in range(2))
    k, v = (rng.standard_normal((B, HKV, t, D)).astype(np.float32) * 0.3 for _ in range(2))
    return dict(q=q, k=k, v=v, do=do, seg=packed_segments(rng, B, t, mean_len=150),
                scale=np.float32(D ** -0.5))


def permuted(x, schedule, dim):
    if schedule != "zigzag":
        return x
    return np.take(x, zigzag_permutation(x.shape[dim], N), axis=dim)


def single_call(g):
    """The port's one plain flash call over the whole sequence: out and
    d(q, k, v) of sum(out * do)."""
    q, k, v = (torch.from_numpy(g[n]).requires_grad_() for n in ("q", "k", "v"))
    out, _ = flash_attention_fwd(q, k, v, segment_ids=torch.from_numpy(g["seg"]),
                                 causal=True, sm_scale=float(g["scale"]))
    out.backward(torch.from_numpy(g["do"]))
    return {"out": out.detach().numpy(), "dq": q.grad.numpy(), "dk": k.grad.numpy(),
            "dv": v.grad.numpy()}


def jax_ring_call(g, schedule):
    """The JAX ring on (1, 4) ('data', 'seq') of the CPU devices, on the
    (permuted) global arrays: out and the vjp of do."""
    mesh = Mesh(np.asarray(jax.devices()[:N]).reshape(1, N), ("data", "seq"))
    seg = jnp.asarray(g["seg"])
    f = functools.partial(jax_ring, segment_ids=seg, mesh=mesh, schedule=schedule,
                          sm_scale=float(g["scale"]), interpret=True)

    @jax.jit
    def both(q, k, v, do):
        out, vjp = jax.vjp(lambda q_, k_, v_: f(q_, k_, v_), q, k, v)
        return (out,) + vjp(do)

    return dict(zip(("out", "dq", "dk", "dv"),
                    (np.asarray(x) for x in both(g["q"], g["k"], g["v"], g["do"]))))


def ring_on_ranks(g, schedule, tmp):
    np.savez(tmp / "inputs.npz", **g)
    ranks = torch_mesh_workers.launch("ring", N, tmp, inputs=str(tmp / "inputs.npz"),
                                      schedule=schedule)
    return {name: np.concatenate([r[name] for r in ranks], axis=2)
            for name in ("out", "dq", "dk", "dv")}


@pytest.mark.parametrize("schedule", ["contiguous", "zigzag"])
def test_ring_matches_single_call_and_jax_ring(tmp_path, schedule):
    g = inputs(schedule, seed=0 if schedule == "contiguous" else 1)
    gp = {k: permuted(v, schedule, 2 if v.ndim == 4 else 1) if np.ndim(v) else v
          for k, v in g.items()}
    got = ring_on_ranks(gp, schedule, tmp_path)
    one = {k: permuted(v, schedule, 2) for k, v in single_call(g).items()}
    ref = jax_ring_call(gp, schedule)
    t = lambda name: torch.from_numpy(gp[name])
    sim = dict(zip(("out", "lse", "dq", "dk", "dv"), ring_on_one_device(
        t("q"), t("k"), t("v"), t("seg"), t("do"), N, schedule, float(g["scale"]))))
    for name in ("out", "dq", "dk", "dv"):
        assert np.isfinite(got[name]).all()
        np.testing.assert_array_equal(sim[name].numpy(), got[name], err_msg=name)
        np.testing.assert_allclose(got[name], one[name], err_msg=f"{name} vs one call", **TOL)
        np.testing.assert_allclose(got[name], ref[name], err_msg=f"{name} vs JAX ring", **TOL)


def _dead_rows(rng, shape, share):
    lse = rng.standard_normal(shape).astype(np.float32) * 3
    lse[rng.random(shape) < share] = LSE_SENTINEL
    return lse


def test_merge_pair_matches_jax_with_dead_rows():
    """Rows dead in one part, in the other and in both (out 0 and the
    sentinel, as the kernels leave them) merge as JAX merges them."""
    rng = np.random.default_rng(3)
    shape = (2, 3, 64)
    out_a, out_b = (rng.standard_normal(shape + (8,)).astype(np.float32) for _ in range(2))
    lse_a, lse_b = _dead_rows(rng, shape, 0.3), _dead_rows(rng, shape, 0.3)
    out_a[lse_a >= LSE_SENTINEL] = 0.0
    out_b[lse_b >= LSE_SENTINEL] = 0.0
    assert ((lse_a >= LSE_SENTINEL) & (lse_b >= LSE_SENTINEL)).any()
    got_out, got_lse = merge_pair(*(torch.from_numpy(x) for x in (out_a, lse_a, out_b, lse_b)))
    want_out, want_lse = jax_merge_pair(out_a, lse_a[..., None], out_b, lse_b[..., None])
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), **TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse)[..., 0], **TOL)
    both_dead = (lse_a >= LSE_SENTINEL) & (lse_b >= LSE_SENTINEL)
    assert (got_out.numpy()[both_dead] == 0).all()
    assert (got_lse.numpy()[both_dead] == LSE_SENTINEL).all()


@pytest.mark.parametrize("chunk,schedule,ok", [
    (128, "contiguous", True), (64, "contiguous", False), (128, "zigzag", False),
    (256, "zigzag", True), (256, "striped", False)])
def test_ring_chunk_rules_as_jax(chunk, schedule, ok):
    """The chunk a rank holds: a multiple of 128 (of 256 under zigzag), a
    known schedule; the messages are the JAX package's."""
    if ok:
        check_chunk(chunk, N, schedule)
        return
    with pytest.raises(ValueError, match="lane-aligned|unknown ring schedule"):
        check_chunk(chunk, N, schedule)


def test_ring_refuses_kv_heads_that_do_not_divide():
    q = torch.zeros(1, 3, 128, 16)
    k = torch.zeros(1, 2, 128, 16)
    with pytest.raises(ValueError, match="not a multiple of kv heads"):
        ring_flash_attention(q, k, k, group=None)
