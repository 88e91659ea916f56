"""The port's attention backward (the plain version on the CPU) against the JAX
package's Pallas backward kernel run in interpret mode, in float32: dq, dk and
dv from `flash_attention_bwd` / `mha_reference_bwd` and from the autograd
function, causal and non-causal, GQA 14/2 and 7/1, d 64 and 128, ragged T,
packed segments with a -1 tail, the left-padded pattern, and dead rows.

Tolerance: 2e-5 absolute and relative, as the forward's test: both sides are
float32 and differ only in summation order.

Where the JAX wrapper pads T with -1 segment ids (non-causal with a -1 tail),
its -1 query rows also see the padded keys (ROADMAP queue 3); dO is zeroed on
-1 rows there, as training's -100 labels make it, and every gradient must
then agree: the differences stay confined to rows no loss reads.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamkit_tpu.ops import flash_attention as jax_flash_attention
from slamkit_tpu.ops.flash_attention import FlashConfig, _bwd, _fwd
from slamkit_tpu_torch.ops import (flash_attention, flash_attention_bwd,
                                   flash_attention_fwd, mha_reference_bwd)

# the gate runs several pytest workers on the CPU's cores: one torch thread
# each keeps their thread pools from oversubscribing the cores
torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-5)


def _inputs(seed, b, h, hkv, t, d):
    rng = np.random.default_rng(seed)
    mk = lambda hh: (rng.standard_normal((b, hh, t, d)) * 0.5).astype(np.float32)
    return mk(h), mk(hkv), mk(hkv), rng.standard_normal((b, h, t, d)).astype(np.float32)


def _packed(b, lens):
    """[b, sum(lens)] segment ids 0, 1, ... with -1 for a trailing pad run
    (the last length); row i rotates the real segment lengths by i."""
    real, tail = list(lens[:-1]), lens[-1]
    rows = [np.repeat(np.r_[np.arange(len(real)), -1], real[i:] + real[:i] + [tail])
            for i in range(b)]
    return np.stack(rows).astype(np.int32)


def _segments(kind, b, t):
    if kind == "packed":
        third = t // 3
        return _packed(b, [third, t - 2 * third - 7, third, 7])
    if kind == "left_padded":
        seg = np.zeros((b, t), np.int32)
        for i, n in enumerate([t // 2, 3][:b]):
            seg[i, :n] = -1
        return seg
    return None


def _jax_grads(q, k, v, do, seg, kv_seg, causal, sm_scale):
    """dq, dk, dv straight from the Pallas `_bwd` (interpret mode) on the
    Pallas `_fwd`'s own out and LSE, with the public wrapper's padding: T up
    to a 128 multiple (one block), D to 128 lanes, padded keys masked by a -1
    segment id (or by causality)."""
    b, h, t, d = q.shape
    hkv = k.shape[1]
    tp, dp = -(-t // 128) * 128, max(128, d)
    if seg is None and not causal:
        seg = kv_seg = np.zeros((b, t), np.int32)
    pad = lambda x: jnp.pad(jnp.asarray(x), [(0, 0), (0, 0), (0, tp - t), (0, dp - d)])
    q5 = pad(q).reshape(b, hkv, h // hkv, tp, dp)
    do5 = pad(do).reshape(b, hkv, h // hkv, tp, dp)
    q_seg = k_seg = None
    if seg is not None:
        segp = lambda s: jnp.pad(jnp.asarray(s), [(0, 0), (0, tp - t)], constant_values=-1)
        q_seg = jax.lax.broadcast_in_dim(segp(seg), (b, tp, 128), (0, 1))
        k_seg = jax.lax.broadcast_in_dim(segp(kv_seg), (b, 8, tp), (0, 2))
    cfg = FlashConfig(causal=causal, sm_scale=sm_scale, groups=h // hkv,
                      block_q=tp, block_k=tp, block_q_bwd=tp, block_k_bwd=tp,
                      has_segments=seg is not None, interpret=True)
    out5, lse5 = _fwd(q5, pad(k), pad(v), q_seg, k_seg, cfg)
    dq5, dk, dv = _bwd(q5, pad(k), pad(v), q_seg, k_seg, out5, lse5, do5, cfg)
    cut = lambda x, heads: np.asarray(x).reshape(b, heads, tp, dp)[:, :, :t, :d]
    return cut(dq5, h), cut(dk, hkv), cut(dv, hkv)


def _torch(*xs):
    return [None if x is None else torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


# (b, h, hkv, t, d, causal, segments)
CASES = [
    (2, 4, 2, 64, 64, True, None),
    (1, 14, 2, 100, 64, True, "packed"),
    (2, 7, 1, 192, 128, True, "packed"),
    (2, 7, 1, 192, 64, True, "left_padded"),
    (1, 14, 2, 256, 64, True, "packed"),
    (1, 4, 2, 100, 64, False, None),
    (2, 14, 2, 192, 128, False, "packed"),
    (1, 7, 1, 200, 64, False, "left_padded"),
]


def _case(b, h, hkv, t, d, causal, kind):
    q, k, v, do = _inputs(t + d + h, b, h, hkv, t, d)
    seg = _segments(kind, b, t)
    if seg is not None and not causal:
        do = do * (seg >= 0)[:, None, :, None]       # training's zero dO on pads
    return q, k, v, do, seg


@functools.lru_cache(maxsize=None)
def _case_grads(*case):
    """The Pallas gradients of a case, computed once for the tests that share it."""
    q, k, v, do, seg = _case(*case)
    return _jax_grads(q, k, v, do, seg, seg, case[5], case[4] ** -0.5)


@pytest.mark.parametrize("b,h,hkv,t,d,causal,kind", CASES)
def test_bwd_matches_pallas(b, h, hkv, t, d, causal, kind):
    q, k, v, do, seg = _case(b, h, hkv, t, d, causal, kind)
    want = _case_grads(b, h, hkv, t, d, causal, kind)
    tq, tk, tv, tdo, tseg = _torch(q, k, v, do, seg)
    out, lse = flash_attention_fwd(tq, tk, tv, segment_ids=tseg, causal=causal)
    got = flash_attention_bwd(tq, tk, tv, out, lse, tdo, segment_ids=tseg, causal=causal)
    plain = mha_reference_bwd(tq, tk, tv, tseg, tseg, out, lse, tdo, causal=causal)
    for name, g, p, w in zip(("dq", "dk", "dv"), got, plain, want):
        np.testing.assert_allclose(g.numpy(), w, **TOL, err_msg=name)
        np.testing.assert_array_equal(g.numpy(), p.numpy(), err_msg=name)


@pytest.mark.parametrize("b,h,hkv,t,d,causal,kind", CASES)
def test_autograd_function_matches_pallas(b, h, hkv, t, d, causal, kind):
    q, k, v, do, seg = _case(b, h, hkv, t, d, causal, kind)
    want = _case_grads(b, h, hkv, t, d, causal, kind)
    tq, tk, tv, tdo, tseg = _torch(q, k, v, do, seg)
    leaves = [x.requires_grad_() for x in (tq, tk, tv)]
    out = flash_attention(*leaves, segment_ids=tseg, causal=causal)
    out.backward(tdo)
    for name, x, w in zip(("dq", "dk", "dv"), leaves, want):
        np.testing.assert_allclose(x.grad.numpy(), w, **TOL, err_msg=name)


@pytest.mark.parametrize("b,h,hkv,t,d,causal,kind", [CASES[1]])
def test_grads_match_jax_public_entry(b, h, hkv, t, d, causal, kind):
    """jax.vjp through the JAX package's public `flash_attention` (custom VJP,
    interpret mode) against torch autograd through the port's."""
    q, k, v, do, seg = _case(b, h, hkv, t, d, causal, kind)
    _, vjp = jax.vjp(lambda a, b_, c: jax_flash_attention(
        a, b_, c, segment_ids=jnp.asarray(seg), causal=causal, interpret=True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo, tseg = _torch(q, k, v, do, seg)
    leaves = [x.requires_grad_() for x in (tq, tk, tv)]
    flash_attention(*leaves, segment_ids=tseg, causal=causal).backward(tdo)
    for name, x, w in zip(("dq", "dk", "dv"), leaves, want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), **TOL, err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_dead_rows_get_no_gradient(causal):
    """Query ids absent from the key ids (LSE +1e30): their P is 0, so their dq
    is exactly 0 and they add nothing to dk and dv — as in the Pallas kernel."""
    b, h, hkv, t, d = 1, 4, 2, 64, 64
    q, k, v, do = _inputs(11, b, h, hkv, t, d)
    q_seg = np.repeat([1, 0, 5, 1], [10, 10, 12, 32])[None].astype(np.int32)
    k_seg = np.repeat([0, 1], [32, 32])[None].astype(np.int32)
    want = _jax_grads(q, k, v, do, q_seg, k_seg, causal, d ** -0.5)
    tq, tk, tv, tdo, tqs, tks = _torch(q, k, v, do, q_seg, k_seg)
    out, lse = flash_attention_fwd(tq, tk, tv, segment_ids=tqs, causal=causal,
                                   kv_segment_ids=tks)
    got = flash_attention_bwd(tq, tk, tv, out, lse, tdo, segment_ids=tqs,
                              kv_segment_ids=tks, causal=causal)
    dead = q_seg[0] == 5
    if causal:   # rows 0..9 are in segment 1, whose keys all come later
        dead |= np.arange(t) < 10
    assert np.all(got[0].numpy()[:, :, dead] == 0.0)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w, **TOL, err_msg=name)


def test_cpu_backward_counts_no_launch():
    q, k, v, do = _torch(*_inputs(3, 1, 2, 1, 64, 64))
    before = flash_attention_bwd.launches
    out, lse = flash_attention_fwd(q, k, v)
    flash_attention_bwd(q, k, v, out, lse, do)
    assert flash_attention_bwd.launches == before


def test_backward_shape_checks():
    q, k, v, do = _torch(*_inputs(4, 1, 2, 1, 64, 64))
    out, lse = flash_attention_fwd(q, k, v)
    with pytest.raises(ValueError, match="must match"):
        flash_attention_bwd(q, k, v, out[:, :1], lse, do)
    with pytest.raises(ValueError, match="needs segment_ids"):
        flash_attention_bwd(q, k, v, out, lse, do,
                            kv_segment_ids=torch.zeros((1, 64), dtype=torch.int32))
