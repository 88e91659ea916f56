"""The port's flash attention (plain version on CPU) against the JAX package's
Pallas kernel run in interpret mode, in float32: output and row log-sum-exp,
causal and non-causal, GQA, ragged T, d 64/128, packed segments with -1 pads,
the left-padded prefill pattern, and dead rows.

Tolerance: 2e-5 absolute and relative on outputs and LSE — both sides are
float32 softmax attention and differ only in summation order (the JAX kernel
is blocked, the plain version is one einsum), as in tests/test_flash_attention.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamkit_tpu.ops import flash_attention as jax_flash_attention
from slamkit_tpu.ops.flash_attention import FlashConfig, _fwd
from slamkit_tpu_torch.ops import flash_attention, flash_attention_fwd, mha_reference

# the gate runs several pytest workers on the CPU's cores: one torch thread
# each keeps their thread pools from oversubscribing the cores
torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-5)


def _qkv(seed, b, h, hkv, t, d):
    rng = np.random.default_rng(seed)
    mk = lambda hh: (rng.standard_normal((b, hh, t, d)) * 0.5).astype(np.float32)
    return mk(h), mk(hkv), mk(hkv)


def _packed(b, lens):
    """[b, sum(lens)] segment ids 0, 1, ... with -1 for a trailing pad run
    (the last length); row i rotates the real segment lengths by i."""
    real, tail = list(lens[:-1]), lens[-1]
    rows = [np.repeat(np.r_[np.arange(len(real)), -1], real[i:] + real[:i] + [tail])
            for i in range(b)]
    return np.stack(rows).astype(np.int32)


def _left_padded(b, t, n_pad):
    seg = np.zeros((b, t), np.int32)
    for i, n in enumerate(n_pad):
        seg[i, :n] = -1
    return seg


def _jax_fwd(q, k, v, seg, kv_seg, causal, sm_scale):
    """Out and LSE straight from the Pallas `_fwd` (interpret mode), with the
    public wrapper's padding: T up to a 128 multiple (one block), D to 128
    lanes, padded keys masked by a -1 segment id (or by causality)."""
    b, h, t, d = q.shape
    hkv = k.shape[1]
    tp, dp = -(-t // 128) * 128, max(128, d)
    if seg is None and not causal:
        seg = kv_seg = np.zeros((b, t), np.int32)
    pad = lambda x: jnp.pad(jnp.asarray(x), [(0, 0), (0, 0), (0, tp - t), (0, dp - d)])
    q5 = pad(q).reshape(b, hkv, h // hkv, tp, dp)
    q_seg = k_seg = None
    if seg is not None:
        segp = lambda s: jnp.pad(jnp.asarray(s), [(0, 0), (0, tp - t)], constant_values=-1)
        q_seg = jax.lax.broadcast_in_dim(segp(seg), (b, tp, 128), (0, 1))
        k_seg = jax.lax.broadcast_in_dim(segp(kv_seg), (b, 8, tp), (0, 2))
    cfg = FlashConfig(causal=causal, sm_scale=sm_scale, groups=h // hkv,
                      block_q=tp, block_k=tp, block_q_bwd=tp, block_k_bwd=tp,
                      has_segments=seg is not None, interpret=True)
    out5, lse5 = _fwd(q5, pad(k), pad(v), q_seg, k_seg, cfg)
    out = np.asarray(out5).reshape(b, h, tp, dp)[:, :, :t, :d]
    return out, np.asarray(lse5).reshape(b, h, tp)[:, :, :t]


def _port(q, k, v, seg, causal, kv_seg=None):
    t = lambda x: None if x is None else torch.from_numpy(x)
    out, lse = flash_attention_fwd(t(q), t(k), t(v), segment_ids=t(seg), causal=causal,
                                   kv_segment_ids=t(kv_seg))
    return out.numpy(), lse.numpy()


# (b, h, hkv, t, d, causal, segments)
CASES = [
    (2, 4, 2, 64, 64, True, None),
    (1, 7, 1, 100, 128, True, "packed"),
    (2, 4, 2, 192, 64, True, "packed"),
    (2, 7, 1, 192, 64, True, "left_padded"),
    (1, 4, 2, 100, 64, False, None),
    (2, 4, 2, 192, 128, False, "packed"),
    (1, 7, 1, 64, 64, False, "left_padded"),
]


def _segments(kind, b, t):
    if kind == "packed":
        third = t // 3
        return _packed(b, [third, t - 2 * third - 7, third, 7])
    if kind == "left_padded":
        return _left_padded(b, t, [t // 2, 3][:b])
    return None


@pytest.mark.parametrize("b,h,hkv,t,d,causal,kind", CASES)
def test_fwd_out_and_lse_match_pallas(b, h, hkv, t, d, causal, kind):
    q, k, v = _qkv(t + d + h, b, h, hkv, t, d)
    seg = _segments(kind, b, t)
    want_out, want_lse = _jax_fwd(q, k, v, seg, seg, causal, d ** -0.5)
    out, lse = _port(q, k, v, seg, causal)
    rows = np.ones((b, t), bool) if (causal or seg is None) else seg >= 0
    # non-causal: the JAX wrapper's -1 tail padding lets -1 query rows also
    # see the zero-padded keys; the port masks keys >= T. Compare rows with
    # a segment id >= 0 only (recorded in ROADMAP queue 3).
    np.testing.assert_allclose(out.transpose(0, 2, 1, 3)[rows],
                               want_out.transpose(0, 2, 1, 3)[rows], **TOL)
    np.testing.assert_allclose(lse.transpose(0, 2, 1)[rows],
                               want_lse.transpose(0, 2, 1)[rows], **TOL)


@pytest.mark.parametrize("b,h,hkv,t,d,causal,kind", [CASES[1], CASES[3], CASES[4]])
def test_public_entry_matches_jax_flash_attention(b, h, hkv, t, d, causal, kind):
    q, k, v = _qkv(7 * t + d, b, h, hkv, t, d)
    seg = _segments(kind, b, t)
    want = np.asarray(jax_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        segment_ids=None if seg is None else jnp.asarray(seg),
        causal=causal, interpret=True))
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          segment_ids=None if seg is None else torch.from_numpy(seg),
                          causal=causal).numpy()
    rows = np.ones((b, t), bool) if (causal or seg is None) else seg >= 0
    np.testing.assert_allclose(got.transpose(0, 2, 1, 3)[rows],
                               want.transpose(0, 2, 1, 3)[rows], **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_dead_rows_zero_output_and_sentinel_lse(causal):
    """Query ids absent from the key ids attend nowhere: exactly 0 output and
    LSE +1e30, as the Pallas kernel writes them."""
    b, h, hkv, t, d = 1, 4, 2, 64, 64
    q, k, v = _qkv(11, b, h, hkv, t, d)
    q_seg = np.repeat([1, 0, 5, 1], [10, 10, 12, 32])[None].astype(np.int32)
    k_seg = np.repeat([0, 1], [32, 32])[None].astype(np.int32)
    want_out, want_lse = _jax_fwd(q, k, v, q_seg, k_seg, causal, d ** -0.5)
    out, lse = _port(q, k, v, q_seg, causal, kv_seg=k_seg)
    dead = q_seg[0] == 5
    if causal:   # rows 0..9 are in segment 1, whose keys all come later
        dead |= np.arange(t) < 10
    assert np.all(out[:, :, dead] == 0.0)
    assert np.all(lse[:, :, dead] == 1e30)
    np.testing.assert_array_equal(want_lse[:, :, dead], lse[:, :, dead])
    np.testing.assert_allclose(out, want_out, **TOL)
    np.testing.assert_allclose(lse[:, :, ~dead], want_lse[:, :, ~dead], **TOL)


def test_cpu_path_does_not_count_launches():
    q, k, v = (torch.from_numpy(x) for x in _qkv(3, 1, 2, 1, 64, 64))
    before = flash_attention_fwd.launches, flash_attention_fwd.f32_launches
    flash_attention(q, k, v, causal=True)
    assert (flash_attention_fwd.launches, flash_attention_fwd.f32_launches) == before


def _right_padded(b, t, seed=0):
    """[b, t] ids as `UnitLM.log_likelihood` builds them for padded text:
    0 on each row's first 40..t tokens, -1 on its right pads."""
    rng = np.random.default_rng(seed)
    seg = np.full((b, t), -1, np.int32)
    for r in range(b):
        seg[r, :int(rng.integers(40, t + 1))] = 0
    return seg


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("kind", ["packed", "right_padded"])
def test_f32_forward_at_the_text_lm_rows_matches_pallas(d, kind):
    """The float32 forward's plain version (what the CUDA float32 kernel is
    held to on the card) against the Pallas `_fwd` run on float32 inputs in
    interpret mode, at the text LM's pattern: GQA 4 (8 q heads over 2 kv
    heads, Llama-3.2-1B's 32/8), causal, rows right-padded with -1 or packed;
    float32 in, float32 out."""
    b, h, hkv, t = 2, 8, 2, 160
    q, k, v = _qkv(d + len(kind), b, h, hkv, t, d)
    seg = _right_padded(b, t) if kind == "right_padded" else _segments("packed", b, t)
    want_out, want_lse = _jax_fwd(q, k, v, seg, seg, True, d ** -0.5)
    out, lse = _port(q, k, v, seg, True)
    assert out.dtype == np.float32 and lse.dtype == np.float32
    np.testing.assert_allclose(out, want_out, **TOL)
    np.testing.assert_allclose(lse, want_lse, **TOL)


def test_gqa_matches_repeated_heads():
    """kv-major GQA without repeats equals attention over repeat_interleave'd
    kv heads."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(5, 2, 6, 2, 96, 64))
    out, lse = mha_reference(q, k, v, causal=True)
    out_r, lse_r = mha_reference(q, k.repeat_interleave(3, 1), v.repeat_interleave(3, 1),
                                 causal=True)
    torch.testing.assert_close(out, out_r, **TOL)
    torch.testing.assert_close(lse, lse_r, **TOL)


@pytest.mark.parametrize("shapes,match", [
    (((1, 4, 64, 64), (1, 3, 64, 64)), "multiple of kv heads"),
    (((1, 4, 64, 64), (1, 2, 32, 64)), "do not match"),
])
def test_shape_checks(shapes, match):
    q, k = (torch.zeros(s) for s in shapes)
    with pytest.raises(ValueError, match=match):
        flash_attention(q, k, k)



@pytest.mark.parametrize("what", ["forward", "backward"])
@pytest.mark.parametrize("given,ok", [
    ((torch.bfloat16,) * 3, True),
    ((torch.float32,) * 3, True),
    ((torch.float16,) * 3, False),
    ((torch.float32, torch.bfloat16, torch.bfloat16), False),
])
def test_kernel_dtype_check(what, given, ok):
    """The one dtype check before a kernel launch, on CPU tensors (it reads
    dtypes only): q, k and v of one dtype, bf16 or float32 (each direction
    has a kernel of each), else a TypeError naming what it takes."""
    from slamkit_tpu_torch.ops.flash_attention import _check_kernel_inputs

    q, k, v = (torch.zeros((1, 2, 64, 64), dtype=dt) for dt in given)
    if ok:
        _check_kernel_inputs(what, q=q, k=k, v=v)
    else:
        with pytest.raises(TypeError, match="bfloat16 or float32"):
            _check_kernel_inputs(what, q=q, k=k, v=v)
