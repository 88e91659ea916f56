"""The CUDA kernels (flash attention, dq_matmul, the probe) against their plain
versions, on the card.

Skips where CUDA is absent. The card's host has no JAX, and tests/conftest.py
imports it, so run this file there without the conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Bounds (bf16 inputs, plain version in float32 from the same inputs): outputs
3e-2 absolute — the kernel rounds the probabilities and the output to bf16,
2 * 2^-8 relative on |out| < 4; LSE 2e-3 — float32 scores either way, the
sums run in another order. Backward: max |kernel - plain| of dq, dk and dv
within 1e-2 of that gradient's max |plain|, plus 1e-5 for gradients that
are ~0 (T = 1: dS = P (dP - delta) cancels to f32 rounding) — the kernel
rounds P and dS to bf16 for its products (2^-9 relative each) and stores
bf16 gradients (2^-9 of the largest), the sums over T keys or queries run
in f32. And, kernel against plain on the same O and LSE, row by row, so
that a fault where gradients are small cannot hide under the largest:
||kernel row - plain row||_2 <= 2e-2 ||plain row||_2 + 1e-3 for every token
and head (the same roundings give ~2^-9 relative per row; 1e-3 covers rows
whose exact gradient cancels to 0).

The float32 forward (flash_fwd_f32.cu) against the same plain version on the
same float32 inputs: out and LSE within 1e-4 absolute. Both compute in
float32 (FMAs on the card's CUDA cores, expf; the plain version's float32
einsums with TF32 off) and differ by summation order alone, ~1e-6 relative
on |out| < 4 and LSE < 12; a bf16 or TF32 rounding anywhere would sit near
1e-3.
"""
import numpy as np
import pytest
import torch

from slamkit_tpu_torch.ops import (flash_attention, flash_attention_bwd,
                                   flash_attention_fwd, mha_reference, mha_reference_bwd)

OUT_BOUND, LSE_BOUND = 3e-2, 2e-3
F32_OUT_BOUND, F32_LSE_BOUND = 1e-4, 1e-4
BWD_REL_BOUND = 1e-2
BWD_ROW_RTOL, BWD_ROW_ATOL = 2e-2, 1e-3


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _inputs(dev, b, h, hkv, t, d, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda hh: torch.randn((b, hh, t, d), generator=g, device=dev).to(torch.bfloat16)
    return mk(h), mk(hkv), mk(hkv)


def _segments(kind, b, t, seed=0):
    rng = np.random.default_rng(seed)
    if kind is None:
        return None
    seg = np.zeros((b, t), np.int32)
    for r in range(b):
        if kind == "packed":
            cuts = np.sort(rng.choice(np.arange(1, t), min(5, t - 1), replace=False)) \
                if t > 1 else np.array([], int)
            for s, lo in enumerate(cuts):
                seg[r, lo:] = s + 1
            seg[r, t - int(rng.integers(0, max(1, t // 8))):] = -1
        elif kind == "segments16":  # 16-token segments packed end to end
            seg[r] = np.arange(t) // 16
        elif kind == "one":  # one segment over the whole row
            pass
        elif kind == "pad_tail":  # one segment, then a -1 tail
            seg[r, t - int(rng.integers(1, max(2, t // 3))):] = -1
        elif kind == "dpo":  # DPO's rows: one segment of 110..T tokens, a -1 tail
            seg[r, int(rng.integers(min(110, t), t + 1)):] = -1
        elif kind == "sims":  # SIMS's packed rows: segments of 40-160 and 300-700 tokens
            seg[r], col, s = -1, 0, 0
            while True:
                n = int(rng.integers(40, 160) if rng.random() < 0.4 else rng.integers(300, 700))
                if col + n > t:   # a last, shorter segment, then a tail of 1-39
                    n = t - col - int(rng.integers(1, 40))
                    if n > 0:
                        seg[r, col:col + n] = s
                    break
                seg[r, col:col + n] = s
                col, s = col + n, s + 1
        else:  # left padded
            seg[r, :int(rng.integers(0, t))] = -1
    return torch.from_numpy(seg)


def _compare(dev, b, h, hkv, t, d, causal, kind, kv_seg=None):
    q, k, v = _inputs(dev, b, h, hkv, t, d, seed=t + d)
    seg = _segments(kind, b, t, seed=t)
    seg = None if seg is None else seg.to(dev)
    before = flash_attention_fwd.launches
    out, lse = flash_attention_fwd(q, k, v, segment_ids=seg, causal=causal,
                                   kv_segment_ids=kv_seg)
    assert flash_attention_fwd.launches == before + 1
    ref, ref_lse = mha_reference(q.float(), k.float(), v.float(), segment_ids=seg,
                                 causal=causal, kv_segment_ids=kv_seg)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert lse.dtype == torch.float32 and lse.shape == (b, h, t)
    dead = ref_lse == 1e30
    assert torch.equal(lse == 1e30, dead)
    assert bool((out[dead] == 0).all())
    alive = ~dead
    if alive.any():
        assert (out.float() - ref)[alive].abs().max().item() <= OUT_BOUND
        assert (lse - ref_lse)[alive].abs().max().item() <= LSE_BOUND
    return dead


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,hkv,t,d", [
    (8, 14, 2, 1024, 64), (8, 14, 2, 128, 64), (8, 14, 2, 1000, 64),
    (8, 7, 1, 1024, 128), (1, 4, 4, 1, 64), (2, 4, 1, 17, 128), (2, 6, 2, 65, 64),
    (1, 2, 2, 2048, 64),
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kind", [None, "packed", "left_padded"])
def test_kernel_matches_plain(dev, b, h, hkv, t, d, causal, kind):
    _compare(dev, b, h, hkv, t, d, causal, kind)


# the forward's tile list and its interior (unmasked) tiles: T under one
# tile and one past it, 64 segments of 16 tokens (every tile masked), one
# segment over the row (every tile below the diagonal interior), a -1 tail,
# left padding; d = 128 with G = 7
@pytest.mark.cuda
@pytest.mark.parametrize("b,h,hkv,t,d", [
    (2, 14, 2, 40, 64), (2, 14, 2, 65, 64), (2, 14, 2, 1024, 64), (2, 7, 1, 1024, 128),
    (2, 7, 1, 65, 128),
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kind", ["segments16", "one", "pad_tail", "left_padded"])
def test_kernel_matches_plain_at_segment_layouts(dev, b, h, hkv, t, d, causal, kind):
    _compare(dev, b, h, hkv, t, d, causal, kind)


# DPO's batch at the Slam shape: 2 x 8 rows (chosen over rejected) of prompt
# 101 + completion 51 = 152 tokens, each one segment and a -1 tail
@pytest.mark.cuda
@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_kernels_match_plain_at_dpo_rows(dev, direction):
    if direction == "forward":
        _compare(dev, 16, 14, 2, 152, 64, True, "dpo")
    else:
        _compare_bwd(dev, 16, 14, 2, 152, 64, True, "dpo")


# SIMS's training batch (config/train_inter_scale.yaml): [4, 14/2, 2048, 64],
# rows best-fit packed from stage 2's short interleaved rows among text and
# speech rows of 300-700 tokens, then a -1 tail; each kernel twice, bitwise
@pytest.mark.cuda
@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_kernels_match_plain_at_sims_rows(dev, direction):
    if direction == "forward":
        first = _compare(dev, 4, 14, 2, 2048, 64, True, "sims")
        again = _compare(dev, 4, 14, 2, 2048, 64, True, "sims")
        assert torch.equal(first, again)
        q, k, v = _inputs(dev, 4, 14, 2, 2048, 64, seed=2048 + 64)
        seg = _segments("sims", 4, 2048, seed=2048).to(dev)
        a = flash_attention_fwd(q, k, v, segment_ids=seg)
        b = flash_attention_fwd(q, k, v, segment_ids=seg)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    else:
        got = _compare_bwd(dev, 4, 14, 2, 2048, 64, True, "sims")
        again = _compare_bwd(dev, 4, 14, 2, 2048, 64, True, "sims")
        assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,hkv,t,d", [(8, 14, 2, 1024, 64), (8, 7, 1, 1024, 128)])
def test_kernel_is_deterministic(dev, b, h, hkv, t, d):
    """No atomics, no split of the keys: two calls on the same inputs give
    bitwise-equal out and LSE."""
    q, k, v = _inputs(dev, b, h, hkv, t, d, seed=6)
    seg = _segments("packed", b, t, seed=7).to(dev)
    first = flash_attention_fwd(q, k, v, segment_ids=seg)
    second = flash_attention_fwd(q, k, v, segment_ids=seg)
    torch.cuda.synchronize()
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_dead_rows(dev, causal):
    """Query ids 7 never appear among the keys: those rows output exactly 0
    with LSE +1e30; every other row matches the plain version."""
    b, t = 2, 256
    seg = torch.zeros((b, t), dtype=torch.int32, device=dev)
    seg[:, 100:140] = 7
    kv_seg = torch.zeros_like(seg)
    q, k, v = _inputs(dev, b, 14, 2, t, 64)
    out, lse = flash_attention_fwd(q, k, v, segment_ids=seg, causal=causal,
                                   kv_segment_ids=kv_seg)
    ref, ref_lse = mha_reference(q.float(), k.float(), v.float(), segment_ids=seg,
                                 causal=causal, kv_segment_ids=kv_seg)
    torch.cuda.synchronize()
    assert bool((out[:, :, 100:140] == 0).all()) and bool((lse[:, :, 100:140] == 1e30).all())
    assert torch.equal(lse == 1e30, ref_lse == 1e30)
    alive = ref_lse < 1e30
    assert int(alive.sum()) == b * 14 * (t - 40)
    assert (out.float() - ref)[alive].abs().max().item() <= OUT_BOUND
    assert (lse - ref_lse)[alive].abs().max().item() <= LSE_BOUND


def _compare_f32(dev, b, h, hkv, t, d, kind, causal=True):
    """The float32 kernel against the plain version; returns (out, lse)."""
    q, k, v = (x.float() for x in _inputs(dev, b, h, hkv, t, d, seed=3 * t + d))
    seg = _segments(kind, b, t, seed=t + 1)
    seg = None if seg is None else seg.to(dev)
    before = flash_attention_fwd.f32_launches, flash_attention_fwd.launches
    out, lse = flash_attention_fwd(q, k, v, segment_ids=seg, causal=causal)
    assert (flash_attention_fwd.f32_launches, flash_attention_fwd.launches) == (
        before[0] + 1, before[1])
    ref, ref_lse = mha_reference(q, k, v, segment_ids=seg, causal=causal)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and out.shape == q.shape
    assert lse.dtype == torch.float32 and lse.shape == (b, h, t)
    dead = ref_lse == 1e30
    assert torch.equal(lse == 1e30, dead) and bool((out[dead] == 0).all())
    alive = ~dead
    assert (out - ref)[alive].abs().max().item() <= F32_OUT_BOUND
    assert (lse - ref_lse)[alive].abs().max().item() <= F32_LSE_BOUND
    again = flash_attention_fwd(q, k, v, segment_ids=seg, causal=causal)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    return out, lse


# the text LM's scoring and the judge's prefill (Llama-3.2-1B, 32/8 heads of
# 64, float32): right-padded rows as log_likelihood pads them, left-padded
# prompts, packed rows, d = 128 with G = 4, T off the tile size
@pytest.mark.cuda
@pytest.mark.parametrize("b,h,hkv,t,d", [
    (8, 32, 8, 512, 64), (2, 32, 8, 130, 64), (2, 8, 2, 512, 128), (1, 4, 1, 1, 64),
    (2, 8, 2, 65, 128),
])
@pytest.mark.parametrize("kind", [None, "packed", "pad_tail", "left_padded"])
def test_f32_kernel_matches_plain(dev, b, h, hkv, t, d, kind):
    _compare_f32(dev, b, h, hkv, t, d, kind)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", [None, "packed"])
def test_f32_kernel_matches_plain_noncausal(dev, kind):
    _compare_f32(dev, 2, 8, 2, 200, 64, kind, causal=False)


@pytest.mark.cuda
def test_f32_kernel_dead_rows_and_gradient_refusal(dev):
    """Query ids 7 never appear among the keys: out 0 and LSE +1e30; a
    float32 input that needs a gradient raises (no float32 backward)."""
    b, t = 2, 256
    seg = torch.zeros((b, t), dtype=torch.int32, device=dev)
    seg[:, 100:140] = 7
    q, k, v = (x.float() for x in _inputs(dev, b, 8, 2, t, 64))
    out, lse = flash_attention_fwd(q, k, v, segment_ids=seg,
                                   kv_segment_ids=torch.zeros_like(seg))
    assert bool((out[:, :, 100:140] == 0).all()) and bool((lse[:, :, 100:140] == 1e30).all())
    assert bool((lse[:, :, :100] < 1e30).all())
    with pytest.raises(NotImplementedError, match="float32 backward"):
        flash_attention(q.requires_grad_(), k, v)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(dev):
    q, k, v = _inputs(dev, 1, 2, 1, 64, 64)
    with pytest.raises(TypeError, match="bfloat16"):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError, match="bfloat16"):
        flash_attention(q.float(), k, v)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q[..., :32].contiguous(), k[..., :32].contiguous(),
                        v[..., :32].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3), k, v)


def _grad_errors(got, want):
    """(name, max |kernel - plain|, its bound, worst row's error over its
    row bound) for each of dq, dk, dv."""
    rows = []
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16 and a.shape == w.shape, name
        assert bool(torch.isfinite(a).all()), name
        diff = a.float() - w
        row_bound = BWD_ROW_RTOL * w.norm(dim=-1) + BWD_ROW_ATOL
        rows.append((name, diff.abs().max().item(),
                     BWD_REL_BOUND * w.abs().max().item() + 1e-5,
                     (diff.norm(dim=-1) / row_bound).max().item()))
    return rows


def _compare_bwd(dev, b, h, hkv, t, d, causal, kind, kv_seg=None, seg=None):
    q, k, v = _inputs(dev, b, h, hkv, t, d, seed=t + d)
    g = torch.Generator(device=dev).manual_seed(t + 1)
    do = torch.randn((b, h, t, d), generator=g, device=dev).to(torch.bfloat16)
    if seg is None:
        seg = _segments(kind, b, t, seed=t)
        seg = None if seg is None else seg.to(dev)
    out, lse = flash_attention_fwd(q, k, v, segment_ids=seg, causal=causal,
                                   kv_segment_ids=kv_seg)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, out, lse, do, segment_ids=seg,
                              kv_segment_ids=kv_seg, causal=causal)
    assert flash_attention_bwd.launches == before + 1
    want = mha_reference_bwd(q.float(), k.float(), v.float(), seg, kv_seg, out.float(),
                             lse, do.float(), causal=causal)
    torch.cuda.synchronize()
    for name, err, bound, worst_row in _grad_errors(got, want):
        assert err <= bound, (name, err, bound)
        assert worst_row <= 1, (name, "worst row error over its bound", worst_row)
    return got


# G = H / Hkv: 7 (Slam, slam_dh128), 1, 4, 3, 2, and past the portable
# cluster size of 8: 16 (clusters of 8, each CTA walking 2 heads) and 11
# (prime: one CTA walks all 11)
@pytest.mark.cuda
@pytest.mark.parametrize("b,h,hkv,t,d", [
    (8, 14, 2, 1024, 64), (8, 14, 2, 1000, 64), (8, 7, 1, 1024, 128),
    (4, 14, 2, 2048, 64), (1, 4, 4, 1, 64), (2, 4, 1, 17, 128), (2, 6, 2, 65, 64),
    (2, 7, 1, 200, 128), (2, 4, 2, 300, 64), (1, 16, 1, 200, 64), (1, 11, 1, 129, 128),
    (2, 16, 1, 97, 128),
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kind", [None, "packed", "left_padded"])
def test_backward_kernel_matches_plain(dev, b, h, hkv, t, d, causal, kind):
    _compare_bwd(dev, b, h, hkv, t, d, causal, kind)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,hkv,t,d", [(8, 14, 2, 1024, 64), (2, 7, 1, 333, 128),
                                         (1, 16, 1, 200, 64)])
def test_backward_kernel_is_deterministic(dev, b, h, hkv, t, d):
    """No atomics: two calls on the same inputs give bitwise-equal dq, dk, dv
    (the resumed training run repeats a step exactly only so)."""
    q, k, v = _inputs(dev, b, h, hkv, t, d, seed=3)
    do = _inputs(dev, b, h, h, t, d, seed=4)[0]
    seg = _segments("packed", b, t, seed=5).to(dev)
    out, lse = flash_attention_fwd(q, k, v, segment_ids=seg)
    first = flash_attention_bwd(q, k, v, out, lse, do, segment_ids=seg)
    second = flash_attention_bwd(q, k, v, out, lse, do, segment_ids=seg)
    torch.cuda.synchronize()
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_backward_dead_rows(dev, causal):
    """Query ids 7 never appear among the keys: those rows' P is exactly 0, so
    their dq is exactly 0, and they add nothing to dk and dv."""
    b, t = 2, 256
    seg = torch.zeros((b, t), dtype=torch.int32, device=dev)
    seg[:, 100:140] = 7
    kv_seg = torch.zeros_like(seg)
    dq, _, _ = _compare_bwd(dev, b, 14, 2, t, 64, causal, None, kv_seg=kv_seg, seg=seg)
    assert bool((dq[:, :, 100:140] == 0).all())


@pytest.mark.cuda
def test_autograd_function_runs_both_kernels(dev):
    """Gradients through `flash_attention` under autograd come from the
    backward kernel, one launch per backward."""
    q, k, v = (x.requires_grad_() for x in _inputs(dev, 2, 14, 2, 256, 64))
    seg = _segments("packed", 2, 256).to(dev)
    fwd0, bwd0 = flash_attention_fwd.launches, flash_attention_bwd.launches
    out = flash_attention(q, k, v, segment_ids=seg)
    (out.float() * torch.linspace(-1, 1, 64, device=dev)).sum().backward()
    assert flash_attention_fwd.launches == fwd0 + 1
    assert flash_attention_bwd.launches == bwd0 + 1
    qf, kf, vf = (x.detach().float().requires_grad_() for x in (q, k, v))
    out_ref, _ = mha_reference(qf, kf, vf, segment_ids=seg)
    (out_ref * torch.linspace(-1, 1, 64, device=dev)).sum().backward()
    torch.cuda.synchronize()
    # the plain side runs its forward in float32 too, so delta differs by the
    # bf16 rounding of O: only the whole-tensor bound applies, not the row one
    for name, err, bound, _ in _grad_errors((q.grad, k.grad, v.grad),
                                            (qf.grad, kf.grad, vf.grad)):
        assert err <= bound, (name, err, bound)


@pytest.mark.cuda
def test_backward_kernel_refuses_what_it_does_not_take(dev):
    q, k, v = _inputs(dev, 1, 2, 1, 64, 64)
    out, lse = flash_attention_fwd(q, k, v)
    with pytest.raises(TypeError, match="bfloat16"):
        flash_attention_bwd(q.float(), k.float(), v.float(), out.float(), lse, out.float())
    with pytest.raises(ValueError, match="head dim"):
        s = lambda x: x[..., :32].contiguous()
        flash_attention_bwd(s(q), s(k), s(v), s(out), lse, s(out))
    with pytest.raises(ValueError, match="must be on"):
        flash_attention_bwd(q, k, v, out, lse.cpu(), out)
    with pytest.raises(ValueError, match="several devices"):
        flash_attention_bwd(q, k.cpu(), v, out, lse, out)
    with pytest.raises(ValueError, match="lse must be"):
        flash_attention_bwd(q, k, v, out, lse[:, :1].contiguous(), out)
    with pytest.raises(ValueError, match="must match"):
        flash_attention_bwd(q, k, v, out[:, :, :32].contiguous(), lse, out)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_bwd(q, k, v, out, lse, out.transpose(2, 3).contiguous().transpose(2, 3))


# --------------------------------------------------------------------------- #
# dq_matmul and the probe kernel
# --------------------------------------------------------------------------- #
SLAM_KN = [(896, 896), (896, 128), (896, 4864), (4864, 896)]


def _dq_inputs(dev, m, k, n, seed=0):
    from slamkit_tpu_torch.ops import quantize_weight

    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    q, s = quantize_weight(torch.randn((k, n), generator=g, device=dev) * 0.02)
    return x, q, s


# the decode GEMV at M = 1, 3, 8, 16 and the prefill at 17 (one warpgroup),
# 600 (8 x 75: the smoke's int8 prefill), 1000 and 1024 over the Slam (K, N)
# pairs; ragged N (not a multiple of 16, or of 8), and K that does not split
# evenly over the cluster (904 = 8 x 113: slices of 120 rows and a last of
# 64) nor into the prefill's 64-deep steps (904 = 14 x 64 + 8)
@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(m, k, n) for m in (1, 3, 8, 16, 17, 600, 1000, 1024)
                                   for k, n in SLAM_KN]
                         + [(5, 64, 250), (3, 72, 131), (17, 896, 250),
                            (1000, 896, 130), (100, 72, 896), (64, 4864, 128),
                            (8, 904, 896), (16, 904, 250), (3, 4864, 131), (16, 8, 4864),
                            (12, 896, 4868), (17, 904, 896), (600, 904, 4864),
                            (1000, 904, 250), (1024, 904, 131), (1024, 896, 4868),
                            (65, 904, 130)])
def test_dq_matmul_kernel_matches_plain(dev, m, k, n):
    from slamkit_tpu_torch.ops import dq_matmul, dq_matmul_reference
    from slamkit_tpu_torch.ops.quant import ulp_bound

    x, q, s = _dq_inputs(dev, m, k, n, seed=m + k + n)
    before = dq_matmul.launches
    got = dq_matmul(x, q, s)
    assert dq_matmul.launches == before + 1
    want = dq_matmul_reference(x, q, s)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    got, want = got.float(), want.float()
    assert bool(((got - want).abs() <= ulp_bound(got, want)).all()), \
        (got - want).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(8, 896, 4864), (16, 4864, 896), (3, 904, 131),
                                   (1024, 896, 4864), (1024, 4864, 896), (600, 896, 128),
                                   (17, 904, 250)])
def test_dq_matmul_kernel_is_deterministic(dev, m, k, n):
    """The decode GEMV sums its split of K in a fixed order (no atomics) and
    the prefill GEMM takes K in one pass: two calls give bitwise-equal
    outputs."""
    from slamkit_tpu_torch.ops import dq_matmul

    x, q, s = _dq_inputs(dev, m, k, n, seed=7)
    first, second = dq_matmul(x, q, s), dq_matmul(x, q, s)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_dq_matmul_kernel_refuses_what_it_does_not_take(dev):
    from slamkit_tpu_torch.ops import dq_matmul

    x, q, s = _dq_inputs(dev, 8, 64, 128)
    with pytest.raises(TypeError, match="bfloat16"):
        dq_matmul(x.float(), q, s)
    with pytest.raises(ValueError, match="several devices"):
        dq_matmul(x, q.cpu(), s)
    with pytest.raises(ValueError, match="disagree on K"):
        dq_matmul(x[:, :32].contiguous(), q, s)
    with pytest.raises(ValueError, match="multiple of 8"):
        dq_matmul(x[:, :60].contiguous(), q[:60].contiguous(), s)
    with pytest.raises(ValueError, match="contiguous"):
        dq_matmul(x, q.t().contiguous().t(), s)
    with pytest.raises(TypeError, match="int8"):
        dq_matmul(x, q.float(), s)
    with pytest.raises(ValueError, match="s must be"):
        dq_matmul(x, q, s[:, :64].contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,reps", [(1024, 64, 1024, 64), (1024, 128, 1024, 64),
                                        (1024, 1024, 64, 64), (1024, 1024, 128, 64),
                                        (64, 32, 64, 1), (128, 96, 192, 3)])
def test_probe_kernel_matches_plain(dev, m, k, n, reps):
    """Within `error_bound(K, reps)` of max |plain| (the reason is there:
    the tensor cores truncate each step into the kernel's one float32 sum)."""
    from slamkit_tpu_torch.ops import matmul_probe, matmul_probe_reference
    from slamkit_tpu_torch.ops.matmul_probe import error_bound

    g = torch.Generator(device=dev).manual_seed(m + k + n)
    a = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    b = torch.randn((k, n), generator=g, device=dev).to(torch.bfloat16)
    before = matmul_probe.launches
    got = matmul_probe(a, b, reps)
    assert matmul_probe.launches == before + 1
    want = matmul_probe_reference(a, b, reps)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (m, n)
    assert (got - want).abs().max().item() <= error_bound(k, reps) * want.abs().max().item()


@pytest.mark.cuda
def test_probe_kernel_refuses_what_it_does_not_take(dev):
    from slamkit_tpu_torch.ops import matmul_probe

    a = torch.zeros((64, 64), dtype=torch.bfloat16, device=dev)
    with pytest.raises(TypeError, match="bfloat16"):
        matmul_probe(a.float(), a.float())
    with pytest.raises(ValueError, match="multiples"):
        matmul_probe(a[:48].contiguous(), a)
    with pytest.raises(ValueError, match="several devices"):
        matmul_probe(a, a.cpu())
