"""The CUDA flash-attention kernels against their plain versions, on the card.

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
"""
import numpy as np
import pytest
import torch

from slamkit_tpu_torch.ops import (flash_attention, flash_attention_bwd,
                                   flash_attention_fwd, mha_reference, mha_reference_bwd)

OUT_BOUND, LSE_BOUND = 3e-2, 2e-3
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


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(dev):
    q, k, v = _inputs(dev, 1, 2, 1, 64, 64)
    with pytest.raises(TypeError, match="bfloat16"):
        flash_attention(q.float(), k.float(), v.float())
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


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,hkv,t,d", [
    (8, 14, 2, 1024, 64), (8, 14, 2, 1000, 64), (8, 7, 1, 1024, 128),
    (4, 14, 2, 2048, 64), (1, 4, 4, 1, 64), (2, 4, 1, 17, 128), (2, 6, 2, 65, 64),
    (2, 7, 1, 200, 128),
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kind", [None, "packed", "left_padded"])
def test_backward_kernel_matches_plain(dev, b, h, hkv, t, d, causal, kind):
    _compare_bwd(dev, b, h, hkv, t, d, causal, kind)


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
