"""The CUDA flash-attention kernel against its plain version, on the card.

Skips where CUDA is absent. The card's host has no JAX, and tests/conftest.py
imports it, so run this file there without the conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Bounds (bf16 inputs, plain version in float32 from the same inputs): outputs
3e-2 absolute — the kernel rounds the probabilities and the output to bf16,
2 * 2^-8 relative on |out| < 4; LSE 2e-3 — float32 scores either way, the
sums run in another order.
"""
import numpy as np
import pytest
import torch

from slamkit_tpu_torch.ops import flash_attention, flash_attention_fwd, mha_reference

OUT_BOUND, LSE_BOUND = 3e-2, 2e-3


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
