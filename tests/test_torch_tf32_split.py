"""The arithmetic of the float32 flash kernels' tensor-core products, emulated
on the CPU: 3xTF32 (`ops/csrc/flash_fwd_f32.cu`, `flash_bwd_f32.cu`).

Each float32 operand x is split into hi = tf32(x) and lo = tf32(x - hi),
where tf32 rounds the mantissa to 10 bits, to nearest with ties away from
zero (`cvt.rna.tf32.f32`), and a product a b is taken as
lo_a hi_b + hi_a lo_b + hi_a hi_b summed in float32 (the products of two
TF32 values are exact in float32; only lo_a lo_b and the rounding of each lo
are dropped, ~2^-22 of |a b|). P and dS are split as float32, never rounded
to bf16.

The emulation sums in float32 rounded to nearest. The tensor cores add to
their accumulator without that rounding, a bias that grows with the number
of adds; the kernels keep it to one tile's adds by starting each tile's
product from zero and adding it to the running sum in float32, which this
emulation's einsums stand for.

The emulated attention forward and backward are held to the plain float32
versions (`ops/attention_ref.py`) with the float32 kernels' own bounds from
`tests/test_torch_cuda.py` and `chip_smoke.py` phases 3e / 3f: out and LSE
within 1e-4 absolute, and each of dq, dk, dv within 16 eps32 sqrt(G T) of
that gradient's max |plain| (+1e-5). A single TF32 product (hi_a hi_b: a
10-bit mantissa, ~2^-11 a rounding) must fall outside the same bounds, so
the bounds tell the two apart.
"""
import math

import numpy as np
import pytest
import torch

from slamkit_tpu_torch.ops import mha_reference, mha_reference_bwd
from slamkit_tpu_torch.ops.attention_ref import LSE_SENTINEL, attention_mask

torch.set_num_threads(1)

F32_OUT_BOUND, F32_LSE_BOUND = 1e-4, 1e-4
F32_EPS, F32_BWD_FACTOR = 2.0 ** -23, 16.0


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest value with a 10-bit mantissa, ties away from
    zero: add half of the 13 dropped bits' unit to the magnitude, then clear
    them (finite inputs)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def einsum_3xtf32(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    (a_hi, a_lo), (b_hi, b_lo) = split(a.float()), split(b.float())
    return (torch.einsum(spec, a_lo, b_hi) + torch.einsum(spec, a_hi, b_lo)
            + torch.einsum(spec, a_hi, b_hi))


def einsum_1xtf32(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.einsum(spec, tf32(a.float()), tf32(b.float()))


def _mask(seg, t, causal):
    m = attention_mask(t, t, causal=causal, q_segment_ids=seg, k_segment_ids=seg)
    return m[:, :, None] if m.dim() == 4 else m


def emulated_fwd(q, k, v, seg, causal, mm):
    """mha_reference with both products taken by `mm`."""
    b, h, t, d = q.shape
    hkv = k.shape[1]
    q5 = q.reshape(b, hkv, h // hkv, t, d)
    s = mm("bkgqd,bktd->bkgqt", q5, k) * d ** -0.5
    mask = _mask(seg, t, causal)
    s = s.masked_fill(~mask, -1e30)
    alive = mask.any(dim=-1).expand(s.shape[:-1])
    lse = torch.where(alive, torch.logsumexp(s, dim=-1), torch.full((), LSE_SENTINEL))
    p = torch.exp(s - lse[..., None])
    out = mm("bkgqt,bktd->bkgqd", p, v)
    return out.reshape(b, h, t, d), lse.reshape(b, h, t)


def emulated_bwd(q, k, v, seg, out, lse, do, causal, mm):
    """mha_reference_bwd with its five products taken by `mm`."""
    b, h, t, d = q.shape
    hkv = k.shape[1]
    g, scale = h // hkv, d ** -0.5
    q5, do5 = q.reshape(b, hkv, g, t, d), do.reshape(b, hkv, g, t, d)
    s = mm("bkgqd,bktd->bkgqt", q5, k) * scale
    p = torch.where(_mask(seg, t, causal), torch.exp(s - lse.reshape(b, hkv, g, t, 1)), 0.0)
    delta = (do5 * out.reshape(b, hkv, g, t, d)).sum(-1, keepdim=True)
    dv = mm("bkgqt,bkgqd->bktd", p, do5)
    ds = p * (mm("bkgqd,bktd->bkgqt", do5, v) - delta) * scale
    dk = mm("bkgqt,bkgqd->bktd", ds, q5)
    dq = mm("bkgqt,bktd->bkgqd", ds, k)
    return dq.reshape(b, h, t, d), dk, dv


def _inputs(b, h, hkv, t, d, seed):
    rng = np.random.default_rng(seed)
    mk = lambda hh: torch.from_numpy(rng.standard_normal((b, hh, t, d)).astype(np.float32))
    seg = np.zeros((b, t), np.int32)
    for r in range(b):        # packed segments of ~t/4 tokens, then a -1 tail
        for s, lo in enumerate(np.sort(rng.choice(np.arange(1, t), 3, replace=False))):
            seg[r, lo:] = s + 1
        seg[r, t - int(rng.integers(1, t // 8)):] = -1
    return mk(h), mk(hkv), mk(hkv), mk(h), torch.from_numpy(seg)


# G = 1 (OPT-125m), 4 (Llama-3.2-1B), 7 (Slam) at d = 64, and d = 128
SHAPES = [(2, 4, 4, 256, 64), (2, 8, 2, 256, 64), (1, 7, 1, 320, 64), (1, 4, 1, 256, 128)]


def test_tf32_rounds_to_nearest_ties_away():
    one_ulp = 2.0 ** -10
    x = torch.tensor([1.0, 1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -12,
                      1 + 3 * 2.0 ** -11, 3.0e-3, -7.5e5], dtype=torch.float32)
    got = tf32(x)
    assert got[:5].tolist() == [1.0, 1 + one_ulp, -(1 + one_ulp), 1.0, 1 + 2 * one_ulp]
    for y, r in zip(x.tolist(), got.tolist()):            # 10 mantissa bits, within half a unit
        m, e = math.frexp(r)
        assert m * 2 ** 11 == int(m * 2 ** 11) and abs(y - r) <= 2.0 ** (e - 12)
    hi, lo = split(x)
    assert torch.equal(tf32(hi), hi) and torch.equal(tf32(lo), lo)
    assert ((hi.double() + lo.double() - x.double()).abs()
            <= 2.0 ** -22 * x.double().abs()).all()


@pytest.mark.parametrize("b,h,hkv,t,d", SHAPES)
def test_forward_3xtf32_holds_the_float32_bounds_and_1xtf32_does_not(b, h, hkv, t, d):
    q, k, v, _, seg = _inputs(b, h, hkv, t, d, seed=t + d + h)
    ref, ref_lse = mha_reference(q, k, v, segment_ids=seg)
    errors = {}
    for name, mm in (("3xtf32", einsum_3xtf32), ("1xtf32", einsum_1xtf32)):
        out, lse = emulated_fwd(q, k, v, seg, True, mm)
        assert torch.equal(lse == LSE_SENTINEL, ref_lse == LSE_SENTINEL)
        errors[name] = ((out - ref).abs().max().item(), (lse - ref_lse).abs().max().item())
    assert errors["3xtf32"][0] <= F32_OUT_BOUND and errors["3xtf32"][1] <= F32_LSE_BOUND, errors
    assert errors["1xtf32"][0] > F32_OUT_BOUND and errors["1xtf32"][1] > F32_LSE_BOUND, errors


@pytest.mark.parametrize("b,h,hkv,t,d", SHAPES)
def test_backward_3xtf32_holds_the_float32_bound_and_1xtf32_does_not(b, h, hkv, t, d):
    q, k, v, do, seg = _inputs(b, h, hkv, t, d, seed=2 * t + d + h)
    out, lse = mha_reference(q, k, v, segment_ids=seg)
    want = mha_reference_bwd(q, k, v, seg, None, out, lse, do)
    g = h // hkv
    over = {}
    for name, mm in (("3xtf32", einsum_3xtf32), ("1xtf32", einsum_1xtf32)):
        got = emulated_bwd(q, k, v, seg, out, lse, do, True, mm)
        over[name] = [(a - w).abs().max().item()
                      / (F32_BWD_FACTOR * F32_EPS * math.sqrt(g * t) * w.abs().max().item()
                         + 1e-5) for a, w in zip(got, want)]
    assert max(over["3xtf32"]) <= 1, over             # each of dq, dk, dv inside its bound
    assert min(over["1xtf32"]) > 1, over              # each of dq, dk, dv outside it
