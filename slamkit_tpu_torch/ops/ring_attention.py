"""Ring flash attention: context parallelism around the flash kernels.

Counterpart of `slamkit_tpu/ops/ring_attention.py`. The JAX package
`shard_map`s a global array; here each rank of the 'seq' process group
holds its own chunk of the sequence and calls `ring_flash_attention` on it
(the trainer hands each rank its tile, `parallel/mesh.py`):

  * k, v and the key segment ids rotate around the ring: every step sends
    to seq rank r + 1 and receives from r - 1 in one `dist.batch_isend_irecv`
    into fresh buffers (NCCL on the card, gloo on the CPU);
  * forward (`_ring_forward`, JAX :138-164): step 0 is the causal call on
    the diagonal chunk; step t >= 1 runs the non-causal call on the received
    chunk only where r >= t (every key then precedes every query; the other
    ranks skip the compute but still rotate) and merges the partial outputs
    by their LSE (`merge_pair`, JAX `_merge_pair` :84-103);
  * backward (`_ring_backward`, JAX `_ring_bwd_rule` :220-258): the flash
    backward of every pair gets the GLOBAL merged out and LSE, so its dq is
    exact and adds up locally in float32, while dk / dv add up in float32 on
    the chunk they belong to and travel the ring with it; one last rotation
    brings them home;
  * zigzag (JAX :167-206, :261-304): with the sequence permuted by
    `zigzag_permutation`, rank r holds the logical half-chunks (r, 2n-1-r),
    so every step costs every rank two half-pair calls: q's high half
    against the received low half, and q's low half against it where
    r >= t, else q's high half against the received high half.

The kernels are reached only through `flash_attention_fwd` /
`flash_attention_bwd`: the CUDA kernels for CUDA tensors, their plain
versions for CPU tensors. `RingFlashAttention` carries the gradient.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .attention_ref import LSE_SENTINEL
from .flash_attention import flash_attention_bwd, flash_attention_fwd

# LSE values at or above this are the kernels' dead-row sentinel (a row that
# sees no key of a chunk): the merge gives them weight 0
_DEAD = LSE_SENTINEL / 2
SCHEDULES = ("contiguous", "zigzag")
# the chunk a rank holds must be a multiple of this (zigzag: of twice this),
# as the JAX package's kernels require of their lane-aligned blocks
CHUNK_UNIT = 128


def zigzag_permutation(t: int, n: int):
    """Time-axis permutation for the zigzag (load-balanced) schedule.

    Returns idx of length t such that permuted[i] = original[idx[i]]:
    rank r's contiguous chunk [r*C, (r+1)*C) then holds the logical
    half-chunks (r, 2n-1-r), h = t/(2n) positions each. Self-inverse is
    NOT guaranteed — invert with np.argsort(idx). Callers must permute
    every per-token array consistently (ids/labels/positions/segments) and
    PRE-SHIFT labels before permuting (next-token adjacency does not
    survive the permutation)."""
    if t % (2 * n):
        raise ValueError(f"T={t} not divisible by 2*n={2 * n}")
    h = t // (2 * n)
    order = []
    for r in range(n):
        order.extend(range(r * h, (r + 1) * h))
        order.extend(range((2 * n - 1 - r) * h, (2 * n - r) * h))
    return np.asarray(order)


def merge_pair(out_a, lse_a, out_b, lse_b):
    """Online-softmax combine of two partial attentions over disjoint keys.

    out_a / out_b are each part's normalised output [B, H, T, D], lse_* the
    matching float32 log-sum-exp [B, H, T] (at or above LSE_SENTINEL / 2: a
    dead row, weight 0). Returns (out float32, lse float32), a row dead in
    both parts staying out 0, lse LSE_SENTINEL."""
    neg_inf = torch.tensor(float("-inf"), device=lse_a.device)
    la = torch.where(lse_a >= _DEAD, neg_inf, lse_a)
    lb = torch.where(lse_b >= _DEAD, neg_inf, lse_b)
    m = torch.maximum(la, lb)
    alive = m > float("-inf")
    ms = torch.where(alive, m, 0.0)
    wa = torch.where(torch.isinf(la), 0.0, torch.exp(la - ms))
    wb = torch.where(torch.isinf(lb), 0.0, torch.exp(lb - ms))
    safe_l = torch.where(alive, wa + wb, 1.0)
    out = (out_a.float() * wa[..., None] + out_b.float() * wb[..., None]) / safe_l[..., None]
    lse = torch.where(alive, ms + torch.log(safe_l), LSE_SENTINEL)
    return out, lse


class _Ring:
    """The 'seq' group as the ring sees it: this rank `r` of `n`, and the
    global ranks it sends to (r + 1) and receives from (r - 1)."""

    def __init__(self, group):
        self.group = group
        self.n = dist.get_world_size(group)
        self.r = dist.get_rank(group)
        self.next = dist.get_global_rank(group, (self.r + 1) % self.n)
        self.prev = dist.get_global_rank(group, (self.r - 1) % self.n)

    def rotate(self, tensors: list) -> list:
        """Send every tensor to r + 1 and receive r - 1's into fresh
        buffers, all in one `batch_isend_irecv`; returns the received."""
        send = [t.contiguous() for t in tensors]
        recv = [torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in send]
        ops = []
        for tag, (s, r) in enumerate(zip(send, recv)):
            ops.append(dist.P2POp(dist.isend, s, self.next, self.group, tag))
            ops.append(dist.P2POp(dist.irecv, r, self.prev, self.group, tag))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return recv


def _halves(x, dim: int):
    h = x.shape[dim] // 2
    return x.narrow(dim, 0, h).contiguous(), x.narrow(dim, h, h).contiguous()


def _fwd(q, k, v, q_seg, k_seg, causal: bool, scale: float):
    return flash_attention_fwd(q, k, v, segment_ids=q_seg, causal=causal, sm_scale=scale,
                               kv_segment_ids=k_seg if q_seg is not None else None)


def _bwd(q, k, v, out, lse, do, q_seg, k_seg, causal: bool, scale: float):
    dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, segment_ids=q_seg,
                                     kv_segment_ids=k_seg if q_seg is not None else None,
                                     causal=causal, sm_scale=scale)
    return dq.float(), dk.float(), dv.float()


def _travelling(k, v, seg) -> list:
    return [k, v] if seg is None else [k, v, seg]


def _diagonal_forward(q, k, v, seg, scale: float):
    """Step 0: the local causal call (out float32, lse). Under zigzag the
    rank's two logical half-chunks are ordered locally as in logical time,
    so the same causal call covers both diagonals and the high half against
    the low half."""
    out, lse = _fwd(q, k, v, seg, seg, True, scale)
    return out.float(), lse


def _forward_step(q, seg, kv, out, lse, r: int, t: int, schedule: str, scale: float):
    """Step t >= 1 of seq rank r: merge what attending the received chunk
    `kv` ([k, v(, key segment ids)]) adds into (out float32, lse)."""
    has_seg = seg is not None
    if schedule == "contiguous":
        if r >= t:      # every received key precedes every local query
            o_t, lse_t = _fwd(q, kv[0], kv[1], seg, kv[2] if has_seg else None, False, scale)
            out, lse = merge_pair(out, lse, o_t, lse_t)
        return out, lse
    # zigzag: the received halves are the logical (j, 2n-1-j), j = r - t mod n
    qa, qb = _halves(q, 2)
    qsa, qsb = _halves(seg, 1) if has_seg else (None, None)
    out_a, out_b = _halves(out, 2)
    lse_a, lse_b = _halves(lse, 2)
    ka, kb = _halves(kv[0], 2)
    va, vb = _halves(kv[1], 2)
    ksa, ksb = _halves(kv[2], 1) if has_seg else (None, None)
    # the high half against the received low half: always visible
    o1, l1 = _fwd(qb, ka, va, qsb, ksa, False, scale)
    out_b, lse_b = merge_pair(out_b, lse_b, o1, l1)
    if r >= t:          # j < r: the low half against the received low half
        o2, l2 = _fwd(qa, ka, va, qsa, ksa, False, scale)
        out_a, lse_a = merge_pair(out_a, lse_a, o2, l2)
    else:               # j > r: the high half against the received high half
        o2, l2 = _fwd(qb, kb, vb, qsb, ksb, False, scale)
        out_b, lse_b = merge_pair(out_b, lse_b, o2, l2)
    return torch.cat([out_a, out_b], dim=2), torch.cat([lse_a, lse_b], dim=2)


def _backward_step(q, seg, out, lse, do, kv, dq, dk, dv, r: int, t: int, schedule: str,
                   scale: float):
    """Step t >= 1 of the backward of seq rank r: the pair's gradients from
    the global (out, lse), dq into the local float32 sum, dk / dv into the
    float32 sums that travel with the received chunk `kv`."""
    has_seg = seg is not None
    if schedule == "contiguous":
        if r >= t:
            dq_t, dk_t, dv_t = _bwd(q, kv[0], kv[1], out, lse, do, seg,
                                    kv[2] if has_seg else None, False, scale)
            dq, dk, dv = dq + dq_t, dk + dk_t, dv + dv_t
        return dq, dk, dv
    qa, qb = _halves(q, 2)
    qsa, qsb = _halves(seg, 1) if has_seg else (None, None)
    oa, ob = _halves(out, 2)
    la, lb = _halves(lse, 2)
    da, db = _halves(do, 2)
    dq_a, dq_b = _halves(dq, 2)
    ka, kb = _halves(kv[0], 2)
    va, vb = _halves(kv[1], 2)
    ksa, ksb = _halves(kv[2], 1) if has_seg else (None, None)
    dka, dkb = _halves(dk, 2)
    dva, dvb = _halves(dv, 2)
    dq1, dk1, dv1 = _bwd(qb, ka, va, ob, lb, db, qsb, ksa, False, scale)
    if r >= t:
        dq2, dk2, dv2 = _bwd(qa, ka, va, oa, la, da, qsa, ksa, False, scale)
        dq_a = dq_a + dq2
        dq_b = dq_b + dq1
        dka = dka + dk1 + dk2
        dva = dva + dv1 + dv2
    else:
        dq2, dk2, dv2 = _bwd(qb, kb, vb, ob, lb, db, qsb, ksb, False, scale)
        dq_b = dq_b + dq1 + dq2
        dka = dka + dk1
        dva = dva + dv1
        dkb = dkb + dk2
        dvb = dvb + dv2
    return (torch.cat([dq_a, dq_b], dim=2), torch.cat([dka, dkb], dim=2),
            torch.cat([dva, dvb], dim=2))


def _ring_forward(q, k, v, seg, ring: _Ring, schedule: str, scale: float):
    """The whole ring pass; returns (out in q's dtype, lse float32)."""
    out, lse = _diagonal_forward(q, k, v, seg, scale)
    kv = _travelling(k, v, seg)
    for t in range(1, ring.n):
        kv = ring.rotate(kv)
        out, lse = _forward_step(q, seg, kv, out, lse, ring.r, t, schedule, scale)
    return out.to(q.dtype), lse


def _ring_backward(q, k, v, seg, out, lse, do, ring: _Ring, schedule: str, scale: float):
    """(dq, dk, dv) of the ring pass, from the global merged out and LSE."""
    dq, dk, dv = _bwd(q, k, v, out, lse, do, seg, seg, True, scale)
    kv = _travelling(k, v, seg)
    for t in range(1, ring.n):
        *kv, dk, dv = ring.rotate(kv + [dk, dv])
        dq, dk, dv = _backward_step(q, seg, out, lse, do, kv, dq, dk, dv, ring.r, t,
                                    schedule, scale)
    # the chunks sit one past home after n - 1 rotations; one more brings
    # their accumulated gradients back to their owner
    if ring.n > 1:
        dk, dv = ring.rotate([dk, dv])
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def ring_on_one_device(q, k, v, segment_ids, do, n: int, schedule: str = "contiguous",
                       sm_scale: Optional[float] = None):
    """The ring's whole kernel sequence for all n ranks of a 'seq' group in
    one process, the rotations made in memory instead of over P2P, from the
    same step functions as `ring_flash_attention`: q [B, H, T, D], k / v,
    segment_ids [B, T] and do (the output's gradient) over the whole
    sequence, already zigzag-permuted for that schedule. Returns (out, lse,
    dq, dk, dv) over the whole (permuted) sequence, each rank's chunk
    where that rank holds it. A check of the kernels in the ring's modes
    where there is one card (`chip_smoke.py` phase 17)."""
    c = q.shape[2] // n
    check_chunk(c, n, schedule)
    scale = q.shape[-1] ** -0.5 if sm_scale is None else sm_scale
    part = lambda x, r, dim: x.narrow(dim, r * c, c).contiguous()
    seg = None if segment_ids is None else segment_ids.to(torch.int32)
    qs = [part(q, r, 2) for r in range(n)]
    segs = [None if seg is None else part(seg, r, 1) for r in range(n)]
    dos = [part(do, r, 2) for r in range(n)]
    state = [_diagonal_forward(qs[r], part(k, r, 2), part(v, r, 2), segs[r], scale)
             for r in range(n)]
    kv = [_travelling(part(k, r, 2), part(v, r, 2), segs[r]) for r in range(n)]
    for t in range(1, n):
        kv = [kv[(r - 1) % n] for r in range(n)]
        state = [_forward_step(qs[r], segs[r], kv[r], *state[r], r, t, schedule, scale)
                 for r in range(n)]
    outs = [o.to(q.dtype) for o, _ in state]
    grads = [list(_bwd(qs[r], part(k, r, 2), part(v, r, 2), outs[r], state[r][1], dos[r],
                       segs[r], segs[r], True, scale)) for r in range(n)]
    kv = [_travelling(part(k, r, 2), part(v, r, 2), segs[r]) for r in range(n)]
    for t in range(1, n):
        kv = [kv[(r - 1) % n] for r in range(n)]
        travelling = [grads[(r - 1) % n][1:] for r in range(n)]
        grads = [list(_backward_step(qs[r], segs[r], outs[r], state[r][1], dos[r], kv[r],
                                     grads[r][0], *travelling[r], r, t, schedule, scale))
                 for r in range(n)]
    home = [grads[(r - 1) % n][1:] for r in range(n)] if n > 1 else [g[1:] for g in grads]
    cat = lambda xs, dim: torch.cat(xs, dim=dim)
    return (cat(outs, 2), cat([s[1] for s in state], 2),
            cat([g[0] for g in grads], 2).to(q.dtype),
            cat([h[0] for h in home], 2).to(k.dtype), cat([h[1] for h in home], 2).to(v.dtype))


class RingFlashAttention(torch.autograd.Function):
    """Causal attention over the 'seq' group's chunks (`ring_flash_attention`'s
    arguments); the backward is the ring backward (JAX's `_ring` custom VJP).
    A remat recompute replays the forward's rotations on every rank, in the
    same order."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, group, schedule, sm_scale):
        ring = _Ring(group)
        out, lse = _ring_forward(q, k, v, segment_ids, ring, schedule, sm_scale)
        ctx.save_for_backward(q, k, v, segment_ids, out, lse)
        ctx.ring, ctx.schedule, ctx.sm_scale = ring, schedule, sm_scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, seg, out, lse = ctx.saved_tensors
        dq, dk, dv = _ring_backward(q, k, v, seg, out, lse, do.contiguous(), ctx.ring,
                                    ctx.schedule, ctx.sm_scale)
        return dq, dk, dv, None, None, None, None


def check_chunk(chunk: int, n: int, schedule: str):
    """Raise unless a rank's chunk of `chunk` positions (of a sequence split
    over a 'seq' group of `n`) suits the ring `schedule`."""
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown ring schedule {schedule!r}")
    unit = CHUNK_UNIT * (2 if schedule == "zigzag" else 1)
    if chunk % unit:
        raise ValueError(
            f"ring attention needs T divisible into lane-aligned chunks: "
            f"T={chunk * n}, seq axis={n} -> chunk {chunk} (must be a multiple of "
            f"{unit} for schedule={schedule})")


def ring_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         segment_ids: Optional[torch.Tensor] = None, *, group,
                         schedule: str = "contiguous",
                         sm_scale: Optional[float] = None) -> torch.Tensor:
    """Causal flash attention over the sequence split across `group`.

    q [B, H, C, D], k / v [B, Hkv, C, D] and segment_ids [B, C] (-1 pads)
    are this rank's chunk: under 'contiguous' seq rank r holds positions
    [r C, (r+1) C); under 'zigzag' the sequence must already be permuted by
    `zigzag_permutation(C n, n)`. C must be a multiple of 128 (of 256 for
    zigzag). Returns this rank's output chunk in q's dtype."""
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"q heads {q.shape[1]} not a multiple of kv heads {k.shape[1]}")
    check_chunk(q.shape[2], dist.get_world_size(group), schedule)
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    seg = None if segment_ids is None else segment_ids.to(torch.int32).contiguous()
    return RingFlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), seg,
                                    group, schedule, sm_scale)


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        n, r = dist.get_world_size(group), dist.get_rank(group)
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        ctx.group, ctx.dim, ctx.n, ctx.r = group, dim, n, r
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad.chunk(ctx.n, ctx.dim)[ctx.r], None, None


def all_gather_seq(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The chunks of every rank of the 'seq' group, in rank order along
    `dim` (the plain attention's keys under context parallelism, as GSPMD
    gathers them on the JAX package's XLA path). Its gradient is the sum of
    every rank's gradient of this rank's chunk: an all-reduce, which NCCL and
    gloo both take (`torch.distributed.nn.functional.all_gather`'s gloo
    backward scatters from global ranks and fails on a subgroup)."""
    return _GatherSeq.apply(x, group, dim)
