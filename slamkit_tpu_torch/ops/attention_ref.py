"""Plain PyTorch attention with causal + segment-id masking, and its backward.

Counterpart of `slamkit_tpu/ops/attention_ref.py`. These are the flash
kernels' plain versions: the CPU path of `ops.flash_attention`, and the ground
truth the CUDA kernels are held against on the card. They compute what the
kernels compute (`slamkit_tpu/ops/flash_attention.py::_fwd_kernel` and
`_bwd_kernel`), including their edge rules, which the JAX reference does not
share:

  * GQA without repeating kv: q head h reads kv head h // G (kv-major);
  * the row log-sum-exp is returned beside the output;
  * a row that attends nowhere outputs exactly 0 with LSE = +1e30
    (`LSE_SENTINEL`), where the JAX reference returns the mean of v.

Softmax and every product run in float32 whatever the input dtype.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30
LSE_SENTINEL = 1e30


def attention_mask(t_q: int, t_k: int, *, causal: bool,
                   q_segment_ids: Optional[torch.Tensor] = None,
                   k_segment_ids: Optional[torch.Tensor] = None,
                   device=None) -> Optional[torch.Tensor]:
    """Boolean mask, True = attend: [t_q, t_k] (causal only) or
    [B, 1, t_q, t_k] when segment ids are given."""
    mask = None
    if causal:
        qi = torch.arange(t_q, device=device)
        ki = torch.arange(t_k, device=device)
        mask = qi[:, None] >= ki[None, :]
    if q_segment_ids is not None:
        seg = (q_segment_ids[:, :, None] == k_segment_ids[:, None, :])[:, None]
        mask = seg if mask is None else (mask & seg)
    return mask


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  segment_ids: Optional[torch.Tensor] = None,
                  causal: bool = True,
                  sm_scale: Optional[float] = None,
                  kv_segment_ids: Optional[torch.Tensor] = None):
    """q [B, H, T, D], k/v [B, Hkv, T, D] (H % Hkv == 0), segment_ids [B, T]
    (query side; kv_segment_ids defaults to them).

    Returns (out [B, H, T, D] in q's dtype, lse [B, H, T] float32)."""
    b, h, t, d = q.shape
    h_kv = k.shape[1]
    g = h // h_kv
    if sm_scale is None:
        sm_scale = d ** -0.5
    if kv_segment_ids is None:
        kv_segment_ids = segment_ids
    q5 = q.float().reshape(b, h_kv, g, t, d)
    s = torch.einsum("bkgqd,bktd->bkgqt", q5, k.float()) * sm_scale
    mask = attention_mask(t, k.shape[2], causal=causal,
                          q_segment_ids=segment_ids,
                          k_segment_ids=kv_segment_ids, device=q.device)
    if mask is not None:
        if mask.dim() == 4:                      # [B, 1, Tq, Tk] -> per group
            mask = mask[:, :, None]
        s = s.masked_fill(~mask, NEG_INF)
        alive = mask.any(dim=-1).expand(s.shape[:-1])
    else:
        alive = torch.ones(s.shape[:-1], dtype=torch.bool, device=q.device)
    lse = torch.where(alive, torch.logsumexp(s, dim=-1),
                      torch.full((), LSE_SENTINEL, device=q.device))
    # masked scores and dead rows (lse = sentinel) both underflow to 0
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bkgqt,bktd->bkgqd", p, v.float())
    return out.reshape(b, h, t, d).to(q.dtype), lse.reshape(b, h, t)


def mha_reference_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      segment_ids: Optional[torch.Tensor],
                      kv_segment_ids: Optional[torch.Tensor],
                      out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                      causal: bool = True, sm_scale: Optional[float] = None):
    """The backward of `mha_reference` by its explicit formulas, in float32,
    from an external output and LSE (as the Pallas `_bwd_kernel` takes them,
    `slamkit_tpu/ops/flash_attention.py:277-304`):

        P = exp(scale * Q K^T - LSE) under the masks (0 off them; a dead
            row's LSE is +1e30, so its P is 0),
        delta = rowsum(dO o O),  dV = P^T dO,  dS = P o (dO V^T - delta) * scale,
        dK = dS^T Q,  dQ = dS K,

    with dK and dV summed over the G query heads of each kv head. Shapes as
    `mha_reference`, plus out/do [B, H, T, D] and lse [B, H, T]; returns
    (dq, dk, dv) in the dtypes of q, k and v."""
    b, h, t, d = q.shape
    h_kv = k.shape[1]
    g = h // h_kv
    if sm_scale is None:
        sm_scale = d ** -0.5
    if kv_segment_ids is None:
        kv_segment_ids = segment_ids
    q5 = q.float().reshape(b, h_kv, g, t, d)
    do5 = do.float().reshape(b, h_kv, g, t, d)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bkgqd,bktd->bkgqt", q5, kf) * sm_scale
    p = torch.exp(s - lse.float().reshape(b, h_kv, g, t, 1))
    mask = attention_mask(t, k.shape[2], causal=causal, q_segment_ids=segment_ids,
                          k_segment_ids=kv_segment_ids, device=q.device)
    if mask is not None:
        p = torch.where(mask[:, :, None] if mask.dim() == 4 else mask, p, 0.0)
    delta = (do5 * out.float().reshape(b, h_kv, g, t, d)).sum(-1, keepdim=True)
    dv = torch.einsum("bkgqt,bkgqd->bktd", p, do5)
    ds = p * (torch.einsum("bkgqd,bktd->bkgqt", do5, vf) - delta) * sm_scale
    dk = torch.einsum("bkgqt,bkgqd->bktd", ds, q5)
    dq = torch.einsum("bkgqt,bktd->bkgqd", ds, kf)
    return dq.reshape(b, h, t, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
