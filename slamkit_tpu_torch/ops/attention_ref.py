"""Plain PyTorch attention with causal + segment-id masking.

Counterpart of `slamkit_tpu/ops/attention_ref.py`. It is the flash kernel's
plain version: the CPU path of `ops.flash_attention`, and the ground truth the
CUDA kernel is held against on the card. It computes what the kernel computes
(`slamkit_tpu/ops/flash_attention.py::_fwd_kernel`), including its edge rules,
which the JAX reference does not share:

  * GQA without repeating kv: q head h reads kv head h // G (kv-major);
  * the row log-sum-exp is returned beside the output;
  * a row that attends nowhere outputs exactly 0 with LSE = +1e30
    (`LSE_SENTINEL`), where the JAX reference returns the mean of v.

Softmax and both products run in float32 whatever the input dtype.
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
