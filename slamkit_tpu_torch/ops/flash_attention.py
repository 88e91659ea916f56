"""Flash-attention forward: the CUDA kernel for CUDA tensors, the plain
version for CPU tensors.

Counterpart of `slamkit_tpu/ops/flash_attention.py` (`flash_attention` :495,
`_fwd` :198, kernel `_fwd_kernel` :124). The kernel is
`ops/csrc/flash_fwd.cu`, built with nvcc on first use (`ops/_build.py`) and
called through ctypes on PyTorch's current stream. Dispatch is by the device
of the tensors and nothing else: a CPU tensor runs `mha_reference`, a CUDA
tensor launches the kernel or raises.

`flash_attention_fwd.launches` counts kernel launches (never plain-version
calls), so a caller can show that its path went through the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .attention_ref import mha_reference

KERNEL = "flash_fwd"


def _kernel_fn():
    fn = _build.load(KERNEL).slamkit_flash_fwd_bf16
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, ctypes.c_float, i, p]
        fn.restype = i
    return fn


def _check(q, k, v, segment_ids, kv_segment_ids):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, H, T, D]")
    b, h, t, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != t or k.shape[3] != d:
        raise ValueError(f"k/v {tuple(k.shape)}, {tuple(v.shape)} do not match q "
                         f"{tuple(q.shape)} (k/v must be [B, Hkv, T, D])")
    if h % k.shape[1]:
        raise ValueError(f"q heads {h} not a multiple of kv heads {k.shape[1]}")
    for name, s in (("segment_ids", segment_ids), ("kv_segment_ids", kv_segment_ids)):
        if s is not None and tuple(s.shape) != (b, t):
            raise ValueError(f"{name} must be [B, T] = {(b, t)}; got {tuple(s.shape)}")
    devices = {x.device for x in (q, k, v, segment_ids, kv_segment_ids) if x is not None}
    if len(devices) != 1:
        raise ValueError(f"inputs are on several devices: {devices}")


def _launch(q, k, v, q_seg, k_seg, causal: bool, sm_scale: float):
    if q.dtype != torch.bfloat16 or k.dtype != torch.bfloat16 or v.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA flash kernel takes bfloat16; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    b, h, t, d = q.shape
    if d not in (64, 128):
        raise ValueError(f"the CUDA flash kernel takes head dim 64 or 128; got {d}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if q_seg is not None:
        q_seg = q_seg.to(torch.int32).contiguous()
        k_seg = k_seg.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            q_seg.data_ptr() if q_seg is not None else None,
            k_seg.data_ptr() if k_seg is not None else None,
            out.data_ptr(), lse.data_ptr(),
            b, h, k.shape[1], t, d, float(sm_scale), int(causal), stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed: CUDA error {err}")
    flash_attention_fwd.launches += 1
    return out, lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        segment_ids: Optional[torch.Tensor] = None,
                        causal: bool = True,
                        sm_scale: Optional[float] = None,
                        kv_segment_ids: Optional[torch.Tensor] = None):
    """Attention forward with its row log-sum-exp.

    q [B, H, T, D]; k/v [B, Hkv, T, D] with q heads kv-major (head h reads kv
    head h // (H // Hkv)); segment_ids [B, T] for the queries, kv_segment_ids
    for the keys (default: the same ids; -1 marks pads, which attend to other
    pads). Returns (out [B, H, T, D] in q's dtype, lse [B, H, T] float32); a
    row with no visible key gets out 0 and lse +1e30.
    """
    _check(q, k, v, segment_ids, kv_segment_ids)
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if kv_segment_ids is None:
        kv_segment_ids = segment_ids
    elif segment_ids is None:
        raise ValueError("kv_segment_ids needs segment_ids for the queries")
    if q.device.type == "cpu":
        return mha_reference(q, k, v, segment_ids=segment_ids, causal=causal,
                             sm_scale=sm_scale, kv_segment_ids=kv_segment_ids)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cpu or cuda, not {q.device}")
    return _launch(q, k, v, segment_ids, kv_segment_ids, causal, sm_scale)


flash_attention_fwd.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    segment_ids: Optional[torch.Tensor] = None,
                    causal: bool = True,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention over [B, H, T, D] with optional [B, T] segment ids
    (the JAX package's public entry); returns the output only."""
    return flash_attention_fwd(q, k, v, segment_ids=segment_ids, causal=causal,
                               sm_scale=sm_scale)[0]
