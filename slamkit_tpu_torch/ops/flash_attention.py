"""Flash attention, forward and backward: the CUDA kernels for CUDA tensors,
the plain versions for CPU tensors.

Counterpart of `slamkit_tpu/ops/flash_attention.py` (`flash_attention` :495,
`_fwd` :198 with kernel `_fwd_kernel` :124; `_bwd` :340 with kernel
`_bwd_kernel` :247; the `_flash` custom VJP :431-448). The kernels are
`ops/csrc/flash_fwd.cu` (bf16), `ops/csrc/flash_fwd_f32.cu` (float32: the
Pallas forward runs in its inputs' dtype, and the JAX package scores text
with a float32 LM) and `ops/csrc/flash_bwd.cu` (bf16), built with nvcc on
first use (`ops/_build.py`) and called through ctypes on PyTorch's current
stream. Dispatch is by the device of the tensors, then by their dtype: a CPU
tensor runs `mha_reference` / `mha_reference_bwd`, a CUDA tensor launches the
kernel of its dtype or raises (float16, mixed dtypes, and a float32 gradient:
the float32 backward is not ported, ROADMAP queue 2).
`FlashAttentionFunction` carries the gradient; `flash_attention` routes
through it when autograd is recording.

`flash_attention_fwd.launches` (the bf16 forward),
`flash_attention_fwd.f32_launches` (the float32 forward) and
`flash_attention_bwd.launches` count kernel launches (never plain-version
calls), so a caller can show that its path went through the kernels.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build
from .attention_ref import mha_reference, mha_reference_bwd

KERNEL = "flash_fwd"
KERNEL_F32 = "flash_fwd_f32"
KERNEL_BWD = "flash_bwd"


_ENTRY = {KERNEL: "slamkit_flash_fwd_bf16", KERNEL_F32: "slamkit_flash_fwd_f32"}


@functools.lru_cache(maxsize=None)
def _kernel_fn(name: str):
    """The forward's C entry of library `name` (bf16 or float32: one signature)."""
    fn = getattr(_build.load(name), _ENTRY[name])
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, ctypes.c_float, i, p]
    fn.restype = i
    return fn


@functools.lru_cache(maxsize=None)
def _kernel_bwd_fns():
    """(the launch, the scratch size) of the backward library."""
    lib = _build.load(KERNEL_BWD)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.slamkit_flash_bwd_bf16
    fn.argtypes = [p] * 12 + [i, i, i, i, i, ctypes.c_float, i, p]
    fn.restype = i
    scratch = lib.slamkit_flash_bwd_scratch_floats
    scratch.argtypes = [i, i, i]
    scratch.restype = ctypes.c_longlong
    return fn, scratch


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


def _segments(segment_ids, kv_segment_ids):
    if kv_segment_ids is None:
        return segment_ids, segment_ids
    if segment_ids is None:
        raise ValueError("kv_segment_ids needs segment_ids for the queries")
    return segment_ids, kv_segment_ids


def _check_kernel_inputs(what: str, dtypes=(torch.bfloat16,), **tensors):
    """What the CUDA kernels take: tensors of one dtype among `dtypes` (bf16;
    the forward also float32), contiguous, 16-byte aligned, d 64/128."""
    got = {x.dtype for x in tensors.values()}
    if len(got) != 1 or not got <= set(dtypes):
        raise TypeError(f"the CUDA flash {what} takes "
                        f"{' or '.join(str(d)[6:] for d in dtypes)} tensors of one dtype; got "
                        + ", ".join(f"{name} {x.dtype}" for name, x in tensors.items()))
    for name, x in tensors.items():
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    d = tensors["q"].shape[-1]
    if d not in (64, 128):
        raise ValueError(f"the CUDA flash {what} kernel takes head dim 64 or 128; got {d}")


def _seg_ptrs(q_seg, k_seg):
    if q_seg is None:
        return None, None, ()
    q_seg = q_seg.to(torch.int32).contiguous()
    k_seg = k_seg.to(torch.int32).contiguous()
    return q_seg.data_ptr(), k_seg.data_ptr(), (q_seg, k_seg)


def _launch(q, k, v, q_seg, k_seg, causal: bool, sm_scale: float):
    """The bf16 kernel for bf16 inputs, the float32 one for float32 inputs."""
    _check_kernel_inputs("forward", (torch.bfloat16, torch.float32), q=q, k=k, v=v)
    f32 = q.dtype == torch.float32
    b, h, t, d = q.shape
    q_ptr, k_ptr, _keep = _seg_ptrs(q_seg, k_seg)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    name = KERNEL_F32 if f32 else KERNEL
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel_fn(name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_ptr, k_ptr,
            out.data_ptr(), lse.data_ptr(),
            b, h, k.shape[1], t, d, float(sm_scale), int(causal), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    if f32:
        flash_attention_fwd.f32_launches += 1
    else:
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
    row with no visible key gets out 0 and lse +1e30. On the card bf16 and
    float32 inputs each have their kernel.
    """
    _check(q, k, v, segment_ids, kv_segment_ids)
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    segment_ids, kv_segment_ids = _segments(segment_ids, kv_segment_ids)
    if q.device.type == "cpu":
        return mha_reference(q, k, v, segment_ids=segment_ids, causal=causal,
                             sm_scale=sm_scale, kv_segment_ids=kv_segment_ids)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cpu or cuda, not {q.device}")
    return _launch(q, k, v, segment_ids, kv_segment_ids, causal, sm_scale)


flash_attention_fwd.launches = 0
flash_attention_fwd.f32_launches = 0


def _launch_bwd(q, k, v, out, lse, do, q_seg, k_seg, causal: bool, sm_scale: float):
    _check_kernel_inputs("backward", q=q, k=k, v=v, out=out, do=do)
    b, h, t, d = q.shape
    if tuple(lse.shape) != (b, h, t):
        raise ValueError(f"lse must be [B, H, T] = {(b, h, t)}; got {tuple(lse.shape)}")
    lse = lse.float().contiguous()
    q_ptr, k_ptr, _keep = _seg_ptrs(q_seg, k_seg)
    launch, scratch_floats = _kernel_bwd_fns()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # delta = rowsum(dO o O) of the O the forward returned (outside the
    # kernel proper, as in the JAX package, flash_attention.py:345) is the
    # kernel's pre-pass; it and the segment-range tables live in `scratch`
    scratch = torch.empty(scratch_floats(b, h, t), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(),
            lse.data_ptr(), q_ptr, k_ptr, dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            scratch.data_ptr(), b, h, k.shape[1], t, d, float(sm_scale), int(causal), stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd launch failed: CUDA error {err}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        segment_ids: Optional[torch.Tensor] = None,
                        kv_segment_ids: Optional[torch.Tensor] = None,
                        causal: bool = True,
                        sm_scale: Optional[float] = None):
    """Gradients (dq, dk, dv) of attention from an external output and LSE
    (those the forward returned, or, for a ring schedule, the merged global
    ones), with the forward's shapes and masks; do is dL/d(out).
    delta = rowsum(dO o O) is taken in float32: by the kernel's pre-pass on
    the card, by the plain version on the CPU."""
    _check(q, k, v, segment_ids, kv_segment_ids)
    if out.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and do {tuple(do.shape)} must match "
                         f"q {tuple(q.shape)}")
    if {x.device for x in (out, lse, do)} != {q.device}:
        raise ValueError(f"out, lse and do must be on {q.device}")
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    segment_ids, kv_segment_ids = _segments(segment_ids, kv_segment_ids)
    if q.device.type == "cpu":
        return mha_reference_bwd(q, k, v, segment_ids, kv_segment_ids, out, lse, do,
                                 causal=causal, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cpu or cuda, not {q.device}")
    return _launch_bwd(q, k, v, out, lse, do, segment_ids, kv_segment_ids, causal,
                       sm_scale)


flash_attention_bwd.launches = 0


class FlashAttentionFunction(torch.autograd.Function):
    """Attention whose gradient is `flash_attention_bwd` (the JAX package's
    `_flash` custom VJP): the forward saves q, k, v, out, lse and the segment
    ids; the backward recomputes P from them."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, kv_segment_ids, causal, sm_scale):
        out, lse = flash_attention_fwd(q, k, v, segment_ids=segment_ids, causal=causal,
                                       sm_scale=sm_scale, kv_segment_ids=kv_segment_ids)
        ctx.save_for_backward(q, k, v, out, lse, segment_ids, kv_segment_ids)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, out, lse, segment_ids, kv_segment_ids = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do.contiguous(),
                                         segment_ids=segment_ids,
                                         kv_segment_ids=kv_segment_ids,
                                         causal=ctx.causal, sm_scale=ctx.sm_scale)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    segment_ids: Optional[torch.Tensor] = None,
                    causal: bool = True,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention over [B, H, T, D] with optional [B, T] segment ids
    (the JAX package's public entry); returns the output only. Under autograd
    it goes through `FlashAttentionFunction`, so the backward kernel runs;
    float32 CUDA inputs that need a gradient raise, since the float32 backward
    is not ported (ROADMAP queue 2)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if q.device.type == "cuda" and q.dtype == torch.float32:
            raise NotImplementedError(
                "flash attention on float32 CUDA tensors that need a gradient: the float32 "
                "backward kernel is not ported yet (ROADMAP queue 2); score under no_grad / "
                "inference_mode, or train in bfloat16")
        return FlashAttentionFunction.apply(q, k, v, segment_ids, None, causal,
                                            sm_scale)[0]
    return flash_attention_fwd(q, k, v, segment_ids=segment_ids, causal=causal,
                               sm_scale=sm_scale)[0]
