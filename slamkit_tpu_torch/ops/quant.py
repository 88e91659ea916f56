"""int8 weight-only quantization for the decode path.

Counterpart of `slamkit_tpu/ops/quant.py`: per-output-channel symmetric int8,

    w ~= q * s,   q int8 in [-127, 127],   s = max|w_col| / 127   (bf16),

`quantize_weight` (:30), `dequantize_weight` (:93) and `dq_matmul` (:51), the
product x @ dequant(q, s) whose TPU kernel is `_dq_kernel` (:43). Here the
kernel is `ops/csrc/dq_matmul.cu`, built with nvcc on first use
(`ops/_build.py`) and called through ctypes on PyTorch's current stream. It
dequantizes on chip, so the bf16 weight never exists in device memory.
Dispatch is by the device of the tensors: a CPU tensor runs the plain version
`dq_matmul_reference`, a CUDA tensor launches the kernel or raises.
`dq_matmul.launches` counts the wrapper's calls that launched the kernel on
the card, never plain-version calls. Every call is one kernel launch (the
decode GEMV sums its split of K inside a thread-block cluster), so the count
is of launches and of calls alike.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

KERNEL = "dq_matmul"


def quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[K, N] float -> (int8 [K, N], bf16 scale [1, N]) per output channel.
    The scale is rounded to bf16 BEFORE dividing, so quantization and
    dequantization use the same scale; rounding is half to even, as
    `jnp.round`."""
    wf = w.float()
    s = wf.abs().amax(dim=0, keepdim=True) / 127.0
    s = torch.where(s == 0.0, torch.ones_like(s), s).to(torch.bfloat16)
    q = torch.clamp(torch.round(wf / s.float()), -127, 127).to(torch.int8)
    return q, s


def dequantize_weight(q: torch.Tensor, s: torch.Tensor,
                      dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return (q.float() * s.float()).to(dtype)


def dq_matmul_reference(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The plain version: x @ dequant(q, s) in float32, cast to bf16."""
    return (x.float() @ (q.float() * s.float().reshape(1, -1))).to(torch.bfloat16)


def ulp_bound(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """How far the kernel may sit from the plain version, element by element:
    one bf16 ulp (2^-7 of the element's binade), floored at the ulp of
    2^-10. Both sum exact float32 products (bf16 x int8 x bf16 fits 24 bits)
    in another order and round once to bf16, so an element may round one
    ulp the other way; below 2^-10 the float32 summation noise itself can
    reach an ulp."""
    got, want = got.float(), want.float()
    mag = torch.maximum(torch.maximum(got.abs(), want.abs()),
                        torch.full_like(got, 2.0 ** -10))
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    fn = _build.load(KERNEL).slamkit_dq_matmul_bf16
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, i, i, i, p]
    fn.restype = i
    return fn


def _check(x, q, s):
    if x.dim() != 2 or q.dim() != 2:
        raise ValueError(f"x must be [M, K] and q [K, N]; got {tuple(x.shape)}, "
                         f"{tuple(q.shape)}")
    if x.shape[1] != q.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} and q {tuple(q.shape)} disagree on K")
    if s.numel() != q.shape[1] or (s.dim() == 2 and s.shape[0] != 1) or s.dim() > 2:
        raise ValueError(f"s must be [1, N] = [1, {q.shape[1]}]; got {tuple(s.shape)}")
    if q.dtype != torch.int8:
        raise TypeError(f"q must be int8; got {q.dtype}")
    devices = {t.device for t in (x, q, s)}
    if len(devices) != 1:
        raise ValueError(f"inputs are on several devices: {devices}")


def _launch(x, q, s):
    if x.dtype != torch.bfloat16 or s.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA dq_matmul kernel takes bfloat16 x and s; got "
                        f"{x.dtype}, {s.dtype}")
    for name, t in (("x", x), ("q", q), ("s", s)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    m, k = x.shape
    n = q.shape[1]
    if k % 8:
        raise ValueError(f"the CUDA dq_matmul kernel takes K a multiple of 8; got {k}")
    index = x.device.index
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return _launch(x, q, s)
    y = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    err = _kernel_fn()(x.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(), m, k, n,
                       torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"dq_matmul launch failed: CUDA error {err}")
    dq_matmul.launches += 1
    return y


def dq_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ dequant(q [K, N] int8, s [1, N] bf16) -> [M, N] bf16, f32
    accumulation. The CUDA kernel takes bf16 x, K a multiple of 8, and any M
    and N."""
    _check(x, q, s)
    if x.device.type == "cpu":
        return dq_matmul_reference(x, q, s)
    if x.device.type != "cuda":
        raise ValueError(f"dq_matmul runs on cpu or cuda, not {x.device}")
    return _launch(x, q, s)


dq_matmul.launches = 0
