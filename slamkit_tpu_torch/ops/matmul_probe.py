"""The contraction-cost probe: `reps` repeated bf16 products summed in f32.

Counterpart of `scripts/bench_flash.py::matmul_probe` (:90), whose Pallas body
(`kern` :98) asked the TPU whether a head-dim-64 contraction costs half of
128. The kernel is `ops/csrc/matmul_probe.cu` (wgmma, the instruction the
flash kernels' products run on), built with nvcc on first use and called
through ctypes; a CPU tensor runs the plain version.
`matmul_probe.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

KERNEL = "matmul_probe"
SHAPES = ((1024, 64, 1024), (1024, 128, 1024), (1024, 1024, 64), (1024, 1024, 128))
REPS = 64


def matmul_probe_reference(a: torch.Tensor, b: torch.Tensor, reps: int) -> torch.Tensor:
    """The plain version: a.float() @ b.float() added into an f32 sum `reps` times."""
    out = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32, device=a.device)
    for _ in range(reps):
        out += a.float() @ b.float()
    return out


def error_bound(k: int, reps: int) -> float:
    """How far the kernel may sit from the plain version, as a fraction of
    max |plain|. The kernel keeps one float32 sum over reps x K/16
    tensor-core steps; each step adds a 16-deep product into it and may
    truncate up to one float32 ulp of the running sum (2^-23 of it, so at
    most of max |plain|), all in the same direction, so the errors add up.
    For short sums the plain version's own float32 rounding dominates, which
    1e-4 covers."""
    return max(1e-4, reps * k / 16 * 2.0 ** -23)


def _kernel_fn():
    fn = _build.load(KERNEL).slamkit_matmul_probe_bf16
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, i, p]
        fn.restype = i
    return fn


def matmul_probe(a: torch.Tensor, b: torch.Tensor, reps: int = REPS) -> torch.Tensor:
    """sum over reps of a [M, K] @ b [K, N] -> f32 [M, N]. The CUDA kernel
    takes bf16, M and N multiples of 64, K a multiple of 32."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"a must be [M, K] and b [K, N]; got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"inputs are on several devices: {a.device}, {b.device}")
    if a.device.type == "cpu":
        return matmul_probe_reference(a, b, reps)
    if a.device.type != "cuda":
        raise ValueError(f"matmul_probe runs on cpu or cuda, not {a.device}")
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA probe kernel takes bfloat16; got {a.dtype}, {b.dtype}")
    m, k = a.shape
    n = b.shape[1]
    if m % 64 or n % 64 or k % 32:
        raise ValueError(f"the CUDA probe kernel takes M, N multiples of 64 and K of 32; "
                         f"got {(m, k, n)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous")
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _kernel_fn()(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, k, n, int(reps),
                           stream)
    if err != 0:
        raise RuntimeError(f"matmul_probe launch failed: CUDA error {err}")
    matmul_probe.launches += 1
    return out


matmul_probe.launches = 0
