"""Flash-attention and contraction-probe timings.

    python -m slamkit_tpu_torch.tools.bench_flash [--heads 14] [--hkv N] [--dim 64] [--iters 20]
    python -m slamkit_tpu_torch.tools.bench_flash --matmul-probe [--iters 20]
    python -m slamkit_tpu_torch.tools.bench_flash --bwd-kernels [--batch 4] [--heads 8]
        [--hkv 2] [--ctx 1024] [--dim 256] [--segs 4] [--noncausal]

The counterpart of `scripts/bench_flash.py`. The headline times the flash
forward kernel and forward + backward (the gradient of sum(out^2), so
dO = 2 out) at the Slam shape [8, heads, 1024, dim] with 8 packed segments
of 128 tokens, between CUDA events. `--matmul-probe` times the probe kernel
(`ops/matmul_probe.py`: 64 repeated products summed in float32) at the four
shapes of the original, [1024, K] x [K, 1024] for K = 64, 128 (the S = Q K^T
contraction) and [1024, 1024] x [1024, N] for N = 64, 128 (the O = P V
output), beside its plain version, and prints the K=64/K=128 and N=64/N=128
ratios: does a head dim of 64 cost half of 128 on the tensor cores?
`--bwd-kernels` splits one bf16 backward call at [batch, heads/hkv, ctx,
dim] (`segs` equal packed segments, causal unless `--noncausal`) into its
three CUDA kernels (the delta / segment-range prep, dK / dV, dQ): the
device time of each, a call's mean over `--iters` calls under
`torch.profiler`, beside the whole call's time in a CUDA graph of
`--iters` calls. The command needs a CUDA card; `bench_shape` and `probe`
also take a CPU device, where the wrappers run their plain versions.

The original's `--sweep` and `--skip-sweep` tune the Pallas kernel's block
sizes; the port's kernels have fixed tiles, so those flags do not exist here.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from ..ops import flash_attention_bwd, flash_attention_fwd, matmul_probe
from ..ops.matmul_probe import REPS, SHAPES, matmul_probe_reference


def time_ms(fn, dev: torch.device, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call: between CUDA events on a card, on the
    host's clock on the CPU."""
    for _ in range(warmup):
        fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(dev)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / iters


def bench_shape(dev, b=8, h=14, t=1024, d=64, hkv=None, segs=8, iters=20) -> dict:
    """Forward and forward + backward ms at [b, h/hkv, t, d] (bf16 on a card,
    float32 on the CPU) with `segs` equal packed segments."""
    g = torch.Generator(device=dev).manual_seed(0)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    mk = lambda heads: torch.randn((b, heads, t, d), generator=g, device=dev).to(dtype)
    q, k, v = mk(h), mk(hkv or h), mk(hkv or h)
    seg = (torch.arange(t, device=dev) // (t // segs)).to(torch.int32).expand(b, t).contiguous()
    fwd = lambda: flash_attention_fwd(q, k, v, segment_ids=seg)

    def fwd_bwd():
        out, lse = fwd()
        return flash_attention_bwd(q, k, v, out, lse, 2 * out, segment_ids=seg)

    return dict(shape=[b, h, hkv or h, t, d], fwd_ms=time_ms(fwd, dev, iters),
                fwd_bwd_ms=time_ms(fwd_bwd, dev, iters))


def graph_ms(fn, iters: int) -> float:
    """Device ms a call: `iters` calls captured in one CUDA graph and
    replayed between CUDA events (no host time between the calls)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):        # warm-up off the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def backward_kernels(dev, b=4, h=8, hkv=2, t=1024, d=256, segs=4, causal=True,
                     iters=10) -> dict:
    """Device microseconds a call of each CUDA kernel of the bf16 backward
    at [b, h/hkv, t, d] with `segs` equal packed segments, averaged over
    `iters` profiled calls, and the call's graph ms."""
    import re

    from torch.profiler import ProfilerActivity, profile

    from ..ops.flash_attention import _launch, _launch_bwd

    g = torch.Generator(device=dev).manual_seed(0)
    mk = lambda heads: torch.randn((b, heads, t, d), generator=g, device=dev).to(torch.bfloat16)
    q, k, v, do = mk(h), mk(hkv), mk(hkv), mk(h)
    seg = (torch.arange(t, device=dev) // -(-t // segs)).to(torch.int32).expand(b, t).contiguous()
    scale = d ** -0.5
    out, lse = _launch(q, k, v, seg, seg, causal, scale)
    call = lambda: _launch_bwd(q, k, v, out, lse, do, seg, seg, causal, scale)
    call()
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            call()
        torch.cuda.synchronize(dev)
    times = {}
    for evt in prof.key_averages():
        total = getattr(evt, "device_time_total", None)
        if total is None:
            total = evt.cuda_time_total
        name = re.search(r"flash_bwd_\w+", evt.key)
        if name and total > 0:
            times[name.group(0)] = times.get(name.group(0), 0.0) + total / iters
    return dict(shape=[b, h, hkv, t, d], segs=segs, causal=causal, kernel_us=times, total_us=sum(times.values()), graph_ms=graph_ms(call, iters))


def probe(dev, shapes=SHAPES, reps: int = REPS, iters: int = 20) -> dict:
    """The probe kernel and its plain version at `shapes` (M, K, N)."""
    rows = []
    for m, k, n in shapes:
        g = torch.Generator(device=dev).manual_seed(m + k + n)
        a = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
        b = torch.randn((k, n), generator=g, device=dev).to(torch.bfloat16)
        ms = time_ms(lambda: matmul_probe(a, b, reps), dev, iters)
        plain_ms = time_ms(lambda: matmul_probe_reference(a, b, reps), dev, max(iters // 4, 1))
        flops = 2 * m * k * n * reps
        rows.append(dict(m=m, k=k, n=n, reps=reps, ms=ms, plain_ms=plain_ms,
                         tflops=flops / ms * 1e-9))
        print(f"  [{m},{k}]x[{k},{n}] x{reps}: kernel {ms:.4f} ms ({flops / ms * 1e-9:.1f} "
              f"TFLOP/s), plain {plain_ms:.4f} ms", flush=True)
    by_shape = {(r["m"], r["k"], r["n"]): r["ms"] for r in rows}
    ratios = {}
    for name, small, big in (("k64_over_k128", (1024, 64, 1024), (1024, 128, 1024)),
                             ("n64_over_n128", (1024, 1024, 64), (1024, 1024, 128))):
        if small in by_shape and big in by_shape:
            ratios[name] = by_shape[small] / by_shape[big]
            print(f"  {name.replace('_over_', ' / ').upper()} ratio: {ratios[name]:.3f}",
                  flush=True)
    return dict(shapes=rows, ratios=ratios)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--matmul-probe", action="store_true")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--hkv", type=int, default=None, help="kv heads (GQA); default: all heads")
    ap.add_argument("--heads", type=int, default=14,
                    help="q heads (14 = Slam; 7 for slam_dh128)")
    ap.add_argument("--dim", type=int, default=64, help="head dim (64 = Slam; 128 for slam_dh128)")
    ap.add_argument("--bwd-kernels", action="store_true",
                    help="the bf16 backward's device time by CUDA kernel")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--ctx", type=int, default=1024)
    ap.add_argument("--segs", type=int, default=4)
    ap.add_argument("--noncausal", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_flash: needs a CUDA card", file=sys.stderr)
        return 1
    from .slam_recipe import nvidia_smi

    dev = torch.device("cuda", 0)
    where = torch.cuda.get_device_name(dev)
    if args.matmul_probe:
        print(f"contraction probe on {where}:", flush=True)
        result = probe(dev, iters=args.iters)
    elif args.bwd_kernels:
        result = backward_kernels(dev, b=args.batch, h=args.heads, hkv=args.hkv or args.heads,
                                  t=args.ctx, d=args.dim, segs=args.segs,
                                  causal=not args.noncausal, iters=args.iters)
        print(f"backward {result['shape']} causal={result['causal']} on {where}: "
              + ", ".join(f"{k} {v:.1f} us" for k, v in result["kernel_us"].items())
              + f"; {result['total_us']:.1f} us in all; graph {result['graph_ms']:.4f} ms a "
              f"call", flush=True)
    else:
        result = bench_shape(dev, h=args.heads, d=args.dim, hkv=args.hkv, iters=args.iters)
        b, h, hkv, t, d = result["shape"]
        print(f"[{b},{h}/{hkv},{t},{d}] on {where}: fwd {result['fwd_ms']:.4f} ms  "
              f"fwd+bwd {result['fwd_bwd_ms']:.4f} ms", flush=True)
    result["device"] = nvidia_smi()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
