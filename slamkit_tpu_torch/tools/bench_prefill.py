"""The int8 prefill GEMM of one checkout, graph-timed beside the dense product.

    python slamkit_tpu_torch/tools/bench_prefill.py [--root DIR] [--m 600 608 1024] [--rounds 3]

Times `dq_matmul` at M > 16, where it runs the prefill GEMM
(`dq_gemm_kernel`), at the Slam decoder's four (K, N) projections: q/o
896x896, k/v 896x128, up/gate 896x4864 and down 4864x896. The time is the
CUDA-graph device time of a call (50 calls captured in one graph, replayed
between CUDA events), beside the dense `x @ w` with w dequantized before the
timing. Every output is held within one bf16 ulp of `dq_matmul_reference`.

`--root` names the checkout whose `slamkit_tpu_torch` is timed (default: the
one that holds this file), so that two commits compare on one card: unpack
the other with `git archive` into a git-ignored directory and run this file
once per root, alternating (other, this, this, other). Run it as a file, not
with `python -m`, so that the package is imported from `--root`. Prints the
card's name and power limit, then one JSON line per shape and round. Needs a
CUDA card.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

# the Slam decoder's (K, N) projection shapes, named
SLAM_KN = (("q/o", 896, 896), ("k/v", 896, 128), ("up/gate", 896, 4864), ("down", 4864, 896))


def graph_ms(fn, iters: int = 50) -> float:
    """Device ms a call: `iters` calls in one CUDA graph, replayed between
    CUDA events (the warm-up runs off the capture, on a side stream)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=pathlib.Path,
                    default=pathlib.Path(__file__).resolve().parents[2],
                    help="checkout whose slamkit_tpu_torch is timed")
    ap.add_argument("--m", type=int, nargs="+", default=[600, 608, 1024],
                    help="rows of x (> 16: the prefill GEMM)")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("bench_prefill: needs a CUDA card", file=sys.stderr)
        return 1
    if any(m <= 16 for m in args.m):
        print("bench_prefill: every --m must be above 16 (below, dq_matmul runs the "
              "decode GEMV)", file=sys.stderr)
        return 2
    from slamkit_tpu_torch.ops import dequantize_weight, dq_matmul, dq_matmul_reference
    from slamkit_tpu_torch.ops import quantize_weight
    from slamkit_tpu_torch.ops.quant import ulp_bound
    from slamkit_tpu_torch.tools.slam_recipe import nvidia_smi

    import slamkit_tpu_torch

    dev = torch.device("cuda", 0)
    print(nvidia_smi(), flush=True)
    print(f"timing {pathlib.Path(slamkit_tpu_torch.__file__).parent}", flush=True)
    worst = 0.0
    for rnd in range(args.rounds):
        for m in args.m:
            for name, k, n in SLAM_KN:
                g = torch.Generator(device=dev).manual_seed(m + k + n)
                x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
                q, s = quantize_weight(torch.randn((k, n), generator=g, device=dev) * 0.02)
                got, want = dq_matmul(x, q, s).float(), dq_matmul_reference(x, q, s).float()
                ulps = ((got - want).abs() / ulp_bound(got, want)).max().item()
                worst = max(worst, ulps)
                w = dequantize_weight(q, s)
                ms = graph_ms(lambda: dq_matmul(x, q, s))
                dense_ms = graph_ms(lambda: x @ w)
                print(json.dumps({"round": rnd, "projection": name, "m": m, "k": k, "n": n,
                                  "graph_ms": ms, "tflops": 2 * m * k * n / ms * 1e-9,
                                  "dense_graph_ms": dense_ms, "max_ulps": ulps}), flush=True)
    if worst > 1.0:
        print(f"bench_prefill: an output was {worst:.2f} bf16 ulp from the plain version "
              f"(bound 1)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
