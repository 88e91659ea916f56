"""Dense against int8 weight-only decoding.

    python -m slamkit_tpu_torch.tools.bench_decode [--ckpt DIR] [--iters 3] [--profile N]

The counterpart of `scripts/bench_decode.py`: B=16 prompts of 32 random
units, 150 new tokens sampled with temperature 0.8 and top-k 25 (seed 0),
through `UnitLM.generate` once dense (bf16 weights) and once with
`weight_quant="int8"` (every projection through the dq_matmul kernel). Each
is warmed up once and then timed over `--iters` calls with the card
synchronised around them. Prints ms per new token, new tokens/s, the int8
over dense speed-up and the dq_matmul launches of one int8 call, as one JSON
line. The model is the Slam width with random weights from a seed, or a
checkpoint directory (`--ckpt`). `--profile N` then traces one call of each
with N new tokens under torch.profiler on the card and prints, per mode, the
call's wall time untraced, the device's busy time in the traced call (the
sum of the kernels' device time) and the kernels that take the most of it,
then the host's time to issue one decode projection as the bf16 product
and as dq_matmul.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..models import UnitLM
from ..ops import dq_matmul, quantize_weight

B, PROMPT, NEW = 16, 32, 150


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(lm: UnitLM, batch: int = B, prompt: int = PROMPT, new: int = NEW,
        iters: int = 3) -> dict:
    """Dense and int8 generation timings of `lm` on its device."""
    prompts = np.random.default_rng(7).integers(2, lm.config.vocab_size, (batch, prompt))
    res = {"batch": batch, "prompt": prompt, "new_tokens": new}
    for name, quant in (("dense_bf16", None), ("int8", "int8")):
        kw = dict(max_new_tokens=new, do_sample=True, temperature=0.8, top_k=25, seed=0,
                  weight_quant=quant)
        before = dq_matmul.launches
        lm.generate(prompts, **kw)                # warm-up (and the int8 weights)
        _sync(lm.device)
        res[f"{name}_dq_launches_per_call"] = dq_matmul.launches - before
        t0 = time.perf_counter()
        for _ in range(iters):
            out = lm.generate(prompts, **kw)
        _sync(lm.device)
        dt = (time.perf_counter() - t0) / iters
        assert tuple(out.shape) == (batch, prompt + new), out.shape
        res[f"{name}_ms_per_token"] = dt / new * 1e3
        res[f"{name}_new_tokens_per_s"] = batch * new / dt
    res["speedup"] = res["dense_bf16_ms_per_token"] / res["int8_ms_per_token"]
    return res


def profile(lm: UnitLM, batch: int = B, prompt: int = PROMPT, new: int = 20,
            top: int = 6) -> dict:
    """Dense and int8: wall ms of an untraced call, device busy ms of a traced
    one, and its `top` kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    if lm.device.type != "cuda":
        raise RuntimeError("the profile traces the card's kernels: the model is on "
                           f"{lm.device}")
    prompts = np.random.default_rng(7).integers(2, lm.config.vocab_size, (batch, prompt))
    res = {"batch": batch, "prompt": prompt, "new_tokens": new}
    for name, quant in (("dense_bf16", None), ("int8", "int8")):
        kw = dict(max_new_tokens=new, do_sample=True, temperature=0.8, top_k=25, seed=0,
                  weight_quant=quant)
        lm.generate(prompts, **kw)
        _sync(lm.device)
        t0 = time.perf_counter()
        lm.generate(prompts, **kw)
        _sync(lm.device)
        wall_ms = (time.perf_counter() - t0) * 1e3
        with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            lm.generate(prompts, **kw)
            _sync(lm.device)
        kernels = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                          and not getattr(e, "is_user_annotation", False)),
                         key=lambda e: -e.self_device_time_total)
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        res[name] = {"wall_ms": wall_ms, "busy_ms": busy_ms, "busy_share": busy_ms / wall_ms,
                     "kernels": [{"name": e.key[:80], "calls": e.count,
                                  "us_a_call": e.self_device_time_total / e.count}
                                 for e in kernels[:top]]}
    res["host_us_a_projection"] = projection_host_us(lm, batch)
    return res


def projection_host_us(lm: UnitLM, rows: int, calls: int = 3000) -> dict:
    """Host microseconds to issue one decode projection (the MLP up, [rows,
    hidden] x [hidden, intermediate]) as the bf16 product and as dq_matmul:
    `calls` calls enqueued back to back on the host clock, the card
    synchronised only before and after, so a call's device time is hidden
    unless it exceeds its host time."""
    cfg = lm.decoder.cfg
    dev = lm.device
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((rows, cfg.hidden_size), generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn((cfg.hidden_size, cfg.intermediate_size), generator=g, device=dev) * 0.02
    q, s = quantize_weight(w)
    w = w.to(torch.bfloat16)
    out = {}
    for name, fn in (("bf16_matmul", lambda: x @ w), ("dq_matmul", lambda: dq_matmul(x, q, s))):
        for _ in range(50):
            fn()
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out[name] = (time.perf_counter() - t0) / calls * 1e6
        _sync(dev)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ckpt", default=None, help="a UnitLM checkpoint directory")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="also trace one call of each with N new tokens")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_decode: needs a CUDA card", file=sys.stderr)
        return 1
    from .slam_recipe import nvidia_smi, slam_config

    dev = torch.device("cuda", 0)
    if args.ckpt:
        lm = UnitLM.from_pretrained(args.ckpt, device=dev)
    else:
        lm = UnitLM(slam_config(), seed=0, device=dev)
    res = run(lm, iters=args.iters)
    if args.profile:
        res["profile"] = profile(lm, new=args.profile)
    res["device"] = nvidia_smi()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
