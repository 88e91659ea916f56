"""Cycles of each phase inside a CTA of the float32 flash kernels and of the
bf16 backward's dK/dV pass at head dim 128.

    python -m slamkit_tpu_torch.tools.cta_clocks [--json PATH]

Builds `ops/csrc/flash_fwd_f32.cu`, `flash_bwd_f32.cu` and `flash_bwd.cu`
with `-DSLAMKIT_CTA_CLOCKS` into libraries of their own name
(`libflash_fwd_f32_slamkit_cta_clocks.so`, ...; the main path's libraries
hold no stamp), runs each once at the shapes of `chip_smoke.py` phases 3e
(forward), 3f (backward) and 3b (the bf16 backward at d = 128), and prints,
per kernel (the forward; the float32 backward's dK/dV and dQ passes; the
bf16 d = 128 dK/dV pass), the median and mean cycles of a CTA's phases,
read by thread 0 with clock64 (`hopper.cuh`'s marks):

  * list:  entry to the tile list ready (the segment-range scan);
  * first: to the first tile's operands in shared memory;
  * loop:  the tile loop, and its cycles per tile visited;
  * tail:  the epilogue (normalise and store; the dK/dV sums over the
           warpgroups and the cluster);
  * total, and the CTAs and tiles a CTA.

The command needs a CUDA card; it exits 1 without one. Stamping costs a few
global stores a CTA, so the cycles are the kernels' own, give or take those.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys

import numpy as np
import torch

from ..ops.flash_attention import (KERNEL_BWD, KERNEL_BWD_F32, KERNEL_F32, _build, _launch,
                                   _launch_bwd)

DEFINES = ("SLAMKIT_CTA_CLOCKS",)
WORDS = 6            # hopper.cuh's kClockWords: 5 marks, then the tiles visited
TILE = 64


def _packed(rng, b, t, n_seg):
    seg = np.full((b, t), -1, np.int32)
    for r in range(b):
        used = t - int(rng.integers(0, t // 10))
        cuts = np.sort(rng.choice(np.arange(1, used), n_seg - 1, replace=False))
        for s, (lo, hi) in enumerate(zip(np.r_[0, cuts], np.r_[cuts, used])):
            seg[r, lo:hi] = s
    return seg


def _right_padded(rng, b, t, lo):
    seg = np.full((b, t), -1, np.int32)
    for r in range(b):
        seg[r, :int(rng.integers(lo, t + 1))] = 0
    return seg


def _left_padded(rng, b, t, most):
    seg = np.zeros((b, t), np.int32)
    for r in range(b):
        seg[r, :int(rng.integers(0, most))] = -1
    return seg


# name, (B, H, Hkv, T, D), ids: chip_smoke.py's phase 3e (forward) and 3f
# (backward) cases that the float32 paths run
FORWARD = [
    ("genppl_score", (8, 32, 8, 3584, 64), lambda r: _right_padded(r, 8, 3584, 1700)),
    ("judge_prefill", (8, 32, 8, 7680, 64), lambda r: _left_padded(r, 8, 7680, 2000)),
    ("llama1b_f32", (8, 32, 8, 512, 64), lambda r: _right_padded(r, 8, 512, 40)),
    ("slam_f32", (8, 14, 2, 1024, 64), lambda r: _packed(r, 8, 1024, 8)),
    ("twist_f32", (8, 12, 12, 512, 64), lambda r: _packed(r, 8, 512, 4)),
]
BACKWARD = [
    ("slam_f32", (8, 14, 2, 1024, 64), lambda r: _packed(r, 8, 1024, 8)),
    ("twist_f32", (8, 12, 12, 512, 64), lambda r: _packed(r, 8, 512, 4)),
    ("d128_f32", (8, 7, 1, 1024, 128), lambda r: _packed(r, 8, 1024, 8)),
    ("dpo_f32", (16, 14, 2, 152, 64), lambda r: _right_padded(r, 16, 152, 110)),
]
# ... and phase 3b's bf16 backward at d = 128 (slam_dh128; SIMS 7B on fsdp [4])
BACKWARD_D128 = [
    ("d128_ctx1024", (8, 7, 1, 1024, 128), lambda r: _packed(r, 8, 1024, 8)),
    ("fsdp4_sims7b", (2, 28, 4, 2048, 128), lambda r: _packed(r, 2, 2048, 4)),
]


def _set_slot(lib_name: str, slot: int, buf) -> None:
    fn = _build.load(lib_name, DEFINES).slamkit_cta_clocks
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(slot, None if buf is None else buf.data_ptr())
    if err != 0:
        raise RuntimeError(f"slamkit_cta_clocks failed: CUDA error {err}")


def summarize(rows: np.ndarray) -> dict:
    """Phase cycles of a [CTAs, WORDS] stamp table (CTAs that never ran
    their stamps, all zeros, are dropped)."""
    rows = rows[rows[:, 0] != 0].astype(np.int64)
    d = np.diff(rows[:, :5], axis=1)
    tiles = rows[:, 5]
    total = rows[:, 4] - rows[:, 0]
    per_tile = d[tiles > 0, 2] / tiles[tiles > 0]
    stat = lambda x: {"median": float(np.median(x)), "mean": float(np.mean(x))} if x.size else None
    return {"ctas": int(rows.shape[0]), "tiles_per_cta": stat(tiles),
            "list": stat(d[:, 0]), "first": stat(d[:, 1]), "loop": stat(d[:, 2]),
            "loop_per_tile": stat(per_tile), "tail": stat(d[:, 3]), "total": stat(total)}


def _grid_ctas(shape, backward: bool, bf16: bool = False):
    b, h, hkv, t, _ = shape
    n_t = (t + TILE - 1) // TILE
    if not backward:
        return {"fwd": h * b * n_t}
    if bf16:     # the d = 128 dK/dV pass: at most 8 CTAs (a cluster) a kv group and key tile
        return {"dkdv": 8 * hkv * b * n_t}
    # the dK/dV pass launches at most H CTAs a kv group and key tile
    return {"dkdv": h * b * n_t, "dq": h * b * n_t}


def run_case(dev, name, shape, make_seg, backward: bool, bf16: bool = False) -> dict:
    """One launch of the stamped forward (or backward; in bf16, `bf16`) at
    `shape`."""
    b, h, hkv, t, d = shape
    g = torch.Generator(device=dev).manual_seed(7)
    dtype = torch.bfloat16 if bf16 else torch.float32
    mk = lambda hh: torch.randn((b, hh, t, d), generator=g, device=dev).to(dtype)
    q, k, v = mk(h), mk(hkv), mk(hkv)
    seg = torch.from_numpy(make_seg(np.random.default_rng(5))).to(dev)
    scale = d ** -0.5
    lib = (KERNEL_BWD if bf16 else KERNEL_BWD_F32) if backward else KERNEL_F32
    bufs = {kind: torch.zeros((n, WORDS), dtype=torch.int64, device=dev)
            for kind, n in _grid_ctas(shape, backward, bf16).items()}
    out, lse = _launch(q, k, v, seg, seg, True, scale)
    for slot, buf in enumerate(bufs.values()):
        _set_slot(lib, slot, buf)
    try:
        if backward:
            _launch_bwd(q, k, v, out, lse, mk(h), seg, seg, True, scale, defines=DEFINES)
        else:
            _launch(q, k, v, seg, seg, True, scale, defines=DEFINES)
        torch.cuda.synchronize(dev)
    finally:
        for slot in range(len(bufs)):
            _set_slot(lib, slot, None)
    return {kind: summarize(buf.cpu().numpy()) for kind, buf in bufs.items()}


def _line(name, shape, kind, s) -> str:
    f = lambda key: f"{s[key]['median']:.0f}" if s[key] else "-"
    return (f"cta_clocks {kind:4s} {name:14s} {shape}: {s['ctas']} CTAs, tiles/CTA "
            f"{s['tiles_per_cta']['mean']:.2f}; median cycles list {f('list')} first "
            f"{f('first')} loop {f('loop')} ({f('loop_per_tile')} a tile) tail {f('tail')} "
            f"total {f('total')} (mean {s['total']['mean']:.0f})")


def run(dev) -> dict:
    result = {"device": torch.cuda.get_device_name(dev), "forward": {}, "backward": {},
              "backward_bf16_d128": {}}
    for section, cases, backward, bf16 in (("forward", FORWARD, False, False),
                                           ("backward", BACKWARD, True, False),
                                           ("backward_bf16_d128", BACKWARD_D128, True, True)):
        for name, shape, make_seg in cases:
            res = run_case(dev, name, shape, make_seg, backward, bf16)
            result[section][name] = {"shape": list(shape), **res}
            for kind, s in res.items():
                print(_line(name, list(shape), kind, s), flush=True)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default=None, help="also write the summary here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("cta_clocks needs a CUDA card", file=sys.stderr)
        return 1
    result = run(torch.device("cuda", 0))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
