#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training, speech-continuation and DPO
slices and its command line once on an NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card (an H100 for
the sm_90a kernels). Phases, in order; any failure exits non-zero:

  1. device  — require CUDA; print the card, its power limit and versions;
               switch TF32 off for float32 matmuls and cuDNN.
  2. build   — compile the four CUDA kernels from `slamkit_tpu_torch/ops/csrc`,
               one nvcc per source, all started together.
  3. kernels — the flash-attention forward kernel against its plain PyTorch
               version (float32 from the same bf16 inputs) at the slices'
               shapes, each timed twice between CUDA events: as eager calls,
               and as a CUDA-graph replay (device time without the host's
               overhead). Beside it, per shape: the library call that
               computes the same function (`scaled_dot_product_attention`
               with the segment and causal mask as a bool [B, 1, T, T] and
               GQA; the backend that ran is printed), graph-timed the same
               way and never used by the port; the bound (the larger of the
               bytes over 3.35 TB/s and the visible pairs' FLOPs over 989
               TFLOP/s, H100 SXM data sheet); roofline_share = bound / kernel
               and vs_library = kernel / library. Each call is repeated and
               must give bitwise the same out and LSE.
  3b. backward kernels — the flash backward (dq, dk, dv) against its plain
               version the same way, at the training shapes; its library
               call is the backward of the same SDPA call, timed alone.
  3c. dq_matmul — the int8 dequant-matmul kernel against its plain version
               at the Slam decoder's four (K, N) projection shapes, for the
               decode rows (M = 8 and 16) and the prefill rows (M = 600 and
               1024); library call `torch._weight_int8pack_mm`; beside each
               prefill row the dense path's `x @ w` (bf16, weight dequantized
               before the timing).
  3d. probe  — the contraction-probe kernel against its plain version at its
               four shapes, the K=64/K=128 and N=64/N=128 time ratios, then
               its entry point `tools/bench_flash.py --matmul-probe` (no
               single PyTorch call computes the probe: no library time).
  4. scoring — a Slam-width UnitLM (Qwen2.5-0.5B decoder, 502 units, bf16,
               random init from a seed) saved and reloaded with
               save_pretrained / from_pretrained, scoring 8 unit-token
               requests of 100-1000 units with log_likelihood; 2 short rows are
               checked against the same weights in float32 on the CPU.
  5. generation — 8 ragged 50-75-unit prompts through generate with the
               generate.yaml settings (temperature 0.8, top-k 25, 150 new
               tokens, seeded torch.Generator), then one greedy pass.
  6. training — the Slam pretraining recipe at full width and depth through
               `SLAMTrainer.train()`: a seeded synthetic tokens.jsonl of
               low-entropy Markov unit strings read through the port's
               tokeniser, `parse_single_dataset` and best-fit packing; B=8 x
               accumulation 16 at context 1024, bf16 AdamW moments, clip 0.5,
               cosine_with_min_lr, full remat. Four steps with a save at step
               3, then a second run resumed from that checkpoint, whose step-4
               loss must match; the export reloads and scores.
  7. card vs CPU — one packed [2, 256] microbatch at full width: loss and
               every parameter gradient in bf16 on the card against float32
               on the CPU, on the same weights.
  8. speech  — eight seeded 3 s 16 kHz WAV prompts through
               `generative_metric.generate` and a SpeechLM of mhubert-base-25hz
               HuBERT (tap 11) + a 500-unit k-means (centroids drawn from the
               prompts' own features) + the Slam UnitLM + the CodeHiFiGAN at
               its published widths, all with seeded random weights;
               generate.yaml's sampling settings with
               weight_quant="int8", then dense. Then every dq_matmul call of
               one int8 prefill (M = 8 x the prompt's length) and one decode
               step held to its plain version within one bf16 ulp; HuBERT,
               the int8 prefill logits and the vocoder on the card against
               float32 CPU runs (or the plain dequant path) on the same
               weights.
  9. command line — `slamkit_tpu_torch.cli.train` in process on the repo's
               config/ tree with the paper's model=slam (twist_init left
               true: no Qwen weights on disk, so the TWIST warm start logs
               its random-init fallback), full width and depth, packing,
               remat, bf16 moments, 2 steps of 4 x 8 at context 1024 on a
               seeded Markov corpus, a save at step 2, step 2 traced by
               training_args.profile_steps=1; the checkpoint reloaded through
               model.pretrained_model with remat on; then
               `slamkit_tpu_torch.cli.eval` metric=sblimp on it over 32
               seeded WAV pairs, through a random mhubert-base-25hz written
               to disk as an HF directory and 500 centroids drawn from its
               features, and the first scoring call's first 4 utterances
               held against the same checkpoint in float32 on the CPU.
  10. data preparation and DPO — in phase 9's work directory:
               `cli.extract_features ext=wav` over phase 9's WAV pairs and
               `cli.prepare_tokens` on its features.jsonl, every line held to
               a direct `audio_represent` of the same batch of files;
               `cli.preference_alignment_feature_extractor` over 16 seeded
               WAV triples (3 s prompts, 1-2 s completions); then
               `cli.preference_alignment_train` from phase 9's checkpoint-2
               (dpo_training_args: lr 5e-5, beta 0.1, 8 pairs a step, so
               [16, 152] batches) on a seeded Markov preference set of 64
               rows (prompts of 100 units, completions of 50) for 4 steps
               with a save at step 3, whose step-1 loss must be ln 2; a run
               resumed from that save must repeat step 4; the export reloads
               and scores; one [2 x 2, 152] batch in bf16 on the card against
               float32 on the CPU (loss, rewards, every gradient).

Phases 3 and 3b also hold the kernels at DPO's shape (`dpo_T152`: [16, 14/2,
152, 64], one segment of 110-152 tokens a row and a -1 tail).

Each main path runs with the launch counters zeroed just before it and read
just after: every scoring forward and every generation prefill launches the
forward kernel once per layer (phases 4-5); every training microbatch
launches it twice per layer (forward and remat recompute) and the backward
kernel once per layer (phase 6); every int8 generate call calls dq_matmul
for the 7 projections of every layer in the prefill and in each decode step
(7 x 24 x 150 = 25200, each one kernel launch) and the flash forward once
per layer (phase 8); the command line's training launches them as phase 6
does, and its scoring the forward once per layer a call (phase 9); every
DPO step launches the forward once per layer for the reference and 1 +
remat times for the policy, and the backward once per layer, and every DPO
evaluation batch the forward twice per layer (phase 10); the probe's entry
point launches its kernel 7 times a shape (phase 3d). A flash backward call
counts one, though it launches three kernels (the delta / segment-range
pre-pass, dK/dV, dQ). The last lines are a JSON object with every measurement, the card's name and power limit, a
JSON object describing each kernel at its representative shape, and
`{"ok": true, "device": {...}}`. In the kernel line, `ms` and `plain_ms` are
eager times between CUDA events (host overhead included, as in every
earlier version of the line); `graph_ms`, `plain_graph_ms` and `library_ms`
are CUDA-graph device times, and `roofline_share` and `vs_library` are
reckoned from them; `library_timed` says how the library call was timed, or
why it has no time (`library_ms` is then null: a library call whose graph
capture fails is not timed another way). The dq_matmul entry is timed at
a decode shape (the GEMV, M <= 16) and carries the prefill GEMM's own times
(M > 16) at M = 1024, up / gate, under `prefill`, beside the dense path's
`dense_graph_ms`.
"""
from __future__ import annotations

import json
import math
import pathlib
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent

PAD, BOS_EOS = 0, 1   # the unit tokeniser's special ids

# kernel-vs-plain bounds: bf16 probabilities and a bf16 output (|out| < 4:
# 2 * 4 * 2^-8 = 3e-2); LSE comes from float32 scores of bf16 inputs
OUT_BOUND, LSE_BOUND = 3e-2, 2e-3
# backward: max |kernel - plain| of each of dq, dk, dv within 1e-2 of that
# gradient's max |plain| (+1e-5 for gradients that cancel to ~0): the kernel
# rounds P and dS to bf16 for its products (2^-9 relative each) and stores
# bf16 gradients (2^-9 of the largest); its sums over T run in float32
BWD_REL_BOUND = 1e-2
# and row by row, so that a fault where gradients are small cannot hide under
# the largest: for every token and head, ||kernel row - plain row||_2 <=
# 2e-2 ||plain row||_2 + 1e-3. The same roundings give a row ~2^-9 relative
# error (an emulation of them in float32 on the CPU: median 2.3e-3, worst
# 5e-3); 1e-3 covers rows whose exact gradient is 0 (a query that sees only
# itself: dS = P (dP - delta) cancels to float32 noise, ~1e-5), against row
# norms of ~1 at these shapes
BWD_ROW_RTOL, BWD_ROW_ATOL = 2e-2, 1e-3
# bf16 card vs float32 CPU on the same weights, mean NLL per row (~6.2 nats)
NLL_BOUND = 2e-2
# training: the resumed run's step-4 loss against the uninterrupted run's.
# Both runs execute the same deterministic kernels (no atomics in the flash
# backward, the same cuBLAS calls) on the same restored state and the same
# replayed batches, so they agree to float32 summation noise; 1e-3 nats
# leaves room for a cuBLAS heuristic that picks another split between runs.
RESUME_BOUND = 1e-3
# card (bf16 compute) vs CPU (float32) on one [2, 256] microbatch: the loss
# (~6.2 nats) within 2e-2 as scoring's NLL; every parameter gradient's
# cosine with the float32 one >= 0.99 (bf16 activations carry ~3 significant
# digits, which bends a gradient by ~1e-2 radians at most)
TRAIN_LOSS_BOUND, GRAD_COSINE_FLOOR = 2e-2, 0.99
# DPO, card vs CPU on one [2 x 2, 152] batch: the loss within 2e-2 and every
# gradient's cosine >= 0.99, as above. A row's summed completion
# log-probability within 2e-2 a token (the per-token bound of a mean NLL
# above, times the row's completion tokens); a reward, beta times the mean
# of (policy - reference) sums, within beta x 2 x that; a margin, the
# difference of two rewards, within twice that; and the sign of a margin
# agrees wherever the CPU's margin is further than its bound from 0
DPO_TOKEN_BOUND = 2e-2
# the Slam decoder's (K, N) projection shapes: q/o 896x896, k/v 896x128,
# up/gate 896x4864, down 4864x896
SLAM_KN = ((896, 896), (896, 128), (896, 4864), (4864, 896))
# phase 8, card against float32 CPU on the same weights. HuBERT runs float32
# on both (TF32 off), so its tapped features differ by summation order only
# (~1e-6 relative per stage over ~20 stages): ||card - cpu|| / ||cpu|| <=
# 1e-4 (a TF32 or bf16 path would sit at 1e-3 or more). Unit ids: at least
# 0.98 of them equal, since an argmin over 500 centroids may flip on a
# near-tie
HUBERT_REL_BOUND, UNIT_AGREE_FLOOR = 1e-4, 0.98
# int8 prefill logits, the dq_matmul kernel against its plain version inside
# the same bf16 forward. Each projection output may round one bf16 ulp
# (2^-8) the other way, and every later bf16 op re-rounds what such a flip
# moved, so the logits differ by the bf16 forward's own noise, not by
# anything the kernel adds. The yardstick is that noise measured on the same
# prompt: the plain path against the plain product in the Pallas kernel's
# order (the scale after the sum), which differs from it the same way.
# ||kernel - plain|| / ||plain|| <= 3 x that (floored at 1e-3): a wrong
# column or scale would sit near 1
INT8_LOGIT_YARDSTICK_FACTOR = 3.0
# the vocoder body on the same conditioning, float32 on both (TF32 off for
# cuDNN): max |d| of the tanh waveform <= 1e-4. Durations round(exp(d) - 1)
# are compared apart: at least 0.98 of them equal, none off by more than 1
VOCODER_ABS_BOUND, DURATION_AGREE_FLOOR = 1e-4, 0.98
# scripts/bench_vocoder.py::FULL_CFG: the textless CodeHiFiGAN's published
# widths (50 Hz frames, 320x upsample to 16 kHz)
CODEHIFIGAN_CFG = {
    "model_in_dim": 128, "num_embeddings": 504, "embedding_dim": 128,
    "upsample_initial_channel": 512, "upsample_rates": [5, 4, 4, 2, 2],
    "upsample_kernel_sizes": [11, 8, 8, 4, 4], "resblock_kernel_sizes": [3, 7, 11],
    "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
    "dur_predictor_params": {"encoder_embed_dim": 128, "var_pred_hidden_dim": 256,
                             "var_pred_kernel_size": 3, "var_pred_dropout": 0.5},
}
# config/metric/generate.yaml's generate_kwargs, seeded
GENERATE_KWARGS = dict(temperature=0.8, top_k=25, max_new_tokens=150, do_sample=True, seed=0)
# the bound of a kernel: the H100 SXM's memory rate and dense bf16 tensor-core
# rate (NVIDIA data sheet), against which every roofline share is stated
HBM_BYTES_PER_S, BF16_FLOPS_PER_S = 3.35e12, 989e12
# published dense bf16 tensor-core peaks (NVIDIA data sheets), by card name
BF16_PEAK_FLOPS = (("H100 PCIe", 756e12), ("H100 NVL", 835e12), ("H100", 989e12),
                   ("H200", 989e12))


def tokenise_units(reprs: list[str], prompt: bool = False) -> np.ndarray:
    """`<UnN>` strings -> a padded id batch through the port's UnitTokeniser:
    `<S> units <S>` with right pads or, with prompt=True, as `build_prompt`
    does (no trailing `<S>`, left pads)."""
    from slamkit_tpu_torch.tokeniser import UnitTokeniser

    tok = UnitTokeniser()
    if prompt:
        return tok.prompt_tokenise(reprs)["input_ids"]
    return tok.string_tokenise(reprs, padding=True)["input_ids"]


def _unit_strings(rng, lengths) -> list[str]:
    return ["".join(f"<Un{u}>" for u in rng.integers(0, 500, n)) for n in lengths]


def _require(ok: bool, msg: str):
    if not ok:
        raise SystemExit(f"chip_smoke: {msg}")


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _cuda_ms(fn, warmup: int, iters: int) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(fn, iters: int) -> float:
    """Device time per call: `iters` calls captured in one CUDA graph and
    replayed between CUDA events, so the host's per-call overhead (which
    back-to-back eager calls pay when a call is short) is left out."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):        # warm-up off the capture, as required
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


def _packed_segments(rng, b, t, n_seg):
    """[b, t] ids: n_seg packed segments of random length, then a -1 tail."""
    seg = np.full((b, t), -1, np.int32)
    for r in range(b):
        used = t - int(rng.integers(0, t // 10))
        cuts = np.sort(rng.choice(np.arange(1, used), n_seg - 1, replace=False))
        for s, (lo, hi) in enumerate(zip(np.r_[0, cuts], np.r_[cuts, used])):
            seg[r, lo:hi] = s
    return seg


def _right_padded(rng, b, t, lo=100):
    """[b, t] ids as log_likelihood and DPO's collate build them: 0 on each
    row's lo..t tokens, -1 on its right pads."""
    seg = np.full((b, t), -1, np.int32)
    for r in range(b):
        seg[r, :int(rng.integers(lo, t + 1))] = 0
    return seg


def _left_padded(rng, b, t):
    seg = np.zeros((b, t), np.int32)
    for r in range(b):
        seg[r, :int(rng.integers(0, t * 2 // 3))] = -1
    return seg


def bound_ms(n_bytes: float, flops: float) -> tuple[float, str]:
    """The least time the card could take (ms) and what sets it: the bytes
    moved (each input read once, each output written once) over the memory
    rate, or the operations over the bf16 tensor-core rate."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_flops = flops / BF16_FLOPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_flops else (by_flops, "operations")


def visible_pairs(seg: np.ndarray, kv_seg, causal: bool) -> int:
    """Query-key pairs attention computes, summed over batch rows: equal
    segment ids (kv_seg defaults to seg) and, when causal, key <= query."""
    b, t = seg.shape
    kv = seg if kv_seg is None else kv_seg
    pairs = 0
    for r in range(b):
        for v in np.unique(seg[r]):
            k_in = kv[r] == v
            if causal:
                pairs += int(np.cumsum(k_in)[seg[r] == v].sum())
            else:
                pairs += int(k_in.sum()) * int((seg[r] == v).sum())
    return pairs


def flash_cost(shape, seg, kv_seg, causal: bool, backward: bool) -> tuple[float, float]:
    """(bytes, FLOPs) of the flash forward or backward at [B, H / Hkv, T, D]
    from this case's own segment ids. Forward: q, k, v and the ids read, out
    (bf16) and LSE (f32) written; 4 D FLOPs a visible pair and head (Q K^T,
    P V). Backward: q, k, v, out, dO, LSE and the ids read, dq, dk, dv
    written; 10 D FLOPs a visible pair and head (S, dP, dV, dK, dQ)."""
    b, h, hkv, t, d = shape
    ids = b * t * 4 * (1 if kv_seg is None else 2)
    q_bytes, kv_bytes, rows = b * h * t * d * 2, b * hkv * t * d * 2, b * h * t
    pairs = h * (visible_pairs(seg, kv_seg, causal) if seg is not None
                 else b * (t * (t + 1) // 2 if causal else t * t))
    if backward:
        return 3 * q_bytes + 2 * kv_bytes + rows * 4 + ids + q_bytes + 2 * kv_bytes, 10 * d * pairs
    return 2 * q_bytes + 2 * kv_bytes + rows * 4 + ids, 4 * d * pairs


def _ratios(device_ms: float, bound: float, library_ms):
    """roofline_share = bound / kernel, vs_library = kernel / library."""
    return bound / device_ms, (device_ms / library_ms if library_ms else None)


def kernel_row(name: str, source: str, replaces: str, cuda_kernels: list[str], launches: int,
               max_abs_err: float, at: dict) -> dict:
    """One kernel's entry in the kernels line from its row `at` of phase 3,
    3b, 3c or 3d. `launches` counts wrapper calls on the main path; each call
    runs the CUDA kernels in `cuda_kernels` one after another (an entry
    "a | b" runs one of the two, by shape)."""
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "cuda_kernels": cuda_kernels,
            "kernels_per_launch": len(cuda_kernels), "max_abs_err": max_abs_err,
            "ms": at["ms"], "plain_ms": at["plain_ms"], "graph_ms": at["device_ms"],
            "plain_graph_ms": at["plain_device_ms"], "bound_ms": at["bound_ms"],
            "bound_by": at["bound_by"], "library_ms": at["library_ms"],
            "library_timed": at["library"], "roofline_share": at["roofline_share"],
            "vs_library": at["vs_library"]}


def prefill_entry(at: dict) -> dict:
    """The prefill GEMM's times (`dq_gemm_kernel`, M > 16) from its phase-3c
    row `at`, under the kernels line's names, with the dense path's time."""
    return {"cuda_kernel": "dq_gemm_kernel", "shape": [at["m"], at["k"], at["n"]],
            "ms": at["ms"], "plain_ms": at["plain_ms"], "graph_ms": at["device_ms"],
            "plain_graph_ms": at["plain_device_ms"], "bound_ms": at["bound_ms"],
            "bound_by": at["bound_by"], "library_ms": at["library_ms"],
            "roofline_share": at["roofline_share"], "vs_library": at["vs_library"],
            "tflops": at["tflops"], "dense_graph_ms": at["dense_graph_ms"]}


def _first_error(e: BaseException) -> str:
    """The first line of the error that started a chain: a capture that
    fails inside the graph is reported by `capture_end` as "a previous error
    during capture", with the cause as its context."""
    while e.__context__ is not None:
        e = e.__context__
    return f"{type(e).__name__}: {str(e).splitlines()[0][:120] if str(e) else ''}"


def _library_ms(fn, iters: int):
    """A library call's CUDA-graph time (ms), captured as `_graph_ms`
    captures the kernel, and how it was timed. A call whose capture fails
    gets (None, the error): it is never timed another way, so every library
    time stands beside the kernel's graph time."""
    import torch

    try:
        return _graph_ms(fn, iters), "graph"
    except RuntimeError as e:
        torch.cuda.synchronize()
        return None, f"none: its graph capture failed ({_first_error(e)})"


def _library_text(library_ms, timed: str, vs_library) -> str:
    if library_ms is None:
        return f"library {timed}"
    return f"library {library_ms:.4f} ms ({timed}), vs_library {vs_library:.3f}"


def _sdpa_library(q, k, v, seg, kv_seg, causal: bool):
    """The fused `scaled_dot_product_attention` call that computes the flash
    kernel's function: a bool [B, 1, T, T] mask from the segment ids and
    causality, GQA by `enable_gqa` where the backend takes it, else k / v
    expanded to H heads here (outside any timed window). Returns (call,
    its k, its v, enable_gqa, backend name), or None when no fused backend
    takes the inputs: the unfused math backend is no yardstick."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    t = q.shape[2]
    kv = seg if kv_seg is None else kv_seg
    mask = seg[:, None, :, None] == kv[:, None, None, :]
    if causal:
        mask = mask & torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
    g = q.shape[1] // k.shape[1]
    expanded = (k.repeat_interleave(g, 1), v.repeat_interleave(g, 1))
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION):
        for gqa, (kk, vv) in ((True, (k, v)), (False, expanded)):
            def call(q=q, kk=kk, vv=vv, gqa=gqa, backend=backend):
                with sdpa_kernel(backend):
                    return F.scaled_dot_product_attention(q, kk, vv, attn_mask=mask,
                                                          enable_gqa=gqa)
            try:
                call()
                torch.cuda.synchronize()
            except RuntimeError:
                continue
            return call, kk, vv, gqa, f"{backend.name}{'' if gqa else ' (k/v expanded)'}"
    return None


NO_SDPA = "none: no fused scaled_dot_product_attention backend took the inputs"


def check_kernels(dev) -> list[dict]:
    """Phase 3: the kernel against the plain version at the slice's shapes."""
    import torch

    from slamkit_tpu_torch.ops import flash_attention_fwd, mha_reference

    rng = np.random.default_rng(0)
    # name, (B, H, Hkv, T, D), causal, segment ids
    cases = [
        ("score_ctx1024", (8, 14, 2, 1024, 64), True, _packed_segments(rng, 8, 1024, 8)),
        ("score_requests", (8, 14, 2, 1024, 64), True, _right_padded(rng, 8, 1024)),
        ("prefill_128", (8, 14, 2, 128, 64), True, _left_padded(rng, 8, 128)),
        ("odd_T1000", (8, 14, 2, 1000, 64), True, _packed_segments(rng, 8, 1000, 8)),
        ("d128_ctx1024", (8, 7, 1, 1024, 128), True, _packed_segments(rng, 8, 1024, 8)),
        ("noncausal_T1000", (2, 14, 2, 1000, 64), False, _packed_segments(rng, 2, 1000, 4)),
        ("dead_rows", (2, 14, 2, 256, 64), True, None),
        ("dpo_T152", (16, 14, 2, 152, 64), True, _right_padded(rng, 16, 152, lo=110)),
    ]
    results = []
    for name, (b, h, hkv, t, d), causal, seg in cases:
        g = torch.Generator(device=dev).manual_seed(len(results))
        mk = lambda hh: torch.randn((b, hh, t, d), generator=g, device=dev).to(torch.bfloat16)
        q, k, v = mk(h), mk(hkv), mk(hkv)
        kv_seg = None
        if seg is None:   # query ids 7 never appear among the keys: dead rows
            seg = np.zeros((b, t), np.int32)
            seg[:, 100:140] = 7
            kv_seg = torch.zeros((b, t), dtype=torch.int32, device=dev)
        bound, bound_by = bound_ms(*flash_cost((b, h, hkv, t, d), seg, None if kv_seg is None
                                               else kv_seg.cpu().numpy(), causal, backward=False))
        seg = torch.from_numpy(seg).to(dev)
        run = lambda: flash_attention_fwd(q, k, v, segment_ids=seg, causal=causal,
                                          kv_segment_ids=kv_seg)
        plain = lambda: mha_reference(q.float(), k.float(), v.float(), segment_ids=seg,
                                      causal=causal, kv_segment_ids=kv_seg)
        out, lse = run()
        ref, ref_lse = plain()
        torch.cuda.synchronize()
        dead = ref_lse == 1e30
        alive = ~dead
        err_out = (out.float() - ref)[alive].abs().max().item()
        err_lse = (lse - ref_lse)[alive].abs().max().item()
        n_dead = int(dead.sum().item())
        dead_ok = bool((lse[dead] == 1e30).all().item() and (out[dead] == 0).all().item()
                       and torch.equal(lse == 1e30, dead))
        again = run()
        deterministic = torch.equal(out, again[0]) and torch.equal(lse, again[1])
        del again
        ms = _cuda_ms(run, warmup=3, iters=20)
        plain_ms = _cuda_ms(plain, warmup=1, iters=5)
        device_ms, plain_device_ms = _graph_ms(run, 20), _graph_ms(plain, 3)
        sdpa = _sdpa_library(q, k, v, seg, kv_seg, causal)
        if sdpa is None:
            library_ms, timed = None, NO_SDPA
        else:
            library_ms, timed = _library_ms(sdpa[0], 20)
            timed = f"sdpa {sdpa[4]}, {timed}"
        share, vs_library = _ratios(device_ms, bound, library_ms)
        ok = err_out <= OUT_BOUND and err_lse <= LSE_BOUND and dead_ok and deterministic
        if name == "dead_rows":
            ok = ok and n_dead == b * h * 40
        results.append(dict(name=name, shape=[b, h, hkv, t, d], causal=causal,
                            max_abs_err_out=err_out, max_abs_err_lse=err_lse,
                            dead_rows=n_dead, deterministic=deterministic, ms=ms,
                            plain_ms=plain_ms,
                            device_ms=device_ms, plain_device_ms=plain_device_ms,
                            library_ms=library_ms, library=timed,
                            bound_ms=bound, bound_by=bound_by, roofline_share=share,
                            vs_library=vs_library, ok=ok))
        print(f"kernel {name:16s} [{b},{h}/{hkv},{t},{d}] causal={causal}: "
              f"|dout|={err_out:.3e} (<= {OUT_BOUND}) |dlse|={err_lse:.3e} "
              f"(<= {LSE_BOUND}) dead={n_dead} dead_ok={dead_ok} bitwise-repeatable={deterministic}"
              f"  eager: kernel "
              f"{ms:.4f} ms plain {plain_ms:.4f} ms; graph: kernel {device_ms:.4f} ms "
              f"plain {plain_device_ms:.4f} ms {_library_text(library_ms, timed, vs_library)}; "
              f"bound {bound:.4f} ms by {bound_by}, roofline_share {share:.3f}  "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        _require(ok, f"the flash kernel disagrees with the plain version at {name}")
    return results


def _grad_errors(got, want) -> list[tuple]:
    """(name, max |kernel - plain|, its bound, worst row's error over its
    row bound) for each of dq, dk, dv; the last must be <= 1."""
    rows = []
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        diff = a.float() - w
        row_bound = BWD_ROW_RTOL * w.norm(dim=-1) + BWD_ROW_ATOL
        rows.append((name, diff.abs().max().item(), BWD_REL_BOUND * w.abs().max().item() + 1e-5,
                     (diff.norm(dim=-1) / row_bound).max().item()))
    return rows


def _sdpa_backward_ms(q, k, v, do, seg, kv_seg):
    """The backward of phase 3's library call on the same inputs, timed
    alone: the forward runs once outside the window, then
    `torch.autograd.grad(..., retain_graph=True)` is timed. Returns (ms or
    None, how it was timed or why it was not). Everything runs on a side
    stream: autograd runs a backward op on its forward op's stream, and a
    forward on the legacy default stream would tie that stream to the
    capture, which CUDA refuses."""
    import torch

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream), torch.inference_mode(False), torch.enable_grad():
        qg, kg, vg, dog = (x.clone() for x in (q, k, v, do))
        sdpa = _sdpa_library(qg, kg, vg, seg, kv_seg, True)
        if sdpa is None:
            return None, NO_SDPA
        call, kk, vv, _, backend = sdpa
        kk.requires_grad_()
        vv.requires_grad_()
        qg.requires_grad_()
        out = call(qg, kk, vv)
        grad = lambda: torch.autograd.grad(out, (qg, kk, vv), dog, retain_graph=True)
        grad()                         # a first call outside the capture (plans, workspace)
        torch.cuda.synchronize()
        ms, timed = _library_ms(grad, 20)
    torch.cuda.current_stream().wait_stream(stream)
    return ms, f"sdpa backward {backend}, {timed}"


def check_backward_kernels(dev) -> list[dict]:
    """Phase 3b: the backward kernel against the plain backward at the
    training shapes: the Slam batch (8 packed segments and a -1 tail), a
    ragged T, d = 128 (config/model/slam_dh128.yaml), the SIMS context 2048
    (config/train_inter_scale.yaml), dead rows, and DPO's [2 x 8, 152] batch
    (one segment of 110-152 tokens a row, then a -1 tail)."""
    import torch

    from slamkit_tpu_torch.ops import flash_attention_bwd, flash_attention_fwd, mha_reference_bwd

    rng = np.random.default_rng(2)
    cases = [
        ("slam_ctx1024", (8, 14, 2, 1024, 64), _packed_segments(rng, 8, 1024, 8)),
        ("odd_T1000", (8, 14, 2, 1000, 64), _packed_segments(rng, 8, 1000, 8)),
        ("d128_ctx1024", (8, 7, 1, 1024, 128), _packed_segments(rng, 8, 1024, 8)),
        ("sims_ctx2048", (4, 14, 2, 2048, 64), _packed_segments(rng, 4, 2048, 8)),
        ("dead_rows", (2, 14, 2, 256, 64), None),
        ("dpo_T152", (16, 14, 2, 152, 64), _right_padded(rng, 16, 152, lo=110)),
    ]
    results = []
    for name, (b, h, hkv, t, d), seg in cases:
        g = torch.Generator(device=dev).manual_seed(100 + len(results))
        mk = lambda hh: torch.randn((b, hh, t, d), generator=g, device=dev).to(torch.bfloat16)
        q, k, v, do = mk(h), mk(hkv), mk(hkv), mk(h)
        kv_seg = None
        if seg is None:   # query ids 7 never appear among the keys: dead rows
            seg = np.zeros((b, t), np.int32)
            seg[:, 100:140] = 7
            kv_seg = torch.zeros((b, t), dtype=torch.int32, device=dev)
        bound, bound_by = bound_ms(*flash_cost((b, h, hkv, t, d), seg, None if kv_seg is None
                                               else kv_seg.cpu().numpy(), True, backward=True))
        seg = torch.from_numpy(seg).to(dev)
        out, lse = flash_attention_fwd(q, k, v, segment_ids=seg, kv_segment_ids=kv_seg)
        run = lambda: flash_attention_bwd(q, k, v, out, lse, do, segment_ids=seg,
                                          kv_segment_ids=kv_seg)
        plain = lambda: mha_reference_bwd(q.float(), k.float(), v.float(), seg, kv_seg,
                                          out.float(), lse, do.float())
        got, want = run(), plain()
        torch.cuda.synchronize()
        errs = _grad_errors(got, want)
        dead_ok = True
        if name == "dead_rows":
            dead_ok = bool((got[0][:, :, 100:140] == 0).all().item())
        ms = _cuda_ms(run, warmup=3, iters=20)
        plain_ms = _cuda_ms(plain, warmup=1, iters=3)
        device_ms, plain_device_ms = _graph_ms(run, 20), _graph_ms(plain, 2)
        again = run()
        deterministic = all(torch.equal(x, y) for x, y in zip(got, again))
        library_ms, timed = _sdpa_backward_ms(q, k, v, do, seg, kv_seg)
        share, vs_library = _ratios(device_ms, bound, library_ms)
        ok = all(e <= bd and row <= 1 for _, e, bd, row in errs) and dead_ok and all(
            bool(torch.isfinite(x).all().item()) for x in got) and deterministic
        results.append(dict(name=name, shape=[b, h, hkv, t, d],
                            max_abs_err={n: e for n, e, _, _ in errs},
                            bound={n: bd for n, _, bd, _ in errs},
                            worst_row_over_bound={n: r for n, _, _, r in errs},
                            deterministic=deterministic,
                            ms=ms, plain_ms=plain_ms, device_ms=device_ms,
                            plain_device_ms=plain_device_ms, library_ms=library_ms,
                            library=timed, bound_ms=bound, bound_by=bound_by,
                            roofline_share=share, vs_library=vs_library, ok=ok))
        print(f"backward {name:14s} [{b},{h}/{hkv},{t},{d}]: "
              + " ".join(f"|{n}|={e:.3e} (<= {bd:.3e}) row {r:.3f} (<= 1)"
                         for n, e, bd, r in errs)
              + f" dead_ok={dead_ok} bitwise-repeatable={deterministic}  eager: kernel "
              f"{ms:.4f} ms plain {plain_ms:.4f} ms; graph: kernel {device_ms:.4f} ms plain "
              f"{plain_device_ms:.4f} ms {_library_text(library_ms, timed, vs_library)}; "
              f"bound {bound:.4f} ms by {bound_by}, roofline_share {share:.3f}  "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        del got, want, again
        _require(ok, f"the flash backward kernel disagrees with the plain version at {name}")
    return results


def _int8pack_library(x, q, s, want):
    """`torch._weight_int8pack_mm(x, q^T, s)` (the same function: int8 [N,
    K] weights, a bf16 scale per output column) graph-timed on the inputs of
    a dq_matmul call; (None, the refusal) where this torch refuses it. Its
    distance from the plain version, in bf16 ulps, goes into the note."""
    import torch

    from slamkit_tpu_torch.ops.quant import ulp_bound

    w_nk, scales = q.t().contiguous(), s.reshape(-1).contiguous()
    call = lambda: torch._weight_int8pack_mm(x, w_nk, scales)
    try:
        got = call().float()
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        return None, f"none: {type(e).__name__}: {str(e).splitlines()[0][:160]}"
    ulps = ((got - want.float()).abs() / ulp_bound(got, want)).max().item()
    ms, timed = _library_ms(call, 50)
    return ms, f"torch._weight_int8pack_mm, {timed}, {ulps:.2f} ulp from plain"


def check_dq_kernels(dev) -> list[dict]:
    """Phase 3c: the dq_matmul kernel against its plain version at the Slam
    decoder's four (K, N) pairs, for the decode rows (M = 8, the smoke's
    batch, and 16, tools/bench_decode.py's) and the prefill rows (M = 8 x 75,
    phase 8's prompt of 3 s at 25 Hz, and 8 x 128); beside it
    `torch._weight_int8pack_mm` on the same (x, q, s) and, for the prefill
    rows, the dense path's cost: the graph time of `x @ w` with w the bf16
    weight dequantized outside the timed region (what a prefill without
    weight_quant="int8" pays; not the library call)."""
    import torch

    from slamkit_tpu_torch.ops import (dequantize_weight, dq_matmul, dq_matmul_reference,
                                       quantize_weight)
    from slamkit_tpu_torch.ops.quant import ulp_bound

    results = []
    for m in (8, 16, 600, 1024):
        for k, n in SLAM_KN:
            g = torch.Generator(device=dev).manual_seed(m + k + n)
            x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
            q, s = quantize_weight(torch.randn((k, n), generator=g, device=dev) * 0.02)
            run = lambda: dq_matmul(x, q, s)
            plain = lambda: dq_matmul_reference(x, q, s)
            got, want = run().float(), plain().float()
            torch.cuda.synchronize()
            err = (got - want).abs()
            ulps = (err / ulp_bound(got, want)).max().item()   # reason there
            ms = _cuda_ms(run, warmup=3, iters=50)
            plain_ms = _cuda_ms(plain, warmup=2, iters=20)
            device_ms, plain_device_ms = _graph_ms(run, 50), _graph_ms(plain, 20)
            deterministic = torch.equal(run(), run())
            library_ms, library = _int8pack_library(x, q, s, want)
            bound, bound_by = bound_ms(m * k * 2 + k * n + n * 2 + m * n * 2, 2 * m * k * n)
            share, vs_library = _ratios(device_ms, bound, library_ms)
            dense_ms, dense_text = None, ""
            if m > 16:
                w = dequantize_weight(q, s)
                dense_ms = _graph_ms(lambda: x @ w, 50)
                dense_text = f"; dense path x @ w (bf16) {dense_ms:.4f} ms"
                del w
            ok = ulps <= 1.0 and bool(torch.isfinite(got).all().item()) and deterministic
            results.append(dict(m=m, k=k, n=n, max_abs_err=err.max().item(), max_ulps=ulps,
                                dense_graph_ms=dense_ms,
                                deterministic=deterministic, ms=ms, plain_ms=plain_ms,
                                device_ms=device_ms, plain_device_ms=plain_device_ms,
                                library_ms=library_ms, library=library, bound_ms=bound,
                                bound_by=bound_by, roofline_share=share, vs_library=vs_library,
                                weight_gb_per_s=k * n / device_ms * 1e-6,
                                tflops=2 * m * k * n / device_ms * 1e-9, ok=ok))
            print(f"dq_matmul [{m},{k}]x[{k},{n}]: |d|={err.max().item():.3e}, "
                  f"{ulps:.2f} bf16 ulp (<= 1), bitwise-repeatable={deterministic}  eager: "
                  f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms; graph: kernel {device_ms:.4f} "
                  f"ms plain {plain_device_ms:.4f} ms "
                  f"{_library_text(library_ms, library, vs_library)}; bound {bound:.4f} ms by "
                  f"{bound_by}, roofline_share {share:.3f} "
                  f"({k * n / device_ms * 1e-6:.1f} GB/s of int8 weights, "
                  f"{2 * m * k * n / device_ms * 1e-9:.2f} TFLOP/s){dense_text}  "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            _require(ok, f"the dq_matmul kernel disagrees with the plain version at "
                     f"[{m},{k}]x[{k},{n}]")
    return results


# the probe repeats one product REPS times into one float32 sum; no single
# PyTorch call computes that (a matmul of the repeated operands would be
# another function), so its rows carry no library time
PROBE_LIBRARY = "none: no single PyTorch call repeats a product into one sum"


def check_probe(dev) -> dict:
    """Phase 3d: the probe kernel against its plain version at its four
    shapes, then its main path: `tools/bench_flash.py --matmul-probe`."""
    import torch

    from slamkit_tpu_torch.ops import matmul_probe, matmul_probe_reference
    from slamkit_tpu_torch.ops.matmul_probe import REPS, SHAPES, error_bound
    from slamkit_tpu_torch.tools import bench_flash

    rows = []
    for m, k, n in SHAPES:
        g = torch.Generator(device=dev).manual_seed(m + k + n)
        a = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
        b = torch.randn((k, n), generator=g, device=dev).to(torch.bfloat16)
        run = lambda: matmul_probe(a, b, REPS)
        plain = lambda: matmul_probe_reference(a, b, REPS)
        got, want = run(), plain()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        bound = error_bound(k, REPS) * want.abs().max().item()   # reason there
        ms, plain_ms = _cuda_ms(run, warmup=3, iters=20), _cuda_ms(plain, warmup=1, iters=5)
        device_ms, plain_device_ms = _graph_ms(run, 20), _graph_ms(plain, 3)
        time_bound, bound_by = bound_ms(m * k * 2 + k * n * 2 + m * n * 4, 2 * m * k * n * REPS)
        ok = err <= bound
        rows.append(dict(m=m, k=k, n=n, reps=REPS, max_abs_err=err, bound=bound, ms=ms,
                         plain_ms=plain_ms, device_ms=device_ms,
                         plain_device_ms=plain_device_ms, library_ms=None,
                         library=PROBE_LIBRARY, bound_ms=time_bound, bound_by=bound_by,
                         roofline_share=time_bound / device_ms, vs_library=None,
                         tflops=2 * m * k * n * REPS / device_ms * 1e-9, ok=ok))
        print(f"probe [{m},{k}]x[{k},{n}] x{REPS}: |d|={err:.3e} (<= {bound:.3e})  eager: "
              f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms; graph: kernel {device_ms:.4f} ms "
              f"plain {plain_device_ms:.4f} ms ({rows[-1]['tflops']:.1f} TFLOP/s); bound "
              f"{time_bound:.4f} ms by {bound_by}, roofline_share "
              f"{time_bound / device_ms:.3f}; library none  {'ok' if ok else 'FAIL'}", flush=True)
        _require(ok, f"the probe kernel disagrees with the plain version at {(m, k, n)}")
    dev_ms = {(r["m"], r["k"], r["n"]): r["device_ms"] for r in rows}
    ratios = {"k64_over_k128": dev_ms[SHAPES[0]] / dev_ms[SHAPES[1]],
              "n64_over_n128": dev_ms[SHAPES[2]] / dev_ms[SHAPES[3]]}
    print(f"probe ratios (graph): K=64/K=128 {ratios['k64_over_k128']:.3f}, "
          f"N=64/N=128 {ratios['n64_over_n128']:.3f}", flush=True)
    matmul_probe.launches = 0                 # the main path's count starts here
    bench_flash.main(["--matmul-probe", "--iters", "5"])
    launches = matmul_probe.launches
    _require(launches == len(SHAPES) * (2 + 5), f"bench_flash --matmul-probe launched the "
             f"probe kernel {launches} times, not {len(SHAPES) * 7}")
    return dict(shapes=rows, ratios=ratios, launches=launches)


def run_slice(dev, smi: str, cfg=None) -> dict:
    """Phases 4 and 5 through the user entry points; returns measurements.
    On the card every scoring forward and every prefill must launch the flash
    kernel once per layer; on the CPU (a rehearsal at a small config) the
    plain version runs and no launch may be counted."""
    import torch

    from slamkit_tpu_torch.models import UnitLM, param_count
    from slamkit_tpu_torch.ops import flash_attention_fwd
    from slamkit_tpu_torch.tools.slam_recipe import slam_config

    rng = np.random.default_rng(1)
    cfg = cfg or slam_config()
    n_layers = cfg.decoder_config().num_layers
    expect = n_layers if dev.type == "cuda" else 0
    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    flash_attention_fwd.launches = 0          # the main path's count starts here

    def launches_of(what, fn):
        before = flash_attention_fwd.launches
        result = fn()
        n = flash_attention_fwd.launches - before
        _require(n == expect, f"{what} launched the flash kernel {n} times, not {expect}")
        return result

    with tempfile.TemporaryDirectory(dir=build_dir) as ckpt:
        t0 = time.perf_counter()
        UnitLM(cfg, seed=0, device=dev).save_pretrained(ckpt)
        lm = UnitLM.from_pretrained(ckpt, device=dev)
        print(f"model: {param_count(lm.decoder) / 1e6:.1f}M params, "
              f"{n_layers} layers, saved+loaded in {time.perf_counter() - t0:.1f} s", flush=True)

        # ---- phase 4: scoring --------------------------------------------
        lengths = rng.integers(100, 1001, 8)
        lengths[0] = 1000
        tokens = tokenise_units(_unit_strings(rng, lengths))
        launches_of("the scoring warm-up", lambda: lm.log_likelihood(tokens))
        _sync(dev)
        t0 = time.perf_counter()
        ll = launches_of("a scoring forward", lambda: lm.log_likelihood(tokens))
        _sync(dev)
        score_s = time.perf_counter() - t0
        _require(tuple(ll.shape) == (8,) and bool(torch.isfinite(ll).all()),
                 f"scores are not 8 finite values: {ll}")
        scored = int((tokens != PAD).sum())
        padded = 8 * (-(-tokens.shape[1] // 64) * 64)
        print(f"scoring: 8 requests of {sorted(lengths.tolist())} units, mean ll "
              f"{ll.mean().item():.4f}, {score_s * 1e3:.2f} ms, {scored / score_s:.0f} "
              f"scored tokens/s ({padded / score_s:.0f} padded) on {smi}", flush=True)

        short = tokenise_units(_unit_strings(rng, [120, 64]))
        card = launches_of("a scoring forward", lambda: lm.log_likelihood(short)).float().cpu()
        ref = UnitLM.from_pretrained(ckpt, device="cpu", torch_dtype="float32")
        cpu = ref.log_likelihood(short)
        del ref
        nll_err = (card - cpu).abs().max().item()
        print(f"scoring vs float32 CPU on 2 short rows: device {card.tolist()} cpu "
              f"{cpu.tolist()} |d|={nll_err:.3e} (<= {NLL_BOUND})", flush=True)
        _require(nll_err <= NLL_BOUND, "device scoring disagrees with the float32 CPU run")

    # ---- phase 5: generation ---------------------------------------------
    prompts = tokenise_units(_unit_strings(rng, rng.integers(50, 76, 8)), prompt=True)
    l0, new = prompts.shape[1], 150
    runs = {}
    for name, kwargs in (("sample", dict(do_sample=True, temperature=0.8, top_k=25,
                                         generator=torch.Generator(device=dev).manual_seed(0))),
                         ("greedy", dict(do_sample=False))):
        _sync(dev)
        t0 = time.perf_counter()
        out = launches_of(f"generation ({name})",
                          lambda: lm.generate(prompts, max_new_tokens=new, **kwargs))
        _sync(dev)
        gen_s = time.perf_counter() - t0
        out = out.cpu().numpy()
        _require(out.shape == (8, l0 + new), f"generate returned {out.shape}")
        _require(bool((out >= 0).all() and (out < cfg.vocab_size).all()), "ids out of vocab")
        _require(bool((out[:, :l0] == prompts).all()), "the prompt was not kept")
        for row in out[:, l0:]:
            hits = np.where(row == BOS_EOS)[0]
            _require(not len(hits) or bool((row[hits[0] + 1:] == PAD).all()),
                     f"a row is not padded after eos: {row}")
        ended = sum(int((row == BOS_EOS).any()) for row in out[:, l0:])
        runs[name] = dict(seconds=gen_s, new_tokens_per_s=8 * new / gen_s, ended_with_eos=ended)
        print(f"generation ({name}): prompts {l0} wide, [8, {l0}+{new}] ids, {ended} rows "
              f"hit eos, {gen_s:.3f} s, {8 * new / gen_s:.0f} new tokens/s on {smi}", flush=True)
    return dict(launches=flash_attention_fwd.launches, score_tokens_per_s=scored / score_s,
                score_ms=score_s * 1e3, nll_err=nll_err, generation=runs)


def _bf16_peak(name: str):
    return next((peak for key, peak in BF16_PEAK_FLOPS if key in name), None)


def _stream_stats(batches, n_layers: int, heads: int, head_dim: int) -> dict:
    """Non-pad tokens, all positions and attention FLOPs (training: forward
    QK^T and PV, 4 d per visible pair, and a backward of twice that) of
    packed microbatches, from their segment ids: a segment of length L has
    L (L + 1) / 2 causal pairs."""
    tokens = positions = pairs = 0
    for mb in batches:
        seg = mb["segment_ids"]
        positions += seg.size
        tokens += int((seg >= 0).sum())
        for row in seg:
            _, counts = np.unique(row[row >= 0], return_counts=True)
            pairs += int((counts * (counts + 1) // 2).sum())
    return dict(tokens=tokens, positions=positions,
                attn_flops=12 * n_layers * heads * head_dim * pairs,
                attn_recompute_flops=4 * n_layers * heads * head_dim * pairs)


def run_training(dev, smi: str, cfg=None, work: pathlib.Path = None, n_rows: int = 1400,
                 lengths=(100, 1001), **overrides) -> dict:
    """Phase 6 through `SLAMTrainer.train()`; returns measurements. On the
    card each microbatch must launch the forward kernel 2 x layers times and
    the backward kernel once per layer; on the CPU (a rehearsal at a small
    config) the plain versions run and no launch may be counted."""
    import dataclasses
    import gc

    import torch

    from slamkit_tpu_torch.data import parse_single_dataset
    from slamkit_tpu_torch.models import UnitLM, param_count
    from slamkit_tpu_torch.ops import flash_attention_bwd, flash_attention_fwd
    from slamkit_tpu_torch.tokeniser import UnitTokeniser
    from slamkit_tpu_torch.tools.slam_recipe import (slam_config, slam_training_args,
                                                     write_markov_corpus)
    from slamkit_tpu_torch.trainer import SLAMTrainer, TrainerCallback

    cfg = dataclasses.replace(cfg or slam_config(), remat=True)
    dcfg = cfg.decoder_config()
    context = overrides.pop("context_len", 1024)
    args = slam_training_args(str(work / "run"), **overrides)
    steps, accum = args["max_steps"], args["gradient_accumulation_steps"]
    write_markov_corpus(work / "tokens.jsonl", n_rows, lengths)
    ds = parse_single_dataset({"data": {}, "model": {"context_len": context}},
                              UnitTokeniser(), str(work / "tokens.jsonl"))["train"]
    print(f"training corpus: {len(ds)} rows, {ds.num_tokens} tokens "
          f"(Markov, 4 successors a unit)", flush=True)

    class Clock(TrainerCallback):
        def __init__(self):
            self.marks = []

        def on_train_begin(self, args, state, control, **kw):
            self.marks = [time.perf_counter()]

        def on_step_end(self, args, state, control, **kw):
            self.marks.append(time.perf_counter())

    def trainer(output_dir, seed):
        model = UnitLM(cfg, seed=seed, device=dev)
        clock = Clock()
        tr = SLAMTrainer(model, {**args, "output_dir": str(output_dir)}, ds,
                         callbacks=[clock], packing=True, context_len=context,
                         packing_strategy="bestfit")
        return model, tr, clock

    model, tr, clock = trainer(work / "run", seed=0)
    n_params = param_count(model.decoder)
    micro = list(tr.train_batcher.epoch(0))[:steps * accum]
    _require(len(micro) == steps * accum, f"the corpus fills {len(micro)} microbatches, "
             f"not {steps * accum}")
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
    flash_attention_fwd.launches = flash_attention_bwd.launches = 0  # the main path
    state = tr.train()
    launches = {"flash_fwd": flash_attention_fwd.launches,
                "flash_bwd": flash_attention_bwd.launches}
    peak_mem = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    losses = [r["loss"] for r in state.log_history if "loss" in r]
    print(f"training: {state.global_step} steps of [{accum} x {args['per_device_train_batch_size']}, "
          f"{context}], losses {losses}, launches {launches}", flush=True)
    _require(state.global_step == steps and len(losses) == steps, "the run did not take "
             f"{steps} logged steps")
    _require(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
             f"the training loss is not finite and falling: {losses}")
    n_layers = dcfg.num_layers
    expect = ({"flash_fwd": steps * accum * 2 * n_layers,
               "flash_bwd": steps * accum * n_layers} if dev.type == "cuda"
              else {"flash_fwd": 0, "flash_bwd": 0})
    _require(launches == expect, f"training launched {launches}, expected {expect} "
             f"(forward and remat recompute per layer, backward per layer)")

    # steady steps: 2 .. steps-1 (step 1 warms up; the last overlaps the
    # background save of the step before it)
    timed = range(1, steps - 1)
    secs = [clock.marks[i + 1] - clock.marks[i] for i in timed]
    stats = _stream_stats([mb for i in timed for mb in micro[i * accum:(i + 1) * accum]],
                          n_layers, dcfg.num_heads, dcfg.head_dim)
    total = sum(secs)
    model_flops = 6 * n_params * stats["tokens"] + stats["attn_flops"]
    hw_flops = (8 * n_params * stats["positions"] + stats["attn_flops"]
                + stats["attn_recompute_flops"])
    peak = _bf16_peak(torch.cuda.get_device_name(dev)) if dev.type == "cuda" else None
    result = dict(steps=steps, accum=accum, losses=losses, launches=launches,
                  step_seconds=[clock.marks[i + 1] - clock.marks[i] for i in range(steps)],
                  timed_steps=[i + 1 for i in timed], tokens_per_s=stats["tokens"] / total,
                  positions_per_s=stats["positions"] / total, step_time_s=total / len(secs),
                  params=n_params, peak_bf16_flops=peak,
                  mfu=model_flops / total / peak if peak else None,
                  hw_util_with_remat=hw_flops / total / peak if peak else None,
                  max_memory_allocated=peak_mem)
    print(f"training throughput (steps {result['timed_steps']}): {result['tokens_per_s']:.1f} "
          f"non-pad tokens/s ({result['positions_per_s']:.1f} positions/s), "
          f"{result['step_time_s']:.3f} s a step of {accum} x {args['per_device_train_batch_size']} "
          f"x {context}, peak memory {peak_mem} B, MFU {result['mfu']} and with the remat "
          f"recompute {result['hw_util_with_remat']} of {peak} bf16 FLOP/s, on {smi}",
          flush=True)
    del tr, model
    gc.collect()

    # resume: a fresh run restored from checkpoint-3 takes step 4 again
    ckpt = work / "run" / f"checkpoint-{steps - 1}"
    _require((ckpt / "trainer_state.json").is_file(), f"{ckpt} was not written")
    model, tr, _ = trainer(work / "resumed", seed=1)
    resumed = tr.train(resume_from_checkpoint=str(ckpt))
    again = [r["loss"] for r in resumed.log_history if "loss" in r][-1]
    resume_err = abs(again - losses[-1])
    print(f"resume from {ckpt.name}: step {steps} loss {again} against {losses[-1]} "
          f"|d|={resume_err:.3e} (<= {RESUME_BOUND})", flush=True)
    _require(resumed.global_step == steps and resume_err <= RESUME_BOUND,
             "the resumed run does not repeat the uninterrupted run's last step")
    del tr, model
    gc.collect()

    export = UnitLM.from_pretrained(str(work / "run" / f"checkpoint-{steps}"), device=dev)
    ll = export.log_likelihood(tokenise_units(_unit_strings(np.random.default_rng(5),
                                                            [150, 90])))
    _require(tuple(ll.shape) == (2,) and bool(torch.isfinite(ll).all()),
             f"the exported checkpoint does not score: {ll}")
    print(f"export reloaded with UnitLM.from_pretrained, scores {ll.tolist()}", flush=True)
    del export
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    result.update(resume_loss=again, resume_err=resume_err, export_ll=ll.tolist())
    return result


def check_card_vs_cpu(dev, work: pathlib.Path, cfg=None, batch=2, context=256) -> dict:
    """Phase 7: one packed microbatch, loss and gradients in bf16 on the card
    against float32 on the CPU from the same weights."""
    import torch

    from slamkit_tpu_torch.data import Batcher, parse_single_dataset
    from slamkit_tpu_torch.models import UnitLM, grads_to_flat
    from slamkit_tpu_torch.tokeniser import UnitTokeniser
    from slamkit_tpu_torch.tools.slam_recipe import slam_config

    ds = parse_single_dataset({"data": {}, "model": {"context_len": context}},
                              UnitTokeniser(), str(work / "tokens.jsonl"))["train"]
    mb = next(iter(Batcher(ds, batch, context, PAD, packing=True, seed=1).epoch(0)))
    batch_t = {k: torch.from_numpy(mb[k]) for k in
               ("input_ids", "labels", "segment_ids", "positions")}
    card = UnitLM(cfg or slam_config(), seed=3, device=dev)
    card.save_pretrained(str(work / "card_vs_cpu"))
    cpu = UnitLM.from_pretrained(str(work / "card_vs_cpu"), torch_dtype="float32",
                                 device="cpu")
    loss_card = card.loss_fn({k: v.to(dev) for k, v in batch_t.items()})
    loss_card.backward()
    loss_cpu = cpu.loss_fn(batch_t)
    loss_cpu.backward()
    got, want = grads_to_flat(card.decoder), grads_to_flat(cpu.decoder)
    cos = {}
    for k, w in want.items():
        a, b = got[k].ravel().astype(np.float64), w.ravel().astype(np.float64)
        cos[k] = float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-30))
    worst = min(cos, key=cos.get)
    loss_err = abs(loss_card.item() - loss_cpu.item())
    print(f"card vs CPU on one packed [{batch}, {context}] microbatch: loss {loss_card.item()} "
          f"vs {loss_cpu.item()} |d|={loss_err:.3e} (<= {TRAIN_LOSS_BOUND}); lowest gradient "
          f"cosine {cos[worst]:.6f} ({worst}; floor {GRAD_COSINE_FLOOR}) over {len(cos)} "
          f"tensors", flush=True)
    _require(loss_err <= TRAIN_LOSS_BOUND, "the card's loss disagrees with the CPU's")
    _require(cos[worst] >= GRAD_COSINE_FLOOR, f"the gradient of {worst} disagrees with "
             f"the CPU's (cosine {cos[worst]})")
    return dict(loss_card=loss_card.item(), loss_cpu=loss_cpu.item(), loss_err=loss_err,
                min_grad_cosine=cos[worst], min_grad_cosine_tensor=worst)


def _tone(rng, seconds: float) -> np.ndarray:
    """`seconds` of 16 kHz audio: a gliding tone in noise, drawn from rng."""
    t = np.arange(int(seconds * 16000)) / 16000
    f0 = rng.uniform(100, 300) * (1 + 0.3 * np.sin(2 * np.pi * rng.uniform(0.5, 2) * t))
    return 0.3 * np.sin(2 * np.pi * np.cumsum(f0) / 16000) + 0.05 * rng.standard_normal(t.size)


def write_prompts(folder: pathlib.Path, n: int, seconds: float, seed: int = 0) -> str:
    """n seeded 16 kHz WAVs of `seconds` each (a gliding tone in noise);
    returns their glob."""
    from slamkit_tpu_torch.utils.audio import save_wav

    rng = np.random.default_rng(seed)
    folder.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        save_wav(str(folder / f"prompt{i}.wav"), _tone(rng, seconds))
    return str(folder / "*.wav")


class Spans:
    """Times named methods of the pipeline's parts (the card synchronised on
    both sides) and counts the kernel launches inside each call."""

    def __init__(self, dev):
        self.dev, self.rows = dev, []

    def wrap(self, obj, method: str, label: str):
        from slamkit_tpu_torch.ops import dq_matmul, flash_attention_fwd

        fn = getattr(obj, method)

        def timed(*args, **kwargs):
            _sync(self.dev)
            before = (dq_matmul.launches, flash_attention_fwd.launches)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            _sync(self.dev)
            self.rows.append(dict(span=label, seconds=time.perf_counter() - t0,
                                  dq=dq_matmul.launches - before[0],
                                  flash=flash_attention_fwd.launches - before[1],
                                  args=args, kwargs=kwargs, out=out))
            return out

        setattr(obj, method, timed)

    def take(self, label: str) -> list[dict]:
        rows = [r for r in self.rows if r["span"] == label]
        self.rows = [r for r in self.rows if r["span"] != label]
        return rows


def run_speech(dev, smi: str, work: pathlib.Path, lm_cfg=None, hubert_cfg=None,
               voc_cfg=None, n_prompts: int = 8, seconds: float = 3.0,
               generate_kwargs=None) -> dict:
    """Phase 8: speech continuation through `generative_metric.generate` and
    a SpeechLM of HuBERT + k-means + UnitLM + CodeHiFiGAN, int8 then dense;
    then the card held against float32 CPU runs on the same weights. On the
    card every int8 generate call must run all 7 projections of every layer
    through dq_matmul in the prefill and in each decode step, and the prefill
    through the flash kernel; on the CPU (a rehearsal at small configs) the
    plain versions run and no launch may be counted."""
    import contextlib

    import torch

    from slamkit_tpu_torch.feature_extractor import (HUBERT_CONFIG_PRESETS, HubertConfig,
                                                     HubertFeatureExtractor, assign_clusters)
    from slamkit_tpu_torch.feature_extractor.hubert import random_params
    from slamkit_tpu_torch.metric import generative_metric
    from slamkit_tpu_torch.models import SpeechLM, UnitLM, transformer
    from slamkit_tpu_torch.models.transformer import init_cache
    from slamkit_tpu_torch.ops import dq_matmul, dq_matmul_reference, flash_attention_fwd
    from slamkit_tpu_torch.ops.quant import ulp_bound
    from slamkit_tpu_torch.tokeniser import UnitTokeniser
    from slamkit_tpu_torch.tools.slam_recipe import slam_config
    from slamkit_tpu_torch.utils.tree import to_torch
    from slamkit_tpu_torch.vocoder import HiFiGANVocoder, hifigan

    lm_cfg = lm_cfg or slam_config()
    hubert_cfg = hubert_cfg or HubertConfig(**HUBERT_CONFIG_PRESETS["slprl/mhubert-base-25hz"])
    voc_cfg = voc_cfg or CODEHIFIGAN_CFG
    gen_kw = dict(generate_kwargs or GENERATE_KWARGS)
    n_layers, new = lm_cfg.decoder_config().num_layers, gen_kw["max_new_tokens"]
    on_card = dev.type == "cuda"
    tap = hubert_cfg.num_hidden_layers - 1      # mhubert-base-25hz's units: layer 11 of 12
    prompts = write_prompts(work / "prompts", n_prompts, seconds)

    hubert_params = random_params(hubert_cfg, seed=1)
    fe = HubertFeatureExtractor.from_params(
        hubert_params, hubert_cfg, np.zeros((500, hubert_cfg.hidden_size), np.float32),
        layer=tap, device=dev)
    # The k-means file is not in the repository, so its 500 centroids are
    # drawn from the tapped features of the prompts themselves (seeded; the
    # Forgy start of k-means). Random centroids would not do: every frame is
    # a layer-normed vector sharing a large component with the others, and
    # one random centroid then wins every frame, which leaves one unit a
    # prompt. This first forward also warms HuBERT up before it is timed.
    prompt_wavs = np.stack([generative_metric.load_audio(str(p), 16000) for p in
                            sorted((work / "prompts").glob("*.wav"))])
    frames = fe.features(torch.from_numpy(prompt_wavs).to(dev)).reshape(
        -1, hubert_cfg.hidden_size).cpu().numpy()
    rng = np.random.default_rng(8)
    centroids = frames[rng.choice(len(frames), 500, replace=len(frames) < 500)]
    fe.centroids = torch.from_numpy(centroids).to(dev)
    voc_params = hifigan.convert_torch_generator(hifigan.random_state_dict(voc_cfg, seed=2),
                                                 voc_cfg)
    lm = UnitLM(lm_cfg, seed=0, device=dev)
    voc = HiFiGANVocoder.from_params(voc_params, voc_cfg, device=dev)
    model = SpeechLM(lm, UnitTokeniser(fe, num_units=500), voc)
    spans = Spans(dev)
    spans.wrap(model.tokeniser, "build_prompt", "tokenise")
    spans.wrap(lm, "generate", "generate")
    spans.wrap(voc, "vocode_batch", "vocode")

    runs = {}
    for quant in ("int8", None):
        name = quant or "dense"
        dq_matmul.launches = flash_attention_fwd.launches = 0   # the main path's count
        res = generative_metric.generate(model, prompts, batch_size=8, prompt_length=3,
                                         num_workers=8, weight_quant=quant, **gen_kw)
        launches = {"dq_matmul": dq_matmul.launches, "flash_fwd": flash_attention_fwd.launches}
        tok, gen, vocode = spans.take("tokenise"), spans.take("generate"), spans.take("vocode")
        wavs = res["generate"]
        _require(len(wavs) == n_prompts and all(
            w.size > 0 and np.isfinite(w).all() for w in wavs),
            f"{name}: not {n_prompts} non-empty finite waveforms")
        per_call = {"dq_matmul": (7 * n_layers * new if quant else 0) if on_card else 0,
                    "flash_fwd": n_layers if on_card else 0}
        for row in gen:
            got = {"dq_matmul": row["dq"], "flash_fwd": row["flash"]}
            _require(got == per_call, f"a {name} generate call launched {got}, expected "
                     f"{per_call}")
        rows = sum(r["out"].shape[0] for r in gen)
        gen_s = sum(r["seconds"] for r in gen)
        audio_s = sum(w.size for w in wavs) / 16000
        voc_s = sum(r["seconds"] for r in vocode)
        runs[name] = dict(
            launches=launches, generate_calls=len(gen), tokenise_ms=1e3 * sum(
                r["seconds"] for r in tok), generate_s=gen_s,
            new_tokens_per_s=rows * new / gen_s, vocode_s=voc_s, audio_s=audio_s,
            vocode_x_realtime=audio_s / voc_s,
            prompt_ids=[list(r["out"]["input_ids"].shape) for r in tok])
        print(f"speech ({name}): {n_prompts} prompts of {seconds} s, tokenise "
              f"{runs[name]['tokenise_ms']:.1f} ms, prompt ids {runs[name]['prompt_ids']}, "
              f"generate {gen_s:.3f} s = {rows * new / gen_s:.1f} new tokens/s, vocode "
              f"{voc_s:.3f} s for {audio_s:.2f} s of audio ({audio_s / voc_s:.1f}x real "
              f"time), launches {launches} on {smi}", flush=True)
        last_prompt = tok[-1]["out"]["input_ids"]
        last_units = vocode[-1]["args"][0]

    # ---- the card against float32 CPU runs on the same weights -----------
    cpu = torch.device("cpu")
    wav = prompt_wavs[:2]
    fe_cpu = HubertFeatureExtractor.from_params(hubert_params, hubert_cfg, centroids,
                                                layer=tap, device="cpu")
    feats = fe.features(torch.from_numpy(wav).to(dev)).float()
    feats_cpu = fe_cpu.features(torch.from_numpy(wav))
    hubert_err = ((feats.cpu() - feats_cpu).norm() / feats_cpu.norm()).item()
    ids = assign_clusters(feats, fe.centroids).cpu()
    agree = (ids == assign_clusters(feats_cpu, fe_cpu.centroids)).float().mean().item()
    print(f"HuBERT card vs CPU on 2 prompts: ||d|| / ||cpu|| = {hubert_err:.3e} (<= "
          f"{HUBERT_REL_BOUND}), unit ids agree {agree:.4f} (>= {UNIT_AGREE_FLOOR})",
          flush=True)
    _require(hubert_err <= HUBERT_REL_BOUND and agree >= UNIT_AGREE_FLOOR,
             "HuBERT on the card disagrees with the float32 CPU run")

    @contextlib.contextmanager
    def dq_path(fn):
        kernel, transformer.dq_matmul = transformer.dq_matmul, fn
        try:
            yield
        finally:
            transformer.dq_matmul = kernel

    def pallas_order(x, q, s):
        """The plain product in the Pallas kernel's order: the scale
        multiplies the float32 sum (quant.py:48), not the weights."""
        return ((x.float() @ q.float()) * s.float().reshape(1, -1)).to(torch.bfloat16)

    held = dict(calls=0, max_ulps=0.0, shapes=set())

    def held_to_plain(x, q, s):
        """The kernel, held on every call to its plain version on the same
        (x, q, s) within one bf16 ulp (`ulp_bound`, reason there)."""
        got = kernel(x, q, s)
        want = dq_matmul_reference(x, q, s)
        ulps = ((got.float() - want.float()).abs() / ulp_bound(got, want)).max().item()
        held["calls"] += 1
        held["max_ulps"] = max(held["max_ulps"], ulps)
        held["shapes"].add((x.shape[0], *q.shape))
        _require(ulps <= 1.0 and bool(torch.isfinite(got).all().item()),
                 f"dq_matmul [{x.shape[0]},{q.shape[0]}]x{list(q.shape)} is {ulps:.2f} bf16 "
                 f"ulp from its plain version in the int8 prefill or decode step")
        return got

    kernel = transformer.dq_matmul
    prepared = lm._int8_decode_params()
    ids_t = torch.as_tensor(last_prompt, device=dev)
    b, l0 = ids_t.shape
    mask = (ids_t != 0).to(torch.int32)       # left pads, as generate lays them out
    prefill = dict(positions=(torch.cumsum(mask, dim=1) - 1).clamp(min=0),
                   segment_ids=torch.where(mask > 0, 0, -1).to(torch.int32))
    with torch.inference_mode():
        # the prefill at the prompt's own M = B x L0 and one decode step
        # (M = B), every projection held to the plain version as it runs
        cache = init_cache(prepared.cfg, b, l0 + 1, device=dev)
        with dq_path(held_to_plain):
            logits, cache = prepared(ids_t, **prefill, cache=cache, cache_index=0)
            prepared(logits[:, -1].argmax(-1)[:, None], positions=prefill["positions"][:, -1:] + 1,
                     segment_ids=torch.cat([prefill["segment_ids"], torch.zeros_like(
                         prefill["segment_ids"][:, :1])], dim=1), cache=cache, cache_index=l0)
        _require(held["calls"] == 2 * 7 * n_layers, f"{held['calls']} dq_matmul calls held in "
                 f"one prefill and one decode step, not {2 * 7 * n_layers}")
        print(f"dq_matmul held per call in the int8 prefill (M = {b} x {l0}) and one decode "
              f"step (M = {b}): {held['calls']} calls at {len(held['shapes'])} shapes, at most "
              f"{held['max_ulps']:.2f} bf16 ulp (<= 1)", flush=True)
        with dq_path(dq_matmul_reference):
            plain_logits, _ = prepared(ids_t, **prefill)
        with dq_path(pallas_order):
            order_logits, _ = prepared(ids_t, **prefill)
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()
    logit_err, logit_yardstick = rel(logits, plain_logits), rel(order_logits, plain_logits)
    logit_max_err = (logits - plain_logits).abs().max().item()
    logit_bound = max(INT8_LOGIT_YARDSTICK_FACTOR * logit_yardstick, 1e-3)
    print(f"int8 prefill logits {list(logits.shape)}, dq_matmul kernel vs plain: "
          f"||d|| / ||plain|| = {logit_err:.3e} (<= {logit_bound:.3e} = "
          f"{INT8_LOGIT_YARDSTICK_FACTOR} x {logit_yardstick:.3e}, the two plain orders), "
          f"max |d| {logit_max_err:.3e}", flush=True)
    _require(logit_err <= logit_bound, "the int8 prefill logits disagree with the plain path")

    units = np.asarray(last_units[0])[:50]
    cpu_params = to_torch(voc_params, cpu)
    h_cpu = hifigan._build_conditioning(cpu_params, voc_cfg, units, dur_prediction=True)
    with torch.inference_mode():
        x = voc.params["dict"][torch.as_tensor(units[None], dtype=torch.long, device=dev)]
        dur = hifigan.durations(hifigan.variance_predictor(
            voc.params["dur_predictor"], voc_cfg["dur_predictor_params"], x))[0]
        x_cpu = cpu_params["dict"][torch.as_tensor(units[None], dtype=torch.long)]
        dur_cpu = hifigan.durations(hifigan.variance_predictor(
            cpu_params["dur_predictor"], voc_cfg["dur_predictor_params"], x_cpu))[0]
    dur_agree = float((dur == dur_cpu).mean())
    dur_max = int(np.abs(dur - dur_cpu).max())
    body = hifigan.generator_forward(voc.params, voc_cfg, h_cpu.to(dev)).cpu()
    body_cpu = hifigan.generator_forward(cpu_params, voc_cfg, h_cpu)
    voc_err = (body - body_cpu).abs().max().item()
    print(f"vocoder card vs CPU on {len(units)} units: durations agree {dur_agree:.4f} (>= "
          f"{DURATION_AGREE_FLOOR}), max |d dur| {dur_max} (<= 1); body on the same "
          f"conditioning [{h_cpu.shape[-1]} frames]: |d wav|={voc_err:.3e} (<= "
          f"{VOCODER_ABS_BOUND})", flush=True)
    _require(dur_agree >= DURATION_AGREE_FLOOR and dur_max <= 1 and voc_err <= VOCODER_ABS_BOUND,
             "the vocoder on the card disagrees with the float32 CPU run")
    return dict(runs=runs, hubert_rel_err=hubert_err, unit_agreement=agree,
                dq_held_calls=held["calls"], dq_held_max_ulps=held["max_ulps"],
                int8_logit_err=logit_err, int8_logit_bound=logit_bound,
                int8_logit_yardstick=logit_yardstick, int8_logit_max_err=logit_max_err,
                duration_agreement=dur_agree, vocoder_err=voc_err)


class _LogLines:
    """Collects the messages of one logger while a phase runs."""

    def __init__(self, name: str):
        import logging

        self.lines = []
        self.logger = logging.getLogger(name)
        self.handler = logging.Handler(logging.INFO)
        self.handler.emit = lambda record: self.lines.append(record.getMessage())

    def __enter__(self):
        import logging

        self.level = self.logger.level
        self.logger.setLevel(logging.INFO)
        self.logger.addHandler(self.handler)
        return self.lines

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)
        self.logger.setLevel(self.level)


def write_pairs(folder: pathlib.Path, n_pairs: int, seconds=(1.0, 3.0), seed: int = 9) -> str:
    """An sBLIMP layout of n_pairs seeded 16 kHz WAV pairs, `<i>+<p|n>.wav`
    in one folder (metric.subfolder=false), each a gliding tone in noise of
    a length drawn from `seconds`."""
    from slamkit_tpu_torch.utils.audio import save_wav

    rng = np.random.default_rng(seed)
    folder.mkdir(parents=True, exist_ok=True)
    for i in range(2 * n_pairs):
        save_wav(str(folder / f"{i}+{'pn'[i % 2]}.wav"), _tone(rng, rng.uniform(*seconds)))
    return str(folder)


def run_cli(dev, smi: str, work: pathlib.Path, model_overrides=(), hubert_cfg=None,
            n_rows: int = 400, lengths=(100, 1001), context: int = 1024, batch: int = 8,
            accum: int = 4, n_pairs: int = 32, seconds=(1.0, 3.0)) -> dict:
    """Phase 9: the command line. `python -m slamkit_tpu_torch.cli.train` in
    process on the paper's config (model=slam with twist_init left true,
    packing, remat, bf16 moments; 2 steps of `accum` x `batch` at `context`,
    a save at step 2, step 2 traced), then `cli.eval` with metric=sblimp on
    that checkpoint over n_pairs seeded WAV pairs, through a random HuBERT
    written to disk as an HF directory and centroids drawn from its own
    features. On the card every training microbatch must launch the
    backward kernel once per layer and the forward twice (remat), and every
    scoring call the forward once per layer; on the CPU (a rehearsal at
    narrow widths, `model_overrides`) no launch may be counted."""
    import gc

    import torch

    from slamkit_tpu_torch.cli import eval as cli_eval
    from slamkit_tpu_torch.cli import train as cli_train
    from slamkit_tpu_torch.config import compose
    from slamkit_tpu_torch.feature_extractor import (HUBERT_CONFIG_PRESETS, HubertConfig,
                                                     HubertFeatureExtractor)
    from slamkit_tpu_torch.feature_extractor.hubert import random_params, save_hf_dir
    from slamkit_tpu_torch.metric import modelling_metric as mm
    from slamkit_tpu_torch.models import UnitLM, tlm_factory
    from slamkit_tpu_torch.ops import flash_attention_bwd, flash_attention_fwd
    from slamkit_tpu_torch.tools.slam_recipe import write_markov_corpus
    from slamkit_tpu_torch.utils.audio import load_audio

    on_card = dev.type == "cuda"
    model_overrides = list(model_overrides)
    write_markov_corpus(work / "cli_tokens.jsonl", n_rows, lengths)
    write_markov_corpus(work / "cli_val.jsonl", 16, lengths, seed=1)
    out, steps = work / "cli_run", 2
    data = [f"data.train_path={work / 'cli_tokens.jsonl'}",
            f"data.val_path={work / 'cli_val.jsonl'}"]
    train_args = ["model=slam", f"model.context_len={context}", *model_overrides, *data,
                  "data.packing=true", f"training_args.output_dir={out}",
                  f"training_args.max_steps={steps}",
                  f"training_args.per_device_train_batch_size={batch}",
                  f"training_args.per_device_eval_batch_size={batch}",
                  f"training_args.gradient_accumulation_steps={accum}",
                  "training_args.remat=true", "training_args.optim_state_dtype=bfloat16",
                  "training_args.save_steps=2", "training_args.logging_steps=1",
                  "training_args.profile_steps=1", "training_args.profile_start=1",
                  *([] if on_card else ["training_args.use_cpu=true"])]
    print(f"cli.train {' '.join(train_args)}", flush=True)
    flash_attention_fwd.launches = flash_attention_bwd.launches = 0   # the main path's count
    with _LogLines("slamkit_tpu_torch.models.hf_convert") as twist_log:
        t0 = time.perf_counter()
        state = cli_train.train(train_args)
        _sync(dev)
        train_s = time.perf_counter() - t0
    train_launches = {"flash_fwd": flash_attention_fwd.launches,
                      "flash_bwd": flash_attention_bwd.launches}
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    twist = twist_log[0] if twist_log else "no warning: the base's weights were loaded"
    logs = [r for r in state.log_history if "loss" in r]
    losses = [r["loss"] for r in logs]
    step_s = [r["num_input_tokens_seen"] - (logs[i - 1]["num_input_tokens_seen"] if i else 0)
              for i, r in enumerate(logs)]
    step_s = [n / r["tokens_per_sec"] for n, r in zip(step_s, logs)]
    print(f"cli.train: {state.global_step} steps, losses {losses}, step seconds {step_s} "
          f"(step 1 warms up, step 2 is traced), label tokens/s "
          f"{[r['tokens_per_sec'] for r in logs]}, {train_s:.1f} s in all, launches "
          f"{train_launches}; TWIST: {twist}; on {smi}", flush=True)
    _require(state.global_step == steps and len(losses) == steps
             and all(math.isfinite(x) for x in losses), f"cli.train did not take {steps} "
             f"finite logged steps: {losses}")
    trace = out / "profile" / "trace.json.gz"
    _require(trace.is_file(), f"training_args.profile_steps=1 wrote no trace at {trace}")
    ckpt = out / f"checkpoint-{steps}"
    # the checkpoint reloads through model.pretrained_model, with the remat
    # that cli.train derives from training_args.remat=true
    cfg = compose(str(ROOT / "config"), "train", ["model=slam", f"model.pretrained_model={ckpt}",
                                                  *model_overrides, *data])
    cfg.model.config_args.remat = True
    reloaded = tlm_factory(cfg.model, device=dev)
    remat_on = bool(reloaded.decoder.cfg.remat and reloaded.config.remat)
    twist_init, n_layers = reloaded.config.twist_init, reloaded.decoder.cfg.num_layers
    del reloaded
    gc.collect()
    print(f"{ckpt.name} reloads through model.pretrained_model: remat {remat_on}, "
          f"twist_init {twist_init}, {n_layers} layers; trace {trace.relative_to(work)} "
          f"({trace.stat().st_size} B)", flush=True)
    _require(remat_on, "the checkpoint reloaded through model.pretrained_model without remat")
    want_bwd = steps * accum * n_layers if on_card else 0
    _require(train_launches["flash_bwd"] == want_bwd and (
        train_launches["flash_fwd"] >= 2 * want_bwd if on_card
        else train_launches["flash_fwd"] == 0), f"cli.train launched {train_launches}: "
             f"expected {want_bwd} backward calls and at least twice as many forward ones")

    # ---- cli.eval on the checkpoint ----------------------------------------
    hubert_cfg = hubert_cfg or HubertConfig(**HUBERT_CONFIG_PRESETS["slprl/mhubert-base-25hz"])
    tap = hubert_cfg.num_hidden_layers - 1
    pairs = pathlib.Path(write_pairs(work / "sblimp", n_pairs, seconds))
    hubert_params = random_params(hubert_cfg, seed=3)
    save_hf_dir(str(work / "hubert"), hubert_params, hubert_cfg)
    # centroids drawn from the random HuBERT's own features of the pairs
    # (seeded), as phase 8 draws them: random ones would give one unit a wav
    fe = HubertFeatureExtractor.from_params(hubert_params, hubert_cfg,
                                            np.zeros((500, hubert_cfg.hidden_size), np.float32),
                                            layer=tap, device=dev)
    frames = np.concatenate([fe.features(torch.from_numpy(load_audio(str(p)))[None].to(dev))[0]
                             .cpu().numpy() for p in sorted(pairs.glob("*.wav"))[:8]])
    rng = np.random.default_rng(10)
    np.save(work / "km.npy", frames[rng.choice(len(frames), 500, replace=len(frames) < 500)])
    del fe
    eval_args = [f"model.pretrained_model={ckpt}", "metric=sblimp", f"metric.data_path={pairs}",
                 "metric.subfolder=false",
                 f"tokeniser.feature_extractor.pretrained_model={work / 'hubert'}",
                 f"tokeniser.feature_extractor.kmeans_path={work / 'km.npy'}",
                 f"tokeniser.feature_extractor.layer={tap}", "batch_size=8", "num_workers=8",
                 *([] if on_card else ["device=cpu", "model.config_args.torch_dtype=float32"])]
    print(f"cli.eval {' '.join(eval_args)}", flush=True)
    calls, metric_s = [], []
    score, timed = UnitLM.log_likelihood, mm.modelling_metric

    def recorded(self, tokens, *args, **kwargs):
        ll = score(self, tokens, *args, **kwargs)
        calls.append((np.array(tokens), ll.float().cpu().numpy()))
        return ll

    def timed_metric(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return timed(*args, **kwargs)
        finally:
            metric_s.append(time.perf_counter() - t0)

    UnitLM.log_likelihood, mm.modelling_metric = recorded, timed_metric
    flash_attention_fwd.launches = 0                                   # the main path's count
    try:
        t0 = time.perf_counter()
        res = cli_eval.eval_main(eval_args)
        eval_s = time.perf_counter() - t0
    finally:
        UnitLM.log_likelihood, mm.modelling_metric = score, timed
    eval_launches = flash_attention_fwd.launches
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    n_scored = sum(len(ll) for _, ll in calls)
    print(f"cli.eval: sBLIMP {res['sBLIMP']} over {n_pairs} pairs, {len(calls)} scoring calls, "
          f"{n_pairs / metric_s[0]:.1f} pairs/s in the metric ({metric_s[0]:.3f} s; {eval_s:.1f} "
          f"s with the loads), launches {eval_launches} on {smi}", flush=True)
    _require(n_scored == 2 * n_pairs and 0.0 <= res["sBLIMP"] <= 1.0 and all(
        np.isfinite(ll).all() for _, ll in calls), f"cli.eval scored {n_scored} utterances, "
             f"not {2 * n_pairs} finite ones: {res}")
    _require(eval_launches == (len(calls) * n_layers if on_card else 0),
             f"cli.eval launched the flash forward {eval_launches} times, not "
             f"{len(calls) * n_layers if on_card else 0}")
    # a few pairs' log likelihoods on the card against the same checkpoint
    # in float32 on the CPU, on the same token ids
    tokens, card_ll = calls[0][0][:4], calls[0][1][:4]
    cpu_lm = UnitLM.from_pretrained(str(ckpt), device="cpu", torch_dtype="float32")
    cpu_ll = cpu_lm.log_likelihood(tokens).numpy()
    del cpu_lm
    ll_err = float(np.abs(card_ll - cpu_ll).max())
    print(f"cli.eval card vs float32 CPU on {len(tokens)} utterances: {card_ll.tolist()} vs "
          f"{cpu_ll.tolist()} |d|={ll_err:.3e} (<= {TRAIN_LOSS_BOUND})", flush=True)
    _require(ll_err <= TRAIN_LOSS_BOUND, "cli.eval's scores on the card disagree with the "
             "float32 CPU run")
    return dict(train_launches=train_launches, eval_launches=eval_launches, losses=losses,
                step_seconds=step_s, label_tokens_per_s=[r["tokens_per_sec"] for r in logs],
                train_seconds=train_s, twist=twist, trace_bytes=trace.stat().st_size,
                reload_remat=remat_on, sblimp=res["sBLIMP"], eval_calls=len(calls),
                eval_pairs_per_s=n_pairs / metric_s[0], eval_seconds=eval_s,
                card_vs_cpu_ll_err=ll_err)


def write_triples(folder: pathlib.Path, n: int, seed: int = 11, prompt_s: float = 3.0,
                  completion_s=(1.0, 2.0)) -> str:
    """n seeded preference triples of 16 kHz WAVs (a prompt of `prompt_s`,
    chosen and rejected of a length drawn from `completion_s`, each a gliding
    tone in noise) and the jsonl naming them; returns its path."""
    from slamkit_tpu_torch.utils.audio import save_wav

    rng = np.random.default_rng(seed)
    folder.mkdir(parents=True, exist_ok=True)
    with open(folder / "triples.jsonl", "w") as f:
        for i in range(n):
            row = {}
            for key, seconds in (("prompt", prompt_s), ("chosen", rng.uniform(*completion_s)),
                                 ("rejected", rng.uniform(*completion_s))):
                path = folder / f"{i}_{key}.wav"
                save_wav(str(path), _tone(rng, seconds))
                row[f"{key}_path"] = str(path)
            f.write(json.dumps(row) + "\n")
    return str(folder / "triples.jsonl")


def check_dpo_card_vs_cpu(dev, ckpt: pathlib.Path, rows: list, beta: float) -> dict:
    """Phase 10's card-vs-CPU check: one [2 x B, T] DPO batch; the policy is
    the checkpoint moved by seeded noise (5% of each tensor's RMS, so that the
    rewards are not 0), the reference the checkpoint itself. Loss, rewards
    and every policy gradient in bf16 on the card against float32 on the CPU,
    on the same weights."""
    import torch

    from slamkit_tpu_torch.models import UnitLM, grads_to_flat
    from slamkit_tpu_torch.trainer.slam_dpo_trainer import (collate, dpo_objective, row_len,
                                                            sequence_logps)

    batch = collate(rows, [max(row_len(r) for r in rows)], PAD)
    n_completion = max(len(r["chosen_input_ids"]) for r in rows)
    gen = torch.Generator().manual_seed(12)
    policy_cpu = UnitLM.from_pretrained(str(ckpt), device="cpu", torch_dtype="float32")
    with torch.no_grad():
        for p in policy_cpu.decoder.parameters():
            p.add_(0.05 * p.pow(2).mean().sqrt() * torch.randn(p.shape, generator=gen))
    moved = {k: v.detach().clone() for k, v in policy_cpu.decoder.state_dict().items()}
    out = {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        if d.type == "cpu":
            policy = policy_cpu
            ref = UnitLM.from_pretrained(str(ckpt), device=d, torch_dtype="float32")
        else:
            policy = UnitLM.from_pretrained(str(ckpt), device=d)
            policy.decoder.load_state_dict(moved)
            ref = UnitLM.from_pretrained(str(ckpt), device=d)
        b = {k: torch.from_numpy(v).to(d) for k, v in batch.items()}
        lp = sequence_logps(policy.decoder, b)
        with torch.no_grad():
            ref_lp = sequence_logps(ref.decoder, b)
        loss, metrics = dpo_objective(lp, ref_lp, beta)
        loss.backward()
        out[name] = dict(loss=loss.item(), metrics={k: v.item() for k, v in metrics.items()},
                         lp=lp.detach().cpu().numpy(), ref_lp=ref_lp.cpu().numpy(),
                         grads=grads_to_flat(policy.decoder))
        del policy, ref
    card, cpu = out["card"], out["cpu"]
    lp_err = float(max(np.abs(card["lp"] - cpu["lp"]).max(),
                       np.abs(card["ref_lp"] - cpu["ref_lp"]).max()))
    lp_bound = DPO_TOKEN_BOUND * n_completion
    reward_bound = beta * 2 * lp_bound
    bounds = {"rewards/chosen": reward_bound, "rewards/rejected": reward_bound,
              "rewards/margins": 2 * reward_bound}
    reward_err = {k: abs(card["metrics"][k] - cpu["metrics"][k]) for k in card["metrics"]}
    half = len(rows)
    margins = lambda o: beta * ((o["lp"][:half] - o["lp"][half:])
                                - (o["ref_lp"][:half] - o["ref_lp"][half:]))
    z_card, z_cpu = margins(card), margins(cpu)
    clear = np.abs(z_cpu) > 2 * reward_bound        # rows whose sign cannot flip
    signs_ok = bool((np.sign(z_card[clear]) == np.sign(z_cpu[clear])).all())
    cos = {}
    for k, w in cpu["grads"].items():
        a, b = card["grads"][k].ravel().astype(np.float64), w.ravel().astype(np.float64)
        cos[k] = float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-30))
    worst = min(cos, key=cos.get)
    loss_err = abs(card["loss"] - cpu["loss"])
    shape = list(batch["input_ids"].shape)
    print(f"DPO card vs CPU on one {shape} batch (policy: the checkpoint + 5% noise): loss "
          f"{card['loss']} vs {cpu['loss']} |d|={loss_err:.3e} (<= {TRAIN_LOSS_BOUND}); row "
          f"log-probs |d|={lp_err:.3e} (<= {lp_bound:.3e}); "
          + ", ".join(f"{k} {card['metrics'][k]:.6f} vs {cpu['metrics'][k]:.6f}"
                      + (f" |d|={reward_err[k]:.3e} (<= {bounds[k]:.3e})" if k in bounds else "")
                      for k in card["metrics"])
          + f"; margins card {z_card.tolist()} cpu {z_cpu.tolist()}, signs agree where |z| > "
          f"{2 * reward_bound:.3f}: {signs_ok}; lowest gradient cosine {cos[worst]:.6f} "
          f"({worst}; floor {GRAD_COSINE_FLOOR}) over {len(cos)} tensors", flush=True)
    _require(loss_err <= TRAIN_LOSS_BOUND and lp_err <= lp_bound and signs_ok
             and all(reward_err[k] <= bd for k, bd in bounds.items()),
             "the card's DPO loss or rewards disagree with the CPU's")
    _require(cos[worst] >= GRAD_COSINE_FLOOR, f"the DPO gradient of {worst} disagrees with "
             f"the CPU's (cosine {cos[worst]})")
    return dict(shape=shape, loss_card=card["loss"], loss_cpu=cpu["loss"], loss_err=loss_err,
                logp_err=lp_err, logp_bound=lp_bound, reward_err=reward_err,
                reward_bounds=bounds, margins_card=z_card.tolist(), margins_cpu=z_cpu.tolist(),
                min_grad_cosine=cos[worst], min_grad_cosine_tensor=worst)


def run_dpo(dev, smi: str, work: pathlib.Path, hubert_cfg=None, n_triples: int = 16,
            triple_seconds=(3.0, (1.0, 2.0)), n_train: int = 64, n_val: int = 16,
            batch: int = 8, prompt_len: int = 100, completion_len: int = 50,
            steps: int = 4) -> dict:
    """Phase 10, in phase 9's work directory (its HuBERT directory, centroids,
    WAV pairs and checkpoint-2): `cli.extract_features` over the pairs and
    `cli.prepare_tokens` on its output, each line held to a direct
    `audio_represent` of the same batch of files;
    `cli.preference_alignment_feature_extractor` over seeded WAV triples;
    then `cli.preference_alignment_train` from checkpoint-2 on a seeded Markov
    preference set (`steps` steps of 2 x `batch` rows, a save a step before
    the end), a run resumed from that save, and one batch on the card against
    float32 on the CPU. On the card every DPO step must launch the forward
    kernel once per layer for the reference and 1 + remat times for the
    policy, and the backward kernel once per layer; every eval batch the
    forward twice per layer; on the CPU (a rehearsal at narrow widths) no
    launch may be counted."""
    import gc

    import torch

    from slamkit_tpu_torch.cli import extract_features as cli_extract
    from slamkit_tpu_torch.cli import preference_alignment_feature_extractor as cli_pref_fe
    from slamkit_tpu_torch.cli import preference_alignment_train as cli_dpo
    from slamkit_tpu_torch.cli import prepare_tokens as cli_prepare
    from slamkit_tpu_torch.config import compose
    from slamkit_tpu_torch.feature_extractor import HUBERT_CONFIG_PRESETS, HubertConfig
    from slamkit_tpu_torch.models import UnitLM
    from slamkit_tpu_torch.ops import flash_attention_bwd, flash_attention_fwd
    from slamkit_tpu_torch.tokeniser import UnitTokeniser, tokeniser_factory
    from slamkit_tpu_torch.tools.slam_recipe import write_preference_rows
    from slamkit_tpu_torch.trainer import SLAMDPOTrainer, tokenize_row
    from slamkit_tpu_torch.utils.audio import load_audio

    on_card = dev.type == "cuda"
    hubert_cfg = hubert_cfg or HubertConfig(**HUBERT_CONFIG_PRESETS["slprl/mhubert-base-25hz"])
    fe_args = [f"tokeniser.feature_extractor.pretrained_model={work / 'hubert'}",
               f"tokeniser.feature_extractor.kmeans_path={work / 'km.npy'}",
               f"tokeniser.feature_extractor.layer={hubert_cfg.num_hidden_layers - 1}",
               *([] if on_card else ["device=cpu"])]

    # ---- stage 1 and 2 ------------------------------------------------------
    wav_dir = work / "sblimp"
    # phase 6 wrote a tokens.jsonl here, and prepare_tokens appends
    features, tokens = work / "stage1_features.jsonl", work / "stage2_tokens.jsonl"
    t0 = time.perf_counter()
    n_feat = cli_extract.extract_features([f"data_path={wav_dir}", "ext=wav",
                                           f"out_path={features}", "batch_size=8",
                                           "num_workers=8", *fe_args])
    _sync(dev)
    stage1_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    n_tok = cli_prepare.prepare_tokens([f"data_path={features}", f"out_path={tokens}",
                                        *([] if on_card else ["+device=cpu"])])
    stage2_s = time.perf_counter() - t0
    wavs = sorted(str(p) for p in wav_dir.glob("**/*.wav"))
    feat_rows = [json.loads(line) for line in features.read_text().splitlines()]
    tok_rows = [json.loads(line) for line in tokens.read_text().splitlines()]
    names = [r["file_name"] for r in feat_rows]
    audio = {n: load_audio(n) for n in names}
    _require(n_feat == n_tok == len(tok_rows) and sorted(names) == wavs and all(
        len(audio[a]) >= len(audio[b]) for a, b in zip(names, names[1:])),
        f"stage 1 wrote {len(feat_rows)} and stage 2 {len(tok_rows)} lines for {len(wavs)} "
        f"WAV files (one line a file, longest first)")
    # the direct call on the same batches: the CLI's order, 8 files zero-padded
    # to their longest (HuBERT masks no padding, so a file's units depend on
    # its batch)
    tok = tokeniser_factory(compose(str(ROOT / "config"), "extract_features",
                                    [f"data_path={wav_dir}", "out_path=-", *fe_args]).tokeniser,
                            device=dev)
    direct = []
    for start in range(0, len(names), 8):
        group = [audio[n] for n in names[start:start + 8]]
        lens = np.array([len(w) for w in group])
        padded = np.zeros((len(group), int(lens.max())), np.float32)
        for i, w in enumerate(group):
            padded[i, :len(w)] = w
        direct += tok.audio_represent(padded, lens)
    stage_ok = all(f["units"] == d["units"] and f["duration"] == d["duration"]
                   and t["file_name"] == f["file_name"]
                   and t["audio_repr"] == tok.stringify_representation([d])[0]
                   for f, t, d in zip(feat_rows, tok_rows, direct))
    n_units = sum(len(r["units"]) for r in feat_rows)
    print(f"stage 1 (cli.extract_features ext=wav): {n_feat} files, {n_units} units, "
          f"{stage1_s:.3f} s; stage 2 (cli.prepare_tokens): {n_tok} lines, {stage2_s:.3f} s; "
          f"every line equals a direct audio_represent of its batch: {stage_ok}; on {smi}",
          flush=True)
    _require(stage_ok, "stage 1 or 2 disagrees with a direct audio_represent")
    del tok

    # ---- preference stage 1 -------------------------------------------------
    triples = write_triples(work / "triples", n_triples, prompt_s=triple_seconds[0],
                            completion_s=triple_seconds[1])
    t0 = time.perf_counter()
    n_pref = cli_pref_fe.extract_features([f"data_path={triples}",
                                           f"out_path={work / 'pref_features.jsonl'}",
                                           "batch_size=8", *fe_args])
    _sync(dev)
    pref_s = time.perf_counter() - t0
    pref_rows = [json.loads(line) for line in
                 (work / "pref_features.jsonl").read_text().splitlines()]
    pref_ok = n_pref == len(pref_rows) == n_triples and all(
        len(r[k]["units"]) == len(r[k]["duration"]) > 0
        for r in pref_rows for k in ("prompt", "chosen", "rejected"))
    print(f"preference stage 1 (cli.preference_alignment_feature_extractor): "
          f"{len(pref_rows)} triples, units of the first prompts "
          f"{[len(r['prompt']['units']) for r in pref_rows[:4]]}, {pref_s:.3f} s; rows well "
          f"formed: {pref_ok}", flush=True)
    _require(pref_ok, f"the preference extractor wrote {len(pref_rows)} rows, not "
             f"{n_triples} with prompt, chosen and rejected units")

    # ---- DPO through the command line ---------------------------------------
    ckpt = work / "cli_run" / "checkpoint-2"
    write_preference_rows(work / "pref_train.jsonl", n_train, prompt_len, completion_len)
    write_preference_rows(work / "pref_val.jsonl", n_val, prompt_len, completion_len, seed=1)
    common = [f"model.pretrained_model={ckpt}", f"data.train_path={work / 'pref_train.jsonl'}",
              f"data.val_path={work / 'pref_val.jsonl'}", f"training_args.max_steps={steps}",
              f"training_args.save_steps={steps - 1}",
              f"training_args.per_device_train_batch_size={batch}",
              "training_args.logging_steps=1",
              *([] if on_card else ["training_args.use_cpu=true",
                                    "model.config_args.torch_dtype=float32"])]
    seen = {}
    train_step = SLAMDPOTrainer._train_step

    def timed_step(self, rows):
        seen["trainer"] = self
        before = (flash_attention_fwd.launches, flash_attention_bwd.launches)
        metrics = train_step(self, rows)
        _sync(dev)
        seen["marks"].append(time.perf_counter())
        seen["launches"].append((flash_attention_fwd.launches - before[0],
                                 flash_attention_bwd.launches - before[1]))
        seen["tokens"].append(int((self._collate(rows)["segment_ids"] >= 0).sum()))
        return metrics

    def dpo_run(args):
        print(f"cli.preference_alignment_train {' '.join(args)}", flush=True)
        seen.update(marks=[], launches=[], tokens=[])
        SLAMDPOTrainer._train_step = timed_step
        flash_attention_fwd.launches = flash_attention_bwd.launches = 0  # the main path's count
        try:
            t0 = time.perf_counter()
            state = cli_dpo.train(args)
            _sync(dev)
        finally:
            SLAMDPOTrainer._train_step = train_step
        launches = {"flash_fwd": flash_attention_fwd.launches,
                    "flash_bwd": flash_attention_bwd.launches}
        tr = seen.pop("trainer")
        dcfg = tr.model.decoder.cfg
        return state, time.perf_counter() - t0, launches, int(tr.max_len), (dcfg.remat,
                                                                             dcfg.num_layers)

    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    out = work / "dpo_run"
    state, dpo_s, launches, max_len, (remat, n_layers) = dpo_run(
        common + [f"training_args.output_dir={out}"])
    peak_mem = torch.cuda.max_memory_allocated(dev) if on_card else None
    logs = [r for r in state.log_history if "loss" in r]
    losses = [r["loss"] for r in logs]
    accs = [r["rewards/accuracies"] for r in logs]
    evals = [r for r in state.log_history if "eval_loss" in r]
    n_eval_batches = -(-n_val // batch)
    per_step = (n_layers * (2 + int(remat)), n_layers) if on_card else (0, 0)
    want = {"flash_fwd": steps * per_step[0] + n_eval_batches * 2 * per_step[1],
            "flash_bwd": steps * per_step[1]}
    step_s = [b - a for a, b in zip(seen["marks"], seen["marks"][1:])]
    tokens_per_s = [n / s for n, s in zip(seen["tokens"][1:], step_s)]
    shape = [2 * batch, max_len]
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    print(f"cli.preference_alignment_train: {state.global_step} steps of {shape} from "
          f"{ckpt.name}, remat {remat} ({per_step[0]} flash_fwd and {per_step[1]} flash_bwd "
          f"a step, {2 * per_step[1]} flash_fwd an eval batch), losses {losses}, "
          f"rewards/accuracies {accs}, eval {evals[-1] if evals else None}; seconds a step "
          f"for steps 2-{steps} {step_s} ({tokens_per_s} chosen+rejected non-pad tokens/s), "
          f"{dpo_s:.1f} s the whole call; launches {launches} (a step {seen['launches']}; "
          f"expected {want}); max_memory_allocated {peak_mem} B; on {smi}", flush=True)
    _require(state.global_step == steps and len(losses) == steps and all(
        math.isfinite(x) for x in losses), f"DPO did not take {steps} finite logged steps")
    _require(abs(losses[0] - math.log(2)) <= 1e-4, f"DPO step 1's loss {losses[0]} is not "
             f"ln 2 within 1e-4 (the policy is the reference)")
    _require(launches == want and all(x == per_step for x in seen["launches"]),
             f"DPO launched {launches} ({seen['launches']} a step), expected {want}")
    _require(len(evals) == 1 and math.isfinite(evals[0]["eval_loss"]),
             "the DPO run's final evaluation is missing")
    launches_per_step = seen["launches"]

    # resume from the save a step before the end: step `steps` again
    resumed, _, resumed_launches, _, _ = dpo_run(
        common + [f"training_args.output_dir={work / 'dpo_resumed'}",
                  f"cont_training={out / f'checkpoint-{steps - 1}'}"])
    again = [r["loss"] for r in resumed.log_history if "loss" in r][-1]
    resume_err = abs(again - losses[-1])
    want_resumed = {"flash_fwd": per_step[0] + n_eval_batches * 2 * per_step[1],
                    "flash_bwd": per_step[1]}
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    print(f"DPO resume from checkpoint-{steps - 1}: step {steps} loss {again} against "
          f"{losses[-1]} |d|={resume_err:.3e} (<= {RESUME_BOUND}); launches "
          f"{resumed_launches} (expected {want_resumed})", flush=True)
    _require(resumed.global_step == steps and resume_err <= RESUME_BOUND,
             "the resumed DPO run does not repeat the uninterrupted run's last step")
    _require(resumed_launches == want_resumed, f"the resumed DPO run launched "
             f"{resumed_launches}, expected {want_resumed}")

    export = UnitLM.from_pretrained(str(out / f"checkpoint-{steps}"), device=dev)
    ll = export.log_likelihood(tokenise_units(_unit_strings(np.random.default_rng(6),
                                                            [150, 90])))
    _require(tuple(ll.shape) == (2,) and bool(torch.isfinite(ll).all()),
             f"the DPO export does not score: {ll}")
    print(f"DPO export checkpoint-{steps} reloads with UnitLM.from_pretrained, scores "
          f"{ll.tolist()}", flush=True)
    del export
    gc.collect()

    # one [2 x 2, T] batch of the training set, card against CPU
    with open(work / "pref_train.jsonl") as f:
        rows = [tokenize_row(json.loads(next(f)), UnitTokeniser(), None, None, False)
                for _ in range(2)]
    check = check_dpo_card_vs_cpu(dev, ckpt, rows, beta=0.1)
    if on_card:
        torch.cuda.empty_cache()
    return dict(stage1_files=n_feat, stage1_units=n_units, stage1_seconds=stage1_s,
                stage2_lines=n_tok, stage2_seconds=stage2_s, pref_rows=len(pref_rows),
                pref_seconds=pref_s, dpo_shape=shape, remat=remat, losses=losses,
                rewards_accuracies=accs, eval=evals[-1], step_seconds=step_s,
                tokens_per_s=tokens_per_s, dpo_seconds=dpo_s, launches=launches,
                launches_per_step=launches_per_step, expected_launches=want,
                resumed_launches=resumed_launches, max_memory_allocated=peak_mem,
                resume_loss=again, resume_err=resume_err, export_ll=ll.tolist(),
                card_vs_cpu=check)


def main() -> int:
    if not (ROOT / "slamkit_tpu_torch" / "ops" / "csrc" / "flash_fwd.cu").is_file():
        print("chip_smoke: run from a checkout of the repository (slamkit_tpu_torch/ "
              "is missing beside this script)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch

    from slamkit_tpu_torch.tools.slam_recipe import nvidia_smi

    # ---- phase 1: device ---------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a "
              "CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    print(smi, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, python "
          f"{sys.version.split()[0]}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off for float32 matmuls and cuDNN", flush=True)

    # ---- phase 2: build, one nvcc per source, all at once -------------------
    from slamkit_tpu_torch.ops import _build
    from slamkit_tpu_torch.ops.flash_attention import KERNEL, KERNEL_BWD
    from slamkit_tpu_torch.ops.matmul_probe import KERNEL as PROBE_KERNEL
    from slamkit_tpu_torch.ops.quant import KERNEL as DQ_KERNEL

    t0 = time.perf_counter()
    names = (KERNEL, KERNEL_BWD, DQ_KERNEL, PROBE_KERNEL)
    with ThreadPoolExecutor(len(names)) as pool:
        libs = list(pool.map(_build.build, names))
    print(f"built {', '.join(str(lib.relative_to(ROOT)) for lib in libs)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for lib in libs:
        print((lib.parent / "build.log").read_text().strip(), flush=True)

    with torch.inference_mode():
        kernel_rows = check_kernels(dev)
        backward_rows = check_backward_kernels(dev)
        dq_rows = check_dq_kernels(dev)
        probe_result = check_probe(dev)
    torch.cuda.empty_cache()
    slice_result = run_slice(dev, smi)
    _require(slice_result["launches"] > 0, "the main path never launched the flash kernel")
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as work:
        train_result = run_training(dev, smi, work=pathlib.Path(work))
        torch.cuda.empty_cache()
        cpu_result = check_card_vs_cpu(dev, pathlib.Path(work))
        torch.cuda.empty_cache()
        speech_result = run_speech(dev, smi, pathlib.Path(work))
        torch.cuda.empty_cache()
        cli_result = run_cli(dev, smi, pathlib.Path(work))
        torch.cuda.empty_cache()
        dpo_result = run_dpo(dev, smi, pathlib.Path(work))
    speech_runs = speech_result["runs"]

    score = next(r for r in kernel_rows if r["name"] == "score_ctx1024")
    bwd = next(r for r in backward_rows if r["name"] == "slam_ctx1024")
    # the kernels line times dq_matmul at a decode step's largest projection
    # (up / gate: [8, 896] x [896, 4864]) and the probe at its K = 128 shape
    dq = next(r for r in dq_rows if (r["m"], r["k"], r["n"]) == (8, 896, 4864))
    # ... and the prefill GEMM (M > 16), a kernel of its own, at M = 1024 up / gate
    dq_prefill = next(r for r in dq_rows if (r["m"], r["k"], r["n"]) == (1024, 896, 4864))
    probe = next(r for r in probe_result["shapes"] if r["k"] == 128)
    print(json.dumps({"shapes": kernel_rows, "backward_shapes": backward_rows,
                      "dq_shapes": dq_rows, "probe": probe_result,
                      "slice": slice_result, "training": train_result,
                      "card_vs_cpu": cpu_result, "speech": speech_result,
                      "cli": cli_result, "dpo": dpo_result}), flush=True)
    print(nvidia_smi(), flush=True)

    print(json.dumps({"kernels": [
        kernel_row("flash_fwd", "slamkit_tpu_torch/ops/csrc/flash_fwd.cu",
                   "slamkit_tpu/ops/flash_attention.py:124", ["flash_fwd_kernel"],
                   slice_result["launches"] + train_result["launches"]["flash_fwd"]
                   + sum(r["launches"]["flash_fwd"] for r in speech_runs.values())
                   + cli_result["train_launches"]["flash_fwd"] + cli_result["eval_launches"]
                   + dpo_result["launches"]["flash_fwd"],
                   max(r["max_abs_err_out"] for r in kernel_rows), score),
        kernel_row("flash_bwd", "slamkit_tpu_torch/ops/csrc/flash_bwd.cu",
                   "slamkit_tpu/ops/flash_attention.py:247",
                   ["flash_bwd_prep_kernel", "flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel"],
                   train_result["launches"]["flash_bwd"]
                   + cli_result["train_launches"]["flash_bwd"]
                   + dpo_result["launches"]["flash_bwd"],
                   max(max(r["max_abs_err"].values()) for r in backward_rows), bwd),
        dict(kernel_row("dq_matmul", "slamkit_tpu_torch/ops/csrc/dq_matmul.cu",
                        "slamkit_tpu/ops/quant.py:43", ["dq_gemv_kernel | dq_gemm_kernel"],
                        speech_runs["int8"]["launches"]["dq_matmul"],
                        max(r["max_abs_err"] for r in dq_rows), dq),
             prefill=prefill_entry(dq_prefill)),
        kernel_row("matmul_probe", "slamkit_tpu_torch/ops/csrc/matmul_probe.cu",
                   "scripts/bench_flash.py:98", ["matmul_probe_kernel"],
                   probe_result["launches"],
                   max(r["max_abs_err"] for r in probe_result["shapes"]), probe)]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
