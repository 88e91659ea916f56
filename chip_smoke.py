#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training, speech-continuation, DPO,
interleaved speech-text (SIMS) and generation-metric (GenPPL, LLM judge)
slices and its command line once on an NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card (an H100 for
the sm_90a kernels). Phases, in order; any failure exits non-zero:

  1. device  — require CUDA; print the card, its power limit and versions;
               switch TF32 off for float32 matmuls and cuDNN.
  2. build   — compile the five CUDA kernel libraries from
               `slamkit_tpu_torch/ops/csrc`, one nvcc per source, all
               started together.
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
  3e. float32 forward — the float32 flash forward (flash_fwd_f32.cu)
               against its plain version on the same float32 inputs at the
               text LM's shapes (`llama1b_f32`: [8, 32/8, 512, 64] with
               log_likelihood's right pads; d = 128; packed rows) and at
               phase 12's own (`genppl_score`: [8, 32/8, 3584, 64], rows of
               1700-3584 tokens and a -1 tail; `judge_prefill`: [8, 32/8,
               7680, 64], left-padded; the plain version there batch rows
               at a time), each call repeated bitwise, timed as phase 3
               times the bf16
               forward; bound by bytes over 3.35 TB/s or FLOPs over the
               H100's float32 CUDA-core 67 TFLOP/s; library call SDPA in
               float32 on the same masked inputs.
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
  11. SIMS   — in phase 9's work directory (its HuBERT directory and
               centroids, phase 10's features.jsonl, phase 8's CodeHiFiGAN
               widths): a base directory with a Qwen2.5-0.5B config.json and
               a WordLevel tokenizer.json of Qwen2.5's 151665 entries (plain
               JSON, no tokenizers package), so the interleaved vocabulary is
               152167 ids; seeded alignment JSONs for the features, then
               `cli.prepare_tokens tokeniser=interleaved_hubert_25
               meta_path=... +tokeniser.params.interleave_seed=0`, every line
               held to a direct `stringify_representation(mode="train")`;
               seeded Markov text-only, interleaved and speech-only corpora
               (stage 2's rows join the interleaved one); `cli.train
               --config-name train_inter_scale` at context 2048, 2 steps of
               4 x 2 with remat and bf16 moments and a save at step 2; then
               `cli.eval metric=cm_ms_tsc` (TEXT prompt, SPEECH
               continuations) over 16 seeded triples, 4 triples' scores held
               against float32 on the CPU; `cli.eval metric=cm_generate`
               TEXT->SPEECH through vocoder=vocoder_hubert_25 (4 prompts, 40
               new tokens, WAVs written) and SPEECH->TEXT on 4 of phase 9's
               WAVs (.txt written), every new token inside its modality.
  12. GenPPL and the LLM judge — in phase 9's work directory:
               `tools/genppl_recipe.py` writes a whisper-large-v3-turbo-shaped
               checkpoint (d_model 1280, 32 + 4 layers, 128 mel bins, vocab
               51866, the real special-token ids and suppress lists) and a
               Llama-3.2-1B-shaped text LM (16 layers, hidden 2048, 32/8
               heads, vocab 128256, tied), random F16 weights; then
               `cli.eval metric=asr_perplexity` over 8 of phase 9's WAVs
               (batch 8) from phase 9's checkpoint with vocoder_hubert_25 at
               phase 8's widths and asr_perplexity.yaml's generate_kwargs
               (seeded), and `cli.eval metric=llm_as_judge` over the same
               WAVs with seeded alignments and the Llama directory as the
               judge; each stage timed (generate, vocode, transcribe, score,
               judge, loads) with `max_memory_allocated`; each metric's
               last float32 flash launch (the last layer of the scoring
               batch, of the judge prefill) held against the plain version
               on that launch's q, k, v and both against float64; the
               text LM's logits and token log-probabilities over a whole
               transcript of the scoring batch, and one Whisper window (its
               encoder output and the
               decoder teacher-forced on the CPU's greedy tokens), held
               against float32 CPU runs.

Phases 3 and 3b also hold the kernels at DPO's shape (`dpo_T152`: [16, 14/2,
152, 64], one segment of 110-152 tokens a row and a -1 tail) and at SIMS's
(`sims_T2048`: [4, 14/2, 2048, 64], rows packed from segments of mixed
length, stage 2's short interleaved rows among text and speech rows of
300-700 tokens, and a -1 tail).

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
evaluation batch the forward twice per layer (phase 10); SIMS training
launches them as phase 6 does, its scoring the forward once per layer a
call and its generation once per layer a prefill (phase 11); GenPPL's
generation launches the bf16 forward once per layer a prefill, and its
text-LM scoring and the judge's prefill the float32 forward once per
text-LM layer a batch (phase 12); the probe's entry
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
# the float32 forward against the same plain version on float32 inputs: both
# compute in float32 (CUDA-core FMAs and expf; float32 einsums with TF32
# off) and differ by summation order alone, ~1e-6 relative on |out| < 4 and
# LSE < 12; a bf16 or TF32 rounding anywhere would sit near 1e-3
F32_OUT_BOUND, F32_LSE_BOUND = 1e-4, 1e-4
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
# phase 11: cm_ms_tsc's mean NLL, bf16 card vs float32 CPU on the same
# checkpoint. A random model over the 152167-id interleaved vocabulary sits
# near ln 152167 = 11.9 nats a token, twice phase 9's ~6.2, so the bound is
# twice NLL_BOUND
SIMS_LL_BOUND = 4e-2
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
# phase 12's own float32 flash launches, on the model's activations, are held
# against the plain version and both against float64: float32 error grows
# with the keys a row sums where their terms agree (a judge prefill's left
# pads share one v, over up to ~2000 keys), in the plain version and the
# kernel alike, so no fixed bound fits every T. The kernel's error against
# float64 may be twice the plain float32 version's, and no less than phase
# 3e's bounds; a TF32 or bf16 product (2^-11 or 2^-8 a rounding, against
# float32's 2^-24) would sit far above both
F32_YARDSTICK_FACTOR = 2.0
# phase 12, card against float32 CPU on the same weights and inputs, float32
# on both sides (TF32 off), so they differ by summation order alone (~1e-6
# relative), where a TF32 or bf16 path would sit at 1e-3 or more. The text
# LM over a whole transcript: its logits at every scored position,
# ||card - cpu|| / ||cpu|| <= 1e-4, and each scored token's log-probability
# (logits of a few units: ~1e-5 nats of float32 noise) within 1e-4 nats.
# Whisper's encoder output over its 32 layers and the teacher-forced decoder
# logits: ||card - cpu|| / ||cpu|| <= 1e-4, as HuBERT's
GENPPL_LOGIT_REL_BOUND, GENPPL_LOGP_BOUND, WHISPER_REL_BOUND = 1e-4, 1e-4, 1e-4
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
# ... and its float32 rate outside the tensor cores (NVIDIA data sheet, SXM),
# the bound of the float32 flash forward, whose products are CUDA-core FMAs
FP32_FLOPS_PER_S = 67e12
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


def _mixed_segments(rng, b, t):
    """[b, t] ids as best-fit packing of phase 11's corpora lays them out:
    each row holds segments of mixed length (stage 2's interleaved rows of
    40-160 tokens among text and speech rows of 300-700), the last cut
    short, and ends in a -1 tail of 1-39 tokens."""
    seg = np.full((b, t), -1, np.int32)
    for r in range(b):
        col, s = 0, 0
        while True:
            n = int(rng.integers(40, 160) if rng.random() < 0.4 else rng.integers(300, 700))
            if col + n > t:   # a last, shorter segment, then a tail of 1-39
                n = t - col - int(rng.integers(1, 40))
                if n > 0:
                    seg[r, col:col + n] = s
                break
            seg[r, col:col + n] = s
            col, s = col + n, s + 1
    return seg


def _right_padded(rng, b, t, lo=100):
    """[b, t] ids as log_likelihood and DPO's collate build them: 0 on each
    row's lo..t tokens, -1 on its right pads."""
    seg = np.full((b, t), -1, np.int32)
    for r in range(b):
        seg[r, :int(rng.integers(lo, t + 1))] = 0
    return seg


def _left_padded(rng, b, t, most=None):
    """[b, t] ids as generate's prefill builds them: -1 on each row's left
    pads (fewer than `most`, by default 2 t / 3), 0 on its prompt."""
    seg = np.zeros((b, t), np.int32)
    for r in range(b):
        seg[r, :int(rng.integers(0, t * 2 // 3 if most is None else most))] = -1
    return seg


def bound_ms(n_bytes: float, flops: float, flops_per_s: float = BF16_FLOPS_PER_S
             ) -> tuple[float, str]:
    """The least time the card could take (ms) and what sets it: the bytes
    moved (each input read once, each output written once) over the memory
    rate, or the operations over the rate of their type (the bf16 tensor-core
    rate unless `flops_per_s` names another: FP32_FLOPS_PER_S for float32)."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_flops = flops / flops_per_s * 1e3
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


def flash_cost(shape, seg, kv_seg, causal: bool, backward: bool, elt_bytes: int = 2
               ) -> tuple[float, float]:
    """(bytes, FLOPs) of the flash forward or backward at [B, H / Hkv, T, D]
    from this case's own segment ids, with q, k, v and out of `elt_bytes`
    bytes an element (bf16: 2, float32: 4). Forward: q, k, v and the ids
    read, out and LSE (f32) written; 4 D FLOPs a visible pair and head
    (Q K^T, P V). Backward: q, k, v, out, dO, LSE and the ids read, dq, dk,
    dv written; 10 D FLOPs a visible pair and head (S, dP, dV, dK, dQ)."""
    b, h, hkv, t, d = shape
    ids = b * t * 4 * (1 if kv_seg is None else 2)
    q_bytes, kv_bytes, rows = (b * h * t * d * elt_bytes, b * hkv * t * d * elt_bytes,
                               b * h * t)
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

# the plain version's [rows, H, T, T] float32 scores are kept under this many
# bytes a call (it runs batch rows at a time above it: T ~ 5000 at 32 heads
# is 3.2 GB a row)
PLAIN_SCORE_BYTES = 4 << 30


def _plain_fwd(q, k, v, seg, kv_seg, causal: bool, sm_scale=None):
    """`mha_reference` on float32 copies of q, k, v, in chunks of batch rows
    whose scores fit PLAIN_SCORE_BYTES. Returns (out, lse, chunks)."""
    import torch

    from slamkit_tpu_torch.ops import mha_reference

    b, h, t, _ = q.shape
    step = max(1, PLAIN_SCORE_BYTES // (h * t * t * 4))
    rows = lambda x, i: None if x is None else x[i:i + step]
    parts = [mha_reference(q[i:i + step].float(), k[i:i + step].float(),
                           v[i:i + step].float(), segment_ids=rows(seg, i), causal=causal,
                           sm_scale=sm_scale, kv_segment_ids=rows(kv_seg, i))
             for i in range(0, b, step)]
    if len(parts) == 1:
        return (*parts[0], 1)
    return torch.cat([o for o, _ in parts]), torch.cat([l for _, l in parts]), len(parts)


def _held_errors(out, lse, ref, ref_lse) -> tuple:
    """A flash forward's (out, lse) against its plain version's: max |d| of
    out and of LSE over the rows that see a key, the dead rows' count, and
    whether the kernel's dead rows are exactly the plain version's, with
    out 0 and LSE 1e30."""
    import torch

    dead = ref_lse == 1e30
    alive = ~dead
    err_out = (out.float() - ref)[alive].abs().max().item()
    err_lse = (lse - ref_lse)[alive].abs().max().item()
    dead_ok = bool((lse[dead] == 1e30).all().item() and (out[dead] == 0).all().item()
                   and torch.equal(lse == 1e30, dead))
    return err_out, err_lse, int(dead.sum().item()), dead_ok


def check_kernels(dev, f32: bool = False) -> list[dict]:
    """Phase 3: the bf16 forward kernel (flash_fwd.cu) against its plain
    version at the slices' shapes. Phase 3e (`f32`): the float32 forward
    (flash_fwd_f32.cu) against the same plain version on float32 inputs at
    the text LM's shapes (Llama-3.2-1B: 32 q heads over 8 kv heads of 64),
    its bound taking the operations at the float32 CUDA-core rate. Among
    them, phase 12's own shapes: a scoring batch (8 transcripts of ~1700-3530
    tokens, padded right to a multiple of 64 with a -1 tail, as
    log_likelihood pads them) and a judge prefill (8 instructions of
    ~5700-7680 tokens, left-padded as judge_text pads them)."""
    import torch

    from slamkit_tpu_torch.ops import flash_attention_fwd

    rng = np.random.default_rng(12 if f32 else 0)
    # name, (B, H, Hkv, T, D), causal, segment ids (None: the dead-rows case)
    cases = [
        ("llama1b_f32", (8, 32, 8, 512, 64), True, _right_padded(rng, 8, 512, lo=40)),
        ("f32_d128", (4, 16, 4, 512, 128), True, _right_padded(rng, 4, 512, lo=40)),
        ("f32_packed", (4, 32, 8, 1024, 64), True, _packed_segments(rng, 4, 1024, 4)),
        ("genppl_score", (8, 32, 8, 3584, 64), True, _right_padded(rng, 8, 3584, lo=1700)),
        ("judge_prefill", (8, 32, 8, 7680, 64), True, _left_padded(rng, 8, 7680, most=2000)),
    ] if f32 else [
        ("score_ctx1024", (8, 14, 2, 1024, 64), True, _packed_segments(rng, 8, 1024, 8)),
        ("score_requests", (8, 14, 2, 1024, 64), True, _right_padded(rng, 8, 1024)),
        ("prefill_128", (8, 14, 2, 128, 64), True, _left_padded(rng, 8, 128)),
        ("odd_T1000", (8, 14, 2, 1000, 64), True, _packed_segments(rng, 8, 1000, 8)),
        ("d128_ctx1024", (8, 7, 1, 1024, 128), True, _packed_segments(rng, 8, 1024, 8)),
        ("noncausal_T1000", (2, 14, 2, 1000, 64), False, _packed_segments(rng, 2, 1000, 4)),
        ("dead_rows", (2, 14, 2, 256, 64), True, None),
        ("dpo_T152", (16, 14, 2, 152, 64), True, _right_padded(rng, 16, 152, lo=110)),
        ("sims_T2048", (4, 14, 2, 2048, 64), True, _mixed_segments(rng, 4, 2048)),
    ]
    dtype, counter = (torch.float32, "f32_launches") if f32 else (torch.bfloat16, "launches")
    out_bound, lse_bound = (F32_OUT_BOUND, F32_LSE_BOUND) if f32 else (OUT_BOUND, LSE_BOUND)
    results = []
    for name, (b, h, hkv, t, d), causal, seg in cases:
        g = torch.Generator(device=dev).manual_seed((100 if f32 else 0) + len(results))
        mk = lambda hh: torch.randn((b, hh, t, d), generator=g, device=dev).to(dtype)
        q, k, v = mk(h), mk(hkv), mk(hkv)
        kv_seg = None
        if seg is None:   # query ids 7 never appear among the keys: dead rows
            seg = np.zeros((b, t), np.int32)
            seg[:, 100:140] = 7
            kv_seg = torch.zeros((b, t), dtype=torch.int32, device=dev)
        cost = flash_cost((b, h, hkv, t, d), seg, None if kv_seg is None
                          else kv_seg.cpu().numpy(), causal, backward=False,
                          elt_bytes=4 if f32 else 2)
        bound, bound_by = bound_ms(*cost, flops_per_s=FP32_FLOPS_PER_S if f32
                                   else BF16_FLOPS_PER_S)
        seg = torch.from_numpy(seg).to(dev)
        run = lambda: flash_attention_fwd(q, k, v, segment_ids=seg, causal=causal,
                                          kv_segment_ids=kv_seg)
        plain = lambda: _plain_fwd(q, k, v, seg, kv_seg, causal)
        before = getattr(flash_attention_fwd, counter)
        out, lse = run()
        _require(getattr(flash_attention_fwd, counter) == before + 1 and out.dtype == dtype,
                 f"a {dtype} call did not launch its kernel or returned {out.dtype}")
        ref, ref_lse, chunks = plain()
        torch.cuda.synchronize()
        err_out, err_lse, n_dead, dead_ok = _held_errors(out, lse, ref, ref_lse)
        del ref, ref_lse
        again = run()
        deterministic = torch.equal(out, again[0]) and torch.equal(lse, again[1])
        del again, out, lse
        ms = _cuda_ms(run, warmup=3, iters=20)
        plain_ms = _cuda_ms(plain, warmup=1, iters=5)
        # a plain version run in chunks is not captured: the graph would keep
        # every chunk's scores at once, and at ~250 ms a call its eager time
        # is its device time
        device_ms = _graph_ms(run, 20)
        plain_device_ms = _graph_ms(plain, 3) if chunks == 1 else None
        sdpa = _sdpa_library(q, k, v, seg, kv_seg, causal)
        if sdpa is None:
            library_ms, timed = None, NO_SDPA
        else:
            library_ms, timed = _library_ms(sdpa[0], 20)
            timed = f"sdpa {sdpa[4]}, {timed}"
        share, vs_library = _ratios(device_ms, bound, library_ms)
        ok = err_out <= out_bound and err_lse <= lse_bound and dead_ok and deterministic
        if name == "dead_rows":
            ok = ok and n_dead == b * h * 40
        tflops = cost[1] / device_ms / 1e9
        results.append(dict(name=name, shape=[b, h, hkv, t, d], causal=causal,
                            dtype=str(dtype)[6:], max_abs_err_out=err_out,
                            max_abs_err_lse=err_lse, dead_rows=n_dead,
                            deterministic=deterministic, ms=ms, plain_ms=plain_ms,
                            device_ms=device_ms, plain_device_ms=plain_device_ms,
                            library_ms=library_ms, library=timed,
                            bound_ms=bound, bound_by=bound_by, roofline_share=share,
                            vs_library=vs_library, tflops=tflops, ok=ok))
        print(f"kernel{' f32' if f32 else ''} {name:16s} [{b},{h}/{hkv},{t},{d}] "
              f"causal={causal}: |dout|={err_out:.3e} (<= {out_bound}) |dlse|={err_lse:.3e} "
              f"(<= {lse_bound}) dead={n_dead} dead_ok={dead_ok} bitwise-repeatable="
              f"{deterministic}  eager: kernel {ms:.4f} ms plain {plain_ms:.4f} ms; graph: "
              f"kernel {device_ms:.4f} ms ({tflops:.1f} TFLOP/s) plain "
              f"{f'{plain_device_ms:.4f} ms' if chunks == 1 else f'not captured ({chunks} chunks)'} "
              f"{_library_text(library_ms, timed, vs_library)}; bound {bound:.4f} ms by "
              f"{bound_by}, roofline_share {share:.3f}  {'ok' if ok else 'FAIL'}", flush=True)
        _require(ok, f"the {dtype} flash kernel disagrees with the plain version at {name}")
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
    (one segment of 110-152 tokens a row, then a -1 tail), and SIMS's rows
    packed from segments of mixed length."""
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
        ("sims_T2048", (4, 14, 2, 2048, 64), _mixed_segments(rng, 4, 2048)),
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


def run_sims(dev, smi: str, work: pathlib.Path, tiny: bool = False, n_entries=None,
             hubert_cfg=None, voc_cfg=None, n_rows: int = 48, lengths=(300, 700),
             context: int = 2048, batch: int = 4, accum: int = 2, steps: int = 2,
             n_triples: int = 16, triple_seconds=(1.0, 2.0), n_prompts: int = 4,
             max_new_tokens: int = 40) -> dict:
    """Phase 11, in phase 9's work directory (its HuBERT directory, centroids
    and WAV pairs, phase 10's features.jsonl): the SIMS recipe through the
    port's command line. Stage 2 with the interleaving tokeniser and seeded
    alignments, held line by line to a direct call; `cli.train --config-name
    train_inter_scale` over a text-only, an interleaved and a speech-only
    corpus (`steps` steps of `batch` x `accum` at `context`, a save at the
    last); `cli.eval metric=cm_ms_tsc` on the checkpoint, a few scores held
    against float32 on the CPU; `cli.eval metric=cm_generate` TEXT->SPEECH
    with the vocoder and SPEECH->TEXT. On the card every training microbatch
    must launch the forward kernel twice per layer (remat) and the backward
    once, every scoring call and every generation prefill the forward once
    per layer; on the CPU (a rehearsal at narrow widths, `tiny`) no launch
    may be counted."""
    import gc

    import torch

    from slamkit_tpu_torch.cli import eval as cli_eval
    from slamkit_tpu_torch.cli import prepare_tokens as cli_prepare
    from slamkit_tpu_torch.cli import train as cli_train
    from slamkit_tpu_torch.config import compose
    from slamkit_tpu_torch.feature_extractor import HUBERT_CONFIG_PRESETS, HubertConfig
    from slamkit_tpu_torch.models import UnitLM
    from slamkit_tpu_torch.ops import flash_attention_bwd, flash_attention_fwd
    from slamkit_tpu_torch.tokeniser import tokeniser_factory
    from slamkit_tpu_torch.tools import sims_recipe
    from slamkit_tpu_torch.trainer import SLAMTrainer
    from slamkit_tpu_torch.vocoder.checkpoint_manager import CHECKPOINT_MANAGER

    on_card = dev.type == "cuda"
    root = work / "sims"
    base = sims_recipe.write_base_dir(root, tiny=tiny,
                                      n_entries=n_entries or sims_recipe.QWEN25_VOCAB)
    hubert_cfg = hubert_cfg or HubertConfig(**HUBERT_CONFIG_PRESETS["slprl/mhubert-base-25hz"])
    tok_args = ["tokeniser=interleaved_hubert_25", f"tokeniser.params.text_tokeniser_path={base}"]
    seed_arg = "+tokeniser.params.interleave_seed=0"

    # ---- stage 2 with alignments --------------------------------------------
    tok = tokeniser_factory(compose(str(ROOT / "config"), "prepare_tokens",
                                    [*tok_args, seed_arg, "data_path=-", "out_path=-"]).tokeniser,
                            device=dev)
    vocab = len(tok.text_tokeniser)
    features = work / "stage1_features.jsonl"
    align = sims_recipe.write_alignments(root / "align", features,
                                         tok.speech_fe.get_unit_duration())
    stage2 = root / "inter_stage2.jsonl"
    t0 = time.perf_counter()
    n_lines = cli_prepare.prepare_tokens([f"data_path={features}", f"out_path={stage2}",
                                          *tok_args, f"meta_path={align}", seed_arg,
                                          *([] if on_card else ["+device=cpu"])])
    stage2_s = time.perf_counter() - t0
    feat_rows = [json.loads(line) for line in features.read_text().splitlines()]
    tok_rows = [json.loads(line) for line in stage2.read_text().splitlines()]
    direct = []
    for row in feat_rows:
        stem = pathlib.Path(row["file_name"]).stem
        meta = json.loads((pathlib.Path(align) / f"{stem}.json").read_text())
        direct.append(tok.stringify_representation([{**row, **meta}], mode="train")[0])
    stage_ok = n_lines == len(feat_rows) == len(tok_rows) and all(
        t["file_name"] == f["file_name"] and t["audio_repr"] == d
        for f, t, d in zip(feat_rows, tok_rows, direct))
    mixed = sum("<speech>" in d and "<text>" in d for d in direct)
    print(f"SIMS stage 2 (cli.prepare_tokens tokeniser=interleaved_hubert_25 meta_path): "
          f"{n_lines} lines in {stage2_s:.3f} s, {mixed} of them mixing speech and text; "
          f"every line equals a direct stringify_representation(mode='train'): {stage_ok}; "
          f"vocabulary {vocab} ids", flush=True)
    _require(stage_ok and mixed > 0, "SIMS stage 2 disagrees with a direct "
             "stringify_representation, or interleaves nothing")

    # ---- cli.train --config-name train_inter_scale --------------------------
    text, _, speech = sims_recipe.write_corpora(root, n_rows, lengths)
    out = root / "run"
    train_args = ["--config-name", "train_inter_scale",
                  f"model.config_args.base_model_name={base}",
                  "model.config_args.twist_init=false",
                  f"data.train_path=[{text},{root / 'inter*.jsonl'},{speech}]",
                  "data.val_path=null", f"model.context_len={context}", "logger=print",
                  f"training_args.output_dir={out}", f"training_args.max_steps={steps}",
                  f"training_args.per_device_train_batch_size={batch}",
                  f"training_args.gradient_accumulation_steps={accum}",
                  f"training_args.save_steps={steps}", "training_args.logging_steps=1",
                  "training_args.remat=true", "training_args.optim_state_dtype=bfloat16",
                  *([] if on_card else ["training_args.use_cpu=true",
                                        "model.config_args.torch_dtype=float32"])]
    print(f"cli.train {' '.join(train_args)}", flush=True)
    seen = dict(marks=[], launches=[], tokens=[])
    train_step = SLAMTrainer._train_step

    def timed_step(self, group):
        seen["trainer"] = self
        before = (flash_attention_fwd.launches, flash_attention_bwd.launches)
        result = train_step(self, group)
        _sync(dev)
        seen["marks"].append(time.perf_counter())
        seen["launches"].append((flash_attention_fwd.launches - before[0],
                                 flash_attention_bwd.launches - before[1]))
        seen["tokens"].append(int(sum((b["segment_ids"] >= 0).sum() for b in group)))
        return result

    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    SLAMTrainer._train_step = timed_step
    flash_attention_fwd.launches = flash_attention_bwd.launches = 0    # the main path's count
    try:
        t0 = time.perf_counter()
        seen["start"] = t0
        state = cli_train.train(train_args)
        _sync(dev)
        train_s = time.perf_counter() - t0
    finally:
        SLAMTrainer._train_step = train_step
    train_launches = {"flash_fwd": flash_attention_fwd.launches,
                      "flash_bwd": flash_attention_bwd.launches}
    peak_mem = torch.cuda.max_memory_allocated(dev) if on_card else None
    trainer = seen.pop("trainer")
    dcfg = trainer.model.decoder.cfg
    n_layers, n_params = dcfg.num_layers, sum(p.numel() for p in trainer.model.parameters())
    n_rows_mixed = len(trainer.train_batcher.ds)
    del trainer
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    losses = [r["loss"] for r in state.log_history if "loss" in r]
    first_s = seen["marks"][0] - seen["start"]
    step_s = [b - a for a, b in zip(seen["marks"], seen["marks"][1:])]
    tokens_per_s = [n / x for n, x in zip(seen["tokens"][1:], step_s)]
    per_step = (2 * n_layers * accum, n_layers * accum) if on_card else (0, 0)
    want = {"flash_fwd": steps * per_step[0], "flash_bwd": steps * per_step[1]}
    print(f"cli.train --config-name train_inter_scale: {state.global_step} steps of {batch} x "
          f"{accum} at {context} over {n_rows_mixed} mixed rows, vocab {dcfg.vocab_size}, "
          f"{n_params} parameters, remat {dcfg.remat}; losses {losses}; {first_s:.3f} s from "
          f"the call's start to the end of step 1 (set-up included), seconds a step for steps "
          f"2-{steps} {step_s}, non-pad tokens a step {seen['tokens']}, non-pad tokens/s for "
          f"steps 2-{steps} {tokens_per_s}; {train_s:.1f} s the whole call; launches "
          f"{train_launches} "
          f"(a step {seen['launches']}; predicted {want}: {2 * n_layers} flash_fwd and "
          f"{n_layers} flash_bwd a microbatch); max_memory_allocated {peak_mem} B; on {smi}",
          flush=True)
    _require(state.global_step == steps and len(losses) == steps
             and all(math.isfinite(x) for x in losses), f"SIMS training did not take {steps} "
             f"finite logged steps: {losses}")
    _require(dcfg.vocab_size == vocab, f"vocab_size -1 resolved to {dcfg.vocab_size}, not the "
             f"interleaved vocabulary's {vocab}")
    _require(train_launches == want and all(x == per_step for x in seen["launches"]),
             f"SIMS training launched {train_launches} ({seen['launches']} a step), "
             f"predicted {want}")
    ckpt = out / f"checkpoint-{steps}"

    # ---- cli.eval metric=cm_ms_tsc ----------------------------------------------
    fe_args = [f"tokeniser.feature_extractor.pretrained_model={work / 'hubert'}",
               f"tokeniser.feature_extractor.kmeans_path={work / 'km.npy'}",
               f"tokeniser.feature_extractor.layer={hubert_cfg.num_hidden_layers - 1}"]
    common = [f"model.pretrained_model={ckpt}", *tok_args, *fe_args, "batch_size=8",
              "num_workers=8",
              *([] if on_card else ["device=cpu", "model.config_args.torch_dtype=float32"])]
    triples = sims_recipe.write_cm_triples(root / "cm", n_triples, seconds=triple_seconds)
    calls = []
    score = UnitLM.log_likelihood

    def recorded(self, tokens, mean_nll=True, ignore_tokens=None):
        ll = score(self, tokens, mean_nll, ignore_tokens)
        calls.append((np.array(tokens), ll.float().cpu().numpy(), ignore_tokens))
        return ll

    UnitLM.log_likelihood = recorded
    flash_attention_fwd.launches = 0                                    # the main path's count
    try:
        t0 = time.perf_counter()
        res = cli_eval.eval_main(common + ["metric=cm_ms_tsc", f"metric.data_path={triples}",
                                           "metric.subfolder=false",
                                           "metric.prompt_modality=TEXT",
                                           "metric.cont_modality=SPEECH"])
        cm_s = time.perf_counter() - t0
    finally:
        UnitLM.log_likelihood = score
    cm_launches, storycloze = flash_attention_fwd.launches, res["StoryCloze"]
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    n_scored = sum(len(ll) for _, ll, _ in calls)
    widths = [c[0].shape[1] for c in calls]
    print(f"cli.eval metric=cm_ms_tsc: StoryCloze {res['StoryCloze']} over {n_triples} triples "
          f"(TEXT prompt, SPEECH continuations), {len(calls)} scoring calls of widths {widths}, "
          f"{cm_s:.1f} s with the loads, launches {cm_launches} on {smi}", flush=True)
    _require(n_scored == 2 * n_triples and 0.0 <= res["StoryCloze"] <= 1.0 and all(
        np.isfinite(ll).all() for _, ll, _ in calls), f"cm_ms_tsc scored {n_scored} sides, not "
             f"{2 * n_triples} finite ones: {res}")
    _require(cm_launches == (len(calls) * n_layers if on_card else 0),
             f"cm_ms_tsc launched the flash forward {cm_launches} times, not "
             f"{len(calls) * n_layers if on_card else 0}")
    tokens, card_ll, ignore = calls[0][0][:4], calls[0][1][:4], calls[0][2]
    cpu_lm = UnitLM.from_pretrained(str(ckpt), device="cpu", torch_dtype="float32")
    cpu_ll = cpu_lm.log_likelihood(tokens, ignore_tokens=ignore).numpy()
    del cpu_lm
    gc.collect()
    ll_err = float(np.abs(card_ll - cpu_ll).max())
    print(f"cm_ms_tsc card vs float32 CPU on {len(tokens)} triples' correct sides: "
          f"{card_ll.tolist()} vs {cpu_ll.tolist()} |d|={ll_err:.3e} (<= {SIMS_LL_BOUND})",
          flush=True)
    _require(ll_err <= SIMS_LL_BOUND, "cm_ms_tsc's scores on the card disagree with the "
             "float32 CPU run")

    # ---- cli.eval metric=cm_generate, TEXT->SPEECH and SPEECH->TEXT --------------
    textless_root = CHECKPOINT_MANAGER.disk_root
    CHECKPOINT_MANAGER.set_root(sims_recipe.write_textless_vocoder(root / "textless",
                                                                   voc_cfg or CODEHIFIGAN_CFG))
    prompts = sims_recipe.write_text_prompts(root / "prompts", n_prompts)
    gen = {}
    generate = UnitLM.generate

    def recorded_generate(self, input_ids, *args, **kwargs):
        ids = generate(self, input_ids, *args, **kwargs)
        gen["ids"].append(ids.cpu().numpy())
        return ids

    for prompt_mod, cont_mod, data in (("TEXT", "SPEECH", f"{prompts}/*.txt"),
                                       ("SPEECH", "TEXT", f"{work / 'sblimp'}/*.wav")):
        folder = root / f"generated_{cont_mod.lower()}"
        args = common + ["metric=cm_generate", "vocoder=vocoder_hubert_25",
                         f"metric.data_path={data}", f"metric.prompt_modality={prompt_mod}",
                         f"metric.cont_modality={cont_mod}", f"metric.num_files={n_prompts}",
                         f"metric.generate_kwargs.max_new_tokens={max_new_tokens}",
                         "+metric.generate_kwargs.seed=0", "metric.ext=wav",
                         f"metric.out_path={folder}"]
        gen.update(ids=[])
        UnitLM.generate = recorded_generate
        flash_attention_fwd.launches = 0                                # the main path's count
        try:
            t0 = time.perf_counter()
            outputs = cli_eval.eval_main(args)["generate"]
            gen_s = time.perf_counter() - t0
        finally:
            UnitLM.generate = generate
        launches = flash_attention_fwd.launches
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        new = np.concatenate([ids[:, -max_new_tokens:] for ids in gen["ids"]])
        banned = np.asarray(tok.get_ignore_tokens(cont_mod))
        in_modality = bool((~np.isin(new, banned) | (new == tok.pad_token_id)).all())
        written = sorted(p.name for p in folder.iterdir()) if folder.is_dir() else []
        if cont_mod == "SPEECH":
            made = sum(np.size(w) > 0 for w in outputs)
            files_ok = len(written) == made > 0 and all(n.endswith(".wav") for n in written)
            sizes = [int(np.size(w)) for w in outputs]
        else:
            files_ok = len(written) == len(outputs) == n_prompts and all(
                n.endswith(".txt") for n in written)
            sizes = [len(t.split()) for t in outputs]
        gen[cont_mod] = dict(seconds=gen_s, launches=launches, calls=len(gen["ids"]),
                             in_modality=in_modality, files=written, sizes=sizes)
        print(f"cli.eval metric=cm_generate {prompt_mod}->{cont_mod}: {len(outputs)} prompts, "
              f"{max_new_tokens} new tokens (seeded sampling, cm_generate.yaml's kwargs), "
              f"{len(gen['ids'])} generate calls, {gen_s:.1f} s with the loads; every new token "
              f"inside {cont_mod}'s ids: {in_modality}; outputs {sizes} "
              f"({'samples' if cont_mod == 'SPEECH' else 'words'}), files {written}; launches "
              f"{launches} on {smi}", flush=True)
        _require(in_modality, f"cm_generate {prompt_mod}->{cont_mod} emitted a token of the "
                 f"other modality")
        _require(files_ok, f"cm_generate {prompt_mod}->{cont_mod} wrote {written}")
        _require(launches == (len(gen["ids"]) * n_layers if on_card else 0),
                 f"cm_generate launched the flash forward {launches} times, not "
                 f"{len(gen['ids']) * n_layers if on_card else 0}")
    CHECKPOINT_MANAGER.set_root(textless_root)
    return dict(vocab=vocab, params=n_params, stage2_lines=n_lines, stage2_seconds=stage2_s,
                stage2_mixed=mixed, mixed_rows=n_rows_mixed, losses=losses,
                first_step_seconds=first_s, step_seconds=step_s, tokens_a_step=seen["tokens"], tokens_per_s=tokens_per_s,
                train_seconds=train_s, train_launches=train_launches,
                launches_per_step=seen["launches"], expected_launches=want,
                max_memory_allocated=peak_mem, storycloze=storycloze,
                cm_calls=len(calls), cm_widths=widths, cm_seconds=cm_s,
                cm_launches=cm_launches, card_vs_cpu_ll_err=ll_err,
                generate={k: gen[k] for k in ("SPEECH", "TEXT")})


def _f64_fwd(q, k, v, seg, kv_seg, causal: bool, sm_scale=None):
    """The flash forward's function in float64, a batch row and kv head at
    a time: (out, lse), dead rows 0 and 1e30 as the kernels give them."""
    import torch

    from slamkit_tpu_torch.ops import attention_mask

    b, h, t, d = q.shape
    g = h // k.shape[1]
    scale = d ** -0.5 if sm_scale is None else sm_scale
    out = torch.zeros((b, h, t, d), dtype=torch.float64, device=q.device)
    lse = torch.full((b, h, t), 1e30, dtype=torch.float64, device=q.device)
    for r in range(b):
        rows = lambda x: None if x is None else x[r:r + 1]
        mask = attention_mask(t, t, causal=causal, q_segment_ids=rows(seg),
                              k_segment_ids=rows(seg if kv_seg is None else kv_seg),
                              device=q.device)
        mask = (torch.ones((t, t), dtype=torch.bool, device=q.device) if mask is None
                else mask.reshape(t, t))
        alive = mask.any(-1)
        for j in range(k.shape[1]):
            heads = slice(j * g, (j + 1) * g)
            s = torch.einsum("gqd,td->gqt", q[r, heads].double(), k[r, j].double()) * scale
            s = s.masked_fill(~mask, float("-inf"))
            lse_j = torch.logsumexp(s, -1)
            p = torch.exp(s - lse_j[..., None]).nan_to_num(0.0)   # dead rows: -inf - -inf
            out[r, heads] = torch.einsum("gqt,td->gqd", p, v[r, j].double())
            lse[r, heads] = torch.where(alive, lse_j, 1e30)
            del s, p
    return out, lse


def hold_launch(args, out) -> dict:
    """One float32 flash launch of the main path, its inputs `args` (as
    `_launch` takes them) and its (out, lse), against the plain version on
    the same q, k, v, and both against float64: the kernel's error may be
    F32_YARDSTICK_FACTOR times the plain version's, and no less than phase
    3e's bounds."""
    q, k, v, q_seg, k_seg, causal, sm_scale = args
    ref, ref_lse, chunks = _plain_fwd(q, k, v, q_seg, k_seg, causal, sm_scale)
    err_out, err_lse, n_dead, dead_ok = _held_errors(*out, ref, ref_lse)
    exact, exact_lse = _f64_fwd(q, k, v, q_seg, k_seg, causal, sm_scale)
    alive = ref_lse != 1e30
    off = lambda o, lse: ((o.double() - exact)[alive].abs().max().item(),
                          (lse.double() - exact_lse)[alive].abs().max().item())
    (k_out, k_lse), (p_out, p_lse) = off(*out), off(ref, ref_lse)
    del exact, exact_lse, ref, ref_lse
    out_bound = max(F32_OUT_BOUND, F32_YARDSTICK_FACTOR * p_out)
    lse_bound = max(F32_LSE_BOUND, F32_YARDSTICK_FACTOR * p_lse)
    pads = (q_seg == -1) if q_seg is not None else None
    return dict(shape=list(q.shape[:2]) + [k.shape[1]] + list(q.shape[2:]), causal=causal,
                pads=None if pads is None else pads.sum(1).tolist(),
                left_padded=None if pads is None else bool(pads[:, 0].any().item()),
                max_abs_err_out=err_out, max_abs_err_lse=err_lse,
                f64_err_out=k_out, f64_err_lse=k_lse, plain_f64_err_out=p_out,
                plain_f64_err_lse=p_lse, out_bound=out_bound, lse_bound=lse_bound,
                dead_rows=n_dead, plain_chunks=chunks,
                ok=k_out <= out_bound and k_lse <= lse_bound and dead_ok)


def lm_scores(model, tokeniser, texts) -> tuple:
    """The text LM's logits [N, V] at every scored position of `texts` and
    each scored token's log-probability [N], padded and masked as
    `UnitLM.log_likelihood` pads and masks them, on the CPU, with the
    scored tokens' count of each text."""
    import torch

    pad = model.config.pad_token_id
    ids = torch.as_tensor(tokeniser(texts, padding=True, return_tensors="np")["input_ids"],
                          dtype=torch.long, device=model.device)
    ids = torch.nn.functional.pad(ids, (0, (-ids.shape[1]) % 64), value=pad)
    with torch.inference_mode():
        logits, _ = model.decoder(ids, segment_ids=torch.where(ids == pad, -1, 0).int())
        target = ids[:, 1:]
        keep = target != pad
        logits = logits[:, :-1][keep]
        logp = torch.log_softmax(logits, -1).gather(-1, target[keep][:, None])[:, 0]
    return logits.cpu(), logp.cpu(), keep.sum(1).tolist()


def run_genppl(dev, smi: str, work: pathlib.Path, tiny: bool = False, hubert_cfg=None,
               voc_cfg=None, n_files: int = 8, batch: int = 8, max_new_tokens=None) -> dict:
    """Phase 12, in phase 9's work directory (its checkpoint-2, HuBERT
    directory, centroids and WAVs): GenPPL and the LLM judge through the
    port's command line. `tools/genppl_recipe.py` writes a
    whisper-large-v3-turbo-shaped checkpoint and a Llama-3.2-1B-shaped text
    LM (random F16 weights; `tiny` for the CPU rehearsal's widths), then
    `cli.eval metric=asr_perplexity` and `metric=llm_as_judge` (alignment
    prompts) run over `n_files` of phase 9's WAVs with vocoder_hubert_25 at
    phase 8's CodeHiFiGAN widths, each stage timed. On the card every
    generate call launches the bf16 forward once per SLM layer (its
    prefill), every text-LM scoring call and every judge prefill the float32
    forward once per text-LM layer; the last float32 launch of each run (the
    last layer of a scoring batch, of a judge prefill) is held against the
    plain version and float64 on its own q, k, v, and a whole transcript of
    the first scoring batch and one Whisper window against float32 CPU runs.
    On the CPU no launch may be counted."""
    import gc
    import importlib
    import shutil

    import torch

    from slamkit_tpu_torch.cli import eval as cli_eval
    from slamkit_tpu_torch.feature_extractor import HUBERT_CONFIG_PRESETS, HubertConfig
    from slamkit_tpu_torch.metric import generative_metric as gm
    from slamkit_tpu_torch.metric import metric_utils
    from slamkit_tpu_torch.metric.whisper import WhisperPipeline
    from slamkit_tpu_torch.models import SpeechLM, UnitLMConfig
    from slamkit_tpu_torch.ops import flash_attention_fwd
    from slamkit_tpu_torch.tools import genppl_recipe, sims_recipe
    from slamkit_tpu_torch.utils.audio import audio_info
    from slamkit_tpu_torch.vocoder import HiFiGANVocoder
    from slamkit_tpu_torch.vocoder.checkpoint_manager import CHECKPOINT_MANAGER

    fa_module = importlib.import_module("slamkit_tpu_torch.ops.flash_attention")
    on_card = dev.type == "cuda"
    root = work / "genppl"
    t0 = phase_start = time.perf_counter()
    whisper_dir = genppl_recipe.write_whisper_dir(root / "whisper", tiny=tiny)
    llama_dir = genppl_recipe.write_llama_dir(root / "llama", tiny=tiny)
    write_s = time.perf_counter() - t0
    with open(pathlib.Path(whisper_dir) / "config.json") as f:
        w_cfg = json.load(f)
    with open(pathlib.Path(llama_dir) / "config.json") as f:
        l_cfg = json.load(f)
    sizes = {d: sum(p.stat().st_size for p in pathlib.Path(d).iterdir())
             for d in (whisper_dir, llama_dir)}
    print(f"GenPPL directories in {write_s:.1f} s: Whisper d_model {w_cfg['d_model']}, "
          f"{w_cfg['encoder_layers']} + {w_cfg['decoder_layers']} layers, vocab "
          f"{w_cfg['vocab_size']} ({sizes[whisper_dir]} B); Llama hidden {l_cfg['hidden_size']}, "
          f"{l_cfg['num_hidden_layers']} layers, {l_cfg['num_attention_heads']}/"
          f"{l_cfg['num_key_value_heads']} heads, vocab {l_cfg['vocab_size']} "
          f"({sizes[llama_dir]} B)", flush=True)
    prompts = root / "prompts"
    prompts.mkdir(parents=True, exist_ok=True)
    wavs = sorted((work / "sblimp").glob("*.wav"))[:n_files]
    for w in wavs:
        shutil.copy(w, prompts / w.name)
    wavs = sorted(prompts.glob("*.wav"))
    seconds = [n / sr for n, sr in map(audio_info, map(str, wavs))]
    align = genppl_recipe.write_alignments(root / "align", [str(w) for w in wavs], seconds)
    textless_root = CHECKPOINT_MANAGER.disk_root
    CHECKPOINT_MANAGER.set_root(sims_recipe.write_textless_vocoder(root / "textless",
                                                                   voc_cfg or CODEHIFIGAN_CFG))
    hubert_cfg = hubert_cfg or HubertConfig(**HUBERT_CONFIG_PRESETS["slprl/mhubert-base-25hz"])
    ckpt = work / "cli_run" / "checkpoint-2"
    with open(ckpt / "unit_lm_config.json") as f:
        slm_layers = UnitLMConfig.from_dict(json.load(f)).decoder_config().num_layers
    common = [f"model.pretrained_model={ckpt}",
              f"tokeniser.feature_extractor.pretrained_model={work / 'hubert'}",
              f"tokeniser.feature_extractor.kmeans_path={work / 'km.npy'}",
              f"tokeniser.feature_extractor.layer={hubert_cfg.num_hidden_layers - 1}",
              "vocoder=vocoder_hubert_25", f"batch_size={batch}", "num_workers=8",
              f"metric.data_path={prompts}/*.wav", f"metric.num_files={n_files}",
              f"metric.whisper_model={whisper_dir}", f"metric.llm_name_or_path={llama_dir}",
              "+metric.generate_kwargs.seed=0",
              *([f"metric.generate_kwargs.max_new_tokens={max_new_tokens}"]
                if max_new_tokens else []),
              *([] if on_card else ["device=cpu", "model.config_args.torch_dtype=float32"])]

    # ---- the stages, timed; what they saw, kept -----------------------------
    seen = {}
    patched = []

    def wrap(owner, name, label, keep=False):
        fn = getattr(owner, name)

        def timed(*args, **kwargs):
            _sync(dev)
            before = (flash_attention_fwd.launches, flash_attention_fwd.f32_launches)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            _sync(dev)
            seen.setdefault(label, []).append(dict(
                seconds=time.perf_counter() - t0,
                bf16=flash_attention_fwd.launches - before[0],
                f32=flash_attention_fwd.f32_launches - before[1],
                **(dict(args=args, out=out) if keep else {})))
            return out

        patched.append((owner, name, fn))
        setattr(owner, name, timed)

    last_f32 = {}

    def keep_last_f32(launch):
        """`_launch`, keeping a copy of the inputs and outputs of its last
        float32 call in `last_f32`."""
        def kept(*args):
            out = launch(*args)
            if args[0].dtype == torch.float32:
                last_f32.update(args=tuple(a.clone() if torch.is_tensor(a) else a for a in args),
                                out=tuple(o.clone() for o in out))
            return out

        patched.append((fa_module, "_launch", launch))
        fa_module._launch = kept

    def unwrap():
        while patched:
            owner, name, fn = patched.pop()
            setattr(owner, name, fn)

    def stage(label):
        return [round(r["seconds"], 4) for r in seen.get(label, [])]

    runs, held = {}, {}
    for metric in ("asr_perplexity", "llm_as_judge"):
        extra = ([f"metric.alignment_folder={align}", "metric.min_file_length=0.1"]
                 if metric == "llm_as_judge" else [])
        args = [*common, f"metric={metric}", *extra]
        print(f"cli.eval {' '.join(args)}", flush=True)
        seen.clear()
        for owner, name, label, keep in (
                (SpeechLM, "generate", "generate", False),
                (HiFiGANVocoder, "vocode_batch", "vocode", False),
                (WhisperPipeline, "__call__", "transcribe", True),
                (gm, "get_llm_perplexity", "score", True),
                (metric_utils.LLMJudge, "__call__", "judge", True),
                (metric_utils, "judge_text", "judge_batch", False),
                (gm, "get_whisper_pipeline", "load_whisper", True),
                (gm, "get_llm", "load_llm", True), (gm, "get_judge", "load_judge", True)):
            wrap(owner, name, label, keep)
        keep_last_f32(fa_module._launch)
        last_f32.clear()
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        flash_attention_fwd.launches = flash_attention_fwd.f32_launches = 0  # the main path's
        try:
            t0 = time.perf_counter()
            res = cli_eval.eval_main(args)
            _sync(dev)
            total = time.perf_counter() - t0
        finally:
            unwrap()
        launches = {"flash_fwd": flash_attention_fwd.launches,
                    "flash_fwd_f32": flash_attention_fwd.f32_launches}
        peak = torch.cuda.max_memory_allocated(dev) if on_card else None
        gen_calls, vocode_s = len(seen.get("generate", [])), sum(stage("vocode"))
        f32_calls = len(seen.get("score" if metric == "asr_perplexity" else "judge_batch", []))
        run = dict(seconds=total, launches=launches, max_memory_allocated=peak,
                   generate_seconds=[g - v for g, v in zip(stage("generate"),
                                                           stage("vocode") or [0] * gen_calls)],
                   vocode_seconds=stage("vocode"), transcribe_seconds=stage("transcribe"),
                   score_seconds=stage("score"), judge_seconds=stage("judge"),
                   load_seconds={k: stage(k) for k in ("load_whisper", "load_llm",
                                                        "load_judge") if k in seen},
                   generate_calls=gen_calls, f32_calls=f32_calls)
        if metric == "asr_perplexity":
            ppl, bleu = res["asr_perplexity"], res["auto-belu-2"]
            texts = [t for r in seen["score"] for t in r["args"][2]]
            run.update(asr_perplexity=ppl, auto_bleu=bleu, transcripts=len(texts),
                       transcript_chars=[len(t) for t in texts])
            print(f"cli.eval metric=asr_perplexity: asr_perplexity {ppl}, auto-BLEU-2 {bleu} "
                  f"over {len(texts)} transcripts of {run['transcript_chars']} characters; "
                  f"{total:.1f} s in all", flush=True)
            _require(math.isfinite(ppl) and ppl > 0 and 0.0 <= bleu <= 1.0
                     and len(texts) == n_files, f"asr_perplexity gave {ppl}, auto-BLEU {bleu} "
                     f"over {len(texts)} transcripts")
        else:
            judged = [t for r in seen["judge"] for t in r["args"][1]]
            pairs = res["audio_transcription"]
            run.update(llm_as_judge=res["llm_as_judge"], judged=len(judged),
                       scores=[r["out"] for r in seen["judge"]])
            print(f"cli.eval metric=llm_as_judge: llm_as_judge {res['llm_as_judge']} (a random "
                  f"judge rarely writes \\boxed{{n}}: nan when it never does) over "
                  f"{len(judged)} instructions of {[len(t) for t in judged]} characters; "
                  f"scores {run['scores']}; {total:.1f} s in all", flush=True)
            _require(len(judged) == len(pairs) == n_files and all(
                p in t and g in t for t, (p, g) in zip(judged, pairs)),
                "the judge's instructions do not hold the transcripts")
        want = {"flash_fwd": gen_calls * slm_layers,
                "flash_fwd_f32": f32_calls * l_cfg["num_hidden_layers"]} if on_card else {
            "flash_fwd": 0, "flash_fwd_f32": 0}
        print(f"{metric} stages (s): generate {run['generate_seconds']}, vocode "
              f"{run['vocode_seconds']}, transcribe {run['transcribe_seconds']}, score "
              f"{run['score_seconds']}, judge {run['judge_seconds']}, loads "
              f"{run['load_seconds']}; launches {launches} (predicted {want}); "
              f"max_memory_allocated {peak} B; on {smi}", flush=True)
        _require(launches == want and gen_calls >= 1 and f32_calls >= 1,
                 f"{metric} launched {launches}, predicted {want}")
        runs[metric] = run
        if metric == "asr_perplexity":
            card_pipe = seen["load_whisper"][0]["out"]
            card_lm, card_tok = seen["load_llm"][0]["out"]
            score_texts = seen["score"][0]["args"][2]
            window = next(w for r in seen["transcribe"] for w in r["args"][1])
        seen.clear()
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        # the run's last float32 launch against the plain version
        _require(bool(last_f32) == on_card, f"{metric}: float32 launches kept "
                 f"{len(last_f32) // 2}, on the card: {on_card}")
        if on_card:
            held[metric] = hold_launch(last_f32["args"], last_f32["out"])
            last_f32.clear()
            torch.cuda.empty_cache()
            h = held[metric]
            print(f"{metric}'s last float32 flash launch {h['shape']} "
                  f"({'left' if h['left_padded'] else 'right'}-padded, pads {h['pads']}) on its "
                  f"q, k, v: against the plain version |dout|={h['max_abs_err_out']:.3e} "
                  f"|dlse|={h['max_abs_err_lse']:.3e}; against float64 |dout|="
                  f"{h['f64_err_out']:.3e} (<= {h['out_bound']:.3e}; plain "
                  f"{h['plain_f64_err_out']:.3e}) |dlse|={h['f64_err_lse']:.3e} (<= "
                  f"{h['lse_bound']:.3e}; plain {h['plain_f64_err_lse']:.3e}) dead="
                  f"{h['dead_rows']}  {'ok' if h['ok'] else 'FAIL'}", flush=True)
            _require(h["ok"], f"{metric}'s float32 flash launch disagrees with the plain version")
    CHECKPOINT_MANAGER.set_root(textless_root)

    # ---- the card against float32 CPU runs ----------------------------------
    # text LM: the shortest transcript of the first scoring batch, whole
    # (the CPU's float32 forward is the slow side), through the card's model
    # and a CPU one
    t0 = time.perf_counter()
    texts = [min(score_texts, key=len)]
    card_logits, card_logp, counts = lm_scores(card_lm, card_tok, texts)
    del card_lm
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    cpu_lm, cpu_tok = metric_utils.get_llm(llama_dir, device="cpu")
    cpu_logits, cpu_logp, _ = lm_scores(cpu_lm, cpu_tok, texts)
    del cpu_lm
    logit_err = float((card_logits - cpu_logits).norm() / cpu_logits.norm())
    logp_err = float((card_logp - cpu_logp).abs().max())
    del card_logits, cpu_logits
    gc.collect()
    lm_check_s = time.perf_counter() - t0
    nll = lambda logp: [round(-float(x.mean()), 6) for x in logp.split(counts)]
    print(f"text LM card vs float32 CPU on {len(texts)} whole transcript "
          f"({[len(t) for t in texts]} characters, {counts} scored tokens): logits "
          f"||d||/||cpu|| {logit_err:.3e} (<= {GENPPL_LOGIT_REL_BOUND}), token log-probabilities "
          f"max |d| {logp_err:.3e} (<= {GENPPL_LOGP_BOUND}); mean NLL {nll(card_logp)} vs "
          f"{nll(cpu_logp)}; {lm_check_s:.1f} s", flush=True)
    _require(logit_err <= GENPPL_LOGIT_REL_BOUND and logp_err <= GENPPL_LOGP_BOUND,
             "the text LM on the card disagrees with the float32 CPU run")
    # Whisper: one window's encoder output, then the decoder teacher-forced
    # on the CPU's greedy tokens, step by step on both
    cpu_pipe = WhisperPipeline(whisper_dir, device="cpu")
    enc_card = card_pipe.model.encode(card_pipe.features([window]))
    enc_cpu = cpu_pipe.model.encode(cpu_pipe.features([window]))
    enc_err = float((enc_card.cpu() - enc_cpu).norm() / enc_cpu.norm())
    forced = cpu_pipe.forced_ids
    max_new = cpu_pipe.cfg.max_target_positions - len(forced)
    toks = cpu_pipe.model.greedy_decode(enc_cpu, forced, max_new, cpu_pipe.suppress,
                                        cpu_pipe.begin_suppress)
    card_toks = card_pipe.model.greedy_decode(enc_card, forced, max_new, card_pipe.suppress,
                                              card_pipe.begin_suppress).cpu()
    caches = (card_pipe.model.new_cache(1, toks.shape[1]), cpu_pipe.model.new_cache(1, toks.shape[1]))
    xkv = (card_pipe.model.cross_kv(enc_card), cpu_pipe.model.cross_kv(enc_cpu))
    step_err = 0.0
    for i in range(toks.shape[1] - 1):
        a = card_pipe.model.decoder_step(toks[:, i].to(dev), i, caches[0], xkv[0]).cpu()
        b = cpu_pipe.model.decoder_step(toks[:, i], i, caches[1], xkv[1])
        step_err = max(step_err, float((a - b).norm() / b.norm()))
    same = float((card_toks == toks).float().mean())
    del cpu_pipe, card_pipe, caches, xkv
    gc.collect()
    print(f"Whisper card vs float32 CPU on one window: encoder ||d||/||cpu|| {enc_err:.3e} "
          f"(<= {WHISPER_REL_BOUND}), teacher-forced logits over {toks.shape[1] - 1} steps worst "
          f"||d||/||cpu|| {step_err:.3e} (<= {WHISPER_REL_BOUND}); greedy tokens equal to the "
          f"CPU's: {same:.4f}", flush=True)
    _require(enc_err <= WHISPER_REL_BOUND and step_err <= WHISPER_REL_BOUND,
             "Whisper on the card disagrees with the float32 CPU run")
    if on_card:
        torch.cuda.empty_cache()
    phase_s = time.perf_counter() - phase_start
    print(f"phase 12: {phase_s:.1f} s in all", flush=True)
    return dict(write_seconds=write_s, dir_bytes=list(sizes.values()), runs=runs,
                seconds=phase_s, f32_held=held, card_vs_cpu_logit_rel_err=logit_err,
                card_vs_cpu_logp_err=logp_err, lm_check_seconds=lm_check_s,
                whisper_encoder_rel_err=enc_err,
                whisper_logit_rel_err=step_err, whisper_tokens_equal=same)


def main() -> int:
    if not (ROOT / "slamkit_tpu_torch" / "ops" / "csrc" / "flash_fwd.cu").is_file():
        print("chip_smoke: run from a checkout of the repository (slamkit_tpu_torch/ "
              "is missing beside this script)", file=sys.stderr)
        return 2
    start = time.perf_counter()
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
    from slamkit_tpu_torch.ops.flash_attention import KERNEL, KERNEL_BWD, KERNEL_F32
    from slamkit_tpu_torch.ops.matmul_probe import KERNEL as PROBE_KERNEL
    from slamkit_tpu_torch.ops.quant import KERNEL as DQ_KERNEL

    t0 = time.perf_counter()
    names = (KERNEL, KERNEL_BWD, DQ_KERNEL, PROBE_KERNEL, KERNEL_F32)
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
        f32_rows = check_kernels(dev, f32=True)
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
        torch.cuda.empty_cache()
        sims_result = run_sims(dev, smi, pathlib.Path(work))
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        genppl_result = run_genppl(dev, smi, pathlib.Path(work))
        print(f"phases 1-11: {t0 - start:.1f} s", flush=True)
    speech_runs = speech_result["runs"]

    score = next(r for r in kernel_rows if r["name"] == "score_ctx1024")
    bwd = next(r for r in backward_rows if r["name"] == "slam_ctx1024")
    # the kernels line times dq_matmul at a decode step's largest projection
    # (up / gate: [8, 896] x [896, 4864]) and the probe at its K = 128 shape
    dq = next(r for r in dq_rows if (r["m"], r["k"], r["n"]) == (8, 896, 4864))
    # ... and the prefill GEMM (M > 16), a kernel of its own, at M = 1024 up / gate
    dq_prefill = next(r for r in dq_rows if (r["m"], r["k"], r["n"]) == (1024, 896, 4864))
    probe = next(r for r in probe_result["shapes"] if r["k"] == 128)
    # ... and the float32 forward at phase 12's scoring batch
    f32 = next(r for r in f32_rows if r["name"] == "genppl_score")
    genppl_runs = genppl_result["runs"].values()
    print(json.dumps({"shapes": kernel_rows, "backward_shapes": backward_rows,
                      "dq_shapes": dq_rows, "probe": probe_result, "f32_shapes": f32_rows,
                      "slice": slice_result, "training": train_result,
                      "card_vs_cpu": cpu_result, "speech": speech_result,
                      "cli": cli_result, "dpo": dpo_result, "sims": sims_result,
                      "genppl": genppl_result}), flush=True)
    print(f"the whole run: {time.perf_counter() - start:.1f} s", flush=True)
    print(nvidia_smi(), flush=True)

    print(json.dumps({"kernels": [
        kernel_row("flash_fwd", "slamkit_tpu_torch/ops/csrc/flash_fwd.cu",
                   "slamkit_tpu/ops/flash_attention.py:124", ["flash_fwd_kernel"],
                   slice_result["launches"] + train_result["launches"]["flash_fwd"]
                   + sum(r["launches"]["flash_fwd"] for r in speech_runs.values())
                   + cli_result["train_launches"]["flash_fwd"] + cli_result["eval_launches"]
                   + dpo_result["launches"]["flash_fwd"]
                   + sims_result["train_launches"]["flash_fwd"] + sims_result["cm_launches"]
                   + sum(g["launches"] for g in sims_result["generate"].values())
                   + sum(r["launches"]["flash_fwd"] for r in genppl_runs),
                   max(r["max_abs_err_out"] for r in kernel_rows), score),
        kernel_row("flash_bwd", "slamkit_tpu_torch/ops/csrc/flash_bwd.cu",
                   "slamkit_tpu/ops/flash_attention.py:247",
                   ["flash_bwd_prep_kernel", "flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel"],
                   train_result["launches"]["flash_bwd"]
                   + cli_result["train_launches"]["flash_bwd"]
                   + dpo_result["launches"]["flash_bwd"]
                   + sims_result["train_launches"]["flash_bwd"],
                   max(max(r["max_abs_err"].values()) for r in backward_rows), bwd),
        dict(kernel_row("dq_matmul", "slamkit_tpu_torch/ops/csrc/dq_matmul.cu",
                        "slamkit_tpu/ops/quant.py:43", ["dq_gemv_kernel | dq_gemm_kernel"],
                        speech_runs["int8"]["launches"]["dq_matmul"],
                        max(r["max_abs_err"] for r in dq_rows), dq),
             prefill=prefill_entry(dq_prefill)),
        kernel_row("matmul_probe", "slamkit_tpu_torch/ops/csrc/matmul_probe.cu",
                   "scripts/bench_flash.py:98", ["matmul_probe_kernel"],
                   probe_result["launches"],
                   max(r["max_abs_err"] for r in probe_result["shapes"]), probe),
        kernel_row("flash_fwd_f32", "slamkit_tpu_torch/ops/csrc/flash_fwd_f32.cu",
                   "slamkit_tpu/ops/flash_attention.py:124", ["flash_fwd_f32_kernel"],
                   sum(r["launches"]["flash_fwd_f32"] for r in genppl_runs),
                   max(r["max_abs_err_out"] for r in f32_rows), f32)]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
