#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training, speech-continuation, DPO,
interleaved speech-text (SIMS), generation-metric (GenPPL, LLM judge),
float32-training, data-preparation and training-settings (dropout,
layerdrop, qkv remat, Adafactor) slices, SIMS at its shipped defaults,
model=slam_dh128 and its command line once on an NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card (an H100 for
the sm_90a kernels). Phases, in order; any failure exits non-zero:

  1. device  — require CUDA; print the card, its power limit and versions;
               switch TF32 off for float32 matmuls and cuDNN.
  2. build   — compile the six CUDA kernel libraries from
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
  3d. probe  — the contraction-probe kernel (wgmma, as the flash kernels'
               products) against its plain version at its four shapes, the K=64/K=128 and N=64/N=128 time ratios, then
               its entry point `tools/bench_flash.py --matmul-probe` (no
               single PyTorch call computes the probe: no library time).
  3e. float32 forward — the float32 flash forward (flash_fwd_f32.cu)
               against its plain version on the same float32 inputs at the
               text LM's shapes (`llama1b_f32`: [8, 32/8, 512, 64] with
               log_likelihood's right pads; d = 128; packed rows) and at
               phase 12's own (`genppl_score`: [8, 32/8, 3584, 64], rows of
               1700-3584 tokens and a -1 tail; `judge_prefill`: [8, 32/8,
               7680, 64], left-padded; the plain version there batch rows
               at a time) and phase 13's training batches (`twist_f32`:
               [8, 12/12, 512, 64], `slam_f32`: [8, 14/2, 1024, 64], packed)
               and tensor parallelism's float32 scoring at 'model' = 2
               (`tp2_slam_f32`: [10, 7/1, 1024, 64], rows of 100-1024 and a
               -1 tail, the kernels line's `tp2_slam_f32` entry),
               each call repeated bitwise, timed as phase 3
               times the bf16
               forward; bound by bytes over 3.35 TB/s or FLOPs over the
               float32 rate of 3xTF32 on the H100's tensor cores (495 / 3
               TFLOP/s; the CUDA-core 67 TFLOP/s bound printed beside it);
               library call SDPA in
               float32 on the same masked inputs.
  3f. float32 backward — the float32 flash backward (flash_bwd_f32.cu)
               against its plain version on the same float32 inputs, O and
               LSE at phase 13's shapes (`twist_f32`: [8, 12/12, 512, 64]
               packed; `slam_f32`: [8, 14/2, 1024, 64], 8 packed segments
               and a -1 tail; `d128_f32`: [8, 7/1, 1024, 128]; a ragged T of
               1000; `dpo_f32`: [16, 14/2, 152, 64] with -1 tails; dead
               rows), each call repeated bitwise, timed as phase 3b times the
               bf16 backward; bound by bytes over 3.35 TB/s or FLOPs over 165
               TFLOP/s (67 beside it); library call SDPA's float32 backward.
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
               against float32 on the CPU; `cli.eval metric=sblimp
               metric.used_token_modality=SPEECH` over phase 9's WAV pairs,
               every log-likelihood finite; `cli.eval metric=cm_generate`
               TEXT->SPEECH through vocoder=vocoder_hubert_25 (4 prompts, 40
               new tokens, WAVs written) and SPEECH->TEXT on 4 of phase 9's
               WAVs (.txt written), every new token inside its modality.
  12. GenPPL and the LLM judge — in phase 9's work directory:
               `tools/genppl_recipe.py` writes a whisper-large-v3-turbo-shaped
               checkpoint (d_model 1280, its 32 encoder layers cut to
               `GENPPL_DEPTHS`' 8, 4 decoder layers, 128 mel bins, vocab
               51866, the real special-token ids and suppress lists) and a
               Llama-3.2-1B-shaped text LM (16 layers cut to 4, hidden 2048,
               32/8 heads, vocab 128256, tied), random F16 weights; then
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
               text LM's logits and token log-probabilities over the
               first `GENPPL_CPU_CHARS` characters of a transcript of the
               scoring batch, and one Whisper window (its
               encoder output and the
               decoder teacher-forced on the CPU's greedy tokens), held
               against float32 CPU runs.
  13. float32 training — in phase 9's work directory, on phase 9's Markov
               corpus: `cli.train` with train.yaml's defaults (model=twist,
               OPT-125m at its published widths, context 512; TWIST falls
               back to random init) and model.config_args.torch_dtype=float32,
               2 steps of 4 x 8 with a save every step, and a run resumed
               from checkpoint-1 whose step-2 loss, eval loss and exported
               weights equal the uninterrupted run's bit for bit; the same
               with model=slam (full width and depth, context 1024, full
               remat); one microbatch of each (its first 2 rows at 512, its
               first row at 1024) on the card against float32 on the CPU
               from the run's last checkpoint, the loss and every parameter
               gradient; `cli.preference_alignment_train` in float32 from
               the Slam run's checkpoint (dpo_training_args, 4 steps of [16,
               152], a save at step 3, step 1 at ln 2) and a run resumed from
               that save, exact as above. Params, gradients, AdamW moments
               and compute are float32; seconds a step, non-pad tokens/s and
               `max_memory_allocated` for each run.
  14. the data path — in a work directory of its own beside phase 9's,
               with phase 9's HuBERT directory (mhubert-base-25hz widths):
               (a) g++'s and libav's versions; the native packer and codec
               must load, and the libav audio decoder wherever libav is
               present (where it is absent a line says so: FLAC is then
               held only by the CPU tests, must raise here, and (b) and (d)
               read WAV twins of the same PCM); (b) 64 seeded files of 2-16
               s, 16 kHz mono (equal to PCM / 32768 bit for bit) and 44.1
               kHz stereo (downmixed and resampled), decode and audio
               seconds; (c) `kmeans_fit` on the card, K = 500 over a 3.2 GB
               memmap of 1048576 x 768 separated clusters, 25 iterations in
               batches of 65536, a second fit bitwise equal, the clusters'
               centres recovered, the CPU's fit on 65536 rows x 5 iterations
               within KMEANS_REL_BOUND, seconds and fitted rows/s, then 500
               centroids on (b)'s HuBERT features as km.npy; (d)
               `cli.extract_features` with the YAML's default ext=flac and
               km.npy, each line equal to a direct `audio_represent`, and
               `cli.prepare_tokens`; (e) `cli.train` model=slam, 2 steps of 8
               x 1024, on two seeded 8M-token unit corpora mixed 0.5 / 0.5
               with data.spill_tokens=2097152 and a fresh data.saved_ds_path,
               then again from the cache: both runs' batches and step-1
               losses equal bit for bit, the spilled batches equal an
               in-RAM build's; `init_dataset`'s host seconds with and
               without the cache, the resident set, the disk.
  15. training settings — in phase 9's work directory: (a) `cli.train
               model=slam` at dropout 0.1, layerdrop 0.1, remat qkv and
               optim=adafactor (full width and depth, context 1024), 2 steps
               of 4 x 8 with a save every step, and a run resumed from
               checkpoint-1 whose step-2 loss, layerdrop decisions and
               exported weights equal the uninterrupted run's bit for bit;
               (b) one [2, 1024] microbatch of its stream at a fixed dropout
               seed: gradients under no remat, "full" and "qkv" bitwise
               equal and each policy's launches, then seconds a step,
               non-pad tokens/s and `max_memory_allocated` of 4 x [8, 1024]
               Adafactor steps under each, and Adafactor's state bytes
               against AdamW's; (c) mask statistics on the card; (d)
               model=twist with attn_implementation=xla and
               attention_dropout 0.1: 2 steps, no flash launch, an exact
               resume, and the flash path's refusal; (e)
               `cli.preference_alignment_train` from (a)'s checkpoint with
               its dropout, twice bit for bit, against the rates at 0; (f)
               Adafactor on the card against the CPU on Slam-shaped tensors.

  16. SIMS at its shipped defaults — in phase 9's work directory (its
               HuBERT directory, centroids and WAVs, phase 10's features):
               (b) `cli.train --config-name train_inter_scale` at its stock
               settings (B=8 at 2048, accumulation 1, no remat, bf16,
               flash_attention_2) on pythia-14m's base directory
               (`tools/sims_recipe.py::write_pythia14m_base`: its config.json
               and a GPT-NeoX-shaped tokenizer.json; TWIST falls back to
               random init), 2 steps with a save a step and a run resumed
               from checkpoint-1 that repeats step 2 bit for bit, then the
               same in float32; (c) float32 SIMS at phase 11's base
               (Qwen2.5-0.5B's widths, 151665 entries; 4 x 2 at 2048, remat,
               bf16 moments) with one [1, 256] slice against float32 on the
               CPU; (d) stage 2 through the shipped default text tokeniser's
               layout (`write_gpt2_bpe_files`: OPT-125m's vocab.json +
               merges.txt of 50265 ids, no tokenizer.json) on phase 11's
               seeded alignments, every line held to a direct call; (e)
               `cli.eval` through the interleaving tokeniser on (b)'s
               checkpoint: metric=sstorycloze over 16 seeded pairs,
               metric=generate with used_token_modality null, SPEECH and TEXT,
               and metric=asr_perplexity through genppl_recipe's Whisper and
               Llama directories at whisper-large-v3-turbo's and
               Llama-3.2-1B's widths (4 encoder and 4 text-LM layers), every
               score finite. Each run prints
               its launches, seconds a step, non-pad tokens/s and
               `max_memory_allocated`.
  17. ring attention — the ring's kernel sequence at the Slam shape
               ([8, 14/2, 1024, 64], 8 packed segments and a -1 tail) cut
               into 4 chunks of 256 (zigzag: halves of 128), for both
               schedules in bf16 and float32: `ops/ring_attention.py::
               ring_on_one_device` runs every rank's causal diagonal call,
               non-causal off-diagonal calls (distinct q / k segment ids,
               dead rows), LSE merges and backward from the global out and
               LSE, rotating in memory; out, LSE and gradients held to one
               kernel call over the whole sequence and to the plain
               version, the launches to the schedule's count; then each of
               its call shapes timed alone. The same, in bf16, at the local
               heads of the ('data', 'model', 'seq') mesh [1, 2, 2]: the
               Slam batch's 7/1 heads a rank cut into 2 chunks of 512
               (zigzag: halves of 256), and its call shapes (`diagonal`
               and `off_diagonal` [8, 7/1, 512, 64], `zigzag_half` [8, 7/1,
               256, 64]) timed alone. Where the host has two or more
               cards, `tools/parallel_smoke.py` on all of them (an even
               count) under torchrun, in five calls (pretraining meshes,
               DPO and the evaluation mesh; then fsdp and SIMS at
               Qwen2.5-7B's widths on fsdp; then tensor parallelism; then
               tensor parallelism with fsdp, Slam and SIMS 7B; then tensor
               parallelism beside the ring over 'seq'); on
               four or more, `tools/multinode.py` then starts its ranks as
               two torchrun nodes of two cards (DP [4], TP [2, 2] and
               fsdp [4] with training_args.multihost=true against one node
               of 4, DP again over NCCL's socket transport) within its own
               900 s; on one card a line says they are not run.
  18. slam_dh128 — in phase 9's work directory: `cli.train
               model=slam_dh128` (config/model/slam_dh128.yaml: the Slam
               recipe's decoder re-headed to 7 heads of 128 over one kv
               head, the same parameters; 24 layers, context 1024, bf16,
               full remat, bf16 moments, as phase 9 passes them) on a seeded
               Markov corpus, 2 steps of 4 x [8, 1024] (the recipe's
               accumulation of 16 cut to 4, `DH128_CUTS`) with a save every
               step, and a run resumed from checkpoint-1 whose step-2 loss
               equals the uninterrupted run's bit for bit; then one packed
               [2, 256] microbatch of its corpus in bf16 on the card against
               float32 on the CPU on the same weights (phase 7's bounds);
               seconds a step, non-pad tokens/s and `max_memory_allocated`.

Phases 3 and 3b also hold the kernels at DPO's shape (`dpo_T152`: [16, 14/2,
152, 64], one segment of 110-152 tokens a row and a -1 tail) and at SIMS's
(`sims_T2048`: [4, 14/2, 2048, 64], rows packed from segments of mixed
length, stage 2's short interleaved rows among text and speech rows of
300-700 tokens, and a -1 tail). Phases 3, 3b, 3e and 3f hold them at head
dims the kernels are not built for, zero-padded to 64, 128 or 256 around
the launch (`ops/flash_attention.py::_launch` / `_launch_bwd`): at
pythia-14m's SIMS batch (`pythia14m_sims`: [8, 4/4, 2048, 32], rows packed
as SIMS's), at d = 80 (`d80`: [4, 8/2, 1024, 80], 4 packed segments) and at
d = 160 (`d160`, the same layout), and at d = 256 itself (`d256`), the last
two causal and not (`_noncausal`), their bounds on the original d; no
shipped config runs d = 160 or 256. Phases 3e and 3f also hold the float32
kernels at float32 SIMS's shape (`sims_f32`: [4, 14/2, 2048, 64], rows
packed as `sims_T2048`'s), which phase 16 (c) runs. Phases 3 and 3b hold
the bf16 kernels at the local heads of tensor parallelism over 'model'
(`parallel/tensor.py`): the Slam batch at model = 2 (`tp2_slam`: [8, 7/1,
1024, 64]) and SIMS at Qwen2.5-7B's widths at model = 4 (`tp4_sims7b`: [2,
7/1, 2048, 128], tools/parallel_smoke.py's 2 rows a step) and at model = 2
under TP + fsdp [2, 2] (`tp2_sims7b`: [2, 14/2, 2048, 128]); they also hold
them at the whole heads of SIMS 7B on fsdp [4] (`fsdp4_sims7b`: [2, 28/4,
2048, 128]), and phase 3b at Qwen2.5-3B's heads at the SIMS context
(`qwen25_3b_sims`: [4, 16/2, 2048, 128], G = 8). Phase 3c
holds dq_matmul at the Slam projections split over model = 2 (up / gate's
[896, 2432] columns, down's [2432, 896] rows).

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
text-LM layer a batch (phase 12); float32 training launches the float32
forward (1 + remat) times a layer a microbatch and once a layer an eval
batch, and the float32 backward once a layer a microbatch, DPO's float32
steps and eval batches as phase 10's, and no bf16 kernel (phase 13); the
data path's two training runs as phase 6's microbatches (phase 14); under
remat_policy=qkv a training microbatch launches the forward and the
backward once per layer that layerdrop keeps (no remat: the same; full:
the forward twice), and the plain attention (attn_implementation=xla)
launches nothing (phase 15); the stock SIMS run launches the forward and
the backward of its dtype once per layer a microbatch, float32 SIMS the
float32 forward twice and the backward once, its scoring the forward once
per layer a call, its generation once per layer a prefill, and the text LM
of GenPPL the float32 forward once per text-LM layer a call (phase 16); a
ring pass of seq rank r of n launches 1 + r calls of each (contiguous) or
1 + 2 (n - 1) (zigzag), 10 and 28 a pass of all 4 ranks, 3 and 6 of both
'seq' ranks at the local heads (phase 17); slam_dh128's training
launches the backward once per layer a microbatch (96 a step: at d = 128
its warp-specialised dK / dV kernel) and the forward twice (phase 18); the
probe's entry
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
`dense_graph_ms`; the two float32 entries carry `cuda_core_bound_ms`, their
FLOPs at the CUDA cores' 67 TFLOP/s, beside `bound_ms` at 3xTF32's rate.
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
# the float32 forward against the same plain version on float32 inputs: the
# kernel's 3xTF32 products (~2^-22 of each product lost) and the plain
# version's float32 einsums (TF32 off) differ by ~1e-6 relative on |out| < 4
# and LSE < 12; one bf16 or TF32 rounding of a product would sit near 1e-3
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
# the float32 backward against the same plain version on float32 inputs:
# the kernel's 3xTF32 products and the plain version's float32 einsums (TF32
# off) differ by float32 noise. dK and dV sum G x T terms (dQ
# sums T), so the bound grows with G T: max |kernel - plain| of each of dq,
# dk, dv within 16 eps32 sqrt(G T) of that gradient's max |plain| (2.1e-5
# at G T = 512, 8.1e-5 at 7 x 1024), a random walk of float32 roundings
# with room for the worst of them; a TF32 or bf16 product anywhere (2^-11 or
# 2^-8 a rounding) would sit above 1e-3
F32_EPS, F32_BWD_FACTOR = 2.0 ** -23, 16.0
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
# LM over a transcript's first GENPPL_CPU_CHARS characters: its logits at
# every scored position,
# ||card - cpu|| / ||cpu|| <= 1e-4, and each scored token's log-probability
# (logits of a few units: ~1e-5 nats of float32 noise) within 1e-4 nats.
# Whisper's encoder output over its 32 layers and the teacher-forced decoder
# logits: ||card - cpu|| / ||cpu|| <= 1e-4, as HuBERT's
GENPPL_LOGIT_REL_BOUND, GENPPL_LOGP_BOUND, WHISPER_REL_BOUND = 1e-4, 1e-4, 1e-4
# ~500 of the text LM's tokens: the CPU's float32 forward over a whole
# transcript (~2600 tokens) took ~81 s on the card's host, time the whole
# run's 1200 s limit no longer leaves; every scored position of the prefix
# is held to the same bounds
GENPPL_CPU_CHARS = 320
# phase 12's Whisper encoder layers and text-LM layers, cut in depth (from
# 32 and 16) at their published widths for the same reason: writing both
# directories, loading them four times and the CPU's float32 runs took
# ~62 s, ~123 s and ~45 s of the run at full depth
GENPPL_DEPTHS = (8, 4)
# phase 13, float32 training: one microbatch's loss and every parameter
# gradient on the card against float32 on the CPU, on the same weights and
# batch. Both sides compute in float32 (TF32 off; 3xTF32 flash kernels)
# and differ by summation order alone (~1e-6 relative through the layers),
# where a TF32 or bf16 product would sit at 1e-3 or more. The loss within
# 1e-5 of |cpu|; each tensor's max |card - cpu| within 1e-4 of its own max
# |cpu|, or of 1e-2 of the largest gradient's where its own is smaller: OPT's
# k bias has a gradient of exactly 0 (softmax ignores a shift every score of
# a row shares), so both sides hold only float32 noise there. OPT's ReLU has
# a kink: a pre-activation within float32 noise of 0 may fall on either
# side, and one such flip moves a column of up_w's gradient by ~1e-2 of its
# largest entry. So the CPU takes the card's ReLU masks (both sides then
# differentiate one piecewise-linear function) and the flips are counted
F32_LOSS_REL_BOUND, F32_GRAD_REL_BOUND, F32_GRAD_FLOOR = 1e-5, 1e-4, 1e-2
# the Slam decoder's (K, N) projection shapes: q/o 896x896, k/v 896x128,
# up/gate 896x4864, down 4864x896
SLAM_KN = ((896, 896), (896, 128), (896, 4864), (4864, 896))
# the same projections split over 'model' = 2 (tensor parallelism,
# slamkit_tpu_torch/parallel/tensor.py): up/gate's columns, down's rows
TP2_SLAM_KN = ((896, 2432), (2432, 896))
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
# ... its float32 rate outside the tensor cores (NVIDIA data sheet, SXM), and
# the float32 rate of 3xTF32 on the tensor cores: three TF32 products (495
# TFLOP/s dense) for each float32 one, which holds every float32 bound of
# phases 3e, 3f, 12 and 13 (tests/test_torch_tf32_split.py emulates it). The
# float32 flash kernels' bound is their FLOPs at the 3xTF32 rate; the
# CUDA-core bound (the basis of the CUDA-core kernels' shares) is printed
# beside it
FP32_FLOPS_PER_S = 67e12
FP32_3XTF32_FLOPS_PER_S = 495e12 / 3
# phase 14, k-means on the card against the CPU: on clusters that Lloyd's
# resolves exactly (see `_cluster_memmap`) both fits take the same rows into
# each centroid and differ only in the order of their float32 sums (~1e-7 a
# term over ~130 rows a cluster): max |card - cpu| / max |cpu| <= 1e-5
KMEANS_REL_BOUND = 1e-5
# phase 15 (f), Adafactor on the card against the CPU on the same parameters
# and gradients: float32 on both, the row / column means, the global norm and
# each parameter's RMS summed in another order (~1e-7 relative each). An
# update of ~1e-3 x rms(p) a step lands on p rounded to p's float32 ulp, so
# a rounding flip moves the two runs' parameters apart by ~eps32 |p| (~1e-4
# of the updates themselves). Each tensor's max |card - cpu| must stay
# within 1e-5 of its largest update plus one eps32 of its largest entry a
# step (a wrong axis or factor would sit near the updates' size)
ADAFACTOR_REL_BOUND = 1e-5
# the slice's overrides of `cli.train model=slam` (phase 15)
SETTINGS = ("model.config_args.dropout=0.1", "model.config_args.layerdrop=0.1",
            "model.config_args.remat=true", "model.config_args.remat_policy=qkv",
            "training_args.optim=adafactor")
# phase 16 (e)'s asr_perplexity models on the card: whisper-large-v3-turbo
# (encoder cut from 32 layers) and Llama-3.2-1B (cut from 16) at their
# published widths, the text LM's heads of 64 as llama1b_f32's
ASR_ENCODER_LAYERS, TEXT_LM_LAYERS = 4, 4
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


def _drop(*dirs):
    """Delete a phase's checkpoint directories once its checks are done and
    no later phase reads them, and print the disk's use before and after:
    every full-depth save is 4-6 GB, and kept to the end of the run they
    would pass 60 GiB, where one phase's at a time stay under 30 GiB."""
    import shutil

    disk = pathlib.Path(dirs[0]).parent
    used = shutil.disk_usage(disk).used
    for d in dirs:
        shutil.rmtree(d)
    print(f"disk: {used / 2**30:.1f} GiB used, {shutil.disk_usage(disk).used / 2**30:.1f} "
          f"GiB after dropping {', '.join(pathlib.Path(d).name for d in dirs)}", flush=True)


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


def _wide_head_cases(rng, with_causal: bool = False) -> list:
    """Phases 3, 3b, 3e and 3f at the head dims that run on the d = 256
    kernels, which no shipped config reaches: d = 256 itself and d = 160
    (zero-padded to 256), [4, 8/2, 1024, d], 4 packed segments and a -1
    tail, causal and not. Forward cases carry their causal flag in the
    tuple's third place (`with_causal`), backward ones last."""
    cases = []
    for d in (256, 160):
        for causal in (True, False):
            name = f"d{d}" + ("" if causal else "_noncausal")
            seg = _packed_segments(rng, 4, 1024, 4)
            cases.append((name, (4, 8, 2, 1024, d), causal, seg) if with_causal
                         else (name, (4, 8, 2, 1024, d), seg, causal))
    return cases


def bound_ms(n_bytes: float, flops: float, flops_per_s: float = BF16_FLOPS_PER_S
             ) -> tuple[float, str]:
    """The least time the card could take (ms) and what sets it: the bytes
    moved (each input read once, each output written once) over the memory
    rate, or the operations over the rate of their type (the bf16 tensor-core
    rate unless `flops_per_s` names another: FP32_3XTF32_FLOPS_PER_S for
    float32)."""
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


def _cores_text(cores_bound) -> str:
    """The float32 kernels' bound at the CUDA-core rate, beside the 3xTF32 one."""
    return "" if cores_bound is None else f" (at 67 TFLOP/s of CUDA cores {cores_bound:.4f} ms)"


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


def shape_entry(at: dict) -> dict:
    """A forward case's times from its phase-3 / 3e row `at`, under the
    kernels line's names: a second shape of an entry's kernel."""
    return {"shape": at["shape"], "ms": at["ms"], "plain_ms": at["plain_ms"],
            "graph_ms": at["device_ms"], "plain_graph_ms": at["plain_device_ms"],
            "bound_ms": at["bound_ms"], "bound_by": at["bound_by"],
            "cuda_core_bound_ms": at["cuda_core_bound_ms"], "library_ms": at["library_ms"],
            "library_timed": at["library"], "roofline_share": at["roofline_share"],
            "vs_library": at["vs_library"], "max_abs_err": at["max_abs_err_out"]}


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
    its bound taking the operations at the float32 rate of 3xTF32. Among
    them, phase 12's own shapes: a scoring batch (8 transcripts of ~1700-3530
    tokens, padded right to a multiple of 64 with a -1 tail, as
    log_likelihood pads them) and a judge prefill (8 instructions of
    ~5700-7680 tokens, left-padded as judge_text pads them), and phase 13's
    training batches (OPT-125m's 12/12 heads at 512, the Slam batch)."""
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
        ("twist_f32", (8, 12, 12, 512, 64), True, _packed_segments(rng, 8, 512, 4)),
        ("slam_f32", (8, 14, 2, 1024, 64), True, _packed_segments(rng, 8, 1024, 8)),
        ("pythia14m_sims", (8, 4, 4, 2048, 32), True, _mixed_segments(rng, 8, 2048)),
        ("d80", (4, 8, 2, 1024, 80), True, _packed_segments(rng, 4, 1024, 4)),
        ("sims_f32", (4, 14, 2, 2048, 64), True, _mixed_segments(rng, 4, 2048)),
        *_wide_head_cases(rng, with_causal=True),
        ("tp2_slam_f32", (10, 7, 1, 1024, 64), True, _right_padded(rng, 10, 1024, lo=100)),
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
        ("pythia14m_sims", (8, 4, 4, 2048, 32), True, _mixed_segments(rng, 8, 2048)),
        ("d80", (4, 8, 2, 1024, 80), True, _packed_segments(rng, 4, 1024, 4)),
        *_wide_head_cases(rng, with_causal=True),
        ("tp2_slam", (8, 7, 1, 1024, 64), True, _packed_segments(rng, 8, 1024, 8)),
        ("tp4_sims7b", (2, 7, 1, 2048, 128), True, _mixed_segments(rng, 2, 2048)),
        ("tp2_sims7b", (2, 14, 2, 2048, 128), True, _mixed_segments(rng, 2, 2048)),
        ("fsdp4_sims7b", (2, 28, 4, 2048, 128), True, _mixed_segments(rng, 2, 2048)),
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
        bound, bound_by = bound_ms(*cost, flops_per_s=FP32_3XTF32_FLOPS_PER_S if f32
                                   else BF16_FLOPS_PER_S)
        cores_bound = bound_ms(*cost, flops_per_s=FP32_FLOPS_PER_S)[0] if f32 else None
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
                            cuda_core_bound_ms=cores_bound, vs_library=vs_library,
                            tflops=tflops, ok=ok))
        print(f"kernel{' f32' if f32 else ''} {name:16s} [{b},{h}/{hkv},{t},{d}] "
              f"causal={causal}: |dout|={err_out:.3e} (<= {out_bound}) |dlse|={err_lse:.3e} "
              f"(<= {lse_bound}) dead={n_dead} dead_ok={dead_ok} bitwise-repeatable="
              f"{deterministic}  eager: kernel {ms:.4f} ms plain {plain_ms:.4f} ms; graph: "
              f"kernel {device_ms:.4f} ms ({tflops:.1f} TFLOP/s) plain "
              f"{f'{plain_device_ms:.4f} ms' if chunks == 1 else f'not captured ({chunks} chunks)'} "
              f"{_library_text(library_ms, timed, vs_library)}; bound {bound:.4f} ms by "
              f"{bound_by}{_cores_text(cores_bound)}, roofline_share {share:.3f}  "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        _require(ok, f"the {dtype} flash kernel disagrees with the plain version at {name}")
    return results


def _grad_errors(got, want, f32_terms: int = 0) -> list[tuple]:
    """(name, max |kernel - plain|, its bound, worst row's error over its
    row bound) for each of dq, dk, dv; the last must be <= 1. With
    `f32_terms` (G T: the float32 kernel) the bound is F32_BWD_FACTOR eps32
    sqrt(G T) of max |plain| and the row check is left out (0)."""
    rows = []
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        diff = a.float() - w
        top = w.abs().max().item()
        if f32_terms:
            rows.append((name, diff.abs().max().item(),
                         F32_BWD_FACTOR * F32_EPS * math.sqrt(f32_terms) * top, 0.0))
            continue
        row_bound = BWD_ROW_RTOL * w.norm(dim=-1) + BWD_ROW_ATOL
        rows.append((name, diff.abs().max().item(), BWD_REL_BOUND * top + 1e-5,
                     (diff.norm(dim=-1) / row_bound).max().item()))
    return rows


def _sdpa_backward_ms(q, k, v, do, seg, kv_seg, causal: bool = True):
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
        sdpa = _sdpa_library(qg, kg, vg, seg, kv_seg, causal)
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


def check_backward_kernels(dev, f32: bool = False) -> list[dict]:
    """Phase 3b: the backward kernel against the plain backward at the
    training shapes: the Slam batch (8 packed segments and a -1 tail), a
    ragged T, d = 128 (config/model/slam_dh128.yaml, which phase 18 trains),
    the SIMS context 2048 (config/train_inter_scale.yaml), dead rows, and
    DPO's [2 x 8, 152] batch (one segment of 110-152 tokens a row, then a -1
    tail), and SIMS's rows packed from segments of mixed length, at the
    Slam heads and at Qwen2.5's heads of 128 (7B's split by tensor
    parallelism and fsdp; 3B's 16 / 2, G = 8). Phase 3f (`f32`): the float32
    backward (flash_bwd_f32.cu) against the same plain version on float32
    inputs at phase 13's shapes: train.yaml's default model (OPT-125m, 12/12
    heads, G = 1, context 512), the Slam batch (G = 7), slam_dh128, a ragged
    T, DPO's rows and dead rows; its bound takes the operations at the
    float32 rate of 3xTF32."""
    import torch

    from slamkit_tpu_torch.ops import flash_attention_bwd, flash_attention_fwd, mha_reference_bwd

    rng = np.random.default_rng(13 if f32 else 2)
    cases = [
        ("twist_f32", (8, 12, 12, 512, 64), _packed_segments(rng, 8, 512, 4)),
        ("slam_f32", (8, 14, 2, 1024, 64), _packed_segments(rng, 8, 1024, 8)),
        ("d128_f32", (8, 7, 1, 1024, 128), _packed_segments(rng, 8, 1024, 8)),
        ("odd_T1000", (8, 14, 2, 1000, 64), _packed_segments(rng, 8, 1000, 8)),
        ("dpo_f32", (16, 14, 2, 152, 64), _right_padded(rng, 16, 152, lo=110)),
        ("dead_rows", (2, 14, 2, 256, 64), None),
        ("pythia14m_sims", (8, 4, 4, 2048, 32), _mixed_segments(rng, 8, 2048)),
        ("d80", (4, 8, 2, 1024, 80), _packed_segments(rng, 4, 1024, 4)),
        ("sims_f32", (4, 14, 2, 2048, 64), _mixed_segments(rng, 4, 2048)),
        *_wide_head_cases(rng),
    ] if f32 else [
        ("slam_ctx1024", (8, 14, 2, 1024, 64), _packed_segments(rng, 8, 1024, 8)),
        ("odd_T1000", (8, 14, 2, 1000, 64), _packed_segments(rng, 8, 1000, 8)),
        ("d128_ctx1024", (8, 7, 1, 1024, 128), _packed_segments(rng, 8, 1024, 8)),
        ("sims_ctx2048", (4, 14, 2, 2048, 64), _packed_segments(rng, 4, 2048, 8)),
        ("dead_rows", (2, 14, 2, 256, 64), None),
        ("dpo_T152", (16, 14, 2, 152, 64), _right_padded(rng, 16, 152, lo=110)),
        ("sims_T2048", (4, 14, 2, 2048, 64), _mixed_segments(rng, 4, 2048)),
        ("pythia14m_sims", (8, 4, 4, 2048, 32), _mixed_segments(rng, 8, 2048)),
        ("d80", (4, 8, 2, 1024, 80), _packed_segments(rng, 4, 1024, 4)),
        *_wide_head_cases(rng),
        ("tp2_slam", (8, 7, 1, 1024, 64), _packed_segments(rng, 8, 1024, 8)),
        ("tp4_sims7b", (2, 7, 1, 2048, 128), _mixed_segments(rng, 2, 2048)),
        ("tp2_sims7b", (2, 14, 2, 2048, 128), _mixed_segments(rng, 2, 2048)),
        ("fsdp4_sims7b", (2, 28, 4, 2048, 128), _mixed_segments(rng, 2, 2048)),
        ("qwen25_3b_sims", (4, 16, 2, 2048, 128), _mixed_segments(rng, 4, 2048)),
    ]
    dtype, counter = (torch.float32, "f32_launches") if f32 else (torch.bfloat16, "launches")
    results = []
    for name, (b, h, hkv, t, d), seg, *flags in cases:
        causal = flags[0] if flags else True
        g = torch.Generator(device=dev).manual_seed((200 if f32 else 100) + len(results))
        mk = lambda hh: torch.randn((b, hh, t, d), generator=g, device=dev).to(dtype)
        q, k, v, do = mk(h), mk(hkv), mk(hkv), mk(h)
        kv_seg = None
        if seg is None:   # query ids 7 never appear among the keys: dead rows
            seg = np.zeros((b, t), np.int32)
            seg[:, 100:140] = 7
            kv_seg = torch.zeros((b, t), dtype=torch.int32, device=dev)
        cost = flash_cost((b, h, hkv, t, d), seg, None if kv_seg is None
                          else kv_seg.cpu().numpy(), causal, backward=True,
                          elt_bytes=4 if f32 else 2)
        bound, bound_by = bound_ms(*cost, flops_per_s=FP32_3XTF32_FLOPS_PER_S if f32
                                   else BF16_FLOPS_PER_S)
        cores_bound = bound_ms(*cost, flops_per_s=FP32_FLOPS_PER_S)[0] if f32 else None
        seg = torch.from_numpy(seg).to(dev)
        out, lse = flash_attention_fwd(q, k, v, segment_ids=seg, kv_segment_ids=kv_seg,
                                       causal=causal)
        run = lambda: flash_attention_bwd(q, k, v, out, lse, do, segment_ids=seg,
                                          kv_segment_ids=kv_seg, causal=causal)
        plain = lambda: mha_reference_bwd(q.float(), k.float(), v.float(), seg, kv_seg,
                                          out.float(), lse, do.float(), causal=causal)
        before = getattr(flash_attention_bwd, counter)
        got = run()
        _require(getattr(flash_attention_bwd, counter) == before + 1
                 and all(x.dtype == dtype for x in got),
                 f"a {dtype} backward call did not launch its kernel or returned "
                 f"{[x.dtype for x in got]}")
        want = plain()
        torch.cuda.synchronize()
        errs = _grad_errors(got, want, f32_terms=(h // hkv) * t if f32 else 0)
        dead_ok = True
        if name == "dead_rows":
            dead_ok = bool((got[0][:, :, 100:140] == 0).all().item())
        ms = _cuda_ms(run, warmup=3, iters=20)
        plain_ms = _cuda_ms(plain, warmup=1, iters=3)
        device_ms, plain_device_ms = _graph_ms(run, 20), _graph_ms(plain, 2)
        again = run()
        deterministic = all(torch.equal(x, y) for x, y in zip(got, again))
        library_ms, timed = _sdpa_backward_ms(q, k, v, do, seg, kv_seg, causal)
        share, vs_library = _ratios(device_ms, bound, library_ms)
        ok = all(e <= bd and row <= 1 for _, e, bd, row in errs) and dead_ok and all(
            bool(torch.isfinite(x).all().item()) for x in got) and deterministic
        tflops = cost[1] / device_ms / 1e9
        results.append(dict(name=name, shape=[b, h, hkv, t, d], causal=causal,
                            dtype=str(dtype)[6:], max_abs_err={n: e for n, e, _, _ in errs},
                            bound={n: bd for n, _, bd, _ in errs},
                            worst_row_over_bound={n: r for n, _, _, r in errs},
                            deterministic=deterministic,
                            ms=ms, plain_ms=plain_ms, device_ms=device_ms,
                            plain_device_ms=plain_device_ms, library_ms=library_ms,
                            library=timed, bound_ms=bound, bound_by=bound_by,
                            roofline_share=share, cuda_core_bound_ms=cores_bound,
                            vs_library=vs_library, tflops=tflops, ok=ok))
        print(f"backward{' f32' if f32 else ''} {name:14s} [{b},{h}/{hkv},{t},{d}]"
              f"{'' if causal else ' causal=False'}: "
              + " ".join(f"|{n}|={e:.3e} (<= {bd:.3e})" + ("" if f32 else
                                                          f" row {r:.3f} (<= 1)")
                         for n, e, bd, r in errs)
              + f" dead_ok={dead_ok} bitwise-repeatable={deterministic}  eager: kernel "
              f"{ms:.4f} ms plain {plain_ms:.4f} ms; graph: kernel {device_ms:.4f} ms "
              f"({tflops:.1f} TFLOP/s) plain "
              f"{plain_device_ms:.4f} ms {_library_text(library_ms, timed, vs_library)}; "
              f"bound {bound:.4f} ms by {bound_by}{_cores_text(cores_bound)}, "
              f"roofline_share {share:.3f}  {'ok' if ok else 'FAIL'}", flush=True)
        del got, want, again
        _require(ok, f"the {dtype} flash backward kernel disagrees with the plain version "
                 f"at {name}")
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
    decoder's four (K, N) pairs and the two that 'model' = 2 splits them to
    (`TP2_SLAM_KN`), for the decode rows (M = 8, the smoke's
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
        for k, n in SLAM_KN + TP2_SLAM_KN:
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
    _drop(work / "run", work / "resumed")
    return result


def check_card_vs_cpu(dev, work: pathlib.Path, cfg=None, batch=2, context=256,
                      tokens: pathlib.Path = None) -> dict:
    """Phase 7: one packed microbatch of `tokens` (phase 6's tokens.jsonl by
    default), loss and gradients in bf16 on the card against float32 on the
    CPU from the same weights."""
    import torch

    from slamkit_tpu_torch.data import Batcher, parse_single_dataset
    from slamkit_tpu_torch.models import UnitLM, grads_to_flat
    from slamkit_tpu_torch.tokeniser import UnitTokeniser
    from slamkit_tpu_torch.tools.slam_recipe import slam_config

    ds = parse_single_dataset({"data": {}, "model": {"context_len": context}},
                              UnitTokeniser(), str(tokens or work / "tokens.jsonl"))["train"]
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
    _drop(work / "card_vs_cpu")
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


def write_pairs(folder: pathlib.Path, n_pairs: int, seconds=(1.0, 3.0), seed: int = 9,
                sep: str = "+") -> str:
    """An sBLIMP layout of n_pairs seeded 16 kHz WAV pairs, `<i>+<p|n>.wav`
    in one folder (metric.subfolder=false), each a gliding tone in noise of
    a length drawn from `seconds`; `sep="_"` gives sWUGGY's and
    StoryCloze's `<i>_<p|n>.wav`."""
    from slamkit_tpu_torch.utils.audio import save_wav

    rng = np.random.default_rng(seed)
    folder.mkdir(parents=True, exist_ok=True)
    for i in range(2 * n_pairs):
        save_wav(str(folder / f"{i}{sep}{'pn'[i % 2]}.wav"), _tone(rng, rng.uniform(*seconds)))
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
    _drop(out, work / "dpo_resumed")
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
    against float32 on the CPU; `cli.eval metric=sblimp` with
    `used_token_modality=SPEECH` (a -inf pad logit that the masked NLL must
    drop), every log-likelihood finite; `cli.eval metric=cm_generate` TEXT->SPEECH
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

    # ---- cli.eval metric=sblimp used_token_modality=SPEECH ----------------------
    # every text id but bos / eos, the pad among them, gets a -inf logit: a
    # pad target's NLL is +inf, which the masked sum must drop, not turn NaN
    cm_calls = len(calls)
    calls.clear()
    UnitLM.log_likelihood = recorded
    flash_attention_fwd.launches = 0                                    # the main path's count
    try:
        t0 = time.perf_counter()
        res = cli_eval.eval_main(common + ["metric=sblimp", f"metric.data_path={work / 'sblimp'}",
                                           "metric.subfolder=false",
                                           "metric.used_token_modality=SPEECH"])
        speech_s = time.perf_counter() - t0
    finally:
        UnitLM.log_likelihood = score
    speech_launches, speech_sblimp = flash_attention_fwd.launches, res["sBLIMP"]
    speech_finite = all(np.isfinite(ll).all() for _, ll, _ in calls)
    print(f"cli.eval metric=sblimp used_token_modality=SPEECH: sBLIMP {speech_sblimp}, "
          f"{len(calls)} scoring calls, every log-likelihood finite: {speech_finite}, "
          f"{speech_s:.1f} s with the loads, launches {speech_launches} on {smi}", flush=True)
    _require(speech_finite and calls and 0.0 <= speech_sblimp <= 1.0,
             f"sblimp with used_token_modality=SPEECH scored {res}")
    _require(speech_launches == (len(calls) * n_layers if on_card else 0),
             f"sblimp launched the flash forward {speech_launches} times, not "
             f"{len(calls) * n_layers if on_card else 0}")

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
    _drop(out)
    return dict(vocab=vocab, params=n_params, stage2_lines=n_lines, stage2_seconds=stage2_s,
                stage2_mixed=mixed, mixed_rows=n_rows_mixed, losses=losses,
                first_step_seconds=first_s, step_seconds=step_s, tokens_a_step=seen["tokens"], tokens_per_s=tokens_per_s,
                train_seconds=train_s, train_launches=train_launches,
                launches_per_step=seen["launches"], expected_launches=want,
                max_memory_allocated=peak_mem, storycloze=storycloze,
                cm_calls=cm_calls, cm_widths=widths, cm_seconds=cm_s,
                cm_launches=cm_launches, card_vs_cpu_ll_err=ll_err,
                speech_sblimp=speech_sblimp, speech_sblimp_calls=len(calls),
                speech_sblimp_seconds=speech_s, speech_sblimp_launches=speech_launches,
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
    LM at their widths, cut in depth to `GENPPL_DEPTHS` (random F16
    weights; `tiny` for the CPU rehearsal's widths), then
    `cli.eval metric=asr_perplexity` and `metric=llm_as_judge` (alignment
    prompts) run over `n_files` of phase 9's WAVs with vocoder_hubert_25 at
    phase 8's CodeHiFiGAN widths, each stage timed. On the card every
    generate call launches the bf16 forward once per SLM layer (its
    prefill), every text-LM scoring call and every judge prefill the float32
    forward once per text-LM layer; the last float32 launch of each run (the
    last layer of a scoring batch, of a judge prefill) is held against the
    plain version and float64 on its own q, k, v, and the first
    GENPPL_CPU_CHARS characters of a transcript of the first scoring batch
    and one Whisper window against float32 CPU runs.
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
    whisper_dir = genppl_recipe.write_whisper_dir(
        root / "whisper", tiny=tiny, encoder_layers=None if tiny else GENPPL_DEPTHS[0])
    llama_dir = genppl_recipe.write_llama_dir(root / "llama", tiny=tiny,
                                              num_layers=None if tiny else GENPPL_DEPTHS[1])
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
    # text LM: the start of the shortest transcript of the first scoring
    # batch (the CPU's float32 forward is the slow side), through the card's
    # model and a CPU one
    t0 = time.perf_counter()
    texts = [min(score_texts, key=len)[:GENPPL_CPU_CHARS]]
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
    print(f"text LM card vs float32 CPU on the start of {len(texts)} transcript "
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
    _drop(whisper_dir, llama_dir)
    phase_s = time.perf_counter() - phase_start
    print(f"phase 12: {phase_s:.1f} s in all", flush=True)
    return dict(write_seconds=write_s, dir_bytes=list(sizes.values()), runs=runs,
                seconds=phase_s, f32_held=held, card_vs_cpu_logit_rel_err=logit_err,
                card_vs_cpu_logp_err=logp_err, lm_check_seconds=lm_check_s,
                whisper_encoder_rel_err=enc_err,
                whisper_logit_rel_err=step_err, whisper_tokens_equal=same)


def _bytes_equal(a: pathlib.Path, b: pathlib.Path) -> bool:
    """Whether two checkpoints' exported parameters (params.npz) are bitwise
    equal."""
    with np.load(a / "params.npz") as x, np.load(b / "params.npz") as y:
        return sorted(x.files) == sorted(y.files) and all(
            x[k].dtype == y[k].dtype and x[k].tobytes() == y[k].tobytes() for k in x.files)


def _f32_card_vs_cpu(dev, ckpt: pathlib.Path, batch: dict) -> dict:
    """Phase 13 (c): one microbatch's loss and every parameter gradient from
    checkpoint `ckpt` in float32 on the card against float32 on the CPU. The
    card's ReLU masks are recorded, in call order, and the CPU's ReLUs take
    them (see F32_GRAD_REL_BOUND); the pre-activations whose sign differs
    are counted."""
    import torch
    import torch.nn.functional as F

    from slamkit_tpu_torch.models import UnitLM, grads_to_flat

    relu, masks, flips = F.relu, [], [0]

    def recording(x, inplace=False):
        masks.append((x > 0).cpu())
        return relu(x)

    def replaying(x, inplace=False):
        mask = masks.pop(0)
        flips[0] += int(((x > 0) != mask).sum())
        return torch.where(mask, x, torch.zeros((), dtype=x.dtype))

    got = {}
    for where, patch in ((dev, recording), (torch.device("cpu"), replaying)):
        lm = UnitLM.from_pretrained(str(ckpt), device=where, torch_dtype="float32",
                                    remat=False)
        F.relu = patch
        try:
            loss = lm.loss_fn({k: torch.from_numpy(v).to(where) for k, v in batch.items()})
            loss.backward()
        finally:
            F.relu = relu
        got[where.type] = (loss.item(), grads_to_flat(lm.decoder))
        del lm, loss
    _require(not masks, f"{len(masks)} ReLU masks of the card were not replayed")
    (loss_card, card), (loss_cpu, cpu) = got[dev.type], got["cpu"]
    top = max(float(np.abs(w).max()) for w in cpu.values())
    rel = {k: float(np.abs(card[k].astype(np.float64) - w).max()
                    / max(float(np.abs(w).max()), F32_GRAD_FLOOR * top)) for k, w in cpu.items()}
    worst = max(rel, key=rel.get)
    loss_rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
    shape = list(batch["input_ids"].shape)
    top3 = sorted(rel.items(), key=lambda kv: -kv[1])[:3]
    print(f"float32 card vs CPU on one {shape} microbatch of {ckpt.parent.name}: loss "
          f"{loss_card} vs {loss_cpu}, relative {loss_rel:.3e} (<= {F32_LOSS_REL_BOUND}); "
          f"largest relative gradient errors {', '.join(f'{k} {v:.3e}' for k, v in top3)} "
          f"(<= {F32_GRAD_REL_BOUND}) over {len(rel)} tensors; ReLU pre-activations of "
          f"another sign on the CPU: {flips[0]}", flush=True)
    _require(loss_rel <= F32_LOSS_REL_BOUND, "the card's float32 loss disagrees with the CPU's")
    _require(rel[worst] <= F32_GRAD_REL_BOUND, f"the float32 gradient of {worst} disagrees "
             f"with the CPU's (relative error {rel[worst]})")
    return dict(shape=shape, loss_card=loss_card, loss_cpu=loss_cpu, loss_rel_err=loss_rel,
                max_grad_rel_err=rel[worst], max_grad_rel_err_tensor=worst,
                relu_sign_flips=flips[0])


def _free(dev):
    import gc

    import torch

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _cli_run(dev, main, cls, args, tokens, counters) -> dict:
    """One entry point's call (`main(args)`) with `cls._train_step` timed:
    per step the seconds between two synchronizes, the launches read from
    `counters` ((function, attribute) pairs, zeroed before the call: the
    main path's count) and `tokens(trainer, group)`; the call's wall
    seconds, state, peak memory (with what was allocated before the call,
    which earlier phases may leave) and its trainer's facts."""
    import torch

    from slamkit_tpu_torch.trainer import SLAMTrainer

    on_card = dev.type == "cuda"
    counts = lambda: tuple(getattr(f, c) for f, c in counters)
    rec = dict(seconds=[], step_launches=[], tokens=[])
    inner = cls._train_step

    def step(tr, group):
        rec["trainer"] = tr
        _sync(dev)
        c0, t0 = counts(), time.perf_counter()
        out = inner(tr, group)
        _sync(dev)
        rec["seconds"].append(time.perf_counter() - t0)
        rec["step_launches"].append(tuple(b - a for a, b in zip(c0, counts())))
        rec["tokens"].append(tokens(tr, group))
        return out

    print(f"{main.__module__.rsplit('.', 1)[-1]} {' '.join(args)}", flush=True)
    _free(dev)
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev) if on_card else None
    cls._train_step = step
    for f, c in counters:   # the main path's count
        setattr(f, c, 0)
    try:
        t0 = time.perf_counter()
        with _LogLines("slamkit_tpu_torch.models.hf_convert") as twist_log:
            state = main(args)
        _sync(dev)
    finally:
        cls._train_step = inner
    tr = rec.pop("trainer")
    dcfg = tr.model.decoder.cfg
    rec.update(state=state, launches=counts(), wall_s=time.perf_counter() - t0,
               n_layers=dcfg.num_layers, remat=bool(dcfg.remat),
               remat_policy=dcfg.remat_policy, dtype=str(dcfg.compute_dtype)[6:],
               twist=twist_log[:1], optimizer=tr.optimizer.kind,
               max_memory_allocated=torch.cuda.max_memory_allocated(dev) if on_card else None,
               allocated_before=before,
               tokens_per_s=[n / t for n, t in zip(rec["tokens"], rec["seconds"])])
    if isinstance(tr, SLAMTrainer):
        rec["eval_batches"] = (len(list(tr.eval_batcher.epoch(0)))
                               if tr.eval_batcher is not None else 0)
        rec["first_microbatch"] = next(iter(tr.train_batcher.epoch(0)))
    else:
        rec["eval_batches"] = -(-len(tr.eval_rows) // tr.batch_size) if tr.eval_rows else 0
    del tr
    _free(dev)
    return rec


def run_f32_training(dev, smi: str, work: pathlib.Path, twist_overrides=(), slam_overrides=(),
                     n_rows: int = 400, lengths=(100, 1001), batch: int = 8, accum: int = 4,
                     steps: int = 2, cpu_rows=(2, 1), n_pref: int = 64, n_pref_val: int = 16,
                     dpo_batch: int = 8, dpo_steps: int = 4, prompt_len: int = 100,
                     completion_len: int = 50) -> dict:
    """Phase 13: float32 training through the command line. (a) `cli.train`
    with train.yaml's defaults (model=twist: OPT-125m, context 512, no
    remat) and model.config_args.torch_dtype=float32, `steps` steps of
    `accum` x `batch` on phase 9's Markov corpus with a save every step, then
    a run resumed from checkpoint-1 whose last loss, final eval loss and
    exported weights equal the uninterrupted run's bit for bit; (b) the same
    with model=slam and full remat; (c) the first `cpu_rows` rows of each
    run's first microbatch on the card against float32 on the CPU, from its
    last checkpoint; (d) `cli.preference_alignment_train` in float32 from
    (b)'s last checkpoint (dpo_training_args, `dpo_steps` steps of 2 x
    `dpo_batch` rows, a save a step before the end, step 1 at ln 2) and a
    run resumed from that save, exact as above. Params, gradients, AdamW
    moments and compute are float32. On the card every training microbatch
    launches the float32 forward (1 + remat) x layers times and the float32
    backward once a layer, every DPO step the forward (2 + remat) x layers
    times and the backward once a layer, every evaluation batch the forward
    once a layer (DPO: twice), and the bf16 kernels never; on the CPU (a
    rehearsal at narrow widths, `*_overrides`) no launch may be counted."""
    from slamkit_tpu_torch.cli import preference_alignment_train as cli_dpo
    from slamkit_tpu_torch.cli import train as cli_train
    from slamkit_tpu_torch.ops import flash_attention_bwd, flash_attention_fwd
    from slamkit_tpu_torch.tools.slam_recipe import write_markov_corpus, write_preference_rows
    from slamkit_tpu_torch.trainer import SLAMDPOTrainer, SLAMTrainer
    from slamkit_tpu_torch.trainer.slam_trainer import BATCH_KEYS

    on_card = dev.type == "cuda"
    counters = ((flash_attention_fwd, "f32_launches"), (flash_attention_bwd, "f32_launches"),
                (flash_attention_fwd, "launches"), (flash_attention_bwd, "launches"))
    free = lambda: _free(dev)
    cli_run = lambda main, cls, args, tokens: _cli_run(dev, main, cls, args, tokens, counters)

    def logged(state, key):
        return [r[key] for r in state.log_history if key in r]

    def check_run(what, rec, last, n_steps, per_step, per_eval):
        """The run took `n_steps` finite steps up to step `last`, each
        launching `per_step` (float32 forward, float32 backward), and
        `per_eval` forwards an eval batch: nothing else, and no bf16 kernel."""
        state, eval_b = rec["state"], rec["eval_batches"]
        want_step = per_step + (0, 0) if on_card else (0, 0, 0, 0)
        want = ((n_steps * per_step[0] + eval_b * per_eval, n_steps * per_step[1], 0, 0)
                if on_card else (0, 0, 0, 0))
        losses = logged(state, "loss")
        print(f"{what}: {state.global_step} steps ({rec['dtype']}, {rec['n_layers']} layers, "
              f"remat {rec['remat']}), losses {losses}, eval {logged(state, 'eval_loss')}; "
              f"seconds a step {rec['seconds']}, non-pad tokens/s {rec['tokens_per_s']}, "
              f"{rec['wall_s']:.1f} s the whole call; launches (f32 fwd, f32 bwd, bf16 fwd, "
              f"bf16 bwd) {rec['launches']} (a step {rec['step_launches']}; expected {want}, "
              f"{eval_b} eval batches); max_memory_allocated {rec['max_memory_allocated']} B; "
              f"on {smi}", flush=True)
        _require(state.global_step == last and len(rec["seconds"]) == n_steps
                 and all(math.isfinite(x) for x in losses) and rec["dtype"] == "float32",
                 f"{what} did not take {n_steps} finite float32 steps: {losses}")
        _require(rec["launches"] == want and all(x == want_step for x in rec["step_launches"]),
                 f"{what} launched {rec['launches']} ({rec['step_launches']} a step), expected "
                 f"{want} ({want_step} a step)")
        return losses

    def check_resume(what, first, again, out, resumed, step):
        """The resumed run repeats the uninterrupted run's last step bit for
        bit: its loss, its final eval loss and checkpoint-`step`'s weights."""
        pairs = {k: (logged(first["state"], k)[-1:], logged(again["state"], k)[-1:])
                 for k in ("loss", "eval_loss")}
        same_w = _bytes_equal(out / f"checkpoint-{step}", resumed / f"checkpoint-{step}")
        print(f"{what} resumed: step {step} " + ", ".join(f"{k} {b} against {a}" for k, (a, b)
                                                        in pairs.items())
              + f"; checkpoint-{step} weights bitwise equal: {same_w}", flush=True)
        _require(all(a == b and a for a, b in pairs.values()) and same_w,
                 f"the resumed {what} run does not repeat step {step} bit for bit")
        return same_w

    # ---- (a) and (b): cli.train in float32, twist then slam ------------------
    train_path, val_path = work / "f32_tokens.jsonl", work / "f32_val.jsonl"
    write_markov_corpus(train_path, n_rows, lengths)        # phase 9's corpus
    write_markov_corpus(val_path, 16, lengths, seed=1)
    common = [f"data.train_path={train_path}", f"data.val_path={val_path}", "data.packing=true",
              "model.config_args.torch_dtype=float32", f"training_args.max_steps={steps}",
              f"training_args.per_device_train_batch_size={batch}",
              f"training_args.per_device_eval_batch_size={batch}",
              f"training_args.gradient_accumulation_steps={accum}",
              "training_args.save_steps=1", "training_args.logging_steps=1",
              *([] if on_card else ["training_args.use_cpu=true"])]
    nonpad = lambda tr, group: sum(int((mb["segment_ids"] >= 0).sum()) for mb in group)
    result, f32_launches = {}, [0, 0]
    for name, extra, rows in (("twist", list(twist_overrides), cpu_rows[0]),
                              ("slam", ["model=slam", "training_args.remat=true",
                                        *slam_overrides], cpu_rows[1])):
        out, resumed = work / f"f32_{name}", work / f"f32_{name}_resumed"
        first = cli_run(cli_train.train, SLAMTrainer,
                        [*extra, *common, f"training_args.output_dir={out}"], nonpad)
        L, fwd_mb = first["n_layers"], first["n_layers"] * (1 + first["remat"])
        losses = check_run(name, first, steps, steps, (accum * fwd_mb, accum * L), L)
        again = cli_run(cli_train.train, SLAMTrainer,
                        [*extra, *common, f"training_args.output_dir={resumed}",
                         f"cont_training={out / 'checkpoint-1'}"], nonpad)
        check_run(f"{name} resumed", again, steps, steps - 1, (accum * fwd_mb, accum * L), L)
        check_resume(name, first, again, out, resumed, steps)
        mb = first.pop("first_microbatch")
        again.pop("first_microbatch")
        check = _f32_card_vs_cpu(dev, out / f"checkpoint-{steps}",
                                 {k: mb[k][:rows] for k in BATCH_KEYS})
        for rec in (first, again):
            f32_launches[0] += rec["launches"][0]
            f32_launches[1] += rec["launches"][1]
        result[name] = dict(
            losses=losses, eval_loss=logged(first["state"], "eval_loss"),
            step_seconds=first["seconds"], tokens_per_s=first["tokens_per_s"],
            wall_s=first["wall_s"], resumed_wall_s=again["wall_s"], launches=first["launches"],
            resumed_launches=again["launches"], eval_batches=first["eval_batches"],
            max_memory_allocated=first["max_memory_allocated"], layers=L,
            remat=first["remat"], twist=first["twist"], card_vs_cpu=check)
        _drop(resumed, out / "checkpoint-1")
        if name == "twist":
            _drop(out)
        free()

    # ---- (d): DPO in float32 from (b)'s last checkpoint ----------------------
    pref_train, pref_val = work / "f32_pref_train.jsonl", work / "f32_pref_val.jsonl"
    write_preference_rows(pref_train, n_pref, prompt_len, completion_len)
    write_preference_rows(pref_val, n_pref_val, prompt_len, completion_len, seed=1)
    slam_ckpt = work / "f32_slam" / f"checkpoint-{steps}"
    dpo_common = [f"model.pretrained_model={slam_ckpt}", "model.config_args.torch_dtype=float32",
                  f"data.train_path={pref_train}", f"data.val_path={pref_val}",
                  f"training_args.max_steps={dpo_steps}",
                  f"training_args.save_steps={dpo_steps - 1}",
                  f"training_args.per_device_train_batch_size={dpo_batch}",
                  "training_args.logging_steps=1",
                  *([] if on_card else ["training_args.use_cpu=true"])]
    dpo_tokens = lambda tr, rows: int((tr._collate(rows)["segment_ids"] >= 0).sum())
    out, resumed = work / "f32_dpo", work / "f32_dpo_resumed"
    first = cli_run(cli_dpo.train, SLAMDPOTrainer,
                    [*dpo_common, f"training_args.output_dir={out}"], dpo_tokens)
    L = first["n_layers"]
    per_step = (L * (2 + first["remat"]), L)
    losses = check_run("dpo", first, dpo_steps, dpo_steps, per_step, 2 * L)
    _require(abs(losses[0] - math.log(2)) <= 1e-6, f"float32 DPO step 1's loss {losses[0]} is "
             f"not ln 2 within 1e-6 (the policy is the reference)")
    again = cli_run(cli_dpo.train, SLAMDPOTrainer,
                    [*dpo_common, f"training_args.output_dir={resumed}",
                     f"cont_training={out / f'checkpoint-{dpo_steps - 1}'}"], dpo_tokens)
    check_run("dpo resumed", again, dpo_steps, 1, per_step, 2 * L)
    check_resume("dpo", first, again, out, resumed, dpo_steps)
    for rec in (first, again):
        f32_launches[0] += rec["launches"][0]
        f32_launches[1] += rec["launches"][1]
    result["dpo"] = dict(losses=losses, eval_loss=logged(first["state"], "eval_loss"),
                         step_seconds=first["seconds"], tokens_per_s=first["tokens_per_s"],
                         wall_s=first["wall_s"], resumed_wall_s=again["wall_s"],
                         launches=first["launches"], resumed_launches=again["launches"],
                         eval_batches=first["eval_batches"],
                         max_memory_allocated=first["max_memory_allocated"], layers=L,
                         remat=first["remat"])
    _drop(out, resumed, work / "f32_slam")
    free()
    result["launches"] = {"flash_fwd_f32": f32_launches[0], "flash_bwd_f32": f32_launches[1]}
    return result


def _gxx_version() -> str:
    import shutil
    import subprocess

    gxx = shutil.which("g++")
    if gxx is None:
        return "absent"
    return subprocess.run([gxx, "--version"], capture_output=True, text=True).stdout.split("\n")[0]


def _libav_versions():
    """pkg-config's versions of the four libav libraries the decoder links,
    or None where pkg-config or one of them is missing."""
    import subprocess

    names = ("libavformat", "libavcodec", "libavutil", "libswresample")
    try:
        proc = subprocess.run(["pkg-config", "--modversion", *names], capture_output=True,
                              text=True)
    except FileNotFoundError:
        return None
    return dict(zip(names, proc.stdout.split())) if proc.returncode == 0 else None


def _rss() -> tuple:
    """(current, peak) resident set of the process in bytes: /proc/self/statm
    (None where it cannot be read) and getrusage's ru_maxrss (the peak since
    the process started: the card's machine offers no way to reset it)."""
    import os
    import resource

    try:
        current = int(pathlib.Path("/proc/self/statm").read_text().split()[1]) * os.sysconf(
            "SC_PAGE_SIZE")
    except (OSError, IndexError, ValueError):
        current = None
    return current, resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def _cluster_memmap(path: pathlib.Path, rows: int, dim: int, k: int, subset: int,
                    spread: float = 4.0, noise: float = 1.0, seed: int = 14):
    """A float32 np.memmap [rows, dim] of k seeded Gaussian clusters (centres
    ~spread x sqrt(2 dim) apart, noise per coordinate), the centres and the
    labels.
    The rows that `kmeans_fit(seed=0)`'s Forgy start draws, from the whole
    array and from its first `subset` rows, are labelled one to a cluster:
    Lloyd's then converges to the clusters' means, no row lies near a
    boundary, and a card and a CPU fit can differ only by summation order.
    (A start that split a cluster would put rows on a boundary, where a
    rounding flip moves a centroid by ~1e-3 of its norm.)"""
    rng = np.random.default_rng(seed)
    centres = (spread * rng.standard_normal((k, dim))).astype(np.float32)
    labels = rng.integers(0, k, rows)
    labels[np.random.default_rng(0).choice(rows, k, replace=False)] = np.arange(k)
    sub_picks = np.random.default_rng(0).choice(subset, k, replace=False)
    fixed = np.isin(sub_picks, np.random.default_rng(0).choice(rows, k, replace=False))
    free = np.setdiff1d(np.arange(k), labels[sub_picks[fixed]])
    labels[sub_picks[~fixed]] = free
    # one block of noise rows serves every block of labels (drawing 3.2 GB of
    # normals would take longer than the fits)
    block = min(rows, 1 << 16)
    draws = noise * rng.standard_normal((block, dim), dtype=np.float32)
    x = np.memmap(path, dtype=np.float32, mode="w+", shape=(rows, dim))
    for lo in range(0, rows, block):
        hi = min(lo + block, rows)
        x[lo:hi] = centres[labels[lo:hi]] + draws[:hi - lo]
    x.flush()
    del x
    return np.memmap(path, dtype=np.float32, mode="r", shape=(rows, dim)), centres, labels


def run_data_path(dev, smi: str, work: pathlib.Path, hubert_cfg=None, model_overrides=(),
                  n_files: int = 64, seconds=(2.0, 16.0), fit_rows: int = 1 << 20,
                  fit_dim: int = 768, k: int = 500, fit_iters: int = 25,
                  fit_batch: int = 1 << 16, subset_rows: int = 1 << 16, subset_iters: int = 5,
                  corpus_tokens: int = 8 << 20, spill_tokens: int = 2 << 20,
                  lengths=(100, 1001), context: int = 1024, batch: int = 8,
                  steps: int = 2) -> dict:
    """Phase 14, the data path, in a work directory of its own beside phase
    9's (whose HuBERT directory it reads):
    (a) the native builds: g++'s and libav's versions; the packer and the
        codec must load, and the audio decoder wherever libav is present;
        where it is absent, a line says so and FLAC is held only by the CPU
        tests (`tests/test_torch_audio.py`): FLAC must then raise, and (b)
        and (d) read the same PCM from WAV twins, said so on their lines;
    (b) `n_files` seeded files of `seconds`, 16 kHz mono and 44.1 kHz stereo
        (16-bit), decoded by `utils/audio.load_audio`: the 16 kHz ones equal
        PCM / 32768 bit for bit, the 44.1 kHz ones their WAV twins' decode,
        resampled to the 16 kHz length; decode and audio seconds;
    (c) `kmeans_fit` on the card, K = k over a seeded memmap of `fit_rows` x
        `fit_dim` float32 clusters, `fit_iters` iterations in `fit_batch`
        rows: a second fit repeats it bit for bit and both recover the
        clusters' centres; on the first `subset_rows` rows for `subset_iters`
        iterations the card matches a CPU fit within KMEANS_REL_BOUND;
        seconds and fitted rows a second; then k centroids fitted on the
        HuBERT features of (b)'s files, written as km.npy;
    (d) `cli.extract_features` with the YAML's default ext=flac and that
        km.npy over (b)'s files, every line held to a direct
        `audio_represent` of its batch, then `cli.prepare_tokens`;
    (e) two seeded corpora of `corpus_tokens` unit tokens, `cli.train`
        model=slam for `steps` steps on both mixed by data.train_ratios with
        data.spill_tokens=`spill_tokens` (each load and the mix spill to
        data.spill_dir) and a fresh data.saved_ds_path (written), then again
        from the cache: the two runs' batches and step-1 losses equal bit
        for bit, and the spilled batches equal an in-RAM build's;
        `init_dataset`'s host seconds with and without the cache, the
        process's resident set (current and peak) around each run, the disk. On the card every training microbatch
        launches the flash backward once a layer and the forward (1 + remat)
        times; on the CPU (a rehearsal at narrow widths) no launch."""
    import gc
    import shutil

    import torch

    from slamkit_tpu_torch.cli import extract_features as cli_extract
    from slamkit_tpu_torch.cli import prepare_tokens as cli_prepare
    from slamkit_tpu_torch.cli import train as cli_train
    from slamkit_tpu_torch.config import compose
    from slamkit_tpu_torch.data import dataset as data_mod
    from slamkit_tpu_torch.feature_extractor import (HUBERT_CONFIG_PRESETS, HubertConfig,
                                                     HubertFeatureExtractor, kmeans_fit,
                                                     save_kmeans_centroids)
    from slamkit_tpu_torch.feature_extractor.hubert import load_hubert
    from slamkit_tpu_torch.native import bindings, codec, pack
    from slamkit_tpu_torch.ops import flash_attention_bwd, flash_attention_fwd
    from slamkit_tpu_torch.tokeniser import tokeniser_factory
    from slamkit_tpu_torch.tools import data_recipe
    from slamkit_tpu_torch.trainer import slam_trainer
    from slamkit_tpu_torch.utils.audio import load_audio

    on_card = dev.type == "cuda"
    phase_t0 = time.perf_counter()
    hubert_cfg = hubert_cfg or HubertConfig(**HUBERT_CONFIG_PRESETS["slprl/mhubert-base-25hz"])
    data_work = work / "data_path"
    data_work.mkdir()
    result = {}

    # ---- (a) the native builds ----------------------------------------------
    versions = _libav_versions()
    for lib in (pack, codec):
        try:
            lib._lib()
        except lib.NativeUnavailable as e:
            raise SystemExit(f"chip_smoke: the native {lib.__name__} did not load: {e}")
    try:
        bindings._lib()
        flac, audio_error = True, None
    except bindings.NativeUnavailable as e:
        flac, audio_error = False, str(e).splitlines()[0]
    print(f"native: g++ {_gxx_version()}; libav {versions or 'absent (pkg-config finds none)'};"
          f" libpack and libcodec loaded; the audio decoder "
          f"{'loaded' if flac else f'did not build: {audio_error}'}", flush=True)
    _require(flac or versions is None, f"libav is present ({versions}) but the native audio "
             f"decoder did not build: {audio_error}")
    if not flac:
        print("libav: absent on this host, so the native audio decoder cannot be built here: "
              "FLAC decoding is held only by the CPU tests (tests/test_torch_audio.py); (b) "
              "and (d) below read the same PCM from WAV twins, not FLAC", flush=True)
    result["native"] = dict(gxx=_gxx_version(), libav=versions, audio_decoder=flac,
                            audio_error=audio_error)

    # ---- (b) decoding -------------------------------------------------------
    audio_dir = data_work / "audio"
    files = data_recipe.write_audio_set(audio_dir, n_files, seconds, seed=14,
                                        kinds=((16000, 1, 16), (44100, 2, 16)))
    if not flac:
        try:
            load_audio(str(files[0][0]))
            raise SystemExit("chip_smoke: FLAC decoded without the native decoder")
        except IOError as e:
            _require("libav" in str(e), f"FLAC without libav raised without naming it: {e}")
    t0 = time.perf_counter()
    decoded = [load_audio(str(f if flac else w)) for f, w, *_ in files]
    decode_s = time.perf_counter() - t0
    audio_s = sum(len(pcm) / sr for _, _, pcm, sr, _ in files)
    exact = resampled = 0
    for (f, w, pcm, sr, _), wav in zip(files, decoded):
        if sr == 16000:
            _require(np.array_equal(wav, (pcm[:, 0] / 32768.0).astype(np.float32)),
                     f"{f.name if flac else w.name} does not decode to its PCM / 32768")
            exact += 1
        else:
            _require(abs(len(wav) - len(pcm) * 16000 / sr) <= 1 and np.isfinite(wav).all(),
                     f"{f.name} decoded to {len(wav)} samples, not {len(pcm) * 16000 / sr:.0f}")
            if flac:
                _require(np.array_equal(wav, load_audio(str(w))), f"{f.name} and its WAV "
                         f"twin decode differently")
            resampled += 1
    print(f"(b) decoded {n_files} {'FLAC' if flac else 'WAV (libav absent)'} files, "
          f"{audio_s:.1f} s of audio in {decode_s:.3f} s ({decode_s / audio_s:.2e} s a second "
          f"of audio): {exact} at 16 kHz equal PCM / 32768 bit for bit, {resampled} at 44.1 "
          f"kHz stereo downmixed and resampled to 16 kHz{', equal to their WAV twins' if flac else ''}",
          flush=True)
    result["decode"] = dict(format="flac" if flac else "wav", files=n_files,
                            audio_seconds=audio_s, decode_seconds=decode_s)

    # ---- (c) fitting on the card --------------------------------------------
    t0 = time.perf_counter()
    x, centres, labels = _cluster_memmap(data_work / "fit.f32", fit_rows, fit_dim, k, subset_rows)
    make_s = time.perf_counter() - t0
    fits, fit_s = [], []
    for _ in range(2):
        _sync(dev)
        t0 = time.perf_counter()
        fits.append(kmeans_fit(x, k, iters=fit_iters, seed=0, batch=fit_batch, device=dev))
        _sync(dev)
        fit_s.append(time.perf_counter() - t0)
    counts = np.bincount(labels, minlength=k)
    centre_err = float(np.abs(fits[0] - centres).max())
    centre_bound = 8.0 / math.sqrt(counts.min())        # 8 sd of a cluster's mean (noise 1)
    repeat = bool(np.array_equal(fits[0], fits[1]))
    sub = np.asarray(x[:subset_rows])
    card_sub = kmeans_fit(sub, k, iters=subset_iters, seed=0, batch=fit_batch, device=dev)
    t0 = time.perf_counter()
    cpu_sub = kmeans_fit(sub, k, iters=subset_iters, seed=0, batch=fit_batch, device="cpu")
    cpu_s = time.perf_counter() - t0
    sub_err = float(np.abs(card_sub - cpu_sub).max() / np.abs(cpu_sub).max())
    rows_per_s = [fit_rows * fit_iters / s for s in fit_s]
    print(f"(c) kmeans_fit on {dev}: K={k} over a memmap of {fit_rows} x {fit_dim} float32 "
          f"({x.nbytes / 1e9:.2f} GB, made in {make_s:.1f} s), {fit_iters} iterations in batches "
          f"of {fit_batch}: {fit_s[0]:.3f} and {fit_s[1]:.3f} s ({rows_per_s[0]:.4g} and "
          f"{rows_per_s[1]:.4g} fitted rows/s); the second fit bitwise equal: {repeat}; max "
          f"|centroid - cluster centre| {centre_err:.3e} (<= {centre_bound:.3e}); on "
          f"{subset_rows} rows x {subset_iters} iterations the card against the CPU "
          f"({cpu_s:.2f} s): {sub_err:.3e} relative (<= {KMEANS_REL_BOUND}); on {smi}", flush=True)
    _require(repeat, "a second kmeans_fit did not repeat the first bit for bit")
    _require(centre_err <= centre_bound, "kmeans_fit did not recover the clusters' centres")
    _require(sub_err <= KMEANS_REL_BOUND, "kmeans_fit on the card disagrees with the CPU")
    del x, sub
    (data_work / "fit.f32").unlink()
    # k centroids on the HuBERT features of (b)'s files (phase 9's random HuBERT)
    params, cfg = load_hubert(str(work / "hubert"), "cpu")     # from_params moves them
    tap = hubert_cfg.num_hidden_layers - 1
    fe = HubertFeatureExtractor.from_params(params, cfg, np.zeros((k, cfg.hidden_size),
                                                                  np.float32), layer=tap,
                                            device=dev)
    with torch.inference_mode():
        frames = np.concatenate([fe.features(torch.from_numpy(w)[None].to(dev))[0].cpu().numpy()
                                 for w in decoded])
    del fe, params
    t0 = time.perf_counter()
    km = kmeans_fit(frames, k, iters=fit_iters, seed=0, batch=fit_batch, device=dev)
    km_s = time.perf_counter() - t0
    save_kmeans_centroids(str(data_work / "km.npy"), km)
    print(f"(c) {k} centroids fitted on {len(frames)} HuBERT frames of (b)'s files in "
          f"{km_s:.3f} s, written to km.npy", flush=True)
    result["kmeans"] = dict(rows=fit_rows, dim=fit_dim, k=k, iters=fit_iters,
                            fit_seconds=fit_s, fitted_rows_per_s=rows_per_s,
                            repeat_bitwise=repeat, centre_err=centre_err,
                            card_vs_cpu_rel_err=sub_err, hubert_frames=len(frames),
                            hubert_fit_seconds=km_s)

    # ---- (d) stage 1 and 2 --------------------------------------------------
    fe_args = [f"tokeniser.feature_extractor.pretrained_model={work / 'hubert'}",
               f"tokeniser.feature_extractor.kmeans_path={data_work / 'km.npy'}",
               f"tokeniser.feature_extractor.layer={tap}", *([] if on_card else ["device=cpu"])]
    features, tokens = data_work / "features.jsonl", data_work / "tokens.jsonl"
    source = [f"data_path={audio_dir}"] if flac else [f"data_path={audio_dir / 'wav'}", "ext=wav"]
    if not flac:
        try:
            cli_extract.extract_features([f"data_path={audio_dir}",
                                          f"out_path={data_work / 'no.jsonl'}", *fe_args])
            raise SystemExit("chip_smoke: cli.extract_features ext=flac ran without libav")
        except IOError as e:
            _require("libav" in str(e), f"ext=flac without libav raised without naming it: {e}")
    t0 = time.perf_counter()
    n_feat = cli_extract.extract_features([*source, f"out_path={features}", "batch_size=8",
                                           "num_workers=8", *fe_args])
    _sync(dev)
    stage1_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    n_tok = cli_prepare.prepare_tokens([f"data_path={features}", f"out_path={tokens}",
                                        *([] if on_card else ["+device=cpu"])])
    stage2_s = time.perf_counter() - t0
    feat_rows = [json.loads(line) for line in features.read_text().splitlines()]
    tok_rows = [json.loads(line) for line in tokens.read_text().splitlines()]
    by_name = {str(f if flac else w): wav for (f, w, *_), wav in zip(files, decoded)}
    names = [r["file_name"] for r in feat_rows]
    _require(n_feat == n_tok == len(tok_rows) == n_files and sorted(names) == sorted(by_name),
             f"stage 1 wrote {n_feat} and stage 2 {n_tok} lines for {n_files} files")
    tok = tokeniser_factory(compose(str(ROOT / "config"), "extract_features",
                                    [*source, "out_path=-", *fe_args]).tokeniser, device=dev)
    direct = []
    for start in range(0, len(names), 8):                  # the CLI's batches, zero-padded
        group = [by_name[n] for n in names[start:start + 8]]
        lens = np.array([len(w) for w in group])
        padded = np.zeros((len(group), int(lens.max())), np.float32)
        for i, w in enumerate(group):
            padded[i, :len(w)] = w
        direct += tok.audio_represent(padded, lens)
    stage_ok = all(f["units"] == d["units"] and f["duration"] == d["duration"]
                   and t["file_name"] == f["file_name"]
                   and t["audio_repr"] == tok.stringify_representation([d])[0]
                   for f, t, d in zip(feat_rows, tok_rows, direct))
    del tok
    n_units = sum(len(r["units"]) for r in feat_rows)
    distinct = len({u for r in feat_rows for u in r["units"]})
    print(f"(d) stage 1 (cli.extract_features, {'the default ext=flac' if flac else 'ext=wav: libav absent'}, "
          f"km.npy of (c)): {n_feat} files, {n_units} units ({distinct} distinct), "
          f"{stage1_s:.3f} s; stage 2: {n_tok} lines, {stage2_s:.3f} s; every line equals a "
          f"direct audio_represent of its batch: {stage_ok}; on {smi}", flush=True)
    _require(stage_ok, "stage 1 or 2 disagrees with a direct audio_represent")
    result["stages"] = dict(files=n_feat, units=n_units, distinct_units=distinct,
                            stage1_seconds=stage1_s, stage2_seconds=stage2_s)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # ---- (e) the spill and the cache at corpus scale ------------------------
    t0 = time.perf_counter()
    corpora = [data_work / f"corpus{i}.jsonl" for i in range(2)]
    n_tokens = [data_recipe.write_unit_corpus(c, corpus_tokens, seed=i, lengths=lengths)
                for i, c in enumerate(corpora)]
    write_s = time.perf_counter() - t0
    spill_dir, cache = data_work / "spill", data_work / "ds_cache"
    model_data = ["model=slam", f"model.context_len={context}", *model_overrides,
                  f"data.train_path=[{','.join(str(c) for c in corpora)}]",
                  "data.train_ratios=[0.5,0.5]", "data.val_path=null", "data.packing=true"]
    train_args = [*model_data, f"data.spill_tokens={spill_tokens}", f"data.spill_dir={spill_dir}",
                  f"data.saved_ds_path={cache}", f"training_args.max_steps={steps}",
                  f"training_args.per_device_train_batch_size={batch}",
                  "training_args.gradient_accumulation_steps=1", "training_args.remat=true",
                  "training_args.optim_state_dtype=bfloat16", "training_args.logging_steps=1",
                  "training_args.save_steps=0", *([] if on_card else ["training_args.use_cpu=true"])]
    real_init, real_batcher = cli_train.init_dataset, slam_trainer.Batcher
    real_factory = cli_train.tlm_factory

    def run(name):
        """cli.train with init_dataset timed and the train batches kept."""
        rec = {"batches": [], "batcher_args": None}

        def timed_init(cfg, tokeniser):
            t0 = time.perf_counter()
            ds = real_init(cfg, tokeniser)
            rec["init_s"] = time.perf_counter() - t0
            rec["train_memmap"] = isinstance(ds["train"].tokens, np.memmap)
            rec["train_tokens"] = ds["train"].num_tokens
            return ds

        def counted_factory(*args, **kwargs):
            model = real_factory(*args, **kwargs)
            rec["layers"] = model.decoder.cfg.num_layers
            return model

        class KeptBatcher(real_batcher):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                if rec["batcher_args"] is None:      # the trainer's first is the train one
                    rec["batcher_args"] = (args[1:], kwargs)
                    self.keep = rec["batches"]

            def epoch(self, *args, **kwargs):
                for b in super().epoch(*args, **kwargs):
                    if hasattr(self, "keep"):
                        self.keep.append({key: np.array(v) for key, v in b.items()})
                    yield b

        cli_train.init_dataset, slam_trainer.Batcher = timed_init, KeptBatcher
        cli_train.tlm_factory = counted_factory
        flash_attention_fwd.launches = flash_attention_bwd.launches = 0  # the main path's count
        rec["rss_before"] = _rss()
        used = shutil.disk_usage(data_work).used
        try:
            t0 = time.perf_counter()
            state = cli_train.train([*train_args, f"training_args.output_dir={data_work / name}"])
            _sync(dev)
            rec["wall_s"] = time.perf_counter() - t0
        finally:
            cli_train.init_dataset, slam_trainer.Batcher = real_init, real_batcher
            cli_train.tlm_factory = real_factory
        rec["launches"] = {"flash_fwd": flash_attention_fwd.launches,
                           "flash_bwd": flash_attention_bwd.launches}
        rec["rss_after"] = _rss()
        rec["disk_delta"] = shutil.disk_usage(data_work).used - used
        rec["losses"] = [r["loss"] for r in state.log_history if "loss" in r]
        rec["steps"] = state.global_step
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        return rec

    first = run("run_build")
    cache_bytes = sum(p.stat().st_size for p in cache.rglob("*") if p.is_file())
    again = run("run_cached")
    # the in-RAM build of the same config: spill_tokens above the corpus, no cache
    cfg = compose(str(ROOT / "config"), "train", [*model_data, f"data.spill_tokens={1 << 40}"])
    t0 = time.perf_counter()
    in_ram = data_mod.init_dataset(cfg, tokeniser_factory(cfg.tokeniser, device=dev))
    ram_s = time.perf_counter() - t0
    args, kwargs = first["batcher_args"]
    ram_batches = []
    for b in real_batcher(in_ram["train"], *args, **kwargs).epoch(0):
        ram_batches.append(b)
        if len(ram_batches) == len(first["batches"]):
            break
    same = lambda a, b: len(a) == len(b) > 0 and all(
        sorted(x) == sorted(y) and all(np.array_equal(x[k2], y[k2]) for k2 in x)
        for x, y in zip(a, b))
    cached_same, ram_same = same(first["batches"], again["batches"]), same(first["batches"],
                                                                           ram_batches)
    rss = lambda r: (f"{r['rss_before'][0]} -> {r['rss_after'][0]} B, the process's peak "
                     f"{r['rss_before'][1]} -> {r['rss_after'][1]} B")
    print(f"(e) two corpora of {n_tokens} unit tokens written in {write_s:.1f} s; cli.train "
          f"model=slam, {steps} steps of {batch} x {context}, mixed 0.5 / 0.5 with "
          f"spill_tokens={spill_tokens}: init_dataset {first['init_s']:.3f} s building "
          f"{first['train_tokens']} train tokens (spilled memmap: {first['train_memmap']}) and "
          f"writing the cache ({cache_bytes} B), {again['init_s']:.3f} s from the cache "
          f"(memmap: {again['train_memmap']}), {ram_s:.3f} s in RAM; RSS over the runs "
          f"{rss(first)} and {rss(again)}; disk {first['disk_delta']} and "
          f"{again['disk_delta']} B more after each run; losses {first['losses']} and "
          f"{again['losses']}; {len(first['batches'])} batches bitwise equal from the cache: "
          f"{cached_same}, spilled vs in RAM: {ram_same}; launches {first['launches']} and "
          f"{again['launches']}; {first['wall_s']:.1f} and {again['wall_s']:.1f} s the calls; "
          f"on {smi}", flush=True)
    _require(first["steps"] == again["steps"] == steps and len(first["losses"]) == steps
             and all(math.isfinite(v) for v in first["losses"]),
             f"cli.train did not take {steps} finite logged steps: {first['losses']}")
    _require(first["train_memmap"] and again["train_memmap"]
             and not isinstance(in_ram["train"].tokens, np.memmap),
             "the mixed corpus did not spill, or the cache did not load as a memmap")
    _require(cached_same and first["losses"][0] == again["losses"][0],
             "the run from the cache does not repeat the run that wrote it bit for bit")
    _require(ram_same, "the spilled corpus's batches differ from the in-RAM build's")
    for rec in (first, again):
        mb = rec["launches"]
        want_bwd = steps * rec["layers"] if on_card else 0
        _require(mb["flash_bwd"] == want_bwd and (mb["flash_fwd"] >= 2 * want_bwd if on_card
                                                  else mb["flash_fwd"] == 0),
                 f"cli.train launched {mb}: expected {want_bwd} backward calls and at least "
                 f"twice as many forward ones")
    result["spill_cache"] = dict(
        corpus_tokens=n_tokens, spill_tokens=spill_tokens, train_tokens=first["train_tokens"],
        init_seconds_build=first["init_s"], init_seconds_cached=again["init_s"],
        init_seconds_in_ram=ram_s, rss=[[first["rss_before"], first["rss_after"]],
                                        [again["rss_before"], again["rss_after"]]],
        disk_delta=[first["disk_delta"], again["disk_delta"]], cache_bytes=cache_bytes,
        losses=[first["losses"], again["losses"]], batches=len(first["batches"]),
        wall_seconds=[first["wall_s"], again["wall_s"]])
    result["launches"] = {key: first["launches"][key] + again["launches"][key]
                          for key in first["launches"]}
    del in_ram, ram_batches, first, again
    gc.collect()
    _drop(data_work)
    result["seconds"] = time.perf_counter() - phase_t0
    print(f"phase 14: {result['seconds']:.1f} s", flush=True)
    return result


def _dropout_seed(num_layers: int, rate: float, lo: int = 1, hi: int = 3) -> int:
    """The first dropout seed whose layerdrop skips between lo and hi layers,
    so that a fixed-seed check runs a skipped layer and most layers."""
    from slamkit_tpu_torch.models.transformer import _layer_drops

    return next(s for s in range(1000)
                if lo <= sum(_layer_drops(s, num_layers, rate)) <= min(hi, num_layers - 1))


def run_training_settings(dev, smi: str, work: pathlib.Path, slam_overrides=(),
                          twist_overrides=(), n_rows: int = 400, lengths=(100, 1001),
                          batch: int = 8, accum: int = 4, steps: int = 2, grad_rows: int = 2,
                          timed_steps: int = 2, mask_shape=(8, 1024, 896), n_pref: int = 32,
                          dpo_batch: int = 8, dpo_steps: int = 2, prompt_len: int = 100,
                          completion_len: int = 50, adafactor_scale: int = 1) -> dict:
    """Phase 15: the decoder's training settings and Adafactor, in phase 9's
    work directory. (a) `cli.train model=slam` at `SETTINGS` (dropout 0.1,
    layerdrop 0.1, remat qkv, Adafactor), `steps` steps of `accum` x `batch`
    with a save every step, and a run resumed from checkpoint-1 whose last
    loss and exported weights equal the uninterrupted run's bit for bit;
    every microbatch launches the flash forward and backward once a layer
    that layerdrop keeps. (b) One [`grad_rows`, T] microbatch of (a)'s stream
    from its last checkpoint with a fixed dropout seed: the gradients under
    no remat, "full" and "qkv" bitwise equal, the flash forward launched
    once a kept layer (twice under "full"); then seconds a step, non-pad
    tokens/s and `max_memory_allocated` of `timed_steps` Adafactor steps of
    `accum` x (a)'s first microbatch under each policy, and Adafactor's
    state bytes against AdamW's. (c) Mask statistics on the card: the kept
    share of a `mask_shape` mask within 5 sigma, the repeat bitwise, another
    seed or site another mask; layerdrop's share over 10000 host draws. (d)
    `cli.train` (model=twist) with the plain attention and
    attention_dropout 0.1: `steps` finite steps, an exact resume, no flash
    launch; the same setting on the flash path raises. (e)
    `cli.preference_alignment_train` from (a)'s checkpoint (its dropout and
    layerdrop; Adafactor), two runs bit for bit equal, and a run from the
    same weights with the rates at 0 whose losses differ after step 1 (step
    1 at ln 2). (f) Adafactor on the card against the CPU from the same
    parameters and gradients of one Slam layer and the embedding (shapes
    divided by `adafactor_scale` in a rehearsal), 3 steps, within
    ADAFACTOR_REL_BOUND. On the CPU (a rehearsal at narrow widths,
    `*_overrides`) no launch may be counted."""
    import dataclasses
    import os

    import torch

    from slamkit_tpu_torch.cli import preference_alignment_train as cli_dpo
    from slamkit_tpu_torch.cli import train as cli_train
    from slamkit_tpu_torch.models import UnitLM, grads_to_flat
    from slamkit_tpu_torch.models import transformer
    from slamkit_tpu_torch.ops import flash_attention_bwd, flash_attention_fwd
    from slamkit_tpu_torch.tools.slam_recipe import write_markov_corpus, write_preference_rows
    from slamkit_tpu_torch.trainer import SLAMDPOTrainer, SLAMTrainer
    from slamkit_tpu_torch.trainer.optim import Adafactor, make_optimizer
    from slamkit_tpu_torch.trainer.slam_trainer import BATCH_KEYS

    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()
    counters = ((flash_attention_fwd, "launches"), (flash_attention_bwd, "launches"))
    counts = lambda: tuple(getattr(f, c) for f, c in counters)
    nonpad = lambda tr, group: sum(int((mb["segment_ids"] >= 0).sum()) for mb in group)
    logged = lambda state, key: [r[key] for r in state.log_history if key in r]
    # layerdrop's decisions, recorded as the runs draw them
    drops, real_drops = [], transformer._layer_drops

    def recording_drops(seed, n, rate):
        drops.append(real_drops(seed, n, rate))
        return drops[-1]

    def cli_run(main, cls, args, tokens):
        drops.clear()
        transformer._layer_drops = recording_drops
        try:
            rec = _cli_run(dev, main, cls, args, tokens, counters)
        finally:
            transformer._layer_drops = real_drops
        rec["kept_layers"] = [len(d) - sum(d) for d in drops]
        return rec

    def check_resume(what, first, again, out, resumed, step):
        pair = (logged(first["state"], "loss")[-1], logged(again["state"], "loss")[-1])
        same_w = _bytes_equal(out / f"checkpoint-{step}", resumed / f"checkpoint-{step}")
        print(f"{what} resumed: step {step} loss {pair[1]} against {pair[0]}; "
              f"checkpoint-{step} weights bitwise equal: {same_w}", flush=True)
        _require(pair[0] == pair[1] and same_w,
                 f"the resumed {what} run does not repeat step {step} bit for bit")

    # ---- (a) cli.train model=slam at the slice's settings --------------------
    train_path, val_path = work / "settings_tokens.jsonl", work / "settings_val.jsonl"
    write_markov_corpus(train_path, n_rows, lengths, seed=2)
    write_markov_corpus(val_path, 16, lengths, seed=3)
    common = [f"data.train_path={train_path}", f"data.val_path={val_path}", "data.packing=true",
              f"training_args.max_steps={steps}",
              f"training_args.per_device_train_batch_size={batch}",
              f"training_args.per_device_eval_batch_size={batch}",
              f"training_args.gradient_accumulation_steps={accum}",
              "training_args.save_steps=1", "training_args.logging_steps=1",
              *([] if on_card else ["training_args.use_cpu=true"])]
    slam_args = ["model=slam", *SETTINGS, *slam_overrides, *common]
    out, resumed = work / "settings_slam", work / "settings_slam_resumed"
    first = cli_run(cli_train.train, SLAMTrainer,
                    [*slam_args, f"training_args.output_dir={out}"], nonpad)
    again = cli_run(cli_train.train, SLAMTrainer,
                    [*slam_args, f"training_args.output_dir={resumed}",
                     f"cont_training={out / 'checkpoint-1'}"], nonpad)
    L = first["n_layers"]
    for what, rec, n_steps in (("slam", first, steps), ("slam resumed", again, steps - 1)):
        state, kept = rec["state"], rec["kept_layers"]
        per_step = [sum(kept[i * accum:(i + 1) * accum]) for i in range(n_steps)]
        want = (sum(per_step) + rec["eval_batches"] * L, sum(per_step)) if on_card else (0, 0)
        want_steps = [(k, k) if on_card else (0, 0) for k in per_step]
        losses = logged(state, "loss")
        print(f"{what} (cli.train {' '.join(SETTINGS)}): {state.global_step} steps of {accum} x "
              f"{batch} ({rec['dtype']}, {L} layers, remat {rec['remat_policy']}, "
              f"{rec['optimizer']}), losses {losses}, eval {logged(state, 'eval_loss')}; layers "
              f"kept a microbatch {kept}; seconds a step {rec['seconds']}, non-pad tokens/s "
              f"{rec['tokens_per_s']}, {rec['wall_s']:.1f} s the whole call; launches (fwd, "
              f"bwd) {rec['launches']} (a step {rec['step_launches']}; expected {want}, "
              f"{rec['eval_batches']} eval batches); max_memory_allocated "
              f"{rec['max_memory_allocated']} B; on {smi}", flush=True)
        _require(state.global_step == steps and len(rec["seconds"]) == n_steps
                 and all(math.isfinite(x) for x in losses)
                 and (rec["remat_policy"], rec["optimizer"]) == ("qkv", "adafactor"),
                 f"{what} did not take {n_steps} finite qkv / Adafactor steps: {losses}")
        _require(len(kept) == n_steps * accum and rec["launches"] == want
                 and rec["step_launches"] == want_steps,
                 f"{what} launched {rec['launches']} ({rec['step_launches']} a step), expected "
                 f"{want} ({want_steps} a step): the flash forward once a kept layer under qkv")
    _require(again["kept_layers"] == first["kept_layers"][accum:],
             "the resumed run's layerdrop decisions are not the uninterrupted run's")
    check_resume("slam", first, again, out, resumed, steps)
    mb = first.pop("first_microbatch")
    again.pop("first_microbatch")
    result = {"slam": dict(
        losses=logged(first["state"], "loss"), eval_loss=logged(first["state"], "eval_loss"),
        step_seconds=first["seconds"], tokens_per_s=first["tokens_per_s"],
        wall_s=first["wall_s"], resumed_wall_s=again["wall_s"], launches=first["launches"],
        step_launches=first["step_launches"], resumed_launches=again["launches"],
        kept_layers=first["kept_layers"], layers=L, eval_batches=first["eval_batches"],
        max_memory_allocated=first["max_memory_allocated"])}
    _drop(resumed, out / "checkpoint-1")
    _free(dev)

    # ---- (b) one microbatch under each remat policy ---------------------------
    ckpt = out / f"checkpoint-{steps}"
    lm = UnitLM.from_pretrained(str(ckpt), device=dev)
    cfg = lm.decoder.cfg
    seed = _dropout_seed(L, cfg.layerdrop)
    kept = L - sum(real_drops(seed, L, cfg.layerdrop))
    policies = {"none": dict(remat=False), "full": dict(remat=True, remat_policy="full"),
                "qkv": dict(remat=True, remat_policy="qkv")}
    want_launches = {"none": (kept, kept), "full": (2 * kept, kept), "qkv": (kept, kept)}
    small = {k: torch.from_numpy(mb[k][:grad_rows]).to(dev) for k in BATCH_KEYS}
    grads, policy_launches = {}, {}
    for name, knobs in policies.items():
        lm.decoder.cfg = dataclasses.replace(cfg, **knobs)
        for p in lm.parameters():
            p.grad = None
        c0 = counts()
        lm.loss_fn(small, dropout_seed=seed).backward()
        _sync(dev)
        policy_launches[name] = tuple(b - a for a, b in zip(c0, counts()))
        grads[name] = {k: p.grad.detach().clone() for k, p in lm.decoder.named_parameters()}
    differ = {name: sorted(k for k in grads["none"] if not torch.equal(g[k], grads["none"][k]))
              for name, g in grads.items()}
    want_pl = want_launches if on_card else {k: (0, 0) for k in policies}
    print(f"remat policies on one {list(small['input_ids'].shape)} microbatch at dropout "
          f"{cfg.dropout}, layerdrop {cfg.layerdrop}, seed {seed} ({kept} of {L} layers kept): "
          f"launches (fwd, bwd) {policy_launches} (expected {want_pl}); tensors whose gradient "
          f"differs from no remat's: {differ}", flush=True)
    _require(policy_launches == want_pl, f"the remat policies launched {policy_launches}, "
             f"expected {want_pl}")
    _require(not any(differ.values()), f"the remat policies' gradients differ: {differ}")
    del grads
    for p in lm.parameters():
        p.grad = None
    _free(dev)
    # ... and seconds a step under each, at (a)'s microbatch
    full_mb = {k: torch.from_numpy(mb[k]).to(dev) for k in BATCH_KEYS}
    tokens = accum * int((mb["segment_ids"] >= 0).sum())
    num_items = accum * int((mb["labels"] != -100).sum())
    n_params = sum(p.numel() for p in lm.parameters())
    opt = Adafactor(lm.parameters(), lambda step: 1e-5, max_grad_norm=0.5)
    state_bytes = sum(t.numel() * t.element_size() for key in ("v_row", "v_col", "v")
                      for t in getattr(opt, key) if t is not None)
    timing = {}
    for name, knobs in policies.items():
        lm.decoder.cfg = dataclasses.replace(cfg, **knobs)
        _free(dev)
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        secs, launches = [], []
        for i in range(1 + timed_steps):
            _sync(dev)
            c0, t0 = counts(), time.perf_counter()
            for j in range(accum):
                lm.loss_fn({**full_mb, "num_items_in_batch": num_items},
                           dropout_seed=1000 * i + j).backward()
            opt.step()
            opt.zero_grad()
            _sync(dev)
            if i:   # the first step warms up
                secs.append(time.perf_counter() - t0)
                launches.append(tuple(b - a for a, b in zip(c0, counts())))
        timing[name] = dict(
            step_seconds=secs, tokens_per_s=[tokens / t for t in secs], step_launches=launches,
            max_memory_allocated=torch.cuda.max_memory_allocated(dev) if on_card else None)
    print(f"a step of {accum} x {list(full_mb['input_ids'].shape)} ({tokens} non-pad tokens), "
          f"Adafactor, dropout live, per remat policy: "
          + "; ".join(f"{k}: seconds {v['step_seconds']}, non-pad tokens/s "
                      f"{v['tokens_per_s']}, launches (fwd, bwd) {v['step_launches']}, "
                      f"max_memory_allocated {v['max_memory_allocated']} B"
                      for k, v in timing.items())
          + f"; Adafactor state {state_bytes} B against AdamW's {8 * n_params} B (float32 "
          f"moments) over {n_params} parameters; on {smi}", flush=True)
    result["remat"] = dict(shape=list(small["input_ids"].shape), seed=seed, kept_layers=kept,
                           launches=policy_launches, timing=timing,
                           adafactor_state_bytes=state_bytes,
                           adamw_state_bytes=8 * n_params, params=n_params)
    del lm, opt, full_mb, small
    _free(dev)

    # ---- (c) mask statistics on the card -------------------------------------
    rate = 0.1
    _sync(dev)
    t0 = time.perf_counter()
    keep = transformer._keep_mask(7, (transformer.ATTN_RES, 3), mask_shape, rate, dev)
    _sync(dev)
    mask_s = time.perf_counter() - t0
    n = keep.numel()
    kept_share = float(keep.sum()) / n
    sigmas = abs(kept_share - (1 - rate)) * n / math.sqrt(n * rate * (1 - rate))
    same = torch.equal(keep, transformer._keep_mask(7, (transformer.ATTN_RES, 3), mask_shape,
                                                    rate, dev))
    other = [not torch.equal(keep, transformer._keep_mask(sd, site, mask_shape, rate, dev))
             for sd, site in ((8, (transformer.ATTN_RES, 3)), (7, (transformer.MLP_RES, 3)))]
    layer_share = float(np.mean([real_drops(sd, L, rate) for sd in range(10000)]))
    layer_sigmas = abs(layer_share - rate) / math.sqrt(rate * (1 - rate) / (10000 * L))
    print(f"masks on {dev.type}: kept share {kept_share} of {n} at rate {rate} ({sigmas:.2f} "
          f"sigma), repeat bitwise {same}, another seed / site another mask {other}, "
          f"{mask_s * 1e3:.3f} ms a draw (the first); layerdrop's share {layer_share} over "
          f"10000 x {L} host draws ({layer_sigmas:.2f} sigma)", flush=True)
    _require(n >= 10 ** 6 or not on_card, f"the mask check holds only {n} elements")
    _require(sigmas <= 5 and layer_sigmas <= 5 and same and all(other),
             "the dropout masks fail their statistics")
    result["masks"] = dict(shape=list(mask_shape), kept_share=kept_share, sigmas=sigmas,
                           repeat_bitwise=same, first_draw_ms=mask_s * 1e3,
                           layerdrop_share=layer_share, layerdrop_sigmas=layer_sigmas)
    del keep

    # ---- (d) model=twist with the plain attention and attention dropout ------
    plain = ["model.config_args.attn_implementation=xla",
             "model.config_args.attention_dropout=0.1", *twist_overrides, *common]
    t_out, t_resumed = work / "settings_twist", work / "settings_twist_resumed"
    tw = cli_run(cli_train.train, SLAMTrainer, [*plain, f"training_args.output_dir={t_out}"],
                 nonpad)
    tw_again = cli_run(cli_train.train, SLAMTrainer,
                       [*plain, f"training_args.output_dir={t_resumed}",
                        f"cont_training={t_out / 'checkpoint-1'}"], nonpad)
    tw.pop("first_microbatch")
    tw_again.pop("first_microbatch")
    losses = logged(tw["state"], "loss")
    print(f"twist (cli.train attn_implementation=xla attention_dropout=0.1): "
          f"{tw['state'].global_step} steps ({tw['dtype']}, {tw['n_layers']} layers), losses "
          f"{losses}; seconds a step {tw['seconds']}, non-pad tokens/s {tw['tokens_per_s']}; "
          f"flash launches (fwd, bwd) {tw['launches']} and resumed {tw_again['launches']} "
          f"(the plain attention: none); max_memory_allocated {tw['max_memory_allocated']} B",
          flush=True)
    _require(tw["state"].global_step == steps and all(math.isfinite(x) for x in losses)
             and tw["launches"] == tw_again["launches"] == (0, 0),
             f"twist on the plain attention: losses {losses}, launches {tw['launches']}")
    check_resume("twist", tw, tw_again, t_out, t_resumed, steps)
    refusal = None
    try:
        cli_train.train([*plain, "model.config_args.attn_implementation=flash_attention_2",
                         "training_args.max_steps=1",
                         f"training_args.output_dir={work / 'settings_twist_flash'}"])
    except ValueError as e:
        refusal = str(e)
    print(f"twist on the flash path with attention_dropout=0.1 raises: {refusal}", flush=True)
    _require(refusal is not None and "attention_dropout" in refusal,
             "attention_dropout on the flash path did not raise")
    result["twist"] = dict(losses=losses, step_seconds=tw["seconds"],
                           tokens_per_s=tw["tokens_per_s"], launches=tw["launches"],
                           max_memory_allocated=tw["max_memory_allocated"], layers=tw["n_layers"])
    _drop(t_out, t_resumed, *[p for p in [work / "settings_twist_flash"] if p.exists()])
    _free(dev)

    # ---- (e) DPO with dropout from (a)'s checkpoint ---------------------------
    pref = work / "settings_pref.jsonl"
    write_preference_rows(pref, n_pref, prompt_len, completion_len, seed=4)
    # the same weights with the rates at 0 (a fine-tune's config_args do not
    # override a checkpoint's, in either package)
    nodrop = work / "settings_nodrop"
    nodrop.mkdir()
    os.link(ckpt / "params.npz", nodrop / "params.npz")
    saved = json.loads((ckpt / "unit_lm_config.json").read_text())
    (nodrop / "unit_lm_config.json").write_text(json.dumps(
        {**saved, "dropout": 0.0, "attention_dropout": 0.0, "layerdrop": 0.0}))
    dpo_args = [f"data.train_path={pref}", f"data.val_path={pref}",
                f"training_args.max_steps={dpo_steps}", "training_args.save_steps=0",
                f"training_args.per_device_train_batch_size={dpo_batch}",
                "training_args.logging_steps=1", "training_args.optim=adafactor",
                *([] if on_card else ["training_args.use_cpu=true"])]
    dpo_tokens = lambda tr, rows: int((tr._collate(rows)["segment_ids"] >= 0).sum())
    dpo = {}
    for name, model_dir in (("a", ckpt), ("b", ckpt), ("no_dropout", nodrop)):
        rec = cli_run(cli_dpo.train, SLAMDPOTrainer,
                      [f"model.pretrained_model={model_dir}", *dpo_args,
                       f"training_args.output_dir={work / f'settings_dpo_{name}'}"], dpo_tokens)
        dpo[name] = dict(losses=logged(rec["state"], "loss"), step_seconds=rec["seconds"],
                         launches=rec["launches"], kept_layers=rec["kept_layers"])
    print(f"DPO from {ckpt.name} ({dpo_steps} steps of 2 x {dpo_batch} rows, Adafactor): with "
          f"its dropout {dpo['a']['losses']} and again {dpo['b']['losses']} (layers kept a step "
          f"{dpo['a']['kept_layers']}); the rates at 0 {dpo['no_dropout']['losses']}; "
          f"launches (fwd, bwd) {dpo['a']['launches']}; seconds a step "
          f"{dpo['a']['step_seconds']}", flush=True)
    _require(dpo["a"]["losses"] == dpo["b"]["losses"] and all(map(math.isfinite,
                                                                 dpo["a"]["losses"])),
             "two same-seed DPO runs with dropout differ")
    _require(all(a != b for a, b in zip(dpo["a"]["losses"][1:], dpo["no_dropout"]["losses"][1:]))
             and abs(dpo["no_dropout"]["losses"][0] - math.log(2)) <= 1e-6,
             "DPO with dropout does not differ from DPO without it after step 1")
    result["dpo"] = dpo
    _drop(out, nodrop, *[work / f"settings_dpo_{name}" for name in dpo])
    _free(dev)

    # ---- (f) Adafactor, card against CPU --------------------------------------
    rng = np.random.default_rng(5)
    shapes = [(502, 896), (896, 896), (896, 128), (896, 128), (896, 896), (896, 4864),
              (896, 4864), (4864, 896), (896,), (128,), (896,)]
    shapes = [tuple(max(n // adafactor_scale, 1) for n in sh) for sh in shapes]
    init = [(0.02 * rng.standard_normal(sh)).astype(np.float32) for sh in shapes]
    grads_np = [[rng.standard_normal(sh).astype(np.float32) for sh in shapes] for _ in range(3)]
    args = {"learning_rate": 1e-3, "lr_scheduler_type": "cosine_with_min_lr",
            "lr_scheduler_kwargs": {"min_lr": 5e-5}, "warmup_steps": 1,
            "max_grad_norm": 0.5, "weight_decay": 0.1, "optim": "adafactor"}
    final = {}
    for where in (dev, torch.device("cpu")):
        params = [torch.nn.Parameter(torch.tensor(x, device=where)) for x in init]
        opt, _ = make_optimizer(args, params, 10)
        for gs in grads_np:
            for p, g in zip(params, gs):
                p.grad = torch.from_numpy(g).to(where)
            opt.step()
        final[where.type] = [p.detach().cpu().numpy().astype(np.float64) for p in params]
    eps32 = float(np.finfo(np.float32).eps)
    rel = [float(np.abs(a - b).max()
                 / (np.abs(b - x).max() + len(grads_np) * eps32 * np.abs(b).max()
                    / ADAFACTOR_REL_BOUND))
           for a, b, x in zip(final[dev.type], final["cpu"], init)]
    factored = sum(d is not None for d in opt.dims)
    print(f"Adafactor on {dev.type} against the CPU, {len(grads_np)} steps of {len(shapes)} "
          f"Slam-shaped tensors ({factored} factored): max |card - cpu| over (the largest "
          f"update + {len(grads_np)} eps32 of the largest entry / {ADAFACTOR_REL_BOUND}), "
          f"the worst tensor's: {max(rel):.3e} (<= {ADAFACTOR_REL_BOUND})", flush=True)
    _require(max(rel) <= ADAFACTOR_REL_BOUND, f"Adafactor on the card disagrees with the CPU: "
             f"{rel}")
    result["adafactor"] = dict(max_rel_err=max(rel), tensors=len(shapes), factored=factored)
    result["launches"] = {
        "flash_fwd": sum(r["launches"][0] for r in (first, again))
        + sum(policy_launches[k][0] for k in policies)
        + sum(sum(t[0] for t in timing[k]["step_launches"]) for k in policies)
        + sum(d["launches"][0] for d in dpo.values()),
        "flash_bwd": sum(r["launches"][1] for r in (first, again))
        + sum(policy_launches[k][1] for k in policies)
        + sum(sum(t[1] for t in timing[k]["step_launches"]) for k in policies)
        + sum(d["launches"][1] for d in dpo.values())}
    result["seconds"] = time.perf_counter() - t_phase
    print(f"phase 15: {result['seconds']:.1f} s", flush=True)
    return result


def run_sims_defaults(dev, smi: str, work: pathlib.Path, tiny: bool = False, n_rows: int = 96,
                      lengths=(300, 700), context: int = 2048, batch: int = 8, steps: int = 2,
                      qwen_entries=None, qwen_batch: int = 4, qwen_accum: int = 2,
                      cpu_tokens: int = 256, hubert_cfg=None, voc_cfg=None, n_stories: int = 16,
                      story_seconds=(1.0, 2.0), n_prompts: int = 4,
                      max_new_tokens: int = 40) -> dict:
    """Phase 16, in phase 9's work directory (its HuBERT directory, centroids
    and WAV pairs, phase 10's features.jsonl): SIMS at its shipped defaults.
    (b) `cli.train --config-name train_inter_scale` on its stock settings
    (per-device batch `batch`, accumulation 1, context `context`, remat off,
    bf16, flash_attention_2) over pythia-14m's base directory
    (`sims_recipe.write_pythia14m_base`: its config.json and GPT-NeoX
    tokenizer, no weights, so TWIST falls back to random init), `steps`
    steps with a save every step, a run resumed from checkpoint-1 that must
    repeat the last step bit for bit, then the same in float32; (c) float32
    SIMS at phase 11's base (Qwen2.5-0.5B's widths, its 151665-entry
    vocabulary; `tiny`: the 4-layer base), `qwen_batch` x `qwen_accum` at
    `context`, remat, bf16 moments, and one row's first `cpu_tokens` tokens
    of its first microbatch on the card against float32 on the CPU; (d)
    stage 2 (`cli.prepare_tokens tokeniser=interleaved_hubert_25`) through
    the shipped default text tokeniser's layout (`write_gpt2_bpe_files`:
    vocab.json + merges.txt, no tokenizer.json) with phase 11's seeded
    alignments, every line held to a direct `stringify_representation`;
    (e) `cli.eval` through the interleaving tokeniser on (b)'s checkpoint:
    `metric=sstorycloze` over `n_stories` seeded pairs, `metric=generate`
    with used_token_modality null, SPEECH and TEXT, and
    `metric=asr_perplexity` through `tools/genppl_recipe.py`'s Whisper and
    Llama directories (on the card whisper-large-v3-turbo's and
    Llama-3.2-1B's widths cut to ASR_ENCODER_LAYERS and TEXT_LM_LAYERS
    layers; `tiny`: the tiny ones), over `n_prompts` of phase 9's WAVs. On the card
    every microbatch of (b) launches the forward and the backward once per
    layer in its dtype, every microbatch of (c) the float32 forward twice
    and the backward once per layer, every scoring call and generation
    prefill of (e) the forward once per layer and every text-LM scoring call
    the float32 forward once per text-LM layer; on the CPU (a rehearsal at
    narrow widths) no launch may be counted."""
    from slamkit_tpu_torch.cli import eval as cli_eval
    from slamkit_tpu_torch.cli import prepare_tokens as cli_prepare
    from slamkit_tpu_torch.cli import train as cli_train
    from slamkit_tpu_torch.config import compose
    from slamkit_tpu_torch.feature_extractor import HUBERT_CONFIG_PRESETS, HubertConfig
    from slamkit_tpu_torch.metric import generative_metric as gm
    from slamkit_tpu_torch.models import UnitLM
    from slamkit_tpu_torch.ops import flash_attention_bwd, flash_attention_fwd
    from slamkit_tpu_torch.tokeniser import tokeniser_factory
    from slamkit_tpu_torch.tools import genppl_recipe, sims_recipe
    from slamkit_tpu_torch.trainer import SLAMTrainer
    from slamkit_tpu_torch.trainer.slam_trainer import BATCH_KEYS
    from slamkit_tpu_torch.vocoder.checkpoint_manager import CHECKPOINT_MANAGER

    on_card = dev.type == "cuda"
    phase_start = time.perf_counter()
    root = work / "sims_defaults"
    counters = ((flash_attention_fwd, "launches"), (flash_attention_bwd, "launches"),
                (flash_attention_fwd, "f32_launches"), (flash_attention_bwd, "f32_launches"))
    nonpad = lambda tr, group: sum(int((mb["segment_ids"] >= 0).sum()) for mb in group)
    logged = lambda state, key: [r[key] for r in state.log_history if key in r]
    launches = dict.fromkeys(("flash_fwd", "flash_bwd", "flash_fwd_f32", "flash_bwd_f32"), 0)

    def count(got):
        for key, n in zip(launches, got):
            launches[key] += n

    def check_train(what, rec, n_steps, per_step):
        """`n_steps` finite steps of `rec["dtype"]`, each launching `per_step`
        (bf16 fwd, bf16 bwd, f32 fwd, f32 bwd) on the card, nothing on the
        CPU."""
        want_step = per_step if on_card else (0, 0, 0, 0)
        want = tuple(n_steps * n for n in want_step)
        losses = logged(rec["state"], "loss")
        step_s, tps = rec["seconds"], rec["tokens_per_s"]
        print(f"{what}: {rec['state'].global_step} steps ({rec['dtype']}, {rec['n_layers']} "
              f"layers, remat {rec['remat']}), losses {losses}; seconds a step {step_s}, "
              f"non-pad tokens a step {rec['tokens']}, non-pad tokens/s {tps}; "
              f"{rec['wall_s']:.1f} s the whole call; launches (bf16 fwd, bf16 bwd, f32 fwd, "
              f"f32 bwd) {rec['launches']} (a step {rec['step_launches']}; predicted {want}); "
              f"max_memory_allocated {rec['max_memory_allocated']} B ({rec['allocated_before']} B "
              f"allocated before the call); {rec['twist']}; on {smi}",
              flush=True)
        _require(len(step_s) == n_steps and rec["state"].global_step == steps
                 and len(losses) == steps and all(math.isfinite(x) for x in losses),
                 f"{what} did not take {n_steps} finite logged steps to step {steps}: {losses}")
        _require(rec["launches"] == want and all(x == want_step for x in rec["step_launches"]),
                 f"{what} launched {rec['launches']} ({rec['step_launches']} a step), "
                 f"predicted {want}")
        count(rec["launches"])
        return losses

    # ---- (b) the stock train_inter_scale run on pythia-14m -------------------
    pythia = sims_recipe.write_pythia14m_base(root / "pythia14m")
    text, inter, speech = sims_recipe.write_corpora(root, n_rows, lengths)
    data = [f"data.train_path=[{text},{inter},{speech}]", "data.val_path=null",
            f"model.context_len={context}", "logger=print"]
    stock = ["--config-name", "train_inter_scale", f"model.config_args.base_model_name={pythia}",
             *data,
             f"training_args.per_device_train_batch_size={batch}",
             f"training_args.max_steps={steps}", "training_args.save_steps=1",
             "training_args.logging_steps=1"]
    result = {}
    for dtype in ("bfloat16", "float32"):
        out = root / f"stock_{dtype}"
        extra = [] if on_card else ["training_args.use_cpu=true"]
        if dtype == "float32" or not on_card:
            extra.append("model.config_args.torch_dtype=float32")
        rec = _cli_run(dev, cli_train.train, SLAMTrainer,
                       [*stock, *extra, f"training_args.output_dir={out}"], nonpad, counters)
        L = rec["n_layers"]
        _require(not rec["remat"] and L == 6 and (rec["dtype"] == dtype or not on_card),
                 f"the stock run took remat {rec['remat']}, {L} layers, {rec['dtype']}")
        per_mb = (L, L, 0, 0) if dtype == "bfloat16" else (0, 0, L, L)
        losses = check_train(f"train_inter_scale on pythia-14m, {dtype}", rec, steps, per_mb)
        result[dtype] = dict(losses=losses, step_seconds=rec["seconds"],
                             tokens_a_step=rec["tokens"], tokens_per_s=rec["tokens_per_s"],
                             wall_s=rec["wall_s"], launches=rec["launches"],
                             step_launches=rec["step_launches"],
                             max_memory_allocated=rec["max_memory_allocated"],
                             allocated_before=rec["allocated_before"],
                             twist=rec["twist"], layers=L)
        if dtype == "bfloat16":
            ckpt = out / f"checkpoint-{steps}"
            resumed = root / "stock_resumed"
            again = _cli_run(dev, cli_train.train, SLAMTrainer,
                             [*stock, *extra, f"training_args.output_dir={resumed}",
                              f"cont_training={out / 'checkpoint-1'}"], nonpad, counters)
            check_train("train_inter_scale on pythia-14m, bfloat16, resumed", again, steps - 1,
                        per_mb)
            last, last_again = losses[-1], logged(again["state"], "loss")[-1]
            same_w = _bytes_equal(ckpt, resumed / f"checkpoint-{steps}")
            print(f"train_inter_scale resumed from checkpoint-1: step {steps} loss {last_again} "
                  f"against {last}; checkpoint-{steps} weights bitwise equal: {same_w}",
                  flush=True)
            _require(last == last_again and same_w, "the resumed stock run does not repeat "
                     f"step {steps} bit for bit")
            result["resume_exact"] = same_w
            _drop(resumed, out / "checkpoint-1")
        else:
            _drop(out)

    # ---- (c) float32 SIMS at Qwen2.5-0.5B's widths ---------------------------
    qbase = sims_recipe.write_base_dir(root / "qwen", tiny=tiny,
                                       n_entries=qwen_entries or sims_recipe.QWEN25_VOCAB)
    out = root / "qwen_f32"
    rec = _cli_run(dev, cli_train.train, SLAMTrainer,
                   ["--config-name", "train_inter_scale",
                    f"model.config_args.base_model_name={qbase}",
                    "model.config_args.twist_init=false", *data,
                    f"training_args.output_dir={out}", f"training_args.max_steps={steps}",
                    f"training_args.per_device_train_batch_size={qwen_batch}",
                    f"training_args.gradient_accumulation_steps={qwen_accum}",
                    f"training_args.save_steps={steps}", "training_args.logging_steps=1",
                    "training_args.remat=true", "training_args.optim_state_dtype=bfloat16",
                    "model.config_args.torch_dtype=float32",
                    *([] if on_card else ["training_args.use_cpu=true"])], nonpad, counters)
    L = rec["n_layers"]
    _require(rec["remat"] and rec["dtype"] == "float32", "float32 SIMS did not take remat and "
             "float32")
    losses = check_train("float32 SIMS at Qwen2.5-0.5B's widths", rec, steps,
                         (0, 0, 2 * L * qwen_accum, L * qwen_accum))
    mb = rec["first_microbatch"]
    check = _f32_card_vs_cpu(dev, out / f"checkpoint-{steps}",
                             {k: mb[k][:1, :cpu_tokens] for k in BATCH_KEYS})
    result["qwen_f32"] = dict(losses=losses, step_seconds=rec["seconds"],
                              tokens_per_s=rec["tokens_per_s"], wall_s=rec["wall_s"],
                              launches=rec["launches"], step_launches=rec["step_launches"],
                              max_memory_allocated=rec["max_memory_allocated"],
                              allocated_before=rec["allocated_before"], layers=L,
                              card_vs_cpu=check)
    _drop(out)

    # ---- (d) stage 2 through GPT-2 vocab.json + merges.txt -------------------
    bpe = sims_recipe.write_gpt2_bpe_files(root / "opt_tokeniser")
    tok_args = ["tokeniser=interleaved_hubert_25", f"tokeniser.params.text_tokeniser_path={bpe}"]
    seed_arg = "+tokeniser.params.interleave_seed=0"
    tok = tokeniser_factory(compose(str(ROOT / "config"), "prepare_tokens",
                                    [*tok_args, seed_arg, "data_path=-", "out_path=-"]).tokeniser,
                            device=dev)
    features = work / "stage1_features.jsonl"
    align = sims_recipe.write_alignments(root / "align", features,
                                         tok.speech_fe.get_unit_duration())   # phase 11's
    stage2 = root / "inter_bpe.jsonl"
    t0 = time.perf_counter()
    n_lines = cli_prepare.prepare_tokens([f"data_path={features}", f"out_path={stage2}",
                                          *tok_args, f"meta_path={align}", seed_arg,
                                          *([] if on_card else ["+device=cpu"])])
    stage2_s = time.perf_counter() - t0
    feat_rows = [json.loads(line) for line in features.read_text().splitlines()]
    tok_rows = [json.loads(line) for line in stage2.read_text().splitlines()]
    direct = []
    for row in feat_rows:
        meta = json.loads((pathlib.Path(align) / f"{pathlib.Path(row['file_name']).stem}.json")
                          .read_text())
        direct.append(tok.stringify_representation([{**row, **meta}], mode="train")[0])
    stage_ok = n_lines == len(feat_rows) == len(tok_rows) and all(
        t["file_name"] == f["file_name"] and t["audio_repr"] == d
        for f, t, d in zip(feat_rows, tok_rows, direct))
    text_ids = sum(len(tok.text_tokeniser(d, add_special_tokens=False)["input_ids"])
                   for d in direct)
    print(f"stage 2 through vocab.json + merges.txt ({len(tok.text_tokeniser)} ids with the "
          f"units): {n_lines} lines in {stage2_s:.3f} s ({n_lines / stage2_s:.1f} lines/s), "
          f"{text_ids} ids in all; every line equals a direct "
          f"stringify_representation(mode='train'): {stage_ok}", flush=True)
    _require(stage_ok and any("<text>" in d and "<speech>" in d for d in direct),
             "stage 2 through the GPT-2 files disagrees with a direct stringify_representation, "
             "or interleaves nothing")
    result["stage2"] = dict(lines=n_lines, seconds=stage2_s, lines_per_s=n_lines / stage2_s,
                            ids=text_ids, vocab=len(tok.text_tokeniser))

    # ---- (e) the metrics through the interleaving tokeniser ------------------
    hubert_cfg = hubert_cfg or HubertConfig(**HUBERT_CONFIG_PRESETS["slprl/mhubert-base-25hz"])
    n_layers = result["bfloat16"]["layers"]
    common = [f"model.pretrained_model={ckpt}", "tokeniser=interleaved_hubert_25",
              f"tokeniser.params.text_tokeniser_path={pythia}",
              f"tokeniser.feature_extractor.pretrained_model={work / 'hubert'}",
              f"tokeniser.feature_extractor.kmeans_path={work / 'km.npy'}",
              f"tokeniser.feature_extractor.layer={hubert_cfg.num_hidden_layers - 1}",
              "batch_size=8", "num_workers=8",
              *([] if on_card else ["device=cpu", "model.config_args.torch_dtype=float32"])]
    stories = write_pairs(root / "sSC", n_stories, story_seconds, seed=16, sep="_")
    textless_root = CHECKPOINT_MANAGER.disk_root
    CHECKPOINT_MANAGER.set_root(sims_recipe.write_textless_vocoder(root / "textless",
                                                                   voc_cfg or CODEHIFIGAN_CFG))
    # on the card whisper-large-v3-turbo's and Llama-3.2-1B's widths, cut in
    # depth (ASR_ENCODER_LAYERS, TEXT_LM_LAYERS); on the CPU the tiny ones
    whisper = genppl_recipe.write_whisper_dir(
        root / "whisper", tiny=tiny, encoder_layers=None if tiny else ASR_ENCODER_LAYERS)
    llm_layers = genppl_recipe.LLAMA_TINY["num_hidden_layers"] if tiny else TEXT_LM_LAYERS
    llama = genppl_recipe.write_llama_dir(root / "llama", tiny=tiny, num_layers=llm_layers)
    gen_kw = [f"metric.generate_kwargs.max_new_tokens={max_new_tokens}",
              "+metric.generate_kwargs.seed=0"]
    prompts = f"{work / 'sblimp'}/*.wav"
    runs = {
        "sstorycloze": ["metric=sstorycloze", f"metric.data_path={stories}"],
        **{f"generate_{m or 'null'}": [
            "metric=generate", "vocoder=vocoder_hubert_25", f"metric.data_path={prompts}",
            f"metric.used_token_modality={m or 'null'}", f"metric.num_files={n_prompts}",
            *gen_kw, f"metric.out_path={root / ('generated_' + (m or 'null'))}"]
           for m in (None, "SPEECH", "TEXT")},
        "asr_perplexity": ["metric=asr_perplexity", "vocoder=vocoder_hubert_25",
                           f"metric.data_path={prompts}", f"metric.num_files={n_prompts}",
                           f"metric.whisper_model={whisper}", f"metric.llm_name_or_path={llama}",
                           *gen_kw, "metric.out_path=null"]}
    calls = {}
    patched = [(UnitLM, "log_likelihood"), (UnitLM, "generate"), (gm, "get_llm_perplexity")]
    originals = [getattr(o, n) for o, n in patched]

    def recorder(fn, label):
        def recorded(*args, **kwargs):
            out = fn(*args, **kwargs)
            calls.setdefault(label, []).append(out)
            return out
        return recorded

    metrics = {}
    for name, args in runs.items():
        calls.clear()
        for (owner, attr), fn in zip(patched, originals):
            setattr(owner, attr, recorder(fn, attr))
        for f, c in counters:      # the main path's count
            setattr(f, c, 0)
        try:
            t0 = time.perf_counter()
            res = cli_eval.eval_main([*common, *args])
            _sync(dev)
            seconds = time.perf_counter() - t0
        finally:
            for (owner, attr), fn in zip(patched, originals):
                setattr(owner, attr, fn)
        got = tuple(getattr(f, c) for f, c in counters)
        # the text LM scores through UnitLM.log_likelihood too, once a call
        n_text = len(calls.get("get_llm_perplexity", []))
        n_score = len(calls.get("log_likelihood", [])) - n_text
        n_gen = len(calls.get("generate", []))
        want = (n_layers * (n_score + n_gen), 0, llm_layers * n_text, 0) if on_card \
            else (0, 0, 0, 0)
        if name == "sstorycloze":
            lls = [x.float().cpu().numpy() for x in calls["log_likelihood"]]
            score, finite = res["StoryCloze"], all(np.isfinite(x).all() for x in lls)
            ok = finite and 0.0 <= score <= 1.0 and sum(x.size for x in lls) == 2 * n_stories
        elif name == "asr_perplexity":
            nll = [np.asarray(x) for x in calls["get_llm_perplexity"]]
            score = res["asr_perplexity"]
            finite = math.isfinite(score) and all(np.isfinite(x).all() for x in nll)
            ok = finite and score > 0 and sum(x.size for x in nll) == n_prompts
        else:
            outs = res["generate"]
            score = [len(g.split()) if isinstance(g, str) else int(np.size(g)) for g in outs]
            finite = all(isinstance(g, str) or np.isfinite(g).all() for g in outs)
            ok = finite and len(outs) == n_prompts and all(
                isinstance(g, str) == name.endswith("TEXT") for g in outs)
        metrics[name] = dict(score=score, finite=finite, seconds=seconds, launches=got,
                             scoring_calls=n_score, generate_calls=n_gen, text_lm_calls=n_text)
        print(f"cli.eval {name} through the interleaving tokeniser on the stock checkpoint: "
              f"{score}; every score finite: {finite}; {n_score} scoring, {n_gen} generate, "
              f"{n_text} text-LM calls; {seconds:.1f} s with the loads; launches (bf16 fwd, bf16 "
              f"bwd, f32 fwd, f32 bwd) {got} (predicted {want}) on {smi}", flush=True)
        _require(ok, f"cli.eval {name} gave {score} (finite: {finite})")
        _require(got == want and n_score + n_gen >= 1,
                 f"cli.eval {name} launched {got}, predicted {want}")
        count(got)
    CHECKPOINT_MANAGER.set_root(textless_root)
    _drop(root)
    seconds = time.perf_counter() - phase_start
    print(f"phase 16: {seconds:.1f} s in all; launches {launches}", flush=True)
    return dict(result, metrics=metrics, launches=launches, seconds=seconds)


# phase 18: config/model/slam_dh128.yaml through `cli.train`, the Slam
# recipe's overrides as phase 9 passes them; its accumulation is cut from the
# recipe's 16 to 4 (DH128_CUTS)
DH128_CUTS = ("training_args.gradient_accumulation_steps: 16 -> 4 (2 steps of 4 x [8, 1024])",)


def run_dh128_training(dev, smi: str, work: pathlib.Path, model_overrides=(), n_rows: int = 400,
                       lengths=(100, 1001), context: int = 1024, batch: int = 8,
                       accum: int = 4, steps: int = 2, cpu_batch: int = 2,
                       cpu_context: int = 256) -> dict:
    """Phase 18, in phase 9's work directory: `cli.train model=slam_dh128`
    (the Slam recipe's decoder re-headed from 14 x 64 to 7 x 128 with one kv
    head: 24 layers, context 1024, bf16, full remat, bf16 moments) at full
    width and depth on a seeded Markov corpus, `steps` steps of `accum` x
    `batch` with a save every step, and a run resumed from checkpoint-1
    whose last loss equals the uninterrupted run's bit for bit. Every
    microbatch launches the flash backward once a layer and the forward
    twice (remat): at d = 128 the backward's warp-specialised dK / dV
    kernel. Then one packed [`cpu_batch`, `cpu_context`] microbatch of the
    corpus, loss and every gradient in bf16 on the card against float32 on
    the CPU on the same weights (phase 7's check and bounds). Prints seconds
    a step, non-pad tokens/s and `max_memory_allocated`. On the CPU (a
    rehearsal at narrow widths, `model_overrides`) no launch may be
    counted."""
    from slamkit_tpu_torch.cli import train as cli_train
    from slamkit_tpu_torch.models import UnitLMConfig
    from slamkit_tpu_torch.models.unit_lm import CONFIG_NAME
    from slamkit_tpu_torch.ops import flash_attention_bwd, flash_attention_fwd
    from slamkit_tpu_torch.tools.slam_recipe import write_markov_corpus
    from slamkit_tpu_torch.trainer import SLAMTrainer

    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()
    counters = ((flash_attention_fwd, "launches"), (flash_attention_bwd, "launches"))
    nonpad = lambda tr, group: sum(int((mb["segment_ids"] >= 0).sum()) for mb in group)
    logged = lambda state, key: [r[key] for r in state.log_history if key in r]
    tokens = work / "dh128_tokens.jsonl"
    write_markov_corpus(tokens, n_rows, lengths, seed=4)
    args = ["model=slam_dh128", f"model.context_len={context}", *model_overrides,
            f"data.train_path={tokens}", "data.val_path=null", "data.packing=true",
            f"training_args.max_steps={steps}",
            f"training_args.per_device_train_batch_size={batch}",
            f"training_args.gradient_accumulation_steps={accum}",
            "training_args.remat=true", "training_args.optim_state_dtype=bfloat16",
            "training_args.save_steps=1", "training_args.logging_steps=1",
            *([] if on_card else ["training_args.use_cpu=true"])]
    out, resumed = work / "dh128_run", work / "dh128_resumed"
    first = _cli_run(dev, cli_train.train, SLAMTrainer,
                     [*args, f"training_args.output_dir={out}"], nonpad, counters)
    again = _cli_run(dev, cli_train.train, SLAMTrainer,
                     [*args, f"training_args.output_dir={resumed}",
                      f"cont_training={out / 'checkpoint-1'}"], nonpad, counters)
    L = first["n_layers"]
    for what, rec, n_steps in (("slam_dh128", first, steps),
                               ("slam_dh128 resumed", again, steps - 1)):
        bwd = n_steps * accum * L if on_card else 0
        losses = logged(rec["state"], "loss")
        print(f"{what} (cli.train model=slam_dh128; cut: {'; '.join(DH128_CUTS)}): "
              f"{rec['state'].global_step} steps of {accum} x [{batch}, {context}] "
              f"({rec['dtype']}, {L} layers, remat {rec['remat']}), losses {losses}; seconds a "
              f"step {rec['seconds']}, non-pad tokens/s {rec['tokens_per_s']}, "
              f"{rec['wall_s']:.1f} s the whole call; launches (fwd, bwd) {rec['launches']} "
              f"(a step {rec['step_launches']}; backward expected {bwd}); "
              f"max_memory_allocated {rec['max_memory_allocated']} B; on {smi}", flush=True)
        _require(rec["state"].global_step == steps and len(rec["seconds"]) == n_steps
                 and len(losses) == steps and all(math.isfinite(x) for x in losses)
                 and rec["remat"], f"{what} did not take {n_steps} finite remat steps: {losses}")
        _require(rec["launches"] == ((2 * bwd, bwd) if on_card else (0, 0)),
                 f"{what} launched (fwd, bwd) {rec['launches']}, not ({2 * bwd}, {bwd}): the "
                 f"backward once a layer a microbatch, the forward twice")
    pair = (logged(first["state"], "loss")[-1], logged(again["state"], "loss")[-1])
    print(f"slam_dh128 resumed from checkpoint-1: step {steps} loss {pair[1]} against "
          f"{pair[0]}", flush=True)
    _require(pair[0] == pair[1], f"the resumed slam_dh128 run does not repeat step {steps} "
             f"bit for bit: {pair}")
    cfg = UnitLMConfig.from_dict(json.loads((out / "checkpoint-1" / CONFIG_NAME).read_text()))
    _drop(out, resumed)
    for rec in (first, again):
        rec.pop("first_microbatch")
        _free(dev)
    cpu = check_card_vs_cpu(dev, work, cfg=cfg, batch=cpu_batch, context=cpu_context,
                            tokens=tokens)
    seconds = time.perf_counter() - t_phase
    print(f"phase 18 (slam_dh128): {seconds:.1f} s", flush=True)
    return dict(cuts=list(DH128_CUTS), layers=L, losses=logged(first["state"], "loss"),
                resumed_loss=pair[1], step_seconds=first["seconds"],
                resumed_step_seconds=again["seconds"], tokens_per_s=first["tokens_per_s"],
                launches=list(first["launches"]), step_launches=first["step_launches"],
                resumed_launches=list(again["launches"]),
                max_memory_allocated=first["max_memory_allocated"],
                wall_s=first["wall_s"], resumed_wall_s=again["wall_s"], card_vs_cpu=cpu,
                seconds=seconds)


# phase 17: the ring's 'seq' group as the multi-card leg runs it at N = 4
RING_N = 4
# ... and at the local heads of the ('data', 'model', 'seq') mesh [1, 2, 2]
# (the tp_seq leg): the Slam batch's 14/2 heads over 'model' = 2, the
# sequence over 'seq' = 2
TP_SEQ_SHAPE, TP_SEQ_N = (8, 7, 1, 1024, 64), 2
# ... and on a host of two or more cards, tools/parallel_smoke.py's legs in
# five torchrun calls of at most 900 s each (on four or more, then
# tools/multinode.py's two torchrun nodes within another 900 s)
PARALLEL_CALLS = ("meshes,dpo,eval", "fsdp,sims7b", "tp,tp_eval,tp_sims7b",
                  "tp_fsdp,tp_fsdp_sims7b", "tp_seq")
PARALLEL_LEGS = tuple(leg for call in PARALLEL_CALLS for leg in call.split(","))


def _ring_errors(got, want, f32: bool, terms: int) -> dict:
    """max |ring - reference| of out, lse (rows that see a key), dq, dk, dv
    and each one's bound: the forward's as phase 3 / 3e, the gradients'
    twice phase 3b / 3f's (the ring adds n partial gradients, each rounded
    to its dtype by the kernel, where one call rounds once)."""
    out, lse, *grads = got
    w_out, w_lse, *w_grads = want
    alive = w_lse < 1e30
    errs = {"out": ((out.float() - w_out.float()).abs().max().item(),
                    F32_OUT_BOUND if f32 else OUT_BOUND),
            "lse": ((lse - w_lse)[alive].abs().max().item(),
                    F32_LSE_BOUND if f32 else LSE_BOUND)}
    for name, a, w in zip(("dq", "dk", "dv"), grads, w_grads):
        top = w.float().abs().max().item()
        rel = F32_BWD_FACTOR * F32_EPS * math.sqrt(terms) if f32 else BWD_REL_BOUND
        errs[name] = ((a.float() - w.float()).abs().max().item(), 2 * rel * top + 1e-5)
    return errs


def run_ring_kernels(dev, shape=(8, 14, 2, 1024, 64), tp_shape=None) -> dict:
    """Phase 17: the ring's kernel sequence (`ops/ring_attention.py`) on this
    card at the Slam shape, its sequence cut into RING_N = 4 chunks of 256
    (zigzag: halves of 128), then in bf16 at `tp_shape` (main passes
    TP_SEQ_SHAPE: a rank's heads on the ('data', 'model', 'seq') mesh [1, 2,
    2]) cut into TP_SEQ_N = 2 chunks (`ring_sequence`). Where the host has
    two or more cards, `tools/parallel_smoke.py` runs on all of them (an even
    count) under torchrun, in the five calls of PARALLEL_CALLS; on one card
    a line says they are not run. Returns the launches of the ring runs by
    kernel, the checks, the times and the multi-card leg's result."""
    import subprocess

    import torch

    t0 = time.perf_counter()
    launches, checks, calls = ring_sequence(dev, shape, RING_N, (False, True))
    if tp_shape is not None:
        tp_launches, tp_checks, tp_calls = ring_sequence(dev, tp_shape, TP_SEQ_N, (False,),
                                                         label="tp_seq ")
        launches = {k: v + tp_launches[k] for k, v in launches.items()}
        checks, calls = checks + tp_checks, calls + tp_calls
    seconds = time.perf_counter() - t0
    print(f"phase 17: the ring's kernels on one device in {seconds:.1f} s; launches "
          f"{launches}", flush=True)
    result = {"launches": launches, "checks": checks, "calls": calls, "seconds": seconds}
    if dev.type != "cuda":
        return result
    torch.cuda.empty_cache()
    cards = torch.cuda.device_count()
    if cards < 2:
        print(f"phase 17: {cards} card on this host: the multi-card legs of "
              f"tools/parallel_smoke.py ({', '.join(PARALLEL_LEGS)}: the data and 'seq' meshes, "
              f"DPO, evaluation, fsdp, tensor parallelism over 'model', tensor parallelism "
              f"with fsdp over 'data' on one mesh, SIMS at Qwen2.5-7B's widths on fsdp, "
              f"on 'model' and on both, and tensor parallelism beside the ring over 'seq') "
              f"need two or "
              f"more (NCCL takes one card a rank), and tools/multinode.py's two torchrun "
              f"nodes of two cards (training_args.multihost=true) need four; none is run",
              flush=True)
        return result
    n = cards - cards % 2
    result["parallel_smoke"] = {}
    for legs in PARALLEL_CALLS:   # five calls, each within its own limit
        t1 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "torch.distributed.run",
                               "--nproc_per_node", str(n), "-m",
                               "slamkit_tpu_torch.tools.parallel_smoke", "--legs", legs],
                              cwd=ROOT, capture_output=True, text=True, timeout=900)
        print(proc.stdout[-6000:], flush=True)
        _require(proc.returncode == 0, f"tools/parallel_smoke.py --legs {legs} on {n} cards "
                 f"failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
        result["parallel_smoke"][legs] = json.loads(proc.stdout.strip().splitlines()[-1])
        print(f"phase 17: tools/parallel_smoke.py --legs {legs} on {n} cards in "
              f"{time.perf_counter() - t1:.1f} s", flush=True)
    if cards < 4:
        print(f"phase 17: {cards} cards on this host: tools/multinode.py's two torchrun nodes "
              f"of two cards need four and are not run", flush=True)
        return result
    t1 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "slamkit_tpu_torch.tools.multinode"],
                          cwd=ROOT, capture_output=True, text=True, timeout=900)
    print(proc.stdout[-8000:], flush=True)
    _require(proc.returncode == 0, f"tools/multinode.py failed ({proc.returncode}):\n"
             f"{proc.stderr[-4000:]}")
    result["multinode"] = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"phase 17: tools/multinode.py (two torchrun nodes of two cards) in "
          f"{time.perf_counter() - t1:.1f} s", flush=True)
    return result


def ring_sequence(dev, shape, n: int, f32s=(False, True), label: str = "") -> tuple:
    """The ring's kernel sequence on this card at `shape` ([B, H/Hkv, T, D]
    as (B, H, Hkv, T, D)), its sequence cut into `n` chunks (zigzag: halves
    of them): for both schedules, in bf16 and (with True in `f32s`) float32,
    `ring_on_one_device` runs every rank's steps (the causal diagonal call;
    the non-causal off-diagonal calls between a query chunk and an earlier
    key chunk, with their distinct q / k segment ids and their dead rows;
    `merge_pair`; the backward of every pair from the global merged out and
    LSE), rotating in memory instead of over NCCL. Its out, LSE and
    gradients are held to one kernel call over the whole sequence and to the
    plain version. Each of the ring's call shapes is then timed alone
    (graph ms beside its bound, the plain version and SDPA). Returns (the
    launches of the ring runs by kernel, the checks, the calls' times); the
    rows carry `label` and `n`. On the CPU (a rehearsal at a small `shape`)
    the plain versions run every step, no launch may be counted, and
    nothing is timed."""
    import torch

    from slamkit_tpu_torch.ops import (flash_attention_bwd, flash_attention_fwd, mha_reference,
                                       mha_reference_bwd)
    from slamkit_tpu_torch.ops.ring_attention import ring_on_one_device, zigzag_permutation

    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    b, h, hkv, t, d = shape
    c = t // n
    rng = np.random.default_rng(17)
    seg_np = _packed_segments(rng, b, t, 8)
    seg = torch.from_numpy(seg_np).to(dev)
    launches = {"flash_fwd": 0, "flash_bwd": 0, "flash_fwd_f32": 0, "flash_bwd_f32": 0}
    expect = ({"contiguous": n * (n + 1) // 2, "zigzag": n * (2 * n - 1)}
              if cuda else {"contiguous": 0, "zigzag": 0})
    checks, calls = [], []
    with torch.inference_mode():
        for f32 in f32s:
            dtype = torch.float32 if f32 else torch.bfloat16
            g = torch.Generator(device=dev).manual_seed(1700 + f32)
            mk = lambda hh: torch.randn((b, hh, t, d), generator=g, device=dev).to(dtype)
            q, k, v, do = mk(h), mk(hkv), mk(hkv), mk(h)
            out, lse = flash_attention_fwd(q, k, v, segment_ids=seg)
            kernel = (out, lse, *flash_attention_bwd(q, k, v, out, lse, do, segment_ids=seg))
            p_out, p_lse = mha_reference(q.float(), k.float(), v.float(), segment_ids=seg)
            plain = (p_out, p_lse, *mha_reference_bwd(q.float(), k.float(), v.float(), seg,
                                                       None, p_out, p_lse, do.float()))
            fwd_key, bwd_key = (("flash_fwd_f32", "flash_bwd_f32") if f32
                                else ("flash_fwd", "flash_bwd"))
            counter = "f32_launches" if f32 else "launches"
            for schedule in ("contiguous", "zigzag"):
                order = zigzag_permutation(t, n) if schedule == "zigzag" else np.arange(t)
                idx = torch.from_numpy(order).to(dev)
                perm = lambda x, dim=2: x.index_select(dim, idx).contiguous()
                args = (perm(q), perm(k), perm(v), perm(seg, 1), perm(do), n, schedule)
                f0, b0 = getattr(flash_attention_fwd, counter), getattr(flash_attention_bwd,
                                                                        counter)
                got = ring_on_one_device(*args)
                n_fwd = getattr(flash_attention_fwd, counter) - f0
                n_bwd = getattr(flash_attention_bwd, counter) - b0
                launches[fwd_key] += n_fwd
                launches[bwd_key] += n_bwd
                sync()
                terms = (h // hkv) * t
                # every output ([B, H, T, D], LSE [B, H, T]) has time at dim 2
                vs_kernel = _ring_errors(got, [perm(x) for x in kernel], f32, terms)
                vs_plain = _ring_errors(got, [perm(x) for x in plain], f32, terms)
                ms = _cuda_ms(lambda: ring_on_one_device(*args), warmup=1, iters=3) if cuda else 0.0
                ok = (all(e <= bd for e, bd in (*vs_kernel.values(), *vs_plain.values()))
                      and n_fwd == n_bwd == expect[schedule]
                      and all(bool(torch.isfinite(x).all().item()) for x in got))
                row = dict(dtype=str(dtype)[6:], schedule=schedule, n=n, chunk=c, heads=[h, hkv],
                           launches={"forward": n_fwd, "backward": n_bwd},
                           expected_launches=expect[schedule], ms=ms,
                           vs_kernel={k_: e for k_, (e, _) in vs_kernel.items()},
                           vs_plain={k_: e for k_, (e, _) in vs_plain.items()},
                           bounds={k_: bd for k_, (_, bd) in vs_plain.items()}, ok=ok)
                checks.append(row)
                print(f"{label}ring {row['dtype']} {schedule} [{b},{h}/{hkv},{t},{d}] n={n} chunk "
                      f"{c}: {n_fwd} forward and "
                      f"{n_bwd} backward launches (expected {expect[schedule]} each); vs one "
                      f"kernel call " + " ".join(f"|{k_}|={e:.3e}" for k_, (e, _) in
                                                 vs_kernel.items())
                      + "; vs plain " + " ".join(f"|{k_}|={e:.3e} (<= {bd:.3e})" for k_, (e, bd)
                                                 in vs_plain.items())
                      + f"; all ranks' forward + backward {ms:.3f} ms eager  "
                      f"{'ok' if ok else 'FAIL'}", flush=True)
                _require(ok, f"the {label}{row['dtype']} {schedule} ring disagrees with one call "
                         f"or the plain version, or launched other kernels than its schedule")
                del got
            if not cuda:
                continue
            # each of the ring's call shapes alone: the diagonal (causal, chunk
            # 0), an off-diagonal pair (non-causal, query chunk 1 against key
            # chunk 0: distinct ids, some dead rows), a zigzag half-pair
            # (logical halves 1 against 0)
            for name, (qs, ks), causal in (("diagonal", (slice(0, c), slice(0, c)), True),
                                           ("off_diagonal", (slice(c, 2 * c), slice(0, c)),
                                            False),
                                           ("zigzag_half", (slice(c // 2, c), slice(0, c // 2)),
                                            False)):
                qq, kk, vv, dd = (x[:, :, sl].contiguous() for x, sl in
                                  ((q, qs), (k, ks), (v, ks), (do, qs)))
                qseg, kseg = seg[:, qs].contiguous(), seg[:, ks].contiguous()
                tl = qq.shape[2]
                for backward in (False, True):
                    o, l = flash_attention_fwd(qq, kk, vv, segment_ids=qseg, causal=causal,
                                               kv_segment_ids=kseg)
                    if backward:
                        run = lambda: flash_attention_bwd(qq, kk, vv, o, l, dd, segment_ids=qseg,
                                                          kv_segment_ids=kseg, causal=causal)
                        plain_call = lambda: mha_reference_bwd(
                            qq.float(), kk.float(), vv.float(), qseg, kseg, o.float(), l,
                            dd.float(), causal=causal)
                        library_ms, timed = _sdpa_backward_ms(qq, kk, vv, dd, qseg, kseg,
                                                              causal)
                    else:
                        run = lambda: flash_attention_fwd(qq, kk, vv, segment_ids=qseg,
                                                          causal=causal, kv_segment_ids=kseg)
                        plain_call = lambda: mha_reference(
                            qq.float(), kk.float(), vv.float(), segment_ids=qseg, causal=causal,
                            kv_segment_ids=kseg)
                        sdpa = _sdpa_library(qq, kk, vv, qseg, kseg, causal)
                        library_ms, timed = ((None, NO_SDPA) if sdpa is None else
                                             _library_ms(lambda: sdpa[0](qq, sdpa[1], sdpa[2]),
                                                         20))
                    cost = flash_cost((b, h, hkv, tl, d), qseg.cpu().numpy(),
                                      kseg.cpu().numpy(), causal, backward=backward,
                                      elt_bytes=4 if f32 else 2)
                    bound, bound_by = bound_ms(*cost, flops_per_s=FP32_3XTF32_FLOPS_PER_S
                                               if f32 else BF16_FLOPS_PER_S)
                    device_ms, plain_ms = _graph_ms(run, 20), _graph_ms(plain_call, 2)
                    share, vs_library = _ratios(device_ms, bound, library_ms)
                    dead = int((l >= 1e30).sum().item())
                    calls.append(dict(name=label + name, dtype=str(dtype)[6:], causal=causal,
                                      backward=backward, shape=[b, h, hkv, tl, d],
                                      dead_rows=dead, graph_ms=device_ms,
                                      plain_graph_ms=plain_ms, bound_ms=bound,
                                      bound_by=bound_by, library_ms=library_ms,
                                      library=timed, roofline_share=share,
                                      vs_library=vs_library))
                    print(f"{label}ring call {name} {str(dtype)[6:]} "
                          f"{'backward' if backward else 'forward'}"
                          f" [{b},{h}/{hkv},{tl},{d}] causal={causal} ({dead} dead rows of "
                          f"{b * h * tl}): graph {device_ms:.4f} ms, plain {plain_ms:.4f} ms, "
                          f"{_library_text(library_ms, timed, vs_library)}; bound {bound:.4f} "
                          f"ms by {bound_by}, roofline_share {share:.3f}", flush=True)
            del q, k, v, do, kernel, plain
    return launches, checks, calls


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
    from slamkit_tpu_torch.ops.flash_attention import (KERNEL, KERNEL_BWD, KERNEL_BWD_F32,
                                                       KERNEL_F32)
    from slamkit_tpu_torch.ops.matmul_probe import KERNEL as PROBE_KERNEL
    from slamkit_tpu_torch.ops.quant import KERNEL as DQ_KERNEL

    t0 = time.perf_counter()
    names = (KERNEL, KERNEL_BWD, DQ_KERNEL, PROBE_KERNEL, KERNEL_F32, KERNEL_BWD_F32)
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
        f32_bwd_rows = check_backward_kernels(dev, f32=True)
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
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        f32_train_result = run_f32_training(dev, smi, pathlib.Path(work))
        print(f"phase 13: {time.perf_counter() - t0:.1f} s", flush=True)
        torch.cuda.empty_cache()
        data_result = run_data_path(dev, smi, pathlib.Path(work))
        torch.cuda.empty_cache()
        settings_result = run_training_settings(dev, smi, pathlib.Path(work))
        torch.cuda.empty_cache()
        defaults_result = run_sims_defaults(dev, smi, pathlib.Path(work))
        torch.cuda.empty_cache()
        dh128_result = run_dh128_training(dev, smi, pathlib.Path(work))
    torch.cuda.empty_cache()
    ring_result = run_ring_kernels(dev, tp_shape=TP_SEQ_SHAPE)
    ring_launches = ring_result["launches"]
    speech_runs = speech_result["runs"]
    defaults_launches = defaults_result["launches"]
    dh128_fwd, dh128_bwd = (a + b for a, b in zip(dh128_result["launches"],
                                                  dh128_result["resumed_launches"]))

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
    # ... and the float32 backward at phase 13's Slam batch
    f32_bwd = next(r for r in f32_bwd_rows if r["name"] == "slam_f32")
    genppl_runs = genppl_result["runs"].values()
    f32_launches = f32_train_result["launches"]
    print(json.dumps({"shapes": kernel_rows, "backward_shapes": backward_rows,
                      "dq_shapes": dq_rows, "probe": probe_result, "f32_shapes": f32_rows,
                      "slice": slice_result, "training": train_result,
                      "card_vs_cpu": cpu_result, "speech": speech_result,
                      "cli": cli_result, "dpo": dpo_result, "sims": sims_result,
                      "genppl": genppl_result, "f32_backward_shapes": f32_bwd_rows,
                      "f32_training": f32_train_result, "data_path": data_result,
                      "training_settings": settings_result,
                      "sims_defaults": defaults_result, "ring": ring_result,
                      "slam_dh128": dh128_result}), flush=True)
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
                   + sum(r["launches"]["flash_fwd"] for r in genppl_runs)
                   + data_result["launches"]["flash_fwd"]
                   + settings_result["launches"]["flash_fwd"] + defaults_launches["flash_fwd"]
                   + ring_launches["flash_fwd"] + dh128_fwd,
                   max(r["max_abs_err_out"] for r in kernel_rows), score),
        kernel_row("flash_bwd", "slamkit_tpu_torch/ops/csrc/flash_bwd.cu",
                   "slamkit_tpu/ops/flash_attention.py:247",
                   ["flash_bwd_prep_kernel",
                    "flash_bwd_dkdv_kernel | flash_bwd_dkdv128_kernel", "flash_bwd_dq_kernel"],
                   train_result["launches"]["flash_bwd"]
                   + cli_result["train_launches"]["flash_bwd"]
                   + dpo_result["launches"]["flash_bwd"]
                   + sims_result["train_launches"]["flash_bwd"]
                   + data_result["launches"]["flash_bwd"]
                   + settings_result["launches"]["flash_bwd"] + defaults_launches["flash_bwd"]
                   + ring_launches["flash_bwd"] + dh128_bwd,
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
        dict(kernel_row("flash_fwd_f32", "slamkit_tpu_torch/ops/csrc/flash_fwd_f32.cu",
                        "slamkit_tpu/ops/flash_attention.py:124", ["flash_fwd_f32_kernel"],
                        sum(r["launches"]["flash_fwd_f32"] for r in genppl_runs)
                        + f32_launches["flash_fwd_f32"] + defaults_launches["flash_fwd_f32"]
                        + ring_launches["flash_fwd_f32"],
                        max(r["max_abs_err_out"] for r in f32_rows), f32),
             cuda_core_bound_ms=f32["cuda_core_bound_ms"],
             tp2_slam_f32=shape_entry(next(r for r in f32_rows
                                           if r["name"] == "tp2_slam_f32"))),
        dict(kernel_row("flash_bwd_f32", "slamkit_tpu_torch/ops/csrc/flash_bwd_f32.cu",
                        "slamkit_tpu/ops/flash_attention.py:247",
                        ["flash_bwd_f32_prep_kernel", "flash_bwd_f32_dkdv_kernel",
                         "flash_bwd_f32_dq_kernel"],
                        f32_launches["flash_bwd_f32"] + defaults_launches["flash_bwd_f32"]
                        + ring_launches["flash_bwd_f32"],
                        max(max(r["max_abs_err"].values()) for r in f32_bwd_rows), f32_bwd),
             cuda_core_bound_ms=f32_bwd["cuda_core_bound_ms"])]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
