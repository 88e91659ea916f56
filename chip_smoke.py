#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training slices once on an NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card (an H100 for
the sm_90a kernels). Phases, in order; any failure exits non-zero:

  1. device  — require CUDA; print the card, its power limit and versions;
               switch TF32 off for float32 matmuls.
  2. build   — compile the CUDA kernels from `slamkit_tpu_torch/ops/csrc`,
               one nvcc per source, all started together.
  3. kernels — the flash-attention forward kernel against its plain PyTorch
               version (float32 from the same bf16 inputs) at the slices'
               shapes, each timed twice between CUDA events: as eager calls,
               and as a CUDA-graph replay (device time without the host's
               overhead).
  3b. backward kernels — the flash backward (dq, dk, dv) against its plain
               version the same way, at the training shapes.
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

Each main path runs with the launch counters zeroed just before it and read
just after: every scoring forward and every generation prefill launches the
forward kernel once per layer (phases 4-5); every training microbatch
launches it twice per layer (forward and remat recompute) and the backward
kernel once per layer (phase 6). The last lines are a JSON object with every
measurement, the card's name and power limit, a JSON object describing each
kernel, and `{"ok": true, "device": {...}}`.
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


def _right_padded(rng, b, t):
    """[b, t] ids as log_likelihood builds them: 0 on each request, -1 on
    its right pads."""
    seg = np.full((b, t), -1, np.int32)
    for r in range(b):
        seg[r, :int(rng.integers(100, t + 1))] = 0
    return seg


def _left_padded(rng, b, t):
    seg = np.zeros((b, t), np.int32)
    for r in range(b):
        seg[r, :int(rng.integers(0, t * 2 // 3))] = -1
    return seg


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
        ms = _cuda_ms(run, warmup=3, iters=20)
        plain_ms = _cuda_ms(plain, warmup=1, iters=5)
        device_ms, plain_device_ms = _graph_ms(run, 20), _graph_ms(plain, 3)
        ok = err_out <= OUT_BOUND and err_lse <= LSE_BOUND and dead_ok
        if name == "dead_rows":
            ok = ok and n_dead == b * h * 40
        results.append(dict(name=name, shape=[b, h, hkv, t, d], causal=causal,
                            max_abs_err_out=err_out, max_abs_err_lse=err_lse,
                            dead_rows=n_dead, ms=ms, plain_ms=plain_ms,
                            device_ms=device_ms, plain_device_ms=plain_device_ms, ok=ok))
        print(f"kernel {name:16s} [{b},{h}/{hkv},{t},{d}] causal={causal}: "
              f"|dout|={err_out:.3e} (<= {OUT_BOUND}) |dlse|={err_lse:.3e} "
              f"(<= {LSE_BOUND}) dead={n_dead} dead_ok={dead_ok}  eager: kernel "
              f"{ms:.4f} ms plain {plain_ms:.4f} ms; graph: kernel {device_ms:.4f} ms "
              f"plain {plain_device_ms:.4f} ms  {'ok' if ok else 'FAIL'}", flush=True)
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


def check_backward_kernels(dev) -> list[dict]:
    """Phase 3b: the backward kernel against the plain backward at the
    training shapes: the Slam batch (8 packed segments and a -1 tail), a
    ragged T, d = 128 (config/model/slam_dh128.yaml), the SIMS context 2048
    (config/train_inter_scale.yaml), and dead rows."""
    import torch

    from slamkit_tpu_torch.ops import flash_attention_bwd, flash_attention_fwd, mha_reference_bwd

    rng = np.random.default_rng(2)
    cases = [
        ("slam_ctx1024", (8, 14, 2, 1024, 64), _packed_segments(rng, 8, 1024, 8)),
        ("odd_T1000", (8, 14, 2, 1000, 64), _packed_segments(rng, 8, 1000, 8)),
        ("d128_ctx1024", (8, 7, 1, 1024, 128), _packed_segments(rng, 8, 1024, 8)),
        ("sims_ctx2048", (4, 14, 2, 2048, 64), _packed_segments(rng, 4, 2048, 8)),
        ("dead_rows", (2, 14, 2, 256, 64), None),
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
        ok = all(e <= bound and row <= 1 for _, e, bound, row in errs) and dead_ok and all(
            bool(torch.isfinite(x).all().item()) for x in got)
        results.append(dict(name=name, shape=[b, h, hkv, t, d],
                            max_abs_err={n: e for n, e, _, _ in errs},
                            bound={n: bd for n, _, bd, _ in errs},
                            worst_row_over_bound={n: r for n, _, _, r in errs},
                            ms=ms, plain_ms=plain_ms, device_ms=device_ms,
                            plain_device_ms=plain_device_ms, ok=ok))
        print(f"backward {name:14s} [{b},{h}/{hkv},{t},{d}]: "
              + " ".join(f"|{n}|={e:.3e} (<= {bd:.3e}) row {r:.3f} (<= 1)"
                         for n, e, bd, r in errs)
              + f" dead_ok={dead_ok}  eager: kernel {ms:.4f} ms plain {plain_ms:.4f} ms; "
              f"graph: kernel {device_ms:.4f} ms plain {plain_device_ms:.4f} ms  "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        del got, want
        _require(ok, f"the flash backward kernel disagrees with the plain version at {name}")
    return results


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
    cpu = UnitLM.from_pretrained(str(work / "card_vs_cpu"), torch_dtype="float32")
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

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        libs = list(pool.map(_build.build, (KERNEL, KERNEL_BWD)))
    print(f"built {', '.join(str(lib.relative_to(ROOT)) for lib in libs)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for lib in libs:
        print((lib.parent / "build.log").read_text().strip(), flush=True)

    with torch.inference_mode():
        kernel_rows = check_kernels(dev)
        backward_rows = check_backward_kernels(dev)
    torch.cuda.empty_cache()
    slice_result = run_slice(dev, smi)
    _require(slice_result["launches"] > 0, "the main path never launched the flash kernel")
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as work:
        train_result = run_training(dev, smi, work=pathlib.Path(work))
        torch.cuda.empty_cache()
        cpu_result = check_card_vs_cpu(dev, pathlib.Path(work))

    score = next(r for r in kernel_rows if r["name"] == "score_ctx1024")
    bwd = next(r for r in backward_rows if r["name"] == "slam_ctx1024")
    print(json.dumps({"shapes": kernel_rows, "backward_shapes": backward_rows,
                      "slice": slice_result, "training": train_result,
                      "card_vs_cpu": cpu_result}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"kernels": [
        {"name": "flash_fwd", "route": "cuda",
         "source": "slamkit_tpu_torch/ops/csrc/flash_fwd.cu",
         "replaces": "slamkit_tpu/ops/flash_attention.py:124",
         "launches": slice_result["launches"] + train_result["launches"]["flash_fwd"],
         "max_abs_err": max(r["max_abs_err_out"] for r in kernel_rows),
         "ms": score["ms"], "plain_ms": score["plain_ms"]},
        {"name": "flash_bwd", "route": "cuda",
         "source": "slamkit_tpu_torch/ops/csrc/flash_bwd.cu",
         "replaces": "slamkit_tpu/ops/flash_attention.py:247",
         "launches": train_result["launches"]["flash_bwd"],
         "max_abs_err": max(max(r["max_abs_err"].values()) for r in backward_rows),
         "ms": bwd["ms"], "plain_ms": bwd["plain_ms"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
