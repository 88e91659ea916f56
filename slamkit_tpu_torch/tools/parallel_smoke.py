"""The Slam recipe on several cards: the mesh's data and sequence axes.

    python -m torch.distributed.run --nproc_per_node N -m slamkit_tpu_torch.tools.parallel_smoke \
        [--legs meshes,dpo,eval]

Each of the N (>= 2, even) ranks joins NCCL on its own card
(`parallel.init_distributed`) and, rank 0 first, builds the flash kernels.
Rank 0 then trains the reference: the global batch (8 packed rows of 1024,
2 microbatches a step) on its card alone. Then every rank trains the Slam
recipe at full width (`tools/slam_recipe.py`: bf16, full remat, random
weights from seed 0) through `SLAMTrainer.train()` on four meshes, each for
4 steps of the same global batch:

  * dp: `mesh_shape [N]` (data parallel);
  * cp_contiguous / cp_zigzag: `[1, N]` over ('data', 'seq'), the ring in
    each schedule (chunks of 1024 / N: 256 at N = 4, zigzag halves of 128);
  * dp_cp: `[2, N / 2]`.

For each it holds step 1's loss and global gradient norm to the one-card
reference (bf16 on both sides; bounds below), the ring's forward and
backward on every rank's chunk to one flash call over the whole sequence
on its card (the CP meshes), the flash launches of every rank to what the
schedule makes, and a resume: a second trainer from checkpoint-3 repeats
step 4's loss and weights bit for bit. It prints per mesh tokens/s and the
time of a step (host clock over steps 2-3, after a synchronise), and, from
`torch.profiler` on rank 0 over one more step, the share of the step's wall
time that NCCL's send / receive kernels (the ring's P2P) and all-reduce
kernels (gradients, loss, the trainer's agreement flags) run, beside the
one-card reference's step time and DP's scaling efficiency.

Then the two other stages users run on several cards, on `mesh_shape [N]`:

  * dpo: `SLAMDPOTrainer` at the Slam widths (full remat) on 16 preference
    pairs a step of phase 10's shape (prompt 101 + completion 51 = 152
    tokens, `tools/slam_recipe.py::write_preference_rows`), 3 steps with a
    save at step 2, against rank 0's one-card run of the same global
    batches: step 1's loss and gradient norm and step 2's loss within the
    training bounds, the flash launches of every rank (72 forward and 24
    backward a step), and a resume from checkpoint-2 that repeats step 3
    bit for bit; s a step and pairs/s (step 2, host clock: step 1 warms up,
    and the save follows step 2) and the NCCL shares of one profiled step;
  * eval: `UnitLM.shard` (what `cli.eval eval_mesh=N` runs) at the Slam
    widths: sBLIMP-sized scoring, 64 pairs of 100-1024 units in batches of
    10 rows (the last rank holds pad rows), against rank 0's unsharded
    scores; then 8 prompts of 50-75 units through `generate` (150 new
    tokens) greedy, int8 greedy and sampled: the greedy runs bit for bit
    against rank 0 decoding each rank's rows alone on its card (what a rank
    computes), the sampled run beside one card's; seconds, pairs/s and new
    tokens/s (host clock, unprofiled), and the NCCL all-gather share of one
    more sampled call under the profiler.

`--legs` runs a subset of the three (meshes, dpo, eval; default all). The
last line is one JSON object of all of it; any failed check exits 1. It
imports only the port.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import pathlib
import shutil
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[2]
ROWS, CONTEXT, MICRO, STEPS = 8, 1024, 2, 4
# step 1 on the mesh against the one-card run of the same global batch,
# bf16 compute on both: the ring merges partial attentions in float32 and
# the all-reduce sums float32 gradients in another order than one card, so
# they differ by bf16 roundings of activations (~3 digits), averaged over
# the step's ~16k tokens: the loss (~6.2 nats) within 5e-3 nats, the global
# gradient norm within 1e-2 of the reference's
LOSS_BOUND, GRAD_NORM_RTOL = 5e-3, 1e-2
# DPO: 16 pairs of 152 tokens a step, and the evaluation's scoring
DPO_PAIRS, DPO_STEPS, DPO_PROMPT, DPO_COMPLETION = 16, 3, 100, 50
EVAL_PAIRS, EVAL_BATCH, EVAL_PROMPTS, EVAL_NEW = 64, 10, 8, 150
# a row's mean log-likelihood on the mesh against one card, bf16 compute on
# both: a rank runs its rows through matrix products of another height, so
# the logits differ by bf16 roundings, averaged over the row's 100-1023
# scored tokens (chip_smoke's NLL_BOUND for the card against the CPU)
EVAL_LL_BOUND = 2e-2
# the ring against one call over the whole sequence, both bf16 kernels:
# out within 3e-2 (chip_smoke's OUT_BOUND: bf16 probabilities and output,
# |out| < 4); each gradient within 2e-2 of its max |one call| + 1e-5 (the
# kernel's bound of 1e-2 against the plain version, on each side)
RING_OUT_BOUND, RING_GRAD_REL = 3e-2, 2e-2
LEGS = ("meshes", "dpo", "eval")


def _require(ok: bool, msg: str):
    if not ok:
        raise RuntimeError(msg)


def meshes(n: int) -> list:
    """(name, mesh_shape, mesh_axes, cp_schedule) of the four meshes."""
    seq = ["data", "seq"]
    return [("dp", [n], None, "contiguous"), ("cp_contiguous", [1, n], seq, "contiguous"),
            ("cp_zigzag", [1, n], seq, "zigzag"), ("dp_cp", [2, n // 2], seq, "contiguous")]


def expected_launches(shape: list, schedule: str, rank: int, layers: int) -> dict:
    """The flash launches of one rank's trainer run (STEPS x MICRO
    microbatches, full remat: each layer's forward twice, its backward once):
    a ring pass of seq rank r launches 1 + r calls (contiguous) or 1 + 2(n-1)
    (zigzag), forward and backward alike."""
    n_seq = shape[1] if len(shape) > 1 else 1
    r = rank % n_seq
    per_pass = 1 + (2 * (n_seq - 1) if schedule == "zigzag" else r)
    micro = STEPS * MICRO * layers
    return {"flash_fwd": 2 * micro * per_pass, "flash_bwd": micro * per_pass}


def packed_segments(rng, b: int, t: int, mean: int = 128) -> np.ndarray:
    """Packed rows of utterances of ~mean tokens with a -1 tail."""
    seg = np.full((b, t), -1, np.int32)
    for row in range(b):
        pos, s, tail = 0, 0, int(rng.integers(16, 96))
        while pos < t - tail:
            ln = min(int(rng.integers(mean // 2, mean * 2)), t - tail - pos)
            seg[row, pos:pos + ln] = s
            pos += ln
            s += 1
    return seg


def check_ring(dev, mesh, schedule: str, dcfg, rows: int, context: int, dtype) -> dict:
    """This rank's chunk of the ring over the mesh's 'seq' group at the
    decoder's attention shape (the Slam recipe: [8, 14/2, 1024, 64] in bf16)
    with packed segments, forward and backward, against one flash call over
    the whole sequence on this device."""
    import torch

    from ..ops import flash_attention, ring_flash_attention, zigzag_permutation

    n, r = mesh.shape["seq"], mesh.coordinate["seq"]
    g = torch.Generator(device="cpu").manual_seed(17)
    hq, hkv, d = dcfg.num_heads, dcfg.num_kv_heads, dcfg.head_dim
    q, do = (torch.randn(rows, hq, context, d, generator=g).to(dev, dtype) for _ in range(2))
    k, v = (torch.randn(rows, hkv, context, d, generator=g).to(dev, dtype) for _ in range(2))
    seg = torch.from_numpy(packed_segments(np.random.default_rng(17), rows, context)).to(dev)
    full = [x.clone().requires_grad_() for x in (q, k, v)]
    want = flash_attention(*full, segment_ids=seg, causal=True)
    want.backward(do)
    order = zigzag_permutation(context, n) if schedule == "zigzag" else np.arange(context)
    cols = torch.from_numpy(order[r * context // n:(r + 1) * context // n]).to(dev)
    part = lambda x, dim: x.index_select(dim, cols).contiguous()
    local = [part(x, 2).requires_grad_() for x in (q, k, v)]
    out = ring_flash_attention(*local, part(seg, 1), group=mesh.group("seq"),
                               schedule=schedule)
    out.backward(part(do, 2))
    errs = {"out": (out.float() - part(want.detach(), 2).float()).abs().max().item()}
    bounds = {"out": RING_OUT_BOUND}
    for name, got, ref in zip(("dq", "dk", "dv"), local, full):
        ref = part(ref.grad, 2).float()
        errs[name] = (got.grad.float() - ref).abs().max().item()
        bounds[name] = RING_GRAD_REL * ref.abs().max().item() + 1e-5
    _require(all(math.isfinite(e) and e <= bounds[k] for k, e in errs.items()),
             f"rank {mesh.rank}: the {schedule} ring disagrees with one call: {errs} "
             f"(bounds {bounds})")
    return {"max_abs_err": errs, "bounds": bounds}


def _grad_norm_recorder(trainer) -> list:
    """Make `trainer` record the global gradient norm each optimizer step
    reads (after the mesh's all-reduce, before clipping)."""
    import torch

    norms, step = [], trainer.optimizer.step

    def recording_step(*a, **kw):
        grads = [p.grad for p in trainer.model.decoder.parameters() if p.grad is not None]
        norms.append(float(torch.sqrt(sum((g.float() ** 2).sum() for g in grads))))
        return step(*a, **kw)

    trainer.optimizer.step = recording_step
    return norms


def _comm_shares(prof, wall_ms: float) -> dict:
    """Device milliseconds of NCCL's send / receive kernels, of its
    all-reduce kernels and of all kernels in a profiled step, and the first
    two as shares of the step's wall time."""
    sums = {"p2p_ms": 0.0, "all_reduce_ms": 0.0, "kernels_ms": 0.0}
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue
        ms = getattr(e, "self_device_time_total", 0.0) / 1e3
        name = e.key.lower()
        sums["kernels_ms"] += ms
        if "nccl" in name and ("sendrecv" in name or "send" in name or "recv" in name):
            sums["p2p_ms"] += ms
        elif "nccl" in name and "allreduce" in name:
            sums["all_reduce_ms"] += ms
        elif "nccl" in name and "allgather" in name:
            sums["all_gather_ms"] = sums.get("all_gather_ms", 0.0) + ms
    sums.update(wall_ms=wall_ms, p2p_share=sums["p2p_ms"] / wall_ms,
                all_reduce_share=sums["all_reduce_ms"] / wall_ms,
                all_gather_share=sums.get("all_gather_ms", 0.0) / wall_ms)
    return sums


def _profiled(lead: bool, cuda: bool, sync, fn):
    """(fn's result, its wall milliseconds, the profiler) with rank 0 under
    `torch.profiler` and every rank starting together."""
    import torch
    import torch.distributed as dist

    prof = None
    if lead:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
    sync()
    dist.barrier()
    t0 = time.perf_counter()
    out = fn()
    sync()
    wall_ms = (time.perf_counter() - t0) * 1e3
    if lead:
        prof.stop()
    return out, wall_ms, prof


def run(dev, work: pathlib.Path, cfg=None, context: int = CONTEXT, rows: int = ROWS,
        n_rows: int = 400, lengths=(100, 1001), legs=LEGS) -> dict:
    """Every check and measurement above of `legs` on this rank's `dev`
    (the card; a rehearsal passes the CPU, a small `cfg`, `context` and
    `rows`, and then no launch may be counted); rank 0 returns the
    results."""
    import torch
    import torch.distributed as dist

    from ..ops import _build
    from ..ops.flash_attention import KERNEL, KERNEL_BWD
    from ..ops.quant import KERNEL as KERNEL_DQ
    from .slam_recipe import nvidia_smi, slam_config

    rank, world = dist.get_rank(), dist.get_world_size()
    lead = rank == 0
    cuda = dev.type == "cuda"
    say = (lambda *a: print(*a, flush=True)) if lead else (lambda *a: None)
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    result = {"world": world, "device": torch.cuda.get_device_name(dev) if cuda else "cpu"}
    if lead:
        if cuda:
            result["nvidia_smi"] = nvidia_smi()
            say(result["nvidia_smi"])
            say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {world} ranks on "
                f"{torch.cuda.device_count()} x {result['device']}")
            t0 = time.perf_counter()
            for name in (KERNEL, KERNEL_BWD, KERNEL_DQ):
                _build.build(name)
            say(f"built {KERNEL}, {KERNEL_BWD}, {KERNEL_DQ} in "
                f"{time.perf_counter() - t0:.1f} s")
    dist.barrier()
    cfg = dataclasses.replace(cfg or slam_config(), remat=True)
    if "meshes" in legs:
        run_meshes(dev, work, cfg, context, rows, n_rows, lengths, result, say, sync)
    if "dpo" in legs:
        result["dpo"] = run_dpo(dev, work, cfg, say, sync)
    if "eval" in legs:
        result["eval"] = run_eval(dev, work, cfg, say, sync, context)
    return result


def run_meshes(dev, work: pathlib.Path, cfg, context: int, rows: int, n_rows: int, lengths,
               result: dict, say, sync):
    """The pretraining leg (module docstring) on this rank, into rank 0's
    `result`: the one-card reference, the four meshes, DP's efficiency."""
    import torch
    import torch.distributed as dist

    from ..data import parse_single_dataset
    from ..models import UnitLM
    from ..ops import flash_attention_bwd, flash_attention_fwd
    from ..parallel import Mesh, make_mesh
    from ..tokeniser import UnitTokeniser
    from ..trainer import SLAMTrainer, TrainerCallback
    from .slam_recipe import slam_training_args, write_markov_corpus

    rank, world = dist.get_rank(), dist.get_world_size()
    lead, cuda = rank == 0, dev.type == "cuda"
    if lead:
        write_markov_corpus(work / "tokens.jsonl", n_rows, lengths)
    dist.barrier()
    ds = parse_single_dataset({"data": {}, "model": {"context_len": context}},
                              UnitTokeniser(), str(work / "tokens.jsonl"))["train"]
    dcfg = cfg.decoder_config()

    class Clock(TrainerCallback):
        def __init__(self):
            self.marks = []

        def on_step_end(self, args, state, control, **kw):
            sync()
            self.marks.append((time.perf_counter(), state.num_input_tokens_seen))

    def trainer(out, mesh, n_data, **over):
        args = slam_training_args(str(out), per_device_train_batch_size=rows // n_data,
                                  gradient_accumulation_steps=MICRO, max_steps=STEPS,
                                  save_steps=3, **over)
        model = UnitLM(cfg, seed=0, device=dev)
        clock = Clock()
        return SLAMTrainer(model, args, ds, callbacks=[clock], packing=True,
                           context_len=context, mesh=mesh), clock

    def timed(marks) -> dict:
        """Steps 2-3 from (time, tokens seen) at each step's end (step 1
        warms up; step 4 follows the step-3 save)."""
        (t1, n1), (t3, n3) = marks[0], marks[2]
        secs = (t3 - t1) / 2
        return {"step_s": secs, "tokens_per_s": (n3 - n1) / 2 / secs}

    # ---- the reference: the global batch on rank 0's card alone --------
    if lead:
        tr, _ = trainer(work / "ref", Mesh(("data",), (1,)), 1)
        norms = _grad_norm_recorder(tr)
        batches = tr.train_batcher.epoch(0)
        losses, marks, seen = [], [], 0
        for _ in range(3):
            loss, tokens = tr._train_step([next(batches) for _ in range(MICRO)])
            losses.append(float(loss))
            sync()
            seen += tokens
            marks.append((time.perf_counter(), seen))
        ref = {"loss": losses[0], "grad_norm": norms[0], **timed(marks)}
        say(f"one card: step 1 loss {ref['loss']:.6f}, gradient norm {ref['grad_norm']:.6f}; "
            f"{ref['step_s']:.4f} s a step, {ref['tokens_per_s']:.1f} tokens/s")
        result["one_card"] = ref
        del tr
    dist.barrier()
    ref = result.get("one_card")

    result["meshes"] = {}
    for name, shape, axes, schedule in meshes(world):
        mesh = make_mesh(shape, axes)
        n_data = mesh.shape["data"]
        out_a, out_b = work / f"{name}_a", work / f"{name}_b"
        over = dict(mesh_shape=shape, mesh_axes=axes, cp_schedule=schedule)
        tr, clock = trainer(out_a, mesh, n_data, **over)
        norms = _grad_norm_recorder(tr)
        flash_attention_fwd.launches = flash_attention_bwd.launches = 0   # the main path
        state = tr.train()
        launches = {"flash_fwd": flash_attention_fwd.launches,
                    "flash_bwd": flash_attention_bwd.launches}
        want = (expected_launches(shape, schedule, rank, dcfg.num_layers) if cuda
                else {"flash_fwd": 0, "flash_bwd": 0})
        _require(launches == want, f"rank {rank} {name}: launches {launches}, expected {want}")
        losses = [r["loss"] for r in state.log_history if "loss" in r]
        row = {"mesh_shape": shape, "mesh_axes": axes, "cp_schedule": schedule,
               "losses": losses, "grad_norm_step1": norms[0], **timed(clock.marks)}
        launch_counts = [None] * world
        dist.all_gather_object(launch_counts, launches)
        row["launches_by_rank"] = launch_counts
        # one more step under the profiler on rank 0 (every rank steps)
        batches = tr.train_batcher.epoch(0, skip_batches=STEPS * MICRO)
        group = [next(batches) for _ in range(MICRO)]
        params_a = {k: p.detach().clone() for k, p in tr.model.decoder.named_parameters()}
        _, wall_ms, prof = _profiled(lead, cuda, sync, lambda: tr._train_step(group))
        if lead:
            row["profiled_step"] = _comm_shares(prof, wall_ms)
        del tr
        # the resume: a second trainer from checkpoint-3 repeats step 4
        tr_b, _ = trainer(out_b, mesh, n_data, **over)
        state_b = tr_b.train(resume_from_checkpoint=str(out_a / "checkpoint-3"))
        losses_b = [r["loss"] for r in state_b.log_history if "loss" in r]
        same = losses_b == losses and all(
            torch.equal(p, params_a[k]) for k, p in tr_b.model.decoder.named_parameters())
        flags = torch.tensor([int(same)], device=dev)
        dist.all_reduce(flags, op=dist.ReduceOp.MIN)
        row["resume_exact"] = bool(flags.item())
        del tr_b, params_a
        if cuda:
            torch.cuda.empty_cache()
        if mesh.shape.get("seq", 1) > 1:
            row["ring"] = check_ring(dev, mesh, schedule, dcfg, rows, context,
                                     dcfg.compute_dtype)
        dist.barrier()
        if lead:
            shutil.rmtree(out_a, ignore_errors=True)
            shutil.rmtree(out_b, ignore_errors=True)
            loss_err = abs(losses[0] - ref["loss"])
            norm_err = abs(norms[0] - ref["grad_norm"]) / ref["grad_norm"]
            row.update(loss_err=loss_err, grad_norm_rel_err=norm_err)
            p = row.get("profiled_step", {})
            say(f"{name} {shape}: losses {losses}; step 1 |d loss| {loss_err:.3e} (<= "
                f"{LOSS_BOUND}), gradient norm {norms[0]:.6f} rel {norm_err:.3e} (<= "
                f"{GRAD_NORM_RTOL}); {row['step_s']:.4f} s a step, "
                f"{row['tokens_per_s']:.1f} tokens/s; P2P {p.get('p2p_share', 0):.4f}, "
                f"all-reduce {p.get('all_reduce_share', 0):.4f} of a "
                f"{p.get('wall_ms', 0):.1f} ms profiled step; resume exact "
                f"{row['resume_exact']}; launches {launch_counts}")
            if "ring" in row:
                say(f"{name} ring vs one call (rank 0): {row['ring']['max_abs_err']}")
            _require(loss_err <= LOSS_BOUND and norm_err <= GRAD_NORM_RTOL,
                     f"{name}: step 1 disagrees with the one-card run")
        _require(row["resume_exact"], f"{name}: the resumed run did not repeat step 4")
        result["meshes"][name] = row
        dist.barrier()
    if lead:
        dp = result["meshes"]["dp"]
        result["dp_scaling_efficiency"] = dp["tokens_per_s"] / (world * ref["tokens_per_s"])
        say(f"DP on {world} cards: {dp['tokens_per_s']:.1f} tokens/s against "
            f"{ref['tokens_per_s']:.1f} on one: scaling efficiency "
            f"{result['dp_scaling_efficiency']:.4f}")


def run_dpo(dev, work: pathlib.Path, cfg, say, sync, pairs: int = DPO_PAIRS,
            prompt_len: int = DPO_PROMPT, completion_len: int = DPO_COMPLETION) -> dict:
    """The DPO leg (module docstring) on this rank; rank 0 returns its row."""
    import torch
    import torch.distributed as dist

    from ..config import compose
    from ..models import UnitLM
    from ..ops import flash_attention_bwd, flash_attention_fwd
    from ..parallel import Mesh, make_mesh
    from ..tokeniser import UnitTokeniser
    from ..trainer import SLAMDPOTrainer, TrainerCallback
    from .slam_recipe import write_preference_rows

    rank, world = dist.get_rank(), dist.get_world_size()
    lead, cuda = rank == 0, dev.type == "cuda"
    if lead:
        write_preference_rows(work / "pref.jsonl", pairs * (DPO_STEPS + 1), prompt_len,
                              completion_len)
    dist.barrier()
    rows = [{k: r[k] for k in ("prompt", "chosen", "rejected")} for r in
            map(json.loads, (work / "pref.jsonl").read_text().splitlines())]

    class Clock(TrainerCallback):
        def __init__(self):
            self.marks = []

        def on_step_end(self, args, state, control, **kw):
            sync()
            self.marks.append(time.perf_counter())

    def trainer(out, mesh, n_data):
        args = compose(str(ROOT / "config"), "preference_alignment_train", [
            f"training_args.output_dir={out}", f"training_args.max_steps={DPO_STEPS}",
            f"training_args.per_device_train_batch_size={pairs // n_data}",
            "training_args.logging_steps=1", f"training_args.save_steps={DPO_STEPS - 1}",
            "training_args.learning_rate=1e-4", "training_args.warmup_ratio=0.0",
            "training_args.warmup_steps=0", "training_args.async_save=false",
            "data.train_path=-", "data.val_path=-"]).training_args
        clock = Clock()
        tr = SLAMDPOTrainer(UnitLM(cfg, seed=0, device=dev), UnitTokeniser(), args, rows,
                            callbacks=[clock], mesh=mesh)
        return tr, clock, _grad_norm_recorder(tr)

    def losses(state):
        return [r["loss"] for r in state.log_history if "loss" in r]

    ref = None
    if lead:   # the global batches on rank 0's card alone
        tr, clock, norms = trainer(work / "dpo_ref", Mesh(("data",), (1,)), 1)
        state = tr.train()
        secs = clock.marks[1] - clock.marks[0]
        ref = {"losses": losses(state), "grad_norm": norms[0], "step_s": secs,
               "pairs_per_s": pairs / secs}
        del tr
        shutil.rmtree(work / "dpo_ref", ignore_errors=True)
    dist.barrier()
    mesh = make_mesh([world])
    tr, clock, norms = trainer(work / "dpo_a", mesh, world)
    flash_attention_fwd.launches = flash_attention_bwd.launches = 0   # the main path
    state = tr.train()
    launches = {"flash_fwd": flash_attention_fwd.launches,
                "flash_bwd": flash_attention_bwd.launches}
    layers = cfg.decoder_config().num_layers
    # per step: the policy's forward twice (full remat) and the reference's
    # once, one backward; nothing for the evaluation (no eval rows)
    want = ({"flash_fwd": 3 * layers * DPO_STEPS, "flash_bwd": layers * DPO_STEPS} if cuda
            else {"flash_fwd": 0, "flash_bwd": 0})
    _require(launches == want, f"rank {rank} dpo: launches {launches}, expected {want}")
    got = losses(state)
    secs = clock.marks[1] - clock.marks[0]
    row = {"mesh_shape": [world], "losses": got, "grad_norm_step1": norms[0],
           "step_s": secs, "pairs_per_s": pairs / secs}
    launch_counts = [None] * world
    dist.all_gather_object(launch_counts, launches)
    row["launches_by_rank"] = launch_counts
    # one more step under the profiler
    order = np.random.default_rng(0).permutation(len(rows))
    extra = [tr.train_rows[i] for i in order[:pairs]]
    params_a = {k: p.detach().clone() for k, p in tr.model.decoder.named_parameters()}
    _, wall_ms, prof = _profiled(lead, cuda, sync, lambda: tr._train_step(extra))
    if lead:
        row["profiled_step"] = _comm_shares(prof, wall_ms)
    del tr
    tr_b, _, _ = trainer(work / "dpo_b", mesh, world)
    state_b = tr_b.train(resume_from_checkpoint=str(work / "dpo_a" / f"checkpoint-{DPO_STEPS - 1}"))
    same = losses(state_b) == got and all(
        torch.equal(p, params_a[k]) for k, p in tr_b.model.decoder.named_parameters())
    flags = torch.tensor([int(same)], device=dev)
    dist.all_reduce(flags, op=dist.ReduceOp.MIN)
    row["resume_exact"] = bool(flags.item())
    del tr_b, params_a
    if cuda:
        torch.cuda.empty_cache()
    dist.barrier()
    if lead:
        shutil.rmtree(work / "dpo_a", ignore_errors=True)
        shutil.rmtree(work / "dpo_b", ignore_errors=True)
        loss_err = max(abs(a - b) for a, b in zip(got[:2], ref["losses"][:2]))
        norm_err = abs(norms[0] - ref["grad_norm"]) / ref["grad_norm"]
        row.update(one_card=ref, loss_err=loss_err, grad_norm_rel_err=norm_err)
        p = row["profiled_step"]
        say(f"dpo [{world}], {pairs} pairs of {prompt_len + completion_len + 2} tokens a "
            f"step: losses {got} (one card {ref['losses']}); steps 1-2 |d loss| "
            f"{loss_err:.3e} (<= {LOSS_BOUND}), step-1 gradient norm {norms[0]:.6f} rel "
            f"{norm_err:.3e} (<= {GRAD_NORM_RTOL}); {secs:.4f} s a step, "
            f"{row['pairs_per_s']:.1f} pairs/s (one card {ref['step_s']:.4f} s, "
            f"{ref['pairs_per_s']:.1f} pairs/s); all-reduce {p['all_reduce_share']:.4f} of a "
            f"{p['wall_ms']:.1f} ms profiled step; resume exact {row['resume_exact']}; "
            f"launches {launch_counts}")
        _require(loss_err <= LOSS_BOUND and norm_err <= GRAD_NORM_RTOL,
                 "dpo: steps 1-2 disagree with the one-card run")
    _require(row["resume_exact"], "dpo: the resumed run did not repeat step 3")
    dist.barrier()
    return row


def run_eval(dev, work: pathlib.Path, cfg, say, sync, context: int = CONTEXT,
             pairs: int = EVAL_PAIRS, batch: int = EVAL_BATCH, n_prompts: int = EVAL_PROMPTS,
             new_tokens: int = EVAL_NEW) -> dict:
    """The evaluation leg (module docstring) on this rank; rank 0 returns
    its row."""
    import torch
    import torch.distributed as dist

    from ..models import UnitLM
    from ..ops import dq_matmul, flash_attention_fwd
    from ..parallel import make_mesh

    rank, world = dist.get_rank(), dist.get_world_size()
    lead, cuda = rank == 0, dev.type == "cuda"
    cfg = dataclasses.replace(cfg, remat=False)
    rng = np.random.default_rng(23)
    lens = rng.integers(100, context + 1, 2 * pairs)
    tokens = np.zeros((2 * pairs, context), np.int64)
    for i, n in enumerate(lens):
        tokens[i, 0] = 1
        tokens[i, 1:n] = rng.integers(2, 502, n - 1)
    plens = rng.integers(50, 76, n_prompts)
    prompts = np.zeros((n_prompts, int(plens.max())), np.int64)
    for i, n in enumerate(plens):
        prompts[i, -n:] = np.r_[1, rng.integers(2, 502, n - 1)]
    batches = [tokens[i:i + batch] for i in range(0, len(tokens), batch)]

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    score = lambda tlm: torch.cat([tlm.log_likelihood(b) for b in batches]).float().cpu()
    gen_kwargs = dict(max_new_tokens=new_tokens)
    sampled = dict(gen_kwargs, do_sample=True, temperature=0.8, top_k=25, seed=0)
    greedy = dict(gen_kwargs, do_sample=False)
    tlm = UnitLM(cfg, seed=0, device=dev)
    one = {}
    if lead:   # one card: the whole batches, and each rank's rows of the prompts alone
        score(tlm)   # warm-up
        one["ll"], one["score_s"] = timed(lambda: score(tlm))
        one["sampled"], one["generate_s"] = timed(lambda: tlm.generate(prompts, **sampled))
        per = -(-n_prompts // world)
        tiles = [prompts[r * per:(r + 1) * per] for r in range(world)]
        one["greedy"] = torch.cat([tlm.generate(t, **greedy) for t in tiles if len(t)])
        one["int8"] = torch.cat([tlm.generate(t, weight_quant="int8", **greedy)
                                 for t in tiles if len(t)])
    dist.barrier()
    tlm.shard(make_mesh([world]))
    score(tlm)   # warm-up
    flash_attention_fwd.launches = dq_matmul.launches = 0   # the main path
    ll, score_s = timed(lambda: score(tlm))
    greedy_out = tlm.generate(prompts, **greedy)
    int8_out = tlm.generate(prompts, weight_quant="int8", **greedy)
    sampled_out, generate_s = timed(lambda: tlm.generate(prompts, **sampled))
    launches = {"flash_fwd": flash_attention_fwd.launches, "dq_matmul": dq_matmul.launches}
    again, wall_ms, prof = _profiled(lead, cuda, sync, lambda: tlm.generate(prompts, **sampled))
    _require(torch.equal(again, sampled_out), f"rank {rank} eval: a sampled call did not repeat")
    _require(not cuda or (launches["flash_fwd"] > 0 and launches["dq_matmul"] > 0),
             f"rank {rank} eval: launches {launches}")
    launch_counts = [None] * world
    dist.all_gather_object(launch_counts, launches)
    row = {"mesh_shape": [world], "score_s": score_s, "pairs_per_s": pairs / score_s,
           "generate_s": generate_s, "new_tokens_per_s": n_prompts * new_tokens / generate_s,
           "launches_by_rank": launch_counts}
    if lead:
        ll_err = (ll - one["ll"]).abs().max().item()
        greedy_same = torch.equal(greedy_out, one["greedy"])
        int8_same = torch.equal(int8_out, one["int8"])
        new = slice(prompts.shape[1], None)
        agree = (sampled_out[:, new] == one["sampled"][:, new]).float().mean().item()
        row.update(one_card={"score_s": one["score_s"],
                             "pairs_per_s": pairs / one["score_s"],
                             "generate_s": one["generate_s"],
                             "new_tokens_per_s": n_prompts * new_tokens / one["generate_s"]},
                   ll_max_abs_err=ll_err, ll_bitwise=bool(torch.equal(ll, one["ll"])),
                   greedy_bitwise=greedy_same, int8_greedy_bitwise=int8_same,
                   sampled_token_agreement=agree, profiled_generate=_comm_shares(prof, wall_ms))
        say(f"eval [{world}] (UnitLM.shard): {2 * pairs} rows of 100-{context} scored in "
            f"batches of {batch}, max |d ll| {ll_err:.3e} (<= {EVAL_LL_BOUND}; bitwise "
            f"{row['ll_bitwise']}), {score_s:.4f} s, {row['pairs_per_s']:.1f} pairs/s (one "
            f"card {one['score_s']:.4f} s); {n_prompts} prompts x {new_tokens} new tokens: "
            f"greedy and int8 greedy equal each rank's rows decoded alone {greedy_same} "
            f"{int8_same}; sampled {row['generate_s']:.4f} s, {row['new_tokens_per_s']:.1f} "
            f"new tokens/s (one card {one['generate_s']:.4f} s), tokens equal to one card's "
            f"{agree:.4f}, all-gather {row['profiled_generate']['all_gather_share']:.4f} of "
            f"a {wall_ms:.1f} ms profiled call; launches {launch_counts}")
        _require(ll_err <= EVAL_LL_BOUND and greedy_same and int8_same,
                 "eval: the sharded scores or greedy tokens disagree with one card")
    del tlm
    if cuda:
        torch.cuda.empty_cache()
    dist.barrier()
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--legs", default=",".join(LEGS),
                    help=f"comma-separated subset of {','.join(LEGS)}")
    legs = tuple(ap.parse_args(argv).legs.split(","))
    if not set(legs) <= set(LEGS):
        print(f"parallel_smoke: --legs takes {','.join(LEGS)}", file=sys.stderr)
        return 2
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world < 2 or world % 2:
        print("parallel_smoke: start it on an even number N >= 2 of ranks, one card each: "
              "python -m torch.distributed.run --nproc_per_node N -m "
              "slamkit_tpu_torch.tools.parallel_smoke", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("parallel_smoke: torch.cuda.is_available() is false; it needs a CUDA card a "
              "rank", file=sys.stderr)
        return 1
    import torch.distributed as dist

    from ..parallel import init_distributed

    dev = init_distributed("cuda")
    work = ROOT / "build" / "parallel_smoke"
    if dist.get_rank() == 0:
        shutil.rmtree(work, ignore_errors=True)
        work.mkdir(parents=True)
    dist.barrier()
    try:
        result = run(dev, work, legs=legs)
        if dist.get_rank() == 0:
            print(json.dumps(result), flush=True)
    finally:
        dist.barrier()
        if dist.get_rank() == 0:
            shutil.rmtree(work, ignore_errors=True)
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
