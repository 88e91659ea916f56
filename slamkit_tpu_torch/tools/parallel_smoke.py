"""The Slam recipe on several cards: the mesh's data, sequence and model axes.

    python -m torch.distributed.run --nproc_per_node N -m slamkit_tpu_torch.tools.parallel_smoke \
        [--legs meshes,dpo,eval,fsdp,sims7b,tp,tp_eval,tp_sims7b,tp_fsdp,tp_fsdp_sims7b,tp_seq]

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

For each it holds every step's loss and step 1's global gradient norm to
the one-card reference (bf16 on both sides; bounds below), the ring's forward and
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

Then the parameters sharded over 'data' (`training_args.fsdp`, ZeRO-3,
`parallel/fsdp.py`):

  * fsdp: the Slam recipe as above on fsdp [N] and fsdp [2, N / 2] over
    ('data', 'seq') (contiguous ring), with the same checks (step 1 against
    the one-card run, each rank's flash launches equal to the unsharded
    mesh's, the resume from checkpoint-3 bit for bit) and a one-card resume
    of fsdp [N]'s checkpoint-3 (rank 0 alone loads the one-rank file and its
    step 4 is within LOSS_BOUND of the mesh's); beside DP [N] (trained here
    too unless the meshes leg ran), s a step, tokens/s, each rank's
    `max_memory_allocated`, the all-gather / reduce-scatter / all-reduce
    shares of one profiled step and how much of the NCCL kernels' time
    overlaps other kernels; then the dpo leg with `training_args.fsdp=true` (policy and reference
    sharded) and the eval leg through `UnitLM.shard(mesh, fsdp=True)`, each
    rank's peak memory beside them;
  * sims7b: `--config-name train_inter_scale` at Qwen2.5-7B's widths and
    full depth (28 layers of 3584, 28 / 4 heads of 128, FFN 18944, untied
    embeddings over SIMS's 152167 ids: 7.62e9 parameters), random weights
    from seed 0, context 2048, bf16, full remat, float32 AdamW moments (the
    yaml's), fsdp [N]; cut to 2 rows a rank (the yaml has 8) and 3 steps.
    Its base directory is `tools/sims_recipe.py::write_base_dir(preset=
    "Qwen/Qwen2.5-7B")` beside the 151665-entry WordLevel tokenizer, its
    corpora `write_corpora`'s. Before sharding, rank 0 computes step 1's
    global batch's loss unsharded on its card, without gradients, a row at
    a time: the fsdp step 1 must be within LOSS_BOUND of it, step 1's
    global gradient norm finite and positive, every parameter moved by the
    last step on some rank, every step's loss finite, every rank's peak memory under
    its card's. The steps go through `SLAMTrainer._train_step`, not
    `train()`: the loop's logging and agreement all-reduce are held at Slam
    width by the fsdp leg. It prints s a
    step, tokens/s, MFU against N x the H100's dense bf16 peak, each rank's
    peak memory beside the whole training state's bytes and the NCCL shares
    of the profiled step 3. It saves no checkpoint: the one-rank file would
    hold 61-91 GB, past the disk a call may use (resume is held at Slam
    width in the fsdp leg).

Then tensor parallelism over 'model' (`parallel/tensor.py`):

  * tp: the Slam recipe as above on TP [2, N / 2] over ('data', 'model')
    (each layer's heads and MLP columns split over the 'model' line, the
    batch over 'data'), beside DP [N] (trained here unless an earlier leg
    did) and the one-card reference, with the same checks (step 1's loss
    and gradient norm against one card, each rank's flash launches, the
    exact resume from checkpoint-3, rank 0 resuming the gathered
    checkpoint-3 alone), every replicated parameter (norms, o_b, down_b, a
    whole vocabulary) bitwise equal across each 'model' line after the last
    step, and s a step, tokens/s, peak memory and the NCCL shares;
  * tp_eval: `UnitLM.shard(mesh, tp=True)` on [2, N / 2] with the Slam
    decoder in float32 (the float32 flash forward): the scores against rank
    0's one-card scores, greedy generation bit for bit against one card
    decoding each 'data' tile's rows alone, sampled generation bit for bit
    against one card's, and int8 greedy as `tests/test_torch_tp_eval.py`
    states it: the int8 prefill's last-position logits within
    `int8_tp_atol` of one card's (the row-parallel products round each
    rank's bf16 partial output once more), the tokens' agreement with one
    card's reported; times as the eval leg's;
  * tp_sims7b: the sims7b leg on TP [1, N] without fsdp, 2 rows a step (its
    one 'data' coordinate) and 3 steps: step 1 against the unsharded loss,
    the peaks while building and training, s a step and MFU with the same
    upper count.

Then tensor parallelism with fsdp on one mesh (JAX `tp_shardings(fsdp=True)`:
each rank's 'model' slices sharded over its 'data' line):

  * tp_fsdp: the Slam recipe on TP + fsdp [2, N / 2] beside TP [2, N / 2]
    and fsdp [N] (each trained here unless an earlier leg of the call did)
    and the one-card reference, with the tp leg's checks (step 1's loss and
    gradient norm against one card, each rank's flash launches, the exact
    resume from checkpoint-3, one card repeating step 4 from it, the
    replicated parameters' shards bitwise equal across each 'model' line,
    all four losses within LOSS_BOUND of one card's); s a step, tokens/s,
    peaks and NCCL shares of each;
  * tp_fsdp_sims7b: the sims7b leg on TP + fsdp [2, N / 2], 2 rows a 'data'
    coordinate (4 a step) and 3 steps, beside fsdp [N] and TP [1, N] (each
    run here unless the sims7b or tp_sims7b leg ran): step 1 against the
    unsharded loss, s a step, tokens/s, MFU, the peaks while building and
    training.

Then tensor parallelism beside the ring over 'seq' on one ('data', 'model',
'seq') mesh (JAX's three-axis mesh: each rank's heads over 'model', its
chunk of the sequence over 'seq'):

  * tp_seq: the Slam recipe on [1, 2, N / 2] over ('data', 'model', 'seq'),
    contiguous and zigzag (the flash route: the ring's bf16 kernels on the
    rank's 7 / 1 heads over chunks of 1024 / (N / 2), 512 at N = 4), beside
    TP [2, N / 2] and CP [1, N] contiguous (each trained here unless an
    earlier leg of the call did) and the one-card reference, with the tp
    leg's checks (step 1's loss and gradient norm and all four losses
    against one card, each rank's flash launches, the exact resume from
    checkpoint-3, one card repeating step 4 from it, the replicated
    parameters bitwise equal across each 'model' line), every parameter
    bitwise equal across each 'seq' line after the last step (the 'seq'
    replicas of a 'model' slice), and the ring on the rank's heads and
    chunk against one flash call over the whole sequence; s a step,
    tokens/s, peaks and NCCL shares of each.

Then the meshes over several nodes (`tools/multinode.py` starts the ranks
as two torchrun nodes, with `--multihost`: `training_args.multihost=true`):

  * nodes: DP [N] and TP [2, N / 2] as the tp leg runs them, then fsdp [N],
    each with the same checks and times and rank 0 resuming the mesh's
    checkpoint-3 on one card; each row names the mesh's nodes and the axes
    whose groups cross them. nodes_dp: DP [N] alone (the run over NCCL's
    socket transport, where TP's and fsdp's traffic would take minutes).

`--legs` runs a subset of the thirteen (meshes, dpo, eval, fsdp, sims7b,
tp, tp_eval, tp_sims7b, tp_fsdp, tp_fsdp_sims7b, tp_seq, nodes, nodes_dp;
default the first five: `chip_smoke.py` runs the three tp legs in a call of
their own, in that order, the two tp_fsdp legs in another, tp_seq in a
third, and the nodes legs through `tools/multinode.py`). `--timeout`
bounds every collective (seconds; `init_process_group`'s timeout). The
last line is one JSON object of all of it; a failed check on any rank ends
every rank and exits 1, so the legs after it do not run. It imports only the port.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import pathlib
import shutil
import sys
import time
import traceback
from typing import Optional

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
# sims7b: context, rows a rank and steps (the yaml's 8 rows cut to 2)
SIMS_CONTEXT, SIMS_PER_DEVICE, SIMS_STEPS = 2048, 2, 3
#: the sims7b leg's layouts: N ranks -> (mesh_shape, mesh_axes, fsdp)
SIMS_LAYOUTS = {"fsdp": lambda n: ([n], None, True),
                "tp": lambda n: ([1, n], ["data", "model"], False),
                "tp_fsdp": lambda n: ([2, n // 2], ["data", "model"], True)}
#: one H100's dense bf16 peak (NVIDIA's data sheet, SXM part at 700 W)
H100_BF16_FLOPS = 989e12
LEGS = ("meshes", "dpo", "eval", "fsdp", "sims7b", "tp", "tp_eval", "tp_sims7b", "tp_fsdp",
        "tp_fsdp_sims7b", "tp_seq", "nodes", "nodes_dp")
DEFAULT_LEGS = LEGS[:5]


def int8_tp_atol(logits, layers: int) -> float:
    """How far the int8 prefill's logits on a 'model' line may sit from one
    card's (`tests/test_torch_tp_eval.py` holds the same bound): each
    layer's two row-parallel products (o, down) round the ranks' bf16
    partial outputs before their sum, one bf16 ulp (2^-8) of the output
    more than one product at most, and the 2 x layers such roundings add
    up through the residual stream as a random walk: sqrt(2 x layers) x
    2^-8 of the largest logit."""
    return math.sqrt(2 * layers) * 2.0 ** -8 * float(abs(logits).max())


def _require(ok: bool, msg: str):
    if not ok:
        raise RuntimeError(msg)


def meshes(n: int) -> list:
    """(name, mesh_shape, mesh_axes, cp_schedule) of the four meshes."""
    seq = ["data", "seq"]
    return [("dp", [n], None, "contiguous"), ("cp_contiguous", [1, n], seq, "contiguous"),
            ("cp_zigzag", [1, n], seq, "zigzag"), ("dp_cp", [2, n // 2], seq, "contiguous")]


def expected_launches(shape: list, axes, schedule: str, rank: int, layers: int) -> dict:
    """The flash launches of one rank's trainer run (STEPS x MICRO
    microbatches, full remat: each layer's forward twice, its backward once):
    a ring pass of seq rank r launches 1 + r calls (contiguous) or 1 + 2(n-1)
    (zigzag), forward and backward alike; a 'model' axis changes no count
    (each rank runs its heads in one call)."""
    axes = list(axes or ("data", "model")[:len(shape)])
    n_seq = shape[axes.index("seq")] if "seq" in axes else 1
    r = int(np.unravel_index(rank, shape)[axes.index("seq")]) if n_seq > 1 else 0
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
    decoder's attention shape on the rank's heads (the Slam recipe: [8, 14/2,
    1024, 64] in bf16; [8, 7/1, 1024, 64] beside 'model' = 2) with packed
    segments, forward and backward, against one flash call over the whole
    sequence on this device."""
    import torch

    from ..ops import flash_attention, ring_flash_attention, zigzag_permutation

    n, r = mesh.shape["seq"], mesh.coordinate["seq"]
    g = torch.Generator(device="cpu").manual_seed(17)
    m = mesh.shape.get("model", 1)
    hq, hkv, d = dcfg.num_heads // m, dcfg.num_kv_heads // m, dcfg.head_dim
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
    reads (after the mesh's reduction, before clipping; the squares of the
    shards over 'data' (fsdp), the slices over 'model' (tp) or both summed
    over their groups, a replicated parameter's counted once:
    `trainer.optim.global_norm`)."""
    from ..parallel.fsdp import local
    from ..trainer.optim import global_norm

    opt = trainer.optimizer
    norms, step = [], opt.step

    def recording_step(*a, **kw):
        held = [(local(p.grad).float(), shard) for p, shard in zip(opt.params, opt.shards)
                if p.grad is not None]
        norms.append(float(global_norm(*map(list, zip(*held)))))
        return step(*a, **kw)

    trainer.optimizer.step = recording_step
    return norms


def _comm_shares(prof, wall_ms: float) -> dict:
    """Device milliseconds of NCCL's send / receive, all-reduce, all-gather
    and reduce-scatter kernels and of all kernels in a profiled step, each
    collective's as a share of the step's wall time, and how much of the
    NCCL kernels' time other kernels overlap (`_overlap`)."""
    sums = {"p2p_ms": 0.0, "all_reduce_ms": 0.0, "kernels_ms": 0.0,
            "reduce_scatter_ms": 0.0}
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
        elif "nccl" in name and "reducescatter" in name:
            sums["reduce_scatter_ms"] += ms
    sums.update(wall_ms=wall_ms, p2p_share=sums["p2p_ms"] / wall_ms,
                all_reduce_share=sums["all_reduce_ms"] / wall_ms,
                all_gather_share=sums.get("all_gather_ms", 0.0) / wall_ms,
                reduce_scatter_share=sums["reduce_scatter_ms"] / wall_ms, **_overlap(prof))
    return sums


def _overlap(prof) -> dict:
    """From the profiled step's device timeline: the milliseconds in which
    an NCCL kernel runs (`nccl_busy_ms`), in which another kernel runs
    (`compute_busy_ms`), and the share of the first that the second
    overlaps (`nccl_overlapped_share`; 0 on the CPU)."""
    spans = {"nccl": [], "compute": []}
    for e in prof.events():
        if not str(e.device_type).endswith("CUDA") or e.time_range.elapsed_us() <= 0:
            continue
        kind = "nccl" if "nccl" in e.name.lower() else "compute"
        spans[kind].append((e.time_range.start, e.time_range.end))

    def union(intervals):
        merged = []
        for a, b in sorted(intervals):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    nccl, compute = union(spans["nccl"]), union(spans["compute"])
    both, j = 0.0, 0
    for a, b in nccl:
        while j < len(compute) and compute[j][1] <= a:
            j += 1
        k = j
        while k < len(compute) and compute[k][0] < b:
            both += min(b, compute[k][1]) - max(a, compute[k][0])
            k += 1
    busy = lambda m: sum(b - a for a, b in m) / 1e3
    nccl_ms = busy(nccl)
    return {"nccl_busy_ms": nccl_ms, "compute_busy_ms": busy(compute),
            "nccl_overlapped_share": both / 1e3 / nccl_ms if nccl_ms else 0.0}


def _replicas_equal(decoder, mesh, axis: str = "model") -> list:
    """The names of the parameters that differ across this rank's line
    along `axis` (compared bit for bit through the line's elementwise MAX
    and MIN) but should not: along 'model' those that `parallel.tensor`
    keeps whole on every rank of the line (with fsdp: the ranks' 'data'
    shards of them), along 'seq' every parameter (a 'model' slice too)."""
    import torch
    import torch.distributed as dist

    from ..parallel.fsdp import local
    from ..parallel.tensor import tp_shard

    differ = []
    with torch.no_grad():
        for name, p in decoder.named_parameters():
            if axis == "model" and tp_shard(p) is not None:
                continue
            mine = local(p.detach())   # fsdp: the same 'data' shard across the line
            hi, lo = mine.clone(), mine.clone()
            dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=mesh.group(axis))
            dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=mesh.group(axis))
            if not (torch.equal(hi, mine) and torch.equal(lo, mine)):
                differ.append(name)
    return differ


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
        n_rows: int = 400, lengths=(100, 1001), legs=DEFAULT_LEGS, sims_arch=None,
        sims_entries: Optional[int] = None, sims_context: int = SIMS_CONTEXT,
        eval_sizes: Optional[dict] = None, multihost: bool = False) -> dict:
    """Every check and measurement above of `legs` on this rank's `dev`
    (the card; a rehearsal passes the CPU, a small `cfg`, `context` and
    `rows`, a small `sims_arch`, `sims_entries` and `sims_context`, fewer
    evaluation rows and tokens in `eval_sizes` (`run_eval`'s keywords), and
    then no launch may be counted); `multihost` trains with
    `training_args.multihost=true`; rank 0 returns the results."""
    import torch
    import torch.distributed as dist

    from ..ops import _build
    from ..ops.flash_attention import KERNEL, KERNEL_BWD, KERNEL_F32
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
            names = (KERNEL, KERNEL_BWD, KERNEL_DQ,
                     *((KERNEL_F32,) if "tp_eval" in legs else ()))
            for name in names:
                _build.build(name)
            say(f"built {', '.join(names)} in {time.perf_counter() - t0:.1f} s")
    dist.barrier()
    cfg = dataclasses.replace(cfg or slam_config(), remat=True)
    pretrain = None
    if {"meshes", "fsdp", "tp", "tp_fsdp", "tp_seq", "nodes", "nodes_dp"} & set(legs):
        pretrain = _Pretrain(dev, work, cfg, context, rows, n_rows, lengths, say, sync,
                             multihost)
    if "meshes" in legs:
        run_meshes(pretrain, result)
    if "dpo" in legs:
        result["dpo"] = run_dpo(dev, work, cfg, say, sync)
    if "eval" in legs:
        result["eval"] = run_eval(dev, work, cfg, say, sync, context, **(eval_sizes or {}))
    if "fsdp" in legs:
        result["fsdp"] = run_fsdp(pretrain, result, eval_sizes or {})
    if "sims7b" in legs:
        sims = {} if sims_entries is None else {"n_entries": sims_entries}
        result["sims7b"] = run_sims7b(dev, work, say, sync, arch=sims_arch,
                                      context=sims_context, layout="fsdp", **sims)
    if "tp" in legs:
        result["tp"] = run_tp(pretrain, result)
    if "tp_eval" in legs:
        result["tp_eval"] = run_eval(dev, work, cfg, say, sync, context, tp=True,
                                     **(eval_sizes or {}))
    if "tp_sims7b" in legs:
        sims = {} if sims_entries is None else {"n_entries": sims_entries}
        result["tp_sims7b"] = run_sims7b(dev, work, say, sync, arch=sims_arch,
                                         context=sims_context, layout="tp", **sims)
    if "tp_fsdp" in legs:
        result["tp_fsdp"] = run_tp_fsdp(pretrain, result)
    if "tp_fsdp_sims7b" in legs:
        sims = {} if sims_entries is None else {"n_entries": sims_entries}
        result["tp_fsdp_sims7b"] = run_tp_fsdp_sims7b(dev, work, say, sync, result,
                                                      arch=sims_arch, context=sims_context,
                                                      **sims)
    if "tp_seq" in legs:
        result["tp_seq"] = run_tp_seq(pretrain, result)
    if "nodes" in legs or "nodes_dp" in legs:
        result["nodes"] = run_nodes(pretrain, result, dp_only="nodes" not in legs)
    return result


def _peaks(dev) -> list:
    """Every rank's `max_memory_allocated` in bytes, in rank order (None on
    the CPU)."""
    import torch
    import torch.distributed as dist

    mine = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    peaks = [None] * dist.get_world_size()
    dist.all_gather_object(peaks, mine)
    return peaks


def _reset_peak(dev):
    """Free what earlier runs left (a trainer whose optimizer step a
    recorder wraps is a reference cycle: only the collector frees it) and
    restart the card's peak."""
    import torch

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)


def _gib(peaks) -> str:
    return ("not measured" if peaks[0] is None else
            "[" + ", ".join(f"{b / 2 ** 30:.2f}" for b in peaks) + "] GiB")


class _Pretrain:
    """The Slam recipe's pretraining runs of this rank (the meshes and fsdp
    legs): the corpus (rank 0 writes it), the trainer of a mesh, the
    one-card reference, and one mesh's checked and timed run."""

    def __init__(self, dev, work: pathlib.Path, cfg, context: int, rows: int, n_rows: int,
                 lengths, say, sync, multihost: bool = False):
        import torch.distributed as dist

        from ..data import parse_single_dataset
        from ..tokeniser import UnitTokeniser
        from .slam_recipe import write_markov_corpus

        self.dev, self.work, self.cfg, self.context, self.rows = dev, work, cfg, context, rows
        self.say, self.sync, self.multihost = say, sync, multihost
        self.rank, self.world = dist.get_rank(), dist.get_world_size()
        self.lead, self.cuda = self.rank == 0, dev.type == "cuda"
        if self.lead:
            write_markov_corpus(work / "tokens.jsonl", n_rows, lengths)
        dist.barrier()
        self.ds = parse_single_dataset({"data": {}, "model": {"context_len": context}},
                                       UnitTokeniser(), str(work / "tokens.jsonl"))["train"]
        self.dcfg = cfg.decoder_config()
        self.ref = None

    def trainer(self, out, mesh, n_data, **over):
        from ..models import UnitLM
        from ..trainer import SLAMTrainer, TrainerCallback
        from .slam_recipe import slam_training_args

        sync = self.sync

        class Clock(TrainerCallback):
            def __init__(self):
                self.marks = []

            def on_step_end(self, args, state, control, **kw):
                sync()
                self.marks.append((time.perf_counter(), state.num_input_tokens_seen))

        args = slam_training_args(str(out), per_device_train_batch_size=self.rows // n_data,
                                  gradient_accumulation_steps=MICRO, max_steps=STEPS,
                                  save_steps=3, multihost=self.multihost, **over)
        model = UnitLM(self.cfg, seed=0, device=self.dev)
        clock = Clock()
        return SLAMTrainer(model, args, self.ds, callbacks=[clock], packing=True,
                           context_len=self.context, mesh=mesh), clock

    @staticmethod
    def timed(marks) -> dict:
        """Steps 2-3 from (time, tokens seen) at each step's end (step 1
        warms up; step 4 follows the step-3 save)."""
        (t1, n1), (t3, n3) = marks[0], marks[2]
        secs = (t3 - t1) / 2
        return {"step_s": secs, "tokens_per_s": (n3 - n1) / 2 / secs}

    def reference(self, result: dict) -> Optional[dict]:
        """The global batch on rank 0's card alone (kept in `result`, and
        returned on rank 0): the STEPS steps' losses, step 1's gradient norm,
        steps 2-3's time."""
        import torch.distributed as dist

        from ..parallel import Mesh

        if self.lead and "one_card" not in result:
            tr, _ = self.trainer(self.work / "ref", Mesh(("data",), (1,)), 1)
            norms = _grad_norm_recorder(tr)
            batches = tr.train_batcher.epoch(0)
            losses, marks, seen = [], [], 0
            for _ in range(STEPS):
                loss, tokens = tr._train_step([next(batches) for _ in range(MICRO)])
                losses.append(float(loss))
                self.sync()
                seen += tokens
                marks.append((time.perf_counter(), seen))
            ref = {"loss": losses[0], "losses": losses, "grad_norm": norms[0],
                   **self.timed(marks)}
            self.say(f"one card: step 1 loss {ref['loss']:.6f}, gradient norm "
                     f"{ref['grad_norm']:.6f}; {ref['step_s']:.4f} s a step, "
                     f"{ref['tokens_per_s']:.1f} tokens/s")
            result["one_card"] = ref
            del tr
        dist.barrier()
        return result.get("one_card")

    def mesh_run(self, name: str, shape: list, axes, schedule: str, ref: Optional[dict],
                 fsdp: bool = False, one_card_resume: bool = False) -> dict:
        """One mesh (module docstring): trained for STEPS steps with a save at
        3, every step's loss and step 1's gradient norm checked against `ref`
        (rank 0's), and resumed; with `fsdp` its parameters sharded,
        `one_card_resume` rank 0 resumes its checkpoint-3 alone."""
        import torch
        import torch.distributed as dist

        from ..ops import flash_attention_bwd, flash_attention_fwd
        from ..parallel import Mesh, make_mesh
        from ..parallel.fsdp import local

        rank, world, lead, cuda, say = self.rank, self.world, self.lead, self.cuda, self.say
        mesh = make_mesh(shape, axes)
        n_data = mesh.shape["data"]
        out_a, out_b, out_c = (self.work / f"{name}_{x}" for x in "abc")
        over = dict(mesh_shape=shape, mesh_axes=axes, cp_schedule=schedule, fsdp=fsdp)
        _reset_peak(self.dev)
        tr, clock = self.trainer(out_a, mesh, n_data, **over)
        norms = _grad_norm_recorder(tr)
        flash_attention_fwd.launches = flash_attention_bwd.launches = 0   # the main path
        state = tr.train()
        launches = {"flash_fwd": flash_attention_fwd.launches,
                    "flash_bwd": flash_attention_bwd.launches}
        want = (expected_launches(shape, axes, schedule, rank, self.dcfg.num_layers) if cuda
                else {"flash_fwd": 0, "flash_bwd": 0})
        _require(launches == want, f"rank {rank} {name}: launches {launches}, expected {want}")
        losses = [r["loss"] for r in state.log_history if "loss" in r]
        row = {"mesh_shape": shape, "mesh_axes": axes, "cp_schedule": schedule, "fsdp": fsdp,
               "nodes": mesh.nodes, "cross_node_axes": list(mesh.cross_node_axes),
               "losses": losses, "grad_norm_step1": norms[0], **self.timed(clock.marks),
               "max_memory_allocated": _peaks(self.dev)}
        launch_counts = [None] * world
        dist.all_gather_object(launch_counts, launches)
        row["launches_by_rank"] = launch_counts
        if mesh.shape.get("model", 1) > 1:   # tensor parallel: the replicas agree
            # ... across 'model' (the whole parameters), and beside a 'seq'
            # axis across 'seq' (every parameter, the slices too)
            for axis, key in (("model", "replicated_bitwise_equal"),
                              ("seq", "seq_replicas_bitwise_equal")):
                if mesh.shape.get(axis, 1) == 1:
                    continue
                differ = _replicas_equal(tr.model.decoder, mesh, axis)
                flags = torch.tensor([len(differ)], device=self.dev)
                dist.all_reduce(flags, op=dist.ReduceOp.MAX)
                row[key] = not flags.item()
                _require(not differ, f"rank {rank} {name}: parameters differ across the "
                         f"'{axis}' line: {differ}")
        # one more step under the profiler on rank 0 (every rank steps)
        batches = tr.train_batcher.epoch(0, skip_batches=STEPS * MICRO)
        group = [next(batches) for _ in range(MICRO)]
        params_a = {k: local(p.detach()).clone()
                    for k, p in tr.model.decoder.named_parameters()}
        _, wall_ms, prof = _profiled(lead, cuda, self.sync, lambda: tr._train_step(group))
        if lead:
            row["profiled_step"] = _comm_shares(prof, wall_ms)
        del tr
        # the resume: a second trainer from checkpoint-3 repeats step 4
        tr_b, _ = self.trainer(out_b, mesh, n_data, **over)
        state_b = tr_b.train(resume_from_checkpoint=str(out_a / "checkpoint-3"))
        losses_b = [r["loss"] for r in state_b.log_history if "loss" in r]
        same = losses_b == losses and all(
            torch.equal(local(p), params_a[k]) for k, p in tr_b.model.decoder.named_parameters())
        flags = torch.tensor([int(same)], device=self.dev)
        dist.all_reduce(flags, op=dist.ReduceOp.MIN)
        row["resume_exact"] = bool(flags.item())
        del tr_b, params_a
        if cuda:
            torch.cuda.empty_cache()
        if one_card_resume and lead:
            # the one-rank checkpoint of the sharded run, on one card
            tr_c, _ = self.trainer(out_c, Mesh(("data",), (1,)), 1)
            state_c = tr_c.train(resume_from_checkpoint=str(out_a / "checkpoint-3"))
            step4 = [r["loss"] for r in state_c.log_history if "loss" in r][-1]
            row["one_card_resume"] = {"loss_step4": step4,
                                      "loss_err": abs(step4 - losses[-1])}
            del tr_c
            if cuda:
                torch.cuda.empty_cache()
        dist.barrier()
        if mesh.shape.get("seq", 1) > 1 and not fsdp:
            row["ring"] = check_ring(self.dev, mesh, schedule, self.dcfg, self.rows,
                                     self.context, self.dcfg.compute_dtype)
        dist.barrier()
        if lead:
            for out in (out_a, out_b, out_c):
                shutil.rmtree(out, ignore_errors=True)
            loss_err = abs(losses[0] - ref["loss"])
            norm_err = abs(norms[0] - ref["grad_norm"]) / ref["grad_norm"]
            losses_err = max(abs(a - b) for a, b in zip(losses, ref["losses"]))
            row.update(loss_err=loss_err, grad_norm_rel_err=norm_err, losses_max_err=losses_err)
            p = row.get("profiled_step", {})
            say(f"{name} {shape}{' fsdp' if fsdp else ''}{f' {axes}' if axes else ''}: losses "
                f"{losses}; step 1 |d loss| "
                f"{loss_err:.3e} (<= {LOSS_BOUND}), gradient norm {norms[0]:.6f} rel "
                f"{norm_err:.3e} (<= {GRAD_NORM_RTOL}); all {STEPS} losses |d| <= "
                f"{losses_err:.3e} (<= {LOSS_BOUND}); "
                f"{row['step_s']:.4f} s a step, "
                f"{row['tokens_per_s']:.1f} tokens/s; peak memory "
                f"{_gib(row['max_memory_allocated'])}; P2P {p.get('p2p_share', 0):.4f}, "
                f"all-reduce {p.get('all_reduce_share', 0):.4f}, all-gather "
                f"{p.get('all_gather_share', 0):.4f}, reduce-scatter "
                f"{p.get('reduce_scatter_share', 0):.4f} of a {p.get('wall_ms', 0):.1f} ms "
                f"profiled step, NCCL overlapped {p.get('nccl_overlapped_share', 0):.4f}; "
                f"resume exact {row['resume_exact']}; launches {launch_counts}"
                + (f"; replicated parameters bitwise equal across 'model' "
                   f"{row['replicated_bitwise_equal']}" if "replicated_bitwise_equal" in row
                   else "")
                + (f"; every parameter bitwise equal across 'seq' "
                   f"{row['seq_replicas_bitwise_equal']}"
                   if "seq_replicas_bitwise_equal" in row else ""))
            if "ring" in row:
                say(f"{name} ring vs one call (rank 0): {row['ring']['max_abs_err']}")
            if "one_card_resume" in row:
                say(f"{name}: checkpoint-3 resumed on one card: step 4 loss "
                    f"{row['one_card_resume']['loss_step4']:.6f}, |d| "
                    f"{row['one_card_resume']['loss_err']:.3e} (<= {LOSS_BOUND})")
                _require(row["one_card_resume"]["loss_err"] <= LOSS_BOUND,
                         f"{name}: the one-card resume of the sharded checkpoint disagrees")
            _require(loss_err <= LOSS_BOUND and norm_err <= GRAD_NORM_RTOL,
                     f"{name}: step 1 disagrees with the one-card run")
            _require(losses_err <= LOSS_BOUND,
                     f"{name}: the losses {losses} disagree with the one-card run's "
                     f"{ref['losses']}")
        _require(row["resume_exact"], f"{name}: the resumed run did not repeat step 4")
        dist.barrier()
        return row


def run_meshes(pretrain: _Pretrain, result: dict):
    """The pretraining leg (module docstring) on this rank, into rank 0's
    `result`: the one-card reference, the four meshes, DP's efficiency."""
    ref = pretrain.reference(result)
    result["meshes"] = {}
    for name, shape, axes, schedule in meshes(pretrain.world):
        result["meshes"][name] = pretrain.mesh_run(name, shape, axes, schedule, ref)
    if pretrain.lead:
        dp = result["meshes"]["dp"]
        result["dp_scaling_efficiency"] = dp["tokens_per_s"] / (pretrain.world *
                                                                ref["tokens_per_s"])
        pretrain.say(f"DP on {pretrain.world} cards: {dp['tokens_per_s']:.1f} tokens/s "
                     f"against {ref['tokens_per_s']:.1f} on one: scaling efficiency "
                     f"{result['dp_scaling_efficiency']:.4f}")


def run_fsdp(pretrain: _Pretrain, result: dict, eval_sizes: dict) -> dict:
    """The fsdp leg (module docstring) on this rank; rank 0 returns its row."""
    n = pretrain.world
    ref = pretrain.reference(result)
    row = {"meshes": {}}
    dp = result.get("meshes", {}).get("dp")
    if dp is None:   # the unsharded DP [N] beside it
        dp = pretrain.mesh_run("dp", [n], None, "contiguous", ref)
    row["dp"] = dp
    row["meshes"]["fsdp"] = pretrain.mesh_run("fsdp", [n], None, "contiguous", ref, fsdp=True,
                                              one_card_resume=True)
    row["meshes"]["fsdp_dp_cp"] = pretrain.mesh_run(
        "fsdp_dp_cp", [2, n // 2], ["data", "seq"], "contiguous", ref, fsdp=True)
    if pretrain.lead:
        got = row["meshes"]["fsdp"]
        pretrain.say(f"fsdp [{n}] against DP [{n}]: {got['step_s']:.4f} / {dp['step_s']:.4f} "
                     f"s a step, {got['tokens_per_s']:.1f} / {dp['tokens_per_s']:.1f} "
                     f"tokens/s; peak memory {_gib(got['max_memory_allocated'])} / "
                     f"{_gib(dp['max_memory_allocated'])}")
    args = (pretrain.dev, pretrain.work, pretrain.cfg, pretrain.say, pretrain.sync)
    row["dpo"] = run_dpo(*args, fsdp=True)
    row["eval"] = run_eval(*args, pretrain.context, fsdp=True, **eval_sizes)
    return row


def run_tp(pretrain: _Pretrain, result: dict) -> dict:
    """The tp leg (module docstring) on this rank; rank 0 returns its row."""
    n = pretrain.world
    ref = pretrain.reference(result)
    row = {}
    dp = (result.get("meshes", {}).get("dp") or result.get("fsdp", {}).get("dp")
          or pretrain.mesh_run("dp", [n], None, "contiguous", ref, one_card_resume=True))
    row["dp"] = dp
    row["tp"] = pretrain.mesh_run("tp", [2, n // 2], ["data", "model"], "contiguous", ref,
                                  one_card_resume=True)
    if pretrain.lead:
        got = row["tp"]
        pretrain.say(f"tp [2, {n // 2}] against DP [{n}] and one card: {got['step_s']:.4f} / "
                     f"{dp['step_s']:.4f} / {ref['step_s']:.4f} s a step, "
                     f"{got['tokens_per_s']:.1f} / {dp['tokens_per_s']:.1f} / "
                     f"{ref['tokens_per_s']:.1f} tokens/s; peak memory "
                     f"{_gib(got['max_memory_allocated'])} / {_gib(dp['max_memory_allocated'])}")
    return row


def run_tp_fsdp(pretrain: _Pretrain, result: dict) -> dict:
    """The tp_fsdp leg (module docstring) on this rank; rank 0 returns its
    rows: TP [2, N / 2], fsdp [N] (an earlier leg's rows where it ran them)
    and TP + fsdp [2, N / 2]."""
    n = pretrain.world
    ref = pretrain.reference(result)
    tp_axes = ["data", "model"]
    row = {"tp": result.get("tp", {}).get("tp") or pretrain.mesh_run(
               "tp", [2, n // 2], tp_axes, "contiguous", ref, one_card_resume=True),
           "fsdp": result.get("fsdp", {}).get("meshes", {}).get("fsdp") or pretrain.mesh_run(
               "fsdp", [n], None, "contiguous", ref, fsdp=True, one_card_resume=True)}
    row["tp_fsdp"] = pretrain.mesh_run("tp_fsdp", [2, n // 2], tp_axes, "contiguous", ref,
                                       fsdp=True, one_card_resume=True)
    if pretrain.lead:
        got, tp, fs = row["tp_fsdp"], row["tp"], row["fsdp"]
        pretrain.say(f"tp_fsdp [2, {n // 2}] against TP [2, {n // 2}], fsdp [{n}] and one "
                     f"card: {got['step_s']:.4f} / {tp['step_s']:.4f} / {fs['step_s']:.4f} / "
                     f"{ref['step_s']:.4f} s a step, {got['tokens_per_s']:.1f} / "
                     f"{tp['tokens_per_s']:.1f} / {fs['tokens_per_s']:.1f} / "
                     f"{ref['tokens_per_s']:.1f} tokens/s; peak memory "
                     f"{_gib(got['max_memory_allocated'])} / {_gib(tp['max_memory_allocated'])}"
                     f" / {_gib(fs['max_memory_allocated'])}")
    return row


def run_tp_fsdp_sims7b(dev, work: pathlib.Path, say, sync, result: dict, **sims) -> dict:
    """The tp_fsdp_sims7b leg (module docstring) on this rank: the sims7b
    leg on TP + fsdp [2, N / 2] beside fsdp [N] and TP [1, N] (the sims7b
    and tp_sims7b legs' rows where they ran); rank 0 returns the rows."""
    import torch.distributed as dist

    row = {"fsdp": result.get("sims7b") or run_sims7b(dev, work, say, sync, layout="fsdp",
                                                      **sims),
           "tp": result.get("tp_sims7b") or run_sims7b(dev, work, say, sync, layout="tp",
                                                       **sims)}
    row["tp_fsdp"] = run_sims7b(dev, work, say, sync, layout="tp_fsdp", **sims)
    if dist.get_rank() == 0:
        rows = [row[k] for k in ("tp_fsdp", "tp", "fsdp")]
        mfu = lambda r: "not measured" if r["mfu"] is None else f"{r['mfu']:.4f}"
        say(f"sims7b TP + fsdp {rows[0]['mesh_shape']} against TP {rows[1]['mesh_shape']} and "
            f"fsdp {rows[2]['mesh_shape']}: "
            + " / ".join(f"{r['timed_step_s']:.4f}" for r in rows) + " s a step, "
            + " / ".join(f"{r['tokens_per_s']:.1f}" for r in rows) + " tokens/s, MFU "
            + " / ".join(mfu(r) for r in rows) + "; peak memory training "
            + " / ".join(_gib(r["max_memory_allocated"]) for r in rows) + ", building "
            + " / ".join(_gib(r["init_max_memory_allocated"]) for r in rows))
    return row


def run_tp_seq(pretrain: _Pretrain, result: dict) -> dict:
    """The tp_seq leg (module docstring) on this rank; rank 0 returns its
    rows: TP [2, N / 2] and CP [1, N] contiguous (an earlier leg's rows where
    it ran them), then [1, 2, N / 2] over ('data', 'model', 'seq') in both
    schedules."""
    n = pretrain.world
    if n < 4:   # [1, 2, 1] would be TP alone
        pretrain.say(f"tp_seq: {n} ranks; a 'seq' axis of 2 beside 'model' = 2 needs 4 or more")
        return {"skipped": f"{n} ranks"}
    ref = pretrain.reference(result)
    axes = ["data", "model", "seq"]
    row = {"tp": (result.get("tp", {}).get("tp") or result.get("tp_fsdp", {}).get("tp")
                  or pretrain.mesh_run("tp", [2, n // 2], ["data", "model"], "contiguous",
                                       ref, one_card_resume=True)),
           "cp_contiguous": (result.get("meshes", {}).get("cp_contiguous")
                             or pretrain.mesh_run("cp_contiguous", [1, n], ["data", "seq"],
                                                  "contiguous", ref))}
    for schedule in ("contiguous", "zigzag"):
        row[f"tp_seq_{schedule}"] = pretrain.mesh_run(
            f"tp_seq_{schedule}", [1, 2, n // 2], axes, schedule, ref, one_card_resume=True)
    if pretrain.lead:
        rows = [row[k] for k in ("tp_seq_contiguous", "tp_seq_zigzag", "tp", "cp_contiguous")]
        pretrain.say(f"tp_seq [1, 2, {n // 2}] contiguous / zigzag against TP [2, {n // 2}], "
                     f"CP [1, {n}] contiguous and one card: "
                     + " / ".join(f"{r['step_s']:.4f}" for r in rows)
                     + f" / {ref['step_s']:.4f} s a step, "
                     + " / ".join(f"{r['tokens_per_s']:.1f}" for r in rows)
                     + f" / {ref['tokens_per_s']:.1f} tokens/s; peak memory "
                     + " / ".join(_gib(r["max_memory_allocated"]) for r in rows))
    return row


def run_nodes(pretrain: _Pretrain, result: dict, dp_only: bool = False) -> dict:
    """The nodes legs (module docstring) on this rank: DP [N] and TP [2, N /
    2] as the tp leg runs them, then fsdp [N] with a one-card resume; DP
    alone with `dp_only`. Rank 0 returns the rows by mesh."""
    n, ref = pretrain.world, pretrain.reference(result)
    if dp_only:
        rows = {"dp": pretrain.mesh_run("dp", [n], None, "contiguous", ref,
                                        one_card_resume=True)}
    else:
        rows = run_tp(pretrain, result)
        rows["fsdp"] = pretrain.mesh_run("fsdp", [n], None, "contiguous", ref, fsdp=True,
                                         one_card_resume=True)
    if pretrain.lead:
        for name, got in rows.items():
            pretrain.say(f"nodes {name}: {got['nodes']} nodes, axes crossing them "
                         f"{got['cross_node_axes']}; {got['step_s']:.4f} s a step against one "
                         f"card's {ref['step_s']:.4f}")
    return rows


def _prefill_logits(decoder, prompts):
    """The last position's logits (whole vocabulary) of `generate`'s
    prefill of the left-padded `prompts` (pad 0) through `decoder`."""
    import torch

    from ..parallel.tensor import gather_vocab

    mask = (prompts != 0).to(torch.int32)
    positions = (torch.cumsum(mask, dim=1) - 1).clamp(min=0)
    seg = torch.where(mask > 0, 0, -1).to(torch.int32)
    with torch.inference_mode():
        logits, _ = decoder(prompts, positions=positions, segment_ids=seg)
        return gather_vocab(logits[:, -1], decoder.tp).float()


def run_dpo(dev, work: pathlib.Path, cfg, say, sync, pairs: int = DPO_PAIRS,
            prompt_len: int = DPO_PROMPT, completion_len: int = DPO_COMPLETION,
            fsdp: bool = False) -> dict:
    """The DPO leg (module docstring) on this rank, with `fsdp` the policy
    and the reference sharded; rank 0 returns its row."""
    import torch
    import torch.distributed as dist

    from ..config import compose
    from ..models import UnitLM
    from ..ops import flash_attention_bwd, flash_attention_fwd
    from ..parallel import Mesh, make_mesh
    from ..parallel.fsdp import local
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
            f"training_args.fsdp={str(fsdp).lower()}", "data.train_path=-",
            "data.val_path=-"]).training_args
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
    _reset_peak(dev)
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
    row = {"mesh_shape": [world], "fsdp": fsdp, "losses": got, "grad_norm_step1": norms[0],
           "step_s": secs, "pairs_per_s": pairs / secs, "max_memory_allocated": _peaks(dev)}
    launch_counts = [None] * world
    dist.all_gather_object(launch_counts, launches)
    row["launches_by_rank"] = launch_counts
    # one more step under the profiler
    order = np.random.default_rng(0).permutation(len(rows))
    extra = [tr.train_rows[i] for i in order[:pairs]]
    params_a = {k: local(p.detach()).clone() for k, p in tr.model.decoder.named_parameters()}
    _, wall_ms, prof = _profiled(lead, cuda, sync, lambda: tr._train_step(extra))
    if lead:
        row["profiled_step"] = _comm_shares(prof, wall_ms)
    del tr
    tr_b, _, _ = trainer(work / "dpo_b", mesh, world)
    state_b = tr_b.train(resume_from_checkpoint=str(work / "dpo_a" / f"checkpoint-{DPO_STEPS - 1}"))
    same = losses(state_b) == got and all(
        torch.equal(local(p), params_a[k]) for k, p in tr_b.model.decoder.named_parameters())
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
        say(f"dpo [{world}]{' fsdp' if fsdp else ''}, {pairs} pairs of "
            f"{prompt_len + completion_len + 2} tokens a "
            f"step: losses {got} (one card {ref['losses']}); steps 1-2 |d loss| "
            f"{loss_err:.3e} (<= {LOSS_BOUND}), step-1 gradient norm {norms[0]:.6f} rel "
            f"{norm_err:.3e} (<= {GRAD_NORM_RTOL}); {secs:.4f} s a step, "
            f"{row['pairs_per_s']:.1f} pairs/s (one card {ref['step_s']:.4f} s, "
            f"{ref['pairs_per_s']:.1f} pairs/s); peak memory "
            f"{_gib(row['max_memory_allocated'])}; all-reduce {p['all_reduce_share']:.4f}, "
            f"all-gather {p['all_gather_share']:.4f}, reduce-scatter "
            f"{p['reduce_scatter_share']:.4f} of a {p['wall_ms']:.1f} ms profiled step; "
            f"resume exact {row['resume_exact']}; launches {launch_counts}")
        _require(loss_err <= LOSS_BOUND and norm_err <= GRAD_NORM_RTOL,
                 "dpo: steps 1-2 disagree with the one-card run")
    _require(row["resume_exact"], "dpo: the resumed run did not repeat step 3")
    dist.barrier()
    return row


def run_eval(dev, work: pathlib.Path, cfg, say, sync, context: int = CONTEXT,
             pairs: int = EVAL_PAIRS, batch: int = EVAL_BATCH, n_prompts: int = EVAL_PROMPTS,
             new_tokens: int = EVAL_NEW, fsdp: bool = False, tp: bool = False) -> dict:
    """The evaluation leg (module docstring) on this rank, with `fsdp` the
    weights sharded too (`UnitLM.shard(mesh, fsdp=True)`), with `tp` split
    over the 'model' axis of [2, N / 2] in float32 (`UnitLM.shard(mesh,
    tp=True)`); rank 0 returns its row."""
    import torch
    import torch.distributed as dist

    from ..models import UnitLM
    from ..ops import dq_matmul, flash_attention_fwd
    from ..parallel import make_mesh

    rank, world = dist.get_rank(), dist.get_world_size()
    lead, cuda = rank == 0, dev.type == "cuda"
    cfg = dataclasses.replace(cfg, remat=False, **({"torch_dtype": "float32"} if tp else {}))
    shape, axes = ([2, world // 2], ["data", "model"]) if tp else ([world], None)
    n_tiles = shape[0]
    counter = "f32_launches" if tp else "launches"
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
    if lead:   # one card: the whole batches, and each tile's rows of the prompts alone
        score(tlm)   # warm-up
        one["ll"], one["score_s"] = timed(lambda: score(tlm))
        one["sampled"], one["generate_s"] = timed(lambda: tlm.generate(prompts, **sampled))
        per = -(-n_prompts // n_tiles)
        tiles = [prompts[r * per:(r + 1) * per] for r in range(n_tiles)]
        one["greedy"] = torch.cat([tlm.generate(t, **greedy) for t in tiles if len(t)])
        one["int8"] = torch.cat([tlm.generate(t, weight_quant="int8", **greedy)
                                 for t in tiles if len(t)])
        if tp:
            one["int8_logits"] = _prefill_logits(tlm._int8_decode_params(),
                                                 torch.from_numpy(prompts).to(dev))
            tlm._int8_cache = None
    dist.barrier()
    _reset_peak(dev)
    mesh = make_mesh(shape, axes)
    tlm.shard(mesh, fsdp=fsdp, tp=tp)
    score(tlm)   # warm-up
    setattr(flash_attention_fwd, counter, 0)   # the main path
    dq_matmul.launches = 0
    ll, score_s = timed(lambda: score(tlm))
    greedy_out = tlm.generate(prompts, **greedy)
    int8_out = tlm.generate(prompts, weight_quant="int8", **greedy)
    sampled_out, generate_s = timed(lambda: tlm.generate(prompts, **sampled))
    launches = {"flash_fwd": getattr(flash_attention_fwd, counter),
                "dq_matmul": dq_matmul.launches}
    int8_logits = (_prefill_logits(tlm._int8_decode_params(), torch.from_numpy(prompts).to(dev))
                   if tp else None)
    again, wall_ms, prof = _profiled(lead, cuda, sync, lambda: tlm.generate(prompts, **sampled))
    _require(torch.equal(again, sampled_out), f"rank {rank} eval: a sampled call did not repeat")
    _require(not cuda or (launches["flash_fwd"] > 0 and launches["dq_matmul"] > 0),
             f"rank {rank} eval: launches {launches}")
    launch_counts = [None] * world
    dist.all_gather_object(launch_counts, launches)
    row = {"mesh_shape": shape, "mesh_axes": axes, "fsdp": fsdp, "tp": tp,
           "dtype": cfg.torch_dtype or "bfloat16", "score_s": score_s,
           "pairs_per_s": pairs / score_s, "generate_s": generate_s,
           "new_tokens_per_s": n_prompts * new_tokens / generate_s,
           "launches_by_rank": launch_counts, "max_memory_allocated": _peaks(dev)}
    if lead:
        ll_err = (ll - one["ll"]).abs().max().item()
        greedy_same = torch.equal(greedy_out, one["greedy"])
        int8_same = torch.equal(int8_out, one["int8"])
        new = slice(prompts.shape[1], None)
        agree = (sampled_out[:, new] == one["sampled"][:, new]).float().mean().item()
        if tp:
            d = (int8_logits - one["int8_logits"]).abs().max().item()
            bound = int8_tp_atol(one["int8_logits"], cfg.decoder_config().num_layers)
            int8_agree = (int8_out[:, new] == one["int8"][:, new]).float().mean().item()
            row.update(int8_prefill_max_abs_err=d, int8_prefill_bound=bound,
                       int8_token_agreement=int8_agree,
                       sampled_bitwise=bool(torch.equal(sampled_out, one["sampled"])))
        row.update(one_card={"score_s": one["score_s"],
                             "pairs_per_s": pairs / one["score_s"],
                             "generate_s": one["generate_s"],
                             "new_tokens_per_s": n_prompts * new_tokens / one["generate_s"]},
                   ll_max_abs_err=ll_err, ll_bitwise=bool(torch.equal(ll, one["ll"])),
                   greedy_bitwise=greedy_same, int8_greedy_bitwise=int8_same,
                   sampled_token_agreement=agree, profiled_generate=_comm_shares(prof, wall_ms))
        say(f"eval {shape} (UnitLM.shard{'(fsdp=True)' if fsdp else ''}"
            f"{'(tp=True), ' + row['dtype'] if tp else ''}): {2 * pairs} rows "
            f"of 100-{context} scored in "
            f"batches of {batch}, max |d ll| {ll_err:.3e} (<= {EVAL_LL_BOUND}; bitwise "
            f"{row['ll_bitwise']}), {score_s:.4f} s, {row['pairs_per_s']:.1f} pairs/s (one "
            f"card {one['score_s']:.4f} s); {n_prompts} prompts x {new_tokens} new tokens: "
            f"greedy and int8 greedy equal each rank's rows decoded alone {greedy_same} "
            f"{int8_same}; sampled {row['generate_s']:.4f} s, {row['new_tokens_per_s']:.1f} "
            f"new tokens/s (one card {one['generate_s']:.4f} s), tokens equal to one card's "
            f"{agree:.4f}, all-gather {row['profiled_generate']['all_gather_share']:.4f} of "
            f"a {wall_ms:.1f} ms profiled call; peak memory "
            f"{_gib(row['max_memory_allocated'])}; launches {launch_counts}")
        if tp:
            say(f"eval tp: int8 prefill max |d logits| {row['int8_prefill_max_abs_err']:.3e} "
                f"(<= {row['int8_prefill_bound']:.3e}), int8 tokens equal to one card's "
                f"{row['int8_token_agreement']:.4f}; sampled bit for bit "
                f"{row['sampled_bitwise']}")
            _require(ll_err <= EVAL_LL_BOUND and greedy_same and row["sampled_bitwise"]
                     and row["int8_prefill_max_abs_err"] <= row["int8_prefill_bound"],
                     "eval tp: the scores, greedy or sampled tokens or the int8 prefill "
                     "disagree with one card")
        else:
            _require(ll_err <= EVAL_LL_BOUND and greedy_same and int8_same,
                     "eval: the sharded scores or greedy tokens disagree with one card")
    del tlm
    if cuda:
        torch.cuda.empty_cache()
    dist.barrier()
    return row


def _unsharded_loss(model, group, dev) -> float:
    """The trainer's loss of a step's `group` of global host batches,
    computed by `model` (whole on this card) without gradients, a row at a
    time: each row's summed NLL over the group's valid-target count."""
    import torch

    from ..data.dataset import IGNORE_INDEX

    num_items = sum(int((mb["labels"] != IGNORE_INDEX).sum()) for mb in group)
    total = 0.0
    with torch.no_grad():
        for mb in group:
            for r in range(len(mb["input_ids"])):
                row = {k: torch.from_numpy(np.ascontiguousarray(mb[k][r:r + 1])).to(dev)
                       for k in ("input_ids", "labels", "segment_ids", "positions")}
                total += float(model.loss_fn({**row, "num_items_in_batch": num_items}))
    return total


def _shard_sums(decoder):
    """Each parameter's local shard summed in float64, in
    `named_parameters` order (an empty shard sums to 0)."""
    import torch

    from ..parallel.fsdp import local

    with torch.no_grad():
        return torch.stack([local(p).sum(dtype=torch.float64)
                            for p in decoder.parameters()])


def run_sims7b(dev, work: pathlib.Path, say, sync, arch=None, n_entries: Optional[int] = None,
               context: int = SIMS_CONTEXT, per_device: int = SIMS_PER_DEVICE,
               steps: int = SIMS_STEPS, n_rows: int = 96, lengths=(300, 700),
               layout: str = "fsdp") -> dict:
    """The sims7b leg (module docstring) on this rank: `--config-name
    train_inter_scale` at Qwen2.5-7B's widths (`arch` replaces them in a
    rehearsal) on `layout` (SIMS_LAYOUTS: fsdp over every rank, TP [1, N]
    over ('data', 'model') without fsdp, or TP + fsdp [2, N / 2]); rank 0
    returns its row."""
    import torch
    import torch.distributed as dist

    from ..config import compose
    from ..data.dataset import Batcher, init_dataset
    from ..models.unit_lm import tlm_factory
    from ..ops import flash_attention_bwd, flash_attention_fwd
    from ..parallel import make_mesh
    from ..tokeniser import tokeniser_factory
    from ..trainer import SLAMTrainer
    from . import sims_recipe

    rank, world = dist.get_rank(), dist.get_world_size()
    lead, cuda = rank == 0, dev.type == "cuda"
    shape, axes, fsdp = SIMS_LAYOUTS[layout](world)
    root = work / "sims7b"
    if lead:
        t0 = time.perf_counter()
        sims_recipe.write_base_dir(root, n_entries=n_entries or sims_recipe.QWEN25_VOCAB,
                                   preset="Qwen/Qwen2.5-7B", arch=arch)
        sims_recipe.write_corpora(root, n_rows, lengths)
        say(f"sims7b: base directory and corpora written in {time.perf_counter() - t0:.1f} s")
    dist.barrier()
    base = root / "base"
    cfg = compose(str(ROOT / "config"), "train_inter_scale", [
        f"model.config_args.base_model_name={base}", "model.config_args.twist_init=false",
        f"tokeniser.params.text_tokeniser_path={base}",
        f"data.train_path=[{root / 'text.jsonl'},{root / 'inter.jsonl'},"
        f"{root / 'speech.jsonl'}]", "data.val_path=null", f"model.context_len={context}",
        "logger=print", f"training_args.output_dir={root / 'run'}",
        f"training_args.max_steps={steps}",
        f"training_args.per_device_train_batch_size={per_device}",
        f"training_args.fsdp={str(fsdp).lower()}", "training_args.remat=true",
        "training_args.save_steps=0",
        *([] if cuda else ["training_args.use_cpu=true",
                           "model.config_args.torch_dtype=float32"])])
    # cli.train's own steps up to its trainer, which would save the state
    # at the end of its run
    tokeniser = tokeniser_factory(cfg.tokeniser, device=dev)
    ds = init_dataset(cfg, tokeniser)["train"]
    cfg.model.config_args.vocab_size = len(tokeniser.text_tokeniser)
    cfg.model.config_args.remat = True
    args = cfg.training_args
    _reset_peak(dev)
    t0 = time.perf_counter()
    model = tlm_factory(cfg.model, device=dev)
    sync()
    init_s = time.perf_counter() - t0
    dcfg = model.decoder.cfg
    n_params = sum(p.numel() for p in model.parameters())
    state_dtype = str(args.get("optim_state_dtype", "float32") or "float32")
    state_bytes = n_params * (4 + 4 + 2 * (2 if state_dtype == "bfloat16" else 4))
    # step 1's global batch, as the trainer's batcher will draw it
    mesh = make_mesh(shape, axes)
    accum = int(args.get("gradient_accumulation_steps", 1) or 1)
    batcher = Batcher(ds, per_device * mesh.shape["data"], context,
                      pad_id=model.config.pad_token_id, packing=True, shuffle=True,
                      seed=int(args.get("seed", 0)),
                      packing_strategy=cfg.data.get("packing_strategy", "bestfit"))
    stream = batcher.epoch(0)
    first = [next(stream) for _ in range(accum)]
    ref_loss = None
    if lead:
        t0 = time.perf_counter()
        ref_loss = _unsharded_loss(model, first, dev)
        say(f"sims7b: {n_params} parameters ({dcfg.num_layers} layers of "
            f"{dcfg.hidden_size}, {dcfg.num_heads}/{dcfg.num_kv_heads} heads of "
            f"{dcfg.head_dim}, FFN {dcfg.intermediate_size}, vocab {dcfg.vocab_size}) built "
            f"in {init_s:.1f} s; step 1's batch unsharded on one card, a row at a time: "
            f"loss {ref_loss:.6f} ({time.perf_counter() - t0:.1f} s)")
    dist.barrier()
    init_peaks = _peaks(dev)
    tr = SLAMTrainer(model, args, ds, packing=True, context_len=context,
                     packing_strategy=cfg.data.get("packing_strategy", "bestfit"), mesh=mesh)
    del model
    _reset_peak(dev)
    norms = _grad_norm_recorder(tr)
    before = _shard_sums(tr.model.decoder)
    batches = tr.train_batcher.epoch(0)
    flash_attention_fwd.launches = flash_attention_bwd.launches = 0   # the main path
    losses, secs, tokens, prof, wall_ms = [], [], [], None, 0.0
    for step in range(steps):
        group = [next(batches) for _ in range(tr.accum)]
        tokens.append(int(sum((b["segment_ids"] >= 0).sum() for b in group)))
        if step == steps - 1:   # the last step under the profiler on rank 0
            (loss, _), wall_ms, prof = _profiled(lead, cuda, sync,
                                                 lambda: tr._train_step(group))
            secs.append(wall_ms / 1e3)
        else:
            sync()
            t0 = time.perf_counter()
            loss, _ = tr._train_step(group)
            sync()
            secs.append(time.perf_counter() - t0)
        losses.append(float(loss))
        if step == 0:
            del tr.optimizer.step   # the recorder's wrapper: steps 2-3 run unrecorded
    # every parameter's updates reached some rank's shard (step 1's learning
    # rate is 0, the warmup's start, so steps 2-3 move them)
    moved = (_shard_sums(tr.model.decoder) != before).to(torch.int32)
    dist.all_reduce(moved, op=dist.ReduceOp.MAX)
    unmoved = [n for (n, _), m in zip(tr.model.decoder.named_parameters(), moved) if not m]
    del before
    launches = {"flash_fwd": flash_attention_fwd.launches,
                "flash_bwd": flash_attention_bwd.launches}
    per_step = dcfg.num_layers * tr.accum
    want = ({"flash_fwd": 2 * per_step * steps, "flash_bwd": per_step * steps} if cuda
            else {"flash_fwd": 0, "flash_bwd": 0})
    _require(launches == want, f"rank {rank} sims7b: launches {launches}, expected {want}")
    launch_counts = [None] * world
    dist.all_gather_object(launch_counts, launches)
    peaks = _peaks(dev)
    card_bytes = torch.cuda.get_device_properties(dev).total_memory if cuda else None
    del tr
    if cuda:
        torch.cuda.empty_cache()
    dist.barrier()
    row = {"mesh_shape": list(mesh.sizes), "mesh_axes": list(mesh.axis_names), "fsdp": fsdp,
           "context": context, "rows_a_step": per_device * mesh.shape["data"] * accum,
           "parameters": n_params, "layers": dcfg.num_layers,
           "hidden_size": dcfg.hidden_size, "vocab_size": dcfg.vocab_size,
           "optim_state_dtype": state_dtype, "losses": losses, "reference_loss": ref_loss,
           "grad_norm_step1": norms[0], "unmoved_parameters": unmoved, "step_s": secs, "tokens": tokens, "launches_by_rank": launch_counts,
           "init_max_memory_allocated": init_peaks, "max_memory_allocated": peaks,
           "state_bytes": state_bytes, "card_bytes": card_bytes, "checkpoint": None}
    if lead:
        shutil.rmtree(root, ignore_errors=True)
        # a step's model FLOPs: 6 N a token over every parameter (the untied
        # input embedding's, a gather, included), plus the causal
        # attention's 6 L T d_q a token over the whole context T, not per
        # packed document (forward and backward, no remat recompute): an
        # upper count, so the MFU is one too
        flops = [n * (6 * n_params + 6 * dcfg.num_layers * context * dcfg.q_dim)
                 for n in tokens]
        timed = secs[1:-1] or secs[-1:]   # unprofiled steps after the first
        step_s = float(np.mean(timed))
        tokens_per_s = float(np.mean(tokens[1:len(timed) + 1])) / step_s
        mfu = (float(np.mean(flops[1:len(timed) + 1])) / step_s /
               (world * H100_BF16_FLOPS)) if cuda else None
        row.update(loss_err=abs(losses[0] - ref_loss), timed_step_s=step_s,
                   tokens_per_s=tokens_per_s, mfu=mfu,
                   profiled_step=_comm_shares(prof, wall_ms))
        p = row["profiled_step"]
        say(f"sims7b {layout} {row['mesh_shape']}: {row['rows_a_step']} rows "
            f"of {context} a step, losses "
            f"{losses}; step 1 |d loss| {row['loss_err']:.3e} against the unsharded "
            f"{ref_loss:.6f} (<= {LOSS_BOUND}), gradient norm {norms[0]:.6f}, parameters "
            f"not moved by step {steps} {unmoved}; s a step {secs} ({step_s:.4f} s unprofiled, "
            f"{tokens_per_s:.1f} tokens/s, MFU "
            f"{'not measured' if mfu is None else f'{mfu:.4f}'} against {world} x "
            f"{H100_BF16_FLOPS:.3g} FLOP/s); peak memory training {_gib(peaks)}, "
            f"building {_gib(init_peaks)}, whole state {state_bytes / 2 ** 30:.2f} GiB; "
            f"all-gather {p['all_gather_share']:.4f}, reduce-scatter "
            f"{p['reduce_scatter_share']:.4f}, all-reduce {p['all_reduce_share']:.4f} of the "
            f"{wall_ms:.1f} ms profiled step 3, NCCL overlapped "
            f"{p['nccl_overlapped_share']:.4f}; launches {launch_counts}; no checkpoint "
            f"(the one-rank state would be {state_bytes / 1e9:.1f} GB with its moments)")
        _require(row["loss_err"] <= LOSS_BOUND, "sims7b: step 1 disagrees with the "
                 "unsharded loss")
    _require(all(math.isfinite(x) for x in losses), f"sims7b: losses {losses}")
    _require(math.isfinite(norms[0]) and norms[0] > 0,
             f"sims7b: step 1's gradient norm {norms[0]}")
    _require(not unmoved, f"sims7b: {steps} steps left {unmoved} unchanged on every rank")
    _require(card_bytes is None or all(b < card_bytes for b in peaks + init_peaks),
             f"sims7b: a rank's peak memory {peaks} {init_peaks} reached its card's "
             f"{card_bytes}")
    dist.barrier()
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--legs", default=",".join(DEFAULT_LEGS),
                    help=f"comma-separated subset of {','.join(LEGS)} (default "
                         f"{','.join(DEFAULT_LEGS)})")
    ap.add_argument("--multihost", action="store_true",
                    help="train with training_args.multihost=true (ranks on several nodes)")
    ap.add_argument("--timeout", type=float, default=None,
                    help="seconds a collective may wait (default: the backend's)")
    args = ap.parse_args(argv)
    legs = tuple(args.legs.split(","))
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

    dev = init_distributed("cuda", timeout=args.timeout)
    work = ROOT / "build" / "parallel_smoke"
    if dist.get_rank() == 0:
        shutil.rmtree(work, ignore_errors=True)
        work.mkdir(parents=True)
    dist.barrier()
    try:
        result = run(dev, work, legs=legs, multihost=args.multihost)
    except BaseException:
        # a check that fails on one rank (rank 0 holds most of them) ends
        # this process at once, so torchrun (and tools/multinode.py, the
        # other node's) stops the others instead of leaving them waiting in
        # a collective until NCCL's timeout
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    if dist.get_rank() == 0:
        print(json.dumps(result), flush=True)
    dist.barrier()
    if dist.get_rank() == 0:
        shutil.rmtree(work, ignore_errors=True)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
