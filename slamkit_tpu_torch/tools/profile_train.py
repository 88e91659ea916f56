"""Where a Slam training step spends the card's time.

    python -m slamkit_tpu_torch.tools.profile_train [--out DIR]

Trains the Slam recipe of `tools/slam_recipe.py` (full width and depth,
random init, bf16 compute, full remat, B=8 x accumulation 16 at context
1024, bf16 AdamW moments) through `SLAMTrainer.train()` for 3 steps on a
seeded Markov corpus, and traces step 3 with `torch.profiler` from a
trainer callback, so the trace covers the loop that `chip_smoke.py` times.
Prints the device time by kernel (top 25); the wall time of every step
(step 3 with the profiler on); the device's busy time in step 3 and its
share of that step's wall time and of step 2's, which runs without the
profiler (the step after a trace runs slower again); and, from the
trainer's named ranges, the host time of the microbatches' forwards, their
backwards (remat recompute included) and the optimizer update, with the
device time of the kernels the forwards and the update launched (the
backward's kernels are launched from autograd's device thread, outside the
range, and make up the rest of the busy time). The gzipped Chrome trace goes
to `--out` (default `build/profile_train`, git-ignored). Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys
import tempfile
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
STEPS = 3   # step 1 warms up, step 2 runs untraced, step 3 is traced
RANGES = ("train/forward", "train/backward", "train/optimizer")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=str(ROOT / "build" / "profile_train"))
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_train: needs a CUDA card", file=sys.stderr)
        return 1
    from ..data import parse_single_dataset
    from ..models import UnitLM
    from ..tokeniser import UnitTokeniser
    from ..trainer import SLAMTrainer, TrainerCallback
    from .slam_recipe import nvidia_smi, slam_config, slam_training_args, write_markov_corpus

    class TraceStep(TrainerCallback):
        """Times every step; profiles the last one."""

        def __init__(self):
            self.walls, self.t0, self.prof = [], None, None

        def on_train_begin(self, args, state, control, **kw):
            self.t0 = time.perf_counter()

        def on_step_end(self, args, state, control, **kw):
            torch.cuda.synchronize()
            self.walls.append((time.perf_counter() - self.t0) * 1e3)
            if state.global_step == STEPS - 1:
                self.prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
                self.prof.start()
            elif state.global_step == STEPS:
                self.prof.stop()
            self.t0 = time.perf_counter()   # the profiler's start and stop are no step's

    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    print(smi, flush=True)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as work:
        work = pathlib.Path(work)
        write_markov_corpus(work / "tokens.jsonl", 1400)
        ds = parse_single_dataset({"data": {}, "model": {"context_len": 1024}},
                                  UnitTokeniser(), str(work / "tokens.jsonl"))["train"]
        model = UnitLM(dataclasses.replace(slam_config(), remat=True), seed=0, device=dev)
        tracer = TraceStep()
        args = slam_training_args(str(work / "run"), save_steps=0, max_steps=STEPS)
        SLAMTrainer(model, args, ds, callbacks=[tracer], packing=True, context_len=1024,
                    packing_strategy="bestfit").train()
    prof, accum = tracer.prof, args["gradient_accumulation_steps"]
    pathlib.Path(opts.out).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(pathlib.Path(opts.out) / "trace.json.gz"))

    averages = prof.key_averages()
    print(averages.table(sort_by="self_device_time_total", row_limit=25), flush=True)
    busy_ms = sum(e.self_device_time_total for e in averages
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)) / 1e3
    untraced, traced = tracer.walls[-2:]
    print(f"step wall ms {[round(w, 3) for w in tracer.walls]} (step {STEPS} traced); "
          f"step {STEPS}: device busy {busy_ms:.3f} ms, {busy_ms / traced:.1%} of its "
          f"{traced:.3f} ms and {busy_ms / untraced:.1%} of untraced step {STEPS - 1}'s "
          f"{untraced:.3f} ms on {smi}", flush=True)
    spans = {e.key: e for e in averages
             if e.key in RANGES and e.device_type == torch.autograd.DeviceType.CPU}
    for name in RANGES:
        e = spans[name]
        print(f"{name}: {e.count} calls, host {e.cpu_time_total / 1e3 / e.count:.3f} ms a call"
              + ("" if name == "train/backward" else f", device time of its kernels "
                 f"{e.device_time_total / 1e3 / e.count:.3f} ms a call"), flush=True)
    rest = busy_ms - sum(spans[n].device_time_total for n in ("train/forward",
                                                             "train/optimizer")) / 1e3
    print(f"backward kernels (busy time less the forwards' and the update's): {rest:.3f} ms, "
          f"{rest / accum:.3f} ms a microbatch", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
