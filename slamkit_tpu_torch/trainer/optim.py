"""Optimizer and learning-rate schedules of the HF TrainingArguments surface.

Counterpart of `slamkit_tpu/trainer/optim.py` (`resolve_warmup_steps` :14,
`make_schedule` :21, `scale_by_adam_compact` :45, `make_optimizer` :88). The
update follows optax's chain, not `torch.optim.AdamW`, so the two packages
take the same steps from the same gradients:

    clip_by_global_norm(max_grad_norm)   g <- g * max / |g| when |g| >= max
    scale_by_adam(b1, b2, eps)           moments in float32 or bfloat16
    add_decayed_weights(weight_decay)    u <- u + wd * p (decoupled)
    scale_by_learning_rate(schedule)     u <- -schedule(count) * u, count from 0
    apply_updates                        p <- p + u

Moment arithmetic runs in float32 whatever the stored dtype. bfloat16 moments
(`optim_state_dtype=bfloat16`) are rounded only when stored and follow
`scale_by_adam_compact`'s order of operations; float32 moments follow
`optax.scale_by_adam`'s. The parameters are updated in place.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional

import numpy as np
import torch


def resolve_warmup_steps(warmup_steps: int, warmup_ratio: float, total_steps: int) -> int:
    """The larger of the explicit step count and the ratio of the run."""
    return max(int(warmup_steps or 0), math.ceil((warmup_ratio or 0.0) * total_steps))


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule."""
    return lambda step: (init - end) * (1 - min(max(step, 0), steps) / steps) + end


def _join(first: Callable, second: Callable, boundary: int) -> Callable[[int], float]:
    """optax.join_schedules with one boundary."""
    return lambda step: first(step) if step < boundary else second(step - boundary)


def make_schedule(lr_scheduler_type: str, learning_rate: float, total_steps: int,
                  warmup_steps: int = 0, min_lr: Optional[float] = None
                  ) -> Callable[[int], float]:
    """HF-style schedule as a function of the optimizer step (0 for the first
    update): linear warmup from 0, then constant, linear or cosine decay."""
    warmup_steps = min(warmup_steps, total_steps)
    decay_steps = max(total_steps - warmup_steps, 1)
    warm = _linear(0.0, learning_rate, max(warmup_steps, 1))
    if lr_scheduler_type == "constant":
        return lambda step: learning_rate
    if lr_scheduler_type == "constant_with_warmup":
        return _join(warm, lambda step: learning_rate, warmup_steps)
    if lr_scheduler_type == "linear":
        return _join(warm, _linear(learning_rate, 0.0, decay_steps), warmup_steps)
    if lr_scheduler_type in ("cosine", "cosine_with_min_lr"):
        end = float(min_lr or 0.0) if lr_scheduler_type == "cosine_with_min_lr" else 0.0
        alpha = end / learning_rate if learning_rate else 0.0

        def cosine(step):   # optax.cosine_decay_schedule
            frac = min(step, decay_steps) / decay_steps
            return learning_rate * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * frac)) + alpha)

        return _join(warm, cosine, warmup_steps)
    raise ValueError(f"Unknown lr_scheduler_type: {lr_scheduler_type}")


class AdamW:
    """clip -> Adam -> decoupled weight decay -> -lr, on `params`' `.grad`s."""

    def __init__(self, params: List[torch.nn.Parameter], schedule: Callable[[int], float],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, max_grad_norm: float = 1.0,
                 state_dtype: torch.dtype = torch.float32):
        if state_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"Unsupported optim_state_dtype: {state_dtype}")
        self.params = list(params)
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.state_dtype = state_dtype
        self.step_count = 0
        self.exp_avg = [torch.zeros_like(p, dtype=state_dtype) for p in self.params]
        self.exp_avg_sq = [torch.zeros_like(p, dtype=state_dtype) for p in self.params]

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """One update from the current `.grad`s; returns the global gradient
        norm before clipping (a 0-d float32 tensor on the parameters' device)."""
        grads = [p.grad.float() for p in self.params]
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = g_norm < self.max_grad_norm          # no host sync: a device flag
        count = self.step_count + 1
        b1, b2 = self.b1, self.b2
        # the bias corrections in float32, as optax takes them; host scalars,
        # so the update waits on no device-to-host or host-to-device copy
        f32 = np.float32
        bc1 = float(f32(1) - np.power(f32(b1), f32(count)))
        bc2 = float(f32(1) - np.power(f32(b2), f32(count)))
        lr = -self.schedule(self.step_count)
        compact = self.state_dtype == torch.bfloat16
        for p, g, m_s, v_s in zip(self.params, grads, self.exp_avg, self.exp_avg_sq):
            g = torch.where(keep, g, g / g_norm * self.max_grad_norm)
            if compact:   # scale_by_adam_compact: f32 arithmetic, bf16 storage
                m = b1 * m_s.float() + (1.0 - b1) * g
                v = b2 * v_s.float() + (1.0 - b2) * g * g
                u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            else:         # optax.scale_by_adam
                m = (1.0 - b1) * g + b1 * m_s
                v = (1.0 - b2) * (g * g) + b2 * v_s
                u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            m_s.copy_(m)
            v_s.copy_(v)
            if self.weight_decay:
                u = u + self.weight_decay * p
            p.add_(u * lr)
        self.step_count = count
        return g_norm

    def state_dict(self) -> dict:
        return {"step": self.step_count, "exp_avg": self.exp_avg,
                "exp_avg_sq": self.exp_avg_sq}

    @torch.no_grad()
    def load_state_dict(self, state: dict):
        self.step_count = int(state["step"])
        for mine, theirs in ((self.exp_avg, state["exp_avg"]),
                             (self.exp_avg_sq, state["exp_avg_sq"])):
            if len(mine) != len(theirs):
                raise ValueError(f"optimizer state holds {len(theirs)} tensors, "
                                 f"the model {len(mine)}")
            for a, b in zip(mine, theirs):
                a.copy_(b)


def make_optimizer(args, params: List[torch.nn.Parameter], total_steps: int):
    """(AdamW, schedule) from the training_args mapping: learning_rate,
    lr_scheduler_type, lr_scheduler_kwargs.min_lr, warmup_steps /
    warmup_ratio, max_grad_norm, weight_decay, adam_beta1/2, adam_epsilon,
    optim (adamw_*) and optim_state_dtype (float32 | bfloat16)."""
    warmup = resolve_warmup_steps(args.get("warmup_steps", 0),
                                  args.get("warmup_ratio", 0.0), total_steps)
    kwargs = args.get("lr_scheduler_kwargs", None)
    min_lr = kwargs.get("min_lr", None) if kwargs is not None else None
    schedule = make_schedule(args.get("lr_scheduler_type", "linear"),
                             float(args["learning_rate"]), total_steps,
                             warmup_steps=warmup, min_lr=min_lr)
    optim = str(args.get("optim", "adamw_torch") or "adamw_torch").lower()
    if optim == "adafactor":
        raise NotImplementedError("optim=adafactor is not ported yet (ROADMAP queue 1 "
                                  "item 5); use adamw with optim_state_dtype=bfloat16")
    if not optim.startswith("adamw"):
        raise ValueError(f"Unsupported optim: {optim!r} (adamw_*)")
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    state_dtype = str(args.get("optim_state_dtype", "float32") or "float32")
    if state_dtype not in dtypes:
        raise ValueError(f"Unsupported optim_state_dtype: {state_dtype!r}")
    tx = AdamW(params, schedule,
               b1=float(args.get("adam_beta1", 0.9)), b2=float(args.get("adam_beta2", 0.999)),
               eps=float(args.get("adam_epsilon", 1e-8)),
               weight_decay=float(args.get("weight_decay", 0.0)),
               max_grad_norm=float(args.get("max_grad_norm", 1.0)),
               state_dtype=dtypes[state_dtype])
    return tx, schedule
