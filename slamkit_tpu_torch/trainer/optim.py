"""Optimizers and learning-rate schedules of the HF TrainingArguments surface.

Counterpart of `slamkit_tpu/trainer/optim.py` (`resolve_warmup_steps` :14,
`make_schedule` :21, `scale_by_adam_compact` :45, `make_optimizer` :88). The
updates follow optax's chains, not `torch.optim`, so the two packages take
the same steps from the same gradients. `optim=adamw_*`:

    clip_by_global_norm(max_grad_norm)   g <- g * max / |g| when |g| >= max
    scale_by_adam(b1, b2, eps)           moments in float32 or bfloat16
    add_decayed_weights(weight_decay)    u <- u + wd * p (decoupled)
    scale_by_learning_rate(schedule)     u <- -schedule(count) * u, count from 0
    apply_updates                        p <- p + u

Moment arithmetic runs in float32 whatever the stored dtype. bfloat16 moments
(`optim_state_dtype=bfloat16`) are rounded only when stored and follow
`scale_by_adam_compact`'s order of operations; float32 moments follow
`optax.scale_by_adam`'s. `optim=adafactor` swaps the Adam stage for
`scale_by_factored_rms()` and `scale_by_param_block_rms()` at optax's
defaults (`Adafactor`). The parameters are updated in place. `state_dict()`
records the optimizer's kind, and loading another kind's state raises.

Parameters sharded over 'data' (`parallel/fsdp.py`) are updated on their
local shards, plain tensors in the same arithmetic: a moment is sharded as
its parameter is, the global norm sums the shards' squares with one
all-reduce over the 'data' group, and Adafactor's factored statistics and
the parameter's RMS take their sums over whole rows, columns and tensors
across the shards, so both compute the unsharded run's numbers (JAX keeps
the factored statistics whole on every device, `parallel/mesh.py:188-202`;
so does the port). `state_dict()` holds the local shards; the keys in
`SHARDED_KEYS` are lists shaped like the parameters, which a checkpoint
gathers whole (`trainer/checkpoint.py`), and `load_state_dict` takes whole
tensors and keeps this rank's slice.

Parameters split over 'model' (`parallel/tensor.py`) are updated the same
way over the 'model' group: their `ParamShard` stands for the 'data' one.
Beside them sit replicated parameters (norms, o_b, down_b, a vocabulary
the axis does not divide), whose whole gradients every rank holds. With
fsdp beside 'model' a parameter may be split on both axes, on 'data' only
(replicated over 'model') or on neither; the global norm and the block RMS
sum each kind's squares over the groups of its own axes (`sum_over`), so
every square counts once over the world, and the factored statistics
reduce each dim over the group that splits it (`ParamShard.mean`).
"""
from __future__ import annotations

import math
import re
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.fsdp import ParamShard, local


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


def sum_over(values: list, shards: list) -> list:
    """Each of `values` (0-d tensors, parts of sums over whole parameters)
    summed over the groups of its `ParamShard`'s axes: the values of one
    kind of split stacked into one all-reduce a group, a whole parameter's
    left as it is. Every rank must call it with the same kinds of split."""
    kinds = {}
    for i, shard in enumerate(shards):
        kinds.setdefault(shard.axes, []).append(i)
    out = list(values)
    for axes in sorted(kinds):
        if not axes:
            continue
        idx = kinds[axes]
        flat = torch.stack([values[i] for i in idx])
        for level in shards[idx[0]].levels:
            dist.all_reduce(flat, group=level.group)
        for i, v in zip(idx, flat.unbind()):
            out[i] = v
    return out


def global_norm(grads: list, shards: list) -> torch.Tensor:
    """The global norm of the gradients (each this rank's part, with its
    `ParamShard`) as a 0-d float32 tensor: each one's squares summed over
    its groups (`sum_over`), a whole one counted once."""
    return torch.sqrt(sum(sum_over([torch.sum(g * g) for g in grads], shards)))


def _global_norm(grads: list, shards: list, max_grad_norm: float):
    """optax.clip_by_global_norm's (norm, keep): the global norm
    (`global_norm`) and the flag that leaves the gradients unclipped, a
    device flag rather than a host sync. Each gradient is clipped in the
    update's loop, one at a time (`_clipped`)."""
    g_norm = global_norm(grads, shards)
    return g_norm, g_norm < max_grad_norm


def _clipped(g, g_norm, keep, max_grad_norm: float):
    return torch.where(keep, g, g / g_norm * max_grad_norm)


def _load_list(mine: list, theirs: list, shards: list, key: str):
    """Copy a saved list of whole tensors (None where the state has none)
    into this optimizer's, this rank's slice of the parameter-shaped ones."""
    if len(mine) != len(theirs):
        raise ValueError(f"optimizer state holds {len(theirs)} tensors, "
                         f"the model {len(mine)}")
    for a, b, shard in zip(mine, theirs, shards):
        if (a is None) != (b is None):
            raise ValueError(f"optimizer state's {key} is factored otherwise "
                             f"than this model's parameters")
        if a is not None:
            a.copy_(shard.narrow(b) if tuple(b.shape) == shard.shape else b)


class _Sharded:
    """What both optimizers keep of their parameters: the parameters and
    each one's `ParamShard` (over 'data' under fsdp, 'model' under tensor
    parallelism, both with both)."""

    def _init_params(self, params):
        self.params = list(params)
        self.shards = [ParamShard.of(p) for p in self.params]

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    def _grads(self) -> list:
        return [local(p.grad).float() for p in self.params]


def _check_kind(state: dict, kind: str):
    """A checkpoint's optimizer state must be of this optimizer's kind
    (checkpoints written before the kind was recorded hold AdamW's)."""
    theirs = state.get("kind", "adamw")
    if theirs != kind:
        raise ValueError(f"the checkpoint's optimizer state is {theirs}'s; this run's "
                         f"optimizer is {kind} (training_args.optim)")


class AdamW(_Sharded):
    """clip -> Adam -> decoupled weight decay -> -lr, on `params`' `.grad`s."""

    kind = "adamw"
    SHARDED_KEYS = ("exp_avg", "exp_avg_sq")

    def __init__(self, params: List[torch.nn.Parameter], schedule: Callable[[int], float],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, max_grad_norm: float = 1.0,
                 state_dtype: torch.dtype = torch.float32):
        if state_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"Unsupported optim_state_dtype: {state_dtype}")
        self._init_params(params)
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.state_dtype = state_dtype
        self.step_count = 0
        self.exp_avg = [torch.zeros_like(local(p), dtype=state_dtype) for p in self.params]
        self.exp_avg_sq = [torch.zeros_like(local(p), dtype=state_dtype) for p in self.params]

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """One update from the current `.grad`s; returns the global gradient
        norm before clipping (a 0-d float32 tensor on the parameters' device)."""
        grads = self._grads()
        g_norm, keep = _global_norm(grads, self.shards, self.max_grad_norm)
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
            p = local(p)
            g = _clipped(g, g_norm, keep, self.max_grad_norm)
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
        return {"kind": self.kind, "step": self.step_count, "exp_avg": self.exp_avg,
                "exp_avg_sq": self.exp_avg_sq}

    @torch.no_grad()
    def load_state_dict(self, state: dict):
        _check_kind(state, self.kind)
        self.step_count = int(state["step"])
        for key in self.SHARDED_KEYS:
            _load_list(getattr(self, key), state[key], self.shards, key)


# optax's defaults of scale_by_factored_rms and scale_by_param_block_rms,
# which the JAX package's chain takes
DECAY_RATE, EPS, MIN_DIM_SIZE_TO_FACTOR, MIN_SCALE = 0.8, 1e-30, 128, 1e-3


def _factored_dims(shape):
    """optax's `_factored_dims`: the (second largest, largest) axes of a
    parameter of two or more axes whose second largest has at least
    MIN_DIM_SIZE_TO_FACTOR entries, else None (np.argsort's order on ties,
    as optax takes it)."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < MIN_DIM_SIZE_TO_FACTOR:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor(_Sharded):
    """The JAX package's adafactor chain, on `params`' `.grad`s:

        clip_by_global_norm(max_grad_norm)
        scale_by_factored_rms()              decay 1 - (count + 1)^-0.8, eps 1e-30;
                                             row / column means of g^2 + eps for a
                                             parameter whose two largest axes have
                                             >= 128 entries, else the full g^2 + eps
        scale_by_param_block_rms()           u <- u * max(rms(p), 1e-3)
        add_decayed_weights(weight_decay)    u <- u + wd * p (decoupled)
        scale_by_learning_rate(schedule)     u <- -schedule(count) * u

    count is the number of updates before this one (optax's state.count).
    The state is float32: per factored parameter a row and a column
    statistic, per other parameter a full second moment. names: the
    parameters' names (`named_parameters()`); the layers' parameters of one
    name then take the RMS of all of them together, as the JAX package's
    leaf stacks them on a layer axis (`models/convert.py`). Without names
    each parameter is a block of its own."""

    kind = "adafactor"
    SHARDED_KEYS = ("v",)

    def __init__(self, params: List[torch.nn.Parameter], schedule: Callable[[int], float],
                 weight_decay: float = 0.0, max_grad_norm: float = 1.0,
                 names: Optional[List[str]] = None):
        self._init_params(params)
        self.blocks = (list(range(len(self.params))) if names is None else
                       [re.sub(r"^layers\.\d+\.", "layers/", n) for n in names])
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.step_count = 0
        # the whole parameters' shapes decide the factoring and size the
        # (whole) statistics
        self.dims = [_factored_dims(s.shape) for s in self.shards]
        zeros = lambda p, s, drop: torch.zeros([n for i, n in enumerate(s.shape) if i != drop],
                                               dtype=torch.float32, device=local(p).device)
        # v_row drops the largest axis (d0), v_col the second largest (d1)
        self.v_row = [zeros(p, s, d[1]) if d else None
                      for p, s, d in zip(self.params, self.shards, self.dims)]
        self.v_col = [zeros(p, s, d[0]) if d else None
                      for p, s, d in zip(self.params, self.shards, self.dims)]
        self.v = [None if d else torch.zeros_like(local(p), dtype=torch.float32)
                  for p, d in zip(self.params, self.dims)]

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """One update from the current `.grad`s; returns the global gradient
        norm before clipping (a 0-d float32 tensor on the parameters' device)."""
        grads = self._grads()
        g_norm, keep = _global_norm(grads, self.shards, self.max_grad_norm)
        # optax's decay schedule in float32 (host scalars, no device copy)
        f32 = np.float32
        decay = f32(1) - np.power(f32(self.step_count + 1), f32(-DECAY_RATE))
        new = float(f32(1) - decay)
        decay = float(decay)
        lr = -self.schedule(self.step_count)
        scales = self._block_scales()
        for i, (p, g, shard) in enumerate(zip(self.params, grads, self.shards)):
            p = local(p)
            g = _clipped(g, g_norm, keep, self.max_grad_norm)
            g_sqr = g * g + EPS
            if self.dims[i] is not None:
                d1, d0 = self.dims[i]
                # whole statistics (sums across the shards where sharded)
                v_row = decay * self.v_row[i] + new * shard.mean(g_sqr, d0)
                v_col = decay * self.v_col[i] + new * shard.mean(g_sqr, d1)
                self.v_row[i].copy_(v_row)
                self.v_col[i].copy_(v_col)
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_factor = (v_row / v_row.mean(dim=reduced_d1, keepdim=True)) ** -0.5
                u = (g * shard.slice_of(row_factor, d0).unsqueeze(d0)
                     * shard.slice_of(v_col ** -0.5, d1).unsqueeze(d1))
            else:
                v = decay * self.v[i] + new * g_sqr
                self.v[i].copy_(v)
                u = g * v ** -0.5
            u = u * scales[self.blocks[i]]
            if self.weight_decay:
                u = u + self.weight_decay * p
            p.add_(u * lr)
        self.step_count += 1
        return g_norm

    def _block_scales(self) -> dict:
        """optax.safe_root_mean_squares of each block's parameters, floored
        at MIN_SCALE: block -> 0-d tensor (each block's sum of squares over
        the groups its parameters are split over, `sum_over`; a block's
        parameters, one name in every layer, are split alike)."""
        sums, kinds, sizes = {}, {}, {}
        for p, shard, block in zip(self.params, self.shards, self.blocks):
            p = local(p)
            sums[block] = sums.get(block, 0.0) + torch.sum(p * p)
            kinds.setdefault(block, shard)
            sizes[block] = sizes.get(block, 0) + math.prod(shard.shape)
        blocks = list(sums)
        total = dict(zip(blocks, sum_over([sums[b] for b in blocks],
                                          [kinds[b] for b in blocks])))
        rms = {b: torch.sqrt(total[b] / sizes[b]) for b in blocks}
        return {b: torch.where(r <= MIN_SCALE, MIN_SCALE, r) for b, r in rms.items()}

    def state_dict(self) -> dict:
        return {"kind": self.kind, "step": self.step_count, "v_row": self.v_row,
                "v_col": self.v_col, "v": self.v}

    @torch.no_grad()
    def load_state_dict(self, state: dict):
        _check_kind(state, self.kind)
        self.step_count = int(state["step"])
        for key in ("v_row", "v_col", "v"):
            _load_list(getattr(self, key), state[key], self.shards, key)


def make_optimizer(args, params: List[torch.nn.Parameter], total_steps: int,
                   names: Optional[List[str]] = None):
    """(optimizer, schedule) from the training_args mapping: learning_rate,
    lr_scheduler_type, lr_scheduler_kwargs.min_lr, warmup_steps /
    warmup_ratio, max_grad_norm, weight_decay, optim (adamw_* -> AdamW with
    adam_beta1/2, adam_epsilon and optim_state_dtype float32 | bfloat16;
    adafactor -> Adafactor, which takes the parameters' `names`)."""
    warmup = resolve_warmup_steps(args.get("warmup_steps", 0),
                                  args.get("warmup_ratio", 0.0), total_steps)
    kwargs = args.get("lr_scheduler_kwargs", None)
    min_lr = kwargs.get("min_lr", None) if kwargs is not None else None
    schedule = make_schedule(args.get("lr_scheduler_type", "linear"),
                             float(args["learning_rate"]), total_steps,
                             warmup_steps=warmup, min_lr=min_lr)
    optim = str(args.get("optim", "adamw_torch") or "adamw_torch").lower()
    weight_decay = float(args.get("weight_decay", 0.0))
    max_grad_norm = float(args.get("max_grad_norm", 1.0))
    if optim == "adafactor":
        return Adafactor(params, schedule, weight_decay=weight_decay,
                         max_grad_norm=max_grad_norm, names=names), schedule
    if not optim.startswith("adamw"):
        raise ValueError(f"Unsupported optim: {optim!r} (adamw_*, adafactor)")
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    state_dtype = str(args.get("optim_state_dtype", "float32") or "float32")
    if state_dtype not in dtypes:
        raise ValueError(f"Unsupported optim_state_dtype: {state_dtype!r}")
    tx = AdamW(params, schedule,
               b1=float(args.get("adam_beta1", 0.9)), b2=float(args.get("adam_beta2", 0.999)),
               eps=float(args.get("adam_epsilon", 1e-8)),
               weight_decay=weight_decay, max_grad_norm=max_grad_norm,
               state_dtype=dtypes[state_dtype])
    return tx, schedule
