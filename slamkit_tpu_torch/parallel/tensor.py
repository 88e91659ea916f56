"""Tensor parallelism over the mesh's 'model' axis (Megatron).

Counterpart of `slamkit_tpu/parallel/mesh.py`'s `tp_specs_for_decoder`
(`:102-127`) and `tp_shardings` (`:130-162`). The JAX package places each
decoder parameter by a PartitionSpec and lets GSPMD insert the collectives;
here each rank of a 'model' line keeps its slice of every sharded parameter
and the decoder (`models/transformer.py`) calls the collectives itself:

  * the plan (`tp_plan`): column-parallel q / k / v / up / gate weights and
    their biases split on the output dim, row-parallel o / down weights on
    the input dim (o_b and down_b replicated), `embed` on the vocab dim
    (dim 0), `lm_head` on the vocab dim (dim 1), everything else (norms,
    learned positions, OPT's projections) replicated; a dim that the 'model'
    size does not divide is replicated, as JAX drops such an axis
    (`:150-153`): Slam's vocabulary at model = 4, say;
  * heads: the port splits whole heads only, so `num_heads` and
    `num_kv_heads` must both divide the 'model' size (`check_heads`). JAX's
    rule would split a kv head's features and let GSPMD reshard around the
    attention (`HEADS_ITEM` records the difference);
  * the collectives, as autograd functions over the 'model' group:
    `copy_in` (identity forward, all-reduce backward) before a
    column-parallel projection and before a vocab-sharded head,
    `reduce_out` (all-reduce forward, identity backward) after a
    row-parallel projection and after the vocab-parallel embedding lookup,
    and `gather_vocab` (an all-gather, no gradient) for the last position's
    logits in generation;
  * `vocab_nll`: the per-token NLL of vocab-sharded float32 logits (the row
    max all-reduced with MAX, the sum of exponentials and each target's
    logit, which its owner gives, all-reduced), so [B, T, V] logits are
    never gathered;
  * `shard_decoder_tp(decoder, mesh)` broadcasts rank 0's weights over the
    world, then replaces each sharded parameter by the rank's slice, tagged
    with its `ParamShard` over the 'model' group (`param_shard`), which the
    optimizers, the checkpoints and `whole_of` (a parameter's tensor
    gathered whole; `models.to_flat`) read, so the global gradient norm,
    Adafactor's factored statistics and its block RMS are the unsharded
    run's;
  * with fsdp over 'data' (JAX `tp_shardings(fsdp=True)`), `fsdp.shard_decoder`
    then shards the slices over each 'model' coordinate's 'data' line, on
    the largest of the dims 'model' left alone that the 'data' size divides
    (`tp_fsdp_plan`, by which `fsdp.shard_decoder` places every parameter,
    names both dims); the slice's tag rides on the sharded parameter, whose
    `ParamShard.of` holds both splits.

Replicated parameters see the same forward on every 'model' rank, and
`copy_in`'s all-reduce gives each the whole gradient, so they stay equal
across the line without a collective of their own.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from .fsdp import ParamShard, _dtensor, data_dim, local

#: where the port's whole-heads rule is recorded against JAX's
HEADS_ITEM = "ROADMAP queue 3"

#: a layer's column-parallel parameters (split on their last dim) and its
#: row-parallel weights (split on dim 0), JAX `tp_specs_for_decoder`
COLUMN = ("q_w", "k_w", "v_w", "up_w", "gate_w", "q_b", "k_b", "v_b", "up_b", "gate_b")
ROW = ("o_w", "down_w")
#: the vocab dim of the top-level parameters that carry one
VOCAB = {"embed": 0, "lm_head": 1}


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """What a tensor-parallel decoder and its layers know of the 'model'
    line: its `group`, `size` and this rank's `rank` in it, whether the MLP
    is split (`mlp`: the intermediate size divides the line) and the rows
    [lo, hi) of the vocabulary this rank holds (`vocab`, None where it is
    replicated)."""
    group: object
    size: int
    rank: int
    mlp: bool
    vocab: Optional[tuple]


def _spec_dim(name: str, ndim: int) -> Optional[int]:
    """The dim JAX's spec puts 'model' on for the parameter `name` (a
    `named_parameters()` name), or None."""
    leaf = name.rsplit(".", 1)[-1]
    if name.startswith("layers."):
        return ndim - 1 if leaf in COLUMN else 0 if leaf in ROW else None
    return VOCAB.get(name)


def tp_plan(shapes: dict, size: int) -> dict:
    """name -> the dim its parameter is split on over a 'model' line of
    `size` ranks, or None (replicated): JAX's spec with every axis that does
    not divide its dim dropped. shapes: name -> whole shape."""
    plan = {}
    for name, shape in shapes.items():
        dim = _spec_dim(name, len(shape))
        plan[name] = dim if dim is not None and shape[dim] % size == 0 else None
    return plan


def tp_fsdp_plan(shapes: dict, model: Optional[int], data: int) -> dict:
    """name -> (the dim 'model' splits or None, the dim 'data' shards or
    None) over a ('data', 'model') mesh of those sizes with fsdp: JAX
    `tp_shardings(fsdp=True)` on the port's per-layer parameters (JAX's
    stacked layer axis, which it may shard over 'data', dropped); `model`
    None, no tensor parallelism: JAX `param_shardings(fsdp=True)`. None on
    'data' is JAX's replication, where FSDP2 pads dim 0. `fsdp.shard_decoder`
    places every parameter by it. shapes: name -> whole shape."""
    split = tp_plan(shapes, model) if model else dict.fromkeys(shapes)
    return {name: (dim, data_dim(shapes[name], data, skip=dim))
            for name, dim in split.items()}


def check_heads(cfg, size: int):
    """Whole heads per rank: `num_heads` and `num_kv_heads` both divide the
    'model' size, else ValueError."""
    if cfg.num_heads % size or cfg.num_kv_heads % size:
        raise ValueError(
            f"{cfg.num_heads} q heads and {cfg.num_kv_heads} kv heads over 'model' = {size}: "
            f"the port splits whole heads only, so both must divide the axis; JAX's rule "
            f"would split a head's features ({HEADS_ITEM})")


def is_tp(decoder) -> bool:
    """Whether `decoder`'s weights are split over 'model' (`shard_decoder_tp`)."""
    return getattr(decoder, "tp", None) is not None


def tp_shard(p: torch.Tensor) -> Optional[ParamShard]:
    """The `ParamShard` of a parameter that `shard_decoder_tp` split, else None."""
    return getattr(p, "param_shard", None)


# --------------------------------------------------------------------------- #
# collectives
# --------------------------------------------------------------------------- #
class _CopyIn(torch.autograd.Function):
    """Identity forward; the backward sums the ranks' partial gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceOut(torch.autograd.Function):
    """The ranks' partial outputs summed forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_in(x: torch.Tensor, tp: Optional[TensorParallel]) -> torch.Tensor:
    """x, whose gradient is summed over the 'model' line (before a
    column-parallel projection); x itself without `tp`."""
    return x if tp is None else _CopyIn.apply(x, tp.group)


def reduce_out(x: torch.Tensor, tp: Optional[TensorParallel]) -> torch.Tensor:
    """The sum of every rank's x over the 'model' line (after a row-parallel
    projection); x itself without `tp`."""
    return x if tp is None else _ReduceOut.apply(x, tp.group)


def gather_vocab(x: torch.Tensor, tp: Optional[TensorParallel]) -> torch.Tensor:
    """[..., V / size] vocab-local values joined to [..., V] on every rank
    (one all-gather, no gradient); x itself where the vocab is whole."""
    if tp is None or tp.vocab is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(tp.size)]
    dist.all_gather(parts, x, group=tp.group)
    return torch.cat(parts, dim=-1)


def vocab_nll(logits: torch.Tensor, targets: torch.Tensor,
              tp: TensorParallel) -> torch.Tensor:
    """`utils.calculation_utils.token_nll` of vocab-sharded logits
    [..., V / size] (float32) without gathering them: log Z from the
    all-reduced row max and sum of exponentials, each target's logit from
    the rank that owns it. Targets < 0 give log Z alone and must be masked
    by the caller, as there."""
    lo, hi = tp.vocab
    with torch.no_grad():
        m = logits.max(dim=-1).values
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=tp.group)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    sumexp = reduce_out(torch.exp(logits - m[..., None]).sum(dim=-1), tp)
    logz = torch.log(sumexp) + m
    t = targets.long()
    mine = (t >= lo) & (t < hi)
    gold = torch.gather(logits, -1, torch.where(mine, t - lo, 0)[..., None])[..., 0]
    gold = reduce_out(torch.where(mine, gold, torch.zeros_like(gold)), tp)
    return logz - gold


def embed_lookup(ids: torch.Tensor, embed: torch.Tensor,
                 tp: Optional[TensorParallel]) -> torch.Tensor:
    """`F.embedding(ids, embed)` of a vocab-sharded table: ids outside the
    rank's rows give zero rows, then the ranks' rows are summed."""
    if tp is None or tp.vocab is None:
        return torch.nn.functional.embedding(ids, embed)
    lo, hi = tp.vocab
    mine = (ids >= lo) & (ids < hi)
    rows = torch.nn.functional.embedding(torch.where(mine, ids - lo, 0), embed)
    return reduce_out(torch.where(mine[..., None], rows, torch.zeros_like(rows)), tp)


# --------------------------------------------------------------------------- #
# placement
# --------------------------------------------------------------------------- #
def shard_decoder_tp(decoder: nn.Module, mesh) -> nn.Module:
    """Split `decoder`'s parameters over `mesh`'s 'model' axis in place (see
    the module docstring) and return it: rank 0's weights are broadcast over
    the world first, then each sharded parameter becomes a new parameter
    holding the rank's slice. With a 'model' axis of 1 it stays as it is."""
    n = mesh.shape.get("model", 1)
    if n == 1 or is_tp(decoder):
        return decoder
    check_heads(decoder.cfg, n)
    group, rank = mesh.group("model"), mesh.coordinate["model"]
    with torch.no_grad():
        for p in decoder.parameters():
            dist.broadcast(p, src=0)
    named = dict(decoder.named_parameters())
    plan = tp_plan({name: tuple(p.shape) for name, p in named.items()}, n)
    for name in plan:
        p, dim = named.pop(name), plan[name]   # the whole tensor is freed with its slot
        if dim is None:
            continue
        owner, leaf = (decoder.get_submodule(name.rsplit(".", 1)[0]), name.rsplit(".", 1)[1]) \
            if "." in name else (decoder, name)
        shape = tuple(p.shape)
        per = shape[dim] // n
        part = nn.Parameter(p.detach().narrow(dim, rank * per, per).clone(),
                            requires_grad=p.requires_grad)
        part.param_shard = ParamShard(shape, dim, rank * per, (rank + 1) * per, n, rank, group,
                                      axis="model")
        owner._parameters[leaf] = part
    vocab_rows = decoder.cfg.vocab_size // n
    tp = TensorParallel(group=group, size=n, rank=rank,
                        mlp=plan.get("layers.0.up_w") is not None,
                        vocab=((rank * vocab_rows, (rank + 1) * vocab_rows)
                               if plan["embed"] is not None else None))
    decoder.tp = tp
    for layer in decoder.layers:
        layer.tp = tp
    return decoder


def whole_of(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """t (the parameter p's value, gradient or snapshot) whole: a part
    sharded as p is (over 'data', a DTensor) gathered over both axes, a
    'model' slice over the 'model' line; a whole tensor as it is."""
    if isinstance(t, _dtensor()):
        return ParamShard.of(p).gather(local(t))
    shard = tp_shard(p)
    if shard is None or tuple(t.shape) == shard.shape:
        return t
    return shard.gather(t)
