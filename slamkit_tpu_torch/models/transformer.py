"""Causal-transformer decoder as a `torch.nn.Module`, for serving and training.

Counterpart of `slamkit_tpu/models/transformer.py`: one configurable decoder
covers the families of the preset table (opt, qwen2, llama, gpt_neox) — RMS or
LayerNorm with bias, silu/gelu GLU or relu/gelu MLPs, RoPE with `rotary_pct`,
learned positions with OPT's offset, parallel residual, post-LN, and
`embed_proj_dim`, a tied or separate head with float32 logits.

Parameters keep the JAX package's names and [in, out] matrix layout, one
`DecoderLayer` per layer where JAX stacks them on a leading axis, so
`models/convert.py` maps `params.npz` onto the module by stacking. They are
stored float32 and cast to the compute dtype where they are used.

Full-sequence attention (training, scoring, generation prefill) follows
`cfg.attn_impl` as the JAX package's `_use_flash` reads it: "flash" runs
`ops.flash_attention` (the CUDA kernels on the card, their plain versions on
the CPU; under autograd its gradient is the flash backward), "xla" the plain
attention (`ops.mha_reference` under autograd, on any device), "auto" the
kernels on the card and the plain attention on the CPU. On a CPU tensor
without probability dropout `flash_attention` is that same plain forward
(with its explicit backward), so the CPU takes it there. The single-token
decode step attends over the KV cache with plain einsums, as the JAX package
does. The KV cache is updated in place.

Training: the parameters take gradients (serving runs under
`torch.inference_mode`). A forward given a `dropout_seed` applies the
config's dropout (embeddings after the positions, the attention and MLP
residual branches in all three block layouts), attention dropout (the
probabilities of the plain attention; the flash path raises, as in JAX) and
layerdrop (whole layers skipped, no rescale); without a seed it is
deterministic. Each mask is a function of (seed, site, layer) alone, drawn
inside the layer from a generator seeded with them (`_keep_mask`), so a
checkpointed layer's recompute draws the same mask and no draw touches the
global RNG; layerdrop's decisions are drawn on the host (`_layer_drops`).
`cfg.remat` checkpoints the first `remat_layers` layers (all when -1) with
`torch.utils.checkpoint`, the JAX package's `jax.checkpoint` of the layer
scan. Under `remat_policy="full"` the backward recomputes each layer's
forward, flash kernel included; under "qkv" the parts before the attention
(norm, q/k/v projections, rope) and after it (o projection, residuals, norm,
MLP) are checkpointed apart and the attention between them is not, so
`FlashAttentionFunction`'s saved q, k, v, out and LSE feed the flash
backward without a second forward launch (JAX's `save_only_these_names`
policy; the plain attention is checkpointed on its own, as JAX recomputes
it).

Several ranks (`SLAMTrainer` on a mesh): a forward given a `shard`
(`parallel.Shard`) holds this rank's tile of the global batch. Its dropout
masks are drawn at the global batch's shape and tiled, so they are the
one-process run's; under a 'seq' axis of several ranks the flash route
runs `ops.ring_flash_attention` on the chunk and the plain route gathers k,
v and the key ids over the group (`ops.all_gather_seq`), the causal mask
offset by the chunk's first position. A remat recompute replays the ring's
rotations on every rank in the same order. The decoder runs each layer as a
module call (`DecoderLayer.forward`, remat inside it), so a layer whose
weights are sharded over 'data' (`parallel/fsdp.py`) is gathered around its
forward, its recompute and its backward.

Tensor parallelism (`parallel/tensor.py`, a decoder that `shard_decoder_tp`
split over a 'model' line): a layer runs on its local heads and MLP columns,
the head counts read from the projections' widths (at Slam and model = 2, 7
q heads and 1 kv head, the GQA group still 7). The q / k / v and MLP inputs
pass `copy_in` (their gradient summed over the line), the o and down
projections' partial outputs are summed (`reduce_out`) before their biases
and the residual dropout, both in the parallel-residual layout too. A
vocab-sharded embedding looks up the rank's rows and sums them; a
vocab-sharded head gives the rank's float32 logit columns. The dropout
sites act on replicated tensors, so every rank draws the same masks;
attention-probability dropout draws the global heads' mask and takes the
rank's heads. A remat recompute replays the collectives in the same order
on every rank.

int8 decode: a layer's seven projection weights may be int8 dicts instead of
parameters (`_proj`); `models/generate.py` builds such a copy for
`generate(weight_quant="int8")`, and its prefill and decode steps then run
every projection through the `dq_matmul` kernel.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import (all_gather_seq, dq_matmul, flash_attention, mha_reference,
                   ring_flash_attention)
from ..parallel.tensor import copy_in, embed_lookup, reduce_out
from .presets import DecoderConfig

NEG_INF = -1e30


_REMAT_POLICIES = ("full", "qkv")
_ATTN_IMPLS = ("auto", "flash", "xla")


def _check_supported(cfg: DecoderConfig):
    """Refuse settings that neither package implements."""
    for name in ("dropout", "attention_dropout", "layerdrop"):
        if not 0.0 <= getattr(cfg, name) < 1.0:
            raise ValueError(f"{name}={getattr(cfg, name)}: a rate in [0, 1)")
    if cfg.remat_policy not in _REMAT_POLICIES:
        raise ValueError(f"remat_policy={cfg.remat_policy!r}: one of {_REMAT_POLICIES}")
    if cfg.attn_impl not in _ATTN_IMPLS:
        raise ValueError(f"attn_impl={cfg.attn_impl!r}: one of {_ATTN_IMPLS}")


# --------------------------------------------------------------------------- #
# dropout masks
# --------------------------------------------------------------------------- #
# the sites a mask is drawn for; a layer's site is (site, layer)
EMBED, ATTN_PROBS, ATTN_RES, MLP_RES, LAYERDROP = range(5)
_M64 = (1 << 64) - 1


def _mix(*words: int) -> int:
    """splitmix64 folded over `words`: one generator seed in [0, 2^63)."""
    h = 0
    for w in words:
        h = (h ^ (int(w) & _M64)) + 0x9E3779B97F4A7C15 & _M64
        h = ((h ^ (h >> 30)) * 0xBF58476D1CE4E5B9) & _M64
        h = ((h ^ (h >> 27)) * 0x94D049BB133111EB) & _M64
        h ^= h >> 31
    return h >> 1


def _keep_mask(seed: int, site: tuple, shape, rate: float, device) -> torch.Tensor:
    """Boolean keep mask of one dropout site, True with probability 1 - rate:
    uniforms from a generator on `device` seeded with (seed, *site) at every
    call. `torch.utils.checkpoint` replays only the default generators, so
    this is what makes a recompute draw the forward's mask."""
    gen = torch.Generator(device=device).manual_seed(_mix(seed, *site))
    return torch.rand(shape, generator=gen, device=device) < 1.0 - rate


def _layer_drops(seed: int, num_layers: int, rate: float) -> list:
    """Which layers layerdrop skips in the forward of `seed`, drawn on the
    host (a decision on the card would cost a synchronisation a layer)."""
    gen = torch.Generator().manual_seed(_mix(seed, LAYERDROP))
    return (torch.rand(num_layers, generator=gen) < rate).tolist()


def _dropout(x, rate: float, seed: Optional[int], site: tuple, shard=None):
    """Inverted dropout as JAX's `_dropout`: where(keep, x / (1 - rate), 0)
    in x's dtype, 1 - rate rounded to that dtype first as JAX rounds a
    Python scalar (in bf16 both then divide by 0.8984375 at rate 0.1); the
    identity without a seed or at rate 0. x [B, T, ...]; under a `shard` the
    mask is drawn at the global batch's shape and x takes its tile, so
    every rank applies the one-process run's mask."""
    if seed is None or rate <= 0.0:
        return x
    if shard is None:
        keep = _keep_mask(seed, site, x.shape, rate, x.device)
    else:
        keep = shard.tile(_keep_mask(seed, site, (shard.batch, shard.time, *x.shape[2:]),
                                     rate, x.device))
    divisor = float(torch.tensor(1.0 - rate, dtype=x.dtype))
    return torch.where(keep, x / divisor, x.new_zeros(()))


class _SkippedLayer(torch.autograd.Function):
    """The residual stream past a layer that layerdrop skips, giving the
    layer's parameters zero gradients: JAX computes a dropped layer and
    selects the carry, so its gradients are zeros, not absent, and the
    optimizer's moments and weight decay go on as for any other layer."""

    @staticmethod
    def forward(ctx, x, *params):
        ctx.params = [(p.shape, p.dtype, p.device) for p in params]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=d, device=dev) if need else None
                     for (s, d, dev), need in zip(ctx.params, ctx.needs_input_grad[1:])))


def _param(*shape, device, fill: Optional[float] = None) -> nn.Parameter:
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if fill is not None and t.device.type != "meta":
        t.fill_(fill)
    return nn.Parameter(t)


def _opt_param(module: nn.Module, name: str, present: bool, *shape, device, fill=None):
    module.register_parameter(
        name, _param(*shape, device=device, fill=fill) if present else None)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: DecoderConfig, device=None):
        super().__init__()
        D, F_, dev = cfg.hidden_size, cfg.intermediate_size, device
        glu = cfg.act.endswith("_glu")
        ln_bias = cfg.norm == "layernorm" and cfg.norm_bias
        self.attn_norm_scale = _param(D, device=dev, fill=1.0)
        _opt_param(self, "attn_norm_bias", ln_bias, D, device=dev, fill=0.0)
        self.q_w = _param(D, cfg.q_dim, device=dev)
        self.k_w = _param(D, cfg.kv_dim, device=dev)
        self.v_w = _param(D, cfg.kv_dim, device=dev)
        _opt_param(self, "q_b", cfg.qkv_bias, cfg.q_dim, device=dev, fill=0.0)
        _opt_param(self, "k_b", cfg.qkv_bias, cfg.kv_dim, device=dev, fill=0.0)
        _opt_param(self, "v_b", cfg.qkv_bias, cfg.kv_dim, device=dev, fill=0.0)
        self.o_w = _param(cfg.q_dim, D, device=dev)
        _opt_param(self, "o_b", cfg.attn_out_bias, D, device=dev, fill=0.0)
        self.mlp_norm_scale = _param(D, device=dev, fill=1.0)
        _opt_param(self, "mlp_norm_bias", ln_bias, D, device=dev, fill=0.0)
        self.up_w = _param(D, F_, device=dev)
        _opt_param(self, "gate_w", glu, D, F_, device=dev)
        self.down_w = _param(F_, D, device=dev)
        _opt_param(self, "up_b", cfg.mlp_bias, F_, device=dev, fill=0.0)
        _opt_param(self, "gate_b", cfg.mlp_bias and glu, F_, device=dev, fill=0.0)
        _opt_param(self, "down_b", cfg.mlp_bias, D, device=dev, fill=0.0)
        self.tp = None   # parallel.tensor.TensorParallel once split over 'model'

    def forward(self, x, rope, segment_ids, cfg: DecoderConfig, *, cache_kv=None,
                cache_index: Optional[int] = None, seed: Optional[int] = None, layer: int = 0,
                shard=None, remat: bool = False, skip: bool = False, cast: bool = False):
        """The block as the decoder's loop runs it (a module call, so an
        fsdp-sharded layer is gathered around it), under the decoder's
        `cfg`: skipped by layerdrop (`skip`), checkpointed under the config's
        remat policy (`remat`), or `_layer` itself. cast: every weight cast
        to the compute dtype at its use, the values
        `models/generate.compute_copy` holds."""
        if skip:
            # HF layerdrop: the whole layer is skipped, no rescale
            return _SkippedLayer.apply(x, *self.parameters()) if torch.is_grad_enabled() else x
        lp = _Cast(self, cfg.compute_dtype) if cast else self
        if remat and cfg.remat_policy == "qkv":
            return _qkv_remat_layer(x, lp, rope, segment_ids, cfg, seed, layer, shard)
        if remat:
            return checkpoint(_layer, x, lp, rope, segment_ids, cfg, seed=seed, layer=layer,
                              shard=shard, use_reentrant=False)
        return _layer(x, lp, rope, segment_ids, cfg, cache_kv=cache_kv, cache_index=cache_index,
                      seed=seed, layer=layer, shard=shard)


class _Cast:
    """A layer's weights (absent ones None) cast to `dtype`."""

    def __init__(self, layer: nn.Module, dtype):
        for name, p in layer._parameters.items():
            setattr(self, name, None if p is None else p.to(dtype))
        self.tp = layer.tp


# --------------------------------------------------------------------------- #
# building blocks
# --------------------------------------------------------------------------- #
def _norm(x, scale, bias, cfg: DecoderConfig):
    x32 = x.float()
    if cfg.norm == "rmsnorm":
        var = (x32 * x32).mean(dim=-1, keepdim=True)
        out = x32 * torch.rsqrt(var + cfg.norm_eps) * scale
    else:
        mean = x32.mean(dim=-1, keepdim=True)
        var = x32.var(dim=-1, keepdim=True, unbiased=False)
        out = (x32 - mean) * torch.rsqrt(var + cfg.norm_eps) * scale
        if bias is not None:
            out = out + bias
    return out.to(x.dtype)


def _rope_angles(positions, cfg: DecoderConfig):
    """cos, sin [B, 1, T, rot_dim // 2] of the NeoX rotary embedding, float32;
    computed once per forward and shared by every layer."""
    half = int(cfg.head_dim * cfg.rotary_pct) // 2
    exponent = -torch.arange(half, dtype=torch.float32, device=positions.device) / half
    freqs = torch.pow(float(cfg.rope_theta), exponent)
    angles = positions[:, None, :, None].float() * freqs          # [B,1,T,half]
    return torch.cos(angles), torch.sin(angles)


def _rope(x, cos, sin):
    """NeoX-style rotary embedding on the first 2 * cos.shape[-1] channels.
    x: [B, H, T, Dh]."""
    half = cos.shape[-1]
    if half == 0:
        return x
    x_rot, x_pass = x[..., :2 * half], x[..., 2 * half:]
    x1, x2 = x_rot[..., :half], x_rot[..., half:]
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([rotated.to(x.dtype), x_pass], dim=-1)


def _proj(x, w, b, dt):
    """[..., d] @ [d, f] (+ b). w is a dense weight or an int8 weight
    {"q": int8 [d, f], "s": bf16 [1, f]} (the int8 decode path,
    `generate.prepare_int8_decode_params`): as the JAX package's `_proj_w`,
    the input goes to `dq_matmul` in bf16 and its bf16 output comes back in
    the compute dtype."""
    if isinstance(w, dict):
        lead = x.shape[:-1]
        y = dq_matmul(x.reshape(-1, x.shape[-1]).to(torch.bfloat16).contiguous(),
                      w["q"], w["s"])
        y = y.reshape(*lead, y.shape[-1]).to(dt)
    else:
        y = x @ w.to(dt)
    return y + b.to(dt) if b is not None else y


def _row_proj(x, w, b, dt, tp):
    """A row-parallel `_proj`: the ranks' partial products summed over the
    'model' line (`tp`), then the bias; `_proj` itself without `tp`."""
    if tp is None:
        return _proj(x, w, b, dt)
    y = reduce_out(_proj(x, w, None, dt), tp)
    return y + b.to(dt) if b is not None else y


def _mlp(x, lp: DecoderLayer, cfg: DecoderConfig):
    dt = x.dtype
    tp = lp.tp if lp.tp is not None and lp.tp.mlp else None
    x = copy_in(x, tp)
    up = _proj(x, lp.up_w, lp.up_b, dt)
    if cfg.act == "silu_glu":
        h = F.silu(_proj(x, lp.gate_w, lp.gate_b, dt)) * up
    elif cfg.act == "gelu_glu":
        h = F.gelu(_proj(x, lp.gate_w, lp.gate_b, dt), approximate="tanh") * up
    elif cfg.act == "relu":
        h = F.relu(up)
    else:  # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(up, approximate="tanh")
    return _row_proj(h, lp.down_w, lp.down_b, dt, tp)


def _split_heads(x, head_dim):
    """[B, T, H * Dh] -> [B, H, T, Dh]; H from the width (a tensor-parallel
    layer's local heads)."""
    b, t, _ = x.shape
    return x.view(b, t, -1, head_dim).transpose(1, 2)


def _merge_heads(x):
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


def _decode_attention(q, k, v, segment_ids, cache_index: int, cfg: DecoderConfig):
    """One query token against the UN-repeated cache: q heads are kv-major,
    so head i reads kv head i // groups. q [B,H,1,Dh], k/v [B,Hkv,Tmax,Dh]
    (a tensor-parallel layer's local heads)."""
    b, h, _, dh = q.shape
    hkv = k.shape[1]
    qg = q[:, :, 0].reshape(b, hkv, h // hkv, dh)
    scores = torch.einsum("bkgd,bktd->bkgt", qg.float(), k.float()) * cfg.head_dim ** -0.5
    valid = torch.arange(k.shape[2], device=q.device)[None, None, None, :] <= cache_index
    if segment_ids is not None:
        valid = valid & (segment_ids[:, None, None, :] >= 0)
    scores = scores.masked_fill(~valid, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    attn = torch.einsum("bkgt,bktd->bkgd", probs, v)
    return attn.reshape(b, h, 1, dh)


def _use_flash(cfg: DecoderConfig, device) -> bool:
    """JAX's `_use_flash`: "flash" and "xla" say which path runs; "auto" is
    the kernels on the card and the plain attention on the CPU."""
    if cfg.attn_impl in ("flash", "xla"):
        return cfg.attn_impl == "flash"
    return torch.device(device).type != "cpu"


def _flash_route(cfg: DecoderConfig, device, probs_dropout: bool) -> bool:
    """Whether full-sequence attention goes through `flash_attention`: on
    the flash path, and on a CPU tensor without probability dropout, where
    `flash_attention` runs the plain attention itself."""
    return _use_flash(cfg, device) or (torch.device(device).type == "cpu"
                                       and not probs_dropout)


def _pre_attention(x, lp: DecoderLayer, rope, cfg: DecoderConfig):
    """Norm (pre-norm), q/k/v projections and rope: (q, k, v)."""
    dt = x.dtype
    h = _norm(x, lp.attn_norm_scale, lp.attn_norm_bias, cfg) if cfg.pre_norm else x
    h = copy_in(h, lp.tp)
    q = _split_heads(_proj(h, lp.q_w, lp.q_b, dt), cfg.head_dim)
    k = _split_heads(_proj(h, lp.k_w, lp.k_b, dt), cfg.head_dim)
    v = _split_heads(_proj(h, lp.v_w, lp.v_b, dt), cfg.head_dim)
    if rope is not None:
        q = _rope(q, *rope)
        k = _rope(k, *rope)
    return q, k, v


def _attention(q, k, v, segment_ids, cfg: DecoderConfig, seed: Optional[int], layer: int,
               shard=None, tp=None):
    """Full-sequence causal attention (scoring, training, a prefill's window)
    on the route `_flash_route` picks, with probability dropout on the plain
    attention when `seed` is given.

    Under a `shard` whose 'seq' group has several ranks (context
    parallelism; q, k, v are this rank's chunk) the flash route runs
    `ring_flash_attention` (JAX `models/transformer.py:206-222`) and the
    plain route gathers k, v and the key segment ids over the group, with
    the causal mask offset by the chunk's first position, as GSPMD does on
    the JAX package's XLA path. Under `tp` (q, k, v hold the rank's heads)
    the probabilities' mask is the global heads' mask, narrowed to them."""
    rate = cfg.attention_dropout if seed is not None else 0.0
    ring = shard is not None and shard.size > 1
    if _flash_route(cfg, q.device, rate > 0.0):
        if ring:
            return ring_flash_attention(q, k, v, segment_ids, group=shard.group,
                                        schedule=shard.schedule,
                                        sm_scale=cfg.head_dim ** -0.5)
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               segment_ids=segment_ids, causal=True,
                               sm_scale=cfg.head_dim ** -0.5)
    kv_segment_ids, offset = None, 0
    if ring:
        k, v = all_gather_seq(k, shard.group, 2), all_gather_seq(v, shard.group, 2)
        if segment_ids is not None:
            kv_segment_ids = all_gather_seq(segment_ids, shard.group, 1)
        offset = shard.rank * q.shape[2]

    def keep(shape):
        heads = shape[1] if tp is None else cfg.num_heads
        if shard is None:
            mask = _keep_mask(seed, (ATTN_PROBS, layer), (shape[0], heads, *shape[2:]), rate,
                              q.device)
        else:
            full = (shard.batch, heads, shard.time, shard.time)
            mask = shard.tile(_keep_mask(seed, (ATTN_PROBS, layer), full, rate, q.device), 2)
        return mask if tp is None else mask.narrow(1, tp.rank * shape[1], shape[1])

    return mha_reference(q, k, v, segment_ids=segment_ids, causal=True,
                         sm_scale=cfg.head_dim ** -0.5, kv_segment_ids=kv_segment_ids,
                         dropout_rate=rate, dropout_keep=keep, q_offset=offset)[0]


def _post_attention(x, attn, lp: DecoderLayer, cfg: DecoderConfig, seed: Optional[int],
                    layer: int, shard=None):
    """The o projection, the residuals and the MLP of the block's layout,
    with residual-branch dropout (HF hidden dropout) when `seed` is given."""
    dt = x.dtype
    attn_out = _dropout(_row_proj(_merge_heads(attn), lp.o_w, lp.o_b, dt, lp.tp), cfg.dropout,
                        seed, (ATTN_RES, layer), shard)
    mlp = lambda h: _dropout(_mlp(h, lp, cfg), cfg.dropout, seed, (MLP_RES, layer), shard)
    if cfg.parallel_residual:
        h2 = _norm(x, lp.mlp_norm_scale, lp.mlp_norm_bias, cfg)
        return x + attn_out + mlp(h2)
    if cfg.pre_norm:
        x = x + attn_out
        h2 = _norm(x, lp.mlp_norm_scale, lp.mlp_norm_bias, cfg)
        return x + mlp(h2)
    # post-LN (OPT-350m): norm(x + attn), then norm(x + mlp)
    x = _norm(x + attn_out, lp.attn_norm_scale, lp.attn_norm_bias, cfg)
    return _norm(x + mlp(x), lp.mlp_norm_scale, lp.mlp_norm_bias, cfg)


def _layer(x, lp: DecoderLayer, rope, segment_ids, cfg: DecoderConfig,
           cache_kv=None, cache_index: Optional[int] = None,
           seed: Optional[int] = None, layer: int = 0, shard=None):
    """One decoder block. rope: (cos, sin) from `_rope_angles`, or None for
    learned positions. cache_kv: optional (k, v) [B, Hkv, Tmax, Dh] views,
    written in place at cache_index. seed: the forward's dropout seed
    (training), layer: this block's index among the masks' sites, shard:
    this rank's tile of the global batch (`parallel.Shard`) or None."""
    q, k, v = _pre_attention(x, lp, rope, cfg)
    decode = cache_kv is not None and q.shape[2] == 1
    if cache_kv is not None:
        ck, cv = cache_kv
        t = k.shape[2]
        ck[:, :, cache_index:cache_index + t] = k.to(ck.dtype)
        cv[:, :, cache_index:cache_index + t] = v.to(cv.dtype)
        if decode:
            k, v = ck.to(x.dtype), cv.to(x.dtype)

    if decode:
        attn = _decode_attention(q, k, v, segment_ids, cache_index, cfg)
    else:
        attn = _attention(q, k, v, segment_ids, cfg, seed, layer, shard, lp.tp)
    return _post_attention(x, attn, lp, cfg, seed, layer, shard)


def _qkv_remat_layer(x, lp: DecoderLayer, rope, segment_ids, cfg: DecoderConfig,
                     seed: Optional[int], layer: int, shard=None):
    """`_layer` under remat_policy="qkv": the parts before and after the
    attention are checkpointed apart; the flash attention between them saves
    its q, k, v, out and LSE, so the backward never runs its forward again.
    The plain attention (which would keep the probabilities) is checkpointed
    on its own."""
    q, k, v = checkpoint(_pre_attention, x, lp, rope, cfg, use_reentrant=False)
    rate = cfg.attention_dropout if seed is not None else 0.0
    if _flash_route(cfg, x.device, rate > 0.0):
        attn = _attention(q, k, v, segment_ids, cfg, seed, layer, shard, lp.tp)
    else:
        attn = checkpoint(_attention, q, k, v, segment_ids, cfg, seed, layer, shard, lp.tp,
                          use_reentrant=False)
    return checkpoint(_post_attention, x, attn, lp, cfg, seed, layer, shard,
                      use_reentrant=False)


class Decoder(nn.Module):
    """The decoder's parameters and its forward.

    Built with uninitialised weights; call `reset_parameters(generator)` for
    the gslm random init, or load weights (`models.convert.load_flat`)."""

    def __init__(self, cfg: DecoderConfig, device=None):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        D, E, dev = cfg.hidden_size, cfg.embed_proj_dim or cfg.hidden_size, device
        ln_bias = cfg.norm == "layernorm" and cfg.norm_bias
        self.embed = _param(cfg.vocab_size, E, device=dev)
        self.layers = nn.ModuleList(DecoderLayer(cfg, dev) for _ in range(cfg.num_layers))
        _opt_param(self, "final_norm_scale", cfg.pre_norm, D, device=dev, fill=1.0)
        _opt_param(self, "final_norm_bias", cfg.pre_norm and ln_bias, D, device=dev,
                   fill=0.0)
        _opt_param(self, "proj_in_w", bool(cfg.embed_proj_dim), E, D, device=dev)
        _opt_param(self, "proj_out_w", bool(cfg.embed_proj_dim), D, E, device=dev)
        _opt_param(self, "pos_embed", cfg.pos == "learned",
                   cfg.max_position_embeddings + cfg.learned_pos_offset, D, device=dev)
        _opt_param(self, "lm_head", not cfg.tie_word_embeddings, E, cfg.vocab_size,
                   device=dev)
        self.tp = None   # parallel.tensor.TensorParallel once split over 'model'

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Random init (the gslm mode, JAX `init_params`): matrices from
        N(0, initializer_range), norm scales 1, biases 0. The draws come from
        `generator` and differ from JAX's."""
        std = self.cfg.initializer_range
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf.endswith("_scale"):
                p.fill_(1.0)
            elif leaf.endswith("_b") or leaf.endswith("_bias"):
                p.zero_()
            else:
                p.normal_(0.0, std, generator=generator)
        return self

    def forward(self, input_ids: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None,
                cache: Optional[tuple] = None,
                cache_index: Optional[int] = None,
                dropout_seed: Optional[int] = None,
                shard=None, cast_weights: bool = False):
        """Returns (logits float32 [B, T, V], cache); split over 'model'
        (`parallel.tensor.shard_decoder_tp`) with a vocab-sharded head, the
        rank's [B, T, V / size] columns.

        positions default to 0..T-1; pass explicit positions for left-padded
        prompts. segment_ids [B, T]: -1 marks padding. cache: (k, v) tensors
        [L, B, Hkv, Tmax, Dh] from `init_cache`, updated in place at
        cache_index; a one-token input with a cache runs the decode step.
        dropout_seed (an int) turns on the config's dropout, attention
        dropout and layerdrop for this forward (training; never with a
        cache); without it the forward is deterministic. shard: this rank's
        tile of a global batch (`parallel.Shard`: input_ids and the rest are
        the tile; the dropout masks are the global batch's, and a 'seq'
        group of several ranks runs the ring) or None. cast_weights: run on
        the weights `models/generate.compute_copy` would hold (each cast to
        the compute dtype at its use, the 1-D final norm kept float32), for
        a decoder whose weights are sharded and cannot be copied whole."""
        cfg = self.cfg
        dt = cfg.compute_dtype
        b, t = input_ids.shape
        seed = dropout_seed if cache is None and (
            cfg.dropout > 0.0 or cfg.attention_dropout > 0.0 or cfg.layerdrop > 0.0) else None
        if seed is not None and cfg.attention_dropout > 0.0 and \
                _use_flash(cfg, input_ids.device):
            # the flash kernels never hold the probabilities to mask
            raise ValueError(
                "attention_dropout > 0 requires attn_implementation='xla' (the "
                "flash kernel does not support probability dropout); set "
                "model.config_args.attn_implementation=xla or use dropout/layerdrop "
                "instead")
        if positions is None:
            positions = torch.arange(t, device=input_ids.device).expand(b, t)

        x = embed_lookup(input_ids, self.embed, self.tp).to(dt)
        if cfg.embed_proj_dim:
            # OPT-350m: project before the learned positions are added
            x = x @ self.proj_in_w.to(dt)
        if cfg.pos == "learned":
            if t > cfg.max_position_embeddings:
                raise ValueError(
                    f"sequence length {t} exceeds max_position_embeddings "
                    f"{cfg.max_position_embeddings} for learned positions")
            # clamp like JAX's gather, which never raises on an index
            idx = (positions + cfg.learned_pos_offset).clamp(max=self.pos_embed.shape[0] - 1)
            x = x + F.embedding(idx, self.pos_embed).to(dt)
        x = _dropout(x, cfg.dropout, seed, (EMBED,), shard)

        rope = _rope_angles(positions, cfg) if cfg.pos == "rope" else None
        n_remat = 0
        if cfg.remat and cache is None and torch.is_grad_enabled():
            n_remat = cfg.num_layers if cfg.remat_layers < 0 else \
                min(cfg.remat_layers, cfg.num_layers)
        skipped = (_layer_drops(seed, cfg.num_layers, cfg.layerdrop)
                   if seed is not None and cfg.layerdrop > 0.0 else [False] * cfg.num_layers)
        for i, lp in enumerate(self.layers):
            kv = None if cache is None else (cache[0][i], cache[1][i])
            x = lp(x, rope, segment_ids, cfg, cache_kv=kv, cache_index=cache_index,
                   seed=seed, layer=i, shard=shard, remat=i < n_remat, skip=skipped[i],
                   cast=cast_weights)

        if cfg.pre_norm:
            x = _norm(x, self.final_norm_scale, self.final_norm_bias, cfg)
        if cfg.embed_proj_dim:
            x = x @ self.proj_out_w.to(x.dtype)
        head = self.embed.t() if cfg.tie_word_embeddings else self.lm_head
        if cast_weights:
            head = head.to(dt)
        vocab_tp = self.tp if self.tp is not None and self.tp.vocab is not None else None
        logits = copy_in(x.float(), vocab_tp) @ head.float()
        return logits, cache


def init_cache(cfg: DecoderConfig, batch: int, max_len: int, dtype=None, device=None,
               kv_heads: Optional[int] = None):
    """KV cache tensors [L, B, Hkv, Tmax, Dh], zero-filled; kv_heads: a
    tensor-parallel rank's local count (default all of them)."""
    dtype = dtype or cfg.compute_dtype
    shape = (cfg.num_layers, batch, kv_heads or cfg.num_kv_heads, max_len, cfg.head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def param_count(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())
