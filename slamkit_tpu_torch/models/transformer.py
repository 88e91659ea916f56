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

Full-sequence attention (training, scoring, generation prefill) goes through
`ops.flash_attention`: the CUDA kernels on the card, the plain versions on
the CPU; under autograd its gradient is the flash backward. The single-token
decode step attends over the KV cache with plain einsums, as the JAX package
does. The KV cache is updated in place.

Training: the parameters take gradients (serving runs under
`torch.inference_mode`). `cfg.remat` checkpoints the first `remat_layers`
layers (all when -1) with `torch.utils.checkpoint`, the JAX package's
`jax.checkpoint` of the layer scan: the backward recomputes each layer's
forward, flash kernel included. Dropout, attention dropout, layerdrop and the
"qkv" remat policy are not ported; a config that sets them raises.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import flash_attention
from .presets import DecoderConfig

NEG_INF = -1e30


def _check_supported(cfg: DecoderConfig):
    """Refuse what the port does not implement yet (ROADMAP queue 1 item 6)."""
    for name in ("dropout", "attention_dropout", "layerdrop"):
        if getattr(cfg, name) > 0.0:
            raise ValueError(f"{name}={getattr(cfg, name)}: the port's decoder does not "
                             f"implement dropout or layerdrop yet (ROADMAP queue 1 item 6)")
    if cfg.remat_policy != "full":
        raise ValueError(f"remat_policy={cfg.remat_policy!r}: the port checkpoints whole "
                         f"layers only (\"full\"); the qkv policy waits (ROADMAP queue 1 "
                         f"item 6)")


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
    y = x @ w.to(dt)
    return y + b.to(dt) if b is not None else y


def _mlp(x, lp: DecoderLayer, cfg: DecoderConfig):
    dt = x.dtype
    up = _proj(x, lp.up_w, lp.up_b, dt)
    if cfg.act == "silu_glu":
        h = F.silu(_proj(x, lp.gate_w, lp.gate_b, dt)) * up
    elif cfg.act == "gelu_glu":
        h = F.gelu(_proj(x, lp.gate_w, lp.gate_b, dt), approximate="tanh") * up
    elif cfg.act == "relu":
        h = F.relu(up)
    else:  # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(up, approximate="tanh")
    return _proj(h, lp.down_w, lp.down_b, dt)


def _split_heads(x, n_heads, head_dim):
    b, t, _ = x.shape
    return x.view(b, t, n_heads, head_dim).transpose(1, 2)


def _merge_heads(x):
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


def _decode_attention(q, k, v, segment_ids, cache_index: int, cfg: DecoderConfig):
    """One query token against the UN-repeated cache: q heads are kv-major,
    so head i reads kv head i // groups. q [B,H,1,Dh], k/v [B,Hkv,Tmax,Dh]."""
    b, _, _, dh = q.shape
    groups = cfg.num_heads // cfg.num_kv_heads
    qg = q[:, :, 0].reshape(b, cfg.num_kv_heads, groups, dh)
    scores = torch.einsum("bkgd,bktd->bkgt", qg.float(), k.float()) * cfg.head_dim ** -0.5
    valid = torch.arange(k.shape[2], device=q.device)[None, None, None, :] <= cache_index
    if segment_ids is not None:
        valid = valid & (segment_ids[:, None, None, :] >= 0)
    scores = scores.masked_fill(~valid, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    attn = torch.einsum("bkgt,bktd->bkgd", probs, v)
    return attn.reshape(b, cfg.num_heads, 1, dh)


def _layer(x, lp: DecoderLayer, rope, segment_ids, cfg: DecoderConfig,
           cache_kv=None, cache_index: Optional[int] = None):
    """One decoder block. rope: (cos, sin) from `_rope_angles`, or None for
    learned positions. cache_kv: optional (k, v) [B, Hkv, Tmax, Dh] views,
    written in place at cache_index."""
    dt = x.dtype
    h = _norm(x, lp.attn_norm_scale, lp.attn_norm_bias, cfg) if cfg.pre_norm else x
    q = _split_heads(_proj(h, lp.q_w, lp.q_b, dt), cfg.num_heads, cfg.head_dim)
    k = _split_heads(_proj(h, lp.k_w, lp.k_b, dt), cfg.num_kv_heads, cfg.head_dim)
    v = _split_heads(_proj(h, lp.v_w, lp.v_b, dt), cfg.num_kv_heads, cfg.head_dim)
    if rope is not None:
        q = _rope(q, *rope)
        k = _rope(k, *rope)

    decode = cache_kv is not None and q.shape[2] == 1
    if cache_kv is not None:
        ck, cv = cache_kv
        t = k.shape[2]
        ck[:, :, cache_index:cache_index + t] = k.to(ck.dtype)
        cv[:, :, cache_index:cache_index + t] = v.to(cv.dtype)
        if decode:
            k, v = ck.to(dt), cv.to(dt)

    if decode:
        attn = _decode_attention(q, k, v, segment_ids, cache_index, cfg)
    else:
        # scoring, or prefill attending within the current window
        attn = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               segment_ids=segment_ids, causal=True,
                               sm_scale=cfg.head_dim ** -0.5)
    attn_out = _proj(_merge_heads(attn), lp.o_w, lp.o_b, dt)

    if cfg.parallel_residual:
        h2 = _norm(x, lp.mlp_norm_scale, lp.mlp_norm_bias, cfg)
        return x + attn_out + _mlp(h2, lp, cfg)
    if cfg.pre_norm:
        x = x + attn_out
        h2 = _norm(x, lp.mlp_norm_scale, lp.mlp_norm_bias, cfg)
        return x + _mlp(h2, lp, cfg)
    # post-LN (OPT-350m): norm(x + attn), then norm(x + mlp)
    x = _norm(x + attn_out, lp.attn_norm_scale, lp.attn_norm_bias, cfg)
    return _norm(x + _mlp(x, lp, cfg), lp.mlp_norm_scale, lp.mlp_norm_bias, cfg)


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
                cache_index: Optional[int] = None):
        """Returns (logits float32 [B, T, V], cache).

        positions default to 0..T-1; pass explicit positions for left-padded
        prompts. segment_ids [B, T]: -1 marks padding. cache: (k, v) tensors
        [L, B, Hkv, Tmax, Dh] from `init_cache`, updated in place at
        cache_index; a one-token input with a cache runs the decode step."""
        cfg = self.cfg
        dt = cfg.compute_dtype
        b, t = input_ids.shape
        if positions is None:
            positions = torch.arange(t, device=input_ids.device).expand(b, t)

        x = F.embedding(input_ids, self.embed).to(dt)
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

        rope = _rope_angles(positions, cfg) if cfg.pos == "rope" else None
        n_remat = 0
        if cfg.remat and cache is None and torch.is_grad_enabled():
            n_remat = cfg.num_layers if cfg.remat_layers < 0 else \
                min(cfg.remat_layers, cfg.num_layers)
        for i, lp in enumerate(self.layers):
            if i < n_remat:
                x = checkpoint(_layer, x, lp, rope, segment_ids, cfg, use_reentrant=False)
                continue
            kv = None if cache is None else (cache[0][i], cache[1][i])
            x = _layer(x, lp, rope, segment_ids, cfg, cache_kv=kv,
                       cache_index=cache_index)

        if cfg.pre_norm:
            x = _norm(x, self.final_norm_scale, self.final_norm_bias, cfg)
        if cfg.embed_proj_dim:
            x = x @ self.proj_out_w.to(x.dtype)
        head = self.embed.t() if cfg.tie_word_embeddings else self.lm_head
        logits = x.float() @ head.float()
        return logits, cache


def init_cache(cfg: DecoderConfig, batch: int, max_len: int, dtype=None, device=None):
    """KV cache tensors [L, B, Hkv, Tmax, Dh], zero-filled."""
    dtype = dtype or cfg.compute_dtype
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len, cfg.head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def param_count(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())
