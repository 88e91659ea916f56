"""Autoregressive sampling with a KV cache.

Counterpart of `slamkit_tpu/models/generate.py`: left-padded prompts, one
prefill through the flash kernel, then single-token decode steps over the
cache; temperature / top-k / top-p sampling, a repetition penalty, a
bad-words vocab mask, and pad after eos. The JAX package traces the decode
loop with `lax.scan`; here it is a Python loop. Sampling draws come from an
explicit `torch.Generator`, so they differ from JAX's keys; the warped
logits they are drawn from are the same.

`weight_quant="int8"` (JAX `generate.py:124`) quantizes the seven projection
weights of every layer per output channel (`ops/quant.py`) and runs them
through the dequant-matmul kernel in the prefill and in every decode step.

On a mesh (`UnitLM.shard`) a rank decodes its rows (`parallel.RowTile`); a
sampled step all-gathers the ranks' masked last-position logits to the
global [B, V], draws from them and keeps its rows, so the draws are one
process's. Greedy steps need no gather. A decoder whose weights are
sharded over the ranks (`UnitLM.shard(fsdp=True)`) is never copied whole:
dense generation runs it as it is, each layer gathered as it runs and cast
at its use to the values `compute_copy` would hold (`Decoder.forward`'s
`cast_weights`), and the int8 copy gathers one weight at a time and
quantizes it whole.

A decoder split over 'model' (`UnitLM.shard(tp=True)`, `parallel/tensor.py`)
keeps its slices: the KV cache holds the rank's kv heads, the last
position's vocab columns are gathered whole (`gather_vocab`) before they are
masked and sampled, so every rank of a 'model' line draws the same token
from the same generator. Its int8 copy quantizes each projection whole, so
the scales are the unsharded ones bit for bit, then keeps the rank's slice:
a column-parallel weight its columns of q and s, a row-parallel one its
rows of q and the whole s; `dq_matmul` runs on the slices and the
row-parallel partial outputs are summed over the line.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.quant import quantize_weight
from ..parallel.fsdp import inference_forward, is_sharded
from ..parallel.tensor import gather_vocab, is_tp, tp_shard, whole_of
from .convert import whole
from .transformer import Decoder, init_cache

NEG_INF = -1e30


def warp_logits(logits: torch.Tensor, temperature: Optional[float],
                top_k: Optional[int], top_p: Optional[float]) -> torch.Tensor:
    """Temperature, then top-k, then top-p (HF warper order). Masked ids get
    NEG_INF, which softmax turns into an exact 0."""
    if temperature is not None:
        logits = logits / max(float(temperature), 1e-6)
    if top_k is not None and top_k > 0:
        # clamped to the vocab size (HF TopKLogitsWarper)
        kth = torch.topk(logits, min(int(top_k), logits.shape[-1]), dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, NEG_INF)
    if top_p is not None:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # keep the smallest set of ids whose cumulative prob exceeds top_p;
        # an index past the end (rounding) keeps everything, as JAX's
        # out-of-range take_along_axis does
        cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True).clamp(max=logits.shape[-1] - 1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = logits.masked_fill(logits < cutoff, NEG_INF)
    return logits


def _sample(logits, generator, do_sample, temperature, top_k, top_p):
    if not do_sample:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(warp_logits(logits, temperature, top_k, top_p), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def _apply_repetition_penalty(logits, seen, penalty):
    """HF semantics: logits of already-seen ids are divided by the penalty
    when positive, multiplied when negative."""
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen, penalized, logits)


#: the per-layer projections that `weight_quant="int8"` quantizes (JAX
#: `generate.py:58`); embeddings (a gather) and the logit head stay dense
_QUANT_KEYS = ("q_w", "k_w", "v_w", "o_w", "up_w", "gate_w", "down_w")


def _weights(decoder: Decoder) -> dict:
    """name -> tensor, or {"q", "s"} for a projection that is int8 already."""
    state = dict(decoder.state_dict())
    for i, layer in enumerate(decoder.layers):
        for key in _QUANT_KEYS:
            w = getattr(layer, key, None)
            if isinstance(w, dict):
                state[f"layers.{i}.{key}"] = w
    return state


def _assemble(decoder: Decoder, state: dict) -> Decoder:
    """A Decoder holding `state`'s tensors without copies (a tensor-parallel
    rank's slices, with the decoder's `tp`); an int8 dict replaces its
    parameter as a plain attribute, which `_proj` reads."""
    clone = Decoder(decoder.cfg, device="meta")
    missing = sorted({name for name, _ in clone.named_parameters()} - set(state))
    if missing:
        raise ValueError(f"weights missing from the decoder's state: {missing}")
    for name, w in state.items():
        module, leaf = name.rsplit(".", 1) if "." in name else ("", name)
        owner = clone.get_submodule(module)
        if isinstance(w, dict):
            del owner._parameters[leaf]
            setattr(owner, leaf, w)
        else:
            owner._parameters[leaf] = nn.Parameter(w, requires_grad=False)
    clone.tp = decoder.tp
    for mine, theirs in zip(clone.layers, decoder.layers):
        mine.tp = theirs.tp
    return clone


def _cast(name: str, w, dtype):
    """`compute_copy`'s value of the weight `name`: cast to `dtype` if it is
    a layer's or has more than one dimension; int8 dicts pass through."""
    cast = not isinstance(w, dict) and (name.startswith("layers.") or w.dim() > 1)
    return w.to(dtype) if cast else w


def compute_copy(decoder: Decoder) -> Decoder:
    """The decoder with its weights cast to the compute dtype once, as the
    JAX package casts every float32 array of more than one dimension before
    its decode loop (per-layer arrays are stacked there, so all of them; the
    1-D final norm stays float32 and is shared with `decoder`)."""
    dt = decoder.cfg.compute_dtype
    return _assemble(decoder, {name: _cast(name, p, dt)
                               for name, p in _weights(decoder).items()})


def _quantize_decode_params(state: dict) -> dict:
    """int8 weight-only quantization of every layer's `_QUANT_KEYS` weight in
    a name -> weight dict (JAX `_quantize_decode_params` :61). Leaves that are
    {"q", "s"} already pass through untouched."""
    out = dict(state)
    for name, w in state.items():
        if (name.startswith("layers.") and name.rsplit(".", 1)[-1] in _QUANT_KEYS
                and isinstance(w, torch.Tensor)):
            q, s = quantize_weight(w)
            out[name] = {"q": q, "s": s}
    return out


def prepare_int8_decode_params(decoder: Decoder) -> Decoder:
    """The decoder for int8 decoding: its weights cast to the compute dtype
    FIRST and the cast values quantized, as JAX `generate` does
    (`generate.py:121-125`; quantizing the float32 masters instead would put
    a few weights one int8 step away). Idempotent: a decoder prepared before
    comes back with the same int8 tensors. A sharded decoder is gathered one
    weight at a time, each quantized whole, so the int8 weights and scales
    are the unsharded model's bit for bit; the copy is whole on every rank
    (every rank must call it). A decoder split over 'model' quantizes each
    projection whole the same way, then keeps the rank's slice of q (and of
    s where it scales the split columns); its other weights stay slices."""
    if not is_sharded(decoder) and not is_tp(decoder):
        return _assemble(decoder, _quantize_decode_params(_weights(compute_copy(decoder))))
    dt = decoder.cfg.compute_dtype
    state = {name: w for name, w in _weights(decoder).items() if isinstance(w, dict)}
    for name, p in decoder.named_parameters():
        shard = tp_shard(p)
        quantized = name.startswith("layers.") and name.rsplit(".", 1)[-1] in _QUANT_KEYS
        w = whole(p.detach()) if not quantized else whole_of(p, whole(p.detach()))
        w = _quantize_decode_params({name: _cast(name, w, dt)})[name]
        if shard is not None and quantized:
            part = lambda t: shard.narrow(t).clone(memory_format=torch.contiguous_format)
            w = {"q": part(w["q"]), "s": w["s"] if shard.dim == 0 else part(w["s"])}
        state[name] = w
    return _assemble(decoder, state)


def is_int8_prepared(decoder: Decoder) -> bool:
    """True when every layer's `_QUANT_KEYS` projection is an int8 dict, as
    `prepare_int8_decode_params` leaves them."""
    return all(isinstance(getattr(layer, key, None), dict)
               for layer in decoder.layers for key in _QUANT_KEYS)


@inference_forward(lambda decoder, *args, **kwargs: decoder)
def generate(decoder: Decoder, input_ids: torch.Tensor, attention_mask: torch.Tensor,
             generator: Optional[torch.Generator], *, max_new_tokens: int,
             do_sample: bool = True, temperature: Optional[float] = None,
             top_k: Optional[int] = None, top_p: Optional[float] = None,
             eos_token_id: Optional[int] = None, pad_token_id: int = 0,
             repetition_penalty: Optional[float] = None,
             bad_words_mask: Optional[torch.Tensor] = None,
             weight_quant: Optional[str] = None, tile=None) -> torch.Tensor:
    """input_ids [B, L0] LEFT-padded, attention_mask [B, L0], both on the
    decoder's device. Returns [B, L0 + max_new_tokens]; positions after eos
    hold pad_token_id. bad_words_mask: bool [V], True = banned id.
    weight_quant="int8" runs every projection of the prefill and of each
    decode step through `dq_matmul` on int8 weights; a decoder that
    `prepare_int8_decode_params` returned runs as it is. tile: the
    `parallel.RowTile` that input_ids are this rank's rows of, or None."""
    b, l0 = input_ids.shape
    if max_new_tokens <= 0:  # HF returns the prompt unchanged
        return input_ids
    cfg = decoder.cfg
    dev = input_ids.device
    if weight_quant == "int8":
        dec = decoder if is_int8_prepared(decoder) else prepare_int8_decode_params(decoder)
    elif weight_quant:
        raise ValueError(f"unknown weight_quant {weight_quant!r} (only 'int8')")
    elif not is_sharded(decoder):
        dec = compute_copy(decoder)
    else:   # each layer gathered as it runs, cast as compute_copy casts it
        dec = lambda *a, **kw: decoder(*a, cast_weights=True, **kw)

    mask = attention_mask.to(torch.int32)
    prompt_seg = torch.where(mask > 0, 0, -1).to(torch.int32)
    seg_full = torch.cat([prompt_seg, torch.zeros((b, max_new_tokens), dtype=torch.int32,
                                                  device=dev)], dim=1)
    positions = (torch.cumsum(mask, dim=1) - 1).clamp(min=0)
    prompt_len = mask.sum(dim=1)

    tp = decoder.tp
    cache = init_cache(cfg, b, l0 + max_new_tokens, device=dev,
                       kv_heads=cfg.num_kv_heads // (tp.size if tp is not None else 1))
    logits, cache = dec(input_ids, positions=positions, segment_ids=prompt_seg,
                        cache=cache, cache_index=0)
    # rightmost position is the last real token
    last_logits = gather_vocab(logits[:, -1, :], tp)

    def mask_logits(lg, seen):
        if bad_words_mask is not None:
            lg = lg.masked_fill(bad_words_mask[None, :], NEG_INF)
        if repetition_penalty is not None:
            lg = _apply_repetition_penalty(lg, seen, repetition_penalty)
        return lg

    # per-row presence of the prompt's non-pad ids, for the penalty
    rows = torch.arange(b, device=dev)
    seen = torch.zeros((b, cfg.vocab_size), dtype=torch.bool, device=dev)
    seen[rows[:, None].expand(b, l0)[mask > 0], input_ids[mask > 0].long()] = True

    def sample(lg):
        if tile is None or not do_sample:
            return _sample(lg, generator, do_sample, temperature, top_k, top_p)
        drawn = _sample(tile.gather(lg), generator, do_sample, temperature, top_k, top_p)
        return tile.mine(drawn, pad_token_id)

    tok = sample(mask_logits(last_logits, seen))
    seen[rows, tok] = True
    finished = (tok == eos_token_id) if eos_token_id is not None else \
        torch.zeros(b, dtype=torch.bool, device=dev)
    out = [tok]
    for i in range(max_new_tokens - 1):
        pos = (prompt_len + i)[:, None]
        logits, cache = dec(tok[:, None], positions=pos, segment_ids=seg_full,
                            cache=cache, cache_index=l0 + i)
        nxt = sample(mask_logits(gather_vocab(logits[:, -1, :], tp), seen))
        nxt = torch.where(finished, torch.full_like(nxt, pad_token_id), nxt)
        seen[rows, nxt] = True
        if eos_token_id is not None:
            finished = finished | (nxt == eos_token_id)
        out.append(nxt)
        tok = nxt
    gen = torch.stack(out, dim=1).to(input_ids.dtype)
    return torch.cat([input_ids, gen], dim=1)
