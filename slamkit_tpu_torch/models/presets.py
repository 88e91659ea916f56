"""Decoder configuration and the model-family preset table.

Counterpart of `slamkit_tpu/models/presets.py` plus the `DecoderConfig` of
`slamkit_tpu/models/transformer.py:31-81`. It is a copy, not an import: the JAX
module imports `transformer.py`, which imports jax. `tests/test_torch_presets.py`
holds `PRESETS` and `resolve_base_config` equal to the JAX package's.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Optional

import torch

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    vocab_size: int = 512
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    num_kv_heads: int = 12
    head_dim: int = 64
    max_position_embeddings: int = 2048
    # family knobs
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    act: str = "silu_glu"            # silu_glu | gelu_glu | relu | gelu
    pos: str = "rope"                # rope | learned
    rope_theta: float = 10000.0
    rotary_pct: float = 1.0          # gptneox uses 0.25
    learned_pos_offset: int = 0      # OPT uses 2
    parallel_residual: bool = False  # gptneox/pythia
    qkv_bias: bool = False           # qwen2: True
    attn_out_bias: bool = False
    mlp_bias: bool = False
    norm_bias: bool = False          # layernorm bias (opt/neox: True)
    embed_proj_dim: int = 0          # OPT-350m project_in/out width; 0 = hidden
    pre_norm: bool = True            # False = post-LN blocks (OPT-350m)
    tie_word_embeddings: bool = True
    norm_eps: float = 1e-6
    initializer_range: float = 0.02
    # training-time regularisation, live only in a forward given a
    # dropout_seed (eval and generation stay deterministic)
    dropout: float = 0.0             # embeddings + residual branches
    attention_dropout: float = 0.0   # attention probabilities (plain path only)
    layerdrop: float = 0.0           # skip whole layers with prob p (OPT)
    dtype: str = "bfloat16"          # compute dtype
    attn_impl: str = "auto"          # auto | flash | xla (the plain attention)
    remat: bool = False
    remat_policy: str = "full"       # full | qkv (keep the attention's q/k/v/out)
    remat_layers: int = -1
    # the Pallas kernel's tile sizes: the CUDA kernels tile themselves, so
    # the port does not read these
    flash_block_q: int = 0
    flash_block_k: int = 0

    @property
    def compute_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.dtype]

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


# Architecture facts for the models named in the reference's configs/docs.
PRESETS: dict[str, dict] = {
    "facebook/opt-125m": dict(
        hidden_size=768, num_layers=12, num_heads=12, num_kv_heads=12,
        head_dim=64, intermediate_size=3072, vocab_size=50272,
        max_position_embeddings=2048, norm="layernorm", norm_bias=True,
        act="relu", pos="learned", learned_pos_offset=2,
        qkv_bias=True, attn_out_bias=True, mlp_bias=True,
        tie_word_embeddings=True, norm_eps=1e-5,
    ),
    "Qwen/Qwen2.5-0.5B": dict(
        hidden_size=896, num_layers=24, num_heads=14, num_kv_heads=2,
        head_dim=64, intermediate_size=4864, vocab_size=151936,
        max_position_embeddings=32768, norm="rmsnorm", act="silu_glu",
        pos="rope", rope_theta=1000000.0, qkv_bias=True,
        tie_word_embeddings=True, norm_eps=1e-6,
    ),
    "Qwen/Qwen2.5-1.5B": dict(
        hidden_size=1536, num_layers=28, num_heads=12, num_kv_heads=2,
        head_dim=128, intermediate_size=8960, vocab_size=151936,
        max_position_embeddings=32768, norm="rmsnorm", act="silu_glu",
        pos="rope", rope_theta=1000000.0, qkv_bias=True,
        tie_word_embeddings=True, norm_eps=1e-6,
    ),
    "Qwen/Qwen2.5-3B": dict(
        hidden_size=2048, num_layers=36, num_heads=16, num_kv_heads=2,
        head_dim=128, intermediate_size=11008, vocab_size=151936,
        max_position_embeddings=32768, norm="rmsnorm", act="silu_glu",
        pos="rope", rope_theta=1000000.0, qkv_bias=True,
        tie_word_embeddings=True, norm_eps=1e-6,
    ),
    "Qwen/Qwen2.5-7B": dict(
        hidden_size=3584, num_layers=28, num_heads=28, num_kv_heads=4,
        head_dim=128, intermediate_size=18944, vocab_size=152064,
        max_position_embeddings=131072, norm="rmsnorm", act="silu_glu",
        pos="rope", rope_theta=1000000.0, qkv_bias=True,
        tie_word_embeddings=False, norm_eps=1e-6,
    ),
    "meta-llama/Llama-3.2-3B": dict(
        hidden_size=3072, num_layers=28, num_heads=24, num_kv_heads=8,
        head_dim=128, intermediate_size=8192, vocab_size=128256,
        max_position_embeddings=131072, norm="rmsnorm", act="silu_glu",
        pos="rope", rope_theta=500000.0,
        tie_word_embeddings=True, norm_eps=1e-5,
    ),
    "meta-llama/Llama-3.2-1B": dict(
        hidden_size=2048, num_layers=16, num_heads=32, num_kv_heads=8,
        head_dim=64, intermediate_size=8192, vocab_size=128256,
        max_position_embeddings=131072, norm="rmsnorm", act="silu_glu",
        pos="rope", rope_theta=500000.0,
        tie_word_embeddings=True, norm_eps=1e-5,
    ),
    "EleutherAI/pythia-14m": dict(
        hidden_size=128, num_layers=6, num_heads=4, num_kv_heads=4,
        head_dim=32, intermediate_size=512, vocab_size=50304,
        max_position_embeddings=2048, norm="layernorm", norm_bias=True,
        act="gelu", pos="rope", rotary_pct=0.25, parallel_residual=True,
        qkv_bias=True, attn_out_bias=True, mlp_bias=True,
        tie_word_embeddings=False, norm_eps=1e-5,
    ),
    "EleutherAI/pythia-160m": dict(
        hidden_size=768, num_layers=12, num_heads=12, num_kv_heads=12,
        head_dim=64, intermediate_size=3072, vocab_size=50304,
        max_position_embeddings=2048, norm="layernorm", norm_bias=True,
        act="gelu", pos="rope", rotary_pct=0.25, parallel_residual=True,
        qkv_bias=True, attn_out_bias=True, mlp_bias=True,
        tie_word_embeddings=False, norm_eps=1e-5,
    ),
}

# HF config.json attribute names -> DecoderConfig field names
_HF_CONFIG_ALIASES = {
    "num_hidden_layers": "num_layers",
    "num_attention_heads": "num_heads",
    "num_key_value_heads": "num_kv_heads",
    "ffn_dim": "intermediate_size",
    "rms_norm_eps": "norm_eps",
    "layer_norm_eps": "norm_eps",
    "use_parallel_residual": "parallel_residual",
}


def translate_decoder_overrides(d: dict) -> dict:
    """Map user overrides (HF attribute names or DecoderConfig field names)
    onto DecoderConfig kwargs; unknown keys warn and drop."""
    fields = {f.name for f in dataclasses.fields(DecoderConfig)}
    out = {}
    for k, v in (d or {}).items():
        k2 = _HF_CONFIG_ALIASES.get(k, k)
        if k2 in fields:
            out[k2] = v
        else:
            logger.warning("Ignoring unknown decoder config override %r", k)
    return out


def config_from_hf_dict(hf: dict) -> dict:
    """Translate an HF config.json dict to DecoderConfig kwargs."""
    mt = hf.get("model_type")
    if mt == "opt":
        proj = hf.get("word_embed_proj_dim", hf["hidden_size"])
        return dict(
            embed_proj_dim=0 if proj == hf["hidden_size"] else proj,
            pre_norm=hf.get("do_layer_norm_before", True),
            hidden_size=hf["hidden_size"], num_layers=hf["num_hidden_layers"],
            num_heads=hf["num_attention_heads"], num_kv_heads=hf["num_attention_heads"],
            head_dim=hf["hidden_size"] // hf["num_attention_heads"],
            intermediate_size=hf["ffn_dim"], vocab_size=hf["vocab_size"],
            max_position_embeddings=hf["max_position_embeddings"],
            norm="layernorm", norm_bias=True, act="relu", pos="learned",
            learned_pos_offset=2, qkv_bias=True, attn_out_bias=True, mlp_bias=True,
            tie_word_embeddings=hf.get("tie_word_embeddings", True), norm_eps=1e-5,
        )
    if mt in ("qwen2", "qwen2_5"):
        heads = hf["num_attention_heads"]
        return dict(
            hidden_size=hf["hidden_size"], num_layers=hf["num_hidden_layers"],
            num_heads=heads, num_kv_heads=hf.get("num_key_value_heads", heads),
            head_dim=hf.get("head_dim") or hf["hidden_size"] // heads,
            intermediate_size=hf["intermediate_size"], vocab_size=hf["vocab_size"],
            max_position_embeddings=hf["max_position_embeddings"],
            norm="rmsnorm", act="silu_glu", pos="rope",
            rope_theta=hf.get("rope_theta", 1e6), qkv_bias=True,
            tie_word_embeddings=hf.get("tie_word_embeddings", True),
            norm_eps=hf.get("rms_norm_eps", 1e-6),
        )
    if mt == "llama":
        heads = hf["num_attention_heads"]
        return dict(
            hidden_size=hf["hidden_size"], num_layers=hf["num_hidden_layers"],
            num_heads=heads, num_kv_heads=hf.get("num_key_value_heads", heads),
            head_dim=hf.get("head_dim") or hf["hidden_size"] // heads,
            intermediate_size=hf["intermediate_size"], vocab_size=hf["vocab_size"],
            max_position_embeddings=hf["max_position_embeddings"],
            norm="rmsnorm", act="silu_glu", pos="rope",
            rope_theta=hf.get("rope_theta", 10000.0),
            qkv_bias=hf.get("attention_bias", False),
            tie_word_embeddings=hf.get("tie_word_embeddings", False),
            norm_eps=hf.get("rms_norm_eps", 1e-5),
        )
    if mt == "gpt_neox":
        heads = hf["num_attention_heads"]
        return dict(
            hidden_size=hf["hidden_size"], num_layers=hf["num_hidden_layers"],
            num_heads=heads, num_kv_heads=heads,
            head_dim=hf["hidden_size"] // heads,
            intermediate_size=hf["intermediate_size"], vocab_size=hf["vocab_size"],
            max_position_embeddings=hf["max_position_embeddings"],
            norm="layernorm", norm_bias=True, act="gelu", pos="rope",
            rotary_pct=hf.get("rotary_pct", 0.25),
            parallel_residual=hf.get("use_parallel_residual", True),
            qkv_bias=True, attn_out_bias=True, mlp_bias=True,
            tie_word_embeddings=hf.get("tie_word_embeddings", False),
            norm_eps=hf.get("layer_norm_eps", 1e-5),
        )
    raise ValueError(f"Unsupported HF model_type for the decoder: {mt!r}")


def resolve_base_config(base_model_name: str, **overrides) -> DecoderConfig:
    """base_model_name (preset key or local dir with an HF config.json)
    -> DecoderConfig, with explicit overrides (vocab_size, rope_theta, ...).

    Unlike the JAX package, an unknown hub id is not looked up through
    transformers: the card's host may not have it, and this path stays
    offline."""
    local_cfg = os.path.join(base_model_name, "config.json")
    if os.path.isfile(local_cfg):
        with open(local_cfg) as f:
            kwargs = config_from_hf_dict(json.load(f))
    elif base_model_name in PRESETS:
        kwargs = dict(PRESETS[base_model_name])
    else:
        raise ValueError(
            f"Unknown base model '{base_model_name}': not a preset "
            f"({sorted(PRESETS)}) and not a local dir with config.json")
    kwargs.update({k: v for k, v in overrides.items() if v is not None})
    return DecoderConfig(**kwargs)
