"""HF checkpoints <-> the port's flat parameters: the TWIST warm start, the
reference toolkit's checkpoints and the HF export.

Counterpart of `slamkit_tpu/models/hf_convert.py`: `load_hf_state_dict` (:29),
`convert_state_dict` (:67) for the qwen2 / llama, opt (with the 350m
`project_in` / `project_out` and post-LN variants) and gpt_neox families,
`resize_embeddings` (:183), `export_hf_state_dict` (:204),
`export_hf_checkpoint` (:275) and `load_twist_params` (:322). Parameters are
the flat `params.npz` dict of float32 numpy arrays that `models/convert.py`
loads (`embed`, `layers/q_w` stacked [L, ...], ...), so `convert_state_dict`
equals the JAX package's tree flattened, key for key and bit for bit.

Weights come from local files only, and neither `transformers` nor
`safetensors` is imported (the card's host may have neither): a directory of
`*.safetensors` (read by `utils/safetensors.py`) or `pytorch_model*.bin`, or a
hub name through a local HF cache (`$HF_HUB_CACHE`, else `$HF_HOME/hub`, else
`~/.cache/huggingface/hub`), read as `models--<org>--<name>/snapshots/<rev>/`.
Nothing is downloaded: where no weights are found, `load_twist_params` warns
and the model starts from random init, as the JAX package does offline.
"""
from __future__ import annotations

import glob
import json
import logging
import os
from typing import Dict, Optional

import numpy as np
import torch

from ..utils.safetensors import read_safetensors, write_safetensors
from .presets import DecoderConfig, resolve_base_config

logger = logging.getLogger(__name__)


def _hub_cache() -> str:
    if os.environ.get("HF_HUB_CACHE"):
        return os.environ["HF_HUB_CACHE"]
    home = os.environ.get("HF_HOME") or os.path.join(os.path.expanduser("~"), ".cache",
                                                     "huggingface")
    return os.path.join(home, "hub")


def _cached_snapshot(name: str) -> str:
    """The local HF cache's snapshot directory of hub model `name` (the one
    `refs/main` names, else the newest that holds weights)."""
    repo = os.path.join(_hub_cache(), "models--" + name.replace("/", "--"))
    snaps = os.path.join(repo, "snapshots")
    ref = os.path.join(repo, "refs", "main")
    if os.path.isfile(ref):
        with open(ref) as f:
            path = os.path.join(snaps, f.read().strip())
        if os.path.isdir(path):
            return path
    found = sorted(glob.glob(os.path.join(snaps, "*")), key=os.path.getmtime)
    found = [d for d in found if glob.glob(os.path.join(d, "*.safetensors"))
             or glob.glob(os.path.join(d, "pytorch_model*.bin"))]
    if not found:
        raise FileNotFoundError(f"{name!r} is neither a local directory nor in the local HF "
                                f"cache ({repo}); nothing is downloaded")
    return found[-1]


def load_hf_state_dict(name_or_path: str) -> Dict[str, np.ndarray]:
    """An HF checkpoint's tensors as numpy: a local directory's safetensors
    (preferred) or `pytorch_model*.bin` files, or a hub name's snapshot in
    the local HF cache."""
    path = name_or_path if os.path.isdir(name_or_path) else _cached_snapshot(name_or_path)
    st_files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if st_files:
        out = {}
        for f in st_files:
            out.update(read_safetensors(f))
        return out
    bin_files = sorted(glob.glob(os.path.join(path, "pytorch_model*.bin")))
    if bin_files:
        out = {}
        for f in bin_files:
            sd = torch.load(f, map_location="cpu", weights_only=True)
            out.update({k: v.float().numpy() for k, v in sd.items()})
        return out
    raise FileNotFoundError(f"No safetensors/bin weights under {path}")


def _f32(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32)


def _stack(sd, template: str, n_layers: int, transpose=False) -> np.ndarray:
    mats = []
    for i in range(n_layers):
        w = _f32(sd[template.format(i)])
        mats.append(w.T if transpose else w)
    return np.stack(mats)


def convert_state_dict(sd: Dict[str, np.ndarray], cfg: DecoderConfig) -> Dict[str, np.ndarray]:
    """Map an HF state dict to the flat parameters (`layers/<name>` stacked on
    a leading layer axis, [in, out] matrices)."""
    L = cfg.num_layers
    keys = set(sd.keys())

    def has(k):
        return k in keys

    if has("model.embed_tokens.weight"):          # qwen2 / llama
        pre = "model.layers.{}."
        layers = {
            "attn_norm_scale": _stack(sd, pre + "input_layernorm.weight", L),
            "q_w": _stack(sd, pre + "self_attn.q_proj.weight", L, transpose=True),
            "k_w": _stack(sd, pre + "self_attn.k_proj.weight", L, transpose=True),
            "v_w": _stack(sd, pre + "self_attn.v_proj.weight", L, transpose=True),
            "o_w": _stack(sd, pre + "self_attn.o_proj.weight", L, transpose=True),
            "mlp_norm_scale": _stack(sd, pre + "post_attention_layernorm.weight", L),
            "gate_w": _stack(sd, pre + "mlp.gate_proj.weight", L, transpose=True),
            "up_w": _stack(sd, pre + "mlp.up_proj.weight", L, transpose=True),
            "down_w": _stack(sd, pre + "mlp.down_proj.weight", L, transpose=True),
        }
        if cfg.qkv_bias:
            layers["q_b"] = _stack(sd, pre + "self_attn.q_proj.bias", L)
            layers["k_b"] = _stack(sd, pre + "self_attn.k_proj.bias", L)
            layers["v_b"] = _stack(sd, pre + "self_attn.v_proj.bias", L)
        params = {"embed": _f32(sd["model.embed_tokens.weight"]),
                  "final_norm_scale": _f32(sd["model.norm.weight"])}
        if not cfg.tie_word_embeddings:
            params["lm_head"] = _f32(sd["lm_head.weight"]).T
        return _flat(params, layers)

    if has("model.decoder.embed_tokens.weight"):  # opt
        pre = "model.decoder.layers.{}."
        layers = {
            "attn_norm_scale": _stack(sd, pre + "self_attn_layer_norm.weight", L),
            "attn_norm_bias": _stack(sd, pre + "self_attn_layer_norm.bias", L),
            "q_w": _stack(sd, pre + "self_attn.q_proj.weight", L, transpose=True),
            "q_b": _stack(sd, pre + "self_attn.q_proj.bias", L),
            "k_w": _stack(sd, pre + "self_attn.k_proj.weight", L, transpose=True),
            "k_b": _stack(sd, pre + "self_attn.k_proj.bias", L),
            "v_w": _stack(sd, pre + "self_attn.v_proj.weight", L, transpose=True),
            "v_b": _stack(sd, pre + "self_attn.v_proj.bias", L),
            "o_w": _stack(sd, pre + "self_attn.out_proj.weight", L, transpose=True),
            "o_b": _stack(sd, pre + "self_attn.out_proj.bias", L),
            "mlp_norm_scale": _stack(sd, pre + "final_layer_norm.weight", L),
            "mlp_norm_bias": _stack(sd, pre + "final_layer_norm.bias", L),
            "up_w": _stack(sd, pre + "fc1.weight", L, transpose=True),
            "up_b": _stack(sd, pre + "fc1.bias", L),
            "down_w": _stack(sd, pre + "fc2.weight", L, transpose=True),
            "down_b": _stack(sd, pre + "fc2.bias", L),
        }
        params = {"embed": _f32(sd["model.decoder.embed_tokens.weight"]),
                  "pos_embed": _f32(sd["model.decoder.embed_positions.weight"])}
        if has("model.decoder.final_layer_norm.weight"):  # pre-norm OPTs only
            params["final_norm_scale"] = _f32(sd["model.decoder.final_layer_norm.weight"])
            params["final_norm_bias"] = _f32(sd["model.decoder.final_layer_norm.bias"])
        if has("model.decoder.project_in.weight"):        # opt-350m family
            params["proj_in_w"] = _f32(sd["model.decoder.project_in.weight"]).T
            params["proj_out_w"] = _f32(sd["model.decoder.project_out.weight"]).T
        if not cfg.tie_word_embeddings:
            params["lm_head"] = _f32(sd["lm_head.weight"]).T
        return _flat(params, layers)

    if has("gpt_neox.embed_in.weight"):           # pythia / gpt_neox
        pre = "gpt_neox.layers.{}."
        H, Dh, D = cfg.num_heads, cfg.head_dim, cfg.hidden_size

        def split_qkv(i, part, bias=False):
            w = _f32(sd[pre.format(i) + f"attention.query_key_value.{'bias' if bias else 'weight'}"])
            idx = {"q": 0, "k": 1, "v": 2}[part]
            if bias:
                return w.reshape(H, 3, Dh)[:, idx].reshape(H * Dh)
            return w.reshape(H, 3, Dh, D)[:, idx].reshape(H * Dh, D).T

        layers = {
            "attn_norm_scale": _stack(sd, pre + "input_layernorm.weight", L),
            "attn_norm_bias": _stack(sd, pre + "input_layernorm.bias", L),
            "o_w": _stack(sd, pre + "attention.dense.weight", L, transpose=True),
            "o_b": _stack(sd, pre + "attention.dense.bias", L),
            "mlp_norm_scale": _stack(sd, pre + "post_attention_layernorm.weight", L),
            "mlp_norm_bias": _stack(sd, pre + "post_attention_layernorm.bias", L),
            "up_w": _stack(sd, pre + "mlp.dense_h_to_4h.weight", L, transpose=True),
            "up_b": _stack(sd, pre + "mlp.dense_h_to_4h.bias", L),
            "down_w": _stack(sd, pre + "mlp.dense_4h_to_h.weight", L, transpose=True),
            "down_b": _stack(sd, pre + "mlp.dense_4h_to_h.bias", L),
        }
        for part in ("q", "k", "v"):
            layers[f"{part}_w"] = np.stack([split_qkv(i, part) for i in range(L)])
            layers[f"{part}_b"] = np.stack([split_qkv(i, part, True) for i in range(L)])
        params = {"embed": _f32(sd["gpt_neox.embed_in.weight"]),
                  "final_norm_scale": _f32(sd["gpt_neox.final_layer_norm.weight"]),
                  "final_norm_bias": _f32(sd["gpt_neox.final_layer_norm.bias"])}
        if not cfg.tie_word_embeddings:
            params["lm_head"] = _f32(sd["embed_out.weight"]).T
        return _flat(params, layers)

    raise ValueError(f"Unrecognised HF state dict (sample keys: {sorted(keys)[:5]})")


def _flat(params: dict, layers: dict) -> Dict[str, np.ndarray]:
    out = {k: np.ascontiguousarray(v) for k, v in params.items()}
    out.update({f"layers/{k}": np.ascontiguousarray(v) for k, v in layers.items()})
    return out


def resize_embeddings(params: Dict[str, np.ndarray], cfg: DecoderConfig, new_vocab: int,
                      seed: int = 0) -> Dict[str, np.ndarray]:
    """TWIST's resize_token_embeddings: the first min(old, new) rows are kept
    as they are; new rows are the old embedding's mean plus N(0, 1) x
    initializer_range noise, drawn from a `torch.Generator` seeded with
    `seed` (the JAX package draws them from `jax.random`)."""
    old = params["embed"]
    if old.shape[0] == new_vocab:
        return params
    gen = torch.Generator().manual_seed(seed)
    noise = lambda *shape: torch.randn(shape, generator=gen, dtype=torch.float32).numpy()
    mean = old.mean(axis=0)
    n_keep = min(old.shape[0], new_vocab)
    params = dict(params)
    embed = mean + noise(new_vocab, old.shape[1]) * cfg.initializer_range
    embed[:n_keep] = old[:n_keep]
    params["embed"] = embed.astype(np.float32)
    if "lm_head" in params:
        head = params["lm_head"]  # [D, V]
        fresh = mean[:, None] + noise(head.shape[0], new_vocab) * cfg.initializer_range
        fresh[:, :n_keep] = head[:, :n_keep]
        params["lm_head"] = fresh.astype(np.float32)
    return params


def export_hf_state_dict(params: Dict[str, np.ndarray], cfg: DecoderConfig
                         ) -> Dict[str, np.ndarray]:
    """Reverse conversion: flat parameters -> HF state dict, for the qwen2 /
    llama and OPT layouts."""
    out: Dict[str, np.ndarray] = {}

    def put(key, arr, transpose=False):
        a = _f32(arr)
        # MUST be contiguous: a writer that serialises the raw buffer of a
        # transposed view under the transposed shape corrupts the data
        out[key] = np.ascontiguousarray(a.T if transpose else a)

    layer = lambda name, i: params[f"layers/{name}"][i]
    if cfg.pos == "rope" and not cfg.parallel_residual:   # qwen2 / llama
        pre = "model.layers.{}."
        for i in range(cfg.num_layers):
            put(pre.format(i) + "input_layernorm.weight", layer("attn_norm_scale", i))
            put(pre.format(i) + "self_attn.q_proj.weight", layer("q_w", i), transpose=True)
            put(pre.format(i) + "self_attn.k_proj.weight", layer("k_w", i), transpose=True)
            put(pre.format(i) + "self_attn.v_proj.weight", layer("v_w", i), transpose=True)
            put(pre.format(i) + "self_attn.o_proj.weight", layer("o_w", i), transpose=True)
            put(pre.format(i) + "post_attention_layernorm.weight", layer("mlp_norm_scale", i))
            put(pre.format(i) + "mlp.gate_proj.weight", layer("gate_w", i), transpose=True)
            put(pre.format(i) + "mlp.up_proj.weight", layer("up_w", i), transpose=True)
            put(pre.format(i) + "mlp.down_proj.weight", layer("down_w", i), transpose=True)
            if cfg.qkv_bias:
                put(pre.format(i) + "self_attn.q_proj.bias", layer("q_b", i))
                put(pre.format(i) + "self_attn.k_proj.bias", layer("k_b", i))
                put(pre.format(i) + "self_attn.v_proj.bias", layer("v_b", i))
        put("model.embed_tokens.weight", params["embed"])
        put("model.norm.weight", params["final_norm_scale"])
        if cfg.tie_word_embeddings:
            put("lm_head.weight", params["embed"])
        else:
            put("lm_head.weight", params["lm_head"], transpose=True)
        return out

    if cfg.pos == "learned":                               # opt
        pre = "model.decoder.layers.{}."
        for i in range(cfg.num_layers):
            put(pre.format(i) + "self_attn_layer_norm.weight", layer("attn_norm_scale", i))
            put(pre.format(i) + "self_attn_layer_norm.bias", layer("attn_norm_bias", i))
            for ours, theirs in (("q", "q_proj"), ("k", "k_proj"),
                                 ("v", "v_proj"), ("o", "out_proj")):
                put(pre.format(i) + f"self_attn.{theirs}.weight", layer(f"{ours}_w", i),
                    transpose=True)
                put(pre.format(i) + f"self_attn.{theirs}.bias", layer(f"{ours}_b", i))
            put(pre.format(i) + "final_layer_norm.weight", layer("mlp_norm_scale", i))
            put(pre.format(i) + "final_layer_norm.bias", layer("mlp_norm_bias", i))
            put(pre.format(i) + "fc1.weight", layer("up_w", i), transpose=True)
            put(pre.format(i) + "fc1.bias", layer("up_b", i))
            put(pre.format(i) + "fc2.weight", layer("down_w", i), transpose=True)
            put(pre.format(i) + "fc2.bias", layer("down_b", i))
        put("model.decoder.embed_tokens.weight", params["embed"])
        put("model.decoder.embed_positions.weight", params["pos_embed"])
        if cfg.pre_norm:  # post-LN OPTs (opt-350m) have no top-level norm
            put("model.decoder.final_layer_norm.weight", params["final_norm_scale"])
            put("model.decoder.final_layer_norm.bias", params["final_norm_bias"])
        if cfg.embed_proj_dim:
            put("model.decoder.project_in.weight", params["proj_in_w"], transpose=True)
            put("model.decoder.project_out.weight", params["proj_out_w"], transpose=True)
        if cfg.tie_word_embeddings:
            put("lm_head.weight", params["embed"])
        else:
            put("lm_head.weight", params["lm_head"], transpose=True)
        return out

    raise ValueError(f"HF export not implemented for this architecture: "
                     f"pos={cfg.pos} parallel_residual={cfg.parallel_residual}")


def export_hf_checkpoint(params: Dict[str, np.ndarray], cfg: DecoderConfig,
                         base_model_name: str, save_directory: str):
    """Write an HF-loadable checkpoint directory (config.json +
    model.safetensors), so parity evals can run the model under
    transformers."""
    os.makedirs(save_directory, exist_ok=True)
    write_safetensors(os.path.join(save_directory, "model.safetensors"),
                      export_hf_state_dict(params, cfg), metadata={"format": "pt"})
    if cfg.pos == "learned":
        hf_cfg = {
            "model_type": "opt", "architectures": ["OPTForCausalLM"],
            "hidden_size": cfg.hidden_size, "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_heads, "ffn_dim": cfg.intermediate_size,
            "vocab_size": cfg.vocab_size,
            "word_embed_proj_dim": cfg.embed_proj_dim or cfg.hidden_size,
            "max_position_embeddings": cfg.max_position_embeddings - 0,
            "do_layer_norm_before": cfg.pre_norm, "activation_function": "relu",
            "tie_word_embeddings": cfg.tie_word_embeddings,
            "pad_token_id": 0, "bos_token_id": 1, "eos_token_id": 1,
            "torch_dtype": "float32",
        }
    else:
        mt = "qwen2" if cfg.qkv_bias else "llama"
        hf_cfg = {
            "model_type": mt,
            "architectures": ["Qwen2ForCausalLM" if mt == "qwen2" else "LlamaForCausalLM"],
            "hidden_size": cfg.hidden_size, "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_heads,
            "num_key_value_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
            "intermediate_size": cfg.intermediate_size, "vocab_size": cfg.vocab_size,
            "max_position_embeddings": cfg.max_position_embeddings,
            "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.norm_eps,
            "hidden_act": "silu", "tie_word_embeddings": cfg.tie_word_embeddings,
            "attention_bias": cfg.qkv_bias,
            "pad_token_id": 0, "bos_token_id": 1, "eos_token_id": 1,
            "torch_dtype": "float32",
        }
    with open(os.path.join(save_directory, "config.json"), "w") as f:
        json.dump(hf_cfg, f, indent=2)
    logger.info("Exported HF checkpoint (%s) to %s (base %s)", hf_cfg["model_type"],
                save_directory, base_model_name)


def load_twist_params(config, decoder_cfg: DecoderConfig, seed: int = 0
                      ) -> Optional[Dict[str, np.ndarray]]:
    """The TWIST warm start: the base LM's weights, converted and resized to
    the unit vocabulary. Returns None, after a warning, where the model must
    start from random init instead: the decoder overrides change the base's
    attention layout (its trained projections would be reinterpreted across
    head boundaries), or its weights are not on this machine. Weights that
    are found but do not convert raise."""
    source = resolve_base_config(config.base_model_name, vocab_size=decoder_cfg.vocab_size)
    layout = ("num_heads", "num_kv_heads", "head_dim", "hidden_size",
              "num_layers", "intermediate_size")
    diffs = [k for k in layout if getattr(source, k) != getattr(decoder_cfg, k)]
    if diffs:
        logger.warning(
            "TWIST init requested but the decoder overrides change the "
            "architecture of %s (%s differ) — pretrained weights would be "
            "reinterpreted across head boundaries; using random init",
            config.base_model_name, ", ".join(diffs))
        return None
    try:
        sd = load_hf_state_dict(config.base_model_name)
    except FileNotFoundError as e:
        logger.warning(
            "TWIST init requested but base weights for %s unavailable (%s); "
            "falling back to random init", config.base_model_name, e)
        return None
    # convert against the original vocabulary, then resize to the unit one
    params = convert_state_dict(sd, decoder_cfg)
    return resize_embeddings(params, decoder_cfg, decoder_cfg.vocab_size, seed=seed)
