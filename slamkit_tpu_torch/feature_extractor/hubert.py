"""HuBERT encoder (conv front end + transformer) with a layer tap, in float32.

Counterpart of `slamkit_tpu/feature_extractor/hubert_jax.py`: `HubertConfig`
(:30), the conv front end with group or layer norm (:79), the weight-normed
positional conv with its even-kernel trim (:99), post-norm and stable-norm
encoder blocks (:109) and `forward` with `tap_layer` (:144), whose tap k is
the activation after k encoder blocks (HF's `hidden_states[k]`); only
`tap_layer` blocks run. The weights are the JAX package's params tree with
torch tensors (layers stacked on a leading axis), so `utils.tree.to_torch` of
its numpy params is the conversion. Attention is plain matmul and softmax, as
in JAX (no Pallas kernel there).

Loaders read local files only and never import transformers:
`convert_hf_state_dict` (:181) maps an HF `HubertModel` state dict, read from
a local directory (`config.json` + `pytorch_model.bin` or
`model.safetensors`); `config_from_fairseq` / `convert_fairseq_state`
(:281-364) map a fairseq / textless `.pt` read with `torch.load`.
`save_hf_dir` writes a params tree as such a directory (its weights random
where the checkpoint is not at hand).
"""
from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import DEFAULT_DEVICE, resolve_device
from ..utils.safetensors import read_safetensors, write_safetensors
from ..utils.tree import to_torch


@dataclasses.dataclass(frozen=True)
class HubertConfig:
    conv_dim: Tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = False
    feat_extract_norm: str = "group"      # group | layer
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    do_stable_layer_norm: bool = False
    feat_proj_layer_norm: bool = True
    layer_norm_eps: float = 1e-5

    @classmethod
    def from_hf_dict(cls, d: dict) -> "HubertConfig":
        keep = {f.name for f in dataclasses.fields(cls)}
        vals = {k: (tuple(v) if isinstance(v, list) else v)
                for k, v in d.items() if k in keep}
        return cls(**vals)

    @property
    def total_stride(self) -> int:
        out = 1
        for s in self.conv_stride:
            out *= s
        return out


def _layer_norm(x, scale, bias, eps):
    return F.layer_norm(x, (x.shape[-1],), scale, bias, eps)


def conv_frontend(params: dict, cfg: HubertConfig, wav: torch.Tensor) -> torch.Tensor:
    """Raw wav [B, T] -> features [B, T', conv_dim[-1]] (HF HubertFeatureEncoder)."""
    x = wav[:, None, :].float()
    for i in range(len(cfg.conv_dim)):
        lp = params["conv_layers"][i]
        x = F.conv1d(x, lp["conv_w"], lp.get("conv_b"), stride=cfg.conv_stride[i])
        if i == 0 and cfg.feat_extract_norm == "group":
            # GroupNorm(groups == channels): per-channel norm over time
            x = F.group_norm(x, x.shape[1], lp["norm_scale"], lp["norm_bias"],
                             cfg.layer_norm_eps)
        elif cfg.feat_extract_norm == "layer":
            x = _layer_norm(x.transpose(1, 2), lp["norm_scale"], lp["norm_bias"],
                            cfg.layer_norm_eps).transpose(1, 2)
        x = F.gelu(x)
    return x.transpose(1, 2)


def _pos_conv(params, cfg: HubertConfig, x):
    """HubertPositionalConvEmbedding: grouped conv + same-pad trim + gelu."""
    h = F.conv1d(x.transpose(1, 2), params["pos_conv_w"], params["pos_conv_b"],
                 padding=cfg.num_conv_pos_embeddings // 2,
                 groups=cfg.num_conv_pos_embedding_groups)
    if cfg.num_conv_pos_embeddings % 2 == 0:
        h = h[:, :, :-1]
    return F.gelu(h).transpose(1, 2)


def _encoder_block(x, lp: dict, cfg: HubertConfig, stable: bool):
    """One HubertEncoderLayer (post-norm) or StableLayerNorm (pre-norm)."""
    H, Dh = cfg.num_attention_heads, cfg.hidden_size // cfg.num_attention_heads
    B, T, D = x.shape
    eps = cfg.layer_norm_eps

    def attn(h):
        heads = lambda t: t.reshape(B, T, H, Dh).transpose(1, 2)
        q = heads((h @ lp["q_w"].T + lp["q_b"]) * Dh ** -0.5)
        k = heads(h @ lp["k_w"].T + lp["k_b"])
        v = heads(h @ lp["v_w"].T + lp["v_b"])
        probs = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
        out = (probs @ v).transpose(1, 2).reshape(B, T, D)
        return out @ lp["o_w"].T + lp["o_b"]

    def ff(h):
        h = F.gelu(h @ lp["ff_in_w"].T + lp["ff_in_b"])
        return h @ lp["ff_out_w"].T + lp["ff_out_b"]

    if stable:
        x = x + attn(_layer_norm(x, lp["ln1_scale"], lp["ln1_bias"], eps))
        return x + ff(_layer_norm(x, lp["ln2_scale"], lp["ln2_bias"], eps))
    x = _layer_norm(x + attn(x), lp["ln1_scale"], lp["ln1_bias"], eps)
    return _layer_norm(x + ff(x), lp["ln2_scale"], lp["ln2_bias"], eps)


def forward(params: dict, cfg: HubertConfig, wav: torch.Tensor,
            tap_layer: Optional[int] = None) -> torch.Tensor:
    """wav [B, T] -> hidden_states[tap_layer] [B, T', hidden] (float32);
    None = all layers and the final output (incl. the stable variant's
    final layer norm)."""
    feats = conv_frontend(params, cfg, wav)
    if cfg.feat_proj_layer_norm:
        feats = _layer_norm(feats, params["fp_norm_scale"], params["fp_norm_bias"],
                            cfg.layer_norm_eps)
    x = feats @ params["fp_proj_w"].T + params["fp_proj_b"]
    x = x + _pos_conv(params, cfg, x)
    stable = cfg.do_stable_layer_norm
    if not stable:
        x = _layer_norm(x, params["enc_norm_scale"], params["enc_norm_bias"],
                        cfg.layer_norm_eps)
    n = cfg.num_hidden_layers if tap_layer is None else tap_layer
    layers = params["layers"]
    for i in range(n):
        x = _encoder_block(x, {k: v[i] for k, v in layers.items()}, cfg, stable)
    if stable and (tap_layer is None or tap_layer == cfg.num_hidden_layers):
        x = _layer_norm(x, params["enc_norm_scale"], params["enc_norm_bias"],
                        cfg.layer_norm_eps)
    return x


def random_params(cfg: HubertConfig, seed: int = 0) -> dict:
    """A seeded params tree (numpy float32) of `cfg`'s shapes: matrices and
    convolutions from N(0, 1 / fan_in), norm scales 1, biases 0. For runs
    at the published widths where the checkpoint is not at hand."""
    rng = np.random.default_rng(seed)

    def w(*shape):
        fan_in = int(np.prod(shape[1:]))
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)

    ones = lambda *s: np.ones(s, np.float32)
    zeros = lambda *s: np.zeros(s, np.float32)
    conv_layers, c_in = [], 1
    for i, (c, k) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel)):
        lp = {"conv_w": w(c, c_in, k)}
        if cfg.conv_bias:
            lp["conv_b"] = zeros(c)
        if (i == 0 and cfg.feat_extract_norm == "group") or cfg.feat_extract_norm == "layer":
            lp["norm_scale"], lp["norm_bias"] = ones(c), zeros(c)
        conv_layers.append(lp)
        c_in = c
    D, L, Fi = cfg.hidden_size, cfg.num_hidden_layers, cfg.intermediate_size
    stack = lambda f: np.stack([f() for _ in range(L)])
    params = {
        "conv_layers": conv_layers,
        "fp_proj_w": w(D, c_in), "fp_proj_b": zeros(D),
        "pos_conv_w": w(D, D // cfg.num_conv_pos_embedding_groups,
                        cfg.num_conv_pos_embeddings),
        "pos_conv_b": zeros(D),
        "enc_norm_scale": ones(D), "enc_norm_bias": zeros(D),
        "layers": {
            **{f"{p}_w": stack(lambda: w(D, D)) for p in ("q", "k", "v", "o")},
            **{f"{p}_b": stack(lambda: zeros(D)) for p in ("q", "k", "v", "o")},
            "ln1_scale": stack(lambda: ones(D)), "ln1_bias": stack(lambda: zeros(D)),
            "ff_in_w": stack(lambda: w(Fi, D)), "ff_in_b": stack(lambda: zeros(Fi)),
            "ff_out_w": stack(lambda: w(D, Fi)), "ff_out_b": stack(lambda: zeros(D)),
            "ln2_scale": stack(lambda: ones(D)), "ln2_bias": stack(lambda: zeros(D)),
        },
    }
    if cfg.feat_proj_layer_norm:
        params["fp_norm_scale"], params["fp_norm_bias"] = ones(c_in), zeros(c_in)
    return params


# --------------------------------------------------------------------------- #
# weight conversion (HF HubertModel state dict -> params tree)
# --------------------------------------------------------------------------- #
def convert_hf_state_dict(sd: dict, cfg: HubertConfig) -> dict:
    """Map an HF HubertModel state dict (numpy-valued) to the params tree
    (numpy). Weight norm on the positional conv is folded (inference only)."""

    def get(k):
        return np.asarray(sd[k], dtype=np.float32)

    conv_layers = []
    for i in range(len(cfg.conv_dim)):
        lp = {"conv_w": get(f"feature_extractor.conv_layers.{i}.conv.weight")}
        if cfg.conv_bias:
            lp["conv_b"] = get(f"feature_extractor.conv_layers.{i}.conv.bias")
        if (i == 0 and cfg.feat_extract_norm == "group") or cfg.feat_extract_norm == "layer":
            lp["norm_scale"] = get(f"feature_extractor.conv_layers.{i}.layer_norm.weight")
            lp["norm_bias"] = get(f"feature_extractor.conv_layers.{i}.layer_norm.bias")
        conv_layers.append(lp)

    # fold weight norm: w = g * v / ||v|| over dims (0, 1), per kernel position
    if "encoder.pos_conv_embed.conv.parametrizations.weight.original0" in sd:
        g = get("encoder.pos_conv_embed.conv.parametrizations.weight.original0")
        v = get("encoder.pos_conv_embed.conv.parametrizations.weight.original1")
    else:
        g = get("encoder.pos_conv_embed.conv.weight_g")
        v = get("encoder.pos_conv_embed.conv.weight_v")
    norm = np.sqrt((v ** 2).sum(axis=(0, 1), keepdims=True))
    pos_conv_w = g * v / np.maximum(norm, 1e-12)

    def stack(fmt):
        return np.stack([get(fmt.format(i=i)) for i in range(cfg.num_hidden_layers)])

    pre = "encoder.layers.{i}."
    layers = {
        "q_w": stack(pre + "attention.q_proj.weight"),
        "q_b": stack(pre + "attention.q_proj.bias"),
        "k_w": stack(pre + "attention.k_proj.weight"),
        "k_b": stack(pre + "attention.k_proj.bias"),
        "v_w": stack(pre + "attention.v_proj.weight"),
        "v_b": stack(pre + "attention.v_proj.bias"),
        "o_w": stack(pre + "attention.out_proj.weight"),
        "o_b": stack(pre + "attention.out_proj.bias"),
        "ln1_scale": stack(pre + "layer_norm.weight"),
        "ln1_bias": stack(pre + "layer_norm.bias"),
        "ff_in_w": stack(pre + "feed_forward.intermediate_dense.weight"),
        "ff_in_b": stack(pre + "feed_forward.intermediate_dense.bias"),
        "ff_out_w": stack(pre + "feed_forward.output_dense.weight"),
        "ff_out_b": stack(pre + "feed_forward.output_dense.bias"),
        "ln2_scale": stack(pre + "final_layer_norm.weight"),
        "ln2_bias": stack(pre + "final_layer_norm.bias"),
    }
    params = {
        "conv_layers": conv_layers,
        "fp_proj_w": get("feature_projection.projection.weight"),
        "fp_proj_b": get("feature_projection.projection.bias"),
        "pos_conv_w": pos_conv_w,
        "pos_conv_b": get("encoder.pos_conv_embed.conv.bias"),
        "enc_norm_scale": get("encoder.layer_norm.weight"),
        "enc_norm_bias": get("encoder.layer_norm.bias"),
        "layers": layers,
    }
    if cfg.feat_proj_layer_norm:
        params["fp_norm_scale"] = get("feature_projection.layer_norm.weight")
        params["fp_norm_bias"] = get("feature_projection.layer_norm.bias")
    return params


def hf_state_dict(params: dict, cfg: HubertConfig) -> dict:
    """The inverse of `convert_hf_state_dict`: a params tree as an HF
    HubertModel state dict (numpy), the positional conv as weight norm with
    g = ||w|| over dims (0, 1) and v = w, which folds back to w."""
    f32 = lambda a: np.ascontiguousarray(np.asarray(a, dtype=np.float32))
    sd = {}
    for i, lp in enumerate(params["conv_layers"]):
        sd[f"feature_extractor.conv_layers.{i}.conv.weight"] = f32(lp["conv_w"])
        if "conv_b" in lp:
            sd[f"feature_extractor.conv_layers.{i}.conv.bias"] = f32(lp["conv_b"])
        if "norm_scale" in lp:
            sd[f"feature_extractor.conv_layers.{i}.layer_norm.weight"] = f32(lp["norm_scale"])
            sd[f"feature_extractor.conv_layers.{i}.layer_norm.bias"] = f32(lp["norm_bias"])
    w = f32(params["pos_conv_w"])
    sd["encoder.pos_conv_embed.conv.weight_g"] = np.sqrt((w ** 2).sum(axis=(0, 1), keepdims=True))
    sd["encoder.pos_conv_embed.conv.weight_v"] = w
    sd["encoder.pos_conv_embed.conv.bias"] = f32(params["pos_conv_b"])
    names = {"q_w": "attention.q_proj.weight", "q_b": "attention.q_proj.bias",
             "k_w": "attention.k_proj.weight", "k_b": "attention.k_proj.bias",
             "v_w": "attention.v_proj.weight", "v_b": "attention.v_proj.bias",
             "o_w": "attention.out_proj.weight", "o_b": "attention.out_proj.bias",
             "ln1_scale": "layer_norm.weight", "ln1_bias": "layer_norm.bias",
             "ff_in_w": "feed_forward.intermediate_dense.weight",
             "ff_in_b": "feed_forward.intermediate_dense.bias",
             "ff_out_w": "feed_forward.output_dense.weight",
             "ff_out_b": "feed_forward.output_dense.bias",
             "ln2_scale": "final_layer_norm.weight", "ln2_bias": "final_layer_norm.bias"}
    for key, hf in names.items():
        for i in range(cfg.num_hidden_layers):
            sd[f"encoder.layers.{i}.{hf}"] = f32(params["layers"][key][i])
    sd["feature_projection.projection.weight"] = f32(params["fp_proj_w"])
    sd["feature_projection.projection.bias"] = f32(params["fp_proj_b"])
    sd["encoder.layer_norm.weight"] = f32(params["enc_norm_scale"])
    sd["encoder.layer_norm.bias"] = f32(params["enc_norm_bias"])
    if cfg.feat_proj_layer_norm:
        sd["feature_projection.layer_norm.weight"] = f32(params["fp_norm_scale"])
        sd["feature_projection.layer_norm.bias"] = f32(params["fp_norm_bias"])
    return sd


def save_hf_dir(path: str, params: dict, cfg: HubertConfig):
    """Write a params tree as a local HF HubertModel directory (config.json
    + model.safetensors), which `load_hf_dir` and transformers both read."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({**dataclasses.asdict(cfg), "model_type": "hubert",
                   "architectures": ["HubertModel"]}, f, indent=2)
    write_safetensors(os.path.join(path, "model.safetensors"), hf_state_dict(params, cfg),
                      metadata={"format": "pt"})


def _strip_prefix(sd: dict) -> dict:
    """HubertModel keys, whether saved bare or under a `hubert.` head model."""
    return {k[len("hubert."):] if k.startswith("hubert.") else k: v for k, v in sd.items()}


def load_hf_dir(path: str):
    """A local HF HubertModel directory -> (params tree (numpy), HubertConfig)."""
    with open(os.path.join(path, "config.json")) as f:
        cfg = HubertConfig.from_hf_dict(json.load(f))
    st = os.path.join(path, "model.safetensors")
    if os.path.isfile(st):
        sd = read_safetensors(st)
    else:
        bin_path = os.path.join(path, "pytorch_model.bin")
        if not os.path.isfile(bin_path):
            raise FileNotFoundError(f"no model.safetensors or pytorch_model.bin in {path}")
        sd = {k: v.float().numpy() for k, v in
              torch.load(bin_path, map_location="cpu", weights_only=True).items()}
    return convert_hf_state_dict(_strip_prefix(sd), cfg), cfg


# --------------------------------------------------------------------------- #
# fairseq / textless checkpoint layout (.pt with {"model": sd, "cfg"|"args"})
# --------------------------------------------------------------------------- #
def _parse_conv_feature_layers(spec):
    """fairseq's conv stack string, '[(512,10,5)] + [(512,3,2)] * 4 + ...',
    parsed without eval: literal lists joined by '+', optionally '* n'."""
    if isinstance(spec, (list, tuple)):
        return [tuple(x) for x in spec]
    layers = []
    for term in str(spec).split("+"):
        term, reps = term.strip(), 1
        if "*" in term:
            term, n = term.rsplit("*", 1)
            term, reps = term.strip(), int(n.strip())
        layers.extend([tuple(t) for t in ast.literal_eval(term)] * reps)
    return layers


def config_from_fairseq(model_cfg: dict) -> HubertConfig:
    """fairseq HubertConfig field names -> ours (extractor_mode 'default' =
    group norm on block 0, 'layer_norm' = per-block layer norm;
    layer_norm_first = stable layer norm)."""
    triples = _parse_conv_feature_layers(model_cfg.get(
        "conv_feature_layers", "[(512,10,5)] + [(512,3,2)] * 4 + [(512,2,2)] * 2"))
    dims, kernels, strides = (tuple(t) for t in zip(*triples))
    mode = str(model_cfg.get("extractor_mode", "default"))
    return HubertConfig(
        conv_dim=dims, conv_kernel=kernels, conv_stride=strides,
        conv_bias=bool(model_cfg.get("conv_bias", False)),
        feat_extract_norm="layer" if mode == "layer_norm" else "group",
        hidden_size=int(model_cfg.get("encoder_embed_dim", 768)),
        num_hidden_layers=int(model_cfg.get("encoder_layers", 12)),
        num_attention_heads=int(model_cfg.get("encoder_attention_heads", 12)),
        intermediate_size=int(model_cfg.get("encoder_ffn_embed_dim", 3072)),
        num_conv_pos_embeddings=int(model_cfg.get("conv_pos", 128)),
        num_conv_pos_embedding_groups=int(model_cfg.get("conv_pos_groups", 16)),
        do_stable_layer_norm=bool(model_cfg.get("layer_norm_first", False)),
    )


def _fairseq_key_to_hf(key: str) -> Optional[str]:
    """One fairseq HubertModel key in HF layout; None = a pretraining-only
    weight (mask embedding, target codebook, final projection)."""
    if key in ("mask_emb", "label_embs_concat") or key.startswith("final_proj"):
        return None
    if key.startswith("layer_norm."):             # pre-projection norm
        return "feature_projection." + key
    if key.startswith("post_extract_proj."):
        return key.replace("post_extract_proj.", "feature_projection.projection.")
    if key.startswith("encoder.pos_conv.0."):
        return key.replace("encoder.pos_conv.0.", "encoder.pos_conv_embed.conv.")
    m = re.fullmatch(r"feature_extractor\.conv_layers\.(\d+)\.(.+)", key)
    if m:
        i, rest = m.groups()
        if rest in ("0.weight", "0.bias"):
            return f"feature_extractor.conv_layers.{i}.conv.{rest[2:]}"
        if rest in ("2.weight", "2.bias", "2.1.weight", "2.1.bias"):
            return f"feature_extractor.conv_layers.{i}.layer_norm." + rest.rsplit(".", 1)[-1]
        return None
    if key.startswith("encoder.layers."):
        return (key.replace(".self_attn_layer_norm.", ".layer_norm.")
                .replace(".self_attn.", ".attention.")
                .replace(".fc1.", ".feed_forward.intermediate_dense.")
                .replace(".fc2.", ".feed_forward.output_dense."))
    if key.startswith("encoder.layer_norm."):
        return key
    return None


def fairseq_model_cfg(state: dict) -> dict:
    """The model-config dict of a fairseq checkpoint: new-style
    {'cfg': {'model': ...}} or old-style {'args': Namespace-or-dict}."""
    meta = state.get("cfg")
    if meta is not None:
        model_cfg = meta["model"] if isinstance(meta, dict) else meta.model
    else:
        args = state.get("args", {})
        model_cfg = args if isinstance(args, dict) else vars(args)
    return model_cfg if isinstance(model_cfg, dict) else dict(model_cfg)


def convert_fairseq_state(state: dict):
    """fairseq / textless checkpoint dict -> (params tree (numpy), HubertConfig)."""
    cfg = config_from_fairseq(fairseq_model_cfg(state))
    sd = {}
    for k, v in state["model"].items():
        nk = _fairseq_key_to_hf(str(k))
        if nk is not None:
            sd[nk] = v.detach().cpu().float().numpy() if hasattr(v, "detach") else np.asarray(v)
    return convert_hf_state_dict(sd, cfg), cfg


def load_hubert(path: str, device=DEFAULT_DEVICE):
    """A local HF directory or a fairseq `.pt` -> (params on `device`, config)."""
    device = resolve_device(device)
    if str(path).endswith(".pt"):
        state = torch.load(path, map_location="cpu", weights_only=False)
        params, cfg = convert_fairseq_state(state)
    elif os.path.isdir(path):
        params, cfg = load_hf_dir(path)
    else:
        raise FileNotFoundError(f"HuBERT weights not found at {path!r}: pass a local HF "
                                f"HubertModel directory or a fairseq .pt (nothing is "
                                f"downloaded)")
    return to_torch(params, device), cfg
