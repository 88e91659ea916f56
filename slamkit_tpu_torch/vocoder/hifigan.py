"""CodeHiFiGAN: the unit-conditioned neural vocoder, in float32.

Counterpart of `slamkit_tpu/vocoder/hifigan_jax.py`: unit embedding, an
optional VariancePredictor whose durations round(exp(log d) - 1) (at least 1)
re-expand the units on the host (`_build_conditioning` :155), f0 / speaker /
style conditioning, then conv_pre, N x (transposed-conv upsample +
multi-kernel ResBlocks averaged), conv_post, tanh (the generator :95-122).
The weights are the JAX package's params tree with torch tensors; weight norm
is folded at conversion (`convert_torch_generator` :278). `synthesize_batch`
(:213) batches samples whose conditioning has the same length or pads
lengths to `bucket_frames` multiples (opt-in).
"""
from __future__ import annotations

import json
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import DEFAULT_DEVICE, resolve_device
from ..utils.tree import to_torch

LRELU_SLOPE = 0.1


def _get_padding(kernel_size, dilation=1):
    return (kernel_size * dilation - dilation) // 2


def _resblock(x, rp, kernel_size, dilations):
    for i, d in enumerate(dilations):
        xt = F.leaky_relu(x, LRELU_SLOPE)
        xt = F.conv1d(xt, rp["convs1"][i]["w"], rp["convs1"][i]["b"],
                      padding=_get_padding(kernel_size, d), dilation=d)
        xt = F.leaky_relu(xt, LRELU_SLOPE)
        xt = F.conv1d(xt, rp["convs2"][i]["w"], rp["convs2"][i]["b"],
                      padding=_get_padding(kernel_size, 1))
        x = xt + x
    return x


def hop(cfg: dict) -> int:
    """Waveform samples per conditioning frame."""
    return math.prod(cfg["upsample_rates"])


@torch.inference_mode()
def generator_forward(params: dict, cfg: dict, x: torch.Tensor) -> torch.Tensor:
    """x [B, model_in_dim, T] -> waveform [B, 1, T * prod(upsample_rates)]."""
    kernels, dilations = cfg["resblock_kernel_sizes"], cfg["resblock_dilation_sizes"]
    x = F.conv1d(x, params["conv_pre"]["w"], params["conv_pre"]["b"], padding=3)
    for i, (u, k) in enumerate(zip(cfg["upsample_rates"], cfg["upsample_kernel_sizes"])):
        x = F.leaky_relu(x, LRELU_SLOPE)
        x = F.conv_transpose1d(x, params["ups"][i]["w"], params["ups"][i]["b"], stride=u,
                               padding=(k - u) // 2)
        xs = None
        for j, (ks, ds) in enumerate(zip(kernels, dilations)):
            rb = _resblock(x, params["resblocks"][i * len(kernels) + j], ks, ds)
            xs = rb if xs is None else xs + rb
        x = xs / len(kernels)
    x = F.leaky_relu(x, 0.01)   # torch F.leaky_relu's default slope at the output conv
    x = F.conv1d(x, params["conv_post"]["w"], params["conv_post"]["b"], padding=3)
    return torch.tanh(x)


@torch.inference_mode()
def variance_predictor(params: dict, cfg: dict, x: torch.Tensor,
                       eps: float = 1e-5) -> torch.Tensor:
    """x [B, T, C] -> log durations [B, T] (dropout inactive at inference)."""
    kernel = cfg["var_pred_kernel_size"]
    h = F.conv1d(x.transpose(1, 2), params["conv1"]["w"], params["conv1"]["b"],
                 padding=(kernel - 1) // 2).transpose(1, 2)
    h = F.layer_norm(F.relu(h), (h.shape[-1],), params["ln1"]["scale"],
                     params["ln1"]["bias"], eps)
    h = F.conv1d(h.transpose(1, 2), params["conv2"]["w"], params["conv2"]["b"],
                 padding=1).transpose(1, 2)
    h = F.layer_norm(F.relu(h), (h.shape[-1],), params["ln2"]["scale"],
                     params["ln2"]["bias"], eps)
    return (h @ params["proj"]["w"].T + params["proj"]["b"])[..., 0]


def _upsample_to(signal, max_frames):
    """Repeat a [1, C, T0] conditioning signal to max_frames frames."""
    t0 = signal.shape[-1]
    if max_frames % t0:
        raise NotImplementedError(
            "Padding condition signal - misalignment between condition features.")
    return torch.repeat_interleave(signal, max_frames // t0, dim=2)


def durations(log_dur: torch.Tensor) -> np.ndarray:
    """Frames per unit from log durations, on the host as the JAX package
    computes them: max(round(exp(log d) - 1), 1)."""
    return np.maximum(np.round(np.exp(log_dur.float().cpu().numpy()) - 1).astype(int), 1)


@torch.inference_mode()
def _build_conditioning(params: dict, cfg: dict, code, dur_prediction: bool = False,
                        speaker_id: int = 0, style_id: int = 0,
                        f0: Optional[np.ndarray] = None) -> torch.Tensor:
    """Unit ids [T] or [1, T] -> generator conditioning [1, C_in, T'] on the
    params' device."""
    dev = params["dict"].device
    code = torch.as_tensor(np.atleast_2d(np.asarray(code)), dtype=torch.long, device=dev)
    x = params["dict"][code]                                  # [1, T, C]
    if dur_prediction and "dur_predictor" in params:
        dur = durations(variance_predictor(params["dur_predictor"],
                                           cfg["dur_predictor_params"], x))
        x = torch.repeat_interleave(x[0], torch.as_tensor(dur[0], device=dev), dim=0)[None]
    if cfg.get("f0", None):
        assert f0 is not None, "this vocoder requires an f0 input"
        f0 = torch.as_tensor(np.atleast_2d(np.asarray(f0)), device=dev)
        if "f0_quant_embed" in params:
            f0c = params["f0_quant_embed"][f0.long()].transpose(1, 2)
        else:
            f0c = f0[:, None, :].float()
        xc = x.transpose(1, 2)
        if xc.shape[-1] < f0c.shape[-1]:
            xc = _upsample_to(xc, f0c.shape[-1])
        elif xc.shape[-1] > f0c.shape[-1]:
            f0c = _upsample_to(f0c, xc.shape[-1])
        x = torch.cat([xc, f0c], dim=1).transpose(1, 2)
    feats = [x.transpose(1, 2)]
    for key, idx in (("spkr", speaker_id), ("style", style_id)):
        if cfg.get({"spkr": "multispkr", "style": "multistyle"}[key], None):
            emb = params[key][idx][None, :, None]             # [1, C, 1]
            feats.append(emb.expand(1, emb.shape[1], feats[0].shape[-1]))
    return torch.cat(feats, dim=1) if len(feats) > 1 else feats[0]


def code_generator_forward(params: dict, cfg: dict, code, dur_prediction: bool = False,
                           speaker_id: int = 0, style_id: int = 0,
                           f0: Optional[np.ndarray] = None) -> np.ndarray:
    """Unit ids [T] or [1, T] -> waveform [T_wav] (numpy float32)."""
    h = _build_conditioning(params, cfg, code, dur_prediction, speaker_id, style_id, f0)
    return generator_forward(params, cfg, h).cpu().numpy().squeeze()


def synthesize_batch(params: dict, cfg: dict, codes: Sequence[np.ndarray],
                     dur_prediction: bool = False, speaker_ids=None, style_ids=None,
                     f0s=None, bucket_frames: Optional[int] = None,
                     max_batch: int = 8) -> List[np.ndarray]:
    """Batched synthesis over variable-length codes. bucket_frames=None (the
    default) groups samples by their exact conditioning length, so every
    output is the per-sample path's (up to the float32 summation order the
    convolution library picks for a batch); bucket_frames=N pads lengths to
    multiples of N (a sample's tail inside the receptive field may change:
    padded frames carry conv biases instead of zeros). Outputs are trimmed to
    the true T * hop."""
    n = len(codes)
    spk = list(speaker_ids) if speaker_ids is not None else [0] * n
    sty = list(style_ids) if style_ids is not None else [0] * n
    f0l = list(f0s) if f0s is not None else [None] * n
    hs = [_build_conditioning(params, cfg, c, dur_prediction, s, st, f)
          for c, s, st, f in zip(codes, spk, sty, f0l)]
    step = hop(cfg)
    buckets: Dict[int, List[int]] = {}
    for i, h in enumerate(hs):
        t = h.shape[-1]
        tb = t if not bucket_frames else max(-(-t // bucket_frames) * bucket_frames,
                                             bucket_frames)
        buckets.setdefault(tb, []).append(i)
    out: List[Optional[np.ndarray]] = [None] * n
    for tb, idxs in sorted(buckets.items()):
        for lo in range(0, len(idxs), max_batch):
            group = idxs[lo:lo + max_batch]
            batch = torch.cat([F.pad(hs[i], (0, tb - hs[i].shape[-1])) for i in group])
            wavs = generator_forward(params, cfg, batch).cpu().numpy()
            for row, i in enumerate(group):
                out[i] = wavs[row, 0, :hs[i].shape[-1] * step]
    return out


# --------------------------------------------------------------------------- #
# weight conversion (torch checkpoint state dict -> params tree)
# --------------------------------------------------------------------------- #
def _fold_weight_norm(sd: Dict[str, np.ndarray], prefix: str) -> dict:
    """weight_g / weight_v (norm over every dim but 0) -> folded weight + bias."""
    if f"{prefix}.weight_g" in sd:
        g = np.asarray(sd[f"{prefix}.weight_g"], np.float32)
        v = np.asarray(sd[f"{prefix}.weight_v"], np.float32)
        axes = tuple(range(1, v.ndim))
        w = g * v / np.maximum(np.sqrt((v ** 2).sum(axis=axes, keepdims=True)), 1e-12)
    else:
        w = np.asarray(sd[f"{prefix}.weight"], np.float32)
    b = sd.get(f"{prefix}.bias")
    return {"w": w, "b": np.asarray(b, np.float32) if b is not None else None}


def convert_torch_generator(sd: Dict[str, np.ndarray], cfg: dict) -> dict:
    """The textless checkpoint's `generator` state dict (numpy-valued) -> the
    params tree (numpy), the JAX package's layout."""
    num_kernels = len(cfg["resblock_kernel_sizes"])
    num_ups = len(cfg["upsample_rates"])
    f32 = lambda k: np.asarray(sd[k], np.float32)
    params = {
        "conv_pre": _fold_weight_norm(sd, "conv_pre"),
        "conv_post": _fold_weight_norm(sd, "conv_post"),
        "ups": [_fold_weight_norm(sd, f"ups.{i}") for i in range(num_ups)],
        "resblocks": [],
        "dict": f32("dict.weight"),
    }
    for r in range(num_ups * num_kernels):
        n_d = len(cfg["resblock_dilation_sizes"][r % num_kernels])
        params["resblocks"].append({
            "convs1": [_fold_weight_norm(sd, f"resblocks.{r}.convs1.{i}") for i in range(n_d)],
            "convs2": [_fold_weight_norm(sd, f"resblocks.{r}.convs2.{i}") for i in range(n_d)],
        })
    for key, name in (("spkr", "spkr.weight"), ("style", "style.weight"),
                      ("f0_quant_embed", "f0_quant_embed.weight")):
        if name in sd:
            params[key] = f32(name)
    if any(k.startswith("dur_predictor") for k in sd):
        dp = "dur_predictor."
        params["dur_predictor"] = {
            "conv1": {"w": f32(dp + "conv1.0.weight"), "b": f32(dp + "conv1.0.bias")},
            "ln1": {"scale": f32(dp + "ln1.weight"), "bias": f32(dp + "ln1.bias")},
            "conv2": {"w": f32(dp + "conv2.0.weight"), "b": f32(dp + "conv2.0.bias")},
            "ln2": {"scale": f32(dp + "ln2.weight"), "bias": f32(dp + "ln2.bias")},
            "proj": {"w": f32(dp + "proj.weight"), "b": f32(dp + "proj.bias")},
        }
    return params


def random_state_dict(cfg: dict, seed: int = 0) -> dict:
    """A torch-layout generator state dict (numpy) with seeded random weights
    (plain .weight / .bias keys and a duration predictor), for runs at the
    published widths where the checkpoint is not at hand."""
    rng = np.random.default_rng(seed)

    def w(*shape, scale=0.05):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    c0 = cfg["upsample_initial_channel"]
    sd = {
        "dict.weight": w(cfg["num_embeddings"], cfg["embedding_dim"], scale=1.0),
        "conv_pre.weight": w(c0, cfg["model_in_dim"], 7),
        "conv_pre.bias": w(c0),
        "conv_post.weight": w(1, c0 // 2 ** len(cfg["upsample_rates"]), 7),
        "conv_post.bias": w(1),
    }
    ch = c0
    for i, k in enumerate(cfg["upsample_kernel_sizes"]):
        sd[f"ups.{i}.weight"] = w(ch, ch // 2, k)        # ConvTranspose1d [in, out, k]
        sd[f"ups.{i}.bias"] = w(ch // 2)
        ch //= 2
    n_kernels = len(cfg["resblock_kernel_sizes"])
    ch = c0
    for i in range(len(cfg["upsample_rates"])):
        ch //= 2
        for j, ks in enumerate(cfg["resblock_kernel_sizes"]):
            r = i * n_kernels + j
            for c in range(len(cfg["resblock_dilation_sizes"][j])):
                for conv in ("convs1", "convs2"):
                    sd[f"resblocks.{r}.{conv}.{c}.weight"] = w(ch, ch, ks)
                    sd[f"resblocks.{r}.{conv}.{c}.bias"] = w(ch)
    dp = cfg["dur_predictor_params"]
    h = dp["var_pred_hidden_dim"]
    sd.update({
        "dur_predictor.conv1.0.weight": w(h, dp["encoder_embed_dim"], 3),
        "dur_predictor.conv1.0.bias": w(h),
        "dur_predictor.ln1.weight": np.ones(h, np.float32),
        "dur_predictor.ln1.bias": np.zeros(h, np.float32),
        "dur_predictor.conv2.0.weight": w(h, h, 3),
        "dur_predictor.conv2.0.bias": w(h),
        "dur_predictor.ln2.weight": np.ones(h, np.float32),
        "dur_predictor.ln2.bias": np.zeros(h, np.float32),
        "dur_predictor.proj.weight": w(1, h),
        "dur_predictor.proj.bias": w(1),
    })
    return sd


def load_checkpoint(model_path: str, config_path: str, device=DEFAULT_DEVICE):
    """A textless CodeHiFiGAN checkpoint (`{'generator': state dict}`) and its
    config json -> (params on `device`, cfg)."""
    device = resolve_device(device)
    with open(config_path) as f:
        cfg = json.load(f)
    state = torch.load(model_path, map_location="cpu", weights_only=False)
    sd = {k: v.float().numpy() for k, v in state["generator"].items()}
    return to_torch(convert_torch_generator(sd, cfg), device), cfg
