"""Whisper ASR for the generative metrics (GenPPL, the LLM judge), without
transformers.

Counterpart of `slamkit_tpu/metric/whisper_jax.py`: `WhisperCfg` (:40, read
from `config.json` with transformers' `WhisperConfig` defaults for absent
keys), `convert_whisper_state_dict` (:95, a copy: the same HF state dict gives
both packages the same parameters), the encoder (`encode` :197: two
convolutions with exact gelu, pre-LN blocks) and the decoder step
(`_decoder_step` :236, self-attention over a KV cache, cross-attention over
keys and values computed once per window, `_cross_kv` :281, the tied output
projection in float32), `greedy_decode` (:296: the forced prefix, the
suppress and begin-suppress masks, eos padding), `_decode_plan` (:454) and
`WhisperPipeline` (`JaxWhisperPipeline` :344: 30 s windows, silence rows
that fill the last batch, window texts joined, unsupported kwargs raise).

Beside those, what the JAX pipeline takes from transformers: the log-mel
front end (`metric/whisper_features.py`) and the transcript's text,
`WhisperTokenizerFast.decode(row, skip_special_tokens=True)` (:421) on the
port's tokenizer.json reader (`whisper_decode`: the prompt before
`<|startoftranscript|>` stripped, special tokens skipped, the tokenizer's
clean-up, `<|n.nn|>` timestamps removed from the text).

Whisper's attention, projections and convolutions are plain torch, as they
are plain jnp in the JAX package (no Pallas kernel). Computation runs in
`dtype` (float32 by default, bfloat16 on request) with layer norms, softmax
and the logits in float32, as `whisper_jax.py` runs them; the convolutions
run with cuDNN's TF32 off, so float32 stays float32 on the card.
`tests/test_torch_whisper.py` holds every piece to the JAX package.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import logging
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..tokeniser.text_tokeniser import TextTokeniser
from ..utils.device import DEFAULT_DEVICE, resolve_device
from ..utils.safetensors import read_safetensors
from .whisper_features import WhisperFeatures

logger = logging.getLogger(__name__)

NEG_INF = -1e30

#: transformers' WhisperConfig defaults, for keys a config.json leaves out
HF_DEFAULTS = dict(vocab_size=51865, num_mel_bins=80, encoder_layers=4,
                   encoder_attention_heads=6, decoder_layers=4, decoder_attention_heads=6,
                   decoder_ffn_dim=1536, encoder_ffn_dim=1536, d_model=384,
                   max_source_positions=1500, max_target_positions=448,
                   decoder_start_token_id=50257, eos_token_id=50256, pad_token_id=50256,
                   bos_token_id=50256, suppress_tokens=None, begin_suppress_tokens=[220, 50256],
                   forced_decoder_ids=None)


@dataclasses.dataclass(frozen=True)
class WhisperCfg:
    """The JAX package's WhisperCfg, field for field."""

    vocab_size: int
    num_mel_bins: int
    d_model: int
    encoder_layers: int
    encoder_heads: int
    decoder_layers: int
    decoder_heads: int
    encoder_ffn: int
    decoder_ffn: int
    max_source_positions: int
    max_target_positions: int
    decoder_start_token_id: int
    eos_token_id: int
    dtype: str = "float32"

    @classmethod
    def from_hf_dict(cls, hf: dict, dtype: str = "float32") -> "WhisperCfg":
        """From a `config.json` dict; absent keys take WhisperConfig's defaults."""
        g = lambda k: hf.get(k, HF_DEFAULTS.get(k))  # noqa: E731
        return cls(vocab_size=g("vocab_size"), num_mel_bins=g("num_mel_bins"),
                   d_model=g("d_model"), encoder_layers=g("encoder_layers"),
                   encoder_heads=g("encoder_attention_heads"),
                   decoder_layers=g("decoder_layers"),
                   decoder_heads=g("decoder_attention_heads"),
                   encoder_ffn=g("encoder_ffn_dim"), decoder_ffn=g("decoder_ffn_dim"),
                   max_source_positions=g("max_source_positions"),
                   max_target_positions=g("max_target_positions"),
                   decoder_start_token_id=g("decoder_start_token_id"),
                   eos_token_id=g("eos_token_id"), dtype=dtype)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.encoder_heads

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


# --------------------------------------------------------------------------- #
# weight conversion: HF state dict (numpy) -> stacked dict (a copy of JAX's)
# --------------------------------------------------------------------------- #
def _stack(sd, fmt: str, n: int, transpose: bool = False) -> Optional[np.ndarray]:
    keys = [fmt.format(i) for i in range(n)]
    if keys[0] not in sd:
        return None
    mats = [np.asarray(sd[k], np.float32) for k in keys]
    if transpose:
        mats = [m.T for m in mats]
    return np.stack(mats)


def convert_whisper_state_dict(sd: dict, cfg: WhisperCfg) -> dict:
    """HF WhisperForConditionalGeneration (numpy-valued, torch layout) ->
    stacked [L, ...] float32 arrays. Linear weights transpose to [in, out];
    k_proj has no bias in the architecture."""
    def side(prefix: str, n_layers: int, cross: bool) -> dict:
        def st(name, transpose=False):
            return _stack(sd, f"{prefix}.layers.{{}}.{name}", n_layers, transpose)

        p = {
            "q_w": st("self_attn.q_proj.weight", True),
            "q_b": st("self_attn.q_proj.bias"),
            "k_w": st("self_attn.k_proj.weight", True),
            "v_w": st("self_attn.v_proj.weight", True),
            "v_b": st("self_attn.v_proj.bias"),
            "o_w": st("self_attn.out_proj.weight", True),
            "o_b": st("self_attn.out_proj.bias"),
            "ln1_scale": st("self_attn_layer_norm.weight"),
            "ln1_bias": st("self_attn_layer_norm.bias"),
            "fc1_w": st("fc1.weight", True),
            "fc1_b": st("fc1.bias"),
            "fc2_w": st("fc2.weight", True),
            "fc2_b": st("fc2.bias"),
            "ln_f_scale": st("final_layer_norm.weight"),
            "ln_f_bias": st("final_layer_norm.bias"),
        }
        if cross:
            p.update({
                "xq_w": st("encoder_attn.q_proj.weight", True),
                "xq_b": st("encoder_attn.q_proj.bias"),
                "xk_w": st("encoder_attn.k_proj.weight", True),
                "xv_w": st("encoder_attn.v_proj.weight", True),
                "xv_b": st("encoder_attn.v_proj.bias"),
                "xo_w": st("encoder_attn.out_proj.weight", True),
                "xo_b": st("encoder_attn.out_proj.bias"),
                "xln_scale": st("encoder_attn_layer_norm.weight"),
                "xln_bias": st("encoder_attn_layer_norm.bias"),
            })
        return p

    g = lambda k: np.asarray(sd[k], np.float32)  # noqa: E731
    return {
        "enc": {
            "conv1_w": g("model.encoder.conv1.weight"),   # [d, mel, 3]
            "conv1_b": g("model.encoder.conv1.bias"),
            "conv2_w": g("model.encoder.conv2.weight"),
            "conv2_b": g("model.encoder.conv2.bias"),
            "pos": g("model.encoder.embed_positions.weight"),
            "layers": side("model.encoder", cfg.encoder_layers, cross=False),
            "ln_scale": g("model.encoder.layer_norm.weight"),
            "ln_bias": g("model.encoder.layer_norm.bias"),
        },
        "dec": {
            "embed": g("model.decoder.embed_tokens.weight"),
            "pos": g("model.decoder.embed_positions.weight"),
            "layers": side("model.decoder", cfg.decoder_layers, cross=True),
            "ln_scale": g("model.decoder.layer_norm.weight"),
            "ln_bias": g("model.decoder.layer_norm.bias"),
        },
    }


def load_whisper_state_dict(model_dir: str) -> Dict[str, np.ndarray]:
    """The checkpoint directory's `*.safetensors` as one numpy state dict
    (no transformers, no safetensors package); raises naming the directory
    where there are none."""
    files = sorted(glob.glob(os.path.join(model_dir, "*.safetensors")))
    if not files:
        raise FileNotFoundError(f"no *.safetensors weights in {model_dir!r}: the port reads "
                                f"Whisper from a local directory (nothing is downloaded)")
    sd: Dict[str, np.ndarray] = {}
    for f in files:
        sd.update(read_safetensors(f))
    return sd


# --------------------------------------------------------------------------- #
# the model
# --------------------------------------------------------------------------- #
def _ln(x, scale, bias):
    return F.layer_norm(x.float(), (x.shape[-1],), scale, bias, eps=1e-5).to(x.dtype)


def _heads(x, n_heads):
    b, t, d = x.shape
    return x.reshape(b, t, n_heads, d // n_heads).transpose(1, 2)


def _merge(x):
    b, h, t, dh = x.shape
    return x.transpose(1, 2).reshape(b, t, h * dh)


def _attn(q, k, v, n_valid: Optional[int] = None):
    """q already scaled; float32 scores and softmax, probabilities in v's
    dtype. n_valid: attend to the first n_valid keys only (the cache)."""
    if n_valid is not None:
        k, v = k[:, :, :n_valid], v[:, :, :n_valid]
    logits = q.float() @ k.float().transpose(-1, -2)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return probs @ v


def _proj(x, w, b=None):
    y = x @ w
    return y + b if b is not None else y


class Whisper:
    """The encoder-decoder on `device`. Parameters come from
    `convert_whisper_state_dict`: projections, convolutions and embeddings
    in the compute dtype, layer norms and the tied output projection in
    float32 (as `whisper_jax.py` keeps them)."""

    def __init__(self, params: dict, cfg: WhisperCfg,
                 device: Union[str, torch.device] = DEFAULT_DEVICE):
        self.cfg = cfg
        self.device = resolve_device(device)
        dt = cfg.compute_dtype

        def put(x, f32=False):
            return torch.from_numpy(np.ascontiguousarray(x)).to(
                self.device, torch.float32 if f32 else dt)

        def layers(tree):
            return [{k: put(v[i], f32=k.startswith(("ln", "xln")))
                     for k, v in tree.items() if v is not None} for i in range(
                len(next(iter(tree.values()))))]

        enc, dec = params["enc"], params["dec"]
        self.enc = {k: put(enc[k]) for k in ("conv1_w", "conv1_b", "conv2_w", "conv2_b", "pos")}
        self.enc.update(ln_scale=put(enc["ln_scale"], True), ln_bias=put(enc["ln_bias"], True))
        self.enc_layers = layers(enc["layers"])
        self.dec = {"embed": put(dec["embed"]), "pos": put(dec["pos"]),
                    "embed_f32": put(dec["embed"], True),
                    "ln_scale": put(dec["ln_scale"], True), "ln_bias": put(dec["ln_bias"], True)}
        self.dec_layers = layers(dec["layers"])

    # -- encoder -------------------------------------------------------------
    @torch.inference_mode()
    def encode(self, mel: torch.Tensor) -> torch.Tensor:
        """mel [B, n_mels, 2 * max_source_positions] -> [B, S, d] hidden states."""
        cfg, e, dt = self.cfg, self.enc, self.cfg.compute_dtype
        x = mel.to(self.device, dt)
        cudnn = torch.backends.cudnn
        # cuDNN takes float32 convolutions in TF32 by default: not here
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=False):
            x = F.gelu(F.conv1d(x, e["conv1_w"], e["conv1_b"], padding=1))
            x = F.gelu(F.conv1d(x, e["conv2_w"], e["conv2_b"], stride=2, padding=1))
        x = x.transpose(1, 2) + e["pos"][None, :x.shape[2]]
        scale = cfg.head_dim ** -0.5
        for lp in self.enc_layers:
            y = _ln(x, lp["ln1_scale"], lp["ln1_bias"])
            q = _heads(_proj(y, lp["q_w"], lp["q_b"]) * scale, cfg.encoder_heads)
            k = _heads(_proj(y, lp["k_w"]), cfg.encoder_heads)
            v = _heads(_proj(y, lp["v_w"], lp["v_b"]), cfg.encoder_heads)
            x = x + _proj(_merge(_attn(q, k, v)), lp["o_w"], lp["o_b"])
            y = _ln(x, lp["ln_f_scale"], lp["ln_f_bias"])
            x = x + _proj(F.gelu(_proj(y, lp["fc1_w"], lp["fc1_b"])), lp["fc2_w"], lp["fc2_b"])
        return _ln(x, e["ln_scale"], e["ln_bias"])

    # -- decoder -------------------------------------------------------------
    @torch.inference_mode()
    def cross_kv(self, enc_out: torch.Tensor) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Cross-attention k / v per decoder layer, once per window: [B, H, S, dh]."""
        h, enc_out = self.cfg.decoder_heads, enc_out.to(self.cfg.compute_dtype)
        return [(_heads(_proj(enc_out, lp["xk_w"]), h),
                 _heads(_proj(enc_out, lp["xv_w"], lp["xv_b"]), h)) for lp in self.dec_layers]

    def new_cache(self, batch: int, t_max: int) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        cfg = self.cfg
        shape = (batch, cfg.decoder_heads, t_max, cfg.d_model // cfg.decoder_heads)
        return [(torch.zeros(shape, dtype=cfg.compute_dtype, device=self.device),
                 torch.zeros(shape, dtype=cfg.compute_dtype, device=self.device))
                for _ in self.dec_layers]

    @torch.inference_mode()
    def decoder_step(self, tok: torch.Tensor, pos: int, cache, xkv) -> torch.Tensor:
        """tok [B] at position `pos` -> logits [B, V] float32; writes the
        step's keys and values into `cache` (from `new_cache`) in place."""
        cfg, d = self.cfg, self.dec
        h = cfg.decoder_heads
        x = (d["embed"][tok] + d["pos"][pos])[:, None, :]           # [B, 1, d]
        scale = cfg.head_dim ** -0.5
        for lp, (ck, cv), (xk, xv) in zip(self.dec_layers, cache, xkv):
            y = _ln(x, lp["ln1_scale"], lp["ln1_bias"])
            q = _heads(_proj(y, lp["q_w"], lp["q_b"]) * scale, h)
            ck[:, :, pos] = _heads(_proj(y, lp["k_w"]), h)[:, :, 0]
            cv[:, :, pos] = _heads(_proj(y, lp["v_w"], lp["v_b"]), h)[:, :, 0]
            x = x + _proj(_merge(_attn(q, ck, cv, n_valid=pos + 1)), lp["o_w"], lp["o_b"])
            y = _ln(x, lp["xln_scale"], lp["xln_bias"])
            xq = _heads(_proj(y, lp["xq_w"], lp["xq_b"]) * scale, h)
            x = x + _proj(_merge(_attn(xq, xk, xv)), lp["xo_w"], lp["xo_b"])
            y = _ln(x, lp["ln_f_scale"], lp["ln_f_bias"])
            x = x + _proj(F.gelu(_proj(y, lp["fc1_w"], lp["fc1_b"])), lp["fc2_w"], lp["fc2_b"])
        x = _ln(x, d["ln_scale"], d["ln_bias"])
        return x[:, 0].float() @ d["embed_f32"].T                    # tied proj_out

    @torch.inference_mode()
    def greedy_decode(self, enc_out: torch.Tensor, forced_ids: Sequence[int],
                      max_new_tokens: int, suppress_mask: Optional[torch.Tensor] = None,
                      begin_suppress_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Greedy transcription: [B, n_forced + max_new_tokens] int64, starting
        with `forced_ids` (decoder_start, then the forced decoder ids); a row
        emits eos after its eos. Stops early once every row has emitted eos:
        the rest would be eos."""
        cfg = self.cfg
        b, n_forced = enc_out.shape[0], len(forced_ids)
        t_max = n_forced + max_new_tokens
        xkv = self.cross_kv(enc_out)
        cache = self.new_cache(b, t_max)
        tokens = torch.full((b, t_max), cfg.eos_token_id, dtype=torch.long, device=self.device)
        tokens[:, :n_forced] = torch.as_tensor(list(forced_ids), device=self.device)
        done = torch.zeros(b, dtype=torch.bool, device=self.device)
        for i in range(t_max - 1):
            logits = self.decoder_step(tokens[:, i], i, cache, xkv)
            if i + 1 < n_forced:      # inside the forced prefix the next token is fixed
                continue
            if suppress_mask is not None:
                logits = logits.masked_fill(suppress_mask, NEG_INF)
            if begin_suppress_mask is not None and i == n_forced - 1:
                logits = logits.masked_fill(begin_suppress_mask, NEG_INF)
            nxt = torch.where(done, cfg.eos_token_id, logits.argmax(dim=-1))
            done = done | (nxt == cfg.eos_token_id)
            tokens[:, i + 1] = nxt
            if (i + 1) % 16 == 0 and bool(done.all()):
                break
        return tokens


# --------------------------------------------------------------------------- #
# the decode plan and the transcript's text
# --------------------------------------------------------------------------- #
def _read_json(path: str) -> Optional[dict]:
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        return json.load(f)


def decode_plan(hf: dict, gen: Optional[dict], cfg: WhisperCfg
                ) -> Tuple[List[int], Optional[np.ndarray], Optional[np.ndarray]]:
    """The forced prefix (decoder_start, then `forced_decoder_ids` by
    position) and the suppress / begin-suppress masks ([vocab] bool or
    None), read from generation_config.json first and config.json after it,
    as `whisper_jax._decode_plan` reads them. A forced slot without a token
    (HF writes the language slot as [1, null] in some generation configs)
    raises, naming it: the JAX package's `int(tok)` raises there too."""
    gen = gen or {}
    hf_get = lambda k: hf.get(k, HF_DEFAULTS.get(k))  # noqa: E731
    forced = [cfg.decoder_start_token_id]
    for slot, tok in sorted(gen.get("forced_decoder_ids") or hf_get("forced_decoder_ids") or [],
                            key=lambda p: p[0]):
        if tok is None:
            raise ValueError(f"forced_decoder_ids slot {slot} has no token (null): name the "
                             f"language / task tokens in generation_config.json")
        forced.append(int(tok))

    def mask_of(ids):
        if not ids:
            return None
        m = np.zeros((cfg.vocab_size,), bool)
        m[np.asarray(list(ids), int)] = True
        return m

    suppress = gen.get("suppress_tokens") or hf_get("suppress_tokens") or []
    begin = gen.get("begin_suppress_tokens") or hf_get("begin_suppress_tokens") or []
    return forced, mask_of(suppress), mask_of(begin)


_TIMESTAMP = re.compile(r"<\|(\d+\.\d+)\|>")


def whisper_decode(tokeniser: TextTokeniser, ids, skip_special_tokens: bool = True) -> str:
    """`WhisperTokenizerFast.decode(ids, skip_special_tokens=...)`: with
    skip_special_tokens a row that starts with `<|startofprev|>` loses its
    prompt up to `<|startoftranscript|>` (all of it without one), then the
    tokenizer's decode and clean-up, then `<|n.nn|>` timestamps are removed
    from the text."""
    ids = [int(i) for i in np.asarray(ids).reshape(-1)]
    if skip_special_tokens and ids:
        prev = tokeniser.convert_tokens_to_ids("<|startofprev|>")
        start = tokeniser.convert_tokens_to_ids("<|startoftranscript|>")
        if ids[0] == prev:
            ids = ids[ids.index(start):] if start in ids else []
    text = tokeniser.decode(ids, skip_special_tokens=skip_special_tokens)
    return _TIMESTAMP.sub("", text)


# --------------------------------------------------------------------------- #
# pipeline
# --------------------------------------------------------------------------- #
class WhisperPipeline:
    """`JaxWhisperPipeline` on the port: callable on a list of float
    waveforms, returns [{"text": ...}]. Features, encoder, greedy decoder and
    text all come from the checkpoint directory `model_dir` (config.json,
    generation_config.json, preprocessor_config.json, tokenizer.json,
    *.safetensors); everything runs on `device`."""

    def __init__(self, model_dir: str, dtype: str = "float32",
                 device: Union[str, torch.device] = DEFAULT_DEVICE):
        if dtype not in ("float32", "bfloat16"):
            raise ValueError(f"asr dtype {dtype!r}: float32 or bfloat16")
        self.device = resolve_device(device)
        hf = _read_json(os.path.join(model_dir, "config.json"))
        if hf is None:
            raise FileNotFoundError(f"no config.json in {model_dir!r}: the port reads Whisper "
                                    f"from a local directory (nothing is downloaded)")
        self.cfg = WhisperCfg.from_hf_dict(hf, dtype=dtype)
        params = convert_whisper_state_dict(load_whisper_state_dict(model_dir), self.cfg)
        self.model = Whisper(params, self.cfg, device=self.device)
        del params
        gen = _read_json(os.path.join(model_dir, "generation_config.json"))
        self.forced_ids, suppress, begin = decode_plan(hf, gen, self.cfg)
        to_mask = lambda m: None if m is None else torch.from_numpy(m).to(self.device)  # noqa
        self.suppress, self.begin_suppress = to_mask(suppress), to_mask(begin)
        self.features = WhisperFeatures.from_pretrained(model_dir, device=self.device)
        self.sample_rate = self.features.sampling_rate
        self.tokeniser = TextTokeniser.from_pretrained(model_dir)
        logger.info("WhisperPipeline (the port's own Whisper): %s on %s (%s)", model_dir,
                    self.device, dtype)

    def __call__(self, wavs: List[np.ndarray], batch_size: int = 8, **kwargs) -> List[dict]:
        """Transcribe a list of waveforms. Audio longer than the 30 s window
        is split into consecutive windows, transcribed independently and
        joined (no stride merge, as the JAX pipeline). Unsupported kwargs
        raise instead of being silently dropped."""
        if kwargs:
            raise ValueError(f"WhisperPipeline got unsupported kwargs {sorted(kwargs)}; "
                             f"supported: batch_size")
        n_samples = self.features.n_samples
        windows: List[np.ndarray] = []
        spans: List[Tuple[int, int]] = []
        for w in wavs:
            w = np.asarray(w, np.float32).reshape(-1)
            n_win = max(1, -(-w.size // n_samples))
            spans.append((len(windows), n_win))
            windows.extend(w[j * n_samples:(j + 1) * n_samples] for j in range(n_win))
        texts = self.transcribe_windows(windows, batch_size)
        return [{"text": "".join(texts[lo:lo + n])} for lo, n in spans]

    def transcribe_windows(self, windows: List[np.ndarray], batch_size: int) -> List[str]:
        out: List[str] = []
        eos, n_forced = self.cfg.eos_token_id, len(self.forced_ids)
        max_new = self.cfg.max_target_positions - n_forced
        for i in range(0, len(windows), batch_size):
            chunk = windows[i:i + batch_size]
            # a fixed batch shape: the tail chunk is filled with silence rows
            pad_rows = batch_size - len(chunk)
            mel = self.features(chunk + [np.zeros(self.sample_rate, np.float32)] * pad_rows)
            enc = self.model.encode(mel)
            toks = self.model.greedy_decode(enc, self.forced_ids, max_new, self.suppress,
                                            self.begin_suppress)
            for row in toks[:len(chunk)].cpu().numpy():
                row = row[n_forced:]
                stop = np.flatnonzero(row == eos)
                row = row[:stop[0]] if stop.size else row
                out.append(whisper_decode(self.tokeniser, row))
        return out
