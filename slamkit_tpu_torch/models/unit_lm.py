"""UnitLM — the unit language model's serving and training surface.

Counterpart of `slamkit_tpu/models/unit_lm.py`: `UnitLMConfig`, and `UnitLM`
with `loss_fn` (training), `log_likelihood` (scoring), `generate` (sampling),
`save_pretrained` / `from_pretrained` on the JAX package's own files
(`unit_lm_config.json` + `params.npz`, so checkpoints cross-load both ways)
and on the reference toolkit's HF checkpoints, `export_hf`, the TWIST warm
start (`twist_init`, through `models/hf_convert.py`), and `tlm_factory`. Mesh
placement and `push_to_hub` (it needs the network) are not ported.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import List, Optional, Union

import numpy as np
import torch

from ..utils.calculation_utils import calc_nll, cross_entropy_loss
from ..utils.device import DEFAULT_DEVICE, resolve_device
from .convert import load_flat, to_flat
from .generate import generate as _generate
from .generate import prepare_int8_decode_params as _prepare_int8
from .hf_convert import (convert_state_dict, export_hf_checkpoint, load_hf_state_dict,
                         load_twist_params)
from .presets import (DecoderConfig, config_from_hf_dict, resolve_base_config,
                      translate_decoder_overrides)
from .transformer import Decoder, param_count

logger = logging.getLogger(__name__)

CONFIG_NAME = "unit_lm_config.json"
WEIGHTS_NAME = "params.npz"


@dataclasses.dataclass
class UnitLMConfig:
    """The JAX package's UnitLMConfig, field for field (same json)."""

    base_model_name: str = "facebook/opt-125m"
    vocab_size: int = 502
    twist_init: bool = True
    use_cache: bool = True
    pad_token_id: int = 0
    bos_token_id: int = 1
    eos_token_id: int = 1
    torch_dtype: Optional[str] = None      # 'bfloat16' | 'float32' | None
    attn_implementation: Optional[str] = None
    rope_theta: Optional[float] = None
    trust_remote_code: Optional[bool] = None
    use_safetensors: Optional[bool] = None
    dropout: float = 0.0
    attention_dropout: float = 0.0
    layerdrop: float = 0.0
    remat: bool = False
    remat_policy: str = "full"
    remat_layers: int = -1
    config_overrides: dict = dataclasses.field(default_factory=dict)

    def decoder_config(self) -> DecoderConfig:
        attn_impl = {"flash_attention_2": "flash", None: "auto"}.get(
            self.attn_implementation, self.attn_implementation or "auto")
        dtype = "bfloat16" if self.torch_dtype in ("bfloat16", None) else "float32"
        explicit = dict(
            vocab_size=self.vocab_size,
            rope_theta=self.rope_theta,
            dtype=dtype,
            attn_impl=attn_impl,
            remat=self.remat or None,
            remat_policy=self.remat_policy if self.remat_policy != "full" else None,
            remat_layers=self.remat_layers if self.remat_layers != -1 else None,
            dropout=self.dropout or None,
            attention_dropout=self.attention_dropout or None,
            layerdrop=self.layerdrop or None,
        )
        merged = {**translate_decoder_overrides(self.config_overrides),
                  **{k: v for k, v in explicit.items() if v is not None}}
        return resolve_base_config(self.base_model_name, **merged)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "UnitLMConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        base = {k: v for k, v in d.items() if k in known}
        extra = {k: v for k, v in d.items() if k not in known}
        if extra:
            # unknown config_args are decoder overrides; explicit
            # config_overrides entries win over strays
            base["config_overrides"] = {**extra, **(base.get("config_overrides") or {})}
        return cls(**base)


#: HF generate() kwargs accepted only at these no-op values. A value matches
#: when it has the same type and compares equal, so num_beams=True or
#: early_stopping=0 are rejected (the JAX package's `v in noop` accepts them).
_NOOP_GENERATE_KWARGS = {
    "num_beams": (1, None), "num_return_sequences": (1, None),
    "length_penalty": (1.0, None), "early_stopping": (False, None),
    "use_cache": (True, None), "min_new_tokens": (0, None),
    "no_repeat_ngram_size": (0, None), "typical_p": (1.0, None),
    "epsilon_cutoff": (0.0, None), "eta_cutoff": (0.0, None),
    "diversity_penalty": (0.0, None), "penalty_alpha": (0.0, None),
}


def _is_noop(value, noop: tuple) -> bool:
    return any(value is None if n is None else (type(value) is type(n) and value == n)
               for n in noop)


def bad_words_mask(bad_words_ids: Optional[list], vocab_size: int,
                   device: Union[str, torch.device] = "cpu") -> Optional[torch.Tensor]:
    """[vocab_size] bool mask of the unigram bans in `bad_words_ids` (lists of
    one id, or bare ids; longer sequences are not bans, as in the JAX
    package), set with one index operation; None without bans."""
    if not bad_words_ids:
        return None
    ids = [w if not isinstance(w, (list, tuple)) else w[0] for w in bad_words_ids
           if not isinstance(w, (list, tuple)) or len(w) == 1]
    mask = torch.zeros(vocab_size, dtype=torch.bool, device=device)
    mask[torch.as_tensor(np.asarray(ids, dtype=np.int64), device=device)] = True
    return mask


class UnitLM:
    def __init__(self, config: UnitLMConfig, params: Optional[dict] = None,
                 seed: int = 0, device: Union[str, torch.device] = DEFAULT_DEVICE,
                 decoder_config: Optional[DecoderConfig] = None):
        """params: a flat JAX-layout dict (`params.npz` keys) to load; without
        it, twist_init converts the base LM's weights (`load_twist_params`)
        and otherwise, or where they cannot be used, the random init runs
        from `seed`. device is where the weights live and every call runs
        (the card by default; without one, pass device="cpu"); nothing moves
        implicitly. decoder_config replaces `config.decoder_config()` (a
        reference checkpoint's own architecture)."""
        self.config = config
        self.device = resolve_device(device)
        cfg = decoder_config or config.decoder_config()
        self.decoder = Decoder(cfg, device=self.device)
        if params is None and config.twist_init:
            params = load_twist_params(config, cfg, seed=seed)
        if params is not None:
            load_flat(self.decoder, params)
        else:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            self.decoder.reset_parameters(gen)
        logger.info("UnitLM: %s, %.1fM params on %s", config.base_model_name,
                    param_count(self.decoder) / 1e6, self.device)

    def _tensor(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            if x.device != self.device:
                raise ValueError(f"input on {x.device}, model on {self.device}")
            return x
        return torch.as_tensor(np.asarray(x), device=self.device)

    # -- training -------------------------------------------------------------
    def parameters(self):
        """The trainable parameters (the decoder's), in a fixed order."""
        return list(self.decoder.parameters())

    def loss_fn(self, batch: dict) -> torch.Tensor:
        """Training loss on {'input_ids', 'labels', 'segment_ids'?,
        'positions'?, 'num_items_in_batch'?}: the shifted cross entropy over
        labels != -100, divided by num_items_in_batch when given (the
        accumulation group's count) and by the batch's own count otherwise.
        The batch's tensors must be on the model's device."""
        get = lambda key: None if batch.get(key) is None else self._tensor(batch[key])
        logits, _ = self.decoder(get("input_ids"), positions=get("positions"),
                                 segment_ids=get("segment_ids"))
        return cross_entropy_loss(logits, get("labels"), batch.get("num_items_in_batch"))

    # -- scoring --------------------------------------------------------------
    @torch.inference_mode()
    def log_likelihood(self, tokens, mean_nll: bool = True,
                       ignore_tokens: Optional[List[int]] = None) -> torch.Tensor:
        """Per-sequence log likelihood [B]: pads (pad_token_id) are excluded,
        bos scores as a real token, ignored vocab ids get -inf logits. T is
        padded up to a multiple of 64 with pads (scores are unchanged)."""
        pad = self.config.pad_token_id
        tokens = self._tensor(tokens)
        rem = (-tokens.shape[-1]) % 64
        if rem:
            tokens = torch.nn.functional.pad(tokens, (0, rem), value=pad)
        seg = torch.where(tokens == pad, -1, 0).to(torch.int32)
        logits, _ = self.decoder(tokens, segment_ids=seg)
        if ignore_tokens is not None:
            m = torch.zeros(self.decoder.cfg.vocab_size, dtype=torch.bool, device=self.device)
            m[torch.as_tensor(list(ignore_tokens), dtype=torch.long, device=self.device)] = True
            logits = logits.masked_fill(m, float("-inf"))
        target = tokens[..., 1:]
        return -calc_nll(logits[..., :-1, :], target, target != pad, mean_nll)

    # -- generation -----------------------------------------------------------
    def generate(self, input_ids, attention_mask=None, *, max_new_tokens: int = 150,
                 do_sample: bool = True, temperature: float = 1.0,
                 top_k: Optional[int] = None, top_p: Optional[float] = None,
                 repetition_penalty: Optional[float] = None,
                 bad_words_ids: Optional[list] = None,
                 seed: Optional[int] = None,
                 generator: Optional[torch.Generator] = None,
                 weight_quant: Optional[str] = None,
                 **kwargs) -> torch.Tensor:
        """Sampling generation on LEFT-padded prompts; returns
        [B, L0 + max_new_tokens] on the model's device.

        Draws come from `generator` (on the model's device), else from a new
        one seeded with `seed` (random when None). weight_quant="int8" decodes
        with int8 projection weights through the dq_matmul kernel. Unsupported
        HF generate kwargs raise unless passed at their no-op value."""
        for k, v in kwargs.items():
            noop = _NOOP_GENERATE_KWARGS.get(k)
            if noop is not None and _is_noop(v, noop):
                continue
            raise ValueError(
                f"UnitLM.generate does not implement {k}={v!r} (supported: "
                f"max_new_tokens, do_sample, temperature, top_k, top_p, "
                f"repetition_penalty, bad_words_ids, seed/generator; {k} is "
                + (f"only supported at its no-op value {noop[0]!r}" if noop is not None
                   else "not a recognised generation knob") + ")")
        if weight_quant not in (None, "int8"):
            raise ValueError(f"unknown weight_quant {weight_quant!r} (only 'int8')")
        pad = self.config.pad_token_id
        input_ids = self._tensor(input_ids)
        if attention_mask is None:
            attention_mask = (input_ids != pad).to(torch.int32)
        else:
            attention_mask = self._tensor(attention_mask)
        # bucket the prompt length (LEFT pad), sliced off the result
        rem = (-input_ids.shape[-1]) % 64
        if rem:
            input_ids = torch.nn.functional.pad(input_ids, (rem, 0), value=pad)
            attention_mask = torch.nn.functional.pad(attention_mask, (rem, 0))
        bad_mask = bad_words_mask(bad_words_ids, self.decoder.cfg.vocab_size, self.device)
        if generator is None:
            generator = torch.Generator(device=self.device)
            if seed is None:
                generator.seed()
            else:
                generator.manual_seed(seed)
        # numerical no-ops map to None so the warpers are skipped
        if temperature is not None and float(temperature) == 1.0:
            temperature = None
        if top_p is not None and float(top_p) >= 1.0:
            top_p = None
        if repetition_penalty is not None and float(repetition_penalty) == 1.0:
            repetition_penalty = None
        decoder = self._int8_decode_params() if weight_quant == "int8" else self.decoder
        out = _generate(decoder, input_ids, attention_mask, generator,
                        max_new_tokens=max_new_tokens, do_sample=do_sample,
                        temperature=temperature, top_k=top_k, top_p=top_p,
                        repetition_penalty=repetition_penalty,
                        eos_token_id=self.config.eos_token_id,
                        pad_token_id=pad, bad_words_mask=bad_mask,
                        weight_quant=weight_quant)
        return out[:, rem:] if rem else out

    def _int8_decode_params(self):
        """The int8 decode copy of the decoder, built once per set of weights
        and reused across generate() calls (JAX `unit_lm.py:265`). The key is
        the parameters' identity and their version counters, so assigning a
        new decoder, loading weights or an optimizer step (all in place here,
        unlike JAX's new arrays) invalidates it."""
        key = [(p, p._version) for p in self.decoder.parameters()]
        cached = getattr(self, "_int8_cache", None)
        if cached is not None and len(cached[0]) == len(key) and all(
                a is b and va == vb for (a, va), (b, vb) in zip(cached[0], key)):
            return cached[1]
        # drop the stale copy BEFORE building the new one, so the old int8
        # weights and the new cast copy are never resident together
        self._int8_cache = None
        prepared = _prepare_int8(self.decoder)
        self._int8_cache = (key, prepared)
        return prepared

    # -- persistence ----------------------------------------------------------
    def save_pretrained(self, save_directory: str, params: Optional[dict] = None):
        """Write `unit_lm_config.json` + `params.npz` in the JAX package's
        layout; the weights land via temp file + rename. params: a snapshot
        of the weights keyed by `decoder.named_parameters()` names to write
        instead of the live ones (a background checkpoint's copy)."""
        os.makedirs(save_directory, exist_ok=True)
        with open(os.path.join(save_directory, CONFIG_NAME), "w") as f:
            json.dump(self.config.to_dict(), f, indent=2)
        tmp = os.path.join(save_directory, "." + WEIGHTS_NAME + ".tmp")
        with open(tmp, "wb") as f:
            np.savez(f, **to_flat(self.decoder, params))
        os.replace(tmp, os.path.join(save_directory, WEIGHTS_NAME))

    def export_hf(self, save_directory: str):
        """An HF-loadable export (config.json + model.safetensors), so parity
        evals can run the model under transformers."""
        export_hf_checkpoint(to_flat(self.decoder), self.decoder.cfg,
                             self.config.base_model_name, save_directory)

    @classmethod
    def from_pretrained(cls, path: str, device: Union[str, torch.device] = DEFAULT_DEVICE,
                        **overrides) -> "UnitLM":
        """Load a checkpoint written by either package's save_pretrained, or
        by the reference toolkit (an HF directory with `config.json` and no
        `unit_lm_config.json`)."""
        cfg_path = os.path.join(path, CONFIG_NAME)
        if not os.path.isfile(cfg_path) and os.path.isfile(os.path.join(path, "config.json")):
            return cls._from_reference_checkpoint(path, device, **overrides)
        with open(cfg_path) as f:
            cfg = UnitLMConfig.from_dict({**json.load(f), **overrides})
        with np.load(os.path.join(path, WEIGHTS_NAME)) as flat:
            params = {k: flat[k] for k in flat.files}
        return cls(cfg, params=params, device=device)

    @classmethod
    def _from_reference_checkpoint(cls, path: str, device, **overrides) -> "UnitLM":
        """A checkpoint saved by the reference toolkit (model_type
        'speech_language_model'): the wrapped causal LM's weights live under
        the 'lm.' prefix, and the nested `base_config` gives the decoder's
        architecture where present (JAX `unit_lm.py:424`). The remat knobs
        of the overrides apply to that architecture too."""
        with open(os.path.join(path, "config.json")) as f:
            ref_cfg = json.load(f)
        if ref_cfg.get("model_type") not in (None, "speech_language_model"):
            raise ValueError(f"Not a reference UnitLM checkpoint: {path}")
        base_config = ref_cfg.get("base_config") or {}
        cfg = UnitLMConfig.from_dict({
            "base_model_name": ref_cfg.get("base_model_name", "facebook/opt-125m"),
            "vocab_size": ref_cfg.get("vocab_size", 502),
            "twist_init": ref_cfg.get("twist_init", True),
            "pad_token_id": ref_cfg.get("pad_token_id", 0),
            "bos_token_id": ref_cfg.get("bos_token_id", 1),
            "eos_token_id": ref_cfg.get("eos_token_id", 1),
            **overrides,
        })
        sd = load_hf_state_dict(path)
        sd = {(k[3:] if k.startswith("lm.") else k): v for k, v in sd.items()}
        if base_config.get("model_type"):
            kwargs = config_from_hf_dict(base_config)
            kwargs["vocab_size"] = cfg.vocab_size
            if cfg.torch_dtype not in ("bfloat16", None):
                kwargs["dtype"] = "float32"
            decoder_cfg = DecoderConfig(**kwargs, remat=cfg.remat,
                                        remat_policy=cfg.remat_policy,
                                        remat_layers=cfg.remat_layers)
        else:
            decoder_cfg = cfg.decoder_config()
        logger.info("Loading a reference-format UnitLM from %s", path)
        return cls(cfg, params=convert_state_dict(sd, decoder_cfg), device=device,
                   decoder_config=decoder_cfg)


def _plain(node) -> dict:
    """A composed config node (slamkit_tpu.config.ConfigNode) or a mapping as
    a plain dict, without importing the config composer."""
    if hasattr(node, "to_container"):
        return node.to_container()
    return dict(node)


def tlm_factory(cfg, device: Union[str, torch.device] = DEFAULT_DEVICE) -> UnitLM:
    """Build a UnitLM from the composed model config (`tlm_type`,
    `pretrained_model`, `config_args`)."""
    if cfg.tlm_type not in ("twist", "gslm"):
        raise ValueError(f"Unknown tlm type: {cfg.tlm_type}")
    args = _plain(cfg.config_args)
    if cfg.get("pretrained_model"):
        overrides = {k: args.get(k) for k in ("attn_implementation", "torch_dtype")}
        overrides["use_cache"] = args.get("use_cache", False)
        # the remat knobs (cli/train sets remat from training_args) hold on
        # a fine-tune or a cont_training start too
        overrides.update({k: args[k] for k in ("remat", "remat_policy", "remat_layers")
                          if args.get(k) is not None})
        return UnitLM.from_pretrained(cfg.pretrained_model, device=device, **overrides)
    return UnitLM(UnitLMConfig.from_dict(args), device=device)
