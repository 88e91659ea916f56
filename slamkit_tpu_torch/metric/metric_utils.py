"""The generative metrics' scoring components: Whisper, the text LM's
perplexity and the LLM judge.

Counterpart of `slamkit_tpu/metric/metric_utils.py`: `get_whisper_pipeline`
(:22), `get_llm` (:44), `get_llm_perplexity` (:72, and its misspelled
`get_llm_preplexity` alias), `extract_digit_from_boxed`, `judge_text`,
`LLMJudge`, `OpenAIJudge` and `get_judge` (:173). The JAX package chooses
between transformers' torch pipelines (backend "torch") and its own stack
(backend "jax"); the card's host has no transformers, so on the port both
names select the port's own Whisper (`metric/whisper.py`) and the port's
`UnitLM` built from the HF directory's `config.json`, `tokenizer.json` and
weights (`presets.resolve_base_config`, `hf_convert.convert_state_dict`), in
float32 as the JAX package runs it; any other name raises. HF's pipeline
heuristics (language detection, fp16, its long-form merge) are not
reproduced. The judge's and text LM's tokeniser is the port's tokenizer.json
reader, with pad = eos where the tokenizer has no pad token.

Unlike the JAX package, `get_llm` raises where the directory holds no
weights: the JAX path falls back to random init with a warning
(`slamkit_tpu/models/hf_convert.py:346-352`), which would score with a
random LM. The judge's sampling draws come from the port's own
`torch.Generator` (seeded where a seed is given): `jax.random` streams
cannot be reproduced.
"""
from __future__ import annotations

import json
import logging
import os
import re
from typing import List, Optional, Union

import numpy as np
import torch

from ..models.hf_convert import convert_state_dict, load_hf_state_dict, resize_embeddings
from ..models.unit_lm import UnitLM, UnitLMConfig
from ..tokeniser.text_tokeniser import TextTokeniser
from ..utils.device import DEFAULT_DEVICE

logger = logging.getLogger(__name__)

OPENAI_MODELS = ["gpt-3.5-turbo", "gpt-4", "gpt-4o"]
BACKENDS = ("torch", "jax")


def check_backend(kind: str, backend: str) -> None:
    """`torch` and `jax` both name the port's own implementation; anything
    else raises."""
    if backend not in BACKENDS:
        raise NotImplementedError(
            f"{kind}={backend!r}: the port runs its own "
            f"{'Whisper' if kind == 'asr_backend' else 'text LM'} for {BACKENDS}, and no other")


def get_whisper_pipeline(model_id: str, device: Union[str, torch.device] = DEFAULT_DEVICE,
                         backend: str = "torch", dtype: str = "float32"):
    """The port's Whisper pipeline over the local checkpoint `model_id`, on
    `device`, computing in `dtype` (float32 or bfloat16)."""
    from .whisper import WhisperPipeline

    check_backend("asr_backend", backend)
    logger.info("asr_backend=%s: the port's own Whisper (metric/whisper.py) runs; "
                "transformers' pipeline is not used", backend)
    return WhisperPipeline(model_id, dtype=dtype, device=device)


def _read_config(model_id: str) -> dict:
    path = os.path.join(model_id, "config.json")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no config.json in {model_id!r}: the text LM is read from a "
                                f"local HF directory (nothing is downloaded)")
    with open(path) as f:
        return json.load(f)


def get_llm(model_id: str, device: Union[str, torch.device] = DEFAULT_DEVICE,
            backend: str = "torch"):
    """(UnitLM in float32 with the HF directory's weights, its tokeniser).
    Raises where the directory holds no weights."""
    check_backend("llm_backend", backend)
    logger.info("llm_backend=%s: the port's own float32 UnitLM runs %s; transformers' "
                "AutoModelForCausalLM is not used", backend, model_id)
    tokeniser = TextTokeniser.from_pretrained(model_id)
    if tokeniser.pad_token_id is None:
        tokeniser.pad_token_id = tokeniser.eos_token_id
    hf = _read_config(model_id)
    cfg = UnitLMConfig(base_model_name=model_id, vocab_size=hf["vocab_size"], twist_init=False,
                       pad_token_id=tokeniser.pad_token_id, torch_dtype="float32")
    decoder_cfg = cfg.decoder_config()
    try:
        sd = load_hf_state_dict(model_id)
    except FileNotFoundError as e:
        raise FileNotFoundError(f"get_llm: no weights in {model_id!r} ({e}); the port does not "
                                f"score with a randomly initialised LM") from e
    params = resize_embeddings(convert_state_dict(sd, decoder_cfg), decoder_cfg, hf["vocab_size"])
    del sd
    return UnitLM(cfg, params=params, device=device, decoder_config=decoder_cfg), tokeniser


def get_llm_perplexity(model: UnitLM, tokeniser: TextTokeniser, text: List[str],
                       device=None) -> np.ndarray:
    """Per-sequence mean NLL of each text under the text LM: pads
    (pad_token_id) excluded, empty rows clamped to one token."""
    enc = tokeniser(text, padding=True, return_tensors="np")
    ids = enc["input_ids"].astype(np.int32)
    return -model.log_likelihood(ids, mean_nll=True).float().cpu().numpy()


# kept under the reference's (misspelled) name
get_llm_preplexity = get_llm_perplexity


def extract_digit_from_boxed(string: str):
    match = re.search(r"\\boxed\{(\d+)\}", string)
    return int(match.group(1)) if match else None


def judge_text(model: UnitLM, tokeniser: TextTokeniser, text: List[str], device=None,
               generator: Optional[torch.Generator] = None) -> list:
    """Left-padded prompts, 512 sampled new tokens at temperature 0.8, the
    \\boxed{n} score of each decoded output (None where there is none)."""
    tokeniser.padding_side = "left"
    enc = tokeniser(text, return_tensors="np", padding=True)
    generation = model.generate(enc["input_ids"].astype(np.int32),
                                attention_mask=enc["attention_mask"].astype(np.int32),
                                max_new_tokens=512, do_sample=True, temperature=0.8,
                                generator=generator)
    decode = tokeniser.batch_decode(generation.cpu().numpy(), skip_special_tokens=True)
    return [extract_digit_from_boxed(t) for t in decode]


class LLMJudge:
    """A local LM as judge. Its sampling draws from `generator` where the
    caller gives one, else from torch's default generator."""

    def __init__(self, model: UnitLM, tokeniser: TextTokeniser, device, batch_size: int,
                 generator: Optional[torch.Generator] = None):
        self.model = model
        self.tokeniser = tokeniser
        self.device = device
        self.batch_size = batch_size
        self.generator = generator

    def __call__(self, texts: List[str]) -> List:
        res = []
        for i in range(0, len(texts), self.batch_size):
            res.extend(judge_text(self.model, self.tokeniser, texts[i:i + self.batch_size],
                                  self.device, generator=self.generator))
        return res


class OpenAIJudge:
    """A judge behind OpenAI's API: needs the `openai` package and the
    network, which the card's host has neither of."""

    def __init__(self, name: str):
        try:
            from openai import OpenAI
        except ImportError as e:
            raise ImportError(f"judge {name!r} is an OpenAI model and needs the openai package, "
                              f"which is not installed; give metric.llm_name_or_path a local "
                              f"HF directory to judge with a local LM") from e
        self.client = OpenAI(api_key=os.environ["OPENAI_API_KEY"])
        self.model_name = name

    def __call__(self, texts: List[str]) -> List:
        res = []
        for text in texts:
            try:
                completion = self.client.chat.completions.create(
                    model=self.model_name, messages=[{"role": "user", "content": text}])
            except Exception as e:  # log and skip, as the reference does
                logger.error("Error: %s", e)
                continue
            res.append(extract_digit_from_boxed(completion.choices[0].message.content))
        return res


def get_judge(name: str, device, batch_size: int, backend: str = "torch"):
    """An OpenAI judge for OpenAI model names, else an LLMJudge over the local
    HF directory `name`, whose eos and pad are put into the model's config
    so that generation stops at the judge's own eos."""
    if name in OPENAI_MODELS:
        return OpenAIJudge(name)
    model, tokeniser = get_llm(name, device, backend=backend)
    eos = tokeniser.eos_token_id
    if eos is None:
        eos = _read_config(name).get("eos_token_id")
    if isinstance(eos, (list, tuple)):      # qwen-style multi-eos configs
        eos = eos[0]
    model.config.eos_token_id = int(eos)
    model.config.pad_token_id = int(tokeniser.pad_token_id)
    return LLMJudge(model, tokeniser, device, batch_size)
