"""The generative metrics: speech continuation, GenPPL and the LLM judge.

Counterpart of `slamkit_tpu/metric/generative_metric.py` (`PromptDataset`
:75, `generate` :132, `_transcribe` :25, `asr_perplexity` :152,
`llm_as_judge` :197) with `_prefetch_batches`
(`metric/modelling_metric.py:79`): prompts are cropped to `prompt_length`
seconds (or, with alignment jsons, to the closest word end), decoded on a
bounded thread pool so host I/O overlaps the device, zero-padded into
batches with their lengths, and continued; `generate_kwargs` (temperature,
top_k, max_new_tokens, weight_quant, ...) pass through to `UnitLM.generate`
unchanged. GenPPL transcribes the continuations with Whisper and scores the
transcripts with a float32 text LM (perplexity = exp of the mean per-text
NLL) beside their auto-BLEU over NLTK's words; the judge transcribes prompt
and continuation and asks an LM for a \\boxed{n} rating. Whisper, the text
LM and the judge run on `torch_device`, the card unless the caller names
another device (`metric_utils.py`).
"""
from __future__ import annotations

import json
import logging
import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from glob import glob, iglob
from typing import List, Optional, Tuple

import numpy as np

from ..utils.audio import audio_info, load_audio
from ..utils.calculation_utils import calc_auto_bleu
from ..utils.device import DEFAULT_DEVICE, resolve_device
from ..utils.word_tokenize import NLTKWordTokenizer
from .metric_utils import get_judge, get_llm, get_llm_perplexity, get_whisper_pipeline

logger = logging.getLogger(__name__)


def get_cut_location(alignment: List[Tuple[str, float, float]], prompt_length: float) -> float:
    """The word END time closest to the requested prompt length."""
    endtimes = np.array([word[2] for word in alignment], dtype=np.float64)
    return float(endtimes[np.abs(endtimes - prompt_length).argmin()])


def is_shorter(file: str, min_file_length: float) -> bool:
    n_frames, sr = audio_info(file)
    return n_frames < min_file_length * sr


def _prefetch_batches(dataset, batch_size, num_workers):
    """Decode items on a bounded thread pool (a window of ~2 batches) so host
    audio I/O overlaps the device work; yields lists of items in order."""
    window = max(2 * batch_size, num_workers)
    with ThreadPoolExecutor(max(num_workers, 1)) as pool:
        futures = deque()
        idx = 0
        items = []
        while idx < len(dataset) or futures:
            while idx < len(dataset) and len(futures) < window:
                futures.append(pool.submit(dataset.__getitem__, idx))
                idx += 1
            items.append(futures.popleft().result())
            if len(items) == batch_size:
                yield items
                items = []
        if items:
            yield items


class PromptDataset:
    """Cropped audio prompts."""

    def __init__(self, glob_path, prompt_length=None, sample_rate=16000, num_files=None,
                 min_file_length=None, use_alignment=False, alignment_folder=None):
        self.prompt_length = prompt_length
        self.sample_rate = sample_rate
        if num_files is None:
            self.data = glob(glob_path, recursive=True)
            if min_file_length is not None:
                self.data = [f for f in self.data if not is_shorter(f, min_file_length)]
        else:
            self.data = []
            for path in iglob(glob_path, recursive=True):
                if len(self.data) >= num_files:
                    break
                if min_file_length is not None and is_shorter(path, min_file_length):
                    continue
                self.data.append(path)
        self.use_alignment = use_alignment
        self.alignment_folder = alignment_folder

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx):
        file = self.data[idx]
        audio = load_audio(file, self.sample_rate)
        if self.prompt_length is not None and not self.use_alignment:
            audio = audio[:int(self.prompt_length * self.sample_rate)]
        elif self.prompt_length is not None and self.use_alignment:
            with open(self.get_alignment_path(file)) as f:
                alignment = json.load(f)["aligned_text"]
            audio = audio[:int(get_cut_location(alignment, self.prompt_length)
                               * self.sample_rate)]
        return audio

    def get_alignment_path(self, file: str) -> str:
        if self.alignment_folder is None:
            return file.replace(".wav", ".json")
        basename = os.path.basename(file)
        return os.path.join(self.alignment_folder, basename[:basename.find(".")] + ".json")

    def batches(self, batch_size: int, num_workers: int = 8):
        """(zero-padded wavs [B, T] float32, lengths [B]) per batch."""
        for wavs in _prefetch_batches(self, batch_size, num_workers):
            lens = np.array([len(w) for w in wavs])
            out = np.zeros((len(wavs), int(lens.max())), dtype=np.float32)
            for i, w in enumerate(wavs):
                out[i, :len(w)] = w
            yield out, lens


def _prompt_dataset(data_path, num_files, prompt_length, sample_rate, min_file_length,
                    alignment_folder, use_alignment) -> PromptDataset:
    dataset = PromptDataset(data_path, num_files=num_files, prompt_length=prompt_length,
                            sample_rate=sample_rate, min_file_length=min_file_length,
                            alignment_folder=alignment_folder, use_alignment=use_alignment)
    if not len(dataset):
        raise ValueError(f"no samples found for {data_path}")
    return dataset


def generate(model, data_path: str, batch_size: int,
             used_tokens_modality: Optional[str] = None, prompt_length=None,
             min_file_length=None, alignment_folder=None, use_alignment=False,
             sample_rate=16000, num_files=None, num_workers: int = 8,
             pin_memory: bool = True, **generate_kwargs):
    """Batched speech continuation of the prompts matching `data_path` (a
    glob); returns {'generate': outputs, 'prompts': cropped prompt wavs}."""
    dataset = _prompt_dataset(data_path, num_files, prompt_length, sample_rate,
                              min_file_length, alignment_folder, use_alignment)
    res, prompts = [], []
    for audio, lens in dataset.batches(batch_size, num_workers):
        res.extend(model.generate(audio, lens, used_tokens_modality, **generate_kwargs))
        prompts.extend([a[:n] for a, n in zip(audio, lens)])
    return {"generate": res, "prompts": prompts}


def _transcribe(whisper_pipeline, wavs, batch_size: int) -> List[str]:
    """ASR over a batch, empty clips filtered out before the pipeline (they
    transcribe as ""); the pipeline's batch is capped at batch_size."""
    wavs = [np.asarray(w, dtype=np.float32) for w in wavs]
    keep = [i for i, w in enumerate(wavs) if w.size > 0]
    texts = [""] * len(wavs)
    if keep:
        outs = whisper_pipeline([wavs[i] for i in keep],
                                batch_size=min(len(keep), max(batch_size, 1)))
        for i, o in zip(keep, outs):
            texts[i] = o["text"]
    return texts


def asr_perplexity(model, data_path: str, batch_size: int, whisper_model: str,
                   llm_name_or_path: str, used_tokens_modality=None, prompt_length=None,
                   min_file_length=None, alignment_folder=None, use_alignment=False,
                   auto_bleu_n: int = 2, sample_rate=16000, num_files=None,
                   num_workers: int = 8, pin_memory: bool = True,
                   torch_device: Optional[str] = None, asr_backend: str = "torch",
                   asr_dtype: str = "float32", llm_backend: str = "torch", **generate_kwargs):
    """GenPPL: continue each prompt, transcribe the continuation with
    Whisper, and score the transcripts with the text LM: {"asr_perplexity":
    exp(mean NLL), "auto-belu-<n>": mean auto-BLEU, "generate", "prompts"}."""
    tokenizer = NLTKWordTokenizer()
    dataset = _prompt_dataset(data_path, num_files, prompt_length, sample_rate,
                              min_file_length, alignment_folder, use_alignment)
    device = resolve_device(torch_device or DEFAULT_DEVICE)
    whisper_pipeline = get_whisper_pipeline(whisper_model, device=device, backend=asr_backend,
                                            dtype=asr_dtype)
    llm, text_lm_tokeniser = get_llm(llm_name_or_path, device=device, backend=llm_backend)
    nlls, gen, prompts, bleus = [], [], [], []
    for audio, lens in dataset.batches(batch_size, num_workers):
        gen_res = model.generate(audio, lens, used_tokens_modality, **generate_kwargs)
        gen.extend(gen_res)
        prompts.extend([a[:n] for a, n in zip(audio, lens)])
        res_texts = _transcribe(whisper_pipeline, gen_res, batch_size)
        bleus.extend([calc_auto_bleu(t, tokenizer, auto_bleu_n) for t in res_texts])
        nlls.extend(get_llm_perplexity(llm, text_lm_tokeniser, res_texts, device=device))
    return {"asr_perplexity": float(np.exp(np.mean(nlls))),
            f"auto-belu-{auto_bleu_n}": float(np.mean(bleus)),
            "generate": gen, "prompts": prompts}


def llm_as_judge(model, data_path: str, batch_size: int, whisper_model: str,
                 llm_name_or_path: str, instruction: str, used_tokens_modality=None,
                 prompt_length=None, min_file_length=None, alignment_folder=None,
                 use_alignment=False, sample_rate=16000, num_files=None, num_workers: int = 8,
                 pin_memory: bool = True, torch_device: Optional[str] = None,
                 asr_backend: str = "torch", asr_dtype: str = "float32",
                 llm_backend: str = "torch", **generate_kwargs):
    """Continue each prompt, transcribe prompt and continuation, fill them
    into `instruction` and ask the judge for a \\boxed{n} rating:
    {"llm_as_judge": mean rating, "generate", "prompts",
    "audio_transcription": [(prompt text, continuation text)]}."""
    dataset = _prompt_dataset(data_path, num_files, prompt_length, sample_rate,
                              min_file_length, alignment_folder, use_alignment)
    for key in ("[prompt_audio_transcription]", "[generated_audio_transcription]"):
        if key not in (instruction or ""):
            raise ValueError(f"llm_as_judge's instruction must hold {key}")
    device = resolve_device(torch_device or DEFAULT_DEVICE)
    whisper_pipeline = get_whisper_pipeline(whisper_model, device=device, backend=asr_backend,
                                            dtype=asr_dtype)
    judge = get_judge(llm_name_or_path, device=device, batch_size=batch_size,
                      backend=llm_backend)
    gen, prompts, texts, prompt_texts, gen_texts = [], [], [], [], []
    for audio, lens in dataset.batches(batch_size, num_workers):
        gen_res = model.generate(audio, lens, used_tokens_modality, remove_prompt=True,
                                 **generate_kwargs)
        gen.extend(gen_res)
        prompts.extend([a[:n] for a, n in zip(audio, lens)])
        p_texts = _transcribe(whisper_pipeline, [a[:n] for a, n in zip(audio, lens)],
                              batch_size)
        g_texts = _transcribe(whisper_pipeline, gen_res, batch_size)
        texts.extend(instruction.replace("[prompt_audio_transcription]", p)
                     .replace("[generated_audio_transcription]", g)
                     for p, g in zip(p_texts, g_texts))
        prompt_texts.extend(p_texts)
        gen_texts.extend(g_texts)
    res = [r for r in judge(texts) if r is not None]
    logger.info("got response for %d out of %d", len(res), len(dataset))
    return {"llm_as_judge": float(np.mean(res)) if res else float("nan"),
            "generate": gen, "prompts": prompts,
            "audio_transcription": list(zip(prompt_texts, gen_texts))}
