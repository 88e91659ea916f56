"""Speech continuation: cropped WAV prompts through `SpeechLM.generate`.

Counterpart of the generate path of `slamkit_tpu/metric/generative_metric.py`
(`PromptDataset` :75, `generate` :132) with `_prefetch_batches`
(`metric/modelling_metric.py:79`): prompts are cropped to `prompt_length`
seconds (or, with alignment jsons, to the closest word end), decoded on a
bounded thread pool so host I/O overlaps the device, zero-padded into
batches with their lengths, and continued; `generate_kwargs` (temperature,
top_k, max_new_tokens, weight_quant, ...) pass through to `UnitLM.generate`
unchanged. ASR perplexity and the LLM judge are not ported.
"""
from __future__ import annotations

import json
import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from glob import glob, iglob
from typing import List, Optional, Tuple

import numpy as np

from ..utils.audio import audio_info, load_audio


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


def generate(model, data_path: str, batch_size: int,
             used_tokens_modality: Optional[str] = None, prompt_length=None,
             min_file_length=None, alignment_folder=None, use_alignment=False,
             sample_rate=16000, num_files=None, num_workers: int = 8,
             pin_memory: bool = True, **generate_kwargs):
    """Batched speech continuation of the prompts matching `data_path` (a
    glob); returns {'generate': outputs, 'prompts': cropped prompt wavs}."""
    dataset = PromptDataset(data_path, prompt_length=prompt_length, sample_rate=sample_rate,
                            num_files=num_files, min_file_length=min_file_length,
                            alignment_folder=alignment_folder, use_alignment=use_alignment)
    assert len(dataset) > 0, f"no samples found for {data_path}"
    res, prompts = [], []
    for audio, lens in dataset.batches(batch_size, num_workers):
        res.extend(model.generate(audio, lens, used_tokens_modality, **generate_kwargs))
        prompts.extend([a[:n] for a, n in zip(audio, lens)])
    return {"generate": res, "prompts": prompts}
