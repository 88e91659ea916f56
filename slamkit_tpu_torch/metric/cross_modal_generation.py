"""Cross-modal generation: WAV or one-line text prompts continued in a
forced output modality.

A copy of `slamkit_tpu/metric/cross_modal_generation.py`: prompt files
collected by a recursive glob (at most `num_files`), SPEECH prompts cropped
to `prompt_length` seconds, each item a one-element GenerationInput list
(`CrossModalPromptDataset`); `generate` continues them in batches through
`SpeechLM.generate` and returns the results beside their prompts.
"""
from __future__ import annotations

import itertools
import logging
from glob import iglob
from typing import List, Optional

from ..tokeniser.interleaving_tokeniser import GenerationInput
from ..utils.audio import load_audio

logger = logging.getLogger(__name__)


def _collect(glob_path: str, limit: Optional[int]) -> List[str]:
    paths = iglob(glob_path, recursive=True)
    if limit is not None:
        paths = itertools.islice(paths, limit)
    return list(paths)


def _speech_prompt(path: str, sample_rate: int, crop_s) -> GenerationInput:
    wav = load_audio(path, sample_rate)
    if crop_s is not None:
        wav = wav[: int(crop_s * sample_rate)]
    return GenerationInput.from_tuple(("SPEECH", wav))


def _text_prompt(path: str, sample_rate: int, crop_s) -> GenerationInput:
    with open(path) as f:
        return GenerationInput.from_tuple(("TEXT", f.read().strip()))


_LOADERS = {"SPEECH": _speech_prompt, "TEXT": _text_prompt}


class CrossModalPromptDataset:
    """Prompt files matched by a recursive glob; each item is a one-element
    GenerationInput list."""

    def __init__(self, glob_path, prompt_length=None, prompt_modality="TEXT",
                 sample_rate=16000, num_files=None):
        if prompt_modality not in _LOADERS:
            raise ValueError(f"Unknown prompt modality {prompt_modality}")
        self.data = _collect(glob_path, num_files)
        self.prompt_modality = prompt_modality
        self.prompt_length = prompt_length  # seconds; audio prompts only
        self.sample_rate = sample_rate

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx):
        loader = _LOADERS[self.prompt_modality]
        return [loader(self.data[idx], self.sample_rate, self.prompt_length)]


def generate(model, data_path: str, batch_size: int,
             prompt_modality: Optional[str] = None,
             output_modality: Optional[str] = None,
             prompt_length: Optional[int] = None, sample_rate: int = 16000,
             num_files: Optional[int] = None, num_workers: int = 8,
             pin_memory: bool = True, **generate_kwargs):
    """{"generate": continuations, "prompts": their prompts}. num_workers and
    pin_memory are accepted for the config's sake; prompts load on the host."""
    ds = CrossModalPromptDataset(data_path, prompt_modality=prompt_modality,
                                 prompt_length=prompt_length,
                                 sample_rate=sample_rate, num_files=num_files)
    if not len(ds):
        raise AssertionError(f"no samples found for {data_path}")
    outputs, prompts = [], []
    for lo in range(0, len(ds), batch_size):
        chunk = [ds[i] for i in range(lo, min(lo + batch_size, len(ds)))]
        prompts.extend(chunk)
        outputs.extend(model.generate(chunk, output_modality=output_modality,
                                      **generate_kwargs))
    return {"generate": outputs, "prompts": prompts}
