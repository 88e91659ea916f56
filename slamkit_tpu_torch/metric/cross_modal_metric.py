"""Cross-modal StoryCloze: (mutual, correct, incorrect) triples whose prompt
and continuations each come as TEXT or SPEECH.

A copy of `slamkit_tpu/metric/cross_modal_metric.py`: `CrossModalMetricDataset`
reads `<base>_correct.wav` and its siblings (`_mutual`, `_incorrect`, each a
`.txt` or a `.wav` by modality); when prompt and continuation are both
SPEECH, the wavs are joined so the feature extractor encodes them together.
`cm_storycloze` scores each side's GenerationInput list with
`SpeechLM.log_likelihood` and keeps the 1 / 0.5 / 0 rule for correct >, =, <
incorrect (:61-75).
"""
from __future__ import annotations

import logging
from pathlib import Path
from typing import List

import numpy as np

from ..tokeniser.interleaving_tokeniser import GenerationInput
from ..utils.audio import load_audio
from .modelling_metric import _host, _prefetch_batches

logger = logging.getLogger(__name__)


class CrossModalMetricDataset:
    def __init__(self, path, subfolder=True, prompt_modality="TEXT",
                 cont_modality="SPEECH", sample_rate=16000):
        self.data: List[Path] = []
        if subfolder:
            for f in Path(path).iterdir():
                if f.is_dir():
                    self.data += f.glob("*_correct.wav")
        else:
            self.data += Path(path).glob("*_correct.wav")
        self.prompt_modality = prompt_modality
        self.cont_modality = cont_modality
        self.sample_rate = sample_rate

    def __len__(self):
        return len(self.data)

    @staticmethod
    def _load_text(txt_file):
        with open(txt_file) as f:
            return f.read().strip()

    def _load(self, mod, txt_path, audio_path):
        if mod == "TEXT":
            return self._load_text(txt_path)
        return load_audio(audio_path, self.sample_rate)

    def __getitem__(self, idx):
        base = str(self.data[idx]).split("_correct.wav")[0]
        prompt = self._load(self.prompt_modality, base + "_mutual.txt", base + "_mutual.wav")
        pos = self._load(self.cont_modality, base + "_correct.txt", base + "_correct.wav")
        neg = self._load(self.cont_modality, base + "_incorrect.txt", base + "_incorrect.wav")
        if self.prompt_modality == "SPEECH" and self.cont_modality == "SPEECH":
            pos_sample = [(self.prompt_modality, np.concatenate([prompt, pos]))]
            neg_sample = [(self.prompt_modality, np.concatenate([prompt, neg]))]
        else:
            pos_sample = [(self.prompt_modality, prompt), (self.cont_modality, pos)]
            neg_sample = [(self.prompt_modality, prompt), (self.cont_modality, neg)]
        return ([GenerationInput.from_tuple(t) for t in pos_sample],
                [GenerationInput.from_tuple(t) for t in neg_sample])


def _modelling_metric(model, dataset, used_token_modality, mean_nll=True,
                      batch_size=1, num_workers=8) -> float:
    results = []
    for items in _prefetch_batches(dataset, batch_size, num_workers):
        pos_ll = _host(model.log_likelihood([it[0] for it in items],
                                            used_token_modality=used_token_modality,
                                            mean_nll=mean_nll))
        neg_ll = _host(model.log_likelihood([it[1] for it in items],
                                            used_token_modality=used_token_modality,
                                            mean_nll=mean_nll))
        results.append(np.where(pos_ll > neg_ll, 1.0, np.where(pos_ll == neg_ll, 0.5, 0.0)))
    return float(np.concatenate(results).mean())


def cm_storycloze(model, data_path, prompt_modality, cont_modality,
                  used_token_modality=None, mean_nll=True, batch_size=1,
                  num_workers=8, pin_memory=True, subfolder=False):
    """{"StoryCloze": score}; pin_memory is accepted for the config's sake."""
    dataset = CrossModalMetricDataset(data_path, prompt_modality=prompt_modality,
                                      cont_modality=cont_modality, subfolder=subfolder)
    if not len(dataset):
        raise AssertionError(f"no samples found for {data_path}")
    res = _modelling_metric(model, dataset, used_token_modality, mean_nll, batch_size,
                            num_workers)
    logger.info("StoryCloze: %.4f", res)
    return {"StoryCloze": res}
