"""Likelihood-pair modelling metrics: sWUGGY / sBLIMP / StoryCloze / SALMon.

A copy of `slamkit_tpu/metric/modelling_metric.py` (the two datasets,
`_pad_batch`, `_prefetch_batches`, `modelling_metric` and the four metrics),
which the port cannot import: the JAX package's modules pull jax in through
their package. Dataset layouts and the 1/0.5/0 tie rule are the reference's:
wav pairs sorted by numeric filename prefix with separator '_'
(swuggy/storycloze) or '+' (sblimp); SALMon groups `*_{idx}_*.wav` per sample
index. Audio is read by the port's `utils/audio.py` (WAV); batches are padded
on the host and scored with `SpeechLM.log_likelihood` on the model's device,
and the scores come back to the host once, at the end.
"""
from __future__ import annotations

import logging
from pathlib import Path
from typing import List, Optional

import numpy as np

from ..utils.audio import load_audio

logger = logging.getLogger(__name__)


class ModellingMetricDataset:
    """Consecutive (pos, neg) wav pairs (reference modelling_metric.py:12-30)."""

    def __init__(self, path, sep="_", subfolder=True, sample_rate=16000):
        self.sample_rate = sample_rate
        self.data: List[Path] = []
        if subfolder:
            for f in Path(path).iterdir():
                if f.is_dir():
                    self.data += sorted(f.glob("*.wav"),
                                        key=lambda x: int(x.name.split(sep)[0]))
        else:
            self.data += sorted(Path(path).glob("*.wav"),
                                key=lambda x: int(x.name.split(sep)[0]))

    def __len__(self):
        return len(self.data) // 2

    def __getitem__(self, idx):
        pos = load_audio(str(self.data[2 * idx]), self.sample_rate)
        neg = load_audio(str(self.data[2 * idx + 1]), self.sample_rate)
        return pos, neg


class SalmonDataset:
    """Groups `*_{idx}_*.wav` by sample index; item = (first, second) sorted
    (reference modelling_metric.py:33-68)."""

    def __init__(self, path, part, sample_rate=16000):
        self.sample_rate = sample_rate
        dir_path = Path(path) / part
        paths = list(dir_path.glob("*.wav"))
        groups: dict = {}
        for p in paths:
            sample_index = int(p.stem.split("_")[1])
            groups.setdefault(sample_index, []).append(str(p))
        self.data = [sorted(groups[k]) for k in sorted(groups)]

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx):
        files = self.data[idx]
        pos = load_audio(files[0], self.sample_rate)
        neg = load_audio(files[1], self.sample_rate)
        return pos, neg


def _pad_batch(wavs: List[np.ndarray]):
    lens = np.array([len(w) for w in wavs])
    out = np.zeros((len(wavs), int(lens.max())), dtype=np.float32)
    for i, w in enumerate(wavs):
        out[i, :len(w)] = w
    return out, lens


def _prefetch_batches(dataset, batch_size, num_workers):
    """Decode wav pairs on a bounded thread pool so host audio I/O overlaps
    the device scoring (window of ~2 batches; the reference gets this from
    torch DataLoader workers)."""
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

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


def _host(ll) -> np.ndarray:
    """Scores as a host array (a torch tensor on any device, or array-like)."""
    if hasattr(ll, "detach"):
        return ll.detach().float().cpu().numpy()
    return np.asarray(ll)


def modelling_metric(model, dataset, used_token_modality,
                     mean_nll: bool = True, batch_size: int = 1,
                     num_workers: int = 8, pin_memory: bool = True,
                     joint_pairs: bool = False) -> float:
    """Score = mean of 1/0.5/0 for pos >/=/< neg likelihood
    (reference modelling_metric.py:79-99).

    joint_pairs scores pos and neg in ONE [2*batch] log_likelihood call
    (half the calls, but the pair shares one padded wav length, so more
    padded feature-extractor work; opt-in)."""
    # likelihoods stay on the device until the end: pulling each batch back
    # would block the host on every call
    deferred = []
    for items in _prefetch_batches(dataset, batch_size, num_workers):
        if joint_pairs:
            n = len(items)
            wavs, lens = _pad_batch([it[0] for it in items]
                                    + [it[1] for it in items])
            ll = model.log_likelihood(
                wavs, lens, mean_nll=mean_nll,
                used_token_modality=used_token_modality)
            deferred.append((n, ll, None))
        else:
            pos, l_pos = _pad_batch([it[0] for it in items])
            neg, l_neg = _pad_batch([it[1] for it in items])
            pos_ll = model.log_likelihood(
                pos, l_pos, mean_nll=mean_nll, used_token_modality=used_token_modality)
            neg_ll = model.log_likelihood(
                neg, l_neg, mean_nll=mean_nll, used_token_modality=used_token_modality)
            deferred.append((len(items), pos_ll, neg_ll))
    results = []
    for n, a, b in deferred:
        if b is None:
            ll = _host(a)
            pos_ll, neg_ll = ll[:n], ll[n:]
        else:
            pos_ll, neg_ll = _host(a), _host(b)
        results.append(np.where(pos_ll > neg_ll, 1.0,
                                np.where(pos_ll == neg_ll, 0.5, 0.0)))
    return float(np.concatenate(results).mean())


def swuggy(model, data_path, used_token_modality, mean_nll=True, batch_size=1,
           num_workers=8, pin_memory=True, subfolder=False,
           joint_pairs=False):
    dataset = ModellingMetricDataset(data_path, sep="_", subfolder=subfolder)
    assert len(dataset) > 0, f"no samples found for {data_path}"
    res = modelling_metric(model, dataset, used_token_modality, mean_nll,
                           batch_size, num_workers, pin_memory,
                           joint_pairs=joint_pairs)
    logger.info("sWUGGY: %.4f", res)
    return {"sWUGGY": res}


def sblimp(model, data_path, used_token_modality, mean_nll=True, batch_size=1,
           num_workers=8, pin_memory=True, subfolder=False,
           joint_pairs=False):
    dataset = ModellingMetricDataset(data_path, sep="+", subfolder=subfolder)
    assert len(dataset) > 0, f"no samples found for {data_path}"
    res = modelling_metric(model, dataset, used_token_modality, mean_nll,
                           batch_size, num_workers, pin_memory,
                           joint_pairs=joint_pairs)
    logger.info("sBLIMP: %.4f", res)
    return {"sBLIMP": res}


def storycloze(model, data_path, used_token_modality, mean_nll=True,
               batch_size=1, num_workers=8, pin_memory=True, subfolder=False,
               joint_pairs=False):
    dataset = ModellingMetricDataset(data_path, sep="_", subfolder=subfolder)
    assert len(dataset) > 0, f"no samples found for {data_path}"
    res = modelling_metric(model, dataset, used_token_modality, mean_nll,
                           batch_size, num_workers, pin_memory,
                           joint_pairs=joint_pairs)
    logger.info("StoryCloze: %.4f", res)
    return {"StoryCloze": res}


SALMON_ALL_PARTS = [
    "bg_alignment/", "bg_all_consistency/", "bg_domain_consistency/",
    "gender_consistency/", "rir_consistency/", "sentiment_alignment/",
    "sentiment_consistency/", "speaker_consistency/",
]


def salmon(model, salmon_path, used_token_modality, mean_nll, parts,
           batch_size, num_workers=8, pin_memory=True, joint_pairs=False):
    if parts[0] == "all":
        parts = SALMON_ALL_PARTS
    out = {}
    for part in parts:
        dataset = SalmonDataset(salmon_path, part)
        assert len(dataset) > 0, f"no samples found for {part}"
        cur = modelling_metric(model, dataset, used_token_modality, mean_nll,
                               batch_size, num_workers, pin_memory,
                               joint_pairs=joint_pairs)
        logger.info("SALMon - %s: %.4f", part, cur)
        out[part] = cur
    return out
