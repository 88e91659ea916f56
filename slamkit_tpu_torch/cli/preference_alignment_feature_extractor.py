"""Preference stage 1 on the port: {prompt, chosen, rejected} WAV triples ->
a preference features jsonl.

    python -m slamkit_tpu_torch.cli.preference_alignment_feature_extractor \
        data_path=<triples.jsonl> out_path=<pref_features.jsonl> \
        tokeniser.feature_extractor.pretrained_model=<HuBERT dir> \
        tokeniser.feature_extractor.kmeans_path=<centroids.npy> [device=cpu]

The counterpart of `cli/preference_alignment_feature_extractor.py`, on the
repo's `config/` tree (preference_alignment_feature_extractor.yaml). Each
input row names `prompt_path`, `chosen_path` and `rejected_path`; a batch of
rows goes through the feature extractor as one pass over its prompts, then
its chosens, then its rejecteds (padded to the longest), split back in
thirds, and each row is written with `prompt`, `chosen` and `rejected` unit
dicts added. skip / take select rows. Every `device` but `cpu`
(the YAML's `tpu` included) runs on the CUDA card. Audio is read as WAV.
"""
import json
import logging
import os

import numpy as np

from ..config import main
from ..utils.audio import load_audio

logger = logging.getLogger(__name__)


class PreferenceAlignmentDataset:
    def __init__(self, data_path: str, sample_rate: int = 16000):
        self.sample_rate = sample_rate
        with open(data_path) as f:
            self.preference_data = [json.loads(line) for line in f if line.strip()]

    def __len__(self):
        return len(self.preference_data)

    def subsample_data(self, skip, take):
        if skip is not None:
            self.preference_data = self.preference_data[skip:]
        if take is not None:
            self.preference_data = self.preference_data[:take]

    def batches(self, batch_size: int):
        """(rows, wav [3 x rows, Tmax], lens): prompts, chosens, rejecteds."""
        for start in range(0, len(self), batch_size):
            rows = self.preference_data[start:start + batch_size]
            wavs = []
            for key in ("prompt_path", "chosen_path", "rejected_path"):
                wavs += [load_audio(r[key], self.sample_rate) for r in rows]
            lens = np.array([len(w) for w in wavs])
            batch = np.zeros((len(wavs), int(lens.max())), dtype=np.float32)
            for i, w in enumerate(wavs):
                batch[i, :len(w)] = w
            yield rows, batch, lens


@main(config_name="preference_alignment_feature_extractor", config_path="../../config")
def extract_features(cfg):
    from ..tokeniser import tokeniser_factory
    from ..utils.device import DEFAULT_DEVICE

    device = "cpu" if cfg.get("device", None) == "cpu" else DEFAULT_DEVICE
    tokeniser = tokeniser_factory(cfg.tokeniser, device=device)
    dataset = PreferenceAlignmentDataset(cfg.data_path, cfg.sample_rate)
    dataset.subsample_data(cfg.get("skip", None), cfg.get("take", None))
    os.makedirs(os.path.dirname(os.path.abspath(cfg.out_path)), exist_ok=True)
    with open(cfg.out_path, "w") as f:
        for rows, wavs, lens in dataset.batches(cfg.batch_size):
            n = len(rows)
            tokenised = tokeniser.audio_represent(wavs, lens)
            for i, row in enumerate(rows):
                row["prompt"] = tokenised[i]
                row["chosen"] = tokenised[n + i]
                row["rejected"] = tokenised[2 * n + i]
                f.write(json.dumps(row) + "\n")
    return len(dataset)


if __name__ == "__main__":
    extract_features()
