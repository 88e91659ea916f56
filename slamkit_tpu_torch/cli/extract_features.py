"""Stage 1 on the port: audio files -> features jsonl {units, duration, file_name}.

    python -m slamkit_tpu_torch.cli.extract_features data_path=<audio dir> [ext=flac] \
        out_path=<features.jsonl> tokeniser.feature_extractor.pretrained_model=<HuBERT dir> \
        tokeniser.feature_extractor.kmeans_path=<centroids.npy> [device=cpu]

The counterpart of `cli/extract_features.py`, on the repo's `config/` tree
(extract_features.yaml): a recursive glob by `ext`, the files sorted by
duration, longest first (a batch that does not fit fails at once), an
optional pickle cache of that list under `cache_path`, data_skip /
data_take, decoding on a thread pool with a bounded prefetch of about two
batches, batched `audio_represent`, lines appended to out_path. Every
`device` but `cpu` (the YAML's `tpu` included) runs on the CUDA card. Audio
is read by `utils/audio.py`: the native libav decoder reads the YAML's
default `ext: flac` and every other format libav reads; where it cannot be
built, WAV alone is read.
"""
import json
import logging
import os
import pickle
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from glob import iglob
from typing import Optional

import numpy as np

from ..config import main
from ..utils.audio import audio_info, load_audio

logger = logging.getLogger(__name__)


class WavDataset:
    """A folder's audio files of one extension, longest first."""

    def __init__(self, data_path: str, ext: str = "flac", cache_path: Optional[str] = None,
                 sample_rate: int = 16000, n_workers: int = 16):
        self.sample_rate = sample_rate
        save_path = None
        if cache_path is not None:
            os.makedirs(cache_path + "/data/", exist_ok=True)
            save_path = f"{cache_path}/data/{data_path.rstrip('/').split('/')[-1]}.pkl"
            if os.path.exists(save_path):
                with open(save_path, "rb") as f:
                    self.files = pickle.load(f)
                return
        files = list(iglob(os.path.join(data_path, f"**/*.{ext}"), recursive=True))
        with ThreadPoolExecutor(n_workers) as pool:
            metas = list(pool.map(lambda p: (p, audio_info(p)[0]), files))
        self.files = sorted(metas, key=lambda x: x[1], reverse=True)
        if save_path:
            with open(save_path, "wb") as f:
                pickle.dump(self.files, f)

    def __len__(self):
        return len(self.files)

    def skip(self, n: int):
        self.files = self.files[n:]

    def take(self, n: int):
        self.files = self.files[:n]

    def load(self, idx: int):
        f_name, _ = self.files[idx]
        return f_name, load_audio(f_name, self.sample_rate)

    def batches(self, batch_size: int, n_workers: int = 4):
        """(file names, wav [B, Tmax] zero-padded, lens), decoded ahead by at
        most max(2 batches, n_workers) files."""
        window = max(2 * batch_size, n_workers)
        with ThreadPoolExecutor(n_workers) as pool:
            futures = deque()
            idx = 0
            batch = []
            while idx < len(self) or futures:
                while idx < len(self) and len(futures) < window:
                    futures.append(pool.submit(self.load, idx))
                    idx += 1
                batch.append(futures.popleft().result())
                if len(batch) == batch_size:
                    yield self._collate(batch)
                    batch = []
            if batch:
                yield self._collate(batch)

    @staticmethod
    def _collate(batch):
        names = [b[0] for b in batch]
        lens = np.array([len(b[1]) for b in batch])
        wav = np.zeros((len(batch), int(lens.max())), dtype=np.float32)
        for i, (_, w) in enumerate(batch):
            wav[i, :len(w)] = w
        return names, wav, lens


@main(config_name="extract_features", config_path="../../config")
def extract_features(cfg):
    from ..tokeniser import tokeniser_factory
    from ..utils.device import DEFAULT_DEVICE

    ds = WavDataset(cfg.data_path, cfg.ext, cfg.cache_path, cfg.sample_rate)
    device = "cpu" if cfg.get("device", None) == "cpu" else DEFAULT_DEVICE
    tokeniser = tokeniser_factory(cfg.tokeniser, device=device)
    if cfg.get("data_skip", None) is not None:
        ds.skip(cfg.data_skip)
    if cfg.get("data_take", None) is not None:
        ds.take(cfg.data_take)
    if os.path.exists(cfg.out_path):
        logger.warning("%s already exists. Appending to it.", cfg.out_path)
    os.makedirs(os.path.dirname(os.path.abspath(cfg.out_path)), exist_ok=True)
    written = 0
    with open(cfg.out_path, "a+") as out_file:
        for names, wav, lens in ds.batches(cfg.batch_size, cfg.num_workers):
            reprs = tokeniser.audio_represent(wav, lens)
            for cur_f, cur_repr in zip(names, reprs):
                cur_repr["file_name"] = cur_f
                out_file.write(json.dumps(cur_repr) + "\n")
                written += 1
    return written


if __name__ == "__main__":
    extract_features()
