"""Named vocoder checkpoints resolved to local files.

Counterpart of `slamkit_tpu/vocoder/checkpoint_manager.py` (the textlesslib
registry) for the CodeHiFiGAN entries: a name maps to a file name under
$TEXTLESS_CHECKPOINT_ROOT (default ~/.textless/). Nothing is downloaded: a
missing file raises and names the path where it is expected.
"""
from __future__ import annotations

import os
import pathlib
from typing import Union

_EXPRESSO = "hifigan_expresso_lj_vctk_"
#: name -> file name, as the textlesslib registry stores them
CHECKPOINTS = {
    "mhubert-base-25hz-kmeans-500-hifigan": "hifigan_lj_mhubert_base_25hz.pt",
    "mhubert-base-25hz-kmeans-500-hifigan-config": "hifigan_lj_mhubert_base_25hz_config.json",
}
for _name, _stem in (
        ("hubert-base-ls960-layer-9-kmeans-500-hifigan", "hubert_base_ls960_L9_km500"),
        ("hubert-base-ls960-layer-9-kmeans-expresso-2000-hifigan",
         "hubert_base_ls960_L9_km2000_expresso"),
        ("mhubert-base-vp_mls_cv_8lang-kmeans-2000-hifigan",
         "mhubert_base_vp_mls_cv_8lang_it3_L12_km2000"),
        ("mhubert-base-vp_mls_cv_8lang-kmeans-expresso-2000-hifigan",
         "mhubert_base_vp_mls_cv_8lang_it3_L12_km2000_expresso")):
    CHECKPOINTS[_name] = f"{_EXPRESSO}{_stem}_generator.pt"
    for _part, _suffix in (("config", "config.json"), ("speakers", "speakers.txt"),
                           ("styles", "styles.txt")):
        CHECKPOINTS[f"{_name}-{_part}"] = f"{_EXPRESSO}{_stem}_{_suffix}"


class CheckpointManager:
    def __init__(self, disk_root: Union[str, pathlib.Path, None] = None):
        if disk_root is None:
            disk_root = os.environ.get("TEXTLESS_CHECKPOINT_ROOT", "~/.textless/")
        self.disk_root = pathlib.Path(disk_root).expanduser().resolve()
        self.storage = dict(CHECKPOINTS)

    def set_root(self, new_root):
        self.disk_root = pathlib.Path(new_root).expanduser().resolve()

    def add_checkpoint(self, name: str, fname: str):
        self.storage[name] = fname

    def get_by_name(self, name: str) -> pathlib.Path:
        if name not in self.storage:
            raise KeyError(f"Unknown checkpoint {name!r}; add it with add_checkpoint")
        path = self.disk_root / self.storage[name]
        if not path.exists():
            raise FileNotFoundError(f"checkpoint {name} is expected at {path} (nothing is "
                                    f"downloaded: place the file there or set "
                                    f"$TEXTLESS_CHECKPOINT_ROOT)")
        return path


CHECKPOINT_MANAGER = CheckpointManager()
