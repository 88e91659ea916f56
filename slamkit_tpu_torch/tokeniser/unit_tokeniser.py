"""The speech-only unit tokeniser: audio or `<UnN>` strings to token ids.

A copy of `slamkit_tpu/tokeniser/unit_tokeniser.py`: `UnitVocab` (:27), the
vocabulary that `text_tokeniser` holds and whose length `cli/train.py` reads
for `vocab_size: -1`, with `convert_ids_to_tokens` and `decode` (:44-57); the
string side (`pad_token_batch` :60, `_encode_one` :103, `string_tokenise`
:107, `__call__` :121, `prepare_sample` :134, `prepare_batch` :137) and the
audio side over a feature extractor (`tokenise` :126, `build_prompt` :129,
`decode_sample` :141, `get_ignore_tokens` :146, `fe_sample_rate` :151); and
`save_pretrained` / `from_pretrained` through `tokeniser_config.json`
(:156-172), the same bytes, so each package loads the other's. Copied
because the JAX package's tokeniser module cannot be imported without jax.
`tests/test_torch_data.py`, `tests/test_torch_speech_lm.py` and
`tests/test_torch_unit_tokeniser.py` hold it equal to the original. The vocabulary: <PAD> = 0, <S> = 1 (bos and eos), <UnN> =
N + 2, so 500 units make 502 ids; every sequence is wrapped as `<S> units
<S>`. The JAX tokeniser pads on its text tokeniser's `padding_side`, which
SpeechLM sets to right for scoring and left for prompts; here `tokenise`
pads right and `build_prompt` left.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Union

import numpy as np

from . import unit_codec
from .audio_tokeniser import AudioTokeniser
from .unit_codec import tokenise_unit_string


def pad_token_batch(seqs: List[List[int]], pad_id: int, padding_side: str = "right") -> dict:
    """Pad ragged id lists to a dense [B, L] batch with an attention mask."""
    max_len = max((len(s) for s in seqs), default=0)
    batch = np.full((len(seqs), max_len), pad_id, dtype=np.int32)
    mask = np.zeros((len(seqs), max_len), dtype=np.int32)
    for i, s in enumerate(seqs):
        n = len(s)
        if padding_side == "right":
            batch[i, :n] = s
            mask[i, :n] = 1
        else:
            batch[i, max_len - n:] = s
            mask[i, max_len - n:] = 1
    return {"input_ids": batch, "attention_mask": mask}


class UnitVocab:
    """The vocabulary's size and special ids, and ids back to token strings
    (the JAX package's stand-in for the reference's HF text tokeniser)."""

    def __init__(self, num_units: int, offset: int, pad_token_id: int, bos_token_id: int,
                 eos_token_id: int):
        self.num_units = num_units
        self.offset = offset
        self.pad_token_id = pad_token_id
        self.bos_token_id = bos_token_id
        self.eos_token_id = eos_token_id

    def __len__(self) -> int:
        return self.num_units + self.offset

    def convert_ids_to_tokens(self, ids) -> List[str]:
        """Each id as `<PAD>`, `<S>` (bos and eos) or `<UnN>`."""
        out = []
        for i in np.atleast_1d(np.asarray(ids)):
            i = int(i)
            if i == self.pad_token_id:
                out.append("<PAD>")
            elif i in (self.bos_token_id, self.eos_token_id):
                out.append("<S>")
            else:
                out.append(f"<Un{i - self.offset}>")
        return out

    def decode(self, ids) -> str:
        return " ".join(self.convert_ids_to_tokens(ids))


class UnitTokeniser(AudioTokeniser):
    """Unit strings to ids; audio too when built over a feature extractor."""

    def __init__(self, speech_tokeniser=None, dedup: bool = True,
                 bos_eos_token_id: int = 1, pad_token_id: int = 0,
                 num_units: int = 500, load_fe: bool = True):
        self.model = speech_tokeniser if load_fe else None
        self.dedup = dedup
        self.bos_token_id = bos_eos_token_id
        self.eos_token_id = bos_eos_token_id
        self.pad_token_id = pad_token_id
        self.num_units = num_units
        # units sit immediately after the special ids
        self.offset = max(self.eos_token_id, self.bos_token_id, self.pad_token_id) + 1
        self.text_tokeniser = UnitVocab(num_units, self.offset, pad_token_id,
                                        self.bos_token_id, self.eos_token_id)

    def __len__(self) -> int:
        return self.num_units + self.offset

    # -- audio -> representation -> strings ------------------------------------
    def audio_represent(self, wav, lens=None) -> List[Dict]:
        if self.model is None:
            raise RuntimeError("This tokeniser was built without a feature extractor")
        return self._represent(self.model, wav, lens, self.dedup)

    def stringify_representation(self, reps: List[Dict], mode: str = "test") -> List[str]:
        return [unit_codec.units_to_string(cur["units"]) for cur in reps]

    # -- strings -> ids ----------------------------------------------------------
    def _encode_one(self, audio_repr: str) -> List[int]:
        ids = tokenise_unit_string(audio_repr, self.offset)
        return [self.bos_token_id] + ids + [self.eos_token_id]

    def string_tokenise(self, audio_repr: Union[str, List[str]], padding: bool = False,
                        add_special_tokens: bool = True, **kwargs) -> dict:
        if isinstance(audio_repr, str):
            audio_repr = [audio_repr]
        if add_special_tokens:
            seqs = [self._encode_one(s) for s in audio_repr]
        else:
            seqs = [tokenise_unit_string(s, self.offset) for s in audio_repr]
        if padding:
            return pad_token_batch(seqs, self.pad_token_id, "right")
        return {"input_ids": seqs, "attention_mask": [[1] * len(s) for s in seqs]}

    def __call__(self, sample: Union[Dict, str, List[str]], **kwargs) -> dict:
        """A representation dict, a `<UnN>` string or a list of them to ids
        (DPO's `tokenize_row` calls it with add_special_tokens=False)."""
        if isinstance(sample, dict):
            sample = self.stringify_representation([sample])[0]
        return self.string_tokenise(sample, **kwargs)

    def prompt_tokenise(self, audio_repr: List[str]) -> dict:
        """Prompts as `build_prompt` makes them: no trailing <S>, left pads."""
        seqs = [self._encode_one(s)[:-1] for s in audio_repr]
        return pad_token_batch(seqs, self.pad_token_id, "left")

    def prepare_sample(self, sample: dict, **kwargs) -> dict:
        """One jsonl row ({'audio_repr': ...}) through `string_tokenise`."""
        return self.string_tokenise(sample["audio_repr"], **kwargs)

    def prepare_batch(self, samples: list) -> list:
        """jsonl rows ({'audio_repr': ...}) to id lists."""
        return [self._encode_one(s["audio_repr"]) for s in samples]

    # -- audio -> ids --------------------------------------------------------------
    def tokenise(self, wav, lens=None) -> dict:
        return self.string_tokenise(self.audio_stringify(wav, lens), padding=True)

    def build_prompt(self, wav, lens=None, output_modality: Optional[str] = None) -> dict:
        return self.prompt_tokenise(self.audio_stringify(wav, lens))

    def decode_sample(self, tokens, output_modality: str = "SPEECH") -> np.ndarray:
        tokens = np.asarray(tokens).ravel()
        keep = ((tokens != self.pad_token_id) & (tokens != self.bos_token_id)
                & (tokens != self.eos_token_id))
        return unit_codec.decode_ids_to_units(tokens[keep], self.offset, self.num_units)

    def get_ignore_tokens(self, _: Optional[str]) -> Optional[List[int]]:
        return None

    @property
    def fe_sample_rate(self) -> int:
        if self.model is None:
            raise RuntimeError("This tokeniser was built without a feature extractor "
                               "(load_fe=False)")
        return self.model.sample_rate

    # -- persistence ---------------------------------------------------------------
    def save_pretrained(self, save_directory: str, **kwargs):
        """`tokeniser_config.json` in `save_directory`: the constructor's
        arguments, with load_fe false (the feature extractor is not saved)."""
        os.makedirs(save_directory, exist_ok=True)
        cfg = {
            "dedup": self.dedup,
            "bos_eos_token_id": self.bos_token_id,
            "pad_token_id": self.pad_token_id,
            "num_units": self.num_units,
            "load_fe": False,
        }
        with open(os.path.join(save_directory, "tokeniser_config.json"), "w") as f:
            json.dump(cfg, f)

    @classmethod
    def from_pretrained(cls, path: str, **kwargs) -> "UnitTokeniser":
        """The tokeniser that `save_pretrained` wrote to `path`, without a
        feature extractor; `kwargs` go to the constructor (a key the file
        holds raises)."""
        with open(os.path.join(path, "tokeniser_config.json"), "r") as f:
            cfg = json.load(f)
        return cls(speech_tokeniser=None, **cfg, **kwargs)
