"""The unit tokeniser's string side: `<UnN>` strings to token ids.

A copy of the string half of `slamkit_tpu/tokeniser/unit_tokeniser.py`
(`pad_token_batch` :60, `UnitTokeniser._encode_one` :103, `string_tokenise`
:107, `prepare_batch` :137, `build_prompt` :129 on strings) and of
`unit_codec.tokenise_unit_string`, copied because the JAX package's tokeniser
module cannot be imported without jax. `tests/test_torch_data.py` holds it
equal to the original. The vocabulary: <PAD> = 0, <S> = 1 (bos and eos),
<UnN> = N + 2, so 500 units make 502 ids; every sequence is wrapped as
`<S> units <S>`. The feature extractor (audio to units) is not ported.
"""
from __future__ import annotations

import re
from typing import List, Union

import numpy as np

_UNIT_RE = re.compile(r"<Un(\d+)>")


def tokenise_unit_string(text: str, offset: int) -> List[int]:
    """'<Un3><Un49>' -> [3 + offset, 49 + offset]; other characters are ignored."""
    return [int(m) + offset for m in _UNIT_RE.findall(text)]


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


class UnitTokeniser:
    """`<UnN>` strings to ids, without a feature extractor."""

    def __init__(self, bos_eos_token_id: int = 1, pad_token_id: int = 0,
                 num_units: int = 500):
        self.bos_token_id = bos_eos_token_id
        self.eos_token_id = bos_eos_token_id
        self.pad_token_id = pad_token_id
        self.num_units = num_units
        # units sit immediately after the special ids
        self.offset = max(self.eos_token_id, self.bos_token_id, self.pad_token_id) + 1

    def __len__(self) -> int:
        return self.num_units + self.offset

    def _encode_one(self, audio_repr: str) -> List[int]:
        ids = tokenise_unit_string(audio_repr, self.offset)
        return [self.bos_token_id] + ids + [self.eos_token_id]

    def string_tokenise(self, audio_repr: Union[str, List[str]], padding: bool = False,
                        add_special_tokens: bool = True) -> dict:
        if isinstance(audio_repr, str):
            audio_repr = [audio_repr]
        if add_special_tokens:
            seqs = [self._encode_one(s) for s in audio_repr]
        else:
            seqs = [tokenise_unit_string(s, self.offset) for s in audio_repr]
        if padding:
            return pad_token_batch(seqs, self.pad_token_id, "right")
        return {"input_ids": seqs, "attention_mask": [[1] * len(s) for s in seqs]}

    def prompt_tokenise(self, audio_repr: List[str]) -> dict:
        """Prompts as `build_prompt` makes them: no trailing <S>, left pads."""
        seqs = [self._encode_one(s)[:-1] for s in audio_repr]
        return pad_token_batch(seqs, self.pad_token_id, "left")

    def prepare_batch(self, samples: list) -> list:
        """jsonl rows ({'audio_repr': ...}) to id lists."""
        return [self._encode_one(s["audio_repr"]) for s in samples]
