"""Speech-text interleaving tokeniser (SpiritLM-style) on the port.

A copy of `slamkit_tpu/tokeniser/interleaving_tokeniser.py` on the port's own
text tokeniser (`text_tokeniser.py`, a tokenizer.json reader) in place of
`transformers.AutoTokenizer` (:116-125). The text vocabulary is extended with
<Un0>..<UnN-1>, <speech> and <text>; train-mode stringify assigns each
aligned word a modality (random / span / poisson) with the same numpy draws
(`select_spans_poisson` :63, `_assign_interleaved_modality` :135, the per-row
Generator `_row_rng` :195), so its strings equal the JAX package's character
for character; speech spans map to unit index ranges through cumsum(duration)
x unit_duration + bisect. Speech segments of generation inputs go through
the feature extractor grouped by exact length (:233-294), so their units
equal a per-segment call. `get_ignore_tokens` partitions the vocabulary for
constrained scoring and generation.

Differences from the JAX module: `tokenise` pads right and `build_prompt`
left by themselves (the JAX package's SpeechLM sets the text tokeniser's
padding_side before each), and `build_prompt` returns input_ids and
attention_mask only (a generic tokenizer.json's token_type_ids would reach
`UnitLM.generate`, which refuses unknown arguments).
`tests/test_torch_interleaving.py` holds it equal to the original.
"""
from __future__ import annotations

import math
import os
import re
import zlib
from bisect import bisect_left, bisect_right
from dataclasses import dataclass
from enum import Enum
from typing import Dict, List, Optional, Union

import numpy as np

from .audio_tokeniser import AudioTokeniser
from .text_tokeniser import TextTokeniser

SPEECH_TOKEN = "<speech>"
TEXT_TOKEN = "<text>"


class ContentType(Enum):
    TEXT = "TEXT"
    SPEECH = "SPEECH"


@dataclass
class GenerationInput:
    content: Union[str, os.PathLike, np.ndarray]
    content_type: ContentType

    @classmethod
    def from_tuple(cls, tup):
        content_type, content = tup
        content_type = content_type.upper()
        if content_type not in ("SPEECH", "TEXT"):
            raise ValueError(f"expects content_type in ['SPEECH', 'TEXT'], found "
                             f"'{content_type}'")
        return cls(content=content, content_type=ContentType[content_type])


def select_spans_poisson(array_size: int, lambda_param: int, eta: float,
                         rng=None) -> np.ndarray:
    """Binary span mask: Poisson(lambda) span lengths until ~eta of the array
    is selected. rng: an np.random.Generator, or the global state."""
    rng = np.random if rng is None else rng
    total_to_select = math.ceil(array_size * eta)
    mask = np.zeros(array_size, dtype=int)
    eligible_indices = set(range(array_size))
    selected_count = 0
    while selected_count < total_to_select and eligible_indices:
        start_index = rng.choice(list(eligible_indices))
        span_length = rng.poisson(lambda_param)
        end_index = min(start_index + span_length, array_size)
        if np.any(mask[start_index:end_index] == 1):
            continue
        mask[start_index:end_index] = 1
        selected_count += end_index - start_index
        for i in range(start_index, end_index):
            eligible_indices.discard(i)
        if end_index < array_size:
            eligible_indices.discard(end_index)
    return mask


class InterleavingTokeniser(AudioTokeniser):
    def __init__(self, speech_tokeniser=None,
                 dedup: bool = True,
                 pad_token_id: int = 0,
                 num_units: int = 500,
                 load_fe: bool = True,
                 text_tokeniser_path: str = "facebook/opt-125m",
                 interleave_method: str = "random",
                 interleave_span: Optional[int] = None,
                 interleave_prob: Optional[float] = None,
                 interleave_seed: Optional[int] = None):
        self.speech_fe = speech_tokeniser if load_fe else None
        self.dedup = dedup
        self.pad_token_id = pad_token_id
        self.num_units = num_units
        self.text_tokeniser = self._init_text_tokeniser(text_tokeniser_path, pad_token_id,
                                                        num_units)
        self.interleave_method = interleave_method
        self.interleave_span = interleave_span
        self.interleave_prob = interleave_prob
        # each row's modality draws come from a Generator keyed on (seed,
        # file_name), so stage 2 is reproducible under its thread pool; None
        # draws from numpy's global state
        self.interleave_seed = interleave_seed

    @staticmethod
    def _init_text_tokeniser(text_tokeniser_path: str, pad_token_id: int,
                             num_units: int) -> TextTokeniser:
        tokeniser = TextTokeniser.from_pretrained(text_tokeniser_path)
        tokeniser.pad_token_id = pad_token_id
        tokeniser.padding_side = "right"
        tokeniser.add_tokens([f"<Un{x}>" for x in range(num_units)]
                             + [SPEECH_TOKEN, TEXT_TOKEN])
        return tokeniser

    def _special_id(self, token: str) -> int:
        return self.text_tokeniser.convert_tokens_to_ids(token)

    # -- audio -> representation -----------------------------------------------
    def audio_represent(self, wav, lens=None) -> List[Dict]:
        if self.speech_fe is None:
            raise RuntimeError("This tokeniser was built without a feature extractor")
        return self._represent(self.speech_fe, wav, lens, self.dedup)

    # -- interleaving -----------------------------------------------------------
    def _assign_interleaved_modality(self, aligned_text: List, rng=None) -> List:
        rng = np.random if rng is None else rng
        modalities = []
        if self.interleave_method == "random":
            for w, s, e in aligned_text:
                cur = "text" if rng.random() < 0.5 else "audio"
                modalities.append((w, s, e, cur))
        elif self.interleave_method == "span":
            patience = 0
            for w, s, e in aligned_text:
                mod_now = "text" if rng.random() >= self.interleave_prob else "audio"
                if mod_now == "audio":
                    patience = self.interleave_span
                cur = "audio" if patience > 0 else "text"
                modalities.append((w, s, e, cur))
                patience -= 1
        elif self.interleave_method == "poisson":
            speech_words = select_spans_poisson(
                len(aligned_text), self.interleave_span, self.interleave_prob,
                rng=None if rng is np.random else rng)
            for i, (w, s, e) in enumerate(aligned_text):
                cur = "audio" if speech_words[i] > 0 else "text"
                modalities.append((w, s, e, cur))
        else:
            raise ValueError(f"Unknown interleave method: {self.interleave_method}")
        return modalities

    def _create_interleaved_text(self, rep: Dict, aligned_text: List) -> str:
        """Word time ranges -> unit index ranges via cumsum(duration) x
        unit_duration + bisect."""
        out = ""
        cur: list = []
        unit_time = np.cumsum(rep["duration"]) * self.speech_fe.get_unit_duration()
        for i in range(len(aligned_text)):
            w, s, e, m = aligned_text[i]
            if i == 0:
                out += SPEECH_TOKEN if m != "text" else TEXT_TOKEN
            if m == "text":
                cur.append(w)
            else:
                cur.append((s, e))
            if i == (len(aligned_text) - 1) or m != aligned_text[i + 1][3]:
                if m == "text":
                    out += "".join(cur)
                    if i != (len(aligned_text) - 1):
                        out += SPEECH_TOKEN
                else:
                    start, end = cur[0][0], cur[-1][1]
                    start_unit = bisect_left(unit_time, start)
                    end_unit = bisect_right(unit_time, end)
                    out += "".join(f"<Un{u}>" for u in rep["units"][start_unit:end_unit])
                    if i != (len(aligned_text) - 1):
                        out += TEXT_TOKEN
                cur = []
        return out

    def _interleave_units(self, rep: Dict, rng=None) -> str:
        modalities = self._assign_interleaved_modality(rep["aligned_text"], rng)
        return self._create_interleaved_text(rep, modalities)

    def _row_rng(self, rep: Dict, occurrence: int):
        """A Generator keyed on (interleave_seed, crc32(file_name)), with the
        occurrence number folded in for repeated or missing names; None when
        unseeded."""
        if self.interleave_seed is None:
            return None
        key = str(rep.get("file_name", ""))
        seed = (self.interleave_seed, zlib.crc32(key.encode("utf-8")))
        if occurrence or not rep.get("file_name"):
            seed = seed + (occurrence + 1,)
        return np.random.default_rng(seed)

    def stringify_representation(self, reps: List[Dict], mode: str = "test") -> List[str]:
        out = []
        seen: Dict[str, int] = {}
        for cur in reps:
            if mode == "train":
                name = str(cur.get("file_name", ""))
                occ = seen.get(name, 0)
                seen[name] = occ + 1
                out.append(self._interleave_units(cur, self._row_rng(cur, occ)))
            elif mode == "test":
                out.append("".join(f"<Un{u}>" for u in cur["units"]))
        return out

    # -- string -> ids -----------------------------------------------------------
    def string_tokenise(self, audio_repr, **kwargs) -> dict:
        kwargs.pop("return_tensors", None)
        return self.text_tokeniser(audio_repr, add_special_tokens=True,
                                   return_tensors="np", **kwargs)

    def _stringify_interleaved(self, inp) -> str:
        return self._stringify_interleaved_batch([inp])[0]

    def _stringify_interleaved_batch(self, inputs) -> List[str]:
        """Interleaved strings for a batch of GenerationInput lists. Speech
        segments go through the feature extractor grouped by exact length
        (every extractor op is per sample, so an unpadded equal-length batch
        equals the per-segment call); with the extractor's opt-in
        bucket_samples, all segments go through one padded pass instead."""
        norm = []
        for inp in inputs:
            if inp and isinstance(inp[0], tuple):
                inp = [GenerationInput.from_tuple(i) for i in inp]
            norm.append(inp)

        wavs, owners = [], []
        for i, inp in enumerate(norm):
            for j, seg in enumerate(inp):
                if seg.content_type.value == ContentType.SPEECH.value:
                    wavs.append(np.asarray(seg.content).reshape(-1))
                    owners.append((i, j))
        seg_strs = {}
        if wavs:
            lens = np.array([len(w) for w in wavs])
            fe = self.speech_fe
            if fe is not None and getattr(fe, "bucket_samples", None):
                groups = [np.arange(len(wavs))]
            else:
                groups = [np.flatnonzero(lens == n) for n in np.unique(lens)]
            for idx in groups:
                sub_lens = lens[idx]
                batch = np.zeros((len(idx), int(sub_lens.max())), np.float32)
                for r, k in enumerate(idx):
                    batch[r, :lens[k]] = wavs[k]
                strs = self.stringify_representation(self.audio_represent(batch, sub_lens))
                for r, k in enumerate(idx):
                    seg_strs[owners[k]] = strs[r]

        out = []
        for i, inp in enumerate(norm):
            cur_str = ""
            prev_mod = None
            for j, segment in enumerate(inp):
                if segment.content_type.value == ContentType.SPEECH.value:
                    if prev_mod != "s":
                        cur_str += SPEECH_TOKEN
                    cur_str += seg_strs[(i, j)]
                    prev_mod = "s"
                elif segment.content_type.value == ContentType.TEXT.value:
                    if prev_mod != "t":
                        cur_str += TEXT_TOKEN
                    cur_str += segment.content
                    prev_mod = "t"
                else:
                    raise ValueError(f"Unknown content type: {segment.content_type.value}")
            out.append(cur_str)
        return out

    def _strings(self, inputs, lens) -> List[str]:
        if isinstance(inputs, np.ndarray):
            return self.stringify_representation(self.audio_represent(inputs, lens))
        if isinstance(inputs, list):
            return self._stringify_interleaved_batch(inputs)
        raise ValueError(
            f"Inputs should be a list of InterleavedInputs or an array, got {type(inputs)}")

    def tokenise(self, inputs, lens=None) -> dict:
        """Audio or GenerationInput lists -> right-padded ids."""
        return self.string_tokenise(self._strings(inputs, lens), padding=True,
                                    padding_side="right")

    def build_prompt(self, inputs, lens=None, output_modality=None) -> dict:
        """Audio or GenerationInput lists -> left-padded prompt ids, ending
        with the output modality's token, without a trailing eos."""
        str_reps = self._strings(inputs, lens)
        if output_modality:
            if output_modality.upper() == ContentType.SPEECH.value:
                str_reps = [s + SPEECH_TOKEN for s in str_reps]
            elif output_modality.upper() == ContentType.TEXT.value:
                str_reps = [s + TEXT_TOKEN for s in str_reps]
            else:
                raise ValueError(f"Unknown output modality: {output_modality}")
        tokens = self.string_tokenise(str_reps, padding=True, padding_side="left")
        tokens = {k: tokens[k] for k in ("input_ids", "attention_mask")}
        eos = self.text_tokeniser.eos_token_id
        if eos is not None and (np.asarray(tokens["input_ids"])[..., -1] == eos).any():
            tokens = {k: v[..., :-1] for k, v in tokens.items()}
        return tokens

    def prepare_sample(self, sample: dict, **kwargs) -> dict:
        return self.string_tokenise(sample["audio_repr"], **kwargs)

    def prepare_batch(self, samples: list) -> list:
        """jsonl rows ({'audio_repr': ...}) -> id lists, one encode call."""
        return self.text_tokeniser([s["audio_repr"] for s in samples],
                                   add_special_tokens=True)["input_ids"]

    def decode_sample(self, tokens, output_modality: str = "SPEECH"):
        tokens = np.asarray(tokens).ravel()
        ignore = [self.text_tokeniser.pad_token_id,
                  self.text_tokeniser.bos_token_id,
                  self.text_tokeniser.eos_token_id]
        ignore = [i for i in ignore if i is not None]
        ignore += [self._special_id(SPEECH_TOKEN), self._special_id(TEXT_TOKEN)]
        if output_modality:
            ignore += self.get_ignore_tokens(output_modality)
        tokens = tokens[~np.isin(tokens, np.asarray(ignore))]
        str_repr = self.text_tokeniser.decode(tokens)
        if output_modality.upper() == "SPEECH":
            return np.array([int(n) for n in re.findall(r"<Un(\d+)>", str_repr)],
                            dtype=np.int64)
        if output_modality.upper() == "TEXT":
            return str_repr
        raise ValueError(f"Unknown output modality: {output_modality}")

    @property
    def fe_sample_rate(self) -> int:
        if self.speech_fe is None:
            raise RuntimeError("This tokeniser does not have a feature extractor")
        return self.speech_fe.sample_rate

    def get_ignore_tokens(self, used_token_modality: Optional[str]) -> Optional[List[int]]:
        """Vocabulary partition: text ids [0, len - units - 2) against the
        unit ids."""
        num_text_tokens = len(self.text_tokeniser) - self.num_units - 2
        special = [self.text_tokeniser.bos_token_id, self.text_tokeniser.eos_token_id]
        if used_token_modality and used_token_modality.upper() == "SPEECH":
            text_tokens = [x for x in range(num_text_tokens) if x not in special]
            text_tokens += [self._special_id(SPEECH_TOKEN), self._special_id(TEXT_TOKEN)]
            return text_tokens
        if used_token_modality and used_token_modality.upper() == "TEXT":
            skip = set(special) | {self._special_id(SPEECH_TOKEN),
                                   self._special_id(TEXT_TOKEN)}
            return [x for x in range(num_text_tokens, len(self.text_tokeniser))
                    if x not in skip]
        return None
