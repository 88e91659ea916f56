"""Text-to-speech helpers used by the data-prep utilities.

A copy of `slamkit_tpu/utils/tts_utils.py`: `clean_phonemes` (:30) and
`attention_to_word_times` (:37), the word-time recovery from a TTS
decoder's per-frame attended-phoneme track, in numpy; the fairseq
FastSpeech2 wrapper and the Kokoro pipeline import fairseq / g2p_en /
kokoro when called and raise where they are absent.
"""
from __future__ import annotations

from typing import Generator, List, Optional, Sequence, Tuple

import numpy as np

from .device import DEFAULT_DEVICE, resolve_device

# FastSpeech2's vocoder consumes one mel frame per 256 output samples; frame
# index * HOP / sample_rate converts attention positions to seconds.
_HOP_SAMPLES = 256

# g2p emits punctuation tokens; the reference folds breaks to "sp" and then
# keeps alphanumeric symbols only, so a word's phoneme count excludes them.
_BREAK_SUBSTITUTIONS = {",": "sp", ";": "sp"}


def clean_phonemes(raw: Sequence[str]) -> List[str]:
    """Normalize a g2p phoneme sequence to the symbols FastSpeech2 consumed:
    breaks become "sp", anything non-alphanumeric is dropped."""
    subbed = (_BREAK_SUBSTITUTIONS.get(p, p) for p in raw)
    return [p for p in subbed if p.isalnum()]


def attention_to_word_times(
    frame_tokens: np.ndarray,
    phoneme_counts: Sequence[int],
    words: Sequence[str],
    sample_rate: int,
) -> List[Tuple[str, float, float]]:
    """Turn a per-frame attended-phoneme-index track into word time spans.

    frame_tokens: int array [T]; frame_tokens[t] is the phoneme-token index
      the decoder attended to while emitting frame t (token 0 is BOS, so the
      first word's phonemes start at index 1).
    phoneme_counts: number of (cleaned) phonemes per word.
    Returns [(" word", start_s, end_s), ...] — the leading space and the
    3-decimal rounding match the reference's alignment records.

    A word's span runs from the first frame attending to its first phoneme
    through the last frame attending to its last phoneme (identical to the
    reference's equality-match walk, reference tts_utils.py:60-78, but done
    with flatnonzero instead of a broadcast-compare on device).
    """
    track = np.asarray(frame_tokens).reshape(-1)
    spans: List[Tuple[str, float, float]] = []
    token_pos = 1  # skip BOS
    for word, count in zip(words, phoneme_counts):
        lo_frames = np.flatnonzero(track == token_pos)
        hi_frames = np.flatnonzero(track == token_pos + count - 1)
        if lo_frames.size == 0 and hi_frames.size == 0:
            raise ValueError(
                f"no frame attends to phonemes of word {word!r} "
                f"(tokens {token_pos}..{token_pos + count - 1})")
        # a zero-duration first/last phoneme (no attending frames) degrades
        # to the other end's frames — the reference's combined equality
        # match does the same rather than aborting the utterance
        start_frame = lo_frames[0] if lo_frames.size else hi_frames[0]
        end_frame = hi_frames[-1] if hi_frames.size else lo_frames[-1]
        start = int(start_frame) * _HOP_SAMPLES / sample_rate
        end = int(end_frame) * _HOP_SAMPLES / sample_rate
        spans.append((" " + word, round(start, 3), round(end, 3)))
        token_pos += count
    return spans


class FastSpeech2:
    """fairseq-hub facebook/fastspeech2-en-ljspeech with word alignment, on
    the card unless `device` names the CPU."""

    HUB_NAME = "facebook/fastspeech2-en-ljspeech"

    def __init__(self, cache_dir: Optional[str] = None, save_sr: int = 16000,
                 eos_padding: int = 30, device: str = DEFAULT_DEVICE):
        import g2p_en
        from fairseq.checkpoint_utils import \
            load_model_ensemble_and_task_from_hf_hub
        from fairseq.models.text_to_speech.hub_interface import TTSHubInterface

        ensemble, hub_cfg, self.task = load_model_ensemble_and_task_from_hf_hub(
            self.HUB_NAME,
            arg_overrides={"vocoder": "hifigan", "fp16": False},
            cache_dir=cache_dir)
        self.sr = self.task.sr
        self.save_sr = save_sr
        self.eos_padding = eos_padding
        self.g2p = g2p_en.G2p()
        self.device = resolve_device(device)
        self.model = ensemble[0].to(self.device)
        TTSHubInterface.update_cfg_with_data_cfg(hub_cfg, self.task.data_cfg)
        self.generator = self.task.build_generator(ensemble, hub_cfg)

    def _synthesize(self, text: str):
        from fairseq.models.text_to_speech.hub_interface import TTSHubInterface

        sample = TTSHubInterface.get_model_input(self.task, text)
        net_input = sample["net_input"]
        for key in ("src_tokens", "src_lengths"):
            net_input[key] = net_input[key].to(self.device)
        return self.generator.generate(self.model, sample)

    def generate_wav(self, text: str, alignment: bool = False):
        output = self._synthesize(text)
        if not alignment:
            return output
        words = text.split()
        counts = [len(clean_phonemes(self.g2p(w))) for w in words]
        track = output[0]["attn"].detach().cpu().numpy()
        return output, attention_to_word_times(track, counts, words, self.sr)


def kokoro(texts: List[str], voice: str = "af_heart",
           speed: int = 1) -> Generator:
    """Run the hexgrad/Kokoro-82M pipeline over texts; the first letter of
    the voice name selects the language code (Kokoro's convention)."""
    from kokoro import KPipeline

    return KPipeline(lang_code=voice[0])(texts, voice=voice, speed=speed)
