"""SpeechLM: a unit LM composed with an audio tokeniser and a vocoder.

Counterpart of `slamkit_tpu/models/speech_lm.py`: `log_likelihood` tokenises
wavs, or lists of `GenerationInput` for the interleaving tokeniser, with
right pads and scores them; `generate` builds left-padded prompts (the
tokeniser's `build_prompt`, which ends an interleaved prompt with the output
modality's token and drops a trailing eos), turns ignore tokens into unigram
bad words (the modality mask), brings the continuations back to the host,
decodes each to units or text and, for SPEECH output, vocodes them in one
`vocode_batch` call.
`generate_kwargs` (temperature, top_k, max_new_tokens, weight_quant, ...)
reach `UnitLM.generate` unchanged.

The components run where they were built: the feature extractor's, the
LM's and the vocoder's devices must be one device, so a CUDA pipeline never
carries on on the CPU.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch


def _device_of(component) -> Optional[torch.device]:
    """The device a component declares (`.device`, or its params tree's)."""
    dev = getattr(component, "device", None)
    if dev is None and isinstance(getattr(component, "params", None), dict):
        leaf = component.params.get("dict")
        dev = getattr(leaf, "device", None)
    return torch.device(dev) if dev is not None else None


class SpeechLM:
    def __init__(self, model, tokeniser, vocoder=None):
        self.model = model
        self.tokeniser = tokeniser
        self.vocoder = vocoder
        self.device = _device_of(model)
        fe = getattr(tokeniser, "model", None) or getattr(tokeniser, "speech_fe", None)
        for name, part in (("feature extractor", fe),
                           ("vocoder", vocoder)):
            dev = _device_of(part) if part is not None else None
            if dev is not None and self.device is not None and dev != self.device:
                raise ValueError(f"the {name} runs on {dev} and the LM on {self.device}: "
                                 f"build every component on one device")

    def log_likelihood(self, wavs, lens=None, mean_nll: bool = True,
                       used_token_modality: Optional[str] = None) -> torch.Tensor:
        """wavs [B, L] zero-padded + lens, or a list of GenerationInput lists,
        -> per-sample log likelihood [B]."""
        tokens = self.tokeniser.tokenise(wavs, lens)["input_ids"]
        ignore_tokens = self.tokeniser.get_ignore_tokens(used_token_modality)
        return self.model.log_likelihood(tokens, mean_nll, ignore_tokens)

    def generate(self, wavs, lens=None, output_modality: Optional[str] = "SPEECH",
                 remove_prompt: bool = False, **kwargs) -> List:
        """Batch continuation: unit arrays, or waveforms when a vocoder is
        attached and the output is SPEECH. The metrics pass their
        `used_token_modality` positionally, whose config default is None:
        None means SPEECH."""
        output_modality = output_modality or "SPEECH"
        tokens = self.tokeniser.build_prompt(wavs, lens, output_modality=output_modality)
        ignore_tokens = self.tokeniser.get_ignore_tokens(output_modality)
        bad_words_ids = None
        if ignore_tokens is not None:
            bad_words_ids = [[int(t)] for t in ignore_tokens]
        conts = self.model.generate(**tokens, bad_words_ids=bad_words_ids, **kwargs)
        conts = conts.cpu().numpy() if isinstance(conts, torch.Tensor) else np.asarray(conts)
        if remove_prompt:
            conts = conts[..., np.asarray(tokens["input_ids"]).shape[1]:]
        decoded = [self.tokeniser.decode_sample(c, output_modality=output_modality)
                   for c in conts]
        if self.vocoder is None or output_modality.upper() != "SPEECH":
            return decoded
        keep = [i for i, c in enumerate(decoded) if np.size(c) > 0]
        wavs = self.vocoder.vocode_batch([decoded[i] for i in keep])
        out = [np.asarray([], dtype=np.float32)] * len(decoded)
        for i, w in zip(keep, wavs):
            out[i] = w
        return out
