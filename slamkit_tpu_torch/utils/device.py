"""The device an entry point runs on.

The port's entry points (`UnitLM`, its loaders and factories, the HuBERT
extractor, the vocoder) run on the CUDA card unless the caller asks for
another device. Without a card, the default raises instead of running on the
CPU: a CPU run must be asked for with `device="cpu"`.
"""
from __future__ import annotations

from typing import Union

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """`device` as a torch.device; a CUDA device gets the current card's index.
    Raises if it names CUDA and no card is available."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r}: no CUDA card is available. The port runs on "
                f"the card by default; pass device=\"cpu\" to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
