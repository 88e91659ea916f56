from .presets import PRESETS, DecoderConfig, resolve_base_config
from .transformer import Decoder, init_cache, param_count
from .convert import grads_to_flat, load_flat, to_flat
from .generate import generate
from .unit_lm import UnitLM, UnitLMConfig, tlm_factory

__all__ = [
    "DecoderConfig", "PRESETS", "resolve_base_config",
    "Decoder", "init_cache", "param_count", "grads_to_flat", "load_flat", "to_flat",
    "generate", "UnitLM", "UnitLMConfig", "tlm_factory",
]
