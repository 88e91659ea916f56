from .audio_tokeniser import AudioTokeniser, tokeniser_factory
from .interleaving_tokeniser import (ContentType, GenerationInput, InterleavingTokeniser,
                                     select_spans_poisson)
from .text_tokeniser import TextTokeniser
from .unit_tokeniser import UnitTokeniser, pad_token_batch, tokenise_unit_string

__all__ = ["AudioTokeniser", "tokeniser_factory", "ContentType", "GenerationInput",
           "InterleavingTokeniser", "select_spans_poisson", "TextTokeniser", "UnitTokeniser",
           "pad_token_batch", "tokenise_unit_string"]
