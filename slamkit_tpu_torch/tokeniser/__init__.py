from .audio_tokeniser import AudioTokeniser, tokeniser_factory
from .unit_tokeniser import UnitTokeniser, pad_token_batch, tokenise_unit_string

__all__ = ["AudioTokeniser", "tokeniser_factory", "UnitTokeniser", "pad_token_batch",
           "tokenise_unit_string"]
