from .unit_tokeniser import UnitTokeniser, pad_token_batch, tokenise_unit_string

__all__ = ["UnitTokeniser", "pad_token_batch", "tokenise_unit_string"]
