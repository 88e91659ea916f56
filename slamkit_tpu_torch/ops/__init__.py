from .attention_ref import attention_mask, mha_reference, mha_reference_bwd
from .flash_attention import (FlashAttentionFunction, flash_attention,
                              flash_attention_bwd, flash_attention_fwd)

__all__ = ["attention_mask", "mha_reference", "mha_reference_bwd",
           "FlashAttentionFunction", "flash_attention", "flash_attention_bwd",
           "flash_attention_fwd"]
