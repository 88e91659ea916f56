from .attention_ref import attention_mask, mha_reference
from .flash_attention import flash_attention, flash_attention_fwd

__all__ = ["attention_mask", "mha_reference", "flash_attention",
           "flash_attention_fwd"]
