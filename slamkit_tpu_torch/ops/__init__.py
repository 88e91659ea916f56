from .attention_ref import attention_mask, mha_reference, mha_reference_bwd
from .flash_attention import (FlashAttentionFunction, flash_attention,
                              flash_attention_bwd, flash_attention_fwd)
from .matmul_probe import matmul_probe, matmul_probe_reference
from .quant import dequantize_weight, dq_matmul, dq_matmul_reference, quantize_weight
from .ring_attention import (RingFlashAttention, all_gather_seq, merge_pair,
                             ring_flash_attention, zigzag_permutation)

__all__ = ["attention_mask", "mha_reference", "mha_reference_bwd",
           "FlashAttentionFunction", "flash_attention", "flash_attention_bwd",
           "flash_attention_fwd", "matmul_probe", "matmul_probe_reference",
           "dequantize_weight", "dq_matmul", "dq_matmul_reference", "quantize_weight",
           "RingFlashAttention", "all_gather_seq", "merge_pair", "ring_flash_attention",
           "zigzag_permutation"]
