"""K4: the flash-attention forward pass, its wrappers, its plain twin and
the full-softmax oracle."""
from .flash_kernel import (
    flash_attention_bshd,
    flash_attention_call,
    flash_attention_plain,
)
from .ops import flash_attention
from .ref import attention_ref

__all__ = ["flash_attention", "flash_attention_bshd", "flash_attention_call",
           "flash_attention_plain", "attention_ref"]
