"""The dense GQA transformer LM (the port of ``repro.models.transformer``;
MoE and MLA are later slices)."""
from .config import LMConfig, MLAConfig, MoEConfig
from .convert import params_from_reference
from .model import (
    TransformerLM,
    decode_step,
    init_cache,
    init_lm_params,
    lm_forward,
    prefill,
)

__all__ = [
    "LMConfig", "MoEConfig", "MLAConfig", "TransformerLM",
    "init_lm_params", "lm_forward", "prefill", "decode_step", "init_cache",
    "params_from_reference",
]
