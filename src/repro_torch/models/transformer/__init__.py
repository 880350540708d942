"""The transformer LM (the port of ``repro.models.transformer``): GQA and
MLA attention, dense and MoE FFNs."""
from .config import LMConfig, MLAConfig, MoEConfig
from .convert import params_from_reference, params_to_reference
from .model import (
    Block,
    TransformerLM,
    decode_step,
    init_cache,
    init_lm_params,
    layer_keys,
    lm_forward,
    lm_loss,
    lm_param_specs,
    param_shapes,
    prefill,
)
from .moe import MoERoute, init_moe, moe_apply, moe_param_specs, moe_route

__all__ = [
    "LMConfig", "MoEConfig", "MLAConfig", "TransformerLM", "Block",
    "init_lm_params", "lm_forward", "prefill", "decode_step", "init_cache",
    "layer_keys", "lm_loss", "lm_param_specs", "param_shapes",
    "params_from_reference", "params_to_reference", "MoERoute", "init_moe",
    "moe_apply", "moe_param_specs", "moe_route",
]
