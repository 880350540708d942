"""The recsys family of the port (the counterpart of
``repro.models.recsys``): EmbeddingBag, the fused per-field lookup and
xDeepFM; ``params_from_reference`` carries the reference's weights
across."""
from ..common import params_from_reference, params_to_reference
from .embedding import embedding_bag, fused_field_lookup
from .xdeepfm import XDeepFMConfig, init_xdeepfm, xdeepfm_forward

__all__ = [
    "embedding_bag",
    "fused_field_lookup",
    "XDeepFMConfig",
    "init_xdeepfm",
    "xdeepfm_forward",
    "params_from_reference",
    "params_to_reference",
]
