"""Graph primitives of the port (the counterpart of ``repro.graphs``):
segment reductions over edge lists in torch, and the host-side CSR,
fanout sampler and halo partitioner as numpy copies."""
from .segment import (
    segment_sum,
    segment_mean,
    segment_max,
    segment_softmax,
    gather_scatter,
    degrees,
)
from .sampler import fanout_sample
from .csr import build_csr_padded

__all__ = [
    "segment_sum", "segment_mean", "segment_max", "segment_softmax",
    "gather_scatter", "degrees", "fanout_sample", "build_csr_padded",
]
