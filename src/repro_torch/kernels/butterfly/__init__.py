from .butterfly_kernel import (
    butterfly_pairs_kernel_call,
    butterfly_pairs_plain,
    butterfly_pairs_windows_kernel_call,
    butterfly_pairs_windows_kernel_multiset_call,
    butterfly_pairs_windows_multiset_plain,
    butterfly_pairs_windows_plain,
)
from .ops import (
    butterfly_count_pallas,
    butterfly_count_pallas_batched,
    butterfly_count_pallas_windows,
    butterfly_count_pallas_windows_multiset,
    butterfly_count_tiles,
)
from .ref import butterfly_count_ref

__all__ = [
    "butterfly_pairs_kernel_call",
    "butterfly_pairs_plain",
    "butterfly_pairs_windows_kernel_call",
    "butterfly_pairs_windows_kernel_multiset_call",
    "butterfly_pairs_windows_multiset_plain",
    "butterfly_pairs_windows_plain",
    "butterfly_count_pallas",
    "butterfly_count_pallas_batched",
    "butterfly_count_pallas_windows",
    "butterfly_count_pallas_windows_multiset",
    "butterfly_count_tiles",
    "butterfly_count_ref",
]
