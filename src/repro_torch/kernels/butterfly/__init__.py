from .butterfly_kernel import (
    butterfly_pairs_windows_kernel_call,
    butterfly_pairs_windows_plain,
)
from .ops import butterfly_count_pallas_windows
from .ref import butterfly_count_ref

__all__ = [
    "butterfly_pairs_windows_kernel_call",
    "butterfly_pairs_windows_plain",
    "butterfly_count_pallas_windows",
    "butterfly_count_ref",
]
