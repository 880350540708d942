from .butterfly import (
    build_biadjacency,
    build_biadjacency_multiset,
    count_butterflies_dense,
    count_butterflies_dense_multiset,
    count_butterflies_from_edges,
    count_butterflies_from_edges_multiset,
    count_butterflies_multiset_np,
    count_butterflies_np,
    count_butterflies_sparse,
    count_butterflies_sparse_multiset,
    count_butterflies_tiled,
    count_butterflies_tiled_multiset,
    window_wedge_counts_np,
)
from .windows import WindowBatch, window_bounds, window_ids, windowize
from .executor import ExecutorResult, WindowExecutor, route_tier
from .sgrapp import (
    SGrappResult,
    mape,
    run_sgrapp,
    run_sgrapp_x,
    sgrapp_estimate,
    sgrapp_x_estimate,
    window_exact_counts,
)

__all__ = [
    "build_biadjacency", "build_biadjacency_multiset",
    "count_butterflies_dense", "count_butterflies_dense_multiset",
    "count_butterflies_from_edges", "count_butterflies_from_edges_multiset",
    "count_butterflies_multiset_np", "count_butterflies_np",
    "count_butterflies_sparse", "count_butterflies_sparse_multiset",
    "count_butterflies_tiled", "count_butterflies_tiled_multiset",
    "window_wedge_counts_np", "WindowBatch",
    "window_bounds", "window_ids", "windowize", "ExecutorResult",
    "WindowExecutor", "route_tier", "SGrappResult", "mape", "run_sgrapp", "run_sgrapp_x",
    "sgrapp_estimate", "sgrapp_x_estimate", "window_exact_counts",
]
