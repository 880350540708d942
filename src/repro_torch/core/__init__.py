from .butterfly import (
    build_biadjacency,
    count_butterflies_dense,
    count_butterflies_from_edges,
    count_butterflies_np,
)
from .windows import WindowBatch, window_bounds, window_ids, windowize
from .executor import ExecutorResult, WindowExecutor
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
    "build_biadjacency", "count_butterflies_dense",
    "count_butterflies_from_edges", "count_butterflies_np", "WindowBatch",
    "window_bounds", "window_ids", "windowize", "ExecutorResult",
    "WindowExecutor", "SGrappResult", "mape", "run_sgrapp", "run_sgrapp_x",
    "sgrapp_estimate", "sgrapp_x_estimate", "window_exact_counts",
]
