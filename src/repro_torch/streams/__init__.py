from .config import DUP_POLICIES, EngineConfig
from .wire import RecordBatch, normalize_records
from .stream import SgrStream, dedupe_stream, stream_chunks
from .generators import (
    ba_bipartite_stream,
    bipartite_pa_stream,
    dynamic_sgr_stream,
    synthetic_rating_stream,
    assign_timestamps,
)
from .engine import (
    StreamingSGrapp,
    migrate_state_dict_to_latest,
    migrate_state_dict_v1,
    migrate_state_dict_v2,
    migrate_state_dict_v3,
)
from .multi import MultiStreamSGrapp
from .oracle import OracleWindow, oracle_window_counts, replay_dynamic
from .state import (
    OP_DELETE,
    OP_INSERT,
    StreamState,
    resolve_window,
    stream_state_init,
)

__all__ = [
    "DUP_POLICIES",
    "EngineConfig",
    "RecordBatch",
    "normalize_records",
    "SgrStream",
    "dedupe_stream",
    "stream_chunks",
    "ba_bipartite_stream",
    "bipartite_pa_stream",
    "dynamic_sgr_stream",
    "synthetic_rating_stream",
    "assign_timestamps",
    "StreamingSGrapp",
    "MultiStreamSGrapp",
    "migrate_state_dict_v1",
    "migrate_state_dict_v2",
    "migrate_state_dict_v3",
    "migrate_state_dict_to_latest",
    "OracleWindow",
    "oracle_window_counts",
    "replay_dynamic",
    "OP_INSERT",
    "OP_DELETE",
    "StreamState",
    "resolve_window",
    "stream_state_init",
]
