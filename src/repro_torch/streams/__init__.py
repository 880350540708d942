from .config import DUP_POLICIES, EngineConfig
from .wire import (
    RecordBatch,
    WIRE_COLUMNS,
    normalize_records,
    records_from_json,
    records_to_json,
)
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

# the serving front end (repro_torch.streams.server) is imported explicitly
# by consumers: it drags in asyncio/logging machinery no library user needs

__all__ = [
    "DUP_POLICIES",
    "EngineConfig",
    "RecordBatch",
    "WIRE_COLUMNS",
    "normalize_records",
    "records_from_json",
    "records_to_json",
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
