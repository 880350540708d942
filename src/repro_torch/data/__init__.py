"""Host data pipeline of the port (the counterpart of ``repro.data``)."""
from .pipeline import Prefetcher, shard_batch, token_batches

__all__ = ["Prefetcher", "shard_batch", "token_batches"]
