"""The record store and its models (copies of ``repro.storage``): the
RREC file format with checksums and the fault seam, the coalesced dense
and ragged batch engines, and the NVM device / cache-hit models."""
from repro_torch.storage.faults import (  # noqa: F401
    CorruptRecordError,
    FaultInjector,
    FaultSpec,
    RetryPolicy,
)
from repro_torch.storage.record_store import (  # noqa: F401
    BatchBufferRing,
    RaggedBatch,
    RaggedBufferRing,
    RecordStore,
    RecordWriter,
)
from repro_torch.storage.devices import (  # noqa: F401
    STORAGE_MODELS,
    StorageModel,
    cache_hit_model,
)
