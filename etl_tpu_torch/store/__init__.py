"""State/schema stores (the in-memory ones; the SQL store is not ported
yet)."""

from .base import (DeadLetterEntry, DestinationTableMetadata, PipelineStore,
                   QuarantineRecord, SchemaStore, StateStore)
from .memory import MemoryStore, NotifyingStore
