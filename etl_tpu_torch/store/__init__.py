"""State/schema stores: the in-memory ones and the durable sqlite store
(the Postgres store is not ported yet)."""

from .base import (DeadLetterEntry, DestinationTableMetadata, PipelineStore,
                   QuarantineRecord, SchemaStore, StateStore)
from .memory import MemoryStore, NotifyingStore
from .sql import SqliteStore
