"""State/schema stores: the in-memory ones and the durable SQL stores
(sqlite, and Postgres over the wire client)."""

from .base import (DeadLetterEntry, DestinationTableMetadata, PipelineStore,
                   QuarantineRecord, SchemaStore, StateStore)
from .memory import MemoryStore, NotifyingStore
from .sql import PostgresStore, SqliteStore
