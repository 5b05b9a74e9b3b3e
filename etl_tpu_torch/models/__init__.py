"""Core data model: LSNs, schemas+masks, cells, rows, events, errors
(copies of the reference's `etl_tpu/models`)."""

from .cell import (JSON_NULL, TOAST_UNCHANGED, PgInterval, PgNumeric, PgSpecialDate,
                   PgSpecialTimestamp, PgTimeTz, py_value_kind)
from .errors import (EtlError, ErrorKind, RetryDirective, RetryKind,
                     etl_error, retry_directive)
from .event import (BeginEvent, ChangeType, CommitEvent, DecodedBatchEvent,
                    DeleteEvent, Event, EventSequenceKey, InsertEvent,
                    RelationEvent, ROW_EVENT_TYPES, SchemaChangeEvent,
                    TruncateEvent, UpdateEvent, event_size_hint)
from .lsn import Lsn
from .pgtypes import CellKind, Oid, array_element, is_array_oid, kind_for_oid
from .schema import (ColumnMask, ColumnSchema, ColumnModification,
                     ReplicatedTableSchema, SchemaDiff, SnapshotId, TableId,
                     TableName, TableSchema, apply_column_changes)
from .table_row import (Column, ColumnarBatch, PartialTableRow, TableRow,
                        TextArray, dense_dtype, value_size_hint)

__all__ = [n for n in dir() if not n.startswith("_")]
