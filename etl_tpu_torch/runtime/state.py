"""Re-export shim: the table state machine lives in models (model-level,
no runtime dependencies) — this path is kept for discoverability next to
the workers that drive the transitions.

Copy of the reference's `etl_tpu/runtime/state.py`.
"""

from ..models.table_state import (PERSISTENT_STATES, TableState,
                                  TableStateType)

__all__ = ["PERSISTENT_STATES", "TableState", "TableStateType"]
