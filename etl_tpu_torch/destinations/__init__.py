"""Destination implementations (the in-memory ones; the others are not
ported yet)."""

from .base import (CommitRange, Destination, WriteAck, event_coordinate,
                   expand_batch_events)
from .memory import (FaultAction, FaultInjectingDestination, FaultKind,
                     MemoryDestination, PoisonRejectingDestination,
                     TransactionalMemoryDestination)
