"""Destination implementations (the in-memory ones; the others are not
ported yet) and the registry that builds one from configuration."""

from .base import (CommitRange, Destination, WriteAck, event_coordinate,
                   expand_batch_events)
from .memory import (FaultAction, FaultInjectingDestination, FaultKind,
                     MemoryDestination, PoisonRejectingDestination,
                     TransactionalMemoryDestination)
from .registry import build_destination
