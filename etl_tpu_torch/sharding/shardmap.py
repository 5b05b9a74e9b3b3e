"""The persisted table→shard assignment record.

Copy of the `ShardAssignment` type of the reference's
`etl_tpu/sharding/shardmap.py`: the store keeps it; the rendezvous map
and the scale-out runtime are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field

#: assignment lifecycle (the reference's two-phase rebalance protocol)
STATUS_STEADY = "steady"
STATUS_REBALANCING = "rebalancing"


@dataclass(frozen=True)
class ShardAssignment:
    """The persisted authoritative assignment (StateStore surface).

    steady:       every pod with (epoch, shard_count) matching this
                  record owns exactly its ShardMap slice.
    rebalancing:  a two-phase epoch bump is in flight: `fence_lsn` is the
                  handoff point (everything ≤ fence must be durable at
                  the OLD owner before the flip), `moved` the tables
                  changing owner, `next_shard_count` the K the flip will
                  install. Pods keep running their current epoch until
                  the coordinator flips.
    """

    epoch: int
    shard_count: int
    status: str = STATUS_STEADY
    fence_lsn: int = 0
    next_shard_count: int = 0  # 0 = no rebalance in flight
    # ((table_id, old_shard, new_shard), ...) — tuple for hashability
    moved: tuple = field(default=())

    @property
    def rebalancing(self) -> bool:
        return self.status == STATUS_REBALANCING

    def to_json(self) -> dict:
        return {
            "epoch": self.epoch,
            "shard_count": self.shard_count,
            "status": self.status,
            "fence_lsn": self.fence_lsn,
            "next_shard_count": self.next_shard_count,
            "moved": [list(m) for m in self.moved],
        }

    @classmethod
    def from_json(cls, doc: dict) -> "ShardAssignment":
        return cls(
            epoch=int(doc["epoch"]),
            shard_count=int(doc["shard_count"]),
            status=str(doc.get("status", STATUS_STEADY)),
            fence_lsn=int(doc.get("fence_lsn", 0)),
            next_shard_count=int(doc.get("next_shard_count", 0)),
            moved=tuple(tuple(m) for m in doc.get("moved", [])),
        )
