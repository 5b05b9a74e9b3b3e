"""Table→shard assignment: rendezvous hashing, versioned by epoch.

Copy of the reference's `etl_tpu/sharding/shardmap.py`: the weight, its
salt and the tie rule are the same, so the port and the reference give
every table the same shard for every K.

One publication's tables are split across K replicator pods by highest-
random-weight (HRW / rendezvous) hashing: each (table, shard) pair gets
a stable 64-bit weight from blake2b, and a table lives on the shard with
the highest weight. Properties this buys (held equal to the reference's
map for every tested (table, K) in tests/test_torch_sharding.py):

  determinism      — the map is a pure function of (table_id, shard_count):
                     identical across processes, hosts, and Python hash
                     seeds (blake2b, never the salted builtin hash());
  minimal movement — growing K→K+1 moves only the tables whose new
                     shard's weight wins (≈ 1/(K+1) of them), and every
                     moved table moves TO the new shard — tables that
                     stay put keep their exact shard index, so a
                     rebalance never reshuffles unmoved tables;
  shrink symmetry  — removing the top shard (K→K-1) re-homes exactly
                     that shard's tables onto the survivors.

`ShardAssignment` is the persisted control-plane record (the StateStore
shard-assignment surface, store/base.py): the authoritative (epoch,
shard_count) every pod must agree with, plus the in-flight rebalance
bookkeeping (fence LSN, moved tables) while a two-phase epoch bump is
underway (sharding/coordinator.py).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

from ..models.errors import ErrorKind, EtlError
from ..models.schema import TableId

#: domain-separation salt for the HRW weights; changing it is a full
#: reshuffle of every deployed map — never do that
_HRW_SALT = "etl"

#: assignment lifecycle (coordinator.py two-phase protocol)
STATUS_STEADY = "steady"
STATUS_REBALANCING = "rebalancing"


def _weight(table_id: TableId, shard: int) -> int:
    digest = hashlib.blake2b(
        f"{_HRW_SALT}:{table_id}:{shard}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "big")


@dataclass(frozen=True)
class ShardMap:
    """Pure assignment function over `shard_count` shards at `epoch`.

    The epoch does NOT feed the hash — the same (tables, K) always
    produces the identical map; epochs version the *authoritative*
    assignment so a pod holding a stale map can be refused (the
    ShardScopedStore write fence, sharding/runtime.py)."""

    shard_count: int
    epoch: int = 0

    def __post_init__(self) -> None:
        if self.shard_count < 1:
            raise EtlError(ErrorKind.CONFIG_INVALID,
                           f"shard_count must be >= 1, got {self.shard_count}")
        if self.epoch < 0:
            raise EtlError(ErrorKind.CONFIG_INVALID,
                           f"epoch must be >= 0, got {self.epoch}")

    def shard_of(self, table_id: TableId) -> int:
        """HRW winner; ties (a 2^-64 event) break toward the lower shard
        index so the map stays total and deterministic."""
        best_shard = 0
        best_weight = -1
        for shard in range(self.shard_count):
            w = _weight(table_id, shard)
            if w > best_weight:
                best_weight = w
                best_shard = shard
        return best_shard

    def owns(self, table_id: TableId, shard: int) -> bool:
        return self.shard_of(table_id) == shard

    def tables_for_shard(self, table_ids, shard: int) -> "list[TableId]":
        return [tid for tid in table_ids if self.shard_of(tid) == shard]

    def partition(self, table_ids) -> "dict[int, list[TableId]]":
        """{shard: owned tables} over every shard (empty lists included —
        an operator looking at tables-per-shard must see empty shards)."""
        out: dict[int, list[TableId]] = {s: [] for s in range(self.shard_count)}
        for tid in table_ids:
            out[self.shard_of(tid)].append(tid)
        return out

    def grown(self) -> "ShardMap":
        return ShardMap(self.shard_count + 1, self.epoch + 1)

    def shrunk(self) -> "ShardMap":
        if self.shard_count == 1:
            raise EtlError(ErrorKind.CONFIG_INVALID,
                           "cannot shrink below one shard")
        return ShardMap(self.shard_count - 1, self.epoch + 1)


def moved_tables(old: ShardMap, new: ShardMap,
                 table_ids) -> "dict[TableId, tuple[int, int]]":
    """{table: (old shard, new shard)} for every table whose owner
    changes between the two maps — the rebalance quiesce set."""
    out: dict[TableId, tuple[int, int]] = {}
    for tid in table_ids:
        a, b = old.shard_of(tid), new.shard_of(tid)
        if a != b:
            out[tid] = (a, b)
    return out


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

    def shard_map(self) -> ShardMap:
        return ShardMap(self.shard_count, self.epoch)

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
