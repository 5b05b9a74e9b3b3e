"""CLI: `python -m etl_tpu_torch.dlq` — operate the dead-letter store.

    python -m etl_tpu_torch.dlq --sqlite state.db --pipeline-id 1 list
    python -m etl_tpu_torch.dlq --sqlite state.db --pipeline-id 1 inspect 3
    python -m etl_tpu_torch.dlq --sqlite state.db --pipeline-id 1 \
        replay --destination-json dest.json [--table 16384] [--ids 1 2]
    python -m etl_tpu_torch.dlq --sqlite state.db --pipeline-id 1 discard 3 4
    python -m etl_tpu_torch.dlq --sqlite state.db --pipeline-id 1 \
        compact [--older-than-s 604800]
    python -m etl_tpu_torch.dlq --sqlite state.db --pipeline-id 1 quarantined
    python -m etl_tpu_torch.dlq --sqlite state.db --pipeline-id 1 \
        unquarantine 16384

`--postgres "host=.. port=.. dbname=.. user=.. password=.."` targets the
shared PostgresStore instead of a sqlite file. `replay` pushes entries
through the REAL destination seam (`destinations.registry
.build_destination` on the given JSON config → `write_event_batches`,
durably awaited) in WAL order and marks them `replayed`; it is
idempotent — replayed entries are skipped on a re-run, and re-pushed
rows are at-least-once duplicates destinations already collapse. The
runbook (docs/dead-letter.md): fix the root cause → replay → verify →
unquarantine — a running replicator adopts the lift live at its next
quarantine poll (PoisonConfig.quarantine_poll_s, default 30 s).
`compact` expires terminal (replayed/discarded) entries past the
retention window; `dead` entries never expire.

Output is one JSON document (sorted keys) per invocation; exit 0 on
success, 1 on a typed failure.

Copy of the reference's `etl_tpu/dlq/__main__.py`.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys

from ..models.errors import EtlError


def _parse_pg_dsn(dsn: str):
    from ..config import PgConnectionConfig

    fields = {}
    for part in dsn.split():
        k, _, v = part.partition("=")
        fields[k] = v
    return PgConnectionConfig(
        host=fields.get("host", "localhost"),
        port=int(fields.get("port", 5432)),
        name=fields.get("dbname", fields.get("name", "postgres")),
        username=fields.get("user", fields.get("username", "postgres")),
        password=fields.get("password"))


async def _open_store(args):
    if args.sqlite:
        from ..store import SqliteStore

        store = SqliteStore(args.sqlite, args.pipeline_id)
        await store.connect()
        return store
    from ..store import PostgresStore

    store = PostgresStore(_parse_pg_dsn(args.postgres), args.pipeline_id)
    await store.connect()
    return store


async def _run(args) -> dict:
    from . import DeadLetterQueue

    store = await _open_store(args)
    try:
        dlq = DeadLetterQueue(store)
        if args.cmd == "list":
            status = None if args.status == "all" else args.status
            entries = await dlq.list(table_id=args.table, status=status)
            return {"entries": [e.describe() for e in entries],
                    "count": len(entries)}
        if args.cmd == "inspect":
            return await dlq.inspect(args.entry_id)
        if args.cmd == "replay":
            from ..destinations import build_destination

            with open(args.destination_json) as f:
                dest = build_destination(json.load(f))
            await dest.startup()
            try:
                return await dlq.replay(
                    dest, entry_ids=args.ids or None,
                    table_id=args.table,
                    include_replayed=args.include_replayed)
            finally:
                await dest.shutdown()
        if args.cmd == "discard":
            return {"discarded": await dlq.discard(args.entry_ids)}
        if args.cmd == "compact":
            return await dlq.compact(args.older_than_s,
                                     statuses=args.status or None)
        if args.cmd == "quarantined":
            records = await dlq.quarantined()
            return {"quarantined": [r.to_json()
                                    for r in records.values()]}
        if args.cmd == "unquarantine":
            lifted = await dlq.unquarantine(args.table_id)
            return {"table_id": args.table_id, "lifted": lifted}
        raise AssertionError(args.cmd)
    finally:
        close = getattr(store, "close", None)
        if close is not None:
            await close()


def main(argv: "list[str] | None" = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m etl_tpu_torch.dlq",
        description="inspect / replay / discard dead-lettered rows and "
                    "manage table quarantine (docs/dead-letter.md)")
    store_group = parser.add_mutually_exclusive_group(required=True)
    store_group.add_argument("--sqlite", metavar="PATH",
                             help="sqlite state-store file")
    store_group.add_argument("--postgres", metavar="DSN",
                             help='Postgres store, "host=.. port=.. '
                                  'dbname=.. user=.. password=.."')
    parser.add_argument("--pipeline-id", type=int, required=True)
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_list = sub.add_parser("list", help="list dead-letter entries")
    p_list.add_argument("--table", type=int, default=None)
    p_list.add_argument("--status", default="dead",
                        choices=["dead", "replayed", "discarded", "all"])

    p_inspect = sub.add_parser("inspect",
                               help="one entry with decoded payload")
    p_inspect.add_argument("entry_id", type=int)

    p_replay = sub.add_parser(
        "replay", help="re-deliver entries through the destination seam "
                       "(idempotent), then mark them replayed")
    p_replay.add_argument("--destination-json", required=True,
                          metavar="FILE",
                          help="destination config JSON "
                               '({"type": "bigquery", ...} — '
                               "destinations/registry.py)")
    p_replay.add_argument("--ids", type=int, nargs="*", default=None)
    p_replay.add_argument("--table", type=int, default=None)
    p_replay.add_argument("--include-replayed", action="store_true",
                          help="re-push entries already marked replayed")

    p_discard = sub.add_parser(
        "discard", help="mark entries discarded (kept for audit)")
    p_discard.add_argument("entry_ids", type=int, nargs="+")

    from ..config.pipeline import PoisonConfig

    p_compact = sub.add_parser(
        "compact", help="TTL expiry of replayed/discarded entries "
                        "older than the retention window (`dead` "
                        "entries never expire)")
    p_compact.add_argument(
        "--older-than-s", type=float,
        default=PoisonConfig().dlq_retention_s,
        help="retention window in seconds (default: "
             "PoisonConfig.dlq_retention_s, 7 days)")
    p_compact.add_argument(
        "--status", action="append", default=None,
        choices=["replayed", "discarded"],
        help="restrict expiry to these terminal statuses "
             "(repeatable; default: both)")

    sub.add_parser("quarantined", help="list quarantined tables")

    p_unq = sub.add_parser(
        "unquarantine", help="lift a table's quarantine (replay first; "
                             "a running replicator adopts the lift "
                             "live at its next quarantine poll)")
    p_unq.add_argument("table_id", type=int)

    args = parser.parse_args(argv)
    try:
        out = asyncio.run(_run(args))
    except EtlError as e:
        print(json.dumps({"error": str(e)}, sort_keys=True))
        return 1
    print(json.dumps(out, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
