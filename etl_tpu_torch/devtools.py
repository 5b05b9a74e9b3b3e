"""Dev automation: `python -m etl_tpu_torch.devtools <command>`.

The xtask analogue (reference crates/xtask: docker Postgres clusters,
chaos injection, pg-fill-table, benchmark orchestration) for an
environment with no docker/k8s: the cluster is the socket-level fake
server, and chaos is driven through its connection-severing hooks.

Commands:
  serve-source   start a fake PG server with N generated rows (the
                 pg-fill-table + `cargo x postgres start` analogue);
                 prints the port and streams CDC traffic if requested.
                 `--workload <profile>` serves a named adversarial
                 profile from workloads/ instead (update/delete/
                 TOAST/truncate/DDL/partitioned traffic, deterministic
                 per (profile, --seed))
  chaos          run a pipeline over real TCP against the fake server
                 while repeatedly severing every replication stream
                 (NetworkChaos partition analogue), then verify exactly-
                 once delivery to the destination
  fuzz           seeded parser fuzzing (testing/fuzz.py)
  bench-compare  diff two benchmark JSON reports (benchmarks/compare.py)
  fill-table     bulk-load a table over the wire client — parallel
                 connections, multi-row batches (xtask pg-fill-table)
  rotate-encryption-key  re-encrypt stored control-plane configs under a
                 new AES-GCM key (xtask rotate-encryption-key)

Copy of the reference's `etl_tpu/devtools.py`. `chaos` runs the port's
`Pipeline` with `--engine cuda` (the default; the reference's `tpu`) and
decodes on the card unless `--device cpu` is given; with no card and
neither `--engine cpu` nor `--device cpu` it exits 1 and runs nothing.
Each scenario's report also carries the decoder's kernel launches and
device-routed batches (`k1_launches`, `device_batches`): on the card
every device-routed batch launched K1 once, and on the CUDA engine some
batch took the device route, or the scenario fails.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys


def _make_filled_db(n_rows: int, n_tables: int = 1):
    from .models import ColumnSchema, Oid, TableName, TableSchema
    from .postgres.fake import FakeDatabase

    db = FakeDatabase()
    tids = []
    for t in range(n_tables):
        tid = 20000 + t
        db.create_table(TableSchema(
            tid, TableName("public", f"filled_{t}"),
            (ColumnSchema("id", Oid.INT8, nullable=False,
                          primary_key_ordinal=1),
             ColumnSchema("bucket", Oid.INT4),
             ColumnSchema("payload", Oid.TEXT))),
            rows=[[str(i + 1), str(i % 97), f"payload-{t}-{i}" + "x" * 40]
                  for i in range(n_rows)])
        tids.append(tid)
    db.create_publication("pub", tids)
    return db, tids


async def serve_source(args) -> int:
    from .testing.fake_pg_server import FakePgServer

    gen = None
    if args.workload:
        from .workloads import WorkloadGenerator

        gen = WorkloadGenerator(args.workload, seed=args.seed)
        db, tids = gen.build_db(), gen.table_ids
    else:
        db, tids = _make_filled_db(args.rows, args.tables)
    server = FakePgServer(db)
    await server.start()
    info = {"port": server.port, "publication": "pub"}
    if gen is not None:
        info.update(gen.describe())
        info["seed"] = args.seed
    else:
        info["rows_per_table"] = args.rows
    info["tables"] = tids  # the published table OIDs (roots when partitioned)
    print(json.dumps(info))
    if args.cdc_rate > 0 and gen is not None:
        # profile-shaped CDC: generator steps until ~cdc_rate row ops
        # landed this second (a step's op count varies by profile — a
        # giant_tx step alone is 512 ops)
        while True:
            ops0 = gen.row_ops
            while gen.row_ops - ops0 < args.cdc_rate:
                await gen.run_tx(db)
            await asyncio.sleep(1.0)
    if args.cdc_rate > 0:
        i = args.rows
        while True:
            remaining = args.cdc_rate  # full requested rows/second
            while remaining > 0:
                tx = db.transaction()
                for _ in range(min(remaining, 500)):
                    i += 1
                    tx.insert(tids[i % len(tids)],
                              [str(i + 1), str(i % 97), f"cdc-{i}"])
                remaining -= 500
                await tx.commit()
            await asyncio.sleep(1.0)
    await asyncio.Event().wait()
    return 0


async def _chaos_scenario(args, scenario: str) -> tuple[dict, bool]:
    """One chaos scenario over a live pipeline on real TCP (the Chaos
    Mesh matrix analogue, xtask chaos/scenario.rs: PacketLoss /
    Partition / Latency). Scenarios:

      partition    sever every replication stream each interval
                   (NetworkChaos Partition) — no loss, NO duplicate
                   events;
      latency      route all wire traffic through a TCP proxy adding
                   delay±jitter per chunk (NetworkChaos Latency / tc
                   netem delay) — no loss, no duplicates, just slower;
      corruption   the proxy flips a byte in every Nth server→client
                   chunk (tc netem corrupt): the wire client must
                   surface typed protocol errors and reconnect —
                   no loss, no duplicates;
      copy         partitions injected DURING the initial table copy
                   (sever until the table reaches READY): the copy's
                   crash-marker/fencing must land exactly the source
                   row set, then CDC flows;
      destination  scripted destination faults (reject before apply +
                   fail AFTER apply) — no loss; duplicates are the
                   at-least-once redeliveries idempotent destinations
                   collapse, bounded by the injected fail-after-apply
                   count;
      slot         invalidate the apply slot mid-stream (max_slot_wal_
                   keep_size eviction) with recreate_and_resync — the
                   pipeline must resync and converge with no loss.
    """
    from .benchmarks.harness import counts_delta, kernel_counts
    from .config import (BatchConfig, BatchEngine, InvalidatedSlotBehavior,
                         PgConnectionConfig, PipelineConfig, RetryConfig)
    from .destinations import MemoryDestination
    from .destinations.memory import (FaultAction, FaultInjectingDestination,
                                      FaultKind)
    from .models import InsertEvent
    from .postgres.client import PgReplicationClient
    from .runtime import Pipeline, TableStateType
    from .store import NotifyingStore
    from .testing.fake_pg_server import FakePgServer

    from .testing.chaos_proxy import ChaosProxy

    db, tids = _make_filled_db(args.rows)
    tid = tids[0]
    server = FakePgServer(db)
    await server.start()
    proxy: ChaosProxy | None = None
    port = server.port
    if scenario == "latency":
        proxy = ChaosProxy("127.0.0.1", server.port,
                           delay_ms=args.latency_ms,
                           jitter_ms=args.latency_ms / 4)
    elif scenario == "corruption":
        # armed AFTER the initial copy reaches READY (corrupting the
        # copy stream is the `copy` scenario's territory; corrupting
        # every 6th copy chunk would just starve convergence)
        proxy = ChaosProxy("127.0.0.1", server.port)
    elif scenario == "copy":
        proxy = ChaosProxy("127.0.0.1", server.port)
    if proxy is not None:
        await proxy.start()
        port = proxy.port
    cfg = PgConnectionConfig(host="127.0.0.1", port=port,
                             name="postgres", username="etl")
    store = NotifyingStore()
    memory = MemoryDestination()
    dest = memory
    fail_after_applies = 0
    if scenario == "destination":
        dest = FaultInjectingDestination(memory)
    counts0 = kernel_counts()
    pipeline = Pipeline(
        config=PipelineConfig(
            pipeline_id=1, publication_name="pub", pg_connection=cfg,
            batch=BatchConfig(max_fill_ms=40,
                              batch_engine=BatchEngine(args.engine),
                              device=args.device),
            apply_retry=RetryConfig(max_attempts=100, initial_delay_ms=50,
                                    max_delay_ms=200),
            invalidated_slot_behavior=
                InvalidatedSlotBehavior.RECREATE_AND_RESYNC),
        store=store, destination=dest,
        source_factory=lambda: PgReplicationClient(cfg))
    ready = store.notify_on(tid, TableStateType.READY)
    await pipeline.start()
    copy_severs = 0
    if scenario == "copy":
        # partition the wire REPEATEDLY while the initial copy runs;
        # stop as soon as the table reaches READY so the run converges
        # tight cadence: the copy has to be HIT while in flight, so
        # sever early and often rather than on the CDC interval
        for _ in range(args.copy_severs):
            if ready.done():
                break
            await asyncio.sleep(0.05)
            if ready.done():
                # READY landed during the sleep: a sever now would hit
                # the CDC stream, not the copy — counting it would
                # false-green the copy_severs > 0 gate
                break
            proxy.sever()
            copy_severs += 1
    await asyncio.wait_for(ready, 120)
    if scenario == "corruption":
        proxy.corrupt_every = 6

    n_cdc = 0
    disruptions = 0
    deadline = asyncio.get_event_loop().time() + args.seconds
    while asyncio.get_event_loop().time() < deadline:
        tx = db.transaction()
        for _ in range(50):
            n_cdc += 1
            tx.insert(tid, [str(10**6 + n_cdc), "0", f"chaos-{n_cdc}"])
        await tx.commit()
        await asyncio.sleep(args.interval / 2)
        disruptions += 1
        if scenario == "partition":
            await db.sever_streams()  # the NetworkChaos partition
        elif scenario in ("latency", "corruption", "copy"):
            # latency/corruption chaos is CONTINUOUS (every forwarded
            # chunk); copy's partitions already happened pre-READY —
            # the loop only produces CDC traffic to converge on
            disruptions -= 1
        elif scenario == "destination":
            # both failure sides of a write: before apply (clean retry)
            # and AFTER apply (forces redelivery of applied events)
            dest.script("write_events", FaultAction(FaultKind.REJECT))
            dest.script("write_events",
                        FaultAction(FaultKind.FAIL_AFTER_APPLY))
            fail_after_applies += 1
        elif scenario == "slot" and disruptions == 2:
            # one mid-stream eviction is the scenario; repeated
            # invalidations would just repeat the same resync
            from .postgres.slots import apply_slot_name

            db.invalidate_slot(apply_slot_name(1))
            await db.sever_streams()
        await asyncio.sleep(args.interval / 2)

    def delivered():
        return {e.row.values[0] for e in memory.events
                if isinstance(e, InsertEvent)}

    def resynced():
        # a slot resync re-copies rows instead of re-streaming them
        return {r.values[0] for r in (memory.table_rows.get(tid) or [])}

    expected = {10**6 + i for i in range(1, n_cdc + 1)}
    for _ in range(600):
        if delivered() | resynced() >= expected:
            break
        await asyncio.sleep(0.1)
    got = delivered() | resynced()
    missing = expected - got
    await pipeline.shutdown_and_wait()
    await server.stop()
    if proxy is not None:
        await proxy.stop()
    counts = counts_delta(counts0)
    dup_count = sum(
        1 for e in memory.events if isinstance(e, InsertEvent)) \
        - len(delivered())
    copied = [r.values[0] for r in (memory.table_rows.get(tid) or [])]
    report = {"scenario": scenario, "disruptions": disruptions,
              "cdc_rows": n_cdc, "delivered": len(got & expected),
              "missing": sorted(missing)[:20],
              "duplicate_events": dup_count,
              "engine": args.engine, "device": args.device,
              "k1_launches": counts["k1_launches"],
              "device_batches": counts["device_batches"]}
    if scenario == "partition":
        ok = (not missing and dup_count == 0
              and len(memory.table_rows[tid]) >= args.rows)
    elif scenario == "latency":
        report["delay_ms"] = args.latency_ms
        ok = not missing and dup_count == 0
    elif scenario == "corruption":
        # the proxy must actually have flipped bytes for this run to
        # mean anything; recovery must be loss- and duplicate-free
        report["corrupted_chunks"] = proxy.corrupted
        ok = not missing and dup_count == 0 and proxy.corrupted > 0
    elif scenario == "copy":
        # chaos DURING the copy: partitions were injected pre-READY and
        # the destination's table rows must be EXACTLY the source set —
        # a lost CTID range shows as missing, a refetched one as dupes
        src = set(range(1, args.rows + 1))  # the pre-CDC table content
        report["copy_severs"] = copy_severs
        report["copy_rows"] = len(copied)
        report["copy_dupes"] = len(copied) - len(set(copied))
        ok = (not missing and copy_severs > 0
              and set(copied) == src and len(copied) == args.rows)
    elif scenario == "destination":
        # duplicates are EXPECTED here (fail-after-apply forces
        # redelivery) but must be bounded by the injected faults x batch
        ok = not missing and dup_count <= fail_after_applies * 64
    else:  # slot
        ok = not missing and bool(memory.dropped_tables)
    # the decoder's route: on the CUDA engine some batch went to the
    # device route, and on the card each such batch launched K1 once
    on_card = args.engine == "cuda" and args.device.split(":")[0] == "cuda"
    launches_ok = (counts["device_batches"] > 0
                   if args.engine == "cuda" else True) and (
        counts["launches"] == counts["device_batches"] if on_card
        else counts["launches"] == 0)
    report["launches_ok"] = launches_ok
    return report, ok and launches_ok


async def chaos(args) -> int:
    if args.engine == "cuda" and args.device.split(":")[0] == "cuda":
        import torch

        if not torch.cuda.is_available():
            # no fallback to the CPU: the run is on the card or not run
            print("chaos: --engine cuda --device cuda: no CUDA device is "
                  "available; nothing run (pass --engine cpu or --device "
                  "cpu to run on the CPU)", file=sys.stderr)
            return 1
        from .ops import decode_kernel

        # a failed build fails here, before a run; built off the loop
        await asyncio.to_thread(decode_kernel.load)
    scenarios = (["partition", "latency", "corruption", "copy",
                  "destination", "slot"]
                 if args.scenario == "all" else [args.scenario])
    failed = []
    for sc in scenarios:
        report, ok = await _chaos_scenario(args, sc)
        print(json.dumps(report))
        if not ok:
            failed.append(sc)
    if failed:
        print(f"CHAOS FAILED: {failed}", file=sys.stderr)
        return 1
    print(f"chaos OK: {', '.join(scenarios)} — no loss",
          file=sys.stderr)
    return 0


async def fill_table(args) -> int:
    """Bulk-load a table over the wire client (reference xtask
    pg-fill-table): N parallel connections issuing multi-row INSERT
    literals (the loader owns every value — ids are sequential ints, the
    payload is a fixed [a-z0-9] filler — so literal SQL is the fastest
    correct shape, like the reference's psql COPY feed), until --rows
    rows of --row-bytes payload landed. Prints one JSON line with
    sustained rows/s and bytes/s."""
    import os
    import random
    import time

    from .config.pipeline import PgConnectionConfig
    from .postgres.client import wire_connection_from_config

    cfg = PgConnectionConfig(
        host=args.host, port=args.port, name=args.database,
        username=args.username,
        password=args.password or os.environ.get("POSTGRES_PASSWORD", ""))
    setup = wire_connection_from_config(cfg, application_name="etl_fill")
    await setup.connect()
    await setup.query(
        f"CREATE TABLE IF NOT EXISTS {args.table} ("
        f"id BIGINT PRIMARY KEY, bucket INT, payload TEXT)")
    await setup.close()

    counter = {"rows": 0, "bytes": 0}
    rng = random.Random(11)
    alphabet = "abcdefghijklmnopqrstuvwxyz0123456789"
    filler = "".join(rng.choice(alphabet) for _ in range(args.row_bytes))

    async def worker(wid: int, base: int, n: int) -> None:
        conn = wire_connection_from_config(
            cfg, application_name=f"etl_fill_{wid}")
        await conn.connect()
        done = 0
        while done < n:
            chunk = min(args.batch_rows, n - done)
            values = ", ".join(
                f"({base + done + k + 1}, {(done + k) % 97}, "
                f"'{filler}')" for k in range(chunk))
            await conn.query(
                f"INSERT INTO {args.table} (id, bucket, payload) "
                f"VALUES {values}")
            done += chunk
            counter["rows"] += chunk
            counter["bytes"] += chunk * (args.row_bytes + 16)
        await conn.close()

    per = -(-args.rows // args.parallelism)
    t0 = time.perf_counter()
    await asyncio.gather(*(worker(i, i * per,
                                  min(per, args.rows - i * per))
                           for i in range(args.parallelism)
                           if args.rows - i * per > 0))
    dt = time.perf_counter() - t0
    print(json.dumps({
        "table": args.table, "rows": counter["rows"],
        "bytes": counter["bytes"], "seconds": round(dt, 3),
        "rows_per_sec": round(counter["rows"] / max(dt, 1e-9)),
        "parallelism": args.parallelism}))
    return 0


def rotate_encryption_key(args) -> int:
    """Re-encrypt every stored source/destination config under a new
    primary key (reference xtask rotate-encryption-key). Keys are
    '<id>:<base64-32-bytes>'; rows already on the new key id are left
    untouched, so the command is idempotent and restartable."""
    import sqlite3

    from .api.crypto import ConfigCipher, EncryptionKey

    def parse_key(s: str) -> EncryptionKey:
        kid, _, b64 = s.partition(":")
        return EncryptionKey.from_base64(int(kid), b64)

    new = parse_key(args.new_key)
    olds = [parse_key(s) for s in args.old_key]
    cipher = ConfigCipher(new, olds)
    db = sqlite3.connect(args.db)
    rotated = skipped = 0
    try:
        for table in ("api_sources", "api_destinations"):
            for row_id, enc in db.execute(
                    f"SELECT id, config_enc FROM {table}").fetchall():
                if json.loads(enc).get("key_id") == new.key_id:
                    skipped += 1
                    continue
                db.execute(f"UPDATE {table} SET config_enc = ? WHERE "
                           f"id = ?", (cipher.rotate(enc), row_id))
                rotated += 1
        db.commit()
    finally:
        db.close()
    print(json.dumps({"rotated": rotated, "already_current": skipped,
                      "new_key_id": new.key_id}))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="etl_tpu_torch.devtools")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("serve-source",
                        help="fake PG server with generated data")
    sp.add_argument("--rows", type=int, default=10_000)
    sp.add_argument("--tables", type=int, default=1)
    sp.add_argument("--cdc-rate", type=int, default=0,
                    help="rows/second of continuous CDC traffic (with "
                         "--workload: row OPS/second of profile-shaped "
                         "traffic)")
    sp.add_argument("--workload", default=None, metavar="PROFILE",
                    help="serve a named workload profile from "
                         "workloads/ (update/delete/TOAST/"
                         "truncate/DDL/partitioned shapes; see "
                         "docs/workloads.md) instead of generated "
                         "filler rows; --rows/--tables are then owned "
                         "by the profile. Deterministic per "
                         "(profile, --seed)")
    sp.add_argument("--seed", type=int, default=7,
                    help="workload generator seed (with --workload)")

    cp = sub.add_parser("chaos", help="chaos scenario matrix")
    cp.add_argument("--rows", type=int, default=2_000)
    cp.add_argument("--seconds", type=float, default=10.0)
    cp.add_argument("--interval", type=float, default=1.0)
    cp.add_argument("--engine", default="cuda", choices=["cuda", "cpu"],
                    help="the batch engine: cuda (the default; the "
                         "decoder's kernels) or cpu (the per-tuple host "
                         "codec)")
    cp.add_argument("--device", default="cuda",
                    help="torch device of the cuda engine's decoders: "
                         "cuda (the default; the card, no card fails the "
                         "run) or cpu (the kernels' plain versions)")
    cp.add_argument("--scenario", default="partition",
                    choices=["partition", "latency", "corruption",
                             "copy", "destination", "slot", "all"])
    cp.add_argument("--latency-ms", type=float, default=40.0,
                    help="per-chunk proxy delay for --scenario latency")
    cp.add_argument("--copy-severs", type=int, default=3,
                    help="max partitions injected during initial copy")

    fp = sub.add_parser("fuzz", help="seeded parser fuzzing")
    fp.add_argument("--target", default=None)
    fp.add_argument("--seconds", type=float, default=10.0)
    fp.add_argument("--seed", type=int, default=None)

    bp = sub.add_parser("bench-compare", help="diff two bench reports")
    bp.add_argument("a")
    bp.add_argument("b")
    bp.add_argument("--fail-pct", type=float, default=None)

    ft = sub.add_parser("fill-table",
                        help="bulk-load a table over the wire client "
                             "(xtask pg-fill-table)")
    ft.add_argument("--host", default="localhost")
    ft.add_argument("--port", type=int, default=5432)
    ft.add_argument("--database", default="postgres")
    ft.add_argument("--username", default="postgres")
    ft.add_argument("--password", default=None,
                    help="falls back to $POSTGRES_PASSWORD")
    ft.add_argument("--table", required=True)
    ft.add_argument("--rows", type=int, default=100_000)
    ft.add_argument("--row-bytes", type=int, default=256)
    ft.add_argument("--batch-rows", type=int, default=500)
    ft.add_argument("--parallelism", type=int, default=4)

    rk = sub.add_parser("rotate-encryption-key",
                        help="re-encrypt stored configs under a new key")
    rk.add_argument("--db", required=True,
                    help="path to the control-plane sqlite database")
    rk.add_argument("--new-key", required=True,
                    help="'<id>:<base64 32-byte key>' — the new primary")
    rk.add_argument("--old-key", action="append", default=[],
                    help="'<id>:<base64>' decrypt-only key (repeatable)")

    args = p.parse_args(argv)
    if args.cmd == "serve-source":
        return asyncio.run(serve_source(args))
    if args.cmd == "chaos":
        return asyncio.run(chaos(args))
    if args.cmd == "fuzz":
        from .testing.fuzz import main as fuzz_main

        fuzz_args = []
        if args.target:
            fuzz_args += ["--target", args.target]
        fuzz_args += ["--seconds", str(args.seconds)]
        if args.seed is not None:
            fuzz_args += ["--seed", str(args.seed)]
        return fuzz_main(fuzz_args)
    if args.cmd == "bench-compare":
        from .benchmarks.compare import main as cmp_main

        cmp_args = [args.a, args.b]
        if args.fail_pct is not None:
            cmp_args += ["--fail-pct", str(args.fail_pct)]
        return cmp_main(cmp_args)
    if args.cmd == "fill-table":
        return asyncio.run(fill_table(args))
    if args.cmd == "rotate-encryption-key":
        return rotate_encryption_key(args)
    return 2


if __name__ == "__main__":
    sys.exit(main())
