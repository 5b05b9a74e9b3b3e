#!/usr/bin/env python3
"""Smoke run of the GPU port (etl_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--seed N] [--batches N]

Phases, each printing its own lines; any failure exits non-zero without
the final result line:

1. device: the card's name, the device count, nvidia-smi's name and power
   limit. No CUDA device → exit 1.
2. build: the program store's default directory is emptied, and nvcc
   builds the decode kernels and the egress render kernel from csrc/
   through the store (`ops/program_store.py`), one nvcc a source, both
   started together (build times and the `-Xptxas -v` reports are
   printed): the cold start's nvcc.
3. kernel against its plain version, on the card, bit for bit: (a) the
   pgbench main-path layout at 262,144 rows (the canonical layout the
   unfiltered main path packs: its three INT4 columns sorted by width
   and bit width; the exact and canonical layouts print), (b) every
   dense kind raw at
   65,536 rows, (c) the integer and temporal kinds nibble-packed at
   65,536 rows. Inputs are seeded and include adversarial rows. Prints
   the walk the launch took (tile, subtile, direct), the kernel time
   (CUDA events, L2 flushed before each launch, the card held busy while
   the host enqueues: `bench.device_ms`), its bound, the launch floor (a
   one-element PyTorch op timed the same way) and the plain version's
   time; (a) is timed three times (min, median, max), and also without
   the hold, as the first two slices timed it.
   3d. the fused row filter: K2 (`filter_pack`) and the compaction
   epilogue (`compact_packed`) against their plain versions, bit for bit,
   alone and chained (`decode_pack_filtered` against
   `parse_and_pack_plain(pred=…)`), and K2c (`filter_pack_compact`, the
   two in one launch) against `parse_and_pack_plain(pred=…)` in
   `words[:, :count]`, the mask and the count: (i) the pgbench specs under
   `bid <= 5` at 262,144 rows, (ii) every comparable kind raw under a
   compound AND/OR/NOT/IS NULL filter, (iii) the integer and temporal
   kinds nibble-packed; (ii) and (iii) at 65,499 rows, not a multiple of
   the block; (iv) `bid <= 5` on two tables whose `bid` sits at another
   position, with the same dense specs, one after the other (each must
   get its own predicate descriptor). Inputs are seeded and hold NULLs, rows that fail to parse,
   dead and force-kept rows, literals that fold to constants and edge
   values. Prints each kernel's time, bound, launch floor and plain time,
   and for the epilogue and K2c the time of `words[:, keep]`; K2 and K2c
   in (i) are timed three times, as K1 in (a). Then K2c's own cases:
   keep none, keep all, a ragged batch, 2^22 rows, 50 launches back to
   back on one status buffer, two streams at once; and a layout whose
   word tile does not fit K2c, which must take K2 + the epilogue.
   3e. K1, K2 and K2c at the main-path shape in every walk (256-row
   tiles, sub-tiles of 128, 64 and 32 rows, direct), bit for bit and
   timed once.
4. main path: pgbench insert CDC payloads → framing → stage_wal_batch →
   DeviceDecoder(device="cuda") with two batches in flight, 262,144 rows
   a batch. Each batch must take the device route and launch K1 once
   (the routes print with the decoder's measured `device_min_rows`);
   the first batch must equal
   the CPU decode of the same staged batch, every batch must have its
   digest, and a row sample must equal the CPU oracle. Prints records/s,
   the stage split (framing + staging, pack, launch on the host clock,
   H2D, kernel, D2H, assemble) and the device's busy share (copies +
   kernel over the batch's wall); and K1's held time on a batch of the
   main path, beside the engine's `kernel_ms`.
5. filtered main path: the same stream under the publication filter
   `bid <= 5` (about half the rows survive). The decoder must launch K2c
   once a batch, and K2 and the epilogue never; the first batch and its
   `source_rows` must equal the CPU decoder's, the survivors must be the
   payloads' rows with bid <= 5, a row sample must equal the CPU oracle,
   and each batch must fetch at most (keep + 0.11) of the unfiltered
   bytes. Prints records/s (staged records), the stage split with the
   second D2H, the busy share and K2c's held time on a main-path batch.
6. table copy through the replication runtime (`bench.run_table_copy`):
   the port's `Pipeline` (BatchEngine.CUDA) copies a seeded
   pgbench_accounts table of 1,000,000 rows from the fake walsender until
   the table is READY, each copy partition decoding through a
   `DecodePipeline` on a CUDA stream of its own. K1 must launch, every
   chunk must take the device route, the delivered row count and an
   order-independent digest over all columns must equal the written
   rows', and 512 sampled rows must equal the CPU oracle. Prints rows/s,
   MiB/s and the stage sums.
7. CDC through the runtime (`bench.run_table_streaming`): 500,000 insert
   events in 500-row transactions (30 ms fill window) into the empty
   table. As phase 6, plus every row arriving once with its (commit LSN,
   ordinal) in order, and after shutdown no decode worker thread, nothing
   in flight and no admission tenant left. Prints events/s, p50/p95 lag
   (source commit to the destination's arrival), the pipeline's pack,
   dispatch and fetch sums with their overlap, the device busy share and
   the distribution of sealed run sizes.
8. the same CDC stream under the publication filter `bid <= 5` in offload
   mode (the walsender ships every row): K2c must launch and K2 and the
   epilogue never; the delivered rows are exactly those with bid <= 5,
   and each event's change types, commit LSNs and ordinals are compacted
   with its rows. Prints events/s (staged events), the keep share and the
   lag.

9. device egress. (a) The render kernel (`egress_render`) against its
   plain version (`egress.render_plain`), bit for bit on both outputs and
   every row: (i) the pgbench main-path specs (nibble) at 262,144 rows,
   timed three times, as K1 in (3a); (ii) every kind the `tsv` encoder
   renders, raw, at 65,536 rows, with the `tsv` plan and the `json` plan
   on the same words. Inputs are seeded: decoded junk, out-of-range and
   edge texts (integer extremes, dates at year ends, TIMESTAMPTZ shifted
   across midnight and year ends), rows of random bits, fields that
   straddle two words. (b) `bench --egress` at 262,144 rows (the min of
   2 timings, `EGRESS_ITERS`, cut for time from 3): each encoder
   alone, and the TSV and NDJSON fast paths, which must use the device
   text and equal the columnar oracle byte for byte. (c) Phase 7's CDC
   stream, with the default PipelineConfig (supervision and poison on),
   into a destination that declares the `tsv` encoder and renders every
   write's TSV body on the clock (`render_batch_tsv_fast`, minus the HTTP
   insert); the SupervisedDestination forwards its encoder. Every body must equal `render_batch_tsv_columnar` on the
   same batch, the render kernel must launch once per device run (as
   often as K1), every device run's batch must carry device text and
   every write of such batches use it, besides phase 7's and 10(a)'s
   supervision checks. Prints
   events/s, p50/p95 lag, the render and egress-fetch sums and the busy
   share beside phase 7's.

10. the reference's default PipelineConfig: supervision and poison-pill
   isolation on. (a) Phase 7's stream with PipelineConfig's defaults but
   for the pipeline id, the publication and the batch: the supervisor
   started, the destination is a SupervisedDestination, K1 launched once
   per device run, no degrade event, no `device-degraded` reason, health
   `healthy` at the end, and phase 7's checks. (b) The same stream, cut
   to 250,000 events (`POISON_EVENTS`), with 0.1 % of the rows poison
   (a `filler` starting `POISON`) into
   `PoisonRejectingDestination(counting)`, the state in a SqliteStore in a
   temporary directory and `PoisonConfig(budget_rows=1_000_000)`: every
   poison row is on the dead-letter store exactly once under its WAL key,
   every other row delivered once in (commit LSN, ordinal) order, each
   isolation's probe writes within `bisection_bound`, K1 launched, and
   `python -m etl_tpu_torch.dlq --sqlite <db> --pipeline-id 1 list` in
   another process lists the same entries. (c) The supervisor's
   host-oracle degrade (`bench.run_device_degrade`): a copy fetch held
   past a 0.5 s stall deadline with `device_degrade_threshold=1` and a
   3 s cooldown; the degrade fires, the device-routed batches and rows
   stay flat from the degrade event until it lifts while the
   oracle-routed rows rise, K1 launches once per device-routed batch over
   the run, it lifts and K1 launches again, and the delivered rows equal
   the written ones. Prints events/s and lag of (a) and (b) beside phase
   7's. The engine's forced-oracle state is checked clear before phases
   4-9, 9(c) and each of 10, and after 10(c).

11. the replicator binary over the Postgres wire protocol, against the
   port's fake server (SCRAM) in a child process: (a)
   `replicator.run_replicator` in this process at 250,000 rows and
   125,000 events (cut for time from phases 6 and 7's 1,000,000 and
   500,000),
   a PostgresStore on the same server, the `memory` destination, then
   20,000 inserts across a restart; (b) phase 8's stream from a
   publication whose catalog row filter is `bid <= 5`; (c) `python -m
   etl_tpu_torch.replicator` as a process and the DLQ CLI.

12. the binary delivering to the warehouse destinations over HTTP, each
   against its fake in a child process (`testing.http_process`): (a)
   ClickHouse at 11(a)'s sizes with its restart: delivered rows equal the
   written ones (count and digest), every `_CHANGE_SEQUENCE_NUMBER` once
   across the restart (the `_etl_commit_log` seam), 512 seeded rows'
   delivered TSV lines byte for byte the host encoder's on the written
   rows, the render kernel once per device-routed batch (as K1) and
   device-rendered writes counted, the DDL once a lifetime; then 100,000
   events under the catalog's `bid <= 5` (K2c, no device text: the host
   encoder by routing). (b) BigQuery Storage Write at 200,000 rows and
   100,000 events (cut for time): rows decoded by `StorageWriteFake` and
   by `pb_reader` equal the written ones, each sequence number once,
   render launches as K1. (c) Snowflake: a line of its own says whether
   zstandard imports; where it does, Snowpipe Streaming at 11(a)'s sizes
   with its restart against `FakeSnowpipeServer` in a child process:
   the delivered rows' count and digest, each `_CHANGE_SEQUENCE_NUMBER`
   once across the restart (the offset tokens), 512 seeded rows' NDJSON
   lines byte for byte the host encoder's, render = K1 = device-routed
   batches; where it does not, the destination's typed refusal
   (CONFIG_INVALID naming zstandard) and a line saying Snowflake did not
   run. Each is printed beside 11(a) of the same call; then a whole run
   without a copy (start, warm-up, CDC, checks) per destination (memory,
   ClickHouse, BigQuery) under cProfile gives its share of the main
   thread's own time.

13. sharded replication (`bench_sharded`): K = 2 → 3 shard pods over one
   fake source and one shared store; each pod's K1 + K2c launches equal
   its device-routed batches.

14. the chaos corpus, the pod kill, the multi-pipeline crash and the DLQ
   scenarios, every batch through K1 (`device_floor(1)`). The two
   program-cache scenarios run on the program store and must launch K1:
   the warm restart builds nothing and loads from disk, the corrupt one
   counts an invalid miss and rebuilds, its nvcc seconds printed.

15. exactly-once and the ack window (`exactly_once_phase`): the hard-kill
   matrix and the K-in-flight crash, the `--ack-latency` (both engines),
   `--poison` and `--exactly-once` (both engines) modes at their
   BENCH_FLOOR.json smoke sizes, each ratio beside its floor, and (c) the
   decoder's leftover parity cases on K1; K1 = device-routed batches in
   every run on the CUDA engine.

16. the benchmark harness (`harness_phase`): the workload matrix with the
   three filter profiles (K2c), the multi-pipeline mode, K = 1 and K = 2
   shard worker processes (each worker's launches = its device-routed
   batches, beside phase 13), lag at 25 % and 75 % of the maximum, the
   wide row, and `python -m etl_tpu_torch.bench --smoke` as a process
   (its exit code, gates and `not_ported` printed; it gates the
   `coldstart_*` smoke sizes, none of which may be listed not ported, and
   both lint gates — the AST pass with `--check-baseline`, and the IR
   tier on the card with its mesh variants — must hold, as must the
   mesh gate (`bench --mesh-check` at `mesh_smoke_rows`, 8 shards on
   the card), with nothing (but the Parquet floor where pyarrow is
   missing) left not ported).

17. the autoscale controller and the control plane
   (`autoscale_api_phase`): (a) `run_autoscale_surge_drain` and
   `run_autoscale_controller_crash` (seed 7) on the card, each green,
   with the decision trace and K trajectory of the same seed on the CPU,
   K1 launches = the pods' device-routed batches > 0, at the CPU run's
   threshold (`device_floor(DEVICE_MIN_ROWS)`: no probe moves its 64-105
   row batches off K1); (b) `bench
   --autoscale` (reaction ticks ≤ autoscale_reaction_ticks_max, the same
   trace twice, back to the starting K) and phase 16's `bench --smoke`
   holding the autoscale gates with rc 0; (c) the API served on
   localhost starts `python -m etl_tpu_torch.replicator` children through
   `LocalOrchestrator` (`benchmarks.control_plane`): K = 1 copies and
   streams through K1 on the card, a shard rebalance and `scale_pipeline`
   roll it to K = 2, each child's own `/metrics` shows K1 work, every
   sequence key arrives once and the stop leaves no child.

18. devtools and the fleet reconciler (`fleet_phase`); (a) and (b)'s
   processes run beside (c) and (d): (a) `python -m
   etl_tpu_torch.devtools chaos --scenario all --engine cuda` at the
   reference's defaults (2,000 rows, 10 s a scenario, 1 s interval,
   40 ms latency): partition, latency, corruption, copy, destination and
   slot each pass the reference's checks (no loss; no duplicate but the
   destination scenario's bounded redeliveries; `copy_severs` > 0 before
   READY; the slot's resync), each with K1 launches = its device-routed
   batches > 0; (b) `python -m etl_tpu_torch.chaos --fleet --seed 7` and
   `bench --fleet`: exit 0 with the converge ticks, actuation counts,
   resume modes, bus actions and actuation-trace digest of the CPU run
   (`FLEET_CHAOS_SEED7`, `FLEET_BENCH_SEED7`, which the tests hold to the
   reference), and phase 16's `bench --smoke` holding the fleet gate;
   (c) a `FleetReconciler` over `OrchestratorFleetRuntime(
   LocalOrchestrator)` and a SqliteStore (`benchmarks.fleet.
   run_fleet_children`): pipelines A (K = 1) and B (K = 2) of two tenants
   converge from empty, each replicator child healthy with K1 work on its
   own `/metrics`; one edit deletes B and rolls A to K = 2 while the
   coordinator is killed in both crash windows of the journal (the
   successor settles B's delete with no runtime call and re-drives A's
   resize), a CDC wave into A, `/v1/fleet` desired = observed, every key
   once, no double actuation, no child left; (d) two pipelines on
   `global_admission()` under the bus's `AdmissionWeightPolicy`
   (`run_admission_weights`, 50,000 inserts each): the boosted and the
   base weight in the scheduler, both streams verified by count and
   digest, K1 = device-routed batches, the scheduler drained.

19. the lake, Iceberg and maintenance (`lake_phase`): (a) prints on a
   line of its own whether pyarrow imports; (b) `fuzz_avro_ocf` at
   `tests/test_fuzz.py`'s seed 20260729 for its 300 cases, the port's
   Iceberg OCF writer against the port's independent reader (no
   pyarrow needed); (c) where pyarrow is missing:
   `LakeDestination`, `IcebergDestination`, `python -m
   etl_tpu_torch.maintenance` and `run_replicator` over a config with
   `destination: lake` each refuse with CONFIG_INVALID naming pyarrow;
   (d) where pyarrow imports: phases 6 and 7's pgbench copy and CDC
   through K1 into a `LakeDestination` (`bench.run_lake_cdc`), its
   `read_current` equal to the written rows, K1 = device-routed batches;
   (e) the same depth through K1 into an `IcebergDestination` against
   the port's `FakeIcebergCatalog` (`bench.run_iceberg_cdc`), read back
   through the snapshot chain, the Avro manifests, Parquet and the CDC
   collapse: the live rows equal the written rows by count, digest and
   column, no commit rejected, K1 = device-routed batches; (f) `python
   -m etl_tpu_torch.maintenance --warehouse DIR` (compaction), then with
   `--vacuum`, then `--history`, as processes over (d)'s lake, after
   (e), so that neither runs beside the other: each exits 0, and the
   lake's current view after them equals (d)'s. No kernel is added; the launch
   counts are set to 0 just before (d) and (e) and read just after each.

20. the program store and autotune (`program_store_phase`): (a) the
   routing cost model fitted on the card (fixed ms, round-trip GB/s, the
   host route's column-rows/s and per-call ms), pgbench batches of 64,
   128 and 256 rows timed through the host route and through K1, the
   resolved `device_min_rows` of pgbench_accounts and of the coldstart
   schema, phase 4's batches each through K1, and every phase's device,
   host and oracle batches; (b) `python -m etl_tpu_torch.bench
   --coldstart` (started as a process before phase 14, so that its cold
   build overlaps it: its seconds are taken under that load) at
   BENCH_FLOOR.json's full coldstart sizes (3 tables, 800 rows a transaction, 2
   transactions), two lifetimes on a fresh cache directory: each prints
   its nvcc seconds, builds, disk hits, oracle rows and start,
   first-durable and total seconds; the warm restart builds nothing, and
   each run's K1 launches equal its device-routed batches.

21. etl-lint over the port (`lint_phase`): (a) the AST,
   interprocedural and concurrency tiers over etl_tpu_torch/ in this
   process (its seconds, its findings, the baseline's entries, none past
   the baseline) and `python -m etl_tpu_torch.analysis --check-baseline`
   as a process beside (b), exit 0; (b) the IR tier on the card
   (`analysis.ir.runner`) at 4,096 and 262,144 rows, pgbench's
   main-path batch, with the main path's own observed signature added
   to the catalogue by one decode into a store of the phase's own: the
   programs per variant, each contract's findings (0, `ir-host-callback`
   checked under CUDA's sync debug mode), K1, K2c (or K2 + the
   epilogue) and the render launched exactly as often as the catalogue
   has programs of their variants (counts set to 0 just before), every
   launch bit for bit against its plain version; (c) two deliberate
   violations built in the phase: a K1 launch wrapper that reads
   `.item()` before it returns must raise `ir-host-callback`, a render
   handed back one row larger than its plan `ir-egress-output-budget`.
   The card's name and power limit print beside the seconds.

22. the row-sharded decode mesh (`mesh_phase`; `parallel/mesh.py`), 8
   shards on the one card (`decode_mesh([cuda:0] * 8)`): (a) at the main
   path's shape (262,144 pgbench rows, nibble) K1, the render (`tsv`)
   and K2c (`bid <= 5`) launched on each shard's row block through the
   shard helpers, 8 launches each, bit for bit against the plain
   versions — K1's words and per-shard fallback counts against
   `parse_and_pack_plain(…, n_shards=8)` on the CPU, K2c's survivors,
   the bit-joined mask and the 8 counts against the same with the
   filter, the render against `render_plain` of the whole batch — and
   each kernel's 8 shard launches back to back held against one
   whole-batch launch; (b) `DeviceDecoder(mesh=…, mesh_min_rows=0)` over
   phase 4's payloads, 3 batches (`MESH_BATCHES`) with two in flight,
   unfiltered and under `bid <= 5`: every batch equal to the
   single-card decoder's (phases 4 and 5, `source_rows` = the truth), K1
   or K2c 8 launches a batch, counts set to 0 just before each and read
   just after (every kernel's counts of the two runs, summed, are the
   phase's launches in the `kernels` line); (c) `bench --mesh-check` and (d) `python -m
   etl_tpu_torch.analysis --programs --mesh --device cuda` as two
   processes at once: (c) ok, (d) the four mesh variants with every
   contract 0; (e) the device count: with 2 or more cards (a) and (b)
   run over the real cards too, with one the line says a mesh across
   cards was not run.

23. the port's examples on the card (`examples_phase`): (a) `python -m
   etl_tpu_torch.examples.lake_pipeline` and (b) `…iceberg_pipeline`
   (their `main()` in this process, every batch through K1 at
   `device_floor(1)`): the read-back each prints (the lake's current
   view; Iceberg's snapshots and live rows) as the example asserts it,
   K1 = the routed batches, counts set to 0 just before each and read
   just after; (c) `…control_plane --port P` as a process on a free
   port: `GET /openapi.json` 200 with the bearer key, a `/v1` route 200
   with it and 401 without, SIGTERM exit 0; (d) `python -m
   etl_tpu_torch.replicator --config-dir` on `examples/config/base.yaml`
   (`batch_engine: cuda`), rewritten to a `PgServerProcess`, a free
   `/metrics` port and a temporary lake and store: `/health` 200, 100,000
   rows and 50,000 events delivered to the lake (count and digest), K1
   work on the child's `/metrics`, SIGTERM exit 0; (e) `python -m
   etl_tpu_torch.testing.sanitize_framer --seconds 1.5` (the port's
   framer under ASan and UBSan: the fuzz target, the differentials, the
   pack/gather hammer), a process beside (a)-(d): exit code 0, or 77
   where the host has no ASan runtime (printed: the sanitizer did not
   run there; the CPU tests run it).

Every phase's routed batches are counted by route (device, host,
oracle), and the three must add up to the routed batches (a mesh batch
counts once a shard).

Then one JSON line of kernel records, nvidia-smi's line, and as the last
line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
SCALAR_OPS_PER_S = 67e12   # H100 SXM float32 outside the tensor cores
OPS_PER_TEXT_BYTE = 4      # compare, subtract, multiply, add per byte parsed
OPS_PER_RENDERED_BYTE = 4  # divide, modulo, add, select per byte rendered


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def time_ms(*args, **kw) -> float:
    """`etl_tpu_torch.bench.device_ms`: the device ms of one launch."""
    from etl_tpu_torch.bench import device_ms

    return device_ms(*args, **kw)


def time_runs(fn, runs: int, flush, hold: bool = True) -> list:
    """`runs` separate `time_ms(fn, 50, flush, hold)` means, in call
    order."""
    return [time_ms(fn, 50, flush=flush, hold=hold) for _ in range(runs)]


def launch_floor_ms(flush, hold: bool = True) -> float:
    """Device ms of a one-element in-place PyTorch op between the same
    events and after the same L2 flush as a kernel: the floor under any
    launch's timed ms."""
    import torch

    one = torch.zeros(1, dtype=torch.int32, device="cuda")
    return time_ms(lambda: one.add_(1), 50, flush=flush, hold=hold)


def spread(runs: list) -> str:
    s = sorted(runs)
    return (f"min={s[0]:.5f} median={s[len(s) // 2]:.5f} max={s[-1]:.5f} "
            f"(runs {', '.join(f'{x:.5f}' for x in runs)})")


def kernel_case(name, specs, nibble, rows, pool, seed, runs=1):
    """Phase 3 case: kernel vs plain version on the card; returns the
    kernel record (times, bound, error)."""
    import numpy as np
    import torch

    from etl_tpu_torch.ops import decode_kernel
    from etl_tpu_torch.ops.bitpack import (layout_for_specs,
                                           parse_and_pack_plain)
    from etl_tpu_torch.testing import field_matrix

    bm, ln = field_matrix(specs, pool, np.random.default_rng(seed), nibble)
    reps = -(-rows // pool)
    bm = np.ascontiguousarray(np.tile(bm, (reps, 1))[:rows])
    ln = np.ascontiguousarray(np.tile(ln, (reps, 1))[:rows])
    bm_d, ln_d = torch.from_numpy(bm).cuda(), torch.from_numpy(ln).cuda()
    n_words = layout_for_specs(specs).n_words
    out = torch.empty((n_words, rows), dtype=torch.int32, device="cuda")
    paths = dict(decode_kernel.path_launches)
    got = decode_kernel.decode_pack(bm_d, ln_d, specs, nibble, out=out)
    torch.cuda.synchronize()
    path = paths_taken(paths)
    want = parse_and_pack_plain(bm_d, ln_d, specs, nibble)
    torch.cuda.synchronize()
    diff = (got.view(torch.int32).long() & 0xFFFFFFFF) \
        - (want.view(torch.int32).long() & 0xFFFFFFFF)
    max_err = int(diff.abs().max().item())
    n_bad = int((diff != 0).any(dim=0).sum().item())
    check(max_err == 0, f"{name}: kernel differs from plain version on "
          f"{n_bad} of {rows} rows")
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    k_runs = time_runs(lambda: decode_kernel.decode_pack(
        bm_d, ln_d, specs, nibble, out=out), runs, scratch.zero_)
    k_ms = sorted(k_runs)[len(k_runs) // 2]
    floor_ms = launch_floor_ms(scratch.zero_)
    paced = time_runs(lambda: decode_kernel.decode_pack(
        bm_d, ln_d, specs, nibble, out=out), runs, scratch.zero_, hold=False)
    paced_floor = launch_floor_ms(scratch.zero_, hold=False)
    p_ms = time_ms(lambda: parse_and_pack_plain(bm_d, ln_d, specs, nibble), 3)
    n_bytes = bm.nbytes + ln.nbytes + n_words * 4 * rows
    n_ops = OPS_PER_TEXT_BYTE * sum(w for _, _, w, _ in specs) * rows
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / SCALAR_OPS_PER_S * 1e3
    rec = {"case": name, "rows": rows, "nibble": nibble,
           "specs": [[c, k.name, w, bw] for c, k, w, bw in specs],
           "max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "bytes": n_bytes, "library_ms": None, "ms_runs": k_runs,
           "path": path,
           "launch_floor_ms": floor_ms, "host_paced_ms_runs": paced,
           "host_paced_launch_floor_ms": paced_floor}
    print(f"  {name}: rows={rows} nibble={nibble} words={n_words} "
          f"path={path} bit-identical=yes kernel_ms={k_ms:.5f} "
          f"plain_ms={p_ms:.3f} "
          f"bound_ms={rec['bound_ms']:.5f} ({rec['bound_by']}, "
          f"{n_bytes} B) launch_floor_ms={floor_ms:.5f} library_ms=null",
          flush=True)
    if runs > 1:
        print(f"    kernel_ms over {runs} timings: {spread(k_runs)}",
              flush=True)
        print(f"    host-paced (no hold) kernel_ms: {spread(paced)}; "
              f"launch_floor_ms={paced_floor:.5f}", flush=True)
    return rec


def paths_taken(before: dict) -> str:
    """The walks (tile, subtile, direct) that K1 and K2 launched in since
    `before`, a copy of decode_kernel.path_launches."""
    from etl_tpu_torch.ops import decode_kernel

    return "+".join(f"{k}x{v - before[k]}" if v - before[k] > 1 else k
                    for k, v in decode_kernel.path_launches.items()
                    if v != before[k]) or "none"


def walk_cases(specs, nibble, rows, pool, seed, pred):
    """K1, K2 and K2c at the main-path shape in every walk (256-row tiles,
    sub-tiles of 128, 64 and 32 rows, direct; K2c with one and, on
    256-row tiles, two rows a thread), each bit for bit against its plain
    version and timed once."""
    import numpy as np
    import torch

    from etl_tpu_torch.ops import decode_kernel as dk
    from etl_tpu_torch.ops.bitpack import (filter_pack_plain,
                                           parse_and_pack_plain)
    from etl_tpu_torch.testing import filter_case as inputs

    bm, ln, fl = inputs(specs, pool, np.random.default_rng(seed), nibble)
    reps = -(-rows // pool)
    bm, ln, fl = (np.ascontiguousarray(np.tile(a, (reps,) + (1,) *
                                               (a.ndim - 1))[:rows])
                  for a in (bm, ln, fl))
    bm_d, ln_d, fl_d = (torch.from_numpy(a).cuda() for a in (bm, ln, fl))
    k1_want = parse_and_pack_plain(bm_d, ln_d, specs, nibble)
    k2_want = filter_pack_plain(bm_d, ln_d, fl_d, specs, nibble, pred,
                                dk.FILTER_BLOCK)
    k2c_want = parse_and_pack_plain(bm_d, ln_d, specs, nibble, pred=pred,
                                    row_flags=fl_d)
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    out = {}
    for walk in (256, 128, 64, 32, 0):
        k1 = dk.decode_pack(bm_d, ln_d, specs, nibble, walk=walk)
        k2 = dk.filter_pack(bm_d, ln_d, fl_d, specs, nibble, pred, walk=walk)
        rpts = (1, 2) if walk == 256 else (1,)
        k2c = [dk.filter_pack_compact(bm_d, ln_d, fl_d, specs, nibble, pred,
                                      walk=walk, rpt=rpt) for rpt in rpts]
        torch.cuda.synchronize()
        errs = [_words_err(k1, k1_want)] + [_words_err(a, b)
                                            for a, b in zip(k2, k2_want)] \
            + [e for got in k2c for e in fused_err(got, k2c_want)]
        check(all(e == 0 for e, _ in errs),
              f"walk {walk}: K1, K2 or K2c differs from its plain version "
              f"{errs}")
        k1_ms = time_ms(lambda: dk.decode_pack(bm_d, ln_d, specs, nibble,
                                               walk=walk), 50, scratch.zero_)
        k2_ms = time_ms(lambda: dk.filter_pack(bm_d, ln_d, fl_d, specs,
                                               nibble, pred, walk=walk), 50,
                        scratch.zero_)
        rec = {"k1_ms": k1_ms, "k2_ms": k2_ms}
        for rpt in rpts:
            rec[f"k2c_rpt{rpt}_ms"] = time_ms(
                lambda: dk.filter_pack_compact(bm_d, ln_d, fl_d, specs,
                                               nibble, pred, walk=walk,
                                               rpt=rpt), 50, scratch.zero_)
        out[dk.path_of(walk) + (f"{walk}" if 0 < walk < 256 else "")] = rec
        print(f"  walk {walk or 'direct'}: K1, K2 and K2c bit-identical, "
              + " ".join(f"{k[:-3]}={v:.5f}" for k, v in rec.items())
              + f" ms (K2c rows a thread as built: "
              f"{dk.compact_rows_per_thread(specs, nibble, walk)})",
              flush=True)
    return out


def _words_err(got, want) -> tuple[int, int]:
    """(max |difference| of the uint32 values, differing columns) of two
    32-bit tensors of one shape."""
    import torch

    check(got.shape == want.shape, f"shapes {got.shape} != {want.shape}")
    diff = (got.view(torch.int32).long() & 0xFFFFFFFF) \
        - (want.view(torch.int32).long() & 0xFFFFFFFF)
    if diff.dim() == 1:
        diff = diff[None, :]
    if not diff.numel():
        return 0, 0
    return int(diff.abs().max().item()), \
        int((diff != 0).any(dim=0).sum().item())


def fused_err(got, want) -> list:
    """K2c's (words, mask, counts) against the plain version's: words in
    columns [0, count) only (K2c writes no column past the count)."""
    n = int(want[2][0])
    return [_words_err(got[0][:, :n], want[0][:, :n]),
            _words_err(got[1], want[1]), _words_err(got[2], want[2])]


def fused_bytes(bm, ln, fl, n_words, survivors) -> int:
    """Bytes K2c must move: its inputs read once, the survivors' words,
    the keep mask and the count written once, and a status word a block
    plus the ticket counter."""
    rows = fl.shape[0]
    n_blocks = -(-rows // 256)
    return bm.nbytes + ln.nbytes + fl.nbytes + n_words * 4 * survivors \
        + 4 * -(-rows // 32) + 4 + 8 * (n_blocks + 1)


def filter_case(name, specs, nibble, rows, pool, seed, pred, runs=1):
    """Phase 3d case: K2, the epilogue and K2c against their plain
    versions on the card; returns (K2 record, epilogue record, K2c
    record)."""
    import numpy as np
    import torch

    from etl_tpu_torch.ops import decode_kernel as dk
    from etl_tpu_torch.ops.bitpack import (compact_packed_plain,
                                           filter_pack_plain,
                                           layout_for_specs,
                                           parse_and_pack_plain)
    from etl_tpu_torch.testing import filter_case as inputs

    bm, ln, fl = inputs(specs, pool, np.random.default_rng(seed), nibble)
    reps = -(-rows // pool)
    bm = np.ascontiguousarray(np.tile(bm, (reps, 1))[:rows])
    ln = np.ascontiguousarray(np.tile(ln, (reps, 1))[:rows])
    fl = np.ascontiguousarray(np.tile(fl, reps)[:rows])
    bm_d, ln_d, fl_d = (torch.from_numpy(a).cuda() for a in (bm, ln, fl))
    args = (bm_d, ln_d, fl_d, specs, nibble, pred)
    paths = dict(dk.path_launches)
    k2 = dk.filter_pack(*args)
    path = paths_taken(paths)
    k2_want = filter_pack_plain(*args, dk.FILTER_BLOCK)
    epi = dk.compact_packed(*k2)
    keep = k2_want[0].new_zeros(rows, dtype=torch.bool)
    keep_np = np.unpackbits(k2_want[1].cpu().numpy().view(np.uint8),
                            bitorder="little")[:rows].astype(bool)
    keep[torch.from_numpy(keep_np).cuda()] = True
    epi_want = compact_packed_plain(k2_want[0], keep)
    full = dk.decode_pack_filtered(*args)
    full_want = parse_and_pack_plain(bm_d, ln_d, specs, nibble, pred=pred,
                                     row_flags=fl_d)
    fpaths = dict(dk.path_launches)
    fused = dk.filter_pack_compact(*args)
    fpath = paths_taken(fpaths)
    torch.cuda.synchronize()
    k2_err = [_words_err(a, b) for a, b in zip(k2, k2_want)]
    epi_err = [_words_err(epi[0], epi_want[0]),
               _words_err(epi[1], epi_want[2])]
    full_err = [_words_err(a, b) for a, b in zip(full, full_want)]
    k2c_err = fused_err(fused, full_want)
    for what, errs in (("K2", k2_err), ("epilogue", epi_err),
                       ("K2 + epilogue", full_err), ("K2c", k2c_err)):
        check(all(e == 0 for e, _ in errs),
              f"{name}: {what} differs from its plain version "
              f"(max err, columns) = {errs}")
    S = int(full_want[2][0])
    n_words = layout_for_specs(specs).n_words
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    k2_runs = time_runs(lambda: dk.filter_pack(*args), runs, scratch.zero_)
    k2_ms = sorted(k2_runs)[len(k2_runs) // 2]
    floor_ms = launch_floor_ms(scratch.zero_)
    paced = time_runs(lambda: dk.filter_pack(*args), runs, scratch.zero_,
                      hold=False)
    paced_floor = launch_floor_ms(scratch.zero_, hold=False)
    k2_plain = time_ms(lambda: filter_pack_plain(*args, dk.FILTER_BLOCK), 3)
    epi_ms = time_ms(lambda: dk.compact_packed(*k2), 50, flush=scratch.zero_)
    epi_plain = time_ms(lambda: compact_packed_plain(k2_want[0], keep), 3)
    words_i32 = k2_want[0].view(torch.int32)
    lib_ms = time_ms(lambda: words_i32[:, keep], 50, flush=scratch.zero_)
    n_mask, n_blocks = -(-rows // 32), -(-rows // dk.FILTER_BLOCK)
    k2_bytes = bm.nbytes + ln.nbytes + fl.nbytes + n_words * 4 * rows \
        + 4 * n_mask + 4 * n_blocks
    k2_ops = OPS_PER_TEXT_BYTE * sum(w for _, _, w, _ in specs) * rows
    epi_bytes = n_words * 4 * S + 4 * n_mask + 4 * n_blocks \
        + n_words * 4 * rows + 4
    k2c_runs = time_runs(lambda: dk.filter_pack_compact(*args), runs,
                         scratch.zero_)
    k2c_ms = sorted(k2c_runs)[len(k2c_runs) // 2]
    k2c_plain = time_ms(lambda: parse_and_pack_plain(
        bm_d, ln_d, specs, nibble, pred=pred, row_flags=fl_d), 3)
    k2c_bytes = fused_bytes(bm, ln, fl, n_words, S)
    recs = []
    for kname, ms, ms_runs, plain, nbytes, ops, err, lib in (
            ("decode_pack_filtered", k2_ms, k2_runs, k2_plain, k2_bytes,
             k2_ops, k2_err + full_err, None),
            ("compact_packed", epi_ms, [epi_ms], epi_plain, epi_bytes, 0,
             epi_err + full_err, lib_ms),
            ("filter_pack_compact", k2c_ms, k2c_runs, k2c_plain, k2c_bytes,
             k2_ops, k2c_err, lib_ms)):
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / SCALAR_OPS_PER_S * 1e3
        recs.append({
            "kernel": kname, "case": name, "rows": rows, "nibble": nibble,
            "row_filter": pred.filter.sql, "survivors": S,
            "max_abs_err": max(e for e, _ in err), "ms": ms,
            "plain_ms": plain, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "library_ms": lib, "ms_runs": ms_runs,
            "launch_floor_ms": floor_ms})
        if kname == "decode_pack_filtered":
            recs[-1]["path"] = path
            recs[-1].update(host_paced_ms_runs=paced,
                            host_paced_launch_floor_ms=paced_floor)
        if kname == "filter_pack_compact":
            recs[-1]["path"] = fpath
        print(f"  {name} {kname}: rows={rows} survivors={S} "
              + (f"path={recs[-1]['path']} " if "path" in recs[-1] else "")
              + f"bit-identical=yes ms={ms:.5f} plain_ms={plain:.3f} "
              f"bound_ms={recs[-1]['bound_ms']:.5f} "
              f"({recs[-1]['bound_by']}, {nbytes} B) launch_floor_ms="
              f"{floor_ms:.5f} library_ms="
              + ("null" if lib is None else f"{lib:.5f}"), flush=True)
    if runs > 1:
        print(f"    K2 ms over {runs} timings: {spread(k2_runs)}", flush=True)
        print(f"    host-paced (no hold) K2 ms: {spread(paced)}; "
              f"launch_floor_ms={paced_floor:.5f}", flush=True)
        print(f"    K2c ms over {runs} timings: {spread(k2c_runs)}; "
              f"K2 + epilogue {k2_ms + epi_ms:.5f}", flush=True)
    return recs


def fused_cases(specs, pool, seed, pred, wide_pred, wide_specs):
    """Phase 3d, K2c's own cases at the pgbench specs (nibble), each bit
    for bit against the plain version (`words[:, :count]`, mask, count):
    keep none (every row dead), keep all (every row force-kept), a ragged
    batch (100,003 rows), 2^22 rows (16,384 blocks: most look-backs meet
    predecessors that are only aggregates), 50 launches back to back on
    one status buffer, two streams at once; and a layout whose word tile
    does not fit (260 INT4 columns), which the engine's route sends to K2
    + the epilogue (full contract, zeros behind). Returns the cases'
    records."""
    import numpy as np
    import torch

    from etl_tpu_torch.ops import decode_kernel as dk
    from etl_tpu_torch.ops.bitpack import layout_for_specs, \
        parse_and_pack_plain
    from etl_tpu_torch.testing import filter_case as inputs

    def make(rows, seed_, flags=None, specs_=specs, pred_=pred):
        bm, ln, fl = inputs(specs_, min(rows, pool),
                            np.random.default_rng(seed_), True)
        reps = -(-rows // pool)
        bm, ln, fl = (np.ascontiguousarray(
            np.tile(a, (reps,) + (1,) * (a.ndim - 1))[:rows])
            for a in (bm, ln, fl))
        if flags is not None:
            fl[:] = flags
        return (*(torch.from_numpy(a).cuda() for a in (bm, ln, fl)),
                specs_, True, pred_)

    def want(args):
        return parse_and_pack_plain(args[0], args[1], args[3], args[4],
                                    pred=args[5], row_flags=args[2])

    def held(args, name, got, expect=None):
        w = want(args)
        torch.cuda.synchronize()
        err = fused_err(got, w)
        n = int(w[2][0])
        check(all(e == 0 for e, _ in err),
              f"{name}: K2c differs from the plain version {err}")
        check(expect is None or n == expect,
              f"{name}: {n} survivors, expected {expect}")
        return {"case": name, "rows": int(args[0].shape[0]),
                "survivors": n, "max_abs_err": max(e for e, _ in err)}

    recs = []
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for name, rows, flags, expect in (
            ("keep none", 262_144, 0, 0), ("keep all", 262_144, 2, 262_144),
            ("ragged", 100_003, None, None),
            ("2^22 rows", 1 << 22, None, None)):
        args = make(rows, seed + rows, flags)
        rec = held(args, name, dk.filter_pack_compact(*args), expect)
        rec["ms"] = time_ms(lambda: dk.filter_pack_compact(*args), 20,
                            scratch.zero_)
        recs.append(rec)
        print(f"  3d K2c {name}: rows={rows} survivors={rec['survivors']} "
              f"bit-identical=yes ms={rec['ms']:.5f}", flush=True)
    # back to back on one status buffer, no synchronisation between
    batch = [make(rows, seed + k, flags) for k, (rows, flags) in
             enumerate(((262_144, None), (300, None), (100_003, 2),
                        (1, None), (65_499, 0)))]
    torch.cuda.synchronize()
    outs = [dk.filter_pack_compact(*batch[k % len(batch)])
            for k in range(50)]
    for k, got in enumerate(outs):
        held(batch[k % len(batch)], f"back-to-back {k}", got)
    recs.append({"case": "50 back-to-back launches", "max_abs_err": 0})
    print("  3d K2c 50 back-to-back launches on one status buffer: "
          "bit-identical=yes", flush=True)
    # two streams at once, each with its own status buffer
    two = [make(1 << 21, seed + 7), make(1 << 21, seed + 8)]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    got = [[], []]
    for _ in range(4):
        for st, args, out in zip(streams, two, got):
            with torch.cuda.stream(st):
                out.append(dk.filter_pack_compact(*args))
    torch.cuda.synchronize()
    for args, outs in zip(two, got):
        for g in outs:
            held(args, "two streams", g)
    recs.append({"case": "two streams", "max_abs_err": 0})
    print("  3d K2c on two streams at once (4 launches each, 2^21 rows): "
          "bit-identical=yes", flush=True)
    # a layout whose word tile does not fit: the two-launch route
    wide = make(1_000, seed + 9, specs_=wide_specs, pred_=wide_pred)
    n_words = layout_for_specs(wide_specs).n_words
    walk = dk.fused_walk(*wide[:3], len(wide_specs),
                         len(dk.pred_descriptor(wide_pred, wide_specs)),
                         n_words)
    check(walk is None, f"the wide layout fits K2c (walk {walk})")
    before = (dk.fused_launches, dk.filter_launches, dk.compact_launches)
    got = dk.prepare_filtered(*wide)()
    w = want(wide)
    torch.cuda.synchronize()
    err = [_words_err(a, b) for a, b in zip(got, w)]
    check(all(e == 0 for e, _ in err),
          f"wide layout: the two-launch route differs {err}")
    check((dk.fused_launches, dk.filter_launches, dk.compact_launches)
          == (before[0], before[1] + 1, before[2] + 1),
          "the wide layout did not take the two-launch route")
    recs.append({"case": "wide layout, two-launch route",
                 "cols": len(wide_specs), "n_words": n_words,
                 "survivors": int(w[2][0]), "max_abs_err": 0})
    print(f"  3d wide layout ({len(wide_specs)} INT4 columns, {n_words} "
          f"words): word tile does not fit, K2 + epilogue taken, "
          f"bit-identical=yes (full contract)", flush=True)
    return recs


def held_main_path_ms(decoder, staged, specs, filtered: bool) -> dict:
    """The main path's kernels on one of its own batches, timed as the
    kernel records are (held, `bench.device_ms`): K1 on the canonical
    layout, or the filtered route (K2c) on the exact one, on the
    decoder's packed bytes, lengths and row flags of `staged` (`specs`
    the batch's exact specs), with the L2 flushed before each launch
    (`cold_ms`) and without (`warm_ms`, as the engine finds the bytes
    just uploaded)."""
    import torch

    from etl_tpu_torch.ops import decode_kernel as dk

    packed = decoder._pack_stage(staged, specs)
    specs = packed.pspecs(specs)  # the canonical layout, unfiltered
    bm = torch.from_numpy(packed.bmat).cuda()
    ln = torch.from_numpy(packed.lengths).cuda()
    if filtered:
        pred = packed.pred
        fl = torch.from_numpy(packed.row_flags).cuda()

        def fn():
            return dk.prepare_filtered(bm, ln, fl, specs, packed.nibble,
                                       pred)()
    else:
        def fn():
            return dk.decode_pack(bm, ln, specs, packed.nibble)
    decoder._pinned.give_back(packed.pinned)
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    return {"cold_ms": time_ms(fn, 50, flush=scratch.zero_),
            "warm_ms": time_ms(fn, 50)}


def _spec_text(specs) -> str:
    return "[" + ", ".join(f"{k.name}/{w}/{bw}" for _, k, w, bw in specs) \
        + "]"


def _reset_launch_counts() -> None:
    """Set the kernels' launch counts and the engine's routed-batch
    counts of this process to 0."""
    from etl_tpu_torch.ops import decode_kernel as dk
    from etl_tpu_torch.ops import egress_kernel as ek
    from etl_tpu_torch.ops import engine

    dk.launches = dk.filter_launches = dk.compact_launches = 0
    dk.fused_launches = ek.launches = 0
    engine.routed_batches = engine.routed_device_batches = 0
    engine.routed_host_batches = engine.routed_oracle_batches = 0


def _launch_counts() -> dict:
    """The counts since `_reset_launch_counts`: launches by kernel and
    batches by route. Every batch the engine routed took exactly one
    route: device + host + oracle must add up to all routed batches."""
    from etl_tpu_torch.ops import decode_kernel as dk
    from etl_tpu_torch.ops import egress_kernel as ek
    from etl_tpu_torch.ops import engine

    out = {"k1_launches": dk.launches, "k2_launches": dk.filter_launches,
           "epilogue_launches": dk.compact_launches,
           "k2c_launches": dk.fused_launches,
           "egress_launches": ek.launches,
           "routed_batches": engine.routed_batches,
           "device_routed_batches": engine.routed_device_batches,
           "host_routed_batches": engine.routed_host_batches,
           "oracle_routed_batches": engine.routed_oracle_batches}
    check(out["device_routed_batches"] + out["host_routed_batches"]
          + out["oracle_routed_batches"] == out["routed_batches"],
          f"routes do not add up to the routed batches: {out}")
    return out


def _stage_line(r: dict) -> str:
    return (f"pack_s={r['pack_s']:.4f} dispatch_s={r['dispatch_s']:.4f} "
            f"fetch_s={r['fetch_s']:.4f} overlap_s={r['overlap_s']:.4f} "
            f"device_s={r['device_s']:.4f} kernel_s={r['kernel_s']:.5f} "
            f"device_busy_share={r['device_busy_share']:.5f}")


def runtime_phases(args) -> dict:
    """Phases 6-8: the replication runtime on the card. Each phase sets
    the launch counts to 0 before it drives the runtime and reads them
    after; returns each phase's result with those counts."""
    import asyncio

    from etl_tpu_torch import bench

    out = {}
    print(f"[6] table copy through the runtime ({args.copy_rows} rows)",
          flush=True)
    _reset_launch_counts()
    r = asyncio.run(bench.run_table_copy(args.copy_rows, "cuda",
                                         seed=args.seed))
    r.update(_launch_counts())
    print(f"  rows/s={r['rows_per_second']:.0f} MiB/s="
          f"{r['mib_per_second']:.2f} copy_wait_ms={r['copy_wait_ms']:.1f} "
          f"batches={r['batches']} delivered={r['rows_delivered']} "
          f"launches: k1={r['k1_launches']} k2c={r['k2c_launches']} "
          f"device_rows={r['device_rows']} oracle_rows={r['oracle_rows']}",
          flush=True)
    print(f"  {_stage_line(r)}", flush=True)
    check(r["k1_launches"] > 0, "the copy launched no K1")
    check(r["device_route_ok"], "a copy chunk did not take the device route")
    check(r["count_ok"] and r["digest_ok"],
          "copied rows differ from the written rows (count or digest)")
    check(r["oracle_sample_ok"], "a sampled copied row differs from the "
          "CPU oracle")
    print("  parity: count and digest of all columns == written rows, 512 "
          "oracle rows equal", flush=True)
    out["6_copy"] = r
    for phase, row_filter in (("7_cdc", None), ("8_cdc_filtered",
                                                "bid <= 5")):
        tag = phase.split("_")[0]
        print(f"[{tag}] CDC through the runtime ({args.cdc_events} events, "
              f"500-row transactions"
              + (f", offload filter {row_filter})" if row_filter else ")"),
              flush=True)
        _reset_launch_counts()
        r = asyncio.run(bench.run_table_streaming(
            args.cdc_events, device="cuda", row_filter=row_filter,
            seed=args.seed + 1))
        r.update(_launch_counts())
        r["events_per_second"] = r["end_to_end_events_per_second"]
        print(f"  events/s={r['events_per_second']:.0f} lag_p50_ms="
              f"{r['lag_p50_ms']:.2f} lag_p95_ms={r['lag_p95_ms']:.2f} "
              f"delivered={r['delivered_rows']} keep_share="
              f"{r['keep_share']:.4f} decoded_events={r['decoded_events']} "
              f"launches: k1={r['k1_launches']} k2c={r['k2c_launches']} "
              f"k2={r['k2_launches']} epilogue={r['epilogue_launches']} "
              f"device_rows={r['device_rows']} oracle_rows="
              f"{r['oracle_rows']}", flush=True)
        print(f"  {_stage_line(r)} overlap_ratio={r['overlap_ratio']:.4f}",
              flush=True)
        print(f"  run sizes: {json.dumps(r['run_rows'])}", flush=True)
        print(f"  after shutdown: {json.dumps(r['after_shutdown'])}",
              flush=True)
        if row_filter is None:
            check(r["k1_launches"] > 0, "CDC launched no K1")
        else:
            check(r["k2c_launches"] > 0, "filtered CDC launched no K2c")
            check(r["k2_launches"] == 0 and r["epilogue_launches"] == 0,
                  "filtered CDC launched K2 or the epilogue")
        check(r["count_ok"] and r["digest_ok"],
              "delivered CDC rows differ from the produced rows (count or "
              "digest)")
        check(r["order_ok"], "CDC rows not delivered once each, in "
              "(commit LSN, ordinal) order")
        check(r["identity_ok"], "an event's identity arrays are not "
              "compacted with its rows")
        check(r["oracle_sample_ok"], "a sampled CDC row differs from the "
              "CPU oracle")
        check(r["shutdown_ok"], "a decode thread, an admission ticket or a "
              "tenant outlived shutdown")
        print("  parity: count and digest == produced rows"
              + (" with bid <= 5" if row_filter else "")
              + ", (commit LSN, ordinal) once each in order, identity "
              "arrays compacted with the rows, 512 oracle rows equal, "
              "clean shutdown", flush=True)
        out[phase] = r
    return out


#: 9(b)'s timings of each encoder: cut for time from `bench --egress`'s 3
EGRESS_ITERS = 2


def egress_case(name, specs, nibble, rows, pool, seed, encoders, runs=1):
    """Phase 9(a) case: the render kernel against its plain version on the
    card, on one set of seeded words, under each encoder's plan; returns
    one record per encoder (times, bound, error)."""
    import numpy as np
    import torch

    from etl_tpu_torch.ops import egress, egress_kernel
    from etl_tpu_torch.testing import egress_words

    words = egress_words(specs, pool, np.random.default_rng(seed), nibble)
    words = words.view(torch.int32).repeat(1, -(-rows // pool))[:, :rows]
    words_d = words.contiguous().cuda()
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    recs = []
    for enc in encoders:
        plan = egress.plan_for_specs(specs, enc)
        got = egress_kernel.render(words_d, specs, plan)
        torch.cuda.synchronize()
        want = egress.render_plain(words_d, specs, plan)
        torch.cuda.synchronize()
        max_err = max(int((g.long() - w.long()).abs().max().item())
                      for g, w in zip(got, want))
        n_bad = int(sum(((g != w).reshape(rows, -1).any(dim=1))
                        for g, w in zip(got, want)).count_nonzero().item())
        check(max_err == 0, f"9a {name} {enc}: the render kernel differs "
              f"from its plain version on {n_bad} of {rows} rows")

        def fn():
            return egress_kernel.render(words_d, specs, plan)

        k_runs = time_runs(fn, runs, scratch.zero_)
        k_ms = sorted(k_runs)[len(k_runs) // 2]
        floor_ms = launch_floor_ms(scratch.zero_)
        p_ms = time_ms(lambda: egress.render_plain(words_d, specs, plan), 3)
        n_bytes = (words.numel() * 4 + rows * plan.total_width
                   + rows * len(plan.slots) * 4)
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = OPS_PER_RENDERED_BYTE * rows * plan.total_width \
            / SCALAR_OPS_PER_S * 1e3
        rec = {"case": f"{name} {enc}", "rows": rows, "nibble": nibble,
               "encoder": enc,
               "specs": [[c, k.name, w, bw] for c, k, w, bw in specs],
               "rendered": [k.name for k in plan.kinds],
               "max_abs_err": max_err, "ms": k_ms, "ms_runs": k_runs,
               "plain_ms": p_ms, "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "bytes": n_bytes, "library_ms": None,
               "launch_floor_ms": floor_ms}
        print(f"  {name} {enc}: rows={rows} columns={len(plan.slots)} "
              f"width={plan.total_width} bit-identical=yes "
              f"kernel_ms={k_ms:.5f} plain_ms={p_ms:.3f} "
              f"bound_ms={rec['bound_ms']:.5f} ({rec['bound_by']}, "
              f"{n_bytes} B) launch_floor_ms={floor_ms:.5f} library_ms=null",
              flush=True)
        if runs > 1:
            print(f"    kernel_ms over {runs} timings: {spread(k_runs)}",
                  flush=True)
        recs.append(rec)
    return recs


def egress_phase(args, main_specs, cdc: dict) -> dict:
    """Phase 9: the render kernel against its plain version (a), the
    encoders alone (b), and phase 7's CDC stream into a destination that
    renders TSV with the device text (c), its launch counts set to 0
    just before it and read just after. `cdc` is phase 7's result, which
    (c) is printed beside."""
    import asyncio

    from etl_tpu_torch import bench
    from etl_tpu_torch.models.pgtypes import CellKind as K
    from etl_tpu_torch.ops import egress, egress_kernel
    from etl_tpu_torch.ops.bitpack import saturation_width

    print("[9a] egress render kernel vs plain version", flush=True)
    cases = egress_case("9a(i) pgbench", main_specs, True, bench.N_ROWS,
                        16_384, args.seed + 40, [egress.ENCODER_TSV], runs=3)
    widths = {K.BOOL: 4, K.I16: 8, K.I32: 12, K.U32: 12, K.I64: 20,
              K.DATE: 16, K.TIMESTAMP: 32, K.TIMESTAMPTZ: 32}
    kinds = [k for k in widths if k in egress.ENCODER_KINDS["tsv"]] * 2
    specs = tuple((i, k, widths[k],
                   (min(widths[k], saturation_width(k)) + 1) & ~1)
                  for i, k in enumerate(kinds))
    cases += egress_case("9a(ii) every tsv kind raw", specs, False, 65_536,
                         4_096, args.seed + 41,
                         [egress.ENCODER_TSV, egress.ENCODER_JSON])

    print(f"[9b] encoders alone (bench --egress, {bench.N_ROWS} rows, "
          f"min of {EGRESS_ITERS})", flush=True)
    eb = bench.run_egress(bench.N_ROWS, n_iters=EGRESS_ITERS)
    print("  " + " ".join(f"{k}={v}" for k, v in eb.items()
                          if k.endswith(("_per_sec", "_attached",
                                         "_used_device", "_identical"))),
          flush=True)
    if "parquet" in eb:  # why the Parquet writer was not measured
        print(f"  parquet: {eb['parquet']}", flush=True)
    for e in ("tsv", "json"):
        t = eb[f"device_{e}_decode_timings"]
        print(f"  {e} decode: " + " ".join(
            f"{k}={v:.4f}" for k, v in t.items() if k.endswith("_ms"))
            + f" fetched_bytes={t['fetched_bytes']}", flush=True)
    check(eb["ok"], "bench --egress: a fast path did not use the device "
          "text or differs from the columnar oracle")

    print(f"[9c] CDC through the runtime into a TSV destination "
          f"({args.cdc_events} events, the default PipelineConfig)",
          flush=True)
    oracle_clear("phase 9(c)")
    _reset_launch_counts()
    r = asyncio.run(bench.run_table_streaming(
        args.cdc_events, device="cuda", seed=args.seed + 1, tsv=True,
        subsystems="default"))
    r.update(_launch_counts())
    r["events_per_second"] = r["end_to_end_events_per_second"]
    t = r["tsv"]
    print(f"  events/s={r['events_per_second']:.0f} (phase 7: "
          f"{cdc['events_per_second']:.0f}) lag_p50_ms={r['lag_p50_ms']:.2f} "
          f"lag_p95_ms={r['lag_p95_ms']:.2f} (phase 7: "
          f"{cdc['lag_p50_ms']:.2f} / {cdc['lag_p95_ms']:.2f}) "
          f"device_busy_share={r['device_busy_share']:.5f} (phase 7: "
          f"{cdc['device_busy_share']:.5f})", flush=True)
    print(f"  launches: egress={r['egress_launches']} k1={r['k1_launches']} "
          f"k2c={r['k2c_launches']} egress_s={r['egress_s']:.5f} "
          f"d2h_egress_s={r['d2h_egress_s']:.5f} kernel_s="
          f"{r['kernel_s']:.5f} device_s={r['device_s']:.4f} render_s="
          f"{t['render_s']:.4f} (share {t['render_share']:.4f}) writes="
          f"{t['writes']} device_writes={t['device_writes']} "
          f"decoded_batches={t['decoded_batches']} device_batches="
          f"{t['device_batches']} oracle_rows={r['oracle_rows']}",
          flush=True)
    print(f"  {_stage_line(r)} overlap_ratio={r['overlap_ratio']:.4f}",
          flush=True)
    print(f"  run sizes: {json.dumps(r['run_rows'])}", flush=True)
    print(f"  after shutdown: {json.dumps(r['after_shutdown'])}", flush=True)
    sv = r["supervision"]
    print(f"  supervisor started={sv['started']} wrapped={sv['wrapped']} "
          f"health={sv['health']} degrade_events={sv['degrade_events']}",
          flush=True)
    check(r["supervision_ok"], "the supervised TSV stream did not keep "
          "its supervision checks (started, wrapped, healthy, no degrade, "
          "K1 once per device run)")
    check(r["egress_launches"] > 0
          and r["egress_launches"] == r["k1_launches"],
          "the render kernel did not launch once per device run")
    check(t["bodies_identical"], "a TSV body differs from "
          "render_batch_tsv_columnar on the same batch")
    check(t["device_runs_carried_text"] and t["used_device_when_carried"],
          "a device run carried no device text, or a write did not use it")
    check(r["count_ok"] and r["digest_ok"] and r["order_ok"]
          and r["identity_ok"] and r["oracle_sample_ok"],
          "delivered TSV-destination rows differ from the produced rows")
    check(r["shutdown_ok"], "a decode thread, an admission ticket or a "
          "tenant outlived shutdown")
    print("  parity: every body == render_batch_tsv_columnar, the render "
          "once per device run through the SupervisedDestination, device "
          "text used on every device write, count/digest/order/identity/"
          "512 oracle rows as phase 7, clean shutdown", flush=True)
    return {"cases": cases, "encoders": eb, "cdc_tsv": r,
            "launches": egress_kernel.launches}


def oracle_clear(before: str) -> None:
    from etl_tpu_torch.ops import engine

    check(not engine.host_oracle_forced(),
          f"the engine's forced host-oracle state is set before {before}")


#: 10(b)'s events: cut for time from phase 7's 500,000 (the poisoned
#: stream runs at about a sixteenth of phase 7's rate)
POISON_EVENTS = 250_000


def default_config_phase(args, cdc: dict) -> dict:
    """Phase 10: the reference's default PipelineConfig (supervision and
    poison on) on the card: (a) phase 7's stream, (b) the stream with
    poison rows over a SqliteStore, (c) the supervisor's host-oracle
    degrade. Each sets the launch counts to 0 just before it and reads
    them just after. `cdc` is phase 7's result, printed beside (a)."""
    import asyncio
    import logging
    import tempfile

    from etl_tpu_torch import bench
    from etl_tpu_torch.ops import engine

    # one warning a poison row is the isolator's log; the counts print here
    logging.getLogger("etl_tpu_torch.poison").setLevel(logging.ERROR)
    out = {}
    print(f"[10a] CDC with the default PipelineConfig ({args.cdc_events} "
          f"events, supervision and poison on)", flush=True)
    oracle_clear("phase 10(a)")
    _reset_launch_counts()
    r = asyncio.run(bench.run_table_streaming(
        args.cdc_events, device="cuda", seed=args.seed + 1,
        subsystems="default"))
    window_k1 = r["k1_launches"]
    r.update(_launch_counts())
    r["events_per_second"] = r["end_to_end_events_per_second"]
    sv = r["supervision"]
    print(f"  events/s={r['events_per_second']:.0f} (phase 7: "
          f"{cdc['events_per_second']:.0f}) lag_p50_ms={r['lag_p50_ms']:.2f} "
          f"lag_p95_ms={r['lag_p95_ms']:.2f} (phase 7: "
          f"{cdc['lag_p50_ms']:.2f} / {cdc['lag_p95_ms']:.2f}) "
          f"device_busy_share={r['device_busy_share']:.5f}", flush=True)
    print(f"  supervisor started={sv['started']} wrapped={sv['wrapped']} "
          f"health={sv['health']} reasons={json.dumps(sv['reasons'])} "
          f"degrade_events={sv['degrade_events']} events="
          f"{json.dumps(sv['events'])}", flush=True)
    print(f"  launches: k1={r['k1_launches']} (window {window_k1}, device "
          f"runs {r['device_runs']}) device_rows={r['device_rows']} "
          f"oracle_rows={r['oracle_rows']}", flush=True)
    print(f"  {_stage_line(r)}", flush=True)
    print(f"  after shutdown: {json.dumps(r['after_shutdown'])}", flush=True)
    check(sv["started"], "the supervisor did not start")
    check(sv["wrapped"], "the destination is not a SupervisedDestination")
    check(window_k1 > 0 and r["k1_per_device_run_ok"],
          "K1 did not launch once per device run")
    check(sv["degrade_events"] == 0
          and "device-degraded" not in sv["reasons"],
          "the default config degraded the engine")
    check(sv["health"] == "healthy", f"health {sv['health']} at the end")
    check(r["count_ok"] and r["digest_ok"] and r["order_ok"]
          and r["identity_ok"] and r["oracle_sample_ok"],
          "default-config rows differ from the produced rows")
    check(r["shutdown_ok"], "a decode thread, an admission ticket or a "
          "tenant outlived shutdown")
    print("  parity: count/digest/order/identity/512 oracle rows as phase 7, "
          "clean shutdown", flush=True)
    out["10a_default"] = r

    events = min(args.cdc_events, POISON_EVENTS)
    print(f"[10b] CDC with poison rows ({events} events, poison "
          f"rate {bench.POISON_RATE}, SqliteStore)", flush=True)
    oracle_clear("phase 10(b)")
    _reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        r = asyncio.run(bench.run_table_streaming(
            events, device="cuda", seed=args.seed + 1,
            subsystems="default", poison_rate=bench.POISON_RATE,
            store_dir=tmp))
    r.update(_launch_counts())
    r["events_per_second"] = r["end_to_end_events_per_second"]
    q = r["dlq"]
    print(f"  events/s={r['events_per_second']:.0f} (10a: "
          f"{out['10a_default']['events_per_second']:.0f}) lag_p50_ms="
          f"{r['lag_p50_ms']:.2f} lag_p95_ms={r['lag_p95_ms']:.2f} "
          f"delivered={r['delivered_rows']} want={r['want_rows']}",
          flush=True)
    print(f"  dlq: poison_rows={q['poison_rows']} entries={q['entries']} "
          f"exactly_once={q['exactly_once']} values_ok={q['values_ok']} "
          f"isolations={q['isolations']} probe_writes={q['probe_writes']} "
          f"probe_bound={q['probe_bound']} bound_ok={q['bound_ok']} "
          f"cli_ok={q['cli_ok']} cli_s={q['cli_s']:.2f}", flush=True)
    print(f"  launches: k1={r['k1_launches']} device_rows="
          f"{r['device_rows']} oracle_rows={r['oracle_rows']}", flush=True)
    print(f"  {_stage_line(r)}", flush=True)
    print(f"  after shutdown: {json.dumps(r['after_shutdown'])}", flush=True)
    if q["cli_stderr"]:
        print(f"  dlq cli stderr: {q['cli_stderr']}", flush=True)
    check(r["k1_launches"] > 0, "the poisoned stream launched no K1")
    check(q["exactly_once"] and q["values_ok"], "a poison row is not on "
          "the dead-letter store exactly once under its WAL key")
    check(r["count_ok"] and r["digest_ok"] and r["order_ok"]
          and r["identity_ok"] and r["oracle_sample_ok"],
          "the healthy rows are not delivered once each in (commit LSN, "
          "ordinal) order")
    check(q["bound_ok"], "an isolation's probe writes exceeded "
          "bisection_bound")
    check(q["cli_ok"], "the DLQ CLI in another process listed other "
          "entries")
    check(r["shutdown_ok"], "a decode thread, an admission ticket or a "
          "tenant outlived shutdown")
    print("  parity: healthy rows count/digest/order/identity/512 oracle "
          "rows, poison rows on the DLQ once each, probe bound, CLI list "
          "equal", flush=True)
    out["10b_poison"] = r

    print("[10c] host-oracle degrade (a copy with a held fetch, then CDC)",
          flush=True)
    oracle_clear("phase 10(c)")
    _reset_launch_counts()
    r = asyncio.run(bench.run_device_degrade(device="cuda"))
    r.update(_launch_counts())
    print(f"  degrade_fired={r['degrade_fired']} component="
          f"{r['degrade_component']} at_s={r['degrade_at_s']} ready_at_s="
          f"{r['ready_at_s']:.2f} done_at_s={r['done_at_s']:.2f}",
          flush=True)
    print(f"  from the degrade to its last forced sample (K1 launches of "
          f"batches routed before it): {json.dumps(r['while_degraded'])} "
          f"lifted="
          f"{r['lifted']} after lift: {json.dumps(r['after_lift'])}",
          flush=True)
    print(f"  launches: k1={r['k1_launches']} device_batches="
          f"{r['device_batches']} device_rows={r['device_rows']} "
          f"oracle_rows={r['oracle_rows']} restarts="
          f"{json.dumps(r['restarts'])} health_at_end={r['health_at_end']} "
          f"streamed={r['cdc_rows_delivered']} once_in_order="
          f"{r['cdc_once_in_order']}", flush=True)
    check(r["degrade_fired"], "the held fetch did not degrade the engine")
    check(r["device_flat_while_degraded"], "batches or rows were routed "
          "to the device while the degrade held")
    check(r["k1_per_device_batch"], "K1 did not launch once per "
          "device-routed batch")
    check(r["oracle_rose_while_degraded"],
          "no rows took the oracle route while the degrade held")
    check(r["lifted"] and r["k1_after_lift"],
          "the degrade did not lift, or K1 did not launch after it")
    check(r["copy_ok"] and r["cdc_ok"], "the delivered rows differ from "
          "the written rows")
    check(not engine.host_oracle_forced(),
          "the forced host-oracle state outlived phase 10(c)")
    print("  parity: copied and streamed rows == written rows (count and "
          "digest); forced-oracle state clear", flush=True)
    out["10c_degrade"] = r
    return out


#: phase 11: the inserts across 11(a)'s restart; 11(c)'s table and stream
#: (the binary as a process proves the process, not a rate)
RESTART_EVENTS = 20_000
#: the depth of 11(a), 11(b) and 12(a), cut for time from phases 6 and
#: 7's 1,000,000 rows and 500,000 events (the program store's phases pay
#: four nvcc builds of the decode library); their rates still print
#: beside phases 6-8
WIRE_COPY_ROWS = 250_000
WIRE_CDC_EVENTS = 125_000
BINARY_COPY_ROWS = 100_000
BINARY_EVENTS = 10_000


def wire_phase(args, runtime: dict, device: str = "cuda") -> dict:
    """Phase 11: the replicator binary over the Postgres wire protocol,
    against a fake server with SCRAM auth in a child process. (a)
    `replicator.run_replicator(config_dir)` in this process at
    `WIRE_COPY_ROWS` and `WIRE_CDC_EVENTS`, with a PostgresStore and a
    restart; (b) the same
    stream from a publication whose catalog row filter is `bid <= 5`, in
    offload mode; (c) `python -m etl_tpu_torch.replicator` as a process
    with a SqliteStore, and the DLQ CLI's `--postgres` and `replay
    --destination-json`. (a) and (b) set the launch counts to 0 just
    before and read them just after; `runtime` holds phases 6-8, printed
    beside them. Returns (a) and (b)."""
    import asyncio

    from etl_tpu_torch import bench

    out = {}
    r6, r7, r8 = runtime["6_copy"], runtime["7_cdc"], runtime["8_cdc_filtered"]
    print(f"[11a] the replicator over the wire, in process: COPY "
          f"{WIRE_COPY_ROWS} rows, CDC {WIRE_CDC_EVENTS} events, then "
          f"{RESTART_EVENTS} more across a restart (PostgresStore, SCRAM, "
          f"the server in a child process)", flush=True)
    oracle_clear("phase 11(a)")
    _reset_launch_counts()
    r = asyncio.run(bench.run_wire_replicator(
        WIRE_COPY_ROWS, WIRE_CDC_EVENTS, device=device, seed=args.seed,
        restart_events=RESTART_EVENTS))
    r.update(_launch_counts())
    _wire_lines(r, r6, r7, "phase 6", "phase 7")
    rr = r["restart"]
    print(f"  restart: health {json.dumps(rr['health'])} rows={rr['rows']} "
          f"copied_again={rr['copied_again']} once_each={rr['ok']}",
          flush=True)
    _wire_checks(r, "11(a)")
    check(rr["ok"], "the restart from the PostgresStore re-copied, lost or "
          "duplicated rows")
    print("  parity: copy count/digest/512 oracle rows, CDC count/digest/"
          "order/identity/512 oracle rows, restart once each, K1 == "
          "device-routed batches, clean SIGTERM", flush=True)
    out["11a_wire"] = r

    print(f"[11b] the same stream from a publication with the catalog row "
          f"filter bid <= 5 (offload mode, {WIRE_CDC_EVENTS} events)",
          flush=True)
    oracle_clear("phase 11(b)")
    _reset_launch_counts()
    r = asyncio.run(bench.run_wire_replicator(
        0, WIRE_CDC_EVENTS, device=device, seed=args.seed,
        row_filter="bid <= 5", restart_events=0))
    r.update(_launch_counts())
    _wire_lines(r, None, r8, None, "phase 8")
    _wire_checks(r, "11(b)")
    print("  parity: delivered == the filter's truth (count/digest), order/"
          "identity/512 oracle rows, K2c (+ K2) == device-routed batches, "
          "clean SIGTERM", flush=True)
    out["11b_wire_filtered"] = r

    print(f"[11c] python -m etl_tpu_torch.replicator as a process "
          f"({BINARY_COPY_ROWS} rows, {BINARY_EVENTS} events, SqliteStore), "
          f"then the DLQ CLI over the wire", flush=True)
    oracle_clear("phase 11(c)")
    r = asyncio.run(bench.run_replicator_binary(
        BINARY_COPY_ROWS, BINARY_EVENTS, device=device, seed=args.seed))
    cli = r["dlq_cli"]
    print(f"  /health {json.dumps(r['health'])} after {r['health_s']:.2f} s, "
          f"slot confirmed after {r['confirmed_s']:.2f} s, SIGTERM exit "
          f"code {r['exit_code']}, stopped cleanly {r['stopped_cleanly']}",
          flush=True)
    print("  dlq cli: " + " ".join(
        f"{name} rc={c['rc']} {c['s']:.2f}s" for name, c in cli.items()),
        flush=True)
    if r["exit_code"] != 0:
        print(r.get("stderr_tail", ""), file=sys.stderr, flush=True)
    check(r["health"] == [200, {"status": "healthy"}],
          "the binary's /health did not answer 200 healthy")
    check(r["exit_code"] == 0 and r["stopped_cleanly"],
          "the binary did not exit 0 on SIGTERM")
    check(r["dlq_ok"], "the DLQ CLI over --postgres or replay "
          "--destination-json failed")
    return out


#: phase 12: 12(a)'s filtered sub-run; 12(b)'s depth (cut for time: the
#: BigQuery fake decodes every proto row twice, in Python); the copy-less
#: runs under cProfile that give each destination's share of the loop
WAREHOUSE_FILTERED_EVENTS = 100_000
BIGQUERY_COPY_ROWS = 200_000
BIGQUERY_EVENTS = 100_000
PROFILE_EVENTS = 20_000  # cut for time from 50,000


def warehouse_phase(args, runtime: dict, device: str = "cuda") -> dict:
    """Phase 12: the replicator binary delivering to the warehouse
    destinations over HTTP, each against its fake in a child process
    (`testing.http_process`), the source as in phase 11(a). (a)
    ClickHouse at 11(a)'s sizes with a restart, then a filtered sub-run
    under the catalog's `bid <= 5` (offload mode: K2c, no device text,
    the host encoder by routing); (b) BigQuery Storage Write at a cut
    depth; (c) Snowflake (Snowpipe Streaming, zstd NDJSON row batches)
    at 11(a)'s sizes with its restart where zstandard imports, else the
    destination's typed refusal (`snowflake_case`). Each run sets the
    launch counts to 0 just before and reads them just after; 11(a) of
    this call is printed beside each. Then a run without a copy per
    destination under cProfile: the destination's share of the loop's
    own time."""
    import asyncio
    import cProfile

    from etl_tpu_torch import bench

    out = {}
    ref = runtime["11a_wire"]
    print(f"[12a] ClickHouse over HTTP: COPY {WIRE_COPY_ROWS} rows, CDC "
          f"{WIRE_CDC_EVENTS} events, then {RESTART_EVENTS} more across a "
          f"restart (the fake in a child process)", flush=True)
    oracle_clear("phase 12(a)")
    _reset_launch_counts()
    r = asyncio.run(bench.run_wire_replicator(
        WIRE_COPY_ROWS, WIRE_CDC_EVENTS, device=device, seed=args.seed,
        restart_events=RESTART_EVENTS, destination="clickhouse"))
    r.update(_launch_counts())
    _wire_lines(r, ref, ref, "11(a)", "11(a)")
    _warehouse_lines(r)
    _wire_checks(r, "12(a)")
    _warehouse_checks(r, "12(a)")
    check(r["restart"]["ok"], "12(a): the restart re-copied, lost or "
          "duplicated rows")
    check(r["ddl_ok"], "12(a): CREATE DATABASE, CREATE TABLE or the "
          "current view not issued once a lifetime")
    print("  parity: copy/CDC count and digest, 512 delivered TSV lines == "
          "the host encoder on the written rows, each sequence number once "
          "across the restart (_etl_commit_log, recover_high_water), K1 == "
          "render == device-routed batches, DDL once a lifetime, clean "
          "SIGTERM", flush=True)
    out["12a_clickhouse"] = r

    print(f"[12a] ClickHouse, filtered: {WAREHOUSE_FILTERED_EVENTS} events "
          f"under the catalog's bid <= 5 (offload mode)", flush=True)
    oracle_clear("phase 12(a), filtered")
    _reset_launch_counts()
    r = asyncio.run(bench.run_wire_replicator(
        0, WAREHOUSE_FILTERED_EVENTS, device=device, seed=args.seed,
        row_filter="bid <= 5", restart_events=0, destination="clickhouse"))
    r.update(_launch_counts())
    _wire_lines(r, None, runtime["11b_wire_filtered"], None, "11(b)")
    _warehouse_lines(r)
    _wire_checks(r, "12(a) filtered")
    _warehouse_checks(r, "12(a) filtered")
    check(r["run"]["egress_launches"] == 0 and r["run"]["host_writes"] > 0
          and r["run"]["device_writes"] == 0,
          "12(a) filtered: a filtered batch carried device text, or no "
          "write was rendered host-side")
    print("  parity: delivered == the filter's truth, 256 TSV lines == the "
          "host encoder, K2c == device-routed batches, render 0, every "
          "write rendered host-side by routing", flush=True)
    out["12a_clickhouse_filtered"] = r

    print(f"[12b] BigQuery Storage Write over HTTP: COPY "
          f"{BIGQUERY_COPY_ROWS} rows, CDC {BIGQUERY_EVENTS} events",
          flush=True)
    oracle_clear("phase 12(b)")
    _reset_launch_counts()
    r = asyncio.run(bench.run_wire_replicator(
        BIGQUERY_COPY_ROWS, BIGQUERY_EVENTS, device=device, seed=args.seed,
        restart_events=0, destination="bigquery"))
    r.update(_launch_counts())
    _wire_lines(r, ref, ref, "11(a)", "11(a)")
    _warehouse_lines(r)
    _wire_checks(r, "12(b)")
    _warehouse_checks(r, "12(b)")
    check(r["pb_mismatches"] == 0, "12(b): pb_reader decoded a request's "
          "rows differently from StorageWriteFake")
    print("  parity: copy/CDC count and digest (StorageWriteFake and "
          "pb_reader agree on every request), 512 decoded rows == the "
          "written rows, each sequence number once, marker high-water, "
          "K1 == render == device-routed batches", flush=True)
    out["12b_bigquery"] = r
    out["12c_snowflake"] = snowflake_case(args, ref, device)

    print(f"[12p] each destination's share of the loop: a run of "
          f"{PROFILE_EVENTS} events (no copy) under cProfile", flush=True)
    shares = {}
    for dest in ("memory", "clickhouse", "bigquery"):
        oracle_clear(f"phase 12 profile ({dest})")
        profiler = cProfile.Profile()
        profiler.enable()
        p = asyncio.run(bench.run_wire_replicator(
            0, PROFILE_EVENTS, device=device, seed=args.seed,
            restart_events=0, destination=dest))
        profiler.disable()
        check(p["ok"], f"12 profile ({dest}): a check failed")
        prof = bench.destination_share(profiler)
        shares[dest] = {"events_per_second": p["events_per_second"],
                        **prof}
        print(f"  {dest}: destination_share="
              f"{prof['destination_share']:.4f} ({prof['destination_s']:.3f}"
              f" s of {prof['profiled_s']:.3f} s profiled) events/s="
              f"{p['events_per_second']:.0f} (profiled) top: "
              + "; ".join(f"{n} {t:.3f}s" for n, t in prof["top"]),
              flush=True)
    out["12a_clickhouse"]["destination_profile"] = shares
    return out


def zstandard_importable() -> bool:
    try:
        import zstandard  # noqa: F401
    except ImportError:
        return False
    return True


def snowflake_case(args, ref: dict, device: str = "cuda") -> dict:
    """Phase 12(c): prints whether zstandard imports. Where it does, the
    binary delivers 12(a)'s stream (`WIRE_COPY_ROWS`, `WIRE_CDC_EVENTS`,
    then `RESTART_EVENTS` across a restart) to Snowflake over HTTP, its
    `FakeSnowpipeServer` in a child process, with 12(a)'s checks: the
    delivered rows' count and digest, each `_CHANGE_SEQUENCE_NUMBER` once
    across the restart (the channel's offset tokens), 512 seeded rows'
    NDJSON lines byte for byte the host encoder's, render = K1 =
    device-routed batches. Where it does not, the destination must
    refuse at construction with CONFIG_INVALID naming zstandard; the run
    then launches nothing and the line says Snowflake did not run."""
    import asyncio

    from etl_tpu_torch import bench

    have = zstandard_importable()
    print(f"[12c] zstandard imports: {'yes' if have else 'no'}", flush=True)
    oracle_clear("phase 12(c)")
    _reset_launch_counts()
    if not have:
        from etl_tpu_torch.destinations.snowflake import (
            SnowflakeConfig, SnowflakeDestination)
        from etl_tpu_torch.models.errors import ErrorKind, EtlError

        try:
            SnowflakeDestination(SnowflakeConfig(
                "http://127.0.0.1:9", "acct", "etl", "db"))
        except EtlError as e:
            check(e.kind is ErrorKind.CONFIG_INVALID
                  and "zstandard" in str(e),
                  f"12(c): the Snowflake destination refused with "
                  f"{e.kind.name}, not CONFIG_INVALID naming zstandard: {e}")
            print(f"  refused CONFIG_INVALID: {e}; Snowflake through K1 "
                  f"did not run", flush=True)
            return {"zstandard": False, "refused": str(e),
                    **_launch_counts()}
        raise SmokeFailure("12(c): the Snowflake destination was built "
                           "without zstandard")
    print(f"  Snowflake over HTTP: COPY {WIRE_COPY_ROWS} rows, CDC "
          f"{WIRE_CDC_EVENTS} events, then {RESTART_EVENTS} more across a "
          f"restart (FakeSnowpipeServer in a child process)", flush=True)
    t0 = time.perf_counter()
    r = asyncio.run(bench.run_wire_replicator(
        WIRE_COPY_ROWS, WIRE_CDC_EVENTS, device=device, seed=args.seed,
        restart_events=RESTART_EVENTS, destination="snowflake"))
    r.update(_launch_counts())
    r["zstandard"] = True
    _wire_lines(r, ref, ref, "11(a)", "11(a)")
    _warehouse_lines(r)
    _wire_checks(r, "12(c)")
    _warehouse_checks(r, "12(c)")
    check(r["restart"]["ok"], "12(c): the restart re-copied, lost or "
          "duplicated rows")
    check(r["device_routed_batches"] > 0 and r["egress_launches"]
          == r["k1_launches"] == (r["device_routed_batches"]
                                  if device == "cuda" else 0),
          "12(c): render, K1 and the device-routed batches differ")
    r["wall_s"] = time.perf_counter() - t0
    print(f"  parity: copy/CDC count and digest, 512 delivered NDJSON lines "
          f"== the host encoder on the written rows, each sequence number "
          f"once across the restart (offset tokens), K1 == render == "
          f"device-routed batches, clean SIGTERM; 12(c) in "
          f"{r['wall_s']:.1f} s", flush=True)
    return r


#: phase 13: the fleet's tables (8 × 125,000 rows: phase 6's 1,000,000)
#: and stream (phase 7's shape, 400,000 inserts over the 8 tables)
SHARD_TABLES = 8


def sharded_phase(args, runtime: dict, device: str = "cuda") -> dict:
    """Phase 13: sharded replication on the card
    (`bench_sharded.run_sharded_replication`): K = 2 shard pods split one
    publication of SHARD_TABLES pgbench_accounts tables over one fake
    source and one shared store, each pod with its own pipelines and CUDA
    streams; shard 1's tables carry `bid <= 5` in offload mode (K2c); the
    pods copy `--shard-copy-rows`, then `--shard-events` inserts stream in
    500-row transactions, and halfway `ShardCoordinator` adds a shard
    (2 → 3) while the stream goes on and the fleet rolls to K = 3. The
    launch counts are set to 0 just before and read just after; each pod's
    own launches and device-routed batches are counted under its decode
    tag. Phases 6 and 7 of this call are printed beside it."""
    import asyncio

    from etl_tpu_torch import bench_sharded

    print(f"[13] sharded replication: {SHARD_TABLES} tables, COPY "
          f"{args.shard_copy_rows} rows, CDC {args.shard_events} events in "
          f"500-row transactions, K = 2 -> 3 midway, bid <= 5 on shard 1's "
          f"tables (offload mode)", flush=True)
    oracle_clear("phase 13")
    _reset_launch_counts()
    r = asyncio.run(bench_sharded.run_sharded_replication(
        args.shard_copy_rows, args.shard_events, tables=SHARD_TABLES,
        device=device, seed=args.seed + 2))
    r.update(_launch_counts())
    r6, r7 = runtime["6_copy"], runtime["7_cdc"]
    print(f"  tables per shard: K=2 {json.dumps(r['tables_per_shard']['k2'])}"
          f" K=3 {json.dumps(r['tables_per_shard']['k3'])}; filtered "
          f"{r['filtered_tables']}; moved {r['moved_tables']}", flush=True)
    print(f"  rows/s={r['rows_per_second']:.0f} (phase 6: "
          f"{r6['rows_per_second']:.0f}) events/s={r['events_per_second']:.0f}"
          f" (phase 7: {r7['events_per_second']:.0f}; producer "
          f"{r['producer_events_per_second']:.0f}) lag_p50_ms="
          f"{r['lag_p50_ms']:.2f} lag_p95_ms={r['lag_p95_ms']:.2f} (phase 7:"
          f" {r7['lag_p50_ms']:.2f} / {r7['lag_p95_ms']:.2f}); before the "
          f"rebalance {r['steady_lag_p50_ms']:.2f} / "
          f"{r['steady_lag_p95_ms']:.2f}", flush=True)
    print(f"  rebalance_s={r['rebalance_s']:.4f} roll_s={r['roll_s']:.4f} "
          f"{json.dumps(r['rebalance'])}; duplicates={r['duplicates']}",
          flush=True)
    print(f"  launches: k1={r['k1_launches']} k2c={r['k2c_launches']} "
          f"k2={r['k2_launches']} epilogue={r['epilogue_launches']} "
          f"device_batches={r['device_batches']} device_rows="
          f"{r['device_rows']} oracle_rows={r['oracle_rows']} (in runs "
          f"below the floor: {r['small_oracle_rows']}); per pod "
          f"{json.dumps(r['pod_launches'])}", flush=True)
    print(f"  device_s={r['device_s']:.4f} kernel_s={r['kernel_s']:.5f} "
          f"device_busy_share={r['device_busy_share']:.5f}; after shutdown "
          f"{json.dumps(r['after_shutdown'])}", flush=True)
    check(r["union_ok"], f"13: the pods' union differs from the written "
          f"rows (count or digest): {json.dumps(r['per_table'])}")
    check(r["identity_ok"], "13: a streamed row's aid is not the one its "
          "(commit LSN, ordinal) names")
    check(r["dup_ok"], "13: a row arrived more than twice, or twice outside "
          "the rebalance's funded window")
    check(r["isolation_ok"], "13: a pod delivered a table it does not own")
    check(r["oracle_sample_ok"], "13: a sampled row differs from the CPU "
          "oracle")
    check(r["launches_ok"], f"13: a pod's K1 + K2c launches differ from its "
          f"device-routed batches: {json.dumps(r['pod_launches'])}")
    check(r["stale_epoch_ok"], f"13: a stale-epoch write was not refused "
          f"({r['stale_epoch_refusal']})")
    check(r["monotonic_ok"], "13: a slot's durable progress went back")
    check(r["shutdown_ok"], "13: a decode thread, an admission ticket or a "
          "tenant outlived shutdown")
    check(r["copy_oracle_free"], "13: a copy chunk took the oracle route")
    check(r["ok"], "13: a check failed")
    print("  parity: per table the union's copy and distinct CDC rows == "
          "written rows (count and digest, bid <= 5 on filtered tables), "
          "aids == their (commit LSN, ordinal), duplicates only on moved "
          "tables past the fence and at most twice, no foreign table "
          "delivered, 512 oracle rows, each pod's K1 + K2c == its "
          "device-routed batches, stale epoch refused, clean shutdown",
          flush=True)
    return {"13_sharded": r}


def chaos_phase(args, device: str = "cuda") -> dict:
    """Phase 14: the chaos corpus through the kernels. `run_scenario` over
    every scenario of the corpus and its workload matrix with the CUDA
    engine on the card and the decoder's floor at one row (at the corpus's
    few-row transactions every batch would otherwise take the host route
    or the oracle), the two program-cache scenarios included: the warm
    restart must build nothing and load from disk, the corrupt one must
    count an invalid miss and rebuild (its nvcc seconds print); then the
    sharded pod kill, the multi-pipeline crash and the DLQ scenarios.
    Each must hold its invariants and launch K1 (the per-tuple engine's
    scenario launches none, by design). The launch counts are set to 0
    just before the phase and read just after."""
    import asyncio

    from etl_tpu_torch.chaos.corpus import SCENARIOS, WORKLOAD_MATRIX
    from etl_tpu_torch.chaos.dlq import run_dlq_scenarios
    from etl_tpu_torch.chaos.multi import run_multi_pipeline_scenario
    from etl_tpu_torch.chaos.runner import device_floor, run_scenario
    from etl_tpu_torch.chaos.sharded import run_sharded_scenario
    from etl_tpu_torch.ops import decode_kernel as dk

    print(f"[14] the chaos corpus through K1 ({len(SCENARIOS)} scenarios + "
          f"{len(WORKLOAD_MATRIX)} of the workload matrix, seed "
          f"{args.seed}), then the sharded pod kill, the multi-pipeline "
          f"crash and the DLQ scenarios", flush=True)
    oracle_clear("phase 14")
    _reset_launch_counts()
    runs = []
    t0 = time.perf_counter()
    with device_floor(1):
        for scenario in SCENARIOS + WORKLOAD_MATRIX:
            k1 = dk.launches
            built = dk.build_seconds
            run = asyncio.run(run_scenario(scenario, args.seed,
                                           device=device))
            runs.append((scenario.name, run, dk.launches - k1,
                         scenario.engine))
            if scenario.program_cache:
                pc = run.program_cache or {}
                rebuild = dk.build_seconds \
                    if dk.build_seconds is not built else None
                print(f"  {scenario.name}: program cache since seeding: "
                      f"builds={pc.get('compiled')} disk_hits="
                      f"{pc.get('disk_hits')} invalid={pc.get('invalid')}"
                      f"; decode_pack.cu rebuilt by nvcc in "
                      f"{rebuild if rebuild is None else round(rebuild, 2)}"
                      f" s", flush=True)
                if scenario.program_cache == "warm":
                    check(pc.get("compiled") == 0
                          and pc.get("disk_hits", 0) > 0,
                          f"14: {scenario.name}: {pc}")
                else:
                    check(pc.get("invalid", 0) >= 1
                          and pc.get("compiled", 0) >= 1
                          and rebuild is not None,
                          f"14: {scenario.name}: {pc}, rebuild {rebuild}")
        for name, fn in (("sharded_pod_kill", run_sharded_scenario),
                         ("multi_pipeline_crash_one_stream",
                          run_multi_pipeline_scenario)):
            k1 = dk.launches
            run = asyncio.run(fn(seed=args.seed, device=device))
            runs.append((name, run, dk.launches - k1, "cuda"))
        k1 = dk.launches
        dlq = asyncio.run(run_dlq_scenarios(seed=args.seed, device=device))
        for run in dlq:  # the two share one count
            runs.append((run.scenario, run, dk.launches - k1, "cuda"))
    wall = time.perf_counter() - t0
    out = {"scenarios": {}, "wall_s": wall}
    for name, run, k1, engine in runs:
        d = run.describe()
        inv = d["invariants"]
        print(f"  {name}: ok={run.ok} k1={k1} duration_s={d['duration_s']}"
              f" stats={json.dumps(inv.get('stats', {}))}"
              + (f" violations={inv['violations']}" if not run.ok else ""),
              flush=True)
        out["scenarios"][name] = {"ok": run.ok, "k1_launches": k1,
                                  "duration_s": d["duration_s"],
                                  **({"program_cache": d["program_cache"]}
                                     if "program_cache" in d else {})}
        check(run.ok, f"14: {name} broke an invariant: {inv['violations']}")
        check(k1 > 0 if engine == "cuda" else k1 == 0,
              f"14: {name} launched K1 {k1} times (engine {engine})")
    out.update(_launch_counts())
    print(f"  {len(runs)} runs green in {wall:.1f} s, none refused; "
          f"launches: k1={out['k1_launches']} k2c={out['k2c_launches']}; "
          f"routes: device={out['device_routed_batches']} host="
          f"{out['host_routed_batches']} oracle="
          f"{out['oracle_routed_batches']}", flush=True)
    return {"14_chaos": out}


def _launch_check(tag: str, d: dict, device: str, kernel: str = "k1",
                  want_kernel: bool = True) -> None:
    """On the card every device-routed batch of a run launched one kernel,
    and (`want_kernel`) `kernel` launched; everywhere the run routed some
    batch to the device."""
    check(d["device_batches"] > 0,
          f"{tag}: no batch took the device route")
    if device == "cuda":
        check(d["launches"] == d["device_batches"],
              f"{tag}: launches {d['launches']} != device-routed batches "
              f"{d['device_batches']}")
        if want_kernel:
            check(d[f"{kernel}_launches"] > 0, f"{tag}: {kernel} launched "
                  "no time")


def _gate_line(tag: str, value, floor, ok: bool) -> None:
    print(f"  {tag}: {value} against floor {floor}: floor_ok={ok}",
          flush=True)


#: phase 15(c): seeded property cases of the leftover parity on K1
PROPERTY_CASES = 24


def leftover_cases(device: str, seed: int) -> dict:
    """Phase 15(c): the decoder's leftover parity cases on K1
    (tests/test_torch_decoder_leftovers.py on the CPU): one descriptor
    serves 3, 100 and 250 rows, and 1- and 2-digit widths; a 5,000-byte
    field falls back; 35 dense columns (ok bits past the first word);
    the bitpack extremes (INT2/4/8 and FLOAT8 limits, long mantissas,
    the tz offset edges); and seeded random schemas of the dense and text
    kinds. Each batch equals the port's CPU codec (the oracle route) on
    the same staged rows."""
    import random

    from etl_tpu_torch import bench
    from etl_tpu_torch.benchmarks.harness import counts_delta, kernel_counts
    from etl_tpu_torch.models import (ColumnSchema, Oid,
                                      ReplicatedTableSchema, TableName,
                                      TableSchema)
    from etl_tpu_torch.ops import decode_kernel as dk
    from etl_tpu_torch.ops.engine import DeviceDecoder
    from etl_tpu_torch.ops.staging import stage_tuples
    from etl_tpu_torch.postgres.codec.pgoutput import (TUPLE_NULL,
                                                       TUPLE_TEXT,
                                                       TupleData)

    def schema_of(oids):
        return ReplicatedTableSchema.with_all_columns(TableSchema(
            1, TableName("public", "t"),
            tuple(ColumnSchema(f"c{i}", o) for i, o in enumerate(oids))))

    def staged_of(rows, n):
        return stage_tuples([TupleData(
            [TUPLE_NULL if v is None else TUPLE_TEXT for v in r],
            [None if v is None else v.encode() for v in r]) for r in rows],
            n)

    def same_as_oracle(oids, rows, tag):
        s = schema_of(oids)
        st = staged_of(rows, len(oids))
        got = DeviceDecoder(s, device=device, device_min_rows=0).decode(st)
        want = DeviceDecoder(s, device="cpu",
                             device_min_rows=10**9).decode(st)
        check(bench.batches_equal(got, want),
              f"15(c) {tag}: the device route differs from the CPU codec")
        return got

    before = kernel_counts()
    dec = DeviceDecoder(schema_of([Oid.INT4]), device=device,
                        device_min_rows=0)
    keys = set()
    desc0 = len(dk._desc_cache)
    for n in (3, 100, 250):
        st = staged_of([[str(100 + i)] for i in range(n)], 1)
        b = dec.decode(st)
        check(list(b.columns[0].data) == [100 + i for i in range(n)],
              f"15(c) buckets: {n} rows decoded wrong")
        w = dec._widths(st)
        keys.add((dec._specs(st, w), dec._can_nibble(w)))
    for hi in (9, 99):
        st = staged_of([[str(hi)] for _ in range(8)], 1)
        check(dec.decode(st).columns[0].data[0] == hi,
              f"15(c) widths: {hi} decoded wrong")
        w = dec._widths(st)
        keys.add((dec._specs(st, w), dec._can_nibble(w)))
    descriptors = len(dk._desc_cache) - desc0
    check(len(keys) == 2 and (device != "cuda" or descriptors <= 2),
          f"15(c) descriptor cache: {len(keys)} spec sets, {descriptors} "
          f"descriptors for 3/100/250 rows and 1/2-digit widths")
    big = same_as_oracle([Oid.TEXT, Oid.INT4], [["x" * 5000, "7"]],
                         "5000-byte field")
    check(big.columns[0].value(0) == "x" * 5000, "15(c) 5000-byte field")
    wide = same_as_oracle([Oid.INT4] * 35,
                          [[str(i * 100 + j) for j in range(35)]
                           for i in range(64)], "35 dense columns")
    check(all(wide.columns[j].data[5] == 500 + j for j in (0, 30, 31, 34)),
          "15(c) 35 dense columns decoded wrong")
    same_as_oracle([Oid.INT2, Oid.INT4, Oid.INT8, Oid.FLOAT8],
                   [["-32768", "-2147483648", "-9223372036854775808",
                     "-1.5e22"],
                    ["32767", "2147483647", "9223372036854775807", "1e-22"],
                    ["0", "0", "0", "-0"]], "integer and float limits")
    same_as_oracle([Oid.FLOAT8],
                   [["123456789012345000000"], ["0.000000000000000012345"],
                    ["999999999999999000000000"], ["1.5"]], "long mantissas")
    same_as_oracle([Oid.TIMESTAMPTZ],
                   [["2024-01-01 00:00:00+09"],
                    ["2024-06-15 23:59:59.999999-15:59:59"],
                    ["0001-01-01 00:00:00+15:59:59"],
                    ["9999-12-31 23:59:59.999999-15:59:59"]],
                   "tz offset edges")
    rng = random.Random(seed)
    gens = {
        Oid.INT2: lambda: str(rng.randrange(-32768, 32768)),
        Oid.INT4: lambda: str(rng.randrange(-2**31, 2**31)),
        Oid.INT8: lambda: str(rng.randrange(-2**63, 2**63)),
        Oid.FLOAT8: lambda: repr(rng.uniform(-1e9, 1e9)),
        Oid.BOOL: lambda: rng.choice(["t", "f"]),
        Oid.DATE: lambda: f"{rng.randrange(1, 10000):04d}-"
                          f"{rng.randrange(1, 13):02d}-"
                          f"{rng.randrange(1, 29):02d}",
        Oid.TIMESTAMPTZ: lambda: f"20{rng.randrange(10, 40)}-0"
                                 f"{rng.randrange(1, 10)}-1"
                                 f"{rng.randrange(0, 9)} "
                                 f"{rng.randrange(24):02d}:"
                                 f"{rng.randrange(60):02d}:"
                                 f"{rng.randrange(60):02d}."
                                 f"{rng.randrange(10**6):06d}"
                                 f"{rng.choice(['+', '-'])}"
                                 f"{rng.randrange(16):02d}",
        Oid.NUMERIC: lambda: f"{rng.randrange(-10**12, 10**12)}."
                             f"{rng.randrange(100):02d}",
        Oid.TEXT: lambda: "t-" + str(rng.randrange(10**9)),
    }
    kinds = list(gens)
    for case in range(PROPERTY_CASES):
        oids = [rng.choice(kinds) for _ in range(rng.randint(1, 6))]
        rows = [[None if rng.random() < 0.1 else gens[o]() for o in oids]
                for _ in range(rng.randint(1, 300))]
        same_as_oracle(oids, rows, f"property case {case} (seed {seed})")
    d = counts_delta(before)
    _launch_check("15(c)", d, device)
    print(f"  15(c) leftover parity on K1: descriptors +{descriptors} for "
          f"{len(keys)} spec sets, 5000-byte field, 35 dense columns, "
          f"limits, {PROPERTY_CASES} property cases == the CPU codec; "
          f"k1={d['k1_launches']} device_batches={d['device_batches']}",
          flush=True)
    return d


def exactly_once_phase(args, device: str = "cuda") -> dict:
    """Phase 15: the exactly-once and ack-window scenarios on the card,
    every batch through K1 (`chaos.runner.device_floor(1)`: at the
    decoder's 64-row floor these few-row transactions take the oracle).
    (a) `run_exactly_once_crash` (the mid-write, pre-progress-commit and
    mid-recovery kills) and `run_ack_window_crash`: invariants green,
    every row once through the transactional sink; (b) the modes at
    BENCH_FLOOR.json's smoke sizes: `run_ack_latency` on the per-tuple
    engine (the reference's gate) and on the CUDA engine,
    `run_poison_streaming`, and `run_exactly_once` on both engines: each
    mode's correctness checks (digests identical, one ack at window=1,
    union, probe bound, dup == 0, seam coverage) must hold, and each
    ratio prints beside its floor with `floor_ok` (a missed floor is a
    finding, not a failure); (c) the decoder's leftover parity cases
    (`leftover_cases`). On the card each run's K1 launches are > 0 and
    equal its device-routed batches. The launch counts are set to 0 just
    before the phase and read just after."""
    import asyncio

    from etl_tpu_torch.benchmarks import harness, smoke
    from etl_tpu_torch.benchmarks.harness import counts_delta, kernel_counts
    from etl_tpu_torch.chaos.ack_window import run_ack_window_crash
    from etl_tpu_torch.chaos.exactly_once import run_exactly_once_crash
    from etl_tpu_torch.chaos.runner import device_floor

    floors = smoke.load_floors()
    print("[15] exactly-once and ack-window on the card: the kill matrix, "
          "the K-in-flight crash, then --ack-latency, --poison and "
          "--exactly-once at their smoke sizes, every batch through K1",
          flush=True)
    oracle_clear("phase 15")
    _reset_launch_counts()
    out: dict = {}
    t0 = time.perf_counter()
    with device_floor(1):
        for name, fn in (("exactly_once_crash", run_exactly_once_crash),
                         ("ack_window_crash", run_ack_window_crash)):
            before = kernel_counts()
            run = asyncio.run(fn(seed=args.seed, device=device))
            d = counts_delta(before)
            desc = run.describe()
            print(f"  15(a) {name}: ok={run.ok} duration_s="
                  f"{desc['duration_s']} k1={d['k1_launches']} "
                  f"device_batches={d['device_batches']}", flush=True)
            check(run.ok, f"15(a) {name}: {desc['invariants']['violations']}")
            if name == "exactly_once_crash":
                for w in run.windows:
                    print(f"    window {w['window']}: max_duplication="
                          f"{w['max_duplication']} delivered="
                          f"{w['delivered_events']} restarts="
                          f"{len(w['restarts'])} recover_calls="
                          f"{w['recover_calls']}", flush=True)
                    check(w["max_duplication"] <= 1,
                          f"15(a) {w['window']}: a row twice through the "
                          "transactional sink")
            else:
                check(run.acks_in_flight_at_kill >= 2,
                      "15(a) the kill landed with < 2 acks in flight")
            _launch_check(f"15(a) {name}", d, device)
            out[name] = {"ok": run.ok, "duration_s": desc["duration_s"],
                         **d}

        modes = (
            ("ack_latency_cpu_engine", smoke.gate_ack,
             lambda: harness.run_ack_latency(
                 ack_ms=floors.get("ack_latency_smoke_ms", 20),
                 engine="cpu", device=device),
             "ack_window_speedup", "speedup_floor"),
            ("ack_latency_cuda_engine", smoke.gate_ack,
             lambda: harness.run_ack_latency(
                 ack_ms=floors.get("ack_latency_smoke_ms", 20),
                 engine="cuda", device=device),
             "ack_window_speedup", "speedup_floor"),
            ("poison", smoke.gate_poison,
             lambda: harness.run_poison_streaming(
                 rate=floors.get("poison_rate", 0.001), seed=args.seed,
                 target_ops=floors.get("poison_smoke_ops", 12_000),
                 device=device),
             "poison_throughput_ratio", "ratio_floor"),
            ("exactly_once_cpu_engine", smoke.gate_exactly_once,
             lambda: harness.run_exactly_once(
                 n_events=floors.get("exactly_once_smoke_events", 3_000),
                 engine="cpu", device=device),
             "exactly_once_overhead_ratio", "ratio_floor"),
            ("exactly_once_cuda_engine", smoke.gate_exactly_once,
             lambda: harness.run_exactly_once(
                 n_events=floors.get("exactly_once_smoke_events", 3_000),
                 engine="cuda", device=device),
             "exactly_once_overhead_ratio", "ratio_floor"))
        for name, gate, fn, ratio_key, floor_key in modes:
            before = kernel_counts()
            res = gate(asyncio.run(fn()), floors)
            d = counts_delta(before)
            wrong = smoke.correctness_failures(res["failures"])
            print(f"  15(b) {name}: engine={res['engine']} "
                  f"k1={d['k1_launches']} device_batches="
                  f"{d['device_batches']} failures={res['failures']}",
                  flush=True)
            _gate_line(f"15(b) {name} {ratio_key}", res[ratio_key],
                       res[floor_key], res["floor_ok"])
            check(not wrong, f"15(b) {name}: {wrong}")
            if res["engine"] == "cuda":
                _launch_check(f"15(b) {name}", d, device)
            else:
                check(d["launches"] == 0,
                      f"15(b) {name}: the per-tuple engine launched a "
                      "kernel")
            summary = {k: res[k] for k in (ratio_key, floor_key,
                                           "floor_ok", "failures")}
            if name.startswith("ack_latency"):
                for leg in ("windowed", "window1"):
                    summary[f"{leg}_events_per_second"] = \
                        res[leg]["events_per_second"]
                    summary[f"{leg}_max_acks_pending"] = \
                        res[leg]["max_acks_pending"]
            elif name == "poison":
                summary.update(
                    clean_events_per_second=res["clean_events_per_second"],
                    poisoned_events_per_second=res[
                        "poisoned_events_per_second"],
                    poison_rows=res["poisoned"]["poison_rows_committed"],
                    dlq_entries=res["poisoned"]["dlq_entries"],
                    probe_writes=res["poisoned"]["probe_writes"],
                    probe_bound=res["poisoned"]["probe_bound"])
            else:
                summary.update(
                    plain_events_per_second=res["plain_events_per_second"],
                    transactional_events_per_second=res[
                        "transactional_events_per_second"],
                    duplicate_rows=res["restart"]["duplicate_rows"],
                    restreamed_deduped_rows=res["restart"][
                        "restreamed_deduped_rows"],
                    unacked_suffix_rows=res["restart"][
                        "unacked_suffix_rows"])
            print(f"    {json.dumps(summary)}", flush=True)
            out[name] = {**summary, **d}
    out["15c_leftovers"] = leftover_cases(device, args.seed)
    out["wall_s"] = time.perf_counter() - t0
    out.update(_launch_counts())
    print(f"  phase 15 in {out['wall_s']:.1f} s; launches: "
          f"k1={out['k1_launches']} k2c={out['k2c_launches']}", flush=True)
    return {"15_exactly_once": out}


def harness_phase(args, runtime: dict, device: str = "cuda") -> dict:
    """Phase 16: the benchmark harness on the card. (a) `run_workload_
    matrix` over BENCH_FLOOR.json's `workload_smoke_profiles` and the three
    `filter_selective_*` profiles (offload mode: K2c), at
    `workload_smoke_ops`, every batch on the device route: each profile
    verifies its end state, K2c launches equal the filter profiles'
    device-routed batches and K1 the others'; (b) `run_multi_pipeline`
    over `multi_pipeline_smoke_profiles`; (c) `run_sharded_processes` at
    K = 1 and K = 2 over `sharded_bench_ops` (K worker processes on the
    card, the library built before them, every batch on the device
    route): each worker's launches equal its device-routed batches; each
    worker's events/s and device batches per 1,000 events print beside
    phase 13's; (d) `run_lag_vs_rate` at 25 % and 75 % of the probed
    maximum; (e) `run_wide_row`; (f) `python -m etl_tpu_torch.bench
    --smoke` as a process: its exit code, gates and `not_ported` list
    print, and its correctness checks must hold. Every floor prints beside
    its value with `floor_ok`. The launch counts are set to 0 just before
    the phase and read just after; the worker processes' launches are
    added from their reports."""
    import asyncio
    import subprocess

    from etl_tpu_torch.benchmarks import harness, smoke
    from etl_tpu_torch.benchmarks.harness import counts_delta, kernel_counts
    from etl_tpu_torch.chaos.runner import device_floor

    floors = smoke.load_floors()
    print("[16] the benchmark harness on the card", flush=True)
    oracle_clear("phase 16")
    _reset_launch_counts()
    out: dict = {}
    t0 = time.perf_counter()
    filt = ["filter_selective_10", "filter_selective_50",
            "filter_selective_90"]
    profiles = list(dict.fromkeys(floors["workload_smoke_profiles"] + filt))
    with device_floor(1):
        wm = smoke.gate_workload(asyncio.run(harness.run_workload_matrix(
            profiles, seed=args.seed,
            target_ops=floors.get("workload_smoke_ops", 400),
            device=device)), floors)
        for name, r in wm["profiles"].items():
            print(f"  16(a) {name}: events/s={r['events_per_second']} "
                  f"verified={r['verified']} k1={r['k1_launches']} "
                  f"k2c={r['k2c_launches']} device_batches="
                  f"{r['device_batches']} rows_filtered="
                  f"{r['decode_rows_filtered']}", flush=True)
            _gate_line(f"16(a) {name} events/s", r["events_per_second"],
                       wm["floors"].get(name), r["events_per_second"]
                       >= wm["floors"].get(name, 0))
            check(r["verified"], f"16(a) {name}: end state not verified")
            _launch_check(f"16(a) {name}", r, device,
                          "k2c" if name in filt else "k1")
            if name in filt and device == "cuda":
                check(r["k2c_launches"] == r["device_batches"],
                      f"16(a) {name}: K2c {r['k2c_launches']} != its "
                      f"device-routed batches {r['device_batches']}")
        out["16a_workloads"] = {n: {k: r[k] for k in (
            "events_per_second", "k1_launches", "k2c_launches",
            "device_batches", "decode_rows_filtered")}
            for n, r in wm["profiles"].items()}

        mp = smoke.gate_multi(asyncio.run(harness.run_multi_pipeline(
            profiles=floors.get("multi_pipeline_smoke_profiles"),
            seed=args.seed,
            target_ops=floors.get("multi_pipeline_smoke_ops", 500),
            device=device)), floors)
        print(f"  16(b) multi-pipeline: {json.dumps(mp['per_stream'])} "
              f"grants={mp['admission_grants']} drained="
              f"{mp['scheduler_drained']} k1={mp['k1_launches']} "
              f"device_batches={mp['device_batches']}", flush=True)
        _gate_line("16(b) aggregate events/s",
                   mp["aggregate_events_per_second"],
                   mp["floor_events_per_second"], mp["floor_ok"])
        check(not smoke.correctness_failures(mp["failures"]),
              f"16(b) multi-pipeline: {mp['failures']}")
        _launch_check("16(b) multi-pipeline", mp, device)
        out["16b_multi_pipeline"] = {k: mp[k] for k in (
            "aggregate_events_per_second", "floor_events_per_second",
            "floor_ok", "per_stream", "k1_launches", "device_batches")}

    ops = floors.get("sharded_bench_ops", 12_000)
    single = asyncio.run(harness.run_sharded_processes(
        shards=1, seed=args.seed, target_ops=ops, device=device,
        device_floor=1))
    sharded = smoke.gate_sharded(asyncio.run(harness.run_sharded_processes(
        shards=2, seed=args.seed, target_ops=ops, device=device,
        device_floor=1)), floors, single=single)
    r13 = runtime.get("13_sharded", {})
    worker_k1 = worker_k2c = 0
    for tag, res in (("K=1", single), ("K=2", sharded)):
        for s, w in res["per_shard"].items():
            print(f"  16(c) {tag} worker {s}: tables={w['tables']} "
                  f"events/s={w['events_per_second']} verified="
                  f"{w['verified']} k1={w['k1_launches']} k2c="
                  f"{w['k2c_launches']} device_batches="
                  f"{w['device_batches']} device batches per 1,000 "
                  f"events={w['device_batches_per_1000_events']:.2f}",
                  flush=True)
            check(w["verified"], f"16(c) {tag} worker {s}: not verified")
            check(w["launches_ok"] and w["device_batches"] > 0,
                  f"16(c) {tag} worker {s}: launches {w['launches']} vs "
                  f"device-routed batches {w['device_batches']}")
            if device == "cuda":
                check(w["k1_launches"] > 0,
                      f"16(c) {tag} worker {s}: K1 launched no time")
            worker_k1 += w["k1_launches"]
            worker_k2c += w["k2c_launches"]
    if r13:
        print(f"  16(c) phase 13 of this call: events/s="
              f"{r13['events_per_second']:.0f} over 2 -> 3 pods in one "
              f"process, device batches per 1,000 events="
              f"{1000 * r13['device_batches'] / args.shard_events:.2f}",
              flush=True)
    _gate_line("16(c) K=2 aggregate events/s",
               sharded["aggregate_events_per_second"],
               sharded["floor_events_per_second"], sharded["floor_ok"])
    print(f"  16(c) K=2 / K=1: {sharded['speedup_vs_single']} (the "
          f"reference's --sharded asks for > 1)", flush=True)
    check(sharded["all_verified"] and single["all_verified"]
          and sharded["union_covers_all_tables"],
          f"16(c) the sharded processes: {sharded['failures']}")
    out["16c_sharded"] = {
        "k1": {s: {k: w[k] for k in (
            "events_per_second", "device_batches",
            "device_batches_per_1000_events", "k1_launches")}
            for s, w in single["per_shard"].items()},
        "k2": {s: {k: w[k] for k in (
            "events_per_second", "device_batches",
            "device_batches_per_1000_events", "k1_launches")}
            for s, w in sharded["per_shard"].items()},
        "aggregate_k1": single["aggregate_events_per_second"],
        "aggregate_k2": sharded["aggregate_events_per_second"],
        "floor": sharded["floor_events_per_second"],
        "floor_ok": sharded["floor_ok"],
        "speedup_vs_single": sharded["speedup_vs_single"]}

    lag = asyncio.run(harness.run_lag_vs_rate(fractions=(0.25, 0.75),
                                              device=device))
    for row in lag["rates"]:
        print(f"  16(d) lag at {row['fraction']} of "
              f"{lag['max_events_per_second']:.0f} events/s: target "
              f"{row['target_rate']} events={row['events']} p50_ms="
              f"{row['p50_ms']:.2f} p95_ms={row['p95_ms']:.2f} k1="
              f"{row['k1_launches']}", flush=True)
    check(lag["ok"], "16(d) a lag run's checks failed")
    check(device != "cuda" or all(r["k1_launches"] > 0
                                  for r in lag["rates"]),
          "16(d) a paced run launched no K1")
    out["16d_lag"] = lag

    before = kernel_counts()
    wide = harness.run_wide_row(device=device)
    d = counts_delta(before)
    print(f"  16(e) wide row: rows/s={wide['rows_per_second']} cells/s="
          f"{wide['cells_per_second']} dense={wide['dense_columns']} "
          f"object={wide['object_columns']} words/row="
          f"{wide['words_per_row']} == oracle route: "
          f"{wide['equals_oracle']} k1={d['k1_launches']}", flush=True)
    check(wide["ok"], "16(e) the wide row differs from the oracle route")
    _launch_check("16(e) wide row", d, device)
    out["16e_wide_row"] = {k: wide[k] for k in (
        "rows_per_second", "cells_per_second", "dense_columns",
        "object_columns", "words_per_row")}

    proc = subprocess.run(
        [sys.executable, "-m", "etl_tpu_torch.bench", "--smoke",
         "--device", device], capture_output=True, text=True, timeout=900,
        cwd=ROOT)
    try:
        sm = json.loads(proc.stdout.strip().splitlines()[-1])
    except (ValueError, IndexError):
        sm = {}
    print(f"  16(f) bench --smoke: rc={proc.returncode} ok={sm.get('ok')} "
          f"gates={json.dumps(sm.get('gates'))}", flush=True)
    print(f"  16(f) not_ported: {json.dumps(sorted(sm.get('not_ported', {})))}",
          flush=True)
    for key in ("table_streaming_events_per_second", "ack_window_speedup",
                "poison_throughput_ratio", "exactly_once_overhead_ratio",
                "multi_pipeline_events_per_second",
                "sharded_events_per_second", "workload_events_per_second",
                "coldstart_cold_first_durable_seconds",
                "coldstart_warm_first_durable_seconds",
                "coldstart_failures", "static_analysis_seconds",
                "static_analysis_findings", "static_analysis_violations",
                "static_analysis_baseline_clean",
                "static_analysis_baseline_seconds", "ir_analysis_seconds",
                "ir_analysis_clean", "ir_analysis_report",
                "mesh_sharded_equals_single", "mesh_shards"):
        print(f"  16(f) {key}={json.dumps(sm.get(key))}", flush=True)
    check(not [k for k in sm.get("not_ported", {})
               if k.startswith("coldstart_")]
          and "coldstart" in sm.get("gates", {}),
          "16(f) bench --smoke does not gate the coldstart_* sizes")
    # the two lint gates (the IR tier with its mesh variants) and the
    # mesh gate run and hold; nothing (but, where pyarrow is missing, the
    # Parquet floor) stays not ported
    check(sm.get("gates", {}).get("static_analysis") is True
          and sm.get("gates", {}).get("ir_analysis") is True,
          "16(f) bench --smoke: a lint gate did not hold")
    check(sm.get("gates", {}).get("mesh") is True
          and sm.get("mesh_shards") == 8,
          f"16(f) bench --smoke: the mesh gate did not hold: "
          f"{json.dumps(sm.get('mesh_check'))}")
    check(set(sm.get("not_ported", {})) - {
        "egress_floors.parquet_rows_per_sec"} == set(),
          f"16(f) bench --smoke: a gate is still not ported: "
          f"{sorted(sm.get('not_ported', {}))}")
    check(bool(sm) and all(sm.get("correctness", {"": False}).values()),
          f"16(f) bench --smoke: a correctness check failed "
          f"({json.dumps(sm.get('correctness'))}; stderr "
          f"{proc.stderr[-600:]})")
    out["16f_smoke"] = {k: sm.get(k) for k in (
        "ok", "gates", "correctness", "not_ported",
        "fleet_actuation_digest")}
    out["16f_smoke"]["rc"] = proc.returncode
    out["wall_s"] = time.perf_counter() - t0
    out.update(_launch_counts())
    out["k1_launches"] += worker_k1
    out["k2c_launches"] += worker_k2c
    print(f"  phase 16 in {out['wall_s']:.1f} s; launches (workers "
          f"included): k1={out['k1_launches']} k2c={out['k2c_launches']}",
          flush=True)
    return {"16_harness": out}


def autoscale_api_phase(args, runtime: dict, device: str = "cuda") -> dict:
    """Phase 17: the autoscale controller's two chaos scenarios on the
    card against the same seed on the CPU, the reaction-time gate, and
    the control plane's replicator children (module docstring, 17). The
    launch counts are set to 0 just before the phase and read just after;
    17(c)'s children count their own, read from their `/metrics`."""
    import asyncio

    from etl_tpu_torch.benchmarks import harness, smoke
    from etl_tpu_torch.benchmarks.control_plane import run_control_plane
    from etl_tpu_torch.chaos.autoscale import (run_autoscale_controller_crash,
                                               run_autoscale_surge_drain)
    from etl_tpu_torch.chaos.runner import device_floor
    from etl_tpu_torch.ops.engine import DeviceDecoder

    print("[17] the autoscale controller and the control plane",
          flush=True)
    oracle_clear("phase 17")
    t0 = time.perf_counter()
    out: dict = {}
    cpu = {fn.__name__: asyncio.run(fn(seed=args.seed, device="cpu"))
           for fn in (run_autoscale_surge_drain,
                      run_autoscale_controller_crash)}
    _reset_launch_counts()
    for fn in (run_autoscale_surge_drain, run_autoscale_controller_crash):
        # at the CPU run's threshold: most of these batches hold 64-105
        # rows, where a measured threshold would move them between the
        # host route and K1 from one probe to the next
        with device_floor(DeviceDecoder.DEVICE_MIN_ROWS):
            run = asyncio.run(fn(seed=args.seed, device=device))
        ref = cpu[fn.__name__]
        d = run.describe()
        stats = d["invariants"].get("stats", {})
        print(f"  17(a) {run.scenario}: ok={run.ok} decisions="
              f"{[x['action'] for x in run.decision_trace]} k_track="
              f"{run.k_track} rebalance_s="
              f"{[r['seconds'] for r in run.rebalances]} max_duplication="
              f"{stats.get('max_duplication')} lost_rows="
              f"{stats.get('lost_rows')} k1={run.k1_launches} "
              f"device_batches={run.device_batches} duration_s="
              f"{d['duration_s']}", flush=True)
        check(run.ok, f"17(a) {run.scenario} broke an invariant: "
              f"{d['invariants']['violations']}")
        check(ref.ok, f"17(a) {run.scenario} on the CPU broke an "
              f"invariant: {ref.report.violations}")
        check(run.decision_trace == ref.decision_trace
              and run.k_track == ref.k_track,
              f"17(a) {run.scenario}: decision trace {run.decision_trace} "
              f"differs from the CPU's {ref.decision_trace}")
        check(0 < run.k1_launches == run.device_batches,
              f"17(a) {run.scenario}: K1 {run.k1_launches} != device-routed "
              f"batches {run.device_batches} (or none)")
        out[f"17a_{run.scenario}"] = {
            "ok": run.ok, "decisions": run.decision_trace,
            "k_track": run.k_track, "rebalances": run.rebalances,
            "k1_launches": run.k1_launches,
            "device_batches": run.device_batches,
            "max_duplication": stats.get("max_duplication"),
            "duration_s": d["duration_s"]}
    out.update(_launch_counts())

    floors = smoke.load_floors()
    limit = floors.get("autoscale_reaction_ticks_max", 3)
    gate = harness.run_autoscale_bench(seed=args.seed,
                                       reaction_ticks_max=limit)
    print(f"  17(b) bench --autoscale: reaction_ticks="
          f"{gate['reaction_ticks']} (max {limit}) decisions="
          f"{gate['decisions']} deterministic={gate['deterministic']} "
          f"ok={gate['ok']}", flush=True)
    check(gate["ok"] and gate["reaction_ticks"] <= limit
          and gate["deterministic"]
          and gate["decisions"][-1]["target_k"] == 2,
          f"17(b) the autoscale gate failed: {gate['failures']}")
    sm = runtime.get("16_harness", {}).get("16f_smoke", {})
    print(f"  17(b) phase 16's bench --smoke: rc={sm.get('rc')} autoscale "
          f"gate={sm.get('gates', {}).get('autoscale')}", flush=True)
    check(sm.get("rc") == 0 and sm.get("gates", {}).get("autoscale") is True
          and not any(k.startswith("autoscale_")
                      for k in sm.get("not_ported", {})),
          "17(b) bench --smoke did not hold the autoscale gates with rc 0")
    out["17b_gate"] = {k: gate[k] for k in (
        "reaction_ticks", "reaction_ticks_max", "scale_up_tick",
        "scale_down_tick", "deterministic", "ok")}

    cp = asyncio.run(run_control_plane(
        copy_rows=CONTROL_PLANE_COPY_ROWS, events=CONTROL_PLANE_EVENTS,
        tables=4, device=device, seed=args.seed))
    print(f"  17(c) control plane: routes={json.dumps(cp['routes'])} "
          f"K=1 healthy in {cp['k1_start_s']:.2f} s, copy "
          f"{cp['tables'] * cp['copy_rows']} rows in {cp['copy_s']:.2f} s, "
          f"CDC {cp['events']} in {cp['k1_cdc_s']:.2f} s; rebalance "
          f"{cp['rebalance_s']:.3f} s, roll to K=2 {cp['roll_s']:.2f} s, "
          f"CDC {cp['events']} in {cp['k2_cdc_s']:.2f} s", flush=True)
    print(f"  17(c) K=1 child /metrics: {json.dumps(cp['k1_metrics'])}; "
          f"K=2 children: {json.dumps(cp['k2_metrics'])}", flush=True)
    print(f"  17(c) per table: {json.dumps(cp['per_table'])}; children "
          f"{json.dumps(cp['children'])}, left {cp['children_left']}; "
          f"checks {json.dumps(cp['checks'])}", flush=True)
    check(cp["ok"], f"17(c) the control plane failed: {cp['checks']}")
    out["17c_control_plane"] = {k: cp[k] for k in (
        "routes", "k1_start_s", "copy_s", "k1_cdc_s", "rebalance_s",
        "roll_s", "k2_start_s", "k2_cdc_s", "k1_metrics", "k2_metrics",
        "per_table", "checks", "build_s")}
    out["wall_s"] = time.perf_counter() - t0
    print(f"  phase 17 in {out['wall_s']:.1f} s; launches (17(a)): "
          f"k1={out['k1_launches']}; 17(c)'s children: kernel_s="
          f"{[m['kernel_s'] for m in [cp['k1_metrics']] + cp['k2_metrics']]}",
          flush=True)
    return {"17_autoscale_api": out}


#: phase 17(c)'s depth: rows a table (four tables) and inserts at each K
CONTROL_PLANE_COPY_ROWS = 50_000
CONTROL_PLANE_EVENTS = 100_000

#: phase 18(a): `devtools chaos` seconds a scenario (the reference's 10)
DEVTOOLS_CHAOS_SECONDS = 10
#: phase 18(c)'s depth: rows a table (two tables a pipeline) and each CDC
#: wave's inserts into a pipeline; 18(d)'s inserts into each pipeline
FLEET_COPY_ROWS = 25_000
FLEET_EVENTS = 20_000
ADMISSION_EVENTS = 50_000

#: what `python -m etl_tpu_torch.chaos --fleet --seed 7` and `bench
#: --fleet` print on the CPU (tests/test_torch_fleet.py holds both to the
#: reference's runs of the same seed)
FLEET_CHAOS_SEED7 = {
    "converge_ticks": {"edit": 1, "initial": 1, "kill_after_actuation": 0,
                       "kill_before_actuation": 0},
    "actuations": 109, "applied_records": 109, "double_actuations": 0,
    "resume_modes": ["kill_before_actuation:redrive",
                     "kill_after_actuation:settle"],
    "bus_actions": {"ack_depth": 2, "admission_weight": 2, "pid_lag": 3},
    "fleet_size": 100, "ok": True}
FLEET_BENCH_SEED7 = {
    "converge_ticks": 1, "edit_converge_ticks": 1, "actuations": 104,
    "applied_records": 104, "double_actuations": 0, "deterministic": True,
    "observed_equals_placement": True,
    "actuation_digest":
        "1253f14e33ece0d9778d1d66fa4689f7baaa8024413db5468670c80a2a60f48e",
    "ok": True}
#: the reference's `devtools chaos` scenarios, in its order
DEVTOOLS_SCENARIOS = ["partition", "latency", "corruption", "copy",
                      "destination", "slot"]


def fleet_phase(args, runtime: dict, device: str = "cuda") -> dict:
    """Phase 18: devtools chaos and the fleet's arithmetic as processes
    beside the fleet's replicator children and the admission weights on
    live pipelines (module docstring, 18). The launch counts are set to
    0 just before 18(d) and read just after; 18(a)'s process and 18(c)'s
    children count their own."""
    import asyncio
    import subprocess
    import tempfile

    from etl_tpu_torch.benchmarks.fleet import (run_admission_weights,
                                                run_fleet_children)

    print("[18] devtools and the fleet reconciler", flush=True)
    oracle_clear("phase 18")
    t0 = time.perf_counter()
    out: dict = {}
    logs = tempfile.TemporaryDirectory()
    commands = {
        "18a_devtools_chaos": ["-m", "etl_tpu_torch.devtools", "chaos",
                               "--scenario", "all", "--engine", "cuda",
                               "--device", device,
                               "--seconds", str(DEVTOOLS_CHAOS_SECONDS)],
        "18b_chaos_fleet": ["-m", "etl_tpu_torch.chaos", "--fleet",
                            "--seed", "7"],
        "18b_bench_fleet": ["-m", "etl_tpu_torch.bench", "--fleet"]}
    procs: dict = {}
    try:
        for name, argv in commands.items():
            with open(os.path.join(logs.name, name + ".out"), "w") as fo, \
                    open(os.path.join(logs.name, name + ".err"), "w") as fe:
                procs[name] = (subprocess.Popen(
                    [sys.executable, *argv], cwd=ROOT, stdout=fo,
                    stderr=fe), time.perf_counter())

        fc = asyncio.run(run_fleet_children(
            FLEET_COPY_ROWS, FLEET_EVENTS, device=device, seed=args.seed))
        ticks = fc["converge_ticks"]
        print(f"  18(c) fleet from empty: ticks={ticks['initial']} "
              f"observed={json.dumps(fc['observed_initial'])} slo="
              f"{json.dumps(fc['slo_weights'])}; 3 children healthy in "
              f"{fc['start_s']:.2f} s, copy {4 * FLEET_COPY_ROWS} rows in "
              f"{fc['copy_s']:.2f} s, wave {2 * FLEET_EVENTS} inserts in "
              f"{fc['wave1_s']:.2f} s; /metrics "
              f"{json.dumps(fc['metrics_initial'])}", flush=True)
        for k in fc["kills"]:
            print(f"  18(c) {k['label']} ({k['window']}, pipeline "
                  f"{k['pipeline_id']}): pending at kill "
                  f"{k['pending_at_kill']}, {k['mode']} "
                  f"{json.dumps(k['settled'])}, resume's runtime calls "
                  f"{k['resume_runtime_calls']}, second resume "
                  f"{k['second_resume']}", flush=True)
        print(f"  18(c) edit (delete B, A 1 -> 2): ticks={ticks['edit']} "
              f"({ticks['edit_after_kills']} after the kills) in "
              f"{fc['edit_s']:.2f} s; observed="
              f"{json.dumps(fc['observed_edit'])}; A's 2 children healthy "
              f"in {fc['roll_start_s']:.2f} s; wave {FLEET_EVENTS} in "
              f"{fc['wave2_s']:.2f} s; /metrics "
              f"{json.dumps(fc['metrics_edit'])}", flush=True)
        print(f"  18(c) /v1/fleet {json.dumps(fc['fleet_view_edit'])}; "
              f"actuations {len(fc['actuations'])} = applied "
              f"{fc['journal']['applied']}, double {fc['double_actuations']};"
              f" remove ticks {ticks['remove']}, observed "
              f"{json.dumps(fc['observed_end'])}; per table "
              f"{json.dumps(fc['per_table'])}; child starts "
              f"{fc['child_starts']}, left {fc['children_left']}; checks "
              f"{json.dumps(fc['checks'])}", flush=True)
        check(fc["ok"], f"18(c) the fleet failed: {fc['checks']}")
        out["18c_fleet_children"] = {k: fc[k] for k in (
            "converge_ticks", "start_s", "copy_s", "wave1_s", "edit_s",
            "roll_start_s", "wave2_s", "metrics_initial", "metrics_edit",
            "kills", "fleet_view_edit", "per_table", "child_starts",
            "double_actuations", "checks")}

        _reset_launch_counts()
        aw = asyncio.run(run_admission_weights(
            ADMISSION_EVENTS, device=device, seed=args.seed))
        out.update(_launch_counts())
        print(f"  18(d) admission weights: applied "
              f"{json.dumps(aw['applied_weights'])} scheduler "
              f"{json.dumps(aw['scheduler_slo'])} stats "
              f"{json.dumps(aw['tenant_stats'])}; "
              f"{2 * ADMISSION_EVENTS} inserts in {aw['window_s']:.2f} s "
              f"({aw['events_per_second']:.0f} events/s); verified "
              f"{json.dumps(aw['verified'])}; k1={out['k1_launches']} "
              f"device_batches={aw['kernel_counts_whole_run']['device_batches']}"
              f"; drained {json.dumps(aw['drained'])}; checks "
              f"{json.dumps(aw['checks'])}", flush=True)
        check(aw["ok"], f"18(d) the admission weights failed: "
              f"{aw['checks']}")
        on_card = device.split(":")[0] == "cuda"
        check((out["k1_launches"] if on_card else
               aw["kernel_counts_whole_run"]["device_batches"])
              == aw["kernel_counts_whole_run"]["device_batches"] > 0,
              f"18(d): K1 {out['k1_launches']} != device-routed batches "
              f"{aw['kernel_counts_whole_run']['device_batches']}")
        out["18d_admission"] = {k: aw[k] for k in (
            "applied_weights", "scheduler_slo", "tenant_stats", "window_s",
            "events_per_second", "verified", "kernel_counts_whole_run",
            "drained", "checks")}

        done: dict = {}
        for name, (proc, started) in procs.items():
            rc = proc.wait(timeout=600)
            with open(os.path.join(logs.name, name + ".out")) as f:
                lines = [json.loads(x) for x in f.read().splitlines()
                         if x.startswith("{")]
            with open(os.path.join(logs.name, name + ".err")) as f:
                err = f.read()
            done[name] = (rc, lines, err, time.perf_counter() - started)

        rc, reports, err, secs = done["18a_devtools_chaos"]
        k1_a = 0
        for r in reports:
            print(f"  18(a) devtools chaos {json.dumps(r)}", flush=True)
            k1_a += r["k1_launches"]
        print(f"  18(a) rc={rc}, done within {secs:.1f} s of its start "
              f"(read after 18(d)); stderr tail {err[-300:]!r}", flush=True)
        check(rc == 0 and [r["scenario"] for r in reports]
              == DEVTOOLS_SCENARIOS,
              f"18(a) devtools chaos rc={rc}: {err[-600:]}")
        by = {r["scenario"]: r for r in reports}
        check(all(0 < r["device_batches"] and r["launches_ok"]
                  and (r["k1_launches"] == r["device_batches"] or not on_card)
                  for r in reports),
              "18(a) a scenario's K1 launches != its device-routed batches")
        check(by["copy"]["copy_severs"] > 0, "18(a) copy: no sever "
              "landed before READY")
        check(by["corruption"]["corrupted_chunks"] > 0,
              "18(a) corruption: no chunk corrupted")
        out["18a_devtools_chaos"] = {"rc": rc, "seconds": secs,
                                     "reports": reports, "k1_launches": k1_a}

        rc, lines, err, secs = done["18b_chaos_fleet"]
        got = lines[-1] if lines else {}
        print(f"  18(b) chaos --fleet: rc={rc} {json.dumps(got)}", flush=True)
        print(f"  18(b) (both processes done within {secs:.1f} s of their "
              f"start; read after 18(d))", flush=True)
        check(rc == 0 and all(got.get(k) == v
                              for k, v in FLEET_CHAOS_SEED7.items()),
              f"18(b) chaos --fleet differs from the CPU run: {got} "
              f"{err[-400:]}")
        rc_b, lines, err, _ = done["18b_bench_fleet"]
        gate = lines[-1] if lines else {}
        print(f"  18(b) bench --fleet: rc={rc_b} {json.dumps(gate)}",
              flush=True)
        check(rc_b == 0 and all(gate.get(k) == v
                                for k, v in FLEET_BENCH_SEED7.items()),
              f"18(b) bench --fleet differs from the CPU run: {gate} "
              f"{err[-400:]}")
        sm = runtime.get("16_harness", {}).get("16f_smoke", {})
        print(f"  18(b) phase 16's bench --smoke: rc={sm.get('rc')} fleet "
              f"gate={sm.get('gates', {}).get('fleet')} digest="
              f"{sm.get('fleet_actuation_digest')}", flush=True)
        check(sm.get("rc") == 0 and sm.get("gates", {}).get("fleet") is True
              and sm.get("fleet_actuation_digest")
              == FLEET_BENCH_SEED7["actuation_digest"]
              and not any(k.startswith("fleet_")
                          for k in sm.get("not_ported", {})),
              "18(b) bench --smoke did not hold the fleet gate with rc 0")
        out["18b_fleet"] = {"chaos": got, "bench": gate}
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        logs.cleanup()
    out["wall_s"] = time.perf_counter() - t0
    print(f"  phase 18 in {out['wall_s']:.1f} s; launches: 18(a)'s process "
          f"k1={out['18a_devtools_chaos']['k1_launches']}, 18(d) "
          f"k1={out['k1_launches']}; 18(c)'s children: kernel_s="
          f"{[m['kernel_s'] for m in fc['metrics_initial'] + fc['metrics_edit']]}",
          flush=True)
    return {"18_fleet": out}


#: phase 19(b): `tests/test_fuzz.py`'s pinned seed and case count
AVRO_FUZZ_SEED = 20260729
AVRO_FUZZ_CASES = 300


def _refused_for_pyarrow(fn, what: str) -> str:
    """Call `fn`; it must raise the typed CONFIG_INVALID naming pyarrow.
    Returns the message."""
    from etl_tpu_torch.models.errors import ErrorKind, EtlError

    try:
        fn()
    except EtlError as e:
        check(e.kind is ErrorKind.CONFIG_INVALID and "pyarrow" in str(e),
              f"19(c): {what} refused with {e.kind.name}, not "
              f"CONFIG_INVALID naming pyarrow: {e}")
        return str(e)
    raise SmokeFailure(f"19(c): {what} built without pyarrow")


def lake_phase(args, device: str = "cuda") -> dict:
    """Phase 19: the lake, Iceberg and maintenance (module docstring,
    19). Without pyarrow the launch counts stay 0: the phase launches
    nothing."""
    import asyncio
    import contextlib
    import io
    import logging
    import tempfile

    from etl_tpu_torch.benchmarks.smoke import pyarrow_importable
    from etl_tpu_torch.testing import fuzz

    print("[19] the lake, Iceberg and maintenance", flush=True)
    oracle_clear("phase 19")
    t0 = time.perf_counter()
    have = pyarrow_importable()
    print(f"  19(a) pyarrow imports: {'yes' if have else 'no'}", flush=True)
    cases = fuzz.run_target("avro_ocf", seconds=0.0,
                            min_cases=AVRO_FUZZ_CASES, seed=AVRO_FUZZ_SEED)
    check(cases >= AVRO_FUZZ_CASES, "19(b): fuzz_avro_ocf ran too few cases")
    print(f"  19(b) fuzz_avro_ocf: {cases} cases at seed {AVRO_FUZZ_SEED}, "
          "every file round-tripped through the independent reader, every "
          "flipped bit rejected typed or decoded to other records",
          flush=True)
    out: dict = {"pyarrow": have, "avro_ocf_cases": cases,
                 "k1_launches": 0, "k2_launches": 0, "epilogue_launches": 0,
                 "k2c_launches": 0, "egress_launches": 0}
    if not have:
        from etl_tpu_torch.destinations.iceberg import (IcebergConfig,
                                                        IcebergDestination)
        from etl_tpu_torch.destinations.lake import (LakeConfig,
                                                     LakeDestination)
        from etl_tpu_torch.maintenance import main as maintenance_main
        from etl_tpu_torch.replicator import run_replicator

        tmp = tempfile.TemporaryDirectory()
        refusals = {
            "lake": _refused_for_pyarrow(
                lambda: LakeDestination(LakeConfig(tmp.name)),
                "LakeDestination"),
            "iceberg": _refused_for_pyarrow(
                lambda: IcebergDestination(IcebergConfig(
                    "http://127.0.0.1:9", tmp.name)), "IcebergDestination")}
        err = io.StringIO()
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(err):
            rc = maintenance_main(["--warehouse", tmp.name])
        doc = json.loads(err.getvalue().strip().splitlines()[-1])
        check(rc == 2 and doc.get("kind") == "CONFIG_INVALID"
              and "pyarrow" in doc.get("error", ""),
              f"19(c): the maintenance command did not refuse typed: "
              f"rc={rc} {doc}")
        refusals["maintenance"] = doc["error"]
        config_dir = os.path.join(tmp.name, "config")
        os.makedirs(config_dir)
        with open(os.path.join(config_dir, "base.yaml"), "w") as f:
            json.dump({"pipeline_id": 1, "publication_name": "pub",
                       "pg_connection": {"host": "127.0.0.1", "port": 9,
                                         "name": "postgres",
                                         "username": "etl"},
                       "batch": {"batch_engine": "cuda", "device": device},
                       "destination": {"type": "lake",
                                       "warehouse_path": tmp.name}}, f)
        root = logging.getLogger()
        handlers, level = list(root.handlers), root.level
        try:
            refusals["replicator"] = _refused_for_pyarrow(
                lambda: asyncio.run(run_replicator(config_dir)),
                "run_replicator with destination lake")
        finally:
            root.handlers, root.level = handlers, level
        tmp.cleanup()
        for name, msg in refusals.items():
            print(f"  19(c) {name}: refused CONFIG_INVALID: {msg[:100]}",
                  flush=True)
        out["refusals"] = refusals
    else:
        from etl_tpu_torch import bench

        print(f"  19(d) pgbench into the lake: COPY {args.copy_rows} rows, "
              f"CDC {args.cdc_events} events", flush=True)
        lake_dir = tempfile.TemporaryDirectory()
        _reset_launch_counts()
        r = asyncio.run(bench.run_lake_cdc(args.copy_rows, args.cdc_events,
                                           device=device, seed=args.seed,
                                           warehouse_path=lake_dir.name))
        r.update(_launch_counts())
        print(f"  lake rows={r['lake_rows']} copy_s={r['copy_s']:.2f} "
              f"cdc_s={r['cdc_s']:.2f} events/s="
              f"{r['events_per_second']:.0f} cdc_files={r['cdc_files']} "
              f"maintenance={r['history']} launches: k1={r['k1_launches']} "
              f"device_batches={r['device_batches']}", flush=True)
        check(r["rows_ok"], "19(d): the lake's current view differs from "
              "the written rows")
        check(r["launches_ok"] and r["device_batches"]
              == r["device_routed_batches"] > 0,
              "19(d): K1 launches differ from the device-routed batches")
        before = r.pop("current")
        out.update(r)
        try:
            iceberg = iceberg_case(args, device)
            out["maintenance"] = maintenance_case(lake_dir.name, before,
                                                  r["cdc_files"])
        finally:
            lake_dir.cleanup()
    out["wall_s"] = time.perf_counter() - t0
    print(f"  phase 19 in {out['wall_s']:.1f} s", flush=True)
    res = {"19_lake": out}
    if have:
        res["19e_iceberg"] = iceberg
    return res


def iceberg_case(args, device: str = "cuda") -> dict:
    """Phase 19(e): pgbench's copy and CDC at 19(d)'s depth through K1
    into an `IcebergDestination` committing to the port's
    `FakeIcebergCatalog` (`bench.run_iceberg_cdc`), read back through the
    snapshot chain, the Avro manifests, Parquet and the CDC collapse: the
    live rows equal the written rows (count, `table_digest`, column by
    column), the catalog rejected no commit, K1 = device-routed batches
    > 0. The launch counts are set to 0 just before and read just
    after."""
    import asyncio

    from etl_tpu_torch import bench

    print(f"  19(e) pgbench into Iceberg: COPY {args.copy_rows} rows, CDC "
          f"{args.cdc_events} events (the fake REST catalog in this "
          f"process)", flush=True)
    oracle_clear("phase 19(e)")
    t0 = time.perf_counter()
    _reset_launch_counts()
    r = asyncio.run(bench.run_iceberg_cdc(args.copy_rows, args.cdc_events,
                                          device=device, seed=args.seed))
    r.update(_launch_counts())
    r["wall_s"] = time.perf_counter() - t0
    print(f"  live rows={r['live_rows']} snapshots={r['snapshots']} data "
          f"files={r['data_files']} copy_s={r['copy_s']:.2f} rows/s="
          f"{r['rows_per_second']:.0f} cdc_s={r['cdc_s']:.2f} events/s="
          f"{r['events_per_second']:.0f} read_s={r['read_s']:.2f} "
          f"rejections={len(r['rejections'])} launches: k1="
          f"{r['k1_launches']} device_batches={r['device_batches']} "
          f"routes {r['device_routed_batches']}/{r['host_routed_batches']}/"
          f"{r['oracle_routed_batches']} (device/host/oracle); 19(e) in "
          f"{r['wall_s']:.1f} s", flush=True)
    check(r["digest_ok"] and r["rows_ok"], "19(e): Iceberg's live rows "
          "differ from the written rows, or the catalog rejected a commit")
    check(r["launches_ok"] and r["device_batches"]
          == r["device_routed_batches"] > 0,
          "19(e): K1 launches differ from the device-routed batches")
    return r


def _maintenance_commands(warehouse: str) -> dict:
    """`python -m etl_tpu_torch.maintenance --warehouse DIR` (compaction),
    then with `--vacuum`, then `--history`, as processes, one after the
    other: each one's exit code, last stdout line, stderr's tail and
    seconds."""
    import subprocess

    out = {}
    for name, argv in (("compact", []), ("vacuum", ["--vacuum"]),
                       ("history", ["--history"])):
        t = time.perf_counter()
        p = subprocess.run(
            [sys.executable, "-m", "etl_tpu_torch.maintenance",
             "--warehouse", warehouse, *argv], cwd=ROOT,
            capture_output=True, text=True, timeout=300)
        out[name] = {"rc": p.returncode, "s": time.perf_counter() - t,
                     "doc": (p.stdout.strip().splitlines() or [""])[-1],
                     "stderr": p.stderr[-1500:]}
        if p.returncode != 0:
            break
    return out


def maintenance_case(warehouse: str, before, cdc_before: int) -> dict:
    """Phase 19(f), after 19(e), so that neither runs beside the other:
    the maintenance commands over 19(d)'s lake (`_maintenance_commands`:
    compaction, `--vacuum`, `--history`), each exit code 0; the current
    view read through a fresh `LakeDestination` afterwards must equal
    `before`, 19(d)'s view read the same way before the first
    command."""
    import asyncio

    from etl_tpu_torch import bench
    from etl_tpu_torch.destinations.lake import LakeConfig, LakeDestination

    async def view() -> tuple:
        lake = LakeDestination(LakeConfig(warehouse))
        await lake.startup()
        try:
            return (lake.read_current(bench.PGBENCH_TID).sort_by("aid"),
                    lake.current_cdc_file_count(bench.PGBENCH_TID))
        finally:
            await lake.shutdown()

    runs = _maintenance_commands(warehouse)
    for name, run in runs.items():
        check(run["rc"] == 0, f"19(f): maintenance {name} exited "
              f"{run['rc']}: {run['stderr']}")
    compact, vacuum, history = (json.loads(runs[k]["doc"]) for k in (
        "compact", "vacuum", "history"))
    t0 = time.perf_counter()
    after, cdc_after = asyncio.run(view())
    view_s = time.perf_counter() - t0
    same = before.equals(after)
    out = {"rows": after.num_rows, "cdc_files_before": cdc_before,
           "cdc_files_after": cdc_after, "compact": compact,
           "compact_s": runs["compact"]["s"], "vacuum": vacuum,
           "vacuum_s": runs["vacuum"]["s"],
           "history": [(h["operation"], h["outcome"])
                       for h in history["history"]],
           "view_equal": same,
           "commands_s": sum(run["s"] for run in runs.values()),
           "view_s": view_s}

    def brief(doc: dict) -> str:
        return json.dumps({k: doc.get(k) for k in (
            "tables", "compacted_files", "vacuumed_files",
            "skipped_by_policy")})

    print(f"  19(f) maintenance over 19(d)'s lake: "
          f"compaction {brief(compact)} ({out['compact_s']:.2f} s), vacuum "
          f"{brief(vacuum)} ({out['vacuum_s']:.2f} s); CDC files "
          f"{cdc_before} -> {cdc_after}; history {out['history']}; current "
          f"view {before.num_rows} rows before == {after.num_rows} after: "
          f"{same}; the commands {out['commands_s']:.1f} s, the view after "
          f"{out['view_s']:.1f} s", flush=True)
    check(same, "19(f): the lake's current view changed under "
          "compaction or vacuum")
    return out


class _Background:
    """A command started now and read later, its output in files, so that
    a long build overlaps a phase; `stop` ends it, and its process group,
    on any way out."""

    def __init__(self, argv: list):
        import subprocess
        import tempfile

        self.dir = tempfile.mkdtemp(prefix="chip-smoke-bg-")
        self.out = open(os.path.join(self.dir, "out"), "w+")
        self.err = open(os.path.join(self.dir, "err"), "w+")
        self.proc = subprocess.Popen(argv, stdout=self.out, stderr=self.err,
                                     cwd=ROOT, start_new_session=True)

    def result(self, timeout: float) -> tuple:
        rc = self.proc.wait(timeout)
        self.out.seek(0)
        self.err.seek(0)
        return rc, self.out.read(), self.err.read()

    def stop(self) -> None:
        import signal

        if self.proc.poll() is None:
            os.killpg(self.proc.pid, signal.SIGKILL)
            self.proc.wait()
        self.out.close()
        self.err.close()
        shutil.rmtree(self.dir, ignore_errors=True)


def start_coldstart(device: str = "cuda") -> _Background:
    """Phase 20(b)'s `python -m etl_tpu_torch.bench --coldstart`, started
    before phase 14 so that its cold lifetime's nvcc build overlaps the
    phase; phase 20 reads its result."""
    return _Background([sys.executable, "-m", "etl_tpu_torch.bench",
                        "--coldstart", "--device", device])


#: phase 20(a): pgbench batch sizes timed through the host route and K1,
#: from the host route's floor (HOST_MIN_ROWS) up; repetitions of each
ROUTE_ROWS = (64, 128, 256)
ROUTE_REPS = 30


def route_times(device: str) -> dict:
    """Phase 20(a)'s direct answer to the routing question: one pgbench
    batch of each of ROUTE_ROWS rows decoded whole (pack, the route,
    assemble; `decode()` returns a host batch) through the host route
    and through K1, each the minimum of ROUTE_REPS calls, the two
    alternating; both must equal the CPU codec. The decoders keep out of
    the routing counters (`telemetry=False`); their K1 launches are
    made before the phase's counts are set to 0."""
    from etl_tpu_torch import bench
    from etl_tpu_torch.ops.engine import DeviceDecoder
    from etl_tpu_torch.ops.wal import concat_payloads, stage_wal_batch

    schema = bench.make_schema()
    routes = {
        "host": DeviceDecoder(schema, device=device,
                              device_min_rows=1 << 30, host_min_rows=1,
                              telemetry=False),
        "k1": DeviceDecoder(schema, device=device, device_min_rows=1,
                            telemetry=False)}
    oracle = DeviceDecoder(schema, device="cpu", device_min_rows=1 << 30,
                           telemetry=False)
    out = {}
    for n in ROUTE_ROWS:
        buf, offs, lens = concat_payloads(bench.build_workload(n))
        staged = stage_wal_batch(buf, offs, lens, 4).staged
        want = oracle.decode(staged)
        for name, dec in routes.items():
            check(bench.batches_equal(dec.decode(staged), want),
                  f"20(a) {n} rows: the {name} route differs from the "
                  "CPU codec")
        best = dict.fromkeys(routes, float("inf"))
        for _ in range(ROUTE_REPS):
            for name, dec in routes.items():
                t0 = time.perf_counter()
                dec.decode(staged)
                best[name] = min(best[name], time.perf_counter() - t0)
        out[n] = {f"{name}_ms": t * 1e3 for name, t in best.items()}
    return out


def program_store_phase(args, runtime: dict, main_counts: dict,
                        coldstart: _Background,
                        device: str = "cuda") -> dict:
    """Phase 20: the program store and autotune at full width. (a) The
    routing cost model fitted on this card (`autotune.measure`: fixed ms,
    round-trip GB/s, the host route's column-rows/s and per-call ms),
    pgbench batches of ROUTE_ROWS rows timed through the host route and
    K1 (`route_times`), and the resolved
    `device_min_rows` of pgbench_accounts and of the coldstart schema;
    phase 4's batches each took K1, and every phase's device, host and
    oracle batches (checked to add up to its routed batches where it ran)
    print. (b) `python -m etl_tpu_torch.bench --coldstart` as a process
    (`coldstart`, started before phase 14 so that its cold build overlaps
    phases 14-15) at BENCH_FLOOR.json's full coldstart sizes: two
    replicator lifetimes on a fresh cache directory, each printing its
    nvcc seconds, builds,
    disk hits, oracle rows and start, first-durable and total seconds;
    the warm run must build nothing, each run's K1 launches must equal
    its device-routed batches and its delivered rows its written rows.
    The launch counts are set to 0 just before the phase and read just
    after; the workers' launches are added from their reports."""
    from etl_tpu_torch import bench
    from etl_tpu_torch.benchmarks import coldstart_worker as cw
    from etl_tpu_torch.models import (ColumnSchema, Oid,
                                      ReplicatedTableSchema, TableName,
                                      TableSchema)
    from etl_tpu_torch.ops import autotune
    from etl_tpu_torch.ops.bitpack import layout_for_specs
    from etl_tpu_torch.ops.engine import DeviceDecoder

    print("[20] the program store and autotune", flush=True)
    oracle_clear("phase 20")
    t0 = time.perf_counter()
    card = bench.card_info()
    model = autotune.measure()
    check(model is not None, "20(a) no cost model on the card")
    print(f"  20(a) cost model ({card}): fixed_ms={model.fixed_s * 1e3!r} "
          f"round_trip_GB/s={model.bytes_per_s / 1e9!r} host_col_rows/s="
          f"{model.host_col_rows_per_s!r} host_fixed_ms="
          f"{model.host_fixed_s * 1e3!r}", flush=True)
    routes = route_times(device)
    for n, r in routes.items():
        print(f"  20(a) {n} pgbench rows ({card}): host route "
              f"{r['host_ms']!r} ms, K1 route {r['k1_ms']!r} ms (whole "
              f"decode, min of {ROUTE_REPS})", flush=True)
    _reset_launch_counts()
    kinds = [getattr(Oid, k) for k in cw.KIND_NAMES]
    cold_schema = ReplicatedTableSchema.with_all_columns(TableSchema(
        cw.BASE_TID, TableName("public", "cold_0"),
        (ColumnSchema("id", Oid.INT8, nullable=False,
                      primary_key_ordinal=1),)
        + tuple(ColumnSchema(f"c{i}", o) for i, o in enumerate(kinds))))
    out: dict = {"cost_model": {
        "fixed_ms": model.fixed_s * 1e3,
        "round_trip_bytes_per_s": model.bytes_per_s,
        "host_col_rows_per_s": model.host_col_rows_per_s,
        "host_fixed_ms": model.host_fixed_s * 1e3},
        "route_ms": routes, "device_min_rows": {}}
    for name, schema in (("pgbench_accounts", bench.make_schema()),
                         ("coldstart", cold_schema)):
        dec = DeviceDecoder(schema, device=device)
        specs = dec._host_specs()
        bpr = sum(w for _, _, w, _ in specs) + len(specs) \
            + layout_for_specs(specs).n_words * 4
        print(f"  20(a) {name}: dense={len(dec._dense)} bytes/row={bpr} "
              f"device_min_rows={dec.device_min_rows} host_min_rows="
              f"{dec.host_min_rows}", flush=True)
        check((dec.host_min_rows or 0) <= dec.device_min_rows,
              f"20(a) {name}: host route above the device route")
        out["device_min_rows"][name] = dec.device_min_rows
    print(f"  20(a) phase 4: {main_counts['device_routed_batches']} "
          f"batches of {bench.N_ROWS} rows, k1={main_counts['k1_launches']}"
          f", host={main_counts['host_routed_batches']} oracle="
          f"{main_counts['oracle_routed_batches']}", flush=True)
    for phase, res in runtime.items():
        if "routed_batches" in res:
            print(f"  20(a) routes of {phase}: device="
                  f"{res['device_routed_batches']} host="
                  f"{res['host_routed_batches']} oracle="
                  f"{res['oracle_routed_batches']} of "
                  f"{res['routed_batches']} (k1={res['k1_launches']} "
                  f"k2c={res['k2c_launches']})", flush=True)

    rc, stdout, stderr = coldstart.result(timeout=900)
    try:
        cs = json.loads(stdout.strip().splitlines()[-1])
    except (ValueError, IndexError):
        cs = {}
    check(rc == 0 and cs.get("ok"),
          f"20(b) bench --coldstart: rc={rc} {cs.get('failures')} "
          f"{stderr[-1500:]}")
    worker_k1 = 0
    for name in ("cold", "warm"):
        r = cs[name]
        print(f"  20(b) {name} ({card}): nvcc_s={r['nvcc_seconds']!r} "
              f"builds={r['programs_compiled']:g} disk_hits="
              f"{r['cache_hits_disk']:g} oracle_rows={r['oracle_rows']:g} "
              f"start_s={r['start_seconds']!r} first_durable_s="
              f"{r['first_durable_seconds']!r} total_s="
              f"{r['total_seconds']!r} rows={r['rows_delivered']}/"
              f"{r['rows_written']} k1={r['k1_launches']} device_batches="
              f"{r['device_batches']} host_batches={r['host_batches']} "
              f"layouts={r['layouts_by_route']}", flush=True)
        check(r["k1_launches"] == r["device_batches"]
              and r["rows_delivered"] == r["rows_written"],
              f"20(b) {name}: {r}")
        worker_k1 += r["k1_launches"]
    check(cs["warm"]["programs_compiled"] == 0,
          "20(b) the warm restart built a library")
    out["coldstart"] = {name: {k: cs[name][k] for k in (
        "nvcc_seconds", "programs_compiled", "cache_hits_disk",
        "oracle_rows", "start_seconds", "first_durable_seconds",
        "total_seconds", "k1_launches", "device_batches", "host_batches",
        "rows_delivered")} for name in ("cold", "warm")}
    out["wall_s"] = time.perf_counter() - t0
    out.update(_launch_counts())
    out["k1_launches"] += worker_k1
    print(f"  phase 20 in {out['wall_s']:.1f} s; launches (workers "
          f"included): k1={out['k1_launches']}", flush=True)
    return {"20_program_store": out}


#: phase 21's row buckets: the IR tier's default and pgbench's main-path
#: batch
LINT_ROW_BUCKETS = (4096, 262_144)


def _lint_probes(runner, catalog) -> dict:
    """21(c): two deliberate violations built here, not in the package.
    (i) a K1 launch wrapper that reads `.item()` of its output between the
    launch and its return must raise `ir-host-callback`; (ii) a render
    whose text is handed back one row larger than its plan must raise
    `ir-egress-output-budget` (on the widest render plan of the catalog,
    whose row of text and lengths outweighs the budget's 64 B of
    slack)."""
    import torch

    k1 = next(d for d in catalog if d.variant == "device"
              and d.tag.startswith("i32x3"))

    def item_between(launch):
        def probe():
            out = launch()
            out.view(torch.int32)[0, 0].item()  # the violation
            return out
        return probe

    eg = max((d for d in catalog if d.variant == "egress-tsv"),
             key=lambda d: len(d.specs))

    def one_row_more(launch):
        def probe():
            ebytes, elens = launch()
            big = torch.empty((ebytes.shape[0] + 1, ebytes.shape[1]),
                              dtype=ebytes.dtype, device=ebytes.device)
            big[:-1].copy_(ebytes)  # a device copy: no host sync
            return big, elens
        return probe

    out = {}
    for name, desc, wrap, rule in (
            ("item", k1, item_between, "ir-host-callback"),
            ("one_row_more", eg, one_row_more, "ir-egress-output-budget")):
        got, _ = runner.analyze_descriptor(desc, "cuda", wrap=wrap)
        rules = sorted({f.rule for f in got})
        print(f"  21(c) {name} on {desc.path} [{desc.scope}]: "
              + "; ".join(f.fingerprint for f in got), flush=True)
        check(rule in rules, f"21(c) the {name} probe did not raise {rule}:"
              f" {rules}")
        out[name] = [f.fingerprint for f in got]
    return out


def lint_phase(staged0, schema) -> dict:
    """Phase 21: etl-lint over the port (module docstring, 21). (a) The
    AST, interprocedural and concurrency tiers over etl_tpu_torch/ in this
    process, and `--check-baseline` in a process beside it. (b) The IR
    tier on the card at LINT_ROW_BUCKETS, after one main-path batch
    decoded with a program store configured, so that the observed
    signature of the main path joins the catalogue; the launch counts are
    set to 0 just before the tier and read just after. (c) The two
    deliberate violations (`_lint_probes`)."""
    import subprocess
    import tempfile

    from etl_tpu_torch import bench
    from etl_tpu_torch.analysis import baseline as baseline_mod
    from etl_tpu_torch.analysis.ir import runner
    from etl_tpu_torch.analysis.ir.catalog import (KERNEL_OF_VARIANT,
                                                   build_catalog)
    from etl_tpu_torch.analysis.rules import analyze_paths, repo_package_dir
    from etl_tpu_torch.ops import program_store
    from etl_tpu_torch.ops.engine import DeviceDecoder

    print("[21] etl-lint over the port", flush=True)
    oracle_clear("phase 21")
    t_phase = time.perf_counter()
    card = bench.card_info()
    t0 = time.perf_counter()
    base = subprocess.Popen(
        [sys.executable, "-m", "etl_tpu_torch.analysis", "--check-baseline",
         "-q"], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        findings = analyze_paths([str(repo_package_dir())])
        ast_s = time.perf_counter() - t0
        entries = baseline_mod.load()
        violations, _ = baseline_mod.apply(findings, entries)
        print(f"  21(a) AST + interprocedural + concurrency tiers over "
              f"etl_tpu_torch/: {ast_s:.2f} s ({card}), {len(findings)} "
              f"findings, {len(entries)} baseline entries, "
              f"{len(violations)} past the baseline", flush=True)
        for f in violations:
            print(f"    {f.render()}", flush=True)
        check(not violations, "21(a) the lint finds violations past the "
              "baseline")

        # (b) the main path's signature, observed into a store of the
        # phase's own, joins the catalogue
        prev = program_store._CONFIGURED[0]
        store = tempfile.mkdtemp(prefix="chip-smoke-lint-")
        program_store.configure(store)
        # the process guard forgets the signatures earlier phases recorded
        # (plans and libraries stay), so this batch's is written again
        program_store.reset_for_tests()
        try:
            DeviceDecoder(schema, device="cuda").decode(staged0)
            observed = program_store.load_observed()
            catalog = build_catalog(row_buckets=LINT_ROW_BUCKETS)
            _reset_launch_counts()
            t1 = time.perf_counter()
            found, _, report = runner.analyze_local(
                device="cuda", row_buckets=LINT_ROW_BUCKETS)
            ir_s = time.perf_counter() - t1
            counts = _launch_counts()
        finally:
            program_store.configure(prev)
            shutil.rmtree(store, ignore_errors=True)
        check(len(observed) == 1, f"21(b) the main-path batch recorded "
              f"{len(observed)} signatures, not 1")
        print(f"  21(b) IR tier on the card ({card}), row buckets "
              f"{list(LINT_ROW_BUCKETS)}: {report['programs']} programs in "
              f"{ir_s:.2f} s (" + ", ".join(
                  f"{k} {v}" for k, v in report["variants"].items())
              + f"; {sum(d.source == 'observed' for d in catalog)} "
              f"observed); seconds by variant "
              f"{report['seconds_by_variant']}", flush=True)
        print("  21(b) findings by contract: " + " ".join(
            f"{k}={v}" for k, v in report["findings"].items())
              + f"; not checked: {report['not_checked'] or 'none'}",
              flush=True)
        for f in found:
            print(f"    {f.render()}", flush=True)
        check(not found and not report["not_checked"],
              "21(b) the IR tier has findings, or left a contract "
              "unchecked, on the card")
        want = {"k1": 0, "k2c": 0, "render": 0}
        for d in catalog:
            kernel = KERNEL_OF_VARIANT.get(d.variant)
            if kernel is not None:
                want[kernel] += 1
        print(f"  21(b) launches: K1 {counts['k1_launches']} (programs "
              f"{want['k1']}), K2c {counts['k2c_launches']} + K2 "
              f"{counts['k2_launches']} / epilogue "
              f"{counts['epilogue_launches']} (filtered programs "
              f"{want['k2c']}), render {counts['egress_launches']} "
              f"(programs {want['render']}); routes {report['routes']}; "
              f"every launch bit for bit against its plain version: "
              f"{'yes' if report['plain_held'] else 'no'}", flush=True)
        check(counts["k1_launches"] == want["k1"]
              and counts["k2c_launches"] + counts["k2_launches"]
              == want["k2c"]
              and counts["k2_launches"] == counts["epilogue_launches"]
              and counts["egress_launches"] == want["render"],
              f"21(b) the launches do not match the catalogue: {counts}, "
              f"want {want}")
        check(report["plain_held"] and not report["plain_mismatches"],
              "21(b) a launch was not held to its plain version")
        probes = _lint_probes(runner, catalog)
        base_out, base_err = base.communicate(timeout=300)
        base_s = time.perf_counter() - t0
    finally:
        if base.poll() is None:
            base.kill()
            base.wait()
    print(f"  21(a) --check-baseline (a process beside (b)): exit "
          f"{base.returncode} in {base_s:.2f} s", flush=True)
    check(base.returncode == 0, f"21(a) --check-baseline exit "
          f"{base.returncode}: {(base_out + base_err)[-600:]}")
    phase_s = time.perf_counter() - t_phase
    print(f"  21 done in {phase_s:.2f} s ({card})", flush=True)
    return {"ast_s": ast_s, "findings": len(findings),
            "baseline_entries": len(entries), "ir_s": ir_s,
            "report": report, "launches": counts, "probes": probes,
            "phase_s": phase_s}


#: phase 22: shards of the one card's mesh, and the mesh decoder's
#: batches per path (cut for time from phase 4's 6)
MESH_SHARDS = 8
MESH_BATCHES = 3


def _cuda_sync_all(devs) -> None:
    import torch

    for d in sorted(set(devs), key=str):
        torch.cuda.synchronize(d)


def _run_shards(launches, devs) -> list:
    """Each shard's prepared launch called with its shard's device
    current, as the engine calls them."""
    from etl_tpu_torch.ops import decode_kernel as dk

    out = []
    for launch, dev in zip(launches, devs):
        with dk.device_scope(dev):
            out.append(launch())
    return out


def _mesh_words_err(got, want) -> int:
    """Largest |difference| of two int32/uint32 word tensors as unsigned
    32-bit values (0 where bit for bit)."""
    import torch

    if got.shape != want.shape:
        return 1 << 32
    a = got.view(torch.int32).long() & 0xFFFFFFFF
    b = want.view(torch.int32).long() & 0xFFFFFFFF
    return int((a - b).abs().max().item()) if a.numel() else 0


def mesh_kernel_cases(mesh, schema, fschema, staged0, main_exact,
                      timed: bool) -> dict:
    """22(a): the main path's batch (pgbench, 262,144 rows, nibble) on
    `mesh`: K1, K2c (`bid <= 5`) and the render (`tsv`) launched on each
    shard's row block through the shard helpers, against the plain
    versions bit for bit — K1's words and the per-shard fallback counts
    against `parse_and_pack_plain(…, n_shards=)` on the CPU, K2c's
    survivors, joined mask and per-shard counts against the same with the
    filter, the render against `render_plain` of the whole batch's words.
    Launches are counted from 0 over the checked run. With `timed` (a
    one-card mesh), each kernel's shard launches back to back are held
    (`bench.device_ms`) against one whole-batch launch."""
    import torch

    from etl_tpu_torch.ops import decode_kernel as dk
    from etl_tpu_torch.ops import egress_kernel as ek
    from etl_tpu_torch.ops.bitpack import (join_keep_masks, layout_for_specs,
                                           parse_and_pack_plain,
                                           shard_fallback_counts)
    from etl_tpu_torch.ops.egress import plan_for_specs, render_plain
    from etl_tpu_torch.ops.engine import DeviceDecoder

    n, devs = mesh.size, list(mesh.flat)
    home = devs[0]

    def packed_of(sch):
        dec = DeviceDecoder(sch, device="cuda", mesh=None)
        packed = dec._pack_stage(staged0, main_exact)
        host = [torch.from_numpy(a).clone() for a in (
            packed.bmat, packed.lengths) + ((packed.row_flags,)
                                            if packed.pred is not None
                                            else ())]
        dec._pinned.give_back(packed.pinned)
        return packed, host

    def blocks(t):
        # a block of its own on its shard's device, as the engine uploads
        return [b.to(d, copy=True)
                for b, d in zip(dk.row_blocks(t, n), devs)]

    out = {}
    packed, host = packed_of(schema)
    specs, nibble = packed.pspecs(main_exact), packed.nibble
    layout = layout_for_specs(specs)
    R = host[0].shape[0]
    rps = R // n
    bms, lns = blocks(host[0]), blocks(host[1])
    _reset_launch_counts()
    k1 = dk.prepare_decode_pack_shards(bms, lns, specs, nibble)
    words = _run_shards(k1, devs)
    bad = [shard_fallback_counts(w, ln, layout) for w, ln in zip(words, lns)]
    plan = plan_for_specs(specs, "tsv")
    render = ek.prepare_render_shards(words, specs, plan)
    texts = _run_shards(render, devs)
    _cuda_sync_all(devs)
    counts = _launch_counts()
    want_w, want_bad = parse_and_pack_plain(host[0], host[1], specs, nibble,
                                            n_shards=n)
    joined = torch.cat([w.view(torch.int32).cpu() for w in words], dim=1)
    got_bad = torch.cat([b.cpu() for b in bad])
    k1_err = max(_mesh_words_err(joined, want_w),
                 int((got_bad - want_bad).abs().max().item()))
    check(k1_err == 0, "22(a) K1 on the mesh differs from "
          "parse_and_pack_plain(n_shards=8) on the CPU")
    check(counts["k1_launches"] == n and counts["egress_launches"] == n,
          f"22(a) K1 and the render did not launch once a shard: {counts}")
    whole_bm, whole_ln = host[0].to(home), host[1].to(home)
    whole_k1 = dk.prepare_decode_pack(whole_bm, whole_ln, specs, nibble)
    whole_words = whole_k1()
    want_t = render_plain(whole_words, specs, plan)
    r_err = max(int((torch.cat([t[i].to(home) for t in texts]).long()
                     - want_t[i].long()).abs().max().item())
                for i in range(2))
    check(r_err == 0, "22(a) the render on the mesh differs from "
          "render_plain of the whole batch")
    out["k1"] = {"launches": counts["k1_launches"], "max_abs_err": k1_err,
                 "shard_bad": got_bad.tolist()}
    out["render"] = {"launches": counts["egress_launches"],
                     "max_abs_err": r_err}

    fpacked, fhost = packed_of(fschema)
    fb, fl, ff = blocks(fhost[0]), blocks(fhost[1]), blocks(fhost[2])
    _reset_launch_counts()
    k2c = dk.prepare_filtered_shards(fb, fl, ff, main_exact, fpacked.nibble,
                                     fpacked.pred)
    fouts = _run_shards(k2c, devs)
    _cuda_sync_all(devs)
    fcounts = _launch_counts()
    w_c, mask, shard_counts, _ = parse_and_pack_plain(
        fhost[0], fhost[1], main_exact, fpacked.nibble, pred=fpacked.pred,
        row_flags=fhost[2], n_shards=n)
    got_counts = torch.cat([o[2].cpu() for o in fouts])
    errs = [int((got_counts - shard_counts).abs().max().item()),
            _mesh_words_err(join_keep_masks([o[1].cpu() for o in fouts],
                                            rps), mask)]
    for s, o in enumerate(fouts):
        c = int(shard_counts[s])
        errs.append(_mesh_words_err(o[0][:, :c].cpu(),
                                    w_c[:, s * rps:s * rps + c]))
    k2c_err = max(errs)
    check(k2c_err == 0, "22(a) K2c on the mesh differs from "
          "parse_and_pack_plain(pred=…, n_shards=8): words, joined mask or "
          "counts")
    check(fcounts["k2c_launches"] == n and fcounts["k2_launches"] == 0,
          f"22(a) K2c did not launch once a shard: {fcounts}")
    out["k2c"] = {"launches": fcounts["k2c_launches"],
                  "max_abs_err": k2c_err,
                  "counts": got_counts.tolist()}
    print(f"  22(a) {n} shards on {sorted({str(d) for d in devs})}, "
          f"{R} rows ({rps} a shard): K1 {counts['k1_launches']}, render "
          f"{counts['egress_launches']}, K2c {fcounts['k2c_launches']} "
          f"launches, each bit for bit (K1 words + shard_bad "
          f"{got_bad.tolist()}; K2c counts {got_counts.tolist()}, joined "
          f"mask; render text and lengths)", flush=True)
    if timed:
        scratch = torch.empty(64 << 20, dtype=torch.uint8, device=home)
        whole_k2c = dk.prepare_filtered(*(t.to(home) for t in fhost),
                                        main_exact, fpacked.nibble,
                                        fpacked.pred)
        whole_render = ek.prepare_render(whole_words, specs, plan)
        for name, shards, whole in (("k1", k1, whole_k1),
                                    ("k2c", k2c, whole_k2c),
                                    ("render", render, whole_render)):
            mesh_ms = time_ms(lambda: _run_shards(shards, devs), 50,
                              flush=scratch.zero_)
            whole_ms = time_ms(whole, 50, flush=scratch.zero_)
            out[name].update(mesh_ms=mesh_ms, whole_ms=whole_ms)
            print(f"  22(a) {name}: {n} shard launches back to back held "
                  f"{mesh_ms:.5f} ms against one whole-batch launch "
                  f"{whole_ms:.5f} ms (ratio {mesh_ms / whole_ms:.3f})",
                  flush=True)
    return out


def mesh_decoder_runs(mesh, schema, fschema, stage, staged0, main) -> dict:
    """22(b): `DeviceDecoder(mesh=mesh, mesh_min_rows=0)` over phase 4's
    payloads, MESH_BATCHES batches with two in flight, then phase 5's
    `bid <= 5`: every batch equal to the single-card decoder's (phase 4's
    and 5's digests, the first batch by value, `source_rows` = the
    payloads' truth), K1 (K2c) launched once a shard a batch, counts set
    to 0 just before each run and read just after."""
    import numpy as np

    from etl_tpu_torch import bench
    from etl_tpu_torch.ops.engine import DeviceDecoder

    n = mesh.size
    out = {}
    for name, sch, kernel in (("unfiltered", schema, "k1"),
                              ("filtered", fschema, "k2c")):
        dec = DeviceDecoder(sch, device="cuda", mesh=mesh, mesh_min_rows=0)
        dec.decode(staged0)  # descriptors, pinned buffers
        _reset_launch_counts()
        done: list = []
        wall = bench.decode_stream(dec, stage, MESH_BATCHES, done.append)
        counts = _launch_counts()
        batches = [p.result() for p in done]
        check(counts[f"{kernel}_launches"] == n * MESH_BATCHES
              == counts["device_routed_batches"]
              and counts["k2_launches"] == 0,
              f"22(b) {name}: the mesh decoder's launches are not "
              f"{n} a batch: {counts}")
        if kernel == "k1":
            check(bench.batches_equal(batches[0], main["first"])
                  and all(bench.batch_digest(b) == main["digest"]
                          for b in batches),
                  "22(b) a mesh batch differs from the single-card "
                  "decoder's")
        else:
            check(bench.filtered_batches_identical(batches[0],
                                                   main["ffirst"])
                  and all(bench.batch_digest(b) == main["fdigest"]
                          and np.array_equal(b.source_rows, main["truth"])
                          for b in batches),
                  "22(b) a filtered mesh batch (or its source_rows) "
                  "differs from the single-card decoder's")
        rps = MESH_BATCHES * bench.N_ROWS / wall
        split = {k: float(np.mean([p.timings[k] for p in done]))
                 for k in done[0].timings if k.endswith("_ms")}
        print(f"  22(b) {name}: {MESH_BATCHES} batches of {bench.N_ROWS} "
              f"rows on {n} shards, {counts[f'{kernel}_launches']} "
              f"{kernel.upper()} launches, each batch == the single-card "
              f"decoder's; records/s={rps:.0f} per-batch ms (sums over "
              f"the shards): " + " ".join(f"{k}={v:.4f}"
                                          for k, v in split.items()),
              flush=True)
        out[name] = {"launches": counts[f"{kernel}_launches"],
                     "records_per_s": rps, "split_ms": split,
                     "counts": counts}
    return out


def mesh_phase(stage, staged0, schema, fschema, main_exact,
               main: dict) -> dict:
    """Phase 22: the row-sharded decode mesh (module docstring, 22)."""
    import subprocess
    import tempfile

    import torch

    from etl_tpu_torch import bench
    from etl_tpu_torch.parallel.mesh import decode_mesh

    print("[22] the row-sharded decode mesh", flush=True)
    oracle_clear("phase 22")
    t_phase = time.perf_counter()
    card = bench.card_info()
    home = torch.device("cuda", 0)
    mesh = decode_mesh([home] * MESH_SHARDS)
    out = {"22a": mesh_kernel_cases(mesh, schema, fschema, staged0,
                                    main_exact, timed=True)}
    out["22b"] = mesh_decoder_runs(mesh, schema, fschema, stage, staged0,
                                   main)
    # (c) and (d), two processes on the card at once
    clean = tempfile.NamedTemporaryFile("w", suffix=".py", delete=False)
    clean.write("x = 1\n")
    clean.close()
    procs = {
        "c": subprocess.Popen(
            [sys.executable, "-m", "etl_tpu_torch.bench", "--mesh-check",
             "--device", "cuda"], cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True),
        "d": subprocess.Popen(
            [sys.executable, "-m", "etl_tpu_torch.analysis", "--programs",
             "--mesh", "--device", "cuda", "--row-buckets", "4096",
             "--json", clean.name], cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)}
    t0 = time.perf_counter()
    try:
        res = {k: p.communicate(timeout=300) for k, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        os.unlink(clean.name)
    sub_s = time.perf_counter() - t0
    try:
        mc = json.loads(res["c"][0].strip().splitlines()[-1])
    except (ValueError, IndexError):
        mc = {}
    print(f"  22(c) bench --mesh-check on the card: rc="
          f"{procs['c'].returncode} ok={mc.get('ok')} shards="
          f"{mc.get('mesh_shards')} rows={mc.get('rows')} equal="
          f"{mc.get('sharded_equals_single')} filtered equal="
          f"{mc.get('filtered_sharded_equals_single')} launches a batch "
          f"K1={mc.get('k1_launches_per_batch')} filtered="
          f"{mc.get('filtered_launches_per_batch')}; decode s single="
          f"{mc.get('single_decode_s')} sharded={mc.get('sharded_decode_s')}"
          f" filtered single={mc.get('filtered_single_decode_s')} sharded="
          f"{mc.get('filtered_sharded_decode_s')}", flush=True)
    check(procs["c"].returncode == 0 and mc.get("ok") is True
          and mc.get("mesh_shards") == MESH_SHARDS,
          f"22(c) bench --mesh-check failed: {res['c'][1][-600:]}")
    try:
        ir = json.loads(res["d"][0])["programs"]
    except (ValueError, KeyError):
        ir = {}
    mesh_variants = {k: v for k, v in ir.get("variants", {}).items()
                     if k.startswith("mesh")}
    print(f"  22(d) --programs --mesh on the card: rc="
          f"{procs['d'].returncode}, {ir.get('programs')} programs (mesh "
          f"variants {mesh_variants}) on {ir.get('mesh_shards')} shards, "
          f"findings {ir.get('findings')}, launches {ir.get('launches')}, "
          f"not checked: {ir.get('not_checked') or 'none'}; (c) and (d) "
          f"together {sub_s:.2f} s", flush=True)
    check(procs["d"].returncode == 0 and ir.get("mesh_shards") == MESH_SHARDS
          and set(mesh_variants) == {"mesh", "mesh-filtered",
                                     "mesh-egress-tsv", "mesh-egress-json"}
          and not any(ir.get("findings", {"": 1}).values())
          and not ir.get("not_checked") and ir.get("plain_held") is True,
          f"22(d) --programs --mesh failed on the card: "
          f"{res['d'][1][-600:]}")
    out["22c"] = mc
    out["22d"] = {k: ir.get(k) for k in ("programs", "variants", "findings",
                                         "launches", "program_launches",
                                         "seconds")}
    count = torch.cuda.device_count()
    if count >= 2:
        cards = decode_mesh()
        out["22e"] = {
            "a": mesh_kernel_cases(cards, schema, fschema, staged0,
                                   main_exact, timed=False),
            "b": mesh_decoder_runs(cards, schema, fschema, stage, staged0,
                                   main)}
        print(f"  22(e) (a) and (b) across {count} cards: passed",
              flush=True)
    else:
        print(f"  22(e) {count} card: a mesh across cards was not run",
              flush=True)
    phase_s = time.perf_counter() - t_phase
    print(f"  22 done in {phase_s:.2f} s ({card})", flush=True)
    a, b = out["22a"], out["22b"]
    # every kernel's launches in (b)'s two runs, as counted there
    out["runtime"] = {
        key: b["unfiltered"]["counts"][key] + b["filtered"]["counts"][key]
        for key in ("k1_launches", "k2_launches", "epilogue_launches",
                    "k2c_launches", "egress_launches")}
    out["runtime"]["rows_per_second"] = b["unfiltered"]["records_per_s"]
    out["kernels"] = {name: {"shards": MESH_SHARDS, **a[name]}
                      for name in ("k1", "k2c", "render")}
    out["phase_s"] = phase_s
    return out


#: 23(d): the example config's stream (cut to the binary's 11(c) scale)
EXAMPLE_COPY_ROWS = 100_000
EXAMPLE_EVENTS = 50_000
SANITIZE_SECONDS = 1.5


def _example_run(name: str, fn, device: str) -> dict:
    """One example pipeline in this process, every batch through K1
    (`device_floor(1)`: the examples' tables are 50 and 100 rows and their
    CDC a transaction of three changes, below any measured threshold),
    launch counts set to 0 just before and read just after."""
    from etl_tpu_torch.chaos.runner import device_floor

    oracle_clear(f"phase 23, {name}")
    t0 = time.perf_counter()
    _reset_launch_counts()
    with device_floor(1):
        r = fn()
    counts = _launch_counts()
    counts["wall_s"] = time.perf_counter() - t0
    print(f"  launches: k1={counts['k1_launches']} routes "
          f"{counts['device_routed_batches']}/"
          f"{counts['host_routed_batches']}/"
          f"{counts['oracle_routed_batches']} (device/host/oracle); "
          f"{counts['wall_s']:.1f} s", flush=True)
    check(counts["device_routed_batches"] == counts["routed_batches"] > 0
          and counts["k1_launches"] == (counts["device_routed_batches"]
                                        if device == "cuda" else 0),
          f"23: {name}: K1 launches differ from the routed batches: "
          f"{counts}")
    return {**r, **counts}


def examples_phase(device: str = "cuda") -> dict:
    """Phase 23: the port's examples on the card. (a) `python -m
    etl_tpu_torch.examples.lake_pipeline` and (b) `…iceberg_pipeline`
    (their `main()`, in this process): the printed read-back (the lake's
    current view; Iceberg's snapshots and live rows after the CDC
    collapse) as the examples assert it; (c) `…control_plane --port P` as
    a process: `GET /openapi.json` 200 with the bearer key, a `/v1` route
    200 with it and 401 without, SIGTERM exit 0; (d) `python -m
    etl_tpu_torch.replicator --config-dir` on `examples/config/base.yaml`
    (`batch_engine: cuda`), rewritten to a `PgServerProcess` and a
    temporary lake and store: `/health` 200, the example's stream
    delivered to the lake, K1 work on the child's `/metrics`, SIGTERM
    exit 0; (e) `python -m etl_tpu_torch.testing.sanitize_framer
    --seconds 1.5` (the port's framer under ASan and UBSan), started as
    a process at the phase's start: exit code 0, or its skip code 77
    where this host has no ASan runtime (then it did not run). Returns
    (a) and (b) with their launch counts."""
    import asyncio
    import tempfile

    from etl_tpu_torch import bench
    from etl_tpu_torch.examples import iceberg_pipeline, lake_pipeline

    print("[23] the port's examples on the card", flush=True)
    t0 = time.perf_counter()
    sanitizer = _Background([sys.executable, "-m",
                             "etl_tpu_torch.testing.sanitize_framer",
                             "--seconds", str(SANITIZE_SECONDS)])
    out = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            print("  23(a) python -m etl_tpu_torch.examples.lake_pipeline",
                  flush=True)
            r = _example_run("the lake example", lambda: lake_pipeline.main(
                ["--device", device, "--warehouse", f"{tmp}/lake"]), device)
            ids = [row["id"] for row in r["current"]]
            row1 = r["current"][0]
            check(ids == [1] + list(range(3, 102))
                  and str(row1["balance"]) == "1000.00"
                  and r["lines"][1:] == [
                      "lake current rows: 100 (copied 100, +1 insert, "
                      "-1 delete)", "updated row 1 balance: 1000.00"],
                  f"23(a): the lake example read back {r['lines']}")
            out["23a_lake_example"] = r
            print("  23(b) python -m etl_tpu_torch.examples."
                  "iceberg_pipeline", flush=True)
            r = _example_run(
                "the Iceberg example", lambda: iceberg_pipeline.main(
                    ["--device", device, "--warehouse", f"{tmp}/iceberg"]),
                device)
            check(r["snapshots"] >= 2 and sorted(r["live"]) == [1] + list(
                range(3, 52)) and r["live"][1]["qty"] == 99
                and r["lines"][-1] == "ok",
                f"23(b): the Iceberg example read back {r['lines']}")
            out["23b_iceberg_example"] = r
        print("  23(c) python -m etl_tpu_torch.examples.control_plane "
              "--port P", flush=True)
        c = asyncio.run(bench.run_example_control_plane())
        print(f"  up after {c['up_s']:.2f} s; /openapi.json {c['openapi']} "
              f"(status, version, paths); /v1/tenants with the key "
              f"{c['tenants_with_key']}, without {c['tenants_without_key']}"
              f"; SIGTERM exit code {c['exit_code']}", flush=True)
        check(c["ok"], f"23(c): the control plane example: {c}")
        print(f"  23(d) python -m etl_tpu_torch.replicator --config-dir on "
              f"the example config: COPY {EXAMPLE_COPY_ROWS} rows, CDC "
              f"{EXAMPLE_EVENTS} events into its lake", flush=True)
        d = asyncio.run(bench.run_example_replicator(
            EXAMPLE_COPY_ROWS, EXAMPLE_EVENTS, device=device))
        print(f"  batch_engine={d['batch_engine']} rewritten "
              f"{d['rewritten']}; /health {json.dumps(d['health'])} after "
              f"{d['health_s']:.2f} s, READY after {d['ready_s']:.2f} s, "
              f"confirmed after {d['confirmed_s']:.2f} s; /metrics device "
              f"rows {d['device_rows']:.0f} kernel_s {d['kernel_s']:.4f}; "
              f"lake rows {d['lake_rows']} (digest {d['rows_ok']}); SIGTERM "
              f"exit code {d['exit_code']}", flush=True)
        if d["exit_code"] != 0:
            print(d.get("stderr_tail", ""), file=sys.stderr, flush=True)
        check(d["ok"], "23(d): the replicator on the example config: a "
              "check failed")
        rc, so, se = sanitizer.result(300)
    finally:
        sanitizer.stop()
    from etl_tpu_torch.testing.sanitize_framer import SKIP

    if rc == SKIP:  # the documented skip, never counted as a pass
        print(f"  23(e) sanitize_framer: exit code {rc}: this host has no "
              f"ASan runtime, the sanitizer did not run: "
              f"{se.strip()[-200:]}", flush=True)
    else:
        print(f"  23(e) sanitize_framer: exit code {rc}: "
              f"{(so.strip().splitlines() or [''])[-1]}", flush=True)
        check(rc == 0, f"23(e): the framer under ASan/UBSan: exit code "
              f"{rc}: {so[-1500:]} {se[-1500:]}")
    out["23e_sanitizer_rc"] = rc
    wall = time.perf_counter() - t0
    print(f"  phase 23 in {wall:.1f} s", flush=True)
    out["23_wall_s"] = wall
    return out


def _warehouse_lines(r: dict) -> None:
    run = r["run"]
    print(f"  warehouse: watched {r['watched_rows']} rows, bad "
          f"{r['watched_bad']}; sequence numbers by arrivals "
          f"{json.dumps(r['seq_arrivals'])}; ddl {json.dumps(r['ddl'])}; "
          f"commit seam {json.dumps(r['commit_log'])}; dedup_inserts="
          f"{r['dedup_inserts']}; fake requests={r['fake_requests']} "
          f"bytes={r['fake_body_bytes']}; egress writes device="
          f"{run['device_writes']} host={run['host_writes']}; egress_s="
          f"{r['egress_s']:.4f} d2h_egress_s={r['d2h_egress_s']:.4f}",
          flush=True)


def _warehouse_checks(r: dict, phase: str) -> None:
    check(r["watched_ok"], f"{phase}: a watched row's delivered text "
          f"differs from the host encoder's, or arrived not once: "
          f"{r['watched_bad']}")
    check(r["seq_once_ok"], f"{phase}: a sequence number arrived more than "
          f"once: {r['seq_arrivals']}")
    check(r["seam_ok"], f"{phase}: the commit seam's records are missing "
          f"or short of the last commit: {r['commit_log']}")
    check(r["warehouse_ok"], f"{phase}: a warehouse check failed")


def _wire_lines(r: dict, copy_ref, cdc_ref, copy_name, cdc_name) -> None:
    from etl_tpu_torch import bench

    print(f"  health: {json.dumps(r['health'])}", flush=True)
    if copy_ref is not None:
        cs = r["copy_stages"]
        print(f"  copy rows/s={r['rows_per_second']:.0f} MiB/s="
              f"{r['mib_per_second']:.2f} ({copy_name}: "
              f"{copy_ref['rows_per_second']:.0f} / "
              f"{copy_ref['mib_per_second']:.2f}) copy_wait_ms="
              f"{r['copy_wait_ms']:.1f} pipeline_start_ms="
              f"{r['pipeline_start_ms']:.1f} device_busy_share="
              f"{cs['device_busy_share']:.5f} ({copy_name}: "
              f"{copy_ref['device_busy_share']:.5f}) k1={cs['k1_launches']} "
              f"device_batches={cs['device_batches']} oracle_rows="
              f"{cs['oracle_rows']:.0f}", flush=True)
    print(f"  events/s={r['events_per_second']:.0f} ({cdc_name}: "
          f"{cdc_ref['events_per_second']:.0f}) producer_events/s="
          f"{r['producer_events_per_second']:.0f} lag_p50_ms="
          f"{r['lag_p50_ms']:.2f} lag_p95_ms={r['lag_p95_ms']:.2f} "
          f"({cdc_name}: {cdc_ref['lag_p50_ms']:.2f} / "
          f"{cdc_ref['lag_p95_ms']:.2f}) device_busy_share="
          f"{r['device_busy_share']:.5f} ({cdc_name}: "
          f"{cdc_ref['device_busy_share']:.5f}) delivered="
          f"{r['delivered_rows']} keep_share={r['keep_share']:.4f}",
          flush=True)
    print(f"  {_stage_line(r)}", flush=True)
    print(f"  launches: k1={r['k1_launches']} k2c={r['k2c_launches']} "
          f"k2={r['k2_launches']} epilogue={r['epilogue_launches']}; run: "
          f"{json.dumps(r['run'])}; CDC window device_rows="
          f"{r['device_rows']} oracle_rows={r['oracle_rows']} (below the "
          f"size floor: {r['small_oracle_rows']}; at most "
          f"{bench.WIRE_CDC_ORACLE_SHARE_MAX:.0%} of the window)",
          flush=True)
    print(f"  /metrics decode counters: {r['metrics_ok']}; after SIGTERM: "
          f"{json.dumps(r['after_shutdown'])}", flush=True)


def _wire_checks(r: dict, phase: str) -> None:
    from etl_tpu_torch import bench

    check(r["health_ok"], f"{phase}: /health did not go 503 starting -> "
          "200 healthy")
    check(r["copy_count_ok"] and r["copy_digest_ok"]
          and r.get("copy_oracle_sample_ok", True) and r["copy_oracle_free"],
          f"{phase}: copied rows differ from the written rows, or a copy "
          "chunk took the oracle route")
    check(r["count_ok"] and r["digest_ok"], f"{phase}: streamed rows "
          "differ from the produced rows (count or digest)")
    check(r["order_ok"] and r["identity_ok"], f"{phase}: streamed rows not "
          "once each in (commit LSN, ordinal) order with their rows")
    check(r["oracle_sample_ok"], f"{phase}: a sampled row differs from "
          "the CPU oracle")
    check(r["launches_ok"], f"{phase}: the launches (K1, K2c, the render "
          "for a warehouse) differ from the device-routed batches, or no "
          "warehouse write used the card's text")
    check(r["cdc_oracle_ok"], f"{phase}: the CDC window routed rows to the "
          "oracle other than runs below the size floor, or more than "
          f"{bench.WIRE_CDC_ORACLE_SHARE_MAX:.0%} of its rows")
    check(r["metrics_ok"], f"{phase}: /metrics lacks the decode counters")
    check(r["shutdown_ok"], f"{phase}: a decode thread, an admission "
          "ticket or a tenant outlived SIGTERM")
    check(r["ok"], f"{phase}: a check failed")


def main() -> int:
    ap = argparse.ArgumentParser(prog="chip_smoke.py")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--batches", type=int, default=6)
    ap.add_argument("--copy-rows", type=int, default=1_000_000)
    ap.add_argument("--cdc-events", type=int, default=500_000)
    ap.add_argument("--shard-copy-rows", type=int, default=1_000_000)
    ap.add_argument("--shard-events", type=int, default=400_000)
    args = ap.parse_args()
    t_start = time.perf_counter()

    import torch

    # -- 1. device -----------------------------------------------------------
    print("[1] device", flush=True)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
    import numpy as np

    from etl_tpu_torch import bench, convert
    from etl_tpu_torch.models.pgtypes import CellKind as K
    from etl_tpu_torch.ops import decode_kernel, egress_kernel, program_store
    from etl_tpu_torch.ops.bitpack import saturation_width
    from etl_tpu_torch.ops.engine import DeviceDecoder
    from etl_tpu_torch.ops.predicate import (compile_row_filter,
                                             parse_row_filter)
    from etl_tpu_torch.ops.wal import concat_payloads, stage_wal_batch

    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = bench.card_info()
    print(f"  name={kind} count={count} torch={torch.__version__} "
          f"cuda={torch.version.cuda}", flush=True)
    print(f"  nvidia-smi: {smi}", flush=True)

    # -- 2. build ------------------------------------------------------------
    print("[2] build", flush=True)
    # the default store starts empty: phase 2 pays the cold start's nvcc
    shutil.rmtree(program_store.DEFAULT_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:  # one nvcc a source, together
        for f in [pool.submit(lib.load) for lib in (decode_kernel,
                                                     egress_kernel)]:
            f.result()
    print(f"  both built in {time.perf_counter() - t0:.2f} s", flush=True)
    for lib in (decode_kernel, egress_kernel):
        print(f"  nvcc build of {os.path.relpath(lib.SOURCE, ROOT)}: "
              f"{lib.build_seconds:.2f} s", flush=True)
        for line in lib.build_log.strip().splitlines():
            print(f"  ptxas: {line}", flush=True)

    # -- 3. kernel vs plain version ------------------------------------------
    print("[3] kernel vs plain version", flush=True)
    rows = bench.N_ROWS
    payloads = bench.build_workload(rows)
    schema = bench.make_schema()
    buf, offs, lens = concat_payloads(payloads)

    def stage():
        return stage_wal_batch(buf, offs, lens, 4)

    decoder = DeviceDecoder(schema, device="cuda")
    staged0 = stage().staged
    # the filtered main path packs the exact layout, the unfiltered one
    # its canonical layout (ops/program_store.py)
    main_exact = decoder._specs(staged0, decoder._widths(staged0))
    main_specs = program_store.canonical_plan(main_exact).specs
    print(f"  main-path layout: exact {_spec_text(main_exact)} -> "
          f"canonical {_spec_text(main_specs)}", flush=True)

    def bw(kind_, w):
        return (min(w, saturation_width(kind_)) + 1) & ~1

    raw_kinds = [(K.BOOL, 4), (K.I16, 8), (K.I32, 12), (K.U32, 12),
                 (K.I64, 20), (K.F32, 16), (K.F64, 24), (K.DATE, 16),
                 (K.TIME, 16), (K.TIMESTAMP, 32), (K.TIMESTAMPTZ, 32)]
    nib_kinds = [(K.I16, 8), (K.I32, 12), (K.U32, 12), (K.I64, 20),
                 (K.DATE, 16), (K.TIME, 16), (K.TIMESTAMP, 32),
                 (K.TIMESTAMPTZ, 32)]
    cases = [
        ("3a pgbench", main_specs, True, rows, 16_384),
        ("3b all kinds raw",
         tuple((i, k, w, bw(k, w)) for i, (k, w) in enumerate(raw_kinds)),
         False, 65_536, 4_096),
        ("3c nibble int+temporal",
         tuple((i, k, w, bw(k, w)) for i, (k, w) in enumerate(nib_kinds)),
         True, 65_536, 4_096),
    ]
    # the main-path shape (3a) is timed three times, for a spread
    records = [kernel_case(name, specs, nib, n, pool, args.seed + i,
                           runs=3 if i == 0 else 1)
               for i, (name, specs, nib, n, pool) in enumerate(cases)]

    print("[3d] fused row filter vs plain versions", flush=True)
    filter_sql = "bid <= 5"
    fschema = schema.with_row_predicate(parse_row_filter(filter_sql))

    def kind_schema(kinds):
        from etl_tpu_torch.models import (ColumnSchema, Oid,
                                          ReplicatedTableSchema, TableName,
                                          TableSchema)

        oid = {K.BOOL: Oid.BOOL, K.I16: Oid.INT2, K.I32: Oid.INT4,
               K.U32: Oid.OID, K.I64: Oid.INT8, K.DATE: Oid.DATE,
               K.TIME: Oid.TIME, K.TIMESTAMP: Oid.TIMESTAMP,
               K.TIMESTAMPTZ: Oid.TIMESTAMPTZ}
        return ReplicatedTableSchema.with_all_columns(TableSchema(
            1, TableName("public", "kinds"),
            tuple(ColumnSchema(f"c{i}", oid[k])
                  for i, (k, _) in enumerate(kinds))))

    cmp_kinds = [(K.BOOL, 4), (K.I16, 8), (K.I32, 12), (K.U32, 12),
                 (K.I64, 20), (K.DATE, 16), (K.TIME, 16), (K.TIMESTAMP, 32),
                 (K.TIMESTAMPTZ, 32)]
    raw_sql = ("((c0 = TRUE OR c1 < 100) AND (c2 >= -5000000 OR "
               "c3 > 3000000000) AND NOT (c4 = -0 OR c5 IS NULL)) OR "
               "(c6 < '12:00:00' AND c7 > '2000-01-01 00:00:00') OR "
               "c8 <= '2024-06-15 00:00:00+00' OR c3 < -1 OR "
               "(c2 > 10000000000000 AND c4 <> 1000000000000000000)")
    nib_sql = ("((c0 >= 100 AND c1 <> -2147483648) OR c2 <= 2147483648 "
               "OR c3 IS NULL) AND NOT (c4 > '2000-01-01' AND "
               "c5 >= '12:00:00.000001') AND (c6 < '2000-01-01 00:00:00' "
               "OR c7 = '2024-06-15 00:00:00+00' OR c3 > -1 OR "
               "c1 < 99999999999)")
    nib_cmp = cmp_kinds[1:]
    fcases = [
        ("3d(i) pgbench bid<=5", main_exact, True, rows, 16_384,
         compile_row_filter(fschema.row_predicate, fschema)),
        ("3d(ii) all comparable kinds raw",
         tuple((i, k, w, bw(k, w)) for i, (k, w) in enumerate(cmp_kinds)),
         False, 65_499, 4_096,
         compile_row_filter(raw_sql, kind_schema(cmp_kinds))),
        ("3d(iii) nibble int+temporal",
         tuple((i, k, w, bw(k, w)) for i, (k, w) in enumerate(nib_cmp)),
         True, 65_499, 4_096,
         compile_row_filter(nib_sql, kind_schema(nib_cmp))),
    ]
    # one filter text on two tables whose filter column sits at another
    # position, with the same dense specs: each must keep its own rows
    i32_specs = tuple((i, K.I32, 12, bw(K.I32, 12)) for i in range(3))
    for tag, names in (("a", ("aid", "bid", "abalance")),
                       ("b", ("bid", "aid", "abalance"))):
        fcases.append((
            f"3d(iv{tag}) bid<=5 on ({', '.join(names)})", i32_specs, True,
            16_411, 4_096,
            compile_row_filter(filter_sql, convert.schema_from_plain(
                1, "public", "pgbench_accounts",
                [(n, 23, -1, False, None) for n in names], [True] * 3,
                [False] * 3))))
    frecords = [filter_case(name, specs, nib, n, pool, args.seed + 10 + i,
                            pred, runs=3 if i == 0 else 1)
                for i, (name, specs, nib, n, pool, pred) in enumerate(fcases)]
    wide_specs = tuple((i, K.I32, 12, bw(K.I32, 12)) for i in range(260))
    wide_pred = compile_row_filter("c1 <= 5", kind_schema([(K.I32, 12)]
                                                          * 260))
    extra = fused_cases(main_exact, 16_384, args.seed + 30, fcases[0][5],
                        wide_pred, wide_specs)

    print("[3e] every walk at the main-path shape", flush=True)
    walks = walk_cases(main_exact, True, rows, 16_384, args.seed + 20,
                       fcases[0][5])

    # -- 4. main path --------------------------------------------------------
    print("[4] main path", flush=True)
    oracle_clear("phase 4")
    check(args.batches >= 6, "--batches must be at least 6")
    warm = decoder.decode(staged0)  # descriptor upload, pinned buffers
    check(warm.num_rows == rows, "warm-up batch has the wrong row count")
    stage_s: list = []

    def timed_stage():
        t0 = time.perf_counter()
        wal = stage()
        stage_s.append(time.perf_counter() - t0)
        return wal

    _reset_launch_counts()
    paths = dict(decode_kernel.path_launches)
    done: list = []
    wall = bench.decode_stream(decoder, timed_stage, args.batches,
                               done.append)
    c4 = _launch_counts()
    launches = c4["k1_launches"]
    print(f"  batches={args.batches} rows/batch={rows} in_flight="
          f"{bench.IN_FLIGHT} kernel launches={launches} "
          f"path={paths_taken(paths)} routes: device="
          f"{c4['device_routed_batches']} host={c4['host_routed_batches']}"
          f" oracle={c4['oracle_routed_batches']} (device_min_rows="
          f"{decoder.device_min_rows})", flush=True)
    check(launches == args.batches == c4["device_routed_batches"],
          f"the main path's {args.batches} batches did not each take K1: "
          f"{c4}")
    batches = [p.result() for p in done]
    check(all(b.num_rows == rows and len(b.columns) == 4 for b in batches),
          "decoded batches have the wrong shape")
    for c in batches[0].columns[:3]:
        check(c.is_dense and c.data.dtype == np.int32 and c.validity.all(),
              f"column {c.schema.name} is not a fully valid int32 column")
    cpu = DeviceDecoder(schema, device="cpu").decode(stage().staged)
    check(bench.batches_equal(batches[0], cpu),
          "first batch differs from the CPU decode of the same staged batch")
    digest = bench.batch_digest(batches[0])
    check(all(bench.batch_digest(b) == digest for b in batches[1:]),
          "a later batch differs from the first")
    check(bench.oracle_sample_ok(batches[0], payloads, schema, 512,
                                 seed=args.seed),
          "a sampled row differs from the CPU oracle decode_insert")
    rps = args.batches * rows / wall
    split = {"stage_ms": float(np.mean(stage_s)) * 1e3}
    split.update({k: float(np.mean([p.timings[k] for p in done]))
                  for k in done[0].timings if k.endswith("_ms")})
    # device busy share: copies + kernel over the wall time of a batch
    busy = (split["h2d_ms"] + split["kernel_ms"] + split["d2h_ms"]) \
        / (wall / args.batches * 1e3)
    print(f"  parity: first batch == CPU decode, {args.batches} digests "
          f"equal, 512 oracle rows equal", flush=True)
    print(f"  records/s={rps:.0f} wall_s={wall:.4f} device_busy_share="
          f"{busy:.4f} per-batch ms: "
          + " ".join(f"{k}={v:.4f}" for k, v in split.items()), flush=True)
    held = held_main_path_ms(decoder, staged0, main_exact, False)
    print(f"  kernel_ms={split['kernel_ms']:.5f} (engine events) against "
          f"K1 held on a main-path batch: cold_ms={held['cold_ms']:.5f} "
          f"warm_ms={held['warm_ms']:.5f}; launch_ms="
          f"{split['launch_ms']:.5f} (host)", flush=True)

    unfiltered_fetched = done[0].timings["fetched_bytes"]

    # -- 5. filtered main path -----------------------------------------------
    print(f"[5] filtered main path ({filter_sql})", flush=True)
    fdecoder = DeviceDecoder(fschema, device="cuda")
    fwarm = fdecoder.decode(staged0)  # descriptors, pinned buffers
    check(0 < fwarm.num_rows < rows, "filtered warm-up kept no or all rows")
    stage_s.clear()
    decode_kernel.launches = 0
    decode_kernel.filter_launches = 0
    decode_kernel.compact_launches = 0
    decode_kernel.fused_launches = 0
    paths = dict(decode_kernel.path_launches)
    fdone: list = []
    fwall = bench.decode_stream(fdecoder, timed_stage, args.batches,
                                fdone.append)
    f_launches = decode_kernel.filter_launches
    c_launches = decode_kernel.compact_launches
    k2c_launches = decode_kernel.fused_launches
    print(f"  batches={args.batches} rows/batch={rows} in_flight="
          f"{bench.IN_FLIGHT} launches: fused={k2c_launches} "
          f"filter={f_launches} compact={c_launches} "
          f"unfiltered={decode_kernel.launches} "
          f"path={paths_taken(paths)}", flush=True)
    check(k2c_launches == args.batches and f_launches == 0
          and c_launches == 0,
          "the filtered path did not launch K2c once a batch, and K2 and "
          "the epilogue never")
    fbatches = [p.result() for p in fdone]
    truth = np.asarray([i for i, (_, bid, _) in
                        enumerate(bench.pgbench_rows(rows)) if bid <= 5],
                       dtype=np.int64)
    fcpu = DeviceDecoder(fschema, device="cpu").decode(stage().staged)
    check(bench.filtered_batches_identical(fbatches[0], fcpu),
          "first filtered batch (or its source_rows) differs from the CPU "
          "decoder's")
    check(all(np.array_equal(b.source_rows, truth) for b in fbatches),
          "survivors differ from the payloads' rows with bid <= 5")
    fdigest = bench.batch_digest(fbatches[0])
    check(all(bench.batch_digest(b) == fdigest for b in fbatches[1:]),
          "a later filtered batch differs from the first")
    check(bench.oracle_sample_ok(fbatches[0], payloads, schema, 512,
                                 seed=args.seed),
          "a sampled filtered row differs from the CPU oracle decode_insert")
    keep = len(truth) / rows
    ratios = [p.timings["fetched_bytes"] / unfiltered_fetched for p in fdone]
    check(max(ratios) <= keep + 0.11,
          f"filtered fetch ratio {max(ratios):.4f} above keep {keep:.4f} "
          f"+ 0.11")
    frps = args.batches * rows / fwall
    fsplit = {"stage_ms": float(np.mean(stage_s)) * 1e3}
    fsplit.update({k: float(np.mean([p.timings[k] for p in fdone]))
                   for k in fdone[0].timings if k.endswith("_ms")})
    fetched = float(np.mean([p.timings["fetched_bytes"] for p in fdone]))
    fbusy = (fsplit["h2d_ms"] + fsplit["kernel_ms"] + fsplit["d2h_ms"]
             + fsplit["d2h_words_ms"]) / (fwall / args.batches * 1e3)
    print(f"  parity: first batch + source_rows == CPU decoder, survivors "
          f"== payload truth ({len(truth)} of {rows}, keep {keep:.4f}), "
          f"{args.batches} digests equal, 512 oracle rows equal; fetched "
          f"{fetched:.0f} B vs {unfiltered_fetched} B "
          f"unfiltered (ratio {max(ratios):.4f})", flush=True)
    print(f"  records/s={frps:.0f} wall_s={fwall:.4f} device_busy_share="
          f"{fbusy:.4f} per-batch ms: "
          + " ".join(f"{k}={v:.4f}" for k, v in fsplit.items()), flush=True)
    fheld = held_main_path_ms(fdecoder, staged0, main_exact, True)
    print(f"  kernel_ms={fsplit['kernel_ms']:.5f} (engine events) against "
          f"K2c held on a main-path batch: cold_ms={fheld['cold_ms']:.5f} "
          f"warm_ms={fheld['warm_ms']:.5f}; launch_ms="
          f"{fsplit['launch_ms']:.5f} (host)", flush=True)

    oracle_clear("phases 6-9")
    runtime = runtime_phases(args)
    eph = egress_phase(args, main_specs, runtime["7_cdc"])
    runtime["9_cdc_tsv"] = eph["cdc_tsv"]
    runtime.update(default_config_phase(args, runtime["7_cdc"]))
    runtime.update(wire_phase(args, runtime))
    runtime.update(warehouse_phase(args, runtime))
    runtime.update(sharded_phase(args, runtime))
    coldstart = start_coldstart()
    try:
        runtime.update(chaos_phase(args))
        runtime.update(exactly_once_phase(args))
        runtime.update(harness_phase(args, runtime))
        runtime.update(autoscale_api_phase(args, runtime))
        runtime.update(fleet_phase(args, runtime))
        runtime.update(lake_phase(args))
        runtime.update(program_store_phase(args, runtime, c4, coldstart))
    finally:
        coldstart.stop()
    lint_phase(staged0, schema)
    mesh = mesh_phase(stage, staged0, schema, fschema, main_exact,
                      {"first": batches[0], "digest": digest,
                       "ffirst": fbatches[0], "fdigest": fdigest,
                       "truth": truth})
    runtime["22_mesh"] = mesh["runtime"]
    ex = examples_phase()
    runtime["23a_lake_example"] = ex["23a_lake_example"]
    runtime["23b_iceberg_example"] = ex["23b_iceberg_example"]

    main_rec = records[0]
    k2_recs = [r for recs in frecords for r in recs
               if r["kernel"] == "decode_pack_filtered"]
    epi_recs = [r for recs in frecords for r in recs
                if r["kernel"] == "compact_packed"]
    k2c_recs = [r for recs in frecords for r in recs
                if r["kernel"] == "filter_pack_compact"]
    filtered_main = {"records_per_s": frps, "batches": args.batches,
                     "rows_per_batch": rows, "row_filter": filter_sql,
                     "keep": keep, "split_ms": fsplit,
                     "fetched_bytes": fetched,
                     "unfiltered_fetched_bytes": unfiltered_fetched,
                     "fetched_ratio": max(ratios),
                     "device_busy_share": fbusy,
                     "kernel_held_ms": fheld}

    def record(name, replaces, n_launches, recs, main):
        main_case = recs[0]
        return {
            "name": name, "route": "cuda",
            "source": "etl_tpu_torch/csrc/decode_pack.cu",
            "replaces": replaces, "launches": n_launches,
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"],
            "launch_floor_ms": main_case["launch_floor_ms"],
            "ms_runs": main_case["ms_runs"],
            "cases": recs, "main_path": main}

    kernels = [
        record("decode_pack", "etl_tpu/ops/pallas_kernel.py:114", launches,
               records,
               {"records_per_s": rps, "batches": args.batches,
                "rows_per_batch": rows, "split_ms": split,
                "device_busy_share": busy, "kernel_held_ms": held}),
        record("decode_pack_filtered", "etl_tpu/ops/pallas_kernel.py:118",
               f_launches, k2_recs, filtered_main),
        record("compact_packed", "etl_tpu/ops/bitpack.py:212", c_launches,
               epi_recs, filtered_main),
        record("filter_pack_compact",
               "etl_tpu/ops/pallas_kernel.py:118 + etl_tpu/ops/bitpack.py:212",
               k2c_launches, k2c_recs, filtered_main),
    ]
    for k, name in zip(kernels, ("k1", "k2", "epilogue", "k2c")):
        k["runtime_launches"] = {
            phase: res[f"{name}_launches"] for phase, res in runtime.items()}
        # the runtime phases this kernel ran in, and what they measured
        k["runtime"] = {phase: {key: res[key] for key in (
            "rows_per_second", "events_per_second", "lag_p50_ms",
            "lag_p95_ms", "device_busy_share") if key in res}
            for phase, res in runtime.items()
            if k["runtime_launches"][phase]}
    # phase 22: each kernel on the 8 row blocks of the one card's mesh
    for k, name in ((kernels[0], "k1"), (kernels[3], "k2c")):
        k["mesh"] = mesh["kernels"][name]
    kernels[3]["fused_cases"] = extra
    kernels[3]["max_abs_err"] = max(
        [kernels[3]["max_abs_err"]] + [r["max_abs_err"] for r in extra])
    for k in kernels[:2] + kernels[3:]:
        k["walks"] = walks
    kernels[1]["library_ms_note"] = (
        "null: no PyTorch call parses, filters and packs the fields")
    kernels[3]["library_ms_note"] = (
        "words[:, keep] after the plain K2, as the epilogue's")
    ecase = eph["cases"][0]
    cdc_tsv = eph["cdc_tsv"]
    kernels.append({
        "name": "egress_render", "route": "cuda",
        "source": "etl_tpu_torch/csrc/egress_render.cu",
        "replaces": "etl_tpu/ops/egress.py:340",
        "launches": cdc_tsv["egress_launches"],
        "runtime_launches": {phase: res["egress_launches"]
                             for phase, res in runtime.items()},
        "runtime": {phase: {key: res[key] for key in (
            "rows_per_second", "events_per_second", "lag_p50_ms",
            "lag_p95_ms", "device_busy_share") if key in res}
            for phase, res in runtime.items() if res["egress_launches"]},
        "max_abs_err": max(c["max_abs_err"] for c in eph["cases"]),
        "ms": ecase["ms"], "plain_ms": ecase["plain_ms"],
        "bound_ms": ecase["bound_ms"], "bound_by": ecase["bound_by"],
        "library_ms": None,
        "library_ms_note": "null: no PyTorch call renders integers or "
                           "dates as decimal text",
        "launch_floor_ms": ecase["launch_floor_ms"],
        "ms_runs": ecase["ms_runs"], "cases": eph["cases"],
        "encoders": eph["encoders"],
        "main_path": {key: cdc_tsv[key] for key in (
            "events_per_second", "lag_p50_ms", "lag_p95_ms",
            "device_busy_share", "egress_s", "d2h_egress_s", "kernel_s",
            "device_s", "k1_launches", "egress_launches", "tsv")},
        "mesh": mesh["kernels"]["render"]})
    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
