"""The floors of BENCH_FLOOR.json applied to the harness's modes, and
`run_smoke`, the port's `bench --smoke`.

BENCH_FLOOR.json is the reference's file at the root of the repo; it is
read here and never written. Each `gate_*` takes a mode's report, adds
the floor it was held to and the floor's failure, and sets `ok` — the
reference's `bench.py` main, mode by mode. `run_smoke` runs every gate of
the file that the port has, at the file's smoke sizes, and names the rest
under `not_ported`, each with the ROADMAP.md entry that brings it. Its
`ok` covers the ported gates only, and says so.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import json
import subprocess
import sys
import time
from pathlib import Path

FLOOR_PATH = Path(__file__).resolve().parents[2] / "BENCH_FLOOR.json"

#: BENCH_FLOOR.json keys whose gate the port does not run yet, by key
#: prefix, with the ROADMAP.md queue 1 entry that brings it (none: every
#: gate of the file is ported)
NOT_PORTED_PREFIXES: dict = {}

#: read where pyarrow imports; listed under `not_ported` where it does not
PARQUET_FLOOR = "egress_floors.parquet_rows_per_sec"
PYARROW_MISSING = "pyarrow missing on this host"


def pyarrow_importable() -> bool:
    from ..destinations.util import require_pyarrow
    from ..models.errors import EtlError

    try:
        require_pyarrow("the Parquet writer")
    except EtlError:
        return False
    return True


def not_ported_prefixes() -> dict:
    """NOT_PORTED_PREFIXES, plus the Parquet floor where pyarrow cannot
    be imported (the card's machine)."""
    out = dict(NOT_PORTED_PREFIXES)
    if not pyarrow_importable():
        out[PARQUET_FLOOR] = PYARROW_MISSING
    return out


def load_floors() -> dict:
    with open(FLOOR_PATH) as f:
        return json.load(f)


def not_ported(floors: dict) -> dict:
    """{key: ROADMAP entry} for every key of `floors` (and of its
    `egress_floors`) that no ported gate reads."""
    keys = list(floors) + [f"egress_floors.{k}"
                           for k in floors.get("egress_floors", {})]
    out = {}
    prefixes = not_ported_prefixes()
    for key in keys:
        for prefix, why in prefixes.items():
            if key.startswith(prefix):
                out[key] = why
    return out


def gate_ack(out: dict, floors: dict) -> dict:
    floor = floors.get("ack_window_speedup_floor", 0)
    out["speedup_floor"] = floor
    out["floor_ok"] = out["ack_window_speedup"] >= floor
    if not out["floor_ok"]:
        out["failures"].append(
            f"ack-window speedup {out['ack_window_speedup']} under floor "
            f"{floor}")
    out["ok"] = not out["failures"]
    return out


def gate_poison(out: dict, floors: dict) -> dict:
    floor = floors.get("poison_ratio_floor", 0.7)
    out["ratio_floor"] = floor
    out["floor_ok"] = out["poison_throughput_ratio"] >= floor
    if not out["floor_ok"]:
        out["failures"].append(
            f"poisoned throughput ratio {out['poison_throughput_ratio']} "
            f"under floor {floor}")
    out["ok"] = not out["failures"]
    return out


def gate_exactly_once(out: dict, floors: dict) -> dict:
    floor = floors.get("exactly_once_ratio_floor", 0.8)
    out["ratio_floor"] = floor
    out["floor_ok"] = out["exactly_once_overhead_ratio"] >= floor
    if not out["floor_ok"]:
        out["failures"].append(
            f"transactional throughput ratio "
            f"{out['exactly_once_overhead_ratio']} under floor {floor}")
    out["ok"] = not out["failures"]
    return out


def gate_workload(out: dict, floors: dict) -> dict:
    wfloors = floors.get("workload_floors", {})
    out["floors"] = {n: wfloors[n] for n in out["events_per_second"]
                     if n in wfloors}
    out["failures"] = [
        f"{n}: {v} ev/s under floor {wfloors[n]}"
        for n, v in out["events_per_second"].items()
        if n in wfloors and v < wfloors[n]]
    out["failures"] += [f"{n}: end state not verified"
                        for n, r in out["profiles"].items()
                        if not r["verified"]]
    out["failures"] += [f"{n}: a device-routed batch launched no kernel"
                        for n, r in out["profiles"].items()
                        if not r["launches_ok"]]
    out["ok"] = not out["failures"]
    return out


def gate_multi(out: dict, floors: dict) -> dict:
    floor = floors.get("multi_pipeline_events_per_sec_floor", 0)
    out["floor_events_per_second"] = floor
    failures = []
    if out["streams"] < 2:
        failures.append(f"only {out['streams']} streams")
    if not out["all_verified"]:
        failures.append("a stream's end state failed verification")
    out["floor_ok"] = out["aggregate_events_per_second"] >= floor
    if not out["floor_ok"]:
        failures.append(
            f"aggregate {out['aggregate_events_per_second']} ev/s under "
            f"floor {floor}")
    if not out["scheduler_drained"]:
        failures.append("admission scheduler did not drain")
    if out["admission_grants"] <= 0:
        failures.append("no admission grants — the scheduler was never "
                        "exercised")
    if not out["launches_ok"]:
        failures.append("a device-routed batch launched no kernel")
    out["failures"] = failures
    out["ok"] = not failures
    return out


def gate_sharded(out: dict, floors: dict,
                 single: "dict | None" = None) -> dict:
    """The sharded floor; with `single` (the K = 1 baseline of the same
    workload) also the reference's strictly-above-single gate."""
    floor = floors.get("sharded_events_per_sec_floor", 0)
    out["floor_events_per_second"] = floor
    failures = []
    if not out["all_verified"]:
        failures.append("a shard's slice failed end-state verification")
    if not out["union_covers_all_tables"]:
        failures.append("shard slices do not cover every table exactly "
                        "once")
    if not out["launches_ok"]:
        failures.append("a worker's kernel launches differ from its "
                        "device-routed batches")
    out["floor_ok"] = out["aggregate_events_per_second"] >= floor
    if not out["floor_ok"]:
        failures.append(
            f"aggregate {out['aggregate_events_per_second']} ev/s under "
            f"floor {floor}")
    if single is not None:
        out["single_shard_events_per_second"] = \
            single["aggregate_events_per_second"]
        out["single_shard_verified"] = single["all_verified"]
        out["speedup_vs_single"] = round(
            out["aggregate_events_per_second"]
            / max(single["aggregate_events_per_second"], 1), 3)
        if not single["all_verified"]:
            failures.append("the single-shard baseline failed "
                            "verification")
        if out["aggregate_events_per_second"] <= \
                single["aggregate_events_per_second"]:
            failures.append(
                f"sharded aggregate {out['aggregate_events_per_second']} "
                f"not strictly above the single-shard run "
                f"{single['aggregate_events_per_second']}")
    out["failures"] = failures
    out["ok"] = not failures
    return out


def _decode_identity(device: str) -> dict:
    """Pipelined decode byte-identical to serial `decode()`, and the
    three stage histograms observed (the reference smoke's first gate)."""
    from .. import bench
    from ..ops.engine import DeviceDecoder
    from ..ops.pipeline import DecodePipeline
    from ..ops.wal import concat_payloads, stage_wal_batch
    from ..telemetry.metrics import (ETL_DECODE_DISPATCH_SECONDS,
                                     ETL_DECODE_FETCH_SECONDS,
                                     ETL_DECODE_PACK_SECONDS, registry)

    payloads = bench.build_workload(2048)
    buf, offs, lens = concat_payloads(payloads)

    def stage():
        return stage_wal_batch(buf, offs, lens, 4)

    decoder = DeviceDecoder(bench.make_schema(), device=device)
    serial = [decoder.decode(stage().staged) for _ in range(3)]
    pipe = DecodePipeline(window=2)
    try:
        handles = [pipe.submit(decoder, stage().staged) for _ in range(3)]
        pipelined = [h.result() for h in handles]
    finally:
        pipe.close()
        pipe.join(10.0)
    return {
        "pipelined_identical": all(bench.batches_equal(s, p)
                                   for s, p in zip(serial, pipelined)),
        "stages_observed": all(registry.get_histogram(n)[0] > 0 for n in (
            ETL_DECODE_PACK_SECONDS, ETL_DECODE_DISPATCH_SECONDS,
            ETL_DECODE_FETCH_SECONDS)),
    }


def _heartbeat_overhead(budget_events_per_sec: float) -> float:
    """One beat's cost charged against the per-event budget at one beat
    per event (pessimistic: the apply loop beats once per select wake)."""
    from ..supervision import Supervisor

    hb = Supervisor().register("bench")
    n_beats = 50_000
    rounds = []
    for _ in range(5):
        t0 = time.perf_counter()
        for i in range(n_beats):
            hb.beat(progress=i, busy=True)
        rounds.append((time.perf_counter() - t0) / n_beats)
    return min(rounds) * budget_events_per_sec


def _timed_run(argv: list, cwd: Path) -> tuple:
    """(completed process, seconds) of one subprocess run."""
    t0 = time.perf_counter()
    proc = subprocess.run(argv, capture_output=True, text=True,
                          timeout=600, cwd=str(cwd))
    return proc, time.perf_counter() - t0


def mesh_gate(floors: dict, device: str) -> dict:
    """The reference's mesh gate: `python -m etl_tpu_torch.bench
    --mesh-check --mesh-rows <mesh_smoke_rows>` in a child process on
    `device` — an 8-shard mesh over its devices (the one card repeated,
    or the CPU) must decode byte-identically to one device, unfiltered
    and filtered, with one launch a shard on a card."""
    root = FLOOR_PATH.parent
    proc, seconds = _timed_run(
        [sys.executable, "-m", "etl_tpu_torch.bench", "--mesh-check",
         "--mesh-rows", str(floors.get("mesh_smoke_rows", 8192)),
         "--device", device.split(":")[0]], root)
    try:
        out = json.loads(proc.stdout.strip().splitlines()[-1])
    except (ValueError, IndexError):
        out = {"error": (proc.stderr or "no output")[-400:]}
    out["ok"] = bool(proc.returncode == 0
                     and out.get("sharded_equals_single") is True
                     and out.get("filtered_sharded_equals_single") is True
                     and out.get("launches_ok") is True
                     and out.get("mesh_shards") == 8)
    out["process_seconds"] = seconds
    return out


def start_lint_processes(device: str) -> dict:
    """Start the two lint gates' processes in the background, beside
    the in-process pass: the exact commands CI runs (`python -m
    etl_tpu_torch.analysis --check-baseline -q`, and the IR tier with
    its mesh variants, `--programs --mesh -q --device <device>`), each
    timed on its own; `lint_gates` collects them."""
    pool = concurrent.futures.ThreadPoolExecutor(2)
    root = FLOOR_PATH.parent
    mod = [sys.executable, "-m", "etl_tpu_torch.analysis"]
    runs = {
        "baseline": pool.submit(_timed_run,
                                mod + ["--check-baseline", "-q"], root),
        "ir": pool.submit(_timed_run,
                          mod + ["--programs", "--mesh", "-q", "--device",
                                 device.split(":")[0]], root),
    }
    pool.shutdown(wait=False)
    return runs


def static_pass() -> tuple:
    """(findings, violations past the baseline, seconds) of the
    whole-program etl-lint pass over the package, in this process."""
    from ..analysis import baseline as baseline_mod
    from ..analysis.rules import analyze_paths, repo_package_dir

    t0 = time.perf_counter()
    findings = analyze_paths([str(repo_package_dir())])
    seconds = time.perf_counter() - t0
    violations, _ = baseline_mod.apply(findings, baseline_mod.load())
    return findings, violations, seconds


def lint_gates(floors: dict, static: tuple, runs: dict) -> dict:
    """bench --smoke's two lint gates, as the reference's bench.py
    (:770-815): (1) the whole-program etl-lint pass (`static_pass`)
    under `static_analysis_budget_s`, with no violation past the
    baseline, and `--check-baseline` clean in a process under the same
    budget; (2) the IR tier in a process, exit 0 (every contract clean
    over the catalog) within `ir_analysis_budget_s`."""
    lint_budget_s = float(floors.get("static_analysis_budget_s", 30.0))
    ir_budget_s = float(floors.get("ir_analysis_budget_s", 120.0))
    findings, violations, lint_s = static
    base, base_s = runs["baseline"].result()
    ir, ir_s = runs["ir"].result()
    base_clean, ir_clean = base.returncode == 0, ir.returncode == 0
    return {
        "static_analysis_seconds": round(lint_s, 3),
        "static_analysis_budget_s": lint_budget_s,
        "static_analysis_under_budget": bool(
            lint_s < lint_budget_s and base_s < lint_budget_s),
        "static_analysis_findings": len(findings),
        "static_analysis_violations": len(violations),
        "static_analysis_baseline_clean": bool(base_clean),
        "static_analysis_baseline_seconds": round(base_s, 3),
        "static_analysis_baseline_error": "" if base_clean
        else (base.stdout + base.stderr)[-2000:],
        "ir_analysis_seconds": round(ir_s, 3),
        "ir_analysis_budget_s": ir_budget_s,
        "ir_analysis_under_budget": bool(ir_s < ir_budget_s),
        "ir_analysis_clean": bool(ir_clean),
        "ir_analysis_error": "" if ir_clean else ir.stderr[-2000:],
        "ir_analysis_report": ir.stderr.strip().splitlines()[-4:],
    }


def correctness_failures(failures: list) -> list:
    """The failures of a gate that are not a missed floor."""
    return [f for f in failures if "under floor" not in f]


def run_smoke(device: str = "cuda") -> dict:
    """Every ported gate of BENCH_FLOOR.json at its smoke size, decoding
    on `device`. Correctness first: every mode's own checks (identity,
    verification, digests, dup == 0, union, probe bound, launches equal
    to device-routed batches on the card) fail the gate as the floor
    does."""
    from .. import bench
    from ..chaos.autoscale import run_autoscale_surge_drain
    from ..chaos.dlq import run_dlq_poison
    from ..chaos.exactly_once import run_exactly_once_crash
    from ..chaos.sharded import run_sharded_scenario
    from ..telemetry.metrics import publish_table_rows_constructed
    from . import harness

    floors = load_floors()
    on_card = device.split(":")[0] == "cuda"
    gates: dict = {}  # name → the gate held, floor included
    correct: dict = {}  # name → the gate's checks but its floor held
    out: dict = {"mode": "smoke", "device": device}
    # coldstart's two lifetimes are subprocesses whose cold one waits on
    # the compiler: started first, in a thread, they overlap the other
    # gates (their wall clock, recorded and not gated, is then taken
    # under the smoke's load)
    pool = concurrent.futures.ThreadPoolExecutor(1)
    coldstart_run = pool.submit(
        harness.run_coldstart,
        n_tables=floors.get("coldstart_smoke_tables", 3),
        rows_per_tx=floors.get("coldstart_smoke_rows_per_tx", 400),
        txs_per_table=floors.get("coldstart_smoke_txs_per_table", 1),
        device=device)
    pool.shutdown(wait=False)
    ident = _decode_identity(device)
    out.update(ident)
    gates["decode_identity"] = correct["decode_identity"] = \
        ident["pipelined_identical"] and ident["stages_observed"]

    hb_budget = floors.get("heartbeat_budget_events_per_sec", 12_000)
    out["heartbeat_overhead_ratio"] = _heartbeat_overhead(hb_budget)
    gates["heartbeat"] = out["heartbeat_overhead_ratio"] < 0.01

    rows0 = publish_table_rows_constructed()
    stream = asyncio.run(bench.run_table_streaming(
        floors.get("table_streaming_smoke_events", 30_000),
        tx_size=floors.get("table_streaming_smoke_tx_size", 200),
        device=device))
    floor = floors["table_streaming_events_per_sec_floor"]
    out["table_streaming_events_per_second"] = \
        stream["end_to_end_events_per_second"]
    out["table_streaming_floor"] = floor
    out["table_streaming_floor_ok"] = \
        stream["end_to_end_events_per_second"] >= floor
    out["table_streaming_checks_ok"] = stream["ok"]
    out["table_streaming_k1_launches"] = stream["k1_launches"]
    out["table_rows_constructed"] = publish_table_rows_constructed() - rows0
    correct["table_streaming"] = bool(
        stream["ok"] and out["table_rows_constructed"] == 0
        and (not on_card or stream["k1_per_device_run_ok"]))
    gates["table_streaming"] = correct["table_streaming"] \
        and out["table_streaming_floor_ok"]

    egress = bench.run_egress(floors.get("egress_smoke_rows", 4096),
                              floors.get("egress_smoke_iters", 3),
                              device=device)
    egress_failures = [
        f"{k}: {egress.get(k)} under floor {v}"
        for k, v in floors.get("egress_floors", {}).items()
        if f"egress_floors.{k}" not in not_ported_prefixes()
        and egress.get(k, 0) < v]
    for flag in ("device_tsv_identical", "device_json_identical",
                 "device_tsv_used_device", "device_json_used_device"):
        if not egress.get(flag, False):
            egress_failures.append(flag)
    out["egress_failures"] = egress_failures
    gates["egress"] = not egress_failures
    correct["egress"] = not correctness_failures(egress_failures)

    workload = asyncio.run(harness.run_workload_matrix(
        floors.get("workload_smoke_profiles"),
        target_ops=floors.get("workload_smoke_ops", 400), device=device))
    gate_workload(workload, floors)
    out["workload_events_per_second"] = workload["events_per_second"]
    out["workload_failures"] = workload["failures"]
    gates["workload"] = workload["ok"]
    correct["workload"] = not correctness_failures(workload["failures"])

    mesh = mesh_gate(floors, device)
    out["mesh_check"] = mesh
    out["mesh_sharded_equals_single"] = bool(
        mesh.get("sharded_equals_single"))
    out["mesh_shards"] = mesh.get("mesh_shards", 0)
    gates["mesh"] = correct["mesh"] = mesh["ok"]

    sel = bench.run_selectivity(
        floors.get("selectivity_smoke_rows", 8_192), device=device,
        n_iters=floors.get("selectivity_smoke_iters", 3),
        fetch_slack=floors.get("selectivity_fetch_slack", 0.11))
    gates["selectivity"] = correct["selectivity"] = sel["ok"]

    ack = gate_ack(asyncio.run(harness.run_ack_latency(
        ack_ms=floors.get("ack_latency_smoke_ms", 20), device=device)),
        floors)
    out["ack_window_speedup"] = ack["ack_window_speedup"]
    out["ack_window_speedup_floor"] = ack["speedup_floor"]
    out["ack_failures"] = ack["failures"]
    gates["ack_window"] = ack["ok"]
    correct["ack_window"] = not correctness_failures(ack["failures"])

    poison = gate_poison(asyncio.run(harness.run_poison_streaming(
        rate=floors.get("poison_rate", 0.001),
        target_ops=floors.get("poison_smoke_ops", 12_000),
        device=device)), floors)
    dlq_chaos = asyncio.run(run_dlq_poison(seed=7, device=device))
    out["poison_throughput_ratio"] = poison["poison_throughput_ratio"]
    out["poison_ratio_floor"] = poison["ratio_floor"]
    out["poison_failures"] = poison["failures"]
    out["dlq_chaos_ok"] = dlq_chaos.ok
    gates["poison"] = poison["ok"] and dlq_chaos.ok
    correct["poison"] = not correctness_failures(poison["failures"]) \
        and dlq_chaos.ok

    eo = gate_exactly_once(asyncio.run(harness.run_exactly_once(
        n_events=floors.get("exactly_once_smoke_events", 3_000),
        device=device)), floors)
    eo_chaos = asyncio.run(run_exactly_once_crash(seed=7, device=device))
    out["exactly_once_overhead_ratio"] = eo["exactly_once_overhead_ratio"]
    out["exactly_once_ratio_floor"] = eo["ratio_floor"]
    out["exactly_once_failures"] = eo["failures"]
    out["exactly_once_duplicate_rows"] = eo["restart"]["duplicate_rows"]
    out["exactly_once_chaos_ok"] = eo_chaos.ok
    gates["exactly_once"] = eo["ok"] and eo_chaos.ok
    correct["exactly_once"] = not correctness_failures(eo["failures"]) \
        and eo_chaos.ok

    mp = gate_multi(asyncio.run(harness.run_multi_pipeline(
        profiles=floors.get("multi_pipeline_smoke_profiles"),
        target_ops=floors.get("multi_pipeline_smoke_ops", 500),
        device=device)), floors)
    out["multi_pipeline_events_per_second"] = \
        mp["aggregate_events_per_second"]
    out["multi_pipeline_floor"] = mp["floor_events_per_second"]
    out["multi_pipeline_failures"] = mp["failures"]
    gates["multi_pipeline"] = mp["ok"]
    correct["multi_pipeline"] = not correctness_failures(mp["failures"])

    sharded_chaos = asyncio.run(run_sharded_scenario(seed=7, device=device))
    sharded = gate_sharded(asyncio.run(harness.run_sharded_processes(
        shards=2, target_ops=floors.get("sharded_smoke_ops", 8_000),
        device=device)), floors)
    out["sharded_events_per_second"] = sharded["aggregate_events_per_second"]
    out["sharded_floor"] = sharded["floor_events_per_second"]
    out["sharded_failures"] = sharded["failures"]
    out["sharded_chaos_ok"] = sharded_chaos.ok
    gates["sharded"] = sharded["ok"] and sharded_chaos.ok
    correct["sharded"] = not correctness_failures(sharded["failures"]) \
        and sharded_chaos.ok

    # autoscale: (a) the policy's reaction-time gate over the seeded
    # surge→drain timeline (pure arithmetic); (b) the surge-drain chaos
    # run, a live K = 2 fleet scaled to 3 and back by the controller
    autoscale = harness.run_autoscale_bench(
        reaction_ticks_max=floors.get("autoscale_reaction_ticks_max", 3))
    autoscale_chaos = asyncio.run(run_autoscale_surge_drain(seed=7,
                                                            device=device))
    out["autoscale_reaction_ticks"] = autoscale["reaction_ticks"]
    out["autoscale_scale_up_tick"] = autoscale["scale_up_tick"]
    out["autoscale_scale_down_tick"] = autoscale["scale_down_tick"]
    out["autoscale_deterministic"] = bool(autoscale["deterministic"])
    out["autoscale_failures"] = autoscale["failures"]
    out["autoscale_chaos_ok"] = bool(autoscale_chaos.ok)
    out["autoscale_chaos"] = autoscale_chaos.describe()
    gates["autoscale"] = correct["autoscale"] = bool(
        autoscale["ok"] and autoscale_chaos.ok)

    # fleet: the declarative reconcile of a seeded fleet onto an empty
    # simulated fleet and through one versioned edit, within the
    # working-tick budget, zero double-actuations, observed ==
    # placement, the same actuation trace twice (pure arithmetic)
    fleet = harness.run_fleet_bench(
        fleet_size=floors.get("fleet_bench_pipelines", 100),
        converge_ticks_max=floors.get("fleet_converge_ticks_max", 3))
    out["fleet_ok"] = bool(fleet["ok"])
    for key in ("converge_ticks", "edit_converge_ticks",
                "converge_ticks_max", "double_actuations",
                "observed_equals_placement", "actuation_digest",
                "failures"):
        out[f"fleet_{key}"] = fleet[key]
    out["fleet_deterministic"] = bool(fleet["deterministic"])
    out["fleet_converge_wall_clock_s"] = fleet["converge_wall_clock_s"]
    gates["fleet"] = correct["fleet"] = bool(fleet["ok"])

    # the lint gates after the timed ones, so that nothing they run
    # overlaps a timed gate, and before the coldstart pair is read, whose
    # cold build may still be running: the two processes beside the
    # in-process pass
    lint_runs = start_lint_processes(device)
    lint = lint_gates(floors, static_pass(), lint_runs)
    out.update(lint)
    correct["static_analysis"] = bool(
        lint["static_analysis_violations"] == 0
        and lint["static_analysis_baseline_clean"])
    gates["static_analysis"] = correct["static_analysis"] \
        and lint["static_analysis_under_budget"]
    correct["ir_analysis"] = lint["ir_analysis_clean"]
    gates["ir_analysis"] = correct["ir_analysis"] \
        and lint["ir_analysis_under_budget"]

    # coldstart: two replicator subprocess lifetimes on one program-cache
    # dir — the warm restart builds NOTHING, loads from disk and decodes
    # no row on the oracle; the cold start's builds are bounded by the
    # prewarm buckets and the permuted tables share one canonical layout
    # (wall clock recorded, not gated)
    coldstart = coldstart_run.result()
    out["coldstart_failures"] = coldstart["failures"]
    out["coldstart_warm_zero_compiles"] = coldstart["warm_zero_compiles"]
    for key in ("warm_first_durable_seconds", "cold_first_durable_seconds"):
        out[f"coldstart_{key}"] = coldstart[key]
    gates["coldstart"] = correct["coldstart"] = bool(coldstart["ok"])

    out["gates"] = gates
    out["correctness"] = correct
    out["not_ported"] = not_ported(floors)
    out["ok"] = all(gates.values())
    out["ok_covers"] = "the ported gates in `gates`; the keys under " \
                       "`not_ported` are not run"
    return out
