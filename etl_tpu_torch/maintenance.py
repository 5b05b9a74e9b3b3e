"""Lake maintenance binary: `python -m etl_tpu_torch.maintenance`.

Reference parity: crates/etl-maintenance + the etl-ducklake-maintenance
binary (etl-replicator/src/bin/etl-ducklake-maintenance.rs) — external
maintenance (compaction/vacuum) coordinated with live writers through the
catalog maintenance flag, optionally pausing/resuming the pipeline through
the control-plane API around the operation (the reference's
pause-replicator-around-compaction coordination).

Copy of the reference's `etl_tpu/maintenance.py`; the control plane's
maintenance CronJob runs it (`api/orchestrator.py`). The lake rewrites
Parquet through pyarrow: where pyarrow cannot be imported, the command
exits 2 before it pauses anything, with the typed CONFIG_INVALID naming
pyarrow on stderr, and `run_maintenance` raises it.

    python -m etl_tpu_torch.maintenance --warehouse DIR [--vacuum]
        [--api-url URL --pipeline-id N --tenant-id T [--api-key K]]
        [--min-cdc-files N] [--history] [--coordinate]
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys

from .destinations.lake import LakeConfig, LakeDestination
from .destinations.util import require_pyarrow
from .models.errors import EtlError


async def run_maintenance(warehouse: str, *, vacuum: bool,
                          api_url: str | None, pipeline_id: int | None,
                          tenant_id: str | None,
                          api_key: str | None = None,
                          stop_timeout_s: float = 120.0,
                          min_cdc_files: int = 2) -> dict:
    """Operation policy (reference etl-maintenance operation policies): a
    table is compacted only when its current generation holds at least
    `min_cdc_files` CDC files — churning small tables is pure write
    amplification. Every operation lands in the catalog's
    lake_maintenance_history for the --history surface. Without pyarrow
    it raises the typed CONFIG_INVALID before it pauses anything."""
    require_pyarrow("lake maintenance")
    paused = False
    session = None
    if api_url and pipeline_id is not None:
        import aiohttp

        headers = {"tenant_id": tenant_id or ""}
        if api_key:
            # the control plane's bearer-auth middleware rejects
            # unauthenticated /v1 calls with 401 — coordination against a
            # secured API needs the key on every pause/status/resume call
            headers["Authorization"] = f"Bearer {api_key}"
        session = aiohttp.ClientSession(headers=headers)
    try:
        if session is not None:
            async with session.post(
                    f"{api_url}/v1/pipelines/{pipeline_id}/stop") as resp:
                paused = resp.status in (200, 202)
            if not paused:
                # the operator asked for coordination; running maintenance
                # against a live writer is exactly what they tried to avoid
                raise RuntimeError(
                    f"could not pause pipeline {pipeline_id}: "
                    f"HTTP {resp.status} — aborting maintenance")
            # 202 means 'stopping': the orchestrator deletes the workload
            # but the pod may still be draining — poll until the pipeline
            # reports stopped so compaction never overlaps a live writer
            # (the pause coordination race). A timeout here still
            # flows through the resume in the finally below — aborted
            # maintenance must not leave replication down.
            deadline = asyncio.get_event_loop().time() + stop_timeout_s
            while True:
                async with session.get(
                        f"{api_url}/v1/pipelines/{pipeline_id}/status") as st:
                    body = await st.json() if st.status == 200 else {}
                if body.get("state") == "stopped":
                    break
                if asyncio.get_event_loop().time() > deadline:
                    raise RuntimeError(
                        f"pipeline {pipeline_id} did not reach 'stopped' "
                        f"within {stop_timeout_s}s "
                        f"(state={body.get('state')!r}) — "
                        f"aborting maintenance")
                await asyncio.sleep(min(0.5, stop_timeout_s / 10))
        lake = LakeDestination(LakeConfig(warehouse))
        await lake.startup()
        table_ids = lake.table_ids()
        compacted = 0
        vacuumed = 0
        skipped_by_policy = 0
        for tid in table_ids:
            if lake.current_cdc_file_count(tid) >= min_cdc_files:
                compacted += await lake.compact(tid)
            else:
                skipped_by_policy += 1
                lake.record_maintenance_skip(tid, "compact")
            if vacuum:
                vacuumed += await lake.vacuum(tid)
        history = lake.maintenance_history(limit=20)
        await lake.shutdown()
        return {"tables": len(table_ids), "compacted_files": compacted,
                "vacuumed_files": vacuumed,
                "skipped_by_policy": skipped_by_policy,
                "paused_pipeline": paused, "history": history}
    finally:
        if session is not None:
            try:
                if paused:
                    async with session.post(
                            f"{api_url}/v1/pipelines/{pipeline_id}/start") \
                            as resp:
                        if resp.status not in (200, 202):
                            import logging

                            logging.getLogger(
                                "etl_tpu_torch.maintenance").error(
                                "failed to resume pipeline %s: HTTP %s — "
                                "resume it manually", pipeline_id,
                                resp.status)
            except Exception as e:
                import logging

                logging.getLogger("etl_tpu_torch.maintenance").error(
                    "failed to resume pipeline %s (%r) — resume it "
                    "manually", pipeline_id, e)
            finally:
                await session.close()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="etl_tpu_torch.maintenance")
    p.add_argument("--warehouse", required=True)
    p.add_argument("--vacuum", action="store_true",
                   help="also delete files from superseded generations")
    p.add_argument("--api-url", default=None,
                   help="control-plane URL: pause/resume the pipeline "
                        "around maintenance")
    p.add_argument("--pipeline-id", type=int, default=None)
    p.add_argument("--tenant-id", default=None)
    p.add_argument("--api-key", default=None,
                   help="bearer token for a secured control plane "
                        "(falls back to $ETL_API_KEY)")
    p.add_argument("--min-cdc-files", type=int, default=2,
                   help="compact a table only when it has >= this many "
                        "CDC files (operation policy)")
    p.add_argument("--history", action="store_true",
                   help="print maintenance history and exit (no ops)")
    p.add_argument("--coordinate", action="store_true",
                   help="run ONE coordinated controller pass through the "
                        "catalog coordination store (operation requests, "
                        "pause lease, history) instead of direct ops")
    p.add_argument("--wait-for-pause", type=float, default=30.0,
                   help="seconds to wait for the replicator to honor the "
                        "pause lease before proceeding (coordinate mode)")
    args = p.parse_args(argv)
    try:
        require_pyarrow("lake maintenance")
    except EtlError as e:
        print(json.dumps({"error": f"{type(e).__name__}: {e}",
                          "kind": e.kind.name}), file=sys.stderr)
        return 2
    if args.coordinate:
        if args.pipeline_id is None:
            # the coordination row is keyed by pipeline id; defaulting
            # would silently coordinate against a row no replicator reads
            p.error("--coordinate requires --pipeline-id")

        async def coordinate() -> dict:
            from .maintenance_coordination import (CatalogMaintenanceStore,
                                                   MaintenanceController,
                                                   MaintenancePolicy)

            lake = LakeDestination(LakeConfig(args.warehouse))
            await lake.startup()
            store = CatalogMaintenanceStore(args.warehouse,
                                            args.pipeline_id)
            ctrl = MaintenanceController(
                store, lake,
                MaintenancePolicy(merge_min_cdc_files=args.min_cdc_files,
                                  cleanup_old_files_enabled=args.vacuum))
            try:
                return await ctrl.run_once(
                    wait_for_pause_s=args.wait_for_pause)
            finally:
                store.close()
                await lake.shutdown()

        try:
            print(json.dumps(asyncio.run(coordinate())))
            return 0
        except Exception as e:
            print(json.dumps({"error": f"{type(e).__name__}: {e}"}),
                  file=sys.stderr)
            return 1
    if args.history:
        async def show() -> dict:
            lake = LakeDestination(LakeConfig(args.warehouse))
            await lake.startup()
            h = lake.maintenance_history(limit=100)
            await lake.shutdown()
            return {"history": h}

        print(json.dumps(asyncio.run(show())))
        return 0
    try:
        import os

        out = asyncio.run(run_maintenance(
            args.warehouse, vacuum=args.vacuum, api_url=args.api_url,
            pipeline_id=args.pipeline_id, tenant_id=args.tenant_id,
            api_key=args.api_key or os.environ.get("ETL_API_KEY"),
            min_cdc_files=args.min_cdc_files))
    except Exception as e:
        print(json.dumps({"error": f"{type(e).__name__}: {e}"}),
              file=sys.stderr)
        return 1
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
