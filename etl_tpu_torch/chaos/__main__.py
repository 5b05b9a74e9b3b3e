"""CLI: `python -m etl_tpu_torch.chaos --seed N [--scenario NAME]`.

Replays scenarios deterministically: the same (scenario, seed) pair
produces the same workload and the same injection trace, so a failing
run from CI reproduces locally from its two numbers. Prints one JSON
object per scenario (sorted keys) and exits non-zero if any invariant
was violated.

Copy of the reference's `etl_tpu/chaos/__main__.py`. The pipelines decode
on the card (`--device cuda`, the default; no card fails the run) unless
`--device cpu` is given. `--fleet` reconciles a simulated fleet by
arithmetic alone and needs no device. The program-cache scenarios run on
the port's program store (ops/program_store.py), each in a private cache
directory.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m etl_tpu_torch.chaos",
        description="deterministic fault-injection scenario runner")
    parser.add_argument("--seed", type=int, default=7,
                        help="workload + injection RNG seed (default 7)")
    parser.add_argument("--scenario", default=None,
                        help="run one scenario by name (default: all)")
    parser.add_argument("--workload", default=None,
                        help="drive the selected scenario(s) with a named "
                             "workload profile (workloads/) instead "
                             "of the default mixed-insert traffic; the "
                             "run manifest and injection trace identify "
                             "the profile and replay bit-identically per "
                             "(scenario, workload, seed)")
    parser.add_argument("--matrix", action="store_true",
                        help="run the curated chaos x workload matrix "
                             "(corpus.WORKLOAD_MATRIX) instead of the "
                             "base corpus")
    parser.add_argument("--multi-pipeline", dest="multi_pipeline",
                        action="store_true",
                        help="run the multi-pipeline scenario instead of "
                             "the corpus: two replication streams share "
                             "the batch-admission scheduler, one is "
                             "hard-killed mid-stream and restarted; the "
                             "survivor must keep decoding, invariants "
                             "must hold for both, and the scheduler must "
                             "drain without leaking tickets or tenants")
    parser.add_argument("--sharded", dest="sharded", type=int, nargs="?",
                        const=2, default=None, metavar="K",
                        help="run the sharded pod-kill scenario instead "
                             "of the corpus: K shard replicators (default "
                             "2) split one publication over one shared "
                             "store, one shard is hard-killed mid-stream "
                             "and restarted; survivors must deliver their "
                             "whole remaining slice during the outage, "
                             "per-shard AND cross-shard-union invariants "
                             "must hold, and no shard may see another's "
                             "tables")
    parser.add_argument("--ack-window", dest="ack_window",
                        action="store_true",
                        help="run the ack-window crash scenario instead "
                             "of the corpus: CDC flows into a destination "
                             "whose acks turn durable late, the pipeline "
                             "is hard-killed while >= 2 acks are "
                             "verifiably in flight, and the restart must "
                             "re-stream the unacked window — zero-loss, "
                             "dup budget = the window, monotonic durable "
                             "LSN")
    parser.add_argument("--autoscale", dest="autoscale",
                        action="store_true",
                        help="run the closed-loop elasticity scenarios "
                             "instead of the corpus: a seeded backlog "
                             "surge must scale K=2->3 under flowing "
                             "traffic via the autoscale controller, the "
                             "drain must scale back 3->2 only after the "
                             "cooldown, invariants must hold across both "
                             "rebalances; then the controller is hard-"
                             "killed mid-rebalance and a successor must "
                             "resume via the persisted decision journal "
                             "with no leaked slots")
    parser.add_argument("--dlq", dest="dlq", action="store_true",
                        help="run the poison-pill / dead-letter "
                             "scenarios instead of the corpus: (1) "
                             "seeded poison rows mid-stream must bisect "
                             "to the DLQ within the probe-write bound, "
                             "quarantine the poisoned table once the "
                             "budget trips while every OTHER table "
                             "delivers its full workload, hold "
                             "delivered ∪ dead-lettered == committed "
                             "truth, and replay+unquarantine must "
                             "restore exact truth idempotently; (2) a "
                             "hard kill mid-bisection must reconverge "
                             "within the dup budget after restart")
    parser.add_argument("--exactly-once", dest="exactly_once",
                        action="store_true",
                        help="run the exactly-once hard-kill matrix "
                             "instead of the corpus: CDC flows into a "
                             "transactional sink that records the acked "
                             "WAL coordinate range atomically with the "
                             "data, the pipeline is hard-killed at "
                             "mid-write, post-write-pre-progress-commit, "
                             "and mid-recovery windows, and every "
                             "restart must recover the sink high-water "
                             "mark and converge with duplication == 0, "
                             "zero-loss, and a monotone high-water mark")
    parser.add_argument("--fleet", dest="fleet", action="store_true",
                        help="run the fleet reconciliation scenario "
                             "instead of the corpus: a 100-pipeline "
                             "declarative fleet (seeded tenancy "
                             "profiles, biting quotas) reconciles from "
                             "empty, absorbs one versioned "
                             "add/remove/resize edit, the coordinator "
                             "is hard-killed mid-roll in BOTH crash "
                             "windows (before and after the actuation "
                             "landed) and the successor must converge "
                             "via the per-pipeline actuation journal "
                             "with zero double-actuations, zero leaked "
                             "pipelines, and per-pipeline zero-loss / "
                             "bounded-dup invariants intact; the three "
                             "policy plugins (PID lag-target, adaptive "
                             "ack-depth, admission weights) run on one "
                             "signal bus")
    parser.add_argument("--device", default="cuda",
                        help="torch device the pipelines decode on: cuda "
                             "(the default; the card) or cpu (the "
                             "kernels' plain versions)")
    parser.add_argument("--device-floor", dest="device_floor", type=int,
                        default=None, metavar="ROWS",
                        help="route every batch of at least ROWS rows to "
                             "the kernels (default: the decoder's 64-row "
                             "floor, below which the corpus's small runs "
                             "take the host oracle)")
    parser.add_argument("--list", action="store_true",
                        help="list scenario names and exit")
    parser.add_argument("--timeout", type=float, default=60.0,
                        help="per-scenario timeout in seconds")
    args = parser.parse_args(argv)

    from ..models.errors import ErrorKind, EtlError

    from .runner import device_floor

    try:
        with device_floor(args.device_floor):
            return _run(parser, args)
    except EtlError as e:
        print(f"refused: {e}", file=sys.stderr)
        return 2 if e.kind is ErrorKind.CONFIG_INVALID else 1


def _run(parser, args) -> int:
    import torch

    from ..models.errors import ErrorKind, EtlError

    if args.fleet:
        if args.matrix or args.workload or args.scenario or args.sharded \
                or args.autoscale or args.multi_pipeline \
                or args.ack_window or args.dlq or args.exactly_once:
            parser.error("--fleet runs its own 100-pipeline "
                         "reconciliation scenario and cannot be "
                         "combined with --matrix/--workload/--scenario/"
                         "--sharded/--autoscale/--multi-pipeline/"
                         "--ack-window/--dlq/--exactly-once")
        from .fleet import run_fleet_chaos

        # the reconciler, the simulated fleet and the signal bus are
        # host arithmetic: the run touches no device, so --device is moot
        run = asyncio.run(run_fleet_chaos(seed=args.seed))
        print(json.dumps(run.describe(), sort_keys=True))
        return 0 if run.ok else 1
    from .corpus import SCENARIOS, WORKLOAD_MATRIX, get_scenario
    from .runner import run_scenario

    if args.list:
        for s in SCENARIOS + WORKLOAD_MATRIX:
            print(f"{s.name}: {s.description}")
        return 0
    if args.device.split(":")[0] == "cuda" \
            and not torch.cuda.is_available():
        # no fallback to the CPU: the run is on the card or it is not run
        raise EtlError(ErrorKind.DEVICE_UNAVAILABLE,
                       f"--device {args.device}: no CUDA device is "
                       "available (pass --device cpu to run the kernels' "
                       "plain versions)")
    device = args.device

    if args.exactly_once:
        if args.matrix or args.workload or args.scenario or args.sharded \
                or args.autoscale or args.multi_pipeline \
                or args.ack_window or args.dlq:
            parser.error("--exactly-once runs its own hard-kill matrix "
                         "and cannot be combined with --matrix/"
                         "--workload/--scenario/--sharded/--autoscale/"
                         "--multi-pipeline/--ack-window/--dlq")
        from .exactly_once import run_exactly_once_crash

        run = asyncio.run(run_exactly_once_crash(seed=args.seed,
                                                 device=device))
        print(json.dumps(run.describe(), sort_keys=True))
        return 0 if run.ok else 1

    if args.multi_pipeline:
        if args.matrix or args.workload or args.scenario or args.sharded \
                or args.autoscale:
            parser.error("--multi-pipeline runs its own two-stream "
                         "scenario and cannot be combined with "
                         "--matrix/--workload/--scenario/--sharded/"
                         "--autoscale")
        from .multi import run_multi_pipeline_scenario

        run = asyncio.run(run_multi_pipeline_scenario(seed=args.seed,
                                                      device=device))
        print(json.dumps(run.describe(), sort_keys=True))
        return 0 if run.ok else 1

    if args.ack_window:
        if args.matrix or args.workload or args.scenario or args.sharded \
                or args.autoscale:
            parser.error("--ack-window runs its own K-in-flight crash "
                         "scenario and cannot be combined with --matrix/"
                         "--workload/--scenario/--sharded/--autoscale")
        from .ack_window import run_ack_window_crash

        run = asyncio.run(run_ack_window_crash(seed=args.seed,
                                               device=device))
        print(json.dumps(run.describe(), sort_keys=True))
        return 0 if run.ok else 1

    if args.dlq:
        if args.matrix or args.workload or args.scenario or args.sharded \
                or args.autoscale or args.ack_window:
            parser.error("--dlq runs its own poison-isolation scenarios "
                         "and cannot be combined with --matrix/"
                         "--workload/--scenario/--sharded/--autoscale/"
                         "--ack-window")
        from .dlq import run_dlq_scenarios

        runs = asyncio.run(run_dlq_scenarios(seed=args.seed, device=device))
        all_ok = True
        for run in runs:
            print(json.dumps(run.describe(), sort_keys=True))
            all_ok = all_ok and run.ok
        return 0 if all_ok else 1

    if args.autoscale:
        if args.matrix or args.workload or args.scenario or args.sharded \
                or args.multi_pipeline:
            parser.error("--autoscale runs its own elasticity scenarios "
                         "and cannot be combined with --matrix/"
                         "--workload/--scenario/--sharded/"
                         "--multi-pipeline")
        from .autoscale import (run_autoscale_controller_crash,
                                run_autoscale_surge_drain)

        all_ok = True
        for runner_fn in (run_autoscale_surge_drain,
                          run_autoscale_controller_crash):
            run = asyncio.run(runner_fn(seed=args.seed, device=device))
            print(json.dumps(run.describe(), sort_keys=True))
            all_ok = all_ok and run.ok
        return 0 if all_ok else 1

    if args.sharded is not None:
        if args.matrix or args.workload or args.scenario:
            parser.error("--sharded runs its own K-shard pod-kill "
                         "scenario and cannot be combined with "
                         "--matrix/--workload/--scenario")
        if args.sharded < 2:
            parser.error("--sharded needs K >= 2 (killing the only "
                         "shard proves nothing about isolation)")
        from .sharded import run_sharded_scenario

        run = asyncio.run(run_sharded_scenario(seed=args.seed,
                                               shards=args.sharded,
                                               device=device))
        print(json.dumps(run.describe(), sort_keys=True))
        return 0 if run.ok else 1

    if args.matrix:
        # the matrix entries carry their profile in their NAME
        # (base__profile); overriding it with --workload (or narrowing
        # with --scenario, which already selects matrix entries by name
        # on its own) would make the manifest name a run that didn't
        # happen
        if args.workload or args.scenario:
            parser.error("--matrix cannot be combined with --workload or "
                         "--scenario (use --scenario <base>__<profile> to "
                         "run one matrix entry)")
        scenarios = list(WORKLOAD_MATRIX)
    elif args.scenario:
        scenarios = [get_scenario(args.scenario)]
    else:
        scenarios = list(SCENARIOS)
    if args.workload:
        from dataclasses import replace

        from ..workloads import get_profile

        get_profile(args.workload)  # fail fast on a typo'd profile name
        # matrix entries embed their profile in their NAME
        # (base__profile); rewriting the workload underneath one would
        # produce a manifest whose name claims traffic that didn't run —
        # the same hazard the --matrix guard above blocks
        clash = [s.name for s in scenarios
                 if s.workload is not None and s.workload != args.workload]
        if clash:
            parser.error(f"--workload conflicts with matrix entr"
                         f"{'ies' if len(clash) > 1 else 'y'} "
                         f"{', '.join(clash)} (the name pins the profile; "
                         "pick --scenario <base> --workload <profile> "
                         "instead)")
        scenarios = [replace(s, workload=args.workload) for s in scenarios]
    all_ok = True
    for scenario in scenarios:
        run = asyncio.run(run_scenario(scenario, args.seed,
                                       timeout_s=args.timeout,
                                       device=device))
        print(json.dumps(run.describe(), sort_keys=True))
        all_ok = all_ok and run.ok
    return 0 if all_ok else 1


if __name__ == "__main__":
    sys.exit(main())
