"""CLI: `python -m etl_tpu_torch.autoscale --replay signals.json`.

Dry-runs a signal timeline through the scaling policy and prints the
decision trace — one JSON object per evaluation tick (sorted keys) plus
a trailing summary line — with the applied-K loop closed in memory
(every non-hold decision updates the simulated topology and starts the
cooldown). Deterministic: the same (timeline, policy knobs) input
prints the identical trace, and `--synthetic --seed N` replays the
seeded surge→drain story bit-identically — the same replay contract as
`python -m etl_tpu_torch.chaos`. Exit 0 always (a dry run has no invariants
to violate); malformed input exits 2.
"""

from __future__ import annotations

import argparse
import json
import sys

from .policy import ACTION_HOLD, AutoscalePolicy, AutoscalePolicyConfig, \
    simulate
from .signals import SignalTimeline, seeded_surge_timeline


def main(argv: "list[str] | None" = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m etl_tpu_torch.autoscale",
        description="replay a signal timeline through the scaling "
                    "policy and print the deterministic decision trace")
    src = parser.add_mutually_exclusive_group(required=True)
    src.add_argument("--replay", metavar="SIGNALS_JSON",
                     help="recorded timeline file (SignalTimeline JSON: "
                          "{frames: [{tick, at_s, shards: [...]}]})")
    src.add_argument("--synthetic", action="store_true",
                     help="generate the seeded surge→drain timeline "
                          "instead of reading a file (the bench "
                          "reaction-time gate's input)")
    parser.add_argument("--seed", type=int, default=7,
                        help="synthetic-timeline seed (default 7)")
    parser.add_argument("--start-k", type=int, default=None,
                        help="initial shard count (default: the first "
                             "frame's shard count)")
    parser.add_argument("--holds", action="store_true",
                        help="print HOLD evaluations too (default: only "
                             "scale decisions + the summary)")
    # policy knobs (docs/autoscale.md): defaults match
    # AutoscalePolicyConfig
    _d = AutoscalePolicyConfig()
    parser.add_argument("--drain-slo-s", type=float, default=_d.drain_slo_s)
    parser.add_argument("--up-backlog-bytes", type=int,
                        default=_d.up_backlog_bytes)
    parser.add_argument("--down-backlog-bytes", type=int,
                        default=_d.down_backlog_bytes)
    parser.add_argument("--up-ticks", type=int, default=_d.up_ticks)
    parser.add_argument("--down-ticks", type=int, default=_d.down_ticks)
    parser.add_argument("--cooldown-ticks", type=int,
                        default=_d.cooldown_ticks)
    parser.add_argument("--min-shards", type=int, default=_d.min_shards)
    parser.add_argument("--max-shards", type=int, default=_d.max_shards)
    args = parser.parse_args(argv)

    if args.synthetic:
        timeline = seeded_surge_timeline(args.seed)
    else:
        try:
            with open(args.replay) as f:
                timeline = SignalTimeline.from_json(json.load(f))
        except (OSError, ValueError, KeyError) as e:
            print(f"cannot load {args.replay}: {e}", file=sys.stderr)
            return 2
    if not timeline.frames:
        print("timeline has no frames", file=sys.stderr)
        return 2

    config = AutoscalePolicyConfig(
        min_shards=args.min_shards, max_shards=args.max_shards,
        drain_slo_s=args.drain_slo_s,
        up_backlog_bytes=args.up_backlog_bytes,
        down_backlog_bytes=args.down_backlog_bytes,
        up_ticks=args.up_ticks, down_ticks=args.down_ticks,
        cooldown_ticks=args.cooldown_ticks)
    config.validate()
    policy = AutoscalePolicy(config)
    start_k = args.start_k if args.start_k is not None \
        else max(1, timeline.frames[0].shard_count)

    decisions = simulate(timeline.frames, policy, start_k)
    final_k = start_k
    actions = []
    for d in decisions:
        if d.action != ACTION_HOLD:
            final_k = d.target_k
            actions.append({"tick": d.tick, "action": d.action,
                            "k": f"{d.current_k}->{d.target_k}"})
        if args.holds or d.action != ACTION_HOLD:
            print(json.dumps(d.describe(), sort_keys=True))
    print(json.dumps({
        "summary": True,
        "source": "synthetic" if args.synthetic else args.replay,
        "seed": args.seed if args.synthetic else None,
        "frames": len(timeline.frames),
        "start_k": start_k,
        "final_k": final_k,
        "decisions": actions,
        "policy": config.to_json(),
    }, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
