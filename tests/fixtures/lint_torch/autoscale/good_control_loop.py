# etl-lint fixture: clean @control_loop decision path — pure arithmetic
# over already-sampled signal frames; blocking I/O OUTSIDE any marked
# function (the collector's sampling, the controller's actuation) is
# fine, and so is math/sorting inside the marked path.
# (no expectations: zero findings)
import math

from etl_tpu_torch.analysis.annotations import control_loop


@control_loop
def rate_model_target(backlog_bytes, capacity_bytes_per_s, drain_slo_s):
    if backlog_bytes <= 0:
        return 0
    return math.ceil(backlog_bytes / (capacity_bytes_per_s * drain_slo_s))


@control_loop
def pick_laggiest_shard(frames):
    latest = frames[-1]
    return max(latest.shards, key=lambda s: s.lag_bytes)


def collector_sample(path):
    # sampling is NOT the decision path: file/registry reads belong here
    with open(path) as f:
        return f.read()
