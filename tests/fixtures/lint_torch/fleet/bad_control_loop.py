# etl-lint fixture (PyTorch sinks): blocking I/O and device traffic
# inside the fleet reconciler's decision path (@control_loop, fleet/)
# — the observe→diff→converge computation must be a pure function of
# (desired spec, observed shard map); a blocking call ties every
# pipeline's convergence to one external service, a device call ties
# fleet control to accelerator health. Nested defs and lambdas inherit
# the frame flag.
# expect: control-loop-blocking-io=6
import time

import torch
import requests

from etl_tpu_torch.analysis.annotations import control_loop


@control_loop
def diff_with_settle(targets, observed):
    time.sleep(0.2)  # blocking settle inside the diff: flagged
    return [pid for pid in targets if pid not in observed]


@control_loop
def observed_k_from_device(counter_dev):
    # the diff must consume HOST state (the observe() snapshot),
    # never read the chip
    return int(counter_dev.item())  # flagged


@control_loop
def targets_from_dashboard(url):
    doc = requests.get(url).json()  # network I/O in the diff: flagged
    return doc["targets"]


@control_loop
def spec_from_file(path):
    with open(path) as f:  # filesystem read in the diff: flagged
        return f.read()


@control_loop
def make_backlog_scorer(pending):
    def score():
        pending.synchronize()  # nested def inherits: flagged
        return 0.0

    return score


@control_loop
def make_shard_counter(counter_dev):
    return lambda: counter_dev.item()  # lambda inherits: flagged
