# etl-lint fixture (PyTorch sinks): blocking I/O and device traffic
# inside the autoscaling control loop's decision path (@control_loop,
# autoscale/) — the signal→policy→decision computation must be a
# pure function of (SignalFrame history, config); a blocking call ties
# decision latency to an external service, a device call ties
# shard-count control to accelerator health. Nested defs and lambdas
# inherit the frame flag.
# expect: control-loop-blocking-io=6
import time

import torch
import requests

from etl_tpu_torch.analysis.annotations import control_loop


@control_loop
def evaluate_with_settle(history, current_k):
    time.sleep(0.5)  # blocking settle inside the decision: flagged
    return current_k + 1


@control_loop
def capacity_from_device(counter_dev):
    # the decision must read HOST state (sampled frames), never the chip
    return float(counter_dev.item())  # flagged


@control_loop
def decide_from_dashboard(url, current_k):
    doc = requests.get(url).json()  # network I/O in the decision: flagged
    return max(current_k, doc["target"])


@control_loop
def decide_from_file(path, current_k):
    with open(path) as f:  # filesystem read in the decision: flagged
        return int(f.read())


@control_loop
def make_capacity_estimator(pending):
    def estimate():
        pending.synchronize()  # nested def inherits: flagged
        return 1.0

    return estimate


@control_loop
def make_backlog_reader(counter_dev):
    return lambda: counter_dev.item()  # lambda inherits: flagged
