# etl-lint fixture (PyTorch sinks): a clean admission grant path —
# weights and picks read HOST state only (LSN deltas, wall clock, plain
# counters); device traffic stays in the dispatch/fetch stages, so the
# rule stays quiet. A fetch OUTSIDE any @admission_path function is
# also fine (it belongs to the consumer's fetch stage).
# (no expectations: zero findings)
import time

import torch

from etl_tpu_torch.analysis.annotations import admission_path


@admission_path
def weight_from_lag(tenant, lag_scale):
    lag = max(0.0, float(tenant.received_lsn - tenant.durable_lsn))
    return 1.0 + lag / lag_scale


@admission_path
def pick_min_pass(waiters, starvation_s):
    now = time.monotonic()
    starved = [t for t in waiters if now - t.wait_since >= starvation_s]
    if starved:
        return min(starved, key=lambda t: t.wait_since)
    return min(waiters, key=lambda t: t.virtual_pass)


def fetch_at_consumer(pending):
    return torch.as_tensor(pending.result()).cpu()
