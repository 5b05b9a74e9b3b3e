# etl-lint fixture (PyTorch sinks): blocking device traffic inside the
# batch-admission scheduler's grant path (@admission_path) — a fetch
# (.item() / .cpu() / a synchronize) OR an upload (.cuda(): the
# @dispatch_stage sanction does NOT extend here) under the scheduler
# lock head-of-line-blocks every tenant's admission. The inline lag
# provider (a nested def/lambda) inherits the frame flag.
# expect: admission-blocking-fetch=6
import torch

from etl_tpu_torch.analysis.annotations import admission_path


@admission_path
def weight_from_device_counter(tenant, counter_dev):
    lag = counter_dev.item()  # fetch under the lock: flagged
    return 1.0 + float(counter_dev.cpu()) + lag  # flagged


@admission_path
def grant_after_sync(tenant, ev):
    ev.synchronize()  # sync in the grant path: flagged
    torch.cuda.synchronize()  # flagged
    return tenant


@admission_path
def admit_with_upload(tenant, weights):
    # even an UPLOAD blocks every waiter behind this tenant's transfer
    return weights.cuda()  # flagged


@admission_path
def make_lag_provider(counter_dev):
    def lag_bytes():
        return float(counter_dev.item())  # nested def: flagged

    return lag_bytes
