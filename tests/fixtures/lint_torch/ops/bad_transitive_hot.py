# expect: hot-loop-host-transfer=3
# The decorator is import-ALIASED — the lexical rule (which matches the
# terminal decorator name in-module) still sees `hl`, but the resolver
# follows the import to analysis.annotations.hot_loop. The hot functions
# reach a fetch (.cpu()) and a device-wide synchronize through helpers
# one file away.
from etl_tpu_torch.analysis.annotations import hot_loop as hl

from .helpers_device import fetch_all, wait_all


@hl
def dispatch_row(batch):
    return fetch_all(batch.pending)


@hl
def dispatch_nested(batch):
    def drain():
        return fetch_all(batch.pending)

    return drain()


@hl
def dispatch_and_wait(batch):
    wait_all()
    return batch
