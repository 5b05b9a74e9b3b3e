# expect: device-sync-in-async=2
# Cross-DIRECTORY chains: an event-loop coroutine in runtime/ reaches a
# definite device sync (.cpu(), torch.cuda.synchronize) through an ops/
# helper. The lexical rule only sees the helper call.
from ..ops.helpers_device import fetch_all, wait_all


async def drain_results(pending):
    return fetch_all(pending)


async def wait_for_card():
    wait_all()
