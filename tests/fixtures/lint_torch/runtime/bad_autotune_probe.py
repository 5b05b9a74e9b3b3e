# etl-lint fixture (PyTorch sinks): the autotune probe and a kernel
# library's load (an nvcc build on a cold store) running synchronously
# inside the asyncio apply loop, with device sync points beside them.
# Regression guard for device-sync-in-async.
# expect: device-sync-in-async=5
import torch

from etl_tpu_torch.ops import autotune, decode_kernel


class Sealer:
    async def seal_run(self, device_value, ev):
        # resolve_device_min_rows -> measure(): builds and times the
        # kernels over the link, all on the event loop
        rows = autotune.resolve_device_min_rows(4, 36.0, 16384)
        decode_kernel.load()
        host = device_value.cpu()
        ev.synchronize()
        return rows, host, device_value.item(), torch.float32
