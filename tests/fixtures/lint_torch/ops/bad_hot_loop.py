# etl-lint fixture (PyTorch sinks): host transfers inside a @hot_loop
# function — each one serializes the hot path against the device link.
# expect: hot-loop-host-transfer=7
import torch

from etl_tpu_torch.analysis.annotations import hot_loop


@hot_loop
def dispatch_and_fetch(words, counts, ev):
    torch.cuda.synchronize()
    ev.synchronize()
    n = counts.item()
    host = words.cpu()
    rows = counts.tolist()
    back = words.to("cpu")
    return host.numpy(), n, rows, back
