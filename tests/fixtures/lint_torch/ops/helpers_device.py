# Clean in isolation: sync helpers around device transfers are legal —
# the bug is reaching them from a @hot_loop function or the event loop
# (bad_transitive_hot.py / bad_transitive_device.py).
import torch


def fetch_all(values):
    return [v.cpu() for v in values]


def wait_all():
    torch.cuda.synchronize()


def force_upload(arr, dev):
    return arr.to(dev)
