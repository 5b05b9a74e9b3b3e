# expect: donated-buffer-use=3
# The port's counterpart of a donation: the destination of a
# non-blocking copy is read on the host before the copy's event (or the
# stream) is synchronised on the path — the copy engine may not have
# written it yet.
import numpy as np


def read_before_event(words_h, words_d, ev, stream):
    words_h.copy_(words_d, non_blocking=True)
    ev.record(stream)
    checksum = words_h.sum()  # read before the wait
    ev.synchronize()
    return checksum


def numpy_view_before_wait(mask_h, mask_d, ev):
    mask_h.copy_(mask_d, non_blocking=True)
    bits = np.asarray(mask_h)  # host read of the in-flight buffer
    ev.synchronize()
    return bits


def wait_on_one_branch(counts_h, counts_d, ev, wait):
    counts_h.copy_(counts_d, non_blocking=True)
    if wait:
        ev.synchronize()
    return counts_h[0]  # one path reaches here without a wait
