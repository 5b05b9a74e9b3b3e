# Safe non-blocking copy patterns: read after the copy's event (or the
# stream) is synchronised, rebind the name, read another buffer, or hand
# the in-flight buffer to a consumer that waits before reading.
import torch


def read_after_event(words_h, words_d, ev, stream):
    words_h.copy_(words_d, non_blocking=True)
    ev.record(stream)
    ev.synchronize()
    return words_h.sum()


def read_after_stream_sync(mask_h, mask_d, stream):
    mask_h.copy_(mask_d, non_blocking=True)
    stream.synchronize()
    return mask_h.numpy()


def read_after_device_sync(counts_h, counts_d):
    counts_h.copy_(counts_d, non_blocking=True)
    torch.cuda.synchronize()
    return counts_h[0]


def rebind_after_copy(words_h, words_d, fresh):
    words_h.copy_(words_d, non_blocking=True)
    words_h = fresh()
    return words_h.sum()


def hand_to_consumer(words_h, words_d, pending_cls, ev):
    words_h.copy_(words_d, non_blocking=True)
    ev.record()
    return pending_cls(words_h, ev)  # the consumer waits on ev first
