# etl-lint fixture (PyTorch sinks): dispatch-only @hot_loop function,
# with the fetch in an undecorated consumer; a dtype cast is no
# transfer — the hot-loop rule must stay quiet.
# (no expectations: zero findings)
import torch

from etl_tpu_torch.analysis.annotations import hot_loop


@hot_loop
def dispatch_only(launch, words):
    words = words.to(torch.int32)  # a cast on the card, not a move
    return launch(words)  # hands back the pending outputs


def consumer_fetch(pending, ev):
    ev.synchronize()  # not @hot_loop: the wait belongs here
    return pending.cpu().numpy()
