# etl-lint fixture (PyTorch sinks): the decode pipeline's dispatch stage
# — a @hot_loop function where host→device UPLOADS and enqueued copies
# (.cuda(), .to(<device>), .copy_(…, non_blocking=True)) are sanctioned
# by @dispatch_stage; the rule must stay quiet.
# (no expectations: zero findings)
from etl_tpu_torch.analysis.annotations import dispatch_stage, hot_loop


@dispatch_stage
@hot_loop
def dispatch_packed(launch, bmat_h, lengths_h, words_h, device):
    bmat = bmat_h.to(device, non_blocking=True)  # upload: rides the stream
    lengths = lengths_h.cuda(non_blocking=True)
    out = launch(bmat, lengths)
    words_h.copy_(out, non_blocking=True)  # enqueued D2H into pinned
    return words_h
