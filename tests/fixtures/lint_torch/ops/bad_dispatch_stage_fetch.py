# etl-lint fixture (PyTorch sinks): @dispatch_stage sanctions UPLOADS
# and enqueued copies only — fetch-side transfers (.cpu(), a blocking
# copy_, an event wait) inside the dispatch stage still serialize the
# pipeline and must be flagged, and an upload in a plain @hot_loop
# function (no @dispatch_stage) is still a finding.
# expect: hot-loop-host-transfer=5
from etl_tpu_torch.analysis.annotations import dispatch_stage, hot_loop


@dispatch_stage
@hot_loop
def dispatch_then_fetch(launch, bmat_h, bmat_d, words_h, ev):
    bmat_d.copy_(bmat_h, non_blocking=True)  # upload: sanctioned
    out = launch(bmat_d)
    words_h.copy_(out)  # blocking D2H: flagged
    ev.synchronize()  # event wait: flagged
    return out.cpu()  # fetch: flagged


@hot_loop
def upload_outside_dispatch_stage(bmat, dev):
    staged = bmat.cuda()  # no @dispatch_stage: flagged
    return staged, bmat.to(dev)  # flagged
