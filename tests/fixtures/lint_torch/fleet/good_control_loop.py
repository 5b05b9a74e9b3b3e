# etl-lint fixture: clean fleet-reconciler decision path — placement
# and diff under @control_loop are pure arithmetic over the desired
# spec and an already-observed shard map; the reconciler's observe()
# (runtime listing, store reads) and actuation live OUTSIDE the marked
# path, where I/O belongs.
# (no expectations: zero findings)
from etl_tpu_torch.analysis.annotations import control_loop


@control_loop
def clamp_tenant_budget(pipelines, max_shards):
    # every pipeline keeps >= 1 shard; surplus dealt in id order
    targets = {p.pipeline_id: 1 for p in pipelines}
    budget = max_shards - len(targets)
    for p in sorted(pipelines, key=lambda q: q.pipeline_id):
        want = p.shard_count - 1
        grant = min(want, budget)
        targets[p.pipeline_id] += grant
        budget -= grant
    return targets


@control_loop
def diff_shard_map(targets, observed):
    deletes = sorted(pid for pid in observed if pid not in targets)
    creates = sorted(pid for pid in targets if pid not in observed)
    resizes = sorted(pid for pid, k in targets.items()
                     if pid in observed and observed[pid] != k)
    return deletes, creates, resizes


def observe_fleet(path):
    # sampling is NOT the decision path: file/store reads belong here
    with open(path) as f:
        return f.read()
