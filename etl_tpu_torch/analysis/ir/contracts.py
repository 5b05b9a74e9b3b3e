"""The per-program contracts the IR tier checks.

Each checker is a pure function over what the runner recorded while it
launched one program (the tensors the launch took and returned, the
host tensors its D2H copies filled, the synchronising calls CUDA's sync
debug mode raised, the `torch.distributed` collectives called, the
kernel descriptors of permuted twins) and returns a list of (detail,
message) violation pairs — empty means the contract holds. Keeping the
checkers record-in/tuples-out makes them trivially falsifiable from
tests without a catalog, a card or a CLI: hand a checker a bad record,
assert it fires.

Contract catalog, each beside the reference's (etl_tpu/analysis/ir/
contracts.py), restated for CUDA launches:

  ir-host-callback    no synchronising call (a D2H fetch, an `.item()`,
                      a stream/event/device synchronize) between a
                      @hot_loop program's prepare and the enqueue of its
                      D2H copies, as `torch.cuda.set_sync_debug_mode(
                      "error")` raises them on the card (the reference:
                      no callback primitive in the jaxpr). Not checkable
                      on the CPU, where the run lists it as not checked
  ir-donation         the port declares no donation, so no output tensor
                      of a launch may share storage with an input tensor
                      (the reference: declared donation must be realized
                      as aliasing, and only on accelerators)
  ir-collective       no `torch.distributed` collective is called during
                      a catalogued dispatch, and on a mesh no shard's
                      launch reads or writes a row tensor of another
                      shard's block, and each kernel of the program
                      launches once a shard (the reference: no collective
                      in a mesh-sharded program's compiled HLO; the
                      port's mesh is one process driving its shards, so
                      a cross-shard effect is a launch touching another
                      block, or one shard's launch standing in for
                      another's)
  ir-widening         no tensor a launch takes or returns has a 64-bit
                      element type: bmat, lengths, row flags, the column
                      and predicate descriptors, the outputs (the
                      reference: no 64-bit equation in the jaxpr). K2c's
                      look-back status buffer is stream state, not an
                      input or output of a launch
  ir-output-budget    the bytes the dispatch's D2H copies move stay within
                      the per-layout budget (packed words + filter
                      metadata + the mesh's per-shard counts + slack) —
                      the reference's formula
  ir-egress-output-budget
                      the render's D2H (text + lengths) fetches at most
                      R·ΣW text bytes + one int32 length per rendered
                      field per row + slack — the reference's formula
  ir-canonical-dedup  permuted-column specs sharing a canonical layout
                      give byte-identical kernel descriptors and the same
                      library digest (and, where launched, the same
                      words) — the reference: byte-identical lowered IR
"""

from __future__ import annotations

#: element types the decode path must never widen to: the packed output
#: format is u32 words and every parser is specified in 32-bit
#: arithmetic; a 64-bit tensor doubles transfer bytes for zero precision
#: the format can represent
WIDE_DTYPES = frozenset({"torch.int64", "torch.uint64", "torch.float64",
                         "torch.complex128"})

#: the `torch.distributed` entry points the runner records during a run
COLLECTIVE_OPS = ("all_reduce", "all_gather", "all_gather_into_tensor",
                  "all_gather_object", "reduce_scatter",
                  "reduce_scatter_tensor", "all_to_all",
                  "all_to_all_single", "broadcast", "broadcast_object_list",
                  "reduce", "gather", "scatter", "barrier", "send", "recv",
                  "isend", "irecv")


def check_host_callback(sync_events) -> list:
    """ir-host-callback: each recorded synchronising call, once per
    site (`sync_events` holds one site string per raise)."""
    out = []
    for site in sorted(set(sync_events)):
        out.append((f"sync@{site}",
                    f"hot-loop program synchronises with the card at "
                    f"{site} (CUDA sync debug mode raised): every "
                    f"dispatch then waits for the device"))
    return out


def _storage_span(t) -> "tuple[int, int] | None":
    """(start, end) of the storage bytes `t` lives in, None for an empty
    tensor."""
    st = t.untyped_storage()
    n = st.nbytes()
    if n == 0:
        return None
    start = st.data_ptr()
    return start, start + n


def check_donation(inputs, outputs) -> list:
    """ir-donation: (input name, output name) pairs whose storages
    overlap on one device. `inputs`/`outputs` are (name, tensor) pairs."""
    out = []
    for oname, o in outputs:
        ospan = _storage_span(o)
        if ospan is None:
            continue
        for iname, i in inputs:
            ispan = _storage_span(i)
            if ispan is None or i.device != o.device:
                continue
            if ospan[0] < ispan[1] and ispan[0] < ospan[1]:
                out.append((f"{oname}<-{iname}",
                            f"launch output `{oname}` shares storage with "
                            f"its input `{iname}`: the port declares no "
                            f"donation, so a later write of the output "
                            f"would clobber what the caller still holds"))
    return out


def check_collectives(calls) -> list:
    """ir-collective: each `torch.distributed` op called during the
    program's dispatch."""
    return [(op, f"a catalogued dispatch called torch.distributed.{op}: "
                 f"decode is rank-local (rows are independent), so any "
                 f"collective is a regression")
            for op in sorted(set(calls))]


def _view_span(t) -> "tuple | None":
    """(device, start, end) of the bytes the view `t` can reach (its
    first element to its last, by its strides), None for an empty one."""
    if t.numel() == 0:
        return None
    reach = sum((n - 1) * st for n, st in zip(t.shape, t.stride())) + 1
    start = t.data_ptr()
    return t.device, start, start + reach * t.element_size()


def check_shard_locality(shards) -> list:
    """ir-collective on a mesh: (shard a's tensor, shard b's tensor)
    pairs whose bytes overlap on one device. `shards` holds one list of
    (name, tensor) a shard: the row tensors its launch read and wrote
    (its block of the input, its outputs); a shard's launch that reads
    or writes another shard's block overlaps that shard's tensors."""
    spans = [[(name, _view_span(t)) for name, t in shard]
             for shard in shards]
    out = []
    for a, mine in enumerate(spans):
        for b in range(a + 1, len(spans)):
            for an, asp in mine:
                for bn, bsp in spans[b]:
                    if asp is None or bsp is None or asp[0] != bsp[0]:
                        continue
                    if asp[1] < bsp[2] and bsp[1] < asp[2]:
                        out.append((
                            f"shard{a}.{an}~shard{b}.{bn}",
                            f"mesh shard {a}'s launch tensor `{an}` "
                            f"overlaps shard {b}'s `{bn}`: a shard's "
                            f"launch must read and write its own row "
                            f"block only"))
    return out


def check_shard_launches(launches: dict, kernel: str, n_shards: int) -> list:
    """ir-collective on a mesh: the program's kernel launched once a
    shard (`launches`, kernel → launches in the program's run; K2 + the
    epilogue count for K2c where the layout takes that route)."""
    if kernel == "k2c" and not launches.get("k2c"):
        got = {k: launches.get(k, 0) for k in ("k2", "epilogue")}
    else:
        got = {kernel: launches.get(kernel, 0)}
    return [(f"launches[{k}]={n}!={n_shards}",
             f"mesh program launched {k} {n} times over {n_shards} "
             f"shards: each shard launches its own block once")
            for k, n in got.items() if n != n_shards]


def check_widening(tensors) -> list:
    """ir-widening: (name, tensor) pairs with a 64-bit element type."""
    out = []
    for name, t in tensors:
        dt = str(t.dtype)
        if dt in WIDE_DTYPES:
            out.append((f"{name}[{dt.split('.', 1)[1]}]",
                        f"launch tensor `{name}` is {dt}: 64-bit types are "
                        f"outside the packed-u32 decode contract"))
    return out


def output_bytes(tensors) -> int:
    """Total bytes of `tensors` (the host tensors the D2H copies fill)."""
    return sum(t.numel() * t.element_size() for t in tensors)


def output_budget_bytes(n_words: int, row_capacity: int, *,
                        filtered: bool, n_shards: int = 0) -> int:
    """The per-program budget (the reference's): the packed words
    themselves, plus the filter metadata the fused path legitimately
    returns (keep mask — a mask a shard on a mesh, each rounded to whole
    words — and a survivor count a shard), plus the mesh's per-shard
    fallback counts, plus 64 bytes of fixed slack. Anything more — an
    extra R-sized output, a widened word array — trips the contract."""
    budget = n_words * 4 * row_capacity
    shards = max(n_shards, 1)
    if filtered:
        rps = row_capacity // shards
        budget += 4 * shards * ((rps + 31) // 32)  # keep mask, 1 bit/row
        budget += 4 * shards                       # survivor counts
    if n_shards:
        budget += 4 * n_shards                     # shard_bad counts
    return budget + 64


def check_output_budget(fetched, n_words: int, row_capacity: int, *,
                        filtered: bool, n_shards: int = 0) -> list:
    """ir-output-budget: fetched bytes vs the layout budget."""
    actual = output_bytes(fetched)
    budget = output_budget_bytes(n_words, row_capacity, filtered=filtered,
                                 n_shards=n_shards)
    if actual <= budget:
        return []
    per_row = actual / max(row_capacity, 1)
    return [(f"bytes={actual}>budget={budget}",
             f"dispatch fetches {actual} bytes ({per_row:.1f} B/row) "
             f"against a {budget}-byte budget for this layout ({n_words} "
             f"packed words/row): a fetch grew beyond packed words + "
             f"filter metadata")]


def egress_output_budget_bytes(row_capacity: int, total_width: int,
                               n_fields: int) -> int:
    """The render's budget (ops/egress.py): the left-aligned text buffer
    — row_capacity × ΣW uint8 bytes where ΣW is the plan's total
    rendered field width — plus one int32 length per rendered field per
    row, plus 64 bytes of fixed slack."""
    return row_capacity * total_width + 4 * row_capacity * n_fields + 64


def check_egress_output_budget(fetched, row_capacity: int,
                               total_width: int, n_fields: int) -> list:
    """ir-egress-output-budget: fetched bytes vs the egress plan's
    encoded-bytes budget."""
    actual = output_bytes(fetched)
    budget = egress_output_budget_bytes(row_capacity, total_width,
                                        n_fields)
    if actual <= budget:
        return []
    per_row = actual / max(row_capacity, 1)
    return [(f"bytes={actual}>budget={budget}",
             f"render fetches {actual} bytes ({per_row:.1f} B/row) "
             f"against a {budget}-byte budget (ΣW={total_width}, "
             f"{n_fields} rendered fields): an output grew beyond the "
             f"declared wire widths")]


def check_canonical_dedup(desc_a: bytes, desc_b: bytes, digest_a: str,
                          digest_b: str,
                          words_equal: "bool | None" = None) -> list:
    """ir-canonical-dedup: two spec permutations of one canonical layout
    must give byte-identical descriptors, one library, and (where they
    were launched) the same words."""
    out = []
    if desc_a != desc_b:
        out.append(("permutation-descriptor-differs",
                    "column-permuted specs that share a canonical layout "
                    "gave DIFFERENT kernel descriptors: canonicalization "
                    "is not collapsing them to one layout (cache-key "
                    "aliasing / prewarm coverage regression)"))
    if digest_a != digest_b:
        out.append(("permutation-library-differs",
                    "column-permuted specs selected different kernel "
                    "libraries: one library must serve every layout"))
    if words_equal is False:
        out.append(("permutation-words-differ",
                    "column-permuted specs that share a canonical layout "
                    "gave different words on the same canonical input"))
    return out
