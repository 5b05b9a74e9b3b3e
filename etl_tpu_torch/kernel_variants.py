"""Times variants of the decode kernels K1 and K2 on the card.

    python -m etl_tpu_torch.kernel_variants [--names a,b,...]

Each variant is `csrc/decode_pack.cu` with one design choice taken back
by a textual substitution (VARIANTS). All variants are built with nvcc
at once, into a temporary directory, and then, one after the other, put
in place of the built library under the wrappers of
`ops/decode_kernel.py`, so every variant runs the same wrapper code. Each
is held bit for bit against the plain versions and timed with
`bench.device_ms` (L2 flushed, the card held while the host enqueues),
three times, at four shapes: K1 on the pgbench main path's specs at
262,144 rows ("k1", chip_smoke.py's 3a), K2 and K2c under `bid <= 5` on
them ("k2", "k2c", 3d(i); K2c held in `words[:, :count]`, the mask and
the count; "k2c_one_row" with one row a thread, 256 threads a block;
"k2c_dead" with every row dead, so nothing is parsed) and K1
on every dense kind raw at 65,536 rows ("k1_raw", 3b). A "probe" takes
out a part of K2c that its output needs, to time the rest: its output
differs. Prints one JSON line per variant, with ptxas's registers and stack
frame per kernel, and then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

# name -> substitutions (old, new) in the kernel source; each old text
# must occur exactly once
VARIANTS = {
    "as built": [],
    # K1 with one row a thread on the integer layouts too
    "one row a thread": [
        ("return launch(false, a, tile_rows, rows_per_thread, stream);",
         "return launch(false, a, tile_rows, 1, stream);")],
    # nibble integers through the symbol loop, as the other kinds
    "symbol loop for nibble ints": [
        ("if (f[0].tiled && f[0].nibble && f[0].w <= 8) {",
         "if (false) {"),
        ("} else if (f[0].tiled && f[0].nibble && f[0].w <= 16) {",
         "} else if (false) {")],
    # the tile staged by loads and stores that wait for each copy
    "synchronous staging": [
        ('asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n" ::"r"(\n'
         '                     (unsigned)__cvta_generic_to_shared(dst)),\n'
         '                 "l"(src));',
         "*reinterpret_cast<uint4 *>(dst) = "
         "*reinterpret_cast<const uint4 *>(src);"),
        ('asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\\n" ::"r"(\n'
         '                     (unsigned)__cvta_generic_to_shared(dst)),\n'
         '                 "l"(src));',
         "*reinterpret_cast<uint32_t *>(dst) = "
         "*reinterpret_cast<const uint32_t *>(src);")],
    # rows of a multiple of 8 bytes not stored one word apart
    "unpadded tile stride": [
        ("return row_bytes % 8 == 0 ? row_bytes + 4 : row_bytes;",
         "return row_bytes;")],
    # K2c's status words read and written relaxed (no release/acquire)
    "K2c relaxed status words": [
        ('asm volatile("st.release.gpu.global.u64 [%0], %1;\\n"',
         'asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\\n"'),
        ('asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\\n"',
         'asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\\n"')],
    # K2c's two-rows-a-thread kernel without its register cap (8 blocks an
    # SM: all 1,024 blocks of the main path in one wave)
    "K2c without launch bounds": [
        ("__global__ void __launch_bounds__(FILTER_BLOCK / 2, 8)",
         "__global__ void")],
    # K2c's spin on relaxed loads, then one acquire-release fence
    "K2c relaxed spin then acq_rel fence": [
        ('asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\\n"',
         'asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\\n"'),
        ("        } while (!__all_sync(0xFFFFFFFFu, status_current(s, a.epoch)));",
         "        } while (!__all_sync(0xFFFFFFFFu, status_current(s, a.epoch)));\n"
         '        asm volatile("fence.acq_rel.gpu;" ::: "memory");')],
    # probes (wrong output, timed only): K2c without its look-back (each
    # block's survivors go to its own first columns); also without the
    # ticket (blocks in blockIdx order); without the scatter
    "probe: no look-back": [
        ("            pre = look_back(a, blk);",
         "            pre = blk * FILTER_BLOCK;")],
    "probe: no look-back and no ticket": [
        ("            pre = look_back(a, blk);",
         "            pre = blk * FILTER_BLOCK;"),
        ("        s_blk = (int64_t)(atomicAdd(a.ticket, 1ull) - a.ticket_base);",
         "        s_blk = blockIdx.x;")],
    "probe: no scatter": [
        ("        scatter_row(a, wt, ballots, s_pre, i);", "        ;")],
}


def variant_source(source: str, subs: list) -> str:
    for old, new in subs:
        if source.count(old) != 1:
            raise ValueError(f"variant text not found once: {old!r}")
        source = source.replace(old, new)
    return source


def ptxas_summary(log: str) -> dict:
    """kernel name -> 'N registers, S bytes stack frame' from -Xptxas -v."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '.*?"
                      r"(decode_pack_kernel|filter_pack_compact2?_kernel"
                      r"|filter_pack_kernel|compact_kernel)"
                      r"(ILi(\d+)E)?", line)
        if m:
            name = m.group(1) + (f"<{m.group(3)}>" if m.group(3) else "")
        m = re.search(r"(\d+) bytes stack frame", line)
        if m and name:
            out[name] = f"{m.group(1)} bytes stack frame"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = f"{m.group(1)} registers, " + out.get(name, "")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="kernel_variants")
    ap.add_argument("--names", default=",".join(VARIANTS))
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    names = args.names.split(",")
    with tempfile.TemporaryDirectory(prefix="kernel_variants-") as tmp:
        return _run(names, Path(tmp), args.seed)


def _run(names: list, tmp: Path, seed: int) -> int:
    import ctypes

    import numpy as np
    import torch

    from . import bench
    from .models.pgtypes import CellKind as K
    from .ops import decode_kernel as dk
    from .ops.bitpack import (filter_pack_plain, parse_and_pack_plain,
                              saturation_width)
    from .ops.engine import DeviceDecoder
    from .ops.predicate import compile_row_filter, parse_row_filter
    from .ops.wal import concat_payloads, stage_wal_batch
    from .testing import field_matrix, filter_case

    source = dk.SOURCE.read_text()
    procs = {}
    for i, name in enumerate(names):
        cu = tmp / f"v{i}.cu"
        cu.write_text(variant_source(source, VARIANTS[name]))
        procs[name] = subprocess.Popen(
            dk.nvcc_command(cu, tmp / f"v{i}.so"), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    logs = {name: p.communicate(timeout=600)[0] for name, p in procs.items()}

    rows = bench.N_ROWS
    schema = bench.make_schema()
    staged = stage_wal_batch(*concat_payloads(bench.build_workload(rows)),
                             4).staged
    dec = DeviceDecoder(schema, device="cuda")
    specs = dec._specs(staged, dec._widths(staged))
    fschema = schema.with_row_predicate(parse_row_filter("bid <= 5"))
    pred = compile_row_filter(fschema.row_predicate, fschema)

    def tiled(arrays, n):
        return [torch.from_numpy(np.ascontiguousarray(
            np.tile(a, (-(-n // len(a)),) + (1,) * (a.ndim - 1))[:n])).cuda()
            for a in arrays]

    rng = np.random.default_rng(seed)
    pg = tiled(filter_case(specs, 16_384, rng, True), rows)
    dead = pg[:2] + [torch.zeros_like(pg[2])]  # every row dead: no parse
    raw_kinds = [(K.BOOL, 4), (K.I16, 8), (K.I32, 12), (K.U32, 12),
                 (K.I64, 20), (K.F32, 16), (K.F64, 24), (K.DATE, 16),
                 (K.TIME, 16), (K.TIMESTAMP, 32), (K.TIMESTAMPTZ, 32)]
    raw_specs = tuple((i, k, w, (min(w, saturation_width(k)) + 1) & ~1)
                      for i, (k, w) in enumerate(raw_kinds))
    raw = tiled(field_matrix(raw_specs, 4_096, rng, False), 65_536)
    cases = {
        "k1": (lambda: dk.decode_pack(pg[0], pg[1], specs, True),
               lambda: parse_and_pack_plain(pg[0], pg[1], specs, True)),
        "k2": (lambda: dk.filter_pack(*pg, specs, True, pred),
               lambda: filter_pack_plain(*pg, specs, True, pred,
                                         dk.FILTER_BLOCK)),
        "k2c": (lambda: dk.filter_pack_compact(*pg, specs, True, pred),
                lambda: parse_and_pack_plain(pg[0], pg[1], specs, True,
                                             pred=pred, row_flags=pg[2])),
        "k2c_one_row": (lambda: dk.filter_pack_compact(*pg, specs, True, pred,
                                                       rpt=1),
                        lambda: parse_and_pack_plain(pg[0], pg[1], specs,
                                                     True, pred=pred,
                                                     row_flags=pg[2])),
        "k2c_dead": (lambda: dk.filter_pack_compact(*dead, specs, True, pred),
                     lambda: parse_and_pack_plain(dead[0], dead[1], specs,
                                                  True, pred=pred,
                                                  row_flags=dead[2])),
        "k1_raw": (lambda: dk.decode_pack(raw[0], raw[1], raw_specs, False),
                   lambda: parse_and_pack_plain(raw[0], raw[1], raw_specs,
                                                False)),
    }

    def same(case, got, want) -> bool:
        if case.startswith("k2c"):  # K2c writes no column past the count
            n = int(want[2][0])
            got = (got[0][:, :n], got[1], got[2])
            want = (want[0][:, :n], want[1], want[2])
        return all(torch.equal(g.view(torch.int32), w.view(torch.int32))
                   for g, w in zip(got, want))

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda").zero_
    for i, name in enumerate(names):
        rec = {"variant": name, "built": procs[name].returncode == 0}
        if rec["built"]:
            dk._lib = dk.bind(ctypes.CDLL(str(tmp / f"v{i}.so")))
            dk._scan_states.clear()  # a probe may leave the tickets behind
            rec["ptxas"] = ptxas_summary(logs[name])
            for case, (kernel, plain) in cases.items():
                got, want = kernel(), plain()
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                rec[f"{case}_identical"] = same(case, got, want)
                rec[f"{case}_ms"] = [bench.device_ms(kernel, 50, flush)
                                     for _ in range(3)]
        else:
            rec["log"] = logs[name][-2000:]
        print(json.dumps(rec), flush=True)
    dk._lib = None
    print(bench.card_info(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
