"""Memory-safety harness for the port's native framer.

The framer parses untrusted walsender bytes in C (`native/framer.c`), so
this run is its safety net: build `framer.c` with AddressSanitizer and
UBSan (`-fno-sanitize-recover`: any out-of-bounds read or write, overflow
or misaligned access aborts the child), then hammer it in child
processes that load the instrumented library
(`native.FRAMER_SO_ENV`) with

  1. the structured-mutation fuzz target `framer` (`testing/fuzz.py`:
     valid pgoutput streams, byte mutations, truncations);
  2. the framer differentials: random valid streams of every message
     kind (begin, insert, update with no, a key or a full old tuple,
     delete, commit; text, binary, NULL and unchanged-TOAST fields)
     framed by C against the port's Python codec
     (`postgres/codec/pgoutput.decode_logical_message`), field by field,
     and a truncated message that must stop the framing at its index;
  3. the pack/gather hammer: `pack_bmat`, `pack_bmat_nibble` and
     `gather_string` over framed batches with adversarial widths, fields
     that end at the buffer's edge and a gather capacity too small.

The port's copy of `scripts/sanitize_framer.py`, pointed at the port's
own `native/framer.c`. Exit 0: no finding; 77 (the automake SKIP
convention): the compiler has no sanitizers here; else a finding.

    python -m etl_tpu_torch.testing.sanitize_framer [--seconds N]
        [--seed N]
"""

from __future__ import annotations

import argparse
import os
import random
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SRC = ROOT / "etl_tpu_torch" / "native" / "framer.c"
SKIP = 77
DEFAULT_SEED = 20260729


def _cc() -> str:
    return os.environ.get("CC", "cc")


def build_asan_so(out_dir: Path) -> Path:
    so = out_dir / "_framer_asan.so"
    subprocess.run(
        [_cc(), "-O1", "-g", "-fsanitize=address,undefined",
         "-fno-sanitize-recover=all", "-shared", "-fPIC", str(SRC), "-o",
         str(so)], check=True, capture_output=True, timeout=180)
    return so


def find_libasan() -> str:
    out = subprocess.run([_cc(), "-print-file-name=libasan.so"],
                         capture_output=True, text=True, check=True)
    path = out.stdout.strip()
    if not path or path == "libasan.so" or not os.path.exists(path):
        raise RuntimeError("libasan.so not found (no gcc sanitizers)")
    return path


def run_child(so: Path, args: list[str]) -> int:
    from ..native import FRAMER_SO_ENV

    env = dict(os.environ)
    env.update({
        # the library's ASan runtime must be initialised before python
        "LD_PRELOAD": find_libasan(),
        FRAMER_SO_ENV: str(so),
        # python leaks by design; abort only on memory errors
        "ASAN_OPTIONS": "detect_leaks=0,abort_on_error=1",
        "UBSAN_OPTIONS": "halt_on_error=1,print_stacktrace=1",
        "PYTHONPATH": f"{ROOT}{os.pathsep}" + os.environ.get(
            "PYTHONPATH", ""),
    })
    return subprocess.run([sys.executable, *args], env=env,
                          cwd=str(ROOT)).returncode


def _loaded(so: str) -> None:
    """Child: the instrumented library must be the one loaded (a run on
    the -O3 build would prove nothing)."""
    from .. import native

    got = native.load_library()
    assert got.source == "override" and got.lib._name == so, \
        (got.source, got.lib._name)
    print(f"sanitized framer loaded: {so}", flush=True)


# -- the framer differentials --------------------------------------------------


def _draw_tuple(rng: random.Random, n_cols: int, toast: bool) -> tuple:
    """(values, kinds) of one TupleData: text, binary, NULL and, where
    `toast`, unchanged-TOAST fields; empty and long values included."""
    from ..postgres.codec import pgoutput as pg

    values, kinds = [], []
    for _ in range(n_cols):
        c = rng.random()
        if c < 0.15:
            values.append(None)
            kinds.append(pg.TUPLE_NULL)
        elif toast and c < 0.25:
            values.append(None)
            kinds.append(pg.TUPLE_UNCHANGED_TOAST)
        else:
            n = rng.choice((0, 1, 7, rng.randint(0, 300)))
            values.append(bytes(rng.randrange(256) for _ in range(n)))
            kinds.append(pg.TUPLE_BINARY if c > 0.9 else pg.TUPLE_TEXT)
    return values, kinds


def _draw_stream(rng: random.Random, n_cols: int) -> list[bytes]:
    """A valid pgoutput stream: a begin, row messages of every kind, a
    commit."""
    import struct

    from ..postgres.codec import pgoutput as pg

    msgs = [pg.encode_begin(rng.randrange(1 << 40), rng.randrange(1 << 50),
                            rng.randrange(1 << 31))]
    for _ in range(rng.randint(1, 24)):
        relid = rng.randrange(1, 1 << 31)
        c = rng.random()
        if c < 0.4:
            vals, kinds = _draw_tuple(rng, n_cols, False)
            msgs.append(pg.encode_insert(relid, vals, kinds))
        elif c < 0.75:
            new, new_kinds = _draw_tuple(rng, n_cols, True)
            old, _ = _draw_tuple(rng, n_cols, False)
            which = rng.choice(("none", "key", "old"))
            msg = bytearray(b"U" + struct.pack(">I", relid))
            if which != "none":
                msg += (b"K" if which == "key" else b"O") \
                    + pg.write_tuple_data(old)
            msg += b"N" + pg.write_tuple_data(new, new_kinds)
            msgs.append(bytes(msg))
        else:
            old, _ = _draw_tuple(rng, n_cols, False)
            msgs.append(pg.encode_delete(relid, old,
                                         full_old=rng.random() < 0.5))
    msgs.append(pg.encode_commit(rng.randrange(1 << 40),
                                 rng.randrange(1 << 40),
                                 rng.randrange(1 << 50)))
    return msgs


def _check_tuple(buf, framed, i: int, side: str, tup) -> None:
    from ..native import FLAG_BINARY, FLAG_NULL, FLAG_TOAST, FLAG_VALUE
    from ..postgres.codec import pgoutput as pg

    off = getattr(framed, f"{side}_off")[i]
    ln = getattr(framed, f"{side}_len")[i]
    flag = getattr(framed, f"{side}_flag")[i]
    want_flag = {pg.TUPLE_TEXT: FLAG_VALUE, pg.TUPLE_BINARY: FLAG_BINARY,
                 pg.TUPLE_NULL: FLAG_NULL,
                 pg.TUPLE_UNCHANGED_TOAST: FLAG_TOAST}
    for c, (kind, value) in enumerate(zip(tup.kinds, tup.values)):
        assert flag[c] == want_flag[kind], (i, side, c, flag[c], kind)
        if value is None:
            assert ln[c] == 0, (i, side, c)
        else:
            got = bytes(buf[off[c]:off[c] + ln[c]])
            assert got == value, (i, side, c)


def framer_case(rng: random.Random) -> None:
    """One differential case: the C framer against the port's codec on a
    valid stream, then the same stream with one row message cut short."""
    import numpy as np

    from ..native import frame_pgoutput
    from ..postgres.codec import pgoutput as pg

    n_cols = rng.randint(1, 6)
    msgs = _draw_stream(rng, n_cols)
    buf = b"".join(msgs)
    lens = np.array([len(m) for m in msgs], dtype=np.int32)
    offs = np.zeros(len(msgs), dtype=np.int64)
    np.cumsum(lens[:-1], out=offs[1:])
    framed, bad = frame_pgoutput(buf, offs, lens, n_cols)
    assert bad == -1, bad
    raw = np.frombuffer(buf, np.uint8)
    for i, m in enumerate(msgs):
        assert framed.kind[i] == m[0], (i, framed.kind[i], m[0])
        msg = pg.decode_logical_message(m)
        if isinstance(msg, pg.InsertMessage):
            assert framed.relid[i] == msg.relation_id
            assert framed.old_kind[i] == 0
            _check_tuple(raw, framed, i, "new", msg.new_tuple)
        elif isinstance(msg, pg.UpdateMessage):
            assert framed.relid[i] == msg.relation_id
            old = msg.old_tuple if msg.old_tuple is not None \
                else msg.key_tuple
            assert framed.old_kind[i] == (
                0 if old is None else ord("O" if msg.old_tuple else "K"))
            if old is not None:
                _check_tuple(raw, framed, i, "old", old)
            _check_tuple(raw, framed, i, "new", msg.new_tuple)
        elif isinstance(msg, pg.DeleteMessage):
            assert framed.relid[i] == msg.relation_id
            old = msg.old_tuple if msg.old_tuple is not None \
                else msg.key_tuple
            assert framed.old_kind[i] == ord(
                "O" if msg.old_tuple is not None else "K")
            _check_tuple(raw, framed, i, "old", old)
        else:
            assert framed.relid[i] == 0 and framed.old_kind[i] == 0
    # one row message cut short: framing stops at its index, the earlier
    # messages framed as before
    rows = [i for i, m in enumerate(msgs) if m[:1] in (b"I", b"U", b"D")]
    cut = rng.choice(rows)
    short = list(msgs)
    short[cut] = msgs[cut][:rng.randrange(1, len(msgs[cut]))]
    buf2 = b"".join(short)
    lens2 = np.array([len(m) for m in short], dtype=np.int32)
    offs2 = np.zeros(len(short), dtype=np.int64)
    np.cumsum(lens2[:-1], out=offs2[1:])
    framed2, bad2 = frame_pgoutput(buf2, offs2, lens2, n_cols)
    assert bad2 == cut, (bad2, cut)
    assert (framed2.kind[:cut] == framed.kind[:cut]).all()
    # the same stream read with one column too many fails at the first
    # row message
    _, bad3 = frame_pgoutput(buf, offs, lens, n_cols + 1)
    assert bad3 == rows[0], (bad3, rows[0])


def differentials(seconds: float, seed: int) -> int:
    """Child: `framer_case` under a wall-clock budget (at least 50
    cases); returns the cases run."""
    deadline = time.monotonic() + seconds
    cases = 0
    while cases < 50 or time.monotonic() < deadline:
        case_seed = seed + cases
        try:
            framer_case(random.Random(case_seed))
        except AssertionError as e:
            raise AssertionError(
                f"framer differential failed at seed {case_seed}: {e}") \
                from e
        cases += 1
    print(f"differentials: {cases} cases OK", flush=True)
    return cases


# -- the pack/gather hammer ---------------------------------------------------


def hammer(seconds: float, seed: int) -> int:
    """Child: randomized pack_bmat / pack_bmat_nibble / gather_string
    calls over framed batches, with adversarial widths (negative, 0,
    past the 255 cap), fields ending at the buffer's edge and a gather
    capacity that must truncate, not overflow. Returns the cases run."""
    import numpy as np

    from .. import native
    from ..postgres.codec import pgoutput

    rng = random.Random(seed)
    deadline = time.monotonic() + seconds
    cases = 0
    while cases < 20 or time.monotonic() < deadline:
        n_cols = rng.randint(1, 6)
        msgs = []
        for _ in range(rng.randint(1, 32)):
            fields = [None if rng.random() < 0.15 else
                      str(rng.randrange(10 ** rng.randint(1, 12))).encode()
                      for _ in range(n_cols)]
            msgs.append(pgoutput.encode_insert(rng.randrange(1, 1 << 31),
                                               fields))
        buf = b"".join(msgs)
        lens = np.array([len(m) for m in msgs], dtype=np.int32)
        offs = np.zeros(len(msgs), dtype=np.int64)
        np.cumsum(lens[:-1], out=offs[1:])
        framed, _ = native.frame_pgoutput(np.frombuffer(buf, np.uint8),
                                          offs, lens, n_cols)
        R, data = framed.n_msgs, framed.buf
        dense = [c for c in range(n_cols) if rng.random() < 0.8]
        widths = [rng.choice((-7, 0, 1, 3, 12, 32, 300)) for _ in dense]
        tw = max(1, sum(min(w, 255) for w in widths))
        lens_out = np.zeros((R, max(1, len(dense))), dtype=np.uint8)
        if dense:
            native.pack_bmat(data, framed.new_off, framed.new_len,
                             np.array(dense, np.int32),
                             np.array(widths, np.int32),
                             np.zeros((R, tw), dtype=np.uint8), lens_out)
            nib_tw = max(1, sum(min(w, 255) for w in widths) // 2 + 1)
            native.pack_bmat_nibble(data, framed.new_off, framed.new_len,
                                    np.array(dense, np.int32),
                                    np.array(widths, np.int32),
                                    np.zeros((R, nib_tw), np.uint8),
                                    lens_out, np.zeros(R, dtype=np.uint8))
        for cap in (3, 1 << 16):
            col = rng.randrange(n_cols)
            valid = (framed.new_flag[:, col] == native.FLAG_VALUE) \
                .astype(np.uint8)
            native.gather_string(data, framed.new_off, framed.new_len,
                                 valid, col, np.zeros(R + 1, np.int32),
                                 np.zeros(cap, dtype=np.uint8))
        cases += 1
    print(f"hammer: {cases} cases OK", flush=True)
    return cases


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="etl_tpu_torch.testing.sanitize_framer")
    p.add_argument("--seconds", type=float, default=10.0,
                   help="the budget of each step under the sanitizers")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--child", choices=("loaded", "differentials",
                                       "hammer"), default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--so", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    seed = DEFAULT_SEED if args.seed is None else args.seed
    if args.child == "loaded":
        _loaded(args.so)
        return 0
    if args.child == "differentials":
        differentials(args.seconds, seed)
        return 0
    if args.child == "hammer":
        hammer(args.seconds, seed)
        return 0

    with tempfile.TemporaryDirectory(prefix="etl-sanitize-") as tmp:
        try:
            find_libasan()
            so = build_asan_so(Path(tmp))
        except (RuntimeError, OSError, subprocess.CalledProcessError) as e:
            detail = getattr(e, "stderr", b"") or b""
            print(f"SKIP: sanitizer toolchain unavailable: {e} "
                  f"{detail.decode(errors='replace')[-300:]}",
                  file=sys.stderr)
            return SKIP
        me = "etl_tpu_torch.testing.sanitize_framer"
        steps = [
            ("the instrumented library did not load",
             ["-m", me, "--child", "loaded", "--so", str(so)]),
            ("the fuzz target framer",
             ["-m", "etl_tpu_torch.testing.fuzz", "--target", "framer",
              "--seconds", str(args.seconds), "--seed", str(seed)]),
            ("the framer differentials",
             ["-m", me, "--child", "differentials", "--seconds",
              str(args.seconds), "--seed", str(seed)]),
            ("the pack/gather hammer",
             ["-m", me, "--child", "hammer", "--seconds", str(args.seconds),
              "--seed", str(seed)]),
        ]
        for what, child in steps:
            rc = run_child(so, child)
            if rc != 0:
                print(f"FAIL: {what} (exit code {rc})", file=sys.stderr)
                return rc
    print(f"sanitize_framer: no findings (fuzz, differentials and the "
          f"pack/gather hammer, {args.seconds:g} s each, seed {seed}, "
          f"under ASan + UBSan)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
