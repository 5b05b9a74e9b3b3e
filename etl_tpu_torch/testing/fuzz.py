"""Fuzz targets for the codec parsers, the native framer and the
destination wire encoders.

Reference parity: cargo-fuzz targets `parse_copy_row`, `parse_text_cell`,
`numeric_text_roundtrip`, `parse_bytea_hex_string`
(fuzz/fuzz_targets/ + src/fuzzing.rs). No coverage-guided fuzzer exists in
this environment, so this is a seeded random byte fuzzer with structured
mutations (truncate/splice/bitflip over valid corpora), a wall-clock
budget, and crash seeds printed for replay — the same contract the
reference's fuzz entry points enforce:

  THE PARSERS MUST NEVER CRASH UNCONTROLLED. Any input either parses or
  raises a typed EtlError; the native framer must flag malformed frames
  (bad_from) or raise EtlError, never segfault or throw bare exceptions.

Copy of the reference's `etl_tpu/testing/fuzz.py`, run against the
port's own codecs, framer, `bq_proto`, `pb_reader` and `snowpipe`. Each
target is split in two: `draw_<target>(rng)` draws one case's inputs as
plain data, `check_<target>(inputs)` holds the port to the contract on
them, and the target is the one after the other. A second implementation
of the same format can be held to the port's on the drawn inputs.

Two targets are refused with a typed CONFIG_INVALID instead of run, both
by `run_target` before its first case and by the target itself:
`avro_ocf` needs the Iceberg metadata writer (`destinations/
iceberg_meta.py`) and `testing/avro_reader.py`, which the port does not
have yet (ROADMAP.md, queue 1 entry 7); `snowpipe_batches` needs the
`zstandard` package where it is not installed.

Run ad hoc:  python -m etl_tpu_torch.testing.fuzz --seconds 30 [--seed N]
"""

from __future__ import annotations

import importlib.util
import random
import time

from ..models.errors import ErrorKind, EtlError
from ..models.pgtypes import Oid

# every OID the text parser dispatches on — fuzz coverage must include
# each branch
_OIDS = [Oid.BOOL, Oid.INT2, Oid.INT4, Oid.INT8, Oid.FLOAT4, Oid.FLOAT8,
         Oid.NUMERIC, Oid.TEXT, Oid.VARCHAR, Oid.BPCHAR, Oid.DATE, Oid.TIME,
         Oid.TIMETZ, Oid.TIMESTAMP, Oid.TIMESTAMPTZ, Oid.UUID, Oid.JSON,
         Oid.JSONB, Oid.BYTEA, Oid.INTERVAL]

_SEED_TEXTS = [
    "0", "-1", "12345678901234567890123456789", "+5", "-", "--", "1e309",
    "1.5", "-0.0", "NaN", "Infinity", "-Infinity", "nan", "1e", "e1", ".",
    "2024-02-29", "0001-01-01", "9999-12-31", "0044-03-15 BC", "infinity",
    "-infinity", "24:00:00", "23:59:60", "12:00:00.1234567",
    "2024-05-01 12:34:56.789+02", "2024-05-01 12:34:56-15:59:59",
    "a0eebc99-9c0b-4ef8-bb6d-6bb9bd380a11", "{}", "[1,2]", "null",
    '{"k": "v"}', "\\xdeadbeef", "\\x", "\\xg", "1 year 2 mons",
    "t", "f", "true", "", " ", "\t", "\\N", "\\", "{1,2,3}", "{NULL}",
    '{"a","b"}', "0.000000000000000012345", "9" * 40,
]

_MUT_CHARS = "0123456789-+.:eE aftTxX{}\\\"',N\x00\x7fé"


def _mutate(rng: random.Random, s: str) -> str:
    ops = rng.randint(1, 3)
    out = s
    for _ in range(ops):
        c = rng.random()
        if c < 0.25 and out:
            i = rng.randrange(len(out))
            out = out[:i] + rng.choice(_MUT_CHARS) + out[i + 1:]
        elif c < 0.5:
            i = rng.randrange(len(out) + 1)
            out = out[:i] + rng.choice(_MUT_CHARS) + out[i:]
        elif c < 0.7 and out:
            i = rng.randrange(len(out))
            out = out[:i] + out[i + 1:]
        elif c < 0.85 and out:
            i, j = sorted((rng.randrange(len(out) + 1),
                           rng.randrange(len(out) + 1)))
            other = rng.choice(_SEED_TEXTS)
            out = out[:i] + other + out[j:]
        else:
            out = out * rng.randint(1, 3)
    return out[:4096]


class FuzzFailure(AssertionError):
    def __init__(self, target: str, seed: int, case: int, detail: str):
        super().__init__(
            f"fuzz target {target} failed at seed={seed} case={case}: "
            f"{detail}\nreplay: python -m etl_tpu_torch.testing.fuzz "
            f"--target {target} --seed {seed}")


# -- text cells ----------------------------------------------------------------


def draw_parse_text_cell(rng: random.Random) -> tuple:
    """(text, oid)."""
    text = _mutate(rng, rng.choice(_SEED_TEXTS))
    return text, rng.choice(_OIDS)


def check_parse_text_cell(inputs: tuple) -> None:
    from ..postgres.codec.text import parse_cell_text

    text, oid = inputs
    try:
        parse_cell_text(text, oid)
    except EtlError:
        pass  # typed rejection is the contract


def fuzz_parse_text_cell(rng: random.Random, _ignored=None) -> None:
    check_parse_text_cell(draw_parse_text_cell(rng))


# -- COPY rows -----------------------------------------------------------------


def draw_parse_copy_row(rng: random.Random) -> tuple:
    """(line bytes, column oids)."""
    n_cols = rng.randint(1, 6)
    oids = [rng.choice(_OIDS) for _ in range(n_cols)]
    fields = [_mutate(rng, rng.choice(_SEED_TEXTS))
              for _ in range(rng.randint(0, n_cols + 1))]
    line = "\t".join(fields).encode("utf-8", "surrogatepass")[:2048]
    return line, oids


def check_parse_copy_row(inputs: tuple) -> None:
    from ..postgres.codec.copy_text import parse_copy_row

    line, oids = inputs
    try:
        parse_copy_row(line, oids)
    except (EtlError, UnicodeDecodeError):
        pass


def fuzz_parse_copy_row(rng: random.Random, _ignored=None) -> None:
    check_parse_copy_row(draw_parse_copy_row(rng))


# -- numerics ------------------------------------------------------------------


def draw_numeric_roundtrip(rng: random.Random) -> tuple:
    """(valid numeric text, a mutated form of it)."""
    digits = rng.randint(1, 35)
    scale = rng.randint(0, digits)
    n = rng.randint(0, 10**digits - 1)
    s = str(n).rjust(scale + 1, "0")
    text = (("-" if rng.random() < 0.5 else "")
            + (s[:-scale] + "." + s[-scale:] if scale else s))
    return text, _mutate(rng, text)


def check_numeric_roundtrip(inputs: tuple) -> None:
    """Valid numeric text must survive parse → pg_text exactly (the
    reference numeric_text_roundtrip target); arbitrary text must parse or
    fail typed."""
    from ..models.cell import PgNumeric
    from ..postgres.codec.text import parse_cell_text

    text, mutated = inputs
    v = parse_cell_text(text, Oid.NUMERIC)
    assert isinstance(v, PgNumeric)
    assert v.pg_text() == text, (v.pg_text(), text)
    # and the mutated form must never crash untyped
    try:
        parse_cell_text(mutated, Oid.NUMERIC)
    except EtlError:
        pass


def fuzz_numeric_roundtrip(rng: random.Random, _ignored=None) -> None:
    check_numeric_roundtrip(draw_numeric_roundtrip(rng))


# -- bytea ---------------------------------------------------------------------


def draw_bytea_hex(rng: random.Random) -> tuple:
    """The two texts: the body behind `\\x`, and the body alone."""
    body = "".join(rng.choice("0123456789abcdefABCDEFxg \\")
                   for _ in range(rng.randint(0, 64)))
    return f"\\x{body}", body


def check_bytea_hex(inputs: tuple) -> None:
    from ..postgres.codec.text import parse_cell_text

    for text in inputs:
        try:
            parse_cell_text(text, Oid.BYTEA)
        except EtlError:
            pass


def fuzz_bytea_hex(rng: random.Random, _ignored=None) -> None:
    check_bytea_hex(draw_bytea_hex(rng))


# -- the native framer ---------------------------------------------------------


def draw_framer(rng: random.Random) -> tuple:
    """(buffer, message offsets, message lengths, column count): up to 8
    messages, valid inserts and begins or random bytes, one of them with
    a bit flipped half the time."""
    import numpy as np

    from ..postgres.codec import pgoutput

    msgs = []
    for _ in range(rng.randint(1, 8)):
        c = rng.random()
        if c < 0.4:  # valid insert, possibly corrupted below
            msgs.append(pgoutput.encode_insert(
                rng.randrange(1, 1 << 31),
                [str(rng.randrange(1000)).encode()
                 for _ in range(rng.randint(0, 4))]))
        elif c < 0.6:
            msgs.append(pgoutput.encode_begin(rng.randrange(1 << 40),
                                              rng.randrange(1 << 50), 7))
        else:
            msgs.append(bytes(rng.randrange(256)
                              for _ in range(rng.randint(0, 64))))
    if msgs and rng.random() < 0.5:  # corrupt one
        i = rng.randrange(len(msgs))
        b = bytearray(msgs[i])
        if b:
            b[rng.randrange(len(b))] ^= 1 << rng.randrange(8)
        msgs[i] = bytes(b)
    buf = b"".join(msgs)
    lens = np.array([len(m) for m in msgs], dtype=np.int32)
    offs = np.zeros(len(msgs), dtype=np.int64)
    np.cumsum(lens[:-1], out=offs[1:])
    return buf, offs, lens, rng.randint(1, 8)


def check_framer(inputs: tuple) -> None:
    """Random bytes through the native pgoutput framer: it must return a
    FramedBatch with bad_from set, or raise EtlError — never crash the
    process or return out-of-bounds offsets."""
    import numpy as np

    from ..native import frame_pgoutput

    buf, offs, lens, n_cols = inputs
    try:
        framed, bad = frame_pgoutput(buf, offs, lens, n_cols)
    except EtlError:
        return
    upto = framed.n_msgs if bad < 0 else bad
    # offsets/lengths within bounds for every framed field
    total = len(buf)
    for arr_off, arr_len in ((framed.new_off[:upto], framed.new_len[:upto]),
                             (framed.old_off[:upto], framed.old_len[:upto])):
        ends = arr_off.astype(np.int64) + arr_len
        assert (arr_off >= 0).all() and (arr_len >= 0).all() \
            and (ends <= total).all(), \
            "framer emitted out-of-bounds field"


def fuzz_framer(rng: random.Random, _ignored=None) -> None:
    check_framer(draw_framer(rng))


# -- Iceberg metadata (Avro OCF) -----------------------------------------------


def _refuse_avro_ocf() -> None:
    raise EtlError(
        ErrorKind.CONFIG_INVALID,
        "fuzz target avro_ocf is not ported to etl_tpu_torch yet: it "
        "round-trips the Iceberg metadata writer (destinations/"
        "iceberg_meta.py) through testing/avro_reader.py, which come with "
        "the lake and Iceberg destinations (ROADMAP.md, queue 1 entry 7)")


def fuzz_avro_ocf(rng: random.Random, _ignored=None) -> None:
    """The Iceberg metadata pair (the OCF writer against the independent
    reader): refused typed until the Iceberg destination is ported."""
    _refuse_avro_ocf()


# -- BigQuery AppendRows -------------------------------------------------------

#: the column kinds of `pb_append_rows`, with how each draws a value
_PB_KINDS = ("INT4", "INT8", "TEXT", "BOOL", "FLOAT8", "NUMERIC")


def _pb_value(rng: random.Random, kind: str):
    if kind == "INT4":
        return rng.randrange(-(1 << 31), 1 << 31)
    if kind == "INT8":
        return rng.randrange(-(1 << 62), 1 << 62)
    if kind == "TEXT":
        return "".join(chr(rng.randrange(32, 0x24F))
                       for _ in range(rng.randint(0, 9)))
    if kind == "BOOL":
        return rng.random() < 0.5
    if kind == "FLOAT8":
        return rng.uniform(-1e12, 1e12)
    return str(rng.randrange(10 ** 12))  # NUMERIC, as its text


def draw_pb_append_rows(rng: random.Random) -> dict:
    """Column kinds (by `Oid` name), the rows' values (None = NULL,
    NUMERIC as text), the request offset, and one bit to flip: its
    position as a fraction of the request's length, and the bit."""
    kinds = [_PB_KINDS[rng.randrange(len(_PB_KINDS))]
             for _ in range(rng.randint(1, 5))]
    rows = [[None if rng.random() < 0.25 else _pb_value(rng, k)
             for k in kinds] for _ in range(rng.randint(1, 4))]
    offset = rng.randrange(1 << 40) if rng.random() < 0.5 else None
    return {"kinds": kinds, "rows": rows, "offset": offset,
            "flip": (rng.random(), rng.randrange(8))}


def pb_request(inputs: dict) -> bytes:
    """The AppendRowsRequest the port's `bq_proto` encodes for `inputs`."""
    from ..destinations import bq_proto
    from ..models.cell import PgNumeric
    from ..models.schema import (ColumnSchema, ReplicatedTableSchema,
                                 TableName, TableSchema)

    kinds = inputs["kinds"]
    schema = ReplicatedTableSchema.with_all_columns(TableSchema(
        999, TableName("public", "fz"),
        tuple(ColumnSchema(f"c{i}", getattr(Oid, k), nullable=True,
                           primary_key_ordinal=1 if i == 0 else None)
              for i, k in enumerate(kinds))))
    rows = []
    for r, values in enumerate(inputs["rows"]):
        values = [PgNumeric(v) if k == "NUMERIC" and v is not None else v
                  for k, v in zip(kinds, values)]
        rows.append(bq_proto.encode_row(schema, values, "UPSERT",
                                        f"{r:016x}"))
    return bq_proto.append_rows_request(
        "projects/p/datasets/d/tables/t/streams/_default",
        bq_proto.row_descriptor(schema), rows, trace_id="fz",
        offset=inputs["offset"])


def flip_bit(buf: bytes, flip: tuple) -> bytes:
    """`buf` with the drawn bit flipped (`draw_pb_append_rows`)."""
    frac, bit = flip
    raw = bytearray(buf)
    raw[min(int(frac * len(raw)), len(raw) - 1)] ^= 1 << bit
    return bytes(raw)


def check_pb_append_rows(inputs: dict) -> None:
    """The BigQuery protobuf pair: a random AppendRowsRequest decoded by
    BOTH decoders — the generic TLV one (bq_proto) and the spec-written
    independent one (pb_reader, which shares no code) — must agree field
    for field; a bit-flipped request must reject typed or parse to
    something that differs, never hang."""
    from ..destinations import bq_proto
    from .pb_reader import decode_append_rows

    buf = pb_request(inputs)
    ind = decode_append_rows(buf)
    own = bq_proto.decode_append_rows_request(buf)
    assert ind["write_stream"] == own.write_stream
    assert ind["trace_id"] == own.trace_id
    assert ind.get("offset") == own.offset
    # full descriptor agreement: (name, number, label, type) 4-tuples
    assert [(f["name"], f["number"], f["label"], f["type"])
            for f in ind["descriptor"]["fields"]] == \
        list(own.descriptor_fields)
    assert len(ind["rows"]) == len(own.serialized_rows) \
        == len(inputs["rows"])
    # row VALUES decoded by both lineages must agree field for field
    assert ind["rows"] == own.decode_rows(), (ind["rows"],
                                              own.decode_rows())
    try:
        decode_append_rows(flip_bit(buf, inputs["flip"]))
    except (ValueError, KeyError):
        pass  # typed rejection is the contract


def fuzz_pb_append_rows(rng: random.Random, _ignored=None) -> None:
    check_pb_append_rows(draw_pb_append_rows(rng))


# -- Snowpipe Streaming row batches --------------------------------------------


def _refuse_without_zstandard() -> None:
    if importlib.util.find_spec("zstandard") is None:
        raise EtlError(
            ErrorKind.CONFIG_INVALID,
            "fuzz target snowpipe_batches needs the zstandard package, "
            "which is not installed here: Snowpipe Streaming row batches "
            "are zstd-compressed (the Snowflake destination is held on "
            "the CPU where zstandard is installed)")


def draw_snowpipe_batches(rng: random.Random) -> list:
    """The NDJSON documents; ~5% of cases feed high-entropy megabyte
    rows so the compressed stream passes BATCH_SPLIT_THRESHOLD and the
    mid-stream split path (row order across batches, the second batch's
    offset range) is really exercised, not vacuously skipped."""
    split_case = rng.random() < 0.05
    gens = [lambda: rng.randrange(-(1 << 60), 1 << 60),
            lambda: "".join(chr(rng.randrange(32, 0x2FF))
                            for _ in range(rng.randint(0, 2000))),
            lambda: None, lambda: rng.random() * 1e6,
            lambda: rng.random() < 0.5,
            lambda: {"nested": [1, "x", None]}]
    n = rng.randint(8, 12) if split_case else rng.randint(1, 40)
    docs = []
    for i in range(n):
        # split rows: 512KB of random bytes → 1MB hex, safely under the
        # 2MB per-row limit; ~4 bits/char entropy keeps zstd near 2:1 so
        # ~8 rows pass the 3.8MB compressed split threshold
        v = rng.randbytes(512 << 10).hex() if split_case \
            else rng.choice(gens)()
        docs.append({"id": i, "v": v, "_cdc_sequence_number": f"{i:016x}"})
    return docs


def snowpipe_batches(docs: list) -> list:
    """The port's `RowBatchBuilder` over `docs`, one row each."""
    from ..destinations.snowpipe import RowBatchBuilder

    b = RowBatchBuilder()
    for doc in docs:
        b.push_row(doc, doc["_cdc_sequence_number"])
    return b.finish()


def check_snowpipe_batches(docs: list) -> None:
    """The Snowpipe streaming-zstd batch builder: random NDJSON rows
    through RowBatchBuilder must re-decode EXACTLY (independent path:
    zstandard decompressor + stdlib json, none of the builder's chunking
    logic) with rows in order across batch splits, correct per-batch row
    counts and offset ranges, and every batch under the API body limit.
    Non-finite floats must reject typed."""
    import json as _json

    _refuse_without_zstandard()
    import zstandard

    from ..destinations.snowpipe import MAX_COMPRESSED_BYTES, RowBatchBuilder

    batches = snowpipe_batches(docs)
    if len(docs) >= 8 and isinstance(docs[0]["v"], str) \
            and len(docs[0]["v"]) == 1 << 20:
        assert len(batches) >= 2, \
            f"split case produced {len(batches)} batch(es)"
    dctx = zstandard.ZstdDecompressor()
    got = []
    row_total = 0
    for rb in batches:
        assert len(rb.data) <= MAX_COMPRESSED_BYTES
        lines = dctx.decompressobj().decompress(rb.data).split(b"\n")
        rows = [_json.loads(ln) for ln in lines if ln]
        assert len(rows) == rb.row_count, (len(rows), rb.row_count)
        # inclusive offset range must be exactly first/last row's token
        assert rb.start_offset == rows[0]["_cdc_sequence_number"]
        assert rb.end_offset == rows[-1]["_cdc_sequence_number"]
        row_total += rb.row_count
        got.extend(rows)
    assert row_total == len(docs) and got == docs, (row_total, len(docs))
    # non-finite floats reject typed (encoding.rs stance)
    b2 = RowBatchBuilder()
    try:
        b2.push_row({"v": float("inf")}, "0")
    except EtlError:
        pass
    else:
        raise AssertionError("non-finite float accepted")


def fuzz_snowpipe_batches(rng: random.Random, _ignored=None) -> None:
    _refuse_without_zstandard()
    check_snowpipe_batches(draw_snowpipe_batches(rng))


TARGETS = {
    "parse_text_cell": fuzz_parse_text_cell,
    "parse_copy_row": fuzz_parse_copy_row,
    "numeric_roundtrip": fuzz_numeric_roundtrip,
    "bytea_hex": fuzz_bytea_hex,
    "framer": fuzz_framer,
    "avro_ocf": fuzz_avro_ocf,
    "pb_append_rows": fuzz_pb_append_rows,
    "snowpipe_batches": fuzz_snowpipe_batches,
}

#: what keeps a target from running here, by target: each raises the
#: typed refusal, or returns when the target can run
REFUSALS = {
    "avro_ocf": _refuse_avro_ocf,
    "snowpipe_batches": _refuse_without_zstandard,
}


def refuse_unavailable(name: str) -> None:
    """Raise the typed CONFIG_INVALID that keeps `name` from running
    here; return if it can run."""
    if name not in TARGETS:
        raise EtlError(ErrorKind.CONFIG_INVALID,
                       f"unknown fuzz target {name!r}; targets: "
                       f"{', '.join(sorted(TARGETS))}")
    refuse = REFUSALS.get(name)
    if refuse is not None:
        refuse()


def run_target(name: str, *, seconds: float = 2.0, seed: int | None = None,
               min_cases: int = 200) -> int:
    """Run one target under a wall-clock budget; returns cases executed.
    Raises FuzzFailure with the replay seed on any contract violation,
    and the target's typed refusal (CONFIG_INVALID) before its first case
    where it cannot run here."""
    refuse_unavailable(name)
    fn = TARGETS[name]
    base_seed = seed if seed is not None else random.randrange(1 << 30)
    deadline = time.monotonic() + seconds
    case = 0
    while case < min_cases or time.monotonic() < deadline:
        case_seed = base_seed + case
        rng = random.Random(case_seed)
        try:
            fn(rng)
        except AssertionError as e:
            raise FuzzFailure(name, base_seed, case, str(e))
        except EtlError:
            pass
        except Exception as e:  # untyped escape = contract violation
            raise FuzzFailure(name, base_seed, case,
                              f"untyped {type(e).__name__}: {e}")
        case += 1
    return case


def main(argv=None) -> int:
    """Run one target (`--target`) or all of them. A target asked for by
    name that cannot run here exits 2 with its typed refusal on stderr;
    a run of all targets prints each refusal on stderr and runs the
    rest."""
    import argparse
    import sys

    p = argparse.ArgumentParser(prog="etl_tpu_torch.testing.fuzz")
    p.add_argument("--target", choices=sorted(TARGETS), default=None)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--seed", type=int, default=None)
    args = p.parse_args(argv)
    names = [args.target] if args.target else sorted(TARGETS)
    for name in names:
        try:
            n = run_target(name, seconds=args.seconds / len(names),
                           seed=args.seed)
        except EtlError as e:
            if e.kind is not ErrorKind.CONFIG_INVALID:
                raise
            print(f"{name}: refused: {e}", file=sys.stderr)
            if args.target:
                return 2
            continue
        print(f"{name}: {n} cases OK")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
