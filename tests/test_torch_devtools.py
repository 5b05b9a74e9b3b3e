"""The port's dev automation (`etl_tpu_torch/devtools.py`) and fuzz
targets (`etl_tpu_torch/testing/fuzz.py`) held to the reference's.

- Every fuzz target, two ways, in one parametrised test: `contract`
  runs the port's `run_target` at `tests/test_fuzz.py`'s pinned seed and
  case count (`avro_ocf` raises its typed refusal instead); `parity`
  draws each case's inputs through the port's `draw_<target>` and runs
  the port's parser, framer or encoder and the reference's on them: the
  same value or the same typed rejection, the same frames, the same
  request and batch bytes.
- `tests/test_fuzz.py`'s devtools cases on the port: `fill-table` over
  the port's fake server, `rotate-encryption-key`.
- `serve-source`: the port's filled database equals the reference's
  `_make_filled_db`, and the command serves it.
- `devtools chaos`: each scenario at 500 rows and 2 s on the per-tuple
  engine and on the CUDA engine's plain versions (`--device cpu`), with
  the reference's checks; without a card and without `--engine cpu` or
  `--device cpu` the command runs nothing.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_devtools.py -q

Tolerance: exact.
"""

import argparse
import asyncio
import json
import os
import random
import subprocess
import sys
import time

import numpy as np
import pytest

from etl_tpu_torch.models.errors import ErrorKind, EtlError
from etl_tpu_torch.testing import fuzz

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FUZZ_SEED = 20260729  # tests/test_fuzz.py's pinned seed
FUZZ_CASES = 300
FUZZ_BOX_S = 1.5


def _same_outcome(port_fn, ref_fn):
    """The port's parse and the reference's on one input: both reject
    typed, or both return the same value."""
    from etl_tpu.models.errors import EtlError as RefError

    try:
        got = ("ok", repr(port_fn()))
    except EtlError as e:
        got = ("typed", e.kind.name)
    try:
        want = ("ok", repr(ref_fn()))
    except RefError as e:
        want = ("typed", e.kind.name)
    assert got == want, (got, want)


def parity_parse_text_cell(inputs):
    from etl_tpu.postgres.codec.text import parse_cell_text as ref_parse
    from etl_tpu_torch.postgres.codec.text import parse_cell_text

    text, oid = inputs
    _same_outcome(lambda: parse_cell_text(text, oid),
                  lambda: ref_parse(text, oid))


def parity_parse_copy_row(inputs):
    from etl_tpu.models.errors import EtlError as RefError
    from etl_tpu.postgres.codec.copy_text import parse_copy_row as ref_parse
    from etl_tpu_torch.postgres.codec.copy_text import parse_copy_row

    line, oids = inputs
    try:
        got = ("ok", repr(parse_copy_row(line, oids).values))
    except (EtlError, UnicodeDecodeError) as e:
        got = ("rejected", type(e).__name__)
    try:
        want = ("ok", repr(ref_parse(line, oids).values))
    except (RefError, UnicodeDecodeError) as e:
        want = ("rejected", type(e).__name__)
    assert got == want, (got, want)


def parity_numeric_roundtrip(inputs):
    from etl_tpu.postgres.codec.text import parse_cell_text as ref_parse
    from etl_tpu_torch.models.pgtypes import Oid
    from etl_tpu_torch.postgres.codec.text import parse_cell_text

    fuzz.check_numeric_roundtrip(inputs)
    for text in inputs:
        _same_outcome(lambda: parse_cell_text(text, Oid.NUMERIC),
                      lambda: ref_parse(text, Oid.NUMERIC))


def parity_bytea_hex(inputs):
    from etl_tpu.postgres.codec.text import parse_cell_text as ref_parse
    from etl_tpu_torch.models.pgtypes import Oid
    from etl_tpu_torch.postgres.codec.text import parse_cell_text

    for text in inputs:
        _same_outcome(lambda: parse_cell_text(text, Oid.BYTEA),
                      lambda: ref_parse(text, Oid.BYTEA))


def parity_framer(inputs):
    """The port's C framer flags or refuses what the reference's does,
    frames what it frames, and never emits an out-of-bounds field."""
    from etl_tpu.models.errors import EtlError as RefError
    from etl_tpu.native import frame_pgoutput as ref_frame
    from etl_tpu_torch.native import frame_pgoutput

    fuzz.check_framer(inputs)
    buf, offs, lens, n_cols = inputs
    try:
        framed, bad = frame_pgoutput(buf, offs, lens, n_cols)
    except EtlError:
        framed = None
    try:
        ref_framed, ref_bad = ref_frame(buf, offs, lens, n_cols)
    except RefError:
        ref_framed = None
    assert (framed is None) == (ref_framed is None)
    if framed is None:
        return
    assert bad == ref_bad
    upto = framed.n_msgs if bad < 0 else bad
    for name in ("new_off", "new_len", "old_off", "old_len"):
        assert np.array_equal(getattr(framed, name)[:upto],
                              getattr(ref_framed, name)[:upto]), name


def _ref_pb_request(inputs) -> bytes:
    """`fuzz.pb_request` on the reference's encoder and models."""
    from etl_tpu.destinations import bq_proto
    from etl_tpu.models.cell import PgNumeric
    from etl_tpu.models.pgtypes import Oid
    from etl_tpu.models.schema import (ColumnSchema, ReplicatedTableSchema,
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


def parity_pb_append_rows(inputs):
    """The port's request bytes are the reference encoder's, and the two
    packages' independent readers agree on them and on a flipped bit."""
    from etl_tpu.testing.pb_reader import decode_append_rows as ref_decode
    from etl_tpu_torch.testing.pb_reader import decode_append_rows

    fuzz.check_pb_append_rows(inputs)
    buf = fuzz.pb_request(inputs)
    assert buf == _ref_pb_request(inputs)
    assert decode_append_rows(buf) == ref_decode(buf)
    flipped = fuzz.flip_bit(buf, inputs["flip"])

    def outcome(fn):
        try:
            return ("ok", repr(fn(flipped)))
        except (ValueError, KeyError) as e:
            return ("rejected", type(e).__name__)

    assert outcome(decode_append_rows) == outcome(ref_decode)


def parity_snowpipe_batches(docs):
    """The port's zstd row batches are the reference builder's, byte for
    byte, with the same row counts and offset ranges."""
    from etl_tpu.destinations.snowpipe import RowBatchBuilder as RefBuilder

    fuzz.check_snowpipe_batches(docs)
    ref = RefBuilder()
    for doc in docs:
        ref.push_row(doc, doc["_cdc_sequence_number"])
    want = [(b.data, b.row_count, b.start_offset, b.end_offset)
            for b in ref.finish()]
    got = [(b.data, b.row_count, b.start_offset, b.end_offset)
           for b in fuzz.snowpipe_batches(docs)]
    assert got == want


#: each target's comparison with the reference, on the port's draws
PARITY = {
    "parse_text_cell": parity_parse_text_cell,
    "parse_copy_row": parity_parse_copy_row,
    "numeric_roundtrip": parity_numeric_roundtrip,
    "bytea_hex": parity_bytea_hex,
    "framer": parity_framer,
    "pb_append_rows": parity_pb_append_rows,
    "snowpipe_batches": parity_snowpipe_batches,
}

FUZZ_CASES_IDS = [("contract", t) for t in sorted(fuzz.TARGETS)] \
    + [("parity", t) for t in sorted(PARITY)]


@pytest.mark.parametrize("mode,target", FUZZ_CASES_IDS,
                         ids=[f"{m}-{t}" for m, t in FUZZ_CASES_IDS])
def test_fuzz_target(mode, target):
    """`contract`: the port's `run_target` at the pinned seed, at least
    FUZZ_CASES cases (a contract violation raises FuzzFailure with its
    replay seed); `avro_ocf` is refused typed before its first case.
    `parity`: seeded (case i on seed FUZZ_SEED + i) and time-boxed, at
    least FUZZ_CASES cases, then until FUZZ_BOX_S has passed; each case
    draws through the port's `draw_<target>` and holds the port to the
    reference on those inputs (a typed rejection of a case is the
    contract; an untyped escape fails)."""
    if mode == "contract":
        if target == "avro_ocf":
            with pytest.raises(EtlError) as e:
                fuzz.run_target(target, seconds=FUZZ_BOX_S,
                                min_cases=FUZZ_CASES, seed=FUZZ_SEED)
            assert e.value.kind is ErrorKind.CONFIG_INVALID
            assert "queue 1 entry 7" in str(e.value)
            with pytest.raises(EtlError):
                fuzz.fuzz_avro_ocf(random.Random(FUZZ_SEED))
            return
        n = fuzz.run_target(target, seconds=FUZZ_BOX_S,
                            min_cases=FUZZ_CASES, seed=FUZZ_SEED)
        assert n >= FUZZ_CASES
        return
    draw = getattr(fuzz, f"draw_{target}")
    check = PARITY[target]
    deadline = time.monotonic() + FUZZ_BOX_S
    case = 0
    while case < FUZZ_CASES or time.monotonic() < deadline:
        seed = FUZZ_SEED + case
        try:
            check(draw(random.Random(seed)))
        except EtlError:
            pass  # typed rejection is the contract
        except Exception as e:
            raise AssertionError(
                f"fuzz target {target} failed at seed {seed}: "
                f"{type(e).__name__}: {e}") from e
        case += 1
    assert case >= FUZZ_CASES


def test_snowpipe_target_refused_typed_without_zstandard(monkeypatch):
    """Where zstandard is not installed (the card's machine), the
    Snowpipe target is refused typed before its first case, as the
    Snowflake destination is held to the CPU."""
    import importlib.util

    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "zstandard"
                        else real(name, *a))
    with pytest.raises(EtlError) as e:
        fuzz.run_target("snowpipe_batches", seconds=0.1, min_cases=1,
                        seed=FUZZ_SEED)
    assert e.value.kind is ErrorKind.CONFIG_INVALID
    assert "zstandard" in str(e.value)


def _cli(*argv, env_extra=None, timeout=240):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-m", "etl_tpu_torch.devtools",
                           *argv], capture_output=True, text=True,
                          timeout=timeout, cwd=ROOT, env=env)


class TestFuzzCli:
    def test_refused_target_exits_2(self):
        proc = _cli("fuzz", "--target", "avro_ocf", "--seconds", "0.1")
        assert proc.returncode == 2, proc.stderr
        assert "refused: CONFIG_INVALID" in proc.stderr
        assert "queue 1 entry 7" in proc.stderr

    def test_all_targets_run_the_ported_ones(self):
        proc = _cli("fuzz", "--seconds", "2", "--seed", "3")
        assert proc.returncode == 0, proc.stderr[-2000:]
        ran = {line.split(":")[0] for line in proc.stdout.splitlines()}
        assert ran == set(fuzz.TARGETS) - {"avro_ocf"}
        assert "avro_ocf: refused" in proc.stderr


class TestDevtoolsFillTable:
    async def test_fill_table_over_wire_client(self):
        """devtools fill-table (reference xtask pg-fill-table): parallel
        wire-client connections bulk-load a user table; verified against
        the fake server's generic-SQL passthrough over real TCP."""
        from etl_tpu_torch.devtools import fill_table
        from etl_tpu_torch.postgres.fake import FakeDatabase
        from etl_tpu_torch.testing.fake_pg_server import FakePgServer

        db = FakeDatabase()
        server = FakePgServer(db)
        server.allow_generic_sql = True
        await server.start()
        try:
            args = argparse.Namespace(
                host="127.0.0.1", port=server.port, database="postgres",
                username="etl", password="", table="fill_demo",
                rows=1234, row_bytes=64, batch_rows=100, parallelism=3)
            rc = await fill_table(args)
            assert rc == 0
            n = db._generic_sql_db.execute(
                "SELECT COUNT(*), COUNT(DISTINCT id) FROM fill_demo"
            ).fetchone()
            assert n == (1234, 1234)  # exact row count, no id collisions
            assert server.connections == 4  # setup + 3 workers
        finally:
            await server.stop()


class TestDevtoolsRotateEncryptionKey:
    def test_rotate_reencrypts_and_is_idempotent(self, tmp_path):
        import base64
        import sqlite3

        from etl_tpu_torch.api.crypto import ConfigCipher, EncryptionKey
        from etl_tpu_torch.devtools import rotate_encryption_key

        old = EncryptionKey.generate(0)
        new = EncryptionKey.generate(1)
        db_path = tmp_path / "api.db"
        db = sqlite3.connect(db_path)
        db.executescript("""
CREATE TABLE api_sources (id INTEGER PRIMARY KEY, tenant_id TEXT,
    name TEXT, config_enc TEXT);
CREATE TABLE api_destinations (id INTEGER PRIMARY KEY, tenant_id TEXT,
    name TEXT, config_enc TEXT);
""")
        old_cipher = ConfigCipher(old)
        db.execute("INSERT INTO api_sources VALUES (1, 't', 's', ?)",
                   (old_cipher.encrypt({"host": "db", "password": "x"}),))
        db.execute("INSERT INTO api_destinations VALUES (1, 't', 'd', ?)",
                   (old_cipher.encrypt({"type": "lake"}),))
        db.commit()
        db.close()

        def keyarg(k):
            return f"{k.key_id}:{base64.b64encode(k.key).decode()}"

        args = argparse.Namespace(db=str(db_path), new_key=keyarg(new),
                                  old_key=[keyarg(old)])
        assert rotate_encryption_key(args) == 0
        # every row decrypts under the NEW key alone
        new_only = ConfigCipher(new)
        db = sqlite3.connect(db_path)
        for table in ("api_sources", "api_destinations"):
            (enc,) = db.execute(
                f"SELECT config_enc FROM {table}").fetchone()
            assert json.loads(enc)["key_id"] == 1
            assert new_only.decrypt(enc)
        db.close()
        # idempotent second pass: nothing left to rotate
        assert rotate_encryption_key(args) == 0


class TestServeSource:
    @pytest.mark.parametrize("rows,tables", [(0, 1), (25, 1), (40, 3)])
    def test_filled_rows_equal_the_reference(self, rows, tables):
        """`serve-source`'s generated tables: the same schemas, rows and
        publication as the reference's `_make_filled_db` for the same
        arguments."""
        from etl_tpu.devtools import _make_filled_db as ref_make
        from etl_tpu_torch.devtools import _make_filled_db

        db, tids = _make_filled_db(rows, tables)
        ref_db, ref_tids = ref_make(rows, tables)
        assert tids == ref_tids
        for tid in tids:
            t, rt = db.tables[tid], ref_db.tables[tid]
            assert [r for r in t.rows] == [r for r in rt.rows]
            assert [(c.name, int(c.type_oid), c.nullable,
                     c.primary_key_ordinal) for c in t.schema.columns] \
                == [(c.name, int(c.type_oid), c.nullable,
                     c.primary_key_ordinal) for c in rt.schema.columns]
        assert db.publications["pub"] == ref_db.publications["pub"]

    def test_command_serves_and_describes(self):
        """`python -m etl_tpu_torch.devtools serve-source` prints the
        reference's description line and serves the table over the wire
        protocol until stopped."""
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["PYTHONPATH"] = ROOT
        proc = subprocess.Popen(
            [sys.executable, "-m", "etl_tpu_torch.devtools", "serve-source",
             "--rows", "30", "--tables", "2"], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, cwd=ROOT, env=env)
        try:
            info = json.loads(proc.stdout.readline())
            assert info["publication"] == "pub"
            assert info["rows_per_table"] == 30
            assert info["tables"] == [20000, 20001]

            async def count() -> int:
                from etl_tpu_torch.config import PgConnectionConfig
                from etl_tpu_torch.postgres.client import \
                    wire_connection_from_config

                conn = wire_connection_from_config(PgConnectionConfig(
                    host="127.0.0.1", port=info["port"], name="postgres",
                    username="etl"), application_name="serve_check")
                await conn.connect()
                try:
                    data = b"".join([chunk async for chunk in conn.copy_out(
                        'COPY (SELECT "id", "bucket", "payload" FROM '
                        '"public"."filled_1") TO STDOUT')])
                    return data.count(b"\n")
                finally:
                    await conn.close()

            assert asyncio.run(count()) == 30
        finally:
            proc.terminate()
            proc.wait(timeout=30)

    def test_workload_profile_description_equals_the_reference(self):
        """`serve-source --workload P --seed N` serves the port's
        generator of that profile, described as the reference's is."""
        from etl_tpu.workloads import WorkloadGenerator as RefGenerator
        from etl_tpu_torch.workloads import WorkloadGenerator

        for profile in ("update_heavy_default", "partitioned_root"):
            gen = WorkloadGenerator(profile, seed=5)
            ref = RefGenerator(profile, seed=5)
            assert gen.describe() == ref.describe()
            assert gen.table_ids == ref.table_ids


# -- devtools chaos ------------------------------------------------------------

SCENARIOS = ["partition", "latency", "corruption", "copy", "destination",
             "slot"]
ENGINES = [("cpu", "cuda"), ("cuda", "cpu")]


def _chaos_args(scenario: str, engine: str, device: str):
    """The reference's CLI defaults at 500 rows and 2 s. The corruption
    scenario flips every 6th server→client chunk after READY: a 1 s
    interval makes two transactions in 2 s, too few chunks to reach the
    6th (the reference's command fails the same way at these sizes), so
    it commits every 0.25 s."""
    return argparse.Namespace(
        rows=500, seconds=2.0,
        interval=0.25 if scenario == "corruption" else 1.0,
        engine=engine, device=device, scenario=scenario, latency_ms=40.0,
        copy_severs=3)


@pytest.mark.parametrize("engine,device", ENGINES,
                         ids=["engine_cpu", "engine_cuda_device_cpu"])
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_chaos_scenario(scenario, engine, device):
    """One `devtools chaos` scenario over real TCP, with the reference's
    checks (no loss; no duplicate but the destination scenario's bounded
    redeliveries; a sever before READY; the slot's resync) and the
    decoder's route: on the CUDA engine some batch took the device route
    (the plain versions here), on the per-tuple engine none."""
    from etl_tpu_torch.devtools import _chaos_scenario

    report, ok = asyncio.run(asyncio.wait_for(
        _chaos_scenario(_chaos_args(scenario, engine, device), scenario),
        120))
    assert ok, report
    assert report["missing"] == []
    assert report["k1_launches"] == 0  # no card here
    if engine == "cuda":
        assert report["device_batches"] > 0
    else:
        assert report["device_batches"] == 0
    if scenario == "copy":
        assert report["copy_severs"] > 0 and report["copy_dupes"] == 0


def test_chaos_without_a_card_runs_nothing():
    """`--engine cuda` (the default) on the card (the default device)
    with no card: exit 1, nothing printed on stdout."""
    proc = _cli("chaos", "--scenario", "partition", "--rows", "100",
                "--seconds", "1", env_extra={"CUDA_VISIBLE_DEVICES": ""},
                timeout=120)
    assert proc.returncode == 1, proc.stderr
    assert proc.stdout == ""
    assert "no CUDA device" in proc.stderr


def test_bench_compare_delegates(tmp_path):
    """`devtools bench-compare` runs the port's `benchmarks.compare`."""
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    a.write_text(json.dumps({"mode": "x", "events_per_second": 100.0}))
    b.write_text(json.dumps({"mode": "x", "events_per_second": 99.0}))
    proc = _cli("bench-compare", str(a), str(b))
    assert proc.returncode == 0, proc.stderr
