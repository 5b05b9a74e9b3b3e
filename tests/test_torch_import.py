"""The port's package boundary: what it imports, and that it never falls
back from the card."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from etl_tpu_torch import convert
from etl_tpu_torch.models import ReplicatedTableSchema as PortSchema
from etl_tpu_torch.models.pgtypes import CellKind as PK
from etl_tpu_torch.ops import decode_kernel
from etl_tpu_torch.ops.bitpack import layout_for_specs as port_layout
from etl_tpu_torch.ops.engine import DeviceDecoder as PortDecoder

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PORT_MODULES = [
    "etl_tpu_torch", "etl_tpu_torch.bench", "etl_tpu_torch.convert",
    "etl_tpu_torch.testing", "etl_tpu_torch.native",
    "etl_tpu_torch.kernel_variants",
    "etl_tpu_torch.models", "etl_tpu_torch.models.cell",
    "etl_tpu_torch.models.errors", "etl_tpu_torch.models.event",
    "etl_tpu_torch.models.lsn", "etl_tpu_torch.models.pgtypes",
    "etl_tpu_torch.models.schema", "etl_tpu_torch.models.table_row",
    "etl_tpu_torch.postgres.codec", "etl_tpu_torch.postgres.codec.copy_text",
    "etl_tpu_torch.postgres.codec.event",
    "etl_tpu_torch.postgres.codec.pgoutput",
    "etl_tpu_torch.postgres.codec.text", "etl_tpu_torch.ops",
    "etl_tpu_torch.ops.bitpack", "etl_tpu_torch.ops.decode_kernel",
    "etl_tpu_torch.ops.egress", "etl_tpu_torch.ops.egress_kernel",
    "etl_tpu_torch.ops.engine", "etl_tpu_torch.ops.parsers",
    "etl_tpu_torch.ops.predicate",
    "etl_tpu_torch.ops.staging", "etl_tpu_torch.ops.wal",
    "etl_tpu_torch.ops.pipeline", "etl_tpu_torch.models.table_state",
    "etl_tpu_torch.ops.program_store", "etl_tpu_torch.ops.autotune",
    "etl_tpu_torch.parallel", "etl_tpu_torch.parallel.mesh",
    "etl_tpu_torch.benchmarks.coldstart_worker",
    "etl_tpu_torch.config", "etl_tpu_torch.config.pipeline",
    "etl_tpu_torch.retry", "etl_tpu_torch.postgres",
    "etl_tpu_torch.postgres.source", "etl_tpu_torch.postgres.slots",
    "etl_tpu_torch.postgres.fake", "etl_tpu_torch.postgres.migrations",
    "etl_tpu_torch.store", "etl_tpu_torch.store.base",
    "etl_tpu_torch.store.memory", "etl_tpu_torch.sharding",
    "etl_tpu_torch.sharding.shardmap", "etl_tpu_torch.destinations",
    "etl_tpu_torch.destinations.base", "etl_tpu_torch.destinations.util",
    "etl_tpu_torch.destinations.memory",
    "etl_tpu_torch.destinations.clickhouse",
    "etl_tpu_torch.destinations.snowflake",
    "etl_tpu_torch.destinations.bq_proto", "etl_tpu_torch.telemetry",
    "etl_tpu_torch.telemetry.metrics", "etl_tpu_torch.telemetry.egress",
    "etl_tpu_torch.chaos", "etl_tpu_torch.chaos.failpoints",
    "etl_tpu_torch.analysis", "etl_tpu_torch.analysis.annotations",
    "etl_tpu_torch.runtime", "etl_tpu_torch.runtime.ack_window",
    "etl_tpu_torch.runtime.apply_loop", "etl_tpu_torch.runtime.apply_worker",
    "etl_tpu_torch.runtime.assembler", "etl_tpu_torch.runtime.backpressure",
    "etl_tpu_torch.runtime.copy", "etl_tpu_torch.runtime.failpoints",
    "etl_tpu_torch.runtime.pipeline", "etl_tpu_torch.runtime.shutdown",
    "etl_tpu_torch.runtime.state", "etl_tpu_torch.runtime.table_cache",
    "etl_tpu_torch.runtime.table_sync", "etl_tpu_torch.runtime.poison",
    "etl_tpu_torch.supervision", "etl_tpu_torch.supervision.breaker",
    "etl_tpu_torch.supervision.destination",
    "etl_tpu_torch.supervision.health",
    "etl_tpu_torch.supervision.heartbeat",
    "etl_tpu_torch.supervision.supervisor", "etl_tpu_torch.dlq",
    "etl_tpu_torch.dlq.codec", "etl_tpu_torch.dlq.__main__",
    "etl_tpu_torch.store.sql", "chip_smoke",
    "etl_tpu_torch.postgres.version", "etl_tpu_torch.postgres.wire",
    "etl_tpu_torch.postgres.lag", "etl_tpu_torch.postgres.client",
    "etl_tpu_torch.testing.fake_pg_server",
    "etl_tpu_torch.testing.chaos_proxy", "etl_tpu_torch.testing.tls",
    "etl_tpu_torch.testing.pg_process",
    "etl_tpu_torch.telemetry.tracing", "etl_tpu_torch.telemetry.notify",
    "etl_tpu_torch.config.load", "etl_tpu_torch.destinations.registry",
    "etl_tpu_torch.replicator",
    "etl_tpu_torch.models.default_expression",
    "etl_tpu_torch.destinations.bigquery",
    "etl_tpu_torch.destinations.snowpipe",
    "etl_tpu_torch.destinations.delay",
    "etl_tpu_torch.testing.fake_http", "etl_tpu_torch.testing.fake_bq",
    "etl_tpu_torch.testing.pb_reader",
    "etl_tpu_torch.testing.fake_snowpipe",
    "etl_tpu_torch.testing.http_process",
    "etl_tpu_torch.sharding.runtime", "etl_tpu_torch.sharding.coordinator",
    "etl_tpu_torch.chaos.scenario", "etl_tpu_torch.chaos.invariants",
    "etl_tpu_torch.chaos.runner", "etl_tpu_torch.chaos.corpus",
    "etl_tpu_torch.chaos.sharded", "etl_tpu_torch.chaos.multi",
    "etl_tpu_torch.chaos.dlq", "etl_tpu_torch.chaos.__main__",
    "etl_tpu_torch.workloads", "etl_tpu_torch.workloads.generator",
    "etl_tpu_torch.workloads.profiles", "etl_tpu_torch.bench_sharded",
    "etl_tpu_torch.chaos.ack_window", "etl_tpu_torch.chaos.exactly_once",
    "etl_tpu_torch.benchmarks", "etl_tpu_torch.benchmarks.harness",
    "etl_tpu_torch.benchmarks.shard_worker",
    "etl_tpu_torch.benchmarks.compare", "etl_tpu_torch.benchmarks.smoke",
    "etl_tpu_torch.autoscale", "etl_tpu_torch.autoscale.signals",
    "etl_tpu_torch.autoscale.policy", "etl_tpu_torch.autoscale.controller",
    "etl_tpu_torch.autoscale.__main__", "etl_tpu_torch.chaos.autoscale",
    "etl_tpu_torch.api", "etl_tpu_torch.api.crypto", "etl_tpu_torch.api.db",
    "etl_tpu_torch.api.orchestrator", "etl_tpu_torch.api.validation",
    "etl_tpu_torch.api.app", "etl_tpu_torch.benchmarks.control_plane",
    "etl_tpu_torch.fleet", "etl_tpu_torch.fleet.spec",
    "etl_tpu_torch.fleet.journal", "etl_tpu_torch.fleet.runtime",
    "etl_tpu_torch.fleet.sim", "etl_tpu_torch.fleet.reconciler",
    "etl_tpu_torch.fleet.bus", "etl_tpu_torch.chaos.fleet",
    "etl_tpu_torch.devtools", "etl_tpu_torch.testing.fuzz",
    "etl_tpu_torch.benchmarks.fleet",
    "etl_tpu_torch.destinations.lake", "etl_tpu_torch.destinations.iceberg",
    "etl_tpu_torch.destinations.iceberg_meta",
    "etl_tpu_torch.testing.avro_reader", "etl_tpu_torch.testing.fake_iceberg",
    "etl_tpu_torch.maintenance", "etl_tpu_torch.maintenance_coordination",
    "etl_tpu_torch.analysis.baseline", "etl_tpu_torch.analysis.callgraph",
    "etl_tpu_torch.analysis.cfg", "etl_tpu_torch.analysis.cli",
    "etl_tpu_torch.analysis.concurrency", "etl_tpu_torch.analysis.contexts",
    "etl_tpu_torch.analysis.domains", "etl_tpu_torch.analysis.findings",
    "etl_tpu_torch.analysis.interproc", "etl_tpu_torch.analysis.rules",
    "etl_tpu_torch.analysis.visitor", "etl_tpu_torch.analysis.__main__",
    "etl_tpu_torch.analysis.ir", "etl_tpu_torch.analysis.ir.catalog",
    "etl_tpu_torch.analysis.ir.contracts", "etl_tpu_torch.analysis.ir.runner",
]

#: the lint's tiers but the IR runner: stdlib-only, as the reference's
#: (the hot modules import the markers from this package)
TORCH_FREE_LINT_MODULES = [
    "etl_tpu_torch.analysis", "etl_tpu_torch.analysis.annotations",
    "etl_tpu_torch.analysis.baseline", "etl_tpu_torch.analysis.callgraph",
    "etl_tpu_torch.analysis.cfg", "etl_tpu_torch.analysis.cli",
    "etl_tpu_torch.analysis.concurrency", "etl_tpu_torch.analysis.contexts",
    "etl_tpu_torch.analysis.domains", "etl_tpu_torch.analysis.findings",
    "etl_tpu_torch.analysis.interproc", "etl_tpu_torch.analysis.rules",
    "etl_tpu_torch.analysis.visitor", "etl_tpu_torch.analysis.ir",
    "etl_tpu_torch.analysis.ir.contracts",
]

#: the lake, Iceberg and maintenance modules import where pyarrow cannot
#: be imported; building them refuses typed there
#: (tests/test_torch_lake.py, test_torch_maintenance.py)
PYARROW_FREE_MODULES = [
    "etl_tpu_torch.destinations.lake", "etl_tpu_torch.destinations.iceberg",
    "etl_tpu_torch.destinations.iceberg_meta",
    "etl_tpu_torch.destinations.registry", "etl_tpu_torch.testing.fuzz",
    "etl_tpu_torch.testing.avro_reader", "etl_tpu_torch.testing.fake_iceberg",
    "etl_tpu_torch.maintenance", "etl_tpu_torch.maintenance_coordination",
    "etl_tpu_torch.replicator", "etl_tpu_torch.bench",
]


def test_every_port_module_is_probed():
    """The probe list names every module of the package: a module added
    to the port cannot escape the import check."""
    import pathlib

    pkg = pathlib.Path(ROOT, "etl_tpu_torch")
    found = set()
    for path in pkg.rglob("*.py"):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        found.add(".".join(parts))
    assert found <= set(PORT_MODULES), sorted(found - set(PORT_MODULES))

_PROBE = """
import importlib, sys
for m in {mods!r}:
    importlib.import_module(m)
bad = sorted(m for m in sys.modules
             if m in ("jax", "etl_tpu") or m.startswith(("jax.", "etl_tpu.")))
print("BAD", bad)
print("HAVE", "etl_tpu_torch.ops.engine" in sys.modules)
"""


def test_parquet_modules_import_without_pyarrow():
    """With pyarrow blocked, the Parquet writers' modules import, pull in
    neither JAX nor the reference, and the OCF pair still round-trips."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    code = ("import sys\nsys.modules['pyarrow'] = None\n"
            + _PROBE.format(mods=PYARROW_FREE_MODULES)
            + "from etl_tpu_torch.testing import fuzz\n"
              "print('CASES', fuzz.run_target('avro_ocf', seconds=0.1, "
              "min_cases=50, seed=1))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=240, cwd=ROOT, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.splitlines()
    assert "BAD []" in lines, proc.stdout
    assert any(ln.startswith("CASES ") and int(ln.split()[1]) >= 50
               for ln in lines), proc.stdout


def test_port_imports_neither_jax_nor_reference():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(mods=PORT_MODULES)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    assert "HAVE True" in out.stdout


_LINT_PROBE = """
import importlib, sys
for m in {mods!r}:
    importlib.import_module(m)
print("BAD", sorted(m for m in sys.modules
                    if m.split(".")[0] in ("torch", "numpy", "jax",
                                           "etl_tpu")))
"""


def test_lint_tiers_import_no_torch():
    """`import etl_tpu_torch.analysis` and every tier but the IR runner
    leave torch (and numpy, jax and the reference) unimported."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run(
        [sys.executable, "-c", _LINT_PROBE.format(
            mods=TORCH_FREE_LINT_MODULES)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_lint_cli_runs_without_jax_or_reference():
    """The whole CLI, both tiers (`--programs --device cpu` over one
    file), runs in a process that has neither jax nor the reference."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    code = ("import sys\n"
            "sys.modules['jax'] = None\nsys.modules['etl_tpu'] = None\n"
            "from etl_tpu_torch.analysis.cli import main\n"
            "rc = main(['--programs', '--device', 'cpu', '--row-buckets', "
            "'64', '-q', sys.argv[1]])\n"
            "print('RC', rc)\n"
            "print('BAD', sorted(m for m in sys.modules if m.split('.')[0] "
            "in ('jax', 'etl_tpu') and sys.modules[m] is not None))\n")
    out = subprocess.run(
        [sys.executable, "-c", code, os.path.join(ROOT, "etl_tpu_torch",
                                                  "analysis", "findings.py")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "RC 0" in out.stdout and "BAD []" in out.stdout, out.stdout


_EGRESS_PROBE = """
import sys
import numpy as np
from etl_tpu_torch import bench
from etl_tpu_torch.destinations import bq_proto
from etl_tpu_torch.destinations.clickhouse import render_batch_tsv_fast
from etl_tpu_torch.destinations.snowflake import (encode_batch_ndjson_fast,
                                                  offset_token_batch)
from etl_tpu_torch.destinations.util import (sequence_number_batch,
                                             sequence_number_buffer)
from etl_tpu_torch.ops import egress_kernel
from etl_tpu_torch.ops.engine import DeviceDecoder
from etl_tpu_torch.ops.wal import concat_payloads, stage_wal_batch

schema = bench.make_schema()
staged = stage_wal_batch(*concat_payloads(bench.build_workload(300)),
                         4).staged
for enc in ("tsv", "json"):
    b = DeviceDecoder(schema, device="cpu", egress=enc).decode(staged)
    assert b.device_egress is not None
    z = np.zeros(b.num_rows, dtype=np.uint64)
    if enc == "tsv":
        render_batch_tsv_fast(schema, b, "UPSERT",
                              sequence_number_buffer(z, z, z),
                              egress=b.device_egress)
        bq_proto.encode_batch(schema, b, [b"UPSERT"] * b.num_rows,
                              sequence_number_batch(z, z, z),
                              egress=b.device_egress)
    else:
        encode_batch_ndjson_fast(schema, b, "insert",
                                 offset_token_batch(z, z),
                                 egress=b.device_egress)
print("BAD", sorted(m for m in sys.modules
                    if m.split(".")[0] in ("pyarrow", "aiohttp", "jax",
                                           "etl_tpu")))
"""


def test_egress_path_imports_neither_pyarrow_nor_aiohttp():
    """Decoding with device egress and encoding TSV, NDJSON and BigQuery
    proto from it imports no pyarrow and no aiohttp (the card's machine
    has no pyarrow), and neither jax nor the reference."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", _EGRESS_PROBE], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def _schema():
    return convert.schema_from_plain(
        1, "public", "t",
        [("a", 23, -1, False, 1), ("b", 25, -1, True, None)],
        [True, True], [True, False])


def test_cuda_decoder_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PortDecoder(_schema())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PortDecoder(_schema(), device="cuda")


def test_decode_pack_refuses_other_devices():
    specs = ((0, PK.I32, 4, 2),)
    bm = torch.zeros((8, 4), dtype=torch.uint8, device="meta")
    ln = torch.zeros((8, 1), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported devices"):
        decode_kernel.decode_pack(bm, ln, specs, False)
    with pytest.raises(ValueError):
        PortDecoder(_schema(), device="meta")


@pytest.mark.parametrize("bad", [
    dict(bmat_dtype=torch.int32), dict(width=3, nibble=True),
    dict(kind=PK.DATE, width=8), dict(cols=2)])
def test_decode_pack_checks_inputs(bad):
    kind, width = bad.get("kind", PK.I32), bad.get("width", 4)
    nibble = bad.get("nibble", False)
    specs = ((0, kind, width, 2),)
    w_in = width // 2 if nibble else width
    bm = torch.zeros((8, w_in), dtype=bad.get("bmat_dtype", torch.uint8))
    ln = torch.zeros((8, bad.get("cols", 1)), dtype=torch.uint8)
    with pytest.raises(ValueError):
        decode_kernel.decode_pack(bm, ln, specs, nibble)


def test_row_filter_round_trips_and_binds():
    """Checks that a schema's row filter round-trips through JSON and that
    the decoder binds it; neither step refuses a row filter any more."""
    from etl_tpu_torch.ops.predicate import parse_row_filter

    d = _schema().to_json()
    assert PortSchema.from_json(d).row_predicate is None
    d["row_filter"] = parse_row_filter("a > 1").to_json()
    schema = PortSchema.from_json(d)
    assert schema.row_predicate == parse_row_filter("a > 1")
    dec = PortDecoder(schema, device="cpu")
    assert dec._row_filter.referenced_indices == (0,)
    assert dec._row_filter.kernel_supported


def test_filter_wrappers_refuse_other_devices_and_bad_inputs():
    from etl_tpu_torch.ops.predicate import compile_row_filter

    pred = compile_row_filter("a > 1", _schema())
    specs = ((0, PK.I32, 4, 2),)

    def t(shape, dtype, device="meta"):
        return torch.zeros(shape, dtype=dtype, device=device)

    with pytest.raises(ValueError, match="unsupported devices"):
        decode_kernel.decode_pack_filtered(
            t((8, 4), torch.uint8), t((8, 1), torch.uint8),
            t(8, torch.uint8), specs, False, pred)
    with pytest.raises(ValueError, match="unsupported devices"):
        decode_kernel.compact_packed(t((1, 8), torch.int32),
                                     t(1, torch.int32), t(1, torch.int32))
    with pytest.raises(ValueError, match="row_flags"):
        decode_kernel.filter_pack(
            t((8, 4), torch.uint8, "cpu"), t((8, 1), torch.uint8, "cpu"),
            t(8, torch.int32, "cpu"), specs, False, pred)
    with pytest.raises(ValueError, match="do not fit"):
        decode_kernel.compact_packed(t((1, 40), torch.int32, "cpu"),
                                     t(1, torch.int32, "cpu"),
                                     t(1, torch.int32, "cpu"))
    for fn in (decode_kernel.filter_pack_compact,
               decode_kernel.prepare_filtered):
        with pytest.raises(ValueError, match="unsupported devices"):
            fn(t((8, 4), torch.uint8), t((8, 1), torch.uint8),
               t(8, torch.uint8), specs, False, pred)
        with pytest.raises(ValueError, match="row_flags"):
            fn(t((8, 4), torch.uint8, "cpu"), t((8, 1), torch.uint8, "cpu"),
               t(7, torch.uint8, "cpu"), specs, False, pred)


def test_pred_descriptor_checks_the_filter_and_specs():
    from etl_tpu_torch.ops.predicate import (MAX_PROGRAM_DEPTH,
                                             compile_row_filter)

    schema = _schema()
    pred = compile_row_filter("a > 1 AND a IS NOT NULL", schema)
    specs = ((0, PK.I32, 4, 2),)
    desc = decode_kernel.pred_descriptor(pred, specs)
    # n_instr, n_ref, the referenced slot, then 3 instructions of 8, then
    # the single-parse index: last referenced slot 0, leaf offsets [0, 1],
    # slot 0 referenced, its one comparison leaf at instruction 0
    assert desc[:3] == [3, 1, 0] and len(desc) == 3 + 3 * 8 + 5
    assert desc[3 + 3 * 8:] == [0, 0, 1, 1, 0]
    with pytest.raises(ValueError, match="not a dense column"):
        decode_kernel.pred_descriptor(pred, ((5, PK.I32, 4, 2),))
    with pytest.raises(ValueError, match="not a dense column"):
        decode_kernel.pred_descriptor(pred, ((0, PK.I64, 4, 2),))
    deep = compile_row_filter(
        " OR ".join(f"a = {i}" for i in range(MAX_PROGRAM_DEPTH + 1)),
        schema)
    with pytest.raises(ValueError, match="envelope"):
        decode_kernel.pred_descriptor(deep, specs)


def test_pred_descriptor_cache_keys_on_column_position():
    """One filter text on two tables whose filter column sits at another
    position, with the same dense specs: each wrapper call gets its own
    table's descriptor, not the one cached for the other table."""
    from etl_tpu_torch.ops.predicate import compile_row_filter

    def table(names):
        return convert.schema_from_plain(
            1, "public", "t", [(n, 23, -1, False, None) for n in names],
            [True] * len(names), [False] * len(names))

    specs = tuple((i, PK.I32, 12, 12) for i in range(3))
    preds = [compile_row_filter("bid <= 5", table(names))
             for names in (("aid", "bid", "abalance"),
                           ("bid", "aid", "abalance"))]
    assert preds[0].fingerprint() == preds[1].fingerprint()
    descs = [decode_kernel._device_pred(p, specs, torch.device("cpu"))
             for p in preds]
    for p, d in zip(preds, descs):
        assert d.tolist() == decode_kernel.pred_descriptor(p, specs)
    assert descs[0].tolist() != descs[1].tolist()


def test_schema_carried_across_gives_reference_layout():
    """convert.schema_from_plain on the reference schema's plain data:
    the same columns, kinds, masks and bit layout."""
    from etl_tpu.models import (ColumnSchema, Oid, ReplicatedTableSchema,
                                TableName, TableSchema)
    from etl_tpu.models.pgtypes import CellKind as RK
    from etl_tpu.ops.bitpack import layout_for_specs as ref_layout

    oids = [Oid.INT2, Oid.INT4, Oid.INT8, Oid.FLOAT4, Oid.FLOAT8, Oid.BOOL,
            Oid.DATE, Oid.TIME, Oid.TIMESTAMP, Oid.TIMESTAMPTZ, Oid.OID,
            Oid.TEXT]
    table = TableSchema(77, TableName("s", "wide"), tuple(
        ColumnSchema(f"c{i}", oid, modifier=i, nullable=i % 2 == 0,
                     primary_key_ordinal=1 if i == 1 else None)
        for i, oid in enumerate(oids)))
    ref = ReplicatedTableSchema.with_all_columns(table)
    port = convert.schema_from_plain(
        ref.id, ref.name.schema, ref.name.name,
        [(c.name, c.type_oid, c.modifier, c.nullable, c.primary_key_ordinal)
         for c in ref.table_schema.columns],
        list(ref.replication_mask), list(ref.identity_mask))
    assert port.to_json() == ref.to_json()
    rng = np.random.default_rng(5)
    rspecs, pspecs = [], []
    for i, c in enumerate(ref.replicated_columns):
        pk = port.replicated_columns[i].kind
        assert pk.name == c.kind.name
        if c.kind.name == "STRING":
            continue
        w = int(rng.integers(1, 40))
        rspecs.append((i, RK[c.kind.name], w + 16, w))
        pspecs.append((i, pk, w + 16, w))
    a, b = ref_layout(tuple(rspecs)), port_layout(tuple(pspecs))
    assert a.n_words == b.n_words and a.total_bits == b.total_bits
    assert [k.name for k in a.kinds] == [k.name for k in b.kinds]
    assert [[(s.comp, s.bit_off, s.bits, s.zigzag) for s in col]
            for col in a.slots] == [[(s.comp, s.bit_off, s.bits, s.zigzag)
                                     for s in col] for col in b.slots]


def test_fused_route_by_shape():
    """`fused_walk`: K2c's walk where its word tile fits beside the rows'
    tile (256 rows on the pgbench shape, a sub-tile on a wider one,
    direct where a base pointer is off 16-byte alignment), None (the
    two-launch route) where it does not fit beside a 32-row sub-tile."""
    def fits(n_cols, width, n_words, view=lambda t: t):
        bm = view(torch.zeros((65, n_cols * width // 2), dtype=torch.uint8))
        ln = view(torch.zeros((65, n_cols), dtype=torch.uint8))
        fl = view(torch.zeros(65, dtype=torch.uint8))
        return decode_kernel.fused_walk(bm, ln, fl, n_cols, 40, n_words)

    assert fits(3, 8, 2) == 256  # pgbench: 12 nibble bytes, 2 words
    assert fits(100, 12, 35) == 64
    assert fits(3, 8, 2, view=lambda t: t[1:]) == 0
    assert fits(260, 12, 90) is None
    assert decode_kernel.tile_bytes(32, 1560, 260, True, 40, True, 90) \
        > decode_kernel.SMEM_BUDGET
    assert decode_kernel.tile_bytes(0, 12, 3, True, 40, True, 2) == 2048
    # two rows a thread on 256-row tiles of all-integer nibble layouts only
    pgbench = tuple((i, PK.I32, 8, 8) for i in range(3))
    assert [decode_kernel.compact_rows_per_thread(pgbench, True, rows)
            for rows in (256, 128, 0)] == [2, 1, 1]
    assert decode_kernel.compact_rows_per_thread(
        ((0, PK.TIMESTAMP, 32, 2),), True, 256) == 1


def test_fused_wrapper_cpu_route_is_the_plain_version():
    from etl_tpu_torch.ops.bitpack import parse_and_pack_plain
    from etl_tpu_torch.ops.predicate import compile_row_filter
    from etl_tpu_torch.testing import filter_case

    pred = compile_row_filter("a > 1", _schema())
    specs = ((0, PK.I32, 12, 10),)
    bm, ln, fl = (torch.from_numpy(a) for a in filter_case(
        specs, 700, np.random.default_rng(5), False))
    want = parse_and_pack_plain(bm, ln, specs, False, pred=pred,
                                row_flags=fl)
    for got in (decode_kernel.filter_pack_compact(bm, ln, fl, specs, False,
                                                  pred),
                decode_kernel.prepare_filtered(bm, ln, fl, specs, False,
                                               pred)()):
        for a, b in zip(got, want):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
