"""Iceberg v2 table-metadata writer: Avro manifests + snapshots.

Reference parity: crates/etl-destinations/src/iceberg/{core,schema}.rs —
the reference commits Arrow/Parquet appends as REAL Iceberg snapshots:
a manifest file (Avro) listing the data files with per-column statistics,
a manifest list (Avro) naming the manifests with row-count summaries, and
a snapshot record referencing the manifest list. This module produces the
same artifacts from scratch:

- a minimal, schema-driven Avro Object Container File writer (no avro
  library is installed — same stance as the hand-rolled protobuf codec in
  bq_proto.py);
- the Iceberg v2 `manifest_entry` / `manifest_file` Avro schemas (public
  spec, https://iceberg.apache.org/spec/ — field-id annotations kept so
  conformant readers can map columns);
- data-file statistics gathered from the Parquet footer (record counts,
  column sizes, null counts, lower/upper bounds in Iceberg's
  single-value binary serialization).

Copy of the reference's `etl_tpu/destinations/iceberg_meta.py`. Only
`data_file_stats` needs pyarrow, and imports it inside. Every random
identifier (the OCF sync marker, manifest file names, snapshot ids) is
drawn from the `rng` argument where one is given (a `random.Random` a
test seeds), else from a fresh version-4 UUID as in the reference.

The independent READER used to verify these files lives in
testing/avro_reader.py and shares no code with this writer.
"""

from __future__ import annotations

import json
import random
import struct
from dataclasses import dataclass, field
from pathlib import Path

from .util import new_uuid4 as _uuid4

# ---------------------------------------------------------------------------
# Avro binary encoding (writer side)
# ---------------------------------------------------------------------------


def _zigzag(n: int) -> bytes:
    """Avro int/long: zigzag + base-128 varint, little-endian groups."""
    u = (n << 1) ^ (n >> 63)
    out = bytearray()
    while True:
        b = u & 0x7F
        u >>= 7
        if u:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _encode(schema, value, out: bytearray) -> None:
    """Schema-driven Avro binary encoding (subset: the types Iceberg
    metadata uses — null/boolean/int/long/bytes/string/record/array/
    union/map)."""
    if isinstance(schema, list):  # union — here always [null, X]
        if value is None:
            out += _zigzag(schema.index("null"))
            return
        branch = next(i for i, s in enumerate(schema) if s != "null")
        out += _zigzag(branch)
        _encode(schema[branch], value, out)
        return
    t = schema["type"] if isinstance(schema, dict) else schema
    if t == "null":
        return
    if t == "boolean":
        out.append(1 if value else 0)
    elif t in ("int", "long"):
        out += _zigzag(int(value))
    elif t == "float":
        out += struct.pack("<f", value)
    elif t == "double":
        out += struct.pack("<d", value)
    elif t == "bytes":
        out += _zigzag(len(value))
        out += value
    elif t == "string":
        raw = value.encode()
        out += _zigzag(len(raw))
        out += raw
    elif t == "record":
        for f in schema["fields"]:
            _encode(f["type"], value.get(f["name"]), out)
    elif t == "array":
        items = list(value)
        if items:
            out += _zigzag(len(items))
            for item in items:
                _encode(schema["items"], item, out)
        out += _zigzag(0)
    elif t == "map":
        entries = list(value.items())
        if entries:
            out += _zigzag(len(entries))
            for k, v in entries:
                _encode("string", k, out)
                _encode(schema["values"], v, out)
        out += _zigzag(0)
    else:
        raise ValueError(f"avro writer: unsupported type {t!r}")


_OCF_MAGIC = b"Obj\x01"


def write_avro_ocf(path: str | Path, schema: dict, records: list[dict],
                   metadata: dict[str, str] | None = None,
                   rng: "random.Random | None" = None) -> int:
    """Write an Avro Object Container File (null codec, one block).
    Returns the file length in bytes."""
    body = bytearray()
    for rec in records:
        _encode(schema, rec, body)
    sync = _uuid4(rng).bytes  # 16-byte sync marker
    meta = {"avro.schema": json.dumps(schema), "avro.codec": "null"}
    for k, v in (metadata or {}).items():
        meta[k] = v
    out = bytearray(_OCF_MAGIC)
    _encode({"type": "map", "values": "string"}, meta, out)
    out += sync
    out += _zigzag(len(records))
    out += _zigzag(len(body))
    out += body
    out += sync
    Path(path).write_bytes(bytes(out))
    return len(out)


# ---------------------------------------------------------------------------
# Iceberg v2 manifest schemas (public spec; field-id annotations preserved)
# ---------------------------------------------------------------------------


def _idmap(name: str, key_id: int, value_id: int, value_type: str) -> dict:
    """Iceberg serializes its int-keyed stat maps as arrays of key/value
    records (logicalType map) so Avro field-ids can annotate both sides."""
    return {"type": "array", "logicalType": "map", "items": {
        "type": "record", "name": name, "fields": [
            {"name": "key", "type": "int", "field-id": key_id},
            {"name": "value", "type": value_type, "field-id": value_id},
        ]}}


DATA_FILE_SCHEMA = {"type": "record", "name": "r2", "fields": [
    {"name": "content", "type": "int", "field-id": 134},
    {"name": "file_path", "type": "string", "field-id": 100},
    {"name": "file_format", "type": "string", "field-id": 101},
    {"name": "partition",
     "type": {"type": "record", "name": "r102", "fields": []},
     "field-id": 102},
    {"name": "record_count", "type": "long", "field-id": 103},
    {"name": "file_size_in_bytes", "type": "long", "field-id": 104},
    {"name": "column_sizes", "type": ["null", _idmap("k117_v118", 117, 118,
                                                     "long")],
     "field-id": 108},
    {"name": "value_counts", "type": ["null", _idmap("k119_v120", 119, 120,
                                                     "long")],
     "field-id": 109},
    {"name": "null_value_counts",
     "type": ["null", _idmap("k121_v122", 121, 122, "long")],
     "field-id": 110},
    {"name": "lower_bounds",
     "type": ["null", _idmap("k126_v127", 126, 127, "bytes")],
     "field-id": 125},
    {"name": "upper_bounds",
     "type": ["null", _idmap("k129_v130", 129, 130, "bytes")],
     "field-id": 128},
]}

MANIFEST_ENTRY_SCHEMA = {
    "type": "record", "name": "manifest_entry", "fields": [
        {"name": "status", "type": "int", "field-id": 0},
        {"name": "snapshot_id", "type": ["null", "long"], "field-id": 1,
         "default": None},
        {"name": "sequence_number", "type": ["null", "long"], "field-id": 3,
         "default": None},
        {"name": "file_sequence_number", "type": ["null", "long"],
         "field-id": 4, "default": None},
        {"name": "data_file", "type": DATA_FILE_SCHEMA, "field-id": 2},
    ],
}

MANIFEST_FILE_SCHEMA = {
    "type": "record", "name": "manifest_file", "fields": [
        {"name": "manifest_path", "type": "string", "field-id": 500},
        {"name": "manifest_length", "type": "long", "field-id": 501},
        {"name": "partition_spec_id", "type": "int", "field-id": 502},
        {"name": "content", "type": "int", "field-id": 517},
        {"name": "sequence_number", "type": "long", "field-id": 515},
        {"name": "min_sequence_number", "type": "long", "field-id": 516},
        {"name": "added_snapshot_id", "type": "long", "field-id": 503},
        {"name": "added_files_count", "type": "int", "field-id": 504},
        {"name": "existing_files_count", "type": "int", "field-id": 505},
        {"name": "deleted_files_count", "type": "int", "field-id": 506},
        {"name": "added_rows_count", "type": "long", "field-id": 512},
        {"name": "existing_rows_count", "type": "long", "field-id": 513},
        {"name": "deleted_rows_count", "type": "long", "field-id": 514},
    ],
}


# ---------------------------------------------------------------------------
# Data-file statistics (from the Parquet footer) + single-value bounds
# ---------------------------------------------------------------------------


def bound_bytes(value, iceberg_type: str = "") -> bytes | None:
    """Iceberg single-value binary serialization for bounds (spec
    Appendix D): little-endian fixed width — 4 bytes for int/float/date,
    8 for long/double/timestamps — UTF-8 for strings. The declared
    `iceberg_type` picks the width; a conformant reader checks buffer
    sizes against the field type, so packing every int as 8 bytes would
    break scan planning on real catalogs. Types outside the subset
    return None (bound omitted)."""
    import datetime

    if isinstance(value, bool):
        return b"\x01" if value else b"\x00"
    if isinstance(value, int):
        return struct.pack("<i" if iceberg_type in ("int", "date")
                           else "<q", value)
    if isinstance(value, float):
        return struct.pack("<f" if iceberg_type == "float" else "<d",
                           value)
    if isinstance(value, str):
        return value.encode()
    if isinstance(value, bytes):
        return value
    if isinstance(value, datetime.datetime):
        epoch = datetime.datetime(1970, 1, 1, tzinfo=value.tzinfo)
        return struct.pack("<q", int((value - epoch).total_seconds() * 1e6))
    if isinstance(value, datetime.date):
        return struct.pack("<i", (value - datetime.date(1970, 1, 1)).days)
    return None


@dataclass
class DataFileInfo:
    """One Parquet data file plus the statistics Iceberg records for it."""

    file_path: str
    record_count: int
    file_size_in_bytes: int
    column_sizes: dict[int, int] = field(default_factory=dict)
    value_counts: dict[int, int] = field(default_factory=dict)
    null_value_counts: dict[int, int] = field(default_factory=dict)
    lower_bounds: dict[int, bytes] = field(default_factory=dict)
    upper_bounds: dict[int, bytes] = field(default_factory=dict)


def data_file_stats(parquet_path: str | Path,
                    field_ids: dict[str, int],
                    field_types: dict[int, str] | None = None
                    ) -> DataFileInfo:
    """Gather Iceberg data-file statistics from a Parquet footer.
    `field_ids` maps column name → Iceberg field id; `field_types` maps
    field id → Iceberg type string (drives bound byte widths)."""
    import pyarrow.parquet as pq

    p = Path(parquet_path)
    meta = pq.ParquetFile(p).metadata
    info = DataFileInfo(file_path=str(p), record_count=meta.num_rows,
                        file_size_in_bytes=p.stat().st_size)
    lows: dict[int, object] = {}
    highs: dict[int, object] = {}
    for rg in range(meta.num_row_groups):
        g = meta.row_group(rg)
        for ci in range(g.num_columns):
            col = g.column(ci)
            name = col.path_in_schema
            fid = field_ids.get(name)
            if fid is None:
                continue
            info.column_sizes[fid] = info.column_sizes.get(fid, 0) \
                + col.total_compressed_size
            info.value_counts[fid] = info.value_counts.get(fid, 0) \
                + col.num_values
            st = col.statistics
            if st is None:
                continue
            if st.null_count is not None:
                info.null_value_counts[fid] = \
                    info.null_value_counts.get(fid, 0) + st.null_count
            if st.has_min_max:
                if fid not in lows or st.min < lows[fid]:
                    lows[fid] = st.min
                if fid not in highs or st.max > highs[fid]:
                    highs[fid] = st.max
    types = field_types or {}
    for fid, v in lows.items():
        b = bound_bytes(v, types.get(fid, ""))
        if b is not None:
            info.lower_bounds[fid] = b
    for fid, v in highs.items():
        b = bound_bytes(v, types.get(fid, ""))
        if b is not None:
            info.upper_bounds[fid] = b
    return info


# ---------------------------------------------------------------------------
# Manifest + manifest-list + snapshot assembly
# ---------------------------------------------------------------------------


def _stat_map(d: dict[int, object]) -> list[dict] | None:
    return [{"key": k, "value": v} for k, v in sorted(d.items())] or None


@dataclass
class ManifestInfo:
    manifest_path: str
    manifest_length: int
    added_files_count: int
    added_rows_count: int
    sequence_number: int


def write_manifest(metadata_dir: str | Path, files: list[DataFileInfo],
                   snapshot_id: int, sequence_number: int,
                   table_schema_json: str,
                   rng: "random.Random | None" = None) -> ManifestInfo:
    """Write one Avro manifest file listing `files` as ADDED entries."""
    d = Path(metadata_dir)
    d.mkdir(parents=True, exist_ok=True)
    path = d / f"{_uuid4(rng).hex}-m0.avro"
    entries = [{
        "status": 1,  # ADDED
        "snapshot_id": snapshot_id,
        "sequence_number": sequence_number,
        "file_sequence_number": sequence_number,
        "data_file": {
            "content": 0,  # DATA
            "file_path": f.file_path,
            "file_format": "PARQUET",
            "partition": {},
            "record_count": f.record_count,
            "file_size_in_bytes": f.file_size_in_bytes,
            "column_sizes": _stat_map(f.column_sizes),
            "value_counts": _stat_map(f.value_counts),
            "null_value_counts": _stat_map(f.null_value_counts),
            "lower_bounds": _stat_map(f.lower_bounds),
            "upper_bounds": _stat_map(f.upper_bounds),
        },
    } for f in files]
    length = write_avro_ocf(
        path, MANIFEST_ENTRY_SCHEMA, entries,
        metadata={"schema": table_schema_json,
                  "partition-spec": "[]", "partition-spec-id": "0",
                  "format-version": "2", "content": "data"}, rng=rng)
    return ManifestInfo(
        manifest_path=str(path), manifest_length=length,
        added_files_count=len(files),
        added_rows_count=sum(f.record_count for f in files),
        sequence_number=sequence_number)


def write_manifest_list(metadata_dir: str | Path,
                        manifests: list[ManifestInfo],
                        snapshot_id: int, sequence_number: int,
                        rng: "random.Random | None" = None) -> str:
    """Write the Avro manifest list a snapshot points at."""
    d = Path(metadata_dir)
    d.mkdir(parents=True, exist_ok=True)
    path = d / f"snap-{snapshot_id}-1-{_uuid4(rng).hex}.avro"
    records = [{
        "manifest_path": m.manifest_path,
        "manifest_length": m.manifest_length,
        "partition_spec_id": 0,
        "content": 0,
        "sequence_number": m.sequence_number,
        "min_sequence_number": m.sequence_number,
        "added_snapshot_id": snapshot_id,
        "added_files_count": m.added_files_count,
        "existing_files_count": 0,
        "deleted_files_count": 0,
        "added_rows_count": m.added_rows_count,
        "existing_rows_count": 0,
        "deleted_rows_count": 0,
    } for m in manifests]
    write_avro_ocf(path, MANIFEST_FILE_SCHEMA, records,
                   metadata={"snapshot-id": str(snapshot_id),
                             "sequence-number": str(sequence_number),
                             "format-version": "2"}, rng=rng)
    return str(path)


def new_snapshot_id(rng: "random.Random | None" = None) -> int:
    # Iceberg snapshot ids are positive 63-bit values
    return _uuid4(rng).int & ((1 << 62) - 1)


def build_snapshot(snapshot_id: int, parent_snapshot_id: int | None,
                   sequence_number: int, manifest_list: str,
                   operation: str, added_files: int, added_records: int,
                   total_records: int, timestamp_ms: int,
                   schema_id: int) -> dict:
    """Snapshot JSON for the REST commit's add-snapshot update."""
    snap = {
        "snapshot-id": snapshot_id,
        "sequence-number": sequence_number,
        "timestamp-ms": timestamp_ms,
        "manifest-list": manifest_list,
        "schema-id": schema_id,
        "summary": {
            "operation": operation,
            "added-data-files": str(added_files),
            "added-records": str(added_records),
            "total-records": str(total_records),
        },
    }
    if parent_snapshot_id is not None:
        snap["parent-snapshot-id"] = parent_snapshot_id
    return snap
