"""Program enumeration for the IR tier.

A `ProgramDescriptor` is everything needed to launch ONE decode program
exactly the way the engine's dispatch would: canonical specs, row
bucket, variant (which kernel, or the host route's plain versions),
nibble packing and the compiled row filter for fused-filter variants.
The catalog enumerates descriptors from three sources:

  * the built-in schema catalog below (the reference's: pgbench, a
    kind-diverse table, a nibble-eligible one, and pgbench under the
    bench suite's `abalance < 0` filter), so the tier has real coverage
    even on a fresh checkout with an empty program store;
  * the program store's *observed signatures* — the dispatch keys the
    engine recorded from live batches, folded in so layouts actually
    seen in production are re-verified on every lint run;
  * a permuted-column twin per multi-column schema, feeding the
    ir-canonical-dedup contract.

Variants: `device` (K1), `nibble` (K1 nibble-packed), `filtered` (K2c,
or K2 + the compaction epilogue where K2c's word tile does not fit: the
engine's own choice, `decode_kernel.prepare_filtered`), `egress-tsv` and
`egress-json` (the render kernel), and `host` / `filtered-host` (the
host route's plain versions on CPU tensors). The reference's separate
Pallas and XLA programs are one K1 program here, listed once. With a
mesh (`build_catalog(mesh=…)`, parallel/mesh.py) the catalogue is the
mesh's variants alone, as the reference's forced-8-device pass: `mesh`
(K1 on every shard's row block, nibble-packed where the layout allows,
as the engine packs it), `mesh-filtered` (the filtered decode on every
block) and `mesh-egress-tsv` / `mesh-egress-json` (the render on every
block's words), at the buckets the shard count divides.

Descriptor tags (`programs/<kinds>-<hash8>`) derive from the canonical
specs via the program store's stable repr, so the finding namespace is
identical across processes and machines.
"""

from __future__ import annotations

import dataclasses
import hashlib

#: variants whose program is a kernel launch on the card, by kernel
KERNEL_OF_VARIANT = {"device": "k1", "nibble": "k1", "filtered": "k2c",
                     "egress-tsv": "render", "egress-json": "render"}
#: the mesh's variants, by the kernel each launches once a shard
MESH_KERNEL_OF_VARIANT = {"mesh": "k1", "mesh-filtered": "k2c",
                          "mesh-egress-tsv": "render",
                          "mesh-egress-json": "render"}


@dataclasses.dataclass
class ProgramDescriptor:
    """One launchable decode program (see module docstring)."""
    tag: str            # stable layout tag, e.g. "i32x3-1f2e3d4c"
    specs: tuple        # canonical (slot, kind, gather_w, bit_w) specs
    row_capacity: int
    variant: str        # device|nibble|filtered|egress-*|host|filtered-host
    nibble: bool = False
    pred: object = None           # predicate.CompiledRowFilter | None
    source: str = "schema"        # schema | observed
    #: wire-encoder name (ops/egress.py) — set on egress-program
    #: descriptors, which launch the SECOND stage (words → wire text)
    #: instead of a decode program
    egress: str = None
    #: permuted-twin canonical specs for ir-canonical-dedup (None = skip)
    dedup_twin: tuple = None
    #: the mesh (parallel.mesh.DecodeMesh) of a mesh variant: its rows
    #: are launched a shard's block at a time
    mesh: object = None

    @property
    def path(self) -> str:
        return f"programs/{self.tag}"

    @property
    def scope(self) -> str:
        return f"{self.variant}-r{self.row_capacity}"

    @property
    def host(self) -> bool:
        return self.variant in ("host", "filtered-host")

    @property
    def n_shards(self) -> int:
        return self.mesh.size if self.mesh is not None else 0


def layout_tag(specs: tuple) -> str:
    """`<kind-counts>-<hash8>`: human-greppable prefix + collision-proof
    stable hash of the canonical specs."""
    from ...ops.program_store import _stable_repr

    counts: dict = {}
    for _, kind, _, _ in specs:
        name = kind.name.lower()
        counts[name] = counts.get(name, 0) + 1
    kinds = "+".join(f"{k}x{n}" for k, n in sorted(counts.items()))
    digest = hashlib.sha256(_stable_repr(specs).encode()).hexdigest()[:8]
    return f"{kinds or 'empty'}-{digest}"


def _table(name: str, cols) -> "object":
    from ...models import ReplicatedTableSchema, TableName, TableSchema

    oid = 90000 + sum(name.encode()) % 1000
    return ReplicatedTableSchema.with_all_columns(TableSchema(
        oid, TableName("public", name), tuple(cols)))


def default_schemas() -> list:
    """(name, schema) pairs the tier always covers (the reference's
    catalog). Chosen for span, not volume: every dense kind family
    appears, one schema is nibble-eligible (all-int, even widths), and
    one mixes dense with host-object columns the way real tables do."""
    from ...models import ColumnSchema, Oid

    pgbench = _table("pgbench_accounts", (
        ColumnSchema("aid", Oid.INT4, nullable=False, primary_key_ordinal=1),
        ColumnSchema("bid", Oid.INT4),
        ColumnSchema("abalance", Oid.INT4),
        ColumnSchema("filler", Oid.BPCHAR, modifier=88)))
    # every remaining dense kind family + object spill (numeric/text)
    kinds_wide = _table("lint_kinds_wide", (
        ColumnSchema("id", Oid.INT8, nullable=False, primary_key_ordinal=1),
        ColumnSchema("flag", Oid.BOOL),
        ColumnSchema("small", Oid.INT2),
        ColumnSchema("ratio", Oid.FLOAT4),
        ColumnSchema("total", Oid.FLOAT8),
        ColumnSchema("born", Oid.DATE),
        ColumnSchema("at_time", Oid.TIME),
        ColumnSchema("created", Oid.TIMESTAMP),
        ColumnSchema("updated", Oid.TIMESTAMPTZ),
        ColumnSchema("amount", Oid.NUMERIC),
        ColumnSchema("note", Oid.TEXT)))
    # nibble-eligible: int/date kinds only — exercises the halved-upload
    # program variant
    nibble = _table("lint_nibble", (
        ColumnSchema("a", Oid.INT4, nullable=False, primary_key_ordinal=1),
        ColumnSchema("b", Oid.INT8),
        ColumnSchema("d", Oid.DATE)))
    return [("pgbench_accounts", pgbench),
            ("lint_kinds_wide", kinds_wide),
            ("lint_nibble", nibble)]


def filtered_schema():
    """pgbench with the bench suite's `abalance < 0` publication row
    filter — kernel-supported, referenced column dense."""
    from ...ops.predicate import parse_row_filter

    _, schema = default_schemas()[0]
    return ("pgbench_filtered",
            schema.with_row_predicate(parse_row_filter("abalance < 0")))


def _decoder(schema):
    """A CPU decoder of `schema`: its specs are the card's (they depend
    on the schema and the batch, not on the device), and it loads no
    kernel library."""
    from ...ops.engine import DeviceDecoder

    return DeviceDecoder(schema, device="cpu", telemetry=False,
                         device_min_rows=1 << 30)


def _device_specs(dec):
    """The device-path width signature for an all-NULL batch at minimum
    gather widths — the deterministic signature the tier verifies (real
    batches bucket up from here; the program structure is identical)."""
    from ...ops.staging import synthetic_staged_batch

    staged = synthetic_staged_batch(len(dec.schema.replicated_columns), 64)
    widths = dec._widths(staged)
    return dec._specs(staged, widths), widths


def build_catalog(*, mesh=None, row_buckets=None,
                  include_observed: bool = True) -> list:
    """All descriptors for one run, deterministically ordered: the
    single-device set, or with `mesh` the mesh's variants alone (module
    docstring)."""
    from ...ops.egress import ENCODER_JSON, ENCODER_TSV, plan_for_specs
    from ...ops.program_store import canonical_plan, load_observed
    from ...parallel.mesh import mesh_cache_key

    buckets = tuple(row_buckets) if row_buckets else (4096,)
    out: list[ProgramDescriptor] = []
    seen: set = set()

    def add(desc: ProgramDescriptor):
        key = (desc.specs, desc.row_capacity, desc.variant, desc.nibble,
               desc.n_shards,
               desc.pred.fingerprint() if desc.pred is not None else None,
               desc.egress)
        if key in seen:
            return
        seen.add(key)
        out.append(desc)

    for _name, schema in default_schemas() + [filtered_schema()]:
        dec = _decoder(schema)
        host_specs = dec._host_specs()
        if not host_specs:
            continue
        pred = dec._row_filter
        if pred is not None and not pred.kernel_supported:
            pred = None
        dev_specs, widths = _device_specs(dec)
        # an unfiltered batch is packed in its canonical layout, a
        # filtered one in its exact layout (the filter names columns):
        # engine._pack_stage, on either route
        host_layout = canonical_plan(host_specs).specs if pred is None \
            else host_specs
        dev_layout = canonical_plan(dev_specs).specs if pred is None \
            else dev_specs
        # permuted twin: reversed column order must canonicalize to the
        # same layout; the runner compares the two programs' descriptors
        twin = canonical_plan(tuple(reversed(dev_specs))).specs \
            if len(dev_specs) > 1 and pred is None else None
        # egress programs: the wire-encoding second stage, enumerated
        # per (layout, encoder) — only for layouts with at least one
        # renderable field, and never under a filter (a filtered batch
        # ships no device text)
        egress_encoders = [e for e in (ENCODER_TSV, ENCODER_JSON)
                           if pred is None
                           and plan_for_specs(dev_layout, e) is not None]
        for bucket in buckets:
            if mesh is not None:
                if bucket % mesh.size:
                    continue
                add(ProgramDescriptor(
                    tag=layout_tag(dev_layout), specs=dev_layout,
                    row_capacity=bucket,
                    variant="mesh-filtered" if pred is not None else "mesh",
                    nibble=dec._can_nibble(widths), pred=pred, mesh=mesh))
                for enc in egress_encoders:
                    add(ProgramDescriptor(
                        tag=layout_tag(dev_layout), specs=dev_layout,
                        row_capacity=bucket, variant=f"mesh-egress-{enc}",
                        egress=enc, mesh=mesh))
                continue
            add(ProgramDescriptor(
                tag=layout_tag(host_layout), specs=host_layout,
                row_capacity=bucket,
                variant="filtered-host" if pred is not None else "host",
                pred=pred))
            add(ProgramDescriptor(
                tag=layout_tag(dev_layout), specs=dev_layout,
                row_capacity=bucket,
                variant="filtered" if pred is not None else "device",
                pred=pred, dedup_twin=twin))
            if pred is None and dec._can_nibble(widths):
                add(ProgramDescriptor(
                    tag=layout_tag(dev_layout), specs=dev_layout,
                    row_capacity=bucket, variant="nibble", nibble=True))
            for enc in egress_encoders:
                add(ProgramDescriptor(
                    tag=layout_tag(dev_layout), specs=dev_layout,
                    row_capacity=bucket, variant=f"egress-{enc}",
                    egress=enc))

    if include_observed:
        # observed dispatch signatures: key shape is (row_capacity,
        # canonical specs, nibble, mesh fingerprint, predicate
        # fingerprint, route) — see DeviceDecoder._dispatch_stage. A
        # mesh key joins the pass of its mesh, any other the
        # single-device pass. Only unfiltered keys are reconstructable
        # from the fingerprint alone (a fingerprint cannot be turned
        # back into a CompiledRowFilter without its schema).
        want_mesh = mesh_cache_key(mesh)
        for key in load_observed():
            if key[3] != want_mesh or key[4] is not None \
                    or key[5] not in ("host", "device"):
                continue
            row_capacity, specs, nibble = key[0], key[1], bool(key[2])
            if not (isinstance(specs, tuple) and specs
                    and all(isinstance(s, tuple) and len(s) == 4
                            for s in specs)):
                continue
            if mesh is not None:
                variant = "mesh"
            else:
                variant = "host" if key[5] == "host" \
                    else "nibble" if nibble else "device"
            add(ProgramDescriptor(
                tag=layout_tag(specs), specs=specs,
                row_capacity=row_capacity, variant=variant,
                nibble=nibble and variant in ("nibble", "mesh"),
                source="observed", mesh=mesh))

    out.sort(key=lambda d: (d.path, d.scope, d.source))
    return out
