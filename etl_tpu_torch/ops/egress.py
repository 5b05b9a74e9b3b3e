"""Device egress: render destination-ready text from the decoded words.

Copy of the reference's `etl_tpu/ops/egress.py` without JAX. The last
host stage of the decode pipeline — turning typed columns into wire
bytes (ClickHouse TSV fields, Snowpipe NDJSON values) — costs more than
the decode itself on the streaming path: per-batch numpy `astype("U21")`
round trips, per-value `str()` loops, a Python `"\\t".join` per row.
The render turns the decode kernel's packed `uint32[n_words, R]` words,
while they are still on the card, into left-aligned ASCII bytes plus
per-row lengths for each rendered column:

    render(words) -> (ebytes uint8[R, sum(widths)], elens int32[R, n])

Renderable kinds are the ones whose canonical Postgres text is pure
integer arithmetic — bools, the int family (minimal decimal, the digits
`str(int)` gives), dates and timestamps (civil-from-days,
`YYYY-MM-DD[ HH:MM:SS.ffffff]`, always 6 fractional digits like
`np.datetime_as_string(unit="us")`). Floats stay host-side (shortest
`repr` is not vectorizable) and strings ride the text gather.

The reference's render is an XLA program (`build_egress_program`); the
port has a kernel written for Hopper (`csrc/egress_render.cu`, wrapper in
`ops/egress_kernel.py`) and its plain PyTorch version, `render_plain`.
`render` sends a CUDA tensor to the kernel and a CPU tensor to the plain
version. Nothing is compiled per plan: the kernel reads the plan from a
small descriptor.

Correctness stance: the render covers every row, but destinations use
only TRUSTED rows — rows the decode itself verified (ok bits, no
oversize, no nibble flag). Everything else (NULLs, TOAST, specials like
`infinity`, fallback rows) is rendered host-side by the per-value oracle
and spliced in whole, so the assembled wire bytes are byte-identical to
the host columnar encoders by construction. The host twins in this
module (`int_text_fixed` & co.) produce the same buffers from a decoded
`ColumnarBatch` when no device buffer landed, so destinations have ONE
fast assembly path with two byte-identical buffer sources.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.pgtypes import CellKind
from .bitpack import layout_for_specs
from .parsers import wrap32

#: encoder names destinations declare via `Destination.egress_encoder`
ENCODER_TSV = "tsv"    # ClickHouse TSV fields (clickhouse.render_value)
ENCODER_JSON = "json"  # Snowpipe NDJSON values (snowflake JSON texts)

#: left-aligned output byte width per renderable kind (worst-case text)
_FIELD_WIDTH = {
    CellKind.BOOL: 5,          # "false"
    CellKind.I16: 6,           # "-32768"
    CellKind.I32: 11,          # "-2147483648"
    CellKind.U32: 10,          # "4294967295"
    CellKind.I64: 20,          # "-9223372036854775808"
    CellKind.DATE: 10,         # "YYYY-MM-DD"
    CellKind.TIMESTAMP: 26,    # "YYYY-MM-DD HH:MM:SS.ffffff"
    CellKind.TIMESTAMPTZ: 26,
}

#: max decimal digits of the magnitude per int-family kind
_MAX_DIGITS = {CellKind.I16: 5, CellKind.I32: 10, CellKind.U32: 10}

_INT_KINDS = frozenset({CellKind.I16, CellKind.I32, CellKind.U32})

#: kinds each encoder can render on device. TSV covers the temporals
#: (ClickHouse wants "YYYY-MM-DD HH:MM:SS.ffffff" — exactly the civil
#: rendering); NDJSON keeps temporals host-side (snowflake's JSON text
#: goes through the generic `json.dumps(encode_value(...))` path whose
#: quoting/format is not worth re-specifying on device).
ENCODER_KINDS = {
    ENCODER_TSV: frozenset({
        CellKind.BOOL, CellKind.I16, CellKind.I32, CellKind.U32,
        CellKind.I64, CellKind.DATE, CellKind.TIMESTAMP,
        CellKind.TIMESTAMPTZ,
    }),
    ENCODER_JSON: frozenset({
        CellKind.BOOL, CellKind.I16, CellKind.I32, CellKind.U32,
        CellKind.I64,
    }),
}

#: widest schema slice the egress program renders: past this the unrolled
#: per-digit selects bloat the program for columns the host renders
#: about as fast anyway (the win concentrates in the common narrow CDC
#: schemas)
EGRESS_MAX_COLS = 32


@dataclasses.dataclass(frozen=True)
class EgressPlan:
    """Static render plan for one (canonical specs, encoder) signature.
    `slots` are canonical slot indices into the pspecs the decode
    program packed — completion maps real schema columns onto them
    through the canonical plan's `slot_of`, exactly like column unpack."""

    encoder: str
    slots: tuple[int, ...]
    kinds: tuple[CellKind, ...]
    widths: tuple[int, ...]

    @property
    def total_width(self) -> int:
        return sum(self.widths)

    @property
    def offsets(self) -> tuple[int, ...]:
        out, off = [], 0
        for w in self.widths:
            out.append(off)
            off += w
        return tuple(out)


def plan_for_specs(pspecs: tuple, encoder: str) -> "EgressPlan | None":
    """The render plan for a packed layout, or None when the encoder is
    unknown, nothing in the layout is device-renderable, or the schema
    is too wide to be worth unrolling."""
    kinds_ok = ENCODER_KINDS.get(encoder)
    if kinds_ok is None or not pspecs:
        return None
    slots, kinds, widths = [], [], []
    for j, (_, kind, _, _) in enumerate(pspecs):
        if kind in kinds_ok:
            slots.append(j)
            kinds.append(kind)
            widths.append(_FIELD_WIDTH[kind])
    if not slots or len(slots) > EGRESS_MAX_COLS:
        return None
    return EgressPlan(encoder, tuple(slots), tuple(kinds), tuple(widths))


# ---------------------------------------------------------------------------
# the render: plain PyTorch version (and the kernel's dispatch)
# ---------------------------------------------------------------------------
#
# Written from the reference's `_extract`, `_signed`, `_field_value`,
# `_digits_to_bytes`, `_render_u32_family`, `_render_i64`, `_render_bool`,
# `_civil` and `_render_timestamp`. The reference computes in int32/uint32;
# here every value is an int64 tensor holding the same number (CPU torch
# has little uint32 arithmetic): a field is masked to its bits, a signed
# value wraps to int32, and every division that may see a negative operand
# is a floor division, as jnp's `//` and `%` on integers are.

#: the components each renderable kind reads, in the kernel's order
RENDER_COMPONENTS = {
    CellKind.BOOL: ("v",), CellKind.I16: ("v",), CellKind.I32: ("v",),
    CellKind.U32: ("v",), CellKind.I64: ("neg", "l0", "l1", "l2"),
    CellKind.DATE: ("days",), CellKind.TIMESTAMP: ("days", "ms", "us"),
    CellKind.TIMESTAMPTZ: ("days", "ms", "us"),
}

_P10 = [10 ** i for i in range(10)]


def _extract(words: torch.Tensor, slot) -> torch.Tensor:
    """Raw field bits of one packed slot, pre-zigzag, as int64[R] in
    [0, 2^32): words are int64[n_words, R] holding uint32 values."""
    w, sh = divmod(slot.bit_off, 32)
    v = words[w] >> sh
    if sh + slot.bits > 32:
        v = (v | (words[w + 1] << (32 - sh))) & 0xFFFFFFFF
    if slot.bits < 32:
        v = v & ((1 << slot.bits) - 1)
    return v


def _field_value(words, fields: dict, name: str) -> torch.Tensor:
    """Decoded int32 component (zeros when the layout omitted it)."""
    s = fields.get(name)
    if s is None:
        return torch.zeros(words.shape[1], dtype=torch.int64,
                           device=words.device)
    raw = _extract(words, s)
    if s.zigzag:
        return (raw >> 1) ^ -(raw & 1)
    return wrap32(raw)


def _fdiv(a, b: int):
    return torch.div(a, b, rounding_mode="floor")


def _digits_to_bytes(digit_at, nd, neg, width: int) -> list:
    L = nd + neg
    out = []
    for p in range(width):
        core = 48 + digit_at(nd - 1 - p + neg)
        if p == 0:
            core = torch.where(neg > 0, 45, core)  # '-'
        out.append(torch.where(p < L, core, 0))
    return out, L


def _render_u32_family(mag, neg, width: int, max_digits: int):
    nd = torch.ones_like(mag)
    for k in range(1, max_digits):
        nd = nd + (mag >= _P10[k]).long()
    p10 = torch.tensor(_P10[:max_digits], dtype=torch.int64,
                       device=mag.device)

    def digit_at(k):
        return (mag // p10[k.clamp(0, max_digits - 1)]) % 10

    return _digits_to_bytes(digit_at, nd, neg, width)


def _limb_digits(limb, hi: int):
    nd = torch.ones_like(limb)
    for k in range(1, hi):
        nd = nd + (limb >= _P10[k]).long()
    return nd


def _render_i64(neg, l0, l1, l2, width: int):
    """Minimal decimal of a base-10^9 limbed magnitude; the pack layout
    bounds l2 <= 9, so digit 18 is l2 itself."""
    nd = torch.where(l2 > 0, 19,
                     torch.where(l1 > 0, 9 + _limb_digits(l1, 9),
                                 _limb_digits(l0, 9)))
    p10 = torch.tensor(_P10[:9], dtype=torch.int64, device=l0.device)

    def digit_at(k):
        kc = k.clamp(0, 18)
        d0 = (l0 // p10[kc.clamp(0, 8)]) % 10
        d1 = (l1 // p10[(kc - 9).clamp(0, 8)]) % 10
        return torch.where(kc < 9, d0, torch.where(kc < 18, d1, l2 % 10))

    return _digits_to_bytes(digit_at, nd, neg, width)


_TRUE = (116, 114, 117, 101, 0)    # "true\0"
_FALSE = (102, 97, 108, 115, 101)  # "false"


def _render_bool(v, width: int):
    t = v > 0
    out = [torch.where(t, _TRUE[p], _FALSE[p]) for p in range(width)]
    return out, torch.where(t, 4, 5)


def _civil(days):
    """Howard Hinnant's civil_from_days, with floor divisions: untrusted
    rows may carry days before year 1."""
    z = days + 719468
    era = _fdiv(z, 146097)
    doe = z - era * 146097
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524)
                - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))
    mp = _fdiv(5 * doy + 2, 153)
    d = doy - _fdiv(153 * mp + 2, 5) + 1
    m = mp + torch.where(mp < 10, 3, -9)
    y = y + (m <= 2).long()
    return y, m, d


def _date_bytes(y, m, d) -> list:
    def dig(x, p):
        return 48 + torch.remainder(_fdiv(x, p), 10)

    c = torch.full_like(y, 45)  # '-'
    return [dig(y, 1000), dig(y, 100), dig(y, 10), dig(y, 1), c,
            dig(m, 10), dig(m, 1), c, dig(d, 10), dig(d, 1)]


def _render_timestamp(days, ms, us, width: int):
    """`YYYY-MM-DD HH:MM:SS.ffffff`. TIMESTAMPTZ rows arrive with ms
    shifted by the zone offset (possibly negative or past a day): floor
    it into [0, 86_400_000) and carry whole days first."""
    day_adj = _fdiv(ms, 86_400_000)
    ms = ms - day_adj * 86_400_000
    y, m, d = _civil(days + day_adj)
    hh = _fdiv(ms, 3_600_000)
    mi = torch.remainder(_fdiv(ms, 60_000), 60)
    ss = torch.remainder(_fdiv(ms, 1_000), 60)
    frac = torch.remainder(ms, 1_000) * 1_000 + us
    out = _date_bytes(y, m, d)
    out.append(torch.full_like(y, 32))  # ' '
    out += [48 + hh // 10, 48 + hh % 10, torch.full_like(y, 58),
            48 + mi // 10, 48 + mi % 10, torch.full_like(y, 58),
            48 + ss // 10, 48 + ss % 10, torch.full_like(y, 46)]
    for p in (100_000, 10_000, 1_000, 100, 10, 1):
        out.append(48 + torch.remainder(_fdiv(frac, p), 10))
    return out, torch.full_like(y, width)


def render_plain(words: torch.Tensor, pspecs: tuple,
                 plan: EgressPlan) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the render kernel: packed words
    uint32 (or int32 bit patterns) [n_words, R] of the layout of `pspecs`
    → (ebytes uint8[R, plan.total_width], elens int32[R, len(plan.slots)]),
    the reference's `build_egress_program` byte for byte on every row."""
    layout = layout_for_specs(pspecs)
    w64 = words.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    R = w64.shape[1]
    bufs, lens = [], []
    for slot, kind, width in zip(plan.slots, plan.kinds, plan.widths):
        fields = {s.comp: s for s in layout.slots[slot]}
        if kind is CellKind.BOOL:
            bs, L = _render_bool(_field_value(w64, fields, "v"), width)
        elif kind in _INT_KINDS:
            s = fields["v"]
            raw = _extract(w64, s)
            if s.zigzag:
                mag, neg = (raw >> 1) + (raw & 1), raw & 1
            else:
                mag, neg = raw, torch.zeros_like(raw)
            bs, L = _render_u32_family(mag, neg, width, _MAX_DIGITS[kind])
        elif kind is CellKind.I64:
            raws = [_extract(w64, fields[c]) if c in fields
                    else torch.zeros(R, dtype=torch.int64,
                                     device=w64.device)
                    for c in ("neg", "l0", "l1", "l2")]
            bs, L = _render_i64(*raws, width)
        elif kind is CellKind.DATE:
            y, m, d = _civil(_field_value(w64, fields, "days"))
            bs, L = _date_bytes(y, m, d), torch.full_like(y, width)
        elif kind in (CellKind.TIMESTAMP, CellKind.TIMESTAMPTZ):
            bs, L = _render_timestamp(
                *(_field_value(w64, fields, c) for c in ("days", "ms", "us")),
                width)
        else:  # pragma: no cover — plan_for_specs filters kinds
            raise AssertionError(kind)
        bufs.append(torch.stack(bs, dim=1))
        lens.append(L)
    if not bufs:
        return (torch.zeros((R, 0), dtype=torch.uint8, device=words.device),
                torch.zeros((R, 0), dtype=torch.int32, device=words.device))
    return (torch.cat(bufs, dim=1).to(torch.uint8),
            torch.stack(lens, dim=1).to(torch.int32))


def render(words: torch.Tensor, pspecs: tuple,
           plan: EgressPlan) -> tuple[torch.Tensor, torch.Tensor]:
    """Render the words of one decode: `egress_kernel.render`, the kernel
    for a CUDA tensor (on the current stream, not synchronised), the
    plain version for a CPU tensor, an error for any other."""
    from . import egress_kernel

    return egress_kernel.render(words, pspecs, plan)


# ---------------------------------------------------------------------------
# fetched-egress transport
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DeviceEgress:
    """Wire-ready text buffers riding a decoded batch
    (`ColumnarBatch.device_egress`). `fields` maps SCHEMA column index →
    (bytes uint8[n, W] left-aligned, lens int32[n]); `untrusted` lists
    row indices whose device bytes must not be used (fallback rows,
    oracle fixups) — destinations render those rows per-value and splice
    whole lines."""

    encoder: str
    n_rows: int
    fields: dict
    untrusted: np.ndarray

    def field(self, col_index: int):
        return self.fields.get(col_index)

    @classmethod
    def concat(cls, parts: list) -> "DeviceEgress | None":
        """Merge per-event-batch egress into one buffer set for a
        coalesced run. All-or-nothing: one part without device buffers
        (or a field-set/encoder mismatch) drops the merged fast path —
        correctness never depends on egress being present."""
        if not parts or any(p is None for p in parts):
            return None
        enc = parts[0].encoder
        keys = set(parts[0].fields)
        if any(p.encoder != enc or set(p.fields) != keys for p in parts):
            return None
        fields: dict = {}
        for k in keys:
            fields[k] = (
                np.concatenate([p.fields[k][0] for p in parts], axis=0),
                np.concatenate([p.fields[k][1] for p in parts]))
        untr, off = [], 0
        for p in parts:
            if p.untrusted.size:
                untr.append(p.untrusted + off)
            off += p.n_rows
        return cls(enc, off, fields,
                   np.concatenate(untr) if untr
                   else np.zeros(0, dtype=np.int64))


def materialize(egress_out: tuple, plan, dense, n: int,
                untrusted) -> "DeviceEgress | None":
    """Index a render's fetched outputs (host tensors or arrays) by schema
    column. `plan` is the batch's canonical pack plan (None = identity,
    the port's only plan: it packs exact specs): real column j rendered
    from canonical slot plan.slot_of[j], the mirror of `_assemble`'s
    unpack mapping. The first `n` rows are copied out, so the fetch's
    pinned buffers can go back to their pool."""
    ebytes_d, elens_d, eplan = egress_out
    ebytes = np.asarray(ebytes_d[:n]).copy()
    elens = np.asarray(elens_d[:n]).copy()
    pos_of = {s: i for i, s in enumerate(eplan.slots)}
    offs = eplan.offsets
    fields: dict = {}
    for j, spec in enumerate(dense):
        slot = plan.slot_of[j] if plan is not None else j
        i = pos_of.get(slot)
        if i is None or eplan.kinds[i] is not spec.kind:
            continue
        o, w = offs[i], eplan.widths[i]
        fields[spec.index] = (ebytes[:n, o:o + w], elens[:n, i])
    if not fields:
        return None
    untr = np.asarray(untrusted, dtype=np.int64) \
        if untrusted is not None else np.zeros(0, dtype=np.int64)
    return DeviceEgress(eplan.encoder, n, fields, untr)


# ---------------------------------------------------------------------------
# host twins + vectorized line assembly
# ---------------------------------------------------------------------------
#
# piece = ("const", bytes-as-uint8[k])                same bytes every row
#       | ("fixed", buf uint8[n, W], lens int32[n])   left-aligned
#       | ("var",   values uint8[total], offsets int64[n+1])
#
# A destination builds one piece per wire token (field text, separator,
# JSON key, metadata column) and `assemble_rows` scatters them into one
# contiguous buffer with two cumsums and one fancy-index store per piece
# — no per-row Python.

def const_piece(b: bytes) -> tuple:
    return ("const", np.frombuffer(b, dtype=np.uint8))


def fixed_piece(buf: np.ndarray, lens: np.ndarray) -> tuple:
    return ("fixed", buf, lens)


def var_from_texts(items: list) -> tuple:
    """Variable piece from per-row bytes (the host per-value path)."""
    n = len(items)
    lens = np.fromiter((len(b) for b in items), dtype=np.int64, count=n)
    offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=offs[1:])
    total = int(offs[-1])
    values = np.frombuffer(b"".join(items), dtype=np.uint8) if total \
        else np.zeros(0, dtype=np.uint8)
    return ("var", values, offs)


def patch_rows_fixed(buf: np.ndarray, lens: np.ndarray, rows: np.ndarray,
                     text: bytes) -> tuple:
    """Overwrite `rows` of a fixed piece with a short constant (NULL
    markers). Copies first: device-fetched buffers are read-only and
    lens views may be shared across columns."""
    if rows.size == 0:
        return buf, lens
    nb = np.frombuffer(text, dtype=np.uint8)
    buf = np.array(buf, copy=True)
    lens = np.array(lens, dtype=np.int64, copy=True)
    buf[rows, :nb.size] = nb
    lens[rows] = nb.size
    return buf, lens


def int_text_fixed(arr: np.ndarray) -> tuple:
    """Host twin of the device int renderers: same digits as str(int)."""
    a = np.asarray(arr)
    n = a.shape[0]
    if n == 0:
        return np.zeros((0, 21), dtype=np.uint8), np.zeros(0, np.int64)
    codes = np.ascontiguousarray(a.astype("U21")).view(np.uint32) \
        .reshape(n, 21)
    return codes.astype(np.uint8), \
        np.count_nonzero(codes, axis=1).astype(np.int64)


def bool_text_fixed(flags: np.ndarray) -> tuple:
    t = np.frombuffer(b"true\x00", dtype=np.uint8)
    f = np.frombuffer(b"false", dtype=np.uint8)
    m = np.asarray(flags).astype(bool)
    return np.where(m[:, None], t, f), np.where(m, 4, 5).astype(np.int64)


def date_text_fixed(days: np.ndarray) -> tuple:
    """Host twin of the device DATE renderer (in-range rows only —
    callers mask specials/out-of-range rows to the per-value oracle,
    same as the columnar encoders do)."""
    n = np.asarray(days).shape[0]
    if n == 0:
        return np.zeros((0, 10), dtype=np.uint8), np.zeros(0, np.int64)
    s = np.datetime_as_string(np.asarray(days).astype("M8[D]"), unit="D")
    codes = np.ascontiguousarray(s.astype("U10")).view(np.uint32) \
        .reshape(n, 10)
    return codes.astype(np.uint8), np.full(n, 10, dtype=np.int64)


def timestamp_text_fixed(micros: np.ndarray) -> tuple:
    """Host twin of the device TIMESTAMP renderer: always 6 fractional
    digits, 'T' replaced by a space — np.datetime_as_string(unit='us')
    exactly as the ClickHouse columnar encoder renders it."""
    n = np.asarray(micros).shape[0]
    if n == 0:
        return np.zeros((0, 26), dtype=np.uint8), np.zeros(0, np.int64)
    s = np.char.replace(
        np.datetime_as_string(np.asarray(micros, dtype=np.int64)
                              .astype("M8[us]"), unit="us"), "T", " ")
    codes = np.ascontiguousarray(s.astype("U26")).view(np.uint32) \
        .reshape(n, 26)
    return codes.astype(np.uint8), np.full(n, 26, dtype=np.int64)


def assemble_rows(n: int, pieces: list,
                  override: "dict | None" = None) -> tuple:
    """Scatter `pieces` into one contiguous byte buffer, one row per
    line. `override` maps row index → full replacement bytes for that
    row (the oracle-rendered untrusted/special rows) — overridden rows
    take NO bytes from any piece. Returns (out uint8[total],
    row_offsets int64[n+1])."""
    m = len(pieces)
    L = np.zeros((n, m), dtype=np.int64)
    for j, p in enumerate(pieces):
        if p[0] == "const":
            L[:, j] = p[1].size
        elif p[0] == "fixed":
            L[:, j] = p[2]
        else:
            L[:, j] = p[2][1:] - p[2][:-1]
    if override:
        rows = np.fromiter(override.keys(), dtype=np.int64,
                           count=len(override))
        L[rows, :] = 0
    row_len = L.sum(axis=1)
    if override:
        for r, b in override.items():
            row_len[r] = len(b)
    starts = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(row_len, out=starts[1:])
    out = np.empty(int(starts[-1]), dtype=np.uint8)
    within = np.zeros(n, dtype=np.int64)
    for j, p in enumerate(pieces):
        lj = L[:, j]
        dst0 = starts[:-1] + within
        if p[0] == "const":
            c = p[1]
            if c.size:
                live = np.flatnonzero(lj) if override else None
                d = dst0[live] if live is not None else dst0
                idx = d[:, None] + np.arange(c.size, dtype=np.int64)
                out[idx.reshape(-1)] = np.tile(c, d.size)
        else:
            tot = int(lj.sum())
            if tot:
                cum_excl = np.cumsum(lj) - lj
                pos = np.arange(tot, dtype=np.int64) \
                    - np.repeat(cum_excl, lj)
                dst = np.repeat(dst0, lj) + pos
                if p[0] == "fixed":
                    buf = p[1]
                    w = buf.shape[1]
                    src = np.repeat(np.arange(n, dtype=np.int64) * w,
                                    lj) + pos
                    out[dst] = buf.reshape(-1)[src]
                else:
                    src = np.repeat(p[2][:-1], lj) + pos
                    out[dst] = p[1][src]
        within += lj
    if override:
        for r, b in override.items():
            if b:
                out[starts[r]:starts[r] + len(b)] = \
                    np.frombuffer(b, dtype=np.uint8)
    return out, starts
