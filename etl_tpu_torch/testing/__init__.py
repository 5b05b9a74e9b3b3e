"""Seeded field inputs for parity checks of the decode kernels.

`field_matrix(specs, n_rows, rng, nibble)` builds the packed byte matrix
and lengths the engine would hand the kernel, filled with Postgres text of
each column's kind and with adversarial rows: out-of-range and malformed
text, lengths past the field width, junk bytes past the length and, for
nibble packing, random symbol codes. The CPU tests feed the same arrays to
the reference and to the port; `chip_smoke.py` and the GPU tests feed them
to the kernel and to its plain version. `filter_case` adds what the
fused row filter (K2) needs: NULL fields, edge values of every comparable
kind and a row-flags vector with dead and force-kept rows.
`egress_words` gives the render kernel its input: the decoded words of
such rows, with edge values and rows of random bits.
"""

from __future__ import annotations

import numpy as np

from ..models.pgtypes import CellKind

# framer.c's nibble alphabet: byte → symbol code, 15 = padding
_NIBBLE_CODE = np.full(256, 15, dtype=np.uint8)
_NIBBLE_CODE[[ord(c) for c in "0123456789-+.: "]] = np.arange(15)
_JUNK = b"0123456789-+.:eE tfNaIny\x00\xff"


def _int_text(rng, lo: int, hi: int) -> str:
    pick = rng.integers(8)
    if pick == 0:
        return str(rng.choice([lo, hi, lo - 1, hi + 1, 0]))
    if pick == 1:
        return rng.choice(["-0", "+5", "007", "-", "+", "", "12a",
                           "9" * 19, "1" * 27, "1" * 28, "-" + "9" * 20])
    bits = int(rng.integers(1, 64))
    v = int(rng.integers(-(2 ** bits), 2 ** bits, dtype=np.int64)) \
        if bits < 63 else int(rng.integers(-2**62, 2**62))
    return str(v)


def _time_text(rng) -> str:
    hh, mm, ss = rng.integers(0, 26), rng.integers(0, 62), rng.integers(0, 62)
    t = f"{hh:02d}:{mm:02d}:{ss:02d}"
    nf = int(rng.integers(0, 9))
    if nf == 7:
        return t + "."
    if nf:
        t += "." + "".join(str(d) for d in rng.integers(0, 10, nf))
    return t


def _date_text(rng) -> str:
    y, m, d = rng.integers(0, 10000), rng.integers(0, 14), rng.integers(0, 33)
    s = f"{y:04d}-{m:02d}-{d:02d}"
    return s + " BC" if rng.integers(20) == 0 else s


def _tz_text(rng) -> str:
    sign = "+-"[int(rng.integers(2))]
    hh = rng.integers(0, 18)
    return rng.choice([f"{sign}{hh:02d}", f"{sign}{hh:02d}:30",
                       f"{sign}{hh:02d}:30:15", f"{sign}{hh}", "",
                       f"{sign}{hh:02d}:3x", "Z"])


def _float_text(rng) -> str:
    pick = rng.integers(6)
    if pick == 0:
        return rng.choice(["NaN", "Infinity", "-Infinity", "nan", "1e", "1e+",
                           "..1", "1.2.3", "+.5", "-", "", ".", "e5",
                           "123456789012345678901", "0.000000000000000012345",
                           "999999999999999000000000", "1e-22", "-1.5e22",
                           "1e23", "0.0001", "3e4", "-2.5E-3", "5e-324"])
    if pick == 1:
        return repr(float(rng.uniform(-1, 1)))
    if pick == 2:
        return f"{rng.uniform(-1e6, 1e6):.{int(rng.integers(0, 9))}f}"
    if pick == 3:
        return f"{rng.uniform(-10, 10):.3f}e{int(rng.integers(-30, 30))}"
    return str(int(rng.integers(-10**12, 10**12)))


def _text(kind: CellKind, rng) -> str:
    if kind is CellKind.BOOL:
        return rng.choice(["t", "f", "t", "f", "true", "x", ""])
    if kind is CellKind.I16:
        return _int_text(rng, -32768, 32767)
    if kind is CellKind.I32:
        return _int_text(rng, -2**31, 2**31 - 1)
    if kind is CellKind.U32:
        return _int_text(rng, 0, 2**32 - 1)
    if kind is CellKind.I64:
        return _int_text(rng, -2**63, 2**63 - 1)
    if kind in (CellKind.F32, CellKind.F64):
        return _float_text(rng)
    if kind is CellKind.DATE:
        return _date_text(rng)
    if kind is CellKind.TIME:
        return _time_text(rng)
    ts = _date_text(rng) + " " + _time_text(rng)
    return ts + _tz_text(rng) if kind is CellKind.TIMESTAMPTZ else ts


def _column(kind: CellKind, width: int, n: int, rng, nibble: bool,
            lengths_u8: bool) -> tuple[np.ndarray, np.ndarray]:
    """One column: bytes u8[n, W] (u8[n, W/2] nibble) and lengths."""
    raw = np.zeros((n, width), dtype=np.uint8)
    lens = np.zeros(n, dtype=np.int64)
    for i in range(n):
        mode = rng.integers(16)
        if mode == 0:  # junk of any length, sometimes past the width
            t = bytes(rng.choice(list(_JUNK), int(rng.integers(0, width + 4))))
        else:
            t = _text(kind, rng).encode()
        lens[i] = len(t)
        t = t[:width]
        raw[i, :len(t)] = np.frombuffer(t, dtype=np.uint8)
        if mode == 1:  # junk past the length
            raw[i, len(t):] = rng.choice(list(_JUNK), width - len(t))
    if lengths_u8:
        lens = np.minimum(lens, 255)
    if not nibble:
        return raw, lens
    codes = _NIBBLE_CODE[raw]
    codes[np.arange(width)[None, :] >= lens[:, None]] = 15
    junk = rng.integers(16, size=n) == 0  # random symbol codes
    codes[junk] = rng.integers(0, 16, size=(int(junk.sum()), width))
    half = width // 2
    return (codes[:, :half] << 4) | codes[:, half:], lens


def field_matrix(specs: tuple, n_rows: int, rng: np.random.Generator,
                 nibble: bool = False,
                 lengths_dtype=np.uint8) -> tuple[np.ndarray, np.ndarray]:
    """(bmat, lengths) for `specs` ((col, kind, width, bit_width) tuples)
    in the engine's layout: bmat u8[R, ΣW] (u8[R, ΣW/2] when `nibble`),
    lengths `lengths_dtype`[R, n]."""
    u8 = np.dtype(lengths_dtype) == np.uint8
    parts, lens = [], []
    for _, kind, width, _ in specs:
        b, ln = _column(kind, width, n_rows, rng, nibble, u8)
        parts.append(b)
        lens.append(ln)
    return (np.ascontiguousarray(np.concatenate(parts, axis=1)),
            np.ascontiguousarray(np.stack(lens, axis=1).astype(lengths_dtype)))


def text_matrix(specs: tuple, columns: list, nibble: bool = False,
                lengths_dtype=np.uint8) -> tuple[np.ndarray, np.ndarray]:
    """(bmat, lengths) for given texts: `columns[j]` lists column j's
    texts (str or bytes), one per row, cut to the width with the full
    length kept (saturated at 255 for uint8 lengths)."""
    u8 = np.dtype(lengths_dtype) == np.uint8
    parts, lens = [], []
    for (_, _, width, _), texts in zip(specs, columns):
        raw = np.zeros((len(texts), width), dtype=np.uint8)
        ln = np.zeros(len(texts), dtype=np.int64)
        for i, t in enumerate(texts):
            b = t.encode() if isinstance(t, str) else bytes(t)
            ln[i] = min(len(b), 255) if u8 else len(b)
            raw[i, :min(len(b), width)] = np.frombuffer(b[:width], np.uint8)
        if nibble:
            codes = _NIBBLE_CODE[raw]
            codes[np.arange(width)[None, :] >= ln[:, None]] = 15
            raw = (codes[:, :width // 2] << 4) | codes[:, width // 2:]
        parts.append(raw)
        lens.append(ln)
    return (np.ascontiguousarray(np.concatenate(parts, axis=1)),
            np.ascontiguousarray(np.stack(lens, axis=1).astype(lengths_dtype)))


# values at the edges of the filter's comparisons, by kind: U32 above
# 2^31, I64 "-0" and limb boundaries, TIMESTAMPTZ values whose offset
# fold borrows from or carries into the next day
EDGE_TEXTS = {
    CellKind.BOOL: ["t", "f"],
    CellKind.I16: ["-32768", "32767", "0", "-0", "100", "99", "101"],
    CellKind.I32: ["-2147483648", "2147483647", "0", "-0", "-5000000",
                   "-5000001", "100", "99"],
    CellKind.U32: ["2147483647", "2147483648", "3000000000", "3000000001",
                   "4294967295", "0"],
    CellKind.I64: ["-0", "0", "-1", "1", "-1000000000", "999999999",
                   "1000000000000000000", "-999999999999999999",
                   "-9223372036854775808", "9223372036854775807"],
    CellKind.DATE: ["2000-01-01", "1999-12-31", "2024-06-15", "0001-01-01",
                    "9999-12-31"],
    CellKind.TIME: ["12:00:00", "11:59:59.999999", "12:00:00.000001",
                    "00:00:00", "23:59:59.999999"],
    CellKind.TIMESTAMP: ["2000-01-01 00:00:00", "1999-12-31 23:59:59.999999",
                         "2000-01-01 00:00:00.000001",
                         "2024-06-15 00:00:00"],
    CellKind.TIMESTAMPTZ: ["2024-06-15 00:00:00+00",
                           "2024-06-14 23:59:59.999999+00",
                           "2024-06-15 01:00:00+01", "2024-06-14 19:00:00-05",
                           "2024-06-15 00:30:00+09:30",
                           "2024-06-14 23:30:00-00:30",
                           "2024-06-15 15:59:59+15:59:59",
                           "2024-06-14 08:00:00.5-15:59:59"],
}


def filter_case(specs: tuple, n_rows: int, rng: np.random.Generator,
                nibble: bool = False, null_share: float = 0.08
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(bmat, lengths, row_flags) for the fused filter: `field_matrix`
    rows with a share of every column's fields NULL (zero length), every
    tenth row an edge value of its column's kind (EDGE_TEXTS), and
    row_flags u8[R] mostly 1 (live) with some 0 (dead) and 2 (live +
    force-keep)."""
    bm, ln = field_matrix(specs, n_rows, rng, nibble)
    edge_rows = np.arange(0, n_rows, 10)
    cols = [[str(rng.choice(EDGE_TEXTS.get(kind, ["0"])))
             for _ in edge_rows] for _, kind, _, _ in specs]
    ebm, eln = text_matrix(specs, cols, nibble)
    bm[edge_rows], ln[edge_rows] = ebm, eln
    ln[rng.random(ln.shape) < null_share] = 0
    flags = rng.choice(np.array([0, 1, 2], dtype=np.uint8), size=n_rows,
                       p=[0.05, 0.85, 0.10])
    return bm, ln, flags


# values at the edges of the egress render, by kind: integer extremes
# and digit-count boundaries, dates at year ends and leap days,
# TIMESTAMPTZ values whose zone shift crosses midnight and year ends
EGRESS_EDGE_TEXTS = {
    CellKind.BOOL: ["t", "f"],
    CellKind.I16: ["-32768", "32767", "0", "-0", "-1", "9", "10", "-10000"],
    CellKind.I32: ["-2147483648", "2147483647", "0", "-1", "999999999",
                   "1000000000", "-1000000000"],
    CellKind.U32: ["4294967295", "0", "999999999", "1000000000",
                   "2147483648"],
    CellKind.I64: ["-9223372036854775808", "9223372036854775807", "0", "-0",
                   "999999999", "1000000000", "-999999999999999999",
                   "1000000000000000000"],
    CellKind.DATE: ["0001-01-01", "9999-12-31", "1999-12-31", "2000-01-01",
                    "1970-01-01", "1969-12-31", "2000-02-29", "1900-03-01"],
    CellKind.TIMESTAMP: ["1999-12-31 23:59:59.999999", "2000-01-01 00:00:00",
                         "0001-01-01 00:00:00", "9999-12-31 23:59:59.999999",
                         "1970-01-01 00:00:00.000001", "2024-02-29 12:00:00"],
    CellKind.TIMESTAMPTZ: ["1999-12-31 23:30:00-05",
                           "2000-01-01 00:30:00+09:30",
                           "2024-12-31 20:00:00-15:59:59",
                           "2025-01-01 01:00:00+15:59:59",
                           "0001-01-01 00:00:00+01",
                           "9999-12-31 23:59:59.999999-14",
                           "1970-01-01 00:00:00+00", "2024-03-01 00:00:00+01"],
}


def egress_words(specs: tuple, n_rows: int, rng: np.random.Generator,
                 nibble: bool = False, junk_share: float = 0.05):
    """Packed decode words uint32[n_words, R] for the egress render: the
    plain decode (`bitpack.parse_and_pack_plain`) of `field_matrix` rows,
    every tenth row an edge value of its column's kind (EGRESS_EDGE_TEXTS),
    then a share of rows overwritten with random bits, so every field holds
    values no parse gives (and rows that failed to parse keep theirs)."""
    import torch

    from ..ops.bitpack import parse_and_pack_plain

    bm, ln = field_matrix(specs, n_rows, rng, nibble)
    edge_rows = np.arange(0, n_rows, 10)
    cols = [[str(rng.choice(EGRESS_EDGE_TEXTS.get(kind, ["0"])))
             for _ in edge_rows] for _, kind, _, _ in specs]
    ebm, eln = text_matrix(specs, cols, nibble)
    bm[edge_rows], ln[edge_rows] = ebm, eln
    words = parse_and_pack_plain(torch.from_numpy(bm), torch.from_numpy(ln),
                                 specs, nibble).view(torch.int32).clone()
    junk = np.flatnonzero(rng.random(n_rows) < junk_share)
    words[:, junk] = torch.from_numpy(rng.integers(
        -2**31, 2**31, size=(words.shape[0], len(junk)), dtype=np.int64)
        .astype(np.int32))
    return words.view(torch.uint32)
