"""Native host components: the pgoutput framer and byte packers (C, ctypes).

Copy of the reference's `etl_tpu/native`: `framer.c` is the same source,
built with the system C compiler ($CC, else `cc`) at first use through
the program store (`ops/program_store.py`: the library `LIBRARY`, in the
configured cache directory or `etl_tpu_torch/_build/`, ignored by git).
Unlike the reference there is no pure-Python walker: a missing compiler
raises. `frame_pgoutput` is the entry point; see ops/wal.py for the
staging layer that consumes it.
"""

from __future__ import annotations

import ctypes
import os
import threading
from pathlib import Path

import numpy as np

from ..ops.program_store import Acquired, Library, acquire

_DIR = Path(__file__).resolve().parent

FLAG_VALUE, FLAG_NULL, FLAG_TOAST, FLAG_BINARY = 0, 1, 2, 3

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a built framer library."""
    lib.etl_frame_pgoutput.restype = ctypes.c_int64
    lib.etl_frame_pgoutput.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,  # buf, buf_len
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,  # msg_off/len/n
        ctypes.c_int32,  # n_cols
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # kind/relid/oldkind
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # new off/len/flag
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # old off/len/flag
    ]
    lib.etl_pack_bmat.restype = None
    lib.etl_pack_bmat.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,  # data, data_len
        ctypes.c_void_p, ctypes.c_void_p,  # offsets, lengths [R,C]
        ctypes.c_int64, ctypes.c_int32,  # n_rows, n_cols
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,  # cols,widths,n
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p,  # bmat,tw,lens
    ]
    lib.etl_pack_bmat_nibble.restype = None
    lib.etl_pack_bmat_nibble.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p,
        ctypes.c_void_p,  # bad_rows
    ]
    lib.etl_gather_string.restype = ctypes.c_int64
    lib.etl_gather_string.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # off,len,valid
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,  # R, C, col
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,  # aoff,vals,cap
    ]
    return lib


LIBRARY = Library("framer", _DIR / "framer.c",
                  lambda: os.environ.get("CC", "cc"),
                  ("-O3", "-shared", "-fPIC"), _bind, timeout_s=120)


#: the sanitizer run's hook (`testing/sanitize_framer.py`): the path of
#: a prebuilt instrumented framer library, loaded in place of the store's
#: -O3 build
FRAMER_SO_ENV = "ETL_NATIVE_FRAMER_SO"


def load_library() -> Acquired:
    """Acquire the framer library through the program store (or load the
    library $ETL_NATIVE_FRAMER_SO names, source "override") and make it
    this module's."""
    global _lib
    with _lock:
        override = os.environ.get(FRAMER_SO_ENV)
        got = Acquired(_bind(ctypes.CDLL(override)), "override") \
            if override else acquire(LIBRARY)
        _lib = got.lib
        return got


def _load() -> ctypes.CDLL:
    lib = _lib
    return lib if lib is not None else load_library().lib


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


class FramedBatch:
    """Output of the framer over n messages (see framer.c doc comment)."""

    __slots__ = ("buf", "kind", "relid", "old_kind", "new_off", "new_len",
                 "new_flag", "old_off", "old_len", "old_flag", "n_msgs")

    def __init__(self, buf: np.ndarray, n_msgs: int, n_cols: int):
        self.buf = buf
        self.n_msgs = n_msgs
        self.kind = np.zeros(n_msgs, dtype=np.uint8)
        self.relid = np.zeros(n_msgs, dtype=np.int32)
        self.old_kind = np.zeros(n_msgs, dtype=np.uint8)
        shape = (n_msgs, n_cols)
        self.new_off = np.zeros(shape, dtype=np.int32)
        self.new_len = np.zeros(shape, dtype=np.int32)
        self.new_flag = np.full(shape, FLAG_NULL, dtype=np.uint8)
        self.old_off = np.zeros(shape, dtype=np.int32)
        self.old_len = np.zeros(shape, dtype=np.int32)
        self.old_flag = np.full(shape, FLAG_NULL, dtype=np.uint8)


def frame_pgoutput(buf: bytes | np.ndarray, msg_off: np.ndarray,
                   msg_len: np.ndarray, n_cols: int) -> tuple[FramedBatch, int]:
    """Frame `len(msg_off)` pgoutput messages inside `buf`.

    Returns (framed, first_bad_index) — first_bad_index is -1 when every
    message framed cleanly; otherwise framing stopped there and the caller
    falls back to the CPU decoder for the remainder.
    """
    data = np.frombuffer(buf, dtype=np.uint8) if isinstance(buf, (bytes, bytearray)) \
        else np.ascontiguousarray(buf, dtype=np.uint8)
    msg_off = np.ascontiguousarray(msg_off, dtype=np.int64)
    msg_len = np.ascontiguousarray(msg_len, dtype=np.int32)
    n = len(msg_off)
    out = FramedBatch(data, n, n_cols)
    p = _ptr
    bad = _load().etl_frame_pgoutput(
        p(data), len(data), p(msg_off), p(msg_len), n, n_cols,
        p(out.kind), p(out.relid), p(out.old_kind),
        p(out.new_off), p(out.new_len), p(out.new_flag),
        p(out.old_off), p(out.old_len), p(out.old_flag))
    return out, int(bad)


def pack_bmat(data, offsets, lengths, col_idx, widths, bmat,
              lens_out) -> bool:
    """C pack of the device byte matrix; False past the C packer's 256
    columns (the caller packs with numpy then)."""
    if len(col_idx) > 256:
        return False
    p = _ptr
    R, C = offsets.shape
    cols = np.ascontiguousarray(col_idx, dtype=np.int32)
    ws = np.ascontiguousarray(widths, dtype=np.int32)
    _load().etl_pack_bmat(p(data), len(data), p(offsets), p(lengths), R, C,
                          p(cols), p(ws), len(cols), p(bmat), bmat.shape[1],
                          p(lens_out))
    return True


def gather_string(data, offsets, lengths, valid, col,
                  arrow_offsets, values) -> int:
    """C gather of one string column into Arrow layout; returns the bytes
    written, or -1 when they would exceed `values`."""
    p = _ptr
    R, C = offsets.shape
    return _load().etl_gather_string(
        p(data), len(data), p(offsets), p(lengths), p(valid), R, C, col,
        p(arrow_offsets), p(values), len(values))


def pack_bmat_nibble(data, offsets, lengths, col_idx, widths, bmat,
                     lens_out, bad_rows) -> bool:
    """C nibble pack (two symbols a byte); False past 256 columns."""
    if len(col_idx) > 256:
        return False
    p = _ptr
    R, C = offsets.shape
    cols = np.ascontiguousarray(col_idx, dtype=np.int32)
    ws = np.ascontiguousarray(widths, dtype=np.int32)
    _load().etl_pack_bmat_nibble(
        p(data), len(data), p(offsets), p(lengths), R, C, p(cols), p(ws),
        len(cols), p(bmat), bmat.shape[1], p(lens_out), p(bad_rows))
    return True
