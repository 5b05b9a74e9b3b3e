"""The benchmark's fixed yardstick: the card's published peak and the
bytes each kernel launch must move.

Frozen copies, so that a later change to the program cannot move the
scale it is measured on:

- `HBM_BYTES_PER_S`: the NVIDIA H100 SXM data sheet's 3.35 TB/s of HBM3
  (copied from `chip_smoke.py`'s `HBM_BYTES_PER_S`).
- `k1_bytes`: K1 (`decode_pack_kernel`) reads its byte matrix and lengths
  once and writes its packed words once (copied from `chip_smoke.py`'s
  phase 3 bound, `n_bytes = bm.nbytes + ln.nbytes + n_words * 4 * rows`).
- `fused_bytes`: K2c (`filter_pack_compact{,2}_kernel`) reads its inputs
  once and writes the survivors' words, the keep mask, the count and a
  status word a block plus the ticket counter (copied from
  `chip_smoke.py`'s `fused_bytes`).

The operation count `chip_smoke.py` sets beside these (4 operations a
text byte against the float32 peak) is an assumption, not a count, and is
not copied: the shares here are of the byte bound alone.
"""

HBM_BYTES_PER_S = 3.35e12
FILTER_BLOCK = 256  # rows a K2c block (FILTER_BLOCK in csrc/decode_pack.cu)


def k1_bytes(bmat_bytes: int, lengths_bytes: int, n_words: int,
             rows: int) -> int:
    return bmat_bytes + lengths_bytes + n_words * 4 * rows


def fused_bytes(bmat_bytes: int, lengths_bytes: int, flags_bytes: int,
                n_words: int, rows: int, survivors: int) -> int:
    n_blocks = -(-rows // FILTER_BLOCK)
    return bmat_bytes + lengths_bytes + flags_bytes + n_words * 4 * survivors \
        + 4 * -(-rows // 32) + 4 + 8 * (n_blocks + 1)


def roofline_pct(n_bytes: int, seconds: float) -> "float | None":
    """The share of the byte bound a kernel reached: the least time the
    bytes need at the peak over the time the kernel took, in percent;
    None where nothing was timed."""
    if seconds <= 0 or n_bytes <= 0:
        return None
    return 100.0 * n_bytes / HBM_BYTES_PER_S / seconds
