// Parse-and-pack decode kernels for Hopper (sm_90a).
//
// decode_pack_kernel replaces the reference's Pallas kernel body `kernel`
// (etl_tpu/ops/pallas_kernel.py:114, K1) and its XLA twin
// `bitpack.parse_and_pack` (etl_tpu/ops/bitpack.py:271): for every dense
// column of a batch, parse the field text into int32 components plus an
// ok bit (semantics of etl_tpu/ops/parsers.py parse_column) and bit-pack
// them at the BitLayout offsets, zigzag on signed components
// (bitpack.pack_device). The words must equal the reference's bit for
// bit, including the values of rows that fail to parse.
//
// filter_pack_kernel replaces `kernel_filtered`
// (etl_tpu/ops/pallas_kernel.py:118, K2): the same parse and pack, plus
// the publication row filter, given as the flat postfix program of
// ops/predicate.py (PRED_* below) and evaluated in SQL's three-valued
// logic on two 32-bit registers used as stacks of (is_true, is_false)
// bits. keep = live & (true | force-keep | a referenced field that failed
// to parse). A kept row packs its words as K1 does; a dropped row's words
// are zeros. compact_kernel replaces the XLA epilogue
// `bitpack.compact_packed` (etl_tpu/ops/bitpack.py:212).
//
// filter_pack_compact_kernel (K2c; filter_pack_compact2_kernel with two
// rows a thread) replaces both in one launch: K2's walk, with a block's
// words kept in shared memory and only its kept rows written, straight
// to their place in the compacted output, after a single-pass decoupled
// look-back (Merrill & Garland) over the blocks' survivor counts. Its
// output equals the reference's in columns [0, count) of the words, the
// keep mask and the count; later columns are not written.
//
// Bound: bytes. Per row K1 reads its field bytes and lengths once and
// writes n_words * 4 bytes: on the pgbench main path 12 nibble bytes,
// 3 lengths and 8 bytes of words, 23 B a row, 6.0 MB for 262,144 rows,
// 1.8 us at 3.35 TB/s; K2 adds a flag byte (24 B a row, 1.9 us); K2c
// writes the survivors' words only (22.5 B a row at the main path's
// 208,176 of 262,144 survivors, 1.8 us). The
// parse is a few hundred integer instructions a row, about 3-4 us of
// issue over 132 SMs: close to the byte bound, so neither may waste the
// other. On the card the time goes to the length of each thread's chain
// of dependent loads and parse steps more than to either bound (PERF.md).
//
// Design.
// - A block owns FILTER_BLOCK = 256 consecutive rows: one contiguous
//   range of the row-major [R, row_bytes] byte matrix, of the [R, n_cols]
//   lengths and of the flags. Its threads stage them into shared memory
//   with 16-byte cp.async copies, all in flight at once (the ragged end
//   of the batch bytewise), and then each thread parses its rows from
//   the tile. Rows whose byte length is a multiple of 8 (an even number
//   of 32-bit words) are stored one word apart in the tile, so that the
//   32 rows a warp reads at once fall on 32 different banks.
// - Where 256 rows do not fit the shared-memory budget (the wrapper's
//   choice, by shape), the block walks its 256 rows in sub-tiles of 128,
//   64 or 32 rows (one warp). Where one warp's tile does not fit either,
//   or a base pointer is not 16-byte aligned, the block reads straight
//   from global memory through the same row body ("direct").
// - The column descriptor (DESC_* below) and the predicate program are
//   staged into shared memory once per block, with the first tile; the
//   column loop is warp-uniform and reads a column's head and each slot
//   as one 16-byte load.
// - The parse keeps everything in registers: components, limbs and
//   digits are scalars or arrays indexed only by unrolled constants, so
//   no per-thread array is indexed at run time. An integer field of at
//   most 16 nibble symbols, the main path's, is parsed without a loop or
//   a branch: its bytes are read as aligned 32-bit words, split into
//   4-bit codes with shifts, and the digit check and decimal value are
//   computed on all symbols at once (parse_int_nibble). Other fields read
//   their symbols one byte load each from the tile, a nibble's code
//   mapped to ASCII by arithmetic.
// - K1 gives each thread two rows where every column takes that
//   loop-free parse (the wrapper's choice): the two rows' chains are
//   independent and interleave. Every other layout, and K2, one row.
// - K2 parses every dense column once, in spec order. As a referenced
//   column is parsed, each of its comparison leaves is judged on the
//   components just parsed and its (true, false) bits are set at the
//   leaf's instruction number in two 64-bit sets; the column's "present
//   but failed" bit is folded into the unevaluable check. Right after the
//   last referenced column the postfix program runs on those bits (a leaf
//   past LEAF_BITS parses its column again from the tile), and a dropped
//   row stops parsing and writes zeros. Blocks are whole 32-row warps, so
//   each warp's __ballot_sync of keep IS one keep-mask word in the
//   reference's little bit order, and __syncthreads_count sums the
//   block's survivors.
// - The output stays the reference's word-major uint32 [n_words, R]:
//   thread r writes column r of each word, so a warp's stores coalesce,
//   and each word of K1 is written exactly once from a register
//   accumulator (no zero fill).
// - compact_kernel: each block sums the survivor counts of the blocks
//   before it (and of all blocks) itself, so no scan launch is needed. A
//   kept row moves to its block's offset plus the popcounts of the mask
//   words before it in the block plus its rank in its own word;
//   positions at or after the total are zeroed.
// - K2c: the row body stores a block's words to a word tile, uint32
//   [n_words][256] in shared memory beside the rows' tile, which holds
//   them across every sub-tile step; a dropped row writes nothing. A
//   block takes its logical index from a ticket (atomicAdd) when it
//   starts, so it waits only on blocks that have started and the
//   look-back cannot deadlock. After the walk it publishes its count
//   (AGGREGATE) in a 64-bit status word tagged with the launch's epoch
//   (so words of an earlier launch read as unpublished and the buffer
//   needs no reset; the ticket counter, 64 bits, never does either), warp
//   0 sums its predecessors back to the nearest INCLUSIVE prefix with
//   release stores and acquire loads, publishes its own inclusive prefix,
//   and the block moves each kept row from the word tile to prefix + its
//   rank (the popcounts of the warps' ballots before it): a warp's kept
//   rows land on consecutive columns. What K2c adds to K2 is latency on
//   each block's path (the ticket, the look-back's round trips to L2,
//   the scatter), paid once a wave of resident blocks: on 256-row tiles
//   it runs two rows a thread in 128-thread blocks capped at 64 registers,
//   so that the main path's 1,024 blocks are resident at once.
//
// All packing is in uint32_t and the reference's wrapping int32 products
// (l1 * 1e9 + l0, ms = sec * 1000 + ...) are computed in uint32_t, where
// wrap-around is defined. C++ `/` and `%` truncate; they are applied here
// only to operands that are non-negative, where they equal jnp's floor
// division.
//
// The same source compiles as host C++ (c++ -x c++, off __CUDACC__):
// the etl_*_host functions run each block's walk with loops in place of
// threads, staging each block's bytes into a tile laid out as on the card
// and calling the same row body, so the CPU tests reach the tile
// indexing, the sub-tile walk and the single-parse leaf bits; K2c's host
// walk interleaves the blocks' phases in a seeded order, so its look-back
// meets unpublished and aggregate-only predecessors.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC  (ops/decode_kernel.py)

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#else
#include <stdlib.h>
#include <string.h>
#define __host__
#define __device__
#define __global__
#define __constant__
#define __forceinline__ inline
#define __restrict__
#endif

namespace {

// kind codes: the order of ops/decode_kernel.py KIND_CODES
enum Kind {
    K_BOOL = 0, K_I16 = 1, K_I32 = 2, K_U32 = 3, K_I64 = 4, K_F32 = 5,
    K_F64 = 6, K_DATE = 7, K_TIME = 8, K_TIMESTAMP = 9, K_TIMESTAMPTZ = 10,
};

// column descriptor: DESC_STRIDE int32 per dense column (112 bytes, so
// every column's head and slots are 16-byte aligned, one vector load
// each): the head (Kind, text width W of the field, byte offset of the
// field in a row of bmat, packed slots of the column, ok first), then
// per slot (comp, bit_off, bits, zigzag)
constexpr int DESC_SLOT0 = 4;
constexpr int MAX_SLOTS = 6;
constexpr int DESC_STRIDE = DESC_SLOT0 + 4 * MAX_SLOTS;
constexpr int COMP_OK = -1;     // slot comp index of the ok bit

// predicate descriptor (ops/decode_kernel.py pred_descriptor):
// [n_instr, n_ref, n_ref referenced column slots,
//  n_instr instructions of PRED_STRIDE int32 each:
//  (opcode, slot, cmp, negate, a, b, c, d) — ops/predicate.py P_* / CMP_*,
//  then the single-parse index: the last referenced slot, n_cols + 1
//  offsets into the leaf list, a referenced flag per slot, and the leaf
//  list: per slot, the instruction numbers of its comparison leaves]
constexpr int PRED_CMP = 0, PRED_NULLTEST = 1, PRED_OR = 3, PRED_NOT = 4;
constexpr int CMP_EQ = 0, CMP_LT = 1, CMP_GT = 2, CMP_CONST = 3;
constexpr int PRED_STRIDE = 8;
constexpr int LEAF_BITS = 64;      // leaves with a bit in the leaf sets
constexpr int FILTER_BLOCK = 256;  // rows per block: whole 32-row warps

__constant__ int32_t P10[9] = {1, 10, 100, 1000, 10000, 100000, 1000000,
                               10000000, 100000000};

#ifdef __CUDACC__
#define POPC(x) __popc(x)
#else
#define POPC(x) __builtin_popcount(x)
#endif

__device__ __forceinline__ bool is_digit(int d) { return d >= 0 && d <= 9; }

// framer.c's nibble alphabet: codes 0-9 are digits, then - + . : space;
// 15 (padding) reads as 0
__device__ __forceinline__ int sym_char(uint32_t code) {
    return code < 10 ? '0' + (int)code
                     : (int)((0x00203A2E2B2DULL >> (8 * (code - 10))) & 0xFF);
}

// One field of one row: raw ASCII bytes or planar nibble pairs (byte k
// holds symbol k in the high nibble and symbol k + W/2 in the low one),
// in the block's tile (`tiled`) or, direct, in global memory.
struct Field {
    const uint8_t *p;
    int w, half;
    bool nibble, tiled;

    __device__ __forceinline__ int at(int k) const {
        if (!nibble) return p[k];
        bool low = k >= half;
        uint32_t b = p[low ? k - half : k];
        return sym_char(low ? b & 0xFu : b >> 4);
    }
    // clamped read (jnp take_along_axis over clip(q, 0, W - 1))
    __device__ __forceinline__ int atc(int q) const {
        return at(q < 0 ? 0 : (q > w - 1 ? w - 1 : q));
    }
};

// Four consecutive int32 of a descriptor, 16-byte aligned: one load.
struct I4 {
    int32_t x, y, z, w;
};

__device__ __forceinline__ I4 load_i4(const int32_t *p) {
#ifdef __CUDACC__
    int4 v = *reinterpret_cast<const int4 *>(p);
    return I4{v.x, v.y, v.z, v.w};
#else
    I4 v;
    memcpy(&v, p, sizeof v);
    return v;
#endif
}

// The field of a column whose descriptor head (kind, width, offset,
// slots) is `hd`.
__device__ __forceinline__ Field field_of(const uint8_t *row, const I4 &hd,
                                          int nibble, bool tiled) {
    return Field{row + hd.z, hd.y, hd.y >> 1, nibble != 0, tiled};
}

// a column's components in COLUMN_COMPONENTS order, as the reference's
// int32 bit patterns
struct Comps {
    uint32_t c0, c1, c2, c3, c4;
};

__device__ __forceinline__ uint32_t comp_at(const Comps &c, int i) {
    return i == 0 ? c.c0 : i == 1 ? c.c1 : i == 2 ? c.c2 : i == 3 ? c.c3
                                                                   : c.c4;
}

// parsers.parse_int: sign, three base-10^9 limbs, digit count, ok. The
// digits are walked from the last one read to the first, so the place
// value 10^(r % 9) of limb r / 9 (r = len - 1 - pos) is a running product.
__device__ __forceinline__ bool parse_int(const Field &f, int len, bool &neg,
                                          int32_t &l0, int32_t &l1,
                                          int32_t &l2, int &ndigits) {
    int b0 = f.at(0);
    neg = b0 == '-';
    int start = (neg || b0 == '+') ? 1 : 0;
    l0 = l1 = l2 = 0;
    bool all_digits = true;
    int hi = len < f.w ? len : f.w;
    int r = len - hi;  // r of pos = hi - 1, >= 0
    int k = r / 9, e = r - 9 * k;
    int32_t pv = 1;
    for (int i = 0; i < e; ++i) pv *= 10;
    for (int pos = hi - 1; pos >= start; --pos) {
        int d = f.at(pos) - '0';
        if (is_digit(d)) {
            int32_t v = d * pv;
            if (k == 0) l0 += v;
            else if (k == 1) l1 += v;
            else if (k == 2) l2 += v;
        } else {
            all_digits = false;
        }
        pv *= 10;
        if (++e == 9) {
            e = 0;
            pv = 1;
            ++k;
        }
    }
    ndigits = len - start;
    return all_digits && ndigits >= 1 && ndigits <= 27 && len <= f.w;
}

__device__ __forceinline__ uint32_t load32(const uint8_t *p) {
#ifdef __CUDACC__
    return *reinterpret_cast<const uint32_t *>(p);
#else
    uint32_t v;
    memcpy(&v, p, 4);
    return v;
#endif
}

// The low n 4-bit lanes of a 32- or 64-bit word (n <= 0: none).
__device__ __forceinline__ uint32_t nib_mask32(int n) {
    return n <= 0 ? 0u : n >= 8 ? ~0u : (1u << (4 * n)) - 1u;
}
__device__ __forceinline__ uint64_t nib_mask(int n) {
    return n <= 0 ? 0 : n >= 16 ? ~0ull : (1ull << (4 * n)) - 1;
}

// A code in the low 4 bits of each byte of x -> the 8 codes as 4-bit
// lanes of the low 32 bits, byte i's at lane i.
__device__ __forceinline__ uint64_t compact_nibbles(uint64_t x) {
    x = (x | (x >> 4)) & 0x00FF00FF00FF00FFull;
    x = (x | (x >> 8)) & 0x0000FFFF0000FFFFull;
    return (x | (x >> 16)) & 0x00000000FFFFFFFFull;
}

// The same for the 4 bytes of a 32-bit word -> 4 lanes of 16 bits.
__device__ __forceinline__ uint32_t compact_nibbles32(uint32_t x) {
    x = (x | (x >> 4)) & 0x00FF00FFu;
    return (x | (x >> 8)) & 0x0000FFFFu;
}

// The 8 bytes of a field in the tile from byte f.p on, read as aligned
// 32-bit words (the tile holds at least 12 bytes past any field).
__device__ __forceinline__ uint64_t field_window(const Field &f) {
    unsigned a = (unsigned)((uintptr_t)f.p & 3);
    const uint8_t *base = f.p - a;
    uint64_t win = load32(base) | (uint64_t)load32(base + 4) << 32;
    // << (63 - 8a) << 1: 0 for a == 0, without a shift by 64
    return (win >> (8 * a)) | (uint64_t)load32(base + 8) << (63 - 8 * a) << 1;
}

// The value of 8 decimal digits in the 4-bit lanes of x, lane 0 the most
// significant; every lane <= 9.
__device__ __forceinline__ uint32_t swar_decimal8(uint32_t x) {
    x = (x & 0x0F0F0F0Fu) * 10 + ((x >> 4) & 0x0F0F0F0Fu);
    x = (x & 0x00FF00FFu) * 100 + ((x >> 8) & 0x00FF00FFu);
    return (x & 0xFFFFu) * 10000 + (x >> 16);
}

// 10^m for 0 <= m <= 8, without a table: one factor per bit of m.
__device__ __forceinline__ uint32_t pow10_small(int m) {
    return (m & 1 ? 10u : 1u) * (m & 2 ? 100u : 1u) * (m & 4 ? 10000u : 1u) *
           (m & 8 ? 100000000u : 1u);
}

// The base-10^9 limbs of v * 10^e mod 10^27, for v < 10^9 and e >= 0:
// v * 10^(e % 9) < 10^17 splits into two limbs, which e / 9 shifts up.
struct Limbs {
    uint32_t l0, l1, l2;
};

__device__ __forceinline__ Limbs scaled_limbs(uint32_t v, int e) {
    int q = e / 9;
    uint64_t t = (uint64_t)v * pow10_small(e - 9 * q);
    uint32_t hi = (uint32_t)(t / 1000000000ull);
    uint32_t lo = (uint32_t)t - hi * 1000000000u;
    return Limbs{q == 0 ? lo : 0u, q == 0 ? hi : q == 1 ? lo : 0u,
                 q == 1 ? hi : q == 2 ? lo : 0u};
}

// x + y limb by limb, mod 10^27.
__device__ __forceinline__ Limbs add_limbs(const Limbs &x, const Limbs &y) {
    uint32_t s0 = x.l0 + y.l0, c0 = s0 >= 1000000000u;
    uint32_t s1 = x.l1 + y.l1 + c0, c1 = s1 >= 1000000000u;
    uint32_t s2 = x.l2 + y.l2 + c1;
    return Limbs{s0 - c0 * 1000000000u, s1 - c1 * 1000000000u,
                 s2 >= 1000000000u ? s2 - 1000000000u : s2};
}

// parse_int on a nibble field of W <= 16 symbols in the tile, without a
// loop or a branch. Its bytes are read as aligned 32-bit words and split
// into a string of 4-bit codes, symbol k at lane k; the digit check, the
// zeroing of non-digits and the decimal value of the positions read are
// computed on all lanes at once (32-bit lanes for W <= 8), and the limbs
// take that value times 10^(len - hi), the place value of the last
// position read (len > hi for a field longer than its width). Equal to
// parse_int.
template <bool WIDE>  // W <= 8 in 32-bit lanes; WIDE: 9 <= W <= 16
__device__ __forceinline__ bool parse_int_nibble(const Field &f, int len,
                                                 bool &neg, int32_t &l0,
                                                 int32_t &l1, int32_t &l2,
                                                 int &ndigits) {
    uint64_t win = field_window(f);
    int hi = len < f.w ? len : f.w;
    int e = len - hi;  // >= 0: the place value of position hi - 1
    uint32_t c0;
    int start;
    bool all_digits;
    Limbs lm;
    if (!WIDE) {
        uint32_t w32 = (uint32_t)win;
        uint32_t s = ((compact_nibbles32((w32 >> 4) & 0x0F0F0F0Fu) &
                       nib_mask32(f.half)) |
                      (compact_nibbles32(w32 & 0x0F0F0F0Fu) << (4 * f.half))) &
                     nib_mask32(f.w);
        c0 = s & 0xFu;
        neg = c0 == 10;
        start = (neg || c0 == 11) ? 1 : 0;
        uint32_t m = nib_mask32(hi) & ~nib_mask32(start);
        // code >= 10 <=> bit 3 and (bit 2 or bit 1)
        uint32_t bad = (s >> 3) & ((s >> 2) | (s >> 1)) & 0x11111111u & m;
        all_digits = bad == 0;
        uint32_t d = s & ~(bad * 0xFu) & m;
        d = hi >= 8 ? d : hi > 0 ? d << (4 * (8 - hi)) : 0;  // -> lane 7
        lm = scaled_limbs(swar_decimal8(d), e);
    } else {
        uint64_t s = ((compact_nibbles((win >> 4) & 0x0F0F0F0F0F0F0F0Full) &
                       nib_mask(f.half)) |
                      (compact_nibbles(win & 0x0F0F0F0F0F0F0F0Full)
                       << (4 * f.half))) &
                     nib_mask(f.w);
        c0 = (uint32_t)s & 0xFu;
        neg = c0 == 10;
        start = (neg || c0 == 11) ? 1 : 0;
        uint64_t m = nib_mask(hi) & ~nib_mask(start);
        uint64_t bad = (s >> 3) & ((s >> 2) | (s >> 1)) &
                       0x1111111111111111ull & m;
        all_digits = bad == 0;
        uint64_t d = s & ~(bad * 0xF) & m;
        d = hi >= 16 ? d : hi > 0 ? d << (4 * (16 - hi)) : 0;  // -> lane 15
        // lanes 0-7 weigh 10^8 more than lanes 8-15
        lm = add_limbs(scaled_limbs(swar_decimal8((uint32_t)d), e + 8),
                       scaled_limbs(swar_decimal8((uint32_t)(d >> 32)), e));
    }
    l0 = (int32_t)lm.l0;
    l1 = (int32_t)lm.l1;
    l2 = (int32_t)lm.l2;
    ndigits = len - start;
    return all_digits && ndigits >= 1 && ndigits <= 27 && len <= f.w;
}

// parsers._int_range_ok
__device__ __forceinline__ bool int_range_ok(int kind, bool neg, int32_t l0,
                                             int32_t l1, int32_t l2, int nd) {
    if (kind == K_I16)
        return nd <= 5 && l1 == 0 && l2 == 0 &&
               ((neg && l0 <= 32768) || (!neg && l0 <= 32767));
    if (kind == K_I32)
        return nd <= 10 && l2 == 0 &&
               (l1 < 2 || (l1 == 2 && ((neg && l0 <= 147483648) ||
                                       (!neg && l0 <= 147483647))));
    if (kind == K_U32)
        return nd <= 10 && l2 == 0 && !neg &&
               (l1 < 4 || (l1 == 4 && l0 <= 294967295));
    // K_I64: |min| = 9223372036854775808
    int hi = neg ? 1 : 0;
    bool at_cap = l2 == 9 && (l1 > 223372036 ||
                              (l1 == 223372036 && l0 > 854775807 + hi));
    return nd <= 19 && !(l2 > 9 || at_cap);
}

// codec.text.days_from_civil for y >= 1, 1 <= m <= 12 (every operand of
// / is then non-negative)
__device__ __forceinline__ int32_t days_from_civil(int y, int m, int d) {
    y -= m <= 2;
    int era = y / 400;
    int yoe = y - era * 400;
    int doy = (153 * (m + (m > 2 ? -3 : 9)) + 2) / 5 + d - 1;
    int doe = yoe * 365 + yoe / 4 - yoe / 100 + doy;
    return era * 146097 + doe - 719468;
}

// parsers.parse_date: 'YYYY-MM-DD' -> days (0 unless ok)
__device__ __forceinline__ bool parse_date(const Field &f, int len,
                                           int32_t &days) {
    int y0 = f.at(0) - '0', y1 = f.at(1) - '0', y2 = f.at(2) - '0',
        y3 = f.at(3) - '0', m0 = f.at(5) - '0', m1 = f.at(6) - '0',
        d0 = f.at(8) - '0', d1 = f.at(9) - '0';
    int y = y0 * 1000 + y1 * 100 + y2 * 10 + y3;
    int m = m0 * 10 + m1;
    int dd = d0 * 10 + d1;
    bool digits_ok = is_digit(y0) && is_digit(y1) && is_digit(y2) &&
                     is_digit(y3) && is_digit(m0) && is_digit(m1) &&
                     is_digit(d0) && is_digit(d1);
    bool ok = len == 10 && digits_ok && f.at(4) == '-' && f.at(7) == '-' &&
              m >= 1 && m <= 12 && dd >= 1 && dd <= 31 && y >= 1;
    days = ok ? days_from_civil(y, m, dd) : 0;
    return ok;
}

// parsers._parse_hms_at: HH:MM:SS[.ffffff] at column `base`
__device__ __forceinline__ bool parse_hms(const Field &f, int len, int base,
                                          int32_t &sec, int32_t &us,
                                          int &end) {
    int h0 = f.at(base) - '0', h1 = f.at(base + 1) - '0',
        m0 = f.at(base + 3) - '0', m1 = f.at(base + 4) - '0',
        s0 = f.at(base + 6) - '0', s1 = f.at(base + 7) - '0';
    int hh = h0 * 10 + h1, mm = m0 * 10 + m1, ss = s0 * 10 + s1;
    bool sep_ok = f.at(base + 2) == ':' && f.at(base + 5) == ':';
    bool digits_ok = is_digit(h0) && is_digit(h1) && is_digit(m0) &&
                     is_digit(m1) && is_digit(s0) && is_digit(s1);
    bool has_dot = base + 8 < f.w && len > base + 8 && f.at(base + 8) == '.';
    // fractional digits: the run of digits starting at base + 9, max 6,
    // summed Horner-wise and scaled to microseconds
    int run = 0;
    int32_t frac = 0;
    bool going = has_dot;
#ifdef __CUDACC__
#pragma unroll
#endif
    for (int k = 0; k < 6; ++k) {
        int pos = base + 9 + k;
        if (going && (pos >= len || pos >= f.w)) going = false;
        int d = going ? f.at(pos) - '0' : 0;
        if (going && !is_digit(d)) going = false;
        if (going) {
            frac = frac * 10 + d;
            ++run;
        }
    }
    for (int k = run; k < 6; ++k) frac *= 10;
    us = frac;
    end = base + 8 + (has_dot ? 1 + run : 0);
    sec = (hh * 60 + mm) * 60 + ss;  // |hh| <= 2277: no overflow
    return sep_ok && digits_ok && (!has_dot || run >= 1) && hh <= 23 &&
           mm <= 59 && ss <= 59;
}

// parsers._parse_tz_at: ±HH[:MM[:SS]] at per-row position p
__device__ __forceinline__ bool parse_tz(const Field &f, int len, int p,
                                         int32_t &off, int &end) {
    int sb = f.atc(p);
    bool neg = sb == '-';
    bool sign_ok = neg || sb == '+';
    int d1 = f.atc(p + 1) - '0', d2 = f.atc(p + 2) - '0';
    int hh = d1 * 10 + d2;
    bool hh_ok = is_digit(d1) && is_digit(d2);
    bool has_min = len > p + 3 && f.atc(p + 3) == ':';
    int m1 = f.atc(p + 4) - '0', m2 = f.atc(p + 5) - '0';
    int mm = has_min ? m1 * 10 + m2 : 0;
    bool mm_ok = !has_min || (is_digit(m1) && is_digit(m2));
    bool has_sec = has_min && len > p + 6 && f.atc(p + 6) == ':';
    int s1 = f.atc(p + 7) - '0', s2 = f.atc(p + 8) - '0';
    int ss = has_sec ? s1 * 10 + s2 : 0;
    bool ss_ok = !has_sec || (is_digit(s1) && is_digit(s2));
    end = p + 3 + (has_min ? 3 : 0) + (has_sec ? 3 : 0);
    int o = hh * 3600 + mm * 60 + ss;
    off = neg ? -o : o;
    return sign_ok && hh_ok && mm_ok && ss_ok && hh <= 15;
}

__device__ __forceinline__ bool match_lit(const Field &f, int len,
                                          const char *lit, int n) {
    if (len != n || n > f.w) return false;
    for (int i = 0; i < n; ++i)
        if (f.at(i) != lit[i]) return false;
    return true;
}

// parsers.parse_float -> (neg, limb0, limb1, exp_adj, special), ok
__device__ __forceinline__ bool parse_float(const Field &f, int len,
                                            Comps &c) {
    int special = match_lit(f, len, "NaN", 3) ? 1
                  : match_lit(f, len, "Infinity", 8) ? 2
                  : match_lit(f, len, "-Infinity", 9) ? 3 : 0;
    int b0 = f.at(0);
    bool neg = b0 == '-';
    int start = (neg || b0 == '+') ? 1 : 0;
    int hi = len < f.w ? len : f.w;
    bool has_e = false;
    int e_pos = len;
    for (int pos = 0; pos < hi; ++pos) {
        int ch = f.at(pos);
        if (ch == 'e' || ch == 'E') {
            has_e = true;
            e_pos = pos;
            break;
        }
    }
    int mant_end = e_pos < f.w ? e_pos : f.w;  // e_pos <= len
    bool has_dot = false;
    int dot_pos = e_pos, n_dots = 0;
    for (int pos = 0; pos < mant_end; ++pos) {
        if (f.at(pos) == '.') {
            if (!has_dot) dot_pos = pos;
            has_dot = true;
            ++n_dots;
        }
    }
    int frac_count = has_dot ? e_pos - dot_pos - 1 : 0;
    bool mant_valid = true, leading = true;
    int n_mant = 0, lead_zero_run = 0;
    int32_t limb0 = 0, limb1 = 0;
    for (int pos = start; pos < mant_end; ++pos) {
        int ch = f.at(pos);
        if (ch == '.') continue;
        ++n_mant;
        int d = ch - '0';
        if (leading) {
            if (d == 0) ++lead_zero_run;
            else leading = false;
        }
        if (!is_digit(d)) {
            mant_valid = false;
            continue;
        }
        int r = pos < dot_pos ? dot_pos - 1 - pos + frac_count
                              : e_pos - 1 - pos;  // >= 0 here
        if (r < 9) limb0 += d * P10[r];
        else if (r < 18) limb1 += d * P10[r - 9];
    }
    int exp_start = e_pos + 1;
    int eb = f.atc(exp_start);
    bool exp_neg = has_e && eb == '-';
    bool exp_sign = has_e && (exp_neg || eb == '+');
    int exp_d_start = exp_start + (exp_sign ? 1 : 0);
    bool exp_valid = !has_e || len > exp_d_start;
    int32_t exp_val = 0;
    for (int pos = exp_d_start < 0 ? 0 : exp_d_start; pos < hi; ++pos) {
        int d = f.at(pos) - '0';
        if (!is_digit(d)) {
            exp_valid = false;
            continue;
        }
        int re = len - 1 - pos;
        if (re < 9) exp_val += d * P10[re];
    }
    if (exp_neg) exp_val = -exp_val;
    if (!has_e) exp_val = 0;
    int32_t exp_adj = exp_val - frac_count;
    int sig = n_mant - lead_zero_run;
    bool fast = sig <= 15 && (exp_adj <= 22 && exp_adj >= -22) &&
                n_mant >= 1 && n_mant <= 18 && n_dots <= 1 && mant_valid &&
                exp_valid;
    c.c0 = neg;
    c.c1 = (uint32_t)limb0;
    c.c2 = (uint32_t)limb1;
    c.c3 = (uint32_t)exp_adj;
    c.c4 = (uint32_t)special;
    return fast || special > 0;
}

#ifdef __CUDACC__
#define UNROLL _Pragma("unroll")
#else
#define UNROLL
#endif

// parsers.parse_column on the same column of N rows: components in
// COLUMN_COMPONENTS order, as the reference's int32 bit patterns, and ok.
// One dispatch on the kind; each case runs the N rows' parses side by
// side, independent chains the scheduler interleaves.
template <int N>
__device__ __forceinline__ void parse_columns(int kind, const Field (&f)[N],
                                              const int (&len)[N],
                                              Comps (&c)[N], bool (&ok)[N]) {
    UNROLL for (int k = 0; k < N; ++k) c[k] = Comps{0, 0, 0, 0, 0};
    switch (kind) {
        case K_BOOL:
            UNROLL for (int k = 0; k < N; ++k) {
                int b0 = f[k].at(0);
                c[k].c0 = b0 == 't';
                ok[k] = len[k] == 1 && (b0 == 't' || b0 == 'f');
            }
            return;
        case K_I16: case K_I32: case K_U32: case K_I64: {
            bool neg[N];
            int32_t l0[N], l1[N], l2[N];
            int nd[N];
            // a column's width and mode are the same on every row
            if (f[0].tiled && f[0].nibble && f[0].w <= 8) {
                UNROLL for (int k = 0; k < N; ++k)
                    ok[k] = parse_int_nibble<false>(f[k], len[k], neg[k],
                                                    l0[k], l1[k], l2[k],
                                                    nd[k]);
            } else if (f[0].tiled && f[0].nibble && f[0].w <= 16) {
                UNROLL for (int k = 0; k < N; ++k)
                    ok[k] = parse_int_nibble<true>(f[k], len[k], neg[k],
                                                   l0[k], l1[k], l2[k],
                                                   nd[k]);
            } else {
                UNROLL for (int k = 0; k < N; ++k)
                    ok[k] = parse_int(f[k], len[k], neg[k], l0[k], l1[k],
                                      l2[k], nd[k]);
            }
            UNROLL for (int k = 0; k < N; ++k) {
                ok[k] = ok[k] &&
                        int_range_ok(kind, neg[k], l0[k], l1[k], l2[k], nd[k]);
                if (kind == K_I64) {
                    c[k].c0 = neg[k];
                    c[k].c1 = (uint32_t)l0[k];
                    c[k].c2 = (uint32_t)l1[k];
                    c[k].c3 = (uint32_t)l2[k];
                } else {
                    uint32_t v =
                        (uint32_t)l1[k] * 1000000000u + (uint32_t)l0[k];
                    c[k].c0 = neg[k] ? 0u - v : v;
                }
            }
            return;
        }
        case K_F32: case K_F64:
            UNROLL for (int k = 0; k < N; ++k)
                ok[k] = parse_float(f[k], len[k], c[k]);
            return;
        case K_DATE:
            UNROLL for (int k = 0; k < N; ++k) {
                int32_t days;
                ok[k] = parse_date(f[k], len[k], days);
                c[k].c0 = (uint32_t)days;
            }
            return;
        case K_TIME:
            UNROLL for (int k = 0; k < N; ++k) {
                int32_t sec, us;
                int end;
                ok[k] = parse_hms(f[k], len[k], 0, sec, us, end) &&
                        end == len[k];
                c[k].c0 = (uint32_t)sec * 1000u + (uint32_t)(us / 1000);
                c[k].c1 = (uint32_t)(us % 1000);
            }
            return;
        default:  // K_TIMESTAMP, K_TIMESTAMPTZ
            UNROLL for (int k = 0; k < N; ++k) {
                int32_t days, sec, us, tz = 0;
                int end, tz_end;
                bool date_ok = parse_date(f[k], 10, days);
                bool space_ok = f[k].at(10) == ' ';
                bool hms_ok = parse_hms(f[k], len[k], 11, sec, us, end);
                bool good;
                if (kind == K_TIMESTAMPTZ) {
                    bool tz_ok = parse_tz(f[k], len[k], end, tz, tz_end);
                    good = date_ok && space_ok && hms_ok && tz_ok &&
                           tz_end == len[k];
                } else {
                    good = date_ok && space_ok && hms_ok && end == len[k];
                }
                uint32_t ms = (uint32_t)sec * 1000u + (uint32_t)(us / 1000);
                c[k].c0 = (uint32_t)days;
                c[k].c1 = ms - (uint32_t)tz * 1000u;
                c[k].c2 = (uint32_t)(us % 1000);
                ok[k] = good && len[k] >= 19;
            }
            return;
    }
}

// Length of field j of a row whose n_cols lengths start at `lens`.
__device__ __forceinline__ int field_len(const uint8_t *lens, int lengths_u8,
                                         int j) {
    return lengths_u8 ? (int)lens[j] : ((const int32_t *)lens)[j];
}

__device__ __forceinline__ bool cmp3(int64_t v, int64_t lit, int cmp) {
    return cmp == CMP_EQ ? v == lit : (cmp == CMP_LT ? v < lit : v > lit);
}

// predicate._device_cmp on one row, against the host-folded literal words
// of instruction `ins`. Components are the reference's int32 bit patterns.
__device__ __forceinline__ bool cmp_leaf(int kind, const Comps &c,
                                         const int32_t *ins) {
    int cmp = ins[2];
    bool res;
    if (cmp == CMP_CONST) {
        res = ins[4] != 0;
    } else if (kind == K_U32) {
        // sign-flipped int32 space orders as uint32 (literal pre-biased)
        res = cmp3((int32_t)(c.c0 ^ 0x80000000u), ins[4], cmp);
    } else if (kind == K_I64) {
        bool neg = (int32_t)c.c0 > 0;
        int32_t l0 = (int32_t)c.c1, l1 = (int32_t)c.c2, l2 = (int32_t)c.c3;
        bool sign_neg = neg && (l0 > 0 || l1 > 0 || l2 > 0);  // "-0" is 0
        bool lneg = ins[7] != 0;
        bool mag_eq = l0 == ins[4] && l1 == ins[5] && l2 == ins[6];
        bool mag_gt = l2 > ins[6] ||
                      (l2 == ins[6] && (l1 > ins[5] ||
                                        (l1 == ins[5] && l0 > ins[4])));
        if (cmp == CMP_EQ)
            res = mag_eq && sign_neg == lneg;
        else if (cmp == CMP_GT)
            res = lneg ? (!sign_neg || (!mag_gt && !mag_eq))
                       : (!sign_neg && mag_gt);
        else
            res = lneg ? (sign_neg && mag_gt)
                       : (sign_neg || (!mag_gt && !mag_eq));
    } else if (kind == K_TIME) {
        int32_t ms = (int32_t)c.c0, us = (int32_t)c.c1;
        bool eq = ms == ins[4] && us == ins[5];
        bool gt = ms > ins[4] || (ms == ins[4] && us > ins[5]);
        res = cmp == CMP_EQ ? eq : (cmp == CMP_GT ? gt : !gt && !eq);
    } else if (kind == K_TIMESTAMP || kind == K_TIMESTAMPTZ) {
        // the tz fold can push ms out of [0, 86_400_000): one borrow or
        // carry renormalises (|tz| < 1 day); int64 keeps garbage rows of
        // unparsed fields free of overflow
        const int64_t day_ms = 86400000;
        int64_t days = (int32_t)c.c0, ms = (int32_t)c.c1,
                us = (int32_t)c.c2;
        if (ms < 0) {
            days -= 1;
            ms += day_ms;
        } else if (ms >= day_ms) {
            days += 1;
            ms -= day_ms;
        }
        bool eq = days == ins[4] && ms == ins[5] && us == ins[6];
        bool gt = days > ins[4] ||
                  (days == ins[4] && (ms > ins[5] ||
                                      (ms == ins[5] && us > ins[6])));
        res = cmp == CMP_EQ ? eq : (cmp == CMP_GT ? gt : !gt && !eq);
    } else {  // K_BOOL, K_I16, K_I32, K_DATE: one int32 component
        res = cmp3((int32_t)c.c0, ins[4], cmp);
    }
    return ins[3] ? !res : res;
}

// ---------------------------------------------------------------------------
// one launch, its tile layout and the row body both kernels share
// ---------------------------------------------------------------------------

struct Job {
    const uint8_t *bmat;     // [R, row_bytes]
    int64_t row_bytes;
    const uint8_t *lengths;  // [R, n_cols] u8 or int32
    int lengths_u8, n_cols;
    const int32_t *desc;     // n_cols * DESC_STRIDE
    int nibble;
    const uint8_t *flags;    // K2: [R] 0 dead, 1 live, 2 live + force-keep
    const int32_t *pred;     // K2: the predicate descriptor
    int pred_ints;
    uint32_t *words;         // [n_words, R]
    uint32_t *mask;          // K2: [ceil(R / 32)]
    int32_t *block_counts;   // K2: [ceil(R / FILTER_BLOCK)]
    int64_t n_rows;
    int n_words;
    // K2c: per-logical-block status words, the ticket counter, the tickets
    // earlier launches on this buffer took, this launch's epoch, counts[1]
    uint64_t *status;
    unsigned long long *ticket;
    uint64_t ticket_base;
    uint32_t epoch;
    int32_t *counts;
};

// Row stride of the byte tile: one word more where a row is an even
// number of 32-bit words, so a warp's 32 rows start on 32 banks.
__host__ __device__ __forceinline__ int64_t tile_stride(int64_t row_bytes) {
    return row_bytes % 8 == 0 ? row_bytes + 4 : row_bytes;
}

// Byte offsets in a block's dynamic shared memory for tiles of T rows:
// row bytes, lengths, flags (K2), then the descriptor and the predicate
// program. Every part before the descriptor is a multiple of 16 bytes
// long (T is a multiple of 32), so each starts 16-byte aligned. T = 0
// (direct) stages nothing. K2c (tile_words = n_words) adds the block's
// word tile, uint32 [n_words][FILTER_BLOCK], 16-byte aligned after the
// rest: it holds the whole block's words across every sub-tile step.
struct Layout {
    int64_t lens, flags, desc, pred, words, total;
};

__host__ __device__ __forceinline__ Layout tile_layout(int64_t row_bytes,
                                                       int n_cols,
                                                       int lengths_u8,
                                                       bool filter,
                                                       int pred_ints, int T,
                                                       int tile_words) {
    Layout L{0, 0, 0, 0, 0, 0};
    if (T > 0) {
        L.lens = T * tile_stride(row_bytes);
        L.flags = L.lens + (int64_t)T * n_cols * (lengths_u8 ? 1 : 4);
        L.desc = L.flags + (filter ? T : 0);
        L.pred = L.desc + 4 * (int64_t)n_cols * DESC_STRIDE;
        L.total = L.pred + 4 * (int64_t)(filter ? pred_ints : 0);
    }
    L.words = L.total;
    if (tile_words > 0) {
        L.words = (L.total + 15) & ~(int64_t)15;
        L.total = L.words + 4 * (int64_t)tile_words * FILTER_BLOCK;
    }
    return L;
}

// Asynchronous copies from global memory into the tile (cp.async: the
// thread issues every copy of its share without waiting for any, and
// cp_async_wait waits for all of them), 16 or 4 bytes, both addresses
// aligned to the size. On the host, plain copies.
__device__ __forceinline__ void copy16_async(uint8_t *dst,
                                             const uint8_t *src) {
#ifdef __CUDACC__
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     (unsigned)__cvta_generic_to_shared(dst)),
                 "l"(src));
#else
    memcpy(dst, src, 16);
#endif
}

__device__ __forceinline__ void copy4_async(uint8_t *dst, const uint8_t *src) {
#ifdef __CUDACC__
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     (unsigned)__cvta_generic_to_shared(dst)),
                 "l"(src));
#else
    memcpy(dst, src, 4);
#endif
}

__device__ __forceinline__ void cp_async_wait() {
#ifdef __CUDACC__
    asm volatile("cp.async.wait_all;\n" ::);
#endif
}

// Thread `tid` of nt's share of copying n bytes from a 16-byte-aligned
// global range to a 16-byte-aligned tile: whole 16-byte chunks issued
// asynchronously, then the ragged end bytewise.
__device__ __forceinline__ void stage_bytes(uint8_t *dst, const uint8_t *src,
                                            int64_t n, int tid, int nt) {
    int64_t n16 = n >> 4;
    for (int64_t c = tid; c < n16; c += nt)
        copy16_async(dst + 16 * c, src + 16 * c);
    for (int64_t b = 16 * n16 + tid; b < n; b += nt) dst[b] = src[b];
}

// The same for row bytes stored one word apart (tile_stride): a row of
// rw words (rw even) lands at row * (rw + 1) words.
__device__ __forceinline__ void stage_rows_padded(uint8_t *dst,
                                                  const uint8_t *src,
                                                  int64_t n, int64_t rw,
                                                  int tid, int nt) {
    int64_t n16 = n >> 4;
    for (int64_t c = tid; c < n16; c += nt) {
        int64_t i = 4 * c, row = i / rw, col = i - row * rw;
        for (int q = 0; q < 4; ++q) {
            copy4_async(dst + 4 * (i + q + row), src + 4 * (i + q));
            if (++col == rw) {
                col = 0;
                ++row;
            }
        }
    }
    for (int64_t i = 4 * n16 + tid; 4 * i < n; i += nt)
        copy4_async(dst + 4 * (i + i / rw), src + 4 * i);
}

// Stage rows [r0, r0 + T) ∩ [0, R): thread tid of nt's share.
__device__ __forceinline__ void stage_step(const Job &a, const Layout &L,
                                           uint8_t *smem, bool filter,
                                           int64_t r0, int T, int tid,
                                           int nt) {
    int64_t n = a.n_rows - r0 < T ? a.n_rows - r0 : T;
    int lsize = a.lengths_u8 ? 1 : 4;
    if (tile_stride(a.row_bytes) != a.row_bytes)
        stage_rows_padded(smem, a.bmat + r0 * a.row_bytes, n * a.row_bytes,
                          a.row_bytes / 4, tid, nt);
    else
        stage_bytes(smem, a.bmat + r0 * a.row_bytes, n * a.row_bytes, tid,
                    nt);
    int64_t lrow = (int64_t)a.n_cols * lsize;
    stage_bytes(smem + L.lens, a.lengths + r0 * lrow, n * lrow, tid, nt);
    if (filter) stage_bytes(smem + L.flags, a.flags + r0, n, tid, nt);
}

// Stage the descriptor (whole 16-byte chunks: 112 bytes a column) and the
// predicate program, once per block, asynchronously.
__device__ __forceinline__ void stage_tables(const Job &a, const Layout &L,
                                             uint8_t *smem, bool filter,
                                             int tid, int nt) {
    stage_bytes(smem + L.desc, (const uint8_t *)a.desc,
                4 * (int64_t)a.n_cols * DESC_STRIDE, tid, nt);
    if (filter)
        for (int i = tid; i < a.pred_ints; i += nt)
            copy4_async(smem + L.pred + 4 * i, (const uint8_t *)(a.pred + i));
}

// Zero row r's words (a dropped row of K2).
__device__ __forceinline__ void zero_words(const Job &a, int64_t r) {
    for (int w = 0; w < a.n_words; ++w) a.words[(int64_t)w * a.n_rows + r] = 0;
}

// Word cw of row r: to the output (K1, K2) or, COMPACT (K2c), to the
// block's word tile `wt`, column r % FILTER_BLOCK.
template <bool COMPACT>
__device__ __forceinline__ void put_word(const Job &a, uint32_t *wt, int cw,
                                         int64_t r, uint32_t v) {
    if (COMPACT)
        wt[cw * FILTER_BLOCK + (int)(r % FILTER_BLOCK)] = v;
    else
        a.words[(int64_t)cw * a.n_rows + r] = v;
}

// A leaf past LEAF_BITS: its column parsed again from the row and judged
// -> bit 0 true, bit 1 false.
template <bool STAGED>
__device__ __forceinline__ uint32_t reparse_leaf(const uint8_t *row,
                                              const uint8_t *lens,
                                              int lengths_u8,
                                              const int32_t *desc, int nibble,
                                              const int32_t *ins) {
    int j = ins[1];
    I4 hd = load_i4(desc + j * DESC_STRIDE);
    Field f[1] = {field_of(row, hd, nibble, STAGED)};
    int len[1] = {field_len(lens, lengths_u8, j)};
    Comps c[1];
    bool ok[1];
    parse_columns<1>(hd.x, f, len, c, ok);
    bool res = cmp_leaf(hd.x, c[0], ins);
    return (uint32_t)(len[0] != 0 && res) | (uint32_t)(len[0] != 0 && !res)
                                                << 1;
}

// The row filter's postfix program over one row, the leaves' bits taken
// from the single parse (lt, lf); a leaf past LEAF_BITS parses its column
// again from the row.
template <bool STAGED>
__device__ __forceinline__ bool judge(const Job &a, const int32_t *desc,
                                      const int32_t *prog, int n_instr,
                                      uint64_t lt, uint64_t lf,
                                      const uint8_t *row, const uint8_t *lens,
                                      int flag, bool unevaluable) {
    uint32_t ts = 0, fs = 0;  // Kleene stacks, bit 0 = top
    for (int i = 0; i < n_instr; ++i) {
        const int32_t *ins = prog + i * PRED_STRIDE;
        int op = ins[0];
        bool t, f;
        if (op == PRED_NULLTEST) {
            bool is_null = field_len(lens, a.lengths_u8, ins[1]) == 0;
            t = ins[3] ? !is_null : is_null;
            f = !t;
        } else if (op == PRED_CMP && i < LEAF_BITS) {
            t = (lt >> i) & 1u;
            f = (lf >> i) & 1u;
        } else if (op == PRED_CMP) {
            uint32_t tf = reparse_leaf<STAGED>(row, lens, a.lengths_u8, desc,
                                               a.nibble, ins);
            t = tf & 1u;
            f = tf >> 1;
        } else if (op == PRED_NOT) {
            t = fs & 1u;
            f = ts & 1u;
            ts >>= 1;
            fs >>= 1;
        } else {  // PRED_AND / PRED_OR over the top n entries
            int n = ins[4];
            uint32_t m = n >= 32 ? 0xFFFFFFFFu : (1u << n) - 1u;
            uint32_t tt = ts & m, ff = fs & m;
            ts = n >= 32 ? 0u : ts >> n;
            fs = n >= 32 ? 0u : fs >> n;
            bool is_or = op == PRED_OR;
            t = is_or ? tt != 0u : tt == m;
            f = is_or ? ff == m : ff != 0u;
        }
        ts = (ts << 1) | (uint32_t)t;
        fs = (fs << 1) | (uint32_t)f;
    }
    // a referenced field that is present but failed its device parse
    // cannot be judged here: keep it, the host re-checks after fixup
    return (ts & 1u) || flag > 1 || unevaluable;
}

// Row `lr` of the current step's rows: its bytes, lengths and flag, from
// the tile (STAGED) or from global memory (row r).
struct RowSrc {
    const uint8_t *row, *lens;
    int flag;
};

// Parse and pack the R rows r[k] of one thread: their column r[k] of
// every output word (rows at or past n_rows are skipped). With FILTER, the
// row filter decides whether each row is kept (keep[k]); a dropped row's
// words are zeros, or with COMPACT not written at all (its words go to
// the word tile `wt`, and only kept rows leave it). Every column is parsed
// once; a referenced column's comparison leaves are judged on the
// components just parsed, and the postfix program runs right after the
// last referenced column.
template <bool FILTER, bool STAGED, bool COMPACT, int R>
__device__ __forceinline__ void rows_body(const Job &a, const int32_t *desc,
                                          const int32_t *pred,
                                          const RowSrc (&src)[R],
                                          const int64_t (&r)[R],
                                          bool (&keep)[R], uint32_t *wt) {
    const int32_t *prog = nullptr, *leaf_off = nullptr, *col_ref = nullptr,
                  *leaves = nullptr;
    int n_instr = 0, last_ref = -1;
    bool live[R], unevaluable[R];
    uint64_t lt[R], lf[R];  // leaf i's (true, false) at bit i
    UNROLL for (int k = 0; k < R; ++k) {
        live[k] = r[k] < a.n_rows;
        unevaluable[k] = false;
        lt[k] = lf[k] = 0;
    }
    if (FILTER) {
        n_instr = pred[0];
        prog = pred + 2 + pred[1];
        last_ref = prog[n_instr * PRED_STRIDE];
        leaf_off = prog + n_instr * PRED_STRIDE + 1;
        col_ref = leaf_off + a.n_cols + 1;
        leaves = col_ref + a.n_cols;
        UNROLL for (int k = 0; k < R; ++k) {
            if (live[k] &&
                (src[k].flag == 0 ||
                 (last_ref < 0 &&
                  !judge<STAGED>(a, desc, prog, n_instr, lt[k], lf[k],
                                 src[k].row, src[k].lens, src[k].flag,
                                 unevaluable[k])))) {
                if (!COMPACT) zero_words(a, r[k]);
                live[k] = false;
            }
        }
    }
    // words [0, cw) are stored; cur accumulates word cw, nxt word cw + 1
    int cw = 0;
    uint32_t cur[R], nxt[R];
    UNROLL for (int k = 0; k < R; ++k) cur[k] = nxt[k] = 0;
    for (int j = 0; j < a.n_cols; ++j) {
        bool any = false;
        UNROLL for (int k = 0; k < R; ++k) any = any || live[k];
        if (FILTER && !any) break;  // every row dropped: all zeros already
        const int32_t *d = desc + j * DESC_STRIDE;
        I4 hd = load_i4(d);  // kind, width, offset, slots
        Field f[R];
        int len[R];
        Comps c[R];
        bool ok[R];
        UNROLL for (int k = 0; k < R; ++k) {
            f[k] = field_of(src[k].row, hd, a.nibble, STAGED);
            len[k] = field_len(src[k].lens, a.lengths_u8, j);
        }
        parse_columns<R>(hd.x, f, len, c, ok);
        if (FILTER && col_ref[j]) {
            UNROLL for (int k = 0; k < R; ++k)
                unevaluable[k] = unevaluable[k] || (len[k] != 0 && !ok[k]);
            for (int q = leaf_off[j]; q < leaf_off[j + 1]; ++q) {
                int i = leaves[q];
                if (i >= LEAF_BITS) continue;
                const int32_t *ins = prog + i * PRED_STRIDE;
                UNROLL for (int k = 0; k < R; ++k) {
                    bool res = cmp_leaf(hd.x, c[k], ins);
                    lt[k] |= (uint64_t)(len[k] != 0 && res) << i;
                    lf[k] |= (uint64_t)(len[k] != 0 && !res) << i;
                }
            }
        }
        for (int s = 0; s < hd.w; ++s) {
            // comp, bit offset, bits, zigzag
            I4 sl = load_i4(d + DESC_SLOT0 + 4 * s);
            int w = sl.y >> 5, sh = sl.y & 31;
            while (cw < w) {
                UNROLL for (int k = 0; k < R; ++k) {
                    if (live[k]) put_word<COMPACT>(a, wt, cw, r[k], cur[k]);
                    cur[k] = nxt[k];
                    nxt[k] = 0;
                }
                ++cw;
            }
            UNROLL for (int k = 0; k < R; ++k) {
                uint32_t v =
                    sl.x == COMP_OK ? (uint32_t)ok[k] : comp_at(c[k], sl.x);
                if (sl.w) v = (v << 1) ^ (uint32_t)((int32_t)v >> 31);
                if (sl.z < 32) v &= (1u << sl.z) - 1u;
                cur[k] |= v << sh;
                if (sh + sl.z > 32) nxt[k] |= v >> (32 - sh);
            }
        }
        if (FILTER && j == last_ref) {
            UNROLL for (int k = 0; k < R; ++k) {
                if (live[k] &&
                    !judge<STAGED>(a, desc, prog, n_instr, lt[k], lf[k],
                                   src[k].row, src[k].lens, src[k].flag,
                                   unevaluable[k])) {
                    // the words stored so far too
                    if (!COMPACT) zero_words(a, r[k]);
                    live[k] = false;
                }
            }
        }
    }
    while (cw < a.n_words) {
        UNROLL for (int k = 0; k < R; ++k) {
            if (live[k]) put_word<COMPACT>(a, wt, cw, r[k], cur[k]);
            cur[k] = nxt[k];
            nxt[k] = 0;
        }
        ++cw;
    }
    UNROLL for (int k = 0; k < R; ++k) keep[k] = live[k];
}

template <bool STAGED, bool FILTER>
__device__ __forceinline__ RowSrc row_src(const Job &a, const Layout &L,
                                          const uint8_t *smem, int lr,
                                          int64_t r) {
    int64_t lrow = (int64_t)a.n_cols * (a.lengths_u8 ? 1 : 4);
    if (STAGED)
        return {smem + lr * tile_stride(a.row_bytes),
                smem + L.lens + lr * lrow,
                FILTER ? (int)smem[L.flags + lr] : 1};
    // a row past the batch reads the last row (its results go nowhere)
    int64_t rr = r < a.n_rows ? r : a.n_rows - 1;
    return {a.bmat + rr * a.row_bytes, a.lengths + rr * lrow,
            FILTER ? (int)a.flags[rr] : 1};
}

// A thread's R rows in a step of T rows from r0 (nt = T / R threads): lr
// and lr + nt, ..., so each warp's rows stay 32 consecutive rows.
template <bool STAGED, bool FILTER, int R>
__device__ __forceinline__ void thread_rows(const Job &a, const Layout &L,
                                            const uint8_t *smem, int64_t r0,
                                            int tid, int nt, RowSrc (&src)[R],
                                            int64_t (&r)[R]) {
    UNROLL for (int k = 0; k < R; ++k) {
        int lr = tid + k * nt;
        r[k] = r0 + lr;
        src[k] = row_src<STAGED, FILTER>(a, L, smem, lr, r[k]);
    }
}

// Survivor counts of the blocks before `b` (*pre) and of all blocks
// (*tot), over the indices start, start + step, ...: each thread of a
// compaction block sums its share, the block reduces.
__device__ void count_sums(const int32_t *counts, int64_t n_blocks,
                           int64_t b, int start, int step, int64_t *pre,
                           int64_t *tot) {
    int64_t p = 0, t = 0;
    for (int64_t i = start; i < n_blocks; i += step) {
        int32_t c = counts[i];
        t += c;
        if (i < b) p += c;
    }
    *pre = p;
    *tot = t;
}

// The compaction of row r of block offset `off`: a kept row moves to
// off + its rank among the kept rows of its block; rows at or after the
// total are zero.
__device__ void compact_row(const uint32_t *__restrict__ words,
                            const uint32_t *__restrict__ mask,
                            uint32_t *__restrict__ out, int64_t n_rows,
                            int n_words, int64_t off, int64_t total,
                            int64_t r) {
    int64_t wr = r >> 5;
    uint32_t m = mask[wr];
    if ((m >> (r & 31)) & 1u) {
        int64_t rank = POPC(m & ((1u << (r & 31)) - 1u));
        for (int64_t w = (r / FILTER_BLOCK) * (FILTER_BLOCK / 32); w < wr; ++w)
            rank += POPC(mask[w]);
        int64_t dest = off + rank;
        for (int w = 0; w < n_words; ++w)
            out[(int64_t)w * n_rows + dest] = words[(int64_t)w * n_rows + r];
    }
    if (r >= total)
        for (int w = 0; w < n_words; ++w) out[(int64_t)w * n_rows + r] = 0;
}

// ---------------------------------------------------------------------------
// K2c's single-pass compaction: status words and the decoupled look-back
// ---------------------------------------------------------------------------

// A logical block's status word: bits 63-34 the launch epoch, 33-32 the
// flag, 31-0 the value. A word whose epoch is not this launch's was left
// by an earlier launch (or is the zero of a new buffer): not yet published.
constexpr uint32_t ST_AGG = 1;   // value: the block's own survivor count
constexpr uint32_t ST_INCL = 2;  // value: survivors up to and including it
constexpr int EPOCH_SHIFT = 34;
constexpr int LOOKBACK = 32;     // predecessors a look-back warp reads at once

__device__ __forceinline__ uint64_t make_status(uint32_t epoch, uint32_t flag,
                                                uint32_t value) {
    return (uint64_t)epoch << EPOCH_SHIFT | (uint64_t)flag << 32 | value;
}

__device__ __forceinline__ bool status_current(uint64_t s, uint32_t epoch) {
    return (uint32_t)(s >> EPOCH_SHIFT) == epoch;
}

__device__ __forceinline__ uint32_t status_flag(uint64_t s) {
    return (uint32_t)(s >> 32) & 3u;
}

__device__ __forceinline__ uint32_t status_value(uint64_t s) {
    return (uint32_t)s;
}

// Publish a status word (release: what the block wrote before is visible
// to whoever acquires the word), and read one (acquire).
__device__ __forceinline__ void status_store(uint64_t *p, uint64_t v) {
#ifdef __CUDACC__
    asm volatile("st.release.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v)
                 : "memory");
#else
    *p = v;
#endif
}

__device__ __forceinline__ uint64_t status_load(const uint64_t *p) {
#ifdef __CUDACC__
    uint64_t v;
    asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n"
                 : "=l"(v)
                 : "l"(p)
                 : "memory");
    return v;
#else
    return *p;
#endif
}

// The status a look-back lane reads in the window of LOOKBACK
// predecessors below logical block `hi`: block hi - 1 - lane; before block
// 0, an inclusive prefix of 0.
__device__ __forceinline__ uint64_t window_status(const Job &a, int64_t hi,
                                                  int lane) {
    int64_t p = hi - 1 - lane;
    return p < 0 ? make_status(a.epoch, ST_INCL, 0) : status_load(a.status + p);
}

// Whether a window sums lane's status: no inclusive prefix at a lower lane
// (a nearer predecessor); `incl` holds the window's inclusive lanes.
__device__ __forceinline__ bool lane_taken(uint32_t incl, int lane) {
    return (incl & ((1u << lane) - 1u)) == 0;
}

// Rank of block row i among the block's survivors: the survivors of the
// warps before its warp plus those below it in its warp's ballot.
__device__ __forceinline__ int block_rank(const uint32_t *ballots, int i) {
    int rank = POPC(ballots[i >> 5] & ((1u << (i & 31)) - 1u));
    for (int w = 0; w < (i >> 5); ++w) rank += POPC(ballots[w]);
    return rank;
}

// Block row i, if kept, from the word tile to its final place pre + rank
// in every output word.
__device__ __forceinline__ void scatter_row(const Job &a, const uint32_t *wt,
                                            const uint32_t *ballots,
                                            int64_t pre, int i) {
    if (!((ballots[i >> 5] >> (i & 31)) & 1u)) return;
    int64_t dest = pre + block_rank(ballots, i);
    for (int w = 0; w < a.n_words; ++w)
        a.words[(int64_t)w * a.n_rows + dest] = wt[w * FILTER_BLOCK + i];
}

// After the look-back: publish the inclusive prefix; the last block also
// writes the batch's survivor count.
__device__ __forceinline__ void publish_inclusive(const Job &a, int64_t blk,
                                                  int64_t pre, int count) {
    status_store(a.status + blk,
                 make_status(a.epoch, ST_INCL, (uint32_t)(pre + count)));
    if (blk == (a.n_rows - 1) / FILTER_BLOCK) a.counts[0] = (int32_t)(pre + count);
}

#ifdef __CUDACC__
// The FILTER_BLOCK rows of logical block `blk`, walked in steps of
// T = R * blockDim.x rows, R rows a thread. K2 writes the block's count;
// COMPACT (K2c) keeps the words in the word tile `wt` and each warp's
// ballot in `ballots`. Returns the block's survivors (FILTER).
template <bool STAGED, bool FILTER, bool COMPACT, int R>
__device__ __forceinline__ int walk_block(const Job &a, uint8_t *smem,
                                          int64_t blk, uint32_t *wt,
                                          uint32_t *ballots) {
    const int nt = blockDim.x, T = R * nt, tid = threadIdx.x;
    Layout L = tile_layout(a.row_bytes, a.n_cols, a.lengths_u8, FILTER,
                           a.pred_ints, T, 0);
    const int32_t *desc = a.desc, *pred = a.pred;
    if (STAGED) {
        stage_tables(a, L, smem, FILTER, tid, nt);
        desc = (const int32_t *)(smem + L.desc);
        pred = (const int32_t *)(smem + L.pred);
    }
    int count = 0;
    for (int s = 0; s < FILTER_BLOCK; s += T) {
        int64_t r0 = blk * FILTER_BLOCK + s;
        if (r0 >= a.n_rows) break;  // the same for the whole block
        if (STAGED) {
            stage_step(a, L, smem, FILTER, r0, T, tid, nt);
            cp_async_wait();
            __syncthreads();
        }
        RowSrc src[R];
        int64_t r[R];
        bool keep[R];
        thread_rows<STAGED, FILTER, R>(a, L, smem, r0, tid, nt, src, r);
        rows_body<FILTER, STAGED, COMPACT, R>(a, desc, pred, src, r, keep,
                                              wt);
        if (FILTER) {
            UNROLL for (int k = 0; k < R; ++k) {
                uint32_t ballot = __ballot_sync(0xFFFFFFFFu, keep[k]);
                if ((tid & 31) == 0 && r[k] < a.n_rows) {
                    a.mask[r[k] >> 5] = ballot;
                    if (COMPACT) ballots[(r[k] % FILTER_BLOCK) >> 5] = ballot;
                }
                count += __syncthreads_count(keep[k]);  // guards the tile
            }
        } else if (STAGED && s + T < FILTER_BLOCK) {
            __syncthreads();  // the next step overwrites the tile
        }
    }
    if (FILTER && !COMPACT && tid == 0) a.block_counts[blk] = count;
    return count;
}

// K1, R rows a thread (2 for the integer layouts of the loop-free parse,
// where the two rows' chains interleave; 1 for every other layout, whose
// longer parses would lose more to the registers than they gain).
template <int R>
__global__ void decode_pack_kernel(Job a, int staged) {
    extern __shared__ __align__(16) uint8_t smem[];
    if (staged)
        walk_block<true, false, false, R>(a, smem, blockIdx.x, nullptr,
                                          nullptr);
    else
        walk_block<false, false, false, R>(a, smem, blockIdx.x, nullptr,
                                           nullptr);
}

// K2, one row a thread.
__global__ void filter_pack_kernel(Job a, int staged) {
    extern __shared__ __align__(16) uint8_t smem[];
    if (staged)
        walk_block<true, true, false, 1>(a, smem, blockIdx.x, nullptr,
                                         nullptr);
    else
        walk_block<false, true, false, 1>(a, smem, blockIdx.x, nullptr,
                                          nullptr);
}

__device__ __forceinline__ int64_t warp_sum(int64_t v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, o);
    return v;
}

// The decoupled look-back of logical block blk > 0 by one warp, after
// the block has published its count as AGGREGATE: the survivors of the
// blocks before it. The warp reads LOOKBACK predecessors at once, spins
// until each has published in this launch, and sums them back to the
// nearest inclusive prefix (summing whole windows of aggregates until one
// holds it). Result in lane 0.
__device__ int64_t look_back(const Job &a, int64_t blk) {
    const int lane = threadIdx.x & 31;
    int64_t pre = 0;
    for (int64_t hi = blk;; hi -= LOOKBACK) {
        uint64_t s;
        do {
            s = window_status(a, hi, lane);
        } while (!__all_sync(0xFFFFFFFFu, status_current(s, a.epoch)));
        uint32_t incl = __ballot_sync(0xFFFFFFFFu, status_flag(s) == ST_INCL);
        pre += warp_sum(lane_taken(incl, lane) ? (int64_t)status_value(s) : 0);
        if (incl) return pre;
    }
}

// K2c: K2's walk with the compaction folded in, R rows a thread. The
// block's logical index is its ticket (a block waits only on blocks that
// started before it, so the look-back cannot deadlock however many blocks
// the grid has). Its words stay in the word tile; after the walk it
// publishes its count, warp 0 looks back for the survivors before it and
// publishes the inclusive prefix, and every thread moves its kept rows
// from the tile to their place: a warp's kept rows land on consecutive
// columns. Columns at or past the survivor count are not written.
template <int R>
__device__ __forceinline__ void compact_block(const Job &a, bool staged) {
    extern __shared__ __align__(16) uint8_t smem[];
    __shared__ uint32_t ballots[FILTER_BLOCK / 32];
    __shared__ int64_t s_blk, s_pre;
    const int tid = threadIdx.x;
    if (tid < FILTER_BLOCK / 32) ballots[tid] = 0;  // steps past the batch
    if (tid == 0)
        s_blk = (int64_t)(atomicAdd(a.ticket, 1ull) - a.ticket_base);
    __syncthreads();
    const int64_t blk = s_blk;
    Layout L = tile_layout(a.row_bytes, a.n_cols, a.lengths_u8, true,
                           a.pred_ints, staged ? R * (int)blockDim.x : 0,
                           a.n_words);
    uint32_t *wt = (uint32_t *)(smem + L.words);
    int count = staged ? walk_block<true, true, true, R>(a, smem, blk, wt,
                                                         ballots)
                       : walk_block<false, true, true, R>(a, smem, blk, wt,
                                                          ballots);
    if (tid < 32) {
        int64_t pre = 0;
        if (blk > 0) {
            if (tid == 0)
                status_store(a.status + blk,
                             make_status(a.epoch, ST_AGG, (uint32_t)count));
            pre = look_back(a, blk);
        }
        if (tid == 0) {
            publish_inclusive(a, blk, pre, count);
            s_pre = pre;
        }
    }
    __syncthreads();
    for (int i = tid; i < FILTER_BLOCK; i += blockDim.x)
        scatter_row(a, wt, ballots, s_pre, i);
}

// K2c, one row a thread: sub-tiles and direct.
__global__ void filter_pack_compact_kernel(Job a, int staged) {
    compact_block<1>(a, staged != 0);
}

// K2c on 256-row tiles, two rows a thread (128 threads) and at most 64
// registers, so that 8 blocks fit an SM: the main path's 1,024 blocks are
// then all resident at once, and no look-back waits for a block of a
// later wave to start, walk and publish.
__global__ void __launch_bounds__(FILTER_BLOCK / 2, 8)
    filter_pack_compact2_kernel(Job a) {
    compact_block<2>(a, true);
}

__global__ void compact_kernel(const uint32_t *__restrict__ words,
                               const uint32_t *__restrict__ mask,
                               const int32_t *__restrict__ block_counts,
                               int64_t n_blocks, uint32_t *__restrict__ out,
                               int32_t *__restrict__ counts, int64_t n_rows,
                               int n_words) {
    __shared__ int64_t s_pre[FILTER_BLOCK / 32], s_tot[FILTER_BLOCK / 32];
    int64_t pre, tot;
    count_sums(block_counts, n_blocks, blockIdx.x, threadIdx.x, FILTER_BLOCK,
               &pre, &tot);
    pre = warp_sum(pre);
    tot = warp_sum(tot);
    int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
        s_pre[warp] = pre;
        s_tot[warp] = tot;
    }
    __syncthreads();
    pre = tot = 0;
    for (int w = 0; w < FILTER_BLOCK / 32; ++w) {
        pre += s_pre[w];
        tot += s_tot[w];
    }
    if (blockIdx.x == 0 && threadIdx.x == 0) counts[0] = (int32_t)tot;
    int64_t r = (int64_t)blockIdx.x * FILTER_BLOCK + threadIdx.x;
    if (r < n_rows)
        compact_row(words, mask, out, n_rows, n_words, pre, tot, r);
}

// Launch K1 or K2 with tiles of `tile_rows` rows (256, 128, 64 or 32,
// a multiple of 32 * rpt), or direct (tile_rows 0: no tile); rpt rows a
// thread (K1: 1 or 2; K2: 1).
int launch(bool filter, const Job &a, int tile_rows, int rpt, void *stream) {
    if (a.n_rows <= 0) return 0;
    int64_t blocks = (a.n_rows + FILTER_BLOCK - 1) / FILTER_BLOCK;
    int rows = tile_rows > 0 ? tile_rows : FILTER_BLOCK;
    if (FILTER_BLOCK % rows != 0 || (rpt != 1 && (filter || rpt != 2)) ||
        rows % (32 * rpt) != 0)
        return (int)cudaErrorInvalidValue;
    int threads = rows / rpt;
    int64_t smem = tile_rows > 0
                       ? tile_layout(a.row_bytes, a.n_cols, a.lengths_u8,
                                     filter, a.pred_ints, tile_rows, 0).total
                       : 0;
    const void *fn = filter ? (const void *)filter_pack_kernel
                     : rpt == 2 ? (const void *)decode_pack_kernel<2>
                                : (const void *)decode_pack_kernel<1>;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    int staged = tile_rows > 0;
    if (filter)
        filter_pack_kernel<<<(unsigned)blocks, threads, (size_t)smem,
                             (cudaStream_t)stream>>>(a, staged);
    else if (rpt == 2)
        decode_pack_kernel<2><<<(unsigned)blocks, threads, (size_t)smem,
                                (cudaStream_t)stream>>>(a, staged);
    else
        decode_pack_kernel<1><<<(unsigned)blocks, threads, (size_t)smem,
                                (cudaStream_t)stream>>>(a, staged);
    return (int)cudaGetLastError();
}

// Launch K2c with tiles of `tile_rows` rows (256, 128, 64 or 32), or
// direct (0): the word tile alone in shared memory; rpt rows a thread (1,
// or 2 with 256-row tiles).
int launch_compact(const Job &a, int tile_rows, int rpt, void *stream) {
    if (a.n_rows <= 0) return 0;
    int64_t blocks = (a.n_rows + FILTER_BLOCK - 1) / FILTER_BLOCK;
    int rows = tile_rows > 0 ? tile_rows : FILTER_BLOCK;
    if (FILTER_BLOCK % rows != 0 || rows % 32 != 0 ||
        (rpt != 1 && (rpt != 2 || tile_rows != FILTER_BLOCK)))
        return (int)cudaErrorInvalidValue;
    int64_t smem = tile_layout(a.row_bytes, a.n_cols, a.lengths_u8, true,
                               a.pred_ints, tile_rows, a.n_words).total;
    const void *fn = rpt == 2 ? (const void *)filter_pack_compact2_kernel
                              : (const void *)filter_pack_compact_kernel;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    if (rpt == 2)
        filter_pack_compact2_kernel<<<(unsigned)blocks, FILTER_BLOCK / 2,
                                      (size_t)smem, (cudaStream_t)stream>>>(a);
    else
        filter_pack_compact_kernel<<<(unsigned)blocks, rows, (size_t)smem,
                                     (cudaStream_t)stream>>>(a,
                                                             tile_rows > 0);
    return (int)cudaGetLastError();
}
#else
// The walk of logical block b on the host: loops in place of threads,
// split at the places where the card's block synchronises, over a tile
// `smem` laid out by L (tile_rows 0: direct). keep[] holds the step's
// keep bits. COMPACT keeps the words in `wt` and the warps' ballots in
// `ballots`, as K2c does. Returns the block's survivors (FILTER).
template <bool FILTER, bool COMPACT, int R>
int32_t walk_host_block(const Job &a, int tile_rows, const Layout &L,
                        uint8_t *smem, bool *keep, int64_t b, uint32_t *wt,
                        uint32_t *ballots) {
    int T = tile_rows > 0 ? tile_rows : FILTER_BLOCK, nt = T / R;
    const int32_t *desc = a.desc, *pred = a.pred;
    if (tile_rows > 0) {
        for (int tid = 0; tid < nt; ++tid)
            stage_tables(a, L, smem, FILTER, tid, nt);
        desc = (const int32_t *)(smem + L.desc);
        pred = (const int32_t *)(smem + L.pred);
    }
    int32_t count = 0;
    for (int s = 0; s < FILTER_BLOCK; s += T) {
        int64_t r0 = b * FILTER_BLOCK + s;
        if (r0 >= a.n_rows) break;
        if (tile_rows > 0)
            for (int tid = 0; tid < nt; ++tid)
                stage_step(a, L, smem, FILTER, r0, T, tid, nt);
        for (int tid = 0; tid < nt; ++tid) {
            RowSrc src[R];
            int64_t r[R];
            bool kept[R];
            if (tile_rows > 0) {
                thread_rows<true, FILTER, R>(a, L, smem, r0, tid, nt, src, r);
                rows_body<FILTER, true, COMPACT, R>(a, desc, pred, src, r,
                                                    kept, wt);
            } else {
                thread_rows<false, FILTER, R>(a, L, smem, r0, tid, nt, src,
                                              r);
                rows_body<FILTER, false, COMPACT, R>(a, desc, pred, src, r,
                                                     kept, wt);
            }
            for (int k = 0; k < R; ++k) keep[tid + k * nt] = kept[k];
        }
        if (!FILTER) continue;
        for (int g = 0; g < T; g += 32) {  // each warp's ballot
            uint32_t ballot = 0;
            for (int lane = 0; lane < 32; ++lane)
                ballot |= (uint32_t)keep[g + lane] << lane;
            if (r0 + g < a.n_rows) {
                a.mask[(r0 + g) >> 5] = ballot;
                if (COMPACT) ballots[(s + g) >> 5] = ballot;
            }
            count += POPC(ballot);
        }
    }
    return count;
}

// Tile and keep buffers of a host walk with tiles of `tile_rows` rows.
struct HostTile {
    Layout L;
    uint8_t *smem = nullptr;
    bool *keep;

    HostTile(const Job &a, bool filter, int tile_rows) {
        int T = tile_rows > 0 ? tile_rows : FILTER_BLOCK;
        L = tile_layout(a.row_bytes, a.n_cols, a.lengths_u8, filter,
                        a.pred_ints, T, 0);
        if (tile_rows > 0) {
            smem = (uint8_t *)aligned_alloc(16,
                                            (size_t)((L.total + 15) & ~15));
            memset(smem, 0xA5, (size_t)L.total);  // no stale zeros to lean on
        }
        keep = new bool[T];  // keep of local row lr
    }
    ~HostTile() {
        delete[] keep;
        free(smem);
    }
};

// K1 or K2 on the host, block after block.
template <bool FILTER, int R>
void walk_host(const Job &a, int tile_rows) {
    int64_t blocks = (a.n_rows + FILTER_BLOCK - 1) / FILTER_BLOCK;
    HostTile t(a, FILTER, tile_rows);
    for (int64_t b = 0; b < blocks; ++b) {
        int32_t count = walk_host_block<FILTER, false, R>(
            a, tile_rows, t.L, t.smem, t.keep, b, nullptr, nullptr);
        if (FILTER) a.block_counts[b] = count;
    }
}

// The host's look-back of logical block blk > 0 (the warp's lanes as a
// loop): false where a predecessor in a window has not published in this
// launch, where the card's warp would spin; the host comes back later.
bool look_back_host(const Job &a, int64_t blk, int64_t *pre) {
    int64_t sum = 0;
    for (int64_t hi = blk;; hi -= LOOKBACK) {
        uint64_t s[LOOKBACK];
        uint32_t incl = 0;
        for (int lane = 0; lane < LOOKBACK; ++lane) {
            s[lane] = window_status(a, hi, lane);
            if (!status_current(s[lane], a.epoch)) return false;
            incl |= (uint32_t)(status_flag(s[lane]) == ST_INCL) << lane;
        }
        for (int lane = 0; lane < LOOKBACK; ++lane)
            if (lane_taken(incl, lane)) sum += status_value(s[lane]);
        if (incl) break;
    }
    *pre = sum;
    return true;
}

// A seeded shuffle of 0..n-1 (splitmix64 draws, Fisher-Yates).
void shuffle(int64_t *order, int64_t n, uint64_t &state) {
    for (int64_t i = 0; i < n; ++i) order[i] = i;
    for (int64_t i = n - 1; i > 0; --i) {
        uint64_t z = (state += 0x9E3779B97F4A7C15ull);
        z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
        z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
        z ^= z >> 31;
        int64_t j = (int64_t)(z % (uint64_t)(i + 1));
        int64_t t = order[i];
        order[i] = order[j];
        order[j] = t;
    }
}

// K2c on the host, in the card's phases with the blocks' progress
// interleaved by a seeded order: every block takes its ticket; in one
// shuffled order each block walks, publishes its count (block 0 its
// inclusive prefix) and tries its look-back, which stops where a
// predecessor has not published in this launch (a status word of an
// earlier launch, or none); in another shuffled order the blocks whose
// look-back stopped run it again, meeting predecessors that are only
// aggregates; then every block scatters its kept rows.
template <int R>
void compact_host(const Job &a, int tile_rows, uint64_t seed) {
    int64_t blocks = (a.n_rows + FILTER_BLOCK - 1) / FILTER_BLOCK;
    HostTile t(a, true, tile_rows);
    uint32_t *wt = new uint32_t[blocks * a.n_words * FILTER_BLOCK];
    memset(wt, 0xA5, sizeof(uint32_t) * blocks * a.n_words * FILTER_BLOCK);
    uint32_t *ballots = new uint32_t[blocks * (FILTER_BLOCK / 32)]();
    int32_t *count = new int32_t[blocks];
    int64_t *pre = new int64_t[blocks], *order = new int64_t[blocks];
    bool *done = new bool[blocks];
    int64_t *blk = new int64_t[blocks];
    for (int64_t b = 0; b < blocks; ++b)  // tickets, in start order
        blk[b] = (int64_t)((*a.ticket)++ - a.ticket_base);
    shuffle(order, blocks, seed);
    for (int64_t i = 0; i < blocks; ++i) {
        int64_t k = blk[order[i]];
        count[k] = walk_host_block<true, true, R>(
            a, tile_rows, t.L, t.smem, t.keep, k,
            wt + k * a.n_words * FILTER_BLOCK,
            ballots + k * (FILTER_BLOCK / 32));
        pre[k] = 0;
        if (k > 0)
            a.status[k] = make_status(a.epoch, ST_AGG, (uint32_t)count[k]);
        done[k] = k == 0 || look_back_host(a, k, &pre[k]);
        if (done[k]) publish_inclusive(a, k, pre[k], count[k]);
    }
    shuffle(order, blocks, seed);
    for (int64_t i = 0; i < blocks; ++i) {
        int64_t k = order[i];
        if (done[k]) continue;
        if (!look_back_host(a, k, &pre[k])) abort();  // all published
        publish_inclusive(a, k, pre[k], count[k]);
    }
    for (int64_t k = 0; k < blocks; ++k)
        for (int i = 0; i < FILTER_BLOCK; ++i)
            scatter_row(a, wt + k * a.n_words * FILTER_BLOCK,
                        ballots + k * (FILTER_BLOCK / 32), pre[k], i);
    delete[] wt;
    delete[] ballots;
    delete[] count;
    delete[] pre;
    delete[] order;
    delete[] done;
    delete[] blk;
}
#endif

}  // namespace

extern "C" {

// Bytes of dynamic shared memory a block with tiles of `tile_rows` rows
// (0: direct) and a word tile of `tile_words` words a row (K2c: n_words;
// K1, K2: 0) takes (ops/decode_kernel.py tile_bytes computes the same).
int64_t etl_tile_bytes(int64_t row_bytes, int n_cols, int lengths_u8,
                       int filter, int pred_ints, int tile_rows,
                       int tile_words) {
    return tile_layout(row_bytes, n_cols, lengths_u8, filter != 0, pred_ints,
                       tile_rows, tile_words).total;
}

int etl_filter_block_rows() { return FILTER_BLOCK; }

#ifdef __CUDACC__
// K1 on `stream`: out uint32[n_words, R]. Returns cudaGetLastError()
// (0 = launched).
int etl_decode_pack(const void *bmat, int64_t row_bytes, const void *lengths,
                    int lengths_u8, int n_cols, const void *desc, int nibble,
                    void *out, int64_t n_rows, int n_words, int tile_rows,
                    int rows_per_thread, void *stream) {
    Job a{(const uint8_t *)bmat, row_bytes, (const uint8_t *)lengths,
          lengths_u8, n_cols, (const int32_t *)desc, nibble, nullptr,
          nullptr, 0, (uint32_t *)out, nullptr, nullptr, n_rows, n_words};
    return launch(false, a, tile_rows, rows_per_thread, stream);
}

// K2 on `stream`: words uint32[n_words, R] (zeros on dropped rows),
// mask uint32[ceil(R / 32)], block_counts int32[ceil(R / FILTER_BLOCK)].
int etl_filter_pack(const void *bmat, int64_t row_bytes, const void *lengths,
                    int lengths_u8, int n_cols, const void *desc, int nibble,
                    const void *flags, const void *pred, int pred_ints,
                    void *words, void *mask, void *block_counts,
                    int64_t n_rows, int n_words, int tile_rows,
                    void *stream) {
    Job a{(const uint8_t *)bmat, row_bytes, (const uint8_t *)lengths,
          lengths_u8, n_cols, (const int32_t *)desc, nibble,
          (const uint8_t *)flags, (const int32_t *)pred, pred_ints,
          (uint32_t *)words, (uint32_t *)mask, (int32_t *)block_counts,
          n_rows, n_words};
    return launch(true, a, tile_rows, 1, stream);
}

// K2c on `stream`, rows_per_thread rows a thread (1, or 2 with 256-row
// tiles): out
// uint32[n_words, R] (the survivors' words in
// columns [0, count); later columns are not written), mask
// uint32[ceil(R / 32)], counts int32[1]. `status` holds a status word per
// block of this launch and `ticket` the ticket counter, which earlier
// launches on the same buffer advanced to `ticket_base`; `epoch` is
// this launch's (1 <= epoch < 2^30, never that of an earlier launch whose
// status words are still in the buffer).
int etl_filter_pack_compact(const void *bmat, int64_t row_bytes,
                            const void *lengths, int lengths_u8, int n_cols,
                            const void *desc, int nibble, const void *flags,
                            const void *pred, int pred_ints, void *out,
                            void *mask, void *counts, void *status,
                            void *ticket, uint64_t ticket_base,
                            uint32_t epoch, int64_t n_rows, int n_words,
                            int tile_rows, int rows_per_thread,
                            void *stream) {
    Job a{(const uint8_t *)bmat, row_bytes, (const uint8_t *)lengths,
          lengths_u8, n_cols, (const int32_t *)desc, nibble,
          (const uint8_t *)flags, (const int32_t *)pred, pred_ints,
          (uint32_t *)out, (uint32_t *)mask, nullptr, n_rows, n_words,
          (uint64_t *)status, (unsigned long long *)ticket, ticket_base,
          epoch, (int32_t *)counts};
    return launch_compact(a, tile_rows, rows_per_thread, stream);
}

// The compaction epilogue on `stream`: out uint32[n_words, R] (survivors
// first, zeros behind), counts int32[1].
int etl_compact_packed(const void *words, const void *mask,
                       const void *block_counts, void *out, void *counts,
                       int64_t n_rows, int n_words, void *stream) {
    if (n_rows <= 0) return 0;
    int64_t blocks = (n_rows + FILTER_BLOCK - 1) / FILTER_BLOCK;
    compact_kernel<<<(unsigned)blocks, FILTER_BLOCK, 0,
                     (cudaStream_t)stream>>>(
        (const uint32_t *)words, (const uint32_t *)mask,
        (const int32_t *)block_counts, blocks, (uint32_t *)out,
        (int32_t *)counts, n_rows, n_words);
    return (int)cudaGetLastError();
}

// Asynchronous strided copy (cudaMemcpy2DAsync, any direction): `height`
// rows of `width` bytes, `spitch` apart in `src`, `dpitch` in `dst`.
int etl_copy_2d(void *dst, int64_t dpitch, const void *src, int64_t spitch,
                int64_t width, int64_t height, void *stream) {
    if (width <= 0 || height <= 0) return 0;
    return (int)cudaMemcpy2DAsync(dst, (size_t)dpitch, src, (size_t)spitch,
                                  (size_t)width, (size_t)height,
                                  cudaMemcpyDefault, (cudaStream_t)stream);
}

const char *etl_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
#else
// K1 on the host, walking each block's rows as the card does with tiles
// of `tile_rows` rows (0: direct, from the arrays themselves) and
// rows_per_thread (1 or 2) rows a thread.
void etl_decode_pack_host(const void *bmat, int64_t row_bytes,
                          const void *lengths, int lengths_u8, int n_cols,
                          const void *desc, int nibble, void *out,
                          int64_t n_rows, int n_words, int tile_rows,
                          int rows_per_thread) {
    Job a{(const uint8_t *)bmat, row_bytes, (const uint8_t *)lengths,
          lengths_u8, n_cols, (const int32_t *)desc, nibble, nullptr,
          nullptr, 0, (uint32_t *)out, nullptr, nullptr, n_rows, n_words};
    if (rows_per_thread == 2)
        walk_host<false, 2>(a, tile_rows);
    else
        walk_host<false, 1>(a, tile_rows);
}

// K2 on the host: the same walk, with each warp's ballot and each block's
// count formed by loops.
void etl_filter_pack_host(const void *bmat, int64_t row_bytes,
                          const void *lengths, int lengths_u8, int n_cols,
                          const void *desc, int nibble, const void *flags,
                          const void *pred, int pred_ints, void *words,
                          void *mask, void *block_counts, int64_t n_rows,
                          int n_words, int tile_rows) {
    Job a{(const uint8_t *)bmat, row_bytes, (const uint8_t *)lengths,
          lengths_u8, n_cols, (const int32_t *)desc, nibble,
          (const uint8_t *)flags, (const int32_t *)pred, pred_ints,
          (uint32_t *)words, (uint32_t *)mask, (int32_t *)block_counts,
          n_rows, n_words};
    walk_host<true, 1>(a, tile_rows);
}

// K2c on the host (compact_host), with the same buffers and rows a
// thread as etl_filter_pack_compact; `seed` orders the blocks' progress.
void etl_filter_pack_compact_host(const void *bmat, int64_t row_bytes,
                                  const void *lengths, int lengths_u8,
                                  int n_cols, const void *desc, int nibble,
                                  const void *flags, const void *pred,
                                  int pred_ints, void *out, void *mask,
                                  void *counts, void *status, void *ticket,
                                  uint64_t ticket_base, uint32_t epoch,
                                  int64_t n_rows, int n_words, int tile_rows,
                                  int rows_per_thread, uint64_t seed) {
    Job a{(const uint8_t *)bmat, row_bytes, (const uint8_t *)lengths,
          lengths_u8, n_cols, (const int32_t *)desc, nibble,
          (const uint8_t *)flags, (const int32_t *)pred, pred_ints,
          (uint32_t *)out, (uint32_t *)mask, nullptr, n_rows, n_words,
          (uint64_t *)status, (unsigned long long *)ticket, ticket_base,
          epoch, (int32_t *)counts};
    if (n_rows <= 0) return;
    if (rows_per_thread == 2)
        compact_host<2>(a, tile_rows, seed);
    else
        compact_host<1>(a, tile_rows, seed);
}

// The compaction epilogue on the host: one "thread" per block does the
// block's count sums.
void etl_compact_packed_host(const void *words, const void *mask,
                             const void *block_counts, void *out,
                             void *counts, int64_t n_rows, int n_words) {
    int64_t blocks = (n_rows + FILTER_BLOCK - 1) / FILTER_BLOCK;
    for (int64_t b = 0; b < blocks; ++b) {
        int64_t pre, tot;
        count_sums((const int32_t *)block_counts, blocks, b, 0, 1, &pre,
                   &tot);
        if (b == 0) ((int32_t *)counts)[0] = (int32_t)tot;
        for (int64_t r = b * FILTER_BLOCK;
             r < (b + 1) * FILTER_BLOCK && r < n_rows; ++r)
            compact_row((const uint32_t *)words, (const uint32_t *)mask,
                        (uint32_t *)out, n_rows, n_words, pre, tot, r);
    }
}
#endif

}  // extern "C"
