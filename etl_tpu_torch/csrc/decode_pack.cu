// Parse-and-pack decode kernel for Hopper (sm_90a).
//
// Replaces the reference's Pallas kernel body `kernel`
// (etl_tpu/ops/pallas_kernel.py:114, K1) and its XLA twin
// `bitpack.parse_and_pack` (etl_tpu/ops/bitpack.py:271): for every dense
// column of a batch, parse the field text into int32 components plus an
// ok bit (semantics of etl_tpu/ops/parsers.py parse_column) and bit-pack
// them at the BitLayout offsets, zigzag on signed components
// (bitpack.pack_device). The words must equal the reference's bit for
// bit, including the values of rows that fail to parse.
//
// Design. The TPU kernel transposed its inputs to [W, R] so that every
// byte position filled a VPU lane vector. Here one thread owns one row:
// it reads the engine's row-major [R, ΣW] (or [R, ΣW/2] planar nibble)
// matrix and [R, C] lengths directly and runs a scalar parse per column,
// with early exits the lane form could not take. The specs, static under
// jit in the reference, are a column-descriptor table (see DESC_* below)
// that the wrapper uploads once per spec set. The output stays the
// reference's word-major uint32 [n_words, R]: thread r writes column r of
// each word, so the stores of a warp coalesce, and every word is written
// exactly once from a register accumulator (no zero fill needed).
//
// All packing is in uint32_t and the reference's wrapping int32 products
// (l1 * 1e9 + l0, ms = sec * 1000 + ...) are computed in uint32_t, where
// wrap-around is defined. C++ `/` and `%` truncate; they are applied here
// only to operands that are non-negative, where they equal jnp's floor
// division.
//
// Bound: bytes. Per row the kernel reads its packed field bytes and
// lengths once and writes n_words * 4 bytes; on the pgbench main path
// that is 262,144 x (12 + 3 + 8) B = 6.0 MB a batch, 1.8 us at the
// H100's 3.35 TB/s. The parse is a few hundred integer operations a row,
// far below the integer rate. This first version reads its bytes one at
// a time through L1 and does not stage through shared memory.
//
// Fused row filter (K2). Replaces `kernel_filtered`
// (etl_tpu/ops/pallas_kernel.py:118) and the XLA compaction epilogue
// `bitpack.compact_packed` (etl_tpu/ops/bitpack.py:212) with one shard:
//
// - filter_pack_kernel, one thread per row as above: it evaluates the
//   publication row filter, given as the flat postfix program of
//   ops/predicate.py (PRED_* below), parsing each leaf's column on demand
//   from the row's bytes; SQL's three-valued logic runs on two 32-bit
//   registers used as stacks of (is_true, is_false) bits. keep = live &
//   (true | force-keep | a referenced field that failed to parse). A kept
//   row packs its words as decode_row does; a dropped row writes zeros.
//   Blocks are FILTER_BLOCK rows, so each warp covers one aligned group of
//   32 rows: its __ballot_sync of keep IS that group's keep-mask word in
//   the reference's little bit order, and __syncthreads_count gives the
//   block's survivor count.
// - compact_kernel: each block sums the survivor counts of the blocks
//   before it (and of all blocks, the total) with a block reduction, so
//   no separate scan launch is needed. A kept row moves to its block's
//   offset plus the popcounts of the mask words before it in the block
//   plus __popc(mask & lanemask_lt); positions at or after the total are
//   zeroed, as compact_packed's zeros_like leaves them.
//
// Bound of the two, bytes: on the pgbench main path K2 reads 16 B a row
// (12 nibble bytes, 3 lengths, 1 flag) and writes 8 B of words plus 1/8 B
// of mask; the epilogue reads the survivors' words and the mask and
// writes 8 B a row. This first version keeps the unfiltered kernel's
// one-byte-at-a-time reads and re-parses a referenced column for each
// leaf that reads it.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC  (ops/decode_kernel.py)

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#else
// Host build of the same source (c++ -x c++), used by the CPU tests
// (tests/test_torch_kernel_host.py) to run the kernel's parse and pack
// code where there is no card: the device qualifiers vanish and
// etl_decode_pack_host walks the rows in a loop.
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

// column descriptor: DESC_STRIDE int32 per dense column
constexpr int DESC_KIND = 0;    // Kind
constexpr int DESC_WIDTH = 1;   // text width W of the field
constexpr int DESC_OFF = 2;     // byte offset of the field in a row of bmat
constexpr int DESC_NSLOTS = 3;  // packed slots of the column (ok first)
constexpr int DESC_SLOT0 = 4;   // then per slot: comp, bit_off, bits, zigzag
constexpr int MAX_SLOTS = 6;
constexpr int DESC_STRIDE = DESC_SLOT0 + 4 * MAX_SLOTS;
constexpr int COMP_OK = -1;     // slot comp index of the ok bit

__constant__ int32_t P10[9] = {1, 10, 100, 1000, 10000, 100000, 1000000,
                               10000000, 100000000};

__device__ __forceinline__ bool is_digit(int d) { return d >= 0 && d <= 9; }

// One field of one row: raw ASCII bytes or planar nibble pairs (byte k
// holds symbol k in the high nibble and symbol k + W/2 in the low one).
struct Field {
    const uint8_t *p;
    int w;
    bool nibble;

    __device__ __forceinline__ int at(int k) const {
        if (!nibble) return p[k];
        int half = w >> 1;
        int code = k < half ? (p[k] >> 4) : (p[k - half] & 0xF);
        if (code < 10) return '0' + code;
        switch (code) {
            case 10: return '-';
            case 11: return '+';
            case 12: return '.';
            case 13: return ':';
            case 14: return ' ';
            default: return 0;  // 15: padding
        }
    }
    // clamped read (jnp take_along_axis over clip(q, 0, W - 1))
    __device__ __forceinline__ int atc(int q) const {
        return at(q < 0 ? 0 : (q > w - 1 ? w - 1 : q));
    }
    __device__ __forceinline__ int fixed2(int k) const {
        return (at(k) - '0') * 10 + (at(k + 1) - '0');
    }
};

// parsers.parse_int: sign, three base-10^9 limbs, digit count, ok
__device__ bool parse_int(const Field &f, int len, bool *neg, int32_t *l,
                          int *ndigits) {
    int b0 = f.at(0);
    *neg = b0 == '-';
    int start = (*neg || b0 == '+') ? 1 : 0;
    l[0] = l[1] = l[2] = 0;
    bool all_digits = true;
    int hi = len < f.w ? len : f.w;
    for (int pos = start; pos < hi; ++pos) {
        int d = f.at(pos) - '0';
        if (!is_digit(d)) {
            all_digits = false;
            continue;
        }
        int r = len - 1 - pos;  // >= 0: pos < len
        int k = r / 9;
        if (k < 3) l[k] += d * P10[r % 9];
    }
    *ndigits = len - start;
    return all_digits && *ndigits >= 1 && *ndigits <= 27 && len <= f.w;
}

// parsers._int_range_ok
__device__ bool int_range_ok(int kind, bool neg, const int32_t *l, int nd) {
    if (kind == K_I16)
        return nd <= 5 && l[1] == 0 && l[2] == 0 &&
               ((neg && l[0] <= 32768) || (!neg && l[0] <= 32767));
    if (kind == K_I32)
        return nd <= 10 && l[2] == 0 &&
               (l[1] < 2 || (l[1] == 2 && ((neg && l[0] <= 147483648) ||
                                           (!neg && l[0] <= 147483647))));
    if (kind == K_U32)
        return nd <= 10 && l[2] == 0 && !neg &&
               (l[1] < 4 || (l[1] == 4 && l[0] <= 294967295));
    // K_I64: |min| = 9223372036854775808
    int hi = neg ? 1 : 0;
    bool at_cap = l[2] == 9 && (l[1] > 223372036 ||
                                (l[1] == 223372036 && l[0] > 854775807 + hi));
    return nd <= 19 && !(l[2] > 9 || at_cap);
}

// codec.text.days_from_civil for y >= 1, 1 <= m <= 12 (every operand of
// / is then non-negative)
__device__ int32_t days_from_civil(int y, int m, int d) {
    y -= m <= 2;
    int era = y / 400;
    int yoe = y - era * 400;
    int doy = (153 * (m + (m > 2 ? -3 : 9)) + 2) / 5 + d - 1;
    int doe = yoe * 365 + yoe / 4 - yoe / 100 + doy;
    return era * 146097 + doe - 719468;
}

// parsers.parse_date: 'YYYY-MM-DD' -> days (0 unless ok)
__device__ bool parse_date(const Field &f, int len, int32_t *days) {
    int d[10];
    for (int i = 0; i < 10; ++i) d[i] = f.at(i) - '0';
    int y = d[0] * 1000 + d[1] * 100 + d[2] * 10 + d[3];
    int m = d[5] * 10 + d[6];
    int dd = d[8] * 10 + d[9];
    bool digits_ok = is_digit(d[0]) && is_digit(d[1]) && is_digit(d[2]) &&
                     is_digit(d[3]) && is_digit(d[5]) && is_digit(d[6]) &&
                     is_digit(d[8]) && is_digit(d[9]);
    bool ok = len == 10 && digits_ok && f.at(4) == '-' && f.at(7) == '-' &&
              m >= 1 && m <= 12 && dd >= 1 && dd <= 31 && y >= 1;
    *days = ok ? days_from_civil(y, m, dd) : 0;
    return ok;
}

// parsers._parse_hms_at: HH:MM:SS[.ffffff] at column `base`
__device__ bool parse_hms(const Field &f, int len, int base, int32_t *sec,
                          int32_t *us, int *end) {
    int hh = f.fixed2(base), mm = f.fixed2(base + 3), ss = f.fixed2(base + 6);
    bool sep_ok = f.at(base + 2) == ':' && f.at(base + 5) == ':';
    bool digits_ok = true;
    const int dig_at[6] = {0, 1, 3, 4, 6, 7};
    for (int i = 0; i < 6; ++i)
        digits_ok = digits_ok && is_digit(f.at(base + dig_at[i]) - '0');
    bool has_dot = base + 8 < f.w && len > base + 8 && f.at(base + 8) == '.';
    // fractional digits: the run of digits starting at base + 9, max 6
    int run = 0;
    int32_t frac = 0;
    if (has_dot) {
        for (int k = 0; k < 6; ++k) {
            int pos = base + 9 + k;
            if (pos >= len || pos >= f.w) break;
            int d = f.at(pos) - '0';
            if (!is_digit(d)) break;
            frac += d * P10[5 - k];
            ++run;
        }
    }
    *us = frac;
    *end = base + 8 + (has_dot ? 1 + run : 0);
    *sec = (hh * 60 + mm) * 60 + ss;  // |hh| <= 2277: no overflow
    return sep_ok && digits_ok && (!has_dot || run >= 1) && hh <= 23 &&
           mm <= 59 && ss <= 59;
}

// parsers._parse_tz_at: ±HH[:MM[:SS]] at per-row position p
__device__ bool parse_tz(const Field &f, int len, int p, int32_t *off,
                         int *end) {
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
    *end = p + 3 + (has_min ? 3 : 0) + (has_sec ? 3 : 0);
    int o = hh * 3600 + mm * 60 + ss;
    *off = neg ? -o : o;
    return sign_ok && hh_ok && mm_ok && ss_ok && hh <= 15;
}

__device__ bool match_lit(const Field &f, int len, const char *lit, int n) {
    if (len != n || n > f.w) return false;
    for (int i = 0; i < n; ++i)
        if (f.at(i) != lit[i]) return false;
    return true;
}

// parsers.parse_float -> (neg, limb0, limb1, exp_adj, special), ok
__device__ bool parse_float(const Field &f, int len, int32_t *c) {
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
    c[0] = neg;
    c[1] = limb0;
    c[2] = limb1;
    c[3] = exp_adj;
    c[4] = special;
    return fast || special > 0;
}

// parsers.parse_column: components in COLUMN_COMPONENTS order, as the
// reference's int32 bit patterns
__device__ bool parse_column(int kind, const Field &f, int len, uint32_t *c) {
    switch (kind) {
        case K_BOOL: {
            int b0 = f.at(0);
            c[0] = b0 == 't';
            return len == 1 && (b0 == 't' || b0 == 'f');
        }
        case K_I16: case K_I32: case K_U32: case K_I64: {
            bool neg;
            int32_t l[3];
            int nd;
            bool ok = parse_int(f, len, &neg, l, &nd);
            ok = ok && int_range_ok(kind, neg, l, nd);
            if (kind == K_I64) {
                c[0] = neg;
                c[1] = l[0];
                c[2] = l[1];
                c[3] = l[2];
            } else {
                uint32_t v = (uint32_t)l[1] * 1000000000u + (uint32_t)l[0];
                c[0] = neg ? 0u - v : v;
            }
            return ok;
        }
        case K_F32: case K_F64: {
            int32_t v[5];
            bool ok = parse_float(f, len, v);
            for (int i = 0; i < 5; ++i) c[i] = (uint32_t)v[i];
            return ok;
        }
        case K_DATE: {
            int32_t days;
            bool ok = parse_date(f, len, &days);
            c[0] = (uint32_t)days;
            return ok;
        }
        case K_TIME: {
            int32_t sec, us;
            int end;
            bool ok = parse_hms(f, len, 0, &sec, &us, &end) && end == len;
            c[0] = (uint32_t)sec * 1000u + (uint32_t)(us / 1000);
            c[1] = (uint32_t)(us % 1000);
            return ok;
        }
        default: {  // K_TIMESTAMP, K_TIMESTAMPTZ
            int32_t days, sec, us, tz = 0;
            int end, tz_end;
            bool date_ok = parse_date(f, 10, &days);
            bool space_ok = f.at(10) == ' ';
            bool hms_ok = parse_hms(f, len, 11, &sec, &us, &end);
            bool ok;
            if (kind == K_TIMESTAMPTZ) {
                bool tz_ok = parse_tz(f, len, end, &tz, &tz_end);
                ok = date_ok && space_ok && hms_ok && tz_ok && tz_end == len;
            } else {
                ok = date_ok && space_ok && hms_ok && end == len;
            }
            uint32_t ms = (uint32_t)sec * 1000u + (uint32_t)(us / 1000);
            c[0] = (uint32_t)days;
            c[1] = ms - (uint32_t)tz * 1000u;
            c[2] = (uint32_t)(us % 1000);
            return ok && len >= 19;
        }
    }
}

// Length of field j of row r (u8 or int32 lengths [R, n_cols]).
__device__ __forceinline__ int field_len(const void *lengths, int lengths_u8,
                                         int n_cols, int64_t r, int j) {
    return lengths_u8 ? (int)((const uint8_t *)lengths)[r * n_cols + j]
                      : ((const int32_t *)lengths)[r * n_cols + j];
}

// Parse and pack row r: its column r of every output word.
__device__ void decode_row(const uint8_t *__restrict__ bmat, int64_t row_bytes,
                           const void *__restrict__ lengths, int lengths_u8,
                           int n_cols, const int32_t *__restrict__ desc,
                           int nibble, uint32_t *__restrict__ out,
                           int64_t n_rows, int n_words, int64_t r) {
    const uint8_t *row = bmat + r * row_bytes;
    // words [0, cw) are stored; cur accumulates word cw, nxt word cw + 1
    int cw = 0;
    uint32_t cur = 0, nxt = 0;
    for (int j = 0; j < n_cols; ++j) {
        const int32_t *d = desc + j * DESC_STRIDE;
        Field f{row + d[DESC_OFF], d[DESC_WIDTH], nibble != 0};
        int len = field_len(lengths, lengths_u8, n_cols, r, j);
        uint32_t comps[5];
        bool ok = parse_column(d[DESC_KIND], f, len, comps);
        int n_slots = d[DESC_NSLOTS];
        for (int s = 0; s < n_slots; ++s) {
            const int32_t *sl = d + DESC_SLOT0 + 4 * s;
            uint32_t v = sl[0] == COMP_OK ? (uint32_t)ok : comps[sl[0]];
            int bit_off = sl[1], bits = sl[2];
            if (sl[3]) v = (v << 1) ^ (uint32_t)((int32_t)v >> 31);
            if (bits < 32) v &= (1u << bits) - 1u;
            int w = bit_off >> 5, sh = bit_off & 31;
            while (cw < w) {
                out[(int64_t)cw * n_rows + r] = cur;
                cur = nxt;
                nxt = 0;
                ++cw;
            }
            cur |= v << sh;
            if (sh + bits > 32) nxt |= v >> (32 - sh);
        }
    }
    while (cw < n_words) {
        out[(int64_t)cw * n_rows + r] = cur;
        cur = nxt;
        nxt = 0;
        ++cw;
    }
}

// ---------------------------------------------------------------------------
// fused row filter (K2) and its compaction epilogue
// ---------------------------------------------------------------------------

// predicate descriptor: [n_instr, n_ref, n_ref referenced column slots,
// then n_instr instructions of PRED_STRIDE int32 each:
// (opcode, slot, cmp, negate, a, b, c, d)] — ops/predicate.py P_* / CMP_*
constexpr int PRED_CMP = 0, PRED_NULLTEST = 1, PRED_AND = 2, PRED_OR = 3,
              PRED_NOT = 4;
constexpr int CMP_EQ = 0, CMP_LT = 1, CMP_GT = 2, CMP_CONST = 3;
constexpr int PRED_STRIDE = 8;
constexpr int FILTER_BLOCK = 256;  // rows per block: whole 32-row warps

#ifdef __CUDACC__
#define POPC(x) __popc(x)
#else
#define POPC(x) __builtin_popcount(x)
#endif

__device__ __forceinline__ bool cmp3(int64_t v, int64_t lit, int cmp) {
    return cmp == CMP_EQ ? v == lit : (cmp == CMP_LT ? v < lit : v > lit);
}

// predicate._device_cmp on one row, against the host-folded literal words
// of instruction `ins`. Components are the reference's int32 bit patterns.
__device__ bool cmp_leaf(int kind, const uint32_t *c, const int32_t *ins) {
    int cmp = ins[2];
    bool res;
    if (cmp == CMP_CONST) {
        res = ins[4] != 0;
    } else if (kind == K_U32) {
        // sign-flipped int32 space orders as uint32 (literal pre-biased)
        res = cmp3((int32_t)(c[0] ^ 0x80000000u), ins[4], cmp);
    } else if (kind == K_I64) {
        bool neg = (int32_t)c[0] > 0;
        int32_t l0 = (int32_t)c[1], l1 = (int32_t)c[2], l2 = (int32_t)c[3];
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
        int32_t ms = (int32_t)c[0], us = (int32_t)c[1];
        bool eq = ms == ins[4] && us == ins[5];
        bool gt = ms > ins[4] || (ms == ins[4] && us > ins[5]);
        res = cmp == CMP_EQ ? eq : (cmp == CMP_GT ? gt : !gt && !eq);
    } else if (kind == K_TIMESTAMP || kind == K_TIMESTAMPTZ) {
        // the tz fold can push ms out of [0, 86_400_000): one borrow or
        // carry renormalises (|tz| < 1 day); int64 keeps garbage rows of
        // unparsed fields free of overflow
        const int64_t day_ms = 86400000;
        int64_t days = (int32_t)c[0], ms = (int32_t)c[1], us = (int32_t)c[2];
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
        res = cmp3((int32_t)c[0], ins[4], cmp);
    }
    return ins[3] ? !res : res;
}

// predicate.CompiledRowFilter.device_keep for row r. `flag`: 0 dead,
// 1 live, 2 live + force-keep.
__device__ bool row_keep(const uint8_t *row, const void *lengths,
                         int lengths_u8, int n_cols, const int32_t *desc,
                         int nibble, const int32_t *pred, int flag,
                         int64_t r) {
    if (flag == 0) return false;
    int n_instr = pred[0], n_ref = pred[1];
    const int32_t *prog = pred + 2 + n_ref;
    uint32_t ts = 0, fs = 0;  // Kleene stacks, bit 0 = top
    for (int i = 0; i < n_instr; ++i) {
        const int32_t *ins = prog + i * PRED_STRIDE;
        int op = ins[0];
        bool t, f;
        if (op == PRED_CMP || op == PRED_NULLTEST) {
            int j = ins[1];
            bool is_null = field_len(lengths, lengths_u8, n_cols, r, j) == 0;
            if (op == PRED_NULLTEST) {
                t = ins[3] ? !is_null : is_null;
                f = !t;
            } else {
                const int32_t *d = desc + j * DESC_STRIDE;
                Field fl{row + d[DESC_OFF], d[DESC_WIDTH], nibble != 0};
                uint32_t comps[5];
                parse_column(d[DESC_KIND], fl,
                             field_len(lengths, lengths_u8, n_cols, r, j),
                             comps);
                bool res = cmp_leaf(d[DESC_KIND], comps, ins);
                t = !is_null && res;
                f = !is_null && !res;
            }
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
    bool unevaluable = false;
    for (int k = 0; k < n_ref && !unevaluable; ++k) {
        int j = pred[2 + k];
        int len = field_len(lengths, lengths_u8, n_cols, r, j);
        const int32_t *d = desc + j * DESC_STRIDE;
        Field fl{row + d[DESC_OFF], d[DESC_WIDTH], nibble != 0};
        uint32_t comps[5];
        unevaluable = len != 0 && !parse_column(d[DESC_KIND], fl, len, comps);
    }
    return (ts & 1u) || flag > 1 || unevaluable;
}

// K2's body for one row: keep verdict, then the packed words (zeros for a
// dropped row, as the reference's words * keep).
__device__ bool filter_pack_row(const uint8_t *__restrict__ bmat,
                                int64_t row_bytes,
                                const void *__restrict__ lengths,
                                int lengths_u8, int n_cols,
                                const int32_t *__restrict__ desc, int nibble,
                                const uint8_t *__restrict__ flags,
                                const int32_t *__restrict__ pred,
                                uint32_t *__restrict__ words, int64_t n_rows,
                                int n_words, int64_t r) {
    bool keep = row_keep(bmat + r * row_bytes, lengths, lengths_u8, n_cols,
                         desc, nibble, pred, flags[r], r);
    if (keep) {
        decode_row(bmat, row_bytes, lengths, lengths_u8, n_cols, desc, nibble,
                   words, n_rows, n_words, r);
    } else {
        for (int w = 0; w < n_words; ++w) words[(int64_t)w * n_rows + r] = 0;
    }
    return keep;
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

#ifdef __CUDACC__
__global__ void filter_pack_kernel(const uint8_t *__restrict__ bmat,
                                   int64_t row_bytes,
                                   const void *__restrict__ lengths,
                                   int lengths_u8, int n_cols,
                                   const int32_t *__restrict__ desc,
                                   int nibble,
                                   const uint8_t *__restrict__ flags,
                                   const int32_t *__restrict__ pred,
                                   uint32_t *__restrict__ words,
                                   uint32_t *__restrict__ mask,
                                   int32_t *__restrict__ block_counts,
                                   int64_t n_rows, int n_words) {
    int64_t r = (int64_t)blockIdx.x * FILTER_BLOCK + threadIdx.x;
    bool keep = r < n_rows &&
                filter_pack_row(bmat, row_bytes, lengths, lengths_u8, n_cols,
                                desc, nibble, flags, pred, words, n_rows,
                                n_words, r);
    uint32_t ballot = __ballot_sync(0xFFFFFFFFu, keep);
    if ((threadIdx.x & 31) == 0 && r < n_rows) mask[r >> 5] = ballot;
    int count = __syncthreads_count(keep);
    if (threadIdx.x == 0) block_counts[blockIdx.x] = count;
}

__device__ __forceinline__ int64_t warp_sum(int64_t v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, o);
    return v;
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

__global__ void decode_pack_kernel(const uint8_t *__restrict__ bmat,
                                   int64_t row_bytes,
                                   const void *__restrict__ lengths,
                                   int lengths_u8, int n_cols,
                                   const int32_t *__restrict__ desc,
                                   int nibble, uint32_t *__restrict__ out,
                                   int64_t n_rows, int n_words) {
    int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (r < n_rows)
        decode_row(bmat, row_bytes, lengths, lengths_u8, n_cols, desc, nibble,
                   out, n_rows, n_words, r);
}
#endif

}  // namespace

extern "C" {

#ifdef __CUDACC__
// Launch on `stream`; returns cudaGetLastError() (0 = launched).
int etl_decode_pack(const void *bmat, int64_t row_bytes, const void *lengths,
                    int lengths_u8, int n_cols, const void *desc, int nibble,
                    void *out, int64_t n_rows, int n_words, void *stream) {
    if (n_rows <= 0) return 0;
    const int threads = 256;
    int64_t blocks = (n_rows + threads - 1) / threads;
    decode_pack_kernel<<<(unsigned)blocks, threads, 0,
                         (cudaStream_t)stream>>>(
        (const uint8_t *)bmat, row_bytes, lengths, lengths_u8, n_cols,
        (const int32_t *)desc, nibble, (uint32_t *)out, n_rows, n_words);
    return (int)cudaGetLastError();
}

// K2 on `stream`: words uint32[n_words, R] (zeros on dropped rows),
// mask uint32[ceil(R / 32)], block_counts int32[ceil(R / FILTER_BLOCK)].
int etl_filter_pack(const void *bmat, int64_t row_bytes, const void *lengths,
                    int lengths_u8, int n_cols, const void *desc, int nibble,
                    const void *flags, const void *pred, void *words,
                    void *mask, void *block_counts, int64_t n_rows,
                    int n_words, void *stream) {
    if (n_rows <= 0) return 0;
    int64_t blocks = (n_rows + FILTER_BLOCK - 1) / FILTER_BLOCK;
    filter_pack_kernel<<<(unsigned)blocks, FILTER_BLOCK, 0,
                         (cudaStream_t)stream>>>(
        (const uint8_t *)bmat, row_bytes, lengths, lengths_u8, n_cols,
        (const int32_t *)desc, nibble, (const uint8_t *)flags,
        (const int32_t *)pred, (uint32_t *)words, (uint32_t *)mask,
        (int32_t *)block_counts, n_rows, n_words);
    return (int)cudaGetLastError();
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

int etl_filter_block_rows() { return FILTER_BLOCK; }

const char *etl_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
#else
void etl_decode_pack_host(const void *bmat, int64_t row_bytes,
                          const void *lengths, int lengths_u8, int n_cols,
                          const void *desc, int nibble, void *out,
                          int64_t n_rows, int n_words) {
    for (int64_t r = 0; r < n_rows; ++r)
        decode_row((const uint8_t *)bmat, row_bytes, lengths, lengths_u8,
                   n_cols, (const int32_t *)desc, nibble, (uint32_t *)out,
                   n_rows, n_words, r);
}

// K2 on the host: the same per-row body, with each warp's ballot and each
// block's count formed by loops.
void etl_filter_pack_host(const void *bmat, int64_t row_bytes,
                          const void *lengths, int lengths_u8, int n_cols,
                          const void *desc, int nibble, const void *flags,
                          const void *pred, void *words, void *mask,
                          void *block_counts, int64_t n_rows, int n_words) {
    int64_t blocks = (n_rows + FILTER_BLOCK - 1) / FILTER_BLOCK;
    for (int64_t b = 0; b < blocks; ++b) {
        int32_t count = 0;
        for (int64_t g = b * FILTER_BLOCK; g < (b + 1) * FILTER_BLOCK;
             g += 32) {
            uint32_t ballot = 0;
            for (int lane = 0; lane < 32; ++lane) {
                int64_t r = g + lane;
                bool keep = r < n_rows &&
                            filter_pack_row(
                                (const uint8_t *)bmat, row_bytes, lengths,
                                lengths_u8, n_cols, (const int32_t *)desc,
                                nibble, (const uint8_t *)flags,
                                (const int32_t *)pred, (uint32_t *)words,
                                n_rows, n_words, r);
                ballot |= (uint32_t)keep << lane;
            }
            if (g < n_rows) ((uint32_t *)mask)[g >> 5] = ballot;
            count += POPC(ballot);
        }
        ((int32_t *)block_counts)[b] = count;
    }
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
