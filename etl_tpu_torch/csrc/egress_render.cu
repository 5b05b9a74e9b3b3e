// Egress render kernel for Hopper (sm_90a).
//
// egress_render_kernel replaces the reference's device egress program,
// `build_egress_program` (etl_tpu/ops/egress.py:340, an XLA program with
// no Pallas kernel): it turns the packed words a decode left on the card,
// uint32 [n_words, R] in the layout of ops/bitpack.py, into the wire text
// of each rendered column — left-aligned ASCII, zero-padded to the
// column's width, in ebytes uint8 [R, sum of widths], and the text's
// length in elens int32 [R, n_rendered]:
//   BOOL                 "true" / "false"
//   I16, I32, U32, I64   minimal decimal, the digits str(int) gives
//   DATE                 YYYY-MM-DD
//   TIMESTAMP(TZ)        YYYY-MM-DD HH:MM:SS.ffffff
// The bytes must equal the reference's program (and ops/egress.py
// render_plain) on EVERY row, including rows whose fields failed to parse
// and hold whatever their bits say, so that a comparison needs no mask.
//
// Bound: bytes. Per row the kernel reads the words that hold its rendered
// fields and writes its text and lengths once: on the pgbench main path
// (three INT4 columns, 2 words) 8 + 33 + 12 = 53 B a row, 13.9 MB for
// 262,144 rows, 4.1 us at 3.35 TB/s. The arithmetic is a few hundred
// integer operations a row (digit extraction by division by constants),
// a few microseconds of instructions over 132 SMs.
//
// Design (a first kernel, simple and right): one thread per row, looping
// over the plan's columns.
// - The plan arrives as a descriptor (ops/egress_kernel.py descriptor),
//   DESC_STRIDE int32 per rendered column: (kind, width, byte offset in a
//   row of ebytes, 0), then per component in RENDER_COMPONENTS order
//   (present, bit_off, bits, zigzag). A block stages it into shared memory
//   once, so nothing is compiled per plan.
// - Reads: thread r reads column r of each word, so a warp's loads
//   coalesce. Writes: each thread writes its row's text byte by byte into
//   a tile of the block's rows in shared memory; the block then stores
//   the tile, one contiguous range of ebytes that starts 16-byte aligned
//   (a block's rows are a multiple of 32), with 16-byte stores. The
//   lengths go straight to elens.
// - Digits are produced from the right by division by the constant 10
//   (a multiply and a shift), not by a power of ten picked per digit.
// - Arithmetic follows the reference's int32/uint32 program exactly. Its
//   `//` and `%` on int32 are FLOOR division and modulo, and the days of
//   an untrusted row, or a zone-shifted TIMESTAMPTZ ms, may be negative:
//   C++ `/` and `%` truncate, so every division that may see a negative
//   operand goes through floor_div/floor_mod below. Fields that straddle
//   two words OR in the next word shifted left with uint32 wrap-around.
//
// The same source compiles as host C++ (c++ -x c++, off __CUDACC__):
// etl_egress_render_host runs the row body for every row, so the CPU
// tests hold the kernel's arithmetic against the plain version.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC  (ops/egress_kernel.py)

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#else
#define __device__
#define __global__
#define __constant__
#define __forceinline__ inline
#define __restrict__
#endif

namespace {

// kind codes: ops/decode_kernel.py KIND_CODES
enum Kind {
    K_BOOL = 0, K_I16 = 1, K_I32 = 2, K_U32 = 3, K_I64 = 4, K_DATE = 7,
    K_TIMESTAMP = 9, K_TIMESTAMPTZ = 10,
};

constexpr int DESC_COMP0 = 4;   // ints before the first component
constexpr int MAX_COMPS = 4;    // I64: neg, l0, l1, l2
constexpr int DESC_STRIDE = DESC_COMP0 + 4 * MAX_COMPS;
constexpr int MAX_COLS = 32;    // ops/egress.py EGRESS_MAX_COLS
constexpr int BLOCK = 256;
constexpr int SMEM_LIMIT = 48 * 1024 - MAX_COLS * DESC_STRIDE * 4;

__constant__ uint32_t P10[10] = {1u, 10u, 100u, 1000u, 10000u, 100000u,
                                 1000000u, 10000000u, 100000000u,
                                 1000000000u};

// floor division and modulo by a positive divisor (jnp's // and %)
__device__ __forceinline__ int32_t floor_div(int32_t a, int32_t b) {
    int32_t q = a / b;
    return (a % b != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ int32_t floor_mod(int32_t a, int32_t b) {
    return a - floor_div(a, b) * b;
}

// raw bits of one component (desc: present, bit_off, bits, zigzag) of
// row r; 0 when the layout omitted it
__device__ __forceinline__ uint32_t extract(const uint32_t *__restrict__ words,
                                            int64_t R, int64_t r,
                                            const int32_t *c) {
    if (!c[0]) return 0u;
    int w = c[1] >> 5, sh = c[1] & 31, bits = c[2];
    uint32_t v = words[(int64_t)w * R + r] >> sh;
    if (sh + bits > 32) v |= words[(int64_t)(w + 1) * R + r] << (32 - sh);
    if (bits < 32) v &= (1u << bits) - 1u;
    return v;
}

// the decoded int32 value of a component (zigzag or plain)
__device__ __forceinline__ int32_t value(const uint32_t *__restrict__ words,
                                         int64_t R, int64_t r,
                                         const int32_t *c) {
    uint32_t raw = extract(words, R, r, c);
    if (c[3]) return (int32_t)(raw >> 1) ^ -(int32_t)(raw & 1u);
    return (int32_t)raw;
}

// minimal decimal of a uint32 magnitude with `neg` in {0, 1}: the
// reference's _render_u32_family + _digits_to_bytes. Its digit at byte p
// is (mag / 10^k) % 10 with k = L - 1 - p, and k never passes the
// digit count, so the digits are written from the right, each by a
// division by the constant 10
template <int MAX_DIGITS>
__device__ __forceinline__ int render_u32(uint8_t *out, uint32_t mag,
                                          int neg, int width) {
    int nd = 1;
#pragma unroll
    for (int k = 1; k < MAX_DIGITS; ++k) nd += mag >= P10[k];
    int L = nd + neg;
    for (int p = L; p < width; ++p) out[p] = 0;
    for (int p = L - 1; p >= neg; --p) {
        out[p] = (uint8_t)(48 + mag % 10u);
        mag /= 10u;
    }
    if (neg) out[0] = 45;  // '-'
    return L;
}

__device__ __forceinline__ int limb_digits(uint32_t limb) {
    int nd = 1;
#pragma unroll
    for (int k = 1; k < 9; ++k) nd += limb >= P10[k];
    return nd;
}

// minimal decimal of a base-10^9 limbed magnitude: _render_i64 (the pack
// layout bounds l2 <= 9, so digit 18 is l2 itself); digit k < 9 comes
// from l0, 9 <= k < 18 from l1, as the reference picks them
__device__ __forceinline__ int render_i64(uint8_t *out, int neg, uint32_t l0,
                                          uint32_t l1, uint32_t l2,
                                          int width) {
    int nd = l2 > 0 ? 19 : (l1 > 0 ? 9 + limb_digits(l1) : limb_digits(l0));
    int L = nd + neg;
    for (int p = L; p < width; ++p) out[p] = 0;
    for (int k = 0; k < nd; ++k) {
        uint32_t d;
        if (k < 9) {
            d = l0 % 10u;
            l0 /= 10u;
        } else if (k < 18) {
            d = l1 % 10u;
            l1 /= 10u;
        } else {
            d = l2 % 10u;
        }
        out[L - 1 - k] = (uint8_t)(48 + d);
    }
    if (neg) out[0] = 45;
    return L;
}

// Howard Hinnant's civil_from_days (_civil), in floor arithmetic
__device__ __forceinline__ void civil(int32_t days, int32_t *y, int32_t *m,
                                      int32_t *d) {
    int32_t z = days + 719468;
    int32_t era = floor_div(z, 146097);
    int32_t doe = z - era * 146097;
    int32_t yoe = floor_div(doe - floor_div(doe, 1460)
                            + floor_div(doe, 36524) - floor_div(doe, 146096),
                            365);
    int32_t yy = yoe + era * 400;
    int32_t doy = doe - (365 * yoe + floor_div(yoe, 4)
                         - floor_div(yoe, 100));
    int32_t mp = floor_div(5 * doy + 2, 153);
    *d = doy - floor_div(153 * mp + 2, 5) + 1;
    *m = mp + (mp < 10 ? 3 : -9);
    *y = yy + (*m <= 2 ? 1 : 0);
}

__device__ __forceinline__ uint8_t digit(int32_t x, int32_t p) {
    return (uint8_t)(48 + floor_mod(floor_div(x, p), 10));
}

// YYYY-MM-DD (_date_bytes)
__device__ __forceinline__ void date_bytes(uint8_t *out, int32_t y,
                                           int32_t m, int32_t d) {
    out[0] = digit(y, 1000);
    out[1] = digit(y, 100);
    out[2] = digit(y, 10);
    out[3] = digit(y, 1);
    out[4] = 45;
    out[5] = digit(m, 10);
    out[6] = digit(m, 1);
    out[7] = 45;
    out[8] = digit(d, 10);
    out[9] = digit(d, 1);
}

// YYYY-MM-DD HH:MM:SS.ffffff (_render_timestamp): a zone-shifted ms is
// floored into [0, 86,400,000) and the whole days carried first
__device__ __forceinline__ void timestamp_bytes(uint8_t *out, int32_t days,
                                                int32_t ms, int32_t us) {
    int32_t day_adj = floor_div(ms, 86400000);
    ms -= day_adj * 86400000;
    int32_t y, m, d;
    civil(days + day_adj, &y, &m, &d);
    date_bytes(out, y, m, d);
    int32_t hh = floor_div(ms, 3600000);
    int32_t mi = floor_mod(floor_div(ms, 60000), 60);
    int32_t ss = floor_mod(floor_div(ms, 1000), 60);
    int32_t frac = floor_mod(ms, 1000) * 1000 + us;
    out[10] = 32;
    out[11] = digit(hh, 10);
    out[12] = digit(hh, 1);
    out[13] = 58;
    out[14] = digit(mi, 10);
    out[15] = digit(mi, 1);
    out[16] = 58;
    out[17] = digit(ss, 10);
    out[18] = digit(ss, 1);
    out[19] = 46;
    out[20] = digit(frac, 100000);
    out[21] = digit(frac, 10000);
    out[22] = digit(frac, 1000);
    out[23] = digit(frac, 100);
    out[24] = digit(frac, 10);
    out[25] = digit(frac, 1);
}

// every rendered column of row r: its text into `row`, its lengths into
// `lens`
__device__ __forceinline__ void render_row(const uint32_t *__restrict__ words,
                                           int64_t R, int64_t r,
                                           const int32_t *desc, int n_cols,
                                           uint8_t *__restrict__ row,
                                           int32_t *__restrict__ lens) {
    for (int j = 0; j < n_cols; ++j) {
        const int32_t *h = desc + j * DESC_STRIDE;
        const int32_t *c = h + DESC_COMP0;
        int kind = h[0], width = h[1];
        uint8_t *out = row + h[2];
        int L = width;
        switch (kind) {
        case K_BOOL: {
            bool t = value(words, R, r, c) > 0;
            const char *s = t ? "true" : "false";  // "true" ends in NUL
            for (int p = 0; p < width; ++p) out[p] = (uint8_t)s[p];
            L = t ? 4 : 5;
            break;
        }
        case K_I16:
        case K_I32:
        case K_U32: {
            uint32_t raw = extract(words, R, r, c);
            uint32_t mag = raw;
            int neg = 0;
            if (c[3]) {
                mag = (raw >> 1) + (raw & 1u);
                neg = (int)(raw & 1u);
            }
            L = kind == K_I16 ? render_u32<5>(out, mag, neg, width)
                              : render_u32<10>(out, mag, neg, width);
            break;
        }
        case K_I64:
            L = render_i64(out, (int)extract(words, R, r, c),
                           extract(words, R, r, c + 4),
                           extract(words, R, r, c + 8),
                           extract(words, R, r, c + 12), width);
            break;
        case K_DATE: {
            int32_t y, m, d;
            civil(value(words, R, r, c), &y, &m, &d);
            date_bytes(out, y, m, d);
            break;
        }
        default:  // K_TIMESTAMP, K_TIMESTAMPTZ
            timestamp_bytes(out, value(words, R, r, c),
                            value(words, R, r, c + 4),
                            value(words, R, r, c + 8));
            break;
        }
        lens[j] = L;
    }
}

#ifdef __CUDACC__
// A block renders blockDim.x consecutive rows (a multiple of 32) into a
// tile of their text in shared memory, then stores the tile — one
// contiguous, 16-byte aligned range of ebytes — with 16-byte stores.
__global__ void __launch_bounds__(BLOCK)
egress_render_kernel(const uint32_t *__restrict__ words, int64_t R,
                     const int32_t *__restrict__ desc, int n_cols,
                     int total_width, uint8_t *__restrict__ ebytes,
                     int32_t *__restrict__ elens) {
    extern __shared__ uint4 tile16[];
    __shared__ int32_t sdesc[MAX_COLS * DESC_STRIDE];
    uint8_t *tile = (uint8_t *)tile16;
    for (int i = threadIdx.x; i < n_cols * DESC_STRIDE; i += blockDim.x)
        sdesc[i] = desc[i];
    __syncthreads();
    int64_t r0 = (int64_t)blockIdx.x * blockDim.x;
    int64_t r = r0 + threadIdx.x;
    if (r < R)
        render_row(words, R, r, sdesc, n_cols,
                   tile + threadIdx.x * total_width, elens + r * n_cols);
    __syncthreads();
    int64_t rows = R - r0 < blockDim.x ? R - r0 : blockDim.x;
    int64_t n_bytes = rows * total_width;
    uint8_t *dst = ebytes + r0 * total_width;
    int64_t n16 = n_bytes / 16;
    for (int64_t i = threadIdx.x; i < n16; i += blockDim.x)
        ((uint4 *)dst)[i] = tile16[i];
    for (int64_t i = n16 * 16 + threadIdx.x; i < n_bytes; i += blockDim.x)
        dst[i] = tile[i];
}

// rows a block renders: BLOCK, or fewer (a multiple of 32) where BLOCK
// rows of text pass the 48 KB of shared memory a launch takes without
// an opt-in
int block_rows(int total_width) {
    int rows = BLOCK;
    while (rows > 32 && (int64_t)rows * total_width > SMEM_LIMIT) rows -= 32;
    return rows;
}
#endif

}  // namespace

extern "C" {

int etl_egress_max_cols() { return MAX_COLS; }

int etl_egress_desc_stride() { return DESC_STRIDE; }

#ifdef __CUDACC__
// The render on `stream`: words uint32[n_words, R] → ebytes
// uint8[R, total_width], elens int32[R, n_cols]. Returns
// cudaGetLastError() (0 = launched).
int etl_egress_render(const void *words, int64_t n_rows, const void *desc,
                      int n_cols, int total_width, void *ebytes, void *elens,
                      void *stream) {
    if (n_rows <= 0) return 0;
    if (n_cols < 1 || n_cols > MAX_COLS) return (int)cudaErrorInvalidValue;
    if (((uintptr_t)ebytes) % 16) return (int)cudaErrorMisalignedAddress;
    int rows = block_rows(total_width);
    int64_t blocks = (n_rows + rows - 1) / rows;
    size_t smem = ((size_t)rows * total_width + 15) / 16 * 16;
    egress_render_kernel<<<(unsigned)blocks, rows, smem,
                           (cudaStream_t)stream>>>(
        (const uint32_t *)words, n_rows, (const int32_t *)desc, n_cols,
        total_width, (uint8_t *)ebytes, (int32_t *)elens);
    return (int)cudaGetLastError();
}

const char *etl_egress_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
#else
// The render on the host: the kernel's row body for every row.
void etl_egress_render_host(const void *words, int64_t n_rows,
                            const void *desc, int n_cols, int total_width,
                            void *ebytes, void *elens) {
    for (int64_t r = 0; r < n_rows; ++r)
        render_row((const uint32_t *)words, n_rows, r, (const int32_t *)desc,
                   n_cols, (uint8_t *)ebytes + r * total_width,
                   (int32_t *)elens + r * n_cols);
}
#endif

}  // extern "C"
