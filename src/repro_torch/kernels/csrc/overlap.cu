// Fractional-overlap matrix for G-PART's candidate graph, CUDA for sm_90a.
//
// Replaces: the Pallas TPU kernel repro/kernels/overlap.py
//   fractional_overlap_matrix (_overlap_kernel). For code rows A (NA, MA)
//   and B (NB, MB), file sizes (F,) and spans, it computes
//     inter[i,j] = sum(sizes[c] for c in codes_i & codes_j)
//     w[i,j]     = inter > 0 ? inter / max((span_i + span_j) - inter, 1e-12) : 0
//   in float32. The TPU version built (rows x files) one-hot slabs so the
//   intersection became a matrix product on its MXU.
//
// Contract: each row holds distinct codes in ascending order, then -1 pads
//   (repro_torch/kernels/ops.py checks it on the host). A row ends at its
//   first code outside [0, F), so no code is ever used out of range.
//
// What bounds it here: not arithmetic. The work is one test per code of a
//   row against another row; the bytes are the code rows, the sizes and the
//   (NA, NB) output. Two shapes matter:
//   * G-PART's main path, 217 rows of up to 1,200 codes over F = 1,732 files
//     (126 codes a row on average): latency. The parent kernel walked each
//     pair serially in one thread, with a binary search per code, so the
//     thread that held the 1,200-code row set the time.
//   * the scaling benchmark, 4,096 rows of 2-8 codes over F = 81,920 files:
//     the 67 MB output, which is the whole byte bound.
//
// Design: one of two plans, chosen from the shapes by overlap.plan.
//   bitmap (any row length; F in windows of at most 8,192 files): a block
//     holds 32 rows of A as bitmaps over a window of files in shared memory,
//     laid out [word][row] so that lane l reads row l's word and the 32
//     lanes hit 32 banks, and the window's file sizes beside them. A warp
//     takes a row j of B and walks its codes once, four chunks of 32 codes
//     in flight: each code's bitmap word and size are broadcast with a
//     shuffle, and each lane tests its own row's bit with one shared-memory
//     read. The rows of A sit along the lanes and the codes along the loop,
//     so no thread walks a pair alone and the longest row costs one
//     broadcast step per code (two shuffles and one read, issued one after
//     another: this walk sets the main path's time). Where F
//     exceeds the window, the block moves the window up the file axis,
//     carrying each pair's sum and each row's position; the bits it set are
//     cleared again after use.
//   merge (rows of at most 8 codes, F beyond one window): a block takes
//     256 rows of A, staged in shared memory with their sizes, and 32 rows
//     of B, one per lane with its codes in registers, whose codes also go
//     into a hash set in shared memory. A warp takes one row i at a time,
//     so its 32 lanes write 32 neighbouring floats of out (coalesced). Most
//     rows of A share no code with any of the 32 rows of B (the set says
//     so exactly), and those cost one read and a store of 0; the codes
//     that the set holds are compared with the lane's codes. (A cheaper
//     test per lane does not pay: some row of B among 32 nearly always
//     spans a wide code range, so a warp-wide skip needs an exact set.)
//   Both add the sizes of the shared codes in ascending code order, float32
//   adds only, then den = (span_i + span_j) - inter and an IEEE division
//   (no fast math), so two calls, the two plans and the tensor-op twin
//   overlap.fractional_overlap_matrix_ordered give the same bits. `inter` is
//   a sum of positive sizes, so it is 0.0 only when the rows are disjoint,
//   which keeps G-PART's `w > 0` pattern exact. No atomics on floats.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsA = 32;          // bitmap plan: rows of A per block (lanes)
constexpr int kMergeRowsA = 256;    // merge plan: rows of A per block
constexpr int kMergeMax = 8;        // merge plan: codes a row holds at most
constexpr int kBuildChunks = 8;     // bitmap build: chunks of 32 codes in flight
constexpr int kWalkChunks = 4;      // bitmap walk: chunks of 32 codes in flight
constexpr unsigned kFull = 0xffffffffu;
static_assert(kRowsA == 32, "one row of A per lane");

__device__ __forceinline__ bool in_window(int c, long long f0, long long f1)
{
    return c >= f0 && c < f1;
}

// Number of leading lanes whose predicate holds (the prefix of a sorted row
// that lies in the window).
__device__ __forceinline__ int prefix_len(bool in)
{
    const unsigned ball = __ballot_sync(kFull, in);
    return ball == kFull ? 32 : __ffs(~ball) - 1;
}

// codes row[p + 32 u + lane] for u < N, -1 past the row's end m
template <int N>
__device__ __forceinline__ void load_chunks(const int* row, int m,
                                            long long p, int lane,
                                            int (&cc)[N])
{
#pragma unroll
    for (int u = 0; u < N; ++u) {
        const long long t = p + 32 * u + lane;
        cc[u] = t < m ? row[t] : -1;
    }
}

// a += the sizes of the 32 broadcast codes whose bit is set in this lane's
// bitmap row, in lane order; `key` is a code's bitmap word row plus its bit
// and `sz` its size (0.0 for a lane with no code). Shuffles and reads go in
// groups of eight so that their latencies overlap; the adds stay in order.
__device__ __forceinline__ float add_chunk(const unsigned* bm, int key,
                                           float sz, int lane, float a)
{
#pragma unroll
    for (int g = 0; g < 32; g += 8) {
        int ks[8];
        float zs[8];
        unsigned bs[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
            ks[e] = __shfl_sync(kFull, key, g + e);
            zs[e] = __shfl_sync(kFull, sz, g + e);
        }
#pragma unroll
        for (int e = 0; e < 8; ++e)
            bs[e] = (bm[(ks[e] & ~31) + lane] >> (ks[e] & 31)) & 1u;
#pragma unroll
        for (int e = 0; e < 8; ++e) a += bs[e] ? zs[e] : 0.f;
    }
    return a;
}

__device__ __forceinline__ float finish(float inter, float span_i, float span_j)
{
    const float den = (span_i + span_j) - inter;
    return inter > 0.f ? inter / fmaxf(den, 1e-12f) : 0.f;
}

// ------------------------------------------------------------ bitmap plan
// A block takes kRowsA rows of A and kWarps rows of B, one per warp. Shared
// memory: bitmap [ww][kRowsA] words, window sizes [ww * 32], then each A
// row's start and end positions in the current window.
__global__ void __launch_bounds__(kThreads)
overlap_bitmap(const int* __restrict__ codes_a, int ma,
               const float* __restrict__ spans_a, int na,
               const int* __restrict__ codes_b, int mb,
               const float* __restrict__ spans_b, int nb,
               const float* __restrict__ sizes, int F, int ww,
               long long tiles_j, float* __restrict__ out)
{
    extern __shared__ unsigned smem[];
    unsigned* bm = smem;                                    // [ww][kRowsA]
    float* wsz = reinterpret_cast<float*>(bm + ww * kRowsA);  // [ww * 32]
    int* a_beg = reinterpret_cast<int*>(wsz + ww * 32);     // [kRowsA]
    int* a_end = a_beg + kRowsA;                            // [kRowsA]

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long bi = blockIdx.x / tiles_j, bj = blockIdx.x % tiles_j;
    const int i0 = (int)(bi * kRowsA);
    const int ti = min(kRowsA, na - i0);
    const long long wbits = (long long)ww * 32;

    for (int e = threadIdx.x; e < ww * kRowsA; e += kThreads) bm[e] = 0u;
    if (threadIdx.x < kRowsA) a_beg[threadIdx.x] = 0;

    const long long j = bj * kWarps + warp;
    const int* row_j = codes_b + (size_t)j * mb;
    int pos = 0;                         // row j's first code not yet added
    float acc = 0.f;
    __syncthreads();

    for (long long f0 = 0; f0 < F; f0 += wbits) {
        const long long f1 = f0 + wbits < F ? f0 + wbits : F;
        // the window's file sizes
        for (long long f = f0 + threadIdx.x; f < f1; f += kThreads)
            wsz[f - f0] = sizes[f];
        // the bits of A's rows in this window: warp w takes rows w, w+8, ...
        // (kBuildChunks chunks of 32 codes loaded at once)
        for (int r = warp; r < ti; r += kWarps) {
            const int* row = codes_a + (size_t)(i0 + r) * ma;
            int p = a_beg[r];
            bool more = p < ma;
            while (more) {
                int cc[kBuildChunks];
                load_chunks(row, ma, p, lane, cc);
#pragma unroll
                for (int u = 0; u < kBuildChunks; ++u) {
                    if (more) {
                        const int n = prefix_len(in_window(cc[u], f0, f1));
                        if (lane < n)
                            atomicOr(&bm[(int)((cc[u] - f0) >> 5) * kRowsA + r],
                                     1u << (cc[u] & 31));
                        p += n;
                        more = n == 32 && p < ma;
                    }
                }
            }
            if (lane == 0) a_end[r] = p;
        }
        __syncthreads();

        // the warp walks its row of B through the window, kWalkChunks
        // chunks of 32 codes at a time, the next ones loaded meanwhile
        if (j < nb) {
            int cc[kWalkChunks];
            load_chunks(row_j, mb, pos, lane, cc);
            bool more = pos < mb;
            while (more) {
                int nx[kWalkChunks];
                load_chunks(row_j, mb, pos + 32 * kWalkChunks, lane, nx);
#pragma unroll
                for (int u = 0; u < kWalkChunks; ++u) {
                    if (more) {
                        const int n = prefix_len(in_window(cc[u], f0, f1));
                        // lanes past the prefix add +0.0, which leaves a
                        // float sum unchanged, so add_chunk needs no branch
                        const bool use = lane < n;
                        const float sz = use ? wsz[cc[u] - f0] : 0.f;
                        // the word's row of the bitmap (a multiple of
                        // kRowsA = 32) plus the bit: one shuffle carries both
                        const int key = use ? (int)((cc[u] - f0) >> 5) * kRowsA
                                                  + (cc[u] & 31)
                                            : 0;
                        acc = add_chunk(bm, key, sz, lane, acc);
                        pos += n;
                        more = n == 32 && pos < mb;
                    }
                }
#pragma unroll
                for (int u = 0; u < kWalkChunks; ++u) cc[u] = nx[u];
            }
        }

        if (f1 < F) {                       // another window follows
            __syncthreads();
            for (int r = warp; r < ti; r += kWarps) {
                const int* row = codes_a + (size_t)(i0 + r) * ma;
                const int beg = a_beg[r], end = a_end[r];
                for (int t = beg + lane; t < end; t += 32)
                    bm[(int)((row[t] - f0) >> 5) * kRowsA + r] = 0u;
                __syncwarp();
                if (lane == 0) a_beg[r] = end;
            }
            __syncthreads();
        }
    }

    const int i = i0 + lane;
    if (lane < ti && j < nb)
        out[(size_t)i * nb + j] = finish(acc, spans_a[i], spans_b[j]);
}

// ------------------------------------------------------------- merge plan
// The block's 32 rows of B put their codes in a hash set in shared memory
// (open addressing, kTable slots for at most 32 * 8 codes). Each row of A
// marks which of its codes the set holds; a code it does not hold is in no
// row of the tile, so a row of A with no mark is 0 in all 32 columns and
// costs its warp one read. A marked code is compared with the lane's codes.
// The marked codes are taken in ascending order, so the shared codes' sizes
// are added in ascending code order.
constexpr int kTable = 1024;

__device__ __forceinline__ unsigned slot(int c)
{
    return ((unsigned)c * 2654435761u) >> 22;           // 10 bits: kTable
}

__global__ void __launch_bounds__(kThreads)
overlap_merge(const int* __restrict__ codes_a, int ma,
              const float* __restrict__ spans_a, int na,
              const int* __restrict__ codes_b, int mb,
              const float* __restrict__ spans_b, int nb,
              const float* __restrict__ sizes, int F,
              long long tiles_j, float* __restrict__ out)
{
    static_assert(2 * 32 * kMergeMax <= kTable, "the set stays half empty");
    __shared__ int table[kTable];
    __shared__ int sa[kMergeRowsA][kMergeMax];
    __shared__ float sz[kMergeRowsA][kMergeMax];
    __shared__ unsigned marks[kMergeRowsA];
    __shared__ float span_a[kMergeRowsA];

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long bi = blockIdx.x / tiles_j, bj = blockIdx.x % tiles_j;
    const int i0 = (int)(bi * kMergeRowsA);
    const long long j = bj * 32 + lane;

    for (int e = threadIdx.x; e < kTable; e += kThreads) table[e] = -1;

    // this lane's row of B in registers (-1 past its end)
    int b[kMergeMax];
    bool alive = j < nb;
#pragma unroll
    for (int t = 0; t < kMergeMax; ++t) {
        const int c = alive && t < mb ? codes_b[(size_t)j * mb + t] : -1;
        alive = alive && c >= 0 && c < F;
        b[t] = alive ? c : -1;
    }
    const float span_j = j < nb ? spans_b[j] : 0.f;

    // rows of A: codes and sizes, a row ending at its first invalid code
    for (int r = threadIdx.x; r < kMergeRowsA; r += kThreads) {
        const int i = i0 + r;
        bool ok = i < na;
#pragma unroll
        for (int t = 0; t < kMergeMax; ++t) {
            const int c = ok && t < ma ? codes_a[(size_t)i * ma + t] : -1;
            ok = ok && c >= 0 && c < F;
            sa[r][t] = ok ? c : -1;
            sz[r][t] = ok ? sizes[c] : 0.f;
        }
        span_a[r] = i < na ? spans_a[i] : 0.f;
    }
    __syncthreads();

    // the tile's codes into the set: warp w inserts its lane's codes t = w,
    // w + 8, ...
#pragma unroll
    for (int t = 0; t < kMergeMax; ++t) {
        if (t % kWarps != warp || b[t] < 0) continue;
        for (unsigned h = slot(b[t]);; h = (h + 1) & (kTable - 1)) {
            const int prev = atomicCAS(&table[h], -1, b[t]);
            if (prev == -1 || prev == b[t]) break;
        }
    }
    __syncthreads();

    for (int r = threadIdx.x; r < kMergeRowsA; r += kThreads) {
        unsigned m = 0u;
#pragma unroll
        for (int t = 0; t < kMergeMax; ++t) {
            const int c = sa[r][t];
            if (c < 0) continue;
            for (unsigned h = slot(c);; h = (h + 1) & (kTable - 1)) {
                const int v = table[h];
                if (v == c) m |= 1u << t;
                if (v == c || v == -1) break;
            }
        }
        marks[r] = m;
    }
    __syncthreads();

    for (int r = warp; r < kMergeRowsA; r += kWarps) {
        const int i = i0 + r;
        if (i >= na) break;
        const unsigned m0 = marks[r];
        float inter = 0.f;
        for (unsigned m = m0; m; m &= m - 1) {
            const int k = __ffs(m) - 1;
            const int c = sa[r][k];
            bool hit = false;
#pragma unroll
            for (int t = 0; t < kMergeMax; ++t) hit |= b[t] == c;
            inter += hit ? sz[r][k] : 0.f;
        }
        if (j < nb)
            out[(size_t)i * nb + j] = m0 ? finish(inter, span_a[r], span_j)
                                         : 0.f;
    }
}

}  // namespace

// plan 0 (bitmap): param = the window's words of files (1-256);
// plan 1 (merge): param unused (rows of at most kMergeMax codes).
extern "C" int overlap_launch(int plan, int param, const int* codes_a, int ma,
                              const float* spans_a, int na,
                              const int* codes_b, int mb,
                              const float* spans_b, int nb,
                              const float* sizes, int F, float* out,
                              void* stream)
{
    if (na == 0 || nb == 0) return 0;
    if (na < 0 || nb < 0 || ma < 0 || mb < 0 || F < 0)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    if (plan == 0) {
        const int ww = param;
        if (ww < 1 || ww > 256) return (int)cudaErrorInvalidValue;
        const long long tiles_i = (na + kRowsA - 1) / kRowsA;
        const long long tiles_j = (nb + kWarps - 1) / kWarps;
        if (tiles_i * tiles_j > 0x7fffffffLL)
            return (int)cudaErrorInvalidValue;
        const size_t smem = (size_t)ww * kRowsA * sizeof(unsigned)
            + (size_t)ww * 32 * sizeof(float) + 2 * kRowsA * sizeof(int);
        static size_t granted = 48 * 1024;
        if (smem > granted) {
            const cudaError_t e = cudaFuncSetAttribute(
                overlap_bitmap, cudaFuncAttributeMaxDynamicSharedMemorySize,
                (int)smem);
            if (e != cudaSuccess) return (int)e;
            granted = smem;
        }
        overlap_bitmap<<<(unsigned)(tiles_i * tiles_j), kThreads, smem, s>>>(
            codes_a, ma, spans_a, na, codes_b, mb, spans_b, nb, sizes, F, ww,
            tiles_j, out);
        return (int)cudaGetLastError();
    }
    if (plan == 1) {
        if (ma > kMergeMax || mb > kMergeMax)
            return (int)cudaErrorInvalidValue;
        const long long tiles_i = (na + kMergeRowsA - 1) / kMergeRowsA;
        const long long tiles_j = (nb + 31) / 32;
        if (tiles_i * tiles_j > 0x7fffffffLL)
            return (int)cudaErrorInvalidValue;
        overlap_merge<<<(unsigned)(tiles_i * tiles_j), kThreads, 0, s>>>(
            codes_a, ma, spans_a, na, codes_b, mb, spans_b, nb, sizes, F,
            tiles_j, out);
        return (int)cudaGetLastError();
    }
    return (int)cudaErrorInvalidValue;
}

extern "C" const char* overlap_error_string(int e)
{
    return cudaGetErrorString((cudaError_t)e);
}
