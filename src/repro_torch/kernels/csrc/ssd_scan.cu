// Mamba2 SSD chunked scan (state-space duality), CUDA for sm_90a.
//
// Replaces: the Pallas TPU kernel repro/kernels/ssd_scan.py ssd_scan
//   (_kernel). For x (b, s, h, p), dt (b, s, h) float32, A (h,) float32,
//   B and C (b, s, g, n), and an optional skip D (h,) float32 it computes,
//   chunk by chunk of Q steps (head h reads group h / (h_total / g)):
//     cum_i    = sum_{k <= i} dt_k A                (within the chunk)
//     y_i      = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//              + exp(cum_i) C_i state  +  D x_i
//     state'   = exp(cum_last) state + sum_j exp(cum_last - cum_j) dt_j x_j B_j^T
//   in float32, y in x's type (D added before the cast), and the final
//   state (b, h, p, n) in float32. Steps past s are zero (dt = 0), so they
//   neither decay nor feed the state. The TPU walked the chunks in order,
//   carrying the state in VMEM scratch across grid steps.
//
// Two routes, chosen by dtype (not a fallback: each dtype has one route).
//
// bfloat16, tensor cores (namespace bf16tc; the prefill and training
//   route). What bounds it: at zamba2's prefill (b 4, s 512, 80 heads of
//   p 64, n 64, chunk 128) the bytes (x and y 21 MB each, the final state
//   5.2 MB, B, C and dt 1.2 MB) take 0.0144 ms at 3.35 TB/s; the products
//   (5.4 GFLOP) 0.005 ms at the bf16 tensor-core peak. So bytes and
//   latency bound it, and the design spreads the work over chunks: the
//   state is the only thing that crosses chunks. Three launches on the
//   caller's stream, all with mma.sync.m16n8k16 (bf16 in, f32 accumulate):
//   1. chunk pass, one block per (batch, chunk, head): cum by a block scan
//      of warp scans in f32; w_j = exp(cum_last - cum_j) dt_j; the chunk's
//      own state S_loc = (w o X)^T B, (p x n) over depth Q, into f32
//      scratch (b, nc, h, p, n); cum_last into scratch (b, nc, h). Each
//      warp scales its own A fragments of X^T by w_j in registers. The
//      same launch has one more block per (batch, chunk, group), first in
//      the grid, for C . B^T (Q x Q, f32 scratch): all the heads of a
//      group share it (80 with zamba2's one group).
//   2. state pass, one thread per (batch, head, p * n element): walks the
//      nc chunks, writes the state entering each chunk over that chunk's
//      S_loc and the final state into the output.
//   3. scan pass, one block per (batch, chunk, head): stages x, C and the
//      entering state (split once into bf16 hi/lo in place); per 16-row
//      tile of the chunk, y = exp(cum_i) C_i . state_in^T (skipped for
//      chunk 0), then, per 16-column tile j <= i, reads C . B^T (one tile
//      ahead), forms W = CB exp(cum_i - cum_j) dt_j, for j <= i only on the
//      diagonal tile (the exponent overflows above it), and y += W . X;
//      then + D x, cast to bf16 once. The four warps take the row tiles in
//      mirrored pairs (long rows with short), and exp is one ex2 of cum in
//      log2 units.
//   x, B and C are exact bf16 operands. The float32 operands the kernel
//   forms itself (w o X, W, state_in) are split as hi = bf16(v),
//   lo = bf16(v - hi) and enter two products (hi . Y + lo . Y), which
//   keeps about 2^-16 relative error: the state's 1e-4 bar holds for bf16
//   inputs too, where a single bf16 rounding (~4e-3) would not. Tiles are
//   zero-padded in shared memory to multiples of 16 (p, n, the chunk), so
//   p = 8, n = 8, short chunks and a ragged tail all work; rows are padded
//   to an odd number of 16-byte units for conflict-free ldmatrix. Shared
//   memory at zamba2's widths: 37 KB (pass 1) and 54 KB (pass 3), so five
//   and four blocks share an SM. 16-byte cp.async stages x, B, C and the
//   state when p and n are multiples of 8 and the bases are 16-byte
//   aligned, plain loads otherwise; dt's first load starts before the
//   staging, so its latency overlaps it.
//   Up to n 256 (kMaxState) passes 1 and 3 stage B, C and the state whole.
//   Above it the slab kernels take the call, so that shared memory does
//   not grow with n: pass 1 stages B (and, in the C . B^T blocks, C) a
//   slab of 128 columns at a time, S_loc's columns come slab by slab, and
//   C . B^T adds each slab's products into its f32 scratch; pass 3's warps
//   walk the rounds of row tiles in step, and for each round and p block
//   the block stages the round's C rows and the entering state's rows a
//   slab at a time (the state split into hi/lo as above), each warp adding
//   the slab's exp(cum_i) C_i . state_in^T to its accumulators before the
//   W . X tiles. So the bf16 route takes any n; its shared memory is set by
//   the chunk and p (ssd_scan_smem_bytes).
//
// float32, CUDA cores (namespace f32; the float32 check route, not a speed
//   path): one block of 256 threads per (batch, head, slice of 32 columns
//   of p); the rows of p are independent (y's column p and the state's row
//   p read only x's column p), so the slices need nothing of each other.
//   The slice's running state lives in its rows of the state output, and
//   the chunk's cum, dt and decays in 3 Q floats of scratch per block.
//   Every operand passes through 32 x 32 tiles in shared memory (C, B, the
//   state, x and W: 21 KB at every shape), each thread carrying its
//   elements' sums in registers from tile to tile, so each sum is one
//   float32 chain in index order: per chunk, for each 32-row tile of y,
//   inter = C_i . state_p over n tiles, W_ij = (C_i . B_j) exp(cum_i -
//   cum_j) dt_j for j <= i over n tiles per 32-column tile of j, intra =
//   W . X over those j tiles, y = intra + inter exp(cum_i) + D x; then
//   state' = exp(cum_last) state + sum_j x_j dec_j B_j over j tiles per
//   32-column tile of n. So it takes every (chunk, p, n) (the wrapper runs
//   a chunk longer than the sequence as a chunk of the sequence: the same
//   scan).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_common.cuh"

namespace f32 {

constexpr int kThreads = 256;
constexpr int kT = 32;                       // rows, j columns, p and n a tile
constexpr int kLd = kT + 1;                  // padded row stride of a tile
constexpr int kTiles = 5;                    // C, B, state, x and W tiles
constexpr int kPer = kT * kT / kThreads;     // elements of a tile a thread

size_t smem_bytes() { return sizeof(float) * kTiles * kT * kLd; }

// One block per (batch, head, slice of kT columns of p); the slice's
// running state lives in its rows of state_out, and cum, dt and the decays
// of the chunk in the block's 3 Q floats of scr. Thread (warp, lane) owns
// the elements (warp + 8 k, lane), k < kPer, of a tile and carries their
// sums in registers from tile to tile, so each sum is one chain in the
// order of its index.
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const float* __restrict__ Bm,
           const float* __restrict__ Cm, const float* __restrict__ Dskip,
           float* __restrict__ y, float* state_out, float* scr, int S,
           int H, int P, int G, int N, int Q, int np)
{
    extern __shared__ float smem[];
    float* cs = smem;                        // C rows i, columns n
    float* bs = cs + kT * kLd;               // B rows j, columns n
    float* ss = bs + kT * kLd;               // state rows p, columns n
    float* xs = ss + kT * kLd;               // x rows j, columns p
    float* ws = xs + kT * kLd;               // W rows i, columns j

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int bh = blockIdx.x / np, b = bh / H, h = bh % H;
    const int g = h / (H / G);
    const int p0 = (blockIdx.x % np) * kT, pw = min(kT, P - p0);
    const float Ah = A[h];
    const float Dh = Dskip != nullptr ? Dskip[h] : 0.f;
    float* cum = scr + (size_t)blockIdx.x * 3 * Q;
    float* dts = cum + Q;
    float* dec = dts + Q;                    // exp(cum_last - cum_j) dt_j
    float* st = state_out + ((size_t)bh * P + p0) * N;   // rows p0 ..
    const size_t xrow = (size_t)H * P, brow = (size_t)G * N;

    // rows [0, rows) and columns [0, cols) of the matrix at src (row
    // stride `stride`) into a tile, zeros elsewhere
    auto load = [&](float* dst, const float* src, size_t stride, int rows,
                    int cols) {
        for (int e = tid; e < kT * kT; e += kThreads) {
            const int r = e / kT, c = e % kT;
            dst[r * kLd + c] = r < rows && c < cols ? src[r * stride + c] : 0.f;
        }
    };

    if (S == 0) {
        for (int e = tid; e < pw * N; e += kThreads) st[e] = 0.f;
        return;
    }
    for (int c0 = 0; c0 < S; c0 += Q) {
        const int L = min(Q, S - c0);
        const float* xc = x + ((size_t)b * S + c0) * xrow + (size_t)h * P;
        const float* bc = Bm + ((size_t)b * S + c0) * brow + (size_t)g * N;
        const float* cc = Cm + ((size_t)b * S + c0) * brow + (size_t)g * N;
        __syncthreads();                     // the last chunk's scratch is read
        for (int i = tid; i < L; i += kThreads)
            dts[i] = dt[((size_t)b * S + c0 + i) * H + h];
        __syncthreads();
        if (tid == 0) {
            float run = 0.f;
            for (int i = 0; i < L; ++i) {
                run += dts[i] * Ah;
                cum[i] = run;
            }
        }
        __syncthreads();
        const float cl = cum[L - 1];
        for (int i = tid; i < L; i += kThreads)
            dec[i] = expf(cl - cum[i]) * dts[i];

        // y, kT rows at a time, from the state entering the chunk
        for (int r0 = 0; r0 < L; r0 += kT) {
            const int R = min(kT, L - r0);
            float intra[kPer], inter[kPer];
#pragma unroll
            for (int k = 0; k < kPer; ++k) intra[k] = inter[k] = 0.f;
            if (c0 > 0) {                    // C_i . state_p over n
                for (int n0 = 0; n0 < N; n0 += kT) {
                    const int nw = min(kT, N - n0);
                    __syncthreads();
                    load(cs, cc + (size_t)r0 * brow + n0, brow, R, nw);
                    load(ss, st + n0, N, pw, nw);
                    __syncthreads();
#pragma unroll
                    for (int k = 0; k < kPer; ++k) {
                        const float* ci = cs + (warp + 8 * k) * kLd;
                        const float* sp = ss + lane * kLd;
                        float v = inter[k];
                        for (int n = 0; n < nw; ++n) v = fmaf(ci[n], sp[n], v);
                        inter[k] = v;
                    }
                }
            }
            for (int j0 = 0; j0 < r0 + R; j0 += kT) {
                const int jw = min(kT, L - j0);
                float dot[kPer];             // C_i . B_j over n
#pragma unroll
                for (int k = 0; k < kPer; ++k) dot[k] = 0.f;
                for (int n0 = 0; n0 < N; n0 += kT) {
                    const int nw = min(kT, N - n0);
                    __syncthreads();
                    load(cs, cc + (size_t)r0 * brow + n0, brow, R, nw);
                    load(bs, bc + (size_t)j0 * brow + n0, brow, jw, nw);
                    __syncthreads();
#pragma unroll
                    for (int k = 0; k < kPer; ++k) {
                        const float* ci = cs + (warp + 8 * k) * kLd;
                        const float* bj = bs + lane * kLd;
                        float v = dot[k];
                        for (int n = 0; n < nw; ++n) v = fmaf(ci[n], bj[n], v);
                        dot[k] = v;
                    }
                }
                __syncthreads();             // ws and xs are free again
                // W_ij = (C_i . B_j) exp(cum_i - cum_j) dt_j, for j <= i only
#pragma unroll
                for (int k = 0; k < kPer; ++k) {
                    const int i = warp + 8 * k, row = r0 + i, j = j0 + lane;
                    ws[i * kLd + lane] = i < R && lane < jw && j <= row
                        ? dot[k] * expf(cum[row] - cum[j]) * dts[j] : 0.f;
                }
                load(xs, xc + (size_t)j0 * xrow + p0, xrow, jw, pw);
                __syncthreads();
#pragma unroll
                for (int k = 0; k < kPer; ++k) {
                    const int i = warp + 8 * k;
                    const float* wi = ws + i * kLd;
                    const int last = min(jw, r0 + i - j0 + 1);   // j <= row
                    float v = intra[k];
                    for (int j = 0; j < last; ++j)
                        v = fmaf(wi[j], xs[j * kLd + lane], v);
                    intra[k] = v;
                }
            }
#pragma unroll
            for (int k = 0; k < kPer; ++k) {
                const int row = r0 + warp + 8 * k;
                if (warp + 8 * k >= R || lane >= pw) continue;
                const float xv = xc[(size_t)row * xrow + p0 + lane];
                y[((size_t)b * S + c0 + row) * xrow + (size_t)h * P + p0 + lane]
                    = intra[k] + inter[k] * expf(cum[row]) + xv * Dh;
            }
        }

        // state' = exp(cum_last) state + sum_j x_j dec_j B_j^T, kT columns
        // of n at a time
        const float ecl = expf(cl);
        for (int n0 = 0; n0 < N; n0 += kT) {
            const int nw = min(kT, N - n0);
            float acc[kPer];
#pragma unroll
            for (int k = 0; k < kPer; ++k) acc[k] = 0.f;
            for (int j0 = 0; j0 < L; j0 += kT) {
                const int jw = min(kT, L - j0);
                __syncthreads();
                load(bs, bc + (size_t)j0 * brow + n0, brow, jw, nw);
                load(xs, xc + (size_t)j0 * xrow + p0, xrow, jw, pw);
                __syncthreads();
#pragma unroll
                for (int k = 0; k < kPer; ++k) {
                    const int p = warp + 8 * k;
                    float v = acc[k];
                    for (int j = 0; j < jw; ++j)
                        v = fmaf(xs[j * kLd + p], dec[j0 + j] * bs[j * kLd + lane], v);
                    acc[k] = v;
                }
            }
#pragma unroll
            for (int k = 0; k < kPer; ++k) {
                const int p = warp + 8 * k;
                if (p >= pw || lane >= nw) continue;
                float* sv = st + (size_t)p * N + n0 + lane;
                *sv = c0 > 0 ? ecl * *sv + acc[k] : acc[k];
            }
        }
    }
}

int launch(const float* x, const float* dt, const float* A, const float* Bm,
           const float* Cm, const float* Dskip, float* y, float* state_out,
           float* scr, int Bsz, int S, int H, int P, int G, int N, int Q,
           cudaStream_t stream)
{
    if (P == 0) return 0;
    if (scr == nullptr && S > 0) return (int)cudaErrorInvalidValue;
    const int np = (P + kT - 1) / kT;
    const long long blocks = (long long)Bsz * H * np;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    ssd_kernel<<<(unsigned)blocks, kThreads, smem_bytes(), stream>>>(
        x, dt, A, Bm, Cm, Dskip, y, state_out, scr, S, H, P, G, N, Q, np);
    return (int)cudaGetLastError();
}

}  // namespace f32

namespace bf16tc {

using tc::bf16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxTile = 128;        // widest p (pass 3) or n (pass 1) block
constexpr float kLog2e = 1.4426950408889634f;

inline __host__ __device__ int up16(int v) { return (v + 15) & ~15; }

constexpr int kMaxState = 256;       // widest n staged whole
constexpr int kSlab = 128;           // n columns a slab above kMaxState

// Row stride (f32) of pass 3's state tile: staged in f32, then each row
// split in place into bf16 hi in [0, N16) and lo in [N16 + 8, 2 N16 + 8)
// (a row stride of 2 N16 + 8 bf16, an odd number of 16-byte units).
inline __host__ __device__ int ld_split_f32(int N16) { return N16 + 4; }

// Shared memory (bytes) of pass 1 and pass 3 for chunk Q, widths P and N:
// pass 1 x (Q16, P16 + 8) and B (Q16, N16 + 8) in bf16, or C in x's place
// in its C.B^T blocks; pass 3 x and C in bf16 and the entering state
// (P16, N16 + 4) in f32; both cum, dt and 32 warp totals in f32.
inline __host__ __device__ size_t smem_pass1(int Q, int P, int N)
{
    const size_t q = up16(Q), p = up16(P), n = up16(N);
    return 2 * (q * ((p > n ? p : n) + 8) + q * (n + 8)) + 4 * (2 * q + 32);
}
inline __host__ __device__ size_t smem_pass3(int Q, int P, int N)
{
    const size_t q = up16(Q), p = up16(P), n = up16(N) + 8;
    return 2 * (q * (p + 8) + q * n)
         + 4 * (p * ld_split_f32(up16(N)) + 2 * q + 32);
}

// Above n kMaxState (the slab kernels): pass 1 stages x (Q16, P16 + 8),
// or a C slab in its place, and a B slab (Q16, kSlab + 8); pass 3 stages x,
// the C rows of one round of row tiles (16 kWarps, kSlab + 8) and a state
// slab (at most kMaxTile rows of p, kSlab + 4) in f32
inline __host__ __device__ size_t smem_pass1_wide(int Q, int P)
{
    const size_t q = up16(Q), p = up16(P);
    return 2 * (q * ((p > kSlab ? p : kSlab) + 8) + q * (kSlab + 8))
         + 4 * (2 * q + 32);
}
inline __host__ __device__ size_t smem_pass3_wide(int Q, int P)
{
    const size_t q = up16(Q), p = up16(P), pr = p < kMaxTile ? p : kMaxTile;
    return 2 * (q * (p + 8) + 16 * kWarps * (kSlab + 8))
         + 4 * (pr * ld_split_f32(kSlab) + 2 * q + 32);
}

// In-place inclusive prefix sum of v[0, n) in shared memory by the whole
// block: warp scans by shuffles, then the warps' totals; tot holds 32.
__device__ void block_cumsum(float* v, int n, float* tot)
{
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
    float carry = 0.f;
    for (int base = 0; base < n; base += blockDim.x) {
        const int i = base + threadIdx.x;
        float x = i < n ? v[i] : 0.f;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const float u = __shfl_up_sync(tc::kFull, x, o);
            if (lane >= o) x += u;
        }
        if (lane == 31) tot[warp] = x;
        __syncthreads();
        float pre = carry, all = 0.f;
        for (int w = 0; w < nw; ++w) {
            if (w < warp) pre += tot[w];
            all += tot[w];
        }
        if (i < n) v[i] = x + pre;
        carry += all;
        __syncthreads();
    }
}

// dt of the chunk into dts[0, Q16) (zeros past the sequence) and its
// cumulative dt * A into cum. d0 is this thread's first dt, loaded by the
// caller before it staged its tiles, so that the load's latency overlaps
// the staging (see first_dt).
__device__ void chunk_cum(const float* __restrict__ dt, float d0, float Ah,
                          int b, int S, int H, int h, int c0, int L, int Q16,
                          float* dts, float* cum, float* tot)
{
    for (int i = threadIdx.x; i < Q16; i += blockDim.x) {
        const float d = i == (int)threadIdx.x ? d0
            : (i < L ? dt[((size_t)b * S + c0 + i) * H + h] : 0.f);
        dts[i] = d;
        cum[i] = d * Ah;
    }
    __syncthreads();
    block_cumsum(cum, Q16, tot);
}
__device__ __forceinline__ float first_dt(const float* __restrict__ dt, int b,
                                          int S, int H, int h, int c0, int L)
{
    const int i = threadIdx.x;
    return i < L ? dt[((size_t)b * S + c0 + i) * H + h] : 0.f;
}

// Row tile of warp `warp` in round m: rounds of kWarps tiles, mirrored
// every other round, so that the long rows (many j tiles) and the short
// ones pair up per warp
__device__ __forceinline__ int row_tile(int m, int warp)
{
    return m * kWarps + ((m & 1) ? kWarps - 1 - warp : warp);
}

// C . B^T of one (batch, chunk, group), (Q16, Q16) f32, into cb: the
// 16 x 16 tiles on and below the diagonal (the scan reads no other)
__device__ void chunk_cb(const bf16* __restrict__ Bm,
                         const bf16* __restrict__ Cm, float* __restrict__ cb,
                         bf16* cs, bf16* bs, int b, int c, int grp, int S,
                         int G, int N, int Q, int vec)
{
    const int Q16 = up16(Q), N16 = up16(N), ldn = N16 + 8;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g8 = lane >> 2, t4 = lane & 3;
    const int c0 = c * Q, L = min(Q, S - c0);
    const size_t bco = (((size_t)b * S + c0) * G + grp) * N;
    tc::stage_rows(bs, ldn, Bm + bco, (size_t)G * N, Q16, L, N, N16, vec, tid,
                   kThreads);
    tc::stage_rows(cs, ldn, Cm + bco, (size_t)G * N, Q16, L, N, N16, vec, tid,
                   kThreads);
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
    __syncthreads();
    const int RT = (L + 15) / 16;
    for (int m = 0;; ++m) {
        const int rt = row_tile(m, warp);
        if (rt >= RT) break;
        for (int jt = 0; jt <= rt; ++jt) {
            float acc[2][4] = {};
            for (int ks = 0; ks < N16 / 16; ++ks) {
                unsigned a[4], bb[4];
                tc::load_a(a, cs, ldn, rt * 16, ks * 16, lane);
                tc::load_b_nk(bb, bs, ldn, jt * 16, ks * 16, lane);
                tc::mma(acc[0], a, bb[0], bb[1]);
                tc::mma(acc[1], a, bb[2], bb[3]);
            }
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
                for (int half = 0; half < 2; ++half)
                    *reinterpret_cast<float2*>(
                        cb + (size_t)(rt * 16 + g8 + 8 * half) * Q16 + jt * 16
                        + nt * 8 + 2 * t4) =
                        make_float2(acc[nt][2 * half], acc[nt][2 * half + 1]);
        }
    }
}

// chunk_cb above n kMaxState: C and B staged a slab of kSlab columns at a
// time, each warp adding a slab's products of its tiles to cb (its own
// elements, so no other thread touches them)
__device__ void chunk_cb_wide(const bf16* __restrict__ Bm,
                              const bf16* __restrict__ Cm,
                              float* __restrict__ cb, bf16* cs, bf16* bs,
                              int b, int c, int grp, int S, int G, int N,
                              int Q, int vec)
{
    const int Q16 = up16(Q), N16 = up16(N), ld = kSlab + 8;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g8 = lane >> 2, t4 = lane & 3;
    const int c0 = c * Q, L = min(Q, S - c0);
    const size_t bco = (((size_t)b * S + c0) * G + grp) * N;
    const int RT = (L + 15) / 16;
    for (int n0 = 0; n0 < N16; n0 += kSlab) {
        const int nw = min(kSlab, N16 - n0), width = min(kSlab, N - n0);
        __syncthreads();                     // the last slab is consumed
        tc::stage_rows(bs, ld, Bm + bco + n0, (size_t)G * N, Q16, L, width,
                       nw, vec, tid, kThreads);
        tc::stage_rows(cs, ld, Cm + bco + n0, (size_t)G * N, Q16, L, width,
                       nw, vec, tid, kThreads);
        tc::cp_async_commit();
        tc::cp_async_wait<0>();
        __syncthreads();
        for (int m = 0;; ++m) {
            const int rt = row_tile(m, warp);
            if (rt >= RT) break;
            for (int jt = 0; jt <= rt; ++jt) {
                float acc[2][4] = {};
                for (int ks = 0; ks < nw / 16; ++ks) {
                    unsigned a[4], bb[4];
                    tc::load_a(a, cs, ld, rt * 16, ks * 16, lane);
                    tc::load_b_nk(bb, bs, ld, jt * 16, ks * 16, lane);
                    tc::mma(acc[0], a, bb[0], bb[1]);
                    tc::mma(acc[1], a, bb[2], bb[3]);
                }
#pragma unroll
                for (int nt = 0; nt < 2; ++nt)
#pragma unroll
                    for (int half = 0; half < 2; ++half) {
                        float2* dst = reinterpret_cast<float2*>(
                            cb + (size_t)(rt * 16 + g8 + 8 * half) * Q16
                            + jt * 16 + nt * 8 + 2 * t4);
                        const float2 was = n0 > 0 ? *dst : make_float2(0.f, 0.f);
                        *dst = make_float2(was.x + acc[nt][2 * half],
                                           was.y + acc[nt][2 * half + 1]);
                    }
            }
        }
    }
}

// ---- pass 1: S_loc = (w o X)^T B per (batch, chunk, head); the first
// b * nc * G blocks compute C . B^T per (batch, chunk, group) instead
template <int NT>                    // n-tiles of 8 per warp tile (<= 16)
__global__ void __launch_bounds__(kThreads)
chunk_state_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const bf16* __restrict__ Bm,
                   const bf16* __restrict__ Cm, float* __restrict__ s_loc,
                   float* __restrict__ decay, float* __restrict__ cbuf,
                   int S, int H, int P, int G, int N, int Q, int nc, int vec)
{
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int Q16 = up16(Q), P16 = up16(P), N16 = up16(N);
    const int ldx = P16 + 8, ldn = N16 + 8;
    bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // (Q16, ldx) or C
    bf16* bs = xs + Q16 * (P16 > N16 ? ldx : ldn);  // (Q16, ldn)
    float* cum = reinterpret_cast<float*>(bs + Q16 * ldn);
    float* w = cum + Q16;                           // dt, then w_j
    float* tot = w + Q16;

    const int n_cb = gridDim.x / (H + G) * G;       // b * nc * G
    if ((int)blockIdx.x < n_cb) {
        const int bc = blockIdx.x / G;
        chunk_cb(Bm, Cm, cbuf + (size_t)blockIdx.x * Q16 * Q16, xs, bs,
                 bc / nc, bc % nc, blockIdx.x % G, S, G, N, Q, vec);
        return;
    }
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g8 = lane >> 2, t4 = lane & 3;
    const int h = (blockIdx.x - n_cb) % H;
    const int bc = (blockIdx.x - n_cb) / H;         // b * nc + c
    const int b = bc / nc, c = bc % nc;
    const int grp = h / (H / G);
    const int c0 = c * Q, L = min(Q, S - c0);

    const float d0 = first_dt(dt, b, S, H, h, c0, L);
    tc::stage_rows(xs, ldx, x + (((size_t)b * S + c0) * H + h) * P,
                   (size_t)H * P, Q16, L, P, P16, vec, tid, kThreads);
    tc::stage_rows(bs, ldn, Bm + (((size_t)b * S + c0) * G + grp) * N,
                   (size_t)G * N, Q16, L, N, N16, vec, tid, kThreads);
    tc::cp_async_commit();
    chunk_cum(dt, d0, A[h], b, S, H, h, c0, L, Q16, w, cum, tot);
    const float cl = cum[Q16 - 1];
    if (tid == 0) decay[(size_t)bc * H + h] = cl;
    for (int j = tid; j < Q16; j += kThreads)
        w[j] = expf(cl - cum[j]) * w[j];
    tc::cp_async_wait<0>();
    __syncthreads();

    // the A operand (w o X)^T: each lane scales its fragment of X^T by
    // w_j per column j (2t, 2t + 1 and 2t + 8, 2t + 9 of the k-step) and
    // splits it into hi/lo; B is exact
    const int ksteps = (L + 15) / 16;
    float* out = s_loc + ((size_t)bc * H + h) * P * N;
    for (int pt = warp; pt < P16 / 16; pt += kWarps) {
        for (int nb = 0; nb < N16; nb += NT * 8) {
            float acc[NT][4];
#pragma unroll
            for (int i = 0; i < NT; ++i)
                acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
            for (int ks = 0; ks < ksteps; ++ks) {
                unsigned a[4], ah[4], al[4];
                tc::load_a_t(a, xs, ldx, ks * 16, pt * 16, lane);
                const float* wk = w + ks * 16 + 2 * t4;
                tc::scale_split(a[0], wk[0], wk[1], ah[0], al[0]);
                tc::scale_split(a[1], wk[0], wk[1], ah[1], al[1]);
                tc::scale_split(a[2], wk[8], wk[9], ah[2], al[2]);
                tc::scale_split(a[3], wk[8], wk[9], ah[3], al[3]);
#pragma unroll
                for (int np = 0; np < NT / 2; ++np) {
                    if (nb + np * 16 >= N16) break;
                    unsigned bb[4];
                    tc::load_b_kn(bb, bs, ldn, ks * 16, nb + np * 16, lane);
                    tc::mma(acc[2 * np], ah, bb[0], bb[1]);
                    tc::mma(acc[2 * np + 1], ah, bb[2], bb[3]);
                    tc::mma(acc[2 * np], al, bb[0], bb[1]);
                    tc::mma(acc[2 * np + 1], al, bb[2], bb[3]);
                }
            }
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
                const int n = nb + nt * 8 + 2 * t4;
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int p = pt * 16 + g8 + 8 * half;
                    if (p >= P || n >= N) continue;
                    float* dst = out + (size_t)p * N + n;
                    if ((N & 1) == 0) {
                        *reinterpret_cast<float2*>(dst) =
                            make_float2(acc[nt][2 * half], acc[nt][2 * half + 1]);
                    } else {
                        dst[0] = acc[nt][2 * half];
                        if (n + 1 < N) dst[1] = acc[nt][2 * half + 1];
                    }
                }
            }
        }
    }
}

// pass 1 above n kMaxState: the same blocks, B (and in the C . B^T
// blocks C) staged a slab of kSlab columns at a time
__global__ void __launch_bounds__(kThreads)
chunk_state_wide_kernel(const bf16* __restrict__ x,
                        const float* __restrict__ dt,
                        const float* __restrict__ A,
                        const bf16* __restrict__ Bm,
                        const bf16* __restrict__ Cm,
                        float* __restrict__ s_loc, float* __restrict__ decay,
                        float* __restrict__ cbuf, int S, int H, int P, int G,
                        int N, int Q, int nc, int vec)
{
    constexpr int NT = kSlab / 8;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int Q16 = up16(Q), P16 = up16(P), N16 = up16(N);
    const int ldx = P16 + 8, lds = kSlab + 8;
    bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // (Q16, ldx), or a C slab
    bf16* bs = xs + Q16 * ((P16 > kSlab ? P16 : kSlab) + 8);  // (Q16, lds)
    float* cum = reinterpret_cast<float*>(bs + Q16 * lds);
    float* w = cum + Q16;                           // dt, then w_j
    float* tot = w + Q16;

    const int n_cb = gridDim.x / (H + G) * G;       // b * nc * G
    if ((int)blockIdx.x < n_cb) {
        const int bc = blockIdx.x / G;
        chunk_cb_wide(Bm, Cm, cbuf + (size_t)blockIdx.x * Q16 * Q16, xs, bs,
                      bc / nc, bc % nc, blockIdx.x % G, S, G, N, Q, vec);
        return;
    }
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g8 = lane >> 2, t4 = lane & 3;
    const int h = (blockIdx.x - n_cb) % H;
    const int bc = (blockIdx.x - n_cb) / H;         // b * nc + c
    const int b = bc / nc, c = bc % nc;
    const int grp = h / (H / G);
    const int c0 = c * Q, L = min(Q, S - c0);
    const size_t bco = (((size_t)b * S + c0) * G + grp) * N;

    const float d0 = first_dt(dt, b, S, H, h, c0, L);
    tc::stage_rows(xs, ldx, x + (((size_t)b * S + c0) * H + h) * P,
                   (size_t)H * P, Q16, L, P, P16, vec, tid, kThreads);
    tc::cp_async_commit();
    chunk_cum(dt, d0, A[h], b, S, H, h, c0, L, Q16, w, cum, tot);
    const float cl = cum[Q16 - 1];
    if (tid == 0) decay[(size_t)bc * H + h] = cl;
    for (int j = tid; j < Q16; j += kThreads)
        w[j] = expf(cl - cum[j]) * w[j];

    const int ksteps = (L + 15) / 16;
    float* out = s_loc + ((size_t)bc * H + h) * P * N;
    for (int n0 = 0; n0 < N16; n0 += kSlab) {
        const int nw = min(kSlab, N16 - n0), width = min(kSlab, N - n0);
        __syncthreads();                     // the last slab is consumed
        tc::stage_rows(bs, lds, Bm + bco + n0, (size_t)G * N, Q16, L, width,
                       nw, vec, tid, kThreads);
        tc::cp_async_commit();
        tc::cp_async_wait<0>();
        __syncthreads();
        for (int pt = warp; pt < P16 / 16; pt += kWarps) {
            float acc[NT][4];
#pragma unroll
            for (int i = 0; i < NT; ++i)
                acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
            for (int ks = 0; ks < ksteps; ++ks) {
                unsigned a[4], ah[4], al[4];
                tc::load_a_t(a, xs, ldx, ks * 16, pt * 16, lane);
                const float* wk = w + ks * 16 + 2 * t4;
                tc::scale_split(a[0], wk[0], wk[1], ah[0], al[0]);
                tc::scale_split(a[1], wk[0], wk[1], ah[1], al[1]);
                tc::scale_split(a[2], wk[8], wk[9], ah[2], al[2]);
                tc::scale_split(a[3], wk[8], wk[9], ah[3], al[3]);
#pragma unroll
                for (int np = 0; np < NT / 2; ++np) {
                    if (np * 16 >= nw) break;
                    unsigned bb[4];
                    tc::load_b_kn(bb, bs, lds, ks * 16, np * 16, lane);
                    tc::mma(acc[2 * np], ah, bb[0], bb[1]);
                    tc::mma(acc[2 * np + 1], ah, bb[2], bb[3]);
                    tc::mma(acc[2 * np], al, bb[0], bb[1]);
                    tc::mma(acc[2 * np + 1], al, bb[2], bb[3]);
                }
            }
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
                const int n = n0 + nt * 8 + 2 * t4;
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int p = pt * 16 + g8 + 8 * half;
                    if (p >= P || n >= N) continue;
                    float* dst = out + (size_t)p * N + n;
                    if ((N & 1) == 0) {
                        *reinterpret_cast<float2*>(dst) =
                            make_float2(acc[nt][2 * half], acc[nt][2 * half + 1]);
                    } else {
                        dst[0] = acc[nt][2 * half];
                        if (n + 1 < N) dst[1] = acc[nt][2 * half + 1];
                    }
                }
            }
        }
    }
}

// ---- pass 2: the state entering each chunk (over S_loc), final state
__global__ void __launch_bounds__(256)
state_pass_kernel(float* __restrict__ buf, const float* __restrict__ decay,
                  float* __restrict__ state_out, int H, int PN, int nc)
{
    constexpr int kBatch = 4;        // chunks whose loads are in flight
    const int e = blockIdx.y * blockDim.x + threadIdx.x;
    const int bh = blockIdx.x, b = bh / H, h = bh % H;
    if (e >= PN) return;
    float st = 0.f;
    for (int c0 = 0; c0 < nc; c0 += kBatch) {
        float loc[kBatch], dec[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
            if (c0 + k >= nc) break;
            const size_t bch = ((size_t)b * nc + c0 + k) * H + h;
            loc[k] = buf[bch * PN + e];
            dec[k] = decay[bch];
        }
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
            if (c0 + k >= nc) break;
            const size_t bch = ((size_t)b * nc + c0 + k) * H + h;
            buf[bch * PN + e] = st;
            st = expf(dec[k]) * st + loc[k];
        }
    }
    state_out[(size_t)bh * PN + e] = st;
}

// y of one row tile rt and block of p columns pb: acc (exp(cum_i) C_i .
// state_in^T, or zeros in chunk 0) += W . X over the column tiles j <= rt,
// then + D x, cast to bf16 once
template <int PT>
__device__ __forceinline__ void scan_tile(
    float (&acc)[PT][4], const float* __restrict__ cbt, const float* cum,
    const float* dts, const bf16* xs, int ldx, bf16* __restrict__ y, int rt,
    int pb, const int (&ri)[2], const float (&ci)[2], int b, int S, int c0,
    int H, int h, int P, int P16, int L, int Q16, float Dh, int lane)
{
    const int t4 = lane & 3;
    // C . B^T of this row tile, read in the accumulator layout, one
    // j tile ahead of its use
    float2 cbn[2][2];
    auto read_cb = [&](int jt) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int half = 0; half < 2; ++half)
                cbn[nt][half] = __ldg(reinterpret_cast<const float2*>(
                    cbt + (size_t)ri[half] * Q16 + jt * 16 + nt * 8
                    + 2 * t4));
    };
    read_cb(0);
    for (int jt = 0; jt <= rt; ++jt) {
        float cb[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
            cb[nt][0] = cbn[nt][0].x; cb[nt][1] = cbn[nt][0].y;
            cb[nt][2] = cbn[nt][1].x; cb[nt][3] = cbn[nt][1].y;
        }
        if (jt < rt) read_cb(jt + 1);
        // W = CB exp(cum_i - cum_j) dt_j for j <= i, as hi/lo A
        // fragments: (nt, half) -> register nt * 2 + half. Below
        // the diagonal tile every j <= i; on it the exponent is
        // formed only for j <= i (it overflows above).
        unsigned ah[4], al[4];
        const bool diag = jt == rt;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
            const int j = jt * 16 + nt * 8 + 2 * t4;
            const float cj0 = cum[j], cj1 = cum[j + 1];
            const float dj0 = dts[j], dj1 = dts[j + 1];
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int i = ri[half];
                float w0 = 0.f, w1 = 0.f;
                if (!diag || j <= i)
                    w0 = cb[nt][2 * half] * tc::ex2(ci[half] - cj0) * dj0;
                if (!diag || j + 1 <= i)
                    w1 = cb[nt][2 * half + 1] * tc::ex2(ci[half] - cj1) * dj1;
                tc::split_pack(w0, w1, ah[nt * 2 + half], al[nt * 2 + half]);
            }
        }
#pragma unroll
        for (int np = 0; np < PT / 2; ++np) {
            if (pb + np * 16 >= P16) break;
            unsigned bb[4];
            tc::load_b_kn(bb, xs, ldx, jt * 16, pb + np * 16, lane);
            tc::mma(acc[2 * np], ah, bb[0], bb[1]);
            tc::mma(acc[2 * np + 1], ah, bb[2], bb[3]);
            tc::mma(acc[2 * np], al, bb[0], bb[1]);
            tc::mma(acc[2 * np + 1], al, bb[2], bb[3]);
        }
    }
    // + D x, one cast to bf16
#pragma unroll
    for (int nt = 0; nt < PT; ++nt) {
        const int p = pb + nt * 8 + 2 * t4;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int i = ri[half];
            if (i >= L || p >= P) continue;
            const float2 xv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(xs + i * ldx + p));
            const float y0 = acc[nt][2 * half] + Dh * xv.x;
            const float y1 = acc[nt][2 * half + 1] + Dh * xv.y;
            bf16* dst = y + (((size_t)b * S + c0 + i) * H + h) * P + p;
            if ((P & 1) == 0) {
                *reinterpret_cast<__nv_bfloat162*>(dst) =
                    __floats2bfloat162_rn(y0, y1);
            } else {
                dst[0] = __float2bfloat16_rn(y0);
                if (p + 1 < P) dst[1] = __float2bfloat16_rn(y1);
            }
        }
    }
}

// ---- pass 3: y per (batch, chunk, head)
template <int PT>                    // p-tiles of 8 per warp tile (<= 16)
__global__ void __launch_bounds__(kThreads)
chunk_scan_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ A, const bf16* __restrict__ Cm,
                  const float* __restrict__ Dskip,
                  const float* __restrict__ state_in,
                  const float* __restrict__ cbuf, bf16* __restrict__ y,
                  int S, int H, int P, int G, int N, int Q, int nc, int vec)
{
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int Q16 = up16(Q), P16 = up16(P), N16 = up16(N);
    const int ldx = P16 + 8, ldn = N16 + 8;
    bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // (Q16, ldx)
    bf16* cs = xs + Q16 * ldx;                      // (Q16, ldn)
    const int ldf = ld_split_f32(N16);
    float* st = reinterpret_cast<float*>(cs + Q16 * ldn);  // (P16, ldf) f32,
    const bf16* sh = reinterpret_cast<const bf16*>(st);    // then hi | lo
    const bf16* sl = sh + N16 + 8;                          // (row 2 ldf)
    float* cum = st + P16 * ldf;                    // then cum * log2(e)
    float* dts = cum + Q16;
    float* tot = dts + Q16;

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g8 = lane >> 2;
    const int h = blockIdx.x % H;
    const int bc = blockIdx.x / H;
    const int b = bc / nc, c = bc % nc;
    const int grp = h / (H / G);
    const int c0 = c * Q, L = min(Q, S - c0);

    const float d0 = first_dt(dt, b, S, H, h, c0, L);
    tc::stage_rows(xs, ldx, x + (((size_t)b * S + c0) * H + h) * P,
                   (size_t)H * P, Q16, L, P, P16, vec, tid, kThreads);
    const size_t bco = (((size_t)b * S + c0) * G + grp) * N;
    tc::stage_rows(cs, ldn, Cm + bco, (size_t)G * N, Q16, L, N, N16, vec, tid,
                   kThreads);
    if (c > 0)
        tc::stage_rows(st, ldf, state_in + ((size_t)bc * H + h) * P * N,
                       (size_t)N, P16, P, N, N16, vec, tid, kThreads);
    tc::cp_async_commit();
    chunk_cum(dt, d0, A[h], b, S, H, h, c0, L, Q16, dts, cum, tot);
    for (int i = tid; i < Q16; i += kThreads) cum[i] *= kLog2e;
    tc::cp_async_wait<0>();
    __syncthreads();
    if (c > 0) {
        // split the state once, row by row (a row is one warp's): read the
        // row's f32 values, then write hi over them and lo beside
        for (int p = warp; p < P16; p += kWarps) {
            float* row = st + p * ldf;
            float2 v[kMaxState / 64];
#pragma unroll
            for (int k = 0; k < kMaxState / 64; ++k) {
                const int col = 2 * (lane + 32 * k);
                if (col < N16) v[k] = *reinterpret_cast<const float2*>(row + col);
            }
            __syncwarp();
            bf16* hrow = reinterpret_cast<bf16*>(row);
#pragma unroll
            for (int k = 0; k < kMaxState / 64; ++k) {
                const int col = 2 * (lane + 32 * k);
                if (col >= N16) continue;
                unsigned hi, lo;
                tc::split_pack(v[k].x, v[k].y, hi, lo);
                *reinterpret_cast<unsigned*>(hrow + col) = hi;
                *reinterpret_cast<unsigned*>(hrow + N16 + 8 + col) = lo;
            }
        }
        __syncthreads();
    }

    const float Dh = Dskip != nullptr ? Dskip[h] : 0.f;
    const float* cbt = cbuf + ((size_t)bc * G + grp) * Q16 * Q16;
    const int RT = (L + 15) / 16;           // row tiles that hold rows < L
    const int nks = N16 / 16;
    for (int m = 0;; ++m) {
        const int rt = row_tile(m, warp);
        if (rt >= RT) break;
        const int i0 = rt * 16;
        const int ri[2] = {i0 + g8, i0 + g8 + 8};
        const float ci[2] = {cum[ri[0]], cum[ri[1]]};   // log2 units
        for (int pb = 0; pb < P16; pb += PT * 8) {
            float acc[PT][4];
#pragma unroll
            for (int i = 0; i < PT; ++i)
                acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
            if (c > 0) {                     // exp(cum_i) C_i . state_in^T
                for (int ks = 0; ks < nks; ++ks) {
                    unsigned a[4];
                    tc::load_a(a, cs, ldn, i0, ks * 16, lane);
#pragma unroll
                    for (int np = 0; np < PT / 2; ++np) {
                        if (pb + np * 16 >= P16) break;
                        unsigned hi[4], lo[4];
                        tc::load_b_nk(hi, sh, 2 * ldf, pb + np * 16, ks * 16, lane);
                        tc::load_b_nk(lo, sl, 2 * ldf, pb + np * 16, ks * 16, lane);
                        tc::mma(acc[2 * np], a, hi[0], hi[1]);
                        tc::mma(acc[2 * np + 1], a, hi[2], hi[3]);
                        tc::mma(acc[2 * np], a, lo[0], lo[1]);
                        tc::mma(acc[2 * np + 1], a, lo[2], lo[3]);
                    }
                }
                const float e0 = tc::ex2(ci[0]), e1 = tc::ex2(ci[1]);
#pragma unroll
                for (int i = 0; i < PT; ++i) {
                    acc[i][0] *= e0; acc[i][1] *= e0;
                    acc[i][2] *= e1; acc[i][3] *= e1;
                }
            }
            scan_tile<PT>(acc, cbt, cum, dts, xs, ldx, y, rt, pb, ri, ci, b, S,
                          c0, H, h, P, P16, L, Q16, Dh, lane);
        }
    }
}

// pass 3 above n kMaxState: the warps walk the rounds of row tiles in
// step, so that for each round and p block the block stages the round's C
// rows and the entering state's rows a slab of kSlab columns at a time
// (the state split into hi/lo in place, as in chunk_scan_kernel) and each
// warp adds the slab's exp(cum_i) C_i . state_in^T terms to its
// accumulators; then scan_tile as above
template <int PT>
__global__ void __launch_bounds__(kThreads)
chunk_scan_wide_kernel(const bf16* __restrict__ x,
                       const float* __restrict__ dt,
                       const float* __restrict__ A,
                       const bf16* __restrict__ Cm,
                       const float* __restrict__ Dskip,
                       const float* __restrict__ state_in,
                       const float* __restrict__ cbuf, bf16* __restrict__ y,
                       int S, int H, int P, int G, int N, int Q, int nc,
                       int vec)
{
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int Q16 = up16(Q), P16 = up16(P), N16 = up16(N);
    const int ldx = P16 + 8, lds = kSlab + 8, ldf = ld_split_f32(kSlab);
    bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // (Q16, ldx)
    bf16* cs = xs + Q16 * ldx;                      // (16 kWarps, lds)
    float* st = reinterpret_cast<float*>(cs + 16 * kWarps * lds);  // (PT 8,
    const bf16* sh = reinterpret_cast<const bf16*>(st);   // ldf) f32, then
    const bf16* sl = sh + kSlab + 8;                       // hi | lo
    float* cum = st + PT * 8 * ldf;                 // then cum * log2(e)
    float* dts = cum + Q16;
    float* tot = dts + Q16;

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g8 = lane >> 2;
    const int h = blockIdx.x % H;
    const int bc = blockIdx.x / H;
    const int b = bc / nc, c = bc % nc;
    const int grp = h / (H / G);
    const int c0 = c * Q, L = min(Q, S - c0);

    const float d0 = first_dt(dt, b, S, H, h, c0, L);
    tc::stage_rows(xs, ldx, x + (((size_t)b * S + c0) * H + h) * P,
                   (size_t)H * P, Q16, L, P, P16, vec, tid, kThreads);
    tc::cp_async_commit();
    chunk_cum(dt, d0, A[h], b, S, H, h, c0, L, Q16, dts, cum, tot);
    for (int i = tid; i < Q16; i += kThreads) cum[i] *= kLog2e;
    tc::cp_async_wait<0>();
    __syncthreads();

    const float Dh = Dskip != nullptr ? Dskip[h] : 0.f;
    const float* cbt = cbuf + ((size_t)bc * G + grp) * Q16 * Q16;
    const bf16* cb0 = Cm + (((size_t)b * S + c0) * G + grp) * N;
    const float* sb0 = state_in + ((size_t)bc * H + h) * P * N;
    const int RT = (L + 15) / 16;           // row tiles that hold rows < L
    for (int m = 0; m * kWarps < RT; ++m) {
        const int rt = row_tile(m, warp);
        const bool active = rt < RT;        // warp-uniform
        const int i0 = rt * 16, r_lo = m * 16 * kWarps;
        const int ri[2] = {i0 + g8, i0 + g8 + 8};
        const float ci[2] = {active ? cum[ri[0]] : 0.f,
                             active ? cum[ri[1]] : 0.f};   // log2 units
        for (int pb = 0; pb < P16; pb += PT * 8) {
            const int pr = min(PT * 8, P16 - pb);
            float acc[PT][4];
#pragma unroll
            for (int i = 0; i < PT; ++i)
                acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
            if (c > 0) {                     // exp(cum_i) C_i . state_in^T
                for (int n0 = 0; n0 < N16; n0 += kSlab) {
                    const int nw = min(kSlab, N16 - n0);
                    const int width = min(kSlab, N - n0);
                    __syncthreads();         // the last slab is consumed
                    tc::stage_rows(cs, lds, cb0 + (size_t)r_lo * G * N + n0,
                                   (size_t)G * N, 16 * kWarps, L - r_lo,
                                   width, nw, vec, tid, kThreads);
                    tc::stage_rows(st, ldf, sb0 + (size_t)pb * N + n0,
                                   (size_t)N, pr, P - pb, width, nw, vec, tid,
                                   kThreads);
                    tc::cp_async_commit();
                    tc::cp_async_wait<0>();
                    __syncthreads();
                    for (int p = warp; p < pr; p += kWarps) {
                        float* row = st + p * ldf;
                        float2 v[kSlab / 64];
#pragma unroll
                        for (int k = 0; k < kSlab / 64; ++k) {
                            const int col = 2 * (lane + 32 * k);
                            if (col < nw) v[k] = *reinterpret_cast<const float2*>(row + col);
                        }
                        __syncwarp();
                        bf16* hrow = reinterpret_cast<bf16*>(row);
#pragma unroll
                        for (int k = 0; k < kSlab / 64; ++k) {
                            const int col = 2 * (lane + 32 * k);
                            if (col >= nw) continue;
                            unsigned hi, lo;
                            tc::split_pack(v[k].x, v[k].y, hi, lo);
                            *reinterpret_cast<unsigned*>(hrow + col) = hi;
                            *reinterpret_cast<unsigned*>(hrow + kSlab + 8 + col) = lo;
                        }
                    }
                    __syncthreads();
                    if (!active) continue;
                    for (int ks = 0; ks < nw / 16; ++ks) {
                        unsigned a[4];
                        tc::load_a(a, cs, lds, i0 - r_lo, ks * 16, lane);
#pragma unroll
                        for (int np = 0; np < PT / 2; ++np) {
                            if (np * 16 >= pr) break;
                            unsigned hi[4], lo[4];
                            tc::load_b_nk(hi, sh, 2 * ldf, np * 16, ks * 16, lane);
                            tc::load_b_nk(lo, sl, 2 * ldf, np * 16, ks * 16, lane);
                            tc::mma(acc[2 * np], a, hi[0], hi[1]);
                            tc::mma(acc[2 * np + 1], a, hi[2], hi[3]);
                            tc::mma(acc[2 * np], a, lo[0], lo[1]);
                            tc::mma(acc[2 * np + 1], a, lo[2], lo[3]);
                        }
                    }
                }
                if (active) {
                    const float e0 = tc::ex2(ci[0]), e1 = tc::ex2(ci[1]);
#pragma unroll
                    for (int i = 0; i < PT; ++i) {
                        acc[i][0] *= e0; acc[i][1] *= e0;
                        acc[i][2] *= e1; acc[i][3] *= e1;
                    }
                }
            }
            if (active)
                scan_tile<PT>(acc, cbt, cum, dts, xs, ldx, y, rt, pb, ri, ci,
                              b, S, c0, H, h, P, P16, L, Q16, Dh, lane);
        }
    }
}

// The chunk and scan passes' launches; Wide: the slab kernels (n above
// kMaxState, pass 1 in slabs of kSlab columns)
template <int NT, bool Wide>
int pass1(const void* x, const float* dt, const float* A, const void* Bm,
          const void* Cm, float* s_loc, float* decay, float* cbuf, int Bsz,
          int S, int H, int P, int G, int N, int Q, int nc, int vec,
          cudaStream_t stream)
{
    static int allowed[64];
    const size_t smem = Wide ? smem_pass1_wide(Q, P) : smem_pass1(Q, P, N);
    const void* fn = Wide ? (const void*)chunk_state_wide_kernel
                          : (const void*)chunk_state_kernel<NT>;
    const cudaError_t e = tc::allow_smem(fn, smem, allowed);
    if (e != cudaSuccess) return (int)e;
    const int blocks = Bsz * nc * (G + H);
    if constexpr (Wide)
        chunk_state_wide_kernel<<<blocks, kThreads, smem, stream>>>(
            (const bf16*)x, dt, A, (const bf16*)Bm, (const bf16*)Cm, s_loc,
            decay, cbuf, S, H, P, G, N, Q, nc, vec);
    else
        chunk_state_kernel<NT><<<blocks, kThreads, smem, stream>>>(
            (const bf16*)x, dt, A, (const bf16*)Bm, (const bf16*)Cm, s_loc,
            decay, cbuf, S, H, P, G, N, Q, nc, vec);
    return (int)cudaGetLastError();
}

template <int PT, bool Wide>
int pass3(const void* x, const float* dt, const float* A, const void* Cm,
          const float* Dskip, const float* state_in, const float* cbuf,
          void* y, int Bsz, int S, int H, int P, int G, int N, int Q, int nc,
          int vec, cudaStream_t stream)
{
    static int allowed[64];
    const size_t smem = Wide ? smem_pass3_wide(Q, P) : smem_pass3(Q, P, N);
    const void* fn = Wide ? (const void*)chunk_scan_wide_kernel<PT>
                          : (const void*)chunk_scan_kernel<PT>;
    const cudaError_t e = tc::allow_smem(fn, smem, allowed);
    if (e != cudaSuccess) return (int)e;
    const int blocks = Bsz * nc * H;
    if constexpr (Wide)
        chunk_scan_wide_kernel<PT><<<blocks, kThreads, smem, stream>>>(
            (const bf16*)x, dt, A, (const bf16*)Cm, Dskip, state_in, cbuf,
            (bf16*)y, S, H, P, G, N, Q, nc, vec);
    else
        chunk_scan_kernel<PT><<<blocks, kThreads, smem, stream>>>(
            (const bf16*)x, dt, A, (const bf16*)Cm, Dskip, state_in, cbuf,
            (bf16*)y, S, H, P, G, N, Q, nc, vec);
    return (int)cudaGetLastError();
}

int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, const float* Dskip, void* y, float* state_out,
           float* s_loc, float* decay, float* cbuf, int Bsz, int S, int H,
           int P, int G, int N, int Q, cudaStream_t s)
{
    if (P == 0 || N == 0) return 0;
    const bool wide = N > kMaxState;
    const int nc = (S + Q - 1) / Q;
    const bool vec = P % 8 == 0 && N % 8 == 0
        && ((uintptr_t)x | (uintptr_t)Bm | (uintptr_t)Cm) % 16 == 0;
    int rc = 0;
    if (nc > 0) {
        const int nt = (up16(N) < kMaxTile ? up16(N) : kMaxTile) / 8;
        if (wide) {
            rc = pass1<kSlab / 8, true>(x, dt, A, Bm, Cm, s_loc, decay, cbuf,
                                        Bsz, S, H, P, G, N, Q, nc, vec, s);
        } else {
            switch (nt) {
#define CASE(V) case V: rc = pass1<V, false>(x, dt, A, Bm, Cm, s_loc, decay, \
                                             cbuf, Bsz, S, H, P, G, N, Q, nc, \
                                             vec, s); break;
                CASE(2) CASE(4) CASE(6) CASE(8) CASE(10) CASE(12) CASE(14)
                CASE(16)
#undef CASE
                default: rc = (int)cudaErrorInvalidValue;
            }
        }
        if (rc != 0) return rc;
    }
    const int PN = P * N;
    state_pass_kernel<<<dim3(Bsz * H, (PN + 255) / 256), 256, 0, s>>>(
        s_loc, decay, state_out, H, PN, nc);
    rc = (int)cudaGetLastError();
    if (rc != 0 || nc == 0) return rc;
    const int pt = (up16(P) < kMaxTile ? up16(P) : kMaxTile) / 8;
    switch (pt) {
#define CASE(V) case V: return wide                                            \
        ? pass3<V, true>(x, dt, A, Cm, Dskip, s_loc, cbuf, y, Bsz, S, H, P, G, \
                         N, Q, nc, vec, s)                                     \
        : pass3<V, false>(x, dt, A, Cm, Dskip, s_loc, cbuf, y, Bsz, S, H, P,  \
                          G, N, Q, nc, vec, s);
        CASE(2) CASE(4) CASE(6) CASE(8) CASE(10) CASE(12) CASE(14) CASE(16)
#undef CASE
    }
    return (int)cudaErrorInvalidValue;
}

}  // namespace bf16tc


// Shared memory a block takes for chunk Q, head width P and state N:
// dtype 0 (the f32 route's kernel: the same at every shape) or 1 (the
// larger of the bf16 route's chunk and scan passes, whole or in slabs).
extern "C" long long ssd_scan_smem_bytes(int Q, int P, int N, int dtype)
{
    if (dtype == 0) return (long long)f32::smem_bytes();
    const bool wide = N > bf16tc::kMaxState;
    const size_t a = wide ? bf16tc::smem_pass1_wide(Q, P)
                          : bf16tc::smem_pass1(Q, P, N);
    const size_t b = wide ? bf16tc::smem_pass3_wide(Q, P)
                          : bf16tc::smem_pass3(Q, P, N);
    return (long long)(a > b ? a : b);
}

// dtype (of x, B, C and y): 0 float32 (the f32 route: scr is its float32
// scratch, 3 Q floats a block of b * h * ceil(p / 32); s_loc,
// decay and cbuf null), 1 bfloat16 (the tensor-core route: the f32 scratch
// s_loc (b, nc, h, p, n), decay (b, nc, h) and cbuf (b, nc, g, Q16, Q16),
// nc = ceil(s / Q), Q16 = Q rounded up to 16; scr null). Dskip may be null
// (no skip connection).
extern "C" int ssd_scan_launch(const void* x, const float* dt, const float* A,
                               const void* Bm, const void* Cm,
                               const float* Dskip, void* y, float* state_out,
                               float* s_loc, float* decay, float* cbuf,
                               float* scr, int Bsz, int S, int H, int P,
                               int G, int N, int Q, int dtype, void* stream)
{
    if (Bsz == 0 || H == 0) return 0;
    if (G < 1 || H % G != 0 || Q < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    switch (dtype) {
        case 0: return f32::launch((const float*)x, dt, A, (const float*)Bm,
                                   (const float*)Cm, Dskip, (float*)y,
                                   state_out, scr, Bsz, S, H, P, G, N, Q, s);
        case 1:
            if (S > 0 && (s_loc == nullptr || decay == nullptr
                          || cbuf == nullptr))
                return (int)cudaErrorInvalidValue;
            return bf16tc::launch(x, dt, A, Bm, Cm, Dskip, y, state_out,
                                  s_loc, decay, cbuf, Bsz, S, H, P, G, N, Q,
                                  s);
    }
    return (int)cudaErrorInvalidValue;
}

extern "C" const char* ssd_scan_error_string(int e)
{
    return cudaGetErrorString((cudaError_t)e);
}
