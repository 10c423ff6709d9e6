// Flash attention (forward, online softmax) for prefill, CUDA for sm_90a.
//
// Replaces: the Pallas TPU kernel repro/kernels/flash_attention.py
//   flash_attention (_kernel). For q (B, Sq, Hq, D), k (B, Sk, Hkv, D) and
//   v (B, Sk, Hkv, Dv) in float32 or bfloat16 it computes
//     o[b, i, h] = softmax_j(mask(softcap(q_i . k_j / sqrt(D)))) v_j
//   with float32 math and o in q's type. Query head h reads key/value head
//   h / (Hq / Hkv) (GQA). Queries sit at the end of the keys: query i has
//   position i + Sk - Sq. With `causal`, key j is visible when j <= pos_i
//   and, with a window, j > pos_i - window. Masked scores are -1e30, not
//   -inf, as on the TPU: a row whose tile is fully masked takes junk p = 1
//   that the next tile's correction exp(-1e30 - m) = 0 wipes out, where
//   -inf would give exp(-inf + inf) = NaN.
//
// Two routes, chosen by dtype (not a fallback: each dtype has one route).
//
// bfloat16, tensor cores (namespace bf16tc; the prefill and training
//   route). What bounds it: at zamba2's prefill (B 4, S 512, 32 heads of
//   80, causal) the bytes of q, k, v and o (42 MB) take 0.0125 ms at
//   3.35 TB/s and the causal products (5.4 GFLOP) 0.005 ms at the bf16
//   tensor-core peak, so memory and latency bound it; mma.sync's rate is
//   far above what this needs, so the design aims at feeding it. FA2's
//   design on mma.sync.m16n8k16 (bf16 in, f32 accumulate): one block of 4
//   warps per (batch * head, 64 queries), q-tiles with the most keys
//   launched first. Each warp owns 16 query rows. Their Q fragments are
//   loaded once into registers with ldmatrix for heads up to 64 wide, and
//   read again from shared memory per tile above that: zamba2's 80 then
//   takes 128 registers, so four blocks share an SM (faster on the card
//   than Q in registers with three), 128 stays free of spills and 256
//   within 255 registers. (32 rows a warp, so that each K
//   and V fragment feeds two products, measured slower: 222 registers
//   leave two blocks an SM.) K and V
//   tiles of 64 keys are staged in bf16 by 16-byte cp.async into a ring of
//   two stages, so the next tile's copy overlaps this tile's math; rows
//   are padded to an odd number of 16-byte units, so ldmatrix (K) and
//   ldmatrix.trans (V) are free of bank conflicts. S = Q.K^T on the tensor
//   cores, then in f32 registers: x 1/sqrt(D), softcap, the -1e30 mask
//   (only on tiles that cross a mask edge), the online max and sum across
//   the quad of lanes that share a row, in log2 units so that each exp is
//   one ex2. P is rounded to bf16 in registers
//   and used directly as the A operand of P.V; O stays in f32 registers
//   and is divided once at the end. Head widths are template buckets of
//   multiples of 16 (max(D, Dv) rounded up; zamba2's 80 is 5 k-steps and
//   10 n-tiles), zero-padded in shared memory only. D or Dv not a multiple
//   of 8, or a base pointer off the 16-byte grid, stages through plain
//   loads instead of cp.async (the same kernel otherwise). Tiles that the
//   causal mask or the window hides from every query of the block are
//   skipped.
//
// float32, CUDA cores (namespace f32; the CUDA-core kernel as it was): one
//   block of 8 warps per (batch * head, tile of 64 queries). The query
//   tile is staged once in shared memory in float32, pre-scaled. The
//   block walks 64-key tiles of K and V, staged in shared memory in float32
//   (K rows at an odd stride, so the 32 lanes reading 32 different keys hit
//   32 different banks). Each warp owns 8 query rows; for each row a lane
//   scores keys lane and lane + 32, the warp reduces max and sum with
//   shuffles, and the lane keeps the running output for dims lane + 32 t in
//   registers (t < DVT = ceil(Dv / 32)). Its products run on the float32
//   CUDA cores with both operands read from shared memory; it is the
//   float32 check route, not a speed path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_common.cuh"

namespace f32 {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;                      // queries per block
constexpr int kBK = 64;                      // keys per tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kBQ / kWarps;          // query rows per warp
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ float warp_max(float v) {
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
    return v;
}
__device__ __forceinline__ float warp_sum(float v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
    return v;
}

template <typename T, int DVT>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o,
             int Sq, int Sk, int Hq, int Hkv, int D, int Dv,
             int causal, int window, float softcap, float scale)
{
    extern __shared__ float smem[];
    const int ldk = D | 1;
    float* qs = smem;                        // (kBQ, D)
    float* ks = qs + kBQ * D;                // (kBK, ldk)
    float* vs = ks + kBK * ldk;              // (kBK, Dv)

    const int bh = blockIdx.x;
    const int b = bh / Hq, h = bh % Hq;
    const int hk = h / (Hq / Hkv);
    const int q0 = blockIdx.y * kBQ;
    const int offset = Sk - Sq;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

    for (int e = threadIdx.x; e < kBQ * D; e += kThreads) {
        const int i = e / D, d = e - (e / D) * D, qi = q0 + i;
        qs[e] = qi < Sq
            ? to_f(q[(((size_t)b * Sq + qi) * Hq + h) * D + d]) * scale : 0.f;
    }

    float m[kRows], l[kRows], acc[kRows][DVT];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
        m[r] = kNegInf;
        l[r] = 0.f;
#pragma unroll
        for (int t = 0; t < DVT; ++t) acc[r][t] = 0.f;
    }

    // keys that some query of this tile can see
    int k_lo = 0, k_hi = Sk;
    if (causal) {
        k_hi = min(Sk, min(q0 + kBQ, Sq) + offset);
        if (window > 0) k_lo = max(0, q0 + offset - window + 1);
    }

    for (int k0 = (k_lo / kBK) * kBK; k0 < k_hi; k0 += kBK) {
        __syncthreads();                     // the previous tile is consumed
        for (int e = threadIdx.x; e < kBK * D; e += kThreads) {
            const int j = e / D, d = e - (e / D) * D, kj = k0 + j;
            ks[j * ldk + d] = kj < Sk
                ? to_f(k[(((size_t)b * Sk + kj) * Hkv + hk) * D + d]) : 0.f;
        }
        for (int e = threadIdx.x; e < kBK * Dv; e += kThreads) {
            const int j = e / Dv, d = e - (e / Dv) * Dv, kj = k0 + j;
            vs[e] = kj < Sk
                ? to_f(v[(((size_t)b * Sk + kj) * Hkv + hk) * Dv + d]) : 0.f;
        }
        __syncthreads();

#pragma unroll
        for (int r = 0; r < kRows; ++r) {
            const int i = warp * kRows + r;
            const int qpos = q0 + i + offset;
            const float* qr = qs + i * D;
            float p[2];
#pragma unroll
            for (int c = 0; c < 2; ++c) {
                const int j = lane + 32 * c;
                const float* kr = ks + j * ldk;
                float s = 0.f;
                for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
                if (softcap > 0.f) s = softcap * tanhf(s / softcap);
                const int kpos = k0 + j;
                bool ok = kpos < Sk;
                if (causal) {
                    ok = ok && kpos <= qpos;
                    if (window > 0) ok = ok && kpos > qpos - window;
                }
                p[c] = ok ? s : kNegInf;
            }
            const float m_new = fmaxf(m[r], warp_max(fmaxf(p[0], p[1])));
            p[0] = expf(p[0] - m_new);
            p[1] = expf(p[1] - m_new);
            const float corr = expf(m[r] - m_new);
            l[r] = l[r] * corr + warp_sum(p[0] + p[1]);
            m[r] = m_new;
#pragma unroll
            for (int t = 0; t < DVT; ++t) acc[r][t] *= corr;
#pragma unroll
            for (int c = 0; c < 2; ++c) {
#pragma unroll 4
                for (int jj = 0; jj < 32; ++jj) {
                    const float pj = __shfl_sync(kFull, p[c], jj);
                    const float* vr = vs + (32 * c + jj) * Dv;
#pragma unroll
                    for (int t = 0; t < DVT; ++t) {
                        const int d = lane + 32 * t;
                        if (d < Dv) acc[r][t] = fmaf(pj, vr[d], acc[r][t]);
                    }
                }
            }
        }
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
        const int qi = q0 + warp * kRows + r;
        if (qi >= Sq) continue;
        const float den = fmaxf(l[r], 1e-30f);
        T* orow = o + (((size_t)b * Sq + qi) * Hq + h) * Dv;
#pragma unroll
        for (int t = 0; t < DVT; ++t) {
            const int d = lane + 32 * t;
            if (d < Dv) orow[d] = from_f<T>(acc[r][t] / den);
        }
    }
}

template <typename T, int DVT>
int launch_t(const void* q, const void* k, const void* v, void* o, int B,
             int Sq, int Sk, int Hq, int Hkv, int D, int Dv, int causal,
             int window, float softcap, float scale, cudaStream_t stream)
{
    const size_t smem = sizeof(float) *
        ((size_t)kBQ * D + (size_t)kBK * (D | 1) + (size_t)kBK * Dv);
    cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<T, DVT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid(B * Hq, (Sq + kBQ - 1) / kBQ);
    flash_kernel<T, DVT><<<grid, kThreads, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)o, Sq, Sk, Hq, Hkv, D, Dv,
        causal, window, softcap, scale);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_dv(int dvt, const void* q, const void* k, const void* v, void* o,
              int B, int Sq, int Sk, int Hq, int Hkv, int D, int Dv,
              int causal, int window, float softcap, float scale,
              cudaStream_t s)
{
    switch (dvt) {
#define CASE(N) case N: return launch_t<T, N>(q, k, v, o, B, Sq, Sk, Hq, Hkv, \
                                              D, Dv, causal, window, softcap, \
                                              scale, s);
        CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    }
    return (int)cudaErrorInvalidValue;
}

}  // namespace f32

namespace bf16tc {

using tc::bf16;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBQ = 64;                      // queries per block
constexpr int kBK = 64;                      // keys per tile
constexpr int kWarps = 4;                    // 16 query rows each
constexpr int kThreads = kWarps * 32;

template <int W>                             // bucket of D and Dv, % 16 == 0
struct Shape {
    static constexpr int LD = W + 8;         // row stride (bf16) in smem
    static constexpr int KS = W / 16;        // k-steps of D, n-tile pairs of Dv
    static constexpr bool kQRegs = W <= 64;  // Q kept in registers (above
                                             // 64 it costs an SM a block)
    static constexpr int kTile = kBK * LD;
    static constexpr size_t kSmem = sizeof(bf16) * ((size_t)kBQ * LD + 4 * (size_t)kTile);
};

template <int W>
__global__ void __launch_bounds__(kThreads)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o,
                int Sq, int Sk, int Hq, int Hkv, int D, int Dv,
                int causal, int window, float softcap, float scale, int vec)
{
    using S = Shape<W>;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* qs = reinterpret_cast<bf16*>(smem_raw);     // (kBQ, LD)
    bf16* ks = qs + kBQ * S::LD;                        // 2 x (kBK, LD)
    bf16* vs = ks + 2 * S::kTile;                       // 2 x (kBK, LD)

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int bh = blockIdx.x;
    const int b = bh / Hq, h = bh % Hq;
    const int hk = h / (Hq / Hkv);
    const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // most keys first
    const int offset = Sk - Sq;

    const size_t qstride = (size_t)Hq * D, kstride = (size_t)Hkv * D,
                 vstride = (size_t)Hkv * Dv;
    const bf16* qb = q + ((size_t)b * Sq + q0) * qstride + (size_t)h * D;
    const bf16* kb = k + (size_t)b * Sk * kstride + (size_t)hk * D;
    const bf16* vb = v + (size_t)b * Sk * vstride + (size_t)hk * Dv;

    // keys that some query of this tile can see
    int k_lo = 0, k_hi = Sk;
    if (causal) {
        k_hi = min(Sk, min(q0 + kBQ, Sq) + offset);
        if (window > 0) k_lo = max(0, q0 + offset - window + 1);
    }
    const int t0 = k_lo / kBK;
    const int n_tiles = k_hi > 0 ? max(0, (k_hi + kBK - 1) / kBK - t0) : 0;

    auto stage_kv = [&](int tile, int st) {
        const int k0 = (t0 + tile) * kBK;
        tc::stage_rows(ks + st * S::kTile, S::LD, kb + (size_t)k0 * kstride,
                       kstride, kBK, Sk - k0, D, W, vec, tid, kThreads);
        tc::stage_rows(vs + st * S::kTile, S::LD, vb + (size_t)k0 * vstride,
                       vstride, kBK, Sk - k0, Dv, W, vec, tid, kThreads);
    };
    tc::stage_rows(qs, S::LD, qb, qstride, kBQ, Sq - q0, D, W, vec, tid,
                   kThreads);
    if (n_tiles > 0) stage_kv(0, 0);
    tc::cp_async_commit();

    const int kst = (D + 15) / 16;          // k-steps that D needs
    const int nvp = (Dv + 15) / 16;         // n-tile pairs that Dv needs
    const int r0 = warp * 16;               // this warp's rows in the tile
    const int qpos0 = q0 + r0 + g + offset, qpos1 = qpos0 + 8;
    // scores are kept in log2 units: x 1/sqrt(D) log2(e), so that
    // exp(s - m) is one ex2 of a difference
    const float scale2 = scale * kLog2e;

    unsigned qf[S::kQRegs ? S::KS : 1][4];
    float oacc[2 * S::KS][4];
#pragma unroll
    for (int i = 0; i < 2 * S::KS; ++i)
        oacc[i][0] = oacc[i][1] = oacc[i][2] = oacc[i][3] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

    for (int it = 0; it < n_tiles; ++it) {
        const int st = it & 1;
        const int k0 = (t0 + it) * kBK;
        tc::cp_async_wait<0>();              // this tile (and Q) landed
        __syncthreads();                     // ... and every warp is done
        if (it + 1 < n_tiles)                // with the other stage: refill
            stage_kv(it + 1, st ^ 1);
        tc::cp_async_commit();
        const bf16* kt = ks + st * S::kTile;
        const bf16* vt = vs + st * S::kTile;

        if (S::kQRegs && it == 0) {
#pragma unroll
            for (int kk = 0; kk < S::KS; ++kk)
                if (kk < kst) tc::load_a(qf[S::kQRegs ? kk : 0], qs, S::LD, r0, kk * 16, lane);
        }

        // S = Q . K^T: 16 rows x 64 keys per warp, 8 n-tiles
        float s[8][4];
#pragma unroll
        for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < S::KS; ++kk) {
            if (kk >= kst) break;
            unsigned a[4];
            if (S::kQRegs) {
#pragma unroll
                for (int r = 0; r < 4; ++r) a[r] = qf[S::kQRegs ? kk : 0][r];
            } else {
                tc::load_a(a, qs, S::LD, r0, kk * 16, lane);
            }
#pragma unroll
            for (int np = 0; np < 4; ++np) {
                unsigned bb[4];
                tc::load_b_nk(bb, kt, S::LD, np * 16, kk * 16, lane);
                tc::mma(s[2 * np], a, bb[0], bb[1]);
                tc::mma(s[2 * np + 1], a, bb[2], bb[3]);
            }
        }

        // scale, softcap, mask (only where a mask edge crosses the tile)
        const bool full = k0 + kBK <= Sk
            && (!causal || (k0 + kBK - 1 <= q0 + offset
                            && (window <= 0
                                || k0 > q0 + kBQ - 1 + offset - window)));
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                float x;
                if (softcap > 0.f)
                    x = softcap * tanhf(s[n][e] * scale / softcap) * kLog2e;
                else
                    x = s[n][e] * scale2;
                if (!full) {
                    const int kpos = k0 + n * 8 + 2 * t + (e & 1);
                    const int qpos = e < 2 ? qpos0 : qpos1;
                    bool ok = kpos < Sk;
                    if (causal) {
                        ok = ok && kpos <= qpos;
                        if (window > 0) ok = ok && kpos > qpos - window;
                    }
                    if (!ok) x = kNegInf;
                }
                s[n][e] = x;
            }
        }

        // online softmax; the four lanes of a quad share rows g and g + 8
        float mx0 = m0, mx1 = m1;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
            mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
            mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
        }
#pragma unroll
        for (int o_ = 1; o_ <= 2; o_ <<= 1) {
            mx0 = fmaxf(mx0, __shfl_xor_sync(tc::kFull, mx0, o_));
            mx1 = fmaxf(mx1, __shfl_xor_sync(tc::kFull, mx1, o_));
        }
        const float c0 = tc::ex2(m0 - mx0), c1 = tc::ex2(m1 - mx1);
        m0 = mx0;
        m1 = mx1;
        float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
            s[n][0] = tc::ex2(s[n][0] - m0);
            s[n][1] = tc::ex2(s[n][1] - m0);
            s[n][2] = tc::ex2(s[n][2] - m1);
            s[n][3] = tc::ex2(s[n][3] - m1);
            rs0 += s[n][0] + s[n][1];
            rs1 += s[n][2] + s[n][3];
        }
        l0 = l0 * c0 + rs0;                  // per-lane partial sums
        l1 = l1 * c1 + rs1;
#pragma unroll
        for (int n = 0; n < 2 * S::KS; ++n) {
            oacc[n][0] *= c0; oacc[n][1] *= c0;
            oacc[n][2] *= c1; oacc[n][3] *= c1;
        }

        // O += P . V, P from the S registers as bf16 A fragments
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            unsigned a[4];
            a[0] = tc::pack_bf16(s[2 * kk][0], s[2 * kk][1]);
            a[1] = tc::pack_bf16(s[2 * kk][2], s[2 * kk][3]);
            a[2] = tc::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
            a[3] = tc::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
            for (int np = 0; np < S::KS; ++np) {
                if (np >= nvp) break;
                unsigned bb[4];
                tc::load_b_kn(bb, vt, S::LD, kk * 16, np * 16, lane);
                tc::mma(oacc[2 * np], a, bb[0], bb[1]);
                tc::mma(oacc[2 * np + 1], a, bb[2], bb[3]);
            }
        }
    }
    tc::cp_async_wait<0>();

#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
        l0 += __shfl_xor_sync(tc::kFull, l0, o_);
        l1 += __shfl_xor_sync(tc::kFull, l1, o_);
    }
    const float inv[2] = {1.f / fmaxf(l0, 1e-30f), 1.f / fmaxf(l1, 1e-30f)};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int qi = q0 + r0 + g + 8 * half;
        if (qi >= Sq) continue;
        bf16* orow = o + (((size_t)b * Sq + qi) * Hq + h) * Dv;
#pragma unroll
        for (int n = 0; n < 2 * S::KS; ++n) {
            const int d = n * 8 + 2 * t;
            if (d >= Dv) continue;
            const float y0 = oacc[n][2 * half] * inv[half];
            const float y1 = oacc[n][2 * half + 1] * inv[half];
            if ((Dv & 1) == 0) {
                *reinterpret_cast<__nv_bfloat162*>(orow + d) =
                    __floats2bfloat162_rn(y0, y1);
            } else {
                orow[d] = __float2bfloat16_rn(y0);
                if (d + 1 < Dv) orow[d + 1] = __float2bfloat16_rn(y1);
            }
        }
    }
}

template <int W>
int launch_w(const void* q, const void* k, const void* v, void* o, int B,
             int Sq, int Sk, int Hq, int Hkv, int D, int Dv, int causal,
             int window, float softcap, float scale, cudaStream_t stream)
{
    static int allowed[64];
    const size_t smem = Shape<W>::kSmem;
    const cudaError_t e = tc::allow_smem((const void*)flash_tc_kernel<W>,
                                         smem, allowed);
    if (e != cudaSuccess) return (int)e;
    const bool vec = D % 8 == 0 && Dv % 8 == 0
        && ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 == 0;
    const dim3 grid(B * Hq, (Sq + kBQ - 1) / kBQ);
    flash_tc_kernel<W><<<grid, kThreads, smem, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, Sq, Sk,
        Hq, Hkv, D, Dv, causal, window, softcap, scale, (int)vec);
    return (int)cudaGetLastError();
}

#define FLASH_BUCKETS(CASE) \
    CASE(16) CASE(32) CASE(48) CASE(64) CASE(80) CASE(96) CASE(128) \
    CASE(160) CASE(192) CASE(256)

int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int Hq, int Hkv, int D, int Dv, int causal,
           int window, float softcap, float scale, cudaStream_t s)
{
    const int w = ((D > Dv ? D : Dv) + 15) / 16 * 16;
#define CASE(W) if (w <= W) return launch_w<W>(q, k, v, o, B, Sq, Sk, Hq, \
        Hkv, D, Dv, causal, window, softcap, scale, s);
    FLASH_BUCKETS(CASE)
#undef CASE
    return (int)cudaErrorInvalidValue;
}

size_t smem_bytes(int D, int Dv)
{
    const int w = ((D > Dv ? D : Dv) + 15) / 16 * 16;
#define CASE(W) if (w <= W) return Shape<W>::kSmem;
    FLASH_BUCKETS(CASE)
#undef CASE
    return 0;
}

}  // namespace bf16tc


// dtype: 0 float32 (the f32 route), 1 bfloat16 (the tensor-core route).
// window <= 0: none; softcap <= 0: none. D and Dv at most 256.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Sk, int Hq, int Hkv, int D, int Dv,
                                      int causal, int window, float softcap,
                                      float scale, int dtype, void* stream)
{
    if (B == 0 || Sq == 0) return 0;
    if (D < 1 || D > 256 || Dv < 1 || Dv > 256 || Hkv < 1 || Hq % Hkv != 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    switch (dtype) {
        case 0: return f32::launch_dv<float>((Dv + 31) / 32, q, k, v, o, B,
                                             Sq, Sk, Hq, Hkv, D, Dv, causal,
                                             window, softcap, scale, s);
        case 1: return bf16tc::launch(q, k, v, o, B, Sq, Sk, Hq, Hkv, D, Dv,
                                      causal, window, softcap, scale, s);
    }
    return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one block for head widths D and Dv: dtype 0
// (the f32 route) or 1 (the bf16 route).
extern "C" long long flash_attention_smem_bytes(int D, int Dv, int dtype)
{
    if (dtype == 1) return (long long)bf16tc::smem_bytes(D, Dv);
    return (long long)(sizeof(float) * ((size_t)f32::kBQ * D
                                        + (size_t)f32::kBK * (D | 1)
                                        + (size_t)f32::kBK * Dv));
}

extern "C" const char* flash_attention_error_string(int e)
{
    return cudaGetErrorString((cudaError_t)e);
}
