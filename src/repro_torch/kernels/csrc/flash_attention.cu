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
// What bounds it here: at zamba2's prefill (B 4, S 512, 32 heads of 80)
//   the bytes of q, k, v and o (42 MB in bf16) take 0.013 ms at 3.35 TB/s
//   and the causal products (5.4 GFLOP) 0.005 ms on the bf16 tensor cores,
//   so the bound is memory. This kernel does its products on the float32
//   CUDA cores and reads both operands of every multiply-add from shared
//   memory, so the shared-memory load pipe sets its pace: about 0.97 ms at
//   that shape on an H100 (PERF.md), 77x the bound. Register tiles that
//   reuse each loaded value, or wgmma, are the remedy (later work).
//
// Design: one block of 8 warps per (batch * head, tile of 64 queries). The
//   query tile is staged once in shared memory in float32, pre-scaled. The
//   block walks 64-key tiles of K and V, staged in shared memory in float32
//   (K rows at an odd stride, so the 32 lanes reading 32 different keys hit
//   32 different banks). Each warp owns 8 query rows; for each row a lane
//   scores keys lane and lane + 32, the warp reduces max and sum with
//   shuffles, and the lane keeps the running output for dims lane + 32 t in
//   registers (t < DVT = ceil(Dv / 32)). Tiles that the causal mask or the
//   window hides from every query of the block are skipped; this changes no
//   visible row, since such a tile adds junk only to a row that has no
//   visible key yet and that junk is wiped by the next correction.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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

}  // namespace

// dtype: 0 float32, 1 bfloat16. window <= 0: none; softcap <= 0:
// none. D and Dv at most 256.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Sk, int Hq, int Hkv, int D, int Dv,
                                      int causal, int window, float softcap,
                                      float scale, int dtype, void* stream)
{
    if (B == 0 || Sq == 0) return 0;
    if (D < 1 || D > 256 || Dv < 1 || Dv > 256 || Hkv < 1 || Hq % Hkv != 0)
        return (int)cudaErrorInvalidValue;
    const int dvt = (Dv + 31) / 32;
    cudaStream_t s = (cudaStream_t)stream;
    switch (dtype) {
        case 0: return launch_dv<float>(dvt, q, k, v, o, B, Sq, Sk, Hq, Hkv, D,
                                        Dv, causal, window, softcap, scale, s);
        case 1: return launch_dv<__nv_bfloat16>(dvt, q, k, v, o, B, Sq, Sk, Hq,
                                                Hkv, D, Dv, causal, window,
                                                softcap, scale, s);
    }
    return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int e)
{
    return cudaGetErrorString((cudaError_t)e);
}
