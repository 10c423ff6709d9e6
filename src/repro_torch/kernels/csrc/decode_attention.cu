// Flash-decoding: one query token per sequence against its KV cache, CUDA
// for sm_90a.
//
// Replaces: the Pallas TPU kernel repro/kernels/decode_attention.py
//   decode_attention (_kernel). For q (B, Hq, D), caches k (B, S, Hkv, D)
//   and v (B, S, Hkv, Dv) in float32 or bfloat16, and kv_len (B,)
//   int32, it computes
//     o[b, h] = softmax_j(mask(softcap(q_bh . k_bj / sqrt(D)))) v_bj
//   in float32, o in q's type. Key j is visible when j < kv_len[b] and,
//   with a window, j > kv_len[b] - 1 - window. The rep = Hq / Hkv query
//   heads of a KV group share one pass over the cache.
//
// What bounds it here: memory. Each visible cache row is read once (at
//   zamba2's last step, 4 x 544 x 32 heads x 80 x 2 (k, v) x 2 bytes =
//   22 MB, 0.0067 ms at 3.35 TB/s) for 4 multiply-adds per element per
//   query head, far below any compute roof. With B = 4 the work is small,
//   so what the card does with it is mostly latency: 128 blocks of 8 warps.
//   Each lane reads its own key row, so one load instruction touches 32
//   rows; at that shape it takes about 0.053 ms on an H100 (PERF.md), 8x
//   the bound and below scaled_dot_product_attention's 0.090 ms.
//
// Design: one block of 8 warps per (batch, KV head, group of HB <= 8 query
//   heads of that KV head). The query heads are staged in shared memory,
//   pre-scaled, in float32. Only the visible key range [lo, kv_len) is
//   walked, in tiles of 32 keys dealt round-robin to the warps; a lane
//   scores one key for all HB heads, the warp reduces max and sum with
//   shuffles, and each lane keeps the running output for dims lane + 32 t
//   (t < DVT = ceil(Dv / 32)) of every head in registers. At the end the 8
//   warps' (m, l, acc) are merged through shared memory with the
//   log-sum-exp rule  M = max m_w,  L = sum l_w e^(m_w - M),
//   o = sum acc_w e^(m_w - M) / max(L, 1e-30)  (flash-decoding's merge).
//   Every tile a warp walks holds a visible key, so its running max is a
//   real score after the tile and masked keys get p = exp(-1e30 - m) = 0.
//   A sequence with kv_len 0 gets o = 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
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

template <typename T, int HB, int DVT>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ kv_len,
              T* __restrict__ o, int S, int Hq, int Hkv, int D, int Dv,
              int window, float softcap, float scale)
{
    extern __shared__ float smem[];
    float* qs = smem;                        // (HB, D)
    float* red = qs + HB * D;                // (kWarps, HB, Dv + 2)
    const int ldr = Dv + 2;

    const int b = blockIdx.x, hk = blockIdx.y;
    const int rep = Hq / Hkv;
    const int h0 = blockIdx.z * HB;          // first head of the group
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

    for (int e = threadIdx.x; e < HB * D; e += kThreads) {
        const int i = e / D, d = e - (e / D) * D;
        qs[e] = h0 + i < rep
            ? to_f(q[((size_t)b * Hq + hk * rep + h0 + i) * D + d]) * scale
            : 0.f;
    }
    __syncthreads();

    const int len = kv_len[b];
    const int hi = min(max(len, 0), S);
    const int lo = window > 0 ? max(0, len - window) : 0;

    float m[HB], l[HB], acc[HB][DVT];
#pragma unroll
    for (int i = 0; i < HB; ++i) {
        m[i] = kNegInf;
        l[i] = 0.f;
#pragma unroll
        for (int t = 0; t < DVT; ++t) acc[i][t] = 0.f;
    }

    for (int t0 = (lo / 32 + warp) * 32; t0 < hi; t0 += 32 * kWarps) {
        const int kpos = t0 + lane;
        const bool ok = kpos >= lo && kpos < hi;
        float s[HB];
#pragma unroll
        for (int i = 0; i < HB; ++i) s[i] = 0.f;
        if (ok) {
            const T* kr = k + (((size_t)b * S + kpos) * Hkv + hk) * D;
            for (int d = 0; d < D; ++d) {
                const float kd = to_f(kr[d]);
#pragma unroll
                for (int i = 0; i < HB; ++i) s[i] = fmaf(qs[i * D + d], kd, s[i]);
            }
        }
        float p[HB];
#pragma unroll
        for (int i = 0; i < HB; ++i) {
            float si = s[i];
            if (softcap > 0.f) si = softcap * tanhf(si / softcap);
            si = ok ? si : kNegInf;
            const float m_new = fmaxf(m[i], warp_max(si));
            p[i] = expf(si - m_new);
            const float corr = expf(m[i] - m_new);
            l[i] = l[i] * corr + warp_sum(p[i]);
            m[i] = m_new;
#pragma unroll
            for (int t = 0; t < DVT; ++t) acc[i][t] *= corr;
        }
        const int n = min(32, hi - t0);
        for (int j = 0; j < n; ++j) {
            if (t0 + j < lo) continue;       // uniform across the warp
            const T* vr = v + (((size_t)b * S + t0 + j) * Hkv + hk) * Dv;
            float vv[DVT];
#pragma unroll
            for (int t = 0; t < DVT; ++t) {
                const int d = lane + 32 * t;
                vv[t] = d < Dv ? to_f(vr[d]) : 0.f;
            }
#pragma unroll
            for (int i = 0; i < HB; ++i) {
                const float pj = __shfl_sync(kFull, p[i], j);
#pragma unroll
                for (int t = 0; t < DVT; ++t) acc[i][t] = fmaf(pj, vv[t], acc[i][t]);
            }
        }
    }

    // merge the warps' partial softmax states
#pragma unroll
    for (int i = 0; i < HB; ++i) {
        float* rw = red + (warp * HB + i) * ldr;
#pragma unroll
        for (int t = 0; t < DVT; ++t) {
            const int d = lane + 32 * t;
            if (d < Dv) rw[d] = acc[i][t];
        }
        if (lane == 0) {
            rw[Dv] = m[i];
            rw[Dv + 1] = l[i];
        }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < HB * Dv; e += kThreads) {
        const int i = e / Dv, d = e - (e / Dv) * Dv;
        if (h0 + i >= rep) continue;
        float M = kNegInf;
        for (int w = 0; w < kWarps; ++w) M = fmaxf(M, red[(w * HB + i) * ldr + Dv]);
        float L = 0.f, A = 0.f;
        for (int w = 0; w < kWarps; ++w) {
            const float* rw = red + (w * HB + i) * ldr;
            const float c = expf(rw[Dv] - M);
            L = fmaf(rw[Dv + 1], c, L);
            A = fmaf(rw[d], c, A);
        }
        o[((size_t)b * Hq + hk * rep + h0 + i) * Dv + d] =
            from_f<T>(A / fmaxf(L, 1e-30f));
    }
}

template <typename T, int HB, int DVT>
int launch_t(const void* q, const void* k, const void* v, const int* kv_len,
             void* o, int B, int S, int Hq, int Hkv, int D, int Dv, int window,
             float softcap, float scale, cudaStream_t stream)
{
    const size_t smem = sizeof(float) *
        ((size_t)HB * D + (size_t)kWarps * HB * (Dv + 2));
    cudaError_t e = cudaFuncSetAttribute(
        decode_kernel<T, HB, DVT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    const int rep = Hq / Hkv;
    const dim3 grid(B, Hkv, (rep + HB - 1) / HB);
    decode_kernel<T, HB, DVT><<<grid, kThreads, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, kv_len, (T*)o, S, Hq, Hkv, D,
        Dv, window, softcap, scale);
    return (int)cudaGetLastError();
}

template <typename T, int HB>
int launch_dv(int dvt, const void* q, const void* k, const void* v,
              const int* kv_len, void* o, int B, int S, int Hq, int Hkv, int D,
              int Dv, int window, float softcap, float scale, cudaStream_t s)
{
    switch (dvt) {
#define CASE(N) case N: return launch_t<T, HB, N>(q, k, v, kv_len, o, B, S, \
                                                  Hq, Hkv, D, Dv, window,   \
                                                  softcap, scale, s);
        CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    }
    return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_hb(int dvt, const void* q, const void* k, const void* v,
              const int* kv_len, void* o, int B, int S, int Hq, int Hkv, int D,
              int Dv, int window, float softcap, float scale, cudaStream_t s)
{
    const int rep = Hq / Hkv;
    if (rep == 1) return launch_dv<T, 1>(dvt, q, k, v, kv_len, o, B, S, Hq, Hkv, D, Dv, window, softcap, scale, s);
    if (rep == 2) return launch_dv<T, 2>(dvt, q, k, v, kv_len, o, B, S, Hq, Hkv, D, Dv, window, softcap, scale, s);
    if (rep <= 4) return launch_dv<T, 4>(dvt, q, k, v, kv_len, o, B, S, Hq, Hkv, D, Dv, window, softcap, scale, s);
    return launch_dv<T, 8>(dvt, q, k, v, kv_len, o, B, S, Hq, Hkv, D, Dv, window, softcap, scale, s);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. window <= 0: none; softcap <= 0:
// none. D and Dv at most 256.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const int* kv_len,
                                       void* o, int B, int S, int Hq, int Hkv,
                                       int D, int Dv, int window,
                                       float softcap, float scale, int dtype,
                                       void* stream)
{
    if (B == 0) return 0;
    if (D < 1 || D > 256 || Dv < 1 || Dv > 256 || Hkv < 1 || Hq % Hkv != 0)
        return (int)cudaErrorInvalidValue;
    const int dvt = (Dv + 31) / 32;
    cudaStream_t s = (cudaStream_t)stream;
    switch (dtype) {
        case 0: return launch_hb<float>(dvt, q, k, v, kv_len, o, B, S, Hq, Hkv,
                                        D, Dv, window, softcap, scale, s);
        case 1: return launch_hb<__nv_bfloat16>(dvt, q, k, v, kv_len, o, B, S,
                                                Hq, Hkv, D, Dv, window,
                                                softcap, scale, s);
    }
    return (int)cudaErrorInvalidValue;
}

extern "C" const char* decode_attention_error_string(int e)
{
    return cudaGetErrorString((cudaError_t)e);
}
