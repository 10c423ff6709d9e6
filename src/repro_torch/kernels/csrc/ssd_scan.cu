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
//   neither decay nor feed the state. The chunk axis is sequential: the
//   TPU carried the state in VMEM scratch across grid steps.
//
// What bounds it here: at zamba2's prefill (b 4, s 512, 80 heads of p 64,
//   n 64, chunk 128) the bytes (x and y 21 MB each in bf16, the final
//   state 5.2 MB, B, C and dt 1.2 MB) take 0.015 ms at 3.35 TB/s; the four
//   contractions per chunk (5.4 GFLOP) take 0.005 ms on the bf16 tensor
//   cores. This kernel runs them on the float32 CUDA cores with both
//   operands of each multiply-add read from shared memory, so the
//   shared-memory load pipe sets its pace: about 1.4 ms at that shape on an
//   H100 (PERF.md), 97x the bound, with 320 blocks for 132 SMs. Register
//   tiles or wgmma, and splitting a (batch, head) over more blocks, are the
//   remedies (later work).
//
// Design: one block of 256 threads per (batch, head) loops over the chunks
//   itself, keeping the (p, n) state in shared memory in float32 (16 KB at
//   64 x 64). Per chunk it stages x (Q, p), B (Q, n) and dt, forms cum with
//   one thread (Q adds, in order), then walks the chunk's rows in tiles of
//   32: it stages those rows of C, forms the tile's (32, Q) weights
//   W_ij = (C_i . B_j) exp(cum_i - cum_j) dt_j for j <= i only (exp of
//   cum_i - cum_j overflows for j > i, and inf * 0 would be NaN), and
//   writes y for the tile. Then every thread updates its share of the
//   state. Rows of B and of the state sit at an odd stride so that lanes
//   reading 32 neighbouring rows hit 32 banks. At p = n = 64 and Q = 128
//   a block takes 106 KB of shared memory, so two blocks share an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRT = 32;                      // chunk rows per y tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

size_t smem_floats(int Q, int P, int N)
{
    const int ldn = N | 1;
    return (size_t)Q * P + (size_t)Q * ldn + (size_t)kRT * N + (size_t)kRT * Q
         + (size_t)P * ldn + 3 * (size_t)Q;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const T* __restrict__ Bm,
           const T* __restrict__ Cm, const float* __restrict__ Dskip,
           T* __restrict__ y, float* __restrict__ state_out,
           int S, int H, int P, int G, int N, int Q)
{
    extern __shared__ float smem[];
    const int ldn = N | 1;
    float* xs = smem;                        // (Q, P)
    float* bs = xs + Q * P;                  // (Q, ldn)
    float* cs = bs + Q * ldn;                // (kRT, N)
    float* ws = cs + kRT * N;                // (kRT, Q)
    float* st = ws + kRT * Q;                // (P, ldn)
    float* cum = st + P * ldn;               // (Q,)
    float* dts = cum + Q;                    // (Q,)
    float* dec = dts + Q;                    // (Q,) exp(cum_last - cum_j) dt_j

    const int b = blockIdx.x / H, h = blockIdx.x % H;
    const int g = h / (H / G);
    const float Ah = A[h];
    const float Dh = Dskip != nullptr ? Dskip[h] : 0.f;

    for (int e = threadIdx.x; e < P * N; e += kThreads)
        st[(e / N) * ldn + e % N] = 0.f;

    for (int c0 = 0; c0 < S; c0 += Q) {
        __syncthreads();                     // the previous chunk is consumed
        for (int e = threadIdx.x; e < Q * P; e += kThreads) {
            const int i = e / P, t = c0 + i;
            xs[e] = t < S ? to_f(x[(((size_t)b * S + t) * H + h) * P + e % P]) : 0.f;
        }
        for (int e = threadIdx.x; e < Q * N; e += kThreads) {
            const int i = e / N, t = c0 + i;
            bs[i * ldn + e % N] = t < S
                ? to_f(Bm[(((size_t)b * S + t) * G + g) * N + e % N]) : 0.f;
        }
        for (int i = threadIdx.x; i < Q; i += kThreads)
            dts[i] = c0 + i < S ? dt[((size_t)b * S + c0 + i) * H + h] : 0.f;
        __syncthreads();
        if (threadIdx.x == 0) {
            float run = 0.f;
            for (int i = 0; i < Q; ++i) {
                run += dts[i] * Ah;
                cum[i] = run;
            }
        }
        __syncthreads();
        const float cl = cum[Q - 1];
        for (int i = threadIdx.x; i < Q; i += kThreads)
            dec[i] = expf(cl - cum[i]) * dts[i];

        for (int r0 = 0; r0 < Q && c0 + r0 < S; r0 += kRT) {
            __syncthreads();                 // the previous tile is consumed
            for (int e = threadIdx.x; e < kRT * N; e += kThreads) {
                const int i = e / N, t = c0 + r0 + i;
                cs[e] = (r0 + i < Q && t < S)
                    ? to_f(Cm[(((size_t)b * S + t) * G + g) * N + e % N]) : 0.f;
            }
            __syncthreads();
            const int wc = min(Q, r0 + kRT);     // columns a row of the tile uses
            for (int e = threadIdx.x; e < kRT * wc; e += kThreads) {
                const int i = e / wc, j = e - (e / wc) * wc, row = r0 + i;
                float w = 0.f;
                if (j <= row && row < Q) {
                    const float* ci = cs + i * N;
                    const float* bj = bs + j * ldn;
                    float dot = 0.f;
                    for (int n = 0; n < N; ++n) dot = fmaf(ci[n], bj[n], dot);
                    w = dot * expf(cum[row] - cum[j]) * dts[j];
                }
                ws[i * Q + j] = w;
            }
            __syncthreads();
            for (int e = threadIdx.x; e < kRT * P; e += kThreads) {
                const int i = e / P, p = e - (e / P) * P, row = r0 + i;
                if (row >= Q || c0 + row >= S) continue;
                const float* wi = ws + i * Q;
                float intra = 0.f;
                for (int j = 0; j <= row; ++j) intra = fmaf(wi[j], xs[j * P + p], intra);
                const float* ci = cs + i * N;
                const float* sp = st + p * ldn;
                float inter = 0.f;
                for (int n = 0; n < N; ++n) inter = fmaf(ci[n], sp[n], inter);
                const float yv = intra + inter * expf(cum[row]) + xs[row * P + p] * Dh;
                y[(((size_t)b * S + c0 + row) * H + h) * P + p] = from_f<T>(yv);
            }
        }
        __syncthreads();                     // y is done with the old state
        const float ecl = expf(cl);
        for (int e = threadIdx.x; e < P * N; e += kThreads) {
            const int p = e / N, n = e - (e / N) * N;
            float acc = 0.f;
            for (int j = 0; j < Q; ++j)
                acc = fmaf(xs[j * P + p], dec[j] * bs[j * ldn + n], acc);
            st[p * ldn + n] = ecl * st[p * ldn + n] + acc;
        }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < P * N; e += kThreads)
        state_out[((size_t)blockIdx.x * P + e / N) * N + e % N] =
            st[(e / N) * ldn + e % N];
}

template <typename T>
int launch_t(const void* x, const float* dt, const float* A, const void* Bm,
             const void* Cm, const float* Dskip, void* y, float* state_out,
             int Bsz, int S, int H, int P, int G, int N, int Q,
             cudaStream_t stream)
{
    const size_t smem = sizeof(float) * smem_floats(Q, P, N);
    cudaError_t e = cudaFuncSetAttribute(
        ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    ssd_kernel<T><<<Bsz * H, kThreads, smem, stream>>>(
        (const T*)x, dt, A, (const T*)Bm, (const T*)Cm, Dskip, (T*)y,
        state_out, S, H, P, G, N, Q);
    return (int)cudaGetLastError();
}

}  // namespace

// Shared memory the kernel takes for chunk Q, head width P and state N.
extern "C" long long ssd_scan_smem_bytes(int Q, int P, int N)
{
    return (long long)(sizeof(float) * smem_floats(Q, P, N));
}

// dtype (of x, B, C and y): 0 float32, 1 bfloat16. Dskip may be
// null (no skip connection).
extern "C" int ssd_scan_launch(const void* x, const float* dt, const float* A,
                               const void* Bm, const void* Cm,
                               const float* Dskip, void* y, float* state_out,
                               int Bsz, int S, int H, int P, int G, int N,
                               int Q, int dtype, void* stream)
{
    if (Bsz == 0 || H == 0) return 0;
    if (G < 1 || H % G != 0 || Q < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    switch (dtype) {
        case 0: return launch_t<float>(x, dt, A, Bm, Cm, Dskip, y, state_out,
                                       Bsz, S, H, P, G, N, Q, s);
        case 1: return launch_t<__nv_bfloat16>(x, dt, A, Bm, Cm, Dskip, y,
                                               state_out, Bsz, S, H, P, G, N,
                                               Q, s);
    }
    return (int)cudaErrorInvalidValue;
}

extern "C" const char* ssd_scan_error_string(int e)
{
    return cudaGetErrorString((cudaError_t)e);
}
