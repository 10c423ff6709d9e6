// Attention at any head width on the CUDA cores, CUDA for sm_90a: the
// float32 check route of K5's and K6's wide routes.
//
// Replaces: the Pallas TPU kernels repro/kernels/flash_attention.py
//   flash_attention and repro/kernels/decode_attention.py decode_attention
//   where their heads are wider than flash_attention.cu (D, Dv <= 256) and
//   decode_attention.cu (D <= 576, Dv <= 512, and a float32 stage within
//   the shared memory) take. The Pallas kernels take any width; the
//   wrappers (kernels/flash_attention.py, kernels/decode_attention.py)
//   send a float32 call here only above those limits, so no config's path
//   reaches this file.
//
// What it computes, per (batch b, query row i, query head h), with the
//   query's KV head h / (Hq / Hkv) and keys j in [lo, hi):
//     s_j = softcap(scale q . k_j),  o = sum_j e^(s_j - m) v_j / sum_j e^(s_j - m)
//   in float32, o in q's type. The visible range [lo, hi) is K5's (query i
//   at position i + Sk - Sq; causal: keys up to it, and with a window the
//   last `window` of them; else all Sk) when kv_len is null, and K6's
//   (j < kv_len[b], and j >= kv_len[b] - window with a window) otherwise.
//   In K6's partials mode (acc set) the range is a slice's: j < kv_len[b]
//   (the slice's local length), and with a window j >= glen[b] - window -
//   offset; the block then writes the unnormalised (acc, m, l) in place of
//   o, with m = -1e30, l = 0, acc = 0 where no key is visible. A query
//   with no visible key gets o = 0.
//
// V inside K: v is read through its own row stride ldv (Dv for a
//   contiguous v, D where v is k's first Dv columns, MLA's latent cache),
//   so the latent cache is never copied.
//
// Route: kernels/attention_wide.py sends it float32 K5 and K6 (both
//   modes) alone; bfloat16 K5 takes attention_wide_tc.cu and bfloat16 K6
//   decode_attention_wide_tc.cu, both on the tensor cores. Its bfloat16
//   instantiation is launched by no wrapper: chip_smoke.py times the
//   tensor-core kernels against it in the same run.
//
// Design: the simplest correct kernel, not a fast one. One block of four
//   warps per (b, i, h). The block holds q (scaled) and its Dv float32
//   accumulators in shared memory, so the widths are bounded only by the
//   shared memory (D + Dv + 64 floats: D + Dv up to about 58,000). It walks
//   the visible keys in tiles of 32: each warp scores every fourth key of
//   the tile, its lanes striding over D and a shuffle reduction summing
//   them; the tile's max and weights e^(s - m) follow the online-softmax
//   rule (m' = max(m, tile max), acc = acc e^(m - m') + sum_j p_j v_j,
//   l = l e^(m - m') + sum_j p_j), each thread updating the output dims
//   tid + 128 t. K and V are read from global memory once per query head,
//   with no reuse across the heads of a GQA group; that is its cost (a
//   check route's), and its times are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 232448;           // 227 KB, a block's limit

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

struct Args {
    const void* q; const void* k; const void* v; void* o;
    const int* kv_len;       // null: K5's causal / window range
    const int* glen;         // partials mode: global lengths (may be null)
    int offset;              // partials mode: the slice's first position
    float* acc; float* m; float* l;   // partials mode when acc is set
    int B, Sq, Sk, Hq, Hkv, D, Dv, ldv, causal, window;
    float softcap, scale;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
wide_kernel(Args a)
{
    extern __shared__ float smem[];
    float* qs = smem;                        // (D,)
    float* accs = qs + a.D;                  // (Dv,)
    float* sc = accs + a.Dv;                 // (kTile,) scores
    float* ps = sc + kTile;                  // (kTile,) weights
    const T* q = (const T*)a.q;
    const T* k = (const T*)a.k;
    const T* v = (const T*)a.v;

    const int h = blockIdx.x % a.Hq;
    const int i = (blockIdx.x / a.Hq) % a.Sq;
    const int b = blockIdx.x / (a.Hq * a.Sq);
    const int hk = h / (a.Hq / a.Hkv);
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

    int lo = 0, hi = a.Sk;
    if (a.kv_len != nullptr) {
        const int len = a.kv_len[b];
        hi = min(max(len, 0), a.Sk);
        if (a.acc != nullptr)
            lo = a.window > 0 && a.glen != nullptr
                ? max(0, a.glen[b] - a.window - a.offset) : 0;
        else
            lo = a.window > 0 ? max(0, len - a.window) : 0;
    } else if (a.causal) {
        const int qpos = i + a.Sk - a.Sq;
        hi = min(qpos + 1, a.Sk);
        lo = a.window > 0 ? max(0, qpos - a.window + 1) : 0;
    }

    const size_t qrow = ((size_t)b * a.Sq + i) * a.Hq + h;
    for (int d = threadIdx.x; d < a.D; d += kThreads)
        qs[d] = to_f(q[qrow * a.D + d]) * a.scale;
    for (int d = threadIdx.x; d < a.Dv; d += kThreads) accs[d] = 0.f;
    __syncthreads();

    float m = kNegInf, l = 0.f;
    for (int t0 = lo; t0 < hi; t0 += kTile) {
        for (int jj = warp; jj < kTile; jj += kWarps) {
            const int j = t0 + jj;
            float s = 0.f;
            if (j < hi) {
                const T* kr = k + (((size_t)b * a.Sk + j) * a.Hkv + hk) * a.D;
                for (int d = lane; d < a.D; d += 32) s = fmaf(qs[d], to_f(kr[d]), s);
            }
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                s += __shfl_xor_sync(0xffffffffu, s, off);
            if (lane == 0) {
                if (a.softcap > 0.f) s = a.softcap * tanhf(s / a.softcap);
                sc[jj] = j < hi ? s : -INFINITY;
            }
        }
        __syncthreads();
        float mt = m;
        for (int jj = 0; jj < kTile; ++jj) mt = fmaxf(mt, sc[jj]);
        const float alpha = expf(m - mt);
        if (threadIdx.x < kTile) {
            const float s = sc[threadIdx.x];
            ps[threadIdx.x] = s == -INFINITY ? 0.f : expf(s - mt);
        }
        __syncthreads();
        float lt = 0.f;
        for (int jj = 0; jj < kTile; ++jj) lt += ps[jj];
        l = l * alpha + lt;
        m = mt;
        const int n = min(kTile, hi - t0);
        for (int d = threadIdx.x; d < a.Dv; d += kThreads) {
            float acc = accs[d] * alpha;
            for (int jj = 0; jj < n; ++jj)
                acc = fmaf(ps[jj], to_f(v[(((size_t)b * a.Sk + t0 + jj) * a.Hkv
                                           + hk) * a.ldv + d]), acc);
            accs[d] = acc;
        }
        __syncthreads();                     // sc and ps are free again
    }

    if (a.acc != nullptr) {
        const size_t bh = (size_t)b * a.Hq + h;
        for (int d = threadIdx.x; d < a.Dv; d += kThreads)
            a.acc[bh * a.Dv + d] = accs[d];
        if (threadIdx.x == 0) {
            a.m[bh] = hi > lo ? m : kNegInf;
            a.l[bh] = l;
        }
        return;
    }
    T* o = (T*)a.o;
    const float inv = l > 0.f ? 1.f / l : 0.f;
    for (int d = threadIdx.x; d < a.Dv; d += kThreads)
        o[qrow * a.Dv + d] = from_f<T>(accs[d] * inv);
}

size_t smem_bytes(int D, int Dv)
{
    return sizeof(float) * ((size_t)D + Dv + 2 * kTile);
}

template <typename T>
int launch_t(const Args& a, cudaStream_t stream)
{
    const size_t smem = smem_bytes(a.D, a.Dv);
    if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
    if (smem > (size_t)kDefaultSmem) {
        const cudaError_t e = cudaFuncSetAttribute(
            wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const long long blocks = (long long)a.B * a.Sq * a.Hq;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    wide_kernel<T><<<(unsigned)blocks, kThreads, smem, stream>>>(a);
    return (int)cudaGetLastError();
}

}  // namespace

// q (B, Sq, Hq, D); k (B, Sk, Hkv, D) contiguous; v (B, Sk, Hkv, Dv) at
// row stride ldv (Dv, or D where v is k's first Dv columns); o (B, Sq, Hq,
// Dv). kv_len null: K5 (causal, window); else K6 with Sq 1 (kv_len (B,)
// int32), in its partials mode when acc is set (acc (B, Hq, Dv), m and l
// (B, Hq) float32; glen (B,) int32 or null, offset). dtype: 0 float32, 1
// bfloat16. window <= 0: none; softcap <= 0: none.
extern "C" int attention_wide_launch(
    const void* q, const void* k, const void* v, void* o, const int* kv_len,
    const int* glen, int offset, float* acc, float* m, float* l, int B,
    int Sq, int Sk, int Hq, int Hkv, int D, int Dv, int ldv, int causal,
    int window, float softcap, float scale, int dtype, void* stream)
{
    if (B == 0 || Sq == 0 || Hq == 0) return 0;
    if (D < 1 || Dv < 1 || Hkv < 1 || Hq % Hkv != 0 || ldv < Dv
        || (acc != nullptr && (m == nullptr || l == nullptr || kv_len == nullptr))
        || (acc == nullptr && o == nullptr))
        return (int)cudaErrorInvalidValue;
    const Args a{q, k, v, o, kv_len, glen, offset, acc, m, l, B, Sq, Sk, Hq,
                 Hkv, D, Dv, ldv, causal, window, softcap, scale};
    switch (dtype) {
        case 0: return launch_t<float>(a, (cudaStream_t)stream);
        case 1: return launch_t<__nv_bfloat16>(a, (cudaStream_t)stream);
    }
    return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one block at head widths D and Dv (bytes).
extern "C" long long attention_wide_smem_bytes(int D, int Dv)
{
    return (long long)smem_bytes(D, Dv);
}

extern "C" const char* attention_wide_error_string(int e)
{
    return cudaGetErrorString((cudaError_t)e);
}
