// The split-KV decode kernels of decode_attention.cu (their design is
// described there), templated on the mode: the ordinary one writes o, the
// partials one (kPartials) the unnormalised (acc, m, l) of one slice of a
// sequence-sharded cache. decode_attention.cu instantiates the first and
// decode_attention_partials.cu the second, so each mode compiles without
// the other's branches and the two sources build side by side.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tc_common.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 2;                  // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;                  // keys per tile, one per lane
constexpr int kMergeThreads = 128;
constexpr int kMaxSplits = 4096;           // the merge's weights: 48 KB
constexpr int kMaxSmem = 232448;           // 227 KB, a block's limit
constexpr int kMaxD = 576, kMaxDv = 512;   // MLA's latent head: 512 + 64
constexpr int kNarrowDvt = 8;              // Dv <= 256: DVT 1..8, HB <= 8
constexpr int kWideGroup = 4;              // Dv > 256: DVT 12 or 16, HB <= 4
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

// one 16-byte unit of a shared-memory row as floats
__device__ __forceinline__ void unit_f(const float* p, float (&f)[4])
{
    const float4 u = *reinterpret_cast<const float4*>(p);
    f[0] = u.x; f[1] = u.y; f[2] = u.z; f[3] = u.w;
}
__device__ __forceinline__ void unit_f(const __nv_bfloat16* p, float (&f)[8])
{
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        const float2 t = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&w[e]));
        f[2 * e] = t.x;
        f[2 * e + 1] = t.y;
    }
}

__device__ __forceinline__ float warp_max(float v) {
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
    return v;
}
__device__ __forceinline__ float warp_sum(float v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
    return v;
}

// Stage rows [r_lo, r_hi) of a 32-row tile (row r at src + r * stride,
// `width` elements) into dst (row stride ld, `units` 16-byte units a row);
// the other rows, and the columns from width to the end of the last unit,
// become zeros. vec: 16-byte cp.async (width a whole number of units, src
// and stride 16-byte aligned; the caller commits); else plain loads. One
// warp.
template <typename T>
__device__ __forceinline__ void stage_tile(T* dst, int ld, const T* src,
                                           size_t stride, int width,
                                           int units, int r_lo, int r_hi,
                                           bool vec, int lane)
{
    constexpr int kPer = 16 / sizeof(T);
    if (vec) {
        int r = lane / units, u = lane - r * units;
        const int dr = 32 / units, du = 32 - dr * units;
        for (; r < kTile; r += dr, u += du) {
            if (u >= units) {
                u -= units;
                if (++r >= kTile) break;
            }
            const bool ok = r >= r_lo && r < r_hi;
            tc::cp_async16(dst + r * ld + u * kPer,
                           ok ? src + r * stride + u * kPer : src, ok ? 16 : 0);
        }
    } else {
        const int w = units * kPer;
        for (int e = lane; e < kTile * w; e += 32) {
            const int r = e / w, c = e - r * w;
            const bool ok = r >= r_lo && r < r_hi && c < width;
            dst[r * ld + c] = ok ? src[r * stride + c] : tc::zero_of<T>();
        }
    }
}

// The partials mode's operands (unused in the ordinary mode).
struct Partials {
    const int* glen;     // (B,) global lengths, for the window; may be null
    int offset;          // global position of the slice's first key
    float* acc;          // (B, Hq, Dv)
    float* m;            // (B, Hq)
    float* l;            // (B, Hq)
};

// Visible keys [lo, hi) of sequence b in a cache of S keys; in the
// partials mode the window is measured from the global length (glen is
// set whenever window > 0).
template <bool kPartials>
__device__ __forceinline__ void visible(const int* kv_len, const Partials& pt,
                                        int b, int S, int window, int& lo,
                                        int& hi)
{
    const int len = kv_len[b];
    hi = min(max(len, 0), S);
    if constexpr (kPartials)
        lo = window > 0 ? max(0, pt.glen[b] - window - pt.offset) : 0;
    else
        lo = window > 0 ? max(0, len - window) : 0;
}

struct Geometry {
    int ku, kv;          // 16-byte units of a K row and of a V row
    int ldk, ldv;        // shared row strides, in elements (ldv: 0, and V
                         // read from the K tile at stride ldk, with v_in_k)
    int dq;              // padded query width (floats)
    int stages;          // tiles in flight per warp: 1 or 2
    size_t q_off, red_off, stage_off, stage_elems, bytes;
};

template <typename T, int HB>
Geometry geometry(int D, int Dv, int split, bool v_in_k)
{
    constexpr int kPer = 16 / sizeof(T);
    Geometry g;
    g.ku = (D + kPer - 1) / kPer;
    g.kv = (Dv + kPer - 1) / kPer;
    g.ldk = (g.ku | 1) * kPer;           // odd units: conflict-free rows
    g.ldv = v_in_k ? 0 : g.kv * kPer;
    g.dq = g.ku * kPer;
    g.q_off = 0;
    g.red_off = sizeof(float) * (size_t)HB * g.dq;
    g.stage_off = g.red_off + sizeof(float) * (size_t)kWarps * HB * (Dv + 2);
    g.stage_off = (g.stage_off + 15) / 16 * 16;
    g.stage_elems = (size_t)kTile * (g.ldk + g.ldv);
    const size_t per_stage = sizeof(T) * g.stage_elems * kWarps;
    const bool ahead = split / kTile / kWarps >= 2;
    g.stages = ahead && g.stage_off + 2 * per_stage <= (size_t)kMaxSmem ? 2 : 1;
    g.bytes = g.stage_off + g.stages * per_stage;
    return g;
}

template <typename T, int HB, int DVT, bool kPartials>
__global__ void __launch_bounds__(kThreads)
split_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int* __restrict__ kv_len,
             T* __restrict__ o, float* __restrict__ part, int S, int Hq,
             int Hkv, int D, int Dv, int window, float softcap, float scale,
             int split, int nsplit, Geometry g, bool vec_k, bool vec_v,
             bool v_in_k, Partials pt)
{
    constexpr int kPer = 16 / sizeof(T);
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* qs = reinterpret_cast<float*>(smem_raw + g.q_off);      // (HB, dq)
    float* red = reinterpret_cast<float*>(smem_raw + g.red_off);   // (kWarps, HB, Dv + 2)
    const int ldr = Dv + 2;

    const int rep = Hq / Hkv;
    const int groups = (rep + HB - 1) / HB;
    int bid = blockIdx.x;
    const int s = bid % nsplit;
    bid /= nsplit;
    const int grp = bid % groups;
    bid /= groups;
    const int hk = bid % Hkv, b = bid / Hkv;
    const int h0 = grp * HB;                 // first head of the group
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

    int lo, hi;
    visible<kPartials>(kv_len, pt, b, S, window, lo, hi);
    const int a = max(s * split, lo), e = min((s + 1) * split, hi);
    if (a >= e && nsplit > 1) return;        // nothing visible in this split

    for (int x = threadIdx.x; x < HB * g.dq; x += kThreads) {
        const int i = x / g.dq, d = x - i * g.dq;
        qs[x] = h0 + i < rep && d < D
            ? to_f(q[((size_t)b * Hq + hk * rep + h0 + i) * D + d]) * scale
            : 0.f;
    }

    // this warp's tiles: starts first + (warp + kWarps n) * kTile < e
    const int first = a / kTile * kTile;
    const int n_tiles = a < e ? (e - first + kTile - 1) / kTile : 0;
    const int mine = n_tiles > warp ? (n_tiles - warp + kWarps - 1) / kWarps : 0;
    T* ring = reinterpret_cast<T*>(smem_raw + g.stage_off)
              + (size_t)warp * g.stages * g.stage_elems;
    const size_t row_k = (size_t)Hkv * D, row_v = (size_t)Hkv * Dv;
    const T* kb = k + (size_t)b * S * row_k + (size_t)hk * D;
    const T* vb = v + (size_t)b * S * row_v + (size_t)hk * Dv;

    auto issue = [&](int n) {
        const int t0 = first + (warp + kWarps * n) * kTile;
        T* ks = ring + (size_t)(n % g.stages) * g.stage_elems;
        T* vs = ks + kTile * g.ldk;
        const int r_lo = max(lo - t0, 0), r_hi = min(e - t0, kTile);
        stage_tile(ks, g.ldk, kb + (size_t)t0 * row_k, row_k, D, g.ku,
                   r_lo, r_hi, vec_k, lane);
        tc::cp_async_commit();
        if (!v_in_k)
            stage_tile(vs, g.ldv, vb + (size_t)t0 * row_v, row_v, Dv, g.kv,
                       r_lo, r_hi, vec_v, lane);
        tc::cp_async_commit();               // empty with v_in_k: same waits
    };
    if (mine > 0) issue(0);
    if (mine > 1 && g.stages == 2) issue(1);
    __syncthreads();                         // qs ready

    float m[HB], l[HB], acc[HB][DVT];
#pragma unroll
    for (int i = 0; i < HB; ++i) {
        m[i] = kNegInf;
        l[i] = 0.f;
#pragma unroll
        for (int t = 0; t < DVT; ++t) acc[i][t] = 0.f;
    }

    for (int n = 0; n < mine; ++n) {
        const int t0 = first + (warp + kWarps * n) * kTile;
        const T* ks = ring + (size_t)(n % g.stages) * g.stage_elems;
        const T* vs = v_in_k ? ks : ks + kTile * g.ldk;
        const int ldv = v_in_k ? g.ldk : g.ldv;
        const bool ahead = g.stages == 2 && n + 1 < mine;
        if (ahead) tc::cp_async_wait<3>(); else tc::cp_async_wait<1>();
        __syncwarp();                        // K of tile n has landed

        float sc[HB];
#pragma unroll
        for (int i = 0; i < HB; ++i) sc[i] = 0.f;
        const T* kr = ks + lane * g.ldk;
        for (int u = 0; u < g.ku; ++u) {
            float kf[kPer];
            unit_f(kr + u * kPer, kf);
#pragma unroll
            for (int i = 0; i < HB; ++i) {
                const float* qi = qs + i * g.dq + u * kPer;
#pragma unroll
                for (int c = 0; c < kPer; c += 4) {
                    const float4 qq = *reinterpret_cast<const float4*>(qi + c);
                    sc[i] = fmaf(qq.x, kf[c], sc[i]);
                    sc[i] = fmaf(qq.y, kf[c + 1], sc[i]);
                    sc[i] = fmaf(qq.z, kf[c + 2], sc[i]);
                    sc[i] = fmaf(qq.w, kf[c + 3], sc[i]);
                }
            }
        }
        const int kpos = t0 + lane;
        const bool ok = kpos >= lo && kpos < e;
        float p[HB];
#pragma unroll
        for (int i = 0; i < HB; ++i) {
            float si = sc[i];
            if (softcap > 0.f) si = softcap * tanhf(si / softcap);
            si = ok ? si : kNegInf;
            const float m_new = fmaxf(m[i], warp_max(si));
            p[i] = ok ? expf(si - m_new) : 0.f;
            const float corr = expf(m[i] - m_new);
            l[i] = l[i] * corr + warp_sum(p[i]);
            m[i] = m_new;
#pragma unroll
            for (int t = 0; t < DVT; ++t) acc[i][t] *= corr;
        }

        if (ahead) tc::cp_async_wait<2>(); else tc::cp_async_wait<0>();
        __syncwarp();                        // V of tile n has landed
#pragma unroll 4
        for (int j = 0; j < kTile; ++j) {
            const T* vr = vs + j * ldv;
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
        __syncwarp();                        // done with this stage
        if (n + g.stages < mine) issue(n + g.stages);
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
    for (int x = threadIdx.x; x < HB * (Dv + 2); x += kThreads) {
        const int i = x / (Dv + 2), d = x - i * (Dv + 2);
        if (h0 + i >= rep) continue;
        float M = kNegInf;
        for (int w = 0; w < kWarps; ++w) M = fmaxf(M, red[(w * HB + i) * ldr + Dv]);
        float L = 0.f, A = 0.f;
        for (int w = 0; w < kWarps; ++w) {
            const float* rw = red + (w * HB + i) * ldr;
            const float c = expf(rw[Dv] - M);
            L = fmaf(rw[Dv + 1], c, L);
            if (d < Dv) A = fmaf(rw[d], c, A);
        }
        const size_t bh = (size_t)b * Hq + hk * rep + h0 + i;
        if (kPartials && nsplit == 1) {
            if (d < Dv) pt.acc[bh * Dv + d] = A;
            else if (d == Dv) pt.m[bh] = M;
            else pt.l[bh] = L;
        } else if (nsplit == 1) {
            if (d < Dv) o[bh * Dv + d] = from_f<T>(A / fmaxf(L, 1e-30f));
        } else {
            part[(bh * nsplit + s) * ldr + d] = d < Dv ? A : (d == Dv ? M : L);
        }
    }
}

// o[b, h] from the (m, l, acc) of the splits that hold a visible key, in
// split order (in the partials mode, the merged (M, L, A) unnormalised).
// One block per (batch, query head); the splits' weights e^(m_s - M) are
// computed once, into shared memory (3 nsplit floats).
template <typename T, bool kPartials>
__global__ void __launch_bounds__(kMergeThreads)
merge_kernel(const float* __restrict__ part, const int* __restrict__ kv_len,
             T* __restrict__ o, int S, int Hq, int Dv, int window, int split,
             int nsplit, Partials pt)
{
    extern __shared__ float ms[];            // m, then l, then weights
    float* ls = ms + nsplit;
    float* ws = ls + nsplit;
    __shared__ float stat[2];                // M, L
    const int bh = blockIdx.x, b = bh / Hq;
    int lo, hi;
    visible<kPartials>(kv_len, pt, b, S, window, lo, hi);
    const int ldr = Dv + 2;
    const int s0 = lo / split;
    const int n = lo < hi ? (hi + split - 1) / split - s0 : 0;
    const float* pr = part + ((size_t)bh * nsplit + s0) * ldr;
    for (int s = threadIdx.x; s < n; s += kMergeThreads) {
        ms[s] = pr[s * ldr + Dv];
        ls[s] = pr[s * ldr + Dv + 1];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        float M = kNegInf;
        for (int s = 0; s < n; ++s) M = fmaxf(M, ms[s]);
        stat[0] = M;
    }
    __syncthreads();
    for (int s = threadIdx.x; s < n; s += kMergeThreads) ws[s] = expf(ms[s] - stat[0]);
    __syncthreads();
    if (threadIdx.x == 0) {
        float L = 0.f;
        for (int s = 0; s < n; ++s) L = fmaf(ls[s], ws[s], L);
        if constexpr (kPartials) {
            pt.m[bh] = stat[0];
            pt.l[bh] = L;
        }
        stat[1] = fmaxf(L, 1e-30f);
    }
    __syncthreads();
    for (int d = threadIdx.x; d < Dv; d += kMergeThreads) {
        float A = 0.f;
#pragma unroll 8
        for (int s = 0; s < n; ++s) A = fmaf(pr[s * ldr + d], ws[s], A);
        if constexpr (kPartials) pt.acc[(size_t)bh * Dv + d] = A;
        else o[(size_t)bh * Dv + d] = from_f<T>(A / stat[1]);
    }
}

bool aligned16(const void* p) { return (reinterpret_cast<size_t>(p) & 15) == 0; }

// Launch the split kernel (and the merge, with more than one split); with
// attr set, launch nothing and report the split kernel's registers, shared
// memory (static + dynamic) and stages instead.
template <typename T, int HB, int DVT, bool kPartials>
int launch_t(const void* q, const void* k, const void* v, const int* kv_len,
             void* o, float* part, int B, int S, int Hq, int Hkv, int D,
             int Dv, int window, float softcap, float scale, int split,
             bool v_in_k, const Partials& pt, cudaStream_t stream, int* attr)
{
    constexpr int kPer = 16 / sizeof(T);
    static int allowed[64];                  // per device, set once
    const Geometry g = geometry<T, HB>(D, Dv, split, v_in_k);
    // float32 heads of 576 with a separate V tile: 280 KB a stage
    if (g.bytes > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
    const void* fn = (const void*)split_kernel<T, HB, DVT, kPartials>;
    cudaError_t e;
    if (attr) {
        cudaFuncAttributes fa;
        e = cudaFuncGetAttributes(&fa, fn);
        attr[0] = fa.numRegs;
        attr[1] = (int)(fa.sharedSizeBytes + g.bytes);
        attr[2] = g.stages;
        return (int)e;
    }
    e = tc::allow_smem(fn, g.bytes, allowed);
    if (e != cudaSuccess) return (int)e;
    const int rep = Hq / Hkv;
    const int nsplit = (S + split - 1) / split;
    const bool vec_k = D % kPer == 0 && aligned16(k);
    const bool vec_v = Dv % kPer == 0 && aligned16(v);
    const long long blocks = (long long)nsplit * B * Hkv * ((rep + HB - 1) / HB);
    split_kernel<T, HB, DVT, kPartials><<<(unsigned)blocks, kThreads, g.bytes, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, kv_len, (T*)o, part, S, Hq,
        Hkv, D, Dv, window, softcap, scale, split, nsplit, g, vec_k, vec_v,
        v_in_k, pt);
    e = cudaGetLastError();
    if (e != cudaSuccess || nsplit == 1) return (int)e;
    merge_kernel<T, kPartials><<<B * Hq, kMergeThreads,
                                 3 * sizeof(float) * nsplit, stream>>>(
        part, kv_len, (T*)o, S, Hq, Dv, window, split, nsplit, pt);
    return (int)cudaGetLastError();
}

#define ARGS q, k, v, kv_len, o, part, B, S, Hq, Hkv, D, Dv, window, \
             softcap, scale, split, v_in_k, pt, s, attr
#define PARAMS const void* q, const void* k, const void* v,              \
               const int* kv_len, void* o, float* part, int B, int S,     \
               int Hq, int Hkv, int D, int Dv, int window, float softcap, \
               float scale, int split, bool v_in_k, const Partials& pt,   \
               cudaStream_t s, int* attr

template <typename T, int HB, bool kPartials>
int launch_dv(int dvt, PARAMS)
{
    switch (dvt) {
#define CASE(N) case N: return launch_t<T, HB, N, kPartials>(ARGS);
        CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    }
    // wide values (Dv 257..512) only at HB <= 4: HB x DVT <= 64 floats
    if constexpr (HB <= kWideGroup) {
        if (dvt <= 12) return launch_t<T, HB, 12, kPartials>(ARGS);
        if (dvt <= 16) return launch_t<T, HB, 16, kPartials>(ARGS);
    }
    return (int)cudaErrorInvalidValue;
}

template <typename T, bool kPartials>
int launch_hb(int dvt, PARAMS)
{
    const int rep = Hq / Hkv;
    if (rep == 1) return launch_dv<T, 1, kPartials>(dvt, ARGS);
    if (rep == 2) return launch_dv<T, 2, kPartials>(dvt, ARGS);
    if (rep <= 4 || dvt > kNarrowDvt)
        return launch_dv<T, kWideGroup, kPartials>(dvt, ARGS);
    return launch_dv<T, 8, kPartials>(dvt, ARGS);
}

// The split and merge launches of one mode: kPartials writes (acc, m, l)
// through pt in place of o.
template <bool kPartials>
int dispatch(int dtype, PARAMS)
{
    if (D < 1 || D > kMaxD || Dv < 1 || Dv > kMaxDv || (v_in_k && Dv > D)
        || Hkv < 1 || Hq % Hkv != 0
        || S < 1 || split < kTile * kWarps || split % (kTile * kWarps) != 0
        || (S + split - 1) / split > kMaxSplits)
        return (int)cudaErrorInvalidValue;
    const int dvt = (Dv + 31) / 32;
    switch (dtype) {
        case 0: return launch_hb<float, kPartials>(dvt, ARGS);
        case 1: return launch_hb<__nv_bfloat16, kPartials>(dvt, ARGS);
    }
    return (int)cudaErrorInvalidValue;
}
#undef ARGS
#undef PARAMS

}  // namespace
