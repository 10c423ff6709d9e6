// Per-tenant, per-tier usage of the fleet dual ascent, summed in float32
// row after row, CUDA for sm_90a.
//
// Replaces: the scatter-add of the jitted scans in repro/core/optassign.py,
//   `jnp.zeros((T, L)).at[t_idx, idx // K].add(chosen)` (_fleet_scan_core,
//   _fleet_scan_plain) and `jnp.zeros(L).at[idx // K].add(chosen)`
//   (_lagrangian_scan). For the chosen flat cell idx[t, n] of each row
//   (tier idx // K) and its stored bytes chosen[t, n], it computes
//     use[t, l] = sum over n = 0, 1, ..., N-1 with idx[t, n] / K == l of
//                 chosen[t, n]
//   in float32, one rounding per addition, in row order: the order of the
//   reference's scatter-add on the CPU. A float32 sum depends on its order,
//   and the dual ascent's next step compares multipliers that carry it, so
//   only the same order gives the reference's cells at every step. A cell
//   outside [0, L K) counts nowhere.
//
// What bounds it here: latency. Each (tenant, tier) sum is a chain of
//   dependent float32 additions, as long as that tier's count of rows; the
//   bytes (12 per row: idx int64 and chosen float32) are a few KB to a few
//   MB a step.
//
// Design: each (tenant, tier) chain gets only its own tier's rows, in row
//   order, from a list in shared memory: a stable compaction of the rows
//   by tier. Within a warp, __match_any_sync gives each row the lanes that
//   share its tier, so its rank among them; per-warp counts and a prefix
//   over warps and tiers give each tier's list its place, each list
//   starting on a 16-byte boundary. The walking thread reads its list in
//   16-byte loads, the next sixteen values in flight while it adds the last
//   sixteen, so the chain waits on its additions alone (__fadd_rn, never
//   contracted). The tier is computed once per row, in 32 bits (a cell is
//   below L K). No atomics: two calls give the same bits, and so does the
//   CPU's np.add.at in float32. Two routes by shape:
//   * block route (more than kWarpMaxN rows, or more than 32 tiers): one
//     block per (tenant, window of 128 tiers); a window's block lists only
//     the rows of its tiers (the others go to the bin past its end), so
//     every tier's chain is still its own rows in row order, at any number
//     of tiers (up to 128 tiers, one window). Eight producer warps stage
//     a tile of 4,096 rows
//     (512 each, with the next tile's loads in flight), compact it and
//     hand it over through named barriers to one walker warp per 32 tiers,
//     thread l walking tier l. The lists are double-buffered, so the
//     producers stage and compact the next tile while the walkers walk
//     this one.
//   * warp route (at most kWarpMaxN rows and 32 tiers): one warp per
//     tenant, eight tenants a block, so many small tenants (phase stream's
//     fleet of 1,024) do not launch blocks of idle threads. The warp loads
//     256 rows at once (all in flight), compacts them and lane l walks
//     tier l.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxTiers = 128;              // tiers a window of the block route
constexpr int kBins = kMaxTiers + 1;        // + rows of other tiers or invalid
constexpr int kMaxWindows = 65535;          // gridDim.y
// block route
constexpr int kProducers = 8;               // warps that stage and compact
constexpr int kChunks = 16;                 // 32-row chunks a producer warp
constexpr int kTile = kProducers * kChunks * 32;   // 4,096 rows a tile
constexpr int kList = kTile + 4 * kBins;    // each list padded to 4 floats
constexpr int kBarFull = 1;                 // + buffer: the tile is listed
constexpr int kBarEmpty = 3;                // + buffer: the tile is walked
constexpr int kBarProducers = 5;            // the producers alone
// warp route
constexpr int kWarpTiers = 32;
constexpr int kWarpChunks = 8;              // 256 rows at once
constexpr int kWarpList = kWarpChunks * 32 + 4 * kWarpTiers;
constexpr int kWarpMaxN = 1024;
constexpr int kTenantsPerBlock = 8;

__device__ __forceinline__ int tier_of(long long cell, int L, int K)
{
    if (cell < 0 || cell >= (long long)L * K) return L;
    return (int)((unsigned)cell / (unsigned)K);
}

// The tier of `cell` within the window of Lw tiers whose first cell is
// first (its first tier times K); Lw for a cell outside it
__device__ __forceinline__ int tier_in(long long cell, long long first,
                                       int Lw, int K)
{
    return tier_of(cell - first, Lw, K);
}

__device__ __forceinline__ unsigned lanemask_lt()
{
    unsigned m;
    asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
    return m;
}

__device__ __forceinline__ void bar_sync(int id, int n)
{
    asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n)
{
    asm volatile("bar.arrive %0, %1;" :: "r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

__device__ __forceinline__ float add4(float acc, float4 x)
{
    acc = __fadd_rn(acc, x.x);
    acc = __fadd_rn(acc, x.y);
    acc = __fadd_rn(acc, x.z);
    return __fadd_rn(acc, x.w);
}

// acc + p[0] + p[1] + ... + p[n-1], in that order, one rounding each; p
// on a 16-byte boundary. The next sixteen values load while the last
// sixteen are added.
__device__ __forceinline__ float walk(const float* p, int n, float acc)
{
    const float4* q = reinterpret_cast<const float4*>(p);
    const int groups = n / 16;
    if (groups > 0) {
        float4 a0 = q[0], a1 = q[1], a2 = q[2], a3 = q[3];
        for (int gi = 1; gi < groups; ++gi) {
            const float4 b0 = q[4 * gi], b1 = q[4 * gi + 1],
                         b2 = q[4 * gi + 2], b3 = q[4 * gi + 3];
            acc = add4(add4(add4(add4(acc, a0), a1), a2), a3);
            a0 = b0; a1 = b1; a2 = b2; a3 = b3;
        }
        acc = add4(add4(add4(add4(acc, a0), a1), a2), a3);
    }
    for (int k = 16 * groups; k < n; ++k) acc = __fadd_rn(acc, p[k]);
    return acc;
}

__global__ void __launch_bounds__(32 * (kProducers + kMaxTiers / 32))
usage_block_kernel(const int64_t* __restrict__ idx,
                   const float* __restrict__ chosen, float* __restrict__ use,
                   int N, int L_all, int K)
{
    // this block's window: tiers [l0, l0 + L)
    const int l0 = blockIdx.y * kMaxTiers;
    const int L = min(kMaxTiers, L_all - l0);
    const long long first_cell = (long long)l0 * K;
    __shared__ __align__(16) float list[2][kList];  // each tier's rows
    __shared__ int base[2][kBins];          // where each tier's list starts
    __shared__ int tot[2][kBins];           // and its length
    __shared__ int cnt[kProducers][kBins];  // a warp's rows per tier, then
                                            // its offset within the tier
    const int t = blockIdx.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int n_tiles = (N + kTile - 1) / kTile;
    const int everyone = blockDim.x;
    const int64_t* it = idx + (size_t)t * N;
    const float* ct = chosen + (size_t)t * N;

    if (warp >= kProducers) {               // a walker: thread l, tier l
        const int l = (warp - kProducers) * 32 + lane;
        float acc = 0.f;
        for (int i = 0; i < n_tiles; ++i) {
            const int b = i & 1;
            bar_sync(kBarFull + b, everyone);
            if (l < L) acc = walk(list[b] + base[b][l], tot[b][l], acc);
            __syncwarp();
            if (i + 2 < n_tiles) bar_arrive(kBarEmpty + b, everyone);
        }
        if (l < L) use[(size_t)t * L_all + l0 + l] = acc;
        return;
    }

    const int bins = L + 1;
    const int mine = warp * (kChunks * 32) + lane;   // this lane's first row
    long long cell[kChunks];
    float val[kChunks];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
        const int n = mine + c * 32;
        cell[c] = n < N ? (long long)it[n] : -1;
        val[c] = n < N ? ct[n] : 0.f;
    }
    for (int i = 0; i < n_tiles; ++i) {
        const int b = i & 1;
        int tier[kChunks];
        float v[kChunks];
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
            tier[c] = tier_in(cell[c], first_cell, L, K);
            v[c] = val[c];
        }
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {  // the next tile, in flight
            const int n = (i + 1) * kTile + mine + c * 32;
            cell[c] = n < N ? (long long)it[n] : -1;
            val[c] = n < N ? ct[n] : 0.f;
        }
        unsigned same[kChunks];
#pragma unroll
        for (int c = 0; c < kChunks; ++c)
            same[c] = __match_any_sync(kFull, tier[c]);
        for (int l = lane; l < bins; l += 32) cnt[warp][l] = 0;
        __syncwarp();
        int pos[kChunks];
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
            const unsigned before = same[c] & lanemask_lt();
            pos[c] = cnt[warp][tier[c]] + __popc(before);
            __syncwarp();
            if (before == 0) cnt[warp][tier[c]] += __popc(same[c]);
            __syncwarp();
        }
        // the walkers are done with this buffer's tile before the last
        if (i >= 2) bar_sync(kBarEmpty + b, everyone);
        else bar_sync(kBarProducers, 32 * kProducers);
        if (warp == 0) {
            // per tier: each warp's offset within it (an exclusive prefix
            // over warps, in place) and its length; then the tiers' starts
            constexpr int kPer = (kBins + 31) / 32;
            int len[kPer], own = 0;
#pragma unroll
            for (int j = 0; j < kPer; ++j) {
                const int l = lane * kPer + j;
                int c[kProducers];
#pragma unroll
                for (int w = 0; w < kProducers; ++w)
                    c[w] = l < bins ? cnt[w][l] : 0;
                len[j] = 0;
#pragma unroll
                for (int w = 0; w < kProducers; ++w) {
                    if (l < bins) cnt[w][l] = len[j];
                    len[j] += c[w];
                }
                if (l < bins) tot[b][l] = len[j];
                own += round4(len[j]);
            }
            int incl = own;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const int x = __shfl_up_sync(kFull, incl, o);
                if (lane >= o) incl += x;
            }
            int at = incl - own;
#pragma unroll
            for (int j = 0; j < kPer; ++j) {
                const int l = lane * kPer + j;
                if (l < bins) base[b][l] = at;
                at += round4(len[j]);
            }
        }
        bar_sync(kBarProducers, 32 * kProducers);
#pragma unroll
        for (int c = 0; c < kChunks; ++c)
            list[b][base[b][tier[c]] + cnt[warp][tier[c]] + pos[c]] = v[c];
        __syncwarp();
        bar_arrive(kBarFull + b, everyone);
    }
}

__global__ void __launch_bounds__(32 * kTenantsPerBlock)
usage_warp_kernel(const int64_t* __restrict__ idx,
                  const float* __restrict__ chosen, float* __restrict__ use,
                  int T, int N, int L, int K)
{
    __shared__ __align__(16) float list[kTenantsPerBlock][kWarpList];
    __shared__ int cnt[kTenantsPerBlock][kWarpTiers];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int t = blockIdx.x * kTenantsPerBlock + warp;
    if (t >= T) return;                     // the whole warp
    const int64_t* it = idx + (size_t)t * N;
    const float* ct = chosen + (size_t)t * N;
    float* lw = list[warp];
    int* cw = cnt[warp];

    float acc = 0.f;
    for (int n0 = 0; n0 < N; n0 += kWarpChunks * 32) {
        const int chunks = min(kWarpChunks, (N - n0 + 31) / 32);
        long long cell[kWarpChunks];
        float val[kWarpChunks];
#pragma unroll
        for (int c = 0; c < kWarpChunks; ++c) {
            const int n = n0 + c * 32 + lane;
            cell[c] = n < N ? (long long)it[n] : -1;
            val[c] = n < N ? ct[n] : 0.f;
        }
        int tier[kWarpChunks];
        unsigned same[kWarpChunks];
#pragma unroll
        for (int c = 0; c < kWarpChunks; ++c) {
            if (c >= chunks) break;
            tier[c] = tier_of(cell[c], L, K);
            same[c] = __match_any_sync(kFull, tier[c]);
        }
        cw[lane] = 0;
        __syncwarp();
        int pos[kWarpChunks];
#pragma unroll
        for (int c = 0; c < kWarpChunks; ++c) {
            if (c >= chunks) break;
            const unsigned before = same[c] & lanemask_lt();
            const bool counted = tier[c] < L;
            pos[c] = counted ? cw[tier[c]] + __popc(before) : 0;
            __syncwarp();
            if (counted && before == 0) cw[tier[c]] += __popc(same[c]);
            __syncwarp();
        }
        const int n_l = cw[lane];           // rows of tier `lane` (0 past L)
        int start = round4(n_l);            // exclusive prefix over tiers
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int x = __shfl_up_sync(kFull, start, o);
            if (lane >= o) start += x;
        }
        start -= round4(n_l);
#pragma unroll
        for (int c = 0; c < kWarpChunks; ++c) {
            if (c >= chunks) break;
            const int at = __shfl_sync(kFull, start, tier[c] & 31);
            if (tier[c] < L) lw[at + pos[c]] = val[c];
        }
        __syncwarp();
        if (lane < L) acc = walk(lw + start, n_l, acc);
        __syncwarp();
    }
    if (lane < L) use[(size_t)t * L + lane] = acc;
}

}  // namespace

// idx: (T, N) int64 flat cells in [0, L * K); chosen: (T, N) float32;
// use: (T, L) float32, written whole. Any L: the block route takes it in
// windows of 128 tiers, one block each.
extern "C" int usage_sum_launch(const int64_t* idx, const float* chosen,
                                float* use, int T, int N, int L, int K,
                                void* stream)
{
    const int windows = (L + kMaxTiers - 1) / kMaxTiers;
    if (T < 0 || N < 0 || L < 1 || K < 1 || windows > kMaxWindows
        || (long long)L * K > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    if (T == 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    if (L <= kWarpTiers && N <= kWarpMaxN) {
        const int blocks = (T + kTenantsPerBlock - 1) / kTenantsPerBlock;
        usage_warp_kernel<<<blocks, 32 * kTenantsPerBlock, 0, s>>>(
            idx, chosen, use, T, N, L, K);
    } else {
        const int widest = L < kMaxTiers ? L : kMaxTiers;
        const int threads = 32 * (kProducers + (widest + 31) / 32);
        usage_block_kernel<<<dim3(T, windows), threads, 0, s>>>(
            idx, chosen, use, N, L, K);
    }
    return (int)cudaGetLastError();
}

extern "C" const char* usage_sum_error_string(int e)
{
    return cudaGetErrorString((cudaError_t)e);
}
