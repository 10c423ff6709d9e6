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
//   only the same order gives the reference's cells at every step.
//
// What bounds it here: latency. Each (tenant, tier) sum is a chain of N
//   dependent float32 additions; the bytes (12 per row: idx int64 and
//   chosen float32) are a few KB to a few MB a step. At one tenant and N
//   16,000 rows the chain is 16,000 additions long whatever the card does.
//
// Design: one block per tenant. The block's threads stage a tile of rows
//   (tier and stored bytes) into shared memory with coalesced loads, then
//   thread l < L walks the tile in row order and adds the rows whose tier
//   is l; every thread of the walk reads the same row at once (a
//   broadcast). So each addition waits on shared memory, not on a global
//   load. No atomics: two calls on the same input give identical bits, and
//   so does the CPU's np.add.at in float32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;        // also the most tiers a call takes
constexpr int kTile = 4096;          // rows staged at once

__global__ void __launch_bounds__(kThreads)
usage_sum_kernel(const int64_t* __restrict__ idx,
                 const float* __restrict__ chosen, float* __restrict__ use,
                 int N, int L, int K)
{
    __shared__ float val[kTile];
    __shared__ unsigned char tier[kTile];
    const int t = blockIdx.x, l = threadIdx.x;
    const int64_t* it = idx + (size_t)t * N;
    const float* ct = chosen + (size_t)t * N;
    float acc = 0.f;
    for (int n0 = 0; n0 < N; n0 += kTile) {
        const int m = min(kTile, N - n0);
        for (int j = threadIdx.x; j < m; j += kThreads) {
            val[j] = ct[n0 + j];
            tier[j] = (unsigned char)(it[n0 + j] / K);
        }
        __syncthreads();
        if (l < L) {
#pragma unroll 8
            for (int j = 0; j < m; ++j)
                if (tier[j] == l) acc = __fadd_rn(acc, val[j]);
        }
        __syncthreads();
    }
    if (l < L) use[(size_t)t * L + l] = acc;
}

}  // namespace

// idx: (T, N) int64 flat cells in [0, L * K); chosen: (T, N) float32;
// use: (T, L) float32, written whole. L at most 128.
extern "C" int usage_sum_launch(const int64_t* idx, const float* chosen,
                                float* use, int T, int N, int L, int K,
                                void* stream)
{
    if (T < 0 || N < 0 || L < 1 || L > kThreads || K < 1)
        return (int)cudaErrorInvalidValue;
    if (T == 0) return 0;
    usage_sum_kernel<<<T, kThreads, 0, (cudaStream_t)stream>>>(
        idx, chosen, use, N, L, K);
    return (int)cudaGetLastError();
}

extern "C" const char* usage_sum_error_string(int e)
{
    return cudaGetErrorString((cudaError_t)e);
}
