// Batched weighted-entropy features for COMPREDICT, CUDA for sm_90a.
//
// Replaces: the Pallas TPU kernel repro/kernels/entropy_features.py
//   weighted_entropy_features (_wef_kernel). Per partition i it builds the
//   (n_buckets, V) histogram of the value codes at positions < n_valid[i],
//   where the value at flat position p sits in row p / n_cols[i] and bucket b
//   holds rows [b*nr/nb, (b+1)*nr/nb) in integer arithmetic, and reduces it to
//     summary[i] = [-sum len*p*log p, -sum p*log p, distinct/total, sum len*p]
//     bucket_h[i, b] = -sum len * pb * log pb
//   with p = hist/total, total = max(n_valid, 1), pb = hist_b/max(sum hist_b, 1),
//   natural log and p > 0 guards. The TPU version scattered counts through a
//   one-hot matrix product into a VMEM histogram.
//
// What bounds it here: memory. Each code is read once and costs one atomic;
//   the histogram is re-read three times by the reduction. At the main path's
//   shapes the vocabulary of one partition reaches ~5.8e5 values (2.3 MB of
//   counts), ten times the 227 KB of shared memory a block can hold, so the
//   histogram lives in device memory (and mostly in the 50 MB L2).
//
// Design: two launches.
//   (a) wef_histogram_kernel: grid (chunks of M) x partitions; each thread
//       takes positions with a grid stride, computes its bucket from the
//       integer edges and atomicAdds an int32 count into the global
//       (N, n_buckets, V) histogram. Integer atomics make the counts exact and
//       independent of their order.
//   (b) wef_reduce_kernel: one block per partition; each thread sums a strided
//       slice of the vocabulary, then a fixed warp-shuffle + shared-memory tree
//       combines the partial sums, so the result is the same on every run.
//       Each term is computed in float32, as the TPU kernel does, but the sums
//       run in float64: a thread's slice holds ~570 terms at the main path's
//       largest vocabulary, and a float32 running sum over that many terms
//       lost more than twice the accuracy of PyTorch's own float32 reduction.

#include <cuda_runtime.h>

namespace {

constexpr int kHistThreads = 256;
constexpr int kHistMaxBlocks = 4096;
constexpr int kReduceThreads = 1024;
constexpr int kMaxBuckets = 16;

__global__ void __launch_bounds__(kHistThreads)
wef_histogram_kernel(const int* __restrict__ codes,    // (N, M)
                     const int* __restrict__ n_valid,  // (N,)
                     const int* __restrict__ n_rows,   // (N,)
                     const int* __restrict__ n_cols,   // (N,)
                     int m, int v, int n_buckets,
                     int* __restrict__ hist)           // (N, nb, V)
{
    const int i = blockIdx.y;
    const int nv = min(n_valid[i], m);
    const int nr = n_rows[i];
    const int nc = max(n_cols[i], 1);
    const int* row = codes + (size_t)i * m;
    int* h = hist + (size_t)i * n_buckets * v;
    for (int pos = blockIdx.x * blockDim.x + threadIdx.x; pos < nv;
         pos += gridDim.x * blockDim.x) {
        const int c = row[pos];
        if (c < 0 || c >= v) continue;
        int b = 0;
        if (n_buckets > 1) {
            const int r = pos / nc;
            for (int e = 1; e < n_buckets; ++e) b += (r >= (e * nr) / n_buckets);
        }
        atomicAdd(h + (size_t)b * v + c, 1);
    }
}

// Sum over the block; the result is valid in thread 0. Fixed order for a
// fixed blockDim. `scratch` holds one entry per warp.
template <typename T>
__device__ T block_sum(T x, T* scratch)
{
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    if (lane == 0) scratch[warp] = x;
    __syncthreads();
    if (warp == 0) {
        x = lane < (int)(blockDim.x >> 5) ? scratch[lane] : T(0);
        for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
    }
    __syncthreads();
    return x;
}

__device__ __forceinline__ float plogp(float p)
{
    return p > 0.f ? p * logf(fmaxf(p, 1e-30f)) : 0.f;
}

__global__ void __launch_bounds__(kReduceThreads)
wef_reduce_kernel(const int* __restrict__ hist,        // (N, nb, V)
                  const float* __restrict__ lengths,   // (N, V) or (V,)
                  long long len_stride,                // V, or 0 for shared
                  const int* __restrict__ n_valid,     // (N,)
                  int v, int n_buckets,
                  float* __restrict__ summary,         // (N, 4)
                  float* __restrict__ bucket_h)        // (N, nb)
{
    __shared__ double red_d[32];
    __shared__ long long red_ll[32];
    __shared__ float tot_b[kMaxBuckets];

    const int i = blockIdx.x;
    const int* h = hist + (size_t)i * n_buckets * v;
    const float* lens = lengths + (size_t)i * len_stride;

    // per-bucket totals, exact in integers
    for (int b = 0; b < n_buckets; ++b) {
        long long s = 0;
        for (int x = threadIdx.x; x < v; x += blockDim.x) s += h[(size_t)b * v + x];
        s = block_sum(s, red_ll);
        if (threadIdx.x == 0) tot_b[b] = fmaxf((float)s, 1.f);
    }
    __syncthreads();

    // summary over the bucket-summed histogram
    const float total = fmaxf((float)n_valid[i], 1.f);
    double a_wh = 0.0, a_h = 0.0, a_len = 0.0;
    long long distinct = 0;
    for (int x = threadIdx.x; x < v; x += blockDim.x) {
        int c = 0;
        for (int b = 0; b < n_buckets; ++b) c += h[(size_t)b * v + x];
        if (c > 0) {
            const float p = (float)c / total;
            const float pl = plogp(p);
            const float len = lens[x];
            a_wh += len * pl;
            a_h += pl;
            a_len += len * p;
            ++distinct;
        }
    }
    a_wh = block_sum(a_wh, red_d);
    a_h = block_sum(a_h, red_d);
    a_len = block_sum(a_len, red_d);
    distinct = block_sum(distinct, red_ll);
    if (threadIdx.x == 0) {
        summary[(size_t)i * 4 + 0] = (float)-a_wh;
        summary[(size_t)i * 4 + 1] = (float)-a_h;
        summary[(size_t)i * 4 + 2] = (float)distinct / total;
        summary[(size_t)i * 4 + 3] = (float)a_len;
    }

    // weighted entropy of each bucket
    for (int b = 0; b < n_buckets; ++b) {
        const float tb = tot_b[b];
        double acc = 0.0;
        for (int x = threadIdx.x; x < v; x += blockDim.x) {
            const int c = h[(size_t)b * v + x];
            if (c > 0) acc += lens[x] * plogp((float)c / tb);
        }
        acc = block_sum(acc, red_d);
        if (threadIdx.x == 0) bucket_h[(size_t)i * n_buckets + b] = (float)-acc;
    }
}

}  // namespace

extern "C" int wef_launch(const int* codes, const int* n_valid,
                          const int* n_rows, const int* n_cols,
                          const float* lengths, long long len_stride,
                          int n, int m, int v, int n_buckets,
                          int* hist, float* summary, float* bucket_h,
                          void* stream)
{
    if (n == 0) return 0;
    if (n_buckets < 1 || n_buckets > kMaxBuckets || v < 1)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    cudaError_t e = cudaMemsetAsync(
        hist, 0, (size_t)n * n_buckets * v * sizeof(int), s);
    if (e != cudaSuccess) return (int)e;
    if (m > 0) {
        int bx = (m + kHistThreads - 1) / kHistThreads;
        if (bx > kHistMaxBlocks) bx = kHistMaxBlocks;
        wef_histogram_kernel<<<dim3(bx, n), kHistThreads, 0, s>>>(
            codes, n_valid, n_rows, n_cols, m, v, n_buckets, hist);
        e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    wef_reduce_kernel<<<n, kReduceThreads, 0, s>>>(
        hist, lengths, len_stride, n_valid, v, n_buckets, summary, bucket_h);
    return (int)cudaGetLastError();
}

extern "C" const char* wef_error_string(int e)
{
    return cudaGetErrorString((cudaError_t)e);
}
