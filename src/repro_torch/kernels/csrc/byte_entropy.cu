// Byte histogram and Shannon entropy (bits per byte) of one payload, CUDA for
// sm_90a.
//
// Replaces: the Pallas TPU kernel repro/kernels/entropy_features.py
//   byte_entropy (_kernel). Out: hist[b] = number of bytes equal to b
//   (int32, 256 bins) and
//     entropy = -sum_b p_b log2 p_b,  p_b = hist[b] / max(n, 1), p_b > 0 only.
//   The TPU version added a one-hot (block, 256) matrix product per block
//   into a float32 VMEM histogram carried across its sequential grid, which
//   is exact only up to 2^24 counts per bin; this one counts in int32, like
//   the reference byte_entropy_ref.
//
// What bounds it here: memory, n bytes read once; the 256 bins and the
//   entropy are 1 KB out. At the sizes it is called with (1-4 MiB) the bytes
//   take about 1 us, so the fixed costs of a call set its time. The parent
//   took two launches: its caller zeroed the histogram with a memset launch
//   first.
//
// Design: one launch, no zeroed buffer per call.
//   * Each warp counts into its own 256-bin shared-memory histogram with
//     one integer atomic a byte, reading 16 bytes a lane a step (the
//     unaligned head and the tail byte by byte); one block per SM.
//   * Each block adds its 256 counts into integer totals with atomics
//     (exact in any order). A completion counter beside them elects the
//     last block, which reads the totals, writes hist, sets totals and
//     counter back to 0 for the next call, and adds the 256 terms p log2 p
//     in a fixed shared-memory tree, so the entropy is the same on every
//     run. A constant payload has p = 1, log2 1 = 0, and gives exactly 0.
//     The totals live with the caller, zeroed once when made (one set per
//     device and stream).
//   Nothing merges a warp's equal bytes before adding them. On an H100 the
//   lanes that add to one bin cost little: chip_smoke.py times this kernel
//   on 4 MiB of random bytes beside 4 MiB of trained bf16 weights (whose
//   every second byte takes a handful of values), and PERF.md keeps both.
//   Merging with __match_any_sync, and per-thread 8-bit counters that no
//   two threads share, were both slower in trials: the match costs more
//   than the collisions, and clearing and flushing private counters costs
//   as much as the counting at these sizes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBins = 256;
constexpr int kThreads = 256;        // one thread per bin at the end
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ void count_word(unsigned* h, uint32_t w)
{
    atomicAdd(&h[w & 0xffu], 1u);
    atomicAdd(&h[(w >> 8) & 0xffu], 1u);
    atomicAdd(&h[(w >> 16) & 0xffu], 1u);
    atomicAdd(&h[w >> 24], 1u);
}

__global__ void __launch_bounds__(kThreads)
byte_entropy_kernel(const uint8_t* __restrict__ data, long long n,
                    long long head, unsigned* __restrict__ acc,
                    int* __restrict__ hist, float* __restrict__ entropy)
{
    __shared__ unsigned sh[kWarps][kBins];
    __shared__ float terms[kBins];
    __shared__ bool last;
    const int t = threadIdx.x;
    for (int i = t; i < kWarps * kBins; i += kThreads) (&sh[0][0])[i] = 0u;
    __syncthreads();

    unsigned* mine = sh[t / 32];
    const long long tid = (long long)blockIdx.x * kThreads + t;
    const long long stride = (long long)gridDim.x * kThreads;
    for (long long i = tid; i < head; i += stride)         // unaligned head
        atomicAdd(&mine[data[i]], 1u);
    const uint4* body = reinterpret_cast<const uint4*>(data + head);
    const long long n16 = (n - head) / 16;
    for (long long i = tid; i < n16; i += stride) {
        const uint4 w = body[i];
        count_word(mine, w.x);
        count_word(mine, w.y);
        count_word(mine, w.z);
        count_word(mine, w.w);
    }
    for (long long i = head + n16 * 16 + tid; i < n; i += stride)   // tail
        atomicAdd(&mine[data[i]], 1u);
    __syncthreads();

    unsigned c = 0;
    for (int w = 0; w < kWarps; ++w) c += sh[w][t];
    if (c) atomicAdd(&acc[t], c);
    __threadfence();                     // this block's counts before its vote
    __syncthreads();
    if (t == 0) last = atomicAdd(&acc[kBins], 1u) == gridDim.x - 1;
    __syncthreads();
    if (!last) return;

    __threadfence();
    const int h = (int)__ldcg(&acc[t]);
    acc[t] = 0u;                         // ready for the next call
    if (t == 0) acc[kBins] = 0u;
    hist[t] = h;
    const float p = (float)h / fmaxf((float)n, 1.0f);
    terms[t] = p > 0.f ? p * log2f(fmaxf(p, 1e-30f)) : 0.f;
    __syncthreads();
    for (int s = kBins / 2; s > 0; s >>= 1) {
        if (t < s) terms[t] += terms[t + s];
        __syncthreads();
    }
    if (t == 0) *entropy = 0.f - terms[0];
}

}  // namespace

// data: n bytes (any alignment); blocks: the grid; acc: 256 bin totals and
// the completion counter, all 0 before the launch and left 0 by it; hist:
// 256 int32; entropy: one float32.
extern "C" int byte_entropy_launch(const uint8_t* data, long long n,
                                   int blocks, unsigned* acc, int* hist,
                                   float* entropy, void* stream)
{
    if (n < 0 || blocks < 1) return (int)cudaErrorInvalidValue;
    const long long head = n == 0 ? 0 :
        (long long)((16 - (reinterpret_cast<uintptr_t>(data) & 15)) & 15);
    const long long h = head < n ? head : n;
    byte_entropy_kernel<<<(unsigned)blocks, kThreads, 0,
                          (cudaStream_t)stream>>>(data, n, h, acc, hist,
                                                  entropy);
    return (int)cudaGetLastError();
}

extern "C" const char* byte_entropy_error_string(int e)
{
    return cudaGetErrorString((cudaError_t)e);
}
