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
//   entropy are 1 KB out. A byte costs one shared-memory atomic, so at the
//   sizes it is called with (1-4 MiB) the atomics and the launch, not the
//   bytes, set its time.
//
// Design: one launch. Hopper's blocks run in no order, so the TPU's carried
//   histogram becomes a two-level one: each block counts into per-warp
//   shared-memory histograms (8 x 256 uint32; a warp's lanes contend only
//   with each other), reading 16 bytes per lane per step (the unaligned head
//   and the tail byte by byte); the block then adds its 256 sums into the
//   global int32 histogram with one atomic per bin. Integer atomics make the
//   counts exact whatever their order. A completion counter elects the last
//   block to finish, which computes the 256 terms p log2 p in float32 and
//   sums them in a fixed shared-memory tree, so the entropy is the same on
//   every run. A constant payload has p = 1, log2 1 = 0, and gives exactly
//   0. The caller zeroes the histogram and the counter (one 1,028-byte
//   buffer) before the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBins = 256;
constexpr int kThreads = 256;        // one thread per bin in the merge
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 264;      // two per SM of an H100 SXM
constexpr int kBytesPerBlockStep = kThreads * 16;

__device__ __forceinline__ void count_word(unsigned* h, uint32_t w)
{
    atomicAdd(&h[w & 0xffu], 1u);
    atomicAdd(&h[(w >> 8) & 0xffu], 1u);
    atomicAdd(&h[(w >> 16) & 0xffu], 1u);
    atomicAdd(&h[w >> 24], 1u);
}

__global__ void __launch_bounds__(kThreads)
byte_entropy_kernel(const uint8_t* __restrict__ data, long long n,
                    long long head, int* __restrict__ hist,
                    unsigned* __restrict__ done, float* __restrict__ entropy)
{
    __shared__ unsigned sh[kWarps][kBins];
    __shared__ float terms[kBins];
    __shared__ bool last;
    for (int i = threadIdx.x; i < kWarps * kBins; i += kThreads)
        (&sh[0][0])[i] = 0u;
    __syncthreads();

    unsigned* mine = sh[threadIdx.x / 32];
    const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
    const long long stride = (long long)gridDim.x * kThreads;
    for (long long i = tid; i < head; i += stride)        // unaligned head
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
    for (int w = 0; w < kWarps; ++w) c += sh[w][threadIdx.x];
    if (c) atomicAdd(&hist[threadIdx.x], (int)c);
    __threadfence();                     // this block's counts before its vote
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(done, 1u) == gridDim.x - 1;
    __syncthreads();
    if (!last) return;

    __threadfence();
    const int h = atomicAdd(&hist[threadIdx.x], 0);      // a coherent read
    const float p = (float)h / fmaxf((float)n, 1.0f);
    terms[threadIdx.x] = p > 0.f ? p * log2f(fmaxf(p, 1e-30f)) : 0.f;
    __syncthreads();
    for (int s = kBins / 2; s > 0; s >>= 1) {
        if (threadIdx.x < s) terms[threadIdx.x] += terms[threadIdx.x + s];
        __syncthreads();
    }
    if (threadIdx.x == 0) *entropy = 0.f - terms[0];
}

}  // namespace

// data: n bytes (any alignment); hist_done: 257 zeroed int32 (256 bins, then
// the completion counter); entropy: one float32.
extern "C" int byte_entropy_launch(const uint8_t* data, long long n,
                                   int* hist_done, float* entropy,
                                   void* stream)
{
    if (n < 0) return (int)cudaErrorInvalidValue;
    const long long head = n == 0 ? 0 :
        (long long)((16 - (reinterpret_cast<uintptr_t>(data) & 15)) & 15);
    const long long h = head < n ? head : n;
    long long grid = (n + 4LL * kBytesPerBlockStep - 1) /
                     (4LL * kBytesPerBlockStep);
    grid = grid < 1 ? 1 : (grid > kMaxBlocks ? kMaxBlocks : grid);
    byte_entropy_kernel<<<(unsigned)grid, kThreads, 0,
                          (cudaStream_t)stream>>>(
        data, n, h, hist_done, reinterpret_cast<unsigned*>(hist_done + kBins),
        entropy);
    return (int)cudaGetLastError();
}

extern "C" const char* byte_entropy_error_string(int e)
{
    return cudaGetErrorString((cudaError_t)e);
}
