// Fractional-overlap matrix for G-PART's candidate graph, CUDA for sm_90a.
//
// Replaces: the Pallas TPU kernel repro/kernels/overlap.py
//   fractional_overlap_matrix (_overlap_kernel). For code rows A (NA, M)
//   and B (NB, M), file sizes (F,) and spans, it computes
//     inter[i,j] = sum(sizes[c] for c in codes_i & codes_j)
//     w[i,j]     = inter > 0 ? inter / max(span_i + span_j - inter, 1e-12) : 0
//   in float32. The TPU version built (rows x files) one-hot slabs so the
//   intersection became a matrix product on its MXU.
//
// What bounds it here: memory and latency, not arithmetic. The work is one
//   add per shared file, a few hundred per pair at the main path's shapes,
//   far below the card's float32 rate; the bytes are the code rows, the
//   sizes and the (NA, NB) output. A one-hot product would instead touch
//   NA*NB*F cells, almost all of them zero.
//
// Design: one block per row i and 128 columns j. The block stages row i's
//   sorted codes and their sizes in shared memory (8 bytes per code). Each
//   thread owns one j, walks row j's sorted codes and binary-searches each in
//   row i, accumulating the matched sizes in float32 in ascending code order.
//   B is passed transposed, (M, NB), so a warp's 32 threads read 32
//   neighbouring words at every step. The weight is finalised in the same
//   thread; `inter` is a sum of positive sizes, so it is exactly 0.0 only when
//   the intersection is empty, which keeps G-PART's `w > 0` pattern exact.
//   No tensor cores, no TF32.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
overlap_kernel(const int* __restrict__ codes_a,     // (NA, ma) ascending, pads last
               const int* __restrict__ lens_a,      // (NA,)
               const float* __restrict__ spans_a,   // (NA,)
               const int* __restrict__ codes_bt,    // (mb, NB) ascending per column
               const int* __restrict__ lens_b,      // (NB,)
               const float* __restrict__ spans_b,   // (NB,)
               const float* __restrict__ sizes,     // (F,)
               int nb, int ma,
               float* __restrict__ out)             // (NA, NB)
{
    extern __shared__ unsigned char smem_raw[];
    int* row_codes = reinterpret_cast<int*>(smem_raw);
    float* row_sizes = reinterpret_cast<float*>(row_codes + ma);

    const int i = blockIdx.x;
    const int len_i = lens_a[i];
    for (int t = threadIdx.x; t < len_i; t += blockDim.x) {
        const int c = codes_a[(size_t)i * ma + t];
        row_codes[t] = c;
        row_sizes[t] = sizes[c];
    }
    __syncthreads();

    const int j = blockIdx.y * blockDim.x + threadIdx.x;
    if (j >= nb) return;
    const int len_j = lens_b[j];
    float inter = 0.f;
    for (int t = 0; t < len_j; ++t) {
        const int c = codes_bt[(size_t)t * nb + j];
        int lo = 0, hi = len_i;
        while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (row_codes[mid] < c) lo = mid + 1; else hi = mid;
        }
        if (lo < len_i && row_codes[lo] == c) inter += row_sizes[lo];
    }
    const float den = spans_a[i] + spans_b[j] - inter;
    out[(size_t)i * nb + j] = inter > 0.f ? inter / fmaxf(den, 1e-12f) : 0.f;
}

}  // namespace

extern "C" int overlap_launch(const int* codes_a, const int* lens_a,
                              const float* spans_a, const int* codes_bt,
                              const int* lens_b, const float* spans_b,
                              const float* sizes, int na, int nb, int ma,
                              float* out, void* stream)
{
    if (na == 0 || nb == 0) return 0;
    const size_t smem = (size_t)ma * (sizeof(int) + sizeof(float));
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            overlap_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const dim3 grid(na, (nb + kThreads - 1) / kThreads);
    overlap_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        codes_a, lens_a, spans_a, codes_bt, lens_b, spans_b, sizes, nb, ma,
        out);
    return (int)cudaGetLastError();
}

extern "C" const char* overlap_error_string(int e)
{
    return cudaGetErrorString((cudaError_t)e);
}
