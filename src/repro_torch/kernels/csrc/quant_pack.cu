// Int8 block quantisation with one absmax scale per 256 values, CUDA for
// sm_90a.
//
// Replaces: the Pallas TPU kernel repro/kernels/quant_pack.py quant_pack
//   (_kernel). For each block of 256 float32 values
//     scale = max(max|x|, 1e-12) / 127
//     q     = clip(round_half_even(x / scale), -127, 127)   (int8)
//   The TPU version walked (256 rows x 256) VMEM tiles over a parallel grid.
//
// What bounds it here: memory. Each value is read once (4 bytes) and written
//   once (1 byte), plus 4 bytes of scale per 256 values; the arithmetic (one
//   division, one round and two compares per value) is far below the card's
//   rate. For the whole zamba2-2.7b gradient (2.34e9 values) that is about
//   11.7 GB, or 3.5 ms at 3.35 TB/s.
//
// Design: one warp per 256-value block, eight blocks per CTA. Each lane
//   loads its 8 consecutive values as two 16-byte loads (a warp reads its
//   1 KB block in two fully coalesced requests), the absmax is a 5-step
//   butterfly of warp shuffles, and each lane stores its 8 int8 values as
//   one 8-byte word; lane 0 writes the scale. Nothing is staged in shared
//   memory. To be bit-equal with the TPU kernel and the plain version:
//   the quotient is x / scale (IEEE division, not a multiply by 1/scale),
//   rintf rounds half to even like jnp.round and torch.round, and the file
//   is built without --use_fast_math, which would make the division
//   approximate. A block of zeros gets the scale 1e-12/127 and q = 0.
//   NaN inputs are not given the TPU kernel's result (fmaxf drops NaN in
//   the absmax); gradients that reach this kernel are finite.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;          // values per scale
constexpr int kWarps = 8;            // 256-value blocks per CTA

__global__ void __launch_bounds__(32 * kWarps)
quant_pack_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                  float* __restrict__ scale, long long n_blocks)
{
    const long long blk = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
    if (blk >= n_blocks) return;                  // whole warps leave together
    const int lane = threadIdx.x & 31;
    const float4* src = reinterpret_cast<const float4*>(x + blk * kBlock) +
                        lane * 2;
    const float4 a = src[0], b = src[1];
    const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    float m = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) m = fmaxf(m, fabsf(v[i]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    const float s = fmaxf(m, 1e-12f) / 127.0f;
    uint32_t word[2] = {0u, 0u};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const float r = fminf(fmaxf(rintf(v[i] / s), -127.f), 127.f);
        word[i / 4] |= (uint32_t)(uint8_t)(int8_t)(int)r << (8 * (i % 4));
    }
    reinterpret_cast<uint2*>(q + blk * kBlock)[lane] =
        make_uint2(word[0], word[1]);
    if (lane == 0) scale[blk] = s;
}

}  // namespace

// x: n_blocks * 256 float32, 16-byte aligned; q: as many int8; scale:
// n_blocks float32.
extern "C" int quant_pack_launch(const float* x, int8_t* q, float* scale,
                                 long long n_blocks, void* stream)
{
    if (n_blocks <= 0) return 0;
    const long long grid = (n_blocks + kWarps - 1) / kWarps;
    if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    quant_pack_kernel<<<(unsigned)grid, 32 * kWarps, 0,
                        (cudaStream_t)stream>>>(x, q, scale, n_blocks);
    return (int)cudaGetLastError();
}

extern "C" const char* quant_pack_error_string(int e)
{
    return cudaGetErrorString((cudaError_t)e);
}
