// Tensor-core building blocks shared by the bfloat16 routes of
// flash_attention.cu, ssd_scan.cu, attention_wide_tc.cu and
// decode_attention_wide_tc.cu (sm_90a): 16-byte cp.async, ldmatrix and
// mma.sync.m16n8k16 with bf16 operands and f32 accumulators.
// decode_attention.cu takes its cp.async staging and allow_smem, and
// entropy_features.cu its allow_smem.
//
// Fragments of mma.sync.m16n8k16 (lane = 4 g + t, g < 8, t < 4):
//   A (16 x 16, row major): a0 = A[g][2t, 2t+1], a1 = A[g+8][2t, 2t+1],
//                           a2 = A[g][2t+8, 2t+9], a3 = A[g+8][2t+8, 2t+9]
//   B (16 x 8):             b0 = B[2t, 2t+1][g], b1 = B[2t+8, 2t+9][g]
//   C, D (16 x 8, f32):     c0, c1 = C[g][2t, 2t+1], c2, c3 = C[g+8][2t, 2t+1]
// so the accumulators of two neighbouring n-tiles are, packed to bf16, the
// A fragment of the next product over those 16 columns (FlashAttention-2's
// register reuse of P).
//
// ldmatrix.x4 reads four 8 x 8 bf16 matrices; lane l gives the address of
// row l & 7 of matrix l >> 3. The four loaders below place those rows so
// that the registers come out as whole fragments. Every tile in shared
// memory has a row stride of (a multiple of 16) + 8 elements, an odd number
// of 16-byte units, so the eight rows of one matrix fall in eight different
// bank groups.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tc {

using bf16 = __nv_bfloat16;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned smem_u32(const void* p)
{
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; src_bytes 0 writes 16 zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes)
{
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit()
{
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait()
{
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p)
{
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p)) : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const bf16* p)
{
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p)) : "memory");
}

// d += a . b over one 16 x 8 x 16 step
__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1)
{
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                 "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),
                   "r"(b0), "r"(b1));
}

// Lane offsets for ldmatrix.x4 over a 16 x 16 tile. Pattern X: matrices
// (rows 0-7, cols 0-7), (rows 8-15, cols 0-7), (rows 0-7, cols 8-15),
// (rows 8-15, cols 8-15). Pattern Y: (0-7, 0-7), (0-7, 8-15), (8-15, 0-7),
// (8-15, 8-15).
__device__ __forceinline__ int x_row(int l) { return l & 15; }
__device__ __forceinline__ int x_col(int l) { return (l >> 4) << 3; }
__device__ __forceinline__ int y_row(int l) { return (l & 7) + ((l >> 4) << 3); }
__device__ __forceinline__ int y_col(int l) { return ((l >> 3) & 1) << 3; }

// A fragment of rows m0.., depth k0.. from A stored [m][k]
__device__ __forceinline__ void load_a(unsigned (&a)[4], const bf16* s, int ld,
                                       int m0, int k0, int l)
{
    ldsm_x4(a, s + (m0 + x_row(l)) * ld + k0 + x_col(l));
}
// A fragment of rows m0.., depth k0.. from A stored transposed, [k][m]
__device__ __forceinline__ void load_a_t(unsigned (&a)[4], const bf16* s,
                                         int ld, int k0, int m0, int l)
{
    ldsm_x4_t(a, s + (k0 + y_row(l)) * ld + m0 + y_col(l));
}
// B fragments of the n-tiles n0 (b[0], b[1]) and n0 + 8 (b[2], b[3]) at
// depth k0.., from B stored [n][k]
__device__ __forceinline__ void load_b_nk(unsigned (&b)[4], const bf16* s,
                                          int ld, int n0, int k0, int l)
{
    ldsm_x4(b, s + (n0 + y_row(l)) * ld + k0 + y_col(l));
}
// the same from B stored [k][n]
__device__ __forceinline__ void load_b_kn(unsigned (&b)[4], const bf16* s,
                                          int ld, int k0, int n0, int l)
{
    ldsm_x4_t(b, s + (k0 + x_row(l)) * ld + n0 + x_col(l));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi)
{
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<unsigned*>(&v);
}

// Split two f32 values into bf16 pairs hi = bf16(v), lo = bf16(v - hi):
// hi + lo keeps v to about 2^-16 relative, so two products with an exact
// bf16 operand (hi . x + lo . x) give f32-grade results on bf16 tensor cores.
__device__ __forceinline__ void split_pack(float v0, float v1, unsigned& hi,
                                           unsigned& lo)
{
    const bf16 h0 = __float2bfloat16_rn(v0), h1 = __float2bfloat16_rn(v1);
    __nv_bfloat162 h;
    h.x = h0;
    h.y = h1;
    hi = *reinterpret_cast<unsigned*>(&h);
    lo = pack_bf16(v0 - __bfloat162float(h0), v1 - __bfloat162float(h1));
}

// Scale the two halves of a fragment register u (a bf16 pair) by s0 and
// s1 and split the f32 products into hi/lo pairs
__device__ __forceinline__ void scale_split(unsigned u, float s0, float s1,
                                            unsigned& hi, unsigned& lo)
{
    const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
    split_pack(f.x * s0, f.y * s1, hi, lo);
}

template <typename T> __device__ __forceinline__ T zero_of();
template <> __device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <> __device__ __forceinline__ bf16 zero_of<bf16>()
{
    return __float2bfloat16_rn(0.f);
}

// Stage rows [0, rows) of a matrix whose row r (of `width` elements)
// starts at src + r * stride into dst (row stride ld); rows at or past
// rows_valid and columns [width, width_pad) become zeros. vec: 16-byte
// cp.async (width a multiple of 16 bytes, src and stride 16-byte aligned;
// the caller commits and waits), plain stores for the zero columns.
// Otherwise plain loads and stores throughout. The threads walk the
// (row, piece) grid in row-major order, stepping row and column by
// addition (two divisions per call, none per piece).
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, int ld, const T* src,
                                           size_t stride, int rows,
                                           int rows_valid, int width,
                                           int width_pad, bool vec, int tid,
                                           int nthreads)
{
    constexpr int kPer = 16 / sizeof(T);
    // pieces per row, and width of a piece, for each of the two walks
    const int n_copy = vec ? width / kPer : width_pad;
    const int w_copy = vec ? kPer : 1;
    if (n_copy > 0) {
        int r = tid / n_copy, c = tid - r * n_copy;
        const int dr = nthreads / n_copy, dc = nthreads - dr * n_copy;
        for (; r < rows; r += dr, c += dc) {
            if (c >= n_copy) {
                c -= n_copy;
                ++r;
                if (r >= rows) break;
            }
            const int col = c * w_copy;
            const bool ok = r < rows_valid;
            if (vec)
                cp_async16(dst + r * ld + col, ok ? src + r * stride + col : src,
                           ok ? 16 : 0);
            else
                dst[r * ld + col] = (ok && col < width) ? src[r * stride + col]
                                                        : zero_of<T>();
        }
    }
    const int pad = vec ? width_pad - width : 0;
    if (pad > 0) {
        int r = tid / pad, c = tid - r * pad;
        const int dr = nthreads / pad, dc = nthreads - dr * pad;
        for (; r < rows; r += dr, c += dc) {
            if (c >= pad) {
                c -= pad;
                ++r;
                if (r >= rows) break;
            }
            dst[r * ld + width + c] = zero_of<T>();
        }
    }
}

// 16 bytes global -> shared (a shared-space address), asynchronously;
// bytes 0 writes 16 zeros
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           int bytes)
{
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

// Stage rows [0, rows) of a bf16 matrix whose row r (`width` elements, a
// multiple of 8) starts at src + r * stride (16-byte aligned) into dst
// (row stride ld) by 16-byte cp.async, with kThreads threads of which this
// is tid; rows at or past rows_valid become zeros, and so do columns
// [width, width_pad). Each thread keeps one column piece and steps over
// rows, so its copies' addresses are independent of one another and the
// loop unrolls: the address arithmetic of one copy does not wait on the
// last (stage_rows's running row and column made each copy wait on a
// chain of integer operations, ~30% of K5 wide's time). width / 8 at most
// kThreads.
template <int kThreads>
__device__ __forceinline__ void stage_vec(bf16* dst, int ld, const bf16* src,
                                          size_t stride, int rows,
                                          int rows_valid, int width,
                                          int width_pad, int tid)
{
    const int n_copy = width >> 3;           // 16-byte pieces a row
    const int dr = kThreads / n_copy;        // rows a pass
    const int r0 = tid / n_copy, col = (tid - r0 * n_copy) * 8;
    if (r0 < dr) {
        const unsigned s0 = smem_u32(dst + r0 * ld + col);
        const unsigned ds = (unsigned)(dr * ld * sizeof(bf16));
        const bf16* g0 = src + (size_t)r0 * stride + col;
        const size_t dg = (size_t)dr * stride;
        int k = 0;
#pragma unroll 4
        for (int r = r0; r < rows; r += dr, ++k) {
            const bool ok = r < rows_valid;
            cp_async16(s0 + k * ds, ok ? g0 + k * dg : src, ok ? 16 : 0);
        }
    }
    const int pad = width_pad - width;
    for (int e = tid; e < rows * pad; e += kThreads) {
        const int r = e / pad;
        dst[r * ld + width + (e - r * pad)] = zero_of<bf16>();
    }
}

// 2^x on the special-function unit (about 2 ulp; flushes denormals)
__device__ __forceinline__ float ex2(float x)
{
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// Allow `bytes` of dynamic shared memory for kernel fn on the current
// device; cache holds, per device, the largest size already allowed, so
// the attribute is set once per kernel and device, not per launch.
inline cudaError_t allow_smem(const void* fn, size_t bytes, int (&cache)[64])
{
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < 64 && cache[dev] >= (int)bytes) return cudaSuccess;
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
    if (e == cudaSuccess && dev < 64) cache[dev] = (int)bytes;
    return e;
}

}  // namespace tc
