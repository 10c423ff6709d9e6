// Flash attention (forward, online softmax) for prefill on Hopper's
// warpgroup tensor cores, CUDA for sm_90a: K5's route `wgmma`.
//
// Replaces: the Pallas TPU kernel repro/kernels/flash_attention.py
//   flash_attention (_kernel), for bfloat16 calls with more than one query
//   whose heads TMA can address: D and Dv multiples of 8 from 32 to 256, q,
//   k and v on 16-byte bases. It computes what flash_attention.cu computes
//   (see there: the positions, the causal mask and window, the softcap,
//   the -1e30 mask value), o in bf16.
//
// What bounds it here: at the zoo's prefill shapes the bytes of q, k, v
//   and o take 0.01-0.03 ms at 3.35 TB/s, and where the keys are many the
//   products take longer: whisper's encoder (4 x 12 heads, 1,500 x 1,500
//   pairs of 64) 0.028 ms and vision's cross prefill (4 x 64 heads, 512 x
//   4,100 pairs of 128) 0.278 ms at the bf16 peak of 989 TFLOP/s. That peak
//   is reached only by wgmma (mma.sync, flash_attention.cu's bf16_tc
//   route, reaches 12% of it there), and fed only if the copies cost the
//   math's threads no issue slots: TMA.
//
// Design (FlashAttention-3's shape): one block per (batch * head, 128
//   queries), q-tiles with the most keys first; 9 warps: two consumer
//   warpgroups of 64 query rows each and a producer warp. The producer's first
//   lane loads the block's Q once and then K and V tiles of BK keys into a
//   ring of stages by TMA (cp.async.bulk.tensor, 4-D tensor maps over (D,
//   heads, S, B) encoded on the host, boxes of 64 columns x rows), each
//   stage's K and V completing on their own mbarrier so that S = Q.K^T starts
//   while V is in flight; the consumers give a stage back on an `empty`
//   mbarrier (one arrival a warp). Every tile lies in shared memory as panels
//   of 64 columns with TMA's 128-byte swizzle, the layout wgmma's descriptors
//   read: columns past D (Dv) are zero-filled by TMA (the tensor map's
//   innermost extent is D), so D 80 and 192 need no padding copy, and rows
//   past Sq or Sk read as zeros. S = Q.K^T: wgmma.m64nBKk16, Q and K both
//   K-major through descriptors, 4 k-steps a 64-column panel of D (zeros past
//   D). Then in f32 registers: x 1/sqrt(D), softcap, the -1e30 mask (only on
//   tiles that cross a mask edge, or the Sk tail), the online max and sum
//   across the quad of lanes that share a row, in log2 units (one ex2 a
//   score). P is rounded to bf16 once a tile in registers, where the
//   accumulator layout of S is the A fragment layout of P.V: O += P.V by
//   wgmma.m64n64k16 with A from registers and V through a transposed
//   (MN-major) descriptor, one product per 64 columns of Dv, at most 128
//   columns a launch (wider Dv runs in slices of 128, Q.K^T again in each): O
//   of 128 columns, S of the next tile and P of this one together fit the 168
//   registers a thread that 9 warps leave (an SM's registers lie in four
//   quarters of 16,384, and one of them holds three warps). Within a warpgroup
//   the tiles overlap: S of tile i + 1 is issued before P.V of tile i, so the
//   softmax of tile i + 1 (ex2 and the CUDA cores; its softcap and mask
//   branches taken once a tile) runs while P.V of tile i is on the tensor
//   cores; O is rescaled and the next P packed once P.V is done. O stays in
//   f32 registers and is divided once at the end. Tiles that the causal mask
//   or the window hides from every query of the block are skipped. Key tiles:
//   128 keys where one V panel is taken, else 64; then as many stages as fit
//   in 227 KB, up to four (the zoo's widths: four; D 192 with Dv 128: 214,120
//   bytes).

#include <cuda.h>             // CUtensorMap and its enums; the encoder is
                              // looked up at run time (encoder() below)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_common.cuh"

namespace {

using tc::bf16;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBQ = 128;                     // query rows a block
constexpr int kConsumers = 256;              // two warpgroups of 64 rows
constexpr int kThreads = kConsumers + 32;    // and a producer warp
constexpr int kMaxStages = 4;                // the ring's depth at most
constexpr int kSliceNV = 2;                  // V panels a launch: Dv slices
                                             // of 128 columns
constexpr int kPanelCols = 64;               // bf16 columns of a 128-byte row
constexpr int kRowBytes = 128;
constexpr int kMaxSmem = 232448;             // 227 KB, a block's limit
constexpr int kMaxWidth = 256;

// ------------------------------------------------------------- PTX pieces
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes)
{
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar)
{
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(bar) : "memory");
}
// Wait until the phase of parity `parity` of bar has completed. A wait
// that outlasts 2^34 cycles (about 9 s, far beyond any tile's copy) traps,
// so that a lost copy fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity)
{
    uint32_t done;
    long long t0 = -1;
    for (;;) {
        asm volatile("{\n.reg .pred p;\n"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     "selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(bar), "r"(parity) : "memory");
        if (done) return;
        const long long now = clock64();
        if (t0 < 0) t0 = now;
        else if (now - t0 > (1ll << 34)) __trap();
    }
}

// One box of the tensor map into shared memory at dst; completes on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2, int c3)
{
    asm volatile("cp.async.bulk.tensor.4d.shared::cluster.global"
                 ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}],"
                 " [%2];\n"
                 :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
                    "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}

// wgmma descriptor of a 128-byte-swizzled operand at shared address addr:
// 8-row groups 1,024 bytes apart (SBO); the leading offset is unused by
// these layouts (K-major within one 128-byte row, or MN-major of 64
// columns, one swizzle atom wide)
__device__ __forceinline__ uint64_t desc(uint32_t addr)
{
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16)
        | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wg_fence()
{
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit()
{
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait()
{
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keep the compiler from moving uses of an accumulator across the
// asynchronous products that write it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N])
{
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(unsigned (&r)[N][4])
{
#pragma unroll
    for (int i = 0; i < N; ++i)
        asm volatile("" : "+r"(r[i][0]), "+r"(r[i][1]), "+r"(r[i][2]),
                     "+r"(r[i][3]) :: "memory");
}

// d (+)= A . B^T over one k-step of 16: A 64 x 16 and B 64 x 16, both
// K-major in shared memory (descriptors a, b); accumulate 0 overwrites d
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate)
{
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= A . B^T over one k-step of 16: A 64 x 16 and B 128 x 16, both
// K-major in shared memory (descriptors a, b); accumulate 0 overwrites d
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                         uint64_t b, int accumulate)
{
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= P . V over one k-step of 16 keys: P 64 x 16 from registers (the
// A fragments a), V 16 x 64 MN-major in shared memory (descriptor b,
// transposed); accumulate 0 overwrites d
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const unsigned (&a)[4],
                                         uint64_t b, int accumulate)
{
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate));
}

// ------------------------------------------------------------------ kernel
struct Layout {
    uint32_t q, k, v, bars;     // offsets from the 1,024-aligned base
    uint32_t k_stage, v_stage;  // bytes of one stage of K, of V
    uint32_t bytes;             // dynamic shared memory to ask for
};

// KD and NV: 64-column panels of D and of Dv
__host__ __device__ inline Layout layout(int BK, int NV, int KD, int stages)
{
    Layout L;
    L.q = 0;
    L.k_stage = (uint32_t)(KD * BK * kRowBytes);
    L.v_stage = (uint32_t)(NV * BK * kRowBytes);
    L.k = L.q + (uint32_t)(KD * kBQ * kRowBytes);
    L.v = L.k + stages * L.k_stage;
    L.bars = L.v + stages * L.v_stage;
    L.bytes = 1024 + L.bars + 8 * (1 + 3 * stages);
    return L;
}

// Scale, softcap (kCap) and mask (kMask: a tile that crosses a mask edge)
// one tile of scores in place (log2 units; -1e30 where masked), then the
// online softmax of this thread's rows r, r + 8: the new row maxima m0,
// m1, the rescale factors c0, c1 of what came before, P = ex2(s - m) in
// place and l updated (per-lane partial sums; the quad of lanes sharing a
// row holds its columns 2t, 2t + 1 of every 8)
template <int BK, bool kCap, bool kMask>
__device__ __forceinline__ void softmax_tile(
    float (&sc)[BK / 2], int k0, int Sk, int causal, int window,
    int qpos0, int qpos1, int t, float scale, float scale2, float softcap,
    float& m0, float& m1, float& l0, float& l1, float& c0, float& c1)
{
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            float x = sc[4 * n + e];
            if (kCap)
                x = softcap * tanhf(x * scale / softcap) * kLog2e;
            else
                x *= scale2;
            if (kMask) {
                const int kpos = k0 + n * 8 + 2 * t + (e & 1);
                const int qpos = e < 2 ? qpos0 : qpos1;
                bool ok = kpos < Sk;
                if (causal) {
                    ok = ok && kpos <= qpos;
                    if (window > 0) ok = ok && kpos > qpos - window;
                }
                if (!ok) x = kNegInf;
            }
            sc[4 * n + e] = x;
        }
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * n], sc[4 * n + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
    }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(tc::kFull, mx0, o_));
        mx1 = fmaxf(mx1, __shfl_xor_sync(tc::kFull, mx1, o_));
    }
    c0 = tc::ex2(m0 - mx0);
    c1 = tc::ex2(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
        sc[4 * n] = tc::ex2(sc[4 * n] - m0);
        sc[4 * n + 1] = tc::ex2(sc[4 * n + 1] - m0);
        sc[4 * n + 2] = tc::ex2(sc[4 * n + 2] - m1);
        sc[4 * n + 3] = tc::ex2(sc[4 * n + 3] - m1);
        rs0 += sc[4 * n] + sc[4 * n + 1];
        rs1 += sc[4 * n + 2] + sc[4 * n + 3];
    }
    l0 = l0 * c0 + rs0;
    l1 = l1 * c1 + rs1;
}

// P in bf16, rounded once: the A fragments of the tile's 16-key k-steps
template <int BK>
__device__ __forceinline__ void pack_p(const float (&sc)[BK / 2],
                                       unsigned (&pf)[BK / 16][4])
{
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
        pf[kk][0] = tc::pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
        pf[kk][1] = tc::pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pf[kk][2] = tc::pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pf[kk][3] = tc::pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
}

template <int BK, int NV, int KD>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(__grid_constant__ const CUtensorMap tq,
                   __grid_constant__ const CUtensorMap tk,
                   __grid_constant__ const CUtensorMap tv,
                   bf16* __restrict__ o, int Sq, int Sk, int Hq, int Hkv,
                   int D, int Dv, int dv0, int causal, int window,
                   float softcap, float scale, int stages)
{
    extern __shared__ unsigned char smem_raw[];
    const uint32_t base = (tc::smem_u32(smem_raw) + 1023u) & ~1023u;
    const Layout L = layout(BK, NV, KD, stages);
    const uint32_t q_s = base + L.q, k_s = base + L.k, v_s = base + L.v;
    const uint32_t bar_q = base + L.bars;
    auto bar_k = [&](int s) { return bar_q + 8u * (1 + s); };
    auto bar_v = [&](int s) { return bar_q + 8u * (1 + stages + s); };
    auto bar_e = [&](int s) { return bar_q + 8u * (1 + 2 * stages + s); };

    const int tid = threadIdx.x;
    const int bh = blockIdx.x;
    const int b = bh / Hq, h = bh % Hq;
    const int hk = h / (Hq / Hkv);
    const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // most keys first
    const int offset = Sk - Sq;

    // keys that some query of this tile can see
    int k_lo = 0, k_hi = Sk;
    if (causal) {
        k_hi = min(Sk, min(q0 + kBQ, Sq) + offset);
        if (window > 0) k_lo = max(0, q0 + offset - window + 1);
    }
    const int t0 = k_lo / BK;
    const int n_tiles = k_hi > 0 ? max(0, (k_hi + BK - 1) / BK - t0) : 0;

    if (tid == 0) {
        mbar_init(bar_q, 1);
        for (int s = 0; s < stages; ++s) {
            mbar_init(bar_k(s), 1);
            mbar_init(bar_v(s), 1);
            mbar_init(bar_e(s), kConsumers / 32);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // the warpgroup, as a value the compiler knows is uniform in a warp
    const int wg = __shfl_sync(tc::kFull, tid / 128, 0);
    if (wg == kConsumers / 128) {            // the producer warp
        if (tid == kConsumers) {
            mbar_expect_tx(bar_q, (uint32_t)(KD * kBQ * kRowBytes));
            for (int p = 0; p < KD; ++p)
                tma_load(q_s + p * kBQ * kRowBytes, &tq, bar_q,
                         p * kPanelCols, h, q0, b);
            for (int it = 0; it < n_tiles; ++it) {
                const int s = it % stages;
                if (it >= stages)            // the consumers gave it back
                    mbar_wait(bar_e(s), (uint32_t)((it / stages - 1) & 1));
                const int k0 = (t0 + it) * BK;
                mbar_expect_tx(bar_k(s), L.k_stage);
                for (int p = 0; p < KD; ++p)
                    tma_load(k_s + s * L.k_stage + p * BK * kRowBytes, &tk,
                             bar_k(s), p * kPanelCols, hk, k0, b);
                mbar_expect_tx(bar_v(s), L.v_stage);
                for (int p = 0; p < NV; ++p)
                    tma_load(v_s + s * L.v_stage + p * BK * kRowBytes, &tv,
                             bar_v(s), dv0 + p * kPanelCols, hk, k0, b);
            }
        }
    } else {
        // consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of the block
        const int warp = (tid >> 5) & 3, lane = tid & 31;
        const int g = lane >> 2, t = lane & 3;
        const int r0 = wg * 64 + warp * 16 + g;  // rows r0, r0 + 8
        const int qpos0 = q0 + r0 + offset, qpos1 = qpos0 + 8;
        // scores are kept in log2 units: x 1/sqrt(D) log2(e), so that
        // exp(s - m) is one ex2 of a difference
        const float scale2 = scale * kLog2e;
        const uint32_t q_wg = q_s + wg * 64 * kRowBytes;
        // a tile is full when every query of the block sees every key of it
        auto is_full = [&](int k0) {
            return k0 + BK <= Sk
                && (!causal || (k0 + BK - 1 <= q0 + offset
                                && (window <= 0
                                    || k0 > q0 + kBQ - 1 + offset - window)));
        };
        // S = Q . K^T of the tile in stage s: 64 rows x BK keys a warpgroup,
        // issued and committed, not waited for
        auto issue_s = [&](float (&sc)[BK / 2], int s) {
            const uint32_t kt = k_s + s * L.k_stage;
            fence_regs(sc);
            wg_fence();
#pragma unroll
            for (int kk = 0; kk < 4 * KD; ++kk) {  // D's columns past D are 0
                const uint32_t col = (uint32_t)((kk & 3) * 32);
                const int p = kk >> 2;
                wgmma_ss(sc, desc(q_wg + p * kBQ * kRowBytes + col),
                         desc(kt + p * BK * kRowBytes + col), kk > 0);
            }
            wg_commit();
        };

        float oacc[NV][32];
#pragma unroll
        for (int c = 0; c < NV; ++c)
#pragma unroll
            for (int i = 0; i < 32; ++i) oacc[c][i] = 0.f;
        float sacc[BK / 2];
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) sacc[i] = 0.f;
        unsigned pf[BK / 16][4];
        float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
        float c0 = 1.f, c1 = 1.f;
        // the softmax of the tile at key k0, its branches taken once a tile
        auto softmax = [&](int k0) {
#define SOFTMAX(cap, mask)                                                \
            softmax_tile<BK, cap, mask>(sacc, k0, Sk, causal, window,     \
                                        qpos0, qpos1, t, scale, scale2,   \
                                        softcap, m0, m1, l0, l1, c0, c1)
            const bool mask = !is_full(k0);
            if (softcap > 0.f) {
                if (mask) SOFTMAX(true, true); else SOFTMAX(true, false);
            } else {
                if (mask) SOFTMAX(false, true); else SOFTMAX(false, false);
            }
#undef SOFTMAX
        };

        // O += P . V of the tile in stage s, issued and committed
        auto issue_pv = [&](int s) {
            const uint32_t vt = v_s + s * L.v_stage;
#pragma unroll
            for (int c = 0; c < NV; ++c) fence_regs(oacc[c]);
            fence_regs(pf);
            wg_fence();
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
                for (int c = 0; c < NV; ++c)
                    wgmma_rs(oacc[c], pf[kk],
                             desc(vt + (c * BK + kk * 16) * kRowBytes), 1);
            }
            wg_commit();
        };
        // after P . V of stage s is waited for: O and P are free again, and so
        // is the stage (one arrival a warp)
        auto retire_pv = [&](int s) {
#pragma unroll
            for (int c = 0; c < NV; ++c) fence_regs(oacc[c]);
            fence_regs(pf);
            if (lane == 0) mbar_arrive(bar_e(s));
        };

        mbar_wait(bar_q, 0);
        if (n_tiles > 0) {                       // the first tile's P
            mbar_wait(bar_k(0), 0);
            issue_s(sacc, 0);
            wg_wait<0>();
            fence_regs(sacc);
            softmax(t0 * BK);
            pack_p<BK>(sacc, pf);
        }
        // Tile it's P . V runs on the tensor cores while the softmax of tile
        // it + 1, whose S was issued just before it, runs beside it. Every
        // iteration issues both products: the last tile's P . V follows the
        // loop
        for (int it = 0; it + 1 < n_tiles; ++it) {
            const int s = it % stages, s1 = (it + 1) % stages;
            mbar_wait(bar_k(s1), (uint32_t)(((it + 1) / stages) & 1));
            issue_s(sacc, s1);
            mbar_wait(bar_v(s), (uint32_t)((it / stages) & 1));
            issue_pv(s);
            wg_wait<1>();                        // S of tile it + 1 is in
            fence_regs(sacc);
            const int k1 = (t0 + it + 1) * BK;
            softmax(k1);
            wg_wait<0>();                        // P . V of tile it is in
            retire_pv(s);
#pragma unroll
            for (int c = 0; c < NV; ++c) {
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    oacc[c][4 * j] *= c0;
                    oacc[c][4 * j + 1] *= c0;
                    oacc[c][4 * j + 2] *= c1;
                    oacc[c][4 * j + 3] *= c1;
                }
            }
            pack_p<BK>(sacc, pf);
        }
        if (n_tiles > 0) {                       // the last tile's P . V
            const int s = (n_tiles - 1) % stages;
            mbar_wait(bar_v(s), (uint32_t)(((n_tiles - 1) / stages) & 1));
            issue_pv(s);
            wg_wait<0>();
            retire_pv(s);
        }

#pragma unroll
        for (int o_ = 1; o_ <= 2; o_ <<= 1) {
            l0 += __shfl_xor_sync(tc::kFull, l0, o_);
            l1 += __shfl_xor_sync(tc::kFull, l1, o_);
        }
        const float inv[2] = {1.f / fmaxf(l0, 1e-30f), 1.f / fmaxf(l1, 1e-30f)};
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int qi = q0 + r0 + 8 * half;
            if (qi >= Sq) continue;
            bf16* orow = o + (((size_t)b * Sq + qi) * Hq + h) * Dv;
#pragma unroll
            for (int c = 0; c < NV; ++c) {
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    const int d = dv0 + c * kPanelCols + j * 8 + 2 * t;
                    if (d >= Dv) continue;   // Dv % 8 == 0: d + 1 < Dv too
                    const int e = 4 * j + 2 * half;
                    *reinterpret_cast<__nv_bfloat162*>(orow + d) =
                        __floats2bfloat162_rn(oacc[c][e] * inv[half],
                                              oacc[c][e + 1] * inv[half]);
                }
            }
        }
    }
}

// ------------------------------------------------------------------- host
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime
// (cudaGetDriverEntryPoint), so that the library links against nothing
// beyond the runtime
EncodeTiled encoder()
{
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 13000
        const cudaError_t e = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
        const cudaError_t e = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
        if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

// The tensor map of a contiguous bf16 (B, S, H, W) tensor as 4-D (W, H, S,
// B), boxes of 64 columns x 1 head x `rows` rows, 128-byte swizzle; what
// lies past W or S reads as zeros
int encode(CUtensorMap* map, const void* ptr, int B, int S, int H, int W,
           int rows)
{
    EncodeTiled fn = encoder();
    if (fn == nullptr) return (int)cudaErrorNotSupported;
    const cuuint64_t dims[4] = {(cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)S,
                                (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)W * 2, (cuuint64_t)H * W * 2,
                                   (cuuint64_t)S * H * W * 2};
    const cuuint32_t box[4] = {(cuuint32_t)kPanelCols, 1, (cuuint32_t)rows, 1};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                          const_cast<void*>(ptr), dims, strides, box, unit,
                          CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Keys a tile and stages of the ring for NV panels of V and KD of D: 128
// keys for one V panel (S, P and O then take 128 of a consumer thread's
// 168 registers), else 64; then as many stages as fit, up to kMaxStages
void plan(int NV, int KD, int& BK, int& stages)
{
    BK = NV == 1 ? 128 : 64;
    stages = 2;
    while (stages < kMaxStages
           && layout(BK, NV, KD, stages + 1).bytes <= (uint32_t)kMaxSmem)
        ++stages;
}

// The instantiations (BK, NV, KD) that plan picks for a slice of Dv and D
// from 8 to 256: every k-step loop is unrolled, so the products of one
// tile issue back to back
#define WGMMA_SHAPES(X)                                                   \
    X(128, 1, 1) X(128, 1, 2) X(128, 1, 3) X(128, 1, 4)                   \
    X(64, 2, 1) X(64, 2, 2) X(64, 2, 3) X(64, 2, 4)

const void* pick(int BK, int NV, int KD)
{
#define X(bk, nv, kd) \
    if (BK == bk && NV == nv && KD == kd) \
        return (const void*)flash_wgmma_kernel<bk, nv, kd>;
    WGMMA_SHAPES(X)
#undef X
    return nullptr;
}

}  // namespace

// q (B, Sq, Hq, D), k (B, Sk, Hkv, D), v (B, Sk, Hkv, Dv), o (B, Sq, Hq,
// Dv): contiguous bf16 on 16-byte bases; D and Dv multiples of 8, at most
// 256. window <= 0: none; softcap <= 0: none.
extern "C" int flash_attention_wgmma_launch(
    const void* q, const void* k, const void* v, void* o, int B, int Sq,
    int Sk, int Hq, int Hkv, int D, int Dv, int causal, int window,
    float softcap, float scale, void* stream)
{
    if (B == 0 || Sq == 0) return 0;
    if (D < 8 || D > kMaxWidth || D % 8 || Dv < 8 || Dv > kMaxWidth || Dv % 8
        || Hkv < 1 || Hq % Hkv != 0
        || ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16)
        return (int)cudaErrorInvalidValue;
    const int KD = (D + kPanelCols - 1) / kPanelCols;
    CUtensorMap tq, tk, tv;
    int rc = encode(&tq, q, B, Sq, Hq, D, kBQ);
    if (rc != 0) return rc;
    tk = tv = tq;                       // Sk 0: no tile is loaded
    const dim3 grid(B * Hq, (Sq + kBQ - 1) / kBQ);
    cudaStream_t s = (cudaStream_t)stream;
    static int allowed[2][kSliceNV][4][64];
    // Dv in slices of kSliceNV panels, a launch each (Q . K^T again in
    // each): O of a slice stays within a consumer thread's registers
    for (int dv0 = 0; dv0 < Dv; dv0 += kSliceNV * kPanelCols) {
        const int left = (Dv - dv0 + kPanelCols - 1) / kPanelCols;
        const int NV = left < kSliceNV ? left : kSliceNV;
        int BK, stages;
        plan(NV, KD, BK, stages);
        const void* fn = pick(BK, NV, KD);
        if (fn == nullptr) return (int)cudaErrorInvalidValue;
        const Layout L = layout(BK, NV, KD, stages);
        const cudaError_t e = tc::allow_smem(
            fn, L.bytes, allowed[BK == 128][NV - 1][KD - 1]);
        if (e != cudaSuccess) return (int)e;
        if (Sk > 0) rc = encode(&tk, k, B, Sk, Hkv, D, BK);
        if (rc == 0 && Sk > 0) rc = encode(&tv, v, B, Sk, Hkv, Dv, BK);
        if (rc != 0) return rc;
        rc = (int)cudaErrorInvalidValue;
#define X(bk, nv, kd)                                                       \
        if (BK == bk && NV == nv && KD == kd) {                             \
            flash_wgmma_kernel<bk, nv, kd><<<grid, kThreads, L.bytes, s>>>( \
                tq, tk, tv, (bf16*)o, Sq, Sk, Hq, Hkv, D, Dv, dv0, causal,  \
                window, softcap, scale, stages);                            \
            rc = (int)cudaGetLastError();                                   \
        }
        WGMMA_SHAPES(X)
#undef X
        if (rc != 0) return rc;
    }
    return 0;
}

// The kernel taken at widths D, Dv (for its first slice of Dv): attr[0]
// registers, attr[1] dynamic shared memory (bytes), attr[2] keys a tile,
// attr[3] local (spilled) bytes a thread, attr[4] stages of the ring,
// attr[5] launches a call (slices of Dv). Launches nothing.
extern "C" int flash_attention_wgmma_info(int D, int Dv, int* attr)
{
    if (D < 8 || D > kMaxWidth || Dv < 8 || Dv > kMaxWidth)
        return (int)cudaErrorInvalidValue;
    const int panels = (Dv + kPanelCols - 1) / kPanelCols;
    const int NV = panels < kSliceNV ? panels : kSliceNV;
    const int KD = (D + kPanelCols - 1) / kPanelCols;
    int BK, stages;
    plan(NV, KD, BK, stages);
    cudaFuncAttributes a;
    const cudaError_t e = cudaFuncGetAttributes(&a, pick(BK, NV, KD));
    if (e != cudaSuccess) return (int)e;
    attr[0] = a.numRegs;
    attr[1] = (int)layout(BK, NV, KD, stages).bytes;
    attr[2] = BK;
    attr[3] = (int)a.localSizeBytes;
    attr[4] = stages;
    attr[5] = (Dv + kSliceNV * kPanelCols - 1) / (kSliceNV * kPanelCols);
    return 0;
}

extern "C" const char* flash_attention_wgmma_error_string(int e)
{
    return cudaGetErrorString((cudaError_t)e);
}
