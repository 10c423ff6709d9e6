// K5's wide route in bfloat16 on the tensor cores, CUDA for sm_90a.
//
// Replaces: the Pallas TPU kernel repro/kernels/flash_attention.py
//   flash_attention where its heads are wider than flash_attention.cu
//   takes (D or Dv above 256). kernels/attention_wide.py sends a bfloat16
//   call here; a float32 call keeps attention_wide.cu's wide_kernel (the
//   check route). K6's wide decode in bfloat16 is
//   decode_attention_wide_tc.cu's, which stages its pieces with this
//   file's copy loop (tc::stage_vec).
//
// What it computes, per (batch b, query row i, query head h), with the
//   query's KV head h / (Hq / Hkv):
//     o = softmax_j(mask(softcap(q_i . k_j / sqrt(D)))) v_j
//   softmax in float32, o in bfloat16. Query i sits at position
//   i + Sk - Sq; with `causal` key j is visible when j <= pos_i and, with
//   a window, j > pos_i - window. Masked scores are -1e30, as in
//   flash_attention.cu (a tile a row cannot see adds junk that the next
//   visible tile's correction exp(-1e30 - m) = 0 wipes out).
//
// What bounds it: at q (2, 512, 8, 320), k (2, 512, 2, 320), Dv 288,
//   causal, the bytes of q, k, v and o (12.5 MB) take 0.0037 ms at
//   3.35 TB/s and the causal products (2.5 GFLOP) 0.0025 ms at the bf16
//   tensor-core peak; so memory and latency bound it, and the design
//   aims at keeping mma.sync fed and the tiles in flight.
//
// Design: flash_attention.cu's bf16 route with D and Dv cut into pieces,
//   so that neither shared memory nor registers grow with the widths.
//   One block of 4 warps per (batch * query head, tile of 64 query rows,
//   slice of Dv), each warp owning 16 rows; the blocks of the tiles with
//   the most keys, over every head and slice, are launched first, so that
//   the longest ones do not share an SM. Dv is cut into n_vs slices of at
//   most 128 columns (equal widths, multiples of 16); each slice is a block
//   of its own that recomputes S, so O stays in float32 registers (64 a
//   thread) at any Dv. For each tile of 64 keys, S = Q.K^T is accumulated
//   on the tensor cores (mma.sync.m16n8k16, bf16 in, float32 out) over D
//   in chunks of 128 columns, each chunk of Q and of K staged together;
//   then the scale, the softcap, the mask (only on tiles that cross a mask
//   edge) and the online softmax in log2 units, in registers, as
//   flash_attention.cu does; then P, rounded to bf16 in registers, is the
//   A operand of P.V against the tile's V slice. Tiles that the causal
//   mask or the window hides from every row of the block are skipped.
//   Every piece (a Q and K chunk, or a V slice) is one item of a ring of
//   kStages slots in shared memory, filled by 16-byte cp.async kStages - 1
//   items ahead of the math, each refill issued after the item's products.
//   Rows are padded to an odd number of 16-byte units, so ldmatrix (Q, K)
//   and ldmatrix.trans (V) are free of bank conflicts. D or Dv not a
//   multiple of 8, or a base pointer off the 16-byte grid, stages through
//   plain loads (the same kernel otherwise). K/V tiles are not shared
//   across the heads of a GQA group: each query head's block reads them
//   again, from L2 at the shapes above.

// What holds it back (clock64 inside the longest block on an NVIDIA H100
//   80GB HBM3 at 700 W): a block's cp.async issue. A thread's 16-byte
//   copies issue at about one per 100 cycles (the 16 it makes for a
//   128-column Q and K chunk take ~1,700 cycles), while a copy lands ~120
//   cycles after its issue; so issue, not latency, sets the time, and
//   neither a deeper ring nor a later refill hides it. Each tile stages Q
//   again (40% of the bytes), each Dv slice stages Q and K again, and the
//   longest block (the last query tile, every key tile) walks 8 tiles
//   alone. TMA bulk copies (no per-thread issue) and K/V shared across a
//   GQA group are the levers (ROADMAP).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_common.cuh"

namespace {

using tc::bf16;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBQ = 64;                      // query rows per block
constexpr int kBK = 64;                      // keys per tile
constexpr int kWarps = 4;                    // 16 query rows each
constexpr int kThreads = kWarps * 32;
constexpr int kDC = 128;                     // columns of D per chunk
constexpr int kVS = 128;                     // widest slice of Dv
constexpr int kLDQ = kDC + 8;                // row stride of Q and K chunks
constexpr int kLDV = kVS + 8;                // row stride of a V slice
constexpr int kStages = 3;                   // ring slots
constexpr int kSlot = (kBQ + kBK) * kLDQ;    // a Q and a K chunk, elements
static_assert(kBK * kLDV <= kSlot, "a V slice must fit a ring slot");
constexpr size_t kSmem = sizeof(bf16) * kStages * (size_t)kSlot;

struct Args {
    const bf16* q; const bf16* k; const bf16* v; bf16* o;
    int Sq, Sk, Hq, Hkv, D, Dv, causal, window;
    int BH, q_tiles, n_vs;                   // the grid: B Hq x tiles x slices
    int vw;                                  // columns of a Dv slice
    float softcap, scale;
    int vec;                                 // 16-byte cp.async staging
};

__global__ void __launch_bounds__(kThreads)
wide_tc_kernel(Args a)
{
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* ring = reinterpret_cast<bf16*>(smem_raw);

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    // one index, slices fastest, then batch * head, then query tiles with
    // the most keys first, so the longest blocks start first on every SM
    const int slice = blockIdx.x % a.n_vs;
    const int rest = blockIdx.x / a.n_vs;
    const int bh = rest % a.BH;
    const int b = bh / a.Hq, h = bh % a.Hq;
    const int hk = h / (a.Hq / a.Hkv);
    const int q0 = (a.q_tiles - 1 - rest / a.BH) * kBQ;
    const int v0 = slice * a.vw;
    const int vw = min(a.vw, a.Dv - v0);
    const int vwp = (vw + 15) & ~15;
    const int nvp = vwp / 16;                // n-tile pairs of the slice
    const int offset = a.Sk - a.Sq;
    const bool vec = a.vec != 0;

    const size_t qstride = (size_t)a.Hq * a.D, kstride = (size_t)a.Hkv * a.D,
                 vstride = (size_t)a.Hkv * a.Dv;
    const bf16* qb = a.q + ((size_t)b * a.Sq + q0) * qstride + (size_t)h * a.D;
    const bf16* kb = a.k + (size_t)b * a.Sk * kstride + (size_t)hk * a.D;
    const bf16* vb = a.v + (size_t)b * a.Sk * vstride + (size_t)hk * a.Dv + v0;

    // keys that some query of this tile can see
    int k_lo = 0, k_hi = a.Sk;
    if (a.causal) {
        k_hi = min(a.Sk, min(q0 + kBQ, a.Sq) + offset);
        if (a.window > 0) k_lo = max(0, q0 + offset - a.window + 1);
    }
    const int t0 = k_lo / kBK;
    const int n_tiles = k_hi > 0 ? max(0, (k_hi + kBK - 1) / kBK - t0) : 0;
    const int nc = (a.D + kDC - 1) / kDC;    // chunks of D
    const int per_tile = nc + 1;             // nc Q/K chunks, then V
    const int n_items = n_tiles * per_tile;

    // stage item `it` into its ring slot (the caller commits)
    auto issue = [&](int it) {
        bf16* slot = ring + (it % kStages) * kSlot;
        const int tile = it / per_tile, c = it - tile * per_tile;
        const int k0 = (t0 + tile) * kBK;
        // (dst, ld, src, stride, rows, rows_valid, width, width_pad) of
        // the Q chunk, then the K chunk; or of the V slice
        auto stage = [&](bf16* d, int ld, const bf16* g, size_t st, int rows,
                         int valid, int w, int wp) {
            if (vec) tc::stage_vec<kThreads>(d, ld, g, st, rows, valid, w,
                                                  wp, tid);
            else tc::stage_rows(d, ld, g, st, rows, valid, w, wp, false, tid,
                                kThreads);
        };
        if (c < nc) {
            const int d0 = c * kDC, w = min(kDC, a.D - d0);
            const int wp = (w + 15) & ~15;
            stage(slot, kLDQ, qb + d0, qstride, kBQ, a.Sq - q0, w, wp);
            stage(slot + kBQ * kLDQ, kLDQ, kb + (size_t)k0 * kstride + d0,
                  kstride, kBK, a.Sk - k0, w, wp);
        } else {
            stage(slot, kLDV, vb + (size_t)k0 * vstride, vstride, kBK,
                  a.Sk - k0, vw, vwp);
        }
    };
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) {
        if (i < n_items) issue(i);
        tc::cp_async_commit();
    }
    // wait for the next item and return its slot; refill() then stages the
    // item kStages - 1 ahead into the slot the last one freed, after this
    // item's products have been issued
    int item = 0;
    auto advance = [&]() -> const bf16* {
        tc::cp_async_wait<kStages - 2>();    // this item landed
        __syncthreads();                     // ... and the last is consumed
        return ring + (item++ % kStages) * kSlot;
    };
    auto refill = [&]() {
        if (item + kStages - 2 < n_items) issue(item + kStages - 2);
        tc::cp_async_commit();
    };

    const int r0 = warp * 16;                // this warp's rows in the tile
    const int qpos0 = q0 + r0 + g + offset, qpos1 = qpos0 + 8;
    // scores in log2 units: x 1/sqrt(D) log2(e), so each exp is one ex2
    const float scale2 = a.scale * kLog2e;

    float oacc[2 * kVS / 16][4];
#pragma unroll
    for (int i = 0; i < 2 * kVS / 16; ++i)
        oacc[i][0] = oacc[i][1] = oacc[i][2] = oacc[i][3] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

    for (int tile = 0; tile < n_tiles; ++tile) {
        const int k0 = (t0 + tile) * kBK;

        // S = Q . K^T over the chunks of D: 16 rows x 64 keys a warp
        float s[8][4];
#pragma unroll
        for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
        for (int c = 0; c < nc; ++c) {
            const bf16* qs = advance();
            const bf16* ks = qs + kBQ * kLDQ;
            const int kst = (min(kDC, a.D - c * kDC) + 15) / 16;
#pragma unroll
            for (int kk = 0; kk < kDC / 16; ++kk) {
                if (kk >= kst) break;
                unsigned af[4];
                tc::load_a(af, qs, kLDQ, r0, kk * 16, lane);
#pragma unroll
                for (int np = 0; np < 4; ++np) {
                    unsigned bb[4];
                    tc::load_b_nk(bb, ks, kLDQ, np * 16, kk * 16, lane);
                    tc::mma(s[2 * np], af, bb[0], bb[1]);
                    tc::mma(s[2 * np + 1], af, bb[2], bb[3]);
                }
            }
            refill();
        }

        // scale, softcap, mask (only where a mask edge crosses the tile)
        const bool full = k0 + kBK <= a.Sk
            && (!a.causal || (k0 + kBK - 1 <= q0 + offset
                              && (a.window <= 0
                                  || k0 > q0 + kBQ - 1 + offset - a.window)));
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                float x;
                if (a.softcap > 0.f)
                    x = a.softcap * tanhf(s[n][e] * a.scale / a.softcap) * kLog2e;
                else
                    x = s[n][e] * scale2;
                if (!full) {
                    const int kpos = k0 + n * 8 + 2 * t + (e & 1);
                    const int qpos = e < 2 ? qpos0 : qpos1;
                    bool ok = kpos < a.Sk;
                    if (a.causal) {
                        ok = ok && kpos <= qpos;
                        if (a.window > 0) ok = ok && kpos > qpos - a.window;
                    }
                    if (!ok) x = kNegInf;
                }
                s[n][e] = x;
            }
        }

        // online softmax; the four lanes of a quad share rows g and g + 8
        float mx0 = m0, mx1 = m1;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
            mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
            mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
        }
#pragma unroll
        for (int o_ = 1; o_ <= 2; o_ <<= 1) {
            mx0 = fmaxf(mx0, __shfl_xor_sync(tc::kFull, mx0, o_));
            mx1 = fmaxf(mx1, __shfl_xor_sync(tc::kFull, mx1, o_));
        }
        const float c0 = tc::ex2(m0 - mx0), c1 = tc::ex2(m1 - mx1);
        m0 = mx0;
        m1 = mx1;
        float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
            s[n][0] = tc::ex2(s[n][0] - m0);
            s[n][1] = tc::ex2(s[n][1] - m0);
            s[n][2] = tc::ex2(s[n][2] - m1);
            s[n][3] = tc::ex2(s[n][3] - m1);
            rs0 += s[n][0] + s[n][1];
            rs1 += s[n][2] + s[n][3];
        }
        l0 = l0 * c0 + rs0;                  // per-lane partial sums
        l1 = l1 * c1 + rs1;
#pragma unroll
        for (int n = 0; n < 2 * kVS / 16; ++n) {
            oacc[n][0] *= c0; oacc[n][1] *= c0;
            oacc[n][2] *= c1; oacc[n][3] *= c1;
        }

        // O += P . V over the slice, P from the S registers as bf16
        const bf16* vs = advance();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            unsigned af[4];
            af[0] = tc::pack_bf16(s[2 * kk][0], s[2 * kk][1]);
            af[1] = tc::pack_bf16(s[2 * kk][2], s[2 * kk][3]);
            af[2] = tc::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
            af[3] = tc::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
            for (int np = 0; np < kVS / 16; ++np) {
                if (np >= nvp) break;
                unsigned bb[4];
                tc::load_b_kn(bb, vs, kLDV, kk * 16, np * 16, lane);
                tc::mma(oacc[2 * np], af, bb[0], bb[1]);
                tc::mma(oacc[2 * np + 1], af, bb[2], bb[3]);
            }
        }
        refill();
    }
    tc::cp_async_wait<0>();

#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
        l0 += __shfl_xor_sync(tc::kFull, l0, o_);
        l1 += __shfl_xor_sync(tc::kFull, l1, o_);
    }
    const float inv[2] = {1.f / fmaxf(l0, 1e-30f), 1.f / fmaxf(l1, 1e-30f)};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int qi = q0 + r0 + g + 8 * half;
        if (qi >= a.Sq) continue;
        bf16* orow = a.o + (((size_t)b * a.Sq + qi) * a.Hq + h) * a.Dv + v0;
#pragma unroll
        for (int n = 0; n < 2 * kVS / 16; ++n) {
            const int d = n * 8 + 2 * t;
            if (d >= vw) continue;
            const float y0 = oacc[n][2 * half] * inv[half];
            const float y1 = oacc[n][2 * half + 1] * inv[half];
            if ((a.Dv & 1) == 0) {
                *reinterpret_cast<__nv_bfloat162*>(orow + d) =
                    __floats2bfloat162_rn(y0, y1);
            } else {
                orow[d] = __float2bfloat16_rn(y0);
                if (d + 1 < vw) orow[d + 1] = __float2bfloat16_rn(y1);
            }
        }
    }
}

}  // namespace

// q (B, Sq, Hq, D), k (B, Sk, Hkv, D), v (B, Sk, Hkv, Dv), o (B, Sq, Hq,
// Dv), all contiguous bfloat16; any D and Dv. window <= 0: none; softcap
// <= 0: none.
extern "C" int attention_wide_tc_launch(
    const void* q, const void* k, const void* v, void* o, int B, int Sq,
    int Sk, int Hq, int Hkv, int D, int Dv, int causal, int window,
    float softcap, float scale, void* stream)
{
    if (B == 0 || Sq == 0 || Hq == 0) return 0;
    if (D < 1 || Dv < 1 || Hkv < 1 || Hq % Hkv != 0)
        return (int)cudaErrorInvalidValue;
    static int allowed[64];
    const cudaError_t e = tc::allow_smem((const void*)wide_tc_kernel, kSmem,
                                         allowed);
    if (e != cudaSuccess) return (int)e;
    const int fewest = (Dv + kVS - 1) / kVS;     // slices of Dv
    const int vw = ((Dv + fewest - 1) / fewest + 15) / 16 * 16;
    const int n_vs = (Dv + vw - 1) / vw;
    const int q_tiles = (Sq + kBQ - 1) / kBQ;
    const long long blocks = (long long)B * Hq * q_tiles * n_vs;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const bool vec = D % 8 == 0 && Dv % 8 == 0
        && ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 == 0;
    const Args a{(const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o,
                 Sq, Sk, Hq, Hkv, D, Dv, causal, window, B * Hq, q_tiles,
                 n_vs, vw, softcap, scale, (int)vec};
    wide_tc_kernel<<<(unsigned)blocks, kThreads, kSmem,
                     (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

// Dynamic shared memory of one block (bytes), the same at every width.
extern "C" long long attention_wide_tc_smem_bytes()
{
    return (long long)kSmem;
}

extern "C" const char* attention_wide_tc_error_string(int e)
{
    return cudaGetErrorString((cudaError_t)e);
}
