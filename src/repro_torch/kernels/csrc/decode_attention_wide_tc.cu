// K6's wide route in bfloat16 on the tensor cores, CUDA for sm_90a, in
// both of its modes.
//
// Replaces: the Pallas TPU kernel repro/kernels/decode_attention.py
//   decode_attention where its heads are wider than decode_attention.cu
//   takes (D above 576 or Dv above 512), and its partials mode (the slice
//   of a sequence-sharded cache, repro/kernels/ref.py
//   decode_attention_partials). kernels/attention_wide.py sends a bfloat16
//   call here; a float32 call keeps attention_wide.cu (the check route).
//
// What it computes, per (batch b, query head h), with the head's KV head
//   h / (Hq / Hkv) and the visible keys j in [lo, hi) (decode_attention.cuh
//   visible(): j < kv_len[b] and, with a window, j >= kv_len[b] - window;
//   in the partials mode j < kv_len[b], the slice's local length, and
//   j >= glen[b] - window - offset):
//     s_j = softcap(q . k_j / sqrt(D)),  o = sum_j e^(s_j - m) v_j / sum_j e^(s_j - m)
//   softmax in float32, o in bfloat16; in the partials mode the
//   unnormalised (acc, m, l) in float32 instead, m the largest visible
//   score, with m = -1e30, l = 0, acc = 0 where no key is visible. A
//   query with no visible key gets o = 0. v is read through its own row
//   stride ldv (Dv for a contiguous v, D where v is k's first Dv columns,
//   MLA's latent cache), so the latent cache is never copied.
//
// What bounds it: at q (4, 16, 640) against a latent cache (4, 1024, 1,
//   640) with v its first 576, the visible rows of the cache (2.6 MB)
//   take under 0.001 ms at 3.35 TB/s and the products (2 x 16 x (640 +
//   576) a key and head) less at the bf16 tensor-core peak: bytes and
//   latency bound it, and with B * Hkv = 4 groups the work has to be
//   spread over keys to reach the SMs at all.
//
// Design: the query heads of one KV group are the rows of one m16 tile
//   (MLA's 16 heads on one latent head fill it; a smaller group pads its
//   rows with zeros, a larger one takes several tiles). One block of 4
//   warps per (batch, KV head, tile of 16 heads, split of the keys, slice
//   of Dv). The keys are cut into splits of `split` keys (a multiple of 64,
//   chosen by the wrapper so that the blocks fill the card) as
//   decode_attention.cu cuts them, and Dv into n_vs slices of at most 128
//   columns as attention_wide_tc.cu cuts them, each slice a block that
//   recomputes the scores, so the output stays in float32 registers (64 a
//   thread). The block walks its keys in tiles of 64, the warps taking 16
//   keys each: S (16 heads x 16 keys) accumulates on mma.sync.m16n8k16
//   over D in chunks of 128 columns (a Q chunk and a K chunk staged
//   together), then the scale, the softcap, the mask outside [lo, hi) and
//   the warp's own online softmax in log2 units (masked keys weigh exactly
//   0), then P, rounded to bf16 in registers, is the A operand of P . V
//   against the warp's 16 rows of the tile's V slice. Every piece is one
//   item of a ring of 3 slots, filled by 16-byte cp.async two items ahead
//   of the math with tc::stage_vec (each thread one column piece stepping
//   over rows, independent addresses: 2 copies a thread for a Q chunk, 8
//   for a K chunk or a V slice). At the end the four warps' (m, l, acc)
//   meet in shared memory and merge in a fixed order; with one split the
//   block writes o (or acc, m, l), else the split's (acc, m, l) go to
//   scratch, and decode_attention.cuh's merge_kernel adds the visible
//   splits in split order, as for decode_attention.cu. Masked scores are
//   -1e30 and weigh 0, so a split, a warp or a tile that sees no key adds
//   nothing. D or Dv or ldv not a multiple of 8, or a base off the 16-byte
//   grid, stages through plain loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_attention.cuh"
#include "tc_common.cuh"

namespace {
namespace wide_tc {

using tc::bf16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kRows = 16;                    // query heads a block (m16)
constexpr int kBK = 64;                      // keys a tile, 16 a warp
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kDC = 128;                     // columns of D a chunk
constexpr int kVS = 128;                     // widest slice of Dv
constexpr int kLD = kDC + 8;                 // row stride of every piece
constexpr int kStages = 3;                   // ring slots
constexpr int kSlot = (kRows + kBK) * kLD;   // a Q and a K chunk, elements
static_assert(kBK * kLD <= kSlot, "a V slice must fit a ring slot");
constexpr size_t kSmem = sizeof(bf16) * kStages * (size_t)kSlot;
constexpr int kLdr = kVS + 2;                // a warp's merged row: acc, m, l
static_assert(sizeof(float) * kWarps * kRows * kLdr <= kSmem,
              "the warps' states must fit the ring");

struct Args {
    const bf16* q; const bf16* k; const bf16* v; bf16* o;
    const int* kv_len;
    Partials pt;                             // the partials mode's operands
    float* part;                             // (B Hq, nsplit, Dv + 2) or null
    int S, Hq, Hkv, D, Dv, ldv, window;
    int tiles, nsplit, split, n_vs, vw;      // the grid and its pieces
    float softcap, scale;
    int vec;                                 // 16-byte cp.async staging
};

template <bool kPartials>
__global__ void __launch_bounds__(kThreads)
decode_tc_kernel(Args a)
{
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* ring = reinterpret_cast<bf16*>(smem_raw);

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    int bid = blockIdx.x;                    // slices fastest, then splits
    const int slice = bid % a.n_vs;
    bid /= a.n_vs;
    const int s = bid % a.nsplit;
    bid /= a.nsplit;
    const int tile_h = bid % a.tiles;
    bid /= a.tiles;
    const int hk = bid % a.Hkv, b = bid / a.Hkv;
    const int rep = a.Hq / a.Hkv;
    const int h0 = hk * rep + tile_h * kRows;    // the tile's first head
    const int rows = min(kRows, rep - tile_h * kRows);
    const int v0 = slice * a.vw;
    const int vw = min(a.vw, a.Dv - v0);
    const int vwp = (vw + 15) & ~15;
    const int nvp = vwp / 16;                // n-tile pairs of the slice
    const bool vec = a.vec != 0;

    int lo, hi;
    visible<kPartials>(a.kv_len, a.pt, b, a.S, a.window, lo, hi);
    const int ka = max(s * a.split, lo), ke = min((s + 1) * a.split, hi);
    if (ka >= ke && a.nsplit > 1) return;    // no key of this split is seen

    const size_t kstride = (size_t)a.Hkv * a.D;
    const size_t vstride = (size_t)a.Hkv * a.ldv;
    const bf16* qb = a.q + ((size_t)b * a.Hq + h0) * a.D;
    const bf16* kb = a.k + (size_t)b * a.S * kstride + (size_t)hk * a.D;
    const bf16* vb = a.v + (size_t)b * a.S * vstride + (size_t)hk * a.ldv
                     + v0;

    const int t0 = ka / kBK;                 // the first tile of 64 keys
    const int n_tiles = ka < ke ? (ke - 1) / kBK - t0 + 1 : 0;
    const int nc = (a.D + kDC - 1) / kDC;    // chunks of D
    const int per_tile = nc + 1;             // nc Q/K chunks, then V
    const int n_items = n_tiles * per_tile;

    // stage item `it` into its ring slot (the caller commits)
    auto issue = [&](int it) {
        bf16* slot = ring + (it % kStages) * kSlot;
        const int tile = it / per_tile, c = it - tile * per_tile;
        const int k0 = (t0 + tile) * kBK;
        auto stage = [&](bf16* d, const bf16* src, size_t st, int n_rows,
                         int valid, int w, int wp) {
            if (vec) tc::stage_vec<kThreads>(d, kLD, src, st, n_rows, valid,
                                             w, wp, tid);
            else tc::stage_rows(d, kLD, src, st, n_rows, valid, w, wp, false,
                                tid, kThreads);
        };
        if (c < nc) {
            const int d0 = c * kDC, w = min(kDC, a.D - d0);
            const int wp = (w + 15) & ~15;
            stage(slot, qb + d0, a.D, kRows, rows, w, wp);
            stage(slot + kRows * kLD, kb + (size_t)k0 * kstride + d0, kstride,
                  kBK, a.S - k0, w, wp);
        } else {
            stage(slot, vb + (size_t)k0 * vstride, vstride, kBK, a.S - k0, vw,
                  vwp);
        }
    };
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) {
        if (i < n_items) issue(i);
        tc::cp_async_commit();
    }
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

    const int kr = warp * 16;                // this warp's keys in a tile
    const float scale2 = a.scale * kLog2e;   // scores in log2 units
    float oacc[2 * kVS / 16][4];
#pragma unroll
    for (int i = 0; i < 2 * kVS / 16; ++i)
        oacc[i][0] = oacc[i][1] = oacc[i][2] = oacc[i][3] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // rows g, g + 8

    for (int tile = 0; tile < n_tiles; ++tile) {
        const int k0 = (t0 + tile) * kBK + kr;

        // S = Q . K^T over the chunks of D: 16 heads x this warp's 16 keys
        float sc[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
        for (int c = 0; c < nc; ++c) {
            const bf16* qs = advance();
            const bf16* ks = qs + kRows * kLD;
            const int kst = (min(kDC, a.D - c * kDC) + 15) / 16;
#pragma unroll
            for (int kk = 0; kk < kDC / 16; ++kk) {
                if (kk >= kst) break;
                unsigned af[4], bb[4];
                tc::load_a(af, qs, kLD, 0, kk * 16, lane);
                tc::load_b_nk(bb, ks, kLD, kr, kk * 16, lane);
                tc::mma(sc[0], af, bb[0], bb[1]);
                tc::mma(sc[1], af, bb[2], bb[3]);
            }
            refill();
        }

        // scale, softcap and the mask: one key per column, for every head
        bool ok[2][2];
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int key = k0 + n * 8 + 2 * t + e;
                ok[n][e] = key >= ka && key < ke;
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                float x;
                if (a.softcap > 0.f)
                    x = a.softcap * tanhf(sc[n][e] * a.scale / a.softcap) * kLog2e;
                else
                    x = sc[n][e] * scale2;
                sc[n][e] = ok[n][e & 1] ? x : kNegInf;
            }
        }

        // the warp's online softmax; the four lanes of a quad share rows
        float mx0 = m0, mx1 = m1;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
            mx0 = fmaxf(mx0, fmaxf(sc[n][0], sc[n][1]));
            mx1 = fmaxf(mx1, fmaxf(sc[n][2], sc[n][3]));
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
        for (int n = 0; n < 2; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float m_ = e < 2 ? m0 : m1;
                sc[n][e] = ok[n][e & 1] ? tc::ex2(sc[n][e] - m_) : 0.f;
            }
            rs0 += sc[n][0] + sc[n][1];
            rs1 += sc[n][2] + sc[n][3];
        }
        l0 = l0 * c0 + rs0;                  // per-lane partial sums
        l1 = l1 * c1 + rs1;
#pragma unroll
        for (int n = 0; n < 2 * kVS / 16; ++n) {
            oacc[n][0] *= c0; oacc[n][1] *= c0;
            oacc[n][2] *= c1; oacc[n][3] *= c1;
        }

        // O += P . V over the slice, P (16 heads x 16 keys) as bf16
        const bf16* vs = advance();
        unsigned af[4];
        af[0] = tc::pack_bf16(sc[0][0], sc[0][1]);
        af[1] = tc::pack_bf16(sc[0][2], sc[0][3]);
        af[2] = tc::pack_bf16(sc[1][0], sc[1][1]);
        af[3] = tc::pack_bf16(sc[1][2], sc[1][3]);
#pragma unroll
        for (int np = 0; np < kVS / 16; ++np) {
            if (np >= nvp) break;
            unsigned bb[4];
            tc::load_b_kn(bb, vs, kLD, kr, np * 16, lane);
            tc::mma(oacc[2 * np], af, bb[0], bb[1]);
            tc::mma(oacc[2 * np + 1], af, bb[2], bb[3]);
        }
        refill();
    }
    tc::cp_async_wait<0>();
    __syncthreads();                         // the ring is free

#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
        l0 += __shfl_xor_sync(tc::kFull, l0, o_);
        l1 += __shfl_xor_sync(tc::kFull, l1, o_);
    }
    // the warps' states into shared memory: (warp, head row, kLdr)
    float* red = reinterpret_cast<float*>(smem_raw);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        float* rw = red + (warp * kRows + g + 8 * half) * kLdr;
#pragma unroll
        for (int n = 0; n < 2 * kVS / 16; ++n) {
            const int d = n * 8 + 2 * t;
            if (d < vw) {
                rw[d] = oacc[n][2 * half];
                rw[d + 1] = oacc[n][2 * half + 1];
            }
        }
        if (t == 0) {
            rw[kVS] = half ? m1 : m0;
            rw[kVS + 1] = half ? l1 : l0;
        }
    }
    __syncthreads();

    // merge the warps in order: column d < vw of acc, then m and l
    const int ldr = a.Dv + 2;                // a split's row of scratch
    for (int x = tid; x < rows * (vw + 2); x += kThreads) {
        const int r = x / (vw + 2), d = x - r * (vw + 2);
        if (d >= vw && slice > 0) continue;  // slice 0 writes m and l
        float M = kNegInf;
#pragma unroll
        for (int w = 0; w < kWarps; ++w)
            M = fmaxf(M, red[(w * kRows + r) * kLdr + kVS]);
        float A = 0.f, L = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
            const float* rw = red + (w * kRows + r) * kLdr;
            const float c = tc::ex2(rw[kVS] - M);
            if (d < vw) A = fmaf(rw[d], c, A);
            L = fmaf(rw[kVS + 1], c, L);
        }
        // m in natural units; -1e30 stays where no key is visible
        const float Mn = M == kNegInf ? kNegInf : M * kLn2;
        const size_t bh = (size_t)b * a.Hq + h0 + r;
        if (a.nsplit > 1) {
            float* pr = a.part + (bh * a.nsplit + s) * ldr;
            if (d < vw) pr[v0 + d] = A;
            else pr[a.Dv + d - vw] = d == vw ? Mn : L;
        } else if constexpr (kPartials) {
            if (d < vw) a.pt.acc[bh * a.Dv + v0 + d] = A;
            else if (d == vw) a.pt.m[bh] = Mn;
            else a.pt.l[bh] = L;
        } else if (d < vw) {
            a.o[bh * a.Dv + v0 + d] = __float2bfloat16_rn(A / fmaxf(L, 1e-30f));
        }
    }
}

template <bool kPartials>
int launch_t(const Args& a, int B, cudaStream_t stream)
{
    static int allowed[64];
    const cudaError_t e = tc::allow_smem((const void*)decode_tc_kernel<kPartials>,
                                         kSmem, allowed);
    if (e != cudaSuccess) return (int)e;
    const long long blocks = (long long)B * a.Hkv * a.tiles * a.nsplit * a.n_vs;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    decode_tc_kernel<kPartials><<<(unsigned)blocks, kThreads, kSmem, stream>>>(a);
    cudaError_t r = cudaGetLastError();
    if (r != cudaSuccess || a.nsplit == 1) return (int)r;
    merge_kernel<bf16, kPartials><<<B * a.Hq, kMergeThreads,
                                    3 * sizeof(float) * a.nsplit, stream>>>(
        a.part, a.kv_len, a.o, a.S, a.Hq, a.Dv, a.window, a.split, a.nsplit,
        a.pt);
    return (int)cudaGetLastError();
}

}  // namespace wide_tc
}  // namespace

// q (B, Hq, D), k (B, S, Hkv, D) contiguous bfloat16; v (B, S, Hkv, Dv)
// bfloat16 with head stride ldv (Dv, or D where v is k's first Dv
// columns); kv_len (B,) int32. The ordinary mode writes o (B, Hq, Dv); the
// partials mode (acc set: acc (B, Hq, Dv), m and l (B, Hq) float32; glen
// (B,) int32 or null, offset) writes (acc, m, l). split: keys a split, a
// positive multiple of 64; with more than one split, part is float32
// scratch of B Hq ceil(S / split) (Dv + 2) values. window <= 0: none;
// softcap <= 0: none.
extern "C" int decode_wide_tc_launch(
    const void* q, const void* k, const void* v, const int* kv_len, void* o,
    const int* glen, int offset, float* acc, float* m, float* l, float* part,
    int B, int S, int Hq, int Hkv, int D, int Dv, int ldv, int window,
    float softcap, float scale, int split, void* stream)
{
    using wide_tc::kBK;
    using wide_tc::kRows;
    using wide_tc::kVS;
    if (B == 0 || Hq == 0) return 0;
    const int nsplit = S > 0 && split > 0 ? (S + split - 1) / split : 0;
    if (D < 1 || Dv < 1 || Hkv < 1 || Hq % Hkv != 0 || ldv < Dv || S < 1
        || split < kBK || split % kBK != 0 || nsplit > kMaxSplits
        || (nsplit > 1 && part == nullptr)
        || (acc != nullptr && (m == nullptr || l == nullptr))
        || (acc == nullptr && o == nullptr)
        || (window > 0 && acc != nullptr && glen == nullptr))
        return (int)cudaErrorInvalidValue;
    const int rep = Hq / Hkv;
    const int fewest = (Dv + kVS - 1) / kVS;     // slices of Dv
    const int vw = ((Dv + fewest - 1) / fewest + 15) / 16 * 16;
    const int n_vs = (Dv + vw - 1) / vw;
    const bool vec = D % 8 == 0 && Dv % 8 == 0 && ldv % 8 == 0
        && ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 == 0;
    using tc::bf16;
    const wide_tc::Args a{
           (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, kv_len,
           Partials{glen, offset, acc, m, l}, part, S, Hq, Hkv, D, Dv, ldv,
           window, (rep + kRows - 1) / kRows, nsplit, split, n_vs, vw,
           softcap, scale, (int)vec};
    cudaStream_t s = (cudaStream_t)stream;
    return acc != nullptr ? wide_tc::launch_t<true>(a, B, s)
                          : wide_tc::launch_t<false>(a, B, s);
}

// Dynamic shared memory of one block (bytes), the same at every width.
extern "C" long long decode_wide_tc_smem_bytes()
{
    return (long long)wide_tc::kSmem;
}

extern "C" const char* decode_wide_tc_error_string(int e)
{
    return cudaGetErrorString((cudaError_t)e);
}
