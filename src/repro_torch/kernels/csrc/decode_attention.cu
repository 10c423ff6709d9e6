// Split-KV flash-decoding: one query token per sequence against its KV
// cache, CUDA for sm_90a.
//
// Replaces: the Pallas TPU kernel repro/kernels/decode_attention.py
//   decode_attention (_kernel). For q (B, Hq, D), caches k (B, S, Hkv, D)
//   and v (B, S, Hkv, Dv) in float32 or bfloat16, and kv_len (B,)
//   int32, it computes
//     o[b, h] = softmax_j(mask(softcap(q_bh . k_bj / sqrt(D)))) v_bj
//   in float32, o in q's type. Key j is visible when lo <= j < hi, with
//   hi = min(kv_len[b], S) and lo = max(0, kv_len[b] - window) (0 without
//   a window). The rep = Hq / Hkv query heads of a KV group share one pass
//   over the cache. A sequence with no visible key gets o = 0. D goes up to
//   576 and Dv up to 512: MLA's absorbed decode (repro/models/attention.py
//   mla_decode) attends 16 query heads of 576 (kv_lora_rank 512 + rope 64)
//   to one latent KV head whose value is the first 512 columns of the same
//   cache row.
//
// V inside K (v_in_k): v is k's first Dv columns, in k's storage and with
//   k's row stride. The kernel then stages each 32-key K tile once and reads
//   V from that tile in shared memory, so the latent cache is read once per
//   head group. Staged apart, a bf16 V tile of 32 x 512 would add 32 KB a
//   stage and warp and leave room for one stage only.
//
// What bounds it here: memory and latency. Each visible cache row is read
//   once (at zamba2's last step, 4 x 544 x 32 heads x 80 x 2 (k, v) x 2
//   bytes = 22 MB, 0.0067 ms at 3.35 TB/s; MLA's latent cache at B 4 and
//   kv_len 4,096: 4 x 4,096 x 576 x 2 bytes = 18.9 MB, 0.0056 ms) for 4
//   multiply-adds per element per query head, far below any compute roof.
//   With B = 4 there are only 128 (sequence, KV head) pairs for 132 SMs, so
//   the cache axis itself has to be cut for the loads to be in flight at
//   once. The latent mode is the exception: 16 query heads share each
//   element, 570 million operations at kv_len 4,096, 0.0085 ms at the CUDA
//   cores' 67 TFLOP/s, above its bytes' 0.0056 ms; its lever is the tensor
//   cores (mma over the head group), later work.
//
// Design (FlashDecoding): the cache axis is cut into splits of `split`
//   keys (a multiple of 64, chosen by the wrapper from S and the grid, never
//   from kv_len, which lives on the card). One block of two warps per
//   (split, batch, KV head, group of HB <= 8 query heads, HB <= 4 when Dv
//   is above 256, so that a lane's HB x DVT accumulators stay at 64 floats
//   and nothing spills); a split wholly
//   outside [lo, hi) exits at once. Each warp takes every other 32-key tile
//   of its split's visible range and stages it into its own shared-memory
//   ring (one or two stages) with 16-byte cp.async, K and V as separate
//   groups, so that scoring starts when K has landed while V is still on
//   its way, and the next tile's loads overlap this tile's arithmetic. Rows
//   whose width is off the 16-byte grid (D 20 in bf16) are staged with
//   plain loads. A lane scores one key for all HB heads, reading its row as
//   16-byte units; rows are an odd number of units apart, so the lanes of
//   a quarter-warp hit distinct banks. The warp keeps the online-softmax
//   state (m, l) and each lane the output dims lane + 32 t of every head.
//   The two warps merge through shared memory with the log-sum-exp rule
//     M = max m_w,  L = sum l_w e^(m_w - M),  A = sum acc_w e^(m_w - M)
//   and the block writes its split's (m, l, acc) in float32 to scratch.
//   A second launch merges the visible splits of each (batch, head) with
//   the same rule, in split order, o = A / max(L, 1e-30); splits outside
//   [lo, hi) are skipped, as if they held m = -1e30, l = 0. With one split
//   the block writes o itself. No float atomics: two calls on the same
//   input give identical bits.
//
// Partials: decode_attention_partials.cu instantiates the same kernels
//   in their partials mode (kPartials), this file in their ordinary one;
//   both include decode_attention.cuh, and nvcc builds them side by side.

#include "decode_attention.cuh"

// dtype: 0 float32, 1 bfloat16. window <= 0: none; softcap <= 0: none.
// D at most 576, Dv at most 512. v_in_k: v is k's first Dv columns (same
// storage and row stride; v is then not read, and Dv <= D); else v is
// contiguous (B, S, Hkv, Dv). split: keys per split, a positive multiple
// of 64, at most 4096 splits;
// part: float32 scratch of B * Hq * ceil(S / split) * (Dv + 2) values
// (unused, and may be null, when one split covers S).
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const int* kv_len,
                                       void* o, float* part, int B, int S,
                                       int Hq, int Hkv, int D, int Dv,
                                       int window, float softcap, float scale,
                                       int split, int v_in_k, int dtype,
                                       void* stream)
{
    if (B == 0) return 0;
    if (split < S && part == nullptr) return (int)cudaErrorInvalidValue;
    const Partials none{nullptr, 0, nullptr, nullptr, nullptr};
    return dispatch<false>(dtype, q, k, v, kv_len, o, part, B, S, Hq, Hkv,
                           D, Dv, window, softcap, scale, split, v_in_k != 0,
                           none, (cudaStream_t)stream, nullptr);
}

// The split kernel's registers, shared memory per block (static +
// dynamic, bytes) and stages at one shape: attr[0..2]. Launches nothing.
extern "C" int decode_attention_info(int S, int Hq, int Hkv, int D, int Dv,
                                     int split, int v_in_k, int dtype,
                                     int* attr)
{
    const Partials none{nullptr, 0, nullptr, nullptr, nullptr};
    return dispatch<false>(dtype, nullptr, nullptr, nullptr, nullptr,
                           nullptr, nullptr, 1, S, Hq, Hkv, D, Dv, 0, 0.f,
                           1.f, split, v_in_k != 0, none, nullptr, attr);
}

extern "C" const char* decode_attention_error_string(int e)
{
    return cudaGetErrorString((cudaError_t)e);
}
