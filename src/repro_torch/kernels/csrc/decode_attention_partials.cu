// Split-KV flash-decoding over one slice of a sequence-sharded cache,
// CUDA for sm_90a: K6's partials mode. The kernels are
// decode_attention.cuh's, instantiated with kPartials, and
// decode_attention.cu describes them.
//
// Partials (decode_attention_partials_launch): the same two launches over
//   one rank's slice of a sequence-sharded cache (repro/kernels/ref.py
//   decode_attention_partials, repro/serving/decode.py). kv_len is then the
//   slice's local length, key j stands at global position j + offset, and
//   a window is measured from the global length glen[b]: lo = max(0,
//   glen[b] - window - offset). In place of o the launch writes the
//   slice's unnormalised softmax state in float32, acc = A (B, Hq, Dv) and
//   m = M, l = L (B, Hq), for the ranks to merge with the same rule; a
//   slice with no visible key gives m = -1e30, l = 0, acc = 0.

#include "decode_attention.cuh"

// The partials mode: as decode_attention_launch over one slice of a
// sequence-sharded cache, with local_len in place of kv_len, the slice's
// first key at global position `offset` and the window measured from
// glen (null: no window); acc (B, Hq, Dv), m and l (B, Hq) float32 in
// place of o.
extern "C" int decode_attention_partials_launch(
    const void* q, const void* k, const void* v, const int* local_len,
    const int* glen, int offset, float* acc, float* m, float* l,
    float* part, int B, int S, int Hq, int Hkv, int D, int Dv, int window,
    float softcap, float scale, int split, int v_in_k, int dtype,
    void* stream)
{
    if (B == 0) return 0;
    if ((split < S && part == nullptr) || !acc || !m || !l)
        return (int)cudaErrorInvalidValue;
    const Partials pt{glen, offset, acc, m, l};
    return dispatch<true>(dtype, q, k, v, local_len, nullptr, part, B, S,
                          Hq, Hkv, D, Dv, glen ? window : 0, softcap, scale,
                          split, v_in_k != 0, pt, (cudaStream_t)stream,
                          nullptr);
}

extern "C" const char* decode_attention_partials_error_string(int e)
{
    return cudaGetErrorString((cudaError_t)e);
}
