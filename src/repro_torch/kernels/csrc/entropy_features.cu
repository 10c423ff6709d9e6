// Batched weighted-entropy features for COMPREDICT, CUDA for sm_90a.
//
// Replaces: the Pallas TPU kernel repro/kernels/entropy_features.py
//   weighted_entropy_features (_wef_kernel). Per partition i it builds the
//   (n_buckets, V) histogram of the value codes at positions < n_valid[i],
//   where the value at flat position p sits in row p / n_cols[i] and bucket b
//   holds rows [b*nr/nb, (b+1)*nr/nb) in integer arithmetic, and reduces it to
//     summary[i] = [-sum len*p*log p, -sum p*log p, distinct/total, sum len*p]
//     bucket_h[i, b] = -sum len * pb * log pb
//   with p = hist/total, total = max(n_valid, 1), pb = hist_b/max(sum hist_b, 1),
//   natural log and p > 0 guards. The TPU version scattered counts through a
//   one-hot matrix product into a VMEM histogram.
//
// What bounds it here: memory. Each code inside n_valid is read once, and
//   the length of each value that occurs; the counting is one shared-memory
//   atomic per code. At the main path's shapes one partition's vocabulary
//   reaches ~5.8e5 values (2.3 MB of counts), ten times the 227 KB of
//   shared memory one block holds, so one block cannot keep a partition's
//   histogram on chip; a thread block cluster can.
//
// Design: the vocabulary is cut into slices of `span` values, one cluster
//   of kCluster = 8 blocks per (partition, slice); grid (8 x slices,
//   partitions), one launch per 65,535 partitions (the grid's second
//   dimension), each with its first partition's offset, so any number of
//   partitions. The cluster's blocks share the partition's positions, 16
//   bytes of codes a thread a step, the next step's load issued before this
//   step's counting; codes outside the slice are skipped. Block rank r owns
//   the values of the slice at offsets r, r + 8, r + 16, ... (no division
//   to find an owner), for which it reduces the entropy terms. Two ways to
//   count, chosen by size:
//   - replicated (n_buckets * V <= kMaxBins: one slice, the whole
//     vocabulary): every block keeps the slice's (nb, span) bins in its own
//     shared memory and counts its positions there with shared-memory
//     atomics; after cluster.sync() each block sums the 8 copies of the
//     values it owns through distributed shared memory (map_shared_rank).
//   - distributed (larger): the slice's (nb, span) bins are spread over the
//     cluster, each block holding the (nb, span / 8) bins of the values it
//     owns (up to 192 KB, so a slice holds 8 x 49,152 bins), and a code is
//     added into its owner's shared memory through distributed shared
//     memory (atomicAdd on the mapped address). The lanes of a warp that
//     add to one bin are found with __match_any_sync and one of them adds
//     their count, which takes the pressure off hot values there (in
//     replicated mode the same aggregation made the main path's class 2
//     slower).
//     These adds cross SMs, slower than local ones, and one partition may
//     hold most of a class's codes (3.0 of 7.2 million in the main path's
//     class 0), so the wrapper's plan also cuts the vocabulary into more
//     slices than the bins need, until a block adds at most 65,536 of the
//     largest partition's codes: more clusters share it, each re-reading
//     its codes. Blocks that own their values and each read all the codes,
//     counting with local atomics only, were slower on the main path.
//   Buckets: a value at row r falls in bucket b when b n_rows / nb <= r
//   (integer division). wef_cluster_kernel has one body and two bucket
//   policies. Up to 16 buckets it finds a bucket in a table of the edges,
//   with its per-bucket arrays (totals, edges) of 16 in static shared
//   memory. Above (WIDE), it finds it by one 64-bit division (the same
//   integer) and sizes its per-bucket arrays by n_buckets in dynamic
//   shared memory beside the bins, so the plan takes any n_buckets: its
//   bins per block, the buckets of a pass x the values a block holds, stay
//   within 49,152. Above 4,096 buckets (kPassBuckets) it counts them in
//   passes of 4,096, re-reading the codes each pass and keeping each owned
//   value's count over all passes for the summary.
//   Integer atomics make the counts exact and independent of their order.
//   The per-bucket totals are counted from the codes by every cluster (a
//   thread keeps a run count while its bucket does not change) and summed
//   over the cluster.
//   Each block then walks only the values it owns: each term in float32, as
//   the TPU kernel does, the sums in float64 (a float32 running sum over the
//   main path's vocabularies lost more than twice the accuracy of PyTorch's
//   float32 reduction), combined over the block by a fixed shuffle and
//   shared-memory tree into 4 + nb partial sums written to scratch. A second
//   launch adds each partition's partials in (slice, rank) order and writes
//   summary and bucket_h. No float atomics and no histogram in device
//   memory: two calls on the same input give identical bits.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "tc_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;            // blocks per cluster (portable size)
constexpr int kShift = 3;              // log2(kCluster)
constexpr int kThreads = 1024;
constexpr int kEdgeBuckets = 16;       // up to here buckets by an edge table
constexpr int kPassBuckets = 4096;     // the most buckets a pass counts
constexpr int kMaxBins = 49152;        // int32 bins a block holds (192 KB)
constexpr int kMaxLaunchRows = 65535;  // partitions a launch (gridDim.y)
constexpr int kCombineThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

int allowed[4][64];                    // shared memory set, per kind and device

// Sum over the block; the result is valid in thread 0. Fixed order for a
// fixed blockDim. `scratch` holds one entry per warp.
template <typename T>
__device__ T block_sum(T x, T* scratch)
{
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(kFull, x, o);
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    if (lane == 0) scratch[warp] = x;
    __syncthreads();
    if (warp == 0) {
        x = lane < (int)(blockDim.x >> 5) ? scratch[lane] : T(0);
        for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(kFull, x, o);
    }
    __syncthreads();
    return x;
}

__device__ __forceinline__ float plogp(float p)
{
    return p > 0.f ? p * logf(fmaxf(p, 1e-30f)) : 0.f;
}

// Bucket of row r among nb buckets of nr rows, bucket e starting at row
// e nr / nb (integer division): the number of e in [1, nb) with
// e nr / nb <= r, which is e nr < (r + 1) nb
__device__ __forceinline__ int bucket_of(int r, int nr, int nb)
{
    if (nr <= 0) return nb - 1;
    const long long k = ((long long)(r + 1) * nb - 1) / nr;
    return k < nb - 1 ? (int)k : nb - 1;
}

// codes c[0..3] at positions 4 qd .. 4 qd + 3 (-1 past n_valid or past the
// quads)
__device__ __forceinline__ int4 load_quad(const int* row, int qd, int nq,
                                          int nv, bool vec)
{
    int4 c = make_int4(-1, -1, -1, -1);
    if (qd >= nq) return c;
    const int p = 4 * qd;
    if (vec) {
        c = __ldg(reinterpret_cast<const int4*>(row + p));
        if (p + 1 >= nv) c.y = -1;
        if (p + 2 >= nv) c.z = -1;
        if (p + 3 >= nv) c.w = -1;
    } else {
        c.x = row[p];
        if (p + 1 < nv) c.y = row[p + 1];
        if (p + 2 < nv) c.z = row[p + 2];
        if (p + 3 < nv) c.w = row[p + 3];
    }
    return c;
}

// The summary's four sums over this block's values x0, x0 + 8, ... < x1,
// c = count(x) each value's count over all buckets, into out[0, 4)
template <typename Count>
__device__ __forceinline__ void summary_sums(Count count, int x0, int x1,
                                             const float* lens, float total,
                                             double* out, double* red_d,
                                             long long* red_ll)
{
    double a_wh = 0.0, a_h = 0.0, a_len = 0.0;
    long long distinct = 0;
    for (int x = x0 + kCluster * threadIdx.x; x < x1; x += kCluster * kThreads) {
        const int c = count(x);
        if (c > 0) {
            const float p = (float)c / total;
            const float pl = plogp(p);
            const float len = lens[x];
            a_wh += len * pl;
            a_h += pl;
            a_len += len * p;
            ++distinct;
        }
    }
    a_wh = block_sum(a_wh, red_d);
    a_h = block_sum(a_h, red_d);
    a_len = block_sum(a_len, red_d);
    distinct = block_sum(distinct, red_ll);
    if (threadIdx.x == 0) {
        out[0] = a_wh;
        out[1] = a_h;
        out[2] = a_len;
        out[3] = (double)distinct;
    }
}

// REPL: the replicated histogram (see the file's note); else distributed.
// WIDE (above kEdgeBuckets buckets): a bucket by bucket_of, the per-bucket
// arrays in dynamic shared memory after the bins, the buckets counted nbw
// at a time (one pass when nbw = n_buckets); with more than one pass each
// owned value's count over all buckets is summed pass by pass in ctot, for
// the summary. Else a bucket by the edge table, its arrays static, one
// pass. Partition i0 + blockIdx.y (a launch takes at most 65,535).
template <bool REPL, bool WIDE>
__global__ void __launch_bounds__(kThreads)
wef_cluster_kernel(const int* __restrict__ codes,      // (N, M)
                   const int* __restrict__ n_valid,    // (N,)
                   const int* __restrict__ n_rows,     // (N,)
                   const int* __restrict__ n_cols,     // (N,)
                   const float* __restrict__ lengths,  // (N, V) or (V,)
                   long long len_stride,               // V, or 0 for shared
                   int m, int v, int n_buckets, int nbw, int i0, int span,
                   bool vec,
                   double* __restrict__ partials)      // (N, slices, 8, 4 + nb)
{
    // REPL: (nbw, span) bins; else (nbw, width); WIDE: then tot (nbw),
    // tot_f (nbw) and, with more than one pass, ctot (one a value owned)
    extern __shared__ int hist[];
    __shared__ double red_d[32];
    __shared__ long long red_ll[32];

    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int slice = blockIdx.x / kCluster;
    const int slices = gridDim.x / kCluster;
    const int i = i0 + blockIdx.y;
    const int lane = threadIdx.x & 31;
    const int nb = n_buckets;
    const int per = WIDE ? nbw : nb;           // buckets a pass
    const int width = span / kCluster;         // distributed: values a block owns
    const int local_v = REPL ? span : width;
    const int nr = n_rows[i];
    const int nc = max(n_cols[i], 1);
    const int nv = max(min(n_valid[i], m), 0);
    const bool multi = WIDE && per < nb;
    int* tot;
    float* tot_f;
    int* ctot = nullptr;
    const int* edge = nullptr;
    if constexpr (WIDE) {
        tot = hist + per * local_v;
        tot_f = reinterpret_cast<float*>(tot + per);
        ctot = reinterpret_cast<int*>(tot_f + per);
        // block rank r owns the values v0 + r + kCluster j of the slice:
        // at most ceil(span / kCluster) of them
        const int owned = (span + kCluster - 1) >> kShift;
        if (multi)
            for (int j = threadIdx.x; j < owned; j += kThreads) ctot[j] = 0;
    } else {
        __shared__ int tot_s[kEdgeBuckets];
        __shared__ int edge_s[kEdgeBuckets];
        __shared__ float tot_f_s[kEdgeBuckets];
        tot = tot_s;
        tot_f = tot_f_s;
        edge = edge_s;
        if (threadIdx.x < nb) edge_s[threadIdx.x] = (threadIdx.x * nr) / nb;
    }

    const int v0 = slice * span;               // the slice's first value
    const int* row = codes + (size_t)i * m;
    // values v0 + rank + kCluster j are this block's
    const int x0 = v0 + rank;
    const int x1 = min(v0 + span, v);
    const float* lens = lengths + (size_t)i * len_stride;
    const float total = fmaxf((float)n_valid[i], 1.f);
    double* out = partials + (((size_t)i * slices + slice) * kCluster + rank)
                             * (4 + nb);
    const int* copy[REPL ? kCluster : 1];
    if constexpr (REPL) {
        for (int r = 0; r < kCluster; ++r) copy[r] = cluster.map_shared_rank(hist, r);
    } else {
        copy[0] = hist;
    }
    // count of value x in bucket b of this pass
    auto at = [&](int b, int x) {
        if constexpr (REPL) {
            int c = 0;
            for (int r = 0; r < kCluster; ++r) c += copy[r][b * span + x - v0];
            return c;
        } else {
            return copy[0][b * width + ((x - v0) >> kShift)];
        }
    };

    // one pass: the buckets [p0, p0 + pw)
    auto pass = [&](int p0, int pw) {
        for (int x = threadIdx.x; x < pw * local_v; x += kThreads) hist[x] = 0;
        for (int t = threadIdx.x; t < pw; t += kThreads) tot[t] = 0;
        cluster.sync();              // every copy zeroed before any add

        // ---- count
        int cur_b = 0, run = 0;
        auto count = [&](int pos, int c) {
            const bool ok = c >= 0 && c < v;
            int b = 0;
            if constexpr (WIDE) {
                if (ok) b = bucket_of(pos / nc, nr, nb) - p0;
            } else if (nb > 1 && ok) {
                const int r = pos / nc;
                for (int e = 1; e < nb; ++e) b += r >= edge[e];
            }
            const bool in = WIDE ? ok && b >= 0 && b < pw : ok;  // this pass's
            if (in) {
                if (b != cur_b) {
                    if (run) atomicAdd(&tot[cur_b], run);
                    cur_b = b;
                    run = 0;
                }
                ++run;
            }
            int key = -1;            // (owner, bin), unique per bin
            const int lc = c - v0;
            if (in && lc >= 0 && lc < span) {
                if constexpr (REPL)
                    key = b * span + lc;
                else
                    key = (lc & (kCluster - 1)) * kMaxBins + b * width
                          + (lc >> kShift);
            }
            // distributed: the lanes adding to one bin, one of which adds
            // for all (hot values); replicated: each lane adds its own
            unsigned peers = 1u << lane;
            if constexpr (!REPL) peers = __match_any_sync(kFull, key);
            if (key >= 0 && lane == __ffs(peers) - 1) {
                const int n = __popc(peers);
                if constexpr (REPL) {
                    atomicAdd(hist + key, n);
                } else {
                    const int owner = key / kMaxBins;
                    atomicAdd(cluster.map_shared_rank(hist, owner)
                              + (key - owner * kMaxBins), n);
                }
            }
        };
        const int nq = (nv + 3) >> 2;
        const int step = kCluster * kThreads;
        int qd = rank * kThreads + threadIdx.x;
        int4 cur = load_quad(row, qd, nq, nv, vec);
        // warp-uniform trip count: every lane takes part in __match_any_sync
        for (int qw = qd - lane; qw < nq; qw += step, qd += step) {
            const int4 next = load_quad(row, qd + step, nq, nv, vec);
            const int p = 4 * qd;
            count(p, cur.x);
            count(p + 1, cur.y);
            count(p + 2, cur.z);
            count(p + 3, cur.w);
            cur = next;
        }
        if (run) atomicAdd(&tot[cur_b], run);
        cluster.sync();              // every add landed, in every block

        for (int t = threadIdx.x; t < pw; t += kThreads) {
            long long s = 0;
            for (int r = 0; r < kCluster; ++r)
                s += *cluster.map_shared_rank(tot + t, r);
            tot_f[t] = fmaxf((float)s, 1.f);
        }
        __syncthreads();

        // ---- reduce the values this block owns
        if (!multi) {
            summary_sums([&](int x) {
                int c = 0;
                for (int b = 0; b < pw; ++b) c += at(b, x);
                return c;
            }, x0, x1, lens, total, out, red_d, red_ll);
        } else {
            for (int x = x0 + kCluster * threadIdx.x; x < x1; x += kCluster * kThreads) {
                int c = 0;
                for (int b = 0; b < pw; ++b) c += at(b, x);
                ctot[(x - v0) >> kShift] += c;
            }
        }
        for (int b = 0; b < pw; ++b) {
            const float tb = tot_f[b];
            double acc = 0.0;
            for (int x = x0 + kCluster * threadIdx.x; x < x1; x += kCluster * kThreads) {
                const int c = at(b, x);
                if (c > 0) acc += lens[x] * plogp((float)c / tb);
            }
            acc = block_sum(acc, red_d);
            if (threadIdx.x == 0) out[4 + p0 + b] = acc;
        }
        cluster.sync();              // no block changes or leaves its bins while others read them
    };

    if constexpr (WIDE) {
        for (int p0 = 0; p0 < nb; p0 += per) pass(p0, min(per, nb - p0));
        if (multi)
            summary_sums([&](int x) { return ctot[(x - v0) >> kShift]; }, x0,
                         x1, lens, total, out, red_d, red_ll);
    } else {
        pass(0, nb);
    }
}

// Each partition's partials added in (slice, rank) order.
__global__ void __launch_bounds__(kCombineThreads)
wef_combine_kernel(const double* __restrict__ partials,
                   const int* __restrict__ n_valid, int n, int n_parts,
                   int n_buckets, float* __restrict__ summary,
                   float* __restrict__ bucket_h)
{
    const int i = blockIdx.x * kCombineThreads + threadIdx.x;
    if (i >= n) return;
    const int w = 4 + n_buckets;
    const double* p = partials + (size_t)i * n_parts * w;
    double s[4];
    for (int t = 0; t < 4; ++t) {
        s[t] = 0.0;
        for (int k = 0; k < n_parts; ++k) s[t] += p[(size_t)k * w + t];
    }
    const float total = fmaxf((float)n_valid[i], 1.f);
    summary[(size_t)i * 4 + 0] = (float)-s[0];
    summary[(size_t)i * 4 + 1] = (float)-s[1];
    summary[(size_t)i * 4 + 2] = (float)(long long)s[3] / total;
    summary[(size_t)i * 4 + 3] = (float)s[2];
    for (int b = 0; b < n_buckets; ++b) {
        double acc = 0.0;
        for (int k = 0; k < n_parts; ++k) acc += p[(size_t)k * w + 4 + b];
        bucket_h[(size_t)i * n_buckets + b] = (float)-acc;
    }
}

cudaLaunchConfig_t cluster_config(int rows, int slices, size_t smem,
                                  cudaStream_t stream,
                                  cudaLaunchAttribute* attr)
{
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kCluster * slices, rows, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
}

// The plan's checks: the slices cover V, a pass takes 1 to kPassBuckets
// buckets (all of them when there are no more, and always up to
// kEdgeBuckets), and a block holds its bins (replicated: the slice's
// (nbw, span); distributed: (nbw, span / 8)).
int check_plan(int v, int n_buckets, int nbw, int slices, int span, int repl)
{
    if (n_buckets < 1 || nbw < 1 || nbw > n_buckets || nbw > kPassBuckets
        || (n_buckets <= kEdgeBuckets && nbw != n_buckets)
        || v < 1 || slices < 1 || span < 1 || (long long)slices * span < v
        || (!repl && span % kCluster)
        || (long long)nbw * (repl ? span : span / kCluster) > kMaxBins)
        return (int)cudaErrorInvalidValue;
    return 0;
}

// Dynamic shared memory of a block: the bins; above kEdgeBuckets buckets
// also tot and tot_f (nbw each) and, with more than one pass, ctot (one
// for each value the block owns: ceil(span / kCluster))
size_t smem_bytes(int n_buckets, int nbw, int span, int repl)
{
    size_t ints = (size_t)nbw * (repl ? span : span / kCluster);
    if (n_buckets > kEdgeBuckets)
        ints += 2 * (size_t)nbw
                + (nbw < n_buckets ? (span + kCluster - 1) / kCluster : 0);
    return sizeof(int) * ints;
}

// The kernel of this kind (replicated or not, above kEdgeBuckets buckets
// or not), its shared memory allowed (once per size and device)
const void* prepare(int repl, int n_buckets, size_t smem, cudaError_t* e)
{
    const bool wide = n_buckets > kEdgeBuckets;
    const void* fn = repl
        ? (wide ? (const void*)wef_cluster_kernel<true, true>
                : (const void*)wef_cluster_kernel<true, false>)
        : (wide ? (const void*)wef_cluster_kernel<false, true>
                : (const void*)wef_cluster_kernel<false, false>);
    *e = tc::allow_smem(fn, smem, allowed[(repl ? 1 : 0) + (wide ? 2 : 0)]);
    return fn;
}

}  // namespace

// The plan (repl, slices, span, nbw: buckets a pass) comes from the
// wrapper (entropy_features.py, _plan); partials: float64 scratch of
// n * slices * 8 * (4 + n_buckets) values. One cluster launch per 65,535
// partitions, then the combine.
extern "C" int wef_launch(const int* codes, const int* n_valid,
                          const int* n_rows, const int* n_cols,
                          const float* lengths, long long len_stride,
                          int n, int m, int v, int n_buckets, int nbw,
                          int repl, int slices, int span, double* partials,
                          float* summary, float* bucket_h, void* stream)
{
    if (n == 0) return 0;
    int rc = check_plan(v, n_buckets, nbw, slices, span, repl);
    if (rc) return rc;
    const cudaStream_t s = (cudaStream_t)stream;
    const size_t smem = smem_bytes(n_buckets, nbw, span, repl);
    const bool vec = m % 4 == 0
        && (reinterpret_cast<size_t>(codes) & 15) == 0;
    cudaError_t e;
    const void* fn = prepare(repl, n_buckets, smem, &e);
    if (e != cudaSuccess) return (int)e;
    // partitions [i0, i0 + rows), at most 65,535 a launch
    for (int i0 = 0; i0 < n; i0 += kMaxLaunchRows) {
        int rows = n - i0 < kMaxLaunchRows ? n - i0 : kMaxLaunchRows;
        cudaLaunchAttribute attr[1];
        const cudaLaunchConfig_t cfg = cluster_config(rows, slices, smem, s,
                                                      attr);
        void* args[] = {&codes, &n_valid, &n_rows, &n_cols, &lengths,
                        &len_stride, &m, &v, &n_buckets, &nbw, &i0, &span,
                        (void*)&vec, &partials};
        e = cudaLaunchKernelExC(&cfg, fn, args);
        if (e != cudaSuccess) return (int)e;
    }
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    wef_combine_kernel<<<(n + kCombineThreads - 1) / kCombineThreads,
                         kCombineThreads, 0, s>>>(
        partials, n_valid, n, slices * kCluster, n_buckets, summary, bucket_h);
    return (int)cudaGetLastError();
}

// For the report, at one plan: attr = {registers, shared memory per block
// (static + dynamic bytes), cluster size, clusters that fit on the card at
// once (cudaOccupancyMaxActiveClusters)}. Launches nothing.
extern "C" int wef_info(int v, int n_buckets, int nbw, int repl, int slices,
                        int span, int* attr)
{
    int rc = check_plan(v, n_buckets, nbw, slices, span, repl);
    if (rc) return rc;
    const size_t smem = smem_bytes(n_buckets, nbw, span, repl);
    cudaError_t e;
    const void* fn = prepare(repl, n_buckets, smem, &e);
    if (e != cudaSuccess) return (int)e;
    cudaFuncAttributes fa;
    e = cudaFuncGetAttributes(&fa, fn);
    if (e != cudaSuccess) return (int)e;
    cudaLaunchAttribute la[1];
    const cudaLaunchConfig_t cfg = cluster_config(1, slices, smem, 0, la);
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
    if (e != cudaSuccess) return (int)e;
    attr[0] = fa.numRegs;
    attr[1] = (int)(fa.sharedSizeBytes + smem);
    attr[2] = kCluster;
    attr[3] = clusters;
    return 0;
}

extern "C" const char* wef_error_string(int e)
{
    return cudaGetErrorString((cudaError_t)e);
}
