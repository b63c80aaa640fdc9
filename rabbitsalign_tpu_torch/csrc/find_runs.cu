// Run lookup against one shard of the hash-sharded index (--shard-index)
// for Hopper (sm_90a).
//
// Replaces the per-shard `local` of rabbitsalign_tpu/parallel/sharding.py
// (ShardedIndex._build_routed :253 and _build :287), an XLA program under
// shard_map in the JAX package (a searchsorted on both sides, the
// reachable check and a (nq, cap) run gather; no pallas_call). Its plain
// PyTorch versions are rabbitsalign_tpu_torch/ops/shard_find.py
// `find_runs_plain` and `gather_runs_plain`, whose outputs these kernels
// equal exactly.
//
// find_runs_kernel, one thread a key: the key's bucket bounds from the
// global bucket table (starts[top] to starts[top + 1] for its top `bits`
// bits), clipped to the shard's entries, a lower-bound binary search with
// unsigned 64-bit compares inside them (bucket_search.cuh, as index_find),
// equality, and only for a found key the end of its run: a galloping
// search from the first entry (1, 2, 4, ... past it, then a binary search
// in the last step), which takes one or two probes in the same cache line
// for the short runs that most keys have. A bucket starts where the hash
// changes, and a shard at a run's start, so the bounded search finds what
// the JAX package's global search with its reachable flags finds: the run
// of the globally smallest hash (the bucket quirk of
// index/strobemer_index.py `_build_buckets`) and the shards' 0xFF..F
// padding lie outside every search range. The run's end is sought over
// the padded width, so a key equal to the padding value, on the shard
// that holds its run, counts the padding too, as in the JAX package.
//
// gather_runs_kernel, one warp a key: the lanes copy consecutive run rows
// of positions and packed (int32 each), so each warp's reads and writes
// are coalesced; keys with no rows to copy return at once.
//
// Bound: bytes, and in practice latency. Each search step is a dependent
// load from a shard that is larger than the 50 MB L2 at 40 Mbp (64 MB of
// hashes for one shard, and the 17 MB bucket table); the card hides it
// only by running many keys at once.
#include <cstdint>
#include <cuda_runtime.h>

#include "bucket_search.cuh"

namespace {

typedef unsigned long long u64;

__global__ void find_runs_kernel(const u64* __restrict__ hashes, long long m, long long size,
                                 long long start, const u64* __restrict__ buckets, int bits,
                                 const u64* __restrict__ queries, long long nq,
                                 long long* __restrict__ gpos, long long* __restrict__ count) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= nq) return;
    const u64 q = queries[i];
    const u64 top = q >> (64 - bits);
    long long lo = (long long)buckets[top] - start;
    long long hi = (long long)buckets[top + 1] - start;
    lo = lo > 0 ? lo : 0;
    hi = hi < size ? hi : size;
    long long c = 0, g = 0;
    const long long first = lower_bound_u64(hashes, lo, hi, q);
    if (first < hi && hashes[first] == q) {
        // the run's end: every index below `a` holds q, none from `b` on
        long long a = first + 1, b = m;
        for (long long step = 1; first + step < m; step <<= 1) {
            if (hashes[first + step] != q) {
                b = first + step;
                break;
            }
            a = first + step + 1;
        }
        while (a < b) {
            const long long mid = a + ((b - a) >> 1);
            if (hashes[mid] == q) {
                a = mid + 1;
            } else {
                b = mid;
            }
        }
        c = a - first;
        g = first + start;
    }
    gpos[i] = g;
    count[i] = c;
}

__global__ void gather_runs_kernel(const int* __restrict__ positions,
                                   const int* __restrict__ packed,
                                   const long long* __restrict__ gpos,
                                   const long long* __restrict__ count, long long start,
                                   const long long* __restrict__ dst, long long nq, long long cap,
                                   int* __restrict__ out_pos, int* __restrict__ out_packed) {
    const long long key = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (key >= nq) return;
    const long long c = count[key];
    const long long d = dst != nullptr ? dst[key] : key * cap;
    if (c <= 0 || d < 0) return;
    const long long n = c < cap ? c : cap;
    const long long src = gpos[key] - start;
    for (long long r = lane; r < n; r += 32) {
        out_pos[d + r] = positions[src + r];
        out_packed[d + r] = packed[src + r];
    }
}

}  // namespace

// hashes (m,) u64 of one shard, its `size` entries then the 0xFF..F
// padding, whose first entry has global index `start`; buckets (2^bits +
// 1,) u64, the index's global bucket table; queries (nq,) u64 in; gpos and
// count (nq,) i64 out (0 and 0 for a key not found). Returns the
// cudaGetLastError() after the launch.
extern "C" int find_runs_launch(const void* hashes, long long m, long long size, long long start,
                                const void* buckets, int bits, const void* queries, long long nq,
                                void* gpos, void* count, void* stream) {
    if (nq > 0) {
        const int threads = 256;
        find_runs_kernel<<<(unsigned)((nq + threads - 1) / threads), threads, 0,
                           (cudaStream_t)stream>>>(
            (const u64*)hashes, m, size, start, (const u64*)buckets, bits, (const u64*)queries,
            nq, (long long*)gpos, (long long*)count);
    }
    return (int)cudaGetLastError();
}

// positions and packed (m,) i32 of one shard; gpos and count (nq,) i64
// from find_runs_launch; dst (nq,) i64, the first output row of each key
// (< 0: skip the key), or null for row key * cap. Copies the first
// min(count, cap) rows of each found key into out_pos and out_packed.
// Returns the cudaGetLastError() after the launch.
extern "C" int gather_runs_launch(const void* positions, const void* packed, const void* gpos,
                                  const void* count, long long start, const void* dst,
                                  long long nq, long long cap, void* out_pos, void* out_packed,
                                  void* stream) {
    if (nq > 0) {
        const int threads = 256;  // 8 keys a block
        const long long keys_per_block = threads / 32;
        gather_runs_kernel<<<(unsigned)((nq + keys_per_block - 1) / keys_per_block), threads, 0,
                             (cudaStream_t)stream>>>(
            (const int*)positions, (const int*)packed, (const long long*)gpos,
            (const long long*)count, start, (const long long*)dst, nq, cap, (int*)out_pos,
            (int*)out_packed);
    }
    return (int)cudaGetLastError();
}
