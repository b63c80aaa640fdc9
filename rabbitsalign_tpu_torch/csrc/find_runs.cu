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
// bucket table (starts[top - top0] to starts[top - top0 + 1] for its top
// `bits` bits, the index clipped to the table: a pod host keeps only its
// slice's rows, top0 the first), clipped to the shard's entries, a
// lower-bound binary search with unsigned 64-bit compares inside them
// (bucket_search.cuh, as index_find), equality, and only for a found key
// the end of its run: a galloping search from the first entry (1, 2, 4,
// ... past it, then a binary search in the last step), which takes one or
// two probes in the same cache line for the short runs that most keys
// have. A bucket starts where the hash changes, and a shard at a run's
// start, so the bounded search finds what the JAX package's global search
// with its reachable flags finds: the run of the globally smallest hash
// (the bucket quirk of index/strobemer_index.py `_build_buckets`) and the
// shards' 0xFF..F padding lie outside every search range. A key outside
// a trimmed table's range searches the nearest end bucket, which holds no
// entry of its hash. The run's end is sought over the padded width, so a
// key equal to the padding value, on the shard that holds its run, counts
// the padding too, as in the JAX package.
//
// gather_runs_kernel, one thread a key: a found key's first min(count,
// cap) run rows of positions and packed (int32 each) are copied to
// dst[key] onwards. Most runs are one row, so the thread copies a run of
// up to kWarpRun rows itself; the lanes whose run is longer are taken
// from a ballot one after the other by the whole warp, 32 consecutive
// rows a step, so those reads and writes stay coalesced. Keys that copy
// nothing cost the coalesced reads of count and dst.
//
// Bound: bytes, and in practice the latency of dependent loads. The
// function's bytes are the keys in and (gpos, count) out, 8 bytes a
// probed hash and 16 a copied row; but every random read on this card
// moves a whole 32-byte sector: the bucket pair, each search step (2.32
// a key at 40 Mbp with bits 21), the equality read and each gallop probe,
// 1.91 M sectors for the 428 k keys of a chunk, a floor of 0.021 ms on an
// H100 (chip_smoke.py, phase Shard). The search is a chain of dependent
// loads into 64 MB of hashes and the 17 MB bucket table, more than the
// 50 MB L2; the card hides their latency only by running many keys at
// once. At 0.030 ms after an L2 flush it sits within 1.5x of that floor
// and is kept as it was. The gather was the larger part, 0.061 ms after a
// flush: a warp a key (nq / 8 blocks of 256 threads), where the found
// keys (a third at 40 Mbp) mostly copied one row with one lane and every
// other warp read a count and returned. A thread a key cuts the grid to
// nq / 256 blocks, reads count and dst coalesced, and issues the found
// keys' row copies from all lanes at once: 0.015 ms after a flush
// (compare_phase_a.py, both on one H100).
#include <cstdint>
#include <cuda_runtime.h>

#include "bucket_search.cuh"

namespace {

typedef unsigned long long u64;

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr long long kWarpRun = 8;  // longer runs are copied by the whole warp

__global__ void find_runs_kernel(const u64* __restrict__ hashes, long long m, long long size,
                                 long long start, const u64* __restrict__ buckets,
                                 long long n_buckets, int bits, long long top0,
                                 const u64* __restrict__ queries, long long nq,
                                 long long* __restrict__ gpos, long long* __restrict__ count) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= nq) return;
    const u64 q = queries[i];
    long long top = (long long)(q >> (64 - bits)) - top0;
    top = top < 0 ? 0 : (top > n_buckets - 2 ? n_buckets - 2 : top);
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
    const long long key = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const int lane = threadIdx.x & 31;
    // every lane stays to the ballot; keys past nq copy nothing
    long long n = 0, d = 0, src = 0;
    if (key < nq) {
        const long long c = count[key];
        d = dst != nullptr ? dst[key] : key * cap;
        if (c > 0 && d >= 0) {
            n = c < cap ? c : cap;
            src = gpos[key] - start;
        }
    }
    const bool by_warp = n > kWarpRun;
    if (!by_warp) {
        for (long long r = 0; r < n; ++r) {
            out_pos[d + r] = positions[src + r];
            out_packed[d + r] = packed[src + r];
        }
    }
    for (unsigned ball = __ballot_sync(kFull, by_warp); ball; ball &= ball - 1) {
        const int leader = __ffs(ball) - 1;
        const long long wn = __shfl_sync(kFull, n, leader);
        const long long wd = __shfl_sync(kFull, d, leader);
        const long long ws = __shfl_sync(kFull, src, leader);
        for (long long r = lane; r < wn; r += 32) {
            out_pos[wd + r] = positions[ws + r];
            out_packed[wd + r] = packed[ws + r];
        }
    }
}

}  // namespace

// hashes (m,) u64 of one shard, its `size` entries then the 0xFF..F
// padding, whose first entry has global index `start`; buckets
// (n_buckets,) u64, rows top0 .. top0 + n_buckets - 1 of the index's
// global bucket table (n_buckets >= 2); queries (nq,) u64 in; gpos and
// count (nq,) i64 out (0 and 0 for a key not found). Returns the
// cudaGetLastError() after the launch.
extern "C" int find_runs_launch(const void* hashes, long long m, long long size, long long start,
                                const void* buckets, long long n_buckets, int bits,
                                long long top0, const void* queries, long long nq, void* gpos,
                                void* count, void* stream) {
    if (nq > 0) {
        const int threads = 256;
        find_runs_kernel<<<(unsigned)((nq + threads - 1) / threads), threads, 0,
                           (cudaStream_t)stream>>>(
            (const u64*)hashes, m, size, start, (const u64*)buckets, n_buckets, bits, top0,
            (const u64*)queries, nq, (long long*)gpos, (long long*)count);
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
        const int threads = 256;
        gather_runs_kernel<<<(unsigned)((nq + threads - 1) / threads), threads, 0,
                             (cudaStream_t)stream>>>(
            (const int*)positions, (const int*)packed, (const long long*)gpos,
            (const long long*)count, start, (const long long*)dst, nq, cap, (int*)out_pos,
            (int*)out_packed);
    }
    return (int)cudaGetLastError();
}
