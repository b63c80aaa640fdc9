// The bucket-bounded lower-bound search of the index lookups for Hopper
// (sm_90a), shared by index_find.cu and find_runs.cu.
#pragma once

// The first index in [lo, hi) of the sorted uint64 `hashes` whose hash is
// not below q (hi if none): a binary search with unsigned 64-bit compares,
// one dependent load a step. The callers bound [lo, hi) by the bucket
// table, starts[top] to starts[top + 1] for the query's top bits, so it
// takes ~log2 of a bucket's width steps instead of log2 of the index's.
__device__ __forceinline__ long long lower_bound_u64(const unsigned long long* __restrict__ hashes,
                                                     long long lo, long long hi,
                                                     unsigned long long q) {
    while (lo < hi) {
        const long long mid = lo + ((hi - lo) >> 1);
        if (hashes[mid] < q) {
            lo = mid + 1;
        } else {
            hi = mid;
        }
    }
    return lo;
}
