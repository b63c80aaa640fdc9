// Index lookup of a batch of randstrobe hashes for Hopper (sm_90a).
//
// Replaces rabbitsalign_tpu/ops/seed_device.py:index_find_device (:239),
// an XLA op in the JAX package (a global searchsorted, then the bucket
// bounds; no pallas_call); its plain PyTorch version is
// rabbitsalign_tpu_torch/ops/seed_device.py of the same name, whose
// output this kernel equals exactly.
//
// One thread a query: the bucket bounds lo = starts[top], hi =
// starts[top + 1] from the query's top `bits` bits, a lower-bound binary
// search with unsigned 64-bit compares inside [lo, hi), then equality.
// That equals the global lower bound checked against the bucket, since a
// bucket starts where the hash changes: the run of the globally smallest
// hash, which starts at 0 and not at a change, is unreachable (the
// quirk of index/strobemer_index.py `_build_buckets`), and an index whose
// hashes are all equal has every bucket at n and finds nothing.
//
// Bound: latency. Each step of the search is a dependent load from a
// hash array larger than the 50 MB L2 at 40 Mbp (64 MB, plus a 17 MB
// bucket table); the card hides it only by running many queries at once.
#include <cstdint>
#include <cuda_runtime.h>

#include "bucket_search.cuh"

namespace {

typedef unsigned long long u64;

__global__ void index_find_kernel(const u64* __restrict__ hashes, long long n,
                                  const u64* __restrict__ buckets, int bits,
                                  const u64* __restrict__ queries, long long nq,
                                  long long* __restrict__ out) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= nq) return;
    const u64 q = queries[i];
    const u64 top = q >> (64 - bits);
    long long lo = (long long)buckets[top];
    long long hi = (long long)buckets[top + 1];
    hi = hi < n ? hi : n;
    const long long first = lower_bound_u64(hashes, lo, hi, q);
    out[i] = (first < hi && hashes[first] == q) ? first : -1;
}

}  // namespace

// hashes (n,) and buckets (2^bits + 1,) u64, queries (nq,) u64 in; out
// (nq,) i64. Returns the cudaGetLastError() after the launch.
extern "C" int index_find_launch(const void* hashes, long long n, const void* buckets, int bits,
                                 const void* queries, long long nq, void* out, void* stream) {
    if (nq > 0) {
        const int threads = 256;
        index_find_kernel<<<(unsigned)((nq + threads - 1) / threads), threads, 0,
                            (cudaStream_t)stream>>>(
            (const u64*)hashes, n, (const u64*)buckets, bits, (const u64*)queries, nq,
            (long long*)out);
    }
    return (int)cudaGetLastError();
}
