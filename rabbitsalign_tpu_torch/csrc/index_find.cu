// Index lookup of a batch of randstrobe hashes for Hopper (sm_90a).
//
// Replaces rabbitsalign_tpu/ops/seed_device.py:index_find_device (:239),
// an XLA op in the JAX package (a global searchsorted, then the bucket
// bounds; no pallas_call); its plain PyTorch version is
// rabbitsalign_tpu_torch/ops/seed_device.py of the same name, whose
// output this kernel equals exactly: the first index in [lo, min(hi, n))
// whose hash is not below q, if that hash equals q, else -1, with lo =
// starts[top] and hi = starts[top + 1] for the query's top `bits` bits.
// That equals the global lower bound checked against the bucket, since a
// bucket starts where the hash changes: the run of the globally smallest
// hash, which starts at 0 and not at a change, is unreachable (the quirk
// of index/strobemer_index.py `_build_buckets`), and an index whose hashes
// are all equal has every bucket at n and finds nothing.
//
// What bounds it on the card: random 32-byte sectors from arrays larger
// than the 50 MB L2 (at 40 Mbp 64 MB of hashes and a 17 MB bucket table),
// and the launch. On the chunk's 423 614 strobes (chip_smoke.py phase
// Seed, an H100 at 700 W; PERF.md §6) the queries touch 2.60 distinct
// sectors each (the bucket pair, and the binary search's probes, which
// after the first mostly fall in a sector already read and hit L1): a
// floor of ~0.0125 ms beside a byte bound of ~0.0076 ms, and an empty
// kernel of this size takes ~0.002 ms. A thread a query ran at ~0.0288 ms
// after an L2 flush.
//
// Design: two queries a thread, over a grid of at most one wave (the SMs
// times the blocks an SM holds, queried once a device), strided over the
// batch. A thread issues both queries' loads, then both bucket pairs', so
// the first two round trips of its two chains overlap; then each query's
// bucket-bounded binary search (bucket_search.cuh `lower_bound_u64`) and
// equality read. Measured beside it on the card (PERF.md §6, PR 10): one
// and four queries a thread, and a window of 4 or 8 hashes read at once
// before the search (the bucket's hashes counted below q without
// branches). The window shortens the chain to two round trips but reads
// every sector of the bucket (3.02 a query at 8, against the search's
// 2.60), and with two queries a thread costs registers: every window
// variant was slower than the search with two queries a thread (~0.027 ms
// after a flush), and so was the search with one or with four queries a
// thread.
#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

#include "bucket_search.cuh"

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;

// two queries a thread: their query and bucket reads issued together,
// then each query's search and equality read, one after the other
__global__ void __launch_bounds__(kThreads) index_find_kernel(
    const u64* __restrict__ hashes, long long n, const u64* __restrict__ buckets, int bits,
    const u64* __restrict__ queries, long long nq, long long* __restrict__ out) {
    const long long stride = (long long)gridDim.x * kThreads;
    for (long long i0 = (long long)blockIdx.x * kThreads + threadIdx.x; i0 < nq;
         i0 += 2 * stride) {
        u64 q[2];
        long long lo[2], hi[2];
#pragma unroll
        for (int k = 0; k < 2; ++k) q[k] = i0 + k * stride < nq ? queries[i0 + k * stride] : 0;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
            const bool live = i0 + k * stride < nq;
            const u64 top = q[k] >> (64 - bits);
            lo[k] = live ? (long long)buckets[top] : 0;
            hi[k] = live ? min((long long)buckets[top + 1], n) : 0;
        }
#pragma unroll
        for (int k = 0; k < 2; ++k) {
            const long long i = i0 + k * stride;
            if (i >= nq) continue;
            const long long first = lower_bound_u64(hashes, lo[k], hi[k], q[k]);
            out[i] = first < hi[k] && hashes[first] == q[k] ? first : -1;
        }
    }
}

// The blocks of one wave on the current device: its SMs times the blocks
// of index_find_kernel an SM holds, queried on the device's first launch
// and kept (0: not yet known). Returns the CUDA error of a failed query.
cudaError_t wave_blocks(long long* wave) {
    static std::atomic<long long> waves[kMaxDevices];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    std::atomic<long long>* known = dev < kMaxDevices ? &waves[dev] : nullptr;
    if (known && (*wave = known->load(std::memory_order_relaxed)) > 0) return cudaSuccess;
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, index_find_kernel, kThreads,
                                                            0);
    if (err != cudaSuccess) return err;
    *wave = (long long)sms * per_sm;
    if (known) known->store(*wave, std::memory_order_relaxed);
    return cudaSuccess;
}

}  // namespace

// hashes (n,) and buckets (2^bits + 1,) u64, queries (nq,) u64 in; out
// (nq,) i64. Returns the cudaGetLastError() after the launch.
extern "C" int index_find_launch(const void* hashes, long long n, const void* buckets, int bits,
                                 const void* queries, long long nq, void* out, void* stream) {
    if (nq <= 0) return (int)cudaGetLastError();
    long long wave = 0;
    const cudaError_t err = wave_blocks(&wave);
    if (err != cudaSuccess) {
        cudaGetLastError();
        return (int)err;
    }
    const long long want = (nq + 2LL * kThreads - 1) / (2LL * kThreads);
    index_find_kernel<<<(unsigned)min(want, wave), kThreads, 0, (cudaStream_t)stream>>>(
        (const u64*)hashes, n, (const u64*)buckets, bits, (const u64*)queries, nq,
        (long long*)out);
    return (int)cudaGetLastError();
}
