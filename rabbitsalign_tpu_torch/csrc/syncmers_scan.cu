// Canonical closed syncmers of a read batch by the reference's automaton,
// for Hopper (sm_90a).
//
// Replaces rabbitsalign_tpu/ops/seed_device.py:syncmers_device (:58), an
// XLA op in the JAX package (a lax.scan over the bases, no pallas_call).
// Its plain PyTorch version is rabbitsalign_tpu_torch/ops/seed_device.py
// `syncmers_scan_plain`, whose outputs this kernel equals exactly.
//
// Per read (codes (B, L) u8 in {0..3, 4 = N}, lengths (B,) i32), base by
// base, the reference's SyncmerIterator (reference
// src/randstrobes.cpp:57-118): both strands' 2-bit k-mer and s-mer values
// rolled, reset by an N; each s-mer's xxh64 pushed into a ring of the
// last w = k - s + 1; the window's minimum tracked as its min-queue
// tracks it: on the first full window the leftmost minimum; a new hash
// strictly below it takes over; when the tracked minimum slides out, a
// rescan from the right, so the rightmost of equal minima. A window whose
// minimum sits at offset t - 1 emits its k-mer's position and xxh64.
// That history is the point of this kernel: the vectorised seeder
// (seed_randstrobes.cu) decides each window in closed form and must flag
// a read with a duplicated minimum as a tie row; this scan is exact on
// those rows. Outputs: positions (B, M) i32, -1 past the count; hashes
// (B, M) u64, 0 past the count; counts (B,) i32 (syncmers past the M-th
// are dropped).
//
// Design: a thread a read, the ring in local memory (w <= 32 u64), the
// k-mer's hash taken only for an emitted window. Bound: operations, about
// 80 int32-equivalent operations an s-mer (the rolled values, the s-mer's
// xxh64, the window's minimum), as the seeding kernel's pass 1. A thread
// a read is a serial chain of L steps with a load each, and 10 000 reads
// fill about 2.4 warps an SM: the kernel is latency-bound far above that
// bound. A warp a read, each lane replaying the automaton from the last
// reset before its run of windows, is the faster design (later work).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 128;
constexpr int kMaxW = 32;
constexpr u64 kUmax = ~0ULL;

constexpr u64 P1 = 0x9E3779B185EBCA87ULL;
constexpr u64 P2 = 0xC2B2AE3D27D4EB4FULL;
constexpr u64 P3 = 0x165667B19E3779F9ULL;
constexpr u64 P4 = 0x85EBCA77C2B2AE63ULL;
constexpr u64 P5 = 0x27D4EB2F165667C5ULL;

__device__ __forceinline__ u64 rotl64(u64 x, int r) { return (x << r) | (x >> (64 - r)); }

// xxh64 of one u64 (reference src/hash.hpp:110-123)
__device__ __forceinline__ u64 xxh64(u64 x) {
    u64 r = P5 + 8;
    x = rotl64(x * P2, 31);
    r = rotl64(r ^ (x * P1), 27);
    r = r * P1 + P4;
    r ^= r >> 33;
    r *= P2;
    r ^= r >> 29;
    r *= P3;
    r ^= r >> 32;
    return r;
}

__global__ void __launch_bounds__(kThreads) syncmers_scan_kernel(
    const uint8_t* __restrict__ codes, const int32_t* __restrict__ lengths, int B, int L, int k,
    int s, int t, int M, int32_t* __restrict__ out_pos, u64* __restrict__ out_hash,
    int32_t* __restrict__ counts) {
    const int b = blockIdx.x * kThreads + threadIdx.x;
    if (b >= B) return;
    const int w = k - s + 1;
    const u64 kmask = k == 32 ? kUmax : (1ULL << (2 * k)) - 1;
    const u64 smask = s == 32 ? kUmax : (1ULL << (2 * s)) - 1;
    const int kshift = 2 * (k - 1), sshift = 2 * (s - 1);
    const uint8_t* row = codes + (size_t)b * L;
    int32_t* pos_row = out_pos + (size_t)b * M;
    u64* hash_row = out_hash + (size_t)b * M;
    const int len = lengths[b];
    const int end = len < L ? len : L;  // emission needs i < length

    u64 ring[kMaxW];  // ring[(head + j) % w] is the window's j-th s-mer
    int head = 0;
    u64 xk0 = 0, xk1 = 0, xs0 = 0, xs1 = 0;
    int run = 0;  // bases since the last N
    u64 minval = kUmax;
    int minpos = -1;
    int n = 0;
    for (int i = 0; i < end; ++i) {
        const unsigned c = row[i];
        if (c >= 4) {
            xk0 = xk1 = xs0 = xs1 = 0;
            run = 0;
            minval = kUmax;
            minpos = -1;
            continue;
        }
        xk0 = ((xk0 << 2) | c) & kmask;
        xk1 = (xk1 >> 2) | ((u64)(3 - c) << kshift);
        xs0 = ((xs0 << 2) | c) & smask;
        xs1 = (xs1 >> 2) | ((u64)(3 - c) << sshift);
        if (++run < s) continue;
        const u64 hs = xxh64(xs0 < xs1 ? xs0 : xs1);
        ring[head] = hs;
        head = head + 1 == w ? 0 : head + 1;
        const int n_smers = run - (s - 1);
        if (n_smers < w) continue;
        if (n_smers == w) {  // the first full window: the leftmost minimum
            minval = kUmax;
            for (int j = 0; j < w; ++j) {
                const u64 v = ring[(head + j) % w];
                if (v < minval) {
                    minval = v;
                    minpos = i - k + 1 + j;
                }
            }
        } else if (minpos == i - k) {  // the minimum slid out: the rightmost
            minval = kUmax;
            for (int j = w - 1; j >= 0; --j) {
                const u64 v = ring[(head + j) % w];
                if (v < minval) {
                    minval = v;
                    minpos = i - k + 1 + j;
                }
            }
        } else if (hs < minval) {
            minval = hs;
            minpos = i - s + 1;
        }
        if (minpos == i - k + t && n < M) {
            pos_row[n] = i - k + 1;
            hash_row[n] = xxh64(xk0 < xk1 ? xk0 : xk1);
            ++n;
        }
    }
    for (int j = n; j < M; ++j) {
        pos_row[j] = -1;
        hash_row[j] = 0;
    }
    counts[b] = n;
}

}  // namespace

// codes (B, L) u8, lengths (B,) i32 in; positions (B, M) i32, hashes
// (B, M) u64, counts (B,) i32 out. Returns the cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for parameters it does not take.
extern "C" int syncmers_scan_launch(const void* codes, const void* lengths, int B, int L, int k,
                                    int s, int t, int M, void* out_pos, void* out_hash,
                                    void* counts, void* stream) {
    if (!(1 <= s && s <= k && k <= 32 && k - s + 1 <= kMaxW && 1 <= t && t <= k - s + 1) ||
        M < 1 || L < 0 || B < 0)
        return (int)cudaErrorInvalidValue;
    if (B == 0) return (int)cudaGetLastError();
    syncmers_scan_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)codes, (const int32_t*)lengths, B, L, k, s, t, M, (int32_t*)out_pos,
        (u64*)out_hash, (int32_t*)counts);
    return (int)cudaGetLastError();
}
