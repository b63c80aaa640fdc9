// The run walk of the composed NAM front end, with the repetitive filter,
// the min-length-diff keep rule and the compaction of the kept hits, for
// Hopper (sm_90a).
//
// Replaces the run walk, keep rule and compaction of
// rabbitsalign_tpu/ops/front_device.py:seed_find_walk (:80-145), XLA ops
// in the JAX package (no pallas_call), which are the reference's
// add_to_hits_per_ref (reference src/nam.cpp:68-85) over a batch. Its
// plain PyTorch version is rabbitsalign_tpu_torch/ops/front_device.py
// `walk_hits_plain`, whose outputs this kernel equals exactly.
//
// Input: the compacted strobes of a read batch in the seeding buffer's
// layout (ops/seed_device.py `strobe_views`: counts (N,) i32, -1 for a
// tie row; offsets (N,) i64; hashes u64, starts and ends i32, is_rev u8,
// and positions i64 from the index lookup, -1 for a miss) and the index
// (hashes (n,) u64, positions and packed (n,) u32). Per read, strobe by
// strobe in order: a found strobe counts in `total`; it is filtered when
// the hash at pos + cutoff (< n) is its own; otherwise it counts in
// `good` and its run is walked, at most `cap` rows while the hash stays
// its own: ref_start = positions[p], ref_end = ref_start + (packed[p] &
// 0xFF) + k, ref_id = packed[p] >> 8, and a row is kept when |qspan -
// (ref_end - ref_start)| is at most every earlier row's of the run. Kept
// hits go to hits (N, maxh, 6) i32 as [is_rc, ref_id, qs, qe, rs, re],
// strobe-major and run-minor (the host's processing order), the first
// maxh of them; n_hits (N,) holds min(kept, maxh), overflow (N,) u8 kept
// > maxh. The caller zeroes `hits`.
//
// Design: one warp a read. The strobes come in rounds of 32, a lane each:
// its position, hash and the filter's probe load together, and a ballot
// gives the walked strobes of the round. Each walked strobe, in order, is
// broadcast and its run read 32 rows a round, a lane a row (coalesced
// 8-byte hashes, then the row's position and packed word); the keep rule
// is a warp inclusive min-scan of the diffs, shifted by one lane, with
// the run's minimum so far carried between rounds; kept rows take their
// slots at a popcount prefix of the ballot. Bound: bytes, 16 B a strobe
// (its position and hash), 16 B a walked row (hash, position, packed) and
// 24 B a kept hit; in practice the dependent round trips of a read's
// strobes (a found strobe's probe, then its run) on random rows of an
// index larger than the L2.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int kWarps = 4;
constexpr unsigned kFull = 0xFFFFFFFFu;

__global__ void __launch_bounds__(kWarps * 32) walk_hits_kernel(
    const int32_t* __restrict__ counts, const long long* __restrict__ offsets,
    const u64* __restrict__ hashes, const int32_t* __restrict__ starts,
    const int32_t* __restrict__ ends, const uint8_t* __restrict__ is_rev,
    const long long* __restrict__ positions, long long N, const u64* __restrict__ idx_hashes,
    const uint32_t* __restrict__ idx_pos, const uint32_t* __restrict__ idx_packed, long long n,
    int k, int cutoff, int maxh, int cap, int32_t* __restrict__ hits,
    int32_t* __restrict__ n_hits, int32_t* __restrict__ total, int32_t* __restrict__ good,
    uint8_t* __restrict__ overflow) {
    const int lane = threadIdx.x & 31;
    const long long b = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
    if (b >= N) return;  // a whole warp
    const int cnt = counts[b];
    const long long off = offsets[b];
    int32_t* out = hits + b * (long long)maxh * 6;
    int kept = 0, n_found = 0, n_good = 0;
    for (int i0 = 0; i0 < cnt; i0 += 32) {
        // this lane's strobe of the round: found, filtered
        const int i = i0 + lane;
        long long p = -1;
        u64 key = 0;
        bool walk = false;
        if (i < cnt) {
            p = positions[off + i];
            key = hashes[off + i];
            if (p >= 0) {
                const long long pc = p + cutoff;
                walk = !(pc < n && idx_hashes[pc] == key);
            }
        }
        n_found += __popc(__ballot_sync(kFull, p >= 0));
        unsigned todo = __ballot_sync(kFull, walk);
        n_good += __popc(todo);
        while (todo) {
            const int src = __ffs((int)todo) - 1;
            todo &= todo - 1;
            const long long sp = __shfl_sync(kFull, p, src);
            const u64 skey = __shfl_sync(kFull, key, src);
            const long long si = off + i0 + src;
            const int qs = starts[si], qe = ends[si], rc = is_rev[si];
            const int qspan = qe - qs;
            int carry = INT_MAX;  // the run's least diff so far
            for (int j0 = 0; j0 < cap; j0 += 32) {
                const int j = j0 + lane;
                const long long q = sp + j;
                const bool in_run = j < cap && q < n && idx_hashes[q] == skey;
                int rs = 0, re = 0, rid = 0, diff = INT_MAX;
                if (in_run) {
                    const uint32_t pk = idx_packed[q];
                    rs = (int)idx_pos[q];
                    re = rs + (int)(pk & 0xFF) + k;
                    rid = (int)(pk >> 8);
                    diff = abs(qspan - (re - rs));
                }
                int incl = diff;
#pragma unroll
                for (int o = 1; o < 32; o <<= 1) {
                    const int v = __shfl_up_sync(kFull, incl, o);
                    if (lane >= o) incl = min(incl, v);
                }
                const int prev = __shfl_up_sync(kFull, incl, 1);
                const int excl = lane == 0 ? carry : min(carry, prev);
                const bool keep = in_run && diff <= excl;
                const unsigned kb = __ballot_sync(kFull, keep);
                if (keep) {
                    const int r = kept + __popc(kb & ((1u << lane) - 1));
                    if (r < maxh) {
                        int32_t* o = out + (long long)r * 6;
                        o[0] = rc;
                        o[1] = rid;
                        o[2] = qs;
                        o[3] = qe;
                        o[4] = rs;
                        o[5] = re;
                    }
                }
                kept += __popc(kb);
                carry = min(carry, __shfl_sync(kFull, incl, 31));
                if (__ballot_sync(kFull, in_run) != kFull) break;  // the run ended
            }
        }
    }
    if (lane == 0) {
        n_hits[b] = kept < maxh ? kept : maxh;
        total[b] = n_found;
        good[b] = n_good;
        overflow[b] = kept > maxh;
    }
}

}  // namespace

// The strobe arrays (counts, offsets, hashes, starts, ends, is_rev,
// positions) of N reads and the index (idx_hashes, idx_pos, idx_packed
// of n rows) in; hits (N, maxh, 6) i32 (zeroed by the caller), n_hits,
// total, good (N,) i32 and overflow (N,) u8 out. Returns the
// cudaGetLastError() after the launch, or cudaErrorInvalidValue.
extern "C" int walk_hits_launch(const void* counts, const void* offsets, const void* hashes,
                                const void* starts, const void* ends, const void* is_rev,
                                const void* positions, long long N, const void* idx_hashes,
                                const void* idx_pos, const void* idx_packed, long long n, int k,
                                int cutoff, int maxh, int cap, void* hits, void* n_hits,
                                void* total, void* good, void* overflow, void* stream) {
    if (N < 0 || n < 0 || maxh < 1 || cap < 0 || cutoff < 0) return (int)cudaErrorInvalidValue;
    if (N == 0) return (int)cudaGetLastError();
    walk_hits_kernel<<<(unsigned)((N + kWarps - 1) / kWarps), kWarps * 32, 0,
                       (cudaStream_t)stream>>>(
        (const int32_t*)counts, (const long long*)offsets, (const u64*)hashes,
        (const int32_t*)starts, (const int32_t*)ends, (const uint8_t*)is_rev,
        (const long long*)positions, N, (const u64*)idx_hashes, (const uint32_t*)idx_pos,
        (const uint32_t*)idx_packed, n, k, cutoff, maxh, cap, (int32_t*)hits, (int32_t*)n_hits,
        (int32_t*)total, (int32_t*)good, (uint8_t*)overflow);
    return (int)cudaGetLastError();
}
