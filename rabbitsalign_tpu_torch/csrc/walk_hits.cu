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
// (ref_end - ref_start)| is at most every earlier row's of the run. A
// probe past the index reads 2^64 - 1, as the host's hash_at. Kept hits
// go to a read's room as [is_rc, ref_id, qs, qe, rs, re] i32, strobe-major
// and run-minor (the host's processing order), as many as the room holds,
// and zeros past them; n_hits (N,) holds min(kept, room), overflow (N,)
// u8 kept > room. With maxh > 0 the room is row b of hits (N, maxh, 6);
// with maxh = 0 (the compact layout) it is the read's own strobe count of
// rows at its strobe offset in hits (T, 6), T the strobe arrays' length.
//
// Bound: bytes, 16 B a strobe (its position and hash), 16 B a walked row
// (hash, position, packed) and the hits, 24 B a slot, kept or zero (46 MB
// at N = 10 000, maxh = 192: 14 us at 3.35 TB/s; 24 B a strobe in the
// compact layout, 10 MB for 10 000 150-base reads). What
// sets the time is latency: a strobe's run is a chain of dependent trips
// to device memory (its position, then the filter's probe and its rows)
// on random rows of an index larger than the L2, and on simulated reads
// almost every run is one row.
//
// Design: one warp a read, its strobes in rounds of 32, a lane a strobe.
// Each lane issues at once the loads of its strobe (position, hash,
// starts, ends, is_rev), then at once the filter's probe at p + cutoff,
// the first row of its run (hash, position, packed) and the next row's
// hash, so a one-row run costs two dependent trips. The lane walks up to
// kLaneRows = 4 rows of its run itself, in order, with its own running
// minimum for the keep rule, loading a row's position and packed word
// (and the next hash) once the row is known to be in the run, and keeps
// the rows in registers: on simulated reads every run is one row, so
// loading more rows at once would only add sectors and registers. A warp
// exclusive scan of the lanes' kept counts gives each lane its first
// slot; a run that goes on past kLaneRows rows (the row after them in the
// run, and cap > kLaneRows) is finished afterwards, in strobe order, by
// the whole warp, 32 rows a round, a lane a row (coalesced 8-byte hashes,
// then the row's position and packed word), the keep rule a warp
// inclusive min-scan of the diffs shifted by one lane and started from
// the lane's carry. Its kept rows take their slots at a popcount prefix
// of the ballot, after its own first rows' hits, and its count shifts the
// slots of every later strobe of the round before any of them is written.
// The read's slots past its hits are zeroed by consecutive lanes at the
// end, so no memset of the hits precedes the launch. Every warp primitive
// is reached by the whole warp.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int kWarps = 4;
constexpr int kLaneRows = 4;  // rows of a run that its lane walks alone
constexpr unsigned kFull = 0xFFFFFFFFu;

// a row's reference span: ref_start, and its length (packed & 0xFF) + k
__device__ __forceinline__ int row_end(int rs, uint32_t pk, int k) {
    return (int)((unsigned)rs + (pk & 0xFF) + (unsigned)k);
}

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
    const int room = maxh > 0 ? maxh : max(cnt, 0);
    int32_t* out = hits + (maxh > 0 ? b * (long long)maxh : off) * 6;
    const int rows = cap < kLaneRows ? cap : kLaneRows;  // the lane's rows of a run
    int kept = 0, n_found = 0, n_good = 0;               // uniform
    for (int i0 = 0; i0 < cnt; i0 += 32) {
        // this lane's strobe of the round
        const int i = i0 + lane;
        long long p = -1;
        u64 key = 0;
        int qs = 0, qe = 0, rc = 0;
        if (i < cnt) {
            const long long si = off + i;
            p = positions[si];
            key = hashes[si];
            qs = starts[si];
            qe = ends[si];
            rc = is_rev[si];
        }
        // the filter's probe, the run's first row and the next row's hash,
        // loaded together
        bool walk = false;
        u64 h0 = 0, hnext = 0;
        uint32_t rp[kLaneRows], rk[kLaneRows];
        if (p >= 0) {
            const long long pc = p + cutoff;
            const u64 probe = pc < n ? idx_hashes[pc] : ~0ull;
            if (p < n) {
                h0 = idx_hashes[p];
                rp[0] = idx_pos[p];
                rk[0] = idx_packed[p];
            }
            hnext = p + 1 < n ? idx_hashes[p + 1] : 0;
            walk = probe != key;
        }
        // the lane's walk: rows j < rows while the hash stays its own, a
        // row's position and packed word (and the next hash) loaded once
        // the row is known to be in the run
        const int qspan = qe - qs;
        int carry = INT_MAX;  // the run's least diff so far
        unsigned kmask = 0;   // the rows kept, a bit each
        int in_run = 0;       // rows of the run walked
        if (walk) {
#pragma unroll
            for (int j = 0; j < kLaneRows; ++j) {
                if (j >= rows || p + j >= n) break;
                if (j == 0) {
                    if (h0 != key) break;
                } else {
                    if (hnext != key) break;
                    rp[j] = idx_pos[p + j];
                    rk[j] = idx_packed[p + j];
                    hnext = p + j + 1 < n ? idx_hashes[p + j + 1] : 0;
                }
                in_run = j + 1;
                const int diff = abs(qspan - ((int)(rk[j] & 0xFF) + k));
                kmask |= (unsigned)(diff <= carry) << j;
                carry = min(carry, diff);
            }
        }
        const int kc = __popc(kmask);
        const bool more = walk && in_run == kLaneRows && kLaneRows < cap &&
                          p + kLaneRows < n && hnext == key;
        n_found += __popc(__ballot_sync(kFull, p >= 0));
        n_good += __popc(__ballot_sync(kFull, walk));
        // first slots: an exclusive scan of the kept counts
        int incl = kc;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int v = __shfl_up_sync(kFull, incl, o);
            if (lane >= o) incl += v;
        }
        const int round_kept = __shfl_sync(kFull, incl, 31);
        // the long runs in strobe order, by the whole warp from row kLaneRows
        int shift = 0;  // kept rows of earlier strobes' long runs
        int extra = 0;  // all long runs' kept rows so far (uniform)
        for (unsigned todo = __ballot_sync(kFull, more); todo; todo &= todo - 1) {
            const int src = __ffs((int)todo) - 1;
            const long long sp = __shfl_sync(kFull, p, src);
            const u64 skey = __shfl_sync(kFull, key, src);
            const int sspan = __shfl_sync(kFull, qspan, src);
            const int sqs = __shfl_sync(kFull, qs, src), sqe = __shfl_sync(kFull, qe, src);
            const int src_rc = __shfl_sync(kFull, rc, src);
            int scarry = __shfl_sync(kFull, carry, src);
            const int at = kept + __shfl_sync(kFull, incl, src) + extra;  // its next slot
            int got = 0;
            for (int j0 = kLaneRows; j0 < cap; j0 += 32) {
                const int j = j0 + lane;
                const long long q = sp + j;
                const bool row_in = j < cap && q < n && idx_hashes[q] == skey;
                int rs = 0, re = 0, rid = 0, diff = INT_MAX;
                if (row_in) {
                    const uint32_t pk = idx_packed[q];
                    rs = (int)idx_pos[q];
                    re = row_end(rs, pk, k);
                    rid = (int)(pk >> 8);
                    diff = abs(sspan - ((int)(pk & 0xFF) + k));
                }
                int mn = diff;
#pragma unroll
                for (int o = 1; o < 32; o <<= 1) {
                    const int v = __shfl_up_sync(kFull, mn, o);
                    if (lane >= o) mn = min(mn, v);
                }
                const int prev = __shfl_up_sync(kFull, mn, 1);
                const int excl = lane == 0 ? scarry : min(scarry, prev);
                const bool keep = row_in && diff <= excl;
                const unsigned kb = __ballot_sync(kFull, keep);
                if (keep) {
                    const int r = at + got + __popc(kb & ((1u << lane) - 1));
                    if (r < room) {
                        int32_t* o = out + (long long)r * 6;
                        o[0] = src_rc;
                        o[1] = rid;
                        o[2] = sqs;
                        o[3] = sqe;
                        o[4] = rs;
                        o[5] = re;
                    }
                }
                got += __popc(kb);
                scarry = min(scarry, __shfl_sync(kFull, mn, 31));
                if (__ballot_sync(kFull, row_in) != kFull) break;  // the run ended
            }
            extra += got;
            if (lane > src) shift += got;
        }
        // the lane's own kept rows, after every earlier strobe's
        int r = kept + incl - kc + shift;
#pragma unroll
        for (int j = 0; j < kLaneRows; ++j) {
            if (!(kmask >> j & 1)) continue;
            if (r < room) {
                const int rs = (int)rp[j];
                int32_t* o = out + (long long)r * 6;
                o[0] = rc;
                o[1] = (int)(rk[j] >> 8);
                o[2] = qs;
                o[3] = qe;
                o[4] = rs;
                o[5] = row_end(rs, rk[j], k);
            }
            ++r;
        }
        kept += round_kept + extra;
    }
    // the row's slots past its hits, zeroed by consecutive lanes
    for (long long j = (long long)min(kept, room) * 6 + lane; j < (long long)room * 6; j += 32)
        out[j] = 0;
    if (lane == 0) {
        n_hits[b] = kept < room ? kept : room;
        total[b] = n_found;
        good[b] = n_good;
        overflow[b] = kept > room;
    }
}

}  // namespace

// The strobe arrays (counts, offsets, hashes, starts, ends, is_rev,
// positions) of N reads and the index (idx_hashes, idx_pos, idx_packed
// of n rows) in; hits (N, maxh, 6) i32, or (T, 6) where maxh is 0 (every
// slot of a room written), n_hits, total, good (N,) i32 and overflow (N,)
// u8 out. Returns the cudaGetLastError() after the launch, or
// cudaErrorInvalidValue.
extern "C" int walk_hits_launch(const void* counts, const void* offsets, const void* hashes,
                                const void* starts, const void* ends, const void* is_rev,
                                const void* positions, long long N, const void* idx_hashes,
                                const void* idx_pos, const void* idx_packed, long long n, int k,
                                int cutoff, int maxh, int cap, void* hits, void* n_hits,
                                void* total, void* good, void* overflow, void* stream) {
    if (N < 0 || n < 0 || maxh < 0 || cap < 0 || cutoff < 0) return (int)cudaErrorInvalidValue;
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
