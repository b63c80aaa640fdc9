// Randstrobe seeding of a read batch, both strands, for Hopper (sm_90a).
//
// Replaces rabbitsalign_tpu/ops/seed_device.py:randstrobes_query_vec
// (:432), an XLA op in the JAX package (no pallas_call); its plain
// PyTorch version is rabbitsalign_tpu_torch/ops/seed_device.py of the
// same name, whose outputs this kernel equals byte for byte, unused slots
// included (hash 0, start -1, end -1).
//
// Per read (codes (B, L) u8 in {0..3, 4 = N}, lengths (B,) i32):
//   * every s-mer start i: the xxh64 of its canonical 2-bit value, or
//     UMAX when an N lies in it;
//   * every k-mer window p (s-mers p .. p + w - 1, w = k - s + 1): the
//     minimum hash, its leftmost offset and how often it occurs. The
//     window is a closed syncmer when it is N-free, inside the read, its
//     minimum is not UMAX and sits at offset t - 1; a duplicated minimum
//     in such a window sets `tie` (the host's min-queue breaks that tie
//     by its history, which no closed form can), as do more than M
//     syncmers;
//   * the syncmers' positions and k-mer hashes, compacted in order;
//   * forward strobes from the list, reverse strobes from the list
//     reversed with positions mirrored (len - pos - k): strobe 2 of
//     syncmer m is the syncmer m + d, d in [w_min, w_max], m + d < n,
//     within max_dist, of least popcount((h_m ^ h_{m+d}) & q), the
//     leftmost on ties; none in range links the syncmer to itself. The
//     strobe's hash is h_m + h_2 (wrapping), its end pos_2 + k.
// Slots [0, n_fwd) and [M, M + n_rc) of a row are valid, with
// n_fwd = n_rc = clamp(n - w_min, 0, M), where n is the number of
// syncmers when len >= w_max and 0 otherwise. Slot indices wrap mod M
// and the reversed list clamps its index to [0, M - 1], as the JAX
// function's roll and clip do; that only matters for rows with more
// than M syncmers, which are tie rows.
//
// Design: one warp per read, four warps a block. The read's codes, its
// s-mer hashes and its syncmer list live in shared memory (9 L + 12 M
// bytes a warp, 21.5 KB a block at L = M = 256). Lanes take positions
// l, l + 32, ...; each emitting lane computes its k-mer hash, and a
// ballot with a prefix popcount places the syncmers in order. Then lanes
// take slots m, m + 32, ... of both strands, so the (B, 2M) outputs are
// written in whole warps of consecutive 8- and 4-byte words.
//
// Bound: the writes. At B = 10 000, L = M = 256 the outputs are 82 MB
// (16 bytes a slot, 512 slots a read) against 2.6 MB of codes read, so
// 25 us at 3.35 TB/s; the arithmetic, about 100 int32-equivalent
// operations a base, is a third of that. xxh64's five 64-bit multiplies
// a hash are each several 32-bit IMADs on this card, and the s-mer and
// k-mer values are repacked from shared memory at every position (s + k
// steps) instead of rolled: both are simple before fast.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int kWarps = 4;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kKeyNone = 0x7FFFFFFF;
constexpr u64 kUmax = ~0ULL;

constexpr u64 P1 = 0x9E3779B185EBCA87ULL;
constexpr u64 P2 = 0xC2B2AE3D27D4EB4FULL;
constexpr u64 P3 = 0x165667B19E3779F9ULL;
constexpr u64 P4 = 0x85EBCA77C2B2AE63ULL;
constexpr u64 P5 = 0x27D4EB2F165667C5ULL;

struct Params {
    int B, L, k, s, t, w_min, w_max, max_dist, M, key_mult;
    u64 q;
};

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

// the canonical 2-bit value of the m-mer at cs[i .. i + m); *clean is
// false when an N lies in it (the value is then garbage, as in the plain
// version)
__device__ __forceinline__ u64 canonical(const uint8_t* cs, int i, int m, bool* clean) {
    u64 f = 0, r = 0;
    bool ok = true;
    for (int j = 0; j < m; ++j) {
        const u64 c = cs[i + j];
        ok &= c < 4;
        f = f * 4 + c;
        r += (3 - c) << (2 * j);
    }
    *clean = ok;
    return f < r ? f : r;
}

// per-warp shared memory: s-mer hashes (L u64), syncmer hashes (M u64),
// syncmer positions (M i32), codes (L u8), rounded up to 16 bytes
__host__ __device__ inline size_t warp_smem(int L, int M) {
    return ((size_t)9 * L + (size_t)12 * M + 15) / 16 * 16;
}

__global__ void __launch_bounds__(kWarps * 32)
seed_randstrobes_kernel(const uint8_t* __restrict__ codes, const int32_t* __restrict__ lengths,
                        Params p, long long* __restrict__ out_hash,
                        int32_t* __restrict__ out_start, int32_t* __restrict__ out_end,
                        int32_t* __restrict__ n_fwd, int32_t* __restrict__ n_rc,
                        uint8_t* __restrict__ tie) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int b = blockIdx.x * kWarps + warp;
    if (b >= p.B) return;  // whole warps only; no block barrier below
    const int L = p.L, M = p.M, k = p.k, s = p.s;
    unsigned char* base = smem + (size_t)warp * warp_smem(L, M);
    u64* sh = (u64*)base;             // [L]
    u64* sync_hash = sh + L;          // [M]
    int* sync_pos = (int*)(sync_hash + M);  // [M]
    uint8_t* cs = (uint8_t*)(sync_pos + M);  // [L]

    const uint8_t* row = codes + (size_t)b * L;
    for (int i = lane; i < L; i += 32) cs[i] = row[i];
    const int len = lengths[b];
    __syncwarp();

    const int w = k - s + 1;
    const int ns = L - s + 1, nk = L - k + 1;
    for (int i = lane; i < ns; i += 32) {
        bool clean;
        const u64 v = canonical(cs, i, s, &clean);
        sh[i] = clean ? xxh64(v) : kUmax;
    }
    __syncwarp();

    // closed syncmers, compacted in position order a round of 32 at a time
    int count = 0;
    bool any_dup = false;
    for (int r0 = 0; r0 < nk; r0 += 32) {  // nk is uniform over the warp
        const int pos = r0 + lane;
        bool emit = false, dup = false;
        u64 khash = 0;
        if (pos < nk) {
            u64 mn = kUmax;
            int arg = 0, ndup = 0;
            for (int j = 0; j < w; ++j) {
                const u64 v = sh[pos + j];
                if (v < mn) {
                    mn = v;
                    arg = j;
                    ndup = 1;
                } else if (v == mn) {
                    ++ndup;
                }
            }
            bool kclean;
            const u64 kv = canonical(cs, pos, k, &kclean);
            const bool gate = kclean && pos + k <= len && mn != kUmax;
            emit = gate && arg == p.t - 1;
            dup = gate && ndup > 1;
            if (emit) khash = xxh64(kv);
        }
        const unsigned ball = __ballot_sync(kFull, emit);
        any_dup |= __any_sync(kFull, dup) != 0;
        if (emit) {
            const int rank = count + __popc(ball & ((1u << lane) - 1u));
            if (rank < M) {
                sync_pos[rank] = pos;
                sync_hash[rank] = khash;
            }
        }
        count += __popc(ball);
    }
    __syncwarp();

    const int n = len >= p.w_max ? count : 0;
    const int n_out = min(max(n - p.w_min, 0), M);
    if (lane == 0) {
        n_fwd[b] = n_out;
        n_rc[b] = n_out;
        tie[b] = (any_dup || count > M) ? 1 : 0;
    }

    long long* oh = out_hash + (size_t)b * 2 * M;
    int32_t* os = out_start + (size_t)b * 2 * M;
    int32_t* oe = out_end + (size_t)b * 2 * M;
    for (int strand = 0; strand < 2; ++strand) {
        for (int m = lane; m < M; m += 32) {
            const int slot = strand * M + m;
            if (m >= n_out) {
                oh[slot] = 0;
                os[slot] = -1;
                oe[slot] = -1;
                continue;
            }
            // entry i of this strand's syncmer list
            auto entry = [&](int i, int* pos, u64* h) {
                if (strand == 0) {
                    *pos = sync_pos[i];
                    *h = sync_hash[i];
                } else {
                    const int src = min(max(n - 1 - i, 0), M - 1);
                    *pos = len - sync_pos[src] - k;
                    *h = sync_hash[src];
                }
            };
            int p1;
            u64 h1;
            entry(m, &p1, &h1);
            int best = kKeyNone, p2 = p1;
            u64 h2 = h1;
            for (int d = p.w_min; d <= p.w_max && m + d < n; ++d) {
                int jp;
                u64 jh;
                entry((m + d) % M, &jp, &jh);
                if (jp > p1 + p.max_dist) continue;
                const int key = __popcll((h1 ^ jh) & p.q) * p.key_mult + (d - p.w_min);
                if (key < best) {
                    best = key;
                    p2 = jp;
                    h2 = jh;
                }
            }
            oh[slot] = (long long)(h1 + h2);
            os[slot] = p1;
            oe[slot] = p2 + k;
        }
    }
}

}  // namespace

// codes (B, L) u8 and lengths (B,) i32 in; hash (B, 2M) i64, start and
// end (B, 2M) i32, n_fwd and n_rc (B,) i32, tie (B,) u8 out. Returns the
// cudaGetLastError() after the launch.
extern "C" int seed_randstrobes_launch(const void* codes, const void* lengths, int B, int L,
                                       int k, int s, int t, int w_min, int w_max,
                                       unsigned long long q, int max_dist, int M, void* hash,
                                       void* start, void* end, void* n_fwd, void* n_rc,
                                       void* tie, void* stream) {
    Params p{B, L, k, s, t, w_min, w_max, max_dist, M, 1, q};
    while (p.key_mult < w_max - w_min + 1) p.key_mult *= 2;
    const size_t smem = kWarps * warp_smem(L, M);
    if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    if (B > 0) {
        seed_randstrobes_kernel<<<(B + kWarps - 1) / kWarps, kWarps * 32, smem,
                                  (cudaStream_t)stream>>>(
            (const uint8_t*)codes, (const int32_t*)lengths, p, (long long*)hash,
            (int32_t*)start, (int32_t*)end, (int32_t*)n_fwd, (int32_t*)n_rc, (uint8_t*)tie);
    }
    return (int)cudaGetLastError();
}
