// Randstrobe seeding of a read batch, both strands, compacted, for Hopper
// (sm_90a).
//
// Replaces rabbitsalign_tpu/ops/seed_device.py:randstrobes_query_vec
// (:432) with the compaction of seed_and_find (:555), XLA ops in the JAX
// package (no pallas_call). Its plain PyTorch version is
// rabbitsalign_tpu_torch/ops/seed_device.py `seed_strobes_plain`
// (`randstrobes_query_vec`, then `compact_strobes`), whose arrays these
// kernels equal byte for byte.
//
// Per read (codes (N, L) u8 in {0..3, 4 = N}, lengths (N,) i32, -1 for a
// read longer than L):
//   * every s-mer start i: the xxh64 of its canonical 2-bit value, or
//     UMAX when an N lies in it;
//   * every k-mer window p (s-mers p .. p + w - 1, w = k - s + 1) inside
//     the read: the minimum hash, its leftmost offset and how often it
//     occurs. The window is a closed syncmer when it is N-free, its
//     minimum is not UMAX and sits at offset t - 1; a duplicated minimum
//     in such a window makes the read a tie row (the host's min-queue
//     breaks that tie by its history, which no closed form can), as do
//     more than M syncmers;
//   * forward strobes from the syncmer list, reverse strobes from the
//     list reversed with positions mirrored (len - pos - k): strobe 2 of
//     syncmer m is the syncmer m + d, d in [w_min, w_max], m + d < n,
//     within max_dist, of least popcount((h_m ^ h_{m+d}) & q), the
//     leftmost on ties; none in range links the syncmer to itself. The
//     strobe's hash is h_m + h_2 (wrapping), its end pos_2 + k.
// The output is what the engine's preseeded phase A reads: counts (N,)
// i32, 2 * max(n - w_min, 0) for n syncmers (n = 0 when len < w_max), -1
// for a tie row or a read longer than L; offsets (N,) i64, their
// exclusive sum over the reads that are not -1; and the total T; then,
// one entry a strobe, each read's forward strobes before its reverse
// ones: hashes i64 (the uint64 bits), positions i64 (left for the index
// lookup), starts and ends i32, is_rev u8. The sections lie back to back
// from `strobes`, each T entries long, so the arrays of a chunk are one
// contiguous prefix of the buffer: ops/seed_device.py `strobe_views`
// reads the same layout, and the host copies that prefix back at once.
//
// Design: three launches on the stream.
//   1. seed_syncmers_kernel, a warp a read, four reads (a tile) a block.
//      The read's codes, its s-mer hashes and its k-mers live in shared
//      memory (17 L bytes a warp). Each lane owns a contiguous run of
//      k-mer windows and the s-mers that start there, and rolls one
//      2-bit value of k codes (both strands) and the position of its last
//      N along them: after k - 1 codes it pushes one code a position, and
//      the s-mer ending at that code is the value's last s codes. A lane
//      marks its syncmers in a bit mask; a warp exclusive scan of their
//      popcounts gives each lane its first rank, so the list comes out in
//      position order into a per-read scratch row of M entries, and lane
//      0 writes the read's count.
//   2. tile_offsets_kernel, one block of 1024 threads: each thread sums
//      the counts of a contiguous run of tiles (four independent loads a
//      tile), a block scan places the runs, and each tile's offset and
//      the total are written.
//   3. seed_link_kernel, a warp a read, a tile a block: the read's offset
//      (its tile's, plus the reads before it in the tile), the read's list
//      into shared memory, then slot j of 2 * n_out per lane, j, j + 32,
//      ..., written at the offset + j: consecutive lanes write consecutive
//      entries.
// Two passes, and not one, because the sections are packed by the total:
// a single pass would not know T while it writes, and the arrays would lie
// at worst-case strides that the host cannot copy back at once. The scan
// runs over tiles, not reads, so that a thread makes a few independent
// loads and not ten dependent ones; a decoupled look-back over the tiles
// inside pass 1, tried instead, made pass 1 slower by more than this scan
// takes (its blocks held their SMs while they looked back; 42.0 us against
// 31.1 and 4.2 for pass 1 and the scan, compare_phase_a.py on an H100).
// Nothing in the (N, 2M) slot space is written: the buffer is sized for
// the worst case (N * 2M strobes) and only the T entries of each section
// are touched.
//
// Bound: operations. At N = 10 016, L = M = 256 the function reads 2.6
// MB of codes and writes 17 B a strobe (423 996 of them) and 12 B a read,
// 9.9 MB, 3 us at 3.35 TB/s; its arithmetic, about 80 int32-equivalent
// operations an s-mer (xxh64's five 64-bit multiplies are each several
// 32-bit IMADs), 65 a syncmer and 12 a strobe-2 candidate, is 9 us at the
// int32 rate. Pass 1 takes most of the time: it issues several times
// those operations (a lane rolls k - 1 codes before its first window,
// 64-bit compares and shifts, the loop's bookkeeping, lanes idle past a
// 150-base read). The scratch list (12 B a syncmer, written and read
// once) is the kernels' own round trip.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int kWarps = 4;
constexpr int kScanThreads = 1024;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kKeyNone = 0x7FFFFFFF;
constexpr u64 kUmax = ~0ULL;

constexpr u64 P1 = 0x9E3779B185EBCA87ULL;
constexpr u64 P2 = 0xC2B2AE3D27D4EB4FULL;
constexpr u64 P3 = 0x165667B19E3779F9ULL;
constexpr u64 P4 = 0x85EBCA77C2B2AE63ULL;
constexpr u64 P5 = 0x27D4EB2F165667C5ULL;

struct Params {
    int N, L, k, s, t, w_min, w_max, max_dist, M, key_mult;
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

// The 2-bit values of an m-mer on both strands, rolled one code at a
// time: fwd holds the first code in its top bits, rev (the reverse
// complement) in its lowest; `last_n` is the position of the last N
// pushed. An N enters as 0: the m-mers that hold it are masked by
// last_n, and it has left both values m pushes later.
struct Roller {
    u64 fwd, rev, mask;
    int shift, last_n;
    __device__ __forceinline__ Roller(int m)
        : fwd(0), rev(0), mask(m == 32 ? kUmax : (1ULL << (2 * m)) - 1), shift(2 * (m - 1)),
          last_n(-1) {}
    __device__ __forceinline__ void push(const uint8_t* cs, int j) {
        const unsigned c = cs[j];
        if (c >= 4) last_n = j;
        fwd = ((fwd << 2) | (c & 3)) & mask;
        rev = (rev >> 2) | ((u64)(3 - (c & 3)) << shift);
    }
    __device__ __forceinline__ u64 canonical() const { return fwd < rev ? fwd : rev; }
};

// pass 1's shared memory a warp: s-mer hashes (L u64), syncmer k-mer
// hashes by position (L u64), codes (L u8), rounded up to 16 bytes
__host__ __device__ inline size_t syncmer_smem(int L) {
    return ((size_t)17 * L + 15) / 16 * 16;
}

// the linking pass's shared memory a warp: the syncmer list, hashes (M u64) and
// positions (M i32)
__host__ __device__ inline size_t link_smem(int M) { return ((size_t)12 * M + 15) / 16 * 16; }

// Pass 1, a warp a read: the read's syncmer list to its scratch row and
// its count to counts[b]. Early returns are whole warps; no block barrier.
__global__ void __launch_bounds__(kWarps * 32)
seed_syncmers_kernel(const uint8_t* __restrict__ codes, const int32_t* __restrict__ lengths,
                     Params p, int32_t* __restrict__ counts, int32_t* __restrict__ sync_pos,
                     u64* __restrict__ sync_hash) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const long long b = (long long)blockIdx.x * kWarps + warp;
    if (b >= p.N) return;
    const int L = p.L, k = p.k, s = p.s, w = k - s + 1;
    u64* sh = (u64*)(smem + (size_t)warp * syncmer_smem(L));  // [L] s-mer hashes
    u64* kh = sh + L;                  // [L] canonical k-mers, then syncmer hashes
    uint8_t* cs = (uint8_t*)(kh + L);  // [L] codes
    const int len = lengths[b];
    const int n_len = len < L ? len : L;
    const int nk = n_len - k + 1;  // windows inside the read
    if (len < 0 || nk <= 0) {
        if (lane == 0) counts[b] = len < 0 ? -1 : 0;
        return;
    }
    const uint8_t* row = codes + b * L;
    for (int i = lane; i < n_len; i += 32) cs[i] = row[i];
    __syncwarp();

    // one roller a lane over a contiguous run: windows [p0, p1) and
    // s-mers [p0, s1) (the last lane's run takes the s-mers past the last
    // window); the s-mer ending at code j is the roller's last s codes
    const int ns = nk + w - 1;
    const int per = (nk + 31) / 32;  // at most 16 for L <= 512: one bit each
    const int p0 = lane * per, p1 = min(p0 + per, nk);
    const int s1 = lane == 31 ? ns : min(p0 + per, ns);
    const u64 smask = s == 32 ? kUmax : (1ULL << (2 * s)) - 1;
    const int sshift = 2 * (k - s);
    unsigned kclean = 0;
    if (p0 < s1) {
        Roller r(k);
        const int end = max(s1 + s - 1, p1 + k - 1);
        for (int j = p0; j < end; ++j) {
            r.push(cs, j);
            const int i = j - s + 1;
            if (i >= p0 && i < s1) {
                const u64 f = r.fwd & smask, v = r.rev >> sshift;
                sh[i] = r.last_n < i ? xxh64(f < v ? f : v) : kUmax;
            }
            const int pos = j - k + 1;
            if (pos >= p0 && pos < p1) {
                kh[pos] = r.canonical();
                kclean |= (unsigned)(r.last_n < pos) << (pos - p0);
            }
        }
    }
    __syncwarp();

    // closed syncmers of the lane's windows, marked in a bit mask
    unsigned emits = 0;
    bool dup = false;
    for (int pos = p0; pos < p1; ++pos) {
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
        const bool gate = (kclean >> (pos - p0) & 1) && mn != kUmax;
        if (gate && arg == p.t - 1) {
            emits |= 1u << (pos - p0);
            kh[pos] = xxh64(kh[pos]);
        }
        dup |= gate && ndup > 1;
    }
    // the lanes' syncmers in position order: an exclusive scan of counts
    const int mine = __popc(emits);
    int incl = mine;
    for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += v;
    }
    const int count = __shfl_sync(kFull, incl, 31);
    const bool tie = __any_sync(kFull, dup) || count > p.M;
    const int n = len >= p.w_max ? count : 0;
    const int n_out = n > p.w_min ? n - p.w_min : 0;  // <= M: count <= M past a tie
    if (lane == 0) counts[b] = tie ? -1 : 2 * n_out;
    if (tie || n_out == 0) return;
    int rank = incl - mine;
    int32_t* lp = sync_pos + b * p.M;
    u64* lh = sync_hash + b * p.M;
    for (unsigned e = emits; e; e &= e - 1) {
        const int pos = p0 + __ffs(e) - 1;
        lp[rank] = pos;
        lh[rank] = kh[pos];
        ++rank;
    }
}

// The strobes of the reads of tile t (kWarps reads, a block of the other
// two kernels).
__device__ __forceinline__ long long tile_sum(const int32_t* __restrict__ counts, long long N,
                                              long long t) {
    long long sum = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
        const long long r = t * kWarps + i;
        if (r < N) sum += max(counts[r], 0);
    }
    return sum;
}

__global__ void __launch_bounds__(kScanThreads)
tile_offsets_kernel(const int32_t* __restrict__ counts, long long N,
                    long long* __restrict__ tile_at, long long* __restrict__ total) {
    __shared__ long long warp_sum[kScanThreads / 32];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const long long n_tiles = (N + kWarps - 1) / kWarps;
    const long long per = (n_tiles + kScanThreads - 1) / kScanThreads;
    const long long t0 = tid * per, t1 = t0 + per < n_tiles ? t0 + per : n_tiles;
    long long sum = 0;
    for (long long t = t0; t < t1; ++t) sum += tile_sum(counts, N, t);
    long long incl = sum;
    for (int o = 1; o < 32; o <<= 1) {
        const long long v = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += v;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        long long v = warp_sum[lane];
        for (int o = 1; o < 32; o <<= 1) {
            const long long u = __shfl_up_sync(kFull, v, o);
            if (lane >= o) v += u;
        }
        warp_sum[lane] = v;
    }
    __syncthreads();
    long long at = incl - sum + (warp > 0 ? warp_sum[warp - 1] : 0);
    for (long long t = t0; t < t1; ++t) {
        tile_at[t] = at;
        at += tile_sum(counts, N, t);
    }
    if (tid == kScanThreads - 1) *total = at;
}

__global__ void __launch_bounds__(kWarps * 32)
seed_link_kernel(const int32_t* __restrict__ lengths, const int32_t* __restrict__ counts,
                 const long long* __restrict__ tile_at, const long long* __restrict__ total,
                 const int32_t* __restrict__ sync_pos, const u64* __restrict__ sync_hash,
                 Params p, long long* __restrict__ offsets, unsigned char* __restrict__ strobes) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const long long b = (long long)blockIdx.x * kWarps + warp;
    if (b >= p.N) return;
    // the read's offset: its tile's, then the reads before it in the tile
    long long off = tile_at[blockIdx.x];
    for (int i = 0; i < warp; ++i) off += max(counts[b - warp + i], 0);
    if (lane == 0) offsets[b] = off;
    const int c = counts[b];
    if (c <= 0) return;
    const int n_out = c >> 1, n = n_out + p.w_min, k = p.k;
    u64* hs = (u64*)(smem + (size_t)warp * link_smem(p.M));  // [M]
    int* ps = (int*)(hs + p.M);                              // [M]
    for (int i = lane; i < n; i += 32) {
        hs[i] = sync_hash[b * p.M + i];
        ps[i] = sync_pos[b * p.M + i];
    }
    __syncwarp();
    const long long T = *total;
    long long* oh = (long long*)strobes;
    int32_t* os = (int32_t*)(strobes + 16 * T);
    int32_t* oe = (int32_t*)(strobes + 20 * T);
    uint8_t* orv = strobes + 24 * T;
    const int len = lengths[b];
    for (int j = lane; j < 2 * n_out; j += 32) {
        const int strand = j >= n_out;
        const int m = j - strand * n_out;
        // entry i of this strand's syncmer list
        auto entry = [&](int i, int* pos, u64* h) {
            const int src = strand ? n - 1 - i : i;
            *pos = strand ? len - ps[src] - k : ps[src];
            *h = hs[src];
        };
        int p1;
        u64 h1;
        entry(m, &p1, &h1);
        int best = kKeyNone, p2 = p1;
        u64 h2 = h1;
        for (int d = p.w_min; d <= p.w_max && m + d < n; ++d) {
            int jp;
            u64 jh;
            entry(m + d, &jp, &jh);
            if (jp > p1 + p.max_dist) continue;
            const int key = __popcll((h1 ^ jh) & p.q) * p.key_mult + (d - p.w_min);
            if (key < best) {
                best = key;
                p2 = jp;
                h2 = jh;
            }
        }
        oh[off + j] = (long long)(h1 + h2);
        os[off + j] = p1;
        oe[off + j] = p2 + k;
        orv[off + j] = (uint8_t)strand;
    }
}

}  // namespace

// codes (N, L) u8 and lengths (N,) i32 in (N >= 1; L, M <= 512); counts
// (N,) i32, offsets (N,) i64 and total (1,) i64 out; strobes: the
// sections of ops/seed_device.py `strobe_views` (room for N * 2M
// strobes); sync_pos (N, M) i32, sync_hash (N, M) u64 and tile_at
// (N / 4 + 1,) i64 scratch. Returns the first cudaGetLastError() that is
// not 0, after each launch.
extern "C" int seed_randstrobes_launch(const void* codes, const void* lengths, int N, int L,
                                       int k, int s, int t, int w_min, int w_max,
                                       unsigned long long q, int max_dist, int M, void* counts,
                                       void* offsets, void* total, void* strobes,
                                       void* sync_pos, void* sync_hash, void* tile_at,
                                       void* stream) {
    Params p{N, L, k, s, t, w_min, w_max, max_dist, M, 1, q};
    while (p.key_mult < w_max - w_min + 1) p.key_mult *= 2;
    const size_t smem1 = kWarps * syncmer_smem(L), smem3 = kWarps * link_smem(M);
    if (smem1 > 48 * 1024 || smem3 > 48 * 1024 || L > 512) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const unsigned blocks = (unsigned)((N + kWarps - 1) / kWarps);
    seed_syncmers_kernel<<<blocks, kWarps * 32, smem1, st>>>(
        (const uint8_t*)codes, (const int32_t*)lengths, p, (int32_t*)counts, (int32_t*)sync_pos,
        (u64*)sync_hash);
    int err = (int)cudaGetLastError();
    if (err) return err;
    tile_offsets_kernel<<<1, kScanThreads, 0, st>>>((const int32_t*)counts, N,
                                                    (long long*)tile_at, (long long*)total);
    err = (int)cudaGetLastError();
    if (err) return err;
    seed_link_kernel<<<blocks, kWarps * 32, smem3, st>>>(
        (const int32_t*)lengths, (const int32_t*)counts, (const long long*)tile_at,
        (const long long*)total, (const int32_t*)sync_pos, (const u64*)sync_hash, p,
        (long long*)offsets, (unsigned char*)strobes);
    return (int)cudaGetLastError();
}
