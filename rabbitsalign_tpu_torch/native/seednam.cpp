// Native host hot path: syncmer/randstrobe seeding, strobemer index
// lookup and NAM chaining for a whole chunk of reads.
//
// This is the TPU framework's equivalent of the reference's CPU hot loops
// (randstrobes_query -> find_nams / find_nams_rescue); a fresh C++
// implementation of the same semantics as rabbitsalign_tpu's Python layer
// (seed/syncmers.py, seed/randstrobes.py, chain/nams.py), which is itself
// validated bit-exact against the reference. Exposed via ctypes; the
// index arrays are borrowed zero-copy from numpy.
//
// Per-read NAMs are returned in emission order (nam_id == order); score
// sorting and tie shuffling stay in Python where the reproducible RNG
// lives.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

#if defined(__AVX512F__) && defined(__AVX512DQ__) && defined(__AVX512BW__)
// BW is required too: the x8 linker's popcount path uses byte-granular
// shuffles/adds/psadbw (_mm512_shuffle_epi8 / _mm512_sad_epu8)
#include <immintrin.h>
#define SEEDNAM_AVX512 1
#endif

namespace {

using u8 = uint8_t;
using u32 = uint32_t;
using u64 = uint64_t;
using i64 = int64_t;

constexpr u64 UMAX = ~0ULL;

inline u64 xxh64(u64 x) {
    constexpr u64 P1 = 0x9E3779B185EBCA87ULL, P2 = 0xC2B2AE3D27D4EB4FULL,
                  P3 = 0x165667B19E3779F9ULL, P4 = 0x85EBCA77C2B2AE63ULL,
                  P5 = 0x27D4EB2F165667C5ULL;
    u64 r = P5 + 8;
    x *= P2;
    x = (x << 31) | (x >> 33);
    r ^= x * P1;
    r = (r << 27) | (r >> 37);
    r = r * P1 + P4;
    r ^= r >> 33;
    r *= P2;
    r ^= r >> 29;
    r *= P3;
    r ^= r >> 32;
    return r;
}

#ifdef SEEDNAM_AVX512
// xxh64 on 8 u64 lanes in-register (same chain as xxh64 above) — the
// ONE vectorized copy of the hash; xxh64_many and the x8 automaton both
// call it so the chain can never silently fork
inline __m512i xxh64_vec(__m512i x) {
    const __m512i vP1 = _mm512_set1_epi64((long long)0x9E3779B185EBCA87ULL);
    const __m512i vP2 = _mm512_set1_epi64((long long)0xC2B2AE3D27D4EB4FULL);
    const __m512i vP3 = _mm512_set1_epi64((long long)0x165667B19E3779F9ULL);
    const __m512i vP4 = _mm512_set1_epi64((long long)0x85EBCA77C2B2AE63ULL);
    const __m512i vR0 =
        _mm512_set1_epi64((long long)(0x27D4EB2F165667C5ULL + 8));
    x = _mm512_mullo_epi64(x, vP2);
    x = _mm512_rol_epi64(x, 31);
    __m512i r = _mm512_xor_si512(vR0, _mm512_mullo_epi64(x, vP1));
    r = _mm512_rol_epi64(r, 27);
    r = _mm512_add_epi64(_mm512_mullo_epi64(r, vP1), vP4);
    r = _mm512_xor_si512(r, _mm512_srli_epi64(r, 33));
    r = _mm512_mullo_epi64(r, vP2);
    r = _mm512_xor_si512(r, _mm512_srli_epi64(r, 29));
    r = _mm512_mullo_epi64(r, vP3);
    r = _mm512_xor_si512(r, _mm512_srli_epi64(r, 32));
    return r;
}
#endif

// hash a contiguous array in place: out[i] = xxh64(in[i]). The s-mer
// hash is the per-base hot loop of seeding (reference hashes every
// s-mer position the same way, src/randstrobes.cpp:33-50); on AVX-512
// (F+DQ: 64-bit vector multiply + rotate) this runs 8 lanes per
// instruction, ~5x the scalar multiply-chain throughput.
inline void xxh64_many(const u64* in, u64* out, i64 n) {
    i64 i = 0;
#ifdef SEEDNAM_AVX512
    for (; i + 8 <= n; i += 8)
        _mm512_storeu_si512(
            (void*)(out + i),
            xxh64_vec(_mm512_loadu_si512((const void*)(in + i))));
#endif
    for (; i < n; ++i) out[i] = xxh64(in[i]);
}

// nucleotide -> 2-bit code, 4 for ambiguous (table lookup)
struct Nt4Table {
    u8 t[256];
    Nt4Table() {
        for (int i = 0; i < 256; ++i) t[i] = 4;
        t['A'] = t['a'] = 0;
        t['C'] = t['c'] = 1;
        t['G'] = t['g'] = 2;
        t['T'] = t['t'] = t['U'] = t['u'] = 3;
    }
};
static const Nt4Table NT4;
inline int nt4(u8 c) { return NT4.t[c]; }

struct Syncmer {
    u64 hash;
    i64 pos;
};

// canonical closed syncmers; exact port of the min-queue automaton
// (same semantics as seed/syncmers.py syncmers_slow). Two passes: the
// first computes every s-mer hash and canonical k-mer value (no
// cross-iteration dependency, so the xxh64 multiply chains pipeline);
// the second runs the window automaton over the precomputed arrays.
static void syncmers_of(const u8* seq, i64 n, int k, int s, int t,
                        std::vector<Syncmer>& out) {
    out.clear();
    const u64 kmask = (k < 32) ? ((1ULL << (2 * k)) - 1) : UMAX;
    const u64 smask = (1ULL << (2 * s)) - 1;
    const int kshift = (k - 1) * 2;
    const int sshift = (s - 1) * 2;
    const int w = k - s + 1;

    // TILED passes: both the rolling registers (pass 1a) and the window
    // automaton (pass 2) are strictly sequential, so their state carries
    // across tile boundaries and the per-position arrays only need TILE
    // entries — identical operation sequence, bounded memory. The flat
    // per-contig arrays (20 B/base) made whole-genome index builds
    // page-fault-bound (a cold 200 Mbp contig spent 2-4x the build's CPU
    // time faulting in ~4 GB of scratch); the tile also keeps pass
    // 1a/1b/2 traffic cache-resident.
    constexpr i64 TILE = 1 << 19;  // 512k positions = 10 MB scratch
    const i64 tile_n = n < TILE ? n : TILE;
    thread_local std::vector<u64> smer_hash, kmer_can;
    thread_local std::vector<int32_t> run;  // l counter (0 on N)
    if ((i64)smer_hash.size() < tile_n) {
        smer_hash.resize(tile_n);
        kmer_can.resize(tile_n);
        run.resize(tile_n);
    }

    // pass-1a rolling registers (canonical k-mer/s-mer VALUES; hashing is
    // deferred to the bulk pass so it vectorizes)
    u64 xk0 = 0, xk1 = 0, xs0 = 0, xs1 = 0;
    i64 l = 0;
    // pass-2 window automaton state; ring buffer wraps via
    // compare-subtract (k <= 32 so w <= 64)
    u64 qs[64];
    int qs_size = 0;
    int qs_head = 0;  // index of oldest
    u64 qs_min_val = UMAX;
    i64 qs_min_pos = -1;
    auto wrap = [w](int idx) { return idx >= w ? idx - w : idx; };

    for (i64 a = 0; a < n; a += TILE) {
        const i64 b = (n < a + TILE) ? n : a + TILE;
        const i64 m = b - a;
        // pass 1a over [a, b): registers carried in
        for (i64 i = a; i < b; ++i) {
            int c = nt4(seq[i]);
            if (c < 4) {
                xk0 = ((xk0 << 2) | (u64)c) & kmask;
                xk1 = (xk1 >> 2) | ((u64)(3 - c) << kshift);
                xs0 = ((xs0 << 2) | (u64)c) & smask;
                xs1 = (xs1 >> 2) | ((u64)(3 - c) << sshift);
                ++l;
                run[i - a] = (int32_t)(l < INT32_MAX ? l : INT32_MAX);
                smer_hash[i - a] = xs0 < xs1 ? xs0 : xs1;
                kmer_can[i - a] = xk0 < xk1 ? xk0 : xk1;
            } else {
                l = 0;
                run[i - a] = 0;
                smer_hash[i - a] = 0;
                xs0 = xs1 = xk0 = xk1 = 0;
            }
        }
        // pass 1b: bulk-hash the tile (AVX-512 8-lane when available);
        // positions with run < s hash a garbage value the automaton never
        // reads — branchless beats masking here
        xxh64_many(smer_hash.data(), smer_hash.data(), m);

        // pass 2 over [a, b): automaton state carried in
        for (i64 i = a; i < b; ++i) {
            int32_t li = run[i - a];
            if (li == 0) {
                qs_min_val = UMAX;
                qs_min_pos = -1;
                qs_size = 0;
                qs_head = 0;
                continue;
            }
            if (li < s) continue;
            u64 hash_s = smer_hash[i - a];
            if (qs_size < w) {
                qs[wrap(qs_head + qs_size)] = hash_s;
                qs_size++;
                if (qs_size < w) continue;
                // first full window: leftmost minimum
                for (int j = 0; j < w; ++j) {
                    u64 v = qs[wrap(qs_head + j)];
                    if (v < qs_min_val) {
                        qs_min_val = v;
                        qs_min_pos = i - k + j + 1;
                    }
                }
            } else {
                // pop front, push back
                qs[qs_head] = hash_s;
                qs_head = wrap(qs_head + 1);
                if (qs_min_pos == i - k) {
                    // tracked min slid out: rightmost minimum wins
                    qs_min_val = UMAX;
                    qs_min_pos = i - s + 1;
                    for (int j = w - 1; j >= 0; --j) {
                        u64 v = qs[wrap(qs_head + j)];
                        if (v < qs_min_val) {
                            qs_min_val = v;
                            qs_min_pos = i - k + j + 1;
                        }
                    }
                } else if (hash_s < qs_min_val) {
                    qs_min_val = hash_s;
                    qs_min_pos = i - s + 1;
                }
            }
            if (qs_min_pos == i - k + t) {
                out.push_back({xxh64(kmer_can[i - a]), i - k + 1});
            }
        }
    }
}

#ifdef SEEDNAM_AVX512
// 8 reads through the syncmer automaton in AVX-512 lockstep, one read
// per 64-bit lane. Bit-exact with syncmers_of: the data-dependent
// branches become lane masks —
//   * filling (l <= k): the "leftmost minimum on first full window"
//     scan is replaced by the equivalent incremental strict-< push rule
//     (processing left to right, "replace only if strictly smaller" IS
//     the leftmost minimum);
//   * eviction rescan (tracked min slid out): rightmost minimum via an
//     ascending-j overwrite on value equality;
//   * emits: per-lane compress-stores of (canonical k-mer, lane|pos),
//     k-mer hashing deferred to one bulk xxh64 pass, then routed back
//     to per-lane outputs in order.
// The window lives in W registers shifted per push (W = k-s+1 is 5 for
// every short-read profile, 7 for r400; other widths take the scalar
// path via syncmers_of_batch).
template <int W>
static void syncmers_of_x8_impl(const u8* const seqs[8], const i64 lens[8],
                                int k, int s, int t,
                                std::vector<Syncmer>* outs[8]) {
    const u64 kmask = (k < 32) ? ((1ULL << (2 * k)) - 1) : UMAX;
    const u64 smask = (1ULL << (2 * s)) - 1;
    const int kshift = (k - 1) * 2;
    const int sshift = (s - 1) * 2;

    i64 Lmax = 0;
    for (int l = 0; l < 8; ++l) Lmax = std::max(Lmax, lens[l]);
    for (int l = 0; l < 8; ++l) outs[l]->clear();
    if (Lmax == 0) return;

    // lane-transposed nt4 codes; lanes past their read length read 4
    // (ambiguous), which keeps l at 0 — no emits, no state
    thread_local std::vector<u8> codes;
    codes.resize((size_t)Lmax * 8);
    for (int l = 0; l < 8; ++l) {
        const u8* sq = seqs[l];
        const i64 n = lens[l];
        for (i64 i = 0; i < n; ++i) codes[(size_t)i * 8 + l] = NT4.t[sq[i]];
        for (i64 i = n; i < Lmax; ++i) codes[(size_t)i * 8 + l] = 4;
    }
    thread_local std::vector<u64> em_kmer, em_meta, em_hash;
    em_kmer.resize((size_t)Lmax * 8);
    em_meta.resize((size_t)Lmax * 8);
    i64 n_emit = 0;

    const __m512i vzero = _mm512_setzero_si512();
    const __m512i v3 = _mm512_set1_epi64(3);
    const __m512i v4 = _mm512_set1_epi64(4);
    const __m512i vkmask = _mm512_set1_epi64((long long)kmask);
    const __m512i vsmask = _mm512_set1_epi64((long long)smask);
    const __m512i vs = _mm512_set1_epi64(s);
    const __m512i vk = _mm512_set1_epi64(k);
    const __m512i vumax = _mm512_set1_epi64(-1);
    const __m512i vneg1 = _mm512_set1_epi64(-1);
    const __m512i vlane = _mm512_set_epi64(
        7LL << 48, 6LL << 48, 5LL << 48, 4LL << 48,
        3LL << 48, 2LL << 48, 1LL << 48, 0LL << 48);

    __m512i xk0 = vzero, xk1 = vzero, xs0 = vzero, xs1 = vzero;
    __m512i vl = vzero;  // consecutive-ACGT run length per lane
    __m512i q[W];
    for (int j = 0; j < W; ++j) q[j] = vzero;
    __m512i minval = vumax, minpos = vneg1;

    for (i64 i = 0; i < Lmax; ++i) {
        __m512i c = _mm512_cvtepu8_epi64(
            _mm_loadl_epi64((const __m128i*)&codes[(size_t)i * 8]));
        __mmask8 valid = _mm512_cmplt_epu64_mask(c, v4);
        // rolling registers; invalid lanes reset to 0 (maskz)
        xk0 = _mm512_maskz_and_epi64(
            valid, _mm512_or_si512(_mm512_slli_epi64(xk0, 2), c), vkmask);
        xk1 = _mm512_maskz_or_epi64(
            valid, _mm512_srli_epi64(xk1, 2),
            _mm512_slli_epi64(_mm512_sub_epi64(v3, c), kshift));
        xs0 = _mm512_maskz_and_epi64(
            valid, _mm512_or_si512(_mm512_slli_epi64(xs0, 2), c), vsmask);
        xs1 = _mm512_maskz_or_epi64(
            valid, _mm512_srli_epi64(xs1, 2),
            _mm512_slli_epi64(_mm512_sub_epi64(v3, c), sshift));
        vl = _mm512_maskz_add_epi64(valid, vl, _mm512_set1_epi64(1));
        minval = _mm512_mask_blend_epi64(valid, vumax, minval);
        minpos = _mm512_mask_blend_epi64(valid, vneg1, minpos);

        __mmask8 pushm = _mm512_cmpge_epu64_mask(vl, vs);  // l >= s
        if (!pushm) continue;

        __m512i sval = _mm512_min_epu64(xs0, xs1);
        __m512i h = xxh64_vec(sval);
        __mmask8 fullm = _mm512_cmpge_epu64_mask(vl, vk);             // l >= k
        __mmask8 evictm = _mm512_cmpgt_epu64_mask(vl, vk) & pushm;    // l > k
        // tracked min slides out this step? (checked BEFORE updates,
        // exactly like the scalar pop-front branch)
        __mmask8 rescanm =
            evictm & _mm512_cmpeq_epi64_mask(minpos, _mm512_set1_epi64(i - k));

        // shift the window registers on push lanes (q[W-1] = newest)
        for (int j = 0; j + 1 < W; ++j)
            q[j] = _mm512_mask_blend_epi64(pushm, q[j], q[j + 1]);
        q[W - 1] = _mm512_mask_blend_epi64(pushm, q[W - 1], h);

        if (rescanm) {
            // rightmost minimum of the shifted window (incl. the new
            // element): ascending-j overwrite on equality
            __m512i rv = q[0];
            for (int j = 1; j < W; ++j) rv = _mm512_min_epu64(rv, q[j]);
            __m512i rp = vzero;
            for (int j = 0; j < W; ++j)
                rp = _mm512_mask_blend_epi64(
                    _mm512_cmpeq_epi64_mask(q[j], rv), rp,
                    _mm512_set1_epi64(i - k + 1 + j));
            minval = _mm512_mask_blend_epi64(rescanm, minval, rv);
            minpos = _mm512_mask_blend_epi64(rescanm, minpos, rp);
        }
        // push rule (fill lanes + non-rescan evict lanes): strict <
        __mmask8 pr =
            (pushm & ~rescanm) & _mm512_cmplt_epu64_mask(h, minval);
        minval = _mm512_mask_blend_epi64(pr, minval, h);
        minpos = _mm512_mask_blend_epi64(pr, minpos,
                                         _mm512_set1_epi64(i - s + 1));

        __mmask8 em = pushm & fullm &
                      _mm512_cmpeq_epi64_mask(minpos,
                                              _mm512_set1_epi64(i - k + t));
        if (em) {
            __m512i kcan = _mm512_min_epu64(xk0, xk1);
            _mm512_mask_compressstoreu_epi64(&em_kmer[n_emit], em, kcan);
            __m512i meta = _mm512_or_si512(
                vlane, _mm512_set1_epi64(i - k + 1));
            _mm512_mask_compressstoreu_epi64(&em_meta[n_emit], em, meta);
            n_emit += __builtin_popcount(em);
        }
    }

    em_hash.resize((size_t)n_emit);
    xxh64_many(em_kmer.data(), em_hash.data(), n_emit);
    for (i64 e = 0; e < n_emit; ++e) {
        int lane = (int)(em_meta[e] >> 48);
        outs[lane]->push_back(
            {em_hash[e], (i64)(em_meta[e] & 0xFFFFFFFFFFFFULL)});
    }
}
#endif  // SEEDNAM_AVX512

// batch front end: 8 reads at a time through the AVX-512 lockstep
// automaton when the toolchain + CPU + window width allow, else the
// scalar automaton per read. Bit-exact either way (fuzz gate:
// tests/sanitize/syncmer_x8_fuzz.cpp).
static void syncmers_of_batch(const u8* const seqs[8], const i64 lens[8],
                              int k, int s, int t,
                              std::vector<Syncmer>* outs[8]) {
#ifdef SEEDNAM_AVX512
    const int w = k - s + 1;
    if (w == 5) return syncmers_of_x8_impl<5>(seqs, lens, k, s, t, outs);
    if (w == 7) return syncmers_of_x8_impl<7>(seqs, lens, k, s, t, outs);
#endif
    for (int l = 0; l < 8; ++l)
        syncmers_of(seqs[l], lens[l], k, s, t, *outs[l]);
}

struct QueryRandstrobe {
    u64 hash;
    int start;
    int end;
    bool is_reverse;
};

inline int popcount64(u64 x) { return __builtin_popcountll(x); }

// link syncmers into randstrobes (same semantics as link_randstrobes)
static void link_strobes(const Syncmer* sync, i64 n, int wmin, int wmax,
                         u64 qmask, int max_dist, int k, bool is_reverse,
                         std::vector<QueryRandstrobe>& out) {
    for (i64 i = 0; i + wmin < n; ++i) {
        const Syncmer& s1 = sync[i];
        i64 wend = std::min(i + (i64)wmax, n - 1);
        i64 max_position = s1.pos + max_dist;
        u64 min_val = UMAX;
        i64 best = i;
        for (i64 j = i + wmin; j <= wend && sync[j].pos <= max_position; ++j) {
            u64 res = (u64)popcount64((s1.hash ^ sync[j].hash) & qmask);
            if (res < min_val) {
                min_val = res;
                best = j;
            }
        }
        out.push_back({s1.hash + sync[best].hash, (int)s1.pos,
                       (int)sync[best].pos + k, is_reverse});
    }
}

// Padding contract for the vectorized linker: callers guarantee at
// least LINK_PAD readable Syncmer entries past index n-1 (sentinels or
// a following record's entries — values are masked, they only need to
// be dereferenceable). Covers the widest profile window (wmax 23 for
// r400) plus the 7-lane group overhang.
static const int LINK_PAD = 32;

#ifdef SEEDNAM_AVX512
// 8 emit positions i..i+7 in lockstep; window offsets d in
// [wmin, wmax] become deinterleaved unaligned loads of the AoS
// {hash, pos} pairs; popcount via the nibble-LUT + psadbw idiom (no
// VPOPCNTDQ on this core). Bit-exact with the scalar linker:
//   * ascending-d strict-< update == scalar's first-minimum rule;
//   * the scalar early break on pos > max_position relies on pos
//     monotonicity within a read, so the mask form (candidate valid
//     iff pos <= max_position AND i+d <= n-1) is equivalent;
//   * lanes whose window is empty keep best = i (hash doubled), like
//     the scalar loop.
static void link_strobes_x8(const Syncmer* sync, i64 n, int wmin, int wmax,
                            u64 qmask, int max_dist, int k, bool is_reverse,
                            std::vector<QueryRandstrobe>& out) {
    const i64 n_emit = n - wmin;
    if (n_emit <= 0) return;
    out.reserve(out.size() + (size_t)n_emit);

    const __m512i idx_even = _mm512_set_epi64(14, 12, 10, 8, 6, 4, 2, 0);
    const __m512i idx_odd = _mm512_set_epi64(15, 13, 11, 9, 7, 5, 3, 1);
    const __m512i vqmask = _mm512_set1_epi64((long long)qmask);
    const __m512i vlut = _mm512_broadcast_i32x4(
        _mm_setr_epi8(0, 1, 1, 2, 1, 2, 2, 3, 1, 2, 2, 3, 2, 3, 3, 4));
    const __m512i vnib = _mm512_set1_epi8(0x0F);
    const __m512i vzero = _mm512_setzero_si512();
    const __m512i vlane = _mm512_set_epi64(7, 6, 5, 4, 3, 2, 1, 0);
    const __m512i vmaxd = _mm512_set1_epi64(max_dist);
    const __m512i vlast = _mm512_set1_epi64(n - 1);
    const u64* base = (const u64*)sync;

    alignas(64) u64 oh[8];
    alignas(64) i64 op1[8], obp[8];
    for (i64 i0 = 0; i0 < n_emit; i0 += 8) {
        __m512i a = _mm512_loadu_si512(base + 2 * i0);
        __m512i b = _mm512_loadu_si512(base + 2 * i0 + 8);
        __m512i h1 = _mm512_permutex2var_epi64(a, idx_even, b);
        __m512i p1 = _mm512_permutex2var_epi64(a, idx_odd, b);
        __m512i vmaxpos = _mm512_add_epi64(p1, vmaxd);
        __m512i vi = _mm512_add_epi64(_mm512_set1_epi64(i0), vlane);
        __m512i minval = _mm512_set1_epi64(-1);  // UMAX (unsigned cmp)
        __m512i bh = h1, bp = p1;
        for (int d = wmin; d <= wmax; ++d) {
            a = _mm512_loadu_si512(base + 2 * (i0 + d));
            b = _mm512_loadu_si512(base + 2 * (i0 + d) + 8);
            __m512i hj = _mm512_permutex2var_epi64(a, idx_even, b);
            __m512i pj = _mm512_permutex2var_epi64(a, idx_odd, b);
            __mmask8 valid = _mm512_cmple_epi64_mask(
                _mm512_add_epi64(vi, _mm512_set1_epi64(d)), vlast);
            valid &= _mm512_cmple_epi64_mask(pj, vmaxpos);
            __m512i x = _mm512_and_si512(_mm512_xor_si512(h1, hj), vqmask);
            __m512i cnt = _mm512_add_epi8(
                _mm512_shuffle_epi8(vlut, _mm512_and_si512(x, vnib)),
                _mm512_shuffle_epi8(
                    vlut, _mm512_and_si512(_mm512_srli_epi64(x, 4), vnib)));
            __m512i res = _mm512_sad_epu8(cnt, vzero);
            __mmask8 upd = valid & _mm512_cmplt_epu64_mask(res, minval);
            minval = _mm512_mask_mov_epi64(minval, upd, res);
            bh = _mm512_mask_mov_epi64(bh, upd, hj);
            bp = _mm512_mask_mov_epi64(bp, upd, pj);
        }
        _mm512_store_si512(oh, _mm512_add_epi64(h1, bh));
        _mm512_store_si512(op1, p1);
        _mm512_store_si512(obp, bp);
        int cnt = (int)std::min<i64>(8, n_emit - i0);
        for (int l = 0; l < cnt; ++l)
            out.push_back({oh[l], (int)op1[l], (int)obp[l] + k, is_reverse});
    }
}
#endif  // SEEDNAM_AVX512

// `padded`: the caller guarantees LINK_PAD readable entries past n-1,
// enabling the 8-lane linker; without it (or without AVX-512) the
// scalar loop runs.
static inline void link_strobes_p(const Syncmer* sync, i64 n, int wmin,
                                  int wmax, u64 qmask, int max_dist, int k,
                                  bool is_reverse,
                                  std::vector<QueryRandstrobe>& out,
                                  bool padded) {
#ifdef SEEDNAM_AVX512
    if (padded && wmax - wmin + 8 <= LINK_PAD)
        return link_strobes_x8(sync, n, wmin, wmax, qmask, max_dist, k,
                               is_reverse, out);
#endif
    (void)padded;
    link_strobes(sync, n, wmin, wmax, qmask, max_dist, k, is_reverse, out);
}

static inline void link_strobes(const std::vector<Syncmer>& sync, int wmin,
                                int wmax, u64 qmask, int max_dist, int k,
                                bool is_reverse,
                                std::vector<QueryRandstrobe>& out) {
    link_strobes(sync.data(), (i64)sync.size(), wmin, wmax, qmask, max_dist,
                 k, is_reverse, out);
}

// THE query-side fw+rc linking contract (reference randstrobes_query,
// src/randstrobes.cpp:207-253): link the forward strand, then link the
// reverse strand from the same canonical syncmers reversed with
// positions mirrored to len - pos - k. `sy` must satisfy the LINK_PAD
// readable-rows contract; `sync_rc` is caller-owned scratch (its pad
// rows only need to be dereferenceable, resize() guarantees that).
// Every host seeding path calls THIS helper so the fw/rc discipline can
// never fork between the engine, the preseed pass, and seednam_chunk.
static inline void link_query_both(const Syncmer* sy, i64 nsy, i64 len,
                                   int wmin, int wmax, u64 qmask,
                                   int max_dist, int k,
                                   std::vector<Syncmer>& sync_rc,
                                   std::vector<QueryRandstrobe>& out) {
    link_strobes_p(sy, nsy, wmin, wmax, qmask, max_dist, k, false, out, true);
    sync_rc.resize(nsy + LINK_PAD);
    for (i64 i = 0; i < nsy; ++i) {
        const Syncmer& m = sy[nsy - 1 - i];
        sync_rc[i] = {m.hash, len - m.pos - k};
    }
    link_strobes_p(sync_rc.data(), nsy, wmin, wmax, qmask, max_dist, k, true,
                   out, true);
}

// appends LINK_PAD sentinel entries WITHOUT growing the logical length
// the caller passes to the linker (sentinel pos is far enough that a
// real read never reaches it, but correctness only needs the masks)
static inline void pad_syncmers(std::vector<Syncmer>& v) {
    for (int i = 0; i < LINK_PAD; ++i)
        v.push_back({UMAX, (i64)1 << 60});
}

struct Hit {
    int query_start, query_end, ref_start, ref_end;
};

struct Nam {
    int nam_id;
    int query_start, query_end, query_prev;
    int ref_start, ref_end, ref_prev;
    int n_hits;
    int ref_id;
    float score;
    int is_rc;
};

struct IndexView {
    const u64* hashes;
    const u32* positions;
    const u32* packed;
    const u64* buckets;
    u64 n;
    int bits;
    u32 filter_cutoff;
    int k;
};

inline u64 hash_at(const IndexView& ix, u64 pos) {
    return pos < ix.n ? ix.hashes[pos] : UMAX;
}

// bucket-bounded first-occurrence lookup (semantics of
// StrobemerIndex.find incl. the skipped-first-run quirk)
static i64 ix_find(const IndexView& ix, u64 key) {
    u64 top = key >> (64 - ix.bits);
    u64 lo = ix.buckets[top];
    u64 hi = ix.buckets[top + 1];
    if (lo >= hi) return -1;
    if (hi - lo < 64) {
        // short buckets: linear scan beats binary search (reference
        // src/index.hpp:66-79 uses the same small-count shortcut)
#ifdef SEEDNAM_AVX512
        // 8 sorted entries per masked compare: typical buckets (~2-8
        // entries) resolve in ONE iteration with no data-dependent
        // branches inside the scan. Masked loads fault-suppress the
        // lanes past `hi`, so no tail handling or over-read.
        __m512i kb = _mm512_set1_epi64((long long)key);
        for (u64 p = lo; p < hi; p += 8) {
            __mmask8 valid = hi - p >= 8 ? (__mmask8)0xFF
                                         : (__mmask8)((1u << (hi - p)) - 1);
            __m512i v = _mm512_maskz_loadu_epi64(valid, &ix.hashes[p]);
            __mmask8 eq = _mm512_mask_cmpeq_epu64_mask(valid, v, kb);
            if (eq) return (i64)(p + (u64)_tzcnt_u32(eq));
            if (_mm512_mask_cmpgt_epu64_mask(valid, v, kb)) return -1;
        }
        return -1;
#else
        for (u64 p = lo; p < hi; ++p) {
            if (ix.hashes[p] == key) return (i64)p;
            if (ix.hashes[p] > key) return -1;
        }
        return -1;
#endif
    }
    const u64* first = std::lower_bound(ix.hashes + lo, ix.hashes + hi, key);
    u64 pos = (u64)(first - ix.hashes);
    if (pos < hi && pos < ix.n && ix.hashes[pos] == key) return (i64)pos;
    return -1;
}

static u64 ix_count(const IndexView& ix, u64 pos) {
    u64 key = ix.hashes[pos];
    const u64* last = std::upper_bound(ix.hashes + pos, ix.hashes + ix.n, key);
    return (u64)(last - (ix.hashes + pos));
}

// insertion-ordered per-ref hit lists (matches the Python dict layer).
// Reusable: clear() keeps slot capacity so the per-read hot loop does no
// heap allocation in the steady state.
struct HitsPerRef {
    std::vector<std::pair<int, std::vector<Hit>>> pool;
    size_t n_used = 0;

    void clear() {
        for (size_t i = 0; i < n_used; ++i) pool[i].second.clear();
        n_used = 0;
    }
    std::vector<Hit>& get(int ref_id) {
        for (size_t i = 0; i < n_used; ++i)
            if (pool[i].first == ref_id) return pool[i].second;
        if (n_used == pool.size()) pool.emplace_back(ref_id, std::vector<Hit>());
        pool[n_used].first = ref_id;
        pool[n_used].second.clear();
        return pool[n_used++].second;
    }
    void touch(int ref_id) { (void)get(ref_id); }
};

static void add_to_hits_per_ref(HitsPerRef& hpr, int qs, int qe,
                                const IndexView& ix, u64 position) {
    int min_diff = INT32_MAX;
    u64 h0 = ix.hashes[position];
    int qspan = qe - qs;
    for (u64 p = position; p < ix.n && ix.hashes[p] == h0; ++p) {
        int rs = (int)ix.positions[p];
        int re = rs + (int)(ix.packed[p] & 0xFF) + ix.k;
        int diff = std::abs(qspan - (re - rs));
        if (diff <= min_diff) {
            hpr.get((int)(ix.packed[p] >> 8)).push_back({qs, qe, rs, re});
            min_diff = diff;
        }
    }
}

static void pre_create_keys(HitsPerRef& hpr, int qs, int qe,
                            const IndexView& ix, u64 position) {
    int min_diff = INT32_MAX;
    u64 h0 = ix.hashes[position];
    int qspan = qe - qs;
    for (u64 p = position; p < ix.n && ix.hashes[p] == h0; ++p) {
        int rs = (int)ix.positions[p];
        int re = rs + (int)(ix.packed[p] & 0xFF) + ix.k;
        int diff = std::abs(qspan - (re - rs));
        if (diff <= min_diff) {
            hpr.touch((int)(ix.packed[p] >> 8));
            min_diff = diff;
        }
    }
}

namespace rh {

struct Sim {
    std::vector<u8> info;
    std::vector<u32> key;
    std::vector<int> orig;
    u64 mask = 0;
    u64 max_allowed = 0;
    u64 num_elem = 0;
    u64 mult = 0xc4ceb9fe1a85ec53ULL;
    u32 info_inc = 32;
    u32 info_hash_shift = 0;

    static u64 hash_int(u64 x) {
        x ^= x >> 33;
        x *= 0xff51afd7ed558ccdULL;
        x ^= x >> 33;
        return x;
    }
    static u64 calc_max_allowed(u64 n) { return n * 80 / 100; }
    u64 buffer_elems(u64 n) const {
        u64 ma = calc_max_allowed(n);
        return n + (ma < 0xFF ? ma : 0xFF);
    }
    void init_data(u64 max_elements) {
        num_elem = 0;
        mask = max_elements - 1;
        max_allowed = calc_max_allowed(max_elements);
        u64 buf = buffer_elems(max_elements);
        info.assign(buf + 1, 0);
        info[buf] = 1;  // sentinel
        key.assign(buf + 1, 0);
        orig.assign(buf + 1, -1);
        info_inc = 32;
        info_hash_shift = 0;
    }
    void key_to_idx(u32 k, u64* idx, u32* inf) const {
        u64 h = hash_int(k) * mult;
        h ^= h >> 33;
        *inf = info_inc + (u32)((h & 31) >> info_hash_shift);
        *idx = (h >> 5) & mask;
    }
    void shift_up(u64 start_idx, u64 insertion_idx) {
        u64 idx = start_idx;
        key[idx] = key[idx - 1];
        orig[idx] = orig[idx - 1];
        while (--idx != insertion_idx) {
            key[idx] = key[idx - 1];
            orig[idx] = orig[idx - 1];
        }
        idx = start_idx;
        while (idx != insertion_idx) {
            info[idx] = (u8)(info[idx - 1] + info_inc);
            if ((u32)info[idx] + info_inc > 0xFF) max_allowed = 0;
            --idx;
        }
    }
    bool try_increase_info() {
        if (info_inc <= 2) return false;
        info_inc = (u8)(info_inc >> 1);
        ++info_hash_shift;
        u64 buf = buffer_elems(mask + 1);
        for (u64 i = 0; i < buf; ++i) info[i] = (u8)(info[i] >> 1);
        info[buf] = 1;
        max_allowed = calc_max_allowed(mask + 1);
        return true;
    }
    // the rehash insert (keys are unique): "skip forward, use <="
    void insert_move(u32 k, int o) {
        // robin_hood.h:1453 - a zeroed max-allowed mid-rehash halves
        // info_inc before continuing (order-observable!)
        if (max_allowed == 0) try_increase_info();
        u64 idx;
        u32 inf;
        key_to_idx(k, &idx, &inf);
        while (inf <= info[idx]) {
            idx++;
            inf += info_inc;
        }
        u64 insertion_idx = idx;
        u8 insertion_info = (u8)inf;
        if ((u32)insertion_info + info_inc > 0xFF) max_allowed = 0;
        while (info[idx] != 0) {
            idx++;
            inf += info_inc;
        }
        if (idx != insertion_idx) shift_up(idx, insertion_idx);
        info[insertion_idx] = insertion_info;
        key[insertion_idx] = k;
        orig[insertion_idx] = o;
        ++num_elem;
    }
    void rehash_pow2(u64 num_buckets) {
        std::vector<u8> oinfo = std::move(info);
        std::vector<u32> okey = std::move(key);
        std::vector<int> oorig = std::move(orig);
        u64 obuf = oinfo.empty() ? 0 : buffer_elems(mask + 1);
        init_data(num_buckets);
        for (u64 i = 0; i < obuf; ++i)
            if (oinfo[i] != 0) insert_move(okey[i], oorig[i]);
    }
    // robin_hood.h reserve(c, false): grow to the smallest power-of-two
    // bucket count whose max-load bound covers c (reference calls
    // hits_per_ref[*].reserve(100) at every construction site,
    // src/nam.cpp:589,776,967,1020 -> 128 buckets)
    void reserve(u64 c) {
        u64 min_allowed = c > num_elem ? c : num_elem;
        u64 new_size = 8;
        while (calc_max_allowed(new_size) < min_allowed && new_size != 0)
            new_size *= 2;
        if (new_size > mask + 1 || mask == 0) rehash_pow2(new_size);
    }
    bool increase_size() {
        if (mask == 0) {
            init_data(8);
            return true;
        }
        if (num_elem < calc_max_allowed(mask + 1) && try_increase_info())
            return true;
        mult += 0xc4ceb9fe1a85ec54ULL;
        if (num_elem * 2 < calc_max_allowed(mask + 1))
            rehash_pow2(mask + 1);
        else
            rehash_pow2((mask + 1) * 2);
        return true;
    }
    // operator[] first-touch (full insertKeyPrepareEmptySpot)
    void touch(u32 k, int o) {
        for (int attempt = 0; attempt < 256; ++attempt) {
            if (mask == 0) {
                increase_size();
                continue;
            }
            u64 idx;
            u32 inf;
            key_to_idx(k, &idx, &inf);
            while (inf < info[idx]) {
                idx++;
                inf += info_inc;
            }
            while (inf == info[idx]) {
                if (key[idx] == k) return;  // found
                idx++;
                inf += info_inc;
            }
            if (num_elem >= max_allowed) {
                increase_size();
                continue;
            }
            u64 insertion_idx = idx;
            u8 insertion_info = (u8)inf;
            if ((u32)insertion_info + info_inc > 0xFF) max_allowed = 0;
            while (info[idx] != 0) {
                idx++;
                inf += info_inc;
            }
            if (idx != insertion_idx) shift_up(idx, insertion_idx);
            info[insertion_idx] = insertion_info;
            key[insertion_idx] = k;
            orig[insertion_idx] = o;
            ++num_elem;
            return;
        }
    }
};

}  // namespace rh

void rh_iteration_perm(const std::vector<std::pair<int, std::vector<Hit>>>& pool,
                       size_t n_used, std::vector<int32_t>& perm) {
    perm.resize(n_used);
    if (n_used <= 1) {
        if (n_used == 1) perm[0] = 0;
        return;
    }
    rh::Sim sim;
    sim.reserve(100);
    for (size_t i = 0; i < n_used; ++i) sim.touch((u32)pool[i].first, (int)i);
    size_t w = 0;
    u64 buf = sim.mask ? sim.buffer_elems(sim.mask + 1) : 0;
    for (u64 i = 0; i < buf && w < n_used; ++i)
        if (sim.info[i] != 0) perm[w++] = sim.orig[i];
    for (size_t i = w; i < n_used; ++i) perm[i] = (int32_t)i;
}

static inline float nam_score(const Nam& n) {
    int qspan = n.query_end - n.query_start;
    int rspan = n.ref_end - n.ref_start;
    int mx = std::max(qspan, rspan);
    int mn = std::min(qspan, rspan);
    int v = 2 * mn - mx;
    return v > 0 ? (float)(n.n_hits * v) : 1.0f;
}

static void flush_open(std::vector<Nam>& open_nams, int query_start,
                       std::vector<Nam>& nams) {
    size_t w = 0;
    for (size_t i = 0; i < open_nams.size(); ++i) {
        Nam& nm = open_nams[i];
        if (nm.query_end < query_start) {
            nm.score = nam_score(nm);
            nm.nam_id = (int)nams.size();
            nams.push_back(nm);
        } else {
            open_nams[w++] = nm;
        }
    }
    open_nams.resize(w);
}

static void merge_hits(HitsPerRef& hpr, int k, bool sort, bool is_rc,
                       std::vector<Nam>& nams) {
    // per-ref groups iterate in robin_hood slot order like the reference
    thread_local std::vector<int32_t> perm;
    rh_iteration_perm(hpr.pool, hpr.n_used, perm);
    for (size_t pi = 0; pi < hpr.n_used; ++pi) {
        size_t ri = (size_t)perm[pi];
        int ref_id = hpr.pool[ri].first;
        auto& hits = hpr.pool[ri].second;
        if (sort)
            // reference Hit::operator< (partial key; unstable sort order
            // under (qs, rs) ties is part of the observable output)
            std::sort(hits.begin(), hits.end(), [](const Hit& a, const Hit& b) {
                return a.query_start != b.query_start ? a.query_start < b.query_start
                                                      : a.ref_start < b.ref_start;
            });
        thread_local std::vector<Nam> open_nams;
        open_nams.clear();
        int prev_q_start = 0;
        for (const Hit& h : hits) {
            bool is_added = false;
            for (Nam& o : open_nams) {
                if (o.query_prev < h.query_start && h.query_start <= o.query_end &&
                    o.ref_prev < h.ref_start && h.ref_start <= o.ref_end) {
                    if (h.query_end > o.query_end && h.ref_end > o.ref_end) {
                        o.query_end = h.query_end;
                        o.ref_end = h.ref_end;
                        o.query_prev = h.query_start;
                        o.ref_prev = h.ref_start;
                        o.n_hits++;
                        is_added = true;
                        break;
                    } else if (h.query_end <= o.query_end && h.ref_end <= o.ref_end) {
                        o.query_prev = h.query_start;
                        o.ref_prev = h.ref_start;
                        o.n_hits++;
                        is_added = true;
                        break;
                    }
                }
            }
            if (!is_added) {
                Nam nm{};
                nm.query_start = nm.query_prev = h.query_start;
                nm.query_end = h.query_end;
                nm.ref_start = nm.ref_prev = h.ref_start;
                nm.ref_end = h.ref_end;
                nm.ref_id = ref_id;
                nm.n_hits = 1;
                nm.is_rc = is_rc ? 1 : 0;
                open_nams.push_back(nm);
            }
            if (h.query_start > prev_q_start + k) {
                flush_open(open_nams, h.query_start, nams);
                prev_q_start = h.query_start;
            }
        }
        for (Nam& nm : open_nams) {
            nm.score = nam_score(nm);
            nm.nam_id = (int)nams.size();
            nams.push_back(nm);
        }
    }
}

// grouped variant used by the rescue path (chain/nams.py
// merge_hits_into_nams_fast semantics)
static void merge_hits_fast(HitsPerRef& hpr, int k, bool sort, bool is_rc,
                            std::vector<Nam>& nams) {
    thread_local std::vector<int32_t> perm;
    rh_iteration_perm(hpr.pool, hpr.n_used, perm);
    for (size_t pi = 0; pi < hpr.n_used; ++pi) {
        size_t ri = (size_t)perm[pi];
        int ref_id = hpr.pool[ri].first;
        auto& hits = hpr.pool[ri].second;
        if (sort)
            // reference Hit::operator< (partial key; unstable sort order
            // under (qs, rs) ties is part of the observable output)
            std::sort(hits.begin(), hits.end(), [](const Hit& a, const Hit& b) {
                return a.query_start != b.query_start ? a.query_start < b.query_start
                                                      : a.ref_start < b.ref_start;
            });
        thread_local std::vector<Nam> open_nams;
        open_nams.clear();
        int prev_q_start = 0;
        size_t i = 0;
        while (i < hits.size()) {
            size_t i_start = i, i_end = i + 1;
            while (i_end < hits.size() && hits[i_end].query_start == hits[i].query_start)
                i_end++;
            i = i_end;
            std::vector<Hit> group(hits.begin() + i_start, hits.begin() + i_end);
            std::sort(group.begin(), group.end(), [](const Hit& a, const Hit& b) {
                return a.query_start != b.query_start ? a.query_start < b.query_start
                                                      : a.ref_start < b.ref_start;
            });
            size_t i_size = group.size();
            std::vector<char> is_added(i_size, 0);
            int query_start = group[0].query_start;
            size_t cnt_done = 0;

            for (Nam& o : open_nams) {
                // binary search the [ref_prev+1, ref_end+1) window
                size_t lower = std::lower_bound(
                                   group.begin(), group.end(), o.ref_prev + 1,
                                   [](const Hit& h, int v) { return h.ref_start < v; }) -
                               group.begin();
                size_t upper = std::lower_bound(
                                   group.begin(), group.end(), o.ref_end + 1,
                                   [](const Hit& h, int v) { return h.ref_start < v; }) -
                               group.begin();
                for (size_t j = lower; j < upper; ++j) {
                    if (is_added[j]) continue;
                    if (query_start <= o.query_end) {
                        const Hit& h = group[j];
                        if (o.ref_prev < h.ref_start && h.ref_start <= o.ref_end) {
                            if (h.query_end > o.query_end && h.ref_end > o.ref_end) {
                                o.query_end = h.query_end;
                                o.ref_end = h.ref_end;
                                o.query_prev = h.query_start;
                                o.ref_prev = h.ref_start;
                                o.n_hits++;
                                is_added[j] = 1;
                                cnt_done++;
                                break;
                            } else if (h.query_end <= o.query_end && h.ref_end <= o.ref_end) {
                                o.query_prev = h.query_start;
                                o.ref_prev = h.ref_start;
                                o.n_hits++;
                                is_added[j] = 1;
                                cnt_done++;
                                break;
                            }
                        }
                    }
                }
                if (cnt_done == i_size) break;
            }

            for (size_t j = 0; j < i_size; ++j) {
                if (!is_added[j]) {
                    const Hit& h = group[j];
                    Nam nm{};
                    nm.query_start = nm.query_prev = h.query_start;
                    nm.query_end = h.query_end;
                    nm.ref_start = nm.ref_prev = h.ref_start;
                    nm.ref_end = h.ref_end;
                    nm.ref_id = ref_id;
                    nm.n_hits = 1;
                    nm.is_rc = is_rc ? 1 : 0;
                    open_nams.push_back(nm);
                }
            }
            if (query_start > prev_q_start + k) {
                flush_open(open_nams, query_start, nams);
                prev_q_start = query_start;
            }
        }
        for (Nam& nm : open_nams) {
            nm.score = nam_score(nm);
            nm.nam_id = (int)nams.size();
            nams.push_back(nm);
        }
    }
}

struct RescueHit {
    u64 position;
    u32 count;
    int query_start, query_end;
};

struct ReadResult {
    std::vector<Nam> nams;
    float nonrep_frac = 1.0f;
    int used_rescue = 0;
};

struct ChunkResult {
    std::vector<ReadResult> reads;
    std::vector<i64> nam_offsets;  // per read start into flat array
    std::vector<int> flat_int;     // 10 ints per nam
    std::vector<float> flat_score;
};

struct NamScratch {
    HitsPerRef hpr[2];
    std::vector<RescueHit> hits_fw, hits_rc, rhs[2];
    std::vector<i64> found;
};

// Phase 2 of find_nams_one: insertion-ordered hit collection from
// precomputed lookup positions (`found`, -1 = absent). Split out so a
// device-seeded pipeline (--device-seed: vectorized seeding + batched
// index find on the accelerator) can feed it directly.
static void find_nams_phase2(const IndexView& ix,
                             const std::vector<QueryRandstrobe>& qrs,
                             const std::vector<i64>& found, ReadResult& rr,
                             NamScratch& scratch) {
    HitsPerRef* hpr = scratch.hpr;
    hpr[0].clear();
    hpr[1].clear();
    int total_hits = 0, good_hits = 0;
    const i64 nq = (i64)qrs.size();
    for (i64 qi = 0; qi < nq; ++qi) {
        i64 pos = found[qi];
        if (pos < 0) continue;
        const auto& q = qrs[qi];
        total_hits++;
        if (hash_at(ix, (u64)pos) == hash_at(ix, (u64)pos + ix.filter_cutoff))
            continue;  // repetitive
        good_hits++;
        add_to_hits_per_ref(hpr[q.is_reverse ? 1 : 0], q.start, q.end, ix, (u64)pos);
    }
    rr.nonrep_frac = total_hits > 0 ? (float)good_hits / (float)total_hits : 1.0f;
    for (int rc = 0; rc < 2; ++rc)
        merge_hits(hpr[rc], ix.k, true, rc != 0, rr.nams);
}

#ifndef PF_L1
#define PF_L1 16
#define PF_L2 8
#endif
static void find_nams_one(const IndexView& ix,
                          const std::vector<QueryRandstrobe>& qrs,
                          ReadResult& rr, NamScratch& scratch) {
    const i64 nq = (i64)qrs.size();
    // Phase 1: all index lookups with two-stage software prefetch (the
    // bucket-table load and the hash-array probe each miss DRAM on
    // multi-GB indexes); lookup results are order-free, so the memory
    // pipeline stays full. As each hit lands, prefetch the lines phase 2
    // will touch (repetitive-filter probe, position/packed records).
    scratch.found.resize(nq);
    for (i64 qi = 0; qi < nq; ++qi) {
        if (qi + PF_L1 < nq) {
            u64 top = qrs[qi + PF_L1].hash >> (64 - ix.bits);
            __builtin_prefetch(&ix.buckets[top]);
        }
        if (qi + PF_L2 < nq) {
            u64 top = qrs[qi + PF_L2].hash >> (64 - ix.bits);
            __builtin_prefetch(&ix.hashes[ix.buckets[top]]);
        }
        i64 pos = ix_find(ix, qrs[qi].hash);
        scratch.found[qi] = pos;
        if (pos >= 0) {
            __builtin_prefetch(&ix.hashes[pos + ix.filter_cutoff]);
            __builtin_prefetch(&ix.positions[pos]);
            __builtin_prefetch(&ix.packed[pos]);
        }
    }
    find_nams_phase2(ix, qrs, scratch.found, rr, scratch);
}

static void find_nams_rescue_one(const IndexView& ix,
                                 const std::vector<QueryRandstrobe>& qrs,
                                 u32 rescue_cutoff, ReadResult& rr,
                                 NamScratch& scratch) {
    rr.nams.clear();
    HitsPerRef* hpr = scratch.hpr;
    hpr[0].clear();
    hpr[1].clear();
    std::vector<RescueHit>& hits_fw = scratch.hits_fw;
    std::vector<RescueHit>& hits_rc = scratch.hits_rc;
    hits_fw.clear();
    hits_rc.clear();
    const i64 nq = (i64)qrs.size();
    for (i64 qi = 0; qi < nq; ++qi) {
        if (qi + 8 < nq)
            __builtin_prefetch(&ix.buckets[qrs[qi + 8].hash >> (64 - ix.bits)]);
        if (qi + 4 < nq)
            __builtin_prefetch(
                &ix.hashes[ix.buckets[qrs[qi + 4].hash >> (64 - ix.bits)]]);
        const auto& q = qrs[qi];
        i64 pos = ix_find(ix, q.hash);
        if (pos >= 0) {
            u32 count = (u32)ix_count(ix, (u64)pos);
            RescueHit rh{(u64)pos, count, q.start, q.end};
            (q.is_reverse ? hits_rc : hits_fw).push_back(rh);
        }
    }
    auto cmp1 = [](const RescueHit& a, const RescueHit& b) {
        if (a.count != b.count) return a.count < b.count;
        if (a.query_start != b.query_start) return a.query_start < b.query_start;
        return a.query_end < b.query_end;
    };
    std::sort(hits_fw.begin(), hits_fw.end(), cmp1);
    std::sort(hits_rc.begin(), hits_rc.end(), cmp1);
    std::vector<RescueHit>* rhs = scratch.rhs;
    rhs[0].clear();
    rhs[1].clear();
    int is_rc_i = 0;
    for (auto* rescue_hits : {&hits_fw, &hits_rc}) {
        int cnt = 0;
        for (auto& rh : *rescue_hits) {
            if ((rh.count > rescue_cutoff && cnt >= 5) || rh.count > 1000) break;
            rhs[is_rc_i].push_back(rh);
            pre_create_keys(hpr[is_rc_i], rh.query_start, rh.query_end, ix, rh.position);
            cnt++;
        }
        is_rc_i++;
    }
    for (int i = 0; i < 2; ++i) {
        std::sort(rhs[i].begin(), rhs[i].end(),
                  [](const RescueHit& a, const RescueHit& b) {
                      return a.query_start < b.query_start;
                  });
        for (auto& rh : rhs[i])
            add_to_hits_per_ref(hpr[i], rh.query_start, rh.query_end, ix, rh.position);
    }
    for (int rc = 0; rc < 2; ++rc)
        merge_hits_fast(hpr[rc], ix.k, false, rc != 0, rr.nams);
    rr.used_rescue = 1;
}

}  // namespace

extern "C" {

// Returns an opaque handle; call seednam_sizes / seednam_copy / seednam_free.
void* seednam_chunk(
    const u64* hashes, const u32* positions, const u32* packed,
    const u64* buckets, u64 n_index, int bits, u32 filter_cutoff,
    const u8* seqs, const i64* offsets, i64 n_reads,
    int k, int s, int t, int wmin, int wmax, u64 qmask, int max_dist,
    u32 rescue_cutoff, int rescue_level) {
    IndexView ix{hashes, positions, packed, buckets, n_index, bits, filter_cutoff, k};
    auto* result = new ChunkResult();
    result->reads.resize(n_reads);

    std::vector<Syncmer> sync, sync_rc;
    std::vector<QueryRandstrobe> qrs;
    NamScratch nsc;
    for (i64 r = 0; r < n_reads; ++r) {
        const u8* seq = seqs + offsets[r];
        i64 len = offsets[r + 1] - offsets[r];
        ReadResult& rr = result->reads[r];
        qrs.clear();
        if (len >= wmax) {
            syncmers_of(seq, len, k, s, t, sync);
            if (!sync.empty()) {
                i64 nsy = (i64)sync.size();
                pad_syncmers(sync);
                link_query_both(sync.data(), nsy, len, wmin, wmax, qmask,
                                max_dist, k, sync_rc, qrs);
            }
        }
        find_nams_one(ix, qrs, rr, nsc);
        // the reference's gate promotes the f32 fraction to double and
        // compares to the double literal 0.7 (aln.cpp:2395) - observable
        // exactly when the ratio rounds to f32(0.7) = 0.699999988 < 0.7
        if (rescue_level > 1 && (rr.nams.empty() || (double)rr.nonrep_frac < 0.7)) {
            find_nams_rescue_one(ix, qrs, rescue_cutoff, rr, nsc);
        }
    }

    // flatten
    result->nam_offsets.resize(n_reads + 1);
    i64 total = 0;
    for (i64 r = 0; r < n_reads; ++r) {
        result->nam_offsets[r] = total;
        total += (i64)result->reads[r].nams.size();
    }
    result->nam_offsets[n_reads] = total;
    result->flat_int.resize(total * 10);
    result->flat_score.resize(total);
    i64 w = 0;
    for (i64 r = 0; r < n_reads; ++r) {
        for (const Nam& nm : result->reads[r].nams) {
            int* p = &result->flat_int[w * 10];
            p[0] = nm.nam_id;
            p[1] = nm.query_start;
            p[2] = nm.query_end;
            p[3] = nm.query_prev;
            p[4] = nm.ref_start;
            p[5] = nm.ref_end;
            p[6] = nm.ref_prev;
            p[7] = nm.n_hits;
            p[8] = nm.ref_id;
            p[9] = nm.is_rc;
            result->flat_score[w] = nm.score;
            w++;
        }
    }
    return result;
}

i64 seednam_total_nams(void* handle) {
    return ((ChunkResult*)handle)->nam_offsets.back();
}

void seednam_copy(void* handle, i64* nam_offsets, int* flat_int,
                  float* flat_score, float* nonrep, int* used_rescue) {
    auto* res = (ChunkResult*)handle;
    std::memcpy(nam_offsets, res->nam_offsets.data(),
                res->nam_offsets.size() * sizeof(i64));
    if (!res->flat_int.empty())
        std::memcpy(flat_int, res->flat_int.data(), res->flat_int.size() * sizeof(int));
    if (!res->flat_score.empty())
        std::memcpy(flat_score, res->flat_score.data(),
                    res->flat_score.size() * sizeof(float));
    for (size_t r = 0; r < res->reads.size(); ++r) {
        nonrep[r] = res->reads[r].nonrep_frac;
        used_rescue[r] = res->reads[r].used_rescue;
    }
}

void seednam_free(void* handle) { delete (ChunkResult*)handle; }

}  // extern "C"

// ---------------------------------------------------------------------
// Hamming fast path: distance gate + highest-scoring-segment alignment in
// one call (semantics of align/hamming.py, i.e. reference
// src/aligner.cpp:219-302 + the <5% gate of src/aln.cpp:453-466).

extern "C" {

// Returns 1 when the Hamming path applies (distance gate passed) and
// fills outputs; returns 0 when the caller must do a gapped alignment.
// cigar_out receives packed (len<<4|op) u32 ops; *cigar_len their count.
// out_vals: [score, segment_start, segment_end, edits]
int hamming_try(const u8* query, const u8* ref, i64 n,
                int match, int mismatch, int end_bonus,
                int* out_vals, u32* cigar_out, i64 cigar_cap, i64* cigar_len) {
    // distance gate (char comparison, like hamming_distance)
    i64 dist = 0;
    for (i64 i = 0; i < n; ++i) dist += (query[i] != ref[i]);
    if (!(n > 0 && (double)dist / (double)n < 0.05)) return 0;

    // highest-scoring segment (reference src/aligner.cpp:219-252)
    i64 start = 0;
    i64 score = end_bonus;
    i64 best_start = 0, best_end = 0, best_score = 0;
    for (i64 i = 0; i < n; ++i) {
        score += (query[i] == ref[i]) ? match : -mismatch;
        if (score < 0) {
            start = i + 1;
            score = 0;
        }
        if (score > best_score) {
            best_start = start;
            best_score = score;
            best_end = i + 1;
        }
    }
    if (score + end_bonus > best_score) {
        best_score = score + end_bonus;
        best_end = n;
        best_start = start;
    }

    // cigar: S? (=|X)* S?  (reference src/aligner.cpp:254-302)
    i64 cl = 0;
    auto push = [&](u32 op, i64 len) {
        if (cl > 0 && (cigar_out[cl - 1] & 0xF) == op)
            cigar_out[cl - 1] += (u32)(len << 4);
        else if (cl < cigar_cap)
            cigar_out[cl++] = (u32)((len << 4) | op);
    };
    if (best_start > 0) push(4, best_start);  // S
    i64 edits = 0;
    i64 i = best_start;
    while (i < best_end) {
        bool m = query[i] == ref[i];
        i64 j = i;
        while (j < best_end && (query[j] == ref[j]) == m) j++;
        push(m ? 7 : 8, j - i);  // '=' or 'X'
        if (!m) edits += j - i;
        i = j;
    }
    if (n - best_end > 0) push(4, n - best_end);
    out_vals[0] = (int)best_score;
    out_vals[1] = (int)best_start;
    out_vals[2] = (int)best_end;
    out_vals[3] = (int)edits;
    *cigar_len = cl;
    return 1;
}

}  // extern "C"

// ---------------------------------------------------------------------
// Introsort-order permutation helpers. The reference sorts NAMs, hits
// and alignment candidates with (unstable) std::sort; with ties the
// resulting order is an artifact of libstdc++'s introsort that the
// mapping tie-breaks then consume. A std::sort over an index array with
// a key-based comparator performs the exact same comparison/swap
// sequence, so these yield the reference's permutation for the Python
// layer (the C++ engine simply uses std::sort directly).

extern "C" {

void sort_perm_u64_asc(const u64* keys, i64 n, int32_t* perm) {
    for (i64 i = 0; i < n; ++i) perm[i] = (int32_t)i;
    std::sort(perm, perm + n,
              [keys](int32_t a, int32_t b) { return keys[a] < keys[b]; });
}

void sort_perm_f64_desc(const double* keys, i64 n, int32_t* perm) {
    for (i64 i = 0; i < n; ++i) perm[i] = (int32_t)i;
    std::sort(perm, perm + n,
              [keys](int32_t a, int32_t b) { return keys[a] > keys[b]; });
}

}  // extern "C"

// ---------------------------------------------------------------------
// robin_hood iteration-order simulation. The reference groups hits per
// reference id in robin_hood::unordered_map and iterates in SLOT order
// (hash-bucket order after robin-hood displacement), which decides NAM
// emission order across contigs — observable output under score ties.
// This simulates the exact slot assignment of the vendored map
// (flat map, MaxLoadFactor100=80, InitialNumElements=8, murmur-mixed
// integer hash, info-byte displacement, growth/rehash/multiplier
// sequence) for a given key first-touch order and yields the iteration
// permutation.


extern "C" {

// keys: unique u32 keys in first-touch order; perm: iteration order as
// indices into the input
void robinhood_iteration_order(const u32* keys, i64 n, i64 reserve,
                               int32_t* perm) {
    rh::Sim sim;
    if (reserve > 0) sim.reserve((u64)reserve);
    for (i64 i = 0; i < n; ++i) sim.touch(keys[i], (int)i);
    i64 w = 0;
    u64 buf = sim.mask ? sim.buffer_elems(sim.mask + 1) : 0;
    for (u64 i = 0; i < buf && w < n; ++i)
        if (sim.info[i] != 0) perm[w++] = sim.orig[i];
    // defensive: keys beyond the simulated range keep insertion order
    for (i64 i = w; i < n; ++i) perm[i] = (int32_t)i;
}

}  // extern "C"
