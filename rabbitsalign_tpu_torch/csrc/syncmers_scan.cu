// Canonical closed syncmers of a read batch, exact to the reference's
// automaton, for Hopper (sm_90a).
//
// Replaces rabbitsalign_tpu/ops/seed_device.py:syncmers_device (:58), an
// XLA op in the JAX package (a lax.scan over the bases, no pallas_call).
// Its plain PyTorch version is rabbitsalign_tpu_torch/ops/seed_device.py
// `syncmers_scan_plain`, whose outputs this kernel equals exactly.
//
// Per read (codes (B, L) u8 in {0..3, 4 = N}, lengths (B,) i32), the
// reference's SyncmerIterator (reference src/randstrobes.cpp:57-118):
// both strands' 2-bit k-mer and s-mer values rolled, reset by an N; each
// s-mer's xxh64 pushed into a min-queue of the last w = k - s + 1. A
// window whose tracked minimum sits at offset t - 1 emits its k-mer's
// position and xxh64. Outputs: positions (B, M) i32, -1 past the count;
// hashes (B, M) u64, 0 past the count; counts (B,) i32 (syncmers past
// the M-th are dropped).
//
// What makes a parallel scan exact. The min-queue's state in a window is
// (minval, minpos). minval is always the window's true minimum and minpos
// a copy of it; its history only picks the copy of a tied minimum: the
// leftmost on a run's first full window, the rightmost on the rescan
// after the tracked one slid out, the old one when a new hash only equals
// it. So (i) a window whose minimum is unique is decided in closed form
// (it emits iff the argmin sits at offset t - 1); (ii) a tied window with
// no copy at offset t - 1 never emits; (iii) a tied window with a copy
// there needs the automaton, replayed from a window whose state is known:
// the last earlier window of the same N-free run whose minimum is unique
// (state: its argmin), or the run's first full window (the leftmost).
//
// Design: a warp a read, kWarps reads a block, the read cut into segments
// of kSeg windows. In a segment each lane owns a contiguous run of at
// most kLaneWin windows and the s-mers that start there, and rolls one
// 2-bit value of k codes (both strands) along them from the code before
// its first window: it writes each s-mer's xxh64 (once a position), each
// window's canonical k-mer and whether the window is N-free and starts
// its run to shared memory. After a __syncwarp each lane decides its
// windows in order, carrying the automaton's state once it is known
// (from a run start, a unique minimum or a replay), and replaying only
// at a case-(iii) window whose state it does not know yet; the replay
// reads the windows before its range from shared memory, so no warp
// primitive is inside it. The state of a segment's last window is made
// known and passed to the next segment, where a replay that reaches back
// past the segment's start begins from it. The syncmers go to a bit mask
// a lane; a warp exclusive scan of their popcounts gives each lane its
// first rank, so they come out in position order; the k-mer's xxh64 is
// taken only for an emitted window of rank below M. The lanes then write
// the row's -1 / 0 padding, consecutive lanes on consecutive slots. Every
// warp primitive is reached by the whole warp.
//
// Bound: bytes, the codes and the (B, M) outputs (12 B a slot: 31 MB at
// B = 10 000, M = 256, ~9 us at 3.35 TB/s); the arithmetic, about 80
// int32-equivalent operations an s-mer (xxh64's 64-bit multiplies are
// several IMADs each), is below it. A replay walks a tied run once a
// lane: a homopolymer or short tandem repeat costs its run's windows
// again for each lane that meets case (iii) in it.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int kWarps = 4;
constexpr int kLaneWin = 16;          // windows a lane a segment (one bit each)
constexpr int kSeg = 32 * kLaneWin;   // windows a segment
constexpr int kMaxW = 32;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr u64 kUmax = ~0ULL;
constexpr uint8_t kClean = 1, kStart = 2;  // window flags: N-free, first of its run

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

// shared memory a warp for segments of `cap` windows: s-mer hashes (cap +
// kMaxW u64), canonical k-mers (cap u64), window flags (cap u8), rounded
// up to 16 bytes
__host__ __device__ inline size_t scan_smem(int cap) {
    return ((size_t)8 * (cap + kMaxW) + (size_t)9 * cap + 15) / 16 * 16;
}

// The automaton's state after a window: its minimum hash and position.
struct MinState {
    u64 val;
    int pos;
};

// The minimum of the w s-mer hashes at sh[0 .. w) and the offsets of its
// first and last copies.
__device__ __forceinline__ void window_min(const u64* sh, int w, u64& mn, int& left,
                                           int& right) {
    mn = sh[0];
    left = right = 0;
    for (int j = 1; j < w; ++j) {
        const u64 v = sh[j];
        if (v < mn) {
            mn = v;
            left = right = j;
        } else if (v == mn) {
            right = j;
        }
    }
}

// The automaton's state at window `pos` (N-free, of segment `base`),
// replayed from the last window before it whose state is known: the run's
// first window (the leftmost minimum), a window with a unique minimum (its
// argmin), or, past the segment's start, the carried state of window
// base - 1. One window a step: when the tracked minimum slid out, the
// rightmost minimum of the new window; else a new hash strictly below it.
__device__ MinState replay(const u64* sh, const uint8_t* flags, int base, int pos, int w,
                           MinState carry) {
    MinState st;
    int q = pos - 1;
    for (;; --q) {
        if (q < base) {
            st = carry;
            break;
        }
        u64 mn;
        int left, right;
        window_min(sh + (q - base), w, mn, left, right);
        if ((flags[q - base] & kStart) || left == right) {
            st = {mn, q + left};
            break;
        }
    }
    for (int c = q + 1; c <= pos; ++c) {
        const u64* win = sh + (c - base);
        if (st.pos == c - 1) {
            u64 mn;
            int left, right;
            window_min(win, w, mn, left, right);
            st = {mn, c + right};
        } else if (win[w - 1] < st.val) {
            st = {win[w - 1], c + w - 1};
        }
    }
    return st;
}

// The 2-bit values of a k-mer on both strands, rolled one code at a time,
// and the position of the last N pushed (an N enters as 0 and is masked
// by last_n).
struct Roller {
    u64 fwd, rev, mask;
    int shift, last_n;
    __device__ __forceinline__ Roller(int m)
        : fwd(0), rev(0), mask(m == 32 ? kUmax : (1ULL << (2 * m)) - 1), shift(2 * (m - 1)),
          last_n(-1) {}
    __device__ __forceinline__ void push(unsigned c, int j) {
        if (c >= 4) last_n = j;
        fwd = ((fwd << 2) | (c & 3)) & mask;
        rev = (rev >> 2) | ((u64)(3 - (c & 3)) << shift);
    }
};

__global__ void __launch_bounds__(kWarps * 32) syncmers_scan_kernel(
    const uint8_t* __restrict__ codes, const int32_t* __restrict__ lengths, int B, int L, int k,
    int s, int t, int M, int cap, int32_t* __restrict__ out_pos, u64* __restrict__ out_hash,
    int32_t* __restrict__ counts) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const long long b = (long long)blockIdx.x * kWarps + warp;
    if (b >= B) return;  // a whole warp
    const int w = k - s + 1;
    u64* sh = (u64*)(smem + (size_t)warp * scan_smem(cap));  // [cap + kMaxW] s-mer hashes
    u64* kh = sh + cap + kMaxW;                               // [cap] canonical k-mers
    uint8_t* flags = (uint8_t*)(kh + cap);                    // [cap] window flags
    const uint8_t* row = codes + b * L;
    int32_t* pos_row = out_pos + b * M;
    u64* hash_row = out_hash + b * M;
    const int len = lengths[b];
    const int end = len < L ? len : L;  // emission needs the k-mer inside the read
    const int nk = end - k + 1;         // windows; <= 0 for len -1 or a short read
    const u64 smask = s == 32 ? kUmax : (1ULL << (2 * s)) - 1;
    const int sshift = 2 * (k - s);

    int n = 0;  // syncmers so far (uniform)
    MinState carry = {kUmax, -1};  // the state of the window before the segment
    for (int base = 0; base < nk; base += kSeg) {
        const int seg_end = min(base + kSeg, nk);
        const int per = (seg_end - base + 31) / 32;
        const int p0 = base + lane * per, p1 = min(p0 + per, seg_end);
        // s-mers [p0, s1): the last lane with windows takes the w - 1 past them
        const int s1 = p1 == seg_end ? p1 + w - 1 : p1;
        if (p0 < p1) {
            Roller r(k);
            for (int j = p0 > 0 ? p0 - 1 : 0; j < p1 + k - 1; ++j) {
                r.push(row[j], j);
                const int i = j - s + 1;
                if (i >= p0 && i < s1) {
                    const u64 f = r.fwd & smask, v = r.rev >> sshift;
                    sh[i - base] = r.last_n < i ? xxh64(f < v ? f : v) : kUmax;
                }
                const int pos = j - k + 1;
                if (pos >= p0) {
                    kh[pos - base] = r.fwd < r.rev ? r.fwd : r.rev;
                    const bool clean = r.last_n < pos;
                    flags[pos - base] =
                        clean ? (uint8_t)(kClean | (r.last_n == pos - 1 ? kStart : 0)) : 0;
                }
            }
        }
        __syncwarp();

        // the lane's windows in order; `st` is the state after window
        // pos - 1 when `known`
        unsigned emits = 0;
        MinState st = carry;
        bool known = p0 == base && base > 0;  // the carry, when that window is N-free
        for (int pos = p0; pos < p1; ++pos) {
            const uint8_t f = flags[pos - base];
            if (!(f & kClean)) {
                known = false;
                continue;
            }
            const u64* win = sh + (pos - base);
            u64 mn;
            int left, right;
            window_min(win, w, mn, left, right);
            if ((f & kStart) || left == right) {  // a run's first window, a unique minimum
                st = {mn, pos + left};
            } else if (known) {  // tied: one step of the automaton
                st = {mn, st.pos == pos - 1 ? pos + right : st.pos};
            } else if (win[t - 1] == mn) {  // tied with a copy at t - 1: replay
                st = replay(sh, flags, base, pos, w, carry);
            } else {  // tied, no copy at t - 1: no syncmer, state still unknown
                continue;
            }
            known = true;
            emits |= (unsigned)(st.pos == pos + t - 1) << (pos - p0);
        }
        // the state of the segment's last window, for the next segment
        if (seg_end < nk) {
            const int owner = (seg_end - 1 - base) / per;
            if (lane == owner && !known && (flags[seg_end - 1 - base] & kClean))
                st = replay(sh, flags, base, seg_end - 1, w, carry);
            carry.val = __shfl_sync(kFull, st.val, owner);
            carry.pos = __shfl_sync(kFull, st.pos, owner);
        }

        // the lanes' syncmers in position order: an exclusive scan of counts
        const int mine = __popc(emits);
        int incl = mine;
        for (int o = 1; o < 32; o <<= 1) {
            const int v = __shfl_up_sync(kFull, incl, o);
            if (lane >= o) incl += v;
        }
        int rank = n + incl - mine;
        for (unsigned e = emits; e && rank < M; e &= e - 1, ++rank) {
            const int pos = p0 + __ffs((int)e) - 1;
            pos_row[rank] = pos;
            hash_row[rank] = xxh64(kh[pos - base]);
        }
        n += __shfl_sync(kFull, incl, 31);
        __syncwarp();  // the next segment overwrites the shared arrays
    }
    const int count = n < M ? n : M;
    for (int j = count + lane; j < M; j += 32) {
        pos_row[j] = -1;
        hash_row[j] = 0;
    }
    if (lane == 0) counts[b] = count;
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
    const int cap = L < kSeg ? L : kSeg;  // windows a segment holds (< L in a read)
    syncmers_scan_kernel<<<(B + kWarps - 1) / kWarps, kWarps * 32, kWarps * scan_smem(cap),
                           (cudaStream_t)stream>>>(
        (const uint8_t*)codes, (const int32_t*)lengths, B, L, k, s, t, M, cap,
        (int32_t*)out_pos, (u64*)out_hash, (int32_t*)counts);
    return (int)cudaGetLastError();
}
