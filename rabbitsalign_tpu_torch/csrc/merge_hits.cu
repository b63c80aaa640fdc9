// The sweep-line merge of ordered hit streams into NAMs, for Hopper
// (sm_90a).
//
// Replaces rabbitsalign_tpu/ops/chain_device.py:merge_hits_device (:52),
// an XLA op in the JAX package (a lax.scan over one read's hits, no
// pallas_call), which is the reference's merge_hits_into_nams (reference
// src/nam.cpp:370-536). Its plain PyTorch version is
// rabbitsalign_tpu_torch/ops/chain_device.py `merge_hits_plain`, whose
// outputs this kernel equals exactly.
//
// Input: S streams of hits concatenated (hits (N, 4) i32 [qs, qe, rs,
// re], seg (N,) u8 marking the first hit of a group, offsets (S + 1,)
// i64). Per hit, over the stream's table of open NAMs (packed in
// insertion order): the first live slot whose window (qp, qe] x (rp, re]
// holds the hit's starts and whose ends the hit passes on both axes or
// on neither takes the hit (extended in the first case; its prev starts
// and n_hits updated either way); else the hit opens a NAM at slot
// n_open, or, the table full, the stream overflows and stops. A group's
// first hit emits every open NAM and resets the sweep; a hit whose query
// start passed prev_q + k emits the NAMs that end before it, the
// survivors compacted stably, and sets prev_q. The stream's end emits
// what is open. Output: each stream's emissions in order, rows [step,
// slot, qs, qe, rs, re, n_hits] from the stream's hit offset (a stream
// emits at most as many NAMs as it has hits), counts (S,) i32 and
// overflow (S,) u8; emissions made before an overflow stay, the count
// holds them.
//
// Design: one warp a stream, one slot of the table a lane and up to four
// a lane (cap <= 128 in slot groups of 32: slot g * 32 + lane), qs, qe,
// rs, re, qp, rp and n_hits in registers. The hits come in rounds of 32,
// a lane loading one, and are broadcast by shuffle. Per hit, a ballot of
// the window and case test over the live slots finds the first match;
// flushes ballot the emitted slots, which write their rows in slot order
// at a popcount prefix, and the survivors move, by shuffle, each to the
// number of survivors below it. The stream is a serial chain of hits:
// what bounds a kernel of few thousand hits a stream is that chain's
// latency (a shuffle and ballots a hit, and the hit round's load), not
// the bytes (16 B read a hit, 28 B written a NAM) or the operations.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kFields = 7;

template <int SLOTS>
struct Table {
    int qs[SLOTS], qe[SLOTS], rs[SLOTS], re[SLOTS], qp[SLOTS], rp[SLOTS], nh[SLOTS];
};

// the position of the (n + 1)-th set bit of m, which has more than n
__device__ __forceinline__ int nth_set(unsigned m, int n) {
    for (int i = 0; i < n; ++i) m &= m - 1;
    return __ffs((int)m) - 1;
}

// write the rows of the slots in `mask` (one ballot a slot group) at
// out[n_out ..] in slot order; returns how many
template <int SLOTS>
__device__ __forceinline__ int emit(const Table<SLOTS>& t, const unsigned (&mask)[SLOTS],
                                    int step, int lane, int n_out, int32_t* out) {
    int before = 0;
#pragma unroll
    for (int g = 0; g < SLOTS; ++g) {
        if ((mask[g] >> lane) & 1u) {
            int32_t* o = out + (long long)(n_out + before + __popc(mask[g] & ((1u << lane) - 1)))
                               * kFields;
            o[0] = step;
            o[1] = g * 32 + lane;
            o[2] = t.qs[g];
            o[3] = t.qe[g];
            o[4] = t.rs[g];
            o[5] = t.re[g];
            o[6] = t.nh[g];
        }
        before += __popc(mask[g]);
    }
    return before;
}

// move the slots in `keep` (one ballot a slot group) to slots 0, 1, ...
// in their order
template <int SLOTS>
__device__ __forceinline__ void compact(Table<SLOTS>& t, const unsigned (&keep)[SLOTS],
                                        int lane) {
    int src_g[SLOTS], src_b[SLOTS];
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
        const int d = j * 32 + lane;
        src_g[j] = 0;
        src_b[j] = lane;
        int acc = 0;
#pragma unroll
        for (int g = 0; g < SLOTS; ++g) {
            const int c = __popc(keep[g]);
            if (d >= acc && d < acc + c) {
                src_g[j] = g;
                src_b[j] = nth_set(keep[g], d - acc);
            }
            acc += c;
        }
    }
    Table<SLOTS> n = t;
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
#pragma unroll
        for (int g = 0; g < SLOTS; ++g) {
            const int qs = __shfl_sync(kFull, t.qs[g], src_b[j]);
            const int qe = __shfl_sync(kFull, t.qe[g], src_b[j]);
            const int rs = __shfl_sync(kFull, t.rs[g], src_b[j]);
            const int re = __shfl_sync(kFull, t.re[g], src_b[j]);
            const int qp = __shfl_sync(kFull, t.qp[g], src_b[j]);
            const int rp = __shfl_sync(kFull, t.rp[g], src_b[j]);
            const int nh = __shfl_sync(kFull, t.nh[g], src_b[j]);
            if (src_g[j] == g) {
                n.qs[j] = qs;
                n.qe[j] = qe;
                n.rs[j] = rs;
                n.re[j] = re;
                n.qp[j] = qp;
                n.rp[j] = rp;
                n.nh[j] = nh;
            }
        }
    }
    t = n;
}

template <int SLOTS>
__global__ void __launch_bounds__(kWarps * 32) merge_hits_kernel(
    const int32_t* __restrict__ hits, const uint8_t* __restrict__ seg,
    const long long* __restrict__ offsets, long long S, int k, int cap,
    int32_t* __restrict__ out, int32_t* __restrict__ counts, uint8_t* __restrict__ overflow) {
    const int lane = threadIdx.x & 31;
    const long long s = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
    if (s >= S) return;  // a whole warp
    const long long h0 = offsets[s];
    const long long H = offsets[s + 1] - h0;
    int32_t* rows = out + h0 * kFields;
    Table<SLOTS> t;
#pragma unroll
    for (int g = 0; g < SLOTS; ++g)
        t.qs[g] = t.qe[g] = t.rs[g] = t.re[g] = t.qp[g] = t.rp[g] = t.nh[g] = 0;
    int n_open = 0, prev_q = 0, n_out = 0;
    bool ovf = false;
    int my_qs = 0, my_qe = 0, my_rs = 0, my_re = 0, my_seg = 0;  // this lane's hit of the round
    for (long long h = 0; h < H; ++h) {
        const int r = (int)(h & 31);
        if (r == 0) {
            const long long i = h + lane;
            if (i < H) {
                const int32_t* x = hits + (h0 + i) * 4;
                my_qs = x[0];
                my_qe = x[1];
                my_rs = x[2];
                my_re = x[3];
                my_seg = seg[h0 + i];
            }
        }
        const int qs = __shfl_sync(kFull, my_qs, r);
        const int qe = __shfl_sync(kFull, my_qe, r);
        const int rs = __shfl_sync(kFull, my_rs, r);
        const int re = __shfl_sync(kFull, my_re, r);
        const int sg = __shfl_sync(kFull, my_seg, r);
        unsigned m[SLOTS];
        if (sg) {  // a new group: emit everything, reset the sweep
#pragma unroll
            for (int g = 0; g < SLOTS; ++g) m[g] = __ballot_sync(kFull, g * 32 + lane < n_open);
            n_out += emit(t, m, (int)h, lane, n_out, rows);
            n_open = 0;
            prev_q = 0;
        }
        // the first open NAM that takes the hit: the lowest matching slot
        int first = -1;
#pragma unroll
        for (int g = 0; g < SLOTS; ++g) {
            const bool in_win = g * 32 + lane < n_open && t.qp[g] < qs && qs <= t.qe[g] &&
                                t.rp[g] < rs && rs <= t.re[g];
            const bool grow = qe > t.qe[g] && re > t.re[g];
            const bool inside = qe <= t.qe[g] && re <= t.re[g];
            const unsigned b = __ballot_sync(kFull, in_win && (grow || inside));
            if (first < 0 && b) first = g * 32 + __ffs((int)b) - 1;
        }
        if (first >= 0) {
#pragma unroll
            for (int g = 0; g < SLOTS; ++g) {
                if (g * 32 + lane == first) {
                    if (qe > t.qe[g] && re > t.re[g]) {
                        t.qe[g] = qe;
                        t.re[g] = re;
                    }
                    t.qp[g] = qs;
                    t.rp[g] = rs;
                    t.nh[g] += 1;
                }
            }
        } else {
            if (n_open >= cap) {
                ovf = true;
                break;  // uniform: n_open is the warp's
            }
#pragma unroll
            for (int g = 0; g < SLOTS; ++g) {
                if (g * 32 + lane == n_open) {
                    t.qs[g] = t.qp[g] = qs;
                    t.qe[g] = qe;
                    t.rs[g] = t.rp[g] = rs;
                    t.re[g] = re;
                    t.nh[g] = 1;
                }
            }
            ++n_open;
        }
        if (qs > prev_q + k) {  // the sweep, once the query start advanced past k
            unsigned keep[SLOTS];
            int n_keep = 0, n_gone = 0;
#pragma unroll
            for (int g = 0; g < SLOTS; ++g) {
                const bool live = g * 32 + lane < n_open;
                m[g] = __ballot_sync(kFull, live && t.qe[g] < qs);
                keep[g] = __ballot_sync(kFull, live && !(t.qe[g] < qs));
                n_keep += __popc(keep[g]);
                n_gone += __popc(m[g]);
            }
            if (n_gone) {
                n_out += emit(t, m, (int)h, lane, n_out, rows);
                compact(t, keep, lane);
                n_open = n_keep;
            }
            prev_q = qs;
        }
    }
    if (!ovf) {  // the end of the stream: emit what is open
        unsigned m[SLOTS];
#pragma unroll
        for (int g = 0; g < SLOTS; ++g) m[g] = __ballot_sync(kFull, g * 32 + lane < n_open);
        n_out += emit(t, m, (int)H, lane, n_out, rows);
    }
    if (lane == 0) {
        counts[s] = n_out;
        overflow[s] = ovf;
    }
}

}  // namespace

// hits (N, 4) i32, seg (N,) u8, offsets (S + 1,) i64 in; out (N, 7) i32,
// counts (S,) i32, overflow (S,) u8 out. cap in [1, 128]. Returns the
// cudaGetLastError() after the launch, or cudaErrorInvalidValue.
extern "C" int merge_hits_launch(const void* hits, const void* seg, const void* offsets,
                                 long long S, int k, int cap, void* out, void* counts,
                                 void* overflow, void* stream) {
    if (cap < 1 || cap > 128 || S < 0) return (int)cudaErrorInvalidValue;
    if (S == 0) return (int)cudaGetLastError();
    const auto kernel = cap <= 32 ? merge_hits_kernel<1>
                        : cap <= 64 ? merge_hits_kernel<2> : merge_hits_kernel<4>;
    kernel<<<(unsigned)((S + kWarps - 1) / kWarps), kWarps * 32, 0, (cudaStream_t)stream>>>(
        (const int32_t*)hits, (const uint8_t*)seg, (const long long*)offsets, S, k, cap,
        (int32_t*)out, (int32_t*)counts, (uint8_t*)overflow);
    return (int)cudaGetLastError();
}
