// The sweep-line merge of ordered hit streams into NAMs, for Hopper
// (sm_90a).
//
// Replaces rabbitsalign_tpu/ops/chain_device.py:merge_hits_device (:52),
// an XLA op in the JAX package (a lax.scan over one read's hits, no
// pallas_call), which is the reference's merge_hits_into_nams (reference
// src/nam.cpp:370-536). Its plain PyTorch version is
// rabbitsalign_tpu_torch/ops/chain_device.py `merge_hits_plain`, whose
// outputs this kernel equals exactly, at any cap >= 1.
//
// Input: S streams of hits concatenated (hits (N, 4) i32 [qs, qe, rs,
// re], seg (N,) u8 marking the first hit of a group, offsets (S + 1,)
// i64). Per hit, over the stream's table of open NAMs (in insertion
// order): the first open NAM whose window (qp, qe] x (rp, re] holds the
// hit's starts and whose ends the hit passes on both axes or on neither
// takes the hit (extended in the first case; its prev starts and n_hits
// updated either way); else the hit opens a NAM at the end of the table,
// or, `cap` NAMs open, the stream overflows and stops. A group's first
// hit emits every open NAM and resets the sweep; a hit whose query start
// passed prev_q + k emits the NAMs that end before it and sets prev_q.
// The stream's end emits what is open. Output: each stream's emissions
// in order, rows [step, slot, qs, qe, rs, re, n_hits] from the stream's
// hit offset (slot: the NAM's rank in the table), zeros from its count to
// its end and outside every stream; counts (S,) i32 and overflow (S,) u8
// (a torch.bool). Emissions made before an overflow stay, the count holds
// them. A stream never holds more NAMs open than it has hits, so its
// table needs c = min(cap, H) slots.
//
// What bounds it: each stream is a serial chain of dependent hits (16
// bytes and a dozen operations a hit), so the kernel's time is its
// slowest warp's chain, not bytes or operations. The design:
//
// * A lane a stream. Block w, one warp, takes streams [32w, 32w + 32);
//   each lane merges its own stream alone, with no shuffle or ballot, its
//   hits loaded kAhead at a time (one 16-byte load each, the next kAhead
//   in flight). Its table keeps the NAMs in insertion order with a live
//   mask: a sweep only clears bits (a NAM's slot is the popcount of the
//   live slots below it), and the live slots are packed down only when a
//   NAM must open past the last slot. The table is kLaneSlots = 32 slots
//   in shared memory, field by field with a lane's words in its own bank,
//   read and written by slot index. (An 8-slot table in registers, indexed
//   by unrolled loops, ran slower on the card: PERF.md §6.)
// * A warp for a stream that holds more NAMs open at once than its lane's
//   table: a lane that finds its table full and a hit that opens one more
//   NAM, below the cap, hands the stream to the warp, which merges it
//   again from its first hit (the rows the lane wrote are rewritten with
//   the same values). The warp takes its streams one after another: a
//   slot a lane in 2 or 4 slot groups by the stream's own min(cap, H)
//   (qs, qe, rs, re, qp, rp, n_hits in registers), the hits loaded 32 at
//   a time and broadcast by shuffle, a ballot finding the first match,
//   flushes writing at a popcount prefix and the survivors compacted by
//   shuffle. Above 128 slots the table lives in the caller's scratch,
//   rows [h0, h0 + min(cap, H)) of an (N, 7) i32 buffer, a slot group at a
//   time.
// * One launch: the warp first writes zeros over its streams' rows (block
//   0 also over the rows outside every stream), coalesced, then the
//   emissions over them; it writes the counts and the flags, so the
//   caller allocates and launches nothing else.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kFields = 7;
constexpr int kDone = 0, kOverflow = 1, kToWarp = 2;  // how a lane's merge ended

struct Hit {
    int qs, qe, rs, re, seg;
};

__device__ __forceinline__ Hit load_hit(const int32_t* hits, const uint8_t* seg, long long i,
                                        bool vec) {
    Hit x;
    if (vec) {  // the 16-byte row in one load
        const int4 v = __ldg(reinterpret_cast<const int4*>(hits) + i);
        x.qs = v.x;
        x.qe = v.y;
        x.rs = v.z;
        x.re = v.w;
    } else {
        const int32_t* p = hits + i * 4;
        x.qs = p[0];
        x.qe = p[1];
        x.rs = p[2];
        x.re = p[3];
    }
    x.seg = seg[i];
    return x;
}

__device__ __forceinline__ void write_row(int32_t* o, int step, int slot, int qs, int qe, int rs,
                                          int re, int nh) {
    o[0] = step;
    o[1] = slot;
    o[2] = qs;
    o[3] = qe;
    o[4] = rs;
    o[5] = re;
    o[6] = nh;
}

// a hit joins an open NAM: inside its window, past both its ends or neither
__device__ __forceinline__ bool joins(const Hit& x, int qe, int re, int qp, int rp) {
    return qp < x.qs && x.qs <= qe && rp < x.rs && x.rs <= re && (x.qe > qe) == (x.re > re);
}

// ---- a lane a stream -------------------------------------------------------

constexpr int kLaneSlots = 32;  // a lane's table; a warp has 32 x 7 x 32 ints of them

// a lane's table: field f of slot j at tab[(j * kFields + f) * 32], tab
// offset by the lane, so that every lane reads and writes its own bank
// whatever slot it is at; the loops run over the live slots only. hit()
// merges one hit and returns kDone, kOverflow or kToWarp (kLaneSlots NAMs
// open and one more to open); emit(mask, step) writes the rows of the
// live slots in mask.
struct LaneTable {
    int* tab;
    unsigned live;
    int top, prev_q, n_out, k, cap;
    int32_t* rows;

    __device__ __forceinline__ LaneTable(int* tab_, int k_, int cap_, int32_t* rows_)
        : tab(tab_), live(0), top(0), prev_q(0), n_out(0), k(k_), cap(cap_), rows(rows_) {}

    __device__ __forceinline__ int* slot(int j) const { return tab + j * kFields * 32; }

    __device__ __forceinline__ void emit(unsigned mask, int step) {
        int32_t* o = rows + (long long)n_out * kFields;
        for (unsigned m = mask; m; m &= m - 1, o += kFields) {
            const int j = __ffs((int)m) - 1;
            const int* f = slot(j);
            write_row(o, step, __popc(live & ((1u << j) - 1u)), f[0], f[32], f[64], f[96],
                      f[192]);
        }
        n_out += __popc(mask);
    }

    __device__ __forceinline__ int hit(const Hit& x, int step) {
        if (x.seg) {  // a new group: emit everything, reset the sweep
            emit(live, step);
            live = 0;
            top = 0;
            prev_q = 0;
        }
        int at = -1;  // the first open NAM that takes the hit
        bool grow = false;
        for (unsigned m = live; m; m &= m - 1) {
            const int j = __ffs((int)m) - 1;
            const int* f = slot(j);
            const int qe = f[32], re = f[96];
            if (joins(x, qe, re, f[128], f[160])) {
                at = j;
                grow = x.qe > qe;
                break;
            }
        }
        int* f;
        if (at < 0) {
            const int n_open = __popc(live);
            if (n_open >= cap) return kOverflow;
            if (top == kLaneSlots) {  // no slot left above the live ones: pack them down
                if (n_open == kLaneSlots) return kToWarp;
                int d = 0;
                for (unsigned m = live; m; m &= m - 1, ++d) {
                    const int* from = slot(__ffs((int)m) - 1);
                    int* to = slot(d);
#pragma unroll
                    for (int i = 0; i < kFields; ++i) to[i * 32] = from[i * 32];
                }
                top = n_open;
                live = (1u << n_open) - 1u;
            }
            at = top++;
            live |= 1u << at;
            f = slot(at);
            f[0] = x.qs;
            f[32] = x.qe;
            f[64] = x.rs;
            f[96] = x.re;
            f[192] = 1;
        } else {
            f = slot(at);
            if (grow) {
                f[32] = x.qe;
                f[96] = x.re;
            }
            f[192] += 1;
        }
        f[128] = x.qs;
        f[160] = x.rs;
        if (x.qs > prev_q + k) {  // the sweep, once the query start advanced past k
            unsigned gone = 0;
            for (unsigned m = live; m; m &= m - 1) {
                const int j = __ffs((int)m) - 1;
                if (slot(j)[32] < x.qs) gone |= 1u << j;
            }
            if (gone) {
                emit(gone, step);
                live &= ~gone;
                top = 32 - __clz((int)live);
            }
            prev_q = x.qs;
        }
        return kDone;
    }
};

constexpr int kAhead = 4;  // the hits a lane has in flight

// one stream merged by this lane alone, its hits loaded kAhead at a time
// (the next kAhead in flight while these are merged). Returns kDone (the
// end flush written), kOverflow or kToWarp; m.n_out holds the emissions.
__device__ __forceinline__ int lane_merge(LaneTable& m, const int32_t* hits, const uint8_t* seg,
                                          long long h0, long long H, bool vec) {
    Hit next[kAhead] = {};
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
        if (u < H) next[u] = load_hit(hits, seg, h0 + u, vec);
    for (long long h = 0; h < H; h += kAhead) {
        Hit cur[kAhead];
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
            cur[u] = next[u];
            if (h + kAhead + u < H) next[u] = load_hit(hits, seg, h0 + h + kAhead + u, vec);
        }
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
            if (h + u >= H) break;
            const int how = m.hit(cur[u], (int)(h + u));
            if (how != kDone) return how;
        }
    }
    m.emit(m.live, (int)H);  // the end of the stream: emit what is open
    return kDone;
}

// ---- a warp a stream, its table in registers -------------------------------

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
            write_row(out + (long long)(n_out + before + __popc(mask[g] & ((1u << lane) - 1)))
                                * kFields,
                      step, g * 32 + lane, t.qs[g], t.qe[g], t.rs[g], t.re[g], t.nh[g]);
        }
        before += __popc(mask[g]);
    }
    return before;
}

// move the slots in `keep` (one ballot a slot group) to slots 0, 1, ...
// in their order, a slot group at a time: slot group j takes its slots
// from groups j and above, which are still as they were
template <int SLOTS>
__device__ __forceinline__ void compact(Table<SLOTS>& t, const unsigned (&keep)[SLOTS],
                                        int lane) {
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
        const int d = j * 32 + lane;
        int src_g = -1, src_b = lane, acc = 0;
#pragma unroll
        for (int g = 0; g < SLOTS; ++g) {
            const int c = __popc(keep[g]);
            if (d >= acc && d < acc + c) {
                src_g = g;
                src_b = nth_set(keep[g], d - acc);
            }
            acc += c;
        }
        int qs = t.qs[j], qe = t.qe[j], rs = t.rs[j], re = t.re[j], qp = t.qp[j], rp = t.rp[j],
            nh = t.nh[j];
#pragma unroll
        for (int g = j; g < SLOTS; ++g) {
            const int x_qs = __shfl_sync(kFull, t.qs[g], src_b);
            const int x_qe = __shfl_sync(kFull, t.qe[g], src_b);
            const int x_rs = __shfl_sync(kFull, t.rs[g], src_b);
            const int x_re = __shfl_sync(kFull, t.re[g], src_b);
            const int x_qp = __shfl_sync(kFull, t.qp[g], src_b);
            const int x_rp = __shfl_sync(kFull, t.rp[g], src_b);
            const int x_nh = __shfl_sync(kFull, t.nh[g], src_b);
            if (src_g == g) {
                qs = x_qs;
                qe = x_qe;
                rs = x_rs;
                re = x_re;
                qp = x_qp;
                rp = x_rp;
                nh = x_nh;
            }
        }
        t.qs[j] = qs;
        t.qe[j] = qe;
        t.rs[j] = rs;
        t.re[j] = re;
        t.qp[j] = qp;
        t.rp[j] = rp;
        t.nh[j] = nh;
    }
}

// this lane's hit of the round of 32 that starts at hit h, broadcast
__device__ __forceinline__ Hit round_hit(const int32_t* hits, const uint8_t* seg, long long h0,
                                         long long H, long long h, bool vec, int lane,
                                         Hit& mine) {
    const int r = (int)(h & 31);
    if (r == 0 && h + lane < H) mine = load_hit(hits, seg, h0 + h + lane, vec);
    Hit x;
    x.qs = __shfl_sync(kFull, mine.qs, r);
    x.qe = __shfl_sync(kFull, mine.qe, r);
    x.rs = __shfl_sync(kFull, mine.rs, r);
    x.re = __shfl_sync(kFull, mine.re, r);
    x.seg = __shfl_sync(kFull, mine.seg, r);
    return x;
}

// one stream merged by the whole warp, SLOTS x 32 >= min(cap, H) slots
template <int SLOTS>
__device__ __forceinline__ void warp_merge(const int32_t* hits, const uint8_t* seg, long long h0, long long H,
                           int k, int cap, bool vec, int lane, int32_t* rows, int& n_out_ret,
                           bool& ovf_ret) {
    Table<SLOTS> t;
#pragma unroll
    for (int g = 0; g < SLOTS; ++g)
        t.qs[g] = t.qe[g] = t.rs[g] = t.re[g] = t.qp[g] = t.rp[g] = t.nh[g] = 0;
    int n_open = 0, prev_q = 0, n_out = 0;
    bool ovf = false;
    Hit mine{0, 0, 0, 0, 0};
    for (long long h = 0; h < H; ++h) {
        const Hit x = round_hit(hits, seg, h0, H, h, vec, lane, mine);
        unsigned m[SLOTS];
        if (x.seg) {  // a new group: emit everything, reset the sweep
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
            const bool b = g * 32 + lane < n_open && joins(x, t.qe[g], t.re[g], t.qp[g], t.rp[g]);
            const unsigned bal = __ballot_sync(kFull, b);
            if (first < 0 && bal) first = g * 32 + __ffs((int)bal) - 1;
        }
        if (first >= 0) {
#pragma unroll
            for (int g = 0; g < SLOTS; ++g) {
                if (g * 32 + lane == first) {
                    if (x.qe > t.qe[g] && x.re > t.re[g]) {
                        t.qe[g] = x.qe;
                        t.re[g] = x.re;
                    }
                    t.qp[g] = x.qs;
                    t.rp[g] = x.rs;
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
                    t.qs[g] = t.qp[g] = x.qs;
                    t.qe[g] = x.qe;
                    t.rs[g] = t.rp[g] = x.rs;
                    t.re[g] = x.re;
                    t.nh[g] = 1;
                }
            }
            ++n_open;
        }
        if (x.qs > prev_q + k) {  // the sweep, once the query start advanced past k
            unsigned keep[SLOTS];
            int n_keep = 0, n_gone = 0;
#pragma unroll
            for (int g = 0; g < SLOTS; ++g) {
                const bool live = g * 32 + lane < n_open;
                m[g] = __ballot_sync(kFull, live && t.qe[g] < x.qs);
                keep[g] = __ballot_sync(kFull, live && !(t.qe[g] < x.qs));
                n_keep += __popc(keep[g]);
                n_gone += __popc(m[g]);
            }
            if (n_gone) {
                n_out += emit(t, m, (int)h, lane, n_out, rows);
                compact(t, keep, lane);
                n_open = n_keep;
            }
            prev_q = x.qs;
        }
    }
    if (!ovf) {  // the end of the stream: emit what is open
        unsigned m[SLOTS];
#pragma unroll
        for (int g = 0; g < SLOTS; ++g) m[g] = __ballot_sync(kFull, g * 32 + lane < n_open);
        n_out += emit(t, m, (int)H, lane, n_out, rows);
    }
    n_out_ret = n_out;
    ovf_ret = ovf;
}

// ---- a warp a stream, its table in scratch memory (more than 128 slots) ----

// emit the table's slots [0, n) at rows[n_out ..] (a slot a lane a round)
__device__ __forceinline__ void mem_emit_all(const int32_t* tab, int n, int step, int lane,
                                             int n_out, int32_t* rows) {
    for (int j = lane; j < n; j += 32) {
        const int32_t* f = tab + (long long)j * kFields;
        write_row(rows + (long long)(n_out + j) * kFields, step, j, f[0], f[1], f[2], f[3],
                  f[6]);
    }
}

// one stream merged by the whole warp, its table at tab: slot j's [qs, qe,
// rs, re, qp, rp, n_hits] at tab[7j ..], min(cap, H) slots
__device__ __forceinline__ void warp_merge_mem(const int32_t* hits, const uint8_t* seg, long long h0, long long H,
                               int k, int cap, bool vec, int lane, int32_t* rows, int32_t* tab,
                               int& n_out_ret, bool& ovf_ret) {
    const unsigned lt = (1u << lane) - 1u;
    int n_open = 0, prev_q = 0, n_out = 0;
    bool ovf = false;
    Hit mine{0, 0, 0, 0, 0};
    for (long long h = 0; h < H; ++h) {
        const Hit x = round_hit(hits, seg, h0, H, h, vec, lane, mine);
        if (x.seg) {  // a new group: emit everything, reset the sweep
            mem_emit_all(tab, n_open, (int)h, lane, n_out, rows);
            n_out += n_open;
            n_open = 0;
            prev_q = 0;
        }
        int first = -1;  // the lowest matching slot, a slot group at a time
        bool grow = false;
        for (int b = 0; b < n_open && first < 0; b += 32) {
            const int j = b + lane;
            bool m = false, a = false;
            if (j < n_open) {
                const int32_t* f = tab + (long long)j * kFields;
                m = joins(x, f[1], f[3], f[4], f[5]);
                a = x.qe > f[1];
            }
            const unsigned bal = __ballot_sync(kFull, m);
            if (bal) {
                const int src = __ffs((int)bal) - 1;
                first = b + src;
                grow = __shfl_sync(kFull, (int)a, src);
            }
        }
        const bool open = first < 0;
        if (open) {
            if (n_open >= cap) {
                ovf = true;
                break;  // uniform
            }
            first = n_open++;
        }
        if (lane == 0) {
            int32_t* f = tab + (long long)first * kFields;
            if (open) {
                f[0] = x.qs;
                f[2] = x.rs;
                f[6] = 0;
            }
            if (open || grow) {
                f[1] = x.qe;
                f[3] = x.re;
            }
            f[4] = x.qs;
            f[5] = x.rs;
            f[6] += 1;
        }
        __syncwarp();
        if (x.qs > prev_q + k) {  // the sweep: emit and compact a slot group at a time
            int kept = 0, gone = 0;
            for (int b = 0; b < n_open; b += 32) {
                const int j = b + lane;
                const bool live = j < n_open;
                int f[kFields] = {0, 0, 0, 0, 0, 0, 0};
                if (live) {
#pragma unroll
                    for (int i = 0; i < kFields; ++i) f[i] = tab[(long long)j * kFields + i];
                }
                const bool g = live && f[1] < x.qs;
                const unsigned gb = __ballot_sync(kFull, g);
                const unsigned kb = __ballot_sync(kFull, live && !g);
                // every lane has read its slot; a survivor moves down, to a
                // slot of this group or an earlier one, both read already
                __syncwarp();
                if (g)
                    write_row(rows + (long long)(n_out + gone + __popc(gb & lt)) * kFields,
                              (int)h, j, f[0], f[1], f[2], f[3], f[6]);
                if (live && !g) {
                    int32_t* d = tab + (long long)(kept + __popc(kb & lt)) * kFields;
#pragma unroll
                    for (int i = 0; i < kFields; ++i) d[i] = f[i];
                }
                kept += __popc(kb);
                gone += __popc(gb);
                __syncwarp();
            }
            n_out += gone;
            n_open = kept;
            prev_q = x.qs;
        }
    }
    if (!ovf) {
        mem_emit_all(tab, n_open, (int)H, lane, n_out, rows);
        n_out += n_open;
    }
    n_out_ret = n_out;
    ovf_ret = ovf;
}

// ---- the kernel --------------------------------------------------------------

__global__ void __launch_bounds__(32) merge_hits_kernel(
    const int32_t* __restrict__ hits, const uint8_t* __restrict__ seg,
    const long long* __restrict__ offsets, long long S, long long N, int k, int cap,
    int32_t* __restrict__ out, int32_t* __restrict__ counts, uint8_t* __restrict__ overflow,
    int32_t* scratch) {
    __shared__ int lane_tabs[kLaneSlots * kFields * 32];
    const int lane = threadIdx.x;
    const long long s = (long long)blockIdx.x * 32 + lane;  // a block a warp
    const bool vec = (reinterpret_cast<uintptr_t>(hits) & 15) == 0;
    long long h0 = 0, H = 0;
    if (s < S) {
        h0 = offsets[s];
        H = offsets[s + 1] - h0;
    }
    // zeros over the warp's rows (and, in block 0, the rows outside every
    // stream), coalesced, before any emission: a row past its stream's
    // count is never written again
    const long long in_block = S - (s - lane);  // this warp's streams, if under 32
    const long long first = __shfl_sync(kFull, h0, 0);
    const long long end = __shfl_sync(kFull, h0 + H, in_block >= 32 ? 31 : in_block > 0 ? (int)in_block - 1 : 0);
    for (long long i = first * kFields + lane; i < end * kFields; i += 32) out[i] = 0;
    if (blockIdx.x == 0) {
        const long long lo = offsets[0], hi = offsets[S];
        for (long long i = lane; i < lo * kFields; i += 32) out[i] = 0;
        for (long long i = hi * kFields + lane; i < N * kFields; i += 32) out[i] = 0;
    }
    __syncwarp();
    int n_out = 0;
    bool ovf = false, on_warp = false;
    if (s < S) {
        LaneTable m(lane_tabs + lane, k, cap, out + h0 * kFields);
        const int how = lane_merge(m, hits, seg, h0, H, vec);
        n_out = m.n_out;
        on_warp = how == kToWarp;
        ovf = how == kOverflow;
    }
    __syncwarp();
    // the streams that hold more than kLaneSlots NAMs open, so need more
    // than 32 slots: the whole warp on each in turn
    for (unsigned todo = __ballot_sync(kFull, on_warp); todo; todo &= todo - 1) {
        const int j = __ffs((int)todo) - 1;
        const long long hj = __shfl_sync(kFull, h0, j);
        const long long Hj = __shfl_sync(kFull, H, j);
        const long long cj = Hj < cap ? Hj : cap;
        int32_t* rows = out + hj * kFields;
        int no = 0;
        bool ov = false;
        if (cj <= 64)
            warp_merge<2>(hits, seg, hj, Hj, k, cap, vec, lane, rows, no, ov);
        else if (cj <= 128)
            warp_merge<4>(hits, seg, hj, Hj, k, cap, vec, lane, rows, no, ov);
        else
            warp_merge_mem(hits, seg, hj, Hj, k, cap, vec, lane, rows, scratch + hj * kFields, no,
                           ov);
        if (lane == j) {
            n_out = no;
            ovf = ov;
        }
    }
    if (s < S) {
        counts[s] = n_out;
        overflow[s] = ovf;
    }
}

}  // namespace

// hits (N, 4) i32, seg (N,) u8, offsets (S + 1,) i64 in; out (N, 7) i32,
// counts (S,) i32, overflow (S,) u8 (or bool) out, every element written;
// scratch (N, 7) i32, needed when cap > 128 (else may be null). cap >= 1.
// Returns the cudaGetLastError() after the launch, or
// cudaErrorInvalidValue.
extern "C" int merge_hits_launch(const void* hits, const void* seg, const void* offsets,
                                 long long S, long long N, int k, int cap, void* out,
                                 void* counts, void* overflow, void* scratch, void* stream) {
    if (cap < 1 || S < 0 || N < 0 || (cap > 128 && scratch == nullptr))
        return (int)cudaErrorInvalidValue;
    if (S == 0 && N == 0) return (int)cudaGetLastError();
    const long long blocks = S > 0 ? (S + 31) / 32 : 1;
    merge_hits_kernel<<<(unsigned)blocks, 32, 0, (cudaStream_t)stream>>>(
        (const int32_t*)hits, (const uint8_t*)seg, (const long long*)offsets, S, N, k, cap,
        (int32_t*)out, (int32_t*)counts, (uint8_t*)overflow, (int32_t*)scratch);
    return (int)cudaGetLastError();
}
