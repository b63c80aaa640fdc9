// Batched affine-gap local Smith-Waterman forward pass for Hopper (sm_90a).
//
// Replaces the Pallas kernel of rabbitsalign_tpu/ops/sw_pallas.py (`_kernel`,
// set up by `_sw_forward_pallas_core` at :420 and launched by its
// pallas_call at :464), together with the tie-break reduction that follows
// that call. Same recurrence, direction byte and tie-breaks. The dirs layout
// is this port's own: (B, Q, T) u8, each pair's Q x T cells contiguous and
// row-major.
//
// Design: one warp per pair, a wavefront along the target, the DP state in
// registers. The Pallas kernel sweeps anti-diagonals over (Q, B) state held
// in VMEM; here the anti-diagonal runs over the 32 lanes of one warp.
// - Lane l owns the query rows [l*R, (l+1)*R), R a template constant: the
//   smallest of 1, 2, 4, 5, 8, 16 with 32 * R >= Q (5 for the tight
//   (152, 256) bucket, 8 and 16 for the legacy ones).
// - At step s the lane computes column t = s - l of its rows, top to bottom.
//   E and H flow down the rows in registers. The row above the lane's first
//   (its H and E at column t) comes from lane l-1's bottom row of the step
//   before, by __shfl_up_sync; the value received one step earlier is the
//   diagonal. Each row's H and F of column t-1 stay in registers (2R values).
//   No DP state goes to device memory.
// - The best cell: each lane sees its cells in increasing t, then q, so a
//   strict `>` keeps the smallest t, then q, of its maximum; a warp
//   reduction with the pair's rule (max score, then min t, then min q)
//   gives the pair's result. A score-0 pair reports t_end = -1, q_end = 0.
// - Direction bytes: each lane writes its cell's byte into a shared-memory
//   ring of 64 columns per row. Every 32 steps all lanes have finished the
//   aligned block of 32 columns that started 32 steps earlier, and the warp
//   writes it to device memory in 16-byte stores, two per row, so every
//   store instruction fills whole 32-byte sectors. The pair's target codes
//   are staged in shared memory once.
//
// What bounds it on the card: integer issue. A cell is about 30
// instructions (sw_cell with Hopper's DPX max instructions, the best-cell
// update, the ring store), and Hopper's INT32 pipe takes two cycles for a
// warp instruction; the bound counts 33 operations per valid cell. The
// wavefront also issues for lanes that idle while it fills and drains (lane
// l starts l steps late), and the last lane's rows past qlen are computed
// and discarded, so a pair costs R * (tlen + lanes - 1) warp cell steps for
// qlen * tlen valid cells. At (152, 256) x 2048 mixed pairs it runs at 2.4x
// the operations bound on an H100 (PERF.md). Device memory carries only the
// codes (read once per pair), the direction bytes (written once, in whole
// sectors) and the three results. Shared memory per warp: 32 * (64 R + 32)
// ring bytes plus T target bytes; 4 warps per block (46080 bytes at (152,
// 256), 143360 at (512, 2048)). chip_smoke.py phase 2 prints each
// instantiation's ptxas registers and spills, and fails on a spill.
// What the design does about it: no cell waits on memory (the state stays in
// registers, the codes in registers and shared memory), DPX instructions fold
// the max chains (one each for E, F and H), and 2048 pairs give 2048 warps,
// 15-16 on every SM, enough to keep the INT32 pipe issuing. What is left is
// the cell arithmetic and the lanes idle at the wave's ends.
//
// Cells outside the valid region (q >= qlen or t >= tlen) are not defined
// in dirs: the traceback only walks valid cells.
//
// The input comes through the kernel's loader parameter, read once in the
// prologue; the DP body and the epilogue are one code for both. CodesIn
// (sw_forward_launch, sw_forward_i16_launch) reads decoded (Q, B) / (T, B)
// codes and int32 lengths. Q2In (sw_forward_q2_launch and its int16 twin,
// the main path's, at R = 5, 8 and 16) reads the engine's q2 upload and
// the flat resident genome itself: it decodes the lane's rows from the
// 2-bit codes and the N mask, and gathers the target window from the
// genome in coalesced runs, where CodesIn's target reads are strided by B.
// So no decoded copy of a batch is built in device memory first.
//
// Two instantiations, picked per call by ops/sw_cuda.py:pick_dtype (the
// rule of sw_pallas._pick_dtype, under RSB_SW16): Acc = int32_t, and
// Acc = int16_t, which starts E and F at NEG16 = -(1 << 14) and passes the
// H and E of a lane's bottom row to the next lane as two int16 halves of
// one 32-bit shuffle. Both compute in int; the span bound that admits int16
// keeps every passed value in range, so wherever it holds the int16
// outputs equal the int32 ones byte for byte.
//
// sw_forward_split_kernel<R, PAIRS> below is the cross-pair ILP variant
// (sw_forward_split_launch, int32; not on the mapping path). It replaces
// the Pallas kernel of tests/sanitize/ilp_probe.py (`make_variant(SPLIT)`
// :33 -> `_kernel_split` :42, pallas_call :162), which splits the batch
// into SPLIT lane groups and interleaves their anti-diagonal recurrences
// in one step. Here one warp holds PAIRS = 2 or 4 pairs, warp w the pairs
// w + p * (B / PAIRS) (the column groups of `_kernel_split`), with the
// production design for each: R rows a lane in registers, column s - l of
// every pair at step s, a shuffle chain a pair, a ring of direction bytes
// and the staged target codes in shared memory for each (a block holds 4 /
// PAIRS warps: the same 4 pairs and bytes as a production block), dirs
// (B, Q, T) in the same 16-byte stores, the same best-cell reduction; its
// outputs equal the int32 warp kernel's byte for byte on valid cells. The
// pairs' chains are independent, and every lane computes every step
// (`lane_column`: selects keep an idle lane's state), so a step's cells of
// all pairs form one basic block and the scheduler can put one pair's
// shuffle and DPX latency under another's arithmetic: the Hopper
// counterpart of the interleaved lane groups. What that costs: 2R + 3
// selects a pair and step, and the steps of the warp's longest pair for
// all of them. What it tests: whether a warp with 2 or 4 chains runs
// faster than as many warps with one (tools/ilp_probe.py; PERF.md).
// It is a kernel of its own, sharing sw_cell, flush_block and the ring
// layout, because as one template with the production kernel (PAIRS = 1)
// ptxas gave the production kernels 72 registers at R = 5 instead of 70,
// and in one arrangement spilled 12 bytes at R = 8. ptxas registers and
// spills of every instantiation are printed by chip_smoke.py phase 2 (at R
// = 16 the split spills).
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

template <typename Acc>
struct NegInf;
template <>
struct NegInf<int32_t> {
    static constexpr int value = -(1 << 28);
};
template <>
struct NegInf<int16_t> {
    static constexpr int value = -(1 << 14);
};

// One DP cell (q, t) from its three neighbours, with every tie rule of the
// recurrence; both kernels below call it, so they share one set of rules.
struct Cell {
    int H, E, F, dir;
};

__device__ __forceinline__ Cell sw_cell(int qc, int tc, int h_diag, int h_up, int e_up,
                                        int h_left, int f_left, int A, int Bm, int O,
                                        int Eg) {
    // E: gap in the target ('I'), from the cell above; extension wins a
    // tie with opening (E = max(h_up - O, e_ext) equals e_ext exactly then)
    const int e_ext = e_up - Eg;
    const int E = __viaddmax_s32(h_up, -O, e_ext);
    // F: gap in the query ('D'), from the cell to the left
    const int f_ext = f_left - Eg;
    const int F = __viaddmax_s32(h_left, -O, f_ext);
    // +A only for equal codes < 4 (N and padding never match)
    const int dsub = h_diag + ((qc == tc && qc < 4) ? A : -Bm);
    // H = max(dsub, max(E, 0), max(F, 0), 0)
    const int H = __vimax3_s32_relu(dsub, E, F);
    // H source: 0 stop, 1 diagonal (wins a tie with the gap), 2 E, 3 F
    // (F wins an E/F tie). With H > 0, "dsub >= max(E, F, 0)" is H == dsub,
    // and then "max(E, 0) > max(F, 0)" is E > F.
    const int src = H == 0 ? 0 : (H == dsub ? 1 : (E > F ? 2 : 3));
    // bit 4: raw code equality, so N against N walks as '='
    return {H, E, F, src | ((E == e_ext) << 2) | ((F == f_ext) << 3) | ((qc == tc) << 4)};
}

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;      // pairs (warps) per block
constexpr int kRing = 64;      // ring columns per row: a block being written out
                               // and the next one being computed
constexpr int kLanePad = 32;   // bytes after each lane's rows: spreads the
                               // lanes' byte stores over the banks
constexpr int kMaxQ = 512;     // 32 lanes x R = 16 rows

// shared memory of one warp: its ring, then its pair's target codes
__host__ __device__ constexpr size_t warp_smem(int R, int T) {
    return 32 * (size_t)(R * kRing + kLanePad) + (((size_t)T + 15) & ~(size_t)15);
}

// Write the direction bytes of columns [32 blk, 32 blk + 32) of rows
// [0, ql), which every lane has finished, from the ring to the pair's
// (Q, T) plane. With T % 16 == 0 two 16-byte stores per row (a chunk that
// starts before tl ends inside the row); otherwise one byte per lane.
template <int R>
__device__ __forceinline__ void flush_block(const uint8_t* ring, uint8_t* out, int blk,
                                            int ql, int tl, int T, int lane) {
    constexpr int kLane = R * kRing + kLanePad;
    const int c0 = blk * 32;
    if (blk < 0 || c0 >= tl) return;
    const int slot = c0 & (kRing - 1);
    if ((T & 15) == 0) {
        for (int c = lane; c < 2 * ql; c += 32) {
            const int q = c >> 1, half = (c & 1) << 4;
            if (c0 + half < tl) {
                const int l = q / R;
                const uint4 v = *reinterpret_cast<const uint4*>(
                    ring + l * kLane + (q - l * R) * kRing + slot + half);
                *reinterpret_cast<uint4*>(out + (size_t)q * T + c0 + half) = v;
            }
        }
    } else if (c0 + lane < tl) {
        for (int q = 0; q < ql; ++q) {
            const int l = q / R;
            out[(size_t)q * T + c0 + lane] = ring[l * kLane + (q - l * R) * kRing + slot + lane];
        }
    }
}

// The forward's input, read in the kernel's prologue by `load`: the
// pair's clamped lengths (ql, tl), its target codes staged in shared memory
// (tcode[t] for t < tl, a lane every 32nd) and the lane's R query codes
// (code 4 for an N and for a row at or past ql). `ring`, the warp's ring,
// is free until the DP starts, and a loader may stage there. CodesIn reads
// the decoded layout: (Q, B) query codes, (T, B) target codes 0..4 and
// int32 lengths, as `unpack_q2` and the Python mapper's fill build them.
struct CodesIn {
    const uint8_t* q_t;   // (Q, B)
    const uint8_t* t_t;   // (T, B)
    const int32_t* qlen;  // (B,)
    const int32_t* tlen;  // (B,)

    template <int R>
    __device__ __forceinline__ void load(int b, int Q, int T, int B, int lane, uint8_t*,
                                         uint8_t* tcode, int (&qc)[R], int& ql, int& tl) const {
        const size_t sB = (size_t)B;
        ql = max(0, min(__ldg(qlen + b), Q));
        tl = max(0, min(__ldg(tlen + b), T));
        for (int t = lane; t < tl; t += 32) tcode[t] = __ldg(t_t + t * sB + b);
        const int q0 = lane * R;
#pragma unroll
        for (int r = 0; r < R; ++r) qc[r] = q0 + r < ql ? __ldg(q_t + (q0 + r) * sB + b) : 4;
    }
};

// Q2In reads the engine's q2 upload (engine.cpp chunk_fill_batch_q2), the
// main path's layout, (Qp + Qm + 8, B) u8 with Qp = ceil(Q/4), Qm =
// ceil(Q/8): the query's 2-bit codes four a byte (row q in byte q / 4 at
// bits 2 (q % 4)), its N mask eight rows a byte, then qlen u16, tlen u16
// and the target's u32 offset into the flat resident genome, low bytes
// first. The target is the genome's window ref[min(tstart + t, len - 1)],
// read in coalesced runs of 32 codes (the clamp of `gather_targets`). The
// query is decoded as the target is staged: a lane a code byte (four rows,
// with its half of a mask byte) into the ring, one word a byte; after a
// __syncwarp each lane reads its R codes from there. So the prologue keeps
// the shape of CodesIn's, a strided loop into shared memory and R loads.
struct Q2In {
    const uint8_t* q2;   // (Qp + Qm + 8, B)
    const uint8_t* ref;  // the flat resident genome, ref_len codes
    long long ref_len;

    template <int R>
    __device__ __forceinline__ void load(int b, int Q, int T, int B, int lane, uint8_t* ring,
                                         uint8_t* tcode, int (&qc)[R], int& ql, int& tl) const {
        const size_t sB = (size_t)B;
        const int Qp = (Q + 3) >> 2, Qm = (Q + 7) >> 3;
        const uint8_t* tail = q2 + (size_t)(Qp + Qm) * sB + b;
        ql = min(__ldg(tail) | (__ldg(tail + sB) << 8), Q);
        tl = min(__ldg(tail + 2 * sB) | (__ldg(tail + 3 * sB) << 8), T);
        const long long tstart = (long long)((uint32_t)__ldg(tail + 4 * sB) |
                                             ((uint32_t)__ldg(tail + 5 * sB) << 8) |
                                             ((uint32_t)__ldg(tail + 6 * sB) << 16) |
                                             ((uint32_t)__ldg(tail + 7 * sB) << 24));
        const long long last = ref_len - 1;
        for (int t = lane; t < tl; t += 32) tcode[t] = __ldg(ref + min(tstart + t, last));
        for (int j = lane; j < Qp; j += 32) {  // rows 4 j .. 4 j + 3
            const uint32_t c = __ldg(q2 + j * sB + b);
            const uint32_t n = __ldg(q2 + (Qp + (j >> 1)) * sB + b) >> ((j & 1) << 2);
            uint32_t w = 0;
#pragma unroll
            for (int k = 0; k < 4; ++k) w |= ((n >> k) & 1 ? 4u : (c >> (2 * k)) & 3u) << (8 * k);
            *reinterpret_cast<uint32_t*>(ring + 4 * j) = w;
        }
        __syncwarp();
        const int q0 = lane * R;
#pragma unroll
        for (int r = 0; r < R; ++r) qc[r] = q0 + r < ql ? ring[q0 + r] : 4;
    }
};

template <typename Acc, int R, typename In>
__global__ void __launch_bounds__(kWarps * 32) sw_forward_warp_kernel(
    const In in,                        // the pairs' codes and lengths (CodesIn or Q2In)
    int Q, int T, int B, int A, int Bm, int O, int Eg,
    uint8_t* __restrict__ dirs,         // (B, Q, T) direction bytes
    int32_t* __restrict__ score,        // (B,)
    int32_t* __restrict__ t_end,        // (B,)
    int32_t* __restrict__ q_end) {      // (B,)
    constexpr int kNeg = NegInf<Acc>::value;
    constexpr int kLane = R * kRing + kLanePad;
    extern __shared__ __align__(16) uint8_t smem[];
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
    if (b >= B) return;  // the whole warp
    uint8_t* ring = smem + (threadIdx.x >> 5) * warp_smem(R, T);
    uint8_t* tcode = ring + 32 * kLane;
    int ql, tl;
    int qc[R], h_left[R], f_left[R];  // per row: code, H and F of column t-1
    in.template load<R>(b, Q, T, B, lane, ring, tcode, qc, ql, tl);
    const int q0 = lane * R;
#pragma unroll
    for (int r = 0; r < R; ++r) {
        h_left[r] = 0;
        f_left[r] = kNeg;
    }
    __syncwarp();  // tcode staged, and the ring's staging read
    const int rows = ql - q0;         // the lane's valid rows (clamped by R below)
    const int lanes = (ql + R - 1) / R;
    const int steps = ql > 0 && tl > 0 ? tl + lanes - 1 : 0;
    const bool busy = lane < lanes;
    uint8_t* my_rows = ring + lane * kLane;
    uint8_t* out = dirs + (size_t)b * Q * T;
    int h_top = 0;                    // H(q0 - 1, t - 1)
    int out_h = 0, out_e = kNeg;      // the lane's bottom row, its last column
    int best_h = 0, best_t = -1, best_q = 0;
    for (int s = 0; s < steps; ++s) {
        // H and E of row q0 - 1 at column t: lane - 1's bottom row, last step
        int h_up, e_up;
        if constexpr (sizeof(Acc) == 2) {
            const unsigned pk = __shfl_up_sync(
                kFull, (unsigned)(uint16_t)out_h | ((unsigned)out_e << 16), 1);
            h_up = (int16_t)(pk & 0xffffu);
            e_up = (int)pk >> 16;
        } else {
            h_up = __shfl_up_sync(kFull, out_h, 1);
            e_up = __shfl_up_sync(kFull, out_e, 1);
        }
        if (lane == 0) {  // row -1
            h_up = 0;
            e_up = kNeg;
        }
        const int t = s - lane;
        if (busy && t >= 0 && t < tl) {
            const int tc = tcode[t];
            uint8_t* col = my_rows + (t & (kRing - 1));
            int h_diag = h_top;
            h_top = h_up;
#pragma unroll
            for (int r = 0; r < R; ++r) {
                const Cell c = sw_cell(qc[r], tc, h_diag, h_up, e_up, h_left[r], f_left[r], A,
                                       Bm, O, Eg);
                col[r * kRing] = (uint8_t)c.dir;
                if (r < rows && c.H > best_h) {  // strict: smallest t, then q
                    best_h = c.H;
                    best_t = t;
                    best_q = q0 + r;
                }
                h_diag = h_left[r];
                h_left[r] = c.H;
                f_left[r] = c.F;
                h_up = c.H;
                e_up = c.E;
            }
            out_h = h_up;
            out_e = e_up;
        }
        if ((s & 31) == 31) {  // every lane is past column 32 * (s >> 5) - 1
            __syncwarp();
            flush_block<R>(ring, out, (s >> 5) - 1, ql, tl, T, lane);
            __syncwarp();
        }
    }
    // the blocks not yet written: at most the last two
    __syncwarp();
    flush_block<R>(ring, out, (steps >> 5) - 1, ql, tl, T, lane);
    flush_block<R>(ring, out, steps >> 5, ql, tl, T, lane);
    // the pair's best: max score, then min t, then min q
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const int oh = __shfl_xor_sync(kFull, best_h, off);
        const int ot = __shfl_xor_sync(kFull, best_t, off);
        const int oq = __shfl_xor_sync(kFull, best_q, off);
        if (oh > best_h || (oh == best_h && (ot < best_t || (ot == best_t && oq < best_q)))) {
            best_h = oh;
            best_t = ot;
            best_q = oq;
        }
    }
    if (lane == 0) {
        score[b] = best_h;
        t_end[b] = best_t;
        q_end[b] = best_q;
    }
}

// The DP state one lane of the split kernel keeps for one pair: per row
// its query code and the H and F of column t-1; H of the row above at
// column t-1 (the diagonal of the lane's first row); its bottom row's H and
// E at its last column, which the next lane reads; and its best cell.
template <int R>
struct LaneState {
    int qc[R], h_left[R], f_left[R];
    int h_top, out_h, out_e;
    int best_h, best_t, best_q;
};

// Column t of the lane's R rows of one pair, top to bottom, from the H and
// E of the row above at column t (h_up, e_up), as the production kernel's
// step computes them; each cell's byte goes to `col`, the lane's ring slot
// of column t. Every lane calls it at every step, and `on` (the lane is
// busy and t lies in [0, tl)) decides by selects whether the state takes
// the results, so that a step's cells of all the warp's pairs form one
// basic block. An idle lane's bytes land in ring slots that no flush reads
// before the lane's next real write there.
template <int R>
__device__ __forceinline__ void lane_column(LaneState<R>& st, int h_up, int e_up, int tc, int t,
                                            bool on, int rows, int q0, uint8_t* col, int A,
                                            int Bm, int O, int Eg) {
    int h_diag = st.h_top;
    st.h_top = on ? h_up : st.h_top;
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const Cell c = sw_cell(st.qc[r], tc, h_diag, h_up, e_up, st.h_left[r], st.f_left[r], A,
                               Bm, O, Eg);
        col[r * kRing] = (uint8_t)c.dir;
        if (on && r < rows && c.H > st.best_h) {  // strict: smallest t, then q
            st.best_h = c.H;
            st.best_t = t;
            st.best_q = q0 + r;
        }
        h_diag = st.h_left[r];
        st.h_left[r] = on ? c.H : st.h_left[r];
        st.f_left[r] = on ? c.F : st.f_left[r];
        h_up = c.H;
        e_up = c.E;
    }
    st.out_h = on ? h_up : st.out_h;
    st.out_e = on ? e_up : st.out_e;
}

// H and E of row q0 - 1 at column t: lane - 1's bottom row, last step
// (row -1 on lane 0)
__device__ __forceinline__ void row_above(int out_h, int out_e, int lane, int& h_up, int& e_up) {
    h_up = __shfl_up_sync(kFull, out_h, 1);
    e_up = __shfl_up_sync(kFull, out_e, 1);
    if (lane == 0) {
        h_up = 0;
        e_up = NegInf<int32_t>::value;
    }
}

// The cross-pair ILP forward, int32: one warp for PAIRS pairs, pair p of
// warp w being w + p * (B / PAIRS), the column groups of `_kernel_split`.
// A block holds kWarps pairs (kWarps / PAIRS warps), so its shared memory
// is the production block's.
template <int R, int PAIRS>
__global__ void __launch_bounds__(kWarps / PAIRS * 32) sw_forward_split_kernel(
    const uint8_t* __restrict__ q_t, const uint8_t* __restrict__ t_t,
    const int32_t* __restrict__ qlen, const int32_t* __restrict__ tlen, int Q, int T, int B,
    int A, int Bm, int O, int Eg, uint8_t* __restrict__ dirs, int32_t* __restrict__ score,
    int32_t* __restrict__ t_end, int32_t* __restrict__ q_end) {
    constexpr int kNeg = NegInf<int32_t>::value;
    constexpr int kLane = R * kRing + kLanePad;
    constexpr int kBlockWarps = kWarps / PAIRS;
    extern __shared__ __align__(16) uint8_t smem[];
    const int lane = threadIdx.x & 31;
    const int Bp = B / PAIRS;
    const int w = blockIdx.x * kBlockWarps + (threadIdx.x >> 5);
    if (w >= Bp) return;  // the whole warp
    uint8_t* wsmem = smem + (threadIdx.x >> 5) * PAIRS * warp_smem(R, T);
    const size_t sB = (size_t)B;
    const int q0 = lane * R;
    LaneState<R> st[PAIRS];
    int b[PAIRS], ql[PAIRS], tl[PAIRS], rows[PAIRS];
    bool busy[PAIRS];
    uint8_t *ring[PAIRS], *tcode[PAIRS], *my_rows[PAIRS], *out[PAIRS];
    int steps = 0;
#pragma unroll
    for (int p = 0; p < PAIRS; ++p) {
        b[p] = w + p * Bp;
        ring[p] = wsmem + p * warp_smem(R, T);
        tcode[p] = ring[p] + 32 * kLane;
        ql[p] = max(0, min(qlen[b[p]], Q));
        tl[p] = max(0, min(tlen[b[p]], T));
        for (int t = lane; t < tl[p]; t += 32) tcode[p][t] = t_t[t * sB + b[p]];
#pragma unroll
        for (int r = 0; r < R; ++r) {
            st[p].qc[r] = q0 + r < ql[p] ? q_t[(q0 + r) * sB + b[p]] : 4;
            st[p].h_left[r] = 0;
            st[p].f_left[r] = kNeg;
        }
    }
    __syncwarp();
#pragma unroll
    for (int p = 0; p < PAIRS; ++p) {
        rows[p] = ql[p] - q0;  // the lane's valid rows (clamped by R in lane_column)
        const int lanes = (ql[p] + R - 1) / R;
        steps = max(steps, ql[p] > 0 && tl[p] > 0 ? tl[p] + lanes - 1 : 0);
        busy[p] = lane < lanes;
        my_rows[p] = ring[p] + lane * kLane;
        out[p] = dirs + (size_t)b[p] * Q * T;
        st[p].h_top = 0;
        st[p].out_h = 0;
        st[p].out_e = kNeg;
        st[p].best_h = 0;
        st[p].best_t = -1;
        st[p].best_q = 0;
    }
    for (int s = 0; s < steps; ++s) {
        int h_up[PAIRS], e_up[PAIRS];
#pragma unroll
        for (int p = 0; p < PAIRS; ++p) row_above(st[p].out_h, st[p].out_e, lane, h_up[p], e_up[p]);
        const int t = s - lane;
#pragma unroll
        for (int p = 0; p < PAIRS; ++p) {
            const bool on = busy[p] && t >= 0 && t < tl[p];
            lane_column<R>(st[p], h_up[p], e_up[p], on ? tcode[p][t] : 4, t, on, rows[p], q0,
                           my_rows[p] + (t & (kRing - 1)), A, Bm, O, Eg);
        }
        if ((s & 31) == 31) {  // every lane is past column 32 * (s >> 5) - 1
            __syncwarp();
#pragma unroll
            for (int p = 0; p < PAIRS; ++p)
                flush_block<R>(ring[p], out[p], (s >> 5) - 1, ql[p], tl[p], T, lane);
            __syncwarp();
        }
    }
    // the blocks not yet written: at most the last two
    __syncwarp();
#pragma unroll
    for (int p = 0; p < PAIRS; ++p) {
        flush_block<R>(ring[p], out[p], (steps >> 5) - 1, ql[p], tl[p], T, lane);
        flush_block<R>(ring[p], out[p], steps >> 5, ql[p], tl[p], T, lane);
    }
    // each pair's best: max score, then min t, then min q
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int p = 0; p < PAIRS; ++p) {
            const int oh = __shfl_xor_sync(kFull, st[p].best_h, off);
            const int ot = __shfl_xor_sync(kFull, st[p].best_t, off);
            const int oq = __shfl_xor_sync(kFull, st[p].best_q, off);
            if (oh > st[p].best_h ||
                (oh == st[p].best_h && (ot < st[p].best_t ||
                                        (ot == st[p].best_t && oq < st[p].best_q)))) {
                st[p].best_h = oh;
                st[p].best_t = ot;
                st[p].best_q = oq;
            }
        }
    }
    if (lane == 0) {
#pragma unroll
        for (int p = 0; p < PAIRS; ++p) {
            score[b[p]] = st[p].best_h;
            t_end[b[p]] = st[p].best_t;
            q_end[b[p]] = st[p].best_q;
        }
    }
}

// Allow `kernel` the device's opt-in maximum of shared memory, the same
// value on every call (so calls from several threads never race on it); a
// launch that needs more than that is refused and its error returned
template <typename K>
int allow_max_smem(K kernel) {
    int dev = 0, max_smem = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
    if (err != cudaSuccess) cudaGetLastError();
    return (int)err;
}

template <typename Acc, int R, typename In>
int launch_warp(const In& in, int Q, int T, int B, int A, int Bm, int O, int Eg, void* dirs,
                void* score, void* t_end, void* q_end, void* stream) {
    const auto kernel = sw_forward_warp_kernel<Acc, R, In>;
    if (const int err = allow_max_smem(kernel)) return err;
    kernel<<<(B + kWarps - 1) / kWarps, kWarps * 32, kWarps * warp_smem(R, T),
             (cudaStream_t)stream>>>(in, Q, T, B, A, Bm, O, Eg, (uint8_t*)dirs, (int32_t*)score,
                                     (int32_t*)t_end, (int32_t*)q_end);
    return (int)cudaGetLastError();
}

template <int R, int PAIRS>
int launch_split(const void* q_t, const void* t_t, const void* qlen, const void* tlen,
                 int Q, int T, int B, int A, int Bm, int O, int Eg, void* dirs,
                 void* score, void* t_end, void* q_end, void* stream) {
    const auto kernel = sw_forward_split_kernel<R, PAIRS>;
    constexpr int kBlockWarps = kWarps / PAIRS;
    if (const int err = allow_max_smem(kernel)) return err;
    kernel<<<(B / PAIRS + kBlockWarps - 1) / kBlockWarps, kBlockWarps * 32,
             kWarps * warp_smem(R, T), (cudaStream_t)stream>>>(
        (const uint8_t*)q_t, (const uint8_t*)t_t, (const int32_t*)qlen, (const int32_t*)tlen, Q,
        T, B, A, Bm, O, Eg, (uint8_t*)dirs, (int32_t*)score, (int32_t*)t_end, (int32_t*)q_end);
    return (int)cudaGetLastError();
}

// f(std::integral_constant<int, R>()) at the smallest R of Rs with 32 R >=
// Q (the rows a lane owns); cudaErrorInvalidValue past the last
template <int... Rs, typename F>
int at_rows(int Q, F&& f) {
    int rc = (int)cudaErrorInvalidValue;
    bool done = false;
    ((done = done || (Q <= 32 * Rs && (rc = f(std::integral_constant<int, Rs>()), true))), ...);
    return rc;
}

// The forward (PAIRS = 0: one warp a pair, in Acc) or the split (PAIRS 2
// or 4, int32) at the R that covers Q
template <typename Acc, int PAIRS>
int launch(const void* q_t, const void* t_t, const void* qlen, const void* tlen, int Q,
           int T, int B, int A, int Bm, int O, int Eg, void* dirs, void* score,
           void* t_end, void* q_end, void* stream) {
    if (Q < 0 || T < 0 || B < 0 || Q > kMaxQ || (PAIRS && B % PAIRS != 0))
        return (int)cudaErrorInvalidValue;
    if (B == 0) return (int)cudaGetLastError();
    return at_rows<1, 2, 4, 5, 8, 16>(Q, [&](auto rows) {
        constexpr int R = decltype(rows)::value;
        if constexpr (PAIRS == 0)
            return launch_warp<Acc, R>(
                CodesIn{(const uint8_t*)q_t, (const uint8_t*)t_t, (const int32_t*)qlen,
                        (const int32_t*)tlen},
                Q, T, B, A, Bm, O, Eg, dirs, score, t_end, q_end, stream);
        else
            return launch_split<R, PAIRS>(q_t, t_t, qlen, tlen, Q, T, B, A, Bm, O, Eg, dirs,
                                          score, t_end, q_end, stream);
    });
}

// The forward on the q2 upload (Q2In), at R = 5, 8 or 16: the smallest
// that covers Q of the rows the engine's buckets take
template <typename Acc>
int launch_q2(const void* q2, const void* ref, long long ref_len, int Q, int T, int B, int A,
              int Bm, int O, int Eg, void* dirs, void* score, void* t_end, void* q_end,
              void* stream) {
    if (Q < 0 || T < 0 || B < 0 || Q > kMaxQ || ref_len < 1) return (int)cudaErrorInvalidValue;
    if (B == 0) return (int)cudaGetLastError();
    const Q2In in{(const uint8_t*)q2, (const uint8_t*)ref, ref_len};
    return at_rows<5, 8, 16>(Q, [&](auto rows) {
        return launch_warp<Acc, decltype(rows)::value>(in, Q, T, B, A, Bm, O, Eg, dirs, score,
                                                       t_end, q_end, stream);
    });
}

}  // namespace

// dirs is (B, Q, T); Q at most 512, anything else returns
// cudaErrorInvalidValue and launches nothing
extern "C" int sw_forward_launch(const void* q_t, const void* t_t, const void* qlen,
                                 const void* tlen, int Q, int T, int B, int A, int Bm,
                                 int O, int Eg, void* dirs, void* score, void* t_end,
                                 void* q_end, void* stream) {
    return launch<int32_t, 0>(q_t, t_t, qlen, tlen, Q, T, B, A, Bm, O, Eg, dirs, score,
                              t_end, q_end, stream);
}

// the int16 configuration; only for shapes and scores within the span
// bound of pick_dtype
extern "C" int sw_forward_i16_launch(const void* q_t, const void* t_t, const void* qlen,
                                     const void* tlen, int Q, int T, int B, int A, int Bm,
                                     int O, int Eg, void* dirs, void* score, void* t_end,
                                     void* q_end, void* stream) {
    return launch<int16_t, 0>(q_t, t_t, qlen, tlen, Q, T, B, A, Bm, O, Eg, dirs, score,
                              t_end, q_end, stream);
}

// The forward on the engine's q2 upload, (ceil(Q/4) + ceil(Q/8) + 8, B)
// u8, and the flat resident genome of ref_len codes, which it decodes and
// gathers itself: the same outputs as sw_forward_launch on unpack_q2's
// (q_t, t_t, qlen, tlen). Q at most 512, else cudaErrorInvalidValue.
extern "C" int sw_forward_q2_launch(const void* q2, const void* ref, long long ref_len, int Q,
                                    int T, int B, int A, int Bm, int O, int Eg, void* dirs,
                                    void* score, void* t_end, void* q_end, void* stream) {
    return launch_q2<int32_t>(q2, ref, ref_len, Q, T, B, A, Bm, O, Eg, dirs, score, t_end, q_end,
                              stream);
}

// the same in the int16 configuration (the span bound of pick_dtype)
extern "C" int sw_forward_q2_i16_launch(const void* q2, const void* ref, long long ref_len,
                                        int Q, int T, int B, int A, int Bm, int O, int Eg,
                                        void* dirs, void* score, void* t_end, void* q_end,
                                        void* stream) {
    return launch_q2<int16_t>(q2, ref, ref_len, Q, T, B, A, Bm, O, Eg, dirs, score, t_end, q_end,
                              stream);
}

// The cross-pair ILP forward, int32, `pairs` pairs a warp; dirs (B, Q, T)
// as above. `pairs` must be 2 or 4 and divide B, and Q at most 512:
// anything else returns cudaErrorInvalidValue and launches nothing.
extern "C" int sw_forward_split_launch(const void* q_t, const void* t_t,
                                       const void* qlen, const void* tlen, int Q,
                                       int T, int B, int A, int Bm, int O, int Eg,
                                       int pairs, void* dirs, void* score, void* t_end,
                                       void* q_end, void* stream) {
    if (pairs == 2)
        return launch<int32_t, 2>(q_t, t_t, qlen, tlen, Q, T, B, A, Bm, O, Eg, dirs, score,
                                  t_end, q_end, stream);
    if (pairs == 4)
        return launch<int32_t, 4>(q_t, t_t, qlen, tlen, Q, T, B, A, Bm, O, Eg, dirs, score,
                                  t_end, q_end, stream);
    return (int)cudaErrorInvalidValue;
}
