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
// 256), 143360 at (512, 2048)). ptxas (CUDA 12.9): 70, 80 and 128 registers
// at R = 5, 8, 16 (72, 96, 80 at R = 4, 2, 1), no spills.
// What the design does about it: no cell waits on memory (the state stays in
// registers, the codes in registers and shared memory), DPX instructions fold
// the max chains (one each for E, F and H), and 2048 pairs give 2048 warps,
// 15-16 on every SM, enough to keep the INT32 pipe issuing. What is left is
// the cell arithmetic and the lanes idle at the wave's ends.
//
// Cells outside the valid region (q >= qlen or t >= tlen) are not defined
// in dirs: the traceback only walks valid cells.
//
// Two instantiations, picked per call by ops/sw_cuda.py:pick_dtype (the
// rule of sw_pallas._pick_dtype, under RSB_SW16): Acc = int32_t, and
// Acc = int16_t, which starts E and F at NEG16 = -(1 << 14) and passes the
// H and E of a lane's bottom row to the next lane as two int16 halves of
// one 32-bit shuffle. Both compute in int; the span bound that admits int16
// keeps every passed value in range, so wherever it holds the int16
// outputs equal the int32 ones byte for byte.
//
// sw_forward_split_kernel below walks each pair row by row on one thread,
// 2 or 4 pairs per thread, with the previous row's H and E in device memory
// and dirs in the (Q, T, B) layout (the cross-pair ILP probe; not on the
// mapping path).
#include <cstdint>
#include <cuda_runtime.h>

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

// A finished row folds into the pair's result: max score, then min t,
// then min q (rows come in increasing q, so a tie on both keeps the first)
__device__ __forceinline__ void fold_row(int row_h, int row_t, int q, int& best_h,
                                         int& best_t, int& best_q) {
    if (row_h > best_h || (row_h == best_h && row_t < best_t)) {
        best_h = row_h;
        best_t = row_t;
        best_q = q;
    }
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

template <typename Acc, int R>
__global__ void __launch_bounds__(kWarps * 32) sw_forward_warp_kernel(
    const uint8_t* __restrict__ q_t,    // (Q, B) query codes 0..4
    const uint8_t* __restrict__ t_t,    // (T, B) target codes 0..4
    const int32_t* __restrict__ qlen,   // (B,)
    const int32_t* __restrict__ tlen,   // (B,)
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
    const int ql = max(0, min(qlen[b], Q));
    const int tl = max(0, min(tlen[b], T));
    const size_t sB = (size_t)B;
    for (int t = lane; t < tl; t += 32) tcode[t] = t_t[t * sB + b];
    const int q0 = lane * R;
    int qc[R], h_left[R], f_left[R];  // per row: code, H and F of column t-1
#pragma unroll
    for (int r = 0; r < R; ++r) {
        qc[r] = q0 + r < ql ? q_t[(q0 + r) * sB + b] : 4;
        h_left[r] = 0;
        f_left[r] = kNeg;
    }
    __syncwarp();
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

// Cross-pair ILP forward, int32: each thread walks its pairs' rows in
// order (q outer, t inner), the previous row's H and E in (T, B) scratch in
// device memory, with PAIRS pairs on each thread. Replaces the Pallas kernel of
// tests/sanitize/ilp_probe.py (`make_variant(SPLIT)` -> `_kernel_split`),
// which splits the batch into SPLIT lane groups and interleaves their
// diagonal recurrences in one step. Here thread i carries the pairs
// i + s * (B / PAIRS), s < PAIRS (group s is columns [s*B/PAIRS,
// (s+1)*B/PAIRS), as in `_kernel_split`), so each of a warp's PAIRS loads
// and stores per cell step stays coalesced. The pairs' cells are
// interleaved one step at a time over the largest qlen and tlen of the
// thread: all PAIRS loads first, then the PAIRS independent cell updates,
// then the stores, so the loads overlap and the compiler never has to
// prove that two pairs' scratch words differ. A cell outside a pair's
// valid region does nothing for that pair: no dirs or scratch write, no
// row best, no fold. dirs are (Q, T, B); outputs equal
// sw_forward_warp_kernel<int32_t, R>'s byte for byte on valid cells, its
// dirs read through ops/sw_cuda.py:permute_dirs.
//
// Block size: one warp. The kernel is bound by latency (each pair is a
// chain of dependent cells whose scratch loads come from L2), so the
// B / PAIRS threads are spread over as many SMs as possible, one warp each:
// at (152, 256) x 1024 that is 16 SMs for PAIRS = 2 and 8 for PAIRS = 4,
// where 128-thread blocks would give 4 and 2. A warp's row scratch (32 x
// PAIRS x T x 8 bytes, 128 KiB at PAIRS = 2, T = 256) then has an SM's L1
// to itself.
constexpr int kSplitThreads = 32;

template <int PAIRS>
__global__ void __launch_bounds__(kSplitThreads) sw_forward_split_kernel(
    const uint8_t* __restrict__ q_t, const uint8_t* __restrict__ t_t,
    const int32_t* __restrict__ qlen, const int32_t* __restrict__ tlen, int Q, int T,
    int B, int A, int Bm, int O, int Eg, uint8_t* __restrict__ dirs,
    int32_t* __restrict__ h_row, int32_t* __restrict__ e_row,
    int32_t* __restrict__ score, int32_t* __restrict__ t_end,
    int32_t* __restrict__ q_end) {
    constexpr int kNeg = NegInf<int32_t>::value;
    const int Bp = B / PAIRS;
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= Bp) return;
    const size_t sB = (size_t)B;
    int b[PAIRS], ql[PAIRS], tl[PAIRS];
    int q_max = 0, t_max = 0;
#pragma unroll
    for (int s = 0; s < PAIRS; ++s) {
        b[s] = i + s * Bp;
        ql[s] = max(0, min(qlen[b[s]], Q));
        tl[s] = max(0, min(tlen[b[s]], T));
        q_max = max(q_max, ql[s]);
        t_max = max(t_max, tl[s]);
    }
    for (int t = 0; t < t_max; ++t) {
#pragma unroll
        for (int s = 0; s < PAIRS; ++s) {
            if (t < tl[s]) {
                h_row[t * sB + b[s]] = 0;
                e_row[t * sB + b[s]] = kNeg;
            }
        }
    }

    int best_h[PAIRS], best_t[PAIRS], best_q[PAIRS];
#pragma unroll
    for (int s = 0; s < PAIRS; ++s) {
        best_h[s] = 0;
        best_t[s] = -1;
        best_q[s] = 0;
    }
    for (int q = 0; q < q_max; ++q) {
        bool row_on[PAIRS];
        int qc[PAIRS], h_diag[PAIRS], h_left[PAIRS], f_left[PAIRS], row_h[PAIRS],
            row_t[PAIRS];
#pragma unroll
        for (int s = 0; s < PAIRS; ++s) {
            row_on[s] = q < ql[s];
            qc[s] = row_on[s] ? q_t[q * sB + b[s]] : 4;
            h_diag[s] = 0;
            h_left[s] = 0;
            f_left[s] = kNeg;
            row_h[s] = 0;
            row_t[s] = -1;
        }
        uint8_t* drow = dirs + (size_t)q * T * sB;
        for (int t = 0; t < t_max; ++t) {
            bool on[PAIRS];
            int tc[PAIRS], h_up[PAIRS], e_up[PAIRS];
#pragma unroll
            for (int s = 0; s < PAIRS; ++s) {
                on[s] = row_on[s] && t < tl[s];
                const size_t k = t * sB + b[s];
                tc[s] = on[s] ? t_t[k] : 0;
                h_up[s] = on[s] ? h_row[k] : 0;
                e_up[s] = on[s] ? e_row[k] : 0;
            }
#pragma unroll
            for (int s = 0; s < PAIRS; ++s) {
                if (!on[s]) continue;
                const size_t k = t * sB + b[s];
                const Cell c = sw_cell(qc[s], tc[s], h_diag[s], h_up[s], e_up[s], h_left[s],
                                       f_left[s], A, Bm, O, Eg);
                drow[k] = (uint8_t)c.dir;
                if (c.H > row_h[s]) {
                    row_h[s] = c.H;
                    row_t[s] = t;
                }
                h_diag[s] = h_up[s];
                h_row[k] = c.H;
                e_row[k] = c.E;
                h_left[s] = c.H;
                f_left[s] = c.F;
            }
        }
#pragma unroll
        for (int s = 0; s < PAIRS; ++s) {
            if (row_on[s]) fold_row(row_h[s], row_t[s], q, best_h[s], best_t[s], best_q[s]);
        }
    }
#pragma unroll
    for (int s = 0; s < PAIRS; ++s) {
        score[b[s]] = best_h[s];
        t_end[b[s]] = best_t[s];
        q_end[b[s]] = best_q[s];
    }
}

template <typename Acc, int R>
int launch_warp(const void* q_t, const void* t_t, const void* qlen, const void* tlen,
                int Q, int T, int B, int A, int Bm, int O, int Eg, void* dirs,
                void* score, void* t_end, void* q_end, void* stream) {
    const auto kernel = sw_forward_warp_kernel<Acc, R>;
    // allow the device's opt-in maximum, the same value on every call (so
    // calls from several threads never race on it); a launch that needs
    // more shared memory than that is refused and its error returned
    int dev = 0, max_smem = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
    if (err != cudaSuccess) {
        cudaGetLastError();
        return (int)err;
    }
    kernel<<<(B + kWarps - 1) / kWarps, kWarps * 32, kWarps * warp_smem(R, T),
             (cudaStream_t)stream>>>((const uint8_t*)q_t, (const uint8_t*)t_t,
                                     (const int32_t*)qlen, (const int32_t*)tlen, Q, T, B, A,
                                     Bm, O, Eg, (uint8_t*)dirs, (int32_t*)score,
                                     (int32_t*)t_end, (int32_t*)q_end);
    return (int)cudaGetLastError();
}

template <typename Acc>
int launch(const void* q_t, const void* t_t, const void* qlen, const void* tlen, int Q,
           int T, int B, int A, int Bm, int O, int Eg, void* dirs, void* score,
           void* t_end, void* q_end, void* stream) {
    if (Q < 0 || T < 0 || B < 0 || Q > kMaxQ) return (int)cudaErrorInvalidValue;
    if (B == 0) return (int)cudaGetLastError();
#define RSB_LAUNCH(R)                                                                   \
    return launch_warp<Acc, R>(q_t, t_t, qlen, tlen, Q, T, B, A, Bm, O, Eg, dirs, score, \
                               t_end, q_end, stream)
    if (Q <= 32) RSB_LAUNCH(1);
    if (Q <= 64) RSB_LAUNCH(2);
    if (Q <= 128) RSB_LAUNCH(4);
    if (Q <= 160) RSB_LAUNCH(5);
    if (Q <= 256) RSB_LAUNCH(8);
    RSB_LAUNCH(16);
#undef RSB_LAUNCH
}

}  // namespace

// dirs is (B, Q, T); Q at most 512, anything else returns
// cudaErrorInvalidValue and launches nothing
extern "C" int sw_forward_launch(const void* q_t, const void* t_t, const void* qlen,
                                 const void* tlen, int Q, int T, int B, int A, int Bm,
                                 int O, int Eg, void* dirs, void* score, void* t_end,
                                 void* q_end, void* stream) {
    return launch<int32_t>(q_t, t_t, qlen, tlen, Q, T, B, A, Bm, O, Eg, dirs, score,
                           t_end, q_end, stream);
}

// the int16 configuration; only for shapes and scores within the span
// bound of pick_dtype
extern "C" int sw_forward_i16_launch(const void* q_t, const void* t_t, const void* qlen,
                                     const void* tlen, int Q, int T, int B, int A, int Bm,
                                     int O, int Eg, void* dirs, void* score, void* t_end,
                                     void* q_end, void* stream) {
    return launch<int16_t>(q_t, t_t, qlen, tlen, Q, T, B, A, Bm, O, Eg, dirs, score,
                           t_end, q_end, stream);
}

// The cross-pair ILP forward, `pairs` pairs per thread; h_row and e_row
// are (T, B) int32 scratch. `pairs` must be 2 or 4 and divide B: anything
// else returns cudaErrorInvalidValue and launches nothing.
extern "C" int sw_forward_split_launch(const void* q_t, const void* t_t,
                                       const void* qlen, const void* tlen, int Q,
                                       int T, int B, int A, int Bm, int O, int Eg,
                                       int pairs, void* dirs, void* h_row,
                                       void* e_row, void* score, void* t_end,
                                       void* q_end, void* stream) {
    if ((pairs != 2 && pairs != 4) || B < 0 || B % pairs != 0)
        return (int)cudaErrorInvalidValue;
    if (B > 0) {
        const int blocks = (B / pairs + kSplitThreads - 1) / kSplitThreads;
        if (pairs == 2)
            sw_forward_split_kernel<2><<<blocks, kSplitThreads, 0, (cudaStream_t)stream>>>(
                (const uint8_t*)q_t, (const uint8_t*)t_t, (const int32_t*)qlen,
                (const int32_t*)tlen, Q, T, B, A, Bm, O, Eg, (uint8_t*)dirs,
                (int32_t*)h_row, (int32_t*)e_row, (int32_t*)score, (int32_t*)t_end,
                (int32_t*)q_end);
        else
            sw_forward_split_kernel<4><<<blocks, kSplitThreads, 0, (cudaStream_t)stream>>>(
                (const uint8_t*)q_t, (const uint8_t*)t_t, (const int32_t*)qlen,
                (const int32_t*)tlen, Q, T, B, A, Bm, O, Eg, (uint8_t*)dirs,
                (int32_t*)h_row, (int32_t*)e_row, (int32_t*)score, (int32_t*)t_end,
                (int32_t*)q_end);
    }
    return (int)cudaGetLastError();
}
