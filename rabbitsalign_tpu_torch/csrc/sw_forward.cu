// Batched affine-gap local Smith-Waterman forward pass for Hopper (sm_90a).
//
// Replaces the Pallas kernel of rabbitsalign_tpu/ops/sw_pallas.py
// (`_kernel`, launched by `_sw_forward_pallas_core`), together with the
// tie-break reduction that follows that call. Same recurrence, direction
// byte and tie-breaks; the dirs layout is this port's own: (Q, T, B) u8
// with the pair index innermost.
//
// Design: one thread per pair (the layout of GASAL2, the reference's own
// CUDA kernel). The thread walks its pair's valid region row by row
// (q outer, t inner). The previous row's H and E live in global scratch
// laid out (T, B), so the 32 threads of a warp touch 32 consecutive words
// at every cell; the diagonal H, the left H and the running F stay in
// registers. The best cell of each row is kept with a strict `>` (the
// smallest t wins a tie), and rows are folded into the pair's result with
// the global rule: max score, then min t, then min q.
//
// What bounds it on the card: each cell moves 17 bytes of global memory
// (H and E read and written, one target code read, one direction byte
// written) and runs 33 integer operations (30 in sw_cell, 3 for the row
// best), so the DP itself is far below
// both the memory and the integer roofline. What bounds it is occupancy:
// one thread per pair gives the tight (152, 256) bucket at 2048 pairs
// 16 blocks of 128 threads for 132 SMs, and each thread's chain of
// dependent cell updates runs at memory latency. Making it fast (several
// threads per pair over anti-diagonals, scratch in shared memory or
// registers, 16-bit DPX arithmetic) is later work; this version is the
// simple one that is exactly right.
//
// Cells outside the valid region (q >= qlen or t >= tlen) are not
// written: the traceback only walks valid cells.
//
// sw_forward_split_kernel below is the same recurrence with 2 or 4 pairs
// per thread (the cross-pair ILP probe; not on the mapping path).
//
// Two instantiations, picked per call by ops/sw_cuda.py:pick_dtype (the
// rule of sw_pallas._pick_dtype, under RSB_SW16): Acc = int32_t, and
// Acc = int16_t, which starts E and F at NEG16 = -(1 << 14) and keeps the
// H and E row scratch in 16 bits, halving the row-scratch traffic (16 ->
// 8 bytes per cell). Both compute in int and store Acc; the span bound that
// admits int16 keeps every stored value in range, so wherever it holds
// the int16 outputs equal the int32 ones byte for byte.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

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
    // tie with opening
    const int e_open = h_up - O, e_ext = e_up - Eg;
    const int e_is_ext = e_open <= e_ext;
    const int E = e_is_ext ? e_ext : e_open;
    // F: gap in the query ('D'), from the cell to the left
    const int f_open = h_left - O, f_ext = f_left - Eg;
    const int f_is_ext = f_open <= f_ext;
    const int F = f_is_ext ? f_ext : f_open;
    // +A only for equal codes < 4 (N and padding never match)
    const int dsub = h_diag + ((qc == tc && qc < 4) ? A : -Bm);
    const int e1 = max(E, 0), f1 = max(F, 0);
    const int gap1 = max(e1, f1);
    const int H = max(max(dsub, gap1), 0);
    // H source: 0 stop, 1 diagonal (wins a tie with the gap), 2 E, 3 F
    // (F wins an E/F tie)
    const int src = H == 0 ? 0 : (dsub >= gap1 ? 1 : (e1 > f1 ? 2 : 3));
    // bit 4: raw code equality, so N against N walks as '='
    return {H, E, F, src | (e_is_ext << 2) | (f_is_ext << 3) | ((qc == tc) << 4)};
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

template <typename Acc>
__global__ void __launch_bounds__(kThreads) sw_forward_kernel(
    const uint8_t* __restrict__ q_t,    // (Q, B) query codes 0..4
    const uint8_t* __restrict__ t_t,    // (T, B) target codes 0..4
    const int32_t* __restrict__ qlen,   // (B,)
    const int32_t* __restrict__ tlen,   // (B,)
    int Q, int T, int B, int A, int Bm, int O, int Eg,
    uint8_t* __restrict__ dirs,         // (Q, T, B) direction bytes
    Acc* __restrict__ h_row,            // (T, B) scratch: previous row's H
    Acc* __restrict__ e_row,            // (T, B) scratch: previous row's E
    int32_t* __restrict__ score,        // (B,)
    int32_t* __restrict__ t_end,        // (B,)
    int32_t* __restrict__ q_end) {      // (B,)
    constexpr int kNeg = NegInf<Acc>::value;
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const int ql = max(0, min(qlen[b], Q));
    const int tl = max(0, min(tlen[b], T));
    const size_t sB = (size_t)B;

    // row -1: H = 0, E = NEG
    for (int t = 0; t < tl; ++t) {
        h_row[t * sB + b] = 0;
        e_row[t * sB + b] = (Acc)kNeg;
    }

    int best_h = 0, best_t = -1, best_q = 0;
    for (int q = 0; q < ql; ++q) {
        const int qc = q_t[q * sB + b];
        uint8_t* drow = dirs + (size_t)q * T * sB + b;
        int h_diag = 0;      // H(q-1, t-1); column -1 is 0
        int h_left = 0;      // H(q, t-1)
        int f_left = kNeg;   // F(q, t-1)
        int row_h = 0, row_t = -1;
        for (int t = 0; t < tl; ++t) {
            const size_t i = t * sB + b;
            const int h_up = h_row[i];  // H(q-1, t)
            const Cell c = sw_cell(qc, t_t[i], h_diag, h_up, e_row[i], h_left, f_left, A,
                                   Bm, O, Eg);
            drow[t * sB] = (uint8_t)c.dir;
            if (c.H > row_h) {  // strict: the row keeps its smallest t
                row_h = c.H;
                row_t = t;
            }
            h_diag = h_up;
            h_row[i] = (Acc)c.H;
            e_row[i] = (Acc)c.E;
            h_left = c.H;
            f_left = c.F;
        }
        fold_row(row_h, row_t, q, best_h, best_t, best_q);
    }
    // a score-0 pair reports t_end = -1, q_end = 0
    score[b] = best_h;
    t_end[b] = best_t;
    q_end[b] = best_q;
}

// Cross-pair ILP forward: the int32 recurrence of sw_forward_kernel with
// PAIRS pairs on each thread. Replaces the Pallas kernel of
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
// row best, no fold. Outputs equal sw_forward_kernel<int32_t>'s byte for
// byte on valid cells.
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

template <typename Acc>
int launch(const void* q_t, const void* t_t, const void* qlen, const void* tlen,
           int Q, int T, int B, int A, int Bm, int O, int Eg, void* dirs,
           void* h_row, void* e_row, void* score, void* t_end, void* q_end,
           void* stream) {
    if (B > 0) {
        const int blocks = (B + kThreads - 1) / kThreads;
        sw_forward_kernel<Acc><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
            (const uint8_t*)q_t, (const uint8_t*)t_t, (const int32_t*)qlen,
            (const int32_t*)tlen, Q, T, B, A, Bm, O, Eg, (uint8_t*)dirs,
            (Acc*)h_row, (Acc*)e_row, (int32_t*)score, (int32_t*)t_end,
            (int32_t*)q_end);
    }
    return (int)cudaGetLastError();
}

}  // namespace

// h_row and e_row are (T, B) int32 scratch
extern "C" int sw_forward_launch(const void* q_t, const void* t_t,
                                 const void* qlen, const void* tlen, int Q,
                                 int T, int B, int A, int Bm, int O, int Eg,
                                 void* dirs, void* h_row, void* e_row,
                                 void* score, void* t_end, void* q_end,
                                 void* stream) {
    return launch<int32_t>(q_t, t_t, qlen, tlen, Q, T, B, A, Bm, O, Eg, dirs,
                           h_row, e_row, score, t_end, q_end, stream);
}

// h_row and e_row are (T, B) int16 scratch; only for shapes and scores
// within the span bound of pick_dtype
extern "C" int sw_forward_i16_launch(const void* q_t, const void* t_t,
                                     const void* qlen, const void* tlen, int Q,
                                     int T, int B, int A, int Bm, int O,
                                     int Eg, void* dirs, void* h_row,
                                     void* e_row, void* score, void* t_end,
                                     void* q_end, void* stream) {
    return launch<int16_t>(q_t, t_t, qlen, tlen, Q, T, B, A, Bm, O, Eg, dirs,
                           h_row, e_row, score, t_end, q_end, stream);
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
