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
// written) and runs ~25 integer operations, so the DP itself is far below
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
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNeg = -(1 << 28);
constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads) sw_forward_kernel(
    const uint8_t* __restrict__ q_t,    // (Q, B) query codes 0..4
    const uint8_t* __restrict__ t_t,    // (T, B) target codes 0..4
    const int32_t* __restrict__ qlen,   // (B,)
    const int32_t* __restrict__ tlen,   // (B,)
    int Q, int T, int B, int A, int Bm, int O, int Eg,
    uint8_t* __restrict__ dirs,         // (Q, T, B) direction bytes
    int32_t* __restrict__ h_row,        // (T, B) scratch: previous row's H
    int32_t* __restrict__ e_row,        // (T, B) scratch: previous row's E
    int32_t* __restrict__ score,        // (B,)
    int32_t* __restrict__ t_end,        // (B,)
    int32_t* __restrict__ q_end) {      // (B,)
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const int ql = max(0, min(qlen[b], Q));
    const int tl = max(0, min(tlen[b], T));
    const size_t sB = (size_t)B;

    // row -1: H = 0, E = NEG
    for (int t = 0; t < tl; ++t) {
        h_row[t * sB + b] = 0;
        e_row[t * sB + b] = kNeg;
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
            const int tc = t_t[i];
            const int h_up = h_row[i];  // H(q-1, t)
            const int e_up = e_row[i];  // E(q-1, t)
            // E: gap in the target ('I'), from the cell above; extension
            // wins a tie with opening
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
            // H source: 0 stop, 1 diagonal (wins a tie with the gap),
            // 2 E, 3 F (F wins an E/F tie)
            const int src = H == 0 ? 0 : (dsub >= gap1 ? 1 : (e1 > f1 ? 2 : 3));
            // bit 4: raw code equality, so N against N walks as '='
            drow[t * sB] = (uint8_t)(src | (e_is_ext << 2) | (f_is_ext << 3) |
                                     ((qc == tc) << 4));
            if (H > row_h) {
                row_h = H;
                row_t = t;
            }
            h_diag = h_up;
            h_row[i] = H;
            e_row[i] = E;
            h_left = H;
            f_left = F;
        }
        if (row_h > best_h || (row_h == best_h && row_t < best_t)) {
            best_h = row_h;
            best_t = row_t;
            best_q = q;
        }
    }
    // a score-0 pair reports t_end = -1, q_end = 0
    score[b] = best_h;
    t_end[b] = best_t;
    q_end[b] = best_q;
}

}  // namespace

extern "C" int sw_forward_launch(const void* q_t, const void* t_t,
                                 const void* qlen, const void* tlen, int Q,
                                 int T, int B, int A, int Bm, int O, int Eg,
                                 void* dirs, void* h_row, void* e_row,
                                 void* score, void* t_end, void* q_end,
                                 void* stream) {
    if (B > 0) {
        const int blocks = (B + kThreads - 1) / kThreads;
        sw_forward_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
            (const uint8_t*)q_t, (const uint8_t*)t_t, (const int32_t*)qlen,
            (const int32_t*)tlen, Q, T, B, A, Bm, O, Eg, (uint8_t*)dirs,
            (int32_t*)h_row, (int32_t*)e_row, (int32_t*)score,
            (int32_t*)t_end, (int32_t*)q_end);
    }
    return (int)cudaGetLastError();
}
