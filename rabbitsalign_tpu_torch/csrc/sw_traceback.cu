// Traceback walk with in-walk run-length encoding, for Hopper (sm_90a).
//
// Replaces the Pallas kernel of rabbitsalign_tpu/ops/tb_pallas.py
// (`_kernel` + `_run_block`, launched by `_sw_traceback_pallas_core`),
// whose semantics are stated by its lax.scan twin
// rabbitsalign_tpu/ops/extend_portable.py:traceback_rle.
//
// Design: one thread per pair walks from (t_end, q_end) over the
// (B, Q, T) direction bytes of sw_forward.cu (its pair's own contiguous
// Q x T plane) until it reaches a stop cell
// or leaves the matrix. The walk keeps its current (op, length) run in
// registers; each completed run goes to slot RLE_M-1-n (descending), so
// ascending slots hold the cigar in forward order. Past RLE_M runs the
// walk keeps counting but stores nothing (the packer then marks the pair
// 0xFFFF and the host re-aligns it).
//
// What bounds it on the card: a walk is at most Q+T-1 dependent one-byte
// loads, and neighbouring threads read far-apart cells, so each step pays
// a full memory latency; compute is negligible. The kernel is short next
// to the forward pass (it touches ~Q+T cells per pair where the forward
// touches Q*T), so it is left simple.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRleM = 32;  // = tb_cuda.RLE_M = engine.cpp chunk_set_device_results M
constexpr int kOpEq = 1, kOpX = 2, kOpI = 3, kOpD = 4;
constexpr int kLayerH = 0, kLayerE = 1, kLayerF = 2;

__global__ void __launch_bounds__(kThreads) sw_traceback_kernel(
    const uint8_t* __restrict__ dirs,     // (B, Q, T)
    const int32_t* __restrict__ score,    // (B,)
    const int32_t* __restrict__ t_end,    // (B,)
    const int32_t* __restrict__ q_end,    // (B,)
    int Q, int T, int B,
    int32_t* __restrict__ runs_op,        // (RLE_M, B)
    int32_t* __restrict__ runs_len,       // (RLE_M, B)
    int32_t* __restrict__ meta) {         // (8, B): t_begin q_begin edits n_runs 0..
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const size_t sB = (size_t)B;
    for (int r = 0; r < kRleM; ++r) {
        runs_op[r * sB + b] = 0;
        runs_len[r * sB + b] = 0;
    }
    int fin_t = 0, fin_q = 0, edits = 0, nrun = 0;
    if (score[b] > 0) {
        int t = t_end[b], q = q_end[b], layer = kLayerH;
        int cur_op = 0, cur_len = 0;
        for (;;) {
            const int cell = dirs[((size_t)b * Q + q) * T + t];
            const int src = cell & 3;
            int op;
            if (layer == kLayerH) {
                op = src == 0 ? 0
                     : src == 1 ? (((cell >> 4) & 1) ? kOpEq : kOpX)
                     : src == 2 ? kOpI
                                : kOpD;
            } else {
                op = layer == kLayerE ? kOpI : kOpD;
            }
            if (op == 0) {  // stop cell: the alignment begins after it
                fin_t = t + 1;
                fin_q = q + 1;
                break;
            }
            if (op != cur_op) {
                if (cur_op) {
                    if (nrun < kRleM) {
                        runs_op[(kRleM - 1 - nrun) * sB + b] = cur_op;
                        runs_len[(kRleM - 1 - nrun) * sB + b] = cur_len;
                    }
                    ++nrun;
                }
                cur_op = op;
                cur_len = 1;
            } else {
                ++cur_len;
            }
            if (op != kOpEq) ++edits;
            const bool diag = op == kOpEq || op == kOpX;
            const int nt = t - (diag || op == kOpD);
            const int nq = q - (diag || op == kOpI);
            if (nt < 0 || nq < 0) {  // off the edge: begin = moved cell + 1
                fin_t = nt + 1;
                fin_q = nq + 1;
                break;
            }
            // stay in the gap layer while this cell's gap was an extension
            layer = diag ? kLayerH
                    : op == kOpI ? (((cell >> 2) & 1) ? kLayerE : kLayerH)
                                 : (((cell >> 3) & 1) ? kLayerF : kLayerH);
            t = nt;
            q = nq;
        }
        if (cur_op) {  // flush the run in progress
            if (nrun < kRleM) {
                runs_op[(kRleM - 1 - nrun) * sB + b] = cur_op;
                runs_len[(kRleM - 1 - nrun) * sB + b] = cur_len;
            }
            ++nrun;
        }
    }
    meta[0 * sB + b] = fin_t;
    meta[1 * sB + b] = fin_q;
    meta[2 * sB + b] = edits;
    meta[3 * sB + b] = nrun;
    for (int r = 4; r < 8; ++r) meta[r * sB + b] = 0;
}

}  // namespace

extern "C" int sw_traceback_launch(const void* dirs, const void* score,
                                   const void* t_end, const void* q_end,
                                   int Q, int T, int B, void* runs_op,
                                   void* runs_len, void* meta, void* stream) {
    if (B > 0) {
        const int blocks = (B + kThreads - 1) / kThreads;
        sw_traceback_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
            (const uint8_t*)dirs, (const int32_t*)score,
            (const int32_t*)t_end, (const int32_t*)q_end, Q, T, B,
            (int32_t*)runs_op, (int32_t*)runs_len, (int32_t*)meta);
    }
    return (int)cudaGetLastError();
}
