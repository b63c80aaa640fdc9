// Traceback walk with in-walk run-length encoding, for Hopper (sm_90a).
//
// Replaces the Pallas kernel of rabbitsalign_tpu/ops/tb_pallas.py
// (`_kernel` + `_run_block`, launched by `_sw_traceback_pallas_core` at
// :240, its pallas_call at :254), whose semantics are stated by its lax.scan
// twin rabbitsalign_tpu/ops/extend_portable.py:traceback_rle. It walks the
// (B, Q, T) direction bytes of sw_forward.cu (each pair's own contiguous
// Q x T plane) from (t_end, q_end) until it reaches a stop cell or leaves
// the matrix, keeping the current (op, length) run; each completed run goes
// to slot RLE_M-1-n (descending), so ascending slots hold the cigar in
// forward order. Past RLE_M runs the walk keeps counting but keeps nothing
// (the packed output then marks the pair 0xFFFF and the host re-aligns it).
//
// What bounds it on the card: latency. A walk is a chain of up to Q+T-1
// dependent steps, each a one-byte read whose address depends on the byte
// before; the bytes and operations are tiny (tens of KB and a few hundred
// thousand integer operations at (152, 256) x 2048). When one thread per
// pair read each byte from device memory, every step paid a full memory
// round trip (about 0.2-0.4 us) and the kernel ran at 0.0035 of its bound.
//
// What the design does about it:
// - One warp per pair, 4 pairs a block: 2048 pairs are 512 blocks over all
//   132 SMs. The walk's state (q, t, layer, the run in progress, edits,
//   n_runs) is warp-uniform, so every branch is uniform.
// - Tiles. Each step moves t or q or both down by one, so from (q0, t0) the
//   next K steps stay in rows [q0-K+1, q0] x columns [t0-K+1, t0]. The warp
//   copies that window of its plane into a per-warp shared-memory tile
//   (clipped at row 0 and column 0) and walks it. With T % 16 == 0 (every
//   engine bucket) the columns start at t0-K+1 rounded down to 16 and the
//   lanes copy 16 bytes each with cp.async; otherwise they copy single bytes.
// - Diagonal runs in one go. In layer H, lane i reads the i-th cell down the
//   diagonal (up to 32, and only as far as the tile is sure to reach); a
//   ballot finds the L leading diagonal cells, and the warp takes those L
//   steps at once: a second ballot of their match bits gives the EQ/X run
//   boundaries, each boundary lane closes one run, and the counts move by
//   popc. A gap step, a gap-layer step and the stop cell go one at a time,
//   all lanes reading the same byte. A 150 bp read's walk is then a handful
//   of such rounds instead of ~150 dependent steps.
// - Refill. A second tile is prefetched with cp.async while the walk runs:
//   the one the diagonal predicts, anchored at (q0-K, t0-K+K/4) (the K/4
//   columns of slack keep a walk that drifted right by an insertion inside
//   it; a drift left by deletions is covered by the column rounding). When
//   the walk leaves its tile it switches to the prefetched one if it holds
//   the new cell, else loads a tile anchored at the new cell synchronously
//   (a long gap that leaves sideways, or T % 16 != 0, where nothing is
//   prefetched), and then prefetches the next diagonal tile.
// - Run slots live in the warp's 32 shared-memory words (the n-th completed
//   run at slot RLE_M-1-n, written by whichever lane closed it), so no
//   (RLE_M, B) scratch goes to device memory; after the walk lane r holds
//   slot r. The lanes store the outputs, one epilogue per instantiation:
//   runs_op / runs_len (RLE_M, B) i32 and meta (8, B) i32 (the tb_pallas
//   contract), or the engine's (2 RLE_M + 14, B) u8 transfer rows, byte for
//   byte those of ops/tb_cuda.py:pack_rle_output (78 bytes a pair instead of
//   288, and no torch pack after the kernel). The packed rows of a block's
//   4 pairs meet in shared memory and leave one 4-byte word a row, not 4
//   single bytes.
// What is left is mostly fixed latency: the launch, the read of score, t_end
// and q_end, then the first tile's copy (its address depends on them), the
// tile switches of a long walk, and the epilogue's stores. Cells outside
// qlen x tlen may be copied into a tile (the forward leaves them undefined)
// but the walk never acts on them.
#include <cstdint>
#include <cuda_runtime.h>

#include "extend_layout.cuh"

namespace {

constexpr int kWarps = 4;  // pairs (warps) per block
constexpr int kOpEq = 1, kOpX = 2;  // then I = 3, D = 4: a gap's op is its source + 1
// A direction byte's source (bits 0-1): 0 stop, 1 diagonal (bit 4: a
// match), 2 insertion (up a row; bit 2: E came by extension), 3 deletion
// (left a column; bit 3: F came by extension).
constexpr int kSrcStop = 0, kSrcDiag = 1, kSrcI = 2;
// The walk's layer: H (the cell's own source), else the source that its gap
// layer forces, 2 in E and 3 in F.
constexpr int kLayerH = 0;

// A tile's rows, K (64 rows were no faster on an H100 at the (152, 256)
// bucket and take three times the shared memory), and its row stride W: the
// K columns a walk can use, rounded down at the start to 16 bytes, in whole
// 16-byte chunks.
constexpr int K = 32;
constexpr int W = ((K + 14) / 16 + 1) * 16;

// Rows [q_lo, q_hi] x columns [t_lo, t_hi] of the pair's plane, held in a
// tile at row q - q_lo, column t - t_lo. An empty tile has q_hi < q_lo.
struct Tile {
    int q_lo, q_hi, t_lo, t_hi;
};
__device__ __forceinline__ bool holds(const Tile& w, int q, int t) {
    return q >= w.q_lo && q <= w.q_hi && t >= w.t_lo && t <= w.t_hi;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start copying the tile anchored at (aq, at) (its bottom-right corner) into
// buf: 16-byte cp.async chunks when `vec` (then complete after
// cp_async_wait_all), else single bytes (complete on return). The caller
// makes the copies visible to the warp with __syncwarp.
__device__ __forceinline__ Tile load_tile(uint8_t* buf, const uint8_t* plane, int aq, int at,
                                          int T, bool vec, int lane) {
    const Tile w = {max(0, aq - K + 1), aq, vec ? max(0, at - K + 1) & ~15 : max(0, at - K + 1),
                    at};
    const int rows = aq - w.q_lo + 1;
    const uint8_t* src = plane + (size_t)w.q_lo * T + w.t_lo;
    if (vec) {
        const int chunks = ((at - w.t_lo) >> 4) + 1;  // the last one ends at (at | 15) < T
        for (int i = lane; i < rows * chunks; i += 32) {
            const int r = i / chunks, c = i - r * chunks;
            cp_async16(buf + r * W + c * 16, src + (size_t)r * T + c * 16);
        }
    } else {
        const int cols = at - w.t_lo + 1;
        for (int i = lane; i < rows * cols; i += 32) {
            const int r = i / cols, c = i - r * cols;
            buf[r * W + c] = src[(size_t)r * T + c];
        }
    }
    return w;
}

// The tile the diagonal predicts after `w`, started into buf (only on the
// 16-byte path, and only where it holds a cell of the matrix)
__device__ __forceinline__ Tile prefetch(uint8_t* buf, const uint8_t* plane, const Tile& w,
                                         int T, bool vec, int lane) {
    const int aq = w.q_hi - K, at = w.t_hi - K + K / 4;
    if (!vec || aq < 0 || at < 0) return Tile{0, -1, 0, -1};  // empty
    return load_tile(buf, plane, aq, at, T, true, lane);
}

template <bool kPacked>
__global__ void __launch_bounds__(kWarps * 32) sw_traceback_kernel(
    const uint8_t* __restrict__ dirs,     // (B, Q, T)
    const int32_t* __restrict__ score,    // (B,)
    const int32_t* __restrict__ t_end,    // (B,)
    const int32_t* __restrict__ q_end,    // (B,)
    int Q, int T, int B,
    int32_t* __restrict__ runs_op,        // (RLE_M, B), unless kPacked
    int32_t* __restrict__ runs_len,       // (RLE_M, B), unless kPacked
    int32_t* __restrict__ meta,           // (8, B) t_begin q_begin edits n_runs 0.., unless kPacked
    uint8_t* __restrict__ packed) {       // (2 RLE_M + 14, B), if kPacked
    __shared__ __align__(16) uint8_t tiles[kWarps][2][K * W];
    __shared__ int slots[kWarps][kRleM];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int b = blockIdx.x * kWarps + warp;
    const bool live = b < B;  // a warp past B walks nothing (and stores nothing)
    const size_t sB = (size_t)B;
    const int sc = live ? score[b] : 0, te = live ? t_end[b] : 0, qe = live ? q_end[b] : 0;
    int my_op = 0, my_len = 0;  // slot `lane` of the pair's runs, read after the walk
    int fin_t = 0, fin_q = 0, edits = 0, nrun = 0;
    if (sc > 0) {
        const uint8_t* plane = dirs + (size_t)b * Q * T;
        const bool vec = (T & 15) == 0 && ((uintptr_t)dirs & 15) == 0;
        uint8_t* cur_buf = tiles[warp][0];
        uint8_t* pre_buf = tiles[warp][1];
        int* const slot = slots[warp];  // completed run n at slot RLE_M-1-n: (len << 3) | op
        slot[lane] = 0;
        int t = te, q = qe;
        int layer = kLayerH;
        int cur_op = 0, cur_len = 0;
        Tile cur = load_tile(cur_buf, plane, q, t, T, vec, lane);
        cp_async_wait_all();
        __syncwarp();
        Tile pre = prefetch(pre_buf, plane, cur, T, vec, lane);
        int s = kSrcDiag;  // the last single step's source (kSrcStop ends the walk)
        for (;;) {
            // A step moves q or t (or both) down by one, so the next n steps
            // read cells of this tile: no bounds check inside the run.
            int n = min(q - cur.q_lo, t - cur.t_lo) + 1;
            int off = (q - cur.q_lo) * W + (t - cur.t_lo);
            while (n > 0) {
                if (layer == kLayerH) {
                    // Lane i reads the i-th cell down the diagonal; the
                    // leading L diagonal cells are L steps taken at once.
                    const int m = min(n, 32);
                    const int c = lane < m ? cur_buf[off - lane * (W + 1)] : kSrcStop;
                    const unsigned diag = __ballot_sync(~0u, (c & 3) == kSrcDiag);
                    const int L = diag == ~0u ? 32 : __ffs(~diag) - 1;
                    if (L > 0) {
                        const unsigned live = L == 32 ? ~0u : (1u << L) - 1;
                        const unsigned eq = __ballot_sync(~0u, (c >> 4) & 1) & live;
                        // Run boundaries: lanes whose op differs from the
                        // lane before, lane 0 against the run in progress.
                        const unsigned bnd = ((eq ^ (eq << 1)) & live & ~1u) |
                                             (((eq & 1) ? kOpEq : kOpX) != cur_op);
                        const unsigned before = bnd & ((1u << lane) - 1);
                        if (((bnd >> lane) & 1) && (before || cur_op)) {
                            // this lane closes the run in progress, the
                            // (popc(before) - (cur_op == 0))-th of the chunk
                            const int p = 31 - __clz(before);  // -1 if none
                            const int op = before ? kOpX - ((eq >> p) & 1) : cur_op;
                            const int len = before ? lane - p : cur_len + lane;
                            const int r = kRleM - 1 - nrun - __popc(before) + (cur_op == 0);
                            if (r >= 0) slot[r] = (len << 3) | op;
                        }
                        nrun += __popc(bnd) - (cur_op == 0);
                        cur_len = bnd ? L - (31 - __clz(bnd)) : cur_len + L;
                        cur_op = kOpX - ((eq >> (L - 1)) & 1);
                        edits += L - __popc(eq);
                        off -= L * (W + 1);
                        q -= L;
                        t -= L;
                        n -= L;
                        continue;
                    }
                }
                // one step: a gap, or the stop cell
                const int cell = cur_buf[off];
                // the step's source: the cell's own in layer H (0 stops the
                // walk), else the gap layer's
                s = layer == kLayerH ? cell & 3 : layer;
                if (s == kSrcStop) break;
                const int op = s + 1;  // I or D
                if (op != cur_op) {
                    // close the run in progress (none before the first)
                    if (cur_op && nrun < kRleM) slot[kRleM - 1 - nrun] = (cur_len << 3) | cur_op;
                    nrun += cur_op != 0;
                    cur_op = op;
                    cur_len = 0;
                }
                ++cur_len;
                ++edits;
                if (s == kSrcI) {  // up a row
                    off -= W;
                    --q;
                } else {  // left a column
                    --off;
                    --t;
                }
                // stay in the gap layer while this cell's gap was an extension
                layer = (cell >> s) & 1 ? s : kLayerH;
                --n;
            }
            // a stop cell, or off the edge: the alignment begins at the cell + 1
            if (s == kSrcStop || q < 0 || t < 0) {
                fin_t = t + 1;
                fin_q = q + 1;
                break;
            }
            if (q < cur.q_lo || t < cur.t_lo) {  // left the tile (a walk never moves up or right)
                cp_async_wait_all();              // the prefetch has landed
                __syncwarp();                     // and no lane still reads cur_buf
                if (holds(pre, q, t)) {
                    cur = pre;
                    uint8_t* x = cur_buf;
                    cur_buf = pre_buf;
                    pre_buf = x;
                } else {
                    cur = load_tile(cur_buf, plane, q, t, T, vec, lane);
                    cp_async_wait_all();
                    __syncwarp();
                }
                pre = prefetch(pre_buf, plane, cur, T, vec, lane);
            }
        }
        if (cur_op) {  // flush the run in progress
            if (nrun < kRleM) slot[kRleM - 1 - nrun] = (cur_len << 3) | cur_op;
            ++nrun;
        }
        cp_async_wait_all();  // no copy may land after the block has left the SM
        __syncwarp();
        my_op = slot[lane] & 7;
        my_len = slot[lane] >> 3;
    }
    if constexpr (kPacked) {
        // rows [0, M): length lo byte; [M, 2M): (op << 5) | (length >> 8);
        // then score, t_end, q_end, t_begin, q_begin, edits, n_runs (0xFFFF
        // past RLE_M runs) as u16 (lo, hi) row pairs, two's complement.
        // The block's kWarps columns meet in shared memory, and each row
        // leaves as one 4-byte store where B % 4 == 0 (every engine batch).
        static_assert(kWarps == 4, "a row of the block's columns is one 32-bit word");
        __shared__ __align__(4) uint8_t cols[kOutRows][kWarps];
        cols[lane][warp] = (uint8_t)(my_len & 0xFF);
        cols[kRleM + lane][warp] = (uint8_t)((my_op << 5) | ((my_len >> 8) & 0x1F));
        if (lane < kOutRows - 2 * kRleM) {
            const int f = lane >> 1;
            const int v = f == 0   ? sc
                          : f == 1 ? te
                          : f == 2 ? qe
                          : f == 3 ? fin_t
                          : f == 4 ? fin_q
                          : f == 5 ? edits
                                   : (nrun > kRleM ? 0xFFFF : nrun);
            cols[2 * kRleM + lane][warp] = (uint8_t)((v >> ((lane & 1) * 8)) & 0xFF);
        }
        __syncthreads();
        const int b0 = blockIdx.x * kWarps;
        const bool words = b0 + kWarps <= B && (B & 3) == 0 && ((uintptr_t)packed & 3) == 0;
        for (int r = threadIdx.x; r < kOutRows; r += kWarps * 32) {
            uint8_t* dst = packed + r * sB + b0;
            if (words) {
                *reinterpret_cast<uint32_t*>(dst) = *reinterpret_cast<const uint32_t*>(cols[r]);
            } else {
                for (int w = 0; w < kWarps && b0 + w < B; ++w) dst[w] = cols[r][w];
            }
        }
    } else {
        if (!live) return;
        runs_op[lane * sB + b] = my_op;
        runs_len[lane * sB + b] = my_len;
        if (lane < 8)
            meta[lane * sB + b] = lane == 0   ? fin_t
                                  : lane == 1 ? fin_q
                                  : lane == 2 ? edits
                                  : lane == 3 ? nrun
                                              : 0;
    }
}

template <bool kPacked>
int launch(const void* dirs, const void* score, const void* t_end, const void* q_end, int Q,
           int T, int B, void* runs_op, void* runs_len, void* meta, void* packed, void* stream) {
    if (B > 0) {
        sw_traceback_kernel<kPacked><<<(B + kWarps - 1) / kWarps, kWarps * 32, 0,
                                       (cudaStream_t)stream>>>(
            (const uint8_t*)dirs, (const int32_t*)score, (const int32_t*)t_end,
            (const int32_t*)q_end, Q, T, B, (int32_t*)runs_op, (int32_t*)runs_len,
            (int32_t*)meta, (uint8_t*)packed);
    }
    return (int)cudaGetLastError();
}

}  // namespace

// The tb_pallas contract: runs_op, runs_len (RLE_M, B) i32 and meta (8, B) i32.
extern "C" int sw_traceback_launch(const void* dirs, const void* score, const void* t_end,
                                   const void* q_end, int Q, int T, int B, void* runs_op,
                                   void* runs_len, void* meta, void* stream) {
    return launch<false>(dirs, score, t_end, q_end, Q, T, B, runs_op, runs_len, meta, nullptr,
                         stream);
}

// The engine's packed transfer rows: out (2 RLE_M + 14, B) u8.
extern "C" int sw_traceback_packed_launch(const void* dirs, const void* score,
                                          const void* t_end, const void* q_end, int Q, int T,
                                          int B, void* out, void* stream) {
    return launch<true>(dirs, score, t_end, q_end, Q, T, B, nullptr, nullptr, nullptr, out,
                        stream);
}
