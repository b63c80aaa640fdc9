// A host emulation of the CUDA features that the port's kernels use
// (rabbitsalign_tpu_torch/csrc/seed_randstrobes.cu, find_runs.cu,
// index_find.cu, sw_forward.cu, syncmers_scan.cu, merge_hits.cu,
// walk_hits.cu), so
// that their sources run on a CPU: tests/torch_cuda_emu.py turns each
// launch into `emu_launch`. The blocks of a launch run one after the
// other, one std::thread a CUDA thread; warp primitives meet at a barrier
// of the warp's 32 threads and __syncthreads at one of the block's. A
// __shared__ variable is a static, which is right only because one block
// runs at a time; atomics need no atomicity for the same reason, so a
// look-back over blocks always finds its predecessor's prefix here.
#pragma once
#include <algorithm>
#include <barrier>
#include <cstdint>
#include <cstring>
#include <cstddef>
#include <memory>
#include <thread>
#include <vector>
using std::max;
using std::min;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __restrict__
#define __align__(x)
#define __shared__ static
struct Dim { unsigned x = 0, y = 0, z = 0; };
inline thread_local Dim threadIdx, blockIdx;
inline Dim blockDim, gridDim;
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaDevAttrMaxSharedMemoryPerBlockOptin, cudaDevAttrMultiProcessorCount };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize };
// the device the launches see: EMU_SMS multiprocessors, each holding
// EMU_BLOCKS_PER_SM blocks of any kernel (small, so that a kernel sized to
// one wave strides over its grid here)
constexpr int EMU_SMS = 2, EMU_BLOCKS_PER_SM = 3;
inline int cudaGetLastError() { return 0; }
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
inline int cudaDeviceGetAttribute(int* v, int attr, int) {
    *v = attr == cudaDevAttrMultiProcessorCount ? EMU_SMS : 232448;
    return 0;
}
template <class K> int cudaFuncSetAttribute(K, int, int) { return 0; }
template <class K> int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) {
    *n = EMU_BLOCKS_PER_SM;
    return 0;
}
struct uint4 { unsigned x, y, z, w; };
struct alignas(16) int4 { int x, y, z, w; };
template <class T> T __ldg(const T* p) { return *p; }
// Hopper's DPX integer instructions, as the CUDA Math API defines them
// (the sums wrap as 32-bit two's complement)
inline int wrap_add(int a, int b) { return (int)((unsigned)a + (unsigned)b); }
inline int __viaddmax_s32(int a, int b, int c) { return max(wrap_add(a, b), c); }
inline int __viaddmax_s32_relu(int a, int b, int c) { return max(max(wrap_add(a, b), c), 0); }
inline int __vimax3_s32(int a, int b, int c) { return max(max(a, b), c); }
inline int __vimax3_s32_relu(int a, int b, int c) { return max(max(max(a, b), c), 0); }
inline int __vimax_s32_relu(int a, int b) { return max(max(a, b), 0); }
inline int cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) { memset(p, v, n); return 0; }
inline void __trap() { abort(); }

struct WarpState {
    std::unique_ptr<std::barrier<>> bar;
    unsigned long long slot[32];
};
inline std::vector<WarpState>* g_warps;
inline std::barrier<>* g_block;
inline unsigned char* g_smem;
inline int lane_id() { return threadIdx.x & 31; }
inline WarpState& my_warp() { return (*g_warps)[threadIdx.x >> 5]; }
inline void __syncwarp() { my_warp().bar->arrive_and_wait(); }
inline void __syncthreads() { g_block->arrive_and_wait(); }
template <class T> T warp_exchange(T v, int src) {
    WarpState& w = my_warp();
    unsigned long long bits = 0;
    memcpy(&bits, &v, sizeof(T));
    w.slot[lane_id()] = bits;
    w.bar->arrive_and_wait();
    T out;
    unsigned long long got = w.slot[src];
    memcpy(&out, &got, sizeof(T));
    w.bar->arrive_and_wait();
    return out;
}
template <class T> T __shfl_sync(unsigned, T v, int src) { return warp_exchange(v, src); }
template <class T> T __shfl_up_sync(unsigned, T v, int o) {
    return warp_exchange(v, lane_id() >= o ? lane_id() - o : lane_id());
}
template <class T> T __shfl_xor_sync(unsigned, T v, int o) { return warp_exchange(v, lane_id() ^ o); }
inline unsigned __ballot_sync(unsigned, bool p) {
    WarpState& w = my_warp();
    w.slot[lane_id()] = p;
    w.bar->arrive_and_wait();
    unsigned m = 0;
    for (int i = 0; i < 32; ++i) m |= (unsigned)(w.slot[i] != 0) << i;
    w.bar->arrive_and_wait();
    return m;
}
inline int __any_sync(unsigned m, bool p) { return __ballot_sync(m, p) != 0; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __popcll(unsigned long long x) { return __builtin_popcountll(x); }
inline int __ffs(int x) { return __builtin_ffs(x); }
inline int __clz(int x) { return x ? __builtin_clz((unsigned)x) : 32; }
inline unsigned long long atomicAdd(unsigned long long* a, unsigned long long v) {
    auto o = *a; *a += v; return o;
}
inline unsigned long long atomicExch(unsigned long long* a, unsigned long long v) {
    auto o = *a; *a = v; return o;
}


// run `grid` blocks one after the other, `block` threads each
template <class K, class... A>
void emu_launch(unsigned grid, unsigned block, size_t smem, K kernel, A... args) {
    blockDim.x = block;
    gridDim.x = grid;
    std::vector<unsigned char> sm(smem + 16);
    g_smem = sm.data();
    for (unsigned bx = 0; bx < grid; ++bx) {
        std::vector<WarpState> warps((block + 31) / 32);
        for (auto& w : warps) w.bar = std::make_unique<std::barrier<>>(32);
        std::barrier<> blk(block);
        g_warps = &warps;
        g_block = &blk;
        std::vector<std::thread> ts;
        for (unsigned t = 0; t < block; ++t)
            ts.emplace_back([=] { threadIdx.x = t; blockIdx.x = bx; kernel(args...); });
        for (auto& t : ts) t.join();
    }
}
