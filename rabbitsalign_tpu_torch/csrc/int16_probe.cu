// Ordered 16-bit compare probe for Hopper (sm_90a).
//
// Replaces the Pallas probe of rabbitsalign_tpu/ops/sw_pallas.py
// (`probe_int16_lowering`, kernel body :99-102): on an (R, C) int16 tile,
//
//     out = where(a < roll(a, 1, axis 0), a, roll(a, 1, axis 0))
//
// where roll(a, 1, 0)[r] = a[(r - 1) mod R]. The TPU probe asks whether
// its compiler lowers an ordered int16 vector compare at all; here the
// question is whether the packed signed 16-bit compare that a later
// s16x2 forward would use (`__vcmplts2`: two int16 lanes per 32-bit word,
// 0xFFFF per lane where a < b) computes the right answer, including at
// -32768, 32767 and on equal lanes. So each thread loads one 32-bit word
// (two neighbouring columns) of row r and of row r - 1, compares them
// lane-wise with `__vcmplts2`, and selects with the mask.
//
// Bound: none that matters; one (16, 128) tile is 4 KiB, one block.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void int16_probe_kernel(const uint32_t* __restrict__ a,  // (R, C/2)
                                   uint32_t* __restrict__ out,      // (R, C/2)
                                   int R, int W) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= R * W) return;
    const int r = i / W, w = i % W;
    const uint32_t x = a[i];
    const uint32_t y = a[((r + R - 1) % R) * W + w];  // roll by 1 along rows
    const uint32_t lt = __vcmplts2(x, y);             // 0xFFFF per lane: x < y
    out[i] = (x & lt) | (y & ~lt);
}

}  // namespace

// a and out are (R, C) int16, C even, row-major
extern "C" int int16_probe_launch(const void* a, void* out, int R, int C,
                                  void* stream) {
    const int W = C / 2;
    const int n = R * W;
    if (n > 0) {
        const int threads = 256;
        int16_probe_kernel<<<(n + threads - 1) / threads, threads, 0,
                             (cudaStream_t)stream>>>(
            (const uint32_t*)a, (uint32_t*)out, R, W);
    }
    return (int)cudaGetLastError();
}
