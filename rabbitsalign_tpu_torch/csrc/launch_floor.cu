// An empty kernel for Hopper (sm_90a): what a launch costs the card when
// the kernel does no work. chip_smoke.py times it on the card, at the grids
// of the port's small kernels, as the floor beside their bounds; nothing
// on the mapping path launches it.
#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

// `blocks` blocks of `threads` threads; returns the cudaGetLastError()
// after the launch
extern "C" int empty_launch(int blocks, int threads, void* stream) {
    if (blocks > 0) empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}
