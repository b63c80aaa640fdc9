// One extend batch of the main path, from the engine's q2 fill to its
// packed output in host memory, enqueued by one call on one stream:
//
//   1. the q2 upload, (Qp + Qm + 8, B) u8 with Qp = ceil(Q/4) and Qm =
//      ceil(Q/8), copied from pinned host memory to the device;
//   2. the forward on it (sw_forward_q2_launch, or its int16 twin), which
//      decodes the queries and gathers the targets from the flat resident
//      genome itself;
//   3. the traceback's packed epilogue (sw_traceback_packed_launch), which
//      writes the engine's (kOutRows, B) transfer rows;
//   4. those rows copied back into pinned host memory, right after the
//      upload's bytes.
//
// The caller allocates everything (`scratch` on the device, of
// extend_q2_scratch_bytes, and the pinned host block) and records an event
// after the call; this code allocates nothing and waits for nothing, so the
// batch costs the host one call into the library and two kernel launches.
// ops/extend_device.py:extend_q2_enqueue is its wrapper. The device-side
// work is the same as extend_batch_packed_resident_q2 (unpack_q2,
// sw_forward, sw_traceback_packed), byte for byte.
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "extend_layout.cuh"

extern "C" int sw_forward_q2_launch(const void* q2, const void* ref, long long ref_len, int Q,
                                    int T, int B, int A, int Bm, int O, int Eg, void* dirs,
                                    void* score, void* t_end, void* q_end, void* stream);
extern "C" int sw_forward_q2_i16_launch(const void* q2, const void* ref, long long ref_len,
                                        int Q, int T, int B, int A, int Bm, int O, int Eg,
                                        void* dirs, void* score, void* t_end, void* q_end,
                                        void* stream);
extern "C" int sw_traceback_packed_launch(const void* dirs, const void* score,
                                          const void* t_end, const void* q_end, int Q, int T,
                                          int B, void* out, void* stream);

namespace {

size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

// The scratch of one batch, from offset 0, each part from a 16-byte
// boundary: the dirs (B, Q, T), score, t_end and q_end (B,) int32, the
// uploaded q2 rows and the packed output.
struct Layout {
    size_t q2_bytes, dirs, res, q2, out, need;

    Layout(int Q, int T, int B) {
        const size_t nB = (size_t)B;
        q2_bytes = ((size_t)(Q + 3) / 4 + (size_t)(Q + 7) / 8 + 8) * nB;
        dirs = 0;
        res = align16(nB * (size_t)Q * (size_t)T);
        q2 = res + align16(3 * sizeof(int32_t) * nB);
        out = q2 + align16(q2_bytes);
        need = out + kOutRows * nB;
    }
};

bool bad_shape(int Q, int T, int B) { return Q < 1 || Q > 512 || T < 1 || B < 0; }

}  // namespace

// *bytes = the scratch that extend_q2_enqueue takes at (Q, T, B);
// cudaErrorInvalidValue for a shape it refuses.
extern "C" int extend_q2_scratch_bytes(int Q, int T, int B, long long* bytes) {
    if (bad_shape(Q, T, B)) return (int)cudaErrorInvalidValue;
    *bytes = (long long)Layout(Q, T, B).need;
    return (int)cudaSuccess;
}

// host: the pinned block, the q2 upload's bytes then room for the
// kOutRows * B output bytes. scratch: the device buffer of
// extend_q2_scratch_bytes, 16-byte aligned. ref: the flat resident genome
// of ref_len codes on `device`, whose stream `stream` is. i16: the int16
// configuration of the forward. Returns the first CUDA error
// (cudaErrorInvalidValue, with nothing enqueued, for a scratch too small
// or a shape the forward refuses).
extern "C" int extend_q2_enqueue(void* host, void* scratch, long long scratch_bytes,
                                 const void* ref, long long ref_len, int Q, int T, int B, int A,
                                 int Bm, int O, int Eg, int i16, int device, void* stream) {
    if (bad_shape(Q, T, B) || ref_len < 1 || scratch_bytes < 0)
        return (int)cudaErrorInvalidValue;
    const Layout at(Q, T, B);
    if ((size_t)scratch_bytes < at.need) return (int)cudaErrorInvalidValue;
    if (B == 0) return (int)cudaSuccess;
    const size_t nB = (size_t)B;
    uint8_t* base = (uint8_t*)scratch;
    uint8_t* dirs = base + at.dirs;
    int32_t* res = (int32_t*)(base + at.res);
    uint8_t* q2 = base + at.q2;
    uint8_t* out = base + at.out;
    const cudaStream_t s = (cudaStream_t)stream;
    int prev = -1;
    cudaError_t err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    int rc = (int)cudaMemcpyAsync(q2, host, at.q2_bytes, cudaMemcpyHostToDevice, s);
    if (rc == 0)
        rc = (i16 ? sw_forward_q2_i16_launch : sw_forward_q2_launch)(
            q2, ref, ref_len, Q, T, B, A, Bm, O, Eg, dirs, res, res + nB, res + 2 * nB, stream);
    if (rc == 0)
        rc = sw_traceback_packed_launch(dirs, res, res + nB, res + 2 * nB, Q, T, B, out, stream);
    if (rc == 0)
        rc = (int)cudaMemcpyAsync((uint8_t*)host + at.q2_bytes, out, kOutRows * nB,
                                  cudaMemcpyDeviceToHost, s);
    if (prev != device) cudaSetDevice(prev);
    return rc;
}
