// Fused decompress-deposit of S top-k messages into a delay ring, for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/cr_reduce/kernel.py::topk_cr_deposit (Pallas
// TPU).
//
// Computes, for the messages s = 0..S-1 in order:
//     acc[slots[s], m, idx[s, m, j]] += vals[s, m, j] * w[s]
// with acc (cap, M, R) f32 updated in place (the reference donates it),
// vals (S, M, k) f32, idx (S, M, k) int32, slots (S,) int32 and w (S,) f32
// read on the device (no host round trip).  A zero weight adds zeros.
//
// What bounds it: device-memory traffic of a sparse scatter — 8 bytes of
// payload per entry plus a read-modify-write of one acc word per entry, in
// random order over up to 1.4 GB of ring.  No arithmetic to speak of.
//
// Design: the Pallas kernel gives one program a row block and streams all
// messages through it; at M = 1 (the training path) that is one program.
// Here each message is one launch (S launches, in message order on the
// stream) whose grid covers its M*k entries, one thread per entry doing
// atomicAdd(acc + target, vals * w).  The product is rounded first
// (__fmul_rn: no FMA contraction), then added with round-to-nearest, which
// is what the plain version does.  The indices a top-k message carries are
// unique within a row, so every acc element gets at most one add per
// launch and launches are ordered: the result is deterministic and equal
// bit for bit to the plain version.  Duplicate indices inside one message
// still all land (the adds are atomic); only their order is then free.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void deposit_kernel(float* __restrict__ acc,
                               const float* __restrict__ vals,
                               const int32_t* __restrict__ idx,
                               const int32_t* __restrict__ slots,
                               const float* __restrict__ weights, int64_t s,
                               int64_t M, int64_t R, int64_t k) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t n = M * k;
  if (e >= n) return;
  const int64_t m = e / k;
  const int64_t off = s * n + e;
  const float v = __fmul_rn(vals[off], weights[s]);
  const int64_t slot = slots[s];
  atomicAdd(acc + (slot * M + m) * R + idx[off], v);
}

}  // namespace

extern "C" {

// Returns the first cudaError_t seen (0 on success).
int topk_cr_deposit_launch(float* acc, const float* vals, const int* idx,
                           const int* slots, const float* weights,
                           long long S, long long M, long long R,
                           long long k, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int64_t n = M * k;
  if (n == 0) return 0;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  for (int64_t s = 0; s < S; ++s) {
    deposit_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
        acc, vals, idx, slots, weights, s, M, R, k);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // extern "C"
