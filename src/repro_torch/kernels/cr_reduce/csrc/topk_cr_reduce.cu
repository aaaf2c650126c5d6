// Weighted scatter-sum of S top-k messages into a fresh dense (M, R)
// output, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/cr_reduce/kernel.py::topk_cr_reduce (Pallas
// TPU).
//
// Computes out = 0, then for the messages s = 0..S-1 in order:
//     out[m, idx[s, m, j]] += float(vals[s, m, j]) * w[s]
// with out (M, R) f32, vals (S, M, k) bf16 or f32, idx (S, M, k) int32 and
// w (S,) f32 read on the device.  A zero weight is not skipped: inf * 0
// adds NaN, as in the reference.
//
// What bounds it: device-memory bytes -- the zero fill writes the whole
// (M, R) output (4 bytes an entry) and each message entry reads 2 or 4
// bytes of value and 4 of index and adds into one output word, in an order
// the indices choose.  No arithmetic to speak of.
//
// Design: the Pallas kernel gives one program a row block and streams all
// messages through it; at M = 1 (the training path) that is one program.
// Here the output is first filled with zeros by a grid-stride kernel of
// 16-byte stores, then each message is one launch (S launches, in message
// order on the stream) whose grid covers its M*k entries, one thread an
// entry doing atomicAdd(out + target, v * w).  The product is rounded first
// (__fmul_rn: no FMA contraction), then added with round-to-nearest, as the
// plain version does.  A top-k message carries unique indices within a
// row, so each output word takes at most one add per launch and launches
// are ordered: the result is bitwise the plain version's and the same from
// run to run.  Duplicate indices inside one message still all land (the
// adds are atomic), but the order of their adds, and so the rounding of
// their sum, is then not fixed.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__global__ void topk_reduce_zero_kernel(float* __restrict__ out, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t n4 = n / 4;
  float4* out4 = reinterpret_cast<float4*>(out);
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride)
    out4[i] = z;
  for (int64_t i = n4 * 4 + (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride)
    out[i] = 0.f;
}

template <typename T>
__global__ void topk_reduce_scatter_kernel(float* __restrict__ out,
                                           const T* __restrict__ vals,
                                           const int32_t* __restrict__ idx,
                                           const float* __restrict__ weights,
                                           int64_t s, int64_t M, int64_t R,
                                           int64_t k) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t n = M * k;
  if (e >= n) return;
  const int64_t m = e / k;
  const int64_t off = s * n + e;
  const float v = __fmul_rn(to_float(vals[off]), weights[s]);
  atomicAdd(out + m * R + idx[off], v);
}

template <typename T>
int launch(float* out, const T* vals, const int* idx, const float* weights,
           long long S, long long M, long long R, long long k,
           cudaStream_t stream) {
  const int64_t total = (int64_t)M * R;
  const int threads = 256;
  if (total > 0) {
    // 16-byte stores; torch's allocations are 16-byte aligned
    const int64_t want = (total / 4 + threads - 1) / threads;
    const unsigned blocks = (unsigned)(want < 132 * 16 ? (want > 0 ? want : 1)
                                                       : 132 * 16);
    topk_reduce_zero_kernel<<<blocks, threads, 0, stream>>>(out, total);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t n = (int64_t)M * k;
  if (n == 0 || total == 0) return 0;
  const int64_t blocks = (n + threads - 1) / threads;
  for (int64_t s = 0; s < S; ++s) {
    topk_reduce_scatter_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
        out, vals, idx, weights, s, M, R, k);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

extern "C" {

// vals_bf16 != 0: vals are bfloat16, else float32.  Returns the first
// cudaError_t seen (0 on success).
int topk_cr_reduce_launch(float* out, const void* vals, int vals_bf16,
                          const int* idx, const float* weights, long long S,
                          long long M, long long R, long long k,
                          void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (vals_bf16)
    return launch(out, static_cast<const __nv_bfloat16*>(vals), idx, weights,
                  S, M, R, k, stream);
  return launch(out, static_cast<const float*>(vals), idx, weights, S, M, R,
                k, stream);
}

}  // extern "C"
