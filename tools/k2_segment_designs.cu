// Two row-segment designs of the top-k deposit (K2) that were tried and not
// kept: each is slower than the atomic scatter a message in
// src/repro_torch/kernels/cr_reduce/csrc/topk_cr_deposit.cu at the training
// path's shape (tools/k2_segment_designs.py times them side by side).
//
// Both reuse K4's run pass and ranges (topk_cr_reduce.cu, included below):
// a payload in K1's order is at most two ascending runs a row, so a block
// that owns a segment of a ring row finds each message's picks there as a
// contiguous range a run, and applies the messages in order with block
// barriers between them.
//   red    one atomic add a pick into the ring, straight from the ranges;
//   delta  a message's products summed into a shared copy of the segment
//          that starts at -0.0 (x + -0.0 == x), then each 16 bytes of the
//          ring that take a product read, added to and written once.
// Payloads off K1's order are not handled here (no atomic route): the
// script gives K1's.
#include "../src/repro_torch/kernels/cr_reduce/csrc/topk_cr_reduce.cu"

namespace {

constexpr int kVec = kSeg / 4 / kThreads;    // 16 bytes of a segment a thread

__device__ __forceinline__ bool touched(float d) {
  return __float_as_uint(d) != 0x80000000u;  // not -0.0
}

template <bool DELTA>
__global__ void __launch_bounds__(kThreads)
    k2_segment_kernel(float* acc, const float* __restrict__ vals,
                      const int32_t* __restrict__ idx,
                      const int32_t* __restrict__ slots,
                      const float* __restrict__ weights, int* scratch,
                      int64_t S, int64_t M, int64_t R, int64_t k,
                      int64_t nseg) {
  __shared__ float4 delta4[DELTA ? kSeg / 4 + 1 : 1];
  __shared__ int s_lo[kMaxRuns], s_n[kMaxRuns];
  const Scratch sc(scratch, S * M, nseg);
  const int64_t m = blockIdx.x / nseg;
  const int64_t b = blockIdx.x - m * nseg;
  const int64_t seg0 = b * kSeg;
  const int n = (int)min((int64_t)kSeg, R - seg0);
  for (int64_t s = 0; s < S; ++s) {
    if (threadIdx.x == 0)
      ranges_of(range_loads(idx, sc, s * M + m, k, b), (int)k, b, s_lo, s_n);
    if (DELTA)
      for (int i = threadIdx.x; i < kSeg / 4 + 1; i += kThreads)
        delta4[i] = make_float4(-0.f, -0.f, -0.f, -0.f);
    __syncthreads();                         // ranges (and -0.0) are in
    float* dst = acc + ((int64_t)slots[s] * M + m) * R + seg0;
    const int head = min((int)((4 - ((uintptr_t)dst >> 2)) & 3), n);
    const int shift = (4 - head) & 3;
    float* seg = DELTA ? reinterpret_cast<float*>(delta4) + shift : dst;
    const int64_t rowoff = (s * M + m) * k;
    for (int i0 = 0; i0 < s_n[0] + s_n[1]; i0 += kBatch) {
      int ix[kUnroll];
      float v[kUnroll];
      load_picks(vals, idx, rowoff, s_lo, s_n, i0, ix, v);
      add_picks(seg, ix, v, weights[s], seg0, n);
    }
    if (DELTA) {
      __syncthreads();                       // the products are in
      for (int i = threadIdx.x; i < n; i += kThreads) {
        const int n4 = (n - head) >> 2;
        if (i >= head && i < head + 4 * n4) continue;  // the 16-byte words
        if (touched(seg[i]))
          __stcg(dst + i, __fadd_rn(__ldcg(dst + i), seg[i]));
      }
      const int n4 = (n - head) >> 2;
      float4* dst4 = reinterpret_cast<float4*>(dst + head);
      const float4* src4 = delta4 + (shift + head) / 4;
      float4 a[kVec];
      bool hit[kVec];
#pragma unroll
      for (int u = 0; u < kVec; ++u) {       // the loads first, then adds
        const int i = u * kThreads + threadIdx.x;
        const float4 d = i < n4 ? src4[i] : make_float4(-0.f, -0.f, -0.f,
                                                         -0.f);
        hit[u] = touched(d.x) || touched(d.y) || touched(d.z) || touched(d.w);
        if (hit[u]) a[u] = __ldcg(dst4 + i);
      }
#pragma unroll
      for (int u = 0; u < kVec; ++u) {
        const int i = u * kThreads + threadIdx.x;
        if (!hit[u]) continue;
        const float4 d = src4[i];
        __stcg(dst4 + i, make_float4(__fadd_rn(a[u].x, d.x),
                                     __fadd_rn(a[u].y, d.y),
                                     __fadd_rn(a[u].z, d.z),
                                     __fadd_rn(a[u].w, d.w)));
      }
    }
    __syncthreads();                         // message s before s + 1
  }
}

}  // namespace

extern "C" {

long long k2_design_scratch_words(long long S, long long M, long long R) {
  return scratch_words(S * M, R);
}

// delta != 0: the staged design, else one atomic add a pick.
int k2_design_launch(float* acc, const float* vals, const int* idx,
                     const int* slots, const float* weights, int* scratch,
                     long long S, long long M, long long R, long long k,
                     int delta, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int64_t nseg = num_segments(R);
  const int64_t rows = S * M;
  cudaError_t e = cudaMemsetAsync(
      scratch, 0, sizeof(int) * scratch_words(rows, R), stream);
  if (e != cudaSuccess) return (int)e;
  topk_reduce_runs_kernel<<<grid_of((rows * k + kChunk - 1) / kChunk),
                            kThreads, 0, stream>>>(idx, scratch, rows, k,
                                                   1.0 / (double)k, nseg);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if (delta)
    k2_segment_kernel<true><<<(unsigned)(M * nseg), kThreads, 0, stream>>>(
        acc, vals, idx, slots, weights, scratch, S, M, R, k, nseg);
  else
    k2_segment_kernel<false><<<(unsigned)(M * nseg), kThreads, 0, stream>>>(
        acc, vals, idx, slots, weights, scratch, S, M, R, k, nseg);
  return (int)cudaGetLastError();
}

}  // extern "C"
