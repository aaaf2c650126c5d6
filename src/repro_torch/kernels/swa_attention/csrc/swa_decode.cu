// Sliding-window decode attention for Hopper (sm_90a), split across the
// key axis (flash-decoding).
//
// Replaces: src/repro/kernels/swa_attention/kernel.py::swa_decode_attention
// (Pallas TPU; body _swa_decode_kernel).
//
// One query token per row b attends over its T cached keys and values.  The
// key at absolute position base[b] + t is live iff key <= pos[b] and, for
// window > 0, pos[b] - key < window.  Per kv head h and query head g:
//     s[t]  = (q[b, h, g, :] . k[b, t, h, :]) * scale    (dead: -1e30)
//     out   = sum_t softmax(s)_t v[b, t, h, :]
// in f32, written in q's dtype as acc / max(l, 1e-30).  Dead scores keep
// the finite value -1e30 (not -inf), so a row with no live key returns the
// mean of its T values, as the reference's softmax over an all -1e30 row
// does (exp(-1e30 - (-1e30)) = 1); where a live key exists,
// exp(-1e30 - m) = 0 removes every dead key exactly.
//
// What bounds it: reading K and V once, 2 * B * T * KV * D elements.  At
// the serving path's shapes (B 4, T 4112, KV 8, G 4, D 128, bf16) that is
// 67.4 MB, 20.1 us at 3.35 TB/s; the 4 * B * KV * G * T * D flops are
// three orders of magnitude below the card's FP32 rate.
//
// Design: B * KV is only 32 at the path's shapes, so T is split across
// blocks: block (split, h, b) serves all G query heads of kv head h over
// keys [split * S, min(T, (split + 1) * S)), so each K and V byte is read
// once.  S (64..512) is chosen so that the grid has at least four blocks
// per SM.  Phase 1: one warp per key computes the G scores (the lanes
// split D; a butterfly shuffle adds them) into shared memory.  Phase 2:
// one warp per query head takes the split's max and its sum of exp.
// Phase 3: each thread owns a column d and a stripe of the keys and
// accumulates the G rows of p^T V; the stripes are added in stripe order.
// The block writes its (m, l, acc) partials; a second launch merges the
// splits of each (b, h) in split order.  No atomics and a fixed order
// everywhere: the result is the same bit for bit from run to run.
// Any T and B, G <= 16, D <= 256, bf16 or f32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int GMAX = 16;
constexpr int DMAX = 256;
constexpr int DPL = DMAX / 32;     // columns per lane in phase 1, at most
constexpr int SBUF = 4096;         // floats of score / stripe scratch
constexpr int MIN_BLOCKS = 4 * 132;
constexpr int MERGE_THREADS = 128;
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Partials of one (split, kv head, row): m and l (G), acc (G, D), f32.
template <typename T, int GT>
__global__ void __launch_bounds__(THREADS) swa_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ pos,
    const int* __restrict__ base, float* __restrict__ part_m,
    float* __restrict__ part_l, float* __restrict__ part_acc, int t_len,
    int kv, int g_n, int d_n, int split, int window, float scale) {
  __shared__ float qs[GMAX * DMAX];
  __shared__ float buf[SBUF];
  __shared__ float ms[GMAX];
  __shared__ float ls[GMAX];

  const int sp = blockIdx.x;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int nsplit = gridDim.x;
  const int t0 = sp * split;
  const int n = min(split, t_len - t0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int p = pos[b];
  const int key0 = base[b] + t0;
  const int64_t row = (int64_t)kv * d_n;   // elements between two keys

  const T* qb = q + (b * kv + h) * (int64_t)g_n * d_n;
  for (int i = tid; i < g_n * d_n; i += THREADS) qs[i] = to_f(qb[i]);
  __syncthreads();

  // phase 1: the split's scores, buf[g * split + t]
  const T* kb = k + (b * t_len + t0) * row + (int64_t)h * d_n;
  for (int t = warp; t < n; t += WARPS) {
    const T* kt = kb + t * row;
    float kr[DPL];
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = lane + 32 * j;
      kr[j] = d < d_n ? to_f(kt[d]) : 0.f;
    }
    float acc[GT];
#pragma unroll
    for (int g = 0; g < GT; ++g) acc[g] = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = lane + 32 * j;
      if (d < d_n) {
#pragma unroll
        for (int g = 0; g < GT; ++g)
          if (g < g_n) acc[g] = fmaf(qs[g * d_n + d], kr[j], acc[g]);
      }
    }
    const int key = key0 + t;
    const bool live = key <= p && (window <= 0 || p - key < window);
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      if (g < g_n) {
        float s = acc[g];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane == 0) buf[g * split + t] = live ? s * scale : NEG;
      }
    }
  }
  __syncthreads();

  // phase 2: per query head, the max and the sum of exp over the split;
  // buf then holds p = exp(s - m)
  for (int g = warp; g < g_n; g += WARPS) {
    float* sg = buf + g * split;
    float m = NEG;
    for (int t = lane; t < n; t += 32) m = fmaxf(m, sg[t]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float l = 0.f;
    for (int t = lane; t < n; t += 32) {
      const float e = expf(sg[t] - m);
      sg[t] = e;
      l += e;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    if (lane == 0) {
      ms[g] = m;
      ls[g] = l;
    }
  }
  __syncthreads();

  // phase 3: acc[g][d] = sum_t p[g][t] v[t][d], one column per thread,
  // keys striped over the ngrp thread groups
  const int dp = (d_n + 31) & ~31;
  const int ngrp = THREADS / dp;
  const int grp = tid / dp;
  const int d = tid - grp * dp;
  const bool owns = grp < ngrp && d < d_n;
  float acc[GT];
#pragma unroll
  for (int g = 0; g < GT; ++g) acc[g] = 0.f;
  if (owns) {
    const T* vd = v + (b * t_len + t0) * row + (int64_t)h * d_n + d;
#pragma unroll 4
    for (int t = grp; t < n; t += ngrp) {
      const float vv = to_f(vd[t * row]);
#pragma unroll
      for (int g = 0; g < GT; ++g)
        if (g < g_n) acc[g] = fmaf(buf[g * split + t], vv, acc[g]);
    }
  }
  __syncthreads();                 // every read of p is done
  if (owns) {
#pragma unroll
    for (int g = 0; g < GT; ++g)
      if (g < g_n) buf[(grp * g_n + g) * d_n + d] = acc[g];
  }
  __syncthreads();
  const int64_t cell = ((b * kv + h) * nsplit + sp) * g_n;
  if (grp == 0 && d < d_n) {
    for (int g = 0; g < g_n; ++g) {
      float s = buf[g * d_n + d];
      for (int r = 1; r < ngrp; ++r) s += buf[(r * g_n + g) * d_n + d];
      part_acc[(cell + g) * d_n + d] = s;
    }
  }
  if (tid < g_n) {
    part_m[cell + tid] = ms[tid];
    part_l[cell + tid] = ls[tid];
  }
}

// Merge the splits of one (kv head, row) in split order.
template <typename T>
__global__ void __launch_bounds__(MERGE_THREADS) swa_merge_kernel(
    const float* __restrict__ part_m, const float* __restrict__ part_l,
    const float* __restrict__ part_acc, T* __restrict__ out, int kv,
    int g_n, int d_n, int nsplit) {
  const int h = blockIdx.x;
  const int64_t b = blockIdx.y;
  const int64_t cell0 = (b * kv + h) * nsplit;
  for (int i = threadIdx.x; i < g_n * d_n; i += MERGE_THREADS) {
    const int g = i / d_n;
    const int d = i - g * d_n;
    float m = NEG;
    for (int s = 0; s < nsplit; ++s)
      m = fmaxf(m, part_m[(cell0 + s) * g_n + g]);
    float l = 0.f, acc = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const int64_t c = (cell0 + s) * g_n + g;
      const float w = expf(part_m[c] - m);
      l += part_l[c] * w;
      acc += part_acc[c * d_n + d] * w;
    }
    put(out + ((b * kv + h) * g_n + g) * d_n + d, acc / fmaxf(l, 1e-30f));
  }
}

int split_len(long long B, long long KV, long long G, long long T) {
  int s = 512;
  while (s * G > SBUF) s /= 2;
  while (s > 64 && B * KV * ((T + s - 1) / s) < MIN_BLOCKS) s /= 2;
  return s;
}

template <typename T, int GT>
cudaError_t launch_split(dim3 grid, cudaStream_t stream, const void* q,
                         const void* k, const void* v, const int* pos,
                         const int* base, float* pm, float* pl, float* pa,
                         int t_len, int kv, int g_n, int d_n, int split,
                         int window, float scale) {
  swa_split_kernel<T, GT><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pos, base, pm, pl, pa, t_len, kv, g_n, d_n,
      split, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_all(cudaStream_t stream, const void* q, const void* k,
                       const void* v, const int* pos, const int* base,
                       float* pm, float* pl, float* pa, void* out,
                       long long B, long long t_len, long long KV,
                       long long G, long long D, long long window,
                       float scale) {
  const int split = split_len(B, KV, G, t_len);
  const int nsplit = (int)((t_len + split - 1) / split);
  const dim3 grid((unsigned)nsplit, (unsigned)KV, (unsigned)B);
  const int it = (int)t_len, ik = (int)KV, ig = (int)G, id = (int)D,
            iw = (int)window;
  cudaError_t e;
  if (G <= 1)
    e = launch_split<T, 1>(grid, stream, q, k, v, pos, base, pm, pl, pa, it,
                           ik, ig, id, split, iw, scale);
  else if (G <= 2)
    e = launch_split<T, 2>(grid, stream, q, k, v, pos, base, pm, pl, pa, it,
                           ik, ig, id, split, iw, scale);
  else if (G <= 4)
    e = launch_split<T, 4>(grid, stream, q, k, v, pos, base, pm, pl, pa, it,
                           ik, ig, id, split, iw, scale);
  else if (G <= 8)
    e = launch_split<T, 8>(grid, stream, q, k, v, pos, base, pm, pl, pa, it,
                           ik, ig, id, split, iw, scale);
  else
    e = launch_split<T, 16>(grid, stream, q, k, v, pos, base, pm, pl, pa, it,
                            ik, ig, id, split, iw, scale);
  if (e != cudaSuccess) return e;
  swa_merge_kernel<T><<<dim3((unsigned)KV, (unsigned)B), MERGE_THREADS, 0,
                        stream>>>(pm, pl, pa, static_cast<T*>(out), ik, ig,
                                  id, nsplit);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Splits of the key axis for these shapes; the partials take
// B * KV * splits * G floats each for m and l and that times D for acc.
long long swa_decode_num_splits(long long B, long long KV, long long G,
                                long long T) {
  const int s = split_len(B, KV, G, T);
  return (T + s - 1) / s;
}

// q (B, KV, G, D); k, v (B, T, KV, D); out (B, KV, G, D), all contiguous
// in one dtype (is_bf16: bfloat16, else float32); pos, base (B,) int32.
// Returns the cudaError_t of the launches (0 on success).
int swa_decode_launch(const void* q, const void* k, const void* v,
                      const int* pos, const int* base, float* part_m,
                      float* part_l, float* part_acc, void* out, long long B,
                      long long T, long long KV, long long G, long long D,
                      long long window, float scale, int is_bf16,
                      void* stream_ptr) {
  if (B <= 0 || B > 65535 || T <= 0 || T > (1LL << 30) || KV <= 0 ||
      KV > 65535 || G <= 0 || G > GMAX || D <= 0 || D > DMAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (is_bf16)
    return (int)launch_all<__nv_bfloat16>(stream, q, k, v, pos, base, part_m,
                                          part_l, part_acc, out, B, T, KV, G,
                                          D, window, scale);
  return (int)launch_all<float>(stream, q, k, v, pos, base, part_m, part_l,
                                part_acc, out, B, T, KV, G, D, window, scale);
}

}  // extern "C"
