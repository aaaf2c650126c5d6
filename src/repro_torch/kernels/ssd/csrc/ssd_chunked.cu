// Chunked Mamba2 SSD scan for Hopper (sm_90a), zero initial state.
//
// Replaces: src/repro/kernels/ssd/kernel.py::ssd_chunked_kernel (Pallas TPU;
// body _ssd_kernel).
//
// Per (batch b, head h) the sequence is cut into chunks of C = min(128, T)
// steps and walked in order, with the state S (hd x N) carried between
// chunks.  For one chunk, with X (C x hd), a (C), B and C (C x N):
//     cum = cumsum(a)                         (sequential, in step order)
//     A   = (C B^T) * tril(exp(cum_i - cum_j))            (C x C)
//     y   = A X + exp(cum) * (C S^T)                      (C x hd)
//     S   = exp(cum_last) S + X^T (B * exp(cum_last - cum))
// all in f32; y is rounded to x's dtype once, and the final S is written in
// f32.  Inputs: x and y (B, T, H, hd), a (B, T, H) f32, B and C (B, T, N),
// S (B, H, hd, N) f32; x, B, C and y all bf16 or all f32.
//
// What bounds it: at the serving path's shape (B 4, T 4096, H 64, hd 112,
// N 64, bf16) the function moves 485.5 MB (x and y 234.9 MB each; a, B
// and C 8.4 MB together; S 7.3 MB), 0.145 ms at 3.35 TB/s, and needs
// 77.3 GFLOP of chunk products, 0.078 ms on the bf16 tensor cores.  So the
// bytes bound it.  This first kernel does the products on the FP32 SIMT
// cores instead (1.15 ms at their peak), with operands read from shared
// memory, so it sits well above the bound; the tensor cores (mma.sync /
// wgmma for C B^T, A X, C S^T and X^T B) are a later step.
//
// Design: one block of 512 threads per (b, h); 256 blocks at the path's
// shape.  The state lives in shared memory for the whole sequence.  Each
// chunk's X and B, the cumsum and its exponentials are staged in shared
// memory as f32; C is staged 32 rows at a time, and the (C x C) matrix A is
// built 32 rows at a time in shared memory, so A never goes to device
// memory.  Rows of S and B are padded to N + 1 floats, so the warps' column
// walks hit distinct banks.  Every sum runs in a fixed order (no atomics),
// so the result is the same bit for bit from run to run.  hd, N and C
// must each be at most 128: the staging then needs at most 231,936 bytes
// of shared memory, under the 232,448 a block may have.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int RT = 32;        // rows of C and A staged at a time

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// floats of dynamic shared memory for (hd, N, C)
inline int64_t smem_floats(int64_t hd, int64_t n,
                                               int64_t c) {
  return hd * (n + 1) + c * hd + c * (n + 1) + RT * n + RT * c + 3 * c;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) ssd_chunk_kernel(
    const T* __restrict__ x, const float* __restrict__ a,
    const T* __restrict__ bm, const T* __restrict__ cm, T* __restrict__ y,
    float* __restrict__ state, int t_len, int h_n, int hd, int n_n,
    int c_len) {
  extern __shared__ float sm[];
  const int np = n_n + 1;
  float* sS = sm;                      // hd x np: the carried state
  float* sX = sS + hd * np;            // C x hd
  float* sB = sX + c_len * hd;         // C x np
  float* sC = sB + c_len * np;         // RT x N: rows r0.. of C
  float* sA = sC + RT * n_n;           // RT x C: rows r0.. of A
  float* sCum = sA + RT * c_len;       // C: cumsum of a
  float* sEc = sCum + c_len;           // C: exp(cum)
  float* sDr = sEc + c_len;            // C: exp(cum_last - cum)

  const int h = blockIdx.x;
  const int64_t b = blockIdx.y;
  const int tid = threadIdx.x;

  for (int i = tid; i < hd * np; i += THREADS) sS[i] = 0.f;

  for (int t0 = 0; t0 < t_len; t0 += c_len) {
    const int64_t step0 = b * t_len + t0;   // row of (b, t0) in (B*T)
    for (int i = tid; i < c_len * hd; i += THREADS) {
      const int r = i / hd, d = i - r * hd;
      sX[i] = to_f(x[((step0 + r) * h_n + h) * hd + d]);
    }
    for (int i = tid; i < c_len * n_n; i += THREADS) {
      const int r = i / n_n, k = i - r * n_n;
      sB[r * np + k] = to_f(bm[step0 * n_n + i]);
    }
    for (int i = tid; i < c_len; i += THREADS)
      sCum[i] = a[(step0 + i) * h_n + h];
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int i = 0; i < c_len; ++i) {
        s += sCum[i];
        sCum[i] = s;
      }
    }
    __syncthreads();
    const float last = sCum[c_len - 1];
    for (int i = tid; i < c_len; i += THREADS) {
      sEc[i] = expf(sCum[i]);
      sDr[i] = expf(last - sCum[i]);
    }

    for (int r0 = 0; r0 < c_len; r0 += RT) {
      const int rows = min(RT, c_len - r0);
      const int cols = r0 + rows;          // keys j < cols reach these rows
      for (int i = tid; i < rows * n_n; i += THREADS)
        sC[i] = to_f(cm[(step0 + r0) * n_n + i]);
      __syncthreads();
      // A[r][j] = (C_r . B_j) exp(cum_r - cum_j) for j <= r
      for (int i = tid; i < rows * cols; i += THREADS) {
        const int ii = i / cols, j = i - ii * cols;
        const int r = r0 + ii;
        float v = 0.f;
        if (j <= r) {
          const float* cr = sC + ii * n_n;
          const float* br = sB + j * np;
          float dot = 0.f;
          for (int k = 0; k < n_n; ++k) dot = fmaf(cr[k], br[k], dot);
          v = dot * expf(sCum[r] - sCum[j]);
        }
        sA[ii * c_len + j] = v;
      }
      __syncthreads();
      // y[r][d] = sum_j<=r A[r][j] X[j][d] + exp(cum_r) (C_r . S_d)
      for (int i = tid; i < rows * hd; i += THREADS) {
        const int ii = i / hd, d = i - ii * hd;
        const int r = r0 + ii;
        const float* ar = sA + ii * c_len;
        float acc = 0.f;
        for (int j = 0; j <= r; ++j) acc = fmaf(ar[j], sX[j * hd + d], acc);
        const float* cr = sC + ii * n_n;
        const float* sr = sS + d * np;
        float cs = 0.f;
        for (int k = 0; k < n_n; ++k) cs = fmaf(cr[k], sr[k], cs);
        put(&y[((step0 + r) * h_n + h) * hd + d], fmaf(sEc[r], cs, acc));
      }
      __syncthreads();
    }

    // S = exp(cum_last) S + X^T (B * exp(cum_last - cum))
    for (int i = tid; i < c_len * n_n; i += THREADS) {
      const int r = i / n_n, k = i - r * n_n;
      sB[r * np + k] *= sDr[r];
    }
    __syncthreads();
    const float el = sEc[c_len - 1];
    for (int i = tid; i < hd * n_n; i += THREADS) {
      const int d = i / n_n, k = i - d * n_n;
      float acc = 0.f;
      for (int j = 0; j < c_len; ++j)
        acc = fmaf(sX[j * hd + d], sB[j * np + k], acc);
      sS[d * np + k] = fmaf(el, sS[d * np + k], acc);
    }
    __syncthreads();
  }

  for (int i = tid; i < hd * n_n; i += THREADS) {
    const int d = i / n_n, k = i - d * n_n;
    state[((b * h_n + h) * hd + d) * n_n + k] = sS[d * np + k];
  }
}

template <typename T>
int launch(const void* x, const float* a, const void* bm, const void* cm,
           void* y, float* state, int64_t b, int64_t t, int64_t h,
           int64_t hd, int64_t n, int64_t c, cudaStream_t stream) {
  const int bytes = (int)(smem_floats(hd, n, c) * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)h, (unsigned)b);
  ssd_chunk_kernel<T><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(x), a, static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<T*>(y), state, (int)t, (int)h,
      (int)hd, (int)n, (int)c);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0: launched).
int ssd_chunked_launch(const void* x, const void* a, const void* bm,
                       const void* cm, void* y, void* state, long long b,
                       long long t, long long h, long long hd, long long n,
                       long long c, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  float* sf = static_cast<float*>(state);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, af, bm, cm, y, sf, b, t, h, hd, n, c,
                                 st);
  return launch<float>(x, af, bm, cm, y, sf, b, t, h, hd, n, c, st);
}

}  // extern "C"
