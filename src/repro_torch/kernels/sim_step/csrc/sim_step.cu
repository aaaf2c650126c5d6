// Fused simulator steps on the Quadratic testbed, for Hopper (sm_90a),
// batched over a leading case axis B.
//
// Replaces: src/repro/kernels/sim_step/kernel.py::delivery_step (bodies
// _delivery_kernel and _delivery_defer_kernel) and ::sync_step (Pallas
// TPU).
//
// delivery_step, per case b (p workers, dimension d, m = 1 + p, or 1 + 2p
// with a deferred-correction buffer):
//     G  = (V - x*) A + noise               (p, d)
//     P  = U G                              (m, d)
//     x' = x - P[0]
//     V' = V - P[1:1+p]  (- defer)
//     defer' = P[1+p:1+2p]
//     sq[i] = sum_c (x'[c] - V'[i, c])^2    (the consistency gap, per worker)
// with V, noise, defer (B, p, d), x (B, d), U (B, m, p) and A (G, d, d),
// x* (G, d) shared by groups of B / G consecutive cases (G = 1: one
// problem for all cases; G = B: one per case).
//
// sync_step, per case b:  x' = x - c[b] * ((x - x*) A) - nsum.
//
// What bounds them: at the simulator's sizes (d <= 512, p <= 32) one
// launch does less than a microsecond of work, so the launch itself does.
// At d = 4096 the (d, d) A matrix (64 MB) sets the byte bound (about 20 us
// at 3.35 TB/s) and the p*d*d FP32 FMAs of G a similar operation bound
// (16 us at p = 32).  The product stays FP32 FFMA, not TF32: the
// reference multiplies in f32.
//
// Design: one block per (column tile of 32, case).  delivery_step walks d
// in chunks of 32: each chunk of (V - x*) and of A's column panel is staged
// in shared memory (the next chunk's loads are in flight in registers while
// the current one is multiplied), and each thread keeps RM rows of the
// p x 32 G tile in registers, accumulating over d in one fixed order.  The
// G tile then goes to shared memory and each thread forms rows of P = U G
// for its column, in a fixed order over p, and writes x', V', defer'.  The
// gap needs every column: each block writes its tile's partial sums of
// (x' - V'_i)^2, and the last block of a case to finish (an integer ticket,
// the only atomic) adds the partials in tile order.  No float atomics and
// a fixed order everywhere, so the result is the same bit for bit from run
// to run and whatever B is.  Any d is taken (the tail tile and chunk are
// masked), and p up to 64.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TN = 32;             // columns per block
constexpr int TK = 32;             // depth of one staged chunk of d
constexpr int RG = 8;              // row groups = warps per block
constexpr int THREADS = TN * RG;   // 256
constexpr int PMAX = 64;

template <int RM>                  // G rows per thread: p <= RG * RM
__global__ void __launch_bounds__(THREADS) delivery_kernel(
    const float* __restrict__ v, const float* __restrict__ x,
    const float* __restrict__ a, const float* __restrict__ xstar,
    const float* __restrict__ noise, const float* __restrict__ u,
    const float* __restrict__ defer, float* __restrict__ x_out,
    float* __restrict__ v_out, float* __restrict__ defer_out,
    float* __restrict__ partial, float* __restrict__ sq,
    unsigned int* __restrict__ ticket, int p, int d, int m, int a_group) {
  constexpr int ROWS = RG * RM;
  __shared__ __align__(16) float As[2][TK][TN];
  __shared__ __align__(16) float Vs[2][ROWS][TK];
  __shared__ float Gs[ROWS][TN + 1];
  __shared__ float Vn[ROWS][TN + 1];
  __shared__ float Xn[TN];
  __shared__ unsigned int is_last;

  const int tx = threadIdx.x & 31;     // column inside the tile
  const int ty = threadIdx.x >> 5;     // warp
  const int tile = blockIdx.x;
  const int ntiles = gridDim.x;
  const int64_t b = blockIdx.y;
  const int c = tile * TN + tx;        // this thread's column
  const int64_t pd = (int64_t)p * d;
  const int64_t grp = b / a_group;
  const float* vb = v + b * pd;
  const float* ab = a + grp * (int64_t)d * d;
  const float* xsb = xstar + grp * d;

  float acc[RM];
#pragma unroll
  for (int r = 0; r < RM; ++r) acc[r] = 0.f;

  // staging registers: 4 A entries and RM entries of (V - x*) per thread
  float ra[4];
  float rv[RM];
  auto load_chunk = [&](int k0) {
    const int kc = k0 + tx;
    const float xs = kc < d ? xsb[kc] : 0.f;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int kr = k0 + ty + 8 * s;
      ra[s] = (kr < d && c < d) ? ab[(int64_t)kr * d + c] : 0.f;
    }
#pragma unroll
    for (int s = 0; s < RM; ++s) {
      const int row = ty + 8 * s;
      rv[s] = (row < p && kc < d) ? __fsub_rn(vb[(int64_t)row * d + kc], xs)
                                  : 0.f;
    }
  };
  auto store_chunk = [&](int buf) {
#pragma unroll
    for (int s = 0; s < 4; ++s) As[buf][ty + 8 * s][tx] = ra[s];
#pragma unroll
    for (int s = 0; s < RM; ++s) Vs[buf][ty + 8 * s][tx] = rv[s];
  };

  const int nchunks = (d + TK - 1) / TK;
  load_chunk(0);
  store_chunk(0);
  __syncthreads();
  for (int ch = 0; ch < nchunks; ++ch) {
    const int buf = ch & 1;
    if (ch + 1 < nchunks) load_chunk((ch + 1) * TK);
#pragma unroll
    for (int k = 0; k < TK; k += 4) {
      const float a0 = As[buf][k][tx], a1 = As[buf][k + 1][tx];
      const float a2 = As[buf][k + 2][tx], a3 = As[buf][k + 3][tx];
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const float4 vv =
            *reinterpret_cast<const float4*>(&Vs[buf][ty * RM + r][k]);
        acc[r] = fmaf(vv.x, a0, acc[r]);
        acc[r] = fmaf(vv.y, a1, acc[r]);
        acc[r] = fmaf(vv.z, a2, acc[r]);
        acc[r] = fmaf(vv.w, a3, acc[r]);
      }
    }
    if (ch + 1 < nchunks) store_chunk(buf ^ 1);
    __syncthreads();
  }

  // G tile (+ noise) to shared memory
  const float* nb = noise + b * pd;
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int i = ty * RM + r;
    if (i < p) Gs[i][tx] = c < d ? __fadd_rn(acc[r], nb[(int64_t)i * d + c])
                                 : 0.f;
  }
  __syncthreads();

  // P = U G, row by row, and the apply
  const float* ub = u + b * (int64_t)m * p;
  const int64_t off = b * pd;
  for (int rr = ty; rr < m; rr += RG) {
    const float* ur = ub + (int64_t)rr * p;
    float s = 0.f;
    for (int i = 0; i < p; ++i) s = fmaf(__ldg(ur + i), Gs[i][tx], s);
    if (c >= d) continue;
    if (rr == 0) {
      const float xn = __fsub_rn(x[b * d + c], s);
      x_out[b * d + c] = xn;
      Xn[tx] = xn;
    } else if (rr <= p) {
      const int64_t e = off + (int64_t)(rr - 1) * d + c;
      float vn = __fsub_rn(v[e], s);
      if (defer != nullptr) vn = __fsub_rn(vn, defer[e]);
      v_out[e] = vn;
      Vn[rr - 1][tx] = vn;
    } else {
      defer_out[off + (int64_t)(rr - 1 - p) * d + c] = s;
    }
  }
  __syncthreads();

  // this tile's share of the gap, one warp per worker row
  for (int i = ty; i < p; i += RG) {
    float t = 0.f;
    if (c < d) {
      const float df = __fsub_rn(Xn[tx], Vn[i][tx]);
      t = __fmul_rn(df, df);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      t = __fadd_rn(t, __shfl_xor_sync(0xffffffffu, t, o));
    if (tx == 0) partial[(b * ntiles + tile) * p + i] = t;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    is_last = atomicAdd(ticket + b, 1u) == (unsigned int)(ntiles - 1);
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int i = threadIdx.x; i < p; i += THREADS) {
    float s = 0.f;
    for (int t = 0; t < ntiles; ++t)
      s = __fadd_rn(s, __ldcg(partial + (b * ntiles + t) * p + i));
    sq[b * p + i] = s;
  }
  if (threadIdx.x == 0) ticket[b] = 0u;   // ready for the next launch
}

constexpr int SYNC_KG = 16;               // warps splitting d
constexpr int SYNC_THREADS = TN * SYNC_KG;  // 512

__global__ void __launch_bounds__(SYNC_THREADS) sync_kernel(
    const float* __restrict__ x, const float* __restrict__ a,
    const float* __restrict__ xstar, const float* __restrict__ nsum,
    const float* __restrict__ cw, float* __restrict__ x_out, int d,
    int a_group) {
  __shared__ float red[SYNC_KG][TN + 1];
  const int tx = threadIdx.x & 31;
  const int kg = threadIdx.x >> 5;
  const int64_t b = blockIdx.y;
  const int c = blockIdx.x * TN + tx;
  const int64_t grp = b / a_group;
  const float* xb = x + b * d;
  const float* ab = a + grp * (int64_t)d * d;
  const float* xsb = xstar + grp * d;
  float s = 0.f;
  if (c < d) {
#pragma unroll 4
    for (int k = kg; k < d; k += SYNC_KG)
      s = fmaf(__fsub_rn(xb[k], xsb[k]), __ldg(ab + (int64_t)k * d + c), s);
  }
  red[kg][tx] = s;
  __syncthreads();
  if (kg != 0 || c >= d) return;
  float dot = red[0][tx];
#pragma unroll
  for (int g = 1; g < SYNC_KG; ++g) dot = __fadd_rn(dot, red[g][tx]);
  x_out[b * d + c] =
      __fsub_rn(__fsub_rn(xb[c], __fmul_rn(cw[b], dot)), nsum[b * d + c]);
}

template <int RM>
cudaError_t launch_delivery(dim3 grid, cudaStream_t stream, const float* v,
                            const float* x, const float* a, const float* xs,
                            const float* noise, const float* u,
                            const float* defer, float* x_out, float* v_out,
                            float* defer_out, float* partial, float* sq,
                            unsigned int* ticket, int p, int d, int m,
                            int a_group) {
  delivery_kernel<RM><<<grid, THREADS, 0, stream>>>(
      v, x, a, xs, noise, u, defer, x_out, v_out, defer_out, partial, sq,
      ticket, p, d, m, a_group);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Scratch floats the delivery step needs for B cases: the per-tile
// partial gaps.  The ticket buffer (B unsigned ints) must start zeroed;
// every launch leaves it zeroed again.
long long sim_delivery_partial_floats(long long B, long long p, long long d) {
  return B * ((d + TN - 1) / TN) * p;
}

// Returns the cudaError_t of the launch (0 on success).  defer and
// defer_out are both null or both set.
int sim_delivery_launch(const float* v, const float* x, const float* a,
                        const float* xstar, const float* noise,
                        const float* u, const float* defer, float* x_out,
                        float* v_out, float* defer_out, float* partial,
                        float* sq, unsigned int* ticket, long long B,
                        long long p, long long d, long long a_group,
                        void* stream_ptr) {
  if (B <= 0 || p <= 0 || p > PMAX || d <= 0 || B > 65535 || a_group <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int m = (int)(defer != nullptr ? 1 + 2 * p : 1 + p);
  const dim3 grid((unsigned)((d + TN - 1) / TN), (unsigned)B);
  const int ip = (int)p, id = (int)d, ig = (int)a_group;
  cudaError_t e;
  if (p <= RG)
    e = launch_delivery<1>(grid, stream, v, x, a, xstar, noise, u, defer,
                           x_out, v_out, defer_out, partial, sq, ticket, ip,
                           id, m, ig);
  else if (p <= 2 * RG)
    e = launch_delivery<2>(grid, stream, v, x, a, xstar, noise, u, defer,
                           x_out, v_out, defer_out, partial, sq, ticket, ip,
                           id, m, ig);
  else if (p <= 4 * RG)
    e = launch_delivery<4>(grid, stream, v, x, a, xstar, noise, u, defer,
                           x_out, v_out, defer_out, partial, sq, ticket, ip,
                           id, m, ig);
  else
    e = launch_delivery<8>(grid, stream, v, x, a, xstar, noise, u, defer,
                           x_out, v_out, defer_out, partial, sq, ticket, ip,
                           id, m, ig);
  return (int)e;
}

int sim_sync_launch(const float* x, const float* a, const float* xstar,
                    const float* nsum, const float* c, float* x_out,
                    long long B, long long d, long long a_group,
                    void* stream_ptr) {
  if (B <= 0 || d <= 0 || B > 65535 || a_group <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const dim3 grid((unsigned)((d + TN - 1) / TN), (unsigned)B);
  sync_kernel<<<grid, SYNC_THREADS, 0, stream>>>(x, a, xstar, nsum, c, x_out,
                                                 (int)d, (int)a_group);
  return (int)cudaGetLastError();
}

}  // extern "C"
