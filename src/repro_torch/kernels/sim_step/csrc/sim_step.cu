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
// delivery_step's design: one block per (column tile of 32, case).  It
// walks d in chunks of 32: each chunk of (V - x*) and of A's column panel
// is staged in shared memory (the next chunk's loads are in flight in
// registers while the current one is multiplied), and each thread keeps RM
// rows of the
// p x 32 G tile in registers, accumulating over d in one fixed order.  The
// G tile then goes to shared memory and each thread forms rows of P = U G
// for its column, in a fixed order over p, and writes x', V', defer'.  The
// gap needs every column: each block writes its tile's partial sums of
// (x' - V'_i)^2, and the last block of a case to finish (an integer ticket,
// the only atomic) adds the partials in tile order.  No float atomics and
// a fixed order everywhere, so the result is the same bit for bit from run
// to run and whatever B is.  Any d is taken (the tail tile and chunk are
// masked), and p up to 64.
//
// sync_step's design: at d = 4096 one column tile per block gave 128
// blocks on 132 SMs with 4 loads of A in flight a warp, so the kernel
// waited on memory latency at 2.9x its byte bound.  A's rows are now split
// across blocks too: block (column tile of 128, row slice, case) reads its
// slice of A with one 16-byte load per lane and row that bypasses L1, 8
// rows in flight a warp (32 KB a block; the first 8 rows before x - x* is
// staged), and at (B 1, d 4096) the grid is 32 x 16 = 512 blocks, about 4
// per SM.  Each block sums its slice in one fixed order; the last block of
// each (case, column tile), found by an integer ticket, adds the slices in
// slice order and applies the epilogue, so the call stays one launch.  The
// slice length depends on d alone, so a case's sum is the same bit for bit
// whatever B, the groups or the card.
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

// sync_step (the design is in the header): the slice length depends on d
// alone (kernel.py's sync_slice_rows chooses it), so a case's summation
// order never depends on B, the groups or the card.
constexpr int SYNC_WARPS = 8;
constexpr int SYNC_THREADS = 32 * SYNC_WARPS;  // 256
constexpr int SYNC_TN = 4 * 32;                // columns per block
constexpr int SYNC_RS_MAX = 512;               // rows per slice, at most
constexpr int SYNC_PRE = 8;                    // rows loaded before x - x*

// 4 floats of a row of A from column c0 (VEC: one 16-byte load that
// bypasses L1; else up to 4 loads, 0 past d).
template <bool VEC>
__device__ __forceinline__ float4 a_row4(const float* p, int c0, int d) {
  float4 v;
  if (VEC) {
    asm volatile(
        "ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];\n"
        : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
        : "l"(p));
  } else {
    v.x = __ldg(p);
    v.y = c0 + 1 < d ? __ldg(p + 1) : 0.f;
    v.z = c0 + 2 < d ? __ldg(p + 2) : 0.f;
    v.w = c0 + 3 < d ? __ldg(p + 3) : 0.f;
  }
  return v;
}

template <bool VEC>   // VEC: 16-byte aligned rows of A (d % 4 == 0)
__global__ void __launch_bounds__(SYNC_THREADS) sync_kernel(
    const float* __restrict__ x, const float* __restrict__ a,
    const float* __restrict__ xstar, const float* __restrict__ nsum,
    const float* __restrict__ cw, float* __restrict__ x_out,
    float* __restrict__ partial, unsigned int* __restrict__ ticket, int d,
    int rs, int a_group) {
  __shared__ float diff[SYNC_RS_MAX];
  __shared__ float red[SYNC_WARPS][SYNC_TN];
  __shared__ unsigned int is_last;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tile = blockIdx.x;
  const int sl = blockIdx.y;
  const int nsl = gridDim.y;
  const int64_t b = blockIdx.z;
  const int64_t grp = b / a_group;
  const float* xb = x + b * d;
  const float* ab = a + grp * (int64_t)d * d;
  const float* xsb = xstar + grp * d;
  const int k0 = sl * rs;
  const int n = min(rs, d - k0);
  const int c0 = tile * SYNC_TN + 4 * lane;   // this lane's 4 columns
  const bool cols = c0 < d;
  const float* ak = ab + (int64_t)k0 * d + c0;

  float4 pre[SYNC_PRE];       // rows warp + SYNC_WARPS * e
#pragma unroll
  for (int e = 0; e < SYNC_PRE; ++e) {
    const int k = warp + SYNC_WARPS * e;
    pre[e] = cols && k < n ? a_row4<VEC>(ak + (int64_t)k * d, c0, d)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int i = threadIdx.x; i < n; i += SYNC_THREADS)
    diff[i] = __fsub_rn(xb[k0 + i], xsb[k0 + i]);
  __syncthreads();

  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  if (cols) {
#pragma unroll
    for (int e = 0; e < SYNC_PRE; ++e) {
      const int k = warp + SYNC_WARPS * e;
      if (k < n) {
        const float dk = diff[k];
        s0 = fmaf(dk, pre[e].x, s0);
        s1 = fmaf(dk, pre[e].y, s1);
        s2 = fmaf(dk, pre[e].z, s2);
        s3 = fmaf(dk, pre[e].w, s3);
      }
    }
#pragma unroll 8
    for (int k = warp + SYNC_WARPS * SYNC_PRE; k < n; k += SYNC_WARPS) {
      const float dk = diff[k];
      const float4 v = a_row4<VEC>(ak + (int64_t)k * d, c0, d);
      s0 = fmaf(dk, v.x, s0);
      s1 = fmaf(dk, v.y, s1);
      s2 = fmaf(dk, v.z, s2);
      s3 = fmaf(dk, v.w, s3);
    }
  }
  red[warp][4 * lane] = s0;
  red[warp][4 * lane + 1] = s1;
  red[warp][4 * lane + 2] = s2;
  red[warp][4 * lane + 3] = s3;
  __syncthreads();

  const int j = threadIdx.x;                 // column of the tile
  const int c = tile * SYNC_TN + j;
  const bool mine = j < SYNC_TN && c < d;
  auto apply = [&](float dot) {
    x_out[b * d + c] = __fsub_rn(__fsub_rn(xb[c], __fmul_rn(cw[b], dot)),
                                 nsum[b * d + c]);
  };
  float dot = 0.f;
  if (mine) {
    dot = red[0][j];
#pragma unroll
    for (int w = 1; w < SYNC_WARPS; ++w) dot = __fadd_rn(dot, red[w][j]);
  }
  if (nsl == 1) {                            // one slice: no partials
    if (mine) apply(dot);
    return;
  }
  if (mine) partial[(b * nsl + sl) * d + c] = dot;
  __threadfence();
  __syncthreads();
  unsigned int* tk = ticket + b * gridDim.x + tile;
  if (threadIdx.x == 0)
    is_last = atomicAdd(tk, 1u) == (unsigned int)(nsl - 1);
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  if (mine) {
    const float* pc = partial + b * nsl * d + c;
    float t = __ldcg(pc);
    for (int s = 1; s < nsl; ++s) t = __fadd_rn(t, __ldcg(pc + (int64_t)s * d));
    apply(t);
  }
  if (threadIdx.x == 0) *tk = 0u;            // ready for the next launch
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

// rs rows of A a slice (1 <= rs <= 512).  With more than one slice,
// ``partial`` holds B * ceil(d / rs) * d floats of per-slice column sums
// and ``ticket`` B * ceil(d / 128) unsigned ints, zeroed; every launch
// leaves them zeroed again.
int sim_sync_launch(const float* x, const float* a, const float* xstar,
                    const float* nsum, const float* c, float* x_out,
                    float* partial, unsigned int* ticket, long long B,
                    long long d, long long rs, long long a_group,
                    void* stream_ptr) {
  if (B <= 0 || d <= 0 || B > 65535 || a_group <= 0 || rs <= 0 ||
      rs > SYNC_RS_MAX || (d + rs - 1) / rs > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const dim3 grid((unsigned)((d + SYNC_TN - 1) / SYNC_TN),
                  (unsigned)((d + rs - 1) / rs), (unsigned)B);
  if (d % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0)
    sync_kernel<true><<<grid, SYNC_THREADS, 0, stream>>>(
        x, a, xstar, nsum, c, x_out, partial, ticket, (int)d, (int)rs,
        (int)a_group);
  else
    sync_kernel<false><<<grid, SYNC_THREADS, 0, stream>>>(
        x, a, xstar, nsum, c, x_out, partial, ticket, (int)d, (int)rs,
        (int)a_group);
  return (int)cudaGetLastError();
}

}  // extern "C"
