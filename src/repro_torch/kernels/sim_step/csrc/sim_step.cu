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
// launch does less than a microsecond of work, so latency does.  At d =
// 4096 the (d, d) A matrix (64 MB) sets the byte bound (about 20 us at
// 3.35 TB/s) and the p*d*d FP32 FMAs of G a similar operation bound (16 us
// at p = 32).  The product stays FP32 FFMA, not TF32: the reference
// multiplies in f32.
//
// delivery_step has two designs, chosen by d alone (kernel.py's
// delivery_slice_rows: one slice of every row, or slices of fewer), so a
// case's summation order never depends on B, the groups or the card:
//
// * the walk (one slice, d <= 512): one block per (column tile of 32,
//   case) walks d in chunks of 32, each chunk of (V - x*) and of A's column
//   panel staged in shared memory while the next chunk's loads are in
//   flight; each thread keeps RM rows of the p x 32 G tile in registers and
//   sums in row order.  At these sizes the call is latency: a row split
//   adds a merge and its own round trips and was measured slower (PERF.md).
// * the split (larger d): G's reduction runs over d's rows of A, so those
//   rows are split across blocks as for sync_step.  Block (column tile of
//   128, row slice, case) keeps 8 rows of A in flight a lane with 16-byte
//   loads that bypass L1 (the next row issued as one is used), the slice's
//   V - x* staged transposed in shared memory (every load issued before the
//   first store); warp w sums rows w, w + 8, ... of the slice for its 4
//   columns x PB rows of V (PB = 8 or 16, p up to 64 in passes, so two
//   blocks fit an SM), the warps' sums are added in warp order through
//   shared memory, and each block writes its (p, 128) partial.  The last
//   block of each (case, column tile), found by an integer ticket, adds
//   the slices in slice order (4 slices' loads in flight at a time) while
//   the noise, V, defer, U and x of its tile arrive by cp.async.
//
// Both then form P = U G for their columns (a fixed order over p), write
// x', V' and defer', and their tile's share of the gap, (x' - V'_i)^2
// summed over the tile's columns in a fixed order; the last block of a case
// (a second ticket) adds the shares in tile order.  One launch a call, no
// float atomics, so the result is the same bit for bit from run to run.
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

constexpr int PMAX = 64;

constexpr int TN = 32;             // walk: columns per block
constexpr int TK = 32;             // depth of one staged chunk of d
constexpr int RG = 8;              // row groups = warps per block
constexpr int THREADS = TN * RG;   // 256

template <int RM>                  // G rows per thread: p <= RG * RM
__global__ void __launch_bounds__(THREADS) delivery_walk_kernel(
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

constexpr int DV_WARPS = 8;
constexpr int DV_THREADS = 32 * DV_WARPS;    // 256
constexpr int DV_TN = 4 * 32;                // split: columns per block
constexpr int DV_RS_MAX = 256;               // rows per slice, at most
constexpr int DV_PB = 16;                    // rows of V a pass, at most
constexpr int DV_PRE = 8;                    // rows of A in flight a lane
constexpr int DV_RED = 8;                    // rows of G a reduction round
constexpr int DV_MQ = 4;                     // float4 of G a thread a batch
constexpr int DV_MS = 4;                     // slices merged per batch

// Floats of the work area: V - x* of the slice transposed ([rows][PB + 4]),
// then the warps' sums ([DV_WARPS][DV_RED][DV_TN]), then the tiles' gap
// shares ([tiles][p]).  Shared memory holds it, then G, the noise, V and
// defer of the tile ([p][DV_TN] each), U ([m][p]) and x of the tile.
int delivery_work_floats(int pb, int rows, int p, int ntiles) {
  int w = rows * (pb + 4);
  if (w < DV_WARPS * DV_RED * DV_TN) w = DV_WARPS * DV_RED * DV_TN;
  if (w < p * ntiles) w = p * ntiles;
  return (w + 3) / 4 * 4;                    // G starts 16-byte aligned
}

size_t delivery_smem_bytes(int work, int p, int m) {
  return sizeof(float) *
         ((size_t)work + 4 * (size_t)p * DV_TN + (size_t)m * p + DV_TN);
}

__device__ __forceinline__ void fma4(float* acc, float s, const float4& a) {
  acc[0] = fmaf(s, a.x, acc[0]);
  acc[1] = fmaf(s, a.y, acc[1]);
  acc[2] = fmaf(s, a.z, acc[2]);
  acc[3] = fmaf(s, a.w, acc[3]);
}

__device__ __forceinline__ float4 add4(float4 a, const float4& b) {
  a.x = __fadd_rn(a.x, b.x);
  a.y = __fadd_rn(a.y, b.y);
  a.z = __fadd_rn(a.z, b.z);
  a.w = __fadd_rn(a.w, b.w);
  return a;
}

// 4 bytes from global to shared memory, asynchronously (0 when !ok).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(sa),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

// 16 bytes (n floats of them real, the rest 0), asynchronously.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int n) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sa),
               "l"(src), "r"(4 * n)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Rows [0, rows) x the tile's DV_TN columns of a (rows, d) matrix into
// shared [rows][DV_TN], 0 past d; asynchronous.  VEC: 16-byte rows (d % 4
// == 0, src aligned), four floats a copy.
template <bool VEC>
__device__ __forceinline__ void tile_async(float* dst, const float* src,
                                           int rows, int col0, int d) {
  if (VEC) {
    for (int e = 4 * threadIdx.x; e < rows * DV_TN; e += 4 * DV_THREADS) {
      const int r = e / DV_TN, col = col0 + (e - r * DV_TN);
      const int n = col < d ? min(4, d - col) : 0;
      cp_async16(dst + e, n ? src + (int64_t)r * d + col : src, n);
    }
    return;
  }
  for (int e = threadIdx.x; e < rows * DV_TN; e += DV_THREADS) {
    const int r = e / DV_TN, col = col0 + (e - r * DV_TN);
    const bool ok = col < d;
    cp_async4(dst + e, ok ? src + (int64_t)r * d + col : src, ok);
  }
}

// The split (the design is in the header).  PB: rows of V a pass.  VEC:
// 16-byte aligned rows of A, V, noise and defer (d % 4 == 0).
template <int PB, bool VEC>
__global__ void __launch_bounds__(DV_THREADS, 2) delivery_split_kernel(
    const float* __restrict__ v, const float* __restrict__ x,
    const float* __restrict__ a, const float* __restrict__ xstar,
    const float* __restrict__ noise, const float* __restrict__ u,
    const float* __restrict__ defer, float* __restrict__ x_out,
    float* __restrict__ v_out, float* __restrict__ defer_out,
    float* __restrict__ gpart, float* __restrict__ qpart,
    float* __restrict__ sq, unsigned int* __restrict__ ticket, int p, int d,
    int m, int rs, int a_group, int work) {
  constexpr int VS = PB + 4;                 // row stride of V - x*
  constexpr int KPT = DV_RS_MAX / DV_THREADS;        // staged columns
  extern __shared__ __align__(16) float smem[];
  float* wk = smem;                          // the work area
  float* Gs = wk + work;                     // G of the tile
  float* En = Gs + p * DV_TN;                // the noise, V, defer, U, x
  float* Vt = En + p * DV_TN;
  float* Dt = Vt + p * DV_TN;
  float* Us = Dt + p * DV_TN;
  float* Xt = Us + m * p;
  __shared__ unsigned int is_last;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tile = blockIdx.x, ntiles = gridDim.x;
  const int sl = blockIdx.y, nsl = gridDim.y;
  const int64_t b = blockIdx.z;
  const int64_t grp = b / a_group;
  const int64_t pd = (int64_t)p * d;
  const float* vb = v + b * pd;
  const float* ab = a + grp * (int64_t)d * d;
  const float* xsb = xstar + grp * d;
  const int k0 = sl * rs;
  const int n = min(rs, d - k0);
  const int col0 = tile * DV_TN;
  const int c0 = col0 + 4 * lane;            // this lane's 4 columns
  const bool cols = c0 < d;
  const float* ak = ab + (int64_t)k0 * d + c0;
  const int nrow = n > warp ? (n - warp + DV_WARPS - 1) / DV_WARPS : 0;
  const int64_t tile_floats = (int64_t)p * DV_TN;
  float* gp = gpart + (b * ntiles + tile) * nsl * tile_floats;

  for (int i0 = 0; i0 < p; i0 += PB) {
    float4 ring[DV_PRE];                     // this warp's next rows
#pragma unroll
    for (int e = 0; e < DV_PRE; ++e)
      ring[e] = cols && e < nrow
                    ? a_row4<VEC>(ak + (int64_t)(warp + DV_WARPS * e) * d,
                                  c0, d)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    // V - x* of the slice, every load in flight before the first store:
    // thread t takes column k0 + t of each row
    const int pn = min(PB, p - i0);
    float sv[PB][KPT];
#pragma unroll
    for (int kk = 0; kk < KPT; ++kk) {
      const int k = threadIdx.x + kk * DV_THREADS;
      const float xk = k < n ? xsb[k0 + k] : 0.f;
#pragma unroll
      for (int i = 0; i < PB; ++i)
        sv[i][kk] = i < pn && k < n
                        ? __fsub_rn(vb[(int64_t)(i0 + i) * d + k0 + k], xk)
                        : 0.f;
    }
    __syncthreads();                         // the work area is free
#pragma unroll
    for (int kk = 0; kk < KPT; ++kk) {
      const int k = threadIdx.x + kk * DV_THREADS;
      if (k < n)
#pragma unroll
        for (int i = 0; i < PB; ++i) wk[k * VS + i] = sv[i][kk];
    }
    __syncthreads();

    float acc[PB][4];
#pragma unroll
    for (int i = 0; i < PB; ++i)
      acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    if (cols) {
      for (int j0 = 0; j0 < nrow; j0 += DV_PRE) {
#pragma unroll
        for (int e = 0; e < DV_PRE; ++e) {
          const int j = j0 + e;
          if (j < nrow) {
            const float4 av = ring[e];
            if (j + DV_PRE < nrow)           // the row 8 ahead, in flight
              ring[e] = a_row4<VEC>(
                  ak + (int64_t)(warp + DV_WARPS * (j + DV_PRE)) * d, c0, d);
            const float* dk = wk + (warp + DV_WARPS * j) * VS;
#pragma unroll
            for (int i = 0; i < PB; i += 4) {
              const float4 dv = *reinterpret_cast<const float4*>(dk + i);
              fma4(acc[i], dv.x, av);
              fma4(acc[i + 1], dv.y, av);
              fma4(acc[i + 2], dv.z, av);
              fma4(acc[i + 3], dv.w, av);
            }
          }
        }
      }
    }

    // the warps' sums, DV_RED rows at a time, added in warp order
#pragma unroll
    for (int r0 = 0; r0 < PB; r0 += DV_RED) {
      __syncthreads();                       // the work area is free
#pragma unroll
      for (int r = 0; r < DV_RED; ++r)
        *reinterpret_cast<float4*>(wk + (warp * DV_RED + r) * DV_TN +
                                   4 * lane) =
            make_float4(acc[r0 + r][0], acc[r0 + r][1], acc[r0 + r][2],
                        acc[r0 + r][3]);
      __syncthreads();
      for (int q = threadIdx.x; q < DV_RED * DV_TN; q += DV_THREADS) {
        const int r = q / DV_TN, c = q - r * DV_TN;
        const int i = i0 + r0 + r;
        if (i >= p) continue;
        float s = wk[r * DV_TN + c];
#pragma unroll
        for (int w = 1; w < DV_WARPS; ++w)
          s = __fadd_rn(s, wk[(w * DV_RED + r) * DV_TN + c]);
        gp[sl * tile_floats + i * DV_TN + c] = s;
      }
    }
  }

  // the slices, in slice order, by the last block of the (case, tile)
  __threadfence();
  __syncthreads();
  unsigned int* tk = ticket + b * ntiles + tile;
  if (threadIdx.x == 0)
    is_last = atomicAdd(tk, 1u) == (unsigned int)(nsl - 1);
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  tile_async<VEC>(En, noise + b * pd, p, col0, d);   // what the apply reads
  tile_async<VEC>(Vt, vb, p, col0, d);
  if (defer != nullptr) tile_async<VEC>(Dt, defer + b * pd, p, col0, d);
  for (int e = threadIdx.x; e < m * p; e += DV_THREADS)
    cp_async4(Us + e, u + b * (int64_t)m * p + e, true);
  if (threadIdx.x < DV_TN) {
    const int col = col0 + threadIdx.x;
    cp_async4(Xt + threadIdx.x, col < d ? x + b * d + col : x, col < d);
  }
  const int nf = p * DV_TN / 4;              // float4 of a partial
  const float4* g4 = reinterpret_cast<const float4*>(gp);
  const int64_t s4 = tile_floats / 4;
  for (int f0 = 0; f0 < nf; f0 += DV_MQ * DV_THREADS) {
    float4 sum[DV_MQ];
#pragma unroll
    for (int j = 0; j < DV_MQ; ++j) {
      const int f = f0 + threadIdx.x + j * DV_THREADS;
      sum[j] = f < nf ? __ldcg(g4 + f) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int t = 1; t < nsl; t += DV_MS) {
      float4 bt[DV_MS][DV_MQ];
#pragma unroll
      for (int s = 0; s < DV_MS; ++s)
#pragma unroll
        for (int j = 0; j < DV_MQ; ++j) {
          const int f = f0 + threadIdx.x + j * DV_THREADS;
          bt[s][j] = t + s < nsl && f < nf
                         ? __ldcg(g4 + (t + s) * s4 + f)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
      for (int s = 0; s < DV_MS; ++s)
        if (t + s < nsl)
#pragma unroll
          for (int j = 0; j < DV_MQ; ++j) sum[j] = add4(sum[j], bt[s][j]);
    }
#pragma unroll
    for (int j = 0; j < DV_MQ; ++j) {
      const int f = f0 + threadIdx.x + j * DV_THREADS;
      if (f < nf) reinterpret_cast<float4*>(Gs)[f] = sum[j];
    }
  }
  if (threadIdx.x == 0) *tk = 0u;            // ready for the next launch
  cp_async_wait_all();
  __syncthreads();
  for (int q = threadIdx.x; q < p * DV_TN; q += DV_THREADS)
    Gs[q] = col0 + (q & (DV_TN - 1)) < d ? __fadd_rn(Gs[q], En[q]) : 0.f;
  __syncthreads();

  // P = U G, 8 rows a thread at a time, and the apply; x' and V' of the
  // tile replace x and V in shared memory for the gap
  const int c = threadIdx.x & (DV_TN - 1);   // column of the tile
  const int col = col0 + c;
  const int half = threadIdx.x / DV_TN;      // rows half, half + 2, ...
  const int64_t off = b * pd;
  for (int r0 = half; r0 < m; r0 += 16) {
    float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int i = 0; i < p; ++i) {
      const float gi = Gs[i * DV_TN + c];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int rr = r0 + 2 * j;
        if (rr < m) s[j] = fmaf(Us[rr * p + i], gi, s[j]);
      }
    }
    if (col >= d) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int rr = r0 + 2 * j;
      if (rr >= m) break;
      if (rr == 0) {
        const float xn = __fsub_rn(Xt[c], s[j]);
        x_out[b * d + col] = xn;
        Xt[c] = xn;
      } else if (rr <= p) {
        const int t = (rr - 1) * DV_TN + c;
        float vn = __fsub_rn(Vt[t], s[j]);
        if (defer != nullptr) vn = __fsub_rn(vn, Dt[t]);
        v_out[off + (int64_t)(rr - 1) * d + col] = vn;
        Vt[t] = vn;
      } else {
        defer_out[off + (int64_t)(rr - 1 - p) * d + col] = s[j];
      }
    }
  }
  __syncthreads();

  // this tile's share of the gap, one warp per worker row: each lane sums
  // its 4 columns in order, then a butterfly over the lanes
  for (int i = warp; i < p; i += DV_WARPS) {
    float t = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cc = 4 * lane + j;
      if (col0 + cc < d) {
        const float df = __fsub_rn(Xt[cc], Vt[i * DV_TN + cc]);
        t = __fadd_rn(t, __fmul_rn(df, df));
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      t = __fadd_rn(t, __shfl_xor_sync(0xffffffffu, t, o));
    if (lane == 0) qpart[(b * ntiles + tile) * p + i] = t;
  }
  __threadfence();
  __syncthreads();
  unsigned int* tq = ticket + (int64_t)gridDim.z * ntiles + b;
  if (threadIdx.x == 0)
    is_last = atomicAdd(tq, 1u) == (unsigned int)(ntiles - 1);
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const float* qb = qpart + b * ntiles * p;  // [tile][p]
  for (int e = threadIdx.x; e < ntiles * p; e += DV_THREADS)
    wk[e] = __ldcg(qb + e);
  __syncthreads();
  for (int i = threadIdx.x; i < p; i += DV_THREADS) {
    float s = 0.f;
    for (int t = 0; t < ntiles; ++t) s = __fadd_rn(s, wk[t * p + i]);
    sq[b * p + i] = s;
  }
  if (threadIdx.x == 0) *tq = 0u;            // ready for the next launch
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
cudaError_t launch_walk(dim3 grid, cudaStream_t stream, const float* v,
                        const float* x, const float* a, const float* xs,
                        const float* noise, const float* u,
                        const float* defer, float* x_out, float* v_out,
                        float* defer_out, float* partial, float* sq,
                        unsigned int* ticket, int p, int d, int m,
                        int a_group) {
  delivery_walk_kernel<RM><<<grid, THREADS, 0, stream>>>(
      v, x, a, xs, noise, u, defer, x_out, v_out, defer_out, partial, sq,
      ticket, p, d, m, a_group);
  return cudaGetLastError();
}

template <int PB, bool VEC>
cudaError_t launch_split(dim3 grid, cudaStream_t stream, const float* v,
                         const float* x, const float* a, const float* xs,
                         const float* noise, const float* u,
                         const float* defer, float* x_out, float* v_out,
                         float* defer_out, float* gpart, float* qpart,
                         float* sq, unsigned int* ticket, int p, int d, int m,
                         int rs, int a_group) {
  const int work = delivery_work_floats(PB, rs < d ? rs : d, p, (int)grid.x);
  const size_t smem = delivery_smem_bytes(work, p, m);
  cudaError_t e = cudaFuncSetAttribute(
      delivery_split_kernel<PB, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  delivery_split_kernel<PB, VEC><<<grid, DV_THREADS, smem, stream>>>(
      v, x, a, xs, noise, u, defer, x_out, v_out, defer_out, gpart, qpart, sq,
      ticket, p, d, m, rs, a_group, work);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Scratch floats the delivery step needs for B cases with rs rows of A a
// slice (rs >= d: the walk): the per-tile partial gaps, and for the split
// the per-slice partial G tiles before them.  The ticket buffer (B *
// (ceil(d / 128) + 1) unsigned ints) must start zeroed; every launch
// leaves it zeroed again.
long long sim_delivery_partial_floats(long long B, long long p, long long d,
                                      long long rs) {
  if (rs >= d) return B * ((d + TN - 1) / TN) * p;
  const long long tiles = (d + DV_TN - 1) / DV_TN;
  const long long slices = (d + rs - 1) / rs;
  return B * tiles * slices * p * DV_TN + B * tiles * p;
}

// Returns the cudaError_t of the launch (0 on success).  defer and
// defer_out are both null or both set; rs >= d takes the walk, else rs
// <= 256 rows of A a slice.
int sim_delivery_launch(const float* v, const float* x, const float* a,
                        const float* xstar, const float* noise,
                        const float* u, const float* defer, float* x_out,
                        float* v_out, float* defer_out, float* partial,
                        float* sq, unsigned int* ticket, long long B,
                        long long p, long long d, long long rs,
                        long long a_group, void* stream_ptr) {
  if (B <= 0 || p <= 0 || p > PMAX || d <= 0 || B > 65535 || a_group <= 0 ||
      rs <= 0 || (rs < d && (rs > DV_RS_MAX || (d + rs - 1) / rs > 65535)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int m = (int)(defer != nullptr ? 1 + 2 * p : 1 + p);
  const int ip = (int)p, id = (int)d, ig = (int)a_group;
  cudaError_t e;
  if (rs >= d) {                              // the walk
    const dim3 grid((unsigned)((d + TN - 1) / TN), (unsigned)B);
#define WALK_ARGS                                                      \
  grid, stream, v, x, a, xstar, noise, u, defer, x_out, v_out, defer_out, \
      partial, sq, ticket, ip, id, m, ig
    if (p <= RG)
      e = launch_walk<1>(WALK_ARGS);
    else if (p <= 2 * RG)
      e = launch_walk<2>(WALK_ARGS);
    else if (p <= 4 * RG)
      e = launch_walk<4>(WALK_ARGS);
    else
      e = launch_walk<8>(WALK_ARGS);
#undef WALK_ARGS
    return (int)e;
  }
  const long long tiles = (d + DV_TN - 1) / DV_TN;
  const long long slices = (d + rs - 1) / rs;
  const dim3 grid((unsigned)tiles, (unsigned)slices, (unsigned)B);
  float* gpart = partial;
  float* qpart = partial + B * tiles * slices * p * DV_TN;
  auto al = [](const void* q) {
    return q == nullptr || reinterpret_cast<uintptr_t>(q) % 16 == 0;
  };
  const bool vec = d % 4 == 0 && al(a) && al(v) && al(noise) && al(defer);
  const int irs = (int)rs;
#define SPLIT_ARGS                                                     \
  grid, stream, v, x, a, xstar, noise, u, defer, x_out, v_out, defer_out, \
      gpart, qpart, sq, ticket, ip, id, m, irs, ig
  if (p <= 8)
    e = vec ? launch_split<8, true>(SPLIT_ARGS)
            : launch_split<8, false>(SPLIT_ARGS);
  else
    e = vec ? launch_split<DV_PB, true>(SPLIT_ARGS)
            : launch_split<DV_PB, false>(SPLIT_ARGS);
#undef SPLIT_ARGS
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
