// Chunked Mamba2 SSD scan for Hopper (sm_90a), zero initial state.
//
// Replaces: src/repro/kernels/ssd/kernel.py::ssd_chunked_kernel (Pallas TPU;
// body _ssd_kernel).
//
// The sequence of each (batch b, head h) is cut into n_c chunks of C =
// min(128, T) steps.  For one chunk, with X (C x hd), a (C), B and C (C x N)
// and S the state the chunk starts from (hd x N):
//     cum = cumsum(a)
//     A   = (C B^T) * tril(exp(cum_i - cum_j))            (C x C)
//     y   = A X + exp(cum) * (C S^T)                      (C x hd)
//     S'  = exp(cum_last) S + X^T (B * exp(cum_last - cum))
// all in f32; y is rounded to x's dtype once, and the final S is written in
// f32.  Inputs: x and y (B, T, H, hd), a (B, T, H) f32, B and C (B, T, N);
// x, B, C and y all bf16 or all f32; hd, N and C at most 128.
//
// Three kernels, launched in order on one stream by ssd_chunked_launch, so
// that every (b, chunk, head) runs in parallel (8192 at the path's shape)
// and only the short walk over chunks is sequential:
//  1. ssd_chunk_state, grid (n_c, H / 4, B), 4 warps.  Warp w takes head
//     h0 + w's cumsum (each lane adds 4 steps in order, a warp scan adds the
//     lanes' sums); then per head, the block forms the chunk's state
//     D = X^T (B * exp(cum_last - cum)) (hd x N, each warp 16 columns) and
//     writes it, and exp(cum_last), to a workspace (B, H, n_c, hd, N) f32.
//     Shared memory: X and B of the chunk, the cumsums (53 KB at the path's
//     shape, 3 blocks an SM by registers).
//  2. ssd_chunk_scan, one thread per (b, h, 4 entries of hd x N), walks the
//     chunks in order, S = fmaf(exp(cum_last), S, D), and writes the state
//     each chunk starts from (bf16 inputs: split in 3 bf16 parts, to a
//     second workspace; f32 inputs: in place of D) and the final state.
//  3. ssd_chunk_out, grid (n_c, H / 4, B), 4 warps.  G = C B^T is computed
//     once per block, for its 4 heads, into registers: warp w owns the
//     16-row strips w and C/16 - 1 - w and keeps the lower-triangle 16 x 16
//     tiles of G those rows need (9 at C = 128, the same for every warp).
//     Per head each warp forms A = G * exp2(c_i - c_j) (c = cum log2(e); 1
//     on the diagonal) on its tiles in registers, as the left operand of
//     the next product, and computes y = exp(cum) (C S^T) + A X over all of
//     hd, loading the right operand's fragments 4 tiles at a time.  Shared
//     memory: C, X (B before the heads), the starting state's parts, the
//     cumsums (102 KB at the path's shape: 2 blocks an SM).
//
// Products run on the tensor cores: mma.sync m16n8k16, bf16 operands, f32
// accumulators, operands from shared memory by ldmatrix, and every
// fragment of a step loaded before its products start, so that
// consecutive mma go to different accumulators.  An operand that is f32
// (A, the carried S, B * decay) is split into hi + mid + lo bf16 parts
// (split3: each part the top 16 bits of what is left, so the parts add up
// to the f32 value exactly and each part times a bf16 value is exact in
// f32), and the products of the parts go into one f32 accumulator.  bf16
// inputs (x, B, C) are exact operands, so a product is three mma; f32
// inputs are split too, and every pair of parts whose weights reach 2^-16
// is multiplied (six mma; the pairs left out weigh 2^-24).  Shared-memory
// rows are padded 8 elements past a multiple of 16, so ldmatrix's 8 rows
// fall in distinct banks; hd, N and C are padded to multiples of 16 with
// zeros, and tiles are copied in by cp.async.
//
// What bounds it: at the serving path's shape (B 4, T 4096, H 64, hd 112,
// N 64, bf16) the function moves 485.5 MB (x and y 234.9 MB each; a, B and C
// 8.4 MB together; S 7.3 MB), 0.145 ms at 3.35 TB/s, and needs 44.9 GFLOP
// of chunk products, 0.045 ms on the bf16 tensor cores, so the bytes bound
// it.  The three passes move 1.88 GB (x read twice; D written, read; the
// split states written, read), 0.56 ms at the memory rate, and run about
// three times the products (the splits).  Pass 2 is bound by its bytes;
// passes 1 and 3 wait on their chains of shared-memory loads, splits and
// mma (and exp2 in pass 3), pass 3 with 8 warps an SM (G's registers and
// 102 KB of shared memory allow no more).  Every sum runs in a fixed order (no atomics), so
// the result is the same bit for bit from run to run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 128;          // 4 warps
constexpr int WARPS = THREADS / 32;
constexpr int HEADS = WARPS;          // heads a block takes: a warp's cumsum each
constexpr int MAXT = 8;               // 16-wide tiles of a dimension <= 128
constexpr int DH = MAXT / 2;          // pass 3: right-operand tiles at a time
constexpr int PAD = 8;                // row padding, in elements
constexpr int SCAN_THREADS = 256;
constexpr float LOG2E = 1.44269504088896341f;

// v rounded up to a multiple of 16 (elements of a tile, bytes of a layout)
__host__ __device__ inline int r16(int v) { return (v + 15) & ~15; }

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}
__device__ __forceinline__ void put2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void put2(bf16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// x = hi + mid + lo exactly, each a bf16 (the top 16 bits of what is left of
// x), for |x| >= 2^-110 and 0; below that within 2^-133.
__device__ __forceinline__ void split3(float x, uint32_t (&p)[3]) {
  const uint32_t u0 = __float_as_uint(x) & 0xffff0000u;
  const float r1 = __fsub_rn(x, __uint_as_float(u0));
  const uint32_t u1 = __float_as_uint(r1) & 0xffff0000u;
  const float r2 = __fsub_rn(r1, __uint_as_float(u1));
  p[0] = u0 >> 16;
  p[1] = u1 >> 16;
  p[2] = __float_as_uint(r2) >> 16;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// tensor-core fragments
// ---------------------------------------------------------------------------

// A 16 x 16 piece (rows r0.., contraction index k0..) of a matrix M[r][k] in
// shared memory: stored row-major (M[r][k] at s[r * ld + k]) or, COL,
// column-major (at s[k * ld + r]).  A bf16 tile may hold P parts, part q at
// s + q * part; an f32 tile holds one array and is split when read.
template <typename E, bool COL, int P = 1>
struct Tile {
  static constexpr int F = sizeof(E) == 4 ? 3 : P;   // parts of a fragment
  const E* s;
  int ld;
  int part;
};

// A fragment is four 32-bit registers of two bf16 each, in the order of the
// m16n8k16 A operand: (row g, k 2t..2t+1), (g + 8, 2t), (g, 2t + 8),
// (g + 8, 2t + 8), g = lane / 4, t = lane % 4.  As a right operand the same
// registers are two n8 tiles: rows r0.. in {0, 2}, rows r0 + 8.. in {1, 3}.

// part q of a bf16 tile's fragment, by ldmatrix
template <bool COL, int P>
__device__ __forceinline__ void frag_part(const Tile<bf16, COL, P>& o, int q,
                                          int r0, int k0, uint32_t (&f)[4]) {
  const int l = threadIdx.x & 31;
  const bf16* p =
      o.s + q * o.part +
      (COL ? (k0 + (l >> 4) * 8 + (l & 7)) * o.ld + r0 + ((l >> 3) & 1) * 8
           : (r0 + (l & 15)) * o.ld + k0 + (l >> 4) * 8);
  const uint32_t addr = smem_u32(p);
  if (COL)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
        : "=r"(f[0]), "=r"(f[1]), "=r"(f[2]), "=r"(f[3])
        : "r"(addr));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
        : "=r"(f[0]), "=r"(f[1]), "=r"(f[2]), "=r"(f[3])
        : "r"(addr));
}

// the fragment of M[r][k] * scale[k] (no scale: M), split into 3 parts
template <typename E, bool COL>
__device__ __forceinline__ void frag_split(const Tile<E, COL>& o,
                                           const float* scale, int r0,
                                           int k0, uint32_t (&f)[3][4]) {
  const int l = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + (l >> 2) + (i & 1) * 8;
    const int k = k0 + 2 * (l & 3) + (i >> 1) * 8;
    float v0 = to_f(COL ? o.s[k * o.ld + r] : o.s[r * o.ld + k]);
    float v1 = to_f(COL ? o.s[(k + 1) * o.ld + r] : o.s[r * o.ld + k + 1]);
    if (scale) {
      v0 *= scale[k];
      v1 *= scale[k + 1];
    }
    uint32_t p0[3], p1[3];
    split3(v0, p0);
    split3(v1, p1);
#pragma unroll
    for (int q = 0; q < 3; ++q) f[q][i] = p0[q] | (p1[q] << 16);
  }
}

// part q of an f32 tile's fragment
template <bool COL>
__device__ __forceinline__ void frag_part(const Tile<float, COL>& o, int q,
                                          int r0, int k0, uint32_t (&f)[4]) {
  uint32_t all[3][4];
  frag_split(o, nullptr, r0, k0, all);
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = all[q][i];
}

// every part of a fragment
template <typename E, bool COL, int P>
__device__ __forceinline__ void frag(const Tile<E, COL, P>& o, int r0, int k0,
                                     uint32_t (&f)[Tile<E, COL, P>::F][4]) {
  if constexpr (sizeof(E) == 4) {
    frag_split(o, nullptr, r0, k0, f);
  } else {
#pragma unroll
    for (int q = 0; q < P; ++q) frag_part(o, q, r0, k0, f[q]);
  }
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc (16 x 16 as two n8 tiles) += a b^T over 16 of the contraction index
__device__ __forceinline__ void mma2(float (&acc)[2][4],
                                     const uint32_t (&a)[4],
                                     const uint32_t (&b)[4]) {
  mma(acc[0], a, b[0], b[2]);
  mma(acc[1], a, b[1], b[3]);
}

// the same for fragments in parts: every pair of parts whose weights reach
// 2^-16 (i + j <= 2), the smallest first
template <int PA, int PB>
__device__ __forceinline__ void mma16(float (&acc)[2][4],
                                      const uint32_t (&a)[PA][4],
                                      const uint32_t (&b)[PB][4]) {
#pragma unroll
  for (int i = PA - 1; i >= 0; --i)
#pragma unroll
    for (int j = PB - 1; j >= 0; --j)
      if (i + j <= 2) mma2(acc, a[i], b[j]);
}

// ---------------------------------------------------------------------------
// staging and the chunk's cumsum
// ---------------------------------------------------------------------------

// dst[r * ld + k] = src[r * stride + k] for r < rows, k < cols, and 0 up to
// rows_pad x cols_pad.  Where the rows allow 16-byte copies they go by
// cp.async, all in flight at once: the caller waits (cp_wait) before the
// block's next barrier.
template <typename T>
__device__ void stage_rows(T* dst, int ld, const T* src, int64_t stride,
                           int rows, int cols, int rows_pad, int cols_pad) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = cols % V == 0 && stride % V == 0 &&
                   (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  if (vec) {
    const int units = cols_pad / V;
    for (int i = threadIdx.x; i < rows_pad * units; i += THREADS) {
      const int r = i / units, k = (i - r * units) * V;
      const bool in = r < rows && k < cols;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                       smem_u32(dst + r * ld + k)),
                   "l"(in ? src + r * stride + k : src), "r"(in ? 16 : 0));
    }
  } else {
    for (int i = threadIdx.x; i < rows_pad * cols_pad; i += THREADS) {
      const int r = i / cols_pad, k = i - r * cols_pad;
      dst[r * ld + k] =
          (r < rows && k < cols) ? src[r * stride + k] : from_f<T>(0.f);
    }
  }
}

__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// cum[j] = a_0 + ... + a_j over the chunk's c <= 128 steps (a at stride
// h_n), by one warp: lane l adds steps 4l..4l+3 in order, a warp scan adds
// the lanes' sums.  cum[j] for c <= j < cp repeats cum[c - 1].
__device__ void chunk_cumsum(const float* a, int h_n, int c, float* cum,
                             int cp) {
  const int l = threadIdx.x & 31;
  float v[4], run = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int j = 4 * l + q;
    run += j < c ? a[static_cast<int64_t>(j) * h_n] : 0.f;
    v[q] = run;
  }
  float inc = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, inc, off);
    if (l >= off) inc += t;
  }
  float ex = __shfl_up_sync(0xffffffffu, inc, 1);
  if (l == 0) ex = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (4 * l + q < cp) cum[4 * l + q] = ex + v[q];
  __syncwarp();
}

// ---------------------------------------------------------------------------
// shared-memory layouts (bytes), the same on the host and the device
// ---------------------------------------------------------------------------

struct StateSmem {     // pass 1: X, B, and per head cum and exp(last - cum)
  int x, b, cum, bytes;
  __host__ __device__ StateSmem(int es, int hd, int n, int c) {
    const int hdp = r16(hd), np = r16(n), cp = r16(c);
    x = 0;
    b = r16(cp * (hdp + PAD) * es);
    cum = b + r16(cp * (np + PAD) * es);
    bytes = cum + 2 * HEADS * cp * 4;
  }
};

struct OutSmem {       // pass 3: C, X (B before the heads), S, cum, exp(cum)
  int c, x, s, cum, bytes;
  __host__ __device__ OutSmem(int es, int hd, int n, int ch) {
    const int hdp = r16(hd), np = r16(n), cp = r16(ch);
    const int w = hdp > np ? hdp : np;
    c = 0;
    x = r16(cp * (np + PAD) * es);
    s = x + r16(cp * (w + PAD) * es);
    cum = s + r16(es == 2 ? 3 * hdp * (np + PAD) * 2 : hdp * (np + PAD) * 4);
    bytes = cum + 2 * HEADS * cp * 4;
  }
};

// ---------------------------------------------------------------------------
// pass 1: chunk states D = X^T (B * exp(cum_last - cum))
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS) ssd_chunk_state(
    const T* __restrict__ x, const float* __restrict__ a,
    const T* __restrict__ bm, float* __restrict__ ws,
    float* __restrict__ el, int t_len, int h_n, int hd, int n_n, int c_len) {
  extern __shared__ __align__(16) unsigned char smem[];
  const StateSmem lay(sizeof(T), hd, n_n, c_len);
  const int hdp = r16(hd), np = r16(n_n), cp = r16(c_len);
  const int ldx = hdp + PAD, ldb = np + PAD;
  T* sX = reinterpret_cast<T*>(smem + lay.x);
  T* sB = reinterpret_cast<T*>(smem + lay.b);
  float* sCum = reinterpret_cast<float*>(smem + lay.cum);
  float* sDr = sCum + HEADS * cp;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int chunk = blockIdx.x, nc = t_len / c_len, h0 = blockIdx.y * HEADS;
  const int64_t b = blockIdx.z;
  const int64_t row0 = b * t_len + static_cast<int64_t>(chunk) * c_len;
  constexpr int F1 = Tile<T, true>::F;       // parts of an x fragment
  const Tile<T, true> xo{sX, ldx, 0};        // X[j][d] as (d, j)
  const Tile<T, true> bo{sB, ldb, 0};        // B[j][n] as (n, j)

  stage_rows(sB, ldb, bm + row0 * n_n, n_n, c_len, n_n, cp, np);
  if (h0 + warp < h_n) {   // warp w: the cumsum and decays of head h0 + w
    const int h = h0 + warp;
    float* cum = sCum + warp * cp;
    chunk_cumsum(a + row0 * h_n + h, h_n, c_len, cum, cp);
    const float last = cum[c_len - 1];
    for (int j = lane; j < cp; j += 32)
      sDr[warp * cp + j] = j < c_len ? expf(last - cum[j]) : 0.f;
    if (lane == 0) el[(b * h_n + h) * nc + chunk] = expf(last);
  }

  for (int hh = 0; hh < HEADS; ++hh) {
    const int h = h0 + hh;
    if (h >= h_n) break;
    stage_rows(sX, ldx, x + (row0 * h_n + h) * hd,
               static_cast<int64_t>(h_n) * hd, c_len, hd, cp, hdp);
    cp_wait();
    __syncthreads();
    // D (hdp x np): warp w takes the 16 columns of strips w, w + 4, ...; the
    // right operand B * decay is split as it is read
    float* dst =
        ws + ((b * h_n + h) * nc + chunk) * static_cast<int64_t>(hdp) * np;
    for (int ni = warp; ni < np / 16; ni += WARPS) {
      float acc[MAXT][2][4] = {};
      for (int ks = 0; ks < cp / 16; ++ks) {
        uint32_t bd[3][4];
        frag_split(bo, sDr + hh * cp, 16 * ni, 16 * ks, bd);
#pragma unroll
        for (int p = 0; p < F1; ++p) {
          uint32_t ax[MAXT][4];
#pragma unroll
          for (int mi = 0; mi < MAXT; ++mi)
            if (mi < hdp / 16) frag_part(xo, p, 16 * mi, 16 * ks, ax[mi]);
#pragma unroll
          for (int q = 2; q >= 0; --q)
            if (p + q <= 2)
#pragma unroll
              for (int mi = 0; mi < MAXT; ++mi)
                if (mi < hdp / 16) mma2(acc[mi], ax[mi], bd[q]);
        }
      }
#pragma unroll
      for (int mi = 0; mi < MAXT; ++mi)
        if (mi < hdp / 16)
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            float* p = dst + (16 * mi + g) * np + 16 * ni + 8 * t + 2 * tg;
            *reinterpret_cast<float2*>(p) =
                make_float2(acc[mi][t][0], acc[mi][t][1]);
            *reinterpret_cast<float2*>(p + 8 * np) =
                make_float2(acc[mi][t][2], acc[mi][t][3]);
          }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// pass 2: the states chunks start from, in chunk order
// ---------------------------------------------------------------------------

// One thread per (b, h, 4 entries): S = fmaf(exp(cum_last), S, D) chunk by
// chunk.  The state a chunk starts from goes in place of its D (f32) or,
// SPLIT, to sp (B, H, n_c, 3, hd, N) as 3 bf16 parts.
template <bool SPLIT>
__global__ void __launch_bounds__(SCAN_THREADS) ssd_chunk_scan(
    float* __restrict__ ws, const float* __restrict__ el,
    bf16* __restrict__ sp, float* __restrict__ state, int nc, int hd,
    int n_n) {
  const int hdp = r16(hd), np = r16(n_n);
  const int quads = hdp * np / 4;
  const int i = blockIdx.y * SCAN_THREADS + threadIdx.x;
  if (i >= quads) return;
  const int64_t bh = blockIdx.x;
  float4* w = reinterpret_cast<float4*>(ws + bh * nc * hdp * np) + i;
  uint2* parts =
      SPLIT ? reinterpret_cast<uint2*>(sp + bh * nc * 3 * hdp * np) + i
            : nullptr;
  const float* e = el + bh * nc;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j0 = 0; j0 < nc; j0 += 8) {
    float4 d[8];
    float ev[8];
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (j0 + q < nc) {
        d[q] = w[static_cast<int64_t>(j0 + q) * quads];
        ev[q] = e[j0 + q];
      }
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (j0 + q < nc) {
        const int64_t j = j0 + q;
        if (SPLIT) {
          uint32_t p0[3], p1[3], p2[3], p3[3];
          split3(s.x, p0);
          split3(s.y, p1);
          split3(s.z, p2);
          split3(s.w, p3);
#pragma unroll
          for (int k = 0; k < 3; ++k)
            parts[(j * 3 + k) * quads] =
                make_uint2(p0[k] | (p1[k] << 16), p2[k] | (p3[k] << 16));
        } else {
          w[j * quads] = s;
        }
        s.x = fmaf(ev[q], s.x, d[q].x);
        s.y = fmaf(ev[q], s.y, d[q].y);
        s.z = fmaf(ev[q], s.z, d[q].z);
        s.w = fmaf(ev[q], s.w, d[q].w);
      }
  }
  const int r = 4 * i / np, k = 4 * i - r * np;
  if (r >= hd) return;
  const float v[4] = {s.x, s.y, s.z, s.w};
  float* out = state + (bh * hd + r) * n_n;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (k + q < n_n) out[k + q] = v[q];
}

// ---------------------------------------------------------------------------
// pass 3: outputs y = exp(cum) (C S^T) + (C B^T * L) X
// ---------------------------------------------------------------------------

// The kk-th G tile of the warp whose strips are s0 <= s1: strip s0's tiles
// 0..s0, then strip s1's 0..s1.
__device__ __forceinline__ bool g_tile(int kk, int s0, int s1, int& mi,
                                       int& ks) {
  if (kk <= s0) {
    mi = s0;
    ks = kk;
    return true;
  }
  if (s1 > s0 && kk - s0 - 1 <= s1) {
    mi = s1;
    ks = kk - s0 - 1;
    return true;
  }
  return false;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) ssd_chunk_out(
    const T* __restrict__ x, const float* __restrict__ a,
    const T* __restrict__ bm, const T* __restrict__ cm,
    const float* __restrict__ ws, const bf16* __restrict__ sp,
    T* __restrict__ y, int t_len, int h_n, int hd, int n_n, int c_len) {
  extern __shared__ __align__(16) unsigned char smem[];
  const OutSmem lay(sizeof(T), hd, n_n, c_len);
  const int hdp = r16(hd), np = r16(n_n), cp = r16(c_len), mt = cp / 16;
  const int ldc = np + PAD, ldx = (hdp > np ? hdp : np) + PAD, lds = np + PAD;
  T* sC = reinterpret_cast<T*>(smem + lay.c);
  T* sX = reinterpret_cast<T*>(smem + lay.x);
  T* sS = reinterpret_cast<T*>(smem + lay.s);
  float* sCum = reinterpret_cast<float*>(smem + lay.cum);
  float* sEc = sCum + HEADS * cp;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int chunk = blockIdx.x, nc = t_len / c_len, h0 = blockIdx.y * HEADS;
  const int64_t b = blockIdx.z;
  const int64_t row0 = b * t_len + static_cast<int64_t>(chunk) * c_len;
  constexpr int F1 = Tile<T, false>::F;      // parts of an x, B, C fragment
  constexpr bool BF = sizeof(T) == 2;        // S in 3 bf16 parts, or f32
  const Tile<T, false> co{sC, ldc, 0};
  const Tile<T, false> bo{sX, ldx, 0};        // B[j][n], before the heads
  const Tile<T, true> xo{sX, ldx, 0};         // X[j][d] as (d, j)
  const Tile<T, false, BF ? 3 : 1> so{sS, lds, hdp * lds};

  stage_rows(sC, ldc, cm + row0 * n_n, n_n, c_len, n_n, cp, np);
  stage_rows(sX, ldx, bm + row0 * n_n, n_n, c_len, n_n, cp, np);
  if (h0 + warp < h_n) {   // warp w: head h0 + w's exp(cum), cum log2(e)
    float* cum = sCum + warp * cp;
    chunk_cumsum(a + row0 * h_n + h0 + warp, h_n, c_len, cum, cp);
    for (int j = lane; j < cp; j += 32) {
      sEc[warp * cp + j] = expf(cum[j]);
      cum[j] *= LOG2E;
    }
  }
  cp_wait();
  __syncthreads();

  // G = C B^T on the warp's lower-triangle tiles, kept in registers
  const int s0 = warp, s1 = mt - 1 - warp;
  const bool active = s0 <= s1;
  float gt[MAXT + 1][2][4] = {};
  if (active)
    for (int k2 = 0; k2 < np / 16; ++k2) {
      uint32_t c0[F1][4], c1[F1][4];
      frag(co, 16 * s0, 16 * k2, c0);
      if (s1 > s0) frag(co, 16 * s1, 16 * k2, c1);
#pragma unroll
      for (int kk = 0; kk <= MAXT; ++kk) {
        int mi, ks;
        if (!g_tile(kk, s0, s1, mi, ks)) continue;
        uint32_t bb[F1][4];
        frag(bo, 16 * ks, 16 * k2, bb);
        if (mi == s0)
          mma16(gt[kk], c0, bb);
        else
          mma16(gt[kk], c1, bb);
      }
    }
  __syncthreads();

  for (int hh = 0; hh < HEADS; ++hh) {
    const int h = h0 + hh;
    if (h >= h_n) break;
    stage_rows(sX, ldx, x + (row0 * h_n + h) * hd,
               static_cast<int64_t>(h_n) * hd, c_len, hd, cp, hdp);
    if (chunk > 0) {     // the state the chunk starts from
      const int64_t at = ((b * h_n + h) * nc + chunk) *
                         static_cast<int64_t>(hdp) * np;
      if constexpr (BF)
        stage_rows(reinterpret_cast<bf16*>(sS), lds, sp + 3 * at, np,
                   3 * hdp, np, 3 * hdp, np);
      else
        stage_rows(reinterpret_cast<float*>(sS), lds, ws + at, np, hdp, np,
                   hdp, np);
    }
    cp_wait();
    __syncthreads();
    const float* cum = sCum + hh * cp;   // cum log2(e)
    const float* ec = sEc + hh * cp;

    for (int slot = 0; active && slot < 2; ++slot) {
      const int mi = slot ? s1 : s0;
      if (slot && s1 == s0) break;
      float acc[MAXT][2][4] = {};
      // right-operand fragments are loaded DH tiles of hd at a time
      if (chunk > 0) {   // exp(cum) (C S^T)
        for (int k2 = 0; k2 < np / 16; ++k2) {
          uint32_t ac[F1][4];
          frag(co, 16 * mi, 16 * k2, ac);
#pragma unroll
          for (int q = 2; q >= 0; --q)
#pragma unroll
            for (int d0 = 0; d0 < MAXT; d0 += DH) {
              uint32_t bs[DH][4];
#pragma unroll
              for (int dp = 0; dp < DH; ++dp)
                if (16 * (d0 + dp) < hdp)
                  frag_part(so, q, 16 * (d0 + dp), 16 * k2, bs[dp]);
#pragma unroll
              for (int p = 0; p < F1; ++p)
                if (p + q <= 2)
#pragma unroll
                  for (int dp = 0; dp < DH; ++dp)
                    if (16 * (d0 + dp) < hdp)
                      mma2(acc[d0 + dp], ac[p], bs[dp]);
            }
        }
        const float e0 = ec[16 * mi + g], e1 = ec[16 * mi + g + 8];
#pragma unroll
        for (int dp = 0; dp < MAXT; ++dp)
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            acc[dp][t][0] *= e0;
            acc[dp][t][1] *= e0;
            acc[dp][t][2] *= e1;
            acc[dp][t][3] *= e1;
          }
      }
      // + A X, A = G * exp2(cum_i log2(e) - cum_j log2(e)) on and below the
      // diagonal (1 on it)
      const int i0 = 16 * mi + g, i1 = i0 + 8;
      const float c0 = cum[i0], c1 = cum[i1];
#pragma unroll
      for (int kk = 0; kk <= MAXT; ++kk) {
        int tile_mi, ks;
        if (!g_tile(kk, s0, s1, tile_mi, ks) || tile_mi != mi) continue;
        uint32_t af[3][4];
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int j = 16 * ks + 8 * t + 2 * tg;
          const float cj0 = cum[j], cj1 = cum[j + 1];
          uint32_t p[4][3];
          split3(j <= i0 ? gt[kk][t][0] * exp2f(c0 - cj0) : 0.f, p[0]);
          split3(j + 1 <= i0 ? gt[kk][t][1] * exp2f(c0 - cj1) : 0.f, p[1]);
          split3(j <= i1 ? gt[kk][t][2] * exp2f(c1 - cj0) : 0.f, p[2]);
          split3(j + 1 <= i1 ? gt[kk][t][3] * exp2f(c1 - cj1) : 0.f, p[3]);
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            af[q][2 * t] = p[0][q] | (p[1][q] << 16);
            af[q][2 * t + 1] = p[2][q] | (p[3][q] << 16);
          }
        }
#pragma unroll
        for (int p = 0; p < F1; ++p)
#pragma unroll
          for (int d0 = 0; d0 < MAXT; d0 += DH) {
            uint32_t bx[DH][4];
#pragma unroll
            for (int dp = 0; dp < DH; ++dp)
              if (16 * (d0 + dp) < hdp)
                frag_part(xo, p, 16 * (d0 + dp), 16 * ks, bx[dp]);
#pragma unroll
            for (int q = 2; q >= 0; --q)
              if (p + q <= 2)
#pragma unroll
                for (int dp = 0; dp < DH; ++dp)
                  if (16 * (d0 + dp) < hdp) mma2(acc[d0 + dp], af[q], bx[dp]);
          }
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int i = rr ? i1 : i0;
        if (i >= c_len) continue;
        T* yp = y + ((row0 + i) * h_n + h) * hd;
#pragma unroll
        for (int dp = 0; dp < MAXT; ++dp)
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            const int d = 16 * dp + 8 * t + 2 * tg;
            const float v0 = acc[dp][t][2 * rr], v1 = acc[dp][t][2 * rr + 1];
            if (d + 1 < hd && hd % 2 == 0) {
              put2(yp + d, v0, v1);
            } else {
              if (d < hd) yp[d] = from_f<T>(v0);
              if (d + 1 < hd) yp[d + 1] = from_f<T>(v1);
            }
          }
      }
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const void* x, const float* a, const void* bm, const void* cm,
           void* y, float* state, float* ws, float* el, bf16* sp, int64_t b,
           int64_t t, int64_t h, int64_t hd, int64_t n, int64_t c,
           cudaStream_t stream) {
  const int nc = (int)(t / c);
  const int s1 = StateSmem(sizeof(T), (int)hd, (int)n, (int)c).bytes;
  const int s3 = OutSmem(sizeof(T), (int)hd, (int)n, (int)c).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_state<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, s1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      ssd_chunk_out<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, s3);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)nc, (unsigned)((h + HEADS - 1) / HEADS),
                  (unsigned)b);
  ssd_chunk_state<T><<<grid, THREADS, s1, stream>>>(
      static_cast<const T*>(x), a, static_cast<const T*>(bm), ws, el,
      (int)t, (int)h, (int)hd, (int)n, (int)c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int quads = r16((int)hd) * r16((int)n) / 4;
  const dim3 sgrid((unsigned)(b * h),
                   (unsigned)((quads + SCAN_THREADS - 1) / SCAN_THREADS));
  ssd_chunk_scan<sizeof(T) == 2><<<sgrid, SCAN_THREADS, 0, stream>>>(
      ws, el, sp, state, nc, (int)hd, (int)n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_chunk_out<T><<<grid, THREADS, s3, stream>>>(
      static_cast<const T*>(x), a, static_cast<const T*>(bm),
      static_cast<const T*>(cm), ws, sp, static_cast<T*>(y), (int)t, (int)h,
      (int)hd, (int)n, (int)c);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch the three passes on `stream`.  The workspace (f32 unless said, hd
// and N padded to multiples of 16): ws (B, H, T / c, hd, N), el (B, H,
// T / c) and, for bf16 inputs, sp (B, H, T / c, 3, hd, N) bf16 (null for
// f32).  Returns the cudaError_t of the first launch that failed (0:
// launched).
int ssd_chunked_launch(const void* x, const void* a, const void* bm,
                       const void* cm, void* y, void* state, void* ws,
                       void* el, void* sp, long long b, long long t,
                       long long h, long long hd, long long n, long long c,
                       int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  float* sf = static_cast<float*>(state);
  float* w = static_cast<float*>(ws);
  float* e = static_cast<float*>(el);
  bf16* p = static_cast<bf16*>(sp);
  if (is_bf16)
    return launch<bf16>(x, af, bm, cm, y, sf, w, e, p, b, t, h, hd, n, c,
                        st);
  return launch<float>(x, af, bm, cm, y, sf, w, e, p, b, t, h, hd, n, c, st);
}

}  // extern "C"
