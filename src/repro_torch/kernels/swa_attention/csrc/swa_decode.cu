// Sliding-window decode attention for Hopper (sm_90a), split across each
// row's live keys (flash-decoding), with the merge fused into the launch.
//
// Replaces: src/repro/kernels/swa_attention/kernel.py::swa_decode_attention
// (Pallas TPU; body _swa_decode_kernel).
//
// One query token per row b attends over its T cached keys and values.  The
// key at absolute position base[b] + t is live iff key <= pos[b] and, for
// window != 0, pos[b] - key < window.  Per kv head h and query head g:
//     s[t]  = (q[b, h, g, :] . k[b, t, h, :]) * scale    (dead: -1e30)
//     out   = sum_t softmax(s)_t v[b, t, h, :]
// in f32, written in q's dtype as acc / max(l, 1e-30).  Dead scores are
// the finite -1e30 (not -inf): where a live key exists, exp(-1e30 - m) = 0
// removes every dead key exactly, so dead keys need not be read at all; a
// row with no live key returns the mean of its T values, as the
// reference's softmax over an all -1e30 row does (exp(0) = 1 for each).
//
// What bounds it: reading K and V of the live keys once (V alone, of all T
// keys, for a row with no live key).  At the serving path's shape (B 4, T
// 4112, KV 8, G 4, D 128, bf16) with a full window of 4096 that is 42 MB,
// 12.6 us at 3.35 TB/s; with phase 15's rows of about 503 live keys it is
// about 8 MB.  The 4 * G * D flops a live key (270 MFLOP a call at most)
// take about 4 us at the card's FP32 rate, so scores and P.V are FFMA.
//
// Design:
// * Live keys only.  A row's live keys are one interval [lo, hi) of t,
//   computed in O(1) from (pos, base, T, window); ref.py::live_span does
//   the same arithmetic and the CPU tests hold it to the plain version's
//   mask.  Block (split, h, b) takes the split-th piece of that interval,
//   ref.py::split_len(n, nsplit) = 16 * ceil(ceil(n / nsplit) / 16) keys of
//   it, so every row spreads its live keys over all nsplit blocks whatever
//   their count (a row with no live key spreads all T keys and reads V
//   only).
// * Loads straight to registers, 16 bytes a thread, eight in flight, with
//   no barrier between a load and its use.  (A cp.async or bulk-copy ring
//   of small tiles with a barrier a tile kept fewer bytes in flight and
//   read this access pattern, 256-byte rows 2 KB apart, more slowly.)
//   Scores: K comes in tiles of up to 256 keys, 16 threads to a row
//   (coalesced), each thread's chunks of the next tile in flight while the
//   tile just stored to shared memory is scored: thread t walks key t's
//   row (rows an odd number of 16-byte chunks apart, so 8 neighbours'
//   chunks fall in distinct banks) against q, staged in f32 in shared
//   memory, with FFMA.  No shuffles, no partial sums.
//   The piece's softmax takes one max and one sum of exp a head.  P.V:
//   thread (16-byte chunk of D, group of heads, key stripe) loads its chunk
//   of eight keys' V rows at once (16 threads cover a row; L1 bypassed)
//   and accumulates 32 f32 outputs with FFMA, p from shared memory; the
//   stripes are added in stripe order.
// * Enough blocks, none idle.  About 256 blocks (two an SM, each with up
//   to 128 registers a thread so that nothing spills) run in one wave; a
//   block's time is a chain of memory round trips (K tiles, V batches, the
//   merge), so more, smaller blocks only add waves.
// * Fused merge.  Each block writes its (m, l, acc) partials; a piece with
//   no keys writes (-1e30, 0, 0), whose weight exp(-1e30 - m) is exactly 0
//   (or 1 beside l = 0 and acc = 0 in a row with no live key).  The last
//   block of each (b, h), found by an integer ticket (kept zeroed across
//   launches by the wrapper), merges the splits, 64 at a time: their m
//   and l are staged in shared memory, a warp a head takes the running max
//   M and the weights exp(m - M) (rescaling what was summed before by
//   exp(M_before - M), a no-op for the first 64), and groups of threads add
//   contiguous runs of the splits' acc (their loads issued together), the
//   runs added in order at the end.  No float atomics and a fixed order
//   everywhere: the result is the same bit for bit from run to run.
// Any T and B, G <= 16, D <= 256, bf16 or f32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int INFLIGHT = 8;         // 16-byte loads a thread keeps in flight
constexpr int PV_ACC = 32;          // P.V accumulators a thread
constexpr int GMAX = 16;
constexpr int DMAX = 256;
constexpr int SPLIT_ROUND = 16;     // a split's length is a multiple of this
constexpr int SC_FLOATS = 8192;     // a split's scores, G * len at most
constexpr int MERGE_SPLITS = 64;    // splits the merge weighs at once
constexpr int MERGE_BATCH = 8;      // acc loads a thread issues together
constexpr int KT_CHUNKS = INFLIGHT * THREADS;  // 16-byte chunks of a K tile
constexpr int KT_MAX = 256;         // keys of a K tile, at most
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// 16 bytes of global memory, around L1 (K and V are read once).
__device__ __forceinline__ uint4 ld16(const void* p) {
  uint4 v;
  asm volatile(
      "ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// One 16-byte chunk as f32.
template <typename T>
struct Chunk;
template <>
struct Chunk<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void cvt(uint4 u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};
template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void cvt(uint4 u, float* f) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

__host__ __device__ __forceinline__ long long round_up(long long x,
                                                       long long m) {
  return (x + m - 1) / m * m;
}

// P.V heads a thread: PV_ACC f32 accumulators with its chunk of D.
template <typename T, int GT>
__host__ __device__ constexpr int pv_heads() {
  return (PV_ACC / Chunk<T>::N) < GT ? (PV_ACC / Chunk<T>::N) : GT;
}

// Sizes and the dynamic shared memory of one block, in bytes from its
// start, computed on the host and passed by value: q in f32, the split's
// scores (key major), one region for the K tile, then the P.V stripes'
// sums, then the merge, and the per-head m and l.
struct Layout {
  int nch, dp, pitch, kt, gp, units, stripes;
  long long sc, red, stat, total;
  Layout(int es, int d, int g, int gh, int len_max) {
    const int ch = 16 / es;
    nch = (d + ch - 1) / ch;
    dp = nch * ch;
    pitch = 16 * (nch | 1);
    kt = (KT_CHUNKS / nch < KT_MAX ? KT_CHUNKS / nch : KT_MAX) / 16 * 16;
    const int nhg = (g + gh - 1) / gh;
    gp = nhg * gh;
    units = nch * nhg;
    stripes = THREADS / units;
    const long long red_b = 4LL * stripes * gp * dp;
    const long long merge_b = 8LL * MERGE_SPLITS * GMAX + 16LL * THREADS;
    const long long kt_b = (long long)kt * pitch;
    long long r = red_b > merge_b ? red_b : merge_b;
    r = r > kt_b ? r : kt_b;
    sc = round_up(4LL * g * dp, 16);
    red = sc + round_up(4LL * g * len_max, 16);
    stat = red + round_up(r, 16);
    total = stat + round_up(8LL * g, 16);
  }
};

// The live keys [lo, hi) of a row: ref.py::live_span.
__device__ __forceinline__ void live_span(long long pos, long long base,
                                          long long t_len, long long window,
                                          long long* lo, long long* hi) {
  const long long rel = pos - base;
  long long h = rel + 1;
  h = h < 0 ? 0 : (h > t_len ? t_len : h);
  long long l = 0;
  if (window != 0) {
    l = rel - window + 1;
    l = l < 0 ? 0 : (l > h ? h : l);
  }
  *lo = l;
  *hi = h;
}

template <typename T, int GT>
__global__ void __launch_bounds__(THREADS, 2) swa_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ pos,
    const int* __restrict__ base, float* __restrict__ part_m,
    float* __restrict__ part_l, float* __restrict__ part_acc,
    T* __restrict__ out, unsigned int* __restrict__ ticket, int t_len,
    int kv, int g_n, int d_n, int window, int len_max, int vec, float scale,
    const Layout lay) {
  using C = Chunk<T>;
  constexpr int CH = C::N;
  constexpr int GH = pv_heads<T, GT>();
  extern __shared__ __align__(16) char smem[];
  __shared__ unsigned int is_last;
  __shared__ float merge_m[GMAX], merge_l[GMAX], merge_f[GMAX];
  float* qs = reinterpret_cast<float*>(smem);
  float* sc = reinterpret_cast<float*>(smem + lay.sc);
  float* red = reinterpret_cast<float*>(smem + lay.red);
  float* ms = reinterpret_cast<float*>(smem + lay.stat);
  float* ls = ms + g_n;

  const int sp = blockIdx.x;
  const int nsplit = gridDim.x;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nch = lay.nch, dp = lay.dp;
  const int gd = g_n * d_n;

  // this split's keys [t0, t0 + n) of the row
  long long lo, hi;
  live_span(pos[b], base[b], t_len, window, &lo, &hi);
  const bool live = hi > lo;
  const long long start = live ? lo : 0;
  const long long nrow = live ? hi - lo : t_len;
  const long long slen =
      round_up((nrow + nsplit - 1) / nsplit, SPLIT_ROUND);
  const long long t0 = start + sp * slen;
  const long long t1 = start + nrow < t0 + slen ? start + nrow : t0 + slen;
  const int n = t1 > t0 ? (int)(t1 - t0) : 0;
  const int64_t row = (int64_t)kv * d_n;  // elements between two keys
  const int64_t first = ((b * t_len + t0) * kv + h) * (int64_t)d_n;

  // P.V thread roles: chunk c of D, head group hg, key stripe r
  const int r = tid / lay.units;
  const int u = tid - r * lay.units;
  const int c = u % nch;
  const int hg = u / nch;
  const int stripes = lay.stripes;
  const bool pv = r < stripes && (c + 1) * CH <= d_n;
  const T* vc = v + first + c * CH;

  if (live && n > 0) {
    const T* qg = q + (b * kv + h) * (int64_t)gd;
    auto stage_q = [&]() {
      for (int x = tid; x < g_n * dp; x += THREADS) {
        const int g = x / dp, e = x - g * dp;
        qs[x] = e < d_n ? to_f(qg[g * d_n + e]) : 0.f;
      }
    };
    if (vec) {
      // K in tiles of kt keys: each thread loads up to INFLIGHT 16-byte
      // chunks (16 threads a row, coalesced) into registers, the next
      // tile's while this one's scores are formed from shared memory
      char* ktile = reinterpret_cast<char*>(red);
      const int kt = lay.kt, pitch = lay.pitch;
      uint4 kb[INFLIGHT];
      auto load = [&](int tt) {
        const int rows = min(kt, n - tt);
#pragma unroll
        for (int e = 0; e < INFLIGHT; ++e) {
          const int x = tid + e * THREADS;
          const int rr = x / nch, cc = x - rr * nch;
          kb[e] = rr < rows ? ld16(k + first + (tt + rr) * row + cc * CH)
                            : make_uint4(0, 0, 0, 0);
        }
      };
      load(0);                  // K's first loads go out before q's
      stage_q();
      for (int tt = 0; tt < n; tt += kt) {
        const int rows = min(kt, n - tt);
#pragma unroll
        for (int e = 0; e < INFLIGHT; ++e) {
          const int x = tid + e * THREADS;
          const int rr = x / nch, cc = x - rr * nch;
          if (rr < rows)
            *reinterpret_cast<uint4*>(ktile + rr * pitch + cc * 16) = kb[e];
        }
        __syncthreads();        // the tile (and q) in shared memory
        if (tt + kt < n) load(tt + kt);
        for (int t = tid; t < rows; t += THREADS) {
          float s[GT];
#pragma unroll
          for (int g = 0; g < GT; ++g) s[g] = 0.f;
          for (int cc = 0; cc < nch; ++cc) {
            float kf[CH];
            C::cvt(*reinterpret_cast<const uint4*>(ktile + t * pitch +
                                                   cc * 16), kf);
#pragma unroll
            for (int g = 0; g < GT; ++g) {
              if (g < g_n) {
                const float* qv = qs + g * dp + cc * CH;
#pragma unroll
                for (int x = 0; x < CH; x += 4) {
                  const float4 q4 = *reinterpret_cast<const float4*>(qv + x);
                  s[g] = fmaf(q4.x, kf[x], s[g]);
                  s[g] = fmaf(q4.y, kf[x + 1], s[g]);
                  s[g] = fmaf(q4.z, kf[x + 2], s[g]);
                  s[g] = fmaf(q4.w, kf[x + 3], s[g]);
                }
              }
            }
          }
#pragma unroll
          for (int g = 0; g < GT; ++g)
            if (g < g_n) sc[(tt + t) * g_n + g] = s[g] * scale;
        }
        __syncthreads();        // the tile is used; sc holds its scores
      }
    } else {
      stage_q();
      __syncthreads();
      for (int t = tid; t < n; t += THREADS) {   // element loads
        const T* kr = k + first + t * row;
        float s[GT];
#pragma unroll
        for (int g = 0; g < GT; ++g) s[g] = 0.f;
        for (int d = 0; d < d_n; ++d) {
          const float kd = to_f(kr[d]);
#pragma unroll
          for (int g = 0; g < GT; ++g)
            if (g < g_n) s[g] = fmaf(qs[g * dp + d], kd, s[g]);
        }
#pragma unroll
        for (int g = 0; g < GT; ++g)
          if (g < g_n) sc[t * g_n + g] = s[g] * scale;
      }
    }
    __syncthreads();          // every score of the piece is in sc
    for (int g = warp; g < g_n; g += WARPS) {
      float m = NEG;
      for (int t = lane; t < n; t += 32) m = fmaxf(m, sc[t * g_n + g]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      float l = 0.f;
      for (int t = lane; t < n; t += 32) {
        const float e = expf(sc[t * g_n + g] - m);
        sc[t * g_n + g] = e;
        l += e;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        l += __shfl_xor_sync(0xffffffffu, l, o);
      if (lane == 0) {
        ms[g] = m;
        ls[g] = l;
      }
    }
    __syncthreads();          // p = exp(s - m) is in sc
  } else if (tid < g_n) {     // no scores: p = 1 a key, the mean of the
    ms[tid] = NEG;            // values (or nothing in an empty piece)
    ls[tid] = live ? 0.f : (float)n;
  }

  // P.V: acc[g][c * CH + x] = sum_t p[t][g] v[t][c * CH + x]
  float acc[GH][CH];
#pragma unroll
  for (int gg = 0; gg < GH; ++gg)
#pragma unroll
    for (int x = 0; x < CH; ++x) acc[gg][x] = 0.f;
  if (pv) {
    for (int tb = r; tb < n; tb += INFLIGHT * stripes) {
      float f[INFLIGHT][CH];
      if (vec) {
        uint4 vb[INFLIGHT];
#pragma unroll
        for (int e = 0; e < INFLIGHT; ++e) {
          const int t = tb + e * stripes;
          vb[e] = t < n ? ld16(vc + t * row) : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
        for (int e = 0; e < INFLIGHT; ++e) C::cvt(vb[e], f[e]);
      } else {
#pragma unroll
        for (int e = 0; e < INFLIGHT; ++e) {
          const int t = tb + e * stripes;
#pragma unroll
          for (int x = 0; x < CH; ++x)
            f[e][x] = t < n ? to_f(vc[t * row + x]) : 0.f;
        }
      }
#pragma unroll
      for (int e = 0; e < INFLIGHT; ++e) {
        const int t = tb + e * stripes;
        if (t < n) {
#pragma unroll
          for (int gg = 0; gg < GH; ++gg) {
            if (hg * GH + gg < g_n) {
              const float p = live ? sc[t * g_n + hg * GH + gg] : 1.f;
#pragma unroll
              for (int x = 0; x < CH; ++x)
                acc[gg][x] = fmaf(p, f[e][x], acc[gg][x]);
            }
          }
        }
      }
    }
  }
  __syncthreads();            // sc and ms are final; red is free
  if (pv) {
#pragma unroll
    for (int gg = 0; gg < GH; ++gg)
#pragma unroll
      for (int x = 0; x < CH; x += 4)
        *reinterpret_cast<float4*>(
            red + (r * lay.gp + hg * GH + gg) * dp + c * CH + x) =
            make_float4(acc[gg][x], acc[gg][x + 1], acc[gg][x + 2],
                        acc[gg][x + 3]);
  }
  __syncthreads();
  const int64_t cell = ((b * kv + h) * nsplit + sp) * g_n;
  for (int x = tid; x < gd; x += THREADS) {
    const int g = x / d_n, d = x - g * d_n;
    float s = 0.f;
    if (d / CH < nch && (d / CH + 1) * CH <= d_n) {   // a full chunk's sum
      float y[8];
      s = red[g * dp + d];
      for (int r0 = 1; r0 < stripes; r0 += 8) {   // 8 loads, then 8 adds
#pragma unroll
        for (int e = 0; e < 8; ++e)
          y[e] = r0 + e < stripes ? red[((r0 + e) * lay.gp + g) * dp + d]
                                  : 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (r0 + e < stripes) s += y[e];
      }
    } else {                  // the ragged last chunk: its keys here
      for (int t = 0; t < n; ++t) {
        const float p = live ? sc[t * g_n + g] : 1.f;
        s = fmaf(p, to_f(v[first + t * row + d]), s);
      }
    }
    part_acc[cell * d_n + x] = s;
  }
  if (tid < g_n) {
    part_m[cell + tid] = ms[tid];
    part_l[cell + tid] = ls[tid];
  }

  // the last block of (b, h) merges the splits
  __threadfence();
  __syncthreads();
  unsigned int* tk = ticket + b * kv + h;
  if (tid == 0)
    is_last = atomicAdd(tk, 1u) == (unsigned int)(nsplit - 1);
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const int64_t cell0 = (b * kv + h) * nsplit;
  T* ob = out + (b * kv + h) * (int64_t)gd;
  const float* pa = part_acc + cell0 * gd;
  // thread (quad of outputs qd, run rn) adds, of each batch of
  // MERGE_SPLITS splits, the run [rn * per, ...) of its quad, MERGE_BATCH
  // loads at a time.  A batch's m and l are staged in shared memory and a
  // warp a head takes the running max M, rescales the running l (and each
  // thread its sum) by exp(M_before - M), and turns m into the weights
  // exp(m - M); the runs are added in run order at the end
  float* wm = red;
  float* wl = wm + MERGE_SPLITS * GMAX;
  float* run = wl + MERGE_SPLITS * GMAX;   // THREADS float4 sums
  const int qw = d_n % 4 == 0 ? 4 : 1;
  const int nq = gd / qw;
  const int stride = min(nq, THREADS);
  const int runs = THREADS / stride;
  const int rn = tid / stride;
  for (int q0 = 0; q0 < nq; q0 += THREADS) {
    const int qd = q0 + tid % stride;
    const bool mine = rn < runs && qd < nq;
    const int g = mine ? qd * qw / d_n : 0;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();          // the last quads' l and sums are read
    if (tid < g_n) {
      merge_m[tid] = NEG;
      merge_l[tid] = 0.f;
    }
    for (int b0 = 0; b0 < nsplit; b0 += MERGE_SPLITS) {
      const int nb = min(MERGE_SPLITS, nsplit - b0);
      __syncthreads();        // the last batch's weights are read
      for (int x = tid; x < nb * g_n; x += THREADS) {
        wm[x] = __ldcg(part_m + (cell0 + b0) * g_n + x);
        wl[x] = __ldcg(part_l + (cell0 + b0) * g_n + x);
      }
      __syncthreads();
      for (int h2 = warp; h2 < g_n; h2 += WARPS) {   // a warp a head
        const float m0 = merge_m[h2];
        float m = m0;
        for (int s = lane; s < nb; s += 32) m = fmaxf(m, wm[s * g_n + h2]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
        float l = 0.f;
        for (int s = lane; s < nb; s += 32) {
          const float w = expf(wm[s * g_n + h2] - m);
          wm[s * g_n + h2] = w;
          l += wl[s * g_n + h2] * w;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          l += __shfl_xor_sync(0xffffffffu, l, o);
        if (lane == 0) {
          const float f = expf(m0 - m);
          merge_f[h2] = f;
          merge_m[h2] = m;
          merge_l[h2] = merge_l[h2] * f + l;
        }
      }
      __syncthreads();
      if (!mine) continue;
      const float f = merge_f[g];
      a.x *= f;
      a.y *= f;
      a.z *= f;
      a.w *= f;
      const int per = (nb + runs - 1) / runs;
      const int s0 = rn * per, s1 = min(nb, s0 + per);
      for (int sb = s0; sb < s1; sb += MERGE_BATCH) {
        float4 ld[MERGE_BATCH];
#pragma unroll
        for (int e = 0; e < MERGE_BATCH; ++e) {
          const float* src = pa + (int64_t)(b0 + sb + e) * gd + qd * qw;
          if (sb + e >= s1)
            ld[e] = make_float4(0.f, 0.f, 0.f, 0.f);
          else if (qw == 4)
            ld[e] = __ldcg(reinterpret_cast<const float4*>(src));
          else
            ld[e] = make_float4(__ldcg(src), 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int e = 0; e < MERGE_BATCH; ++e) {
          if (sb + e < s1) {
            const float w = wm[(sb + e) * g_n + g];
            a.x += ld[e].x * w;
            a.y += ld[e].y * w;
            a.z += ld[e].z * w;
            a.w += ld[e].w * w;
          }
        }
      }
    }
    reinterpret_cast<float4*>(run)[tid] = a;
    __syncthreads();
    if (tid < min(nq - q0, THREADS)) {
      float4 s = reinterpret_cast<float4*>(run)[tid];
      for (int rr = 1; rr < runs; ++rr) {
        const float4 t = reinterpret_cast<float4*>(run)[rr * stride + tid];
        s.x += t.x;
        s.y += t.y;
        s.z += t.z;
        s.w += t.w;
      }
      const int qd = q0 + tid;
      const float l = fmaxf(merge_l[qd * qw / d_n], 1e-30f);
      T* o = ob + qd * qw;
      put(o, s.x / l);
      if (qw == 4) {
        put(o + 1, s.y / l);
        put(o + 2, s.z / l);
        put(o + 3, s.w / l);
      }
    }
  }
  if (tid == 0) *tk = 0u;     // ready for the next launch
}

template <typename T, int GT>
cudaError_t launch(cudaStream_t stream, const void* q, const void* k,
                   const void* v, const int* pos, const int* base, float* pm,
                   float* pl, float* pa, void* out, unsigned int* ticket,
                   long long B, long long t_len, long long KV, long long G,
                   long long D, long long window, long long nsplit,
                   int len_max, float scale) {
  const int vec = (D * (long long)sizeof(T)) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const Layout lay(sizeof(T), (int)D, (int)G, pv_heads<T, GT>(), len_max);
  if (lay.total > 232448) return cudaErrorInvalidValue;
  auto kern = swa_decode_kernel<T, GT>;
  // set on every launch: the attribute holds per device
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.total);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)nsplit, (unsigned)KV, (unsigned)B);
  kern<<<grid, THREADS, (size_t)lay.total, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pos, base, pm, pl, pa, static_cast<T*>(out),
      ticket, (int)t_len, (int)KV, (int)G, (int)D, (int)window, len_max, vec,
      scale, lay);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_g(cudaStream_t stream, const void* q, const void* k,
                     const void* v, const int* pos, const int* base,
                     float* pm, float* pl, float* pa, void* out,
                     unsigned int* ticket, long long B, long long t_len,
                     long long KV, long long G, long long D, long long window,
                     long long nsplit, int len_max, float scale) {
  if (G <= 1)
    return launch<T, 1>(stream, q, k, v, pos, base, pm, pl, pa, out, ticket,
                        B, t_len, KV, G, D, window, nsplit, len_max, scale);
  if (G <= 2)
    return launch<T, 2>(stream, q, k, v, pos, base, pm, pl, pa, out, ticket,
                        B, t_len, KV, G, D, window, nsplit, len_max, scale);
  if (G <= 4)
    return launch<T, 4>(stream, q, k, v, pos, base, pm, pl, pa, out, ticket,
                        B, t_len, KV, G, D, window, nsplit, len_max, scale);
  if (G <= 8)
    return launch<T, 8>(stream, q, k, v, pos, base, pm, pl, pa, out, ticket,
                        B, t_len, KV, G, D, window, nsplit, len_max, scale);
  return launch<T, 16>(stream, q, k, v, pos, base, pm, pl, pa, out, ticket,
                       B, t_len, KV, G, D, window, nsplit, len_max, scale);
}

}  // namespace

extern "C" {

// q (B, KV, G, D); k, v (B, T, KV, D); out (B, KV, G, D), all contiguous
// in one dtype (is_bf16: bfloat16, else float32); pos, base (B,) int32;
// part_m, part_l (B, KV, nsplit, G) and part_acc (B, KV, nsplit, G, D)
// f32 scratch; ticket (B * KV) unsigned ints, zeroed, left zeroed.  Every
// row's split holds at most len_max live keys: 16 * ceil(ceil(L / nsplit)
// / 16) with L = min(T, window) for window > 0, else T; G * len_max must
// not exceed SC_FLOATS.  Returns the cudaError_t of the launch (0 on
// success).
int swa_decode_launch(const void* q, const void* k, const void* v,
                      const int* pos, const int* base, float* part_m,
                      float* part_l, float* part_acc, void* out,
                      unsigned int* ticket, long long B, long long T,
                      long long KV, long long G, long long D,
                      long long window, long long nsplit, float scale,
                      int is_bf16, void* stream_ptr) {
  if (B <= 0 || B > 65535 || T <= 0 || T > (1LL << 30) || KV <= 0 ||
      KV > 65535 || G <= 0 || G > GMAX || D <= 0 || D > DMAX ||
      nsplit <= 0 || nsplit > T || window < -(1LL << 30) ||
      window > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  const long long l = window > 0 && window < T ? window : T;
  const long long len_max = round_up((l + nsplit - 1) / nsplit, SPLIT_ROUND);
  if (len_max * G > SC_FLOATS) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (is_bf16)
    return (int)launch_g<__nv_bfloat16>(stream, q, k, v, pos, base, part_m,
                                        part_l, part_acc, out, ticket, B, T,
                                        KV, G, D, window, nsplit,
                                        (int)len_max, scale);
  return (int)launch_g<float>(stream, q, k, v, pos, base, part_m, part_l,
                              part_acc, out, ticket, B, T, KV, G, D, window,
                              nsplit, (int)len_max, scale);
}

}  // extern "C"
