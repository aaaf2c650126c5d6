// One-bit (sign / mean) quantization with error feedback, for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/onebit_ef/kernel.py::onebit_ef (Pallas TPU,
// body _onebit_ef_kernel).
//
// Computes, per row of w = err + g (M, R), g and err f32: the sign classes
// w >= 0 (-0.0 is in the + class, NaN in the - class), their means (Eq. 30,
// counts clamped at 1), the sign map packed LSB first into ceil(R / 8)
// bytes (pad bits zero) and the residual w - Q(w), written to out (which
// may be err itself).  Any M and any R.
//
// What bounds it: device-memory bytes, 12 an entry (g and err read, the
// residual written) and one per 8 entries of signs; a few operations an
// entry.  At the simulator's sizes (M = B p rows, R = d <= 4096) a call
// moves at most about 1.6 MB, under half a microsecond of bytes, so the
// time is the launch and the dependent memory round trips.  The design
// therefore reads each row once: load, reduce, store.
//
// Layout: a thread owns units of 8 consecutive entries.  A unit's 8 signs
// are one byte of the sign map, stored with no exchange between lanes (a
// warp's bytes are one coalesced store) as soon as the unit is counted:
// the signs do not wait for the means.  A unit whose row starts 16-byte
// aligned (R % 4 == 0 and aligned pointers) loads and stores as two 16-byte
// accesses per array, any other unit entry by entry; a thread issues the
// loads of all its units before it adds any.  Each thread adds its units'
// entries in unit order, entry order inside a unit: s_pos += w or s_neg +=
// w, n_pos += 1 for w >= 0.  A warp adds its lanes by a fixed
// __shfl_xor_sync butterfly (offsets 16, 8, 4, 2, 1: x + x[lane ^ o], the
// same bits on both lanes of a pair).  Two routes, chosen from the shape
// on the host (kernel.py's plan, which states the rules):
//
// * warp rows (R <= WARP_ROW_MAX): one warp a row, up to ROWS_PER_BLOCK_MAX
//   rows a block (one until the rows fill the SMs twice over); lane l holds
//   units l, l + 32, ... (up to WARP_ROW_MAX / 256 of them) in registers.
//   After the butterfly every lane has the means and writes its residual
//   from registers: one load round and one store round, no shared memory,
//   no barrier.
// * cluster rows (longer R): a cluster of C CTAs of T threads a row, U
//   units a thread: in pass k, CTA c, slot j, thread t owns unit k C T U +
//   c T U + j T + t.  Each CTA adds its warps' butterfly sums in warp order
//   (every thread reads them after one __syncthreads).  Each CTA then
//   writes its partial into slot c of every CTA's shared memory
//   (cluster.map_shared_rank), and after one cluster.sync() every CTA adds
//   the C partials in rank order from its own shared memory, so every CTA
//   computes the same means; no CTA touches another's shared memory after
//   that barrier, so no second one is needed before exit.  (The CTAs arrive
//   at a relaxed cluster barrier when they start and wait on it before
//   their first remote write, so every CTA's shared memory exists then.)
//   Reading the partials remotely after the barrier, with a second barrier
//   before exit, was slower on the H100.  C = 1 launches as a plain block:
//   its exchange is the __syncthreads alone (a cluster barrier costs
//   microseconds on the H100, even in a cluster of one CTA).  A row longer
//   than C T CL_UNITS_MAX units (131,072 entries at C = 8, T = 256) loops
//   over passes: each thread reads its units once to count them and again
//   after the exchange to write them.  Every entry is read before it is
//   written by the thread that writes it, so out may alias err.  The rules
//   use constants only, so a row's summation order never depends on the
//   card.
//
// Means divide with IEEE division (__fdiv_rn; built without fast math);
// w = __fadd_rn(err, g) and the residual __fsub_rn(w, q), with no FMA
// contraction.  No float atomics: every output is the same bit for bit
// from run to run.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int WARP_ROW_MAX = 2048;     // entries: a row up to here, one warp
constexpr int WARP_UNITS_MAX = WARP_ROW_MAX / (32 * 8);   // 8 units a lane
constexpr int ROWS_PER_BLOCK_MAX = 8;  // warp rows: warps (rows) a block
constexpr int CL_T_MIN = 64;           // cluster rows: threads a CTA, at
constexpr int CL_T_MAX = 256;          // least and at most
constexpr int CL_UNITS_MAX = 8;        // units a thread holds in registers
constexpr int CL_MAX = 8;              // CTAs a cluster (portable limit)
constexpr unsigned FULL = 0xffffffffu;

struct Sums {
  float pos, neg;
  int n;
};

struct __align__(16) Raw {
  float g[8], e[8];
};

// The unit starting at entry i0 of a row, as loaded: entries past R read
// as 0 and are never counted.  Only loads, so that the loads of all of a
// thread's units are in flight together.
__device__ __forceinline__ void load_unit(const float* g, const float* e,
                                          long long i0, long long R, bool vec,
                                          Raw& x) {
  if (vec && i0 + 8 <= R) {
    *reinterpret_cast<float4*>(x.g) = *reinterpret_cast<const float4*>(g + i0);
    *reinterpret_cast<float4*>(x.g + 4) =
        *reinterpret_cast<const float4*>(g + i0 + 4);
    *reinterpret_cast<float4*>(x.e) = *reinterpret_cast<const float4*>(e + i0);
    *reinterpret_cast<float4*>(x.e + 4) =
        *reinterpret_cast<const float4*>(e + i0 + 4);
  } else {
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      x.g[b] = i0 + b < R ? g[i0 + b] : 0.f;
      x.e[b] = i0 + b < R ? e[i0 + b] : 0.f;
    }
  }
}

__device__ __forceinline__ void combine(const Raw& x, float (&w)[8]) {
#pragma unroll
  for (int b = 0; b < 8; ++b) w[b] = __fadd_rn(x.e[b], x.g[b]);
}

// Adds the unit's live entries to s and returns its sign byte.  The unit's
// + and - entries are summed as a tree, ((0 + 1) + (2 + 3)) + ((4 + 5) +
// (6 + 7)), with 0 in place of an entry of the other class or past R, and
// each tree added to s in unit order: short dependent chains.
__device__ __forceinline__ unsigned add_unit(const float (&w)[8], long long i0,
                                             long long R, Sums& s) {
  unsigned byte = 0;
  float vp[8], vn[8];
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const bool live = i0 + b < R;
    const bool p = w[b] >= 0.f;
    byte |= (unsigned)(live && p) << b;
    vp[b] = live && p ? w[b] : 0.f;
    vn[b] = live && !p ? w[b] : 0.f;
  }
  const float tp = __fadd_rn(__fadd_rn(__fadd_rn(vp[0], vp[1]),
                                       __fadd_rn(vp[2], vp[3])),
                             __fadd_rn(__fadd_rn(vp[4], vp[5]),
                                       __fadd_rn(vp[6], vp[7])));
  const float tn = __fadd_rn(__fadd_rn(__fadd_rn(vn[0], vn[1]),
                                       __fadd_rn(vn[2], vn[3])),
                             __fadd_rn(__fadd_rn(vn[4], vn[5]),
                                       __fadd_rn(vn[6], vn[7])));
  s.pos = __fadd_rn(s.pos, tp);
  s.neg = __fadd_rn(s.neg, tn);
  s.n += __popc(byte);
  return byte;
}

// Writes the unit's residual w - Q(w).
__device__ __forceinline__ void store_unit(float* out, long long i0,
                                           long long R, bool vec,
                                           const float (&w)[8], float mp,
                                           float mn) {
  float r[8];
#pragma unroll
  for (int b = 0; b < 8; ++b) r[b] = __fsub_rn(w[b], w[b] >= 0.f ? mp : mn);
  if (vec && i0 + 8 <= R) {
    *reinterpret_cast<float4*>(out + i0) = make_float4(r[0], r[1], r[2], r[3]);
    *reinterpret_cast<float4*>(out + i0 + 4) =
        make_float4(r[4], r[5], r[6], r[7]);
  } else {
#pragma unroll
    for (int b = 0; b < 8; ++b)
      if (i0 + b < R) out[i0 + b] = r[b];
  }
}

__device__ __forceinline__ void add_to(Sums& t, const Sums& o) {
  t.pos = __fadd_rn(t.pos, o.pos);
  t.neg = __fadd_rn(t.neg, o.neg);
  t.n += o.n;
}

__device__ __forceinline__ void warp_sum(Sums& s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    Sums x;
    x.pos = __shfl_xor_sync(FULL, s.pos, o);
    x.neg = __shfl_xor_sync(FULL, s.neg, o);
    x.n = __shfl_xor_sync(FULL, s.n, o);
    add_to(s, x);
  }
}

__device__ __forceinline__ void class_means(const Sums& s, long long R,
                                            float& mp, float& mn) {
  const long long n_neg = R - s.n;
  mp = __fdiv_rn(s.pos, (float)(s.n > 1 ? s.n : 1));
  mn = __fdiv_rn(s.neg, (float)(n_neg > 1 ? n_neg : 1));
}

template <int U>                       // units a lane: ceil(R / 256) <= U
__global__ void __launch_bounds__(ROWS_PER_BLOCK_MAX * 32) onebit_warp_rows(
    const float* g, const float* err, uint8_t* packed, float* means,
    float* out, long long M, long long R, int vec) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= M) return;                // the whole warp leaves together
  const long long nb = (R + 7) >> 3;
  const float* gr = g + row * R;
  const float* er = err + row * R;
  float w[U][8];
  Sums s = {0.f, 0.f, 0};
  {
    Raw x[U];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const long long u = (long long)j * 32 + lane;
      if (u < nb) load_unit(gr, er, u * 8, R, vec, x[j]);
    }
#pragma unroll
    for (int j = 0; j < U; ++j) combine(x[j], w[j]);
  }
#pragma unroll
  for (int j = 0; j < U; ++j) {
    const long long u = (long long)j * 32 + lane;
    if (u < nb) packed[row * nb + u] = (uint8_t)add_unit(w[j], u * 8, R, s);
  }
  warp_sum(s);
  float mp, mn;
  class_means(s, R, mp, mn);
  if (lane == 0) {
    means[2 * row] = mp;
    means[2 * row + 1] = mn;
  }
#pragma unroll
  for (int j = 0; j < U; ++j) {
    const long long u = (long long)j * 32 + lane;
    if (u < nb) store_unit(out + row * R, u * 8, R, vec, w[j], mp, mn);
  }
}

// T threads a CTA, U units a thread a pass, C CTAs a row; LOOP: more than
// one pass, the units read again after the exchange instead of kept.  CL:
// C > 1; without it (C == 1) the kernel holds no cluster instruction and
// launches as a plain block.
template <int T, int U, bool LOOP, bool CL>
__global__ void __launch_bounds__(T) onebit_cluster_rows(
    const float* g, const float* err, uint8_t* packed, float* means,
    float* out, long long M, long long R, int C, int passes, int vec) {
  constexpr int NW = T / 32;
  __shared__ Sums warp_part[NW];
  __shared__ Sums part[CL_MAX];        // the cluster's CTA partials, by rank
  int rank = 0;
  if constexpr (CL) {
    rank = (int)cg::this_cluster().block_rank();
    // arrive now, wait before the first remote write: every CTA of the
    // cluster has then started, so its shared memory may be written
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  }
  const long long row = (long long)blockIdx.x / C;
  const long long nb = (R + 7) >> 3;
  const float* gr = g + row * R;
  const float* er = err + row * R;
  uint8_t* prow = packed + row * nb;
  const long long stride = (long long)C * T * U;         // units a pass
  const long long first = (long long)rank * T * U + threadIdx.x;
  const int npass = LOOP ? passes : 1;

  float w[U][8];
  Sums s = {0.f, 0.f, 0};
  for (int k = 0; k < npass; ++k) {
    Raw x[U];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const long long u = k * stride + first + (long long)j * T;
      if (u < nb) load_unit(gr, er, u * 8, R, vec, x[j]);
    }
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const long long u = k * stride + first + (long long)j * T;
      combine(x[j], w[j]);
      if (u < nb) prow[u] = (uint8_t)add_unit(w[j], u * 8, R, s);
    }
  }
  warp_sum(s);
  if ((threadIdx.x & 31) == 0) warp_part[threadIdx.x >> 5] = s;
  __syncthreads();
  Sums tot = warp_part[0];             // every thread, in warp order
#pragma unroll
  for (int i = 1; i < NW; ++i) add_to(tot, warp_part[i]);
  if constexpr (CL) {
    cg::cluster_group cluster = cg::this_cluster();
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    if (threadIdx.x < C) *cluster.map_shared_rank(&part[rank], threadIdx.x) = tot;
    cluster.sync();                    // every partial has landed
    tot = part[0];
    for (int c = 1; c < C; ++c) add_to(tot, part[c]);
  }
  float mp, mn;
  class_means(tot, R, mp, mn);
  if (rank == 0 && threadIdx.x == 0) {
    means[2 * row] = mp;
    means[2 * row + 1] = mn;
  }
  float* orow = out + row * R;
  if (!LOOP) {
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const long long u = first + (long long)j * T;
      if (u < nb) store_unit(orow, u * 8, R, vec, w[j], mp, mn);
    }
    return;
  }
  for (int k = 0; k < npass; ++k) {
    Raw x[U];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const long long u = k * stride + first + (long long)j * T;
      if (u < nb) load_unit(gr, er, u * 8, R, vec, x[j]);
    }
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const long long u = k * stride + first + (long long)j * T;
      combine(x[j], w[j]);
      if (u < nb) store_unit(orow, u * 8, R, vec, w[j], mp, mn);
    }
  }
}

template <int U>
cudaError_t launch_warp(const float* g, const float* err, uint8_t* packed,
                        float* means, float* out, long long M, long long R,
                        int rows, int vec, cudaStream_t stream) {
  const long long blocks = (M + rows - 1) / rows;
  onebit_warp_rows<U><<<(unsigned)blocks, rows * 32, 0, stream>>>(
      g, err, packed, means, out, M, R, vec);
  return cudaGetLastError();
}

template <int T, int U, bool LOOP, bool CL>
cudaError_t launch_rows(const float* g, const float* err, uint8_t* packed,
                        float* means, float* out, long long M, long long R,
                        int C, int passes, int vec, cudaStream_t stream) {
  if constexpr (!CL) {
    onebit_cluster_rows<T, U, LOOP, false><<<(unsigned)M, T, 0, stream>>>(
        g, err, packed, means, out, M, R, 1, passes, vec);
    return cudaGetLastError();
  } else {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(M * C), 1, 1);
  cfg.blockDim = dim3(T, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, onebit_cluster_rows<T, U, LOOP, true>, g, err, packed, means,
      out, M, R, C, passes, vec);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
  }
}

// The CTAs of CL_T_MAX threads: one a row (C == 1) or a cluster's.
template <bool CL>
cudaError_t launch_rows_full(const float* g, const float* err,
                             uint8_t* packed, float* means, float* out,
                             long long M, long long R, int C, int U,
                             int passes, int vec, cudaStream_t stream) {
  constexpr int T = CL_T_MAX;
  if (passes > 1)
    return launch_rows<T, CL_UNITS_MAX, true, CL>(g, err, packed, means, out,
                                                  M, R, C, passes, vec,
                                                  stream);
  switch (U) {
    case 1: return launch_rows<T, 1, false, CL>(g, err, packed, means, out, M, R, C, 1, vec, stream);
    case 2: return launch_rows<T, 2, false, CL>(g, err, packed, means, out, M, R, C, 1, vec, stream);
    case 4: return launch_rows<T, 4, false, CL>(g, err, packed, means, out, M, R, C, 1, vec, stream);
    default: return launch_rows<T, 8, false, CL>(g, err, packed, means, out, M, R, C, 1, vec, stream);
  }
}

bool pow2_in(long long x, long long least, long long most) {
  return x >= least && x <= most && (x & (x - 1)) == 0;
}

}  // namespace

extern "C" {

// The layout constants, for the wrapper to check its own copy against:
// WARP_ROW_MAX, ROWS_PER_BLOCK_MAX, CL_T_MIN, CL_T_MAX, CL_UNITS_MAX,
// CL_MAX.
void onebit_ef_constants(long long* out) {
  out[0] = WARP_ROW_MAX;
  out[1] = ROWS_PER_BLOCK_MAX;
  out[2] = CL_T_MIN;
  out[3] = CL_T_MAX;
  out[4] = CL_UNITS_MAX;
  out[5] = CL_MAX;
}

// Returns the cudaError_t of the launch (0 on success).  cluster == 0 takes
// the warp rows, `threads` / 32 rows a block and `units` units a lane (R <=
// WARP_ROW_MAX, 32 units >= ceil(R / 8)); else the cluster rows with
// `cluster` CTAs of `threads` threads a row and `units` units a thread a
// pass, more than one pass only at units == CL_UNITS_MAX.
int onebit_ef_launch(const float* g, const float* err, unsigned char* packed,
                     float* means, float* out, long long M, long long R,
                     long long cluster, long long threads, long long units,
                     void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (M < 1 || R < 1 || R >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const int vec = R % 4 == 0 &&
                  ((uintptr_t)g | (uintptr_t)err | (uintptr_t)out) % 16 == 0;
  const long long nb = (R + 7) / 8;
  if (cluster == 0) {
    if (R > WARP_ROW_MAX || !pow2_in(units, 1, WARP_UNITS_MAX) ||
        units * 32 < nb || !pow2_in(threads, 32, ROWS_PER_BLOCK_MAX * 32))
      return (int)cudaErrorInvalidValue;
    const int rows = (int)(threads / 32);
    switch (units) {
      case 1: return (int)launch_warp<1>(g, err, packed, means, out, M, R, rows, vec, stream);
      case 2: return (int)launch_warp<2>(g, err, packed, means, out, M, R, rows, vec, stream);
      case 4: return (int)launch_warp<4>(g, err, packed, means, out, M, R, rows, vec, stream);
      default: return (int)launch_warp<8>(g, err, packed, means, out, M, R, rows, vec, stream);
    }
  }
  // the plan's shapes: fewer than CL_T_MAX threads only in a cluster, each
  // thread one unit; one CTA a row only of CL_T_MAX threads
  if (!pow2_in(cluster, 1, CL_MAX) || !pow2_in(units, 1, CL_UNITS_MAX) ||
      !pow2_in(threads, CL_T_MIN, CL_T_MAX) || M * cluster >= (1LL << 31) ||
      (threads < CL_T_MAX && (units != 1 || cluster == 1)))
    return (int)cudaErrorInvalidValue;
  const long long per_pass = cluster * threads * units;
  const long long passes = (nb + per_pass - 1) / per_pass;
  if (passes > 1 && (units != CL_UNITS_MAX || threads != CL_T_MAX ||
                     passes >= (1LL << 31)))
    return (int)cudaErrorInvalidValue;
  const int C = (int)cluster, U = (int)units, P = (int)passes;
  switch (threads) {
    case 64: return (int)launch_rows<64, 1, false, true>(g, err, packed, means, out, M, R, C, 1, vec, stream);
    case 128: return (int)launch_rows<128, 1, false, true>(g, err, packed, means, out, M, R, C, 1, vec, stream);
    default:
      if (C == 1)
        return (int)launch_rows_full<false>(g, err, packed, means, out, M, R, 1, U, P, vec, stream);
      return (int)launch_rows_full<true>(g, err, packed, means, out, M, R, C, U, P, vec, stream);
  }
}

}  // extern "C"
