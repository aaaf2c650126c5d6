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
// What bounds it: device-memory bytes -- the output is written once (4
// bytes an entry) and each message entry reads 2 or 4 bytes of value and 4
// of index.  No arithmetic to speak of.
//
// Design: the Pallas kernel gives one program a row block and streams all
// messages through it; at M = 1 (the training path) that is one program.
// Here the payloads are read as K1 (topk_ef.cu) writes them: every pick
// above the threshold in index order, then the ties in index order, so a
// payload row is at most kMaxRuns = 2 strictly ascending runs of indices.
// A block that owns a segment of kSeg entries of an output row then finds
// each message's picks there as one contiguous range of positions a run.
// Two launches a call on that route (the segment route), after a memset
// of the scratch:
//   runs     one pass over idx, into a scratch the launcher zeroes first:
//            per payload row its descent (a position p > 0 with idx[p] <=
//            idx[p - 1], where the second run starts) and the indices on
//            either side of it; for every segment boundary b * kSeg the
//            positions where a run crosses it (idx[p - 1] < b * kSeg <=
//            idx[p]), written by the pair of picks that straddles it: a
//            searchsorted by scatter, not a search a block.  A strictly
//            ascending run crosses a boundary at most once, so a boundary
//            has at most two crossings, kept as their minimum (as max(k -
//            p)) and maximum (as max(p + 1)).  A pair whose indices span
//            many boundaries (a sparse run of ties) writes them all, its
//            warp 32 at a time.  A row of more than kMaxRuns runs sets
//            the route flag: the call takes the atomic route.
//   segment  one block per (m, segment): the segment zeroed to +0.0 in
//            shared memory; each message's ranges from one round of loads
//            (the run's end indices and the crossings: a run's range starts
//            at its start when its first index is in or past the segment,
//            at its end when its last index is before it, else at the
//            crossing); the picks of two messages at a time loaded
//            together; their products added there with shared-memory
//            atomics, message by message, a block barrier between; and
//            the segment written once with 16-byte stores.
// On the atomic route (a payload not in K1's order) the segment launch
// writes zeros and S scatter launches, one a message in order on the
// stream, do one atomicAdd(out + target, v * w) a pick; on the segment
// route they exit at once.  The route is chosen on the device, with no
// read-back to the host.  Both routes round the product first (__fmul_rn:
// no FMA contraction) and add it to a sum that starts at +0.0 (0 + -0.0 is
// +0.0, as in the plain version).  Indices unique within a row (a top-k
// message) make each word take at most one add a message, and messages
// are ordered on both routes: the result is bitwise the plain version's
// and the same from run to run.  Duplicate indices inside one message
// still all land (the adds are atomic), but the order of their adds, and
// so the rounding of their sum, is then not fixed.  Rows need not start on
// 16 bytes (R % 4 != 0): the segment writes a scalar head up to the first
// 16-byte boundary, and keeps its shared copy shifted so that the 16-byte
// reads line up.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSegShift = 13;
constexpr int kSeg = 1 << kSegShift;         // entries of a segment: 32 KB
constexpr int kMaxRuns = 2;                  // ascending runs a payload row
constexpr int kQuads = 2;                    // fours of positions a thread
constexpr int kChunk = 4 * kQuads * kThreads;  // positions a block, run pass
constexpr int kGridCap = 132 * 8;            // run and scatter grids
constexpr int kGroup = 64;                   // messages whose ranges a
                                             // block holds at once
constexpr int kUnroll = 4;                   // picks a thread loads a message
constexpr int kBatch = kUnroll * kThreads;
constexpr int kHead = 4;                     // scratch words before the rows

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

int64_t num_segments(int64_t r) { return (r + kSeg - 1) / kSeg; }

// The scratch, int32 words zeroed by the launcher:
//   [0]                 the route flag, 1 = the atomic route;
//   rec[4 row .. +3]    the row's descent position (0: none), the indices
//                       at positions d - 1 and d, and a spare word;
//   cross[row][b][2]    for b in [0, nseg], the crossings of b * kSeg as
//                       max(k - p) and max(p + 1), 0 for none.
int64_t scratch_words(int64_t rows, int64_t r) {
  return kHead + 4 * rows + 2 * rows * (num_segments(r) + 1);
}

struct Scratch {
  int* flag;
  int* rec;
  int* cross;
  int64_t nseg;
  __device__ Scratch(int* base, int64_t rows, int64_t nseg_)
      : flag(base), rec(base + kHead), cross(base + kHead + 4 * rows),
        nseg(nseg_) {}
  __device__ int* at(int64_t row, int64_t b) const {
    return cross + 2 * (row * (nseg + 1) + b);
  }
};

// Positions f .. f + 3 of the flattened payload (0 past n): one 16-byte
// load when idx is 16-byte aligned and all four are live.
__device__ __forceinline__ int4 load4(const int32_t* idx, int64_t f,
                                      int64_t n, bool vec) {
  if (vec && f + 4 <= n) return *reinterpret_cast<const int4*>(idx + f);
  int4 v;
  v.x = f < n ? idx[f] : 0;
  v.y = f + 1 < n ? idx[f + 1] : 0;
  v.z = f + 2 < n ? idx[f + 2] : 0;
  v.w = f + 3 < n ? idx[f + 3] : 0;
  return v;
}

// The segment of index x, clamped to [0, nseg].
__device__ __forceinline__ int seg_of(int x, int64_t nseg) {
  return min(max(x >> kSegShift, 0), (int)nseg);
}

__device__ __forceinline__ int elem(const int4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// Position j of a thread's four, whose first is at offset off of row `row`
// (off < k): its row and its offset in that row.
__device__ __forceinline__ void place(int64_t row, int64_t off, int j,
                                      int64_t k, int64_t* r, int* p) {
  int64_t o = off + j;
  int64_t rr = row;
  if (o >= k) {                              // the four straddle a row end
    rr += o / k;
    o -= (rr - row) * k;
  }
  *r = rr;
  *p = (int)o;
}

// A warp's descents (bit j of desc: position j of the lane's four): when
// kMaxRuns lanes see one in the same row (the first and the last such
// lane agree) the call takes the atomic route (*flag = 1) and this returns
// true; else each descent is recorded in its row's rec, and a second one
// in a row sets *flag.  All 32 lanes call it.
__device__ __noinline__ bool record_descents(int* recs, int64_t row,
                                             int64_t off, int4 v, int prev,
                                             unsigned desc, int64_t k,
                                             int* flag) {
  const int lane = threadIdx.x & 31;
  const unsigned dlanes = __ballot_sync(kFull, desc != 0);
  int64_t drow = row;                        // the row of the first descent
  int dp = 0;
  if (desc) place(row, off, __ffs(desc) - 1, k, &drow, &dp);
  const int64_t first = __shfl_sync(kFull, drow, __ffs(dlanes) - 1);
  const int64_t last = __shfl_sync(kFull, drow, 31 - __clz(dlanes));
  if (__popc(dlanes) >= kMaxRuns && first == last) {
    if (lane == 0) *flag = 1;
    return true;
  }
  for (unsigned d = desc; d; d &= d - 1) {
    const int j = __ffs(d) - 1;
    int64_t r;
    int p;
    place(row, off, j, k, &r, &p);
    int* rec = recs + 4 * r;
    if (atomicMax(rec, p) != 0) *flag = 1;   // a second descent
    rec[1] = j ? elem(v, j - 1) : prev;
    rec[2] = elem(v, j);
  }
  return false;
}

// The boundaries a warp's ascending pairs cross, written into the
// crossing table: the warp takes each lane that has some in turn and
// writes them 32 at a time, so a long gap (a sparse run, such as a few
// ties spread over the row) does not hold one lane for thousands of
// writes.  All 32 lanes call it.
__device__ __noinline__ void write_crossings(int* cross, int64_t nseg,
                                             int64_t row, int64_t off, int4 v,
                                             int prev, unsigned up, int tot,
                                             int64_t k) {
  const int lane = threadIdx.x & 31;
  for (unsigned todo = __ballot_sync(kFull, tot > 0); todo;
       todo &= todo - 1) {
    const int who = __ffs(todo) - 1;
    const int64_t w_row = __shfl_sync(kFull, row, who);
    const int64_t w_off = __shfl_sync(kFull, off, who);
    const int4 w_v = make_int4(
        __shfl_sync(kFull, v.x, who), __shfl_sync(kFull, v.y, who),
        __shfl_sync(kFull, v.z, who), __shfl_sync(kFull, v.w, who));
    const unsigned w_up = __shfl_sync(kFull, up, who);
    int qp = seg_of(__shfl_sync(kFull, prev, who), nseg);
    for (int j = 0; j < 4; ++j) {
      const int qj = seg_of(elem(w_v, j), nseg);
      if (w_up >> j & 1) {
        int64_t r;
        int p;
        place(w_row, w_off, j, k, &r, &p);
        for (int bq = qp + 1 + lane; bq <= qj; bq += 32) {
          int* c = cross + 2 * (r * (nseg + 1) + bq);
          atomicMax(c, (int)k - p);
          atomicMax(c + 1, p + 1);
        }
      }
      qp = qj;
    }
  }
}

// Blocks walk chunks of kChunk consecutive positions of the flattened
// (rows, k) payload, a grid stride apart; a thread holds four consecutive
// positions a trip, and the lanes of a warp consecutive fours.  Along a
// strictly ascending stretch the boundaries crossed telescope: the four's
// pairs cross (q(before), q(last)] with q = the clamped index >> kSegShift.
// inv_k = 1.0 / k.
__global__ void __launch_bounds__(kThreads)
    topk_reduce_runs_kernel(const int32_t* __restrict__ idx, int* scratch,
                            int64_t rows, int64_t k, double inv_k,
                            int64_t nseg) {
  const Scratch sc(scratch, rows, nseg);
  const int64_t n = rows * k;
  const int lane = threadIdx.x & 31;
  const bool vec = ((uintptr_t)idx & 15) == 0;
  // set once this block saw a row of more than kMaxRuns runs: the call
  // takes the atomic route, and crossings are moot from then on
  __shared__ int s_flag;
  if (threadIdx.x == 0) s_flag = 0;
  __syncthreads();
  for (int64_t base = (int64_t)blockIdx.x * kChunk; base < n;
       base += (int64_t)gridDim.x * kChunk) {
    // every load first: the bytes in flight are what this pass runs on
    int4 v[kQuads];
    int lead[kQuads];
#pragma unroll
    for (int it = 0; it < kQuads; ++it) {
      const int64_t f = base + 4 * (it * kThreads + threadIdx.x);
      v[it] = load4(idx, f, n, vec);
      lead[it] = lane == 0 && f > 0 && f <= n ? idx[f - 1] : 0;
    }
    const bool atomic_known = *reinterpret_cast<volatile int*>(&s_flag);
    // the chunk's first row, by a reciprocal (exact after one correction)
    int64_t row0 = (int64_t)((double)base * inv_k);
    if (row0 * k > base) --row0;
    if ((row0 + 1) * k <= base) ++row0;
#pragma unroll
    for (int it = 0; it < kQuads; ++it) {
      const int64_t f = base + 4 * (it * kThreads + threadIdx.x);
      int64_t row = row0;
      int64_t off = f - row0 * k;
      if (off >= k) {
        row += off / k;
        off -= (row - row0) * k;
      }
      int prev = __shfl_up_sync(kFull, v[it].w, 1);
      if (lane == 0) prev = lead[it];
      // per position j: the pair (j - 1, j) lies in one row, and descends
      unsigned pairs = 0, desc = 0;
      if (f + 4 <= n && off + 4 <= k) {      // four of one row, all live
        pairs = off > 0 ? 0xf : 0xe;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          int64_t r;
          int p;
          place(row, off, j, k, &r, &p);
          if (f + j < n && p > 0) pairs |= 1u << j;
        }
      }
      int before = prev;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int x = elem(v[it], j);
        if ((pairs >> j & 1) && x <= before) desc |= 1u << j;
        before = x;
      }
      const bool multi = __ballot_sync(kFull, desc != 0) &&
                         record_descents(sc.rec, row, off, v[it], prev, desc,
                                         k, &s_flag);
      if (multi || atomic_known) continue;
      // the boundaries ascending pair j crosses: b in (q[j], q[j + 1]], q
      // the clamped index >> kSegShift (q[0] that of the index before the
      // four); along four ascending pairs they telescope
      const unsigned up = pairs & ~desc;
      const int qa = seg_of(prev, nseg);
      int tot = 0;
      if (up == 0xf) {
        tot = seg_of(v[it].w, nseg) - qa;
      } else {
        int qp = qa;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qj = seg_of(elem(v[it], j), nseg);
          if (up >> j & 1) tot += max(qj - qp, 0);
          qp = qj;
        }
      }
      if (__ballot_sync(kFull, tot > 0))
        write_crossings(sc.cross, nseg, row, off, v[it], prev, up, tot, k);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0 && s_flag) *sc.flag = 1;
}

// The first position of run [a, e), whose first and last indices are ia
// and ie, with an index >= b * kSeg; c: boundary b's crossings, of which
// the first run takes the minimum and the second the maximum.
__device__ __forceinline__ int run_start(int a, int e, int ia, int ie,
                                         int64_t b, int2 c, bool second,
                                         int k) {
  const int64_t bound = b << kSegShift;
  if (e <= a || ia >= bound) return a;
  if (ie < bound) return e;
  const int p = second ? c.y - 1 : k - c.x;
  return min(max(p, a), e);                  // clamped: memory-safe always
}

// What a message row's ranges in segment b are computed from, loaded in
// one round: the row's record, boundary b's and b + 1's crossings, and the
// row's first and last indices.
struct RangeLoads {
  int4 rec;
  int2 c0, c1;
  int first, last;
};

__device__ __forceinline__ RangeLoads range_loads(const int32_t* idx,
                                                  const Scratch& sc,
                                                  int64_t row, int64_t k,
                                                  int64_t b) {
  RangeLoads L;
  L.rec = *reinterpret_cast<const int4*>(sc.rec + 4 * row);
  L.c0 = *reinterpret_cast<const int2*>(sc.at(row, b));
  L.c1 = *reinterpret_cast<const int2*>(sc.at(row, b + 1));
  L.first = idx[row * k];
  L.last = idx[row * k + k - 1];
  return L;
}

// The ranges: positions [lo[r], lo[r] + n[r]) of the row's runs r in
// segment b.  Meaningful on the segment route only; memory-safe on both.
__device__ __forceinline__ void ranges_of(const RangeLoads& L, int k,
                                          int64_t b, int* lo, int* n) {
  const int d = L.rec.x;
  const int e0 = d ? d : k;                  // the first run is [0, e0)
  const int ie0 = d ? L.rec.y : L.last;
  lo[0] = run_start(0, e0, L.first, ie0, b, L.c0, false, k);
  n[0] = max(run_start(0, e0, L.first, ie0, b + 1, L.c1, false, k) - lo[0],
             0);
  lo[1] = run_start(e0, k, L.rec.z, L.last, b, L.c0, true, k);
  n[1] = max(run_start(e0, k, L.rec.z, L.last, b + 1, L.c1, true, k) - lo[1],
             0);
}

// Picks [i0, i0 + kBatch) of a message's ranges (lo, n), at payload row
// offset rowoff: their indices (-1 past the ranges) and values.
template <typename T>
__device__ __forceinline__ void load_picks(const T* vals, const int32_t* idx,
                                           int64_t rowoff, const int* lo,
                                           const int* n, int i0,
                                           int (&ix)[kUnroll],
                                           float (&v)[kUnroll]) {
  const int total = n[0] + n[1];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int i = i0 + u * kThreads + threadIdx.x;
    ix[u] = -1;
    v[u] = 0.f;
    if (i < total) {
      const int64_t p = rowoff + (i < n[0] ? lo[0] + i : lo[1] + i - n[0]);
      ix[u] = idx[p];
      v[u] = to_float(vals[p]);
    }
  }
}

__device__ __forceinline__ void add_picks(float* seg,
                                          const int (&ix)[kUnroll],
                                          const float (&v)[kUnroll], float w,
                                          int64_t seg0, int n) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t o = (int64_t)ix[u] - seg0;
    if (ix[u] >= 0 && o >= 0 && o < n) atomicAdd(seg + o, __fmul_rn(v[u], w));
  }
}

// Adds the messages s0 .. s0 + g - 1 (ranges in s_lo, s_n) into the
// segment, two at a time, a block barrier between messages and after.
template <typename T>
__device__ __forceinline__ void add_messages(
    float* seg, const T* vals, const int32_t* idx, const float* weights,
    int64_t s0, int g, const int (*s_lo)[kMaxRuns],
    const int (*s_n)[kMaxRuns], int64_t M, int64_t m, int64_t k,
    int64_t seg0, int n) {
  for (int j = 0; j < g; j += 2) {
    const int pair = min(2, g - j);
    const int64_t s = s0 + j;
    const int64_t off0 = (s * M + m) * k;
    const int64_t off1 = off0 + M * k;
    const float w0 = weights[s];
    const float w1 = pair > 1 ? weights[s + 1] : 0.f;
    const int t0 = s_n[j][0] + s_n[j][1];
    const int t1 = pair > 1 ? s_n[j + 1][0] + s_n[j + 1][1] : 0;
    if (t0 <= kBatch && t1 <= kBatch) {      // both messages' loads at once
      int ix0[kUnroll], ix1[kUnroll];
      float v0[kUnroll], v1[kUnroll];
      load_picks(vals, idx, off0, s_lo[j], s_n[j], 0, ix0, v0);
      if (pair > 1)
        load_picks(vals, idx, off1, s_lo[j + 1], s_n[j + 1], 0, ix1, v1);
      add_picks(seg, ix0, v0, w0, seg0, n);
      if (pair > 1) {
        __syncthreads();                     // message s before s + 1
        add_picks(seg, ix1, v1, w1, seg0, n);
      }
    } else {
      for (int q = 0; q < pair; ++q) {
        if (q) __syncthreads();              // message s before s + 1
        const int tq = q ? t1 : t0;
        for (int i0 = 0; i0 < tq; i0 += kBatch) {
          int ix[kUnroll];
          float v[kUnroll];
          load_picks(vals, idx, q ? off1 : off0, s_lo[j + q], s_n[j + q], i0,
                     ix, v);
          add_picks(seg, ix, v, q ? w1 : w0, seg0, n);
        }
      }
    }
    __syncthreads();                         // these two before the next
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 6)
    topk_reduce_segment_kernel(float* __restrict__ out,
                               const T* __restrict__ vals,
                               const int32_t* __restrict__ idx,
                               const float* __restrict__ weights,
                               int* scratch, int64_t S, int64_t M, int64_t R,
                               int64_t k, int64_t nseg) {
  __shared__ float4 seg4[kSeg / 4 + 1];
  __shared__ int s_lo[kGroup][kMaxRuns];
  __shared__ int s_n[kGroup][kMaxRuns];
  __shared__ int s_atomic;
  const Scratch sc(scratch, S * M, nseg);
  const int64_t m = blockIdx.x / nseg;
  const int64_t b = blockIdx.x - m * nseg;
  const int64_t seg0 = b * kSeg;
  const int n = (int)min((int64_t)kSeg, R - seg0);
  float* dst = out + m * R + seg0;
  // the floats before dst's first 16-byte boundary; entry i of the
  // segment lives at seg[i] = seg4's float shift + i, so that dst + head
  // meets a whole float4 of seg4
  const int head = min((int)((4 - ((uintptr_t)dst >> 2)) & 3), n);
  const int shift = (4 - head) & 3;
  float* seg = reinterpret_cast<float*>(seg4) + shift;
  for (int i = threadIdx.x; i < kSeg / 4 + 1; i += kThreads)
    seg4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (threadIdx.x == 0) s_atomic = *sc.flag;
  for (int64_t g0 = 0; g0 < S; g0 += kGroup) {
    const int g = (int)min((int64_t)kGroup, S - g0);
    for (int j = threadIdx.x; j < g; j += kThreads)
      ranges_of(range_loads(idx, sc, (g0 + j) * M + m, k, b), (int)k, b,
                s_lo[j], s_n[j]);
    __syncthreads();                         // zeros, flag and ranges are in
    if (s_atomic) break;                     // the segment stays zero
    add_messages(seg, vals, idx, weights, g0, g, s_lo, s_n, M, m, k, seg0, n);
  }
  __syncthreads();                           // zeros and sums are in
  for (int i = threadIdx.x; i < head; i += kThreads) dst[i] = seg[i];
  const int n4 = (n - head) >> 2;
  float4* dst4 = reinterpret_cast<float4*>(dst + head);
  const float4* src4 = seg4 + (shift + head) / 4;
  for (int i = threadIdx.x; i < n4; i += kThreads) dst4[i] = src4[i];
  for (int i = head + 4 * n4 + threadIdx.x; i < n; i += kThreads)
    dst[i] = seg[i];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    topk_reduce_scatter_kernel(float* __restrict__ out,
                               const T* __restrict__ vals,
                               const int32_t* __restrict__ idx,
                               const float* __restrict__ weights,
                               const int* __restrict__ flag, int64_t s,
                               int64_t M, int64_t R, int64_t k) {
  if (*flag == 0) return;                    // the segment route
  const int64_t n = M * k;
  const float w = weights[s];
  for (int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x; e < n;
       e += (int64_t)gridDim.x * kThreads) {
    const int64_t m = e / k;
    const int64_t off = s * n + e;
    atomicAdd(out + m * R + idx[off], __fmul_rn(to_float(vals[off]), w));
  }
}

unsigned grid_of(int64_t want) {
  return (unsigned)(want < kGridCap ? (want > 0 ? want : 1) : kGridCap);
}

template <typename T>
int launch(float* out, const T* vals, const int* idx, const float* weights,
           int* scratch, long long S, long long M, long long R, long long k,
           cudaStream_t stream) {
  const int64_t nseg = num_segments(R);
  if (M * nseg == 0) return 0;
  if (S * M * k == 0) S = 0;                 // the zero fill alone
  const int64_t rows = S * M;
  cudaError_t e = cudaMemsetAsync(
      scratch, 0, sizeof(int) * scratch_words(rows, R), stream);
  if (e != cudaSuccess) return (int)e;
  if (rows > 0) {
    topk_reduce_runs_kernel<<<grid_of((rows * k + kChunk - 1) / kChunk),
                              kThreads, 0, stream>>>(
        idx, scratch, rows, k, 1.0 / (double)k, nseg);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  topk_reduce_segment_kernel<T><<<(unsigned)(M * nseg), kThreads, 0,
                                  stream>>>(out, vals, idx, weights, scratch,
                                            S, M, R, k, nseg);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  for (int64_t s = 0; s < S; ++s) {
    topk_reduce_scatter_kernel<T>
        <<<grid_of((M * k + kThreads - 1) / kThreads), kThreads, 0,
           stream>>>(out, vals, idx, weights, scratch, s, M, R, k);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

extern "C" {

// int32 words of scratch the launcher needs for S messages of M rows of R.
long long topk_cr_reduce_scratch_words(long long S, long long M,
                                       long long R) {
  return scratch_words(S * M, R);
}

// vals_bf16 != 0: vals are bfloat16, else float32.  scratch: the int32
// words above (at least), zeroed here.  Returns the first cudaError_t seen
// (0 on success).
int topk_cr_reduce_launch(float* out, const void* vals, int vals_bf16,
                          const int* idx, const float* weights, int* scratch,
                          long long S, long long M, long long R, long long k,
                          void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (vals_bf16)
    return launch(out, static_cast<const __nv_bfloat16*>(vals), idx, weights,
                  scratch, S, M, R, k, stream);
  return launch(out, static_cast<const float*>(vals), idx, weights, scratch,
                S, M, R, k, stream);
}

}  // extern "C"
