// Fused top-k + error feedback over whole rows, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/topk_ef/kernel.py::topk_ef (Pallas TPU).
//
// Computes, per row of (M, R):  w = err + f32(g);  pick the k entries of
// largest |w| (on ties the lowest index wins, as lax.top_k does);  emit
// vals (M, k) = w at the picks (signed), idx (M, k) int32, and
// new_err (M, R) = w with the picks zeroed.  The order of the picks inside
// a row is the documented one: every entry with |w| above the threshold
// first, then the ties, each group in index order, so the output is
// deterministic.
//
// What bounds it: device-memory bytes.  Every element must be read twice
// (g and err) and new_err written once, 12 bytes per element, plus 8 bytes
// per pick; there is no arithmetic to speak of.  The training path calls it
// with M = 1 and R up to 352,321,536 (a whole stacked leaf), so the work
// has to spread over all SMs along ONE row.
//
// Design: a radix select of the k-th largest key over the row, where the
// keys are the bit patterns of |w| (sign bit cleared; for non-negative
// floats they order like the values), split in three digits: bits 30..20,
// 19..9 and 8..0.  Four launches a call, whatever M and R:
//   hist   w = err + g with 16-byte loads, w written into new_err, and a
//          block-private shared histogram of digit 0, merged into the row's
//          histogram with integer atomics.  The last block to finish (an
//          integer ticket) suffix-scans the bins: bin b0 holds the k-th
//          largest key.  12 bytes an element.
//   cand   re-reads w: a histogram of digit 1 of the keys in bin b0, and
//          those keys compacted into a candidate list (each warp reserves
//          slots kBatch at a time, so one atomic serves many trips); the
//          last block fixes digit 1.  4 bytes an element, 4 a candidate.
//          After the first digit only bin b0 can change the answer: about
//          1.8% of a row of Gaussian-like w at ratio 1/16.
//   digit  a histogram of digit 2 of the candidates that share the first
//          two digits; the last block fixes T, the k-th largest key, and
//          need, the ties at T to take (k less the keys above T).  4 bytes
//          a candidate.
//   place  one block per chunk of 4096 entries, chunks taken in the order
//          an atomic counter hands them out: counts the keys > T and == T,
//          learns the counts of all earlier chunks by a decoupled look-back
//          (each chunk publishes its own counts, then their running total;
//          a waiting lane backs off, as every waiting warp polls the same
//          few words), and writes every key > T and the first `need` ties
//          in index order (one block scan of the per-thread counts of its 4
//          float4) into shared memory, then out as two contiguous runs (the
//          picks above T, the ties), zeroing new_err at the picks by
//          rewriting their 32-byte sectors whole.  4 bytes an element, 8 a
//          pick, and the sectors that hold picks (about 40% at ratio 1/16)
//          written again.
// Traffic: 20 bytes an element and 8 a pick, plus 8 a candidate and the
// rewritten sectors, against the 12 and 8 of the bound.  The candidate
// list holds `cap` keys a row (the launcher's argument; the wrapper gives
// max(R / 16, min(R, 65536))) and the slots the warps may leave unused.
// When bin b0 holds more keys than cap (ties, all-zero rows, few distinct
// magnitudes), which the hist pass's last block knows exactly, cand
// compacts nothing and digit histograms w itself, the whole row again: 24
// bytes an element.  The choice is made on the device; nothing goes back
// to the host.
// Determinism: counts are merged with integer atomics and picks placed by
// offsets that are exact prefix sums, so nothing depends on the order in
// which blocks run.  The histograms, tickets and counters live in a
// zeroed scratch kept across calls (the wrapper's), and every launch
// leaves them zeroed again, so launches of one wrapper must be ordered on
// one stream.  new_err may alias err or g: hist reads err[i] and g[i] and
// writes new_err[i] in the same thread, and no later pass reads err or g.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBins0 = 2048;                 // key bits 30..20
constexpr int kBins1 = 2048;                 // key bits 19..9
constexpr int kBins2 = 512;                  // key bits 8..0
// per row, zeroed between calls: the three histograms, then the tickets of
// hist, cand and digit, the candidate count and place's chunk counter
constexpr int kTicketHist = kBins0 + kBins1 + kBins2;
constexpr int kTicketCand = kTicketHist + 1;
constexpr int kTicketDigit = kTicketHist + 2;
constexpr int kCandCount = kTicketHist + 3;
constexpr int kChunkCount = kTicketHist + 4;
constexpr int kZeroedWords = kTicketHist + 8;
// per row, per call: the prefix of T (T at the end), need, the candidate
// count, and whether bin b0 overflowed the candidate list
constexpr int kStateWords = 4;
constexpr int kVecHist = 2;                  // float4 of g and err a trip
constexpr int kVecCand = 4;
constexpr int kVecDigit = 2;
constexpr int kVecPlace = 4;
constexpr int64_t kChunk = (int64_t)kVecPlace * kThreads * 4;   // 4096
constexpr int kMaxGridY = 65535;
// place's look-back words: 2 flag bits, the count > T (31 bits) and the
// count == T (31 bits); R < 2^31, so sums of either never carry over
constexpr unsigned long long kFlagAgg = 1ull << 62;
constexpr unsigned long long kFlagSum = 2ull << 62;
constexpr unsigned long long kPayload = (1ull << 62) - 1;
constexpr uint32_t kBatch = 32 * kVecCand * 4;   // list slots a warp takes
constexpr uint32_t kNoKey = 0xffffffffu;     // an unused slot (bit 31 set)

__device__ __forceinline__ uint32_t key_of(float w) {
  return __float_as_uint(w) & 0x7fffffffu;
}

__device__ __forceinline__ float elem(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// Elements i..i+3 of a row of n (0 past n).  VEC: one 16-byte load when
// the four are in the row (the row start is 16-byte aligned).
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* p, int64_t i,
                                        int64_t n) {
  if (VEC && i + 4 <= n) return *reinterpret_cast<const float4*>(p + i);
  float4 v;
  v.x = i < n ? p[i] : 0.f;
  v.y = i + 1 < n ? p[i + 1] : 0.f;
  v.z = i + 2 < n ? p[i + 2] : 0.f;
  v.w = i + 3 < n ? p[i + 3] : 0.f;
  return v;
}

template <bool VEC>
__device__ __forceinline__ void store4(float* p, int64_t i, int64_t n,
                                       float4 v) {
  if (VEC && i + 4 <= n) {
    *reinterpret_cast<float4*>(p + i) = v;
    return;
  }
  if (i < n) p[i] = v.x;
  if (i + 1 < n) p[i + 1] = v.y;
  if (i + 2 < n) p[i + 2] = v.z;
  if (i + 3 < n) p[i + 3] = v.w;
}

// Shared-memory histogram add of one key a lane (`in`: the lane counts).
// When every counting lane has the same bin (an all-zero or all-equal
// stretch) one lane adds them all; else each adds its own.  All 32 lanes
// must call it.
__device__ __forceinline__ void hist_add(uint32_t* sh, bool in,
                                         uint32_t bin) {
  const unsigned act = __ballot_sync(kFull, in);
  if (act == 0u) return;
  const int leader = __ffs(act) - 1;
  const uint32_t lb = __shfl_sync(kFull, bin, leader);
  if (__all_sync(kFull, !in || bin == lb)) {
    if ((int)(threadIdx.x & 31u) == leader)
      atomicAdd(&sh[lb], (uint32_t)__popc(act));
  } else if (in) {
    atomicAdd(&sh[bin], 1u);
  }
}

__device__ __forceinline__ uint32_t warp_scan(uint32_t v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t n = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += n;
  }
  return v;
}

// Exclusive scan of one value a thread, in thread order, over the block;
// *total gets the sum.  sh: kWarps words.  All threads must call it.
__device__ __forceinline__ uint32_t block_scan(uint32_t v, uint32_t* sh,
                                               uint32_t* total) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t inc = warp_scan(v);
  __syncthreads();                           // sh is free
  if (lane == 31) sh[warp] = inc;
  __syncthreads();
  uint32_t before = 0u, all = 0u;
#pragma unroll
  for (int j = 0; j < kWarps; ++j) {
    const uint32_t s = sh[j];
    if (j < warp) before += s;
    all += s;
  }
  *total = all;
  return inc - v + before;
}

// True in every thread of the block that finishes the row last, after all
// blocks have merged their counts.
__device__ __forceinline__ bool last_block(uint32_t* ticket,
                                           unsigned* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    *flag = atomicAdd(ticket, 1u) == gridDim.x - 1u;
  __syncthreads();
  const bool last = *flag != 0u;
  if (last) __threadfence();
  return last;
}

// Run by the last block of a row: with S[b] the keys in bins >= b, find
// the bin b with S[b] >= need > S[b + 1].  sel = {b, S[b + 1], keys in b}.
// Leaves the histogram zeroed.
template <int NBINS>
__device__ void select_bin(uint32_t* hist, uint32_t need, uint32_t* sh,
                           uint32_t* sel) {
  constexpr int PER = NBINS / kThreads;
  uint32_t h[PER];
  uint32_t s = 0u;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int b = NBINS - 1 - ((int)threadIdx.x * PER + j);
    h[j] = __ldcg(hist + b);
    hist[b] = 0u;
    s += h[j];
  }
  uint32_t total;
  uint32_t run = block_scan(s, sh, &total);
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    if (run < need && run + h[j] >= need) {
      sel[0] = (uint32_t)(NBINS - 1 - ((int)threadIdx.x * PER + j));
      sel[1] = run;
      sel[2] = h[j];
    }
    run += h[j];
  }
  __syncthreads();
}

// hist: w = err + g into new_err, histogram of digit 0, select it.  No
// __restrict__ on g, err and w: new_err may alias err or g.
template <bool VEC>
__global__ void __launch_bounds__(kThreads) topk_ef_hist(
    const float* g, const float* err, float* w, uint32_t* zeroed,
    uint32_t* state, int64_t M, int64_t R, int64_t k, int64_t cap) {
  __shared__ uint32_t sh[kBins0];
  __shared__ uint32_t red[kWarps];
  __shared__ uint32_t sel[3];
  __shared__ unsigned last;
  constexpr int64_t kTrip = (int64_t)kVecHist * kThreads * 4;
  for (int64_t row = blockIdx.y; row < M; row += gridDim.y) {
    for (int j = threadIdx.x; j < kBins0; j += kThreads) sh[j] = 0u;
    __syncthreads();
    const float* gr = g + row * R;
    const float* er = err ? err + row * R : nullptr;
    float* wr = w + row * R;
    for (int64_t base = (int64_t)blockIdx.x * kTrip; base < R;
         base += (int64_t)gridDim.x * kTrip) {
      float4 gv[kVecHist], ev[kVecHist];
#pragma unroll
      for (int u = 0; u < kVecHist; ++u) {
        const int64_t i = base + ((int64_t)u * kThreads + threadIdx.x) * 4;
        gv[u] = load4<VEC>(gr, i, R);
        ev[u] = er ? load4<VEC>(er, i, R) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kVecHist; ++u) {
        const int64_t i = base + ((int64_t)u * kThreads + threadIdx.x) * 4;
        float4 wv;
        wv.x = __fadd_rn(ev[u].x, gv[u].x);
        wv.y = __fadd_rn(ev[u].y, gv[u].y);
        wv.z = __fadd_rn(ev[u].z, gv[u].z);
        wv.w = __fadd_rn(ev[u].w, gv[u].w);
        store4<VEC>(wr, i, R, wv);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          hist_add(sh, i + e < R, key_of(elem(wv, e)) >> 20);
      }
    }
    __syncthreads();
    uint32_t* zr = zeroed + row * kZeroedWords;
    for (int j = threadIdx.x; j < kBins0; j += kThreads)
      if (sh[j]) atomicAdd(zr + j, sh[j]);
    if (last_block(zr + kTicketHist, &last)) {
      select_bin<kBins0>(zr, (uint32_t)k, red, sel);
      if (threadIdx.x == 0) {
        uint32_t* st = state + row * kStateWords;
        st[0] = sel[0] << 20;
        st[1] = (uint32_t)k - sel[1];
        st[2] = 0u;
        st[3] = (int64_t)sel[2] > cap ? 1u : 0u;
        zr[kTicketHist] = 0u;
      }
    }
    __syncthreads();
  }
}

// cand: histogram of digit 1 of the keys in bin b0, their keys into the
// candidate list (unless bin b0 overflowed it), select digit 1; also
// zeroes place's look-back words.  Each warp reserves list slots kBatch at
// a time with one atomic and fills them in order; the slots it leaves
// unused at the end of the row hold kNoKey, which no digit matches.
template <bool VEC>
__global__ void __launch_bounds__(kThreads) topk_ef_cand(
    const float* __restrict__ w, uint32_t* __restrict__ zeroed,
    uint32_t* __restrict__ state, uint32_t* __restrict__ cand,
    unsigned long long* __restrict__ look, int64_t M, int64_t R,
    int64_t list, int64_t nb) {
  __shared__ uint32_t sh[kBins1];
  __shared__ uint32_t red[kWarps];
  __shared__ uint32_t sel[3];
  __shared__ unsigned last;
  constexpr int64_t kTrip = (int64_t)kVecCand * kThreads * 4;
  const int lane = threadIdx.x & 31;
  for (int64_t row = blockIdx.y; row < M; row += gridDim.y) {
    for (int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x; j < nb;
         j += (int64_t)gridDim.x * kThreads)
      look[row * nb + j] = 0ull;
    for (int j = threadIdx.x; j < kBins1; j += kThreads) sh[j] = 0u;
    uint32_t* st = state + row * kStateWords;
    uint32_t* zr = zeroed + row * kZeroedWords;
    const uint32_t b0 = st[0] >> 20;
    const bool keep = st[3] == 0u;
    const float* wr = w + row * R;
    uint32_t* cr = cand + row * list;
    uint32_t next = 0u, left = 0u;           // this warp's reserved slots
    __syncthreads();
    for (int64_t start = (int64_t)blockIdx.x * kTrip; start < R;
         start += (int64_t)gridDim.x * kTrip) {
      float4 x[kVecCand];
#pragma unroll
      for (int u = 0; u < kVecCand; ++u)
        x[u] = load4<VEC>(
            wr, start + ((int64_t)u * kThreads + threadIdx.x) * 4, R);
      uint32_t n = 0u;
#pragma unroll
      for (int u = 0; u < kVecCand; ++u) {
        const int64_t i = start + ((int64_t)u * kThreads + threadIdx.x) * 4;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t key = key_of(elem(x[u], e));
          const bool in = i + e < R && (key >> 20) == b0;
          hist_add(sh, in, (key >> 9) & (kBins1 - 1));
          n += in ? 1u : 0u;
        }
      }
      if (!keep) continue;
      const uint32_t inc = warp_scan(n);
      const uint32_t total = __shfl_sync(kFull, inc, 31);
      if (total == 0u) continue;
      // the trip's first `left` keys fill the current batch, the rest
      // start a new one (total <= 32 * 16 = kBatch)
      uint32_t fresh = 0u;
      if (total > left) {
        if (lane == 0) fresh = atomicAdd(zr + kCandCount, kBatch);
        fresh = __shfl_sync(kFull, fresh, 0);
      }
      uint32_t q = inc - n;                  // this lane's first key
#pragma unroll
      for (int u = 0; u < kVecCand; ++u) {
        const int64_t i = start + ((int64_t)u * kThreads + threadIdx.x) * 4;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t key = key_of(elem(x[u], e));
          if (i + e < R && (key >> 20) == b0) {
            cr[q < left ? next + q : fresh + (q - left)] = key;
            ++q;
          }
        }
      }
      if (total > left) {
        next = fresh + (total - left);
        left = kBatch - (total - left);
      } else {
        next += total;
        left -= total;
      }
    }
    for (uint32_t j = lane; j < left; j += 32) cr[next + j] = kNoKey;
    __syncthreads();
    for (int j = threadIdx.x; j < kBins1; j += kThreads)
      if (sh[j]) atomicAdd(zr + kBins0 + j, sh[j]);
    if (last_block(zr + kTicketCand, &last)) {
      const uint32_t need = st[1];
      select_bin<kBins1>(zr + kBins0, need, red, sel);
      if (threadIdx.x == 0) {
        st[0] |= sel[0] << 9;
        st[1] = need - sel[1];
        st[2] = __ldcg(zr + kCandCount);
        zr[kCandCount] = 0u;
        zr[kTicketCand] = 0u;
      }
    }
    __syncthreads();
  }
}

// digit: histogram of digit 2 of the candidates (or, when bin b0
// overflowed the list, of w) that share the first two digits; fix T and
// need.
template <bool VEC>
__global__ void __launch_bounds__(kThreads) topk_ef_digit(
    const float* __restrict__ w, const uint32_t* __restrict__ cand,
    uint32_t* __restrict__ zeroed, uint32_t* __restrict__ state, int64_t M,
    int64_t R, int64_t list) {
  __shared__ uint32_t sh[kBins2];
  __shared__ uint32_t red[kWarps];
  __shared__ uint32_t sel[3];
  __shared__ unsigned last;
  constexpr int64_t kTrip = (int64_t)kVecDigit * kThreads * 4;
  for (int64_t row = blockIdx.y; row < M; row += gridDim.y) {
    for (int j = threadIdx.x; j < kBins2; j += kThreads) sh[j] = 0u;
    uint32_t* st = state + row * kStateWords;
    uint32_t* zr = zeroed + row * kZeroedWords;
    const uint32_t prefix = st[0];
    const bool over = st[3] != 0u;
    const int64_t n = over ? R : (int64_t)st[2];
    const float* src = over ? w + row * R
                            : reinterpret_cast<const float*>(cand + row * list);
    // list keys have bit 31 clear and unused slots set, so their raw bits
    // are compared; w's bits lose the sign first
    const uint32_t mask = over ? 0x7fffffffu : 0xffffffffu;
    const uint32_t hi = prefix >> 9;
    __syncthreads();
    for (int64_t start = (int64_t)blockIdx.x * kTrip; start < n;
         start += (int64_t)gridDim.x * kTrip) {
      float4 x[kVecDigit];
#pragma unroll
      for (int u = 0; u < kVecDigit; ++u)
        x[u] = load4<VEC>(
            src, start + ((int64_t)u * kThreads + threadIdx.x) * 4, n);
#pragma unroll
      for (int u = 0; u < kVecDigit; ++u) {
        const int64_t i = start + ((int64_t)u * kThreads + threadIdx.x) * 4;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t key = __float_as_uint(elem(x[u], e)) & mask;
          hist_add(sh, i + e < n && (key >> 9) == hi, key & (kBins2 - 1));
        }
      }
    }
    __syncthreads();
    for (int j = threadIdx.x; j < kBins2; j += kThreads)
      if (sh[j]) atomicAdd(zr + kBins0 + kBins1 + j, sh[j]);
    if (last_block(zr + kTicketDigit, &last)) {
      const uint32_t need = st[1];
      select_bin<kBins2>(zr + kBins0 + kBins1, need, red, sel);
      if (threadIdx.x == 0) {
        st[0] = prefix | sel[0];
        st[1] = need - sel[1];
        zr[kTicketDigit] = 0u;
      }
    }
    __syncthreads();
  }
}

__device__ __forceinline__ unsigned long long load_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :
               : "l"(p), "l"(v)
               : "memory");
}

// The look-back of chunk `id` > 0 by one warp: the counts (> T in bits
// 61..31, == T in bits 30..0) of every chunk before it.  Each chunk's
// block publishes its own counts (kFlagAgg) before it looks back, and the
// running total through it (kFlagSum) after, so the walk ends at the
// nearest published total; lane l reads chunk id - 1 - l, 32 chunks a
// step.  A chunk before `id` was handed to a block that is already
// running, so every wait ends.
__device__ __forceinline__ unsigned long long look_back(
    const unsigned long long* look, int64_t id) {
  const int lane = threadIdx.x & 31;
  unsigned long long before = 0ull;
  for (int64_t j = id - 1;; j -= 32) {
    const int64_t q = j - lane;
    unsigned long long s = kFlagSum;         // before chunk 0: zero
    if (q >= 0) {
      s = load_relaxed(look + q);
      unsigned ns = 32;                      // back off: the words are hot
      while ((s >> 62) == 0ull) {
        __nanosleep(ns);
        ns = ns < 512 ? 2 * ns : ns;
        s = load_relaxed(look + q);
      }
    }
    const unsigned sums = __ballot_sync(kFull, (s >> 62) == 2ull);
    const int upto = sums ? __ffs(sums) - 1 : 31;
    unsigned long long v = lane <= upto ? (s & kPayload) : 0ull;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
    before += v;
    if (sums) return before;
  }
}

// Exclusive scans of kVecPlace values a thread, each over the block in
// thread order, in one pass; tot[u] gets the sums.  sh: kVecPlace * kWarps
// words.  All threads must call it.
__device__ __forceinline__ void block_scan_vec(const uint32_t* v,
                                               uint32_t* ex, uint32_t* tot,
                                               uint32_t* sh) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t inc[kVecPlace];
#pragma unroll
  for (int u = 0; u < kVecPlace; ++u) inc[u] = warp_scan(v[u]);
  __syncthreads();                           // sh is free
  if (lane == 31)
#pragma unroll
    for (int u = 0; u < kVecPlace; ++u) sh[u * kWarps + warp] = inc[u];
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kVecPlace; ++u) {
    uint32_t before = 0u, all = 0u;
#pragma unroll
    for (int j = 0; j < kWarps; ++j) {
      const uint32_t s = sh[u * kWarps + j];
      if (j < warp) before += s;
      all += s;
    }
    ex[u] = inc[u] - v[u] + before;
    tot[u] = all;
  }
}

// place: one chunk of 4096 entries a block; writes the chunk's picks at
// their offsets, in index order, and zeroes new_err there.  Four blocks an
// SM (at most 64 registers) ran fastest: fewer wait longer on memory, more
// spill.
template <bool VEC>
__global__ void __launch_bounds__(kThreads, 4) topk_ef_place(
    float* __restrict__ w, const uint32_t* __restrict__ state,
    unsigned long long* __restrict__ look, uint32_t* __restrict__ zeroed,
    float* __restrict__ vals, int32_t* __restrict__ idx, int64_t M,
    int64_t R, int64_t k, int64_t nb) {
  __shared__ uint32_t red[kVecPlace * kWarps];
  __shared__ uint32_t s_id;
  __shared__ unsigned long long s_before;
  __shared__ float s_val[kChunk];            // the chunk's picks, in order
  __shared__ int32_t s_idx[kChunk];
  const int warp = threadIdx.x >> 5;
  for (int64_t row = blockIdx.y; row < M; row += gridDim.y) {
    uint32_t* zr = zeroed + row * kZeroedWords;
    if (threadIdx.x == 0) {
      const uint32_t id = atomicAdd(zr + kChunkCount, 1u);
      if ((int64_t)id == nb - 1) zr[kChunkCount] = 0u;   // all handed out
      s_id = id;
    }
    __syncthreads();
    const int64_t id = s_id;
    const uint32_t* st = state + row * kStateWords;
    const uint32_t T = st[0], need = st[1];
    const uint32_t n_gt = (uint32_t)k - need;   // picks above T, the row
    float* wr = w + row * R;
    const int64_t base = id * kChunk;
    float4 x[kVecPlace];
    uint32_t cnt[kVecPlace];          // per float4: (> T) | (== T) << 16
#pragma unroll
    for (int u = 0; u < kVecPlace; ++u) {
      const int64_t i = base + ((int64_t)u * kThreads + threadIdx.x) * 4;
      x[u] = load4<VEC>(wr, i, R);
      cnt[u] = 0u;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t key = key_of(elem(x[u], e));
        if (i + e < R) cnt[u] += key > T ? 1u : (key == T ? 0x10000u : 0u);
      }
    }
    uint32_t ex[kVecPlace], tot[kVecPlace];
    block_scan_vec(cnt, ex, tot, red);
    uint32_t agg = 0u;
#pragma unroll
    for (int u = 0; u < kVecPlace; ++u) agg += tot[u];
    const unsigned long long counts =
        ((unsigned long long)(agg & 0xffffu) << 31) | (agg >> 16);
    unsigned long long* lr = look + row * nb;
    if (id == 0) {
      if (threadIdx.x == 0) {
        store_relaxed(lr, kFlagSum | counts);
        s_before = 0ull;
      }
    } else {
      if (threadIdx.x == 0) store_relaxed(lr + id, kFlagAgg | counts);
      if (warp == 0) {
        const unsigned long long before = look_back(lr, id);
        if (threadIdx.x == 0) {
          store_relaxed(lr + id, kFlagSum | (before + counts));
          s_before = before;
        }
      }
    }
    __syncthreads();
    const uint32_t gt_before = (uint32_t)(s_before >> 31);
    const uint32_t eq_before = (uint32_t)(s_before & 0x7fffffffull);
    const uint32_t n_g = agg & 0xffffu;      // the chunk's picks above T
    // the chunk's ties it takes: the first need - eq_before, if any left
    const uint32_t n_e = eq_before >= need ? 0u
                         : min(agg >> 16, need - eq_before);
    if (n_g + n_e != 0u) {
      // each pick to its place in the chunk's run, in shared memory
      uint32_t run_g = 0u, run_e = 0u;
#pragma unroll
      for (int u = 0; u < kVecPlace; ++u) {
        uint32_t pg = run_g + (ex[u] & 0xffffu);
        uint32_t pe = run_e + (ex[u] >> 16);
        const int64_t i = base + ((int64_t)u * kThreads + threadIdx.x) * 4;
        unsigned picked = 0u;                  // bit e: element i + e
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (i + e >= R) continue;
          const float v = elem(x[u], e);
          const uint32_t key = key_of(v);
          if (key > T) {
            s_val[pg] = v;
            s_idx[pg] = (int32_t)(i + e);
            picked |= 1u << e;
            ++pg;
          } else if (key == T) {
            if (pe < n_e) {
              s_val[n_g + pe] = v;
              s_idx[n_g + pe] = (int32_t)(i + e);
              picked |= 1u << e;
            }
            ++pe;
          }
        }
        // the residual: a lane and its neighbour share a 32-byte sector,
        // rewritten whole (picks zeroed) when either holds a pick
        if (picked | __shfl_xor_sync(kFull, picked, 1)) {
          float4 z = x[u];
          if (picked & 1u) z.x = 0.f;
          if (picked & 2u) z.y = 0.f;
          if (picked & 4u) z.z = 0.f;
          if (picked & 8u) z.w = 0.f;
          store4<VEC>(wr, i, R, z);
        }
        run_g += tot[u] & 0xffffu;
        run_e += tot[u] >> 16;
      }
      __syncthreads();
      // the two runs out whole: picks above T at gt_before, ties after
      // every pick above T of the row, at n_gt + eq_before
      float* vr = vals + row * k;
      int32_t* ir = idx + row * k;
      for (uint32_t j = threadIdx.x; j < n_g + n_e; j += kThreads) {
        const uint32_t at = j < n_g ? gt_before + j : n_gt + eq_before + (j - n_g);
        vr[at] = s_val[j];
        ir[at] = s_idx[j];
      }
    }
    __syncthreads();
  }
}

int64_t num_chunks(int64_t R) { return (R + kChunk - 1) / kChunk; }

int64_t look_words(int64_t M, int64_t R) {     // 32-bit words, kept even
  return ((2 * M * num_chunks(R) + 3) / 4) * 4;
}

// Blocks of `fn` (kThreads each) the card runs at once; cached per kernel.
int resident_blocks(const void* fn) {
  static const void* fns[16];
  static int blocks[16];
  static int cached = 0;
  for (int j = 0; j < cached; ++j)
    if (fns[j] == fn) return blocks[j];
  int dev = 0, sms = 0, per = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, fn, kThreads, 0);
  const int b = (sms > 0 ? sms : 1) * (per > 0 ? per : 1);
  if (cached < 16) {
    fns[cached] = fn;
    blocks[cached] = b;
    ++cached;
  }
  return b;
}

unsigned grid_x(const void* fn, int64_t R, int64_t trip) {
  const int64_t want = (R + trip - 1) / trip;
  const int64_t fit = resident_blocks(fn);
  return (unsigned)(want < fit ? want : fit);
}

unsigned cand_grid(int64_t R) {               // the same for VEC and not
  return grid_x((const void*)topk_ef_cand<true>, R,
                (int64_t)kVecCand * kThreads * 4);
}

// Slots of a row's candidate list: cap keys, and the slots each of cand's
// warps may leave unused.
int64_t list_slots(int64_t R, int64_t cap) {
  return cap + (int64_t)cand_grid(R) * kWarps * kBatch;
}

template <bool VEC>
int launch_all(const float* g, const float* err, float* w, float* vals,
               int* idx, unsigned long long* look, uint32_t* state,
               uint32_t* cand, uint32_t* zeroed, int64_t M, int64_t R,
               int64_t k, int64_t cap, int64_t list, cudaStream_t stream) {
  const int64_t nb = num_chunks(R);
  const unsigned gy = (unsigned)(M < kMaxGridY ? M : kMaxGridY);
  const dim3 ga(grid_x((const void*)topk_ef_hist<VEC>, R,
                       (int64_t)kVecHist * kThreads * 4), gy);
  topk_ef_hist<VEC><<<ga, kThreads, 0, stream>>>(g, err, w, zeroed, state,
                                                 M, R, k, cap);
  const dim3 gb(cand_grid(R), gy);
  topk_ef_cand<VEC><<<gb, kThreads, 0, stream>>>(w, zeroed, state, cand,
                                                 look, M, R, list, nb);
  const dim3 gc(grid_x((const void*)topk_ef_digit<VEC>, R,
                       (int64_t)kVecDigit * kThreads * 4), gy);
  topk_ef_digit<VEC><<<gc, kThreads, 0, stream>>>(w, cand, zeroed, state, M,
                                                  R, list);
  const dim3 gd((unsigned)nb, gy);
  topk_ef_place<VEC><<<gd, kThreads, 0, stream>>>(
      w, state, look, zeroed, vals, reinterpret_cast<int32_t*>(idx), M, R,
      k, nb);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// 32-bit words of per-call scratch for (M, R) and at most `cap` candidate
// keys a row (cap a multiple of 4).
long long topk_ef_scratch_words(long long M, long long R, long long cap) {
  return look_words(M, R) + M * kStateWords + M * list_slots(R, cap);
}

// 32-bit words of the zeroed scratch kept across calls, for M rows.
long long topk_ef_zeroed_words(long long M) { return M * kZeroedWords; }

// g, err (may be NULL: no residual), new_err (may alias err or g): (M, R)
// f32; vals (M, k) f32, idx (M, k) int32; scratch and zeroed as sized
// above (zeroed all zero; left so).  Launches on `stream`; returns the
// first cudaError_t seen (0 on success).
int topk_ef_launch(const float* g, const float* err, float* new_err,
                   float* vals, int* idx, unsigned int* scratch,
                   unsigned int* zeroed, long long M, long long R,
                   long long k, long long cap, void* stream_ptr) {
  if (M <= 0 || R <= 0 || R >= (1LL << 31) || k < 1 || k > R || cap < 4 ||
      cap % 4 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int64_t list = list_slots(R, cap);
  unsigned long long* look = reinterpret_cast<unsigned long long*>(scratch);
  uint32_t* state = scratch + look_words(M, R);
  uint32_t* cand = state + M * kStateWords;
  const bool vec = aligned16(g) && (err == nullptr || aligned16(err)) &&
                   aligned16(new_err) && aligned16(cand) &&
                   (M == 1 || R % 4 == 0);
  if (vec)
    return launch_all<true>(g, err, new_err, vals, idx, look, state, cand,
                            zeroed, M, R, k, cap, list, stream);
  return launch_all<false>(g, err, new_err, vals, idx, look, state, cand,
                           zeroed, M, R, k, cap, list, stream);
}

}  // extern "C"
