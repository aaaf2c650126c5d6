// Fused top-k + error feedback over whole rows, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/topk_ef/kernel.py::topk_ef (Pallas TPU).
//
// Computes, per row of (M, R):  w = err + f32(g);  pick the k entries of
// largest |w| (on ties the lowest index wins, as lax.top_k does);  emit
// vals (M, k) = w at the picks (signed), idx (M, k) int32, and
// new_err (M, R) = w with the picks zeroed.  The order of the picks inside
// a row is free (the deposit does not depend on it): this kernel writes the
// entries with |w| above the threshold first, then the ties, each group in
// index order, so the output is deterministic.
//
// What bounds it: device-memory bytes.  Every element must be read twice
// (g and err) and new_err written once, 12 bytes per element, plus 8 bytes
// per pick; there is no arithmetic to speak of.  The training path calls it
// with M = 1 and R up to 352,321,536 (a whole stacked leaf), so the work
// has to spread over all SMs along ONE row.
//
// Design: the Pallas kernel's k argmax-and-mask passes over a VMEM-resident
// row block would be k serial passes here (k ~ 22 M).  Instead a multi-
// block radix select over the row finds the k-th largest key:
//   * keys are the bit patterns of |w| (sign bit cleared); for
//     non-negative floats they order like the values;
//   * pass 0 fuses w = err + g, writes w into new_err, and histograms the
//     top 11 key bits; passes 1 and 2 histogram the next 11 and the last 9
//     bits of the keys that share the selected prefix.  Histograms are
//     counted in shared memory (warp-aggregated with match.any) and merged
//     with INTEGER atomics, so the counts, and the threshold key T they
//     give, are exact and deterministic;
//   * after each histogram a one-block select kernel takes a suffix scan of
//     the bins and fixes the next digit of T and the number of ties still
//     to take, need = k - count(key > T);
//   * a count pass records per block (fixed contiguous chunks of the row)
//     how many keys are > T and == T, a one-block scan per row turns those
//     into offsets, and the write pass places every key > T and the first
//     `need` ties in index order (ballot + popc ranks inside each tile),
//     writing vals / idx and zeroing new_err at the picks.
// Traffic: pass 0 reads 8 and writes 4 bytes per element, passes 1 and 2,
// the count and the write pass read 4 each: 28 bytes per element against
// the 12 of the bound.  new_err may alias err (the update in place that the
// trainer uses): pass 0 reads err[i] and writes new_err[i] in the same
// thread, and no later pass reads err.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                // histogram / count / write
constexpr int kWarps = kThreads / 32;
constexpr int kTilesPerChunk = 32;
constexpr int64_t kChunk = (int64_t)kThreads * kTilesPerChunk;
constexpr int kScanThreads = 1024;
constexpr int kBins0 = 2048;                 // key bits 30..20
constexpr int kBins1 = 2048;                 // key bits 19..9
constexpr int kBins2 = 512;                  // key bits 8..0
constexpr int kHistWords = kBins0 + kBins1 + kBins2;
constexpr int kStateWords = 4;               // prefix (= T at the end), need
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNoBin = 0xffffffffu;
constexpr int kMaxRowsPerLaunch = 65535;     // gridDim.y limit

__device__ __forceinline__ uint32_t key_of(float w) {
  return __float_as_uint(w) & 0x7fffffffu;
}

// Warp-aggregated shared-memory histogram add: lanes holding the same bin
// add once, by their lowest lane.  All 32 lanes must call it.
__device__ __forceinline__ void warp_bin_add(uint32_t* sh, unsigned bin) {
  const unsigned lane = threadIdx.x & 31u;
  if (__ballot_sync(kFull, bin != kNoBin) == 0u) return;
  const unsigned same = __match_any_sync(kFull, bin);
  if (bin != kNoBin && lane == (unsigned)(__ffs(same) - 1))
    atomicAdd(&sh[bin], (uint32_t)__popc(same));
}

__global__ void init_kernel(uint32_t* hist, uint32_t* state, int64_t rows,
                            uint32_t k) {
  const int64_t n = rows * kHistWords;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x)
    hist[i] = 0u;
  for (int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; r < rows;
       r += (int64_t)gridDim.x * blockDim.x) {
    state[r * kStateWords + 0] = 0u;   // prefix of T
    state[r * kStateWords + 1] = k;    // picks still to place at/below it
  }
}

// Pass 0: w = err + g into new_err, histogram of key bits 30..20.  No
// __restrict__ on g, err and w_out: new_err may alias err (or g), and each
// element is read and then written by the same thread.
__global__ void hist0_kernel(const float* g, const float* err, float* w_out,
                             uint32_t* __restrict__ hist, int64_t R) {
  __shared__ uint32_t sh[kBins0];
  for (int i = threadIdx.x; i < kBins0; i += blockDim.x) sh[i] = 0u;
  __syncthreads();
  const int64_t row = blockIdx.y;
  const float* gr = g + row * R;
  const float* er = err ? err + row * R : nullptr;
  float* wr = w_out + row * R;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t base = (int64_t)blockIdx.x * blockDim.x; base < R;
       base += stride) {
    const int64_t i = base + threadIdx.x;
    unsigned bin = kNoBin;
    if (i < R) {
      const float e = er ? er[i] : 0.0f;
      const float w = __fadd_rn(e, gr[i]);
      wr[i] = w;
      bin = key_of(w) >> 20;
    }
    warp_bin_add(sh, bin);
  }
  __syncthreads();
  uint32_t* hr = hist + row * kHistWords;
  for (int i = threadIdx.x; i < kBins0; i += blockDim.x)
    if (sh[i]) atomicAdd(&hr[i], sh[i]);
}

// Passes 1 and 2: histogram of the next digit of the keys sharing the
// prefix fixed so far (bits above HI_SHIFT).
template <int SHIFT, int NBINS, int HI_SHIFT, int HIST_OFF>
__global__ void histn_kernel(const float* __restrict__ w,
                             const uint32_t* __restrict__ state,
                             uint32_t* __restrict__ hist, int64_t R) {
  __shared__ uint32_t sh[NBINS];
  for (int i = threadIdx.x; i < NBINS; i += blockDim.x) sh[i] = 0u;
  __syncthreads();
  const int64_t row = blockIdx.y;
  const uint32_t hi = state[row * kStateWords] >> HI_SHIFT;
  const float* wr = w + row * R;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t base = (int64_t)blockIdx.x * blockDim.x; base < R;
       base += stride) {
    const int64_t i = base + threadIdx.x;
    unsigned bin = kNoBin;
    if (i < R) {
      const uint32_t key = key_of(wr[i]);
      if ((key >> HI_SHIFT) == hi) bin = (key >> SHIFT) & (NBINS - 1);
    }
    warp_bin_add(sh, bin);
  }
  __syncthreads();
  uint32_t* hr = hist + row * kHistWords + HIST_OFF;
  for (int i = threadIdx.x; i < NBINS; i += blockDim.x)
    if (sh[i]) atomicAdd(&hr[i], sh[i]);
}

// One block per row: suffix-scan the bins, find the bin b holding the
// need-th largest remaining key (S[b] >= need > S[b+1]), fix digit b of T
// and subtract the S[b+1] keys above it from need.
template <int NBINS, int SHIFT, int HIST_OFF>
__global__ void select_kernel(const uint32_t* __restrict__ hist,
                              uint32_t* __restrict__ state) {
  __shared__ uint32_t s[2][NBINS];
  __shared__ uint32_t need_sh;
  const int64_t row = blockIdx.x;
  const uint32_t* h = hist + row * kHistWords + HIST_OFF;
  if (threadIdx.x == 0) need_sh = state[row * kStateWords + 1];
  for (int j = threadIdx.x; j < NBINS; j += blockDim.x)
    s[0][j] = h[NBINS - 1 - j];              // reversed: prefix = suffix
  __syncthreads();
  int src = 0;
  for (int off = 1; off < NBINS; off <<= 1) {
    for (int j = threadIdx.x; j < NBINS; j += blockDim.x)
      s[src ^ 1][j] = s[src][j] + (j >= off ? s[src][j - off] : 0u);
    __syncthreads();
    src ^= 1;
  }
  const uint32_t need = need_sh;
  for (int b = threadIdx.x; b < NBINS; b += blockDim.x) {
    const uint32_t sb = s[src][NBINS - 1 - b];            // keys with digit >= b
    const uint32_t sb1 = (b + 1 < NBINS) ? s[src][NBINS - 2 - b] : 0u;
    if (sb >= need && sb1 < need) {
      state[row * kStateWords + 0] |= (uint32_t)b << SHIFT;
      state[row * kStateWords + 1] = need - sb1;
    }
  }
}

__device__ __forceinline__ uint32_t block_sum(uint32_t v, uint32_t* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  uint32_t t = 0u;
  for (int j = 0; j < (int)(blockDim.x >> 5); ++j) t += red[j];
  return t;
}

// Per fixed chunk of the row: how many keys are > T and == T.
__global__ void count_kernel(const float* __restrict__ w,
                             const uint32_t* __restrict__ state,
                             uint32_t* __restrict__ cnt_gt,
                             uint32_t* __restrict__ cnt_eq, int64_t R,
                             int64_t nb) {
  __shared__ uint32_t red[kWarps];
  const int64_t row = blockIdx.y, b = blockIdx.x;
  const uint32_t T = state[row * kStateWords];
  const float* wr = w + row * R;
  const int64_t start = b * kChunk;
  const int64_t end = start + kChunk < R ? start + kChunk : R;
  uint32_t ng = 0u, ne = 0u;
  for (int64_t i = start + threadIdx.x; i < end; i += kThreads) {
    const uint32_t key = key_of(wr[i]);
    ng += key > T;
    ne += key == T;
  }
  ng = block_sum(ng, red);
  ne = block_sum(ne, red);
  if (threadIdx.x == 0) {
    cnt_gt[row * nb + b] = ng;
    cnt_eq[row * nb + b] = ne;
  }
}

// Inclusive warp scan of one value.
__device__ __forceinline__ uint32_t warp_scan(uint32_t v) {
  const int lane = threadIdx.x & 31;
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t n = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += n;
  }
  return v;
}

// Exclusive block scan (blockDim == kScanThreads) of one value per thread.
__device__ __forceinline__ uint32_t block_exclusive_scan(uint32_t v,
                                                         uint32_t* sh) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t inc = warp_scan(v);
  __syncthreads();
  if (lane == 31) sh[warp] = inc;
  __syncthreads();
  if (warp == 0) sh[lane] = warp_scan(sh[lane]);
  __syncthreads();
  return inc - v + (warp > 0 ? sh[warp - 1] : 0u);
}

// One block per row: exclusive scans of the per-chunk counts.
__global__ void scan_kernel(const uint32_t* __restrict__ cnt_gt,
                            const uint32_t* __restrict__ cnt_eq,
                            uint32_t* __restrict__ off_gt,
                            uint32_t* __restrict__ off_eq, int64_t nb) {
  __shared__ uint32_t sh[32];
  const int64_t row = blockIdx.x;
  const int64_t per = (nb + kScanThreads - 1) / kScanThreads;
  const int64_t lo = threadIdx.x * per;
  const int64_t hi = lo + per < nb ? lo + per : nb;
  const uint32_t* cg = cnt_gt + row * nb;
  const uint32_t* ce = cnt_eq + row * nb;
  uint32_t sg = 0u, se = 0u;
  for (int64_t j = lo; j < hi; ++j) { sg += cg[j]; se += ce[j]; }
  uint32_t rg = block_exclusive_scan(sg, sh);
  uint32_t re = block_exclusive_scan(se, sh);
  for (int64_t j = lo; j < hi; ++j) {
    off_gt[row * nb + j] = rg;
    off_eq[row * nb + j] = re;
    rg += cg[j];
    re += ce[j];
  }
}

// Place every key > T and the first `need` ties, in index order.
__global__ void write_kernel(float* __restrict__ w,
                             const uint32_t* __restrict__ state,
                             const uint32_t* __restrict__ cnt_gt,
                             const uint32_t* __restrict__ cnt_eq,
                             const uint32_t* __restrict__ off_gt,
                             const uint32_t* __restrict__ off_eq,
                             float* __restrict__ vals,
                             int32_t* __restrict__ idx, int64_t R, int64_t k,
                             int64_t nb) {
  __shared__ uint32_t wg[kWarps], we[kWarps];
  const int64_t row = blockIdx.y, b = blockIdx.x;
  const uint32_t T = state[row * kStateWords + 0];
  const uint32_t need = state[row * kStateWords + 1];
  const uint32_t n_gt = (uint32_t)k - need;
  const uint32_t base_g = off_gt[row * nb + b];
  const uint32_t base_e = off_eq[row * nb + b];
  if (cnt_gt[row * nb + b] == 0u &&
      (cnt_eq[row * nb + b] == 0u || base_e >= need))
    return;                                   // no pick in this chunk
  float* wr = w + row * R;
  float* vr = vals + row * k;
  int32_t* ir = idx + row * k;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  const int64_t start = b * kChunk;
  const int64_t end = start + kChunk < R ? start + kChunk : R;
  uint32_t run_g = 0u, run_e = 0u;
  for (int64_t t0 = start; t0 < end; t0 += kThreads) {
    const int64_t i = t0 + threadIdx.x;
    const bool valid = i < end;
    const float x = valid ? wr[i] : 0.0f;
    const uint32_t key = key_of(x);
    const bool gt = valid && key > T;
    const bool eq = valid && key == T;
    const unsigned bg = __ballot_sync(kFull, gt);
    const unsigned be = __ballot_sync(kFull, eq);
    if (lane == 0) { wg[warp] = __popc(bg); we[warp] = __popc(be); }
    __syncthreads();
    uint32_t pg = 0u, pe = 0u, tg = 0u, te = 0u;
    for (int j = 0; j < kWarps; ++j) {
      if (j < warp) { pg += wg[j]; pe += we[j]; }
      tg += wg[j];
      te += we[j];
    }
    if (gt) {
      const uint32_t pos = base_g + run_g + pg + __popc(bg & lt);
      vr[pos] = x;
      ir[pos] = (int32_t)i;
      wr[i] = 0.0f;
    } else if (eq) {
      const uint32_t tie = base_e + run_e + pe + __popc(be & lt);
      if (tie < need) {
        const uint32_t pos = n_gt + tie;
        vr[pos] = x;
        ir[pos] = (int32_t)i;
        wr[i] = 0.0f;
      }
    }
    run_g += tg;
    run_e += te;
    __syncthreads();
  }
}

int64_t num_chunks(int64_t R) { return (R + kChunk - 1) / kChunk; }

}  // namespace

extern "C" {

// 32-bit words of scratch the launcher needs for (M, R).
long long topk_ef_scratch_words(long long M, long long R) {
  return M * (kHistWords + kStateWords + 4 * num_chunks(R));
}

// g, err (may be NULL: no residual), new_err (may alias err): (M, R) f32;
// vals (M, k) f32, idx (M, k) int32; scratch as sized above.  Launches on
// `stream`; returns the first cudaError_t seen (0 on success).
int topk_ef_launch(const float* g, const float* err, float* new_err,
                   float* vals, int* idx, unsigned int* scratch, long long M,
                   long long R, long long k, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int64_t nb = num_chunks(R);
  uint32_t* hist = scratch;
  uint32_t* state = hist + M * kHistWords;
  uint32_t* cnt_gt = state + M * kStateWords;
  uint32_t* cnt_eq = cnt_gt + M * nb;
  uint32_t* off_gt = cnt_eq + M * nb;
  uint32_t* off_eq = off_gt + M * nb;
  int64_t hist_blocks = (R + kThreads - 1) / kThreads;
  if (hist_blocks > 1056) hist_blocks = 1056;   // 8 blocks on each of 132 SMs
  init_kernel<<<256, 256, 0, stream>>>(hist, state, M, (uint32_t)k);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  for (int64_t r0 = 0; r0 < M; r0 += kMaxRowsPerLaunch) {
    const int64_t rows = M - r0 < kMaxRowsPerLaunch ? M - r0
                                                    : kMaxRowsPerLaunch;
    const float* gr = g + r0 * R;
    const float* er = err ? err + r0 * R : nullptr;
    float* wr = new_err + r0 * R;
    uint32_t* hr = hist + r0 * kHistWords;
    uint32_t* sr = state + r0 * kStateWords;
    const dim3 hgrid((unsigned)hist_blocks, (unsigned)rows);
    const dim3 cgrid((unsigned)nb, (unsigned)rows);
    hist0_kernel<<<hgrid, kThreads, 0, stream>>>(gr, er, wr, hr, R);
    select_kernel<kBins0, 20, 0><<<(unsigned)rows, kScanThreads, 0, stream>>>(
        hr, sr);
    histn_kernel<9, kBins1, 20, kBins0><<<hgrid, kThreads, 0, stream>>>(
        wr, sr, hr, R);
    select_kernel<kBins1, 9, kBins0>
        <<<(unsigned)rows, kScanThreads, 0, stream>>>(hr, sr);
    histn_kernel<0, kBins2, 9, kBins0 + kBins1>
        <<<hgrid, kThreads, 0, stream>>>(wr, sr, hr, R);
    select_kernel<kBins2, 0, kBins0 + kBins1>
        <<<(unsigned)rows, kScanThreads, 0, stream>>>(hr, sr);
    count_kernel<<<cgrid, kThreads, 0, stream>>>(
        wr, sr, cnt_gt + r0 * nb, cnt_eq + r0 * nb, R, nb);
    scan_kernel<<<(unsigned)rows, kScanThreads, 0, stream>>>(
        cnt_gt + r0 * nb, cnt_eq + r0 * nb, off_gt + r0 * nb,
        off_eq + r0 * nb, nb);
    write_kernel<<<cgrid, kThreads, 0, stream>>>(
        wr, sr, cnt_gt + r0 * nb, cnt_eq + r0 * nb, off_gt + r0 * nb,
        off_eq + r0 * nb, vals + r0 * k, idx + r0 * k, R, k, nb);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // extern "C"
