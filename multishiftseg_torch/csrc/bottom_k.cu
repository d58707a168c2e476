// Sum of the k smallest-keyed values with threshold ties sharing the remainder,
// for Hopper (sm_90a).
//
// Replaces _bottom_k_sum (multishiftseg_tpu/losses/rcl.py:65), RCL's pixel
// selection: keys are the detached per-pixel CE values (>= 0, +inf where the
// pixel is not in-distribution), compared as their uint32 bit patterns (monotone
// for non-negative floats). The JAX package finds the k-th smallest key by a
// 32-step binary search over the bit pattern, each step a full pass; here a radix
// select finds the same key in three passes (digits of 11, 11 and 10 bits, most
// significant first), then one pass counts and sums the values below and at it:
//   sum = sum_less + sum_eq * need / max(n_eq, 1),  need = max(k - n_less, 0).
// k (select_num) stays on the device; so do the threshold and the tie weight,
// which the backward (bk_backward) reads: d values = g * (1 below the threshold,
// need / n_eq at it, 0 above). As the binary search, k <= 0 gives threshold 0
// and k > n gives 0xFFFFFFFF.
//
// The forward is one cooperative kernel (bk_select_sum), every block resident,
// one a SM, 1024 threads; grid-wide barriers (cooperative groups' grid sync)
// separate its phases:
//   1. Each block copies its contiguous slice of keys to shared memory (16-byte
//      loads, as far as its share holds: about 55,000 keys a block, 7.3 M on an
//      H100), binning them by the first digit into a shared histogram (a
//      shared atomic a key) as they arrive. Keys past the staged share are
//      read from global memory in every pass, so any n < 2^32 is right. Then
//      it starts copying its values into the rest of its shared memory
//      (cp.async), to land while the passes run. Block 0 zeroes the three
//      global histograms. Barrier.
//   2. Each pass: the block's nonzero bins added into the pass's own global
//      histogram; barrier; every block reads the histogram and finds the digit
//      by a block scan (the same answer in every block); then the next pass
//      bins the keys that match the prefix, from shared memory.
//   3. The final pass reads keys and values from shared memory (what did not
//      fit from HBM, once), sums below and at the threshold in f64 a thread,
//      then a block in a fixed order (shuffles, then warp 0); block partials,
//      barrier, block 0 adds them the same way, so the result does not depend
//      on the schedule.
// The kernel needs no zeroed buffer; a call is one kernel, which a CUDA graph
// captures (cudaLaunchCooperativeKernel).
//
// Bound at the main-path shapes (8 x 700 x 700 = 3.92 M f32 CE values): reading
// keys and values once is 31.4 MB, 9.4 us at 3.35 TB/s. Memory bound.
//
// Scratch (int32 words, no initial contents): [0] threshold, [1, 5) result f32
// (sum, tie weight, n_less, n_eq), [8, 8 + 3 * 2048) the passes' histograms,
// then f64 sums [2 * blocks] and u64 counts [2 * blocks] of the block partials;
// bottom_k_scratch_words(blocks) in all.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int BINS = 2048;  // the widest digit's
constexpr int PASSES = 3;
constexpr unsigned FULL = 0xffffffffu;

constexpr int S_THRESHOLD = 0;
constexpr int S_RESULT = 1;
constexpr int S_HIST = 8;
constexpr int S_PARTIALS = S_HIST + PASSES * BINS;  // 8-byte aligned

// shared memory: histogram, reduction scratch, the found digit, then the keys
// and the values
constexpr int SM_RED = BINS * 4;
constexpr int SM_MISC = SM_RED + WARPS * 8 * 4;
constexpr int SM_KEYS = SM_MISC + 16;  // 16-byte aligned

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ int digit_shift(int p) { return p == 0 ? 21 : (p == 1 ? 10 : 0); }

// count a key in its bin if it matches the threshold's prefix
__device__ __forceinline__ void bin_key(unsigned* hist, uint32_t key, bool ok, unsigned hi,
                                        unsigned prefix, int shift, unsigned digit_mask) {
  if (ok && (key & hi) == prefix) atomicAdd(&hist[(key >> shift) & digit_mask], 1u);
}

// The smallest digit at which the global histogram's running count reaches
// k: every block computes the same. Returns (digit, count below it) through
// shared memory; k <= 0 gives digit 0, k above the total the last digit (the
// global route's rounds meet both; the single launch never calls it so).
__device__ void find_digit(const unsigned* __restrict__ ghist, int bins, long long k,
                           unsigned long long* wsum, unsigned* misc) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const unsigned h0 = 2 * t < bins ? __ldcg(ghist + 2 * t) : 0u;
  const unsigned h1 = 2 * t + 1 < bins ? __ldcg(ghist + 2 * t + 1) : 0u;
  const unsigned long long s = (unsigned long long)h0 + h1;
  unsigned long long incl = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned long long y = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const unsigned long long w = wsum[lane];
    unsigned long long wi = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned long long y = __shfl_up_sync(FULL, wi, o);
      if (lane >= o) wi += y;
    }
    wsum[lane] = wi - w;
  }
  __syncthreads();
  const long long excl = (long long)(wsum[warp] + incl - s);
  if (excl < k && k <= excl + (long long)s) {
    const bool first = k <= excl + (long long)h0;
    misc[0] = first ? 2 * t : 2 * t + 1;
    misc[1] = (unsigned)(first ? excl : excl + h0);
  } else if (k <= 0 && t == 0) {  // none needed: digit 0 (the global route's rounds)
    misc[0] = 0u;
    misc[1] = 0u;
  } else if (k > 0 && t == THREADS - 1 && k > excl + (long long)s) {  // the keys fall short
    misc[0] = (unsigned)(bins - 1);
    misc[1] = (unsigned)(excl + (long long)s - __ldcg(ghist + bins - 1));
  }
  __syncthreads();
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// The block's four sums, in a fixed order, into thread 0's arguments:
// each warp's by shuffle, then the warps' by warp 0.
__device__ void block_sums(double& sl, double& se, unsigned long long& cl,
                           unsigned long long& ce, double* red_d, unsigned long long* red_c) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  sl = warp_sum(sl);
  se = warp_sum(se);
  cl = warp_sum(cl);
  ce = warp_sum(ce);
  __syncthreads();  // red_* may still be read
  if (lane == 0) {
    red_d[warp] = sl;
    red_d[WARPS + warp] = se;
    red_c[warp] = cl;
    red_c[WARPS + warp] = ce;
  }
  __syncthreads();
  if (warp == 0) {
    sl = warp_sum(red_d[lane]);
    se = warp_sum(red_d[WARPS + lane]);
    cl = warp_sum(red_c[lane]);
    ce = warp_sum(red_c[WARPS + lane]);
  }
}

__global__ void __launch_bounds__(THREADS, 1) bk_select_sum(
    const uint32_t* __restrict__ keys, const float* __restrict__ values, int64_t n,
    const int* __restrict__ select_num, int64_t per, int stage, int vstage,
    unsigned* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char bk_smem[];
  unsigned* hist = reinterpret_cast<unsigned*>(bk_smem);
  double* red_d = reinterpret_cast<double*>(bk_smem + SM_RED);         // [2][WARPS]
  unsigned long long* red_c = reinterpret_cast<unsigned long long*>(red_d + 2 * WARPS);
  unsigned* misc = reinterpret_cast<unsigned*>(bk_smem + SM_MISC);
  uint32_t* sk = reinterpret_cast<uint32_t*>(bk_smem + SM_KEYS);
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int tid = threadIdx.x;
  const int64_t start = (int64_t)blockIdx.x * per;
  const int64_t m = start < n ? (n - start < per ? n - start : per) : 0;  // this block's keys
  const int s = (int)(m < stage ? m : stage);                            // staged of them
  const int vs = (int)(m < vstage ? m : vstage);                         // values staged
  const uint32_t* gk = keys + start;
  const float* gv = values + start;
  float* sv = reinterpret_cast<float*>(sk + stage);
  unsigned* ghist = scratch + S_HIST;

  for (int i = tid; i < BINS; i += THREADS) hist[i] = 0u;
  if (blockIdx.x == 0)
    for (int i = tid; i < PASSES * BINS; i += THREADS) ghist[i] = 0u;
  const long long k = *select_num;
  const bool fixed = k <= 0 || k > n;
  unsigned prefix = k <= 0 ? 0u : 0xffffffffu;  // the threshold when fixed
  __syncthreads();

  // 1. stage the slice, binning by the first digit as the keys arrive
  const unsigned mask0 = (1u << 11) - 1u;
  int64_t from = 0;
  if (((uintptr_t)gk & 15) == 0) {
    const uint4* g4 = reinterpret_cast<const uint4*>(gk);
    uint4* s4 = reinterpret_cast<uint4*>(sk);
    const int units = s >> 2;
    for (int b = 0; b < units; b += 4 * THREADS) {
      uint4 q[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = b + u * THREADS + tid;
        q[u] = i < units ? __ldcs(g4 + i) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = b + u * THREADS + tid;
        const bool ok = i < units;
        if (ok) s4[i] = q[u];
        if (!fixed) {
          bin_key(hist, q[u].x, ok, 0u, 0u, 21, mask0);
          bin_key(hist, q[u].y, ok, 0u, 0u, 21, mask0);
          bin_key(hist, q[u].z, ok, 0u, 0u, 21, mask0);
          bin_key(hist, q[u].w, ok, 0u, 0u, 21, mask0);
        }
      }
    }
    from = 4 * (int64_t)units;
  }
  for (int64_t b = from; b < m; b += THREADS) {  // one by one: off alignment, past the stage
    const int64_t i = b + tid;
    const bool ok = i < m;
    const uint32_t key = ok ? (i < s ? __ldcs(gk + i) : __ldcg(gk + i)) : 0u;
    if (ok && i < s) sk[i] = key;
    if (!fixed) bin_key(hist, key, ok, 0u, 0u, 21, mask0);
  }
  // the values follow into shared memory while the passes run
  if (((uintptr_t)gv & 15) == 0) {
    for (int i = tid; i < vs >> 2; i += THREADS) cp_async16(sv + 4 * i, gv + 4 * i);
    for (int i = (vs & ~3) + tid; i < vs; i += THREADS) cp_async4(sv + i, gv + i);
  } else {
    for (int i = tid; i < vs; i += THREADS) cp_async4(sv + i, gv + i);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  __syncthreads();

  if (!fixed) {
    grid.sync();  // the global histograms are zero
    long long left = k;
    prefix = 0u;
    for (int p = 0; p < PASSES; ++p) {
      const int shift = digit_shift(p);
      const int bins = p == PASSES - 1 ? 1024 : BINS;
      if (p > 0) {
        // bin the keys under the prefix so far, from shared memory
        const unsigned hi = ~0u << (digit_shift(p - 1));
        const unsigned dmask = (unsigned)bins - 1u;
        const uint4* s4 = reinterpret_cast<const uint4*>(sk);
        const int units = s >> 2;
        for (int b = 0; b < units; b += THREADS) {
          const int i = b + tid;
          const bool ok = i < units;
          const uint4 q = ok ? s4[i] : make_uint4(0u, 0u, 0u, 0u);
          bin_key(hist, q.x, ok, hi, prefix, shift, dmask);
          bin_key(hist, q.y, ok, hi, prefix, shift, dmask);
          bin_key(hist, q.z, ok, hi, prefix, shift, dmask);
          bin_key(hist, q.w, ok, hi, prefix, shift, dmask);
        }
        for (int64_t b = 4 * (int64_t)units; b < m; b += THREADS) {
          const int64_t i = b + tid;
          const bool ok = i < m;
          const uint32_t key = ok ? (i < s ? sk[i] : __ldcg(gk + i)) : 0u;
          bin_key(hist, key, ok, hi, prefix, shift, dmask);
        }
        __syncthreads();
      }
      unsigned* gh = ghist + p * BINS;
      for (int i = tid; i < bins; i += THREADS) {
        const unsigned h = hist[i];
        if (h) atomicAdd(gh + i, h);
        hist[i] = 0u;
      }
      grid.sync();
      find_digit(gh, bins, left, red_c, misc);
      prefix |= misc[0] << shift;
      left -= misc[1];
    }
  }

  // 3. the sums below and at the threshold
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  const uint32_t t = prefix;
  double sl = 0.0, se = 0.0;
  unsigned long long cl = 0, ce = 0;
  {
    const uint4* s4 = reinterpret_cast<const uint4*>(sk);
    const int units = s >> 2;
    const bool vec = ((uintptr_t)gv & 15) == 0;
#pragma unroll 4
    for (int i = tid; i < units; i += THREADS) {
      const uint4 q = s4[i];
      float4 v;
      if (4 * i + 4 <= vs) {
        v = reinterpret_cast<const float4*>(sv)[i];
      } else if (vec) {
        v = __ldcs(reinterpret_cast<const float4*>(gv) + i);
      } else {
        v = make_float4(__ldcs(gv + 4 * i), __ldcs(gv + 4 * i + 1), __ldcs(gv + 4 * i + 2),
                        __ldcs(gv + 4 * i + 3));
      }
      const uint32_t kk[4] = {q.x, q.y, q.z, q.w};
      const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (kk[c] < t) {
          sl += (double)vv[c];
          ++cl;
        } else if (kk[c] == t) {
          se += (double)vv[c];
          ++ce;
        }
      }
    }
    for (int64_t i = 4 * (int64_t)units + tid; i < m; i += THREADS) {
      const uint32_t key = i < s ? sk[i] : __ldcg(gk + i);
      const float v = i < vs ? sv[i] : __ldcs(gv + i);
      if (key < t) {
        sl += (double)v;
        ++cl;
      } else if (key == t) {
        se += (double)v;
        ++ce;
      }
    }
  }
  // the block's sums in a fixed order: warps by shuffle, then the warps' by
  // warp 0; block partials; then block 0 sums them the same way
  block_sums(sl, se, cl, ce, red_d, red_c);
  double* psum = reinterpret_cast<double*>(scratch + S_PARTIALS);
  unsigned long long* pcnt = reinterpret_cast<unsigned long long*>(psum + 2 * gridDim.x);
  if (tid == 0) {
    psum[2 * blockIdx.x] = sl;
    psum[2 * blockIdx.x + 1] = se;
    pcnt[2 * blockIdx.x] = cl;
    pcnt[2 * blockIdx.x + 1] = ce;
  }
  grid.sync();
  if (blockIdx.x != 0) return;
  const bool mine = tid < (int)gridDim.x;  // one partial a thread (blocks <= THREADS)
  sl = mine ? __ldcg(psum + 2 * tid) : 0.0;
  se = mine ? __ldcg(psum + 2 * tid + 1) : 0.0;
  cl = mine ? __ldcg(pcnt + 2 * tid) : 0ull;
  ce = mine ? __ldcg(pcnt + 2 * tid + 1) : 0ull;
  block_sums(sl, se, cl, ce, red_d, red_c);
  if (tid == 0) {
    const long long need = max(k - (long long)cl, 0LL);
    const float w_eq = (float)need / (float)(ce > 0 ? ce : 1ull);
    float* result = reinterpret_cast<float*>(scratch + S_RESULT);
    result[0] = __fadd_rn((float)sl, __fmul_rn((float)se, w_eq));
    result[1] = w_eq;
    result[2] = (float)cl;
    result[3] = (float)ce;
    scratch[S_THRESHOLD] = t;
  }
}

__global__ void __launch_bounds__(256) bk_backward(const uint32_t* __restrict__ keys, int64_t n,
                                                   const unsigned* __restrict__ scratch,
                                                   const float* __restrict__ grad,
                                                   float* __restrict__ dvalues) {
  const unsigned t = __ldg(scratch + S_THRESHOLD);
  const float g = __ldg(grad), w_eq = __ldg(reinterpret_cast<const float*>(scratch + S_RESULT) + 1);
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const uint32_t b = __ldg(keys + i);
    dvalues[i] = b < t ? g : (b == t ? g * w_eq : 0.f);
  }
}

// ---------------------------------------------------------------------------
// The global route: the selection over the keys of every rank of a process
// group (losses/rcl.py::bottom_k_sum_global). Between the launches the caller
// all-reduces what they wrote:
//   bottom_k_global_hist, rounds 0, 1, 2: every block finds the prefix of the
//     rounds before from their all-reduced histograms (find_digit, the same in
//     every block), then bins this rank's keys under it by the round's digit
//     (a shared histogram, then its nonzero bins added to the round's global
//     one, zeroed first) -> all-reduce of the round's 2048 counts;
//   bottom_k_global_sums: the threshold from the three histograms, this rank's
//     sums below and at it in f64 and their counts, a block in a fixed order,
//     then one block adds the block partials in a fixed order -> all-reduce of
//     the four f64 sums;
//   bottom_k_global_result: need = max(k - n_less, 0), the tie weight and the
//     sum as the single launch writes them, so bk_backward serves both routes.
// Scratch (int32 words): the single launch's header and histograms, then from
// G_PART the four f64 sums, from G_BLOCKS the block partials (2 f64 and 2 u64
// a block); bottom_k_global_scratch_words(blocks) in all.

constexpr int G_PART = S_HIST + PASSES * BINS;  // 8-byte aligned
constexpr int G_BLOCKS = G_PART + 8;

// the threshold's prefix after rounds 0..p-1 and the count still needed
__device__ void global_prefix(const unsigned* __restrict__ scratch, long long k, int p,
                              unsigned long long* wsum, unsigned* misc, unsigned* prefix,
                              long long* left) {
  unsigned pre = 0u;
  long long l = k;
  for (int q = 0; q < p; ++q) {
    find_digit(scratch + S_HIST + q * BINS, q == PASSES - 1 ? 1024 : BINS, l, wsum, misc);
    pre |= misc[0] << digit_shift(q);
    l -= misc[1];
  }
  *prefix = pre;
  *left = l;
}

__global__ void __launch_bounds__(THREADS) bk_global_hist(const uint32_t* __restrict__ keys,
                                                          int64_t n,
                                                          const int* __restrict__ select_num,
                                                          unsigned* __restrict__ scratch, int p) {
  __shared__ unsigned hist[BINS];
  __shared__ unsigned long long wsum[WARPS];
  __shared__ unsigned misc[4];
  const int tid = threadIdx.x;
  for (int i = tid; i < BINS; i += THREADS) hist[i] = 0u;
  unsigned prefix;
  long long left;
  global_prefix(scratch, *select_num, p, wsum, misc, &prefix, &left);
  __syncthreads();  // the zeroed histogram (round 0 finds no digit before)
  const int shift = digit_shift(p);
  const int bins = p == PASSES - 1 ? 1024 : BINS;
  const unsigned hi = p == 0 ? 0u : ~0u << digit_shift(p - 1);
  const unsigned dmask = (unsigned)bins - 1u;
  for (int64_t i = (int64_t)blockIdx.x * THREADS + tid; i < n; i += (int64_t)gridDim.x * THREADS)
    bin_key(hist, __ldg(keys + i), true, hi, prefix, shift, dmask);
  __syncthreads();
  unsigned* gh = scratch + S_HIST + p * BINS;
  for (int i = tid; i < bins; i += THREADS) {
    const unsigned h = hist[i];
    if (h) atomicAdd(gh + i, h);
  }
}

__global__ void __launch_bounds__(THREADS) bk_global_sums(const uint32_t* __restrict__ keys,
                                                          const float* __restrict__ values,
                                                          int64_t n,
                                                          const int* __restrict__ select_num,
                                                          unsigned* __restrict__ scratch) {
  __shared__ double red_d[2 * WARPS];
  __shared__ unsigned long long red_c[2 * WARPS];
  __shared__ unsigned misc[4];
  const int tid = threadIdx.x;
  unsigned t;
  long long left;
  global_prefix(scratch, *select_num, PASSES, red_c, misc, &t, &left);
  double sl = 0.0, se = 0.0;
  unsigned long long cl = 0, ce = 0;
  for (int64_t i = (int64_t)blockIdx.x * THREADS + tid; i < n; i += (int64_t)gridDim.x * THREADS) {
    const uint32_t key = __ldg(keys + i);
    if (key < t) {
      sl += (double)__ldg(values + i);
      ++cl;
    } else if (key == t) {
      se += (double)__ldg(values + i);
      ++ce;
    }
  }
  block_sums(sl, se, cl, ce, red_d, red_c);
  double* psum = reinterpret_cast<double*>(scratch + G_BLOCKS);
  unsigned long long* pcnt = reinterpret_cast<unsigned long long*>(psum + 2 * gridDim.x);
  if (tid == 0) {
    psum[2 * blockIdx.x] = sl;
    psum[2 * blockIdx.x + 1] = se;
    pcnt[2 * blockIdx.x] = cl;
    pcnt[2 * blockIdx.x + 1] = ce;
    if (blockIdx.x == 0) scratch[S_THRESHOLD] = t;
  }
}

// one block: the block partials in a fixed order -> the four f64 sums
__global__ void __launch_bounds__(THREADS) bk_global_partials(unsigned* __restrict__ scratch,
                                                              int blocks) {
  __shared__ double red_d[2 * WARPS];
  __shared__ unsigned long long red_c[2 * WARPS];
  const int tid = threadIdx.x;
  const double* psum = reinterpret_cast<const double*>(scratch + G_BLOCKS);
  const unsigned long long* pcnt = reinterpret_cast<const unsigned long long*>(psum + 2 * blocks);
  const bool mine = tid < blocks;
  double sl = mine ? psum[2 * tid] : 0.0, se = mine ? psum[2 * tid + 1] : 0.0;
  unsigned long long cl = mine ? pcnt[2 * tid] : 0ull, ce = mine ? pcnt[2 * tid + 1] : 0ull;
  block_sums(sl, se, cl, ce, red_d, red_c);
  if (tid == 0) {
    double* part = reinterpret_cast<double*>(scratch + G_PART);
    part[0] = sl;
    part[1] = se;
    part[2] = (double)cl;
    part[3] = (double)ce;
  }
}

__global__ void bk_global_result(const int* __restrict__ select_num,
                                 unsigned* __restrict__ scratch) {
  if (threadIdx.x != 0) return;
  const double* part = reinterpret_cast<const double*>(scratch + G_PART);
  const long long cl = (long long)part[2], ce = (long long)part[3];
  const long long need = max((long long)*select_num - cl, 0LL);
  const float w_eq = (float)need / (float)(ce > 0 ? ce : 1ll);
  float* result = reinterpret_cast<float*>(scratch + S_RESULT);
  result[0] = __fadd_rn((float)part[0], __fmul_rn((float)part[1], w_eq));
  result[1] = w_eq;
  result[2] = (float)cl;
  result[3] = (float)ce;
}

int global_blocks(int64_t n, int max_blocks) {
  int64_t b = (n + 8 * THREADS - 1) / (8 * THREADS);
  return (int)(b < 1 ? 1 : (b > max_blocks ? max_blocks : b));
}

// the forward's grid and slices for n keys: blocks, keys a block (a multiple of 4)
void slices(int64_t n, int max_blocks, int* blocks, int64_t* per) {
  int64_t b = (n + 8 * THREADS - 1) / (8 * THREADS);
  b = b < 1 ? 1 : (b > max_blocks ? max_blocks : b);
  int64_t p = ((n + b - 1) / b + 3) & ~(int64_t)3;
  if (p < 4) p = 4;
  *per = p;
  *blocks = (int)((n + p - 1) / p > 0 ? (n + p - 1) / p : 1);
}

}  // namespace

// Scratch words the forward needs with at most max_blocks blocks.
extern "C" long long bottom_k_scratch_words(int max_blocks) {
  return S_PARTIALS + 8ll * max_blocks;
}

// The forward's cooperative launch on the current device: sets its shared
// memory to the block maximum and writes the most blocks it may launch (every
// one resident) and the 4-byte words a block stages (its keys, then as many
// of its values as fit). Called once a device.
extern "C" int bottom_k_config(int* max_blocks, int* stage_keys) {
  int dev = 0, sms = 0, smem = 0, per_sm = 0;
  cudaFuncAttributes attr;
  int rc = (int)cudaGetDevice(&dev);
  if (rc == 0) rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == 0) rc = (int)cudaDeviceGetAttribute(&smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (rc == 0) rc = (int)cudaFuncGetAttributes(&attr, bk_select_sum);
  smem -= (int)attr.sharedSizeBytes;  // the grid sync's, if any
  if (rc == 0) rc = (int)cudaFuncSetAttribute(bk_select_sum,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc == 0) rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bk_select_sum,
                                                                       THREADS, smem);
  if (rc != 0) return rc;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *max_blocks = sms * per_sm < THREADS ? sms * per_sm : THREADS;  // a partial a thread at the end
  *stage_keys = ((smem - SM_KEYS) / 4) & ~3;
  return 0;
}

// Keys of n that the forward stages in shared memory (the rest it reads from
// global memory in every pass).
extern "C" long long bottom_k_staged_keys(long long n, int max_blocks, int stage_keys) {
  int blocks;
  int64_t per;
  slices(n, max_blocks, &blocks, &per);
  const int64_t stage = per < stage_keys ? per : stage_keys;
  long long staged = 0;
  for (int b = 0; b < blocks; ++b) {
    const int64_t m = n - b * per < per ? n - b * per : per;
    staged += m > 0 ? (m < stage ? m : stage) : 0;
  }
  return staged;
}

// keys, values: [n]; select_num: int32 [1] on the device; scratch:
// bottom_k_scratch_words(max_blocks) words, no initial contents; max_blocks
// and stage_keys from bottom_k_config. One launch, no host sync.
extern "C" int bottom_k_forward(const void* keys, const void* values, long long n,
                                const void* select_num, void* scratch, int max_blocks,
                                int stage_keys, void* stream) {
  if (n < 0 || n >= (1ll << 32) || max_blocks < 1 || stage_keys < 0)
    return (int)cudaErrorInvalidValue;
  int blocks;
  int64_t per;
  slices(n, max_blocks, &blocks, &per);
  // the keys first, then as many of the values as the rest holds
  int stage = (int)(per < stage_keys ? per : stage_keys);
  int vstage = (int)(per < stage_keys - stage ? per : stage_keys - stage);
  int64_t nn = n;
  void* args[] = {(void*)&keys, (void*)&values, (void*)&nn, (void*)&select_num, (void*)&per,
                  (void*)&stage, (void*)&vstage, (void*)&scratch};
  const int rc = (int)cudaLaunchCooperativeKernel(
      (const void*)bk_select_sum, dim3(blocks), dim3(THREADS), args,
      (size_t)SM_KEYS + 4 * ((size_t)stage + vstage), (cudaStream_t)stream);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

// dvalues[i] = grad * weight of element i, from the forward's scratch.
extern "C" int bottom_k_backward(const void* keys, long long n, const void* scratch,
                                 const void* grad, void* dvalues, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  int64_t blocks = (n + 1023) / 1024;
  if (blocks > 132 * 8) blocks = 132 * 8;
  bk_backward<<<(int)blocks, 256, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)keys, n, (const unsigned*)scratch, (const float*)grad,
      (float*)dvalues);
  return (int)cudaGetLastError();
}

// The global route's scratch words with at most max_blocks blocks.
extern "C" long long bottom_k_global_scratch_words(int max_blocks) {
  return G_BLOCKS + 8ll * max_blocks;
}

// Round `pass` (0, 1, 2) of the global route: zeroes the round's histogram and
// adds this rank's counts under the prefix of the all-reduced rounds before.
extern "C" int bottom_k_global_hist(const void* keys, long long n, const void* select_num,
                                    void* scratch, int pass, int max_blocks, void* stream) {
  if (n < 0 || n >= (1ll << 32) || pass < 0 || pass >= PASSES || max_blocks < 1)
    return (int)cudaErrorInvalidValue;
  unsigned* words = (unsigned*)scratch;
  int rc = (int)cudaMemsetAsync(words + S_HIST + pass * BINS, 0, BINS * sizeof(unsigned),
                                (cudaStream_t)stream);
  if (rc != 0) return rc;
  bk_global_hist<<<global_blocks(n, max_blocks), THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)keys, n, (const int*)select_num, words, pass);
  return (int)cudaGetLastError();
}

// This rank's sums below and at the global threshold (all three rounds
// all-reduced), as four f64 at G_PART; two launches.
extern "C" int bottom_k_global_sums(const void* keys, const void* values, long long n,
                                    const void* select_num, void* scratch, int max_blocks,
                                    void* stream) {
  if (n < 0 || n >= (1ll << 32) || max_blocks < 1 || max_blocks > THREADS)
    return (int)cudaErrorInvalidValue;
  const int blocks = global_blocks(n, max_blocks);
  bk_global_sums<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)keys, (const float*)values, n, (const int*)select_num,
      (unsigned*)scratch);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  bk_global_partials<<<1, THREADS, 0, (cudaStream_t)stream>>>((unsigned*)scratch, blocks);
  return (int)cudaGetLastError();
}

// The result from the all-reduced sums: the single launch's layout.
extern "C" int bottom_k_global_result(const void* select_num, void* scratch, void* stream) {
  bk_global_result<<<1, 32, 0, (cudaStream_t)stream>>>((const int*)select_num,
                                                       (unsigned*)scratch);
  return (int)cudaGetLastError();
}
