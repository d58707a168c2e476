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

// The smallest digit at which a histogram's running count reaches k, PER
// consecutive bins a thread (bins <= PER * THREADS; count(b) reads bin b):
// every block computes the same. Returns (digit, count below it) through
// shared memory; k <= 0 gives digit 0, k above the total the last digit (the
// global route's rounds meet both; the single launch never calls it so).
template <int PER, typename Count>
__device__ void scan_digit(Count count, int bins, long long k, unsigned long long* wsum,
                           unsigned* misc) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  unsigned long long s = 0;
#pragma unroll
  for (int j = 0; j < PER; ++j) s += PER * t + j < bins ? count(PER * t + j) : 0ull;
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
    long long below = excl;  // this thread's bins again, one by one
    for (int j = 0; j < PER; ++j) {
      const long long h = (long long)count(PER * t + j);
      if (k <= below + h) {
        misc[0] = PER * t + j;
        misc[1] = (unsigned)below;
        break;
      }
      below += h;
    }
  } else if (k <= 0 && t == 0) {  // none needed: digit 0 (the global route's rounds)
    misc[0] = 0u;
    misc[1] = 0u;
  } else if (k > 0 && t == THREADS - 1 && k > excl + (long long)s) {  // the keys fall short
    misc[0] = (unsigned)(bins - 1);
    misc[1] = (unsigned)(excl + (long long)s - count(bins - 1));
  }
  __syncthreads();
}

// scan_digit over a global int32 histogram of at most 2048 bins
__device__ void find_digit(const unsigned* __restrict__ ghist, int bins, long long k,
                           unsigned long long* wsum, unsigned* misc) {
  scan_digit<2>([=](int b) { return (unsigned long long)__ldcg(ghist + b); }, bins, k, wsum,
                misc);
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
// group (losses/rcl.py::bottom_k_sum_global). Four kernels and three
// all-reduces a call, nothing filled; the caller all-reduces what a kernel
// wrote before it launches the next:
//   bk_global_round<0>: one cooperative launch in clusters of CLUSTER blocks.
//     The blocks zero the rounds' histograms and the fold's counter; grid
//     barrier; each block bins its slice of keys by the first digit (the top
//     G_BITS0 bits) into a shared histogram; the cluster sums its blocks'
//     histograms over distributed shared memory (block r of the cluster a
//     range of bins) and adds each nonzero sum to the global histogram H0
//     with one atomic -> all-reduce of H0;
//   bk_global_round<1>: every block finds the first digit from H0 (scan_digit,
//     the same in every block; block 0 hands it and the count still needed on
//     in the scratch), then bins the keys under it by the second digit into
//     H1 the same way -> all-reduce of H1;
//   bk_global_fold: the prefix P of the first two digits (the first handed on,
//     the second from H1, handed on in turn). A key below P's band (key < P,
//     the band's own digit 0) adds its value to the thread's f64 sum below
//     and one to its count; a key in the band (its top G_BITS0 + G_BITS1 bits
//     are P's) adds one to the block's count of its last digit and its value
//     to its warp's f64 sum of that digit. A warp's band keys are added lane
//     by lane, iteration by iteration; the warps' sums in warp order, the
//     sums below as block_sums does; the blocks' of a cluster in rank order
//     over distributed shared memory, into one slot a cluster; the last
//     block to finish (the counter) adds the slots in cluster order ->
//     all-reduce of [band sums, band counts, sum below, count below], f64
//     (counts exact below 2^53);
//   bk_global_result: one block: the last digit from the band counts (on the
//     handed-on prefix and count still needed); n_less = count below + the
//     band counts under the digit, sum_less likewise, the band's part as a
//     block reduction in a fixed order; n_eq and sum_eq the digit's; need =
//     max(k - n_less, 0); the tie weight and the sum as the single launch
//     writes them, so bk_backward serves both routes.
// So the sum does not depend on the schedule, and after the all-reduces every
// rank computes the same. The keys are read three times (from L2 at the main
// size), the values once.
//
// Digits: 12 bits a round, the last 8 the fold's. Two 16-bit rounds (65,536-bin
// histograms, too wide for a block's shared copy) measured over ten times
// slower on an H100 (PERF.md).
// Scratch (int32 words, no initial contents): the single launch's header
// ([0] threshold, [1, 5) result), [G_COUNTER] the fold's counter, the
// handed-on prefixes from G_PREFIX, H0 from G_H0, H1 from G_H1, the
// all-reduced fold from G_PART (G_SLOT f64), then a slot of G_SLOT f64 a
// cluster; bottom_k_global_layout gives the offsets.

constexpr int CLUSTER = 8;
constexpr int G_BITS0 = 12, G_BITS1 = 12;
constexpr int G_SHIFT0 = 32 - G_BITS0, G_FOLD = G_SHIFT0 - G_BITS1;
constexpr int G_BINS0 = 1 << G_BITS0, G_BINS1 = 1 << G_BITS1, G_FOLD_BINS = 1 << G_FOLD;
static_assert(G_FOLD > 0 && G_FOLD <= 8, "the fold keeps a warp's sums of its bins");
constexpr int G_SLOT = 2 * G_FOLD_BINS + 2;
constexpr int G_COUNTER = 5;
// the prefix after round r (u32 at G_PREFIX + 4 r) and the count still
// needed (i64 at G_PREFIX + 4 r + 2), written by the kernel after it
constexpr int G_PREFIX = 8;
constexpr int G_H0 = 16;
constexpr int G_H1 = G_H0 + G_BINS0;
constexpr int G_PART = G_H1 + G_BINS1;  // even: 8-byte aligned
constexpr int G_SLOTS = G_PART + 2 * G_SLOT;
static_assert(G_PART % 2 == 0 && G_SLOT % 2 == 0, "f64 alignment");
// the fold's shared memory: the warps' band sums, the block's slot, its counts
constexpr int G_FOLD_SMEM = 8 * (WARPS * G_FOLD_BINS + G_SLOT) + 4 * G_FOLD_BINS;

// The digit of round `round` from its all-reduced histogram, on top of the
// prefix and count still needed that the rounds before it handed on (k and
// prefix 0 for round 0): the threshold's prefix through this round and the
// count still needed after it. Every block computes the same; block 0's
// thread 0 hands them on in the scratch when `hand_on`.
__device__ void g_digit(unsigned* __restrict__ scratch, long long k, int round,
                        unsigned long long* wsum, unsigned* misc, unsigned* prefix,
                        long long* left, bool hand_on) {
  unsigned pre = 0u;
  long long l = k;
  if (round > 0) {
    pre = __ldcg(scratch + G_PREFIX);
    l = __ldcg(reinterpret_cast<const long long*>(scratch + G_PREFIX + 2));
  }
  if (round == 0) {
    const unsigned* h0 = scratch + G_H0;
    scan_digit<(G_BINS0 + THREADS - 1) / THREADS>(
        [=](int b) { return (unsigned long long)__ldcg(h0 + b); }, G_BINS0, l, wsum, misc);
    pre |= misc[0] << G_SHIFT0;
  } else {
    const unsigned* h1 = scratch + G_H1;
    scan_digit<(G_BINS1 + THREADS - 1) / THREADS>(
        [=](int b) { return (unsigned long long)__ldcg(h1 + b); }, G_BINS1, l, wsum, misc);
    pre |= misc[0] << G_FOLD;
  }
  l -= misc[1];
  if (hand_on && blockIdx.x == 0 && threadIdx.x == 0) {
    scratch[G_PREFIX + 4 * round] = pre;
    *reinterpret_cast<long long*>(scratch + G_PREFIX + 4 * round + 2) = l;
  }
  *prefix = pre;
  *left = l;
}

// op(key, value, ok) over the block's slice [start, start + m): four at a
// time where keys (and values) are 16-byte aligned, every lane of a warp in
// every iteration (the fold's ballots need them).
template <bool VALUES, typename Op>
__device__ __forceinline__ void g_sweep(const uint32_t* __restrict__ keys,
                                        const float* __restrict__ values, int64_t start,
                                        int64_t m, Op op) {
  const int tid = threadIdx.x;
  const uint32_t* gk = keys + start;
  const float* gv = VALUES ? values + start : nullptr;
  int64_t from = 0;
  if ((((uintptr_t)gk | (uintptr_t)gv) & 15) == 0) {
    const int64_t units = m >> 2;
    for (int64_t b = 0; b < units; b += THREADS) {
      const int64_t u = b + tid;
      const bool ok = u < units;
      const uint4 q = ok ? __ldg(reinterpret_cast<const uint4*>(gk) + u) : make_uint4(0, 0, 0, 0);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (VALUES && ok) v = __ldg(reinterpret_cast<const float4*>(gv) + u);
      op(q.x, v.x, ok);
      op(q.y, v.y, ok);
      op(q.z, v.z, ok);
      op(q.w, v.w, ok);
    }
    from = 4 * units;
  }
  for (int64_t b = from; b < m; b += THREADS) {
    const int64_t i = b + tid;
    const bool ok = i < m;
    op(ok ? __ldg(gk + i) : 0u, VALUES && ok ? __ldg(gv + i) : 0.f, ok);
  }
}

template <int ROUND>
__global__ void __launch_bounds__(THREADS, 1) bk_global_round(const uint32_t* __restrict__ keys,
                                                              int64_t n, int64_t per,
                                                              const int* __restrict__ select_num,
                                                              unsigned* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char g_smem[];
  __shared__ unsigned long long wsum[WARPS];
  __shared__ unsigned misc[4];
  constexpr int BINS = ROUND == 0 ? G_BINS0 : G_BINS1;
  constexpr int SHIFT = ROUND == 0 ? G_SHIFT0 : G_FOLD;
  unsigned* const ghist = scratch + (ROUND == 0 ? G_H0 : G_H1);
  unsigned* const hist = reinterpret_cast<unsigned*>(g_smem);
  const int tid = threadIdx.x;
  for (int i = tid; i < BINS; i += THREADS) hist[i] = 0u;
  unsigned prefix = 0u, hi = 0u;
  if constexpr (ROUND == 0) {
    // zero both rounds' histograms and the counter, a share a block
    const int words = G_PART - G_H0;
    const int chunk = (words + (int)gridDim.x - 1) / (int)gridDim.x;
    const int w0 = (int)blockIdx.x * chunk, w1 = min(w0 + chunk, words);
    for (int w = w0 + tid; w < w1; w += THREADS) scratch[G_H0 + w] = 0u;
    if (blockIdx.x == 0 && tid == 0) scratch[G_COUNTER] = 0u;
    cooperative_groups::this_grid().sync();
  } else {
    long long left;
    g_digit(scratch, *select_num, 0, wsum, misc, &prefix, &left, true);
    hi = ~0u << G_SHIFT0;
  }
  __syncthreads();  // the shared histogram is zero
  const int64_t start = (int64_t)blockIdx.x * per;
  const int64_t m = start < n ? (n - start < per ? n - start : per) : 0;
  g_sweep<false>(keys, nullptr, start, m, [&](uint32_t key, float, bool ok) {
    if (ok && (key & hi) == prefix) atomicAdd(&hist[(key >> SHIFT) & (BINS - 1)], 1u);
  });
  // the cluster's histograms summed over its blocks, by bin ranges
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  cluster.sync();  // every count has landed
  const int rank = (int)cluster.block_rank();
  constexpr int SHARE = BINS / CLUSTER;  // a multiple of 4
  const uint4* peer[CLUSTER];
#pragma unroll
  for (int q = 0; q < CLUSTER; ++q)
    peer[q] = reinterpret_cast<const uint4*>(cluster.map_shared_rank(hist, q));
  for (int u = tid; u < SHARE / 4; u += THREADS) {
    uint4 s = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int q = 0; q < CLUSTER; ++q) {
      const uint4 v = peer[q][rank * SHARE / 4 + u];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    unsigned* g = ghist + rank * SHARE + 4 * u;
    if (s.x) atomicAdd(g, s.x);
    if (s.y) atomicAdd(g + 1, s.y);
    if (s.z) atomicAdd(g + 2, s.z);
    if (s.w) atomicAdd(g + 3, s.w);
  }
  cluster.sync();  // no block leaves while a peer reads its shared memory
}

__global__ void __launch_bounds__(THREADS, 1) bk_global_fold(const uint32_t* __restrict__ keys,
                                                             const float* __restrict__ values,
                                                             int64_t n, int64_t per,
                                                             const int* __restrict__ select_num,
                                                             unsigned* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char g_smem[];
  __shared__ double red_d[2 * WARPS];
  __shared__ unsigned long long red_c[2 * WARPS];
  __shared__ unsigned misc[4];
  double* wacc = reinterpret_cast<double*>(g_smem);  // [WARPS][G_FOLD_BINS]
  double* slot = wacc + WARPS * G_FOLD_BINS;          // [G_SLOT]
  unsigned* bcnt = reinterpret_cast<unsigned*>(slot + G_SLOT);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < WARPS * G_FOLD_BINS; i += THREADS) wacc[i] = 0.0;
  for (int i = tid; i < G_FOLD_BINS; i += THREADS) bcnt[i] = 0u;
  unsigned prefix;
  long long left;
  g_digit(scratch, *select_num, 1, red_c, misc, &prefix, &left, true);
  const unsigned hi = ~0u << G_FOLD;
  double sl = 0.0;
  unsigned long long cl = 0;
  double* mine = wacc + warp * G_FOLD_BINS;
  const int64_t start = (int64_t)blockIdx.x * per;
  const int64_t m = start < n ? (n - start < per ? n - start : per) : 0;
  g_sweep<true>(keys, values, start, m, [&](uint32_t key, float v, bool ok) {
    if (ok && key < prefix) {
      sl += (double)v;
      ++cl;
    }
    const bool band = ok && (key & hi) == prefix;
    unsigned lanes = __ballot_sync(FULL, band);
    if (lanes == 0u) return;
    const unsigned d = key & (unsigned)(G_FOLD_BINS - 1);
    if (band) atomicAdd(&bcnt[d], 1u);  // integer: the order does not matter
    while (lanes) {  // the sums lane by lane
      const int src = __ffs(lanes) - 1;
      lanes &= lanes - 1u;
      const unsigned dd = __shfl_sync(FULL, d, src);
      const float vv = __shfl_sync(FULL, v, src);
      if (lane == 0) mine[dd] += (double)vv;
    }
  });
  double se = 0.0;
  unsigned long long ce = 0;
  block_sums(sl, se, cl, ce, red_d, red_c);  // syncs: the warps' sums are in
  for (int b = tid; b < G_FOLD_BINS; b += THREADS) {
    double s = 0.0;
    for (int w = 0; w < WARPS; ++w) s += wacc[w * G_FOLD_BINS + b];
    slot[b] = s;
    slot[G_FOLD_BINS + b] = (double)bcnt[b];
  }
  if (tid == 0) {
    slot[2 * G_FOLD_BINS] = sl;
    slot[2 * G_FOLD_BINS + 1] = (double)cl;
  }
  // the cluster's slot: its blocks' summed in rank order
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  cluster.sync();
  const int rank = (int)cluster.block_rank();
  constexpr int SHARE = (G_SLOT + CLUSTER - 1) / CLUSTER;
  double* gslot = reinterpret_cast<double*>(scratch + G_SLOTS) +
                  (int64_t)(blockIdx.x / CLUSTER) * G_SLOT;
  for (int e = rank * SHARE + tid; e < min(G_SLOT, (rank + 1) * SHARE); e += THREADS) {
    double s = 0.0;
#pragma unroll
    for (int q = 0; q < CLUSTER; ++q) s += cluster.map_shared_rank(slot, q)[e];
    gslot[e] = s;
  }
  cluster.sync();  // no block leaves while a peer reads its shared memory
  // the last block to finish adds the clusters' slots in cluster order
  __threadfence();
  __syncthreads();
  if (tid == 0) misc[0] = atomicAdd(scratch + G_COUNTER, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!misc[0]) return;
  __threadfence();
  const double* slots = reinterpret_cast<const double*>(scratch + G_SLOTS);
  double* part = reinterpret_cast<double*>(scratch + G_PART);
  const int clusters = (int)gridDim.x / CLUSTER;
  for (int e = tid; e < G_SLOT; e += THREADS) {
    double s = 0.0;
    for (int c = 0; c < clusters; ++c) s += __ldcg(slots + (int64_t)c * G_SLOT + e);
    part[e] = s;
  }
}

__global__ void __launch_bounds__(THREADS) bk_global_result(const int* __restrict__ select_num,
                                                            unsigned* __restrict__ scratch) {
  __shared__ unsigned long long wsum[WARPS];
  __shared__ double red_d[2 * WARPS];
  __shared__ unsigned long long red_c[2 * WARPS];
  __shared__ unsigned misc[4];
  const int tid = threadIdx.x;
  const long long k = *select_num;
  const unsigned prefix = __ldcg(scratch + G_PREFIX + 4);
  const long long left = __ldcg(reinterpret_cast<const long long*>(scratch + G_PREFIX + 6));
  const double* part = reinterpret_cast<const double*>(scratch + G_PART);
  scan_digit<(G_FOLD_BINS + THREADS - 1) / THREADS>(
      [=](int b) { return (unsigned long long)__ldcg(part + G_FOLD_BINS + b); }, G_FOLD_BINS,
      left, wsum, misc);
  const int d = (int)misc[0];
  // the band below the digit, a fixed-order block reduction; the count exact
  double sl = 0.0, se = 0.0;
  unsigned long long cl = 0, ce = 0;
  for (int b = tid; b < d; b += THREADS) {
    sl += __ldcg(part + b);
    cl += (unsigned long long)__ldcg(part + G_FOLD_BINS + b);
  }
  block_sums(sl, se, cl, ce, red_d, red_c);
  if (tid != 0) return;
  sl += part[2 * G_FOLD_BINS];
  const long long n_less = (long long)cl + (long long)part[2 * G_FOLD_BINS + 1];
  const double sum_eq = part[d];
  const long long n_eq = (long long)part[G_FOLD_BINS + d];
  const long long need = max(k - n_less, 0LL);
  const float w_eq = (float)need / (float)(n_eq > 0 ? n_eq : 1ll);
  float* result = reinterpret_cast<float*>(scratch + S_RESULT);
  result[0] = __fadd_rn((float)sl, __fmul_rn((float)sum_eq, w_eq));
  result[1] = w_eq;
  result[2] = (float)n_less;
  result[3] = (float)n_eq;
  scratch[S_THRESHOLD] = prefix | (unsigned)d;
}

// the global route's grid for n keys: blocks (whole clusters, at most
// max_blocks) and keys a block (a multiple of 4)
void g_slices(int64_t n, int max_blocks, int* blocks, int64_t* per) {
  int64_t c = (n + (int64_t)CLUSTER * THREADS * 4 - 1) / ((int64_t)CLUSTER * THREADS * 4);
  const int64_t most = max_blocks / CLUSTER;
  c = c < 1 ? 1 : (c > most ? most : c);
  *blocks = (int)(c * CLUSTER);
  int64_t p = ((n + *blocks - 1) / *blocks + 3) & ~(int64_t)3;
  *per = p < 4 ? 4 : p;
}

template <typename Kernel, typename... Args>
int g_launch(Kernel kernel, int blocks, size_t smem, bool cooperative, void* stream,
             Args... args) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = CLUSTER;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeCooperative;
  attrs[1].val.cooperative = 1;
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attrs;
  cfg.numAttrs = cooperative ? 2 : 1;
  const int rc = (int)cudaLaunchKernelEx(&cfg, kernel, args...);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

constexpr size_t g_round_smem(int bins) { return 4 * (size_t)bins; }

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

// Once a device: the global route's dynamic shared memory, and the most blocks
// its cooperative round may take (whole clusters, every block resident).
extern "C" int bottom_k_global_config(int* max_blocks) {
  int rc = (int)cudaFuncSetAttribute(bk_global_fold, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     G_FOLD_SMEM);
  if (rc != 0) return rc;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = CLUSTER;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(CLUSTER);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = g_round_smem(G_BINS0);
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  int clusters = 0;
  rc = (int)cudaOccupancyMaxActiveClusters(&clusters, bk_global_round<0>, &cfg);
  if (rc != 0) return rc;
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  *max_blocks = clusters * CLUSTER;
  return 0;
}

// The global route's scratch with at most max_blocks blocks (int32 words):
// out[0] H0's first word, out[1] its bins, out[2] H1's first word, out[3] its
// bins, out[4] the fold's first word (f64 from there), out[5] its f64
// entries, out[6] the words in all.
extern "C" int bottom_k_global_layout(int max_blocks, long long* out) {
  if (max_blocks < CLUSTER) return (int)cudaErrorInvalidValue;
  out[0] = G_H0;
  out[1] = G_BINS0;
  out[2] = G_H1;
  out[3] = G_BINS1;
  out[4] = G_PART;
  out[5] = G_SLOT;
  out[6] = G_SLOTS + 2ll * G_SLOT * (max_blocks / CLUSTER);
  return 0;
}

// Round 0 or 1 of the global route: this rank's counts of the round's digit
// under the prefix of the all-reduced rounds before (round 0 also zeroes the
// scratch the route adds into).
extern "C" int bottom_k_global_round(const void* keys, long long n, const void* select_num,
                                     void* scratch, int round, int max_blocks, void* stream) {
  if (n < 0 || n >= (1ll << 32) || round < 0 || round > 1 || max_blocks < CLUSTER)
    return (int)cudaErrorInvalidValue;
  int blocks;
  int64_t per;
  g_slices(n, max_blocks, &blocks, &per);
  int64_t nn = n;
  if (round == 0)
    return g_launch(bk_global_round<0>, blocks, g_round_smem(G_BINS0), true, stream,
                    (const uint32_t*)keys, nn, per, (const int*)select_num, (unsigned*)scratch);
  return g_launch(bk_global_round<1>, blocks, g_round_smem(G_BINS1), false, stream,
                  (const uint32_t*)keys, nn, per, (const int*)select_num, (unsigned*)scratch);
}

// The fold: this rank's sum and count below the band of the two all-reduced
// rounds' prefix and its band's sums and counts by the last digit, G_SLOT f64
// at the layout's fold word.
extern "C" int bottom_k_global_fold(const void* keys, const void* values, long long n,
                                    const void* select_num, void* scratch, int max_blocks,
                                    void* stream) {
  if (n < 0 || n >= (1ll << 32) || max_blocks < CLUSTER) return (int)cudaErrorInvalidValue;
  int blocks;
  int64_t per;
  g_slices(n, max_blocks, &blocks, &per);
  int64_t nn = n;
  return g_launch(bk_global_fold, blocks, (size_t)G_FOLD_SMEM, false, stream,
                  (const uint32_t*)keys, (const float*)values, nn, per, (const int*)select_num,
                  (unsigned*)scratch);
}

// The result from the all-reduced fold: the single launch's layout.
extern "C" int bottom_k_global_result(const void* select_num, void* scratch, void* stream) {
  bk_global_result<<<1, THREADS, 0, (cudaStream_t)stream>>>((const int*)select_num,
                                                            (unsigned*)scratch);
  return (int)cudaGetLastError();
}
