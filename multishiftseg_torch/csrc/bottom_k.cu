// Sum of the k smallest-keyed values with threshold ties sharing the remainder,
// for Hopper (sm_90a).
//
// Replaces _bottom_k_sum (multishiftseg_tpu/losses/rcl.py:65), RCL's pixel
// selection: keys are the detached per-pixel CE values (>= 0, +inf where the
// pixel is not in-distribution), compared as their uint32 bit patterns (monotone
// for non-negative floats). The JAX package finds the k-th smallest key by a
// 32-step binary search over the bit pattern, each step a full pass; here a radix
// select finds the same key in four passes of an 8-bit histogram (bk_hist, one
// launch a byte, most significant first), then one pass (bk_reduce) counts and
// sums the values below and at it:
//   sum = sum_less + sum_eq * need / max(n_eq, 1),  need = max(k - n_less, 0).
// k (select_num) stays on the device; so do the threshold and the tie weight,
// which the backward (bk_backward) reads: d values = g * (1 below the threshold,
// need / n_eq at it, 0 above). As the binary search, k <= 0 gives threshold 0
// and k > n gives 0xFFFFFFFF.
//
// Each pass's blocks count into shared memory (one atomic a warp and bin) and
// add into a global histogram; the last block to finish (atomic ticket after a
// fence) scans it, fixes the next byte of the threshold, and clears the
// histogram for the next pass. The
// final pass sums in f64 per block and the last block adds the block partials
// in a fixed order, so the result does not depend on the schedule.
//
// Bound at the main-path shapes (8 x 700 x 700 = 3.92 M f32 CE values): reading
// keys and values once is 31.4 MB, 9.4 us at 3.35 TB/s; the four histogram
// passes re-read the keys (from L2 after the first). Memory bound.
//
// Work buffer (int32, zeroed by the caller): [0, 256) histogram, [256] ticket,
// [257] threshold so far, [258] k left, [259] 1 if k fixed the threshold
// outright. Result buffer (f32 [4]): sum, tie weight, n_less, n_eq.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ bool last_block(unsigned int* ticket) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

__global__ void __launch_bounds__(THREADS) bk_hist(const uint32_t* __restrict__ keys, int64_t n,
                                                   const int* __restrict__ select_num,
                                                   unsigned int* __restrict__ work, int shift) {
  __shared__ unsigned int hist[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) hist[i] = 0;
  __syncthreads();
  const unsigned int prefix = __ldcg(work + 257);
  const unsigned int hi = shift == 24 ? 0u : (0xFFFFFFFFu << (shift + 8));
  if (shift == 24 || __ldcg(work + 259) == 0u) {
    // warp-uniform trip count, so that the lanes with one bin add once: the
    // keys' high bytes (the exponent, in the first pass) crowd into few bins
    const int lane = threadIdx.x & 31;
    for (int64_t base = (int64_t)blockIdx.x * blockDim.x; base < n;
         base += (int64_t)gridDim.x * blockDim.x) {
      const int64_t i = base + threadIdx.x;
      unsigned int bin = 256u;  // none
      if (i < n) {
        const uint32_t b = __ldg(keys + i);
        if ((b & hi) == (prefix & hi)) bin = (b >> shift) & 255u;
      }
      const unsigned int same = __match_any_sync(0xffffffffu, bin);
      if (bin < 256u && lane == __ffs(same) - 1) atomicAdd(&hist[bin], __popc(same));
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 256; i += blockDim.x)
    if (hist[i]) atomicAdd(work + i, hist[i]);
  if (!last_block(work + 256)) return;
  // the whole histogram into shared memory at once, then one thread scans it
  __syncthreads();
  for (int i = threadIdx.x; i < 256; i += blockDim.x) hist[i] = __ldcg(work + i);
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned int p = prefix;
    int64_t k;
    unsigned int fixed;
    if (shift == 24) {
      k = *select_num;
      fixed = k <= 0 || k > n;
      if (k <= 0) p = 0u;
      if (k > n) p = 0xFFFFFFFFu;
    } else {
      k = (int)__ldcg(work + 258);
      fixed = __ldcg(work + 259);
    }
    if (!fixed) {
      int64_t below = 0;
      int b = 0;
      for (; b < 255; ++b) {
        const int64_t h = hist[b];
        if (below + h >= k) break;
        below += h;
      }
      p |= (unsigned int)b << shift;
      k -= below;
    }
    work[257] = p;
    work[258] = (unsigned int)k;
    work[259] = fixed;
    work[256] = 0u;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 256; i += blockDim.x) work[i] = 0u;
}

template <typename T>
__device__ T block_sum(T v, T* shared) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) shared[warp] = v;
  __syncthreads();
  T s = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += shared[w];  // fixed order
  return s;
}

__global__ void __launch_bounds__(THREADS) bk_reduce(
    const uint32_t* __restrict__ keys, const float* __restrict__ values, int64_t n,
    const int* __restrict__ select_num, unsigned int* __restrict__ work,
    double* __restrict__ part_sum, unsigned long long* __restrict__ part_cnt,
    float* __restrict__ result) {
  __shared__ double sd[THREADS / 32];
  __shared__ unsigned long long sc[THREADS / 32];
  const unsigned int t = __ldcg(work + 257);
  double s_less = 0.0, s_eq = 0.0;
  unsigned long long c_less = 0, c_eq = 0;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const uint32_t b = __ldg(keys + i);
    const double v = (double)__ldg(values + i);
    if (b < t) {
      s_less += v;
      ++c_less;
    } else if (b == t) {
      s_eq += v;
      ++c_eq;
    }
  }
  s_less = block_sum(s_less, sd);
  s_eq = block_sum(s_eq, sd);
  c_less = block_sum(c_less, sc);
  c_eq = block_sum(c_eq, sc);
  if (threadIdx.x == 0) {
    part_sum[2 * blockIdx.x] = s_less;
    part_sum[2 * blockIdx.x + 1] = s_eq;
    part_cnt[2 * blockIdx.x] = c_less;
    part_cnt[2 * blockIdx.x + 1] = c_eq;
  }
  if (!last_block(work + 256)) return;
  // the block partials: a strided share per thread, then the block sum, both
  // in a fixed order
  s_less = s_eq = 0.0;
  c_less = c_eq = 0;
  for (unsigned int b = threadIdx.x; b < gridDim.x; b += blockDim.x) {
    s_less += __ldcg(part_sum + 2 * b);
    s_eq += __ldcg(part_sum + 2 * b + 1);
    c_less += __ldcg(part_cnt + 2 * b);
    c_eq += __ldcg(part_cnt + 2 * b + 1);
  }
  const double sl = block_sum(s_less, sd), se = block_sum(s_eq, sd);
  const unsigned long long nl = block_sum(c_less, sc), ne = block_sum(c_eq, sc);
  if (threadIdx.x == 0) {
    const long long need = max((long long)*select_num - (long long)nl, 0LL);
    const float w_eq = (float)need / (float)(ne > 0 ? ne : 1ull);
    result[0] = (float)sl + (float)se * w_eq;
    result[1] = w_eq;
    result[2] = (float)nl;
    result[3] = (float)ne;
    work[256] = 0u;
  }
}

__global__ void __launch_bounds__(THREADS) bk_backward(const uint32_t* __restrict__ keys,
                                                       int64_t n,
                                                       const unsigned int* __restrict__ work,
                                                       const float* __restrict__ result,
                                                       const float* __restrict__ grad,
                                                       float* __restrict__ dvalues) {
  const unsigned int t = __ldg(work + 257);
  const float g = __ldg(grad), w_eq = __ldg(result + 1);
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const uint32_t b = __ldg(keys + i);
    dvalues[i] = b < t ? g : (b == t ? g * w_eq : 0.f);
  }
}

int grid_for(int64_t n) {
  int64_t blocks = (n + THREADS * 4 - 1) / (THREADS * 4);
  if (blocks > 132 * 8) blocks = 132 * 8;
  return blocks < 1 ? 1 : (int)blocks;
}

}  // namespace

extern "C" int bottom_k_blocks(long long n) { return grid_for(n); }

// keys, values: [n]; select_num: int32 [1] on the device; work: int32 [260],
// zeroed; part_sum: f64 [2 * blocks]; part_cnt: u64 [2 * blocks], blocks =
// bottom_k_blocks(n); result: f32 [4]. Five launches, no host sync.
extern "C" int bottom_k_forward(const void* keys, const void* values, long long n,
                                const void* select_num, void* work, void* part_sum,
                                void* part_cnt, void* result, void* stream) {
  if (n < 0 || n >= (1ll << 32)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int blocks = grid_for(n);
  for (int shift = 24; shift >= 0; shift -= 8) {
    bk_hist<<<blocks, THREADS, 0, st>>>((const uint32_t*)keys, n, (const int*)select_num,
                                        (unsigned int*)work, shift);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  bk_reduce<<<blocks, THREADS, 0, st>>>((const uint32_t*)keys, (const float*)values, n,
                                        (const int*)select_num, (unsigned int*)work,
                                        (double*)part_sum, (unsigned long long*)part_cnt,
                                        (float*)result);
  return (int)cudaGetLastError();
}

// dvalues[i] = grad * weight of element i, from the forward's work and result.
extern "C" int bottom_k_backward(const void* keys, long long n, const void* work,
                                 const void* result, const void* grad, void* dvalues,
                                 void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  bk_backward<<<grid_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)keys, n, (const unsigned int*)work, (const float*)result,
      (const float*)grad, (float*)dvalues);
  return (int)cudaGetLastError();
}
