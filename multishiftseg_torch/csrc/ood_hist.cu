// Binned OOD metrics for Hopper (sm_90a): the masked score range and the
// label-split score histogram of one map.
//
// Replaces multishiftseg_tpu/evals/ood_metrics.py:
//   * _masked_min_max (:197): lo, hi = min / max of the scores whose label is
//     0 or 1 (+inf / -inf when there is none; NaN, both, when one of those
//     scores is NaN, as jnp.min / jnp.max give)      entry ood_masked_min_max
//   * _hist_update (:186), and the histogram of binned_ood_metrics (:286):
//     bin = clamp((int)((s - lo) / max(hi - lo, 1e-12) * nb), 0, nb - 1);
//     pos[bin] += label == 1, neg[bin] += label == 0   entry ood_hist
// The bin is computed in exactly that f32 order with IEEE division (this
// source must not be built with --use_fast_math), so the counts equal the
// plain version's bit for bit. The float is clamped to [0, nb] before the
// conversion: the same bin for every non-NaN value, without the conversion of
// an out-of-range float.
//
// Design. Min / max: a grid-stride block reduce that keeps a NaN, then one
// atomicMin / atomicMax per block on the order-preserving int image of the
// float, read back as floats by a one-thread pass. A NaN enters the atomics
// as the NaN whose image orders below -inf (min) or above +inf (max), so it
// wins both. Histogram: each block counts into its
// own pos / neg histograms in shared memory (2 x nb ints, 64 KB at 8192 bins,
// above the default 48 KB: opt-in), then adds its nonzero bins to the output
// with int32 atomics. Both entries read lo / hi from device memory, so the
// caller needs no host sync between them.
// Bound at 720x1280: 921,600 scores + labels, 7.4 MB read, 2.2 us at
// 3.35 TB/s per entry; the launches and the caller's per-map host sync take
// longer than the work.

#include <cuda_runtime.h>
#include <stdint.h>

#define OOD_THREADS 256
#define POS_INF __int_as_float(0x7f800000)
#define NEG_INF __int_as_float(0xff800000)

__device__ __forceinline__ int float_to_ordered(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float ordered_to_float(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

__device__ __forceinline__ bool valid_label(int l) { return l == 0 || l == 1; }

// min / max that return a NaN operand (fminf / fmaxf would drop it)
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || a < b) ? a : b;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__global__ void minmax_init_kernel(int* lohi) {
  lohi[0] = float_to_ordered(POS_INF);
  lohi[1] = float_to_ordered(NEG_INF);
}

__global__ void __launch_bounds__(OOD_THREADS)
minmax_kernel(const float* __restrict__ scores, const int* __restrict__ labels,
              int64_t n, int* __restrict__ lohi) {
  __shared__ float slo[OOD_THREADS / 32], shi[OOD_THREADS / 32];
  float lo = POS_INF, hi = NEG_INF;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    if (valid_label(labels[i])) {
      const float s = scores[i];
      lo = nan_min(lo, s);
      hi = nan_max(hi, s);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = nan_min(lo, __shfl_down_sync(0xffffffffu, lo, off));
    hi = nan_max(hi, __shfl_down_sync(0xffffffffu, hi, off));
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    slo[warp] = lo;
    shi[warp] = hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int wv = 1; wv < OOD_THREADS / 32; ++wv) {
      lo = nan_min(lo, slo[wv]);
      hi = nan_max(hi, shi[wv]);
    }
    atomicMin(&lohi[0], float_to_ordered(lo != lo ? __int_as_float((int)0xffc00000) : lo));
    atomicMax(&lohi[1], float_to_ordered(hi != hi ? __int_as_float((int)0x7fc00000) : hi));
  }
}

__global__ void minmax_finish_kernel(int* lohi) {
  const int lo = lohi[0], hi = lohi[1];
  float* out = reinterpret_cast<float*>(lohi);
  out[0] = ordered_to_float(lo);
  out[1] = ordered_to_float(hi);
}

__global__ void __launch_bounds__(OOD_THREADS)
hist_kernel(const float* __restrict__ scores, const int* __restrict__ labels,
            int64_t n, const float* __restrict__ lohi, int nb,
            int* __restrict__ pos, int* __restrict__ neg) {
  extern __shared__ int shist[];  // [pos nb | neg nb]
  for (int i = threadIdx.x; i < 2 * nb; i += blockDim.x) shist[i] = 0;
  __syncthreads();
  const float lo = lohi[0];
  const float span = fmaxf(lohi[1] - lo, 1e-12f);
  const float bins = (float)nb;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int l = labels[i];
    if (!valid_label(l)) continue;
    float x = __fdiv_rn(scores[i] - lo, span) * bins;
    x = fminf(fmaxf(x, 0.f), bins);
    const int b = min((int)x, nb - 1);
    atomicAdd(&shist[(l == 1 ? 0 : nb) + b], 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * nb; i += blockDim.x) {
    const int c = shist[i];
    if (c != 0) atomicAdd(i < nb ? &pos[i] : &neg[i - nb], c);
  }
}

static int grid_blocks(int64_t n) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t want = (n + OOD_THREADS * 16 - 1) / (OOD_THREADS * 16);
  return (int)(want < 1 ? 1 : (want < sms ? want : sms));
}

// scores f32 [n], labels int32 [n] -> lohi f32 [2] = (lo, hi) over the pixels
// labelled 0 or 1; (+inf, -inf) when there is none.
extern "C" int ood_masked_min_max(const void* scores, const void* labels,
                                  long long n, void* lohi, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  minmax_init_kernel<<<1, 1, 0, st>>>((int*)lohi);
  if (n > 0) {
    minmax_kernel<<<grid_blocks(n), OOD_THREADS, 0, st>>>(
        (const float*)scores, (const int*)labels, (int64_t)n, (int*)lohi);
  }
  minmax_finish_kernel<<<1, 1, 0, st>>>((int*)lohi);
  return (int)cudaGetLastError();
}

// Adds the counts of one map to pos / neg (int32 [nb] each; the wrapper
// passes zeros),
// binned over [lohi[0], lohi[1]] (f32 [2] in device memory).
extern "C" int ood_hist(const void* scores, const void* labels, long long n,
                        const void* lohi, int nb, void* pos, void* neg,
                        void* stream) {
  const size_t smem = (size_t)2 * nb * sizeof(int);
  if (n < 0 || nb < 1 || smem > 232448) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  hist_kernel<<<grid_blocks(n), OOD_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)scores, (const int*)labels, (int64_t)n, (const float*)lohi,
      nb, (int*)pos, (int*)neg);
  return (int)cudaGetLastError();
}
