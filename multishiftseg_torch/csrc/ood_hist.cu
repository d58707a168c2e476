// Binned OOD metrics for Hopper (sm_90a): the masked score range and the
// label-split score histogram of one map, one kernel a call.
//
// Replaces multishiftseg_tpu/evals/ood_metrics.py:
//   * _masked_min_max (:197): lo, hi = min / max of the scores whose label is
//     0 or 1 (+inf / -inf when there is none; NaN, both, when one of those
//     scores is NaN, as jnp.min / jnp.max give)            mode RANGE
//   * _hist_update (:186), and the histogram of binned_ood_metrics (:286):
//     bin = clip(int((s - lo) / max(hi - lo, 1e-12) * nb), 0, nb - 1);
//     pos[bin] += label == 1, neg[bin] += label == 0         mode HIST
//   * both in sequence, the body of BinnedOODMeter.update (:235-241) and of
//     binned_ood_metrics without a given range                RANGE | HIST
// The bin is computed in exactly that f32 order with IEEE division (this
// source must not be built with --use_fast_math), so the counts equal the
// plain version's bit for bit. max(hi - lo, 1e-12) keeps a NaN, as jnp.maximum
// does. The float is clamped to [0, nb] before the conversion: the same bin
// for every non-NaN value, and a NaN (fmaxf(NaN, 0) = 0) lands in bin 0, where
// XLA's conversion (NaN to 0) and clip put it.
//
// Design: one cooperative launch (every block resident, one an SM, 1024
// threads) in clusters of CLUSTER blocks. Block b takes a contiguous slice of
// the pixels.
//   1. Each block reads its slice once (16-byte loads where the map is
//      contiguous and aligned; rows of width w, ld apart, for a cropped view)
//      and takes the slice's NaN-keeping min / max over the valid pixels. With
//      RANGE | HIST it copies the slice to shared memory as it goes (scores f32,
//      labels one byte: 0, 1 or 2 for void), as far as its share of shared
//      memory holds; the rest it reads again from global memory in step 3.
//      Warp and block minima by redux.sync on the float's order-preserving
//      int image (a NaN below -inf for the min, above +inf for the max, so it
//      wins both); block partials; grid barrier; the partials reduced the
//      same way (min and max are exact, so the order does not matter).
//   2. With HIST alone, lo and hi come from device memory (or by value), and
//      step 3 bins the pixels as it reads them.
//   3. Each block counts its pixels into its own pos / neg histograms in
//      shared memory (2 nb int32, 64 KB at 8192 bins) with shared atomics.
//      Cluster barrier; block r of a cluster sums entries [r E / CLUSTER,
//      (r + 1) E / CLUSTER) over the cluster's blocks, reading their shared
//      memory (distributed shared memory, 16-byte loads), and adds each
//      nonzero sum to the output with one global atomic: a cluster makes the
//      global atomics of one block. The blocks zero the output before the
//      grid barrier that precedes every global atomic, so nothing is zeroed
//      before the launch and a call is one kernel, which a CUDA graph
//      captures.
// Output (int32 words): [0] lo, [1] hi (f32 bits; RANGE), [2, 2 + nb) pos,
// [2 + nb, 2 + 2 nb) neg (HIST).
//
// Limits: 2 nb entries in a block's shared memory (nb <= 29,000 on an H100;
// the wrapper refuses more before any launch).
//
// Bound at 720x1280: 921,600 f32 scores and int32 labels, 7.4 MB read, 2.2 us
// at 3.35 TB/s. The launch, the grid barrier, the cluster barriers and the
// cross-SM merge take longer than the read (PERF.md, section 6).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int CLUSTER = 8;  // blocks that share one pair of histograms
constexpr int MODE_RANGE = 1;
constexpr int MODE_HIST = 2;

#define POS_INF __int_as_float(0x7f800000)
#define NEG_INF __int_as_float(0xff800000)
#define FULL 0xffffffffu

struct Args {
  const float* scores;  // rows of w pixels, ld apart (ld == w: contiguous)
  const int* labels;    // [n], contiguous, in the scores' row-major order
  const float* lo_ptr;  // HIST alone: the range in device memory, or null and
  const float* hi_ptr;  // then lo_val / hi_val
  float lo_val, hi_val;
  int64_t n, w, ld;
  int64_t per;  // pixels a block (a multiple of 4)
  int stage;    // pixels a block stages in shared memory (RANGE | HIST)
  int nb;
  int entries;  // 2 nb rounded up to a multiple of 4 * CLUSTER
  int mode;
  int* out;       // [2 + 2 nb]
  int2* partials; // [gridDim.x]: the blocks' min and max keys
};

// min / max that return a NaN operand (fminf / fmaxf would drop it)
__device__ __forceinline__ float nan_min(float a, float b) { return (a != a || a < b) ? a : b; }
__device__ __forceinline__ float nan_max(float a, float b) { return (a != a || a > b) ? a : b; }

// 0 in-distribution, 1 OOD, 2 void
__device__ __forceinline__ unsigned label_code(int l) {
  return (l == 0 || l == 1) ? (unsigned)l : 2u;
}

// order-preserving int images of a float: a NaN below everything (min key)
// or above everything (max key)
__device__ __forceinline__ int ordered(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ int min_key(float f) { return f != f ? INT_MIN : ordered(f); }
__device__ __forceinline__ int max_key(float f) { return f != f ? INT_MAX : ordered(f); }
__device__ __forceinline__ float key_float(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);  // a NaN key gives a NaN
}

// The running range of a thread; with STAGE, the pixels below `stage` are
// also written to shared memory.
template <bool STAGE>
struct RangeOp {
  float lo, hi;
  float* ss;
  unsigned char* sl;
  int64_t stage;

  __device__ __forceinline__ void take(float s, int l) {
    if (l == 0 || l == 1) {
      lo = nan_min(lo, s);
      hi = nan_max(hi, s);
    }
  }
  __device__ __forceinline__ void operator()(int64_t i, float s, int l) {
    take(s, l);
    if (STAGE && i < stage) {
      ss[i] = s;
      sl[i] = (unsigned char)label_code(l);
    }
  }
  // four pixels from i (a multiple of 4; stage is one too)
  __device__ __forceinline__ void operator()(int64_t i, float4 s, int4 l) {
    take(s.x, l.x);
    take(s.y, l.y);
    take(s.z, l.z);
    take(s.w, l.w);
    if (STAGE && i < stage) {
      *reinterpret_cast<float4*>(ss + i) = s;
      *reinterpret_cast<unsigned*>(sl + i) = label_code(l.x) | label_code(l.y) << 8 |
                                             label_code(l.z) << 16 | label_code(l.w) << 24;
    }
  }
};

// Counts a pixel in the block's histograms.
struct BinOp {
  float lo, span, bins;
  int nb;
  int* hist;  // [pos nb | neg nb], shared memory

  __device__ __forceinline__ void add(float s, unsigned code) {
    if (code > 1u) return;
    float x = __fdiv_rn(s - lo, span) * bins;
    x = fminf(fmaxf(x, 0.f), bins);  // a NaN to 0
    const int b = min((int)x, nb - 1);
    atomicAdd(hist + (code == 1u ? 0 : nb) + b, 1);
  }
  __device__ __forceinline__ void operator()(int64_t, float s, int l) { add(s, label_code(l)); }
  __device__ __forceinline__ void operator()(int64_t, float4 s, int4 l) {
    add(s.x, label_code(l.x));
    add(s.y, label_code(l.y));
    add(s.z, label_code(l.z));
    add(s.w, label_code(l.w));
  }
};

// op(i, score, label) for the block's pixels i in [from, m) of the slice that
// starts at pixel `start` (four at a time where the map is contiguous and
// aligned).
template <typename Op>
__device__ __forceinline__ void sweep(const Args& a, int64_t start, int64_t from, int64_t m,
                                      Op& op) {
  const int tid = threadIdx.x;
  const int* gl = a.labels + start;
  if (a.ld == a.w) {
    const float* gs = a.scores + start;
    int64_t rest = from;
    if (((((uintptr_t)gs | (uintptr_t)gl) & 15) == 0) && (from & 3) == 0) {
      const int64_t units = (m - from) >> 2;
      const float4* s4 = reinterpret_cast<const float4*>(gs + from);
      const int4* l4 = reinterpret_cast<const int4*>(gl + from);
      for (int64_t u0 = 0; u0 < units; u0 += 2 * THREADS) {
        float4 s[2];
        int4 l[2];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int64_t u = u0 + k * THREADS + tid;
          if (u < units) {
            s[k] = __ldcs(s4 + u);
            l[k] = __ldcs(l4 + u);
          }
        }
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int64_t u = u0 + k * THREADS + tid;
          if (u < units) op(from + 4 * u, s[k], l[k]);
        }
      }
      rest = from + 4 * units;
    }
    for (int64_t i = rest + tid; i < m; i += THREADS) op(i, __ldcs(gs + i), __ldcs(gl + i));
  } else {  // rows of a cropped view: (r, c) stepped without a division
    const int64_t g = start + from + tid;
    int64_t r = g / a.w, c = g - r * a.w;
    const int64_t dr = THREADS / a.w, dc = THREADS % a.w;
    for (int64_t i = from + tid; i < m; i += THREADS) {
      op(i, __ldcs(a.scores + r * a.ld + c), __ldcs(gl + i));
      c += dc;
      r += dr;
      if (c >= a.w) {
        c -= a.w;
        ++r;
      }
    }
  }
}

// The block's (min key, max key) of its threads' keys, in warp 0.
__device__ __forceinline__ int2 block_keys_of(int2 k, int2* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  k.x = __reduce_min_sync(FULL, k.x);
  k.y = __reduce_max_sync(FULL, k.y);
  if (lane == 0) red[warp] = k;
  __syncthreads();
  if (warp == 0) {
    k = lane < WARPS ? red[lane] : make_int2(INT_MAX, INT_MIN);
    k.x = __reduce_min_sync(FULL, k.x);
    k.y = __reduce_max_sync(FULL, k.y);
  }
  return k;
}

__global__ void __launch_bounds__(THREADS, 1) ood_reduce_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int2 red[WARPS];
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int64_t start = (int64_t)blockIdx.x * a.per;
  const int64_t m = start < a.n ? (a.n - start < a.per ? a.n - start : a.per) : 0;
  const bool range = a.mode & MODE_RANGE, hist = a.mode & MODE_HIST;
  int* hist_local = reinterpret_cast<int*>(smem);
  float* ss = reinterpret_cast<float*>(smem + 4 * (size_t)(hist ? a.entries : 0));
  unsigned char* sl = reinterpret_cast<unsigned char*>(ss + a.stage);
  const int staged = (int)(m < a.stage ? m : a.stage);

  if (hist) {  // the block's histograms, and its share of the output's
    for (int j = tid; j < a.entries; j += THREADS) hist_local[j] = 0;
    const int e2 = 2 * a.nb;
    const int chunk = (e2 + (int)gridDim.x - 1) / (int)gridDim.x;
    const int e0 = (int)blockIdx.x * chunk, e1 = min(e0 + chunk, e2);
    for (int e = e0 + tid; e < e1; e += THREADS) a.out[2 + e] = 0;
  }
  float lo, hi;
  if (range) {
    float blo, bhi;
    if (hist) {
      RangeOp<true> op{POS_INF, NEG_INF, ss, sl, a.stage};
      sweep(a, start, 0, m, op);
      blo = op.lo;
      bhi = op.hi;
    } else {
      RangeOp<false> op{POS_INF, NEG_INF, nullptr, nullptr, 0};
      sweep(a, start, 0, m, op);
      blo = op.lo;
      bhi = op.hi;
    }
    const int2 k = block_keys_of(make_int2(min_key(blo), max_key(bhi)), red);
    if (tid == 0) a.partials[blockIdx.x] = k;
    grid.sync();
    if (!hist && blockIdx.x != 0) return;
    // one partial a thread (gridDim.x <= THREADS), then as the block's
    int2 g = tid < (int)gridDim.x ? __ldcg(a.partials + tid) : make_int2(INT_MAX, INT_MIN);
    g = block_keys_of(g, red);
    __syncthreads();  // warp 0 has read red
    if (tid == 0) red[0] = g;
    __syncthreads();
    g = red[0];
    lo = key_float(g.x);
    hi = key_float(g.y);
    if (blockIdx.x == 0 && tid == 0) {
      a.out[0] = __float_as_int(lo);
      a.out[1] = __float_as_int(hi);
    }
    if (!hist) return;
  } else {
    lo = a.lo_ptr ? *a.lo_ptr : a.lo_val;
    hi = a.hi_ptr ? *a.hi_ptr : a.hi_val;
    __syncthreads();  // the block's histograms are zero
  }

  const float d = hi - lo;
  BinOp bin{lo, d != d ? d : fmaxf(d, 1e-12f), (float)a.nb, a.nb, hist_local};
  if (range) {
    // the staged pixels from shared memory, the rest from global memory
    const float4* ss4 = reinterpret_cast<const float4*>(ss);
    const unsigned* sl4 = reinterpret_cast<const unsigned*>(sl);
#pragma unroll 4
    for (int u = tid; u < staged >> 2; u += THREADS) {
      const float4 v = ss4[u];
      const unsigned c = sl4[u];
      bin.add(v.x, c & 255u);
      bin.add(v.y, (c >> 8) & 255u);
      bin.add(v.z, (c >> 16) & 255u);
      bin.add(v.w, c >> 24);
    }
    for (int i = (staged & ~3) + tid; i < staged; i += THREADS) bin.add(ss[i], sl[i]);
    sweep(a, start, staged, m, bin);
  } else {
    sweep(a, start, 0, m, bin);
    grid.sync();  // every block has zeroed its share of the output
  }

  // the cluster's histograms summed over its blocks, by entry ranges
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every count has landed
  const int rank = (int)cluster.block_rank();
  const int share = a.entries / CLUSTER;  // a multiple of 4
  const int4* peer[CLUSTER];
#pragma unroll
  for (int q = 0; q < CLUSTER; ++q)
    peer[q] = reinterpret_cast<const int4*>(cluster.map_shared_rank(hist_local, q));
  const int e2 = 2 * a.nb;
  for (int u = tid; u < share / 4; u += THREADS) {
    const int e = rank * share + 4 * u;
    int4 sum = make_int4(0, 0, 0, 0);
#pragma unroll
    for (int q = 0; q < CLUSTER; ++q) {
      const int4 v = peer[q][rank * share / 4 + u];
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    const int add[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (add[c] != 0 && e + c < e2) atomicAdd(a.out + 2 + e + c, add[c]);
  }
  cluster.sync();  // no block leaves while a peer reads its shared memory
}

}  // namespace

// Once a device: sets the kernel's shared memory to the block maximum and
// writes the most blocks a launch may take (every one resident, a multiple of
// the cluster size), the dynamic shared memory a block may take and the
// cluster size.
extern "C" int ood_config(int* max_blocks, int* smem_bytes, int* cluster) {
  int dev = 0, smem = 0;
  cudaFuncAttributes attr;
  int rc = (int)cudaGetDevice(&dev);
  if (rc == 0) rc = (int)cudaDeviceGetAttribute(&smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (rc == 0) rc = (int)cudaFuncGetAttributes(&attr, ood_reduce_kernel);
  if (rc != 0) return rc;
  smem -= (int)attr.sharedSizeBytes;
  rc = (int)cudaFuncSetAttribute(ood_reduce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
  if (rc != 0) return rc;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = CLUSTER;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(CLUSTER);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  int clusters = 0;
  rc = (int)cudaOccupancyMaxActiveClusters(&clusters, ood_reduce_kernel, &cfg);
  if (rc != 0) return rc;
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  if (clusters * CLUSTER > THREADS) clusters = THREADS / CLUSTER;  // a partial a thread
  *max_blocks = clusters * CLUSTER;
  *smem_bytes = smem;
  *cluster = CLUSTER;
  return 0;
}

// mode: 1 range, 2 histogram over the given range, 3 both. scores: n pixels in
// rows of w, ld apart (ld == w: contiguous); labels int32 [n]. lo_ptr / hi_ptr:
// the range in device memory (mode 2), or null and then lo / hi. out: int32
// [2 + 2 nb]; scratch: 2 max_blocks words, no initial contents. max_blocks
// and smem_bytes from ood_config. One launch, no host sync.
extern "C" int ood_reduce(int mode, const void* scores, long long n, long long w, long long ld,
                          const void* labels, const void* lo_ptr, const void* hi_ptr, float lo,
                          float hi, int nb, void* out, void* scratch, int max_blocks,
                          int smem_bytes, void* stream) {
  if (mode < 1 || mode > 3 || n < 0 || w < 0 || ld < w || (ld != w && w < 1) || nb < 1 ||
      max_blocks < CLUSTER)
    return (int)cudaErrorInvalidValue;
  const bool hist = mode & MODE_HIST;
  Args a;
  a.scores = (const float*)scores;
  a.labels = (const int*)labels;
  a.lo_ptr = (const float*)lo_ptr;
  a.hi_ptr = (const float*)hi_ptr;
  a.lo_val = lo;
  a.hi_val = hi;
  a.n = n;
  a.w = w;
  a.ld = ld;
  a.nb = nb;
  a.mode = mode;
  a.entries = ((2 * nb + 4 * CLUSTER - 1) / (4 * CLUSTER)) * 4 * CLUSTER;
  const int hist_bytes = hist ? 4 * a.entries : 0;
  if (hist_bytes > smem_bytes) return (int)cudaErrorInvalidValue;
  int64_t clusters = (n + (int64_t)CLUSTER * THREADS * 4 - 1) / ((int64_t)CLUSTER * THREADS * 4);
  const int64_t most = max_blocks / CLUSTER;
  clusters = clusters < 1 ? 1 : (clusters > most ? most : clusters);
  const int blocks = (int)(clusters * CLUSTER);
  a.per = (((n + blocks - 1) / blocks) + 3) & ~(int64_t)3;
  if (a.per < 4) a.per = 4;
  const int64_t room = ((int64_t)(smem_bytes - hist_bytes) / 5) & ~(int64_t)15;
  const int64_t want = (a.per + 15) & ~(int64_t)15;  // the slice, staged whole if it fits
  a.stage = mode == 3 ? (int)(want < room ? want : room) : 0;
  a.out = (int*)out;
  a.partials = (int2*)scratch;

  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeCooperative;
  attrs[0].val.cooperative = 1;
  attrs[1].id = cudaLaunchAttributeClusterDimension;
  attrs[1].val.clusterDim.x = CLUSTER;
  attrs[1].val.clusterDim.y = 1;
  attrs[1].val.clusterDim.z = 1;
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = (size_t)hist_bytes + 5 * (size_t)a.stage;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attrs;
  cfg.numAttrs = 2;
  const int rc = (int)cudaLaunchKernelEx(&cfg, ood_reduce_kernel, a);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
