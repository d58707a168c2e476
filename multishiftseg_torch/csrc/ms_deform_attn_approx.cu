// The approximate eval modes of multi-scale deformable attention for Hopper
// (sm_90a).
//
// Replaces the TPU-side ops of multishiftseg_tpu/ops/ms_deform_attn.py:
//   * _core_forward_nearest_topk           (:304-372), entry msda_forward_topk
//                                           (centroid = 0): nearest_top{T}
//   * _core_forward_nearest_topk_centroid  (:375-478), entry msda_forward_topk
//                                           (centroid = 1): nearest_top{T}c
//   * _core_forward_shared                 (:481-562), entry msda_forward_shared
// On the TPU they cut the gather's index count, which set that chip's floor;
// here they are simple kernels in the shape of msda_forward_kernel
// (csrc/ms_deform_attn.cu): one thread per (n, q, m) and group of channels.
//
// Layouts (all contiguous), as msda_forward:
//   value [N, S, M, D]  bf16 or f32, S = sum_l H_l * W_l
//   loc   [N, Lq, M, L, P, 2]  f32, normalised (x, y) in [0, 1]
//   attn  [N, Lq, M, L, P]     same type as value
//   out   [N, Lq, M * D]       same type as value
//
// The coordinate arithmetic uses __fmul_rn / __fadd_rn / __fsub_rn, so nvcc
// fuses no multiply-add into it: pixel positions, the in-map tests and the
// centroids round as in the plain versions (ops/ms_deform_attn.py), which sum
// the centroids in the same order (point by point, head by head). A nearest
// pixel is clamp(floor(x + 0.5)), x = loc * W - 0.5, and a point counts only
// inside the half-pixel border (-0.5 < x < W - 0.5).
//
// top-T: each thread of a (n, q, m) loads the head's J = L * P weights (zeroed
// outside the map, before selection) and pixels into registers and selects T
// of them by (weight descending, index ascending), the order of jax.lax.top_k:
// point j is kept when fewer than T points come before it in that order. Without
// CENTROID the kept weights are scaled by sum_all / max(sum_kept, 1e-12); with
// it they keep their exact weights, and each level adds one nearest row at the
// mass-weighted centroid of its unkept points, carrying their mass (a zero-mass
// tail parks at 0.5 with weight 0; a centroid outside the border gets weight 0).
// J <= 32 (the wrapper checks); the selection is unrolled over MAXJ = 16 or 32.
//
// shared: a block takes QPB queries. First its threads compute the J shared
// points of each query from all M heads, x_s = sum_m a x / max(sum_m a, 1e-12),
// round them to their nearest pixels and keep the pixel (or -1 outside the
// border, dropping the point for every head) in shared memory; then one thread
// per (query, head, channel group) gathers the J rows of its head's channels
// with the head's exact weights.
//
// Bound at the main-path shapes (S = Lq = 43008, M = 8, D = 32, L = 3, P = 4,
// bf16): each mode must read value 22 MB, loc 33 MB and attn 8.3 MB and write
// 22 MB, 85.5 MB, 25.5 us at 3.35 TB/s. Its arithmetic is 2 f32 operations per
// channel and gathered row plus the selection's J^2 comparisons a head, far
// below the byte time. So bytes bound it; the rows come from the 22 MB value
// table, which fits in the 50 MB L2.

#include "msda_common.cuh"

#define MSDA_THREADS 256

// The nearest pixel of normalised (nx, ny) on a W x H level: its offset in
// the level (iy * W + ix), or -1 outside the half-pixel border.
__device__ __forceinline__ int msda_nearest(float nx, float ny, int W, int H) {
  const float x = __fsub_rn(__fmul_rn(nx, (float)W), 0.5f);
  const float y = __fsub_rn(__fmul_rn(ny, (float)H), 0.5f);
  if (!(x > -0.5f && x < (float)W - 0.5f && y > -0.5f && y < (float)H - 0.5f)) return -1;
  const int ix = min(max((int)floorf(__fadd_rn(x, 0.5f)), 0), W - 1);
  const int iy = min(max((int)floorf(__fadd_rn(y, 0.5f)), 0), H - 1);
  return iy * W + ix;
}

template <typename T, int V, int MAXJ, bool CENTROID>
__global__ void msda_topk_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                                 const T* __restrict__ attn, T* __restrict__ out,
                                 int64_t total, int S, int M, int D, int Lq, int P,
                                 int top, MsdaLevels lv) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int groups = D / V;
  const int d0 = (int)(idx % groups) * V;
  const int64_t nqm = idx / groups;  // (n * Lq + q) * M + m
  const int m = (int)(nqm % M);
  const int n = (int)(nqm / ((int64_t)M * Lq));
  const int J = lv.n * P;
  const float2* lp = reinterpret_cast<const float2*>(loc) + nqm * J;
  const T* ap = attn + nqm * J;
  const int64_t row = (int64_t)M * D;
  const T* vb = value + (int64_t)n * S * row + (int64_t)m * D + d0;

  // the head's points: weight (0 outside the map) and row offset in the image
  float a[MAXJ];
  int pix[MAXJ];
  float sum_all = 0.f;
#pragma unroll
  for (int j = 0; j < MAXJ; ++j) {
    a[j] = 0.f;
    pix[j] = 0;
    if (j < J) {
      const int l = j / P;
      const float2 xy = __ldg(lp + j);
      const int o = msda_nearest(xy.x, xy.y, lv.w[l], lv.h[l]);
      if (o >= 0) {
        a[j] = msda_to_float(ap[j]);
        pix[j] = lv.start[l] + o;
      }
      sum_all += a[j];
    }
  }
  // keep j when fewer than `top` points precede it in (weight desc, index asc)
  unsigned int kept = 0u;
  float sum_kept = 0.f;
#pragma unroll
  for (int j = 0; j < MAXJ; ++j) {
    if (j < J) {
      int before = 0;
#pragma unroll
      for (int k = 0; k < MAXJ; ++k) {
        if (k < J) before += (a[k] > a[j]) || (a[k] == a[j] && k < j);
      }
      if (before < top) {
        kept |= 1u << j;
        sum_kept += a[j];
      }
    }
  }
  const float factor = CENTROID ? 1.f : __fdiv_rn(sum_all, fmaxf(sum_kept, 1e-12f));

  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;
#pragma unroll
  for (int j = 0; j < MAXJ; ++j) {
    // a kept point outside the map has weight 0: skipping it adds nothing
    if (j < J && ((kept >> j) & 1u) && a[j] != 0.f) {
      msda_fma<T, V>(vb + (int64_t)pix[j] * row, CENTROID ? a[j] : a[j] * factor, acc);
    }
  }
  if (CENTROID) {
#pragma unroll
    for (int l = 0; l < MSDA_MAX_LEVELS; ++l) {
      if (l >= lv.n) break;
      float mass = 0.f, sx = 0.f, sy = 0.f;
      for (int p = 0; p < P; ++p) {
        const int j = l * P + p;
        // a kept point adds 0 to each sum, as in the plain version; skip it
        if ((kept >> j) & 1u) continue;
        float t = 0.f;
#pragma unroll
        for (int k = 0; k < MAXJ; ++k) {
          if (k == j) t = a[k];  // a register, not a local-memory index
        }
        const float2 xy = __ldg(lp + j);
        mass = __fadd_rn(mass, t);
        sx = __fadd_rn(sx, __fmul_rn(t, xy.x));
        sy = __fadd_rn(sy, __fmul_rn(t, xy.y));
      }
      const float inv = __fdiv_rn(1.f, fmaxf(mass, 1e-12f));
      const bool safe = mass > 1e-12f;
      const float cx = safe ? __fmul_rn(sx, inv) : 0.5f;
      const float cy = safe ? __fmul_rn(sy, inv) : 0.5f;
      const int o = msda_nearest(cx, cy, lv.w[l], lv.h[l]);
      if (o >= 0 && mass != 0.f) {
        msda_fma<T, V>(vb + (int64_t)(lv.start[l] + o) * row, mass, acc);
      }
    }
  }
  msda_store(out + nqm * D + d0, acc);
}

template <typename T, int V>
__global__ void msda_shared_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                                   const T* __restrict__ attn, T* __restrict__ out,
                                   int64_t queries, int S, int M, int D, int Lq, int P,
                                   int qpb, MsdaLevels lv) {
  extern __shared__ int spix[];  // [qpb][J]: the shared point's row offset, or -1
  const int J = lv.n * P;
  const int64_t q0 = (int64_t)blockIdx.x * qpb;
  const float2* loc2 = reinterpret_cast<const float2*>(loc);
  for (int i = threadIdx.x; i < qpb * J; i += blockDim.x) {
    const int64_t nq = q0 + i / J;  // n * Lq + q
    const int j = i % J;
    int pix = -1;
    if (nq < queries) {
      float asum = 0.f, sx = 0.f, sy = 0.f;
      for (int h = 0; h < M; ++h) {
        const int64_t e = (nq * M + h) * J + j;
        const float a = msda_to_float(attn[e]);
        const float2 xy = __ldg(loc2 + e);
        asum = __fadd_rn(asum, a);
        sx = __fadd_rn(sx, __fmul_rn(xy.x, a));
        sy = __fadd_rn(sy, __fmul_rn(xy.y, a));
      }
      const float inv = __fdiv_rn(1.f, fmaxf(asum, 1e-12f));
      const int l = j / P;
      const int o = msda_nearest(__fmul_rn(sx, inv), __fmul_rn(sy, inv), lv.w[l], lv.h[l]);
      if (o >= 0) pix = lv.start[l] + o;
    }
    spix[i] = pix;
  }
  __syncthreads();

  const int groups = D / V;
  const int per_query = M * groups;
  const int ql = threadIdx.x / per_query;
  const int64_t nq = q0 + ql;
  if (ql >= qpb || nq >= queries) return;
  const int m = (threadIdx.x % per_query) / groups;
  const int d0 = (threadIdx.x % groups) * V;
  const int n = (int)(nq / Lq);
  const int64_t nqm = nq * M + m;
  const T* ap = attn + nqm * J;
  const int64_t row = (int64_t)M * D;
  const T* vb = value + (int64_t)n * S * row + (int64_t)m * D + d0;
  const int* sp = spix + ql * J;
  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;
  for (int j = 0; j < J; ++j) {
    const int pix = sp[j];
    if (pix >= 0) msda_fma<T, V>(vb + (int64_t)pix * row, msda_to_float(ap[j]), acc);
  }
  msda_store(out + nqm * D + d0, acc);
}

// Channel groups of VEC (16 bytes) when D and the addresses allow it, else 1.
static bool msda_vec_ok(const void* value, const void* out, int d, int vec) {
  return d % vec == 0 && ((uintptr_t)value & 15) == 0 && ((uintptr_t)out & 15) == 0;
}

template <typename T, int V, int MAXJ>
static void msda_topk_launch(const void* value, const void* loc, const void* attn, void* out,
                             int64_t total, int s, int m, int d, int lq, int P, int top,
                             int centroid, const MsdaLevels& lv, cudaStream_t st) {
  const unsigned int blocks = (unsigned int)((total + MSDA_THREADS - 1) / MSDA_THREADS);
  if (centroid) {
    msda_topk_kernel<T, V, MAXJ, true><<<blocks, MSDA_THREADS, 0, st>>>(
        (const T*)value, (const float*)loc, (const T*)attn, (T*)out, total, s, m, d, lq, P,
        top, lv);
  } else {
    msda_topk_kernel<T, V, MAXJ, false><<<blocks, MSDA_THREADS, 0, st>>>(
        (const T*)value, (const float*)loc, (const T*)attn, (T*)out, total, s, m, d, lq, P,
        top, lv);
  }
}

template <typename T, int V>
static void msda_topk_maxj(const void* value, const void* loc, const void* attn, void* out,
                           int64_t total, int s, int m, int d, int lq, int P, int top,
                           int centroid, const MsdaLevels& lv, cudaStream_t st) {
  if (lv.n * P <= 16) {
    msda_topk_launch<T, V, 16>(value, loc, attn, out, total, s, m, d, lq, P, top, centroid,
                               lv, st);
  } else {
    msda_topk_launch<T, V, 32>(value, loc, attn, out, total, s, m, d, lq, P, top, centroid,
                               lv, st);
  }
}

template <typename T, int VEC>
static int msda_topk_dispatch(const void* value, const void* loc, const void* attn,
                              void* out, int n, int s, int m, int d, int lq, int P, int top,
                              int centroid, const MsdaLevels& lv, cudaStream_t st) {
  const bool vec = msda_vec_ok(value, out, d, VEC);
  const int64_t total = (int64_t)n * lq * m * (vec ? d / VEC : d);
  if (total == 0) return (int)cudaSuccess;
  if ((total + MSDA_THREADS - 1) / MSDA_THREADS > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if (vec) {
    msda_topk_maxj<T, VEC>(value, loc, attn, out, total, s, m, d, lq, P, top, centroid, lv, st);
  } else {
    msda_topk_maxj<T, 1>(value, loc, attn, out, total, s, m, d, lq, P, top, centroid, lv, st);
  }
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16. shapes_hw: host array [n_levels][2] of (H, W).
// 1 <= top <= n_levels * n_points <= 32. Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int msda_forward_topk(const void* value, const void* loc, const void* attn,
                                 void* out, int n, int s, int m, int d, int lq,
                                 int n_levels, int n_points, const int* shapes_hw, int dtype,
                                 int top, int centroid, void* stream) {
  MsdaLevels lv;
  const int rc = msda_levels(&lv, n_levels, shapes_hw, s);
  if (rc != 0) return rc;
  const int J = n_levels * n_points;
  if (n_points < 1 || J > 32 || top < 1 || top > J) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)loc & 7) != 0) return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    return msda_topk_dispatch<float, 4>(value, loc, attn, out, n, s, m, d, lq, n_points, top,
                                        centroid, lv, st);
  }
  if (dtype == 1) {
    return msda_topk_dispatch<__nv_bfloat16, 8>(value, loc, attn, out, n, s, m, d, lq,
                                                n_points, top, centroid, lv, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T, int V>
static int msda_shared_launch(const void* value, const void* loc, const void* attn, void* out,
                              int n, int s, int m, int d, int lq, int P, const MsdaLevels& lv,
                              cudaStream_t st) {
  const int per_query = m * (d / V);
  if (per_query > 1024) return (int)cudaErrorInvalidValue;
  const int qpb = per_query >= MSDA_THREADS ? 1 : MSDA_THREADS / per_query;
  const int threads = qpb * per_query;
  const int64_t queries = (int64_t)n * lq;
  const int64_t blocks = (queries + qpb - 1) / qpb;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)qpb * lv.n * P * sizeof(int);
  msda_shared_kernel<T, V><<<(unsigned int)blocks, threads, smem, st>>>(
      (const T*)value, (const float*)loc, (const T*)attn, (T*)out, queries, s, m, d, lq, P,
      qpb, lv);
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16. shapes_hw: host array [n_levels][2] of (H, W).
// n_levels * n_points <= 32. Returns cudaGetLastError() after the launch.
extern "C" int msda_forward_shared(const void* value, const void* loc, const void* attn,
                                   void* out, int n, int s, int m, int d, int lq,
                                   int n_levels, int n_points, const int* shapes_hw,
                                   int dtype, void* stream) {
  MsdaLevels lv;
  const int rc = msda_levels(&lv, n_levels, shapes_hw, s);
  if (rc != 0) return rc;
  if (n_points < 1 || n_levels * n_points > 32 || m < 1 || d < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (((uintptr_t)loc & 7) != 0) return (int)cudaErrorMisalignedAddress;
  if ((int64_t)n * lq == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    return msda_vec_ok(value, out, d, 4)
               ? msda_shared_launch<float, 4>(value, loc, attn, out, n, s, m, d, lq,
                                              n_points, lv, st)
               : msda_shared_launch<float, 1>(value, loc, attn, out, n, s, m, d, lq,
                                              n_points, lv, st);
  }
  if (dtype == 1) {
    return msda_vec_ok(value, out, d, 8)
               ? msda_shared_launch<__nv_bfloat16, 8>(value, loc, attn, out, n, s, m, d, lq,
                                                      n_points, lv, st)
               : msda_shared_launch<__nv_bfloat16, 1>(value, loc, attn, out, n, s, m, d, lq,
                                                      n_points, lv, st);
  }
  return (int)cudaErrorInvalidValue;
}
