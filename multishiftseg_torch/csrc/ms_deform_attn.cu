// Multi-scale deformable attention forward for Hopper (sm_90a).
//
// Replaces the TPU-side ops of multishiftseg_tpu/ops/ms_deform_attn.py:
//   * _core_forward          (exact bilinear; grid_sample zeros padding,
//                             align_corners=False), entry msda_forward(nearest=0)
//   * _core_forward_nearest  (nearest pixel, weight zeroed outside the half-pixel
//                             border), entry msda_forward(nearest=1)
// The TPU version builds a 2x2 im2col table per level to suit the TPU's gather
// unit; here every thread reads its corners straight from value[N, S, M, D].
//
// Layouts (all contiguous):
//   value [N, S, M, D]  bf16 or f32, S = sum_l H_l * W_l
//   loc   [N, Lq, M, L, P, 2]  f32, normalised (x, y) in [0, 1]
//   attn  [N, Lq, M, L, P]     same type as value
//   out   [N, Lq, M * D]       same type as value
//
// Design: one thread per (n, q, m) and 16-byte group of channels (8 bf16 or
// 4 f32; 1 channel when D or an address does not allow it). The thread computes
// each point's corner weights once for its whole group and reads each corner as
// one 16-byte vector from value[N, S, M, D]; the four threads of one (n, q, m)
// read one contiguous 64-byte row (bf16, D = 32). Out-of-map corners are read at
// a clamped address with weight 0, so the four loads of a point issue together.
// The level loop is unrolled over MSDA_MAX_LEVELS so the level table stays in
// registers. Sums run in f32; the output is written once in the value's type.
//
// Bound at the main-path shapes (1024x2048 image: S = Lq = 43008, M = 8, D = 32,
// L = 3, P = 4, bf16): the function must read value 22 MB + loc 33 MB + attn
// 8.3 MB and write 22 MB = 85.5 MB, 25.5 us at 3.35 TB/s; its arithmetic
// (about 10 f32 operations per output element and sample point, 1.3 GFLOP) is
// 20 us at 67 TFLOP/s. So bytes bound it. The corner reads themselves
// (16.5 M rows of 64 B, about 1 GB) come from the 22 MB value table, which fits
// in the 50 MB L2, so in practice L2 bandwidth is the nearer limit.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define MSDA_MAX_LEVELS 8

struct MsdaLevels {
  int n;
  int h[MSDA_MAX_LEVELS];
  int w[MSDA_MAX_LEVELS];
  int start[MSDA_MAX_LEVELS];
};

__device__ __forceinline__ float msda_to_float(float v) { return v; }
__device__ __forceinline__ float msda_to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// V consecutive channels <-> f32 registers
template <typename T>
__device__ __forceinline__ void msda_load(const T* p, float (&v)[1]) { v[0] = msda_to_float(*p); }
__device__ __forceinline__ void msda_load(const float* p, float (&v)[4]) {
  const float4 r = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
}
__device__ __forceinline__ void msda_load(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void msda_store(float* p, const float (&v)[1]) { *p = v[0]; }
__device__ __forceinline__ void msda_store(__nv_bfloat16* p, const float (&v)[1]) {
  *p = __float2bfloat16(v[0]);
}
__device__ __forceinline__ void msda_store(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void msda_store(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 r;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = r;
}

template <typename T, int V>
__device__ __forceinline__ void msda_fma(const T* p, float w, float (&acc)[V]) {
  float v[V];
  msda_load(p, v);
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = fmaf(w, v[i], acc[i]);
}

template <typename T, int V, bool NEAREST>
__global__ void msda_forward_kernel(const T* __restrict__ value,
                                    const float* __restrict__ loc,
                                    const T* __restrict__ attn,
                                    T* __restrict__ out,
                                    int64_t total, int S, int M, int D, int Lq,
                                    int P, MsdaLevels lv) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int groups = D / V;
  const int d0 = (int)(idx % groups) * V;
  const int64_t nqm = idx / groups;      // (n * Lq + q) * M + m
  const int m = (int)(nqm % M);
  const int n = (int)(nqm / ((int64_t)M * Lq));
  const int J = lv.n * P;
  const float2* lp = reinterpret_cast<const float2*>(loc) + nqm * J;
  const T* ap = attn + nqm * J;
  const int64_t row = (int64_t)M * D;    // stride of one s in value
  const T* vb = value + (int64_t)n * S * row + (int64_t)m * D + d0;

  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;
#pragma unroll
  for (int l = 0; l < MSDA_MAX_LEVELS; ++l) {
    if (l >= lv.n) break;
    const int H = lv.h[l];
    const int W = lv.w[l];
    const T* vl = vb + (int64_t)lv.start[l] * row;
    for (int p = 0; p < P; ++p) {
      const int j = l * P + p;
      const float2 xy = __ldg(lp + j);
      const float x = xy.x * (float)W - 0.5f;
      const float y = xy.y * (float)H - 0.5f;
      const float a = msda_to_float(ap[j]);
      if (NEAREST) {
        // _core_forward_nearest: the sample counts only inside the half-pixel
        // border, at clamp(floor(x + 0.5)).
        if (x > -0.5f && x < (float)W - 0.5f && y > -0.5f && y < (float)H - 0.5f) {
          const int ix = min(max((int)floorf(x + 0.5f), 0), W - 1);
          const int iy = min(max((int)floorf(y + 0.5f), 0), H - 1);
          msda_fma<T, V>(vl + ((int64_t)iy * W + ix) * row, a, acc);
        }
      } else if (x > -1.f && x < (float)W && y > -1.f && y < (float)H) {
        // All four corners lie outside unless -1 < x < W and -1 < y < H; the
        // test also keeps the integer casts in range. An outside corner is
        // read at the clamped address with weight 0 (grid_sample's zeros).
        const float x0f = floorf(x);
        const float y0f = floorf(y);
        const int x0 = (int)x0f, y0 = (int)y0f;
        const float fx = x - x0f, fy = y - y0f;
        const float wx0 = x0 >= 0 ? 1.f - fx : 0.f;
        const float wx1 = x0 + 1 < W ? fx : 0.f;
        const float wy0 = y0 >= 0 ? a * (1.f - fy) : 0.f;
        const float wy1 = y0 + 1 < H ? a * fy : 0.f;
        const int64_t cx0 = max(x0, 0), cx1 = min(x0 + 1, W - 1);
        const int64_t ry0 = (int64_t)max(y0, 0) * W, ry1 = (int64_t)min(y0 + 1, H - 1) * W;
        msda_fma<T, V>(vl + (ry0 + cx0) * row, wy0 * wx0, acc);
        msda_fma<T, V>(vl + (ry0 + cx1) * row, wy0 * wx1, acc);
        msda_fma<T, V>(vl + (ry1 + cx0) * row, wy1 * wx0, acc);
        msda_fma<T, V>(vl + (ry1 + cx1) * row, wy1 * wx1, acc);
      }
    }
  }
  msda_store(out + nqm * D + d0, acc);
}

template <typename T, int V>
static void msda_launch(const void* value, const void* loc, const void* attn,
                        void* out, int64_t total, int S, int M, int D, int Lq,
                        int P, const MsdaLevels& lv, int nearest,
                        cudaStream_t stream) {
  const int threads = 256;
  const unsigned int blocks = (unsigned int)((total + threads - 1) / threads);
  if (nearest) {
    msda_forward_kernel<T, V, true><<<blocks, threads, 0, stream>>>(
        (const T*)value, (const float*)loc, (const T*)attn, (T*)out, total, S,
        M, D, Lq, P, lv);
  } else {
    msda_forward_kernel<T, V, false><<<blocks, threads, 0, stream>>>(
        (const T*)value, (const float*)loc, (const T*)attn, (T*)out, total, S,
        M, D, Lq, P, lv);
  }
}

// Channel groups of VEC when D and the addresses allow it, else single channels.
template <typename T, int VEC>
static int msda_dispatch(const void* value, const void* loc, const void* attn,
                         void* out, int n, int s, int m, int d, int lq,
                         int n_points, const MsdaLevels& lv, int nearest,
                         cudaStream_t st) {
  const bool vec = d % VEC == 0 && ((uintptr_t)value & 15) == 0 &&
                   ((uintptr_t)out & 15) == 0;
  const int64_t total = (int64_t)n * lq * m * (vec ? d / VEC : d);
  if (total == 0) return (int)cudaSuccess;
  if ((total + 255) / 256 > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if (vec) {
    msda_launch<T, VEC>(value, loc, attn, out, total, s, m, d, lq, n_points, lv, nearest, st);
  } else {
    msda_launch<T, 1>(value, loc, attn, out, total, s, m, d, lq, n_points, lv, nearest, st);
  }
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16. shapes_hw: host array [n_levels][2] of (H, W).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int msda_forward(const void* value, const void* loc, const void* attn,
                            void* out, int n, int s, int m, int d, int lq,
                            int n_levels, int n_points, const int* shapes_hw,
                            int dtype, int nearest, void* stream) {
  if (n_levels < 1 || n_levels > MSDA_MAX_LEVELS || n_points < 1) {
    return (int)cudaErrorInvalidValue;
  }
  MsdaLevels lv;
  lv.n = n_levels;
  int64_t start = 0;
  for (int l = 0; l < n_levels; ++l) {
    lv.h[l] = shapes_hw[2 * l];
    lv.w[l] = shapes_hw[2 * l + 1];
    lv.start[l] = (int)start;
    start += (int64_t)lv.h[l] * lv.w[l];
  }
  if (start != s) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)loc & 7) != 0) return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    return msda_dispatch<float, 4>(value, loc, attn, out, n, s, m, d, lq, n_points, lv, nearest, st);
  }
  if (dtype == 1) {
    return msda_dispatch<__nv_bfloat16, 8>(value, loc, attn, out, n, s, m, d, lq, n_points, lv, nearest, st);
  }
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Backward of the exact bilinear mode.
//
// Replaces _core_vjp_bwd (multishiftseg_tpu/ops/ms_deform_attn.py:587, with its
// _col2im / _im2col_table / _flat_row_gather helpers), which regathers 2x2 windows
// of an im2col table and scatters one corner-grad row per sample point because
// the TPU's scatter cost is per index. Here one warp owns one (n, q, m); its lanes
// own channels d = lane, lane + 32, ... For each sample point the warp recomputes
// the four bilinear corners, then
//   * d value: each in-map corner gets attn * corner weight * g[d] by atomicAdd
//     into an f32 buffer (the wrapper zeroes it first and casts it once to
//     value's type afterwards);
//   * d attn = <g, sampled value> and d loc = attn * (W, H) * <g, d sample / d
//     (x, y)>: per-lane partial sums reduced over the warp by shuffles; lane 0
//     writes them. A point with no in-map corner writes zeros.
// The location derivative is one-sided at integer pixel positions (fx == 0
// takes the right-hand slope, as grid_sample's backward does); the JAX adjoint's
// -sign(0) gives 0 there, so the two agree everywhere except on those kinks.
// Degenerate h == 1 / w == 1 levels need nothing special: the missing corner
// row or column is simply out of the map.
//
// Bound at the stage-2 shapes (16 images at 704x704: S = Lq = 10164, M = 8,
// D = 32, L = 3, P = 4, bf16): it must read value 83 MB, loc 125 MB, attn 31 MB
// and g 83 MB and write d value 83 MB, d loc 125 MB and d attn 31 MB = 562 MB,
// 0.17 ms at 3.35 TB/s. Its arithmetic needs 4 f32 operations per channel and
// in-map corner (a multiply-add of <g, corner value>, from which d attn and
// d loc follow per corner, and a multiply and an add into d value), 5.6 GFLOP
// or 0.08 ms at 67 TFLOP/s for chip_smoke.py's seeded points. So bytes bound
// it; in practice the 1.4 G f32 atomics (one per channel and in-map corner) into
// the 166 MB f32 d value buffer are the nearer limit, and a later PR would
// accumulate per block in shared memory first.

#define MSDA_BWD_MAX_CHUNKS 4  // D <= 128: up to 4 channels per lane

template <typename T>
__device__ __forceinline__ void msda_store1(T* p, float v);
template <>
__device__ __forceinline__ void msda_store1<float>(float* p, float v) { *p = v; }
template <>
__device__ __forceinline__ void msda_store1<__nv_bfloat16>(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float msda_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void msda_backward_kernel(const T* __restrict__ value,
                                     const float* __restrict__ loc,
                                     const T* __restrict__ attn,
                                     const T* __restrict__ grad_out,
                                     float* __restrict__ grad_value,
                                     float* __restrict__ grad_loc,
                                     T* __restrict__ grad_attn,
                                     int64_t total, int S, int M, int D, int Lq,
                                     int P, MsdaLevels lv) {
  const int lane = threadIdx.x & 31;
  const int64_t nqm = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (nqm >= total) return;  // uniform over the warp
  const int m = (int)(nqm % M);
  const int n = (int)(nqm / ((int64_t)M * Lq));
  const int J = lv.n * P;
  const float2* lp = reinterpret_cast<const float2*>(loc) + nqm * J;
  const T* ap = attn + nqm * J;
  const int64_t row = (int64_t)M * D;
  const int64_t base = (int64_t)n * S * row + (int64_t)m * D;
  const T* vb = value + base;
  float* gvb = grad_value + base;

  float g[MSDA_BWD_MAX_CHUNKS];
#pragma unroll
  for (int c = 0; c < MSDA_BWD_MAX_CHUNKS; ++c) {
    const int d = lane + 32 * c;
    g[c] = d < D ? msda_to_float(grad_out[nqm * D + d]) : 0.f;
  }

#pragma unroll
  for (int l = 0; l < MSDA_MAX_LEVELS; ++l) {
    if (l >= lv.n) break;
    const int H = lv.h[l];
    const int W = lv.w[l];
    const int64_t lstart = (int64_t)lv.start[l];
    for (int p = 0; p < P; ++p) {
      const int j = l * P + p;
      const float2 xy = __ldg(lp + j);
      const float x = xy.x * (float)W - 0.5f;
      const float y = xy.y * (float)H - 0.5f;
      const float a = msda_to_float(ap[j]);
      float s_attn = 0.f, s_dx = 0.f, s_dy = 0.f;
      if (x > -1.f && x < (float)W && y > -1.f && y < (float)H) {
        const float x0f = floorf(x);
        const float y0f = floorf(y);
        const int x0 = (int)x0f, y0 = (int)y0f;
        const float fx = x - x0f, fy = y - y0f;
        const bool vx0 = x0 >= 0, vx1 = x0 + 1 < W;
        const bool vy0 = y0 >= 0, vy1 = y0 + 1 < H;
        const bool v00 = vy0 && vx0, v01 = vy0 && vx1, v10 = vy1 && vx0, v11 = vy1 && vx1;
        const float w00 = (1.f - fy) * (1.f - fx), w01 = (1.f - fy) * fx;
        const float w10 = fy * (1.f - fx), w11 = fy * fx;
        const int64_t o00 = (lstart + (int64_t)y0 * W + x0) * row;
        const int64_t o01 = o00 + row;
        const int64_t o10 = o00 + (int64_t)W * row;
        const int64_t o11 = o10 + row;
#pragma unroll
        for (int c = 0; c < MSDA_BWD_MAX_CHUNKS; ++c) {
          const int d = lane + 32 * c;
          if (d < D) {
            const float c00 = v00 ? msda_to_float(vb[o00 + d]) : 0.f;
            const float c01 = v01 ? msda_to_float(vb[o01 + d]) : 0.f;
            const float c10 = v10 ? msda_to_float(vb[o10 + d]) : 0.f;
            const float c11 = v11 ? msda_to_float(vb[o11 + d]) : 0.f;
            const float gd = g[c];
            s_attn += gd * (w00 * c00 + w01 * c01 + w10 * c10 + w11 * c11);
            s_dx += gd * ((1.f - fy) * (c01 - c00) + fy * (c11 - c10));
            s_dy += gd * ((1.f - fx) * (c10 - c00) + fx * (c11 - c01));
            const float ag = a * gd;
            if (v00) atomicAdd(gvb + o00 + d, ag * w00);
            if (v01) atomicAdd(gvb + o01 + d, ag * w01);
            if (v10) atomicAdd(gvb + o10 + d, ag * w10);
            if (v11) atomicAdd(gvb + o11 + d, ag * w11);
          }
        }
      }
      s_attn = msda_warp_sum(s_attn);
      s_dx = msda_warp_sum(s_dx);
      s_dy = msda_warp_sum(s_dy);
      if (lane == 0) {
        msda_store1<T>(grad_attn + nqm * J + j, s_attn);
        grad_loc[(nqm * J + j) * 2] = a * (float)W * s_dx;
        grad_loc[(nqm * J + j) * 2 + 1] = a * (float)H * s_dy;
      }
    }
  }
}

// dtype: 0 = float32, 1 = bfloat16 (value, attn, grad_out and grad_attn); loc and
// grad_loc are float32, grad_value is a zeroed float32 [N, S, M, D] buffer.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int msda_backward(const void* value, const void* loc, const void* attn,
                             const void* grad_out, void* grad_value, void* grad_loc,
                             void* grad_attn, int n, int s, int m, int d, int lq,
                             int n_levels, int n_points, const int* shapes_hw,
                             int dtype, void* stream) {
  if (n_levels < 1 || n_levels > MSDA_MAX_LEVELS || n_points < 1 || d < 1 ||
      d > 32 * MSDA_BWD_MAX_CHUNKS) {
    return (int)cudaErrorInvalidValue;
  }
  MsdaLevels lv;
  lv.n = n_levels;
  int64_t start = 0;
  for (int l = 0; l < n_levels; ++l) {
    lv.h[l] = shapes_hw[2 * l];
    lv.w[l] = shapes_hw[2 * l + 1];
    lv.start[l] = (int)start;
    start += (int64_t)lv.h[l] * lv.w[l];
  }
  if (start != s) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)loc & 7) != 0) return (int)cudaErrorMisalignedAddress;
  const int64_t total = (int64_t)n * lq * m;
  if (total == 0) return (int)cudaSuccess;
  const int threads = 256;  // 8 warps, one (n, q, m) each
  const int64_t blocks = (total * 32 + threads - 1) / threads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    msda_backward_kernel<float><<<(unsigned int)blocks, threads, 0, st>>>(
        (const float*)value, (const float*)loc, (const float*)attn,
        (const float*)grad_out, (float*)grad_value, (float*)grad_loc,
        (float*)grad_attn, total, s, m, d, lq, n_points, lv);
  } else if (dtype == 1) {
    msda_backward_kernel<__nv_bfloat16><<<(unsigned int)blocks, threads, 0, st>>>(
        (const __nv_bfloat16*)value, (const float*)loc, (const __nv_bfloat16*)attn,
        (const __nv_bfloat16*)grad_out, (float*)grad_value, (float*)grad_loc,
        (__nv_bfloat16*)grad_attn, total, s, m, d, lq, n_points, lv);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
