// Device helpers shared by the deformable-attention kernels
// (csrc/ms_deform_attn.cu, csrc/ms_deform_attn_approx.cu): the level table, the
// nearest pixel of a point, the conversions of bf16 / f32 / int8 channels to f32
// registers and back, and the weighted accumulation of one row of V channels.

#pragma once

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

// The level table of shapes_hw (host array [n_levels][2] of (H, W)): each
// level's start row in value's S axis. cudaErrorInvalidValue unless
// 1 <= n_levels <= MSDA_MAX_LEVELS and the levels sum to s rows.
static inline int msda_levels(MsdaLevels* lv, int n_levels, const int* shapes_hw, int s) {
  if (n_levels < 1 || n_levels > MSDA_MAX_LEVELS) return (int)cudaErrorInvalidValue;
  lv->n = n_levels;
  int64_t start = 0;
  for (int l = 0; l < n_levels; ++l) {
    lv->h[l] = shapes_hw[2 * l];
    lv->w[l] = shapes_hw[2 * l + 1];
    lv->start[l] = (int)start;
    start += (int64_t)lv->h[l] * lv->w[l];
  }
  return start == s ? (int)cudaSuccess : (int)cudaErrorInvalidValue;
}

// The nearest pixel of normalised (nx, ny) on a W x H level: its offset in
// the level (iy * W + ix), or -1 outside the half-pixel border. x = nx * W - 0.5
// rounds the product before the subtraction (no fused multiply-add, as the
// plain versions and JAX take it): a point exactly on a pixel boundary then
// picks the same pixel on every side.
__device__ __forceinline__ int msda_nearest(float nx, float ny, int W, int H) {
  const float x = __fsub_rn(__fmul_rn(nx, (float)W), 0.5f);
  const float y = __fsub_rn(__fmul_rn(ny, (float)H), 0.5f);
  if (!(x > -0.5f && x < (float)W - 0.5f && y > -0.5f && y < (float)H - 0.5f)) return -1;
  const int ix = min(max((int)floorf(__fadd_rn(x, 0.5f)), 0), W - 1);
  const int iy = min(max((int)floorf(__fadd_rn(y, 0.5f)), 0), H - 1);
  return iy * W + ix;
}

__device__ __forceinline__ float msda_to_float(float v) { return v; }
__device__ __forceinline__ float msda_to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float msda_to_float(int8_t v) { return (float)v; }

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
// the int8 table: 8 channels as one 8-byte load (bf16 output), 4 as one
// 4-byte load (f32 output)
__device__ __forceinline__ void msda_load(const int8_t* p, float (&v)[8]) {
  const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
  const char4 a = *reinterpret_cast<const char4*>(&r.x);
  const char4 b = *reinterpret_cast<const char4*>(&r.y);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void msda_load(const int8_t* p, float (&v)[4]) {
  const int r = __ldg(reinterpret_cast<const int*>(p));
  const char4 a = *reinterpret_cast<const char4*>(&r);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
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
