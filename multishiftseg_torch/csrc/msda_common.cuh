// Device helpers shared by the deformable-attention kernels
// (csrc/ms_deform_attn.cu, csrc/ms_deform_attn_approx.cu): the level table, the
// nearest pixel of a point, the conversions of bf16 / f32 channels (and of one
// int8 channel) to f32 registers and back, and the weighted accumulation of one
// row of V channels.

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

// 16 bytes global -> shared without passing through registers; the thread
// waits with msda_cp_async_wait_all (or a group wait) before reading them
__device__ __forceinline__ void msda_cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void msda_cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ float msda_to_float(float v) { return v; }
__device__ __forceinline__ float msda_to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float msda_to_float(int8_t v) { return (float)v; }

// The raw bits of V consecutive channels of a TV table: one 16-byte load of 8
// bf16 or 4 f32, an 8-byte load of 4 bf16 or 8 int8, a 4-byte load of 4 int8,
// or one channel.
template <typename TV, int V> struct MsdaRaw { using type = TV; };  // V == 1
template <> struct MsdaRaw<float, 4> { using type = float4; };
template <> struct MsdaRaw<__nv_bfloat16, 8> { using type = uint4; };
template <> struct MsdaRaw<__nv_bfloat16, 4> { using type = uint2; };
template <> struct MsdaRaw<int8_t, 8> { using type = uint2; };
template <> struct MsdaRaw<int8_t, 4> { using type = unsigned; };

// them at p, from shared memory (SHARED) or through the read-only path
template <bool SHARED, typename TV, int V>
__device__ __forceinline__ typename MsdaRaw<TV, V>::type msda_fetch(const TV* p) {
  using R = typename MsdaRaw<TV, V>::type;
  const R* q = reinterpret_cast<const R*>(p);
  if constexpr (SHARED || V == 1) {
    return *q;
  } else {
    return __ldg(q);
  }
}

// 4 int8 channels (one word) to f32, exactly: each byte with its sign bit
// flipped (b + 128) becomes the low byte of the f32 2^23 + b + 128 by one
// byte permute, and 2^23 + 128 is subtracted. An int-to-float conversion
// issues at a quarter of the FMA rate, and bounded the int8 forward.
__device__ __forceinline__ void msda_i8x4(unsigned w, float* v) {
  const unsigned x = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[i] = __uint_as_float(__byte_perm(x, 0x4b000000u, 0x7540u + i)) - 8388736.f;
  }
}

// raw bits -> V f32 registers; a bf16 becomes an f32 by a shift or a mask
template <typename TV>
__device__ __forceinline__ void msda_unpack(TV r, float (&v)[1]) { v[0] = msda_to_float(r); }
__device__ __forceinline__ void msda_unpack(float4 r, float (&v)[4]) {
  v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
}
__device__ __forceinline__ void msda_unpack(uint4 r, float (&v)[8]) {
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void msda_unpack(uint2 r, float (&v)[4]) {  // 4 bf16
  v[0] = __uint_as_float(r.x << 16);
  v[1] = __uint_as_float(r.x & 0xffff0000u);
  v[2] = __uint_as_float(r.y << 16);
  v[3] = __uint_as_float(r.y & 0xffff0000u);
}
__device__ __forceinline__ void msda_unpack(uint2 r, float (&v)[8]) {  // 8 int8
  msda_i8x4(r.x, v);
  msda_i8x4(r.y, v + 4);
}
__device__ __forceinline__ void msda_unpack(unsigned r, float (&v)[4]) { msda_i8x4(r, v); }

// V consecutive channels at p (global memory) -> f32 registers
template <typename TV, int V>
__device__ __forceinline__ void msda_load(const TV* p, float (&v)[V]) {
  msda_unpack(msda_fetch<false, TV, V>(p), v);
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
