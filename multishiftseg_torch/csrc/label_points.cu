// Bilinear samples of one-hot label masks at points, for Hopper (sm_90a).
//
// Replaces _corner_gather_labels with sample_target_points and
// sample_class_points (multishiftseg_tpu/losses/criterion.py:66, :101, :110):
// the criterion never materialises [B, K, H, W] target masks; it samples the
// one-hot mask of a class at a point as the sum of the bilinear weights of the
// point's four corners whose label is that class. Out-of-map corners weigh 0
// (grid_sample's zeros padding, align_corners=False). Labels are data: no
// gradient.
//
// Entries:
//   label_points_classes: labels [B, H, W] int32, coords [B, P, 2] f32 (x, y) in
//     [0, 1] -> out [B, K, P] f32, every class 0..K-1 at every point.
//   label_points_rows: labels [B, H, W] int32, coords [R, P, 2], class_id [R]
//     int32 -> out [R, P] f32; row r reads label map map_offset + r / rows_per_map.
//     The JAX package repeats each label map K times (jnp.repeat,
//     criterion.py:409, :419); here the row indexes the map instead.
//
// Design: one thread per point; it computes the four corners once and reads four
// int32 labels, then writes K (or 1) outputs; neighbouring threads write
// neighbouring points, so the stores coalesce. The coordinate arithmetic uses
// explicitly rounded multiplies and adds, so no FMA contraction moves a corner
// across a pixel edge relative to the plain version.
//
// Bound at the stage-2 shapes (16 images at 704x704, K = 19, P = 12544), for
// the matcher's targets: only the corners of the label maps are read, so the
// function must read the 32-byte label sectors those corners lie in (11.6 MB
// for chip_smoke.py's seeded points, each sector once) and the coordinates
// (1.6 MB) and write the samples (15.3 MB), 8.5 us at 3.35 TB/s; the arithmetic
// (4 compares and 4 adds per point and class, 30.5 MFLOP) takes 0.5 us at
// 67 TFLOP/s. So bytes bound it.

#include <cuda_runtime.h>
#include <stdint.h>

struct LpCorners {
  int lab[4];
  float w[4];
};

__device__ __forceinline__ LpCorners lp_corners(const int* __restrict__ map, float cx,
                                                float cy, int H, int W) {
  const float x = __fsub_rn(__fmul_rn(cx, (float)W), 0.5f);
  const float y = __fsub_rn(__fmul_rn(cy, (float)H), 0.5f);
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const float wx = __fsub_rn(x, x0f);
  const float wy = __fsub_rn(y, y0f);
  // corners beyond int range lie far outside the map: clamp before the cast
  const int x0 = (int)fminf(fmaxf(x0f, -2.f), (float)W + 1.f);
  const int y0 = (int)fminf(fmaxf(y0f, -2.f), (float)H + 1.f);
  const float wxs[2] = {__fsub_rn(1.f, wx), wx};
  const float wys[2] = {__fsub_rn(1.f, wy), wy};
  LpCorners c;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int dy = k >> 1, dx = k & 1;  // JAX order: (0,0), (0,1), (1,0), (1,1)
    const int ix = x0 + dx, iy = y0 + dy;
    const bool valid = ix >= 0 && ix < W && iy >= 0 && iy < H;
    c.lab[k] = valid ? __ldg(map + (int64_t)iy * W + ix) : -1;
    c.w[k] = valid ? __fmul_rn(wxs[dx], wys[dy]) : 0.f;
  }
  return c;
}

__global__ void label_points_classes_kernel(const int* __restrict__ labels,
                                            const float* __restrict__ coords,
                                            float* __restrict__ out, int B, int H,
                                            int W, int P, int K) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)B * P) return;
  const int b = (int)(idx / P);
  const int p = (int)(idx % P);
  const float2 xy = __ldg(reinterpret_cast<const float2*>(coords) + idx);
  const LpCorners c = lp_corners(labels + (int64_t)b * H * W, xy.x, xy.y, H, W);
  float* ob = out + (int64_t)b * K * P + p;
  for (int k = 0; k < K; ++k) {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) s = __fadd_rn(s, c.lab[q] == k ? c.w[q] : 0.f);
    ob[(int64_t)k * P] = s;
  }
}

__global__ void label_points_rows_kernel(const int* __restrict__ labels,
                                         const float* __restrict__ coords,
                                         const int* __restrict__ class_id,
                                         float* __restrict__ out, int R, int H, int W,
                                         int P, int rows_per_map, int map_offset) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)R * P) return;
  const int r = (int)(idx / P);
  const int map = map_offset + r / rows_per_map;
  const float2 xy = __ldg(reinterpret_cast<const float2*>(coords) + idx);
  const LpCorners c = lp_corners(labels + (int64_t)map * H * W, xy.x, xy.y, H, W);
  const int k = __ldg(class_id + r);
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) s = __fadd_rn(s, c.lab[q] == k ? c.w[q] : 0.f);
  out[idx] = s;
}

static unsigned int lp_blocks(int64_t total, int threads) {
  return (unsigned int)((total + threads - 1) / threads);
}

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int label_points_classes(const void* labels, const void* coords, void* out,
                                    int b, int h, int w, int p, int k, void* stream) {
  if (h < 1 || w < 1 || k < 1) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)coords & 7) != 0) return (int)cudaErrorMisalignedAddress;
  const int64_t total = (int64_t)b * p;
  if (total == 0) return (int)cudaSuccess;
  const int threads = 256;
  if ((total + threads - 1) / threads > 0x7fffffff) return (int)cudaErrorInvalidValue;
  label_points_classes_kernel<<<lp_blocks(total, threads), threads, 0, (cudaStream_t)stream>>>(
      (const int*)labels, (const float*)coords, (float*)out, b, h, w, p, k);
  return (int)cudaGetLastError();
}

extern "C" int label_points_rows(const void* labels, const void* coords,
                                 const void* class_id, void* out, int r, int h, int w,
                                 int p, int rows_per_map, int map_offset, void* stream) {
  if (h < 1 || w < 1 || rows_per_map < 1 || map_offset < 0) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)coords & 7) != 0) return (int)cudaErrorMisalignedAddress;
  const int64_t total = (int64_t)r * p;
  if (total == 0) return (int)cudaSuccess;
  const int threads = 256;
  if ((total + threads - 1) / threads > 0x7fffffff) return (int)cudaErrorInvalidValue;
  label_points_rows_kernel<<<lp_blocks(total, threads), threads, 0, (cudaStream_t)stream>>>(
      (const int*)labels, (const float*)coords, (const int*)class_id, (float*)out, r, h, w,
      p, rows_per_map, map_offset);
  return (int)cudaGetLastError();
}
