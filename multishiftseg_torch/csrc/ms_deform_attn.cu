// Multi-scale deformable attention forward for Hopper (sm_90a).
//
// Replaces the TPU-side ops of multishiftseg_tpu/ops/ms_deform_attn.py:
//   * _core_forward          (exact bilinear; grid_sample zeros padding,
//                             align_corners=False), entry msda_forward(nearest=0)
//   * _core_forward_nearest  (nearest pixel, weight zeroed outside the half-pixel
//                             border), entry msda_forward(nearest=1)
//   * _core_forward with quantize_table (the int8 value table), entries
//     msda_quantize and msda_forward_int8 (below the backward)
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

#include <type_traits>

#include "msda_common.cuh"

// a corner of the int8 table: the channel's scale folded into the corner weight
template <int V>
__device__ __forceinline__ void msda_fma_scaled(const int8_t* p, float w,
                                                const float (&sc)[V], float (&acc)[V]) {
  float v[V];
  msda_load(p, v);
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = fmaf(w * sc[i], v[i], acc[i]);
}

// One corner read: TV = T, or int8_t with the per-channel scale sc.
template <typename TV, int V>
__device__ __forceinline__ void msda_corner(const TV* p, float w, const float (&sc)[V],
                                            float (&acc)[V]) {
  if constexpr (std::is_same<TV, int8_t>::value) {
    msda_fma_scaled<V>(p, w, sc, acc);
  } else {
    msda_fma<TV, V>(p, w, acc);
  }
}

// TV: the value table's type, T (bf16 or f32) or int8_t (scale [D] given)
template <typename T, typename TV, int V, bool NEAREST>
__global__ void msda_forward_kernel(const TV* __restrict__ value,
                                    const float* __restrict__ scale,
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
  const TV* vb = value + (int64_t)n * S * row + (int64_t)m * D + d0;

  float acc[V];
  float sc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    acc[i] = 0.f;
    sc[i] = std::is_same<TV, int8_t>::value ? __ldg(scale + d0 + i) : 1.f;
  }
#pragma unroll
  for (int l = 0; l < MSDA_MAX_LEVELS; ++l) {
    if (l >= lv.n) break;
    const int H = lv.h[l];
    const int W = lv.w[l];
    const TV* vl = vb + (int64_t)lv.start[l] * row;
    for (int p = 0; p < P; ++p) {
      const int j = l * P + p;
      const float2 xy = __ldg(lp + j);
      const float x = xy.x * (float)W - 0.5f;
      const float y = xy.y * (float)H - 0.5f;
      const float a = msda_to_float(ap[j]);
      if (NEAREST) {
        // _core_forward_nearest: the sample counts only inside the half-pixel
        // border, at clamp(floor(x + 0.5)), its coordinates rounded op by op
        // (x and y above, which may be fused, serve bilinear only)
        const int off = msda_nearest(xy.x, xy.y, W, H);
        if (off >= 0) msda_corner<TV, V>(vl + (int64_t)off * row, a, sc, acc);
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
        msda_corner<TV, V>(vl + (ry0 + cx0) * row, wy0 * wx0, sc, acc);
        msda_corner<TV, V>(vl + (ry0 + cx1) * row, wy0 * wx1, sc, acc);
        msda_corner<TV, V>(vl + (ry1 + cx0) * row, wy1 * wx0, sc, acc);
        msda_corner<TV, V>(vl + (ry1 + cx1) * row, wy1 * wx1, sc, acc);
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
    msda_forward_kernel<T, T, V, true><<<blocks, threads, 0, stream>>>(
        (const T*)value, nullptr, (const float*)loc, (const T*)attn, (T*)out, total,
        S, M, D, Lq, P, lv);
  } else {
    msda_forward_kernel<T, T, V, false><<<blocks, threads, 0, stream>>>(
        (const T*)value, nullptr, (const float*)loc, (const T*)attn, (T*)out, total,
        S, M, D, Lq, P, lv);
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
  if (n_points < 1) return (int)cudaErrorInvalidValue;
  MsdaLevels lv;
  const int rc = msda_levels(&lv, n_levels, shapes_hw, s);
  if (rc != 0) return rc;
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
// the TPU's scatter cost is per index.
//
// Design: the forward's thread layout, with groups sized for the atomics. GP
// threads (a power of two dividing 32) own one (n, q, m); thread g of them
// owns channels 4g .. 4g + 3 (V = 4; V = 1, single channels, when D or an
// address does not allow it), so at D = 32 a head has 8 threads. For each
// sample point (its location and weight loaded one point ahead) the group
// computes the corner weights once, then each thread
//   * reads its 4 channels of each in-map corner (one 8-byte bf16 or 16-byte
//     f32 load) and takes four partial dot products <g, corner>; d attn =
//     sum_c w_c <g, c> and d loc = attn * (W, H) * the bilinear slopes of those
//     dots, reduced over the group by log2(GP) shuffle steps; thread 0 writes;
//   * adds attn * w_c * g into d value, an f32 buffer the wrapper zeroes first
//     and casts once afterwards, by one float4 atomic a corner
//     (red.global.add.v4.f32), so one atomic instruction of a group covers the
//     head's whole 128-byte f32 row: one L2 request a corner. Out-of-map
//     corners are skipped, never added at a clamped address; a point with no
//     in-map corner writes zeros.
// Why not 16-byte bf16 groups (4 threads a head, 2 float4 atomics a corner):
// each atomic instruction then covers half a row, two L2 requests a corner,
// and that layout ran slower on the card (PERF.md, PR 7).
// The location derivative is one-sided at integer pixel positions (fx == 0
// takes the right-hand slope, as grid_sample's backward does); the JAX adjoint's
// -sign(0) gives 0 there, so the two agree everywhere except on those kinks.
// Degenerate h == 1 / w == 1 levels need nothing special: the missing corner
// row or column is simply out of the map. The sums in d value run in an order
// that changes from run to run (atomics), exactly as before.
//
// Bound at the stage-2 shapes (16 images at 704x704: S = Lq = 10164, M = 8,
// D = 32, L = 3, P = 4, bf16): it must read value 83 MB, loc 125 MB, attn 31 MB
// and g 83 MB and write d value 83 MB, d loc 125 MB and d attn 31 MB = 562 MB,
// 0.17 ms at 3.35 TB/s. Its arithmetic needs 4 f32 operations per channel and
// in-map corner (a multiply-add of <g, corner value>, from which d attn and
// d loc follow per corner, and a multiply and an add into d value), 5.6 GFLOP
// or 0.08 ms at 67 TFLOP/s for chip_smoke.py's seeded points. So bytes bound
// it. The L2 is the nearer limit: about 44 M in-map (head, corner) pairs, each
// a 64-byte corner read and a 128-byte read-modify-write of f32 d value (one
// image's 10 MB stays in the 50 MB L2 while its queries run), some 8 GB of L2
// traffic; the atomics take more than half of the kernel's time.
// Staging d value in shared memory would pay only where a block's points
// share corners, which uniformly random points (chip_smoke.py) do not.

#define MSDA_BWD_MAX_CHUNKS 4  // V == 1: D <= 128, up to 4 channels a thread

template <typename T>
__device__ __forceinline__ void msda_store1(T* p, float v);
template <>
__device__ __forceinline__ void msda_store1<float>(float* p, float v) { *p = v; }
template <>
__device__ __forceinline__ void msda_store1<__nv_bfloat16>(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// <g, the V channels at p>
template <typename T, int V>
__device__ __forceinline__ float msda_dot(const T* p, const float (&g)[V]) {
  float v[V];
  msda_load(p, v);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) s = fmaf(g[i], v[i], s);
  return s;
}

// The lanes of this thread's group of GP (a power of two dividing 32).
__device__ __forceinline__ unsigned msda_group_mask(int GP) {
  const unsigned lane = threadIdx.x & 31u;
  return GP == 32 ? 0xffffffffu : ((1u << GP) - 1u) << (lane & ~(unsigned)(GP - 1));
}

// G units of V channels a head (V == 4: one unit a thread, G <= GP; V == 1:
// unit g + c * GP is chunk c of thread g).
template <typename T, int V>
__global__ void __launch_bounds__(256)
msda_backward_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                     const T* __restrict__ attn, const T* __restrict__ grad_out,
                     float* __restrict__ grad_value, float* __restrict__ grad_loc,
                     T* __restrict__ grad_attn, int heads, int S, int M, int D,
                     int Lq, int P, int G, int log2_gp, MsdaLevels lv) {
  constexpr int CH = V == 1 ? MSDA_BWD_MAX_CHUNKS : 1;
  // 32-bit index arithmetic: the launcher keeps heads * GP below 2^31
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nqm = tid >> log2_gp;  // (n * Lq + q) * M + m
  if (nqm >= heads) return;        // whole groups: GP divides the block
  const int GP = 1 << log2_gp;
  const unsigned gmask = msda_group_mask(GP);
  const int g = tid & (GP - 1);
  const int m = nqm % M;
  const int n = nqm / (M * Lq);
  const int J = lv.n * P;
  const float2* lp = reinterpret_cast<const float2*>(loc) + (int64_t)nqm * J;
  const T* ap = attn + (int64_t)nqm * J;
  const int64_t row = (int64_t)M * D;
  const int64_t base = (int64_t)n * S * row + (int64_t)m * D;
  const T* vb = value + base;
  float* gvb = grad_value + base;
  const T* gp = grad_out + (int64_t)nqm * D;

  // grad_out at this thread's channels: they are read from value and added
  // into d value
  float gl[CH][V];
  bool has[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int u = g + c * GP;
    has[c] = u < G;
    if (has[c]) {
      msda_load(gp + V * u, gl[c]);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) gl[c][i] = 0.f;
    }
  }

  // the next point's location and weight are loaded one point ahead
  float2 xy_next = __ldg(lp);
  float a_next = msda_to_float(ap[0]);
#pragma unroll
  for (int l = 0; l < MSDA_MAX_LEVELS; ++l) {
    if (l >= lv.n) break;
    const int H = lv.h[l];
    const int W = lv.w[l];
    const int64_t lstart = (int64_t)lv.start[l];
    for (int p = 0; p < P; ++p) {
      const int j = l * P + p;
      const float2 xy = xy_next;
      const float a = a_next;
      if (j + 1 < J) {
        xy_next = __ldg(lp + j + 1);
        a_next = msda_to_float(ap[j + 1]);
      }
      const float x = xy.x * (float)W - 0.5f;
      const float y = xy.y * (float)H - 0.5f;
      float s_attn = 0.f, s_dx = 0.f, s_dy = 0.f;
      if (x > -1.f && x < (float)W && y > -1.f && y < (float)H) {  // same for the group
        const float x0f = floorf(x);
        const float y0f = floorf(y);
        const int x0 = (int)x0f, y0 = (int)y0f;
        const float fx = x - x0f, fy = y - y0f;
        const bool vx0 = x0 >= 0, vx1 = x0 + 1 < W;
        const bool vy0 = y0 >= 0, vy1 = y0 + 1 < H;
        const bool vc[4] = {vy0 && vx0, vy0 && vx1, vy1 && vx0, vy1 && vx1};
        const float wc[4] = {(1.f - fy) * (1.f - fx), (1.f - fy) * fx, fy * (1.f - fx),
                             fy * fx};
        const int64_t o00 = (lstart + (int64_t)y0 * W + x0) * row;
        const int64_t oc[4] = {o00, o00 + row, o00 + (int64_t)W * row,
                               o00 + (int64_t)W * row + row};
        float dc[4] = {0.f, 0.f, 0.f, 0.f};  // <g, corner> over this thread's channels
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          if (has[c]) {
            const int d = V * (g + c * GP);
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              if (vc[k]) dc[k] += msda_dot<T, V>(vb + oc[k] + d, gl[c]);
            }
          }
        }
        s_attn = wc[0] * dc[0] + wc[1] * dc[1] + wc[2] * dc[2] + wc[3] * dc[3];
        s_dx = (1.f - fy) * (dc[1] - dc[0]) + fy * (dc[3] - dc[2]);
        s_dy = (1.f - fx) * (dc[2] - dc[0]) + fx * (dc[3] - dc[1]);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (!vc[k]) continue;
          const float s = a * wc[k];
#pragma unroll
          for (int c = 0; c < CH; ++c) {
            if (!has[c]) continue;
            float* dst = gvb + oc[k] + V * (g + c * GP);
            if constexpr (V == 4) {
              atomicAdd(reinterpret_cast<float4*>(dst),
                        make_float4(s * gl[c][0], s * gl[c][1], s * gl[c][2], s * gl[c][3]));
            } else {
              atomicAdd(dst, s * gl[c][0]);
            }
          }
        }
      }
      for (int o = GP >> 1; o > 0; o >>= 1) {
        s_attn += __shfl_xor_sync(gmask, s_attn, o);
        s_dx += __shfl_xor_sync(gmask, s_dx, o);
        s_dy += __shfl_xor_sync(gmask, s_dy, o);
      }
      if (g == 0) {
        msda_store1<T>(grad_attn + (int64_t)nqm * J + j, s_attn);
        reinterpret_cast<float2*>(grad_loc)[(int64_t)nqm * J + j] =
            make_float2(a * (float)W * s_dx, a * (float)H * s_dy);
      }
    }
  }
}

template <typename T, int V>
static int msda_backward_launch(const void* value, const void* loc, const void* attn,
                                const void* grad_out, void* grad_value, void* grad_loc,
                                void* grad_attn, int64_t heads, int S, int M, int D,
                                int Lq, int P, int G, const MsdaLevels& lv,
                                cudaStream_t st) {
  int log2_gp = 0;
  while ((1 << log2_gp) < G && log2_gp < 5) ++log2_gp;
  const int GP = 1 << log2_gp;
  if ((G + GP - 1) / GP > (V == 1 ? MSDA_BWD_MAX_CHUNKS : 1)) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  if (heads * GP > 0x7fffffffLL - threads) return (int)cudaErrorInvalidValue;
  const int blocks = (int)((heads * GP + threads - 1) / threads);
  msda_backward_kernel<T, V><<<blocks, threads, 0, st>>>(
      (const T*)value, (const float*)loc, (const T*)attn, (const T*)grad_out,
      (float*)grad_value, (float*)grad_loc, (T*)grad_attn, (int)heads, S, M, D, Lq, P, G,
      log2_gp, lv);
  return (int)cudaGetLastError();
}

// Groups of 4 channels when D and the addresses allow it, else single channels.
template <typename T>
static int msda_backward_dispatch(const void* value, const void* loc, const void* attn,
                                  const void* grad_out, void* grad_value, void* grad_loc,
                                  void* grad_attn, int64_t heads, int S, int M, int D,
                                  int Lq, int P, const MsdaLevels& lv, cudaStream_t st) {
  const bool vec = D % 4 == 0 && ((uintptr_t)value & 15) == 0 &&
                   ((uintptr_t)grad_out & 15) == 0 && ((uintptr_t)grad_value & 15) == 0;
  if (vec) {
    return msda_backward_launch<T, 4>(value, loc, attn, grad_out, grad_value, grad_loc,
                                      grad_attn, heads, S, M, D, Lq, P, D / 4, lv, st);
  }
  return msda_backward_launch<T, 1>(value, loc, attn, grad_out, grad_value, grad_loc,
                                    grad_attn, heads, S, M, D, Lq, P, D, lv, st);
}

// dtype: 0 = float32, 1 = bfloat16 (value, attn, grad_out and grad_attn); loc and
// grad_loc are float32, grad_value is a zeroed float32 [N, S, M, D] buffer.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int msda_backward(const void* value, const void* loc, const void* attn,
                             const void* grad_out, void* grad_value, void* grad_loc,
                             void* grad_attn, int n, int s, int m, int d, int lq,
                             int n_levels, int n_points, const int* shapes_hw,
                             int dtype, void* stream) {
  if (n_points < 1 || d < 1 || d > 32 * MSDA_BWD_MAX_CHUNKS) return (int)cudaErrorInvalidValue;
  MsdaLevels lv;
  const int rc = msda_levels(&lv, n_levels, shapes_hw, s);
  if (rc != 0) return rc;
  if (((uintptr_t)loc & 7) != 0 || ((uintptr_t)grad_loc & 7) != 0) {
    return (int)cudaErrorMisalignedAddress;
  }
  const int64_t heads = (int64_t)n * lq * m;
  if (heads == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    return msda_backward_dispatch<float>(value, loc, attn, grad_out, grad_value, grad_loc,
                                         grad_attn, heads, s, m, d, lq, n_points, lv, st);
  }
  if (dtype == 1) {
    return msda_backward_dispatch<__nv_bfloat16>(value, loc, attn, grad_out, grad_value,
                                                 grad_loc, grad_attn, heads, s, m, d, lq,
                                                 n_points, lv, st);
  }
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// The int8 value table of the bilinear mode (quantize_table=True).
//
// Replaces multishiftseg_tpu/ops/ms_deform_attn.py:130-139 (per-channel
// symmetric int8 quantisation of value [N, S, M, D]: scale_d = max |v| over
// (N, S, M) / 127, floored at 1e-12; q = clip(round(v / scale_d), -127, 127))
// and :221-225 (the scale folded into the corner weights of the forward).
//
// msda_quantize, two kernels:
//   1. the per-channel absolute max. A block's threads own fixed channels of
//      consecutive rows of the [N*S*M, D] view and walk the rows grid-strided;
//      the max runs on the bits of |v| (non-negative floats order as their
//      bits, and a NaN's bits above +inf's), and the block reduces its rows in
//      shared memory and issues one atomicMax a channel, so the result is exact
//      whatever the order and a NaN propagates, as in jnp.max and torch.amax.
//   2. one pass that writes the table: rintf(__fdiv_rn(v, scale)) clamped to
//      +-127 (round half to even and IEEE division, as jnp.round and the plain
//      version's true division; no fast math), 0 where the quotient is NaN (as
//      XLA's float-to-int conversion); then a small kernel writes the scale
//      over the max, after the table pass in stream order. A channel holding a
//      NaN gets a NaN scale, so the forward's outputs from it are NaN.
// The table equals the plain version's bit for bit.
// msda_forward_int8: the bilinear kernel above reading int8 corners
// (msda_forward_kernel<T, int8_t, ...>), with each channel's scale multiplied
// into the corner weight; sums in f32, the output in attn's type.
//
// Bound at the main-path shapes (S = Lq = 43008, M = 8, D = 32, L = 3, P = 4,
// bf16): the quantize must read value 22 MB and write the 11 MB table, 33 MB,
// 9.9 us at 3.35 TB/s (the max pass reads value once more, 44 MB in all); the
// forward must read the table 11 MB, loc 33 MB and attn 8.3 MB and write 22 MB,
// 74.3 MB, 22.2 us. Both are bound by bytes.

#define MSDA_Q_THREADS 256

template <typename T>
__global__ void msda_absmax_kernel(const T* __restrict__ value, int64_t rows, int D,
                                   int rows_per_step, unsigned int* __restrict__ amax) {
  __shared__ unsigned int smax[MSDA_Q_THREADS];
  const int d = threadIdx.x % D;
  const int r0 = threadIdx.x / D;
  unsigned int mx = 0u;  // the bits of max |v|
  if (r0 < rows_per_step) {
    for (int64_t r = (int64_t)blockIdx.x * rows_per_step + r0; r < rows;
         r += (int64_t)gridDim.x * rows_per_step) {
      mx = max(mx, __float_as_uint(fabsf(msda_to_float(value[r * D + d]))));
    }
  }
  smax[threadIdx.x] = mx;
  __syncthreads();
  if (threadIdx.x < D) {
    for (int k = 1; k < rows_per_step; ++k) mx = max(mx, smax[k * D + threadIdx.x]);
    atomicMax(amax + threadIdx.x, mx);
  }
}

// max |v| / 127 floored at 1e-12; NaN stays NaN (fmaxf would drop it)
__device__ __forceinline__ float msda_scale(unsigned int amax_bits) {
  const float s = __fdiv_rn(__uint_as_float(amax_bits), 127.f);
  return isnan(s) ? s : fmaxf(s, 1e-12f);
}

template <typename T>
__global__ void msda_quantize_kernel(const T* __restrict__ value, int64_t total, int D,
                                     unsigned int* __restrict__ amax_scale,
                                     int8_t* __restrict__ q) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const float s = msda_scale(amax_scale[i % D]);
  const float v = rintf(__fdiv_rn(msda_to_float(value[i]), s));
  q[i] = isnan(v) ? (int8_t)0 : (int8_t)fminf(fmaxf(v, -127.f), 127.f);
}

__global__ void msda_scale_kernel(unsigned int* __restrict__ amax_scale, int D) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d < D) amax_scale[d] = __float_as_uint(msda_scale(amax_scale[d]));
}

template <typename T>
static int msda_quantize_launch(const T* value, int8_t* q, unsigned int* scale,
                                int64_t rows, int D, cudaStream_t st) {
  const int rows_per_step = MSDA_Q_THREADS / D;
  int sms = 132;
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int64_t steps = (rows + rows_per_step - 1) / rows_per_step;
  const int blocks1 = (int)(steps < 4 * (int64_t)sms ? steps : 4 * (int64_t)sms);
  msda_absmax_kernel<T><<<blocks1, MSDA_Q_THREADS, 0, st>>>(value, rows, D, rows_per_step,
                                                           scale);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const int64_t total = rows * D;
  const int64_t blocks2 = (total + MSDA_Q_THREADS - 1) / MSDA_Q_THREADS;
  if (blocks2 > 0x7fffffff) return (int)cudaErrorInvalidValue;
  msda_quantize_kernel<T><<<(unsigned int)blocks2, MSDA_Q_THREADS, 0, st>>>(
      value, total, D, scale, q);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  // stream order: the table pass has read every max before the scale replaces it
  msda_scale_kernel<<<(D + 255) / 256, 256, 0, st>>>(scale, D);
  return (int)cudaGetLastError();
}

// value [rows, D] (rows = N * S * M) f32 (dtype 0) or bf16 (1); q int8 [rows, D];
// scale: a zeroed f32 [D] buffer, the scale on return. D <= 256.
extern "C" int msda_quantize(const void* value, void* q, void* scale, long long rows,
                             int d, int dtype, void* stream) {
  if (d < 1 || d > MSDA_Q_THREADS || rows < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    return msda_quantize_launch<float>((const float*)value, (int8_t*)q,
                                       (unsigned int*)scale, rows, d, st);
  }
  if (dtype == 1) {
    return msda_quantize_launch<__nv_bfloat16>((const __nv_bfloat16*)value, (int8_t*)q,
                                               (unsigned int*)scale, rows, d, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T, int V>
static void msda_int8_launch(const int8_t* qvalue, const float* scale, const float* loc,
                             const T* attn, T* out, int64_t total, int S, int M, int D,
                             int Lq, int P, const MsdaLevels& lv, cudaStream_t st) {
  const int threads = 256;
  const unsigned int blocks = (unsigned int)((total + threads - 1) / threads);
  msda_forward_kernel<T, int8_t, V, false><<<blocks, threads, 0, st>>>(
      qvalue, scale, loc, attn, out, total, S, M, D, Lq, P, lv);
}

template <typename T, int VEC>
static int msda_int8_dispatch(const void* qvalue, const void* scale, const void* loc,
                              const void* attn, void* out, int n, int s, int m, int d,
                              int lq, int n_points, const MsdaLevels& lv, cudaStream_t st) {
  // VEC int8 channels in one VEC-byte load, VEC outputs in one 16-byte store
  const bool vec = d % VEC == 0 && ((uintptr_t)qvalue % VEC) == 0 &&
                   ((uintptr_t)out & 15) == 0;
  const int64_t total = (int64_t)n * lq * m * (vec ? d / VEC : d);
  if (total == 0) return (int)cudaSuccess;
  if ((total + 255) / 256 > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if (vec) {
    msda_int8_launch<T, VEC>((const int8_t*)qvalue, (const float*)scale, (const float*)loc,
                             (const T*)attn, (T*)out, total, s, m, d, lq, n_points, lv, st);
  } else {
    msda_int8_launch<T, 1>((const int8_t*)qvalue, (const float*)scale, (const float*)loc,
                           (const T*)attn, (T*)out, total, s, m, d, lq, n_points, lv, st);
  }
  return (int)cudaGetLastError();
}

// qvalue int8 [N, S, M, D] and its f32 scale [D] (msda_quantize); loc, attn and
// out as msda_forward, dtype that of attn and out (0 f32, 1 bf16).
extern "C" int msda_forward_int8(const void* qvalue, const void* scale, const void* loc,
                                 const void* attn, void* out, int n, int s, int m, int d,
                                 int lq, int n_levels, int n_points, const int* shapes_hw,
                                 int dtype, void* stream) {
  if (n_points < 1) return (int)cudaErrorInvalidValue;
  MsdaLevels lv;
  const int rc = msda_levels(&lv, n_levels, shapes_hw, s);
  if (rc != 0) return rc;
  if (((uintptr_t)loc & 7) != 0) return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    return msda_int8_dispatch<float, 4>(qvalue, scale, loc, attn, out, n, s, m, d, lq,
                                        n_points, lv, st);
  }
  if (dtype == 1) {
    return msda_int8_dispatch<__nv_bfloat16, 8>(qvalue, scale, loc, attn, out, n, s, m, d,
                                                lq, n_points, lv, st);
  }
  return (int)cudaErrorInvalidValue;
}
