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
// All three modes run one head-major kernel, msda_fwd_kernel (below),
// templated on the value table's type (bf16 / f32, or int8 with a per-channel
// scale) and on the sampling (the four bilinear corners, or the nearest pixel).
//
// Bound at the main-path shapes (1024x2048 image: S = Lq = 43008, M = 8, D = 32,
// L = 3, P = 4, bf16): the function must read value 22 MB + loc 33 MB + attn
// 8.3 MB and write 22 MB = 85.5 MB, 25.5 us at 3.35 TB/s; its arithmetic
// (about 10 f32 operations per output element and sample point, 1.3 GFLOP) is
// 20 us at 67 TFLOP/s. So bytes bound it. The corner reads themselves
// (16.5 M rows of 64 B, about 1 GB) come from the 22 MB value table, which fits
// in the 50 MB L2, so in practice L2 bandwidth is the nearer limit.

#include <algorithm>
#include <type_traits>

#include <cooperative_groups.h>

#include "msda_common.cuh"

// ---------------------------------------------------------------------------
// The forward of all three modes (msda_forward, msda_forward_int8): head-major
// blocks that stage the coarse levels of their head in shared memory.
//
// Its HBM bound (bilinear: 0.096 ms at the training shapes, 0.026 at eval) is
// far from what limits it. Every corner of every point is one 16-byte read a
// thread (64 B a head at D = 32 in bf16) from value, which fits in the 50 MB
// L2: at the training shapes (16 images at 704x704, levels 22^2, 44^2, 88^2:
// 16 x 10,164 queries x 8 heads x 12 points x 4 corners x 64 B) some 4.0 GB of
// L2 reads, 8.0 TB/s at the 0.50 ms of a kernel with one thread per (query,
// head, 16-byte group), whose 256-thread blocks span 8 queries x 8 heads; at
// the eval shapes about 1.06 GB, 7.2 TB/s at 0.147 ms (H100, PERF.md).
// Staging the coarse levels takes most of those reads off the L2.
// Design:
//   * A block of 1024 threads serves one (image, head) and a chunk of that
//     head's queries, so its threads share the head's value planes. A query
//     keeps its channel units of V channels (GP threads, 4 at D = 32 in bf16,
//     8 in f32): 16 bytes of a bf16 / f32 table; V bytes of the int8 table,
//     whose V channels make one 16-byte store of the output.
//   * Before the query loop a bilinear or int8 block copies the head's rows
//     of the first `staged` levels (the coarsest: the model orders them so)
//     to shared memory with 16-byte cp.async pieces, 64 B a row at a 512 B
//     stride:
//     levels 0 and 1 at the training shapes (151 KB), level 0 at the eval
//     shapes (128 KB; 64 KB of int8 rows); the caller picks the count
//     (ops/ms_deform_attn.py::staged_levels). Their rows are then plain
//     shared loads; the other levels' rows come from global memory through
//     L1. This removes 2/3 of the bilinear corner reads from L2 at the
//     training shapes and 1/3 at the eval shapes.
//   * The grid is one wave of blocks (one an SM at 1024 threads), run image
//     by image: its blocks serve the (image, head) pairs of as many images as
//     keep their value tables within half the L2 (4 of the 16 at training, 4
//     chunks a pair; 1 at eval, 16 chunks), so the unstaged levels' rows stay
//     in L2; staged, the copies (blocks x staged bytes) stay under a quarter
//     of the row reads staging saves. Launches that stage nothing take the
//     same wave: against one pass of queries a block it ran 17-22% faster
//     for nearest and for single channels, as fast for f32 (H100, PERF.md).
//   * Each point's location and weight is loaded once for its group, one
//     point a thread, a query's rounds of GP points at once; shuffles over
//     the whole warp (every thread takes the same passes) hand it out.
//     Bilinear hands out (x, y, weight) and each thread of the group takes the
//     corner weights. Nearest rounds the point to its pixel in the thread
//     that loaded it (its level's W, H and first row from a table of the
//     points in shared memory; msda_nearest rounds op by op, as the plain
//     version) and hands out (row, weight): two shuffles and one row a point,
//     the coordinate arithmetic done once; a thread requests the rows of
//     MSDA_NEAR_BATCH points before it adds any. Offsets are 32-bit (one
//     image's table holds fewer than 2^31 elements), and a bf16 channel
//     becomes an f32 by a shift or a mask, an int8 one by a byte permute and
//     a subtraction (msda_unpack).
//   * The int8 table's per-channel scale multiplies each channel's sum once,
//     before the store, not every corner weight.
//   * Out-of-map corners are read at a clamped address with weight 0
//     (grid_sample's zeros); a nearest point outside the half-pixel border is
//     skipped. Sums run in f32 point by point (bilinear corners 00, 01, 10,
//     11): a staged level changes where a row is read from, not what is added.
// On the H100 (PERF.md) staging with one 512-thread block an SM ran slower
// than no staging; 32 warps a block, then the image-by-image order (the
// concurrent blocks' random points otherwise spread over all 16 images'
// tables, more than the L2 holds) made it the faster of the two for bilinear
// and the int8 table. Nearest reads one row a point, and staging level 0 ran
// no faster than none: it reads every row from global memory. What bounds the
// nearest kernel is the latency of each pass's location and weight loads
// and of its row loads, not bytes or instructions: with the row loads
// removed it still took most of its time. Prefetching the next pass's
// points (into L2, or into registers, which spill at the 64 a thread that
// 1024-thread blocks allow) and smaller blocks ran slower.

// The lanes of this thread's group of GP (a power of two dividing 32).
__device__ __forceinline__ unsigned msda_group_mask(int GP) {
  const unsigned lane = threadIdx.x & 31u;
  return GP == 32 ? 0xffffffffu : ((1u << GP) - 1u) << (lane & ~(unsigned)(GP - 1));
}

#define MSDA_FWD_THREADS 1024
#define MSDA_FWD_MAX_CHUNKS 4      // V == 1: 4 channels a thread in each channel pass
#define MSDA_FWD_ROUNDS 4          // rounds of a query's points loaded at once
#define MSDA_NEAR_BATCH 4          // nearest rows a thread requests before adding them
#define MSDA_MAX_STAGED 232448     // shared bytes a block may use (an H100's 227 KB)

// acc += w * the V channels at p
template <typename TV, int V, bool SHARED>
__device__ __forceinline__ void msda_fma_from(const TV* p, float w, float (&acc)[V]) {
  float v[V];
  msda_unpack(msda_fetch<SHARED, TV, V>(p), v);
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = fmaf(w, v[i], acc[i]);
}

// One point (nx, ny) with weight a on a W x H level whose rows lie `stride`
// elements apart from vl: the thread's channel units u0 + g + c * GP (c < CH)
// below G.
// Offsets in 32 bits: the host keeps one image's table below 2^31 elements.
template <typename TV, int V, int CH, bool SHARED>
__device__ __forceinline__ void msda_bilinear_point(const TV* vl, int stride, int H, int W,
                                                    float nx, float ny, float a, int u0,
                                                    int g, int GP, int G,
                                                    float (&acc)[CH][V]) {
  const float x = nx * (float)W - 0.5f;
  const float y = ny * (float)H - 0.5f;
  // all four corners lie outside unless -1 < x < W and -1 < y < H; the test
  // also keeps the integer casts in range
  if (!(x > -1.f && x < (float)W && y > -1.f && y < (float)H)) return;
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const int x0 = (int)x0f, y0 = (int)y0f;
  const float fx = x - x0f, fy = y - y0f;
  const float wx0 = x0 >= 0 ? 1.f - fx : 0.f;
  const float wx1 = x0 + 1 < W ? fx : 0.f;
  const float wy0 = y0 >= 0 ? a * (1.f - fy) : 0.f;
  const float wy1 = y0 + 1 < H ? a * fy : 0.f;
  const int cx0 = max(x0, 0) * stride, cx1 = min(x0 + 1, W - 1) * stride;
  const int ry0 = max(y0, 0) * W * stride, ry1 = min(y0 + 1, H - 1) * W * stride;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int u = u0 + g + c * GP;
    if (u < G) {
      const TV* p = vl + V * u;
      msda_fma_from<TV, V, SHARED>(p + ry0 + cx0, wy0 * wx0, acc[c]);
      msda_fma_from<TV, V, SHARED>(p + ry0 + cx1, wy0 * wx1, acc[c]);
      msda_fma_from<TV, V, SHARED>(p + ry1 + cx0, wy1 * wx0, acc[c]);
      msda_fma_from<TV, V, SHARED>(p + ry1 + cx1, wy1 * wx1, acc[c]);
    }
  }
}

// gridDim = (chunks, M, N); block (chunk, m, n) serves head m of image n for
// queries [chunk * q_chunk, (chunk + 1) * q_chunk). T: attn's and out's type;
// TV: the table's, T or int8_t (scale [D] given). G units of V channels a
// head, GP = 2^log2_gp threads a query (at most 32). Thread g serves units
// u0 + g + c * GP, c < CH (one unit for V > 1, MSDA_FWD_MAX_CHUNKS for
// V == 1), in channel passes u0 = 0, CH * GP, ... below G: one pass unless a
// head has more than CH * GP units (D > 256 in bf16, 128 in f32 or single
// channels). staged_rows: the rows of the first `staged` levels, staged in
// shared memory.
template <typename T, typename TV, int V, bool NEAREST>
__global__ void __launch_bounds__(MSDA_FWD_THREADS)
msda_fwd_kernel(const TV* __restrict__ value, const float* __restrict__ scale,
                const float* __restrict__ loc, const T* __restrict__ attn, T* __restrict__ out,
                int S, int M, int D, int Lq, int P, int G, int log2_gp, int q_chunk,
                int staged, int staged_rows, MsdaLevels lv) {
  constexpr int CH = V == 1 ? MSDA_FWD_MAX_CHUNKS : 1;
  extern __shared__ uint4 msda_smem[];
  TV* sv = reinterpret_cast<TV*>(msda_smem);  // [staged_rows][D]
  // nearest (which stages no rows): (W, H, first row) of each point's level
  int4* spt = reinterpret_cast<int4*>(msda_smem);
  const int m = blockIdx.y, n = blockIdx.z;
  const int64_t row = (int64_t)M * D;  // stride of one s in value
  const TV* vb = value + (int64_t)n * S * row + (int64_t)m * D;
  const int J = lv.n * P;
  if (staged_rows > 0) {  // only with 16-byte pieces of rows (the host checks)
    constexpr int E = 16 / sizeof(TV);
    const int pieces = D / E;
    for (int i = threadIdx.x; i < staged_rows * pieces; i += MSDA_FWD_THREADS) {
      const int s = i / pieces, k = i - s * pieces;
      msda_cp_async16(sv + (int64_t)s * D + k * E, vb + s * row + k * E);
    }
    msda_cp_async_wait_all();
  }
  if constexpr (NEAREST) {
    for (int j = threadIdx.x; j < J; j += MSDA_FWD_THREADS) {
      const int l = j / P;
      int4 e = make_int4(0, 0, 0, 0);
#pragma unroll
      for (int k = 0; k < MSDA_MAX_LEVELS; ++k) {
        if (k == l) e = make_int4(lv.w[k], lv.h[k], lv.start[k], 0);
      }
      spt[j] = e;
    }
  }
  __syncthreads();

  const int GP = 1 << log2_gp;
  const int g = threadIdx.x & (GP - 1);
  const int per_pass = MSDA_FWD_THREADS >> log2_gp;  // queries a block serves at once
  const int q_begin = (int)blockIdx.x * q_chunk;
  const int q_end = min(Lq, q_begin + q_chunk);
  // every thread takes the same passes, so shuffles span whole warps; a query
  // past the chunk's end repeats the last one and writes nothing
  for (int qb = q_begin; qb < q_end; qb += per_pass) {
    const int q = qb + (int)(threadIdx.x >> log2_gp);
    const int64_t nqm = ((int64_t)n * Lq + min(q, q_end - 1)) * M + m;
    const float2* lp = reinterpret_cast<const float2*>(loc) + nqm * J;
    const T* ap = attn + nqm * J;
    for (int u0 = 0; u0 < G; u0 += CH * GP) {  // channel passes, all threads alike
      float acc[CH][V];
#pragma unroll
      for (int c = 0; c < CH; ++c) {
#pragma unroll
        for (int i = 0; i < V; ++i) acc[c][i] = 0.f;
      }
      if constexpr (NEAREST) {
        // batches of MSDA_FWD_ROUNDS rounds of GP points: each thread rounds
        // its point of each round to a row in the image (-1 outside the map)
        for (int jb = 0; jb < J; jb += MSDA_FWD_ROUNDS * GP) {
          int r[MSDA_FWD_ROUNDS];
          float w[MSDA_FWD_ROUNDS];
#pragma unroll
          for (int k = 0; k < MSDA_FWD_ROUNDS; ++k) {
            const int jk = jb + k * GP + g;
            r[k] = -1;
            w[k] = 0.f;
            if (jk < J) {
              const int4 e = spt[jk];
              const float2 xy = __ldg(lp + jk);
              const int o = msda_nearest(xy.x, xy.y, e.x, e.y);
              r[k] = o < 0 ? -1 : e.z + o;
              w[k] = msda_to_float(ap[jk]);
            }
          }
#pragma unroll
          for (int k = 0; k < MSDA_FWD_ROUNDS; ++k) {
            const int j0 = jb + k * GP;
            if (j0 >= J) break;  // the same for every thread
            const int nt = min(GP, J - j0);
            // MSDA_NEAR_BATCH points at a time: their rows are all requested
            // before any is added
            for (int t0 = 0; t0 < nt; t0 += MSDA_NEAR_BATCH) {
              typename MsdaRaw<TV, V>::type raw[MSDA_NEAR_BATCH][CH];
              float ww[MSDA_NEAR_BATCH];
              bool on[MSDA_NEAR_BATCH];
#pragma unroll
              for (int b = 0; b < MSDA_NEAR_BATCH; ++b) {
                const int t = t0 + b;
                const int rr = __shfl_sync(0xffffffffu, r[k], t & (GP - 1), GP);
                ww[b] = __shfl_sync(0xffffffffu, w[k], t & (GP - 1), GP);
                on[b] = t < nt && rr >= 0;
#pragma unroll
                for (int c = 0; c < CH; ++c) {
                  const int u = u0 + g + c * GP;
                  if (on[b] && u < G) {
                    raw[b][c] = msda_fetch<false, TV, V>(vb + rr * (int)row + V * u);
                  }
                }
              }
#pragma unroll
              for (int b = 0; b < MSDA_NEAR_BATCH; ++b) {
#pragma unroll
                for (int c = 0; c < CH; ++c) {
                  if (on[b] && u0 + g + c * GP < G) {
                    float v[V];
                    msda_unpack(raw[b][c], v);
#pragma unroll
                    for (int i = 0; i < V; ++i) acc[c][i] = fmaf(ww[b], v[i], acc[c][i]);
                  }
                }
              }
            }
          }
        }
      } else {
        // the group's points, one a thread per round of GP; the rounds of a
        // batch (MSDA_FWD_ROUNDS of them) are loaded at once, round 0 is in use
        float2 xy[MSDA_FWD_ROUNDS];
        float a[MSDA_FWD_ROUNDS];
#pragma unroll
        for (int l = 0; l < MSDA_MAX_LEVELS; ++l) {
          if (l >= lv.n) break;
          const int H = lv.h[l];
          const int W = lv.w[l];
          for (int p = 0; p < P; ++p) {
            const int j = l * P + p;
            const int t = j & (GP - 1);
            if (t == 0) {
              if ((j >> log2_gp) % MSDA_FWD_ROUNDS == 0) {
#pragma unroll
                for (int k = 0; k < MSDA_FWD_ROUNDS; ++k) {
                  const int jk = j + k * GP + g;
                  xy[k] = jk < J ? __ldg(lp + jk) : make_float2(0.f, 0.f);
                  a[k] = jk < J ? msda_to_float(ap[jk]) : 0.f;
                }
              } else {
#pragma unroll
                for (int k = 0; k + 1 < MSDA_FWD_ROUNDS; ++k) {
                  xy[k] = xy[k + 1];
                  a[k] = a[k + 1];
                }
              }
            }
            const float nx = __shfl_sync(0xffffffffu, xy[0].x, t, GP);
            const float ny = __shfl_sync(0xffffffffu, xy[0].y, t, GP);
            const float w = __shfl_sync(0xffffffffu, a[0], t, GP);
            if (l < staged) {
              msda_bilinear_point<TV, V, CH, true>(sv + lv.start[l] * D, D, H, W, nx, ny, w,
                                                   u0, g, GP, G, acc);
            } else {
              msda_bilinear_point<TV, V, CH, false>(vb + (int64_t)lv.start[l] * row, (int)row,
                                                    H, W, nx, ny, w, u0, g, GP, G, acc);
            }
          }
        }
      }
      if (q < q_end) {
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          const int u = u0 + g + c * GP;
          if (u >= G) continue;
          if constexpr (std::is_same<TV, int8_t>::value) {
#pragma unroll
            for (int i = 0; i < V; ++i) acc[c][i] *= __ldg(scale + V * u + i);
          }
          msda_store(out + nqm * D + V * u, acc[c]);
        }
      }
    }
  }
}

template <typename T, typename TV, int V, bool NEAREST>
static int msda_fwd_launch(const TV* value, const float* scale, const void* loc,
                           const void* attn, void* out, int N, int S, int M, int D, int Lq,
                           int P, int staged, const MsdaLevels& lv, cudaStream_t st) {
  const int G = D / V;
  int log2_gp = 0;
  while ((1 << log2_gp) < G && log2_gp < 5) ++log2_gp;
  const int GP = 1 << log2_gp;
  if ((int64_t)S * M * D > 0x7fffffff) return (int)cudaErrorInvalidValue;  // 32-bit offsets
  // staging copies 16-byte pieces of rows
  if (staged > 0 && ((D * sizeof(TV)) % 16 != 0 || ((uintptr_t)value & 15) != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  int staged_rows = 0;
  for (int l = 0; l < staged; ++l) staged_rows += lv.h[l] * lv.w[l];
  const size_t staged_bytes = (size_t)staged_rows * D * sizeof(TV);
  const size_t smem = NEAREST ? (size_t)lv.n * P * sizeof(int4) : staged_bytes;
  if (smem > MSDA_MAX_STAGED) return (int)cudaErrorInvalidValue;
  const auto kern = msda_fwd_kernel<T, TV, V, NEAREST>;
  // this launch's shared memory, the blocks of it that an SM holds, the
  // device's SMs and L2
  int per_sm = 0, dev = 0, sms = 0, l2 = 0;
  int rc = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)smem);
  if (rc == 0) rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                                       MSDA_FWD_THREADS, smem);
  if (rc == 0) rc = (int)cudaGetDevice(&dev);
  if (rc == 0) rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == 0) rc = (int)cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, dev);
  if (rc != 0) return rc;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int64_t per_pass = MSDA_FWD_THREADS >> log2_gp;  // queries a block serves at once
  const int64_t passes = (Lq + per_pass - 1) / per_pass;
  // one wave of blocks shared by the (image, head) pairs of as many images as
  // keep their value tables within half the L2 (blocks run image by image) ...
  const double table = (double)S * M * D * sizeof(TV);
  int64_t images = (int64_t)(0.5 * l2 / table);
  images = images < 1 ? 1 : (images > N ? N : images);
  int64_t chunks = (int64_t)per_sm * sms / (images * M);
  if (staged > 0) {
    // ... whose copies (staged bytes a block) stay under a quarter of the
    // corner reads that staging saves (4 corners of each staged point)
    const double saved = (double)Lq * P * staged * 4 * D * sizeof(TV);
    const int64_t cap = (int64_t)(0.25 * saved / (double)staged_bytes);
    chunks = chunks < cap ? chunks : cap;
  }
  chunks = chunks < 1 ? 1 : (chunks > passes ? passes : chunks);
  const int64_t q_chunk = (passes + chunks - 1) / chunks * per_pass;
  chunks = (Lq + q_chunk - 1) / q_chunk;
  if (chunks > 0x7fffffff || M > 65535 || N > 65535) return (int)cudaErrorInvalidValue;
  kern<<<dim3((unsigned int)chunks, M, N), MSDA_FWD_THREADS, smem, st>>>(
      value, scale, (const float*)loc, (const T*)attn, (T*)out, S, M, D, Lq, P, G, log2_gp,
      (int)q_chunk, staged, staged_rows, lv);
  return (int)cudaGetLastError();
}

// Channel groups of VEC (16 bytes) when D and the addresses allow it, else
// single channels; staging needs the groups.
template <typename T, int VEC>
static int msda_dispatch(const void* value, const void* loc, const void* attn,
                         void* out, int n, int s, int m, int d, int lq,
                         int n_points, const MsdaLevels& lv, int nearest, int staged,
                         cudaStream_t st) {
  const bool vec = d % VEC == 0 && ((uintptr_t)value & 15) == 0 &&
                   ((uintptr_t)out & 15) == 0;
  if (staged > 0 && !vec) return (int)cudaErrorInvalidValue;
  if ((int64_t)n * lq * m == 0) return (int)cudaSuccess;
  const T* v = (const T*)value;
  if (nearest) {
    return vec ? msda_fwd_launch<T, T, VEC, true>(v, nullptr, loc, attn, out, n, s, m, d, lq,
                                                  n_points, staged, lv, st)
               : msda_fwd_launch<T, T, 1, true>(v, nullptr, loc, attn, out, n, s, m, d, lq,
                                                n_points, staged, lv, st);
  }
  return vec ? msda_fwd_launch<T, T, VEC, false>(v, nullptr, loc, attn, out, n, s, m, d, lq,
                                                 n_points, staged, lv, st)
             : msda_fwd_launch<T, T, 1, false>(v, nullptr, loc, attn, out, n, s, m, d, lq,
                                               n_points, staged, lv, st);
}

// dtype: 0 = float32, 1 = bfloat16. shapes_hw: host array [n_levels][2] of (H, W).
// staged: the levels, from the first, whose rows of a head a block stages in
// shared memory (0 .. n_levels; bilinear only; needs 16-byte channel groups
// and at most 227 KB).
// Returns the first failed CUDA call's error, else cudaGetLastError() after
// the launch (0 on success).
extern "C" int msda_forward(const void* value, const void* loc, const void* attn,
                            void* out, int n, int s, int m, int d, int lq,
                            int n_levels, int n_points, const int* shapes_hw,
                            int dtype, int nearest, int staged, void* stream) {
  if (n_points < 1 || d < 1 || staged < 0 || staged > n_levels || (nearest && staged > 0)) {
    return (int)cudaErrorInvalidValue;
  }
  MsdaLevels lv;
  const int rc = msda_levels(&lv, n_levels, shapes_hw, s);
  if (rc != 0) return rc;
  if (((uintptr_t)loc & 7) != 0) return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    return msda_dispatch<float, 4>(value, loc, attn, out, n, s, m, d, lq, n_points, lv,
                                   nearest, staged, st);
  }
  if (dtype == 1) {
    return msda_dispatch<__nv_bfloat16, 8>(value, loc, attn, out, n, s, m, d, lq, n_points,
                                           lv, nearest, staged, st);
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
// msda_quantize, one cooperative kernel (msda_quantize_kernel), grid-wide
// barrier between its two passes, every block resident at once:
//   1. Each block copies its contiguous slice of value (16-element aligned) to
//      shared memory with 16-byte cp.async pieces, as far as its share of the
//      grid's shared memory holds (two blocks an SM, 108 KB each: 29 MB on an
//      H100, the whole bf16 table at the eval shapes), and takes the
//      per-channel max |v| of the slice on the bits (non-negative floats order
//      as their bits, and a NaN's bits lie above +inf's, so the max is exact,
//      order-free and propagates a NaN, as jnp.max and torch.amax); bf16 pairs
//      take one 16x2 integer max (__vmaxu2). Every thread's pieces keep their
//      channels (the threads a pass takes are a multiple of the lanes after
//      which the channels repeat), so a thread keeps one max an element of its
//      piece; warp shuffles join lanes that own the same channels and the block
//      writes one partial [D] to the caller's scratch.
//   2. After the barrier each block reduces the partials to the scale, max |v|
//      / 127 by __fdiv_rn floored at 1e-12 (NaN kept), and writes its slice of
//      the table from shared memory (what did not fit is read again from
//      global memory, through the L2): rintf(__fdiv_rn(v, scale)) clamped to
//      +-127 (round half to even and IEEE division, as jnp.round and the plain
//      version's true division; no fast math), 0 where the quotient is NaN
//      (as XLA's float-to-int conversion), 16 int8 to a store; the quotient
//      comes from the scale's reciprocal wherever that provably rounds alike
//      (msda_q8_rcp), an IEEE division costing some ten instructions an
//      element. Block 0 writes the scale. A channel holding a NaN gets a NaN scale, so the forward's
//      outputs from it are NaN.
// It reads value once from device memory, needs no zeroed buffer and launches
// one kernel. Its barrier is cooperative groups' grid sync, so it launches by
// cudaLaunchCooperativeKernel, which a CUDA graph can capture. A pointer off
// 16-byte alignment takes single elements and nothing is staged.
// The table equals the plain version's bit for bit.
// msda_forward_int8: the forward kernel above (msda_fwd_kernel<T, int8_t, V,
// false>) reading int8 corners, V bytes a unit (8 for a bf16 output, 4 for
// f32), with the coarse levels staged as the bf16 table's (level 0 at the
// eval shapes is 64 KB of 32-byte rows) and each channel's sum multiplied by
// its scale once before the store; sums in f32, the output in attn's type.
//
// Bound at the main-path shapes (S = Lq = 43008, M = 8, D = 32, L = 3, P = 4,
// bf16): the quantize must read value 22 MB and write the 11 MB table, 33 MB,
// 9.9 us at 3.35 TB/s; the forward must read the table 11 MB, loc 33 MB and
// attn 8.3 MB and write 22 MB, 74.3 MB, 22.2 us. Both are bound by bytes.

#define MSDA_Q_THREADS 512
#define MSDA_Q_BLOCKS_PER_SM 2
#define MSDA_Q_MAX_D 256
// the bytes of value a block stages: two blocks an SM, each beside its 3 KB of
// reduction buffers (a multiple of 64: whole 16-element pieces in bf16 and f32)
#define MSDA_Q_STAGE_BYTES (108 * 1024)

__host__ __device__ __forceinline__ int msda_gcd(int a, int b) {
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// max |v| / 127 floored at 1e-12; NaN stays NaN (fmaxf would drop it)
__device__ __forceinline__ float msda_scale(unsigned int amax_bits) {
  const float s = __fdiv_rn(__uint_as_float(amax_bits), 127.f);
  return isnan(s) ? s : fmaxf(s, 1e-12f);
}

// Pass 1's pieces: 16 bytes (8 bf16 or 4 f32) whose |v| bits are max'ed into
// 4 words (bf16 two to a word, as 16-bit halves), or one element.
__device__ __forceinline__ void msda_q_absmax(uint4 r, unsigned (&acc)[4], bool bf16) {
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc[i] = bf16 ? __vmaxu2(acc[i], w[i] & 0x7fff7fffu) : max(acc[i], w[i] & 0x7fffffffu);
  }
}
template <typename T>
__device__ __forceinline__ void msda_q_absmax(T r, unsigned (&acc)[1], bool) {
  acc[0] = max(acc[0], __float_as_uint(fabsf(msda_to_float(r))));
}
// the f32 bits of the max of element j of the pieces
template <int AW>
__device__ __forceinline__ unsigned msda_q_bits(const unsigned (&acc)[AW], int j, bool bf16) {
  if constexpr (AW == 1) {
    return acc[0];
  } else {
    return bf16 ? ((acc[j >> 1] >> (16 * (j & 1))) & 0xffffu) << 16 : acc[j];
  }
}

// one table entry: rintf(v / s) clamped to +-127, 0 for NaN
__device__ __forceinline__ unsigned msda_q8_clamp(float x) {
  return isnan(x) ? 0u : (unsigned)(int)fminf(fmaxf(x, -127.f), 127.f) & 0xffu;
}
__device__ __forceinline__ unsigned msda_q8(float v, float s) {
  return msda_q8_clamp(rintf(__fdiv_rn(v, s)));
}
// The same from r = 1 / s (IEEE-rounded) where that is exact: |v / s| <= 127
// (1 + 2^-23) by the scale's choice, so v * r lies within 2^-15 of the IEEE
// quotient (the reciprocal and the product each within 2^-24 relative); where
// v * r is more than 2^-14 from a half-integer both round to the same integer.
// Nearer to one, or NaN, the quotient is taken exactly (s_at() gives s).
template <typename F>
__device__ __forceinline__ unsigned msda_q8_rcp(float v, float r, F s_at) {
  const float x = __fmul_rn(v, r);
  const float i = rintf(x);
  if (fabsf(x - i) < 0.5f - 6.103515625e-05f) return msda_q8_clamp(i);
  return msda_q8(v, s_at());
}

// 16 elements at p (16-byte aligned, shared or global memory) -> f32
__device__ __forceinline__ void msda_q_load16(const __nv_bfloat16* p, float (&v)[16]) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  float a[8], b[8];
  msda_unpack(q[0], a);
  msda_unpack(q[1], b);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    v[i] = a[i];
    v[8 + i] = b[i];
  }
}
__device__ __forceinline__ void msda_q_load16(const float* p, float (&v)[16]) {
  const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 r = q[i];
    v[4 * i] = r.x;
    v[4 * i + 1] = r.y;
    v[4 * i + 2] = r.z;
    v[4 * i + 3] = r.w;
  }
}

// Block b quantizes value[b * per_block, ...) of the total elements ([rows, D]
// flattened; per_block a multiple of 16), staging its first `stage` elements.
// VEC: value and q are 16-byte aligned; pass 1 takes 16-byte pieces (E
// elements), pass 2 pieces of 16 elements (one 16-byte store); else single
// elements in both. partials: [gridDim.x][D] scratch.
template <typename T, bool VEC>
__global__ void __launch_bounds__(MSDA_Q_THREADS, MSDA_Q_BLOCKS_PER_SM)
msda_quantize_kernel(const T* __restrict__ value, int64_t total, int D, int per_block,
                     int stage, unsigned* partials, float* __restrict__ scale,
                     int8_t* __restrict__ q) {
  constexpr bool bf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int E = VEC ? 16 / (int)sizeof(T) : 1;  // elements of a pass-1 piece
  constexpr int AW = VEC ? 4 : 1;                   // words of its max bits
  constexpr int PE = VEC ? 16 : 1;                  // elements of a pass-2 piece
  extern __shared__ uint4 msda_q_smem[];
  __shared__ unsigned smax[MSDA_Q_MAX_D];
  __shared__ unsigned red[MSDA_Q_THREADS];
  __shared__ float ssc[MSDA_Q_MAX_D];
  const T* sv = reinterpret_cast<const T*>(msda_q_smem);
  const int t = threadIdx.x;
  const int64_t start = (int64_t)blockIdx.x * per_block;
  const int64_t left = total - start;
  const int n = left <= 0 ? 0 : (left < per_block ? (int)left : per_block);
  const int ns = min(n, stage);
  const int off = (int)(start % D);  // the channel of the slice's first element
  const T* gv = value + start;
  if (t < D) smax[t] = 0u;

  // 1. thread t < A1 takes pieces t, t + A1, ...: A1 is a multiple of the p1
  // lanes after which the pieces' channels repeat
  const int p1 = D / msda_gcd(D, E);
  const int A1 = MSDA_Q_THREADS - MSDA_Q_THREADS % p1;
  const int full = n / E, staged = VEC ? ns / E : 0;  // pieces; staged ones copied
  const int in_smem = staged * E;                       // elements in shared memory
  unsigned acc[AW];
#pragma unroll
  for (int i = 0; i < AW; ++i) acc[i] = 0u;
  if (t < A1) {
    if constexpr (VEC) {
      for (int p = t; p < staged; p += A1) {
        msda_cp_async16(msda_q_smem + p, reinterpret_cast<const uint4*>(gv) + p);
      }
    }
    // the unstaged pieces from global memory while the copies land
    int p = t;
    if (p < staged) p += (staged - p + A1 - 1) / A1 * A1;
    for (; p < full; p += A1) {
      if constexpr (VEC) {
        msda_q_absmax(__ldg(reinterpret_cast<const uint4*>(gv) + p), acc, bf16);
      } else {
        msda_q_absmax(gv[p], acc, bf16);
      }
    }
    if constexpr (VEC) {
      msda_cp_async_wait_all();
      for (int p = t; p < staged; p += A1) msda_q_absmax(msda_q_smem[p], acc, bf16);
    }
  }
  __syncthreads();  // smax zeroed
  if (VEC && t < n - full * E) {  // the last block's elements past its last piece
    const int i = full * E + t;
    atomicMax(smax + (off + i) % D, __float_as_uint(fabsf(msda_to_float(gv[i]))));
  }
  unsigned bits[E];
#pragma unroll
  for (int j = 0; j < E; ++j) bits[j] = msda_q_bits(acc, j, bf16);
  const int c1 = (off + t * E) % D;
  if (32 % p1 == 0) {  // lanes p1 apart hold the same channels (and A1 is every thread)
    for (int o = p1; o < 32; o <<= 1) {
#pragma unroll
      for (int j = 0; j < E; ++j) bits[j] = max(bits[j], __shfl_xor_sync(0xffffffffu, bits[j], o));
    }
    if ((t & 31) < p1) {
#pragma unroll
      for (int j = 0; j < E; ++j) atomicMax(smax + (c1 + j) % D, bits[j]);
    }
  } else if (t < A1) {
#pragma unroll
    for (int j = 0; j < E; ++j) atomicMax(smax + (c1 + j) % D, bits[j]);
  }
  __syncthreads();
  if (t < D) partials[(int64_t)blockIdx.x * D + t] = smax[t];

  cooperative_groups::this_grid().sync();

  // 2. the scale from every block's partials (R blocks a step per channel)
  const int R = MSDA_Q_THREADS / D;
  unsigned mx = 0u;
  if (t < R * D) {  // 8 loads in flight at a time
    const unsigned* pc = partials + t % D;
    int b = t / D;
    for (; b + 7 * R < (int)gridDim.x; b += 8 * R) {
      unsigned m8[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) m8[k] = __ldcg(pc + (int64_t)(b + k * R) * D);
#pragma unroll
      for (int k = 0; k < 8; ++k) mx = max(mx, m8[k]);
    }
    for (; b < (int)gridDim.x; b += R) mx = max(mx, __ldcg(pc + (int64_t)b * D));
  }
  red[t] = mx;
  __syncthreads();
  if (t < D) {
    for (int r = 1; r < R; ++r) mx = max(mx, red[r * D + t]);
    ssc[t] = msda_scale(mx);
    if (blockIdx.x == 0) scale[t] = ssc[t];
  }
  __syncthreads();

  // the table: thread t < A2 takes pieces t, t + A2, ... of PE elements, whose
  // channels (and scales) stay its own
  const int p2 = D / msda_gcd(D, PE);
  const int A2 = MSDA_Q_THREADS - MSDA_Q_THREADS % p2;
  const int full2 = n / PE;
  if (t < A2) {
    float r[PE];  // 1 / scale of each element's channel
    const int c2 = (off + t * PE) % D;
#pragma unroll
    for (int j = 0; j < PE; ++j) r[j] = __frcp_rn(ssc[(c2 + j) % D]);
    for (int p = t; p < full2; p += A2) {
      const int e0 = p * PE;
      if constexpr (VEC) {
        float v[16];
        msda_q_load16(e0 + 16 <= in_smem ? sv + e0 : gv + e0, v);
        unsigned b[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          b[j] = msda_q8_rcp(v[j], r[j], [&] { return ssc[(c2 + j) % D]; });
        }
        uint4 o;
        unsigned* ow = reinterpret_cast<unsigned*>(&o);
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          ow[w] = b[4 * w] | b[4 * w + 1] << 8 | b[4 * w + 2] << 16 | b[4 * w + 3] << 24;
        }
        *reinterpret_cast<uint4*>(q + start + e0) = o;
      } else {
        q[start + e0] = (int8_t)msda_q8_rcp(msda_to_float(gv[e0]), r[0],
                                            [&] { return ssc[c2]; });
      }
    }
  }
  if (VEC && t < n - full2 * PE) {  // the last block's elements past its last piece
    const int i = full2 * PE + t;
    const float v = msda_to_float(i < in_smem ? sv[i] : gv[i]);
    q[start + i] = (int8_t)msda_q8(v, ssc[(off + i) % D]);
  }
}

// The most blocks msda_quantize launches on the current device (the partials
// scratch it needs is that many rows of D words); 0 on error.
extern "C" int msda_quantize_max_blocks() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  return sms * MSDA_Q_BLOCKS_PER_SM;
}

template <typename T, bool VEC>
static int msda_quantize_launch(const T* value, int8_t* q, float* scale, unsigned* partials,
                                int max_blocks, int64_t total, int D, cudaStream_t st) {
  const auto kern = msda_quantize_kernel<T, VEC>;
  int dev = 0, sms = 0;
  int rc = (int)cudaGetDevice(&dev);
  if (rc == 0) rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == 0) rc = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              VEC ? MSDA_Q_STAGE_BYTES : 0);
  if (rc != 0) return rc;
  // every block resident (the barrier): MSDA_Q_BLOCKS_PER_SM an SM, which the
  // launch bounds and the staging size guarantee (else the launch fails);
  // at least a 16-element piece a thread; within the scratch
  int64_t blocks = (total + 16 * MSDA_Q_THREADS - 1) / (16 * MSDA_Q_THREADS);
  blocks = std::min(blocks, (int64_t)MSDA_Q_BLOCKS_PER_SM * sms);
  blocks = std::max<int64_t>(1, std::min<int64_t>(blocks, max_blocks));
  const int64_t per_block = std::max<int64_t>(16, ((total + blocks - 1) / blocks + 15) / 16 * 16);
  if (per_block > 0x7fffffff - 64) return (int)cudaErrorInvalidValue;
  blocks = std::max<int64_t>(1, (total + per_block - 1) / per_block);
  int per = (int)per_block;
  int stage = VEC ? (int)std::min<int64_t>(per_block, MSDA_Q_STAGE_BYTES / sizeof(T)) : 0;
  void* args[] = {(void*)&value, (void*)&total, (void*)&D, (void*)&per, (void*)&stage,
                  (void*)&partials, (void*)&scale, (void*)&q};
  rc = (int)cudaLaunchCooperativeKernel((const void*)kern, dim3((unsigned int)blocks),
                                        dim3(MSDA_Q_THREADS), args,
                                        (size_t)stage * sizeof(T), st);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

// value [rows, D] (rows = N * S * M) f32 (dtype 0) or bf16 (1) -> q int8
// [rows, D] and the f32 scale [D]. partials: scratch of partial_blocks x D
// words (msda_quantize_max_blocks() rows), no initial contents. D <= 256.
extern "C" int msda_quantize(const void* value, void* q, void* scale, void* partials,
                             int partial_blocks, long long rows, int d, int dtype,
                             void* stream) {
  if (d < 1 || d > MSDA_Q_MAX_D || rows < 0 || partial_blocks < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t total = (int64_t)rows * d;
  const bool vec = ((uintptr_t)value & 15) == 0 && ((uintptr_t)q & 15) == 0;
  cudaStream_t st = (cudaStream_t)stream;
  unsigned* part = (unsigned*)partials;
  float* sc = (float*)scale;
  int8_t* qq = (int8_t*)q;
  if (dtype == 0) {
    const float* v = (const float*)value;
    return vec ? msda_quantize_launch<float, true>(v, qq, sc, part, partial_blocks, total, d, st)
               : msda_quantize_launch<float, false>(v, qq, sc, part, partial_blocks, total, d,
                                                    st);
  }
  if (dtype == 1) {
    const __nv_bfloat16* v = (const __nv_bfloat16*)value;
    return vec ? msda_quantize_launch<__nv_bfloat16, true>(v, qq, sc, part, partial_blocks,
                                                           total, d, st)
               : msda_quantize_launch<__nv_bfloat16, false>(v, qq, sc, part, partial_blocks,
                                                            total, d, st);
  }
  return (int)cudaErrorInvalidValue;
}

// VEC int8 channels in one VEC-byte load and VEC outputs in one 16-byte store
// when D and the addresses allow it, else single channels.
template <typename T, int VEC>
static int msda_int8_dispatch(const void* qvalue, const void* scale, const void* loc,
                              const void* attn, void* out, int n, int s, int m, int d,
                              int lq, int n_points, const MsdaLevels& lv, int staged,
                              cudaStream_t st) {
  const bool vec = d % VEC == 0 && ((uintptr_t)qvalue % VEC) == 0 &&
                   ((uintptr_t)out & 15) == 0;
  if ((int64_t)n * lq * m == 0) return (int)cudaSuccess;
  const int8_t* q = (const int8_t*)qvalue;
  const float* sc = (const float*)scale;
  return vec ? msda_fwd_launch<T, int8_t, VEC, false>(q, sc, loc, attn, out, n, s, m, d, lq,
                                                      n_points, staged, lv, st)
             : msda_fwd_launch<T, int8_t, 1, false>(q, sc, loc, attn, out, n, s, m, d, lq,
                                                    n_points, staged, lv, st);
}

// qvalue int8 [N, S, M, D] and its f32 scale [D] (msda_quantize); loc, attn and
// out as msda_forward, dtype that of attn and out (0 f32, 1 bf16); staged as
// msda_forward's (rows of D bytes: D a multiple of 16).
extern "C" int msda_forward_int8(const void* qvalue, const void* scale, const void* loc,
                                 const void* attn, void* out, int n, int s, int m, int d,
                                 int lq, int n_levels, int n_points, const int* shapes_hw,
                                 int dtype, int staged, void* stream) {
  if (n_points < 1 || d < 1 || staged < 0 || staged > n_levels) {
    return (int)cudaErrorInvalidValue;
  }
  MsdaLevels lv;
  const int rc = msda_levels(&lv, n_levels, shapes_hw, s);
  if (rc != 0) return rc;
  if (((uintptr_t)loc & 7) != 0) return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    return msda_int8_dispatch<float, 4>(qvalue, scale, loc, attn, out, n, s, m, d, lq,
                                        n_points, lv, staged, st);
  }
  if (dtype == 1) {
    return msda_int8_dispatch<__nv_bfloat16, 8>(qvalue, scale, loc, attn, out, n, s, m, d,
                                                lq, n_points, lv, staged, st);
  }
  return (int)cudaErrorInvalidValue;
}
