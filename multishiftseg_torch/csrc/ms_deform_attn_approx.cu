// The approximate eval modes of multi-scale deformable attention for Hopper
// (sm_90a).
//
// Replaces the TPU-side ops of multishiftseg_tpu/ops/ms_deform_attn.py:
//   * _core_forward_nearest_topk           (:304-372), entry msda_forward_topk
//                                           (centroid = 0): nearest_top{T}
//   * _core_forward_nearest_topk_centroid  (:375-478), entry msda_forward_topk
//                                           (centroid = 1): nearest_top{T}c
//   * _core_forward_shared                 (:481-562), entry msda_forward_shared
// On the TPU they cut the gather's index count, which set that chip's floor.
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
// top-T (msda_topk_kernel) selects once a head, in two phases a block of 256
// threads, over the heads of 256 / GP consecutive (query, head) pairs:
//   1. Selection, one lane a point: a head's J <= 32 points take a segment of
//      SW lanes (the power of two at or above J: two heads a warp at J = 12,
//      one at J = 32). Each lane loads its point, rounds it to its nearest
//      pixel (its level's W, H and first row from a table of the points in
//      shared memory) and zeroes its weight outside the map. It ranks itself
//      by J shuffles in the order of jax.lax.top_k (weight descending, then
//      index ascending: kept when fewer than T points come first), the kept
//      mask is a ballot, and a kept point's slot in the head's list is the
//      count of kept points below it. Without CENTROID the kept weights are
//      scaled by sum_all / max(sum_kept, 1e-12), both summed in point order
//      (J shuffles); with it they keep their exact weights, and lane l < L
//      takes level l's centroid of the unkept points, its mass and (x, y)
//      sums taken in point order through P shuffles each, and adds one
//      nearest row there carrying that mass (a zero-mass tail parks at 0.5
//      with weight 0; a centroid outside the border gets weight 0). The list,
//      T kept (row, weight) pairs and L centroid pairs a head, goes to shared
//      memory.
//   2. Gather: GP threads a head (4 at D = 32 in bf16, 8 in f32; 16-byte
//      channel groups, else single channels in passes) read the list by
//      broadcast and add its T + L rows (T rows without CENTROID), skipping
//      a row whose weight is 0 or that lies outside the map. A thread
//      requests the rows of MSDA_TOPK_BATCH entries before it adds any, and a
//      warp requests its next pass's points before it ranks the current
//      ones, so loads overlap.
// Every thread of a head repeating the whole selection (J^2 comparisons and J
// location loads each) costs more than the gather of half of nearest's rows.
// On the H100 (PERF.md) the selection still takes the larger part of the
// time; unrolling its loops over 16 or 32 points, and persistent blocks that
// copy each tile's points to shared memory (cp.async) while they work on the
// previous tile, ran slower.
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
#define MSDA_TOPK_THREADS 256
#define MSDA_TOPK_BATCH 4  // list entries whose rows a thread requests before adding them

// gridDim.x blocks of MSDA_TOPK_THREADS / GP heads (GP = 2^log2_gp threads a
// head in the gather, at least 4), SW = 2^log2_sw lanes a head in the
// selection. G units of V channels a head.
template <typename T, int V, bool CENTROID>
__global__ void __launch_bounds__(MSDA_TOPK_THREADS)
msda_topk_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                 const T* __restrict__ attn, T* __restrict__ out, int64_t heads, int S, int M,
                 int D, int Lq, int P, int top, int G, int log2_gp, int log2_sw,
                 MsdaLevels lv) {
  extern __shared__ int4 msda_topk_smem[];
  const int J = lv.n * P;
  const int E = top + (CENTROID ? lv.n : 0);  // rows gathered a head
  const int HB = MSDA_TOPK_THREADS >> log2_gp;
  int4* spt = msda_topk_smem;                         // [J]: W, H, first row of the level
  int2* sel = reinterpret_cast<int2*>(spt + J);       // [HB][E]: row (-1: none), weight bits
  const int64_t h0 = (int64_t)blockIdx.x * HB;
  for (int j = threadIdx.x; j < J; j += MSDA_TOPK_THREADS) {
    const int l = j / P;
    int4 e = make_int4(0, 0, 0, 0);
#pragma unroll
    for (int k = 0; k < MSDA_MAX_LEVELS; ++k) {
      if (k == l) e = make_int4(lv.w[k], lv.h[k], lv.start[k], 0);
    }
    spt[j] = e;
  }
  __syncthreads();

  // 1. selection: lane j of a segment holds point j of its head. A pass
  // takes a warp's 32 / SW heads; the next pass's points are requested
  // before this one is ranked
  const unsigned full = 0xffffffffu;
  const int SW = 1 << log2_sw;
  const int lane = threadIdx.x & 31;
  const int j = lane & (SW - 1);
  const int seg = lane >> log2_sw;
  const int per_warp = 32 >> log2_sw;
  const int step = (MSDA_TOPK_THREADS >> 5) * per_warp;
  const unsigned seg_bits = SW == 32 ? full : (1u << SW) - 1u;
  const float2* loc2 = reinterpret_cast<const float2*>(loc);
  int hl = (threadIdx.x >> 5) * per_warp + seg;
  bool live_next = hl < HB && h0 + hl < heads && j < J;
  float2 xy_next = make_float2(0.f, 0.f);
  float a_next = 0.f;
  if (live_next) {
    xy_next = __ldg(loc2 + (h0 + hl) * J + j);
    a_next = msda_to_float(attn[(h0 + hl) * J + j]);
  }
  for (; hl - seg < HB; hl += step) {  // all lanes of a warp alike
    const bool live = live_next;
    const float x = xy_next.x, y = xy_next.y;
    float a = a_next;
    const int hn = hl + step;
    live_next = hn < HB && h0 + hn < heads && j < J;
    if (live_next) {
      xy_next = __ldg(loc2 + (h0 + hn) * J + j);
      a_next = msda_to_float(attn[(h0 + hn) * J + j]);
    }
    int r = -1;
    if (live) {
      const int4 e = spt[j];
      const int o = msda_nearest(x, y, e.x, e.y);
      r = o < 0 ? -1 : e.z + o;
    }
    if (r < 0) a = 0.f;  // outside the map (or no point): weight 0 before selection
    int before = 0;      // points ahead of this one in (weight desc, index asc)
    float sum_all = 0.f;  // in point order
#pragma unroll 4
    for (int k = 0; k < J; ++k) {
      const float ak = __shfl_sync(full, a, k, SW);
      before += (ak > a) || (ak == a && k < j);
      if constexpr (!CENTROID) sum_all += ak;
    }
    const bool kept = live && before < top;
    const unsigned kmask = (__ballot_sync(full, kept) >> (seg << log2_sw)) & seg_bits;
    float w = a;
    if constexpr (!CENTROID) {
      float sum_kept = 0.f;  // in point order; an unkept point adds 0
      const float ka = kept ? a : 0.f;
#pragma unroll 4
      for (int k = 0; k < J; ++k) sum_kept += __shfl_sync(full, ka, k, SW);
      w = a * __fdiv_rn(sum_all, fmaxf(sum_kept, 1e-12f));
    }
    if (kept) {
      const int slot = __popc(kmask & ((1u << j) - 1u));
      if (slot < top) sel[hl * E + slot] = make_int2(a != 0.f ? r : -1, __float_as_int(w));
    }
    if constexpr (CENTROID) {
      // lane l < L sums level l's unkept points in point order; a kept point
      // adds 0, as in the plain version
      const float t = kept ? 0.f : a;
      const float tx = __fmul_rn(t, x), ty = __fmul_rn(t, y);
      const int l = min(j, lv.n - 1);
      float mass = 0.f, sx = 0.f, sy = 0.f;
      for (int p = 0; p < P; ++p) {
        mass = __fadd_rn(mass, __shfl_sync(full, t, l * P + p, SW));
        sx = __fadd_rn(sx, __shfl_sync(full, tx, l * P + p, SW));
        sy = __fadd_rn(sy, __shfl_sync(full, ty, l * P + p, SW));
      }
      if (live && j < lv.n) {
        const int4 e = spt[j * P];
        const float inv = __fdiv_rn(1.f, fmaxf(mass, 1e-12f));
        const bool safe = mass > 1e-12f;
        const float cx = safe ? __fmul_rn(sx, inv) : 0.5f;
        const float cy = safe ? __fmul_rn(sy, inv) : 0.5f;
        const int o = msda_nearest(cx, cy, e.x, e.y);
        sel[hl * E + top + j] =
            make_int2(o >= 0 && mass != 0.f ? e.z + o : -1, __float_as_int(mass));
      }
    }
  }
  __syncthreads();

  // 2. gather: GP threads a head, its list read by broadcast; the rows of
  // MSDA_TOPK_BATCH entries are all requested before any is added
  const int hg = threadIdx.x >> log2_gp;
  const int64_t h = h0 + hg;
  if (h >= heads) return;
  const int GP = 1 << log2_gp;
  const int m = (int)(h % M);
  const int n = (int)(h / ((int64_t)M * Lq));
  const int64_t row = (int64_t)M * D;
  const T* vb = value + (int64_t)n * S * row + (int64_t)m * D;
  const int2* list = sel + hg * E;
  for (int u = threadIdx.x & (GP - 1); u < G; u += GP) {  // channel passes
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.f;
    for (int i0 = 0; i0 < E; i0 += MSDA_TOPK_BATCH) {
      typename MsdaRaw<T, V>::type raw[MSDA_TOPK_BATCH];
      float wb[MSDA_TOPK_BATCH];
#pragma unroll
      for (int b = 0; b < MSDA_TOPK_BATCH; ++b) {
        const int2 e = i0 + b < E ? list[i0 + b] : make_int2(-1, 0);
        wb[b] = e.x < 0 ? 0.f : __int_as_float(e.y);
        if (e.x >= 0) raw[b] = msda_fetch<false, T, V>(vb + (int64_t)e.x * row + V * u);
      }
#pragma unroll
      for (int b = 0; b < MSDA_TOPK_BATCH; ++b) {
        if (wb[b] != 0.f) {  // a row outside the map, or of weight 0, adds nothing
          float v[V];
          msda_unpack(raw[b], v);
#pragma unroll
          for (int i = 0; i < V; ++i) acc[i] = fmaf(wb[b], v[i], acc[i]);
        }
      }
    }
    msda_store(out + h * D + V * u, acc);
  }
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

template <typename T, int V, bool CENTROID>
static int msda_topk_launch(const void* value, const void* loc, const void* attn, void* out,
                            int n, int s, int m, int d, int lq, int P, int top,
                            const MsdaLevels& lv, cudaStream_t st) {
  const int G = d / V;
  int log2_gp = 2;  // at least 4 threads a head: the list stays under 48 KB
  while ((1 << log2_gp) < G && log2_gp < 5) ++log2_gp;
  const int J = lv.n * P;
  int log2_sw = 0;
  while ((1 << log2_sw) < J) ++log2_sw;
  const int HB = MSDA_TOPK_THREADS >> log2_gp;
  const int E = top + (CENTROID ? lv.n : 0);
  const size_t smem = (size_t)J * sizeof(int4) + (size_t)HB * E * sizeof(int2);
  const int64_t heads = (int64_t)n * lq * m;
  const int64_t blocks = (heads + HB - 1) / HB;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  msda_topk_kernel<T, V, CENTROID><<<(unsigned int)blocks, MSDA_TOPK_THREADS, smem, st>>>(
      (const T*)value, (const float*)loc, (const T*)attn, (T*)out, heads, s, m, d, lq, P, top,
      G, log2_gp, log2_sw, lv);
  return (int)cudaGetLastError();
}

// 16-byte channel groups when D and the addresses allow it, else single channels.
template <typename T, int VEC>
static int msda_topk_dispatch(const void* value, const void* loc, const void* attn,
                              void* out, int n, int s, int m, int d, int lq, int P, int top,
                              int centroid, const MsdaLevels& lv, cudaStream_t st) {
  if ((int64_t)n * lq * m == 0) return (int)cudaSuccess;
  const bool vec = msda_vec_ok(value, out, d, VEC);
  if (centroid) {
    return vec ? msda_topk_launch<T, VEC, true>(value, loc, attn, out, n, s, m, d, lq, P, top,
                                                lv, st)
               : msda_topk_launch<T, 1, true>(value, loc, attn, out, n, s, m, d, lq, P, top,
                                              lv, st);
  }
  return vec ? msda_topk_launch<T, VEC, false>(value, loc, attn, out, n, s, m, d, lq, P, top,
                                               lv, st)
             : msda_topk_launch<T, 1, false>(value, loc, attn, out, n, s, m, d, lq, P, top,
                                             lv, st);
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
