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
// shared (msda_shared_kernel): one warp a query at a time; persistent blocks
// of MSDA_SH_WARPS warps, as many as the SMs hold.
//   1. The warp copies a query's M * J locations and weights (768 B of loc and
//      192 B of bf16 attn at M = 8, J = 12) to shared memory in 16-byte
//      cp.async pieces (2-byte loads for the edges of a block that is not
//      16-byte aligned), one query ahead: the next query's points land while
//      the warp gathers this one's rows. attn is read from global memory
//      once. Lane j < J sums point j's centroid over the heads in head order,
//      x_s = sum_m a x / max(sum_m a, 1e-12) (each step __fadd_rn /
//      __fmul_rn, one division, as the plain version), and rounds it to its
//      nearest pixel; a ballot compacts the in-map points, in point order,
//      into a list of (row, point) in shared memory. A point outside the
//      border drops for every head: it is not in the list, so no lane
//      branches around a load.
//   2. Gather: the query's row is M * D channels (512 B in bf16 at D = 32),
//      one 16-byte unit a lane (units of V channels of one head; passes of 32
//      units when a row holds more, as in f32 or single channels). A lane
//      requests MSDA_SH_BATCH list rows before it adds any, each with its
//      head's exact weight from the staged attn.
//   What bounds it is latency: a query's two dependent steps (its points,
//   then its rows). On the H100 (PERF.md) copying the points a query ahead
//   beat copying them on demand; 4 rows a batch beat 2, 3, 5, 6, 8 or 12 (12
//   spills); 16 warps a block at 64 registers (two blocks an SM) beat 4 or 8
//   warps at 64 or 80.
//
// Bound at the main-path shapes (S = Lq = 43008, M = 8, D = 32, L = 3, P = 4,
// bf16): each mode must read value 22 MB, loc 33 MB and attn 8.3 MB and write
// 22 MB, 85.5 MB, 25.5 us at 3.35 TB/s. Its arithmetic is 2 f32 operations per
// channel and gathered row plus the selection's J^2 comparisons a head, far
// below the byte time. So bytes bound it; the rows come from the 22 MB value
// table, which fits in the 50 MB L2. shared gathers 12 rows of 512 B a query,
// about 264 MB of L2 reads a call: at the L2's rate that is the nearer floor.

#include "msda_common.cuh"

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

// shared: one warp a query (see the file's head), its shape chosen on the
// H100 (PERF.md).
#define MSDA_SH_WARPS 16      // queries a block
#define MSDA_SH_BATCH 4       // rows a lane requests before it adds any
#define MSDA_SH_MIN_BLOCKS 2  // blocks an SM must hold (caps the registers)
#define MSDA_SH_THREADS (32 * MSDA_SH_WARPS)
#define MSDA_SH_LIST_BYTES (32 * 8)  // a warp's list of in-map points: J <= 32 int2
#define MSDA_SH_SMEM 232448           // shared bytes a block may use (an H100's 227 KB)

// The warp copies nbytes (even) at src (2-byte aligned) to shared memory at
// dst + (src & 15), so that src's 16-byte-aligned pieces land on 16-byte
// boundaries; dst is 16-byte aligned with 16 bytes to spare. The aligned body
// moves in 16-byte cp.async pieces (the caller waits for them), the up to 14
// bytes before and after it in 2-byte loads.
__device__ __forceinline__ void msda_warp_copy(char* dst, const char* src, int nbytes,
                                               int lane) {
  const int shift = (int)((uintptr_t)src & 15);
  char* d = dst + shift;
  const int head = min(nbytes, (16 - shift) & 15);
  const int body = (nbytes - head) & ~15;
  for (int i = lane; i < (nbytes - body) >> 1; i += 32) {  // the 2-byte edges
    const int b = 2 * i < head ? 2 * i : 2 * i + body;
    *reinterpret_cast<unsigned short*>(d + b) =
        __ldg(reinterpret_cast<const unsigned short*>(src + b));
  }
  const uint4* s4 = reinterpret_cast<const uint4*>(src + head);
  uint4* d4 = reinterpret_cast<uint4*>(d + head);
  for (int i = lane; i < (body >> 4); i += 32) msda_cp_async16(d4 + i, s4 + i);
}

// Warp w of block b serves queries b * MSDA_SH_WARPS + w, then every
// gridDim.x * MSDA_SH_WARPS further on. STAGED (persistent blocks): a query's
// loc [M][J] float2 and attn [M][J] are copied to one of the warp's two pairs
// of shared buffers (loc_buf and attn_buf bytes) while the warp gathers the
// previous query's rows, and read from there; else (only when they do not
// fit: one query a warp) read from global memory. G units of V channels a
// head; lane u of a pass serves unit u of the query's M * G.
template <typename T, int V, bool STAGED>
__global__ void __launch_bounds__(MSDA_SH_THREADS, MSDA_SH_MIN_BLOCKS)
msda_shared_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                   const T* __restrict__ attn, T* __restrict__ out, int64_t queries, int S,
                   int M, int D, int Lq, int P, int loc_buf, int attn_buf, int warp_bytes,
                   MsdaLevels lv) {
  extern __shared__ uint4 msda_sh_smem[];
  const int J = lv.n * P;
  const int lane = threadIdx.x & 31;
  const int MG = M * (D / V);
  const int G = D / V;
  const int64_t row = (int64_t)M * D;
  const int loc_bytes = M * J * 8, attn_bytes = M * J * (int)sizeof(T);
  char* wbase = reinterpret_cast<char*>(msda_sh_smem) + (threadIdx.x >> 5) * warp_bytes;
  int2* list = reinterpret_cast<int2*>(wbase);  // [K]: (row, point) of the in-map points
  char* bufs = wbase + MSDA_SH_LIST_BYTES;      // 2 x (loc_buf + attn_buf)
  const char* lsrc = reinterpret_cast<const char*>(loc);
  const char* asrc = reinterpret_cast<const char*>(attn);
  // this lane's point: its level's W, H and first row
  int lw = 0, lh = 0, lstart = 0;
  if (lane < J) {
    const int l = lane / P;
#pragma unroll
    for (int k = 0; k < MSDA_MAX_LEVELS; ++k) {
      if (k == l) {
        lw = lv.w[k];
        lh = lv.h[k];
        lstart = lv.start[k];
      }
    }
  }
  const int64_t stride = (int64_t)gridDim.x * MSDA_SH_WARPS;
  int64_t nq = (int64_t)blockIdx.x * MSDA_SH_WARPS + (threadIdx.x >> 5);  // n * Lq + q
  if constexpr (STAGED) {
    if (nq < queries) {
      msda_warp_copy(bufs, lsrc + nq * loc_bytes, loc_bytes, lane);
      msda_warp_copy(bufs + loc_buf, asrc + nq * attn_bytes, attn_bytes, lane);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int k = 0; nq < queries; nq += stride, ++k) {
    const char* lq_src = lsrc + nq * loc_bytes;
    const char* aq_src = asrc + nq * attn_bytes;
    const float2* lp = reinterpret_cast<const float2*>(lq_src);
    const T* ap = reinterpret_cast<const T*>(aq_src);
    if constexpr (STAGED) {
      char* lb = bufs + (k & 1) * (loc_buf + attn_buf);
      char* ab = lb + loc_buf;
      // the next query's points into the other buffers, then wait for this one's
      const int64_t nx = nq + stride;
      char* nb = bufs + ((k + 1) & 1) * (loc_buf + attn_buf);
      if (nx < queries) {
        msda_warp_copy(nb, lsrc + nx * loc_bytes, loc_bytes, lane);
        msda_warp_copy(nb + loc_buf, asrc + nx * attn_bytes, attn_bytes, lane);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      __syncwarp();
      lp = reinterpret_cast<const float2*>(lb + ((uintptr_t)lq_src & 15));
      ap = reinterpret_cast<const T*>(ab + ((uintptr_t)aq_src & 15));
    }

    // 1. lane j < J: point j's centroid over the heads, in head order, and its
    // nearest pixel; the in-map points go to the list in point order
    int pix = -1;
    if (lane < J) {
      float asum = 0.f, sx = 0.f, sy = 0.f;
#pragma unroll 4
      for (int h = 0; h < M; ++h) {
        const float a = msda_to_float(ap[h * J + lane]);
        const float2 xy = lp[h * J + lane];
        asum = __fadd_rn(asum, a);
        sx = __fadd_rn(sx, __fmul_rn(xy.x, a));
        sy = __fadd_rn(sy, __fmul_rn(xy.y, a));
      }
      const float inv = __fdiv_rn(1.f, fmaxf(asum, 1e-12f));
      const int o = msda_nearest(__fmul_rn(sx, inv), __fmul_rn(sy, inv), lw, lh);
      if (o >= 0) pix = lstart + o;
    }
    const unsigned in_map = __ballot_sync(0xffffffffu, pix >= 0);
    if (pix >= 0) list[__popc(in_map & ((1u << lane) - 1u))] = make_int2(pix, lane);
    const int K = __popc(in_map);
    __syncwarp();

    // 2. gather: lane u of a pass adds the K rows' channels of unit u with its
    // head's exact weights, MSDA_SH_BATCH rows requested before any is added
    const int64_t n = nq / Lq;
    const T* vb = value + n * S * row;
    for (int u = lane; u < MG; u += 32) {
      const T* vu = vb + (int64_t)u * V;
      const T* aw = ap + (u / G) * J;
      float acc[V];
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = 0.f;
      for (int t0 = 0; t0 < K; t0 += MSDA_SH_BATCH) {
        typename MsdaRaw<T, V>::type raw[MSDA_SH_BATCH];
        float w[MSDA_SH_BATCH];
#pragma unroll
        for (int b = 0; b < MSDA_SH_BATCH; ++b) {
          if (t0 + b < K) {
            const int2 e = list[t0 + b];
            raw[b] = msda_fetch<false, T, V>(vu + e.x * row);
            w[b] = msda_to_float(aw[e.y]);
          }
        }
#pragma unroll
        for (int b = 0; b < MSDA_SH_BATCH; ++b) {
          if (t0 + b < K) {
            float v[V];
            msda_unpack(raw[b], v);
#pragma unroll
            for (int i = 0; i < V; ++i) acc[i] = fmaf(w[b], v[i], acc[i]);
          }
        }
      }
      msda_store(out + nq * row + (int64_t)u * V, acc);
    }
    __syncwarp();  // the list and buffers are rewritten for the next query
  }
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

template <typename T, int V, bool STAGED>
static int msda_shared_go(const void* value, const void* loc, const void* attn, void* out,
                          int64_t queries, int s, int m, int d, int lq, int P,
                          int loc_buf, int attn_buf, int warp_bytes, const MsdaLevels& lv,
                          cudaStream_t st) {
  const auto kern = msda_shared_kernel<T, V, STAGED>;
  const size_t smem = (size_t)warp_bytes * MSDA_SH_WARPS;
  int64_t blocks = (queries + MSDA_SH_WARPS - 1) / MSDA_SH_WARPS;
  int rc = 0;
  if (smem > 48 * 1024) {
    rc = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
  }
  if (STAGED && rc == 0) {
    // persistent: the MSDA_SH_MIN_BLOCKS blocks an SM that the launch bounds
    // hold in registers (no occupancy query: it cost host time every call)
    int dev = 0, sms = 0;
    rc = (int)cudaGetDevice(&dev);
    if (rc == 0) rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc == 0 && blocks > (int64_t)MSDA_SH_MIN_BLOCKS * sms) {
      blocks = (int64_t)MSDA_SH_MIN_BLOCKS * sms;
    }
  }
  if (rc != 0) return rc;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned int)blocks, MSDA_SH_THREADS, smem, st>>>(
      (const T*)value, (const float*)loc, (const T*)attn, (T*)out, queries, s, m, d, lq, P,
      loc_buf, attn_buf, warp_bytes, lv);
  return (int)cudaGetLastError();
}

// Staged unless a warp's two pairs of buffers would not fit in a block's
// shared memory (M * J above about 650 points at 16 warps a block).
template <typename T, int V>
static int msda_shared_launch(const void* value, const void* loc, const void* attn, void* out,
                              int n, int s, int m, int d, int lq, int P, const MsdaLevels& lv,
                              cudaStream_t st) {
  const int64_t queries = (int64_t)n * lq;
  const int64_t points = (int64_t)m * lv.n * P;
  if (points * 8 > 0x7fffffff) return (int)cudaErrorInvalidValue;
  // each buffer: a query's bytes and 16 to spare, rounded up to 16
  const int loc_buf = (int)((points * 8 + 31) & ~15);
  const int attn_buf = (int)((points * (int64_t)sizeof(T) + 31) & ~15);
  const int64_t staged_bytes = MSDA_SH_LIST_BYTES + 2 * ((int64_t)loc_buf + attn_buf);
  if (staged_bytes * MSDA_SH_WARPS <= MSDA_SH_SMEM) {
    return msda_shared_go<T, V, true>(value, loc, attn, out, queries, s, m, d, lq, P, loc_buf,
                                      attn_buf, (int)staged_bytes, lv, st);
  }
  return msda_shared_go<T, V, false>(value, loc, attn, out, queries, s, m, d, lq, P, 0, 0,
                                     MSDA_SH_LIST_BYTES, lv, st);
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
