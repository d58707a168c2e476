// Fused Mask2Former score tail for Hopper (sm_90a): upsample, sigmoid and the
// query contraction in one pass over output tiles, and the anomaly score's
// backward.
//
// Replaces the TPU-side expressions of
//   * multishiftseg_tpu/ops/scores.py::mask2former_anomaly_score (with
//     ops/resize.py::resize_bilinear_nchw, models/maskformer.py:236-239):
//     anomaly[n, y, x] = 1 - max_k sum_q probs[n, q, k] * sigmoid(up(mask)[n, q, y, x])
//     entry mask_scores_forward(mode 0)
//   * ops/scores.py::mask2former_semantic_logits + models/maskformer.py::
//     semantic_inference: channel k < K gets the same sum, channel K + q gets
//     keep_w[n, q] * sigmoid(up(mask)[n, q, y, x]); entry mode 1, or mode 2
//     for the K class channels alone (a caller that keeps only sem[:, :K])
//   * JAX autodiff of the anomaly score (ops/scores.py:39-51 through
//     resize.py:133): entry mask_scores_backward
// The plain path materialises the [N, Q, H, W] upsampled logits and their
// sigmoid in device memory (two 839 MB f32 stacks at Q = 100, 1024x2048); here
// each thread keeps its pixels' K sums in registers and nothing but the output
// is written.
//
// Upsampling is bilinear with align_corners=False: the source row of output
// row y is clamp((y + 0.5) * h / H - 0.5, 0, h - 1), taps floor and
// min(floor + 1, h - 1) (resize.py::_interp_matrix); the same for columns.
//
// Layouts (contiguous, f32): masks [N, Q, h, w]; probs [N, Q, K] (softmax over
// K + 1 classes, the void class dropped); keep_w [N, Q]; out [N, H, W]
// (anomaly), [N, K + Q, H, W] (semantic) or [N, K, H, W] (classes only).
//
// Forward (mask_scores_fwd_kernel, modes 0-2). Bound at Q = 100, K = 19: per
// output pixel and query the bilinear taps take 7 f32 operations, the sigmoid
// 4 and the K sums 2K = 38, 49 in all. At the eval shapes (256x512 ->
// 1024x2048) that is 10.3 GFLOP, 0.154 ms at 67 TFLOP/s, against 52 MB read
// and 8.4 MB written (18 us) for the anomaly score: operations bound it; at
// stage 1's shapes (16 x 176^2 -> 704^2) 38.9 GFLOP, 0.58 ms. The semantic
// mode writes K + Q = 119 channels, 1.0 GB at the eval shapes (0.31 ms):
// bytes bound it. A thread per pixel that read its four taps of every query
// from global memory, with int64 offsets and the IEEE exp and divide, issued
// more than twice the instructions the bound counts (5.5-5.8x the bound on
// the H100, PERF.md). The design:
//   * 256-thread blocks walk 2-D tiles of 16 x 32 output pixels of one image;
//     each thread owns two pixels of one column, 8 rows apart, which share
//     every probability load and their column taps. The grid is one wave of
//     blocks shared by the images.
//   * Staging. At 4x upsampling a tile's taps fall in a window of 6 x 10
//     texels a query. The window of the Q planes is copied to shared memory by
//     cp.async (24 KB at Q = 100), and each of the tile's 16 rows is
//     interpolated vertically once (64 KB), queries fastest: a pixel then
//     reads four queries' two taps as two float4s and interpolates them
//     horizontally. The next tile's window is copied as soon as the current
//     one has been interpolated, so the copy runs behind the current tile's
//     arithmetic (the interpolated rows are the second buffer). The host sizes
//     the window exactly (window_extent): 96 KB a block at Q = 100, two blocks
//     (16 warps) an SM. The window code is the backward's (stage_window,
//     interpolate_rows, staged_sums).
//   * The sigmoid is one ex2 and one reciprocal, both approximate (the staged
//     rows are pre-scaled by -log2(e)); the IEEE pair costs several times the
//     instructions. The K sums sit in KMAX = 20 or 32 registers a pixel, fed
//     by float4 broadcasts of the zero-padded probability rows from shared
//     memory.
//   * Mode 1's K + Q channels and mode 2's K, which nothing re-reads, go out
//     by streaming stores (__stcs), coalesced along the tile's rows.
//   * A window that does not fit (a downsample, many queries) reads its taps
//     from global memory instead: dispatch by shape.
// On the H100 (PERF.md, PR 8) the shared-memory loads, not the FMAs, appear
// to set the pace: one pixel a thread (a float4 of probabilities for every
// four FMAs) ran slower than two, while more blocks an SM or fewer
// instructions a query did not move it.
//
// Backward. anomaly = 1 - max_k acc_k, acc_k = sum_q p_qk s_q. The gradient g
// of a pixel goes to the classes that reach the max, split evenly among them
// (JAX's rule for jnp.max): d acc_k = -g / ties. Then
//   d p[q, k] = sum over pixels of d acc_k * s_q      (a reduction over H * W)
//   d up_q    = s_q (1 - s_q) * sum_k d acc_k p_qk     (only when asked)
//   d mask    = the transpose of the bilinear upsample of d up.
// Kernel 1 (mask_scores_bwd_dp_kernel): a few blocks per image, 256 threads,
// each walking 8 x 32 output tiles, a thread a pixel; a tile with no gradient
// (the crop's margin) is skipped after one barrier.
//   * Staging as in the forward (one buffer: the window is copied and
//     interpolated before each tile).
//   * Pass 1, a thread per pixel: the forward's K sums over the Q queries, the
//     max and the tie set (a bit mask), the share -g / ties.
//   * Class lists: a ballot per warp and class and one scan over (class, warp)
//     give each class the tile's tied pixels in pixel order (one byte an
//     entry; a pixel with several tied classes is in each of their lists).
//   * Pass 2, two threads a query (200 of 256 busy at Q = 100): for each
//     class, d probs[q, k] += share * s_q over the class list, s_q recomputed
//     from the staged window, one thread taking the first half of the list and
//     the other the second, in a register kept over all of the block's tiles.
//     Nothing is contended and every sum runs in a fixed order.
//   * Both passes take the sigmoid with the fast exp and divide, as the
//     forward does.
// At the end each block writes its (query, half) sums to a partial [N,
// chunks, 2, Q * K]; kernel 2 sums the slices in order: the result does not
// depend on the run, and d probs is the same with or without d mask.
// Shared memory at Q = 100, K = 19: 67 KB a block, 3 blocks (24 warps) an SM.
// When d mask is asked, kernel 1 also stores each pixel's tie set and share,
// and kernel 3 gathers: one thread per low-resolution texel walks the output
// pixels whose bilinear taps reach it and sums their d up, weight by weight.
// No atomics to device memory anywhere.
// Bound at stage 1's shapes (16 x 704^2 from 176^2, Q = 100, K = 19, the
// gradient inside the 700^2 crop: 7.84 M pixels): the forward's 4.9 k f32
// operations per pixel plus 2 per query for d probs, about 39 GFLOP, 0.60 ms
// at 67 TFLOP/s; masks 198 MB + g 32 MB read, 0.07 ms. Operations bound it.
// Kernel 1 does more than the bound counts: pass 2 recomputes each sigmoid
// it needs (an interpolation, an exp and a reciprocal a query and pixel).
// d mask adds 198 MB written.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MASK_SCORES_MAX_K 32
// output tiles of both kernels: TILE_Y x TILE_X pixels, a thread each
#define TILE_Y 8
#define TILE_X 32
#define TILE_THREADS (TILE_Y * TILE_X)
// the forward's tiles are FWD_ROWS times as tall: a thread owns FWD_ROWS
// pixels of one column, rows TILE_Y apart, which share every probability load
#define FWD_ROWS 2
#define BWD_MAX_QUERIES TILE_THREADS  // pass 2: a thread (two when Q <= 128) a query
// a window staged only while two blocks fit on an SM; beyond, taps from global
#define STAGED_MAX_SMEM (113 * 1024)

struct Taps {
  int64_t o00, o01, o10, o11;
  float ly, lx;
};

// The source coordinate of output index i, fused (one rounding) so that the
// host's window_extent reproduces it exactly.
__device__ __forceinline__ void source_index(int i, float scale, int n_in,
                                             int* i0, int* i1, float* l) {
  float src = __fmaf_rn((float)i + 0.5f, scale, -0.5f);
  src = fminf(fmaxf(src, 0.f), (float)(n_in - 1));
  *i0 = (int)floorf(src);
  *i1 = min(*i0 + 1, n_in - 1);
  *l = src - (float)*i0;
}

__device__ __forceinline__ Taps pixel_taps(int y, int x, int h, int w, float sy,
                                           float sx) {
  int y0, y1, x0, x1;
  Taps t;
  source_index(y, sy, h, &y0, &y1, &t.ly);
  source_index(x, sx, w, &x0, &x1, &t.lx);
  t.o00 = (int64_t)y0 * w + x0;
  t.o01 = (int64_t)y0 * w + x1;
  t.o10 = (int64_t)y1 * w + x0;
  t.o11 = (int64_t)y1 * w + x1;
  return t;
}

// The staged rows hold -log2(e) times the vertically interpolated logit, so
// that the sigmoid of a pixel's horizontal interpolation t of two of them is
// 1 / (1 + 2^t): one ex2 and one reciprocal, both approximate (a few ulp;
// flushed to 0 below 2^-126, where the sigmoid is 1 to f32 precision).
#define NEG_LOG2E (-1.4426950408889634f)

__device__ __forceinline__ float lerp_sigmoid(float a, float b, float lx) {
  const float t = (1.f - lx) * a + lx * b;
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(t));
  return __fdividef(1.f, 1.f + e);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ float sigmoid_at(const float* mq, const Taps& t) {
  const float v = (1.f - t.ly) * ((1.f - t.lx) * mq[t.o00] + t.lx * mq[t.o01]) +
                  t.ly * ((1.f - t.lx) * mq[t.o10] + t.lx * mq[t.o11]);
  return 1.f / (1.f + expf(-v));
}

// The source rows [y0, y0 + rows) and columns [x0, x0 + cols) that the taps
// of the tile of tile_y x TILE_X outputs from (y0t, x0t) reach.
struct Window {
  int y0, x0, rows, cols;
};

__device__ __forceinline__ Window tile_window(int y0t, int x0t, int tile_y, int h, int w,
                                              int H, int W, float sy, float sx) {
  Window win;
  int a, b;
  float l;
  source_index(y0t, sy, h, &win.y0, &a, &l);
  source_index(min(y0t + tile_y, H) - 1, sy, h, &a, &b, &l);
  win.rows = b - win.y0 + 1;
  source_index(x0t, sx, w, &win.x0, &a, &l);
  source_index(min(x0t + TILE_X, W) - 1, sx, w, &a, &b, &l);
  win.cols = b - win.x0 + 1;
  return win;
}

// A tile's staged window of the Q planes in shared memory, as the host sized
// it (wh x ww texels a query at most): raw [Q][rs], row r of a query at r * ww
// (rs odd: the queries' texels fall in different banks); interp [tile_y * ww]
// [qs], each output row's vertical interpolation, queries fastest (qs a
// multiple of 4 with qs / 4 odd: a pixel reads 4 queries as one float4, and
// the columns of a row fall in different bank groups).
struct Staging {
  float* raw;
  float* interp;
  int tile_y, wh, ww, rs, qs;
};

// Issue the cp.async copies of the window of the Q planes of mn into raw
// (the caller waits). Thread t copies element t % per of the queries t / per,
// + slots, ... (a window larger than the block takes several rounds).
__device__ __forceinline__ void stage_window(const float* mn, int64_t plane, int w, int Q,
                                             const Window& win, const Staging& st, int tid,
                                             int threads) {
  if (win.rows > st.wh || win.cols > st.ww) __trap();  // the host sized it (window_extent)
  const int per = win.rows * win.cols;
  for (int e0 = 0; e0 < per; e0 += threads) {
    const int span = min(per - e0, threads), slots = threads / span;
    if (tid < slots * span) {
      const int e = e0 + tid % span, r = e / win.cols, c = e - r * win.cols;
      const float* src = mn + (int64_t)(win.y0 + r) * w + win.x0 + c;
      float* dst = st.raw + r * st.ww + c;
      for (int q = tid / span; q < Q; q += slots) {
        cp_async4(dst + (size_t)q * st.rs, src + q * plane);
      }
    }
  }
}

// Each output row's vertical interpolation of the staged window, times
// -log2(e) (see lerp_sigmoid), shared by its TILE_X pixels. Thread t takes
// query t % span and every slots-th (row, column) from t / span on.
__device__ __forceinline__ void interpolate_rows(int Q, const Window& win, int y0t, int H,
                                                 int h, float sy, const Staging& st,
                                                 int tid, int threads) {
  for (int q0 = 0; q0 < Q; q0 += threads) {
    const int span = min(Q - q0, threads), slots = threads / span;
    if (tid >= slots * span) continue;
    const int q = q0 + tid % span;
    const float* rq = st.raw + (size_t)q * st.rs;
    float* dq = st.interp + q;
    int e = tid / span, r = e / win.cols, c = e - r * win.cols;
    while (r < st.tile_y && y0t + r < H) {
      int r0, r1;
      float ly;
      source_index(y0t + r, sy, h, &r0, &r1, &ly);
      const float* s0 = rq + (r0 - win.y0) * st.ww;
      const float* s1 = rq + (r1 - win.y0) * st.ww;
      float* d = dq + (size_t)r * st.ww * st.qs;
      for (const int row = r; r == row;) {
        d[(size_t)c * st.qs] = ((1.f - ly) * s0[c] + ly * s1[c]) * NEG_LOG2E;
        for (c += slots; c >= win.cols; c -= win.cols) ++r;
      }
    }
  }
}

// Probability rows in shared memory are padded with zeros to KMAX classes (a
// multiple of 4, at least K), so that a row is read as float4s: one shared
// load feeds four sums.
__device__ __forceinline__ void load_probs(const float* __restrict__ probs,
                                           float* sprobs, int Q, int K, int KMAX) {
  for (int i = threadIdx.x; i < Q * KMAX; i += blockDim.x) {
    const int k = i % KMAX;
    sprobs[i] = k < K ? probs[(i / KMAX) * K + k] : 0.f;
  }
}

// acc[r][k] += p[k] * s[r] over one padded row p (16-byte aligned), for R
// pixels
template <int KMAX, int R>
__device__ __forceinline__ void accumulate(float (&acc)[R][KMAX], const float* p,
                                           const float (&s)[R]) {
  const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int j = 0; j < KMAX / 4; ++j) {
    const float4 v = p4[j];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      acc[r][4 * j] = fmaf(v.x, s[r], acc[r][4 * j]);
      acc[r][4 * j + 1] = fmaf(v.y, s[r], acc[r][4 * j + 1]);
      acc[r][4 * j + 2] = fmaf(v.z, s[r], acc[r][4 * j + 2]);
      acc[r][4 * j + 3] = fmaf(v.w, s[r], acc[r][4 * j + 3]);
    }
  }
}

// R pixels' K sums over the Q queries from the staged rows: i0[r] and i1[r]
// are pixel r's two taps' interpolated rows (queries fastest), lx their
// column weight; on_sigmoid(q, r, s) sees each sigmoid. Four queries a step.
template <int KMAX, int R, typename F>
__device__ __forceinline__ void staged_sums(float (&acc)[R][KMAX], const float* const (&i0)[R],
                                            const float* const (&i1)[R], float lx,
                                            const float* sprobs, int Q, F&& on_sigmoid) {
  int q = 0;
#pragma unroll 2
  for (; q + 4 <= Q; q += 4) {
    float s[4][R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(i0[r] + q);
      const float4 b = *reinterpret_cast<const float4*>(i1[r] + q);
      s[0][r] = lerp_sigmoid(a.x, b.x, lx);
      s[1][r] = lerp_sigmoid(a.y, b.y, lx);
      s[2][r] = lerp_sigmoid(a.z, b.z, lx);
      s[3][r] = lerp_sigmoid(a.w, b.w, lx);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      accumulate<KMAX, R>(acc, sprobs + (q + u) * KMAX, s[u]);
#pragma unroll
      for (int r = 0; r < R; ++r) on_sigmoid(q + u, r, s[u][r]);
    }
  }
  for (; q < Q; ++q) {
    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = lerp_sigmoid(i0[r][q], i1[r][q], lx);
    accumulate<KMAX, R>(acc, sprobs + q * KMAX, s);
#pragma unroll
    for (int r = 0; r < R; ++r) on_sigmoid(q, r, s[r]);
  }
}

template <int KMAX>
__device__ __forceinline__ float class_max(const float (&acc)[KMAX], int K) {
  float mx = acc[0];
#pragma unroll
  for (int k = 1; k < KMAX; ++k) {
    if (k < K) mx = fmaxf(mx, acc[k]);
  }
  return mx;
}

// mode: 0 anomaly, 1 semantic (K + Q channels), 2 semantic classes (K
// channels). gridDim = (chunks, N); each block walks the tiles chunk, chunk +
// chunks, ... of image n (FWD_ROWS * TILE_Y x TILE_X pixels). STAGED: taps
// from the staged window (see Staging); else from global memory.
template <int MODE, int KMAX, bool STAGED>
__global__ void __launch_bounds__(TILE_THREADS, 2)
mask_scores_fwd_kernel(const float* __restrict__ masks, const float* __restrict__ probs,
                       const float* __restrict__ keep_w, float* __restrict__ out, int Q,
                       int K, int h, int w, int H, int W, float sy, float sx, int wh,
                       int ww, int rs, int qs) {
  constexpr int R = FWD_ROWS, TY = FWD_ROWS * TILE_Y;
  extern __shared__ float4 smem4[];
  float* sprobs = reinterpret_cast<float*>(smem4);  // [Q][KMAX]
  Staging st;
  st.interp = sprobs + Q * KMAX;                     // [TY * ww][qs]
  st.raw = st.interp + (size_t)TY * ww * qs;         // [Q][rs]
  st.tile_y = TY, st.wh = wh, st.ww = ww, st.rs = rs, st.qs = qs;
  float* skeep = st.raw + (size_t)Q * rs;            // [Q] (mode 1 only)
  const int n = blockIdx.y, chunk = blockIdx.x, chunks = gridDim.x;
  const int tid = threadIdx.x, tx = tid % TILE_X, ty = tid / TILE_X;
  load_probs(probs + (int64_t)n * Q * K, sprobs, Q, K, KMAX);
  if (MODE == 1) {
    for (int i = tid; i < Q; i += TILE_THREADS) skeep[i] = keep_w[(int64_t)n * Q + i];
  }
  __syncthreads();
  const int64_t HW = (int64_t)H * W;
  const int64_t plane = (int64_t)h * w;
  const float* mn = masks + (int64_t)n * Q * plane;
  const int channels = MODE == 1 ? K + Q : K;
  float* on = out + (int64_t)n * (MODE == 0 ? 1 : channels) * HW;
  const int tiles_x = (W + TILE_X - 1) / TILE_X;
  const int tiles = ((H + TY - 1) / TY) * tiles_x;
  if (STAGED && chunk < tiles) {
    const int y0t = (chunk / tiles_x) * TY, x0t = (chunk % tiles_x) * TILE_X;
    stage_window(mn, plane, w, Q, tile_window(y0t, x0t, TY, h, w, H, W, sy, sx), st, tid,
                 TILE_THREADS);
  }

  for (int tile = chunk; tile < tiles; tile += chunks) {
    const int y0t = (tile / tiles_x) * TY, x0t = (tile % tiles_x) * TILE_X;
    // a pixel beyond the map's edge computes its edge neighbour and writes nothing
    const int x = min(x0t + tx, W - 1);
    bool inside[R];
    int y[R];
    int64_t at[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      inside[r] = y0t + ty + r * TILE_Y < H && x0t + tx < W;
      y[r] = min(y0t + ty + r * TILE_Y, H - 1);
      at[r] = (int64_t)y[r] * W + x;
    }
    // mode 1: each query's extra channel, keep_w[q] * s, as it is computed
    auto extra = [&](int q, int r, float s) {
      if (MODE == 1 && inside[r]) __stcs(on + (int64_t)(K + q) * HW + at[r], skeep[q] * s);
    };
    float acc[R][KMAX];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int k = 0; k < KMAX; ++k) acc[r][k] = 0.f;
    }
    if (STAGED) {
      const Window win = tile_window(y0t, x0t, TY, h, w, H, W, sy, sx);
      cp_async_wait_all();
      __syncthreads();  // the window is in; every thread is done with the last rows
      interpolate_rows(Q, win, y0t, H, h, sy, st, tid, TILE_THREADS);
      __syncthreads();  // the rows are in; the window's buffer is free
      const int next = tile + chunks;
      if (next < tiles) {  // the next tile's window, copied behind this tile's sums
        const int y0n = (next / tiles_x) * TY, x0n = (next % tiles_x) * TILE_X;
        stage_window(mn, plane, w, Q, tile_window(y0n, x0n, TY, h, w, H, W, sy, sx), st,
                     tid, TILE_THREADS);
      }
      int c0, c1;
      float lx;
      source_index(x, sx, w, &c0, &c1, &lx);
      const float* i0[R];
      const float* i1[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = (y[r] - y0t) * ww - win.x0;
        i0[r] = st.interp + (size_t)(row + c0) * qs;
        i1[r] = st.interp + (size_t)(row + c1) * qs;
      }
      staged_sums<KMAX, R>(acc, i0, i1, lx, sprobs, Q, extra);
    } else {
      Taps t[R];
#pragma unroll
      for (int r = 0; r < R; ++r) t[r] = pixel_taps(y[r], x, h, w, sy, sx);
      const float* mq = mn;
      for (int q = 0; q < Q; ++q, mq += plane) {
        float s[R];
#pragma unroll
        for (int r = 0; r < R; ++r) s[r] = sigmoid_at(mq, t[r]);
        accumulate<KMAX, R>(acc, sprobs + q * KMAX, s);
#pragma unroll
        for (int r = 0; r < R; ++r) extra(q, r, s[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (!inside[r]) continue;
      if (MODE == 0) {
        on[at[r]] = 1.f - class_max<KMAX>(acc[r], K);
      } else {
#pragma unroll
        for (int k = 0; k < KMAX; ++k) {
          if (k < K) __stcs(on + (int64_t)k * HW + at[r], acc[r][k]);
        }
      }
    }
  }
}

// The most rows (columns) of n_in that one tile of `tile` outputs reaches,
// with the device's arithmetic (source_index): the window's exact size.
static int window_extent(int n_out, int n_in, int tile) {
  const float scale = (float)n_in / (float)n_out;
  auto source = [&](int i) {
    return fminf(fmaxf(fmaf((float)i + 0.5f, scale, -0.5f), 0.f), (float)(n_in - 1));
  };
  int most = 0;
  for (int t0 = 0; t0 < n_out; t0 += tile) {
    const int t1 = (t0 + tile < n_out ? t0 + tile : n_out) - 1;
    const int i0 = (int)floorf(source(t0));
    const int i1 = (int)floorf(source(t1)) + 1 < n_in ? (int)floorf(source(t1)) + 1 : n_in - 1;
    if (i1 - i0 + 1 > most) most = i1 - i0 + 1;
  }
  return most;
}

// A kernel's launch plan for these shapes: the staged window (Staging), when
// it fits.
struct TilePlan {
  int wh, ww, rs, qs;  // 0: taps from global memory
  int kmax;            // sums a pixel keeps: 20 or 32
  size_t smem;
};

// tile_y: the tiles' rows; extra: the kernel's shared bytes besides the
// probabilities and the window
static int tile_plan(int q, int k, int h, int w, int H, int W, int tile_y, size_t extra,
                     TilePlan* p) {
  p->kmax = k <= 20 ? 20 : 32;
  const size_t fixed = (size_t)q * p->kmax * 4 + extra;
  p->wh = window_extent(H, h, tile_y);
  p->ww = window_extent(W, w, TILE_X);
  p->rs = (p->wh * p->ww) | 1;
  p->qs = ((q + 3) & ~3) | 4;
  p->smem = fixed + ((size_t)tile_y * p->ww * p->qs + (size_t)q * p->rs) * 4;
  if (p->smem > STAGED_MAX_SMEM) {
    p->wh = p->ww = p->rs = p->qs = 0;
    p->smem = fixed;
  }
  return p->smem > 232448 ? (int)cudaErrorInvalidValue : (int)cudaSuccess;
}

typedef void (*FwdKernel)(const float*, const float*, const float*, float*, int, int, int,
                          int, int, int, float, float, int, int, int, int);

template <int MODE>
static FwdKernel fwd_kernel_of(const TilePlan& p) {
  if (p.wh > 0) {
    return p.kmax == 20 ? mask_scores_fwd_kernel<MODE, 20, true>
                        : mask_scores_fwd_kernel<MODE, 32, true>;
  }
  return p.kmax == 20 ? mask_scores_fwd_kernel<MODE, 20, false>
                      : mask_scores_fwd_kernel<MODE, 32, false>;
}

// mode: 0 = anomaly ([N, H, W] output, keep_w unused), 1 = semantic
// ([N, K + Q, H, W]), 2 = semantic classes only ([N, K, H, W], keep_w unused).
// Returns the first failed CUDA call's error, else cudaGetLastError() after
// the launch.
extern "C" int mask_scores_forward(const void* masks, const void* probs,
                                   const void* keep_w, void* out, int n, int q,
                                   int k, int h, int w, int H, int W, int mode,
                                   void* stream) {
  if (k < 1 || k > MASK_SCORES_MAX_K || q < 1 || h < 1 || w < 1 || H < 0 || W < 0 ||
      mode < 0 || mode > 2) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0 || H == 0 || W == 0) return (int)cudaSuccess;
  if (n > 65535) return (int)cudaErrorInvalidValue;
  TilePlan p;
  int rc = tile_plan(q, k, h, w, H, W, FWD_ROWS * TILE_Y, mode == 1 ? (size_t)q * 4 : 0, &p);
  if (rc != 0) return rc;
  const FwdKernel kern = mode == 0 ? fwd_kernel_of<0>(p)
                         : mode == 1 ? fwd_kernel_of<1>(p) : fwd_kernel_of<2>(p);
  // this launch's shared memory, and the blocks of it that the SMs hold
  int per_sm = 0, dev = 0, sms = 0;
  rc = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (rc == 0) rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, TILE_THREADS,
                                                                       p.smem);
  if (rc == 0) rc = (int)cudaGetDevice(&dev);
  if (rc == 0) rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != 0) return rc;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // one wave of blocks shared by the images, each image's tiles split in chunks
  const int64_t tiles =
      (int64_t)((H + FWD_ROWS * TILE_Y - 1) / (FWD_ROWS * TILE_Y)) * ((W + TILE_X - 1) / TILE_X);
  int64_t chunks = (int64_t)per_sm * sms / n;
  chunks = chunks < 1 ? 1 : (chunks > tiles ? tiles : chunks);
  kern<<<dim3((unsigned int)chunks, (unsigned int)n), TILE_THREADS, p.smem,
         (cudaStream_t)stream>>>((const float*)masks, (const float*)probs,
                                 (const float*)keep_w, (float*)out, q, k, h, w, H, W,
                                 (float)h / (float)H, (float)w / (float)W, p.wh, p.ww, p.rs,
                                 p.qs);
  return (int)cudaGetLastError();
}

// Kernel 1: gridDim = (chunks, N), TILE_THREADS threads; each iteration one
// tile of TILE_Y x TILE_X output pixels, a thread per pixel. STAGED: the
// tile's window of the Q planes is copied to shared memory (cp.async), each
// output row's vertical interpolation computed once, and every tap read from
// there (see Staging); else (a window too large for shared memory:
// downsampling, or many queries) the taps come from global memory. partial
// [N, chunks, parts, Q * K]; tie_mask / share [N, H * W] are written only when
// not null.
template <int KMAX, bool STAGED>
__global__ void __launch_bounds__(TILE_THREADS, KMAX == 20 ? 3 : 2)
mask_scores_bwd_dp_kernel(const float* __restrict__ masks,
                          const float* __restrict__ probs,
                          const float* __restrict__ grad,
                          float* __restrict__ partial,
                          uint32_t* __restrict__ tie_mask,
                          float* __restrict__ share_out, int Q, int K, int h,
                          int w, int H, int W, float sy, float sx, int wh, int ww,
                          int rs, int qs, int parts) {
  extern __shared__ float4 smem4[];
  float* sprobs = reinterpret_cast<float*>(smem4);             // [Q][KMAX]
  Staging st;
  st.interp = sprobs + Q * KMAX;                                // [TILE_Y * ww][qs]
  st.tile_y = TILE_Y, st.wh = wh, st.ww = ww, st.rs = rs, st.qs = qs;
  float4* pix = reinterpret_cast<float4*>(st.interp + (size_t)TILE_Y * ww * qs);  // [tid]
  uint32_t* wbits = reinterpret_cast<uint32_t*>(pix + TILE_THREADS);  // [warp][class]
  int* woff = reinterpret_cast<int*>(wbits + TILE_THREADS);    // [warp][class]
  int* lstart = woff + TILE_THREADS;                           // [33], padded to 36
  st.raw = reinterpret_cast<float*>(lstart + 36);              // [Q][rs]
  uint8_t* entries = reinterpret_cast<uint8_t*>(st.raw + (size_t)Q * rs);
  const int n = blockIdx.y;
  const int chunk = blockIdx.x;
  const int chunks = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  load_probs(probs + (int64_t)n * Q * K, sprobs, Q, K, KMAX);

  const int64_t HW = (int64_t)H * W;
  const int64_t plane = (int64_t)h * w;
  const float* mn = masks + (int64_t)n * Q * plane;
  const int tiles_x = (W + TILE_X - 1) / TILE_X;
  const int tiles = ((H + TILE_Y - 1) / TILE_Y) * tiles_x;
  const int ty = tid / TILE_X, tx = tid % TILE_X;
  // pass 2: thread (query pq, part) sums half of every class list (parts = 2)
  const int pq = tid % Q, part = tid / Q;
  const bool owner = tid < parts * Q;
  float dacc[KMAX];
#pragma unroll
  for (int k = 0; k < KMAX; ++k) dacc[k] = 0.f;
  __syncthreads();

  for (int tile = chunk; tile < tiles; tile += chunks) {
    const int y0t = (tile / tiles_x) * TILE_Y, x0t = (tile % tiles_x) * TILE_X;
    const int y = y0t + ty, x = x0t + tx;
    const bool inside = y < H && x < W;
    const int64_t at = (int64_t)n * HW + (int64_t)y * W + x;
    const float g = inside ? grad[at] : 0.f;
    // a tile without gradient (the crop's margin) costs one barrier; it also
    // keeps the previous tile's shared memory until every thread is done
    if (!__syncthreads_or(g != 0.f)) {
      if (tie_mask != nullptr && inside) {
        tie_mask[at] = 0u;
        share_out[at] = 0.f;
      }
      continue;
    }
    int wx0 = 0;
    if (STAGED) {
      const Window win = tile_window(y0t, x0t, TILE_Y, h, w, H, W, sy, sx);
      wx0 = win.x0;
      stage_window(mn, plane, w, Q, win, st, tid, TILE_THREADS);
      cp_async_wait_all();
      __syncthreads();
      interpolate_rows(Q, win, y0t, H, h, sy, st, tid, TILE_THREADS);
      __syncthreads();
    }

    // pass 1, a thread per pixel: the forward's sums, the max and its ties
    uint32_t mask = 0;
    float share = 0.f;
    if (g != 0.f) {
      float acc[1][KMAX];
#pragma unroll
      for (int k = 0; k < KMAX; ++k) acc[0][k] = 0.f;
      int c0 = 0, c1 = 0;  // the pixel's two taps: their (row, column) in the interpolated rows
      float lx = 0.f;
      if (STAGED) {
        source_index(x, sx, w, &c0, &c1, &lx);
        c0 += ty * ww - wx0;
        c1 += ty * ww - wx0;
        const float* const i0[1] = {st.interp + (size_t)c0 * qs};
        const float* const i1[1] = {st.interp + (size_t)c1 * qs};
        staged_sums<KMAX, 1>(acc, i0, i1, lx, sprobs, Q, [](int, int, float) {});
      } else {
        const Taps t = pixel_taps(y, x, h, w, sy, sx);
        const float* mq = mn;
        for (int q = 0; q < Q; ++q, mq += plane) {
          const float sq[1] = {sigmoid_at(mq, t)};
          accumulate<KMAX, 1>(acc, sprobs + q * KMAX, sq);
        }
      }
      const float mx = class_max<KMAX>(acc[0], K);
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        if (k < K && acc[0][k] == mx) mask |= 1u << k;
      }
      share = -g / (float)__popc(mask);
      pix[tid] = make_float4(__int_as_float(c0), lx, share, __int_as_float(c1));
    }
    if (tie_mask != nullptr && inside) {
      tie_mask[at] = mask;
      share_out[at] = share;
    }

    // the class lists: for each class, its tied pixels in pixel order (a
    // pixel with several tied classes is in each of their lists), by a ballot
    // per warp and class and one scan over (class, warp)
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k < K) {
        const uint32_t bits = __ballot_sync(0xffffffffu, (mask >> k) & 1u);
        if (lane == 0) wbits[warp * 32 + k] = bits;
      }
    }
    __syncthreads();
    if (warp == 0) {
      int tot = 0;
      for (int v = 0; v < TILE_THREADS / 32; ++v) {
        woff[v * 32 + lane] = tot;
        tot += lane < K ? __popc(wbits[v * 32 + lane]) : 0;
      }
      int incl = tot;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += t;
      }
      const int start = incl - tot;
      for (int v = 0; v < TILE_THREADS / 32; ++v) woff[v * 32 + lane] += start;
      lstart[lane] = start;
      if (lane == 31) lstart[32] = incl;
    }
    __syncthreads();
    for (uint32_t bits = mask; bits != 0; bits &= bits - 1) {
      const int k = __ffs(bits) - 1;
      const int slot = woff[warp * 32 + k] + __popc(wbits[warp * 32 + k] & ((1u << lane) - 1u));
      entries[slot] = (uint8_t)tid;
    }
    __syncthreads();

    // pass 2: d probs[q, k] += share * s_q over class k's list, in list order,
    // in a register; s_q recomputed from the staged window
    if (owner) {
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        if (k < K) {
          const int lo = lstart[k], hi = lstart[k + 1];
          const int mid = lo + (hi - lo + 1) / 2;
          const int e0 = parts == 2 && part == 1 ? mid : lo;
          const int e1 = parts == 2 && part == 0 ? mid : hi;
          float sum = 0.f;
          const float* iq = st.interp + pq;
#pragma unroll 4
          for (int e = e0; e < e1; ++e) {
            const int i = entries[e];
            const float4 info = pix[i];
            float s;
            if (STAGED) {
              s = lerp_sigmoid(iq[(size_t)__float_as_int(info.x) * qs],
                               iq[(size_t)__float_as_int(info.w) * qs], info.y);
            } else {
              s = sigmoid_at(mn + pq * plane,
                             pixel_taps(y0t + i / TILE_X, x0t + i % TILE_X, h, w, sy, sx));
            }
            sum = fmaf(info.z, s, sum);
          }
          dacc[k] += sum;
        }
      }
    }
  }
  if (owner) {
    float* out = partial + (((int64_t)n * chunks + chunk) * parts + part) * Q * K + pq * K;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k < K) out[k] = dacc[k];
    }
  }
}

// Kernel 2: dprobs[n, i] = sum over (chunk, part) of partial[n, chunk, part, i],
// in order.
__global__ void mask_scores_bwd_sum_kernel(const float* __restrict__ partial,
                                           float* __restrict__ dprobs,
                                           int slices, int QK, int64_t total) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= total) return;
  const int64_t n = j / QK, i = j % QK;
  const float* p = partial + n * slices * QK + i;
  float s = 0.f;
  for (int c = 0; c < slices; ++c) s += p[(int64_t)c * QK];
  dprobs[j] = s;
}

// Weight of low-resolution index t in output index i's two bilinear taps.
__device__ __forceinline__ float tap_weight(int i, float scale, int n_in, int t) {
  int i0, i1;
  float l;
  source_index(i, scale, n_in, &i0, &i1, &l);
  return (i0 == t ? 1.f - l : 0.f) + (i1 == t ? l : 0.f);
}

// Kernel 3: gridDim = (ceil(h * w / 256), Q, N). One thread per texel gathers
// the d up of the output pixels whose taps reach it.
__global__ void mask_scores_bwd_dmask_kernel(const float* __restrict__ masks,
                                             const float* __restrict__ probs,
                                             const uint32_t* __restrict__ tie_mask,
                                             const float* __restrict__ share,
                                             float* __restrict__ dmask, int Q,
                                             int K, int h, int w, int H, int W,
                                             float sy, float sx) {
  __shared__ float sp[MASK_SCORES_MAX_K];
  const int q = blockIdx.y, n = blockIdx.z;
  if (threadIdx.x < K) sp[threadIdx.x] = probs[((int64_t)n * Q + q) * K + threadIdx.x];
  __syncthreads();
  const int64_t texel = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (texel >= (int64_t)h * w) return;
  const int ty = (int)(texel / w), tx = (int)(texel % w);
  const float* mq = masks + ((int64_t)n * Q + q) * h * w;
  const int64_t HW = (int64_t)H * W;
  const uint32_t* tm = tie_mask + (int64_t)n * HW;
  const float* sh = share + (int64_t)n * HW;
  // output rows (columns) whose taps can reach ty (tx), with a margin: the
  // exact weight below decides
  const int ylo = max(0, (int)floorf((ty - 1.f) / sy) - 2);
  const int yhi = min(H - 1, (int)ceilf((ty + 2.f) / sy) + 2);
  const int xlo = max(0, (int)floorf((tx - 1.f) / sx) - 2);
  const int xhi = min(W - 1, (int)ceilf((tx + 2.f) / sx) + 2);
  float acc = 0.f;
  for (int y = ylo; y <= yhi; ++y) {
    const float wy = tap_weight(y, sy, h, ty);
    if (wy == 0.f) continue;
    for (int x = xlo; x <= xhi; ++x) {
      const float wx = tap_weight(x, sx, w, tx);
      if (wx == 0.f) continue;
      const int64_t pix = (int64_t)y * W + x;
      const uint32_t m = tm[pix];
      if (m == 0) continue;
      float ps = 0.f;
      for (uint32_t bits = m; bits != 0; bits &= bits - 1) ps += sp[__ffs(bits) - 1];
      const float s = sigmoid_at(mq, pixel_taps(y, x, h, w, sy, sx));
      acc += wy * wx * (sh[pix] * ps * s * (1.f - s));
    }
  }
  dmask[((int64_t)n * Q + q) * h * w + texel] = acc;
}


// Shared bytes of kernel 1 besides the probabilities and the window: per
// pixel (taps, lx, share), ballots, list offsets and starts, the lists (a
// byte an entry).
static size_t bwd_dp_extra_smem(int k) {
  return 16 * TILE_THREADS + 4 * (2 * TILE_THREADS + 36) + (size_t)TILE_THREADS * k;
}

// Kernel 1's launch plan; parts: pass-2 threads a query.
static int bwd_plan(int q, int k, int h, int w, int H, int W, TilePlan* p, int* parts) {
  if (q < 1 || q > BWD_MAX_QUERIES || k < 1 || k > MASK_SCORES_MAX_K || h < 1 || w < 1 ||
      H < 1 || W < 1) {
    return (int)cudaErrorInvalidValue;
  }
  *parts = q <= TILE_THREADS / 2 ? 2 : 1;
  return tile_plan(q, k, h, w, H, W, TILE_Y, bwd_dp_extra_smem(k), p);
}

typedef void (*BwdKernel)(const float*, const float*, const float*, float*, uint32_t*,
                          float*, int, int, int, int, int, int, float, float, int, int,
                          int, int, int);

static BwdKernel bwd_kernel(const TilePlan& p) {
  if (p.wh > 0) {
    return p.kmax == 20 ? mask_scores_bwd_dp_kernel<20, true>
                        : mask_scores_bwd_dp_kernel<32, true>;
  }
  return p.kmax == 20 ? mask_scores_bwd_dp_kernel<20, false>
                      : mask_scores_bwd_dp_kernel<32, false>;
}

// Blocks of kernel 1 that fit on one SM at once, for the caller's choice of
// chunks: a grid of at most one wave (a second wave of a few blocks would
// double the time).
extern "C" int mask_scores_backward_blocks_per_sm(int q, int k, int h, int w, int H, int W,
                                                  int* blocks) {
  TilePlan p;
  int parts;
  int rc = bwd_plan(q, k, h, w, H, W, &p, &parts);
  if (rc != 0) return rc;
  const BwdKernel kern = bwd_kernel(p);
  rc = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)p.smem);
  if (rc != 0) return rc;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern, TILE_THREADS, p.smem);
}

// Backward of mode 0. grad [N, H, W]; dprobs [N, Q, K] out; partial scratch
// [N, chunks, 2, Q, K]. dmask [N, Q, h, w] is computed only when not null, and
// then needs the scratch tie_mask (uint32) and share (f32), each [N, H, W].
// Q <= 256. Returns the first failed launch's cudaError, else cudaGetLastError().
extern "C" int mask_scores_backward(const void* masks, const void* probs,
                                    const void* grad, void* dprobs,
                                    void* partial, int chunks, void* dmask,
                                    void* tie_mask, void* share, int n, int q,
                                    int k, int h, int w, int H, int W,
                                    void* stream) {
  if (chunks < 1 || n > 65535 || chunks > 65535 ||
      (dmask != nullptr && (tie_mask == nullptr || share == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  TilePlan p;
  int parts;
  int rc = bwd_plan(q, k, h, w, H, W, &p, &parts);
  if (rc != 0) return rc;
  if (n == 0) return (int)cudaSuccess;
  const float sy = (float)h / (float)H;
  const float sx = (float)w / (float)W;
  cudaStream_t st = (cudaStream_t)stream;
  const BwdKernel kern = bwd_kernel(p);
  if (p.smem > 48 * 1024) {
    rc = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)p.smem);
    if (rc != 0) return rc;
  }
  kern<<<dim3(chunks, n), TILE_THREADS, p.smem, st>>>(
      (const float*)masks, (const float*)probs, (const float*)grad,
      (float*)partial, dmask != nullptr ? (uint32_t*)tie_mask : nullptr,
      dmask != nullptr ? (float*)share : nullptr, q, k, h, w, H, W, sy, sx, p.wh, p.ww,
      p.rs, p.qs, parts);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const int64_t total = (int64_t)n * q * k;
  mask_scores_bwd_sum_kernel<<<(unsigned int)((total + 255) / 256), 256, 0, st>>>(
      (const float*)partial, (float*)dprobs, chunks * parts, q * k, total);
  rc = (int)cudaGetLastError();
  if (rc != 0 || dmask == nullptr) return rc;
  const int64_t texels = (int64_t)h * w;
  dim3 grid((unsigned int)((texels + 255) / 256), (unsigned int)q, (unsigned int)n);
  mask_scores_bwd_dmask_kernel<<<grid, 256, 0, st>>>(
      (const float*)masks, (const float*)probs, (const uint32_t*)tie_mask,
      (const float*)share, (float*)dmask, q, k, h, w, H, W, sy, sx);
  return (int)cudaGetLastError();
}
