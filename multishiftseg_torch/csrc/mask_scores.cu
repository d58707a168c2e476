// Fused Mask2Former score tail for Hopper (sm_90a): upsample, sigmoid and the
// query contraction in one pass per output pixel, and the anomaly score's
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
// each thread keeps its pixel's K sums in registers and nothing but the output
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
// Bound at the eval shapes (Q = 100, K = 19, 256x512 -> 1024x2048): anomaly
// reads 52 MB and writes 8.4 MB (18 us of memory) but does about
// 100 x (7 + 4 + 38) + 19 = 4.9 k f32 operations per pixel, 10.3 GFLOP in all,
// 0.15 ms at 67 TFLOP/s: operations bound it. Semantic writes 1.0 GB (0.31 ms),
// so bytes bound it.
//
// Backward. anomaly = 1 - max_k acc_k, acc_k = sum_q p_qk s_q. The gradient g
// of a pixel goes to the classes that reach the max, split evenly among them
// (JAX's rule for jnp.max): d acc_k = -g / ties. Then
//   d p[q, k] = sum over pixels of d acc_k * s_q      (a reduction over H * W)
//   d up_q    = s_q (1 - s_q) * sum_k d acc_k p_qk     (only when asked)
//   d mask    = the transpose of the bilinear upsample of d up.
// Kernel 1 (mask_scores_bwd_dp_kernel): a few blocks per image, 256 threads,
// each walking 2-D tiles of 8 x 32 output pixels; a tile with no gradient (the
// crop's margin) is skipped after one barrier.
//   * Staging. At 4x upsampling a tile's bilinear taps fall inside a window of
//     4 x 10 texels a query. The block copies that window of the Q planes to
//     shared memory with cp.async (16 KB at Q = 100), then interpolates each of
//     the tile's 8 rows vertically once (32 KB): a pixel's value is then one
//     horizontal interpolation of two shared-memory reads, the rows sharing
//     their vertical one. (When the window does not fit, as in a downsample,
//     the taps are read from global memory instead: dispatch by shape.)
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
//   * Both passes take the sigmoid with the fast exp and divide (__expf,
//     __fdividef; a few ulp, far inside the 1e-5 tolerance of d probs): the
//     IEEE ones cost several times the instructions, and the sigmoid is
//     most of pass 1's work.
// At the end each block writes its (query, half) sums to a partial [N,
// chunks, 2, Q * K]; kernel 2 sums the slices in order: the result does not
// depend on the run, and d probs is the same with or without d mask.
// Shared memory at Q = 100, K = 19: 66 KB a block, 3 blocks (24 warps) an SM.
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
// the backward's kernel 1: a tile of BWD_TY x BWD_TX output pixels, a thread each
#define BWD_THREADS 256
#define BWD_TY 8
#define BWD_TX 32
#define BWD_MAX_QUERIES BWD_THREADS  // pass 2: a thread (two when Q <= 128) a query
// a window staged only while two blocks fit on an SM; beyond, taps from global
#define BWD_STAGED_MAX_SMEM (113 * 1024)

// mode: 0 anomaly, 1 semantic (K + Q channels), 2 semantic classes (K channels)
struct Taps {
  int64_t o00, o01, o10, o11;
  float ly, lx;
};

__device__ __forceinline__ void source_index(int i, float scale, int n_in,
                                             int* i0, int* i1, float* l) {
  float src = ((float)i + 0.5f) * scale - 0.5f;
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

// sigmoid of the horizontal interpolation of two vertically interpolated taps
__device__ __forceinline__ float lerp_sigmoid(float a, float b, float lx) {
  const float v = (1.f - lx) * a + lx * b;
  return __fdividef(1.f, 1.f + __expf(-v));
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

// Probability rows in shared memory are padded to a multiple of 4 classes
// (zeros), so that a row is read as float4s: one shared load feeds four sums.
__host__ __device__ __forceinline__ int padded_classes(int k) { return (k + 3) & ~3; }

__device__ __forceinline__ void load_probs(const float* __restrict__ probs,
                                           float* sprobs, int Q, int K) {
  const int KP = padded_classes(K);
  for (int i = threadIdx.x; i < Q * KP; i += blockDim.x) {
    const int k = i % KP;
    sprobs[i] = k < K ? probs[(i / KP) * K + k] : 0.f;
  }
}

// acc[k] += p[k] * s for the K classes of one padded row p (16-byte aligned);
// KMAX (a multiple of 4, at least K) sums in registers
template <int KMAX>
__device__ __forceinline__ void accumulate(float (&acc)[KMAX], const float* p, float s,
                                           int K) {
  const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int j = 0; j < KMAX / 4; ++j) {
    if (4 * j < K) {
      const float4 v = p4[j];
      acc[4 * j] = fmaf(v.x, s, acc[4 * j]);
      acc[4 * j + 1] = fmaf(v.y, s, acc[4 * j + 1]);
      acc[4 * j + 2] = fmaf(v.z, s, acc[4 * j + 2]);
      acc[4 * j + 3] = fmaf(v.w, s, acc[4 * j + 3]);
    }
  }
}

template <int MODE>
__global__ void mask_scores_kernel(const float* __restrict__ masks,
                                   const float* __restrict__ probs,
                                   const float* __restrict__ keep_w,
                                   float* __restrict__ out, int Q, int K,
                                   int h, int w, int H, int W, float sy,
                                   float sx) {
  extern __shared__ float4 smem4[];
  float* sprobs = reinterpret_cast<float*>(smem4);  // [Q][KP]
  const int KP = padded_classes(K);
  float* skeep = sprobs + Q * KP;                     // [Q] (mode 1 only)
  const int n = blockIdx.y;
  load_probs(probs + (int64_t)n * Q * K, sprobs, Q, K);
  if (MODE == 1) {
    for (int i = threadIdx.x; i < Q; i += blockDim.x) {
      skeep[i] = keep_w[(int64_t)n * Q + i];
    }
  }
  __syncthreads();

  const int64_t HW = (int64_t)H * W;
  const int64_t pix = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= HW) return;
  const Taps t = pixel_taps((int)(pix / W), (int)(pix % W), h, w, sy, sx);

  float acc[MASK_SCORES_MAX_K];
#pragma unroll
  for (int k = 0; k < MASK_SCORES_MAX_K; ++k) acc[k] = 0.f;

  const int64_t plane = (int64_t)h * w;
  const float* mq = masks + (int64_t)n * Q * plane;
  for (int q = 0; q < Q; ++q, mq += plane) {
    const float s = sigmoid_at(mq, t);
    accumulate<MASK_SCORES_MAX_K>(acc, sprobs + q * KP, s, K);
    if (MODE == 1) {
      out[((int64_t)n * (K + Q) + K + q) * HW + pix] = skeep[q] * s;
    }
  }
  if (MODE == 0) {
    float mx = acc[0];
#pragma unroll
    for (int k = 1; k < MASK_SCORES_MAX_K; ++k) {
      if (k < K) mx = fmaxf(mx, acc[k]);
    }
    out[(int64_t)n * HW + pix] = 1.f - mx;
  } else {
    const int channels = MODE == 1 ? K + Q : K;
#pragma unroll
    for (int k = 0; k < MASK_SCORES_MAX_K; ++k) {
      if (k < K) out[((int64_t)n * channels + k) * HW + pix] = acc[k];
    }
  }
}

template <int MODE>
static int launch_forward(const float* masks, const float* probs,
                          const float* keep_w, float* out, int n, int q, int k,
                          int h, int w, int H, int W, cudaStream_t st) {
  const int threads = 256;
  const int64_t bx = ((int64_t)H * W + threads - 1) / threads;
  const size_t smem = (size_t)(q * padded_classes(k) + q) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(mask_scores_kernel<MODE>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  dim3 grid((unsigned int)bx, (unsigned int)n);
  mask_scores_kernel<MODE><<<grid, threads, smem, st>>>(
      masks, probs, keep_w, out, q, k, h, w, H, W, (float)h / (float)H,
      (float)w / (float)W);
  return (int)cudaGetLastError();
}

// mode: 0 = anomaly ([N, H, W] output, keep_w unused), 1 = semantic
// ([N, K + Q, H, W]), 2 = semantic classes only ([N, K, H, W], keep_w unused).
// Returns cudaGetLastError() after the launch.
extern "C" int mask_scores_forward(const void* masks, const void* probs,
                                   const void* keep_w, void* out, int n, int q,
                                   int k, int h, int w, int H, int W, int mode,
                                   void* stream) {
  if (k < 1 || k > MASK_SCORES_MAX_K || q < 1 || h < 1 || w < 1 || mode < 0 ||
      mode > 2) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t HW = (int64_t)H * W;
  if (n == 0 || HW == 0) return (int)cudaSuccess;
  if ((HW + 255) / 256 > 0x7fffffff || n > 65535) return (int)cudaErrorInvalidValue;
  const float* m = (const float*)masks;
  const float* p = (const float*)probs;
  const float* kw = (const float*)keep_w;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == 0) return launch_forward<0>(m, p, kw, o, n, q, k, h, w, H, W, st);
  if (mode == 1) return launch_forward<1>(m, p, kw, o, n, q, k, h, w, H, W, st);
  return launch_forward<2>(m, p, kw, o, n, q, k, h, w, H, W, st);
}

// Kernel 1: gridDim = (chunks, N), BWD_THREADS threads; each iteration one tile
// of BWD_TY x BWD_TX output pixels, a thread per pixel. STAGED: the tile's
// window of the Q planes is copied to shared memory (cp.async), each output
// row's vertical interpolation computed once into `interp`, and every tap read
// from there; else (a window too large for shared memory: downsampling, or
// many queries) the taps come from global memory. partial [N, chunks, parts,
// Q * K]; tie_mask / share [N, H * W] are written only when not null.
template <int KMAX, bool STAGED>
__global__ void __launch_bounds__(BWD_THREADS, KMAX == 20 ? 3 : 2)
mask_scores_bwd_dp_kernel(const float* __restrict__ masks,
                          const float* __restrict__ probs,
                          const float* __restrict__ grad,
                          float* __restrict__ partial,
                          uint32_t* __restrict__ tie_mask,
                          float* __restrict__ share_out, int Q, int K, int h,
                          int w, int H, int W, float sy, float sx, int wh, int ww,
                          int is, int parts) {
  extern __shared__ float4 smem4[];
  const int KP = padded_classes(K);
  float* sprobs = reinterpret_cast<float*>(smem4);            // [Q][KP]
  float4* pix = reinterpret_cast<float4*>(sprobs + Q * KP);   // [BWD_THREADS]
  uint32_t* wbits = reinterpret_cast<uint32_t*>(pix + BWD_THREADS);  // [warp][class]
  int* woff = reinterpret_cast<int*>(wbits + BWD_THREADS);    // [warp][class]
  int* lstart = woff + BWD_THREADS;                           // [33], padded to 36
  float* raw = reinterpret_cast<float*>(lstart + 36);         // [Q][wh][ww]
  float* interp = raw + (size_t)Q * wh * ww;                  // [Q][is]: [BWD_TY][ww]
  uint8_t* entries = reinterpret_cast<uint8_t*>(interp + (size_t)Q * is);
  const int n = blockIdx.y;
  const int chunk = blockIdx.x;
  const int chunks = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  load_probs(probs + (int64_t)n * Q * K, sprobs, Q, K);

  const int64_t HW = (int64_t)H * W;
  const int64_t plane = (int64_t)h * w;
  const float* mn = masks + (int64_t)n * Q * plane;
  const int tiles_x = (W + BWD_TX - 1) / BWD_TX;
  const int tiles = ((H + BWD_TY - 1) / BWD_TY) * tiles_x;
  const int ty = tid / BWD_TX, tx = tid % BWD_TX;
  // pass 2: thread (query pq, part) sums half of every class list (parts = 2)
  const int pq = tid % Q, part = tid / Q;
  const bool owner = tid < parts * Q;
  float dacc[KMAX];
#pragma unroll
  for (int k = 0; k < KMAX; ++k) dacc[k] = 0.f;
  __syncthreads();

  for (int tile = chunk; tile < tiles; tile += chunks) {
    const int y0t = (tile / tiles_x) * BWD_TY, x0t = (tile % tiles_x) * BWD_TX;
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
      int wy0, a, b;
      float l;
      source_index(y0t, sy, h, &wy0, &a, &l);
      source_index(min(y0t + BWD_TY, H) - 1, sy, h, &a, &b, &l);
      const int rows = b - wy0 + 1;
      source_index(x0t, sx, w, &wx0, &a, &l);
      source_index(min(x0t + BWD_TX, W) - 1, sx, w, &a, &b, &l);
      const int cols = b - wx0 + 1;
      if (rows > wh || cols > ww) __trap();  // the host sized the window with a margin
      // thread t copies element t % per of the queries t / per, + slots, ...
      // (per <= BWD_THREADS; a larger window takes several rounds)
      const int per = rows * cols;
      for (int e0 = 0; e0 < per; e0 += BWD_THREADS) {
        const int span = min(per - e0, BWD_THREADS), slots = BWD_THREADS / span;
        if (tid < slots * span) {
          const int e = e0 + tid % span, r = e / cols, c = e - r * cols;
          const float* src = mn + (int64_t)(wy0 + r) * w + wx0 + c;
          float* dst = raw + r * ww + c;
          for (int q = tid / span; q < Q; q += slots) {
            cp_async4(dst + (size_t)q * wh * ww, src + q * plane);
          }
        }
      }
      cp_async_wait_all();
      __syncthreads();
      // each output row's vertical interpolation, shared by its BWD_TX pixels
      const int per_i = BWD_TY * cols;
      for (int e0 = 0; e0 < per_i; e0 += BWD_THREADS) {
        const int span = min(per_i - e0, BWD_THREADS), slots = BWD_THREADS / span;
        const int e = e0 + tid % span, r = e / cols, c = e - r * cols;
        if (tid < slots * span && y0t + r < H) {
          int r0, r1;
          float ly;
          source_index(y0t + r, sy, h, &r0, &r1, &ly);
          const float* src0 = raw + (r0 - wy0) * ww + c;
          const float* src1 = raw + (r1 - wy0) * ww + c;
          float* dst = interp + r * ww + c;
          for (int q = tid / span; q < Q; q += slots) {
            const size_t at = (size_t)q * wh * ww;
            dst[(size_t)q * is] = (1.f - ly) * src0[at] + ly * src1[at];
          }
        }
      }
      __syncthreads();
    }

    // pass 1, a thread per pixel: the forward's sums, the max and its ties
    uint32_t mask = 0;
    float share = 0.f;
    if (g != 0.f) {
      float acc[KMAX];
#pragma unroll
      for (int k = 0; k < KMAX; ++k) acc[k] = 0.f;
      int c0 = 0, c1 = 0;  // the pixel's two taps in a query's interpolated rows
      float lx = 0.f;
      if (STAGED) {
        source_index(x, sx, w, &c0, &c1, &lx);
        c0 += ty * ww - wx0;
        c1 += ty * ww - wx0;
        const float* iq = interp;
        for (int q = 0; q < Q; ++q, iq += is) {
          accumulate<KMAX>(acc, sprobs + q * KP, lerp_sigmoid(iq[c0], iq[c1], lx), K);
        }
      } else {
        const Taps t = pixel_taps(y, x, h, w, sy, sx);
        const float* mq = mn;
        for (int q = 0; q < Q; ++q, mq += plane) {
          accumulate<KMAX>(acc, sprobs + q * KP, sigmoid_at(mq, t), K);
        }
      }
      float mx = acc[0];
#pragma unroll
      for (int k = 1; k < KMAX; ++k) {
        if (k < K) mx = fmaxf(mx, acc[k]);
      }
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        if (k < K && acc[k] == mx) mask |= 1u << k;
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
      for (int v = 0; v < BWD_THREADS / 32; ++v) {
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
      for (int v = 0; v < BWD_THREADS / 32; ++v) woff[v * 32 + lane] += start;
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
          const float* iq = interp + (size_t)pq * is;
#pragma unroll 4
          for (int e = e0; e < e1; ++e) {
            const int i = entries[e];
            const float4 info = pix[i];
            float s;
            if (STAGED) {
              s = lerp_sigmoid(iq[__float_as_int(info.x)], iq[__float_as_int(info.w)], info.y);
            } else {
              s = sigmoid_at(mn + pq * plane,
                             pixel_taps(y0t + i / BWD_TX, x0t + i % BWD_TX, h, w, sy, sx));
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


// Kernel 1's launch plan for these shapes.
struct BwdPlan {
  int wh, ww;  // the staged window's rows and columns; 0: taps from global memory
  int is;      // floats between two queries' interpolated rows (odd: no bank conflicts)
  int kmax;    // sums a thread keeps: 20 or 32
  int parts;   // pass-2 threads a query
  size_t smem;
};

// The most rows (columns) of n_in that one tile of `tile` outputs reaches,
// plus 2: the device's rounding of a source coordinate may differ from this
// double-precision count by one index at either end.
static int window_extent(int n_out, int n_in, int tile) {
  const double scale = (double)n_in / (double)n_out;
  int most = 0;
  for (int t0 = 0; t0 < n_out; t0 += tile) {
    const int t1 = (t0 + tile < n_out ? t0 + tile : n_out) - 1;
    const double a = fmin(fmax((t0 + 0.5) * scale - 0.5, 0.0), n_in - 1.0);
    const double b = fmin(fmax((t1 + 0.5) * scale - 0.5, 0.0), n_in - 1.0);
    const int i0 = (int)floor(a);
    const int i1 = (int)floor(b) + 1 < n_in ? (int)floor(b) + 1 : n_in - 1;
    if (i1 - i0 + 1 > most) most = i1 - i0 + 1;
  }
  return most + 2 < n_in ? most + 2 : n_in;
}

static size_t bwd_dp_smem(int q, int k, int wh, int ww, int is) {
  size_t bytes = (size_t)q * padded_classes(k) * 4  // probabilities
                 + 16 * BWD_THREADS                  // per pixel: columns, lx, share
                 + 4 * (2 * BWD_THREADS + 36);        // ballots, list offsets, starts
  bytes += (size_t)q * ((size_t)wh * ww + is) * 4;    // window and interpolated rows
  return bytes + (size_t)BWD_THREADS * k;             // the lists, a byte an entry
}

static int bwd_plan(int q, int k, int h, int w, int H, int W, BwdPlan* p) {
  if (q < 1 || q > BWD_MAX_QUERIES || k < 1 || k > MASK_SCORES_MAX_K || h < 1 || w < 1 ||
      H < 1 || W < 1) {
    return (int)cudaErrorInvalidValue;
  }
  p->kmax = k <= 20 ? 20 : 32;
  p->parts = q <= BWD_THREADS / 2 ? 2 : 1;
  p->wh = window_extent(H, h, BWD_TY);
  p->ww = window_extent(W, w, BWD_TX);
  p->is = (BWD_TY * p->ww) | 1;
  p->smem = bwd_dp_smem(q, k, p->wh, p->ww, p->is);
  if (p->smem > BWD_STAGED_MAX_SMEM) {
    p->wh = p->ww = p->is = 0;
    p->smem = bwd_dp_smem(q, k, 0, 0, 0);
  }
  return p->smem > 232448 ? (int)cudaErrorInvalidValue : (int)cudaSuccess;
}

typedef void (*BwdKernel)(const float*, const float*, const float*, float*, uint32_t*,
                          float*, int, int, int, int, int, int, float, float, int, int,
                          int, int);

static BwdKernel bwd_kernel(const BwdPlan& p) {
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
  BwdPlan p;
  int rc = bwd_plan(q, k, h, w, H, W, &p);
  if (rc != 0) return rc;
  const BwdKernel kern = bwd_kernel(p);
  rc = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)p.smem);
  if (rc != 0) return rc;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern, BWD_THREADS, p.smem);
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
  BwdPlan p;
  int rc = bwd_plan(q, k, h, w, H, W, &p);
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
  kern<<<dim3(chunks, n), BWD_THREADS, p.smem, st>>>(
      (const float*)masks, (const float*)probs, (const float*)grad,
      (float*)partial, dmask != nullptr ? (uint32_t*)tie_mask : nullptr,
      dmask != nullptr ? (float*)share : nullptr, q, k, h, w, H, W, sy, sx, p.wh, p.ww,
      p.is, p.parts);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const int64_t total = (int64_t)n * q * k;
  mask_scores_bwd_sum_kernel<<<(unsigned int)((total + 255) / 256), 256, 0, st>>>(
      (const float*)partial, (float*)dprobs, chunks * p.parts, q * k, total);
  rc = (int)cudaGetLastError();
  if (rc != 0 || dmask == nullptr) return rc;
  const int64_t texels = (int64_t)h * w;
  dim3 grid((unsigned int)((texels + 255) / 256), (unsigned int)q, (unsigned int)n);
  mask_scores_bwd_dmask_kernel<<<grid, 256, 0, st>>>(
      (const float*)masks, (const float*)probs, (const uint32_t*)tie_mask,
      (const float*)share, (float*)dmask, q, k, h, w, H, W, sy, sx);
  return (int)cudaGetLastError();
}
