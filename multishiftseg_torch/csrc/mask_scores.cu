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
// Kernel 1 (mask_scores_bwd_dp_kernel), a few blocks per image, each walking
// tiles of 128 consecutive pixels. Pass 1, a thread per pixel: it recomputes
// the forward's K sums, keeping each sigmoid s_q in a [Q, 128] shared tile,
// and finds the max and the tie set (a bit mask). Pass 2, a thread per query:
// it adds share * s_q into its own row of d probs [Q, K] in shared memory,
// pixel by pixel, so nothing is contended and every sum runs in a fixed order.
// Each block writes its rows to a partial [N, chunks, Q * K]; kernel 2 sums
// the chunks in order: the result does not depend on the run.
// When d mask is asked, kernel 1 also stores each pixel's tie set and share,
// and kernel 3 gathers: one thread per low-resolution texel walks the output
// pixels whose bilinear taps reach it and sums their d up, weight by weight.
// No atomics to device memory anywhere.
// Bound at stage 1's shapes (16 x 704^2 from 176^2, Q = 100, K = 19): the
// forward's 4.9 k operations per pixel plus 2 per plane for d p, about
// 40 GFLOP, 0.60 ms at 67 TFLOP/s; masks 198 MB + g 32 MB read, 0.07 ms.
// Operations bound it; d mask adds 198 MB written.

#include <cuda_runtime.h>
#include <stdint.h>

#define MASK_SCORES_MAX_K 32
#define BWD_THREADS 128
// a row of the backward's sigmoid tile, padded: thread q reads row q's column
// i, banks (q + i) mod 32, conflict-free
#define TILE_ROW (BWD_THREADS + 1)

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

// acc[k] += p[k] * s for the K classes of one padded row p (16-byte aligned)
__device__ __forceinline__ void accumulate(float (&acc)[MASK_SCORES_MAX_K],
                                           const float* p, float s, int K) {
  const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int j = 0; j < MASK_SCORES_MAX_K / 4; ++j) {
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
    accumulate(acc, sprobs + q * KP, s, K);
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

// Kernel 1: gridDim = (chunks, N), BWD_THREADS threads, each iteration one
// tile of BWD_THREADS consecutive pixels. partial [N, chunks, Q * K];
// tie_mask / share [N, H * W] are written only when not null.
__global__ void __launch_bounds__(BWD_THREADS)
mask_scores_bwd_dp_kernel(const float* __restrict__ masks,
                          const float* __restrict__ probs,
                          const float* __restrict__ grad,
                          float* __restrict__ partial,
                          uint32_t* __restrict__ tie_mask,
                          float* __restrict__ share_out, int Q, int K, int h,
                          int w, int H, int W, float sy, float sx) {
  extern __shared__ float4 smem4[];
  const int QK = Q * K;
  const int KP = padded_classes(K);
  float* sprobs = reinterpret_cast<float*>(smem4);  // [Q][KP]
  float* sacc = sprobs + Q * KP;       // [Q * K]: row q summed by thread q alone
  float* ss = sacc + QK;               // [Q][TILE_ROW]: the tile's sigmoids
  float* tshare = ss + Q * TILE_ROW;   // [BWD_THREADS]
  uint32_t* tmask = reinterpret_cast<uint32_t*>(tshare + BWD_THREADS);
  const int n = blockIdx.y;
  const int chunk = blockIdx.x;
  const int chunks = gridDim.x;
  load_probs(probs + (int64_t)n * QK, sprobs, Q, K);
  for (int i = threadIdx.x; i < QK; i += blockDim.x) sacc[i] = 0.f;
  __syncthreads();

  const int64_t HW = (int64_t)H * W;
  const int64_t plane = (int64_t)h * w;
  const float* mn = masks + (int64_t)n * Q * plane;
  for (int64_t base = (int64_t)chunk * BWD_THREADS; base < HW;
       base += (int64_t)chunks * BWD_THREADS) {
    // pass 1, a thread per pixel: the forward's sums, the max and its ties
    const int64_t pix = base + threadIdx.x;
    const float g = pix < HW ? grad[(int64_t)n * HW + pix] : 0.f;
    uint32_t mask = 0;
    float share = 0.f;
    if (g != 0.f) {
      const Taps t = pixel_taps((int)(pix / W), (int)(pix % W), h, w, sy, sx);
      float acc[MASK_SCORES_MAX_K];
#pragma unroll
      for (int k = 0; k < MASK_SCORES_MAX_K; ++k) acc[k] = 0.f;
      const float* mq = mn;
      for (int q = 0; q < Q; ++q, mq += plane) {
        const float s = sigmoid_at(mq, t);
        ss[q * TILE_ROW + threadIdx.x] = s;
        accumulate(acc, sprobs + q * KP, s, K);
      }
      float mx = acc[0];
#pragma unroll
      for (int k = 1; k < MASK_SCORES_MAX_K; ++k) {
        if (k < K) mx = fmaxf(mx, acc[k]);
      }
#pragma unroll
      for (int k = 0; k < MASK_SCORES_MAX_K; ++k) {
        if (k < K && acc[k] == mx) mask |= 1u << k;
      }
      share = -g / (float)__popc(mask);
    }
    if (tie_mask != nullptr && pix < HW) {
      tie_mask[(int64_t)n * HW + pix] = mask;
      share_out[(int64_t)n * HW + pix] = share;
    }
    tmask[threadIdx.x] = mask;
    tshare[threadIdx.x] = share;
    __syncthreads();
    // pass 2, a thread per query: its row of d probs over the tile's pixels,
    // in pixel order (the pixel, hence the branch, is the same for all threads)
    for (int q = threadIdx.x; q < Q; q += BWD_THREADS) {
      const float* sq = ss + q * TILE_ROW;
      float* aq = sacc + q * K;
      for (int i = 0; i < BWD_THREADS; ++i) {
        const uint32_t m = tmask[i];
        if (m == 0) continue;
        const float v = tshare[i] * sq[i];
        for (uint32_t bits = m; bits != 0; bits &= bits - 1) aq[__ffs(bits) - 1] += v;
      }
    }
    __syncthreads();
  }
  float* out = partial + ((int64_t)n * chunks + chunk) * QK;
  for (int i = threadIdx.x; i < QK; i += blockDim.x) out[i] = sacc[i];
}

// Kernel 2: dprobs[n, i] = sum over chunks of partial[n, chunk, i], in order.
__global__ void mask_scores_bwd_sum_kernel(const float* __restrict__ partial,
                                           float* __restrict__ dprobs,
                                           int chunks, int QK, int64_t total) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= total) return;
  const int64_t n = j / QK, i = j % QK;
  const float* p = partial + n * chunks * QK + i;
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s += p[(int64_t)c * QK];
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

static size_t bwd_dp_smem(int q, int k) {
  return ((size_t)q * (padded_classes(k) + k + TILE_ROW) + 2 * BWD_THREADS) * sizeof(float);
}

// Blocks of kernel 1 that fit on one SM at once, for the caller's choice of
// chunks: a grid of at most one wave (a second wave of a few blocks would
// double the time).
extern "C" int mask_scores_backward_blocks_per_sm(int q, int k, int* blocks) {
  const size_t smem = bwd_dp_smem(q, k);
  if (q < 1 || k < 1 || smem > 232448) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(mask_scores_bwd_dp_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, mask_scores_bwd_dp_kernel, BWD_THREADS, smem);
}

// Backward of mode 0. grad [N, H, W]; dprobs [N, Q, K] out; partial scratch
// [N, chunks, Q, K]. dmask [N, Q, h, w] is computed only when not null, and
// then needs the scratch tie_mask (uint32) and share (f32), each [N, H, W].
// Returns the first failed launch's cudaError, else cudaGetLastError().
extern "C" int mask_scores_backward(const void* masks, const void* probs,
                                    const void* grad, void* dprobs,
                                    void* partial, int chunks, void* dmask,
                                    void* tie_mask, void* share, int n, int q,
                                    int k, int h, int w, int H, int W,
                                    void* stream) {
  if (k < 1 || k > MASK_SCORES_MAX_K || q < 1 || h < 1 || w < 1 || chunks < 1 ||
      n > 65535 || chunks > 65535 || q > 65535 ||
      (dmask != nullptr && (tie_mask == nullptr || share == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return (int)cudaSuccess;
  const float sy = (float)h / (float)H;
  const float sx = (float)w / (float)W;
  const size_t smem = bwd_dp_smem(q, k);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(mask_scores_bwd_dp_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  mask_scores_bwd_dp_kernel<<<dim3(chunks, n), BWD_THREADS, smem, st>>>(
      (const float*)masks, (const float*)probs, (const float*)grad,
      (float*)partial, dmask != nullptr ? (uint32_t*)tie_mask : nullptr,
      dmask != nullptr ? (float*)share : nullptr, q, k, h, w, H, W, sy, sx);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const int64_t total = (int64_t)n * q * k;
  mask_scores_bwd_sum_kernel<<<(unsigned int)((total + 255) / 256), 256, 0, st>>>(
      (const float*)partial, (float*)dprobs, chunks, q * k, total);
  rc = (int)cudaGetLastError();
  if (rc != 0 || dmask == nullptr) return rc;
  const int64_t texels = (int64_t)h * w;
  dim3 grid((unsigned int)((texels + 255) / 256), (unsigned int)q, (unsigned int)n);
  mask_scores_bwd_dmask_kernel<<<grid, 256, 0, st>>>(
      (const float*)masks, (const float*)probs, (const uint32_t*)tie_mask,
      (const float*)share, (float*)dmask, q, k, h, w, H, W, sy, sx);
  return (int)cudaGetLastError();
}
