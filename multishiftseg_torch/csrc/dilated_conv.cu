// 3x3 convolution at a large dilation (ASPP rates 12/24/36), stride 1, zero
// padding = rate, no bias, for Hopper (sm_90a). Forward and weight gradient.
//
// Replaces dilated_conv3x3 (multishiftseg_tpu/ops/dilated_conv.py:19), which the
// JAX package writes as nine zero-padded shifted [HW, Cin] x [Cin, Cout] products
// summed in f32 and rounded once to the input type. Here both directions are
// implicit GEMMs that gather the shifted input rows themselves (zero fill at the
// borders), so nothing padded or shifted is materialised.
//
// Layouts (the JAX package's): x [N, H, W, Cin]; weight per tap [9, Cout, Cin]
// (tap = 3 * ky + kx, its shift (dy, dx) = ((ky - 1) * rate, (kx - 1) * rate));
// out [N, H, W, Cout]; d weight [9, Cout, Cin] f32.
//
// Entries:
//   dconv_forward: out[p] = sum_taps x[p + shift] . W[tap]^T, f32 accumulation,
//     one rounding to the input type. The input gradient is this entry on the
//     output gradient with the flipped, transposed weight (the wrapper's doing).
//   dconv_wgrad: dW[tap] += sum_p g[p]^T x[p + shift] over the output pixels whose
//     shifted source lies in the map; the reduction over pixels is split over
//     blocks and summed by f32 atomics into a zeroed buffer.
//
// bf16 route: mma.sync m16n8k16 (bf16 in, f32 accumulate) fed by ldmatrix from a
// 3-stage cp.async ring; 128 x 128 block tiles, 8 warps of 64 x 32. The forward
// walks the reduction channel chunk by channel chunk, the nine taps inside each
// chunk, so the blocks in flight read one 64-byte channel slice of the whole map
// (2 MB at the eval shapes), which stays in L2 across taps. Taps whose shift
// leaves every pixel of a block outside the map are skipped; the weight gradient
// enumerates only the in-map pixels of each tap. f32 route (the f32 parity runs,
// TF32 off): plain FMAs, 64 x 64 tiles, 4 x 4 outputs a thread.
//
// Bound at the main-path shapes (chip_smoke.py counts it from in-map taps only):
// the eval forward (x [1, 128, 256, 4096] bf16, Cout 256, rates 12/24/36) does
// 1.9 TFLOP over 0.3 GB, and the training weight gradient (16 x 88 x 88) 4.6
// TFLOP: both are bound by the tensor cores' bf16 rate, not by memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int STAGES = 3;
// forward tiles: BM pixels x BN output channels, BK input channels a stage
constexpr int BM = 128, BN = 128, BK = 32;
constexpr int LDA = BK + 8;  // padded smem rows (80 bytes): conflict-free ldmatrix
// weight-gradient tiles: WM output channels x WN input channels, WK pixels a stage
constexpr int WM = 128, WN = 128, WK = 32;
constexpr int LDW = WM + 8;  // 272-byte rows
constexpr int FWD_SMEM = STAGES * (BM + BN) * LDA * 2;
constexpr int WGRAD_SMEM = STAGES * WK * (WM + WN + 16) * 2;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte async copy; src_bytes 0 fills the destination with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ bool inside(int v, int n) { return v >= 0 && v < n; }

// ---------------------------------------------------------------------------
// forward, bf16, tensor cores

__global__ void __launch_bounds__(THREADS) dconv_fwd_bf16(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    __nv_bfloat16* __restrict__ out, int N, int H, int W, int Cin, int Cout, int rate) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);  // [STAGES][BM][LDA]
  __nv_bfloat16* Bs = As + STAGES * BM * LDA;                     // [STAGES][BN][LDA]
  __shared__ int taps[9];
  __shared__ int ntaps;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // warp tile: 64 pixels x 32 channels
  const int64_t M = (int64_t)N * H * W;
  const int co0 = blockIdx.x * BN;
  const int64_t m0 = (int64_t)blockIdx.y * BM;

  // this thread copies one 16-byte chunk of two A rows (pixels) and two B rows
  const int chunk = tid & 3;
  int py[2], px[2];
  int64_t img[2];
  bool pin[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t m = m0 + (tid >> 2) + 64 * i;
    pin[i] = m < M;
    const int64_t mm = pin[i] ? m : 0;
    const int64_t hw = mm % ((int64_t)H * W);
    img[i] = (mm - hw);  // first pixel of the image
    py[i] = (int)(hw / W);
    px[i] = (int)(hw % W);
  }
  if (tid == 0) ntaps = 0;
  __syncthreads();
  for (int t = 0; t < 9; ++t) {
    const int dy = (t / 3 - 1) * rate, dx = (t % 3 - 1) * rate;
    bool any = false;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      any |= pin[i] && inside(py[i] + dy, H) && inside(px[i] + dx, W);
    any = __syncthreads_or(any);
    if (any && tid == 0) taps[ntaps++] = t;
  }
  __syncthreads();
  const int nt = ntaps;
  const int kchunks = (Cin + BK - 1) / BK;
  const int iters = nt * kchunks;

  auto load = [&](int it, int s) {
    const int t = taps[it % nt];
    const int k = (it / nt) * BK + chunk * 8;
    const int dy = (t / 3 - 1) * rate, dx = (t % 3 - 1) * rate;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = (tid >> 2) + 64 * i;
      const int sy = py[i] + dy, sx = px[i] + dx;
      const bool va = pin[i] && inside(sy, H) && inside(sx, W) && k < Cin;
      const __nv_bfloat16* src =
          va ? x + ((img[i] + (int64_t)sy * W + sx) * Cin + k) : x;
      cp_async16(As + (s * BM + r) * LDA + chunk * 8, src, va);
      const int co = co0 + r;
      const bool vb = co < Cout && k < Cin;
      const __nv_bfloat16* wsrc = vb ? w + (((int64_t)t * Cout + co) * Cin + k) : w;
      cp_async16(Bs + (s * BN + r) * LDA + chunk * 8, wsrc, vb);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < iters) load(s, s);
    cp_async_commit();
  }
  for (int it = 0; it < iters; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int s = it % STAGES;
    const __nv_bfloat16* as = As + s * BM * LDA;
    const __nv_bfloat16* bs = Bs + s * BN * LDA;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4(af[mt], as + (wm * 64 + mt * 16 + (lane & 15)) * LDA + kk + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t r[4];
        ldmatrix_x4(r, bs + (wn * 32 + j * 16 + (lane >> 4) * 8 + (lane & 7)) * LDA + kk +
                           ((lane >> 3) & 1) * 8);
        bf[2 * j][0] = r[0];
        bf[2 * j][1] = r[1];
        bf[2 * j + 1][0] = r[2];
        bf[2 * j + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int n8 = 0; n8 < 4; ++n8) mma_bf16(acc[mt][n8], af[mt], bf[n8][0], bf[n8][1]);
    }
    const int nxt = it + STAGES - 1;
    if (nxt < iters) load(nxt, nxt % STAGES);
    cp_async_commit();
  }
  cp_async_wait<0>();

  const int g = lane >> 2, t4 = lane & 3;
  const bool pairs = (Cout & 1) == 0;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int64_t m = m0 + wm * 64 + mt * 16 + g + half * 8;
      if (m >= M) continue;
#pragma unroll
      for (int n8 = 0; n8 < 4; ++n8) {
        const int co = co0 + wn * 32 + n8 * 8 + t4 * 2;
        const float v0 = acc[mt][n8][half * 2], v1 = acc[mt][n8][half * 2 + 1];
        __nv_bfloat16* o = out + m * Cout + co;
        if (pairs && co + 1 < Cout) {
          *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (co < Cout) o[0] = __float2bfloat16_rn(v0);
          if (co + 1 < Cout) o[1] = __float2bfloat16_rn(v1);
        }
      }
    }
}

// ---------------------------------------------------------------------------
// weight gradient, bf16, tensor cores
//
// Block (ci tile, co tile, tap * splits + split): dW[tap][co][ci] over a slice of
// the tap's in-map output pixels, enumerated row segment by row segment: pixel q
// of the tap is image n, row y in [y_lo, y_hi), column x_lo + c, c < L.

struct SegCursor {
  int n, y, c;  // image, row, offset in the row segment
};

__device__ __forceinline__ void seg_advance(SegCursor& s, int step, int L, int y_lo,
                                            int y_hi) {
  s.c += step;
  while (s.c >= L) {
    s.c -= L;
    if (++s.y == y_hi) {
      s.y = y_lo;
      ++s.n;
    }
  }
}

struct TapRange {
  int dy, dx, y_lo, y_hi, x_lo, x_hi;
  int64_t count;  // in-map output pixels of the tap
};

__device__ __forceinline__ TapRange tap_range(int t, int N, int H, int W, int rate) {
  TapRange r;
  r.dy = (t / 3 - 1) * rate;
  r.dx = (t % 3 - 1) * rate;
  r.y_lo = max(0, -r.dy);
  r.y_hi = min(H, H - r.dy);
  r.x_lo = max(0, -r.dx);
  r.x_hi = min(W, W - r.dx);
  r.count = (r.y_lo < r.y_hi && r.x_lo < r.x_hi)
                ? (int64_t)N * (r.y_hi - r.y_lo) * (r.x_hi - r.x_lo)
                : 0;
  return r;
}

__global__ void __launch_bounds__(THREADS) dconv_wgrad_bf16(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ gout,
    float* __restrict__ dw, int N, int H, int W, int Cin, int Cout, int rate, int splits) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Gs = reinterpret_cast<__nv_bfloat16*>(smem);  // [STAGES][WK][LDW] (co)
  __nv_bfloat16* Xs = Gs + STAGES * WK * LDW;                     // [STAGES][WK][LDW] (ci)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // warp tile: 64 co x 32 ci
  const int ci0 = blockIdx.x * WN, co0 = blockIdx.y * WM;
  const int t = blockIdx.z / splits, split = blockIdx.z % splits;
  const TapRange tr = tap_range(t, N, H, W, rate);
  const int64_t per = ((tr.count + splits - 1) / splits + WK - 1) / WK * WK;
  const int64_t q_begin = per * split;
  const int64_t q_end = min(tr.count, q_begin + per);
  if (q_begin >= q_end) return;
  const int L = tr.x_hi - tr.x_lo, rows = tr.y_hi - tr.y_lo;
  const int iters = (int)((q_end - q_begin + WK - 1) / WK);

  // this thread copies one 16-byte chunk of two pixel rows of each tile
  const int chunk = tid & 15;
  const int prow = tid >> 4;  // and prow + 16
  SegCursor cur;
  {
    const int64_t per_img = (int64_t)rows * L;
    cur.n = (int)(q_begin / per_img);
    const int64_t rem = q_begin % per_img;
    cur.y = tr.y_lo + (int)(rem / L);
    cur.c = (int)(rem % L);
  }
  int64_t q_next = q_begin;

  auto load = [&](int s) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = prow + 16 * i;
      SegCursor p = cur;
      seg_advance(p, r, L, tr.y_lo, tr.y_hi);
      const bool v = q_next + r < q_end;
      const int64_t pout = ((int64_t)p.n * H + p.y) * W + tr.x_lo + p.c;
      const int64_t psrc = pout + (int64_t)tr.dy * W + tr.dx;
      const int co = co0 + chunk * 8, ci = ci0 + chunk * 8;
      const bool vg = v && co < Cout, vx = v && ci < Cin;
      cp_async16(Gs + (s * WK + r) * LDW + chunk * 8, vg ? gout + pout * Cout + co : gout, vg);
      cp_async16(Xs + (s * WK + r) * LDW + chunk * 8, vx ? x + psrc * Cin + ci : x, vx);
    }
    seg_advance(cur, WK, L, tr.y_lo, tr.y_hi);
    q_next += WK;
  };

  float acc[4][4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < iters) load(s);
    cp_async_commit();
  }
  for (int it = 0; it < iters; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int s = it % STAGES;
    const __nv_bfloat16* gs = Gs + s * WK * LDW;
    const __nv_bfloat16* xs = Xs + s * WK * LDW;
    const int mat = lane >> 3, r8 = lane & 7;
#pragma unroll
    for (int kk = 0; kk < WK; kk += 16) {
      uint32_t af[4][4], bf[4][2];
      // A = g^T (co x pixels) from Gs[pixel][co], transposed on load
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4_trans(af[mt], gs + (kk + (mat >> 1) * 8 + r8) * LDW + wm * 64 + mt * 16 +
                                      (mat & 1) * 8);
      // B = x (pixels x ci) from Xs[pixel][ci], transposed on load
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, xs + (kk + (mat & 1) * 8 + r8) * LDW + wn * 32 + j * 16 +
                                 (mat >> 1) * 8);
        bf[2 * j][0] = r[0];
        bf[2 * j][1] = r[1];
        bf[2 * j + 1][0] = r[2];
        bf[2 * j + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int n8 = 0; n8 < 4; ++n8) mma_bf16(acc[mt][n8], af[mt], bf[n8][0], bf[n8][1]);
    }
    const int nxt = it + STAGES - 1;
    if (nxt < iters) load(nxt % STAGES);
    cp_async_commit();
  }
  cp_async_wait<0>();

  const int g = lane >> 2, t4 = lane & 3;
  float* dwt = dw + (int64_t)t * Cout * Cin;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int co = co0 + wm * 64 + mt * 16 + g + half * 8;
      if (co >= Cout) continue;
#pragma unroll
      for (int n8 = 0; n8 < 4; ++n8) {
        const int ci = ci0 + wn * 32 + n8 * 8 + t4 * 2;
        if (ci < Cin) atomicAdd(dwt + (int64_t)co * Cin + ci, acc[mt][n8][half * 2]);
        if (ci + 1 < Cin) atomicAdd(dwt + (int64_t)co * Cin + ci + 1, acc[mt][n8][half * 2 + 1]);
      }
    }
}

// ---------------------------------------------------------------------------
// f32 routes (plain FMAs; the parity runs with TF32 off)

constexpr int FT = 64, FK = 16;

__global__ void __launch_bounds__(THREADS) dconv_fwd_f32(const float* __restrict__ x,
                                                         const float* __restrict__ w,
                                                         float* __restrict__ out, int N, int H,
                                                         int W, int Cin, int Cout, int rate) {
  __shared__ float As[FK][FT + 4];  // [channel][pixel]
  __shared__ float Bs[FK][FT + 4];  // [channel][out channel]
  __shared__ int taps[9];
  __shared__ int ntaps;
  const int tid = threadIdx.x;
  const int64_t M = (int64_t)N * H * W;
  const int co0 = blockIdx.x * FT;
  const int64_t m0 = (int64_t)blockIdx.y * FT;
  // loads: pixel / out channel tid / 4, channels (tid % 4) * 4 .. + 3
  const int lr = tid >> 2, lk = (tid & 3) * 4;
  const int64_t m = m0 + lr;
  const bool pin = m < M;
  const int64_t hw = (pin ? m : 0) % ((int64_t)H * W);
  const int64_t img = (pin ? m : 0) - hw;
  const int py = (int)(hw / W), px = (int)(hw % W);
  if (tid == 0) ntaps = 0;
  __syncthreads();
  for (int t = 0; t < 9; ++t) {
    const int dy = (t / 3 - 1) * rate, dx = (t % 3 - 1) * rate;
    const bool any = __syncthreads_or(pin && inside(py + dy, H) && inside(px + dx, W));
    if (any && tid == 0) taps[ntaps++] = t;
  }
  __syncthreads();
  // compute: pixels ty * 4 .. + 3, out channels tx * 4 .. + 3
  const int tx = tid & 15, ty = tid >> 4;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < Cin; k0 += FK) {
    for (int ti = 0; ti < ntaps; ++ti) {
      const int t = taps[ti];
      const int dy = (t / 3 - 1) * rate, dx = (t % 3 - 1) * rate;
      const int sy = py + dy, sx = px + dx;
      const bool va = pin && inside(sy, H) && inside(sx, W);
      const float* xs = x + (img + (int64_t)sy * W + sx) * Cin;
      const int co = co0 + lr;
      const float* ws = w + ((int64_t)t * Cout + co) * Cin;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + lk + j;
        As[lk + j][lr] = (va && k < Cin) ? xs[k] : 0.f;
        Bs[lk + j][lr] = (co < Cout && k < Cin) ? ws[k] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < FK; ++k) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = As[k][ty * 4 + i];
          b[i] = Bs[k][tx * 4 + i];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t mo = m0 + ty * 4 + i;
    if (mo >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = co0 + tx * 4 + j;
      if (co < Cout) out[mo * Cout + co] = acc[i][j];
    }
  }
}

__global__ void __launch_bounds__(THREADS) dconv_wgrad_f32(const float* __restrict__ x,
                                                           const float* __restrict__ gout,
                                                           float* __restrict__ dw, int N, int H,
                                                           int W, int Cin, int Cout, int rate,
                                                           int splits) {
  __shared__ float Gs[FK][FT + 4];  // [pixel][out channel]
  __shared__ float Xs[FK][FT + 4];  // [pixel][in channel]
  const int tid = threadIdx.x;
  const int ci0 = blockIdx.x * FT, co0 = blockIdx.y * FT;
  const int t = blockIdx.z / splits, split = blockIdx.z % splits;
  const TapRange tr = tap_range(t, N, H, W, rate);
  const int64_t per = ((tr.count + splits - 1) / splits + FK - 1) / FK * FK;
  const int64_t q_begin = per * split;
  const int64_t q_end = min(tr.count, q_begin + per);
  if (q_begin >= q_end) return;
  const int L = tr.x_hi - tr.x_lo, rows = tr.y_hi - tr.y_lo;
  // loads: pixel row tid / 16, channels (tid % 16) * 4 .. + 3
  const int lr = tid >> 4, lc = (tid & 15) * 4;
  const int tx = tid & 15, ty = tid >> 4;  // compute: co ty * 4 .., ci tx * 4 ..
  float acc[4][4] = {};
  for (int64_t q0 = q_begin; q0 < q_end; q0 += FK) {
    const int64_t q = q0 + lr;
    const bool v = q < q_end;
    const int64_t qq = v ? q : q_begin;
    const int64_t per_img = (int64_t)rows * L;
    const int n = (int)(qq / per_img);
    const int64_t rem = qq % per_img;
    const int64_t pout = ((int64_t)n * H + tr.y_lo + rem / L) * W + tr.x_lo + rem % L;
    const int64_t psrc = pout + (int64_t)tr.dy * W + tr.dx;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = co0 + lc + j, ci = ci0 + lc + j;
      Gs[lr][lc + j] = (v && co < Cout) ? gout[pout * Cout + co] : 0.f;
      Xs[lr][lc + j] = (v && ci < Cin) ? x[psrc * Cin + ci] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = Gs[k][ty * 4 + i];
        b[i] = Xs[k][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* dwt = dw + (int64_t)t * Cout * Cin;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int co = co0 + ty * 4 + i;
    if (co >= Cout) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ci = ci0 + tx * 4 + j;
      if (ci < Cin) atomicAdd(dwt + (int64_t)co * Cin + ci, acc[i][j]);
    }
  }
}

int ceil_div(int64_t a, int64_t b) { return (int)((a + b - 1) / b); }

// split the pixel reduction so that the grid holds about 16 blocks an SM
int wgrad_splits(int64_t pixels, int tiles, int step) {
  const int64_t target = 132 * 16;
  int64_t s = (target + 9 * (int64_t)tiles - 1) / (9 * (int64_t)tiles);
  const int64_t most = (pixels + step - 1) / step;
  if (s > most) s = most;
  if (s < 1) s = 1;
  return (int)s;
}

}  // namespace

// dtype: 0 = f32, 1 = bf16. bf16 needs Cin and Cout multiples of 8 and 16-byte
// aligned tensors (the wrapper pads). Returns cudaGetLastError() after the launch.
extern "C" int dconv_forward(const void* x, const void* w, void* out, int n, int h, int wd,
                             int cin, int cout, int rate, int dtype, void* stream) {
  if (n < 0 || h < 1 || wd < 1 || cin < 1 || cout < 1 || rate < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t m = (int64_t)n * h * wd;
  if (m == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1) {
    if ((cin & 7) || (((uintptr_t)x | (uintptr_t)w) & 15)) return (int)cudaErrorMisalignedAddress;
    if (ceil_div(m, BM) > 65535) return (int)cudaErrorInvalidValue;
    static bool attr = false;
    if (!attr) {
      cudaFuncSetAttribute(dconv_fwd_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, FWD_SMEM);
      attr = true;
    }
    dim3 grid(ceil_div(cout, BN), ceil_div(m, BM));
    dconv_fwd_bf16<<<grid, THREADS, FWD_SMEM, st>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (__nv_bfloat16*)out, n, h, wd, cin,
        cout, rate);
  } else if (dtype == 0) {
    if (ceil_div(m, FT) > 65535) return (int)cudaErrorInvalidValue;
    dim3 grid(ceil_div(cout, FT), ceil_div(m, FT));
    dconv_fwd_f32<<<grid, THREADS, 0, st>>>((const float*)x, (const float*)w, (float*)out, n, h,
                                             wd, cin, cout, rate);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// dw: f32 [9, Cout, Cin], zeroed by the caller (the blocks add into it).
extern "C" int dconv_wgrad(const void* x, const void* g, void* dw, int n, int h, int wd, int cin,
                           int cout, int rate, int dtype, void* stream) {
  if (n < 0 || h < 1 || wd < 1 || cin < 1 || cout < 1 || rate < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t m = (int64_t)n * h * wd;
  if (m == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1) {
    if ((cin & 7) || (cout & 7) || (((uintptr_t)x | (uintptr_t)g) & 15))
      return (int)cudaErrorMisalignedAddress;
    static bool attr = false;
    if (!attr) {
      cudaFuncSetAttribute(dconv_wgrad_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           WGRAD_SMEM);
      attr = true;
    }
    const int tiles = ceil_div(cin, WN) * ceil_div(cout, WM);
    const int splits = wgrad_splits(m, tiles, WK);
    if ((int64_t)9 * splits > 65535) return (int)cudaErrorInvalidValue;
    dim3 grid(ceil_div(cin, WN), ceil_div(cout, WM), 9 * splits);
    dconv_wgrad_bf16<<<grid, THREADS, WGRAD_SMEM, st>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)g, (float*)dw, n, h, wd, cin, cout, rate,
        splits);
  } else if (dtype == 0) {
    const int tiles = ceil_div(cin, FT) * ceil_div(cout, FT);
    const int splits = wgrad_splits(m, tiles, FK);
    if ((int64_t)9 * splits > 65535) return (int)cudaErrorInvalidValue;
    dim3 grid(ceil_div(cin, FT), ceil_div(cout, FT), 9 * splits);
    dconv_wgrad_f32<<<grid, THREADS, 0, st>>>((const float*)x, (const float*)g, (float*)dw, n, h,
                                               wd, cin, cout, rate, splits);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
