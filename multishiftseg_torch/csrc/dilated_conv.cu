// 3x3 convolution at a large dilation (ASPP rates 12/24/36), stride 1, zero
// padding = rate, no bias, for Hopper (sm_90a). Forward and weight gradient.
//
// Replaces dilated_conv3x3 (multishiftseg_tpu/ops/dilated_conv.py:19), which the
// JAX package writes as nine zero-padded shifted [HW, Cin] x [Cin, Cout] products
// summed in f32 and rounded once to the input type. Here both directions are
// implicit GEMMs over the shifted input itself, so nothing padded or shifted is
// materialised.
//
// Layouts (the JAX package's): x [N, H, W, Cin]; weight per tap [9, Cout, Cin]
// (tap = 3 * ky + kx, its shift (dy, dx) = ((ky - 1) * rate, (kx - 1) * rate));
// out [N, H, W, Cout]; d weight [9, Cout, Cin] f32.
//
// Entries:
//   dconv_forward: out[p] = sum_taps x[p + shift] . W[tap]^T, f32 accumulation,
//     one rounding to the input type. The input gradient is this entry on the
//     output gradient with the flipped, transposed weight (the wrapper's doing).
//   dconv_wgrad: dW[tap] += sum_p g[p]^T x[p + shift] over the output pixels;
//     the reduction over pixels is split over blocks and summed by f32 vector
//     atomics into a zeroed buffer.
//
// What bounds it: the tensor cores. At the main-path shapes the forward does
// 1.52 TFLOP of in-map taps (eval: x [1, 128, 256, 4096] bf16 -> 256, rates
// 12/24/36, 0.3 GB moved) and 4.73 TFLOP at the training shapes (16 x 88 x 88);
// the weight gradient 4.73 TFLOP there. At 989 TFLOP/s that is 1.5 and 4.8 ms,
// against 0.1-0.4 ms for their bytes at 3.35 TB/s.
//
// bf16 design (warp-specialised, TMA + wgmma, one block an SM):
//   * 384 threads: one producer warpgroup (one thread issues every load, the
//     group gives its registers away with setmaxnreg) and two consumer
//     warpgroups that run wgmma.mma_async with f32 accumulators in registers.
//   * A ring of 4 stages of 48 KB in shared memory, each with a full and an
//     empty mbarrier; TMA tiled loads with the 128-byte swizzle, so a
//     64-channel row of bf16 is one swizzle row and wgmma reads the tiles as
//     they land. TMA fills every coordinate outside the tensor with zeros,
//     negative ones included: that is the conv's zero padding, so the kernels
//     have no border code. A tap whose shifted box misses the map is skipped
//     for speed only.
//   * Forward: a block computes 8 x 16 output pixels of one image by 256 output
//     channels (all of Cout = 256, so each shifted input box is fetched once).
//     A stage holds the input box [64 channels, 16 cols, 8 rows] at the tap's
//     shifted coordinates (16 KB) and the tap's weight tile [256 Cout, 64 Cin]
//     (32 KB); each consumer warpgroup takes 64 pixels with four
//     m64n256k16 products (both operands K-major), 128 f32 registers a thread.
//     The reduction walks channel blocks outer and taps inner, so the blocks
//     in flight share one 64-channel slice of the map in L2. Per 64-channel
//     step a block reads 9 x 48 KB from L2, of which 288 KB are weights.
//     Epilogue: one rounding to bf16, stored from registers for the pixels
//     inside the map and the channels below Cout.
//   * Weight gradient: a block computes dW[tap] for 256 Cout x 128 Cin over one
//     slice of the tap's in-map output rectangle, walked as 8 x 8 pixel boxes
//     (the reduction step: 64 pixels). A stage holds g's box [256 channels] at
//     the output coordinates (four 64-channel boxes, 32 KB) and x's box
//     [128 channels] at the shifted ones (16 KB). A = g^T and B = x lie
//     M- and N-major in shared memory; wgmma takes them so through its
//     transpose bits. Each consumer warpgroup holds 128 Cout x 128 Cin in two
//     m64n128k16 accumulators. Zero fill makes every product outside the map
//     0, so the boxes need not fit the rectangle. The block adds its tile into
//     dW with one float4 atomic (red.global.add.v4.f32) per 4 entries. The grid
//     runs the nine taps of one channel tile side by side (tap fastest), then
//     the channel tiles of one pixel slice, so x's shifted windows and g's
//     slice are shared in L2.
//   Tensor maps are encoded on the host through the driver's
//   cuTensorMapEncodeTiled, found with cudaGetDriverEntryPoint (no -lcuda), and
//   passed as __grid_constant__ parameters.
//
// f32 route (the f32 parity runs, TF32 off): plain FMAs, 64 x 64 tiles, 4 x 4
// outputs a thread.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // the f32 route's blocks

// ---------------------------------------------------------------------------
// Hopper primitives (PTX)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// wait until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads or writes across a wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile whose 1024-byte
// swizzle atoms are 1024-byte aligned: lbo / sbo in bytes
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// D[64 x 256] += A[64 x 16] B[16 x 256], bf16 in, f32 accumulate, both K-major
__device__ __forceinline__ void wgmma_m64n256_kk(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] B[16 x 128], A M-major and B N-major (transposed)
__device__ __forceinline__ void wgmma_m64n128_mn(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// ---------------------------------------------------------------------------
// bf16 kernels: shared layout

constexpr int STAGES = 4;
constexpr int KB = 64;  // bf16 channels a swizzle row (128 bytes)
constexpr int BOX = KB * 64 * 2;  // 8 KB: a 64-channel box of 64 pixels
constexpr int STAGE_BYTES = 6 * BOX;  // 48 KB
constexpr int WS_THREADS = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int WS_SMEM = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;  // + alignment, barriers
constexpr int CONSUMER_WARPS = 8;

struct Ring {
  uint32_t base;  // stage s at base + s * STAGE_BYTES, 1024-byte aligned
  __device__ uint32_t stage(int s) const { return base + s * STAGE_BYTES; }
  __device__ uint32_t full(int s) const { return base + STAGES * STAGE_BYTES + 8 * s; }
  __device__ uint32_t empty(int s) const { return base + STAGES * STAGE_BYTES + 8 * (STAGES + s); }
};

__device__ __forceinline__ Ring ring_init() {
  extern __shared__ unsigned char smem_raw[];
  Ring r{(smem_u32(smem_raw) + 1023u) & ~1023u};
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(r.full(s), 1);
      mbar_init(r.empty(s), CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return r;
}

// ---------------------------------------------------------------------------
// forward, bf16: block = 8 x 16 output pixels of one image x 256 output channels

constexpr int FR = 8, FC = 16;  // pixel tile rows, cols

__global__ void __launch_bounds__(WS_THREADS, 1)
    dconv_fwd_wgmma(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wmap, __nv_bfloat16* __restrict__ out,
                    int H, int W, int Cin, int Cout, int rate, int tiles_x, int tiles_y) {
  const int tile = blockIdx.x;
  const int x0 = (tile % tiles_x) * FC, y0 = (tile / tiles_x % tiles_y) * FR;
  const int n = tile / (tiles_x * tiles_y);
  const int co0 = blockIdx.y * 256;
  // taps whose shifted box meets the map for this tile's in-map pixels
  const int rows = min(FR, H - y0), cols = min(FC, W - x0);
  uint32_t mask = 0;
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    const int sy = y0 + (t / 3 - 1) * rate, sx = x0 + (t % 3 - 1) * rate;
    if (sy < H && sy + rows > 0 && sx < W && sx + cols > 0) mask |= 1u << t;
  }
  const int iters = __popc(mask) * ((Cin + KB - 1) / KB);
  const Ring ring = ring_init();

  if (threadIdx.x < 128) {  // producer
    regs_dec<40>();
    if (threadIdx.x == 0) {
      int t = -1, k = 0;
      for (int it = 0; it < iters; ++it) {
        // next tap of the mask; after the last, the next channel block
        uint32_t rest = t < 0 ? mask : mask & (~0u << (t + 1));
        if (!rest) {
          rest = mask;
          k += KB;
        }
        t = __ffs(rest) - 1;
        const int s = it % STAGES;
        mbar_wait(ring.empty(s), ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(ring.full(s), STAGE_BYTES);
        const uint32_t a = ring.stage(s);
        tma_load_4d(a, &xmap, ring.full(s), k, x0 + (t % 3 - 1) * rate, y0 + (t / 3 - 1) * rate,
                    n);
        tma_load_3d(a + 2 * BOX, &wmap, ring.full(s), k, co0, t);
      }
    }
  } else {  // consumers: warpgroup wg takes tile pixels [64 wg, 64 wg + 64)
    regs_inc<232>();
    const int wg = (threadIdx.x >> 7) - 1;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    fence_regs(acc);
    for (int it = 0; it < iters; ++it) {
      const int s = it % STAGES;
      mbar_wait(ring.full(s), (it / STAGES) & 1);
      const uint32_t a = ring.stage(s) + wg * BOX, b = ring.stage(s) + 2 * BOX;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KB / 16; ++kk)
        wgmma_m64n256_kk(acc, desc_sw128(a + 32 * kk, 16, 1024), desc_sw128(b + 32 * kk, 16, 1024));
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done: release it
      if (it > 0 && lane == 0) mbar_arrive(ring.empty((it - 1) % STAGES));
    }
    wgmma_wait<0>();
    fence_regs(acc);
    // accumulator i: row 16 warp + lane / 4 (+ 8 for i % 4 >= 2), column
    // 8 (i / 4) + 2 (lane % 4) + i % 2
    const bool pairs = (Cout & 1) == 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = wg * 64 + warp * 16 + (lane >> 2) + 8 * h;
      const int y = y0 + p / FC, x = x0 + p % FC;
      if (y >= H || x >= W) continue;
      __nv_bfloat16* o = out + (((int64_t)n * H + y) * W + x) * Cout;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int co = co0 + 8 * j + 2 * (lane & 3);
        const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        if (pairs && co + 1 < Cout) {
          *reinterpret_cast<__nv_bfloat162*>(o + co) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (co < Cout) o[co] = __float2bfloat16_rn(v0);
          if (co + 1 < Cout) o[co + 1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// weight gradient, bf16: block = (tap, 128 input channels, 256 output channels
// x a slice of the tap's in-map output pixels)

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

constexpr int PB = 8;  // pixel box side: 8 x 8 = 64 pixels a stage

__global__ void __launch_bounds__(WS_THREADS, 1)
    dconv_wgrad_wgmma(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap gmap, float* __restrict__ dw, int N,
                      int H, int W, int Cin, int Cout, int rate, int slices) {
  const int t = blockIdx.x, ci0 = blockIdx.y * 128;
  const int slice = blockIdx.z % slices, co0 = blockIdx.z / slices * 256;
  const TapRange tr = tap_range(t, N, H, W, rate);
  if (tr.count == 0) return;
  const int nbx = (tr.x_hi - tr.x_lo + PB - 1) / PB;
  const int per_img = (tr.y_hi - tr.y_lo + PB - 1) / PB * nbx;
  const int64_t boxes = (int64_t)N * per_img;
  const int64_t b0 = boxes * slice / slices;
  const int iters = (int)(boxes * (slice + 1) / slices - b0);
  if (iters <= 0) return;
  const Ring ring = ring_init();

  if (threadIdx.x < 128) {  // producer
    regs_dec<40>();
    if (threadIdx.x == 0) {
      for (int it = 0; it < iters; ++it) {
        const int64_t b = b0 + it;
        const int n = (int)(b / per_img), r = (int)(b % per_img);
        const int y = tr.y_lo + r / nbx * PB, x = tr.x_lo + r % nbx * PB;
        const int s = it % STAGES;
        mbar_wait(ring.empty(s), ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(ring.full(s), STAGE_BYTES);
        const uint32_t st = ring.stage(s);
#pragma unroll
        for (int c = 0; c < 4; ++c) tma_load_4d(st + c * BOX, &gmap, ring.full(s), co0 + KB * c, x, y, n);
#pragma unroll
        for (int c = 0; c < 2; ++c)
          tma_load_4d(st + (4 + c) * BOX, &xmap, ring.full(s), ci0 + KB * c, x + tr.dx, y + tr.dy,
                      n);
      }
    }
  } else {  // consumers: warpgroup wg takes output channels [128 wg, 128 wg + 128)
    regs_inc<232>();
    const int wg = (threadIdx.x >> 7) - 1;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    float acc[2][64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[0][i] = acc[1][i] = 0.f;
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    for (int it = 0; it < iters; ++it) {
      const int s = it % STAGES;
      mbar_wait(ring.full(s), (it / STAGES) & 1);
      const uint32_t g = ring.stage(s) + 2 * wg * BOX, xs = ring.stage(s) + 4 * BOX;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // 16 pixels = 16 rows of 128 bytes
        const uint64_t db = desc_sw128(xs + 2048 * kk, BOX, 1024);
#pragma unroll
        for (int mb = 0; mb < 2; ++mb)
          wgmma_m64n128_mn(acc[mb], desc_sw128(g + mb * BOX + 2048 * kk, BOX, 1024), db);
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (it > 0 && lane == 0) mbar_arrive(ring.empty((it - 1) % STAGES));
    }
    wgmma_wait<0>();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    // accumulator i of acc[mb]: co row 16 warp + lane / 4 (+ 8 for i % 4 >= 2),
    // ci column 8 (i / 4) + 2 (lane % 4) + i % 2. Lanes 2k and 2k + 1 swap
    // halves so that each holds 4 consecutive columns of one row: the even
    // lane row r, the odd lane row r + 8.
    const bool odd = lane & 1;
    float* dwt = dw + (int64_t)t * Cout * Cin;
#pragma unroll
    for (int mb = 0; mb < 2; ++mb) {
      const int co = co0 + 128 * wg + 64 * mb + 16 * warp + (lane >> 2) + (odd ? 8 : 0);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float* a = &acc[mb][4 * j];
        const float s0 = odd ? a[0] : a[2], s1 = odd ? a[1] : a[3];
        const float r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
        const float r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
        const float4 v = odd ? make_float4(r0, r1, a[2], a[3]) : make_float4(a[0], a[1], r0, r1);
        const int ci = ci0 + 8 * j + (lane & 2) * 2;
        if (co < Cout && ci < Cin)
          atomicAdd(reinterpret_cast<float4*>(dwt + (int64_t)co * Cin + ci), v);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32 routes (plain FMAs; the parity runs with TF32 off)

constexpr int FT = 64, FK = 16;

__device__ __forceinline__ bool inside(int v, int n) { return v >= 0 && v < n; }

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

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      count = 132;
  }
  return count;
}

// pixel slices of the bf16 weight gradient: at least 8 waves of blocks (the
// taps' rectangles differ in size), each slice at least 16 boxes, and the
// first count from there whose last wave is at least 90% full
int wgrad_slices(int64_t max_boxes, int64_t units_per_slice) {
  const int64_t sms = sm_count();
  const int64_t most = max_boxes / 16 > 1 ? max_boxes / 16 : 1;
  int64_t s = (8 * sms + units_per_slice - 1) / units_per_slice;
  if (s > most) return (int)most;
  for (int64_t c = s; c <= most; ++c) {
    const int64_t units = c * units_per_slice;
    if (units * 10 >= ((units + sms - 1) / sms) * sms * 9) return (int)c;
  }
  return (int)s;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t rc =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (rc == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// A bf16 tensor map with the 128-byte swizzle over a contiguous tensor whose
// dims (innermost first) are dims[0..rank); zero fill outside it. 0 or a
// cudaError.
int encode_bf16(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                const cuuint32_t* box) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return (int)cudaErrorNotSupported;
  cuuint64_t strides[4];
  cuuint64_t s = 2;
  for (int i = 0; i + 1 < rank; ++i) strides[i] = s *= dims[i];
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank, const_cast<void*>(base),
                        dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? (int)cudaSuccess : (int)cudaErrorInvalidValue;
}

int set_smem(const void* kernel, bool* done) {
  if (*done) return (int)cudaSuccess;
  const cudaError_t rc =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WS_SMEM);
  *done = rc == cudaSuccess;
  return (int)rc;
}

}  // namespace

// dtype: 0 = f32, 1 = bf16. bf16 needs Cin a multiple of 8 and 16-byte aligned
// x and weight (the tensor maps' strides and bases; the wrapper pads). Returns
// 0 or the cudaError of the tensor maps or the launch.
extern "C" int dconv_forward(const void* x, const void* w, void* out, int n, int h, int wd,
                             int cin, int cout, int rate, int dtype, void* stream) {
  if (n < 0 || h < 1 || wd < 1 || cin < 1 || cout < 1 || rate < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t m = (int64_t)n * h * wd;
  if (m == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1) {
    if ((cin & 7) || (((uintptr_t)x | (uintptr_t)w) & 15)) return (int)cudaErrorMisalignedAddress;
    CUtensorMap xmap, wmap;
    const cuuint64_t xd[4] = {(cuuint64_t)cin, (cuuint64_t)wd, (cuuint64_t)h, (cuuint64_t)n};
    const cuuint32_t xb[4] = {KB, FC, FR, 1};
    const cuuint64_t wdims[3] = {(cuuint64_t)cin, (cuuint64_t)cout, 9};
    const cuuint32_t wb[3] = {KB, 256, 1};
    int rc = encode_bf16(&xmap, x, 4, xd, xb);
    if (rc == 0) rc = encode_bf16(&wmap, w, 3, wdims, wb);
    static bool attr = false;
    if (rc == 0) rc = set_smem((const void*)dconv_fwd_wgmma, &attr);
    if (rc != 0) return rc;
    const int tiles_x = ceil_div(wd, FC), tiles_y = ceil_div(h, FR);
    if ((int64_t)tiles_x * tiles_y * n > 0x7fffffff || ceil_div(cout, 256) > 65535)
      return (int)cudaErrorInvalidValue;
    dim3 grid(tiles_x * tiles_y * n, ceil_div(cout, 256));
    dconv_fwd_wgmma<<<grid, WS_THREADS, WS_SMEM, st>>>(xmap, wmap, (__nv_bfloat16*)out, h, wd,
                                                        cin, cout, rate, tiles_x, tiles_y);
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

// dw: f32 [9, Cout, Cin], zeroed by the caller (the blocks add into it). bf16
// needs Cin and Cout multiples of 8 and 16-byte aligned x, g and dw.
extern "C" int dconv_wgrad(const void* x, const void* g, void* dw, int n, int h, int wd, int cin,
                           int cout, int rate, int dtype, void* stream) {
  if (n < 0 || h < 1 || wd < 1 || cin < 1 || cout < 1 || rate < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t m = (int64_t)n * h * wd;
  if (m == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1) {
    if ((cin & 7) || (cout & 7) || (((uintptr_t)x | (uintptr_t)g | (uintptr_t)dw) & 15))
      return (int)cudaErrorMisalignedAddress;
    CUtensorMap xmap, gmap;
    const cuuint64_t xd[4] = {(cuuint64_t)cin, (cuuint64_t)wd, (cuuint64_t)h, (cuuint64_t)n};
    const cuuint64_t gd[4] = {(cuuint64_t)cout, (cuuint64_t)wd, (cuuint64_t)h, (cuuint64_t)n};
    const cuuint32_t box[4] = {KB, PB, PB, 1};
    int rc = encode_bf16(&xmap, x, 4, xd, box);
    if (rc == 0) rc = encode_bf16(&gmap, g, 4, gd, box);
    static bool attr = false;
    if (rc == 0) rc = set_smem((const void*)dconv_wgrad_wgmma, &attr);
    if (rc != 0) return rc;
    // the largest tap rectangle: the centre tap's, the whole map
    const int64_t max_boxes = (int64_t)n * ceil_div(h, PB) * ceil_div(wd, PB);
    const int ci_tiles = ceil_div(cin, 128), co_tiles = ceil_div(cout, 256);
    const int slices = wgrad_slices(max_boxes, 9LL * ci_tiles * co_tiles);
    if ((int64_t)slices * co_tiles > 65535 || ci_tiles > 65535) return (int)cudaErrorInvalidValue;
    dim3 grid(9, ci_tiles, slices * co_tiles);
    dconv_wgrad_wgmma<<<grid, WS_THREADS, WS_SMEM, st>>>(xmap, gmap, (float*)dw, n, h, wd, cin,
                                                          cout, rate, slices);
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
