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
//   label_quads: labels [B, H, W] int32 -> quads [B, H + 1, WQ] int32, WQ =
//     W + 1 rounded up to 4: word (qy, qx) holds the codes of the four corners
//     of the 2x2 block whose top-left pixel is (qx - 1, qy - 1), one byte each
//     in JAX's corner order, (0,0), (0,1), (1,0), (1,1) as (dy, dx); a label in
//     [0, 254] is its own code, any other label and a corner off the map 255.
//     The criterion packs its label maps once a call; its sampling calls share
//     them. Replaces no TPU op: it trades one pass over the maps for one
//     gather a point instead of four.
//   label_points_classes: labels, quads, coords [B, P, 2] f32 (x, y) in [0, 1]
//     -> out [B, K, P] f32, every class 0..K-1 at every point.
//   label_points_rows: labels, quads, coords [R, P, 2], class_id [R] int32 ->
//     out [R, P] f32; row r reads map map_offset + r / rows_per_map. The JAX
//     package repeats each label map K times (jnp.repeat, criterion.py:409,
//     :419); here the row indexes the map instead.
// A class in [0, 254] is compared with the codes; any other (a class id of
// 255 or more, or below 0) with the corners' labels read from the map, so the
// samples are those of the labels for every class id.
//
// Design. The time went into the gathers: one thread a point, four 4-byte
// label reads a point, each a 32-byte sector of L2 traffic (the rows entry at
// the instance recipe's shapes reads 4.8 M points' corners, 0.094 ms a call on
// an H100). With the packed corner codes a point reads one word: one sector,
// 0.051 ms there. A thread takes one point; two or four points a thread (their
// coordinates in 16-byte loads, each class's samples in one 16-byte store
// along P) and 128-thread blocks measured no faster (PERF.md). Both sampling
// kernels use 30 registers and the pack 32, none spilling (nvcc -Xptxas -v,
// sm_90a): 8 blocks of 256 threads a SM, full occupancy; the classes entry at
// a vanilla recipe's 8 x 12544 points fills 392 of the card's 1056 block
// slots, one wave, and there a gather of the same words alone takes most of
// its time (PERF.md). The rows entry
// runs over the flat [R * P] points in order, so the rows of one map run
// together and find its codes in L2. The pack writes four words a thread (one
// 16-byte store), its label reads coalesced along a row. The coordinate
// arithmetic uses explicitly rounded multiplies and adds, so no FMA
// contraction moves a corner across a pixel edge relative to the plain
// version, and the corners are summed in JAX's order: the samples equal the
// earlier four-gathers kernel's bit for bit.
//
// Bounds (chip_smoke.py's seeded points; bytes bind all three): the classes
// entry at the stage-2 shapes (16 images at 704x704, K = 19, P = 12544) reads
// the 32-byte sectors of the code words its points read (5.8 MB, each once)
// and the coordinates (1.6 MB) and writes the samples (15.3 MB), 6.8 us at
// 3.35 TB/s; the arithmetic (4 compares and 4 adds per point and class, 30.5
// MFLOP) 0.5 us at 67 TFLOP/s. The rows entry at the clean candidates' shapes
// (152 rows of 15680 points on 8 of the maps) reads 15.8 MB of code sectors
// and 19.1 MB of coordinates and writes 9.5 MB of samples. The pack of the 16
// maps reads 31.7 MB and writes 31.8 MB.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LP_THREADS = 256;
constexpr int QUAD_THREADS = 128;  // the pack: four words a thread

__device__ __forceinline__ unsigned lp_code(int l) {
  return (l >= 0 && l < 255) ? (unsigned)l : 255u;
}

// A point's corners: its top-left pixel (x0, y0) and the four weights in JAX's
// order, 0 off the map.
struct LpPoint {
  int x0, y0;
  float w[4];
};

__device__ __forceinline__ LpPoint lp_point(float cx, float cy, int H, int W) {
  const float x = __fsub_rn(__fmul_rn(cx, (float)W), 0.5f);
  const float y = __fsub_rn(__fmul_rn(cy, (float)H), 0.5f);
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const float wx = __fsub_rn(x, x0f);
  const float wy = __fsub_rn(y, y0f);
  LpPoint pt;
  // corners beyond int range lie far outside the map: clamp before the cast
  pt.x0 = (int)fminf(fmaxf(x0f, -2.f), (float)W + 1.f);
  pt.y0 = (int)fminf(fmaxf(y0f, -2.f), (float)H + 1.f);
  const float wxs[2] = {__fsub_rn(1.f, wx), wx};
  const float wys[2] = {__fsub_rn(1.f, wy), wy};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int dy = q >> 1, dx = q & 1;
    const int ix = pt.x0 + dx, iy = pt.y0 + dy;
    const bool valid = ix >= 0 && ix < W && iy >= 0 && iy < H;
    pt.w[q] = valid ? __fmul_rn(wxs[dx], wys[dy]) : 0.f;
  }
  return pt;
}

// The corner codes of a point: its block's word, all 255 where no corner is
// on the map.
__device__ __forceinline__ unsigned lp_codes(const int* __restrict__ quads, const LpPoint& pt,
                                             int H, int WQ, int W) {
  const bool any = pt.x0 >= -1 && pt.x0 < W && pt.y0 >= -1 && pt.y0 < H;
  return any ? (unsigned)__ldg(quads + (int64_t)(pt.y0 + 1) * WQ + pt.x0 + 1) : 0xffffffffu;
}

// The sample of class k: the weights of the corners whose code is k
__device__ __forceinline__ float lp_sample(const LpPoint& pt, unsigned codes, unsigned k) {
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) s = __fadd_rn(s, ((codes >> (8 * q)) & 255u) == k ? pt.w[q] : 0.f);
  return s;
}

// The sample of class k from the map's labels themselves (a class the codes
// do not hold)
__device__ __forceinline__ float lp_sample_exact(const int* __restrict__ map, const LpPoint& pt,
                                                 int H, int W, int k) {
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int ix = pt.x0 + (q & 1), iy = pt.y0 + (q >> 1);
    const bool valid = ix >= 0 && ix < W && iy >= 0 && iy < H;
    const int l = valid ? __ldg(map + (int64_t)iy * W + ix) : 0;
    s = __fadd_rn(s, valid && l == k ? pt.w[q] : 0.f);
  }
  return s;
}

// a thread: four words of row qy of map b, from column qx0 (WQ % 4 == 0)
__global__ void __launch_bounds__(QUAD_THREADS) label_quads_kernel(const int* __restrict__ labels,
                                                                   int* __restrict__ quads, int H,
                                                                   int W, int WQ) {
  const int qx0 = 4 * ((int)blockIdx.x * QUAD_THREADS + (int)threadIdx.x);
  if (qx0 >= WQ) return;
  const int qy = (int)blockIdx.y, b = (int)blockIdx.z;
  const int* map = labels + (int64_t)b * H * W;
  // the codes of pixels x0 - 1 .. x0 + 3 of rows qy - 1 and qy (255 off the map)
  unsigned c[2][5];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int iy = qy - 1 + r;
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      const int ix = qx0 - 1 + j;
      c[r][j] = (iy >= 0 && iy < H && ix >= 0 && ix < W)
                    ? lp_code(__ldg(map + (int64_t)iy * W + ix)) : 255u;
    }
  }
  int4 out;
  int* o = reinterpret_cast<int*>(&out);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    o[j] = (int)(c[0][j] | c[0][j + 1] << 8 | c[1][j] << 16 | c[1][j + 1] << 24);
  *reinterpret_cast<int4*>(quads + ((int64_t)b * (H + 1) + qy) * WQ + qx0) = out;
}

// thread -> (map b, point p)
__global__ void __launch_bounds__(LP_THREADS) label_points_classes_kernel(
    const int* __restrict__ labels, const int* __restrict__ quads,
    const float* __restrict__ coords, float* __restrict__ out, int B, int H, int W, int WQ,
    int P, int K) {
  const int64_t idx = (int64_t)blockIdx.x * LP_THREADS + threadIdx.x;
  if (idx >= (int64_t)B * P) return;
  const int b = (int)(idx / P);
  const int p = (int)(idx - (int64_t)b * P);
  const float2 xy = __ldg(reinterpret_cast<const float2*>(coords) + idx);
  const LpPoint pt = lp_point(xy.x, xy.y, H, W);
  const unsigned codes = lp_codes(quads + (int64_t)b * (H + 1) * WQ, pt, H, WQ, W);
  const int* map = labels + (int64_t)b * H * W;
  float* ob = out + (int64_t)b * K * P + p;
  for (int k = 0; k < K; ++k)
    ob[(int64_t)k * P] = k < 255 ? lp_sample(pt, codes, (unsigned)k)
                                 : lp_sample_exact(map, pt, H, W, k);
}

// thread -> the flat point i of [R * P]
__global__ void __launch_bounds__(LP_THREADS) label_points_rows_kernel(
    const int* __restrict__ labels, const int* __restrict__ quads,
    const float* __restrict__ coords, const int* __restrict__ class_id, float* __restrict__ out,
    int64_t total, int H, int W, int WQ, int P, int rows_per_map, int map_offset) {
  const int64_t i = (int64_t)blockIdx.x * LP_THREADS + threadIdx.x;
  if (i >= total) return;
  const int r = (int)(i / P);
  const int map = map_offset + r / rows_per_map;
  const float2 xy = __ldg(reinterpret_cast<const float2*>(coords) + i);
  const LpPoint pt = lp_point(xy.x, xy.y, H, W);
  const int k = __ldg(class_id + r);
  out[i] = (k >= 0 && k < 255)
               ? lp_sample(pt, lp_codes(quads + (int64_t)map * (H + 1) * WQ, pt, H, WQ, W),
                           (unsigned)k)
               : lp_sample_exact(labels + (int64_t)map * H * W, pt, H, W, k);
}

bool aligned(const void* p, int bytes) { return ((uintptr_t)p & (bytes - 1)) == 0; }

}  // namespace

// The packed map's row of words for maps of width w.
extern "C" int label_quads_width(int w) { return (w + 1 + 3) & ~3; }

// Returns cudaGetLastError() after the launch (0 on success). labels [b, h, w];
// quads [b, h + 1, label_quads_width(w)], 16-byte aligned.
extern "C" int label_quads(const void* labels, void* quads, int b, int h, int w, void* stream) {
  if (h < 1 || w < 1 || b < 0 || h >= 65535 || b >= 65536) return (int)cudaErrorInvalidValue;
  if (!aligned(quads, 16)) return (int)cudaErrorMisalignedAddress;
  if (b == 0) return (int)cudaSuccess;
  const int wq = label_quads_width(w);
  const dim3 grid((unsigned)((wq / 4 + QUAD_THREADS - 1) / QUAD_THREADS), (unsigned)(h + 1),
                  (unsigned)b);
  label_quads_kernel<<<grid, QUAD_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)labels, (int*)quads, h, w, wq);
  return (int)cudaGetLastError();
}

// labels: b maps, quads their label_quads; coords [b, p, 2]; out [b, k, p].
extern "C" int label_points_classes(const void* labels, const void* quads, const void* coords,
                                    void* out, int b, int h, int w, int p, int k, void* stream) {
  if (h < 1 || w < 1 || k < 1 || b < 0 || p < 0) return (int)cudaErrorInvalidValue;
  if (!aligned(coords, 8)) return (int)cudaErrorMisalignedAddress;
  const int64_t total = (int64_t)b * p;
  if (total == 0) return (int)cudaSuccess;
  const int64_t blocks = (total + LP_THREADS - 1) / LP_THREADS;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  label_points_classes_kernel<<<(unsigned)blocks, LP_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)labels, (const int*)quads, (const float*)coords, (float*)out, b, h, w,
      label_quads_width(w), p, k);
  return (int)cudaGetLastError();
}

extern "C" int label_points_rows(const void* labels, const void* quads, const void* coords,
                                 const void* class_id, void* out, int r, int h, int w, int p,
                                 int rows_per_map, int map_offset, void* stream) {
  if (h < 1 || w < 1 || rows_per_map < 1 || map_offset < 0) return (int)cudaErrorInvalidValue;
  if (!aligned(coords, 8)) return (int)cudaErrorMisalignedAddress;
  const int64_t total = (int64_t)r * p;
  if (total == 0) return (int)cudaSuccess;
  const int64_t blocks = (total + LP_THREADS - 1) / LP_THREADS;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  label_points_rows_kernel<<<(unsigned)blocks, LP_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)labels, (const int*)quads, (const float*)coords, (const int*)class_id,
      (float*)out, total, h, w, label_quads_width(w), p, rows_per_map, map_offset);
  return (int)cudaGetLastError();
}
