// Batched minimum-cost assignment for Hopper (sm_90a).
//
// Replaces linear_sum_assignment (multishiftseg_tpu/losses/matcher.py:28), the
// on-device Jonker-Volgenant solver the JAX package writes in lax control flow
// and vmaps over the batch. Same algorithm, same arithmetic, same tie rule, so
// the same assignment: for each row in order, a Dijkstra over the columns with
// dual potentials (u over rows, v over columns), then the dual update, then the
// augmentation along the alternating path that ends at the first free column.
//
// Layouts: cost [B, R, C] f32 contiguous (R <= C; rows are targets, columns are
// queries in the matcher); col4row [B, R] int64, the column assigned to each row.
//
// Design: one warp a problem, one problem a block, so B problems spread over B
// SMs (16 at the stage-2 shapes) and the search has no block barrier. The
// problem's cost matrix is copied to shared memory once (16-byte cp.async
// pieces), so every step reads shared memory, not the L2. Lane l owns columns
// j = l + 32 t, t < T; their v, shortest, parent and row4col live in registers
// and their visited flags in one bit mask; u and col4row live in shared memory.
// A Dijkstra step: each lane updates the reduced costs of its unvisited columns
// and keeps its lowest (strict <, t rising, so the lowest column of a tie);
// the warp takes the lowest value by __reduce_min_sync on the float's
// order-preserving image (-0 read as +0, so equal floats tie), then the lowest
// column among the lanes that hold it by a second one; the owner lane hands the
// column's shortest and row4col (each lane picks its candidate's while the warp
// reduces) to the warp by shuffle. The reduced cost is
// ((c - u_i) - v_j) + minval in that order, the JAX expression's, with nothing
// to contract; a NaN never wins (reduced < shortest is false). With no finite
// reduced cost left (a NaN or inf cost) the first unvisited column is taken,
// so the search still ends within C steps. The dual update runs over each
// lane's columns (distinct columns belong to distinct rows); the augmentation
// walks the path with the warp, one lane writing each row's column. The kernel
// writes int64, so a call is one kernel.
//
// Limits: C <= 32 * LSA_MAX_SLOTS (512) columns, and the shared memory of a
// problem, lsa_smem_bytes(R, C), at most 232,448 bytes (the H100's opt-in
// maximum a block); the wrapper (losses/matcher.py) refuses larger shapes
// before any launch, with the same formula.
//
// Bound at the stage-2 shapes (16 problems of 19 x 100): it must read 122 KB and
// write 2.4 KB, 37 ns at 3.35 TB/s; its work is at most R Dijkstra passes of R
// steps over C columns, about 5 f32 operations each, 2.9 MFLOP, 43 ns at
// 67 TFLOP/s. Neither bounds it: it is a chain of dependent warp argmins, the
// most of any problem (97 steps in chip_smoke.py's data), so latency bounds it:
// about 410 ns a step on an H100 (chip_smoke.py's device_ns_per_step).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#define LSA_MAX_SLOTS 16           // columns a lane: C <= 512
#define LSA_MAX_SMEM 232448        // shared memory a block can opt into (H100)

namespace {

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

// order-preserving image of a non-NaN float; -0 maps as +0
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned b = __float_as_uint(f == 0.f ? 0.f : f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// cost floats of the shared-memory copy: R * C, offset by up to 3 floats so
// that the copy keeps the source's 16-byte phase, rounded up to 16 bytes
__host__ __device__ __forceinline__ int lsa_cost_floats(int r, int c) {
  return (r * c + 3 + 3) & ~3;
}

template <int T>
__global__ void __launch_bounds__(32) lsa_warp_kernel(const float* __restrict__ cost,
                                                      int64_t* __restrict__ out, int R,
                                                      int C) {
  extern __shared__ __align__(16) float lsa_smem[];
  const int lane = threadIdx.x;
  const float* cg = cost + (int64_t)blockIdx.x * R * C;
  // the source's phase within 16 bytes, kept in shared memory
  const int phase = (int)(((uintptr_t)cg >> 2) & 3);
  float* cs = lsa_smem + phase;
  float* u = lsa_smem + lsa_cost_floats(R, C);
  int* col4row = reinterpret_cast<int*>(u + R);
  {
    const int n = R * C;
    const int head = min((4 - phase) & 3, n);
    if (lane < head) cp_async4(cs + lane, cg + lane);
    const int quads = (n - head) >> 2;
    for (int q = lane; q < quads; q += 32) cp_async16(cs + head + 4 * q, cg + head + 4 * q);
    const int done = head + 4 * quads;
    if (done + lane < n) cp_async4(cs + done + lane, cg + done + lane);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int r = lane; r < R; r += 32) {
    u[r] = 0.f;
    col4row[r] = -1;
  }

  float v[T], sh[T];
  int par[T], r4c[T];
  unsigned real = 0;  // bit t: column lane + 32 t exists
#pragma unroll
  for (int t = 0; t < T; ++t) {
    v[t] = 0.f;
    r4c[t] = -1;
    if (lane + 32 * t < C) real |= 1u << t;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();

  for (int cur = 0; cur < R; ++cur) {
    unsigned vis = ~real;  // a missing column counts as visited
#pragma unroll
    for (int t = 0; t < T; ++t) {
      sh[t] = CUDART_INF_F;
      par[t] = cur;
    }
    int i = cur, sink = 0;
    float minval = 0.f;
    while (true) {
      const float ui = u[i];
      const float* crow = cs + i * C;
      float best = CUDART_INF_F;
      int bt = -1;  // the slot of the lane's lowest column
#pragma unroll
      for (int t = 0; t < T; ++t) {
        if (!((vis >> t) & 1u)) {
          const int j = lane + 32 * t;
          const float reduced = __fadd_rn(__fsub_rn(__fsub_rn(crow[j], ui), v[t]), minval);
          if (reduced < sh[t]) {
            sh[t] = reduced;
            par[t] = i;
          }
          if (sh[t] < best) {
            best = sh[t];
            bt = t;
          }
        }
      }
      const int bestj = lane + 32 * bt;
      // the candidate's row, picked while the warp reduces
      int r_own = r4c[0];
#pragma unroll
      for (int t = 1; t < T; ++t)
        if (bt == t) r_own = r4c[t];
      const unsigned key = bt >= 0 ? order_key(best) : 0xffffffffu;
      const unsigned kmin = __reduce_min_sync(FULL, key);
      int owner;
      if (kmin != 0xffffffffu) {
        owner = (int)__reduce_min_sync(FULL, key == kmin ? (unsigned)bestj : 0xffffffffu) & 31;
      } else {
        // no finite reduced cost: the first unvisited column
        bt = -1;
#pragma unroll
        for (int t = T - 1; t >= 0; --t)
          if (!((vis >> t) & 1u)) bt = t;
        owner = (int)__reduce_min_sync(FULL, bt >= 0 ? (unsigned)(lane + 32 * bt) : 0xffffffffu) & 31;
        best = CUDART_INF_F;
        r_own = r4c[0];
#pragma unroll
        for (int t = 1; t < T; ++t)
          if (bt == t) r_own = r4c[t];
      }
      minval = __shfl_sync(FULL, best, owner);
      const int nxt = __shfl_sync(FULL, r_own, owner);
      if (lane == owner) vis |= 1u << bt;
      if (nxt < 0) {
        sink = __shfl_sync(FULL, lane + 32 * bt, owner);
        break;
      }
      i = nxt;
    }

    // dual update: u[cur] += minval; a visited column j held by row r moves
    // u[r] by minval - shortest[j] and v[j] by the opposite
    if (lane == 0) u[cur] = __fadd_rn(u[cur], minval);
#pragma unroll
    for (int t = 0; t < T; ++t) {
      if (((vis & real) >> t) & 1u) {
        const float delta = __fsub_rn(minval, sh[t]);
        if (r4c[t] >= 0) u[r4c[t]] = __fadd_rn(u[r4c[t]], delta);
        v[t] = __fadd_rn(v[t], -delta);
      }
    }
    __syncwarp();
    // augmentation: along the parents from the sink back to row cur
    int j = sink, row;
    do {
      const int owner = j & 31, slot = j >> 5;
      int p_own = par[0];
#pragma unroll
      for (int t = 1; t < T; ++t)
        if (slot == t) p_own = par[t];
      row = __shfl_sync(FULL, p_own, owner);
      const int prev = col4row[row];
      if (lane == owner) {
#pragma unroll
        for (int t = 0; t < T; ++t)
          if (slot == t) r4c[t] = row;
      }
      __syncwarp();  // every lane has read col4row[row]
      if (lane == 0) col4row[row] = j;
      j = prev;
    } while (row != cur);  // the path's rows differ: no other read waits on the write
    __syncwarp();
  }
  for (int r = lane; r < R; r += 32) out[(int64_t)blockIdx.x * R + r] = col4row[r];
}

template <int T>
int lsa_launch(const float* cost, int64_t* out, int b, int r, int c, size_t smem,
               cudaStream_t st) {
  const auto kern = lsa_warp_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<b, 32, smem, st>>>(cost, out, r, c);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory of one problem: its cost copy, u and col4row.
extern "C" long long lsa_smem_bytes(int r, int c) {
  return 4ll * lsa_cost_floats(r, c) + 8ll * r;
}

// cost [B, R, C] f32, col4row [B, R] int64, 1 <= R <= C <= 512,
// lsa_smem_bytes(R, C) <= 232448. Returns cudaGetLastError() after the launch
// (0 on success); cudaErrorInvalidValue for a shape past the limits.
extern "C" int lsa_solve(const void* cost, void* col4row, int b, int r, int c, void* stream) {
  if (b < 0 || r < 1 || r > c || c > 32 * LSA_MAX_SLOTS) return (int)cudaErrorInvalidValue;
  const long long smem = lsa_smem_bytes(r, c);
  if (smem > LSA_MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (b == 0) return (int)cudaSuccess;
  const float* cf = (const float*)cost;
  int64_t* o = (int64_t*)col4row;
  cudaStream_t st = (cudaStream_t)stream;
  const int slots = (c + 31) / 32;
  if (slots <= 1) return lsa_launch<1>(cf, o, b, r, c, (size_t)smem, st);
  if (slots <= 2) return lsa_launch<2>(cf, o, b, r, c, (size_t)smem, st);
  if (slots <= 4) return lsa_launch<4>(cf, o, b, r, c, (size_t)smem, st);
  if (slots <= 8) return lsa_launch<8>(cf, o, b, r, c, (size_t)smem, st);
  return lsa_launch<16>(cf, o, b, r, c, (size_t)smem, st);
}
