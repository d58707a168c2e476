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
// queries in the matcher); col4row [B, R] int32, the column assigned to each row.
//
// Design: one thread block per problem, threads over columns. Each Dijkstra step
// updates the reduced costs of the unvisited columns in parallel, then a block
// argmin picks the closest column, ties to the lowest index as jnp.argmin does
// (with rows masked at 1e9 ties are everywhere, and the valid rows' assignment
// depends on that rule). The reduced cost is evaluated as ((c - u_i) - v_j) +
// minval, the JAX expression's order; nothing here multiplies, so no FMA
// contraction can change a rounding. The dual update runs over columns in
// parallel (distinct columns belong to distinct rows); the augmentation, a walk
// of at most R steps, runs on one thread. All state lives in shared memory.
//
// Bound at the stage-2 shapes (16 problems of 19 x 100): it must read 122 KB and
// write 1.2 KB, 37 ns at 3.35 TB/s; its work is at most R Dijkstra passes of R
// steps over C columns, about 5 f32 operations each, 2.9 MFLOP, 43 ns at
// 67 TFLOP/s. Neither bounds it: it is a chain of R * R dependent block-wide
// argmins (each a few __syncthreads), so latency bounds it, and 16 blocks use
// 16 of the 132 SMs.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#define LSA_THREADS 128

__global__ void lsa_kernel(const float* __restrict__ cost, int* __restrict__ out,
                           int R, int C) {
  extern __shared__ float lsa_smem[];
  float* v = lsa_smem;                                   // [C]
  float* shortest = v + C;                               // [C]
  float* u = shortest + C;                               // [R]
  int* parent = reinterpret_cast<int*>(u + R);           // [C]
  int* row4col = parent + C;                             // [C]
  int* visited = row4col + C;                            // [C]
  int* col4row = visited + C;                            // [R]
  __shared__ float red_val[LSA_THREADS / 32];
  __shared__ int red_idx[LSA_THREADS / 32];
  __shared__ int s_i, s_sink;
  __shared__ float s_minval;

  const int tid = threadIdx.x;
  const float* cb = cost + (int64_t)blockIdx.x * R * C;
  for (int j = tid; j < C; j += blockDim.x) {
    v[j] = 0.f;
    row4col[j] = -1;
  }
  for (int r = tid; r < R; r += blockDim.x) {
    u[r] = 0.f;
    col4row[r] = -1;
  }
  __syncthreads();

  for (int cur = 0; cur < R; ++cur) {
    for (int j = tid; j < C; j += blockDim.x) {
      shortest[j] = CUDART_INF_F;
      parent[j] = cur;
      visited[j] = 0;
    }
    if (tid == 0) {
      s_i = cur;
      s_sink = -1;
      s_minval = 0.f;
    }
    __syncthreads();
    while (true) {
      const int i = s_i;
      const float minval = s_minval;
      const float ui = u[i];
      float best = CUDART_INF_F;
      int bestj = C;
      for (int j = tid; j < C; j += blockDim.x) {
        if (!visited[j]) {
          const float reduced = ((cb[(int64_t)i * C + j] - ui) - v[j]) + minval;
          if (reduced < shortest[j]) {
            shortest[j] = reduced;
            parent[j] = i;
          }
          // j rises along a thread's loop: strict < keeps the lowest index
          if (shortest[j] < best) {
            best = shortest[j];
            bestj = j;
          }
        }
      }
      // block argmin, ties to the lowest column
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, best, o);
        const int oj = __shfl_xor_sync(0xffffffffu, bestj, o);
        if (ov < best || (ov == best && oj < bestj)) {
          best = ov;
          bestj = oj;
        }
      }
      if ((tid & 31) == 0) {
        red_val[tid >> 5] = best;
        red_idx[tid >> 5] = bestj;
      }
      __syncthreads();
      if (tid == 0) {
        for (int w = 1; w < (int)(blockDim.x >> 5); ++w) {
          if (red_val[w] < best || (red_val[w] == best && red_idx[w] < bestj)) {
            best = red_val[w];
            bestj = red_idx[w];
          }
        }
        if (bestj >= C) {
          // no finite reduced cost (a NaN or inf cost): take the first
          // unvisited column, so the search still ends within C steps
          for (bestj = 0; visited[bestj]; ++bestj) {}
          best = shortest[bestj];
        }
        s_minval = best;
        visited[bestj] = 1;
        const int nxt = row4col[bestj];
        if (nxt < 0) {
          s_sink = bestj;
        } else {
          s_i = nxt;
        }
      }
      __syncthreads();
      if (s_sink >= 0) break;
    }

    // dual update: u[cur] += minval; a visited column j held by row r moves
    // u[r] by minval - shortest[j] and v[j] by the opposite
    const float minval = s_minval;
    if (tid == 0) u[cur] += minval;
    for (int j = tid; j < C; j += blockDim.x) {
      if (visited[j]) {
        const float delta = minval - shortest[j];
        const int r = row4col[j];
        if (r >= 0) u[r] = u[r] + delta;
        v[j] = v[j] + (-delta);
      }
    }
    __syncthreads();
    if (tid == 0) {
      int j = s_sink;
      int i;
      do {
        i = parent[j];
        const int prev = col4row[i];
        row4col[j] = i;
        col4row[i] = j;
        j = prev;
      } while (i != cur);
    }
    __syncthreads();
  }
  for (int r = tid; r < R; r += blockDim.x) out[(int64_t)blockIdx.x * R + r] = col4row[r];
}

// cost [B, R, C] f32, col4row [B, R] int32, 1 <= R <= C.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int lsa_solve(const void* cost, void* col4row, int b, int r, int c,
                         void* stream) {
  if (r < 1 || r > c) return (int)cudaErrorInvalidValue;
  if (b == 0) return (int)cudaSuccess;
  const size_t smem = (size_t)(2 * c + r) * sizeof(float) + (size_t)(3 * c + r) * sizeof(int);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  lsa_kernel<<<b, LSA_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)cost, (int*)col4row, r, c);
  return (int)cudaGetLastError();
}
