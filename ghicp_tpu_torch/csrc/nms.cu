// Exact-radius NMS fixed point for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel ghicp_tpu/ops/nms_kernel.py::nms_pallas
// (_nms_kernel): every round of the greedy-equivalent non-max suppression
// in one launch.  A candidate wins a round iff it is alive and beats
// (curvature desc, original index asc) every alive candidate within the
// radius; winners are selected, and alive candidates within the radius of
// a winner are suppressed; rounds end when nothing is alive or at
// max_rounds.
//
// Bound on this card: operations.  The inputs are a few hundred KB (at
// 65,536 candidates: 1 MB of coordinates and curvatures, 768 KB of
// alive/wins/selected flags, all L2-resident), while each round tests the
// distance of every pair of candidates in near tiles twice (about nine
// float ops a test), so the float32 rate, not memory, sets the floor.
//
// Design.  The host sorts candidates in Morton order, cuts tiles of 256
// and lists for each row tile the column tiles whose bounding boxes lie
// within the radius (ops/nms_kernel.py::nms_prep).  One cooperative
// persistent launch holds the whole fixed point: alive, wins and sel live
// in global memory, and grid.sync() separates the two sweeps of a round.
// A block owns a row tile (one thread a row) and walks its near column
// tiles, staging each tile's coordinates, curvatures, original ids and
// alive (sweep 1) or wins (sweep 2) flags in shared memory; tiles with no
// flag set are skipped whole.  Sweep 1 keeps the running (max curvature,
// lowest original id at that max) over alive in-radius candidates and
// writes wins; sweep 2 selects the winners and clears alive for winners and
// for candidates within the radius of one, counting what stays alive with
// one atomic add a block into a rotating slot that every block reads after
// the next grid.sync().  Distances are direct differences of centred
// coordinates, (dx*dx + dy*dy) + dz*dz with explicitly rounded intrinsics,
// compared with r^2, so the plain PyTorch version agrees bit for bit.
//
// The entry returns cudaGetLastError() of its launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

constexpr int TS = 256;   // candidates a tile = threads a block
#define NEG_F (-3.0e38f)
#define BIG_I 0x7fffffff

struct Params {
  int N, T, maxn, max_rounds;
  float r2;
  const float4* xc;     // [N] sorted (x, y, z, curvature), centred
  const int* oid;       // [N] original index
  const int* cand;      // [N] sorted candidate flags
  const int* nbr_cnt;   // [T]
  const int* nbr_idx;   // [T, maxn]
  int* alive;
  int* wins;
  int* sel;
  int* cnt;             // [3] rotating alive counts, zero on entry
  int* rounds;
};

__device__ __forceinline__ float dist2(float4 a, float4 b) {
  const float dx = __fsub_rn(a.x, b.x);
  const float dy = __fsub_rn(a.y, b.y);
  const float dz = __fsub_rn(a.z, b.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__device__ __forceinline__ int block_count(int v, int* s_red) {
  // sum of v over the block (all threads return it)
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int w = threadIdx.x >> 5;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) s_red[w] = v;
  __syncthreads();
  int tot = 0;
  for (int k = 0; k < TS / 32; ++k) tot += s_red[k];
  return tot;
}

__global__ void __launch_bounds__(TS) nms_kernel(Params P) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float4 s_p[TS];
  __shared__ int s_oid[TS];
  __shared__ int s_flag[TS];
  __shared__ int s_red[TS / 32];
  const int tid = threadIdx.x;

  // ---- initial alive set and its size --------------------------------
  for (int t = blockIdx.x; t < P.T; t += gridDim.x) {
    const int i = t * TS + tid;
    const int c = P.cand[i] != 0;
    P.alive[i] = c;
    P.wins[i] = 0;
    P.sel[i] = 0;
    const int n = block_count(c, s_red);
    if (tid == 0 && n) atomicAdd(P.cnt, n);
  }
  grid.sync();
  int n_alive = __ldcg(P.cnt);
  int r = 0;
  while (n_alive > 0 && r < P.max_rounds) {
    // ---- sweep 1: wins = alive rows that beat every alive neighbour ----
    for (int t = blockIdx.x; t < P.T; t += gridDim.x) {
      const int i = t * TS + tid;
      const int a_i = __ldcg(P.alive + i);
      if (!__syncthreads_or(a_i)) {
        P.wins[i] = 0;
        continue;
      }
      const float4 p_i = __ldg(P.xc + i);
      const int o_i = __ldg(P.oid + i);
      float maxc = NEG_F;
      int idmin = BIG_I;
      const int n_near = __ldg(P.nbr_cnt + t);
      for (int k = 0; k < n_near; ++k) {
        const int j = __ldg(P.nbr_idx + (size_t)t * P.maxn + k) * TS + tid;
        __syncthreads();
        s_p[tid] = __ldg(P.xc + j);
        s_oid[tid] = __ldg(P.oid + j);
        s_flag[tid] = __ldcg(P.alive + j);
        if (!__syncthreads_or(s_flag[tid])) continue;
        if (!a_i) continue;
        for (int q = 0; q < TS; ++q) {
          if (!s_flag[q]) continue;
          const float4 p_j = s_p[q];
          const int o_j = s_oid[q];
          if (dist2(p_i, p_j) <= P.r2 && o_j != o_i) {
            if (p_j.w > maxc) {
              maxc = p_j.w;
              idmin = o_j;
            } else if (p_j.w == maxc && o_j < idmin) {
              idmin = o_j;
            }
          }
        }
      }
      P.wins[i] = (a_i && (p_i.w > maxc || (p_i.w == maxc && o_i < idmin)))
                      ? 1 : 0;
    }
    grid.sync();
    // ---- sweep 2: select winners, suppress their alive neighbours -------
    const int slot = (r + 1) % 3;
    for (int t = blockIdx.x; t < P.T; t += gridDim.x) {
      const int i = t * TS + tid;
      const int a_i = __ldcg(P.alive + i);
      const int w_i = __ldcg(P.wins + i);
      if (w_i) P.sel[i] = 1;
      if (!__syncthreads_or(a_i)) continue;
      const float4 p_i = __ldg(P.xc + i);
      const int o_i = __ldg(P.oid + i);
      int supp = 0;
      const int n_near = __ldg(P.nbr_cnt + t);
      for (int k = 0; k < n_near; ++k) {
        const int j = __ldg(P.nbr_idx + (size_t)t * P.maxn + k) * TS + tid;
        __syncthreads();
        s_p[tid] = __ldg(P.xc + j);
        s_oid[tid] = __ldg(P.oid + j);
        s_flag[tid] = __ldcg(P.wins + j);
        if (!__syncthreads_or(s_flag[tid])) continue;
        if (!a_i || supp) continue;
        for (int q = 0; q < TS; ++q) {
          if (s_flag[q] && s_oid[q] != o_i && dist2(p_i, s_p[q]) <= P.r2) {
            supp = 1;
            break;
          }
        }
      }
      const int keep = (a_i && !w_i && !supp) ? 1 : 0;
      P.alive[i] = keep;
      const int n = block_count(keep, s_red);
      if (tid == 0 && n) atomicAdd(P.cnt + slot, n);
    }
    grid.sync();
    n_alive = __ldcg(P.cnt + slot);
    if (blockIdx.x == 0 && tid == 0) P.cnt[(r + 2) % 3] = 0;
    ++r;
  }
  if (blockIdx.x == 0 && tid == 0) *P.rounds = r;
}

extern "C" int nms_exact(const void* xc, const int* oid, const int* cand,
                         const int* nbr_cnt, const int* nbr_idx, int N, int T,
                         int maxn, int max_rounds, float r2, int* alive,
                         int* wins, int* sel, int* cnt, int* rounds,
                         void* stream) {
  Params P = {};
  P.N = N;
  P.T = T;
  P.maxn = maxn;
  P.max_rounds = max_rounds;
  P.r2 = r2;
  P.xc = (const float4*)xc;
  P.oid = oid;
  P.cand = cand;
  P.nbr_cnt = nbr_cnt;
  P.nbr_idx = nbr_idx;
  P.alive = alive;
  P.wins = wins;
  P.sel = sel;
  P.cnt = cnt;
  P.rounds = rounds;
  int dev = 0, sms = 0, occ = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, (const void*)nms_kernel,
                                                TS, 0);
  if (occ < 1) return (int)cudaErrorLaunchOutOfResources;
  int blocks = sms * occ;
  if (blocks > T) blocks = T;
  void* args[] = {&P};
  cudaLaunchCooperativeKernel((const void*)nms_kernel, blocks, TS, args, 0,
                              (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
