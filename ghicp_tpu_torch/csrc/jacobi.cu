// Jacobi (synchronous) auction rounds for Hopper (sm_90a), plain C
// interface.
//
// Replaces two Pallas TPU kernels of the JAX package with one kernel:
//   * ghicp_tpu/ops/auction_rounds.py::auction_rounds_pallas (_kernel):
//     ``n_rounds`` fixed synchronous bidding rounds (early = 0);
//   * ghicp_tpu/ops/auction_rounds.py::auction_phase_pallas (_phase_kernel):
//     rounds until no row is open or a runtime ``max_rounds`` budget is
//     spent (early = 1), with the exact test S - #owned columns - sum(sunk)
//     == 0 checked before every round, so zero rounds are possible.
// The benefit matrix b [S, C] is bf16 or float32 (computed in float32).
//
// One round, bit for bit the JAX reference auction_rounds_ref: a row is
// assigned iff some column's owner is that row; every unassigned, unsunk row
// computes (v1, j1, v2) of v = b - p (j1 the lowest column at the maximum,
// v2 the maximum with only column j1 masked to -3e38); v1 <= sink sinks the
// row, else it bids ((p[j1] + v1) - max(v2, sink)) + eps on j1; each column
// goes to its highest bid, the HIGHEST row among equal bids (the reference's
// scatter-max of row ids), and its price becomes that bid.  Bids at or below
// -1.5e38 count as no bid.
//
// Bound on this card: memory.  A round reads b once (S * C * 2 or 4 bytes:
// 134 MB bf16 at 8192^2, 40 us at 3.35 TB/s); the state (prices, owners,
// sunk flags, a per-row owned stamp, a 64-bit bid key a column: ~200 KB at
// 8192) stays in L2.
//
// Design.  One cooperative launch runs every round; two grid syncs a round
// separate the bid step from the resolve step.  Bid step: each block stages
// the round's prices in shared memory; one warp a row reads the row in
// 16-byte loads (eight entries a lane, columns in increasing order per
// lane), keeps the running top-2 and merges it across the warp with the
// lowest-column rule; lane 0 posts the bid as the key
// (f2o(bid + 0.0f) << 32) | row with a 64-bit atomicMax (adding +0.0 makes
// -0.0 and +0.0 one key, as they compare equal in the reference), so the
// highest bid and then the highest row wins whatever the order of the
// atomics.  Resolve step: one thread a column takes its key, sets owner and
// price, clears the key, and stamps the column's (new or kept) owner with
// the next round's tag, so "owned at the start of round r" is
// stamp == r + 1 with no clearing pass.  The early-exit count: every block
// keeps S - #owned - sum(sunk) itself and subtracts the round's events (a
// row sinking, a column gaining its first owner), counted by atomics into
// one of three slots a round apart and read after the resolve's grid sync,
// so every block takes the same decision and no block starts a round the
// others skip.  The float operations are explicitly rounded intrinsics in
// the reference's order (-fmad=false).
//
// Every entry returns cudaGetLastError() of its launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "top2.cuh"

namespace cg = cooperative_groups;

constexpr int NT = 256;           // threads per block
constexpr int NWARP = NT / 32;
constexpr int UNROLL = 4;         // 16-byte loads in flight a lane

struct JParams {
  const void* b;                  // [S, C] bf16 or float32
  float* p;                       // [C] prices, updated in place
  int* owner;                     // [C] row id or -1, in place
  int* sunk;                      // [S] in place
  int* rounds;                    // [1] rounds run
  int* stamp;                     // [S] zero on entry: owned-at-round tags
  unsigned long long* key;        // [C] zero on entry, zero on exit
  int* cnt;                       // [4] zero on entry: start count, 3 slots
  float eps, sink;
  int max_rounds, early, S, C;
};

template <typename T>
__device__ __forceinline__ Top2 warp_row_top2(const T* row, const float* sp,
                                              int C, int lane) {
  Top2 t = t2_empty();
  for (int base = lane * 8; base < C; base += 32 * 8 * UNROLL) {
    float x[UNROLL][8];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int c = base + u * 32 * 8;
      if (c < C) load8(row + c, x[u]);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int c = base + u * 32 * 8;
      if (c < C) {
#pragma unroll
        for (int q = 0; q < 8; ++q) t2_push(t, __fsub_rn(x[u][q], sp[c + q]),
                                            c + q);
      }
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    Top2 u;
    u.v1 = __shfl_xor_sync(0xffffffffu, t.v1, o);
    u.j1 = __shfl_xor_sync(0xffffffffu, t.j1, o);
    u.v2 = __shfl_xor_sync(0xffffffffu, t.v2, o);
    t = t2_merge(t, u);
  }
  return t;
}

template <typename T>
__global__ void __launch_bounds__(NT) jacobi_kernel(JParams P) {
  extern __shared__ float s_p[];  // [C] this round's prices
  cg::grid_group grid = cg::this_grid();
  const int S = P.S, C = P.C;
  const int gtid = blockIdx.x * NT + threadIdx.x;
  const int gthreads = gridDim.x * NT;
  const int lane = threadIdx.x & 31;
  const int gwarp = blockIdx.x * NWARP + (threadIdx.x >> 5);
  const int nwarps = gridDim.x * NWARP;
  const T* b = static_cast<const T*>(P.b);
  // the start state: owned stamps of round 0 and #owned + sum(sunk)
  for (int c = gtid; c < C; c += gthreads) {
    const int o = P.owner[c];
    if (o >= 0) {
      if (o < S) P.stamp[o] = 1;
      atomicAdd(P.cnt, 1);
    }
  }
  for (int i = gtid; i < S; i += gthreads) {
    const int s = P.sunk[i];
    if (s != 0) atomicAdd(P.cnt, s);
  }
  grid.sync();
  long long left = (long long)S - (long long)__ldcg(P.cnt);
  int r = 0;
  while (r < P.max_rounds && (!P.early || left > 0)) {
    int* ev = P.cnt + 1 + r % 3;
    if (gtid == 0) P.cnt[1 + (r + 1) % 3] = 0;
    for (int c = threadIdx.x; c < C; c += NT) s_p[c] = __ldcg(P.p + c);
    __syncthreads();
    const int tag = r + 1;
    // ---- bids: one warp a row ------------------------------------------
    for (int row = gwarp; row < S; row += nwarps) {
      if (__ldcg(P.stamp + row) == tag || __ldcg(P.sunk + row) != 0)
        continue;
      const Top2 t = warp_row_top2<T>(b + (size_t)row * C, s_p, C, lane);
      if (lane == 0) {
        if (t.v1 <= P.sink) {
          P.sunk[row] = 1;
          atomicAdd(ev, 1);
        } else {
          const float bid = __fadd_rn(
              __fsub_rn(__fadd_rn(s_p[t.j1], t.v1), fmaxf(t.v2, P.sink)),
              P.eps);
          if (bid > -1.5e38f) {
            const unsigned long long k =
                ((unsigned long long)f2o(__fadd_rn(bid, 0.0f)) << 32) |
                (unsigned long long)(unsigned int)row;
            atomicMax(P.key + t.j1, k);
          }
        }
      }
    }
    grid.sync();
    // ---- resolve: one thread a column ----------------------------------
    for (int c = gtid; c < C; c += gthreads) {
      const unsigned long long k = __ldcg(P.key + c);
      int o = __ldcg(P.owner + c);
      if (k != 0ull) {
        if (o < 0) atomicAdd(ev, 1);
        o = (int)(unsigned int)(k & 0xffffffffull);
        P.owner[c] = o;
        P.p[c] = o2f((unsigned int)(k >> 32));
        P.key[c] = 0ull;
      }
      if (o >= 0 && o < S) P.stamp[o] = tag + 1;
    }
    grid.sync();
    left -= __ldcg(ev);
    ++r;
  }
  if (gtid == 0) *P.rounds = r;
}

template <typename T>
static int launch(JParams* P, void* stream) {
  const void* fn = (const void*)jacobi_kernel<T>;
  const size_t smem = (size_t)P->C * sizeof(float);
  int dev = 0, sms = 0, optin = 0, occ = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, NT, smem);
  if (occ < 1) return (int)cudaErrorLaunchOutOfResources;
  // two blocks an SM at most: each block copies the prices every round
  const int blocks = sms * (occ < 2 ? occ : 2);
  void* args[] = {P};
  cudaLaunchCooperativeKernel(fn, blocks, NT, args, smem,
                              (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

extern "C" int jacobi_rounds(const void* b, int f32, float* p, int* owner,
                             int* sunk, int* rounds, float eps, float sink,
                             int max_rounds, int early, int S, int C,
                             int* stamp, unsigned long long* key, int* cnt,
                             void* stream) {
  JParams P = {};
  P.b = b;
  P.p = p;
  P.owner = owner;
  P.sunk = sunk;
  P.rounds = rounds;
  P.stamp = stamp;
  P.key = key;
  P.cnt = cnt;
  P.eps = eps;
  P.sink = sink;
  P.max_rounds = max_rounds;
  P.early = early;
  P.S = S;
  P.C = C;
  return f32 ? launch<float>(&P, stream) : launch<__nv_bfloat16>(&P, stream);
}
