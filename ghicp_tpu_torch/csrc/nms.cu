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
// 65,536 candidates: 1 MB of coordinates and curvatures, 256 KB of state,
// all L2-resident), while each round tests the distance of alive pairs in
// near tiles (about nine float ops a test), so the float32 rate, not
// memory, sets the floor.
//
// Design.  The host sorts candidates in Morton order, cuts tiles of 256,
// lists for each row tile the column tiles whose bounding boxes lie within
// the radius and flattens those (row tile, column tile) pairs into one list
// of work items (ops/nms_kernel.py::nms_prep).  One cooperative persistent
// launch holds the whole fixed point, two phases a round with a grid.sync()
// after each; in each phase the blocks take items from the list in turn,
// so a dense row tile with 50 near tiles is 50 items spread over the card
// rather than one block's serial walk.
//
// State.  One int a slot: -1 dead (never a candidate, or suppressed), else
// a round stamp s.  In round r a slot is alive iff s >= r; an alive slot
// that has not lost yet has s == r; losing sets s = r + 1.  So in phase 2
// the winners of round r are exactly the slots with s == r, and they keep
// that stamp for good: every later round's tests (s == r', s >= r' with
// r' > r) leave them out, and at the end a slot is selected iff 0 <= s <
// rounds.  Every write of a phase moves a slot only between states that
// the phase's readers treat alike (phase 1: r -> r + 1, both alive as a
// column; phase 2: r + 1 -> -1, both "not a winner"), so items may run in
// any order and read each other's writes or not: "beats every alive
// neighbour" is an AND over items and "within the radius of a winner" an
// OR.  An atomicExch tells the first writer of a slot, which counts it:
// round r's losers L_r (phase 1) and suppressed S_r (phase 2) land in
// per-round counters, and every block reads alive_{r+1} = L_r - S_r after
// the grid sync.
//
// An item (row tile t, column tile u) stages in shared memory the slots of
// t and of u that its phase needs, compacted by a ballot and a prefix over
// the warps: phase 1 the alive rows not yet lost and every alive column,
// phase 2 the alive rows that lost (non-winners) and the winners.  Empty
// sides end the item.  A lane owns one compacted row and walks the
// compacted columns (broadcast reads); when the rows fill fewer than the
// eight warps, the spare warps split the columns, each marking the rows it
// settles.  A warp stops as soon as every lane is settled (beaten, or
// within the radius of a winner).  Distances are direct differences of
// centred coordinates, (dx*dx + dy*dy) + dz*dz with explicitly rounded
// intrinsics, compared with r^2, so the plain PyTorch version agrees bit
// for bit.
//
// The entry returns cudaGetLastError() of its launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

constexpr int TS = 256;          // candidates a tile = threads a block
constexpr int WARPS = TS / 32;
constexpr int DEAD = -1;
constexpr int CHUNK = 16;        // columns between two "all settled" votes
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  int N, T, maxn, max_rounds;
  float r2;
  const float4* xc;     // [N] sorted (x, y, z, curvature), centred
  const int* oid;       // [N] original index
  const int* cand;      // [N] sorted candidate flags
  const int* nbr_idx;   // [T, maxn] near column tiles of each row tile
  const int* items;     // [T * maxn] item codes k * T + t, listed first
  const int* n_items;   // [1] listed items
  int* st;              // [N] state: -1 dead, else a round stamp
  int* cnt;             // [2 max_rounds + 1] zero on entry
  int* sel;             // [N] out: selected (sorted order)
  int* rounds;          // [1] out
};

__device__ __forceinline__ float dist2(float4 a, float4 b) {
  const float dx = __fsub_rn(a.x, b.x);
  const float dy = __fsub_rn(a.y, b.y);
  const float dz = __fsub_rn(a.z, b.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__device__ __forceinline__ int block_sum(int v, int* s_red) {
  // sum of v over the block (all threads return it)
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  const int w = threadIdx.x >> 5;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) s_red[w] = v;
  __syncthreads();
  int tot = 0;
  for (int k = 0; k < WARPS; ++k) tot += s_red[k];
  return tot;
}

struct Side {
  float4 p[TS];   // (x, y, z, curvature)
  int o[TS];      // original index
  int i[TS];      // slot
};

// The slots of ``tile`` that pass ``keep`` (on their state), compacted in
// slot order into ``s``; returns their count (every thread).  ``s_wn``:
// the warps' counts, a buffer of its own for each side staged together.
template <typename Keep>
__device__ __forceinline__ int stage(const Params& P, int tile, Keep keep,
                                     Side& s, int* s_wn) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i = tile * TS + tid;
  const bool k = keep(__ldcg(P.st + i));
  const unsigned bal = __ballot_sync(FULL, k);
  if (lane == 0) s_wn[warp] = __popc(bal);
  __syncthreads();
  int off = 0, n = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    off += w < warp ? s_wn[w] : 0;
    n += s_wn[w];
  }
  if (k) {
    const int q = off + __popc(bal & ((1u << lane) - 1u));
    s.p[q] = __ldg(P.xc + i);
    s.o[q] = __ldg(P.oid + i);
    s.i[q] = i;
  }
  return n;
}

// One phase over every item.  Phase 1 (WIN = false): rows alive and not
// yet lost (s == r), columns alive (s >= r); a row beaten by a column
// within the radius goes to r + 1.  Phase 2 (WIN = true): rows that lost
// (s == r + 1), columns the winners (s == r); a row within the radius of
// one dies.  Returns nothing: the block's first writes are added to
// cnt[slot].
template <bool WIN>
__device__ void phase(const Params& P, int r, int slot, Side& rows,
                      Side& cols, int* s_wn, int* s_red) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_it = __ldg(P.n_items);
  int first = 0;   // this thread's first writes over the phase
  for (int it = blockIdx.x; it < n_it; it += gridDim.x) {
    const int code = __ldg(P.items + it);
    const int k = code / P.T, t = code - k * P.T;
    const int u = __ldg(P.nbr_idx + (size_t)t * P.maxn + k);
    __syncthreads();   // the previous item is done with the shared sides
    const int n_r = stage(P, t, [&](int s) { return s == (WIN ? r + 1 : r); },
                          rows, s_wn);
    const int n_c = stage(P, u, [&](int s) { return WIN ? s == r : s >= r; },
                          cols, s_wn + WARPS);
    __syncthreads();
    if (n_r == 0 || n_c == 0) continue;
    // warps: row groups of 32 rows, the spare ones splitting the columns
    const int nrw = (n_r + 31) >> 5;
    const int ncs = WARPS / nrw;
    if (warp >= nrw * ncs) continue;
    const int rgi = warp % nrw, csi = warp / nrw;
    const int chunk = (n_c + ncs - 1) / ncs;
    const int q0 = csi * chunk, q1 = min(n_c, q0 + chunk);
    const int qr = rgi * 32 + lane;
    const bool has = qr < n_r;
    const float4 pi = has ? rows.p[qr] : make_float4(0.f, 0.f, 0.f, 0.f);
    const int oi = has ? rows.o[qr] : 0;
    bool hit = false;   // beaten (phase 1) or suppressed (phase 2)
    for (int qa = q0; qa < q1; qa += CHUNK) {
      if (__all_sync(FULL, hit || !has)) break;
      const int qb = min(q1, qa + CHUNK);
      for (int q = qa; q < qb; ++q) {
        const float4 pj = cols.p[q];
        const bool near = dist2(pi, pj) <= P.r2;
        if constexpr (WIN) {
          hit = hit || near;
        } else {
          const int oj = cols.o[q];
          hit = hit || (near && (pj.w > pi.w || (pj.w == pi.w && oj < oi)));
        }
      }
    }
    if (has && hit) {
      const int from = WIN ? r + 1 : r;
      first += atomicExch(P.st + rows.i[qr], WIN ? DEAD : r + 1) == from;
    }
  }
  const int n = block_sum(first, s_red);
  if (threadIdx.x == 0 && n) atomicAdd(P.cnt + slot, n);
}

__global__ void __launch_bounds__(TS) nms_kernel(Params P) {
  cg::grid_group grid = cg::this_grid();
  __shared__ Side s_rows, s_cols;
  __shared__ int s_wn[2 * WARPS];
  __shared__ int s_red[WARPS];
  const int tid = threadIdx.x;
  const int stride = gridDim.x * TS;

  // ---- the candidates alive at round 0 -------------------------------
  int c0 = 0;
  for (int i = blockIdx.x * TS + tid; i < P.N; i += stride) {
    const int c = P.cand[i] != 0;
    P.st[i] = c ? 0 : DEAD;
    c0 += c;
  }
  const int n0 = block_sum(c0, s_red);
  if (tid == 0 && n0) atomicAdd(P.cnt, n0);
  grid.sync();
  int n_alive = __ldcg(P.cnt);
  int r = 0;
  while (n_alive > 0 && r < P.max_rounds) {
    phase<false>(P, r, 2 * r + 1, s_rows, s_cols, s_wn, s_red);
    grid.sync();
    phase<true>(P, r, 2 * r + 2, s_rows, s_cols, s_wn, s_red);
    grid.sync();
    n_alive = __ldcg(P.cnt + 2 * r + 1) - __ldcg(P.cnt + 2 * r + 2);
    ++r;
  }
  // selected: the winners of rounds 0 .. r - 1 keep their round's stamp
  for (int i = blockIdx.x * TS + tid; i < P.N; i += stride) {
    const int s = __ldcg(P.st + i);
    P.sel[i] = (s >= 0 && s < r) ? 1 : 0;
  }
  if (blockIdx.x == 0 && tid == 0) *P.rounds = r;
}

extern "C" int nms_exact(const void* xc, const int* oid, const int* cand,
                         const int* nbr_idx, const int* items,
                         const int* n_items, int N, int T, int maxn,
                         int max_rounds, float r2, int* st, int* cnt,
                         int* sel, int* rounds, void* stream) {
  Params P = {};
  P.N = N;
  P.T = T;
  P.maxn = maxn;
  P.max_rounds = max_rounds;
  P.r2 = r2;
  P.xc = (const float4*)xc;
  P.oid = oid;
  P.cand = cand;
  P.nbr_idx = nbr_idx;
  P.items = items;
  P.n_items = n_items;
  P.st = st;
  P.cnt = cnt;
  P.sel = sel;
  P.rounds = rounds;
  int dev = 0, sms = 0, occ = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, (const void*)nms_kernel,
                                                TS, 0);
  if (occ < 1) return (int)cudaErrorLaunchOutOfResources;
  // every block takes items; more than there are listed items would only
  // wait at the grid syncs
  int blocks = sms * occ;
  if (blocks > T * maxn) blocks = T * maxn;
  void* args[] = {&P};
  cudaLaunchCooperativeKernel((const void*)nms_kernel, blocks, TS, args, 0,
                              (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
