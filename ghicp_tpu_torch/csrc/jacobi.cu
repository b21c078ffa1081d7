// Jacobi (synchronous) auction rounds for Hopper (sm_90a), plain C
// interface.
//
// Replaces two Pallas TPU kernels of the JAX package with one kernel:
//   * ghicp_tpu/ops/auction_rounds.py::auction_rounds_pallas (_kernel):
//     ``n_rounds`` fixed synchronous bidding rounds (early = 0);
//   * ghicp_tpu/ops/auction_rounds.py::auction_phase_pallas (_phase_kernel):
//     rounds until S - #owned columns - sum(sunk) == 0 (tested before every
//     round, so zero rounds are possible) or a runtime ``max_rounds`` budget
//     is spent (early = 1).
// The benefit matrix b [S, C] is bf16 or float32 (computed in float32).
//
// One round, bit for bit the JAX reference auction_rounds_ref: a row is
// assigned iff some column's owner is that row; every unassigned, unsunk row
// computes (v1, j1, v2) of v = b - p (j1 the lowest column at the maximum,
// v2 the maximum with only column j1 masked to -3e38); v1 <= sink sinks the
// row, else it bids ((p[j1] + v1) - max(v2, sink)) + eps on j1; each column
// goes to its highest bid, the HIGHEST row among equal bids (the reference's
// scatter-max of row ids), and its price becomes that bid.  Bids at or below
// -1.5e38 count as no bid.  The float operations are explicitly rounded
// intrinsics in the reference's order (-fmad=false).
//
// Bound on this card: memory.  A round reads the rows open at its start
// (S * C * 2 or 4 bytes in a cold round 0: 134 MB bf16 at 8192^2, 40 us at
// 3.35 TB/s); the state (prices, owners, per-row counts, the open-row lists,
// two 64-bit bid keys a column: ~0.3 MB at 8192^2) stays in L2.  After
// round 0 a round reads few rows, and its time is latency: grid syncs and
// dependent L2 round trips.
//
// Design (times: NVIDIA H100 80GB HBM3, 8192^2, PERF.md).  The call is out
// of place: one pass copies p0 / owner0 / sunk0 into the outputs and clears
// the scratch, so the wrapper makes four empty tensors and no fill.  A
// row's state is one count, nown = the columns it owns plus OWN_SUNK if it
// is sunk, so a row is open iff nown == 0; the rows open at a round's start
// are an explicit list: every row after a cold start (no owner, no sunk
// row: no count, no list to build), else listed from nown, and after each
// round the rows whose bid lost or that had no bid and the owners
// displaced from a column whose count fell to 0.  A round reads only its
// open rows, and K7 stops as soon as a round would start with none
// (nothing can change after that: the exact open-row test); K8 keeps the
// reference's column count, and a K8 call with no open row but a positive
// count spends its budget without work.
//
// One cooperative launch, one block of 512 threads an SM (128 registers a
// thread: the 1024-thread block spilled and read the heavy round ~40 %
// slower).  A grid round has two grid syncs (bids | resolve | next round).
// Bids: the list is cut into tiles of RB rows (RB the power of two that
// puts at most one tile on each block, at most 16); a block's 16 warps take
// a tile as RB rows x 16 / RB column chunks, so a light round's row is read
// by up to 16 warps at once; the chunks' partial (v1, j1, v2, p[j1]) meet
// in shared memory and merge with the lowest-column rule.  A warp walks its
// columns in batches of 64 bytes a lane, the next batch loaded while this
// one is pushed (no L1 allocation: the matrix is read once).  A TMA ring of
// four 2 KB stages a warp and L2 bulk prefetch ahead of the batches both
// read round 0 slower.  Where a block takes 8 or more rows a tile, it
// stages the round's prices in shared memory; a lighter round reads its
// chunk's prices from L2 beside the matrix and carries p[j1] with j1.  The
// top-2 update is branch-free.  The deciding lane posts the bid as the key
// (f2o(bid + 0.0f) << 32) | row with a 64-bit atomicMax (adding +0.0 makes
// -0.0 and +0.0 one key), into one of two key arrays a round apart, and
// keeps (row, column) in shared memory.  Resolve: the same block takes its
// own decisions: a row is the winner iff the column's key holds its row
// id; the winner sets owner and price and moves the displaced owner's
// count; losers and displaced rows with no column left are appended to the
// next list (one atomic a warp).  Each block clears the keys it posted in
// the next round, so every key array is zero again before its round.
// Events of the round (a row sinking, a column gaining its first owner)
// update K8's count, read by every block after the resolve's grid sync, so
// every block takes the same decision.  Counters live in three slots a
// round apart.
//
// Solo endgame: once a round starts with at most SOLO_ROWS (8) open rows
// (and the prices, owners and counts fit one block's shared memory; else
// solo_max is 0), every block but block 0 exits and block 0 runs the
// remaining rounds alone with block barriers instead of grid syncs: its 16
// warps split the open rows' columns, warp 0 decides, resolves the columns
// among its lanes, writes each won column through to the outputs, builds
// the next list and has the copy engine bring a displaced owner's row into
// L2 for the next round.  A round with one open row takes ~2.5 us there,
// ~6.7 us as a grid round.
//
// Every entry returns cudaGetLastError() of its launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "top2.cuh"

namespace cg = cooperative_groups;

constexpr int NT = 512;              // threads per block, one block an SM
constexpr int NWARP = NT / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int OWN_SUNK = 1 << 24;    // nown's mark of a sunk row
constexpr int SLOT = 4;              // a round's counters: next open rows,
                                     // events
constexpr int MAXG = 512;            // most blocks (per-block partial sums)
constexpr int MAXDEV = 64;
// Work split (measured on the H100 at 8192^2, PERF.md): block 0 goes on
// alone once a round starts with at most SOLO_ROWS open rows (4, 8, 12 and
// 16 tried); a grid round stages the prices in shared memory once a block
// takes STAGE_RB or more rows a tile (4, 8 and 16 alike)
constexpr int SOLO_ROWS = 8;
constexpr int STAGE_RB = 8;
static_assert(SOLO_ROWS <= NWARP, "solo's rows each take a warp or more");

typedef unsigned long long u64;

// Scratch layout in 4-byte words (jacobi_scratch_bytes): rounds, three
// counter slots, the per-block partial counts, two key arrays [C], nown [S],
// two open-row lists [S].
constexpr int W_ROUNDS = 0;
constexpr int W_CTR = 4;
constexpr int W_PART = 16;                     // long long [MAXG][2]
constexpr int W_KEY = W_PART + 4 * MAXG;       // u64 [2][C]

struct JParams {
  const void* b;                  // [S, C] bf16 or float32
  const float* p0;                // [C] start prices
  const int* owner0;              // [C] start owners (row id or -1)
  const int* sunk0;               // [S] start sunk flags
  float* p;                       // [C] out
  int* owner;                     // [C] out
  int* sunk;                      // [S] out
  int* rounds;                    // [1] rounds run
  int* ctr;                       // [3 * SLOT]
  long long* part;                // [MAXG][2]
  u64* key[2];                    // [C] each
  int* nown;                      // [S]
  int* list[2];                   // [S] each
  float eps, sink;
  int max_rounds, early, S, C, solo_max, dec_cap;
};

// A row's running top-2 with the price at j1.
struct J2 {
  float v1;
  int j1;
  float v2;
  float pj;
};

__device__ __forceinline__ J2 j2_empty() {
  J2 t;
  t.v1 = -INFINITY;
  t.j1 = 0x7fffffff;
  t.v2 = NEG_F;   // jnp: max over the other columns and the NEG slot of j1
  t.pj = 0.0f;
  return t;
}

// Columns are pushed in increasing order per thread: strict > keeps the
// lowest column on ties, and a tie at a later column still counts for v2
// (top2.cuh t2_push without its branch).  PJ: carry the price at j1 (where
// the prices are not in shared memory for the deciding lane).
template <bool PJ>
__device__ __forceinline__ void j2_push(J2& a, float v, int j, float pr) {
  const bool gt = v > a.v1;
  a.v2 = fmaxf(a.v2, gt ? a.v1 : v);
  a.v1 = gt ? v : a.v1;
  a.j1 = gt ? j : a.j1;
  if (PJ) a.pj = gt ? pr : a.pj;
}

// top2.cuh t2_merge (lowest column among equal maxima), the price with j1.
__device__ __forceinline__ J2 j2_merge(J2 a, J2 b) {
  const bool bw = (b.v1 > a.v1) || (b.v1 == a.v1 && b.j1 < a.j1);
  J2 r;
  r.v1 = bw ? b.v1 : a.v1;
  r.j1 = bw ? b.j1 : a.j1;
  r.pj = bw ? b.pj : a.pj;
  r.v2 = bw ? fmaxf(b.v2, a.v1) : fmaxf(a.v2, b.v1);
  return r;
}

__device__ __forceinline__ J2 j2_shfl_xor(J2 t, int o) {
  J2 u;
  u.v1 = __shfl_xor_sync(FULL, t.v1, o);
  u.j1 = __shfl_xor_sync(FULL, t.j1, o);
  u.v2 = __shfl_xor_sync(FULL, t.v2, o);
  u.pj = __shfl_xor_sync(FULL, t.pj, o);
  return u;
}

// Merge over aligned groups of ``width`` lanes (a power of two): every lane
// of a group ends with the group's merge.
__device__ __forceinline__ J2 j2_group_merge(J2 t, int width) {
  for (int o = 1; o < width; o <<= 1) t = j2_merge(t, j2_shfl_xor(t, o));
  return t;
}

// Eight consecutive matrix entries as loaded (one 16-byte load of bf16, two
// of float32; read once, so not kept in L1), unpacked one at a time where
// they are used, so a lane's batch takes 16 registers in either type.
template <typename T>
struct Raw8;

template <>
struct Raw8<__nv_bfloat16> {
  uint4 w;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
        : "=r"(w.x), "=r"(w.y), "=r"(w.z), "=r"(w.w)
        : "l"(p));
  }
  // bf16 -> float is the bits shifted up (__bfloat162float)
  __device__ __forceinline__ float at(int k) const {
    const unsigned int u = k < 2 ? w.x : k < 4 ? w.y : k < 6 ? w.z : w.w;
    return __uint_as_float((k & 1) ? (u & 0xffff0000u) : (u << 16));
  }
};

template <>
struct Raw8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
        : "=f"(a.x), "=f"(a.y), "=f"(a.z), "=f"(a.w)
        : "l"(p));
    asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
        : "=f"(b.x), "=f"(b.y), "=f"(b.z), "=f"(b.w)
        : "l"(p + 4));
  }
  __device__ __forceinline__ float at(int k) const {
    const float4& h = k < 4 ? a : b;
    const int q = k & 3;
    return q == 0 ? h.x : q == 1 ? h.y : q == 2 ? h.z : h.w;
  }
};

__device__ __forceinline__ void price8(const float* pr, float q[8]) {
  const float4 a = *reinterpret_cast<const float4*>(pr);
  const float4 b = *reinterpret_cast<const float4*>(pr + 4);
  q[0] = a.x; q[1] = a.y; q[2] = a.z; q[3] = a.w;
  q[4] = b.x; q[5] = b.y; q[6] = b.z; q[7] = b.w;
}

__device__ __forceinline__ void price8_l2(const float* pr, float q[8]) {
  const float4 a = __ldcg(reinterpret_cast<const float4*>(pr));
  const float4 b = __ldcg(reinterpret_cast<const float4*>(pr + 4));
  q[0] = a.x; q[1] = a.y; q[2] = a.z; q[3] = a.w;
  q[4] = b.x; q[5] = b.y; q[6] = b.z; q[7] = b.w;
}

// Ask the copy engine to bring [p, p + bytes) into L2 (16-byte multiples),
// without holding registers.
__device__ __forceinline__ void prefetch_l2(const void* p, int bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;"
               :
               : "l"(p), "r"(bytes)
               : "memory");
}

// A lane's batch of U x 8 entries (U x 256 columns apart) from ``base``.
template <typename T, int U>
__device__ __forceinline__ void load_batch(Raw8<T> (&x)[U], const T* row,
                                           int base, int c1) {
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (base + u * 256 < c1) x[u].load(row + base + u * 256);
}

template <typename T, int U, bool SMEM>
__device__ __forceinline__ void push_batch(J2& a, const Raw8<T> (&x)[U],
                                           const float* pr, int base,
                                           int c1) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int c = base + u * 256;
    if (c < c1) {
      float q[8];
      if (SMEM)
        price8(pr + c, q);
      else
        price8_l2(pr + c, q);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        j2_push<!SMEM>(a, __fsub_rn(x[u].at(k), q[k]), c + k, q[k]);
    }
  }
}

// One warp's top-2 of (row - price) over columns [c0, c1) (multiples of 8):
// a lane takes 8 consecutive columns every 256, in batches of U x 8 (64
// bytes of the matrix, 2 KB a warp), the next batch loaded while this one
// is pushed, in increasing column order.  SMEM: the prices are in shared
// memory (the deciding lane reads p[j1] there), else read from L2 (written
// by other blocks in earlier rounds) and carried with j1.  Every lane
// returns the warp's merge.
template <typename T, bool SMEM>
__device__ __forceinline__ J2 walk(const T* __restrict__ row,
                                   const float* pr, int c0, int c1,
                                   int lane) {
  constexpr int U = 8 / sizeof(T);
  constexpr int STEP = 256 * U;
  J2 a = j2_empty();
  Raw8<T> x[U], y[U];
  int base = c0 + lane * 8;
  load_batch<T, U>(x, row, base, c1);
  while (base < c1) {
    load_batch<T, U>(y, row, base + STEP, c1);
    push_batch<T, U, SMEM>(a, x, pr, base, c1);
    base += STEP;
    if (base >= c1) break;
    load_batch<T, U>(x, row, base + STEP, c1);
    push_batch<T, U, SMEM>(a, y, pr, base, c1);
    base += STEP;
  }
  return j2_group_merge(a, 32);
}

// The bid of a row that does not sink, in the reference's order.
__device__ __forceinline__ float bid_of(const J2& t, float sink, float eps) {
  return __fadd_rn(__fsub_rn(__fadd_rn(t.pj, t.v1), fmaxf(t.v2, sink)),
                   eps);
}

__device__ __forceinline__ u64 key_of(float bid, int row) {
  return ((u64)f2o(__fadd_rn(bid, 0.0f)) << 32) | (u64)(unsigned int)row;
}

// Append ``v`` (when >= 0) of every lane of a full warp to dst at a count
// taken from *cnt: one atomic a warp.
__device__ __forceinline__ void warp_append(int* dst, int* cnt, int v,
                                            int lane) {
  const unsigned m = __ballot_sync(FULL, v >= 0);
  if (m == 0u) return;
  const int lead = __ffs(m) - 1;
  int base = 0;
  if (lane == lead) base = atomicAdd(cnt, __popc(m));
  base = __shfl_sync(FULL, base, lead);
  if (v >= 0) dst[base + __popc(m & ((1u << lane) - 1u))] = v;
}

// Columns of chunk ``ci`` of ``nch`` (multiples of 8).
__device__ __forceinline__ void chunk_cols(int C, int nch, int ci, int& c0,
                                           int& c1) {
  const int cw = ((C / nch) + 7) & ~7;
  c0 = min(C, ci * cw);
  c1 = min(C, c0 + cw);
}

// Block 0 alone from round ``r`` with the ``n`` open rows (<= NWARP) of
// ``list`` (rows 0 .. n - 1 when null); returns the rounds run.
template <typename T>
__device__ __noinline__ int solo(const JParams& P, float* smem, int* s_list,
                                J2* s_part, const int* list, int r, int n,
                                long long left) {
  __shared__ int s_next, s_events;
  const int S = P.S, C = P.C;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* b = static_cast<const T*>(P.b);
  float* sp = smem;
  int* sown = reinterpret_cast<int*>(smem + C);
  int* snown = sown + C;
  int row0 = threadIdx.x;   // the list's load in flight with the state's
  if (list != nullptr && threadIdx.x < n) row0 = __ldcg(list + threadIdx.x);
  // C and S are multiples of 128: the state moves in 16-byte pieces
  for (int c = threadIdx.x * 4; c < C; c += NT * 4) {
    *reinterpret_cast<float4*>(sp + c) =
        __ldcg(reinterpret_cast<const float4*>(P.p + c));
    *reinterpret_cast<int4*>(sown + c) =
        __ldcg(reinterpret_cast<const int4*>(P.owner + c));
  }
  for (int i = threadIdx.x * 4; i < S; i += NT * 4)
    *reinterpret_cast<int4*>(snown + i) =
        __ldcg(reinterpret_cast<const int4*>(P.nown + i));
  if (threadIdx.x < n) s_list[threadIdx.x] = row0;
  __syncthreads();
  int cur = 0;
  while (r < P.max_rounds && !(P.early && left <= 0)) {
    if (n == 0) {        // nothing open: no later round changes anything
      r = P.max_rounds;
      break;
    }
    int rb = 1;
    while (rb < n) rb <<= 1;
    const int nch = NWARP / rb, lg = __ffs(nch) - 1;
    const int ri = warp >> lg, ci = warp & (nch - 1);
    J2 a = j2_empty();
    if (ri < n) {
      int c0, c1;
      chunk_cols(C, nch, ci, c0, c1);
      a = walk<T, true>(b + (size_t)s_list[cur * NWARP + ri] * C, sp, c0, c1,
                        lane);
    }
    if (lane == 0) s_part[warp] = a;
    __syncthreads();
    if (warp == 0) {
      // row q's merge ends in lane q * nch; lane q < n takes it
      const J2 g = j2_group_merge(lane < NWARP ? s_part[lane] : j2_empty(),
                                  nch);
      J2 m;
      const int src = (lane << lg) & 31;
      m.v1 = __shfl_sync(FULL, g.v1, src);
      m.j1 = __shfl_sync(FULL, g.j1, src);
      m.v2 = __shfl_sync(FULL, g.v2, src);
      const bool act = lane < n;
      const int row = act ? s_list[cur * NWARP + lane] : -1;
      if (act) m.pj = sp[m.j1];
      bool sinks = false;
      int col = -1 - lane;          // no bid: a column no other lane has
      u64 key = 0ull;
      if (act) {
        if (m.v1 <= P.sink) {
          sinks = true;
        } else {
          const float bid = bid_of(m, P.sink, P.eps);
          if (bid > -1.5e38f) {
            col = m.j1;
            key = key_of(bid, row);
          }
        }
      }
      // the column's winner: the highest key among the lanes bidding on it
      u64 best = key;
      for (int s = 0; s < n; ++s) {
        const u64 ks = __shfl_sync(FULL, key, s);
        const int cs = __shfl_sync(FULL, col, s);
        if (cs == col && ks > best) best = ks;
      }
      int push = -1, ev = 0;
      if (act) {
        if (sinks) {
          P.sunk[row] = 1;
          snown[row] = OWN_SUNK;
          ev = 1;
        } else if (col < 0 || best != key) {
          push = row;
        } else {
          const int o = sown[col];
          const float price = o2f((unsigned int)(key >> 32));
          sown[col] = row;
          sp[col] = price;
          P.owner[col] = row;   // written through: no copy back at the end
          P.p[col] = price;
          snown[row] = 1;
          if (o < 0)
            ev = 1;
          else if (o < S && atomicSub(snown + o, 1) == 1) {
            push = o;   // bids next round: bring its row into L2 now
            prefetch_l2(b + (size_t)o * C, C * sizeof(T));
          }
        }
      }
      const unsigned pm = __ballot_sync(FULL, push >= 0);
      if (push >= 0)
        s_list[(cur ^ 1) * NWARP + __popc(pm & ((1u << lane) - 1u))] = push;
      const unsigned em = __ballot_sync(FULL, ev != 0);
      if (lane == 0) {
        s_next = __popc(pm);
        s_events = __popc(em);
      }
    }
    __syncthreads();   // s_next, s_events rewritten after the next walk
    n = s_next;
    left -= s_events;
    cur ^= 1;
    ++r;
  }
  return r;
}

template <typename T>
__global__ void __launch_bounds__(NT, 1) jacobi_kernel(JParams P) {
  extern __shared__ __align__(16) float smem[];  // prices, or solo's state
  __shared__ J2 s_part[NWARP];
  __shared__ int s_list[2 * NWARP];  // solo's two open-row lists
  __shared__ int s_ndec, s_ev;
  __shared__ long long s_sum[2 * NWARP];
  cg::grid_group grid = cg::this_grid();
  const int S = P.S, C = P.C, G = gridDim.x;
  const int gtid = blockIdx.x * NT + threadIdx.x;
  const int gthreads = G * NT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* b = static_cast<const T*>(P.b);
  // decisions of this block's rows: (row, column or -1)
  int* dec_row = reinterpret_cast<int*>(
      smem + max(C, P.solo_max > 0 ? 2 * C + S : 0));
  int* dec_col = dec_row + P.dec_cap;

  // ---- start: copy the inputs, clear the scratch, count -----------------
  // per block: #owned columns + sum(sunk), and #owned + #sunk rows
  long long cnt = 0, warm = 0;
  for (int c = gtid; c < C; c += gthreads) {
    P.p[c] = __ldg(P.p0 + c);
    const int o = __ldg(P.owner0 + c);
    P.owner[c] = o;
    P.key[0][c] = 0ull;
    P.key[1][c] = 0ull;
    cnt += o >= 0;
  }
  warm = cnt;
  for (int i = gtid; i < S; i += gthreads) {
    const int s = __ldg(P.sunk0 + i);
    P.sunk[i] = s;
    P.nown[i] = s != 0 ? OWN_SUNK : 0;
    cnt += s;
    warm += s != 0;
  }
  if (gtid < 3 * SLOT) P.ctr[gtid] = 0;
  for (int o = 16; o > 0; o >>= 1) {
    cnt += __shfl_xor_sync(FULL, cnt, o);
    warm += __shfl_xor_sync(FULL, warm, o);
  }
  if (lane == 0) {
    s_sum[warp] = cnt;
    s_sum[NWARP + warp] = warm;
  }
  if (threadIdx.x == 0) {
    s_ndec = 0;
    s_ev = 0;
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    long long t = 0;
    for (int w = 0; w < NWARP; ++w) t += s_sum[threadIdx.x * NWARP + w];
    P.part[2 * blockIdx.x + threadIdx.x] = t;
  }
  grid.sync();
  // K8's count S - #owned - sum(sunk), and whether any column is owned or
  // any row sunk, in every block
  if (warp == 0) {
    long long t = 0, u = 0;
    for (int g = lane; g < G; g += 32) {
      t += __ldcg(P.part + 2 * g);
      u += __ldcg(P.part + 2 * g + 1);
    }
    for (int o = 16; o > 0; o >>= 1) {
      t += __shfl_xor_sync(FULL, t, o);
      u += __shfl_xor_sync(FULL, u, o);
    }
    if (lane == 0) {
      s_sum[0] = t;
      s_sum[1] = u;
    }
  }
  __syncthreads();
  long long left = (long long)S - s_sum[0];
  // a cold start (no owner, no sunk row) opens every row: round 0's list is
  // the identity; else count the owned columns and list the open rows
  bool ident = s_sum[1] == 0;
  int n = S;
  if (!ident) {
    for (int c = gtid; c < C; c += gthreads) {
      const int o = __ldg(P.owner0 + c);
      if (o >= 0 && o < S) atomicAdd(P.nown + o, 1);
    }
    grid.sync();
    // round 0's open rows, counted in the slot of round -1 (slot 2)
    for (int i0 = blockIdx.x * NT + warp * 32; i0 < S; i0 += gthreads) {
      const int i = i0 + lane;
      warp_append(P.list[0], P.ctr + 2 * SLOT,
                  (i < S && __ldcg(P.nown + i) == 0) ? i : -1, lane);
    }
    grid.sync();
    n = __ldcg(P.ctr + 2 * SLOT);
  }
  int ndec_prev = 0, r = 0;
  while (r < P.max_rounds && !(P.early && left <= 0)) {
    if (n == 0) {        // nothing open: no later round changes anything
      r = P.max_rounds;
      break;
    }
    if (n <= P.solo_max) {
      if (blockIdx.x != 0) return;
      r = solo<T>(P, smem, s_list, s_part, ident ? nullptr : P.list[r & 1],
                  r, n, left);
      if (threadIdx.x == 0) *P.rounds = r;
      return;
    }
    int* slot = P.ctr + (r % 3) * SLOT;
    u64* K = P.key[r & 1];
    // ---- bids ------------------------------------------------------------
    if (gtid < SLOT) P.ctr[((r + 1) % 3) * SLOT + gtid] = 0;
    {   // the keys this block posted in round r - 1 are free again
      u64* Kp = P.key[(r + 1) & 1];
      for (int k = threadIdx.x; k < ndec_prev; k += NT)
        if (dec_col[k] >= 0) Kp[dec_col[k]] = 0ull;
      __syncthreads();   // the decisions are rewritten below
    }
    int rb = 1;
    while (rb < NWARP && rb * G < n) rb <<= 1;
    const int nch = NWARP / rb, lg = __ffs(nch) - 1;
    const int ri = warp >> lg, ci = warp & (nch - 1);
    const bool stage = rb >= STAGE_RB;
    if (stage) {
      for (int c = threadIdx.x * 4; c < C; c += NT * 4)
        *reinterpret_cast<float4*>(smem + c) =
            __ldcg(reinterpret_cast<const float4*>(P.p + c));
      __syncthreads();
    }
    int c0, c1;
    chunk_cols(C, nch, ci, c0, c1);
    for (int t = blockIdx.x; t * rb < n; t += G) {
      const int idx = t * rb + ri;
      int row = -1;
      J2 a = j2_empty();
      if (idx < n) {
        row = ident ? idx : __ldcg(P.list[r & 1] + idx);
        const T* br = b + (size_t)row * C;
        a = stage ? walk<T, true>(br, smem, c0, c1, lane)
                  : walk<T, false>(br, P.p, c0, c1, lane);
      }
      if (nch > 1) {
        if (lane == 0) s_part[warp] = a;
        __syncthreads();
        if (ci == 0) {
          a = j2_group_merge(lane < nch ? s_part[warp + lane] : j2_empty(),
                             32);
        }
      }
      if (ci == 0 && lane == 0 && idx < n) {
        if (a.v1 <= P.sink) {
          P.sunk[row] = 1;
          P.nown[row] = OWN_SUNK;
          atomicAdd(&s_ev, 1);
        } else {
          if (stage) a.pj = smem[a.j1];
          const float bid = bid_of(a, P.sink, P.eps);
          int col = -1;
          if (bid > -1.5e38f) {
            col = a.j1;
            atomicMax(K + col, key_of(bid, row));
          }
          const int k = atomicAdd(&s_ndec, 1);
          dec_row[k] = row;
          dec_col[k] = col;
        }
      }
      if (nch > 1) __syncthreads();   // s_part is rewritten by the next tile
    }
    grid.sync();
    // ---- resolve: this block's decisions ---------------------------------
    const int ndec = s_ndec;
    for (int k = threadIdx.x; k < ((ndec + 31) & ~31); k += NT) {
      int push = -1;
      bool first = false;
      if (k < ndec) {
        const int row = dec_row[k], j = dec_col[k];
        if (j < 0) {
          push = row;
        } else {
          const u64 kk = __ldcg(K + j);
          const int o = __ldcg(P.owner + j);
          if ((int)(unsigned int)(kk & 0xffffffffull) != row) {
            push = row;
          } else {
            P.owner[j] = row;
            P.p[j] = o2f((unsigned int)(kk >> 32));
            P.nown[row] = 1;
            if (o < 0)
              first = true;
            else if (o < S && atomicSub(P.nown + o, 1) == 1)
              push = o;
          }
        }
      }
      warp_append(P.list[(r + 1) & 1], slot, push, lane);
      const unsigned fm = __ballot_sync(FULL, first);
      if (lane == 0 && fm) atomicAdd(&s_ev, __popc(fm));
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      if (s_ev) atomicAdd(slot + 1, s_ev);
      s_ev = 0;
      s_ndec = 0;
    }
    grid.sync();
    n = __ldcg(slot);
    left -= __ldcg(slot + 1);
    ident = false;
    ndec_prev = ndec;
    ++r;
  }
  if (gtid == 0) *P.rounds = r;
}

// Dynamic shared memory: the prices (C floats) or, with the solo endgame,
// its prices, owners and counts (2C + S words), then the block's decisions.
static size_t smem_bytes(int S, int C, int solo, int dec_cap) {
  const size_t words = (size_t)(solo ? 2 * C + S : C) + 2 * (size_t)dec_cap;
  return words * 4;
}

extern "C" size_t jacobi_scratch_bytes(int S, int C) {
  return ((size_t)W_KEY + 4 * (size_t)C + 3 * (size_t)S) * 4;
}

template <typename T>
static int launch(JParams* P, void* stream) {
  static std::mutex mu;
  static int sms[MAXDEV], dyn_max[MAXDEV];
  const void* fn = (const void*)jacobi_kernel<T>;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= MAXDEV) return (int)cudaErrorInvalidDevice;
  {
    std::lock_guard<std::mutex> lock(mu);
    if (sms[dev] == 0) {   // once a device: its attributes and occupancy
      cudaFuncAttributes fa;
      cudaFuncGetAttributes(&fa, fn);
      int n = 0, o = 0, occ = 0;
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
      cudaDeviceGetAttribute(&o, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
      const int dmax = o - (int)fa.sharedSizeBytes;
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           dmax);
      // at the largest dynamic shared memory, so any launch below it fits
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, NT,
                                                    (size_t)dmax);
      if (occ < 1 || n > MAXG) return (int)cudaErrorLaunchOutOfResources;
      dyn_max[dev] = dmax;
      sms[dev] = n;
    }
  }
  const int G = sms[dev];
  P->dec_cap = (P->S + G - 1) / G + 2 * NWARP;
  if (P->solo_max > 0 &&
      smem_bytes(P->S, P->C, 1, P->dec_cap) > (size_t)dyn_max[dev])
    P->solo_max = 0;   // no room for the solo endgame: grid rounds only
  const size_t smem = smem_bytes(P->S, P->C, P->solo_max > 0, P->dec_cap);
  if (smem > (size_t)dyn_max[dev]) return (int)cudaErrorInvalidValue;
  void* args[] = {P};
  cudaLaunchCooperativeKernel(fn, G, NT, args, smem, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

extern "C" int jacobi_rounds(const void* b, int f32, const float* p0,
                             const int* owner0, const int* sunk0, float* p,
                             int* owner, int* sunk, int* scratch, float eps,
                             float sink, int max_rounds, int early, int S,
                             int C, void* stream) {
  JParams P = {};
  P.b = b;
  P.p0 = p0;
  P.owner0 = owner0;
  P.sunk0 = sunk0;
  P.p = p;
  P.owner = owner;
  P.sunk = sunk;
  P.rounds = scratch + W_ROUNDS;
  P.ctr = scratch + W_CTR;
  P.part = reinterpret_cast<long long*>(scratch + W_PART);
  P.key[0] = reinterpret_cast<u64*>(scratch + W_KEY);
  P.key[1] = P.key[0] + C;
  P.nown = scratch + W_KEY + 4 * C;
  P.list[0] = P.nown + S;
  P.list[1] = P.list[0] + S;
  P.eps = eps;
  P.sink = sink;
  P.max_rounds = max_rounds;
  P.early = early;
  P.S = S;
  P.C = C;
  P.solo_max = SOLO_ROWS;
  return f32 ? launch<float>(&P, stream) : launch<__nv_bfloat16>(&P, stream);
}
