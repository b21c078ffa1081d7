// Gauss-Seidel auction kernels for Hopper (sm_90a), plain C interface.
//
// Replaces two Pallas TPU kernels of the JAX package:
//   * ghicp_tpu/ops/auction_rounds.py::auction_phase_gs_pallas (_gs_kernel):
//     one epsilon phase of a Gauss-Seidel forward auction with an
//     outside-option sink, on a stored benefit matrix       -> gs_phase();
//   * ghicp_tpu/ops/auction_rounds.py::auction_warm_fused_pallas
//     (_warm_fused_kernel): one warm engine iteration — sweep 0 over benefits
//     rebuilt from the FD stripe and the keypoint coordinates, the eps-CS
//     keep test, a Jacobi round 0 from the parked hints, Gauss-Seidel sweeps
//     and greedy completion                                 -> warm_fused();
//     with ``mult`` the FPFH/RoPS cost ED * expf(-k * logf(max(FD, 1e-6)))
//     (k in the wfd slot) instead of the BSC blend W_ED * ED + W_FD * FD.
// The matrix (K2's benefits, K3's FD) is bf16 or, on the auction_bf16=False
// lane, float32: each kernel is a template on its element type T; either
// way the arithmetic is float32.
//
// Bound on this card: memory for K2 (a sweep reads the open rows of its
// active tiles of the stored benefits); for K3 the float work of
// rebuilding every benefit (sqrt, and expf / logf with ``mult``) against
// one read of the FD (bf16: 134 MB at 8192^2, 40 us at 3.35 TB/s).
//
// The Gauss-Seidel sweeps (gs_sweeps, both kernels; one cooperative launch,
// one 512-thread block an SM).  Every block keeps a replica of the prices,
// the owners and the open flags.  For each active tile (the tiles with
// open rows at the sweep start, in order) the open rows are split over the
// blocks in column parts (up to 16 parts a row when the tile has few open
// rows); each part's top-2 of (b - p) goes to a global slot; after ONE grid
// sync every block merges the parts, applies the tile's bid rule (the
// highest delta wins a column, ties to the lowest row: the TPU kernel's
// first-max-lane rule) and updates its own replica identically.  No
// atomics, no bid-slot clearing and no second barrier a tile; the active
// list is counted from the replica.  (The part slots alternate between two
// buffers: a block may scan tile k + 1 while another still reads tile k's
// parts.)  The resolve finds each bid column's highest key in a hash table
// once a tile has more than TAB_MIN bidders (a cold sweep's full tiles),
// by comparing all pairs below that.  K2's solve may end in the solo
// endgame (SOLO_UNITS): block 0 alone, whole-row scans, no grid sync.
// The replica lives in shared memory where it fits (GsSmem form 0: 8 bytes
// a column and one a row, to about 23,500 slots); past that (both kernels)
// the owners move to a global slice a block (form 1: to about 42,000
// slots) and then the prices and open flags too (form 2), read through L1,
// so the shape stops at the scratch's size, not at the card's shared
// memory.  The tile counts and the tile list take 8 bytes a tile of the
// tile scratch, so the tile count has no cap of its own: a shape runs
// where the scratch of some form fits a block.  A
// part scan is a functor: K3 rebuilds each benefit from the FD and the
// factors (FdScan), K2 reads the stored matrix (MatScan), two parts at a
// time where a block has them.
//
// K2 (gs_phase_kernel<T, FORM>): the replica is loaded from the start
// state, the sweeps run from sweep 0 at eps * sched[r] (eps and sink are
// device scalars), then the rows left open are completed greedily at the
// final prices (a block-wide scan a row: best column or the sink) and the
// replica is written out.  An owner S (the row-sharded auction's owner of
// a column held by another rank's row) is carried as it is and, when its
// column is won here, reopens no local row.
//
// K3 design (warm_fused_kernel<T, MULT, LUT, FORM>):
//   sweep 0  each block owns bands of 64 rows, a warp 4 of them.  Chunks of
//            1024 columns of the column factors (x, y, z, |t|^2, mask) and
//            the bidding-start prices are staged in shared memory with
//            cp.async, double-buffered, and reused by every row of the band;
//            FD rows are read as 16-byte vectors (8 bf16 entries a lane).
//            Each lane keeps its rows' top-2, vsel and the benefit max in
//            registers and a warp merges them by shuffles: no block barrier
//            a row.  The top-2 merge (t2_merge) is lexicographic (highest
//            value, then lowest column) and vsel / bmax are maxima, so any
//            split gives the same bits as the plain version.  (K1's
//            fused_benefit, csrc/cost.cu, walks the same bands with the
//            helpers of sweep.cuh.)
//   round 0  the keep test, the column release and the round-0 Jacobi bids
//            (64-bit atomicMax slots) between grid syncs, as the TPU kernel.
//   sweeps   gs_sweeps from sweep 1, the replica in replica form FORM
//            (sweep 0's staging, two buffers of six 1024-column arrays,
//            shares the shared memory with the replica's part there).
//   end      greedy completion of the rows left open from the parked hints,
//            then the replica is written out.
// The scratch (bid slots, hints, part slots, the benefit-max key, a counter,
// K2's global replicas) comes from the wrapper, made once an engine run;
// the kernels leave the bid slots and the counter at zero and the max key
// at orderable(-3e38), as they found them.
//
// Everything that must match the plain PyTorch version bit for bit is
// computed with explicitly rounded intrinsics (no FMA contraction; expf and
// logf, as PyTorch's exp and log on the card, never __expf / __logf), and the
// escalation schedule comes in as a precomputed table, so kernel and plain
// version read the same epsilon values.
//
// Every entry returns cudaGetLastError() of its launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sweep.cuh"
#include "top2.cuh"

namespace cg = cooperative_groups;

constexpr int GMAX = 16;             // most column parts of one GS row
constexpr int TRACE_SWEEPS = 30;     // trace slots for active tiles a sweep
// A tile's (row, part) slots number at most max(ts, blocks) <= MAX_ITEMS.
constexpr int MAX_ITEMS = 1024;
// The resolve of a tile with more than TAB_MIN bidders finds each column's
// highest key in a hash table of TAB slots (in the part slots' shared
// memory, free once the parts are merged); fewer compare all pairs.
constexpr int TAB = 1024;
constexpr int TAB_MIN = 32;
// K2's endgame: from the sweep whose open rows would cost block 0 at most
// SOLO_UNITS 8-column units of scan an active tile (two rows of 8192
// columns), block 0 goes on alone: whole-row scans and no grid sync.  A
// grid step costs a light tile ~2 us whatever its rows; a block's
// whole-row scan grows with the row (at 24,576 columns one row costs
// about a step).
constexpr int SOLO_UNITS = 2048;
static_assert(12 * TAB <= 12 * MAX_ITEMS, "the table fits the part slots");

// ===========================================================================
// The Gauss-Seidel sweeps (K2 and K3)
// ===========================================================================

// Shared memory of the Gauss-Seidel sweeps (byte offsets): the replica's
// part of replica form ``form`` (0: prices, owners and open flags; 1:
// prices and open flags, the owners in a global slice a block; 2: none,
// all three in global slices) and the tile scratch from ``key`` on.
struct GsSmem {
  int p, own, key, rows, col, cnt, list, t, part, misc, open, total;
  __host__ __device__ GsSmem(int S, int C, int ts, int n_tiles, int form) {
    p = 0;
    own = p + (form <= 1 ? 4 * C : 0);
    key = own + (form == 0 ? 4 * C : 0);
    rows = key + 8 * ts;
    col = rows + 4 * ts;
    cnt = col + 4 * ts;
    list = cnt + 4 * n_tiles;
    t = list + 4 * n_tiles;
    part = t + 16 * WNWARP;
    misc = part + 12 * MAX_ITEMS;
    open = misc + 16;
    total = open + (form <= 1 ? ((S + 15) & ~15) : 0);
  }
};

// A block's replica of the prices, owners and open flags (shared memory,
// or the block's slice of a global scratch array).
struct Replica {
  float* p;
  int* own;
  unsigned char* open;
};

// What the sweeps read and write besides the block's replica.
struct GsArgs {
  int S, C, ts, n_tiles, max_rounds;
  const float* sched;   // [max_rounds] escalation boost per sweep
  float* part;          // [2][ts][GMAX][3] part top-2 slots
  int* sunk;            // rows taking the sink are set here
  int* trace;           // [3 + TRACE_SWEEPS]: [2] rows scanned, [3 + k]
                        // active tiles of the k-th sweep
};

// The block's merge of every thread's top-2 ``t``; all threads return it.
__device__ __forceinline__ Top2 block_top2(Top2 t, Top2* s_t) {
  t = t2_warp_merge(t);
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  if (l == 0) s_t[w] = t;
  __syncthreads();
  Top2 r = s_t[0];
  for (int j = 1; j < WNWARP; ++j) r = t2_merge(r, s_t[j]);
  __syncthreads();   // s_t is reused by the next part
  return r;
}

// Top-2 of (b - p) of ``row`` over the 8-column units [u0, u1), at the
// block's replica prices; all threads return the block's merge.
template <typename Scan>
__device__ __forceinline__ Top2 part_scan(const Scan& scan, const float* s_p,
                                          Top2* s_t, int row, int u0,
                                          int u1) {
  return block_top2(scan(s_p, row, u0, u1), s_t);
}

// The block's merges of two sets of per-thread top-2s (``a`` through
// ``s_a``, ``b`` through ``s_b``) with one pair of barriers.
__device__ __forceinline__ void block_top2_pair(Top2& a, Top2& b, Top2* s_a,
                                                Top2* s_b) {
  a = t2_warp_merge(a);
  b = t2_warp_merge(b);
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  if (l == 0) {
    s_a[w] = a;
    s_b[w] = b;
  }
  __syncthreads();
  a = s_a[0];
  b = s_b[0];
  for (int j = 1; j < WNWARP; ++j) {
    a = t2_merge(a, s_a[j]);
    b = t2_merge(b, s_b[j]);
  }
  __syncthreads();
}

// Store a part's top-2 in its global slot.
__device__ __forceinline__ void put_part(float* d, const Top2& o) {
  __stcg(d, o.v1);
  __stcg(d + 1, __int_as_float(o.j1));
  __stcg(d + 2, o.v2);
}

// Gauss-Seidel sweeps from sweep r0 on, over the block's replica; returns
// the sweep count.  ``sm`` is the tile scratch (GsSmem's part from ``key``
// on, laid out as GsSmem without the replica); with ``count_open`` block 0
// writes the rows open at the first sweep's start to trace[0].  With
// ``solo_ok`` the sweeps may end in the solo endgame (SOLO_UNITS): every
// block decides it alike at a sweep start, syncs the grid once more and
// all but block 0 return; ``solo`` tells the caller.
template <typename Scan>
__device__ int gs_sweeps(const GsArgs& A, cg::grid_group& grid,
                         unsigned char* sm, const Replica& R,
                         const Scan& scan, float eps, float sink, int r0,
                         bool count_open, bool solo_ok, bool& solo) {
  const GsSmem L(A.S, A.C, A.ts, A.n_tiles, 2);
  float* s_p = R.p;
  int* s_own = R.own;
  unsigned char* s_open = R.open;
  unsigned long long* s_key =
      reinterpret_cast<unsigned long long*>(sm + L.key);
  int* s_rows = reinterpret_cast<int*>(sm + L.rows);
  int* s_col = reinterpret_cast<int*>(sm + L.col);
  int* s_cnt = reinterpret_cast<int*>(sm + L.cnt);
  int* s_list = reinterpret_cast<int*>(sm + L.list);
  Top2* s_t = reinterpret_cast<Top2*>(sm + L.t);
  Top2* s_part = reinterpret_cast<Top2*>(sm + L.part);
  int* s_misc = reinterpret_cast<int*>(sm + L.misc);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ts = A.ts, U = A.C / 8;
  const int gcap = min(GMAX, max(1, U / 64));   // parts of >= 512 columns
  int r = r0, k = 0, scans = 0;
  while (true) {
    for (int i = tid; i < A.n_tiles; i += WNT) s_cnt[i] = 0;
    __syncthreads();
    if (ts % 32 == 0) {   // a warp's 32 rows lie in one tile
      for (int i0 = tid & ~31; i0 < A.S; i0 += WNT) {
        const unsigned int bal = __ballot_sync(0xffffffffu, s_open[i0 + lane]);
        if (lane == 0 && bal) atomicAdd(&s_cnt[i0 / ts], __popc(bal));
      }
    } else {
      for (int i = tid; i < A.S; i += WNT)
        if (s_open[i]) atomicAdd(&s_cnt[i / ts], 1);
    }
    __syncthreads();
    if (tid == 0) {
      int n = 0, tot = 0;
      for (int i = 0; i < A.n_tiles; ++i) {
        tot += s_cnt[i];
        if (s_cnt[i] > 0) s_list[n++] = i;
      }
      s_misc[0] = n;
      s_misc[1] = tot;
    }
    __syncthreads();
    const int n_active = s_misc[0];
    if (count_open && r == r0 && blockIdx.x == 0 && tid == 0)
      A.trace[0] = s_misc[1];
    if (s_misc[1] == 0 || r >= A.max_rounds) break;
    if (solo_ok && !solo && s_misc[1] * U <= SOLO_UNITS * n_active) {
      solo = true;
      grid.sync();   // every block's writes so far land before block 0's
      if (blockIdx.x != 0) return r;
    }
    if (blockIdx.x == 0 && tid == 0 && r - r0 < TRACE_SWEEPS)
      A.trace[3 + r - r0] = n_active;
    const float eps_r = __fmul_rn(eps, A.sched[r]);
    for (int j = 0; j < n_active; ++j, ++k) {
      const int tile = s_list[j];
      // the tile's open rows, in order: a warp a group of 32 rows, each
      // group at the open rows of the groups before it (their counts in
      // s_t, free until the scan)
      const int ng = (ts + 31) / 32;   // <= WNWARP
      int* s_gcnt = reinterpret_cast<int*>(s_t);
      unsigned int bal = 0u;
      if (warp < ng) {
        const int i = warp * 32 + lane;
        bal = __ballot_sync(0xffffffffu, i < ts && s_open[tile * ts + i]);
        if (lane == 0) s_gcnt[warp] = __popc(bal);
      }
      __syncthreads();
      if (warp < ng) {
        int off = 0;
        for (int w = 0; w < warp; ++w) off += s_gcnt[w];
        if ((bal >> lane) & 1u)
          s_rows[off + __popc(bal & ((1u << lane) - 1u))] = warp * 32 + lane;
        if (warp == ng - 1 && lane == 0) s_misc[2] = off + __popc(bal);
      }
      __syncthreads();
      const int n = s_misc[2];
      scans += n;
      // solo: block 0 scans whole rows into its own part slots
      const int nb = solo ? 1 : (int)gridDim.x;
      const int g = solo ? 1 : min(gcap, max(1, nb / n));
      float* part = A.part + (size_t)(k & 1) * ts * GMAX * 3;
      // scan: item = (open row i, column part q); a block takes items
      // it, it + grid, ...: two at a time where the scan can pair them
      // (the second's warp partials in the part slots' upper half, free
      // during the scan)
      const int items = n * g;
      for (int it = solo ? 0 : blockIdx.x; it < items; it += nb) {
        const int i = it / g, q = it - i * g;
        if constexpr (Scan::PAIR) {
          const int it2 = it + nb;
          if (it2 < items) {
            const int i2 = it2 / g, q2 = it2 - i2 * g;
            Top2 a, b;
            scan.pair(s_p, tile * ts + s_rows[i], q * U / g, (q + 1) * U / g,
                      tile * ts + s_rows[i2], q2 * U / g, (q2 + 1) * U / g,
                      a, b);
            block_top2_pair(a, b, s_t, s_part + MAX_ITEMS / 2);
            if (tid == 0) {
              if (solo) {
                s_part[it] = a;
                s_part[it2] = b;
              } else {
                put_part(part + ((size_t)i * GMAX + q) * 3, a);
                put_part(part + ((size_t)i2 * GMAX + q2) * 3, b);
              }
            }
            it = it2;
            continue;
          }
        }
        const Top2 o = part_scan(scan, s_p, s_t, tile * ts + s_rows[i],
                                 q * U / g, (q + 1) * U / g);
        if (tid == 0) {
          if (solo)
            s_part[it] = o;
          else
            put_part(part + ((size_t)i * GMAX + q) * 3, o);
        }
      }
      if (!solo) {
        grid.sync();
        // resolve, the same in every block: merge the parts, bid, decide
        for (int it = tid; it < n * g; it += WNT) {
          const int i = it / g, q = it - i * g;
          const float* d = part + ((size_t)i * GMAX + q) * 3;
          Top2 u;
          u.v1 = __ldcg(d);
          u.j1 = __float_as_int(__ldcg(d + 1));
          u.v2 = __ldcg(d + 2);
          s_part[it] = u;
        }
      }
      __syncthreads();
      int row = -1, col = -1;
      unsigned long long key = 0ull;
      if (tid < n) {
        Top2 o = s_part[tid * g];
        for (int q = 1; q < g; ++q) o = t2_merge(o, s_part[tid * g + q]);
        row = tile * ts + s_rows[tid];
        if (o.v1 > sink) {
          const float delta =
              __fadd_rn(__fsub_rn(o.v1, fmaxf(o.v2, sink)), eps_r);
          col = o.j1;
          key = ((unsigned long long)f2o(delta) << 32) |
                (unsigned long long)(0xffffffffu - (unsigned int)row);
        }
        s_col[tid] = col;
        s_key[tid] = key;
      }
      __syncthreads();
      // the highest key of each bid column wins it
      bool win = false;
      if (n > TAB_MIN) {
        unsigned long long* h_key =
            reinterpret_cast<unsigned long long*>(sm + L.part);
        int* h_col = reinterpret_cast<int*>(sm + L.part + 8 * TAB);
        for (int h = tid; h < TAB; h += WNT) {
          h_key[h] = 0ull;
          h_col[h] = -1;
        }
        __syncthreads();
        int h = -1;
        if (col >= 0) {
          h = (int)(((unsigned int)col * 2654435761u) >> 22);   // 10 bits
          while (true) {
            const int prev = atomicCAS(h_col + h, -1, col);
            if (prev == -1 || prev == col) break;
            h = (h + 1) & (TAB - 1);
          }
          atomicMax(h_key + h, key);
        }
        __syncthreads();
        win = h >= 0 && h_key[h] == key;
      } else if (col >= 0) {
        win = true;
        for (int m = 0; m < n; ++m)
          if (s_col[m] == col && s_key[m] > key) win = false;
      }
      if (tid < n) {
        if (col < 0) {
          s_open[row] = 0;
          if (solo || tid % gridDim.x == blockIdx.x) A.sunk[row] = 1;
        } else {
          if (win) {
            const int victim = s_own[col];
            s_own[col] = row;
            s_p[col] = __fadd_rn(s_p[col], o2f((unsigned int)(key >> 32)));
            s_open[row] = 0;
            // a victim of another rank's rows (owner S, the sharded
            // auction's foreign owner) has no local open flag
            if (victim >= 0 && victim < A.S) s_open[victim] = 1;
          }
        }
      }
      __syncthreads();
    }
    ++r;
  }
  if (blockIdx.x == 0 && tid == 0) A.trace[2] = scans;
  return r;
}

// ===========================================================================
// K2: one Gauss-Seidel phase on the stored benefits
// ===========================================================================

struct GsParams {
  int S, C, ts, n_tiles, max_rounds, complete;
  const void* mat;                // benefits b [S, C] (bf16 or float32: T)
  const float* p0;                // [C] start state
  const int* owner0;              // [C]
  const int* sunk0;               // [S]
  const int* open0;               // [S]
  const float* sched;             // [max_rounds]
  const float* epsp;              // device scalars
  const float* sinkp;
  // outputs
  float* p;
  int* owner;
  int* sunk;
  int* gcol;
  int* rounds;
  // scratch
  float* part;                    // [2][ts][GMAX][3]
  int* trace;                     // [3 + TRACE_SWEEPS]: rows open at the
                                  // start, sweeps, rows scanned, active
                                  // tiles a sweep
  float* rp;                      // form 2: [blocks][C] replica prices
  int* rown;                      // forms 1, 2: [blocks][C] replica owners
  unsigned char* ropen;           // form 2: [blocks][S] replica open flags
};

// K2's part scan: the stored row of benefits less the replica prices.  A
// thread pushes its units u0 + tid, u0 + tid + WNT, ... in that order.
template <typename T>
struct MatScan {
  static constexpr bool PAIR = true;
  const T* mat;
  int C;
  // Push the 8 columns from c0 of a row's loaded entries ``x``.
  __device__ __forceinline__ static void push8(Top2& t, const float* x,
                                               const float* s_p, int c0) {
    const float4 pa = *reinterpret_cast<const float4*>(s_p + c0);
    const float4 pb = *reinterpret_cast<const float4*>(s_p + c0 + 4);
    const float pv[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
#pragma unroll
    for (int q = 0; q < 8; ++q) t2_push(t, __fsub_rn(x[q], pv[q]), c0 + q);
  }
  __device__ __forceinline__ Top2 operator()(const float* s_p, int row,
                                             int u0, int u1) const {
    const T* rp = mat + (size_t)row * C;
    Top2 t = t2_empty();
    for (int u = u0 + threadIdx.x; u < u1; u += WNT) {
      float x[8];
      load8(rp + (size_t)u * 8, x);
      push8(t, x, s_p, u * 8);
    }
    return t;
  }
  // Two parts at once (row ra over units [a0, a1), rb over [b0, b1)),
  // each thread taking the same units as two single scans, their loads
  // in flight together.
  __device__ __forceinline__ void pair(const float* s_p, int ra, int a0,
                                       int a1, int rb, int b0, int b1,
                                       Top2& ta, Top2& tb) const {
    const T* pa = mat + (size_t)ra * C;
    const T* pb = mat + (size_t)rb * C;
    ta = t2_empty();
    tb = t2_empty();
    const int na = a1 - a0, nb = b1 - b0;
    for (int k = threadIdx.x; k < max(na, nb); k += WNT) {
      float xa[8], xb[8];
      if (k < na) load8(pa + (size_t)(a0 + k) * 8, xa);
      if (k < nb) load8(pb + (size_t)(b0 + k) * 8, xb);
      if (k < na) push8(ta, xa, s_p, (a0 + k) * 8);
      if (k < nb) push8(tb, xb, s_p, (b0 + k) * 8);
    }
  }
};

template <typename T, int FORM>
__global__ void __launch_bounds__(WNT, 1) gs_phase_kernel(GsParams P) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int gtid = blockIdx.x * WNT + threadIdx.x;
  const int gthreads = gridDim.x * WNT;
  const float eps = *P.epsp, sink = *P.sinkp;
  const GsSmem L(P.S, P.C, P.ts, P.n_tiles, FORM);
  unsigned char* tsm = smem + L.key;   // the sweeps' tile scratch
  Replica R;
  R.p = FORM <= 1 ? reinterpret_cast<float*>(smem + L.p)
                  : P.rp + (size_t)blockIdx.x * P.C;
  R.own = FORM == 0 ? reinterpret_cast<int*>(smem + L.own)
                    : P.rown + (size_t)blockIdx.x * P.C;
  R.open = FORM <= 1 ? smem + L.open : P.ropen + (size_t)blockIdx.x * P.S;
  for (int c = threadIdx.x; c < P.C; c += WNT) {
    R.p[c] = P.p0[c];
    R.own[c] = P.owner0[c];
  }
  for (int i = threadIdx.x; i < P.S; i += WNT)
    R.open[i] = P.open0[i] != 0 ? 1 : 0;
  // sink decisions are written after a grid sync, so after this copy
  for (int i = gtid; i < P.S; i += gthreads) P.sunk[i] = P.sunk0[i];
  __syncthreads();
  const GsArgs A = {P.S, P.C, P.ts, P.n_tiles, P.max_rounds,
                    P.sched, P.part, P.sunk, P.trace};
  const MatScan<T> scan = {static_cast<const T*>(P.mat), P.C};
  bool solo = false;
  const int r = gs_sweeps(A, grid, tsm, R, scan, eps, sink, 0, true, true,
                          solo);
  if (solo && blockIdx.x != 0) return;   // block 0 holds the final state
  const int b0 = solo ? 0 : blockIdx.x, nb = solo ? 1 : gridDim.x;
  const int t0 = solo ? threadIdx.x : gtid, nt = solo ? WNT : gthreads;
  // greedy completion of the rows still open: the best column at the
  // final prices or the sink (-1: the row was not open, C: the sink); a
  // block a row, or block 0 alone finding them WNT rows at a time
  const GsSmem Lt(P.S, P.C, P.ts, P.n_tiles, 2);
  Top2* s_t = reinterpret_cast<Top2*>(tsm + Lt.t);
  unsigned int* s_m = reinterpret_cast<unsigned int*>(tsm + Lt.part);
  const auto complete = [&](int row) {
    const Top2 o = part_scan(scan, R.p, s_t, row, 0, P.C / 8);
    if (threadIdx.x == 0) P.gcol[row] = (o.v1 > sink) ? o.j1 : P.C;
  };
  if (P.complete && !solo) {
    for (int row = b0; row < P.S; row += nb)
      if (R.open[row]) complete(row);   // block-uniform
  } else if (P.complete) {
    for (int base = 0; base < P.S; base += WNT) {
      const int i = base + threadIdx.x;
      const unsigned int bal =
          __ballot_sync(0xffffffffu, i < P.S && R.open[i]);
      if ((threadIdx.x & 31) == 0) s_m[threadIdx.x >> 5] = bal;
      __syncthreads();
      for (int w = 0; w < WNWARP; ++w)
        for (unsigned int m = s_m[w]; m; m &= m - 1u)
          complete(base + w * 32 + __ffs(m) - 1);
      __syncthreads();   // s_m is rewritten
    }
  }
  for (int i = t0; i < P.S; i += nt)
    if (!R.open[i] || !P.complete) P.gcol[i] = -1;
  for (int c = t0; c < P.C; c += nt) {
    P.p[c] = R.p[c];
    P.owner[c] = R.own[c];
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *P.rounds = r;
    P.trace[1] = r;
  }
}

// K2's dynamic shared memory in replica form ``form`` (GsSmem).
static size_t gs_smem(int S, int C, int ts, int form) {
  return (size_t)GsSmem(S, C, ts, S / ts, form).total;
}

// K2's replica form at this shape: the first of 0, 1, 2 (GsSmem) whose
// shared memory fits a block; -1 no form (a tile of more than WNT rows, or
// a tile scratch past a block's shared memory even in form 2).
extern "C" int gs_phase_form(int S, int C, int ts) {
  if (ts > WNT) return -1;
  for (int form = 0; form <= 2; ++form)
    if (gs_smem(S, C, ts, form) <= SMEM_MAX) return form;
  return -1;
}

extern "C" size_t gs_phase_smem(int S, int C, int ts, int form) {
  return gs_smem(S, C, ts, form);
}

template <typename T, int FORM>
static int launch_gs(GsParams* P, int nblk, void* stream) {
  static int sms = 0;
  const void* fn = (const void*)gs_phase_kernel<T, FORM>;
  const size_t smem = gs_smem(P->S, P->C, P->ts, FORM);
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)SMEM_MAX);
  }
  int occ = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, WNT, smem);
  if (occ < 1) return (int)cudaErrorLaunchOutOfResources;
  int blocks = min(sms, MAX_ITEMS);
  if (FORM > 0) blocks = min(blocks, nblk);   // the replica slices there are
  void* args[] = {P};
  cudaLaunchCooperativeKernel(fn, blocks, WNT, args, smem,
                              (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

extern "C" int gs_phase(const void* b, int f32, const float* p0,
                        const int* owner0, const int* sunk0, const int* open0,
                        const float* sched, const float* epsp,
                        const float* sinkp, int max_rounds, int complete,
                        int S, int C, int ts, float* p, int* owner, int* sunk,
                        int* gcol, int* rounds, float* part, int* trace,
                        float* rp, int* rown, unsigned char* ropen, int nblk,
                        int form, void* stream) {
  GsParams P = {};
  P.S = S;
  P.C = C;
  P.ts = ts;
  P.n_tiles = S / ts;
  P.max_rounds = max_rounds;
  P.complete = complete;
  P.mat = b;
  P.p0 = p0;
  P.owner0 = owner0;
  P.sunk0 = sunk0;
  P.open0 = open0;
  P.sched = sched;
  P.epsp = epsp;
  P.sinkp = sinkp;
  P.p = p;
  P.owner = owner;
  P.sunk = sunk;
  P.gcol = gcol;
  P.rounds = rounds;
  P.part = part;
  P.trace = trace;
  P.rp = rp;
  P.rown = rown;
  P.ropen = ropen;
  // the form the wrapper's scratch was made for: at least the shape's
  // own (a larger one keeps more of the replica in global memory)
  const int fit = gs_phase_form(S, C, ts);
  if (fit < 0 || form < fit || form > 2) return (int)cudaErrorInvalidValue;
  if (form > 0 && (rown == nullptr || nblk < 1))
    return (int)cudaErrorInvalidValue;
  if (form > 1 && (rp == nullptr || ropen == nullptr))
    return (int)cudaErrorInvalidValue;
  if (f32)
    return form == 0 ? launch_gs<float, 0>(&P, nblk, stream)
           : form == 1 ? launch_gs<float, 1>(&P, nblk, stream)
                       : launch_gs<float, 2>(&P, nblk, stream);
  return form == 0 ? launch_gs<__nv_bfloat16, 0>(&P, nblk, stream)
         : form == 1 ? launch_gs<__nv_bfloat16, 1>(&P, nblk, stream)
                     : launch_gs<__nv_bfloat16, 2>(&P, nblk, stream);
}

// ===========================================================================
// K3: the warm fused iteration
// ===========================================================================

struct WarmParams {
  int S, C, ts, n_tiles, max_rounds;
  float wed, wfd, scale, eps_abs, rel_eps;
  const void* fd;                 // [S, C] bf16 or float32 (T)
  const float* kps;               // [S, 3] source keypoints
  const float* kt;                // [5, C] target x, y, z, |t|^2, mask (0/1)
  const unsigned char* ms;        // [S] source mask
  const float* p0;                // [C] bidding-start prices
  const long long* owner0;        // [C]
  const long long* acol0;         // [S]
  const int* sunk0;               // [S]
  const unsigned char* ownok;     // [S]
  const float* sched;             // [max_rounds]
  const float* sinkp;             // device scalars
  const float* dpenp;
  // outputs
  float* p;
  int* owner;
  int* sunk;
  int* gcol;
  int* rounds;
  float* stats;                   // [b_max, 0, eps, eps_keep]
  // scratch
  unsigned long long* bid;        // [C]: zero on entry and exit
  int* open;                      // [S]
  int* vic;                       // [C]
  float* hv1;                     // [S] parked hints
  int* hj1;
  float* hv2;
  float* hvsel;
  float* part;                    // [2][ts][GMAX][3] part top-2 slots
  unsigned int* bmax;             // [1]: orderable(-3e38) on entry and exit
  int* cnt;                       // [1]: zero on entry and exit
  int* trace;                     // [3 + TRACE_SWEEPS]: rows open after
                                  // the keep test, sweeps, rows scanned in
                                  // sweeps >= 1, active tiles a sweep
  float* rp;                      // form 2: [blocks][C] replica prices
  int* rown;                      // forms 1, 2: [blocks][C] replica owners
  unsigned char* ropen;           // form 2: [blocks][S] replica open flags
};

// Sweep 0: hints (v1, j1, v2, vsel) of every row at the bidding-start
// prices and the block's benefit max, folded into P.bmax.
template <typename T, bool MULT, bool LUT>
__device__ void sweep0(const WarmParams& P, float* sm, const float* lut) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int S = P.S, C = P.C;
  const int nch = (C + CHUNK - 1) / CHUNK;
  float bmx = NEG_F;
  for (int band = blockIdx.x; band * BAND < S; band += gridDim.x) {
    float sx[RPW], sy[RPW], sz[RPW], sw[RPW], vs[RPW];
    int ac[RPW], mode[RPW];   // mode: 0 no row, 1 masked row, 2 valid row
    Top2 t[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int row = band * BAND + warp * RPW + r;
      t[r] = t2_empty();
      vs[r] = NEG_F;
      sx[r] = sy[r] = sz[r] = sw[r] = 0.0f;
      ac[r] = -1;
      mode[r] = 0;
      if (row < S) {
        const float* k = P.kps + 3 * (size_t)row;
        sx[r] = k[0];
        sy[r] = k[1];
        sz[r] = k[2];
        sw[r] = sq_norm(sx[r], sy[r], sz[r]);
        const long long a = P.acol0[row];
        ac[r] = (a >= 0 && a < C) ? (int)a : -1;
        mode[r] = P.ms[row] ? 2 : 1;
      }
    }
    const T* fdb =
        static_cast<const T*>(P.fd) + (size_t)(band * BAND + warp * RPW) * C;
    stage_chunk(P.kt, P.p0, C, sm, 0, min(CHUNK, C));
    cp_commit();
    for (int ch = 0; ch < nch; ++ch) {
      const int cb = ch * CHUNK;
      if (ch + 1 < nch)
        stage_chunk(P.kt, P.p0, C, sm + ((ch + 1) & 1) * NARR * CHUNK,
                    cb + CHUNK, min(CHUNK, C - cb - CHUNK));
      cp_commit();
      cp_wait1();
      __syncthreads();
      const float* b = sm + (ch & 1) * NARR * CHUNK;
      const int width = min(CHUNK, C - cb);
      for (int ps = 0; ps * 256 < width; ++ps) {
        const int c0 = cb + ps * 256 + lane * 8;
        if (c0 >= C) continue;
        Raw8<T> x[RPW];
#pragma unroll
        for (int r = 0; r < RPW; ++r)
          if (mode[r] == 2) x[r].load(fdb + (size_t)r * C + c0);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          Cols4 k;
          k.load(b, ps * 256 + h * 128 + lane * 4);
#pragma unroll
          for (int r = 0; r < RPW; ++r) {
            if (mode[r] == 0) continue;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int c = c0 + h * 4 + q;
              float bt = NEG_F;
              if (mode[r] == 2 && k.m[q] != 0.0f)
                bt = entry_benefit<MULT>(
                    P.wed, P.wfd, P.scale, sx[r], sy[r], sz[r], sw[r],
                    k.x[q], k.y[q], k.z[q], k.w[q],
                    MULT ? 0.0f : x[r].get(h * 4 + q),
                    MULT ? fd_weight<T, LUT>(P.wfd, lut, x[r], h * 4 + q)
                         : 0.0f);
              const float v = __fsub_rn(bt, k.p[q]);
              t2_push(t[r], v, c);
              if (c == ac[r]) vs[r] = fmaxf(vs[r], v);
              bmx = fmaxf(bmx, bt);
            }
          }
        }
      }
      __syncthreads();   // buffer (ch & 1) is free for chunk ch + 2
    }
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      if (mode[r] == 0) continue;   // warp-uniform
      const Top2 o = t2_warp_merge(t[r]);
      float v = vs[r];
      for (int s = 16; s > 0; s >>= 1)
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, s));
      if (lane == 0) {
        const int row = band * BAND + warp * RPW + r;
        P.hv1[row] = o.v1;
        P.hj1[row] = o.j1;
        P.hv2[row] = o.v2;
        P.hvsel[row] = v;
      }
    }
  }
  for (int s = 16; s > 0; s >>= 1)
    bmx = fmaxf(bmx, __shfl_xor_sync(0xffffffffu, bmx, s));
  if (lane == 0) atomicMax(P.bmax, f2o(bmx));
}

// K3's part scan: each benefit rebuilt from the FD and the factors.
template <typename T, bool MULT, bool LUT>
struct FdScan {
  static constexpr bool PAIR = false;
  int C;
  float wed, wfd, scale;
  const T* fd;
  const float* kps;
  const float* kt;
  const unsigned char* ms;
  const float* lut;
  __device__ __forceinline__ Top2 operator()(const float* s_p, int row,
                                             int u0, int u1) const {
    const float* k = kps + 3 * (size_t)row;
    const float sx = k[0], sy = k[1], sz = k[2];
    const float sw = sq_norm(sx, sy, sz);
    const bool valid = ms[row] != 0;
    const T* rp = fd + (size_t)row * C;
    Top2 t = t2_empty();
    for (int u = u0 + threadIdx.x; u < u1; u += WNT) {
      const int c0 = u * 8;
      Raw8<T> x;
      if (valid) x.load(rp + c0);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = c0 + 4 * h;
        const float4 X = __ldg(reinterpret_cast<const float4*>(kt + c));
        const float4 Y = __ldg(reinterpret_cast<const float4*>(kt + C + c));
        const float4 Z =
            __ldg(reinterpret_cast<const float4*>(kt + 2 * C + c));
        const float4 W =
            __ldg(reinterpret_cast<const float4*>(kt + 3 * C + c));
        const float4 M =
            __ldg(reinterpret_cast<const float4*>(kt + 4 * C + c));
        const float4 Q = *reinterpret_cast<const float4*>(s_p + c);
        const float tx[4] = {X.x, X.y, X.z, X.w};
        const float ty[4] = {Y.x, Y.y, Y.z, Y.w};
        const float tz[4] = {Z.x, Z.y, Z.z, Z.w};
        const float tw[4] = {W.x, W.y, W.z, W.w};
        const float tm[4] = {M.x, M.y, M.z, M.w};
        const float tp[4] = {Q.x, Q.y, Q.z, Q.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float bt = NEG_F;
          if (valid && tm[q] != 0.0f)
            bt = entry_benefit<MULT>(
                wed, wfd, scale, sx, sy, sz, sw, tx[q], ty[q], tz[q], tw[q],
                MULT ? 0.0f : x.get(4 * h + q),
                MULT ? fd_weight<T, LUT>(wfd, lut, x, 4 * h + q) : 0.0f);
          t2_push(t, __fsub_rn(bt, tp[q]), c + q);
        }
      }
    }
    return t;
  }
};

template <typename T, bool MULT, bool LUT, int FORM>
__global__ void __launch_bounds__(WNT, 1) warm_fused_kernel(WarmParams P) {
  extern __shared__ __align__(16) unsigned char smem_all[];
  // [the mult factor table (LUT)][sweep 0's staging | the sweeps' replica]
  float* lut = reinterpret_cast<float*>(smem_all);
  unsigned char* smem = smem_all + (LUT ? LUT_BYTES : 0);
  cg::grid_group grid = cg::this_grid();
  const int gtid = blockIdx.x * WNT + threadIdx.x;
  const int gthreads = gridDim.x * WNT;
  const float sink = *P.sinkp, dpen = *P.dpenp;
  if (LUT) {
    fill_lut(P.wfd, lut);
    __syncthreads();
  }
  // ---- sweep 0: exact hints at the bidding-start prices ----------------
  sweep0<T, MULT, LUT>(P, reinterpret_cast<float*>(smem), lut);
  for (int c = gtid; c < P.C; c += gthreads) {
    P.p[c] = P.p0[c];
    P.owner[c] = (int)P.owner0[c];
  }
  grid.sync();
  // ---- keep test, column release and round-0 bids ----------------------
  const float bmax = o2f(__ldcg(P.bmax));
  const float spread = fmaxf(__fsub_rn(bmax, sink), 0.0f);
  const float eps = fmaxf(P.eps_abs, __fmul_rn(P.rel_eps, spread));
  const float hi = fmaxf(__fdiv_rn(spread, 8.0f), eps);
  const float eps_keep =
      fminf(fmaxf(__fadd_rn(dpen, __fmul_rn(2.0f, eps)), eps), hi);
  int n_bid = 0;
  for (int i = gtid; i < P.S; i += gthreads) {
    const float v1 = __ldcg(P.hv1 + i);
    const bool valid = P.ms[i] != 0;
    const bool ownok = P.ownok[i] != 0;
    const float thr = __fsub_rn(v1, eps_keep);
    const bool keep = ownok && (__ldcg(P.hvsel + i) >= thr);
    const bool stay_sunk = (P.sunk0[i] != 0) && (sink >= thr);
    const bool open_t = valid && !(keep || stay_sunk);
    const bool to_sink = open_t && (v1 <= sink);
    P.sunk[i] = (stay_sunk || to_sink || !valid) ? 1 : 0;
    const bool bidding = open_t && !to_sink;
    P.open[i] = bidding ? 1 : 0;
    n_bid += bidding;
    const long long ac = P.acol0[i];
    if (ownok && !keep && ac >= 0 && ac < P.C) P.owner[ac] = -1;  // release
    if (bidding) {
      const int j1 = __ldcg(P.hj1 + i);
      const float delta =
          __fadd_rn(__fsub_rn(v1, fmaxf(__ldcg(P.hv2 + i), sink)), eps);
      const float bidv = __fadd_rn(delta, P.p0[j1]);
      unsigned long long key =
          ((unsigned long long)f2o(bidv) << 32) |
          (unsigned long long)(0xffffffffu - (unsigned int)i);
      atomicMax(P.bid + j1, key);
    }
  }
  n_bid = __reduce_add_sync(0xffffffffu, n_bid);
  if ((threadIdx.x & 31) == 0 && n_bid) atomicAdd(P.cnt, n_bid);
  grid.sync();
  // ---- Jacobi resolution of round 0 (per column) -----------------------
  for (int c = gtid; c < P.C; c += gthreads) {
    const unsigned long long key = __ldcg(P.bid + c);
    int victim = -1;
    if (key != 0ull) {
      const int w = (int)(0xffffffffu - (unsigned int)(key & 0xffffffffu));
      victim = __ldcg(P.owner + c);
      P.owner[c] = w;
      P.p[c] = o2f((unsigned int)(key >> 32));
      P.open[w] = 0;
      P.bid[c] = 0ull;
    }
    P.vic[c] = victim;
  }
  grid.sync();
  for (int c = gtid; c < P.C; c += gthreads) {
    const int v = P.vic[c];
    if (v >= 0) P.open[v] = 1;
  }
  grid.sync();
  // ---- Gauss-Seidel sweeps on the block's replica -----------------------
  // (form 0 in shared memory; 1: the owners in the block's global slice;
  // 2: the prices and open flags there too)
  const GsSmem L(P.S, P.C, P.ts, P.n_tiles, FORM);
  Replica R;
  R.p = FORM <= 1 ? reinterpret_cast<float*>(smem + L.p)
                  : P.rp + (size_t)blockIdx.x * P.C;
  R.own = FORM == 0 ? reinterpret_cast<int*>(smem + L.own)
                    : P.rown + (size_t)blockIdx.x * P.C;
  R.open = FORM <= 1 ? smem + L.open : P.ropen + (size_t)blockIdx.x * P.S;
  for (int c = threadIdx.x; c < P.C; c += WNT) {
    R.p[c] = __ldcg(P.p + c);
    R.own[c] = __ldcg(P.owner + c);
  }
  for (int i = threadIdx.x; i < P.S; i += WNT)
    R.open[i] = (unsigned char)__ldcg(P.open + i);
  __syncthreads();
  const GsArgs A = {P.S, P.C, P.ts, P.n_tiles, P.max_rounds,
                    P.sched, P.part, P.sunk, P.trace};
  const FdScan<T, MULT, LUT> scan = {P.C, P.wed, P.wfd, P.scale,
                                     static_cast<const T*>(P.fd), P.kps,
                                     P.kt, P.ms, lut};
  bool solo = false;   // K3 keeps every block to its end
  const int r = gs_sweeps(A, grid, smem + L.key, R, scan, eps, sink, 1,
                          false, false, solo);
  // ---- write-out and greedy completion from the parked hints -----------
  for (int c = gtid; c < P.C; c += gthreads) {
    P.p[c] = R.p[c];
    P.owner[c] = R.own[c];
  }
  for (int i = gtid; i < P.S; i += gthreads) {
    int g = -1;
    if (R.open[i]) {
      const int j1 = __ldcg(P.hj1 + i);
      const float v1n =
          __fadd_rn(__ldcg(P.hv1 + i), __fsub_rn(P.p0[j1], R.p[j1]));
      g = (v1n > sink) ? j1 : P.C;
    }
    P.gcol[i] = g;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *P.rounds = r;
    P.stats[0] = bmax;
    P.stats[1] = 0.0f;
    P.stats[2] = eps;
    P.stats[3] = eps_keep;
    P.trace[0] = __ldcg(P.cnt);
    P.trace[1] = r;
    *P.cnt = 0;
    *P.bmax = f2o(NEG_F);
  }
}

// Dynamic shared memory of one block in replica form ``form``: sweep 0's
// staging and the sweeps' part of GsSmem share it, the table (``lut``)
// comes on top.
static size_t warm_smem(int S, int C, int ts, bool lut, int form) {
  const size_t s0 = (size_t)2 * NARR * CHUNK * sizeof(float);
  const size_t gs = (size_t)GsSmem(S, C, ts, S / ts, form).total;
  return (s0 > gs ? s0 : gs) + (lut ? LUT_BYTES : 0);
}

extern "C" size_t warm_fused_smem(int S, int C, int ts, int lut, int form) {
  return warm_smem(S, C, ts, lut != 0, form);
}

// K3's replica form at this shape: the first of 0, 1, 2 whose shared
// memory, without the mult form's table, fits a block; -1 none (a tile of
// more than WNT rows, or a tile scratch past a block's shared memory).
// The bf16 mult form takes its table where it fits beside that form.
extern "C" int warm_fused_form(int S, int C, int ts) {
  if (ts > WNT) return -1;
  for (int form = 0; form <= 2; ++form)
    if (warm_smem(S, C, ts, false, form) <= SMEM_MAX) return form;
  return -1;
}

template <typename T, bool MULT, bool LUT, int FORM>
static int launch_warm(WarmParams* P, int nblk, void* stream) {
  static int sms = 0;
  const void* fn = (const void*)warm_fused_kernel<T, MULT, LUT, FORM>;
  const size_t smem = warm_smem(P->S, P->C, P->ts, LUT, FORM);
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)SMEM_MAX);
  }
  int occ = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, WNT, smem);
  if (occ < 1) return (int)cudaErrorLaunchOutOfResources;
  int blocks = min(sms, MAX_ITEMS);
  if (FORM > 0) blocks = min(blocks, nblk);   // the replica slices there are
  void* args[] = {P};
  cudaLaunchCooperativeKernel(fn, blocks, WNT, args, smem,
                              (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// One (T, MULT, LUT) form of K3 in replica form ``form``.
template <typename T, bool MULT, bool LUT>
static int launch_warm_form(WarmParams* P, int nblk, int form,
                            void* stream) {
  return form == 0   ? launch_warm<T, MULT, LUT, 0>(P, nblk, stream)
         : form == 1 ? launch_warm<T, MULT, LUT, 1>(P, nblk, stream)
                     : launch_warm<T, MULT, LUT, 2>(P, nblk, stream);
}

extern "C" int warm_fused(const void* fd, int f32, int mult, const float* kps,
                          const float* kt, const void* ms, const float* p0,
                          const void* owner0, const void* acol0,
                          const int* sunk0, const void* ownok,
                          const float* sched, const float* sinkp,
                          const float* dpenp, float wed, float wfd,
                          float scale, float eps_abs, float rel_eps,
                          int max_rounds, int S, int C, int ts, float* p,
                          int* owner, int* sunk, int* gcol, int* rounds,
                          float* stats, unsigned long long* bid, int* open,
                          int* vic, float* hv1, int* hj1, float* hv2,
                          float* hvsel, float* part, unsigned int* bmax,
                          int* cnt, int* trace, float* rp, int* rown,
                          unsigned char* ropen, int nblk, int form,
                          void* stream) {
  WarmParams P = {};
  P.S = S;
  P.C = C;
  P.ts = ts;
  P.n_tiles = S / ts;
  P.max_rounds = max_rounds;
  P.wed = wed;
  P.wfd = wfd;
  P.scale = scale;
  P.eps_abs = eps_abs;
  P.rel_eps = rel_eps;
  P.fd = fd;
  P.kps = kps;
  P.kt = kt;
  P.ms = (const unsigned char*)ms;
  P.p0 = p0;
  P.owner0 = (const long long*)owner0;
  P.acol0 = (const long long*)acol0;
  P.sunk0 = sunk0;
  P.ownok = (const unsigned char*)ownok;
  P.sched = sched;
  P.sinkp = sinkp;
  P.dpenp = dpenp;
  P.p = p;
  P.owner = owner;
  P.sunk = sunk;
  P.gcol = gcol;
  P.rounds = rounds;
  P.stats = stats;
  P.bid = bid;
  P.open = open;
  P.vic = vic;
  P.hv1 = hv1;
  P.hj1 = hj1;
  P.hv2 = hv2;
  P.hvsel = hvsel;
  P.part = part;
  P.bmax = bmax;
  P.cnt = cnt;
  P.trace = trace;
  P.rp = rp;
  P.rown = rown;
  P.ropen = ropen;
  // the form the wrapper's scratch was made for: at least the shape's
  // own (a larger one keeps more of the replica in global memory)
  const int fit = warm_fused_form(S, C, ts);
  if (fit < 0 || form < fit || form > 2) return (int)cudaErrorInvalidValue;
  if (form > 0 && (rown == nullptr || nblk < 1))
    return (int)cudaErrorInvalidValue;
  if (form > 1 && (rp == nullptr || ropen == nullptr))
    return (int)cudaErrorInvalidValue;
  if (f32)
    return mult ? launch_warm_form<float, true, false>(&P, nblk, form, stream)
                : launch_warm_form<float, false, false>(&P, nblk, form,
                                                        stream);
  if (!mult)
    return launch_warm_form<__nv_bfloat16, false, false>(&P, nblk, form,
                                                         stream);
  // the bf16 mult form takes its factor table where it fits beside the
  // replica's part in shared memory
  return warm_smem(S, C, ts, true, form) <= SMEM_MAX
             ? launch_warm_form<__nv_bfloat16, true, true>(&P, nblk, form,
                                                           stream)
             : launch_warm_form<__nv_bfloat16, true, false>(&P, nblk, form,
                                                            stream);
}
