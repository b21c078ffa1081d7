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
// Bound on this card: memory for K2 (a sweep reads its active row tiles of
// the stored benefits); for K3 the float work of rebuilding every benefit
// (sqrt, and expf / logf with ``mult``) against one read of the FD (bf16:
// 134 MB at 8192^2, 40 us at 3.35 TB/s).
//
// K2 design.  One persistent cooperative launch (grid = co-resident blocks,
// cg::grid_group::sync between stages) keeps the whole phase on the card:
// prices, owners, open/sunk flags and the per-column bid slots stay in
// global memory (all of it fits in L2).  The sequential Gauss-Seidel tile
// order of the TPU kernel is kept exactly: the active-tile list is rebuilt
// at each sweep start (every block computes it from the open flags), and
// for each listed tile
//   phase A: one block per open row computes the row's top-2 of (b - p)
//            (lowest column on argmax ties, as jnp.argmax) and posts its
//            bid to column j1 with a 64-bit atomicMax of
//            (orderable(delta) << 32 | (0xFFFFFFFF - row)): the highest
//            delta wins, ties go to the lowest row id (the TPU kernel's
//            first-max-lane rule) — no 14-bit row packing, so S is not
//            capped at 16384;
//   phase B: after a grid sync, each bidder reads its column's slot; the
//            winner takes the column at p + delta, reopens the evicted
//            owner and clears the slot.  Sink decisions made in phase A are
//            applied here too, so no open flag changes while another block
//            may still be building the active list.
// K2 and K3 share only top2.cuh.
//
// K3 design (one cooperative launch, one 512-thread block an SM):
//   sweep 0  each block owns bands of 64 rows, a warp 4 of them.  Chunks of
//            1024 columns of the column factors (x, y, z, |t|^2, mask) and
//            the bidding-start prices are staged in shared memory with
//            cp.async, double-buffered, and reused by every row of the band;
//            FD rows are read as 16-byte vectors (8 bf16 entries a lane).
//            Each lane keeps its rows' top-2, vsel and the benefit max in
//            registers and a warp merges them by shuffles: no block barrier
//            a row.  The top-2 merge (t2_merge) is lexicographic (highest
//            value, then lowest column) and vsel / bmax are maxima, so any
//            split gives the same bits as the plain version.
//   round 0  the keep test, the column release and the round-0 Jacobi bids
//            (64-bit atomicMax slots) between grid syncs, as the TPU kernel.
//   sweeps   every block keeps a replica of the prices, the owners and the
//            open flags in shared memory.  For each active tile (the tiles
//            with open rows at the sweep start, in order) the open rows are
//            split over the blocks in column parts (up to 16 parts a row
//            when the tile has few open rows); each part's top-2 of (b - p)
//            goes to a global slot; after ONE grid sync every block merges
//            the parts, applies the tile's bid rule (the highest delta wins
//            a column, ties to the lowest row) and updates its own replica
//            identically.  No atomics, no bid-slot clearing and no second
//            barrier a tile; the active list is counted from the replica.
//            (The part slots alternate between two buffers: a block may
//            scan tile k + 1 while another still reads tile k's parts.)
//   end      greedy completion of the rows left open from the parked hints,
//            then the replica is written out.
// The scratch (bid slots, hints, part slots, the benefit-max key, a counter)
// comes from the wrapper, made once an engine run; the kernel leaves the bid
// slots and the counter at zero and the max key at orderable(-3e38), as it
// found them.  sink and the penalty step reach it as device scalars.
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

#include "top2.cuh"

namespace cg = cooperative_groups;

#define MAX_TILES 1024

constexpr int NT = 256;           // K2: threads per block
constexpr int NWARP = NT / 32;

struct Params {
  int S, C, ts, n_tiles, max_rounds, complete;
  float sink, eps;                // eps: the phase epsilon
  const float* sched;             // [max_rounds] escalation boost per sweep
  const void* mat;                // benefits b [S, C] (bf16 or float32: T)
  // state, updated in place
  float* p;
  int* owner;
  int* sunk;
  int* open;
  int* gcol;
  int* rounds;
  // scratch
  unsigned long long* bid;        // [C], zero on entry, zero on exit
  int* rowdec;                    // [ts]: -2 none, -1 sink, else bid column
};

// Block-wide scan of one row: top-2 of (b - p).  All threads return it.
template <typename T>
__device__ Top2 row_scan(const Params& P, int row, const float* pr) {
  __shared__ Top2 s_t[NWARP];
  const int C = P.C;
  Top2 t = t2_empty();
  const T* rp = static_cast<const T*>(P.mat) + (size_t)row * C;
  for (int c0 = threadIdx.x * 8; c0 < C; c0 += NT * 8) {
    float xv[8];
    load8(rp + c0, xv);
    float4 pa = __ldcg(reinterpret_cast<const float4*>(pr + c0));
    float4 pb = __ldcg(reinterpret_cast<const float4*>(pr + c0 + 4));
    float pv[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
#pragma unroll
    for (int q = 0; q < 8; ++q) t2_push(t, __fsub_rn(xv[q], pv[q]), c0 + q);
  }
  t = t2_warp_merge(t);
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  if (l == 0) s_t[w] = t;
  __syncthreads();
  Top2 r = s_t[0];
  for (int k = 1; k < NWARP; ++k) r = t2_merge(r, s_t[k]);
  __syncthreads();   // s_t is reused by the next row
  return r;
}

// Block-redundant: count open rows and list the tiles that have any.
__device__ void build_active(const Params& P, int* s_list, int* s_n,
                             int* s_open) {
  __shared__ int s_cnt[MAX_TILES];
  for (int t = threadIdx.x; t < P.n_tiles; t += NT) s_cnt[t] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < P.S; i += NT) {
    if (__ldcg(P.open + i)) atomicAdd(&s_cnt[i / P.ts], 1);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int n = 0, tot = 0;
    for (int t = 0; t < P.n_tiles; ++t) {
      tot += s_cnt[t];
      if (s_cnt[t] > 0) s_list[n++] = t;
    }
    *s_n = n;
    *s_open = tot;
  }
  __syncthreads();
}

// Gauss-Seidel sweeps over the active tiles, from sweep r0 on.
template <typename T>
__device__ int gs_sweeps(const Params& P, cg::grid_group& grid, int r0,
                         float eps) {
  __shared__ int s_list[MAX_TILES];
  __shared__ int s_n, s_open;
  const int gtid = blockIdx.x * NT + threadIdx.x;
  const int gthreads = gridDim.x * NT;
  int r = r0;
  while (true) {
    build_active(P, s_list, &s_n, &s_open);
    if (s_open == 0 || r >= P.max_rounds) break;
    const float eps_r = __fmul_rn(eps, P.sched[r]);
    const int n_active = s_n;
    for (int j = 0; j < n_active; ++j) {
      const int t = s_list[j];
      // phase A: bids of the tile's open rows at the current prices
      for (int lr = blockIdx.x; lr < P.ts; lr += gridDim.x) {
        const int row = t * P.ts + lr;
        if (!__ldcg(P.open + row)) {
          if (threadIdx.x == 0) P.rowdec[lr] = -2;
          continue;
        }
        const Top2 o = row_scan<T>(P, row, P.p);
        if (threadIdx.x == 0) {
          if (o.v1 <= P.sink) {
            P.rowdec[lr] = -1;
          } else {
            float delta = __fadd_rn(__fsub_rn(o.v1, fmaxf(o.v2, P.sink)),
                                    eps_r);
            unsigned long long key =
                ((unsigned long long)f2o(delta) << 32) |
                (unsigned long long)(0xffffffffu - (unsigned int)row);
            atomicMax(P.bid + o.j1, key);
            P.rowdec[lr] = o.j1;
          }
        }
      }
      grid.sync();
      // phase B: resolve — winners take their columns, victims reopen
      for (int lr = gtid; lr < P.ts; lr += gthreads) {
        const int row = t * P.ts + lr;
        const int dec = __ldcg(P.rowdec + lr);
        if (dec == -1) {
          P.sunk[row] = 1;
          P.open[row] = 0;
        } else if (dec >= 0) {
          unsigned long long key = __ldcg(P.bid + dec);
          if ((unsigned int)(key & 0xffffffffu) ==
              0xffffffffu - (unsigned int)row) {
            const float dmax = o2f((unsigned int)(key >> 32));
            const int victim = __ldcg(P.owner + dec);
            P.owner[dec] = row;
            P.p[dec] = __fadd_rn(__ldcg(P.p + dec), dmax);
            P.bid[dec] = 0ull;
            P.open[row] = 0;
            if (victim >= 0) P.open[victim] = 1;
          }
        }
      }
      grid.sync();
    }
    ++r;
  }
  return r;
}

template <typename T>
__global__ void __launch_bounds__(NT) gs_phase_kernel(Params P) {
  cg::grid_group grid = cg::this_grid();
  const int r = gs_sweeps<T>(P, grid, 0, P.eps);
  // greedy completion of rows still open: best column at the final prices
  // or the sink (-1 = row was not open, C = sink)
  if (P.complete) {
    for (int row = blockIdx.x; row < P.S; row += gridDim.x) {
      if (!__ldcg(P.open + row)) continue;
      const Top2 o = row_scan<T>(P, row, P.p);
      if (threadIdx.x == 0) P.gcol[row] = (o.v1 > P.sink) ? o.j1 : P.C;
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *P.rounds = r;
}

static int launch(const void* fn, Params* P, void* stream) {
  int dev = 0, sms = 0, occ = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, NT, 0);
  if (occ < 1) return (int)cudaErrorLaunchOutOfResources;
  int per_sm = occ < 2 ? occ : 2;
  int blocks = sms * per_sm;
  void* args[] = {P};
  cudaLaunchCooperativeKernel(fn, blocks, NT, args, 0, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

extern "C" int gs_phase(const void* b, int f32, float* p, int* owner, int* sunk,
                        int* open, int* gcol, int* rounds, const float* sched,
                        float eps, float sink, int max_rounds, int complete,
                        int S, int C, int ts,
                        unsigned long long* bid, int* rowdec, void* stream) {
  Params P = {};
  P.S = S;
  P.C = C;
  P.ts = ts;
  P.n_tiles = S / ts;
  P.max_rounds = max_rounds;
  P.complete = complete;
  P.sink = sink;
  P.eps = eps;
  P.sched = sched;
  P.mat = b;
  P.p = p;
  P.owner = owner;
  P.sunk = sunk;
  P.open = open;
  P.gcol = gcol;
  P.rounds = rounds;
  P.bid = bid;
  P.rowdec = rowdec;
  return launch(f32 ? (const void*)gs_phase_kernel<float>
                     : (const void*)gs_phase_kernel<__nv_bfloat16>,
                &P, stream);
}

// ===========================================================================
// K3: the warm fused iteration
// ===========================================================================

constexpr int WNT = 512;             // threads per block (one block an SM)
constexpr int WNWARP = WNT / 32;
constexpr int RPW = 4;               // sweep 0: rows a warp
constexpr int BAND = WNWARP * RPW;   // sweep 0: rows a band
constexpr int CHUNK = 1024;          // sweep 0: columns staged at once
constexpr int NARR = 6;              // staged arrays: x, y, z, |t|^2, mask, p0
constexpr int GMAX = 16;             // most column parts of one GS row
constexpr int TRACE_SWEEPS = 30;     // trace slots for active tiles a sweep

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
};

// Eight FD entries kept as loaded (16 or 32 bytes) and converted on use.
template <typename T>
struct Raw8;

template <>
struct Raw8<__nv_bfloat16> {
  uint4 u;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    u = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ unsigned int bits(int q) const {
    const unsigned int w = q < 2 ? u.x : q < 4 ? u.y : q < 6 ? u.z : u.w;
    return (q & 1) ? (w >> 16) : (w & 0xffffu);
  }
  __device__ __forceinline__ float get(int q) const {
    return __uint_as_float(bits(q) << 16);
  }
};

template <>
struct Raw8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p + 4));
  }
  __device__ __forceinline__ float get(int q) const {
    const float4& h = q < 4 ? a : b;
    const int k = q & 3;
    return k == 0 ? h.x : k == 1 ? h.y : k == 2 ? h.z : h.w;
  }
};

// The mult form's FD factor expf(-k * logf(max(FD, 1e-6))).
__device__ __forceinline__ float mult_weight(const WarmParams& P, float x) {
  return expf(__fmul_rn(-P.wfd, logf(fmaxf(x, 1e-6f))));
}

// With LUT, the mult factor of a bf16 FD in [0, 1] (every bf16 pattern up
// to 1.0: LUT_N floats) comes from a table the block fills with
// mult_weight itself, so the bits are the same; a negative FD (its floor
// is 1e-6, as +0's) reads entry 0 and a larger one is computed.
constexpr unsigned int LUT_N = 0x3F81;   // bf16 bits of 1.0, plus one
constexpr int LUT_BYTES = (LUT_N * 4 + 15) & ~15;

template <typename T, bool LUT>
__device__ __forceinline__ float fd_weight(const WarmParams& P,
                                           const float* lut,
                                           const Raw8<T>& x, int q) {
  if constexpr (LUT) {
    unsigned int u = x.bits(q);
    if (u & 0x8000u) u = 0;
    if (u < LUT_N) return lut[u];
  }
  return mult_weight(P, x.get(q));
}

// Benefit of one valid (row, column) entry, in the order of the plain
// version (ops/auction_rounds.py::factor_benefits); ``w`` is the mult
// form's FD factor (unused by the BSC blend).
template <bool MULT>
__device__ __forceinline__ float entry_benefit(const WarmParams& P, float sx,
                                               float sy, float sz, float sw,
                                               float tx, float ty, float tz,
                                               float tw, float fdv, float w) {
  const float d = __fadd_rn(__fadd_rn(__fmul_rn(sx, tx), __fmul_rn(sy, ty)),
                            __fmul_rn(sz, tz));
  const float d2 =
      fmaxf(__fsub_rn(__fadd_rn(sw, tw), __fmul_rn(2.0f, d)), 0.0f);
  const float ed = __fmul_rn(P.scale, __fsqrt_rn(d2));
  const float cd =
      MULT ? __fmul_rn(ed, w)
           : __fadd_rn(__fmul_rn(P.wed, ed), __fmul_rn(P.wfd, fdv));
  return -cd;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned int d = (unsigned int)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Stage columns [cb, cb + width) of the six column arrays into ``buf``.
// Within each 256-column pass a lane's eight columns sit as two float4
// halves 128 floats apart, so the warp's reads are conflict-free.
__device__ __forceinline__ void stage_chunk(const WarmParams& P, float* buf,
                                            int cb, int width) {
  const int pieces = width >> 2;   // float4 pieces per array
  for (int k = threadIdx.x; k < NARR * pieces; k += WNT) {
    const int a = k / pieces;
    const int o = (k - a * pieces) << 2;
    const float* src = (a < 5 ? P.kt + (size_t)a * P.C : P.p0) + cb + o;
    const int within = o & 255;
    cp_async16(buf + a * CHUNK + (o & ~255) + ((within >> 2) & 1) * 128 +
                   (within >> 3) * 4,
               src);
  }
}

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
        sw[r] = __fadd_rn(__fadd_rn(__fmul_rn(sx[r], sx[r]),
                                    __fmul_rn(sy[r], sy[r])),
                          __fmul_rn(sz[r], sz[r]));
        const long long a = P.acol0[row];
        ac[r] = (a >= 0 && a < C) ? (int)a : -1;
        mode[r] = P.ms[row] ? 2 : 1;
      }
    }
    const T* fdb =
        static_cast<const T*>(P.fd) + (size_t)(band * BAND + warp * RPW) * C;
    stage_chunk(P, sm, 0, min(CHUNK, C));
    cp_commit();
    for (int ch = 0; ch < nch; ++ch) {
      const int cb = ch * CHUNK;
      if (ch + 1 < nch)
        stage_chunk(P, sm + ((ch + 1) & 1) * NARR * CHUNK, cb + CHUNK,
                    min(CHUNK, C - cb - CHUNK));
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
          const int o = ps * 256 + h * 128 + lane * 4;
          const float4 X = *reinterpret_cast<const float4*>(b + o);
          const float4 Y = *reinterpret_cast<const float4*>(b + CHUNK + o);
          const float4 Z = *reinterpret_cast<const float4*>(b + 2 * CHUNK + o);
          const float4 W = *reinterpret_cast<const float4*>(b + 3 * CHUNK + o);
          const float4 M = *reinterpret_cast<const float4*>(b + 4 * CHUNK + o);
          const float4 Q = *reinterpret_cast<const float4*>(b + 5 * CHUNK + o);
          const float tx[4] = {X.x, X.y, X.z, X.w};
          const float ty[4] = {Y.x, Y.y, Y.z, Y.w};
          const float tz[4] = {Z.x, Z.y, Z.z, Z.w};
          const float tw[4] = {W.x, W.y, W.z, W.w};
          const float tm[4] = {M.x, M.y, M.z, M.w};
          const float tp[4] = {Q.x, Q.y, Q.z, Q.w};
#pragma unroll
          for (int r = 0; r < RPW; ++r) {
            if (mode[r] == 0) continue;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int c = c0 + h * 4 + q;
              float bt = NEG_F;
              if (mode[r] == 2 && tm[q] != 0.0f)
                bt = entry_benefit<MULT>(
                    P, sx[r], sy[r], sz[r], sw[r], tx[q], ty[q], tz[q], tw[q],
                    MULT ? 0.0f : x[r].get(h * 4 + q),
                    MULT ? fd_weight<T, LUT>(P, lut, x[r], h * 4 + q) : 0.0f);
              const float v = __fsub_rn(bt, tp[q]);
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

// Shared memory of the Gauss-Seidel sweeps (byte offsets).  A tile's
// (row, part) slots number at most max(ts, blocks) <= MAX_ITEMS.
constexpr int MAX_ITEMS = 1024;
struct GsSmem {
  int p, own, key, rows, col, cnt, list, t, part, misc, open, total;
  __host__ __device__ GsSmem(int S, int C, int ts, int n_tiles) {
    p = 0;
    own = p + 4 * C;
    key = own + 4 * C;
    rows = key + 8 * ts;
    col = rows + 4 * ts;
    cnt = col + 4 * ts;
    list = cnt + 4 * n_tiles;
    t = list + 4 * n_tiles;
    part = t + 16 * WNWARP;
    misc = part + 12 * MAX_ITEMS;
    open = misc + 16;
    total = open + ((S + 15) & ~15);
  }
};

// Top-2 of (b - p) of ``row`` over the 8-column units [u0, u1), at the
// block's replica prices; all threads return the block's merge.
template <typename T, bool MULT, bool LUT>
__device__ Top2 part_scan(const WarmParams& P, const float* s_p, Top2* s_t,
                          const float* lut, int row, int u0, int u1) {
  const int C = P.C;
  const float* k = P.kps + 3 * (size_t)row;
  const float sx = k[0], sy = k[1], sz = k[2];
  const float sw = __fadd_rn(__fadd_rn(__fmul_rn(sx, sx), __fmul_rn(sy, sy)),
                             __fmul_rn(sz, sz));
  const bool valid = P.ms[row] != 0;
  const T* rp = static_cast<const T*>(P.fd) + (size_t)row * C;
  Top2 t = t2_empty();
  for (int u = u0 + threadIdx.x; u < u1; u += WNT) {
    const int c0 = u * 8;
    Raw8<T> x;
    if (valid) x.load(rp + c0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + 4 * h;
      const float4 X = __ldg(reinterpret_cast<const float4*>(P.kt + c));
      const float4 Y = __ldg(reinterpret_cast<const float4*>(P.kt + C + c));
      const float4 Z =
          __ldg(reinterpret_cast<const float4*>(P.kt + 2 * C + c));
      const float4 W =
          __ldg(reinterpret_cast<const float4*>(P.kt + 3 * C + c));
      const float4 M =
          __ldg(reinterpret_cast<const float4*>(P.kt + 4 * C + c));
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
              P, sx, sy, sz, sw, tx[q], ty[q], tz[q], tw[q],
              MULT ? 0.0f : x.get(4 * h + q),
              MULT ? fd_weight<T, LUT>(P, lut, x, 4 * h + q) : 0.0f);
        t2_push(t, __fsub_rn(bt, tp[q]), c + q);
      }
    }
  }
  t = t2_warp_merge(t);
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  if (l == 0) s_t[w] = t;
  __syncthreads();
  Top2 r = s_t[0];
  for (int j = 1; j < WNWARP; ++j) r = t2_merge(r, s_t[j]);
  __syncthreads();   // s_t is reused by the next part
  return r;
}

// Gauss-Seidel sweeps from sweep 1 on, over the block's replica; returns
// the sweep count.
template <typename T, bool MULT, bool LUT>
__device__ int warm_sweeps(const WarmParams& P, cg::grid_group& grid,
                           unsigned char* sm, const float* lut, float eps,
                           float sink) {
  const GsSmem L(P.S, P.C, P.ts, P.n_tiles);
  float* s_p = reinterpret_cast<float*>(sm + L.p);
  int* s_own = reinterpret_cast<int*>(sm + L.own);
  unsigned long long* s_key = reinterpret_cast<unsigned long long*>(sm + L.key);
  int* s_rows = reinterpret_cast<int*>(sm + L.rows);
  int* s_col = reinterpret_cast<int*>(sm + L.col);
  int* s_cnt = reinterpret_cast<int*>(sm + L.cnt);
  int* s_list = reinterpret_cast<int*>(sm + L.list);
  Top2* s_t = reinterpret_cast<Top2*>(sm + L.t);
  Top2* s_part = reinterpret_cast<Top2*>(sm + L.part);
  int* s_misc = reinterpret_cast<int*>(sm + L.misc);
  unsigned char* s_open = sm + L.open;
  const int tid = threadIdx.x, lane = tid & 31;
  const int ts = P.ts, U = P.C / 8;
  const int gcap = min(GMAX, max(1, U / 64));   // parts of >= 512 columns
  int r = 1, k = 0, scans = 0;
  while (true) {
    for (int i = tid; i < P.n_tiles; i += WNT) s_cnt[i] = 0;
    __syncthreads();
    for (int i = tid; i < P.S; i += WNT)
      if (s_open[i]) atomicAdd(&s_cnt[i / ts], 1);
    __syncthreads();
    if (tid == 0) {
      int n = 0, tot = 0;
      for (int i = 0; i < P.n_tiles; ++i) {
        tot += s_cnt[i];
        if (s_cnt[i] > 0) s_list[n++] = i;
      }
      s_misc[0] = n;
      s_misc[1] = tot;
    }
    __syncthreads();
    const int n_active = s_misc[0];
    if (s_misc[1] == 0 || r >= P.max_rounds) break;
    if (blockIdx.x == 0 && tid == 0 && r - 1 < TRACE_SWEEPS)
      P.trace[2 + r] = n_active;
    const float eps_r = __fmul_rn(eps, P.sched[r]);
    for (int j = 0; j < n_active; ++j, ++k) {
      const int tile = s_list[j];
      // the tile's open rows, in order
      if (tid < 32) {
        int n = 0;
        for (int base = 0; base < ts; base += 32) {
          const bool o = base + lane < ts && s_open[tile * ts + base + lane];
          const unsigned int bal = __ballot_sync(0xffffffffu, o);
          if (o) s_rows[n + __popc(bal & ((1u << lane) - 1u))] = base + lane;
          n += __popc(bal);
        }
        if (lane == 0) s_misc[2] = n;
      }
      __syncthreads();
      const int n = s_misc[2];
      scans += n;
      const int g = min(gcap, max(1, (int)gridDim.x / n));
      float* part = P.part + (size_t)(k & 1) * ts * GMAX * 3;
      // scan: item = (open row i, column part q)
      for (int it = blockIdx.x; it < n * g; it += gridDim.x) {
        const int i = it / g, q = it - i * g;
        const Top2 o = part_scan<T, MULT, LUT>(
            P, s_p, s_t, lut, tile * ts + s_rows[i], q * U / g,
            (q + 1) * U / g);
        if (tid == 0) {
          float* d = part + ((size_t)i * GMAX + q) * 3;
          __stcg(d, o.v1);
          __stcg(d + 1, __int_as_float(o.j1));
          __stcg(d + 2, o.v2);
        }
      }
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
      __syncthreads();
      if (tid < n) {
        Top2 o = s_part[tid * g];
        for (int q = 1; q < g; ++q) o = t2_merge(o, s_part[tid * g + q]);
        const int row = tile * ts + s_rows[tid];
        if (o.v1 <= sink) {
          s_col[tid] = -1;
        } else {
          const float delta =
              __fadd_rn(__fsub_rn(o.v1, fmaxf(o.v2, sink)), eps_r);
          s_col[tid] = o.j1;
          s_key[tid] = ((unsigned long long)f2o(delta) << 32) |
                       (unsigned long long)(0xffffffffu - (unsigned int)row);
        }
      }
      __syncthreads();
      if (tid < n) {
        const int row = tile * ts + s_rows[tid];
        const int col = s_col[tid];
        if (col < 0) {
          s_open[row] = 0;
          if (tid % gridDim.x == blockIdx.x) P.sunk[row] = 1;
        } else {
          const unsigned long long key = s_key[tid];
          bool win = true;
          for (int m = 0; m < n; ++m)
            if (s_col[m] == col && s_key[m] > key) win = false;
          if (win) {
            const int victim = s_own[col];
            s_own[col] = row;
            s_p[col] = __fadd_rn(s_p[col], o2f((unsigned int)(key >> 32)));
            s_open[row] = 0;
            if (victim >= 0) s_open[victim] = 1;
          }
        }
      }
      __syncthreads();
    }
    ++r;
  }
  if (blockIdx.x == 0 && tid == 0) P.trace[2] = scans;
  return r;
}

template <typename T, bool MULT, bool LUT>
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
    for (int u = threadIdx.x; u < (int)LUT_N; u += WNT)
      lut[u] = mult_weight(P, __uint_as_float((unsigned int)u << 16));
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
  const GsSmem L(P.S, P.C, P.ts, P.n_tiles);
  float* s_p = reinterpret_cast<float*>(smem + L.p);
  int* s_own = reinterpret_cast<int*>(smem + L.own);
  unsigned char* s_open = smem + L.open;
  for (int c = threadIdx.x; c < P.C; c += WNT) {
    s_p[c] = __ldcg(P.p + c);
    s_own[c] = __ldcg(P.owner + c);
  }
  for (int i = threadIdx.x; i < P.S; i += WNT)
    s_open[i] = (unsigned char)__ldcg(P.open + i);
  __syncthreads();
  const int r = warm_sweeps<T, MULT, LUT>(P, grid, smem, lut, eps, sink);
  // ---- write-out and greedy completion from the parked hints -----------
  for (int c = gtid; c < P.C; c += gthreads) {
    P.p[c] = s_p[c];
    P.owner[c] = s_own[c];
  }
  for (int i = gtid; i < P.S; i += gthreads) {
    int g = -1;
    if (s_open[i]) {
      const int j1 = __ldcg(P.hj1 + i);
      const float v1n =
          __fadd_rn(__ldcg(P.hv1 + i), __fsub_rn(P.p0[j1], s_p[j1]));
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

// Dynamic shared memory of one block: sweep 0's staging and the sweeps'
// replica share it, the table (``lut``) comes on top.
static size_t warm_smem(int S, int C, int ts, bool lut) {
  const size_t s0 = (size_t)2 * NARR * CHUNK * sizeof(float);
  const size_t gs = (size_t)GsSmem(S, C, ts, S / ts).total;
  return (s0 > gs ? s0 : gs) + (lut ? LUT_BYTES : 0);
}

constexpr size_t SMEM_MAX = 232448;   // a block's most on this card

extern "C" size_t warm_fused_smem(int S, int C, int ts, int lut) {
  return warm_smem(S, C, ts, lut != 0);
}

template <typename T, bool MULT, bool LUT>
static int launch_warm(WarmParams* P, void* stream) {
  static int sms = 0;
  const void* fn = (const void*)warm_fused_kernel<T, MULT, LUT>;
  const size_t smem = warm_smem(P->S, P->C, P->ts, LUT);
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
  void* args[] = {P};
  cudaLaunchCooperativeKernel(fn, min(sms, MAX_ITEMS), WNT, args, smem,
                              (cudaStream_t)stream);
  return (int)cudaGetLastError();
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
                          int* cnt, int* trace, void* stream) {
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
  if (f32)
    return mult ? launch_warm<float, true, false>(&P, stream)
                : launch_warm<float, false, false>(&P, stream);
  if (!mult) return launch_warm<__nv_bfloat16, false, false>(&P, stream);
  // the bf16 mult form takes its factor table where it fits
  return warm_smem(S, C, ts, true) <= SMEM_MAX
             ? launch_warm<__nv_bfloat16, true, true>(&P, stream)
             : launch_warm<__nv_bfloat16, true, false>(&P, stream);
}
