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
// lane, float32: each kernel is a template on its element type T, and the
// entries take a flag; either way the arithmetic is float32.
//
// Bound on this card: memory.  A full sweep reads the [S, C] matrix once
// (bf16: 134 MB at 8192^2, 40 us at 3.35 TB/s; float32 twice that); later
// sweeps read only the row tiles that still have open rows, so a sweep's
// floor is its active tiles' bytes.  The arithmetic is a handful of float ops per entry.
//
// Design.  One persistent cooperative launch (grid = co-resident blocks,
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

constexpr int NT = 256;           // threads per block
constexpr int NWARP = NT / 32;

struct Params {
  int S, C, ts, n_tiles, max_rounds, complete;
  float sink, eps;                // eps: K2's phase epsilon (K3 derives its own)
  const float* sched;             // [max_rounds] escalation boost per sweep
  const void* mat;                // K2: benefits b [S, C]; K3: FD [S, C]
                                  // (bf16 or float32: the kernels' T)
  // K3 only
  const float4* kps;              // [S] (x, y, z, |s|^2)
  const float4* kpt;              // [C] (x, y, z, |t|^2)
  const int* ms;
  const int* mt;
  float wed, wfd, scale;
  int mult;                       // FPFH/RoPS blend (wed unused)
  float eps_abs, rel_eps, dpen;
  const float* p0;
  const int* acol0;
  const int* sunk0;
  const int* ownok;
  // state, updated in place
  float* p;
  int* owner;
  int* sunk;
  int* open;
  int* gcol;
  int* rounds;
  float* stats;                   // K3: [b_max, 0, eps, eps_keep]
  // scratch
  unsigned long long* bid;        // [C], zero on entry, zero on exit
  int* rowdec;                    // [ts]: -2 none, -1 sink, else bid column
  int* vic;                       // [C]
  float* hv1;                     // K3 parked hints [S]
  int* hj1;
  float* hv2;
  float* hvsel;
  unsigned int* bmax;             // K3: orderable max of the benefits
};

struct RowOut {
  Top2 t;
  float vsel;
  float bmax;
};

// Benefit of one (row, column) entry rebuilt from factors, in the order of
// the plain version (ops/auction_rounds.py::_factor_benefits).
__device__ __forceinline__ float factor_benefit(const Params& P, float4 s,
                                                int msr, int c, float fdv) {
  float4 t = __ldg(P.kpt + c);
  float d = __fadd_rn(__fadd_rn(__fmul_rn(s.x, t.x), __fmul_rn(s.y, t.y)),
                      __fmul_rn(s.z, t.z));
  float d2 = fmaxf(__fsub_rn(__fadd_rn(s.w, t.w), __fmul_rn(2.0f, d)), 0.0f);
  float ed = __fmul_rn(P.scale, __fsqrt_rn(d2));
  float cd = P.mult
      ? __fmul_rn(ed, expf(__fmul_rn(-P.wfd, logf(fmaxf(fdv, 1e-6f)))))
      : __fadd_rn(__fmul_rn(P.wed, ed), __fmul_rn(P.wfd, fdv));
  return (msr != 0 && __ldg(P.mt + c) != 0) ? -cd : NEG_F;
}

// Block-wide scan of one row: top-2 of (b - p) and, for sweep 0, the value
// at the kept column and the benefit max.  All threads return the result.
template <typename T, bool FACTOR, bool SWEEP0>
__device__ RowOut row_scan(const Params& P, int row, const float* pr,
                           int acol) {
  __shared__ Top2 s_t[NWARP];
  __shared__ float s_a[NWARP], s_b[NWARP];
  const int C = P.C;
  Top2 t = t2_empty();
  float vsel = NEG_F, bmx = NEG_F;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  int msr = 0;
  if (FACTOR) {
    s = P.kps[row];
    msr = P.ms[row];
  }
  const T* rp = static_cast<const T*>(P.mat) + (size_t)row * C;
  for (int c0 = threadIdx.x * 8; c0 < C; c0 += NT * 8) {
    float xv[8];
    load8(rp + c0, xv);
    float4 pa = __ldcg(reinterpret_cast<const float4*>(pr + c0));
    float4 pb = __ldcg(reinterpret_cast<const float4*>(pr + c0 + 4));
    float pv[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      int c = c0 + q;
      float x = xv[q];
      float bt = FACTOR ? factor_benefit(P, s, msr, c, x) : x;
      float v = __fsub_rn(bt, pv[q]);
      t2_push(t, v, c);
      if (SWEEP0) {
        if (c == acol) vsel = fmaxf(vsel, v);
        bmx = fmaxf(bmx, bt);
      }
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    Top2 u;
    u.v1 = __shfl_xor_sync(0xffffffffu, t.v1, o);
    u.j1 = __shfl_xor_sync(0xffffffffu, t.j1, o);
    u.v2 = __shfl_xor_sync(0xffffffffu, t.v2, o);
    t = t2_merge(t, u);
    if (SWEEP0) {
      vsel = fmaxf(vsel, __shfl_xor_sync(0xffffffffu, vsel, o));
      bmx = fmaxf(bmx, __shfl_xor_sync(0xffffffffu, bmx, o));
    }
  }
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  if (l == 0) {
    s_t[w] = t;
    s_a[w] = vsel;
    s_b[w] = bmx;
  }
  __syncthreads();
  RowOut r;
  r.t = s_t[0];
  r.vsel = s_a[0];
  r.bmax = s_b[0];
  for (int k = 1; k < NWARP; ++k) {
    r.t = t2_merge(r.t, s_t[k]);
    r.vsel = fmaxf(r.vsel, s_a[k]);
    r.bmax = fmaxf(r.bmax, s_b[k]);
  }
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
template <typename T, bool FACTOR>
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
        RowOut o = row_scan<T, FACTOR, false>(P, row, P.p, -1);
        if (threadIdx.x == 0) {
          if (o.t.v1 <= P.sink) {
            P.rowdec[lr] = -1;
          } else {
            float delta = __fadd_rn(__fsub_rn(o.t.v1, fmaxf(o.t.v2, P.sink)),
                                    eps_r);
            unsigned long long key =
                ((unsigned long long)f2o(delta) << 32) |
                (unsigned long long)(0xffffffffu - (unsigned int)row);
            atomicMax(P.bid + o.t.j1, key);
            P.rowdec[lr] = o.t.j1;
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
  const int r = gs_sweeps<T, false>(P, grid, 0, P.eps);
  // greedy completion of rows still open: best column at the final prices
  // or the sink (-1 = row was not open, C = sink)
  if (P.complete) {
    for (int row = blockIdx.x; row < P.S; row += gridDim.x) {
      if (!__ldcg(P.open + row)) continue;
      RowOut o = row_scan<T, false, false>(P, row, P.p, -1);
      if (threadIdx.x == 0) P.gcol[row] = (o.t.v1 > P.sink) ? o.t.j1 : P.C;
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *P.rounds = r;
}

template <typename T>
__global__ void __launch_bounds__(NT) warm_fused_kernel(Params P) {
  cg::grid_group grid = cg::this_grid();
  const int gtid = blockIdx.x * NT + threadIdx.x;
  const int gthreads = gridDim.x * NT;
  // ---- sweep 0: exact hints at the bidding-start prices ----------------
  for (int row = blockIdx.x; row < P.S; row += gridDim.x) {
    const int ac = P.acol0[row];
    RowOut o = row_scan<T, true, true>(P, row, P.p0, ac);
    if (threadIdx.x == 0) {
      P.hv1[row] = o.t.v1;
      P.hj1[row] = o.t.j1;
      P.hv2[row] = o.t.v2;
      P.hvsel[row] = o.vsel;
      atomicMax(P.bmax, f2o(o.bmax));
    }
  }
  grid.sync();
  // ---- keep test, column release and round-0 bids ----------------------
  const float bmax = o2f(__ldcg(P.bmax));
  const float spread = fmaxf(__fsub_rn(bmax, P.sink), 0.0f);
  const float eps = fmaxf(P.eps_abs, __fmul_rn(P.rel_eps, spread));
  const float hi = fmaxf(__fdiv_rn(spread, 8.0f), eps);
  const float eps_keep =
      fminf(fmaxf(__fadd_rn(P.dpen, __fmul_rn(2.0f, eps)), eps), hi);
  for (int i = gtid; i < P.S; i += gthreads) {
    const float v1 = __ldcg(P.hv1 + i);
    const bool valid = P.ms[i] != 0;
    const bool ownok = P.ownok[i] != 0;
    const float thr = __fsub_rn(v1, eps_keep);
    const bool keep = ownok && (__ldcg(P.hvsel + i) >= thr);
    const bool stay_sunk = (P.sunk0[i] != 0) && (P.sink >= thr);
    const bool open_t = valid && !(keep || stay_sunk);
    const bool to_sink = open_t && (v1 <= P.sink);
    P.sunk[i] = (stay_sunk || to_sink || !valid) ? 1 : 0;
    const bool bidding = open_t && !to_sink;
    P.open[i] = bidding ? 1 : 0;
    const int ac = P.acol0[i];
    if (ownok && !keep && ac >= 0 && ac < P.C) P.owner[ac] = -1;  // release
    if (bidding) {
      const int j1 = __ldcg(P.hj1 + i);
      const float delta =
          __fadd_rn(__fsub_rn(v1, fmaxf(__ldcg(P.hv2 + i), P.sink)), eps);
      const float bidv = __fadd_rn(delta, P.p0[j1]);
      unsigned long long key =
          ((unsigned long long)f2o(bidv) << 32) |
          (unsigned long long)(0xffffffffu - (unsigned int)i);
      atomicMax(P.bid + j1, key);
    }
  }
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
  // ---- Gauss-Seidel sweeps on factor-built benefits --------------------
  const int r = gs_sweeps<T, true>(P, grid, 1, eps);
  // ---- greedy completion from the parked hints -------------------------
  for (int i = gtid; i < P.S; i += gthreads) {
    if (!__ldcg(P.open + i)) continue;
    const int j1 = __ldcg(P.hj1 + i);
    const float v1n =
        __fadd_rn(__ldcg(P.hv1 + i), __fsub_rn(P.p0[j1], __ldcg(P.p + j1)));
    P.gcol[i] = (v1n > P.sink) ? j1 : P.C;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *P.rounds = r;
    P.stats[0] = bmax;
    P.stats[1] = 0.0f;
    P.stats[2] = eps;
    P.stats[3] = eps_keep;
  }
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

extern "C" int warm_fused(const void* fd, int f32, const void* kps, const void* kpt,
                          const int* ms, const int* mt, const float* p0,
                          const int* acol0, const int* sunk0,
                          const int* ownok, const float* sched, float wed,
                          float wfd, float scale, int mult, float sink,
                          float eps_abs,
                          float rel_eps, float dpen, int max_rounds,
                          int S, int C, int ts,
                          float* p, int* owner, int* sunk, int* open,
                          int* gcol, int* rounds, float* stats,
                          unsigned long long* bid, int* rowdec, int* vic,
                          float* hv1, int* hj1, float* hv2, float* hvsel,
                          unsigned int* bmax, void* stream) {
  Params P = {};
  P.S = S;
  P.C = C;
  P.ts = ts;
  P.n_tiles = S / ts;
  P.max_rounds = max_rounds;
  P.sink = sink;
  P.sched = sched;
  P.mat = fd;
  P.kps = (const float4*)kps;
  P.kpt = (const float4*)kpt;
  P.ms = ms;
  P.mt = mt;
  P.wed = wed;
  P.wfd = wfd;
  P.scale = scale;
  P.mult = mult;
  P.eps_abs = eps_abs;
  P.rel_eps = rel_eps;
  P.dpen = dpen;
  P.p0 = p0;
  P.acol0 = acol0;
  P.sunk0 = sunk0;
  P.ownok = ownok;
  P.p = p;
  P.owner = owner;
  P.sunk = sunk;
  P.open = open;
  P.gcol = gcol;
  P.rounds = rounds;
  P.stats = stats;
  P.bid = bid;
  P.rowdec = rowdec;
  P.vic = vic;
  P.hv1 = hv1;
  P.hj1 = hj1;
  P.hv2 = hv2;
  P.hvsel = hvsel;
  P.bmax = bmax;
  return launch(f32 ? (const void*)warm_fused_kernel<float>
                     : (const void*)warm_fused_kernel<__nv_bfloat16>,
                &P, stream);
}
