// Fused cost -> benefit sweep (kernel K1) for Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas TPU kernel ghicp_tpu/ops/cost_kernel.py::fused_benefit
// (_kernel).  In one pass over the [S, C] stripe it computes
//   ED = scale * sqrt(|s|^2 + |t|^2 - 2 s.t)
//   CD = W_ED * ED + W_FD * FD, or with ``mult`` ED * expf(-k logf(max(FD,
//        1e-6))) (the FPFH/RoPS lane, k in the W_FD slot)
//   b  = -CD at valid pairs, -3e38 elsewhere (stored in the FD's type)
// and, from the float32 benefits, v1 = rowmax(b - p) and vsel = (b -
// p)[acol0], the valid pairs' count, sum CD and sum CD^2 and max CD (with
// STATS), max ED and max(-CD).
//
// Bound on this card: memory, one FD read and one b write (268 MB at
// 8192^2 in bf16, 80 us at 3.35 TB/s; twice that in float32), unless the
// mult form's expf / logf outweigh it (float32, no table).
//
// Design: K3's sweep 0 (csrc/auction.cu), with the helpers of sweep.cuh.
// A persistent grid of 512-thread blocks walks bands of 64 rows, a warp 4
// of them.  Chunks of 1024 columns of the target factors (x, y, z, |t|^2,
// mask, from a [5, C] array made once an engine run) and the deflated
// prices are staged in shared memory with cp.async, double-buffered, and
// reused by the band's 64 rows; FD rows are read and b rows written as
// 16-byte vectors (8 bf16 entries a lane, or two float4).  The bf16 mult
// form reads its FD factor from a table of every bf16 FD in [0, 1], filled
// once a block with the same expf / logf (the bits are the same).  A lane
// keeps its rows' v1 and vsel in registers (maxima: any order gives the
// plain version's bits) and its statistics in float over a chunk, folded
// into double at the chunk's end; the block's warps merge them by shuffles
// into global accumulators (double sums, an exact integer count, orderable
// maxima), and the last block to finish writes the six statistics and
// resets the accumulators, so the call is one launch.  The source rows'
// |s|^2, the bool masks and the int64 or int32 acol0 are read as they are.
//
// Everything that must match the plain PyTorch version bit for bit is
// computed with explicitly rounded intrinsics (no FMA contraction; expf and
// logf as PyTorch's exp and log on the card), and b is rounded to bf16 to
// nearest even as PyTorch's conversion does.
//
// Every entry returns cudaGetLastError() of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sweep.cuh"
#include "top2.cuh"

struct CostParams {
  int S, C, acol64;
  float wed, wfd, scale;
  const void* fd;                 // [S, C] bf16 or float32 (T)
  const float* kps;               // [S, 3] source keypoints
  const float* kt;                // [5, C] target x, y, z, |t|^2, mask (0/1)
  const unsigned char* ms;        // [S] source mask (bool)
  const float* p;                 // [C] deflated prices, 16-byte aligned
  const void* acol0;              // [S] int64 (acol64) or int32
  // outputs
  void* b;                        // [S, C] T
  float* v1;                      // [S]
  float* vsel;                    // [S]
  float* stats;                   // [6] count, sum, sumsq, cd max, ed max,
                                  // b max
  // scratch, as the kernel leaves it: zero sums, count and done counter,
  // the maxima's keys at orderable(0, 0, -3e38)
  double* acc;                    // [2]
  unsigned long long* cnt;        // [1]
  unsigned int* mx;               // [3]
  unsigned int* done;             // [1]
};

// A lane's outputs of one row: its 8 bf16 entries written as 16 bytes, or
// each half's 4 float32 entries as 16 bytes.
template <typename T>
struct Out8;

template <>
struct Out8<__nv_bfloat16> {
  unsigned int w[4];
  __device__ __forceinline__ void set(int q, float v) {
    const unsigned int h =
        (unsigned int)__bfloat16_as_ushort(__float2bfloat16_rn(v));
    if (q & 1)
      w[q >> 1] |= h << 16;
    else
      w[q >> 1] = h;
  }
  __device__ __forceinline__ void store(__nv_bfloat16* dst) const {
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <>
struct Out8<float> {
  float v[4];
  __device__ __forceinline__ void set(int q, float x) { v[q & 3] = x; }
  __device__ __forceinline__ void store_half(float* dst, int h) const {
    *reinterpret_cast<float4*>(dst + 4 * h) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <typename T, bool MULT, bool LUT, bool STATS>
__global__ void __launch_bounds__(WNT, 1) cost_kernel(CostParams P) {
  extern __shared__ __align__(16) unsigned char smem_all[];
  // [the mult factor table (LUT)][the chunk staging]
  float* lut = reinterpret_cast<float*>(smem_all);
  float* sm = reinterpret_cast<float*>(smem_all + (LUT ? LUT_BYTES : 0));
  __shared__ int s_last;
  if (LUT) {
    fill_lut(P.wfd, lut);
    __syncthreads();
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int S = P.S, C = P.C;
  const int nch = (C + CHUNK - 1) / CHUNK;
  double a1 = 0.0, a2 = 0.0;
  unsigned int n = 0;
  float cdmx = 0.0f, edmx = 0.0f, bmx = NEG_F;
  for (int band = blockIdx.x; band * BAND < S; band += gridDim.x) {
    float sx[RPW], sy[RPW], sz[RPW], sw[RPW], v1[RPW], vs[RPW];
    int ac[RPW], mode[RPW];   // mode: 0 no row, 1 masked row, 2 valid row
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int row = band * BAND + warp * RPW + r;
      v1[r] = -INFINITY;
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
        const long long a =
            P.acol64 ? static_cast<const long long*>(P.acol0)[row]
                     : (long long)static_cast<const int*>(P.acol0)[row];
        ac[r] = (a >= 0 && a < C) ? (int)a : -1;
        mode[r] = P.ms[row] ? 2 : 1;
      }
    }
    const size_t base = (size_t)(band * BAND + warp * RPW) * C;
    const T* fdb = static_cast<const T*>(P.fd) + base;
    T* bb = static_cast<T*>(P.b) + base;
    stage_chunk(P.kt, P.p, C, sm, 0, min(CHUNK, C));
    cp_commit();
    for (int ch = 0; ch < nch; ++ch) {
      const int cb = ch * CHUNK;
      if (ch + 1 < nch)
        stage_chunk(P.kt, P.p, C, sm + ((ch + 1) & 1) * NARR * CHUNK,
                    cb + CHUNK, min(CHUNK, C - cb - CHUNK));
      cp_commit();
      cp_wait1();
      __syncthreads();
      const float* buf = sm + (ch & 1) * NARR * CHUNK;
      const int width = min(CHUNK, C - cb);
      float f1 = 0.0f, f2 = 0.0f;   // the chunk's sums of CD and CD^2
      for (int ps = 0; ps * 256 < width; ++ps) {
        const int c0 = cb + ps * 256 + lane * 8;
        if (c0 >= C) continue;
        Raw8<T> x[RPW];
#pragma unroll
        for (int r = 0; r < RPW; ++r)
          if (mode[r] == 2) x[r].load(fdb + (size_t)r * C + c0);
        Out8<T> o[RPW];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          Cols4 k;
          k.load(buf, ps * 256 + h * 128 + lane * 4);
#pragma unroll
          for (int r = 0; r < RPW; ++r) {
            if (mode[r] == 0) continue;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int c = c0 + h * 4 + q;
              float bt = NEG_F;
              if (mode[r] == 2 && k.m[q] != 0.0f) {
                const float ed =
                    entry_ed(P.scale, sx[r], sy[r], sz[r], sw[r], k.x[q],
                             k.y[q], k.z[q], k.w[q]);
                const float cd = entry_cd<MULT>(
                    P.wed, P.wfd, ed, MULT ? 0.0f : x[r].get(h * 4 + q),
                    MULT ? fd_weight<T, LUT>(P.wfd, lut, x[r], h * 4 + q)
                         : 0.0f);
                bt = -cd;
                if (STATS) {
                  ++n;
                  f1 = __fadd_rn(f1, cd);
                  f2 = __fadd_rn(f2, __fmul_rn(cd, cd));
                  cdmx = fmaxf(cdmx, cd);
                }
                edmx = fmaxf(edmx, ed);
                bmx = fmaxf(bmx, bt);
              }
              o[r].set(h * 4 + q, bt);
              const float v = __fsub_rn(bt, k.p[q]);
              v1[r] = fmaxf(v1[r], v);
              if (c == ac[r]) vs[r] = fmaxf(vs[r], v);
            }
          }
          if constexpr (sizeof(T) == 4) {
#pragma unroll
            for (int r = 0; r < RPW; ++r)
              if (mode[r] != 0) o[r].store_half(bb + (size_t)r * C + c0, h);
          }
        }
        if constexpr (sizeof(T) == 2) {
#pragma unroll
          for (int r = 0; r < RPW; ++r)
            if (mode[r] != 0) o[r].store(bb + (size_t)r * C + c0);
        }
      }
      if (STATS) {
        a1 += (double)f1;
        a2 += (double)f2;
      }
      __syncthreads();   // buffer (ch & 1) is free for chunk ch + 2
    }
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      if (mode[r] == 0) continue;   // warp-uniform
      float a = v1[r], v = vs[r];
      for (int s = 16; s > 0; s >>= 1) {
        a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, s));
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, s));
      }
      if (lane == 0) {
        const int row = band * BAND + warp * RPW + r;
        P.v1[row] = a;
        P.vsel[row] = v;
      }
    }
  }
  // ---- the block's statistics into the global accumulators -------------
  for (int s = 16; s > 0; s >>= 1) {
    edmx = fmaxf(edmx, __shfl_xor_sync(0xffffffffu, edmx, s));
    bmx = fmaxf(bmx, __shfl_xor_sync(0xffffffffu, bmx, s));
    if (STATS) {
      a1 += __shfl_xor_sync(0xffffffffu, a1, s);
      a2 += __shfl_xor_sync(0xffffffffu, a2, s);
      n += __shfl_xor_sync(0xffffffffu, n, s);
      cdmx = fmaxf(cdmx, __shfl_xor_sync(0xffffffffu, cdmx, s));
    }
  }
  if (lane == 0) {
    atomicMax(P.mx + 1, f2o(edmx));
    atomicMax(P.mx + 2, f2o(bmx));
    if (STATS) {
      atomicAdd(P.acc, a1);
      atomicAdd(P.acc + 1, a2);
      atomicAdd(P.cnt, (unsigned long long)n);
      atomicMax(P.mx, f2o(cdmx));
    }
  }
  // ---- the last block writes the statistics and resets the scratch -----
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(P.done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (s_last && threadIdx.x == 0) {
    __threadfence();
    const double s1 = __ldcg(P.acc), s2 = __ldcg(P.acc + 1);
    const unsigned long long c = __ldcg(P.cnt);
    P.stats[0] = STATS ? __ull2float_rn(c) : 0.0f;
    P.stats[1] = STATS ? __double2float_rn(s1) : 0.0f;
    P.stats[2] = STATS ? __double2float_rn(s2) : 0.0f;
    P.stats[3] = STATS ? o2f(__ldcg(P.mx)) : 0.0f;
    P.stats[4] = o2f(__ldcg(P.mx + 1));
    P.stats[5] = o2f(__ldcg(P.mx + 2));
    P.acc[0] = 0.0;
    P.acc[1] = 0.0;
    *P.cnt = 0ull;
    P.mx[0] = f2o(0.0f);
    P.mx[1] = f2o(0.0f);
    P.mx[2] = f2o(NEG_F);
    *P.done = 0u;
  }
}

static size_t cost_smem(bool lut) {
  return (size_t)2 * NARR * CHUNK * sizeof(float) + (lut ? LUT_BYTES : 0);
}

template <typename T, bool MULT, bool LUT, bool STATS>
static int launch_cost(CostParams* P, void* stream) {
  static int sms = 0;
  const void* fn = (const void*)cost_kernel<T, MULT, LUT, STATS>;
  const size_t smem = cost_smem(LUT);
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  const int bands = (P->S + BAND - 1) / BAND;
  cost_kernel<T, MULT, LUT, STATS>
      <<<min(bands, sms), WNT, smem, (cudaStream_t)stream>>>(*P);
  return (int)cudaGetLastError();
}

template <typename T, bool MULT, bool LUT>
static int launch_cost_s(CostParams* P, int stats, void* stream) {
  return stats ? launch_cost<T, MULT, LUT, true>(P, stream)
               : launch_cost<T, MULT, LUT, false>(P, stream);
}

extern "C" int fused_benefit(const void* fd, int f32, int mult, int stats,
                             const float* kps, const float* kt, const void* ms,
                             const float* p, const void* acol0, int acol64,
                             float wed, float wfd, float scale, int S, int C,
                             void* b, float* v1, float* vsel, float* out,
                             double* acc, unsigned long long* cnt,
                             unsigned int* mx, unsigned int* done,
                             void* stream) {
  CostParams P = {};
  P.S = S;
  P.C = C;
  P.acol64 = acol64;
  P.wed = wed;
  P.wfd = wfd;
  P.scale = scale;
  P.fd = fd;
  P.kps = kps;
  P.kt = kt;
  P.ms = (const unsigned char*)ms;
  P.p = p;
  P.acol0 = acol0;
  P.b = b;
  P.v1 = v1;
  P.vsel = vsel;
  P.stats = out;
  P.acc = acc;
  P.cnt = cnt;
  P.mx = mx;
  P.done = done;
  if (f32)
    return mult ? launch_cost_s<float, true, false>(&P, stats, stream)
                : launch_cost_s<float, false, false>(&P, stats, stream);
  return mult ? launch_cost_s<__nv_bfloat16, true, true>(&P, stats, stream)
              : launch_cost_s<__nv_bfloat16, false, false>(&P, stats, stream);
}
