// Shared device helpers of the banded benefit sweeps: K1's fused_benefit
// (cost.cu) and K3's sweep 0 and Gauss-Seidel scans (auction.cu).  Both
// rebuild a benefit entry from the FD and the keypoint factors in the same
// operation order as the plain PyTorch versions, stage the target factors
// of a column chunk with cp.async, and read FD rows as 16-byte vectors.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "top2.cuh"

constexpr int WNT = 512;             // threads per block (one block an SM)
constexpr int WNWARP = WNT / 32;
constexpr int RPW = 4;               // banded sweep: rows a warp
constexpr int BAND = WNWARP * RPW;   // banded sweep: rows a band
constexpr int CHUNK = 1024;          // banded sweep: columns staged at once
constexpr int NARR = 6;              // staged arrays: x, y, z, |t|^2, mask, p
constexpr size_t SMEM_MAX = 232448;  // a block's most on this card

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
__device__ __forceinline__ float mult_weight(float k, float x) {
  return expf(__fmul_rn(-k, logf(fmaxf(x, 1e-6f))));
}

// With LUT, the mult factor of a bf16 FD in [0, 1] (every bf16 pattern up
// to 1.0: LUT_N floats) comes from a table the block fills with
// mult_weight itself, so the bits are the same; a negative FD (its floor
// is 1e-6, as +0's) reads entry 0 and a larger one is computed.
constexpr unsigned int LUT_N = 0x3F81;   // bf16 bits of 1.0, plus one
constexpr int LUT_BYTES = (LUT_N * 4 + 15) & ~15;

// The block fills ``lut``; the caller syncs before reading it.
__device__ __forceinline__ void fill_lut(float k, float* lut) {
  for (int u = threadIdx.x; u < (int)LUT_N; u += blockDim.x)
    lut[u] = mult_weight(k, __uint_as_float((unsigned int)u << 16));
}

template <typename T, bool LUT>
__device__ __forceinline__ float fd_weight(float k, const float* lut,
                                           const Raw8<T>& x, int q) {
  if constexpr (LUT) {
    unsigned int u = x.bits(q);
    if (u & 0x8000u) u = 0;
    if (u < LUT_N) return lut[u];
  }
  return mult_weight(k, x.get(q));
}

// ED of one (row, column) entry from the (x, y, z, |x|^2) factors, in the
// order of the plain version (ops/cost_kernel.py::factor_ed).
__device__ __forceinline__ float entry_ed(float scale, float sx, float sy,
                                          float sz, float sw, float tx,
                                          float ty, float tz, float tw) {
  const float d = __fadd_rn(__fadd_rn(__fmul_rn(sx, tx), __fmul_rn(sy, ty)),
                            __fmul_rn(sz, tz));
  const float d2 =
      fmaxf(__fsub_rn(__fadd_rn(sw, tw), __fmul_rn(2.0f, d)), 0.0f);
  return __fmul_rn(scale, __fsqrt_rn(d2));
}

// CD of an entry from its ED: the BSC blend W_ED * ED + W_FD * FD, or with
// MULT ED times the FD factor ``w`` (fd_weight).
template <bool MULT>
__device__ __forceinline__ float entry_cd(float wed, float wfd, float ed,
                                          float fdv, float w) {
  return MULT ? __fmul_rn(ed, w)
              : __fadd_rn(__fmul_rn(wed, ed), __fmul_rn(wfd, fdv));
}

// Benefit -CD of one valid entry (ops/auction_rounds.py::factor_benefits).
template <bool MULT>
__device__ __forceinline__ float entry_benefit(float wed, float wfd,
                                               float scale, float sx,
                                               float sy, float sz, float sw,
                                               float tx, float ty, float tz,
                                               float tw, float fdv, float w) {
  return -entry_cd<MULT>(wed, wfd,
                         entry_ed(scale, sx, sy, sz, sw, tx, ty, tz, tw),
                         fdv, w);
}

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
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

// Stage columns [cb, cb + width) of the six column arrays (the five rows
// of ``kt`` [5, C] and the prices ``p``) into ``buf``.  Within each
// 256-column pass a lane's eight columns sit as two float4 halves 128
// floats apart, so the warp's reads are conflict-free.
__device__ __forceinline__ void stage_chunk(const float* kt, const float* p,
                                            int C, float* buf, int cb,
                                            int width) {
  const int pieces = width >> 2;   // float4 pieces per array
  for (int k = threadIdx.x; k < NARR * pieces; k += WNT) {
    const int a = k / pieces;
    const int o = (k - a * pieces) << 2;
    const float* src = (a < 5 ? kt + (size_t)a * C : p) + cb + o;
    const int within = o & 255;
    cp_async16(buf + a * CHUNK + (o & ~255) + ((within >> 2) & 1) * 128 +
                   (within >> 3) * 4,
               src);
  }
}

// One half of a lane's 8 staged columns (4 consecutive columns) of the six
// arrays, from the chunk buffer ``b`` at offset ``o``.
struct Cols4 {
  float x[4], y[4], z[4], w[4], m[4], p[4];
  __device__ __forceinline__ void load(const float* b, int o) {
    const float4 X = *reinterpret_cast<const float4*>(b + o);
    const float4 Y = *reinterpret_cast<const float4*>(b + CHUNK + o);
    const float4 Z = *reinterpret_cast<const float4*>(b + 2 * CHUNK + o);
    const float4 W = *reinterpret_cast<const float4*>(b + 3 * CHUNK + o);
    const float4 M = *reinterpret_cast<const float4*>(b + 4 * CHUNK + o);
    const float4 Q = *reinterpret_cast<const float4*>(b + 5 * CHUNK + o);
    x[0] = X.x; x[1] = X.y; x[2] = X.z; x[3] = X.w;
    y[0] = Y.x; y[1] = Y.y; y[2] = Y.z; y[3] = Y.w;
    z[0] = Z.x; z[1] = Z.y; z[2] = Z.z; z[3] = Z.w;
    w[0] = W.x; w[1] = W.y; w[2] = W.z; w[3] = W.w;
    m[0] = M.x; m[1] = M.y; m[2] = M.z; m[3] = M.w;
    p[0] = Q.x; p[1] = Q.y; p[2] = Q.z; p[3] = Q.w;
  }
};
