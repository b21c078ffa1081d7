// Shared device helpers of the auction kernels (auction.cu, jacobi.cu):
// the order-preserving float key of the 64-bit atomicMax bids and the
// running row top-2 of (b - p) with the jnp.argmax tie rule.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define NEG_F (-3.0e38f)

// Float bits mapped to an unsigned key that orders like the values.
__device__ __forceinline__ unsigned int f2o(float f) {
  unsigned int u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float o2f(unsigned int o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

struct Top2 {
  float v1;
  int j1;
  float v2;
};

__device__ __forceinline__ Top2 t2_empty() {
  Top2 t;
  t.v1 = -INFINITY;
  t.j1 = 0x7fffffff;
  t.v2 = NEG_F;   // jnp: max over the other columns and the NEG slot of j1
  return t;
}

// Columns are pushed in increasing order per thread: strict > keeps the
// lowest column on ties, and a tie at a later column still counts for v2.
__device__ __forceinline__ void t2_push(Top2& a, float v, int j) {
  if (v > a.v1) {
    a.v2 = fmaxf(a.v2, a.v1);
    a.v1 = v;
    a.j1 = j;
  } else {
    a.v2 = fmaxf(a.v2, v);
  }
}

__device__ __forceinline__ Top2 t2_merge(Top2 a, Top2 b) {
  bool bw = (b.v1 > a.v1) || (b.v1 == a.v1 && b.j1 < a.j1);
  Top2 r;
  if (bw) {
    r.v1 = b.v1;
    r.j1 = b.j1;
    r.v2 = fmaxf(b.v2, a.v1);
  } else {
    r.v1 = a.v1;
    r.j1 = a.j1;
    r.v2 = fmaxf(a.v2, b.v1);
  }
  return r;
}

// The merge of a warp's 32 running top-2s, in every lane.
__device__ __forceinline__ Top2 t2_warp_merge(Top2 t) {
  for (int o = 16; o > 0; o >>= 1) {
    Top2 u;
    u.v1 = __shfl_xor_sync(0xffffffffu, t.v1, o);
    u.j1 = __shfl_xor_sync(0xffffffffu, t.j1, o);
    u.v2 = __shfl_xor_sync(0xffffffffu, t.v2, o);
    t = t2_merge(t, u);
  }
  return t;
}

// Eight consecutive matrix entries as float, from one or two 16-byte loads
// (the matrix element type is bf16 or float32; the row must be 16-byte
// aligned at ``p``).
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float x[8]) {
  uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int q = 0; q < 8; ++q) x[q] = __bfloat162float(h[q]);
}

__device__ __forceinline__ void load8(const float* p, float x[8]) {
  float4 a = __ldg(reinterpret_cast<const float4*>(p));
  float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
