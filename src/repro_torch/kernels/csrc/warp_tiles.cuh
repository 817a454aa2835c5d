// Warp-level tile products shared by the backward kernels
// (flash_attention_bwd.cu, gmm_bwd.cu): one warp computes a 16 x 8 NF
// block of C (+)= A B from tiles in shared memory, f32 accumulators in
// the mma.sync m16n8k16 C layout whatever the input type:
//
//   d[f][0], d[f][1]: row g,     columns 8 f + 2 t, 8 f + 2 t + 1
//   d[f][2], d[f][3]: row g + 8, the same columns
//
// with g = lane / 4 and t = lane % 4, rows and columns relative to the
// block's corner.  bf16 tiles go through the tensor cores (mma.sync,
// f32 accumulation); f32 tiles through f32 FMAs in the same layout, so a
// kernel written once over these helpers runs in either type.
//
// A tile is addressed by element strides: element (i, j) at p[i * si +
// j * sj].  A is read as (m, k) and B as its transpose (n, k), so a tile
// kept row-major in shared memory serves as either operand, transposed
// or not, without a copy.  Where k is the contiguous index (sj == 1) a
// bf16 pair is one 32-bit load; else two 16-bit loads.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {
namespace tiles {

template <typename T>
struct Tile {
  const T* p;
  int si, sj;
  __device__ __forceinline__ T at(int i, int j) const { return p[i * si + j * sj]; }
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// elements (i, j) and (i, j + 1) of a bf16 tile, packed low, high
__device__ __forceinline__ uint32_t pair(const Tile<__nv_bfloat16>& a, int i,
                                         int j) {
  if (a.sj == 1)  // i * si + j is even: si and j are
    return *reinterpret_cast<const uint32_t*>(a.p + i * a.si + j);
  const uint16_t* u = reinterpret_cast<const uint16_t*>(a.p);
  return static_cast<uint32_t>(u[i * a.si + j * a.sj]) |
         (static_cast<uint32_t>(u[i * a.si + (j + 1) * a.sj]) << 16);
}

// d[f] += A[m0 : m0 + 16, 0 : K] B[0 : K, n0 + 8 f : n0 + 8 f + 8] for
// f < NF, with B given as Bt (n, k); K a multiple of 16.
template <int NF>
__device__ __forceinline__ void warp_gemm(float (&d)[NF][4],
                                          const Tile<__nv_bfloat16>& A,
                                          const Tile<__nv_bfloat16>& Bt,
                                          int m0, int n0, int K) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t a[4];
    a[0] = pair(A, m0 + g, k0 + 2 * t);
    a[1] = pair(A, m0 + g + 8, k0 + 2 * t);
    a[2] = pair(A, m0 + g, k0 + 2 * t + 8);
    a[3] = pair(A, m0 + g + 8, k0 + 2 * t + 8);
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const uint32_t b0 = pair(Bt, n0 + 8 * f + g, k0 + 2 * t);
      const uint32_t b1 = pair(Bt, n0 + 8 * f + g, k0 + 2 * t + 8);
      hopper::mma_bf16(d[f], a, b0, b1);
    }
  }
}

template <int NF>
__device__ __forceinline__ void warp_gemm(float (&d)[NF][4],
                                          const Tile<float>& A,
                                          const Tile<float>& Bt, int m0,
                                          int n0, int K) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int k = 0; k < K; ++k) {
    const float a0 = A.at(m0 + g, k), a1 = A.at(m0 + g + 8, k);
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const float b0 = Bt.at(n0 + 8 * f + 2 * t, k);
      const float b1 = Bt.at(n0 + 8 * f + 2 * t + 1, k);
      d[f][0] = fmaf(a0, b0, d[f][0]);
      d[f][1] = fmaf(a0, b1, d[f][1]);
      d[f][2] = fmaf(a1, b0, d[f][2]);
      d[f][3] = fmaf(a1, b1, d[f][3]);
    }
  }
}

template <int NF>
__device__ __forceinline__ void zero(float (&d)[NF][4]) {
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int x = 0; x < 4; ++x) d[f][x] = 0.f;
}

// (row, column) of accumulator element x of fragment f, relative to the
// block's corner
__device__ __forceinline__ int frag_row(int x) {
  return ((threadIdx.x & 31) >> 2) + (x >= 2 ? 8 : 0);
}
__device__ __forceinline__ int frag_col(int f, int x) {
  return 8 * f + 2 * (threadIdx.x & 3) + (x & 1);
}

}  // namespace tiles
}  // namespace
