// The grouped matmul's backward pass for Hopper (sm_90a): for the
// forward y[e] = x[e] w[e], x (E, C, D), w (E, D, F), and the cotangent
// dy (E, C, F),
//
//   dx[e] = dy[e] w[e]^T    (E, C, F) x (E, D, F)^T -> (E, C, D)
//   dw[e] = x[e]^T dy[e]    (E, C, D)^T x (E, C, F) -> (E, D, F)
//
// in the input type, accumulated in f32.  w is read in its stored (E, D,
// F) layout and x in its (E, C, D) one: no transposed copy is made.
//
// No TPU kernel is replaced: the reference trains its MoE layer through
// XLA's autodiff of the "egcd,edf->egcf" einsums (src/repro/models/
// moe.py::moe_ffn), while the port's forward is the hand-written kernel
// of gmm.cu (the Pallas kernel src/repro/kernels/moe_gmm.py::gmm's port),
// whose launch autograd cannot see.  This is that kernel's backward
// (kernels/gmm.py::GMM).
//
// Bound: operations.  At the training shape (E=128, C=320, D=2048,
// F=768, bf16) dx and dw are 2 * 2 * E * C * D * F = 258 GFLOP, 0.26 ms at
// 989 TFLOP/s; the bytes (x, w, dy read once, dx, dw written once) are
// 1.3 GB, 0.38 ms at 3.35 TB/s, so at this shape the bytes bound it.
//
// Design (a first one on mma.sync; wgmma and TMA are later work): each
// entry launches one product kernel twice, once for dx and once for dw,
// with the operands given by element strides.  A CTA of 8 warps takes a
// 128 x 128 tile of C[e]; its A and B tiles sit in shared memory
// k-contiguous whatever the source's layout, and each warp takes 64 x 32
// of the tile.
//
// * bf16 (gemm_bf16): K in steps of 64.  Each thread loads its share of
//   the next step's tiles as 16-byte vectors into registers before the
//   tensor cores run the current one, then stores them: along k where
//   the source is k-contiguous (dy's rows for dx, w's rows), else along
//   the rows (x's and dy's rows for dw, written transposed into shared
//   memory).  Fragments come by ldmatrix, each B fragment serving four
//   m16 tiles; products by mma.sync m16n8k16 with f32 accumulation, the
//   output written as bf16 pairs.
// * f32 (gemm): K in steps of 32, scalar loads, warp_tiles.cuh's FMA
//   products in the mma layout.
//
// Every edge is masked: C, the contraction of dw, is any length (the MoE
// layer's is a multiple of 4), and D and F (multiples of 16) need not
// divide the tile.
//
// The C entry points return cudaGetLastError() after the launches, or
// cudaErrorInvalidValue for arguments they refuse.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "warp_tiles.cuh"

namespace {

using tiles::from_f32;
using tiles::Tile;

constexpr int kThreads = 256;
constexpr int kBM = 128, kBN = 128, kBK = 32;

// rows i0 .. i0 + 127 and k0 .. k0 + 31 of an operand (element (i, k) at
// g[i * si + k * sk]) into s[i * kLd + k], zeros past I and K
template <typename T, int kLd>
__device__ __forceinline__ void load_tile(T* s, const T* __restrict__ g,
                                          int i0, int I, long long si,
                                          long long sk, int k0, int K) {
  const T zero = from_f32<T>(0.f);
  for (int x = threadIdx.x; x < 128 * kBK; x += kThreads) {
    int i, kk;
    if (sk == 1) {  // k contiguous in the source: threads along k
      i = x / kBK;
      kk = x - i * kBK;
    } else {        // i contiguous: threads along i
      kk = x / 128;
      i = x - kk * 128;
    }
    const int gi = i0 + i, gk = k0 + kk;
    s[i * kLd + kk] = (gi < I && gk < K) ? g[gi * si + gk * sk] : zero;
  }
}

// C[e] (M x N, contiguous) = A[e] (M x K) B[e] (K x N); A's element
// (m, k) at a + e sae + m sam + k sak, B's (k, n) at b + e sbe + k sbk +
// n sbn
template <typename T>
__global__ void __launch_bounds__(kThreads)
gemm(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ c,
     int M, int N, int K, long long sae, long long sam, long long sak,
     long long sbe, long long sbn, long long sbk) {
  constexpr int kLd = kBK + 16 / static_cast<int>(sizeof(T));
  __shared__ __align__(16) T As[kBM * kLd];
  __shared__ __align__(16) T Bs[kBN * kLd];
  const int e = blockIdx.z, m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const T* ae = a + e * sae;
  const T* be = b + e * sbe;
  const int warp = threadIdx.x >> 5;
  const int wm = 64 * (warp >> 2), wn = 32 * (warp & 3);

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) tiles::zero(acc[mt]);
  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();  // the last step's reads are done
    load_tile<T, kLd>(As, ae, m0, M, sam, sak, k0, K);
    load_tile<T, kLd>(Bs, be, n0, N, sbn, sbk, k0, K);
    __syncthreads();
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
      tiles::warp_gemm<4>(acc[mt], Tile<T>{As, kLd, 1}, Tile<T>{Bs, kLd, 1},
                          wm + 16 * mt, wn, kBK);
  }

  T* ce = c + static_cast<long long>(e) * M * N;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int f = 0; f < 4; ++f)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int m = m0 + wm + 16 * mt + tiles::frag_row(x);
        const int n = n0 + wn + tiles::frag_col(f, x);
        if (m < M && n < N)
          ce[static_cast<long long>(m) * N + n] = from_f32<T>(acc[mt][f][x]);
      }
}

// --------------------------------------------------------------------------
// bf16 on the tensor cores

constexpr int kBK16 = 64;             // k a step
constexpr int kLd16 = kBK16 + 8;      // shared row: 144 bytes
constexpr int kVecs = 128 * kBK16 / 8 / kThreads;  // 16-byte vectors a thread

// Step k0's vectors of one operand (element (i, k) at g[i si + k sk]) into
// registers: k-contiguous sources (sk == 1) as 8 k's of one row, the
// others (si == 1) as 8 rows at one k; zeros past I and K.
__device__ __forceinline__ void fetch(uint4 (&r)[kVecs],
                                      const __nv_bfloat16* __restrict__ g,
                                      int i0, int I, long long si,
                                      long long sk, int k0, int K) {
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int x = threadIdx.x + j * kThreads;
    int i, k;
    if (sk == 1) {
      i = x / (kBK16 / 8);
      k = (x % (kBK16 / 8)) * 8;
    } else {
      k = x % kBK16;  // consecutive threads on k: the stores below spread
      i = (x / kBK16) * 8;  // over the banks
    }
    const int gi = i0 + i, gk = k0 + k;
    r[j] = make_uint4(0, 0, 0, 0);
    if (gi < I && gk < K)
      r[j] = *reinterpret_cast<const uint4*>(g + gi * si + gk * sk);
  }
}

// the registers of fetch into the k-contiguous tile s[i * kLd16 + k]
__device__ __forceinline__ void stash(__nv_bfloat16* s,
                                      const uint4 (&r)[kVecs], bool kvec) {
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int x = threadIdx.x + j * kThreads;
    if (kvec) {
      const int i = x / (kBK16 / 8), k = (x % (kBK16 / 8)) * 8;
      *reinterpret_cast<uint4*>(s + i * kLd16 + k) = r[j];
    } else {
      const int k = x % kBK16, i = (x / kBK16) * 8;
      const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&r[j]);
#pragma unroll
      for (int t = 0; t < 8; ++t) s[(i + t) * kLd16 + k] = v[t];
    }
  }
}

// C[e] = A[e] B[e] as gemm above, bf16 in and out; A's and B's row
// counts are M and N, their k-contiguity given by sak / sbk == 1
__global__ void __launch_bounds__(kThreads)
gemm_bf16(const __nv_bfloat16* __restrict__ a,
          const __nv_bfloat16* __restrict__ b, __nv_bfloat16* __restrict__ c,
          int M, int N, int K, long long sae, long long sam, long long sak,
          long long sbe, long long sbn, long long sbk) {
  __shared__ __align__(16) __nv_bfloat16 As[128 * kLd16];
  __shared__ __align__(16) __nv_bfloat16 Bs[128 * kLd16];
  const int e = blockIdx.z, m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const __nv_bfloat16* ae = a + e * sae;
  const __nv_bfloat16* be = b + e * sbe;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = 64 * (warp >> 2), wn = 32 * (warp & 3);
  // ldmatrix row addresses: lanes 8 q .. 8 q + 7 give matrix q's rows.
  // A (m16 x k16): matrices (rows 0-7, k 0-7), (8-15, 0-7), (0-7, 8-15),
  // (8-15, 8-15), the mma A fragment's a0..a3.  B (two n8 tiles x k16):
  // (n 0-7, k 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15), b0 b1 of the
  // first tile then of the second.
  const int q = lane >> 3, rr = lane & 7;
  const uint32_t a_base = hopper::smem_u32(
      As + (wm + rr + 8 * (q & 1)) * kLd16 + 8 * (q >> 1));
  const uint32_t b_base = hopper::smem_u32(
      Bs + (wn + rr + 8 * (q >> 1)) * kLd16 + 8 * (q & 1));

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) tiles::zero(acc[mt]);
  uint4 ra[kVecs], rb[kVecs];
  fetch(ra, ae, m0, M, sam, sak, 0, K);
  fetch(rb, be, n0, N, sbn, sbk, 0, K);
  for (int k0 = 0; k0 < K; k0 += kBK16) {
    __syncthreads();  // the last step's fragments are read
    stash(As, ra, sak == 1);
    stash(Bs, rb, sbk == 1);
    __syncthreads();
    if (k0 + kBK16 < K) {  // the next step's loads fly under this one
      fetch(ra, ae, m0, M, sam, sak, k0 + kBK16, K);
      fetch(rb, be, n0, N, sbn, sbk, k0 + kBK16, K);
    }
#pragma unroll
    for (int kk = 0; kk < kBK16; kk += 16) {
      uint32_t bf[4][2];
#pragma unroll
      for (int f = 0; f < 4; f += 2) {
        uint32_t r[4];
        hopper::ldmatrix_x4(r, b_base + (f * 8 * kLd16 + kk) * 2);
        bf[f][0] = r[0];
        bf[f][1] = r[1];
        bf[f + 1][0] = r[2];
        bf[f + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        uint32_t af[4];
        hopper::ldmatrix_x4(af, a_base + (mt * 16 * kLd16 + kk) * 2);
#pragma unroll
        for (int f = 0; f < 4; ++f)
          hopper::mma_bf16(acc[mt][f], af, bf[f][0], bf[f][1]);
      }
    }
  }

  __nv_bfloat16* ce = c + static_cast<long long>(e) * M * N;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int f = 0; f < 4; ++f)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + 16 * mt + tiles::frag_row(2 * h);
        const int n = n0 + wn + tiles::frag_col(f, 0);  // even; N % 16 == 0
        if (m < M && n < N)
          *reinterpret_cast<uint32_t*>(ce + static_cast<long long>(m) * N +
                                       n) =
              hopper::pack_bf16(acc[mt][f][2 * h], acc[mt][f][2 * h + 1]);
      }
}

// C[e] = A[e] B[e] on the type's kernel
template <typename T>
void product(dim3 grid, cudaStream_t s, const T* a, const T* b, T* c, int M,
             int N, int K, long long sae, long long sam, long long sak,
             long long sbe, long long sbn, long long sbk) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    gemm_bf16<<<grid, kThreads, 0, s>>>(a, b, c, M, N, K, sae, sam, sak, sbe,
                                        sbn, sbk);
  else
    gemm<T><<<grid, kThreads, 0, s>>>(a, b, c, M, N, K, sae, sam, sak, sbe,
                                      sbn, sbk);
}

template <typename T>
int launch(const void* x, const void* w, const void* dy, void* dx, void* dw,
           int E, int C, int D, int F, void* stream) {
  if (E < 1 || C < 1 || D < 1 || F < 1 || E > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long CD = static_cast<long long>(C) * D,
                  CF = static_cast<long long>(C) * F,
                  DF = static_cast<long long>(D) * F;
  // bf16 moves 16-byte vectors along D and F
  if (std::is_same<T, __nv_bfloat16>::value && (D % 16 != 0 || F % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dx != nullptr) {  // dx[e] = dy[e] w[e]^T: A = dy (c, f), B(f, d) = w[e][d][f]
    const dim3 grid((D + kBN - 1) / kBN, (C + kBM - 1) / kBM, E);
    product<T>(grid, s, static_cast<const T*>(dy), static_cast<const T*>(w),
               static_cast<T*>(dx), C, D, F, CF, F, 1, DF, F, 1);
  }
  if (dw != nullptr) {  // dw[e] = x[e]^T dy[e]: A(d, c) = x[e][c][d], B = dy (c, f)
    const dim3 grid((F + kBN - 1) / kBN, (D + kBM - 1) / kBM, E);
    product<T>(grid, s, static_cast<const T*>(x), static_cast<const T*>(dy),
               static_cast<T*>(dw), D, F, C, CD, 1, D, CF, 1, F);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (E, C, D), w (E, D, F), dy (E, C, F) contiguous; dx (E, C, D) and dw
// (E, D, F) contiguous outputs in the same type, either may be null
extern "C" int gmm_bwd_f32(const void* x, const void* w, const void* dy,
                           void* dx, void* dw, int E, int C, int D, int F,
                           void* stream) {
  return launch<float>(x, w, dy, dx, dw, E, C, D, F, stream);
}

extern "C" int gmm_bwd_bf16(const void* x, const void* w, const void* dy,
                            void* dx, void* dw, int E, int C, int D, int F,
                            void* stream) {
  return launch<__nv_bfloat16>(x, w, dy, dx, dw, E, C, D, F, stream);
}
