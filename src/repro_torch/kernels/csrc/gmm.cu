// Grouped (expert-batched) matrix product for Hopper (sm_90a):
//
//   out[e] = x[e] @ w[e],   x (E, C, D), w (E, D, F) -> out (E, C, F)
//
// Products are accumulated in f32 whatever the input type (bf16 or f32)
// and written in the input type.  All three tensors are contiguous.
//
// Replaces the Pallas kernel src/repro/kernels/moe_gmm.py::gmm (body
// _kernel), the product the reference's MoE layer computes with its
// "egcd,edf->egcf" einsums (models/moe.py:88, :89, :91).  The port's MoE
// layer calls it three times per layer: wi and wg on the (E, G*cap, D)
// slot tensor, wo on the activated (E, G*cap, F) one.
//
// Bound.  At qwen3-moe-30b-a3b's prefill shape (E = 128, C = 624, D =
// 2048, F = 768, bf16) a call is 251 GFLOP and moves 853 MB: 0.254 ms at
// the 989 TFLOP/s dense bf16 rate and 0.255 ms at 3.35 TB/s, nearly
// balanced.  At the decode shape (C = 4) it is bound by the 403 MB of
// weights alone: 0.120 ms.
//
// Design, simple and right first.  One CTA per (column tile, row tile,
// expert) of the output; a loop over D stages slabs of 32 of x and w in
// shared memory through cp.async 16-byte copies, three slabs in flight.
// A copy that would cross the ragged edge (a row >= C, a depth >= D, a
// column >= F) reads nothing and writes zeros, so C need not be a
// multiple of the tile, and D and F need only be multiples of 16 (every
// 16-byte copy then lies wholly inside or wholly outside a row).
//   bf16: tensor cores through nvcuda::wmma bf16 16x16x16 fragments with
//   f32 accumulators.  Tiles of 128 x 128 (8 warps of 64 x 32) when C >
//   16; for C <= 16 (decode) tiles of 16 x 128 (4 warps of 16 x 32), so
//   the CTAs stream the weights without fetching 112 empty rows of x per
//   slab.  The epilogue stages each 16 x 16 accumulator fragment in
//   shared memory, casts it to bf16 and writes the rows < C with 16-byte
//   stores.
//   f32: 64 x 64 tiles of f32 FMAs, 4 x 4 outputs per thread, summed in
//   order over D; TF32 tensor-core tiles would break the 2e-5 tolerance.
// wgmma, TMA and a persistent schedule are later work.
//
// The C entry points return cudaGetLastError() after the launch (or
// cudaErrorInvalidValue for shapes they do not take); the Python wrapper
// raises on a non-zero code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kBK = 32;      // depth of a bf16 slab
constexpr int kBKf = 16;     // depth of an f32 slab
constexpr int kStages = 3;   // slabs in flight

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared; when !pred it reads nothing
// and writes 16 zero bytes (src must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage rows [m0, m0 + ROWS) x depth [k0, k0 + COLS) of a (rows, ld)
// row-major matrix into shared memory with row stride LDS (elements of
// T), zero-filling what lies outside (n_rows, n_cols).
template <typename T, int ROWS, int COLS, int LDS, int THREADS>
__device__ __forceinline__ void stage_tile(T* dst, const T* src, long long ld,
                                           int r0, int c0, int n_rows,
                                           int n_cols, const T* any_valid) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte copy
  constexpr int PER_ROW = COLS / V;
  constexpr int CHUNKS = ROWS * PER_ROW;
  for (int i = threadIdx.x; i < CHUNKS; i += THREADS) {
    const int r = i / PER_ROW, c = (i - r * PER_ROW) * V;
    const bool ok = (r0 + r < n_rows) && (c0 + c < n_cols);
    const T* s = ok ? src + (r0 + r) * ld + c0 + c : any_valid;
    cp_async16(dst + r * LDS + c, s, ok);
  }
}

// ---------------------------------------------------------------------
// bf16: wmma tensor-core tiles
template <int BM, int BN>
struct Bf16Tile {
  static constexpr int LDA = kBK + 8;  // 80-byte rows: 16-byte aligned,
  static constexpr int LDB = BN + 8;   // and 16-row steps 32-byte aligned
  static constexpr int A_STAGE = BM * LDA;
  static constexpr int B_STAGE = kBK * LDB;
  static constexpr size_t kSmem =
      sizeof(__nv_bfloat16) * kStages * (A_STAGE + B_STAGE);
};

template <int BM, int BN, int WARPS_M, int WARPS_N>
__global__ void __launch_bounds__(WARPS_M* WARPS_N * 32)
gmm_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                const __nv_bfloat16* __restrict__ w,
                __nv_bfloat16* __restrict__ out, int C, int D, int F) {
  using Tile = Bf16Tile<BM, BN>;
  constexpr int kThreads = WARPS_M * WARPS_N * 32;
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  constexpr int FM = WM / 16, FN = WN / 16;
  static_assert(WM % 16 == 0 && WN % 16 == 0, "warp tile of 16s");
  static_assert(Tile::kSmem >= WARPS_M * WARPS_N * 256 * sizeof(float),
                "the epilogue's staging fits the pipeline's buffers");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Bs = As + kStages * Tile::A_STAGE;

  const int e = blockIdx.z, m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const __nv_bfloat16* xe = x + static_cast<long long>(e) * C * D;
  const __nv_bfloat16* we = w + static_cast<long long>(e) * D * F;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int nk = (D + kBK - 1) / kBK;

  auto stage = [&](int kt) {
    const int s = kt % kStages, k0 = kt * kBK;
    stage_tile<__nv_bfloat16, BM, kBK, Tile::LDA, kThreads>(
        As + s * Tile::A_STAGE, xe, D, m0, k0, C, D, x);
    stage_tile<__nv_bfloat16, kBK, BN, Tile::LDB, kThreads>(
        Bs + s * Tile::B_STAGE, we, F, k0, n0, D, F, w);
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

#pragma unroll
  for (int kt = 0; kt < kStages - 1; ++kt) {
    if (kt < nk) stage(kt);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();  // slab kt has landed (this thread's part)
    __syncthreads();  // ... every thread's, and slab kt-1 is consumed
    if (kt + kStages - 1 < nk) stage(kt + kStages - 1);
    cp_async_commit();
    const int s = kt % kStages;
    const __nv_bfloat16* a = As + s * Tile::A_STAGE + wm * WM * Tile::LDA;
    const __nv_bfloat16* b = Bs + s * Tile::B_STAGE + wn * WN;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(fa[i], a + i * 16 * Tile::LDA + kk, Tile::LDA);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(fb[j], b + kk * Tile::LDB + j * 16, Tile::LDB);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the pipeline's buffers become the epilogue's

  // each warp stages one 16 x 16 fragment at a time; a lane writes 8
  // columns of one row as one 16-byte store
  float* st = reinterpret_cast<float*>(smem_raw) + warp * 256;
  const int r = lane >> 1, c = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int row = m0 + wm * WM + i * 16 + r;
      const int col = n0 + wn * WN + j * 16 + c;
      if (row < C && col < F) {
        __align__(16) __nv_bfloat16 v[8];
#pragma unroll
        for (int t = 0; t < 8; ++t) v[t] = __float2bfloat16(st[r * 16 + c + t]);
        *reinterpret_cast<uint4*>(
            out + (static_cast<long long>(e) * C + row) * F + col) =
            *reinterpret_cast<const uint4*>(v);
      }
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------------
// f32: FMA register tiles
constexpr int kFBM = 64, kFBN = 64, kFThreads = 256;
constexpr int kFLDA = kBKf + 4, kFLDB = kFBN + 4;  // 16-byte aligned rows

__global__ void __launch_bounds__(kFThreads)
gmm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
               float* __restrict__ out, int C, int D, int F) {
  __shared__ __align__(16) float As[kStages][kFBM * kFLDA];
  __shared__ __align__(16) float Bs[kStages][kBKf * kFLDB];
  const int e = blockIdx.z, m0 = blockIdx.y * kFBM, n0 = blockIdx.x * kFBN;
  const float* xe = x + static_cast<long long>(e) * C * D;
  const float* we = w + static_cast<long long>(e) * D * F;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int nk = (D + kBKf - 1) / kBKf;

  auto stage = [&](int kt) {
    const int s = kt % kStages, k0 = kt * kBKf;
    stage_tile<float, kFBM, kBKf, kFLDA, kFThreads>(As[s], xe, D, m0, k0, C,
                                                   D, x);
    stage_tile<float, kBKf, kFBN, kFLDB, kFThreads>(Bs[s], we, F, k0, n0, D,
                                                   F, w);
  };

  float acc[4][4] = {};
#pragma unroll
  for (int kt = 0; kt < kStages - 1; ++kt) {
    if (kt < nk) stage(kt);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (kt + kStages - 1 < nk) stage(kt + kStages - 1);
    cp_async_commit();
    const float* a = As[kt % kStages];
    const float* b = Bs[kt % kStages];
#pragma unroll
    for (int kk = 0; kk < kBKf; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = a[(ty + 16 * i) * kFLDA + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = b[kk * kFLDB + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= C) continue;
    float* o = out + (static_cast<long long>(e) * C + row) * F;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < F) o[col] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------
bool shape_ok(int E, int C, int D, int F, int bm) {
  return E >= 1 && E <= 65535 && C >= 1 && (C + bm - 1) / bm <= 65535 &&
         D >= 16 && D % 16 == 0 && F >= 16 && F % 16 == 0;
}

template <int BM, int BN, int WARPS_M, int WARPS_N>
int launch_bf16(const void* x, const void* w, void* out, int E, int C, int D,
                int F, cudaStream_t stream) {
  constexpr size_t bytes = Bf16Tile<BM, BN>::kSmem;
  static bool opted_in = false;  // above 48 KB only after opting in
  if (!opted_in) {
    cudaFuncSetAttribute(gmm_bf16_kernel<BM, BN, WARPS_M, WARPS_N>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(bytes));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const dim3 grid((F + BN - 1) / BN, (C + BM - 1) / BM, E);
  gmm_bf16_kernel<BM, BN, WARPS_M, WARPS_N>
      <<<grid, WARPS_M * WARPS_N * 32, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(out),
      C, D, F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int gmm_bf16(const void* x, const void* w, void* out, int E,
                        int C, int D, int F, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C <= 16) {
    if (!shape_ok(E, C, D, F, 16)) return static_cast<int>(cudaErrorInvalidValue);
    return launch_bf16<16, 128, 1, 4>(x, w, out, E, C, D, F, s);
  }
  if (!shape_ok(E, C, D, F, 128)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_bf16<128, 128, 2, 4>(x, w, out, E, C, D, F, s);
}

extern "C" int gmm_f32(const void* x, const void* w, void* out, int E, int C,
                       int D, int F, void* stream) {
  if (!shape_ok(E, C, D, F, kFBM)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((F + kFBN - 1) / kFBN, (C + kFBM - 1) / kFBM, E);
  gmm_f32_kernel<<<grid, kFThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(out), C, D, F);
  return static_cast<int>(cudaGetLastError());
}
