// The grouped matmul's backward pass for Hopper (sm_90a): for the
// forward y[e] = x[e] w[e], x (E, C, D), w (E, D, F), and the cotangent
// dy (E, C, F),
//
//   dx[e] = dy[e] w[e]^T    (E, C, F) x (E, D, F)^T -> (E, C, D)
//   dw[e] = x[e]^T dy[e]    (E, C, D)^T x (E, C, F) -> (E, D, F)
//
// in the input type, accumulated in f32, each output rounded once.  x, w
// and dy are read in their stored layouts: no transposed copy is made.
//
// No TPU kernel is replaced: the reference trains its MoE layer through
// XLA's autodiff of the "egcd,edf->egcf" einsums (src/repro/models/
// moe.py::moe_ffn), while the port's forward is the hand-written kernel
// of gmm.cu (the Pallas kernel src/repro/kernels/moe_gmm.py::gmm's port),
// whose launch autograd cannot see.  This is that kernel's backward
// (kernels/gmm.py::GMM).
//
// Bound: bytes.  At the training shape (E = 128, C = 320, D = 2048, F =
// 768, bf16) dx and dw are 2 * 2 * E * C * D * F = 258 GFLOP, 0.26 ms at
// 989 TFLOP/s; x, w and dy read once and dx and dw written once are
// 1.2 GB, 0.36 ms at 3.35 TB/s.  Each product alone is nearly balanced
// (634 MB and 129 GFLOP), so it needs the tensor cores' rate and
// streaming at once.
//
// Which inputs take which kernel is the Python wrapper's choice
// (kernels/gmm.py::_bwd_variant); each has its own C entry:
//
// * gmm_bwd_bf16, the wgmma kernels (bf16; D and F multiples of 16,
//   bases 16-byte aligned, as TMA needs).  One template, gmm_bwd_wgmma,
//   launched once for dx and once for dw, in the shape of gmm.cu's
//   gmm_wgmma: persistent CTAs (one per SM) walk the output tiles expert
//   by expert so that an expert's operands are reused from L2; a CTA is
//   one producer warpgroup and two consumer warpgroups (setmaxnreg moves
//   registers to the consumers); one producer thread fills a ring of
//   128-byte-swizzled stages by TMA from 3-d tensor maps over (E, C, D),
//   (E, D, F) and (E, C, F), with a full / empty mbarrier pair a
//   stage, so rows past C (or D, F) load as zeros and never read the
//   next expert; each consumer warpgroup owns 64 rows of the tile and
//   runs wgmma with f32 accumulators in registers, one stage's group in
//   flight behind the next; the epilogue stages the tile in bf16 by
//   stmatrix in the store's swizzled layout, in two halves through one
//   buffer a warpgroup (the second once the store has read the first:
//   the ring takes the rest of the 227 KB), and another producer thread
//   stores them by TMA (clipped at C, D and F) while the consumers go on
//   with the next tile.  Every operand is read in place through the
//   descriptors:
//   - dx is computed transposed, dx[e]^T = w[e] dy[e]^T, so that the
//     403 MB of w stream once as the 64-row side: A = w (rows d, f
//     contiguous: K-major), B = dy (rows c, f contiguous: K-major, wgmma's
//     untransposed B).  A tile is 128 rows of D x 320 of C, each
//     warpgroup's 64 x 320 as two m64n160k16 accumulators; at C = 320 it
//     covers an expert's rows exactly, with no padded row (a C that is
//     not a multiple of 320 pads its last tile's columns with the loads'
//     zeros).  Three 56 KB stages; the epilogue writes each 64 x 160
//     accumulator transposed, by stmatrix.trans, as a (160 of C) x (64
//     of D) box of dx.
//   - dw: A = x^T (rows c, d contiguous: MN-major, the transpose-A bit),
//     B = dy (rows c, f contiguous: MN-major, the transpose-B bit); the
//     contraction runs over C, whose ragged end the maps' zero fill
//     makes exact.  A tile is 128 rows of D x 256 of F (m64n256k16 a
//     warpgroup), five 64-deep steps at C = 320, through four 48 KB
//     stages (three, with the whole tile staged at once, ran slower on
//     the H100: the short k loop needs the deeper ring).
//   Every wgmma sits on its warpgroup's uniform path (ptxas serialises
//   them all when one sits under a branch or beside a TMA store), and a
//   wait that sees no progress for ~2^34 cycles traps instead of holding
//   the card.  The Hopper helpers come from hopper.cuh.
// * gmm_bwd_f32 (f32, gemm): 128 x 128 tiles of f32 FMAs in
//   warp_tiles.cuh's mma layout, K in steps of 32, scalar loads; TF32
//   tensor-core tiles would break the 2e-5 tolerance.
// * gmm_bwd_bf16_mma (gemm_bf16): the earlier bf16 design, mma.sync
//   m16n8k16 on 128 x 128 tiles whose 16-byte vectors pass through
//   registers a step ahead (transposed by hand into shared memory for
//   dw).  No caller on the main path takes it; it is timed beside the
//   wgmma kernels.
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
// bf16 by mma.sync (gemm_bf16): the design the wgmma kernels replaced,
// reached only as kernels/gmm.py::_bwd_variant's "mma" answer, so that it
// can be timed beside them

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


// --------------------------------------------------------------------------
// bf16: the wgmma kernels
namespace wg {

using namespace hopper;

constexpr int kThreads = 384;  // two consumer warpgroups, then the producer
constexpr int kProducerRegs = 40;   // 128 x (40 + 2 x 232) <= 65536
constexpr int kConsumerRegs = 232;
constexpr int kBM = 128;      // rows of D in an output tile, 64 a warpgroup
constexpr int kBK = 64;       // depth of a stage: one 128-byte row of bf16
constexpr int kBlock = 64 * 128;  // bytes of 64 rows of one 128-byte row

// dx^T tiles: 128 of D x (two chunks of 160) of C
constexpr int kDxChunk = 160;
constexpr int kDxBN = 2 * kDxChunk;
constexpr int kDxABytes = kBM * 128;             // w: 128 rows, 16 KB
constexpr int kDxChunkBytes = kDxChunk * 128;    // dy: 160 rows, 20 KB
constexpr int kDxStage = kDxABytes + 2 * kDxChunkBytes;  // 56 KB
// dw tiles: 128 of D x 256 of F
constexpr int kDwBN = 256;
constexpr int kDwABytes = 2 * kBlock;            // x: 64 rows of 128 of D
constexpr int kDwStage = kDwABytes + 4 * kBlock;  // and dy's 256 of F: 48 KB

template <bool kDx>
struct Shape {
  static constexpr int kBN = kDx ? kDxBN : kDwBN;
  static constexpr int kStage = kDx ? kDxStage : kDwStage;
  // stages: with the staging buffers they fill the 227 KB
  static constexpr int kRing = kDx ? 3 : 4;
  // a warpgroup's staging buffer, used twice a tile: one (160 of C) x (64
  // of D) box of dx, or 64 rows of D x 128 of F of dw
  static constexpr int kOut = kDx ? kDxChunkBytes : 2 * kBlock;
  static constexpr size_t kSmem = static_cast<size_t>(kRing) * kStage +
                                  2 * kOut + 8 * (2 * kRing + 4) + 1024;
};

// m64n160k16, A and B K-major (dx: w's rows and dy's rows, f contiguous)
__device__ __forceinline__ void wgmma_n160(float (&d)[80], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79"
      "}, %80, %81, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "l"(a), "l"(b), "r"(scale_d));
}

// m64n256k16, A and B MN-major, both transpose bits set (dw: x's and
// dy's rows, d and f contiguous; k = c runs across the rows)
__device__ __forceinline__ void wgmma_n256_t(float (&d)[128], uint64_t a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(scale_d));
}

// The 8-column blocks n and n + 1 of a warp's 16 accumulator rows (four
// 8 x 8 matrices: (n, rows 0-7), (n, rows 8-15), (n + 1, rows 0-7), (n +
// 1, rows 8-15)) into shared memory in bf16 by stmatrix, each matrix
// transposed when kTrans: lanes 8 i .. 8 i + 7 give the addresses of the
// rows of matrix i as stored (with kTrans a stored row is a column of the
// accumulator's matrix).
template <bool kTrans, int N>
__device__ __forceinline__ void stmatrix_pair(const float (&acc)[N], int n,
                                              uint32_t addr) {
  const uint32_t r0 = pack_bf16(acc[4 * n], acc[4 * n + 1]),
                 r1 = pack_bf16(acc[4 * n + 2], acc[4 * n + 3]),
                 r2 = pack_bf16(acc[4 * n + 4], acc[4 * n + 5]),
                 r3 = pack_bf16(acc[4 * n + 6], acc[4 * n + 7]);
  if constexpr (kTrans)
    asm volatile(
        "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], "
        "{%1, %2, %3, %4};\n" ::"r"(addr),
        "r"(r0), "r"(r1), "r"(r2), "r"(r3)
        : "memory");
  else
    asm volatile(
        "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n"
        ::"r"(addr), "r"(r0), "r"(r1), "r"(r2), "r"(r3)
        : "memory");
}

// One 64 (D) x 160 (C) accumulator of a warpgroup into its staging buffer
// as the (160 of C) x (64 of D) box of dx, in the store's 128-byte
// swizzled layout (the 16-byte chunk k of row r at chunk k ^ (r % 8)).
// acc[4 n + 2 h + i] holds (d, c) = (16 warp + lane / 4 + 8 h, 8 n + 2
// (lane % 4) + i): each 8 x 8 block (n, h) is one matrix, stored
// transposed, whose row c holds d's chunk 2 warp + h.
__device__ __forceinline__ void stash_dx(const float (&acc)[kDxChunk / 2],
                                         uint32_t buf, int warp, int lane) {
  const int q = lane >> 3, rr = lane & 7;  // this lane's matrix and row
  const uint32_t chunk = (2 * warp + (q & 1)) ^ rr;
#pragma unroll
  for (int n = 0; n < kDxChunk / 8; n += 2)
    stmatrix_pair<true>(
        acc, n, buf + (8 * (n + (q >> 1)) + rr) * 128 + (chunk << 4));
}

// The 64-column blocks kFirst and kFirst + 1 of a warpgroup's 64 (D) x
// 256 (F) accumulator of dw into its staging buffer, each kBlock bytes in
// the store's swizzled layout; each 8 x 8 block (n, h) is one matrix,
// whose row 16 warp + 8 h + r holds chunk n % 8 of block n / 8.
template <int kFirst>
__device__ __forceinline__ void stash_dw(const float (&acc)[kDwBN / 2],
                                         uint32_t buf, int warp, int lane) {
  const int q = lane >> 3, rr = lane & 7;
  const uint32_t row = (16 * warp + 8 * (q & 1) + rr) * 128;
#pragma unroll
  for (int n = 8 * kFirst; n < 8 * (kFirst + 2); n += 2) {
    const int nq = n + (q >> 1);
    stmatrix_pair<false>(acc, n,
                         buf + (nq / 8 - kFirst) * kBlock + row +
                             (((nq % 8) ^ rr) << 4));
  }
}

// After a warpgroup's stash into its staging buffer: the generic-proxy
// writes before the TMA store (async proxy) reads them, then each warp
// tells the storing thread.
__device__ __forceinline__ void staged(uint32_t ofull, int lane) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncwarp();
  if (lane == 0) mbar_arrive(ofull);
}

// dx (kDx): amap over w (E, D, F), bmap over dy (E, C, F), omap over dx
// (E, C, D).  dw: amap over x (E, C, D), bmap over dy, omap over dw (E,
// D, F).  Tile t: expert t / (n_m n_n), then n_n column tiles (of C for
// dx, of F for dw), then n_m row tiles of D, so that consecutive CTAs
// share the column tile's operand; nk stages of 64 a tile.
template <bool kDx>
__global__ void __launch_bounds__(kThreads, 1)
gmm_bwd_wgmma(const __grid_constant__ CUtensorMap amap,
              const __grid_constant__ CUtensorMap bmap,
              const __grid_constant__ CUtensorMap omap, int n_m, int n_n,
              int nk, int n_tiles) {
  using S = Shape<kDx>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sout = ring + S::kRing * S::kStage;
  // full[s] at bars + 8 s, empty[s] at bars + 8 (S::kRing + s); for the
  // staging buffer of warpgroup h: ofull[h] (written) and oempty[h] (its
  // store has read it)
  const uint32_t bars = sout + 2 * S::kOut;
  const uint32_t obars = bars + 16 * S::kRing;
  const int tid = threadIdx.x;
  const int per_expert = n_m * n_n;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < S::kRing; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (S::kRing + s), 8);  // the consumers' 8 warps
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mbar_init(obars + 8 * h, 4);  // a warpgroup's 4 warps
      mbar_init(obars + 8 * (2 + h), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup's role, warp-uniform as the compiler sees it, so that
  // each role's code gets its setmaxnreg budget
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (role == 2) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == 256) {  // one thread keeps the ring full
      int g = 0;  // stages issued so far: the ring position
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const int e = t / per_expert, r = t - e * per_expert;
        const int m0 = (r % n_m) * kBM, n0 = (r / n_m) * S::kBN;
        for (int kt = 0; kt < nk; ++kt, ++g) {
          const int s = g % S::kRing, k0 = kt * kBK;
          if (g >= S::kRing)
            mbar_wait(bars + 8 * (S::kRing + s), ((g / S::kRing) - 1) & 1);
          const uint32_t full = bars + 8 * s;
          const uint32_t dst = ring + s * S::kStage;
          mbar_expect_tx(full, S::kStage);
          if constexpr (kDx) {
            // w: 64 of F x 128 rows of D; dy: 64 of F x 160 rows of C, twice
            tma_load_3d(dst, &amap, full, k0, m0, e);
#pragma unroll
            for (int j = 0; j < 2; ++j)
              tma_load_3d(dst + kDxABytes + j * kDxChunkBytes, &bmap, full,
                          k0, n0 + j * kDxChunk, e);
          } else {
            // x: 64 of D x 64 rows of C, twice; dy: 64 of F x 64 rows of
            // C, four times
#pragma unroll
            for (int h = 0; h < 2; ++h)
              tma_load_3d(dst + h * kBlock, &amap, full, m0 + 64 * h, k0, e);
#pragma unroll
            for (int c = 0; c < 4; ++c)
              tma_load_3d(dst + kDwABytes + c * kBlock, &bmap, full,
                          n0 + 64 * c, k0, e);
          }
        }
      }
    } else if (tid == 288) {
      // another stores each warpgroup's staged half tile once its 4 warps
      // have written it (nothing past C, D or F is written), and frees
      // the buffer when the store has read it.  (A TMA store on a consumer
      // warpgroup's path makes the compiler serialise the wgmmas.)
      int u = 0;  // uses of each staging buffer so far
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const int e = t / per_expert, r = t - e * per_expert;
        const int m0 = (r % n_m) * kBM, n0 = (r / n_m) * S::kBN;
        for (int j = 0; j < 2; ++j, ++u)
          for (int h = 0; h < 2; ++h) {
            mbar_wait(obars + 8 * h, u & 1);
            const uint32_t buf = sout + h * S::kOut;
            if constexpr (kDx) {
              tma_store_3d(&omap, buf, m0 + 64 * h, n0 + j * kDxChunk, e);
            } else {
#pragma unroll
              for (int c = 0; c < 2; ++c)
                tma_store_3d(&omap, buf + c * kBlock, n0 + 128 * j + 64 * c,
                             m0 + 64 * h, e);
            }
            bulk_wait<true>();
            mbar_arrive(obars + 8 * (2 + h));
          }
      }
      bulk_wait<false>();  // the last stores have landed
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wgi = role, warp = (tid & 127) >> 5, lane = tid & 31;
  const uint32_t buf = sout + wgi * S::kOut;
  const uint32_t ofull = obars + 8 * wgi, oempty = obars + 8 * (2 + wgi);
  int g = 0, u = 0;
  // dx: two 64 x 160 accumulators; dw: one 64 x 256 (acc1 unused)
  float acc0[kDx ? kDxChunk / 2 : kDwBN / 2], acc1[kDx ? kDxChunk / 2 : 1];
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
#pragma unroll
    for (int i = 0; i < static_cast<int>(sizeof(acc0) / 4); ++i) acc0[i] = 0.f;
#pragma unroll
    for (int i = 0; i < static_cast<int>(sizeof(acc1) / 4); ++i) acc1[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt, ++g) {
      const int s = g % S::kRing;
      mbar_wait(bars + 8 * s, (g / S::kRing) & 1);
      const uint32_t a = ring + s * S::kStage + wgi * kBlock;
      const uint32_t b = ring + s * S::kStage + (kDx ? kDxABytes : kDwABytes);
      pin(acc0);
      pin(acc1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        if constexpr (kDx) {
          // K-major A and B: a k16 step is 32 bytes inside the swizzled
          // rows
          const uint64_t da = desc(a + kk * 32, 16, 1024);
          wgmma_n160(acc0, da, desc(b + kk * 32, 16, 1024), 1);
          wgmma_n160(acc1, da, desc(b + kDxChunkBytes + kk * 32, 16, 1024),
                     1);
        } else {
          // MN-major A and B: a k16 step is 16 rows, 2048 bytes; LBO
          // steps between B's 64-column blocks
          wgmma_n256_t(acc0, desc(a + kk * 2048, kBlock, 1024),
                       desc(b + kk * 2048, kBlock, 1024), 1);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's group is done
      pin(acc0);
      pin(acc1);
      if (kt > 0 && lane == 0)
        mbar_arrive(bars + 8 * (S::kRing + (g - 1) % S::kRing));
    }
    wgmma_wait<0>();
    pin(acc0);
    pin(acc1);
    if (lane == 0) mbar_arrive(bars + 8 * (S::kRing + (g - 1) % S::kRing));

    // Epilogue: the tile in two staged halves, each once the last store
    // has read the buffer
    if (u > 0) mbar_wait(oempty, (u - 1) & 1);
    if constexpr (kDx)
      stash_dx(acc0, buf, warp, lane);
    else
      stash_dw<0>(acc0, buf, warp, lane);
    staged(ofull, lane);
    mbar_wait(oempty, u & 1);
    if constexpr (kDx)
      stash_dx(acc1, buf, warp, lane);
    else
      stash_dw<2>(acc0, buf, warp, lane);
    staged(ofull, lane);
    u += 2;
  }
}

template <bool kDx>
int launch_product(const CUtensorMap& amap, const CUtensorMap& bmap,
                   const CUtensorMap& omap, int E, int n_m, int n_n, int nk,
                   cudaStream_t stream) {
  static bool opted_in = false;
  if (const int err = opt_in(gmm_bwd_wgmma<kDx>, Shape<kDx>::kSmem,
                             &opted_in))
    return err;
  const long long n_tiles = static_cast<long long>(E) * n_m * n_n;
  if (n_tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(n_tiles < n_sms() ? n_tiles : n_sms());
  gmm_bwd_wgmma<kDx><<<grid, kThreads, Shape<kDx>::kSmem, stream>>>(
      amap, bmap, omap, n_m, n_n, nk, static_cast<int>(n_tiles));
  return static_cast<int>(cudaGetLastError());
}

int launch(const void* x, const void* w, const void* dy, void* dx, void* dw,
           int E, int C, int D, int F, cudaStream_t stream) {
  CUtensorMap amap, bmap, omap;
  const int n_m = (D + kBM - 1) / kBM;
  if (dx != nullptr) {
    if (!map_3d(&amap, w, F, D, E, kBM) ||
        !map_3d(&bmap, dy, F, C, E, kDxChunk) ||
        !map_3d(&omap, dx, D, C, E, kDxChunk))
      return static_cast<int>(cudaErrorInvalidValue);
    if (const int err = launch_product<true>(
            amap, bmap, omap, E, n_m, (C + kDxBN - 1) / kDxBN,
            (F + kBK - 1) / kBK, stream))
      return err;
  }
  if (dw != nullptr) {
    if (!map_3d(&amap, x, D, C, E, 64) || !map_3d(&bmap, dy, F, C, E, 64) ||
        !map_3d(&omap, dw, F, D, E, 64))
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_product<false>(amap, bmap, omap, E, n_m,
                                 (F + kDwBN - 1) / kDwBN,
                                 (C + kBK - 1) / kBK, stream);
  }
  return 0;
}

}  // namespace wg

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

// dx and dw on the 128 x 128 block kernels: gemm for f32, gemm_bf16 for
// bf16
template <typename T>
int launch_blocked(const void* x, const void* w, const void* dy, void* dx,
                   void* dw, int E, int C, int D, int F, cudaStream_t s) {
  if (E > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const long long CD = static_cast<long long>(C) * D,
                  CF = static_cast<long long>(C) * F,
                  DF = static_cast<long long>(D) * F;
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

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// the arguments every entry takes: positive sizes, D and F multiples of
// 16 (bf16 moves 16-byte vectors along them)
bool shape_ok(int E, int C, int D, int F) {
  return E >= 1 && C >= 1 && D >= 16 && D % 16 == 0 && F >= 16 &&
         F % 16 == 0;
}

}  // namespace

// x (E, C, D), w (E, D, F), dy (E, C, F) contiguous; dx (E, C, D) and dw
// (E, D, F) contiguous outputs in the same type, either may be null
extern "C" int gmm_bwd_f32(const void* x, const void* w, const void* dy,
                           void* dx, void* dw, int E, int C, int D, int F,
                           void* stream) {
  if (!shape_ok(E, C, D, F)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_blocked<float>(x, w, dy, dx, dw, E, C, D, F,
                               static_cast<cudaStream_t>(stream));
}

// the same in bf16 on the wgmma kernels; every pointer 16-byte aligned
extern "C" int gmm_bwd_bf16(const void* x, const void* w, const void* dy,
                            void* dx, void* dw, int E, int C, int D, int F,
                            void* stream) {
  if (!shape_ok(E, C, D, F) || !aligned16(x) || !aligned16(w) ||
      !aligned16(dy) || !aligned16(dx) || !aligned16(dw))
    return static_cast<int>(cudaErrorInvalidValue);
  return wg::launch(x, w, dy, dx, dw, E, C, D, F,
                    static_cast<cudaStream_t>(stream));
}

// the same on the earlier mma.sync kernel (gemm_bf16)
extern "C" int gmm_bwd_bf16_mma(const void* x, const void* w, const void* dy,
                                void* dx, void* dw, int E, int C, int D,
                                int F, void* stream) {
  if (!shape_ok(E, C, D, F) || !aligned16(x) || !aligned16(w) ||
      !aligned16(dy))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_blocked<__nv_bfloat16>(x, w, dy, dx, dw, E, C, D, F,
                                       static_cast<cudaStream_t>(stream));
}
