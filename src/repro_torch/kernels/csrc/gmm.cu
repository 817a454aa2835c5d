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
// balanced, so it needs the tensor cores' rate and streaming at once.  At
// the decode shape (C = 4) it is bound by the 403 MB of weights alone:
// 0.120 ms.
//
// Which inputs take which kernel is the Python wrapper's choice
// (kernels/gmm.py::_variant); each has its own C entry:
//
// * gmm_bf16, the wgmma kernels (every bf16 input; D and F multiples of
//   16, bases 16-byte aligned, as TMA needs).  Persistent: one CTA per
//   SM walks the output tiles expert by expert, and within an expert one
//   column tile's row tiles one after another, so a w tile comes from
//   DRAM once and is reused from L2 (an expert's w is 3.1 MB and its x
//   2.6 MB at the prefill shape; ~4 experts are in flight across the
//   CTAs, well inside the 50 MB L2).  A CTA is one producer warpgroup
//   and two consumer warpgroups; setmaxnreg moves registers from the
//   producer to the consumers.  One producer thread fills a ring of
//   stages in shared memory by TMA (cp.async.bulk.tensor, 128-byte
//   swizzle, tensor maps built on the host and passed as
//   __grid_constant__ parameters) with an mbarrier pair per stage: "full",
//   which the copy completes, and "empty", on which each consumer warp
//   arrives when its wgmmas have read the stage.  The maps are 3-d, (E,
//   C, D), (E, D, F) and (E, C, F), so a tile's rows past C are zeros on
//   loads and never read the next expert's rows, and nothing past C or F
//   is written on stores: C need not be a multiple of the tile (C = 624
//   ends each expert on a 112-row tile).
//   - C > 16 (prefill): output tiles of 128 x 256; a stage holds 64 of
//     D of x (128 rows, K-major) and of w (256 columns, N-major, read by
//     wgmma with the descriptor's transpose-B bit: no copy).  Each
//     consumer warpgroup runs wgmma m64n256k16 on its 64 rows with f32
//     accumulators in registers, one stage's group in flight behind the
//     next.  The epilogue writes the tile in bf16 into a staging buffer
//     in the 128-byte swizzled layout, and another producer thread
//     stores it by TMA while the consumers go on with the next tile.
//   - C <= 16 (decode): a 64-row tile of x would be 75-98 % padding, so
//     the operands swap: w is wgmma's A operand (64 columns of F per
//     warpgroup as M, read MN-major with the transpose-A bit) and x its B
//     operand (C padded to N = 16 by the loads' zero fill).  An output
//     tile is (expert, 128 columns of F) over all of D; a stage is 16 KB
//     of w and 2 KB of x, and the ring is deep, so the weights stream at
//     the card's rate.  The (F, C) accumulator is written straight to
//     out[e, c, f] for c < C (a few KB a tile).
//   Every wgmma sits on the warpgroup's uniform path (ptxas serialises
//   them all when one sits under a branch), and a wait that sees no
//   progress for ~2^34 cycles traps instead of holding the card.  The
//   Hopper helpers come from hopper.cuh.
// * gmm_f32, the FMA kernel (every f32 input): 64 x 64 tiles of f32 FMAs,
//   4 x 4 outputs per thread, staged by 16-byte cp.async copies three
//   slabs deep, summed in order over D; TF32 tensor-core tiles would
//   break the 2e-5 tolerance.
//
// The C entry points return cudaGetLastError() after the launch (or
// cudaErrorInvalidValue for shapes they do not take); the Python wrapper
// raises on a non-zero code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBKf = 16;     // depth of an f32 slab
constexpr int kStages = 3;   // f32 slabs in flight

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
    cp_async16(smem_u32(dst + r * LDS + c), s, ok);
  }
}

// ---------------------------------------------------------------------
// bf16: wgmma kernels
namespace wg {

constexpr int kThreads = 384;  // two consumer warpgroups, then the producer
constexpr int kProducerRegs = 40;   // 128 x (40 + 2 x 232) <= 65536
constexpr int kConsumerRegs = 232;
constexpr int kBM = 128;      // rows of a prefill output tile, 64 a warpgroup
constexpr int kBK = 64;       // depth of a stage: one 128-byte row of bf16
constexpr int kBlock = 64 * 128;  // bytes of 64 rows of one 128-byte row
constexpr int kSwapN = 16;    // x rows of a decode stage (wgmma's N)
constexpr int kSwapF = 128;   // columns of F of a decode output tile

// m64n256k16: A (x) K-major, B (w) MN-major (transpose bit set)
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t a,
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
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
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

// m64n16k16: A (w) MN-major (transpose bit set), B (x) K-major
__device__ __forceinline__ void wgmma_n16_ta(float (&d)[8], uint64_t a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(scale_d));
}

// Prefill: output tiles of 128 x kBN through a ring of kRing stages
// beside a staging buffer for the output (128 x 128 tiles with deeper
// rings, and writing the output straight from the registers, ran slower
// on the H100 at the prefill shape).  Tile t of the schedule: expert e,
// then column tile, then row tile.
constexpr int kBN = 256;
constexpr int kRing = 3;
constexpr int kNB = kBN / 64;                       // 64-column blocks
constexpr int kABytes = kBM * 128;                  // x: 128 rows, 16 KB
constexpr int kStageBytes = kABytes + kNB * kBlock;  // 48 KB
constexpr int kOutHalf = kNB * kBlock;              // 64 rows of out, 32 KB
constexpr size_t kPrefillSmem = static_cast<size_t>(kRing) * kStageBytes +
                                2 * kOutHalf + 8 * (2 * kRing + 4) + 1024;

__global__ void __launch_bounds__(kThreads, 1)
gmm_wgmma(const __grid_constant__ CUtensorMap xmap,
          const __grid_constant__ CUtensorMap wmap,
          const __grid_constant__ CUtensorMap omap, int n_row, int n_col,
          int nk, int n_tiles) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sout = ring + kRing * kStageBytes;
  // full[s] at bars + 8 s, empty[s] at bars + 8 (kRing + s); for the
  // out half h of warpgroup h: ofull[h] (written) and oempty[h] (its
  // store has read it)
  const uint32_t bars = sout + 2 * kOutHalf;
  const uint32_t obars = bars + 16 * kRing;
  const int tid = threadIdx.x;
  const int per_expert = n_row * n_col;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kRing; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kRing + s), 8);  // the consumers' 8 warps
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
        const int n0 = (r / n_row) * kBN, m0 = (r % n_row) * kBM;
        for (int kt = 0; kt < nk; ++kt, ++g) {
          const int s = g % kRing;
          if (g >= kRing)
            mbar_wait(bars + 8 * (kRing + s), ((g / kRing) - 1) & 1);
          const uint32_t full = bars + 8 * s;
          const uint32_t dst = ring + s * kStageBytes;
          mbar_expect_tx(full, kStageBytes);
          tma_load_3d(dst, &xmap, full, kt * kBK, m0, e);
#pragma unroll
          for (int c = 0; c < kNB; ++c)
            tma_load_3d(dst + kABytes + c * kBlock, &wmap, full,
                        n0 + 64 * c, kt * kBK, e);
        }
      }
    } else if (tid == 288) {
      // another stores each tile's two halves once their warpgroups have
      // written them (nothing past C or F is written), and frees each
      // half when its store has read it.  (A TMA store on a consumer
      // warpgroup's path makes the compiler serialise the wgmmas.)
      int j = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++j) {
        const int e = t / per_expert, r = t - e * per_expert;
        const int n0 = (r / n_row) * kBN, m0 = (r % n_row) * kBM;
        for (int h = 0; h < 2; ++h) {
          mbar_wait(obars + 8 * h, j & 1);
#pragma unroll
          for (int c = 0; c < kNB; ++c)
            tma_store_3d(&omap, sout + h * kOutHalf + c * kBlock,
                         n0 + 64 * c, m0 + 64 * h, e);
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
  const int col0 = 2 * (lane & 3);
  float acc[kBN / 2];
  int g = 0, j = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++j) {
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt, ++g) {
      const int s = g % kRing;
      mbar_wait(bars + 8 * s, (g / kRing) & 1);
      const uint32_t a = ring + s * kStageBytes + wgi * 64 * 128;
      const uint32_t b = ring + s * kStageBytes + kABytes;
      pin(acc);
      wgmma_fence();
      // four k16 steps: A advances 32 bytes inside its swizzled row, B
      // 16 rows (2048 bytes); LBO steps between B's 64-column blocks
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_n256(acc, desc(a + kk * 32, 16, 1024),
                   desc(b + kk * 2048, kBlock, 1024), 1);
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's group is done
      pin(acc);
      if (kt > 0 && lane == 0)
        mbar_arrive(bars + 8 * (kRing + (g - 1) % kRing));
    }
    wgmma_wait<0>();
    pin(acc);
    if (lane == 0) mbar_arrive(bars + 8 * (kRing + (g - 1) % kRing));

    // Epilogue: the accumulator in bf16 into this warpgroup's half of the
    // staging buffer, once the last tile's store has read it, in the
    // 128-byte swizzled layout of the store's boxes; then each warp tells
    // the storing thread.
    if (j > 0) mbar_wait(obars + 8 * (2 + wgi), (j - 1) & 1);
    const uint32_t half = sout + wgi * kOutHalf;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = warp * 16 + lane / 4 + 8 * h;  // of the 64
      // the 16-byte chunk c of the row sits at chunk c ^ (row % 8): with
      // bits 4-6 of x set to row % 8, x ^ (c << 4) is its address
      const uint32_t x = half + row * 128 + ((row % 8) << 4) + col0 * 2;
#pragma unroll
      for (int n = 0; n < kBN / 8; ++n) {
        const int colb = 8 * n;
        st_shared((x + (colb / 64) * kBlock) ^ (((colb % 64) / 8) << 4),
                  pack_bf16(acc[4 * n + 2 * h], acc[4 * n + 2 * h + 1]));
      }
    }
    // the generic-proxy writes before the TMA store (async proxy) reads
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (lane == 0) mbar_arrive(obars + 8 * wgi);
  }
}

// Decode (C <= 16): w as A (MN-major), x as B, an output tile being
// (expert, kSwapF columns of F); tile t: expert t / n_col.
constexpr int kSwapWBytes = 2 * kBlock;             // 64 of D x 128 of F
constexpr int kSwapXBytes = kSwapN * 128;           // 16 rows x 64 of D
constexpr int kSwapStageBytes = kSwapWBytes + kSwapXBytes;
constexpr int kSwapStages = 8;  // 144 KB of weights and x in flight
constexpr size_t kSwapSmem =
    static_cast<size_t>(kSwapStages) * kSwapStageBytes + 16 * kSwapStages +
    1024;

__global__ void __launch_bounds__(kThreads, 1)
gmm_wgmma_swap(const __grid_constant__ CUtensorMap xmap,
               const __grid_constant__ CUtensorMap wmap,
               __nv_bfloat16* __restrict__ out, int C, int F, int n_col,
               int nk, int n_tiles) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = ring + kSwapStages * kSwapStageBytes;
  const int tid = threadIdx.x;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kSwapStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kSwapStages + s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (role == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == 256) {
      int g = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const int e = t / n_col, n0 = (t - e * n_col) * kSwapF;
        for (int kt = 0; kt < nk; ++kt, ++g) {
          const int s = g % kSwapStages;
          if (g >= kSwapStages)
            mbar_wait(bars + 8 * (kSwapStages + s),
                      ((g / kSwapStages) - 1) & 1);
          const uint32_t full = bars + 8 * s;
          const uint32_t dst = ring + s * kSwapStageBytes;
          mbar_expect_tx(full, kSwapStageBytes);
          tma_load_3d(dst, &wmap, full, n0, kt * kBK, e);
          tma_load_3d(dst + kBlock, &wmap, full, n0 + 64, kt * kBK, e);
          tma_load_3d(dst + kSwapWBytes, &xmap, full, kt * kBK, 0, e);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wgi = role, warp = (tid & 127) >> 5, lane = tid & 31;
  float acc[kSwapN / 2];
  int g = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int e = t / n_col, n0 = (t - e * n_col) * kSwapF;
#pragma unroll
    for (int i = 0; i < kSwapN / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt, ++g) {
      const int s = g % kSwapStages;
      mbar_wait(bars + 8 * s, (g / kSwapStages) & 1);
      const uint32_t a = ring + s * kSwapStageBytes + wgi * kBlock;
      const uint32_t b = ring + s * kSwapStageBytes + kSwapWBytes;
      pin(acc);
      wgmma_fence();
      // A (w) MN-major: a k16 step is 16 rows of D, 2048 bytes; B (x)
      // K-major: 32 bytes inside its swizzled row
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_n16_ta(acc, desc(a + kk * 2048, kBlock, 1024),
                     desc(b + kk * 32, 16, 1024), 1);
      wgmma_commit();
      wgmma_wait<1>();
      pin(acc);
      if (kt > 0 && lane == 0)
        mbar_arrive(bars + 8 * (kSwapStages + (g - 1) % kSwapStages));
    }
    wgmma_wait<0>();
    pin(acc);
    if (lane == 0)
      mbar_arrive(bars + 8 * (kSwapStages + (g - 1) % kSwapStages));
    // acc[4 n + 2 h + i]: F column f (the row of the product), C row c
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int f = n0 + wgi * 64 + warp * 16 + lane / 4 + 8 * h;
#pragma unroll
      for (int n = 0; n < kSwapN / 8; ++n)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int c = 8 * n + 2 * (lane & 3) + i;
          if (c < C && f < F)
            out[(static_cast<long long>(e) * C + c) * F + f] =
                __float2bfloat16(acc[4 * n + 2 * h + i]);
        }
    }
  }
}

int launch_prefill(const void* x, const void* w, void* out, int E, int C,
                   int D, int F, cudaStream_t stream) {
  static bool opted_in = false;
  if (const int err = opt_in(gmm_wgmma, kPrefillSmem, &opted_in)) return err;
  CUtensorMap xmap, wmap, omap;
  if (!map_3d(&xmap, x, D, C, E, kBM) || !map_3d(&wmap, w, F, D, E, 64) ||
      !map_3d(&omap, out, F, C, E, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_row = (C + kBM - 1) / kBM, n_col = (F + kBN - 1) / kBN;
  const long long n_tiles = static_cast<long long>(E) * n_row * n_col;
  if (n_tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(n_tiles < n_sms() ? n_tiles : n_sms());
  gmm_wgmma<<<grid, kThreads, kPrefillSmem, stream>>>(
      xmap, wmap, omap, n_row, n_col, (D + kBK - 1) / kBK,
      static_cast<int>(n_tiles));
  return static_cast<int>(cudaGetLastError());
}

int launch_decode(const void* x, const void* w, void* out, int E, int C,
                  int D, int F, cudaStream_t stream) {
  static bool opted_in = false;
  if (const int err = opt_in(gmm_wgmma_swap, kSwapSmem, &opted_in))
    return err;
  CUtensorMap xmap, wmap;
  if (!map_3d(&xmap, x, D, C, E, kSwapN) || !map_3d(&wmap, w, F, D, E, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_col = (F + kSwapF - 1) / kSwapF;
  const long long n_tiles = static_cast<long long>(E) * n_col;
  if (n_tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(n_tiles < n_sms() ? n_tiles : n_sms());
  gmm_wgmma_swap<<<grid, kThreads, kSwapSmem, stream>>>(
      xmap, wmap, static_cast<__nv_bfloat16*>(out), C, F, n_col,
      (D + kBK - 1) / kBK, static_cast<int>(n_tiles));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

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

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" int gmm_bf16(const void* x, const void* w, void* out, int E,
                        int C, int D, int F, void* stream) {
  if (E < 1 || C < 1 || D < 16 || D % 16 || F < 16 || F % 16 ||
      !aligned16(x) || !aligned16(w) || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C <= wg::kSwapN) return wg::launch_decode(x, w, out, E, C, D, F, s);
  return wg::launch_prefill(x, w, out, E, C, D, F, s);
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
