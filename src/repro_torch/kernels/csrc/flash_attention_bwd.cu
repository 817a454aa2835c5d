// Flash attention, the backward pass, for Hopper (sm_90a).
//
// Given q (B, Sq, H, D), k (B, Skv, KV, D), v (B, Skv, KV, Dv), the
// forward's output o (B, Sq, H, Dv) and log-sum-exp lse (B, H, Sq) f32,
// and the output's cotangent do, it computes
//
//   P  = exp(q k^T D^-1/2 - lse)         (masked: causal aligned at 0, Skv)
//   dv = P^T do                          summed over the G query heads of
//   dP = do v^T                          each kv head (GQA)
//   dS = P (dP - delta),  delta = rowsum(do o)
//   dq = dS k D^-1/2,     dk = dS^T q D^-1/2
//
// No TPU kernel is replaced: the reference trains through XLA's autodiff
// of its blockwise attention (src/repro/models/attention.py::
// blockwise_attention, rematerialised by jax.checkpoint), while the port's
// forward is the hand-written kernel of flash_attention.cu, whose launch
// autograd cannot see.  This is that kernel's backward
// (kernels/flash_attention.py::FlashAttention).
//
// Bound: operations.  The work is 2.5 times the forward's: five products
// of the same size (S, dP, dV, dK and dQ) against the forward's two.  At
// the training shape (B=4, S=1024, H=32, KV=4, D=128, bf16, causal) that
// is 2 * 5 * B * H * S (S + 1) / 2 * D = 86 GFLOP, 0.087 ms at 989 TFLOP/s;
// the bytes (q, k, v, o, do, lse read once, dq, dk, dv written once) are
// 0.13 GB, 0.04 ms at 3.35 TB/s.
//
// Design.  Two kernels after one delta pass (bwd_delta: one warp a
// (batch, position, head) row).  Both give a CTA of 8 warps one (batch,
// kv head) and 64 kv positions: K and V of the block stay in shared
// memory, dK and dV in f32 registers, while the CTA walks every query
// tile that sees the block (rows of the flattened (query position, head
// in group) index, as the forward's, so the G heads of the kv head sum
// in the same accumulators; causal: only tiles at or below the
// diagonal).  D and Dv are padded with zeros to kD.
//
// * flash_bwd_tc, bf16 with D and Dv multiples of 16 and 16-byte rows
//   (the training path).  What bounded the first kernel was shared
//   memory read 16 bits at a time for the transposed products, no
//   fragment reuse, ~143 M dq atomics a call and the causal tail.  Here:
//   - every fragment comes by ldmatrix, the transposed operands (dO and Q
//     for dV and dK, dS^T and K for dQ) by ldmatrix.trans; each A
//     fragment serves a warp's whole row of n8 tiles;
//   - S^T = K Q^T and dP^T = V dO^T are computed kv-major (a warp: 16 kv
//     rows x 32 query rows), so P^T and dS^T go to shared memory in the
//     layout dV += P^T dO and dK += dS^T Q read as A (16 kv rows x kD / 2
//     columns a warp);
//   - dQ = dS K (16 query rows x kD / 2 a warp) goes to an f32 tile in
//     shared memory in the 128-byte swizzle, and from there into an f32
//     (B, KV, Sq G, D) buffer (the tiles' row order; the wrapper permutes
//     and casts it) by TMA tensor reductions (cp.reduce.async.bulk.tensor
//     .add), one 32-column box a warp, issued at the next tile's first
//     barrier: no per-element atomics;
//   - Q, dO, lse and delta come by cp.async (4 threads a row, one
//     division a row) into the other of two stages while a tile runs, and
//     the dQ tile is double-buffered where shared memory allows (kD <=
//     128: 190 KB): two barriers a tile;
//   - CTAs are numbered kv-block-major, so the causal blocks that see the
//     most query tiles start first.
//   P and dS are rounded to bf16 (as the forward rounds P) and the
//   products accumulate in f32 (mma.sync m16n8k16).  What bounds it now
//   is latency: one CTA of 8 warps an SM (registers and shared memory
//   allow no second) through three dependent phases a tile, neither the
//   shared-memory reads nor mma.sync near their rates; loading Q and dO
//   by TMA instead of cp.async was tried and gained nothing.  wgmma (B
//   read from shared memory by the warpgroup, the accumulators
//   asynchronous) is the next step.
// * flash_bwd, every other input (f32, other widths or strides): the
//   first design, kept as it was.  Per tile S and dP (each warp 16 rows x
//   64 / kNS columns), P and dS into shared memory in the input type,
//   the transposed products read in place, dQ by f32 atomicAdd; products
//   by warp_tiles.cuh (mma.sync for bf16, FMAs for f32).  A query tile is
//   64 rows in bf16 and 32 in f32, so the f32 tiles of kD = 256 fit the
//   227 KB of shared memory.
//
// q, k, v, o and do are read in the model's (B, S, heads, D) layout with
// element strides for batch, position and head (the head dim contiguous);
// dk and dv are written contiguous, dq accumulated into a contiguous f32
// (B, Sq, H, D) buffer that the caller zeroes.  The C entry points return
// cudaGetLastError() after the launches, or cudaErrorInvalidValue for
// arguments they refuse.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "warp_tiles.cuh"

namespace {

using tiles::from_f32;
using tiles::Tile;
using tiles::to_f32;

constexpr int kThreads = 256;  // 8 warps
constexpr int kBc = 64;        // kv positions of a CTA

struct Strides {
  long long b, s, h;  // elements; the head dim is contiguous
};

template <typename T>
__global__ void __launch_bounds__(256)
bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
          float* __restrict__ delta, Strides os, Strides ds, int Sq, int H,
          int Dv, long long n_rows) {
  const long long row =
      static_cast<long long>(blockIdx.x) * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const int h = static_cast<int>(row % H);
  const long long bs = row / H;
  const int pos = static_cast<int>(bs % Sq);
  const int b = static_cast<int>(bs / Sq);
  const T* orow = o + b * os.b + pos * os.s + h * os.h;
  const T* drow = dout + b * ds.b + pos * ds.s + h * ds.h;
  float acc = 0.f;
  for (int d = lane; d < Dv; d += 32)
    acc = fmaf(to_f32(orow[d]), to_f32(drow[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[(static_cast<long long>(b) * H + h) * Sq + pos] = acc;
}

template <typename T, int kD, int kBr>
struct Layout {
  static constexpr int kPad = 16 / sizeof(T);  // 16 bytes a row
  static constexpr int kLd = kD + kPad;        // Q, dO, K and V tiles
  static constexpr int kLdp = kBc + kPad;      // P and dS tiles
  static constexpr size_t bytes =
      sizeof(T) * (2 * kBc * kLd + 2 * kBr * kLd + 2 * kBr * kLdp) +
      2 * kBr * sizeof(float);
};

template <typename T, int kD, int kBr>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          float* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
          Strides qs, Strides ks, Strides vs, Strides dos, int Sq, int Skv,
          int KV, int G, int D, int Dv, int causal, float scale) {
  using L = Layout<T, kD, kBr>;
  constexpr int kLd = L::kLd, kLdp = L::kLdp;
  constexpr int kMT = kBr / 16;         // m16 row tiles of a query tile
  constexpr int kNS = 8 / kMT;          // warps sharing one: column splits
  constexpr int kSF = kBc / 8 / kNS;    // n8 fragments of S a warp
  constexpr int kAF = kD / 16;          // of dK / dV (half the columns)
  constexpr int kQC = kD / kNS;         // dQ columns a warp
  constexpr int kQF = kQC >= 32 ? 4 : kQC / 8;  // n8 fragments a dQ chunk
  static_assert(kMT * kNS == 8 && kSF >= 1 && kQC % (8 * kQF) == 0,
                "tile shape");

  extern __shared__ __align__(16) uint8_t smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + kBc * kLd;
  T* Qs = Vs + kBc * kLd;
  T* dOs = Qs + kBr * kLd;
  T* Ps = dOs + kBr * kLd;
  T* dSs = Ps + kBr * kLdp;
  float* lse_s = reinterpret_cast<float*>(dSs + kBr * kLdp);
  float* delta_s = lse_s + kBr;

  const int tid = threadIdx.x, warp = tid >> 5;
  const int b = blockIdx.y / KV, kvh = blockIdx.y % KV;
  const int c0 = blockIdx.x * kBc;
  const int H = KV * G;
  const long long n_rows = static_cast<long long>(Sq) * G;
  const T zero = from_f32<T>(0.f);

  // the block's K and V, zeros past Skv and past D / Dv
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;
  for (int i = tid; i < kBc * kD; i += kThreads) {
    const int c = i / kD, d = i - c * kD;
    const int kp = c0 + c;
    Ks[c * kLd + d] = (kp < Skv && d < D) ? kb[kp * ks.s + d] : zero;
    Vs[c * kLd + d] = (kp < Skv && d < Dv) ? vb[kp * vs.s + d] : zero;
  }

  float dk_acc[kAF][4], dv_acc[kAF][4];
  tiles::zero(dk_acc);
  tiles::zero(dv_acc);
  const int am0 = 16 * (warp >> 1);         // this warp's dK / dV rows
  const int an0 = (warp & 1) * (kD / 2);    // and columns
  const int sm0 = 16 * (warp / kNS);        // its S / dP / dQ rows
  const int sn0 = (warp % kNS) * (8 * kSF);  // its S / dP columns
  const int qn0 = (warp % kNS) * kQC;       // its dQ columns

  // causal: rows p G + g with p < c0 see none of the block
  const int qt0 =
      causal ? static_cast<int>(static_cast<long long>(c0) * G / kBr) : 0;
  const int n_qt = static_cast<int>((n_rows + kBr - 1) / kBr);
  for (int qt = qt0; qt < n_qt; ++qt) {
    const long long r0 = static_cast<long long>(qt) * kBr;
    __syncthreads();  // the last tile's reads of Q, dO, P and dS are done
    for (int i = tid; i < kBr * kD; i += kThreads) {
      const int r = i / kD, d = i - r * kD;
      const long long R = r0 + r;
      T qv = zero, dov = zero;
      if (R < n_rows) {
        const int pos = static_cast<int>(R / G);
        const int h = kvh * G + static_cast<int>(R % G);
        if (d < D) qv = q[b * qs.b + pos * qs.s + h * qs.h + d];
        if (d < Dv) dov = dout[b * dos.b + pos * dos.s + h * dos.h + d];
      }
      Qs[r * kLd + d] = qv;
      dOs[r * kLd + d] = dov;
    }
    if (tid < kBr) {
      const long long R = r0 + tid;
      float l = INFINITY, dl = 0.f;  // a row past the end: P = 0
      if (R < n_rows) {
        const int pos = static_cast<int>(R / G);
        const int h = kvh * G + static_cast<int>(R % G);
        const long long at = (static_cast<long long>(b) * H + h) * Sq + pos;
        l = lse[at];
        dl = delta[at];
      }
      lse_s[tid] = l;
      delta_s[tid] = dl;
    }
    __syncthreads();

    // S = Q K^T and dP = dO V^T; P and dS into shared memory
    {
      float s[kSF][4], dp[kSF][4];
      tiles::zero(s);
      tiles::zero(dp);
      tiles::warp_gemm<kSF>(s, Tile<T>{Qs, kLd, 1}, Tile<T>{Ks, kLd, 1}, sm0,
                            sn0, kD);
      tiles::warp_gemm<kSF>(dp, Tile<T>{dOs, kLd, 1}, Tile<T>{Vs, kLd, 1},
                            sm0, sn0, kD);
#pragma unroll
      for (int f = 0; f < kSF; ++f)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int r = sm0 + tiles::frag_row(x);
          const int c = sn0 + tiles::frag_col(f, x);
          const long long R = r0 + r;
          const int kp = c0 + c;
          const bool ok = R < n_rows && kp < Skv &&
                          (!causal || kp <= static_cast<int>(R / G));
          const float p = ok ? expf(s[f][x] * scale - lse_s[r]) : 0.f;
          Ps[r * kLdp + c] = from_f32<T>(p);
          dSs[r * kLdp + c] = from_f32<T>(p * (dp[f][x] - delta_s[r]));
        }
    }
    __syncthreads();

    // dV += P^T dO, dK += dS^T Q: P, dS, dO and Q read transposed
    tiles::warp_gemm<kAF>(dv_acc, Tile<T>{Ps, 1, kLdp}, Tile<T>{dOs, 1, kLd},
                          am0, an0, kBr);
    tiles::warp_gemm<kAF>(dk_acc, Tile<T>{dSs, 1, kLdp}, Tile<T>{Qs, 1, kLd},
                          am0, an0, kBr);
    // dQ += dS K D^-1/2, in chunks of columns, into the f32 buffer
#pragma unroll 1
    for (int c = 0; c < kQC; c += 8 * kQF) {
      float acc[kQF][4];
      tiles::zero(acc);
      tiles::warp_gemm<kQF>(acc, Tile<T>{dSs, kLdp, 1}, Tile<T>{Ks, 1, kLd},
                            sm0, qn0 + c, kBc);
#pragma unroll
      for (int f = 0; f < kQF; ++f)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const long long R = r0 + sm0 + tiles::frag_row(x);
          const int d = qn0 + c + tiles::frag_col(f, x);
          if (R < n_rows && d < D) {
            const int pos = static_cast<int>(R / G);
            const int h = kvh * G + static_cast<int>(R % G);
            atomicAdd(dq + ((static_cast<long long>(b) * Sq + pos) * H + h) *
                               D + d,
                      acc[f][x] * scale);
          }
        }
    }
  }

  // dK D^-1/2 and dV of the block's kv positions
#pragma unroll
  for (int f = 0; f < kAF; ++f)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int kp = c0 + am0 + tiles::frag_row(x);
      const int d = an0 + tiles::frag_col(f, x);
      if (kp >= Skv) continue;
      const long long at = (static_cast<long long>(b) * Skv + kp) * KV + kvh;
      if (d < D) dk[at * D + d] = from_f32<T>(dk_acc[f][x] * scale);
      if (d < Dv) dv[at * Dv + d] = from_f32<T>(dv_acc[f][x]);
    }
}

template <typename T, int kD, int kBr>
int launch_kd(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const float* lse, float* delta, float* dq,
              void* dk, void* dv, int B, int Sq, int Skv, int H, int KV,
              int D, int Dv, int causal, const long long* st,
              cudaStream_t stream) {
  constexpr size_t bytes = Layout<T, kD, kBr>::bytes;
  static bool opted_in = false;  // opt in to the shared memory once
  if (!opted_in) {
    cudaFuncSetAttribute(flash_bwd<T, kD, kBr>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(bytes));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]},
      dos{st[12], st[13], st[14]};
  const long long rows = static_cast<long long>(B) * Sq * H;
  const long long delta_blocks = (rows + 7) / 8;
  if (delta_blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  bwd_delta<T><<<static_cast<unsigned>(delta_blocks), 256, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, os, dos,
      Sq, H, Dv, rows);
  const dim3 grid(static_cast<unsigned>((Skv + kBc - 1) / kBc),
                  static_cast<unsigned>(B * KV));
  flash_bwd<T, kD, kBr><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, dq,
      static_cast<T*>(dk), static_cast<T*>(dv), qs, ks, vs, dos, Sq, Skv, KV,
      H / KV, D, Dv, causal, 1.f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kBr>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, float* dq,
           void* dk, void* dv, int B, int Sq, int Skv, int H, int KV, int D,
           int Dv, int causal, const long long* st, void* stream) {
  if (D < 1 || D > 256 || Dv < 1 || Dv > 256 || KV < 1 || H % KV != 0 ||
      B < 1 || Sq < 1 || Skv < 1 || B * KV > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int w = D > Dv ? D : Dv;
  if (w <= 64)
    return launch_kd<T, 64, kBr>(q, k, v, o, dout, lse, delta, dq, dk, dv, B,
                                 Sq, Skv, H, KV, D, Dv, causal, st, s);
  if (w <= 128)
    return launch_kd<T, 128, kBr>(q, k, v, o, dout, lse, delta, dq, dk, dv, B,
                                  Sq, Skv, H, KV, D, Dv, causal, st, s);
  return launch_kd<T, 256, kBr>(q, k, v, o, dout, lse, delta, dq, dk, dv, B,
                                Sq, Skv, H, KV, D, Dv, causal, st, s);
}

// --------------------------------------------------------------------------
// bf16 on the tensor cores (flash_bwd_tc)

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kBr = 64;  // query rows (flattened (position, head in group)) a tile
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory, in bytes from a 1024-byte aligned base (the period of
// the 128-byte swizzle): K and V of the block; P^T and dS^T (kv-major,
// bf16); kDQ_n f32 dQ tiles, each kD / 32 boxes of 64 rows x 128 bytes in
// the 128-byte swizzle that the tensor reductions read; kStages tiles of
// Q, dO, lse and delta.  Two of each where they fit (kD <= 128: 190 KB),
// else two dQ tiles and one stage (kD 192) or one of each (kD 256).  bf16
// rows padded by 16 bytes, so the 8 rows an ldmatrix reads fall on
// distinct banks.
template <int kD>
struct Smem {
  static constexpr int kLd = kD + 8;    // bf16 rows of K, V, Q, dO
  static constexpr int kLdp = kBr + 8;  // bf16 rows of P^T, dS^T
  static constexpr int kTile = kBc * kLd * 2;
  static constexpr int kDQTile = kBr * kD * 4;  // kD / 32 boxes of 8 KB
  static constexpr int kBase = 2 * kTile + 2 * kBc * kLdp * 2;
  static constexpr int kPerStage = 2 * kBr * kLd * 2 + 2 * kBr * 4;
  static constexpr int kLimit = 232448 - 1024;  // the alignment's slack
  static constexpr int kDQ_n =
      kBase + 2 * kDQTile + kPerStage <= kLimit ? 2 : 1;
  static constexpr int kStages =
      kBase + kDQ_n * kDQTile + 2 * kPerStage <= kLimit ? 2 : 1;
  static constexpr int kK = 0, kV = kTile;
  static constexpr int kP = 2 * kTile, kDS = kP + kBc * kLdp * 2;
  static constexpr int kDQ = kDS + kBc * kLdp * 2;  // + i * kDQTile
  static constexpr int kQ = kDQ + kDQ_n * kDQTile;  // + stage * kPerStage
  static constexpr int kDO = kQ + kBr * kLd * 2;
  static constexpr int kLse = kDO + kBr * kLd * 2;
  static constexpr int kDelta = kLse + kBr * 4;
  static constexpr int bytes = kQ + kStages * kPerStage + 1024;
  static_assert(kDQ % 1024 == 0 && kDQTile % 1024 == 0 && kD <= 256,
                "swizzle period; a box a warp");
  static_assert(bytes <= 232448, "shared memory");
};

// 4-byte asynchronous copy global -> shared; zeros when !pred
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

// make this thread's generic-proxy writes to shared memory visible to the
// bulk copies issued after the next barrier
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// global box += one box of shared memory (the map's f32 type and 128-byte
// swizzle), a 3-d tensor reduction in this thread's bulk group; elements
// past the tensor's edges are dropped
__device__ __forceinline__ void tma_add_3d(const CUtensorMap* map,
                                           uint32_t src, int c0, int c1,
                                           int c2) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.3d.global.shared::cta.add.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wait until all but the newest N of this thread's bulk reductions have
// read their shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_tc(const __grid_constant__ CUtensorMap dqmap,
             const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             bf16* __restrict__ dk,
             bf16* __restrict__ dv, Strides qs, Strides ks, Strides vs,
             Strides dos, int Sq, int Skv, int KV, int G, int D, int Dv,
             int causal, float scale, int pairs) {
  using L = Smem<kD>;
  constexpr int kLd = L::kLd, kLdp = L::kLdp;
  constexpr int kChunks = kD / 8;       // 16-byte pieces of a row
  constexpr int kHalf = kD / 2;         // dK / dV / dQ columns a warp
  constexpr int kNF = kHalf / 8;        // its n8 fragments of dK and dV
  constexpr int kQC =  // dQ columns at a time
      kHalf <= 64 ? kHalf : (kHalf % 64 == 0 ? 64 : 48);
  static_assert(kNF % 2 == 0 && kHalf % kQC == 0, "tile shape");

  extern __shared__ __align__(128) uint8_t smem_all[];
  const uint32_t sb = (hopper::smem_u32(smem_all) + 1023u) & ~1023u;
  uint8_t* smem_raw = smem_all + (sb - hopper::smem_u32(smem_all));
  const float* lse_s0 = reinterpret_cast<const float*>(smem_raw + L::kLse);
  const float* delta_s0 =
      reinterpret_cast<const float*>(smem_raw + L::kDelta);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int lq = lane >> 3, lr = lane & 7;  // ldmatrix: matrix, row in it
  // the longest kv blocks (causal: the first) come first
  const int j = blockIdx.x / pairs, pair = blockIdx.x - j * pairs;
  const int b = pair / KV, kvh = pair - b * KV;
  const int c0 = j * kBc;
  const int H = KV * G;
  const int n_rows = Sq * G;  // the launch checks that it fits

  // the block's K and V, zeros past Skv and past D / Dv
  {
    const bf16* kb = k + b * ks.b + kvh * ks.h;
    const bf16* vb = v + b * vs.b + kvh * vs.h;
    for (int i = tid; i < kBc * kChunks; i += kThreads) {
      const int c = i / kChunks, d = (i - c * kChunks) * 8;
      const int kp = c0 + c;
      const bool okk = kp < Skv && d < D, okv = kp < Skv && d < Dv;
      const uint32_t at = (c * kLd + d) * 2;
      hopper::cp_async16(sb + L::kK + at, okk ? kb + kp * ks.s + d : k, okk);
      hopper::cp_async16(sb + L::kV + at, okv ? vb + kp * vs.s + d : v, okv);
    }
    hopper::cp_async_commit();
  }

  // query tile qt's Q, dO, lse and delta into stage st: 4 threads a row,
  // each taking every 4th 16-byte piece (a warp's copies cover 64
  // contiguous bytes of each of 8 rows)
  static_assert(kThreads == 4 * kBr && kChunks % 4 == 0, "row copies");
  auto load_tile = [&](int st, int qt) {
    const uint32_t base = sb + st * L::kPerStage;
    const int r = tid >> 2, t4 = tid & 3;
    const int R = qt * kBr + r;
    const bool in = R < n_rows;
    const int pos = in ? R / G : 0;
    const int h = in ? kvh * G + R - pos * G : 0;
    const bf16* qrow = q + b * qs.b + pos * qs.s + h * qs.h;
    const bf16* drow = dout + b * dos.b + pos * dos.s + h * dos.h;
#pragma unroll
    for (int j = 0; j < kChunks / 4; ++j) {
      const int d = (4 * j + t4) * 8;
      const bool okq = in && d < D, okd = in && d < Dv;
      const uint32_t at = (r * kLd + d) * 2;
      hopper::cp_async16(base + L::kQ + at, okq ? qrow + d : q, okq);
      hopper::cp_async16(base + L::kDO + at, okd ? drow + d : dout, okd);
    }
    if (t4 == 0) {
      const long long at =
          in ? (static_cast<long long>(b) * H + h) * Sq + pos : 0;
      cp_async4(base + L::kLse + r * 4, lse + at, in);
      cp_async4(base + L::kDelta + r * 4, delta + at, in);
    }
    hopper::cp_async_commit();
  };

  const int mi = warp & 3;   // 16-row slice: kv rows (phases 1, 2), q (3)
  const int hi = warp >> 2;  // half: q columns (phase 1), d columns (2, 3)
  float dk_acc[kNF][4], dv_acc[kNF][4];
  tiles::zero(dk_acc);
  tiles::zero(dv_acc);
  const float scale_log2 = scale * kLog2e;

  // causal: rows p G + g with p < c0 see none of the block
  const int qt0 = causal ? c0 * G / kBr : 0;
  const int n_qt = (n_rows + kBr - 1) / kBr;
  // box `warp` (columns 32 warp ..) of tile qt's dQ into the f32 buffer
  // (B KV, Sq G, D), one reduction a warp with a box (lane 0 issues it);
  // rows past Sq G are dropped
  const bool boxer = lane == 0 && warp * 32 < D;
  auto reduce_dq = [&](int qt) {
    tma_add_3d(&dqmap,
               sb + L::kDQ + ((qt - qt0) % L::kDQ_n) * L::kDQTile +
                   warp * (kBr * 128),
               warp * 32, qt * kBr, pair);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  };

  if (L::kStages == 2 && qt0 < n_qt) load_tile(0, qt0);
  for (int qt = qt0; qt < n_qt; ++qt) {
    const int st = L::kStages == 2 ? (qt - qt0) & 1 : 0;
    if (L::kStages == 2) {
      hopper::cp_async_wait<0>();  // this tile's copies (and K, V)
      __syncthreads();  // ... everyone's; the last tile is done with all
      // the other stage was last read in the last tile
      if (qt + 1 < n_qt) load_tile(st ^ 1, qt + 1);
    } else {
      __syncthreads();  // the last tile is done with Q and dO
      load_tile(0, qt);
      hopper::cp_async_wait<0>();
      __syncthreads();
    }
    // the last tile's dQ out (its warps wrote and fenced it before the
    // barrier); this tile's dQ tile free once the reductions that last
    // read it have
    if (boxer) {
      if (qt > qt0) reduce_dq(qt - 1);
      bulk_wait_read<L::kDQ_n - 1>();
    }
    const uint32_t sQ = sb + st * L::kPerStage + L::kQ;
    const uint32_t sDO = sb + st * L::kPerStage + L::kDO;
    const float* lse_s = lse_s0 + st * L::kPerStage / 4;
    const float* delta_s = delta_s0 + st * L::kPerStage / 4;
    const int r0 = qt * kBr;

    // phase 1: S^T = K Q^T and dP^T = V dO^T, 16 kv rows x 32 q columns
    // a warp; P^T and dS^T into shared memory as bf16
    {
      const int m0 = 16 * mi, n0 = 32 * hi;
      float s[4][4], dp[4][4];
      tiles::zero(s);
      tiles::zero(dp);
      const uint32_t a_off = ((m0 + lr + (lq & 1) * 8) * kLd + (lq >> 1) * 8) * 2;
      const uint32_t b_off = ((n0 + lr + (lq >> 1) * 8) * kLd + (lq & 1) * 8) * 2;
#pragma unroll
      for (int k0 = 0; k0 < kD; k0 += 16) {  // zeros past D
        uint32_t a[4], b0[4], b1[4];
        hopper::ldmatrix_x4(a, sb + L::kK + a_off + k0 * 2);
        hopper::ldmatrix_x4(b0, sQ + b_off + k0 * 2);
        hopper::ldmatrix_x4(b1, sQ + b_off + (16 * kLd + k0) * 2);
        hopper::mma_bf16(s[0], a, b0[0], b0[1]);
        hopper::mma_bf16(s[1], a, b0[2], b0[3]);
        hopper::mma_bf16(s[2], a, b1[0], b1[1]);
        hopper::mma_bf16(s[3], a, b1[2], b1[3]);
      }
#pragma unroll
      for (int k0 = 0; k0 < kD; k0 += 16) {  // zeros past Dv
        uint32_t a[4], b0[4], b1[4];
        hopper::ldmatrix_x4(a, sb + L::kV + a_off + k0 * 2);
        hopper::ldmatrix_x4(b0, sDO + b_off + k0 * 2);
        hopper::ldmatrix_x4(b1, sDO + b_off + (16 * kLd + k0) * 2);
        hopper::mma_bf16(dp[0], a, b0[0], b0[1]);
        hopper::mma_bf16(dp[1], a, b0[2], b0[3]);
        hopper::mma_bf16(dp[2], a, b1[0], b1[1]);
        hopper::mma_bf16(dp[3], a, b1[2], b1[3]);
      }
      bf16* Ps = reinterpret_cast<bf16*>(smem_raw + L::kP);
      bf16* dSs = reinterpret_cast<bf16*>(smem_raw + L::kDS);
#pragma unroll
      for (int f = 0; f < 4; ++f)
#pragma unroll
        for (int e = 0; e < 2; ++e) {  // q column 2 t + e of fragment f
          const int r = n0 + tiles::frag_col(f, e);
          const int R = r0 + r;
          const float ls = lse_s[r] * kLog2e, dl = delta_s[r];
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {  // kv rows g, g + 8
            const int x = 2 * hr + e;
            const int kp = c0 + m0 + tiles::frag_row(x);
            // select before the exp: a row past the end reads lse = 0
            const bool ok =  // kp <= R / G without the division
                R < n_rows && kp < Skv && (!causal || kp * G <= R);
            const float p =
                ok ? hopper::ex2(fmaf(s[f][x], scale_log2, -ls)) : 0.f;
            s[f][x] = p;
            dp[f][x] = p * (dp[f][x] - dl);
          }
        }
#pragma unroll
      for (int f = 0; f < 4; ++f)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int c = m0 + tiles::frag_row(2 * hr);
          const int r = n0 + tiles::frag_col(f, 0);
          *reinterpret_cast<uint32_t*>(Ps + c * kLdp + r) =
              hopper::pack_bf16(s[f][2 * hr], s[f][2 * hr + 1]);
          *reinterpret_cast<uint32_t*>(dSs + c * kLdp + r) =
              hopper::pack_bf16(dp[f][2 * hr], dp[f][2 * hr + 1]);
        }
    }
    __syncthreads();

    // phase 2: dV += P^T dO and dK += dS^T Q, 16 kv rows x kD / 2 columns
    // a warp; dO and Q read transposed by ldmatrix.trans
    {
      const int m0 = 16 * mi, nb = hi * kHalf;
      const uint32_t a_off = ((m0 + lr + (lq & 1) * 8) * kLdp + (lq >> 1) * 8) * 2;
      const uint32_t b_off = ((lr + (lq & 1) * 8) * kLd + nb + (lq >> 1) * 8) * 2;
      const bool any_v = nb < Dv, any_k = nb < D;
#pragma unroll
      for (int k0 = 0; k0 < kBr; k0 += 16) {
        uint32_t ap[4], as[4];
        hopper::ldmatrix_x4(ap, sb + L::kP + a_off + k0 * 2);
        hopper::ldmatrix_x4(as, sb + L::kDS + a_off + k0 * 2);
#pragma unroll
        for (int f = 0; f < kNF; f += 2) {
          const uint32_t off = b_off + (k0 * kLd + 8 * f) * 2;
          if (any_v && nb + 8 * f < Dv) {
            uint32_t bo[4];
            hopper::ldmatrix_x4_trans(bo, sDO + off);
            hopper::mma_bf16(dv_acc[f], ap, bo[0], bo[1]);
            hopper::mma_bf16(dv_acc[f + 1], ap, bo[2], bo[3]);
          }
          if (any_k && nb + 8 * f < D) {
            uint32_t bq[4];
            hopper::ldmatrix_x4_trans(bq, sQ + off);
            hopper::mma_bf16(dk_acc[f], as, bq[0], bq[1]);
            hopper::mma_bf16(dk_acc[f + 1], as, bq[2], bq[3]);
          }
        }
      }
    }
    // phase 3: dQ = dS K D^-1/2, 16 q rows x kD / 2 columns a warp, into
    // this tile's f32 dQ tile; dS^T and K read transposed
    {
      float* stage = reinterpret_cast<float*>(
          smem_raw + L::kDQ + ((qt - qt0) % L::kDQ_n) * L::kDQTile);
      const int m0 = 16 * mi;
      const uint32_t a_off = ((lr + (lq >> 1) * 8) * kLdp + m0 + (lq & 1) * 8) * 2;
#pragma unroll 1
      for (int cc = 0; cc < kHalf; cc += kQC) {
        const int nb = hi * kHalf + cc;
        if (nb >= D) break;
        float acc[kQC / 8][4];
        tiles::zero(acc);
        const uint32_t b_off = ((lr + (lq & 1) * 8) * kLd + nb + (lq >> 1) * 8) * 2;
#pragma unroll
        for (int k0 = 0; k0 < kBc; k0 += 16) {
          uint32_t a[4];
          hopper::ldmatrix_x4_trans(a, sb + L::kDS + a_off + k0 * kLdp * 2);
#pragma unroll
          for (int f = 0; f < kQC / 8; f += 2) {
            uint32_t bk[4];
            hopper::ldmatrix_x4_trans(bk, sb + L::kK + b_off + (k0 * kLd + 8 * f) * 2);
            hopper::mma_bf16(acc[f], a, bk[0], bk[1]);
            hopper::mma_bf16(acc[f + 1], a, bk[2], bk[3]);
          }
        }
#pragma unroll
        for (int f = 0; f < kQC / 8; ++f)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            // box d / 32, row r, its 16-byte piece swizzled by r % 8
            const int r = m0 + tiles::frag_row(2 * hr);
            const int d = nb + tiles::frag_col(f, 0);
            const int at = (d >> 5) * (kBr * 32) + r * 32 +
                           ((((d & 31) >> 2) ^ (r & 7)) << 2) + (d & 3);
            *reinterpret_cast<float2*>(stage + at) =
                make_float2(acc[f][2 * hr] * scale, acc[f][2 * hr + 1] * scale);
          }
      }
    }
    fence_async_shared();  // for the bulk reductions after the barrier
  }
  __syncthreads();
  if (boxer) {
    if (n_qt > qt0) reduce_dq(n_qt - 1);
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
  hopper::cp_async_wait<0>();

  // dK D^-1/2 and dV of the block's kv positions, bf16 pairs
  const int nb = hi * kHalf;
#pragma unroll
  for (int f = 0; f < kNF; ++f)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int kp = c0 + 16 * mi + tiles::frag_row(2 * hr);
      const int d = nb + tiles::frag_col(f, 0);
      if (kp >= Skv) continue;
      const long long at = (static_cast<long long>(b) * Skv + kp) * KV + kvh;
      if (d < D)
        *reinterpret_cast<uint32_t*>(dk + at * D + d) = hopper::pack_bf16(
            dk_acc[f][2 * hr] * scale, dk_acc[f][2 * hr + 1] * scale);
      if (d < Dv)
        *reinterpret_cast<uint32_t*>(dv + at * Dv + d) =
            hopper::pack_bf16(dv_acc[f][2 * hr], dv_acc[f][2 * hr + 1]);
    }
}

// the tensor map of the f32 dq buffer (pairs, rows, D): boxes of 32
// columns x 64 rows x 1, 128-byte swizzle, nothing written past the edges
bool dq_map(CUtensorMap* map, float* dq, int D, long long rows, int pairs) {
  const hopper::EncodeTiled encode = hopper::encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(pairs)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 4,
                                 static_cast<cuuint64_t>(rows) * D * 4};
  const cuuint32_t box[3] = {32, kBr, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, dq, dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kD>
int launch_kd(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const float* lse, float* delta, float* dq,
              void* dk, void* dv, int B, int Sq, int Skv, int H, int KV,
              int D, int Dv, int causal, const long long* st,
              cudaStream_t stream) {
  constexpr int bytes = Smem<kD>::bytes;
  CUtensorMap dqmap;
  if (!dq_map(&dqmap, dq, D, static_cast<long long>(Sq) * (H / KV), B * KV))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool opted_in = false;  // opt in to the shared memory once
  if (!opted_in) {
    cudaFuncSetAttribute(flash_bwd_tc<kD>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]},
      dos{st[12], st[13], st[14]};
  const long long rows = static_cast<long long>(B) * Sq * H;
  const long long delta_blocks = (rows + 7) / 8;
  const long long ctas = static_cast<long long>((Skv + kBc - 1) / kBc) * B * KV;
  if (delta_blocks > 0x7fffffffLL || ctas > 0x7fffffffLL ||
      static_cast<long long>(Sq) * (H / KV) > 0x7fffffffLL - kBr)
    return static_cast<int>(cudaErrorInvalidValue);
  bwd_delta<bf16><<<static_cast<unsigned>(delta_blocks), 256, 0, stream>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), delta, os,
      dos, Sq, H, Dv, rows);
  flash_bwd_tc<kD><<<static_cast<unsigned>(ctas), kThreads, bytes, stream>>>(
      dqmap, static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), qs, ks, vs, dos, Sq,
      Skv, KV, H / KV, D, Dv, causal, 1.f / sqrtf(static_cast<float>(D)),
      B * KV);
  return static_cast<int>(cudaGetLastError());
}

// the pointers and strides that 16-byte copies need
bool aligned(const void* q, const void* k, const void* v, const void* dout,
             const long long* st) {
  const void* ptrs[4] = {q, k, v, dout};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  for (int i = 0; i < 15; ++i)  // o's (9-11) are read by bwd_delta alone
    if ((i < 9 || i > 11) && (st[i] <= 0 || st[i] % 8)) return false;
  return true;
}

int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, float* dq,
           void* dk, void* dv, int B, int Sq, int Skv, int H, int KV, int D,
           int Dv, int causal, const long long* st, void* stream) {
  if (D < 16 || D > 256 || D % 16 || Dv < 16 || Dv > 256 || Dv % 16 ||
      KV < 1 || H % KV != 0 || B < 1 || Sq < 1 || Skv < 1 ||
      !aligned(q, k, v, dout, st) ||
      reinterpret_cast<uintptr_t>(dq) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int w = D > Dv ? D : Dv;
  if (w <= 64)
    return launch_kd<64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Skv,
                         H, KV, D, Dv, causal, st, s);
  if (w <= 128)
    return launch_kd<128>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq,
                          Skv, H, KV, D, Dv, causal, st, s);
  if (w <= 192)
    return launch_kd<192>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq,
                          Skv, H, KV, D, Dv, causal, st, s);
  return launch_kd<256>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Skv,
                        H, KV, D, Dv, causal, st, s);
}

}  // namespace tc

}  // namespace

// strides: 15 element strides, (batch, position, head) of q, k, v, o and
// do; lse and delta (B, H, Sq) f32 (delta is scratch the call fills); dq
// (B, Sq, H, D) f32, zeroed by the caller; dk (B, Skv, KV, D) and dv (B,
// Skv, KV, Dv) contiguous, in the input type
extern "C" int flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, float* dq, void* dk,
    void* dv, int B, int Sq, int Skv, int H, int KV, int D, int Dv,
    int causal, const long long* strides, void* stream) {
  return launch<float, 32>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq,
                           Skv, H, KV, D, Dv, causal, strides, stream);
}

extern "C" int flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, float* dq, void* dk,
    void* dv, int B, int Sq, int Skv, int H, int KV, int D, int Dv,
    int causal, const long long* strides, void* stream) {
  return launch<__nv_bfloat16, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                   B, Sq, Skv, H, KV, D, Dv, causal, strides,
                                   stream);
}

// the tensor-core kernel: bf16 with D and Dv multiples of 16, the
// batch, position and head strides of q, k, v and do positive multiples
// of 8 and those four pointers and dq 16-byte aligned (else
// cudaErrorInvalidValue); the same arguments as above, but dq is summed
// into a contiguous f32 (B, KV, Sq, G, D) buffer (the kernel's row
// order), zeroed by the caller
extern "C" int flash_attention_bwd_bf16_tc(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, float* dq, void* dk,
    void* dv, int B, int Sq, int Skv, int H, int KV, int D, int Dv,
    int causal, const long long* strides, void* stream) {
  return tc::launch(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Skv, H,
                    KV, D, Dv, causal, strides, stream);
}
