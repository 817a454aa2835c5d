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
// Design (a first, simple one; wgmma and TMA are later work):
//
// * bwd_delta: one warp a (batch, position, head) row computes delta.
// * flash_bwd: a CTA of 8 warps owns one (batch, kv head) and 64 kv
//   positions; K and V of the block stay in shared memory, and dK and dV
//   in f32 registers (each warp 16 kv rows x half the columns) while the
//   CTA walks every query tile that sees the block: kBr rows of the
//   flattened (query position, head in group) index, as the forward's
//   rows, so the G heads of the kv head are summed in the same
//   accumulators, and for causal inputs only tiles at or below the
//   diagonal.  Per tile: Q and dO into shared memory; S and dP (each warp
//   16 rows x 64 / kNS columns) and from them P and dS into shared memory
//   in the input type; dV += P^T dO and dK += dS^T Q read those tiles
//   transposed in place; dQ = dS K goes to an f32 buffer with atomicAdd
//   (the wrapper casts it).  The products are warp_tiles.cuh's: bf16 on the
//   tensor cores (mma.sync m16n8k16, f32 accumulation, P and dS rounded to
//   bf16 as the forward rounds P), f32 on FMAs (P and dS unrounded).
//   D and Dv are padded with zeros to kD (64, 128 or 256).  A query tile
//   is 64 rows in bf16 and 32 in f32, so the f32 tiles of kD = 256 fit
//   the 227 KB of shared memory.
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
