// Flash-decoding for Hopper (sm_90a): one query token per batch row
// against a KV cache, with a per-row valid length.
//
//   o[b, 0, h] = sum_{j < len[b]} softmax_j(q[b, 0, h] . k[b, j, h / G]
//                                           * D^-1/2) v[b, j, h / G]
//
// GQA-native (query head h reads kv head h / G).  Scores, probabilities
// and the accumulator are f32 whatever the input type (bf16 or f32); the
// output is written in the input type.  len[b] is clamped to [0, S]; a
// row with len[b] = 0 writes zeros.  Given an lse pointer, each row also
// gets lse[b, h] = log sum_{j < len[b]} exp(q . k_j * D^-1/2) in f32
// (-inf where len[b] = 0): what a combine of attentions over blocks of
// one cache weighs each block by (the tensor-parallel decode's, each
// model rank attending over its own block of rows).
//
// Replaces the Pallas kernel src/repro/kernels/decode_attention.py::
// decode_attention (body _kernel), which the model's decode step calls
// once per layer in place of the reference's XLA decode_attention.
//
// Bound: bytes.  The work is a reduction over the cache: K and V up to
// len[b] are read once.  At the serving path's shape (B=8, KV=4, D=128,
// bf16, len ~1018 of S=2048) that is ~16.7 MB per call, ~5.0 us at
// 3.35 TB/s, against ~0.12 GFLOP.
//
// Design: one launch, balanced split-KV.  The TPU kernel walks all of S
// in one program per (batch, kv head); here that would be 32 CTAs for 132
// SMs.  So each (batch, kv head) gets n_split CTAs, a number the host
// fixes from (B, KV, S, the SM count) alone (kernels/decode_attention.py::
// _splits: as many as keep every CTA resident at once, two an SM, since a
// second wave of a few CTAs costs more than it spreads), never from the
// lengths, which live on the card.  Each CTA
// reads its own len[b] and takes an even share of the positions below it,
// so none is launched only to exit and the work stays balanced at any
// length.  A CTA serves all G query heads of its kv head, so every K and
// V byte is read once.  It writes its partial (the row max m in log2
// units, the sum l and the unnormalised accumulator) to scratch; then,
// after a __threadfence(), it takes a ticket from a per-(batch, kv head)
// counter, and the CTA that draws the last ticket combines the n_split
// partials in split order (deterministic whatever the order of arrival:
// weights per split and head first, then float4 sums over the splits)
// and resets the counter to 0 for the next call, so a CUDA graph replays
// correctly.  The wrapper allocates the counters once per device, zeroed.
//
// Two kernels of that scheme (the Python wrapper's _variant picks):
// * decode_mma (bf16 with D and Dv multiples of 16 up to 256, G <= 16,
//   16-byte aligned rows): 128 threads.  K and V tiles of 64 positions
//   stay bf16 in shared memory, arriving together by 16-byte cp.async
//   through a ring of 2-3 stages (a 16-byte chunk c of row r sits at
//   chunk c ^ (r % 8), so ldmatrix reads are conflict-free).  The G heads
//   are the rows of mma.sync m16n8k16 tiles (G padded to 16), q's
//   fragments held in registers; each warp takes 16 positions of every
//   tile: S = Q K^T (ldmatrix), an online softmax in f32 on the
//   accumulator registers (exp2, D^-1/2 log2 e folded in), P rounded to
//   bf16 as the A operand of O += P V (ldmatrix.trans of V, no copy).
//   The four warps' partials merge through shared memory.
// * decode_fma (f32, and bf16 inputs the other does not take): K and V
//   turned into f32 in shared memory (taking turns in one buffer) a tile
//   of 64 positions at a time, f32 FMAs and an online softmax across the
//   tiles, so f32 inputs stay within 2e-5 of the plain version.
//
// q and o are (B, 1, H, D) and k, v (B, S, KV, D) with element strides
// for batch, position and head; the head dim must be contiguous.  The C
// entry points return cudaGetLastError() after the launch (or
// cudaErrorInvalidValue for arguments they refuse); the Python wrapper
// raises on a non-zero code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;  // cache positions of a tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

struct Strides {
  long long b, s, h;  // elements; the head dim is contiguous
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// The positions [*begin, *end) that split `split` of n_split takes of
// the valid len[b]: an even share, whatever the length.
__device__ __forceinline__ void share(const int32_t* kv_len, int b, int S,
                                      int split, int n_split, int* begin,
                                      int* end) {
  int len = kv_len[b];
  len = len < 0 ? 0 : (len > S ? S : len);
  *begin = static_cast<int>(static_cast<long long>(len) * split / n_split);
  *end = static_cast<int>(static_cast<long long>(len) * (split + 1) /
                          n_split);
}

// Shared memory the combine needs: the n_split x G (m, l) pairs.
size_t combine_smem(int n_split, int G) {
  return sizeof(float) * 2 * static_cast<size_t>(n_split) * G;
}

size_t larger(size_t a, size_t b) { return a > b ? a : b; }

// Called by every thread of a CTA once its partial is written: the last
// CTA of the (batch, kv head) to get here combines the n_split partials
// in split order into o, writes each head's log-sum-exp to lse when it
// is given (in natural-log units, -inf for a row with no keys), and
// resets the ticket.  smem: at least
// combine_smem(n_split, G) bytes, written only after the barrier below,
// when every thread's reads of it are done.
template <typename T>
__device__ void finish(const float* part_ml, const float* part_acc,
                       int* tickets, T* o, float* lse, Strides os, int bkv,
                       int KV, int G, int Dv, int n_split, float* smem) {
  __shared__ int last;
  __threadfence();  // this CTA's partial is visible before its ticket
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(tickets + bkv, 1) == n_split - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();  // ... and every other CTA's, before the reads below
  const int b = bkv / KV, kvh = bkv % KV;
  const float* ml = part_ml + static_cast<long long>(bkv) * n_split * G * 2;
  const float* acc =
      part_acc + static_cast<long long>(bkv) * n_split * G * Dv;
  // the (m, l) pairs, then per head the max M and sum L over the splits,
  // and in place of each m the split's weight exp2(m - M) / L (no keys,
  // len 0: every l and accumulator is 0, so the output is 0)
  for (int i = threadIdx.x; i < n_split * G * 2; i += kThreads)
    smem[i] = __ldcg(ml + i);
  __syncthreads();
  for (int g = threadIdx.x; g < G; g += kThreads) {
    float M = kNegInf, L = 0.f;
    for (int s = 0; s < n_split; ++s) M = fmaxf(M, smem[(s * G + g) * 2]);
    for (int s = 0; s < n_split; ++s)
      L += smem[(s * G + g) * 2 + 1] * exp2f(smem[(s * G + g) * 2] - M);
    const float inv = 1.f / fmaxf(L, 1e-30f);
    // m is in log2 units (the scores carry log2 e): lse = (M + log2 L) ln 2
    if (lse != nullptr)
      lse[bkv * G + g] =
          L > 0.f ? (M + log2f(L)) * 0.6931471805599453f : -INFINITY;
    for (int s = 0; s < n_split; ++s)
      smem[(s * G + g) * 2] = exp2f(smem[(s * G + g) * 2] - M) * inv;
  }
  __syncthreads();
  // the weighted sums, each over the splits in order: four columns a
  // thread where the rows allow 16-byte loads
  const int vec = Dv % 4 == 0 ? 4 : 1;
  const int per_row = Dv / vec;
  for (int i = threadIdx.x; i < G * per_row; i += kThreads) {
    const int g = i / per_row, d = (i - g * per_row) * vec;
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    if (vec == 4) {
#pragma unroll 8
      for (int s = 0; s < n_split; ++s) {
        const float4 x = __ldcg(reinterpret_cast<const float4*>(
            acc + (static_cast<long long>(s) * G + g) * Dv + d));
        const float w = smem[(s * G + g) * 2];
        a[0] += x.x * w;
        a[1] += x.y * w;
        a[2] += x.z * w;
        a[3] += x.w * w;
      }
    } else {
#pragma unroll 8
      for (int s = 0; s < n_split; ++s)
        a[0] += __ldcg(acc + (static_cast<long long>(s) * G + g) * Dv + d) *
                smem[(s * G + g) * 2];
    }
    T* orow = o + b * os.b + (kvh * G + g) * os.h + d;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < vec) store(orow + j, a[j]);
  }
  if (threadIdx.x == 0) tickets[bkv] = 0;  // ready for the next call
}

// ---------------------------------------------------------------------
// FMA kernel: grid (n_split, B * KV).  Partials part_ml [B * KV, n_split,
// G] x (m, l) and part_acc [B * KV, n_split, G, Dv].
size_t fma_smem(int G, int D, int Dv) {
  const int ldkv = (D + 1) > Dv ? (D + 1) : Dv;
  return sizeof(float) * (static_cast<size_t>(G) * D +
                          static_cast<size_t>(kTile) * ldkv +
                          static_cast<size_t>(G) * kTile +
                          static_cast<size_t>(G) * Dv + 3 * G);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_fma(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const int32_t* __restrict__ kv_len,
           float* __restrict__ part_ml, float* __restrict__ part_acc,
           int* __restrict__ tickets, T* __restrict__ o,
           float* __restrict__ lse, Strides qs,
           Strides ks, Strides vs, Strides os, int S, int KV, int G, int D,
           int Dv, int n_split, float scale_log2) {
  extern __shared__ __align__(16) float smem[];
  const int split = blockIdx.x, bkv = blockIdx.y;
  const int b = bkv / KV, kvh = bkv % KV;
  int begin, end;
  share(kv_len, b, S, split, n_split, &begin, &end);

  const int ldk = D + 1;  // odd for even D: conflict-free column walks
  const int ldkv = ldk > Dv ? ldk : Dv;
  float* Qs = smem;                  // G x D
  float* KVs = Qs + G * D;           // kTile x ldk (K), then kTile x Dv (V)
  float* Ss = KVs + kTile * ldkv;    // G x kTile
  float* Acc = Ss + G * kTile;       // G x Dv
  float* Ms = Acc + G * Dv;          // G: running max, log2 units
  float* Ls = Ms + G;                // G: running sum
  float* Cs = Ls + G;                // G: this tile's rescale factor
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const T* qb = q + b * qs.b + static_cast<long long>(kvh) * G * qs.h;
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i - g * D;
    Qs[i] = to_f32(qb[g * qs.h + d]);
  }
  for (int i = tid; i < G * Dv; i += kThreads) Acc[i] = 0.f;
  for (int g = tid; g < G; g += kThreads) {
    Ms[g] = kNegInf;
    Ls[g] = 0.f;
  }
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;

  for (int p0 = begin; p0 < end; p0 += kTile) {
    const int np = end - p0 < kTile ? end - p0 : kTile;
    __syncthreads();  // the last tile's reads of V and P are done
    for (int i = tid; i < np * D; i += kThreads) {
      const int c = i / D, d = i - c * D;
      KVs[c * ldk + d] = to_f32(kb[static_cast<long long>(p0 + c) * ks.s + d]);
    }
    __syncthreads();
    for (int i = tid; i < G * kTile; i += kThreads) {
      const int g = i / kTile, c = i - g * kTile;
      float s = kNegInf;
      if (c < np) {
        float a = 0.f;
        for (int d = 0; d < D; ++d)
          a = fmaf(Qs[g * D + d], KVs[c * ldk + d], a);
        s = a * scale_log2;
      }
      Ss[i] = s;
    }
    __syncthreads();
    for (int g = warp; g < G; g += kWarps) {
      float* srow = Ss + g * kTile;
      float mx = kNegInf;
      for (int c = lane; c < np; c += 32) mx = fmaxf(mx, srow[c]);
      const float m_new = fmaxf(Ms[g], warp_max(mx));
      float sum = 0.f;
      for (int c = lane; c < kTile; c += 32) {
        const float p = c < np ? exp2f(srow[c] - m_new) : 0.f;
        srow[c] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = exp2f(Ms[g] - m_new);
        Cs[g] = corr;
        Ls[g] = Ls[g] * corr + sum;
        Ms[g] = m_new;
      }
    }
    __syncthreads();  // every read of K is done: V takes the buffer
    for (int i = tid; i < np * Dv; i += kThreads) {
      const int c = i / Dv, d = i - c * Dv;
      KVs[c * Dv + d] = to_f32(vb[static_cast<long long>(p0 + c) * vs.s + d]);
    }
    __syncthreads();
    for (int i = tid; i < G * Dv; i += kThreads) {
      const int g = i / Dv, d = i - g * Dv;
      const float* prow = Ss + g * kTile;
      float a = 0.f;
      for (int c = 0; c < np; ++c) a = fmaf(prow[c], KVs[c * Dv + d], a);
      Acc[i] = Acc[i] * Cs[g] + a;
    }
  }
  __syncthreads();

  const long long part = static_cast<long long>(bkv) * n_split + split;
  for (int i = tid; i < G * Dv; i += kThreads)
    part_acc[part * G * Dv + i] = Acc[i];
  for (int g = tid; g < G; g += kThreads) {
    part_ml[(part * G + g) * 2] = Ms[g];
    part_ml[(part * G + g) * 2 + 1] = Ls[g];
  }
  finish<T>(part_ml, part_acc, tickets, o, lse, os, bkv, KV, G, Dv,
            n_split, smem);
}

// ---------------------------------------------------------------------
// mma.sync kernel (bf16)
// kD: D and Dv padded to 64, 128 or 256; a K or V row of a tile is kD
// bf16 in shared memory, zeros past D or Dv
template <int kD, int kStages>
struct Mma {
  static constexpr int kRowBytes = kD * 2;
  static constexpr int kChunks = kD / 8;  // 16-byte chunks of a row
  static constexpr int kTileBytes = kTile * kRowBytes;
  static constexpr int kStageBytes = 2 * kTileBytes;  // K, then V
  static constexpr size_t kRing = static_cast<size_t>(kStages) * kStageBytes;
  // after the loop: the warps' accumulators, maxima and sums
  static constexpr size_t kMerge = sizeof(float) * kWarps * 16 * (kD + 2);
  static constexpr size_t kSmem = kRing > kMerge ? kRing : kMerge;
};

template <int kD, int kStages>
__global__ void __launch_bounds__(kThreads)
decode_mma(const __nv_bfloat16* __restrict__ q,
           const __nv_bfloat16* __restrict__ k,
           const __nv_bfloat16* __restrict__ v,
           const int32_t* __restrict__ kv_len, float* __restrict__ part_ml,
           float* __restrict__ part_acc, int* __restrict__ tickets,
           __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
           Strides qs, Strides ks, Strides vs, Strides os, int S, int KV,
           int G, int D, int Dv, int n_split, float scale_log2) {
  using L = Mma<kD, kStages>;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  const uint32_t sbase = smem_u32(smem_raw);
  const int split = blockIdx.x, bkv = blockIdx.y;
  const int b = bkv / KV, kvh = bkv % KV;
  int begin, end;
  share(kv_len, b, S, split, n_split, &begin, &end);
  const int n_tiles = (end - begin + kTile - 1) / kTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = lane >> 2, cq = 2 * (lane & 3);

  const __nv_bfloat16* kb = k + b * ks.b + kvh * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + kvh * vs.h;
  // tile t (positions begin + 64 t ...) into stage t % kStages, K and V;
  // zeros past end, D and Dv
  auto stage = [&](int t) {
    const int p0 = begin + t * kTile;
    const uint32_t dst = sbase + (t % kStages) * L::kStageBytes;
    for (int i = tid; i < kTile * L::kChunks; i += kThreads) {
      const int r = i / L::kChunks, c = i - r * L::kChunks;
      const int p = p0 + r;
      const uint32_t off = r * L::kRowBytes + ((c ^ (r & 7)) << 4);
      const bool kin = p < end && 8 * c < D, vin = p < end && 8 * c < Dv;
      cp_async16(dst + off, kin ? kb + p * ks.s + 8 * c : kb, kin);
      cp_async16(dst + L::kTileBytes + off,
                 vin ? vb + p * vs.s + 8 * c : vb, vin);
    }
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) stage(t);
    cp_async_commit();
  }

  // q's A fragments: row g (a head of the group, zero past G), columns d
  uint32_t qa[kD / 16][4];
  const __nv_bfloat16* qb =
      q + b * qs.b + static_cast<long long>(kvh) * G * qs.h;
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int g = r0 + 8 * (i & 1), d = 16 * kk + cq + 8 * (i >> 1);
      qa[kk][i] = g < G && d < D
                      ? *reinterpret_cast<const uint32_t*>(qb + g * qs.h + d)
                      : 0u;
    }

  // this thread's rows r0 and r0 + 8 (h = 0, 1): max in log2 units, its
  // share of the sum, and of the accumulator columns 8 n + cq + j
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();  // tile t has landed (this thread's part)
    __syncthreads();  // ... every thread's, and tile t - 1 is consumed
    if (t + kStages - 1 < n_tiles) stage(t + kStages - 1);
    cp_async_commit();
    const uint32_t kt = sbase + (t % kStages) * L::kStageBytes;
    const uint32_t vt = kt + L::kTileBytes;
    const int rw = warp * 16;  // this warp's 16 positions of the tile

    // S = Q K^T: two n8 tiles of positions; ldmatrix x4 gives the B
    // fragments of both (rows rw + (lane & 7) + 8 (lane >> 4), chunks
    // 2 kk and 2 kk + 1)
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const int r = rw + (lane & 7) + 8 * (lane >> 4);
      const int c = 2 * kk + ((lane >> 3) & 1);
      uint32_t bf[4];
      ldmatrix_x4(bf, kt + r * L::kRowBytes + ((c ^ (r & 7)) << 4));
      mma_bf16(sc[0], qa[kk], bf[0], bf[1]);
      mma_bf16(sc[1], qa[kk], bf[2], bf[3]);
    }

    // online softmax over the 16 positions: sc[n][2 h + j] is row r0 +
    // 8 h, position rw + 8 n + cq + j
    const int pbase = begin + t * kTile + rw + cq;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const bool ok = pbase + 8 * n + j < end;
          const float x = ok ? sc[n][2 * h + j] * scale_log2 : kNegInf;
          sc[n][2 * h + j] = x;
          mx[h] = fmaxf(mx[h], x);
        }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      corr[h] = ex2(m[h] - m_new);
      m[h] = m_new;
      l[h] *= corr[h];
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const bool ok = pbase + 8 * n + j < end;
          const float p = ok ? ex2(sc[n][2 * h + j] - m[h]) : 0.f;
          sc[n][2 * h + j] = p;
          l[h] += p;
        }
#pragma unroll
    for (int n = 0; n < kD / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] *= corr[i >> 1];

    // O += P V: P in bf16 as the A fragment (the score tiles' layout is
    // the m16k16 A layout), V's B fragments by ldmatrix.trans (rows rw +
    // (lane & 7) + 8 ((lane >> 3) & 1), chunks 2 c + (lane >> 4))
    const uint32_t pa[4] = {pack_bf16(sc[0][0], sc[0][1]),
                            pack_bf16(sc[0][2], sc[0][3]),
                            pack_bf16(sc[1][0], sc[1][1]),
                            pack_bf16(sc[1][2], sc[1][3])};
#pragma unroll
    for (int c2 = 0; c2 < kD / 16; ++c2) {
      const int r = rw + (lane & 7) + 8 * ((lane >> 3) & 1);
      const int c = 2 * c2 + (lane >> 4);
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, vt + r * L::kRowBytes + ((c ^ (r & 7)) << 4));
      mma_bf16(acc[2 * c2], pa, bf[0], bf[1]);
      mma_bf16(acc[2 * c2 + 1], pa, bf[2], bf[3]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring becomes the merge buffer

  // merge the four warps' partials: red [warp][row][kD], then m and l
  float* red = reinterpret_cast<float*>(smem_raw);
  float* red_m = red + kWarps * 16 * kD;
  float* red_l = red_m + kWarps * 16;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int row = warp * 16 + r0 + 8 * h;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      red[row * kD + 8 * n + cq] = acc[n][2 * h];
      red[row * kD + 8 * n + cq + 1] = acc[n][2 * h + 1];
    }
    if ((lane & 3) == 0) {
      red_m[row] = m[h];
      red_l[row] = l[h];
    }
  }
  __syncthreads();
  const long long part = static_cast<long long>(bkv) * n_split + split;
  for (int i = tid; i < G * Dv; i += kThreads) {
    const int g = i / Dv, d = i - g * Dv;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, red_m[w * 16 + g]);
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      a += red[(w * 16 + g) * kD + d] * exp2f(red_m[w * 16 + g] - M);
    part_acc[part * G * Dv + i] = a;
  }
  for (int g = tid; g < G; g += kThreads) {
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, red_m[w * 16 + g]);
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      s += red_l[w * 16 + g] * exp2f(red_m[w * 16 + g] - M);
    part_ml[(part * G + g) * 2] = M;
    part_ml[(part * G + g) * 2 + 1] = s;
  }
  finish<__nv_bfloat16>(part_ml, part_acc, tickets, o, lse, os, bkv, KV, G,
                        Dv, n_split, red);
}

// ---------------------------------------------------------------------
struct Args {
  const void *q, *k, *v, *kv_len;
  void *part_ml, *part_acc, *tickets, *o, *lse;
  int B, S, H, KV, D, Dv, n_split;
  Strides qs, ks, vs, os;
  float scale_log2;
};

Args args(const void* q, const void* k, const void* v, const void* kv_len,
          void* part_ml, void* part_acc, void* tickets, void* o, void* lse,
          int B, int S, int H, int KV, int D, int Dv, int n_split,
          const long long* st) {
  return Args{q, k, v, kv_len, part_ml, part_acc, tickets, o, lse, B, S, H,
              KV, D, Dv, n_split, Strides{st[0], 0, st[1]},
              Strides{st[2], st[3], st[4]}, Strides{st[5], st[6], st[7]},
              Strides{st[8], 0, st[9]},
              1.4426950408889634f / sqrtf(static_cast<float>(D))};
}

bool args_ok(const Args& a) {
  return a.D >= 1 && a.D <= 256 && a.Dv >= 1 && a.Dv <= 256 && a.KV >= 1 &&
         a.H % a.KV == 0 && a.n_split >= 1 && a.B * a.KV <= 65535;
}

// Opt in, once per kernel, to all the dynamic shared memory the card
// gives a block beside the kernel's static shared memory (finish's flag);
// *optin gets that many bytes.
template <typename Kernel>
int opt_in(Kernel kernel, int* optin) {
  if (*optin != 0) return 0;
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  cudaFuncAttributes attr;
  cudaFuncGetAttributes(&attr, kernel);
  bytes -= static_cast<int>(attr.sharedSizeBytes);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       bytes);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) *optin = bytes;
  return static_cast<int>(err);
}

template <typename T>
int launch_fma(const Args& a, cudaStream_t stream) {
  static int optin = 0;
  if (!args_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  if (const int err = opt_in(decode_fma<T>, &optin)) return err;
  const int G = a.H / a.KV;
  const size_t bytes =
      larger(fma_smem(G, a.D, a.Dv), combine_smem(a.n_split, G));
  if (bytes > static_cast<size_t>(optin))
    return static_cast<int>(cudaErrorInvalidValue);
  decode_fma<T><<<dim3(a.n_split, a.B * a.KV), kThreads, bytes, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const int32_t*>(a.kv_len),
      static_cast<float*>(a.part_ml), static_cast<float*>(a.part_acc),
      static_cast<int*>(a.tickets), static_cast<T*>(a.o),
      static_cast<float*>(a.lse), a.qs, a.ks, a.vs, a.os, a.S, a.KV, G, a.D,
      a.Dv, a.n_split, a.scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <int kD, int kStages>
int launch_mma_d(const Args& a, cudaStream_t stream) {
  using L = Mma<kD, kStages>;
  static int optin = 0;
  if (const int err = opt_in(decode_mma<kD, kStages>, &optin)) return err;
  const size_t bytes = larger(L::kSmem, combine_smem(a.n_split, a.H / a.KV));
  if (bytes > static_cast<size_t>(optin))
    return static_cast<int>(cudaErrorInvalidValue);
  decode_mma<kD, kStages>
      <<<dim3(a.n_split, a.B * a.KV), kThreads, bytes, stream>>>(
          static_cast<const __nv_bfloat16*>(a.q),
          static_cast<const __nv_bfloat16*>(a.k),
          static_cast<const __nv_bfloat16*>(a.v),
          static_cast<const int32_t*>(a.kv_len),
          static_cast<float*>(a.part_ml), static_cast<float*>(a.part_acc),
          static_cast<int*>(a.tickets), static_cast<__nv_bfloat16*>(a.o),
          static_cast<float*>(a.lse), a.qs, a.ks, a.vs, a.os, a.S, a.KV,
          a.H / a.KV, a.D, a.Dv,
          a.n_split, a.scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// the mma kernel's own conditions (the wrapper's _variant checks the same)
int launch_mma(const Args& a, cudaStream_t stream) {
  const long long st[8] = {a.qs.b, a.qs.h, a.ks.b, a.ks.s,
                           a.ks.h, a.vs.b, a.vs.s, a.vs.h};
  bool ok = args_ok(a) && a.D % 16 == 0 && a.Dv % 16 == 0 &&
            a.H / a.KV <= 16;
  for (long long s : st) ok = ok && s % 8 == 0;
  const void* ptrs[3] = {a.q, a.k, a.v};
  for (const void* p : ptrs)
    ok = ok && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const int w = a.D > a.Dv ? a.D : a.Dv;
  if (w <= 64) return launch_mma_d<64, 3>(a, stream);
  if (w <= 128) return launch_mma_d<128, 3>(a, stream);
  return launch_mma_d<256, 2>(a, stream);
}

}  // namespace

// strides: 10 element strides, q (batch, head), k and v (batch, position,
// head), o (batch, head).  part_ml (B * KV, n_split, G, 2) and part_acc
// (B * KV, n_split, G, Dv) are f32 scratch; tickets (B * KV,) int32,
// zero before the call and zero again after it.  lse: null, or (B, H)
// f32 contiguous, each row's log-sum-exp of its scaled scores.
#define DECODE_ENTRY(name, launcher)                                         \
  extern "C" int name(const void* q, const void* k, const void* v,           \
                      const void* kv_len, void* part_ml, void* part_acc,     \
                      void* tickets, void* o, void* lse, int B, int S,       \
                      int H, int KV, int D, int Dv, int n_split,             \
                      const long long* strides, void* stream) {              \
    return launcher(args(q, k, v, kv_len, part_ml, part_acc, tickets, o,    \
                         lse, B, S, H, KV, D, Dv, n_split, strides),         \
                    static_cast<cudaStream_t>(stream));                      \
  }

DECODE_ENTRY(decode_attention_f32, launch_fma<float>)
DECODE_ENTRY(decode_attention_bf16, launch_fma<__nv_bfloat16>)
DECODE_ENTRY(decode_attention_bf16_mma, launch_mma)
