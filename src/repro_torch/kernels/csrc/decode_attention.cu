// Flash-decoding for Hopper (sm_90a): one query token per batch row
// against a KV cache, with a per-row valid length.
//
//   o[b, 0, h] = sum_{j < len[b]} softmax_j(q[b, 0, h] . k[b, j, h / G]
//                                           * D^-1/2) v[b, j, h / G]
//
// GQA-native (query head h reads kv head h / G).  Scores, probabilities
// and the accumulator are f32 whatever the input type (bf16 or f32); the
// output is written in the input type.
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
// Design.  The TPU kernel walks all of S in one program per (batch, kv
// head) and masks; here that would be 32 CTAs for 132 SMs at the path's
// shape.  So the sequence is split: pass 1 gives each (chunk of 64
// positions, batch, kv head) its own CTA, for all G query heads of that kv
// head, and a CTA whose chunk starts at or beyond len[b] exits at once, so
// only positions < len[b] are read.  It stages q and the chunk's K in
// shared memory (f32, odd row stride: conflict-free), computes the G x 64
// scores, takes each head's max and sum with warp shuffles, then loads V
// into the same buffer and writes its partial (m, l, acc) to scratch.
// Pass 2 (one CTA per (batch, kv head, head in group)) rescales the
// partials of the chunks below len[b] by exp(m - M) and divides by the
// combined sum.  The per-row length bound and the split with its combine
// are why this is CUDA and not Triton: the early exit depends on a length
// read on the device, and the two passes share one scratch layout.
//
// q and o are (B, 1, H, D) and k, v (B, S, KV, D) with element strides
// for batch, position and head; the head dim must be contiguous.  The C
// entry points return cudaGetLastError() after the launches; the Python
// wrapper raises on a non-zero code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;  // cache positions per CTA of pass 1
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

__device__ __forceinline__ int valid_len(const int32_t* kv_len, int b, int S) {
  const int len = kv_len[b];
  return len < 0 ? 0 : (len > S ? S : len);
}

size_t smem_bytes(int G, int D, int Dv) {
  const int ldkv = (D + 1) > Dv ? (D + 1) : Dv;
  return sizeof(float) * (static_cast<size_t>(G) * D +
                          static_cast<size_t>(kChunk) * ldkv +
                          static_cast<size_t>(G) * kChunk);
}

// pass 1: grid (n_splits, B * KV); partials [B * KV, n_splits, G] x (m, l)
// and [B * KV, n_splits, G, Dv]
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_partial(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const int32_t* __restrict__ kv_len,
               float* __restrict__ part_ml, float* __restrict__ part_acc,
               Strides qs, Strides ks, Strides vs, int S, int KV, int G,
               int D, int Dv, int n_splits, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int split = blockIdx.x, bkv = blockIdx.y;
  const int b = bkv / KV, kvh = bkv % KV;
  const int len = valid_len(kv_len, b, S);
  const int p0 = split * kChunk;
  if (p0 >= len) return;  // nothing valid here: pass 2 skips this chunk
  const int np = len - p0 < kChunk ? len - p0 : kChunk;

  const int ldk = D + 1;
  float* Qs = smem;                                  // G x D
  float* KVs = Qs + G * D;                           // kChunk x ldk, then x Dv
  float* Ss = KVs + kChunk * (ldk > Dv ? ldk : Dv);  // G x kChunk
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const T* qb = q + b * qs.b + static_cast<long long>(kvh) * G * qs.h;
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i - g * D;
    Qs[i] = to_f32(qb[g * qs.h + d]);
  }
  const T* kb = k + b * ks.b + kvh * ks.h + static_cast<long long>(p0) * ks.s;
  for (int i = tid; i < np * D; i += kThreads) {
    const int c = i / D, d = i - c * D;
    KVs[c * ldk + d] = to_f32(kb[c * ks.s + d]);
  }
  __syncthreads();

  for (int i = tid; i < G * kChunk; i += kThreads) {
    const int g = i / kChunk, c = i - g * kChunk;
    float s = kNegInf;
    if (c < np) {
      float a = 0.f;
      for (int d = 0; d < D; ++d) a = fmaf(Qs[g * D + d], KVs[c * ldk + d], a);
      s = a * scale;
    }
    Ss[i] = s;
  }
  __syncthreads();

  float* ml = part_ml + (static_cast<long long>(bkv) * n_splits + split) * G * 2;
  for (int g = warp; g < G; g += kWarps) {
    float* srow = Ss + g * kChunk;
    float mx = kNegInf;
    for (int c = lane; c < np; c += 32) mx = fmaxf(mx, srow[c]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int c = lane; c < kChunk; c += 32) {
      const float p = c < np ? expf(srow[c] - mx) : 0.f;
      srow[c] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      ml[g * 2] = mx;
      ml[g * 2 + 1] = sum;
    }
  }
  __syncthreads();  // every read of K is done: V takes the buffer

  const T* vb = v + b * vs.b + kvh * vs.h + static_cast<long long>(p0) * vs.s;
  for (int i = tid; i < np * Dv; i += kThreads) {
    const int c = i / Dv, d = i - c * Dv;
    KVs[c * Dv + d] = to_f32(vb[c * vs.s + d]);
  }
  __syncthreads();

  float* acc = part_acc +
               (static_cast<long long>(bkv) * n_splits + split) * G * Dv;
  for (int i = tid; i < G * Dv; i += kThreads) {
    const int g = i / Dv, d = i - g * Dv;
    const float* prow = Ss + g * kChunk;
    float a = 0.f;
    for (int c = 0; c < np; ++c) a = fmaf(prow[c], KVs[c * Dv + d], a);
    acc[i] = a;
  }
}

// pass 2: one CTA per (b * KV + kvh) * G + g
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_combine(const float* __restrict__ part_ml,
               const float* __restrict__ part_acc,
               const int32_t* __restrict__ kv_len, T* __restrict__ o,
               Strides os, int S, int KV, int G, int Dv, int n_splits) {
  const int bg = blockIdx.x;
  const int bkv = bg / G, g = bg - bkv * G;
  const int b = bkv / KV, kvh = bkv % KV;
  const int n_used = (valid_len(kv_len, b, S) + kChunk - 1) / kChunk;
  const float* ml = part_ml + static_cast<long long>(bkv) * n_splits * G * 2;
  const float* acc = part_acc + static_cast<long long>(bkv) * n_splits * G * Dv;

  float M = kNegInf;
  for (int s = 0; s < n_used; ++s) M = fmaxf(M, ml[(s * G + g) * 2]);
  float L = 0.f;
  for (int s = 0; s < n_used; ++s)
    L += ml[(s * G + g) * 2 + 1] * expf(ml[(s * G + g) * 2] - M);
  const float inv = 1.f / fmaxf(L, 1e-30f);
  T* orow = o + b * os.b + (kvh * G + g) * os.h;
  for (int d = threadIdx.x; d < Dv; d += kThreads) {
    float a = 0.f;
    for (int s = 0; s < n_used; ++s)
      a += acc[(static_cast<long long>(s) * G + g) * Dv + d] *
           expf(ml[(s * G + g) * 2] - M);
    store(orow + d, a * inv);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* kv_len,
           void* part_ml, void* part_acc, void* o, int B, int S, int H, int KV,
           int D, int Dv, int n_splits, const long long* st, void* stream) {
  if (D < 1 || D > 256 || Dv < 1 || Dv > 256 || KV < 1 || H % KV != 0 ||
      n_splits != (S + kChunk - 1) / kChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  static int optin = 0;  // opt in to the card's full shared memory once
  if (optin == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    cudaFuncSetAttribute(decode_partial<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) {
      optin = 0;
      return static_cast<int>(err);
    }
  }
  const int G = H / KV;
  const size_t bytes = smem_bytes(G, D, Dv);
  if (bytes > static_cast<size_t>(optin))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides qs{st[0], 0, st[1]}, ks{st[2], st[3], st[4]},
      vs{st[5], st[6], st[7]}, os{st[8], 0, st[9]};
  decode_partial<T><<<dim3(n_splits, B * KV), kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(kv_len),
      static_cast<float*>(part_ml), static_cast<float*>(part_acc), qs, ks, vs,
      S, KV, G, D, Dv, n_splits, 1.f / sqrtf(static_cast<float>(D)));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine<T><<<B * KV * G, kThreads, 0, s>>>(
      static_cast<const float*>(part_ml), static_cast<const float*>(part_acc),
      static_cast<const int32_t*>(kv_len), static_cast<T*>(o), os, S, KV, G,
      Dv, n_splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// positions of the cache each CTA of pass 1 takes
extern "C" int decode_attention_chunk() { return kChunk; }

// strides: 10 element strides, q (batch, head), k and v (batch, position,
// head), o (batch, head)
extern "C" int decode_attention_f32(const void* q, const void* k,
                                    const void* v, const void* kv_len,
                                    void* part_ml, void* part_acc, void* o,
                                    int B, int S, int H, int KV, int D, int Dv,
                                    int n_splits, const long long* strides,
                                    void* stream) {
  return launch<float>(q, k, v, kv_len, part_ml, part_acc, o, B, S, H, KV, D,
                       Dv, n_splits, strides, stream);
}

extern "C" int decode_attention_bf16(const void* q, const void* k,
                                     const void* v, const void* kv_len,
                                     void* part_ml, void* part_acc, void* o,
                                     int B, int S, int H, int KV, int D,
                                     int Dv, int n_splits,
                                     const long long* strides, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, kv_len, part_ml, part_acc, o, B, S,
                               H, KV, D, Dv, n_splits, strides, stream);
}
