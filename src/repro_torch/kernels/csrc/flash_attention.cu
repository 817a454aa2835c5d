// Flash attention (forward) for Hopper (sm_90a).
//
//   o[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, h / G] * D^-1/2) v[b, j, h / G]
//
// over the keys j < Skv (and j <= i when causal, the query and key
// positions aligned at 0), GQA-native: query head h reads kv head h / G.
// Scores, probabilities and the accumulator are f32 whatever the input
// type (bf16 or f32); the output is written in the input type.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py::
// flash_attention (body _kernel), which the model's prefill calls once per
// layer in place of the reference's XLA blockwise_attention.
//
// Bound: operations.  At the serving path's shape (B=8, S=1024, H=28,
// KV=4, D=128, bf16, causal) the work is 2 * 2 * B * H * S^2 / 2 * D
// = ~60 GFLOP, ~0.061 ms at 989 TFLOP/s bf16; the bytes (q, k, v read once,
// o written once) are ~134 MB, ~0.040 ms at 3.35 TB/s.
//
// Design.  A CTA takes one (batch, kv head) and 64 consecutive rows of the
// flattened (query position, head in group) index, row = i * G + g, so one
// tile holds all G query heads that share a kv head and the K/V tile it
// loads into shared memory serves all of them (the Pallas kernel's "kv
// blocks fetched once per kv head").  It walks the kv positions in tiles
// of 64 with an online softmax; the running max and sum (m, l) and the
// output accumulator stay in registers, f32.  256 threads as 16 x 16: a
// thread owns 4 rows and, of the 64 x 64 score tile, the columns tx + 16 j;
// of the accumulator, the columns tx + 16 j up to Dv.  Row reductions are
// shuffles among the 16 threads of a half-warp.  Causal tiles that lie
// wholly above the diagonal of the CTA's last query are never visited;
// ragged edges (Sq, Skv not multiples of 64) are masked.  K and V take
// turns in one shared buffer (K for the scores, then V for P.V), so a CTA
// needs ~83 KB at D = 128 and two fit on an SM.  The products are f32 FMAs
// from shared memory: a first kernel that is right; tensor-core tiles
// (mma / wgmma) and TMA are later work.
//
// q, k, v and o are read and written in the model's (B, S, heads, D)
// layout with element strides for batch, position and head; the head dim
// must be contiguous.  The C entry points return cudaGetLastError() after
// the launch; the Python wrapper raises on a non-zero code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kRows = 64;      // (query, head) rows of a CTA: 16 ty x 4
constexpr int kCols = 64;      // kv positions of a tile: 16 tx x 4
constexpr int kLdp = kCols + 1;
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

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

size_t smem_bytes(int D, int Dv) {
  const int ldkv = (D + 1) > Dv ? (D + 1) : Dv;
  return sizeof(float) *
         (static_cast<size_t>(kRows) * (D + 1) +
          static_cast<size_t>(kCols) * ldkv + kRows * kLdp);
}

// NJ = accumulator columns per thread: Dv <= 16 * NJ
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, Strides qs, Strides ks,
          Strides vs, Strides os, int Sq, int Skv, int KV, int G, int D,
          int Dv, int causal, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int ldq = D + 1;  // odd for even D: conflict-free column walks
  const int ldkv = ldq > Dv ? ldq : Dv;
  float* Qs = smem;                   // kRows x ldq
  float* KVs = Qs + kRows * ldq;      // kCols x ldq (K), then kCols x Dv (V)
  float* Ps = KVs + kCols * ldkv;     // kRows x kLdp

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.y / KV, kvh = blockIdx.y % KV;
  const long long n_rows = static_cast<long long>(Sq) * G;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const T* qb = q + b * qs.b;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;

  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const long long rg = row0 + r;
    float x = 0.f;
    if (rg < n_rows) {
      const int qp = static_cast<int>(rg / G), g = static_cast<int>(rg % G);
      x = to_f32(qb[qp * qs.s + (kvh * G + g) * qs.h + d]);
    }
    Qs[r * ldq + d] = x;
  }

  int qpos[4];
  bool row_ok[4];
  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long rg = row0 + ty * 4 + i;
    row_ok[i] = rg < n_rows;
    qpos[i] = row_ok[i] ? static_cast<int>(rg / G) : -1;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  const long long last_row = (row0 + kRows < n_rows ? row0 + kRows : n_rows) - 1;
  const int q_last = static_cast<int>(last_row / G);
  const int kv_end = causal ? (Skv < q_last + 1 ? Skv : q_last + 1) : Skv;
  const int n_tiles = (kv_end + kCols - 1) / kCols;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kCols;
    __syncthreads();  // the last tile's reads of V and P are done
    for (int i = tid; i < kCols * D; i += kThreads) {
      const int c = i / D, d = i - c * D;
      const int kp = k0 + c;
      KVs[c * ldq + d] = kp < Skv ? to_f32(kb[kp * ks.s + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float a[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * ldq + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kk[j] = KVs[(tx + 16 * j) * ldq + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], kk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool ok[4];
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        ok[j] = row_ok[i] && kp < Skv && (!causal || kp <= qpos[i]);
        s[i][j] *= scale;
        if (ok[j]) mt = fmaxf(mt, s[i][j]);
      }
      mt = half_warp_max(mt);
      const float m_new = fmaxf(m[i], mt);
      const float corr = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty * 4 + i) * kLdp + tx + 16 * j] = p;
        ps += p;
      }
      ps = half_warp_sum(ps);
      l[i] = l[i] * corr + ps;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }

    __syncthreads();  // every read of K is done: V takes the buffer
    for (int i = tid; i < kCols * Dv; i += kThreads) {
      const int c = i / Dv, d = i - c * Dv;
      const int kp = k0 + c;
      KVs[c * Dv + d] = kp < Skv ? to_f32(vb[kp * vs.s + d]) : 0.f;
    }
    __syncthreads();

    for (int c = 0; c < kCols; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * kLdp + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = tx + 16 * j;
        const float vv = d < Dv ? KVs[c * Dv + d] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!row_ok[i]) continue;
    const long long rg = row0 + ty * 4 + i;
    const int qp = static_cast<int>(rg / G), g = static_cast<int>(rg % G);
    T* orow = o + b * os.b + qp * os.s + (kvh * G + g) * os.h;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < Dv) store(orow + d, acc[i][j] * inv);
    }
  }
}

template <typename T, int NJ>
int launch_nj(const void* q, const void* k, const void* v, void* o, int B,
              int Sq, int Skv, int H, int KV, int D, int Dv, int causal,
              const long long* st, cudaStream_t stream) {
  static int optin = 0;  // opt in to the card's full shared memory once
  if (optin == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    cudaFuncSetAttribute(flash_fwd<T, NJ>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) {
      optin = 0;
      return static_cast<int>(err);
    }
  }
  const size_t bytes = smem_bytes(D, Dv);
  if (bytes > static_cast<size_t>(optin))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_rows = static_cast<long long>(Sq) * (H / KV);
  const dim3 grid(static_cast<unsigned>((n_rows + kRows - 1) / kRows),
                  static_cast<unsigned>(B * KV));
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  flash_fwd<T, NJ><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), qs, ks, vs, os, Sq, Skv,
      KV, H / KV, D, Dv, causal, 1.f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int H, int KV, int D, int Dv, int causal,
           const long long* st, void* stream) {
  if (D < 1 || D > 256 || Dv < 1 || Dv > 256 || KV < 1 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dv <= 16)
    return launch_nj<T, 1>(q, k, v, o, B, Sq, Skv, H, KV, D, Dv, causal, st, s);
  if (Dv <= 32)
    return launch_nj<T, 2>(q, k, v, o, B, Sq, Skv, H, KV, D, Dv, causal, st, s);
  if (Dv <= 64)
    return launch_nj<T, 4>(q, k, v, o, B, Sq, Skv, H, KV, D, Dv, causal, st, s);
  if (Dv <= 128)
    return launch_nj<T, 8>(q, k, v, o, B, Sq, Skv, H, KV, D, Dv, causal, st, s);
  return launch_nj<T, 16>(q, k, v, o, B, Sq, Skv, H, KV, D, Dv, causal, st, s);
}

}  // namespace

// strides: 12 element strides, (batch, position, head) of q, k, v and o
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   void* o, int B, int Sq, int Skv, int H,
                                   int KV, int D, int Dv, int causal,
                                   const long long* strides, void* stream) {
  return launch<float>(q, k, v, o, B, Sq, Skv, H, KV, D, Dv, causal, strides,
                       stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int B, int Sq,
                                    int Skv, int H, int KV, int D, int Dv,
                                    int causal, const long long* strides,
                                    void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, B, Sq, Skv, H, KV, D, Dv, causal,
                               strides, stream);
}
