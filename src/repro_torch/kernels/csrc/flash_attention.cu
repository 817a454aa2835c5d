// Flash attention (forward) for Hopper (sm_90a): two kernels of one
// function.
//
//   o[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, h / G] * D^-1/2) v[b, j, h / G]
//
// over the keys j < Skv (and j <= i when causal, the query and key
// positions aligned at 0), GQA-native: query head h reads kv head h / G.
// Scores, the running max and sum (m, l) and the accumulator are f32; the
// output is written in the input type.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py::
// flash_attention (body _kernel), which the model's prefill calls once per
// layer in place of the reference's XLA blockwise_attention.  The Pallas
// kernel rounds P to the value type before P.V and accumulates in f32.
//
// Bound: operations.  At the serving path's shape (B=8, S=1002, H=28,
// KV=4, D=128, bf16, causal) the work is 2 * 2 * B * H * S (S + 1) / 2 * D
// = 57.6 GFLOP, 0.058 ms at 989 TFLOP/s bf16; the bytes (q, k, v read once,
// o written once) are 131 MB, 0.039 ms at 3.35 TB/s.
//
// Which inputs take which kernel is the Python wrapper's choice
// (kernels/flash_attention.py::_variant); each has its own C entry:
//
// * flash_attention_bf16_tc, the tensor-core kernel (flash_fwd_tc): bf16
//   with D and Dv multiples of 16, G <= 128 and every row 16-byte aligned
//   (base pointers, and the batch, position and head strides of q, k and
//   v in multiples of 8 elements).  A work item is one (batch, kv head)
//   and P consecutive query positions with all G heads of each: rows
//   p G + g of the flattened (position, head in group) index, P G <= 64
//   per consumer warpgroup, so every K/V tile it loads serves all G heads
//   and Q and O are plain TMA boxes (64 columns x G heads x P positions).
//   The kernel is persistent: one CTA per SM walks the items, those with
//   the longest causal rows first.  A CTA has three consumer warpgroups
//   (192 rows; two at D > 128, where the accumulator takes twice the
//   registers) and one producer warpgroup, and setmaxnreg moves registers
//   from the producer to the consumers.  One producer thread fills a ring
//   of K and V tiles of 64 kv positions in shared memory with TMA
//   (cp.async.bulk.tensor, 128-byte swizzle, tensor maps built on the host
//   and passed as __grid_constant__ parameters) and mbarriers: a "full"
//   barrier per stage that the copy completes, an "empty" one that each
//   consumer warp arrives on when it is done with the stage.  Another
//   loads each item's Q by TMA into one of two buffers, so the next item's
//   Q and first K/V tiles arrive while this one runs, and a third stores
//   each item's O by TMA.  Per tile t, each
//   warpgroup issues S_t = Q K_t^T with wgmma m64n64k16 (bf16 in, f32
//   out, both operands read from shared memory through matrix descriptors)
//   and behind it P_{t-1} V_{t-1} (wgmma with P as its register A operand
//   and V from shared memory MN-major, no transpose copy); it runs the
//   online softmax of S_t on the accumulator registers while the tensor
//   cores finish P_{t-1} V_{t-1} (row max and sum over the 4 lanes of a
//   row by shuffles, exp2 with D^-1/2 log2 e folded into one FFMA, masks
//   only on tiles that cross some row's diagonal or Skv's ragged end), then
//   rescales the accumulator and rounds P_t to bf16 in registers.  The
//   warpgroups run unsynchronised, so one's softmax also overlaps the
//   others' products.  Like the Pallas kernel it rounds P to bf16 before
//   P.V and accumulates in f32.  Tiles wholly above the diagonal are never
//   loaded.  O goes through the item's Q buffer, in Q's swizzled layout,
//   out by a TMA store that overlaps the next item.  Widths are padded to
//   64 (TMA fills the columns past D or Dv with zeros on loads and writes
//   nothing past Dv or Sq on stores); launch_tc gives the ring depth and
//   shared memory by width.
// * flash_attention_f32 and flash_attention_bf16, the FMA kernel
//   (flash_fwd): every f32 input, and the bf16 inputs the tensor-core
//   kernel does not take.  A CTA takes one (batch, kv head) and 64 rows of
//   the same flattened index and walks the kv positions in tiles of 64;
//   256 threads as 16 x 16: a thread owns 4 rows and, of the 64 x 64 score
//   tile, the columns tx + 16 j; of the accumulator, the columns tx + 16 j
//   up to Dv.  Row reductions are shuffles among the 16 threads of a
//   half-warp.  Inputs are turned into f32 in shared memory (K and V take
//   turns in one buffer, ~83 KB at D = 128, two CTAs an SM) and both
//   products are f32 FMAs, P unrounded: that keeps f32 inputs within 2e-5
//   of the plain version, which bf16 or TF32 tiles would not.
//
// Both kernels also write, when given a non-null lse, each row's f32
// log-sum-exp of the scaled scores, (B, H, Sq): m D^-1/2 + ln l, which
// the backward pass (flash_attention_bwd.cu) recomputes P from.  Serving
// passes null and writes nothing more.
//
// q, k, v and o are read and written in the model's (B, S, heads, D)
// layout with element strides for batch, position and head; the head dim
// must be contiguous.  The C entry points return cudaGetLastError() after
// the launch (or cudaErrorInvalidValue for arguments they refuse); the
// Python wrapper raises on a non-zero code.  The Hopper helpers (mbarriers,
// TMA, wgmma descriptors and fences) come from hopper.cuh.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

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
          const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
          Strides qs, Strides ks, Strides vs, Strides os, int Sq, int Skv,
          int KV, int G, int D, int Dv, int causal, float scale) {
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
    // the row's log-sum-exp of the scaled scores, for the backward pass
    if (lse != nullptr && tx == 0)
      lse[(static_cast<long long>(b) * KV * G + kvh * G + g) * Sq + qp] =
          m[i] + logf(l[i]);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < Dv) store(orow + d, acc[i][j] * inv);
    }
  }
}

template <typename T, int NJ>
int launch_nj(const void* q, const void* k, const void* v, void* o,
              float* lse, int B, int Sq, int Skv, int H, int KV, int D,
              int Dv, int causal, const long long* st, cudaStream_t stream) {
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
      static_cast<const T*>(v), static_cast<T*>(o), lse, qs, ks, vs, os, Sq,
      Skv, KV, H / KV, D, Dv, causal, 1.f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Sq, int Skv, int H, int KV, int D, int Dv, int causal,
           const long long* st, void* stream) {
  if (D < 1 || D > 256 || Dv < 1 || Dv > 256 || KV < 1 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dv <= 16)
    return launch_nj<T, 1>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, Dv,
                               causal, st, s);
  if (Dv <= 32)
    return launch_nj<T, 2>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, Dv,
                               causal, st, s);
  if (Dv <= 64)
    return launch_nj<T, 4>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, Dv,
                               causal, st, s);
  if (Dv <= 128)
    return launch_nj<T, 8>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, Dv,
                               causal, st, s);
  return launch_nj<T, 16>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, Dv,
                               causal, st, s);
}

}  // namespace

// ---------------------------------------------------------------------------
// The tensor-core kernel (bf16).

namespace {
namespace tc {

using namespace hopper;

// A CTA has kWGs consumer warpgroups of 64 rows each and one producer
// warpgroup; after setmaxnreg a producer thread keeps 56 registers and a
// consumer thread its share of the rest: 128 x (56 + kWGs x regs) <= 65536.
constexpr int kProducerRegs = 56;
// kv positions of a K/V tile: with 128 the scores, P and the accumulator
// need more registers than three warpgroups have, and with two it measured
// slower on the H100
constexpr int kBN = 64;
// wgmma m64nNk16, bf16 x bf16 -> f32, D (+)= A B.  _ss (N = 64): A and B
// from shared memory, both K-major; scale_d = 0 overwrites D.  _rs (N = 64
// or 128): A from registers (the m16k16 fragment of each warp), B from
// shared memory MN-major (transposed), D += A B.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// Shared memory of a CTA: kQBufs Q buffers (kD / 64 column blocks of
// 64 kWGs rows of 128 bytes), then per stage a K and a V tile (kD / 64
// blocks of kBN rows of 128 bytes each), then the barriers; plus slack to
// align the base to 1024 bytes, the period of the 128-byte swizzle.
constexpr size_t smem_bytes(int kD, int kStages, int kQBufs, int kWGs) {
  return static_cast<size_t>(kQBufs) * kD * 2 * 64 * kWGs +
         static_cast<size_t>(kStages) * 2 * kD * 2 * kBN +
         8 * (2 * kStages + 3 * kQBufs) + 1024;
}

// Online softmax of one score tile, in place (scores -> probabilities), on
// the wgmma accumulator layout: sc[4 n + 2 h + j] is this thread's row h,
// column 8 n + col0 + j of the tile.  The running max m is kept in score
// units; scale_log2 = D^-1/2 log2 e turns a score into an exponent of 2 in
// one FFMA.  l is this lane's share of the row sum.  corr gets the factor
// by which the accumulator's rows shrink.
__device__ __forceinline__ void softmax_tile(float (&sc)[kBN / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&corr)[2], bool masked,
                                             int k0, int col0, int Skv,
                                             int causal, const int (&qpos)[2],
                                             float scale_log2) {
  if (masked) {
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int kp = k0 + 8 * n + col0 + j;
          if (kp >= Skv || (causal && kp > qpos[h]))
            sc[4 * n + 2 * h + j] = -INFINITY;
        }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < kBN / 8; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      mx[h] = fmaxf(mx[h], fmaxf(sc[4 * n + 2 * h], sc[4 * n + 2 * h + 1]));
  float base[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m[h], mx[h]);
    base[h] = m_new == -INFINITY ? 0.f : m_new * scale_log2;
    corr[h] = ex2(m[h] * scale_log2 - base[h]);  // 0 while m is -inf
    m[h] = m_new;
  }
#pragma unroll
  for (int n = 0; n < kBN / 8; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float e = ex2(fmaf(sc[4 * n + 2 * h + j], scale_log2, -base[h]));
        sc[4 * n + 2 * h + j] = e;
        rs[h] += e;
      }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + rs[h];
}

// The item of round k for this CTA: CTA c takes item k * gridDim.x + c in
// even rounds and k * gridDim.x + gridDim.x - 1 - c in odd ones, so that
// with items in order of decreasing work every CTA gets a like share.
__device__ __forceinline__ int item_index(int k) {
  const int c = (k & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  return k * gridDim.x + c;
}

// A work item: P consecutive query positions of one (batch, kv head), all
// G heads of each, so P G rows; items in order of decreasing causal work
// (the last positions first).
struct Item {
  int b, kvh, pos0, n_tiles;
};

__device__ __forceinline__ Item item_of(int i, int BKV, int KV,
                                        int n_pos_tiles, int P, int Sq,
                                        int Skv, int causal) {
  Item it;
  const int bh = i % BKV;
  it.b = bh / KV;
  it.kvh = bh % KV;
  it.pos0 = (n_pos_tiles - 1 - i / BKV) * P;
  const int last = (it.pos0 + P < Sq ? it.pos0 + P : Sq) - 1;
  const int kv_end = causal ? (Skv < last + 1 ? Skv : last + 1) : Skv;
  it.n_tiles = (kv_end + kBN - 1) / kBN;
  return it;
}

// kD: D and Dv padded to a multiple of 64 (64, 128 or 256); kStages: depth
// of the K/V ring; kQBufs: Q buffers (2 lets the next item's Q load while
// this one runs); kWGs: consumer warpgroups, 64 rows each.  Persistent:
// CTA c takes items c, 2 gridDim.x - 1 - c, ... (item_index).  Q, K and V
// come in by TMA, O goes out by TMA from the item's Q buffer.
template <int kD, int kStages, int kQBufs, int kWGs>
__global__ void __launch_bounds__(128 * (kWGs + 1), 1)
flash_fwd_tc(const __grid_constant__ CUtensorMap qmap,
             const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap,
             const __grid_constant__ CUtensorMap omap, float* lse, int Sq,
             int Skv, int KV, int G, int P, int causal, float scale_log2,
             int n_pos_tiles, int BKV) {
  constexpr int kRows = 64 * kWGs;        // rows of a Q buffer, >= P G
  constexpr int kConsumers = 128 * kWGs;  // threads of the consumers
  constexpr int kConsumerRegs = kWGs == 2 ? 224 : 152;
  constexpr int kBlocks = kD / 64;                 // 128-byte column blocks
  constexpr int kQBlock = kRows * 128;             // bytes of a Q block
  constexpr int kQBytes = kBlocks * kQBlock;       // one Q buffer
  constexpr int kTileBlock = kBN * 128;            // bytes of a K/V block
  constexpr int kTileBytes = kBlocks * kTileBlock;  // one K (or V) tile
  constexpr int kStageBytes = 2 * kTileBytes;
  constexpr int kNc = kD < 128 ? kD : 128;  // columns of one P.V wgmma
  constexpr int kNcs = kD / kNc;
  constexpr int kS = kBN / 2;               // score registers per thread

  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t skv = sq + kQBufs * kQBytes;
  const uint32_t bars = skv + kStages * kStageBytes;
  // full[s] at bars + 8 s, empty[s] at bars + 8 (kStages + s); then for
  // Q buffer j: qfull[j] (its Q has landed), qempty[j] (its O has been
  // read out) and ofull[j] (its O is written)
  const uint32_t qbars = bars + 16 * kStages;

  const int tid = threadIdx.x;
  const int n_items = n_pos_tiles * BKV;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kStages + s), kConsumers / 32);
    }
#pragma unroll
    for (int j = 0; j < kQBufs; ++j) {
      mbar_init(qbars + 8 * j, 1);
      mbar_init(qbars + 8 * (kQBufs + j), 1);
      mbar_init(qbars + 8 * (2 * kQBufs + j), kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup's role, warp-uniform as the compiler sees it (a shuffle
  // from lane 0), so that each role's code gets its setmaxnreg budget
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (role == kConsumers / 128) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == kConsumers) {  // one thread keeps the K/V ring full
      int g = 0;  // tiles issued so far: the ring position
      for (int k = 0;; ++k) {
        const int i = item_index(k);
        if (i >= n_items) break;
        const Item it = item_of(i, BKV, KV, n_pos_tiles, P, Sq, Skv, causal);
        for (int t = 0; t < it.n_tiles; ++t, ++g) {
          const int s = g % kStages;
          if (g >= kStages)
            mbar_wait(bars + 8 * (kStages + s), ((g / kStages) - 1) & 1);
          const uint32_t full = bars + 8 * s;
          const uint32_t kdst = skv + s * kStageBytes;
          mbar_expect_tx(full, kStageBytes);
#pragma unroll
          for (int c = 0; c < kBlocks; ++c) {
            tma_load(kdst + c * kTileBlock, &kmap, full, 64 * c, it.kvh,
                     t * kBN, it.b);
            tma_load(kdst + kTileBytes + c * kTileBlock, &vmap, full, 64 * c,
                     it.kvh, t * kBN, it.b);
          }
        }
      }
    } else if (tid == kConsumers + 32) {
      // another thread loads each item's Q: a box of 64 columns x G heads
      // x P positions a block, rows p G + g, zeros past Sq and D
      for (int j = 0;; ++j) {  // j: items loaded so far
        const int i = item_index(j);
        if (i >= n_items) break;
        const Item it = item_of(i, BKV, KV, n_pos_tiles, P, Sq, Skv, causal);
        const int qb = j % kQBufs;
        if (j >= kQBufs)
          mbar_wait(qbars + 8 * (kQBufs + qb), ((j / kQBufs) - 1) & 1);
        const uint32_t full = qbars + 8 * qb;
        mbar_expect_tx(full, kBlocks * 128 * G * P);
#pragma unroll
        for (int c = 0; c < kBlocks; ++c)
          tma_load(sq + qb * kQBytes + c * kQBlock, &qmap, full, 64 * c,
                   it.kvh * G, it.pos0, it.b);
      }
    } else if (tid == kConsumers + 64) {
      // a third stores each item's O (P G rows of its Q buffer; nothing
      // past Sq and Dv is written) once the consumers have written it,
      // and frees the buffer when the store has read it.  (A TMA store
      // issued from a consumer warpgroup's path makes the compiler
      // serialise the wgmmas.)
      for (int j = 0;; ++j) {
        const int i = item_index(j);
        if (i >= n_items) break;
        const Item it = item_of(i, BKV, KV, n_pos_tiles, P, Sq, Skv, causal);
        const int qb = j % kQBufs;
        mbar_wait(qbars + 8 * (2 * kQBufs + qb), (j / kQBufs) & 1);
#pragma unroll
        for (int c = 0; c < kBlocks; ++c)
          tma_store(&omap, sq + qb * kQBytes + c * kQBlock, 64 * c,
                    it.kvh * G, it.pos0, it.b);
        bulk_wait<true>();
        mbar_arrive(qbars + 8 * (kQBufs + qb));
      }
      bulk_wait<false>();  // the last stores have landed
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = role, wt = tid & 127, warp = wt >> 5, lane = tid & 31;
  const int col0 = 2 * (lane & 3);
  // this thread's two accumulator rows of the item: 64 wg + 16 warp +
  // lane / 4 + 8 h, a row being p G + g
  const int row[2] = {wg * 64 + warp * 16 + lane / 4,
                      wg * 64 + warp * 16 + lane / 4 + 8};

  float sc[kS];
  float acc[kNcs][kNc / 2];
  uint32_t p[kBN / 16][4];
#pragma unroll
  for (int i = 0; i < kS; ++i) sc[i] = 0.f;
  uint32_t qdesc_base = 0;

  // S = Q K^T of the tile in stage st: kD / 16 steps of k16; a step
  // advances 32 bytes inside a 128-byte swizzled row, four steps a block
  auto issue_s = [&](int st) {
    const uint32_t kbase = skv + st * kStageBytes;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_ss(sc,
               desc(qdesc_base + (kk / 4) * kQBlock + (kk % 4) * 32, 16, 1024),
               desc(kbase + (kk / 4) * kTileBlock + (kk % 4) * 32, 16, 1024),
               kk > 0);
    wgmma_commit();
  };
  // O += P V of the tile in stage st: V MN-major, 16 positions (2048
  // bytes) a k16 step; LBO steps between 64-column blocks, SBO between
  // groups of 8 positions
  auto issue_pv = [&](int st) {
    const uint32_t vbase = skv + st * kStageBytes + kTileBytes;
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
      for (int c = 0; c < kNcs; ++c)
        wgmma_rs(acc[c], p[kk],
                 desc(vbase + c * (kNc / 64) * kTileBlock + kk * 2048,
                      kTileBlock, 1024));
    wgmma_commit();
  };
  auto pin_pv = [&]() {
#pragma unroll
    for (int c = 0; c < kNcs; ++c) pin(acc[c]);
    pin(p);
  };
  // P in bf16 as wgmma's A fragment: the accumulator of columns
  // 16 kk .. 16 kk + 15 is the A layout of the k16 step kk
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      p[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
      p[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      p[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      p[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
  };

  int g = 0;  // tiles consumed so far: the ring position
  for (int j = 0;; ++j) {  // j: items taken so far
    const int i = item_index(j);
    if (i >= n_items) break;
    const Item it = item_of(i, BKV, KV, n_pos_tiles, P, Sq, Skv, causal);
    const int qb = j % kQBufs;
    const uint32_t qbuf = sq + qb * kQBytes;
    qdesc_base = qbuf + wg * 64 * 128;
    int qpos[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) qpos[h] = it.pos0 + row[h] / G;
    // tiles before n_full are unmasked for every row of the warpgroup
    const int q_first = it.pos0 + wg * 64 / G;
    const int n_full =
        causal ? (q_first + 1 < Skv ? q_first + 1 : Skv) / kBN : Skv / kBN;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, corr[2];
#pragma unroll
    for (int c = 0; c < kNcs; ++c)
#pragma unroll
      for (int x = 0; x < kNc / 2; ++x) acc[c][x] = 0.f;

    mbar_wait(qbars + 8 * qb, (j / kQBufs) & 1);

    // Every wgmma sits on the warpgroup's uniform path (a wgmma under a
    // branch makes the compiler serialise them all).  Tile 0: S_0, its
    // softmax, P_0.
    mbar_wait(bars + 8 * (g % kStages), (g / kStages) & 1);
    pin(sc);
    wgmma_fence();
    issue_s(g % kStages);
    wgmma_wait<0>();
    pin(sc);
    softmax_tile(sc, m, l, corr, 0 >= n_full, 0, col0, Skv, causal, qpos,
                 scale_log2);
    pack_p();
    // Tile t: S_t is issued, then P_{t-1} V_{t-1} behind it; the softmax
    // of S_t runs while the tensor cores finish P_{t-1} V_{t-1}; then the
    // accumulator is rescaled and P_t rounded to bf16.
    for (int t = 1; t < it.n_tiles; ++t) {
      const int s = (g + t) % kStages, sp = (g + t - 1) % kStages;
      mbar_wait(bars + 8 * s, ((g + t) / kStages) & 1);
      pin(sc);
      pin_pv();
      wgmma_fence();
      issue_s(s);
      issue_pv(sp);
      wgmma_wait<1>();  // S_t is done; P_{t-1} V_{t-1} may still run
      pin(sc);
      softmax_tile(sc, m, l, corr, t >= n_full, t * kBN, col0, Skv, causal,
                   qpos, scale_log2);
      wgmma_wait<0>();
      pin_pv();
      if (lane == 0) mbar_arrive(bars + 8 * (kStages + sp));  // done with sp
#pragma unroll
      for (int c = 0; c < kNcs; ++c)
#pragma unroll
        for (int n = 0; n < kNc / 8; ++n)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            acc[c][4 * n + 2 * h] *= corr[h];
            acc[c][4 * n + 2 * h + 1] *= corr[h];
          }
      pack_p();
    }
    // the last tile's P V (n_tiles >= 1: every row has key 0)
    const int s_last = (g + it.n_tiles - 1) % kStages;
    pin_pv();
    wgmma_fence();
    issue_pv(s_last);
    wgmma_wait<0>();
    pin_pv();
    if (lane == 0) mbar_arrive(bars + 8 * (kStages + s_last));
    g += it.n_tiles;

    // Epilogue: O = acc / l in bf16 into this warpgroup's rows of the Q
    // buffer (its own reads of Q are done), in Q's swizzled layout; each
    // warp then tells the producer's storing thread.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      const float inv = 1.f / fmaxf(l[h], 1e-30f);
      // the row's log-sum-exp of the scaled scores (m is in score units),
      // for the backward pass
      if (lse != nullptr && (lane & 3) == 0 && row[h] < P * G &&
          it.pos0 + row[h] / G < Sq)
        lse[(static_cast<long long>(it.b) * KV * G + it.kvh * G + row[h] % G) *
                Sq +
            it.pos0 + row[h] / G] =
            (m[h] * scale_log2 + log2f(l[h])) * 0.6931471805599453f;
      // the 16-byte chunk j of the row sits at chunk j ^ (row % 8): with
      // bits 4-6 of x set to row % 8, x ^ (j << 4) is its address (the
      // offsets stay constants, not 32 registers)
      const uint32_t x =
          qbuf + row[h] * 128 + ((row[h] % 8) << 4) + col0 * 2;
#pragma unroll
      for (int c = 0; c < kNcs; ++c)
#pragma unroll
        for (int n = 0; n < kNc / 8; ++n) {
          const int colb = c * kNc + 8 * n;  // the column block's first
          st_shared((x + (colb / 64) * kQBlock) ^ (((colb % 64) / 8) << 4),
                    pack_bf16(acc[c][4 * n + 2 * h] * inv,
                              acc[c][4 * n + 2 * h + 1] * inv));
        }
    }
    // the generic-proxy writes before the TMA store (async proxy) reads
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (lane == 0) mbar_arrive(qbars + 8 * (2 * kQBufs + qb));
  }
}

// The tensor map of q, k, v or o (B, S, heads, width) with element strides
// st = (batch, position, head): dims innermost first (width, heads, S, B),
// boxes of 64 columns x box_heads heads x box_rows positions x 1 batch,
// 128-byte swizzle, zeros past every edge on loads, nothing written past
// them on stores.
bool tile_map(CUtensorMap* map, const void* ptr, int width, int heads, int S,
              int B, const long long* st, int box_heads, int box_rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(width),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[2]) * 2,
                                 static_cast<cuuint64_t>(st[1]) * 2,
                                 static_cast<cuuint64_t>(st[0]) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(box_heads),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kD, int kStages, int kQBufs, int kWGs>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Sq, int Skv, int H, int KV, int D, int Dv, int causal,
           const long long* st, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes(kD, kStages, kQBufs, kWGs);
  constexpr int kRows = 64 * kWGs;
  const int G = H / KV;
  if (G > kRows) return static_cast<int>(cudaErrorInvalidValue);
  const int P = kRows / G;  // query positions of an item
  static bool opted_in = false;  // opt in to the shared memory once
  if (!opted_in) {
    cudaFuncSetAttribute(flash_fwd_tc<kD, kStages, kQBufs, kWGs>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(bytes));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  CUtensorMap qmap, kmap, vmap, omap;
  if (!tile_map(&qmap, q, D, H, Sq, B, st, G, P) ||
      !tile_map(&kmap, k, D, KV, Skv, B, st + 3, 1, kBN) ||
      !tile_map(&vmap, v, Dv, KV, Skv, B, st + 6, 1, kBN) ||
      !tile_map(&omap, o, Dv, H, Sq, B, st + 9, G, P))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_pos_tiles = (Sq + P - 1) / P;
  const long long n_items = n_pos_tiles * B * KV;
  if (n_items > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, n_sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, dev);
  const int n_ctas = static_cast<int>(n_items < n_sms ? n_items : n_sms);
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(D));
  constexpr int kThreads = 128 * (kWGs + 1);
  flash_fwd_tc<kD, kStages, kQBufs, kWGs><<<n_ctas, kThreads, bytes, stream>>>(
      qmap, kmap, vmap, omap, lse, Sq, Skv, KV, G, P, causal, scale_log2,
      static_cast<int>(n_pos_tiles), B * KV);
  return static_cast<int>(cudaGetLastError());
}

// D and Dv padded to 64, 128 or 256.  At 64 and 128: three consumer
// warpgroups (192 rows an item), a ring of 4, two Q buffers (112 and 224
// KB of shared memory).  At 256 the f32 accumulator takes 128 registers a
// thread: two warpgroups, a ring of 2, one Q buffer (192 KB).
int launch_tc(const void* q, const void* k, const void* v, void* o,
              float* lse, int B, int Sq, int Skv, int H, int KV, int D,
              int Dv, int causal, const long long* st, void* stream) {
  if (D < 16 || D > 256 || Dv < 16 || Dv > 256 || D % 16 != 0 ||
      Dv % 16 != 0 || KV < 1 || H % KV != 0 || H / KV > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < 12; ++i)  // q, k, v, o rows 16-byte aligned
    if (st[i] <= 0 || st[i] % 8 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(q) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(k) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(o) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int w = D > Dv ? D : Dv;
  if (w <= 64)
    return launch<64, 4, 2, 3>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, Dv,
                                 causal, st, s);
  if (w <= 128)
    return launch<128, 4, 2, 3>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, Dv,
                                 causal, st, s);
  return launch<256, 2, 1, 2>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, Dv,
                                 causal, st, s);
}

}  // namespace tc
}  // namespace

// strides: 12 element strides, (batch, position, head) of q, k, v and o;
// lse: null, or the (B, H, Sq) f32 log-sum-exp of each row's scaled scores
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   void* o, float* lse, int B, int Sq,
                                   int Skv, int H, int KV, int D, int Dv,
                                   int causal, const long long* strides,
                                   void* stream) {
  return launch<float>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, Dv, causal,
                       strides, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, float* lse, int B,
                                    int Sq, int Skv, int H, int KV, int D,
                                    int Dv, int causal,
                                    const long long* strides, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, Dv,
                               causal, strides, stream);
}

extern "C" int flash_attention_bf16_tc(const void* q, const void* k,
                                       const void* v, void* o, float* lse,
                                       int B, int Sq, int Skv, int H, int KV,
                                       int D, int Dv, int causal,
                                       const long long* strides,
                                       void* stream) {
  return tc::launch_tc(q, k, v, o, lse, B, Sq, Skv, H, KV, D, Dv, causal,
                       strides, stream);
}
