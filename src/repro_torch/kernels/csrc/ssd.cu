// Mamba2 SSD (state-space duality) chunked scan for Hopper (sm_90a).
//
// For each (batch b, head h), with xd = x * dt and dA = dt * A[h], walking
// the chunks of Q positions in order with a carried (P, N) state:
//
//   cum   = cumsum(dA)                                          (Q,)
//   y     = ((C B^T) o L) xd + (C state^T) o exp(cum)           (Q, P)
//           L[q, k] = exp(cum_q - cum_k) for q >= k, else 0
//   state = state * exp(cum_Q) + (xd o exp(cum_Q - cum))^T B    (P, N)
//
// Head h reads group h / (H / G) of B and C.  y and the final state are
// f32; the carried state stays f32 from chunk to chunk.
//
// Replaces the Pallas kernel src/repro/kernels/ssd.py::ssd (body _kernel),
// the twin of the reference model's XLA ssd_chunked, which the Mamba2
// prefill (models/ssm.py::mamba2_fwd) calls once per layer.
//
// Bound.  At the serving path's shape (B=8, L=1024, H=64, P=64, N=128,
// Q=256, bf16 x, B, C) the function moves ~224 MB (x 67 MB read, y 134 MB
// of f32 written, the f32 state 17 MB, B, C and dt ~6 MB): ~0.067 ms at
// 3.35 TB/s.  Its products are ~26 GFLOP with C B^T counted once per
// (batch, group, chunk), ~0.026 ms at the 989 TFLOP/s bf16 rate, so bytes
// bind.  In f32 (~0.39 ms at 67 TFLOP/s) operations bind.
//
// Two kernels (the Python wrapper's _variant picks):
//
// * ssd_tc (bf16 with P <= 64, N <= 128, both multiples of 8, Q <= 256,
//   16-byte aligned rows): the four products on the tensor cores,
//   mma.sync m16n8k16 with bf16 operands and f32 accumulators.  A CTA of
//   8 warps takes one (b, h) at a time and walks its chunks in order, so
//   the state recurrence keeps the reference's order and no per-chunk
//   state goes to memory; the CTAs are persistent (as many as are
//   resident at once, each walking (b, h) = blockIdx.x + k gridDim.x).
//   A chunk's C, B and x rows sit in shared memory as bf16 (16-byte
//   chunks XOR-swizzled by row, so ldmatrix is conflict-free), copied by
//   16-byte cp.async in two groups that overlap the products: the next
//   chunk's C (of this (b, h) or the next) streams in during this chunk's
//   state update, its B and x during its own state term.  Per chunk:
//   (i)   y_q  = exp(cum_q) * C_q state^T, the state read as a bf16 hi +
//         lo pair (the f32 state itself is never rounded);
//   (ii)  y_q += S~ x_k over the k at or below q, S = C_q B_k^T in f32,
//         S~ = S * exp(cum_q - cum_k) * dt_k, on the diagonal block a
//         select on the causal triangle (never a product with a mask:
//         exp above it overflows, and inf * 0 is NaN), split into a bf16
//         hi + lo pair straight from the accumulator registers (the
//         m16n8 accumulator layout is the A operand's); x stays exact;
//   (iii) state = state * exp(cum_Q) + (x o w)^T B, w = dt exp(cum_Q -
//         cum), x o w as a bf16 hi + lo pair, accumulated in the f32
//         registers that hold the state from chunk to chunk.
//   One bf16 in place of any of the three pairs moves some y past the
//   4e-2 tolerance (tests/test_torch_ssm.py emulates the rounding points
//   on the CPU); a pair keeps ~16 bits.  The 16-row strips of y go two to
//   a warp, strips w and 15 - w, so the causal work is even across the
//   warps.  Every chunk's prefix sum of dA is taken up front, one thread
//   per chunk adding in order (a warp-parallel scan moved f32 results
//   past 2e-4 in the FMA kernel), for a window of up to kWindow positions
//   at a time, and kept in log2 units for ex2.  The hi + lo pairs and the
//   per-head C B^T make the tensor work ~89 GFLOP at the path shape, 3.4x
//   the function's ~26: the kernel is bound by its mma.sync products, not
//   by its bytes.
//
// * ssd_fwd (f32, and bf16 inputs the other does not take): f32 FMAs.
//   One CTA per (b, h); the Pallas grid's sequential chunk axis is
//   a loop inside the CTA, and the (P, N) state (32 KB at P=64, N=128) stays
//   in shared memory from chunk to chunk.  Per chunk: dt is staged and one
//   thread takes the prefix sum of dA in order, as a plain cumsum does: the
//   decay exp(cum_q - cum_k) takes the difference of two sums that reach
//   hundreds, so the order of the additions shows in the f32 result (a
//   warp-parallel scan moved it by more than 2e-4 at L=1024, N=128), and
//   the Q dependent adds cost ~1 us of the call.  Then 64-row
//   q-tiles of C go against the 64-row k-tiles of B and xd at or below them
//   (the tiles above the diagonal are never visited): S = C_q B_k^T, the
//   decay selected on the causal triangle before the exp, then S xd_k;
//   then the incoming-state term C_q state^T scaled by exp(cum_q).  Only
//   after every q-tile has read the old state is it decayed and updated,
//   k-tile by k-tile, each thread holding its 4 x 8 block of the state in
//   registers.  256 threads as 16 x 16: of a 64 x 64 tile a thread owns
//   rows 4 ty + i and columns tx + 16 j.  Rows of the shared tiles are
//   padded to N + 1 floats so the column walks are free of bank
//   conflicts.  ~133 KB of dynamic shared memory at P=64, N=128: one CTA
//   per SM.  x, B and C may be f32 or bf16 and are cast on load.
//
// Training asks either kernel for each chunk's incoming state as well
// (a (B, L / Q, H, P, N) f32 output, written only when given a pointer,
// so serving is unchanged): the backward kernel (ssd_bwd.cu) starts
// every chunk from it.
//
// x, dt, B and C are read in the model's (B, L, heads, dim) layout with
// element strides for batch, position and head (or group); their last dim
// must be contiguous.  y (B, L, H, P) and the state (B, H, P, N) are
// written contiguous.  The C entry points return cudaGetLastError() after
// the launch (or cudaErrorInvalidValue for arguments they refuse); the
// Python wrapper raises on a non-zero code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kTile = 64;      // positions of a q- or k-tile
constexpr int kLdS = kTile + 1;
constexpr int kMaxP = 64;      // head dim: 16 tx x 4 columns
constexpr int kMaxN = 128;     // state dim: 16 tx x 8 columns in the update

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

struct Strides {
  long long b, l, h;  // elements; the last dim is contiguous
};

size_t smem_bytes(int P, int N, int Q) {
  const size_t ldn = static_cast<size_t>(N) + 1;
  return sizeof(float) * (P * ldn                 // the carried state
                          + 2 * kTile * ldn       // C and B tiles
                          + kTile * kLdS          // the score tile
                          + kTile * static_cast<size_t>(P)  // the xd tile
                          + 2 * static_cast<size_t>(Q));    // dt, cum
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ssd_fwd(const T* __restrict__ x, const float* __restrict__ dt,
        const float* __restrict__ A, const T* __restrict__ Bm,
        const T* __restrict__ Cm, float* __restrict__ y,
        float* __restrict__ state_out, float* __restrict__ states,
        Strides xs, Strides ds, Strides bs, Strides cs, int L, int H, int G,
        int P, int N, int Q) {
  extern __shared__ __align__(16) float smem[];
  const int ldn = N + 1;
  float* St = smem;               // P x ldn
  float* Cs = St + P * ldn;       // kTile x ldn
  float* Bs = Cs + kTile * ldn;   // kTile x ldn
  float* Ss = Bs + kTile * ldn;   // kTile x kLdS
  float* Xs = Ss + kTile * kLdS;  // kTile x P
  float* dts = Xs + kTile * P;    // Q
  float* cum = dts + Q;           // Q

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int g = h / (H / G);
  const float a = A[h];
  const T* xb = x + b * xs.b + h * xs.h;
  const float* db = dt + b * ds.b + h * ds.h;
  const T* Bb = Bm + b * bs.b + g * bs.h;
  const T* Cb = Cm + b * cs.b + g * cs.h;
  const long long y_row = static_cast<long long>(H) * P;  // y's position stride
  float* yb = y + (static_cast<long long>(b) * L * H + h) * P;

  for (int i = tid; i < P * ldn; i += kThreads) St[i] = 0.f;

  const int n_chunks = L / Q;
  for (int c = 0; c < n_chunks; ++c) {
    const long long l0 = static_cast<long long>(c) * Q;
    __syncthreads();  // the last chunk's update of St and reads of cum are done
    if (states != nullptr) {  // the chunk's incoming state, for training
      float* sc = states + ((static_cast<long long>(b) * n_chunks + c) * H + h) *
                               P * N;
      for (int i = tid; i < P * N; i += kThreads) {
        const int p = i / N, n = i - p * N;
        sc[i] = St[p * ldn + n];
      }
    }
    for (int i = tid; i < Q; i += kThreads) {
      const float d = db[(l0 + i) * ds.l];
      dts[i] = d;
      cum[i] = d * a;
    }
    __syncthreads();
    if (tid == 0) {  // inclusive prefix sum of dA, in order
      float run = 0.f;
      for (int i = 0; i < Q; ++i) {
        run += cum[i];
        cum[i] = run;
      }
    }
    __syncthreads();
    const float cum_last = cum[Q - 1];

    for (int q0 = 0; q0 < Q; q0 += kTile) {
      const int nq = min(kTile, Q - q0);
      __syncthreads();  // the last q-tile's reads of Cs are done
      for (int i = tid; i < kTile * N; i += kThreads) {
        const int r = i / N, n = i - r * N;
        Cs[r * ldn + n] =
            r < nq ? to_f32(Cb[(l0 + q0 + r) * cs.l + n]) : 0.f;
      }
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

      for (int k0 = 0; k0 <= q0; k0 += kTile) {
        const int nk = min(kTile, Q - k0);
        __syncthreads();  // the last k-tile's reads of Bs, Xs and Ss are done
        for (int i = tid; i < kTile * N; i += kThreads) {
          const int r = i / N, n = i - r * N;
          Bs[r * ldn + n] =
              r < nk ? to_f32(Bb[(l0 + k0 + r) * bs.l + n]) : 0.f;
        }
        for (int i = tid; i < kTile * P; i += kThreads) {
          const int r = i / P, p = i - r * P;
          Xs[r * P + p] =
              r < nk ? to_f32(xb[(l0 + k0 + r) * xs.l + p]) * dts[k0 + r]
                     : 0.f;
        }
        __syncthreads();

        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = Cs[(ty * 4 + i) * ldn + n];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = Bs[(tx + 16 * j) * ldn + n];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = fmaf(cv[i], bv[j], s[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = ty * 4 + i, qi = q0 + r;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = tx + 16 * j, kj = k0 + col;
            // select on the causal triangle before the exp
            const bool ok = r < nq && col < nk && kj <= qi;
            const float seg = cum[min(qi, Q - 1)] - cum[min(kj, Q - 1)];
            Ss[r * kLdS + col] = ok ? s[i][j] * expf(seg) : 0.f;
          }
        }
        __syncthreads();

        for (int kk = 0; kk < nk; ++kk) {
          float sv[4], xv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) sv[i] = Ss[(ty * 4 + i) * kLdS + kk];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int p = tx + 16 * j;
            xv[j] = p < P ? Xs[kk * P + p] : 0.f;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(sv[i], xv[j], acc[i][j]);
        }
      }

      // the incoming state: exp(cum_q) * C_q St^T
      float o[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = Cs[(ty * 4 + i) * ldn + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tx + 16 * j;
          sv[j] = p < P ? St[p * ldn + n] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) o[i][j] = fmaf(cv[i], sv[j], o[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        if (r >= nq) continue;
        const float e = expf(cum[q0 + r]);
        float* yrow = yb + (l0 + q0 + r) * y_row;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tx + 16 * j;
          if (p < P) yrow[p] = fmaf(e, o[i][j], acc[i][j]);
        }
      }
    }

    // the state update, after every q-tile has read the old state
    __syncthreads();
    const float decay = expf(cum_last);
    float st[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = tx + 16 * j;
        st[i][j] = (p < P && n < N) ? St[p * ldn + n] * decay : 0.f;
      }
    }
    for (int k0 = 0; k0 < Q; k0 += kTile) {
      const int nk = min(kTile, Q - k0);
      __syncthreads();  // the last k-tile's reads of Bs and Xs are done
      for (int i = tid; i < kTile * N; i += kThreads) {
        const int r = i / N, n = i - r * N;
        Bs[r * ldn + n] = r < nk ? to_f32(Bb[(l0 + k0 + r) * bs.l + n]) : 0.f;
      }
      for (int i = tid; i < kTile * P; i += kThreads) {
        const int r = i / P, p = i - r * P;
        Xs[r * P + p] =
            r < nk ? to_f32(xb[(l0 + k0 + r) * xs.l + p]) * dts[k0 + r] *
                         expf(cum_last - cum[k0 + r])
                   : 0.f;
      }
      __syncthreads();
      for (int kk = 0; kk < nk; ++kk) {
        float w[4], bv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int p = ty + 16 * i;
          w[i] = p < P ? Xs[kk * P + p] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = tx + 16 * j;
          bv[j] = n < N ? Bs[kk * ldn + n] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) st[i][j] = fmaf(w[i], bv[j], st[i][j]);
      }
    }
    // each thread writes back only the elements it read: no other thread
    // touches them until the next chunk's first barrier
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = tx + 16 * j;
        if (p < P && n < N) St[p * ldn + n] = st[i][j];
      }
    }
  }

  __syncthreads();
  float* so = state_out + static_cast<long long>(bh) * P * N;
  for (int i = tid; i < P * N; i += kThreads) {
    const int p = i / N, n = i - p * N;
    so[i] = St[p * ldn + n];
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* y, void* state, void* states, int Bsz, int L,
           int H, int G, int P, int N, int Q, const long long* st,
           void* stream) {
  if (Bsz < 1 || L < 1 || Q < 1 || L % Q != 0 || G < 1 || H % G != 0 ||
      P < 1 || P > kMaxP || N < 1 || N > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  static int optin = 0;  // opt in to the card's full shared memory once
  if (optin == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    cudaFuncSetAttribute(ssd_fwd<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) {
      optin = 0;
      return static_cast<int>(err);
    }
  }
  const size_t bytes = smem_bytes(P, N, Q);
  if (bytes > static_cast<size_t>(optin))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides xs{st[0], st[1], st[2]}, ds{st[3], st[4], st[5]},
      bs{st[6], st[7], st[8]}, cs{st[9], st[10], st[11]};
  ssd_fwd<T><<<Bsz * H, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<float*>(y),
      static_cast<float*>(state), static_cast<float*>(states), xs, ds, bs, cs,
      L, H, G, P, N, Q);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------
// tensor-core kernel (bf16)
using namespace hopper;

constexpr int kTcThreads = 256;  // 8 warps
constexpr int kTcP = 64;         // x and y columns, P padded to 64
constexpr int kTcMaxQ = 256;     // chunk rows held in shared memory
constexpr int kWindow = 1024;    // positions of dt and cum held at once
constexpr float kLog2e = 1.4426950408889634f;

// byte offset of 16-byte chunk c of row r in a tile of kChunks (a
// multiple of 8) chunks a row: chunk c sits at c ^ (r % 8)
template <int kChunks>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * kChunks * 16 + ((c ^ (r & 7)) << 4));
}

// kN: N padded to 64 or 128
template <int kN>
struct Tc {
  static constexpr int kNC = kN / 8;    // 16-byte chunks of a C, B, state row
  static constexpr int kPC = kTcP / 8;  // ... of an x row
  static constexpr int kKN = kN / 16;   // k-steps over N
  static constexpr int kPT = kTcP / 8;  // n8 tiles of a y row
  // the state: warp w owns rows 16 (w / 2) + [0, 16) and columns
  // kSN (w % 2) + [0, kSN)
  static constexpr int kSN = kN / 2;
  static constexpr int kST = kSN / 8;   // ... in n8 tiles
  static size_t smem(int Qp) {
    return static_cast<size_t>(Qp) * (2 * kN + kTcP) * 2  // C, B, x
           + 2 * static_cast<size_t>(kTcP) * kN * 2       // state hi, lo
           + sizeof(float) * (2 * kWindow + 2 * kTcMaxQ);  // dt, cum, e, w
  }
};

// rows l0 + [0, Qp) of a (position, width) bf16 operand into a swizzled
// shared tile by 16-byte cp.async, in this thread's current group; zeros
// at rows >= Q and columns >= width
template <int kChunks>
__device__ __forceinline__ void stage_rows(uint32_t dst,
                                           const __nv_bfloat16* src,
                                           long long ls, long long l0,
                                           int width, int Q, int Qp,
                                           int tid) {
  // a thread keeps its chunk c and steps its rows by kRows, so the
  // swizzle and the source column stay fixed
  constexpr int kRows = kTcThreads / kChunks;
  const int c = tid % kChunks;
  const bool col_in = 8 * c < width;
  int r = tid / kChunks;
  uint32_t d = dst + swz<kChunks>(r, c);
  const __nv_bfloat16* s = src + (l0 + r) * ls + 8 * c;
  const long long step = kRows * ls;
  for (; r < Qp; r += kRows, d += kRows * kChunks * 16, s += step) {
    const bool in = col_in && r < Q;
    cp_async16(d, in ? s : src, in);
  }
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (v0, v1) as a bf16 hi + lo pair: hi = bf16(v), lo = bf16(v - hi)
__device__ __forceinline__ void split(float v0, float v1, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 f = __bfloat1622float2(h);
  hi = bits(h);
  lo = pack_bf16(v0 - f.x, v1 - f.y);
}

// the two bf16 of v scaled by (w0, w1) in f32, as a hi + lo pair
__device__ __forceinline__ void scale_split(uint32_t v, float w0, float w1,
                                            uint32_t& hi, uint32_t& lo) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
  split(f.x * w0, f.y * w1, hi, lo);
}

template <int kN>
__global__ void __launch_bounds__(kTcThreads, 1)
ssd_tc(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
       const float* __restrict__ A, const __nv_bfloat16* __restrict__ Bm,
       const __nv_bfloat16* __restrict__ Cm, float* __restrict__ y,
       float* __restrict__ state_out, float* __restrict__ states, Strides xs,
       Strides ds, Strides bs, Strides cs, int Bsz, int L, int H, int G, int P,
       int N, int Q) {
  using T = Tc<kN>;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  const int Qp = (Q + 15) & ~15;
  const uint32_t sC = smem_u32(smem_raw);
  const uint32_t sB = sC + Qp * kN * 2;
  const uint32_t sX = sB + Qp * kN * 2;
  const uint32_t sHi = sX + Qp * kTcP * 2;  // the state's bf16 hi + lo
  const uint32_t sLo = sHi + kTcP * kN * 2;
  float* dts = reinterpret_cast<float*>(smem_raw + (sLo + kTcP * kN * 2 - sC));
  float* cum = dts + kWindow;
  float* ee = cum + kWindow;  // exp(cum_q) of the chunk's rows
  float* ww = ee + kTcMaxQ;   // dt_k exp(cum_Q - cum_k)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t2 = 2 * (lane & 3);  // a fragment's row, column
  const long long y_row = static_cast<long long>(H) * P;  // y's position stride
  const int nc = L / Q, per_window = kWindow / Q, items = Bsz * H;
  // this warp's 16-row strips of y, w and 15 - w (those below Q), and its
  // block of the state
  const int strip[2] = {warp, 15 - warp};
  const bool has[2] = {16 * strip[0] < Q, 16 * strip[1] < Q};
  const int sp0 = 16 * (warp >> 1), sn0 = T::kSN * (warp & 1);

  // The CTA walks its items (b, h) = blockIdx.x + k gridDim.x and each
  // item's chunks in order; the copies of the next (item, chunk)'s tiles
  // overlap this one's products, across items too.
  auto x_of = [&](int it) {
    return x + (it / H) * xs.b + (it % H) * xs.h;
  };
  auto b_of = [&](const __nv_bfloat16* m, const Strides& ms, int it) {
    return m + (it / H) * ms.b + ((it % H) / (H / G)) * ms.h;
  };
  int it = blockIdx.x;
  if (it >= items) return;
  stage_rows<T::kNC>(sC, b_of(Cm, cs, it), cs.l, 0, N, Q, Qp, tid);
  cp_async_commit();
  stage_rows<T::kNC>(sB, b_of(Bm, bs, it), bs.l, 0, N, Q, Qp, tid);
  stage_rows<T::kPC>(sX, x_of(it), xs.l, 0, P, Q, Qp, tid);
  cp_async_commit();

  float st[T::kST][4];
  for (; it < items; it += gridDim.x) {
    const int b = it / H, h = it - b * H;
    const float a = A[h];
    const float* db = dt + b * ds.b + h * ds.h;
    float* yb = y + (static_cast<long long>(b) * L * H + h) * P;
#pragma unroll
    for (int j = 0; j < T::kST; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) st[j][i] = 0.f;

    for (int c = 0; c < nc; ++c) {
      const long long l0 = static_cast<long long>(c) * Q;
      const int slot = c % per_window;
      if (states != nullptr) {  // the chunk's incoming state, for training
        float* sc = states + ((static_cast<long long>(b) * nc + c) * H + h) *
                                 P * N;
#pragma unroll
        for (int j = 0; j < T::kST; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int p = sp0 + g8 + 8 * hh, n = sn0 + 8 * j + t2;
            if (p < P && n < N)
              *reinterpret_cast<float2*>(sc + p * N + n) =
                  make_float2(st[j][2 * hh], st[j][2 * hh + 1]);
          }
      }
      if (slot == 0) {
        // dt of the window's chunks, then each chunk's inclusive prefix
        // sum of dA, in order, one thread a chunk (__fmul_rn: dA is
        // rounded before the add, as the plain version's cumsum takes it)
        const int here = min(per_window, nc - c);
        for (int i = tid; i < here * Q; i += kTcThreads)
          dts[i] = db[(l0 + i) * ds.l];
        __syncthreads();
        if (tid < here) {
          const float* d = dts + tid * Q;
          float* out = cum + tid * Q;
          float run = 0.f;
          int i = 0;
          for (; i + 8 <= Q; i += 8) {  // eight loads ahead of the adds
            float v[8];
#pragma unroll
            for (int j = 0; j < 8; ++j) v[j] = __fmul_rn(d[i + j], a);
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              run += v[j];
              out[i + j] = run * kLog2e;
            }
          }
          for (; i < Q; ++i) {
            run += __fmul_rn(d[i], a);
            out[i] = run * kLog2e;
          }
        }
        __syncthreads();
      }
      const float* cq = cum + slot * Q;  // in log2 units
      const float* dq = dts + slot * Q;
      const float tot = cq[Q - 1];
      for (int i = tid; i < Qp; i += kTcThreads) {
        const bool in = i < Q;
        ee[i] = in ? ex2(cq[i]) : 0.f;
        ww[i] = in ? dq[i] * ex2(tot - cq[i]) : 0.f;
      }
      cp_async_wait<1>();  // this thread's copies of the chunk's C
      __syncthreads();     // ... every thread's; e, w and the state pair

      // (i) y = exp(cum_q) C_q state^T, for both strips; acc[i][j][2 hh +
      // jj] is row 16 strip[i] + g8 + 8 hh, column 8 j + t2 + jj
      float acc[2][T::kPT][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < T::kPT; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
      if (c > 0) {  // the state is zero before the first chunk
        // both strips against each fragment of the state pair
#pragma unroll
        for (int kk = 0; kk < T::kKN; ++kk) {
          uint32_t af[2][4];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            if (has[i])
              ldmatrix_x4(af[i], sC + swz<T::kNC>(16 * strip[i] + (lane & 15),
                                                  2 * kk + (lane >> 4)));
#pragma unroll
          for (int jp = 0; jp < T::kPT / 2; ++jp) {
            const uint32_t off = swz<T::kNC>(
                16 * jp + (lane & 7) + 8 * (lane >> 4),
                2 * kk + ((lane >> 3) & 1));
            uint32_t hi[4], lo[4];
            ldmatrix_x4(hi, sHi + off);
            ldmatrix_x4(lo, sLo + off);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              if (!has[i]) continue;
              mma_bf16(acc[i][2 * jp], af[i], hi[0], hi[1]);
              mma_bf16(acc[i][2 * jp + 1], af[i], hi[2], hi[3]);
            }
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              if (!has[i]) continue;
              mma_bf16(acc[i][2 * jp], af[i], lo[0], lo[1]);
              mma_bf16(acc[i][2 * jp + 1], af[i], lo[2], lo[3]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (!has[i]) continue;
          const int q0 = 16 * strip[i];
          const float e0 = ee[q0 + g8], e1 = ee[q0 + g8 + 8];
#pragma unroll
          for (int j = 0; j < T::kPT; ++j) {
            acc[i][j][0] *= e0;
            acc[i][j][1] *= e0;
            acc[i][j][2] *= e1;
            acc[i][j][3] *= e1;
          }
        }
      }

      cp_async_wait<0>();  // this thread's copies of the chunk's B and x
      __syncthreads();     // ... every thread's

      // (ii) y += S~ x over the 16-position k-blocks at or below each strip
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (!has[i]) continue;
        const int q0 = 16 * strip[i];
        uint32_t cf[T::kKN][4];  // C_q's A fragments
#pragma unroll
        for (int kk = 0; kk < T::kKN; ++kk)
          ldmatrix_x4(cf[kk], sC + swz<T::kNC>(q0 + (lane & 15),
                                               2 * kk + (lane >> 4)));
        const float cr[2] = {cq[min(q0 + g8, Q - 1)],
                             cq[min(q0 + g8 + 8, Q - 1)]};
        // one 16-position k-block: kDiag for the block on the diagonal
        auto k_block = [&](int k0, auto kDiag) {
          // S = C_q B_k^T, the sum over N in two halves (even and odd
          // k-steps) for shorter chains: s[u][n][2 hh + jj] is row q0 +
          // g8 + 8 hh, position k0 + 8 n + t2 + jj
          float s[2][2][4];
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int n = 0; n < 2; ++n)
#pragma unroll
              for (int r = 0; r < 4; ++r) s[u][n][r] = 0.f;
#pragma unroll
          for (int kk = 0; kk < T::kKN; ++kk) {
            uint32_t bf[4];
            ldmatrix_x4(bf, sB + swz<T::kNC>(k0 + (lane & 7) + 8 * (lane >> 4),
                                             2 * kk + ((lane >> 3) & 1)));
            mma_bf16(s[kk & 1][0], cf[kk], bf[0], bf[1]);
            mma_bf16(s[kk & 1][1], cf[kk], bf[2], bf[3]);
          }
          // S~ = S exp(cum_q - cum_k) dt_k; on the diagonal block, a
          // select on the causal triangle (k <= q < Q there), never a
          // product with a mask: the exp above it may overflow, and
          // inf * 0 is NaN.  The accumulator layout is the A operand's.
          float ck[2][2], dk[2][2];
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
              ck[n][jj] = cq[k0 + 8 * n + t2 + jj];  // past Q: rows discarded
              dk[n][jj] = dq[k0 + 8 * n + t2 + jj];
            }
          uint32_t phi[4], plo[4];
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              float v[2];
#pragma unroll
              for (int jj = 0; jj < 2; ++jj) {
                const float sv = s[0][n][2 * hh + jj] + s[1][n][2 * hh + jj];
                v[jj] = sv * ex2(cr[hh] - ck[n][jj]) * dk[n][jj];
                if (decltype(kDiag)::value)
                  v[jj] = 8 * n + t2 + jj <= g8 + 8 * hh ? v[jj] : 0.f;
              }
              split(v[0], v[1], phi[2 * n + hh], plo[2 * n + hh]);
            }
          uint32_t xf[T::kPT / 2][4];  // x_k's B fragments
#pragma unroll
          for (int c2 = 0; c2 < T::kPT / 2; ++c2)
            ldmatrix_x4_trans(xf[c2], sX + swz<T::kPC>(
                                          k0 + (lane & 7) + 8 * ((lane >> 3) & 1),
                                          2 * c2 + (lane >> 4)));
#pragma unroll
          for (int c2 = 0; c2 < T::kPT / 2; ++c2) {
            mma_bf16(acc[i][2 * c2], phi, xf[c2][0], xf[c2][1]);
            mma_bf16(acc[i][2 * c2 + 1], phi, xf[c2][2], xf[c2][3]);
          }
#pragma unroll
          for (int c2 = 0; c2 < T::kPT / 2; ++c2) {
            mma_bf16(acc[i][2 * c2], plo, xf[c2][0], xf[c2][1]);
            mma_bf16(acc[i][2 * c2 + 1], plo, xf[c2][2], xf[c2][3]);
          }
        };
        for (int k0 = 0; k0 < q0; k0 += 16) k_block(k0, std::false_type());
        k_block(q0, std::true_type());
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int q = q0 + g8 + 8 * hh;
          if (q >= Q) continue;
          float* yrow = yb + (l0 + q) * y_row;
#pragma unroll
          for (int j = 0; j < T::kPT; ++j) {
            const int p = 8 * j + t2;
            if (p < P)
              *reinterpret_cast<float2*>(yrow + p) =
                  make_float2(acc[i][j][2 * hh], acc[i][j][2 * hh + 1]);
          }
        }
      }

      // the next (item, chunk): this item's next chunk, else the CTA's
      // next item's first
      const int nit = c + 1 < nc ? it : it + gridDim.x;
      const long long nl0 = c + 1 < nc ? l0 + Q : 0;
      const bool more = nit < items;
      __syncthreads();  // every warp is done with the chunk's C
      if (more) stage_rows<T::kNC>(sC, b_of(Cm, cs, nit), cs.l, nl0, N, Q, Qp, tid);
      cp_async_commit();

      // (iii) state = state exp(cum_Q) + (x o w)^T B: A = (x o w)^T from x
      // by ldmatrix.trans, scaled in registers (the next k-block's x
      // loaded ahead of this one's products); B by ldmatrix.trans
      const float decay = ex2(tot);
#pragma unroll
      for (int j = 0; j < T::kST; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) st[j][r] *= decay;
      auto x_frag = [&](uint32_t (&xa)[4], int k0) {
        ldmatrix_x4_trans(xa, sX + swz<T::kPC>(k0 + (lane & 7) + 8 * (lane >> 4),
                                               sp0 / 8 + ((lane >> 3) & 1)));
      };
      uint32_t xa[4];
      x_frag(xa, 0);
      for (int k0 = 0; k0 < Qp; k0 += 16) {
        // xa[0], xa[1]: positions k0 + t2 + {0, 1}; xa[2], xa[3]: k0 + 8 + ...
        const float w0 = ww[k0 + t2], w1 = ww[k0 + t2 + 1];
        const float w2 = ww[k0 + 8 + t2], w3 = ww[k0 + 9 + t2];
        uint32_t ahi[4], alo[4];
        scale_split(xa[0], w0, w1, ahi[0], alo[0]);
        scale_split(xa[1], w0, w1, ahi[1], alo[1]);
        scale_split(xa[2], w2, w3, ahi[2], alo[2]);
        scale_split(xa[3], w2, w3, ahi[3], alo[3]);
        if (k0 + 16 < Qp) x_frag(xa, k0 + 16);
        uint32_t bf[T::kST / 2][4];
#pragma unroll
        for (int c2 = 0; c2 < T::kST / 2; ++c2)
          ldmatrix_x4_trans(bf[c2], sB + swz<T::kNC>(
                                        k0 + (lane & 7) + 8 * ((lane >> 3) & 1),
                                        sn0 / 8 + 2 * c2 + (lane >> 4)));
#pragma unroll
        for (int c2 = 0; c2 < T::kST / 2; ++c2) {
          mma_bf16(st[2 * c2], ahi, bf[c2][0], bf[c2][1]);
          mma_bf16(st[2 * c2 + 1], ahi, bf[c2][2], bf[c2][3]);
        }
#pragma unroll
        for (int c2 = 0; c2 < T::kST / 2; ++c2) {
          mma_bf16(st[2 * c2], alo, bf[c2][0], bf[c2][1]);
          mma_bf16(st[2 * c2 + 1], alo, bf[c2][2], bf[c2][3]);
        }
      }

      __syncthreads();  // every warp is done with the chunk's B, x and w
      if (more) {
        stage_rows<T::kNC>(sB, b_of(Bm, bs, nit), bs.l, nl0, N, Q, Qp, tid);
        stage_rows<T::kPC>(sX, x_of(nit), xs.l, nl0, P, Q, Qp, tid);
      }
      cp_async_commit();
      if (c + 1 < nc) {
        // the state's bf16 hi + lo pair for the next chunk's term (i),
        // whose last reads were before the barriers above
#pragma unroll
        for (int j = 0; j < T::kST; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int p = sp0 + g8 + 8 * hh, n = sn0 + 8 * j + t2;
            const uint32_t off = swz<T::kNC>(p, n >> 3) + 2 * (n & 7);
            uint32_t hi, lo;
            split(st[j][2 * hh], st[j][2 * hh + 1], hi, lo);
            st_shared(sHi + off, hi);
            st_shared(sLo + off, lo);
          }
      }
    }

    float* so = state_out + static_cast<long long>(it) * P * N;
#pragma unroll
    for (int j = 0; j < T::kST; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int p = sp0 + g8 + 8 * hh, n = sn0 + 8 * j + t2;
        if (p < P && n < N)
          *reinterpret_cast<float2*>(so + p * N + n) =
              make_float2(st[j][2 * hh], st[j][2 * hh + 1]);
      }
  }
  cp_async_wait<0>();
}

template <int kN>
int launch_tc_n(const void* x, const void* dt, const void* A, const void* Bm,
                const void* Cm, void* y, void* state, void* states, int Bsz,
                int L, int H, int G, int P, int N, int Q,
                const Strides (&s)[4], cudaStream_t stream) {
  static int optin = 0, n_sm = 0;  // opt in to all shared memory once
  if (optin == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    cudaFuncSetAttribute(ssd_tc<kN>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) {
      optin = 0;
      return static_cast<int>(err);
    }
  }
  const size_t bytes = Tc<kN>::smem((Q + 15) & ~15);
  if (bytes > static_cast<size_t>(optin))
    return static_cast<int>(cudaErrorInvalidValue);
  // persistent: as many CTAs as are resident at once, each walking items
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ssd_tc<kN>,
                                                kTcThreads, bytes);
  const long long items = static_cast<long long>(Bsz) * H;
  const long long resident = static_cast<long long>(n_sm) * max(per_sm, 1);
  const int grid = static_cast<int>(items < resident ? items : resident);
  ssd_tc<kN><<<grid, kTcThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const __nv_bfloat16*>(Bm),
      static_cast<const __nv_bfloat16*>(Cm), static_cast<float*>(y),
      static_cast<float*>(state), static_cast<float*>(states), s[0], s[1],
      s[2], s[3], Bsz, L, H, G, P, N, Q);
  return static_cast<int>(cudaGetLastError());
}


bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// the tensor-core kernel's own conditions (the wrapper's _variant checks
// the same)
int launch_tc(const void* x, const void* dt, const void* A, const void* Bm,
              const void* Cm, void* y, void* state, void* states, int Bsz,
              int L, int H, int G, int P, int N, int Q, const long long* st,
              void* stream) {
  if (Bsz < 1 || L < 1 || Q < 1 || Q > kTcMaxQ || L % Q != 0 || G < 1 ||
      H % G != 0 || P < 8 || P > kTcP || P % 8 != 0 || N < 8 || N > 128 ||
      N % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(x) || !aligned16(Bm) || !aligned16(Cm))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < 12; ++i)  // x's, B's and C's strides (not dt's)
    if (i / 3 != 1 && st[i] % 8 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
  const Strides s[4] = {{st[0], st[1], st[2]}, {st[3], st[4], st[5]},
                        {st[6], st[7], st[8]}, {st[9], st[10], st[11]}};
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (N <= 64)
    return launch_tc_n<64>(x, dt, A, Bm, Cm, y, state, states, Bsz, L, H, G,
                           P, N, Q, s, cs);
  return launch_tc_n<128>(x, dt, A, Bm, Cm, y, state, states, Bsz, L, H, G,
                          P, N, Q, s, cs);
}

}  // namespace

// x, B, C in f32 (ssd_f32) or bf16 (ssd_bf16: the FMA kernel; ssd_bf16_tc:
// the tensor-core kernel); dt (B, L, H) and A (H,) f32.  strides: 12
// element strides, (batch, position, head or group) of x, dt, B and C.
// y (B, L, H, P) and state (B, H, P, N) are contiguous f32; states, when
// not null, receives each chunk's incoming state (B, L / Q, H, P, N) f32
// (the backward's input; serving passes null).
extern "C" int ssd_f32(const void* x, const void* dt, const void* A,
                       const void* Bm, const void* Cm, void* y, void* state,
                       void* states, int Bsz, int L, int H, int G, int P,
                       int N, int Q, const long long* strides, void* stream) {
  return launch<float>(x, dt, A, Bm, Cm, y, state, states, Bsz, L, H, G, P, N,
                       Q, strides, stream);
}

extern "C" int ssd_bf16(const void* x, const void* dt, const void* A,
                        const void* Bm, const void* Cm, void* y, void* state,
                        void* states, int Bsz, int L, int H, int G, int P,
                        int N, int Q, const long long* strides, void* stream) {
  return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, state, states, Bsz, L, H,
                               G, P, N, Q, strides, stream);
}

extern "C" int ssd_bf16_tc(const void* x, const void* dt, const void* A,
                           const void* Bm, const void* Cm, void* y,
                           void* state, void* states, int Bsz, int L, int H,
                           int G, int P, int N, int Q,
                           const long long* strides, void* stream) {
  return launch_tc(x, dt, A, Bm, Cm, y, state, states, Bsz, L, H, G, P, N, Q,
                   strides, stream);
}
