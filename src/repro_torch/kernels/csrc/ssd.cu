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
// Head h reads group h / (H / G) of B and C.  Everything is f32; x, B and
// C may be f32 or bf16 and are cast on load.  y and the final state are
// f32.
//
// Replaces the Pallas kernel src/repro/kernels/ssd.py::ssd (body _kernel),
// the twin of the reference model's XLA ssd_chunked, which the Mamba2
// prefill (models/ssm.py::mamba2_fwd) calls once per layer.
//
// Bound: operations.  At the serving path's shape (B=8, L=1024, H=64,
// P=64, N=128, Q=256) the causal half of the work is ~21 MFLOP per
// (b, h, chunk), ~43 GFLOP in all: ~0.64 ms at the 67 TFLOP/s f32 rate.
// The bytes (x, B, C, dt read once, y and the state written once) are
// ~0.2 GB, ~0.06 ms at 3.35 TB/s.
//
// Design.  One CTA per (b, h); the Pallas grid's sequential chunk axis is
// a loop inside the CTA, and the (P, N) state (32 KB at P=64, N=128) stays
// in shared memory from chunk to chunk.  Per chunk: dt is staged and one
// thread takes the prefix sum of dA in order, as a plain cumsum does: the
// decay exp(cum_q - cum_k) takes the difference of two sums that reach
// hundreds, so the order of the additions shows in the f32 result (a
// warp-parallel scan moved it by more than 2e-4 at L=1024, N=128), and
// the Q dependent adds cost ~1 us of the call.  Then 64-row
// q-tiles of C go against the 64-row k-tiles of B and xd at or below them
// (the tiles above the diagonal are never visited): S = C_q B_k^T, the
// decay selected on the causal triangle BEFORE the exp (exp of the upper
// triangle overflows, and inf * 0 is NaN), then S xd_k; then the
// incoming-state term C_q state^T scaled by exp(cum_q).  Only after every
// q-tile has read the old state is it decayed and updated, k-tile by
// k-tile, each thread holding its 4 x 8 block of the state in registers.
// 256 threads as 16 x 16: of a 64 x 64 tile a thread owns rows 4 ty + i
// and columns tx + 16 j.  Rows of the shared tiles are padded to N + 1
// floats so the column walks are free of bank conflicts.  ~133 KB of
// dynamic shared memory at P=64, N=128: one CTA per SM.  The products are
// f32 FMAs from shared memory, a first kernel that is right; sharing
// C B^T across the heads of a group and tensor-core tiles are later work.
//
// x, dt, B and C are read in the model's (B, L, heads, dim) layout with
// element strides for batch, position and head (or group); their last dim
// must be contiguous.  y (B, L, H, P) and the state (B, H, P, N) are
// written contiguous.  The C entry points return cudaGetLastError() after
// the launch; the Python wrapper raises on a non-zero code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
        float* __restrict__ state_out, Strides xs, Strides ds, Strides bs,
        Strides cs, int L, int H, int G, int P, int N, int Q) {
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
           const void* Cm, void* y, void* state, int Bsz, int L, int H, int G,
           int P, int N, int Q, const long long* st, void* stream) {
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
      static_cast<float*>(state), xs, ds, bs, cs, L, H, G, P, N, Q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, B, C in f32 (ssd_f32) or bf16 (ssd_bf16); dt (B, L, H) and A (H,) f32.
// strides: 12 element strides, (batch, position, head or group) of x, dt,
// B and C.  y (B, L, H, P) and state (B, H, P, N) are contiguous f32.
extern "C" int ssd_f32(const void* x, const void* dt, const void* A,
                       const void* Bm, const void* Cm, void* y, void* state,
                       int Bsz, int L, int H, int G, int P, int N, int Q,
                       const long long* strides, void* stream) {
  return launch<float>(x, dt, A, Bm, Cm, y, state, Bsz, L, H, G, P, N, Q,
                       strides, stream);
}

extern "C" int ssd_bf16(const void* x, const void* dt, const void* A,
                        const void* Bm, const void* Cm, void* y, void* state,
                        int Bsz, int L, int H, int G, int P, int N, int Q,
                        const long long* strides, void* stream) {
  return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, state, Bsz, L, H, G, P,
                               N, Q, strides, stream);
}
