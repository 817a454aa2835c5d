// The backward pass of the Mamba2 SSD chunked scan (ssd.cu) for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the reference differentiates its XLA
// ssd_chunked (src/repro/models/ssm.py:87) with jax.vjp, and its Pallas
// kernel src/repro/kernels/ssd.py::ssd has no backward.  It is the
// backward of the port's SSD kernels, which the SSD autograd function
// (kernels/ssd.py) calls once per Mamba2 layer a train step.
//
// For each (batch b, head h), with xd = x * dt, dA = dt * A[h] and, per
// chunk of Q positions, cum = cumsum(dA), tot = cum[Q - 1], the chunk's
// incoming state S_in (P, N) from the forward (its optional states
// output) and the cotangent dS (P, N) of the state leaving the chunk, the
// chunks are walked in reverse order with dS on chip:
//
//   L[q, k] = exp(cum_q - cum_k) for q >= k, else 0
//   CB = C B^T, DX = dy xd^T, M = CB o DX o L                  (Q, Q)
//   dC_q  = sum_k (DX o L)_qk B_k + exp(cum_q) dy_q S_in
//   dB_k  = sum_q (DX o L)_qk C_q + exp(tot - cum_k) dS^T xd_k
//   dxd_k = sum_q (CB o L)_qk dy_q + exp(tot - cum_k) dS B_k
//   dcum  = rowsum(M) - colsum(M) + exp(cum_q) dy_q S_in C_q
//           - W_k,  W_k = exp(tot - cum_k) xd_k^T dS B_k
//   dcum[Q - 1] += exp(tot) <dS, S_in> + sum_k W_k
//   d(dA) = reverse cumsum of dcum;  dx = dxd dt;
//   ddt = dxd . x + d(dA) A;  dA_h += sum d(dA) dt
//   dS   <- exp(tot) dS + sum_q exp(cum_q) dy_q C_q^T
//
// Every decay is selected on the causal triangle before the exp (never a
// product with a mask): above it cum_q - cum_k is large and positive, exp
// overflows, and inf * 0 is NaN.  The reference's jnp.where(causal,
// exp(seg), 0) meets exactly that in its gradient (ROADMAP Queue 3).
// Inside the triangle every decay is at most 1.
//
// Design: f32 FMAs for f32 and bf16 inputs alike (bf16 is cast on load),
// f32 accumulation throughout.  One CTA of 256 threads (16 x 16) per
// (b, h) walks the chunks in reverse; the chunk's S_in and dS sit in
// shared memory (rows padded to N + 1 floats, so column walks are free of
// bank conflicts).  Within a chunk, 64-position tiles: a first sweep over
// q-tiles (the k-tiles at or below each) gives dC and the row sums of M;
// a second over k-tiles (the q-tiles at or above each) gives dB, dxd and
// the column sums, recomputing the CB and DX tiles (simpler than holding
// a whole chunk's dC on chip beside dB).  A thread holds a 4 x 4 block of
// a (64, 64) tile or a 4 x 8 block of a (64, N) one.  dB and dC are
// summed over the group's heads (64-way for mamba2-1.3b's G = 1) by f32
// atomics into (B, L, G, N) f32 buffers that the wrapper zeroes and casts;
// dA by one atomic a CTA; dx and ddt are written once.
//
// Bound.  At mamba2-1.3b's training shape (B=4, L=1024, H=64, P=64,
// N=128, Q=256, bf16) the function reads x, B, C, dt, the f32 dy (67 MB)
// and the chunks' f32 states (33.5 MB) and writes dx, ddt, dA, dB, dC:
// ~174 MB, 0.052 ms at 3.35 TB/s.  Its products, each counted once (C B^T
// and the dB, dC tile products per group, dy xd^T and dxd per head over
// the causal half, the four state terms), are ~26 GFLOP, 0.027 ms at the
// bf16 tensor-core rate: bytes bind.  This kernel runs ~2.5x those
// products (C B^T and dC, dB per head, C B^T and dy xd^T in both sweeps)
// on f32 FMAs (67 TFLOP/s at best): far from the bound, a first kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kTile = 64;      // positions of a q- or k-tile
constexpr int kLdT = kTile + 1;
constexpr int kMaxP = 64;      // head dim: 16 tx x 4 columns
constexpr int kMaxN = 128;     // state dim: 16 tx x 8 columns

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Strides {
  long long b, l, h;  // elements; the last dim is contiguous
};

// the sum over the 16 lanes of a half-warp (the threads of one ty)
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

size_t smem_bytes(int P, int N, int Q) {
  const size_t ldn = static_cast<size_t>(N) + 1, ldp = P + 1;
  return sizeof(float) * (2 * P * ldn          // S_in, dS
                          + 2 * kTile * ldn    // C and B tiles
                          + 2 * kTile * ldp    // dy and x tiles
                          + 2 * kTile * kLdT   // the two (64, 64) tiles
                          + 5 * static_cast<size_t>(Q)  // dt, cum, dcum, dxx, W
                          + 32);               // a block reduction
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd(const T* __restrict__ x, const float* __restrict__ dt,
        const float* __restrict__ A, const T* __restrict__ Bm,
        const T* __restrict__ Cm, const float* __restrict__ states,
        const float* __restrict__ dy, const float* __restrict__ dstate,
        T* __restrict__ dx, float* __restrict__ ddt, float* __restrict__ dA,
        float* __restrict__ dB, float* __restrict__ dC, Strides xs,
        Strides ds, Strides bs, Strides cs, Strides ys, int L, int H, int G,
        int P, int N, int Q) {
  extern __shared__ __align__(16) float smem[];
  const int ldn = N + 1, ldp = P + 1;
  float* Ss = smem;                // P x ldn: the chunk's incoming state
  float* dSs = Ss + P * ldn;       // P x ldn: the outgoing state's cotangent
  float* Cs = dSs + P * ldn;       // kTile x ldn
  float* Bs = Cs + kTile * ldn;    // kTile x ldn
  float* Ys = Bs + kTile * ldn;    // kTile x ldp: dy
  float* Xs = Ys + kTile * ldp;    // kTile x ldp: x (not yet times dt)
  float* T1 = Xs + kTile * ldp;    // kTile x kLdT
  float* T2 = T1 + kTile * kLdT;   // kTile x kLdT
  float* dts = T2 + kTile * kLdT;  // Q
  float* cum = dts + Q;            // Q
  float* dcum = cum + Q;           // Q
  float* dxx = dcum + Q;           // Q: sum_p dxd x
  float* wk = dxx + Q;             // Q: W_k
  float* red = wk + Q;             // 32

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int g = h / (H / G);
  const float a = A[h];
  const T* xb = x + b * xs.b + h * xs.h;
  const float* db = dt + b * ds.b + h * ds.h;
  const T* Bb = Bm + b * bs.b + g * bs.h;
  const T* Cb = Cm + b * cs.b + g * cs.h;
  const float* yb = dy + b * ys.b + h * ys.h;
  const long long hp = static_cast<long long>(H) * P;  // dx's position stride
  T* dxb = dx + static_cast<long long>(b) * L * hp + static_cast<long long>(h) * P;
  float* ddtb = ddt + static_cast<long long>(b) * L * H + h;
  const long long gn = static_cast<long long>(G) * N;  // dB's position stride
  float* dBb = dB + static_cast<long long>(b) * L * gn + static_cast<long long>(g) * N;
  float* dCb = dC + static_cast<long long>(b) * L * gn + static_cast<long long>(g) * N;
  const int nc = L / Q;

  for (int i = tid; i < P * N; i += kThreads) {
    const int p = i / N, n = i - p * N;
    dSs[p * ldn + n] =
        dstate != nullptr ? dstate[static_cast<long long>(bh) * P * N + i] : 0.f;
  }
  float dA_part = 0.f;

  for (int c = nc - 1; c >= 0; --c) {
    const long long l0 = static_cast<long long>(c) * Q;
    __syncthreads();  // the last chunk is done with every buffer
    for (int i = tid; i < Q; i += kThreads) {
      const float d = db[(l0 + i) * ds.l];
      dts[i] = d;
      cum[i] = d * a;
      dcum[i] = 0.f;
    }
    const float* sc =
        states + ((static_cast<long long>(b) * nc + c) * H + h) * P * N;
    for (int i = tid; i < P * N; i += kThreads) {
      const int p = i / N, n = i - p * N;
      Ss[p * ldn + n] = sc[i];
    }
    __syncthreads();
    if (tid == 0) {  // inclusive prefix sum of dA, in order (as the forward)
      float run = 0.f;
      for (int i = 0; i < Q; ++i) {
        run += cum[i];
        cum[i] = run;
      }
    }
    __syncthreads();
    const float tot = cum[Q - 1];

    // ---- sweep 1, over q-tiles: dC and the row sums of M
    for (int q0 = 0; q0 < Q; q0 += kTile) {
      const int nq = min(kTile, Q - q0);
      __syncthreads();  // the last q-tile's reads of Cs and Ys are done
      for (int i = tid; i < kTile * N; i += kThreads) {
        const int r = i / N, n = i - r * N;
        Cs[r * ldn + n] = r < nq ? to_f32(Cb[(l0 + q0 + r) * cs.l + n]) : 0.f;
      }
      for (int i = tid; i < kTile * P; i += kThreads) {
        const int r = i / P, p = i - r * P;
        Ys[r * ldp + p] = r < nq ? yb[(l0 + q0 + r) * ys.l + p] : 0.f;
      }
      __syncthreads();
      // the incoming state's term: dC_q = exp(cum_q) dy_q S_in, and
      // exp(cum_q) (dy_q S_in) . C_q into the row's dcum
      float dc[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) dc[i][j] = 0.f;
      for (int p = 0; p < P; ++p) {
        float yv[4], sv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) yv[i] = Ys[(ty * 4 + i) * ldp + p];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = tx + 16 * j;
          sv[j] = n < N ? Ss[p * ldn + n] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) dc[i][j] = fmaf(yv[i], sv[j], dc[i][j]);
      }
      float rowp[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        const float e = r < nq ? expf(cum[min(q0 + r, Q - 1)]) : 0.f;
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = tx + 16 * j;
          if (n < N) s = fmaf(dc[i][j], Cs[r * ldn + n], s);
          dc[i][j] *= e;
        }
        rowp[i] = e * s;
      }

      for (int k0 = 0; k0 <= q0; k0 += kTile) {
        const int nk = min(kTile, Q - k0);
        __syncthreads();  // the last k-tile's reads of Bs, Xs and T1 are done
        for (int i = tid; i < kTile * N; i += kThreads) {
          const int r = i / N, n = i - r * N;
          Bs[r * ldn + n] = r < nk ? to_f32(Bb[(l0 + k0 + r) * bs.l + n]) : 0.f;
        }
        for (int i = tid; i < kTile * P; i += kThreads) {
          const int r = i / P, p = i - r * P;
          Xs[r * ldp + p] = r < nk ? to_f32(xb[(l0 + k0 + r) * xs.l + p]) : 0.f;
        }
        __syncthreads();
        // CB and dy x^T for rows q (4 ty + i), columns k (tx + 16 j)
        float cb[4][4], dxv[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) cb[i][j] = dxv[i][j] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = Cs[(ty * 4 + i) * ldn + n];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = Bs[(tx + 16 * j) * ldn + n];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) cb[i][j] = fmaf(cv[i], bv[j], cb[i][j]);
        }
        for (int p = 0; p < P; ++p) {
          float yv[4], xv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) yv[i] = Ys[(ty * 4 + i) * ldp + p];
#pragma unroll
          for (int j = 0; j < 4; ++j) xv[j] = Xs[(tx + 16 * j) * ldp + p];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) dxv[i][j] = fmaf(yv[i], xv[j], dxv[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = ty * 4 + i, qi = q0 + r;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = tx + 16 * j, kj = k0 + col;
            // select on the causal triangle before the exp
            const bool ok = r < nq && col < nk && kj <= qi;
            const int qc = min(qi, Q - 1), kc = min(kj, Q - 1);
            const float l = ok ? expf(cum[qc] - cum[kc]) : 0.f;
            const float t1 = ok ? dxv[i][j] * dts[kc] * l : 0.f;  // (DX o L)
            rowp[i] = fmaf(cb[i][j], t1, rowp[i]);
            T1[r * kLdT + col] = t1;
          }
        }
        __syncthreads();
        // dC_q += (DX o L) B_k
        for (int kk = 0; kk < nk; ++kk) {
          float tv[4], bv[8];
#pragma unroll
          for (int i = 0; i < 4; ++i) tv[i] = T1[(ty * 4 + i) * kLdT + kk];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int n = tx + 16 * j;
            bv[j] = n < N ? Bs[kk * ldn + n] : 0.f;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) dc[i][j] = fmaf(tv[i], bv[j], dc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        const float s = sum16(rowp[i]);
        if (r >= nq) continue;
        if (tx == 0) dcum[q0 + r] += s;
        float* row = dCb + (l0 + q0 + r) * gn;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = tx + 16 * j;
          if (n < N) atomicAdd(row + n, dc[i][j]);
        }
      }
    }

    // ---- sweep 2, over k-tiles: dB, dxd (-> dx and dxd . x), the
    // column sums of M and W
    for (int k0 = 0; k0 < Q; k0 += kTile) {
      const int nk = min(kTile, Q - k0);
      __syncthreads();  // the last tile's reads of Bs and Xs are done
      for (int i = tid; i < kTile * N; i += kThreads) {
        const int r = i / N, n = i - r * N;
        Bs[r * ldn + n] = r < nk ? to_f32(Bb[(l0 + k0 + r) * bs.l + n]) : 0.f;
      }
      for (int i = tid; i < kTile * P; i += kThreads) {
        const int r = i / P, p = i - r * P;
        Xs[r * ldp + p] = r < nk ? to_f32(xb[(l0 + k0 + r) * xs.l + p]) : 0.f;
      }
      __syncthreads();
      // the outgoing state's terms, rows k (4 ty + i): dxd = w dS B_k
      // (columns p = tx + 16 j) and dB = w dt_k dS^T x_k (columns n)
      float dxd[4][4], dbv[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) dxd[i][j] = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) dbv[i][j] = 0.f;
      }
      for (int n = 0; n < N; ++n) {
        float bv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) bv[i] = Bs[(ty * 4 + i) * ldn + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tx + 16 * j;
          sv[j] = p < P ? dSs[p * ldn + n] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) dxd[i][j] = fmaf(bv[i], sv[j], dxd[i][j]);
      }
      for (int p = 0; p < P; ++p) {
        float xv[4], sv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = Xs[(ty * 4 + i) * ldp + p];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = tx + 16 * j;
          sv[j] = n < N ? dSs[p * ldn + n] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) dbv[i][j] = fmaf(xv[i], sv[j], dbv[i][j]);
      }
      float colp[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        const bool in = r < nk;
        const int kc = min(k0 + r, Q - 1);
        const float w = in ? expf(tot - cum[kc]) : 0.f;
        const float d = in ? dts[kc] : 0.f;
        float s = 0.f;  // x_k . (dS B_k)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tx + 16 * j;
          dxd[i][j] *= w;
          if (p < P) s = fmaf(Xs[r * ldp + p], dxd[i][j], s);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) dbv[i][j] *= w * d;
        colp[i] = -d * s;  // -W_k, summed over the half-warp below
        const float wrow = d * sum16(s);
        if (in && tx == 0) wk[k0 + r] = wrow;  // W_k, for dtot
      }

      for (int q0 = k0; q0 < Q; q0 += kTile) {
        const int nq = min(kTile, Q - q0);
        __syncthreads();  // the last q-tile's reads of Cs, Ys, T1, T2 are done
        for (int i = tid; i < kTile * N; i += kThreads) {
          const int r = i / N, n = i - r * N;
          Cs[r * ldn + n] = r < nq ? to_f32(Cb[(l0 + q0 + r) * cs.l + n]) : 0.f;
        }
        for (int i = tid; i < kTile * P; i += kThreads) {
          const int r = i / P, p = i - r * P;
          Ys[r * ldp + p] = r < nq ? yb[(l0 + q0 + r) * ys.l + p] : 0.f;
        }
        __syncthreads();
        // B_k C_q^T and x_k dy_q^T for rows k (4 ty + i), columns q
        float cb[4][4], dxv[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) cb[i][j] = dxv[i][j] = 0.f;
        for (int n = 0; n < N; ++n) {
          float bv[4], cv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) bv[i] = Bs[(ty * 4 + i) * ldn + n];
#pragma unroll
          for (int j = 0; j < 4; ++j) cv[j] = Cs[(tx + 16 * j) * ldn + n];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) cb[i][j] = fmaf(bv[i], cv[j], cb[i][j]);
        }
        for (int p = 0; p < P; ++p) {
          float xv[4], yv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) xv[i] = Xs[(ty * 4 + i) * ldp + p];
#pragma unroll
          for (int j = 0; j < 4; ++j) yv[j] = Ys[(tx + 16 * j) * ldp + p];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) dxv[i][j] = fmaf(xv[i], yv[j], dxv[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = ty * 4 + i, kj = k0 + r;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = tx + 16 * j, qi = q0 + col;
            // select on the causal triangle before the exp
            const bool ok = r < nk && col < nq && kj <= qi;
            const int qc = min(qi, Q - 1), kc = min(kj, Q - 1);
            const float l = ok ? expf(cum[qc] - cum[kc]) : 0.f;
            const float t1 = ok ? dxv[i][j] * dts[kc] * l : 0.f;  // (DX o L)^T
            const float t2 = ok ? cb[i][j] * l : 0.f;             // (CB o L)^T
            colp[i] = fmaf(-cb[i][j], t1, colp[i]);
            T1[r * kLdT + col] = t1;
            T2[r * kLdT + col] = t2;
          }
        }
        __syncthreads();
        // dB_k += (DX o L)^T C_q, dxd_k += (CB o L)^T dy_q
        for (int qq = 0; qq < nq; ++qq) {
          float t1v[4], t2v[4], cv[8], yv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            t1v[i] = T1[(ty * 4 + i) * kLdT + qq];
            t2v[i] = T2[(ty * 4 + i) * kLdT + qq];
          }
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int n = tx + 16 * j;
            cv[j] = n < N ? Cs[qq * ldn + n] : 0.f;
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int p = tx + 16 * j;
            yv[j] = p < P ? Ys[qq * ldp + p] : 0.f;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int j = 0; j < 8; ++j) dbv[i][j] = fmaf(t1v[i], cv[j], dbv[i][j]);
#pragma unroll
            for (int j = 0; j < 4; ++j) dxd[i][j] = fmaf(t2v[i], yv[j], dxd[i][j]);
          }
        }
      }
      // the k rows' outputs: dx = dxd dt, dxd . x, the column sums, dB
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        const bool in = r < nk;
        const float d = in ? dts[min(k0 + r, Q - 1)] : 0.f;
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tx + 16 * j;
          if (p < P) s = fmaf(dxd[i][j], Xs[r * ldp + p], s);
        }
        s = sum16(s);
        const float col = sum16(colp[i]);
        if (!in) continue;
        if (tx == 0) {
          dxx[k0 + r] = s;
          dcum[k0 + r] += col;
        }
        T* xrow = dxb + (l0 + k0 + r) * hp;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tx + 16 * j;
          if (p < P) xrow[p] = from_f32<T>(dxd[i][j] * d);
        }
        float* row = dBb + (l0 + k0 + r) * gn;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = tx + 16 * j;
          if (n < N) atomicAdd(row + n, dbv[i][j]);
        }
      }
    }
    __syncthreads();

    // ---- dS <- exp(tot) dS + sum_q exp(cum_q) dy_q C_q^T, and <dS, S_in>
    // thread block: rows p = ty + 16 i, columns n = tx + 16 j
    const float decay = expf(tot);
    float st[4][8];
    float inner = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = tx + 16 * j;
        const bool in = p < P && n < N;
        const float v = in ? dSs[p * ldn + n] : 0.f;
        if (in) inner = fmaf(v, Ss[p * ldn + n], inner);
        st[i][j] = v * decay;
      }
    }
    for (int q0 = 0; q0 < Q; q0 += kTile) {
      const int nq = min(kTile, Q - q0);
      __syncthreads();  // the last tile's reads of Cs and Ys are done
      for (int i = tid; i < kTile * N; i += kThreads) {
        const int r = i / N, n = i - r * N;
        Cs[r * ldn + n] = r < nq ? to_f32(Cb[(l0 + q0 + r) * cs.l + n]) : 0.f;
      }
      for (int i = tid; i < kTile * P; i += kThreads) {
        const int r = i / P, p = i - r * P;
        Ys[r * ldp + p] =
            r < nq ? yb[(l0 + q0 + r) * ys.l + p] * expf(cum[q0 + r]) : 0.f;
      }
      __syncthreads();
      for (int qq = 0; qq < nq; ++qq) {
        float yv[4], cv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int p = ty + 16 * i;
          yv[i] = p < P ? Ys[qq * ldp + p] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = tx + 16 * j;
          cv[j] = n < N ? Cs[qq * ldn + n] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) st[i][j] = fmaf(yv[i], cv[j], st[i][j]);
      }
    }
    // each thread writes back only the elements it read: nothing else
    // reads dSs until the next chunk's first barrier
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = tx + 16 * j;
        if (p < P && n < N) dSs[p * ldn + n] = st[i][j];
      }
    }
    inner = sum16(inner);
    inner += __shfl_xor_sync(0xffffffffu, inner, 16);
    if ((tid & 31) == 0) red[tid >> 5] = inner;
    __syncthreads();
    if (tid == 0) {
      float ip = 0.f, wsum = 0.f;
      for (int w = 0; w < kThreads / 32; ++w) ip += red[w];
      for (int k = 0; k < Q; ++k) wsum += wk[k];
      // dtot = exp(tot) <dS, S_in> + sum_k W_k, then d(dA) = the reverse
      // cumsum of dcum
      float run = 0.f;
      dcum[Q - 1] += decay * ip + wsum;
      for (int k = Q - 1; k >= 0; --k) {
        run += dcum[k];
        dcum[k] = run;
      }
    }
    __syncthreads();
    for (int j = tid; j < Q; j += kThreads) {
      const float da = dcum[j];
      ddtb[(l0 + j) * H] = fmaf(da, a, dxx[j]);
      dA_part = fmaf(da, dts[j], dA_part);
    }
  }

  dA_part = sum16(dA_part);
  dA_part += __shfl_xor_sync(0xffffffffu, dA_part, 16);
  __syncthreads();
  if ((tid & 31) == 0) red[tid >> 5] = dA_part;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) s += red[w];
    atomicAdd(dA + h, s);
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* states, const void* dy,
           const void* dstate, void* dx, void* ddt, void* dA, void* dB,
           void* dC, int Bsz, int L, int H, int G, int P, int N, int Q,
           const long long* st, void* stream) {
  if (Bsz < 1 || L < 1 || Q < 1 || L % Q != 0 || G < 1 || H % G != 0 ||
      P < 1 || P > kMaxP || N < 1 || N > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  static int optin = 0;  // opt in to the card's full shared memory once
  if (optin == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    cudaFuncSetAttribute(ssd_bwd<T>,
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
      bs{st[6], st[7], st[8]}, cs{st[9], st[10], st[11]},
      ys{st[12], st[13], st[14]};
  ssd_bwd<T><<<Bsz * H, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(states),
      static_cast<const float*>(dy), static_cast<const float*>(dstate),
      static_cast<T*>(dx), static_cast<float*>(ddt), static_cast<float*>(dA),
      static_cast<float*>(dB), static_cast<float*>(dC), xs, ds, bs, cs, ys, L,
      H, G, P, N, Q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, B, C in f32 (ssd_bwd_f32) or bf16 (ssd_bwd_bf16); dt (B, L, H), A
// (H,), states (B, L / Q, H, P, N), dy (B, L, H, P) and dstate (B, H, P,
// N, or null: zeros) f32.  strides: 15 element strides, (batch, position,
// head or group) of x, dt, B, C and dy.  dx (B, L, H, P) in x's type and
// ddt (B, L, H) f32 are written; dA (H,) and dB, dC (B, L, G, N) f32 are
// added to (the caller zeroes them).
extern "C" int ssd_bwd_f32(const void* x, const void* dt, const void* A,
                           const void* Bm, const void* Cm, const void* states,
                           const void* dy, const void* dstate, void* dx,
                           void* ddt, void* dA, void* dB, void* dC, int Bsz,
                           int L, int H, int G, int P, int N, int Q,
                           const long long* strides, void* stream) {
  return launch<float>(x, dt, A, Bm, Cm, states, dy, dstate, dx, ddt, dA, dB,
                       dC, Bsz, L, H, G, P, N, Q, strides, stream);
}

extern "C" int ssd_bwd_bf16(const void* x, const void* dt, const void* A,
                            const void* Bm, const void* Cm,
                            const void* states, const void* dy,
                            const void* dstate, void* dx, void* ddt, void* dA,
                            void* dB, void* dC, int Bsz, int L, int H, int G,
                            int P, int N, int Q, const long long* strides,
                            void* stream) {
  return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, states, dy, dstate, dx, ddt,
                               dA, dB, dC, Bsz, L, H, G, P, N, Q, strides,
                               stream);
}
