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
// Bound.  At mamba2-1.3b's training shape (B=4, L=1024, H=64, P=64,
// N=128, Q=256, bf16) the function reads x, B, C, dt, the f32 dy (67 MB)
// and the chunks' f32 states (33.5 MB) and writes dx, ddt, dA, dB, dC:
// ~174 MB, 0.052 ms at 3.35 TB/s.  Its products, each counted once (C B^T
// and the dB, dC tile products per group, dy xd^T and dxd per head over
// the causal half, the four state terms), are ~26 GFLOP, 0.027 ms at the
// bf16 tensor-core rate: bytes bind.
//
// Design, bf16 with P and N multiples of 8 (P <= 64, N <= 128), a chunk
// of at most 256 and 16-byte rows (the training path): four kernels, so
// that the one sequential dependency, the state's cotangent dS carried
// from chunk to chunk, is split out of the chunk-local work:
//
// * ssd_bwd_u, one CTA a (batch, chunk, head): U_c = sum_q e^cum_q dy_q^T
//   C_q on the tensor cores; it also writes dy as bf16 hi + lo planes;
// * ssd_bwd_scan, one CTA a (batch, head, slice of P N): dS_c = e^tot_{c+1}
//   dS_{c+1} + U_{c+1} in reverse, elementwise; dS_c and S_in_c go out as
//   bf16 hi + lo planes, <dS_c, S_in_c> by one atomic a CTA;
// * ssd_bwd_tc, one CTA a (batch, chunk, 64-position tile, group, block of
//   8 of its heads): the chunk-local terms above for the tile's rows, in
//   two sweeps (as q rows: dC and the row sums of M over the k-tiles at or
//   below; as k rows: dxd, dB, the column sums and W over the q-tiles at
//   or above), on mma.sync m16n8k16 fed by ldmatrix (f32 accumulation).
//   The f32 operands (dy, the states, dS, T1 = DX o L and T2 = CB o L)
//   enter as bf16 hi + lo pairs (hi hi + lo hi + hi lo), so the f32
//   result is not rounded to bf16.  Every input comes by cp.async from bf16 rows or planes; the
//   other tile of each (q-tile, k-tile) pair goes through two buffers,
//   the next pair's copies in flight while this one's products run (two
//   barriers a pair).  dB and dC are summed over the block's heads in
//   registers and go out by one f32 atomic an element (8-way at G = 1);
// * ssd_bwd_finish, one warp a (batch, chunk, head): the reverse cumsum of
//   dcum plus dtot, then ddt and dA.
//
// 1024 + 2048 + 512 + 128 CTAs at the training shape, against the first
// kernel's 256 serial ones on f32 FMAs (one CTA a (batch, head) walking
// the chunks in reverse), which stays for f32 and the other inputs
// (ssd_bwd below): a thread holds a 4 x 4 block of a (64, 64) tile or a
// 4 x 8 block of a (64, N) one; a first sweep over q-tiles gives dC and
// the row sums, a second over k-tiles dB, dxd and the column sums; dB and
// dC by f32 atomics, dA by one atomic a CTA.  What bounds the tensor-core
// path now: the shared-memory fragment traffic and the latency of the
// main kernel's phases with one CTA an SM (C B^T is still recomputed per
// head and in both sweeps: ~2x its share of the products).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

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

// --------------------------------------------------------------------------
// bf16 on the tensor cores: four kernels (ssd_bwd_u, ssd_bwd_scan,
// ssd_bwd_tc, ssd_bwd_finish)

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kT = 64;         // positions of a tile
constexpr int kP = 64;         // the head dim, padded with zeros
constexpr int kMaxQ = 256;     // the chunk
constexpr int kHeads = 8;      // heads of a group a ssd_bwd_tc CTA takes
constexpr int kLdP = kP + 8;   // bf16 rows of (., P) tiles: 16 bytes of pad
constexpr int kLdT = kT + 8;   // bf16 rows of (kT, kT) tiles
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (v0, v1) as a bf16 hi + lo pair: hi = bf16(v), lo = bf16(v - hi)
__device__ __forceinline__ void split(float v0, float v1, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 f = __bfloat1622float2(h);
  hi = bits(h);
  lo = hopper::pack_bf16(v0 - f.x, v1 - f.y);
}

__device__ __forceinline__ float bf(const bf16* s, int i) {
  return __bfloat162float(s[i]);
}

// ldmatrix lane addresses (bytes) into a bf16 tile of row stride ld
// elements: an A fragment (m16 x k16) of a row-major [m][k] tile, read
// as is (lane_a) or from a [k][m] tile, transposed (lane_at); two B
// fragments (k16 x two n8) from a [n][k] tile (lane_bt) or a [k][n] one,
// transposed (lane_b)
__device__ __forceinline__ uint32_t lane_a(uint32_t s, int ld, int m0, int k0) {
  const int l = threadIdx.x & 31, q = l >> 3, r = l & 7;
  return s + ((m0 + r + (q & 1) * 8) * ld + k0 + (q >> 1) * 8) * 2;
}
__device__ __forceinline__ uint32_t lane_at(uint32_t s, int ld, int m0, int k0) {
  const int l = threadIdx.x & 31, q = l >> 3, r = l & 7;
  return s + ((k0 + r + (q >> 1) * 8) * ld + m0 + (q & 1) * 8) * 2;
}
__device__ __forceinline__ uint32_t lane_bt(uint32_t s, int ld, int n0, int k0) {
  const int l = threadIdx.x & 31, q = l >> 3, r = l & 7;
  return s + ((n0 + r + (q >> 1) * 8) * ld + k0 + (q & 1) * 8) * 2;
}
__device__ __forceinline__ uint32_t lane_b(uint32_t s, int ld, int k0, int n0) {
  const int l = threadIdx.x & 31, q = l >> 3, r = l & 7;
  return s + ((k0 + r + (q & 1) * 8) * ld + n0 + (q >> 1) * 8) * 2;
}

// d[f] += A[m0 : m0 + 16, 0 : K] B[0 : K, n0 + 8 f : n0 + 8 f + 8], f < NF
// (K the padded width: the tiles hold zeros past the real one).
// A is [m][k] (kAT: [k][m]), B is [k][n] (kBT: [n][k]).  An operand
// with a second plane (a2, b2: the lo half of an f32 split into bf16 hi
// + lo) adds its products: hi hi + lo hi + hi lo.
template <int NF, int K, bool kAT, bool kBT, bool kA2, bool kB2>
__device__ __forceinline__ void mma_tile(float (&d)[NF][4], uint32_t a,
                                         uint32_t a2, int lda, int m0,
                                         uint32_t b, uint32_t b2, int ldb,
                                         int n0) {
  static_assert(NF % 2 == 0 && K % 16 == 0, "two n8 fragments an ldmatrix");
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t ah[4], al[4];
    const uint32_t ao = kAT ? lane_at(0, lda, m0, k0) : lane_a(0, lda, m0, k0);
    if (kAT) hopper::ldmatrix_x4_trans(ah, a + ao);
    else hopper::ldmatrix_x4(ah, a + ao);
    if (kA2) {
      if (kAT) hopper::ldmatrix_x4_trans(al, a2 + ao);
      else hopper::ldmatrix_x4(al, a2 + ao);
    }
#pragma unroll
    for (int f = 0; f < NF; f += 2) {
      uint32_t bh[4], bl[4];
      const uint32_t bo =
          kBT ? lane_bt(0, ldb, n0 + 8 * f, k0) : lane_b(0, ldb, k0, n0 + 8 * f);
      if (kBT) hopper::ldmatrix_x4(bh, b + bo);
      else hopper::ldmatrix_x4_trans(bh, b + bo);
      hopper::mma_bf16(d[f], ah, bh[0], bh[1]);
      hopper::mma_bf16(d[f + 1], ah, bh[2], bh[3]);
      if (kA2) {
        hopper::mma_bf16(d[f], al, bh[0], bh[1]);
        hopper::mma_bf16(d[f + 1], al, bh[2], bh[3]);
      }
      if (kB2) {
        if (kBT) hopper::ldmatrix_x4(bl, b2 + bo);
        else hopper::ldmatrix_x4_trans(bl, b2 + bo);
        hopper::mma_bf16(d[f], ah, bl[0], bl[1]);
        hopper::mma_bf16(d[f + 1], ah, bl[2], bl[3]);
      }
    }
  }
}

template <int NF>
__device__ __forceinline__ void zero(float (&d)[NF][4]) {
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int x = 0; x < 4; ++x) d[f][x] = 0.f;
}

// row (g, or g + 8 for hr = 1) and first column of accumulator elements
// 2 hr and 2 hr + 1 of fragment f, relative to the warp tile's corner
__device__ __forceinline__ int frow(int hr) {
  return ((threadIdx.x & 31) >> 2) + 8 * hr;
}
__device__ __forceinline__ int fcol(int f) {
  return 8 * f + 2 * (threadIdx.x & 3);
}

// the sum over the 4 lanes of a quad (an accumulator row's threads)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// rows [0, kRows) x columns [0, kCols) of a bf16 matrix (element (r, c)
// at src[r * ld + c]) into s[r * sld + c] by 16-byte cp.async, zeros
// where r >= rows or c >= cols (a multiple of 8)
template <int kRows, int kCols>
__device__ __forceinline__ void stage_bf16(uint32_t s, int sld,
                                           const bf16* src, long long ld,
                                           int rows, int cols) {
  constexpr int kC = kCols / 8;
  for (int i = threadIdx.x; i < kRows * kC; i += blockDim.x) {
    const int r = i / kC, c = (i - r * kC) * 8;
    const bool in = r < rows && c < cols;
    hopper::cp_async16(s + (r * sld + c) * 2, in ? src + r * ld + c : src, in);
  }
}

// dts[i] = dt of chunk position i and cum[i] = the inclusive prefix sum
// of dt * a, for i < Q <= 256 = blockDim.x; zeros past Q.  Ends with a
// barrier.
__device__ __forceinline__ void chunk_scan(float* dts, float* cum,
                                           float* wsum, const float* dtp,
                                           long long dls, float a, int Q) {
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const float d = tid < Q ? dtp[tid * dls] : 0.f;
  float v = d * a;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += n;
  }
  if (lane == 31) wsum[w] = v;
  __syncthreads();
  float off = 0.f;
  for (int i = 0; i < w; ++i) off += wsum[i];
  dts[tid] = d;
  cum[tid] = tid < Q ? v + off : 0.f;
  __syncthreads();
}

// the scratch's parts: bf16 hi + lo planes of dy (B, L, H, P) and of
// the states S_in and cotangents dS at the chunk boundaries (B, nc, H,
// P, N), then f32: U and its dS (B, nc, H, P, N), inner (B, nc, H), dcum
// and W (B, L, H); each part starts 16-byte aligned
struct Scratch {
  bf16 *dyh, *dyl, *sh, *sl, *dsh, *dsl;
  float *U, *inner, *dcum, *W;
  long long floats;
  Scratch(void* base, int Bsz, int L, int H, int P, int N, int Q) {
    const long long nc = L / Q, X = Bsz * nc * H * P * N,
                    Y = static_cast<long long>(Bsz) * L * H * P;
    const long long r4i = (Bsz * nc * H + 3) / 4 * 4,
                    r4r = (static_cast<long long>(Bsz) * L * H + 3) / 4 * 4;
    bf16* hb = static_cast<bf16*>(base);
    dyh = hb;
    dyl = dyh + Y;
    sh = dyl + Y;
    sl = sh + X;
    dsh = sl + X;
    dsl = dsh + X;
    U = reinterpret_cast<float*>(dsl + X);
    inner = U + X;
    dcum = inner + r4i;
    W = dcum + r4r;
    floats = Y + 3 * X + r4i + 2 * r4r;
  }
};

template <int kN>
struct Lay {
  static constexpr int kLdN = kN + 8;
  static constexpr int kNF = kN / 16;  // n8 fragments of a warp's kN / 2
  static constexpr int kRowN = kT * kLdN * 2, kRowP = kT * kLdP * 2;
  static constexpr int kTT = kT * kLdT * 2, kSt = kP * kLdN * 2;
  // ssd_bwd_tc: C_t, B_t, x_t, dy_t hi + lo, a state's hi + lo (S_in,
  // then dS), two buffers of the other tile (its B or C, and its x or dy
  // hi + lo), T1 and T2 hi + lo, then f32 cum, dt, the row sums, W and
  // dxd . x, and 8 warp sums
  static constexpr int sCt = 0, sBt = kRowN, sXt = 2 * kRowN;
  static constexpr int sDyH = sXt + kRowP, sDyL = sDyH + kRowP;
  static constexpr int sStH = sDyL + kRowP, sStL = sStH + kSt;
  static constexpr int sO = sStL + kSt;  // + buffer * kOther
  static constexpr int sO2H = sO + kRowN, sO2L = sO2H + kRowP;
  static constexpr int kOther = kRowN + 2 * kRowP;
  static constexpr int sT1H = sO + 2 * kOther, sT1L = sT1H + kTT;
  static constexpr int sT2H = sT1L + kTT, sT2L = sT2H + kTT;
  static constexpr int sF = sT2L + kTT;
  static constexpr int bytes = sF + 4 * (2 * kMaxQ + 3 * kT + 8);
  // ssd_bwd_u: dy e^cum hi + lo, C, then f32 cum, dt, 8 warp sums
  static constexpr int uDyH = 0, uDyL = kRowP, uC = 2 * kRowP;
  static constexpr int uF = uC + kRowN;
  static constexpr int ubytes = uF + 4 * (2 * kMaxQ + 8);
};

// U_c = sum_q exp(cum_q) dy_q^T C_q (P, N) of chunk c, one CTA a (batch,
// chunk, head): 8 warps of 16 p x kN / 2 n; dy e^cum as bf16 hi + lo.
// It also writes dy's hi + lo planes for ssd_bwd_tc.
template <int kN>
__global__ void __launch_bounds__(256)
ssd_bwd_u(const float* __restrict__ dt, const float* __restrict__ A,
          const bf16* __restrict__ Cm, const float* __restrict__ dy,
          float* __restrict__ U, float* __restrict__ inner,
          bf16* __restrict__ dyh_out,
          bf16* __restrict__ dyl_out, Strides ds, Strides cs, Strides ys,
          int L, int H, int G, int P, int N, int Q) {
  using Y = Lay<kN>;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  const uint32_t sb = hopper::smem_u32(smem_raw);
  bf16* dyh = reinterpret_cast<bf16*>(smem_raw + Y::uDyH);
  bf16* dyl = reinterpret_cast<bf16*>(smem_raw + Y::uDyL);
  float* cum = reinterpret_cast<float*>(smem_raw + Y::uF);
  float* dts = cum + kMaxQ;
  float* wsum = dts + kMaxQ;
  const int nc = L / Q;
  const int h = blockIdx.x % H, c = (blockIdx.x / H) % nc,
            b = blockIdx.x / (H * nc);
  const int g = h / (H / G);
  const long long l0 = static_cast<long long>(c) * Q;
  chunk_scan(dts, cum, wsum, dt + b * ds.b + l0 * ds.l + h * ds.h, ds.l,
             A[h], Q);
  if (threadIdx.x == 0) inner[blockIdx.x] = 0.f;  // ssd_bwd_scan's sums
  const int warp = threadIdx.x >> 5, mi = warp & 3, nh = warp >> 2;
  float acc[Y::kNF][4];
  zero(acc);
  for (int q0 = 0; q0 < Q; q0 += kT) {
    const int rows = min(kT, Q - q0);
    __syncthreads();  // the last tile's reads are done
    stage_bf16<kT, kN>(sb + Y::uC, Y::kLdN,
                       Cm + b * cs.b + (l0 + q0) * cs.l + g * cs.h, cs.l,
                       rows, N);
    hopper::cp_async_commit();
    // the rows of dy: hi + lo planes out, and scaled by e^cum into shared
    // memory
    {
      constexpr int kC = kP / 4;
      const float* src = dy + b * ys.b + (l0 + q0) * ys.l + h * ys.h;
      const long long out =
          ((static_cast<long long>(b) * L + l0 + q0) * H + h) * P;
      for (int i = threadIdx.x; i < kT * kC; i += blockDim.x) {
        const int r = i / kC, cc = (i - r * kC) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        uint2 hh, ll;
        if (r < rows && cc < P) {
          v = *reinterpret_cast<const float4*>(src + r * ys.l + cc);
          split(v.x, v.y, hh.x, ll.x);
          split(v.z, v.w, hh.y, ll.y);
          const long long at = out + static_cast<long long>(r) * H * P + cc;
          *reinterpret_cast<uint2*>(dyh_out + at) = hh;
          *reinterpret_cast<uint2*>(dyl_out + at) = ll;
          const float w = expf(cum[q0 + r]);
          v.x *= w; v.y *= w; v.z *= w; v.w *= w;
        }
        split(v.x, v.y, hh.x, ll.x);
        split(v.z, v.w, hh.y, ll.y);
        *reinterpret_cast<uint2*>(dyh + r * kLdP + cc) = hh;
        *reinterpret_cast<uint2*>(dyl + r * kLdP + cc) = ll;
      }
    }
    hopper::cp_async_wait<0>();
    __syncthreads();
    // acc (p, n) += (dy e)^T [p][q] C [q][n]
    mma_tile<Y::kNF, kT, true, false, true, false>(
        acc, sb + Y::uDyH, sb + Y::uDyL, kLdP, 16 * mi, sb + Y::uC, 0,
        Y::kLdN, nh * (kN / 2));
  }
  float* u = U + ((static_cast<long long>(b) * nc + c) * H + h) * P * N;
#pragma unroll
  for (int f = 0; f < Y::kNF; ++f)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int p = 16 * mi + frow(hr);
      const int n = nh * (kN / 2) + fcol(f);
      if (p < P && n < N)
        *reinterpret_cast<float2*>(u + p * N + n) =
            make_float2(acc[f][2 * hr], acc[f][2 * hr + 1]);
    }
}

__device__ __forceinline__ void split1(float v, bf16& hi, bf16& lo) {
  hi = __float2bfloat16(v);
  lo = __float2bfloat16(v - __bfloat162float(hi));
}

// The state's cotangent at each chunk boundary, one CTA a (batch, head,
// slice of kSlice of the P N elements) walking the chunks in reverse:
// dS_c (the cotangent of the state leaving chunk c) = exp(tot_{c+1})
// dS_{c+1} + U_{c+1}, from dS_{nc-1} = dstate (or zeros).  dS_c and S_in_c
// go out as bf16 hi + lo planes; inner[b, c, h] (zeroed by ssd_bwd_u)
// gathers <dS_c, S_in_c> for the chunk's dtot by one atomic a CTA.
constexpr int kSlice = 1024;
__global__ void __launch_bounds__(256)
ssd_bwd_scan(const float* __restrict__ dt, const float* __restrict__ A,
             const float* __restrict__ states,
             const float* __restrict__ dstate, const float* __restrict__ U,
             bf16* __restrict__ sh, bf16* __restrict__ sl,
             bf16* __restrict__ dsh, bf16* __restrict__ dsl,
             float* __restrict__ inner, Strides ds, int L, int H, int P,
             int N, int Q) {
  constexpr int kPer = kSlice / 256;
  __shared__ float red[8];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nc = L / Q, PN = P * N, ns = (PN + kSlice - 1) / kSlice;
  const int bh = blockIdx.x / ns, e0 = (blockIdx.x - bh * ns) * kSlice;
  const int b = bh / H, h = bh - b * H;
  const float a = A[h];
  float dS[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int e = e0 + tid + 256 * j;
    dS[j] = dstate != nullptr && e < PN
                ? dstate[(static_cast<long long>(b) * H + h) * PN + e]
                : 0.f;
  }
  for (int c = nc - 1; c >= 0; --c) {
    // tot_c = sum of dt a over the chunk
    float t = 0.f;
    for (int q = tid; q < Q; q += 256)
      t += dt[b * ds.b + (static_cast<long long>(c) * Q + q) * ds.l +
              h * ds.h];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    __syncthreads();  // the last chunk's reads of red are done
    if (lane == 0) red[warp] = t;
    __syncthreads();
    float tot = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) tot += red[w];
    const float decay = expf(tot * a);
    const long long at = ((static_cast<long long>(b) * nc + c) * H + h) * PN;
    float ip = 0.f;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = e0 + tid + 256 * j;
      if (e >= PN) continue;
      const float sv = states[at + e];
      ip = fmaf(dS[j], sv, ip);
      split1(sv, sh[at + e], sl[at + e]);
      split1(dS[j], dsh[at + e], dsl[at + e]);
      dS[j] = fmaf(decay, dS[j], U[at + e]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ip += __shfl_xor_sync(0xffffffffu, ip, o);
    __syncthreads();
    if (lane == 0) red[warp] = ip;
    __syncthreads();
    if (tid == 0) {
      float v = 0.f;
      for (int w = 0; w < 8; ++w) v += red[w];
      atomicAdd(inner + (static_cast<long long>(b) * nc + c) * H + h, v);
    }
  }
}

// The chunk-local products, one CTA a (batch, chunk, 64-position tile t,
// group, block of kHeads of its heads), 8 warps.  For each head of the
// block, with dS_c from ssd_bwd_scan:
//
// * sweep 1, rows q of tile t: dC_q = e^cum_q dy_q S_in + sum over the
//   k-tiles j <= t of T1 B_j, T1 = (dy x_j^T) dt_k L (16 q x 32 k a warp,
//   then 16 q x kN / 2 n); the row sums of M = CB o T1 and e^cum (dy S_in)
//   . C into dcum.
// * sweep 2, rows k of tile t: dxd_k = sum over the q-tiles i >= t of
//   T2^T dy_i + w_k dS B_k, dB_k = sum of T1^T C_i + w_k dt_k dS^T x_k;
//   the column sums of M out of dcum, and W_k.
//
// Every input is bf16 (x, B, C) or a bf16 hi + lo pair of planes (dy, the
// states, dS) that cp.async brings in; the pairs' other tiles go through
// two buffers, the next one's copies in flight while this one's products
// run.  T1 and T2 are split into hi + lo in shared memory.  dC and dB stay
// in registers across the block's heads, then go to the f32 outputs by
// one atomic an element; dx is written, and ddt (dxd . x for now), dcum -
// W and W go to the f32 rows that ssd_bwd_finish reads.
template <int kN>
__global__ void __launch_bounds__(256, 1)
ssd_bwd_tc(const bf16* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const bf16* __restrict__ Bm,
           const bf16* __restrict__ Cm, Scratch sc, bf16* __restrict__ dx,
           float* __restrict__ ddt, float* __restrict__ dB,
           float* __restrict__ dC, Strides xs, Strides ds, Strides bs,
           Strides cs, int L, int H, int G, int P, int N, int Q) {
  using Y = Lay<kN>;
  constexpr int kNF = Y::kNF, kLdN = Y::kLdN, kHalf = kN / 2;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  const uint32_t sb = hopper::smem_u32(smem_raw);
  const bf16* Ct = reinterpret_cast<const bf16*>(smem_raw + Y::sCt);
  const bf16* Xt = reinterpret_cast<const bf16*>(smem_raw + Y::sXt);
  bf16* t1h = reinterpret_cast<bf16*>(smem_raw + Y::sT1H);
  bf16* t1l = reinterpret_cast<bf16*>(smem_raw + Y::sT1L);
  bf16* t2h = reinterpret_cast<bf16*>(smem_raw + Y::sT2H);
  bf16* t2l = reinterpret_cast<bf16*>(smem_raw + Y::sT2L);
  float* cum = reinterpret_cast<float*>(smem_raw + Y::sF);
  float* dts = cum + kMaxQ;
  float* dcum_s = dts + kMaxQ;  // kT each: row sums, W, dxd . x
  float* w_s = dcum_s + kT;
  float* dxx_s = w_s + kT;
  float* wsum = dxx_s + kT;

  const int nc = L / Q, nt = (Q + kT - 1) / kT;
  const int rep = H / G, nhb = (rep + kHeads - 1) / kHeads;
  int idx = blockIdx.x;
  const int hb = idx % nhb;
  idx /= nhb;
  const int g = idx % G;
  idx /= G;
  const int t = idx % nt;
  idx /= nt;
  const int c = idx % nc, b = idx / nc;
  const int h0 = g * rep + hb * kHeads;
  const int nh_blk = min(kHeads, rep - hb * kHeads);
  const long long l0 = static_cast<long long>(c) * Q;  // the chunk's start
  const int p0 = t * kT;                                // the tile's, in it
  const int rows_t = min(kT, Q - p0);
  const int n1 = t + 1, n_pairs = n1 + nt - t;  // sweep 1's, both sweeps'
  const int tid = threadIdx.x, warp = tid >> 5;
  const int mi = warp & 3;   // 16-row slice of the tile
  const int hi = warp >> 2;  // half: of the other tile's 64 (phase a), of
                             // kN (dB, dC) or of kP (dxd)
  const long long HP = static_cast<long long>(H) * P;

  // the group's C and B rows of tile t
  stage_bf16<kT, kN>(sb + Y::sCt, kLdN,
                     Cm + b * cs.b + (l0 + p0) * cs.l + g * cs.h, cs.l,
                     rows_t, N);
  stage_bf16<kT, kN>(sb + Y::sBt, kLdN,
                     Bm + b * bs.b + (l0 + p0) * bs.l + g * bs.h, bs.l,
                     rows_t, N);
  hopper::cp_async_commit();

  float dC_acc[kNF][4], dB_acc[kNF][4];
  zero(dC_acc);
  zero(dB_acc);

  for (int hh = 0; hh < nh_blk; ++hh) {
    const int h = h0 + hh;
    // pair p's other tile into buffer buf: sweep 1's B_j and x_j, sweep
    // 2's C_i and dy_i hi + lo
    auto issue = [&](int pr, int buf) {
      const uint32_t o = sb + Y::sO + buf * Y::kOther;
      const int r0 = (pr < n1 ? pr : t + pr - n1) * kT;
      const int rows = min(kT, Q - r0);
      if (pr < n1) {
        stage_bf16<kT, kN>(o, kLdN,
                           Bm + b * bs.b + (l0 + r0) * bs.l + g * bs.h, bs.l,
                           rows, N);
        stage_bf16<kT, kP>(o + Y::kRowN, kLdP,
                           x + b * xs.b + (l0 + r0) * xs.l + h * xs.h, xs.l,
                           rows, P);
      } else {
        const long long at = ((b * L + l0 + r0) * H + h) * P;
        stage_bf16<kT, kN>(o, kLdN,
                           Cm + b * cs.b + (l0 + r0) * cs.l + g * cs.h, cs.l,
                           rows, N);
        stage_bf16<kT, kP>(o + Y::kRowN, kLdP, sc.dyh + at, HP, rows, P);
        stage_bf16<kT, kP>(o + Y::kRowN + Y::kRowP, kLdP, sc.dyl + at, HP,
                           rows, P);
      }
      hopper::cp_async_commit();
    };
    const long long hs = static_cast<long long>((b * nc + c) * H + h) * P * N;
    __syncthreads();  // the last head is done with every buffer
    if (tid < kT) dcum_s[tid] = w_s[tid] = dxx_s[tid] = 0.f;
    {
      const long long at = ((b * L + l0 + p0) * H + h) * P;
      stage_bf16<kT, kP>(sb + Y::sXt, kLdP,
                         x + b * xs.b + (l0 + p0) * xs.l + h * xs.h, xs.l,
                         rows_t, P);
      stage_bf16<kT, kP>(sb + Y::sDyH, kLdP, sc.dyh + at, HP, rows_t, P);
      stage_bf16<kT, kP>(sb + Y::sDyL, kLdP, sc.dyl + at, HP, rows_t, P);
      stage_bf16<kP, kN>(sb + Y::sStH, kLdN, sc.sh + hs, N, P, N);
      stage_bf16<kP, kN>(sb + Y::sStL, kLdN, sc.sl + hs, N, P, N);
      hopper::cp_async_commit();
    }
    issue(0, 0);
    chunk_scan(dts, cum, wsum, dt + b * ds.b + l0 * ds.l + h * ds.h, ds.l,
               A[h], Q);
    const float tot = cum[Q - 1];
    hopper::cp_async_wait<0>();  // the head's tiles and pair 0's
    __syncthreads();

    // ---- sweep 1's state term: dC += e^cum dy S_in, and its row sums
    {
      float tmp[kNF][4];
      zero(tmp);
      // dy S_in, 16 q x kN / 2 n
      mma_tile<kNF, kP, false, false, true, true>(
          tmp, sb + Y::sDyH, sb + Y::sDyL, kLdP, 16 * mi, sb + Y::sStH,
          sb + Y::sStL, kLdN, hi * kHalf);
      float rp[2] = {0.f, 0.f};
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = 16 * mi + frow(hr);
        const float e = r < rows_t ? expf(cum[p0 + r]) : 0.f;
#pragma unroll
        for (int f = 0; f < kNF; ++f)
#pragma unroll
          for (int z = 0; z < 2; ++z) {
            const int n = hi * kHalf + fcol(f) + z;
            const float v = tmp[f][2 * hr + z] * e;
            dC_acc[f][2 * hr + z] += v;
            rp[hr] = fmaf(v, bf(Ct, r * kLdN + n), rp[hr]);
          }
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const float v = quad_sum(rp[hr]);
        if ((tid & 3) == 0) atomicAdd(dcum_s + 16 * mi + frow(hr), v);
      }
    }
    float dxd[4][4];  // 16 k x 32 p: columns 32 hi ..
    zero(dxd);
    for (int pr = 0; pr < n_pairs; ++pr) {
      const int buf = pr & 1;
      const uint32_t o = sb + Y::sO + buf * Y::kOther;
      hopper::cp_async_wait<0>();  // this pair's tiles (and dS)
      __syncthreads();  // ... everyone's; the last pair is done with the
                        // other buffer and T
      if (pr == 0) {  // every warp is done with S_in: dS takes its planes
        stage_bf16<kP, kN>(sb + Y::sStH, kLdN, sc.dsh + hs, N, P, N);
        stage_bf16<kP, kN>(sb + Y::sStL, kLdN, sc.dsl + hs, N, P, N);
      }
      if (pr + 1 < n_pairs) issue(pr + 1, buf ^ 1);
      else hopper::cp_async_commit();
      if (pr < n1) {
        // ---- sweep 1, k-tile j: CB = C_t B_j^T and DX = dy x_j^T (16 q x
        // 32 k), T1 = DX dt_k L and the row sums of CB o T1; then dC +=
        // T1 B_j (16 q x kN / 2 n)
        const int k0 = pr * kT;
        float cb[4][4], dxv[4][4];
        zero(cb);
        zero(dxv);
        mma_tile<4, kN, false, true, false, false>(cb, sb + Y::sCt, 0, kLdN,
                                               16 * mi, o, 0, kLdN, 32 * hi);
        mma_tile<4, kP, false, true, true, false>(dxv, sb + Y::sDyH,
                                              sb + Y::sDyL, kLdP, 16 * mi,
                                              o + Y::kRowN, 0, kLdP,
                                              32 * hi);
        float rp[2] = {0.f, 0.f};
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = 16 * mi + frow(hr), qi = p0 + r;
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            float tv[2];
#pragma unroll
            for (int z = 0; z < 2; ++z) {
              const int kj = k0 + 32 * hi + fcol(f) + z;
              // select on the causal triangle before the exp
              const bool ok = qi < Q && kj <= qi;
              const float lv =
                  ok ? hopper::ex2((cum[qi] - cum[kj]) * kLog2e) : 0.f;
              tv[z] = ok ? dxv[f][2 * hr + z] * dts[kj] * lv : 0.f;
              rp[hr] = fmaf(cb[f][2 * hr + z], tv[z], rp[hr]);
            }
            uint32_t th, tl;
            split(tv[0], tv[1], th, tl);
            const int at = r * kLdT + 32 * hi + fcol(f);
            *reinterpret_cast<uint32_t*>(t1h + at) = th;
            *reinterpret_cast<uint32_t*>(t1l + at) = tl;
          }
        }
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const float v = quad_sum(rp[hr]);
          if ((tid & 3) == 0) atomicAdd(dcum_s + 16 * mi + frow(hr), v);
        }
        __syncthreads();
        mma_tile<kNF, kT, false, false, true, false>(
            dC_acc, sb + Y::sT1H, sb + Y::sT1L, kLdT, 16 * mi, o, 0, kLdN,
            hi * kHalf);
      } else {
        // ---- sweep 2, q-tile i: CB^T = B_t C_i^T and x_t dy_i^T (16 k x
        // 32 q), T1^T, T2^T and the column sums; then dB += T1^T C_i (16 k
        // x kN / 2 n) and dxd += T2^T dy_i (16 k x 32 p)
        const int q0 = (t + pr - n1) * kT;
        float cb[4][4], xdy[4][4];
        zero(cb);
        zero(xdy);
        mma_tile<4, kN, false, true, false, false>(cb, sb + Y::sBt, 0, kLdN,
                                               16 * mi, o, 0, kLdN, 32 * hi);
        mma_tile<4, kP, false, true, false, true>(
            xdy, sb + Y::sXt, 0, kLdP, 16 * mi, o + Y::kRowN,
            o + Y::kRowN + Y::kRowP, kLdP, 32 * hi);
        float cp[2] = {0.f, 0.f};
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = 16 * mi + frow(hr), kk = p0 + r;
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            float tv[2], uv[2];
#pragma unroll
            for (int z = 0; z < 2; ++z) {
              const int qq = q0 + 32 * hi + fcol(f) + z;
              // select on the causal triangle before the exp
              const bool ok = qq < Q && kk <= qq;
              const float lv =
                  ok ? hopper::ex2((cum[qq] - cum[kk]) * kLog2e) : 0.f;
              tv[z] = ok ? xdy[f][2 * hr + z] * dts[kk] * lv : 0.f;
              uv[z] = ok ? cb[f][2 * hr + z] * lv : 0.f;
              cp[hr] = fmaf(-cb[f][2 * hr + z], tv[z], cp[hr]);
            }
            uint32_t th, tl;
            const int at = r * kLdT + 32 * hi + fcol(f);
            split(tv[0], tv[1], th, tl);
            *reinterpret_cast<uint32_t*>(t1h + at) = th;
            *reinterpret_cast<uint32_t*>(t1l + at) = tl;
            split(uv[0], uv[1], th, tl);
            *reinterpret_cast<uint32_t*>(t2h + at) = th;
            *reinterpret_cast<uint32_t*>(t2l + at) = tl;
          }
        }
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const float v = quad_sum(cp[hr]);
          if ((tid & 3) == 0) atomicAdd(dcum_s + 16 * mi + frow(hr), v);
        }
        __syncthreads();
        mma_tile<kNF, kT, false, false, true, false>(
            dB_acc, sb + Y::sT1H, sb + Y::sT1L, kLdT, 16 * mi, o, 0, kLdN,
            hi * kHalf);
        mma_tile<4, kT, false, false, true, true>(
            dxd, sb + Y::sT2H, sb + Y::sT2L, kLdT, 16 * mi, o + Y::kRowN,
            o + Y::kRowN + Y::kRowP, kLdP, 32 * hi);
      }
    }

    // ---- sweep 2's state terms: dxd += w_k dS B_k (and W_k = dt_k x_k .
    // (w_k dS B_k)), dB += w_k dt_k x_k dS
    hopper::cp_async_wait<0>();
    __syncthreads();
    {
      float sd[4][4];
      zero(sd);
      mma_tile<4, kN, false, true, false, true>(sd, sb + Y::sBt, 0, kLdN,
                                            16 * mi, sb + Y::sStH,
                                            sb + Y::sStL, kLdN, 32 * hi);
      float tmp[kNF][4];
      zero(tmp);
      mma_tile<kNF, kP, false, false, false, true>(
          tmp, sb + Y::sXt, 0, kLdP, 16 * mi, sb + Y::sStH, sb + Y::sStL,
          kLdN, hi * kHalf);
      float wp[2] = {0.f, 0.f};
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = 16 * mi + frow(hr);
        const bool in = r < rows_t;
        const float w = in ? expf(tot - cum[p0 + r]) : 0.f;
        const float d = in ? dts[p0 + r] : 0.f;
#pragma unroll
        for (int f = 0; f < 4; ++f)
#pragma unroll
          for (int z = 0; z < 2; ++z) {
            const int pc = 32 * hi + fcol(f) + z;
            const float v = sd[f][2 * hr + z] * w;
            dxd[f][2 * hr + z] += v;
            wp[hr] = fmaf(d * bf(Xt, r * kLdP + pc), v, wp[hr]);
          }
#pragma unroll
        for (int f = 0; f < kNF; ++f)
#pragma unroll
          for (int z = 0; z < 2; ++z)
            dB_acc[f][2 * hr + z] = fmaf(tmp[f][2 * hr + z], w * d,
                                         dB_acc[f][2 * hr + z]);
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const float v = quad_sum(wp[hr]);
        if ((tid & 3) == 0) atomicAdd(w_s + 16 * mi + frow(hr), v);
      }
    }

    // ---- the head's rows: dx = dxd dt, dxd . x; then the f32 rows
    {
      bf16* dxb = dx + ((static_cast<long long>(b) * L + l0 + p0) * H + h) * P;
      float xp[2] = {0.f, 0.f};
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = 16 * mi + frow(hr);
        if (r >= rows_t) continue;
        const float d = dts[p0 + r];
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int pc = 32 * hi + fcol(f);
          if (pc >= P) continue;
          const float v0 = dxd[f][2 * hr], v1 = dxd[f][2 * hr + 1];
          xp[hr] = fmaf(v0, bf(Xt, r * kLdP + pc),
                        fmaf(v1, bf(Xt, r * kLdP + pc + 1), xp[hr]));
          *reinterpret_cast<uint32_t*>(dxb + r * HP + pc) =
              hopper::pack_bf16(v0 * d, v1 * d);
        }
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const float v = quad_sum(xp[hr]);
        if ((tid & 3) == 0) atomicAdd(dxx_s + 16 * mi + frow(hr), v);
      }
    }
    __syncthreads();
    if (tid < rows_t) {
      const long long at = (static_cast<long long>(b) * L + l0 + p0 + tid) * H + h;
      ddt[at] = dxx_s[tid];
      sc.dcum[at] = dcum_s[tid] - w_s[tid];
      sc.W[at] = w_s[tid];
    }
  }

  // dC and dB of the block's heads, summed over the group's blocks
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = 16 * mi + frow(hr);
    if (r >= rows_t) continue;
    const long long row =
        ((static_cast<long long>(b) * L + l0 + p0 + r) * G + g) * N;
#pragma unroll
    for (int f = 0; f < kNF; ++f)
#pragma unroll
      for (int z = 0; z < 2; ++z) {
        const int n = hi * kHalf + fcol(f) + z;
        if (n >= N) continue;
        atomicAdd(dC + row + n, dC_acc[f][2 * hr + z]);
        atomicAdd(dB + row + n, dB_acc[f][2 * hr + z]);
      }
  }
}

// One warp a (batch, chunk, head): dtot = exp(tot) <dS, S_in> + sum_k W_k,
// d(dA) = the reverse cumsum of dcum plus dtot, ddt += d(dA) A and dA_h +=
// sum d(dA) dt (one atomic a warp).
__global__ void __launch_bounds__(256)
ssd_bwd_finish(const float* __restrict__ dt, const float* __restrict__ A,
               const float* __restrict__ inner,
               const float* __restrict__ dcum, const float* __restrict__ W,
               float* __restrict__ ddt, float* __restrict__ dA, Strides ds,
               int Bsz, int L, int H, int Q) {
  const int lane = threadIdx.x & 31;
  const int nc = L / Q;
  const long long item =
      static_cast<long long>(blockIdx.x) * 8 + (threadIdx.x >> 5);
  if (item >= static_cast<long long>(Bsz) * nc * H) return;
  const int h = static_cast<int>(item % H);
  const int c = static_cast<int>((item / H) % nc);
  const int b = static_cast<int>(item / (static_cast<long long>(H) * nc));
  const float a = A[h];
  const long long l0 = static_cast<long long>(c) * Q;
  const float* dtp = dt + b * ds.b + l0 * ds.l + h * ds.h;
  const long long base = (static_cast<long long>(b) * L + l0) * H + h;
  float tot = 0.f, ws = 0.f;
  for (int k = lane; k < Q; k += 32) {
    tot += dtp[k * ds.l] * a;
    ws += W[base + static_cast<long long>(k) * H];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    tot += __shfl_xor_sync(0xffffffffu, tot, o);
    ws += __shfl_xor_sync(0xffffffffu, ws, o);
  }
  float carry = expf(tot) * inner[item] + ws;  // dtot
  float part = 0.f;
  for (int s0 = ((Q - 1) / 32) * 32; s0 >= 0; s0 -= 32) {
    const int k = s0 + lane;
    float v = k < Q ? dcum[base + static_cast<long long>(k) * H] : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {  // suffix sums within the strip
      const float n = __shfl_down_sync(0xffffffffu, v, o);
      if (lane + o < 32) v += n;
    }
    const float da = v + carry;
    carry += __shfl_sync(0xffffffffu, v, 0);
    if (k < Q) {
      float* t = ddt + base + static_cast<long long>(k) * H;
      *t = fmaf(da, a, *t);
      part = fmaf(da, dtp[k * ds.l], part);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
  if (lane == 0) atomicAdd(dA + h, part);
}

template <int kN>
int launch_kn(const void* x, const void* dt, const void* A, const void* Bm,
              const void* Cm, const void* states, const void* dy,
              const void* dstate, void* dx, void* ddt, void* dA, void* dB,
              void* dC, const Scratch& sc, int Bsz, int L, int H, int G,
              int P, int N, int Q, const long long* st, cudaStream_t stream) {
  using Y = Lay<kN>;
  static bool opted_in = false;  // opt in to the shared memory once
  if (!opted_in) {
    cudaFuncSetAttribute(ssd_bwd_tc<kN>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         Y::bytes);
    cudaFuncSetAttribute(ssd_bwd_u<kN>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         Y::ubytes);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const Strides xs{st[0], st[1], st[2]}, ds{st[3], st[4], st[5]},
      bs{st[6], st[7], st[8]}, cs{st[9], st[10], st[11]},
      ys{st[12], st[13], st[14]};
  const int nc = L / Q, nt = (Q + kT - 1) / kT;
  const int rep = H / G, nhb = (rep + kHeads - 1) / kHeads;
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  ssd_bwd_u<kN><<<Bsz * nc * H, 256, Y::ubytes, stream>>>(
      dtf, Af, static_cast<const bf16*>(Cm), static_cast<const float*>(dy),
      sc.U, sc.inner, sc.dyh, sc.dyl, ds, cs, ys, L, H, G, P, N, Q);
  ssd_bwd_scan<<<Bsz * H * ((P * N + kSlice - 1) / kSlice), 256, 0, stream>>>(
      dtf, Af, static_cast<const float*>(states),
      static_cast<const float*>(dstate), sc.U, sc.sh, sc.sl, sc.dsh, sc.dsl,
      sc.inner, ds, L, H, P, N, Q);
  ssd_bwd_tc<kN><<<Bsz * nc * nt * G * nhb, 256, Y::bytes, stream>>>(
      static_cast<const bf16*>(x), dtf, Af, static_cast<const bf16*>(Bm),
      static_cast<const bf16*>(Cm), sc, static_cast<bf16*>(dx),
      static_cast<float*>(ddt), static_cast<float*>(dB),
      static_cast<float*>(dC), xs, ds, bs, cs, L, H, G, P, N, Q);
  const long long warps = static_cast<long long>(Bsz) * nc * H;
  ssd_bwd_finish<<<static_cast<unsigned>((warps + 7) / 8), 256, 0, stream>>>(
      dtf, Af, sc.inner, sc.dcum, sc.W, static_cast<float*>(ddt),
      static_cast<float*>(dA), ds, Bsz, L, H, Q);
  return static_cast<int>(cudaGetLastError());
}

int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* states, const void* dy,
           const void* dstate, void* dx, void* ddt, void* dA, void* dB,
           void* dC, void* scratch, long long scratch_len, int Bsz, int L,
           int H, int G, int P, int N, int Q, const long long* st,
           void* stream) {
  if (Bsz < 1 || L < 1 || Q < 1 || Q > kMaxQ || L % Q != 0 || G < 1 ||
      H % G != 0 || P < 8 || P > kP || P % 8 || N < 8 || N > 128 || N % 8 ||
      static_cast<long long>(Bsz) * (L / Q) * H * ((Q + kT - 1) / kT) >
          0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte rows: x, B and C by cp.async, dy by float4
  const void* bf_ptrs[3] = {x, Bm, Cm};
  for (const void* p : bf_ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16)
      return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < 12; ++i)  // dt's (3-5) are read one by one
    if ((i < 3 || i > 5) && st[i] % 8)
      return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(dy) % 16 || st[12] % 4 || st[13] % 4 ||
      st[14] % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const Scratch sc(scratch, Bsz, L, H, P, N, Q);
  if (scratch_len < sc.floats || reinterpret_cast<uintptr_t>(scratch) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 64)
    return launch_kn<64>(x, dt, A, Bm, Cm, states, dy, dstate, dx, ddt, dA,
                         dB, dC, sc, Bsz, L, H, G, P, N, Q, st, s);
  return launch_kn<128>(x, dt, A, Bm, Cm, states, dy, dstate, dx, ddt, dA, dB,
                        dC, sc, Bsz, L, H, G, P, N, Q, st, s);
}

}  // namespace tc

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

// The tensor-core backward: bf16 x, B and C with P and N multiples of 8
// (P <= 64, N <= 128), a chunk of at most 256, x's, B's and C's batch,
// position and head strides multiples of 8 and their pointers 16-byte
// aligned, dy's strides multiples of 4 and its pointer 16-byte aligned
// (else cudaErrorInvalidValue).  The arguments of ssd_bwd_bf16 and a
// 16-byte aligned scratch of scratch_len floats, at least B L H P + 3 X +
// 2 B L H + B (L / Q) H with X = B (L / Q) H P N, each of the last two
// terms rounded up to a multiple of 4 (what it holds is overwritten).
// Four kernels, in order on the stream.
extern "C" int ssd_bwd_bf16_tc(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm,
                               const void* states, const void* dy,
                               const void* dstate, void* dx, void* ddt,
                               void* dA, void* dB, void* dC, void* scratch,
                               long long scratch_len, int Bsz, int L, int H,
                               int G, int P, int N, int Q,
                               const long long* strides, void* stream) {
  return tc::launch(x, dt, A, Bm, Cm, states, dy, dstate, dx, ddt, dA, dB,
                    dC, scratch, scratch_len, Bsz, L, H, G, P, N, Q, strides,
                    stream);
}
