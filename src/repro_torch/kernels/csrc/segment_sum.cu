// Per-row segment sum for Hopper (sm_90a).
//
//   out[t, b] = sum_r values[t, r] * (ids[t, r] == b),  ids outside [0, B)
//   add nothing.
//
// Replaces the Pallas kernel src/repro/kernels/segment_sum.py::segment_sum
// (body _seg_kernel), which the simulation core calls from `recount` to
// rebuild the per-(node, app) busy counts from the (T, R) busy mask.
//
// Bound: bytes.  Each input element is read once (8 + 4 bytes for f64
// values and int32 ids) and each output element written once; the work is
// one add per input element.  At the core's shape (T=256, R=1000,
// B=1250, f64) that is ~5.6 MB, ~1.7 us at 3.35 TB/s, against 256k adds.
// At that size the kernel is bound by latency long before bandwidth: the
// design spends as few dependent memory round trips as it can.
//
// Design: one CTA a row; the row's histogram lives in shared memory.  What the first version of this kernel lost its time to (its
// phases timed apart on an H100): the f64 shared-memory atomics, which
// compile to compare-and-swap loops, and the round trips of loads,
// zeroing and stores that it did one after the other.
// - Loads first: every thread loads its whole share of the row into
//   registers (16-byte loads: ids as int4, values as two double2 or one
//   float4; kUnroll vectors a thread) before it zeroes the histogram or
//   starts any atomic, so the zeroing hides under the load latency and a
//   row costs one round trip to memory.  The CTA's threads are chosen so
//   that one pass covers the row (256 threads x 4 elements at R = 1000).
//   Two and four rows a CTA were slower on an H100 (PERF.md).
// - Two histograms a row: values that are whole numbers of magnitude at
//   most 2^30 / R go to an int32 histogram with native integer
//   shared-memory atomics (exact: no sum of them can overflow); every
//   other value goes to the f64 (or f32) histogram with atomicAdd.  The
//   row's bins are the sum of the two (the int one alone where no value
//   of the row took a float atomic).  A 0/1 busy mask, the core's only
//   input, takes integer atomics alone and its sums are exact.  Zero
//   values are skipped (adding zero changes no sum that started at +0).
// - The histograms are zeroed with 16-byte shared stores and the row is
//   written with 16-byte global stores (a scalar head and tail where the
//   row's bins do not start or end on 16 bytes, e.g. odd B in f64).
// - Where R is not a multiple of 4 or a base pointer is not 16-byte
//   aligned, the same kernel runs with scalar loads (kVec = 1).
// - Where B does not fit the shared-memory tile (48 KB over both
//   histograms), an outer loop walks the bins tile by tile and each tile
//   re-reads the row.
// The TPU kernel's one-hot contraction is not carried over: a scatter
// into on-chip memory is the cheap form of a histogram on this card.
//
// Sums of whole numbers (0/1 masks) are exact whatever order the atomics
// land in; for other values the order varies from run to run and the
// result differs from a sequential sum by rounding only.
//
// The C entry points return cudaGetLastError() after the launch; the
// Python wrapper raises on a non-zero code.  `segment_sum_noop` launches
// an empty kernel with the same grid, block and shared memory (the
// launch floor).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSmemBytes = 48 * 1024;  // default dynamic limit, no opt-in
constexpr int kMaxThreads = 512;       // 128 registers a thread
constexpr int kUnroll = 4;             // vectors a thread holds per pass

template <typename T, int kVec>
struct Load;

template <typename T>
struct Load<T, 1> {
  __device__ static void values(const T* p, T (&v)[1]) { v[0] = __ldcs(p); }
  __device__ static void ids(const int32_t* p, int32_t (&v)[1]) {
    v[0] = __ldcs(p);
  }
};

template <>
struct Load<double, 4> {
  __device__ static void values(const double* p, double (&v)[4]) {
    const double2 a = __ldcs(reinterpret_cast<const double2*>(p));
    const double2 b = __ldcs(reinterpret_cast<const double2*>(p) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  }
  __device__ static void ids(const int32_t* p, int32_t (&v)[4]) {
    const int4 a = __ldcs(reinterpret_cast<const int4*>(p));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  }
};

template <>
struct Load<float, 4> {
  __device__ static void values(const float* p, float (&v)[4]) {
    const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  }
  __device__ static void ids(const int32_t* p, int32_t (&v)[4]) {
    Load<double, 4>::ids(p, v);
  }
};

// Bin i of a row: the int histogram, plus the float one where any value
// of the row took a float atomic.
template <typename T>
__device__ inline T bin(const int* ih, const T* fh, int i, bool mixed) {
  return mixed ? static_cast<T>(ih[i]) + fh[i] : static_cast<T>(ih[i]);
}

// 16 bytes of a row's bins (their start need not be 16-byte aligned in
// shared memory).
__device__ inline void store16(double* dst, const int* ih, const double* fh,
                               bool mixed) {
  *reinterpret_cast<double2*>(dst) =
      make_double2(bin(ih, fh, 0, mixed), bin(ih, fh, 1, mixed));
}
__device__ inline void store16(float* dst, const int* ih, const float* fh,
                               bool mixed) {
  *reinterpret_cast<float4*>(dst) =
      make_float4(bin(ih, fh, 0, mixed), bin(ih, fh, 1, mixed),
                  bin(ih, fh, 2, mixed), bin(ih, fh, 3, mixed));
}

// CTA blockIdx.x sums row blockIdx.x; thread t loads vectors t, t +
// blockDim.x, ... of kVec elements each.  Shared memory holds the row's
// float histogram (stride of T), then its int histogram (stride of int).
template <typename T, int kVec>
__global__ void __launch_bounds__(kMaxThreads)
segment_sum_rows(const T* __restrict__ values,
                 const int32_t* __restrict__ ids, T* __restrict__ out,
                 int R, int B, int tile, int stride, T int_cap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kW = 16 / static_cast<int>(sizeof(T));  // bins a 16 B store
  const int tpr = blockDim.x;
  const int lt = threadIdx.x;
  const long long row = blockIdx.x;
  T* fhist = reinterpret_cast<T*>(smem_raw);
  int* ihist = reinterpret_cast<int*>(fhist + stride);
  const T* vrow = values + row * R;
  const int32_t* irow = ids + row * R;
  T* orow = out + row * B;
  const int nvec = R / kVec;
  int4* zero = reinterpret_cast<int4*>(smem_raw);
  const int nzero = stride * static_cast<int>(sizeof(T) + 4) / 16;

  for (int b0 = 0; b0 < B; b0 += tile) {
    const int nb = min(tile, B - b0);
    bool mixed = false;                  // this thread took a float atomic
    for (int v0 = lt; v0 < nvec || v0 == lt; v0 += tpr * kUnroll) {
      T val[kUnroll][kVec];
      int32_t id[kUnroll][kVec];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int v = v0 + u * tpr;
        if (v < nvec) {
          Load<T, kVec>::values(vrow + static_cast<long long>(v) * kVec,
                                val[u]);
          Load<T, kVec>::ids(irow + static_cast<long long>(v) * kVec,
                             id[u]);
        } else {
#pragma unroll
          for (int e = 0; e < kVec; ++e) { val[u][e] = T(0); id[u][e] = -1; }
        }
      }
      if (v0 == lt) {
        // the first pass's loads are in flight: zero the histograms
        for (int i = lt; i < nzero; i += tpr)
          zero[i] = make_int4(0, 0, 0, 0);
        __syncthreads();
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const T x = val[u][e];
          const long long b = static_cast<long long>(id[u][e]) - b0;
          if (x == T(0) || b < 0 || b >= nb) continue;
          if (x == trunc(x) && fabs(x) <= int_cap) {
            atomicAdd(&ihist[b], static_cast<int>(x));
          } else {
            atomicAdd(&fhist[b], x);
            mixed = true;
          }
        }
      }
    }
    mixed = __syncthreads_or(mixed);
    T* dst = orow + b0;
    const int mis = static_cast<int>(
        (reinterpret_cast<uintptr_t>(dst) % 16) / sizeof(T));
    const int head = min(mis == 0 ? 0 : kW - mis, nb);
    const int nbody = (nb - head) / kW;
    const int tail0 = head + nbody * kW;
    for (int i = lt; i < head; i += tpr)
      dst[i] = bin(ihist, fhist, i, mixed);
    for (int i = lt; i < nbody; i += tpr) {
      const int k = head + i * kW;
      store16(dst + k, ihist + k, fhist + k, mixed);
    }
    for (int i = tail0 + lt; i < nb; i += tpr)
      dst[i] = bin(ihist, fhist, i, mixed);
    if (b0 + tile < B) __syncthreads();   // the next tile reuses the bins
  }
}

__global__ void noop() {}

struct Plan {
  int vec, tile, stride, block;
  size_t smem;
};

template <typename T>
Plan plan(const void* values, const void* ids, int R, int B) {
  Plan p;
  p.vec = (R % 4 == 0 && reinterpret_cast<uintptr_t>(values) % 16 == 0 &&
           reinterpret_cast<uintptr_t>(ids) % 16 == 0) ? 4 : 1;
  const int nvec = R / p.vec;
  // one vector a thread covers the row in one pass where it fits
  p.block = min(kMaxThreads, max(32, (nvec + 31) / 32 * 32));
  // a stride of 4 bins keeps both histograms 16-byte aligned
  const int cap = kSmemBytes / static_cast<int>(sizeof(T) + 4) / 4 * 4;
  p.tile = B < cap ? B : cap;
  p.stride = (p.tile + 3) / 4 * 4;
  p.smem = static_cast<size_t>(p.stride) * (sizeof(T) + 4);
  return p;
}

template <typename T>
int launch(const void* values, const void* ids, void* out, int n_rows,
           int R, int B, void* stream) {
  const Plan p = plan<T>(values, ids, R, B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* v = static_cast<const T*>(values);
  const int32_t* i = static_cast<const int32_t*>(ids);
  T* o = static_cast<T*>(out);
  // whole numbers up to this magnitude sum exactly in an int32 bin: R of
  // them stay below 2^30 (2^31 with the cap's rounding to T)
  const T int_cap = static_cast<T>((1 << 30) / (R > 0 ? R : 1));
  if (p.vec == 4)
    segment_sum_rows<T, 4><<<n_rows, p.block, p.smem, s>>>(
        v, i, o, R, B, p.tile, p.stride, int_cap);
  else
    segment_sum_rows<T, 1><<<n_rows, p.block, p.smem, s>>>(
        v, i, o, R, B, p.tile, p.stride, int_cap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int segment_sum_f64(const void* values, const void* ids,
                               void* out, int T, int R, int B,
                               void* stream) {
  return launch<double>(values, ids, out, T, R, B, stream);
}

extern "C" int segment_sum_f32(const void* values, const void* ids,
                               void* out, int T, int R, int B,
                               void* stream) {
  return launch<float>(values, ids, out, T, R, B, stream);
}

// An empty kernel launched as segment_sum_f64 would launch it: the floor
// that launch and CTA scheduling alone put under the kernel's time.
extern "C" int segment_sum_noop(const void* values, const void* ids, int T,
                                int R, int B, void* stream) {
  const Plan p = plan<double>(values, ids, R, B);
  noop<<<T, p.block, p.smem, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
