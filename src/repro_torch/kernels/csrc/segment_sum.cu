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
//
// Design: one CTA per row.  The row's histogram lives in shared memory
// in the input's dtype (1250 x 8 B = 10 KB for f64), zeroed in the kernel;
// threads stride over R with coalesced loads and atomicAdd into shared
// memory, skipping ids outside [0, B); then one coalesced write of the
// row.  Where B does not fit the shared-memory tile, an outer loop walks
// the bins tile by tile (each tile re-reads the row).  The TPU kernel's
// one-hot contraction is not carried over: a scatter into on-chip memory
// is the cheap form of a histogram on this card.
//
// Sums of 0/1 masks are integers below 2^53, so the f64 result is exact
// whatever order the atomics land in; for general values the order varies
// from run to run and the result differs from a sequential sum by
// rounding only.
//
// The C entry points return cudaGetLastError() after the launch; the
// Python wrapper raises on a non-zero code.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemBytes = 48 * 1024;  // default dynamic limit, no opt-in

template <typename T>
__global__ void __launch_bounds__(kThreads)
segment_sum_rows(const T* __restrict__ values,
                 const int32_t* __restrict__ ids,
                 T* __restrict__ out, int R, int B, int tile) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* hist = reinterpret_cast<T*>(smem_raw);
  const size_t row = blockIdx.x;
  const T* vrow = values + row * static_cast<size_t>(R);
  const int32_t* irow = ids + row * static_cast<size_t>(R);
  T* orow = out + row * static_cast<size_t>(B);
  for (int b0 = 0; b0 < B; b0 += tile) {
    const int nb = min(tile, B - b0);
    for (int i = threadIdx.x; i < nb; i += blockDim.x) hist[i] = T(0);
    __syncthreads();
    for (int r = threadIdx.x; r < R; r += blockDim.x) {
      const long long b = static_cast<long long>(irow[r]) - b0;
      if (b >= 0 && b < nb) atomicAdd(&hist[b], vrow[r]);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nb; i += blockDim.x) orow[b0 + i] = hist[i];
    __syncthreads();
  }
}

template <typename T>
int launch(const void* values, const void* ids, void* out, int T_, int R,
           int B, void* stream) {
  const int cap = kSmemBytes / static_cast<int>(sizeof(T));
  const int tile = B < cap ? B : cap;
  segment_sum_rows<T><<<T_, kThreads, tile * sizeof(T),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(values), static_cast<const int32_t*>(ids),
      static_cast<T*>(out), R, B, tile);
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
