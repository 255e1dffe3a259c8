// The sort's row permutation: the cell-sorted rows of build_sorted_grid in
// one launch.
//
// Replaces no TPU kernel: the XLA gather of nbody_tpu/ops/sorted_window.py
// build_sorted_grid (the payload's concatenation, its row gather, the id
// gather and the cell coordinates from the sorted ids), which the port ran
// as torch's cat, two index gathers and the //, % and stack ops.
//
// For each sorted row i, with j = order[i] (the stable argsort of the cell
// ids):
//   psort[i]     = (pos[j], mass[j])                one 16-byte store
//   ids_out[i]   = ids[j]
//   csort[i]     = (id // d // d, id // d % d, id % d),  id = ids[j]
//                  (floor division and modulo, as torch's // and %)
//   extra_out[i] = extra[j]                         E columns
// csort and extra are optional. Every output is a copy of input rows, or
// integer arithmetic on them, so it is the torch composition's bit for
// bit. pos and extra are read at a row stride (the innermost stride 1),
// mass at an element stride: the sorted step hands in views of the last
// step's (N, 4) rows.
//
// What bounds it on the H100: bytes. At N = 1M without csort or extra it
// reads order (8 B a row), pos (12), mass (4) and the id (4), and writes
// 16 + 4: 48 MB, 14 us at 3.35 TB/s; csort adds 12 B a row (18 us).
// torch's gather ran one thread block a gathered row (1M blocks of 16
// bytes) and took 0.60 ms at either layout. Design: one thread a sorted
// row, 256 a block; a warp reads 32 consecutive entries of order and
// writes 32 consecutive rows of each output (psort as 512 contiguous
// bytes), so only the gathered reads scatter, and only as far as order
// departs from the identity (the sorted step's state is already in the
// last step's cell order). No shared memory.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

struct Rows {
  const long long* order;  // int64
  const float* pos;
  int64_t pos_stride;
  const float* mass;
  int64_t mass_stride;
  const int* ids;
  const float* extra;
  int64_t extra_stride;
  int e;
  int d;
  int64_t n;
  float4* psort;
  int* ids_out;
  int* csort;
  float* extra_out;
};

// a // d and a % d for d > 0, rounding towards minus infinity (torch's
// integer // and %); C's / and % round towards zero
__device__ __forceinline__ int floor_div(int a, int d, int* rem) {
  int q = a / d;
  int r = a - q * d;
  if (r < 0) {
    q -= 1;
    r += d;
  }
  *rem = r;
  return q;
}

template <bool kCsort, bool kExtra>
__global__ void __launch_bounds__(kThreads)
    payload_gather_kernel(const Rows a) {
  const int64_t i = int64_t{blockIdx.x} * kThreads + threadIdx.x;
  if (i >= a.n) return;
  const int64_t j = __ldg(a.order + i);
  const float* p = a.pos + j * a.pos_stride;
  a.psort[i] = make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2),
                           __ldg(a.mass + j * a.mass_stride));
  const int id = __ldg(a.ids + j);
  a.ids_out[i] = id;
  if constexpr (kCsort) {
    int z, y;
    const int yx = floor_div(id, a.d, &z);
    const int x = floor_div(yx, a.d, &y);
    int* c = a.csort + 3 * i;
    c[0] = x;
    c[1] = y;
    c[2] = z;
  }
  if constexpr (kExtra) {
    const float* src = a.extra + j * a.extra_stride;
    float* dst = a.extra_out + i * a.e;
    for (int c = 0; c < a.e; ++c) dst[c] = __ldg(src + c);
  }
}

template <bool kCsort, bool kExtra>
cudaError_t launch(const Rows& a, cudaStream_t stream) {
  const unsigned blocks =
      static_cast<unsigned>((a.n + kThreads - 1) / kThreads);
  payload_gather_kernel<kCsort, kExtra><<<blocks, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// order (n,) int64; pos (n, 3) at row stride pos_stride floats; mass (n,)
// at stride mass_stride; ids (n,) int32; d the ids' stride (csort only);
// extra (n, e) at row stride extra_stride, or null with e = 0; outputs
// psort (n, 4) (16-byte aligned), ids_out (n,), csort (n, 3) or null,
// extra_out (n, e) or null. Returns cudaErrorInvalidValue for n < 1, a
// misaligned psort, csort with d < 1, or e and extra not agreeing.
extern "C" int nbt_payload_gather(const long long* order, long long n,
                                  const float* pos, long long pos_stride,
                                  const float* mass, long long mass_stride,
                                  const int* ids, int d, const float* extra,
                                  long long extra_stride, int e, float* psort,
                                  int* ids_out, int* csort, float* extra_out,
                                  void* stream) {
  if (n < 1 || reinterpret_cast<uintptr_t>(psort) % 16 != 0 ||
      (csort != nullptr && d < 1) || e < 0 || (e > 0) != (extra != nullptr) ||
      (e > 0) != (extra_out != nullptr)) {
    return cudaErrorInvalidValue;
  }
  const Rows a{order, pos, pos_stride, mass, mass_stride, ids, extra,
               extra_stride, e, d, n, reinterpret_cast<float4*>(psort),
               ids_out, csort, extra_out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (csort != nullptr) {
    return e > 0 ? launch<true, true>(a, s) : launch<true, false>(a, s);
  }
  return e > 0 ? launch<false, true>(a, s) : launch<false, false>(a, s);
}
