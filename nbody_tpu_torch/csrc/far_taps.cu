// One pyramid level's multipole-to-local tap sum, one thread per
// (target child, parent cell).
//
// Replaces: nbody_tpu/ops/pallas_far_taps.py, _taps_kernel /
// far_taps_pallas (the VMEM-resident tap loop of
// barnes_hut._far_conv_level). The TPU kernel approximates HIGHEST with a
// bf16 split on the MXU; this one computes in plain FP32 FMAs.
//
//   out[kt*19 + o, c] = sum_t sum_i taps[t, kt*19 + o, i] * mom[i, c + off_t]
//
// mom (80, p^3): 8 source children x [m, srel3, quad6] per parent cell,
// taps (T, 152, 80) with T = (2ws+1)^3 parent offsets in (x, y, z) order,
// out (152, p^3): 8 target children x [A3, J6, H10]. A source cell outside
// the p^3 grid contributes zero (the TPU kernel's zero pads and z masks).
//
// What bounds it on the H100: FP32 arithmetic and L1/L2 bandwidth. At the
// finest 1M level (p = 32) it is 27 * 152 * 80 * 32768 FMAs ~ 1.1e10 and
// each moment value is reused by the 19 outputs of one child. Design:
// blockIdx.y picks the target child kt; a block of 128 threads covers 128
// consecutive parent cells, so a warp's moment loads are contiguous; for
// each tap the block stages that child's 19 x 80 tap rows (6 KB) in shared
// memory, read back as warp-wide broadcasts; 19 accumulators live in
// registers. (The whole 152 x 80 tap would be 48.6 KB and need the
// dynamic shared-memory opt-in; the per-child slice does not.)

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 19;   // A3 + J6 + H10 per target child
constexpr int kIn = 80;     // 8 source children x [m, s3, q6]
constexpr int kOut = 152;   // 8 target children x 19
constexpr int kThreads = 128;

__global__ void far_taps_kernel(const float* __restrict__ mom,
                                const float* __restrict__ taps,
                                float* __restrict__ out, int p, int ws) {
  __shared__ float sh[kRows * kIn];
  const int pc = p * p * p;
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const int kt = blockIdx.y;
  const bool live = c < pc;
  const int cx = live ? c / (p * p) : 0;
  const int cy = live ? (c / p) % p : 0;
  const int cz = live ? c % p : 0;
  const int w1 = 2 * ws + 1;
  const int ntaps = w1 * w1 * w1;

  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;

  for (int t = 0; t < ntaps; ++t) {
    __syncthreads();
    const float* src = taps + (static_cast<size_t>(t) * kOut + kt * kRows) * kIn;
    for (int i = threadIdx.x; i < kRows * kIn; i += kThreads) sh[i] = src[i];
    __syncthreads();
    const int sx = cx + t / (w1 * w1) - ws;
    const int sy = cy + (t / w1) % w1 - ws;
    const int sz = cz + t % w1 - ws;
    if (!live || sx < 0 || sx >= p || sy < 0 || sy >= p || sz < 0 || sz >= p)
      continue;
    const float* m = mom + (sx * p + sy) * p + sz;
    for (int i = 0; i < kIn; ++i) {
      const float v = m[static_cast<size_t>(i) * pc];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] += sh[r * kIn + i] * v;
    }
  }
  if (live) {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      out[static_cast<size_t>(kt * kRows + r) * pc + c] = acc[r];
  }
}

}  // namespace

extern "C" int nbt_far_taps(const float* mom, const float* taps, float* out,
                            int p, int ws, void* stream) {
  const int pc = p * p * p;
  const dim3 grid((pc + kThreads - 1) / kThreads, 8);
  far_taps_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      mom, taps, out, p, ws);
  return static_cast<int>(cudaGetLastError());
}
