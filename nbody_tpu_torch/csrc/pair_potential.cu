// All-pairs softened potential energy, one thread per row i.
//
// Replaces: nbody_tpu/ops/direct.py, _pe_kernel / pairwise_potential_pallas
// (1024 x 1024 VMEM tiles, a Kahan sum carried in (1, 1) output refs across
// the sequential j grid, (8, 128) output blocks for Mosaic's tiling).
//
// Computes, per block of rows, the partial sum
//   sum_{i in block} m_i * sum_{j != i} m_j / sqrt(r_ij^2 + eps^2)
// in float64; the wrapper adds the partials (float64) and applies -G/2.
// A pair with raw r^2 == 0 (self, coincident) is excluded, tested BEFORE
// eps^2 is added; r^2 is rounded step by step (dx^2 + dy^2) + dz^2 with no
// FMA contraction, as the plain twin rounds it, so both exclude the same
// pairs.
//
// What bounds it on the H100: operations. N^2 pairs at ~20 FP32 operations
// and one rsqrtf (MUFU) each; at N = 1M that is 1.0e12 pairs, >= 0.30 s at
// 67 TFLOP/s, against ~16 MB of input. Design: each block of 256 threads
// stages 256 sources as float4 (x, y, z, m) in shared memory, every thread
// sweeps the tile from there (broadcast reads), sums the tile's 256 terms in
// a float32 register and adds that partial into a float64 register sum
// (one double add per 256 pairs), so the long one-signed sum does not drift
// in float32. No sequential grid, so no Kahan carry: the block reduces its
// 256 row sums with warp shuffles and writes one double.
//
// Cross form (nbt_pair_potential_cross; the ring energy of
// nbody_tpu/parallel/step.py, sharded_energy, which the JAX package leaves
// to XLA): targets (tpos, tmass) against a separate source set (spos,
// smass), the same per-block float64 partials of
//   sum_{i in block} m_i * sum_j m_j / sqrt(r_ij^2 + eps^2), raw r^2 != 0.
// A pair of the two sets at one point (raw r^2 == 0) is excluded as the self
// pair is. The main form is the cross form of a set against itself: the same
// kernel, the same arithmetic.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;

__global__ void __launch_bounds__(kBlock)
pair_potential_kernel(const float* __restrict__ tpos,
                      const float* __restrict__ tmass, int nt,
                      const float* __restrict__ pos,
                      const float* __restrict__ mass, int n, float eps2,
                      double* __restrict__ partial) {
  __shared__ float4 tile[kBlock];
  __shared__ double warp_sum[kBlock / 32];
  const int i = blockIdx.x * kBlock + threadIdx.x;
  float xi = 0.f, yi = 0.f, zi = 0.f, mi = 0.f;
  if (i < nt) {
    xi = tpos[3 * i];
    yi = tpos[3 * i + 1];
    zi = tpos[3 * i + 2];
    mi = tmass[i];
  }
  double row = 0.0;
  for (int base = 0; base < n; base += kBlock) {
    const int j = base + threadIdx.x;
    tile[threadIdx.x] =
        j < n ? make_float4(pos[3 * j], pos[3 * j + 1], pos[3 * j + 2], mass[j])
              : make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
    const int cnt = min(kBlock, n - base);
    float part = 0.f;
#pragma unroll 8
    for (int jj = 0; jj < cnt; ++jj) {
      const float4 s = tile[jj];
      const float dx = s.x - xi;
      const float dy = s.y - yi;
      const float dz = s.z - zi;
      const float r2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      const float e = s.w * rsqrtf(r2 + eps2);
      part += (r2 == 0.f) ? 0.f : e;  // self / coincident pair excluded
    }
    row += static_cast<double>(part);
    __syncthreads();
  }
  double v = static_cast<double>(mi) * row;  // rows past nt have mi = 0
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sum[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kBlock / 32 ? warp_sum[lane] : 0.0;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) partial[blockIdx.x] = v;
  }
}

}  // namespace

// Partials of targets (tpos, tmass, nt) against sources (spos, smass, ns):
// ceil(nt / 256) doubles.
extern "C" int nbt_pair_potential_cross(const float* tpos, const float* tmass,
                                        int nt, const float* spos,
                                        const float* smass, int ns,
                                        float eps2, double* partial,
                                        void* stream) {
  if (nt > 0) {
    const int blocks = (nt + kBlock - 1) / kBlock;
    pair_potential_kernel<<<blocks, kBlock, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        tpos, tmass, nt, spos, smass, ns, eps2, partial);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nbt_pair_potential(const float* pos, const float* mass, int n,
                                  float eps2, double* partial, void* stream) {
  return nbt_pair_potential_cross(pos, mass, n, pos, mass, n, eps2, partial,
                                  stream);
}
