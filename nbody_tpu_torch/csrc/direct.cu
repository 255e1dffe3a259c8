// Direct O(N^2) softened gravity, one thread per target.
//
// Replaces: nbody_tpu/ops/direct.py, _direct_kernel / direct_forces_pallas
// (the (i, j)-tiled VMEM kernel).
//
// Computes a_i = G * sum_j m_j (x_j - x_i) / (|x_j - x_i|^2 + eps^2)^{3/2}
// in the displacement form; a coincident pair (raw r^2 == 0, including the
// self pair) contributes exactly zero. Targets may be a subset of the
// sources (the Barnes-Hut ground truth samples targets against all rows).
//
// What bounds it on the H100: arithmetic. Each pair costs ~20 FP32
// operations and one rsqrtf (MUFU); the source stream is reused by every
// target of a block, so device memory traffic is ns * 16 B per block.
// Design: each block of 256 threads stages 256 sources as float4
// (x, y, z, m) in shared memory and every thread sweeps the tile from
// there (broadcast reads, no bank conflicts); accumulation stays in
// registers and G is applied once at the end, as in the TPU kernel.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;

__global__ void direct_forces_kernel(const float* __restrict__ tgt, int nt,
                                     const float* __restrict__ spos,
                                     const float* __restrict__ smass, int ns,
                                     float G, float eps2,
                                     float* __restrict__ acc) {
  __shared__ float4 tile[kBlock];
  const int i = blockIdx.x * kBlock + threadIdx.x;
  float xi = 0.f, yi = 0.f, zi = 0.f;
  if (i < nt) {
    xi = tgt[3 * i];
    yi = tgt[3 * i + 1];
    zi = tgt[3 * i + 2];
  }
  float ax = 0.f, ay = 0.f, az = 0.f;
  for (int base = 0; base < ns; base += kBlock) {
    const int j = base + threadIdx.x;
    tile[threadIdx.x] =
        j < ns ? make_float4(spos[3 * j], spos[3 * j + 1], spos[3 * j + 2],
                             smass[j])
               : make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
    const int cnt = min(kBlock, ns - base);
#pragma unroll 8
    for (int jj = 0; jj < cnt; ++jj) {
      const float4 s = tile[jj];
      const float dx = s.x - xi;
      const float dy = s.y - yi;
      const float dz = s.z - zi;
      const float r2 = dx * dx + dy * dy + dz * dz;
      const float inv = rsqrtf(r2 + eps2);
      float w = s.w * (inv * inv * inv);
      w = (r2 == 0.f) ? 0.f : w;  // self / coincident pair -> exactly 0
      ax += w * dx;
      ay += w * dy;
      az += w * dz;
    }
    __syncthreads();
  }
  if (i < nt) {
    acc[3 * i] = G * ax;
    acc[3 * i + 1] = G * ay;
    acc[3 * i + 2] = G * az;
  }
}

}  // namespace

extern "C" int nbt_direct_forces(const float* tgt, int nt, const float* spos,
                                 const float* smass, int ns, float G,
                                 float eps2, float* acc, void* stream) {
  if (nt > 0) {
    const int blocks = (nt + kBlock - 1) / kBlock;
    direct_forces_kernel<<<blocks, kBlock, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        tgt, nt, spos, smass, ns, G, eps2, acc);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nbt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
