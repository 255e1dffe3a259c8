// Slot placement + finest-level order-2 moments + per-cell counts, one
// thread per cell.
//
// Replaces: nbody_tpu/ops/pallas_scatter.py, _kernel /
// monotone_scatter_tiles with with_moments=True (called by
// tile_sweep.tile_build_pallas). The TPU kernel expresses the scatter as a
// one-hot MXU matmul with a 3-way bf16 split, f32 dest ids and a chunked
// slot-major layout that is relaid afterwards; none of that is needed here.
//
// Input: psort (N, 4) cell-sorted rows [x, y, z, m] and cell_start (d^3+1)
// (first sorted row of each linear cell id, sentinel N at the end). Cell c
// owns the contiguous run psort[cell_start[c] : cell_start[c+1]].
// Output:
//   tiles   (d, 4, k, d^2) plane-major slot tensor, the sweep's layout:
//           the row of rank r < k in cell (x, y, z) lands at
//           [x, :, r, y*d + z]; every other slot holds the cell centre
//           lo + (c + 0.5) * cell with mass 0 (inert);
//   moments (11, d^3): [m, m*xr(3), m*xr(x)xr(6) as xx,yy,zz,xy,xz,yz,
//           count] about the cell centre, over the WHOLE run, so rows past
//           the k-slot cap still count: moments and counts are exact at any
//           density.
//
// What bounds it on the H100: device memory. It reads psort once (16 B a
// row) and writes 4*k*4 B of slots plus 44 B of moments per cell: at
// d = 64, k = 16, 1M rows ~ 16 + 67 + 12 MB, tens of microseconds at
// 3.35 TB/s. Design: a thread owns one cell, so the run is reduced in a
// fixed order with no atomics (deterministic), and neighbouring threads
// own neighbouring z cells, so every slot store of a warp is one coalesced
// row of the plane-major layout.

#include <cuda_runtime.h>

namespace {

__global__ void tile_scatter_kernel(const float4* __restrict__ psort,
                                    const int* __restrict__ cell_start,
                                    const float* __restrict__ lo,
                                    const float* __restrict__ cellw,
                                    float* __restrict__ tiles,
                                    float* __restrict__ moments, int d,
                                    int k) {
  const int d2 = d * d;
  const int nc = d2 * d;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= nc) return;
  const int x = c / d2;
  const int yz = c - x * d2;
  const int y = yz / d;
  const int z = yz - y * d;
  const float cw = cellw[0];
  // Centres rounded as the plain twin rounds them (no FMA contraction),
  // so filler slots and moment offsets match it bit for bit.
  const float cx = __fadd_rn(lo[0], __fmul_rn(static_cast<float>(x) + 0.5f, cw));
  const float cy = __fadd_rn(lo[1], __fmul_rn(static_cast<float>(y) + 0.5f, cw));
  const float cz = __fadd_rn(lo[2], __fmul_rn(static_cast<float>(z) + 0.5f, cw));

  const size_t chs = static_cast<size_t>(k) * d2;  // channel stride
  float* slot = tiles + static_cast<size_t>(x) * 4 * chs + yz;

  const int s0 = cell_start[c];
  const int s1 = cell_start[c + 1];
  float mom[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) mom[i] = 0.f;
  for (int i = s0; i < s1; ++i) {
    const float4 p = psort[i];
    const float xr = p.x - cx;
    const float yr = p.y - cy;
    const float zr = p.z - cz;
    const float m = p.w;
    mom[0] += m;
    mom[1] += m * xr;
    mom[2] += m * yr;
    mom[3] += m * zr;
    mom[4] += m * (xr * xr);
    mom[5] += m * (yr * yr);
    mom[6] += m * (zr * zr);
    mom[7] += m * (xr * yr);
    mom[8] += m * (xr * zr);
    mom[9] += m * (yr * zr);
    const int r = i - s0;
    if (r < k) {
      float* s = slot + static_cast<size_t>(r) * d2;
      s[0] = p.x;
      s[chs] = p.y;
      s[2 * chs] = p.z;
      s[3 * chs] = p.w;
    }
  }
  for (int r = min(s1 - s0, k); r < k; ++r) {
    float* s = slot + static_cast<size_t>(r) * d2;
    s[0] = cx;
    s[chs] = cy;
    s[2 * chs] = cz;
    s[3 * chs] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 10; ++i) moments[static_cast<size_t>(i) * nc + c] = mom[i];
  moments[static_cast<size_t>(10) * nc + c] = static_cast<float>(s1 - s0);
}

}  // namespace

extern "C" int nbt_tile_scatter(const float* psort, const int* cell_start,
                                const float* lo, const float* cellw,
                                float* tiles, float* moments, int d, int k,
                                void* stream) {
  const int nc = d * d * d;
  const int threads = 128;
  const int blocks = (nc + threads - 1) / threads;
  tile_scatter_kernel<<<blocks, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(psort), cell_start, lo, cellw, tiles,
      moments, d, k);
  return static_cast<int>(cudaGetLastError());
}
