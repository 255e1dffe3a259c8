// Sorted-window short-range sweep, one thread per cell-sorted target.
//
// Replaces: nbody_tpu/ops/pallas_window_sweep.py, _kernel /
// window_sweep_pallas (the hot loop of the spatial hash's window engine
// and of the Barnes-Hut "window" near engine).
//
// Rows are sorted by row-major cell id (x major, z fastest, stride d), so
// for a block of B consecutive targets and one (dx, dy) offset every
// source the block can need lies in ONE contiguous run of rows. For each
// cell-sorted target i and offset, it sums
//   m_j (x_j - x_i) / (r^2 + eps^2)^{3/2}
// over the rows j of that run whose integer cell coordinates match
// exactly: cx_j == cx_i + dx, cy_j == cy_i + dy, |cz_j - cz_i| <= z_hw.
// A pair also needs raw r^2 > 0 and, with use_cutoff, raw r^2 <= cutoff2
// (tested before softening). Output (N, 3) in sorted order, NOT scaled by
// G. The exact coordinate predicate is the correctness guarantee: a window
// that is misplaced or clipped can only MISS pairs, never count one twice;
// offsets past the grid edge give ids that wrap into a neighbouring
// column, and the predicate rejects those rows.
//
// Window anchoring (sorted_window.py one_block / _window_starts): with
// first/last the first and the last REAL target of the block,
//   base0 = clip(((first.x+dx) d + first.y+dy) d + max(first.z - z_hw, 0))
//   base1 = clip(((last.x+dx) d + last.y+dy) d + min(last.z + z_hw, d-1) + 1)
//   win_start = cell_start[base0], needed_end = cell_start[base1]
// The rows covered are [win_start, win_start + window): the definition of
// the JAX package's XLA path, not its TPU kernel's (which aligns starts
// down to 128 and reads window + 128 rows). So the overflow audit is
//   overflow += max(needed_end - win_start - window, 0)
// per (block, offset), summed into one int64 by thread 0 of each block.
// Rows at or past needed_end cannot match (ids are sorted), so the loop
// runs only over the live span [win_start, min(needed_end, win_start +
// window)) and computes the same sum.
//
// What bounds it on the H100: FP32 arithmetic and rsqrtf throughput over
// the pair tests of the live spans (at 1M dense, some 10^10 tests: 9
// offsets x a z-run of 3-4 cells x ~240 rows per target), ~20 operations
// each; it reads O(N) bytes. Design: the block stages each live span in
// shared-memory tiles of B rows (float4 position + mass, int4 cell
// coordinates) and every thread tests its target against the tile from
// there (broadcast reads), the accumulator in registers. None of the TPU
// kernel's workarounds (128-aligned DMA windows, eye-matmul transposes,
// f32-carried coordinates) carry over.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxBlock = 512;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__global__ void __launch_bounds__(kMaxBlock)
window_sweep_kernel(const float4* __restrict__ psort,
                    const int* __restrict__ csort,
                    const int* __restrict__ cell_start, int n, int d,
                    const int* __restrict__ offsets, int n_off, int z_hw,
                    int window, float eps2, float cutoff2, int use_cutoff,
                    float* __restrict__ acc,
                    unsigned long long* __restrict__ overflow) {
  __shared__ float4 sp[kMaxBlock];
  __shared__ int4 sc[kMaxBlock];
  const int b = blockDim.x;
  const int row0 = blockIdx.x * b;
  const int i = row0 + threadIdx.x;
  const bool active = i < n;
  const int last = min(n, row0 + b) - 1;
  const int num_cells = d * d * d;
  const int fx = csort[3 * row0], fy = csort[3 * row0 + 1];
  const int fz = csort[3 * row0 + 2];
  const int lx = csort[3 * last], ly = csort[3 * last + 1];
  const int lz = csort[3 * last + 2];

  float tx = 0.f, ty = 0.f, tz = 0.f;
  int cx = 0, cy = 0, cz = 0;
  if (active) {
    const float4 p = psort[i];
    tx = p.x;
    ty = p.y;
    tz = p.z;
    cx = csort[3 * i];
    cy = csort[3 * i + 1];
    cz = csort[3 * i + 2];
  }
  float ax = 0.f, ay = 0.f, az = 0.f;
  unsigned long long over = 0;

  for (int o = 0; o < n_off; ++o) {
    const int dx = offsets[2 * o];
    const int dy = offsets[2 * o + 1];
    const int base0 = clampi(((fx + dx) * d + fy + dy) * d + max(fz - z_hw, 0),
                             0, num_cells);
    const int base1 = clampi(
        ((lx + dx) * d + ly + dy) * d + min(lz + z_hw, d - 1) + 1, 0,
        num_cells);
    const int win_start = cell_start[base0];
    const int needed_end = cell_start[base1];
    over += static_cast<unsigned long long>(
        max(needed_end - win_start - window, 0));
    const int live_end = min(needed_end, win_start + window);
    const int tcx = cx + dx;
    const int tcy = cy + dy;
    // win_start/live_end are the same for every thread of the block, so
    // the barriers below are reached uniformly.
    for (int base = win_start; base < live_end; base += b) {
      const int j = base + threadIdx.x;
      if (j < live_end) {
        sp[threadIdx.x] = psort[j];
        sc[threadIdx.x] =
            make_int4(csort[3 * j], csort[3 * j + 1], csort[3 * j + 2], 0);
      }
      __syncthreads();
      if (active) {
        const int cnt = min(b, live_end - base);
        for (int t = 0; t < cnt; ++t) {
          const int4 c = sc[t];
          if (c.x != tcx || c.y != tcy || abs(c.z - cz) > z_hw) continue;
          const float4 s = sp[t];
          const float ddx = s.x - tx;
          const float ddy = s.y - ty;
          const float ddz = s.z - tz;
          // rounded as the plain twin rounds it (no FMA contraction), so
          // both agree on every pair at the cutoff boundary
          const float r2 = __fadd_rn(__fadd_rn(__fmul_rn(ddx, ddx),
                                               __fmul_rn(ddy, ddy)),
                                     __fmul_rn(ddz, ddz));
          if (!(r2 > 0.f) || (use_cutoff && !(r2 <= cutoff2))) continue;
          const float inv = rsqrtf(r2 + eps2);
          const float w = s.w * (inv * inv * inv);
          ax += w * ddx;
          ay += w * ddy;
          az += w * ddz;
        }
      }
      __syncthreads();
    }
  }
  if (active) {
    acc[3 * i] = ax;
    acc[3 * i + 1] = ay;
    acc[3 * i + 2] = az;
  }
  if (threadIdx.x == 0 && over > 0) atomicAdd(overflow, over);
}

}  // namespace

extern "C" int nbt_window_sweep(const float* psort, const int* csort,
                                const int* cell_start, int n, int d,
                                const int* offsets, int n_off, int z_hw,
                                int window, float eps2, float cutoff2,
                                int use_cutoff, float* acc,
                                unsigned long long* overflow, int block,
                                void* stream) {
  if (block < 1 || block > kMaxBlock) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (n + block - 1) / block;
  window_sweep_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(psort), csort, cell_start, n, d,
      offsets, n_off, z_hw, window, eps2, cutoff2, use_cutoff, acc, overflow);
  return static_cast<int>(cudaGetLastError());
}
