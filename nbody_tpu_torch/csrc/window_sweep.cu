// Sorted-window short-range sweep, anchored per target cell.
//
// Replaces: nbody_tpu/ops/pallas_window_sweep.py, _kernel /
// window_sweep_pallas (the hot loop of the spatial hash's window engine
// and of the Barnes-Hut "window" near engine).
//
// Rows are sorted by row-major cell id (x major, z fastest, stride d). For
// each cell-sorted target i and (dx, dy) offset it sums
//   m_j (x_j - x_i) / (r^2 + eps^2)^{3/2}
// over the rows j whose cell coordinates match exactly: cx_j == cx_i + dx,
// cy_j == cy_i + dy, |cz_j - cz_i| <= z_hw, that lie inside the window of
// the target's block. A pair also needs raw r^2 > 0 and, with use_cutoff,
// raw r^2 <= cutoff2 (tested before softening). Output (N, 3) in sorted
// order, NOT scaled by G.
//
// Window (sorted_window.py one_block, the JAX package's XLA path): with
// first/last the first and the last REAL target of a block of B rows,
//   base0 = clip(((first.x+dx) d + first.y+dy) d + max(first.z - z_hw, 0))
//   base1 = clip(((last.x+dx) d + last.y+dy) d + min(last.z + z_hw, d-1) + 1)
//   win_start = cell_start[base0], needed_end = cell_start[base1]
// The rows covered are [win_start, win_start + window), and
//   overflow += max(needed_end - win_start - window, 0)
// per (block, offset), summed into one int64 (an integer atomic per block).
//
// Per cell: the rows matching a target of cell (cx, cy, cz) for offset
// (dx, dy) are ONE run of sorted rows, the z-run of column
// col = ((cx+dx) d + cy+dy) d:
//   [cell_start[col + max(cz - z_hw, 0)], cell_start[col + min(cz + z_hw,
//    d - 1) + 1])
// and empty when cx+dx or cy+dy lies outside [0, d) (such ids would wrap
// into a neighbouring column). Clipped to the block's window it is exactly
// the set of window rows the coordinate predicate accepts, so the kernel
// tests no coordinates: every row of the span is a pair, and only r^2 > 0
// and the cutoff remain. Every target of one cell in one block has the same
// spans (ops/window_sweep.py window_spans mirrors them on the CPU).
//
// What bounds it on the H100: FP32 arithmetic and rsqrtf throughput over
// the pairs (at 1M dense some 5.7e9: 9 offsets x a z-run of 3 cells x ~240
// rows per target), ~20 operations each; it reads O(N) bytes from device
// memory. Design: one CUDA block per B targets, one thread per target; the
// block's windows are computed once into shared memory; each thread walks
// its own spans, reading each source row as one float4 (position + mass).
// The targets of a warp mostly share a cell, so a warp's loads mostly hit
// one address (one L1 transaction, broadcast); where a warp holds two
// cells it walks the longer span and the other lanes idle. Each target
// sums its offsets and rows in order with no atomics, so two calls give
// bit-identical output. r^2 is rounded step by step (no FMA contraction),
// as the plain twin rounds it, so both agree on every pair at the cutoff.
// The pair loop is issue-bound (~21 instructions a pair, unrolled by 4),
// so with eps2 >= kLeanEps2 it drops the r^2 > 0 test (the target itself
// adds exactly 0: its weight m / eps^3 <= m * 1e18 is finite for any mass
// below 3e20) and the denormal fix-up of rsqrtf (rsqrt.approx.ftz: the
// argument is never denormal). On an H100 that loop takes 0.863x the
// device time of the other at the 1M dense-hash shape and 0.882x at the
// 1M Barnes-Hut window shape (scripts/profile_window_sweep_torch.py).
// Below kLeanEps2 only the loop that keeps the test is right (the target's
// own r^2 = 0 would give 0 * inf).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxBlock = 512;
// The least eps^2 of the lean pair loop (eps >= 1e-6).
constexpr float kLeanEps2 = 1e-12f;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

template <bool kCutoff, bool kSoft>
__global__ void __launch_bounds__(kMaxBlock, 2)
window_sweep_kernel(const float4* __restrict__ psort,
                    const int* __restrict__ csort,
                    const int* __restrict__ cell_start, int n, int d,
                    const int* __restrict__ offsets, int n_off, int z_hw,
                    int window, float eps2, float cutoff2,
                    float* __restrict__ acc,
                    unsigned long long* __restrict__ overflow) {
  // Per offset: dx, dy and the block's window [lo, hi), 16 B an offset in
  // dynamic shared memory: 17 KB at the widest Barnes-Hut window (ws 16,
  // 1089 offsets), inside the 48 KB a launch takes without opting in.
  extern __shared__ int s_tab[];
  int* s_dx = s_tab;
  int* s_dy = s_tab + n_off;
  int* s_lo = s_tab + 2 * n_off;
  int* s_hi = s_tab + 3 * n_off;
  __shared__ unsigned long long s_over;
  const int b = blockDim.x;
  const int row0 = blockIdx.x * b;
  const int i = row0 + threadIdx.x;
  const bool active = i < n;

  if (threadIdx.x == 0) s_over = 0;
  __syncthreads();
  // The block's window per offset, one thread per offset.
  for (int o = threadIdx.x; o < n_off; o += b) {
    const int last = min(n, row0 + b) - 1;
    const int fx = csort[3 * row0], fy = csort[3 * row0 + 1];
    const int fz = csort[3 * row0 + 2];
    const int lx = csort[3 * last], ly = csort[3 * last + 1];
    const int lz = csort[3 * last + 2];
    const int num_cells = d * d * d;
    const int dx = offsets[2 * o], dy = offsets[2 * o + 1];
    const int base0 = clampi(((fx + dx) * d + fy + dy) * d + max(fz - z_hw, 0),
                             0, num_cells);
    const int base1 = clampi(
        ((lx + dx) * d + ly + dy) * d + min(lz + z_hw, d - 1) + 1, 0,
        num_cells);
    const int win_start = cell_start[base0];
    const int needed_end = cell_start[base1];
    s_dx[o] = dx;
    s_dy[o] = dy;
    s_lo[o] = win_start;
    s_hi[o] = min(needed_end, win_start + window);
    const int over = needed_end - win_start - window;
    if (over > 0) atomicAdd(&s_over, static_cast<unsigned long long>(over));
  }
  __syncthreads();
  if (threadIdx.x == 0 && s_over > 0) atomicAdd(overflow, s_over);
  if (!active) return;

  const float4 p = psort[i];
  const int cx = csort[3 * i], cy = csort[3 * i + 1], cz = csort[3 * i + 2];
  const int z0 = max(cz - z_hw, 0);
  const int z1 = min(cz + z_hw, d - 1) + 1;
  float ax = 0.f, ay = 0.f, az = 0.f;
  for (int o = 0; o < n_off; ++o) {
    const int nx = cx + s_dx[o];
    const int ny = cy + s_dy[o];
    if (nx < 0 || nx >= d || ny < 0 || ny >= d) continue;
    const int col = (nx * d + ny) * d;
    const int lo = max(__ldg(cell_start + col + z0), s_lo[o]);
    const int hi = min(__ldg(cell_start + col + z1), s_hi[o]);
#pragma unroll 4
    for (int j = lo; j < hi; ++j) {
      const float4 s = __ldg(psort + j);
      const float ddx = s.x - p.x;
      const float ddy = s.y - p.y;
      const float ddz = s.z - p.z;
      const float r2 = __fadd_rn(__fadd_rn(__fmul_rn(ddx, ddx),
                                           __fmul_rn(ddy, ddy)),
                                 __fmul_rn(ddz, ddz));
      float inv;
      if (kSoft) {  // r2 + eps2 >= kLeanEps2: the flush never acts
        asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(inv) : "f"(r2 + eps2));
      } else {
        inv = rsqrtf(r2 + eps2);
      }
      // With eps2 >= kLeanEps2 w is finite, so the target itself (ddx =
      // ddy = ddz = 0) adds exactly 0 and needs no test; any other row at
      // r2 == 0 (each |d| < 1e-22, its square flushed) adds under 1e-22 w.
      bool keep = kSoft || r2 > 0.f;
      if (kCutoff) keep = keep && r2 <= cutoff2;
      const float w = keep ? s.w * (inv * inv * inv) : 0.f;
      ax = fmaf(w, ddx, ax);
      ay = fmaf(w, ddy, ay);
      az = fmaf(w, ddz, az);
    }
  }
  acc[3 * i] = ax;
  acc[3 * i + 1] = ay;
  acc[3 * i + 2] = az;
}

}  // namespace

extern "C" int nbt_window_sweep(const float* psort, const int* csort,
                                const int* cell_start, int n, int d,
                                const int* offsets, int n_off, int z_hw,
                                int window, float eps2, float cutoff2,
                                int use_cutoff, float* acc,
                                unsigned long long* overflow, int block,
                                void* stream) {
  if (block < 1 || block > kMaxBlock || n_off < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (n + block - 1) / block;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* p = reinterpret_cast<const float4*>(psort);
  auto kernel = use_cutoff ? window_sweep_kernel<true, true>
                           : window_sweep_kernel<false, true>;
  if (!(eps2 >= kLeanEps2)) {
    kernel = use_cutoff ? window_sweep_kernel<true, false>
                        : window_sweep_kernel<false, false>;
  }
  const size_t smem = 4 * sizeof(int) * static_cast<size_t>(n_off);
  kernel<<<grid, block, smem, s>>>(p, csort, cell_start, n, d, offsets,
                                   n_off, z_hw, window, eps2, cutoff2, acc,
                                   overflow);
  return static_cast<int>(cudaGetLastError());
}
