// Near-field slot sweep seeded with the far-field local expansion, staged
// per brick of cells in shared memory.
//
// Replaces: nbody_tpu/ops/pallas_tile_near.py, _near_kernel /
// tile_sweep_pallas_plane (raw plane-major output only).
//
// tiles (d, 4, k, d^2) plane-major slots [x, y, z, m] (see scatter.cu).
// For each live target slot (x, y, z, s):
//   out = far(slot) + sum over the (2ws+1)^3 neighbour cells inside the
//         grid and their live source slots of
//         m_j (x_j - x_i) / (r^2 + eps^2)^{3/2}
// NOT scaled by G. far(slot) = A + J.delta + 1/2 (H.delta).delta with
// delta = slot position - cell centre, from far (d, n_far, d^2) with the
// channel order of barnes_hut.far_field_grid: [A3 | J6 xx,yy,zz,xy,xz,yz |
// H10 xxx,yyy,zzz,xxy,xxz,xyy,yyz,xzz,yzz,xyz] (n_far = 0, 9 or 19).
// A pair with raw r^2 == 0 (self, coincident) contributes nothing; with
// use_cutoff a pair counts only when raw r^2 <= cutoff2, tested before
// softening (the spatial-hash predicate).
// counts (d^3) — the per-cell occupancy from scatter.cu — makes slots
// s >= min(count, k) dead: dead targets are written as 0 (never picked
// up) and dead sources are skipped. Without counts every slot is live
// (filler slots have mass 0 and add nothing).
//
// Slab form (nbt_tile_near_slab; the near sweep of nbody_tpu/parallel/
// tree.py, _slab_sweep, which the JAX package leaves to XLA): the tiles hold
// nx x-planes of a slab, (nx, 4, k, d^2), counts (nx d^2) is required and n_far
// is 0; the targets are planes [x0, x0 + planes) and out is (planes, 3, k,
// d^2). Source cells past the slab's x-extent [0, nx) or the grid's y, z
// extent [0, d) hold none. The cube form is the slab form with nx = planes =
// d and x0 = 0: the same kernel, the same arithmetic.
//
// What bounds it on the H100: FP32 issue over the live pairs (~20
// instructions a pair, r^2 rounded step by step), not memory: every live
// slot is read by the ~9 bricks whose halo holds it, 16 bytes each, mostly
// from L2. The work per brick around the pair loop (counts, a scan, the
// staging) is latency, hidden by the other blocks of the SM.
//
// Design. One block of 128 threads per brick: bz cells (x, y, z0..z0+bz-1)
// of one z column (make_plan below picks bz, the rows a chunk stages and
// the columns a group holds). The brick's halo is (2ws+1)^2
// neighbour columns, each the z-run z0-ws .. z0+bz-1+ws. The block
//   1. counts the brick's live targets and numbers them cell by cell;
//   2. keeps each target's position and cell in shared memory and seeds
//      its sum there with the far expansion;
//   3. per group of halo columns, numbers the group's live rows (columns
//      in (ox, oy) order, z ascending, slots ascending; cells past the grid
//      edge hold none) with one block-wide scan over its halo cells, giving
//      a table of where each cell's rows start, then stages the rows as
//      float4 (x, y, z, m), rows_cap at a time, with cp.async: a thread per
//      halo cell queues its slots (consecutive threads on consecutive z of
//      one column) and the block waits once per chunk;
//   4. walks: thread t takes targets t, t + 128, ...; a target of cell z
//      finds its sources in column c as ONE span of the list,
//      [start(c, z - ws), start(c, z + ws + 1)), so it tests no cell
//      coordinate. The targets of one cell share every span (a shared
//      memory broadcast); a warp holds 2-4 cells of neighbouring z, whose
//      spans differ only by the cells at their ends.
// No atomics: each target adds its far seed, then its columns and rows in
// list order, chunk by chunk, so two calls give bit-identical output.
// r^2 is rounded step by step (no FMA contraction), as the plain twin
// rounds it, so both agree on every pair at the cutoff. With eps2 >=
// kLeanEps2 the pair loop drops the r^2 == 0 test (a coincident pair has
// dx = dy = dz = 0 and adds exactly 0: its weight m / eps^3 <= m * 1e18 is
// finite for any mass below 3e20) and rsqrtf's denormal fix-up
// (rsqrt.approx.ftz: r^2 + eps2 is never denormal), as K7 does; below
// kLeanEps2 only the loop that keeps the test is right (0 * inf). On an
// H100 the lean loop takes 0.85-0.92x the time of the other at the 1M
// shapes (scripts/profile_tile_near_torch.py), and bricks of 128 ws^2
// slots (8 cells at k 16, ws 1; 32 at ws 2) ran the fastest of 4, 8, 16
// and 32 cells (PERF.md).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBz = 32;
// Dynamic shared memory a block aims for (~4 blocks of 128 threads an SM),
// and the most a launch may ask for (opted in once per device).
constexpr int kSmemBudget = 56 * 1024;
constexpr int kMaxSmem = 200 * 1024;
constexpr int kTableInts = 8192;  // table ints of one column group (32 KB)
// The least eps^2 of the lean pair loop (eps >= 1e-6).
constexpr float kLeanEps2 = 1e-12f;

// Exclusive prefix of one int per thread over the block; *total gets the
// sum. Every thread of the block must call it.
__device__ __forceinline__ int block_scan(int v, int* s_warp, int* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += t;
  }
  if (lane == 31) s_warp[w] = inc;
  __syncthreads();
  int base = 0, tot = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    const int t = s_warp[i];
    base += i < w ? t : 0;
    tot += t;
  }
  __syncthreads();
  *total = tot;
  return base + inc - v;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
      static_cast<unsigned>(__cvta_generic_to_shared(dst))), "l"(src));
}

// The brick cell of target i: the last zz with tpre[zz] <= i.
__device__ __forceinline__ int target_cell(const int* tpre, int nz, int i) {
  int lo = 0, hi = nz;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (tpre[mid] <= i) lo = mid; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int live_slots(const float* counts, int nx, int d,
                                          int k, int xs, int ys, int zs) {
  if (xs < 0 || xs >= nx || ys < 0 || ys >= d || zs < 0 || zs >= d) return 0;
  if (!counts) return k;
  const size_t c = (static_cast<size_t>(xs) * d + ys) * d + zs;
  return min(static_cast<int>(counts[c]), k);
}

template <bool kCutoff, bool kSoft>
__global__ void __launch_bounds__(kThreads)
tile_near_kernel(const float* __restrict__ tiles,
                 const float* __restrict__ far, int n_far,
                 const float* __restrict__ counts,
                 const float* __restrict__ lo,
                 const float* __restrict__ cellw, float* __restrict__ out,
                 int nx, int x0, int d, int k, int ws, int bz, int rows_cap,
                 int group_cols, float eps2, float cutoff2) {
  extern __shared__ float4 s_rows[];          // rows_cap staged rows
  float4* s_acc = s_rows + rows_cap;          // bz * k target sums
  float4* s_tgt = s_acc + bz * k;             // bz * k (x, y, z, cell)
  int* s_tab = reinterpret_cast<int*>(s_tgt + bz * k);  // group table
  __shared__ int s_tpre[kMaxBz + 1];
  __shared__ int s_warp[kWarps];

  const int tid = threadIdx.x;
  const int xt = blockIdx.x / d;  // the target plane, of out
  const int x = x0 + xt;          // the same plane, of tiles
  const int y = blockIdx.x - xt * d;
  const int z0 = blockIdx.y * bz;
  const int nz = min(bz, d - z0);
  const int d2 = d * d;
  const size_t chs = static_cast<size_t>(k) * d2;  // channel stride
  const int yz0 = y * d + z0;

  // 1. the brick's live targets, numbered cell by cell
  const int live =
      tid < nz ? live_slots(counts, nx, d, k, x, y, z0 + tid) : 0;
  int n_tgt;
  const int first = block_scan(live, s_warp, &n_tgt);
  if (tid < nz) s_tpre[tid] = first;
  if (tid == 0) s_tpre[nz] = n_tgt;
  __syncthreads();

  if (n_tgt > 0) {
    // 2. positions, cells and far seeds of the targets
    for (int i = tid; i < n_tgt; i += kThreads) {
      const int zz = target_cell(s_tpre, nz, i);
      const float* t = tiles + static_cast<size_t>(x) * 4 * chs +
                       static_cast<size_t>(i - s_tpre[zz]) * d2 + yz0 + zz;
      const float tx = t[0], ty = t[chs], tz = t[2 * chs];
      s_tgt[i] = make_float4(tx, ty, tz, __int_as_float(zz));
      float ax = 0.f, ay = 0.f, az = 0.f;
      if (n_far > 0) {
        const float cw = cellw[0];
        // centre rounded without FMA contraction, as in scatter.cu
        const float dx = tx - __fadd_rn(lo[0], __fmul_rn(static_cast<float>(x) + 0.5f, cw));
        const float dy = ty - __fadd_rn(lo[1], __fmul_rn(static_cast<float>(y) + 0.5f, cw));
        const float dz = tz - __fadd_rn(lo[2], __fmul_rn(static_cast<float>(z0 + zz) + 0.5f, cw));
        const float* f = far + static_cast<size_t>(x) * n_far * d2 + yz0 + zz;
#define F(ch) f[static_cast<size_t>(ch) * d2]
        ax = F(0) + (F(3) * dx + F(6) * dy + F(7) * dz);
        ay = F(1) + (F(6) * dx + F(4) * dy + F(8) * dz);
        az = F(2) + (F(7) * dx + F(8) * dy + F(5) * dz);
        if (n_far > 9) {
          const float hxx = F(9) * dx + F(12) * dy + F(13) * dz;
          const float hyy = F(14) * dx + F(10) * dy + F(15) * dz;
          const float hzz = F(16) * dx + F(17) * dy + F(11) * dz;
          const float hxy = F(12) * dx + F(14) * dy + F(18) * dz;
          const float hxz = F(13) * dx + F(18) * dy + F(16) * dz;
          const float hyz = F(18) * dx + F(15) * dy + F(17) * dz;
          ax += 0.5f * (hxx * dx + hxy * dy + hxz * dz);
          ay += 0.5f * (hxy * dx + hyy * dy + hyz * dz);
          az += 0.5f * (hxz * dx + hyz * dy + hzz * dz);
        }
#undef F
      }
      s_acc[i] = make_float4(ax, ay, az, 0.f);
    }

    const int w1 = 2 * ws + 1;
    const int n_cols = w1 * w1;
    const int hz = nz + 2 * ws;  // halo cells of a column
    for (int c0 = 0; c0 < n_cols; c0 += group_cols) {
      const int n_cells = min(group_cols, n_cols - c0) * hz;
      // 3a. the group's halo cells, in list order, e consecutive cells a
      // thread: live slots into the table, then their exclusive prefix
      const int e = (n_cells + kThreads - 1) / kThreads;
      const int f0 = min(tid * e, n_cells), f1 = min(f0 + e, n_cells);
      __syncthreads();  // the previous group's walk is done with s_tab
      int mine = 0;
      for (int f = f0; f < f1; ++f) {
        const int cg = f / hz, h = f - cg * hz;
        const int c = c0 + cg;
        const int ox = c / w1;
        const int v = live_slots(counts, nx, d, k, x + ox - ws,
                                 y + (c - ox * w1) - ws, z0 - ws + h);
        s_tab[f] = v;
        mine += v;
      }
      int n_rows;
      int run = block_scan(mine, s_warp, &n_rows);
      for (int f = f0; f < f1; ++f) {
        const int v = s_tab[f];
        s_tab[f] = run;
        run += v;
      }
      if (tid == 0) s_tab[n_cells] = n_rows;
      for (int a = 0; a < n_rows; a += rows_cap) {
        const int b = min(n_rows, a + rows_cap);
        __syncthreads();  // table done / previous chunk walked
        // 3b. stage rows [a, b) of the list
        for (int f = tid; f < n_cells; f += kThreads) {
          const int j0 = max(s_tab[f], a), j1 = min(s_tab[f + 1], b);
          if (j0 >= j1) continue;
          const int cg = f / hz, h = f - cg * hz;
          const int c = c0 + cg;
          const int ox = c / w1;
          const int xs = x + ox - ws, ys = y + (c - ox * w1) - ws;
          const float* src = tiles + static_cast<size_t>(xs) * 4 * chs +
                             static_cast<size_t>(j0 - s_tab[f]) * d2 +
                             ys * d + z0 - ws + h;
          for (int j = j0; j < j1; ++j, src += d2) {
            float* dst = reinterpret_cast<float*>(s_rows + (j - a));
            cp_async4(dst, src);
            cp_async4(dst + 1, src + chs);
            cp_async4(dst + 2, src + 2 * chs);
            cp_async4(dst + 3, src + 3 * chs);
          }
        }
        asm volatile("cp.async.wait_all;\n" ::);
        __syncthreads();
        // 4. each target walks its span in every column of the group
        for (int i = tid; i < n_tgt; i += kThreads) {
          const float4 t = s_tgt[i];
          const int zz = __float_as_int(t.w);
          const float4 acc = s_acc[i];
          float ax = acc.x, ay = acc.y, az = acc.z;
          for (int f = zz; f < n_cells; f += hz) {  // column by column
            const int j0 = max(s_tab[f], a) - a;
            const int j1 = min(s_tab[f + 2 * ws + 1], b) - a;
#pragma unroll 4
            for (int j = j0; j < j1; ++j) {
              const float4 sj = s_rows[j];
              const float dx = sj.x - t.x;
              const float dy = sj.y - t.y;
              const float dz = sj.z - t.z;
              const float r2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                                   __fmul_rn(dy, dy)),
                                         __fmul_rn(dz, dz));
              float inv;
              if (kSoft) {  // r2 + eps2 >= kLeanEps2: the flush never acts
                asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(inv) : "f"(r2 + eps2));
              } else {
                inv = rsqrtf(r2 + eps2);
              }
              bool keep = kSoft || r2 != 0.f;
              if (kCutoff) keep = keep && r2 <= cutoff2;
              const float w = keep ? sj.w * (inv * inv * inv) : 0.f;
              ax = fmaf(w, dx, ax);
              ay = fmaf(w, dy, ay);
              az = fmaf(w, dz, az);
            }
          }
          s_acc[i] = make_float4(ax, ay, az, 0.f);
        }
      }
    }
  }
  __syncthreads();
  // 5. every slot of the brick, live sums and dead zeros, z fastest
  float* ob = out + static_cast<size_t>(xt) * 3 * chs + yz0;
  for (int it = tid; it < k * nz; it += kThreads) {
    const int s = it / nz, zz = it - s * nz;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s < s_tpre[zz + 1] - s_tpre[zz]) a = s_acc[s_tpre[zz] + s];
    float* o = ob + static_cast<size_t>(s) * d2 + zz;
    o[0] = a.x;
    o[chs] = a.y;
    o[2 * chs] = a.z;
  }
}

// Kernel K4's launch plan for (d, k, ws), ws <= d - 1. A brick is bz cells
// of one z column: 128 ws^2 slots, at most 32 cells. Its halo columns are
// taken group_cols at a time (bz + 2 ws table ints each), and their live
// rows are staged rows_cap at a time: all of them when the worst case
// (every slot of every halo cell live) fits the budget. smem <= 102404
// bytes for any k <= 64.
struct Plan {
  int bz, rows_cap, group_cols, smem;
};

Plan make_plan(int d, int k, int ws) {
  Plan p;
  p.bz = max(1, min(min(kMaxBz, d), 128 / k * ws * ws));
  const int hz = p.bz + 2 * ws;
  const int n_cols = (2 * ws + 1) * (2 * ws + 1);
  p.group_cols = max(1, min(n_cols, kTableInts / hz));
  const int table = 4 * (p.group_cols * hz + 1);
  const int fixed = 32 * p.bz * k + table;
  p.rows_cap = static_cast<int>(
      min(static_cast<long long>(n_cols) * hz * k,
          static_cast<long long>(max(256, (kSmemBudget - fixed) / 16))));
  p.smem = 16 * p.rows_cap + fixed;
  return p;
}

using Kernel = decltype(&tile_near_kernel<false, false>);

}  // namespace

// nbt_tile_near's plan for (d, k, ws): field 0 bz, 1 rows_cap, 2
// group_cols, 3 dynamic shared memory bytes; -1 for another field or a
// shape the kernel does not take.
extern "C" int nbt_tile_near_plan(int d, int k, int ws, int field) {
  if (d < 1 || k < 1 || ws < 0) return -1;
  const Plan p = make_plan(d, k, min(ws, d - 1));
  switch (field) {
    case 0: return p.bz;
    case 1: return p.rows_cap;
    case 2: return p.group_cols;
    case 3: return p.smem;
    default: return -1;
  }
}

namespace {

// Launch over target planes [x0, x0 + planes) of nx-plane tiles (the cube
// form: nx = planes = d, x0 = 0).
int launch_near(const float* tiles, const float* far, int n_far,
                const float* counts, const float* lo, const float* cellw,
                float* out, int nx, int x0, int planes, int d, int k, int ws,
                float eps2, float cutoff2, int use_cutoff, void* stream) {
  if (d < 1 || k < 1 || ws < 0) return static_cast<int>(cudaErrorInvalidValue);
  ws = min(ws, d - 1);  // cells farther than d - 1 lie outside the grid
  const Plan plan = make_plan(d, k, ws);
  if (plan.smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const bool soft = eps2 >= kLeanEps2;
  Kernel kernels[4] = {tile_near_kernel<false, false>,
                       tile_near_kernel<false, true>,
                       tile_near_kernel<true, false>,
                       tile_near_kernel<true, true>};
  // the opt-in above 48 KB of dynamic shared memory, once per device
  static bool opted_in[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= 64) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  if (!opted_in[device]) {
    for (Kernel kern : kernels) {
      err = cudaFuncSetAttribute(kern,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kMaxSmem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    opted_in[device] = true;
  }
  const dim3 grid(planes * d, (d + plan.bz - 1) / plan.bz);
  kernels[2 * (use_cutoff != 0) + soft]<<<grid, kThreads, plan.smem,
                                          static_cast<cudaStream_t>(stream)>>>(
      tiles, far, n_far, counts, lo, cellw, out, nx, x0, d, k, ws, plan.bz,
      plan.rows_cap, plan.group_cols, eps2, cutoff2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int nbt_tile_near(const float* tiles, const float* far, int n_far,
                             const float* counts, const float* lo,
                             const float* cellw, float* out, int d, int k,
                             int ws, float eps2, float cutoff2, int use_cutoff,
                             void* stream) {
  return launch_near(tiles, far, n_far, counts, lo, cellw, out, d, 0, d, d, k,
                     ws, eps2, cutoff2, use_cutoff, stream);
}

// The slab form: targets in planes [x0, x0 + planes) of nx-plane tiles,
// counts required, no far seed.
extern "C" int nbt_tile_near_slab(const float* tiles, const float* counts,
                                  float* out, int nx, int x0, int planes,
                                  int d, int k, int ws, float eps2,
                                  float cutoff2, int use_cutoff,
                                  void* stream) {
  if (!counts || planes < 1 || x0 < 0 || x0 + planes > nx) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_near(tiles, nullptr, 0, counts, nullptr, nullptr, out, nx, x0,
                     planes, d, k, ws, eps2, cutoff2, use_cutoff, stream);
}
