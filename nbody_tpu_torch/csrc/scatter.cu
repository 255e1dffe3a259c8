// Slot placement (kernel K2): by rank inside each cell's run, with the
// finest-level order-2 moments and per-cell counts; or by an explicit slot
// id per row.
//
// Replaces: nbody_tpu/ops/pallas_scatter.py, _kernel /
// monotone_scatter_tiles, in the three forms its callers use:
//   * with_moments=True (tile_sweep.tile_build_pallas, the main path):
//     nbt_tile_scatter;
//   * with_moments=True, with_coverage=True, extra= the 3 velocity channels
//     (table_step._sort_build): nbt_tile_scatter_ext;
//   * with_coverage=True, extra= by explicit dest ids
//     (table_step._repair_step): nbt_tile_place, which moves the movers
//     within the step's own table instead of building a dense one.
// The TPU kernel expresses the scatter as a one-hot MXU matmul with a 3-way
// bf16 split, f32 dest ids, chunked source windows and a slot-major layout
// that is relaid afterwards; none of that is needed here: on Hopper a
// scatter is a store. Its dest-id output channel (row 4 of with_coverage,
// "unused by callers") is left out, and so are extra-channel counts other
// than the 3 the callers place (the row tag and row id of the JAX callers
// are int32 state in the port).
//
// Rank form. Input: psort (N, 4) cell-sorted rows [x, y, z, m] and
// cell_start (d^3+1) (first sorted row of each linear cell id, sentinel N
// at the end). Cell c owns the contiguous run psort[cell_start[c] :
// cell_start[c+1]].
// Output:
//   tiles   (d, 4, k, d^2) plane-major slot tensor, the sweep's layout:
//           the row of rank r < k in cell (x, y, z) lands at
//           [x, :, r, y*d + z]; every other slot holds the cell centre
//           lo + (c + 0.5) * cell with mass 0 (inert);
//   moments (11, d^3): [m, m*xr(3), m*xr(x)xr(6) as xx,yy,zz,xy,xz,yz,
//           count] about the cell centre, over the WHOLE run, so rows past
//           the k-slot cap still count: moments and counts are exact at any
//           density;
//   cov     (d, 1, k, d^2), table form: 1.0 where a row was placed, else 0;
//   ext     (d, 3, k, d^2), table form: extra (N, 3)'s row at the row's own
//           slot, exact 0.0 in empty slots.
//
// Dest form (nbt_tile_place), in place on one table: mover j's row (its
// slot's 4 channels and 3 extra ones) moves from its slot src[j] to the
// slot id dest[j] = cell*k + slot, its old slot gets the filler, the
// table's row bookkeeping follows, and the moved rows' old and new cells
// get their high-water mark (K4's live count) recomputed; dest ids outside
// [0, d^3*k), such as the sentinels >= 2^24, move nothing. The JAX kernel
// places the movers' rows into a dense filler table that its caller merges
// with the old one; here the rows never leave the table.
//
// What bounds it on the H100: device memory. The rank form reads psort
// once (16 B a row, plus 12 B of extra) and writes (4 [+ 1 + 3])*k*4 B of
// slots plus 44 B of moments per cell: at d = 64, k = 16, 1M rows,
// ~16 + 67 + 12 MB in the main form, tens of microseconds at 3.35 TB/s;
// cov and the 3 extra planes add 67 MB. The dest form moves ~100 B a
// mover (its slot read, its new slot and the vacated one written, the
// bookkeeping, and the k cov values of two cells), so a repair step costs
// what its movers cost, not the table's size; at a few hundred movers it
// is two launches' latency. Design: in the rank
// form a thread owns one cell, so the run is reduced in a fixed order with
// no atomics (deterministic), and neighbouring threads own neighbouring z
// cells, so every slot store of a warp is one coalesced row of the
// plane-major layout. Each form is its own template instantiation
// (coverage, E), so the main path's kernel keeps its code. The dest form
// is a thread per mover (distinct slots: no races), then a thread per
// touched cell; the whole move is one call, because on the card a repair
// step is bound by the host's launches, not by its bytes.

#include <cuda_runtime.h>

namespace {

// Centres rounded as the plain twin rounds them (no FMA contraction), so
// filler slots and moment offsets match it bit for bit.
__device__ __forceinline__ float centre(float lo, int c, float cw) {
  return __fadd_rn(lo, __fmul_rn(static_cast<float>(c) + 0.5f, cw));
}

template <bool kCov, int kE>
__global__ void tile_scatter_kernel(const float4* __restrict__ psort,
                                    const float* __restrict__ extra,
                                    const int* __restrict__ cell_start,
                                    const float* __restrict__ lo,
                                    const float* __restrict__ cellw,
                                    float* __restrict__ tiles,
                                    float* __restrict__ moments,
                                    float* __restrict__ cov,
                                    float* __restrict__ ext, int d, int k) {
  const int d2 = d * d;
  const int nc = d2 * d;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= nc) return;
  const int x = c / d2;
  const int yz = c - x * d2;
  const int y = yz / d;
  const int z = yz - y * d;
  const float cw = cellw[0];
  const float cx = centre(lo[0], x, cw);
  const float cy = centre(lo[1], y, cw);
  const float cz = centre(lo[2], z, cw);

  const size_t chs = static_cast<size_t>(k) * d2;  // channel stride
  float* slot = tiles + static_cast<size_t>(x) * 4 * chs + yz;
  float* cslot = nullptr;
  float* eslot = nullptr;
  if constexpr (kCov) cslot = cov + static_cast<size_t>(x) * chs + yz;
  if constexpr (kE > 0) eslot = ext + static_cast<size_t>(x) * kE * chs + yz;

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
      const size_t off = static_cast<size_t>(r) * d2;
      float* s = slot + off;
      s[0] = p.x;
      s[chs] = p.y;
      s[2 * chs] = p.z;
      s[3 * chs] = p.w;
      if constexpr (kCov) cslot[off] = 1.f;
      if constexpr (kE > 0) {
        const float* e = extra + static_cast<size_t>(i) * kE;
#pragma unroll
        for (int j = 0; j < kE; ++j) eslot[j * chs + off] = e[j];
      }
    }
  }
  for (int r = min(s1 - s0, k); r < k; ++r) {
    const size_t off = static_cast<size_t>(r) * d2;
    float* s = slot + off;
    s[0] = cx;
    s[chs] = cy;
    s[2 * chs] = cz;
    s[3 * chs] = 0.f;
    if constexpr (kCov) cslot[off] = 0.f;
    if constexpr (kE > 0) {
#pragma unroll
      for (int j = 0; j < kE; ++j) eslot[j * chs + off] = 0.f;
    }
  }
#pragma unroll
  for (int i = 0; i < 10; ++i) moments[static_cast<size_t>(i) * nc + c] = mom[i];
  moments[static_cast<size_t>(10) * nc + c] = static_cast<float>(s1 - s0);
}

// Dest form, in place on one table: mover j's row moves from slot src[j]
// (a flat index (x*k + r)*d^2 + yz of the (d, k, d^2) slot grid, the
// audit's order) to the slot id dest[j] = cell*k + slot, with its extra
// channels and its bookkeeping (slot_row: the row of each slot id, -1 when
// empty; idx_ext: the slot id of each row); its old slot gets the filler
// (centre, mass 0, cov 0, ext 0). dest ids outside [0, d^3*k) (the
// sentinels >= 2^24: denied arrivals) move nothing. The valid sources and
// destinations are all distinct slots (a row only moves to a slot above its
// target cell's high-water mark and leaves one below its own), so no two
// threads touch one slot.
__global__ void tile_move_kernel(const int* __restrict__ src,
                                 const int* __restrict__ dest, int m,
                                 const float* __restrict__ lo,
                                 const float* __restrict__ cellw,
                                 float* __restrict__ tiles,
                                 float* __restrict__ cov,
                                 float* __restrict__ ext,
                                 int* __restrict__ slot_row,
                                 int* __restrict__ idx_ext, int d, int k) {
  constexpr int kE = 3;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  const int d2 = d * d;
  const int nslots = d2 * d * k;
  const int t = dest[j];
  const int f = src[j];
  if (t < 0 || t >= nslots || f < 0 || f >= nslots) return;
  const size_t chs = static_cast<size_t>(k) * d2;
  // source: plane-order index -> (x, r, yz)
  const int fyz = f % d2;
  const int fxr = f / d2;
  const int fr = fxr % k;
  const int fx = fxr / k;
  const size_t foff = static_cast<size_t>(fr) * d2 + fyz;
  // destination: slot id -> (x, r, yz)
  const int tc = t / k;
  const int tx = tc / d2;
  const int tyz = tc - tx * d2;
  const size_t toff = static_cast<size_t>(t - tc * k) * d2 + tyz;

  float* fs = tiles + static_cast<size_t>(fx) * 4 * chs + foff;
  float* ts = tiles + static_cast<size_t>(tx) * 4 * chs + toff;
  float* fe = ext + static_cast<size_t>(fx) * kE * chs + foff;
  float* te = ext + static_cast<size_t>(tx) * kE * chs + toff;
#pragma unroll
  for (int c = 0; c < 4; ++c) ts[c * chs] = fs[c * chs];
#pragma unroll
  for (int c = 0; c < kE; ++c) {
    te[c * chs] = fe[c * chs];
    fe[c * chs] = 0.f;
  }
  cov[static_cast<size_t>(tx) * chs + toff] = 1.f;
  cov[static_cast<size_t>(fx) * chs + foff] = 0.f;
  const float cw = cellw[0];
  const int fy = fyz / d;
  fs[0] = centre(lo[0], fx, cw);
  fs[chs] = centre(lo[1], fy, cw);
  fs[2 * chs] = centre(lo[2], fyz - fy * d, cw);
  fs[3 * chs] = 0.f;

  const int fid = (fx * d2 + fyz) * k + fr;
  const int rid = slot_row[fid];
  slot_row[fid] = -1;
  slot_row[t] = rid;
  if (rid >= 0) idx_ext[rid] = t;
}

// After the moves: each moved row's old and new cell get their high-water
// mark (one past the highest occupied slot) recomputed from cov, as K4's
// live count. Threads that share a cell write the same value.
__global__ void cell_hwm_kernel(const int* __restrict__ src,
                                const int* __restrict__ dest, int m,
                                const float* __restrict__ cov,
                                float* __restrict__ live, int d, int k) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 2 * m) return;
  const int j = i < m ? i : i - m;
  const int d2 = d * d;
  const int nslots = d2 * d * k;
  const int t = dest[j];
  const int f = src[j];
  if (t < 0 || t >= nslots || f < 0 || f >= nslots) return;
  int x, yz;
  if (i < m) {
    x = f / (d2 * k);
    yz = f % d2;
  } else {
    const int c = t / k;
    x = c / d2;
    yz = c - x * d2;
  }
  const size_t chs = static_cast<size_t>(k) * d2;
  const float* cs = cov + static_cast<size_t>(x) * chs + yz;
  int h = 0;
  for (int r = 0; r < k; ++r) {
    if (cs[static_cast<size_t>(r) * d2] > 0.f) h = r + 1;
  }
  live[x * d2 + yz] = static_cast<float>(h);
}

constexpr int kThreads = 128;

template <bool kCov, int kE>
void launch_scatter(const float* psort, const float* extra,
                    const int* cell_start, const float* lo, const float* cellw,
                    float* tiles, float* moments, float* cov, float* ext,
                    int d, int k, cudaStream_t stream) {
  const int nc = d * d * d;
  tile_scatter_kernel<kCov, kE>
      <<<(nc + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
          reinterpret_cast<const float4*>(psort), extra, cell_start, lo,
          cellw, tiles, moments, cov, ext, d, k);
}

}  // namespace

extern "C" int nbt_tile_scatter(const float* psort, const int* cell_start,
                                const float* lo, const float* cellw,
                                float* tiles, float* moments, int d, int k,
                                void* stream) {
  launch_scatter<false, 0>(psort, nullptr, cell_start, lo, cellw, tiles,
                           moments, nullptr, nullptr, d, k,
                           static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// The rank form with coverage and the 3 velocity channels (extra (N, 3)
// row-major, ext (d, 3, k, d^2)): the table re-sort's form.
extern "C" int nbt_tile_scatter_ext(const float* psort, const float* extra,
                                    const int* cell_start, const float* lo,
                                    const float* cellw, float* tiles,
                                    float* moments, float* cov, float* ext,
                                    int d, int k, void* stream) {
  launch_scatter<true, 3>(psort, extra, cell_start, lo, cellw, tiles, moments,
                          cov, ext, d, k, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// The dest form, in place: src (M,) plane-order slot indices and dest (M,)
// slot ids, both int32, into the table tiles, cov and ext, its K4 liveness
// live (d^3,) and its bookkeeping slot_row (d^3*k,) and idx_ext (N,).
extern "C" int nbt_tile_place(const int* src, const int* dest, int m,
                              const float* lo, const float* cellw,
                              float* tiles, float* cov, float* ext,
                              float* live, int* slot_row, int* idx_ext, int d,
                              int k, void* stream) {
  if (m > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    tile_move_kernel<<<(m + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        src, dest, m, lo, cellw, tiles, cov, ext, slot_row, idx_ext, d, k);
    cell_hwm_kernel<<<(2 * m + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        src, dest, m, cov, live, d, k);
  }
  return static_cast<int>(cudaGetLastError());
}
