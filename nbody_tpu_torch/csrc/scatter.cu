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
// ~16 + 67 + 12 MB in the main form, ~29 us at 3.35 TB/s; the table
// form's cov and 3 extra planes add 67 MB. The slot stores are 70 % of
// the bytes, so the design makes every one of them a full coalesced line.
//
// Rank form design: one block of kThreads per (x, y) z-row of d cells.
// The z-row's cells are consecutive cell ids, so its rows are one
// contiguous range of psort, from cell_start[c0] to cell_start[c0 + d],
// and the block reads nothing else but those d + 1 entries of cell_start.
//   * Staging: the range is copied to shared memory kChunkRows rows at a
//     time with 16-byte cp.async (4-byte ones for the 12-byte extra rows).
//     At the 1M shapes every z-row fits one chunk (the longest: 520 rows
//     at step 0, 1060 after the Barnes-Hut collapse); a longer one loops
//     over chunks, so a cell of any length stays exact.
//   * Slot stores: a thread per slot (r, z), z fastest, writes its slot's
//     4 channels (and cov, ext) exactly once: the staged row of rank r
//     when r < count(z), else the filler. Each store instruction of a warp
//     covers consecutive z of one (channel, r) plane row, the d floats at
//     tiles[x, ch, r, y*d : y*d + d]: one coalesced pass, no second
//     filler loop. A z-row longer than a chunk stores each placed slot
//     while its row is staged and the filler with the first chunk.
//   * Moments, summed from shared memory in a fixed order with no float
//     atomics, so two calls are bit-equal. A run of at most kSlice rows
//     (all but a few cells even in the collapse) is summed by one thread
//     serially in row order, the arithmetic of the one-thread-per-cell
//     kernel this replaces. A longer run is cut by the fixed kSlice-row
//     slices of the z-row's row range: a warp sums each slice a row a
//     lane, then a fixed __shfl_xor tree; the cell's slice sums are added
//     in slice order, and a run that spans chunks carries its sum from one
//     chunk to the next. Since a long run has more rows than a slice,
//     a slice meets at most two long runs (the one holding its first row
//     and the one holding its last), so a slice's sums have two fixed
//     places. The count is cell_start[c+1] - cell_start[c] as a float.
// Each form is its own template instantiation (coverage, E).
//
// Dest form design: a thread per mover (distinct slots: no races), then a
// thread per touched cell reading the cell's k entries of slot_row, one
// 64-byte line at k = 16: occupied (cov 1) exactly where slot_row >= 0,
// which the table keeps after every build and move. The whole move is one
// call, because on the card a repair step is bound by the host's
// launches, not by its bytes (~100 B a mover).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;     // rank form: a block per z-row, 8 warps
constexpr int kChunkRows = 1024;  // rows staged at a time (16 KB float4)
constexpr int kSlice = 32;        // rows a warp sums at once; longer runs
                                  // are summed by slices
constexpr int kSlices = kChunkRows / kSlice;
constexpr int kMoveThreads = 128;
constexpr int kMaxSmem = 200 * 1024;

// Dynamic shared memory of the rank form: the staged rows, their extra
// channels, the per-cell moment sums (10, d), two slice sums a slice, and
// the z-row's d + 1 cell starts.
__host__ __device__ constexpr int scatter_smem(int d, int e) {
  return kChunkRows * 16 + kChunkRows * e * 4 + 10 * d * 4 +
         kSlices * 20 * 4 + (d + 1) * 4;
}

// Centres rounded as the plain twin rounds them (no FMA contraction), so
// filler slots and moment offsets match it bit for bit.
__device__ __forceinline__ float centre(float lo, int c, float cw) {
  return __fadd_rn(lo, __fmul_rn(static_cast<float>(c) + 0.5f, cw));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
      static_cast<unsigned>(__cvta_generic_to_shared(dst))), "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
      static_cast<unsigned>(__cvta_generic_to_shared(dst))), "l"(src));
}

// Row p's ten moment terms about the centre (cx, cy, cz), added to mom.
__device__ __forceinline__ void add_row(float* mom, float4 p, float cx,
                                        float cy, float cz) {
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
}

// The z-row cell holding row i: the last z with cs[z] <= i.
__device__ __forceinline__ int cell_of(const int* cs, int d, int i) {
  int lo = 0, hi = d - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (cs[mid] <= i) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

// A warp's sum of the staged rows [a, b) (b - a <= 32, a row a lane) by a
// fixed xor tree; lane 0 stores the ten sums at out. Every lane calls it.
__device__ __forceinline__ void slice_sum(const float4* rows, int clo, int a,
                                          int b, float cx, float cy, float cz,
                                          int lane, float* out) {
  float mom[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) mom[i] = 0.f;
  if (a + lane < b) add_row(mom, rows[a + lane - clo], cx, cy, cz);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < 10; ++i) {
      mom[i] += __shfl_xor_sync(0xffffffffu, mom[i], off);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 10; ++i) out[i] = mom[i];
  }
}

template <bool kCov, int kE>
__global__ void __launch_bounds__(kThreads)
    tile_scatter_kernel(const float4* __restrict__ psort,
                        const float* __restrict__ extra,
                        const int* __restrict__ cell_start,
                        const float* __restrict__ lo,
                        const float* __restrict__ cellw,
                        float* __restrict__ tiles, float* __restrict__ moments,
                        float* __restrict__ cov, float* __restrict__ ext,
                        int d, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* rows_s = reinterpret_cast<float4*>(smem);
  float* ext_s = reinterpret_cast<float*>(rows_s + kChunkRows);
  float* acc_s = ext_s + kChunkRows * kE;  // (10, d)
  float* part_s = acc_s + 10 * d;          // (kSlices, 2, 10)
  int* cs_s = reinterpret_cast<int*>(part_s + kSlices * 20);

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int d2 = d * d;
  const int nc = d2 * d;
  const int x = blockIdx.x / d;
  const int y = blockIdx.x - x * d;
  const int c0 = blockIdx.x * d;  // x*d^2 + y*d: the z-row's first cell
  const float cw = cellw[0];
  const float lz = lo[2];
  const float cx = centre(lo[0], x, cw);
  const float cy = centre(lo[1], y, cw);

  const int r0 = cell_start[c0];
  const int r1 = cell_start[c0 + d];
  bool has_long = false;
  for (int z = t; z < d; z += kThreads) {
    const int a = cell_start[c0 + z];
    cs_s[z] = a;
    has_long |= cell_start[c0 + z + 1] - a > kSlice;
#pragma unroll
    for (int i = 0; i < 10; ++i) acc_s[i * d + z] = 0.f;
  }
  if (t == 0) cs_s[d] = r1;

  // the z-row's slab: slot (r, z) of channel ch at ch*chs + r*d^2 + z
  const size_t chs = static_cast<size_t>(k) * d2;
  const size_t row0 = static_cast<size_t>(y) * d;
  float* slot = tiles + static_cast<size_t>(x) * 4 * chs + row0;
  float* cslot = nullptr;
  float* eslot = nullptr;
  if constexpr (kCov) cslot = cov + static_cast<size_t>(x) * chs + row0;
  if constexpr (kE > 0) {
    eslot = ext + static_cast<size_t>(x) * kE * chs + row0;
  }

  const int nrows = r1 - r0;
  const int nchunks = nrows > 0 ? (nrows + kChunkRows - 1) / kChunkRows : 1;
  for (int j = 0; j < nchunks; ++j) {
    if (j > 0) __syncthreads();  // the previous chunk is read
    const int clo = r0 + j * kChunkRows;
    const int chi = min(clo + kChunkRows, r1);
    const int len = chi - clo;
    for (int i = t; i < len; i += kThreads) {
      cp_async16(rows_s + i, psort + clo + i);
    }
    if constexpr (kE > 0) {
      const float* src = extra + static_cast<size_t>(clo) * kE;
      for (int i = t; i < len * kE; i += kThreads) {
        cp_async4(ext_s + i, src + i);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::);
    const bool any_long = __syncthreads_or(has_long) != 0;

    // slot stores: placed rows staged in this chunk, the filler once
    for (int i = t; i < d * k; i += kThreads) {
      const int r = i / d;
      const int z = i - r * d;
      const int s = cs_s[z];
      const int g = s + r - clo;  // staged index of rank r's row
      const bool placed = r < cs_s[z + 1] - s;
      float4 v;
      float e[kE > 0 ? kE : 1];
      bool store;
      if (placed) {
        store = g >= 0 && g < len;
        if (store) {
          v = rows_s[g];
#pragma unroll
          for (int c = 0; c < kE; ++c) e[c] = ext_s[g * kE + c];
        }
      } else {
        store = j == 0;
        v = make_float4(cx, cy, centre(lz, z, cw), 0.f);
#pragma unroll
        for (int c = 0; c < kE; ++c) e[c] = 0.f;
      }
      if (store) {
        const size_t off = static_cast<size_t>(r) * d2 + z;
        slot[off] = v.x;
        slot[chs + off] = v.y;
        slot[2 * chs + off] = v.z;
        slot[3 * chs + off] = v.w;
        if constexpr (kCov) cslot[off] = placed ? 1.f : 0.f;
#pragma unroll
        for (int c = 0; c < kE; ++c) eslot[c * chs + off] = e[c];
      }
    }

    // moments of the short runs: a thread per cell, in row order
    for (int z = t; z < d; z += kThreads) {
      const int s = cs_s[z];
      const int e = cs_s[z + 1];
      const int a = max(s, clo);
      const int b = min(e, chi);
      if (e - s > kSlice || a >= b) continue;
      const float cz = centre(lz, z, cw);
      float mom[10];
#pragma unroll
      for (int i = 0; i < 10; ++i) mom[i] = acc_s[i * d + z];
      for (int i = a; i < b; ++i) add_row(mom, rows_s[i - clo], cx, cy, cz);
#pragma unroll
      for (int i = 0; i < 10; ++i) acc_s[i * d + z] = mom[i];
    }
    if (!any_long) continue;

    // the long runs: a warp per slice, then each cell's slices in order
    const int nsl = (len + kSlice - 1) / kSlice;
    for (int sl = t >> 5; sl < nsl; sl += kThreads / 32) {
      const int a = clo + sl * kSlice;
      const int b = min(a + kSlice, chi);
      const int za = cell_of(cs_s, d, a);
      const int zb = cell_of(cs_s, d, b - 1);
      if (cs_s[za + 1] - cs_s[za] > kSlice) {
        slice_sum(rows_s, clo, a, min(b, cs_s[za + 1]), cx, cy,
                  centre(lz, za, cw), lane, part_s + sl * 20);
      }
      if (zb != za && cs_s[zb + 1] - cs_s[zb] > kSlice) {
        slice_sum(rows_s, clo, cs_s[zb], b, cx, cy, centre(lz, zb, cw), lane,
                  part_s + sl * 20 + 10);
      }
    }
    __syncthreads();
    for (int z = t; z < d; z += kThreads) {
      const int s = cs_s[z];
      const int e = cs_s[z + 1];
      const int a = max(s, clo);
      const int b = min(e, chi);
      if (e - s <= kSlice || a >= b) continue;
      float mom[10];
#pragma unroll
      for (int i = 0; i < 10; ++i) mom[i] = acc_s[i * d + z];
      for (int sl = (a - clo) / kSlice; sl <= (b - 1 - clo) / kSlice; ++sl) {
        // the run holds the slice's first row, or starts inside it
        const float* p =
            part_s + sl * 20 + (s <= clo + sl * kSlice ? 0 : 10);
#pragma unroll
        for (int i = 0; i < 10; ++i) mom[i] += p[i];
      }
#pragma unroll
      for (int i = 0; i < 10; ++i) acc_s[i * d + z] = mom[i];
    }
  }

  // each cell's sums were last written by this same thread
  for (int z = t; z < d; z += kThreads) {
#pragma unroll
    for (int i = 0; i < 10; ++i) {
      moments[static_cast<size_t>(i) * nc + c0 + z] = acc_s[i * d + z];
    }
    moments[static_cast<size_t>(10) * nc + c0 + z] =
        static_cast<float>(cs_s[z + 1] - cs_s[z]);
  }
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
// mark (one past the highest occupied slot), K4's live count, from the
// cell's k contiguous slot_row entries (occupied where >= 0, as cov is
// 1). Threads that share a cell write the same value.
__global__ void cell_hwm_kernel(const int* __restrict__ src,
                                const int* __restrict__ dest, int m,
                                const int* __restrict__ slot_row,
                                float* __restrict__ live, int d, int k) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 2 * m) return;
  const int j = i < m ? i : i - m;
  const int d2 = d * d;
  const int nslots = d2 * d * k;
  const int t = dest[j];
  const int f = src[j];
  if (t < 0 || t >= nslots || f < 0 || f >= nslots) return;
  const int c = i < m ? (f / (d2 * k)) * d2 + f % d2 : t / k;
  const int* row = slot_row + static_cast<size_t>(c) * k;
  int h = 0;
  for (int r = 0; r < k; ++r) {
    if (row[r] >= 0) h = r + 1;
  }
  live[c] = static_cast<float>(h);
}

template <bool kCov, int kE>
int launch_scatter(const float* psort, const float* extra,
                   const int* cell_start, const float* lo, const float* cellw,
                   float* tiles, float* moments, float* cov, float* ext, int d,
                   int k, cudaStream_t stream) {
  if (d < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = scatter_smem(d, kE);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = tile_scatter_kernel<kCov, kE>;
  if (smem > 48 * 1024) {  // opt in above 48 KB: d > 400 (table), > 683
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<d * d, kThreads, smem, stream>>>(
      reinterpret_cast<const float4*>(psort), extra, cell_start, lo, cellw,
      tiles, moments, cov, ext, d, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int nbt_tile_scatter(const float* psort, const int* cell_start,
                                const float* lo, const float* cellw,
                                float* tiles, float* moments, int d, int k,
                                void* stream) {
  return launch_scatter<false, 0>(psort, nullptr, cell_start, lo, cellw,
                                  tiles, moments, nullptr, nullptr, d, k,
                                  static_cast<cudaStream_t>(stream));
}

// The rank form with coverage and the 3 velocity channels (extra (N, 3)
// row-major, ext (d, 3, k, d^2)): the table re-sort's form.
extern "C" int nbt_tile_scatter_ext(const float* psort, const float* extra,
                                    const int* cell_start, const float* lo,
                                    const float* cellw, float* tiles,
                                    float* moments, float* cov, float* ext,
                                    int d, int k, void* stream) {
  return launch_scatter<true, 3>(psort, extra, cell_start, lo, cellw, tiles,
                                 moments, cov, ext, d, k,
                                 static_cast<cudaStream_t>(stream));
}

// The rank form's plan: rows staged a chunk (field 0), and the longest run
// a thread sums alone, also the rows of a warp's slice (1); -1 for another
// field.
extern "C" int nbt_tile_scatter_plan(int field) {
  switch (field) {
    case 0: return kChunkRows;
    case 1: return kSlice;
    default: return -1;
  }
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
    tile_move_kernel<<<(m + kMoveThreads - 1) / kMoveThreads, kMoveThreads,
                       0, s>>>(src, dest, m, lo, cellw, tiles, cov, ext,
                               slot_row, idx_ext, d, k);
    cell_hwm_kernel<<<(2 * m + kMoveThreads - 1) / kMoveThreads,
                      kMoveThreads, 0, s>>>(src, dest, m, slot_row, live, d,
                                            k);
  }
  return static_cast<int>(cudaGetLastError());
}
