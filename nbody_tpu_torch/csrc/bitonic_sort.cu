// Bitonic sort of int32 (key, value) pairs by key, ascending, not stable.
//
// Replaces: nbody_tpu/ops/pallas_sort.py, the three kernels behind
// bitonic_sort_pairs / bitonic_argsort: _local_sort_kernel (a whole
// 2^18-element block in VMEM), _cross_pass_kernel (one pass between two
// blocks) and _merge_block_kernel (the in-block passes of a stage). The TPU
// layout, a (2048, 128) row/lane tile per block with every XOR-partner
// exchange made of two pltpu.rolls and a select, exists for the VPU and is
// not carried over.
//
// The network is the canonical one, so its result is a fixed function of
// the input, ties included, and equals the JAX function's bit for bit:
// N is padded to n_pad = 2^m (m >= 10); for stage k = 1..m and pass
// j = k-1..0, element i and its partner i ^ 2^j are compared in the
// direction given by bit k of i (set = descending), and they swap only on
// strict inequality of (key, pad). Each pair meets its comparators in that
// order; how passes are grouped into launches changes no bit.
//
// Elements. The working array holds (key, row) as one int2 per element:
// the row index of the input the key came from. A pad is a row >= n, so
// the pad flag is read off the row (no flag array), and the comparison is
// on (key, row >= n): a pad is greater than any real key, INT_MAX
// included, and the first n rows of the result are always the real ones
// (the JAX function's pads tie with a real INT_MAX key). When every key is
// below INT_MAX no comparison changes, so the output is the JAX
// function's. Values ride along as the row: the last launch writes
// vals_out[i] = vals_in[row[i]]. The pad flag can decide a comparison only
// between a pad and a real INT_MAX key, so each block (tile launches) or
// thread (device-memory groups) compares keys alone unless the elements it
// compares hold both (the same comparisons either way): the exact
// comparison in every pass is much slower (PERF.md, K8 findings).
//
// Shape of the work (kTileLog2 = 13: 8192-element tiles, 64 KB of dynamic
// shared memory, 1024 threads of 8 elements):
//   - a warp owns 256 consecutive elements, lane l holding elements
//     e * 32 + l (e = 0..7): passes with partner distance 2^j, j < 5, are
//     __shfl_xor_sync exchanges, j = 5..7 are exchanges between a thread's
//     own registers; neither touches shared memory or a barrier;
//   - passes j = 8..12 go through shared memory, in groups of up to 3:
//     each thread loads the 8 elements that 3 consecutive passes exchange
//     among themselves, runs the 3 passes in registers, and stores them,
//     so one barrier per group;
//   - (a) one launch sorts every tile (stages 1..13); the direction of
//     stage 13 is bit 13 of the global index, so neighbouring tiles
//     alternate, as alt_blocks does on the TPU;
//   - (b) for each stage k > 13, the passes j = k-1..13 over device memory
//     in groups of up to kGroup = 4 consecutive passes per launch: each
//     thread gathers the 16 elements those passes exchange among
//     themselves (stride 2^(j-3)), runs them in registers and writes back
//     once;
//   - (c) then one launch runs the passes j = 12..0 of stage k tile by
//     tile as in (a).
// At N = 1M (m = 20): 1 + 10 groups + 7 merges = 18 launches, all queued
// by one call of nbt_bitonic_sort. The schedule is ops/sort.py's
// launch_plan, passed in by the wrapper as the first and last pass of each
// launch; the entry point runs it after checking that the launches chain
// into the canonical pass sequence, and refuses any other.
//
// What bounds it on the H100: the function moves one read and one write of
// keys and values, 16 MB at 1M, 4.8 us at 3.35 TB/s, and O(N log N)
// integer compares; no comparison network reaches that bytes bound, since
// it makes m(m+1)/2 = 210 passes over the data at 1M. This design pays for
// the passes where they are cheap: 132 of the 210 run in shuffles (90) or
// between a thread's registers (42), 50 in shared memory in 12 + 7 x 3
// barriers per tile, and the 28 over device memory are fused into 10
// launches, each one read and one write of the 8 MB working array, which
// stays in the 50 MB L2. The pad flag costs no bytes: it is the row.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kTileLog2 = 13;     // elements per shared-memory tile
constexpr int kPerThread = 8;     // elements per thread in a tile
constexpr int kWarpLog2 = 8;      // 32 lanes x 8 elements
constexpr int kSmemGroup = 3;     // passes per shared-memory group
constexpr int kGroup = 4;         // most passes per device-memory launch
constexpr int kGroupThreads = 256;

// (key, pad) of a > (key, pad) of b; the pad flag is row >= n. Without a
// real INT_MAX key beside a pad (kExact false) the pad flag never decides,
// and the keys alone give the same comparisons.
template <bool kExact>
__device__ __forceinline__ bool greater(int2 a, int2 b, int n) {
  if (kExact) return a.x > b.x || (a.x == b.x && a.y >= n && b.y < n);
  return a.x > b.x;
}

// Compare-exchange by selects, so that no warp branches on the data.
template <bool kExact>
__device__ __forceinline__ void exchange(int2& lo, int2& hi, bool desc,
                                         int n) {
  const bool swap =
      desc ? greater<kExact>(hi, lo, n) : greater<kExact>(lo, hi, n);
  const int2 a = lo, b = hi;
  lo = make_int2(swap ? b.x : a.x, swap ? b.y : a.y);
  hi = make_int2(swap ? a.x : b.x, swap ? a.y : b.y);
}

// R consecutive passes on the 2^R elements x[q] = a[base + q * stride], the
// first pass on bit R-1 of q; one direction for all of them.
template <int R, bool kExact>
__device__ __forceinline__ void group_passes(int2 (&x)[1 << R], bool desc,
                                             int n) {
#pragma unroll
  for (int b = R - 1; b >= 0; --b) {
#pragma unroll
    for (int q = 0; q < (1 << R); ++q) {
      if (!(q & (1 << b))) exchange<kExact>(x[q], x[q | (1 << b)], desc, n);
    }
  }
}

// Base index of group g of the passes j_top .. j_top-R+1: g's low bits
// below j_top-R+1 stay, the rest move above j_top.
__device__ __forceinline__ int group_base(int g, int j_top, int r) {
  const int low = j_top - r + 1;
  return ((g >> low) << (j_top + 1)) | (g & ((1 << low) - 1));
}

// One group of R passes (j_top .. j_top-R+1, R <= 3) of stage k over the
// tile in shared memory; tile_base is the tile's first global index.
template <int R, bool kExact>
__device__ __forceinline__ void smem_group(int2* s, int tile_log2,
                                           int tile_base, int j_top, int k,
                                           int n) {
  const int low = j_top - R + 1;
  const int groups = 1 << (tile_log2 - R);
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    const int base = group_base(g, j_top, R);
    int2 x[1 << R];
#pragma unroll
    for (int q = 0; q < (1 << R); ++q) x[q] = s[base + (q << low)];
    group_passes<R, kExact>(x, ((tile_base + base) >> k) & 1, n);
#pragma unroll
    for (int q = 0; q < (1 << R); ++q) s[base + (q << low)] = x[q];
  }
}

// The pass whose partners are x[e] and x[e ^ B] of one thread.
template <int B, bool kExact>
__device__ __forceinline__ void register_pass(int2 (&x)[kPerThread],
                                              const bool (&desc)[kPerThread],
                                              int n) {
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    if (!(e & B)) exchange<kExact>(x[e], x[e | B], desc[e], n);
  }
}

// Stages k_lo..k_hi of the tile whose element seg + 32 e this thread holds
// in x[e], passes j = min(k, tile_log2) - 1 .. 0 of each.
template <bool kExact>
__device__ __forceinline__ void tile_stages(int2 (&x)[kPerThread], int2* s,
                                            int seg, int tile_base,
                                            int tile_log2, int k_lo, int k_hi,
                                            int n) {
  const int lane = threadIdx.x & 31;
  for (int k = k_lo; k <= k_hi; ++k) {
    bool desc[kPerThread];  // bit k of each element's index
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) desc[e] = ((seg + 32 * e) >> k) & 1;
    int j = (k < tile_log2 ? k : tile_log2) - 1;
    if (j >= kWarpLog2) {
#pragma unroll
      for (int e = 0; e < kPerThread; ++e) s[seg - tile_base + 32 * e] = x[e];
      __syncthreads();
      while (j >= kWarpLog2) {
        const int r = j - kWarpLog2 + 1 < kSmemGroup ? j - kWarpLog2 + 1
                                                     : kSmemGroup;
        if (r == 3) {
          smem_group<3, kExact>(s, tile_log2, tile_base, j, k, n);
        } else if (r == 2) {
          smem_group<2, kExact>(s, tile_log2, tile_base, j, k, n);
        } else {
          smem_group<1, kExact>(s, tile_log2, tile_base, j, k, n);
        }
        __syncthreads();
        j -= r;
      }
#pragma unroll
      for (int e = 0; e < kPerThread; ++e) x[e] = s[seg - tile_base + 32 * e];
      // the next spill writes only this thread's own slots, which no other
      // thread reads before the barrier that follows it
    }
    // partner in the same thread: e ^ 2^(j-5); j is 7 or below here, and
    // each pass is spelled out so that x[] is indexed statically
    if (j >= 7) register_pass<4, kExact>(x, desc, n);
    if (j >= 6) register_pass<2, kExact>(x, desc, n);
    if (j >= 5) register_pass<1, kExact>(x, desc, n);
    if (j > 4) j = 4;
    for (; j >= 0; --j) {  // partner in the same warp: lane ^ 2^j
      const bool lo = !(lane & (1 << j));
#pragma unroll
      for (int e = 0; e < kPerThread; ++e) {
        int2 y;
        y.x = __shfl_xor_sync(0xffffffffu, x[e].x, 1 << j);
        y.y = __shfl_xor_sync(0xffffffffu, x[e].y, 1 << j);
        // the lower element keeps the smaller one going up, the larger
        // going down; the upper element the other
        const bool take = lo == desc[e] ? greater<kExact>(y, x[e], n)
                                        : greater<kExact>(x[e], y, n);
        x[e] = make_int2(take ? y.x : x[e].x, take ? y.y : x[e].y);
      }
    }
  }
}

// Whether the pad flag can decide a comparison among the elements x[] of
// one thread: a real INT_MAX key and a pad both among them.
template <int E>
__device__ __forceinline__ void pads_and_int_max(const int2 (&x)[E], int n,
                                                 bool& pad, bool& int_max) {
  pad = int_max = false;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    pad |= x[e].y >= n;
    int_max |= x[e].y < n && x[e].x == INT_MAX;
  }
}

// Stages k_lo..k_hi of each 2^tile_log2 tile. Input: keys_in (rows >= n
// are pads, INT_MAX) when given, else the working array. Output: the first
// n rows as keys_out and vals_in[row] when keys_out is given, else the
// working array.
__global__ void __launch_bounds__(1 << (kTileLog2 - 3))
bitonic_tile_kernel(const int* keys_in, const int* vals_in, int n,
                    int2* work, int* keys_out, int* vals_out, int tile_log2,
                    int k_lo, int k_hi) {
  extern __shared__ int2 s[];
  const int tile_base = blockIdx.x << tile_log2;
  const int seg = tile_base + ((threadIdx.x >> 5) << kWarpLog2) +
                  (threadIdx.x & 31);
  int2 x[kPerThread];  // x[e] is global element seg + 32 e
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    const int g = seg + 32 * e;
    x[e] = keys_in != nullptr ? make_int2(g < n ? keys_in[g] : INT_MAX, g)
                              : work[g];
  }
  // every comparison of this launch is inside the tile
  bool pad, int_max;
  pads_and_int_max(x, n, pad, int_max);
  const bool ex = __syncthreads_or(pad) && __syncthreads_or(int_max);
  if (ex) {
    tile_stages<true>(x, s, seg, tile_base, tile_log2, k_lo, k_hi, n);
  } else {
    tile_stages<false>(x, s, seg, tile_base, tile_log2, k_lo, k_hi, n);
  }
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    const int g = seg + 32 * e;
    if (keys_out != nullptr) {
      if (g < n) {
        keys_out[g] = x[e].x;
        vals_out[g] = vals_in[x[e].y];
      }
    } else {
      work[g] = x[e];
    }
  }
}

// R consecutive passes j_top .. j_top-R+1 of stage k over the working
// array in device memory, one group of 2^R elements per thread.
template <int R>
__global__ void __launch_bounds__(kGroupThreads)
bitonic_group_kernel(int2* work, int n_groups, int j_top, int k, int n) {
  const int g = blockIdx.x * kGroupThreads + threadIdx.x;
  if (g >= n_groups) return;
  const int low = j_top - R + 1;
  const int base = group_base(g, j_top, R);
  int2 x[1 << R];
#pragma unroll
  for (int q = 0; q < (1 << R); ++q) x[q] = work[base + (q << low)];
  const bool desc = (base >> k) & 1;
  bool pad, int_max;  // every comparison of this thread is among x[]
  pads_and_int_max(x, n, pad, int_max);
  if (pad && int_max) {
    group_passes<R, true>(x, desc, n);
  } else {
    group_passes<R, false>(x, desc, n);
  }
#pragma unroll
  for (int q = 0; q < (1 << R); ++q) work[base + (q << low)] = x[q];
}

int launch_group(int r, int2* work, int n_pad, int j_top, int k, int n,
                 cudaStream_t stream) {
  const int n_groups = n_pad >> r;
  const int blocks = (n_groups + kGroupThreads - 1) / kGroupThreads;
  switch (r) {
    case 4:
      bitonic_group_kernel<4><<<blocks, kGroupThreads, 0, stream>>>(
          work, n_groups, j_top, k, n);
      break;
    case 3:
      bitonic_group_kernel<3><<<blocks, kGroupThreads, 0, stream>>>(
          work, n_groups, j_top, k, n);
      break;
    case 2:
      bitonic_group_kernel<2><<<blocks, kGroupThreads, 0, stream>>>(
          work, n_groups, j_top, k, n);
      break;
    default:
      bitonic_group_kernel<1><<<blocks, kGroupThreads, 0, stream>>>(
          work, n_groups, j_top, k, n);
  }
  return static_cast<int>(cudaGetLastError());
}

// Whether plan (n_launches entries of the first and last pass of a launch,
// (k, j) each) is a schedule this file runs: the launches chain into the
// canonical sequence (1, 0), (2, 1), (2, 0), ... (m, 0), and each is
// either tile passes (j = min(k, t) - 1 .. 0 of stages k_first..k_last,
// one stage once k_last > t) or a group of 1..kGroup passes j >= t of one
// stage.
bool valid_plan(const int* plan, int n_launches, int m, int t) {
  int k = 1, j = 0;  // the next pass of the canonical sequence
  for (int i = 0; i < n_launches; ++i) {
    const int* e = plan + 4 * i;
    if (e[0] != k || e[1] != j || e[2] < k || e[2] > m) return false;
    const bool tile = e[1] == (k < t ? k : t) - 1 && e[3] == 0 &&
                      (e[2] == k || e[2] <= t);
    const bool group = e[2] == k && e[3] >= t && e[3] <= j &&
                       j - e[3] < kGroup;
    if (!tile && !group) return false;
    k = e[3] == 0 ? e[2] + 1 : e[2];
    j = e[3] == 0 ? e[2] : e[3] - 1;
  }
  return k == m + 1;
}

}  // namespace

// Sorts keys_in/vals_in (n rows) into keys_out/vals_out (n rows) by the
// launches of plan, a host array of n_launches x (k_first, j_first,
// k_last, j_last). work is scratch of 2^m int2 (8 bytes each).
extern "C" int nbt_bitonic_sort(const int* keys_in, const int* vals_in,
                                int n, int m, const int* plan,
                                int n_launches, int* work, int* keys_out,
                                int* vals_out, void* stream_ptr) {
  const int tile_log2 = m < kTileLog2 ? m : kTileLog2;
  if (m < 10 || m > 30 || n < 0 || n > (1 << m) || work == nullptr ||
      plan == nullptr || !valid_plan(plan, n_launches, m, tile_log2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  int2* w = reinterpret_cast<int2*>(work);
  const int n_pad = 1 << m;
  const int tiles = n_pad >> tile_log2;
  const int threads = 1 << (tile_log2 - 3);
  const size_t smem = sizeof(int2) << tile_log2;
  // the opt-in above 48 KB of dynamic shared memory, once per device
  static bool opted_in[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= 64) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  if (!opted_in[device]) {
    err = cudaFuncSetAttribute(bitonic_tile_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(sizeof(int2) << kTileLog2));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in[device] = true;
  }
  for (int i = 0; i < n_launches; ++i) {
    const int* e = plan + 4 * i;
    if (e[3] == 0) {  // tile passes: the first reads keys_in, the last
                      // writes keys_out
      bitonic_tile_kernel<<<tiles, threads, smem, stream>>>(
          i == 0 ? keys_in : nullptr, vals_in, n, w,
          i == n_launches - 1 ? keys_out : nullptr, vals_out, tile_log2,
          e[0], e[2]);
      err = cudaGetLastError();
    } else {
      err = static_cast<cudaError_t>(launch_group(
          e[1] - e[3] + 1, w, n_pad, e[1], e[0], n, stream));
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}
