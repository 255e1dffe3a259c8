// Bitonic sort of int32 (key, value) pairs by key, ascending, not stable.
//
// Replaces: nbody_tpu/ops/pallas_sort.py, the three kernels behind
// bitonic_sort_pairs / bitonic_argsort: _local_sort_kernel (a whole
// 2^18-element block in VMEM), _cross_pass_kernel (one pass between two
// blocks) and _merge_block_kernel (the in-block passes of a stage). The TPU
// layout, a (2048, 128) row/lane tile per block with every XOR-partner
// exchange made of two pltpu.rolls and a select, exists for the VPU and is
// not carried over: here a pass is one compare-exchange per thread.
//
// The network is the canonical one, so its result is a fixed function of
// the input, ties included, and equals the JAX function's bit for bit:
// N is padded to n_pad = 2^m (m >= 10); for stage k = 1..m and pass
// j = k-1..0, element i and its partner i ^ 2^j are compared in the
// direction given by bit k of i (set = descending), and they swap only on
// strict inequality.
//
// Padding. The JAX function pads with INT_MAX keys, so a real INT_MAX key
// ties with a pad and a pad can end up inside the first n rows: its
// permutation then repeats row 0. Here every element carries a pad flag
// and the comparison is on (key, pad), so a pad is greater than any real
// key, INT_MAX included, and the first n rows are always the real ones.
// When every key is below INT_MAX no comparison changes, so the output is
// the JAX function's. The flags live in a byte array beside the working
// keys; when n is a power of two there is no pad and no flag array.
//
// Shape of the work (kTileLog2 = 11, so 2048-element tiles):
//   (a) one launch sorts every tile in shared memory (stages 1..11); the
//       direction of stage 11 is bit 11 of the global index, which makes
//       neighbouring tiles alternate, as alt_blocks does on the TPU;
//   (b) for each stage k > 11, each pass j >= 11 is one launch over device
//       memory, one thread per pair;
//   (c) then one launch runs the passes j = 10..0 of stage k in shared
//       memory, tile by tile.
// At N = 1M (m = 20) that is 1 + sum_{k=12}^{20} ((k - 11) + 1) = 55
// launches, all queued by one call of nbt_bitonic_sort.
//
// What bounds it on the H100: the function moves one read and one write of
// the padded pairs, 2 x 2 x 4 B x 2^20 = 16.8 MB at 1M, 5.0 us at
// 3.35 TB/s; it does O(N) compare-exchanges per pass. This design's cost
// is its 210 passes: 66 in shared memory in (a), 45 over device memory in
// (b) and 99 in shared memory in (c). The 8 MB of keys and values (9 MB
// with flags) fit in the 50 MB L2, so the passes of (b) run mostly from
// L2, and the 55 launches are queued back to back from C with no host
// work between them.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kTileLog2 = 11;
constexpr int kTile = 1 << kTileLog2;
constexpr int kGlobalThreads = 256;

// (ka, pa) > (kb, pb): keys first, then the pad flag.
__device__ __forceinline__ bool greater(int ka, int pa, int kb, int pb) {
  return ka > kb || (ka == kb && pa > pb);
}

// Index of the lower element of pair p in a pass with partner distance 2^j.
__device__ __forceinline__ int pair_lo(int p, int j) {
  return ((p >> j) << (j + 1)) | (p & ((1 << j) - 1));
}

// Stages k_lo..k_hi of one tile of 2^tile_log2 elements in shared memory,
// passes j = min(k, tile_log2) - 1 .. 0 of each (one pair per thread,
// blockDim = half the tile). Reads src (rows at or past n_src are pads:
// key INT_MAX, value 0, flag 1, unless src_pads gives the flags) and
// writes dst; src may equal dst. dst_pads is written when given.
__global__ void __launch_bounds__(kTile / 2)
tile_sort_kernel(const int* src_keys, const int* src_vals,
                 const unsigned char* src_pads, int n_src, int* dst_keys,
                 int* dst_vals, unsigned char* dst_pads, int tile_log2,
                 int k_lo, int k_hi) {
  __shared__ int sk[kTile];
  __shared__ int sv[kTile];
  __shared__ unsigned char sp[kTile];
  const int base = blockIdx.x << tile_log2;
  const int t = threadIdx.x;
  const int half = 1 << (tile_log2 - 1);
  for (int r = t; r < 2 * half; r += half) {
    const int g = base + r;
    const bool real = g < n_src;
    sk[r] = real ? src_keys[g] : INT_MAX;
    sv[r] = real ? src_vals[g] : 0;
    sp[r] = src_pads != nullptr ? src_pads[g] : (real ? 0 : 1);
  }
  __syncthreads();
  for (int k = k_lo; k <= k_hi; ++k) {
    const int j_top = k < tile_log2 ? k : tile_log2;
    for (int j = j_top - 1; j >= 0; --j) {
      const int lo = pair_lo(t, j);
      const int hi = lo | (1 << j);
      const bool desc = ((base + lo) >> k) & 1;
      const int ka = sk[lo], kb = sk[hi];
      const int pa = sp[lo], pb = sp[hi];
      const bool swap = desc ? greater(kb, pb, ka, pa)
                             : greater(ka, pa, kb, pb);
      if (swap) {
        sk[lo] = kb;
        sk[hi] = ka;
        const int va = sv[lo];
        sv[lo] = sv[hi];
        sv[hi] = va;
        sp[lo] = static_cast<unsigned char>(pb);
        sp[hi] = static_cast<unsigned char>(pa);
      }
      __syncthreads();
    }
  }
  for (int r = t; r < 2 * half; r += half) {
    const int g = base + r;
    dst_keys[g] = sk[r];
    dst_vals[g] = sv[r];
    if (dst_pads != nullptr) dst_pads[g] = sp[r];
  }
}

// One pass (k, j) over the whole padded array in device memory.
__global__ void __launch_bounds__(kGlobalThreads)
global_pass_kernel(int* keys, int* vals, unsigned char* pads, int n_pairs,
                   int k, int j) {
  const int p = blockIdx.x * kGlobalThreads + threadIdx.x;
  if (p >= n_pairs) return;
  const int lo = pair_lo(p, j);
  const int hi = lo | (1 << j);
  const bool desc = (lo >> k) & 1;
  const int ka = keys[lo], kb = keys[hi];
  const int pa = pads != nullptr ? pads[lo] : 0;
  const int pb = pads != nullptr ? pads[hi] : 0;
  const bool swap = desc ? greater(kb, pb, ka, pa) : greater(ka, pa, kb, pb);
  if (swap) {
    keys[lo] = kb;
    keys[hi] = ka;
    const int va = vals[lo];
    vals[lo] = vals[hi];
    vals[hi] = va;
    if (pads != nullptr) {
      pads[lo] = static_cast<unsigned char>(pb);
      pads[hi] = static_cast<unsigned char>(pa);
    }
  }
}

}  // namespace

// Sorts keys_in/vals_in (n rows) into keys/vals (2^m rows, the first n the
// sorted real pairs). pads (2^m bytes of scratch) must be given when
// n < 2^m and may be null when n == 2^m.
extern "C" int nbt_bitonic_sort(const int* keys_in, const int* vals_in,
                                int n, int m, int* keys, int* vals,
                                unsigned char* pads, void* stream_ptr) {
  if (m < 10 || m > 30 || n < 0 || n > (1 << m) ||
      (pads == nullptr && n != (1 << m))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int n_pad = 1 << m;
  const int tile_log2 = m < kTileLog2 ? m : kTileLog2;
  const int tiles = n_pad >> tile_log2;
  const int tile_threads = 1 << (tile_log2 - 1);
  tile_sort_kernel<<<tiles, tile_threads, 0, stream>>>(
      keys_in, vals_in, nullptr, n, keys, vals, pads, tile_log2, 1,
      tile_log2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_pairs = n_pad / 2;
  const int pass_blocks = (n_pairs + kGlobalThreads - 1) / kGlobalThreads;
  for (int k = tile_log2 + 1; k <= m; ++k) {
    for (int j = k - 1; j >= tile_log2; --j) {
      global_pass_kernel<<<pass_blocks, kGlobalThreads, 0, stream>>>(
          keys, vals, pads, n_pairs, k, j);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    tile_sort_kernel<<<tiles, tile_threads, 0, stream>>>(
        keys, vals, pads, n_pad, keys, vals, pads, tile_log2, k, k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}
