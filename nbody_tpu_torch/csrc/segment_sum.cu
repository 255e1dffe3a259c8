// Per-segment sums over rows sorted by destination, row-parallel.
//
// Replaces: nbody_tpu/ops/pallas_scatter.py, _segsum_kernel /
// monotone_segment_sum (the Barnes-Hut non-fused moments pass,
// barnes_hut._sorted_finest_moments). The TPU kernel builds a one-hot
// (dest x row) matrix per 128-aligned source window and sums on the MXU
// with a 3-way bf16 split, carrying dest ids as f32; here it is a
// segmented reduction over int32 ids.
//
// Input: vals (N, C) row-major, C <= 15; dest (N,) int32 destination per
// row, non-decreasing except for sentinel rows (dest >= 2^24) that may
// interleave and add nothing. Output out (C, num_dest): out[c, s] = sum of
// vals[r, c] over rows with dest == s (0 <= s < num_dest; rows with other
// ids add nothing).
//
// What bounds it on the H100: device memory. It reads vals and dest once
// and writes C x num_dest floats: at 1M rows x 4 channels into 262144
// segments ~20 MB in and 4 MB out, ~7 us at 3.35 TB/s. At that size a
// call's time is mostly the host's, so a call is two launches and nothing
// else (no memset): every segment, empty ones included, is written once by
// two kernels on the caller's stream; no float atomics (two calls are
// bit-identical):
//  1. segsum_chunks: one block per chunk of kChunk consecutive rows, each
//     thread kRows consecutive rows (float4 loads when C = 4). A sentinel
//     row takes the last real id before it in the chunk (the first real id
//     of the chunk if none) as its key and adds 0, so keys stay
//     non-decreasing. Each thread sums its runs in row order; a segmented
//     scan over the threads (fixed shuffle tree, then warps in order)
//     carries runs across threads. A run that lies inside the chunk and
//     touches neither of its ends is written straight to out; the chunk's
//     first and last run (one run if the chunk holds one key) go to a side
//     buffer as (key, partial sum). Ids between the chunk's first and last
//     key that it does not hold have no row anywhere: the block writes
//     their zeros.
//  2. segsum_join, one block per chunk: the chunk that holds a run's first
//     row adds, in chunk order, the partials of the chunks the run
//     continues into (skipping chunks with no real row) and writes the
//     sum; the block writes the zeros of the ids between the previous
//     chunk's last key and its first (and after the last key, for the last
//     chunk with a real row).

#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxChannels = 15;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;
constexpr int kChunk = kThreads * kRows;
constexpr int kJoinThreads = 128;
constexpr int kSentinel = 1 << 24;
// Key of a chunk with no real row: never a real id.
constexpr int kEmpty = kSentinel;

template <int C>
__device__ __forceinline__ void load_row(const float* __restrict__ vals,
                                         int r, float (&v)[C]) {
  if constexpr (C == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(vals) + r);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c)
      v[c] = __ldg(vals + static_cast<size_t>(r) * C + c);
  }
}

template <int C>
__device__ __forceinline__ void store_seg(float* __restrict__ out,
                                          int num_dest, int key,
                                          const float (&v)[C]) {
  if (key < 0 || key >= num_dest) return;
#pragma unroll
  for (int c = 0; c < C; ++c)
    out[static_cast<size_t>(c) * num_dest + key] = v[c];
}

template <int C>
__device__ __forceinline__ void zero_seg(float* __restrict__ out,
                                         int num_dest, int key) {
#pragma unroll
  for (int c = 0; c < C; ++c)
    out[static_cast<size_t>(c) * num_dest + key] = 0.f;
}

template <int C>
__global__ void __launch_bounds__(kThreads)
segsum_chunks(const float* __restrict__ vals, int n,
              const int* __restrict__ dest, int num_dest,
              float* __restrict__ out, int* __restrict__ part_key,
              float* __restrict__ part_sum) {
  __shared__ int s_keys[kChunk];
  __shared__ int s_max[kWarps], s_min[kWarps];
  __shared__ int s_flag[kWarps];
  __shared__ float s_tot[kWarps][C];
  __shared__ float s_scan[kThreads][C];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int chunk = blockIdx.x;
  const int r0 = chunk * kChunk + t * kRows;

  // Keys: real ids as they are, sentinel rows (and rows past n) resolved.
  int key[kRows];
  bool real[kRows];
  int first_real = INT_MAX, last_real = INT_MIN;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int r = r0 + k;
    key[k] = r < n ? __ldg(dest + r) : kSentinel;
    real[k] = key[k] < kSentinel;
    if (real[k]) {
      first_real = min(first_real, key[k]);
      last_real = key[k];
    }
  }
  // Exclusive max-scan of last_real over the threads (the last real id
  // before this thread) and the chunk's first real id.
  int incl = last_real;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl = max(incl, v);
  }
  int mn = first_real;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, off));
  if (lane == 31) s_max[warp] = incl;
  if (lane == 0) s_min[warp] = mn;
  __syncthreads();
  int before = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) before = INT_MIN;
  int chunk_first = INT_MAX;
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) before = max(before, s_max[w]);
    chunk_first = min(chunk_first, s_min[w]);
  }
  int env = before;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    if (real[k]) {
      env = key[k];
    } else {
      key[k] = env != INT_MIN ? env
               : (chunk_first != INT_MAX ? chunk_first : kEmpty);
    }
    s_keys[t * kRows + k] = key[k];
  }

  // This thread's runs, in row order: the first run's sum (fsum), the
  // last run's (run, when the thread holds more than one key); runs in
  // between are whole and not at a chunk end, so they are written now.
  const int fk = key[0], lk = key[kRows - 1];
  const bool single = fk == lk;
  float fsum[C], run[C];
#pragma unroll
  for (int c = 0; c < C; ++c) fsum[c] = run[c] = 0.f;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    if (real[k]) {
      float v[C];
      load_row<C>(vals, r0 + k, v);
#pragma unroll
      for (int c = 0; c < C; ++c) run[c] += v[c];
    }
    if (k < kRows - 1 && key[k + 1] != key[k]) {
      if (key[k] == fk) {
#pragma unroll
        for (int c = 0; c < C; ++c) fsum[c] = run[c];
      } else {
        store_seg<C>(out, num_dest, key[k], run);
      }
#pragma unroll
      for (int c = 0; c < C; ++c) run[c] = 0.f;
    }
  }
  if (single) {
#pragma unroll
    for (int c = 0; c < C; ++c) fsum[c] = run[c];
  }
  __syncthreads();
  const bool match = t > 0 && s_keys[t * kRows - 1] == fk;
  const bool cont_next = t < kThreads - 1 && s_keys[(t + 1) * kRows] == lk;

  // Segmented inclusive scan over threads of the sum of the run holding
  // each thread's last row: S_t = v_t + (single_t && match_t ? S_{t-1} : 0),
  // v_t (in run) the part of that run within the thread.
  float s[C];
#pragma unroll
  for (int c = 0; c < C; ++c) s[c] = run[c];
  int head = !(single && match);
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int h = __shfl_up_sync(0xffffffffu, head, off);
    float prev[C];
#pragma unroll
    for (int c = 0; c < C; ++c)
      prev[c] = __shfl_up_sync(0xffffffffu, s[c], off);
    if (lane >= off) {
      if (!head) {
#pragma unroll
        for (int c = 0; c < C; ++c) s[c] = prev[c] + s[c];
      }
      head |= h;
    }
  }
  if (lane == 31) {
    s_flag[warp] = head;
#pragma unroll
    for (int c = 0; c < C; ++c) s_tot[warp][c] = s[c];
  }
  __syncthreads();
  if (!head) {  // the run reaches back past this warp: add earlier warps
    float pre[C];
#pragma unroll
    for (int c = 0; c < C; ++c) pre[c] = 0.f;
    for (int w = 0; w < warp; ++w) {
#pragma unroll
      for (int c = 0; c < C; ++c)
        pre[c] = s_flag[w] ? s_tot[w][c] : pre[c] + s_tot[w][c];
    }
#pragma unroll
    for (int c = 0; c < C; ++c) s[c] = pre[c] + s[c];
  }
#pragma unroll
  for (int c = 0; c < C; ++c) s_scan[t][c] = s[c];
  __syncthreads();

  const int chunk_head = s_keys[0], chunk_tail = s_keys[kChunk - 1];
  int* pk = part_key + 2 * chunk;
  float* ps = part_sum + static_cast<size_t>(2 * chunk) * C;
  // The run of this thread's first row, if it ends here.
  if (!single || !cont_next) {
    float f[C];
#pragma unroll
    for (int c = 0; c < C; ++c)
      f[c] = (match ? s_scan[t - 1][c] : 0.f) + fsum[c];
    const bool at_head = fk == chunk_head;
    const bool at_tail = single && t == kThreads - 1;
    if (at_head) {
      pk[0] = fk;
#pragma unroll
      for (int c = 0; c < C; ++c) ps[c] = f[c];
    }
    if (at_tail) {
      pk[1] = fk;
#pragma unroll
      for (int c = 0; c < C; ++c) ps[C + c] = f[c];
    }
    if (!at_head && !at_tail) store_seg<C>(out, num_dest, fk, f);
  }
  // The run of this thread's last row, if it starts here and ends here.
  if (!single && !cont_next) {
    if (t == kThreads - 1) {
      pk[1] = lk;
#pragma unroll
      for (int c = 0; c < C; ++c) ps[C + c] = run[c];
    } else {
      store_seg<C>(out, num_dest, lk, run);
    }
  }

  // Zeros of the ids strictly between the chunk's first and last key that
  // no row of the chunk holds (a binary search in the sorted keys).
  if (chunk_head == kEmpty) return;
  const int z_end = min(chunk_tail, num_dest);
  for (int id = max(chunk_head + 1, 0) + t; id < z_end; id += kThreads) {
    int a = 0;  // the last key < id (one exists: s_keys[0] < id)
#pragma unroll
    for (int step = kChunk / 2; step > 0; step >>= 1)
      if (s_keys[a + step] < id) a += step;
    if (s_keys[a + 1] != id) zero_seg<C>(out, num_dest, id);
  }
}

template <int C>
__device__ void join_walk(const int* __restrict__ part_key,
                          const float* __restrict__ part_sum, int n_chunks,
                          int q, int key, float (&acc)[C]) {
  for (; q < n_chunks; ++q) {
    const int h = part_key[2 * q];
    if (h == kEmpty) continue;
    if (h != key) break;
#pragma unroll
    for (int c = 0; c < C; ++c)
      acc[c] += part_sum[static_cast<size_t>(2 * q) * C + c];
    if (part_key[2 * q + 1] != key) break;
  }
}

template <int C>
__global__ void __launch_bounds__(kJoinThreads)
segsum_join(const int* __restrict__ part_key,
            const float* __restrict__ part_sum, int n_chunks, int num_dest,
            float* __restrict__ out) {
  __shared__ int s_zero[4];  // two id ranges [lo, hi) to zero
  const int ch = blockIdx.x;
  if (threadIdx.x == 0) {
    int z[4] = {0, 0, 0, 0};
    const int hk = part_key[2 * ch], tk = part_key[2 * ch + 1];
    if (hk != kEmpty) {
      int p = ch - 1;
      while (p >= 0 && part_key[2 * p] == kEmpty) --p;
      const int prev_tail = p >= 0 ? part_key[2 * p + 1] : -1;
      const float* ps = part_sum + static_cast<size_t>(2 * ch) * C;
      float acc[C];
      if (p < 0 || prev_tail != hk) {  // the chunk holds its head run's start
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] = ps[c];
        if (hk == tk)
          join_walk<C>(part_key, part_sum, n_chunks, ch + 1, hk, acc);
        store_seg<C>(out, num_dest, hk, acc);
      }
      if (hk != tk) {  // and of its tail run
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] = ps[C + c];
        join_walk<C>(part_key, part_sum, n_chunks, ch + 1, tk, acc);
        store_seg<C>(out, num_dest, tk, acc);
      }
      // the gap before this chunk's first key (from id 0 for the first
      // chunk with a real row)
      z[0] = p >= 0 ? prev_tail + 1 : 0;
      z[1] = hk;
      int q = ch + 1;
      while (q < n_chunks && part_key[2 * q] == kEmpty) ++q;
      if (q == n_chunks) {  // the last chunk with a real row
        z[2] = tk + 1;
        z[3] = num_dest;
      }
    } else if (ch == 0) {
      int q = 0;
      while (q < n_chunks && part_key[2 * q] == kEmpty) ++q;
      if (q == n_chunks) z[1] = num_dest;  // no real row at all
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) s_zero[i] = z[i];
  }
  __syncthreads();
  for (int r = 0; r < 2; ++r) {
    const int hi = min(s_zero[2 * r + 1], num_dest);
    for (int id = max(s_zero[2 * r], 0) + threadIdx.x; id < hi;
         id += kJoinThreads)
      zero_seg<C>(out, num_dest, id);
  }
}

// The buffer the caller allocates, in floats: out (C, num_dest), then,
// 16-byte aligned, part_key (n_chunks, 2) int32 and part_sum (n_chunks, 2,
// C) float32.
long long buffer_floats(int C, int n, int num_dest) {
  const long long n_chunks = (static_cast<long long>(n) + kChunk - 1) / kChunk;
  const long long out = (static_cast<long long>(C) * num_dest + 3) / 4 * 4;
  return out + 2 * n_chunks + 2 * n_chunks * C;
}

}  // namespace

// The buffer nbt_segment_sum needs, in floats (the caller allocates it).
extern "C" long long nbt_segment_sum_buffer_floats(int C, int n,
                                                   int num_dest) {
  return buffer_floats(C, n, num_dest);
}

// Rows per chunk of segsum_chunks (for tests that place chunk edges).
extern "C" int nbt_segment_sum_chunk_rows() { return kChunk; }

// out: the start of a buffer of ``capacity`` >= buffer_floats(C, n,
// num_dest) floats.
extern "C" int nbt_segment_sum(const float* vals, int C, int n,
                               const int* dest, int num_dest, float* out,
                               long long capacity, void* stream) {
  if (C < 1 || C > kMaxChannels || n < 0 || num_dest < 0 ||
      num_dest > kSentinel || capacity < buffer_floats(C, n, num_dest))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_dest == 0) return static_cast<int>(cudaSuccess);
  if (n == 0) {  // no row: every segment is 0
    return static_cast<int>(cudaMemsetAsync(
        out, 0, sizeof(float) * static_cast<size_t>(C) * num_dest, s));
  }
  const size_t out_floats = (static_cast<size_t>(C) * num_dest + 3) / 4 * 4;
  const int n_chunks = (n + kChunk - 1) / kChunk;
  int* part_key = reinterpret_cast<int*>(out + out_floats);
  float* part_sum = out + out_floats + 2 * static_cast<size_t>(n_chunks);
  cudaError_t err;
  switch (C) {
#define NBT_SEGSUM_CASE(k)                                              \
  case k:                                                               \
    segsum_chunks<k><<<n_chunks, kThreads, 0, s>>>(                     \
        vals, n, dest, num_dest, out, part_key, part_sum);              \
    err = cudaGetLastError();                                           \
    if (err != cudaSuccess) return static_cast<int>(err);               \
    segsum_join<k><<<n_chunks, kJoinThreads, 0, s>>>(                   \
        part_key, part_sum, n_chunks, num_dest, out);                   \
    return static_cast<int>(cudaGetLastError());
    NBT_SEGSUM_CASE(1) NBT_SEGSUM_CASE(2) NBT_SEGSUM_CASE(3)
    NBT_SEGSUM_CASE(4) NBT_SEGSUM_CASE(5) NBT_SEGSUM_CASE(6)
    NBT_SEGSUM_CASE(7) NBT_SEGSUM_CASE(8) NBT_SEGSUM_CASE(9)
    NBT_SEGSUM_CASE(10) NBT_SEGSUM_CASE(11) NBT_SEGSUM_CASE(12)
    NBT_SEGSUM_CASE(13) NBT_SEGSUM_CASE(14) NBT_SEGSUM_CASE(15)
#undef NBT_SEGSUM_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
