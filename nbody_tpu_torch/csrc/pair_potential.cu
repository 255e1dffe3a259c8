// All-pairs softened potential energy over a balanced walk of tile pairs.
//
// Replaces: nbody_tpu/ops/direct.py, _pe_kernel / pairwise_potential_pallas
// (1024 x 1024 VMEM tiles, a Kahan sum carried in (1, 1) output refs across
// the sequential j grid, (8, 128) output blocks for Mosaic's tiling).
//
// Main form (nbt_pair_potential): each unordered pair once,
//   sum_{i < j} m_i * m_j / sqrt(r_ij^2 + eps^2),
// as float64 partials, one per block; the wrapper adds them (float64) and
// applies -G. Cross form (nbt_pair_potential_cross; the ring energy of
// nbody_tpu/parallel/step.py, sharded_energy, which the JAX package leaves
// to XLA): targets (tpos, tmass) against a separate source set (spos,
// smass), all pairs, sum_i m_i * sum_j m_j / sqrt(r_ij^2 + eps^2), the same
// float64 partials; its wrapper applies -G/2.
// A pair with raw r^2 == 0 (coincident, or a row with itself) is excluded,
// tested BEFORE eps^2 is added; r^2 is rounded step by step
// (dx^2 + dy^2) + dz^2 with no FMA contraction, as the plain twin rounds
// it, so both exclude the same pairs.
//
// What bounds it on the H100: FP32 issue. A pair costs about 12
// instructions (3 FADD for the displacement, 3 FMUL + 2 FADD for r^2, one
// FADD for eps^2, one MUFU rsqrt, the r^2 == 0 compare and a predicated
// FFMA into the sum), which the bound counts as 20 operations; the MUFU's
// 16 rsqrt a clock an SM is not the limit (an SM issues 128 lanes a clock,
// ~10.7 pairs). Device memory traffic is ~16 bytes a row. Design:
//  * rows are cut into 256-row tiles; the main form walks only the upper
//    triangle of tile pairs (I <= J), row-major: off-diagonal pairs take
//    all 256 x 256 pairs, a diagonal pair only j > i; the cross form walks
//    all nt_tiles x ns_tiles pairs;
//  * that walk is cut into runs of `run` consecutive tile pairs, one run a
//    block, `run` planned here from the SM count and the blocks an SM
//    holds so that one wave of equal runs fills the card at every N (plan()
//    below; the caller asks nbt_pair_potential_partials for the number of
//    partials; ops/direct.py pair_tile_schedule mirrors the walk for the
//    CPU tests);
//  * a block of 64 threads holds 4 targets a thread in registers for as
//    long as its run stays in one tile row, and stages each source tile as
//    float4 (x, y, z, m) in shared memory: one broadcast load feeds 4 pairs;
//  * each target's terms over one source tile (<= 256) are summed in
//    float32, then added to a float64 register; when the run leaves a tile
//    row the thread adds m_i * row_i (float64) to its total; the block
//    reduces its totals in a fixed order and writes one double. No float
//    atomics, so two calls are bit-equal;
//  * with eps2 >= kLeanEps2 the rsqrt is rsqrt.approx.ftz: r^2 + eps2 is
//    then never denormal, and on a normal input it runs the same MUFU
//    rsqrt as rsqrtf, whose denormal test and two predicated scalings
//    (and the registers they hold) cost ~1.4x in device time (1M drift
//    input, scripts/profile_tile_near_torch.py --k5-baseline). Below it
//    rsqrtf, which takes a denormal r^2 (eps = 0, a pair ~1e-20 apart).
// r^2 stays on the FP32 pipes: |x_i|^2 + |x_j|^2 - 2 x_i.x_j on the tensor
// cores cancels at close pairs and cannot see raw r^2 == 0.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 64;                  // a block
constexpr int kPer = 4;                       // targets a thread
constexpr int kTile = kThreads * kPer;        // rows a tile (both axes)
constexpr int kUnroll = 8;                    // of the source loop
constexpr int kMinBlocks = 16;                // resident a SM (<= 64 regs)
// The least eps^2 of the ftz rsqrt (eps >= 1e-6).
constexpr float kLeanEps2 = 1e-12f;

__host__ __device__ inline long long tiles_of(int n) {
  return (static_cast<long long>(n) + kTile - 1) / kTile;
}

// Tile pairs of the main form's upper triangle before tile row I.
__host__ __device__ inline long long row_start(long long I, long long nt) {
  return I * nt - I * (I - 1) / 2;
}

// The tile row holding flat index k of the main form's triangle walk:
// the root of row_start(I) = k, then corrected by whole rows.
__device__ inline long long tile_row(long long k, long long nt) {
  const double b = 2.0 * static_cast<double>(nt) + 1.0;
  long long I = static_cast<long long>(
      floor((b - sqrt(b * b - 8.0 * static_cast<double>(k))) * 0.5));
  I = max(0LL, min(I, nt - 1));
  while (I > 0 && row_start(I, nt) > k) --I;
  while (I + 1 < nt && row_start(I + 1, nt) <= k) ++I;
  return I;
}

__device__ inline void load_targets(const float* __restrict__ pos,
                                    const float* __restrict__ mass, int n,
                                    long long I, float (&px)[kPer],
                                    float (&py)[kPer], float (&pz)[kPer],
                                    float (&pm)[kPer]) {
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const long long i = I * kTile + threadIdx.x + r * kThreads;
    const bool in = i < n;
    px[r] = in ? pos[3 * i] : 0.f;
    py[r] = in ? pos[3 * i + 1] : 0.f;
    pz[r] = in ? pos[3 * i + 2] : 0.f;
    pm[r] = in ? mass[i] : 0.f;  // rows past n carry no energy
  }
}

// Adds each target's sum over the staged tile to row[r]. kDiag: the tile
// pair is on the diagonal, so only sources after the target count.
template <bool kLean, bool kDiag>
__device__ __forceinline__ void sweep(const float4* tile, const float (&px)[kPer],
                                      const float (&py)[kPer],
                                      const float (&pz)[kPer], float eps2,
                                      double (&row)[kPer]) {
  float part[kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r) part[r] = 0.f;
#pragma unroll kUnroll
  for (int jj = 0; jj < kTile; ++jj) {
    const float4 s = tile[jj];
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const float dx = s.x - px[r];
      const float dy = s.y - py[r];
      const float dz = s.z - pz[r];
      const float r2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      float inv;
      if (kLean) {
        asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(inv) : "f"(r2 + eps2));
      } else {
        inv = rsqrtf(r2 + eps2);
      }
      bool keep = r2 != 0.f;  // self / coincident pair excluded
      if (kDiag) keep = keep && jj > static_cast<int>(threadIdx.x) + r * kThreads;
      if (keep) part[r] = fmaf(s.w, inv, part[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < kPer; ++r) row[r] += static_cast<double>(part[r]);
}

// One run of `run` tile pairs a block; block b takes flat indices
// [b * run, min((b + 1) * run, total)) of the walk. kCross: the targets'
// tiles against all source tiles, row-major; otherwise the upper triangle
// of the one set's tiles.
template <bool kLean, bool kCross>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
pair_potential_kernel(const float* __restrict__ tpos,
                      const float* __restrict__ tmass, int nt,
                      const float* __restrict__ spos,
                      const float* __restrict__ smass, int ns, float eps2,
                      long long run, long long total,
                      double* __restrict__ partial) {
  __shared__ float4 tile[kTile];
  __shared__ double warp_sum[kThreads / 32];
  const long long nti = tiles_of(nt), nts = tiles_of(ns);
  long long k = static_cast<long long>(blockIdx.x) * run;
  const long long end = min(k + run, total);
  long long I, J;
  if (kCross) {
    I = k / nts;
    J = k - I * nts;
  } else {
    I = tile_row(k, nti);
    J = I + (k - row_start(I, nti));
  }
  float px[kPer], py[kPer], pz[kPer], pm[kPer];
  double row[kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r) row[r] = 0.0;
  load_targets(tpos, tmass, nt, I, px, py, pz, pm);
  double acc = 0.0;
  for (; k < end; ++k) {
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int c = threadIdx.x + q * kThreads;
      const long long j = J * kTile + c;
      tile[c] = j < ns ? make_float4(spos[3 * j], spos[3 * j + 1],
                                     spos[3 * j + 2], smass[j])
                       : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
    if (!kCross && I == J) {
      sweep<kLean, true>(tile, px, py, pz, eps2, row);
    } else {
      sweep<kLean, false>(tile, px, py, pz, eps2, row);
    }
    __syncthreads();
    if (++J == nts) {  // the run leaves tile row I
#pragma unroll
      for (int r = 0; r < kPer; ++r) {
        acc += static_cast<double>(pm[r]) * row[r];
        row[r] = 0.0;
      }
      ++I;
      J = kCross ? 0 : I;
      if (k + 1 < end) load_targets(tpos, tmass, nt, I, px, py, pz, pm);
    }
  }
#pragma unroll
  for (int r = 0; r < kPer; ++r) acc += static_cast<double>(pm[r]) * row[r];
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  }
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    double v = warp_sum[0];
    for (int w = 1; w < kThreads / 32; ++w) v += warp_sum[w];
    partial[blockIdx.x] = v;
  }
}

long long total_pairs(int nt, int ns, bool cross) {
  const long long a = tiles_of(nt);
  return cross ? a * tiles_of(ns) : a * (a + 1) / 2;
}

// Blocks of a call on `device` (one partial each) and the tile pairs each
// walks, out of `total`: one wave of resident blocks (the SM count times
// the blocks an SM holds of the instance that fits fewest), each taking an
// equal run, so the card fills at every N; the last block's run is the
// remainder.
cudaError_t plan(int device, long long total, long long* run,
                 long long* blocks) {
  static int wave_of[64] = {};  // per device
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (wave_of[device] == 0) {
    int sms = 0;
    cudaError_t err = cudaDeviceGetAttribute(
        &sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    const void* kernels[] = {
        reinterpret_cast<const void*>(pair_potential_kernel<true, false>),
        reinterpret_cast<const void*>(pair_potential_kernel<false, false>),
        reinterpret_cast<const void*>(pair_potential_kernel<true, true>),
        reinterpret_cast<const void*>(pair_potential_kernel<false, true>)};
    int per_sm = 1 << 30;
    for (const void* f : kernels) {
      int b = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, f, kThreads, 0);
      if (err != cudaSuccess) return err;
      per_sm = min(per_sm, b);
    }
    wave_of[device] = max(sms, 1) * max(per_sm, 1);
  }
  *run = max(1LL, (total + wave_of[device] - 1) / wave_of[device]);
  *blocks = (total + *run - 1) / *run;
  return cudaSuccess;
}

// `partials`: the doubles at `partial`, which must be the plan's blocks
// (nbt_pair_potential_partials).
template <bool kCross>
int launch(const float* tpos, const float* tmass, int nt, const float* spos,
           const float* smass, int ns, float eps2, double* partial,
           long long partials, void* stream) {
  if (nt <= 0 || ns <= 0) {
    return static_cast<int>(partials == 0 ? cudaGetLastError()
                                          : cudaErrorInvalidValue);
  }
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = total_pairs(nt, ns, kCross);
  long long run = 0, blocks = 0;
  err = plan(device, total, &run, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (partials != blocks || blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned grid = static_cast<unsigned>(blocks);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (eps2 >= kLeanEps2) {
    pair_potential_kernel<true, kCross><<<grid, kThreads, 0, s>>>(
        tpos, tmass, nt, spos, smass, ns, eps2, run, total, partial);
  } else {
    pair_potential_kernel<false, kCross><<<grid, kThreads, 0, s>>>(
        tpos, tmass, nt, spos, smass, ns, eps2, run, total, partial);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Float64 partials (one a block) a call on `device` writes: the main form
// over nt rows (cross == 0, ns unused) or nt targets against ns sources;
// 0 for no rows, -1 on a CUDA error.
extern "C" long long nbt_pair_potential_partials(int device, int nt, int ns,
                                                 int cross) {
  if (nt <= 0 || (cross && ns <= 0)) return 0;
  long long run = 0, blocks = 0;
  const cudaError_t err =
      plan(device, total_pairs(nt, cross ? ns : nt, cross != 0), &run,
           &blocks);
  return err == cudaSuccess ? blocks : -1;
}

// Partials of the main form over (pos, mass, n).
extern "C" int nbt_pair_potential(const float* pos, const float* mass, int n,
                                  float eps2, double* partial,
                                  long long partials, void* stream) {
  return launch<false>(pos, mass, n, pos, mass, n, eps2, partial, partials,
                       stream);
}

// Partials of targets (tpos, tmass, nt) against sources (spos, smass, ns).
extern "C" int nbt_pair_potential_cross(const float* tpos, const float* tmass,
                                        int nt, const float* spos,
                                        const float* smass, int ns,
                                        float eps2, double* partial,
                                        long long partials, void* stream) {
  return launch<true>(tpos, tmass, nt, spos, smass, ns, eps2, partial,
                      partials, stream);
}
