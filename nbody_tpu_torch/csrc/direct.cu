// Direct O(N^2) softened gravity, four targets a thread, the source axis
// split across blocks when the targets alone leave SMs idle.
//
// Replaces: nbody_tpu/ops/direct.py, _direct_kernel / direct_forces_pallas
// (the (i, j)-tiled VMEM kernel).
//
// Computes a_i = G * sum_j m_j (x_j - x_i) / (|x_j - x_i|^2 + eps^2)^{3/2}
// in the displacement form; a coincident pair (raw r^2 == 0, including the
// self pair) contributes exactly zero. Targets may be a subset of the
// sources (the Barnes-Hut ground truth samples targets against all rows).
//
// What bounds it on the H100: FP32 issue. A pair costs 13 instructions
// (3 FADD, 3 FFMA for r^2 + eps^2, one MUFU rsqrt, 3 FMUL, 3 FFMA; the
// unrolled loop issues 13.5 with its shared-memory load and branch), which
// the bound counts as 20 operations; device memory traffic is small.
// Design:
//  * a block of 256 threads takes 1024 targets, four a thread, so every
//    source it stages as float4 (x, y, z, m) in shared memory (a broadcast
//    read) feeds four pairs; the source loop is unrolled 8 times;
//  * the sources are split into ranges of whole 256-row tiles, one per
//    blockIdx.y, planned from the SM count and the blocks an SM holds
//    (plan() below) so that every SM has the same work and holds as many
//    blocks as it can (4096 targets are 4 target blocks: without the split
//    128 of 132 SMs would sit idle); each block writes its partial sums,
//    and a second kernel adds them in range order and applies G. No
//    atomics, so two calls give bit-identical output;
//  * with eps2 >= kLeanEps2 the pair loop folds eps2 into the FMA chain of
//    r^2, uses rsqrt.approx.ftz (r^2 + eps2 is never denormal) and has no
//    r^2 == 0 select: a coincident pair has dx = dy = dz = 0 and adds
//    exactly 0, since its weight m / eps^3 <= m * 1e18 is finite for any
//    mass below 3e20. Below kLeanEps2 the loop keeps rsqrtf and the select
//    (the self pair would give 0 * inf). With no cutoff, FMA contraction
//    only moves r^2 by an ulp.
// On an H100 the lean loop takes 0.76x the time of the other
// (scripts/profile_tile_near_torch.py); two targets a thread, eight,
// 128-thread blocks, an unroll of 4 or 16, or splits held to one wave were
// each slower at some shape the paths use (PERF.md).

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kPer = 4;                       // targets a thread
constexpr int kTargets = kBlock * kPer;       // targets a block
constexpr int kTile = kBlock;                 // sources staged a step
constexpr int kWaves = 16;                    // most waves a split may take
constexpr int kUnroll = 8;                    // of the source loop
// The least eps^2 of the lean pair loop (eps >= 1e-6).
constexpr float kLeanEps2 = 1e-12f;

template <bool kSoft>
__global__ void __launch_bounds__(kBlock)
direct_forces_kernel(const float* __restrict__ tgt, int nt,
                     const float* __restrict__ spos,
                     const float* __restrict__ smass, int ns, int range,
                     float G, float eps2, float* __restrict__ out) {
  __shared__ float4 tile[kTile];
  const int i0 = blockIdx.x * kTargets + threadIdx.x;
  float px[kPer], py[kPer], pz[kPer], ax[kPer], ay[kPer], az[kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int i = i0 + r * kBlock;
    px[r] = i < nt ? tgt[3 * i] : 0.f;
    py[r] = i < nt ? tgt[3 * i + 1] : 0.f;
    pz[r] = i < nt ? tgt[3 * i + 2] : 0.f;
    ax[r] = ay[r] = az[r] = 0.f;
  }
  const int part = blockIdx.y;
  const int j_end = min(ns, (part + 1) * range);
  for (int base = part * range; base < j_end; base += kTile) {
    const int j = base + threadIdx.x;
    tile[threadIdx.x] =
        j < j_end ? make_float4(spos[3 * j], spos[3 * j + 1],
                                spos[3 * j + 2], smass[j])
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
    const int cnt = min(kTile, j_end - base);
#pragma unroll kUnroll
    for (int jj = 0; jj < cnt; ++jj) {
      const float4 s = tile[jj];
#pragma unroll
      for (int r = 0; r < kPer; ++r) {
        const float dx = s.x - px[r];
        const float dy = s.y - py[r];
        const float dz = s.z - pz[r];
        float w;
        if (kSoft) {
          const float r2e = fmaf(dx, dx, fmaf(dy, dy, fmaf(dz, dz, eps2)));
          float inv;
          asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(inv) : "f"(r2e));
          w = (s.w * inv) * (inv * inv);
        } else {
          const float r2 = fmaf(dx, dx, fmaf(dy, dy, dz * dz));
          const float inv = rsqrtf(r2 + eps2);
          w = r2 == 0.f ? 0.f : s.w * (inv * inv * inv);
        }
        ax[r] = fmaf(w, dx, ax[r]);
        ay[r] = fmaf(w, dy, ay[r]);
        az[r] = fmaf(w, dz, az[r]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int i = i0 + r * kBlock;
    if (i >= nt) continue;
    if (gridDim.y == 1) {
      out[3 * i] = G * ax[r];
      out[3 * i + 1] = G * ay[r];
      out[3 * i + 2] = G * az[r];
    } else {  // partial (range, component, target)
      float* p = out + static_cast<size_t>(part) * 3 * nt + i;
      p[0] = ax[r];
      p[nt] = ay[r];
      p[2 * static_cast<size_t>(nt)] = az[r];
    }
  }
}

// acc[i][c] = G * sum over ranges, in range order, of partial[s][c][i].
__global__ void direct_forces_join(const float* __restrict__ partial,
                                   int n_ranges, int nt, float G,
                                   float* __restrict__ acc) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;  // c * nt + i
  if (e >= 3 * nt) return;
  float sum = 0.f;
  for (int s = 0; s < n_ranges; ++s)
    sum += partial[static_cast<size_t>(s) * 3 * nt + e];
  const int c = e / nt;
  acc[3 * (e - c * nt) + c] = G * sum;
}

// Source range for (nt, ns) on `device`, in rows, a whole number of tiles.
// All blocks have the same work, so the call takes as long as the SM given
// the most blocks: tile time ~ ceil(blocks / SMs) * tiles a range. The plan
// finds the least of that over the splits that fit kWaves waves of blocks,
// then takes, of the splits within 2 % of it, the fewest blocks that fill
// one wave (so every SM holds as many blocks as it can, with the fewest
// partial sums), or if none fills one, the most blocks. A range that holds
// every source means no split.
cudaError_t plan(int device, int nt, int ns, int* range) {
  static int sms_of[64] = {}, wave_of[64] = {};  // per device
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (wave_of[device] == 0) {
    int sms = 0, per_sm = 0;
    cudaError_t err = cudaDeviceGetAttribute(
        &sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, direct_forces_kernel<true>, kBlock, 0);
    if (err != cudaSuccess) return err;
    sms_of[device] = max(sms, 1);
    wave_of[device] = sms_of[device] * max(per_sm, 1);
  }
  const long long sms = sms_of[device], wave = wave_of[device];
  const long long tblocks = (max(nt, 1) + kTargets - 1) / kTargets;
  const int tiles = max((ns + kTile - 1) / kTile, 1);
  *range = tiles * kTile;
  if (tiles == 1 || tblocks * 2 > wave * kWaves) return cudaSuccess;
  auto cost = [&](int n, int per) {
    return (tblocks * n + sms - 1) / sms * per;
  };
  const int most = static_cast<int>(
      min(wave * kWaves / tblocks, static_cast<long long>(tiles)));
  long long best = cost(1, tiles);
  for (int want = 2; want <= most; ++want) {
    const int per = (tiles + want - 1) / want;
    best = min(best, cost((tiles + per - 1) / per, per));
  }
  int pick = 0;  // ranges of the chosen split
  for (int want = 1; want <= most; ++want) {
    const int per = (tiles + want - 1) / want;
    const int n = (tiles + per - 1) / per;
    if (n != want || cost(n, per) * 100 > best * 102) continue;
    const bool fills = tblocks * n >= wave;
    if (fills || pick == 0 || tblocks * pick < wave) pick = n;
    if (fills) break;
  }
  *range = (tiles + pick - 1) / pick * kTile;
  return cudaSuccess;
}

}  // namespace

// Rows of each source range nbt_direct_forces should take for (nt, ns) on
// `device` (plan() above), or -1 on a CUDA error. With R = ceil(ns / range)
// ranges above 1, the call needs 3 * R * nt floats of scratch.
extern "C" int nbt_direct_forces_range(int device, int nt, int ns) {
  int range = 0;
  return plan(device, nt, ns, &range) == cudaSuccess ? range : -1;
}

extern "C" int nbt_direct_forces(const float* tgt, int nt, const float* spos,
                                 const float* smass, int ns, int range,
                                 float G, float eps2, float* acc,
                                 float* scratch, long long scratch_floats,
                                 void* stream) {
  if (nt <= 0) return static_cast<int>(cudaGetLastError());
  if (range < kTile || range % kTile != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_ranges = ns > range ? (ns + range - 1) / range : 1;
  if (n_ranges > 1 && scratch_floats < 3LL * n_ranges * nt) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((nt + kTargets - 1) / kTargets, n_ranges);
  float* out = n_ranges > 1 ? scratch : acc;
  if (eps2 >= kLeanEps2) {
    direct_forces_kernel<true><<<grid, kBlock, 0, s>>>(
        tgt, nt, spos, smass, ns, range, G, eps2, out);
  } else {
    direct_forces_kernel<false><<<grid, kBlock, 0, s>>>(
        tgt, nt, spos, smass, ns, range, G, eps2, out);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_ranges == 1) return static_cast<int>(err);
  direct_forces_join<<<(3 * nt + 255) / 256, 256, 0, s>>>(scratch, n_ranges,
                                                          nt, G, acc);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nbt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
