// Table-resident stepping's elementwise passes over the slot tables: the
// drift (with the pre-force audit on request) and the kick.
//
// Replaces: no TPU kernel. On the TPU these passes are XLA fusions of
// nbody_tpu/ops/table_step.py (_drift, _movers, and the tail of
// _frozen_force_and_kick); eager PyTorch runs each of their ~30 operations
// as a pass of its own over the whole table, which costs more than the
// placement and pickup the table saves (a frozen step of the 1M sparse
// hash: 1.104 busy ms against 0.950 in row space).
//
// Layout: the sweep's plane-major slot tables (d, C, k, d^2): pos (C = 4,
// [x, y, z, m]), vel and acc (C = 3), cov (C = 1, 1.0 where a row lives).
// A thread owns one slot (x, r, yz), t = (x*k + r)*d^2 + yz, so a warp's
// loads and stores are coalesced rows of each plane.
//
// Drift (nbt_table_drift): pos_d = pos + vel*dt + (dt^2/2)*acc, the mass
// copied; vel_h = vel + (dt/2)*acc; with the audit, mover[t] = the slot's
// cell under the frozen binning of its drifted position when the slot is
// occupied and that cell is not its own, else -1, and *n_stale += the
// number of such slots. Each operation is rounded as eager PyTorch rounds
// it (no FMA contraction), so the kernel is bit-equal to its plain twin and
// to the row-space stepper's arithmetic; the binning is each engine's own:
// truncation of (v - lo) / cell for Barnes-Hut (cell a device scalar, a
// true division), floor of (v - lo) * (1 / cell_size) for the hash (PyTorch
// divides by a host scalar as a product with its f32 reciprocal).
//
// Kick (nbt_table_kick), in place: acc = G * (cov * raw) (empty slots
// masked to 0), vel = vel_h + (dt/2)*acc.
//
// What bounds it on the H100: device memory. The drift reads 10 channels
// (11 with the audit) and writes 7 (8): 68-76 B a slot, 0.21-0.32 GB at
// d = 64, k = 16 (4.2M slots), ~0.06-0.1 ms at 3.35 TB/s; the kick reads 7
// and writes 6 channels, 52 B a slot. Design: one pass each; the stale
// count is summed per warp (ballot + popc) before one atomicAdd of an
// integer, so it is exact and deterministic.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

enum Bin { kNoAudit = 0, kTrunc = 1, kFloor = 2 };

template <int kBin>
__device__ __forceinline__ int coord(float v, float lo, float cell, float inv,
                                     int d) {
  int c;
  if constexpr (kBin == kTrunc) {
    c = static_cast<int>(__fdiv_rn(__fsub_rn(v, lo), cell));
  } else {
    c = static_cast<int>(floorf(__fmul_rn(__fsub_rn(v, lo), inv)));
  }
  return min(max(c, 0), d - 1);
}

template <int kBin>
__global__ void table_drift_kernel(
    const float* __restrict__ pos, const float* __restrict__ vel,
    const float* __restrict__ acc, const float* __restrict__ cov,
    const float* __restrict__ lo, const float* __restrict__ cellw,
    float inv_cell, int d, int k, float dt, float c2, float hdt,
    float* __restrict__ pos_d, float* __restrict__ vel_h,
    int* __restrict__ mover, int* __restrict__ n_stale) {
  const int d2 = d * d;
  const int total = d2 * d * k;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = t < total;
  bool stale = false;
  if (in) {
    const int yz = t % d2;
    const int xr = t / d2;
    const int r = xr % k;
    const int x = xr / k;
    const size_t chs = static_cast<size_t>(k) * d2;
    const size_t off = static_cast<size_t>(r) * d2 + yz;
    const size_t p4 = static_cast<size_t>(x) * 4 * chs + off;
    const size_t p3 = static_cast<size_t>(x) * 3 * chs + off;
    float q[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float a = acc[p3 + c * chs];
      const float v = vel[p3 + c * chs];
      q[c] = __fadd_rn(__fadd_rn(pos[p4 + c * chs], __fmul_rn(v, dt)),
                       __fmul_rn(a, c2));
      pos_d[p4 + c * chs] = q[c];
      vel_h[p3 + c * chs] = __fadd_rn(v, __fmul_rn(a, hdt));
    }
    pos_d[p4 + 3 * chs] = pos[p4 + 3 * chs];
    if constexpr (kBin != kNoAudit) {
      const float cw = cellw[0];
      const int id = (coord<kBin>(q[0], lo[0], cw, inv_cell, d) * d +
                      coord<kBin>(q[1], lo[1], cw, inv_cell, d)) * d +
                     coord<kBin>(q[2], lo[2], cw, inv_cell, d);
      stale = id != x * d2 + yz && cov[static_cast<size_t>(x) * chs + off] > 0.f;
      mover[t] = stale ? id : -1;
    }
  }
  if constexpr (kBin != kNoAudit) {
    const unsigned b = __ballot_sync(0xffffffffu, stale);
    if ((threadIdx.x & 31) == 0 && b) atomicAdd(n_stale, __popc(b));
  }
}

__global__ void table_kick_kernel(float* __restrict__ acc,
                                  const float* __restrict__ cov,
                                  float* __restrict__ vel, float G, float hdt,
                                  int d, int k) {
  const int d2 = d * d;
  const int total = d2 * d * k;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int yz = t % d2;
  const int xr = t / d2;
  const int r = xr % k;
  const int x = xr / k;
  const size_t chs = static_cast<size_t>(k) * d2;
  const size_t off = static_cast<size_t>(r) * d2 + yz;
  const size_t p3 = static_cast<size_t>(x) * 3 * chs + off;
  const float m = cov[static_cast<size_t>(x) * chs + off];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float a = __fmul_rn(__fmul_rn(m, acc[p3 + c * chs]), G);
    acc[p3 + c * chs] = a;
    vel[p3 + c * chs] = __fadd_rn(vel[p3 + c * chs], __fmul_rn(a, hdt));
  }
}

template <int kBin>
void launch_drift(const float* pos, const float* vel, const float* acc,
                  const float* cov, const float* lo, const float* cellw,
                  float inv_cell, int d, int k, float dt, float c2, float hdt,
                  float* pos_d, float* vel_h, int* mover, int* n_stale,
                  cudaStream_t stream) {
  const int total = d * d * d * k;
  table_drift_kernel<kBin><<<(total + kThreads - 1) / kThreads, kThreads, 0,
                             stream>>>(pos, vel, acc, cov, lo, cellw,
                                       inv_cell, d, k, dt, c2, hdt, pos_d,
                                       vel_h, mover, n_stale);
}

}  // namespace

// bin: 0 no audit (mover, n_stale, cov unused), 1 Barnes-Hut truncation,
// 2 hash floor. n_stale (one int32) is zeroed here before the launch.
extern "C" int nbt_table_drift(const float* pos, const float* vel,
                               const float* acc, const float* cov,
                               const float* lo, const float* cellw,
                               float inv_cell, int bin, int d, int k, float dt,
                               float c2, float hdt, float* pos_d, float* vel_h,
                               int* mover, int* n_stale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bin != kNoAudit) {
    const cudaError_t err = cudaMemsetAsync(n_stale, 0, sizeof(int), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  switch (bin) {
    case kNoAudit:
      launch_drift<kNoAudit>(pos, vel, acc, cov, lo, cellw, inv_cell, d, k,
                             dt, c2, hdt, pos_d, vel_h, mover, n_stale, s);
      break;
    case kTrunc:
      launch_drift<kTrunc>(pos, vel, acc, cov, lo, cellw, inv_cell, d, k, dt,
                           c2, hdt, pos_d, vel_h, mover, n_stale, s);
      break;
    case kFloor:
      launch_drift<kFloor>(pos, vel, acc, cov, lo, cellw, inv_cell, d, k, dt,
                           c2, hdt, pos_d, vel_h, mover, n_stale, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// In place: acc (the sweep's raw output) becomes G * cov * raw, vel (the
// half-kicked velocities) gets the second half-kick.
extern "C" int nbt_table_kick(float* acc, const float* cov, float* vel,
                              float G, float hdt, int d, int k, void* stream) {
  const int total = d * d * d * k;
  table_kick_kernel<<<(total + kThreads - 1) / kThreads, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(acc, cov, vel, G,
                                                           hdt, d, k);
  return static_cast<int>(cudaGetLastError());
}
