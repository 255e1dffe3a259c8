// Near-field slot sweep seeded with the far-field local expansion, one
// thread per (cell, target slot).
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
// What bounds it on the H100: FP32 arithmetic and rsqrtf throughput over
// the live pairs (~27 x occupancy per live slot). The TPU kernel pads x,
// masks z wraps and sweeps every slot of a lane chunk; here a thread
// bounds-checks its neighbour cells in place and loops only over the
// live slots, so the cost tracks the real occupancy, not the k cap.
// Neighbouring threads own neighbouring z cells of one slot plane, so
// every source and target load of a warp is one coalesced row.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void tile_near_kernel(const float* __restrict__ tiles,
                                 const float* __restrict__ far, int n_far,
                                 const float* __restrict__ counts,
                                 const float* __restrict__ lo,
                                 const float* __restrict__ cellw,
                                 float* __restrict__ out, int d, int k,
                                 int ws, float eps2, float cutoff2,
                                 int use_cutoff) {
  const int d2 = d * d;
  const int yz = blockIdx.x * kThreads + threadIdx.x;
  if (yz >= d2) return;
  const int s = blockIdx.y;
  const int x = blockIdx.z;
  const int y = yz / d;
  const int z = yz - y * d;
  const size_t chs = static_cast<size_t>(k) * d2;  // channel stride
  float* o = out + static_cast<size_t>(x) * 3 * chs + static_cast<size_t>(s) * d2 + yz;

  const int live_t =
      counts ? min(static_cast<int>(counts[x * d2 + yz]), k) : k;
  if (s >= live_t) {
    o[0] = 0.f;
    o[chs] = 0.f;
    o[2 * chs] = 0.f;
    return;
  }
  const float* t = tiles + static_cast<size_t>(x) * 4 * chs + static_cast<size_t>(s) * d2 + yz;
  const float tx = t[0];
  const float ty = t[chs];
  const float tz = t[2 * chs];

  float ax = 0.f, ay = 0.f, az = 0.f;
  if (n_far > 0) {
    const float cw = cellw[0];
    // centre rounded without FMA contraction, as in scatter.cu
    const float dx = tx - __fadd_rn(lo[0], __fmul_rn(static_cast<float>(x) + 0.5f, cw));
    const float dy = ty - __fadd_rn(lo[1], __fmul_rn(static_cast<float>(y) + 0.5f, cw));
    const float dz = tz - __fadd_rn(lo[2], __fmul_rn(static_cast<float>(z) + 0.5f, cw));
    const float* f = far + static_cast<size_t>(x) * n_far * d2 + yz;
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

  for (int ox = -ws; ox <= ws; ++ox) {
    const int xs = x + ox;
    if (xs < 0 || xs >= d) continue;
    for (int oy = -ws; oy <= ws; ++oy) {
      const int ys = y + oy;
      if (ys < 0 || ys >= d) continue;
      for (int oz = -ws; oz <= ws; ++oz) {
        const int zs = z + oz;
        if (zs < 0 || zs >= d) continue;
        const int c2 = ys * d + zs;
        const int live_s =
            counts ? min(static_cast<int>(counts[xs * d2 + c2]), k) : k;
        const float* src = tiles + static_cast<size_t>(xs) * 4 * chs + c2;
        for (int j = 0; j < live_s; ++j) {
          const float* sj = src + static_cast<size_t>(j) * d2;
          const float dx = sj[0] - tx;
          const float dy = sj[chs] - ty;
          const float dz = sj[2 * chs] - tz;
          const float sm = sj[3 * chs];
          // rounded as the plain twin rounds it (no FMA contraction), so
          // both agree on every pair at the cutoff boundary
          const float r2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                               __fmul_rn(dy, dy)),
                                     __fmul_rn(dz, dz));
          if (r2 == 0.f || (use_cutoff && !(r2 <= cutoff2))) continue;
          const float inv = rsqrtf(r2 + eps2);
          const float w = sm * (inv * inv * inv);
          ax += w * dx;
          ay += w * dy;
          az += w * dz;
        }
      }
    }
  }
  o[0] = ax;
  o[chs] = ay;
  o[2 * chs] = az;
}

}  // namespace

extern "C" int nbt_tile_near(const float* tiles, const float* far, int n_far,
                             const float* counts, const float* lo,
                             const float* cellw, float* out, int d, int k,
                             int ws, float eps2, float cutoff2, int use_cutoff,
                             void* stream) {
  const dim3 grid((d * d + kThreads - 1) / kThreads, k, d);
  tile_near_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tiles, far, n_far, counts, lo, cellw, out, d, k, ws, eps2, cutoff2,
      use_cutoff);
  return static_cast<int>(cudaGetLastError());
}
