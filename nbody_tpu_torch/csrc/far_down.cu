// The order-2 far field's downward pass: each pyramid level's accepted
// local expansions, translated down to the finest cells, as the sweep's
// far plane.
//
// Replaces no TPU kernel: the XLA ops of the level loop of
// nbody_tpu/ops/barnes_hut.py far_field_grid (to_grid, rep8, the
// sym_matvec / sym3_matvec translations and the adds), which the port ran
// as ~450 torch operations a force evaluation, and far_plane_grid's final
// cat / permute / contiguous.
//
// Input: the L levels' outputs of kernel K3 as far_taps writes them,
// (152, p^3) each with p = 2^(l-1): row = kid*19 + channel, kid = 4kx +
// 2ky + kz the target child, channel [A3 | J6 | H10], column = the parent
// cell (qx*p + qy)*p + qz. `cell` is the finest cell edge, read on the
// device (a 0-d tensor of the captured step). Output: the far plane
// (d, 19, d^2), d = 2^L, plane[x, c, y*d + z] the unscaled expansion of
// finest cell (x, y, z) about its centre.
//
// Per finest cell, from its level-1 ancestor's (A, J, H) down through its
// ancestors, with delta = (parity of the level-l ancestor - 1/2) * s_l,
// s_l = cell * 2^(L-l) that ancestor's edge:
//   A <- (A_l + A) + J.delta, then + 0.5 * (H.delta).delta
//   J <- (J_l + J) + H.delta
//   H <- H_l + H
// in the order and with the roundings of the torch composition
// (ops/far_down.down_pass): every product and sum rounded once, none
// contracted into an FMA (__fmul_rn / __fadd_rn), and delta and s_l exact
// (powers of two times cell). So the plane is the composition's bit for
// bit.
//
// What bounds it on the H100: bytes. At d = 64 (L = 6) it reads the finest
// level's K3 output once (20 MB) and writes the plane once (20 MB): 12 us
// at 3.35 TB/s; the coarser levels (2.9 MB together) stay in L2. Design:
// one thread per finest cell, z fastest, so a warp's stores of one channel
// are one run of 32 floats and its loads of the finest level two runs of
// 16 (kz = 0 and 1) in whole sectors; the expansion lives in 19 registers
// through the levels, and no shared memory is needed.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxLevels = 10;
constexpr int kThreads = 256;
constexpr int kChannels = 19;

struct Levels {
  const float* out[kMaxLevels];  // level l at out[l - 1]
};

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}

__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}

// (a*v0 + b*v1) + c*v2: the order of torch's expression
__device__ __forceinline__ float dot3(float a, float b, float c,
                                      const float v[3]) {
  return add(add(mul(a, v[0]), mul(b, v[1])), mul(c, v[2]));
}

// symmetric [xx, yy, zz, xy, xz, yz] times v (barnes_hut.sym_matvec)
__device__ __forceinline__ void sym_matvec(const float j[6], const float v[3],
                                           float out[3]) {
  out[0] = dot3(j[0], j[3], j[4], v);
  out[1] = dot3(j[3], j[1], j[5], v);
  out[2] = dot3(j[4], j[5], j[2], v);
}

// symmetric [xxx, yyy, zzz, xxy, xxz, xyy, yyz, xzz, yzz, xyz] contracted
// with v into [xx, yy, zz, xy, xz, yz] (barnes_hut.sym3_matvec)
__device__ __forceinline__ void sym3_matvec(const float h[10],
                                            const float v[3], float out[6]) {
  out[0] = dot3(h[0], h[3], h[4], v);
  out[1] = dot3(h[5], h[1], h[6], v);
  out[2] = dot3(h[7], h[8], h[2], v);
  out[3] = dot3(h[3], h[5], h[9], v);
  out[4] = dot3(h[4], h[9], h[7], v);
  out[5] = dot3(h[9], h[6], h[8], v);
}

// One thread a finest cell of the 2^L grid; L a template argument, so the
// level loop unrolls and each level's pointer is read from the kernel's
// parameters with a constant index (a runtime index copies the array to
// local memory).
template <int L>
__global__ void __launch_bounds__(kThreads)
    far_down_kernel(Levels lv, const float* __restrict__ cell,
                    float* __restrict__ plane) {
  constexpr int64_t d = int64_t{1} << L;
  const int64_t t = int64_t{blockIdx.x} * kThreads + threadIdx.x;
  if (t >= d * d * d) return;
  const int z = static_cast<int>(t & (d - 1));
  const int y = static_cast<int>((t >> L) & (d - 1));
  const int x = static_cast<int>(t >> (2 * L));
  const float edge = __ldg(cell);

  float a[3], j[6], h[10];
#pragma unroll
  for (int l = 1; l <= L; ++l) {
    const int sh = L - l;
    const int cx = x >> sh, cy = y >> sh, cz = z >> sh;
    const int64_t p = int64_t{1} << (l - 1);
    const int64_t pc = p * p * p;
    const int kid = ((cx & 1) << 2) | ((cy & 1) << 1) | (cz & 1);
    const float* __restrict__ src =
        lv.out[l - 1] + kid * kChannels * pc +
        ((cx >> 1) * p + (cy >> 1)) * p + (cz >> 1);
    float in[kChannels];
#pragma unroll
    for (int c = 0; c < kChannels; ++c) in[c] = __ldg(src + c * pc);
    if (l == 1) {
#pragma unroll
      for (int c = 0; c < 3; ++c) a[c] = in[c];
#pragma unroll
      for (int c = 0; c < 6; ++c) j[c] = in[3 + c];
#pragma unroll
      for (int c = 0; c < 10; ++c) h[c] = in[9 + c];
      continue;
    }
    const float s = mul(edge, static_cast<float>(1 << sh));
    const float v[3] = {mul((cx & 1) ? 0.5f : -0.5f, s),
                        mul((cy & 1) ? 0.5f : -0.5f, s),
                        mul((cz & 1) ? 0.5f : -0.5f, s)};
    float jv[3], hv[6], hvv[3];
    sym_matvec(j, v, jv);
    sym3_matvec(h, v, hv);
    sym_matvec(hv, v, hvv);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      a[c] = add(add(in[c], a[c]), jv[c]);
      a[c] = add(a[c], mul(0.5f, hvv[c]));
    }
#pragma unroll
    for (int c = 0; c < 6; ++c) j[c] = add(add(in[3 + c], j[c]), hv[c]);
#pragma unroll
    for (int c = 0; c < 10; ++c) h[c] = add(in[9 + c], h[c]);
  }

  float* dst = plane + int64_t{x} * kChannels * d * d + int64_t{y} * d + z;
#pragma unroll
  for (int c = 0; c < 3; ++c) dst[c * d * d] = a[c];
#pragma unroll
  for (int c = 0; c < 6; ++c) dst[(3 + c) * d * d] = j[c];
#pragma unroll
  for (int c = 0; c < 10; ++c) dst[(9 + c) * d * d] = h[c];
}

template <int L>
cudaError_t launch(const Levels& lv, const float* cell, float* plane,
                   cudaStream_t stream) {
  constexpr int64_t cells = int64_t{1} << (3 * L);
  constexpr unsigned blocks =
      static_cast<unsigned>((cells + kThreads - 1) / kThreads);
  far_down_kernel<L><<<blocks, kThreads, 0, stream>>>(lv, cell, plane);
  return cudaGetLastError();
}

}  // namespace

// outs: a host array of `levels` device pointers, K3's output of level l
// at outs[l - 1]; cell: one float on the device; plane: (2^L, 19, 4^L).
// Returns cudaErrorInvalidValue for levels outside 1..kMaxLevels.
extern "C" int nbt_far_down(const void* const* outs, int levels,
                            const float* cell, float* plane, void* stream) {
  if (levels < 1 || levels > kMaxLevels) return cudaErrorInvalidValue;
  Levels lv{};
  for (int l = 0; l < levels; ++l) {
    lv.out[l] = static_cast<const float*>(outs[l]);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (levels) {
    case 1: return launch<1>(lv, cell, plane, s);
    case 2: return launch<2>(lv, cell, plane, s);
    case 3: return launch<3>(lv, cell, plane, s);
    case 4: return launch<4>(lv, cell, plane, s);
    case 5: return launch<5>(lv, cell, plane, s);
    case 6: return launch<6>(lv, cell, plane, s);
    case 7: return launch<7>(lv, cell, plane, s);
    case 8: return launch<8>(lv, cell, plane, s);
    case 9: return launch<9>(lv, cell, plane, s);
    default: return launch<10>(lv, cell, plane, s);
  }
}
