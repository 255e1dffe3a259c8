// Point-sprite splat of one frame (kernel R1): project, cull, size, colour
// and splat N points into an (H, W, 3) float32 image, then clamp it.
//
// Replaces: no TPU kernel. The JAX package renders on the host: the NumPy
// projection, culling, sizing and colouring of
// nbody_tpu/render/renderer.py (PointRenderer.render) and the serial C++
// splat native/rasterizer.cpp (nbody_splat_points), after copying every
// point to the host each frame. Here the points stay on the card and only
// the image leaves it.
//
// Passes, all on the caller's stream:
//   0. memsets: the image to 0, the key range to its empty value;
//   1. project (a thread per point, grid-stride): float64 projection in
//      Camera.project's order, visibility, px / py / size cast to float32,
//      the colour key (view z or |v|) in float64, and the key's min and
//      max over the visible points: a block reduction, then one atomicMin
//      of an order-preserving 64-bit image of each (the max as the min of
//      the complement), so the range is exact and order-free;
//   2. splat (a thread per point): the point's colour from the key range
//      (float64 lerp, cast to float32), then its disc of radius r <= 8
//      added to the image with float atomicAdd;
//   3. finish (a thread per value, grid-stride): clamp to [0, 1] and the
//      optional uint8 copy, (img * 255) truncated.
// Every operation that decides where a point lands or what it adds is
// rounded on its own (__dadd_rn, __dmul_rn, __fmul_rn, ...): nvcc's FMA
// contraction would otherwise move px or a falloff weight by an ulp
// against the plain twin.
//
// What bounds it on the H100: memory. Pass 1 reads 12 B a point (24 B in
// VELOCITY mode) and writes 20 B of per-point sprite data that pass 2 reads
// back; the image is 11.06 MB at 1280x720, written by the memset, read and
// written by the atomics and by the clamp. At 1M points that is ~110 MB,
// ~33 us at 3.35 TB/s. The atomics (15 a point at r = 1, up to 591 at
// r = 8) go to L2; where many points land on one pixel they serialise.
// Float atomics add in no fixed order, so the image is not bit-reproducible
// (within ~1e-6 of the float64 sum of the same terms); binning points to
// screen tiles in shared memory would fix the order and cut the atomics.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;
constexpr double kCull = 1.2;
constexpr double kMinDepth = 0.1;
constexpr double kMinSize = 0.5;
constexpr double kMaxSize = 16.0;
constexpr double kFlatRange = 1e-12;

enum Mode { kDepth = 0, kVelocity = 1, kDensity = 2 };

// Ramp endpoints (start, end) of each mode, nbody_tpu_torch/render/color.py.
__constant__ double kRamp[3][2][3] = {
    {{1.0, 0.65, 0.3}, {0.3, 0.45, 1.0}},    // DEPTH: warm -> cool
    {{0.2, 0.35, 1.0}, {1.0, 0.25, 0.15}},   // VELOCITY: slow -> fast
    {{0.25, 0.65, 0.35}, {1.0, 0.95, 0.4}},  // DENSITY: sparse -> dense
};

struct Mats {
  double pv[16];    // projection * view, row-major
  double view[16];  // view, row-major
};

// ((x*m0 + y*m1) + z*m2) + m3: one row of hom @ M^T, hom = (x, y, z, 1).
__device__ __forceinline__ double mrow(double x, double y, double z,
                                       const double* m) {
  return __dadd_rn(
      __dadd_rn(__dadd_rn(__dmul_rn(x, m[0]), __dmul_rn(y, m[1])),
                __dmul_rn(z, m[2])),
      m[3]);
}

// An order-preserving map of doubles onto unsigned 64-bit integers.
__device__ __forceinline__ unsigned long long order_bits(double v) {
  const unsigned long long b =
      static_cast<unsigned long long>(__double_as_longlong(v));
  return (b >> 63) ? ~b : (b | 0x8000000000000000ull);
}

__device__ __forceinline__ double from_order_bits(unsigned long long k) {
  const unsigned long long b = (k >> 63) ? (k & 0x7fffffffffffffffull) : ~k;
  return __longlong_as_double(static_cast<long long>(b));
}

// C's lround of a float: in double |v| + 0.5 is exact.
__device__ __forceinline__ int round_half_away(float v) {
  const double a = floor(fabs(static_cast<double>(v)) + 0.5);
  return static_cast<int>(v < 0.0f ? -a : a);
}

__device__ __forceinline__ unsigned long long warp_min(unsigned long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(0xffffffffu, v, off);
    v = o < v ? o : v;
  }
  return v;
}

__global__ void project_kernel(const float* __restrict__ pos,
                               const float* __restrict__ vel, int n,
                               Mats mats, double half_near, double ps30,
                               int mode, int width, int height,
                               float* __restrict__ pts,
                               double* __restrict__ key,
                               unsigned long long* __restrict__ range) {
  unsigned long long lo = ~0ull, nhi = ~0ull;  // min key, min of ~key
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const double x = pos[3 * i], y = pos[3 * i + 1], z = pos[3 * i + 2];
    const double w = mrow(x, y, z, mats.pv + 12);
    const bool in_front = w > half_near;
    const double w_safe = in_front ? w : 1.0;
    const double nx = __ddiv_rn(mrow(x, y, z, mats.pv), w_safe);
    const double ny = __ddiv_rn(mrow(x, y, z, mats.pv + 4), w_safe);
    const double vz = -mrow(x, y, z, mats.view + 8);
    float px = 0.0f, py = 0.0f, size = 0.0f;
    double k = 0.0;
    if (in_front && fabs(nx) < kCull && fabs(ny) < kCull) {
      px = __double2float_rn(__dmul_rn(
          __dadd_rn(__dmul_rn(nx, 0.5), 0.5), static_cast<double>(width - 1)));
      py = __double2float_rn(__dmul_rn(
          __dsub_rn(1.0, __dadd_rn(__dmul_rn(ny, 0.5), 0.5)),
          static_cast<double>(height - 1)));
      const double s = __ddiv_rn(ps30, fmax(vz, kMinDepth));
      size = __double2float_rn(fmin(fmax(s, kMinSize), kMaxSize));
      if (mode == kVelocity) {
        const double a = vel[3 * i], b = vel[3 * i + 1], c = vel[3 * i + 2];
        k = __dsqrt_rn(__dadd_rn(__dadd_rn(__dmul_rn(a, a), __dmul_rn(b, b)),
                                 __dmul_rn(c, c)));
      } else {
        k = vz;
      }
      const unsigned long long o = order_bits(k);
      lo = o < lo ? o : lo;
      nhi = ~o < nhi ? ~o : nhi;
    }
    pts[i] = px;
    pts[n + i] = py;
    pts[2 * n + i] = size;
    key[i] = k;
  }
  __shared__ unsigned long long s_lo[kThreads / 32], s_nhi[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  lo = warp_min(lo);
  nhi = warp_min(nhi);
  if (lane == 0) {
    s_lo[warp] = lo;
    s_nhi[warp] = nhi;
  }
  __syncthreads();
  if (warp == 0) {
    lo = lane < kThreads / 32 ? s_lo[lane] : ~0ull;
    nhi = lane < kThreads / 32 ? s_nhi[lane] : ~0ull;
    lo = warp_min(lo);
    nhi = warp_min(nhi);
    if (lane == 0 && mode != kDensity) {
      if (lo != ~0ull) atomicMin(range, lo);
      if (nhi != ~0ull) atomicMin(range + 1, nhi);
    }
  }
}

__global__ void splat_kernel(int n, int mode, int width, int height,
                             const float* __restrict__ pts,
                             const double* __restrict__ key,
                             const unsigned long long* __restrict__ range,
                             float* __restrict__ img, float* __restrict__ rgb) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float size = pts[2 * n + i];
  if (size == 0.0f) {  // not visible
    if (rgb != nullptr) rgb[3 * i] = rgb[3 * i + 1] = rgb[3 * i + 2] = 0.0f;
    return;
  }
  // t = (key - lo) / (hi - lo) clipped to [0, 1]; 0 for a flat range and
  // in DENSITY mode (no density input: every point takes the ramp's start)
  double t = 0.0;
  if (mode != kDensity) {
    const double lo = from_order_bits(range[0]);
    const double hi = from_order_bits(~range[1]);
    const double span = __dsub_rn(hi, lo);
    if (!(span < kFlatRange)) {
      t = fmin(fmax(__ddiv_rn(__dsub_rn(key[i], lo), span), 0.0), 1.0);
    }
  }
  const double u = __dsub_rn(1.0, t);
  float c[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    c[j] = __double2float_rn(__dadd_rn(__dmul_rn(kRamp[mode][0][j], u),
                                       __dmul_rn(kRamp[mode][1][j], t)));
  }
  if (rgb != nullptr) {
    rgb[3 * i] = c[0];
    rgb[3 * i + 1] = c[1];
    rgb[3 * i + 2] = c[2];
  }
  const int r = max(1, round_half_away(__fmul_rn(size, 0.5f)));
  const int cx = round_half_away(pts[i]);
  const int cy = round_half_away(pts[n + i]);
  const float r2 = static_cast<float>(r * r);
  const float alpha = fminf(1.0f, __fdiv_rn(1.5f, r2));
  const float inv_r2 = __fdiv_rn(1.0f, r2);
  const float cr = __fmul_rn(c[0], alpha);
  const float cg = __fmul_rn(c[1], alpha);
  const float cb = __fmul_rn(c[2], alpha);
  const int y0 = max(0, cy - r), y1 = min(height - 1, cy + r);
  const int x0 = max(0, cx - r), x1 = min(width - 1, cx + r);
  for (int y = y0; y <= y1; ++y) {
    const int dy = y - cy;
    float* row = img + static_cast<size_t>(y) * width * 3;
    for (int x = x0; x <= x1; ++x) {
      const int dx = x - cx;
      const int d2 = dx * dx + dy * dy;
      if (d2 > r * r) continue;
      const float fall = __fsub_rn(
          1.0f, __fmul_rn(__fmul_rn(0.6f, static_cast<float>(d2)), inv_r2));
      atomicAdd(row + 3 * x, __fmul_rn(cr, fall));
      atomicAdd(row + 3 * x + 1, __fmul_rn(cg, fall));
      atomicAdd(row + 3 * x + 2, __fmul_rn(cb, fall));
    }
  }
}

__global__ void finish_kernel(float* __restrict__ img,
                              unsigned char* __restrict__ u8, int64_t total) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const float v = fminf(1.0f, fmaxf(0.0f, img[i]));
    img[i] = v;
    if (u8 != nullptr) {
      u8[i] = static_cast<unsigned char>(
          static_cast<int>(__fmul_rn(v, 255.0f)));
    }
  }
}

int blocks_for(int64_t work, int cap) {
  const int64_t b = (work + kThreads - 1) / kThreads;
  return static_cast<int>(b < cap ? b : cap);
}

}  // namespace

// pos, vel (VELOCITY mode only, else may be null): (n, 3) float32;
// mats_host: 32 doubles on the host (P*V, then V, row-major); half_near:
// the in-front threshold on clip w; ps30: point_size * 30; img: (height,
// width, 3) float32 out; u8: its uint8 copy out, or null; pts: (3, n)
// float32 scratch (px, py, size; 0 for a point not visible); key: (n,)
// double scratch; rgb: (n, 3) float32 out, or null; range: 2 x 64-bit
// scratch.
extern "C" int nbt_render_points(const float* pos, const float* vel, int n,
                                 const double* mats_host, double half_near,
                                 double ps30, int mode, int width, int height,
                                 float* img, unsigned char* u8, float* pts,
                                 double* key, float* rgb, void* range,
                                 cudaStream_t stream) {
  if (n < 0 || width < 1 || height < 1 || mode < kDepth || mode > kDensity ||
      (mode == kVelocity && n > 0 && vel == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Mats mats;
  for (int j = 0; j < 16; ++j) {
    mats.pv[j] = mats_host[j];
    mats.view[j] = mats_host[16 + j];
  }
  const int64_t total = static_cast<int64_t>(height) * width * 3;
  auto* krange = static_cast<unsigned long long*>(range);
  cudaError_t err = cudaMemsetAsync(img, 0, total * sizeof(float), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(krange, 0xff, 2 * sizeof(unsigned long long), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    project_kernel<<<blocks_for(n, kMaxBlocks), kThreads, 0, stream>>>(
        pos, vel, n, mats, half_near, ps30, mode, width, height, pts, key,
        krange);
    splat_kernel<<<blocks_for(n, 1 << 30), kThreads, 0, stream>>>(
        n, mode, width, height, pts, key, krange, img, rgb);
  }
  finish_kernel<<<blocks_for(total, 2 * kMaxBlocks), kThreads, 0, stream>>>(
      img, u8, total);
  return static_cast<int>(cudaGetLastError());
}
