// Point-sprite splat of one frame (kernel R1): project, cull, size, colour
// and splat N points into an (H, W, 3) float32 image, clamped, and its
// optional uint8 copy.
//
// Replaces: no TPU kernel. The JAX package renders on the host: the NumPy
// projection, culling, sizing and colouring of
// nbody_tpu/render/renderer.py (PointRenderer.render) and the serial C++
// splat native/rasterizer.cpp (nbody_splat_points), after copying every
// point to the host each frame. Here the points stay on the card and only
// the image leaves it.
//
// The image is the JAX renderer's native one, bit for bit, and the same on
// every call. nbody_splat_points adds each pixel's terms in point-index
// order, and the shipped library (-O3 -march=native) contracts two
// operations into float32 FMAs. So each pixel here is the float32 sum,
// from 0, of its terms in ascending point index, each rounded as there:
// c = rgb * alpha on its own, fall = fma(-(0.6 * d2), 1 / r2, 1) with
// 0.6 * d2 on its own, acc = fma(c, fall, acc). Every operation is written
// with its rounding intrinsic (__fmul_rn, __fmaf_rn, __dadd_rn, ...):
// nvcc's own contraction would otherwise round differently.
//
// Passes, all on the caller's stream; no float atomic and no memset of
// the image:
//   0. one memset of the meta buffer's key range and list counters;
//   1. project (a thread per point, grid-stride): float64 projection in
//      Camera.project's order, visibility, px / py / size cast to float32,
//      the colour key (view z in float64, or |v| in float32 as NumPy's
//      norm of the float32 velocities), the key's min and max over the
//      visible points (a block reduction, then one atomicMax of an
//      order-preserving 64-bit image of each: exact and order-free), and
//      an integer atomicAdd to the counter (tile, chunk) of each 8 x 8
//      screen tile (kTile) that the disc's bounding box, clipped to the
//      image, touches; chunk = the point's index range, one of `chunks`
//      (up to kMaxChunks), which also spreads a hot tile's atomics;
//   2. scan (two kernels: block sums, then each block's exclusive prefix
//      from the sums before it): the counters' first entries, tile-major,
//      so a tile's list is its chunks' runs in chunk order;
//   3. fill (a thread per point): the colour from the key range, the
//      sprite record (cx, cy as int16, rgb * alpha; 16 B) and the point's
//      entry, (index << 4) | r, written into its run in each touched tile
//      at a slot taken with an integer atomicAdd (all of a point's slots
//      first, so its atomics are in flight together). A run is in no
//      order; the runs are, since a chunk's indices precede the next one's;
//   4. splat (a block of 64 threads per tile, a thread per pixel with
//      its three sums in registers): the tile's list (at most kCap
//      entries) is loaded into shared memory and sorted there: by one warp
//      when it has at most kWarpSort entries, else a warp a chunk run when
//      every run has at most kWarpSort (bitonic over registers and
//      shuffles, no block barrier), else whole (bitonic in shared memory).
//      It is then walked in chunks of the block's width, each chunk's
//      records gathered into shared memory while the block adds the one
//      before. Then the clamp, and the image and the uint8 copy written
//      once (an empty tile writes zeros). A longer list is handed on;
//   5. splat_long (a grid over the handed-on tiles): the block partitions
//      the list by index bucket (index / kCap: at most kCap entries a
//      bucket, since a point enters a tile once) into a second buffer,
//      then splats runs of whole buckets of at most kCap entries in bucket
//      order, each sorted in shared memory as in pass 4. A list of any
//      length is exact.
// The scratch is sized from n alone, so the host never reads a count and
// a call can be captured in a CUDA graph: a disc of r <= 8 (17 px) touches
// at most kSideTiles^2 = 9 tiles, so the list takes n x 9 int32 (36 MB at
// 1M points), and the long-list partition buffer as much again, which only
// pass 5 touches and only for a list past kCap entries.
//
// What bounds it on the H100: memory, in the bound. Pass 1 reads 12 B a
// point (24 B in VELOCITY mode); the image and its copy are written once
// (11.06 + 2.76 MB at 1280x720): at 1M points ~26 MB, ~8 us at 3.35 TB/s.
// The time goes elsewhere: the per-entry integer atomics of passes 1 and
// 3, the per-tile sorts, and the splat's pixel tests (entries x kTile^2,
// ~0.1G at the app's camera), whose terms must be added one after
// another. 8 x 8 tiles took 0.60x the time of 16 x 16 at the app's camera
// and 0.97-0.99x at a close one on an H100 (PERF.md).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 8;                  // screen tile side, pixels
constexpr int kTilePix = kTile * kTile;   // threads of a splat block
constexpr int kMaxBlocks = 132 * 8;
constexpr int kMaxRadius = 8;  // round(MAX_SIZE / 2)
constexpr int kCap = 2048;     // list entries a tile sorts in shared memory
constexpr int kBuckets = 2048; // index buckets of a long list's partition
constexpr int kMaxSide = 16384;  // image side; keeps cx, cy in int16
constexpr int kLongBlocks = 264;  // blocks of the long-list splat
constexpr int kMaxChunks = 64;  // index-range chunks a tile's list is cut in
constexpr int kWarpSort = 64;   // the longest run a warp sorts
constexpr int kMaxPoints = 1 << 27;  // index << 4 | r fits 32 bits
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

// Tiles that an interval of 2 * kMaxRadius + 1 pixels can touch.
constexpr int kSideTiles = (2 * kMaxRadius - 1) / kTile + 2;

// ((x*m0 + y*m1) + z*m2) + m3: one row of hom @ M^T, hom = (x, y, z, 1).
__device__ __forceinline__ double mrow(double x, double y, double z,
                                       const double* m) {
  return __dadd_rn(
      __dadd_rn(__dadd_rn(__dmul_rn(x, m[0]), __dmul_rn(y, m[1])),
                __dmul_rn(z, m[2])),
      m[3]);
}

// An order-preserving map of doubles onto unsigned 64-bit integers; no
// finite double maps to 0, so 0 is the empty value of a max.
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

__device__ __forceinline__ unsigned long long warp_max(unsigned long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(0xffffffffu, v, off);
    v = o > v ? o : v;
  }
  return v;
}

// A visible sprite's disc: centre, radius and its bounding box clipped to
// the image (empty when x0 > x1 or y0 > y1).
struct Disc {
  int cx, cy, r, x0, x1, y0, y1;
};

__device__ __forceinline__ Disc disc_of(float px, float py, float size,
                                        int width, int height) {
  Disc d;
  d.r = max(1, round_half_away(__fmul_rn(size, 0.5f)));
  d.cx = round_half_away(px);
  d.cy = round_half_away(py);
  d.x0 = max(0, d.cx - d.r);
  d.x1 = min(width - 1, d.cx + d.r);
  d.y0 = max(0, d.cy - d.r);
  d.y1 = min(height - 1, d.cy + d.r);
  return d;
}

// The meta buffer, in ints: the key range (2 x u64: the max of ~bits and
// of bits), the count of long tiles, then the counts, their exclusive
// prefix and the fill cursors (each m = counts_padded ints, tile-major:
// [tile * chunks + k]; first[n_tiles * chunks] = the total), the long
// tiles, and the scan's block sums.
struct Meta {
  unsigned long long* range;
  int* n_long;
  int* count;
  int* first;
  int* cursor;
  int* long_tiles;
  int* block_sum;
};

constexpr int kScanThreads = 1024;
constexpr int kScanSeg = 4 * kScanThreads;  // counts a scan block takes

inline int counts_padded(int n_tiles, int chunks) {
  return (n_tiles * chunks + 1 + 3) & ~3;
}

inline int scan_blocks(int n_tiles, int chunks) {
  return (counts_padded(n_tiles, chunks) + kScanSeg - 1) / kScanSeg;
}

inline Meta meta_of(void* base, int n_tiles, int chunks) {
  int* b = static_cast<int*>(base);
  const int m = counts_padded(n_tiles, chunks);
  Meta mt;
  mt.range = reinterpret_cast<unsigned long long*>(b);
  mt.n_long = b + 4;
  mt.count = b + 8;
  mt.first = mt.count + m;
  mt.cursor = mt.first + m;
  mt.long_tiles = mt.cursor + m;
  mt.block_sum = mt.long_tiles + n_tiles;
  return mt;
}

__global__ void project_kernel(const float* __restrict__ pos,
                               const float* __restrict__ vel, int n,
                               Mats mats, double half_near, double ps30,
                               int mode, int width, int height, int tiles_x,
                               int chunks, int chunk_len,
                               float* __restrict__ pts,
                               double* __restrict__ key, Meta meta) {
  unsigned long long nlo = 0, hi = 0;  // max of ~bits, max of bits
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
      if (mode == kVelocity) {  // float32, as np.linalg.norm of float32
        const float a = vel[3 * i], b = vel[3 * i + 1], c = vel[3 * i + 2];
        k = __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)),
                                 __fmul_rn(c, c)));
      } else {
        k = vz;
      }
      const unsigned long long o = order_bits(k);
      nlo = ~o > nlo ? ~o : nlo;
      hi = o > hi ? o : hi;
      const Disc d = disc_of(px, py, size, width, height);
      if (d.x0 <= d.x1 && d.y0 <= d.y1) {
        const int sub = i / chunk_len;
        for (int ty = d.y0 / kTile; ty <= d.y1 / kTile; ++ty) {
          for (int tx = d.x0 / kTile; tx <= d.x1 / kTile; ++tx) {
            atomicAdd(meta.count + (ty * tiles_x + tx) * chunks + sub, 1);
          }
        }
      }
    }
    pts[i] = px;
    pts[n + i] = py;
    pts[2 * n + i] = size;
    key[i] = k;
  }
  __shared__ unsigned long long s_nlo[kThreads / 32], s_hi[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  nlo = warp_max(nlo);
  hi = warp_max(hi);
  if (lane == 0) {
    s_nlo[warp] = nlo;
    s_hi[warp] = hi;
  }
  __syncthreads();
  if (warp == 0) {
    nlo = lane < kThreads / 32 ? s_nlo[lane] : 0ull;
    hi = lane < kThreads / 32 ? s_hi[lane] : 0ull;
    nlo = warp_max(nlo);
    hi = warp_max(hi);
    if (lane == 0 && mode != kDensity) {
      if (nlo != 0ull) atomicMax(meta.range, nlo);
      if (hi != 0ull) atomicMax(meta.range + 1, hi);
    }
  }
}

// Exclusive prefix of v over the kScanThreads threads of the block, and
// the block's total.
__device__ int block_exclusive(int v, int* s_warp, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += o;
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = s_warp[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += o;
    }
    s_warp[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  *total = s_warp[31];
  const int ex = inc - v + (warp > 0 ? s_warp[warp - 1] : 0);
  __syncthreads();  // s_warp is reused by the caller's next call
  return ex;
}

// Scan, pass 1: each block's sum of its kScanSeg counts (four a thread).
__global__ void __launch_bounds__(kScanThreads)
    block_sum_kernel(int m, Meta meta) {
  __shared__ int s_warp[32];
  const int at = blockIdx.x * kScanSeg + 4 * threadIdx.x;
  int v = 0;
  if (at < m) {
    const int4 c = *reinterpret_cast<const int4*>(meta.count + at);
    v = c.x + c.y + c.z + c.w;
  }
  int total;
  block_exclusive(v, s_warp, &total);
  if (threadIdx.x == 0) meta.block_sum[blockIdx.x] = total;
}

// Scan, pass 2: first[] and cursor[] = the exclusive prefix of the counts,
// each block from the sum of the block sums before it.
__global__ void __launch_bounds__(kScanThreads)
    scan_kernel(int m, Meta meta) {
  __shared__ int s_warp[32];
  int before = 0, total;
  for (int b = threadIdx.x; b < static_cast<int>(blockIdx.x);
       b += kScanThreads) {
    before += meta.block_sum[b];
  }
  block_exclusive(before, s_warp, &total);
  before = total;
  const int at = blockIdx.x * kScanSeg + 4 * threadIdx.x;
  int4 c = make_int4(0, 0, 0, 0);
  if (at < m) c = *reinterpret_cast<const int4*>(meta.count + at);
  int ex = before + block_exclusive(c.x + c.y + c.z + c.w, s_warp, &total);
  if (at < m) {
    int4 f;
    f.x = ex;
    f.y = f.x + c.x;
    f.z = f.y + c.y;
    f.w = f.z + c.z;
    *reinterpret_cast<int4*>(meta.first + at) = f;
    *reinterpret_cast<int4*>(meta.cursor + at) = f;
  }
}

__global__ void fill_kernel(int n, int mode, int width, int height,
                            int tiles_x, int chunks, int chunk_len,
                            const float* __restrict__ pts,
                            const double* __restrict__ key, Meta meta,
                            float* __restrict__ rgb, float4* __restrict__ rec,
                            unsigned* __restrict__ list) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float size = pts[2 * n + i];
  if (size == 0.0f) {  // not visible
    if (rgb != nullptr) rgb[3 * i] = rgb[3 * i + 1] = rgb[3 * i + 2] = 0.0f;
    return;
  }
  const Disc d = disc_of(pts[i], pts[n + i], size, width, height);
  const bool hit = d.x0 <= d.x1 && d.y0 <= d.y1;
  // the list slots first, all atomics in flight together
  int slot[kSideTiles * kSideTiles];
  const int sub = i / chunk_len;
#pragma unroll
  for (int q = 0; q < kSideTiles * kSideTiles; ++q) {
    const int tx = d.x0 / kTile + q % kSideTiles,
              ty = d.y0 / kTile + q / kSideTiles;
    slot[q] = hit && tx <= d.x1 / kTile && ty <= d.y1 / kTile
                  ? atomicAdd(meta.cursor + (ty * tiles_x + tx) * chunks + sub,
                              1)
                  : -1;
  }
  // t = (key - lo) / (hi - lo) clipped to [0, 1]: in float64 for DEPTH, in
  // float32 for VELOCITY's float32 key (NumPy's arithmetic with
  // Python-float bounds: the range in float64, rounded for the division);
  // 0 for a flat range and in DENSITY mode (no density input: every point
  // takes the ramp's start). u = 1 - t in t's precision.
  double t = 0.0, u = 1.0;
  if (mode != kDensity) {
    const double lo = from_order_bits(~meta.range[0]);
    const double hi = from_order_bits(meta.range[1]);
    const double span = __dsub_rn(hi, lo);
    if (!(span < kFlatRange)) {
      if (mode == kVelocity) {
        float tf = __fdiv_rn(__fsub_rn(static_cast<float>(key[i]),
                                       static_cast<float>(lo)),
                             __double2float_rn(span));
        tf = fminf(fmaxf(tf, 0.0f), 1.0f);
        t = tf;
        u = __fsub_rn(1.0f, tf);
      } else {
        t = fmin(fmax(__ddiv_rn(__dsub_rn(key[i], lo), span), 0.0), 1.0);
        u = __dsub_rn(1.0, t);
      }
    }
  }
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
  if (!hit) return;  // the disc misses the image
  const float alpha = fminf(1.0f, __fdiv_rn(1.5f, static_cast<float>(
                                                      d.r * d.r)));
  const unsigned xy = (static_cast<unsigned>(d.cx) & 0xffffu) |
                      (static_cast<unsigned>(d.cy) << 16);
  rec[i] = make_float4(__uint_as_float(xy), __fmul_rn(c[0], alpha),
                       __fmul_rn(c[1], alpha), __fmul_rn(c[2], alpha));
  const unsigned entry = (static_cast<unsigned>(i) << 4) |
                         static_cast<unsigned>(d.r);
#pragma unroll
  for (int q = 0; q < kSideTiles * kSideTiles; ++q) {
    if (slot[q] >= 0) list[slot[q]] = entry;
  }
}

// The splat's shared staging, double-buffered: a chunk of kN records, and
// for each warp of the block the chunk's records whose rows meet the
// warp's (their places in the chunk, in order, and their count by staging
// warp).
struct Stage {
  static constexpr int kN = kTilePix, kWarps = kN / 32;
  int4 pos[2][kN];    // cx, cy, r * r, r
  float4 col[2][kN];  // c = rgb * alpha, 1 / r^2
  unsigned char idx[2][kWarps][kN];
  int cnt[2][kWarps][kWarps];
};

// A tile's pixel work, shared by the two splat kernels: the thread's pixel
// (x, y), its warp's first row, and its three sums.
struct TileSplat {
  static constexpr int kN = kTilePix, kWarps = kN / 32, kRows = 32 / kTile;
  int x, y, row0;
  float acc[3];

  __device__ void init(int tile, int tiles_x) {
    const int tx = tile % tiles_x, ty = tile / tiles_x;
    x = tx * kTile + static_cast<int>(threadIdx.x) % kTile;
    y = ty * kTile + static_cast<int>(threadIdx.x) / kTile;
    row0 = ty * kTile;
    acc[0] = acc[1] = acc[2] = 0.0f;
  }

  // Sort s_key[0, len) ascending in shared memory (bitonic, padded to a
  // power of two with 0xffffffff); len <= kCap.
  __device__ static void sort(unsigned* s_key, int len) {
    int p = 1;
    while (p < len) p <<= 1;
    for (int j = len + static_cast<int>(threadIdx.x); j < p; j += kN) {
      s_key[j] = 0xffffffffu;
    }
    __syncthreads();
    for (int k = 2; k <= p; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int c = threadIdx.x; c < (p >> 1); c += kN) {
          const int e = ((c & ~(j - 1)) << 1) | (c & (j - 1));
          const unsigned a = s_key[e], b = s_key[e + j];
          if ((a > b) == ((e & k) == 0)) {
            s_key[e] = b;
            s_key[e + j] = a;
          }
        }
        __syncthreads();
      }
    }
  }

  // Sort the run s_key[a, a + m), m <= kWarpSort, by the calling warp
  // (bitonic in registers and shuffles, two entries a lane).
  __device__ static void warp_sort(unsigned* s_key, int a, int m) {
    const int lane = threadIdx.x & 31;
    unsigned v[2];  // entries lane and 32 + lane of the run
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      v[i] = lane + 32 * i < m ? s_key[a + lane + 32 * i] : 0xffffffffu;
    }
#pragma unroll
    for (int k = 2; k <= 64; k <<= 1) {
#pragma unroll
      for (int j = k >> 1; j > 0; j >>= 1) {
        if (j == 32) {  // entries lane and 32 + lane: ascending for k 64
          const unsigned lo = min(v[0], v[1]), hi = max(v[0], v[1]);
          v[0] = lo;
          v[1] = hi;
          continue;
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const unsigned o = __shfl_xor_sync(0xffffffffu, v[i], j);
          const bool up = ((lane + 32 * i) & k) == 0;
          v[i] = ((lane & j) == 0) == up ? min(v[i], o) : max(v[i], o);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (lane + 32 * i < m) s_key[a + lane + 32 * i] = v[i];
    }
  }

  // Sort s_key[0, len): a list of at most kWarpSort entries by one warp;
  // else, when each index chunk's run s_key[s_seg[c], s_seg[c + 1]) has at
  // most kWarpSort entries, each run by a warp (the runs are in chunk
  // order, and a chunk's indices precede the next one's); else whole.
  __device__ static void sort_list(unsigned* s_key, int len, const int* s_seg,
                                   int chunks, int longest) {
    if (len <= kWarpSort) {
      if (threadIdx.x < 32) warp_sort(s_key, 0, len);
    } else if (longest <= kWarpSort) {
      for (int c = threadIdx.x >> 5; c < chunks; c += kN / 32) {
        const int a = s_seg[c], m = s_seg[c + 1] - a;
        if (m > 1) warp_sort(s_key, a, m);  // warp-uniform
      }
    } else {
      sort(s_key, len);
    }
    __syncthreads();
  }

  // Add the sorted entries s_key[0, len) in order, kN a chunk: a thread
  // stages one record of the chunk and gathers one of the next while the
  // block adds this one; each warp walks only the records whose rows meet
  // its own (listed by ballots when staged, in order).
  __device__ void add(const unsigned* s_key, int len,
                      const float4* __restrict__ rec, Stage& st) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const unsigned below = (1u << lane) - 1u;
    unsigned e = 0;
    float4 q = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (tid < len) {
      e = s_key[tid];
      q = rec[e >> 4];
    }
    for (int base = 0, buf = 0; base < len; base += kN, buf ^= 1) {
      const bool live = tid < len - base;
      int cy = 0, r = 0;
      if (live) {
        r = static_cast<int>(e & 15u);
        const unsigned xy = __float_as_uint(q.x);
        cy = static_cast<short>(xy >> 16);
        st.pos[buf][tid] = make_int4(static_cast<short>(xy & 0xffffu), cy,
                                     r * r, r);
        st.col[buf][tid] = make_float4(
            q.y, q.z, q.w, __fdiv_rn(1.0f, static_cast<float>(r * r)));
      }
      int at[kWarps];
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int lo = row0 + w * kRows;
        const bool meets = live && cy - r < lo + kRows && cy + r >= lo;
        const unsigned b = __ballot_sync(0xffffffffu, meets);
        if (lane == 0) st.cnt[buf][w][warp] = __popc(b);
        at[w] = meets ? __popc(b & below) : -1;
      }
      __syncthreads();
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        if (at[w] >= 0) {
          for (int sw = 0; sw < warp; ++sw) at[w] += st.cnt[buf][w][sw];
          st.idx[buf][w][at[w]] = static_cast<unsigned char>(tid);
        }
      }
      int cnt = 0;
      for (int sw = 0; sw < kWarps; ++sw) cnt += st.cnt[buf][warp][sw];
      __syncthreads();
      if (base + kN + tid < len) {
        e = s_key[base + kN + tid];
        q = rec[e >> 4];
      }
#pragma unroll 4
      for (int k = 0; k < cnt; ++k) {
        const int j = st.idx[buf][warp][k];
        const int4 p = st.pos[buf][j];
        const int dx = x - p.x, dy = y - p.y;
        const int d2 = dx * dx + dy * dy;
        if (d2 <= p.z) {
          const float4 c = st.col[buf][j];
          const float fall = __fmaf_rn(
              -__fmul_rn(0.6f, static_cast<float>(d2)), c.w, 1.0f);
          acc[0] = __fmaf_rn(c.x, fall, acc[0]);
          acc[1] = __fmaf_rn(c.y, fall, acc[1]);
          acc[2] = __fmaf_rn(c.z, fall, acc[2]);
        }
      }
    }
    __syncthreads();  // the caller may refill s_key and the staging
  }

  // Clamp to [0, 1] and write the pixel (and its uint8 copy) once.
  __device__ void store(int width, int height, float* __restrict__ img,
                        unsigned char* __restrict__ u8) const {
    if (x >= width || y >= height) return;
    const size_t at = (static_cast<size_t>(y) * width + x) * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float v = fminf(1.0f, fmaxf(0.0f, acc[c]));
      img[at + c] = v;
      if (u8 != nullptr) {
        u8[at + c] = static_cast<unsigned char>(
            static_cast<int>(__fmul_rn(v, 255.0f)));
      }
    }
  }
};

__global__ void __launch_bounds__(kTilePix)
    splat_kernel(int width, int height, int tiles_x, int chunks, Meta meta,
                 const unsigned* __restrict__ list,
                 const float4* __restrict__ rec, float* __restrict__ img,
                 unsigned char* __restrict__ u8) {
  __shared__ unsigned s_key[kCap];
  __shared__ Stage st;
  __shared__ int s_seg[kMaxChunks + 1];
  __shared__ int s_longest;
  const int tile = blockIdx.x;
  const int* seg = meta.first + tile * chunks;
  const int a = seg[0];
  const int len = seg[chunks] - a;
  if (len > kCap) {  // splat_long_kernel's
    if (threadIdx.x == 0) meta.long_tiles[atomicAdd(meta.n_long, 1)] = tile;
    return;
  }
  TileSplat s;
  s.init(tile, tiles_x);
  if (threadIdx.x == 0) s_longest = 0;
  for (int c = threadIdx.x; c <= chunks; c += kTilePix) {
    s_seg[c] = seg[c] - a;
  }
  for (int j = threadIdx.x; j < len; j += kTilePix) s_key[j] = list[a + j];
  __syncthreads();
  for (int c = threadIdx.x; c < chunks; c += kTilePix) {
    atomicMax(&s_longest, s_seg[c + 1] - s_seg[c]);
  }
  __syncthreads();
  TileSplat::sort_list(s_key, len, s_seg, chunks, s_longest);
  s.add(s_key, len, rec, st);
  s.store(width, height, img, u8);
}

// Exclusive prefix of s_v[0, kBuckets) in place, s_v[kBuckets] = the total;
// kTilePix threads, each over a contiguous run.
__device__ void bucket_scan(int* s_v, int* s_part) {
  constexpr int kN = kTilePix, per = kBuckets / kN;
  const int a = threadIdx.x * per;
  int sum = 0;
  for (int b = a; b < a + per; ++b) sum += s_v[b];
  s_part[threadIdx.x] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int w = 0; w < kN; ++w) {
      const int v = s_part[w];
      s_part[w] = run;
      run += v;
    }
    s_v[kBuckets] = run;
  }
  __syncthreads();
  int at = s_part[threadIdx.x];
  for (int b = a; b < a + per; ++b) {
    const int v = s_v[b];
    s_v[b] = at;
    at += v;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kTilePix)
    splat_long_kernel(int n, int width, int height, int tiles_x, int chunks,
                      Meta meta, const unsigned* __restrict__ list,
                      unsigned* __restrict__ tmp,
                      const float4* __restrict__ rec,
                      float* __restrict__ img,
                      unsigned char* __restrict__ u8) {
  static_assert(kBuckets % kTilePix == 0, "buckets split over the block");
  __shared__ unsigned s_key[kCap];
  __shared__ Stage st;
  __shared__ int s_off[kBuckets + 1];
  __shared__ int s_cur[kBuckets];
  __shared__ int s_part[kTilePix];
  __shared__ int s_end;
  const int ranges = ((n + kCap - 1) / kCap + kBuckets - 1) / kBuckets;
  const int n_long = *meta.n_long;
  for (int q = blockIdx.x; q < n_long; q += gridDim.x) {
    const int tile = meta.long_tiles[q];
    const int first = meta.first[tile * chunks];
    const int len = meta.first[(tile + 1) * chunks] - first;
    TileSplat s;
    s.init(tile, tiles_x);
    const unsigned* src = list + first;
    unsigned* part = tmp + first;
    for (int range = 0; range < ranges; ++range) {
      const unsigned b0 = static_cast<unsigned>(range) * kBuckets;
      for (int b = threadIdx.x; b < kBuckets; b += kTilePix) s_off[b] = 0;
      __syncthreads();
      for (int j = threadIdx.x; j < len; j += kTilePix) {
        const unsigned b = (src[j] >> 4) / kCap - b0;
        if (b < kBuckets) atomicAdd(s_off + b, 1);
      }
      __syncthreads();
      bucket_scan(s_off, s_part);
      for (int b = threadIdx.x; b < kBuckets; b += kTilePix) {
        s_cur[b] = s_off[b];
      }
      __syncthreads();
      for (int j = threadIdx.x; j < len; j += kTilePix) {
        const unsigned e = src[j];
        const unsigned b = (e >> 4) / kCap - b0;
        if (b < kBuckets) part[atomicAdd(s_cur + b, 1)] = e;
      }
      __syncthreads();
      // runs of whole buckets of at most kCap entries, in bucket order
      for (int g0 = 0; g0 < kBuckets;) {
        if (threadIdx.x == 0) {
          int lo = g0 + 1, hi = kBuckets;  // the last g1 with a run <= kCap
          while (lo < hi) {
            const int mid = (lo + hi + 1) >> 1;
            if (s_off[mid] - s_off[g0] <= kCap) lo = mid; else hi = mid - 1;
          }
          s_end = lo;
        }
        __syncthreads();
        const int g1 = s_end;
        const int a = s_off[g0], m = s_off[g1] - a;
        for (int j = threadIdx.x; j < m; j += kTilePix) {
          s_key[j] = part[a + j];
        }
        TileSplat::sort(s_key, m);
        s.add(s_key, m, rec, st);
        g0 = g1;
      }
    }
    s.store(width, height, img, u8);
  }
}

int blocks_for(int64_t work, int cap) {
  const int64_t b = (work + kThreads - 1) / kThreads;
  return static_cast<int>(b < cap ? b : cap);
}

int launch(const float* pos, const float* vel, int n, const Mats& mats,
           double half_near, double ps30, int mode, int width, int height,
           int chunks, float* img, unsigned char* u8, float* pts,
           double* key, float* rgb, float4* rec, void* meta_base,
           unsigned* list, unsigned* tmp, cudaStream_t stream) {
  const int tiles_x = (width + kTile - 1) / kTile;
  const int n_tiles = tiles_x * ((height + kTile - 1) / kTile);
  const int m = counts_padded(n_tiles, chunks);
  const Meta meta = meta_of(meta_base, n_tiles, chunks);
  const int chunk_len = n > chunks ? (n + chunks - 1) / chunks : 1;
  cudaError_t err = cudaMemsetAsync(meta_base, 0, (8 + m) * sizeof(int),
                                    stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    project_kernel<<<blocks_for(n, kMaxBlocks), kThreads, 0, stream>>>(
        pos, vel, n, mats, half_near, ps30, mode, width, height, tiles_x,
        chunks, chunk_len, pts, key, meta);
  }
  const int blocks = scan_blocks(n_tiles, chunks);
  block_sum_kernel<<<blocks, kScanThreads, 0, stream>>>(m, meta);
  scan_kernel<<<blocks, kScanThreads, 0, stream>>>(m, meta);
  if (n > 0) {
    fill_kernel<<<blocks_for(n, 1 << 30), kThreads, 0, stream>>>(
        n, mode, width, height, tiles_x, chunks, chunk_len, pts, key, meta,
        rgb, rec, list);
  }
  splat_kernel<<<n_tiles, kTilePix, 0, stream>>>(
      width, height, tiles_x, chunks, meta, list, rec, img, u8);
  const int long_blocks = n_tiles < kLongBlocks ? n_tiles : kLongBlocks;
  splat_long_kernel<<<long_blocks, kTilePix, 0, stream>>>(
      n, width, height, tiles_x, chunks, meta, list, tmp, rec, img, u8);
  return static_cast<int>(cudaGetLastError());
}

bool valid_chunks(int chunks) { return chunks >= 1 && chunks <= kMaxChunks; }

}  // namespace

// chunks, n_tiles, field -> nbt_render_points' scratch sizes: the most
// list entries a sprite makes (field 0: tiles its disc's box can touch),
// the meta buffer's ints (field 1); -1 for chunks outside [1, kMaxChunks]
// or another field.
extern "C" int nbt_render_scratch(int chunks, int n_tiles, int field) {
  if (!valid_chunks(chunks) || n_tiles < 1) return -1;
  if (field == 0) return kSideTiles * kSideTiles;
  if (field == 1) {
    return 8 + 3 * counts_padded(n_tiles, chunks) + n_tiles +
           scan_blocks(n_tiles, chunks);
  }
  return -1;
}

// pos, vel (VELOCITY mode only, else may be null): (n, 3) float32;
// mats_host: 32 doubles on the host (P*V, then V, row-major); half_near:
// the in-front threshold on clip w; ps30: point_size * 30; chunks: index
// ranges a tile's list is cut in, each with its own counter (1 to
// kMaxChunks); img: (height, width, 3) float32 out; u8: its uint8 copy
// out, or null; pts: (3, n) float32 scratch (px, py,
// size; 0 for a point not visible); key: (n,) double scratch; rgb: (n, 3)
// float32 out, or null; rec: (n, 4) float32 scratch; meta, list, tmp:
// int scratch of nbt_render_scratch's sizes (list and tmp n times field
// 0 each).
extern "C" int nbt_render_points(const float* pos, const float* vel, int n,
                                 const double* mats_host, double half_near,
                                 double ps30, int mode, int width, int height,
                                 int chunks, float* img,
                                 unsigned char* u8, float* pts, double* key,
                                 float* rgb, float* rec, void* meta,
                                 unsigned* list, unsigned* tmp,
                                 cudaStream_t stream) {
  if (n < 0 || n > kMaxPoints || width < 1 || height < 1 ||
      width > kMaxSide || height > kMaxSide || mode < kDepth ||
      mode > kDensity || (mode == kVelocity && n > 0 && vel == nullptr) ||
      !valid_chunks(chunks)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Mats mats;
  for (int j = 0; j < 16; ++j) {
    mats.pv[j] = mats_host[j];
    mats.view[j] = mats_host[16 + j];
  }
  return launch(pos, vel, n, mats, half_near, ps30, mode, width, height,
                chunks, img, u8, pts, key, rgb,
                reinterpret_cast<float4*>(rec), meta, list, tmp, stream);
}
