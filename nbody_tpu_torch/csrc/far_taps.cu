// One pyramid level's multipole-to-local tap sum, as an implicit GEMM on
// the tensor cores in 3xTF32.
//
// Replaces: nbody_tpu/ops/pallas_far_taps.py, _taps_kernel /
// far_taps_pallas (the VMEM-resident tap loop of
// barnes_hut._far_conv_level), which runs the products on the MXU with a
// 3-way bf16 split (exact=True, the main path's setting).
//
//   out[o, c] = sum_t sum_i taps[t, o, i] * mom[i, c + off_t]
//
// mom (80, p^3): 8 source children x [m, srel3, quad6] per parent cell,
// taps (T, 152, 80) with T = (2ws+1)^3 parent offsets in (x, y, z) order,
// out (152, p^3): 8 target children x [A3, J6, H10]. A source cell outside
// the p^3 grid contributes zero (the TPU kernel's zero pads and z masks).
//
// As a GEMM: out^T (cells x 152) = sum_t A_t (cells x 80) . B_t (80 x 152),
// A_t the moments of each cell's source at offset t, B_t = taps[t]^T; K is
// 27 taps x 80 channels = 2160 at ws = 1.
//
// What bounds it on the H100: the multiply-adds. At the finest 1M level
// (p = 32, ws = 1) the sources inside the grid make 1.01e10 of them: 0.30
// ms at the 67 TFLOP/s of the FP32 pipes, 0.12 ms as three TF32 products
// each at 495 TFLOP/s; its bytes (31 MB) take 0.01 ms. So the products run
// on the tensor cores: mma.sync m16n8k8 TF32 with FP32 accumulation, each
// operand x split into hi = tf32(x) and lo = tf32(x - hi), and
// acc += lo_a hi_b + hi_a lo_b + hi_a hi_b (lo_a lo_b, ~2^-22 |ab|, is
// dropped): FP32-level products, the counterpart of the TPU kernel's bf16
// split. The tensor cores add into their accumulator with truncation, an
// error that grows with the number of products in one fragment (at ws = 2,
// 3750 of them, it missed 2e-5 max|out| by 3.5x), so each stage of 15
// products per output is summed in a zeroed fragment and added to the FP32
// total with a rounded add.
//
// Design: a block owns a brick of cells and a range of the 19 n8 output
// tiles. From p = 32 on: a 4x4x8 brick (128 cells) and all 152 outputs,
// 16 warps of 32 cells (two m16 tiles) x 5 or 4 output tiles, at most 128
// registers a thread so that all 16 fit an SM. Below: a 2x4x4 brick (32
// cells) and a quarter of the outputs per block (p = 16 puts 512 blocks
// on the card), where KW = 4 warps (8 at p <= 8, at most 64 blocks) split
// the stages, stage s to warp s % KW, and add their sums at the end in the
// order 0, 1, 2, ...: a lone warp would wait out every latency of its ~50
// stages in turn. The K loop runs over stages of (tap, 40 channels), only
// over the taps that reach the grid from the brick (at p = 1 the centre
// one): the stage's A tile (the brick's cells shifted by the tap, zero
// outside the grid, one 4-byte cp.async each with zero fill) and B tile
// (the block's rows of the tap matrix x 40 channels, 16-byte cp.async)
// land in a ring in dynamic shared memory (three stages deep from p = 32
// on, two groups of KW below), one barrier a step. Operands are split into
// hi/lo as they are read into fragments. Every output is the sum of its
// terms in one fixed order: no atomics, and two calls give the same bits.
// Works for any ws (a whole halo slab of the moments would not fit shared
// memory beyond ws = 2).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kIn = 80;     // 8 source children x [m, s3, q6]
constexpr int kOut = 152;   // 8 target children x [A3, J6, H10]
constexpr int kNTiles = kOut / 8;
constexpr int kKc = 40;     // channels per stage
constexpr int kLdb = kKc + 4;  // B row stride (floats): conflict-free
                               // fragment loads (44 = 12 mod 32)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x = hi + lo: hi is x rounded to TF32 (10 mantissa bits, ties away from
// zero) by integer arithmetic, lo = x - hi exactly; the tensor cores
// ignore lo's low 13 bits, which loses at most 2^-10 |lo| <= 2^-21 |x|.
// sm_90 has no instruction for cvt.rna.tf32.f32, and its emulation cost
// more than the products.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Brick BX x BY x BZ of cells (z fastest); the 19 n8 output tiles split
// over NSPLIT blocks (gridDim.y) and, inside a block, over WN warps; KW
// warps split the stages among themselves (stage s to warp s % KW) and
// their sums meet at the end in a fixed order. The stages go through a
// ring of RING groups of KW slots in shared memory.
template <int BX, int BY, int BZ, int WN, int NSPLIT, int KW, int RING>
struct Tiling {
  static constexpr int kCells = BX * BY * BZ;
  static constexpr int kWm = kCells / 32;          // warps across cells
  static constexpr int kThreads = 32 * kWm * WN * KW;
  static constexpr int kNtb = (kNTiles + NSPLIT - 1) / NSPLIT;  // a block
  static constexpr int kNt = (kNtb + WN - 1) / WN;              // a warp
  static constexpr int kLda = kCells + 8;  // A channel stride: = 8 mod 32
  static constexpr int kStageFloats = kKc * kLda + 8 * kNtb * kLdb;
  static constexpr size_t kSmem =
      static_cast<size_t>(RING) * KW * kStageFloats * sizeof(float);
  static constexpr int kChStep = kThreads / kCells;  // staging
  static_assert(kCells % 32 == 0 && kKc % kChStep == 0, "tiling");
  static_assert(KW == 1 || (KW - 1) * kWm * WN * 32 * 2 * kNt * 4 <=
                               RING * KW * kStageFloats, "reduction space");
};

// The tap offsets along one axis whose shift keeps some of the brick's
// cells [b0, min(b0 + B, p)) inside [0, p): [lo, lo + count).
__device__ __forceinline__ int2 live_offsets(int b0, int B, int p, int ws) {
  const int hi_cell = (b0 + B < p ? b0 + B : p) - 1;
  const int lo = -ws > -hi_cell ? -ws : -hi_cell;
  const int hi = ws < p - 1 - b0 ? ws : p - 1 - b0;
  return make_int2(lo, hi - lo + 1);
}

template <int BX, int BY, int BZ, int WN, int NSPLIT, int KW, int RING>
__global__ void __launch_bounds__(
    Tiling<BX, BY, BZ, WN, NSPLIT, KW, RING>::kThreads, 1)
far_taps_mma_kernel(const float* __restrict__ mom,
                    const float* __restrict__ taps, float* __restrict__ out,
                    int p, int ws) {
  using T = Tiling<BX, BY, BZ, WN, NSPLIT, KW, RING>;
  extern __shared__ __align__(16) float smem[];
  const int pc = p * p * p;
  const int w1 = 2 * ws + 1;

  // this block's brick, its output tiles [nb0, nb1), and the taps that
  // reach the grid from it (a box of offsets; the others add zero)
  const int nby = (p + BY - 1) / BY, nbz = (p + BZ - 1) / BZ;
  const int bz0 = (blockIdx.x % nbz) * BZ;
  const int by0 = (blockIdx.x / nbz % nby) * BY;
  const int bx0 = (blockIdx.x / (nbz * nby)) * BX;
  const int nb0 = blockIdx.y * T::kNtb;
  const int nb1 = nb0 + T::kNtb < kNTiles ? nb0 + T::kNtb : kNTiles;
  const int2 ox = live_offsets(bx0, BX, p, ws);
  const int2 oy = live_offsets(by0, BY, p, ws);
  const int2 oz = live_offsets(bz0, BZ, p, ws);
  const int n_stages = ox.y * oy.y * oz.y * (kIn / kKc);
  const int n_groups = (n_stages + KW - 1) / KW;

  // staging: thread -> one cell of the brick, every kChStep-th channel
  const int tid = threadIdx.x;
  const int s_cell = tid % T::kCells;
  const int s_ch0 = tid / T::kCells;
  const int sx = bx0 + s_cell / (BY * BZ);
  const int sy = by0 + s_cell / BZ % BY;
  const int sz = bz0 + s_cell % BZ;

  // start the copies of group i (stages KW i .. KW i + KW - 1, those that
  // exist) into ring slots (i % RING) KW + q; every call commits one
  // cp.async group
  auto stage_group = [&](int i) {
    for (int q = 0; q < KW; ++q) {
      const int s = KW * i + q;
      if (s >= n_stages) break;
      float* sa = smem + ((i % RING) * KW + q) * T::kStageFloats;
      float* sb = sa + kKc * T::kLda;
      const int tl = s / (kIn / kKc);
      const int c0 = s % (kIn / kKc) * kKc;
      const int dx = ox.x + tl / (oy.y * oz.y);
      const int dy = oy.x + tl / oz.y % oy.y;
      const int dz = oz.x + tl % oz.y;
      const int t = ((dx + ws) * w1 + dy + ws) * w1 + dz + ws;
      const int x = sx + dx, y = sy + dy, z = sz + dz;
      const bool in = x >= 0 && x < p && y >= 0 && y < p && z >= 0 && z < p;
      const float* src = mom + (in ? (x * p + y) * p + z : 0);
#pragma unroll 2
      for (int c = s_ch0; c < kKc; c += T::kChStep) {
        cp_async4(sa + c * T::kLda + s_cell,
                  src + static_cast<size_t>(c0 + c) * pc, in);
      }
      const float* tb =
          taps + (static_cast<size_t>(t) * kOut + 8 * nb0) * kIn + c0;
      for (int j = tid; j < 8 * (nb1 - nb0) * (kKc / 4); j += T::kThreads) {
        const int row = j / (kKc / 4), c4 = j % (kKc / 4);
        cp_async16(sb + row * kLdb + 4 * c4, tb + row * kIn + 4 * c4);
      }
    }
    cp_async_commit();
  };

  // fragments: this warp's cells, output tiles and share of the stages
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int wm = warp % T::kWm, wn = warp / T::kWm % WN;
  const int kw = warp / (T::kWm * WN);
  const int cell0 = 32 * wm;      // first brick cell of the warp
  const int nt0 = wn * T::kNt;    // first output tile, block-relative

  float acc[2][T::kNt][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < T::kNt; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[m][n][r] = 0.f;

#pragma unroll
  for (int i = 0; i < RING - 1; ++i) stage_group(i);
  for (int i = 0; i < n_groups; ++i) {
    cp_async_wait<RING - 2>();  // group i has landed (this thread's copies)
    __syncthreads();  // ... everyone's; and group i - 1's slots are free
    stage_group(i + RING - 1);  // empty past the last group
    if (KW * i + kw < n_stages) {
      const float* sa = smem + ((i % RING) * KW + kw) * T::kStageFloats;
      const float* sb = sa + kKc * T::kLda;
      float part[2][T::kNt][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < T::kNt; ++n)
#pragma unroll
          for (int r = 0; r < 4; ++r) part[m][n][r] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kKc / 8; ++ks) {
        uint32_t ahi[2][4], alo[2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          // rows g, g+8 of the m tile; columns (channels) tq, tq+4
          const float* a = sa + (8 * ks + tq) * T::kLda + cell0 + 16 * m + g;
          split_tf32(a[0], ahi[m][0], alo[m][0]);
          split_tf32(a[8], ahi[m][1], alo[m][1]);
          split_tf32(a[4 * T::kLda], ahi[m][2], alo[m][2]);
          split_tf32(a[4 * T::kLda + 8], ahi[m][3], alo[m][3]);
        }
#pragma unroll
        for (int n = 0; n < T::kNt; ++n) {
          if (nb0 + nt0 + n < nb1) {
            // B[k = tq (+4)][n = g] = taps[t][o = 8 (nb0 + nt0 + n) + g][ch]
            const float* b = sb + (8 * (nt0 + n) + g) * kLdb + 8 * ks + tq;
            uint32_t bhi0, blo0, bhi1, blo1;
            split_tf32(b[0], bhi0, blo0);
            split_tf32(b[4], bhi1, blo1);
#pragma unroll
            for (int m = 0; m < 2; ++m)
              mma_tf32(part[m][n], ahi[m], blo0, blo1);
#pragma unroll
            for (int m = 0; m < 2; ++m)
              mma_tf32(part[m][n], alo[m], bhi0, bhi1);
#pragma unroll
            for (int m = 0; m < 2; ++m)
              mma_tf32(part[m][n], ahi[m], bhi0, bhi1);
          }
        }
      }
      // the tensor cores truncate as they accumulate: a stage's 15
      // products per output go into a fresh fragment, added to the total
      // with a rounded add
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < T::kNt; ++n)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[m][n][r] += part[m][n][r];
    }
  }
  cp_async_wait<0>();  // only empty groups remain; none left in flight

  if (KW > 1) {
    // the stage-split warps' sums, added in the order kw = 0, 1, ...
    __syncthreads();    // every warp is done with the ring
    float* red = smem;  // [kw - 1][warp (wm, wn)][value][lane]
    const int wmn = warp % (T::kWm * WN);
    constexpr int kVals = 2 * T::kNt * 4;
    if (kw > 0) {
      float* r = red + ((kw - 1) * T::kWm * WN + wmn) * kVals * 32 + lane;
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < T::kNt; ++n)
#pragma unroll
          for (int v = 0; v < 4; ++v)
            r[((m * T::kNt + n) * 4 + v) * 32] = acc[m][n][v];
    }
    __syncthreads();
    if (kw > 0) return;
    for (int k2 = 1; k2 < KW; ++k2) {
      const float* r =
          red + ((k2 - 1) * T::kWm * WN + wmn) * kVals * 32 + lane;
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < T::kNt; ++n)
#pragma unroll
          for (int v = 0; v < 4; ++v)
            acc[m][n][v] += r[((m * T::kNt + n) * 4 + v) * 32];
    }
  }

  // C fragment: rows g, g+8 (cells), columns 2tq, 2tq+1 (outputs)
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int l = cell0 + 16 * m + g + 8 * h;
      const int x = bx0 + l / (BY * BZ), y = by0 + l / BZ % BY,
                z = bz0 + l % BZ;
      if (x >= p || y >= p || z >= p) continue;
      const int c = (x * p + y) * p + z;
#pragma unroll
      for (int n = 0; n < T::kNt; ++n) {
        if (nb0 + nt0 + n < nb1) {
          const int o = 8 * (nb0 + nt0 + n) + 2 * tq;
          out[static_cast<size_t>(o) * pc + c] = acc[m][n][2 * h];
          out[static_cast<size_t>(o + 1) * pc + c] = acc[m][n][2 * h + 1];
        }
      }
    }
  }
}

template <int BX, int BY, int BZ, int WN, int NSPLIT, int KW, int RING>
int launch(const float* mom, const float* taps, float* out, int p, int ws,
           cudaStream_t stream) {
  using T = Tiling<BX, BY, BZ, WN, NSPLIT, KW, RING>;
  auto kernel = far_taps_mma_kernel<BX, BY, BZ, WN, NSPLIT, KW, RING>;
  // the opt-in above 48 KB of dynamic shared memory, once per device
  static bool opted_in[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= 64) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  if (!opted_in[device]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(T::kSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in[device] = true;
  }
  const dim3 grid(
      ((p + BX - 1) / BX) * ((p + BY - 1) / BY) * ((p + BZ - 1) / BZ),
      NSPLIT);
  kernel<<<grid, T::kThreads, T::kSmem, stream>>>(mom, taps, out, p, ws);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// taps must be 16-byte aligned (the wrapper checks).
extern "C" int nbt_far_taps(const float* mom, const float* taps, float* out,
                            int p, int ws, void* stream) {
  if (p < 1 || ws < 0 || (reinterpret_cast<uintptr_t>(taps) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p >= 32) return launch<4, 4, 8, 4, 1, 1, 3>(mom, taps, out, p, ws, s);
  if (p >= 16) return launch<2, 4, 4, 1, 4, 4, 2>(mom, taps, out, p, ws, s);
  // at most 64 blocks: twice the stage-splitting warps take a quarter off
  // these levels' time (PERF.md, K3 findings)
  return launch<2, 4, 4, 1, 4, 8, 2>(mom, taps, out, p, ws, s);
}
