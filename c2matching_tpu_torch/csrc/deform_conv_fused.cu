// The modulated deformable conv's forward, fused (kernel B3F) for Hopper,
// sm_90a: for every output pixel p of a batch, in one launch,
//   out[p, o] = bias[o] + sum_{k, c} cols[p, k * C + c] w_kc[k * C + c, o]
//   cols[p, k * C + c] = mask[p, g, k] * bilinear(x_b[:, :, c], y, x)
// with g = c / (C / G), b the image of p and the sample point of B3's
// forward (deform_conv.cu): y = oy * sh - ph + (k / kw) * dh + dy, likewise
// x. The columns never reach device memory: they are formed in shared
// memory a tile at a time and contracted there on the tensor cores.
//
// Replaces the XLA formulation c2matching_tpu/ops/deform_conv.py
// (modulated_deform_conv / _mdc_fast_single: the gather, then the einsum
// with the weight), which the port ran as B3's forward writing the columns
// of each image to device memory and a torch.matmul after it (for a bf16 x
// through an f32 copy of the columns). The TPU side has no Pallas kernel
// for it.
//
// What bounds it on this card. The contraction is 2 * P * 9C * Co flops:
// 203 GFLOP a DynAgg of the batch-16 serving request (P = 16 x 128 x 84 at
// C = Co = 256, and the same at the two larger scales), 0.21 ms in bf16 at
// 989 TFLOP/s and 1.23 ms as 3xTF32 at 495. The bilinear sampling gathers
// four corners of every (pixel, tap, group) sample (199 M samples at relu1,
// 16 bytes a corner in bf16 and 32 in f32: 12.7 and 25.4 GB of gathers)
// and reads every sample's offsets and mask (2.4 GB at relu1). The
// corners come from L2 and L1, and their rate sets the pace: measured at
// the batch-16 DynAggs, ~4 TB/s of corner reads, 3.1 ms at bf16 relu1 and
// 6 ms at f32 relu1, where the products would take 0.07 and 0.41. Builds
// that left one role out read (products alone / columns alone / both, ms,
// block-coherent offsets): f32 relu3 1.82 / 2.49 / 3.53, f32 relu1 2.33 /
// 4.74 / 6.09, bf16 relu1 0.95 / 2.73 / 3.08: the columns set the pace,
// and in f32 the two roles overlap only in part. The columns B3 wrote
// (5.55 GB a bf16 batch, 11.1 GB f32) and the bf16 path's f32 copy of them
// are gone; so is the per-image loop.
//
// Products: wgmma with A from registers and B (the weight) from shared
// memory. f32 x: 3xTF32. Each f32 value splits into big = tf32(v) and
// small = tf32(v - big) (cvt.rna's rounding) and each 8-deep step
// accumulates big*small + small*big + big*big, as B1, B2 and the B3
// backward do. bf16 x: the columns are rounded to bf16, as B3 stores them,
// and the weight too (the wrapper rounds it), so one bf16 wgmma m64n64k16
// a 16-deep step with f32 accumulation is the very arithmetic of the
// columns path (bf16 x bf16 products, f32 sums). In both, the products of
// a stage (128 bytes of depth: 32 f32 or 64 bf16 channels) sum in a fresh
// accumulator that one rounded f32 add takes into the running sum: the
// tensor cores truncate as they add, so the running sum never passes
// through them.
//
// Design: B2's (dcn_window.cu) shape with B3's sampling. One 640-thread
// block a SM walks units u = blockIdx.x, + gridDim.x, ...: a tile of 128
// consecutive output pixels of the batch (an image's last tile runs on
// into the next image) and 64 or 128 output channels (COT; wider Co takes
// more units). A unit runs through stages (chunk j of 128 bytes of
// channels, tap k), a chunk through the nine taps so that consecutive
// stages read neighbouring corners (1.05-1.25x faster than a tap through
// the chunks). Each stage lives in one slot of a ring of three in shared
// memory that holds the stage's columns (128 pixels x 128 bytes, rows
// padded by 16 bytes) and the weight's boxes for it (a fourth slot took
// L1's room and measured up to 1.1x slower). Roles hand over on
// mbarriers; there is no block-wide barrier after the start.
// - A pass of its own (weight_kernel) writes w_kc once a call as the
//   stage boxes' operand, laid out (P, K, Co_pad, C_pad): K-major, wgmma's
//   B (N x k), zeros past C and Co; f32 as its (big, small) TF32 parts,
//   bf16 as is. The scratch (4.7 MB at the f32 relu3 DynAgg) comes from
//   hopper.cuh's pool.
// - Warpgroups 2-4 form the columns, with the registers the products
//   leave them (64 to 88 by configuration). Per stage they wait for the
//   slot's "empty" barrier, one thread asks TMA for the weight's boxes
//   (128-byte swizzle) on the slot's "full" barrier, and each thread
//   forms up to three 16-byte vectors of a pixel's row (4 f32 or 8 bf16
//   channels of one group): the sample point, validity, corner weights
//   and mask of its (pixel, tap, group) sample from the offsets and mask
//   it loaded while the last stage's corners were in flight (1.25x), then
//   the four corners by 16-byte loads of NHWC x, one to three vectors'
//   loads in flight together (sampler_ilp); the arithmetic per channel
//   is B3's (the weighted corners summed in order, then times the mask,
//   rounded to x's type), so the columns are B3's bit for bit; then each
//   arrives on "full".
// - Warpgroups 0-1 take 64 pixels each. Per stage: wait for "full",
//   ldmatrix the stage's A fragments from the columns (the padded rows
//   keep an ldmatrix's 8 rows on distinct banks; the same addresses give
//   tf32's m64n64k8 and bf16's m64n64k16 fragments), split them in
//   registers (f32), then per 64-column half the stage's wgmma into a
//   fresh accumulator, wait, one f32 add into the running sum; then
//   arrive on "empty". At the unit's end each adds the bias to its
//   64 x COT sums and writes them to the output, while the column warps
//   fill the ring for the next unit.
// Index math is 32-bit where every extent fits (x, the offsets, the
// output), else the 64-bit instantiation runs, as in B3. Every wait is
// bounded: a lost arrival ends the launch with an error instead of hanging
// the card.
//
// Semantics (c2matching_tpu/ops/deform_conv.py:60-67), as B3's: a tap is
// zero unless -1 < y < H and -1 < x < W, tested before any conversion to
// int, so huge or NaN offsets give exact zeros; corners outside the image
// contribute zero. Coordinates and weights are f32.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"
#include "mma.cuh"

namespace {

using namespace c2m;

constexpr int PIX = 128;              // output pixels a tile
constexpr int CONSUMER_WARPS = 8;     // warpgroups 0-1: the products
constexpr int COLUMN_THREADS = 384;   // warpgroups 2-4: the columns
constexpr int COLUMN_T0 = 32 * CONSUMER_WARPS;
constexpr int THREADS = COLUMN_T0 + COLUMN_THREADS;
// the registers a thread has at launch (the most the block allows)
constexpr int LAUNCH_REGS = 65536 / THREADS / 8 * 8;
constexpr int ROW_BYTES = TMA_BOX_BYTES + 16;   // a pixel's row of columns
constexpr int COL_BYTES = PIX * ROW_BYTES;
constexpr int VECS = TMA_BOX_BYTES / 16;        // 16-byte vectors a row
// vectors a column thread forms a stage
constexpr int NV = (VECS * PIX + COLUMN_THREADS - 1) / COLUMN_THREADS;
constexpr int ROW_STEP = COLUMN_THREADS / VECS;  // a thread's pixels apart
constexpr int STAGES = 3;   // ring slots
constexpr int MAX_SMEM = 232448 - 256;  // beside the static barriers
static_assert(PIX == 2 * 64, "two consumer warpgroups of 64 pixels");
static_assert(COLUMN_THREADS % VECS == 0, "a column thread's vector is fixed");
static_assert(COL_BYTES % 1024 == 0, "slots stay 1 KB aligned");

// pieces of the weight a stage (f32: its TF32 big and small parts), and
// channels a 16-byte vector of x
template <typename T>
__host__ __device__ constexpr int pieces() {
  return std::is_same<T, float>::value ? 2 : 1;
}
template <typename T>
__host__ __device__ constexpr int vec_channels() {
  return 16 / static_cast<int>(sizeof(T));
}
// channels a stage: one 128-byte TMA box of depth
template <typename T>
__host__ __device__ constexpr int stage_channels() {
  return TMA_BOX_BYTES / static_cast<int>(sizeof(T));
}

__host__ __device__ constexpr int slot_bytes(int pieces, int cot) {
  return pieces * cot * TMA_BOX_BYTES + COL_BYTES;
}
// the largest slot (f32's two weight parts at 128 output channels) fits
// the ring, so every configuration takes all three slots
static_assert(1024 + STAGES * slot_bytes(2, 128) <= MAX_SMEM,
              "the ring fits in shared memory");

// What setmaxnreg gives the products' warpgroups: their sums (NH x 32), a
// fresh accumulator (32), a stage's A fragments (f32: 16 and their small
// TF32 parts 16; bf16: 16) and ~20 for addresses and loop state. The
// column warpgroups take the rest of the block's registers: 64, 80, 72 and
// 88 a thread (f32 / bf16 at 128 / 64 output channels a tile).
template <typename T, int NH>
__host__ __device__ constexpr int consumer_regs() {
  return pieces<T>() == 2 ? (NH == 2 ? 144 : 120) : (NH == 2 ? 128 : 104);
}
template <typename T, int NH>
__host__ __device__ constexpr int sampler_regs() {
  return (THREADS * LAUNCH_REGS - 256 * consumer_regs<T, NH>()) /
         COLUMN_THREADS / 8 * 8;
}
// The vectors whose corner loads a column thread has in flight together
// (4 corners of 16 bytes each), as measured fastest at the batch-16
// DynAggs (one H100): bf16 all three of its stage's at 64 output channels
// a tile, two at 128; f32 one fewer (f32 relu1 5.9-6.6 ms at two against
// 6.6-7.6 at three, relu2 and relu3 3.5-4.0 at one against 3.7-4.3 at two).
template <typename T, int NH>
__host__ __device__ constexpr int sampler_ilp() {
  return (NH == 1 ? NV : 2) - (pieces<T>() == 2 ? 1 : 0);
}

// n / d for 0 <= n < 2^31 by a multiply and a shift (the multiplier m and
// shift s from the host): q = (umulhi(n, m) + n) >> s.
struct Div {
  uint32_t m, s;
};

Div divider(uint32_t d) {
  uint32_t s = 0;
  while ((1ull << s) < d) ++s;
  const uint64_t m = ((1ull << 32) * ((1ull << s) - d)) / d + 1;
  return {static_cast<uint32_t>(m), s};
}

__device__ __forceinline__ int fast_div(const Div& q, int n) {
  return static_cast<int>(
      (__umulhi(static_cast<uint32_t>(n), q.m) + static_cast<uint32_t>(n)) >>
      q.s);
}

struct Shape {
  int h, w, c, ho, wo, g, k_taps, kw, sh, sw, ph, pw, dh, dw;
  int cg, co;
  int m;          // output pixels of the batch
  int n_pix;      // output pixels an image
  int ch;         // stage-deep chunks of C
  int co_tiles;   // COT-wide tiles of Co
  int units;      // (pixel tile, Co tile) units
  Div by_npix, by_wo, by_kw, by_cg;
};

// w_kc (K * C, Co) f32 as the stage boxes' operand, out[piece][k][o][c] of
// (P, K, co_pad, c_pad) in T, zeros past C and Co: for f32 its TF32 parts
// (big, small), for bf16 the value itself (the wrapper rounded it to bf16,
// so the conversion is exact).
template <typename T>
__global__ void __launch_bounds__(SPLIT_THREADS)
weight_kernel(const float* __restrict__ wkc, T* __restrict__ out, int k_taps,
              int c, int co, int co_pad, int c_pad) {
  const int64_t n = static_cast<int64_t>(k_taps) * co_pad * c_pad;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * SPLIT_THREADS +
                   threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * SPLIT_THREADS) {
    const int cc = static_cast<int>(i % c_pad);
    const int o = static_cast<int>((i / c_pad) % co_pad);
    const int k = static_cast<int>(i / (static_cast<int64_t>(c_pad) * co_pad));
    const float v =
        cc < c && o < co
            ? wkc[(static_cast<int64_t>(k) * c + cc) * co + o]
            : 0.f;
    if constexpr (std::is_same<T, float>::value) {
      uint32_t big, small;
      split_tf32(__float_as_uint(v), big, small);
      out[i] = __uint_as_float(big);
      out[n + i] = __uint_as_float(small);
    } else {
      out[i] = __float2bfloat16(v);
    }
  }
}

// D (64 x 64, f32) = A (64 x 16 bf16, registers) * B (64 x 16, shared)^T +
// (scale_d ? D : 0): wgmma_tf32_rs_n64's layouts (hopper.cuh), A held as
// mma.sync m16n8k16 holds it: a[0] (row g, depth 2t, 2t + 1), a[1] (row
// g + 8), a[2] (row g, depth 2t + 8, 2t + 9), a[3] (row g + 8, depth
// 2t + 8, 2t + 9). B is K-major (no transpose).
__device__ __forceinline__ void wgmma_bf16_rs_n64(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t desc_b,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// One stage's products into sum[NH] (sum = acc where first): the A
// fragments of its 4 steps by ldmatrix from the columns at a_addr, then per
// 64-column half hh the steps' wgmma into a fresh accumulator with B from
// the weight's boxes at w_addr, wait, one f32 add.
template <typename T, int NH>
__device__ __forceinline__ void stage_products(float (&acc)[32],
                                               float (&sum)[NH][32],
                                               uint32_t a_addr,
                                               uint32_t w_addr, bool first) {
  constexpr int COT = 64 * NH;
  uint32_t a[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    ldmatrix_x4(a_addr + kk * 32, a[kk][0], a[kk][1], a[kk][2], a[kk][3]);
  if constexpr (pieces<T>() == 2) {
    uint32_t small[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32_int(a[kk][e], a[kk][e], small[kk][e]);
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) {
      const uint64_t b_big = sw128_desc(w_addr + hh * 64 * TMA_BOX_BYTES);
      const uint64_t b_small =
          sw128_desc(w_addr + (COT + hh * 64) * TMA_BOX_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_tf32_rs_n64(acc, a[kk], b_small + 2 * kk, kk != 0);
        wgmma_tf32_rs_n64(acc, small[kk], b_big + 2 * kk, 1);
        wgmma_tf32_rs_n64(acc, a[kk], b_big + 2 * kk, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(acc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        fence_operands(a[kk]);
        fence_operands(small[kk]);
      }
#pragma unroll
      for (int i = 0; i < 32; ++i)
        sum[hh][i] = first ? acc[i] : sum[hh][i] + acc[i];
    }
  } else {
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) {
      const uint64_t b = sw128_desc(w_addr + hh * 64 * TMA_BOX_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_bf16_rs_n64(acc, a[kk], b + 2 * kk, kk != 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(acc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_operands(a[kk]);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        sum[hh][i] = first ? acc[i] : sum[hh][i] + acc[i];
    }
  }
}

// word q of a 16-byte vector
__device__ __forceinline__ uint32_t word(const uint4& u, int q) {
  return q == 0 ? u.x : (q == 1 ? u.y : (q == 2 ? u.z : u.w));
}

// w_map covers the weight's operand as (c_pad, co_pad, P K), boxes of
// 128 bytes x COT.
template <typename T, typename I, int NH>
__global__ void __launch_bounds__(THREADS, 1)
mdc_fused_kernel(const __grid_constant__ CUtensorMap w_map,
                 const T* __restrict__ x, const float* __restrict__ offset,
                 const float* __restrict__ mask,
                 const float* __restrict__ bias, float* __restrict__ out,
                 const Shape s) {
  constexpr int P = pieces<T>();
  constexpr int COT = 64 * NH;
  constexpr int W_BYTES = P * COT * TMA_BOX_BYTES;
  constexpr int SLOT = slot_bytes(P, COT);
  constexpr int VC = vec_channels<T>();
  constexpr int KS = stage_channels<T>();
  constexpr int ILP = sampler_ilp<T, NH>();
  static_assert(256 * consumer_regs<T, NH>() +
                        COLUMN_THREADS * sampler_regs<T, NH>() <=
                    THREADS * LAUNCH_REGS,
                "the block's registers");
  __shared__ __align__(8) uint64_t full_bar[STAGES];
  __shared__ __align__(8) uint64_t empty_bar[STAGES];
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t smem0 = smem_addr(smem);
  const uint32_t ring = (smem0 + 1023u) & ~1023u;   // slots, 1 KB aligned
  uint8_t* ring_ptr = smem + (ring - smem0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_steps = s.k_taps * s.ch;   // stages a unit

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(smem_addr(&full_bar[i]), COLUMN_THREADS + 1);
      mbar_init(smem_addr(&empty_bar[i]), CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < CONSUMER_WARPS) {
    // ------------------------------------------ warpgroups 0-1: products
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        consumer_regs<T, NH>()));
    const int g8 = lane >> 2;
    const int t4 = lane & 3;
    // the lane's ldmatrix row address in a slot's columns (m16 x 16 bytes)
    const uint32_t a_off =
        W_BYTES + (16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1)) * ROW_BYTES +
        16 * (lane >> 4);
    float acc[32], sum[NH][32];
    int slot = 0;          // the ring slot of the stage, and its phase
    uint32_t phase = 0;
    for (int u = blockIdx.x; u < s.units; u += gridDim.x) {
      for (int st = 0; st < n_steps; ++st) {
        mbar_wait(smem_addr(&full_bar[slot]), phase);
        const uint32_t base = ring + slot * SLOT;
        stage_products<T, NH>(acc, sum, base + a_off, base, st == 0);
        __syncwarp();
        if (lane == 0) mbar_arrive(smem_addr(&empty_bar[slot]));
        if (++slot == STAGES) {
          slot = 0;
          phase ^= 1;
        }
      }
      // the unit's sums plus the bias: sum[hh][4j + 2h + e] is pixel
      // 16 warp + g8 + 8h of the tile, channel co0 + 64 hh + 8j + 2 t4 + e
      const int tile = u / s.co_tiles;
      const int co0 = u % s.co_tiles * COT;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = tile * PIX + 16 * warp + g8 + 8 * h;
        if (p >= s.m) continue;
        float* o = out + static_cast<I>(p) * s.co;
#pragma unroll
        for (int hh = 0; hh < NH; ++hh)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int oc = co0 + hh * 64 + 8 * j + 2 * t4;
            float v0 = sum[hh][4 * j + 2 * h];
            float v1 = sum[hh][4 * j + 2 * h + 1];
            if (bias != nullptr) {
              if (oc < s.co) v0 += __ldg(bias + oc);
              if (oc + 1 < s.co) v1 += __ldg(bias + oc + 1);
            }
            if (oc + 1 < s.co && !(s.co & 1)) {
              *reinterpret_cast<float2*>(o + oc) = make_float2(v0, v1);
            } else {
              if (oc < s.co) o[oc] = v0;
              if (oc + 1 < s.co) o[oc + 1] = v1;
            }
          }
      }
    }
  } else {
    // ---------------------------------- warpgroups 2-4: the columns
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        sampler_regs<T, NH>()));
    const int sid = threadIdx.x - COLUMN_T0;
    const int vec = sid % VECS;         // the thread's vector of a row
    const int row0 = sid / VECS;        // its first pixel of the tile
    // corner r's distance from corner 0, in values of x
    const I row_c = static_cast<I>(s.w) * s.c;
    // The offsets and masks of the thread's vectors of stage (unit uu, tap
    // kk, chunk jj), zeros for a vector past the tile, the batch or C.
    // Each stage loads the next stage's while its corners are in flight.
    auto fields = [&](int uu, int kk, int jj, float2 (&o)[NV],
                      float (&mk)[NV]) {
      const int pp0 = uu / s.co_tiles * PIX;
      const int cc = jj * KS + vec * VC;
      const int gi = cc < s.c ? fast_div(s.by_cg, cc) : 0;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int pl = row0 + i * ROW_STEP;
        const int p = pp0 + pl;
        o[i] = make_float2(0.f, 0.f);
        mk[i] = 0.f;
        if (uu < s.units && pl < PIX && p < s.m && cc < s.c) {
          const I om = (static_cast<I>(p) * s.g + gi) * s.k_taps + kk;
          o[i] = __ldg(reinterpret_cast<const float2*>(offset) + om);
          mk[i] = __ldg(mask + om);
        }
      }
    };
    float2 o_next[NV];
    float m_next[NV];
    fields(blockIdx.x, 0, 0, o_next, m_next);
    int slot = 0;          // the ring slot of the stage, and its phase
    uint32_t phase = 0;
    for (int u = blockIdx.x; u < s.units; u += gridDim.x) {
      const int co0 = u % s.co_tiles * COT;
      const int p0 = u / s.co_tiles * PIX;
      int k = 0;
      int j = 0;
      for (int st = 0; st < n_steps; ++st) {
        float2 o_cur[NV];
        float m_cur[NV];
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          o_cur[i] = o_next[i];
          m_cur[i] = m_next[i];
        }
        // the next stage's tap and chunk: a chunk of channels through the
        // taps, so that consecutive stages read neighbouring corners
        int k_next = k + 1, j_next = j;
        if (k_next == s.k_taps) {
          k_next = 0;
          ++j_next;
        }
        if (st + 1 == n_steps)
          fields(u + gridDim.x, 0, 0, o_next, m_next);
        else
          fields(u, k_next, j_next, o_next, m_next);
        const uint32_t full = smem_addr(&full_bar[slot]);
        mbar_wait(smem_addr(&empty_bar[slot]), phase ^ 1);
        if (sid == 0) {
          mbar_expect_tx(full, W_BYTES);
          const uint32_t base = ring + slot * SLOT;
#pragma unroll
          for (int piece = 0; piece < P; ++piece)
            tma_load(base + piece * COT * TMA_BOX_BYTES, &w_map, full, j * KS,
                     co0, piece * s.k_taps + k);
        }
        uint8_t* cols = ring_ptr + slot * SLOT + W_BYTES;
        // the thread's channels, their group, and the tap's point before
        // the offset
        const int cc = j * KS + vec * VC;
        const bool chan = cc < s.c;
        const int ky = fast_div(s.by_kw, k);
        const int kx = k - ky * s.kw;
#pragma unroll
        for (int i0 = 0; i0 < NV; i0 += ILP) {
          // per vector: its corner weights and mask (zeros for a sample
          // outside the image), the corners inside the image (a bit each)
          // and its first corner's index in x
          float wt[ILP][4];
          float mm[ILP];
          unsigned ok[ILP];
          I src[ILP];
#pragma unroll
          for (int i = 0; i < ILP; ++i) {
            const int pl = row0 + (i0 + i) * ROW_STEP;
            const int p = p0 + pl;
            mm[i] = 0.f;
            ok[i] = 0u;
            src[i] = 0;
#pragma unroll
            for (int r = 0; r < 4; ++r) wt[i][r] = 0.f;
            if (i0 + i < NV && pl < PIX && p < s.m && chan) {
              const int b = fast_div(s.by_npix, p);
              const int pix = p - b * s.n_pix;
              const int oy = fast_div(s.by_wo, pix);
              const int ox = pix - oy * s.wo;
              const float y = static_cast<float>(oy * s.sh - s.ph +
                                                 ky * s.dh) +
                              o_cur[i0 + i].x;
              const float xs = static_cast<float>(ox * s.sw - s.pw +
                                                  kx * s.dw) +
                               o_cur[i0 + i].y;
              if (y > -1.f && y < static_cast<float>(s.h) && xs > -1.f &&
                  xs < static_cast<float>(s.w)) {
                const float y0f = floorf(y);
                const float x0f = floorf(xs);
                const float fy = y - y0f;
                const float fx = xs - x0f;
                const int y0 = static_cast<int>(y0f);
                const int x0 = static_cast<int>(x0f);
                ok[i] = (y0 >= 0 && x0 >= 0 ? 1u : 0u) |
                        (y0 >= 0 && x0 + 1 < s.w ? 2u : 0u) |
                        (y0 + 1 < s.h && x0 >= 0 ? 4u : 0u) |
                        (y0 + 1 < s.h && x0 + 1 < s.w ? 8u : 0u);
                wt[i][0] = (1.f - fy) * (1.f - fx);
                wt[i][1] = (1.f - fy) * fx;
                wt[i][2] = fy * (1.f - fx);
                wt[i][3] = fy * fx;
                mm[i] = m_cur[i0 + i];
                // only the corners inside the image are read
                src[i] = ((static_cast<I>(b) * s.h + y0) * s.w + x0) * s.c +
                         cc;
              }
            }
          }
          uint4 cr[ILP][4];
#pragma unroll
          for (int i = 0; i < ILP; ++i)
#pragma unroll
            for (int r = 0; r < 4; ++r)
              cr[i][r] = (ok[i] >> r) & 1u
                             ? __ldg(reinterpret_cast<const uint4*>(
                                   x + src[i] + (r & 1) * s.c +
                                   (r >> 1) * row_c))
                             : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
          for (int i = 0; i < ILP; ++i) {
            const int pl = row0 + (i0 + i) * ROW_STEP;
            if (i0 + i >= NV || pl >= PIX) continue;
            // B3's arithmetic a channel: the weighted corners summed in
            // order, then times the mask, rounded to x's type
            uint32_t res[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const uint32_t wq[4] = {word(cr[i][0], q), word(cr[i][1], q),
                                      word(cr[i][2], q), word(cr[i][3], q)};
              if constexpr (VC == 4) {
                float v = 0.f;
#pragma unroll
                for (int r = 0; r < 4; ++r)
                  v += wt[i][r] * __uint_as_float(wq[r]);
                res[q] = __float_as_uint(v * mm[i]);
              } else {
                float lo = 0.f, hi = 0.f;
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                  lo += wt[i][r] * __uint_as_float(wq[r] << 16);
                  hi += wt[i][r] * __uint_as_float(wq[r] & 0xffff0000u);
                }
                const __nv_bfloat162 b2 =
                    __floats2bfloat162_rn(lo * mm[i], hi * mm[i]);
                res[q] = *reinterpret_cast<const uint32_t*>(&b2);
              }
            }
            *reinterpret_cast<uint4*>(cols + pl * ROW_BYTES + 16 * vec) =
                make_uint4(res[0], res[1], res[2], res[3]);
          }
        }
        mbar_arrive(full);
        if (++slot == STAGES) {
          slot = 0;
          phase ^= 1;
        }
        k = k_next;
        j = j_next;
      }
    }
  }
}

template <typename T, typename I, int NH>
cudaError_t run(const CUtensorMap& w_map, const void* x, const void* offset,
                const void* mask, const void* bias, void* out, const Shape& s,
                size_t smem, cudaStream_t stream) {
  const auto kernel = mdc_fused_kernel<T, I, NH>;
  // setmaxnreg.inc waits for registers that the column warps' dec frees:
  // the launch must give the block LAUNCH_REGS a thread, or it would wait
  // forever
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  if (attr.numRegs < LAUNCH_REGS) return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // one block a SM, walking the units in turn
  int64_t blocks = sm_count();
  if (blocks > s.units) blocks = s.units;
  if (blocks < 1) blocks = 1;
  kernel<<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(
      w_map, static_cast<const T*>(x), static_cast<const float*>(offset),
      static_cast<const float*>(mask), static_cast<const float*>(bias),
      static_cast<float*>(out), s);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* offset, const void* mask,
           const void* wkc, const void* bias, void* out, int batch, int h,
           int w, int c, int ho, int wo, int g, int kh, int kw, int sh, int sw,
           int ph, int pw, int dh, int dw, int co, void* stream) {
  constexpr int P = pieces<T>();
  constexpr int KS = stage_channels<T>();
  const int64_t m = static_cast<int64_t>(batch) * ho * wo;
  const int64_t taps = static_cast<int64_t>(kh) * kw;
  const int nh = co <= 64 ? 1 : 2;
  const int cot = 64 * nh;
  const int64_t co_tiles = (static_cast<int64_t>(co) + cot - 1) / cot;
  const int64_t units = (m + PIX - 1) / PIX * co_tiles;
  if (batch < 1 || h < 1 || w < 1 || ho < 1 || wo < 1 || kh < 1 || kw < 1 ||
      g < 1 || c < 1 || c % g || (c / g) % vec_channels<T>() || co < 1 ||
      // pixel and unit indices are 32-bit, a block's last step past the
      // end too
      m > 0x7fffffffLL - 2 * PIX || units > 0x7fffffffLL - 65536 ||
      taps * c > 0x7fffffffLL ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(offset) % 8 ||
      reinterpret_cast<uintptr_t>(out) % 8 || wkc == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  Shape s;
  s.h = h;
  s.w = w;
  s.c = c;
  s.ho = ho;
  s.wo = wo;
  s.g = g;
  s.k_taps = static_cast<int>(taps);
  s.kw = kw;
  s.sh = sh;
  s.sw = sw;
  s.ph = ph;
  s.pw = pw;
  s.dh = dh;
  s.dw = dw;
  s.cg = c / g;
  s.co = co;
  s.m = static_cast<int>(m);
  s.n_pix = ho * wo;
  s.ch = (c + KS - 1) / KS;
  s.co_tiles = static_cast<int>(co_tiles);
  s.units = static_cast<int>(units);
  s.by_npix = divider(s.n_pix);
  s.by_wo = divider(wo);
  s.by_kw = divider(kw);
  s.by_cg = divider(s.cg);
  const size_t smem = 1024 + static_cast<size_t>(STAGES) * slot_bytes(P, cot);
  // 32-bit indices hold every index: x's values (corners up to one row
  // past), the offsets' and the output's
  const int64_t n_x = (static_cast<int64_t>(batch) * h + 2) * w * c;
  const int64_t n_off = 2 * m * g * taps;
  const int64_t n_out = m * co;
  const bool narrow = n_x < (int64_t{1} << 31) && n_off < (int64_t{1} << 31) &&
                      n_out < (int64_t{1} << 31);

  // the weight's operand in scratch, rows of whole TMA boxes
  const int c_pad = s.ch * KS;
  const int co_pad = s.co_tiles * cot;
  const int64_t n = taps * co_pad * c_pad;
  void* parts = nullptr;
  cudaMemPool_t pool;
  cudaError_t err = scratch_pool(&pool);
  if (err == cudaSuccess)
    err = cudaMallocFromPoolAsync(&parts, P * sizeof(T) * n, pool, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  {
    const int64_t want = (n + SPLIT_THREADS - 1) / SPLIT_THREADS;
    const int64_t cap =
        static_cast<int64_t>(sm_count() > 0 ? sm_count() : 1) * 16;
    weight_kernel<T><<<static_cast<unsigned>(want < cap ? want : cap),
                       SPLIT_THREADS, 0, st>>>(
        static_cast<const float*>(wkc), static_cast<T*>(parts),
        s.k_taps, c, co, co_pad, c_pad);
    err = cudaGetLastError();
  }
  CUtensorMap w_map;
  if (err == cudaSuccess &&
      !make_map<T>(&w_map, parts, c_pad, co_pad, P * s.k_taps, cot))
    err = cudaErrorInvalidValue;
  if (err == cudaSuccess) {
#define C2M_RUN(I_, NH_) \
  run<T, I_, NH_>(w_map, x, offset, mask, bias, out, s, smem, st)
    err = narrow ? (nh == 1 ? C2M_RUN(int, 1) : C2M_RUN(int, 2))
                 : (nh == 1 ? C2M_RUN(int64_t, 1) : C2M_RUN(int64_t, 2));
#undef C2M_RUN
  }
  const cudaError_t freed = cudaFreeAsync(parts, st);
  return static_cast<int>(err != cudaSuccess ? err : freed);
}

}  // namespace

// x: (B, H, W, C) f32 or bf16; offset (B, Ho, Wo, G, K, 2) and mask
// (B, Ho, Wo, G, K) f32; w_kc (K * C, Co) f32 (for a bf16 x rounded to bf16
// by the caller); bias (Co,) f32 or null. Writes out (B, Ho, Wo, Co) f32.
// Refuses (cudaErrorInvalidValue) a group width off the 16-byte vectors
// (f32: 4 channels, bf16: 8), pixel or unit counts past 32-bit indices, x
// not 16-byte aligned, and offset or out not 8-byte aligned.
#define C2M_FUSED_ENTRY(NAME, T)                                              \
  extern "C" int NAME(const void* x, const void* offset, const void* mask,    \
                      const void* wkc, const void* bias, void* out,           \
                      int batch, int h, int w, int c, int ho, int wo, int g,  \
                      int kh, int kw, int sh, int sw, int ph, int pw, int dh, \
                      int dw, int co, void* stream) {                         \
    return launch<T>(x, offset, mask, wkc, bias, out, batch, h, w, c, ho, wo, \
                     g, kh, kw, sh, sw, ph, pw, dh, dw, co, stream);          \
  }

C2M_FUSED_ENTRY(c2m_mdc_fused_f32, float)
C2M_FUSED_ENTRY(c2m_mdc_fused_bf16, __nv_bfloat16)
