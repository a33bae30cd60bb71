// The backward of the modulated deformable conv (kernel B3's backward) for
// Hopper, sm_90a: for every image b of a batch, in one launch,
//   G[b, p, k * C + c] = sum_o grad_out[b, p, o] * w_kc[k * C + c, o]
//   grad_mask[b, p, g, k]      = valid * sum_c G[c] * sample(c)
//   grad_offset[b, p, g, k, :] = valid * m * sum_c G[c] * d sample(c) / d(y, x)
//   grad_x[b, corner, c]      += valid * m * w_corner * G[c]  (when asked)
// with c over group g's channels, sample(c) the unmodulated bilinear sample
// of x at the tap's point and m the modulation. G is the columns' gradient
// of out[b, p, o] = sum cols_b[p, k * C + c] w_kc[k * C + c, o]; it never
// goes to device memory. The weight's and bias's gradients are plain
// products that the wrapper leaves to torch.matmul.
//
// Replaces what jax.grad computes through the XLA op
// c2matching_tpu/ops/deform_conv.py (modulated_deform_conv /
// _mdc_fast_single); the TPU side has no Pallas kernel for it. Its
// semantics: floor has zero derivative, so d fy / d y = 1; a sample outside
// -1 < y < H, -1 < x < W contributes nothing (the test comes before any
// float-to-int conversion, so offsets of 1e4 to 3e30 give exact zeros);
// corners outside the image are zeros, so they add nothing to the offset
// gradient and receive no grad_x. A bf16 x is read into f32; w_kc is f32
// (the wrapper rounds it to bf16 first for a bf16 x, as the forward does).
//
// What bounds it on this card. G is 2 * P * 9C * Co flops a DynAgg image
// (1.9 GFLOP at relu3 40 x 40 x 256 and at relu1 160 x 160 x 64), run as
// 3xTF32 on the tensor cores: three times that at 495 TFLOP/s, 0.10 ms a
// training DynAgg at batch 9. Beside it the corner dots gather four corners
// of every (pixel, tap, group) sample of x (16.6 M samples of 32 bytes a
// corner at relu1) and read and write every sample's offsets and mask
// (0.4 GB at relu1). Measured on the mma.sync kernel this replaces
// (scripts/bench_dcn_backward.py --roles), the products set the pace at
// relu3 (0.50 of 0.57 ms), the dots at relu1 (0.92 of 1.17 ms), and the two
// tie at relu2.
//
// Products: wgmma, the only way to Hopper's full tensor-core rate, as
// 3xTF32. Each f32 value splits into big = tf32(v) and small = tf32(v -
// big) (cvt.rna's rounding), and for each 8-deep step big*small +
// small*big + big*big accumulate; the products of a 32-deep stage (12
// wgmma) sum in a fresh accumulator that one rounded f32 add takes into
// the running sum, as kernel B1 does: the tensor cores truncate as they
// add, so the running sum never passes through them.
// - B is w_kc. For an f32 x, B1's split pass (split_kernel) writes it as
//   (big, small) TF32 arrays into scratch (9C x Co f32 each, at most 5.9
//   MB) before the kernel. TMA brings each stage's 64 x 32 box of both
//   arrays into shared memory (128-byte swizzle, zeros past 9C rows and
//   past Co), completing on an mbarrier, in a ring of up to 4 stages that
//   one producer warp keeps full. For a bf16 x the wrapper has rounded
//   w_kc to bf16, so it is its own big part and its small part is zero:
//   TMA reads w_kc itself, with no pass and no scratch, and the big*small
//   product, which would add exact zeros, is dropped.
// - A is the tile's grad_out rows (64 pixels x Co f32), brought by TMA in
//   32-deep boxes, double-buffered so that the next tile's rows land while
//   this one's are used (one buffer where two do not fit, Co > 256). wgmma
//   reads A from registers here: each thread loads its fragment of a
//   stage (4 steps x 4 values) from the swizzled box and splits it in
//   registers, so A needs no split copy in shared memory and is read once
//   for its three products. Holding A's split fragments for the whole depth
//   would take 256 registers a thread at Co = 256; a stage's take 32.
// A chunk is 64 consecutive columns of G in w_kc's row order, cut to whole
// samples: at relu1 one tap of all 8 groups. (Chunks of 128 columns
// measured 1.3x slower at relu1 in f32 and 1.1x faster at relu2 in bf16:
// one width keeps one path.)
//
// Design: one 512-thread block a SM walks units v = blockIdx.x, +
// gridDim.x, ...: a tile of 64 output pixels of one image and a run of its
// chunks (all of them, or an equal segment where that fills the card's
// last wave better). Blocks at work at once hold neighbouring tiles, so the
// corners they gather come from L2 (with the next task's loads issued
// ahead, 1.3x faster at relu1 than each block walking a contiguous share).
// - Warpgroup 0 (4 warps, setmaxnreg 152 registers) issues the products
//   of each chunk stage by stage: wait for the stage's ring slot, load and
//   split A's fragments, 12 (bf16: 8) wgmma m64n64k8 into a fresh
//   accumulator, wait, release the slot, add into the running sum (32 + 32
//   registers, 32 for the fragments). At the chunk's end it writes G (64 x
//   64 f32) into one of two shared buffers and arrives on its "full"
//   mbarrier. (Issuing a stage's products before waiting for the last
//   stage's, into a second accumulator, took 192 registers, spilled and
//   measured 1.8x slower in the products.)
// - Warp 4 is the producer: one thread issues every TMA load.
// - Warps 5-15 (352 threads, setmaxnreg 120 with warp 4) take the G of each
//   chunk into the corner dots: one thread, or 2-4 lanes with 4-channel
//   vectors, per (pixel, sample) task, G read from shared memory, the
//   lanes' four dots reduced by shuffles; the first lane writes the mask
//   and offset gradients (zeros for an invalid sample); grad_x, when
//   asked, by f32 atomics (4-channel vector atomics where the group
//   allows). A lane takes up to 2 (f32) or 4 (bf16) of the group's
//   4-channel vectors without grad_x, one with it. A thread decodes its
//   next task and loads that task's offsets and mask while its current
//   task's corners are in flight; divisions by the shape's extents are
//   multiplications by constants the host computes. Carrying two tasks at
//   once measured slower (the registers spill), and so did copying a
//   tile's offsets and masks into shared memory by bulk copies, and the
//   gradients out the same way (L1 lost the room the corners hit in), and
//   so did copying the next task's corners into shared memory by cp.async
//   while the current task's dots run, the tasks streamed across a unit's
//   chunks (f32: 1.26x slower at relu1, 1.10x at relu2, where the ring
//   lost two stages to the copies' 88 KB).
//   Then the threads arrive on the buffer's "empty" mbarrier. The
//   products of chunk n + 1 run while the dots take chunk n.
// Shared memory: A 2 x 64 x 4 Co bytes, the ring stages x pieces x 8 KB, G
// 2 x 18 KB; f32 relu1 (Co 64, 4 stages) 133 KiB, relu2 (Co 128, 4 stages)
// 165 KiB, relu3 (Co 256, 3 stages) 213 KiB; Co 320 keeps one A buffer.
// Every wait is bounded: a lost arrival ends the launch with an error
// instead of hanging the card.

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

constexpr int PT = 64;               // output pixels a tile: wgmma's rows
constexpr int N = 64;                // columns of G a chunk, at most
constexpr int THREADS = 512;
constexpr int CONSUMER_WARPS = 4;    // warpgroup 0: the products
constexpr int PRODUCER_WARP = 4;     // the TMA loads
constexpr int DOT_WARP0 = 5;         // warps 5-15: the corner dots
constexpr int DOT_THREADS = THREADS - 32 * DOT_WARP0;
// 128 x CONSUMER_REGS + 384 x OTHER_REGS = the block's 65536 registers
constexpr int CONSUMER_REGS = 152;
constexpr int OTHER_REGS = 120;
constexpr int KS = TMA_BOX_BYTES / 4;  // depth a stage: 32 f32
constexpr int A_BOX = PT * TMA_BOX_BYTES;  // a stage of a tile's grad_out
constexpr int B_BOX = N * TMA_BOX_BYTES;   // a stage of a chunk's w_kc part
constexpr int LDG = N + 8;           // G's row stride in words: a warp's
                                     // float2 stores hit distinct banks
constexpr int MAX_STAGES = 4;
constexpr int MAX_SMEM = 232448 - 256;  // beside the static barriers
constexpr int MAX_GROUP = 64;        // channels a group, at most
constexpr int MAX_CO = 320;
static_assert(DOT_THREADS % 32 == 0, "whole dot warps");
static_assert(128 * CONSUMER_REGS + (THREADS - 128) * OTHER_REGS <= 65536,
              "the block's registers");

// A measurement's switch, which the default build never sets
// (scripts/bench_dcn_backward.py --roles builds it): C2M_DCB_ROLE=1 runs
// the products alone (the dot warps only hand the buffers back), 2 the
// corner dots alone (no products; G is left unwritten). The gradients are
// then wrong; only the time is read.
#ifndef C2M_DCB_ROLE
#define C2M_DCB_ROLE 0
#endif

template <typename T>
__host__ __device__ constexpr int pieces() {
  return std::is_same<T, float>::value ? 2 : 1;
}

// the alignment slack, A's buffers, the ring and two G buffers
constexpr size_t smem_bytes(int pieces, int stages, int a_bufs, int n_ks) {
  return 1024 + static_cast<size_t>(a_bufs) * n_ks * A_BOX +
         static_cast<size_t>(stages) * pieces * B_BOX +
         2 * sizeof(float) * PT * LDG;
}
static_assert(smem_bytes(2, 2, 1, (MAX_CO + KS - 1) / KS) <= MAX_SMEM,
              "the widest grad_out rows fit with one A buffer");

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
  int cg;          // channels a group
  int n_ks;        // 32-deep stages of Co
  int stages;      // ring slots
  int a_bufs;      // A buffers (1 or 2)
  int ne;          // columns of G a chunk covers: 64 cut to whole samples
  int nsc;         // samples a chunk: ne / cg
  int n_chunks;    // chunks of an image's 9C columns
  int seg_chunks;  // chunks a unit: n_chunks / segments a tile
  int segs;        // segments a tile
  int tiles_img;   // 64-pixel tiles of an image
  int64_t units;   // (tile, segment) units of the batch
  Div by_nsc, by_g, by_wo, by_kw;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 4 channels from 16 (f32) or 8 (bf16) aligned bytes, through L1
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float d) {
  d += a.x * b.x;
  d += a.y * b.y;
  d += a.z * b.z;
  d += a.w * b.w;
  return d;
}

// The modulated weight of corner r (0: (y0, x0), 1: (y0, x0 + 1), 2:
// (y0 + 1, x0), 3: (y0 + 1, x0 + 1)) of a point with fractions (fy, fx).
__device__ __forceinline__ float corner_weight(float m, float fy, float fx,
                                               int r) {
  return m * (r < 2 ? 1.f - fy : fy) * (r % 2 ? fx : 1.f - fx);
}

// One corner-dot task: its sample's index in the offsets and masks, its
// pixel's row in G and its first column there, its group's first channel,
// its tap's point before the offset.
struct Task {
  int64_t idx;
  int pl, gcol, ch0;
  float by, bx;
  bool act;
};

// Task e (of n_tasks) of chunk n of the tile at pixel p0 of image b (rows
// pixels, the first at `first` in the batch's pixels): lane fastest, then
// the chunk's sample, then the pixel; column si * Cg of G is tap si / G,
// group si % G.
template <int LANES>
__device__ __forceinline__ Task decode(const Shape& s, int e, int n_tasks,
                                       int n, int ns, int p0, int rows,
                                       int64_t first) {
  Task t;
  const int sample = e / LANES;
  t.pl = fast_div(s.by_nsc, sample);
  const int j = sample - t.pl * s.nsc;
  // a task's lanes agree on every test
  t.act = e < n_tasks && t.pl < rows && j < ns;
  const int si = n * s.nsc + j;
  const int k = fast_div(s.by_g, si);
  const int gg = si - k * s.g;
  const int p = p0 + t.pl;
  const int py = fast_div(s.by_wo, p);
  const int ky = fast_div(s.by_kw, k);
  t.gcol = j * s.cg;
  t.ch0 = gg * s.cg;
  t.idx = ((first + t.pl) * s.g + gg) * s.k_taps + k;
  t.by = static_cast<float>(py * s.sh - s.ph) +
         static_cast<float>(ky * s.dh);
  t.bx = static_cast<float>((p - py * s.wo) * s.sw - s.pw) +
         static_cast<float>((k - ky * s.kw) * s.dw);
  return t;
}

// Where a task's point (y, x) falls: inside the image (valid), its
// fractions, its first corner's index in x and which corners lie inside.
struct Point {
  bool valid;
  bool ok[4];
  float fy, fx;
  int64_t corner;
};

__device__ __forceinline__ Point locate(const Task& q, float y, float x,
                                        int b, int h, int w, int c) {
  Point pt;
  pt.valid = q.act && y > -1.f && y < static_cast<float>(h) && x > -1.f &&
             x < static_cast<float>(w);
  pt.fy = pt.fx = 0.f;
  pt.corner = 0;
#pragma unroll
  for (int r = 0; r < 4; ++r) pt.ok[r] = false;
  if (pt.valid) {
    const float y0f = floorf(y);
    const float x0f = floorf(x);
    pt.fy = y - y0f;
    pt.fx = x - x0f;
    const int y0 = static_cast<int>(y0f);
    const int x0 = static_cast<int>(x0f);
    pt.ok[0] = y0 >= 0 && x0 >= 0;
    pt.ok[1] = y0 >= 0 && x0 + 1 < w;
    pt.ok[2] = y0 + 1 < h && x0 >= 0;
    pt.ok[3] = y0 + 1 < h && x0 + 1 < w;
    // only the corners inside the image are read
    pt.corner = ((static_cast<int64_t>(b) * h + y0) * w + x0) * c + q.ch0;
  }
  return pt;
}

// The corner dots of one task at point pt with modulation m. The first
// lane writes the sample's offset and mask gradients (zeros outside the
// image; each skipped when null); every lane adds grad_x.
template <typename T, bool VEC, int LANES>
__device__ __forceinline__ void corner_dots(
    const Task& q, const Point& pt, float m, const T* __restrict__ x,
    const float* gbuf, float* __restrict__ off_out,
    float* __restrict__ m_out, float* __restrict__ g_x, int w, int c, int cg,
    unsigned lane_mask) {
  const int lane = threadIdx.x & (LANES - 1);
  const bool valid = pt.valid;
  const float fy = pt.fy, fx = pt.fx;
  const int64_t corner = pt.corner;
  const bool* ok = pt.ok;
  // corner r's distance from corner 0, in values
  const int64_t row = static_cast<int64_t>(w) * c;
  auto step = [&](int r) { return (r & 1) * c + (r >> 1) * row; };
  const float* gp = gbuf + q.pl * LDG + q.gcol;
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  if constexpr (VEC) {
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int ch = 4 * lane; ch < cg; ch += 4 * LANES) {
      float4 cr[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        cr[r] = ok[r] ? load4(x + corner + ch + step(r)) : z;
      const float4 gv =
          valid ? *reinterpret_cast<const float4*>(gp + ch) : z;
#pragma unroll
      for (int r = 0; r < 4; ++r) d[r] = dot4(gv, cr[r], d[r]);
      if (g_x != nullptr && valid) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
          if (ok[r]) {
            const float sc = corner_weight(m, fy, fx, r);
            atomicAdd(reinterpret_cast<float4*>(g_x + corner + ch + step(r)),
                      make_float4(sc * gv.x, sc * gv.y, sc * gv.z,
                                  sc * gv.w));
          }
      }
    }
  } else if (valid) {
    for (int ch = lane; ch < cg; ch += LANES) {
      const float gv = gp[ch];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (ok[r]) {
          d[r] += gv * to_f32(x[corner + ch + step(r)]);
          if (g_x != nullptr)
            atomicAdd(g_x + (corner + ch + step(r)),
                      corner_weight(m, fy, fx, r) * gv);
        }
    }
  }
  if (!q.act) return;  // the task's lanes return together
#pragma unroll
  for (int o = LANES >> 1; o > 0; o >>= 1)
#pragma unroll
    for (int r = 0; r < 4; ++r) d[r] += __shfl_xor_sync(lane_mask, d[r], o);
  if (lane != 0) return;
  if (m_out != nullptr)
    m_out[q.idx] = valid ? (1.f - fy) * (1.f - fx) * d[0] +
                               (1.f - fy) * fx * d[1] +
                               fy * (1.f - fx) * d[2] + fy * fx * d[3]
                         : 0.f;
  if (off_out != nullptr) {
    // d/dy and d/dx of the four corner weights, times the corner dots
    const float gy = (1.f - fx) * (d[2] - d[0]) + fx * (d[3] - d[1]);
    const float gx = (1.f - fy) * (d[1] - d[0]) + fy * (d[3] - d[2]);
    *reinterpret_cast<float2*>(off_out + 2 * q.idx) =
        valid ? make_float2(m * gy, m * gx) : make_float2(0.f, 0.f);
  }
}

// The three (bf16: two) TF32 products of one 8-deep step into acc, the
// first with scale-d `first ? 0 : 1`.
template <int P>
__device__ __forceinline__ void step_products(float (&acc)[N / 2],
                                              const uint32_t (&big)[4],
                                              const uint32_t (&small)[4],
                                              uint64_t b_big, uint64_t b_small,
                                              bool first) {
  if constexpr (P == 2) {
    wgmma_tf32_rs_n64(acc, big, b_small, !first);
    wgmma_tf32_rs_n64(acc, small, b_big, 1);
  } else {
    wgmma_tf32_rs_n64(acc, small, b_big, !first);
  }
  wgmma_tf32_rs_n64(acc, big, b_big, 1);
}

// a_map covers grad_out as (Co, B * Ho * Wo, 1), boxes of 32 x 64; b_map
// w_kc's TF32 parts as (Co, 9C, pieces), boxes of 32 x 64.
// VEC: cg is a multiple of 4 and x is aligned for 4-channel loads; the
// LANES lanes of a task then take interleaved 4-channel vectors.
template <typename T, bool VEC, int LANES>
__global__ void __launch_bounds__(THREADS, 1)
mdc_backward_kernel(const __grid_constant__ CUtensorMap a_map,
                    const __grid_constant__ CUtensorMap b_map,
                    const T* __restrict__ x, const float* __restrict__ offset,
                    const float* __restrict__ mask,
                    float* __restrict__ g_offset, float* __restrict__ g_mask,
                    float* __restrict__ g_x, const Shape s) {
  constexpr int P = pieces<T>();
  constexpr int B_STAGE = P * B_BOX;
  __shared__ __align__(8) uint64_t full_bar[MAX_STAGES];
  __shared__ __align__(8) uint64_t empty_bar[MAX_STAGES];
  __shared__ __align__(8) uint64_t a_full[2], a_empty[2];
  __shared__ __align__(8) uint64_t g_full[2], g_empty[2];
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t smem0 = smem_addr(smem);
  const uint32_t a_s = (smem0 + 1023u) & ~1023u;   // A buffers, 1 KB aligned
  const uint32_t b_s = a_s + s.a_bufs * s.n_ks * A_BOX;   // the ring
  const uint8_t* a_ptr = smem + (a_s - smem0);
  float* g_s = reinterpret_cast<float*>(smem + (b_s - smem0) +
                                        s.stages * B_STAGE);
  const int n_samples = s.k_taps * s.g;      // samples a pixel
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_pix = s.ho * s.wo;

  if (threadIdx.x == 0) {
    for (int i = 0; i < s.stages; ++i) {
      mbar_init(smem_addr(&full_bar[i]), 1);
      mbar_init(smem_addr(&empty_bar[i]), CONSUMER_WARPS);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(smem_addr(&a_full[i]), 1);
      mbar_init(smem_addr(&a_empty[i]), CONSUMER_WARPS);
      mbar_init(smem_addr(&g_full[i]), 32 * CONSUMER_WARPS);
      mbar_init(smem_addr(&g_empty[i]), DOT_THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Every role walks the block's units v = blockIdx.x, + gridDim.x, ...:
  // chunks [c0, c0 + seg_chunks) of tile v / segs.
  if (warp < CONSUMER_WARPS) {
    // ------------------------------------------------ warpgroup 0: G
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        CONSUMER_REGS));
    const int g8 = lane >> 2;
    const int t4 = lane & 3;
    const int r0 = 16 * warp + g8;   // the thread's rows r0, r0 + 8
    float acc[N / 2], sum[N / 2];
    int ti = 0;
    int64_t step = 0;
    int q = 0;
    for (int64_t v = blockIdx.x; v < s.units; v += gridDim.x, ++ti) {
      const int c0 = static_cast<int>(v % s.segs) * s.seg_chunks;
      const int ab = ti % s.a_bufs;
      mbar_wait(smem_addr(&a_full[ab]), (ti / s.a_bufs) & 1);
      const uint8_t* a_tile = a_ptr + ab * s.n_ks * A_BOX;
      for (int n = c0; n < c0 + s.seg_chunks; ++n, ++q) {
        for (int ks = 0; ks < s.n_ks; ++ks, ++step) {
          const int slot = static_cast<int>(step % s.stages);
          mbar_wait(smem_addr(&full_bar[slot]),
                    static_cast<uint32_t>(step / s.stages) & 1);
#if C2M_DCB_ROLE != 2
          // the thread's A fragments of the stage's 4 steps: (row r0 or
          // r0 + 8, depth 8 kk + t4 or + 4) in the 128-byte swizzled box
          const uint8_t* box = a_tile + ks * A_BOX;
          uint32_t big[4][4], small[4][4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = r0 + 8 * (e & 1);
              const int chunk16 = (2 * kk + (e >> 1)) ^ (row & 7);
              const float a = *reinterpret_cast<const float*>(
                  box + row * TMA_BOX_BYTES + chunk16 * 16 + 4 * t4);
              split_tf32_int(__float_as_uint(a), big[kk][e], small[kk][e]);
            }
          const uint32_t slot_addr = b_s + slot * B_STAGE;
          const uint64_t b_big = sw128_desc(slot_addr);
          const uint64_t b_small = sw128_desc(slot_addr + (P - 1) * B_BOX);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            step_products<P>(acc, big[kk], small[kk], b_big + 2 * kk,
                             b_small + 2 * kk, kk == 0);
          wgmma_commit();
          wgmma_wait<0>();
          fence_operands(acc);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            fence_operands(big[kk]);
            fence_operands(small[kk]);
          }
#endif
          __syncwarp();
          if (lane == 0) mbar_arrive(smem_addr(&empty_bar[slot]));
#if C2M_DCB_ROLE != 2
          // one rounded f32 add a stage takes its products into the sum
#pragma unroll
          for (int i = 0; i < N / 2; ++i)
            sum[i] = ks == 0 ? acc[i] : sum[i] + acc[i];
#endif
        }
        // G of the chunk into buffer q & 1 once the dots are done with it:
        // sum[4j + 2h + e] is row r0 + 8h, column 8j + 2 t4 + e
        const int gb = q & 1;
        mbar_wait(smem_addr(&g_empty[gb]), ((q >> 1) & 1) ^ 1);
#if C2M_DCB_ROLE != 2
        float* gbuf = g_s + gb * PT * LDG;
#pragma unroll
        for (int j = 0; j < N / 8; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            *reinterpret_cast<float2*>(gbuf + (r0 + 8 * hh) * LDG + 8 * j +
                                       2 * t4) =
                make_float2(sum[4 * j + 2 * hh], sum[4 * j + 2 * hh + 1]);
#endif
        mbar_arrive(smem_addr(&g_full[gb]));
      }
      // the tile's A rows are no longer read
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_addr(&a_empty[ab]));
    }
  } else {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(OTHER_REGS));
    if (warp == PRODUCER_WARP) {
      // -------------------------------------------- warp 4: TMA loads
      if (lane != 0) return;
      auto load_a = [&](int64_t tile, int t_index) {
        const int ab = t_index % s.a_bufs;
        const uint32_t bar = smem_addr(&a_full[ab]);
        mbar_wait(smem_addr(&a_empty[ab]), ((t_index / s.a_bufs) & 1) ^ 1);
        mbar_expect_tx(bar, s.n_ks * A_BOX);
        const int b = static_cast<int>(tile / s.tiles_img);
        const int row =
            b * n_pix + static_cast<int>(tile % s.tiles_img) * PT;
        for (int ks = 0; ks < s.n_ks; ++ks)
          tma_load(a_s + (ab * s.n_ks + ks) * A_BOX, &a_map, bar, ks * KS,
                   row, 0);
      };
      int ti = 0;
      int64_t step = 0;
      load_a(blockIdx.x / s.segs, 0);
      for (int64_t v = blockIdx.x; v < s.units; v += gridDim.x, ++ti) {
        const int c0 = static_cast<int>(v % s.segs) * s.seg_chunks;
        const int64_t next = v + gridDim.x;
        const int steps = s.seg_chunks * s.n_ks;
        // the next unit's rows: into the other buffer once the consumers
        // have begun this unit (its ring is full), else after this unit
        const int a_at =
            s.a_bufs == 2 ? min(s.stages, steps) - 1 : steps - 1;
        for (int j = 0; j < steps; ++j, ++step) {
          const int slot = static_cast<int>(step % s.stages);
          const uint32_t bar = smem_addr(&full_bar[slot]);
          mbar_wait(smem_addr(&empty_bar[slot]),
                    (static_cast<uint32_t>(step / s.stages) & 1) ^ 1);
          mbar_expect_tx(bar, B_STAGE);
          const int col = (c0 + j / s.n_ks) * s.ne;
          const int k0 = (j % s.n_ks) * KS;
#pragma unroll
          for (int piece = 0; piece < P; ++piece)
            tma_load(b_s + slot * B_STAGE + piece * B_BOX, &b_map, bar, k0,
                     col, piece);
          if (j == a_at && next < s.units) load_a(next / s.segs, ti + 1);
        }
      }
    } else {
      // ---------------------------------- warps 5-15: the corner dots
      const int dt = threadIdx.x - 32 * DOT_WARP0;
      const unsigned lane_mask = ((1u << LANES) - 1u)
                                 << (lane & ~(LANES - 1));
      const int n_tasks = PT * s.nsc * LANES;
      int q = 0;
      for (int64_t v = blockIdx.x; v < s.units; v += gridDim.x) {
        const int64_t tile = v / s.segs;
        const int c0 = static_cast<int>(v % s.segs) * s.seg_chunks;
        const int b = static_cast<int>(tile / s.tiles_img);
        const int p0 = static_cast<int>(tile % s.tiles_img) * PT;
        const int rows = min(PT, n_pix - p0);
        const int64_t first = static_cast<int64_t>(b) * n_pix + p0;
        for (int n = c0; n < c0 + s.seg_chunks; ++n, ++q) {
          const int gb = q & 1;
          const uint32_t full = smem_addr(&g_full[gb]);
          const uint32_t parity = (q >> 1) & 1;
          bool waited = false;
#if C2M_DCB_ROLE != 1
          const float* gbuf = g_s + gb * PT * LDG;
          const int ns = min(s.nsc, n_samples - n * s.nsc);
          // the next task, decoded and its offsets and mask loaded while
          // the current task's corners are (two tasks ahead, or the stream
          // carried across chunks, or L1 asked for the next task's corners:
          // each measured slower)
          Task next = decode<LANES>(s, dt, n_tasks, n, ns, p0, rows, first);
          float2 o_next = make_float2(0.f, 0.f);
          float m_next = 0.f;
          if (next.act) {
            o_next =
                __ldg(reinterpret_cast<const float2*>(offset + 2 * next.idx));
            m_next = __ldg(mask + next.idx);
          }
          for (int e = dt; e < n_tasks; e += DOT_THREADS) {
            const Task cur = next;
            const float2 o = o_next;
            const float m = m_next;
            if (e + DOT_THREADS < n_tasks) {
              next = decode<LANES>(s, e + DOT_THREADS, n_tasks, n, ns, p0,
                                   rows, first);
              if (next.act) {
                o_next = __ldg(
                    reinterpret_cast<const float2*>(offset + 2 * next.idx));
                m_next = __ldg(mask + next.idx);
              }
            }
            const Point pt =
                locate(cur, cur.by + o.x, cur.bx + o.y, b, s.h, s.w, s.c);
            if (!waited) {
              mbar_wait(full, parity);
              waited = true;
            }
            corner_dots<T, VEC, LANES>(cur, pt, m, x, gbuf, g_offset, g_mask,
                                       g_x, s.w, s.c, s.cg, lane_mask);
          }
#endif
          // every thread takes the chunk's phase before it releases the
          // buffer, so no thread arrives twice in one phase
          if (!waited) mbar_wait(full, parity);
          mbar_arrive(smem_addr(&g_empty[gb]));
        }
      }
    }
  }
}

// The split w_kc's scratch (2 x 9C x Co f32, 4.7 MB at the relu3 DynAgg)
// comes from the library's own pool (hopper.cuh, scratch_pool).

template <typename T, bool VEC, int LANES>
cudaError_t run(const CUtensorMap& a_map, const CUtensorMap& b_map,
                const void* x, const void* offset, const void* mask,
                void* g_offset, void* g_mask, void* g_x, const Shape& s,
                size_t smem, cudaStream_t stream) {
  const auto kernel = mdc_backward_kernel<T, VEC, LANES>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // one block a SM, walking the units in turn
  int64_t blocks = sm_count();
  if (blocks > s.units) blocks = s.units;
  if (blocks < 1) blocks = 1;
  kernel<<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(
      a_map, b_map, static_cast<const T*>(x),
      static_cast<const float*>(offset), static_cast<const float*>(mask),
      static_cast<float*>(g_offset), static_cast<float*>(g_mask),
      static_cast<float*>(g_x), s);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* offset, const void* mask,
           const void* gout, const void* wkc, void* g_offset, void* g_mask,
           void* g_x, int batch, int h, int w, int c, int ho, int wo, int g,
           int kh, int kw, int sh, int sw, int ph, int pw, int dh, int dw,
           int co, void* stream) {
  const int64_t n_pix = static_cast<int64_t>(ho) * wo;
  if (batch < 1 || h < 1 || w < 1 || ho < 1 || wo < 1 || kh < 1 || kw < 1 ||
      g < 1 || c % g || c / g > MAX_GROUP || co < 1 || co % 4 ||
      co > MAX_CO || static_cast<int64_t>(batch) * n_pix > 0x7fffffffLL ||
      static_cast<int64_t>(kh) * kw * c > 0x7fffffffLL ||
      reinterpret_cast<uintptr_t>(gout) % 16 ||
      reinterpret_cast<uintptr_t>(wkc) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr int P = pieces<T>();
  Shape s;
  s.h = h;
  s.w = w;
  s.c = c;
  s.ho = ho;
  s.wo = wo;
  s.g = g;
  s.k_taps = kh * kw;
  s.kw = kw;
  s.sh = sh;
  s.sw = sw;
  s.ph = ph;
  s.pw = pw;
  s.dh = dh;
  s.dw = dw;
  s.cg = c / g;
  s.n_ks = (co + KS - 1) / KS;
  const int kc = s.k_taps * c;
  s.ne = N / s.cg * s.cg;
  s.nsc = s.ne / s.cg;
  s.n_chunks = (kc + s.ne - 1) / s.ne;
  s.tiles_img = static_cast<int>((n_pix + PT - 1) / PT);
  s.by_nsc = divider(s.nsc);
  s.by_g = divider(g);
  s.by_wo = divider(wo);
  s.by_kw = divider(kw);
  // a tile's chunks cut into equal segments (each unit loads its tile's
  // rows again): the fewest whose waves of units keep the card within
  // 2.5% as busy as the best cut does
  const int64_t tiles = static_cast<int64_t>(batch) * s.tiles_img;
  const int64_t slots = sm_count() > 0 ? sm_count() : 1;
  auto busy = [&](int segs) {
    const int64_t units = tiles * segs;
    return static_cast<double>(units) /
           (((units + slots - 1) / slots) * slots);
  };
  double best = 0.0;
  for (int segs = 1; segs <= s.n_chunks; ++segs)
    if (s.n_chunks % segs == 0 && busy(segs) > best) best = busy(segs);
  s.segs = s.n_chunks;
  for (int segs = s.n_chunks; segs >= 1; --segs)
    if (s.n_chunks % segs == 0 && busy(segs) >= best - 0.025) s.segs = segs;
  s.seg_chunks = s.n_chunks / s.segs;
  s.units = tiles * s.segs;
  // the deepest ring that fits, two A buffers before one
  s.stages = 0;
  for (int a_bufs = 2; a_bufs >= 1 && !s.stages; --a_bufs)
    for (int stages = MAX_STAGES; stages >= 2 && !s.stages; --stages)
      if (smem_bytes(P, stages, a_bufs, s.n_ks) <= MAX_SMEM) {
        s.stages = stages;
        s.a_bufs = a_bufs;
      }
  if (!s.stages) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(P, s.stages, s.a_bufs, s.n_ks);

  // f32: w_kc's (big, small) TF32 parts in scratch; bf16: w_kc itself
  cudaError_t err = cudaSuccess;
  void* parts = nullptr;
  if (P == 2) {
    cudaMemPool_t pool;
    err = scratch_pool(&pool);
    if (err == cudaSuccess)
      err = cudaMallocFromPoolAsync(&parts, 2 * sizeof(float) * kc * co,
                                    pool, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = split(wkc, parts, static_cast<int64_t>(kc) * co, st);
  }
  CUtensorMap a_map, b_map;
  if (err == cudaSuccess &&
      (!make_map<float>(&a_map, gout, co,
                        static_cast<int>(batch * n_pix), 1, PT) ||
       !make_map<float>(&b_map, P == 2 ? parts : wkc, co, kc, P, N)))
    err = cudaErrorInvalidValue;
  if (err == cudaSuccess) {
    const bool vec = s.cg % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T)) == 0;
#define C2M_RUN(VEC_, LANES_)                                                 \
  run<T, VEC_, LANES_>(a_map, b_map, x, offset, mask, g_offset, g_mask, g_x, \
                       s, smem, st)
    // Lanes a task: each takes up to 2 (f32) or 4 (bf16) of the group's
    // 4-channel vectors, or one when grad_x is asked (its atomics then
    // spread over the lanes). Measured at the training shapes: one lane
    // for relu1 and 2 for relu2 gave 5% (f32) and 17-24% (bf16) against
    // a lane a vector, and 1.4-2x slower with grad_x.
    const int vectors = s.cg / 4;
    const int per_lane = g_x ? 1 : (P == 2 ? 2 : 4);
    const int want = vectors / per_lane;
    err = !vec ? C2M_RUN(false, 1)
               : (want >= 4 ? C2M_RUN(true, 4)
                            : (want >= 2 ? C2M_RUN(true, 2)
                                         : C2M_RUN(true, 1)));
#undef C2M_RUN
  }
  const cudaError_t freed = parts ? cudaFreeAsync(parts, st) : cudaSuccess;
  return static_cast<int>(err != cudaSuccess ? err : freed);
}

}  // namespace

// x: (B, H, W, C) f32 or bf16; offset (B, Ho, Wo, G, K, 2) and mask
// (B, Ho, Wo, G, K) f32; grad_out (B, Ho, Wo, Co) f32; w_kc (K * C, Co) f32.
// Writes grad_offset and grad_mask (each skipped when null) and adds into
// grad_x (B, H, W, C) f32 when it is not null. Refuses
// (cudaErrorInvalidValue) groups wider than 64 channels, Co not a multiple
// of 4 or above 320, and grad_out or w_kc not 16-byte aligned.
#define C2M_BACKWARD_ENTRY(NAME, T)                                           \
  extern "C" int NAME(const void* x, const void* offset, const void* mask,    \
                      const void* gout, const void* wkc, void* g_offset,      \
                      void* g_mask, void* g_x, int batch, int h, int w,       \
                      int c, int ho, int wo, int g, int kh, int kw, int sh,   \
                      int sw, int ph, int pw, int dh, int dw, int co,         \
                      void* stream) {                                         \
    return launch<T>(x, offset, mask, gout, wkc, g_offset, g_mask, g_x,       \
                     batch, h, w, c, ho, wo, g, kh, kw, sh, sw, ph, pw, dh,   \
                     dw, co, stream);                                         \
  }

C2M_BACKWARD_ENTRY(c2m_mdc_backward_f32, float)
C2M_BACKWARD_ENTRY(c2m_mdc_backward_bf16, __nv_bfloat16)
