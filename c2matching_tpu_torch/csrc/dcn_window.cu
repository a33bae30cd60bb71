// Tent-weighted window contraction (kernel B2, forward) for Hopper, sm_90a.
//
// The windowed deformable conv has, for every aligned blk x blk output
// block b and tap k, one win x win window of the image at the origin
// (oy, ox) = origins[b, k]. This kernel turns the windows into the conv's
// output:
//   cols[p, k * C + c] = sum_wy sum_wx tent(ry - wy) tent(rx - wx) mm
//                        cell(b(p), k, wy, wx)[c]
//   out[p, o]          = sum_{k, c} cols[p, k * C + c] weight[k, c, o]
// with tent(d) = max(0, 1 - |d|), ry, rx, mm read at (group of c, k, p).
// A cell lives in one of two places (the template flag IMAGE):
// - image mode: x[oy + wy, ox + wx, :] of the (H, W, C) image, and 0.0
//   outside the image. Origins are clamped to [-2, H + 2 - win], so the
//   cells outside are exactly the 2-cell zero ring that the gather pads;
// - rows mode: rows[b, k, wy, wx * C + c], the windows gathered into a
//   buffer (ops/dcn_window.py, _window_gather).
// Both run the same body and the same sums and read a missing cell as 0.0,
// so on the same inputs they give the same bits.
//
// Replaces the Pallas kernel c2matching_tpu/ops/pallas/dcn_window_kernel.py
// (window_contract_pallas, body _kernel). It read gathered windows because
// Pallas on the TPU could not gather inside a kernel, evaluated every tent
// over all win x win cells on the VPU, and pre-expanded the fields to 128
// lanes because Mosaic cannot slice lanes below that. None of that holds
// here: image mode reads x at each window's origin, so no window buffer
// (1.8 GB in f32 at relu1) is written or read.
//
// What bounds it on this card: operations. At relu1 of the CUFED5 bucket
// (512 x 384 x 64, G = 8, blk 4, win 8) the weight contraction is 14.5
// GFLOP, as at relu2 (256 x 192 x 128, blk 2, win 6), while image mode must
// move 0.27 and 0.09 GB (x, the three fields, the weight, the output). So
// the contraction runs on the tensor cores, by wgmma, as 3xTF32: each f32
// value v splits into big = tf32(v) and small = tf32(v - big) (cvt.rna's
// rounding), and for each 8-channel step big*small + small*big + big*big
// accumulate. The products of a 32-channel stage (12 wgmma m64n64k8 a
// 64-column half) sum in a fresh accumulator that one rounded f32 add
// takes into the running sum, as B1 and the B3 backward do: the tensor
// cores truncate as they add, so the running sum never passes through
// them. The weight stays f32 whatever x's type.
//
// Design: one 640-thread block a SM walks units u = blockIdx.x,
// + gridDim.x, ...: a tile of 4 x 32 output pixels (PIX = 128) and 64 or
// 128 output channels (COT; wider Co takes more units). A unit runs
// through stages (tap k, 32-channel chunk j), each in one slot of a ring
// in shared memory; a slot holds the stage's columns (PIX x 32 f32, rows
// padded to 36 words) and the weight's TF32 parts for it. The roles run
// in warps of their own and hand over on mbarriers; there is no
// block-wide barrier after the start.
// - A pass of its own (split_weight_kernel) writes the weight once a call
//   as (big, small) TF32 parts, laid out (2, K, Co_pad, C_pad): K-major,
//   wgmma's B (N x k), zeros past C and Co, rows of whole 128-byte TMA
//   boxes. The scratch (1.2 MB at relu2) comes from hopper.cuh's pool.
// - Warpgroups 2-4 (setmaxnreg 64) form the columns. Per stage they wait
//   for the slot's "empty" barrier, one thread asks TMA for the weight's
//   two 32 x COT boxes (128-byte swizzle) on the slot's "full" barrier,
//   and each thread forms up to three 4-channel vectors: 8 lanes on the 8
//   vectors of a pixel's chunk (16 bytes of f32, 8 of bf16: a cell's chunk
//   read as one line), the tents and then the cells of two vectors loaded
//   together, at most the 2 x 2 cells whose weight is not zero read; then
//   each arrives on "full".
// - Warpgroups 0-1 (setmaxnreg 144) take 64 pixels each. Per stage: wait
//   for "full", ldmatrix the stage's A fragments (m16n8k8's layout) from
//   the columns (the padded rows keep the 8 rows of an ldmatrix on
//   distinct banks), split them in registers (split_tf32_int), then per
//   64-column half 12 wgmma m64n64k8 with A from registers and B from the
//   slot, wait, one f32 add into the running sum; then arrive on "empty".
//   The two warpgroups' products cover each other's waits. As a tap's
//   products begin they also write the tents and first cell of every
//   (pixel, group) of the tap two on, into one of three buffers the
//   columns read (the lanes of a warp on 32 neighbouring pixels of one
//   group, swizzled so that neither these writes nor the columns' reads
//   conflict on banks), from fields that cp.async brought to shared memory
//   four taps ahead, so no tent waits for a load. At the unit's end each
//   writes its 64 x COT sums to the output.
// Measured (scripts/bench_window.py, one H100): the sampling, not the
// products, set the pace of the first builds. It is latency-bound (the
// cells come from L2): loading two vectors' cells at once took the
// columns 1.4x, and 12 column warps beat 8 by 1.14x. The tents cost the
// column warps ~20% of their time and two barriers a tap; in a warpgroup
// of their own (4 warps) they were slower still, as an instruction stream
// of one warp a scheduler; in the products' warps, fed by cp.async two
// taps ahead of the columns, they are cheapest. Ring depth (2-6 slots),
// splitting the weight in shared memory instead of the pass, loading it
// once a block, and the products' warpgroups taking turns on the tents
// (they spill at Co 128) changed nothing or lost: neither the weight's L2
// traffic nor the carve-out left to L1 is the limit.
// Every wait is bounded: a lost arrival ends the launch with an error
// instead of hanging the card.
// For any ry and rx this gives what the dense formula gives: every cell the
// kernel skips has a zero tent there.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"
#include "mma.cuh"

namespace {

using namespace c2m;

// A measurement's switch, which the default build never sets
// (scripts/bench_window.py --roles builds it): C2M_B2_ROLE=1 leaves out
// the columns (the products, with the tents their warps write), 2 the
// products (the tents and the columns). The output is then wrong; only the
// time is read.
#ifndef C2M_B2_ROLE
#define C2M_B2_ROLE 0
#endif

constexpr int TR = 4;             // output rows per tile
constexpr int TW = 32;            // output columns per tile
constexpr int PIX = TR * TW;      // output pixels per tile
constexpr int CONSUMER_WARPS = 8;   // warpgroups 0-1: the products
// a tap's tents are written by the products' two warpgroups; the columns
// by the three warpgroups after them
constexpr int TENT_THREADS = 256;
constexpr int COLUMN_THREADS = 384;
constexpr int COLUMN_T0 = 32 * CONSUMER_WARPS;
constexpr int THREADS = COLUMN_T0 + COLUMN_THREADS;
// the registers a thread has at launch (the most the block allows), and
// what setmaxnreg moves from the sampling warpgroups to the products
constexpr int LAUNCH_REGS = 65536 / THREADS / 8 * 8;
constexpr int SAMPLER_REGS = 64;
constexpr int CONSUMER_REGS =
    (THREADS * LAUNCH_REGS - (THREADS - 256) * SAMPLER_REGS) / 256 / 8 * 8;
constexpr int KS = TMA_BOX_BYTES / 4;  // channels a stage: 32 f32
constexpr int LDA = KS + 4;       // the columns' row stride in words
constexpr int COL_BYTES = PIX * LDA * 4;
constexpr int MAX_STAGES = 4;
constexpr int MAX_SMEM = 232448 - 256;  // beside the static barriers
constexpr int MAX_C = 512;        // the widest image (the op serves 64, 128)
// tents of up to three taps in flight; the (pixel, group) items a tent
// thread loads at once: a tap's 8 groups in one go
constexpr int MAX_TENT_BUFS = 3;
constexpr int TB = 8 * PIX / TENT_THREADS;
// taps whose fields are in flight to shared memory ahead of their tents,
// at most, and a tap's staged fields (three of TB items a tent thread, its
// origin)
constexpr int MAX_AHEAD = 4;
constexpr int FIELD_STAGE_BYTES = (3 * TB * 4 + 8) * TENT_THREADS;
// 4-channel column vectors a column thread forms a stage (32 channels a
// pixel), ILP of them with their loads in flight together
constexpr int NV = (8 * PIX + COLUMN_THREADS - 1) / COLUMN_THREADS;
constexpr int ILP = 2;
static_assert(PIX == 2 * 64, "two consumer warpgroups of 64 pixels");
static_assert(TENT_THREADS % PIX == 0 && COLUMN_THREADS % 32 == 0,
              "a tent thread's pixel, a column thread's vector and channel "
              "in a chunk are fixed");
static_assert(256 * CONSUMER_REGS + (THREADS - 256) * SAMPLER_REGS <=
                  THREADS * LAUNCH_REGS &&
                  CONSUMER_REGS >= 144,
              "the block's registers");
static_assert(COL_BYTES % 1024 == 0, "slots stay 1 KB aligned");

// a slot: the weight's big and small boxes (COT rows of 128 bytes each),
// then the columns
__host__ __device__ constexpr int w_bytes(int cot) {
  return 2 * cot * TMA_BOX_BYTES;
}
__host__ __device__ constexpr int slot_bytes(int cot) {
  return w_bytes(cot) + COL_BYTES;
}

// the alignment slack, the ring, the tents and first cell of every
// (pixel, group) of tent_bufs taps, and the staged fields of ahead taps
size_t smem_bytes(int stages, int cot, int g, int tent_bufs, int ahead) {
  return 1024 + static_cast<size_t>(stages) * slot_bytes(cot) +
         static_cast<size_t>(tent_bufs) * PIX * g *
             (sizeof(float4) + sizeof(int)) +
         static_cast<size_t>(ahead) * FIELD_STAGE_BYTES;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 4 channels from 16 (f32) or 8 (bf16) aligned bytes
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

// One column value from its 2 x 2 cells; both modes and both channel paths
// take this order of operations
__device__ __forceinline__ float tent_sum(float v00, float v01, float v10,
                                          float v11, const float4& t) {
  const float s0 = fmaf(v01, t.w, v00 * t.z);
  const float s1 = fmaf(v11, t.w, v10 * t.z);
  return fmaf(s1, t.y, s0 * t.x);
}

struct Shape {
  int k_taps, blk, win, c, g, co, nbx, h, w;
  int ho, wo, ntx;   // output extent, tiles a tile row
  int ch;            // 32-channel chunks of C
  int co_tiles;      // COT-wide tiles of Co
  int stages;        // ring slots
  int tent_bufs;     // taps of tents in shared memory (1 to 3)
  int ahead;         // taps of staged fields (1 to MAX_AHEAD)
  int units;         // (pixel tile, Co tile) units
};

// The weight (K, C, ldw) f32 as TF32 parts out[piece][k][o][c] of
// (2, K, co_pad, c_pad), zeros past C and Co.
__global__ void __launch_bounds__(SPLIT_THREADS)
split_weight_kernel(const float* __restrict__ weight, float* __restrict__ out,
                    int k_taps, int c, int co, int ldw, int co_pad,
                    int c_pad) {
  const int64_t n = static_cast<int64_t>(k_taps) * co_pad * c_pad;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * SPLIT_THREADS +
                   threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * SPLIT_THREADS) {
    const int cc = static_cast<int>(i % c_pad);
    const int o = static_cast<int>((i / c_pad) % co_pad);
    const int k = static_cast<int>(i / (static_cast<int64_t>(c_pad) * co_pad));
    const float v =
        cc < c && o < co
            ? weight[(static_cast<int64_t>(k) * c + cc) * ldw + o]
            : 0.f;
    uint32_t big, small;
    split_tf32(__float_as_uint(v), big, small);
    out[i] = __uint_as_float(big);
    out[n + i] = __uint_as_float(small);
  }
}

// The three TF32 products of one 8-channel step into acc, the first with
// scale-d `first ? 0 : 1`.
__device__ __forceinline__ void step_products(float (&acc)[32],
                                              const uint32_t (&big)[4],
                                              const uint32_t (&small)[4],
                                              uint64_t b_big, uint64_t b_small,
                                              bool first) {
  wgmma_tf32_rs_n64(acc, big, b_small, !first);
  wgmma_tf32_rs_n64(acc, small, b_big, 1);
  wgmma_tf32_rs_n64(acc, big, b_big, 1);
}

// A tent thread's share of a tap's tents in batch b: the fields of its
// (pixel, group) items e = tid + (b TB + i) TENT_THREADS (a thread's pixel
// is fixed), and in image mode their block's origin for the tap.
struct TentFields {
  float ry[TB], rx[TB], mm[TB];
  int2 org;
};

// A tent thread's pixel in unit u: its index in the output, its block's,
// and whether it lies inside the output (a ragged tile's may not). Worked
// out once a unit, not once a tap.
struct TentPix {
  int pix, bl;
  bool in;
};

__device__ __forceinline__ TentPix tent_pix(const Shape& s, int u, int tid) {
  const int pl = tid % PIX;
  const int tile = u / s.co_tiles;
  const int y = (tile / s.ntx) * TR + pl / TW;
  const int x = (tile % s.ntx) * TW + pl % TW;
  TentPix q;
  q.in = y < s.ho && x < s.wo;
  q.pix = q.in ? y * s.wo + x : 0;
  q.bl = q.in ? (y / s.blk) * s.nbx + x / s.blk : 0;
  return q;
}

// The fields of batch b of tap k for tent thread tid at pixel q; zeros past
// the image.
template <bool IMAGE>
__device__ __forceinline__ void load_fields(TentFields& f, const Shape& s,
                                            const int* __restrict__ origins,
                                            const float* __restrict__ fry,
                                            const float* __restrict__ frx,
                                            const float* __restrict__ fmm,
                                            int tid, const TentPix& q, int k,
                                            int b) {
  const int64_t n_pix = static_cast<int64_t>(s.ho) * s.wo;
  if constexpr (IMAGE) {
    f.org = make_int2(0, 0);
    if (q.in)
      f.org = __ldg(reinterpret_cast<const int2*>(origins) +
                    static_cast<int64_t>(q.bl) * s.k_taps + k);
  }
#pragma unroll
  for (int i = 0; i < TB; ++i) {
    const int gi = tid / PIX + (b * TB + i) * (TENT_THREADS / PIX);
    f.ry[i] = f.rx[i] = f.mm[i] = 0.f;
    if (q.in && gi < s.g) {
      const int64_t e =
          (static_cast<int64_t>(gi) * s.k_taps + k) * n_pix + q.pix;
      f.ry[i] = __ldg(fry + e);
      f.rx[i] = __ldg(frx + e);
      f.mm[i] = __ldg(fmm + e);
    }
  }
}

// The tents and first cell of batch b's items from the loaded fields, into
// tent_s and idx_s. The first cell of each axis is floor(r) clamped to
// [-2, win] before the conversion to int (huge coordinates stay in int
// range, and a clamped cell and the one after it are outside the window);
// the tents there and one cell on are zero for cells outside the window
// and, in image mode, for cells outside the image (rows mode reads 0.0
// there, which gives the same sums); the x-tents are times the modulation.
// A ragged tile's missing pixels get zero tents. The groups' order is
// swizzled by the pixel (G a power of two), so that 8 neighbouring pixels
// of one group and 8 groups of one pixel both hit distinct banks.
template <bool IMAGE>
__device__ __forceinline__ void store_tents(const TentFields& f,
                                            const Shape& s, float4* tent_s,
                                            int* idx_s, int tid,
                                            const TentPix& q, int k, int b) {
  const int pl = tid % PIX;
  const float fwin = static_cast<float>(s.win);
  const int swz = (s.g & (s.g - 1)) == 0 ? s.g - 1 : 0;
#pragma unroll
  for (int i = 0; i < TB; ++i) {
    const int gi = tid / PIX + (b * TB + i) * (TENT_THREADS / PIX);
    if (gi >= s.g) continue;
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    int idx = 0;
    if (q.in) {
      const float ry = f.ry[i];
      const float rx = f.rx[i];
      const float m = f.mm[i];
      const float y0f = fminf(fmaxf(floorf(ry), -2.f), fwin);
      const float x0f = fminf(fmaxf(floorf(rx), -2.f), fwin);
      const int y0 = static_cast<int>(y0f);
      const int x0 = static_cast<int>(x0f);
      t.x = y0 >= 0 && y0 < s.win ? fmaxf(0.f, 1.f - fabsf(ry - y0f)) : 0.f;
      t.y = y0 + 1 >= 0 && y0 + 1 < s.win
                ? fmaxf(0.f, 1.f - fabsf(ry - (y0f + 1.f)))
                : 0.f;
      t.z = x0 >= 0 && x0 < s.win ? fmaxf(0.f, 1.f - fabsf(rx - x0f)) * m
                                  : 0.f;
      t.w = x0 + 1 >= 0 && x0 + 1 < s.win
                ? fmaxf(0.f, 1.f - fabsf(rx - (x0f + 1.f))) * m
                : 0.f;
      if constexpr (IMAGE) {
        const int iy = f.org.x + y0;
        const int ix = f.org.y + x0;
        if (iy < 0 || iy >= s.h) t.x = 0.f;
        if (iy + 1 < 0 || iy + 1 >= s.h) t.y = 0.f;
        if (ix < 0 || ix >= s.w) t.z = 0.f;
        if (ix + 1 < 0 || ix + 1 >= s.w) t.w = 0.f;
        idx = iy * s.w + ix;
      } else {
        idx = static_cast<int>(
            ((static_cast<int64_t>(q.bl) * s.k_taps + k) * s.win + y0) *
                s.win +
            x0);
      }
    }
    const int sl = pl * s.g + (gi ^ (pl & swz));
    tent_s[sl] = t;
    idx_s[sl] = idx;
  }
}

// 4 or 8 bytes global -> shared, asynchronously; src_bytes = 0 writes zeros
// and reads nothing
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// waits until at most n (0 to MAX_AHEAD - 1) of the thread's committed
// groups are pending
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// Tent thread tid's batch-0 fields of tap k at pixel q, and in image mode
// its block's origin, copied to the stage at dst (zeros past the image)
// without passing through registers: the copies of up to MAX_AHEAD taps fly
// at once.
template <bool IMAGE>
__device__ __forceinline__ void stage_fields(uint32_t dst, const Shape& s,
                                             const int* __restrict__ origins,
                                             const float* __restrict__ fry,
                                             const float* __restrict__ frx,
                                             const float* __restrict__ fmm,
                                             int tid, const TentPix& q,
                                             int k) {
  // item i is group tid / PIX + i (TENT_THREADS / PIX): its fields lie
  // i (TENT_THREADS / PIX) K n_pix values past item 0's
  const int64_t n_pix = static_cast<int64_t>(s.ho) * s.wo;
  const int64_t e0 =
      (static_cast<int64_t>(tid / PIX) * s.k_taps + k) * n_pix + q.pix;
  const int64_t step = (TENT_THREADS / PIX) * s.k_taps * n_pix;
#pragma unroll
  for (int i = 0; i < TB; ++i) {
    const int gi = tid / PIX + i * (TENT_THREADS / PIX);
    const bool ok = q.in && gi < s.g;
    const int64_t e = ok ? e0 + i * step : 0;
    cp_async4(dst + ((0 * TB + i) * TENT_THREADS + tid) * 4, fry + e,
              ok ? 4 : 0);
    cp_async4(dst + ((1 * TB + i) * TENT_THREADS + tid) * 4, frx + e,
              ok ? 4 : 0);
    cp_async4(dst + ((2 * TB + i) * TENT_THREADS + tid) * 4, fmm + e,
              ok ? 4 : 0);
  }
  if constexpr (IMAGE)
    cp_async8(dst + 3 * TB * TENT_THREADS * 4 + tid * 8,
              origins + 2 * (static_cast<int64_t>(q.bl) * s.k_taps + k),
              q.in ? 8 : 0);
}

// Tent thread tid's staged fields into registers.
template <bool IMAGE>
__device__ __forceinline__ void read_staged(TentFields& f,
                                            const uint8_t* stage, int tid) {
  const float* fs = reinterpret_cast<const float*>(stage);
#pragma unroll
  for (int i = 0; i < TB; ++i) {
    f.ry[i] = fs[(0 * TB + i) * TENT_THREADS + tid];
    f.rx[i] = fs[(1 * TB + i) * TENT_THREADS + tid];
    f.mm[i] = fs[(2 * TB + i) * TENT_THREADS + tid];
  }
  if constexpr (IMAGE)
    f.org = reinterpret_cast<const int2*>(fs + 3 * TB * TENT_THREADS)[tid];
}

// w_map covers the split weight as (c_pad, co_pad, 2K), boxes of 32 x COT.
template <typename T, bool IMAGE, int NH>
__global__ void __launch_bounds__(THREADS, 1)
window_contract_kernel(const __grid_constant__ CUtensorMap w_map,
                       const T* __restrict__ src,
                       const int* __restrict__ origins,
                       const float* __restrict__ fry,
                       const float* __restrict__ frx,
                       const float* __restrict__ fmm,
                       float* __restrict__ out, const Shape s) {
  constexpr int COT = 64 * NH;
  constexpr int W_BYTES = w_bytes(COT);
  constexpr int SLOT = slot_bytes(COT);
  __shared__ __align__(8) uint64_t full_bar[MAX_STAGES];
  __shared__ __align__(8) uint64_t empty_bar[MAX_STAGES];
  __shared__ __align__(8) uint64_t tent_full[MAX_TENT_BUFS];
  __shared__ __align__(8) uint64_t tent_empty[MAX_TENT_BUFS];
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t smem0 = smem_addr(smem);
  const uint32_t ring = (smem0 + 1023u) & ~1023u;   // slots, 1 KB aligned
  uint8_t* ring_ptr = smem + (ring - smem0);
  // the tents and first cells of tent_bufs taps, then the staged fields
  float4* tent_base = reinterpret_cast<float4*>(ring_ptr + s.stages * SLOT);
  int* idx_base = reinterpret_cast<int*>(tent_base + s.tent_bufs * PIX * s.g);
  uint8_t* field_base =
      reinterpret_cast<uint8_t*>(idx_base + s.tent_bufs * PIX * s.g);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_steps = s.k_taps * s.ch;   // stages a unit
  const int n_batches =   // of TB tents a tent thread
      (PIX * s.g + TB * TENT_THREADS - 1) / (TB * TENT_THREADS);

  if (threadIdx.x == 0) {
    for (int i = 0; i < s.stages; ++i) {
      mbar_init(smem_addr(&full_bar[i]), COLUMN_THREADS + 1);
      mbar_init(smem_addr(&empty_bar[i]), CONSUMER_WARPS);
    }
    for (int i = 0; i < s.tent_bufs; ++i) {
      mbar_init(smem_addr(&tent_full[i]), TENT_THREADS);
      mbar_init(smem_addr(&tent_empty[i]), COLUMN_THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The tents of the block's (unit, tap) sequence, tap by tap, by the
  // products' threads: each tap's into buffer q % tent_bufs (tap q), at
  // most tent_bufs taps ahead of the columns, from the fields copied to
  // the next of ahead stages ahead taps before; then the fields of the tap
  // ahead taps on go to that stage. Cursors, not divisions, walk the
  // sequence.
  const uint32_t fstage = smem_addr(field_base);
  int pu = blockIdx.x, pk = 0, pq = 0;   // the next tap to write tents for
  int su = blockIdx.x, sk = 0;           // the next tap to stage fields for
  int p_slot = 0;                        // its field stage
  TentPix p_pix = tent_pix(s, pu, threadIdx.x);   // the thread's pixel in
  TentPix s_pix = p_pix;                          // units pu and su
  auto stage_next = [&]() {   // the fields of tap (su, sk), if any
    if (su < s.units)
      stage_fields<IMAGE>(fstage + p_slot * FIELD_STAGE_BYTES, s, origins,
                          fry, frx, fmm, threadIdx.x, s_pix, sk);
    cp_async_commit();
    if (++sk == s.k_taps) {
      sk = 0;
      su += gridDim.x;
      s_pix = tent_pix(s, su, threadIdx.x);
    }
  };
  auto tent_step = [&]() {
    const int buf = pq % s.tent_bufs;
    cp_async_wait(s.ahead - 1);   // tap (pu, pk)'s fields landed
    TentFields f;
    read_staged<IMAGE>(f, field_base + p_slot * FIELD_STAGE_BYTES,
                       threadIdx.x);
    mbar_wait(smem_addr(&tent_empty[buf]),
              (static_cast<uint32_t>(pq / s.tent_bufs) & 1) ^ 1);
    for (int b = 0; b < n_batches; ++b) {
      if (b > 0)   // groups past the staged 8, loaded now
        load_fields<IMAGE>(f, s, origins, fry, frx, fmm, threadIdx.x, p_pix,
                           pk, b);
      store_tents<IMAGE>(
          f, s, tent_base + buf * PIX * s.g, idx_base + buf * PIX * s.g,
          threadIdx.x, p_pix, pk, b);
    }
    mbar_arrive(smem_addr(&tent_full[buf]));
    stage_next();   // into the stage just read
    if (++p_slot == s.ahead) p_slot = 0;
    if (++pk == s.k_taps) {
      pk = 0;
      pu += gridDim.x;
      p_pix = tent_pix(s, pu, threadIdx.x);
    }
    ++pq;
  };

  if (warp < CONSUMER_WARPS) {
    // ------------------------------------------ warpgroups 0-1: products
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        CONSUMER_REGS));
    const int g8 = lane >> 2;
    const int t4 = lane & 3;
    // the lane's ldmatrix row address in a slot's columns (m16 x 8 words)
    const uint32_t a_off =
        W_BYTES + ((16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1)) * LDA +
                   4 * (lane >> 4)) * 4;
    float acc[32], sum[NH][32];
    int slot = 0;          // the ring slot of the stage, and its phase
    uint32_t phase = 0;
    // the tents of the first tent_bufs - 1 taps before the products, then
    // as each tap's products begin those of the tap tent_bufs - 1 on (whose
    // buffer the last tap's columns have freed)
    for (int a = 0; a < s.ahead; ++a) {
      stage_next();
      if (++p_slot == s.ahead) p_slot = 0;
    }
    for (int i = 1; i < s.tent_bufs && pu < s.units; ++i) tent_step();
    for (int u = blockIdx.x; u < s.units; u += gridDim.x) {
#pragma unroll
      for (int hh = 0; hh < NH; ++hh)
#pragma unroll
        for (int i = 0; i < 32; ++i) sum[hh][i] = 0.f;
      for (int st = 0; st < n_steps; ++st) {
        if (st % s.ch == 0 && pu < s.units) tent_step();
        mbar_wait(smem_addr(&full_bar[slot]), phase);
#if C2M_B2_ROLE != 2
        const uint32_t base = ring + slot * SLOT;
        uint32_t big[4][4], small[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t a[4];
          ldmatrix_x4(base + a_off + kk * 32, a[0], a[1], a[2], a[3]);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            split_tf32_int(a[e], big[kk][e], small[kk][e]);
        }
#pragma unroll
        for (int hh = 0; hh < NH; ++hh) {
          const uint64_t b_big = sw128_desc(base + hh * 64 * TMA_BOX_BYTES);
          const uint64_t b_small =
              sw128_desc(base + (COT + hh * 64) * TMA_BOX_BYTES);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            step_products(acc, big[kk], small[kk], b_big + 2 * kk,
                          b_small + 2 * kk, kk == 0);
          wgmma_commit();
          wgmma_wait<0>();
          fence_operands(acc);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            fence_operands(big[kk]);
            fence_operands(small[kk]);
          }
          // one rounded f32 add a stage takes its products into the sum
#pragma unroll
          for (int i = 0; i < 32; ++i)
            sum[hh][i] = st == 0 ? acc[i] : sum[hh][i] + acc[i];
        }
#endif
        __syncwarp();
        if (lane == 0) mbar_arrive(smem_addr(&empty_bar[slot]));
        if (++slot == s.stages) {
          slot = 0;
          phase ^= 1;
        }
      }
      // the unit's sums: sum[hh][4j + 2h + e] is pixel 16 warp + g8 + 8h,
      // channel co0 + 64 hh + 8j + 2 t4 + e
      const int tile = u / s.co_tiles;
      const int co0 = u % s.co_tiles * COT;
      const int y_t = (tile / s.ntx) * TR;
      const int x_t = (tile % s.ntx) * TW;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int pl = 16 * warp + g8 + 8 * h;
        const int y = y_t + pl / TW;
        const int x = x_t + pl % TW;
        if (y >= s.ho || x >= s.wo) continue;
        float* o = out + (static_cast<int64_t>(y) * s.wo + x) * s.co;
#pragma unroll
        for (int hh = 0; hh < NH; ++hh)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int oc = co0 + hh * 64 + 8 * j + 2 * t4;
            const float v0 = sum[hh][4 * j + 2 * h];
            const float v1 = sum[hh][4 * j + 2 * h + 1];
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
        SAMPLER_REGS));
    const int sid = threadIdx.x - COLUMN_T0;
    const int cg = s.c / s.g;
    const bool vec = cg % 4 == 0;
    const int swz = (s.g & (s.g - 1)) == 0 ? s.g - 1 : 0;
    // cells per row of the source: the image's width, or the window's
    const int64_t row_c = static_cast<int64_t>(IMAGE ? s.w : s.win) * s.c;
    int slot = 0;          // the ring slot of the stage, and its phase
    uint32_t phase = 0;
    int buf = 0;           // the tap's tent buffer, and its phase
    uint32_t t_par = 0;
    for (int u = blockIdx.x; u < s.units; u += gridDim.x) {
      const int co0 = u % s.co_tiles * (64 * NH);
      for (int k = 0; k < s.k_taps; ++k) {
        const float4* tent_s = tent_base + buf * PIX * s.g;
        const int* idx_s = idx_base + buf * PIX * s.g;
        mbar_wait(smem_addr(&tent_full[buf]), t_par);
        for (int j = 0; j < s.ch; ++j) {
          const uint32_t full = smem_addr(&full_bar[slot]);
          mbar_wait(smem_addr(&empty_bar[slot]), phase ^ 1);
          const uint32_t base = ring + slot * SLOT;
          if (sid == 0) {
#if C2M_B2_ROLE != 2
            mbar_expect_tx(full, W_BYTES);
            tma_load(base, &w_map, full, j * KS, co0, k);
            tma_load(base + W_BYTES / 2, &w_map, full, j * KS, co0,
                     s.k_taps + k);
#else
            mbar_arrive(full);
#endif
          }
#if C2M_B2_ROLE != 1
          float* cols = reinterpret_cast<float*>(ring_ptr + slot * SLOT +
                                                 W_BYTES);
          if (vec) {
            // lanes on the 8 4-channel vectors of a pixel's chunk: a
            // thread's vector is fixed, its pixels step by 32; ILP
            // vectors' tents, then their cells, are loaded together
            const int v = sid & 7;
            const int cc = j * KS + 4 * v;
            const int gi = cc / cg;
#pragma unroll
            for (int i0 = 0; i0 < NV; i0 += ILP) {
              float4 t[ILP];
              const T* p[ILP];
#pragma unroll
              for (int i = 0; i < ILP; ++i) {
                const int pl = (sid >> 3) + (i0 + i) * (COLUMN_THREADS / 8);
                t[i] = make_float4(0.f, 0.f, 0.f, 0.f);
                p[i] = src;
                if (i0 + i < NV && pl < PIX && cc < s.c) {
                  const int sl = pl * s.g + (gi ^ (pl & swz));
                  t[i] = tent_s[sl];
                  p[i] = src + static_cast<int64_t>(idx_s[sl]) * s.c + cc;
                }
              }
              float4 c4[ILP][4];
              const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
              for (int i = 0; i < ILP; ++i) {
                c4[i][0] = t[i].x != 0.f && t[i].z != 0.f ? load4(p[i]) : z;
                c4[i][1] =
                    t[i].x != 0.f && t[i].w != 0.f ? load4(p[i] + s.c) : z;
                c4[i][2] =
                    t[i].y != 0.f && t[i].z != 0.f ? load4(p[i] + row_c) : z;
                c4[i][3] = t[i].y != 0.f && t[i].w != 0.f
                               ? load4(p[i] + row_c + s.c)
                               : z;
              }
#pragma unroll
              for (int i = 0; i < ILP; ++i) {
                const int pl = (sid >> 3) + (i0 + i) * (COLUMN_THREADS / 8);
                if (i0 + i >= NV || pl >= PIX) continue;
                float4 r;
                r.x = tent_sum(c4[i][0].x, c4[i][1].x, c4[i][2].x,
                               c4[i][3].x, t[i]);
                r.y = tent_sum(c4[i][0].y, c4[i][1].y, c4[i][2].y,
                               c4[i][3].y, t[i]);
                r.z = tent_sum(c4[i][0].z, c4[i][1].z, c4[i][2].z,
                               c4[i][3].z, t[i]);
                r.w = tent_sum(c4[i][0].w, c4[i][1].w, c4[i][2].w,
                               c4[i][3].w, t[i]);
                *reinterpret_cast<float4*>(cols + pl * LDA + 4 * v) = r;
              }
            }
          } else {
            // groups of channels off the 4-channel vectors: a lane a
            // channel of the chunk
            const int cc = j * KS + lane;
            const int gi = cc / cg;
            for (int pl = sid >> 5; pl < PIX; pl += COLUMN_THREADS / 32) {
              float r = 0.f;
              if (cc < s.c) {
                const int sl = pl * s.g + (gi ^ (pl & swz));
                const float4 t = tent_s[sl];
                const T* p = src + static_cast<int64_t>(idx_s[sl]) * s.c + cc;
                const float v00 =
                    t.x != 0.f && t.z != 0.f ? to_f32(p[0]) : 0.f;
                const float v01 =
                    t.x != 0.f && t.w != 0.f ? to_f32(p[s.c]) : 0.f;
                const float v10 =
                    t.y != 0.f && t.z != 0.f ? to_f32(p[row_c]) : 0.f;
                const float v11 =
                    t.y != 0.f && t.w != 0.f ? to_f32(p[row_c + s.c]) : 0.f;
                r = tent_sum(v00, v01, v10, v11, t);
              }
              cols[pl * LDA + lane] = r;
            }
          }
#endif
          mbar_arrive(full);
          if (++slot == s.stages) {
            slot = 0;
            phase ^= 1;
          }
        }
        mbar_arrive(smem_addr(&tent_empty[buf]));   // the tap's tents read
        if (++buf == s.tent_bufs) {
          buf = 0;
          t_par ^= 1;
        }
      }
    }
  }
}

template <typename T, bool IMAGE, int NH>
cudaError_t run(const CUtensorMap& w_map, const void* src, const void* origins,
                const void* ry, const void* rx, const void* mm, void* out,
                const Shape& s, size_t smem, cudaStream_t stream) {
  const auto kernel = window_contract_kernel<T, IMAGE, NH>;
  // setmaxnreg.inc waits for registers that the samplers' dec frees: the
  // launch must give the block LAUNCH_REGS a thread, or it would wait
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
      w_map, static_cast<const T*>(src), static_cast<const int*>(origins),
      static_cast<const float*>(ry), static_cast<const float*>(rx),
      static_cast<const float*>(mm), static_cast<float*>(out), s);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* src, const void* origins, const void* ry,
           const void* rx, const void* mm, const void* weight, void* out,
           int nb, int k_taps, int blk, int win, int c, int g, int co,
           int ldw, int nbx, int h, int w, void* stream) {
  const bool image = origins != nullptr;
  const int nh = co <= 64 ? 1 : 2;
  const int cot = 64 * nh;
  const int64_t ho = nb / (nbx > 0 ? nbx : 1) * static_cast<int64_t>(blk);
  const int64_t wo = static_cast<int64_t>(nbx) * blk;
  const int64_t tiles = (ho + TR - 1) / TR * ((wo + TW - 1) / TW);
  const int co_tiles = (co + cot - 1) / cot;
  const bool vec = g > 0 && c % g == 0 && (c / g) % 4 == 0;
  const uintptr_t vec_bytes = 4 * sizeof(T);
  if (nb < 1 || k_taps < 1 || blk < 1 || win < 1 || g < 1 || c < 1 ||
      c > MAX_C || c % g || co < 1 || ldw < co || nbx < 1 || nb % nbx ||
      ho * wo > 0x7fffffffLL ||
      // unit indices are 32-bit, a block's last step past the end too
      tiles * co_tiles > 0x7fffffffLL - 65536 ||
      smem_bytes(1, cot, g, 1, 1) > MAX_SMEM ||
      // cell indices are 32-bit
      (image ? (static_cast<int64_t>(h) + 4) * (w + 4)
             : static_cast<int64_t>(nb) * k_taps * win * win) > 0x7fffffffLL ||
      (vec && reinterpret_cast<uintptr_t>(src) % vec_bytes) ||
      (image && (h < 1 || w < 1 ||
                 reinterpret_cast<uintptr_t>(origins) % 8)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  Shape s;
  s.k_taps = k_taps;
  s.blk = blk;
  s.win = win;
  s.c = c;
  s.g = g;
  s.co = co;
  s.nbx = nbx;
  s.h = h;
  s.w = w;
  s.ho = static_cast<int>(ho);
  s.wo = static_cast<int>(wo);
  s.ntx = static_cast<int>((wo + TW - 1) / TW);
  s.ch = (c + KS - 1) / KS;
  s.co_tiles = co_tiles;
  s.units = static_cast<int>(tiles * co_tiles);
  // the most staged fields and tents that fit beside one ring slot (many
  // groups take fewer), then the deepest ring
  s.tent_bufs = MAX_TENT_BUFS;
  s.ahead = MAX_AHEAD;
  while (smem_bytes(1, cot, g, s.tent_bufs, s.ahead) > MAX_SMEM) {
    if (s.ahead > 1)
      --s.ahead;
    else
      --s.tent_bufs;
  }
  s.stages = 1;
  while (s.stages < MAX_STAGES &&
         smem_bytes(s.stages + 1, cot, g, s.tent_bufs, s.ahead) <= MAX_SMEM)
    ++s.stages;
  const size_t smem = smem_bytes(s.stages, cot, g, s.tent_bufs, s.ahead);

  // the weight's TF32 parts in scratch, rows of whole TMA boxes
  const int c_pad = s.ch * KS;
  const int co_pad = co_tiles * cot;
  const int64_t n = static_cast<int64_t>(k_taps) * co_pad * c_pad;
  void* parts = nullptr;
  cudaMemPool_t pool;
  cudaError_t err = scratch_pool(&pool);
  if (err == cudaSuccess)
    err = cudaMallocFromPoolAsync(&parts, 2 * sizeof(float) * n, pool, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  {
    const int64_t want = (n + SPLIT_THREADS - 1) / SPLIT_THREADS;
    const int64_t cap = static_cast<int64_t>(sm_count() > 0 ? sm_count() : 1) *
                        16;
    split_weight_kernel<<<static_cast<unsigned>(want < cap ? want : cap),
                          SPLIT_THREADS, 0, st>>>(
        static_cast<const float*>(weight), static_cast<float*>(parts), k_taps,
        c, co, ldw, co_pad, c_pad);
    err = cudaGetLastError();
  }
  CUtensorMap w_map;
  if (err == cudaSuccess &&
      !make_map<float>(&w_map, parts, c_pad, co_pad, 2 * k_taps, cot))
    err = cudaErrorInvalidValue;
  if (err == cudaSuccess) {
#define C2M_RUN(IMAGE_, NH_)                                               \
  run<T, IMAGE_, NH_>(w_map, src, origins, ry, rx, mm, out, s, smem, st)
    err = image ? (nh == 1 ? C2M_RUN(true, 1) : C2M_RUN(true, 2))
                : (nh == 1 ? C2M_RUN(false, 1) : C2M_RUN(false, 2));
#undef C2M_RUN
  }
  const cudaError_t freed = cudaFreeAsync(parts, st);
  return static_cast<int>(err != cudaSuccess ? err : freed);
}

}  // namespace

// src: the (H, W, C) image when origins, the (NB, K, 2) int32 window
// origins, is given (image mode), else the (NB, K, win, win * C) windows
// (rows mode; h and w are not read). weight: (K, C, ldw) f32, columns past
// Co not read. out: (Ho, Wo, Co) f32. Refuses (cudaErrorInvalidValue) C
// past 512, tents of a tile past shared memory (G too large), 32-bit cell
// indices that overflow, and an image or windows not aligned to the
// 4-channel loads.
#define C2M_WINDOW_ENTRY(NAME, T)                                            \
  extern "C" int NAME(const void* src, const void* origins, const void* ry,  \
                      const void* rx, const void* mm, const void* weight,    \
                      void* out, int nb, int k_taps, int blk, int win, int c, \
                      int g, int co, int ldw, int nbx, int h, int w,         \
                      void* stream) {                                        \
    return launch<T>(src, origins, ry, rx, mm, weight, out, nb, k_taps, blk, \
                     win, c, g, co, ldw, nbx, h, w, stream);                 \
  }

C2M_WINDOW_ENTRY(c2m_window_contract_f32, float)
C2M_WINDOW_ENTRY(c2m_window_contract_bf16, __nv_bfloat16)
