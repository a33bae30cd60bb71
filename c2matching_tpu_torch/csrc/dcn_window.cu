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
// the contraction runs on the tensor cores, as 3xTF32 with mma.sync
// m16n8k8: each f32 value splits in registers into big = tf32(v) and
// small = tf32(v - big), rounded as cvt.rna rounds but by integer
// operations (split_tf32_int, measured faster than the conversions), and
// big*small + small*big + big*big of each 8-channel step sum in a fresh
// fragment that one rounded f32 add takes into the running sum, as B1 does
// (patch_match.cu: the tensor cores truncate as they add). The weight
// stays f32 whatever x's type.
//
// Design: a thread block of 8 warps takes a tile of 4 x 32 output pixels
// (PIX = 128) and 64 or 128 output channels (grid.y covers wider Co). Per
// tap k:
//   1a. tents: the lanes of a warp take 32 neighbouring pixels of one group
//       (the fields are read coalesced) and write each (pixel, group)'s
//       four tents and first cell to shared memory, swizzled so that
//       neither these writes nor the reads of 1b conflict on banks;
//   1b. columns: the lanes of a warp take neighbouring 4-channel vectors of
//       a pixel (16 bytes of f32, 8 of bf16), so a cell's channels are read
//       coalesced; each reads at most the 2 x 2 cells whose weight is not
//       zero and writes PIX x C f32 columns to shared memory;
//   2.  products: out[PIX, Co tile] += cols @ weight[k]; the warps tile the
//       block 4 x 2, each 32 pixels x (Co tile / 2) in registers; A
//       fragments by ldmatrix from the columns (rows padded by 4 words:
//       conflict-free), B fragments by 32-bit loads from the weight rows
//       (padded to Co tile + 8 words: conflict-free).
// The weight streams through a 3-slot cp.async ring of 16-row chunks
// (4.5 KB at relu1, 8.5 KB at relu2), the chunks of a tap and then the
// next tap's: two chunks are in flight while one is multiplied, and the
// next tap's first chunks arrive while its columns are sampled. One barrier
// per chunk and one per tap. 2 blocks a SM: 122 (Co <= 64) or 128
// registers a thread, no spills; 69,120 bytes of shared memory at relu1
// and 114,176 at relu2.
// For any ry and rx this gives what the dense formula gives: every cell the
// kernel skips has a zero tent there.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

using namespace c2m;

constexpr int THREADS = 256;
constexpr int TR = 4;             // output rows per tile
constexpr int TW = 32;            // output columns per tile
constexpr int PIX = TR * TW;      // output pixels per thread block
constexpr int WARPS_M = 4;
constexpr int WARPS_N = 2;
constexpr int MT = PIX / WARPS_M / 16;  // m16 tiles per warp
constexpr int KC = 16;            // weight rows per ring slot: two k-steps
constexpr int SLOTS = 3;          // ring slots
constexpr int MAX_SMEM = 232448;

static_assert(WARPS_M * WARPS_N * 32 == THREADS, "8 warps");
static_assert(MT * 16 * WARPS_M == PIX, "the warps cover the tile's pixels");

// Output channels per block (COT) and the weight rows' padded stride (LDB
// = COT + 8 words: the lanes of a B fragment load hit distinct banks).
template <int JV>
struct CoTile {
  static constexpr int COT = 64 * JV;
  static constexpr int LDB = COT + 8;
  static constexpr int NT = COT / WARPS_N / 8;  // n8 tiles per warp
};

// Channels padded to whole ring slots; the columns' row stride in words
// (4 more: the 8 rows of an ldmatrix hit distinct banks).
inline __host__ __device__ int padded_c(int c) { return (c + KC - 1) / KC * KC; }
inline __host__ __device__ int cols_ld(int c) { return padded_c(c) + 4; }

// the columns, the weight ring, and the tents and first cell of every
// (pixel, group) of a tap
size_t smem_bytes(int c, int g, int cot) {
  return static_cast<size_t>(PIX) * cols_ld(c) * sizeof(float) +
         static_cast<size_t>(SLOTS) * KC * (cot + 8) * sizeof(float) +
         static_cast<size_t>(PIX) * g * (sizeof(float4) + sizeof(int));
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

template <typename T, bool IMAGE, int JV>
__global__ void __launch_bounds__(THREADS, 2)
window_contract_kernel(const T* __restrict__ src,
                       const int* __restrict__ origins,
                       const float* __restrict__ fry,
                       const float* __restrict__ frx,
                       const float* __restrict__ fmm,
                       const float* __restrict__ weight,
                       float* __restrict__ out, int k_taps, int blk, int win,
                       int c, int g, int co, int ldw, int nby, int nbx, int h,
                       int w) {
  constexpr int COT = CoTile<JV>::COT;
  constexpr int LDB = CoTile<JV>::LDB;
  constexpr int NT = CoTile<JV>::NT;
  extern __shared__ __align__(16) float smem[];
  const int lda = cols_ld(c);
  const int cp = padded_c(c);
  const int ch = cp / KC;  // weight chunks per tap
  float* cols_s = smem;
  float* w_s = cols_s + PIX * lda;
  float4* tent_s = reinterpret_cast<float4*>(w_s + SLOTS * KC * LDB);
  int* idx_s = reinterpret_cast<int*>(tent_s + PIX * g);
  const uint32_t w_addr = smem_addr(w_s);
  // (pixel, group) -> its slot of tent_s and idx_s; the groups' order is
  // swizzled by the pixel (G a power of two), so that 8 neighbouring
  // pixels of one group and 8 groups of one pixel both hit distinct banks
  const int swz = (g & (g - 1)) == 0 ? g - 1 : 0;

  const int tid = threadIdx.x;
  const int ho = nby * blk;
  const int wo = nbx * blk;
  const int64_t n_pix = static_cast<int64_t>(ho) * wo;
  const int ntx = (wo + TW - 1) / TW;
  const int y_t = (blockIdx.x / ntx) * TR;
  const int x_t = (blockIdx.x % ntx) * TW;
  const int co0 = blockIdx.y * COT;
  const int cg = c / g;
  const float fwin = static_cast<float>(win);
  // cells per row of the source: the image's width, or the window's
  const int64_t row_c = static_cast<int64_t>(IMAGE ? w : win) * c;

  // chunk s of the weight (tap s / ch, rows (s % ch) * KC ..) into a slot;
  // rows past C and columns past ldw are zero-filled
  auto load_w = [&](int s, int slot) {
    const int k = s / ch;
    const int c0 = (s % ch) * KC;
    const uint32_t base = w_addr + slot * KC * LDB * 4;
    for (int i = tid; i < KC * COT / 4; i += THREADS) {
      const int r = i / (COT / 4);
      const int q = 4 * (i % (COT / 4));
      const bool in = c0 + r < c && co0 + q < ldw;
      const float* p =
          in ? weight + (static_cast<int64_t>(k) * c + c0 + r) * ldw + co0 + q
             : weight;
      cp_async16(base + (r * LDB + q) * 4, p, in ? 16 : 0);
    }
  };

  // the columns' padding channels stay zero: the products read them
  for (int i = tid; i < PIX * (cp - c); i += THREADS)
    cols_s[(i / (cp - c)) * lda + c + i % (cp - c)] = 0.f;

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_m = warp / WARPS_N;
  const int warp_n = warp % WARPS_N;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  // ldmatrix row address of the lane in the columns (m16 x 8 words), and
  // the lane's B word in a slot: (row tq, column gq) of an n8 tile
  const uint32_t a_addr =
      smem_addr(cols_s) +
      ((warp_m * MT * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * lda +
       4 * (lane >> 4)) * 4;
  const int b_off = tq * LDB + warp_n * (COT / WARPS_N) + gq;

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int n_chunks = k_taps * ch;
#pragma unroll
  for (int s = 0; s < SLOTS - 1; ++s) {
    if (s < n_chunks) load_w(s, s);
    cp_async_commit();
  }

  for (int k = 0; k < k_taps; ++k) {
    // 1a. the tents and first cell of every (pixel, group) of tap k; the
    // lanes of a warp take 32 neighbouring pixels of one group, so the
    // fields are read coalesced. The first cell of each axis is floor(r)
    // clamped to [-2, win] before the conversion to int (huge coordinates
    // stay in int range, and a clamped cell and the one after it are
    // outside the window); the tents there and one cell on are zero for
    // cells outside the window and, in image mode, for cells outside the
    // image (rows mode reads 0.0 there, which gives the same sums); the
    // x-tents are times the modulation. A ragged tile's missing pixels get
    // zero tents.
#pragma unroll 1
    for (int e = tid; e < PIX * g; e += THREADS) {
      const int pl = e % PIX;
      const int gi = e / PIX;
      const int y = y_t + pl / TW;
      const int x = x_t + pl % TW;
      float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
      int idx = 0;
      if (y < ho && x < wo) {
        const int64_t f = (static_cast<int64_t>(gi) * k_taps + k) * n_pix +
                          static_cast<int64_t>(y) * wo + x;
        const float ry = __ldg(fry + f);
        const float rx = __ldg(frx + f);
        const float m = __ldg(fmm + f);
        const float y0f = fminf(fmaxf(floorf(ry), -2.f), fwin);
        const float x0f = fminf(fmaxf(floorf(rx), -2.f), fwin);
        const int y0 = static_cast<int>(y0f);
        const int x0 = static_cast<int>(x0f);
        t.x = y0 >= 0 && y0 < win ? fmaxf(0.f, 1.f - fabsf(ry - y0f)) : 0.f;
        t.y = y0 + 1 >= 0 && y0 + 1 < win
                  ? fmaxf(0.f, 1.f - fabsf(ry - (y0f + 1.f)))
                  : 0.f;
        t.z = x0 >= 0 && x0 < win ? fmaxf(0.f, 1.f - fabsf(rx - x0f)) * m
                                  : 0.f;
        t.w = x0 + 1 >= 0 && x0 + 1 < win
                  ? fmaxf(0.f, 1.f - fabsf(rx - (x0f + 1.f))) * m
                  : 0.f;
        const int64_t b = static_cast<int64_t>(y / blk) * nbx + x / blk;
        if constexpr (IMAGE) {
          const int2 o = __ldg(reinterpret_cast<const int2*>(origins) +
                               b * k_taps + k);
          const int iy = o.x + y0;
          const int ix = o.y + x0;
          if (iy < 0 || iy >= h) t.x = 0.f;
          if (iy + 1 < 0 || iy + 1 >= h) t.y = 0.f;
          if (ix < 0 || ix >= w) t.z = 0.f;
          if (ix + 1 < 0 || ix + 1 >= w) t.w = 0.f;
          idx = iy * w + ix;
        } else {
          idx = static_cast<int>(((b * k_taps + k) * win + y0) * win + x0);
        }
      }
      const int sl = pl * g + (gi ^ (pl & swz));
      tent_s[sl] = t;
      idx_s[sl] = idx;
    }
    __syncthreads();  // the tents written; the last tap's products done

    // 1b. the columns of tap k: the lanes of a warp take neighbouring
    // 4-channel vectors of a pixel, so a cell's channels are read
    // coalesced; a cell whose weight is zero is not read
    if (cg % 4 == 0) {
      const int nv = c / 4;
#pragma unroll 2
      for (int e = tid; e < PIX * nv; e += THREADS) {
        const int pl = e / nv;
        const int v = e % nv;
        const int sl = pl * g + ((v * 4 / cg) ^ (pl & swz));
        const float4 t = tent_s[sl];
        const T* p = src + static_cast<int64_t>(idx_s[sl]) * c + v * 4;
        const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
        const float4 v00 = t.x != 0.f && t.z != 0.f ? load4(p) : z;
        const float4 v01 = t.x != 0.f && t.w != 0.f ? load4(p + c) : z;
        const float4 v10 = t.y != 0.f && t.z != 0.f ? load4(p + row_c) : z;
        const float4 v11 =
            t.y != 0.f && t.w != 0.f ? load4(p + row_c + c) : z;
        float4 s;
        s.x = tent_sum(v00.x, v01.x, v10.x, v11.x, t);
        s.y = tent_sum(v00.y, v01.y, v10.y, v11.y, t);
        s.z = tent_sum(v00.z, v01.z, v10.z, v11.z, t);
        s.w = tent_sum(v00.w, v01.w, v10.w, v11.w, t);
        *reinterpret_cast<float4*>(cols_s + pl * lda + v * 4) = s;
      }
    } else {  // groups of channels off the 4-channel vectors
      for (int e = tid; e < PIX * c; e += THREADS) {
        const int pl = e / c;
        const int cc = e % c;
        const int sl = pl * g + ((cc / cg) ^ (pl & swz));
        const float4 t = tent_s[sl];
        const T* p = src + static_cast<int64_t>(idx_s[sl]) * c + cc;
        const float v00 = t.x != 0.f && t.z != 0.f ? to_f32(p[0]) : 0.f;
        const float v01 = t.x != 0.f && t.w != 0.f ? to_f32(p[c]) : 0.f;
        const float v10 = t.y != 0.f && t.z != 0.f ? to_f32(p[row_c]) : 0.f;
        const float v11 =
            t.y != 0.f && t.w != 0.f ? to_f32(p[row_c + c]) : 0.f;
        cols_s[pl * lda + cc] = tent_sum(v00, v01, v10, v11, t);
      }
    }

    // 2. out += cols @ weight[k], one ring chunk of KC rows at a time
    for (int j = 0; j < ch; ++j) {
      const int s = k * ch + j;
      cp_async_wait<SLOTS - 2>();
      __syncthreads();  // chunk s landed; the columns written; chunk s - 1's
                        // products done, so its slot is free
      if (s + SLOTS - 1 < n_chunks)
        load_w(s + SLOTS - 1, (s + SLOTS - 1) % SLOTS);
      cp_async_commit();

      const float* ws = w_s + (s % SLOTS) * KC * LDB + b_off;
      const uint32_t a_chunk = a_addr + j * KC * 4;
#pragma unroll 1
      for (int kk = 0; kk < KC / 8; ++kk) {
        uint32_t a_big[MT][4], a_small[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t a[4];
          ldmatrix_x4(a_chunk + (mt * 16 * lda + kk * 8) * 4, a[0], a[1],
                      a[2], a[3]);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            split_tf32_int(a[e], a_big[mt][e], a_small[mt][e]);
        }
        const float* wk = ws + kk * 8 * LDB;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          uint32_t b_big[2], b_small[2];
          split_tf32_int(__float_as_uint(wk[nt * 8]), b_big[0], b_small[0]);
          split_tf32_int(__float_as_uint(wk[nt * 8 + 4 * LDB]), b_big[1],
                         b_small[1]);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            float sum8[4];
            mma_tf32_zero(sum8, a_big[mt], b_small[0], b_small[1]);
            mma_tf32(sum8, a_small[mt], b_big[0], b_big[1]);
            mma_tf32(sum8, a_big[mt], b_big[0], b_big[1]);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][nt][e] += sum8[e];
          }
        }
      }
    }
  }

  // accumulator (row gq, cols 2 tq, 2 tq + 1) and (row gq + 8, same cols)
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int pl = warp_m * MT * 16 + mt * 16 + hh * 8 + gq;
      const int y = y_t + pl / TW;
      const int x = x_t + pl % TW;
      if (y >= ho || x >= wo) continue;
      float* o = out + (static_cast<int64_t>(y) * wo + x) * co;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int oc = co0 + warp_n * (COT / WARPS_N) + nt * 8 + 2 * tq;
        if (oc + 1 < co && !(co & 1)) {
          *reinterpret_cast<float2*>(o + oc) =
              make_float2(acc[mt][nt][2 * hh], acc[mt][nt][2 * hh + 1]);
        } else {
          if (oc < co) o[oc] = acc[mt][nt][2 * hh];
          if (oc + 1 < co) o[oc + 1] = acc[mt][nt][2 * hh + 1];
        }
      }
    }
}

template <typename T, bool IMAGE, int JV>
int launch_t(const void* src, const void* origins, const void* ry,
             const void* rx, const void* mm, const void* weight, void* out,
             int k_taps, int blk, int win, int c, int g, int co, int ldw,
             int nby, int nbx, int h, int w, void* stream) {
  auto kernel = window_contract_kernel<T, IMAGE, JV>;
  const size_t smem = smem_bytes(c, g, CoTile<JV>::COT);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tiles = static_cast<int64_t>((nby * blk + TR - 1) / TR) *
                        ((nbx * blk + TW - 1) / TW);
  const dim3 grid(static_cast<unsigned>(tiles),
                  (co + CoTile<JV>::COT - 1) / CoTile<JV>::COT);
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(src), static_cast<const int*>(origins),
      static_cast<const float*>(ry), static_cast<const float*>(rx),
      static_cast<const float*>(mm), static_cast<const float*>(weight),
      static_cast<float*>(out), k_taps, blk, win, c, g, co, ldw, nby, nbx, h,
      w);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* src, const void* origins, const void* ry,
           const void* rx, const void* mm, const void* weight, void* out,
           int nb, int k_taps, int blk, int win, int c, int g, int co,
           int ldw, int nbx, int h, int w, void* stream) {
  const bool image = origins != nullptr;
  const int jv = co <= 64 ? 1 : 2;
  const int64_t ho = nb / (nbx > 0 ? nbx : 1) * static_cast<int64_t>(blk);
  const int64_t wo = static_cast<int64_t>(nbx) * blk;
  const int64_t tiles = (ho + TR - 1) / TR * ((wo + TW - 1) / TW);
  const bool vec = g > 0 && c % g == 0 && (c / g) % 4 == 0;
  const uintptr_t vec_bytes = 4 * sizeof(T);
  if (nb < 1 || k_taps < 1 || blk < 1 || win < 1 || g < 1 || c < 1 ||
      c % g || co < 1 || ldw < co || ldw % 4 || nbx < 1 || nb % nbx ||
      ho * wo > 0x7fffffffLL || tiles > 0x7fffffffLL ||
      (co + 64 * jv - 1) / (64 * jv) > 65535 ||
      smem_bytes(c, g, 64 * jv) > MAX_SMEM ||
      // cell indices are 32-bit
      (image ? (static_cast<int64_t>(h) + 4) * (w + 4)
             : static_cast<int64_t>(nb) * k_taps * win * win) > 0x7fffffffLL ||
      reinterpret_cast<uintptr_t>(weight) % 16 ||
      (vec && reinterpret_cast<uintptr_t>(src) % vec_bytes) ||
      (image && (h < 1 || w < 1 ||
                 reinterpret_cast<uintptr_t>(origins) % 8)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nby = nb / nbx;
  if (image)
    return jv == 1 ? launch_t<T, true, 1>(src, origins, ry, rx, mm, weight,
                                          out, k_taps, blk, win, c, g, co,
                                          ldw, nby, nbx, h, w, stream)
                   : launch_t<T, true, 2>(src, origins, ry, rx, mm, weight,
                                          out, k_taps, blk, win, c, g, co,
                                          ldw, nby, nbx, h, w, stream);
  return jv == 1 ? launch_t<T, false, 1>(src, origins, ry, rx, mm, weight,
                                         out, k_taps, blk, win, c, g, co, ldw,
                                         nby, nbx, h, w, stream)
                 : launch_t<T, false, 2>(src, origins, ry, rx, mm, weight,
                                         out, k_taps, blk, win, c, g, co, ldw,
                                         nby, nbx, h, w, stream);
}

}  // namespace

// src: the (H, W, C) image when origins, the (NB, K, 2) int32 window
// origins, is given (image mode), else the (NB, K, win, win * C) windows
// (rows mode; h and w are not read). weight: (K, C, ldw) f32 with ldw a
// multiple of 4 and columns past Co not read. out: (Ho, Wo, Co) f32.
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
