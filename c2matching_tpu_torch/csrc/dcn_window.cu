// Tent-weighted window contraction (kernel B2, forward) for Hopper, sm_90a.
//
// The windowed deformable conv gathers, for every aligned blk x blk output
// block b and tap k, one win x win x C window of the zero-padded input
// (rows[b, k, wy, wx * C + c]). This kernel turns the windows into the
// conv's output:
//   cols[p, k * C + c] = sum_wy sum_wx tent(ry - wy) tent(rx - wx) mm
//                        rows[b(p), k, wy, wx * C + c]
//   out[p, o]          = sum_{k, c} cols[p, k * C + c] weight[k, c, o]
// with tent(d) = max(0, 1 - |d|), ry, rx, mm read at (group of c, k, p).
//
// Replaces the Pallas kernel c2matching_tpu/ops/pallas/dcn_window_kernel.py
// (window_contract_pallas, body _kernel), which evaluated every tent over
// all win x win cells on the VPU because it could not gather inside a
// window, and pre-expanded the fields to 128 lanes because Mosaic cannot
// slice lanes below that. Neither holds here.
//
// What bounds it on this card: bytes first. At relu1 of the CUFED5 bucket
// (512 x 384 x 64, G = 8, blk 4, win 8) the f32 windows are 1.81 GB, against
// 14.5 GFLOP of weight contraction (0.54 ms of reads at 3.35 TB/s, 0.22 ms at
// the 67 TFLOP/s f32 peak). A tent is non-zero on at most two cells per
// axis, so each (pixel, tap, group) reads at most 2 x 2 cells of its window,
// and never one whose weight is zero: sectors that no pixel of a block needs
// are not read at all. The weight contraction stays in the kernel, as in
// the Pallas kernel's body.
//
// Design: one thread block of 256 threads takes 64 output pixels in
// block-major order (whole blk x blk blocks where blk^2 divides 64, else
// the tile straddles blocks; the ragged end is masked). Per tap:
//   1. the tents of every (pixel, group): the first cell of each axis,
//      floor(r) clamped to [-2, win] before the conversion to int, and the
//      two tents there and one cell on, zeroed for cells outside the
//      window (they do not exist), the x-tents times the modulation;
//   2. the 64 x C columns of this tap into shared memory, one channel a
//      thread, so that a warp reads a cell's channels coalesced;
//   3. out[64, Co] += cols @ weight[k], 32 weight rows at a time staged in
//      shared memory, each thread holding 4 pixels x 4 * JV channels of the
//      output in registers (JV = ceil(Co / 64)).
// For any ry and rx this gives what the dense formula gives: every cell the
// kernel skips has a zero tent there. Rows are converted to f32; the weight
// is f32 whatever the rows' type; sums are f32. Index math is 64-bit: at
// relu1 the windows hold 453 M elements.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PIX = 64;       // output pixels per thread block
constexpr int CO_LANES = 16;  // threads across the output channels
constexpr int CCH = 32;       // weight rows staged per step
constexpr int MAX_SMEM = 232448;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// output pixel (row-major over Ho x Wo) of the i-th pixel in block-major
// order
__device__ __forceinline__ int64_t pixel_of(int64_t i, int blk, int nbx) {
  const int q_n = blk * blk;
  const int64_t b = i / q_n;
  const int q = static_cast<int>(i % q_n);
  const int64_t y = (b / nbx) * blk + q / blk;
  const int64_t x = (b % nbx) * blk + q % blk;
  return y * (static_cast<int64_t>(nbx) * blk) + x;
}

size_t smem_bytes(int c, int g, int co) {
  const int cop = (co + 63) / 64 * 64;
  return static_cast<size_t>(PIX) * g * (sizeof(float4) + sizeof(int2)) +
         static_cast<size_t>(PIX) * (c + 4) * sizeof(float) +
         static_cast<size_t>(CCH) * cop * sizeof(float);
}

template <typename T, int JV>
__global__ void __launch_bounds__(THREADS)
window_contract_kernel(const T* __restrict__ rows,
                       const float* __restrict__ ry,
                       const float* __restrict__ rx,
                       const float* __restrict__ mm,
                       const float* __restrict__ weight,
                       float* __restrict__ out, int nb, int k_taps, int blk,
                       int win, int c, int g, int co, int nbx) {
  constexpr int COP = 64 * JV;  // output channels padded to the thread tile
  extern __shared__ __align__(16) unsigned char smem[];
  const int cs = c + 4;  // padded column stride, a multiple of 4
  float4* tap_w = reinterpret_cast<float4*>(smem);  // ty0, ty1, txm0, txm1
  float* cols_s = reinterpret_cast<float*>(tap_w + PIX * g);
  float* w_s = cols_s + PIX * cs;
  int2* tap_c = reinterpret_cast<int2*>(w_s + CCH * COP);  // (y0, x0)

  const int tid = threadIdx.x;
  const int64_t n_pix = static_cast<int64_t>(nb) * blk * blk;  // = P
  const int64_t pix0 = static_cast<int64_t>(blockIdx.x) * PIX;
  const int cg = c / g;
  const int winc = win * c;
  const float fwin = static_cast<float>(win);

  const int pg = tid / CO_LANES;  // this thread's pixels: 4 pg .. 4 pg + 3
  const int cl = tid % CO_LANES;  // and channels jv * 64 + 4 cl + (0..3)
  float acc[4][4 * JV];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4 * JV; ++j) acc[i][j] = 0.f;

  for (int k = 0; k < k_taps; ++k) {
    // 1. tents of every (pixel, group) of tap k
    for (int e = tid; e < PIX * g; e += THREADS) {
      const int pl = e / g;
      const int gi = e % g;
      float4 tw = make_float4(0.f, 0.f, 0.f, 0.f);
      int2 tc = make_int2(0, 0);
      if (pix0 + pl < n_pix) {
        const int64_t f = (static_cast<int64_t>(gi) * k_taps + k) * n_pix +
                          pixel_of(pix0 + pl, blk, nbx);
        const float y = ry[f];
        const float x = rx[f];
        const float m = mm[f];
        // clamp before the conversion: huge coordinates stay in int range,
        // and a clamped cell and the one after it are both outside
        const float y0f = fminf(fmaxf(floorf(y), -2.f), fwin);
        const float x0f = fminf(fmaxf(floorf(x), -2.f), fwin);
        const int y0 = static_cast<int>(y0f);
        const int x0 = static_cast<int>(x0f);
        const bool iy0 = y0 >= 0 && y0 < win;
        const bool iy1 = y0 + 1 >= 0 && y0 + 1 < win;
        const bool ix0 = x0 >= 0 && x0 < win;
        const bool ix1 = x0 + 1 >= 0 && x0 + 1 < win;
        tw.x = iy0 ? fmaxf(0.f, 1.f - fabsf(y - y0f)) : 0.f;
        tw.y = iy1 ? fmaxf(0.f, 1.f - fabsf(y - (y0f + 1.f))) : 0.f;
        tw.z = ix0 ? fmaxf(0.f, 1.f - fabsf(x - x0f)) * m : 0.f;
        tw.w = ix1 ? fmaxf(0.f, 1.f - fabsf(x - (x0f + 1.f))) * m : 0.f;
        tc = make_int2(y0, x0);
      }
      tap_w[e] = tw;
      tap_c[e] = tc;
    }
    __syncthreads();

    // 2. the 64 x C columns of tap k; a zero weight skips its cell
    for (int e = tid; e < PIX * c; e += THREADS) {
      const int pl = e / c;
      const int ch = e % c;
      float v = 0.f;
      if (pix0 + pl < n_pix) {
        const int t = pl * g + ch / cg;
        const float4 tw = tap_w[t];
        const int2 tc = tap_c[t];
        const int64_t b = (pix0 + pl) / (blk * blk);
        const T* wnd =
            rows + (b * k_taps + k) * static_cast<int64_t>(win) * winc + ch;
        if (tw.x != 0.f) {
          const T* r = wnd + static_cast<int64_t>(tc.x) * winc;
          float s = 0.f;
          if (tw.z != 0.f) s += to_f32(r[tc.y * c]) * tw.z;
          if (tw.w != 0.f) s += to_f32(r[(tc.y + 1) * c]) * tw.w;
          v += s * tw.x;
        }
        if (tw.y != 0.f) {
          const T* r = wnd + static_cast<int64_t>(tc.x + 1) * winc;
          float s = 0.f;
          if (tw.z != 0.f) s += to_f32(r[tc.y * c]) * tw.z;
          if (tw.w != 0.f) s += to_f32(r[(tc.y + 1) * c]) * tw.w;
          v += s * tw.y;
        }
      }
      cols_s[pl * cs + ch] = v;
    }

    // 3. out += cols @ weight[k], CCH weight rows at a time
    for (int c0 = 0; c0 < c; c0 += CCH) {
      const int cn = min(CCH, c - c0);
      __syncthreads();  // columns written; the last step's w_s reads done
      for (int e = tid; e < CCH * COP; e += THREADS) {
        const int r = e / COP;
        const int o = e % COP;
        w_s[e] = (r < cn && o < co)
                     ? weight[(static_cast<int64_t>(k) * c + c0 + r) * co + o]
                     : 0.f;
      }
      __syncthreads();
      for (int r = 0; r < cn; r += 4) {  // c % 4 == 0, so cn % 4 == 0
        float4 a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = *reinterpret_cast<const float4*>(
              &cols_s[(pg * 4 + i) * cs + c0 + r]);
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
#pragma unroll
          for (int jv = 0; jv < JV; ++jv) {
            const float4 wv = *reinterpret_cast<const float4*>(
                &w_s[(r + rr) * COP + jv * 64 + cl * 4]);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float av = lane(a[i], rr);
              acc[i][jv * 4 + 0] = fmaf(av, wv.x, acc[i][jv * 4 + 0]);
              acc[i][jv * 4 + 1] = fmaf(av, wv.y, acc[i][jv * 4 + 1]);
              acc[i][jv * 4 + 2] = fmaf(av, wv.z, acc[i][jv * 4 + 2]);
              acc[i][jv * 4 + 3] = fmaf(av, wv.w, acc[i][jv * 4 + 3]);
            }
          }
        }
      }
    }
    // the next tap's step 1 writes only tap_w / tap_c, which step 3 does not
    // read; its __syncthreads then orders step 2's cols_s writes after
    // every thread's step 3
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t ip = pix0 + pg * 4 + i;
    if (ip >= n_pix) continue;
    float* o = out + pixel_of(ip, blk, nbx) * co;
#pragma unroll
    for (int jv = 0; jv < JV; ++jv)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int oc = jv * 64 + cl * 4 + v;
        if (oc < co) o[oc] = acc[i][jv * 4 + v];
      }
  }
}

template <typename T, int JV>
int launch_jv(const void* rows, const void* ry, const void* rx,
              const void* mm, const void* weight, void* out, int nb,
              int k_taps, int blk, int win, int c, int g, int co, int nbx,
              void* stream) {
  const size_t smem = smem_bytes(c, g, co);
  cudaError_t err = cudaFuncSetAttribute(
      window_contract_kernel<T, JV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tiles =
      (static_cast<int64_t>(nb) * blk * blk + PIX - 1) / PIX;
  window_contract_kernel<T, JV><<<static_cast<unsigned>(tiles), THREADS, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(rows), static_cast<const float*>(ry),
      static_cast<const float*>(rx), static_cast<const float*>(mm),
      static_cast<const float*>(weight), static_cast<float*>(out), nb, k_taps,
      blk, win, c, g, co, nbx);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* rows, const void* ry, const void* rx, const void* mm,
           const void* weight, void* out, int nb, int k_taps, int blk,
           int win, int c, int g, int co, int nbx, void* stream) {
  const int64_t tiles =
      (static_cast<int64_t>(nb) * blk * blk + PIX - 1) / PIX;
  if (nb < 1 || k_taps < 1 || blk < 1 || win < 1 || g < 1 || c % g ||
      c % 4 || c < 4 || co < 1 || nbx < 1 || nb % nbx ||
      tiles > 0x7fffffff || smem_bytes(c, g, co) > MAX_SMEM)
    return static_cast<int>(cudaErrorInvalidValue);
  switch ((co + 63) / 64) {
    case 1:
      return launch_jv<T, 1>(rows, ry, rx, mm, weight, out, nb, k_taps, blk,
                             win, c, g, co, nbx, stream);
    case 2:
      return launch_jv<T, 2>(rows, ry, rx, mm, weight, out, nb, k_taps, blk,
                             win, c, g, co, nbx, stream);
    case 3:
      return launch_jv<T, 3>(rows, ry, rx, mm, weight, out, nb, k_taps, blk,
                             win, c, g, co, nbx, stream);
    case 4:
      return launch_jv<T, 4>(rows, ry, rx, mm, weight, out, nb, k_taps, blk,
                             win, c, g, co, nbx, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

#define C2M_WINDOW_ENTRY(NAME, T)                                             \
  extern "C" int NAME(const void* rows, const void* ry, const void* rx,       \
                      const void* mm, const void* weight, void* out, int nb,  \
                      int k_taps, int blk, int win, int c, int g, int co,     \
                      int nbx, void* stream) {                                \
    return launch<T>(rows, ry, rx, mm, weight, out, nb, k_taps, blk, win, c,  \
                     g, co, nbx, stream);                                     \
  }

C2M_WINDOW_ENTRY(c2m_window_contract_f32, float)
C2M_WINDOW_ENTRY(c2m_window_contract_bf16, __nv_bfloat16)
