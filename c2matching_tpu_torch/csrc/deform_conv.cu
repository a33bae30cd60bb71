// Modulated deformable im2col (kernel B3, forward) for Hopper, sm_90a.
//
// For one image, writes the modulated bilinear columns
//   cols[p, k * C + c] = mask[p, g, k] * bilinear(x[:, :, c], y, x)
// with g = c / (C / G) and the sample point
//   y = ho * stride_h - pad_h + (k / kw) * dil_h + offset[p, g, k, 0]
//   x = wo * stride_w - pad_w + (k % kw) * dil_w + offset[p, g, k, 1]
// as upstream's DCNv2 dcn_v2_im2col_cuda.cu does. The wrapper then computes
// cols @ weight.reshape(K * C, Co) in torch.matmul.
//
// Replaces the XLA formulation c2matching_tpu/ops/deform_conv.py
// (modulated_deform_conv / _mdc_fast_single), which packed the four bilinear
// corners into gathered rows because the TPU's gather is bound by its row
// rate. There is no Pallas kernel for it on the TPU side.
//
// What bounds it on this card: bytes. At the relu1 scale of the CUFED5
// bucket (512 x 336 x 64, G = 8, K = 9) the f32 columns are 396 MB per
// image, written once; the four corner reads of x (44 MB) come mostly from
// L2, since neighbouring taps and pixels share corners. At 3.35 TB/s the
// writes alone take about 0.12 ms. So one thread computes one column element:
// consecutive threads take consecutive channels, which makes both the corner
// reads (NHWC) and the column writes coalesced, and the threads of a group
// read the same offset and mask words, which the cache broadcasts.
//
// Semantics (c2matching_tpu/ops/deform_conv.py:60-67): a tap is zero unless
// -1 < y < H and -1 < x < W; the test comes before any conversion to int,
// so offsets of 1e4 or more (or NaN) give exact zeros and never an
// out-of-bounds read. Corners outside the image contribute zero.
// Coordinates and weights are f32; x is f32 or bf16 and the columns are
// stored in x's type. Index math is 64-bit: the columns of a batch can
// exceed 2^31 elements.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
mdc_im2col_kernel(const T* __restrict__ x, const float* __restrict__ offset,
                  const float* __restrict__ mask, T* __restrict__ cols, int h,
                  int w, int c, int ho, int wo, int g, int kh, int kw, int sh,
                  int sw, int ph, int pw, int dh, int dw) {
  const int k_taps = kh * kw;
  const int cg = c / g;
  const int64_t total = static_cast<int64_t>(ho) * wo * k_taps * c;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < total; e += step) {
    const int ch = static_cast<int>(e % c);
    const int64_t t = e / c;
    const int k = static_cast<int>(t % k_taps);
    const int64_t p = t / k_taps;
    const int oy = static_cast<int>(p / wo);
    const int ox = static_cast<int>(p % wo);
    const int64_t om = (p * g + ch / cg) * k_taps + k;

    const float y = static_cast<float>(oy * sh - ph + (k / kw) * dh) +
                    offset[2 * om];
    const float xs = static_cast<float>(ox * sw - pw + (k % kw) * dw) +
                     offset[2 * om + 1];
    float v = 0.f;
    if (y > -1.f && y < static_cast<float>(h) && xs > -1.f &&
        xs < static_cast<float>(w)) {
      const float y0f = floorf(y);
      const float x0f = floorf(xs);
      const float fy = y - y0f;
      const float fx = xs - x0f;
      const int y0 = static_cast<int>(y0f);
      const int x0 = static_cast<int>(x0f);
      const T* base = x + ch;
      if (y0 >= 0) {
        const T* row = base + static_cast<int64_t>(y0) * w * c;
        if (x0 >= 0) v += (1.f - fy) * (1.f - fx) * to_f32(row[static_cast<int64_t>(x0) * c]);
        if (x0 + 1 < w) v += (1.f - fy) * fx * to_f32(row[static_cast<int64_t>(x0 + 1) * c]);
      }
      if (y0 + 1 < h) {
        const T* row = base + static_cast<int64_t>(y0 + 1) * w * c;
        if (x0 >= 0) v += fy * (1.f - fx) * to_f32(row[static_cast<int64_t>(x0) * c]);
        if (x0 + 1 < w) v += fy * fx * to_f32(row[static_cast<int64_t>(x0 + 1) * c]);
      }
      v *= mask[om];
    }
    cols[e] = from_f32<T>(v);
  }
}

template <typename T>
int launch(const void* x, const void* offset, const void* mask, void* cols,
           int h, int w, int c, int ho, int wo, int g, int kh, int kw, int sh,
           int sw, int ph, int pw, int dh, int dw, void* stream) {
  const int64_t total = static_cast<int64_t>(ho) * wo * kh * kw * c;
  int64_t blocks = (total + THREADS - 1) / THREADS;
  if (blocks > (int64_t{1} << 20)) blocks = int64_t{1} << 20;  // grid-stride
  if (blocks < 1) blocks = 1;
  mdc_im2col_kernel<T><<<static_cast<unsigned>(blocks), THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(offset),
      static_cast<const float*>(mask), static_cast<T*>(cols), h, w, c, ho, wo,
      g, kh, kw, sh, sw, ph, pw, dh, dw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define C2M_IM2COL_ENTRY(NAME, T)                                             \
  extern "C" int NAME(const void* x, const void* offset, const void* mask,    \
                      void* cols, int h, int w, int c, int ho, int wo, int g, \
                      int kh, int kw, int sh, int sw, int ph, int pw, int dh, \
                      int dw, void* stream) {                                 \
    return launch<T>(x, offset, mask, cols, h, w, c, ho, wo, g, kh, kw, sh,   \
                     sw, ph, pw, dh, dw, stream);                             \
  }

C2M_IM2COL_ENTRY(c2m_mdc_im2col_f32, float)
C2M_IM2COL_ENTRY(c2m_mdc_im2col_bf16, __nv_bfloat16)
