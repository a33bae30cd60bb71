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
// bucket (512 x 384 x 64, G = 8, K = 9) the f32 columns are 453 MB per
// image, written once; the four corner reads of x (50 MB) come mostly from
// L2, since neighbouring taps and pixels share corners. At 3.35 TB/s the
// writes alone take about 0.14 ms.
//
// Design: one thread per (pixel, tap, group) sample, or 2 or 4 lanes where
// the group holds 2 or 4+ vectors of 16 bytes (f32: Cg = 8 and 16+; bf16:
// Cg = 16 and 32+). The sample point, the validity test,
// the four corner weights, the offset and the mask are computed and read
// once per sample, not once per channel. The lanes then loop over the
// group's Cg channels with 16-byte loads of the four corners and 16-byte
// streaming stores of the columns (4 channels per vector in f32, 8 in
// bf16); the lanes of a sample take interleaved vectors, so each store
// instruction of a sample is one contiguous run. A Cg that is not a
// multiple of the vector width (or an x that is not 16-byte aligned) takes
// the scalar channel loop. Consecutive samples are consecutive (tap, group)
// pairs of one pixel, so a warp's stores cover one contiguous run of the
// row cols[p, :] and its corner reads are contiguous channels of NHWC x.
// Index math is 32-bit where every extent of the image fits, else the
// 64-bit instantiation runs. A grid-stride loop over a grid sized from the
// SM count and the occupancy; each thread carries its sample's indices
// from one stride to the next instead of dividing.
//
// Semantics (c2matching_tpu/ops/deform_conv.py:60-67): a tap is zero unless
// -1 < y < H and -1 < x < W; the test comes before any conversion to int,
// so offsets of 1e4 or more (or NaN) give exact zeros and never an
// out-of-bounds read. Corners outside the image contribute zero.
// Coordinates and weights are f32; x is f32 or bf16 and the columns are
// stored in x's type. The arithmetic per channel is the plain version's:
// the weighted corners summed in order, then times the mask.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

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

// 16 bytes of x's type: load into f32, store from f32
template <typename T> struct Vec16;

template <> struct Vec16<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float (&v)[N]) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  }
  __device__ __forceinline__ static void store(float* p, const float (&v)[N]) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  }
};

template <> struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float (&v)[N]) {
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p,
                                               const float (&v)[N]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&b);
    }
    __stcs(reinterpret_cast<uint4*>(p), make_uint4(w[0], w[1], w[2], w[3]));
  }
};

// One (pixel, tap, group) sample: the lane's vectors (VEC) or channels of
// the columns cols[p, k * C + group * Cg + ...].
template <typename T, typename I, bool VEC>
__device__ __forceinline__ void im2col_sample(
    const T* __restrict__ x, const float* __restrict__ offset,
    const float* __restrict__ mask, T* __restrict__ cols, int h, int w,
    int c, int g, int k_taps, int kw, int sh, int sw, int ph, int pw, int dh,
    int dw, int lanes, int lane, I p, int oy, int ox, int k, int gi) {
  using V = Vec16<T>;
  const int cg = c / g;
  const I om = (p * g + gi) * k_taps + k;
  int ky = 0;
  int kx = k;
  while (kx >= kw) {  // k / kw and k % kw, for a few taps a row
    kx -= kw;
    ++ky;
  }
  const float y =
      static_cast<float>(oy * sh - ph + ky * dh) + offset[2 * om];
  const float xs =
      static_cast<float>(ox * sw - pw + kx * dw) + offset[2 * om + 1];
  T* out = cols + (p * k_taps + k) * c + gi * cg;

  if (!(y > -1.f && y < static_cast<float>(h) && xs > -1.f &&
        xs < static_cast<float>(w))) {
    if constexpr (VEC) {
      float zero[V::N];
#pragma unroll
      for (int i = 0; i < V::N; ++i) zero[i] = 0.f;
      for (int ch = lane * V::N; ch < cg; ch += lanes * V::N)
        V::store(out + ch, zero);
    } else {
      for (int ch = lane; ch < cg; ch += lanes) out[ch] = from_f32<T>(0.f);
    }
    return;
  }

  const float y0f = floorf(y);
  const float x0f = floorf(xs);
  const float fy = y - y0f;
  const float fx = xs - x0f;
  const int y0 = static_cast<int>(y0f);
  const int x0 = static_cast<int>(x0f);
  const float w00 = (1.f - fy) * (1.f - fx);
  const float w01 = (1.f - fy) * fx;
  const float w10 = fy * (1.f - fx);
  const float w11 = fy * fx;
  const bool ok00 = y0 >= 0 && x0 >= 0;
  const bool ok01 = y0 >= 0 && x0 + 1 < w;
  const bool ok10 = y0 + 1 < h && x0 >= 0;
  const bool ok11 = y0 + 1 < h && x0 + 1 < w;
  // only the corners inside the image are read
  const T* p00 = x + (static_cast<I>(y0) * w + x0) * c + gi * cg;
  const T* p01 = p00 + c;
  const T* p10 = p00 + static_cast<I>(w) * c;
  const T* p11 = p10 + c;
  const float m = mask[om];

  if constexpr (VEC) {
    for (int ch = lane * V::N; ch < cg; ch += lanes * V::N) {
      float v[V::N], cr[V::N];
#pragma unroll
      for (int i = 0; i < V::N; ++i) v[i] = 0.f;
      if (ok00) {
        V::load(p00 + ch, cr);
#pragma unroll
        for (int i = 0; i < V::N; ++i) v[i] += w00 * cr[i];
      }
      if (ok01) {
        V::load(p01 + ch, cr);
#pragma unroll
        for (int i = 0; i < V::N; ++i) v[i] += w01 * cr[i];
      }
      if (ok10) {
        V::load(p10 + ch, cr);
#pragma unroll
        for (int i = 0; i < V::N; ++i) v[i] += w10 * cr[i];
      }
      if (ok11) {
        V::load(p11 + ch, cr);
#pragma unroll
        for (int i = 0; i < V::N; ++i) v[i] += w11 * cr[i];
      }
#pragma unroll
      for (int i = 0; i < V::N; ++i) v[i] *= m;
      V::store(out + ch, v);
    }
  } else {
    for (int ch = lane; ch < cg; ch += lanes) {
      float v = 0.f;
      if (ok00) v += w00 * to_f32(p00[ch]);
      if (ok01) v += w01 * to_f32(p01[ch]);
      if (ok10) v += w10 * to_f32(p10[ch]);
      if (ok11) v += w11 * to_f32(p11[ch]);
      out[ch] = from_f32<T>(v * m);
    }
  }
}

// I: the index type (int or int64_t). VEC: Cg is a multiple of the vector
// width and x is 16-byte aligned. Thread e takes lane e % lanes of sample
// s = e / lanes = ((p * K) + k) * G + group, p = oy * Wo + ox. The grid
// stride is a multiple of the lanes, so a thread keeps its lane, and its
// sample advances by a fixed step: the loop carries (group, k, ox, oy)
// forward with compares instead of dividing each time.
template <typename T, typename I, bool VEC>
__global__ void __launch_bounds__(THREADS)
mdc_im2col_kernel(const T* __restrict__ x, const float* __restrict__ offset,
                  const float* __restrict__ mask, T* __restrict__ cols, int h,
                  int w, int c, int ho, int wo, int g, int kh, int kw, int sh,
                  int sw, int ph, int pw, int dh, int dw, int lane_bits) {
  const int k_taps = kh * kw;
  const int lanes = 1 << lane_bits;
  const I n_threads = (static_cast<I>(ho) * wo * k_taps * g) << lane_bits;
  const I stride = static_cast<I>(gridDim.x) * THREADS;
  I e = static_cast<I>(blockIdx.x) * THREADS + threadIdx.x;
  if (e >= n_threads) return;
  const int lane = static_cast<int>(e) & (lanes - 1);
  // the first sample, and the step, as (p, k, group) and p as (oy, ox)
  const I s0 = e >> lane_bits;
  const I step = stride >> lane_bits;
  int gi = static_cast<int>(s0 % g);
  int k = static_cast<int>((s0 / g) % k_taps);
  I p = s0 / g / k_taps;
  int oy = static_cast<int>(p / wo);
  int ox = static_cast<int>(p % wo);
  const int d_gi = static_cast<int>(step % g);
  const int d_k = static_cast<int>((step / g) % k_taps);
  const I d_p = step / g / k_taps;
  const int d_oy = static_cast<int>(d_p / wo);
  const int d_ox = static_cast<int>(d_p % wo);
  for (; e < n_threads; e += stride) {
    im2col_sample<T, I, VEC>(x, offset, mask, cols, h, w, c, g, k_taps, kw,
                             sh, sw, ph, pw, dh, dw, lanes, lane, p, oy, ox,
                             k, gi);
    gi += d_gi;
    int carry = gi >= g;
    gi -= carry ? g : 0;
    k += d_k + carry;
    carry = k >= k_taps;
    k -= carry ? k_taps : 0;
    ox += d_ox + carry;
    carry = ox >= wo;
    ox -= carry ? wo : 0;
    oy += d_oy + carry;
    p = static_cast<I>(oy) * wo + ox;
  }
}

template <typename T, typename I, bool VEC>
cudaError_t run(const void* x, const void* offset, const void* mask,
                void* cols, int64_t n_threads, int h, int w, int c, int ho,
                int wo, int g, int kh, int kw, int sh, int sw, int ph, int pw,
                int dh, int dw, int lane_bits, cudaStream_t stream) {
  const auto kernel = mdc_im2col_kernel<T, I, VEC>;
  const int64_t resident = static_cast<int64_t>(c2m::sm_count()) *
                           c2m::blocks_per_sm(kernel, THREADS, 0);
  int64_t blocks = (n_threads + THREADS - 1) / THREADS;
  if (blocks > resident && resident > 0) blocks = resident;
  if (blocks < 1) blocks = 1;
  kernel<<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(offset),
      static_cast<const float*>(mask), static_cast<T*>(cols), h, w, c, ho,
      wo, g, kh, kw, sh, sw, ph, pw, dh, dw, lane_bits);
  return cudaGetLastError();
}

template <typename T, bool VEC>
cudaError_t run_index(bool narrow, const void* x, const void* offset,
                      const void* mask, void* cols, int64_t n_threads,
                      int h, int w, int c, int ho, int wo, int g, int kh,
                      int kw, int sh, int sw, int ph, int pw, int dh, int dw,
                      int lane_bits, cudaStream_t s) {
  return narrow
             ? run<T, int, VEC>(x, offset, mask, cols, n_threads, h, w, c, ho,
                                wo, g, kh, kw, sh, sw, ph, pw, dh, dw,
                                lane_bits, s)
             : run<T, int64_t, VEC>(x, offset, mask, cols, n_threads, h, w, c,
                                    ho, wo, g, kh, kw, sh, sw, ph, pw, dh, dw,
                                    lane_bits, s);
}

template <typename T>
int launch(const void* x, const void* offset, const void* mask, void* cols,
           int h, int w, int c, int ho, int wo, int g, int kh, int kw, int sh,
           int sw, int ph, int pw, int dh, int dw, void* stream) {
  if (g < 1 || c % g) return static_cast<int>(cudaErrorInvalidValue);
  const int cg = c / g;
  constexpr int vec = Vec16<T>::N;
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16) == 0 &&
                       (reinterpret_cast<uintptr_t>(cols) % 16) == 0;
  const bool vector = cg % vec == 0 && aligned;
  // one lane per 16-byte vector of the group, at most 4 (2 bits)
  const int vectors = vector ? cg / vec : 1;
  const int lane_bits = vectors >= 4 ? 2 : (vectors >= 2 ? 1 : 0);
  const int64_t taps = static_cast<int64_t>(kh) * kw;
  const int64_t n_threads =
      (static_cast<int64_t>(ho) * wo * taps * g) << lane_bits;
  // 32-bit indices hold every index of this image: the threads plus one
  // grid stride, the column and offset elements, and the corner pointers
  // (up to one row past x)
  const int64_t sm_grid = static_cast<int64_t>(c2m::sm_count()) * 2048;
  const int64_t largest = [&] {
    int64_t m = n_threads + sm_grid;
    const int64_t n_cols = static_cast<int64_t>(ho) * wo * taps * c;
    const int64_t n_off = 2 * static_cast<int64_t>(ho) * wo * taps * g;
    const int64_t n_x = (static_cast<int64_t>(h) + 2) * w * c;
    if (n_cols > m) m = n_cols;
    if (n_off > m) m = n_off;
    if (n_x > m) m = n_x;
    return m;
  }();
  const bool narrow = largest < (int64_t{1} << 31);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      vector ? run_index<T, true>(narrow, x, offset, mask, cols, n_threads, h,
                                  w, c, ho, wo, g, kh, kw, sh, sw, ph, pw, dh,
                                  dw, lane_bits, s)
             : run_index<T, false>(narrow, x, offset, mask, cols, n_threads,
                                   h, w, c, ho, wo, g, kh, kw, sh, sw, ph, pw,
                                   dh, dw, lane_bits, s);
  return static_cast<int>(err);
}

// ---------------------------------------------------------------- backward
//
// The gradient of the columns above: given grad_cols (P, K * C) in f32,
//   grad_mask[p, g, k]      = valid * sum_c G[c] * sample(c)
//   grad_offset[p, g, k, :] = valid * m * sum_c G[c] * d sample(c) / d(y, x)
//   grad_x[corner, c]      += valid * m * w_corner * G[c]  (corners inside)
// with G = grad_cols[p, k * C + c] over the group's channels and sample(c)
// the unmodulated bilinear sample. This is what jax.grad gives through the
// JAX package's _mdc_fast_single: floor has zero derivative, so
// d fy / d y = 1; a sample outside -1 < y < H, -1 < x < W contributes
// nothing; corners outside the image are zeros, so they add nothing to the
// offset gradient and receive no grad_x.
//
// What bounds it on this card: bytes. grad_cols (P * K * C f32) is read
// once and is most of the traffic; the corner reads of x come mostly from
// L2; the offset and mask gradients are 3 floats per sample. grad_x, when
// asked for, is a scatter of 4 f32 atomics per column element into an f32
// buffer (a bf16 x is cast once afterwards by the wrapper).
//
// Design: the forward's layout. One thread, or 2-4 lanes, per (pixel, tap,
// group) sample; the lanes take interleaved 16-byte vectors of the group's
// channels of grad_cols and of the four corners and keep one dot product
// per corner in registers; the lanes' sums meet by shuffles within the
// sample's lanes (consecutive threads of one warp); the first lane turns the
// four corner dots into the mask gradient and the two offset gradients and
// writes them (zeros for a sample outside the image). The same grid-stride
// loop, carried indices and 32-bit / 64-bit index split as the forward.

// 16 bytes of x's type as f32 (Vec16), and the matching f32 values of
// grad_cols: one float4 for f32 x, two for bf16 x
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p + i));
    v[i] = t.x; v[i + 1] = t.y; v[i + 2] = t.z; v[i + 3] = t.w;
  }
}

template <typename T, typename I, bool VEC>
__device__ __forceinline__ void col2im_sample(
    const T* __restrict__ x, const float* __restrict__ offset,
    const float* __restrict__ mask, const float* __restrict__ gcols,
    float* __restrict__ g_offset, float* __restrict__ g_mask,
    float* __restrict__ g_x, int h, int w, int c, int g, int k_taps, int kw,
    int sh, int sw, int ph, int pw, int dh, int dw, int lanes, int lane,
    unsigned lane_mask, I p, int oy, int ox, int k, int gi) {
  using V = Vec16<T>;
  const int cg = c / g;
  const I om = (p * g + gi) * k_taps + k;
  int ky = 0;
  int kx = k;
  while (kx >= kw) {
    kx -= kw;
    ++ky;
  }
  const float y =
      static_cast<float>(oy * sh - ph + ky * dh) + offset[2 * om];
  const float xs =
      static_cast<float>(ox * sw - pw + kx * dw) + offset[2 * om + 1];
  const bool valid = y > -1.f && y < static_cast<float>(h) && xs > -1.f &&
                     xs < static_cast<float>(w);
  // the dots of the group's grad_cols with each corner's values
  float d00 = 0.f, d01 = 0.f, d10 = 0.f, d11 = 0.f;
  float fy = 0.f, fx = 0.f, m = 0.f;
  if (valid) {
    const float y0f = floorf(y);
    const float x0f = floorf(xs);
    fy = y - y0f;
    fx = xs - x0f;
    const int y0 = static_cast<int>(y0f);
    const int x0 = static_cast<int>(x0f);
    const bool ok00 = y0 >= 0 && x0 >= 0;
    const bool ok01 = y0 >= 0 && x0 + 1 < w;
    const bool ok10 = y0 + 1 < h && x0 >= 0;
    const bool ok11 = y0 + 1 < h && x0 + 1 < w;
    const I corner = (static_cast<I>(y0) * w + x0) * c + gi * cg;
    const T* p00 = x + corner;
    const T* p01 = p00 + c;
    const T* p10 = p00 + static_cast<I>(w) * c;
    const T* p11 = p10 + c;
    const float* gp = gcols + (p * k_taps + k) * c + gi * cg;
    m = mask[om];
    // grad_x: m * corner weight * G onto each corner inside the image, at
    // g_x + corner + (0, o01, o10, o11)
    const I o01 = c;
    const I o10 = static_cast<I>(w) * c;
    const I o11 = o10 + c;
    const float s00 = m * (1.f - fy) * (1.f - fx);
    const float s01 = m * (1.f - fy) * fx;
    const float s10 = m * fy * (1.f - fx);
    const float s11 = m * fy * fx;
    if constexpr (VEC) {
      for (int ch = lane * V::N; ch < cg; ch += lanes * V::N) {
        float gv[V::N], cr[V::N];
        load_f32<V::N>(gp + ch, gv);
        if (ok00) {
          V::load(p00 + ch, cr);
#pragma unroll
          for (int i = 0; i < V::N; ++i) d00 += gv[i] * cr[i];
        }
        if (ok01) {
          V::load(p01 + ch, cr);
#pragma unroll
          for (int i = 0; i < V::N; ++i) d01 += gv[i] * cr[i];
        }
        if (ok10) {
          V::load(p10 + ch, cr);
#pragma unroll
          for (int i = 0; i < V::N; ++i) d10 += gv[i] * cr[i];
        }
        if (ok11) {
          V::load(p11 + ch, cr);
#pragma unroll
          for (int i = 0; i < V::N; ++i) d11 += gv[i] * cr[i];
        }
        if (g_x != nullptr) {
#pragma unroll
          for (int i = 0; i < V::N; ++i) {
            float* at = g_x + (corner + ch + i);
            if (ok00) atomicAdd(at, s00 * gv[i]);
            if (ok01) atomicAdd(at + o01, s01 * gv[i]);
            if (ok10) atomicAdd(at + o10, s10 * gv[i]);
            if (ok11) atomicAdd(at + o11, s11 * gv[i]);
          }
        }
      }
    } else {
      for (int ch = lane; ch < cg; ch += lanes) {
        const float gv = gp[ch];
        if (ok00) d00 += gv * to_f32(p00[ch]);
        if (ok01) d01 += gv * to_f32(p01[ch]);
        if (ok10) d10 += gv * to_f32(p10[ch]);
        if (ok11) d11 += gv * to_f32(p11[ch]);
        if (g_x != nullptr) {
          float* at = g_x + (corner + ch);
          if (ok00) atomicAdd(at, s00 * gv);
          if (ok01) atomicAdd(at + o01, s01 * gv);
          if (ok10) atomicAdd(at + o10, s10 * gv);
          if (ok11) atomicAdd(at + o11, s11 * gv);
        }
      }
    }
  }
  // every lane of a sample is active here (the sample's lanes enter and
  // leave the loop together), and only they are named in lane_mask
  for (int o = lanes >> 1; o > 0; o >>= 1) {
    d00 += __shfl_xor_sync(lane_mask, d00, o);
    d01 += __shfl_xor_sync(lane_mask, d01, o);
    d10 += __shfl_xor_sync(lane_mask, d10, o);
    d11 += __shfl_xor_sync(lane_mask, d11, o);
  }
  if (lane != 0) return;
  if (g_mask != nullptr)
    g_mask[om] = valid ? (1.f - fy) * (1.f - fx) * d00 + (1.f - fy) * fx * d01 +
                             fy * (1.f - fx) * d10 + fy * fx * d11
                       : 0.f;
  if (g_offset != nullptr) {
    // d/dy and d/dx of the four corner weights, times the corner dots
    const float gy = (1.f - fx) * (d10 - d00) + fx * (d11 - d01);
    const float gx = (1.f - fy) * (d01 - d00) + fy * (d11 - d10);
    g_offset[2 * om] = valid ? m * gy : 0.f;
    g_offset[2 * om + 1] = valid ? m * gx : 0.f;
  }
}

template <typename T, typename I, bool VEC>
__global__ void __launch_bounds__(THREADS)
mdc_col2im_kernel(const T* __restrict__ x, const float* __restrict__ offset,
                  const float* __restrict__ mask,
                  const float* __restrict__ gcols, float* __restrict__ g_offset,
                  float* __restrict__ g_mask, float* __restrict__ g_x, int h,
                  int w, int c, int ho, int wo, int g, int kh, int kw, int sh,
                  int sw, int ph, int pw, int dh, int dw, int lane_bits) {
  const int k_taps = kh * kw;
  const int lanes = 1 << lane_bits;
  const I n_threads = (static_cast<I>(ho) * wo * k_taps * g) << lane_bits;
  const I stride = static_cast<I>(gridDim.x) * THREADS;
  I e = static_cast<I>(blockIdx.x) * THREADS + threadIdx.x;
  if (e >= n_threads) return;
  const int lane = static_cast<int>(e) & (lanes - 1);
  // the sample's lanes: consecutive threads of one warp
  const int first = (threadIdx.x & 31) & ~(lanes - 1);
  const unsigned lane_mask =
      (lanes == 32 ? 0xffffffffu : ((1u << lanes) - 1u)) << first;
  const I s0 = e >> lane_bits;
  const I step = stride >> lane_bits;
  int gi = static_cast<int>(s0 % g);
  int k = static_cast<int>((s0 / g) % k_taps);
  I p = s0 / g / k_taps;
  int oy = static_cast<int>(p / wo);
  int ox = static_cast<int>(p % wo);
  const int d_gi = static_cast<int>(step % g);
  const int d_k = static_cast<int>((step / g) % k_taps);
  const I d_p = step / g / k_taps;
  const int d_oy = static_cast<int>(d_p / wo);
  const int d_ox = static_cast<int>(d_p % wo);
  for (; e < n_threads; e += stride) {
    col2im_sample<T, I, VEC>(x, offset, mask, gcols, g_offset, g_mask, g_x, h,
                             w, c, g, k_taps, kw, sh, sw, ph, pw, dh, dw,
                             lanes, lane, lane_mask, p, oy, ox, k, gi);
    gi += d_gi;
    int carry = gi >= g;
    gi -= carry ? g : 0;
    k += d_k + carry;
    carry = k >= k_taps;
    k -= carry ? k_taps : 0;
    ox += d_ox + carry;
    carry = ox >= wo;
    ox -= carry ? wo : 0;
    oy += d_oy + carry;
    p = static_cast<I>(oy) * wo + ox;
  }
}

template <typename T, typename I, bool VEC>
cudaError_t run_col2im(const void* x, const void* offset, const void* mask,
                       const void* gcols, void* g_offset, void* g_mask,
                       void* g_x, int64_t n_threads, int h, int w, int c,
                       int ho, int wo, int g, int kh, int kw, int sh, int sw,
                       int ph, int pw, int dh, int dw, int lane_bits,
                       cudaStream_t stream) {
  const auto kernel = mdc_col2im_kernel<T, I, VEC>;
  const int64_t resident = static_cast<int64_t>(c2m::sm_count()) *
                           c2m::blocks_per_sm(kernel, THREADS, 0);
  int64_t blocks = (n_threads + THREADS - 1) / THREADS;
  if (blocks > resident && resident > 0) blocks = resident;
  if (blocks < 1) blocks = 1;
  kernel<<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(offset),
      static_cast<const float*>(mask), static_cast<const float*>(gcols),
      static_cast<float*>(g_offset), static_cast<float*>(g_mask),
      static_cast<float*>(g_x), h, w, c, ho, wo, g, kh, kw, sh, sw, ph, pw,
      dh, dw, lane_bits);
  return cudaGetLastError();
}

template <typename T, bool VEC>
cudaError_t run_col2im_index(bool narrow, const void* x, const void* offset,
                             const void* mask, const void* gcols,
                             void* g_offset, void* g_mask, void* g_x,
                             int64_t n_threads, int h, int w, int c, int ho,
                             int wo, int g, int kh, int kw, int sh, int sw,
                             int ph, int pw, int dh, int dw, int lane_bits,
                             cudaStream_t s) {
  return narrow ? run_col2im<T, int, VEC>(x, offset, mask, gcols, g_offset,
                                          g_mask, g_x, n_threads, h, w, c, ho,
                                          wo, g, kh, kw, sh, sw, ph, pw, dh,
                                          dw, lane_bits, s)
                : run_col2im<T, int64_t, VEC>(
                      x, offset, mask, gcols, g_offset, g_mask, g_x,
                      n_threads, h, w, c, ho, wo, g, kh, kw, sh, sw, ph, pw,
                      dh, dw, lane_bits, s);
}

template <typename T>
int launch_col2im(const void* x, const void* offset, const void* mask,
                  const void* gcols, void* g_offset, void* g_mask, void* g_x,
                  int h, int w, int c, int ho, int wo, int g, int kh, int kw,
                  int sh, int sw, int ph, int pw, int dh, int dw,
                  void* stream) {
  if (g < 1 || c % g) return static_cast<int>(cudaErrorInvalidValue);
  const int cg = c / g;
  constexpr int vec = Vec16<T>::N;
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16) == 0 &&
                       (reinterpret_cast<uintptr_t>(gcols) % 16) == 0;
  const bool vector = cg % vec == 0 && aligned;
  const int vectors = vector ? cg / vec : 1;
  const int lane_bits = vectors >= 4 ? 2 : (vectors >= 2 ? 1 : 0);
  const int64_t taps = static_cast<int64_t>(kh) * kw;
  const int64_t n_threads =
      (static_cast<int64_t>(ho) * wo * taps * g) << lane_bits;
  // the forward's rule: 32-bit indices hold the threads plus one grid
  // stride, the grad_cols, offset and x elements (corners up to one row past)
  const int64_t sm_grid = static_cast<int64_t>(c2m::sm_count()) * 2048;
  int64_t largest = n_threads + sm_grid;
  const int64_t n_cols = static_cast<int64_t>(ho) * wo * taps * c;
  const int64_t n_off = 2 * static_cast<int64_t>(ho) * wo * taps * g;
  const int64_t n_x = (static_cast<int64_t>(h) + 2) * w * c;
  if (n_cols > largest) largest = n_cols;
  if (n_off > largest) largest = n_off;
  if (n_x > largest) largest = n_x;
  const bool narrow = largest < (int64_t{1} << 31);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      vector ? run_col2im_index<T, true>(narrow, x, offset, mask, gcols,
                                         g_offset, g_mask, g_x, n_threads, h,
                                         w, c, ho, wo, g, kh, kw, sh, sw, ph,
                                         pw, dh, dw, lane_bits, s)
             : run_col2im_index<T, false>(narrow, x, offset, mask, gcols,
                                          g_offset, g_mask, g_x, n_threads, h,
                                          w, c, ho, wo, g, kh, kw, sh, sw, ph,
                                          pw, dh, dw, lane_bits, s);
  return static_cast<int>(err);
}

}  // namespace

#define C2M_COL2IM_ENTRY(NAME, T)                                             \
  extern "C" int NAME(const void* x, const void* offset, const void* mask,    \
                      const void* gcols, void* g_offset, void* g_mask,        \
                      void* g_x, int h, int w, int c, int ho, int wo, int g,  \
                      int kh, int kw, int sh, int sw, int ph, int pw, int dh, \
                      int dw, void* stream) {                                 \
    return launch_col2im<T>(x, offset, mask, gcols, g_offset, g_mask, g_x, h, \
                            w, c, ho, wo, g, kh, kw, sh, sw, ph, pw, dh, dw,  \
                            stream);                                          \
  }

C2M_COL2IM_ENTRY(c2m_mdc_col2im_f32, float)
C2M_COL2IM_ENTRY(c2m_mdc_col2im_bf16, __nv_bfloat16)

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
