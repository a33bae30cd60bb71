// Conv epilogue for Hopper, sm_90a: in place on a conv's NHWC output y,
//   y = act(y + bias) [+ residual]
// with act none, ReLU or leaky ReLU(slope), in one pass over y.
//
// Replaces no TPU kernel. XLA fuses a convolution's bias, activation and
// residual add into the convolution's output on the TPU; PyTorch's cuDNN
// path does not: it runs the convolution, then adds the bias in a generic
// broadcast kernel (the (1, C, 1, 1) bias has stride 0 over the pixels of a
// channels-last output, which takes TensorIterator off its vectorised
// path), then runs the ReLU, the leaky ReLU and the residual add as passes
// of their own. This kernel takes their place after a convolution that
// cuDNN ran without a bias.
//
// What bounds it on this card: bytes. It reads y (and the residual) and
// writes y once, a few operations an element. At the restoration net's
// relu1 blocks at batch 16 (16 x 336 x 512 x 64, f32) a pass with a
// residual moves 2.64 GB, 0.79 ms at 3.35 TB/s.
//
// Design: 16-byte loads and stores a thread (4 f32 or 8 bf16 values), in a
// grid-stride loop over a grid sized from the SM count and the occupancy,
// four vectors loaded before any is written so that enough bytes are in
// flight. The grid's stride is cut to a multiple of the vectors in a
// pixel, so every vector a thread touches starts at the same channel: the
// thread reads its bias vector once, through __ldg, and divides nothing in
// the loop. A C that is not a multiple of the vector width (the final
// conv's C = 3), or a pointer that is not 16-byte aligned, takes the same
// loop one element at a time.
//
// Semantics: the values of the unfused sequence bit for bit. The bias is
// added in f32 and rounded to y's type, as PyTorch's add_ after
// cudnn_convolution; the leaky ReLU multiplies in f32 (x > 0 ? x : x * slope)
// and rounds, as F.leaky_relu; the ReLU keeps a NaN, as clamp_min; the
// residual is added in f32 and rounded, as residual + out. The adds and the
// multiply are __fadd_rn / __fmul_rn, so no FMA contracts two roundings into
// one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_LEAKY = 2 };

// One element's bits and its round trip through f32.
template <typename T> struct Elem;

template <> struct Elem<float> {
  using Bits = uint32_t;
  __device__ __forceinline__ static float get(uint32_t b) {
    return __uint_as_float(b);
  }
  __device__ __forceinline__ static uint32_t put(float v) {
    return __float_as_uint(v);
  }
  __device__ __forceinline__ static float round(float v) { return v; }
};

template <> struct Elem<__nv_bfloat16> {
  using Bits = uint16_t;
  __device__ __forceinline__ static float get(uint16_t b) {
    return __uint_as_float(static_cast<uint32_t>(b) << 16);
  }
  // round to nearest even, as c10::BFloat16 from float
  __device__ __forceinline__ static uint16_t put(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
  __device__ __forceinline__ static float round(float v) { return get(put(v)); }
};

// A word of 16 bytes, or of one element for the scalar loop.
template <int BYTES> struct Word;
template <> struct Word<16> { using type = uint4; };
template <> struct Word<4> { using type = uint32_t; };
template <> struct Word<2> { using type = uint16_t; };

// N elements of type T as one word
template <typename T, int N> union Pack {
  using Bits = typename Elem<T>::Bits;
  using W = typename Word<sizeof(Bits) * N>::type;
  W word;
  Bits bits[N];
};

template <typename T, int N, int ACT, bool RES>
__global__ void __launch_bounds__(THREADS)
    epilogue_kernel(typename Pack<T, N>::W* __restrict__ y,
                    const typename Pack<T, N>::W* __restrict__ bias,
                    const typename Pack<T, N>::W* __restrict__ res,
                    int64_t n_packs, int c_packs, int64_t stride, float slope) {
  using E = Elem<T>;
  using P = Pack<T, N>;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (t >= stride) return;
  // stride is a multiple of c_packs: each pack of this thread starts at the
  // same channel
  P b;
  b.word = __ldg(bias + t % c_packs);
  float bf[N];
#pragma unroll
  for (int j = 0; j < N; ++j) bf[j] = E::get(b.bits[j]);

  for (int64_t base = t; base < n_packs; base += UNROLL * stride) {
    P v[UNROLL];
    P r[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t i = base + u * stride;
      if (i < n_packs) {
        v[u].word = y[i];
        if (RES) r[u].word = __ldg(res + i);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t i = base + u * stride;
      if (i < n_packs) {
#pragma unroll
        for (int j = 0; j < N; ++j) {
          float a = E::round(__fadd_rn(E::get(v[u].bits[j]), bf[j]));
          if (ACT == ACT_RELU) {
            a = (a > 0.f || a != a) ? a : 0.f;
          } else if (ACT == ACT_LEAKY) {
            a = a > 0.f ? a : E::round(__fmul_rn(a, slope));
          }
          if (RES) a = E::round(__fadd_rn(E::get(r[u].bits[j]), a));
          v[u].bits[j] = E::put(a);
        }
        y[i] = v[u].word;
      }
    }
  }
}

template <typename T, int N, int ACT, bool RES>
cudaError_t run(void* y, const void* bias, const void* res, int64_t n, int c,
                float slope, cudaStream_t stream) {
  using W = typename Pack<T, N>::W;
  auto kernel = epilogue_kernel<T, N, ACT, RES>;
  const int64_t n_packs = n / N;
  const int c_packs = c / N;
  const int64_t full = static_cast<int64_t>(c2m::sm_count()) *
                       c2m::blocks_per_sm(kernel, THREADS, 0);
  int64_t blocks = (n_packs + THREADS - 1) / THREADS;
  if (full > 0 && blocks > full) blocks = full;
  // a pixel's packs never outnumber the threads: n_packs >= c_packs, and
  // full blocks hold far more threads than a conv has channels
  if (blocks * THREADS < c_packs) blocks = (c_packs + THREADS - 1) / THREADS;
  const int64_t stride = blocks * THREADS / c_packs * c_packs;
  kernel<<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      static_cast<W*>(y), static_cast<const W*>(bias),
      static_cast<const W*>(res), n_packs, c_packs, stride, slope);
  return cudaGetLastError();
}

template <typename T, int N>
cudaError_t run_act(void* y, const void* bias, const void* res, int64_t n,
                    int c, int act, float slope, cudaStream_t s) {
  switch (act) {
    case ACT_NONE:
      return res ? run<T, N, ACT_NONE, true>(y, bias, res, n, c, slope, s)
                 : run<T, N, ACT_NONE, false>(y, bias, res, n, c, slope, s);
    case ACT_RELU:
      return res ? run<T, N, ACT_RELU, true>(y, bias, res, n, c, slope, s)
                 : run<T, N, ACT_RELU, false>(y, bias, res, n, c, slope, s);
    case ACT_LEAKY:
      return res ? run<T, N, ACT_LEAKY, true>(y, bias, res, n, c, slope, s)
                 : run<T, N, ACT_LEAKY, false>(y, bias, res, n, c, slope, s);
    default:
      return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
int launch(void* y, const void* bias, const void* res, long long n, int c,
           int act, float slope, void* stream) {
  if (n < 0 || c < 1 || n % c) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  constexpr int V = 16 / sizeof(T);
  const bool vector = c % V == 0 && aligned16(y) && aligned16(bias) &&
                      (res == nullptr || aligned16(res));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      vector ? run_act<T, V>(y, bias, res, n, c, act, slope, s)
             : run_act<T, 1>(y, bias, res, n, c, act, slope, s);
  return static_cast<int>(err);
}

}  // namespace

// y: n elements, C-innermost (n a multiple of c); bias: c elements; res:
// n elements or null. act: 0 none, 1 ReLU, 2 leaky ReLU(slope). Launches
// on `stream` and returns cudaGetLastError() (0 on success).
#define C2M_EPILOGUE_ENTRY(NAME, T)                                         \
  extern "C" int NAME(void* y, const void* bias, const void* res,           \
                      long long n, int c, int act, float slope,             \
                      void* stream) {                                       \
    return launch<T>(y, bias, res, n, c, act, slope, stream);               \
  }

C2M_EPILOGUE_ENTRY(c2m_conv_epilogue_f32, float)
C2M_EPILOGUE_ENTRY(c2m_conv_epilogue_bf16, __nv_bfloat16)
