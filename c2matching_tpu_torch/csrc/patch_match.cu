// Patch-match argmax (kernel B1) for Hopper, sm_90a.
//
// For each image b and query row i:
//   idx[b, i] = argmax_j (q[b, i] . r[b, j] + bias[j]) over j < nr
//   val[b, i] = that maximum
// The first maximum wins, as torch.argmax gives it. The nq x nr scores never
// reach device memory.
//
// Replaces the TPU kernel c2matching_tpu/ops/pallas/patch_match_kernel.py
// (match_argmax, body _match_kernel). There a sequential grid axis over ref
// tiles carried a running (max, argmax) in the output block. Here one block
// owns BM query rows of one image and loops over every ref tile itself, so
// no reduction crosses blocks.
//
// What bounds it on this card: 2 * nq * nr * D flops, 646 GFLOP per image for
// a CUFED5 request padded to the eval bucket (nq = nr = 11844, D = 2304). The
// f32 operands of one image are 109 MB each; every block streams all of r,
// mostly from L2. At the SIMT f32 rate (67 TFLOP/s peak) the flops take at
// least 9.6 ms, so the
// kernel is compute-bound, and the inner loop is made of FMAs fed from
// shared memory: each thread keeps a 4 x 4 register tile of dot products and
// reads one float4 of q and one of r per k step (q and r are staged k-major
// in shared memory, so both reads are vector loads). No TF32 and no tensor
// cores: TF32 rounding flips near-tie argmaxes. bf16 operands are widened to
// f32 as they are staged; products of two bf16 values are exact in f32.
//
// Tie rule: within a thread the columns arrive in increasing j, and a value
// replaces the running best only if strictly larger. Merging the 16 threads
// that share a query row takes the larger value and, on an exact tie, the
// smaller index. So the result is the global first maximum.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;   // query rows per block
constexpr int BN = 64;   // ref rows per tile
constexpr int BK = 16;   // depth staged per step
constexpr int TM = 4;    // query rows per thread
constexpr int TN = 4;    // ref rows per thread
constexpr int TX = BN / TN;               // 16 threads across a ref tile
constexpr int THREADS = (BM / TM) * TX;   // 256
constexpr int LDS = BM + 4;  // padded stride: the transposed stores hit at
                             // most 2 lanes per bank, float4 reads stay aligned

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

__device__ __forceinline__ bool better(float v, int j, float best, int best_j) {
  return v > best || (v == best && j < best_j);
}

// Requires d % 4 == 0 and 16-byte aligned rows (the wrapper checks both).
template <typename T>
__global__ void __launch_bounds__(THREADS)
match_argmax_kernel(const T* __restrict__ q, const T* __restrict__ r,
                    const float* __restrict__ bias, int nq, int nr, int d,
                    int* __restrict__ idx_out, float* __restrict__ val_out) {
  __shared__ __align__(16) float qs[BK][LDS];
  __shared__ __align__(16) float rs[BK][LDS];
  __shared__ float red_val[BM][TX];
  __shared__ int red_idx[BM][TX];

  const int b = blockIdx.y;
  const int m0 = blockIdx.x * BM;
  q += static_cast<int64_t>(b) * nq * d;
  r += static_cast<int64_t>(b) * nr * d;

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  // staging: thread -> (row, float4 chunk along k); a warp covers 8 rows
  // of 64 contiguous bytes each
  const int lrow = tid / (BK / 4);
  const int lc = tid % (BK / 4);

  float best[TM];
  int best_j[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    best[i] = -INFINITY;
    best_j[i] = 0x7fffffff;
  }

  for (int n0 = 0; n0 < nr; n0 += BN) {
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < d; k0 += BK) {
      const int gk = k0 + 4 * lc;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      const int gm = m0 + lrow;
      if (gm < nq && gk < d) load4(q + static_cast<int64_t>(gm) * d + gk, v);
#pragma unroll
      for (int e = 0; e < 4; ++e) qs[4 * lc + e][lrow] = v[e];
      float w[4] = {0.f, 0.f, 0.f, 0.f};
      const int gn = n0 + lrow;
      if (gn < nr && gk < d) load4(r + static_cast<int64_t>(gn) * d + gk, w);
#pragma unroll
      for (int e = 0; e < 4; ++e) rs[4 * lc + e][lrow] = w[e];
      __syncthreads();

#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&qs[kk][ty * TM]);
        const float4 c = *reinterpret_cast<const float4*>(&rs[kk][tx * TN]);
        const float av[TM] = {a.x, a.y, a.z, a.w};
        const float cv[TN] = {c.x, c.y, c.z, c.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], cv[j], acc[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn < nr) {
        const float bj = bias ? bias[gn] : 0.f;
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float s = acc[i][j] + bj;
          if (better(s, gn, best[i], best_j[i])) {
            best[i] = s;
            best_j[i] = gn;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    red_val[ty * TM + i][tx] = best[i];
    red_idx[ty * TM + i][tx] = best_j[i];
  }
  __syncthreads();
  if (tid < BM) {
    float bv = red_val[tid][0];
    int bj = red_idx[tid][0];
    for (int t = 1; t < TX; ++t) {
      if (better(red_val[tid][t], red_idx[tid][t], bv, bj)) {
        bv = red_val[tid][t];
        bj = red_idx[tid][t];
      }
    }
    const int gm = m0 + tid;
    if (gm < nq) {
      idx_out[static_cast<int64_t>(b) * nq + gm] = bj;
      val_out[static_cast<int64_t>(b) * nq + gm] = bv;
    }
  }
}

template <typename T>
int launch(const void* q, const void* r, const void* bias, int batch, int nq,
           int nr, int d, void* idx, void* val, void* stream) {
  const dim3 grid((nq + BM - 1) / BM, batch);
  match_argmax_kernel<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(r),
      static_cast<const float*>(bias), nq, nr, d, static_cast<int*>(idx),
      static_cast<float*>(val));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int c2m_match_argmax_f32(const void* q, const void* r,
                                    const void* bias, int batch, int nq, int nr,
                                    int d, void* idx, void* val, void* stream) {
  return launch<float>(q, r, bias, batch, nq, nr, d, idx, val, stream);
}

extern "C" int c2m_match_argmax_bf16(const void* q, const void* r,
                                     const void* bias, int batch, int nq,
                                     int nr, int d, void* idx, void* val,
                                     void* stream) {
  return launch<__nv_bfloat16>(q, r, bias, batch, nq, nr, d, idx, val, stream);
}
