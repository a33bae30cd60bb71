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
// tiles carried a running (max, argmax) in the output block. Here a block
// owns BM query rows and a contiguous run of ref tiles (a partition of the
// ref axis) and carries the running (max, argmax) in registers; a second
// launch merges the partitions.
//
// What bounds it on this card: 2 * nq * nr * D operations, 646 GFLOP per
// image for a CUFED5 request padded to the eval bucket (nq = nr = 11844,
// D = 2304); the operands are 109 MB (f32) or 55 MB (bf16) each. So the
// work has to run on the tensor cores:
// - bf16 operands (the serving config): mma.sync m16n8k16, f32
//   accumulation; products of two bf16 values are exact in f32.
// - f32 operands: 3xTF32. Each operand splits into big = tf32(x) and
//   small = tf32(x - big) (cvt.rna, round to nearest, ties away), and
//   big*small + small*big + big*big accumulate in f32 (mma.sync m16n8k8):
//   the dropped small*small term is ~2^-22 of each product, so the scores
//   stay within f32 rounding of the exact ones. One plain TF32 pass would
//   flip near-tie argmaxes. The tensor cores truncate as they add, so the
//   three products of each 8-word step sum in a fresh fragment that one
//   rounded f32 add takes into the running sum (see stage_3xtf32).
// mma.sync and not wgmma: its operands come from registers, so the 3xTF32
// split happens between the shared-memory load and the product, and one
// kernel shape serves both types; wgmma reads B from shared memory, where
// the split would cost a separate pass over both f32 operands.
//
// Design: a 128 x 128 block tile, 8 warps of 64 x 32, and 32 words of depth
// per stage (32 f32 or 64 bf16 values) in a 3-stage cp.async ring with one
// barrier per stage; 16-byte copies into rows padded to 36 words, so the
// ldmatrix fragment loads are free of bank conflicts. 2 blocks per SM, at
// most 128 registers a thread (108 KB of shared memory a block). After
// the last stage of a ref tile each thread adds the bias to its 8 columns of
// its 8 rows, folds them into a running (max, argmax), and the 4 lanes that
// share a row merge by shuffles. Ref rows j >= nr get a bias of -inf, so
// they never win (as patch_match_kernel.py masks them).
//
// Filling the card: at the main path's 11844 queries, 128-row query tiles
// give 93 blocks for 132 SMs. So the ref axis is split into partitions
// (c2m_match_argmax_parts picks their number from the SM count and the
// occupancy); each (partition, query tile) block writes a partial
// (max, argmax) to scratch, and a second launch merges the partials. The
// partition is blockIdx.x: blocks that run at once cover a few query tiles
// and every partition, so they walk the same r tiles and r comes from L2.
//
// Tie rule: within a thread the columns arrive in increasing j, and a value
// replaces the running best only if strictly larger. Every merge (the
// lanes of a quad, the warps of a block, the partitions) takes the larger
// value and, on an exact tie, the smaller index. So the result is the
// global first maximum of the kernel's scores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace {

using namespace c2m;

constexpr int BM = 128;        // query rows per block
constexpr int BN = 128;        // ref rows per tile
constexpr int BKW = 32;        // 32-bit words of depth per stage
constexpr int LDW = BKW + 4;   // padded row stride in words
constexpr int STAGES = 3;
constexpr int WARPS_M = 2;
constexpr int WARPS_N = 4;
constexpr int THREADS = 32 * WARPS_M * WARPS_N;  // 256
constexpr int WM = BM / WARPS_M;  // 64 query rows per warp
constexpr int WN = BN / WARPS_N;  // 32 ref rows per warp
constexpr int MT = WM / 16;       // m16 tiles per warp
constexpr int NT = WN / 8;        // n8 tiles per warp
constexpr int STAGE_WORDS = (BM + BN) * LDW;
constexpr int SMEM_BYTES = STAGES * STAGE_WORDS * 4;   // 110,592
constexpr int CHUNKS = BM * (BKW / 4) / THREADS;       // 16-byte copies
constexpr int MERGE_THREADS = 256;

static_assert(BM == BN, "one copy loop stages both operands");
static_assert(2 * WARPS_N * BM <= STAGE_WORDS, "merge buffers fit");

__device__ __forceinline__ bool better(float v, int j, float best, int best_j) {
  return v > best || (v == best && j < best_j);
}

// One stage's products for a warp's 64 x 32 tile. a_addr, b_addr: the
// lane's ldmatrix row addresses in the stage (see the kernel).
__device__ __forceinline__ void load_b(uint32_t (&bf)[NT][2], uint32_t addr) {
#pragma unroll
  for (int np = 0; np < NT / 2; ++np)
    ldmatrix_x4(addr + np * 16 * LDW * 4, bf[2 * np][0], bf[2 * np][1],
                bf[2 * np + 1][0], bf[2 * np + 1][1]);
}

__device__ __forceinline__ void stage_bf16(float (&acc)[MT][NT][4],
                                           uint32_t a_addr, uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < BKW / 8; ++kk) {
    uint32_t bf[NT][2];
    load_b(bf, b_addr + kk * 32);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      uint32_t a[4];
      ldmatrix_x4(a_addr + mt * 16 * LDW * 4 + kk * 32, a[0], a[1], a[2],
                  a[3]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mma_bf16(acc[mt][nt], a, bf[nt][0], bf[nt][1]);
    }
  }
}

// The three products of 8 words sum in a fresh fragment, which one rounded
// f32 add then takes into the running sum: the tensor cores' additions
// truncate, and truncating at the scale of the running sum 864 times over
// D = 2304 drifts by ~1e-4 (measured on the card). Not unrolled over kk:
// unrolled, the fragments of four steps spill at 128 registers.
__device__ __forceinline__ void stage_3xtf32(float (&acc)[MT][NT][4],
                                             uint32_t a_addr,
                                             uint32_t b_addr) {
#pragma unroll 1
  for (int kk = 0; kk < BKW / 8; ++kk) {
    uint32_t bf[NT][2], b_big[NT][2], b_small[NT][2];
    load_b(bf, b_addr + kk * 32);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        split_tf32(bf[nt][e], b_big[nt][e], b_small[nt][e]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      uint32_t a[4], a_big[4], a_small[4];
      ldmatrix_x4(a_addr + mt * 16 * LDW * 4 + kk * 32, a[0], a[1], a[2],
                  a[3]);
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(a[e], a_big[e], a_small[e]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float sum8[4];
        mma_tf32_zero(sum8, a_big, b_small[nt][0], b_small[nt][1]);
        mma_tf32(sum8, a_small, b_big[nt][0], b_big[nt][1]);
        mma_tf32(sum8, a_big, b_big[nt][0], b_big[nt][1]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += sum8[e];
      }
    }
  }
}

// Fragment layouts (PTX ISA, mma.m16n8k8 .tf32 and mma.m16n8k16 .bf16),
// counted in 32-bit words of depth, identical for both types: with
// g = lane / 4 and t = lane % 4, A holds (row g, word t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4); B holds (ref row g, word t), (g, t + 4); the
// accumulator holds (row g, cols 2t, 2t + 1), (row g + 8, same cols).
// ldmatrix.x4 delivers exactly these from four 8 x 4-word matrices.
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
match_argmax_kernel(const T* __restrict__ q, const T* __restrict__ r,
                    const float* __restrict__ bias, int nq, int nr, int dw,
                    int parts, float* __restrict__ out_val,
                    int* __restrict__ out_idx) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int part = blockIdx.x;
  const int m0 = blockIdx.y * BM;
  const int b = blockIdx.z;
  const int n_tiles = (nr + BN - 1) / BN;
  const int tile0 =
      static_cast<int>(static_cast<int64_t>(part) * n_tiles / parts);
  const int tile1 =
      static_cast<int>(static_cast<int64_t>(part + 1) * n_tiles / parts);
  const int k_tiles = (dw + BKW - 1) / BKW;
  const int steps = (tile1 - tile0) * k_tiles;

  const int64_t row_bytes = static_cast<int64_t>(dw) * 4;
  const char* qb = reinterpret_cast<const char*>(q) +
                   static_cast<int64_t>(b) * nq * row_bytes;
  const char* rb = reinterpret_cast<const char*>(r) +
                   static_cast<int64_t>(b) * nr * row_bytes;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_m = warp / WARPS_N;
  const int warp_n = warp % WARPS_N;
  const int g = lane >> 2;
  const int t = lane & 3;
  const uint32_t smem0 = smem_addr(smem);

  // One stage: BM query rows and BN ref rows of BKW words each, as 16-byte
  // copies; copy c goes to row c / 8, column 4 * (c % 8). Rows past nq or
  // nr and words past dw are zero-filled.
  auto load_stage = [&](int step, int slot) {
    const int n0 = (tile0 + step / k_tiles) * BN;
    const int w0 = (step % k_tiles) * BKW;
    const uint32_t sa = smem0 + slot * STAGE_WORDS * 4;
    const uint32_t sb = sa + BM * LDW * 4;
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const int c = tid + i * THREADS;
      const int row = c >> 3;
      const int word = w0 + 4 * (c & 7);
      const uint32_t off = (row * LDW + 4 * (c & 7)) * 4;
      const bool kin = word < dw;
      const bool qin = kin && m0 + row < nq;
      const bool rin = kin && n0 + row < nr;
      cp_async16(sa + off,
                      qin ? qb + (m0 + row) * row_bytes + word * 4 : qb,
                      qin ? 16 : 0);
      cp_async16(sb + off,
                      rin ? rb + (n0 + row) * row_bytes + word * 4 : rb,
                      rin ? 16 : 0);
    }
  };

  // ldmatrix row addresses (bytes from a stage's start): an m16 x 8-word
  // A tile, and two n8 x 8-word B tiles
  const uint32_t a_off =
      ((warp_m * WM + (lane & 7) + 8 * ((lane >> 3) & 1)) * LDW +
       4 * (lane >> 4)) * 4;
  const uint32_t b_off =
      ((BM + warp_n * WN + (lane & 7) + 8 * (lane >> 4)) * LDW +
       4 * ((lane >> 3) & 1)) * 4;

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  // the running best of rows 4 * s + t (s = 0, 1) of the thread's 8
  float run_v[2] = {-INFINITY, -INFINITY};
  int run_j[2] = {0x7fffffff, 0x7fffffff};

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load_stage(s, s);
    cp_async_commit();
  }

  for (int s = 0; s < steps; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (s + STAGES - 1 < steps)
      load_stage(s + STAGES - 1, (s + STAGES - 1) % STAGES);
    cp_async_commit();

    const uint32_t stage = smem0 + (s % STAGES) * STAGE_WORDS * 4;
    if constexpr (std::is_same<T, float>::value)
      stage_3xtf32(acc, stage + a_off, stage + b_off);
    else
      stage_bf16(acc, stage + a_off, stage + b_off);

    if ((s + 1) % k_tiles == 0) {
      // the ref tile is complete: fold its scores into the running best
      const int j0 = (tile0 + s / k_tiles) * BN + warp_n * WN + 2 * t;
      float bj[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = j0 + nt * 8 + e;
          bj[nt][e] = j < nr ? (bias ? __ldg(bias + j) : 0.f) : -INFINITY;
        }
#pragma unroll
      for (int ri = 0; ri < 2 * MT; ++ri) {
        const int mt = ri >> 1;
        const int h = ri & 1;
        float v = -INFINITY;
        int jv = 0x7fffffff;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float sc = acc[mt][nt][2 * h + e] + bj[nt][e];
            if (sc > v) {
              v = sc;
              jv = j0 + nt * 8 + e;
            }
            acc[mt][nt][2 * h + e] = 0.f;
          }
#pragma unroll
        for (int o = 1; o <= 2; o <<= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, v, o);
          const int oj = __shfl_xor_sync(0xffffffffu, jv, o);
          if (better(ov, oj, v, jv)) {
            v = ov;
            jv = oj;
          }
        }
        // earlier tiles hold smaller indices: strict > keeps them on ties
        if ((ri & 3) == t && v > run_v[ri >> 2]) {
          run_v[ri >> 2] = v;
          run_j[ri >> 2] = jv;
        }
      }
    }
  }

  // merge the WARPS_N warps that share each query row
  cp_async_wait<0>();
  __syncthreads();
  float* red_v = reinterpret_cast<float*>(smem);
  int* red_j = reinterpret_cast<int*>(smem + WARPS_N * BM);
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int ri = 4 * s + t;
    const int row = warp_m * WM + (ri >> 1) * 16 + (ri & 1) * 8 + g;
    red_v[warp_n * BM + row] = run_v[s];
    red_j[warp_n * BM + row] = run_j[s];
  }
  __syncthreads();
  if (tid < BM && m0 + tid < nq) {
    float v = red_v[tid];
    int jv = red_j[tid];
#pragma unroll
    for (int wn = 1; wn < WARPS_N; ++wn) {
      if (better(red_v[wn * BM + tid], red_j[wn * BM + tid], v, jv)) {
        v = red_v[wn * BM + tid];
        jv = red_j[wn * BM + tid];
      }
    }
    const int64_t o = (static_cast<int64_t>(b) * parts + part) * nq + m0 + tid;
    out_val[o] = v;
    out_idx[o] = jv;
  }
}

// Merges the partitions' (max, argmax) of each query row, (B, P, nq) ->
// (B, nq), with the tie rule above.
__global__ void __launch_bounds__(MERGE_THREADS)
merge_parts_kernel(const float* __restrict__ part_val,
                   const int* __restrict__ part_idx, int64_t rows, int nq,
                   int parts, float* __restrict__ val, int* __restrict__ idx) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * MERGE_THREADS +
                    threadIdx.x;
  if (i >= rows) return;
  const int64_t b = i / nq;
  const int64_t m = i - b * nq;
  const int64_t base = b * parts * nq + m;
  float v = part_val[base];
  int jv = part_idx[base];
  for (int p = 1; p < parts; ++p) {
    const float pv = part_val[base + static_cast<int64_t>(p) * nq];
    const int pj = part_idx[base + static_cast<int64_t>(p) * nq];
    if (better(pv, pj, v, jv)) {
      v = pv;
      jv = pj;
    }
  }
  val[i] = v;
  idx[i] = jv;
}

template <typename T>
cudaError_t prepare() {
  return cudaFuncSetAttribute(match_argmax_kernel<T>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              SMEM_BYTES);
}

// The number of ref-axis partitions: the least estimated makespan, in ref
// tiles of work, over the resident blocks of the card (ties: fewer).
template <typename T>
int partitions(int batch, int nq, int nr) {
  if (prepare<T>() != cudaSuccess) return -1;
  const int slots = c2m::sm_count() *
                    c2m::blocks_per_sm(match_argmax_kernel<T>, THREADS,
                                       SMEM_BYTES);
  if (slots <= 0) return -1;
  const int64_t q_tiles = static_cast<int64_t>(batch) * ((nq + BM - 1) / BM);
  const int n_tiles = (nr + BN - 1) / BN;
  int best = 1;
  double best_cost = 0.0;
  for (int p = 1; p <= n_tiles; ++p) {
    const int64_t waves = (q_tiles * p + slots - 1) / slots;
    // a quarter tile of fixed cost per block: the ring's fill, the merges
    const double cost =
        static_cast<double>(waves) * ((n_tiles + p - 1) / p + 0.25);
    if (p == 1 || cost < best_cost) {
      best = p;
      best_cost = cost;
    }
  }
  return best;
}

template <typename T>
int launch(const void* q, const void* r, const void* bias, int batch, int nq,
           int nr, int d, int parts, void* part_val, void* part_idx,
           void* idx, void* val, void* stream) {
  const int q_tiles = (nq + BM - 1) / BM;
  if (parts < 1 || q_tiles > 65535 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = prepare<T>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dw = static_cast<int>(d * sizeof(T) / 4);
  float* out_val = static_cast<float*>(parts > 1 ? part_val : val);
  int* out_idx = static_cast<int*>(parts > 1 ? part_idx : idx);
  match_argmax_kernel<T><<<dim3(parts, q_tiles, batch), THREADS, SMEM_BYTES,
                           s>>>(
      static_cast<const T*>(q), static_cast<const T*>(r),
      static_cast<const float*>(bias), nq, nr, dw, parts, out_val, out_idx);
  err = cudaGetLastError();
  if (err != cudaSuccess || parts == 1) return static_cast<int>(err);
  const int64_t rows = static_cast<int64_t>(batch) * nq;
  merge_parts_kernel<<<static_cast<unsigned>((rows + MERGE_THREADS - 1) /
                                             MERGE_THREADS),
                       MERGE_THREADS, 0, s>>>(
      out_val, out_idx, rows, nq, parts, static_cast<float*>(val),
      static_cast<int*>(idx));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Partitions of the ref axis for a launch; negative on a CUDA error.
extern "C" int c2m_match_argmax_parts(int batch, int nq, int nr, int bf16) {
  return bf16 ? partitions<__nv_bfloat16>(batch, nq, nr)
              : partitions<float>(batch, nq, nr);
}

// Requires d % 8 == 0 and 16-byte aligned q and r (the wrapper checks
// both); part_val and part_idx hold (batch, parts, nq) when parts > 1.
extern "C" int c2m_match_argmax_f32(const void* q, const void* r,
                                    const void* bias, int batch, int nq,
                                    int nr, int d, int parts, void* part_val,
                                    void* part_idx, void* idx, void* val,
                                    void* stream) {
  return launch<float>(q, r, bias, batch, nq, nr, d, parts, part_val,
                       part_idx, idx, val, stream);
}

extern "C" int c2m_match_argmax_bf16(const void* q, const void* r,
                                     const void* bias, int batch, int nq,
                                     int nr, int d, int parts, void* part_val,
                                     void* part_idx, void* idx, void* val,
                                     void* stream) {
  return launch<__nv_bfloat16>(q, r, bias, batch, nq, nr, d, parts, part_val,
                               part_idx, idx, val, stream);
}
