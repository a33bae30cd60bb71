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
// What bounds it on this card: 2 * nq * nr * D operations, 564 GFLOP per
// image on the main path (nq = 11844 queries of the bucket-padded CUFED5
// request, nr = 10332 ref rows that can win, D = 2304), against operands of
// 109 and 95 MB (f32) or half that (bf16). So the tensor cores bound it:
// - bf16 operands (the serving config): wgmma m64n256k16 with f32
//   accumulators; products of two bf16 values are exact in f32.
// - f32 operands: 3xTF32. Each operand splits into big = tf32(x) and
//   small = tf32(x - big) (cvt.rna, round to nearest, ties away), and
//   big*small + small*big + big*big accumulate in f32 (wgmma m64n128k8):
//   the dropped small*small term is ~2^-22 of each product, so the scores
//   stay within f32 rounding of the exact ones. One plain TF32 pass would
//   flip near-tie argmaxes. Three TF32 products per f32 product: 1.69 TFLOP
//   an image at 495 TFLOP/s.
// Next after the tensor cores comes L2: each block stages 1 byte into
// shared memory per 48 (f32, split operands) or 85 (bf16) operations, tens
// of GB an image, so the tiles are as large as the accumulators allow and
// blocks that run at once share their tiles in L2 (see Filling the card).
//
// Why wgmma and TMA: wgmma is the only way to Hopper's full tensor-core
// rate, and TMA feeds it with no thread spending registers or instructions
// on the copies. wgmma reads its operands from shared memory, so the
// 3xTF32 split cannot sit between a load and the product as it did with
// mma.sync; it is a separate elementwise pass (split_kernel) into scratch
// the wrapper allocates: (2, B, N, D), big then small. That pass reads the
// operands once and writes them twice, ~0.2 ms an image, against a
// product of ~1.7 TFLOP; the tiles then land ready for the tensor cores.
//
// Design: 3 warpgroups a block, one block an SM (~193 KB of shared memory).
// - Warpgroup 0 is the producer: one thread keeps a ring of STAGES tiles
//   in flight with cp.async.bulk.tensor (TMA) on an mbarrier each
//   ("full"), from 3-D tensor maps (D, N, slices) with 128-byte swizzle; a
//   stage is 128 bytes of depth (32 f32 or 64 bf16 values) of the block's
//   BM = 128 query rows and BN ref rows (of big and small for f32). TMA
//   zero-fills rows past nq or nr and depth past D. setmaxnreg gives the
//   producer 40 registers and the consumers 232. Every mbarrier wait is
//   bounded (hopper.cuh's mbar_wait): a lost arrival traps, which fails
//   the launch instead of hanging the card.
// - Warpgroups 1 and 2 are consumers, 64 query rows each, both reading the
//   same ref tile. Each issues wgmma on the landed stage, waits for those
//   products, and releases the stage to the producer ("empty", one arrive
//   a warp); the two consumers keep each other's waits covered (keeping a
//   stage's products in flight while issuing the next measured slower).
//   f32: the 3 x 4 products of a stage sum in a fresh accumulator (scale-d
//   0 on the first), and one rounded f32 add takes that chunk into the
//   running sum: the tensor cores truncate as they add, and truncating at
//   the scale of the running sum over all 2304 depths drifts by ~1e-4
//   (measured on the card with mma.sync). bf16 accumulates straight.
// - After the last stage of a ref tile each thread adds the bias to its
//   BN / 4 columns of its 2 rows, folds them into a running (max, argmax),
//   and the 4 lanes that share a row merge by shuffles. The fold is once a
//   ref tile (every 72 f32 or 36 bf16 stages); while one consumer folds or
//   adds its chunk, the other's products keep the tensor cores busy. Ref
//   rows past the partition or past nr never win (as
//   patch_match_kernel.py masks rows past nr).
//
// Filling the card: at the main path's 10332 queries, 128-row query tiles
// give 81 blocks for 132 SMs. So the ref axis is split into partitions of
// ceil(nr / parts) rows (c2m_match_argmax_parts picks their number from
// the SM count); each (partition, query tile) block writes a partial
// (max, argmax) to scratch, and a last launch merges the partials. The
// partition is blockIdx.x: blocks that run at once cover a few query tiles
// and every partition, so they walk the same r tiles and r comes from L2;
// and every block walks the same number of ref tiles, so the partitions of
// a query tile stay in step and read its q tiles from L2 together.
//
// Tie rule: within a thread the columns arrive in increasing j, and a value
// replaces the running best only if strictly larger. Every merge (the
// lanes of a quad, the partitions) takes the larger value and, on an exact
// tie, the smaller index. So the result is the global first maximum of the
// kernel's scores.

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

constexpr int BM = 128;          // query rows per block, 64 a consumer
constexpr int THREADS = 384;     // producer + 2 consumer warpgroups
constexpr int ROW_BYTES = 128;   // a stage's depth: one swizzle span
constexpr int MERGE_THREADS = 256;

template <typename T>
struct Cfg;

template <>
struct Cfg<float> {
  static constexpr int BN = 128;      // ref rows per tile
  static constexpr int STAGES = 3;
  static constexpr int PIECES = 2;    // TF32 pieces: big and small
};

template <>
struct Cfg<__nv_bfloat16> {
  static constexpr int BN = 256;
  static constexpr int STAGES = 4;
  static constexpr int PIECES = 1;
};

template <typename T>
struct Layout : Cfg<T> {
  using Cfg<T>::BN;
  using Cfg<T>::STAGES;
  using Cfg<T>::PIECES;
  static constexpr int Q_BYTES = PIECES * BM * ROW_BYTES;
  static constexpr int R_BYTES = PIECES * BN * ROW_BYTES;
  static constexpr int STAGE_BYTES = Q_BYTES + R_BYTES;
  // the ring, and up to 1 KB to align it: 128-byte swizzle repeats every
  // 8 rows of 128 bytes, so a tile starts on a 1024-byte boundary
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;
  static constexpr int DEPTH = ROW_BYTES / sizeof(T);   // values a stage
  static constexpr int NACC = BN / 2;   // accumulators a thread (m64)
};

__device__ __forceinline__ bool better(float v, int j, float best, int best_j) {
  return v > best || (v == best && j < best_j);
}

template <typename T>
__device__ __forceinline__ void stage_products(
    float (&acc)[Layout<T>::NACC], uint32_t stage, int cw, bool first);

// f32: the three TF32 products of 4 depth steps of 8, into a fresh
// accumulator (scale-d 0 on the first product).
template <>
__device__ __forceinline__ void stage_products<float>(float (&acc)[64],
                                                      uint32_t stage, int cw,
                                                      bool) {
  using L = Layout<float>;
  const uint64_t q_big = sw128_desc(stage + cw * 64 * ROW_BYTES);
  const uint64_t q_small = sw128_desc(stage + (BM + cw * 64) * ROW_BYTES);
  const uint64_t r_big = sw128_desc(stage + L::Q_BYTES);
  const uint64_t r_small = sw128_desc(stage + L::Q_BYTES + L::BN * ROW_BYTES);
#pragma unroll
  for (int k = 0; k < ROW_BYTES / 32; ++k) {
    const int o = k * 2;   // 32 bytes of depth, in 16-byte units
    wgmma_tf32_n128(acc, q_big + o, r_small + o, k > 0);
    wgmma_tf32_n128(acc, q_small + o, r_big + o, 1);
    wgmma_tf32_n128(acc, q_big + o, r_big + o, 1);
  }
}

// bf16: 4 depth steps of 16 into the running accumulator (scale-d 0 on the
// first step of a ref tile).
template <>
__device__ __forceinline__ void stage_products<__nv_bfloat16>(
    float (&acc)[128], uint32_t stage, int cw, bool first) {
  using L = Layout<__nv_bfloat16>;
  const uint64_t qd = sw128_desc(stage + cw * 64 * ROW_BYTES);
  const uint64_t rd = sw128_desc(stage + L::Q_BYTES);
#pragma unroll
  for (int k = 0; k < ROW_BYTES / 32; ++k)
    wgmma_bf16_n256(acc, qd + 2 * k, rd + 2 * k, !(first && k == 0));
}

// Folds a finished ref tile (columns n0 ..., those below n_end) into the
// thread's running best of its rows h = 0, 1 (see the accumulator layout).
template <int NACC>
__device__ __forceinline__ void fold_tile(const float (&acc)[NACC],
                                          const float* __restrict__ bias,
                                          int n0, int n_end, int t,
                                          float (&best_v)[2],
                                          int (&best_j)[2]) {
  float bj[NACC / 2];
#pragma unroll
  for (int j = 0; j < NACC / 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = n0 + 8 * j + 2 * t + e;
      bj[2 * j + e] =
          col < n_end ? (bias ? __ldg(bias + col) : 0.f) : -INFINITY;
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float v = -INFINITY;
    int jv = 0x7fffffff;
#pragma unroll
    for (int j = 0; j < NACC / 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float sc = acc[4 * j + 2 * h + e] + bj[2 * j + e];
        if (sc > v) {
          v = sc;
          jv = n0 + 8 * j + 2 * t + e;
        }
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
    if (v > best_v[h]) {
      best_v[h] = v;
      best_j[h] = jv;
    }
  }
}

// q_map and r_map cover (D, N, slices): slice s of q_map is image s of q
// for bf16, and big (s < batch) or small (s >= batch) of image s % batch of
// the split f32 operand.
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
match_argmax_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap r_map,
                    const float* __restrict__ bias, int batch, int nq, int nr,
                    int d, int parts, float* __restrict__ out_val,
                    int* __restrict__ out_idx) {
  using L = Layout<T>;
  __shared__ __align__(8) uint64_t full_bar[L::STAGES];
  __shared__ __align__(8) uint64_t empty_bar[L::STAGES];
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t ring = (smem_addr(smem) + 1023u) & ~1023u;

  const int part = blockIdx.x;
  const int m0 = blockIdx.y * BM;
  const int b = blockIdx.z;
  // the partition's ref rows [n_begin, n_end), walked in n_tiles tiles
  const int part_rows = (nr + parts - 1) / parts;
  const int n_tiles = (part_rows + L::BN - 1) / L::BN;
  const int n_begin = part * part_rows;
  const int n_end = min(nr, n_begin + part_rows);
  const int k_stages = (d + L::DEPTH - 1) / L::DEPTH;
  const int steps = n_tiles * k_stages;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(smem_addr(&full_bar[s]), 1);
      mbar_init(smem_addr(&empty_bar[s]), 8);   // the consumers' 8 warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      for (int step = 0; step < steps; ++step) {
        const int s = step % L::STAGES;
        const uint32_t parity = (step / L::STAGES) & 1;
        const uint32_t full = smem_addr(&full_bar[s]);
        mbar_wait(smem_addr(&empty_bar[s]), parity ^ 1);
        mbar_expect_tx(full, L::STAGE_BYTES);
        const int n0 = n_begin + (step / k_stages) * L::BN;
        const int k0 = (step % k_stages) * L::DEPTH;
        const uint32_t stage = ring + s * L::STAGE_BYTES;
#pragma unroll
        for (int piece = 0; piece < L::PIECES; ++piece) {
          tma_load(stage + piece * BM * ROW_BYTES, &q_map, full, k0, m0,
                   b + piece * batch);
          tma_load(stage + L::Q_BYTES + piece * L::BN * ROW_BYTES, &r_map,
                   full, k0, n0, b + piece * batch);
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1;
    const int tid = threadIdx.x & 127;
    const int lane = tid & 31;
    const int t = lane & 3;
    float acc[L::NACC];
    float run[std::is_same<T, float>::value ? L::NACC : 1];
    float best_v[2] = {-INFINITY, -INFINITY};
    int best_j[2] = {0x7fffffff, 0x7fffffff};
    int step = 0;
    for (int tile = 0; tile < n_tiles; ++tile) {
      for (int ks = 0; ks < k_stages; ++ks, ++step) {
        const int s = step % L::STAGES;
        mbar_wait(smem_addr(&full_bar[s]), (step / L::STAGES) & 1);
        wgmma_fence();
        stage_products<T>(acc, ring + s * L::STAGE_BYTES, cw, ks == 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(acc);
        if (lane == 0) mbar_arrive(smem_addr(&empty_bar[s]));
        if constexpr (std::is_same<T, float>::value) {
          // one rounded f32 add a stage takes the chunk into the sum
#pragma unroll
          for (int i = 0; i < L::NACC; ++i)
            run[i] = ks == 0 ? acc[i] : run[i] + acc[i];
        }
      }
      if constexpr (std::is_same<T, float>::value)
        fold_tile(run, bias, n_begin + tile * L::BN, n_end, t, best_v,
                  best_j);
      else
        fold_tile(acc, bias, n_begin + tile * L::BN, n_end, t, best_v,
                  best_j);
    }
    if (t == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + cw * 64 + (tid >> 5) * 16 + (lane >> 2) + 8 * h;
        if (row < nq) {
          const int64_t o =
              (static_cast<int64_t>(b) * parts + part) * nq + row;
          out_val[o] = best_v[h];
          out_idx[o] = best_j[h];
        }
      }
    }
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
                              Layout<T>::SMEM_BYTES);
}

// The number of ref-axis partitions: the least estimated makespan, in ref
// tiles of work, over the resident blocks of the card (ties: fewer). Every
// partition holds ceil(nr / parts) rows, so every block walks the same
// number of tiles: the blocks of one query tile then stay in step, and
// its q tiles reach L2 once for all of them (blocks of unequal lengths
// drift apart over the waves, and each reads q from memory again).
// f32 operands take two partitions or more: with one, every resident block
// streams its own q tile (two TF32 parts, 2.36 MB at D = 2304) from memory
// once a ref tile, which the makespan does not count (at batch 16 and
// 10332 x 10332 one partition took 119 ms, three 70; H100). The floor
// changes the pick only where the batch's q tiles fill whole waves of the
// card on their own: on 132 SMs, CUFED5's 10332 x 10332 at batch 8, 13,
// 16, 21, 24, 26 and 29 (3 partitions, whose makespan is within 1% of
// one's). Every other f32 launch of the port already takes two or more:
// batch 1 and its bands (3), the other batches up to 32 (2 to 9) and the
// training match's 1444 x 1444 at batch 9 (6). bf16 keeps the plain
// makespan: its q tile is a quarter of f32's bytes against a ref tile
// twice as wide, and at batch 16 and 11844 x 11844 one partition took
// 16.4 ms, three 20.9.
template <typename T>
int partitions(int batch, int nq, int nr) {
  if (prepare<T>() != cudaSuccess) return -1;
  const int slots =
      c2m::sm_count() * c2m::blocks_per_sm(match_argmax_kernel<T>, THREADS,
                                           Layout<T>::SMEM_BYTES);
  if (slots <= 0) return -1;
  const int64_t q_tiles = static_cast<int64_t>(batch) * ((nq + BM - 1) / BM);
  constexpr int BN = Layout<T>::BN;
  const int n_tiles = (nr + BN - 1) / BN;
  const int first = (sizeof(T) == 4 && n_tiles > 1) ? 2 : 1;
  int best = first;
  double best_cost = 0.0;
  for (int p = first; p <= n_tiles; ++p) {
    const int64_t waves = (q_tiles * p + slots - 1) / slots;
    const int tiles = ((nr + p - 1) / p + BN - 1) / BN;
    // a quarter tile of fixed cost per block: the ring's fill, the merges
    const double cost = static_cast<double>(waves) * (tiles + 0.25);
    if (p == first || cost < best_cost) {
      best = p;
      best_cost = cost;
    }
  }
  return best;
}

template <typename T>
int launch(const void* q, const void* r, const void* bias, int batch, int nq,
           int nr, int d, int parts, void* q_split, void* r_split,
           void* part_val, void* part_idx, void* idx, void* val,
           void* stream) {
  constexpr bool f32 = std::is_same<T, float>::value;
  const int q_tiles = (nq + BM - 1) / BM;
  if (parts < 1 || q_tiles > 65535 || batch > 65535 ||
      (f32 && (!q_split || !r_split)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = prepare<T>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32) {
    err = split(q, q_split, static_cast<int64_t>(batch) * nq * d, s);
    if (err == cudaSuccess)
      err = split(r, r_split, static_cast<int64_t>(batch) * nr * d, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int slices = f32 ? 2 * batch : batch;
  CUtensorMap q_map, r_map;
  if (!make_map<T>(&q_map, f32 ? q_split : q, d, nq, slices, BM) ||
      !make_map<T>(&r_map, f32 ? r_split : r, d, nr, slices,
                   Layout<T>::BN))
    return static_cast<int>(cudaErrorInvalidValue);
  float* out_val = static_cast<float*>(parts > 1 ? part_val : val);
  int* out_idx = static_cast<int*>(parts > 1 ? part_idx : idx);
  match_argmax_kernel<T>
      <<<dim3(parts, q_tiles, batch), THREADS, Layout<T>::SMEM_BYTES, s>>>(
          q_map, r_map, static_cast<const float*>(bias), batch, nq, nr, d,
          parts, out_val, out_idx);
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
// both); q_split and r_split hold (2, batch, nq or nr, d) f32 (f32 only);
// part_val and part_idx hold (batch, parts, nq) when parts > 1.
extern "C" int c2m_match_argmax_f32(const void* q, const void* r,
                                    const void* bias, int batch, int nq,
                                    int nr, int d, int parts, void* q_split,
                                    void* r_split, void* part_val,
                                    void* part_idx, void* idx, void* val,
                                    void* stream) {
  return launch<float>(q, r, bias, batch, nq, nr, d, parts, q_split, r_split,
                       part_val, part_idx, idx, val, stream);
}

extern "C" int c2m_match_argmax_bf16(const void* q, const void* r,
                                     const void* bias, int batch, int nq,
                                     int nr, int d, int parts, void* q_split,
                                     void* r_split, void* part_val,
                                     void* part_idx, void* idx, void* val,
                                     void* stream) {
  return launch<__nv_bfloat16>(q, r, bias, batch, nq, nr, d, parts, q_split,
                               r_split, part_val, part_idx, idx, val, stream);
}
