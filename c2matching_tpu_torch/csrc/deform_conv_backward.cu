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
// What bounds it on this card: operations by count, latency in practice.
// G is 2 * P * 9C * Co flops a DynAgg image (1.9 GFLOP at relu3 40 x 40 x
// 256 and at relu1 160 x 160 x 64), run as 3xTF32 on the tensor cores:
// three times that at 495 TFLOP/s, against ~10 MB of x, offsets, mask,
// grad_out and gradients per image. Formed in device memory and multiplied
// outside, G alone was 15-59 MB a DynAgg image written and read back. The
// corner dots gather four corners of every (pixel, tap, group) sample from
// x: 16.6 M samples of 32 bytes a corner at relu1 and batch 9.
//
// Design: one block a SM (512 threads) walks tiles of PT output pixels of
// the batch's images (blockIdx.x, + gridDim.x, ...). Per tile the (tap,
// group) slices of w_kc are taken in chunks of whole groups of one tap, at
// most NC = 64 rows (G columns): 8 groups of cg 8, 4 of cg 16, 2 of cg 32.
// Two roles run side by side, handing G over through two shared buffers
// (named barriers FULL and EMPTY, one pair a buffer):
//   - 8 MMA warps stage the tile's grad_out rows (PT x Co f32) once with
//     cp.async and form each chunk's G = grad_out tile @ chunk^T, depth Co
//     in slices of KS = 32 through a 3-slot cp.async ring; the warps tile
//     G 2 x 4 (PT 64) or 4 x 2 (PT 128), two m16 tiles each. 3xTF32
//     mma.sync m16n8k8: each f32 value splits into big and small TF32 parts
//     (split_tf32_int; grad_out once a tile into two shared copies at
//     64-pixel tiles, PRESPLIT), and big*small + small*big + big*big of each
//     8-deep step sum in a fresh fragment that one rounded f32 add takes
//     into the running sum, as kernels B1 and B2 do;
//   - 8 dot warps take the G of the chunk before into the corner dots: one
//     thread, or 2-4 lanes with 4-channel vectors, per (pixel, group)
//     sample, two samples a thread at once so that their corner loads are
//     in flight together, G read from shared memory, the lanes' four dots
//     reduced by shuffles; the first lane writes the mask and offset
//     gradients (zeros for an invalid sample); grad_x, when asked, by f32
//     atomics from every lane. At 8-channel groups (relu1), where the dots
//     outweigh the products, the corners of the next chunk are copied into
//     shared memory by cp.async while the current one is summed (GATHER).
// The group widths of training (8, 16, 32) have their own instantiations,
// so lanes, groups a chunk and the sample's place are constants (CGT).
// Tiles are 128 pixels where 64-pixel tiles would fill fewer than two
// waves of the card (relu3 at batch 9: 113 tiles instead of 225 on 132
// SMs), else 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

using namespace c2m;

constexpr int MMA_WARPS = 8;     // form G
constexpr int DOT_WARPS = 8;     // take G into the corner dots
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr int DOT_THREADS = 32 * DOT_WARPS;
constexpr int THREADS = MMA_THREADS + DOT_THREADS;
constexpr int NC = 64;           // w_kc rows (G columns) per chunk, at most
constexpr int KS = 32;           // depth (output channels) per ring slot
constexpr int SLOTS = 3;         // ring slots
constexpr int LDW = KS + 4;      // a slot row's stride in words
constexpr int LDG = NC + 4;      // G's row stride in words
constexpr int CU = 2;            // samples a dot thread carries at once
constexpr int MAX_SMEM = 232448;
constexpr int MAX_CO = 320;      // grad_out rows of a 64-pixel tile, split
                                 // in two, fit in shared memory
// named barriers (0 is __syncthreads, which the roles do not use)
constexpr int BAR_MMA = 1;       // the MMA warps among themselves
constexpr int BAR_DOT = 2;       // the dot warps among themselves
constexpr int BAR_FULL = 3;      // + buffer: G written (MMA arrive, dot wait)
constexpr int BAR_EMPTY = 5;     // + buffer: G read (dot arrive, MMA wait)

// PT output pixels a tile (64 or 128): the MMA warps tile the chunk's G
// (PT x NC) WARPS_M x WARPS_N, each warp MT m16 by NT n8 tiles
template <int PT>
struct Tile {
  static constexpr int WARPS_M = PT / 32;
  static constexpr int WARPS_N = MMA_WARPS / WARPS_M;
  static constexpr int MT = 2;
  static constexpr int NT = NC / WARPS_N / 8;
  static_assert(WARPS_M * WARPS_N == MMA_WARPS, "the MMA warps");
  static_assert(MT * 16 * WARPS_M == PT && NT * 8 * WARPS_N == NC,
                "the MMA warps cover the chunk's G");
};

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Co padded to whole ring slices; grad_out's row stride in words (4 more:
// the 8 rows of an ldmatrix hit distinct banks)
constexpr __host__ __device__ int padded_co(int co) {
  return (co + KS - 1) / KS * KS;
}
constexpr __host__ __device__ int a_ld(int co) {
  return padded_co(co) + 4;
}

// In the gather path a dot thread's lane-tasks of a chunk read GV vectors
// of 4 channels (its samples' corners).
constexpr int GV = 16;

// grad_out rows (twice when pre-split), the weight ring, two G buffers, the
// tile's pixel table and, in the gather path, two chunks' corners
constexpr size_t smem_bytes(int co, bool presplit, int pt,
                            size_t gather_bytes = 0) {
  return sizeof(float) *
             ((presplit ? 2 : 1) * static_cast<size_t>(pt) * a_ld(co) +
              SLOTS * NC * LDW + 2 * pt * LDG + 2 * pt) +
         gather_bytes;
}

template <typename T>
constexpr size_t gather_bytes() {
  return 2 * GV * DOT_THREADS * 4 * sizeof(T);
}
static_assert(smem_bytes(MAX_CO, true, 64) <= MAX_SMEM,
              "a 64-pixel tile's grad_out rows, split, fit up to MAX_CO");


// 4 channels of x from shared memory
__device__ __forceinline__ float4 smem4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 smem4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// global -> shared copy of 4 channels of x (16 bytes of f32, 8 of bf16);
// ok = false writes zeros and reads nothing
__device__ __forceinline__ void cp_async_x4(uint32_t dst, const float* src,
                                            bool ok) {
  cp_async16(dst, src, ok ? 16 : 0);
}
__device__ __forceinline__ void cp_async_x4(uint32_t dst,
                                            const __nv_bfloat16* src,
                                            bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 8 : 0)
               : "memory");
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

__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float d) {
  d += a.x * b.x;
  d += a.y * b.y;
  d += a.z * b.z;
  d += a.w * b.w;
  return d;
}

// One corner-dot sample of a chunk: its pixel and group within the chunk,
// its index among the tile's samples, its point and modulation.
struct Sample {
  int idx;
  int pl, gl;
  float y, x, m;
  bool act;
};

// The corner dots of a thread's CU samples, the lanes' vectors of all of
// them loaded before they are summed. The first lane writes each sample's
// offset and mask gradients (zeros outside the image) into the tile's
// (off_out, m_out: skipped when null); every lane adds grad_x.
template <typename T, bool VEC>
__device__ __forceinline__ void corner_dots(
    const Sample (&sm)[CU], const T* __restrict__ x, const float* gbuf,
    float* off_out, float* m_out, float* __restrict__ g_x, int b, int h,
    int w, int c, int cg, int g0, int lane_bits, unsigned lane_mask) {
  // cg and lane_bits are compile-time constants where the kernel was
  // instantiated for one group width (CGT)
  const int lanes = 1 << lane_bits;
  const int lane = threadIdx.x & (lanes - 1);
  bool valid[CU], ok[CU][4];
  float fy[CU], fx[CU], sc[CU][4];
  int64_t corner[CU];
  const float* gp[CU];
  const int64_t step[4] = {0, c, static_cast<int64_t>(w) * c,
                           static_cast<int64_t>(w) * c + c};
#pragma unroll
  for (int i = 0; i < CU; ++i) {
    const Sample& q = sm[i];
    valid[i] = q.act && q.y > -1.f && q.y < static_cast<float>(h) &&
               q.x > -1.f && q.x < static_cast<float>(w);
    fy[i] = fx[i] = 0.f;
    corner[i] = 0;
#pragma unroll
    for (int r = 0; r < 4; ++r) ok[i][r] = false;
    if (valid[i]) {
      const float y0f = floorf(q.y);
      const float x0f = floorf(q.x);
      fy[i] = q.y - y0f;
      fx[i] = q.x - x0f;
      const int y0 = static_cast<int>(y0f);
      const int x0 = static_cast<int>(x0f);
      ok[i][0] = y0 >= 0 && x0 >= 0;
      ok[i][1] = y0 >= 0 && x0 + 1 < w;
      ok[i][2] = y0 + 1 < h && x0 >= 0;
      ok[i][3] = y0 + 1 < h && x0 + 1 < w;
      // only the corners inside the image are read
      corner[i] = ((static_cast<int64_t>(b) * h + y0) * w + x0) * c +
                  (g0 + q.gl) * cg;
    }
    gp[i] = gbuf + q.pl * LDG + q.gl * cg;
    sc[i][0] = q.m * (1.f - fy[i]) * (1.f - fx[i]);
    sc[i][1] = q.m * (1.f - fy[i]) * fx[i];
    sc[i][2] = q.m * fy[i] * (1.f - fx[i]);
    sc[i][3] = q.m * fy[i] * fx[i];
  }
  float d[CU][4];
#pragma unroll
  for (int i = 0; i < CU; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) d[i][r] = 0.f;
  if constexpr (VEC) {
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int ch = 4 * lane; ch < cg; ch += 4 * lanes) {
      float4 gv[CU], cr[CU][4];
#pragma unroll
      for (int i = 0; i < CU; ++i) {
        gv[i] = valid[i] ? *reinterpret_cast<const float4*>(gp[i] + ch) : z;
#pragma unroll
        for (int r = 0; r < 4; ++r)
          cr[i][r] = ok[i][r] ? load4(x + corner[i] + ch + step[r]) : z;
      }
#pragma unroll
      for (int i = 0; i < CU; ++i) {
#pragma unroll
        for (int r = 0; r < 4; ++r) d[i][r] = dot4(gv[i], cr[i][r], d[i][r]);
        if (g_x != nullptr && valid[i]) {
          const float gs[4] = {gv[i].x, gv[i].y, gv[i].z, gv[i].w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
            if (ok[i][r])
#pragma unroll
              for (int v = 0; v < 4; ++v)
                atomicAdd(g_x + (corner[i] + ch + v + step[r]),
                          sc[i][r] * gs[v]);
        }
      }
    }
  } else {
    for (int ch = lane; ch < cg; ch += lanes) {
#pragma unroll
      for (int i = 0; i < CU; ++i) {
        if (!valid[i]) continue;
        const float gv = gp[i][ch];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          if (ok[i][r]) {
            d[i][r] += gv * to_f32(x[corner[i] + ch + step[r]]);
            if (g_x != nullptr)
              atomicAdd(g_x + (corner[i] + ch + step[r]), sc[i][r] * gv);
          }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < CU; ++i) {
    const Sample& q = sm[i];
    if (!q.act) continue;  // the sample's lanes skip together
    for (int o = lanes >> 1; o > 0; o >>= 1)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        d[i][r] += __shfl_xor_sync(lane_mask, d[i][r], o);
    if (lane != 0) continue;
    const float ty = fy[i];
    const float tx = fx[i];
    if (m_out != nullptr)
      m_out[q.idx] = valid[i] ? (1.f - ty) * (1.f - tx) * d[i][0] +
                                  (1.f - ty) * tx * d[i][1] +
                                  ty * (1.f - tx) * d[i][2] +
                                  ty * tx * d[i][3]
                            : 0.f;
    if (off_out != nullptr) {
      // d/dy and d/dx of the four corner weights, times the corner dots
      const float gy = (1.f - tx) * (d[i][2] - d[i][0]) +
                       tx * (d[i][3] - d[i][1]);
      const float gx = (1.f - ty) * (d[i][1] - d[i][0]) +
                       ty * (d[i][3] - d[i][2]);
      off_out[2 * q.idx] = valid[i] ? q.m * gy : 0.f;
      off_out[2 * q.idx + 1] = valid[i] ? q.m * gx : 0.f;
    }
  }
}

// The dot warps' work on one tile in the gather path, for group width CG:
// a thread's lane-tasks keep their (pixel, group, lane) from chunk to chunk,
// only the tap and the groups' base change. Chunk n's offsets and masks are
// loaded two chunks ahead, its corners copied into shared memory (cp.async)
// one chunk ahead, so while a chunk's dots are summed the next chunk's
// corners are in flight. Each thread reads back only what it copied.
template <typename T, int CG, int PT>
__device__ __forceinline__ void gather_tile(
    const T* __restrict__ x, const float* off_in, const float* m_in,
    float* off_out, float* m_out, const float* g_s, const float2* pix_s,
    T* c_s, int dt, unsigned lane_mask, int rows, int b, int h, int w, int c,
    int g, int k_taps, int kw, int dh, int dw, int cpt, int n_chunks,
    int& q) {
  constexpr int LB = CG >= 16 ? 2 : 1;            // lane bits
  constexpr int LANES = 1 << LB;
  constexpr int VPL = CG / 4 / LANES;             // vectors a lane
  constexpr int NG = NC / CG;                     // groups a chunk
  constexpr int TPT = PT * NG * LANES / DOT_THREADS;  // lane-tasks a thread
  static_assert(TPT * VPL * 4 == GV, "the gather buffer's vectors");
  const int lane = dt & (LANES - 1);
  int pl[TPT], gl[TPT];
  bool act[TPT];
#pragma unroll
  for (int j = 0; j < TPT; ++j) {
    const int sample = (dt + j * DOT_THREADS) >> LB;
    gl[j] = sample % NG;
    pl[j] = sample / NG;
    act[j] = pl[j] < rows;  // a sample's lanes agree
  }
  const int64_t step[4] = {0, c, static_cast<int64_t>(w) * c,
                           static_cast<int64_t>(w) * c + c};
  const uint32_t c_addr = smem_addr(c_s);

  // the sample's index in the tile's offsets and masks
  auto index = [&](int n, int j) {
    return (pl[j] * g + (n % cpt) * NG + gl[j]) * k_taps + n / cpt;
  };
  auto load = [&](int n, float (&oy)[TPT], float (&ox)[TPT],
                  float (&om)[TPT]) {
#pragma unroll
    for (int j = 0; j < TPT; ++j) {
      oy[j] = ox[j] = om[j] = 0.f;
      if (act[j]) {
        const float2 o =
            *reinterpret_cast<const float2*>(off_in + 2 * index(n, j));
        oy[j] = o.x;
        ox[j] = o.y;
        om[j] = m_in[index(n, j)];
      }
    }
  };
  // the sample's point: its pixel's base, the tap, the offset
  auto point = [&](int n, int j, float oy, float ox, float& y, float& xs) {
    const int k = n / cpt;
    const float2 base = pix_s[pl[j]];
    y = (base.x + static_cast<float>((k / kw) * dh)) + oy;
    xs = (base.y + static_cast<float>((k % kw) * dw)) + ox;
  };
  auto copy_corners = [&](int n, const float (&oy)[TPT],
                          const float (&ox)[TPT]) {
    const uint32_t dst0 = c_addr + ((n & 1) * GV * DOT_THREADS + dt) * 4 *
                                       static_cast<uint32_t>(sizeof(T));
#pragma unroll
    for (int j = 0; j < TPT; ++j) {
      float y, xs;
      point(n, j, oy[j], ox[j], y, xs);
      bool ok[4] = {false, false, false, false};
      int64_t corner = 0;
      if (act[j] && y > -1.f && y < static_cast<float>(h) && xs > -1.f &&
          xs < static_cast<float>(w)) {
        const int y0 = static_cast<int>(floorf(y));
        const int x0 = static_cast<int>(floorf(xs));
        ok[0] = y0 >= 0 && x0 >= 0;
        ok[1] = y0 >= 0 && x0 + 1 < w;
        ok[2] = y0 + 1 < h && x0 >= 0;
        ok[3] = y0 + 1 < h && x0 + 1 < w;
        corner = ((static_cast<int64_t>(b) * h + y0) * w + x0) * c +
                 ((n % cpt) * NG + gl[j]) * CG + 4 * lane;
      }
#pragma unroll
      for (int v = 0; v < VPL; ++v)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int slot = (j * VPL + v) * 4 + r;
          cp_async_x4(dst0 + slot * DOT_THREADS * 4 * sizeof(T),
                      ok[r] ? x + corner + v * 4 * LANES + step[r] : x,
                      ok[r]);
        }
    }
  };
  auto dots = [&](int n, const float (&oy)[TPT], const float (&ox)[TPT],
                  const float (&om)[TPT]) {
    const float* gb = g_s + (q & 1) * PT * LDG;
    const T* src = c_s + ((n & 1) * GV * DOT_THREADS + dt) * 4;
#pragma unroll
    for (int j = 0; j < TPT; ++j) {
      if (!act[j]) continue;  // the sample's lanes skip together
      float y, xs;
      point(n, j, oy[j], ox[j], y, xs);
      const bool valid = y > -1.f && y < static_cast<float>(h) &&
                         xs > -1.f && xs < static_cast<float>(w);
      float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        const float4 gv = *reinterpret_cast<const float4*>(
            gb + pl[j] * LDG + gl[j] * CG + 4 * lane + v * 4 * LANES);
#pragma unroll
        for (int r = 0; r < 4; ++r)
          d[r] = dot4(gv, smem4(src + ((j * VPL + v) * 4 + r) *
                                          DOT_THREADS * 4),
                      d[r]);
      }
#pragma unroll
      for (int o = LANES >> 1; o > 0; o >>= 1)
#pragma unroll
        for (int r = 0; r < 4; ++r) d[r] += __shfl_xor_sync(lane_mask, d[r], o);
      if (lane != 0) continue;
      const float fy = valid ? y - floorf(y) : 0.f;
      const float fx = valid ? xs - floorf(xs) : 0.f;
      const int idx = index(n, j);
      if (m_out != nullptr)
        m_out[idx] = valid ? (1.f - fy) * (1.f - fx) * d[0] +
                                 (1.f - fy) * fx * d[1] +
                                 fy * (1.f - fx) * d[2] + fy * fx * d[3]
                           : 0.f;
      if (off_out != nullptr) {
        // d/dy and d/dx of the four corner weights, times the corner dots
        const float gy = (1.f - fx) * (d[2] - d[0]) + fx * (d[3] - d[1]);
        const float gx = (1.f - fy) * (d[1] - d[0]) + fy * (d[3] - d[2]);
        off_out[2 * idx] = valid ? om[j] * gy : 0.f;
        off_out[2 * idx + 1] = valid ? om[j] * gx : 0.f;
      }
    }
  };

  float oy0[TPT], ox0[TPT], om0[TPT];  // chunk n
  float oy1[TPT], ox1[TPT], om1[TPT];  // chunk n + 1
  float oy2[TPT], ox2[TPT], om2[TPT];  // chunk n + 2
  load(0, oy0, ox0, om0);
  copy_corners(0, oy0, ox0);
  cp_async_commit();
  if (n_chunks > 1) load(1, oy1, ox1, om1);
  for (int n = 0; n < n_chunks; ++n, ++q) {
    if (n + 2 < n_chunks) load(n + 2, oy2, ox2, om2);
    if (n + 1 < n_chunks) copy_corners(n + 1, oy1, ox1);
    cp_async_commit();
    cp_async_wait<1>();  // this thread's corners of chunk n landed
    bar_sync(BAR_FULL + (q & 1), THREADS);
    dots(n, oy0, ox0, om0);
    bar_arrive(BAR_EMPTY + (q & 1), THREADS);
#pragma unroll
    for (int j = 0; j < TPT; ++j) {
      oy0[j] = oy1[j];
      ox0[j] = ox1[j];
      om0[j] = om1[j];
      oy1[j] = oy2[j];
      ox1[j] = ox2[j];
      om1[j] = om2[j];
    }
  }
  cp_async_wait<0>();
}

// VEC: cg is a multiple of 4 and x is aligned for 4-channel loads; the
// lanes of a sample then take interleaved 4-channel vectors.
// CGT: the group width when the kernel is instantiated for one (8, 16 or
// 32 channels, G a multiple of the groups a chunk holds), else 0.
// PRESPLIT: grad_out's rows are split into their big and small TF32 parts
// once a tile, in shared memory, instead of at every product (PT 64).
// GATHER (CGT 8, PT 64, no grad_x): the dot warps copy each chunk's corners
// into shared memory with cp.async one chunk ahead.
template <typename T, bool VEC, int CGT, bool PRESPLIT, int PT, bool GATHER>
__global__ void __launch_bounds__(THREADS, 1)
mdc_backward_kernel(const T* __restrict__ x, const float* __restrict__ offset,
                    const float* __restrict__ mask,
                    const float* __restrict__ gout,
                    const float* __restrict__ wkc, float* __restrict__ g_offset,
                    float* __restrict__ g_mask, float* __restrict__ g_x,
                    int batch, int h, int w, int c, int ho, int wo, int g,
                    int kh, int kw, int sh, int sw, int ph, int pw, int dh,
                    int dw, int co, int lane_bits_arg) {
  constexpr int WARPS_N = Tile<PT>::WARPS_N;
  constexpr int MT = Tile<PT>::MT;
  constexpr int NT = Tile<PT>::NT;
  extern __shared__ __align__(16) float smem[];
  const int lda = a_ld(co);
  const int cop = padded_co(co);
  const int k_taps = kh * kw;
  const int gk = g * k_taps;
  float* a_s = smem;                        // grad_out (its big parts)
  float* a_sm = a_s + PT * lda;             // its small parts (PRESPLIT)
  float* w_s = a_sm + (PRESPLIT ? PT * lda : 0);
  float* g_s = w_s + SLOTS * NC * LDW;      // two buffers of PT x LDG
  // the tile's pixels' base sampling point (y, x)
  float2* pix_s = reinterpret_cast<float2*>(g_s + 2 * PT * LDG);
  // (GATHER) two chunks' corners: [chunk & 1][vector][dot thread]
  T* c_s = reinterpret_cast<T*>(pix_s + PT);

  const int tid = threadIdx.x;
  const int lane32 = tid & 31;
  const int n_pix = ho * wo;
  const int tiles_img = (n_pix + PT - 1) / PT;
  const int64_t n_tiles = static_cast<int64_t>(batch) * tiles_img;
  const int cg = CGT ? CGT : c / g;
  const int lane_bits = CGT ? (CGT >= 16 ? 2 : 1) : lane_bits_arg;
  const int gpc = CGT ? NC / CGT : min(g, NC / cg);  // groups per chunk
  const int cpt = (g + gpc - 1) / gpc;    // chunks per tap
  const int n_chunks = k_taps * cpt;
  const int n_ks = cop / KS;              // ring slices per chunk
  const int n_stages = n_chunks * n_ks;

  if (tid < MMA_THREADS) {
    // ------------------------------------------------ MMA warps: form G
    const int warp = tid >> 5;
    const int wm = warp / WARPS_N;
    const int wn = warp % WARPS_N;
    const int gq = lane32 >> 2;
    const int tq = lane32 & 3;
    // ldmatrix row address of the lane in grad_out (m16 x 8 words), and
    // the lane's B word in a slot: (depth tq, G column gq) of an n8 tile
    const uint32_t a_addr =
        smem_addr(a_s) +
        ((wm * MT * 16 + (lane32 & 7) + 8 * ((lane32 >> 3) & 1)) * lda +
         4 * (lane32 >> 4)) * 4;
    const int b_off = (wn * NT * 8 + gq) * LDW + tq;
    int q = 0;  // chunks over the block's tiles
    for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int b = static_cast<int>(tile / tiles_img);
      const int p0 = static_cast<int>(tile % tiles_img) * PT;
      bar_sync(BAR_MMA, MMA_THREADS);  // the last tile's products are done

      // the tile's grad_out rows; zeros past the image's pixels and past Co
      {
        const float* src =
            gout + (static_cast<int64_t>(b) * n_pix + p0) * co;
        const uint32_t base = smem_addr(a_s);
        const int nv = cop / 4;
        for (int i = tid; i < PT * nv; i += MMA_THREADS) {
          const int r = i / nv;
          const int qv = 4 * (i % nv);
          const bool in = p0 + r < n_pix && qv < co;
          cp_async16(base + (r * lda + qv) * 4,
                     in ? src + static_cast<int64_t>(r) * co + qv : gout,
                     in ? 16 : 0);
        }
        cp_async_commit();
      }
      // ring stage t: slice t % n_ks of chunk t / n_ks, the chunk's rows
      // of w_kc (rows past its groups and columns past Co zero-filled)
      auto load_w = [&](int t, int slot) {
        const int n = t / n_ks;
        const int o0 = (t % n_ks) * KS;
        const int g0 = (n % cpt) * gpc;
        const int rows = min(gpc, g - g0) * cg;
        const int64_t row0 = static_cast<int64_t>(n / cpt) * c + g0 * cg;
        const uint32_t base = smem_addr(w_s) + slot * NC * LDW * 4;
        for (int i = tid; i < NC * (KS / 4); i += MMA_THREADS) {
          const int r = i / (KS / 4);
          const int qv = 4 * (i % (KS / 4));
          const bool in = r < rows && o0 + qv < co;
          cp_async16(base + (r * LDW + qv) * 4,
                     in ? wkc + (row0 + r) * co + o0 + qv : wkc, in ? 16 : 0);
        }
      };
#pragma unroll
      for (int s = 0; s < SLOTS - 1; ++s) {
        if (s < n_stages) load_w(s, s);
        cp_async_commit();
      }
      if constexpr (PRESPLIT) {
        cp_async_wait<SLOTS - 1>();  // grad_out's rows landed
        bar_sync(BAR_MMA, MMA_THREADS);
        for (int i = tid; i < PT * lda; i += MMA_THREADS) {
          uint32_t big, small;
          split_tf32_int(__float_as_uint(a_s[i]), big, small);
          a_s[i] = __uint_as_float(big);
          a_sm[i] = __uint_as_float(small);
        }
      }

      int t = 0;
      for (int n = 0; n < n_chunks; ++n, ++q) {
        const int ng = CGT ? gpc : min(gpc, g - (n % cpt) * gpc);
        float acc[MT][NT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
        for (int s = 0; s < n_ks; ++s, ++t) {
          cp_async_wait<SLOTS - 2>();
          bar_sync(BAR_MMA, MMA_THREADS);  // stage t landed (and grad_out);
                                           // stage t - 1's products done
          if (t + SLOTS - 1 < n_stages)
            load_w(t + SLOTS - 1, (t + SLOTS - 1) % SLOTS);
          cp_async_commit();
          if (wn * NT * 8 >= ng * cg) continue;  // columns past the chunk
          const float* ws = w_s + (t % SLOTS) * NC * LDW + b_off;
#pragma unroll
          for (int kk = 0; kk < KS / 8; ++kk) {
            uint32_t a_big[MT][4], a_small[MT][4];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              const uint32_t at =
                  a_addr + (mt * 16 * lda + s * KS + kk * 8) * 4;
              if constexpr (PRESPLIT) {
                ldmatrix_x4(at, a_big[mt][0], a_big[mt][1], a_big[mt][2],
                            a_big[mt][3]);
                ldmatrix_x4(at + PT * lda * 4, a_small[mt][0], a_small[mt][1],
                            a_small[mt][2], a_small[mt][3]);
              } else {
                uint32_t a[4];
                ldmatrix_x4(at, a[0], a[1], a[2], a[3]);
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  split_tf32_int(a[e], a_big[mt][e], a_small[mt][e]);
              }
            }
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              const float* wk = ws + nt * 8 * LDW + kk * 8;
              uint32_t b_big[2], b_small[2];
              split_tf32_int(__float_as_uint(wk[0]), b_big[0], b_small[0]);
              split_tf32_int(__float_as_uint(wk[4]), b_big[1], b_small[1]);
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
        // G of the chunk into buffer q & 1 once the dot warps are done with
        // it: accumulator (row gq, cols 2 tq, 2 tq + 1) and (row gq + 8,
        // the same cols) of each tile
        const int buf = q & 1;
        if (q >= 2) bar_sync(BAR_EMPTY + buf, THREADS);
        float* gb = g_s + buf * PT * LDG;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = wm * MT * 16 + mt * 16 + hh * 8 + gq;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
              *reinterpret_cast<float2*>(gb + row * LDG + wn * NT * 8 +
                                         nt * 8 + 2 * tq) =
                  make_float2(acc[mt][nt][2 * hh], acc[mt][nt][2 * hh + 1]);
          }
        bar_arrive(BAR_FULL + buf, THREADS);
      }
      cp_async_wait<0>();
    }
    // the dot warps' releases of the last two chunks
    for (int r = q < 2 ? 0 : q - 2; r < q; ++r)
      bar_sync(BAR_EMPTY + (r & 1), THREADS);
  } else {
    // ---------------------------------- dot warps: G into the corner dots
    const int dt = tid - MMA_THREADS;
    const int lanes = 1 << lane_bits;
    const unsigned lane_mask = ((1u << lanes) - 1u)
                               << (lane32 & ~(lanes - 1));
    int q = 0;
    for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int b = static_cast<int>(tile / tiles_img);
      const int p0 = static_cast<int>(tile % tiles_img) * PT;
      const int rows = min(PT, n_pix - p0);
      const int64_t first = (static_cast<int64_t>(b) * n_pix + p0) * gk;
      // the tile's offsets, masks and their gradients, indexed by the
      // sample's place in the tile
      const float* off_in = offset + 2 * first;
      const float* m_in = mask + first;
      float* off_out = g_offset == nullptr ? nullptr : g_offset + 2 * first;
      float* m_out = g_mask == nullptr ? nullptr : g_mask + first;
      bar_sync(BAR_DOT, DOT_THREADS);  // the last tile's pixels are done
      for (int pl = dt; pl < rows; pl += DOT_THREADS) {
        const int p = p0 + pl;
        pix_s[pl] = make_float2(static_cast<float>((p / wo) * sh - ph),
                                static_cast<float>((p % wo) * sw - pw));
      }
      bar_sync(BAR_DOT, DOT_THREADS);

      if constexpr (GATHER) {
        gather_tile<T, CGT, PT>(x, off_in, m_in, off_out, m_out, g_s, pix_s,
                                c_s, dt, lane_mask, rows, b, h, w, c, g,
                                k_taps, kw, dh, dw, cpt, n_chunks, q);
        continue;
      }
      for (int n = 0; n < n_chunks; ++n, ++q) {
        const int k = n / cpt;
        const int g0 = (n % cpt) * gpc;
        const int ng = CGT ? gpc : min(gpc, g - g0);
        const float ky = static_cast<float>((k / kw) * dh);
        const float kx = static_cast<float>((k % kw) * dw);
        const int buf = q & 1;
        const float* gb = g_s + buf * PT * LDG;
        bar_sync(BAR_FULL + buf, THREADS);
        // the chunk's (pixel, group) samples: lane fastest, then the group,
        // then the pixel; a thread carries CU samples at once
        const int n_tasks = (PT * ng) << lane_bits;
        for (int e0 = dt; e0 < n_tasks; e0 += CU * DOT_THREADS) {
          Sample sm[CU];
#pragma unroll
          for (int j = 0; j < CU; ++j) {
            Sample& sq = sm[j];
            const int e = e0 + j * DOT_THREADS;
            const int sample = e >> lane_bits;
            sq.gl = sample % ng;
            sq.pl = sample / ng;
            // a sample's lanes agree on both tests
            sq.act = e < n_tasks && sq.pl < rows;
            sq.idx = (sq.pl * g + g0 + sq.gl) * k_taps + k;
            sq.y = sq.x = sq.m = 0.f;
            if (sq.act) {
              const float2 base = pix_s[sq.pl];
              const float2 o =
                  *reinterpret_cast<const float2*>(off_in + 2 * sq.idx);
              sq.y = (base.x + ky) + o.x;
              sq.x = (base.y + kx) + o.y;
              sq.m = m_in[sq.idx];
            }
          }
          corner_dots<T, VEC>(sm, x, gb, off_out, m_out, g_x, b, h, w, c,
                              cg, g0, lane_bits, lane_mask);
        }
        bar_arrive(BAR_EMPTY + buf, THREADS);
      }
    }
  }
}

template <typename T, bool VEC, int CGT, bool PRESPLIT, int PT, bool GATHER>
int run(const void* x, const void* offset, const void* mask, const void* gout,
        const void* wkc, void* g_offset, void* g_mask, void* g_x, int batch,
        int h, int w, int c, int ho, int wo, int g, int kh, int kw, int sh,
        int sw, int ph, int pw, int dh, int dw, int co, int lane_bits,
        cudaStream_t stream) {
  const auto kernel = mdc_backward_kernel<T, VEC, CGT, PRESPLIT, PT, GATHER>;
  const size_t smem =
      smem_bytes(co, PRESPLIT, PT, GATHER ? gather_bytes<T>() : 0);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // one block a SM walks the tiles (blockIdx.x, + gridDim.x, ...)
  const int64_t tiles =
      static_cast<int64_t>(batch) * ((static_cast<int64_t>(ho) * wo + PT - 1) /
                                     PT);
  int64_t blocks = static_cast<int64_t>(sm_count()) *
                   blocks_per_sm(kernel, THREADS, smem);
  if (blocks > tiles) blocks = tiles;
  if (blocks < 1) blocks = 1;
  kernel<<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(offset),
      static_cast<const float*>(mask), static_cast<const float*>(gout),
      static_cast<const float*>(wkc), static_cast<float*>(g_offset),
      static_cast<float*>(g_mask), static_cast<float*>(g_x), batch, h, w, c,
      ho, wo, g, kh, kw, sh, sw, ph, pw, dh, dw, co, lane_bits);
  return static_cast<int>(cudaGetLastError());
}

// The variants below are chosen by shape; each is measured against its
// absence by c2matching_tpu_torch/scripts/bench_dcn_backward.py, which
// builds this file with one of these switches set to 0 (all 1 by default).
#ifndef C2M_DCB_GATHER
#define C2M_DCB_GATHER 1
#endif
#ifndef C2M_DCB_WIDE
#define C2M_DCB_WIDE 1
#endif
#ifndef C2M_DCB_PRESPLIT
#define C2M_DCB_PRESPLIT 1
#endif
#ifndef C2M_DCB_CGT
#define C2M_DCB_CGT 1
#endif

template <typename T>
int launch(const void* x, const void* offset, const void* mask,
           const void* gout, const void* wkc, void* g_offset, void* g_mask,
           void* g_x, int batch, int h, int w, int c, int ho, int wo, int g,
           int kh, int kw, int sh, int sw, int ph, int pw, int dh, int dw,
           int co, void* stream) {
  const int64_t n_pix = static_cast<int64_t>(ho) * wo;
  if (batch < 1 || h < 1 || w < 1 || ho < 1 || wo < 1 || kh < 1 || kw < 1 ||
      g < 1 || c % g || c / g > NC || co < 1 || co % 4 || co > MAX_CO ||
      static_cast<int64_t>(batch) * n_pix > 0x7fffffffLL ||
      reinterpret_cast<uintptr_t>(gout) % 16 ||
      reinterpret_cast<uintptr_t>(wkc) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int cg = c / g;
  const bool vec = cg % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T)) == 0;
  // one lane per 4-channel vector of the group, at most 4 (2 bits)
  const int vectors = vec ? cg / 4 : 1;
  const int lane_bits = vectors >= 4 ? 2 : (vectors >= 2 ? 1 : 0);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // The training group widths get their own instantiations (CGT). Their
  // tiles are 128 pixels where 64-pixel tiles would fill fewer than two
  // waves of the card (one wider wave, no half-empty second one) and the
  // rows fit; 64-pixel tiles split grad_out once a tile (PRESPLIT: both
  // parts fit up to MAX_CO), 128-pixel ones at every product. At 8-channel
  // groups (the corner dots outweigh the products) without grad_x, the
  // corners are gathered by cp.async where their buffers fit too.
  const int64_t tiles64 = batch * ((n_pix + 63) / 64);
  const bool special = C2M_DCB_CGT && vec && g % (NC / cg) == 0 &&
                       (cg == 8 || cg == 16 || cg == 32);
  const bool wide = C2M_DCB_WIDE && special &&
                    tiles64 < 2 * static_cast<int64_t>(sm_count()) &&
                    smem_bytes(co, false, 128) <= MAX_SMEM;
  const bool gather = C2M_DCB_GATHER && special && !wide && cg == 8 &&
                      g_x == nullptr &&
                      smem_bytes(co, C2M_DCB_PRESPLIT, 64,
                                 gather_bytes<T>()) <= MAX_SMEM;
  constexpr bool PS = C2M_DCB_PRESPLIT;
#define C2M_RUN(VEC_, CGT_, PS_, PT_, GA_)                                   \
  run<T, VEC_, CGT_, PS_, PT_, GA_>(x, offset, mask, gout, wkc, g_offset,     \
                                    g_mask, g_x, batch, h, w, c, ho, wo, g,   \
                                    kh, kw, sh, sw, ph, pw, dh, dw, co,       \
                                    lane_bits, s)
#define C2M_TILE(CGT_)                                                       \
  (wide ? C2M_RUN(true, CGT_, false, 128, false)                             \
        : C2M_RUN(true, CGT_, PS, 64, false))
  if (gather) return C2M_RUN(true, 8, PS, 64, true);
  if (special)
    return cg == 8 ? C2M_TILE(8) : (cg == 16 ? C2M_TILE(16) : C2M_TILE(32));
  return vec ? C2M_RUN(true, 0, PS, 64, false)
             : C2M_RUN(false, 0, PS, 64, false);
#undef C2M_TILE
#undef C2M_RUN
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
