// Device helpers shared by the tensor-core kernels: cp.async copies,
// ldmatrix fragment loads and mma.sync products (B2 dcn_window.cu, the B3
// backward deform_conv_backward.cu), and the split of an f32 value into two
// TF32 values for 3xTF32 (those and B1 patch_match.cu, whose products are
// wgmma).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace c2m {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy that bypasses L1; src_bytes = 0 writes
// zeros and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t& d0,
                                            uint32_t& d1, uint32_t& d2,
                                            uint32_t& d3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(d0), "=r"(d1), "=r"(d2), "=r"(d3)
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The same with a zero accumulator: one zero register feeds all four C
// operands, so a fresh fragment costs no moves.
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// x = big + small + (a rest of ~2^-22 |x|), both parts TF32 values.
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& big,
                                           uint32_t& small) {
  const float xf = __uint_as_float(x);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(xf));
  const float rest = xf - __uint_as_float(big);  // exact in f32
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(rest));
}

// The same split by integer operations, rounding as cvt.rna does for every
// finite x: half of the 13 dropped bits is added to the magnitude, then
// they are cleared: two integer operations in place of each conversion.
__device__ __forceinline__ void split_tf32_int(uint32_t x, uint32_t& big,
                                               uint32_t& small) {
  big = (x + 0x1000u) & 0xffffe000u;
  const float rest = __uint_as_float(x) - __uint_as_float(big);  // exact
  small = (__float_as_uint(rest) + 0x1000u) & 0xffffe000u;
}

}  // namespace c2m
