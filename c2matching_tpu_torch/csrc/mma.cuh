// Device helpers shared by the tensor-core kernels (B1 patch_match.cu, B2
// dcn_window.cu, the B3 backward deform_conv_backward.cu): shared-memory
// addresses, ldmatrix fragment loads (B2's A operand) and the split of an
// f32 value into two TF32 values for 3xTF32.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace c2m {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t& d0,
                                            uint32_t& d1, uint32_t& d2,
                                            uint32_t& d3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(d0), "=r"(d1), "=r"(d2), "=r"(d3)
      : "r"(addr));
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
