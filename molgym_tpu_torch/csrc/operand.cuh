// Operand types of the encoder's kernels (cg_aggregate*.cu, cg_square*.cu),
// f32 or bf16 for the encoder's bf16 path (--encoder_dtype=bfloat16), and the
// copies that stage them into shared memory.
//
// Whatever the operand type, a kernel does its arithmetic in f32: it converts
// each bf16 operand to f32 as it stages it into shared memory, keeps the CG
// coefficients and every intermediate (the pair tensor z, dz, e, the sums) in
// f32, and rounds each output once to bf16 (round to nearest even). That is
// the function "bf16 in, f32 math, bf16 out", which the plain versions in
// ops/fused_agg.py compute too. The TPU kernels also round the coefficients
// and z to bf16 (molgym_tpu/ops/pallas_agg.py:_mxu_dtype), only because the
// TPU's matrix unit takes bf16 inputs; no unit of this card forces that here.
#pragma once

#include <cuda_bf16.h>

namespace operand {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// floats between the 16-byte line that holds *p and p: where a row staged
// from p by stage_row lies in its buffer (bf16 rows lie at its start)
__device__ __forceinline__ int lead_floats(const float* p) {
  return (int)((reinterpret_cast<size_t>(p) & 15) >> 2);
}
__device__ __forceinline__ int lead_floats(const __nv_bfloat16*) { return 0; }

__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The n values of a row at `src` into shared floats at `dst`, by the block's
// threads. f32: 16-byte cp.async copies from the line that holds the row's
// first value, so the row lies at dst + lead_floats(src) and the buffer needs
// up to 3 floats of slack (the first and last lines may reach up to 12 bytes
// outside the tensor, inside a line that holds valid values, so inside its
// allocation). bf16: converted value by value, 2-byte loads that are aligned
// at any offset, to the buffer's start; no copy is left in flight.
__device__ __forceinline__ void stage_row(float* dst, const float* src, int n) {
  const int lead = lead_floats(src);
  for (int c = threadIdx.x; 4 * c < lead + n; c += blockDim.x)
    cp_async_16(dst + 4 * c, src - lead + 4 * c);
}
__device__ __forceinline__ void stage_row(float* dst, const __nv_bfloat16* src, int n) {
  for (int c = threadIdx.x; c < n; c += blockDim.x) dst[c] = to_f32(src[c]);
}

// one value: a 4-byte cp.async copy, or a conversion
__device__ __forceinline__ void stage_value(float* dst, const float* src) {
  cp_async_4(dst, src);
}
__device__ __forceinline__ void stage_value(float* dst, const __nv_bfloat16* src) {
  *dst = to_f32(*src);
}

}  // namespace operand
