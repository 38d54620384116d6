// What the CG product's forward (cg_product.cu) and backward
// (cg_product_bwd.cu) share: the slot layout of a tile's rows in shared
// memory, the asynchronous copies that fill it, and the host's one-time
// raise of a kernel's shared-memory limit.
//
// The slot layout is decided on the host: ops/fused_cg.py:slot_stride sizes
// each kernel's shared memory from it (product_fwd_plan, product_bwd_smem),
// and slot_stride below must give the same strides, or the kernels' reads
// leave their blocks' shared memory (tests/test_torch_fused_cg.py holds the
// two against each other).
#pragma once

#include <cuda_runtime.h>

#include <array>
#include <map>
#include <mutex>

namespace {

constexpr int kWarp = 32;
constexpr int kDefaultSmem = 48 * 1024;

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) / 16 * 16; }

// float2 per slot (a, b, g or dz of one index) for a tile of R rows:
// 16-byte multiples (8 bytes at R = 1) on which slot s starts at bank group
// s or 3 s mod 8
template <int R>
__host__ __device__ constexpr int slot_stride() {
  return R >= 4 ? R + 2 : R;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// R complex values from a 16-byte aligned slot (8 bytes for R = 1)
template <int R>
__device__ __forceinline__ void load_slot(const float2* p, float2 (&v)[R]) {
  if constexpr (R == 1) {
    v[0] = p[0];
  } else {
    const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
    for (int j = 0; j < R / 2; ++j) {
      const float4 t = q[j];
      v[2 * j] = make_float2(t.x, t.y);
      v[2 * j + 1] = make_float2(t.z, t.w);
    }
  }
}

// Raises `kernel`'s limit of dynamic shared memory to `smem` where that is
// above the default, once per (device, tile) and larger size: a launch at
// the default costs the host nothing. False if the runtime refuses. Each
// source that includes this keeps its own map, for its own kernels.
template <typename Kernel>
bool allow_smem(Kernel kernel, int rows_per_tile, int smem) {
  if (smem <= kDefaultSmem) return true;
  static std::mutex mutex;
  static std::map<std::array<int, 2>, int> limit;
  int dev = 0;
  cudaGetDevice(&dev);
  std::lock_guard<std::mutex> lock(mutex);
  int& allowed = limit[{dev, rows_per_tile}];
  if (smem > allowed) {
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem) != cudaSuccess)
      return false;
    allowed = smem;
  }
  return true;
}

}  // namespace
