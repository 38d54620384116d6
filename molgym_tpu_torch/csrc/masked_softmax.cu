// Masked row softmax and its backward, f32, for Hopper (sm_90a).
//
//   x[r, n]   = mask[r, n] ? logits[r, n] : -1e9
//   e[r, n]   = exp(x[r, n] - max_n x[r, n]) * mask[r, n]
//   out[r, n] = e[r, n] / max(sum_n e[r, n], 1e-20)
//
// exact zeros where masked, and a row of zeros (not NaN) where every entry
// is masked. Backward, from the saved output p and the output gradient g
// (the row maximum carries no gradient):
//
//   dlogits[r, n] = p[r, n] * (g[r, n] - sum_n g[r, n] p[r, n])
//
// which is zero where masked, because p is.
//
// Replaces molgym_tpu/ops/pallas_softmax.py:_softmax_kernel (the focus and
// element heads' normalisation); that kernel has no backward, this one is on
// the training path and needs one.
//
// Bound on the H100: the forward reads logits (4 bytes) and the mask
// (1 byte) and writes out (4 bytes), the backward reads p and g and writes
// dlogits (12 bytes an element). At the heads' shapes ([140, 7], [140, 3])
// that is 9 KB or less, a few ns at 3.35 TB/s, far below the time of one
// launch; at [8192, 128] it is 9.4 MB forward and 12.6 MB backward, 2.8 us
// and 3.8 us. Both are bound by bytes.
//
// Design: one warp per row, four rows a block. The lanes stride over the
// row, so any N is taken, and a row's three passes (maximum, sum, write)
// read it from L1 after the first. The reductions are warp shuffles in a
// fixed order: the same bits every run.
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;
constexpr float NEG_INF = -1e9f;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void masked_softmax_kernel(
    const float* __restrict__ logits,          // [rows, N]
    const unsigned char* __restrict__ mask,    // [rows, N], 0 = masked
    float* __restrict__ out,                   // [rows, N]
    int rows, int N) {
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;                     // whole warps leave together
  const float* x = logits + (size_t)row * N;
  const unsigned char* mk = mask + (size_t)row * N;
  float* o = out + (size_t)row * N;

  float vmax = NEG_INF;
  for (int n = lane; n < N; n += 32)
    vmax = fmaxf(vmax, mk[n] ? x[n] : NEG_INF);
  vmax = warp_max(vmax);

  float sum = 0.f;
  for (int n = lane; n < N; n += 32)
    if (mk[n]) sum += expf(x[n] - vmax);
  sum = fmaxf(warp_sum(sum), 1e-20f);

  for (int n = lane; n < N; n += 32)
    o[n] = mk[n] ? expf(x[n] - vmax) / sum : 0.f;
}

__global__ void masked_softmax_bwd_kernel(
    const float* __restrict__ probs,           // [rows, N]
    const float* __restrict__ grad,            // [rows, N]
    float* __restrict__ dlogits,               // [rows, N]
    int rows, int N) {
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* p = probs + (size_t)row * N;
  const float* g = grad + (size_t)row * N;
  float* d = dlogits + (size_t)row * N;

  float dot = 0.f;
  for (int n = lane; n < N; n += 32) dot += g[n] * p[n];
  dot = warp_sum(dot);
  for (int n = lane; n < N; n += 32) d[n] = p[n] * (g[n] - dot);
}

}  // namespace

// Both launch on `stream` and return cudaGetLastError() (0 on success).
extern "C" int masked_softmax_f32(
    const float* logits, const unsigned char* mask, float* out, int rows,
    int N, void* stream) {
  if (rows > 0 && N > 0) {
    const int blocks = (rows + WARPS - 1) / WARPS;
    masked_softmax_kernel<<<blocks, 32 * WARPS, 0, (cudaStream_t)stream>>>(
        logits, mask, out, rows, N);
  }
  return (int)cudaGetLastError();
}

extern "C" int masked_softmax_bwd_f32(
    const float* probs, const float* grad, float* dlogits, int rows, int N,
    void* stream) {
  if (rows > 0 && N > 0) {
    const int blocks = (rows + WARPS - 1) / WARPS;
    masked_softmax_bwd_kernel<<<blocks, 32 * WARPS, 0, (cudaStream_t)stream>>>(
        probs, grad, dlogits, rows, N);
  }
  return (int)cudaGetLastError();
}
