// Backward (vector-Jacobian product) of the CG square of cg_square.cu, f32,
// for Hopper (sm_90a). Given the output gradients g[r, k] (real and
// imaginary parts separate) of out[r, k] = sum_p C[p, k] a[r, m_p] a[r, n_p]:
//
//   dz[r, p]    = sum_k C[p, k] g[r, k]
//   da[r, m_p] += dz[r, p] conj(a[r, n_p])
//   da[r, n_p] += dz[r, p] conj(a[r, m_p])
//
// The rep is both operands of every pair, so both product-rule terms land
// on it, and a diagonal pair (m, m) contributes twice, whatever factor the
// tri fold put into its coefficients. One code path serves the dense, the
// l1-grouped and the tri pair lists, as in the forward.
//
// Replaces molgym_tpu/ops/pallas_agg.py:_bwd_kernel with n_j = 1 and a pair
// list (the square's VJP, de + dq summed by JAX because one array is both
// operands).
//
// Bound on the H100 at the SF6 shapes (rows = 140 * 7 * 10 = 9,800, M = 25,
// P = 325 tri pairs, K = 375): the kernel must read g (29.4 MB) and a
// (2.0 MB) and write da (2.0 MB), about 10 us at 3.35 TB/s; its arithmetic,
// 4 operations for each of the folded table's 1,130 nonzeros and 16 per
// pair, is about 0.1 GFLOP, under 2 us at 67 TFLOP/s. It is bound by bytes:
// the read of g.
//
// Design: a block takes ROWS rows, stages a and g in shared memory (g read
// once, coalesced along k), forms dz for its rows from the CG table as
// compressed sparse rows (the transpose of the forward's columns), and then
// gives each (row, m) to one thread, which walks the pairs that hold m
// (an incidence table built on the host, each pair listed once per operand
// slot). Each da[r, m] is thus one thread's sum: no atomics, and the same
// bits every run.
#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 8;

__global__ void cg_square_bwd_kernel(
    const float* __restrict__ a_r,       // [rows, M]
    const float* __restrict__ a_i,       // [rows, M]
    const float* __restrict__ g_r,       // [rows, K]
    const float* __restrict__ g_i,       // [rows, K]
    const int* __restrict__ rowptr,      // [P + 1]
    const int* __restrict__ col,         // [nnz] output column k
    const float* __restrict__ coef,      // [nnz]
    const int* __restrict__ mptr,        // [M + 1]
    const int* __restrict__ inc_pair,    // [2P] pair holding m
    const int* __restrict__ inc_other,   // [2P] that pair's other slot
    float* __restrict__ da_r,            // [rows, M]
    float* __restrict__ da_i,            // [rows, M]
    int rows, int M, int P, int K) {
  extern __shared__ float smem[];
  float* s_ar = smem;                    // [ROWS][M]
  float* s_ai = s_ar + ROWS * M;
  float* s_gr = s_ai + ROWS * M;         // [ROWS][K]
  float* s_gi = s_gr + ROWS * K;
  float* dz_r = s_gi + ROWS * K;         // [ROWS][P]
  float* dz_i = dz_r + ROWS * P;

  const int row0 = blockIdx.x * ROWS;
  const int nrows = min(ROWS, rows - row0);
  for (int idx = threadIdx.x; idx < nrows * M; idx += blockDim.x) {
    s_ar[idx] = a_r[(size_t)row0 * M + idx];
    s_ai[idx] = a_i[(size_t)row0 * M + idx];
  }
  for (int idx = threadIdx.x; idx < nrows * K; idx += blockDim.x) {
    s_gr[idx] = g_r[(size_t)row0 * K + idx];
    s_gi[idx] = g_i[(size_t)row0 * K + idx];
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < nrows * P; idx += blockDim.x) {
    const int r = idx / P;
    const int p = idx - r * P;
    const float* gr = s_gr + r * K;
    const float* gi = s_gi + r * K;
    float acc_r = 0.f, acc_i = 0.f;
    const int end = __ldg(rowptr + p + 1);
    for (int e = __ldg(rowptr + p); e < end; ++e) {
      const int k = __ldg(col + e);
      const float c = __ldg(coef + e);
      acc_r += c * gr[k];
      acc_i += c * gi[k];
    }
    dz_r[idx] = acc_r;
    dz_i[idx] = acc_i;
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < nrows * M; idx += blockDim.x) {
    const int r = idx / M;
    const int m = idx - r * M;
    const float* zr = dz_r + r * P;
    const float* zi = dz_i + r * P;
    const float* ar = s_ar + r * M;
    const float* ai = s_ai + r * M;
    float acc_r = 0.f, acc_i = 0.f;
    const int end = __ldg(mptr + m + 1);
    for (int e = __ldg(mptr + m); e < end; ++e) {
      const int p = __ldg(inc_pair + e);
      const int o = __ldg(inc_other + e);
      acc_r += zr[p] * ar[o] + zi[p] * ai[o];
      acc_i += zi[p] * ar[o] - zr[p] * ai[o];
    }
    da_r[(size_t)row0 * M + idx] = acc_r;
    da_i[(size_t)row0 * M + idx] = acc_i;
  }
}

}  // namespace

extern "C" size_t cg_square_bwd_smem_bytes(int M, int P, int K) {
  return sizeof(float) * 2 * (size_t)ROWS * (M + K + P);
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int cg_square_bwd_f32(
    const float* a_r, const float* a_i, const float* g_r, const float* g_i,
    const int* rowptr, const int* col, const float* coef, const int* mptr,
    const int* inc_pair, const int* inc_other, float* da_r, float* da_i,
    int rows, int M, int P, int K, void* stream) {
  const size_t smem = cg_square_bwd_smem_bytes(M, P, K);
  cudaError_t err = cudaFuncSetAttribute(
      cg_square_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (rows > 0) {
    const int blocks = (rows + ROWS - 1) / ROWS;
    cg_square_bwd_kernel<<<blocks, 256, smem, (cudaStream_t)stream>>>(
        a_r, a_i, g_r, g_i, rowptr, col, coef, mptr, inc_pair, inc_other,
        da_r, da_i, rows, M, P, K);
  }
  return (int)cudaGetLastError();
}
