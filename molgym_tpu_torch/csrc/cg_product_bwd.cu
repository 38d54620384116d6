// Backward (vector-Jacobian product) of the CG product of cg_product.cu,
// f32, for Hopper (sm_90a). Given the output gradients g[r, k] (real and
// imaginary parts separate) of out[r, k] = sum_{m,n} C[m*M2+n, k] a[r,m] b[r,n]:
//
//   dz[r, m, n] = sum_k C[m*M2 + n, k] g[r, k]
//   da[r, m]    = sum_n dz[r, m, n] conj(b[r, n])
//   db[r, n]    = sum_m dz[r, m, n] conj(a[r, m])
//
// Replaces molgym_tpu/ops/pallas_cg.py:_bwd_kernel, which again spreads a
// and b over the pair axis with 0/1 matrix products and folds the pair axis
// back with their transposes.
//
// Bound on the H100 at the SF6 shapes (rows = 560, M1 = M2 = 25, K = 375,
// 1,396 nonzeros): the kernel must read g (1.68 MB), a and b (0.22 MB) and
// the table (17 KB) and write da and db (0.22 MB), about 0.6 us at
// 3.35 TB/s; its arithmetic, 4 operations a nonzero and 16 a pair for each
// row, is 0.009 GFLOP, 0.1 us at 67 TFLOP/s. It is bound by bytes, the read
// of g, and the bound lies below the time of one launch.
//
// Design: a block takes ROWS rows, stages a, b and g in shared memory (g
// read once, coalesced along k), forms dz for its rows in shared memory
// from the table as compressed sparse rows (the transpose of the forward's
// columns), and then gives each (row, m) of da and each (row, n) of db to
// one thread, which sums over the other index. Every output element is one
// thread's sum: no atomics, and the same bits every run.
#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 4;

__global__ void cg_product_bwd_kernel(
    const float* __restrict__ a_r,       // [rows, M1]
    const float* __restrict__ a_i,       // [rows, M1]
    const float* __restrict__ b_r,       // [rows, M2]
    const float* __restrict__ b_i,       // [rows, M2]
    const float* __restrict__ g_r,       // [rows, K]
    const float* __restrict__ g_i,       // [rows, K]
    const int* __restrict__ rowptr,      // [M1 * M2 + 1]
    const int* __restrict__ col,         // [nnz] output column k
    const float* __restrict__ coef,      // [nnz]
    float* __restrict__ da_r,            // [rows, M1]
    float* __restrict__ da_i,            // [rows, M1]
    float* __restrict__ db_r,            // [rows, M2]
    float* __restrict__ db_i,            // [rows, M2]
    int rows, int M1, int M2, int K) {
  extern __shared__ float smem[];
  const int P = M1 * M2;
  float* s_ar = smem;                    // [ROWS][M1]
  float* s_ai = s_ar + ROWS * M1;
  float* s_br = s_ai + ROWS * M1;        // [ROWS][M2]
  float* s_bi = s_br + ROWS * M2;
  float* s_gr = s_bi + ROWS * M2;        // [ROWS][K]
  float* s_gi = s_gr + ROWS * K;
  float* dz_r = s_gi + ROWS * K;         // [ROWS][P]
  float* dz_i = dz_r + ROWS * P;

  const int row0 = blockIdx.x * ROWS;
  const int nrows = min(ROWS, rows - row0);
  for (int idx = threadIdx.x; idx < nrows * M1; idx += blockDim.x) {
    s_ar[idx] = a_r[(size_t)row0 * M1 + idx];
    s_ai[idx] = a_i[(size_t)row0 * M1 + idx];
  }
  for (int idx = threadIdx.x; idx < nrows * M2; idx += blockDim.x) {
    s_br[idx] = b_r[(size_t)row0 * M2 + idx];
    s_bi[idx] = b_i[(size_t)row0 * M2 + idx];
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

  // one thread per (row, m) of da, then per (row, n) of db
  const int n_a = nrows * M1;
  for (int idx = threadIdx.x; idx < n_a + nrows * M2; idx += blockDim.x) {
    float acc_r = 0.f, acc_i = 0.f;
    if (idx < n_a) {
      const int r = idx / M1;
      const int m = idx - r * M1;
      const float* zr = dz_r + r * P + m * M2;
      const float* zi = dz_i + r * P + m * M2;
      const float* br = s_br + r * M2;
      const float* bi = s_bi + r * M2;
      for (int n = 0; n < M2; ++n) {
        acc_r += zr[n] * br[n] + zi[n] * bi[n];
        acc_i += zi[n] * br[n] - zr[n] * bi[n];
      }
      da_r[(size_t)row0 * M1 + idx] = acc_r;
      da_i[(size_t)row0 * M1 + idx] = acc_i;
    } else {
      const int j = idx - n_a;
      const int r = j / M2;
      const int n = j - r * M2;
      const float* zr = dz_r + r * P + n;
      const float* zi = dz_i + r * P + n;
      const float* ar = s_ar + r * M1;
      const float* ai = s_ai + r * M1;
      for (int m = 0; m < M1; ++m) {
        acc_r += zr[m * M2] * ar[m] + zi[m * M2] * ai[m];
        acc_i += zi[m * M2] * ar[m] - zr[m * M2] * ai[m];
      }
      db_r[(size_t)row0 * M2 + j] = acc_r;
      db_i[(size_t)row0 * M2 + j] = acc_i;
    }
  }
}

}  // namespace

extern "C" size_t cg_product_bwd_smem_bytes(int M1, int M2, int K) {
  return sizeof(float) * 2 * (size_t)ROWS * (M1 + M2 + K + M1 * M2);
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int cg_product_bwd_f32(
    const float* a_r, const float* a_i, const float* b_r, const float* b_i,
    const float* g_r, const float* g_i, const int* rowptr, const int* col,
    const float* coef, float* da_r, float* da_i, float* db_r, float* db_i,
    int rows, int M1, int M2, int K, void* stream) {
  const size_t smem = cg_product_bwd_smem_bytes(M1, M2, K);
  cudaError_t err = cudaFuncSetAttribute(
      cg_product_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (rows > 0) {
    const int blocks = (rows + ROWS - 1) / ROWS;
    cg_product_bwd_kernel<<<blocks, 256, smem, (cudaStream_t)stream>>>(
        a_r, a_i, b_r, b_i, g_r, g_i, rowptr, col, coef, da_r, da_i, db_r,
        db_i, rows, M1, M2, K);
  }
  return (int)cudaGetLastError();
}
