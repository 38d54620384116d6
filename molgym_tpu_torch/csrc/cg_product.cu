// Channel-wise CG product of two packed reps, f32, for Hopper (sm_90a).
//
//   out[r, k] = sum_{m,n} C[m*M2 + n, k] * a[r, m] * b[r, n]     (complex a, b;
//                                                                  C real)
//
// with the rows r = (leading dims, tau) flattened and real and imaginary
// parts in separate arrays. It is the product the policy's mixer takes
// twice per forward: the distance rep (M1 = 1) with the focused atom's
// covariants, and that result with itself.
//
// Replaces molgym_tpu/ops/pallas_cg.py:_fwd_kernel. That kernel spreads a
// and b over the (m, n) pair axis with two 0/1 matrix products, because its
// compiler cannot reshape, and contracts with one dense [P, K] product
// against a table that is 99 % zeros. Here a thread forms the pair products
// it needs in registers and walks only the table's nonzeros.
//
// Bound on the H100 at the SF6 shapes (rows = 140 * 4 = 560, M1 = M2 = 25,
// K = 375, 1,396 nonzeros): the kernel must read 0.22 MB (a, b) and the
// table (17 KB) and write 1.68 MB (out), about 0.6 us at 3.35 TB/s; its
// arithmetic, 10 operations a nonzero and row, is 0.008 GFLOP, 0.1 us at
// 67 TFLOP/s. It is bound by bytes, the write of out, and the bound lies
// below the time of one launch.
//
// Design: a block takes ROWS rows and stages their a and b in shared
// memory; one thread per output (r, k) walks column k of the table in
// compressed sparse columns, each entry with its (m, n) and coefficient,
// and writes its output once, coalesced along k. The columns are in the
// dense K order of the table.
#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 4;

__global__ void cg_product_kernel(
    const float* __restrict__ a_r,      // [rows, M1]
    const float* __restrict__ a_i,      // [rows, M1]
    const float* __restrict__ b_r,      // [rows, M2]
    const float* __restrict__ b_i,      // [rows, M2]
    const int* __restrict__ colptr,     // [K + 1]
    const int* __restrict__ ent_m,      // [nnz] m of the entry
    const int* __restrict__ ent_n,      // [nnz] n of the entry
    const float* __restrict__ coef,     // [nnz]
    float* __restrict__ out_r,          // [rows, K]
    float* __restrict__ out_i,          // [rows, K]
    int rows, int M1, int M2, int K) {
  extern __shared__ float smem[];
  float* s_ar = smem;                   // [ROWS][M1]
  float* s_ai = s_ar + ROWS * M1;
  float* s_br = s_ai + ROWS * M1;       // [ROWS][M2]
  float* s_bi = s_br + ROWS * M2;

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
  __syncthreads();

  float* o_r = out_r + (size_t)row0 * K;
  float* o_i = out_i + (size_t)row0 * K;
  for (int idx = threadIdx.x; idx < nrows * K; idx += blockDim.x) {
    const int r = idx / K;
    const int k = idx - r * K;
    const float* ar = s_ar + r * M1;
    const float* ai = s_ai + r * M1;
    const float* br = s_br + r * M2;
    const float* bi = s_bi + r * M2;
    float acc_r = 0.f, acc_i = 0.f;
    const int end = __ldg(colptr + k + 1);
    for (int e = __ldg(colptr + k); e < end; ++e) {
      const int m = __ldg(ent_m + e), n = __ldg(ent_n + e);
      const float c = __ldg(coef + e);
      const float xr = ar[m], xi = ai[m], yr = br[n], yi = bi[n];
      acc_r += c * (xr * yr - xi * yi);
      acc_i += c * (xr * yi + xi * yr);
    }
    o_r[idx] = acc_r;
    o_i[idx] = acc_i;
  }
}

}  // namespace

extern "C" size_t cg_product_smem_bytes(int M1, int M2) {
  return sizeof(float) * 2 * (size_t)ROWS * (M1 + M2);
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int cg_product_f32(
    const float* a_r, const float* a_i, const float* b_r, const float* b_i,
    const int* colptr, const int* ent_m, const int* ent_n, const float* coef,
    float* out_r, float* out_i, int rows, int M1, int M2, int K,
    void* stream) {
  const size_t smem = cg_product_smem_bytes(M1, M2);
  cudaError_t err = cudaFuncSetAttribute(
      cg_product_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (rows > 0) {
    const int blocks = (rows + ROWS - 1) / ROWS;
    cg_product_kernel<<<blocks, 256, smem, (cudaStream_t)stream>>>(
        a_r, a_i, b_r, b_i, colptr, ent_m, ent_n, coef, out_r, out_i,
        rows, M1, M2, K);
  }
  return (int)cudaGetLastError();
}
