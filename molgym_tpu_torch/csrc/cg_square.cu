// CG self-product ("CG square") of a packed rep over a list of (m, n) pairs,
// f32, for Hopper (sm_90a).
//
//   z[r, p]   = a[r, m_p] * a[r, n_p]              (complex)
//   out[r, k] = sum_p C[p, k] * z[r, p]            (C real)
//
// with the rows r = (b, i, t) flattened and real and imaginary parts in
// separate arrays. With the tri fold (pairs m <= n, folded tables
// C[m,n] + C[n,m], columns grouped by lmin) this is the level's square.
//
// Replaces molgym_tpu/ops/pallas_agg.py:_fwd_kernel with n_j = 1 and a pair
// list (the tri fold reached through cg_square_fused_ri).
//
// Bound on the H100 at the SF6 shapes (rows = 140 * 7 * 10 = 9,800, M = 25,
// P = 325 tri pairs, K = 375): the kernel must read 2.0 MB (a) and write
// 29.4 MB (out), about 9.4 us at 3.35 TB/s; its arithmetic, 6 operations a
// pair plus 4 for each of the folded tables' 1,130 nonzeros, is 0.06 GFLOP, under 2 us
// at 67 TFLOP/s. It is bound by bytes: the write of out.
//
// Design: a block takes ROWS rows, stages a in shared memory, forms the P
// pair products in shared memory (8 x 325 complex, 21 KB) and contracts them
// against the table in compressed sparse columns (the folded tables are
// mostly zeros), writing each output row once, coalesced along k. The column
// order of the sparse table is the output order, so the lmin-major permuted
// K of the tri fold comes out directly.
#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 8;

__global__ void cg_square_kernel(
    const float* __restrict__ a_r,      // [rows, M]
    const float* __restrict__ a_i,      // [rows, M]
    const int* __restrict__ pair_m,     // [P]
    const int* __restrict__ pair_n,     // [P]
    const int* __restrict__ colptr,     // [K + 1]
    const int* __restrict__ pair_of,    // [nnz]
    const float* __restrict__ coef,     // [nnz]
    float* __restrict__ out_r,          // [rows, K]
    float* __restrict__ out_i,          // [rows, K]
    int rows, int M, int P, int K) {
  extern __shared__ float smem[];
  float* s_ar = smem;                   // [ROWS][M]
  float* s_ai = s_ar + ROWS * M;
  float* z_r = s_ai + ROWS * M;         // [ROWS][P]
  float* z_i = z_r + ROWS * P;

  const int row0 = blockIdx.x * ROWS;
  const int nrows = min(ROWS, rows - row0);
  const float* ar = a_r + (size_t)row0 * M;
  const float* ai = a_i + (size_t)row0 * M;
  for (int idx = threadIdx.x; idx < nrows * M; idx += blockDim.x) {
    s_ar[idx] = ar[idx];
    s_ai[idx] = ai[idx];
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < nrows * P; idx += blockDim.x) {
    const int r = idx / P;
    const int p = idx - r * P;
    const int m = __ldg(pair_m + p), n = __ldg(pair_n + p);
    const float xr = s_ar[r * M + m], xi = s_ai[r * M + m];
    const float yr = s_ar[r * M + n], yi = s_ai[r * M + n];
    z_r[idx] = xr * yr - xi * yi;
    z_i[idx] = xr * yi + xi * yr;
  }
  __syncthreads();

  float* o_r = out_r + (size_t)row0 * K;
  float* o_i = out_i + (size_t)row0 * K;
  for (int idx = threadIdx.x; idx < nrows * K; idx += blockDim.x) {
    const int r = idx / K;
    const int k = idx - r * K;
    const float* zr = z_r + r * P;
    const float* zi = z_i + r * P;
    float acc_r = 0.f, acc_i = 0.f;
    const int end = __ldg(colptr + k + 1);
    for (int e = __ldg(colptr + k); e < end; ++e) {
      const int p = __ldg(pair_of + e);
      const float c = __ldg(coef + e);
      acc_r += c * zr[p];
      acc_i += c * zi[p];
    }
    o_r[idx] = acc_r;
    o_i[idx] = acc_i;
  }
}

}  // namespace

extern "C" size_t cg_square_smem_bytes(int M, int P) {
  return sizeof(float) * 2 * (size_t)ROWS * (M + P);
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int cg_square_fused_f32(
    const float* a_r, const float* a_i, const int* pair_m, const int* pair_n,
    const int* colptr, const int* pair_of, const float* coef,
    float* out_r, float* out_i, int rows, int M, int P, int K, void* stream) {
  const size_t smem = cg_square_smem_bytes(M, P);
  cudaError_t err = cudaFuncSetAttribute(
      cg_square_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (rows > 0) {
    const int blocks = (rows + ROWS - 1) / ROWS;
    cg_square_kernel<<<blocks, 256, smem, (cudaStream_t)stream>>>(
        a_r, a_i, pair_m, pair_n, colptr, pair_of, coef, out_r, out_i,
        rows, M, P, K);
  }
  return (int)cudaGetLastError();
}
