// Fused edge build + neighbourhood CG aggregate, f32, for Hopper (sm_90a).
//
//   out[b,i,t,k] = sum_{(m,n)} C[(m,n),k] * z[b,i,t,m,n]
//   z[b,i,t,m,n] = sum_j rad[b,i,j,t,l(m)] * Y[b,i,j,m] * q[b,j,t,n]
//
// complex Y, q, z and out with real and imaginary parts in separate arrays
// (Y arrives stacked as [..., M1, 2]); C is real.
//
// Replaces molgym_tpu/ops/pallas_agg.py:_grouped_fwd_kernel (the grouped
// strategy) and :_fwd_kernel with n_j = N (the row fallback): both compute
// this function, so one kernel serves every batch size.
//
// Bound on the H100 at the SF6 shapes (B = 140, N = 7, tau = 10, M1 = 25,
// M2 = 25, K = 375): the kernel must read about 4.7 MB (Y, rad, q) and write
// 29.4 MB (out), about 10 us at 3.35 TB/s, and do about 0.34 GFLOP for z plus
// 0.06 GFLOP for the sparse contraction, about 6 us at the 67 TFLOP/s f32
// rate outside the tensor cores. It is bound by bytes, mostly the write of
// out, with operations close behind.
//
// Design: one block per (b, i). The block builds the edge rep e = rad * Y
// and stages q for the whole neighbourhood in shared memory, forms
// z[t, (m, n)] in shared memory (10 x 625 complex at SF6, 50 KB), and
// contracts z against the CG table given as compressed sparse columns: the
// dense [625, 375] table is more than 99% zeros (1,396 nonzeros), so the
// kernel reads only those (from L2, where the 11 KB of them stay resident). Neither
// the edge tensor nor z ever reaches device memory; out is written once,
// coalesced along k. The column order of the sparse table is the output
// order, so the dense order and the l1-grouped permuted order of the JAX
// kernel both come out of the same code. No tensor cores: the work is
// small next to the output write, and a wgmma version is later work.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int l_of_m(int m) {
  int l = 0;
  while ((l + 1) * (l + 1) <= m) ++l;
  return l;
}

__global__ void cg_aggregate_edge_kernel(
    const float* __restrict__ sph,     // [B, N, N, M1, 2]
    const float* __restrict__ rad,     // [B, N, N, T, L]
    const float* __restrict__ q_r,     // [B, N, T, M2]
    const float* __restrict__ q_i,     // [B, N, T, M2]
    const int* __restrict__ colptr,    // [K + 1]
    const int* __restrict__ pair_of,   // [nnz] pair p = m * M2 + n
    const float* __restrict__ coef,    // [nnz]
    float* __restrict__ out_r,         // [B, N, T, K]
    float* __restrict__ out_i,         // [B, N, T, K]
    int N, int T, int L, int M1, int M2, int K) {
  extern __shared__ float smem[];
  const int P = M1 * M2;
  float* e_r = smem;                   // [N][T][M1]
  float* e_i = e_r + N * T * M1;
  float* s_qr = e_i + N * T * M1;      // [N][T][M2]
  float* s_qi = s_qr + N * T * M2;
  float* z_r = s_qi + N * T * M2;      // [T][P]
  float* z_i = z_r + T * P;

  const int bi = blockIdx.x;           // b * N + i
  const int b = bi / N;
  const float* sph_bi = sph + (size_t)bi * N * M1 * 2;
  const float* rad_bi = rad + (size_t)bi * N * T * L;
  const float* qr_b = q_r + (size_t)b * N * T * M2;
  const float* qi_b = q_i + (size_t)b * N * T * M2;

  for (int idx = threadIdx.x; idx < N * T * M1; idx += blockDim.x) {
    const int m = idx % M1;
    const int jt = idx / M1;           // j * T + t
    const int j = jt / T;
    const float r = rad_bi[jt * L + l_of_m(m)];
    e_r[idx] = r * sph_bi[(j * M1 + m) * 2];
    e_i[idx] = r * sph_bi[(j * M1 + m) * 2 + 1];
  }
  for (int idx = threadIdx.x; idx < N * T * M2; idx += blockDim.x) {
    s_qr[idx] = qr_b[idx];
    s_qi[idx] = qi_b[idx];
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < T * P; idx += blockDim.x) {
    const int t = idx / P;
    const int p = idx - t * P;
    const int m = p / M2;
    const int n = p - m * M2;
    float zr = 0.f, zi = 0.f;
    for (int j = 0; j < N; ++j) {
      const int jt = j * T + t;
      const float er = e_r[jt * M1 + m], ei = e_i[jt * M1 + m];
      const float qr = s_qr[jt * M2 + n], qi = s_qi[jt * M2 + n];
      zr += er * qr - ei * qi;
      zi += er * qi + ei * qr;
    }
    z_r[idx] = zr;
    z_i[idx] = zi;
  }
  __syncthreads();

  float* o_r = out_r + (size_t)bi * T * K;
  float* o_i = out_i + (size_t)bi * T * K;
  for (int idx = threadIdx.x; idx < T * K; idx += blockDim.x) {
    const int t = idx / K;
    const int k = idx - t * K;
    const float* zr_t = z_r + t * P;
    const float* zi_t = z_i + t * P;
    float acc_r = 0.f, acc_i = 0.f;
    const int end = __ldg(colptr + k + 1);
    for (int e = __ldg(colptr + k); e < end; ++e) {
      const int p = __ldg(pair_of + e);
      const float c = __ldg(coef + e);
      acc_r += c * zr_t[p];
      acc_i += c * zi_t[p];
    }
    o_r[idx] = acc_r;
    o_i[idx] = acc_i;
  }
}

}  // namespace

extern "C" size_t cg_aggregate_smem_bytes(int N, int T, int M1, int M2) {
  return sizeof(float) *
         (2 * (size_t)N * T * M1 + 2 * (size_t)N * T * M2 + 2 * (size_t)T * M1 * M2);
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int cg_aggregate_edge_fused_f32(
    const float* sph, const float* rad, const float* q_r, const float* q_i,
    const int* colptr, const int* pair_of, const float* coef,
    float* out_r, float* out_i,
    int B, int N, int T, int L, int M1, int M2, int K, void* stream) {
  const size_t smem = cg_aggregate_smem_bytes(N, T, M1, M2);
  cudaError_t err = cudaFuncSetAttribute(
      cg_aggregate_edge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (B * N > 0) {
    cg_aggregate_edge_kernel<<<B * N, 256, smem, (cudaStream_t)stream>>>(
        sph, rad, q_r, q_i, colptr, pair_of, coef, out_r, out_i,
        N, T, L, M1, M2, K);
  }
  return (int)cudaGetLastError();
}
