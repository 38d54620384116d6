// Backward (vector-Jacobian product) of the fused edge build + CG aggregate
// of cg_aggregate.cu, f32, for Hopper (sm_90a). Given the output gradients
// g[b,i,t,k] (real and imaginary parts separate):
//
//   dz[b,i,t,(m,n)] = sum_k C[(m,n),k] g[b,i,t,k]
//   de[b,i,j,t,m]   = sum_n dz[b,i,t,m,n] conj(q[b,j,t,n])
//   drad[b,i,j,t,l] = sum_{m in l} Re(de[b,i,j,t,m] conj(Y[b,i,j,m]))
//   dq[b,j,t,n]     = sum_{i,m} dz[b,i,t,m,n] conj(e[b,i,j,t,m])
//
// with e = rad[l(m)] * Y rebuilt from the inputs (nothing of the forward is
// kept). The spherical harmonics Y get no gradient.
//
// Replaces molgym_tpu/ops/pallas_agg.py:_grouped_bwd_kernel (the grouped
// strategy) and :_bwd_kernel with n_j = N (the row fallback).
//
// Bound on the H100 at the SF6 shapes (B = 140, N = 7, tau = 10, M1 = 25,
// M2 = 25, K = 375): the kernel must read g (29.4 MB) and Y, rad, q
// (4.7 MB) and write drad (1.4 MB) and dq (2.0 MB), about 11 us at
// 3.35 TB/s; it does about 0.34 GFLOP for de and as much for dq, plus the
// sparse transposed contraction, about 11 us at the 67 TFLOP/s f32 rate
// outside the tensor cores. Bytes and operations are about even.
//
// Design: one block per (b, t). The channel t is a batch axis of this
// function: dq[b, :, t, :] sums over i and m only, so the block that holds
// every (i, j) of one (b, t) owns its slice of dq outright. The sum over i
// that the TPU kernel did with a transposed selection matmul is a loop
// inside the block: no atomics, no second pass, the same bits every run,
// and B * tau = 1,400 blocks at SF6. The block stages g[b, :, t, :] and
// q[b, :, t, :], forms dz in shared memory (7 x 625 complex at SF6) from
// the CG table given as compressed sparse rows (the transpose of the
// forward's columns, in the same permuted K order), and builds Y and e for
// all 49 (i, j). No tensor cores; the work is small.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int l_of_m(int m) {
  int l = 0;
  while ((l + 1) * (l + 1) <= m) ++l;
  return l;
}

__global__ void cg_aggregate_bwd_kernel(
    const float* __restrict__ sph,     // [B, N, N, M1, 2]
    const float* __restrict__ rad,     // [B, N, N, T, L]
    const float* __restrict__ q_r,     // [B, N, T, M2]
    const float* __restrict__ q_i,     // [B, N, T, M2]
    const float* __restrict__ g_r,     // [B, N, T, K]
    const float* __restrict__ g_i,     // [B, N, T, K]
    const int* __restrict__ rowptr,    // [P + 1], P = M1 * M2
    const int* __restrict__ col,       // [nnz] output column k
    const float* __restrict__ coef,    // [nnz]
    float* __restrict__ drad,          // [B, N, N, T, L]
    float* __restrict__ dq_r,          // [B, N, T, M2]
    float* __restrict__ dq_i,          // [B, N, T, M2]
    int N, int T, int L, int M1, int M2, int K) {
  extern __shared__ float smem[];
  const int P = M1 * M2;
  const int NN = N * N;
  float* s_gr = smem;                  // [N][K]
  float* s_gi = s_gr + N * K;
  float* dz_r = s_gi + N * K;          // [N][P]
  float* dz_i = dz_r + N * P;
  float* y_r = dz_i + N * P;           // [N * N][M1]
  float* y_i = y_r + NN * M1;
  float* e_r = y_i + NN * M1;          // [N * N][M1]
  float* e_i = e_r + NN * M1;
  float* term = e_i + NN * M1;         // [N * N][M1]
  float* s_qr = term + NN * M1;        // [N][M2]
  float* s_qi = s_qr + N * M2;

  const int bt = blockIdx.x;           // b * T + t
  const int b = bt / T;
  const int t = bt - b * T;

  for (int idx = threadIdx.x; idx < N * K; idx += blockDim.x) {
    const int i = idx / K;
    const size_t src = ((size_t)(b * N + i) * T + t) * K + (idx - i * K);
    s_gr[idx] = g_r[src];
    s_gi[idx] = g_i[src];
  }
  for (int idx = threadIdx.x; idx < N * M2; idx += blockDim.x) {
    const int j = idx / M2;
    const size_t src = ((size_t)(b * N + j) * T + t) * M2 + (idx - j * M2);
    s_qr[idx] = q_r[src];
    s_qi[idx] = q_i[src];
  }
  for (int idx = threadIdx.x; idx < NN * M1; idx += blockDim.x) {
    const int ij = idx / M1;
    const int m = idx - ij * M1;
    const size_t e = (size_t)b * NN + ij;
    const float yr = sph[(e * M1 + m) * 2];
    const float yi = sph[(e * M1 + m) * 2 + 1];
    const float r = rad[(e * T + t) * L + l_of_m(m)];
    y_r[idx] = yr;
    y_i[idx] = yi;
    e_r[idx] = r * yr;
    e_i[idx] = r * yi;
  }
  __syncthreads();

  // dz[i, p] = sum_k C[p, k] g[i, k]
  for (int idx = threadIdx.x; idx < N * P; idx += blockDim.x) {
    const int i = idx / P;
    const int p = idx - i * P;
    const float* gr = s_gr + i * K;
    const float* gi = s_gi + i * K;
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

  // per (i, j, m): de = sum_n dz[i, (m, n)] conj(q[j, n]), kept as its
  // radial term Re(de conj(Y)), summed over the m of each l below
  for (int idx = threadIdx.x; idx < NN * M1; idx += blockDim.x) {
    const int ij = idx / M1;
    const int m = idx - ij * M1;
    const int i = ij / N;
    const int j = ij - i * N;
    const float* zr = dz_r + i * P + m * M2;
    const float* zi = dz_i + i * P + m * M2;
    const float* qr = s_qr + j * M2;
    const float* qi = s_qi + j * M2;
    float de_r = 0.f, de_i = 0.f;
    for (int n = 0; n < M2; ++n) {
      de_r += zr[n] * qr[n] + zi[n] * qi[n];
      de_i += zi[n] * qr[n] - zr[n] * qi[n];
    }
    term[idx] = de_r * y_r[idx] + de_i * y_i[idx];
  }
  // per (j, n): dq = sum_{i, m} dz[i, (m, n)] conj(e[i, j, m])
  for (int idx = threadIdx.x; idx < N * M2; idx += blockDim.x) {
    const int j = idx / M2;
    const int n = idx - j * M2;
    float acc_r = 0.f, acc_i = 0.f;
    for (int i = 0; i < N; ++i) {
      const float* er = e_r + (i * N + j) * M1;
      const float* ei = e_i + (i * N + j) * M1;
      const float* zr = dz_r + i * P + n;
      const float* zi = dz_i + i * P + n;
      for (int m = 0; m < M1; ++m) {
        const float a = zr[m * M2], c = zi[m * M2];
        acc_r += a * er[m] + c * ei[m];
        acc_i += c * er[m] - a * ei[m];
      }
    }
    const size_t dst = ((size_t)(b * N + j) * T + t) * M2 + n;
    dq_r[dst] = acc_r;
    dq_i[dst] = acc_i;
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < NN * L; idx += blockDim.x) {
    const int ij = idx / L;
    const int l = idx - ij * L;
    float s = 0.f;
    for (int m = l * l; m < (l + 1) * (l + 1); ++m) s += term[ij * M1 + m];
    drad[(((size_t)b * NN + ij) * T + t) * L + l] = s;
  }
}

}  // namespace

extern "C" size_t cg_aggregate_bwd_smem_bytes(int N, int M1, int M2, int K) {
  return sizeof(float) * (2 * (size_t)N * K + 2 * (size_t)N * M1 * M2 +
                          5 * (size_t)N * N * M1 + 2 * (size_t)N * M2);
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int cg_aggregate_bwd_f32(
    const float* sph, const float* rad, const float* q_r, const float* q_i,
    const float* g_r, const float* g_i, const int* rowptr, const int* col,
    const float* coef, float* drad, float* dq_r, float* dq_i,
    int B, int N, int T, int L, int M1, int M2, int K, void* stream) {
  const size_t smem = cg_aggregate_bwd_smem_bytes(N, M1, M2, K);
  cudaError_t err = cudaFuncSetAttribute(
      cg_aggregate_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (B * T > 0) {
    cg_aggregate_bwd_kernel<<<B * T, 256, smem, (cudaStream_t)stream>>>(
        sph, rad, q_r, q_i, g_r, g_i, rowptr, col, coef, drad, dq_r, dq_i,
        N, T, L, M1, M2, K);
  }
  return (int)cudaGetLastError();
}
