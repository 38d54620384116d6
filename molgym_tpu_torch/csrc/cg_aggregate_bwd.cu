// Backward (vector-Jacobian product) of the fused edge build + CG aggregate
// of cg_aggregate.cu for Hopper (sm_90a), f32 or bf16 operands, f32
// accumulation. Given the output
// gradients g[b,i,t,k] (real and imaginary parts separate):
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
// M2 = 25, K = 375): g (29.4 MB) and Y, rad, q (4.7 MB) read, drad (1.4 MB)
// and dq (2.0 MB) written, about 11 us at 3.35 TB/s; about 0.34 GFLOP for de
// and as much for dq plus the sparse transposed contraction, about 11 us at
// the 67 TFLOP/s f32 rate outside the tensor cores. Bytes and operations are
// about even; f32 operands (the 1e-4 parity with the plain version), so no
// tensor cores.
//
// One block per (b, t), as before: the channel t is a batch axis, and
// dq[b, :, t, :] sums over i and m only, so the block that sees every (i, j)
// of one (b, t) owns its slice of dq outright: no atomics, no second pass,
// and the order of every sum is fixed by the code, so two runs give the same
// bits. What held the first version back (82 KB of shared memory with g and
// dz of all i resident at once; dq summed by N * M2 threads, 7 or 10 of 256
// at level 0, through N * M1 dependent steps; the table walked through
// rowptr -> entry -> g from L2) and what this design does about each:
//
//  * Rows i in steps. The block holds g, Y, rad, e and dz of NI rows i at a
//    time (ops/fused_agg.py:aggregate_bwd_plan): all N at level 0, where
//    they take 29-37 KB and one round trip to memory serves the whole
//    (b, t); one row (SF6) or three (M = 16) at the upper levels, in two
//    buffers, cp.async bringing in the next rows while these are worked on,
//    so that shared memory is 32-35 KB and six blocks fit an SM. The copies
//    are 16 bytes wide from the 16-byte line that holds a row's first value.
//    Blocks are persistent (a grid-stride walk over (b, t)) and stage the
//    table once.
//  * dq by every thread. A thread owns dq[j, a strip of NS slots n] for a
//    CHUNK of m, accumulates it in registers over all i, and at the end the
//    mc lanes that share an output add their chunks by a __shfl_xor tree.
//    de likewise: a thread owns de[j, a strip of MS slots m] for a chunk of
//    n, the nc lanes are added by the same tree, and Re(de conj(Y)) goes to
//    a small buffer from which one thread per (i, j, l) sums its 2l + 1
//    terms while the other threads already form the next dz. mc and nc are
//    powers of two chosen on the host; at level 0 (M2 = 1) dq has N outputs
//    and 16 lanes work on each.
//  * Bank conflicts. The strips are strided (n = s + x * M2 / NS), so that
//    neighbouring lanes read neighbouring words of dz, and the rows of dz
//    are padded to the length for which the host counts the fewest passes
//    (fused_agg.dz_conflicts: 28 slots at M2 = 25, 17 at 16). At M = 16
//    this took the kernel from 0.125 to 0.099 ms (every load was 4-way).
//  * The table as in the forward: 8-byte (column, coefficient) words, the rows
//    sorted by length and padded to the longest of each group of 32
//    (fused_agg.warp_padded, 5% padding at SF6), in shared memory; a lane
//    scatters its dz into the row `row_of` names.
//  * drad is written in the L-float pieces its [B, N, N, T, L] layout gives a
//    (b, t) block (20 bytes at a stride of T * L floats): 1.4 MB in all,
//    and the stores leave the block without waiting.
//
// Operands, cotangents and outputs are f32, or all bf16 (operand.cuh). f32
// operands reach shared memory as raw bytes (cp.async, 16 bytes from the line
// that holds a row's first value); bf16 ones are converted to f32 value by
// value as they are staged (2-byte loads, aligned at any offset: a bf16 row of
// g or Y may start on any even byte) and lie at the start of their buffers.
// So the shared-memory layout (ops/fused_agg.py:aggregate_bwd_smem), the plan
// and every sum, in the same fixed order, are the same for both, and each
// output is rounded once. The bf16 staging is a plain load: it does not
// overlap the work of the rows before as cp.async does. With bf16 the bytes
// halve (about 5.5 us at SF6) and the operations bound the kernel.
//
// Measured on an NVIDIA H100 80GB HBM3 (700 W), CUDA-graph replay, B = 140
// (molgym_tpu_torch/bench_encoder.py): SF6 levels 1-2 0.140 ms (first
// version 0.173), level 0 0.028 (0.034); M = 16, N = 10: 0.092 (0.157) and
// 0.034 (0.041). Tried and dropped, each by the same measurement: a thread
// tile over two neighbours j (fewer loads of dz, more shuffles: no faster),
// more or fewer blocks per SM (3 to 7: within 15%), 4-byte against 16-byte
// copies (the same). clock64 stamps give, per row i of an SF6 level 1-2
// block, dz : dq : de : staging as about 2.5 : 1.2 : 2.1 : 1.7 thousand
// cycles even when the block has its SM alone: chains of dependent
// shared-memory loads, so the kernel is bound by latency inside a block and
// by shared-memory traffic across blocks, not by device memory.
// PERF.md, section 6, has every shape.
#include <cuda_runtime.h>

#include <array>
#include <map>
#include <mutex>

#include "operand.cuh"

namespace {

using operand::cp_async_16;
using operand::cp_async_wait_all;
using operand::from_f32;
using operand::lead_floats;
using operand::stage_row;
using operand::stage_value;
using operand::to_f32;

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 192;       // a block's most
constexpr int kMinBlocks = 6;       // per SM: caps a thread at 56 registers

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) / 16 * 16; }

// floats a shared row of k values takes with the slack of its 16-byte copy
__host__ __device__ inline int padded_row(int k) { return ((k + 3) / 4 + 1) * 4; }

template <typename In, int NS, int MS>
__global__ void __launch_bounds__(kThreads, kMinBlocks) cg_aggregate_bwd_kernel(
    const In* __restrict__ sph,        // [B, N, N, M1, 2]
    const In* __restrict__ rad,        // [B, N, N, T, L]
    const In* __restrict__ q_r,        // [B, N, T, M2]
    const In* __restrict__ q_i,        // [B, N, T, M2]
    const In* __restrict__ g_r,        // [B, N, T, K]
    const In* __restrict__ g_i,        // [B, N, T, K]
    const int* __restrict__ grp_ptr,   // [G + 1] entry offset of each group
    const int* __restrict__ row_of,    // [32 G] (m << 16 | n) of each slot, or -1
    const int2* __restrict__ ent,      // [n_ent] (column k, coef bits)
    In* __restrict__ drad,             // [B, N, N, T, L]
    In* __restrict__ dq_r,             // [B, N, T, M2]
    In* __restrict__ dq_i,             // [B, N, T, M2]
    int n_work, int N, int T, int L, int M1, int M2, int K, int G, int n_ent,
    int NI, int M2P, int MC, int m_chunk, int NC, int n_chunk) {
  extern __shared__ float4 smem4[];
  const int P = M1 * M2P;              // dz rows are padded to M2P slots
  const int NM = N * M1;
  const int n_steps = (N + NI - 1) / NI;
  const int n_buf = n_steps > 1 ? 2 : 1;
  char* base = reinterpret_cast<char*>(smem4);
  int2* s_ent = reinterpret_cast<int2*>(base);
  base += align16(sizeof(int2) * n_ent);
  const int KP = padded_row(K);        // a row of g and the slack of its copy
  const size_t g_buf = sizeof(float) * NI * 2 * KP;
  float* s_g = reinterpret_cast<float*>(base);        // [n_buf][NI][g_r KP | g_i KP]
  base += n_buf * g_buf;
  const size_t y_buf = align16(sizeof(float2) * (NI * NM + 2));
  float2* s_y = reinterpret_cast<float2*>(base);      // [n_buf][NI][N][M1] + slack
  base += n_buf * y_buf;
  const size_t r_buf = align16(sizeof(float) * NI * N * L);
  float* s_rad = reinterpret_cast<float*>(base);      // [n_buf][NI][N][L]
  base += n_buf * r_buf;
  float2* s_e = reinterpret_cast<float2*>(base);      // [NI][N][M1]
  base += align16(sizeof(float2) * NI * NM);
  float2* s_dz = reinterpret_cast<float2*>(base);     // [NI][M1][M2P]
  base += align16(sizeof(float2) * NI * P);
  float2* s_q = reinterpret_cast<float2*>(base);      // [N][M2]
  base += align16(sizeof(float2) * N * M2);
  float* s_term = reinterpret_cast<float*>(base);     // [NI][N][M1]
  base += align16(sizeof(float) * NI * NM);
  int* s_ptr = reinterpret_cast<int*>(base);          // [G + 1]
  base += align16(sizeof(int) * (G + 1));
  int* s_row = reinterpret_cast<int*>(base);          // [32 G]
  base += align16(sizeof(int) * kWarp * G);
  int* s_l = reinterpret_cast<int*>(base);            // [M1] l of m

  const int tid = threadIdx.x;
  const int lane = tid & (kWarp - 1);
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;

  // once per block: the table (asynchronously), offsets, rows, l of m; the
  // first barrier of the first (b, t) covers them
  for (int idx = tid; idx < n_ent / 2; idx += blockDim.x)
    cp_async_16(s_ent + 2 * idx, ent + 2 * idx);
  for (int idx = tid; idx <= G; idx += blockDim.x) s_ptr[idx] = grp_ptr[idx];
  for (int idx = tid; idx < kWarp * G; idx += blockDim.x) s_row[idx] = row_of[idx];
  for (int m = tid; m < M1; m += blockDim.x) {
    int l = 0;
    while ((l + 1) * (l + 1) <= m) ++l;
    s_l[m] = l;
  }

  // this thread's two roles, the same for every (b, t):
  //   dq[qj, n = qs + x SQ, x < NS] over m in [qm0, qm1)
  //   de[ej, m = es + x SE, x < MS] over n in [en0, en1)
  // (strided strips: neighbouring lanes read neighbouring words of dz)
  // strips per row: a strip wider than 1 is the n of an n * n rep (the host's
  // strip_of), so the strides of the strided strips are compile-time numbers
  const int SQ = NS == 1 ? M2 : NS, SE = MS == 1 ? M1 : MS;
  const int qc = tid % MC, q_row = tid / MC;
  const int qs = q_row % SQ, qj = q_row / SQ;
  const bool q_on = qj < N;
  const int qm0 = min(qc * m_chunk, M1), qm1 = min(qm0 + m_chunk, M1);
  // threads left over after one row's de outputs take further rows of the
  // step side by side (level 0: N * SE outputs a row, RP rows at a time)
  const int RP = max(1, min(NI, (int)blockDim.x / (N * SE * NC)));
  const int ec = tid % NC, e_row = tid / NC;
  const int es = e_row % SE, ej = (e_row / SE) % N, ei = e_row / (SE * N);
  const bool e_on = ei < RP;
  const int en0 = min(ec * n_chunk, M2), en1 = min(en0 + n_chunk, M2);

  for (int work = blockIdx.x; work < n_work; work += gridDim.x) {
    const int b = work / T;
    const int t = work - b * T;

    // copies of what rows i0 .. i0 + ni need (asynchronous for f32):
    // g[b, i, t, :], Y[b, i, :, :] and rad[b, i, :, t, :]
    auto prefetch = [&](int i0, int ni, int buf) {
      const size_t bi0 = (size_t)b * N + i0;
      // a row of g starts at any multiple of the operand's size and lies at
      // sg + lead_floats of its address (at most 3 floats of slack)
      float* sg = s_g + buf * (g_buf / sizeof(float));
      for (int ii = 0; ii < ni; ++ii) {
        stage_row(sg + ii * 2 * KP, g_r + ((bi0 + ii) * T + t) * K, K);
        stage_row(sg + ii * 2 * KP + KP, g_i + ((bi0 + ii) * T + t) * K, K);
      }
      // Y of the step's rows is one run of pairs (f32: 8-byte aligned, at
      // most 2 floats of slack)
      stage_row(reinterpret_cast<float*>(s_y + buf * (y_buf / sizeof(float2))),
                sph + bi0 * NM * 2, 2 * ni * NM);
      float* sr = s_rad + buf * (r_buf / sizeof(float));
      for (int row = tid; row < ni * N; row += blockDim.x) {  // (i - i0) * N + j
        const In* src = rad + ((bi0 * N + row) * T + t) * L;
        for (int l = 0; l < L; ++l) stage_value(sr + row * L + l, src + l);
      }
    };
    // drad[b, i0 + ii, j, t, l] for the ni rows whose radial terms are in
    // s_term, one thread per (ii, j, l)
    auto radial_sums = [&](int i0, int ni) {
      for (int idx = tid; idx < ni * N * L; idx += blockDim.x) {
        const int row = idx / L;       // ii * N + j
        const int l = idx - row * L;
        const float* term = s_term + row * M1;
        float s = 0.f;
        for (int m = l * l; m < (l + 1) * (l + 1); ++m) s += term[m];
        drad[((((size_t)b * N + i0) * N + row) * T + t) * L + l] = from_f32<In>(s);
      }
    };

    prefetch(0, min(NI, N), 0);
    // q[b, :, t, :]; the previous (b, t) is done with s_q (the barrier
    // before its last radial sums)
    for (int idx = tid; idx < N * M2; idx += blockDim.x) {
      const int j = idx / M2;
      const size_t src = (((size_t)b * N + j) * T + t) * M2 + (idx - j * M2);
      s_q[idx] = make_float2(to_f32(q_r[src]), to_f32(q_i[src]));
    }

    float acc_r[NS], acc_i[NS];        // this thread's share of dq
#pragma unroll
    for (int x = 0; x < NS; ++x) acc_r[x] = acc_i[x] = 0.f;

    for (int step = 0; step < n_steps; ++step) {
      const int i0 = step * NI;
      const int ni = min(NI, N - i0);
      const int buf = step & (n_buf - 1);
      cp_async_wait_all();
      __syncthreads();                 // these rows have landed; the last are done
      if (step + 1 < n_steps) prefetch(i0 + NI, min(NI, N - i0 - NI), buf ^ 1);
      const float* sg = s_g + buf * (g_buf / sizeof(float));
      const size_t bi0 = (size_t)b * N + i0;
      const float2* sy = s_y + buf * (y_buf / sizeof(float2)) +
                         lead_floats(sph + bi0 * NM * 2) / 2;
      const float* sr = s_rad + buf * (r_buf / sizeof(float));

      // dz[ii, p] = sum_k C[p, k] g[ii, k]: a warp per (row, group of 32 p)
      for (int item = warp; item < ni * G; item += n_warps) {
        const int ii = item / G;
        const int g = item - ii * G;
        const int first = s_ptr[g];
        const int trips = (s_ptr[g + 1] - first) >> 5;
        const int2* row = s_ent + first + lane;
        const float* gr = sg + ii * 2 * KP +
                          lead_floats(g_r + ((bi0 + ii) * T + t) * K);
        const float* gi = sg + ii * 2 * KP + KP +
                          lead_floats(g_i + ((bi0 + ii) * T + t) * K);
        float a_r = 0.f, a_i = 0.f;
        int e = 0;
        for (; e + 2 <= trips; e += 2) {   // two entries in flight
          const int2 v0 = row[e * kWarp];
          const int2 v1 = row[(e + 1) * kWarp];
          const float r0 = gr[v0.x], i0g = gi[v0.x];
          const float r1 = gr[v1.x], i1g = gi[v1.x];
          a_r += __int_as_float(v0.y) * r0;
          a_i += __int_as_float(v0.y) * i0g;
          a_r += __int_as_float(v1.y) * r1;
          a_i += __int_as_float(v1.y) * i1g;
        }
        if (e < trips) {
          const int2 v = row[e * kWarp];
          a_r += __int_as_float(v.y) * gr[v.x];
          a_i += __int_as_float(v.y) * gi[v.x];
        }
        const int mn = s_row[g * kWarp + lane];
        if (mn >= 0)
          s_dz[ii * P + (mn >> 16) * M2P + (mn & 0xffff)] = make_float2(a_r, a_i);
      }
      // e[ii, j, m] = rad[ii, j, l(m)] * Y[ii, j, m]
      for (int idx = tid; idx < ni * NM; idx += blockDim.x) {
        const int row = idx / M1;      // ii * N + j
        const float2 y = sy[idx];
        const float r = sr[row * L + s_l[idx - row * M1]];
        s_e[idx] = make_float2(r * y.x, r * y.y);
      }
      if (step > 0) radial_sums(i0 - NI, NI);
      __syncthreads();

      // dq[qj, strip] += sum_{ii, m in chunk} dz[ii, m, strip] conj(e[ii, qj, m])
      if (q_on) {
        for (int ii = 0; ii < ni; ++ii) {
          const float2* ep = s_e + (ii * N + qj) * M1;
          const float2* zp = s_dz + ii * P + qs;
          for (int m = qm0; m < qm1; ++m) {
            const float2 e = ep[m];
#pragma unroll
            for (int x = 0; x < NS; ++x) {
              const float2 zz = zp[m * M2P + x * SQ];
              acc_r[x] = fmaf(zz.x, e.x, fmaf(zz.y, e.y, acc_r[x]));
              acc_i[x] = fmaf(zz.y, e.x, fmaf(-zz.x, e.y, acc_i[x]));
            }
          }
        }
      }
      // de[ii, ej, strip] = sum_{n in chunk} dz[ii, strip, n] conj(q[ej, n]);
      // the nc lanes of one output are added, and its radial term stored
      for (int ii0 = 0; ii0 < ni; ii0 += RP) {
        const int ii = ii0 + ei;
        const bool on = e_on && ii < ni;
        float de_r[MS], de_i[MS];
#pragma unroll
        for (int x = 0; x < MS; ++x) de_r[x] = de_i[x] = 0.f;
        if (on) {
          const float2* zp = s_dz + ii * P + es * M2P;
          for (int n = en0; n < en1; ++n) {
            const float2 q = s_q[ej * M2 + n];
#pragma unroll
            for (int x = 0; x < MS; ++x) {
              const float2 zz = zp[x * SE * M2P + n];
              de_r[x] = fmaf(zz.x, q.x, fmaf(zz.y, q.y, de_r[x]));
              de_i[x] = fmaf(zz.y, q.x, fmaf(-zz.x, q.y, de_i[x]));
            }
          }
        }
        for (int off = 1; off < NC; off <<= 1) {
#pragma unroll
          for (int x = 0; x < MS; ++x) {
            de_r[x] += __shfl_xor_sync(kFull, de_r[x], off);
            de_i[x] += __shfl_xor_sync(kFull, de_i[x], off);
          }
        }
        if (on && ec == 0) {
#pragma unroll
          for (int x = 0; x < MS; ++x) {
            const int at = (ii * N + ej) * M1 + es + x * SE;
            const float2 y = sy[at];
            s_term[at] = de_r[x] * y.x + de_i[x] * y.y;
          }
        }
      }
    }
    __syncthreads();                   // the last rows' radial terms
    radial_sums((n_steps - 1) * NI, N - (n_steps - 1) * NI);
    // dq: add the mc lanes of each output in a fixed order, lane 0 writes
    for (int off = 1; off < MC; off <<= 1) {
#pragma unroll
      for (int x = 0; x < NS; ++x) {
        acc_r[x] += __shfl_xor_sync(kFull, acc_r[x], off);
        acc_i[x] += __shfl_xor_sync(kFull, acc_i[x], off);
      }
    }
    if (q_on && qc == 0) {
      const size_t dst = (((size_t)b * N + qj) * T + t) * M2 + qs;
#pragma unroll
      for (int x = 0; x < NS; ++x) {
        dq_r[dst + x * SQ] = from_f32<In>(acc_r[x]);
        dq_i[dst + x * SQ] = from_f32<In>(acc_i[x]);
      }
    }
  }
  cp_async_wait_all();                 // a block that got no (b, t)
}

template <typename In>
using Kernel = void (*)(const In*, const In*, const In*, const In*, const In*,
                        const In*, const int*, const int*, const int2*, In*, In*,
                        In*, int, int, int, int, int, int, int, int, int, int,
                        int, int, int, int, int);

template <int NS>
Kernel<float> kernel_for_ms(int ms) {
  switch (ms) {
    case 1: return cg_aggregate_bwd_kernel<float, NS, 1>;
    case 3: return cg_aggregate_bwd_kernel<float, NS, 3>;
    case 4: return cg_aggregate_bwd_kernel<float, NS, 4>;
    case 5: return cg_aggregate_bwd_kernel<float, NS, 5>;
    default: return nullptr;
  }
}

// f32: every pair of strips the host's strip_of can give
template <typename In>
Kernel<In> kernel_for(int ns, int ms);
template <>
Kernel<float> kernel_for<float>(int ns, int ms) {
  switch (ns) {
    case 1: return kernel_for_ms<1>(ms);
    case 3: return kernel_for_ms<3>(ms);
    case 4: return kernel_for_ms<4>(ms);
    case 5: return kernel_for_ms<5>(ms);
    default: return nullptr;
  }
}

// bf16: only the pairs the encoder gives, whose atom rep is one l (level 0,
// ns = 1) or as wide as the harmonics (ns = ms); the build's slowest file
// takes 7 more instantiations, not 16
template <int MS>
Kernel<__nv_bfloat16> kernel_bf16(int ns) {
  if (ns == 1) return cg_aggregate_bwd_kernel<__nv_bfloat16, 1, MS>;
  if (ns == MS) return cg_aggregate_bwd_kernel<__nv_bfloat16, MS, MS>;
  return nullptr;
}
template <>
Kernel<__nv_bfloat16> kernel_for<__nv_bfloat16>(int ns, int ms) {
  switch (ms) {
    case 1: return kernel_bf16<1>(ns);
    case 3: return kernel_bf16<3>(ns);
    case 4: return kernel_bf16<4>(ns);
    case 5: return kernel_bf16<5>(ns);
    default: return nullptr;
  }
}

int num_sms() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

bool power_of_two(int n) { return n > 0 && (n & (n - 1)) == 0; }

// Resident blocks per SM of the instantiation for operands `In` and strips
// of `ns` and `ms` on the current device; -1 for strips the kernel is not
// compiled for or a refused configuration. The runtime is asked once per
// (device, ns, ms, threads, smem) and operand type, and the kernel's limit of
// dynamic shared memory is only ever raised: a launch costs the host one look
// into the map.
template <typename In>
int blocks_per_sm(int ns, int ms, int threads, int smem) {
  static std::mutex mutex;
  static std::map<std::array<int, 5>, int> known;
  static std::map<std::array<int, 3>, int> limit;
  Kernel<In> kernel = kernel_for<In>(ns, ms);
  if (kernel == nullptr) return -1;
  int dev = 0;
  cudaGetDevice(&dev);
  std::lock_guard<std::mutex> lock(mutex);
  const std::array<int, 5> key = {dev, ns, ms, threads, smem};
  const auto found = known.find(key);
  if (found != known.end()) return found->second;
  int& allowed = limit[{dev, ns, ms}];
  if (smem > allowed) {
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem) != cudaSuccess)
      return -1;
    allowed = smem;
  }
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads,
                                                    smem) != cudaSuccess)
    return -1;
  known[key] = blocks;
  return blocks;
}

template <typename In>
int launch(const In* sph, const In* rad, const In* q_r, const In* q_i,
           const In* g_r, const In* g_i, const int* grp_ptr, const int* row_of,
           const int* ent, In* drad, In* dq_r, In* dq_i, int B, int N, int T,
           int L, int M1, int M2, int K, int G, int n_ent, int NI, int M2P,
           int ns, int ms, int mc, int nc, int threads, int smem, void* stream) {
  Kernel<In> kernel = kernel_for<In>(ns, ms);
  if (kernel == nullptr || (ns > 1 && M2 != ns * ns) ||
      (ms > 1 && M1 != ms * ms) || !power_of_two(mc) || !power_of_two(nc) ||
      mc > kWarp || nc > kWarp || n_ent % kWarp != 0 || threads % kWarp != 0 ||
      threads > kThreads || N * (M2 / ns) * mc > threads ||
      N * (M1 / ms) * nc > threads || NI < 1 || NI > N || M2P < M2 ||
      smem < 0)
    return (int)cudaErrorInvalidValue;
  const int per_sm = blocks_per_sm<In>(ns, ms, threads, smem);
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long n_work = (long long)B * T;
  if (n_work > 0) {
    const long long slots = (long long)per_sm * num_sms();
    const int grid = (int)(n_work < slots ? n_work : slots);
    kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
        sph, rad, q_r, q_i, g_r, g_i, grp_ptr, row_of,
        reinterpret_cast<const int2*>(ent), drad, dq_r, dq_i, (int)n_work, N, T,
        L, M1, M2, K, G, n_ent, NI, M2P, mc, (M1 + mc - 1) / mc, nc,
        (M2 + nc - 1) / nc);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cg_aggregate_bwd_blocks_per_sm(int ns, int ms, int threads,
                                              int smem) {
  return blocks_per_sm<float>(ns, ms, threads, smem);
}

// Launch on `stream` and return cudaGetLastError() (0 on success). A strip
// `ns` > 1 has M2 = ns * ns, a strip `ms` > 1 has M1 = ms * ms (bf16: ns is
// 1 or ms); `mc` and `nc` are powers of two of at most 32 with
// N * (M2 / ns) * mc and N * (M1 / ms) * nc at most `threads`; `NI` rows i a
// step, 1 <= NI <= N (all N at once in one buffer, or fewer in two buffers
// that take turns); dz rows of `M2P` >= M2 slots; `smem` is the block's
// shared memory, summed on the host over the arrays the kernel lays out
// (ops/fused_agg.py:aggregate_bwd_smem). Operands, cotangents and outputs are
// f32, or all bf16.
extern "C" int cg_aggregate_bwd_f32(
    const float* sph, const float* rad, const float* q_r, const float* q_i,
    const float* g_r, const float* g_i, const int* grp_ptr, const int* row_of,
    const int* ent, float* drad, float* dq_r, float* dq_i,
    int B, int N, int T, int L, int M1, int M2, int K, int G, int n_ent,
    int NI, int M2P, int ns, int ms, int mc, int nc, int threads, int smem,
    void* stream) {
  return launch(sph, rad, q_r, q_i, g_r, g_i, grp_ptr, row_of, ent, drad, dq_r,
                dq_i, B, N, T, L, M1, M2, K, G, n_ent, NI, M2P, ns, ms, mc, nc,
                threads, smem, stream);
}

extern "C" int cg_aggregate_bwd_bf16(
    const __nv_bfloat16* sph, const __nv_bfloat16* rad,
    const __nv_bfloat16* q_r, const __nv_bfloat16* q_i,
    const __nv_bfloat16* g_r, const __nv_bfloat16* g_i, const int* grp_ptr,
    const int* row_of, const int* ent, __nv_bfloat16* drad,
    __nv_bfloat16* dq_r, __nv_bfloat16* dq_i, int B, int N, int T, int L,
    int M1, int M2, int K, int G, int n_ent, int NI, int M2P, int ns, int ms,
    int mc, int nc, int threads, int smem, void* stream) {
  return launch(sph, rad, q_r, q_i, g_r, g_i, grp_ptr, row_of, ent, drad, dq_r,
                dq_i, B, N, T, L, M1, M2, K, G, n_ent, NI, M2P, ns, ms, mc, nc,
                threads, smem, stream);
}
