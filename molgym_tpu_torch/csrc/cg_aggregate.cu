// Fused edge build + neighbourhood CG aggregate for Hopper (sm_90a), f32 or
// bf16 operands, f32 accumulation.
//
//   out[b,i,t,k] = sum_{(m,n)} C[(m,n),k] * z[b,i,t,m,n]
//   z[b,i,t,m,n] = sum_j rad[b,i,j,t,l(m)] * Y[b,i,j,m] * q[b,j,t,n]
//
// complex Y, q, z and out with real and imaginary parts in separate arrays
// (Y arrives stacked as [..., M1, 2]); C is real.
//
// Replaces molgym_tpu/ops/pallas_agg.py:_grouped_fwd_kernel (the grouped
// strategy) and :_fwd_kernel with n_j = N (the row fallback): both compute
// this function, so one kernel serves every batch size and both tables.
//
// Bound on the H100 at the SF6 shapes (B = 140, N = 7, tau = 10, M1 = 25,
// M2 = 25, K = 375): 4.7 MB read (Y, rad, q) and 29.4 MB written (out),
// about 10 us at 3.35 TB/s; 0.34 GFLOP for z plus 0.06 GFLOP for the sparse
// contraction, about 6 us at the 67 TFLOP/s f32 rate outside the tensor
// cores. Bound by bytes, mostly the write of out, with operations close
// behind; f32 operands, because TF32 or bf16 products would not hold the
// 1e-4 parity with the plain version, so no tensor cores. With bf16 operands
// and outputs the bytes halve (about 5 us) and the same f32 operations, about
// 6 us, bound it.
//
// What held the first version back (one block of 256 threads per (b, i),
// 78 KB of shared memory, z built with four shared loads per four FMAs, the
// table walked through colptr -> entry -> z from L2, a division or two for
// every element staged) and what this design does about each:
//
//  * Grid. The channel t is a batch axis of the whole function: e, q, z and
//    out are all indexed by it. A block takes one (b, i) and a TILE of
//    channels chosen on the host (ops/fused_agg.py:aggregate_fwd_tile: 2 at
//    SF6 levels 1-2, all 10 at level 0, fewer at small batches), so shared
//    memory falls to 17-36 KB, five to eight blocks fit an SM, and B = 10
//    still gives the card 350 blocks. Blocks are persistent: a block walks
//    over tiles with the grid's stride and stages the table once.
//  * Staging. A thread per (j, m) loads Y once and walks the tile's channels;
//    one division per thread and tile, none per element (the first redesign
//    spent as much of its time on index arithmetic here as on z).
//  * z in registers. A thread owns two neighbours m and a strip of NS slots n
//    (NS = 5 at M2 = 25, 4 at 16, 1 at 1): e[j, t, m] is one 8-byte load per
//    j, q a strip that the lanes of a warp share (a broadcast), 8 NS FMAs
//    per 2 + NS loads, written as fmaf so that each complex product is four
//    FMAs (a * b + c * d + acc compiles to a multiply, an FMA and an add).
//  * The table in shared memory, one load per entry. The host packs each
//    nonzero as one 8-byte (pair, coefficient) word and pads the columns of
//    each group of 32 to the group's longest (fused_agg.warp_padded), so a
//    warp reads one step of its 32 columns as 256 consecutive bytes, the
//    trip count is the warp's and no per-column pointer is in the chain; an
//    entry is loaded once for two channels. The copy into shared memory is
//    cp.async, overlapped with the staging of e and q. The padding costs
//    nothing a warp did not already pay: it waited for its longest column
//    before.
//
// `In` is the operand type of Y, rad, q and out, f32 or bf16 (operand.cuh):
// e and q are converted to f32 as they are staged, so the shared-memory
// layout (ops/fused_agg.py:aggregate_fwd_smem) and every sum are the same
// for both, and each output is rounded once. The bf16 version stages value
// by value (2-byte loads, aligned at any offset) and stores one value at a
// time; its outputs are half the bytes of the f32 version's.
//
// Measured on an NVIDIA H100 80GB HBM3 (700 W), CUDA-graph replay
// (molgym_tpu_torch/bench_encoder.py): SF6 levels 1-2 0.054 ms at B = 140
// (first version 0.127), 0.0065 at B = 10 (0.025); level 0 0.0099 (0.0149).
// clock64 stamps around the phases of a block give staging : z : table as
// 29 : 37 : 26 at SF6 levels 1-2, so no one phase is left to remove; the
// block is bound by shared-memory traffic and by how fast its warps can be
// scheduled, not by device memory.
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
using operand::to_f32;

constexpr int kWarp = 32;

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) / 16 * 16; }

template <typename In>
__device__ __forceinline__ float2 load_pair(const In* p) {
  return make_float2(to_f32(p[0]), to_f32(p[1]));
}
template <>
__device__ __forceinline__ float2 load_pair<float>(const float* p) {
  return *reinterpret_cast<const float2*>(p);   // [.., M1, 2]: 8-byte aligned
}

template <typename In, int NS>
__global__ void __launch_bounds__(256) cg_aggregate_edge_kernel(
    const In* __restrict__ sph,        // [B, N, N, M1, 2]
    const In* __restrict__ rad,        // [B, N, N, T, L]
    const In* __restrict__ q_r,        // [B, N, T, M2]
    const In* __restrict__ q_i,        // [B, N, T, M2]
    const int* __restrict__ grp_ptr,   // [G + 1] entry offset of each group
    const int2* __restrict__ ent,      // [n_ent] (pair m * M2 + n, coef bits)
    In* __restrict__ out_r,            // [B, N, T, K]
    In* __restrict__ out_i,            // [B, N, T, K]
    int n_work, int n_tiles, int N, int T, int TT, int L, int M1, int M2,
    int K, int G, int n_ent) {
  extern __shared__ float4 smem4[];
  const int P = M1 * M2;
  char* base = reinterpret_cast<char*>(smem4);
  int2* s_ent = reinterpret_cast<int2*>(base);
  base += align16(sizeof(int2) * n_ent);
  float2* s_z = reinterpret_cast<float2*>(base);      // [TT][M1][M2]
  base += align16(sizeof(float2) * TT * P);
  float2* s_e = reinterpret_cast<float2*>(base);      // [N][TT][M1]
  base += align16(sizeof(float2) * N * TT * M1);
  float2* s_q = reinterpret_cast<float2*>(base);      // [N][TT][M2]
  base += align16(sizeof(float2) * N * TT * M2);
  int* s_ptr = reinterpret_cast<int*>(base);          // [G + 1]

  const int tid = threadIdx.x;
  const int lane = tid & (kWarp - 1);
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;

  // once per block: the table (asynchronously) and the group offsets; the
  // barrier after the first tile's staging covers both
  for (int idx = tid; idx < n_ent / 2; idx += blockDim.x)
    cp_async_16(s_ent + 2 * idx, ent + 2 * idx);
  for (int idx = tid; idx <= G; idx += blockDim.x) s_ptr[idx] = grp_ptr[idx];

  const int S = M2 / NS;               // strips per m
  const int MP = (M1 + 1) / 2;         // pairs of neighbours m
  // this thread's z item of the first round, (tt, s, pair of m) with the
  // pair fastest: the same for every tile
  const int z_mp = tid % MP, z_s = (tid / MP) % S, z_tt = tid / (MP * S);

  for (int work = blockIdx.x; work < n_work; work += gridDim.x) {
    const int bi = work / n_tiles;     // b * N + i
    const int t0 = (work - bi * n_tiles) * TT;
    const int tn = min(TT, T - t0);    // channels of this tile
    const int b = bi / N;

    // e[j, tt, m] = rad[b, i, j, t0 + tt, l(m)] * Y[b, i, j, m]: a thread per
    // (j, m) loads Y once and walks the channels; q likewise per (j, n)
    const In* y_bi = sph + (size_t)bi * N * M1 * 2;
    const In* r_bi = rad + ((size_t)bi * N * T + t0) * L;
    for (int p = tid; p < N * M1; p += blockDim.x) {
      const int j = p / M1;
      const int m = p - j * M1;
      int l = 0;
      while ((l + 1) * (l + 1) <= m) ++l;
      const float2 yy = load_pair<In>(y_bi + 2 * p);
      const In* r = r_bi + j * T * L + l;
      float2* dst = s_e + j * TT * M1 + m;
#pragma unroll 2
      for (int tt = 0; tt < tn; ++tt) {
        const float rr = to_f32(r[tt * L]);
        dst[tt * M1] = make_float2(rr * yy.x, rr * yy.y);
      }
    }
    const In* qr_b = q_r + ((size_t)b * N * T + t0) * M2;
    const In* qi_b = q_i + ((size_t)b * N * T + t0) * M2;
    for (int p = tid; p < N * M2; p += blockDim.x) {
      const int j = p / M2;
      const int src = j * T * M2 + (p - j * M2);
      float2* dst = s_q + j * TT * M2 + (p - j * M2);
#pragma unroll 2
      for (int tt = 0; tt < tn; ++tt)
        dst[tt * M2] = make_float2(to_f32(qr_b[src + tt * M2]),
                                   to_f32(qi_b[src + tt * M2]));
    }
    cp_async_wait_all();               // the table, on the first tile
    __syncthreads();

    // z[tt, m, strip]: two neighbours m and NS slots n per thread (the odd
    // last m alone), the sum over j in registers: one load of q serves both
    const int n_items = tn * S * MP;
    for (int idx = tid; idx < n_items; idx += blockDim.x) {
      int mp = z_mp, s = z_s, tt = z_tt;
      if (idx != tid) {
        mp = idx % MP;
        s = (idx / MP) % S;
        tt = idx / (MP * S);
      }
      const int m = 2 * mp;
      const bool two = m + 1 < M1;
      const float2* ep = s_e + tt * M1 + m;
      const float2* fp = ep + (two ? 1 : 0);
      const float2* qp = s_q + tt * M2 + s * NS;
      float zr[NS], zi[NS], wr[NS], wi[NS];
#pragma unroll
      for (int x = 0; x < NS; ++x) zr[x] = zi[x] = wr[x] = wi[x] = 0.f;
      for (int j = 0; j < N; ++j) {
        const float2 e = ep[j * TT * M1];
        const float2 f = fp[j * TT * M1];
#pragma unroll
        for (int x = 0; x < NS; ++x) {
          const float2 q = qp[j * TT * M2 + x];
          zr[x] = fmaf(e.x, q.x, fmaf(-e.y, q.y, zr[x]));
          zi[x] = fmaf(e.x, q.y, fmaf(e.y, q.x, zi[x]));
          wr[x] = fmaf(f.x, q.x, fmaf(-f.y, q.y, wr[x]));
          wi[x] = fmaf(f.x, q.y, fmaf(f.y, q.x, wi[x]));
        }
      }
      float2* zp = s_z + (tt * M1 + m) * M2 + s * NS;
#pragma unroll
      for (int x = 0; x < NS; ++x) {
        zp[x] = make_float2(zr[x], zi[x]);
        if (two) zp[M2 + x] = make_float2(wr[x], wi[x]);
      }
    }
    __syncthreads();

    // out[tt, k]: a warp per (pair of channels, group of 32 columns), a lane
    // per column, the warp's trip count; an entry is loaded once for both
    // channels
    const int n_pairs = (tn + 1) >> 1;
    for (int item = warp; item < n_pairs * G; item += n_warps) {
      const int pair = item / G;
      const int g = item - pair * G;
      const int tt = 2 * pair;
      const bool two = tt + 1 < tn;
      const int first = s_ptr[g];
      const int trips = (s_ptr[g + 1] - first) >> 5;
      const float2* z0 = s_z + tt * P;
      const float2* z1 = z0 + (two ? P : 0);
      const int2* col = s_ent + first + lane;
      float a0r = 0.f, a0i = 0.f, a1r = 0.f, a1i = 0.f;
#pragma unroll 2
      for (int e = 0; e < trips; ++e) {
        const int2 v = col[e * kWarp];
        const float c = __int_as_float(v.y);
        const float2 za = z0[v.x];
        const float2 zb = z1[v.x];
        a0r += c * za.x;
        a0i += c * za.y;
        a1r += c * zb.x;
        a1i += c * zb.y;
      }
      const int k = g * kWarp + lane;
      if (k < K) {
        const size_t dst = ((size_t)bi * T + t0 + tt) * K + k;
        out_r[dst] = from_f32<In>(a0r);
        out_i[dst] = from_f32<In>(a0i);
        if (two) {
          out_r[dst + K] = from_f32<In>(a1r);
          out_i[dst + K] = from_f32<In>(a1i);
        }
      }
    }
    // the next tile's e and q may be staged at once: nothing reads them
    // after the barrier above, and z is not written before the next one
  }
  cp_async_wait_all();                 // a block that got no tile
}

template <typename In>
using Kernel = void (*)(const In*, const In*, const In*, const In*, const int*,
                        const int2*, In*, In*, int, int, int, int, int, int,
                        int, int, int, int, int);

template <typename In>
Kernel<In> kernel_for(int ns) {
  switch (ns) {
    case 1: return cg_aggregate_edge_kernel<In, 1>;
    case 3: return cg_aggregate_edge_kernel<In, 3>;
    case 4: return cg_aggregate_edge_kernel<In, 4>;
    case 5: return cg_aggregate_edge_kernel<In, 5>;
    default: return nullptr;
  }
}

// Resident blocks per SM of the instantiation for operands `In` and strips
// of `ns` on the current device; -1 for a strip the kernel is not compiled
// for or a refused configuration. The runtime is asked once per (device, ns,
// threads, smem) and operand type, and the kernel's limit of dynamic shared
// memory is only ever raised: a launch costs the host one look into the map.
template <typename In>
int blocks_per_sm(int ns, int threads, int smem) {
  static std::mutex mutex;
  static std::map<std::array<int, 4>, int> known;
  static std::map<std::array<int, 2>, int> limit;
  Kernel<In> kernel = kernel_for<In>(ns);
  if (kernel == nullptr) return -1;
  int dev = 0;
  cudaGetDevice(&dev);
  std::lock_guard<std::mutex> lock(mutex);
  const std::array<int, 4> key = {dev, ns, threads, smem};
  const auto found = known.find(key);
  if (found != known.end()) return found->second;
  int& allowed = limit[{dev, ns}];
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

int num_sms() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

template <typename In>
int launch(const In* sph, const In* rad, const In* q_r, const In* q_i,
           const int* grp_ptr, const int* ent, In* out_r, In* out_i, int B,
           int N, int T, int L, int M1, int M2, int K, int G, int n_ent, int TT,
           int ns, int threads, int smem, void* stream) {
  Kernel<In> kernel = kernel_for<In>(ns);
  if (kernel == nullptr || M2 % ns != 0 || TT < 1 || n_ent % kWarp != 0 ||
      threads % kWarp != 0 || threads > 256 || smem < 0)
    return (int)cudaErrorInvalidValue;
  const int per_sm = blocks_per_sm<In>(ns, threads, smem);
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int n_tiles = (T + TT - 1) / TT;
  const long long n_work = (long long)B * N * n_tiles;
  if (n_work > 0) {
    const long long slots = (long long)per_sm * num_sms();
    const int grid = (int)(n_work < slots ? n_work : slots);
    kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
        sph, rad, q_r, q_i, grp_ptr, reinterpret_cast<const int2*>(ent), out_r,
        out_i, (int)n_work, n_tiles, N, T, TT, L, M1, M2, K, G, n_ent);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cg_aggregate_blocks_per_sm(int ns, int threads, int smem) {
  return blocks_per_sm<float>(ns, threads, smem);
}

// Launch on `stream` and return cudaGetLastError() (0 on success). `ns` must
// divide M2; the table has `n_ent` entries, a multiple of 32; `smem` is the
// block's shared memory, summed on the host over the arrays the kernel lays
// out (ops/fused_agg.py:aggregate_fwd_smem). Operands and outputs are f32, or
// all bf16.
extern "C" int cg_aggregate_edge_fused_f32(
    const float* sph, const float* rad, const float* q_r, const float* q_i,
    const int* grp_ptr, const int* ent, float* out_r, float* out_i,
    int B, int N, int T, int L, int M1, int M2, int K, int G, int n_ent,
    int TT, int ns, int threads, int smem, void* stream) {
  return launch(sph, rad, q_r, q_i, grp_ptr, ent, out_r, out_i, B, N, T, L,
                M1, M2, K, G, n_ent, TT, ns, threads, smem, stream);
}

extern "C" int cg_aggregate_edge_fused_bf16(
    const __nv_bfloat16* sph, const __nv_bfloat16* rad,
    const __nv_bfloat16* q_r, const __nv_bfloat16* q_i, const int* grp_ptr,
    const int* ent, __nv_bfloat16* out_r, __nv_bfloat16* out_i, int B, int N,
    int T, int L, int M1, int M2, int K, int G, int n_ent, int TT, int ns,
    int threads, int smem, void* stream) {
  return launch(sph, rad, q_r, q_i, grp_ptr, ent, out_r, out_i, B, N, T, L,
                M1, M2, K, G, n_ent, TT, ns, threads, smem, stream);
}
