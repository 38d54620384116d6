// CG self-product ("CG square") of a packed rep over a list of (m, n) pairs,
// f32 or bf16 operands, f32 accumulation, for Hopper (sm_90a).
//
//   z[r, p]   = a[r, m_p] * a[r, n_p]              (complex)
//   out[r, k] = sum_p C[p, k] * z[r, p]            (C real)
//
// with the rows r = (b, i, t) flattened and real and imaginary parts in
// separate arrays. With the tri fold (pairs m <= n, folded tables
// C[m,n] + C[n,m], columns grouped by lmin) this is the level's square; the
// dense and l1-grouped pair lists run through the same code.
//
// Replaces molgym_tpu/ops/pallas_agg.py:_fwd_kernel with n_j = 1 and a pair
// list (the tri fold reached through cg_square_fused_ri).
//
// Bound on the H100 at the SF6 shapes (rows = 140 * 7 * 10 = 9,800, M = 25,
// P = 325 tri pairs, K = 375): the kernel must read 2.0 MB (a) and write
// 29.4 MB (out), about 9.4 us at 3.35 TB/s; its arithmetic, 6 operations a
// pair plus 4 for each of the folded tables' 1,130 nonzeros, is 0.06 GFLOP,
// under 2 us at 67 TFLOP/s. It is bound by bytes: the write of out.
//
// What held the first version back (blocks of 8 rows, 1.16 waves at
// B = 140 and a handful of blocks at B <= 10; a thread per (row, k) that
// walked its column through colptr -> entry -> z from L1 and waited for the
// longest column of its warp; an integer division per element; z read at
// scattered pairs with bank conflicts) and what this design does about each:
//
//  * A lane per output column over a tile of R rows (R = 4, 2 or 1, a
//    template parameter chosen on the host from the shapes alone,
//    ops/fused_agg.py:square_fwd_plan: 4 at B = 140, 2 at SF6's B = 10, 1
//    at B = 1): the 2 R sums sit in registers, and each table entry is read
//    once for all R rows. Stores go out one row at a time, 32 neighbouring
//    k per warp.
//  * The table in shared memory: the host packs each nonzero as one 8-byte
//    (z slot, coefficient) word and pads the columns of each group of 32 to
//    the group's longest (fused_agg.warp_padded: 1,728 entries at SF6), so a
//    warp reads one step of its 32 columns as 256 consecutive bytes with no
//    per-column pointer. It is copied once per block with cp.async. A
//    column with no entries gets zeros from the padding; a group with none
//    at all is written as zeros without a step.
//  * z pair-major, [slot][R] complex, a thread per slot over the R rows, so
//    a lane loads its rows as 16-byte vectors; slots of R = 4 rows are
//    padded to 48 bytes, so that slot s falls on bank group 3 s mod 8. Only
//    the pairs some column reads get a slot (287 of 325 at SF6). The host
//    orders each column's entries over its group's steps so that the eight
//    lanes of a quarter warp, which one phase of a 16-byte load serves,
//    read slots of distinct bank groups where they can
//    (fused_agg.spread_steps): 1.10 phases a load instead of 1.57 at SF6.
//  * Blocks are persistent and walk the tiles with the grid's stride; a's
//    next tile is copied in (cp.async) while this one is worked on. At the
//    rollout's batch the host picks smaller tiles, so that the rows spread
//    over more blocks (350 at SF6, B = 10; 70 at B = 1, against 88 and 9
//    before). Groups go to warps in a snake over their lengths, longest
//    first, so that no warp takes two long groups while another idles.
//  * The complex products are fmaf, with no division in any loop.
//
// Measured on an NVIDIA H100 80GB HBM3 (700 W), CUDA-graph replay, this
// kernel and the first version in turns in one call
// (molgym_tpu_torch/bench_encoder.py): SF6 tau 10, B = 140 0.0179-0.0186 ms
// (first version 0.0325-0.0331), B = 10 0.0044 (0.0090), B = 1 0.0033
// (0.0085). Before the entries were spread over the banks, compiling out
// the table walk took it from 0.0199 to 0.0150 ms and compiling out its
// stores to 0.016-0.018 ms, against 0.0098 ms for writing the output alone
// (zero_): the block's phases, more than the write, set its pace.
// PERF.md, section 6, has every shape.
//
// `In` is the operand type of a and out, f32 or bf16 (operand.cuh). A bf16
// rep is converted to f32 as it is staged into its slots, by plain 2-byte
// loads (no cp.async: the copy converts), so the slot layout
// (ops/fused_agg.py:square_fwd_smem), the plan and every sum are the same for
// both, and each output is rounded once. With bf16 the bytes halve (about
// 4.7 us at SF6), still above the operations.
#include <cuda_runtime.h>

#include <array>
#include <map>
#include <mutex>

#include "operand.cuh"

namespace {

using operand::cp_async_16;
using operand::cp_async_wait_all;
using operand::from_f32;
using operand::stage_value;

constexpr int kWarp = 32;
constexpr int kMaxThreads = 256;

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) / 16 * 16; }

// float2 per slot of z (and of a) for a tile of R rows: 16-byte multiples
// (8 bytes at R = 1) on which slot s starts at bank group s or 3 s mod 8
template <int R>
__host__ __device__ constexpr int slot_stride() { return R >= 4 ? R + 2 : R; }

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

template <int R>
__device__ __forceinline__ void store_slot(float2* p, const float2 (&v)[R]) {
  if constexpr (R == 1) {
    p[0] = v[0];
  } else {
    float4* q = reinterpret_cast<float4*>(p);
#pragma unroll
    for (int j = 0; j < R / 2; ++j)
      q[j] = make_float4(v[2 * j].x, v[2 * j].y, v[2 * j + 1].x, v[2 * j + 1].y);
  }
}

// position of the i-th of `ways` takers' items in a snake over a sequence:
// taker c takes c, 2 ways - 1 - c, 2 ways + c, ... (increasing in i)
__device__ __forceinline__ int snake(int i, int c, int ways) {
  return i * ways + ((i & 1) ? ways - 1 - c : c);
}

template <typename In, int R>
__global__ void __launch_bounds__(kMaxThreads) cg_square_kernel(
    const In* __restrict__ a_r,         // [rows, M]
    const In* __restrict__ a_i,         // [rows, M]
    const int* __restrict__ slot_mn,    // [S] (m << 16 | n) of the pair in z slot s
    const int* __restrict__ grp_ptr,    // [G + 1] entry offset of each group of 32 columns
    const int* __restrict__ grp_seq,    // [G] the groups, longest first
    const int2* __restrict__ ent,       // [n_ent] (z slot, coef bits)
    In* __restrict__ out_r,             // [rows, K]
    In* __restrict__ out_i,             // [rows, K]
    int rows, int M, int K, int G, int n_ent, int S) {
  constexpr int ZS = slot_stride<R>();
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  int2* s_ent = reinterpret_cast<int2*>(base);
  base += align16(sizeof(int2) * n_ent);
  float2* s_z = reinterpret_cast<float2*>(base);        // [S][ZS]
  base += align16(sizeof(float2) * S * ZS);
  const size_t a_buf = align16(sizeof(float2) * M * ZS);
  float2* s_a = reinterpret_cast<float2*>(base);        // [2][M][ZS]
  base += 2 * a_buf;
  int* s_ptr = reinterpret_cast<int*>(base);            // [G + 1]
  base += align16(sizeof(int) * (G + 1));
  int* s_seq = reinterpret_cast<int*>(base);            // [G]
  base += align16(sizeof(int) * G);
  int* s_mn = reinterpret_cast<int*>(base);             // [S]

  const int tid = threadIdx.x;
  const int lane = tid & (kWarp - 1);
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;

  // once per block: the table (asynchronously), offsets, order, pairs; the
  // first barrier of the first item covers them
  for (int idx = tid; idx < n_ent / 2; idx += blockDim.x)
    cp_async_16(s_ent + 2 * idx, ent + 2 * idx);
  for (int idx = tid; idx <= G; idx += blockDim.x) s_ptr[idx] = grp_ptr[idx];
  for (int idx = tid; idx < G; idx += blockDim.x) s_seq[idx] = grp_seq[idx];
  for (int idx = tid; idx < S; idx += blockDim.x) s_mn[idx] = slot_mn[idx];

  const int n_tiles = (rows + R - 1) / R;

  // a[row0 + r, m] into slot m of buffer `buf`, a 4-byte copy (or a bf16
  // conversion) per value; the rows of a last, short tile keep what they
  // held (their sums are not stored). One division per copy, R * M copies a
  // tile.
  auto prefetch = [&](int tile, int buf) {
    const int row0 = tile * R;
    float2* dst = reinterpret_cast<float2*>(reinterpret_cast<char*>(s_a) + buf * a_buf);
    const int n = min(R, rows - row0) * M;
    for (int idx = tid; idx < n; idx += blockDim.x) {
      const int r = idx / M;
      float2* d = dst + (idx - r * M) * ZS + r;
      stage_value(&d->x, a_r + (size_t)row0 * M + idx);
      stage_value(&d->y, a_i + (size_t)row0 * M + idx);
    }
  };

  if (blockIdx.x < n_tiles) prefetch(blockIdx.x, 0);
  int buf = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, buf ^= 1) {
    const int row0 = tile * R;
    const int nr = min(R, rows - row0);
    cp_async_wait_all();
    __syncthreads();     // this tile's a has landed; the last tile's table phase is done with z
    if (tile + (int)gridDim.x < n_tiles) prefetch(tile + gridDim.x, buf ^ 1);

    // z[s, r] = a[r, m_s] a[r, n_s]: a thread per slot over the tile's rows
    const float2* sa =
        reinterpret_cast<const float2*>(reinterpret_cast<const char*>(s_a) + buf * a_buf);
    for (int s = tid; s < S; s += blockDim.x) {
      const int mn = s_mn[s];
      float2 x[R], y[R], z[R];
      load_slot<R>(sa + (mn >> 16) * ZS, x);
      load_slot<R>(sa + (mn & 0xffff) * ZS, y);
#pragma unroll
      for (int r = 0; r < R; ++r)
        z[r] = make_float2(fmaf(x[r].x, y[r].x, -x[r].y * y[r].y),
                           fmaf(x[r].x, y[r].y, x[r].y * y[r].x));
      store_slot<R>(s_z + s * ZS, z);
    }
    __syncthreads();

    // out[r, k]: a warp per group of 32 columns, a lane per column, the R
    // rows' sums in registers; one entry serves all rows
    for (int j = 0;; ++j) {
      const int pos = snake(j, warp, n_warps);
      if (pos >= G) break;
      const int g = s_seq[pos];
      const int first = s_ptr[g];
      const int trips = (s_ptr[g + 1] - first) >> 5;
      const int2* col = s_ent + first + lane;
      float acc_r[R], acc_i[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc_r[r] = acc_i[r] = 0.f;
#pragma unroll 2
      for (int e = 0; e < trips; ++e) {
        const int2 v = col[e * kWarp];
        const float c = __int_as_float(v.y);
        float2 z[R];
        load_slot<R>(s_z + v.x * ZS, z);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          acc_r[r] = fmaf(c, z[r].x, acc_r[r]);
          acc_i[r] = fmaf(c, z[r].y, acc_i[r]);
        }
      }
      const int k = g * kWarp + lane;
      if (k < K) {
        In* o_r = out_r + (size_t)row0 * K + k;
        In* o_i = out_i + (size_t)row0 * K + k;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r < nr) {
            o_r[(size_t)r * K] = from_f32<In>(acc_r[r]);
            o_i[(size_t)r * K] = from_f32<In>(acc_i[r]);
          }
        }
      }
    }
  }
  cp_async_wait_all();   // a block that got no tile
}

template <typename In>
using Kernel = void (*)(const In*, const In*, const int*, const int*,
                        const int*, const int2*, In*, In*, int, int, int, int,
                        int, int);

template <typename In>
Kernel<In> kernel_for(int rows_per_tile) {
  switch (rows_per_tile) {
    case 1: return cg_square_kernel<In, 1>;
    case 2: return cg_square_kernel<In, 2>;
    case 4: return cg_square_kernel<In, 4>;
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

// Resident blocks per SM of the instantiation for operands `In` and tiles of
// `rows_per_tile` rows on the current device; -1 for a tile the kernel is not
// compiled for or a refused configuration. The runtime is asked once per
// (device, tile, threads, smem) and operand type, and the kernel's limit of
// dynamic shared memory is only ever raised: a launch costs the host one look
// into the map.
template <typename In>
int blocks_per_sm(int rows_per_tile, int threads, int smem) {
  static std::mutex mutex;
  static std::map<std::array<int, 4>, int> known;
  static std::map<std::array<int, 2>, int> limit;
  Kernel<In> kernel = kernel_for<In>(rows_per_tile);
  if (kernel == nullptr) return -1;
  int dev = 0;
  cudaGetDevice(&dev);
  std::lock_guard<std::mutex> lock(mutex);
  const std::array<int, 4> key = {dev, rows_per_tile, threads, smem};
  const auto found = known.find(key);
  if (found != known.end()) return found->second;
  int& allowed = limit[{dev, rows_per_tile}];
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
int launch(const In* a_r, const In* a_i, const int* slot_mn, const int* grp_ptr,
           const int* grp_seq, const int* ent, In* out_r, In* out_i, int rows,
           int M, int K, int G, int n_ent, int S, int rows_per_tile,
           int threads, int smem, void* stream) {
  Kernel<In> kernel = kernel_for<In>(rows_per_tile);
  if (kernel == nullptr || n_ent % kWarp != 0 || M < 1 || M >= 65536 ||
      G < 1 || K > G * kWarp || threads % kWarp != 0 || threads < kWarp || threads > kMaxThreads ||
      smem < 0)
    return (int)cudaErrorInvalidValue;
  const int per_sm = blocks_per_sm<In>(rows_per_tile, threads, smem);
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int n_tiles = (rows + rows_per_tile - 1) / rows_per_tile;
  if (n_tiles > 0) {
    const int slots = per_sm * num_sms();
    const int grid = n_tiles < slots ? n_tiles : slots;
    kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
        a_r, a_i, slot_mn, grp_ptr, grp_seq, reinterpret_cast<const int2*>(ent),
        out_r, out_i, rows, M, K, G, n_ent, S);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cg_square_blocks_per_sm(int rows_per_tile, int threads, int smem) {
  return blocks_per_sm<float>(rows_per_tile, threads, smem);
}

// Launch on `stream` and return cudaGetLastError() (0 on success). The table
// has `n_ent` entries, a multiple of 32, in G groups; M < 65536; tiles of
// `rows_per_tile` rows (1, 2 or 4); `smem` is the block's shared memory,
// summed on the host over the arrays the kernel lays out
// (ops/fused_agg.py:square_fwd_smem). Operands and outputs are f32, or all
// bf16.
extern "C" int cg_square_fused_f32(
    const float* a_r, const float* a_i, const int* slot_mn, const int* grp_ptr,
    const int* grp_seq, const int* ent, float* out_r, float* out_i, int rows,
    int M, int K, int G, int n_ent, int S, int rows_per_tile, int threads,
    int smem, void* stream) {
  return launch(a_r, a_i, slot_mn, grp_ptr, grp_seq, ent, out_r, out_i, rows,
                M, K, G, n_ent, S, rows_per_tile, threads, smem, stream);
}

extern "C" int cg_square_fused_bf16(
    const __nv_bfloat16* a_r, const __nv_bfloat16* a_i, const int* slot_mn,
    const int* grp_ptr, const int* grp_seq, const int* ent,
    __nv_bfloat16* out_r, __nv_bfloat16* out_i, int rows, int M, int K, int G,
    int n_ent, int S, int rows_per_tile, int threads, int smem, void* stream) {
  return launch(a_r, a_i, slot_mn, grp_ptr, grp_seq, ent, out_r, out_i, rows,
                M, K, G, n_ent, S, rows_per_tile, threads, smem, stream);
}
