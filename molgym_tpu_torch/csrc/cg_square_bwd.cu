// Backward (vector-Jacobian product) of the CG square of cg_square.cu, f32
// or bf16 operands, f32 accumulation, for Hopper (sm_90a). Given the output gradients g[r, k] (real and
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
// What held the first version back (46 KB of shared memory a block of 8
// rows, so 2.3 waves of 4 blocks an SM; g copied in before any arithmetic;
// dz by a thread per (row, pair) with a division, the CSR rows re-read per
// row and the 38 empty pairs given threads; da by 200 of 256 threads through
// 26 steps of 6 dependent loads) and what this design does about each:
//
//  * Persistent blocks of 128 threads over tiles of R = 2 rows (30 KB at
//    SF6, seven blocks an SM; of tiles of 1, 2, 4 and 8 rows and blocks of
//    64, 128 and 256 threads this read fastest at both configurations), g
//    and a of the next tile streaming in by cp.async into a second buffer
//    while this tile is worked on: 16-byte copies of g from the 16-byte
//    line that holds a row's first value, 4-byte copies of a into its
//    slot-major layout.
//  * dz by a lane per pair over the R rows in registers: the table's rows,
//    packed as 8-byte (k, coefficient) words, sorted by length and padded
//    to the longest of each group of 32 (fused_agg.warp_padded: 1,248
//    entries at SF6), are read once per tile for all R rows; warps take the
//    groups in a snake over their lengths. Only the pairs with entries have
//    lanes; dz of a pair is stored at its rank, and the empty pairs share
//    one slot of zeros past the last group. The lanes read g at scattered
//    k, so the host orders each row's entries over its group's steps so
//    that the 32 lanes of a step read distinct banks where they can
//    (fused_agg.spread_steps): 1.10 phases a load instead of 1.67 at SF6.
//  * da by a thread per (row, m) over a dense [M][L] table of (dz slot,
//    other slot) words (L = M + 1 for the tri pairs, 2 M for the dense
//    ones): every line is L long, so no pointer array, and the host orders
//    each line by the other slot, so that the threads of one step read the
//    same a. Rows are the fastest index of a thread, so a warp reads 8
//    rows of 4 slots of dz. Each da is one thread's sum in a fixed order:
//    no atomics, and the same bits every run.
//  * The complex products are fmaf; no division in any loop.
//
// Measured on an NVIDIA H100 80GB HBM3 (700 W), CUDA-graph replay, this
// kernel and the first version in turns in one call
// (molgym_tpu_torch/bench_encoder.py): SF6 tau 10, B = 140 0.0236-0.0239 ms
// (first version 0.0556-0.0558); M = 16, tau 16 0.0252-0.0255 (0.0326-
// 0.0329). In a variant with tiles of 4 rows, compiling out dz, da or the
// copies took it from 0.024 to 0.017, 0.017 and 0.019 ms: the three
// overlap, and none alone sets the pace.
// PERF.md, section 6, has every shape.
//
// `In` is the operand type of a, g and da, f32 or bf16 (operand.cuh). bf16 g
// and a are converted to f32 as they are staged, value by value (2-byte
// loads, aligned at any offset: a bf16 row of g may start on any even byte),
// g at the start of its row's buffer, so the layout
// (ops/fused_agg.py:square_bwd_smem) and every sum, in the same fixed order,
// are the same for both, and each output is rounded once. With bf16 the
// bytes halve (about 5 us at SF6), still above the operations.
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

constexpr int kWarp = 32;
constexpr int kThreads = 128;
constexpr int R = 2;                   // rows a tile

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) / 16 * 16; }

// float2 per slot of dz (and of a) for a tile of R rows: 16 bytes, slot s
// on bank group s mod 8
constexpr int ZS = R;

// floats a shared row of k values takes with the slack of its 16-byte copy
__host__ __device__ inline int padded_row(int k) { return ((k + 3) / 4 + 1) * 4; }

// position of the i-th of `ways` takers' items in a snake over a sequence:
// taker c takes c, 2 ways - 1 - c, 2 ways + c, ... (increasing in i)
__device__ __forceinline__ int snake(int i, int c, int ways) {
  return i * ways + ((i & 1) ? ways - 1 - c : c);
}

template <typename In>
__global__ void __launch_bounds__(kThreads) cg_square_bwd_kernel(
    const In* __restrict__ a_r,          // [rows, M]
    const In* __restrict__ a_i,          // [rows, M]
    const In* __restrict__ g_r,          // [rows, K]
    const In* __restrict__ g_i,          // [rows, K]
    const int* __restrict__ grp_ptr,     // [G + 1] entry offset of each group of 32 pairs
    const int2* __restrict__ ent,        // [n_ent] (column k, coef bits)
    const int* __restrict__ inc,         // [M][L] (dz slot << 8 | other slot)
    In* __restrict__ da_r,               // [rows, M]
    In* __restrict__ da_i,               // [rows, M]
    int rows, int M, int K, int G, int n_ent, int L) {
  const int S = kWarp * G + 1;           // dz slots; the last holds zeros
  const int KP = padded_row(K);
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  int2* s_ent = reinterpret_cast<int2*>(base);
  base += align16(sizeof(int2) * n_ent);
  float2* s_dz = reinterpret_cast<float2*>(base);       // [S][ZS]
  base += align16(sizeof(float2) * S * ZS);
  const size_t g_buf = sizeof(float) * R * 2 * KP;
  float* s_g = reinterpret_cast<float*>(base);          // [2][R][g_r KP | g_i KP]
  base += 2 * g_buf;
  const size_t a_buf = align16(sizeof(float2) * M * ZS);
  float2* s_a = reinterpret_cast<float2*>(base);        // [2][M][ZS]
  base += 2 * a_buf;
  int* s_ptr = reinterpret_cast<int*>(base);            // [G + 1]
  base += align16(sizeof(int) * (G + 1));
  int* s_inc = reinterpret_cast<int*>(base);            // [M][L]

  const int tid = threadIdx.x;
  const int lane = tid & (kWarp - 1);
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;

  // once per block: the table (asynchronously), offsets, incidence, the
  // slot of zeros; the first barrier of the first tile covers them
  for (int idx = tid; idx < n_ent / 2; idx += blockDim.x)
    cp_async_16(s_ent + 2 * idx, ent + 2 * idx);
  for (int idx = tid; idx <= G; idx += blockDim.x) s_ptr[idx] = grp_ptr[idx];
  for (int idx = tid; idx < M * L; idx += blockDim.x) s_inc[idx] = inc[idx];
  for (int r = tid; r < R; r += blockDim.x) s_dz[(S - 1) * ZS + r] = make_float2(0.f, 0.f);

  const int n_tiles = (rows + R - 1) / R;

  // copies (asynchronous for f32) of what tile `tile` needs into buffer
  // `buf`: its rows of g (stage_row: a row lies at lead_floats of its
  // address, at most 3 floats into its buffer) and a, value by value into
  // its slots. The rows of a last, short tile keep what they held: their
  // sums are not stored.
  auto prefetch = [&](int tile, int buf) {
    const int row0 = tile * R;
    const int nr = min(R, rows - row0);
    float* sg = s_g + buf * (g_buf / sizeof(float));
    for (int r = 0; r < nr; ++r) {
      stage_row(sg + r * 2 * KP, g_r + (size_t)(row0 + r) * K, K);
      stage_row(sg + r * 2 * KP + KP, g_i + (size_t)(row0 + r) * K, K);
    }
    float2* sa = reinterpret_cast<float2*>(reinterpret_cast<char*>(s_a) + buf * a_buf);
    for (int idx = tid; idx < nr * M; idx += blockDim.x) {
      const int r = idx / M;
      float2* d = sa + (idx - r * M) * ZS + r;
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
    __syncthreads();     // this tile has landed; the last tile's da is done with dz and a
    if (tile + (int)gridDim.x < n_tiles) prefetch(tile + gridDim.x, buf ^ 1);

    // dz[slot, r] = sum_k C[p, k] g[r, k]: a warp per group of 32 pairs, a
    // lane per pair, the R rows' sums in registers; one entry serves all rows
    const float* sg = s_g + buf * (g_buf / sizeof(float));
    int off_r[R], off_i[R];            // where each row's g lies in the buffer
#pragma unroll
    for (int r = 0; r < R; ++r) {
      off_r[r] = r * 2 * KP + lead_floats(g_r + (size_t)(row0 + r) * K);
      off_i[r] = r * 2 * KP + KP + lead_floats(g_i + (size_t)(row0 + r) * K);
    }
    for (int j = 0;; ++j) {          // the groups are sorted, longest first
      const int g = snake(j, warp, n_warps);
      if (g >= G) break;
      const int first = s_ptr[g];
      const int trips = (s_ptr[g + 1] - first) >> 5;
      const int2* row = s_ent + first + lane;
      float acc_r[R], acc_i[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc_r[r] = acc_i[r] = 0.f;
#pragma unroll 2
      for (int e = 0; e < trips; ++e) {
        const int2 v = row[e * kWarp];
        const float c = __int_as_float(v.y);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          acc_r[r] = fmaf(c, sg[off_r[r] + v.x], acc_r[r]);
          acc_i[r] = fmaf(c, sg[off_i[r] + v.x], acc_i[r]);
        }
      }
      *reinterpret_cast<float4*>(s_dz + (g * kWarp + lane) * ZS) =
          make_float4(acc_r[0], acc_i[0], acc_r[1], acc_i[1]);
    }
    __syncthreads();

    // da[r, m] = sum_j dz[slot_j, r] conj(a[r, other_j]) over line m: a
    // thread per (row, m), rows fastest, the sum in the line's order
    const float2* sa =
        reinterpret_cast<const float2*>(reinterpret_cast<const char*>(s_a) + buf * a_buf);
    for (int item = tid; item < R * M; item += blockDim.x) {
      const int r = item % R;
      const int m = item / R;
      const int* line = s_inc + m * L;
      float acc_r = 0.f, acc_i = 0.f;
#pragma unroll 4
      for (int j = 0; j < L; ++j) {
        const int v = line[j];
        const float2 z = s_dz[(v >> 8) * ZS + r];
        const float2 x = sa[(v & 255) * ZS + r];
        acc_r = fmaf(z.x, x.x, fmaf(z.y, x.y, acc_r));
        acc_i = fmaf(z.y, x.x, fmaf(-z.x, x.y, acc_i));
      }
      if (r < nr) {
        da_r[(size_t)(row0 + r) * M + m] = from_f32<In>(acc_r);
        da_i[(size_t)(row0 + r) * M + m] = from_f32<In>(acc_i);
      }
    }
  }
  cp_async_wait_all();   // a block that got no tile
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

// Resident blocks per SM of the instantiation for operands `In` at `smem`
// bytes, asked of the runtime once per (device, smem) and operand type, as
// in cg_square.cu.
template <typename In>
int blocks_per_sm(int smem) {
  static std::mutex mutex;
  static std::map<std::array<int, 2>, int> known;
  static std::map<int, int> limit;
  int dev = 0;
  cudaGetDevice(&dev);
  std::lock_guard<std::mutex> lock(mutex);
  const std::array<int, 2> key = {dev, smem};
  const auto found = known.find(key);
  if (found != known.end()) return found->second;
  int& allowed = limit[dev];
  if (smem > allowed) {
    if (cudaFuncSetAttribute(cg_square_bwd_kernel<In>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem) != cudaSuccess)
      return -1;
    allowed = smem;
  }
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, cg_square_bwd_kernel<In>, kThreads, smem) != cudaSuccess)
    return -1;
  known[key] = blocks;
  return blocks;
}

template <typename In>
int launch(const In* a_r, const In* a_i, const In* g_r, const In* g_i,
           const int* grp_ptr, const int* ent, const int* inc, In* da_r,
           In* da_i, int rows, int M, int K, int G, int n_ent, int L, int smem,
           void* stream) {
  if (n_ent % kWarp != 0 || M < 1 || M > 256 || G < 1 || L < 1 || smem < 0)
    return (int)cudaErrorInvalidValue;
  const int per_sm = blocks_per_sm<In>(smem);
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int n_tiles = (rows + R - 1) / R;
  if (n_tiles > 0) {
    const int slots = per_sm * num_sms();
    const int grid = n_tiles < slots ? n_tiles : slots;
    cg_square_bwd_kernel<In><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        a_r, a_i, g_r, g_i, grp_ptr, reinterpret_cast<const int2*>(ent), inc,
        da_r, da_i, rows, M, K, G, n_ent, L);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cg_square_bwd_blocks_per_sm(int smem) { return blocks_per_sm<float>(smem); }

// Launch on `stream` and return cudaGetLastError() (0 on success). The table
// has `n_ent` entries, a multiple of 32, in G groups of 32 dz slots; `inc`
// is [M][L] with M <= 256 and every dz slot at most 32 G; `smem` is the
// block's shared memory, summed on the host over the arrays the kernel lays
// out (ops/fused_agg.py:square_bwd_smem). Operands, cotangents and outputs
// are f32, or all bf16.
extern "C" int cg_square_bwd_f32(
    const float* a_r, const float* a_i, const float* g_r, const float* g_i,
    const int* grp_ptr, const int* ent, const int* inc, float* da_r,
    float* da_i, int rows, int M, int K, int G, int n_ent, int L, int smem,
    void* stream) {
  return launch(a_r, a_i, g_r, g_i, grp_ptr, ent, inc, da_r, da_i, rows, M, K,
                G, n_ent, L, smem, stream);
}

extern "C" int cg_square_bwd_bf16(
    const __nv_bfloat16* a_r, const __nv_bfloat16* a_i,
    const __nv_bfloat16* g_r, const __nv_bfloat16* g_i, const int* grp_ptr,
    const int* ent, const int* inc, __nv_bfloat16* da_r, __nv_bfloat16* da_i,
    int rows, int M, int K, int G, int n_ent, int L, int smem, void* stream) {
  return launch(a_r, a_i, g_r, g_i, grp_ptr, ent, inc, da_r, da_i, rows, M, K,
                G, n_ent, L, smem, stream);
}
