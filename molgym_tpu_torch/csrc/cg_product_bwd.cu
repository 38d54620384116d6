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
// 1,396 nonzeros, 555 of the 625 pairs live): the kernel must read g
// (1.68 MB), a and b (0.22 MB) and the table (11 KB) and write da
// and db (0.22 MB), about 0.6 us at 3.35 TB/s; its arithmetic, 4 operations
// a nonzero and 16 a live pair for each row, is 0.008 GFLOP, 0.1 us at
// 67 TFLOP/s. It is bound by bytes, the read of g, and the bound lies below
// the time of one launch: what the kernel takes beyond a launch is latency.
//
// What held the first version back (blocks of 4 rows, 140 blocks of 256
// threads with 33.6 KB each; dz for all 625 pairs, the 70 without entries
// included, by a thread per (row, pair) that walked its row of the table
// through rowptr -> col -> coef in global memory, once per row; then da and
// db by 200 of 256 threads, each a 25-step loop; a cudaFuncSetAttribute
// per launch) and what this design does about each:
//
//  * Tiles of R rows (a template parameter, 4, 2 or 1), a block each. g,
//    a and b of the tile and the packed tables are copied in at once by
//    cp.async (16 bytes a copy for the tables, 4 for g, a and b into their
//    slot-major layout), one barrier. A block copies the whole table for
//    its tile, so the host takes the fewest rows a tile whose own data
//    bring half the table's bytes (ops/fused_cg.py:product_bwd_plan): at
//    560 rows 2 rows at SF6's second product (280 blocks, 33 KB each), 4 at
//    the stochastic configuration's, 1 at the mixer's first product, whose
//    table is smaller than a row of g (4 rows there read 0.0043 ms against
//    0.0033).
//  * dz by a lane per live pair over the R rows in registers: the table's
//    rows, packed as 8-byte (k, coefficient) words, sorted by length and
//    padded to the longest of each group of 32 (fused_agg.warp_padded:
//    1,472 entries at SF6), each read once for all rows; warps take the
//    groups in a snake over their lengths. Only the live pairs have
//    lanes; dz of a pair is stored at its lane slot, and the slot past the
//    last group holds zeros. The lanes read g at scattered k, so the host
//    orders each lane's entries over its group's steps so that a quarter
//    warp's 16-byte loads fall on distinct bank groups where they can
//    (fused_agg.spread_steps).
//  * da and db over two step-major tables of (dz slot, other slot) words:
//    line m lists the live pairs (m, n) by n, line n of the second the
//    live pairs (m, n) by m, each table as long as its longest line (25
//    and 25 at SF6; 25 and 1 where M1 = 1), padded with the slot of zeros.
//    A power of two of neighbouring lanes takes each line, lane s every
//    s-th step, and a shuffle tree adds their sums: the 25-step line of da
//    where M1 = 1 is 7 steps a lane. At a step of da the lines mostly name
//    one n, so their loads of b are one broadcast.
//  * Every output is the same lanes' sums added in the same order: no
//    atomics, and the same bits every run. The complex products are fmaf;
//    no division. The host raises the kernel's shared-memory limit only
//    above the default 48 KB, once per (device, tile) and size.
//
// Measured: PERF.md, section 6 (molgym_tpu_torch/bench_encoder.py --kernels
// product and chip_smoke.py).
#include "cg_product_common.cuh"

namespace {

constexpr int kMaxThreads = 256;

// words of a step-major table of L steps of n lines, padded to 16 bytes
__host__ __device__ inline int line_words(int L, int n) { return (L * n + 3) / 4 * 4; }

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

// x[r, 0..M) of the tile's rows into slot-major [M][ZS] float2, a 4-byte
// copy per value; the rows past a short tile keep what they held (their
// sums are not stored)
template <int ZS>
__device__ __forceinline__ void copy_slots(float2* dst, const float* x_r,
                                           const float* x_i, int nr, int M) {
  for (int r = 0; r < nr; ++r) {
    for (int m = threadIdx.x; m < M; m += blockDim.x) {
      float2* d = dst + m * ZS + r;
      cp_async4(&d->x, x_r + (size_t)r * M + m);
      cp_async4(&d->y, x_i + (size_t)r * M + m);
    }
  }
}

template <int R>
__global__ void __launch_bounds__(kMaxThreads) cg_product_bwd_kernel(
    const float* __restrict__ a_r,       // [rows, M1]
    const float* __restrict__ a_i,       // [rows, M1]
    const float* __restrict__ b_r,       // [rows, M2]
    const float* __restrict__ b_i,       // [rows, M2]
    const float* __restrict__ g_r,       // [rows, K]
    const float* __restrict__ g_i,       // [rows, K]
    const int* __restrict__ grp_ptr,     // [G + 1] entry offset of each group of 32 live pairs
    const int2* __restrict__ ent,        // [n_ent] (column k, coef bits)
    const int* __restrict__ lines,       // step-major [La][M1], then [Lb][M2]: (dz slot << 16 | other slot)
    float* __restrict__ da_r,            // [rows, M1]
    float* __restrict__ da_i,            // [rows, M1]
    float* __restrict__ db_r,            // [rows, M2]
    float* __restrict__ db_i,            // [rows, M2]
    int rows, int M1, int M2, int K, int G, int n_ent, int La, int Lb,
    int lane_shift) {
  constexpr int ZS = slot_stride<R>();
  const int a_words = line_words(La, M1);
  const int n_words = a_words + line_words(Lb, M2);
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  int2* s_ent = reinterpret_cast<int2*>(base);           // [n_ent]
  base += align16(sizeof(int2) * n_ent);
  float2* s_dz = reinterpret_cast<float2*>(base);        // [32 G + 1][ZS]
  base += align16(sizeof(float2) * (kWarp * G + 1) * ZS);
  float2* s_g = reinterpret_cast<float2*>(base);         // [K][ZS]
  base += align16(sizeof(float2) * K * ZS);
  float2* s_a = reinterpret_cast<float2*>(base);         // [M1][ZS]
  base += align16(sizeof(float2) * M1 * ZS);
  float2* s_b = reinterpret_cast<float2*>(base);         // [M2][ZS]
  base += align16(sizeof(float2) * M2 * ZS);
  int* s_lines = reinterpret_cast<int*>(base);           // [n_words]
  base += align16(sizeof(int) * n_words);
  int* s_ptr = reinterpret_cast<int*>(base);             // [G + 1]

  const int tid = threadIdx.x;
  const int lane = tid & (kWarp - 1);
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int row0 = blockIdx.x * R;
  const int nr = min(R, rows - row0);

  for (int idx = tid; idx < n_ent / 2; idx += blockDim.x)
    cp_async16(s_ent + 2 * idx, ent + 2 * idx);
  for (int idx = tid; idx < n_words / 4; idx += blockDim.x)
    cp_async16(s_lines + 4 * idx, lines + 4 * idx);
  copy_slots<ZS>(s_g, g_r + (size_t)row0 * K, g_i + (size_t)row0 * K, nr, K);
  copy_slots<ZS>(s_a, a_r + (size_t)row0 * M1, a_i + (size_t)row0 * M1, nr, M1);
  copy_slots<ZS>(s_b, b_r + (size_t)row0 * M2, b_i + (size_t)row0 * M2, nr, M2);
  for (int idx = tid; idx <= G; idx += blockDim.x) s_ptr[idx] = __ldg(grp_ptr + idx);
  if (tid < R) s_dz[kWarp * G * ZS + tid] = make_float2(0.f, 0.f);
  cp_async_wait_all();
  __syncthreads();

  // dz: a warp per group of 32 live pairs, a lane per pair, the R rows' sums
  // in registers; one entry serves all rows
  for (int j = 0;; ++j) {
    const int g = snake(j, warp, n_warps);
    if (g >= G) break;
    const int first = s_ptr[g];
    const int trips = (s_ptr[g + 1] - first) >> 5;
    const int2* col = s_ent + first + lane;
    float2 acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = make_float2(0.f, 0.f);
#pragma unroll 3
    for (int e = 0; e < trips; ++e) {
      const int2 v = col[e * kWarp];
      const float c = __int_as_float(v.y);
      float2 gv[R];
      load_slot<R>(s_g + v.x * ZS, gv);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        acc[r].x = fmaf(c, gv[r].x, acc[r].x);
        acc[r].y = fmaf(c, gv[r].y, acc[r].y);
      }
    }
    store_slot<R>(s_dz + (g * kWarp + lane) * ZS, acc);
  }
  __syncthreads();

  // da and db: 2^lane_shift neighbouring lanes per line, the R rows, each
  // lane taking every 2^lane_shift-th step; line t < M1 is da[., t] over
  // conj(b), line M1 + n is db[., n] over conj(a). A shuffle tree adds the
  // lanes' sums in a fixed order.
  const int n_lines = M1 + M2;
  const int per_line = 1 << lane_shift;
  for (int at = warp * kWarp; at < (n_lines << lane_shift); at += blockDim.x) {
    const int t = (at + lane) >> lane_shift;
    const int s = lane & (per_line - 1);
    float2 acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = make_float2(0.f, 0.f);
    if (t < n_lines) {
      const bool is_a = t < M1;
      const int n = is_a ? M1 : M2;
      const int L = is_a ? La : Lb;
      const int* line = is_a ? s_lines + t : s_lines + a_words + (t - M1);
      const float2* other = is_a ? s_b : s_a;
#pragma unroll 4
      for (int e = s; e < L; e += per_line) {
        const int w = line[e * n];
        float2 z[R], y[R];
        load_slot<R>(s_dz + (w >> 16) * ZS, z);
        load_slot<R>(other + (w & 0xffff) * ZS, y);
#pragma unroll
        for (int r = 0; r < R; ++r) {        // dz conj(y)
          acc[r].x = fmaf(z[r].x, y[r].x, fmaf(z[r].y, y[r].y, acc[r].x));
          acc[r].y = fmaf(z[r].y, y[r].x, fmaf(-z[r].x, y[r].y, acc[r].y));
        }
      }
    }
    for (int off = per_line >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        acc[r].x += __shfl_down_sync(0xffffffffu, acc[r].x, off);
        acc[r].y += __shfl_down_sync(0xffffffffu, acc[r].y, off);
      }
    }
    if (t < n_lines && s == 0) {
      const bool is_a = t < M1;
      const int n = is_a ? M1 : M2;
      const size_t o = (size_t)row0 * n + (is_a ? t : t - M1);
      float* o_r = is_a ? da_r : db_r;
      float* o_i = is_a ? da_i : db_i;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < nr) {
          o_r[o + (size_t)r * n] = acc[r].x;
          o_i[o + (size_t)r * n] = acc[r].y;
        }
      }
    }
  }
}

typedef void (*Kernel)(const float*, const float*, const float*, const float*,
                       const float*, const float*, const int*, const int2*,
                       const int*, float*, float*, float*, float*, int, int,
                       int, int, int, int, int, int, int);

Kernel kernel_for(int rows_per_tile) {
  switch (rows_per_tile) {
    case 1: return cg_product_bwd_kernel<1>;
    case 2: return cg_product_bwd_kernel<2>;
    case 4: return cg_product_bwd_kernel<4>;
    default: return nullptr;
  }
}

}  // namespace

// Resident blocks per SM of the instantiation for tiles of `rows_per_tile`
// rows at `threads` and `smem`, for a log line; -1 for a tile the kernel is
// not compiled for or a refused configuration.
extern "C" int cg_product_bwd_blocks_per_sm(int rows_per_tile, int threads,
                                            int smem) {
  Kernel kernel = kernel_for(rows_per_tile);
  if (kernel == nullptr || !allow_smem(kernel, rows_per_tile, smem)) return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads,
                                                    smem) != cudaSuccess)
    return -1;
  return blocks;
}

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// table has `n_ent` entries, a multiple of 32, in G groups; the lines are
// two step-major tables of La and Lb steps, each padded to a multiple of 4
// words; 2^lane_shift lanes a line (at most a warp); M1, M2 < 65536; tiles
// of `rows_per_tile` rows (1, 2 or 4), `threads` a block and its shared
// bytes (`smem`) from the host's plan (ops/fused_cg.py:product_bwd_plan).
extern "C" int cg_product_bwd_f32(
    const float* a_r, const float* a_i, const float* b_r, const float* b_i,
    const float* g_r, const float* g_i, const int* grp_ptr, const int* ent,
    const int* lines, float* da_r, float* da_i, float* db_r, float* db_i,
    int rows, int M1, int M2, int K, int G, int n_ent, int La, int Lb,
    int lane_shift, int rows_per_tile, int threads, int smem, void* stream) {
  Kernel kernel = kernel_for(rows_per_tile);
  if (kernel == nullptr || M1 < 1 || M1 >= 65536 || M2 < 1 || M2 >= 65536 ||
      G < 1 || n_ent % kWarp != 0 || La < 1 || Lb < 1 || lane_shift < 0 ||
      lane_shift > 5 || threads % kWarp != 0 || threads < kWarp ||
      threads > kMaxThreads || smem < 0)
    return (int)cudaErrorInvalidValue;
  if (!allow_smem(kernel, rows_per_tile, smem))
    return (int)cudaErrorInvalidConfiguration;
  if (rows > 0) {
    kernel<<<(rows + rows_per_tile - 1) / rows_per_tile, threads, smem,
             (cudaStream_t)stream>>>(
        a_r, a_i, b_r, b_i, g_r, g_i, grp_ptr,
        reinterpret_cast<const int2*>(ent), lines, da_r, da_i, db_r, db_i,
        rows, M1, M2, K, G, n_ent, La, Lb, lane_shift);
  }
  return (int)cudaGetLastError();
}
