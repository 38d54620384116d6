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
// against a table that is 99 % zeros. Here a lane forms the pair products
// it needs in registers and walks only the table's nonzeros.
//
// Bound on the H100 at the SF6 shapes (rows = 140 * 4 = 560, M1 = M2 = 25,
// K = 375, 1,396 nonzeros): the kernel must read 0.22 MB (a, b) and the
// table (11 KB at 8 bytes a nonzero) and write 1.68 MB (out), about 0.6 us
// at 3.35 TB/s; its arithmetic, 10 operations a nonzero and row, is 0.008
// GFLOP, 0.1 us at 67 TFLOP/s. It is bound by bytes, the write of out, and
// the bound lies below the time of one launch: what the kernel takes beyond
// a launch is latency, the chain from the first load to the last store.
//
// What held the first version back (blocks of 4 rows and 256 threads, 140
// blocks on 132 SMs at 560 rows; a thread per output (r, k) that walked
// its column through colptr -> three entry arrays -> a and b, six rounds
// of that chain a thread, the column re-walked for each row; a division
// per output; a cudaFuncSetAttribute per launch) and what this design does
// about each:
//
//  * The host packs each nonzero as one 8-byte (m << 16 | n, coefficient)
//    word and pads the columns of each group of 32 to the group's longest
//    (ops/fused_cg.py:product_tables: 2,688 entries at SF6), so a step of
//    a warp is 256 consecutive bytes with no per-column pointer. The
//    columns stay in output order, so that lane l of group g writes
//    column 32 g + l and a warp's stores are coalesced: columns sorted by
//    length (1,568 entries, the lanes of a warp finishing together) read
//    0.0047 ms against 0.0036 at 560 rows, the scattered stores costing
//    more than the padding.
//  * A lane per column over a tile of R rows (R = 4 or 1, a template
//    parameter): the 2 R sums sit in registers, and each entry is read once
//    for all R rows. a and b of the tile lie slot-major, [slot][R]
//    complex, so a lane loads its rows of a[m] and of b[n] as 16-byte
//    vectors (slots of 4 rows padded to 48 bytes, slot s on bank group
//    3 s mod 8).
//  * The group offsets come by value, in the constant bank, so the
//    block's first act is to copy its chunk's entries, a and b, all at
//    once by cp.async (16 bytes a copy for the table, 4 for a and b into
//    their slots); one barrier, and the walk reads shared memory only.
//    Loading each lane's entries into registers instead took 52-64
//    registers and read slower at every shape.
//  * A block takes a tile and a chunk of 3 groups
//    (ops/fused_cg.py:product_fwd_plan): at 560 rows tiles of 4 rows, 560
//    blocks at SF6 (with all 12 groups a block, 8 of the 132 SMs took two
//    of the 140 blocks: 0.0043 ms against 0.0037); at 40 and 4 rows tiles
//    of 1 row, so the rows spread over the SMs.
//  * No division in the walk; the complex products are fmaf. The host
//    raises the kernel's shared-memory limit only above the default 48 KB,
//    once per (device, tile) and size.
//
// Measured: PERF.md, section 6 (molgym_tpu_torch/bench_encoder.py --kernels
// product and chip_smoke.py).
#include "cg_product_common.cuh"

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxGroups = 64;         // groups of 32 columns (K <= 2,048)

// x[r, 0..M) of the tile's rows into slot-major [M][ZS] float2, a 4-byte
// copy per value; the rows past a short tile keep what they held (their
// sums are not stored)
template <int ZS>
__device__ __forceinline__ void copy_slots(float2* dst, const float* x_r,
                                           const float* x_i, int n, int M) {
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
    const int r = idx / M;
    float2* d = dst + (idx - r * M) * ZS + r;
    cp_async4(&d->x, x_r + idx);
    cp_async4(&d->y, x_i + idx);
  }
}

// entry offsets of the column groups, passed by value: the kernel reads
// them from the constant bank, so no load from device memory stands before
// its copy of the entries
struct GroupOffsets {
  int at[kMaxGroups + 1];
};

template <int R>
__global__ void __launch_bounds__(kMaxThreads) cg_product_kernel(
    const float* __restrict__ a_r,      // [rows, M1]
    const float* __restrict__ a_i,      // [rows, M1]
    const float* __restrict__ b_r,      // [rows, M2]
    const float* __restrict__ b_i,      // [rows, M2]
    const __grid_constant__ GroupOffsets grp,   // [G + 1] entry offset of each group of 32 columns
    const int2* __restrict__ ent,       // [n_ent] (m << 16 | n, coef bits)
    float* __restrict__ out_r,          // [rows, K]
    float* __restrict__ out_i,          // [rows, K]
    int rows, int M1, int M2, int K, int G, int per_block, int ent_cap) {
  constexpr int ZS = slot_stride<R>();
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  int2* s_ent = reinterpret_cast<int2*>(base);          // [ent_cap]
  base += align16(sizeof(int2) * ent_cap);
  float2* s_a = reinterpret_cast<float2*>(base);        // [M1][ZS]
  base += align16(sizeof(float2) * M1 * ZS);
  float2* s_b = reinterpret_cast<float2*>(base);        // [M2][ZS]

  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int row0 = blockIdx.x * R;
  const int nr = min(R, rows - row0);
  const int g0 = blockIdx.y * per_block;
  const int g1 = min(G, g0 + per_block);

  copy_slots<ZS>(s_a, a_r + (size_t)row0 * M1, a_i + (size_t)row0 * M1,
                 nr * M1, M1);
  copy_slots<ZS>(s_b, b_r + (size_t)row0 * M2, b_i + (size_t)row0 * M2,
                 nr * M2, M2);
  // the chunk's entries: every group holds a multiple of 32, so the copy is
  // whole 16-byte pairs from a 16-byte aligned start
  const int e0 = grp.at[g0];
  const int n_pairs = (grp.at[g1] - e0) >> 1;
  for (int idx = threadIdx.x; idx < n_pairs; idx += blockDim.x)
    cp_async16(s_ent + 2 * idx, ent + e0 + 2 * idx);
  cp_async_wait_all();
  __syncthreads();

  // a warp per group of 32 columns, a lane per column, the R rows' sums in
  // registers; one entry serves all rows
  for (int g = g0 + warp; g < g1; g += n_warps) {
    float acc_r[R], acc_i[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc_r[r] = acc_i[r] = 0.f;
    const int2* col = s_ent + grp.at[g] - e0 + lane;
    const int trips = (grp.at[g + 1] - grp.at[g]) >> 5;
#pragma unroll 3
    for (int e = 0; e < trips; ++e) {
      const int2 v = col[e * kWarp];
      const float c = __int_as_float(v.y);
      float2 x[R], y[R];
      load_slot<R>(s_a + (v.x >> 16) * ZS, x);
      load_slot<R>(s_b + (v.x & 0xffff) * ZS, y);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float zr = fmaf(x[r].x, y[r].x, -x[r].y * y[r].y);
        const float zi = fmaf(x[r].x, y[r].y, x[r].y * y[r].x);
        acc_r[r] = fmaf(c, zr, acc_r[r]);
        acc_i[r] = fmaf(c, zi, acc_i[r]);
      }
    }
    const int k = g * kWarp + lane;
    if (k < K) {
      float* o_r = out_r + (size_t)row0 * K + k;
      float* o_i = out_i + (size_t)row0 * K + k;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < nr) {
          o_r[(size_t)r * K] = acc_r[r];
          o_i[(size_t)r * K] = acc_i[r];
        }
      }
    }
  }
}

typedef void (*Kernel)(const float*, const float*, const float*, const float*,
                       const GroupOffsets, const int2*, float*, float*, int,
                       int, int, int, int, int, int);

Kernel kernel_for(int rows_per_tile) {
  switch (rows_per_tile) {
    case 1: return cg_product_kernel<1>;
    case 4: return cg_product_kernel<4>;
    default: return nullptr;
  }
}

}  // namespace

// Resident blocks per SM of the instantiation for tiles of `rows_per_tile`
// rows at `threads` and `smem`, for a log line; -1 for a tile the kernel is
// not compiled for or a refused configuration.
extern "C" int cg_product_blocks_per_sm(int rows_per_tile, int threads, int smem) {
  Kernel kernel = kernel_for(rows_per_tile);
  if (kernel == nullptr || !allow_smem(kernel, rows_per_tile, smem)) return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads,
                                                    smem) != cudaSuccess)
    return -1;
  return blocks;
}

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// table has G <= 64 groups of whole warps of entries, their offsets
// `grp_ptr` [G + 1] in host memory; tiles of `rows_per_tile` rows (1 or 4)
// and chunks of `per_block` groups, a block each; the block's `threads`,
// the most entries of a chunk (`ent_cap`) and its shared bytes (`smem`)
// come from the host's plan (ops/fused_cg.py:product_fwd_plan).
extern "C" int cg_product_f32(
    const float* a_r, const float* a_i, const float* b_r, const float* b_i,
    const int* grp_ptr, const int* ent, float* out_r,
    float* out_i, int rows, int M1, int M2, int K, int G, int rows_per_tile,
    int per_block, int threads, int ent_cap, int smem, void* stream) {
  Kernel kernel = kernel_for(rows_per_tile);
  if (kernel == nullptr || M1 < 1 || M1 >= 65536 || M2 < 1 || M2 >= 65536 ||
      G < 1 || G > kMaxGroups || K > G * kWarp || per_block < 1 ||
      threads % kWarp != 0 || threads < kWarp || threads > kMaxThreads ||
      ent_cap < 0 || smem < 0)
    return (int)cudaErrorInvalidValue;
  if (!allow_smem(kernel, rows_per_tile, smem))
    return (int)cudaErrorInvalidConfiguration;
  GroupOffsets grp;
  for (int g = 0; g <= G; ++g) grp.at[g] = grp_ptr[g];
  if (rows > 0) {
    const dim3 grid((rows + rows_per_tile - 1) / rows_per_tile,
                    (G + per_block - 1) / per_block);
    kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
        a_r, a_i, b_r, b_i, grp, reinterpret_cast<const int2*>(ent),
        out_r, out_i, rows, M1, M2, K, G, per_block, ent_cap);
  }
  return (int)cudaGetLastError();
}
