// The masked categorical head of the policy, forward and backward, f32, for
// Hopper (sm_90a): the masked softmax fused with what every head computes
// after it.
//
// Replaces molgym_tpu/ops/pallas_softmax.py:29 `_softmax_kernel` (the focus
// and element heads' masked softmax), and takes in with it the head's
// sampling, log-probability and entropy (molgym_tpu/distributions/
// discrete.py) and one backward for all of them, which the TPU kernel lacks.
// Per row of N entries:
//
//   x[n]  = mask[n] ? logits[n] : -1e9
//   p[n]  = mask[n] ? exp(x[n] - max x) / max(sum, 1e-20) : 0
//           (exact zeros where masked, a row of zeros where every entry is)
//   index = mode PROBS: none (the plain softmax); GIVEN: read from `index_in`;
//           GREEDY: the first n of the largest p (torch.argmax);
//           SAMPLE: Gumbel-max over the uniforms u, the first n of the
//             largest (log(max(p, 1e-10)) + (p > 0 ? 0 : -1e9))
//                      + (-log(-log(clamp(u[n], FLT_MIN, 1 - 1e-7))))
//           in the plain version's order of operations
//   logp  = log(max(p[index], 1e-10))       (NaN for an index outside [0, N))
//   ent   = -sum over p > 0 of p log(max(p, 1e-10))
//
// Backward: the exact vector-Jacobian product of that composition as torch's
// autograd takes it (clamp(min=eps) passes where p >= eps, the entropy's
// where(p > 0) passes nothing where p = 0, the row maximum carries nothing),
// from the saved p and index and the gradients g_p (may be absent), g_logp
// and g_ent:
//
//   g[n]       = g_p[n] + [n = index][p >= 1e-10] g_logp / p
//                + [p > 0] (-g_ent) (log(max(p, 1e-10)) + [p >= 1e-10] p / p)
//   dlogits[n] = p[n] (g[n] - sum_m g[m] p[m])       (zero where masked)
//
// Bound on the H100: bytes. A row's forward reads 4N logits, N mask bytes and,
// sampling, 4N uniforms, and writes 4N probs and 16 bytes (index, logp, ent);
// its backward reads 4N probs (and 4N g_p), the index and two gradients and
// writes 4N dlogits: 8N to 12N + 16 bytes. At the heads' [140, 7] that is
// 15.0 KB forward and 10.1 KB backward, 4.5 ns and 3.0 ns at 3.35 TB/s, a
// few thousandths of one launch; at [8192, 128] 13.8 MB and 8.5 MB, 4.1 us
// and 2.5 us.
//
// Design: the bound is nanoseconds at the heads' shapes, so the time a head
// costs is its launches, and the design removes launches and leaves bytes
// alone. The plain head is some 25 small PyTorch ops forward (softmax,
// Gumbel-max, gather, log, entropy) and 35 in autograd's backward; here it is
// one launch each way (and the caller's one torch.rand draw when sampling:
// the uniforms come from the caller's torch.Generator, so a trajectory keeps
// the draws, their shapes and their order, of the plain chain). What is left
// of a launch is latency, so each row's loads are issued together, before the
// first reduction: one warp per row, four rows a block, a lane holding its
// first K = 4 entries in registers (logits, mask and uniforms; backward:
// probs and their gradient), with the given index or the row's gradients
// beside them. The lanes stride over a longer row, so any N is taken, and
// read its rest again from L1. The reductions (max, sum, entropy, the first
// maximum, the backward's dot product) are warp shuffles in a fixed order:
// the same bits every run.
#include <cfloat>
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;
constexpr int K = 4;        // entries a lane keeps in registers
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG_INF = -1e9f;
constexpr float EPS = 1e-10f;
// torch's u.clamp(max=1.0 - 1e-7) on float32: the double rounded to float
constexpr float U_MAX = (float)(1.0 - 1e-7);

enum Mode { PROBS = 0, GIVEN = 1, GREEDY = 2, SAMPLE = 3 };

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// (v, i) comes before (w, j) as torch.argmax orders them: NaN above every
// number, then the larger value, then the lower index.
__device__ __forceinline__ bool before(float v, int i, float w, int j) {
  const bool nv = isnan(v), nw = isnan(w);
  if (nv != nw) return nv;
  if (!nv && v != w) return v > w;
  return i < j;
}

// the first maximum of the warp's (v, i) pairs, in every lane
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(FULL, v, o);
    const int j = __shfl_xor_sync(FULL, i, o);
    if (before(w, j, v, i)) {
      v = w;
      i = j;
    }
  }
}

template <int MODE>
__global__ void head_fwd_kernel(
    const float* __restrict__ logits,          // [rows, N]
    const unsigned char* __restrict__ mask,    // [rows, N], 0 = masked
    const float* __restrict__ u,               // [rows, N] (SAMPLE)
    const int64_t* __restrict__ index_in,      // [rows] (GIVEN)
    float* __restrict__ probs,                 // [rows, N]
    int64_t* __restrict__ index,               // [rows] (not PROBS)
    float* __restrict__ logp,                  // [rows] (not PROBS)
    float* __restrict__ ent,                   // [rows] (not PROBS)
    int rows, int N) {
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;                     // whole warps leave together
  const float* x = logits + (size_t)row * N;
  const unsigned char* mk = mask + (size_t)row * N;
  const float* ur = MODE == SAMPLE ? u + (size_t)row * N : nullptr;
  float* o = probs + (size_t)row * N;

  // every load at once, before the first reduction: the given index and the
  // lane's first K entries (the whole row up to N = 32 K)
  const int64_t given = MODE == GIVEN ? index_in[row] : 0;
  float xv[K], uv[K];
  bool mv[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int n = lane + 32 * k;
    mv[k] = n < N && mk[n];
    xv[k] = n < N ? x[n] : 0.f;
    uv[k] = MODE == SAMPLE && n < N ? ur[n] : 0.f;
  }
  // body(n, logit, kept, uniform) over the lane's entries: its registers,
  // then the rest of a longer row from memory (L1 after the first pass)
  auto each = [&](auto&& body) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (lane + 32 * k < N) body(lane + 32 * k, xv[k], mv[k], uv[k]);
    for (int n = lane + 32 * K; n < N; n += 32)
      body(n, x[n], mk[n] != 0, MODE == SAMPLE ? ur[n] : 0.f);
  };

  float vmax = NEG_INF;
  each([&](int, float xn, bool kept, float) {
    vmax = fmaxf(vmax, kept ? xn : NEG_INF);
  });
  vmax = warp_max(vmax);

  float sum = 0.f;
  each([&](int, float xn, bool kept, float) {
    if (kept) sum += expf(xn - vmax);
  });
  sum = fmaxf(warp_sum(sum), 1e-20f);

  float plogp = 0.f;                           // this lane's part of -ent
  float best = -INFINITY;                      // this lane's first maximum
  int arg = INT_MAX;
  each([&](int n, float xn, bool kept, float un) {
    const float p = kept ? expf(xn - vmax) / sum : 0.f;
    o[n] = p;
    if (MODE == PROBS) return;
    if (p > 0.f) plogp += p * logf(fmaxf(p, EPS));
    if (MODE == GREEDY || MODE == SAMPLE) {
      float score = p;
      if (MODE == SAMPLE) {
        const float uc = fminf(fmaxf(un, FLT_MIN), U_MAX);
        score = (logf(fmaxf(p, EPS)) + (p > 0.f ? 0.f : NEG_INF)) +
                (-logf(-logf(uc)));
      }
      if (before(score, n, best, arg)) {       // n grows: ties keep the first
        best = score;
        arg = n;
      }
    }
  });
  if (MODE == PROBS) return;
  plogp = warp_sum(plogp);
  int64_t idx = given;
  if (MODE != GIVEN) {
    warp_argmax(best, arg);
    idx = arg;
  }
  if (lane == 0) {
    float lp = NAN;
    if (idx >= 0 && idx < N) {                 // p[idx] again, the same bits
      const float p = mk[idx] ? expf(x[idx] - vmax) / sum : 0.f;
      lp = logf(fmaxf(p, EPS));
    }
    index[row] = idx;
    logp[row] = lp;
    ent[row] = -plogp;
  }
}

__global__ void head_bwd_kernel(
    const float* __restrict__ probs,           // [rows, N]
    const int64_t* __restrict__ index,         // [rows], or null
    const float* __restrict__ g_probs,         // [rows, N], or null
    const float* __restrict__ g_logp,          // row r at r * s_logp, or null
    int s_logp,
    const float* __restrict__ g_ent,           // row r at r * s_ent, or null
    int s_ent,
    float* __restrict__ dlogits,               // [rows, N]
    int rows, int N) {
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* p = probs + (size_t)row * N;
  const float* gp = g_probs ? g_probs + (size_t)row * N : nullptr;
  float* d = dlogits + (size_t)row * N;

  // every load at once, as in the forward
  const int64_t idx = (index && g_logp) ? index[row] : -1;
  const float gl = g_logp ? g_logp[(size_t)row * s_logp] : 0.f;
  const float ge = g_ent ? -g_ent[(size_t)row * s_ent] : 0.f;  // ent = -sum
  float pv[K], gv[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int n = lane + 32 * k;
    pv[k] = n < N ? p[n] : 0.f;
    gv[k] = gp && n < N ? gp[n] : 0.f;
  }

  // the gradient of the softmax's output at entry n, from g_p[n]
  auto grad = [&](int n, float pn, float g) {
    if (n == idx && pn >= EPS) g += gl / pn;
    if (g_ent && pn > 0.f) {
      g += ge * logf(fmaxf(pn, EPS));
      if (pn >= EPS) g += (ge * pn) / pn;
    }
    return g;
  };

  float dot = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (lane + 32 * k < N) {
      gv[k] = grad(lane + 32 * k, pv[k], gv[k]);
      dot += gv[k] * pv[k];
    }
  }
  for (int n = lane + 32 * K; n < N; n += 32)
    dot += grad(n, p[n], gp ? gp[n] : 0.f) * p[n];
  dot = warp_sum(dot);
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (lane + 32 * k < N) d[lane + 32 * k] = pv[k] * (gv[k] - dot);
  for (int n = lane + 32 * K; n < N; n += 32)
    d[n] = p[n] * (grad(n, p[n], gp ? gp[n] : 0.f) - dot);
}

template <int MODE>
void launch_fwd(const float* logits, const unsigned char* mask, const float* u,
                const int64_t* index_in, float* probs, int64_t* index,
                float* logp, float* ent, int rows, int N, cudaStream_t s) {
  const int blocks = (rows + WARPS - 1) / WARPS;
  head_fwd_kernel<MODE><<<blocks, 32 * WARPS, 0, s>>>(
      logits, mask, u, index_in, probs, index, logp, ent, rows, N);
}

}  // namespace

// Both launch on `stream` and return cudaGetLastError() (0 on success);
// cudaErrorInvalidValue for an unknown mode.
extern "C" int masked_categorical_f32(
    const float* logits, const unsigned char* mask, const float* u,
    const int64_t* index_in, float* probs, int64_t* index, float* logp,
    float* ent, int mode, int rows, int N, void* stream) {
  if (rows > 0 && N > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    switch (mode) {
      case PROBS:
        launch_fwd<PROBS>(logits, mask, u, index_in, probs, index, logp, ent,
                          rows, N, s);
        break;
      case GIVEN:
        launch_fwd<GIVEN>(logits, mask, u, index_in, probs, index, logp, ent,
                          rows, N, s);
        break;
      case GREEDY:
        launch_fwd<GREEDY>(logits, mask, u, index_in, probs, index, logp, ent,
                           rows, N, s);
        break;
      case SAMPLE:
        launch_fwd<SAMPLE>(logits, mask, u, index_in, probs, index, logp, ent,
                           rows, N, s);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

extern "C" int masked_categorical_bwd_f32(
    const float* probs, const int64_t* index, const float* g_probs,
    const float* g_logp, int s_logp, const float* g_ent, int s_ent,
    float* dlogits, int rows, int N, void* stream) {
  if (rows > 0 && N > 0) {
    const int blocks = (rows + WARPS - 1) / WARPS;
    head_bwd_kernel<<<blocks, 32 * WARPS, 0, (cudaStream_t)stream>>>(
        probs, index, g_probs, g_logp, s_logp, g_ent, s_ent, dlogits, rows, N);
  }
  return (int)cudaGetLastError();
}
