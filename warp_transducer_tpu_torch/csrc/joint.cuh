// Shared pieces of the fused joint+loss kernels (joint_prep.cu,
// joint_grad.cu): the compacted list of valid lattice rows, the tile of joint
// features h = tanh(e ⊕ p) in shared memory, and the register-tiled f32
// product on shared-memory operands.
//
// Rows. A row is a lattice cell (b, t, u); only the cells inside each
// utterance's lattice, t < T_b and u < U_b, carry work. They are numbered
// b-major, then t, then u, through `offsets` (B+1 running sums of T_b·U_b),
// and a block takes a tile of consecutive numbers, so no block spends
// products on padding. The grid is sized for all B·T·U cells, since the
// host never reads the lengths; blocks beyond the last valid tile leave at
// once.
//
// Threads. 256 threads as a 16 × 16 grid (ty, tx). A thread's micro-tile is
// strided, rows ty + 16·i and columns tx + 16·j, so that its scalar reads of
// shared memory are free of bank conflicts with odd leading dimensions: the
// 16 tx lanes read 16 neighbouring words, the 2 ty values of a warp
// broadcast.
#pragma once

#include "common.cuh"

namespace wtt {
namespace joint {

constexpr int kThreads = 256;
constexpr int kDim = 16;  // the thread grid is kDim × kDim
constexpr int kBK = 16;   // depth of one streamed W chunk
constexpr int kMaxH = 1024;

// Tile parameter by H, shared by the three kernels: 4, 2 or 1 sixteens of
// rows (or of columns, for the column kernel) a block, so that a thread
// keeps 64 accumulators of an H-wide result in registers and the h tile
// stays near 64 KB of shared memory.
inline int tile_param(int H) { return H <= 256 ? 4 : H <= 512 ? 2 : 1; }

struct Rows {
  const long long* offsets;  // (B+1) running sums of valid cells
  const int* label_lengths;  // (B,)
  int B, T, U;
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Row number r -> (b, t, u); false when r is beyond the last valid row.
__device__ __forceinline__ bool locate(const Rows& rows, long long r, int& b, int& t, int& u) {
  if (r >= rows.offsets[rows.B]) return false;
  int lo = 0, hi = rows.B;  // offsets[lo] <= r < offsets[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (rows.offsets[mid] <= r) lo = mid; else hi = mid;
  }
  const int Ub = min(max(rows.label_lengths[lo] + 1, 0), rows.U);
  const long long local = r - rows.offsets[lo];
  b = lo;
  t = (int)(local / Ub);
  u = (int)(local % Ub);
  return true;
}

// The first BM threads place the tile's rows: s_b[m] = -1 beyond the end.
template <int BM>
__device__ __forceinline__ void place_rows(const Rows& rows, long long first, int* s_b, int* s_t,
                                           int* s_u) {
  if (threadIdx.x < BM) {
    int b = -1, t = 0, u = 0;
    if (!locate(rows, first + threadIdx.x, b, t, u)) b = -1;
    s_b[threadIdx.x] = b;
    s_t[threadIdx.x] = t;
    s_u[threadIdx.x] = u;
  }
}

// hs[k·ldh + m] = tanh(e[b,t,k] + p[b,u,k]) for the tile's rows, zero for
// k >= H and for rows beyond the end; rounded to bf16 when `round`. The
// lanes run along k, so the reads of e and p are contiguous.
template <int BM>
__device__ __forceinline__ void fill_h(float* hs, int ldh, const float* __restrict__ e,
                                       const float* __restrict__ p, const int* s_b,
                                       const int* s_t, const int* s_u, int T, int U, int H,
                                       int Hp, bool round) {
  for (int idx = threadIdx.x; idx < BM * Hp; idx += kThreads) {
    const int m = idx / Hp, k = idx % Hp;
    float h = 0.f;
    const int b = s_b[m];
    if (b >= 0 && k < H) {
      h = tanhf(e[((long long)b * T + s_t[m]) * H + k] + p[((long long)b * U + s_u[m]) * H + k]);
      if (round) h = round_bf16(h);
    }
    hs[k * ldh + m] = h;
  }
}

// acc[i][j] += Σ_kk A[kk·lda + ty + 16·i] · Bs[kk·ldb + tx + 16·j].
template <int TM, int TN>
__device__ __forceinline__ void mma_tile(float (&acc)[TM][TN], const float* A, int lda,
                                         const float* Bs, int ldb, int kcount, int ty, int tx) {
#pragma unroll 4
  for (int kk = 0; kk < kcount; ++kk) {
    float a[TM], b[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = A[kk * lda + ty + kDim * i];
#pragma unroll
    for (int j = 0; j < TN; ++j) b[j] = Bs[kk * ldb + tx + kDim * j];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Stage W[k0 : k0+kBK, v0 : v0+BN] as ws[kk·(BN+1) + n], zero outside (H, V).
template <int BN, typename TW>
__device__ __forceinline__ void load_w_chunk(float* ws, const TW* __restrict__ W, int H, int V,
                                             int k0, int v0) {
  for (int idx = threadIdx.x; idx < kBK * BN; idx += kThreads) {
    const int kk = idx / BN, n = idx % BN;
    const int k = k0 + kk, v = v0 + n;
    ws[kk * (BN + 1) + n] = (k < H && v < V) ? float(to_acc(W[(long long)k * V + v])) : 0.f;
  }
}

// One element of the dense gradient, formed in f32 before any rounding:
// coef·softmax(v) − cb·[v = blank] − ce·[v = label].
__device__ __forceinline__ float grad_element(float logit, float denom, float coef, float cb,
                                              float ce, int v, int blank, int lab) {
  float g = coef * expf(logit + denom);
  if (v == blank) g -= cb;
  if (v == lab) g -= ce;
  return g;
}

}  // namespace joint
}  // namespace wtt
