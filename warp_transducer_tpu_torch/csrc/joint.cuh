// Shared pieces of the fused joint+loss kernels (joint_prep.cu,
// joint_grad.cu, dur_head.cu): the compacted list of valid lattice rows, the
// tile of joint features h = tanh(e ⊕ p) in shared memory, the
// register-tiled f32 product on shared-memory operands, the per-row panels
// of the extra coefficient fields and of the duration head's cotangent, and
// the duration head's own products (D <= 8 columns: a warp's dot products
// going in, one thread per k coming back).
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
// Width of a per-row panel in shared memory: the K extra coefficient fields
// or the D duration columns of a row, padded with zeros.
constexpr int kPanel = wtt::kMaxExtraCols;

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

// The extra column that equals v, as its index k, or -1. Unrolled over the
// by-value table with constant indices, so the table stays in the
// parameter bank (its unused entries hold -1).
__device__ __forceinline__ int extra_index(const wtt::ExtraCols& cols, int v) {
  int k = -1;
#pragma unroll
  for (int i = 0; i < wtt::kMaxExtraCols; ++i)
    if (v == cols.col[i]) k = i;
  return k;
}

// Whether any extra column lies in [v0, v0 + width): the same answer for
// every thread of a block, so that the tiles without one (all but K of
// them) skip the per-column search.
__device__ __forceinline__ bool has_extra(const wtt::ExtraCols& cols, int v0, int width) {
  bool any = false;
#pragma unroll
  for (int i = 0; i < wtt::kMaxExtraCols; ++i)
    any |= cols.col[i] >= v0 && cols.col[i] < v0 + width;
  return any;
}

// One element of the dense gradient, formed in f32 before any rounding:
// coef·softmax(v) − cb·[v = blank] − ce·[v = label] − cx[xk] where column v
// is extra column xk (xk = -1: none). cx: the row's panel of extra fields.
__device__ __forceinline__ float grad_element(float logit, float denom, float coef, float cb,
                                              float ce, int v, int blank, int lab,
                                              const float* cx, int xk) {
  float g = coef * expf(logit + denom);
  if (v == blank) g -= cb;
  if (v == lab) g -= ce;
  if (xk >= 0) g -= cx[xk];
  return g;
}

// panel[m·kPanel + c] = src[cell(m)·C + c] for the tile's rows and c < C,
// zero for c >= C, for rows beyond the end and where src is null.
// src: (B, T, U, C).
template <int BM>
__device__ __forceinline__ void load_panel(float* panel, const float* __restrict__ src, int C,
                                           const int* s_b, const int* s_t, const int* s_u, int T,
                                           int U) {
  for (int idx = threadIdx.x; idx < BM * kPanel; idx += kThreads) {
    const int m = idx / kPanel, c = idx % kPanel;
    const int b = s_b[m];
    float x = 0.f;
    if (src != nullptr && b >= 0 && c < C)
      x = src[(((long long)b * T + s_t[m]) * U + s_u[m]) * C + c];
    panel[idx] = x;
  }
}

// d[k·ldh + m] of the tile's rows into de and dp. One thread per k sums the
// runs of rows that share (b, t) and adds each run to de with one atomicAdd
// (a run is cut only at a tile edge), and adds every row to dp.
template <int BM>
__device__ __forceinline__ void scatter_de_dp(const float* ds, int ldh, const int* s_b,
                                              const int* s_t, const int* s_u, const Rows& rows,
                                              int H, float* __restrict__ de,
                                              float* __restrict__ dp) {
  for (int k = threadIdx.x; k < H; k += kThreads) {
    float run = 0.f;
    for (int m = 0; m < BM; ++m) {
      const int b = s_b[m];
      if (b < 0) break;
      const float d = ds[k * ldh + m];
      atomicAdd(dp + ((long long)b * rows.U + s_u[m]) * H + k, d);
      run += d;
      const bool last = m + 1 == BM || s_b[m + 1] != b || s_t[m + 1] != s_t[m];
      if (last) {
        atomicAdd(de + ((long long)b * rows.T + s_t[m]) * H + k, run);
        run = 0.f;
      }
    }
  }
}

// The duration head of one row, by the calling warp:
// out[d] = Σ_k tanh(e_row[k] + p_row[k]) · Wd[k·D + d] for d < D, with the
// unrounded f32 h whatever the type of W (the token head's products round h
// to bf16 when W is bf16; this one never does). The lanes run along k;
// every lane returns every sum.
__device__ __forceinline__ void dur_row(const float* __restrict__ e_row,
                                        const float* __restrict__ p_row,
                                        const float* __restrict__ Wd, int H, int D, int lane,
                                        float (&out)[kPanel]) {
#pragma unroll
  for (int d = 0; d < kPanel; ++d) out[d] = 0.f;
  for (int k = lane; k < H; k += wtt::kWarp) {
    const float h = tanhf(e_row[k] + p_row[k]);
#pragma unroll
    for (int d = 0; d < kPanel; ++d)
      if (d < D) out[d] = fmaf(h, Wd[k * D + d], out[d]);
  }
#pragma unroll
  for (int d = 0; d < kPanel; ++d)
    if (d < D) out[d] = wtt::warp_sum(out[d]);
}

// dst[cell·D + d] = out[d] + bias_d[d], lane d writing column d (a select:
// no indexed copy of `out`).
__device__ __forceinline__ void store_dur_row(float* __restrict__ dst, const float (&out)[kPanel],
                                              const float* __restrict__ bias_d, int D, int lane) {
#pragma unroll
  for (int d = 0; d < kPanel; ++d)
    if (lane == d && d < D) dst[d] = out[d] + bias_d[d];
}

// Shared memory of dur_grad_tiles at this H and tile height.
inline size_t dur_grad_smem_bytes(int H, int BM) {
  const int Hp = (H + kBK - 1) / kBK * kBK;
  return sizeof(float) * ((size_t)Hp * (BM + 1) + (size_t)BM * kPanel) + sizeof(int) * 3 * BM;
}

// The duration head's gradient, the body of a block that walks every
// gridDim.x-th tile of BM valid rows. With the unrounded h of the tile in
// shared memory it accumulates its partial of dWd[k][d] = Σ_rows h[k]·g_dur[d]
// (thread tid owns k = tid + 256·q, in registers across the tiles) and,
// with kWithDh, adds d = (g_dur·Wdᵀ)·(1 − h²) into de and dp. The block's
// partial is written whole to dWd_part[blockIdx.x] (H × D), zeros when it met
// no tile; sum_parts_kernel adds the partials in a fixed order, so dWd does
// not depend on the order in which blocks ran. e, p: f32; g_dur: (B, T, U, D),
// zero outside the lattice; Wd: (H, D), read only with kWithDh.
template <int BM, bool kWithDh>
__device__ __forceinline__ void dur_grad_tiles(const float* __restrict__ e,
                                               const float* __restrict__ p,
                                               const float* __restrict__ Wd,
                                               const float* __restrict__ g_dur, const Rows& rows,
                                               float* __restrict__ de, float* __restrict__ dp,
                                               float* __restrict__ dWd_part, int H, int D,
                                               float* smem) {
  constexpr int KQ = kMaxH / kThreads;
  const int Hp = (H + kBK - 1) / kBK * kBK;
  const int ldh = BM + 1;
  float* hs = smem;                                 // Hp × ldh; then d in place
  float* s_gd = hs + (size_t)Hp * ldh;              // BM × kPanel
  int* s_b = reinterpret_cast<int*>(s_gd + BM * kPanel);
  int* s_t = s_b + BM;
  int* s_u = s_t + BM;
  const int tid = threadIdx.x;

  float acc[KQ][kPanel] = {};
  const long long total = rows.offsets[rows.B];
  for (long long first = (long long)blockIdx.x * BM; first < total;
       first += (long long)gridDim.x * BM) {
    __syncthreads();  // the last tile consumed
    place_rows<BM>(rows, first, s_b, s_t, s_u);
    __syncthreads();
    load_panel<BM>(s_gd, g_dur, D, s_b, s_t, s_u, rows.T, rows.U);
    fill_h<BM>(hs, ldh, e, p, s_b, s_t, s_u, rows.T, rows.U, H, Hp, false);
    __syncthreads();
#pragma unroll
    for (int q = 0; q < KQ; ++q) {
      const int k = tid + q * kThreads;
      if (k >= H) continue;
      for (int m = 0; m < BM; ++m) {
        const float h = hs[k * ldh + m];
#pragma unroll
        for (int d = 0; d < kPanel; ++d) acc[q][d] = fmaf(h, s_gd[m * kPanel + d], acc[q][d]);
      }
    }
    if (kWithDh) {
      __syncthreads();  // every h read before d takes its place
      for (int idx = tid; idx < BM * Hp; idx += kThreads) {
        const int m = idx / Hp, k = idx % Hp;
        float d = 0.f;
        if (k < H) {
          float dh = 0.f;
          for (int c = 0; c < D; ++c) dh = fmaf(s_gd[m * kPanel + c], Wd[k * D + c], dh);
          const float h = hs[k * ldh + m];
          d = dh * (1.f - h * h);
        }
        hs[k * ldh + m] = d;
      }
      __syncthreads();
      scatter_de_dp<BM>(hs, ldh, s_b, s_t, s_u, rows, H, de, dp);
    }
  }

  float* out = dWd_part + (size_t)blockIdx.x * H * D;
#pragma unroll
  for (int q = 0; q < KQ; ++q) {
    const int k = tid + q * kThreads;
    if (k >= H) continue;
#pragma unroll
    for (int d = 0; d < kPanel; ++d)
      if (d < D) out[k * D + d] = acc[q][d];
  }
}

// out[i] = Σ_s part[s·n + i], added in the order of s.
static __global__ void sum_parts_kernel(const float* __restrict__ part, float* __restrict__ out,
                                        long long n, int nsplit) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < nsplit; ++k) s += part[(size_t)k * n + i];
  out[i] = s;
}

// Launch sum_parts_kernel over n elements; returns the launch's error.
inline cudaError_t sum_parts(const float* part, float* out, long long n, int nsplit,
                             cudaStream_t stream) {
  sum_parts_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(part, out, n, nsplit);
  return cudaGetLastError();
}

}  // namespace joint
}  // namespace wtt
