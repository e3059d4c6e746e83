// Fused joint gradient kernels: the gradients of the fused joint+loss to e,
// p, W and bias from the (B, T, U) coefficient fields, without the
// (B, T, U, V) logits or their gradient ever reaching device memory.
//
// Replaces: warp_transducer_tpu/ops/pallas/joint_fused.py::_grad_kernel
// (called through fused_grad and fused_grad_chunked; with its extra_cols
// through fused_grad_mb, the multi-blank loss; with its with_dur through
// fused_grad_tdt, the TDT loss).
//
// Per valid row r = (b, t, u), recomputing h = tanh(e[b,t] + p[b,u]) and each
// tile of logits = h·W + bias:
//   g = coef·exp(logits + denom) − cb·[v = blank] − ce·[v = label]
//       − Σ_k cx[r, k]·[v = col_k]
// in f32, every subtraction before any rounding of g (coef·p_label − ce is
// a difference of two O(1) terms). Then dh = g·Wᵀ, dW = hᵀ·g, db = Σ_rows g,
// and with d = dh·(1 − h²): de[b,t] = Σ_u d, dp[b,u] = Σ_t d. With a duration
// head, its cotangent g_dur (B, T, U, D) joins dh as g_dur·Wdᵀ before the
// (1 − h²), and dWd = hᵀ·g_dur. Rows outside (t < T_b) & (u < U_b) have zero
// coefficients and are never visited (joint.cuh numbers the valid rows only).
// K and D are run-time numbers (0: none), at most 8 each; the rows' K fields
// and D cotangents sit in shared memory beside cb and ce.
//
// Types as joint_prep.cu: e, p, bias and the fields in f32; W f32 or bf16.
// With bf16 W, h and g are rounded to bf16 before the three products (db
// sums the unrounded g, tanh' uses the unrounded h), each product exact in
// f32 and summed in f32. The duration head's two products take the unrounded
// h, f32 Wd and f32 g_dur in both cases.
//
// Bound on this card: operations, 3 · 2·R·H·V over the float32 rate.
//
// Design. The TPU kernel's grid runs in order on one core and carries dW and
// db across every step and dp across the T tiles of one b. Here blocks run in
// parallel and nothing carries over, and one H × V partial of dW per row
// tile would be billions of atomics. So the work is split into two kernels
// that each own what they sum, at the price of computing the logits twice
// (four products in place of three):
//
// * joint_grad_rows_kernel — row-parallel. A block owns a tile of valid rows,
//   walks all of V, forms each g tile in registers, stages it in shared
//   memory and accumulates dh for its rows in registers (64 accumulators a
//   thread: 16·TM rows × H columns, TM = 4, 2, 1 for H ≤ 256, 512, 1024). At
//   the end d = dh·(1 − h²) goes through shared memory; one thread per k
//   sums the runs of rows that share (b, t) and adds each run to de with one
//   atomicAdd (a run is cut only at a tile edge, so with U_b ≤ the tile's
//   rows at most two blocks add to an element and the sum does not depend on
//   their order), and adds every row to dp with an atomicAdd (T_b terms per
//   element, in an order that varies from run to run).
// * joint_grad_cols_kernel — column-parallel. A block owns a stripe of V
//   (16·TN columns, TN = 4, 2, 1 by H as above) and keeps W's stripe in
//   shared memory and its H × stripe slice of dW and its slice of db in
//   registers. It walks every `nsplit`-th row tile, recomputes h and the
//   logits of its stripe, forms g and accumulates hᵀ·g. Slices are written
//   once, with no atomics, into one of `nsplit` partial buffers, which
//   sum_parts_kernel adds in a fixed order: dW and db are deterministic.
// * joint_grad_dwd_kernel — dWd (H, D), with a duration head only. It is a sum
//   over every valid row, like dW, but of the unrounded h, which neither
//   kernel above holds when W is bf16, and H·D is 1,024 addresses: an
//   atomicAdd a block would be thousands of blocks contending for them, in an
//   order that changes from run to run. So a third, light kernel
//   (joint.cuh::dur_grad_tiles) walks the row tiles once more with the
//   unrounded h tile, a few hundred blocks each owning one partial of dWd in
//   registers, and sum_parts_kernel adds the partials in a fixed order: dWd is
//   deterministic too, at the price of R·H more tanh (the products are 2·R·H·D
//   operations beside the token head's 8·R·H·V).
#include "joint.cuh"

namespace {

using namespace wtt::joint;

constexpr int kNB = 16;  // columns of one W chunk of the dh product

// ---- rows: dh, de, dp -------------------------------------------------------

constexpr int kRowsTN = 8;
constexpr int kRowsBN = kDim * kRowsTN;  // 128 columns a V tile

template <int TM>
size_t rows_smem_bytes(int H) {
  constexpr int BM = kDim * TM;
  const int Hp = (H + kBK - 1) / kBK * kBK;
  const size_t wchunk = (size_t)kBK * (kRowsBN + 1) > (size_t)Hp * (kNB + 1)
                            ? (size_t)kBK * (kRowsBN + 1) : (size_t)Hp * (kNB + 1);
  return sizeof(float) * ((size_t)Hp * (BM + 1) + wchunk + (size_t)kRowsBN * (BM + 1) +
                          (4 + 2 * kPanel) * BM) +
         sizeof(int) * 4 * BM;
}

template <typename TW, bool kRound, int TM>
__global__ void __launch_bounds__(kThreads)
joint_grad_rows_kernel(const float* __restrict__ e, const float* __restrict__ p,
                       const TW* __restrict__ W, const float* __restrict__ bias,
                       const int* __restrict__ lab_full, Rows rows,
                       const float* __restrict__ denom, const float* __restrict__ coef,
                       const float* __restrict__ cb, const float* __restrict__ ce,
                       const float* __restrict__ cx, const wtt::ExtraCols cols,
                       const float* __restrict__ Wd, const float* __restrict__ g_dur, int D,
                       float* __restrict__ de, float* __restrict__ dp, int H, int V, int blank) {
  constexpr int BM = kDim * TM;
  constexpr int KJ = 64 / TM;  // dh columns a thread: k = tx + 16·j
  const long long first = (long long)blockIdx.x * BM;
  if (first >= rows.offsets[rows.B]) return;
  const int Hp = (H + kBK - 1) / kBK * kBK;
  const int ldh = BM + 1;
  extern __shared__ float smem[];
  float* hs = smem;  // Hp × ldh; at the end it holds d
  const size_t wchunk = (size_t)kBK * (kRowsBN + 1) > (size_t)Hp * (kNB + 1)
                            ? (size_t)kBK * (kRowsBN + 1) : (size_t)Hp * (kNB + 1);
  float* ws = hs + (size_t)Hp * ldh;  // a chunk of W for either product
  float* gs = ws + wchunk;            // kRowsBN × ldh, gs[n·ldh + m]
  float* s_den = gs + (size_t)kRowsBN * ldh;
  float* s_coef = s_den + BM;
  float* s_cb = s_coef + BM;
  float* s_ce = s_cb + BM;
  float* s_cx = s_ce + BM;           // BM × kPanel extra fields
  float* s_gd = s_cx + BM * kPanel;  // BM × kPanel duration cotangents
  int* s_b = reinterpret_cast<int*>(s_gd + BM * kPanel);
  int* s_t = s_b + BM;
  int* s_u = s_t + BM;
  int* s_lab = s_u + BM;

  const int tid = threadIdx.x, tx = tid % kDim, ty = tid / kDim;
  place_rows<BM>(rows, first, s_b, s_t, s_u);
  __syncthreads();
  load_panel<BM>(s_cx, cx, cols.n, s_b, s_t, s_u, rows.T, rows.U);
  load_panel<BM>(s_gd, g_dur, D, s_b, s_t, s_u, rows.T, rows.U);
  if (tid < BM) {
    const int b = s_b[tid];
    const bool on = b >= 0;
    const long long cell = on ? ((long long)b * rows.T + s_t[tid]) * rows.U + s_u[tid] : 0;
    s_lab[tid] = on ? lab_full[(long long)b * rows.U + s_u[tid]] : -1;
    s_den[tid] = on ? denom[cell] : 0.f;
    s_coef[tid] = on ? coef[cell] : 0.f;
    s_cb[tid] = on ? cb[cell] : 0.f;
    s_ce[tid] = on ? ce[cell] : 0.f;
  }
  fill_h<BM>(hs, ldh, e, p, s_b, s_t, s_u, rows.T, rows.U, H, Hp, kRound);
  __syncthreads();

  float dh[TM][KJ] = {};
  for (int v0 = 0; v0 < V; v0 += kRowsBN) {
    float acc[TM][kRowsTN] = {};
    for (int k0 = 0; k0 < Hp; k0 += kBK) {
      load_w_chunk<kRowsBN>(ws, W, H, V, k0, v0);
      __syncthreads();
      mma_tile<TM, kRowsTN>(acc, hs + k0 * ldh, ldh, ws, kRowsBN + 1, kBK, ty, tx);
      __syncthreads();
    }
    const bool extras_here = has_extra(cols, v0, kRowsBN);
#pragma unroll
    for (int j = 0; j < kRowsTN; ++j) {
      const int n = tx + kDim * j, v = v0 + n;
      const float bv = v < V ? bias[v] : 0.f;
      const int xk = extras_here ? extra_index(cols, v) : -1;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int m = ty + kDim * i;
        float g = 0.f;
        if (v < V) {
          g = grad_element(acc[i][j] + bv, s_den[m], s_coef[m], s_cb[m], s_ce[m], v, blank,
                           s_lab[m], s_cx + m * kPanel, xk);
          if (kRound) g = round_bf16(g);
        }
        gs[n * ldh + m] = g;
      }
    }
    // dh[m][k] += Σ_n g[m][n] · W[k][v0 + n], W staged kNB columns at a time
    // as ws[k·(kNB+1) + nn].
    const int n_end = min(kRowsBN, V - v0);
    for (int nc = 0; nc < n_end; nc += kNB) {
      __syncthreads();  // gs complete (first pass); the last chunk consumed
      for (int idx = tid; idx < Hp * kNB; idx += kThreads) {
        const int k = idx / kNB, nn = idx % kNB, v = v0 + nc + nn;
        ws[k * (kNB + 1) + nn] =
            (k < H && v < V) ? float(wtt::to_acc(W[(long long)k * V + v])) : 0.f;
      }
      __syncthreads();
#pragma unroll 2
      for (int nn = 0; nn < kNB; ++nn) {
        float a[TM], w[KJ];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = gs[(nc + nn) * ldh + ty + kDim * i];
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          const int k = tx + kDim * j;
          w[j] = k < Hp ? ws[k * (kNB + 1) + nn] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < KJ; ++j) dh[i][j] = fmaf(a[i], w[j], dh[i][j]);
      }
    }
    __syncthreads();  // before the next tile overwrites ws and gs
  }

  // d = (dh + g_dur·Wdᵀ) · (1 − h²) with the unrounded h, staged over hs as
  // d[k·ldh + m].
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = ty + kDim * i, b = s_b[m];
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      const int k = tx + kDim * j;
      if (k >= Hp) continue;
      float d = 0.f;
      if (b >= 0 && k < H) {
        const float h = tanhf(e[((long long)b * rows.T + s_t[m]) * H + k] +
                              p[((long long)b * rows.U + s_u[m]) * H + k]);
        float dh_k = dh[i][j];
        for (int c = 0; c < D; ++c) dh_k = fmaf(s_gd[m * kPanel + c], Wd[k * D + c], dh_k);
        d = dh_k * (1.f - h * h);
      }
      hs[k * ldh + m] = d;
    }
  }
  __syncthreads();
  scatter_de_dp<BM>(hs, ldh, s_b, s_t, s_u, rows, H, de, dp);
}

// ---- columns: dW, db --------------------------------------------------------

template <int TN>
size_t cols_smem_bytes(int H) {
  constexpr int BM = kDim * TN, BN = kDim * TN;
  const int Hp = (H + kBK - 1) / kBK * kBK;
  return sizeof(float) * ((size_t)Hp * (BN + 1) + (size_t)Hp * (BM + 1) + (size_t)BM * (BN + 1) +
                          (4 + kPanel) * BM + kDim * BN) +
         sizeof(int) * 4 * BM;
}

template <typename TW, bool kRound, int TN>
__global__ void __launch_bounds__(kThreads)
joint_grad_cols_kernel(const float* __restrict__ e, const float* __restrict__ p,
                       const TW* __restrict__ W, const float* __restrict__ bias,
                       const int* __restrict__ lab_full, Rows rows,
                       const float* __restrict__ denom, const float* __restrict__ coef,
                       const float* __restrict__ cb, const float* __restrict__ ce,
                       const float* __restrict__ cx, const wtt::ExtraCols cols,
                       float* __restrict__ dW_part, float* __restrict__ db_part, int H, int V,
                       int blank) {
  constexpr int TM = TN;
  constexpr int BM = kDim * TM, BN = kDim * TN;
  constexpr int KI = 64 / TN;  // dW rows a thread: k = ty + 16·i
  const int Hp = (H + kBK - 1) / kBK * kBK;
  const int ldh = BM + 1, ldw = BN + 1;
  extern __shared__ float smem[];
  float* wst = smem;                        // Hp × ldw, W's stripe
  float* hs = wst + (size_t)Hp * ldw;       // Hp × ldh
  float* gs = hs + (size_t)Hp * ldh;        // BM × ldw, gs[m·ldw + n]
  float* s_den = gs + (size_t)BM * ldw;
  float* s_coef = s_den + BM;
  float* s_cb = s_coef + BM;
  float* s_ce = s_cb + BM;
  float* s_cx = s_ce + BM;                  // BM × kPanel extra fields
  float* s_red = s_cx + BM * kPanel;        // kDim × BN, for db
  int* s_b = reinterpret_cast<int*>(s_red + kDim * BN);
  int* s_t = s_b + BM;
  int* s_u = s_t + BM;
  int* s_lab = s_u + BM;

  const int tid = threadIdx.x, tx = tid % kDim, ty = tid / kDim;
  const int v0 = blockIdx.x * BN;
  const int split = blockIdx.y, nsplit = gridDim.y;
  for (int idx = tid; idx < Hp * BN; idx += kThreads) {
    const int k = idx / BN, n = idx % BN, v = v0 + n;
    wst[k * ldw + n] = (k < H && v < V) ? float(wtt::to_acc(W[(long long)k * V + v])) : 0.f;
  }
  float bv[TN];
  int xk[TN];  // the extra column this thread's column j is, or -1
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int v = v0 + tx + kDim * j;
    bv[j] = v < V ? bias[v] : 0.f;
    xk[j] = extra_index(cols, v);
  }

  float dW[KI][TN] = {};
  float db[TN] = {};
  const long long total = rows.offsets[rows.B];
  for (long long first = (long long)split * BM; first < total; first += (long long)nsplit * BM) {
    __syncthreads();  // the last tile's hs and gs consumed; wst complete
    place_rows<BM>(rows, first, s_b, s_t, s_u);
    __syncthreads();
    load_panel<BM>(s_cx, cx, cols.n, s_b, s_t, s_u, rows.T, rows.U);
    if (tid < BM) {
      const int b = s_b[tid];
      const bool on = b >= 0;
      const long long cell = on ? ((long long)b * rows.T + s_t[tid]) * rows.U + s_u[tid] : 0;
      s_lab[tid] = on ? lab_full[(long long)b * rows.U + s_u[tid]] : -1;
      s_den[tid] = on ? denom[cell] : 0.f;
      s_coef[tid] = on ? coef[cell] : 0.f;
      s_cb[tid] = on ? cb[cell] : 0.f;
      s_ce[tid] = on ? ce[cell] : 0.f;
    }
    fill_h<BM>(hs, ldh, e, p, s_b, s_t, s_u, rows.T, rows.U, H, Hp, kRound);
    __syncthreads();
    float acc[TM][TN] = {};
    mma_tile<TM, TN>(acc, hs, ldh, wst, ldw, Hp, ty, tx);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = tx + kDim * j, v = v0 + n;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int m = ty + kDim * i;
        float g = 0.f;
        if (v < V) {  // rows beyond the end have zero coefficients
          g = grad_element(acc[i][j] + bv[j], s_den[m], s_coef[m], s_cb[m], s_ce[m], v, blank,
                           s_lab[m], s_cx + m * kPanel, xk[j]);
          db[j] += g;
          if (kRound) g = round_bf16(g);
        }
        gs[m * ldw + n] = g;
      }
    }
    __syncthreads();
    // dW[k][n] += Σ_m h[m][k] · g[m][n]
#pragma unroll 2
    for (int m = 0; m < BM; ++m) {
      float a[KI], g[TN];
#pragma unroll
      for (int i = 0; i < KI; ++i) {
        const int k = ty + kDim * i;
        a[i] = k < Hp ? hs[k * ldh + m] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) g[j] = gs[m * ldw + tx + kDim * j];
#pragma unroll
      for (int i = 0; i < KI; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) dW[i][j] = fmaf(a[i], g[j], dW[i][j]);
    }
  }

  float* out = dW_part + (size_t)split * H * V;
#pragma unroll
  for (int i = 0; i < KI; ++i) {
    const int k = ty + kDim * i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int v = v0 + tx + kDim * j;
      if (k < H && v < V) out[(long long)k * V + v] = dW[i][j];
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < TN; ++j) s_red[ty * BN + tx + kDim * j] = db[j];
  __syncthreads();
  if (tid < BN && v0 + tid < V) {
    float s = 0.f;
    for (int r = 0; r < kDim; ++r) s += s_red[r * BN + tid];
    db_part[(size_t)split * V + v0 + tid] = s;
  }
}

// ---- dWd ---------------------------------------------------------------------

template <int TM>
__global__ void __launch_bounds__(kThreads)
joint_grad_dwd_kernel(const float* __restrict__ e, const float* __restrict__ p,
                      const float* __restrict__ g_dur, Rows rows, float* __restrict__ dWd_part,
                      int H, int D) {
  extern __shared__ float smem[];
  dur_grad_tiles<kDim * TM, false>(e, p, nullptr, g_dur, rows, nullptr, nullptr, dWd_part, H, D,
                                   smem);
}

// ---- launches ---------------------------------------------------------------

struct Args {
  const float *e, *p;
  const void* W;
  const float* bias;
  const int* lab_full;
  Rows rows;
  const float *denom, *coef, *cb, *ce, *cx;
  wtt::ExtraCols cols;
  int H, V, blank;
  cudaStream_t stream;
};

template <typename TW, bool kRound, int TM>
int launch_rows(const Args& a, const float* Wd, const float* g_dur, int D, float* de, float* dp) {
  auto kernel = joint_grad_rows_kernel<TW, kRound, TM>;
  const size_t bytes = rows_smem_bytes<TM>(a.H);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const long long cells = (long long)a.rows.B * a.rows.T * a.rows.U;
  const long long blocks = (cells + kDim * TM - 1) / (kDim * TM);
  kernel<<<(unsigned)blocks, kThreads, bytes, a.stream>>>(
      a.e, a.p, static_cast<const TW*>(a.W), a.bias, a.lab_full, a.rows, a.denom, a.coef, a.cb,
      a.ce, a.cx, a.cols, Wd, g_dur, D, de, dp, a.H, a.V, a.blank);
  return (int)cudaGetLastError();
}

template <typename TW, bool kRound, int TN>
int launch_cols(const Args& a, float* dW, float* db, float* dW_part, float* db_part,
                int nsplit) {
  auto kernel = joint_grad_cols_kernel<TW, kRound, TN>;
  const size_t bytes = cols_smem_bytes<TN>(a.H);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int stripes = (a.V + kDim * TN - 1) / (kDim * TN);
  // With one split the slices are the results themselves.
  kernel<<<dim3(stripes, nsplit), kThreads, bytes, a.stream>>>(
      a.e, a.p, static_cast<const TW*>(a.W), a.bias, a.lab_full, a.rows, a.denom, a.coef, a.cb,
      a.ce, a.cx, a.cols, nsplit > 1 ? dW_part : dW, nsplit > 1 ? db_part : db, a.H, a.V,
      a.blank);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return (int)err;
  err = sum_parts(dW_part, dW, (long long)a.H * a.V, nsplit, a.stream);
  if (err != cudaSuccess) return (int)err;
  return (int)sum_parts(db_part, db, a.V, nsplit, a.stream);
}

template <int TM>
int launch_dwd(const float* e, const float* p, const float* g_dur, Rows rows, float* dWd,
               float* dWd_part, int nsplit, int H, int D, cudaStream_t stream) {
  auto kernel = joint_grad_dwd_kernel<TM>;
  const size_t bytes = dur_grad_smem_bytes(H, kDim * TM);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<nsplit, kThreads, bytes, stream>>>(e, p, g_dur, rows, dWd_part, H, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)sum_parts(dWd_part, dWd, (long long)H * D, nsplit, stream);
}

// False when the extra columns are not K <= 8 indices inside [0, V) with
// their fields.
bool make_args(Args* a, const void* e, const void* p, const void* W, const void* bias,
               const int* lab_full, const void* offsets, const int* label_lengths,
               const void* denom, const void* coef, const void* cb, const void* ce,
               const void* cx, const int* extra_cols, int K, int B, int T, int U, int H, int V,
               int blank, void* stream) {
  *a = Args{static_cast<const float*>(e), static_cast<const float*>(p), W,
            static_cast<const float*>(bias), lab_full,
            Rows{static_cast<const long long*>(offsets), label_lengths, B, T, U},
            static_cast<const float*>(denom), static_cast<const float*>(coef),
            static_cast<const float*>(cb), static_cast<const float*>(ce),
            static_cast<const float*>(cx), wtt::ExtraCols{}, H, V, blank,
            static_cast<cudaStream_t>(stream)};
  return wtt::extra_cols(extra_cols, K, V, &a->cols) && (K == 0 || cx != nullptr);
}

}  // namespace

extern "C" {

// The largest H the joint kernels' register tiling covers.
int wtt_joint_max_h() { return kMaxH; }

// Dynamic shared memory the two kernels ask for at this H (the larger).
long long wtt_joint_grad_smem(int H) {
  size_t r, c;
  switch (tile_param(H)) {
    case 4: r = rows_smem_bytes<4>(H); c = cols_smem_bytes<4>(H); break;
    case 2: r = rows_smem_bytes<2>(H); c = cols_smem_bytes<2>(H); break;
    default: r = rows_smem_bytes<1>(H); c = cols_smem_bytes<1>(H); break;
  }
  return (long long)(r > c ? r : c);
}

// Columns of V one block of the column kernel owns at this H.
int wtt_joint_grad_stripe(int H) { return kDim * tile_param(H); }

// The inputs of wtt_joint_prep plus denom, coef, cb, ce: (B,T,U) f32, and
// cx: (B,T,U,K) f32 for the K columns extra_cols (a host array; K = 0: cx
// unused). Wd: (H,D) f32 and g_dur: (B,T,U,D) f32, zero outside the lattice
// (D = 0: both unused). de: (B,T,H) f32 and dp: (B,U,H) f32, both zeroed by
// the caller (the kernel adds into them). Returns the launch's cudaError_t.
int wtt_joint_grad_rows(const void* e, const void* p, const void* W, int w_dtype,
                        const void* bias, const int* lab_full, const void* offsets,
                        const int* label_lengths, const void* denom, const void* coef,
                        const void* cb, const void* ce, const void* cx, const int* extra_cols,
                        int K, const void* Wd, const void* g_dur, int D, void* de, void* dp,
                        int B, int T, int U, int H, int V, int blank, void* stream) {
  if ((long long)B * T * U == 0 || V == 0 || H == 0) return 0;
  if (H > kMaxH || D < 0 || D > kPanel || (D > 0 && (Wd == nullptr || g_dur == nullptr)))
    return (int)cudaErrorInvalidValue;
  Args a;
  if (!make_args(&a, e, p, W, bias, lab_full, offsets, label_lengths, denom, coef, cb, ce, cx,
                 extra_cols, K, B, T, U, H, V, blank, stream))
    return (int)cudaErrorInvalidValue;
  const float* wd = static_cast<const float*>(Wd);
  const float* gd = static_cast<const float*>(g_dur);
  float* o1 = static_cast<float*>(de);
  float* o2 = static_cast<float*>(dp);
  const int tm = tile_param(H);
  if (w_dtype == wtt::kF32) {
    return tm == 4 ? launch_rows<float, false, 4>(a, wd, gd, D, o1, o2)
         : tm == 2 ? launch_rows<float, false, 2>(a, wd, gd, D, o1, o2)
                   : launch_rows<float, false, 1>(a, wd, gd, D, o1, o2);
  }
  if (w_dtype == wtt::kBF16) {
    return tm == 4 ? launch_rows<__nv_bfloat16, true, 4>(a, wd, gd, D, o1, o2)
         : tm == 2 ? launch_rows<__nv_bfloat16, true, 2>(a, wd, gd, D, o1, o2)
                   : launch_rows<__nv_bfloat16, true, 1>(a, wd, gd, D, o1, o2);
  }
  return (int)cudaErrorInvalidValue;
}

// dW: (H,V) f32 and db: (V,) f32, written whole. dW_part: (nsplit,H,V) f32
// and db_part: (nsplit,V) f32 scratch, unused when nsplit == 1. Returns the
// launches' cudaError_t.
int wtt_joint_grad_cols(const void* e, const void* p, const void* W, int w_dtype,
                        const void* bias, const int* lab_full, const void* offsets,
                        const int* label_lengths, const void* denom, const void* coef,
                        const void* cb, const void* ce, const void* cx, const int* extra_cols,
                        int K, void* dW, void* db, void* dW_part, void* db_part, int nsplit,
                        int B, int T, int U, int H, int V, int blank, void* stream) {
  if (V == 0 || H == 0) return 0;
  if (H > kMaxH || nsplit < 1) return (int)cudaErrorInvalidValue;
  Args a;
  if (!make_args(&a, e, p, W, bias, lab_full, offsets, label_lengths, denom, coef, cb, ce, cx,
                 extra_cols, K, B, T, U, H, V, blank, stream))
    return (int)cudaErrorInvalidValue;
  float* o1 = static_cast<float*>(dW);
  float* o2 = static_cast<float*>(db);
  float* s1 = static_cast<float*>(dW_part);
  float* s2 = static_cast<float*>(db_part);
  const int tn = tile_param(H);
  if (w_dtype == wtt::kF32) {
    return tn == 4 ? launch_cols<float, false, 4>(a, o1, o2, s1, s2, nsplit)
         : tn == 2 ? launch_cols<float, false, 2>(a, o1, o2, s1, s2, nsplit)
                   : launch_cols<float, false, 1>(a, o1, o2, s1, s2, nsplit);
  }
  if (w_dtype == wtt::kBF16) {
    return tn == 4 ? launch_cols<__nv_bfloat16, true, 4>(a, o1, o2, s1, s2, nsplit)
         : tn == 2 ? launch_cols<__nv_bfloat16, true, 2>(a, o1, o2, s1, s2, nsplit)
                   : launch_cols<__nv_bfloat16, true, 1>(a, o1, o2, s1, s2, nsplit);
  }
  return (int)cudaErrorInvalidValue;
}

// dWd: (H,D) f32 = hᵀ·g_dur with the unrounded h, written whole. e, p,
// offsets, label_lengths as above; g_dur: (B,T,U,D) f32, zero outside the
// lattice; dWd_part: (nsplit,H,D) f32 scratch, one partial a block. Returns
// the launches' cudaError_t.
int wtt_joint_grad_dwd(const void* e, const void* p, const void* offsets,
                       const int* label_lengths, const void* g_dur, void* dWd, void* dWd_part,
                       int nsplit, int B, int T, int U, int H, int D, void* stream) {
  if (H == 0 || D == 0) return 0;
  if (H > kMaxH || D < 0 || D > kPanel || nsplit < 1) return (int)cudaErrorInvalidValue;
  const Rows rows{static_cast<const long long*>(offsets), label_lengths, B, T, U};
  const float* ef = static_cast<const float*>(e);
  const float* pf = static_cast<const float*>(p);
  const float* gd = static_cast<const float*>(g_dur);
  float* o = static_cast<float*>(dWd);
  float* part = static_cast<float*>(dWd_part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile_param(H)) {
    case 4: return launch_dwd<4>(ef, pf, gd, rows, o, part, nsplit, H, D, s);
    case 2: return launch_dwd<2>(ef, pf, gd, rows, o, part, nsplit, H, D, s);
    default: return launch_dwd<1>(ef, pf, gd, rows, o, part, nsplit, H, D, s);
  }
}

}  // extern "C"
