// Fused joint gradient kernels: the gradients of the fused joint+loss to e,
// p, W and bias from the (B, T, U) coefficient fields, without the
// (B, T, U, V) logits or their gradient ever reaching device memory.
//
// Replaces: warp_transducer_tpu/ops/pallas/joint_fused.py::_grad_kernel
// (called through fused_grad and fused_grad_chunked).
//
// Per valid row r = (b, t, u), recomputing h = tanh(e[b,t] + p[b,u]) and each
// tile of logits = h·W + bias:
//   g = coef·exp(logits + denom) − cb·[v = blank] − ce·[v = label]
// in f32, both subtractions before any rounding of g (coef·p_label − ce is
// a difference of two O(1) terms). Then dh = g·Wᵀ, dW = hᵀ·g, db = Σ_rows g,
// and with d = dh·(1 − h²): de[b,t] = Σ_u d, dp[b,u] = Σ_t d. Rows outside
// (t < T_b) & (u < U_b) have zero coefficients and are never visited
// (joint.cuh numbers the valid rows only).
//
// Types as joint_prep.cu: e, p, bias and the fields in f32; W f32 or bf16.
// With bf16 W, h and g are rounded to bf16 before the three products (db
// sums the unrounded g, tanh' uses the unrounded h), each product exact in
// f32 and summed in f32.
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
//   joint_grad_sum_kernel adds in a fixed order: dW and db are deterministic.
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
  return sizeof(float) * ((size_t)Hp * (BM + 1) + wchunk + (size_t)kRowsBN * (BM + 1) + 4 * BM) +
         sizeof(int) * 4 * BM;
}

template <typename TW, bool kRound, int TM>
__global__ void __launch_bounds__(kThreads)
joint_grad_rows_kernel(const float* __restrict__ e, const float* __restrict__ p,
                       const TW* __restrict__ W, const float* __restrict__ bias,
                       const int* __restrict__ lab_full, Rows rows,
                       const float* __restrict__ denom, const float* __restrict__ coef,
                       const float* __restrict__ cb, const float* __restrict__ ce,
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
  int* s_b = reinterpret_cast<int*>(s_ce + BM);
  int* s_t = s_b + BM;
  int* s_u = s_t + BM;
  int* s_lab = s_u + BM;

  const int tid = threadIdx.x, tx = tid % kDim, ty = tid / kDim;
  place_rows<BM>(rows, first, s_b, s_t, s_u);
  __syncthreads();
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
#pragma unroll
    for (int j = 0; j < kRowsTN; ++j) {
      const int n = tx + kDim * j, v = v0 + n;
      const float bv = v < V ? bias[v] : 0.f;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int m = ty + kDim * i;
        float g = 0.f;
        if (v < V) {
          g = grad_element(acc[i][j] + bv, s_den[m], s_coef[m], s_cb[m], s_ce[m], v, blank,
                           s_lab[m]);
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

  // d = dh · (1 − h²) with the unrounded h, staged over hs as d[k·ldh + m].
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
        d = dh[i][j] * (1.f - h * h);
      }
      hs[k * ldh + m] = d;
    }
  }
  __syncthreads();
  for (int k = tid; k < H; k += kThreads) {
    float run = 0.f;
    for (int m = 0; m < BM; ++m) {
      const int b = s_b[m];
      if (b < 0) break;
      const float d = hs[k * ldh + m];
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

// ---- columns: dW, db --------------------------------------------------------

template <int TN>
size_t cols_smem_bytes(int H) {
  constexpr int BM = kDim * TN, BN = kDim * TN;
  const int Hp = (H + kBK - 1) / kBK * kBK;
  return sizeof(float) * ((size_t)Hp * (BN + 1) + (size_t)Hp * (BM + 1) + (size_t)BM * (BN + 1) +
                          4 * BM + kDim * BN) +
         sizeof(int) * 4 * BM;
}

template <typename TW, bool kRound, int TN>
__global__ void __launch_bounds__(kThreads)
joint_grad_cols_kernel(const float* __restrict__ e, const float* __restrict__ p,
                       const TW* __restrict__ W, const float* __restrict__ bias,
                       const int* __restrict__ lab_full, Rows rows,
                       const float* __restrict__ denom, const float* __restrict__ coef,
                       const float* __restrict__ cb, const float* __restrict__ ce,
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
  float* s_red = s_ce + BM;                 // kDim × BN, for db
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
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int v = v0 + tx + kDim * j;
    bv[j] = v < V ? bias[v] : 0.f;
  }

  float dW[KI][TN] = {};
  float db[TN] = {};
  const long long total = rows.offsets[rows.B];
  for (long long first = (long long)split * BM; first < total; first += (long long)nsplit * BM) {
    __syncthreads();  // the last tile's hs and gs consumed; wst complete
    place_rows<BM>(rows, first, s_b, s_t, s_u);
    __syncthreads();
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
                           s_lab[m]);
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

// out[i] = Σ_s part[s·n + i], added in the order of s.
__global__ void joint_grad_sum_kernel(const float* __restrict__ part, float* __restrict__ out,
                                      long long n, int nsplit) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < nsplit; ++k) s += part[(size_t)k * n + i];
  out[i] = s;
}

// ---- launches ---------------------------------------------------------------

struct Args {
  const float *e, *p;
  const void* W;
  const float* bias;
  const int* lab_full;
  Rows rows;
  const float *denom, *coef, *cb, *ce;
  int H, V, blank;
  cudaStream_t stream;
};

template <typename TW, bool kRound, int TM>
int launch_rows(const Args& a, float* de, float* dp) {
  auto kernel = joint_grad_rows_kernel<TW, kRound, TM>;
  const size_t bytes = rows_smem_bytes<TM>(a.H);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const long long cells = (long long)a.rows.B * a.rows.T * a.rows.U;
  const long long blocks = (cells + kDim * TM - 1) / (kDim * TM);
  kernel<<<(unsigned)blocks, kThreads, bytes, a.stream>>>(
      a.e, a.p, static_cast<const TW*>(a.W), a.bias, a.lab_full, a.rows, a.denom, a.coef, a.cb,
      a.ce, de, dp, a.H, a.V, a.blank);
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
      a.ce, nsplit > 1 ? dW_part : dW, nsplit > 1 ? db_part : db, a.H, a.V, a.blank);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return (int)err;
  const long long n = (long long)a.H * a.V;
  joint_grad_sum_kernel<<<(unsigned)((n + 255) / 256), 256, 0, a.stream>>>(dW_part, dW, n, nsplit);
  joint_grad_sum_kernel<<<(unsigned)((a.V + 255) / 256), 256, 0, a.stream>>>(db_part, db, a.V,
                                                                            nsplit);
  return (int)cudaGetLastError();
}

Args make_args(const void* e, const void* p, const void* W, const void* bias,
               const int* lab_full, const void* offsets, const int* label_lengths,
               const void* denom, const void* coef, const void* cb, const void* ce, int B, int T,
               int U, int H, int V, int blank, void* stream) {
  return Args{static_cast<const float*>(e), static_cast<const float*>(p), W,
              static_cast<const float*>(bias), lab_full,
              Rows{static_cast<const long long*>(offsets), label_lengths, B, T, U},
              static_cast<const float*>(denom), static_cast<const float*>(coef),
              static_cast<const float*>(cb), static_cast<const float*>(ce), H, V, blank,
              static_cast<cudaStream_t>(stream)};
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

// The inputs of wtt_joint_prep plus denom, coef, cb, ce: (B,T,U) f32.
// de: (B,T,H) f32 and dp: (B,U,H) f32, both zeroed by the caller (the kernel
// adds into them). Returns the launch's cudaError_t.
int wtt_joint_grad_rows(const void* e, const void* p, const void* W, int w_dtype,
                        const void* bias, const int* lab_full, const void* offsets,
                        const int* label_lengths, const void* denom, const void* coef,
                        const void* cb, const void* ce, void* de, void* dp, int B, int T, int U,
                        int H, int V, int blank, void* stream) {
  if ((long long)B * T * U == 0 || V == 0 || H == 0) return 0;
  if (H > kMaxH) return (int)cudaErrorInvalidValue;
  const Args a = make_args(e, p, W, bias, lab_full, offsets, label_lengths, denom, coef, cb, ce,
                           B, T, U, H, V, blank, stream);
  float* o1 = static_cast<float*>(de);
  float* o2 = static_cast<float*>(dp);
  const int tm = tile_param(H);
  if (w_dtype == wtt::kF32) {
    return tm == 4 ? launch_rows<float, false, 4>(a, o1, o2)
         : tm == 2 ? launch_rows<float, false, 2>(a, o1, o2)
                   : launch_rows<float, false, 1>(a, o1, o2);
  }
  if (w_dtype == wtt::kBF16) {
    return tm == 4 ? launch_rows<__nv_bfloat16, true, 4>(a, o1, o2)
         : tm == 2 ? launch_rows<__nv_bfloat16, true, 2>(a, o1, o2)
                   : launch_rows<__nv_bfloat16, true, 1>(a, o1, o2);
  }
  return (int)cudaErrorInvalidValue;
}

// dW: (H,V) f32 and db: (V,) f32, written whole. dW_part: (nsplit,H,V) f32
// and db_part: (nsplit,V) f32 scratch, unused when nsplit == 1. Returns the
// launches' cudaError_t.
int wtt_joint_grad_cols(const void* e, const void* p, const void* W, int w_dtype,
                        const void* bias, const int* lab_full, const void* offsets,
                        const int* label_lengths, const void* denom, const void* coef,
                        const void* cb, const void* ce, void* dW, void* db, void* dW_part,
                        void* db_part, int nsplit, int B, int T, int U, int H, int V, int blank,
                        void* stream) {
  if (V == 0 || H == 0) return 0;
  if (H > kMaxH || nsplit < 1) return (int)cudaErrorInvalidValue;
  const Args a = make_args(e, p, W, bias, lab_full, offsets, label_lengths, denom, coef, cb, ce,
                           B, T, U, H, V, blank, stream);
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

}  // extern "C"
