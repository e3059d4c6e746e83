// Fused joint gradient kernels: the gradients of the fused joint+loss to e,
// p, W and bias from the (B, T, U) coefficient fields, without the
// (B, T, U, V) logits or their gradient ever reaching device memory whole.
//
// Replaces: warp_transducer_tpu/ops/pallas/joint_fused.py::_grad_kernel
// (called through fused_grad and fused_grad_chunked; with its extra_cols
// through fused_grad_mb, the multi-blank loss; with its with_dur through
// fused_grad_tdt, the TDT loss).
//
// Per valid row r = (b, t, u), recomputing h = tanh(e[b,t] + p[b,u]) and
// logits = h·W + bias:
//   g = coef·exp(logits + denom) − cb·[v = blank] − ce·[v = label]
//       − Σ_k cx[r, k]·[v = col_k]
// in f32, every subtraction before any rounding of g (coef·p_label − ce is
// a difference of two O(1) terms). Then dh = g·Wᵀ, dW = hᵀ·g, db = Σ_rows g,
// and with d = dh·(1 − h²): de[b,t] = Σ_u d, dp[b,u] = Σ_t d. With a duration
// head, its cotangent g_dur (B, T, U, D) joins dh as g_dur·Wdᵀ before the
// (1 − h²), and dWd = hᵀ·g_dur. Rows outside (t < T_b) & (u < U_b) have zero
// coefficients and are never visited (joint.cuh numbers the valid rows only).
// K and D are run-time numbers (0: none), at most 8 each.
//
// Types as joint_prep.cu: e, p, bias and the fields in f32; W f32 or bf16.
// With bf16 W, h and g are rounded to bf16 before the three products (db
// sums the unrounded g, tanh' uses the unrounded h, recomputed from e and
// p), which run on the tensor cores with f32 sums; g is formed in f32 from
// the f32 accumulators and rounded only after every subtraction. With f32 W
// each product is three TF32 products of the split operands (joint.cuh,
// Op<float>): f32 accuracy on the tensor cores. The duration head's two
// products take the unrounded h, f32 Wd and f32 g_dur in both cases.
//
// Bound on this card: operations, 3 · 2·R·H·V over the tensor cores' rate
// (989 TFLOP/s bf16; 495 / 3 with f32 W). The kernels perform exactly those
// three products (the logits once, where the design before computed them
// twice, and twice more for every pass over H above 1024), plus the bytes of
// g of each chunk of rows, written once in two layouts and read once in each.
//
// Design. The gradient runs a chunk of rows at a time (the wrapper's loop;
// the chunk's buffers, joint.cuh::plan, stay within 128 MB), every product on
// the wgmma engine of joint.cuh with 128 × 128 tiles of two warpgroups:
// * the row launch (this file): joint_h_kernel (joint_prep.cu) writes the
//   chunk's h and hᵀ; joint_grad_g_kernel computes the logits of a 128-row,
//   128-column tile (A = h, B = Wᵀ, over Hp), forms g in f32 in the epilogue
//   and writes it through shared memory as g (chunk × Vp) and gᵀ (Vp ×
//   chunk) in the operand type, and the tile's column sums of the unrounded
//   g to a partial of db; joint_grad_dh_kernel computes a 128 × 128 tile of
//   dh = g·Wᵀ (A = g, B = W) over its span of V (the sum over V is split
//   where the chunk's tiles of dh are too few to fill the card) into an f32
//   partial; joint_grad_d_kernel adds the partials, adds g_dur·Wdᵀ,
//   multiplies by (1 − h²) with h recomputed unrounded, and adds each row to
//   dp and each run of rows that share (b, t) to de with atomics (a run is
//   cut every 8 rows, a thread's share), so de and dp are sums in an order
//   that varies from run to run.
// * the column launch (joint_grad_cols.cu): dW += hᵀ·g over the chunk, and
//   db += the chunk's partials, in a fixed order: dW and db are
//   bit-reproducible.
// No kernel holds an H-wide sum, and every operand streams through the ring
// in k-slices, so the same kernels serve every H.
// * joint_grad_dwd_kernel — dWd (H, D), with a duration head only. It is a sum
//   over every valid row, like dW, but of the unrounded h, which the products
//   do not hold when W is bf16, and H·D is few addresses: an atomicAdd a block
//   would be thousands of blocks contending for them, in an order that
//   changes from run to run. So a light kernel of its own
//   (joint.cuh::dur_grad_tiles) walks the row tiles once more with the
//   unrounded h tile, a few hundred blocks each owning one partial of dWd in
//   registers, and sum_parts_kernel adds the partials in a fixed order: dWd is
//   deterministic too, at the price of R·H more tanh (the products are 2·R·H·D
//   operations beside the token head's 6·R·H·V).
#include "joint.cuh"

extern "C" int wtt_joint_weights(const void* W, int w_dtype, int H, int V, void* wt, void* wp,
                                 void* stream);
extern "C" int wtt_joint_h(const void* e, const void* p, const void* offsets,
                           const int* label_lengths, int B, int T, int U, int H,
                           long long row_begin, int chunk, int w_dtype, void* h, void* ht,
                           void* stream);

namespace {

using namespace wtt::joint;

// ---- g ----------------------------------------------------------------------------

// A block: rows first .. first + 127 of the chunk (chunk-local tile
// blockIdx.x) and columns v0 .. v0 + 127 of Vp (blockIdx.y).
template <typename TW>
__global__ void __launch_bounds__(kThreads, 1)
joint_grad_g_kernel(const typename Op<TW>::T* __restrict__ h,
                    const typename Op<TW>::T* __restrict__ wt, int chunk,
                    const float* __restrict__ bias, const int* __restrict__ lab_full, Rows rows,
                    long long row_begin, const float* __restrict__ denom,
                    const float* __restrict__ coef, const float* __restrict__ cb,
                    const float* __restrict__ ce, const float* __restrict__ cx,
                    const wtt::ExtraCols cols, int H, int V, int blank,
                    typename Op<TW>::T* __restrict__ g, typename Op<TW>::T* __restrict__ gt,
                    float* __restrict__ db_part) {
  using O = Op<TW>;
  using T = typename O::T;
  constexpr int KS = O::kKS;
  const long long first = row_begin + (long long)blockIdx.x * kBM;
  if (first >= rows.offsets[rows.B]) return;
  const int Hp = pad128(H), Vp = pad128(V), v0 = blockIdx.y * kBN;
  extern __shared__ __align__(128) unsigned char joint_smem[];
  unsigned char* ring = joint_smem;
  uint64_t* bars = reinterpret_cast<uint64_t*>(joint_smem + kRingBytes<TW>);
  float* s_den = reinterpret_cast<float*>(joint_smem + kRingBytes<TW> + kBars);
  float* s_coef = s_den + kBM;
  float* s_cb = s_coef + kBM;
  float* s_ce = s_cb + kBM;
  float* s_cx = s_ce + kBM;  // kBM × kPanel extra fields
  int* s_b = reinterpret_cast<int*>(s_cx + kBM * kPanel);
  int* s_t = s_b + kBM;
  int* s_u = s_t + kBM;
  int* s_lab = s_u + kBM;
  float* s_bias = reinterpret_cast<float*>(s_lab + kBM);  // of the tile's columns
  int* s_xk = reinterpret_cast<int*>(s_bias + kBN);       // their extra index, or -1

  const int tid = threadIdx.x;
  place_rows<kBM>(rows, first, s_b, s_t, s_u);
  __syncthreads();
  load_panel<kBM>(s_cx, cx, cols.n, s_b, s_t, s_u, rows.T, rows.U);
  if (tid < kBM) {
    const int b = s_b[tid];
    const bool on = b >= 0;
    const long long cell = on ? ((long long)b * rows.T + s_t[tid]) * rows.U + s_u[tid] : 0;
    s_lab[tid] = on ? lab_full[(long long)b * rows.U + s_u[tid]] : -1;
    s_den[tid] = on ? denom[cell] : 0.f;
    s_coef[tid] = on ? coef[cell] : 0.f;
    s_cb[tid] = on ? cb[cell] : 0.f;
    s_ce[tid] = on ? ce[cell] : 0.f;
  } else {
    const int n = tid - kBM, v = v0 + n;
    s_bias[n] = v < V ? bias[v] : 0.f;
    s_xk[n] = extra_index(cols, v);
  }

  const Frag f;
  float acc[64], part[64];
  const long long m0 = first - row_begin;
  const Src<T> a = row_tile<TW>(h, blockIdx.x, Hp, (long long)chunk * Hp);
  const Src<T> b = row_tile<TW>(wt, blockIdx.y, Hp, (long long)Vp * Hp);
  run_ring<kStageBytes<TW>>(
      Hp / KS, ring, bars,
      [&](int i, unsigned char* stage, uint32_t bar) { load_stage<TW>(stage, bar, a, i, b, i); },
      [&](int i, uint32_t stage) { mma_step<TW>(acc, part, stage, f.wg, i == 0); });

  // g in f32, staged over the ring (gs[m·kGLd + n]); zero past V and past
  // the last row (whose coefficients are zero).
  float* gs = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = f.row0 + 8 * r;
      float out[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int n = 8 * j + f.tq2 + q, v = v0 + n;
        out[q] = v < V && s_b[m] >= 0
                     ? grad_element(acc[4 * j + 2 * r + q] + s_bias[n], s_den[m], s_coef[m],
                                    s_cb[m], s_ce[m], v, blank, s_lab[m], s_cx + m * kPanel,
                                    s_xk[n])
                     : 0.f;
      }
      *reinterpret_cast<float2*>(gs + m * kGLd + 8 * j + f.tq2) = make_float2(out[0], out[1]);
    }
  __syncthreads();
  const long long gn = (long long)chunk * Vp;
  // g (chunk rows, Vp columns) and gᵀ (Vp rows, chunk columns) in tiles, a
  // warp writing 8 rows × 4 pieces a step.
  constexpr int E = O::kE, P = kBN / E;
  for (int idx = tid; idx < kBM * P; idx += kThreads) {
    const int rr = idx & 7, c = (idx >> 3) % P, m = (idx >> 3) / P * 8 + rr;
    float x[E];
#pragma unroll
    for (int q = 0; q < E; ++q) x[q] = gs[m * kGLd + c * E + q];
    O::put_piece(g, gn, tiled<TW>(m0 + m, v0 + c * E, Vp), x);
  }
  for (int idx = tid; idx < kBN * P; idx += kThreads) {
    const int rr = idx & 7, c = (idx >> 3) % P, n = (idx >> 3) / P * 8 + rr;
    float x[E];
#pragma unroll
    for (int q = 0; q < E; ++q) x[q] = gs[(c * E + q) * kGLd + n];
    O::put_piece(gt, gn, tiled<TW>(v0 + n, (int)m0 + c * E, chunk), x);
  }
  // db's partial of this tile: the column's 128 unrounded g, in row order.
  if (tid < kBN) {
    float s = 0.f;
    for (int m = 0; m < kBM; ++m) s += gs[m * kGLd + tid];
    db_part[(long long)blockIdx.x * Vp + v0 + tid] = s;
  }
}

// ---- dh, de, dp -------------------------------------------------------------------

// A block: the 128 × 128 tile of dh at rows first .. first + 127 (chunk-local
// tile blockIdx.x) and columns k0 .. k0 + 127 of Hp (blockIdx.y), summed over
// the columns of V of its split (blockIdx.z: Vp in gridDim.z spans of whole
// 128-column tiles), written to its f32 partial dh_part[z] (chunk × Hp, row
// major).
template <typename TW>
__global__ void __launch_bounds__(kThreads, 1)
joint_grad_dh_kernel(const typename Op<TW>::T* __restrict__ g,
                     const typename Op<TW>::T* __restrict__ wp, int chunk, Rows rows,
                     long long row_begin, float* __restrict__ dh_part, int H, int V) {
  using O = Op<TW>;
  using T = typename O::T;
  constexpr int KT = kBN / O::kKS;  // k-slices a 128-column tile of V
  const long long first = row_begin + (long long)blockIdx.x * kBM;
  if (first >= rows.offsets[rows.B]) return;
  const int Hp = pad128(H), Vp = pad128(V), k0 = blockIdx.y * kBN;
  const int span = (Vp / kBN + gridDim.z - 1) / gridDim.z;  // V tiles a split
  const int t0 = blockIdx.z * span, t1 = min(Vp / kBN, t0 + span);
  extern __shared__ __align__(128) unsigned char joint_smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(joint_smem + kRingBytes<TW>);
  const Frag f;
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;  // a split with no tiles writes zeros
  const Src<T> a = row_tile<TW>(g, blockIdx.x, Vp, (long long)chunk * Vp);
  const Src<T> b = row_tile<TW>(wp, blockIdx.y, Vp, (long long)Hp * Vp);
  auto load = [&](int i, unsigned char* stage, uint32_t bar) {
    load_stage<TW>(stage, bar, a, t0 * KT + i, b, t0 * KT + i);
  };
  const int n = t1 > t0 ? (t1 - t0) * KT : 0;
  run_ring<kStageBytes<TW>>(n, joint_smem, bars, load, [&](int i, uint32_t stage) {
    mma_step<TW>(acc, part, stage, f.wg, i == 0);
  });
  float* out = dh_part + (long long)blockIdx.z * chunk * Hp + (first - row_begin) * Hp + k0;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(out + (long long)(f.row0 + 8 * r) * Hp + 8 * j + f.tq2) =
          make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
}

// d = (Σ_z dh_part[z] + g_dur·Wdᵀ) · (1 − h²) with the unrounded h, of
// kDRows·2 rows (blockIdx.x) and 128 columns k0 .. k0 + 127 (blockIdx.y), a
// thread a column and kDRows rows: each row to dp, each run of rows that
// share (b, t) to de, one atomicAdd a run (a run is cut every kDRows rows).
// Short row spans keep the grid wide: a thread's rows are serial.
constexpr int kDRows = 8;
constexpr int kDTile = 2 * kDRows;  // rows a block

__global__ void __launch_bounds__(kThreads)
joint_grad_d_kernel(const float* __restrict__ dh_part, int nsplit, int chunk, Rows rows,
                    long long row_begin, const float* __restrict__ e,
                    const float* __restrict__ p, const float* __restrict__ Wd,
                    const float* __restrict__ g_dur, int D, float* __restrict__ de,
                    float* __restrict__ dp, int H) {
  __shared__ float s_gd[kDTile * kPanel];
  __shared__ int s_b[kDTile], s_t[kDTile], s_u[kDTile];
  const long long first = row_begin + (long long)blockIdx.x * kDTile;
  if (first >= rows.offsets[rows.B]) return;
  const int Hp = pad128(H), tid = threadIdx.x;
  place_rows<kDTile>(rows, first, s_b, s_t, s_u);
  __syncthreads();
  load_panel<kDTile>(s_gd, g_dur, D, s_b, s_t, s_u, rows.T, rows.U);
  __syncthreads();
  const int k = blockIdx.y * kBN + (tid & 127), m1 = (tid >> 7) * kDRows + kDRows;
  if (k >= H) return;
  const long long m0 = first - row_begin;
  float run = 0.f;
  for (int m = m1 - kDRows; m < m1; ++m) {
    const int b = s_b[m];
    if (b < 0) break;
    float dh = 0.f;
    for (int z = 0; z < nsplit; ++z) dh += dh_part[((long long)z * chunk + m0 + m) * Hp + k];
    for (int c = 0; c < D; ++c) dh = fmaf(s_gd[m * kPanel + c], Wd[k * D + c], dh);
    const float hv = tanhf(e[((long long)b * rows.T + s_t[m]) * H + k] +
                           p[((long long)b * rows.U + s_u[m]) * H + k]);
    const float d = dh * (1.f - hv * hv);
    atomicAdd(dp + ((long long)b * rows.U + s_u[m]) * H + k, d);
    run += d;
    const bool last = m + 1 == m1 || s_b[m + 1] != b || s_t[m + 1] != s_t[m];
    if (last) {
      atomicAdd(de + ((long long)b * rows.T + s_t[m]) * H + k, run);
      run = 0.f;
    }
  }
}

// ---- dWd ---------------------------------------------------------------------

template <int TM>
__global__ void __launch_bounds__(kThreads)
joint_grad_dwd_kernel(const float* __restrict__ e, const float* __restrict__ p,
                      const float* __restrict__ g_dur, Rows rows, float* __restrict__ dWd_part,
                      int H, int D) {
  extern __shared__ float smem[];
  dur_grad_tiles<kDim * TM>(e, p, g_dur, rows, dWd_part, H, D, smem);
}

// ---- launches ---------------------------------------------------------------

// What the row launch takes beside GradArgs: the duration head, de and dp,
// the chunk, the splits of dh's sum over V and the scratch buffers (joint.py
// allocates them).
struct RowsArgs {
  const float *Wd, *g_dur;
  int D;
  float *de, *dp;
  long long row_begin;
  int chunk, dh_split;
  void *wt, *wp, *h, *ht, *g, *gt;
  float *db_part, *dh_part;
};

template <typename TW>
int launch_rows(const GradArgs& a, const RowsArgs& r, int w_dtype) {
  using T = typename Op<TW>::T;
  const Plan q = plan<TW>(a.H, a.V, 0);
  int err = 0;
  if (r.row_begin == 0) {  // the first chunk lays W out for the whole call
    err = wtt_joint_weights(a.W, w_dtype, a.H, a.V, r.wt, r.wp, a.stream);
    if (err != 0) return err;
  }
  err = wtt_joint_h(a.e, a.p, a.rows.offsets, a.rows.label_lengths, a.rows.B, a.rows.T, a.rows.U,
                    a.H, r.row_begin, r.chunk, w_dtype, r.h, r.ht, a.stream);
  if (err != 0) return err;
  err = (int)launch(joint_grad_g_kernel<TW>, dim3(r.chunk / kBM, q.vp / kBN), (size_t)q.g_smem,
                    a.stream, static_cast<const T*>(r.h), static_cast<const T*>(r.wt), r.chunk,
                    a.bias, a.lab_full, a.rows, r.row_begin, a.denom, a.coef, a.cb, a.ce, a.cx,
                    a.cols, a.H, a.V, a.blank, static_cast<T*>(r.g), static_cast<T*>(r.gt),
                    r.db_part);
  if (err != 0) return err;
  err = (int)launch(joint_grad_dh_kernel<TW>, dim3(r.chunk / kBM, q.hp / kBN, r.dh_split),
                    (size_t)q.dh_smem, a.stream, static_cast<const T*>(r.g),
                    static_cast<const T*>(r.wp), r.chunk, a.rows, r.row_begin, r.dh_part, a.H,
                    a.V);
  if (err != 0) return err;
  joint_grad_d_kernel<<<dim3(r.chunk / kDTile, q.hp / kBN), kThreads, 0, a.stream>>>(
      r.dh_part, r.dh_split, r.chunk, a.rows, r.row_begin, a.e, a.p, r.Wd, r.g_dur, r.D, r.de,
      r.dp, a.H);
  return (int)cudaGetLastError();
}

template <typename TW>
int attrs(int which, int* regs, int* local_bytes) {
  return which == 0 ? kernel_attrs(joint_grad_g_kernel<TW>, regs, local_bytes)
                    : kernel_attrs(joint_grad_dh_kernel<TW>, regs, local_bytes);
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

}  // namespace

extern "C" {

// Dynamic shared memory the row launch's engine kernels ask for at this H
// (the larger of the g and dh kernels and of the two W types).
long long wtt_joint_grad_rows_smem(int H) {
  const Plan f = plan<float>(H, 1, 0), b = plan<__nv_bfloat16>(H, 1, 0);
  long long m = f.g_smem > f.dh_smem ? f.g_smem : f.dh_smem;
  m = b.g_smem > m ? b.g_smem : m;
  return b.dh_smem > m ? b.dh_smem : m;
}

// Dynamic shared memory the dWd kernel asks for at this H.
long long wtt_joint_grad_dwd_smem(int H) {
  return (long long)dur_grad_smem_bytes(H, kDim * dwd_tile(H));
}

// Registers a thread and local (spill) bytes of joint_grad_g_kernel (which
// = 0) or joint_grad_dh_kernel (1) with W of this type, as ptxas compiled
// it. Returns the cudaError_t of the query.
int wtt_joint_grad_rows_attrs(int which, int w_dtype, int* regs, int* local_bytes) {
  switch (w_dtype) {
    case wtt::kF32: return attrs<float>(which, regs, local_bytes);
    case wtt::kBF16: return attrs<__nv_bfloat16>(which, regs, local_bytes);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The inputs of wtt_joint_prep plus denom, coef, cb, ce: (B,T,U) f32, and
// cx: (B,T,U,K) f32 for the K columns extra_cols (a host array; K = 0: cx
// unused). Wd: (H,D) f32 and g_dur: (B,T,U,D) f32, zero outside the lattice
// (D = 0: both unused). de: (B,T,H) f32 and dp: (B,U,H) f32, both zeroed by
// the caller (the kernels add into them). The launches cover the valid rows
// row_begin .. row_begin + chunk − 1 (row_begin and chunk multiples of 128).
// Scratch, in W's operand type (bf16, or f32 as tf32 hi then lo): wt (Vp,
// Hp) and wp (Hp, Vp), laid out here when row_begin is 0 and read by every
// chunk after; the chunk's h (chunk, Hp), ht (Hp, chunk), g (chunk, Vp) and
// gt (Vp, chunk), which the column launch reads, all stored in tiles
// (joint.cuh::tiled); db_part (chunk / 128, Vp) f32; dh_part (dh_split,
// chunk, Hp) f32, dh's sum over V in dh_split spans of whole 128-column
// tiles. Returns the launches' cudaError_t.
int wtt_joint_grad_rows(const void* e, const void* p, const void* W, int w_dtype,
                        const void* bias, const int* lab_full, const void* offsets,
                        const int* label_lengths, const void* denom, const void* coef,
                        const void* cb, const void* ce, const void* cx, const int* extra_cols,
                        int K, const void* Wd, const void* g_dur, int D, void* de, void* dp,
                        long long row_begin, int chunk, int dh_split, void* wt, void* wp, void* h,
                        void* ht, void* g, void* gt, void* db_part, void* dh_part, int B, int T,
                        int U, int H, int V, int blank, void* stream) {
  if ((long long)B * T * U == 0 || V == 0 || H == 0) return 0;
  if (D < 0 || D > kPanel || (D > 0 && (Wd == nullptr || g_dur == nullptr)) || chunk < kBM ||
      chunk % kBM != 0 || row_begin % kBM != 0 || dh_split < 1)
    return (int)cudaErrorInvalidValue;
  GradArgs a;
  if (!make_grad_args(&a, e, p, W, bias, lab_full, offsets, label_lengths, denom, coef, cb, ce,
                      cx, extra_cols, K, B, T, U, H, V, blank, stream))
    return (int)cudaErrorInvalidValue;
  const RowsArgs r{static_cast<const float*>(Wd), static_cast<const float*>(g_dur), D,
                   static_cast<float*>(de), static_cast<float*>(dp), row_begin, chunk, dh_split,
                   wt, wp, h, ht, g, gt, static_cast<float*>(db_part),
                   static_cast<float*>(dh_part)};
  if (w_dtype == wtt::kF32) return launch_rows<float>(a, r, w_dtype);
  if (w_dtype == wtt::kBF16) return launch_rows<__nv_bfloat16>(a, r, w_dtype);
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
  if (D < 0 || D > kPanel || nsplit < 1) return (int)cudaErrorInvalidValue;
  const Rows rows{static_cast<const long long*>(offsets), label_lengths, B, T, U};
  const float* ef = static_cast<const float*>(e);
  const float* pf = static_cast<const float*>(p);
  const float* gd = static_cast<const float*>(g_dur);
  float* o = static_cast<float*>(dWd);
  float* part = static_cast<float*>(dWd_part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dwd_tile(H)) {
    case 4: return launch_dwd<4>(ef, pf, gd, rows, o, part, nsplit, H, D, s);
    case 2: return launch_dwd<2>(ef, pf, gd, rows, o, part, nsplit, H, D, s);
    default: return launch_dwd<1>(ef, pf, gd, rows, o, part, nsplit, H, D, s);
  }
}

}  // extern "C"
