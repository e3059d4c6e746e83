// Prep kernel: per (b, t, u) row of the (B, T, U, V) activations, the
// log-softmax denominator and the blank and label log-probs.
//
// Replaces: warp_transducer_tpu/ops/pallas/prep_fused.py:31 (_kernel), the
// TPU's one-read prep, there gated to V >= 512 by the TPU's (8, 128) lane
// tiling. Here it is the prep at every V.
//
// Bound on this card: bytes. Every activation is read once (B·T·U·V
// elements in their own type) and three (B,T,U) fields are written; the
// arithmetic (a compare, a subtract and an exp per element) is far below
// the 67 TFLOP/s float32 rate at 3.35 TB/s.
//
// Design: the tiled row reductions of reduce.cuh. At small V (the
// reference's V = 28 and 50) a row is a few hundred bytes and a warp a row
// spends its time on latency: a lane reads one element, then the warp
// shuffles ten times and one lane divides and loads the label. So a block
// takes a tile of rows, rows·V contiguous elements, with 16-byte loads
// across row boundaries all in flight at once, reduces each row from
// shared memory with a few threads, and a thread a row emits the row's
// outputs, coalesced across the tile, reading x[blank], x[y_u] and the
// extra columns from shared memory. Above reduce.cuh's switch point a
// warp takes a row, by vectors, kUnroll of them a lane in flight. The
// label's row (b, u) comes from two multiply-high divisions by magic
// numbers made on the host. bf16/f16 are read natively and accumulate in
// f32, f64 in f64. With log_probs_input nothing is reduced and the row is
// read only at the columns it emits.
//
// Outputs per row: lpb = x[blank] + d, lpe = x[y_u] + d (NEG at u = U-1 or
// for a label outside [0, V)), denom = d = −logsumexp(x), and, for the K
// extra columns (the big blanks of the multi-blank loss; the JAX package's
// prep.onepass_stats(extra_cols=...)), extras[row, k] = x[cols[k]] + d.
// Every row is computed; the kernel takes no lengths. K has no cap: up to
// 8 columns come by value, unrolled (the instances the main shapes run);
// past 8 the kernels of their own (prep_many_tile_kernel,
// prep_many_warp_kernel) read the columns from a table in device memory in
// a loop at run time, the rest of the row's work unchanged.
#include "reduce.cuh"

namespace {

namespace red = wtt::reduce;

template <typename TIn, typename TAcc>
struct PrepOp {
  using Tin = TIn;
  using Tacc = TAcc;
  const Tin* acts;
  const int* labels;  // (B, U)
  Tacc *lpb, *lpe, *denom, *extras;
  wtt::ExtraCols cols;
  long long rows;
  int T, U, V, blank;
  bool reduce;
  red::Plan plan;
  unsigned u_mul, tu_mul;  // division by U and by T·U
  int u_shr, tu_shr;

  // A row's label and whether it is in the last column (u = U-1).
  struct Stage {
    int lab, last;
  };
  __device__ __forceinline__ Stage stage(int row) const {
    const int bt = red::div_by(row, u_mul, u_shr, U), u = row - bt * U;
    const int b = red::div_by(row, tu_mul, tu_shr, T * U);
    return Stage{labels[b * U + u], u == U - 1};
  }
  template <class Read>
  __device__ __forceinline__ void emit(int row, Tacc d, const Read& x, const Stage& st) const {
    const int lab = st.lab;
    const Tacc xe = (lab >= 0 && lab < V) ? x(lab) : Tacc(wtt::kNeg);
    lpb[row] = x(blank) + d;
    lpe[row] = st.last ? Tacc(wtt::kNeg) : xe + d;
    if (denom != nullptr) denom[row] = d;
#pragma unroll
    for (int k = 0; k < wtt::kMaxExtraCols; ++k)
      if (k < cols.n) extras[(long long)row * cols.n + k] = x(cols.col[k]) + d;
  }
};

// K > kMaxExtraCols extra columns: their indices in a device table, read
// in a loop at run time (cols.n = K).
template <typename TIn, typename TAcc>
struct ManyPrepOp : PrepOp<TIn, TAcc> {
  using Tacc = TAcc;
  const int* table;  // (K,) int32 in device memory

  template <class Read>
  __device__ __forceinline__ void emit(int row, Tacc d, const Read& x,
                                       const typename PrepOp<TIn, TAcc>::Stage& st) const {
    const int lab = st.lab, K = this->cols.n;
    const Tacc xe = (lab >= 0 && lab < this->V) ? x(lab) : Tacc(wtt::kNeg);
    this->lpb[row] = x(this->blank) + d;
    this->lpe[row] = st.last ? Tacc(wtt::kNeg) : xe + d;
    if (this->denom != nullptr) this->denom[row] = d;
    Tacc* out = this->extras + (long long)row * K;
    for (int k = 0; k < K; ++k) out[k] = x(__ldg(table + k)) + d;
  }
};

template <typename Tin, typename Tacc, int VEC>
__global__ void __launch_bounds__(red::kThreads) prep_tile_kernel(const PrepOp<Tin, Tacc> op) {
  red::tile_body<VEC>(op);
}
template <typename Tin, typename Tacc, int VEC>
__global__ void __launch_bounds__(red::kThreads) prep_warp_kernel(const PrepOp<Tin, Tacc> op) {
  red::warp_body<VEC>(op);
}

template <typename Tin, typename Tacc, int VEC>
__global__ void __launch_bounds__(red::kThreads)
    prep_many_tile_kernel(const ManyPrepOp<Tin, Tacc> op) {
  red::tile_body<VEC>(op);
}
template <typename Tin, typename Tacc, int VEC>
__global__ void __launch_bounds__(red::kThreads)
    prep_many_warp_kernel(const ManyPrepOp<Tin, Tacc> op) {
  red::warp_body<VEC>(op);
}

template <typename Tin, typename Tacc>
int launch(const void* acts, const int* labels, void* lpb, void* lpe, void* denom,
           void* extras, const wtt::ExtraCols& cols, const int* table, long long rows, int T,
           int U, int V, int blank, int log_probs_input, const red::Plan& plan,
           cudaStream_t stream) {
  ManyPrepOp<Tin, Tacc> op;  // its PrepOp part is the launch of K <= kMaxExtraCols
  op.acts = static_cast<const Tin*>(acts);
  op.labels = labels;
  op.lpb = static_cast<Tacc*>(lpb);
  op.lpe = static_cast<Tacc*>(lpe);
  op.denom = static_cast<Tacc*>(denom);
  op.extras = static_cast<Tacc*>(extras);
  op.cols = cols;
  op.rows = rows;
  op.T = T;
  op.U = U;
  op.V = V;
  op.blank = blank;
  op.reduce = log_probs_input == 0;
  op.plan = plan;
  red::division_magic((unsigned)U, &op.u_mul, &op.u_shr);
  red::division_magic((unsigned)(T * U), &op.tu_mul, &op.tu_shr);
  op.table = table;
  constexpr int V16 = 16 / (int)sizeof(Tin);
  if (cols.n > wtt::kMaxExtraCols)
    return red::launch(op, prep_many_tile_kernel<Tin, Tacc, 1>,
                       prep_many_tile_kernel<Tin, Tacc, V16>, prep_many_warp_kernel<Tin, Tacc, 1>,
                       prep_many_warp_kernel<Tin, Tacc, V16>, stream);
  const PrepOp<Tin, Tacc>& few = op;
  return red::launch(few, prep_tile_kernel<Tin, Tacc, 1>, prep_tile_kernel<Tin, Tacc, V16>,
                   prep_warp_kernel<Tin, Tacc, 1>, prep_warp_kernel<Tin, Tacc, V16>, stream);
}

int prep(const void* acts, int dtype, const int* labels, void* lpb, void* lpe, void* denom,
         void* extras, const int* extra_cols, int K, const int* table, long long rows, int T,
         int U, int V, int blank, int log_probs_input, const red::Plan& plan, void* stream) {
  if (rows == 0) return 0;
  wtt::ExtraCols cols;
  // Up to kMaxExtraCols columns by value; past that, from the device table.
  const bool cols_ok = K > wtt::kMaxExtraCols
                           ? wtt::cols_inside(extra_cols, K, V) && table != nullptr
                           : wtt::extra_cols(extra_cols, K, V, &cols);
  if (K > wtt::kMaxExtraCols) cols = wtt::many_cols(K);
  // The reductions' row math is 32-bit: every row index below 2^31.
  if (!cols_ok || rows >= (1LL << 31) || !red::plan_ok(plan, V, red::elt_size(dtype)) ||
      (plan.vec > 1 && red::alignment(acts) < 16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case wtt::kF32:
      return launch<float, float>(acts, labels, lpb, lpe, denom, extras, cols, table,
          rows, T, U, V, blank, log_probs_input, plan, s);
    case wtt::kF64:
      return launch<double, double>(acts, labels, lpb, lpe, denom, extras, cols, table,
          rows, T, U, V, blank, log_probs_input, plan, s);
    case wtt::kBF16:
      return launch<__nv_bfloat16, float>(acts, labels, lpb, lpe, denom, extras, cols, table,
          rows, T, U, V, blank, log_probs_input, plan, s);
    case wtt::kF16:
      return launch<__half, float>(acts, labels, lpb, lpe, denom, extras, cols, table,
          rows, T, U, V, blank, log_probs_input, plan, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// acts: (B,T,U,V) of type `dtype`; labels: (B,U) int32 (column U-1 unused);
// lpb, lpe, denom: (B,T,U) f32, or f64 for f64 acts; denom may be null
// (log_probs_input); extras: (B,T,U,K) of the same type for the K columns
// extra_cols (a host array, each inside [0, V); any K); table: the same K
// columns as an int32 array in device memory, read past
// wtt::kMaxExtraCols of them (may be null up to that).
// The plan is reduce.cuh's for V, the type and acts' alignment. Returns
// the launch's cudaError_t.
int wtt_prep(const void* acts, int dtype, const int* labels, void* lpb, void* lpe,
             void* denom, void* extras, const int* extra_cols, int K, const int* table,
             long long rows, int T, int U, int V, int blank, int log_probs_input,
             void* stream) {
  const int elt = red::elt_size(dtype);
  if (elt == 0 || V < 1) return (int)cudaErrorInvalidValue;
  return prep(acts, dtype, labels, lpb, lpe, denom, extras, extra_cols, K, table, rows, T, U, V,
              blank, log_probs_input, red::plan(V, elt, red::alignment(acts)), stream);
}

// wtt_prep with a plan from the caller (seven unsigned, as wtt_reduce_plan
// gives them): both modes at one V, for the card tests and
// scripts/tune_prep.py. A plan outside the bodies' limits is refused.
int wtt_prep_planned(const void* acts, int dtype, const int* labels, void* lpb, void* lpe,
                     void* denom, void* extras, const int* extra_cols, int K,
                     const int* table, long long rows, int T, int U, int V, int blank,
                     int log_probs_input, const unsigned* plan_host, void* stream) {
  const unsigned* h = plan_host;
  red::Plan plan{(int)h[0], (int)h[1], (int)h[2], h[3], (int)h[4], (int)h[5], (int)h[6]};
  red::division_magic((unsigned)V, &plan.mul, &plan.shr);  // not taken from the caller
  return prep(acts, dtype, labels, lpb, lpe, denom, extras, extra_cols, K, table, rows, T, U, V,
              blank, log_probs_input, plan, stream);
}

// reduce.cuh's plan for rows of V elements of `elt` bytes at base
// alignment `align`, into out[7]; the card tests hold it against
// ops/cuda/rows.py::reduce_plan.
void wtt_reduce_plan(int V, int elt, int align, unsigned* out) {
  const red::Plan p = red::plan(V, elt, align);
  const unsigned v[7] = {(unsigned)p.mode, (unsigned)p.rows, (unsigned)p.vec, p.mul,
                         (unsigned)p.shr, (unsigned)p.group, (unsigned)p.stride};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
}

const char* wtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
