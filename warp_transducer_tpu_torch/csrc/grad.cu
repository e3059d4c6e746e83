// Gradient kernels: the one pass over (B, T, U, V) that writes the RNN-T
// gradient, in two modes on the tiled row passes of rows.cuh.
//
// Replaces: no Pallas kernel. The JAX package leaves this pass to XLA
// (warp_transducer_tpu/ops/gradients.py:60, grad_wrt_acts, one fused
// element-wise pass with its coefficients, and grad_wrt_log_probs at :111);
// the reference runs it as compute_grad_kernel, which reads α, β and the
// log-likelihood per cell.
//
// Lattice mode (wtt_grad_lattice; the dense loss's backward). A row's
// scalars come from the lattice, staged once per row as
// ops/gradients.py::coefficients computes them:
//   coef = exp(α − ll + β),
//   cb   = exp(α − ll + lpb + β(t+1, u)): β(t+1, u) is entry row + U; 0 at the
//          terminal cell (T_b−1, U_b−1), NEG elsewhere past t = T_b−2;
//   ce   = exp(α − ll + lpe + β(t, u+1)): entry row + 1; NEG for u >= U_b−1;
// then FastEmit (coef += λ·ce, ce *= 1 + λ) and the upstream cotangent
// (a (B,) scale). No (B, T, U) field is written.
//
// Fields mode (wtt_grad; the multi-blank loss and the TDT token head, whose
// coefficients are not the standard ones): coef, cb, ce come as (B, T, U)
// fields and K extra columns' posteriors as a (B, T, U, K) field. K has no
// cap: up to 8 columns come by value (the instances the main shapes run);
// past 8, instances of their own (ManyFieldsOp, dense and sparse) read the
// columns from a table in device memory, looked through in a loop at run
// time for a column inside [min col_k, max col_k] only.
//
// Per element of a valid row ((t < T_b) & (u < U_b); others are written 0),
// rows.cuh::grad_element: dense g = coef·exp(x + denom) − cb·[v = blank]
// − ce·[v = y_u] − Σ_k extra_k·[v = col_k]; sparse (log-prob inputs) −ce at
// the label where the row has one, else −cb at blank, else 0. The
// arithmetic is f64 for f64 input and f32 otherwise; each element is
// rounded once to the output type.
//
// The sparse fields mode with K extra columns (the multi-blank loss on
// log-probs: −cB_k at big-blank column k, written over blank and under the
// label, as the native engine writes them, rnnt_cpu.cpp:529-533) is an
// instantiation of its own, so that the dense fields mode compiles as
// before. Its element is the K = 0 sparse element, and only a column inside
// [min col_k, max col_k] (one unsigned compare) looks through the K columns
// (the default big blanks, the last K columns, are contiguous).
//
// Bound on this card: bytes. The activations are read in valid rows and the
// gradient written everywhere, both in the input's type; the lattice mode's
// scalars (α, β twice, lpb, lpe, denom a row) add about 7·4/V of that.
#include "rows.cuh"

namespace {

using wtt::rows::GradRow;

// What both modes share: the row's place in the lattice and the element.
// A staged row's label column is, dense, the row's label (its ce is 0 where
// it has none) and, sparse, -1 where it has none.
template <typename TIo, typename TAcc>
struct Common {
  using Tio = TIo;
  using Tacc = TAcc;
  using Row = GradRow<TAcc>;
  const Tio* acts;
  Tio* grads;
  const Tacc* denom;
  const int* labels;  // (B, U)
  const int* input_lengths;
  const int* label_lengths;
  long long rows;
  int T, U, V, blank, n_extra;
  bool sparse, reads;
  wtt::ExtraCols cols;
  wtt::rows::Plan plan;

  // Decompose a row into (b, t, u); false outside (t < T_b) & (u < U_b).
  __device__ __forceinline__ bool cell(int row, int& b, int& t, int& u, int& Tb, int& Ub) const {
    u = row % U;
    const int bt = row / U;
    t = bt % T;
    b = bt / T;
    Tb = input_lengths[b];
    Ub = label_lengths[b] + 1;
    return t < Tb && u < Ub;
  }
  __device__ __forceinline__ Tacc apply(const Row& r, int col, Tacc x, const Tacc* extra) const {
    return wtt::rows::grad_element(r, col, x, blank, sparse, n_extra, cols, extra);
  }
};

template <typename TIo, typename TAcc>
struct LatticeOp : Common<TIo, TAcc> {
  using Tacc = TAcc;
  const Tacc *lpb, *lpe, *alphas, *betas, *logll, *scale;
  long long scale_stride;
  Tacc lam, lam1;  // FastEmit λ and 1 + λ (rounded from double once)

  __device__ __forceinline__ GradRow<Tacc> stage(int row, Tacc*) const {
    GradRow<Tacc> r{Tacc(0), Tacc(0), Tacc(0), Tacc(0), -1, 0};
    int b, t, u, Tb, Ub;
    // An invalid row reads nothing past its lengths: issuing a row's reads
    // with the lengths' instead, whatever its validity, measured slower on
    // an H100 (PERF.md, the A/B of the staging).
    if (!this->cell(row, b, t, u, Tb, Ub)) return r;
    const int U = this->U;
    const Tacc neg = Tacc(wtt::kNeg);
    const Tacc a_ll = alphas[row] - logll[b];
    // The shifted β is NEG past the utterance (and past the tensor's last
    // frame or label, as the plain version pads it), 0 at the terminal cell.
    const Tacc bt = t < Tb - 1 && t + 1 < this->T ? betas[row + U]
                    : (t == Tb - 1 && u == Ub - 1 ? Tacc(0) : neg);
    const Tacc bu = u < Ub - 1 && u + 1 < U ? betas[row + 1] : neg;
    Tacc coef = wtt::ex(a_ll + betas[row]);
    Tacc cb = wtt::ex(a_ll + lpb[row] + bt);
    Tacc ce = wtt::ex(a_ll + lpe[row] + bu);
    if (lam != Tacc(0)) {
      coef = coef + wtt::mul_rn(lam, ce);
      ce = wtt::mul_rn(ce, lam1);
    }
    if (scale) {
      const Tacc s = scale[b * scale_stride];
      coef = wtt::mul_rn(coef, s);
      cb = wtt::mul_rn(cb, s);
      ce = wtt::mul_rn(ce, s);
    }
    r.coef = coef;
    r.cb = cb;
    r.ce = ce;
    r.den = this->sparse ? Tacc(0) : this->denom[row];
    r.lab = this->sparse && u >= Ub - 1 ? -1 : this->labels[b * U + u];
    r.valid = 1;
    return r;
  }
};

template <typename TIo, typename TAcc, bool SPARSE>
struct FieldsOp : Common<TIo, TAcc> {
  using Tacc = TAcc;
  const Tacc *coef, *cb, *ce, *extra;
  int lo, span;  // the extra columns lie in [lo, lo + span]; lo = -1, span = 0 for none

  __device__ __forceinline__ GradRow<Tacc> stage(int row, Tacc* ext) const {
    GradRow<Tacc> r{Tacc(0), Tacc(0), Tacc(0), Tacc(0), -1, 0};
    int b, t, u, Tb, Ub;
    if (!this->cell(row, b, t, u, Tb, Ub)) return r;
    const int K = this->n_extra;
    for (int k = 0; k < K; ++k) ext[k] = extra[(long long)row * K + k];
    r.coef = this->sparse ? Tacc(0) : coef[row];
    r.cb = cb[row];
    r.ce = ce[row];
    r.den = this->sparse ? Tacc(0) : this->denom[row];
    r.lab = this->sparse && u >= Ub - 1 ? -1 : this->labels[b * this->U + u];
    r.valid = 1;
    return r;
  }
  __device__ __forceinline__ Tacc apply(const GradRow<Tacc>& r, int col, Tacc x,
                                        const Tacc* ext) const {
    if (!SPARSE)
      return wtt::rows::grad_element<Tacc>(r, col, x, this->blank, false, this->n_extra,
                                           this->cols, ext);
    Tacc out = wtt::rows::grad_element<Tacc>(r, col, x, this->blank, true, 0, this->cols,
                                             nullptr);
    if ((unsigned)(col - lo) <= (unsigned)span && r.valid && col != r.lab) {
#pragma unroll
      for (int k = 0; k < wtt::kMaxExtraCols; ++k)
        if (k < this->n_extra && col == this->cols.col[k]) out = -ext[k];
    }
    return out;
  }
};

// K > kMaxExtraCols extra columns: the same element, the columns read from a
// device table in a loop at run time (cols.n = K). Dense: every matching
// column subtracted, in the order of k, after blank and the label; sparse:
// the last matching column over blank and under the label.
// Columns that run lo, lo + 1, … in the order of k (the default big
// blanks, the last K columns) are found without the loop: k = col − lo.
template <typename TIo, typename TAcc, bool SPARSE>
struct ManyFieldsOp : FieldsOp<TIo, TAcc, SPARSE> {
  using Tacc = TAcc;
  const int* table;  // (K,) int32 in device memory
  bool contiguous;   // table[k] == lo + k for every k

  __device__ __forceinline__ Tacc apply(const GradRow<Tacc>& r, int col, Tacc x,
                                        const Tacc* ext) const {
    Tacc out = wtt::rows::grad_element<Tacc>(r, col, x, this->blank, SPARSE, 0, this->cols,
                                             nullptr);
    if ((unsigned)(col - this->lo) <= (unsigned)this->span && r.valid &&
        !(SPARSE && col == r.lab)) {
      if (contiguous) {
        const Tacc e = ext[col - this->lo];
        out = SPARSE ? -e : out - e;
      } else {
        for (int k = 0; k < this->n_extra; ++k)
          if (col == __ldg(table + k)) out = SPARSE ? -ext[k] : out - ext[k];
      }
    }
    return out;
  }
};

template <typename Tio, typename Tacc, int VEC>
__global__ void __launch_bounds__(wtt::rows::kThreads)
    grad_lattice_tile_kernel(const LatticeOp<Tio, Tacc> op) {
  wtt::rows::tile_body<VEC>(op);
}
template <typename Tio, typename Tacc, int VEC>
__global__ void __launch_bounds__(wtt::rows::kThreads)
    grad_lattice_warp_kernel(const LatticeOp<Tio, Tacc> op) {
  wtt::rows::warp_body<VEC>(op);
}
template <typename Tio, typename Tacc, int VEC, bool SPARSE>
__global__ void __launch_bounds__(wtt::rows::kThreads)
    grad_fields_tile_kernel(const FieldsOp<Tio, Tacc, SPARSE> op) {
  wtt::rows::tile_body<VEC>(op);
}
template <typename Tio, typename Tacc, int VEC, bool SPARSE>
__global__ void __launch_bounds__(wtt::rows::kThreads)
    grad_fields_warp_kernel(const FieldsOp<Tio, Tacc, SPARSE> op) {
  wtt::rows::warp_body<VEC>(op);
}

template <typename Tio, typename Tacc, int VEC, bool SPARSE>
__global__ void __launch_bounds__(wtt::rows::kThreads)
    grad_many_tile_kernel(const ManyFieldsOp<Tio, Tacc, SPARSE> op) {
  wtt::rows::tile_body<VEC>(op);
}
template <typename Tio, typename Tacc, int VEC, bool SPARSE>
__global__ void __launch_bounds__(wtt::rows::kThreads)
    grad_many_warp_kernel(const ManyFieldsOp<Tio, Tacc, SPARSE> op) {
  wtt::rows::warp_body<VEC>(op);
}

constexpr int kVec(int elt) { return 16 / elt; }

template <typename Tio, typename Tacc>
int launch_lattice(const LatticeOp<Tio, Tacc>& op, cudaStream_t s) {
  constexpr int V16 = kVec(sizeof(Tio));
  return wtt::rows::launch(op, grad_lattice_tile_kernel<Tio, Tacc, 1>,
                           grad_lattice_tile_kernel<Tio, Tacc, V16>,
                           grad_lattice_warp_kernel<Tio, Tacc, 1>,
                           grad_lattice_warp_kernel<Tio, Tacc, V16>, s);
}
template <typename Tio, typename Tacc, bool SPARSE>
int launch_fields(const FieldsOp<Tio, Tacc, SPARSE>& op, cudaStream_t s) {
  constexpr int V16 = kVec(sizeof(Tio));
  return wtt::rows::launch(op, grad_fields_tile_kernel<Tio, Tacc, 1, SPARSE>,
                           grad_fields_tile_kernel<Tio, Tacc, V16, SPARSE>,
                           grad_fields_warp_kernel<Tio, Tacc, 1, SPARSE>,
                           grad_fields_warp_kernel<Tio, Tacc, V16, SPARSE>, s);
}

template <typename Tio, typename Tacc>
void fill_common(Common<Tio, Tacc>& c, const void* acts, const void* denom, const int* labels,
                 const int* input_lengths, const int* label_lengths, void* grads, long long rows,
                 int T, int U, int V, int blank, int sparse, const wtt::ExtraCols& cols,
                 const wtt::rows::Plan& plan) {
  c.acts = static_cast<const Tio*>(acts);
  c.grads = static_cast<Tio*>(grads);
  c.denom = static_cast<const Tacc*>(denom);
  c.labels = labels;
  c.input_lengths = input_lengths;
  c.label_lengths = label_lengths;
  c.rows = rows;
  c.T = T;
  c.U = U;
  c.V = V;
  c.blank = blank;
  c.n_extra = cols.n;
  c.sparse = sparse != 0;
  c.reads = sparse == 0;
  c.cols = cols;
  c.plan = plan;
}

template <typename Tio, typename Tacc>
int lattice(const void* acts, const void* denom, const void* lpb, const void* lpe,
            const void* alphas, const void* betas, const void* logll, const void* scale,
            long long scale_stride, double lambda, const int* labels, const int* input_lengths,
            const int* label_lengths, void* grads, long long rows, int T, int U, int V,
            int blank, int sparse, const wtt::rows::Plan& plan, cudaStream_t s) {
  LatticeOp<Tio, Tacc> op;
  fill_common<Tio, Tacc>(op, acts, denom, labels, input_lengths, label_lengths, grads, rows, T,
                         U, V, blank, sparse, wtt::ExtraCols{0, {-1, -1, -1, -1, -1, -1, -1, -1}},
                         plan);
  op.lpb = static_cast<const Tacc*>(lpb);
  op.lpe = static_cast<const Tacc*>(lpe);
  op.alphas = static_cast<const Tacc*>(alphas);
  op.betas = static_cast<const Tacc*>(betas);
  op.logll = static_cast<const Tacc*>(logll);
  op.scale = static_cast<const Tacc*>(scale);
  op.scale_stride = scale_stride;
  op.lam = static_cast<Tacc>(lambda);
  op.lam1 = static_cast<Tacc>(1.0 + lambda);
  return launch_lattice(op, s);
}

template <typename Tio, typename Tacc, bool SPARSE>
int launch_many(const ManyFieldsOp<Tio, Tacc, SPARSE>& op, cudaStream_t s) {
  constexpr int V16 = kVec(sizeof(Tio));
  return wtt::rows::launch(op, grad_many_tile_kernel<Tio, Tacc, 1, SPARSE>,
                           grad_many_tile_kernel<Tio, Tacc, V16, SPARSE>,
                           grad_many_warp_kernel<Tio, Tacc, 1, SPARSE>,
                           grad_many_warp_kernel<Tio, Tacc, V16, SPARSE>, s);
}

// host_cols: the K columns (a host array), table: the same in device memory
// (read past kMaxExtraCols of them).
template <typename Tio, typename Tacc, bool SPARSE>
int fields_mode(const void* acts, const void* denom, const void* coef, const void* cb,
                const void* ce, const void* extra, const wtt::ExtraCols& cols,
                const int* host_cols, const int* table, const int* labels,
                const int* input_lengths, const int* label_lengths, void* grads, long long rows,
                int T, int U, int V, int blank, const wtt::rows::Plan& plan, cudaStream_t s) {
  ManyFieldsOp<Tio, Tacc, SPARSE> op;  // its FieldsOp part is the launch of K <= kMaxExtraCols
  fill_common<Tio, Tacc>(op, acts, denom, labels, input_lengths, label_lengths, grads, rows, T,
                         U, V, blank, SPARSE, cols, plan);
  op.coef = static_cast<const Tacc*>(coef);
  op.cb = static_cast<const Tacc*>(cb);
  op.ce = static_cast<const Tacc*>(ce);
  op.extra = static_cast<const Tacc*>(extra);
  op.lo = -1;
  op.span = 0;
  if (cols.n) {
    int hi = host_cols[0];
    op.lo = host_cols[0];
    for (int k = 1; k < cols.n; ++k) {
      op.lo = host_cols[k] < op.lo ? host_cols[k] : op.lo;
      hi = host_cols[k] > hi ? host_cols[k] : hi;
    }
    op.span = hi - op.lo;
  }
  op.table = table;
  op.contiguous = true;
  for (int k = 1; k < cols.n; ++k)
    op.contiguous = op.contiguous && host_cols[k] == host_cols[0] + k;
  if (cols.n > wtt::kMaxExtraCols) return launch_many(op, s);
  const FieldsOp<Tio, Tacc, SPARSE>& few = op;
  return launch_fields(few, s);
}

template <typename Tio, typename Tacc>
int fields(const void* acts, const void* denom, const void* coef, const void* cb, const void* ce,
           const void* extra, const wtt::ExtraCols& cols, const int* host_cols,
           const int* table, const int* labels, const int* input_lengths,
           const int* label_lengths, void* grads, long long rows, int T, int U, int V, int blank,
           int sparse, const wtt::rows::Plan& plan, cudaStream_t s) {
  return sparse ? fields_mode<Tio, Tacc, true>(acts, denom, coef, cb, ce, extra, cols, host_cols,
                                               table, labels, input_lengths, label_lengths, grads,
                                               rows, T, U, V, blank, plan, s)
                : fields_mode<Tio, Tacc, false>(acts, denom, coef, cb, ce, extra, cols,
                                                host_cols, table, labels, input_lengths,
                                                label_lengths, grads, rows, T, U, V, blank, plan,
                                                s);
}

int elt_size(int dtype) {
  switch (dtype) {
    case wtt::kF32: return 4;
    case wtt::kF64: return 8;
    case wtt::kBF16:
    case wtt::kF16: return 2;
    default: return 0;
  }
}

// The limits of the 32-bit row math (rows.cuh): rows and every row's start
// below 2^31 elements of a tile.
bool shape_ok(long long rows, int V, int dtype, const wtt::rows::Plan& plan) {
  const int elt = elt_size(dtype);
  return elt > 0 && rows < (1LL << 31) && wtt::rows::plan_ok(plan, V, elt);
}

}  // namespace

extern "C" {

// Lattice mode. acts, grads: (B,T,U,V) of type `dtype` (acts and denom
// unused, may be null, when sparse); denom, lpb, lpe, alphas, betas: (B,T,U)
// f32, or f64 for f64; logll: (B,) of that type; scale: (B,) of that type
// read at b·scale_stride, or null; labels: (B,U) int32; lengths: (B,) int32;
// plan: the five unsigned of ops/cuda/rows.py::plan (a host array). Returns
// the launch's cudaError_t.
int wtt_grad_lattice(const void* acts, int dtype, const void* denom, const void* lpb,
                     const void* lpe, const void* alphas, const void* betas, const void* logll,
                     const void* scale, long long scale_stride, double fastemit_lambda,
                     const int* labels, const int* input_lengths, const int* label_lengths,
                     void* grads, long long rows, int T, int U, int V, int blank, int sparse,
                     const unsigned* plan_host, void* stream) {
  if (rows == 0) return 0;
  const wtt::rows::Plan plan = wtt::rows::plan_from(plan_host);
  if (!shape_ok(rows, V, dtype, plan)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case wtt::kF32:
      return lattice<float, float>(acts, denom, lpb, lpe, alphas, betas, logll, scale,
          scale_stride, fastemit_lambda, labels, input_lengths, label_lengths, grads, rows, T,
          U, V, blank, sparse, plan, s);
    case wtt::kF64:
      return lattice<double, double>(acts, denom, lpb, lpe, alphas, betas, logll, scale,
          scale_stride, fastemit_lambda, labels, input_lengths, label_lengths, grads, rows, T,
          U, V, blank, sparse, plan, s);
    case wtt::kBF16:
      return lattice<__nv_bfloat16, float>(acts, denom, lpb, lpe, alphas, betas, logll, scale,
          scale_stride, fastemit_lambda, labels, input_lengths, label_lengths, grads, rows, T,
          U, V, blank, sparse, plan, s);
    case wtt::kF16:
      return lattice<__half, float>(acts, denom, lpb, lpe, alphas, betas, logll, scale,
          scale_stride, fastemit_lambda, labels, input_lengths, label_lengths, grads, rows, T,
          U, V, blank, sparse, plan, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Fields mode. acts, grads: (B,T,U,V) of type `dtype` (acts and denom
// unused, may be null, when sparse); denom, coef, cb, ce: (B,T,U) f32, or
// f64 for f64; extra: (B,T,U,K) of the same type for the K columns
// extra_cols (a host array, any K), in both modes; table: the same K
// columns as an int32 array in device memory, read past
// wtt::kMaxExtraCols of them (may be null up to that); labels: (B,U)
// int32; lengths: (B,) int32; plan as above. Returns the launch's
// cudaError_t.
int wtt_grad(const void* acts, int dtype, const void* denom, const void* coef,
             const void* cb, const void* ce, const void* extra, const int* extra_cols, int K,
             const int* table, const int* labels, const int* input_lengths,
             const int* label_lengths, void* grads, long long rows, int T, int U, int V,
             int blank, int sparse, const unsigned* plan_host, void* stream) {
  if (rows == 0) return 0;
  wtt::ExtraCols cols;
  const wtt::rows::Plan plan = wtt::rows::plan_from(plan_host);
  const bool cols_ok = K > wtt::kMaxExtraCols
                           ? wtt::cols_inside(extra_cols, K, V) && table != nullptr
                           : wtt::extra_cols(extra_cols, K, V, &cols);
  if (K > wtt::kMaxExtraCols) cols = wtt::many_cols(K);
  if (!cols_ok || !shape_ok(rows, V, dtype, plan)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case wtt::kF32:
      return fields<float, float>(acts, denom, coef, cb, ce, extra, cols, extra_cols, table,
          labels, input_lengths, label_lengths, grads, rows, T, U, V, blank, sparse, plan, s);
    case wtt::kF64:
      return fields<double, double>(acts, denom, coef, cb, ce, extra, cols, extra_cols, table,
          labels, input_lengths, label_lengths, grads, rows, T, U, V, blank, sparse, plan, s);
    case wtt::kBF16:
      return fields<__nv_bfloat16, float>(acts, denom, coef, cb, ce, extra, cols, extra_cols, table,
          labels, input_lengths, label_lengths, grads, rows, T, U, V, blank, sparse, plan, s);
    case wtt::kF16:
      return fields<__half, float>(acts, denom, coef, cb, ce, extra, cols, extra_cols, table,
          labels, input_lengths, label_lengths, grads, rows, T, U, V, blank, sparse, plan, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
