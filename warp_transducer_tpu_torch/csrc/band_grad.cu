// Band gradient kernel: the one pass over the (B, T, S, V) band that
// writes the pruned loss's gradient from the small (B, T, S) coefficient
// fields, on the tiled row passes of rows.cuh.
//
// Replaces: warp_transducer_tpu/ops/pallas/band_pipeline.py:135
// (_grad_kernel, called through _grad_fields_call), which broadcasts five
// lane-packed per-cell scalars over each segment's V columns.
//
// Per element of a valid row (t < T_b and ranges[b,t] + s < U_b):
//   g = coef * exp(x + denom) - cb * [v == blank] - ce * [v == label]
// (ops/band.py::band_grad; rows.cuh::grad_element). Invalid rows are written
// 0 without reading the band. coef/cb/ce come from plain torch ops on the
// band lattice (ops/band.py::band_coefs), with the upstream cotangent,
// FastEmit and the zeroing of infeasible utterances already folded in.
//
// Bound on this card: bytes. It reads the band at valid rows and writes
// the whole gradient, both in the input's type; the (B,T,S) fields add
// 5·4/V of that. About four operations per element.
//
// Design: rows.cuh's two modes (a tile of rows a block below the planner's
// switch point in V, a warp a row above it). A row's validity comes from
// its band start and the lengths, its label from the (B,T,S) lab_row (-1:
// none). The arithmetic is f32 for every input type (as the JAX package's
// pruned loss); the product is rounded on its own (mul_rn) so the kernel
// rounds as the plain version does, and each element is rounded once to
// the output type.
#include "rows.cuh"

namespace {

using wtt::rows::GradRow;

template <typename TIo>
struct BandOp {
  using Tio = TIo;
  using Tacc = float;
  using Row = GradRow<float>;
  const Tio* acts;
  Tio* grads;
  const float *denom, *coef, *cb, *ce;
  const int *lab_row, *ranges, *input_lengths, *label_lengths;
  long long rows;
  int T, S, V, blank, n_extra;
  bool reads;
  wtt::rows::Plan plan;

  __device__ __forceinline__ Row stage(int row, float*) const {
    Row r{0.0f, 0.0f, 0.0f, 0.0f, -1, 0};
    const int bt = row / S;  // (b, t) of the row
    const int s = row - bt * S;
    const int t = bt % T;
    const int b = bt / T;
    if (t >= input_lengths[b] || ranges[bt] + s >= label_lengths[b] + 1) return r;
    r.coef = coef[row];
    r.cb = cb[row];
    r.ce = ce[row];
    r.den = denom[row];
    r.lab = lab_row[row];
    r.valid = 1;
    return r;
  }
  __device__ __forceinline__ float apply(const Row& r, int col, float x, const float*) const {
    return wtt::rows::grad_element<float>(r, col, x, blank, false, 0, wtt::ExtraCols{}, nullptr);
  }
};

template <typename Tio, int VEC>
__global__ void __launch_bounds__(wtt::rows::kThreads) band_grad_tile_kernel(const BandOp<Tio> op) {
  wtt::rows::tile_body<VEC>(op);
}
template <typename Tio, int VEC>
__global__ void __launch_bounds__(wtt::rows::kThreads) band_grad_warp_kernel(const BandOp<Tio> op) {
  wtt::rows::warp_body<VEC>(op);
}

template <typename Tio>
int launch(const void* acts, const float* denom, const float* coef, const float* cb,
           const float* ce, const int* lab_row, const int* ranges, const int* input_lengths,
           const int* label_lengths, void* grads, long long rows, int T, int S, int V, int blank,
           const wtt::rows::Plan& plan, cudaStream_t stream) {
  if (rows >= (1LL << 31) || !wtt::rows::plan_ok(plan, V, sizeof(Tio)))
    return (int)cudaErrorInvalidValue;
  BandOp<Tio> op{static_cast<const Tio*>(acts), static_cast<Tio*>(grads), denom, coef, cb, ce,
                 lab_row, ranges, input_lengths, label_lengths, rows, T, S, V, blank, 0, true,
                 plan};
  constexpr int V16 = 16 / sizeof(Tio);
  return wtt::rows::launch(op, band_grad_tile_kernel<Tio, 1>, band_grad_tile_kernel<Tio, V16>,
                           band_grad_warp_kernel<Tio, 1>, band_grad_warp_kernel<Tio, V16>, stream);
}

}  // namespace

extern "C" {

// acts, grads: (B,T,S,V) of type `dtype`; denom, coef, cb, ce: (B,T,S) f32;
// lab_row: (B,T,S) int32 (-1: no label); ranges: (B,T) int32; lengths: (B,)
// int32; rows = B·T·S; plan: the five unsigned of ops/cuda/rows.py::plan (a
// host array). Returns the launch's cudaError_t.
int wtt_band_grad(const void* acts, int dtype, const void* denom, const void* coef,
                  const void* cb, const void* ce, const int* lab_row, const int* ranges,
                  const int* input_lengths, const int* label_lengths, void* grads,
                  long long rows, int T, int S, int V, int blank, const unsigned* plan_host,
                  void* stream) {
  if (rows == 0) return 0;
  const wtt::rows::Plan plan = wtt::rows::plan_from(plan_host);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dn = static_cast<const float*>(denom);
  const float* cf = static_cast<const float*>(coef);
  const float* b = static_cast<const float*>(cb);
  const float* e = static_cast<const float*>(ce);
  switch (dtype) {
    case wtt::kF32:
      return launch<float>(acts, dn, cf, b, e, lab_row, ranges, input_lengths, label_lengths,
                           grads, rows, T, S, V, blank, plan, st);
    case wtt::kF64:
      return launch<double>(acts, dn, cf, b, e, lab_row, ranges, input_lengths, label_lengths,
                            grads, rows, T, S, V, blank, plan, st);
    case wtt::kBF16:
      return launch<__nv_bfloat16>(acts, dn, cf, b, e, lab_row, ranges, input_lengths,
                                   label_lengths, grads, rows, T, S, V, blank, plan, st);
    case wtt::kF16:
      return launch<__half>(acts, dn, cf, b, e, lab_row, ranges, input_lengths, label_lengths,
                            grads, rows, T, S, V, blank, plan, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
