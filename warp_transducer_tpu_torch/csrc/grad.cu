// Gradient kernel: the one pass over (B, T, U, V) that writes the RNN-T
// gradient from the small (B, T, U) coefficient fields.
//
// Replaces: no Pallas kernel. The JAX package leaves this pass to XLA
// (warp_transducer_tpu/ops/gradients.py:60, grad_wrt_acts, the fused
// element-wise pass at :97-108, and grad_wrt_log_probs at :111); the
// reference runs it as compute_grad_kernel.
//
// Dense convention (sparse == 0), per element of a valid row:
//   g = coef * exp(x + denom) - cb * [v == blank] - ce * [v == y_u]
//       - sum_k extra[k] * [v == cols[k]]
// (every subtraction whose column matches applies). The K <= 8 extra
// columns are the big blanks of the multi-blank loss (the JAX package's
// ops/multiblank.py:268, _multiblank_grad); their posteriors come as one
// (B,T,U,K) field and are subtracted in the accumulation type before the
// one rounding to the output type. With K = 0 the pass is the standard one. Sparse convention
// (log-prob inputs, sparse == 1): g = -ce at the label when the row has
// one, else -cb at blank, else 0 (the label overwrites blank, as in
// cpu_rnnt.h:253-267). Rows outside (t < T_b) & (u < U_b) are written 0.
// coef/cb/ce come from plain torch ops on the lattice outputs
// (ops/gradients.py::coefficients), with the upstream cotangent and
// FastEmit already folded in, so this pass needs no extra multiply.
//
// Bound on this card: bytes. It reads the activations once and writes the
// gradient once, both in the input's type (B·T·U·V elements each way);
// the (B,T,U) fields add 4/V of that. About four operations per element.
//
// Design: as the prep kernel, one warp per row and eight rows per block,
// lanes striding over V, so reads and writes are contiguous across a warp
// and across neighbouring warps. The row's coefficients, denominator and
// label are loaded once per lane. Accumulation is f32 (f64 for f64 input)
// and each element is rounded once to the output type.
#include "common.cuh"

namespace {

constexpr int kRowsPerBlock = 8;

template <typename Tio, typename Tacc, bool kExtra>
__global__ void grad_kernel(const Tio* __restrict__ acts, const Tacc* __restrict__ denom,
                            const Tacc* __restrict__ coef, const Tacc* __restrict__ cb,
                            const Tacc* __restrict__ ce, const Tacc* __restrict__ extra,
                            const wtt::ExtraCols cols, const int* __restrict__ labels,
                            const int* __restrict__ input_lengths,
                            const int* __restrict__ label_lengths, Tio* __restrict__ grads,
                            long long rows, int T, int U, int V, int blank, int sparse) {
  const int lane = threadIdx.x % wtt::kWarp;
  const long long row = (long long)blockIdx.x * kRowsPerBlock + threadIdx.x / wtt::kWarp;
  if (row >= rows) return;
  Tio* g = grads + row * V;
  const int u = (int)(row % U);
  const int t = (int)((row / U) % T);
  const long long b = row / ((long long)T * U);
  const int Ub = label_lengths[b] + 1;
  if (t >= input_lengths[b] || u >= Ub) {
    for (int v = lane; v < V; v += wtt::kWarp) wtt::store(g + v, Tacc(0));
    return;
  }
  const int lab = labels[b * U + u];
  const Tacc cbv = cb[row];
  const Tacc cev = ce[row];
  if (sparse) {
    const bool has_label = u < Ub - 1;
    for (int v = lane; v < V; v += wtt::kWarp) {
      Tacc out = v == blank ? -cbv : Tacc(0);
      if (has_label && v == lab) out = -cev;
      wtt::store(g + v, out);
    }
    return;
  }
  const Tio* x = acts + row * V;
  const Tacc c = coef[row];
  const Tacc d = denom[row];
  Tacc exv[wtt::kMaxExtraCols];
#pragma unroll
  for (int k = 0; k < wtt::kMaxExtraCols; ++k)
    exv[k] = (kExtra && k < cols.n) ? extra[row * cols.n + k] : Tacc(0);
  for (int v = lane; v < V; v += wtt::kWarp) {
    Tacc out = wtt::mul_rn(c, wtt::ex(wtt::to_acc(x[v]) + d));
    if (v == blank) out -= cbv;
    if (v == lab) out -= cev;
    if constexpr (kExtra) {  // compiled out of the K = 0 instantiation
#pragma unroll
      for (int k = 0; k < wtt::kMaxExtraCols; ++k)
        if (v == cols.col[k]) out -= exv[k];  // unused entries hold -1
    }
    wtt::store(g + v, out);
  }
}

template <typename Tio, typename Tacc>
int launch(const void* acts, const void* denom, const void* coef, const void* cb,
           const void* ce, const void* extra, const wtt::ExtraCols& cols, const int* labels,
           const int* input_lengths, const int* label_lengths, void* grads, long long rows,
           int T, int U, int V, int blank, int sparse, cudaStream_t stream) {
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  auto kernel = cols.n > 0 ? grad_kernel<Tio, Tacc, true> : grad_kernel<Tio, Tacc, false>;
  kernel<<<(unsigned)blocks, kRowsPerBlock * wtt::kWarp, 0, stream>>>(
      static_cast<const Tio*>(acts), static_cast<const Tacc*>(denom),
      static_cast<const Tacc*>(coef), static_cast<const Tacc*>(cb),
      static_cast<const Tacc*>(ce), static_cast<const Tacc*>(extra), cols, labels,
      input_lengths, label_lengths,
      static_cast<Tio*>(grads), rows, T, U, V, blank, sparse);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// acts, grads: (B,T,U,V) of type `dtype` (acts and denom unused, may be
// null, when sparse); denom, coef, cb, ce: (B,T,U) f32, or f64 for f64;
// extra: (B,T,U,K) of the same type for the K columns extra_cols (a host
// array; dense only, K = 0 when sparse); labels: (B,U) int32; lengths: (B,)
// int32. Returns the launch's cudaError_t.
int wtt_grad(const void* acts, int dtype, const void* denom, const void* coef,
             const void* cb, const void* ce, const void* extra, const int* extra_cols, int K,
             const int* labels, const int* input_lengths, const int* label_lengths,
             void* grads, long long rows, int T, int U, int V, int blank, int sparse,
             void* stream) {
  if (rows == 0) return 0;
  wtt::ExtraCols cols;
  if (!wtt::extra_cols(extra_cols, K, V, &cols) || (sparse && K > 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case wtt::kF32:
      return launch<float, float>(acts, denom, coef, cb, ce, extra, cols, labels,
          input_lengths, label_lengths, grads, rows, T, U, V, blank, sparse, s);
    case wtt::kF64:
      return launch<double, double>(acts, denom, coef, cb, ce, extra, cols, labels,
          input_lengths, label_lengths, grads, rows, T, U, V, blank, sparse, s);
    case wtt::kBF16:
      return launch<__nv_bfloat16, float>(acts, denom, coef, cb, ce, extra, cols, labels,
          input_lengths, label_lengths, grads, rows, T, U, V, blank, sparse, s);
    case wtt::kF16:
      return launch<__half, float>(acts, denom, coef, cb, ce, extra, cols, labels,
          input_lengths, label_lengths, grads, rows, T, U, V, blank, sparse, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
