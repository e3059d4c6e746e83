// Band gradient kernel: the one pass over the (B, T, S, V) band that
// writes the pruned loss's gradient from the small (B, T, S) coefficient
// fields.
//
// Replaces: warp_transducer_tpu/ops/pallas/band_pipeline.py:135
// (_grad_kernel, called through _grad_fields_call), which broadcasts five
// lane-packed per-cell scalars over each segment's V columns.
//
// Per element of a valid row (t < T_b and ranges[b,t] + s < U_b):
//   g = coef * exp(x + denom) - cb * [v == blank] - ce * [v == label]
// (ops/band.py::band_grad). Invalid rows are written 0 without reading
// the band. coef/cb/ce come from plain torch ops on the band lattice
// (ops/band.py::band_coefs), with the upstream cotangent, FastEmit and
// the zeroing of infeasible utterances already folded in.
//
// Bound on this card: bytes. It reads the band at valid rows and writes
// the whole gradient, both in the input's type; the (B,T,S) fields add
// 4/V of that. About four operations per element.
//
// Design: grad.cu's, one warp per row and eight rows per block, lanes
// striding over V, so reads and writes are contiguous across a warp and
// across neighbouring warps. A row's validity comes from its band start
// and the lengths, its label from the (B,T,S) lab_row (-1: none). The
// arithmetic is f32 for every input type (as the JAX package's pruned
// loss); the product is rounded on its own (mul_rn) so the kernel rounds
// as the plain version does, and each element is rounded once to the
// output type.
#include "common.cuh"

namespace {

constexpr int kRowsPerBlock = 8;

template <typename Tio>
__global__ void band_grad_kernel(const Tio* __restrict__ acts, const float* __restrict__ denom,
                                 const float* __restrict__ coef, const float* __restrict__ cb,
                                 const float* __restrict__ ce, const int* __restrict__ lab_row,
                                 const int* __restrict__ ranges,
                                 const int* __restrict__ input_lengths,
                                 const int* __restrict__ label_lengths, Tio* __restrict__ grads,
                                 long long rows, int T, int S, int V, int blank) {
  const int lane = threadIdx.x % wtt::kWarp;
  const long long row = (long long)blockIdx.x * kRowsPerBlock + threadIdx.x / wtt::kWarp;
  if (row >= rows) return;
  Tio* g = grads + row * V;
  const long long bt = row / S;  // (b, t) of the row
  const int s = (int)(row % S);
  const int t = (int)(bt % T);
  const long long b = bt / T;
  if (t >= input_lengths[b] || ranges[bt] + s >= label_lengths[b] + 1) {
    for (int v = lane; v < V; v += wtt::kWarp) wtt::store(g + v, 0.0f);
    return;
  }
  const Tio* x = acts + row * V;
  const float c = coef[row];
  const float d = denom[row];
  const float cbv = cb[row];
  const float cev = ce[row];
  const int lab = lab_row[row];
  for (int v = lane; v < V; v += wtt::kWarp) {
    float out = wtt::mul_rn(c, wtt::ex(static_cast<float>(wtt::to_acc(x[v])) + d));
    if (v == blank) out -= cbv;
    if (v == lab) out -= cev;
    wtt::store(g + v, out);
  }
}

template <typename Tio>
int launch(const void* acts, const float* denom, const float* coef, const float* cb,
           const float* ce, const int* lab_row, const int* ranges, const int* input_lengths,
           const int* label_lengths, void* grads, long long rows, int T, int S, int V, int blank,
           cudaStream_t stream) {
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  band_grad_kernel<Tio><<<(unsigned)blocks, kRowsPerBlock * wtt::kWarp, 0, stream>>>(
      static_cast<const Tio*>(acts), denom, coef, cb, ce, lab_row, ranges, input_lengths,
      label_lengths, static_cast<Tio*>(grads), rows, T, S, V, blank);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// acts, grads: (B,T,S,V) of type `dtype`; denom, coef, cb, ce: (B,T,S) f32;
// lab_row: (B,T,S) int32 (-1: no label); ranges: (B,T) int32; lengths: (B,)
// int32; rows = B·T·S. Returns the launch's cudaError_t.
int wtt_band_grad(const void* acts, int dtype, const void* denom, const void* coef,
                  const void* cb, const void* ce, const int* lab_row, const int* ranges,
                  const int* input_lengths, const int* label_lengths, void* grads,
                  long long rows, int T, int S, int V, int blank, void* stream) {
  if (rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dn = static_cast<const float*>(denom);
  const float* cf = static_cast<const float*>(coef);
  const float* b = static_cast<const float*>(cb);
  const float* e = static_cast<const float*>(ce);
  switch (dtype) {
    case wtt::kF32:
      return launch<float>(acts, dn, cf, b, e, lab_row, ranges, input_lengths, label_lengths,
                           grads, rows, T, S, V, blank, st);
    case wtt::kF64:
      return launch<double>(acts, dn, cf, b, e, lab_row, ranges, input_lengths, label_lengths,
                            grads, rows, T, S, V, blank, st);
    case wtt::kBF16:
      return launch<__nv_bfloat16>(acts, dn, cf, b, e, lab_row, ranges, input_lengths,
                                   label_lengths, grads, rows, T, S, V, blank, st);
    case wtt::kF16:
      return launch<__half>(acts, dn, cf, b, e, lab_row, ranges, input_lengths, label_lengths,
                            grads, rows, T, S, V, blank, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
