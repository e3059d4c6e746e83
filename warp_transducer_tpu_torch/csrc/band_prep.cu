// Band prep kernel: per (b, t, s) row of the (B, T, S, V) band of joint
// logits, the log-softmax denominator and the blank and label log-probs.
//
// Replaces: warp_transducer_tpu/ops/pallas/band_pipeline.py:70
// (_prep_kernel, called through _prep_fields_call), the TPU's one read of
// the band into a lane-packed (B, T, 3·S_pad) carrier. Here the outputs are
// three plain (B, T, S) fields.
//
// Per row: denom = -logsumexp_v x, lpb = x[blank] + denom,
// lpe = x[label] + denom where the row has a label (lab_row >= 0, inside
// [0, V)), else NEG (ops/band.py::band_prep). The label comes per row,
// label of lattice row u = ranges[b, t] + s, so there is no U-1 column rule.
//
// Bound on this card: bytes. The band is read once (B·T·S·V elements in
// their own type) and three (B,T,S) f32 fields are written; about four
// operations per element, far below the 67 TFLOP/s float32 rate at
// 3.35 TB/s.
//
// Design: prep.cu's, one warp per row and eight rows per block, the lanes
// striding over V (coalesced across the warp and across neighbouring
// warps), an online (max, sum-exp) per lane combined with shuffles
// (wtt::neg_logsumexp_row). Every input type is converted to f32 per
// element and the row is computed in f32, as the JAX package computes the
// pruned loss in f32 for every input type.
#include "common.cuh"

namespace {

constexpr int kRowsPerBlock = 8;

template <typename Tin>
__global__ void band_prep_kernel(const Tin* __restrict__ acts, const int* __restrict__ lab_row,
                                 float* __restrict__ lpb, float* __restrict__ lpe,
                                 float* __restrict__ denom, long long rows, int V, int blank) {
  const int lane = threadIdx.x % wtt::kWarp;
  const long long row = (long long)blockIdx.x * kRowsPerBlock + threadIdx.x / wtt::kWarp;
  if (row >= rows) return;  // the whole warp leaves together
  const Tin* x = acts + row * V;
  const float d = wtt::neg_logsumexp_row<float>(x, V, lane);
  if (lane == 0) {
    const int lab = lab_row[row];
    lpb[row] = static_cast<float>(wtt::to_acc(x[blank])) + d;
    lpe[row] = (lab >= 0 && lab < V) ? static_cast<float>(wtt::to_acc(x[lab])) + d
                                     : float(wtt::kNeg);
    denom[row] = d;
  }
}

template <typename Tin>
int launch(const void* acts, const int* lab_row, float* lpb, float* lpe, float* denom,
           long long rows, int V, int blank, cudaStream_t stream) {
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  band_prep_kernel<Tin><<<(unsigned)blocks, kRowsPerBlock * wtt::kWarp, 0, stream>>>(
      static_cast<const Tin*>(acts), lab_row, lpb, lpe, denom, rows, V, blank);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// acts: (B,T,S,V) of type `dtype`; lab_row: (B,T,S) int32, -1 where the row
// has no label; lpb, lpe, denom: (B,T,S) f32; rows = B·T·S. Returns the
// launch's cudaError_t.
int wtt_band_prep(const void* acts, int dtype, const int* lab_row, void* lpb, void* lpe,
                  void* denom, long long rows, int V, int blank, void* stream) {
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* b = static_cast<float*>(lpb);
  float* e = static_cast<float*>(lpe);
  float* d = static_cast<float*>(denom);
  switch (dtype) {
    case wtt::kF32:
      return launch<float>(acts, lab_row, b, e, d, rows, V, blank, s);
    case wtt::kF64:
      return launch<double>(acts, lab_row, b, e, d, rows, V, blank, s);
    case wtt::kBF16:
      return launch<__nv_bfloat16>(acts, lab_row, b, e, d, rows, V, blank, s);
    case wtt::kF16:
      return launch<__half>(acts, lab_row, b, e, d, rows, V, blank, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
