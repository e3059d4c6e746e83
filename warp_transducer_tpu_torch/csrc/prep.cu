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
// Design: one warp per row, eight rows per block. The lanes stride over V,
// so a warp reads its row with consecutive lanes on consecutive addresses
// and neighbouring warps read neighbouring rows: at V=28 a block reads 8
// rows = 896 contiguous bytes, at V=5000 each warp loops 157 times over its
// own contiguous row. Each lane keeps an online (max, sum-exp) pair, the
// renormalisation online softmax uses, so the row is read once; the warp
// then combines the 32 pairs with shuffles (wtt::neg_logsumexp_row in
// common.cuh, shared with band_prep.cu). bf16/f16 are read natively and
// converted per element; they accumulate in f32, f64 in f64. Lane 0 reads
// x[blank] and x[y_u] (already in L1 after the pass) and writes the row's
// three outputs. With log_probs_input the reduction is skipped.
//
// Extra columns (the big blanks of the multi-blank loss; the JAX package's
// prep.onepass_stats(extra_cols=...)): lane k < K reads x[cols[k]] and
// writes extras[row, k] = x + denom. The K <= 8 indices come in by value.
#include "common.cuh"

namespace {

constexpr int kRowsPerBlock = 8;

template <typename Tin, typename Tacc>
__global__ void prep_kernel(const Tin* __restrict__ acts, const int* __restrict__ labels,
                            Tacc* __restrict__ lpb, Tacc* __restrict__ lpe,
                            Tacc* __restrict__ denom, Tacc* __restrict__ extras,
                            const wtt::ExtraCols cols, long long rows, int T, int U, int V,
                            int blank, int log_probs_input) {
  const int lane = threadIdx.x % wtt::kWarp;
  const long long row = (long long)blockIdx.x * kRowsPerBlock + threadIdx.x / wtt::kWarp;
  if (row >= rows) return;  // the whole warp leaves together
  const Tin* x = acts + row * V;

  const Tacc d = log_probs_input ? Tacc(0) : wtt::neg_logsumexp_row<Tacc>(x, V, lane);
  if (lane == 0) {
    const int u = (int)(row % U);
    const long long b = row / ((long long)T * U);
    const int lab = labels[b * U + u];
    const Tacc xe = (lab >= 0 && lab < V) ? wtt::to_acc(x[lab]) : Tacc(wtt::kNeg);
    lpb[row] = wtt::to_acc(x[blank]) + d;
    lpe[row] = (u == U - 1) ? Tacc(wtt::kNeg) : xe + d;
    if (denom != nullptr) denom[row] = d;
  }
  int col = -1;  // lane k < K takes extra column k (a select: no indexed copy of `cols`)
#pragma unroll
  for (int k = 0; k < wtt::kMaxExtraCols; ++k)
    if (lane == k) col = cols.col[k];
  if (col >= 0) extras[row * cols.n + lane] = wtt::to_acc(x[col]) + d;
}

template <typename Tin, typename Tacc>
int launch(const void* acts, const int* labels, void* lpb, void* lpe, void* denom,
           void* extras, const wtt::ExtraCols& cols, long long rows, int T, int U, int V,
           int blank, int log_probs_input, cudaStream_t stream) {
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  prep_kernel<Tin, Tacc><<<(unsigned)blocks, kRowsPerBlock * wtt::kWarp, 0, stream>>>(
      static_cast<const Tin*>(acts), labels, static_cast<Tacc*>(lpb),
      static_cast<Tacc*>(lpe), static_cast<Tacc*>(denom), static_cast<Tacc*>(extras), cols,
      rows, T, U, V, blank, log_probs_input);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// acts: (B,T,U,V) of type `dtype`; labels: (B,U) int32 (column U-1 unused);
// lpb, lpe, denom: (B,T,U) f32, or f64 for f64 acts; denom may be null
// (log_probs_input); extras: (B,T,U,K) of the same type for the K columns
// extra_cols (a host array, each inside [0, V); K <= wtt::kMaxExtraCols).
// Returns the launch's cudaError_t.
int wtt_prep(const void* acts, int dtype, const int* labels, void* lpb, void* lpe,
             void* denom, void* extras, const int* extra_cols, int K, long long rows, int T,
             int U, int V, int blank, int log_probs_input, void* stream) {
  if (rows == 0) return 0;
  wtt::ExtraCols cols;
  if (!wtt::extra_cols(extra_cols, K, V, &cols)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case wtt::kF32:
      return launch<float, float>(acts, labels, lpb, lpe, denom, extras, cols, rows, T, U, V,
                                  blank, log_probs_input, s);
    case wtt::kF64:
      return launch<double, double>(acts, labels, lpb, lpe, denom, extras, cols, rows, T, U, V,
                                    blank, log_probs_input, s);
    case wtt::kBF16:
      return launch<__nv_bfloat16, float>(acts, labels, lpb, lpe, denom, extras, cols, rows, T,
                                          U, V, blank, log_probs_input, s);
    case wtt::kF16:
      return launch<__half, float>(acts, labels, lpb, lpe, denom, extras, cols, rows, T, U, V,
                                   blank, log_probs_input, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* wtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
