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
// Design: prep.cu's, the tiled row reductions of reduce.cuh. At the small
// V of the long-utterance band (V = 50: 960,000 rows of 200 bytes at
// B = 128, T = 1500, S = 5) a block takes a tile of rows, rows·V
// contiguous elements, with 16-byte loads across row boundaries all in
// flight at once, reduces each row from shared memory with a few threads,
// and a thread a row stages the row's label during the loads and emits the
// three fields, coalesced across the tile, reading x[blank] and x[label]
// from shared memory. Above reduce.cuh's switch point (V > 256) a warp
// takes a row, kUnroll vectors a lane in flight. Every input type is
// converted to f32 per element and the row is computed in f32 (f64 too),
// as the JAX package computes the pruned loss in f32 for every input type.
// The plan comes from reduce.cuh::plan for V, the input's element size and
// the band's actual alignment (a view need not start on the 16-byte grid).
#include "reduce.cuh"

namespace {

namespace red = wtt::reduce;

template <typename TIn>
struct BandPrepOp {
  using Tin = TIn;
  using Tacc = float;
  static constexpr bool reduce = true;
  const Tin* acts;
  const int* lab_row;  // (B, T, S), -1 where the row has no label
  float *lpb, *lpe, *denom;
  long long rows;
  int V, blank;
  red::Plan plan;

  struct Stage {
    int lab;
  };
  __device__ __forceinline__ Stage stage(int row) const { return Stage{lab_row[row]}; }
  template <class Read>
  __device__ __forceinline__ void emit(int row, float d, const Read& x, const Stage& st) const {
    const int lab = st.lab;
    lpb[row] = x(blank) + d;
    lpe[row] = (lab >= 0 && lab < V) ? x(lab) + d : float(wtt::kNeg);
    denom[row] = d;
  }
};

template <typename Tin, int VEC>
__global__ void __launch_bounds__(red::kThreads) band_prep_tile_kernel(const BandPrepOp<Tin> op) {
  red::tile_body<VEC>(op);
}
template <typename Tin, int VEC>
__global__ void __launch_bounds__(red::kThreads) band_prep_warp_kernel(const BandPrepOp<Tin> op) {
  red::warp_body<VEC>(op);
}

template <typename Tin>
int launch(const void* acts, const int* lab_row, void* lpb, void* lpe, void* denom,
           long long rows, int V, int blank, const red::Plan& plan, cudaStream_t stream) {
  BandPrepOp<Tin> op;
  op.acts = static_cast<const Tin*>(acts);
  op.lab_row = lab_row;
  op.lpb = static_cast<float*>(lpb);
  op.lpe = static_cast<float*>(lpe);
  op.denom = static_cast<float*>(denom);
  op.rows = rows;
  op.V = V;
  op.blank = blank;
  op.plan = plan;
  constexpr int V16 = 16 / (int)sizeof(Tin);
  return red::launch(op, band_prep_tile_kernel<Tin, 1>, band_prep_tile_kernel<Tin, V16>,
                     band_prep_warp_kernel<Tin, 1>, band_prep_warp_kernel<Tin, V16>, stream);
}

// Registers and local bytes a thread of one kernel instance.
template <typename Tin>
int attrs(int mode, int vec, int* regs, int* local_bytes) {
  constexpr int V16 = 16 / (int)sizeof(Tin);
  cudaFuncAttributes a;
  const cudaError_t err =
      mode == red::kTile
          ? cudaFuncGetAttributes(&a, vec > 1 ? band_prep_tile_kernel<Tin, V16>
                                              : band_prep_tile_kernel<Tin, 1>)
          : cudaFuncGetAttributes(&a, vec > 1 ? band_prep_warp_kernel<Tin, V16>
                                              : band_prep_warp_kernel<Tin, 1>);
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}

int band_prep(const void* acts, int dtype, const int* lab_row, void* lpb, void* lpe,
              void* denom, long long rows, int V, int blank, const red::Plan& plan,
              void* stream) {
  if (rows == 0) return 0;
  // The reductions' row math is 32-bit: every row index below 2^31.
  if (rows >= (1LL << 31) || blank < 0 || blank >= V ||
      !red::plan_ok(plan, V, red::elt_size(dtype)) ||
      (plan.vec > 1 && red::alignment(acts) < 16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case wtt::kF32:
      return launch<float>(acts, lab_row, lpb, lpe, denom, rows, V, blank, plan, s);
    case wtt::kF64:
      return launch<double>(acts, lab_row, lpb, lpe, denom, rows, V, blank, plan, s);
    case wtt::kBF16:
      return launch<__nv_bfloat16>(acts, lab_row, lpb, lpe, denom, rows, V, blank, plan, s);
    case wtt::kF16:
      return launch<__half>(acts, lab_row, lpb, lpe, denom, rows, V, blank, plan, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// acts: (B,T,S,V) of type `dtype`; lab_row: (B,T,S) int32, -1 where the row
// has no label; lpb, lpe, denom: (B,T,S) f32; rows = B·T·S. The plan is
// reduce.cuh's for V, the type and acts' alignment. Returns the launch's
// cudaError_t.
int wtt_band_prep(const void* acts, int dtype, const int* lab_row, void* lpb, void* lpe,
                  void* denom, long long rows, int V, int blank, void* stream) {
  const int elt = red::elt_size(dtype);
  if (elt == 0 || V < 1) return (int)cudaErrorInvalidValue;
  return band_prep(acts, dtype, lab_row, lpb, lpe, denom, rows, V, blank,
                   red::plan(V, elt, red::alignment(acts)), stream);
}

// wtt_band_prep with a plan from the caller (seven unsigned, as
// wtt_reduce_plan gives them): both modes at one V, for the card tests and
// scripts/time_band.py. A plan outside the bodies' limits is refused.
int wtt_band_prep_planned(const void* acts, int dtype, const int* lab_row, void* lpb,
                          void* lpe, void* denom, long long rows, int V, int blank,
                          const unsigned* plan_host, void* stream) {
  const unsigned* h = plan_host;
  red::Plan plan{(int)h[0], (int)h[1], (int)h[2], h[3], (int)h[4], (int)h[5], (int)h[6]};
  red::division_magic((unsigned)V, &plan.mul, &plan.shr);  // not taken from the caller
  return band_prep(acts, dtype, lab_row, lpb, lpe, denom, rows, V, blank, plan, stream);
}

// Registers and local (spilled) bytes a thread of the kernel instance for
// the type `dtype`, the plan's mode and vectors (vec > 1) or not.
int wtt_band_prep_attrs(int dtype, int mode, int vec, int* regs, int* local_bytes) {
  switch (dtype) {
    case wtt::kF32: return attrs<float>(mode, vec, regs, local_bytes);
    case wtt::kF64: return attrs<double>(mode, vec, regs, local_bytes);
    case wtt::kBF16: return attrs<__nv_bfloat16>(mode, vec, regs, local_bytes);
    case wtt::kF16: return attrs<__half>(mode, vec, regs, local_bytes);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
