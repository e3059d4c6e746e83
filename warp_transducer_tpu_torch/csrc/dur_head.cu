// Duration-head kernels of the fused TDT loss: the second, tiny projection
// (D <= 8 columns) of the joint features h = tanh(e ⊕ p), on its own, without
// the (B, T, U, H) features ever reaching device memory. They go with the
// fused joint kernels of the token head alone (joint_prep.cu, joint_grad.cu
// without their duration head): the composed route of ops/tdt_fused.py.
//
// Replaces: warp_transducer_tpu/ops/pallas/joint_fused.py::_dur_prep_kernel
// (called through dur_head_prep) and ::_dur_grad_kernel (dur_head_grad).
//
// Prep, per valid row r = (b, t, u): dlog[r] = h·Wd + bias_d, the raw
// duration logits. Gradient, from the cotangent g_dur (B, T, U, D), zero
// outside the lattice: d = (g_dur·Wdᵀ)·(1 − h²), de2[b,t] = Σ_u d,
// dp2[b,u] = Σ_t d, dWd = hᵀ·g_dur. These add to the token head's de and dp,
// since dh enters the (1 − h²) linearly. e, p, Wd, bias_d and g_dur are f32
// and h is never rounded. Rows outside (t < T_b) & (u < U_b) are not visited:
// the wrapper pre-fills dlog, de2 and dp2 with zeros.
//
// Bound on this card: bytes for the prep (e, p read, D values a row written:
// 2·H·D operations a row are few beside them); operations or bytes for the
// gradient, 4·R·H·D against e, p, g_dur, de2, dp2. Both spend their time on
// the R·H tanh and on latency.
//
// Design. The TPU kernels walk (b, T tile) in order and carry dWd and dp
// across the grid. Here:
// * dur_prep_kernel — a warp per valid row (joint.cuh::dur_row): the lanes
//   run along k, read e[b,t] and p[b,u] contiguously (both stay in L2: each
//   row of e is read U_b times), and combine their D partial sums with
//   shuffles. No shared memory.
// * dur_grad_kernel — joint.cuh::dur_grad_tiles. A few hundred blocks each
//   walk every nsplit-th tile of valid rows with the h tile in shared memory;
//   thread k keeps its D sums of dWd in registers across the tiles, d takes
//   h's place and goes to de2 and dp2 by atomicAdd as in joint_grad.cu. Each
//   block writes one partial of dWd and sum_parts_kernel adds them in a fixed
//   order, so dWd is deterministic; de2 and dp2 are sums of atomics, in an
//   order that varies from run to run.
#include "joint.cuh"

namespace {

using namespace wtt::joint;

__global__ void __launch_bounds__(kThreads)
dur_prep_kernel(const float* __restrict__ e, const float* __restrict__ p,
                const float* __restrict__ Wd, const float* __restrict__ bias_d, Rows rows,
                float* __restrict__ dlog, int H, int D) {
  const int warp = threadIdx.x / wtt::kWarp, lane = threadIdx.x % wtt::kWarp;
  int b, t, u;
  if (!locate(rows, (long long)blockIdx.x * kWarps + warp, b, t, u)) return;
  float out[kPanel];
  dur_row(e + ((long long)b * rows.T + t) * H, p + ((long long)b * rows.U + u) * H, Wd, H, D, lane,
          out);
  store_dur_row(dlog + (((long long)b * rows.T + t) * rows.U + u) * D, out, bias_d, D, lane);
}

template <int TM>
__global__ void __launch_bounds__(kThreads)
dur_grad_kernel(const float* __restrict__ e, const float* __restrict__ p,
                const float* __restrict__ Wd, const float* __restrict__ g_dur, Rows rows,
                float* __restrict__ de, float* __restrict__ dp, float* __restrict__ dWd_part,
                int H, int D) {
  extern __shared__ float smem[];
  dur_grad_tiles<kDim * TM, true>(e, p, Wd, g_dur, rows, de, dp, dWd_part, H, D, smem);
}

template <int TM>
int launch_grad(const float* e, const float* p, const float* Wd, const float* g_dur, Rows rows,
                float* de, float* dp, float* dWd, float* dWd_part, int nsplit, int H, int D,
                cudaStream_t stream) {
  auto kernel = dur_grad_kernel<TM>;
  const size_t bytes = dur_grad_smem_bytes(H, kDim * TM);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<nsplit, kThreads, bytes, stream>>>(e, p, Wd, g_dur, rows, de, dp, dWd_part, H, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)sum_parts(dWd_part, dWd, (long long)H * D, nsplit, stream);
}

}  // namespace

extern "C" {

// Dynamic shared memory the gradient kernels of the duration head ask for at
// this H (dur_grad_kernel here, joint_grad_dwd_kernel in joint_grad.cu).
long long wtt_dur_head_smem(int H) {
  return (long long)dur_grad_smem_bytes(H, kDim * tile_param(H));
}

// e: (B,T,H) f32; p: (B,U,H) f32; Wd: (H,D) f32; bias_d: (D,) f32; offsets:
// (B+1) int64 running sums of T_b·U_b; label_lengths: (B,) int32; dlog:
// (B,T,U,D) f32, pre-filled with zeros. 1 <= D <= 8. Returns the launch's
// cudaError_t.
int wtt_dur_head_prep(const void* e, const void* p, const void* Wd, const void* bias_d,
                      const void* offsets, const int* label_lengths, void* dlog, int B, int T,
                      int U, int H, int D, void* stream) {
  const long long cells = (long long)B * T * U;
  if (cells == 0) return 0;
  if (D < 1 || D > kPanel) return (int)cudaErrorInvalidValue;
  const Rows rows{static_cast<const long long*>(offsets), label_lengths, B, T, U};
  dur_prep_kernel<<<(unsigned)((cells + kWarps - 1) / kWarps), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(e), static_cast<const float*>(p), static_cast<const float*>(Wd),
      static_cast<const float*>(bias_d), rows, static_cast<float*>(dlog), H, D);
  return (int)cudaGetLastError();
}

// The inputs of wtt_dur_head_prep with g_dur: (B,T,U,D) f32, zero outside
// the lattice, in place of bias_d. de: (B,T,H) f32 and dp: (B,U,H) f32, both
// zeroed by the caller (the kernel adds into them); dWd: (H,D) f32, written
// whole; dWd_part: (nsplit,H,D) f32 scratch, one partial a block. Returns the
// launches' cudaError_t.
int wtt_dur_head_grad(const void* e, const void* p, const void* Wd, const void* g_dur,
                      const void* offsets, const int* label_lengths, void* de, void* dp,
                      void* dWd, void* dWd_part, int nsplit, int B, int T, int U, int H, int D,
                      void* stream) {
  if (H == 0) return 0;
  if (H > kMaxH || D < 1 || D > kPanel || nsplit < 1) return (int)cudaErrorInvalidValue;
  const Rows rows{static_cast<const long long*>(offsets), label_lengths, B, T, U};
  const float* ef = static_cast<const float*>(e);
  const float* pf = static_cast<const float*>(p);
  const float* wd = static_cast<const float*>(Wd);
  const float* gd = static_cast<const float*>(g_dur);
  float* o1 = static_cast<float*>(de);
  float* o2 = static_cast<float*>(dp);
  float* o3 = static_cast<float*>(dWd);
  float* part = static_cast<float*>(dWd_part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile_param(H)) {
    case 4: return launch_grad<4>(ef, pf, wd, gd, rows, o1, o2, o3, part, nsplit, H, D, s);
    case 2: return launch_grad<2>(ef, pf, wd, gd, rows, o1, o2, o3, part, nsplit, H, D, s);
    default: return launch_grad<1>(ef, pf, wd, gd, rows, o1, o2, o3, part, nsplit, H, D, s);
  }
}

}  // extern "C"
