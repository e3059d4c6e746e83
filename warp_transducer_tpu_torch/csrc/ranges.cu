// Range kernel: per utterance, the three scans over T that turn the
// per-frame posterior peaks best_u = argmax_u(α + β - ll) into band starts.
//
// Replaces: no Pallas kernel. The JAX package runs these scans as three
// lax.scans that XLA lowers (warp_transducer_tpu/ops/pruned.py:94-150,
// ranges_from_posteriors); as torch ops they would be about 3·T small
// launches a call (4,500 at T = 1500), and the host would set the pace of
// the whole pruned step.
//
// The scans (ops/band.py::band_starts), with hi = max(U_b - S, 0):
//   1. forward clamp: r(t) = min(clip(raw(t), r(t-1), r(t-1) + S-1), hi)
//      from r(-1) = 0, raw = clip(best_u - (S-1)/2, 0, hi); then r(0) = 0
//      and r(T_b-1) = hi (the band must reach the terminal cell);
//   2. backward raise: r(t) = max(r(t), r(t+1) - (S-1)), then r(0) = 0;
//   3. forward fix: the clamp of 1. again from 0, then the value at
//      max(T_b-1, 0) held to the end and everything clipped to
//      [0, max(U_b-1, 0)].
//
// Bound on this card: the chain of 3·T dependent steps of one thread, not
// bytes (it reads and writes B·T ints). What the design does about it: one
// block per utterance stages its T values in shared memory (a coalesced
// warp load and store), so each dependent step costs a shared-memory
// access, not a device-memory one; the B utterances run in parallel.
#include "common.cuh"

namespace {

__global__ void band_starts_kernel(const int* __restrict__ best_u,
                                   const int* __restrict__ input_lengths,
                                   const int* __restrict__ label_lengths,
                                   int* __restrict__ ranges, int T, int S) {
  extern __shared__ int row[];
  const int b = blockIdx.x;
  const int* src = best_u + (long long)b * T;
  int* dst = ranges + (long long)b * T;
  for (int t = threadIdx.x; t < T; t += blockDim.x) row[t] = src[t];
  __syncthreads();
  if (threadIdx.x == 0) {
    const int Tb = input_lengths[b];
    const int Ub = label_lengths[b] + 1;
    const int hi = max(Ub - S, 0);
    const int step = S - 1;
    // 1. forward clamp
    int r = 0;
    for (int t = 0; t < T; ++t) {
      const int raw = min(max(row[t] - step / 2, 0), hi);
      r = min(min(max(raw, r), r + step), hi);
      row[t] = r;
    }
    row[0] = 0;
    if (Tb - 1 >= 0 && Tb - 1 < T) row[Tb - 1] = hi;
    // 2. backward raise
    r = row[T - 1];
    for (int t = T - 2; t >= 0; --t) {
      r = max(row[t], r - step);
      row[t] = r;
    }
    row[0] = 0;
    // 3. forward fix up to the last frame, then hold and clip
    const int t_end = min(max(Tb - 1, 0), T - 1);
    const int top = max(Ub - 1, 0);
    r = 0;
    for (int t = 0; t <= t_end; ++t) {
      r = min(min(max(row[t], r), r + step), hi);
      row[t] = min(max(r, 0), top);
    }
    const int held = min(max(r, 0), top);
    for (int t = t_end + 1; t < T; ++t) row[t] = held;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < T; t += blockDim.x) dst[t] = row[t];
}

}  // namespace

extern "C" {

// best_u, ranges: (B,T) int32; lengths: (B,) int32; S >= 2, T >= 1.
// Returns the launch's cudaError_t.
int wtt_band_starts(const int* best_u, const int* input_lengths, const int* label_lengths,
                    int* ranges, int B, int T, int S, void* stream) {
  if (B == 0) return 0;
  if (T < 1 || S < 2) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)T * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        band_starts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  band_starts_kernel<<<B, wtt::kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
      best_u, input_lengths, label_lengths, ranges, T, S);
  return (int)cudaGetLastError();
}

}  // extern "C"
