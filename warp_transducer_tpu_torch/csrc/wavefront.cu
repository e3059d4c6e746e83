// Lattice kernel: the RNN-T alpha and beta recursions over the T+U-1
// anti-diagonals of each utterance's (T, U) lattice.
//
// Replaces: warp_transducer_tpu/ops/pallas/wavefront_stream.py:49
// (_stream_kernel, the TPU path) and warp_transducer_tpu/ops/pallas/
// wavefront.py:72 (_kernel, the batch-tiled variant). Both step one whole
// diagonal of a skewed (N, B, U) panel per iteration; here every block
// walks the diagonals of one utterance in place.
//
// Bound on this card: neither bytes nor operations but the dependency
// chain. The kernel moves 4·B·T·U values (lpb, lpe in; alphas, betas out)
// and does about ten operations per cell, which the card would finish in
// microseconds; but diagonal n needs diagonal n-1, so each block runs
// T+U-1 steps in sequence, each a global load, a log1p/exp and a
// __syncthreads. What the design does about it: alpha and beta are
// independent, so they run as two blocks side by side (grid (B, 2)), and
// the previous diagonal is kept in shared memory (double-buffered, one
// barrier per diagonal) so a step reads device memory only for lpb/lpe.
// Those reads, at t = n-u in the (B, T, U) layout, are strided by U-1
// between neighbouring threads and not coalesced; a later change may stage
// them through shared memory.
//
// Layout: grid (B, 2) with blockIdx.y choosing alpha (0) or beta (1), or
// (B, 1) for the scoring path. Thread i handles u = i, i + blockDim, ...
// This is the reference's compute_alphas_kernel<<<B, U>>> layout.
//
// Semantics (as ops/lattice.py and the Pallas kernels): inputs clamped to
// >= NEG; valid cells (t < T_b) & (u < U_b); alpha(0,0) = 0;
// ll_forward = alpha + lpb at (T_b-1, U_b-1); beta seeded there by a masked
// overwrite; ll_backward = beta(0,0). Every cell of alphas/betas is
// written, invalid ones with NEG.
#include "common.cuh"

namespace {

template <typename T>
__global__ void wavefront_kernel(const T* __restrict__ lpb, const T* __restrict__ lpe,
                                 const int* __restrict__ input_lengths,
                                 const int* __restrict__ label_lengths,
                                 T* __restrict__ alphas, T* __restrict__ betas,
                                 T* __restrict__ ll_forward, T* __restrict__ ll_backward,
                                 int Tmax, int U) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* buf0 = reinterpret_cast<T*>(smem_raw);
  T* buf1 = buf0 + U;
  const T neg = T(wtt::kNeg);
  const int b = blockIdx.x;
  const int Tb = input_lengths[b];
  const int Ub = label_lengths[b] + 1;
  const int N = Tmax + U - 1;
  const long long base = (long long)b * Tmax * U;
  const T* pb = lpb + base;
  const T* pe = lpe + base;

  if (blockIdx.y == 0) {
    // ---- alpha: diagonal n from diagonal n-1 ----
    T* out = alphas + base;
    T* prev = buf0;
    T* cur = buf1;
    for (int u = threadIdx.x; u < U; u += blockDim.x) {
      T a = (u == 0 && Tb > 0 && Ub > 0) ? T(0) : neg;
      prev[u] = a;
      if (u == 0) {
        out[0] = a;
        ll_forward[b] = neg;
        if (Tb == 1 && Ub == 1) ll_forward[b] = a + wtt::clamp_neg(pb[0]);
      }
    }
    __syncthreads();
    for (int n = 1; n < N; ++n) {
      for (int u = threadIdx.x; u < U; u += blockDim.x) {
        const int t = n - u;
        T a = neg;
        if (t >= 0 && t < Tmax) {
          const long long cell = (long long)t * U + u;
          if (t < Tb && u < Ub) {
            const T no_emit = t >= 1 ? prev[u] + wtt::clamp_neg(pb[cell - U]) : neg;
            const T emit = u >= 1 ? prev[u - 1] + wtt::clamp_neg(pe[cell - 1]) : neg;
            a = wtt::lse(no_emit, emit);
            if (t == Tb - 1 && u == Ub - 1) ll_forward[b] = a + wtt::clamp_neg(pb[cell]);
          }
          out[cell] = a;
        }
        cur[u] = a;
      }
      __syncthreads();
      T* tmp = prev;
      prev = cur;
      cur = tmp;
    }
  } else {
    // ---- beta: diagonal n from diagonal n+1 ----
    T* out = betas + base;
    T* next = buf0;
    T* cur = buf1;
    for (int u = threadIdx.x; u < U; u += blockDim.x) next[u] = neg;
    __syncthreads();
    for (int n = N - 1; n >= 0; --n) {
      for (int u = threadIdx.x; u < U; u += blockDim.x) {
        const int t = n - u;
        T v = neg;
        if (t >= 0 && t < Tmax) {
          const long long cell = (long long)t * U + u;
          const T lpb_c = wtt::clamp_neg(pb[cell]);
          if (t == Tb - 1 && u == Ub - 1) {
            v = lpb_c;  // the terminal cell seeds the sweep
          } else if (t < Tb && u < Ub) {
            const T no_emit = t + 1 < Tmax ? next[u] + lpb_c : neg;
            const T emit = u + 1 < U ? next[u + 1] + wtt::clamp_neg(pe[cell]) : neg;
            v = wtt::lse(no_emit, emit);
          }
          out[cell] = v;
        }
        cur[u] = v;
      }
      __syncthreads();
      T* tmp = next;
      next = cur;
      cur = tmp;
    }
    if (threadIdx.x == 0) ll_backward[b] = next[0];
  }
}

template <typename T>
int launch(const void* lpb, const void* lpe, const int* input_lengths,
           const int* label_lengths, void* alphas, void* betas, void* ll_forward,
           void* ll_backward, int B, int Tmax, int U, int compute_betas,
           cudaStream_t stream) {
  const size_t smem = 2 * (size_t)U * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        wavefront_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int threads = U < 1024 ? ((U + 31) / 32) * 32 : 1024;
  dim3 grid(B, compute_betas ? 2 : 1);
  wavefront_kernel<T><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(lpb), static_cast<const T*>(lpe), input_lengths, label_lengths,
      static_cast<T*>(alphas), static_cast<T*>(betas), static_cast<T*>(ll_forward),
      static_cast<T*>(ll_backward), Tmax, U);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// lpb, lpe: (B,T,U) f32 or f64 (`dtype`); lengths: (B,) int32;
// alphas, betas: (B,T,U) (betas unused and may be null when
// compute_betas == 0); ll_forward, ll_backward: (B,). Returns the launch's
// cudaError_t.
int wtt_wavefront(const void* lpb, const void* lpe, int dtype, const int* input_lengths,
                  const int* label_lengths, void* alphas, void* betas, void* ll_forward,
                  void* ll_backward, int B, int T, int U, int compute_betas, void* stream) {
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case wtt::kF32:
      return launch<float>(lpb, lpe, input_lengths, label_lengths, alphas, betas,
                           ll_forward, ll_backward, B, T, U, compute_betas, s);
    case wtt::kF64:
      return launch<double>(lpb, lpe, input_lengths, label_lengths, alphas, betas,
                            ll_forward, ll_backward, B, T, U, compute_betas, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
