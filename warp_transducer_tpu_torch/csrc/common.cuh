// Shared helpers of the RNN-T kernels: the finite sentinel, the log-sum-exp
// of two finite values, math overloads for float/double, per-element
// conversion of the input types, and warp reductions.
#pragma once

#include <cfloat>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace wtt {

// Large finite negative: behaves as -inf under log-sum-exp but keeps the
// arithmetic NaN-free (exp(NEG - x) flushes to 0, NEG + NEG stays finite).
// Same value as NEG in ops/prep.py and the Pallas kernels.
constexpr double kNeg = -1.0e30;

// Type codes shared with the Python wrappers (ops/cuda/__init__.py).
enum DType { kF32 = 0, kF64 = 1, kBF16 = 2, kF16 = 3 };

constexpr int kWarp = 32;

// Read an element of any input type in its accumulation type.
__device__ __forceinline__ float to_acc(float x) { return x; }
__device__ __forceinline__ double to_acc(double x) { return x; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_acc(__half x) { return __half2float(x); }

// Write an accumulated value in the output type (one rounding).
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(double* p, double x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void store(__half* p, float x) { *p = __float2half(x); }

__device__ __forceinline__ float ex(float x) { return expf(x); }
__device__ __forceinline__ double ex(double x) { return exp(x); }
__device__ __forceinline__ float lg(float x) { return logf(x); }
__device__ __forceinline__ double lg(double x) { return log(x); }
// Products rounded on their own, never contracted into an FMA, so the
// kernels round as the plain PyTorch versions do.
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

template <typename T> __device__ __forceinline__ T lowest();
template <> __device__ __forceinline__ float lowest<float>() { return -FLT_MAX; }
template <> __device__ __forceinline__ double lowest<double>() { return -DBL_MAX; }

// log(exp(a) + exp(b)) for finite inputs (the _lse of pallas/wavefront.py).
__device__ __forceinline__ float lse(float a, float b) {
  float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}
__device__ __forceinline__ double lse(double a, double b) {
  double m = fmax(a, b);
  return m + log1p(exp(-fabs(a - b)));
}

// max(x, NEG) that keeps a NaN, as jnp.maximum and torch.clamp_min do.
template <typename T>
__device__ __forceinline__ T clamp_neg(T x) {
  return x < T(kNeg) ? T(kNeg) : x;
}

template <typename T>
__device__ __forceinline__ T warp_max(T x) {
  for (int o = kWarp / 2; o > 0; o >>= 1) {
    T y = __shfl_xor_sync(0xffffffffu, x, o);
    x = y > x ? y : x;
  }
  return x;
}
template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
  for (int o = kWarp / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// -logsumexp of one row of V values, reduced by the calling warp (the row
// body of prep.cu and band_prep.cu). The lanes stride over the row, each
// keeping an online (max, sum-exp) pair, the renormalisation online softmax
// uses, so the row is read once; the warp then combines the 32 pairs with
// shuffles. Each element is converted to Tacc first (bf16/f16 to f32, f64
// to f32 where Tacc is float). Every lane returns the row's value.
template <typename Tacc, typename Tin>
__device__ __forceinline__ Tacc neg_logsumexp_row(const Tin* __restrict__ x, int V, int lane) {
  Tacc m = lowest<Tacc>(), s = Tacc(0);
  for (int v = lane; v < V; v += kWarp) {
    const Tacc xv = static_cast<Tacc>(to_acc(x[v]));
    if (xv > m) {
      s = s * ex(m - xv) + Tacc(1);
      m = xv;
    } else {
      s += ex(xv - m);
    }
  }
  const Tacc row_max = warp_max(m);
  const Tacc row_sum = warp_sum(s * ex(m - row_max));
  return -(row_max + lg(row_sum));
}

}  // namespace wtt
