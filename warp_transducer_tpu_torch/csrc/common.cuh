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

// Extra vocabulary columns of the prep and gradient kernels (the big blanks
// of the multi-blank loss), passed to the kernel by value up to
// kMaxExtraCols of them. Past that, the kernels' instances of their own read
// the columns from a table in device memory and loop over it at run time
// (there is no cap); ExtraCols then carries the count alone.
constexpr int kMaxExtraCols = 8;
struct ExtraCols {
  int n;
  int col[kMaxExtraCols];  // entries beyond n hold -1
};
// Fill `out` from a host array of K indices; false unless 0 <= K <=
// kMaxExtraCols and every index lies inside [0, V).
inline bool extra_cols(const int* host, int K, int V, ExtraCols* out) {
  if (K < 0 || K > kMaxExtraCols || (K > 0 && host == nullptr)) return false;
  out->n = K;
  for (int k = 0; k < kMaxExtraCols; ++k) {
    out->col[k] = k < K ? host[k] : -1;
    if (k < K && (host[k] < 0 || host[k] >= V)) return false;
  }
  return true;
}

// Whether K >= 0 host indices (a table of any length) all lie inside [0, V).
inline bool cols_inside(const int* host, int K, int V) {
  if (K < 0 || (K > 0 && host == nullptr)) return false;
  for (int k = 0; k < K; ++k)
    if (host[k] < 0 || host[k] >= V) return false;
  return true;
}
// ExtraCols for K columns of a table read at run time (K > kMaxExtraCols):
// the count, every entry -1.
inline ExtraCols many_cols(int K) {
  ExtraCols c;
  c.n = K;
  for (int k = 0; k < kMaxExtraCols; ++k) c.col[k] = -1;
  return c;
}

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

}  // namespace wtt
