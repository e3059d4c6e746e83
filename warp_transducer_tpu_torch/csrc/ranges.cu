// Range kernel: band starts from the lattice's posteriors, per utterance,
// the whole of the JAX package's ranges_from_posteriors in one launch.
//
// Replaces: no Pallas kernel. The JAX package forms the posterior
// γ = α + β − ll, takes its argmax over u and runs three lax.scans that XLA
// lowers (warp_transducer_tpu/ops/pruned.py:94-150, ranges_from_posteriors);
// as torch ops the argmax would write and read a (B, T, U) γ (two passes and
// an argmax, ≈ 1.4 GB of traffic at B = 128, T = 1500, U = 301) and the
// scans would be about 3·T small launches a call.
//
// What it computes (ops/band.py::posterior_peaks, then band_starts):
//   best_u(t) = the first u of largest (α(t, u) + β(t, u)) − ll, in the
//   input's type and in that order of rounding, so the argmax agrees bit
//   for bit (NaN above every number, as torch.argmax and jnp.argmax);
// then, with hi = max(U_b − S, 0) and raw = clip(best_u − (S−1)/2, 0, hi):
//   1. forward clamp: r(t) = min(max(raw(t), r(t−1)), r(t−1) + S−1) from
//      r(−1) = 0, then r(0) = 0 and r(T_b−1) = hi;
//   2. backward raise: r(t) = max(r(t), r(t+1) − (S−1)), then r(0) = 0;
//   3. forward fix: the clamp of 1. again from 0, the value at T_b−1 held to
//      the end.
// The plain version also caps each clamp at hi and clips the result to
// [0, max(U_b − 1, 0)]; both are no-ops (raw <= hi, so every r <= hi, and
// hi <= U_b − 1 as S >= 2), so the kernel leaves them out. Frames from T_b
// on feed nothing the kernel returns (r(T_b−1) is forced to hi, which
// every raise from above stays under, and the result is held from there),
// nor does the peak of frame T_b−1 itself, so for 1 <= T_b <= T the kernel
// reads frames 0 .. T_b−2 only and walks T_b frames; T_b <= 0 gives zeros;
// T_b > T (outside the contract) reads and walks all T frames unforced.
//
// Bound on this card: α and β read once at the frames it needs, over
// 3.35 TB/s (231 MB each at B = 128, T = 1500, U = 301, f32), and the
// scans' chain, 3·T_b dependent steps of one thread an utterance.
//
// Design, one block per utterance (the plan, `plan` below):
// * The argmax, off any chain: a row (one frame) belongs to a group of G
//   lanes, G the largest power of two up to a warp that leaves each lane
//   kLaneMin of the row's U elements at least (G = 32 at U = 301, 4 at
//   U = 21, 1 below U = 8; a template parameter, one kernel instance each),
//   so a warp takes 32/G rows at once, the block's warps taking rows in
//   turn, as many warps as the rows need (up to 32). A lane loads 48 bytes
//   of its elements of α and of β at once, at constant offsets from one
//   pointer (coalesced across the group; the rows need not start on any
//   grid), then keeps a (value, first index) pair; the group combines its
//   pairs by xor shuffles: the larger value wins, on equal values (or two
//   NaNs) the smaller index. That order is total (the indices differ), so
//   every combine order gives the first maximum. The group's first lane
//   parks best_u in shared memory.
// * The scans, a short chain: one thread walks the three scans over the
//   utterance's best_u in shared memory, kScanStep steps an iteration, the
//   next iteration's values loaded (two 16-byte shared loads) before the
//   current steps and the results stored after them, so the dependent work
//   of a step is the clamp alone: a max then an add-min forward, one
//   add-max backward (VIMNMX, VIADDMNMX). The slots past the walked frames
//   hold values that leave the chain unchanged (kLow backward and in the
//   third scan). Then the block writes the starts out, coalesced.
// The plan takes this layout at every shape. A grid-wide argmax kernel
// followed by a scan kernel, a block an utterance, measured 1% slower at
// the long-utterance pruned shape (B = 128, T = 1500, U = 301) and 34%
// slower at the large-vocabulary one (B = 128, T = 150, U = 21: two
// launches) on an H100 (PERF.md, scripts/time_band.py); it was faster where B is well
// below the SM count and the utterances are long (B = 16, 32 at T = 1500),
// where a block an utterance leaves most SMs idle.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kMaxWarps = 32;
// A lane of a row's group reads at least this many of the row's elements.
constexpr int kLaneMin = 4;
// Steps of a scan iteration: two int4 of shared memory.
constexpr int kScanStep = 8;
// A start no scan step raises: max(kLow, r - (S-1)) and min(max(kLow, r),
// r + S-1) leave r as it is, and kLow - (S-1) does not overflow.
constexpr int kLow = INT_MIN / 2;

struct Plan {
  int group;  // lanes a row
  int warps;  // a block
};

// The launch plan for utterances of T frames and rows of U elements
// (ops/cuda/ranges.py::plan mirrors it; a card test holds the two equal).
inline Plan plan(int T, int U) {
  int g = 1;
  while (g < wtt::kWarp && 2 * g * kLaneMin <= U) g *= 2;
  const int rows_per_warp = wtt::kWarp / g;
  const int w = (T + rows_per_warp - 1) / rows_per_warp;
  return Plan{g, w < 1 ? 1 : (w > kMaxWarps ? kMaxWarps : w)};
}

// Shared memory of a block: T starts rounded up to a scan iteration, and
// one iteration more for the loads taken ahead.
__host__ __device__ inline size_t smem_bytes(int T) {
  return (size_t)((T + kScanStep - 1) / kScanStep + 1) * kScanStep * sizeof(int);
}

// (v, i) comes before (w, j) in the argmax's order.
template <typename F>
__device__ __forceinline__ bool first_max(F v, int i, F w, int j) {
  const bool vn = v != v, wn = w != w;
  return vn ? (!wn || i < j) : (!wn && (v > w || (v == w && i < j)));
}

// The first argmax over c of (a[c] + be[c]) − l, c < U, for a group of G
// lanes (g the lane's place in it); every lane of the warp calls it, and
// every lane of the group returns the row's index. A lane takes its
// elements g, g + G, ... kChunk at once: every load first, each at a
// constant offset from the lane's pointer (G is a template parameter, so
// the loads need no address arithmetic and no branch, only a predicate),
// then the pairs, in f32 (or f64) in the plain version's order, from
// (−inf, g), an element taken only when strictly larger (or a NaN over a
// number), so a lane keeps its first maximum (g itself where its elements
// are all −inf); the update is a select, no branch. The group then
// combines its pairs by first_max over xor shuffles.
template <int G, typename F>
__device__ __forceinline__ int row_argmax(const F* __restrict__ a, const F* __restrict__ be,
                                          F l, int U, int g) {
  constexpr int kChunk = 48 / (int)sizeof(F);  // a lane's elements of one array in flight
  F best = -F(INFINITY);  // element g's place: a row of -inf keeps its first index
  int bi = g;
  const F* pa = a + g;
  const F* pb = be + g;
  for (int c0 = g; c0 < U; c0 += kChunk * G, pa += kChunk * G, pb += kChunk * G) {
    F va[kChunk], vb[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const bool in = c0 + k * G < U;
      va[k] = in ? pa[k * G] : F(0);
      vb[k] = in ? pb[k * G] : F(0);
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int c = c0 + k * G;
      const F x = (va[k] + vb[k]) - l;
      const bool take = (c < U) & ((x > best) | ((x != x) & (best == best)));
      best = take ? x : best;
      bi = take ? c : bi;
    }
  }
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) {
    const F ob = __shfl_xor_sync(0xffffffffu, best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    const bool take = first_max(ob, oi, best, bi);
    best = take ? ob : best;
    bi = take ? oi : bi;
  }
  return bi;
}

// The three scans over row[0 .. m) (frames walked), row[0 .. n) holding
// best_u (frames whose peak counts); one thread. row holds smem_bytes(T).
__device__ __forceinline__ void scans(int* row, int n, int m, bool force, int hi, int step,
                                      int half) {
  int4* r4 = reinterpret_cast<int4*>(row);
  constexpr int kVecs = kScanStep / 4;
  int x[kScanStep];
  int4 a0, a1;
  // 1. forward clamp over frames 0 .. n-1
  int r = 0;
  a0 = r4[0];
  a1 = r4[1];
#pragma unroll 1
  for (int k = 0; k < n; k += kScanStep) {
    const int4 b0 = r4[k / 4 + kVecs], b1 = r4[k / 4 + kVecs + 1];  // ahead
    x[0] = a0.x; x[1] = a0.y; x[2] = a0.z; x[3] = a0.w;
    x[4] = a1.x; x[5] = a1.y; x[6] = a1.z; x[7] = a1.w;
#pragma unroll
    for (int j = 0; j < kScanStep; ++j) {
      const int raw = min(max(x[j] - half, 0), hi);
      r = min(max(raw, r), r + step);
      x[j] = r;
    }
    r4[k / 4] = make_int4(x[0], x[1], x[2], x[3]);
    r4[k / 4 + 1] = make_int4(x[4], x[5], x[6], x[7]);
    a0 = b0;
    a1 = b1;
  }
  if (force) row[n] = hi;  // the last frame reaches the terminal cell
  const int end = (m + kScanStep - 1) / kScanStep * kScanStep;
  for (int t = m; t < end; ++t) row[t] = kLow;
  // 2. backward raise from frame m-1 down
  r = kLow;
  int k = end - kScanStep;
  a0 = r4[k / 4];
  a1 = r4[k / 4 + 1];
#pragma unroll 1
  for (; k >= 0; k -= kScanStep) {
    const int kb = k >= kScanStep ? k - kScanStep : 0;  // ahead, below
    const int4 b0 = r4[kb / 4], b1 = r4[kb / 4 + 1];
    x[0] = a0.x; x[1] = a0.y; x[2] = a0.z; x[3] = a0.w;
    x[4] = a1.x; x[5] = a1.y; x[6] = a1.z; x[7] = a1.w;
#pragma unroll
    for (int j = kScanStep - 1; j >= 0; --j) {
      r = max(x[j], r - step);
      x[j] = r;
    }
    r4[k / 4] = make_int4(x[0], x[1], x[2], x[3]);
    r4[k / 4 + 1] = make_int4(x[4], x[5], x[6], x[7]);
    a0 = b0;
    a1 = b1;
  }
  row[0] = 0;
  // 3. forward fix over frames 0 .. m-1
  r = 0;
  a0 = r4[0];
  a1 = r4[1];
#pragma unroll 1
  for (k = 0; k < m; k += kScanStep) {
    const int4 b0 = r4[k / 4 + kVecs], b1 = r4[k / 4 + kVecs + 1];  // ahead
    x[0] = a0.x; x[1] = a0.y; x[2] = a0.z; x[3] = a0.w;
    x[4] = a1.x; x[5] = a1.y; x[6] = a1.z; x[7] = a1.w;
#pragma unroll
    for (int j = 0; j < kScanStep; ++j) {
      r = min(max(x[j], r), r + step);
      x[j] = r;
    }
    r4[k / 4] = make_int4(x[0], x[1], x[2], x[3]);
    r4[k / 4 + 1] = make_int4(x[4], x[5], x[6], x[7]);
    a0 = b0;
    a1 = b1;
  }
}

template <typename F, int G>
__global__ void __launch_bounds__(kMaxWarps * wtt::kWarp, 1)
    ranges_kernel(const F* __restrict__ alphas, const F* __restrict__ betas,
                  const F* __restrict__ ll, const int* __restrict__ input_lengths,
                  const int* __restrict__ label_lengths, int* __restrict__ ranges, int T, int U,
                  int S) {
  extern __shared__ __align__(16) int row[];
  const int b = blockIdx.x;
  const int Tb = input_lengths[b];
  const int hi = max(label_lengths[b] + 1 - S, 0);
  // Frames walked (m) and frames whose peak counts (n).
  const bool force = Tb >= 1 && Tb <= T;
  const int m = Tb <= 0 ? 0 : min(Tb, T);
  const int n = force ? m - 1 : m;

  // The peaks of frames 0 .. n-1, a group of G lanes a frame.
  const F l = ll[b];
  const long long base = (long long)b * T * U;
  const int lane = threadIdx.x % wtt::kWarp, warps = blockDim.x / wtt::kWarp;
  constexpr int per_warp = wtt::kWarp / G;
  const int q = lane / G;
  for (int t0 = threadIdx.x / wtt::kWarp * per_warp; t0 < n; t0 += warps * per_warp) {
    const long long off = base + (long long)min(t0 + q, n - 1) * U;
    const int bi = row_argmax<G>(alphas + off, betas + off, l, U, lane % G);
    if (lane % G == 0 && t0 + q < n) row[t0 + q] = bi;
  }
  const int words = (int)(smem_bytes(T) / sizeof(int));
  for (int t = n + threadIdx.x; t < words; t += blockDim.x) row[t] = 0;  // defined past the peaks
  __syncthreads();
  if (threadIdx.x == 0 && m > 0) scans(row, n, m, force, hi, S - 1, (S - 1) / 2);
  __syncthreads();
  const int held = m > 0 ? row[m - 1] : 0;
  int* out = ranges + (long long)b * T;
  for (int t = threadIdx.x; t < T; t += blockDim.x) out[t] = t < m ? row[t] : held;
}

template <typename F>
using RangesKernel = void (*)(const F*, const F*, const F*, const int*, const int*, int*, int,
                              int, int);

// The kernel instance for G lanes a row.
template <typename F>
RangesKernel<F> kernel_for(int G) {
  switch (G) {
    case 1: return ranges_kernel<F, 1>;
    case 2: return ranges_kernel<F, 2>;
    case 4: return ranges_kernel<F, 4>;
    case 8: return ranges_kernel<F, 8>;
    case 16: return ranges_kernel<F, 16>;
    default: return ranges_kernel<F, 32>;
  }
}

template <typename F>
int launch(const void* alphas, const void* betas, const void* ll, const int* input_lengths,
           const int* label_lengths, int* ranges, int B, int T, int U, int S,
           cudaStream_t stream) {
  const Plan p = plan(T, U);
  const RangesKernel<F> k = kernel_for<F>(p.group);
  const size_t smem = smem_bytes(T);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  k<<<B, p.warps * wtt::kWarp, smem, stream>>>(
      static_cast<const F*>(alphas), static_cast<const F*>(betas), static_cast<const F*>(ll),
      input_lengths, label_lengths, ranges, T, U, S);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// alphas, betas: (B,T,U) of type `dtype` (f32 or f64); ll: (B,) of that
// type; lengths: (B,) int32; ranges: (B,T) int32; S >= 2, T >= 1, U >= 1.
// Returns the launch's cudaError_t.
int wtt_ranges(const void* alphas, const void* betas, const void* ll, int dtype,
               const int* input_lengths, const int* label_lengths, int* ranges, int B, int T,
               int U, int S, void* stream) {
  if (B == 0) return 0;
  if (T < 1 || U < 1 || S < 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case wtt::kF32:
      return launch<float>(alphas, betas, ll, input_lengths, label_lengths, ranges, B, T, U, S,
                           s);
    case wtt::kF64:
      return launch<double>(alphas, betas, ll, input_lengths, label_lengths, ranges, B, T, U, S,
                            s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The kernel's plan for T frames of U elements into out[3]: lanes a row,
// warps a block, shared-memory bytes a block; the card tests hold it
// against ops/cuda/ranges.py::plan.
void wtt_ranges_plan(int T, int U, int* out) {
  const Plan p = plan(T, U);
  out[0] = p.group;
  out[1] = p.warps;
  out[2] = (int)smem_bytes(T);
}

// Registers and local (spilled) bytes a thread of the kernel instance for
// `dtype` and rows of U elements (its G lanes a row).
int wtt_ranges_attrs(int dtype, int U, int* regs, int* local_bytes) {
  if (dtype != wtt::kF32 && dtype != wtt::kF64) return (int)cudaErrorInvalidValue;
  const int G = plan(1, U).group;
  cudaFuncAttributes a;
  const cudaError_t err = dtype == wtt::kF32 ? cudaFuncGetAttributes(&a, kernel_for<float>(G))
                                             : cudaFuncGetAttributes(&a, kernel_for<double>(G));
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}

}  // extern "C"
