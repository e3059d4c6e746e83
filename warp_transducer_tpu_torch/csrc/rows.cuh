// Tiled row passes: the element loops of the kernels that sweep (rows, V)
// tensors once, a row's few scalars applied to each of its V elements
// (grad.cu, band_grad.cu).
//
// Two modes, chosen per call by the planner of ops/cuda/rows.py (`plan`),
// which hands the kernel a Plan:
//
// * Tile (small V). A block of kThreads threads owns `rows` consecutive
//   rows, rows·V contiguous elements (at most kThreads·kVecsPerThread
//   vectors, 16 KB). First one thread per row stages the row's scalars in
//   shared memory (coalesced loads across the block); then every thread
//   takes vectors of the tile's flat element range, thread-strided, with
//   the widest load and store the base alignment allows (16 B, or one
//   element), and a scalar tail. An element's row is its tile offset
//   divided by V, by a multiply-high with the planner's magic numbers, once
//   per vector; within a vector the column steps and wraps. rows·V is a
//   multiple of the vector width, so every tile, and so every vector,
//   starts aligned. This is the Hopper form of what the TPU band gradient
//   does when it lays S rows of V out as one lane-packed stretch
//   (warp_transducer_tpu/ops/pallas/band_pipeline.py:135-163).
// * Warp (large V). A warp per row, kWarpRows rows a block; lane 0 stages
//   the row's scalars in shared memory; the lanes stride over the row by
//   vectors, after a scalar head up to the first aligned element, with a
//   scalar tail; kUnroll vectors a lane are loaded before any is used.
//
// Index math is 32-bit inside a row or a tile (the wrappers keep rows and
// rows·V within their limits); pointers are offset once with 64-bit math.
// A row whose `valid` is 0 is written 0 and its elements are not read (a
// vector that also covers a valid row is read whole, and so is every vector
// of a row shorter than a vector).
//
// An Op supplies: Tio, Tacc; `rows` (long long), `V`, `plan`, `n_extra`;
// `acts` (read when `reads`), `grads`; `Row stage(int row, Tacc* extra)`,
// which fills the row's scalars and its n_extra values; and `Tacc
// apply(const Row&, int col, Tacc x, const Tacc* extra)`, one element.
// tests/test_torch_rows.py mirrors both modes' index loops to check the
// planner: every element covered once, every vector aligned.
#pragma once

#include <cstring>

#include "common.cuh"

namespace wtt {
namespace rows {

enum Mode { kTile = 0, kWarpMode = 1 };

constexpr int kThreads = 256;      // a block, in both modes
constexpr int kVecsPerThread = 4;  // tile mode: a thread's vectors in flight
constexpr int kMaxTileRows = 512;  // tile mode: rows whose scalars a block stages
constexpr int kWarpRows = kThreads / kWarp;
constexpr int kUnroll = 4;  // warp mode: vectors a lane loads before it uses them

// The planner's choice, passed as a host array of five unsigned:
// mode, rows (a tile's, or kWarpRows), vec (1 or 16 bytes of elements),
// and the multiply-high magic of division by V (mul, shr).
struct Plan {
  int mode, rows, vec;
  unsigned mul;
  int shr;
};

inline Plan plan_from(const unsigned* p) {
  return Plan{(int)p[0], (int)p[1], (int)p[2], p[3], (int)p[4]};
}

// True when `p` fits the kernels' limits for rows of V elements of `elt`
// bytes: the planner's invariants, checked again on the C side.
inline bool plan_ok(const Plan& p, int V, int elt) {
  if (V < 1 || (p.vec != 1 && p.vec * elt != 16)) return false;
  if (p.mode == kWarpMode) return p.rows == kWarpRows;
  return p.mode == kTile && p.rows >= 1 && p.rows <= kMaxTileRows &&
         (long long)p.rows * V % p.vec == 0 &&
         (long long)p.rows * V <= (long long)kThreads * kVecsPerThread * p.vec;
}

// n / V for 0 <= n < 2^31: floor(n · mul / 2^32) >> shr (the round-up
// method; mul = ceil(2^(31 + ceil(log2 V)) / V), shr = ceil(log2 V) - 1).
__device__ __forceinline__ int div_v(int n, const Plan& p, int V) {
  return V == 1 ? n : (int)(__umulhi((unsigned)n, p.mul) >> p.shr);
}

// VEC elements of T, as one aligned load or store.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};
template <int BYTES> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = unsigned; };
template <> struct Raw<2> { using type = unsigned short; };

// Streaming loads and stores: the pass reads and writes each element once.
template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load(const T* p) {
  using R = typename Raw<sizeof(T) * VEC>::type;
  const R r = __ldcs(reinterpret_cast<const R*>(p));
  Pack<T, VEC> out;
  memcpy(&out, &r, sizeof(R));
  return out;
}
template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const Pack<T, VEC>& v) {
  using R = typename Raw<sizeof(T) * VEC>::type;
  R r;
  memcpy(&r, &v, sizeof(R));
  __stcs(reinterpret_cast<R*>(p), r);
}

// An accumulated value in the output type (one rounding).
template <typename T> __device__ __forceinline__ T from_acc(float x);
template <> __device__ __forceinline__ float from_acc<float>(float x) { return x; }
template <> __device__ __forceinline__ double from_acc<double>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_acc<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_acc<__half>(float x) { return __float2half(x); }
template <typename T> __device__ __forceinline__ T from_acc(double x);
template <> __device__ __forceinline__ double from_acc<double>(double x) { return x; }

// Dynamic shared memory of a launch: the staged rows and their extra values.
template <class Op>
inline size_t smem_bytes(const Op& op) {
  return (size_t)op.plan.rows *
         (sizeof(typename Op::Row) + (size_t)op.n_extra * sizeof(typename Op::Tacc));
}

template <int VEC, class Op>
__device__ __forceinline__ void tile_body(const Op& op) {
  using Tio = typename Op::Tio;
  using Tacc = typename Op::Tacc;
  using Row = typename Op::Row;
  extern __shared__ __align__(16) unsigned char smem[];
  const int R = op.plan.rows, V = op.V, K = op.n_extra;
  Row* srow = reinterpret_cast<Row*>(smem);
  Tacc* sext = reinterpret_cast<Tacc*>(srow + R);
  const long long row0 = (long long)blockIdx.x * R;
  const int nrows = (int)min((long long)R, op.rows - row0);
  for (int r = threadIdx.x; r < nrows; r += kThreads)
    srow[r] = op.stage((int)(row0 + r), sext + r * K);
  __syncthreads();
  const int n = nrows * V, nv = n / VEC * VEC;
  const long long base = row0 * V;
  const Tio* x = op.acts + (op.reads ? base : 0);
  Tio* g = op.grads + base;
  Pack<Tio, VEC> in[kVecsPerThread];
#pragma unroll
  for (int i = 0; i < kVecsPerThread; ++i) {  // every load before any use
    const int e = (threadIdx.x + i * kThreads) * VEC;
    // A vector spans two rows at most where V >= VEC; below, it is read
    // whatever its rows' validity.
    if (op.reads && e < nv &&
        (V < VEC || srow[div_v(e, op.plan, V)].valid || srow[div_v(e + VEC - 1, op.plan, V)].valid))
      in[i] = load<Tio, VEC>(x + e);
  }
#pragma unroll
  for (int i = 0; i < kVecsPerThread; ++i) {
    const int e = (threadIdx.x + i * kThreads) * VEC;
    if (e >= nv) break;
    int r = div_v(e, op.plan, V), col = e - r * V;
    Row row = srow[r];
    Pack<Tio, VEC> out;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      out.v[j] = from_acc<Tio>(op.apply(row, col, static_cast<Tacc>(to_acc(in[i].v[j])),
                                        sext + r * K));
      if (++col == V && j + 1 < VEC) {
        col = 0;
        row = srow[++r];
      }
    }
    store<Tio, VEC>(g + e, out);
  }
  const int e = nv + threadIdx.x;  // the scalar tail, fewer than VEC elements
  if (e < n) {
    const int r = div_v(e, op.plan, V);
    const Row& row = srow[r];
    const Tacc xv = op.reads && row.valid ? static_cast<Tacc>(to_acc(x[e])) : Tacc(0);
    g[e] = from_acc<Tio>(op.apply(row, e - r * V, xv, sext + r * K));
  }
}

template <int VEC, class Op>
__device__ __forceinline__ void warp_body(const Op& op) {
  using Tio = typename Op::Tio;
  using Tacc = typename Op::Tacc;
  using Row = typename Op::Row;
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = op.n_extra, V = op.V;
  const int w = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  Row* srow = reinterpret_cast<Row*>(smem);
  Tacc* ext = reinterpret_cast<Tacc*>(srow + kWarpRows) + w * K;
  const long long ri = (long long)blockIdx.x * kWarpRows + w;
  if (ri >= op.rows) return;  // whole warps only: no block barrier follows
  if (lane == 0) srow[w] = op.stage((int)ri, ext);
  __syncwarp();
  const Row row = srow[w];
  const long long base = ri * V;
  const bool reads = op.reads && row.valid;
  const Tio* x = op.acts + (op.reads ? base : 0);
  Tio* g = op.grads + base;
  // Elements before the first one aligned to VEC (the bases are aligned).
  const int head = (int)min((long long)V, (VEC - base % VEC) % VEC);
  if (lane < head)
    g[lane] = from_acc<Tio>(
        op.apply(row, lane, reads ? static_cast<Tacc>(to_acc(x[lane])) : Tacc(0), ext));
  const int nvec = (V - head) / VEC;
  for (int v0 = lane; v0 < nvec; v0 += kUnroll * kWarp) {
    Pack<Tio, VEC> in[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int vi = v0 + k * kWarp;
      if (reads && vi < nvec) in[k] = load<Tio, VEC>(x + head + vi * VEC);
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int vi = v0 + k * kWarp;
      if (vi >= nvec) break;
      const int col = head + vi * VEC;
      Pack<Tio, VEC> out;
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        out.v[j] = from_acc<Tio>(
            op.apply(row, col + j, static_cast<Tacc>(to_acc(in[k].v[j])), ext));
      store<Tio, VEC>(g + col, out);
    }
  }
  for (int c = head + nvec * VEC + lane; c < V; c += kWarp)
    g[c] = from_acc<Tio>(op.apply(row, c, reads ? static_cast<Tacc>(to_acc(x[c])) : Tacc(0), ext));
}

// Launch a pass with the kernel the plan names: tile<VEC> or warp<VEC>,
// VEC the plan's vector width (1, or kVec elements of 16 bytes).
template <class Op, typename Kernel>
int launch(const Op& op, Kernel tile1, Kernel tile_vec, Kernel warp1, Kernel warp_vec,
           cudaStream_t stream) {
  const bool tile = op.plan.mode == kTile;
  const Kernel k = tile ? (op.plan.vec > 1 ? tile_vec : tile1) : (op.plan.vec > 1 ? warp_vec : warp1);
  const long long per_block = tile ? op.plan.rows : kWarpRows;
  const long long blocks = (op.rows + per_block - 1) / per_block;
  const size_t smem = smem_bytes(op);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  k<<<(unsigned)blocks, kThreads, smem, stream>>>(op);
  return (int)cudaGetLastError();
}

// ---- The gradient's row, shared by grad.cu and band_grad.cu ----------------

// A row's scalars: the softmax weight, the blank and label posteriors, the
// denominator (−logsumexp), the label column (−1: none) and validity.
template <typename Tacc>
struct GradRow {
  Tacc coef, cb, ce, den;
  int lab, valid;
};

// One element of a gradient row, in the accumulation type. Dense (log-softmax
// fused): coef·exp(x + den) − cb·[col = blank] − ce·[col = lab]
// − Σ_k extra[k]·[col = cols[k]], every matching subtraction applied, the
// product rounded on its own (mul_rn) as the plain versions round it.
// Sparse: −ce at the label, else −cb at blank, else 0 (the label
// overwrites blank, cpu_rnnt.h:253-267). Invalid rows: 0.
template <typename Tacc>
__device__ __forceinline__ Tacc grad_element(const GradRow<Tacc>& r, int col, Tacc x, int blank,
                                             bool sparse, int K, const ExtraCols& cols,
                                             const Tacc* extra) {
  if (!r.valid) return Tacc(0);
  if (sparse) return col == r.lab ? -r.ce : (col == blank ? -r.cb : Tacc(0));
  Tacc out = mul_rn(r.coef, ex(x + r.den));
  if (col == blank) out -= r.cb;
  if (col == r.lab) out -= r.ce;
  if (K) {
#pragma unroll
    for (int k = 0; k < kMaxExtraCols; ++k)
      if (k < K && col == cols.col[k]) out -= extra[k];
  }
  return out;
}

}  // namespace rows
}  // namespace wtt
