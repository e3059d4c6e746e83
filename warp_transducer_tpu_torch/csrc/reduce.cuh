// Tiled row reductions: the loops of the kernels that reduce each row of a
// (rows, V) tensor to its −logsumexp and then emit a few values of the row
// (prep.cu, band_prep.cu).
//
// Two modes, chosen per call by `plan` below, the mirror of
// ops/cuda/rows.py::reduce_plan (tests/test_torch_rows.py checks the Python
// planner's index loops; a card test checks that the two planners agree):
//
// * Tile (small V). A block of kThreads threads owns `rows` consecutive
//   rows, rows·V contiguous elements (at most kThreads·kVecsPerThread
//   vectors, 16 KB, as rows.cuh plans the gradient's tiles). Every thread
//   issues its kVecsPerThread 16-byte loads (or one-element loads where the
//   base is off the 16-byte grid) before it uses any, across row
//   boundaries, then scatters the elements, in the accumulation type, into
//   shared memory at row stride `stride`. A group of `group` threads (a
//   power of two up to a warp, each thread left kGroupBytes of the row at
//   least) then reduces each row from shared memory: the row's max, then
//   the sum of exp(x − max), each combined over the group by shuffles. The
//   tile is in shared memory,
//   so the second read costs no device bytes; the two passes keep the
//   per-element branch and rescaling of an online pair out of the loop and
//   round as the plain two-pass version does. `stride` is the least
//   multiple of `group` at or above V whose quotient by `group` is odd
//   (any, for a group of a warp): the rows that one warp reduces at once
//   then start `group` banks apart, so their reads are free of bank
//   conflicts in 4-byte and in 8-byte words. Last, a thread a row (so
//   coalesced across the tile) calls the op's `emit` with the row's value
//   and a reader of its elements in shared memory. That thread stages the
//   row's own scalars (`stage`, the prep's label) right after the tile's
//   loads are issued, so that their latency overlaps.
// * Warp (large V). A warp per row, kWarpRows rows a block; the lanes
//   stride over the row by vectors after a scalar head up to the first
//   aligned element, kUnroll vectors a lane in flight, each lane keeping an
//   online (max, sum-exp) pair updated once a vector; the warp combines the
//   pairs by shuffles and lane 0, which staged the row's scalars before the
//   loads, calls `emit` with a reader of the row in device memory.
//
// Without `reduce` (log-prob inputs) neither mode reduces: a thread (tile)
// or lane 0 (warp) calls `emit` with the value 0 and a reader of the row in
// device memory, so only the columns it emits are read.
//
// An Op supplies: Tin, Tacc, Stage; `acts`, `rows` (long long, below 2^31),
// `V`, `reduce`, `plan`; `Stage stage(int row)`, the row's scalars; and
// `template <class Read> void emit(int row, Tacc d, const Read& x, const
// Stage&)`, where x(col) is the row's element col in Tacc.
#pragma once

#include "rows.cuh"

namespace wtt {
namespace reduce {

using rows::kThreads;
using rows::kUnroll;
using rows::kVecsPerThread;
using rows::kWarpRows;
using rows::Pack;

constexpr int kTile = 0, kWarpMode = 1;
constexpr int kMaxTileRows = rows::kMaxTileRows;
// The switch point: rows of at most this many elements go by tiles
// (scripts/tune_prep.py chose it on an H100).
constexpr int kTileMaxV = 256;
// A thread of a tile's group reduces at least this many bytes of its row.
constexpr int kGroupBytes = 64;
static_assert(kMaxTileRows % kThreads == 0, "a tile's rows are staged in whole rounds");

// The plan, as wtt_reduce_plan returns it (seven unsigned): mode, rows (a
// tile's, or kWarpRows), vec (1 or 16 bytes of elements), the
// multiply-high magic of division by V (mul, shr), the threads a row
// (group) and the shared-memory row stride in elements (stride).
struct Plan {
  int mode, rows, vec;
  unsigned mul;
  int shr, group, stride;
};

// (mul, shr) of the round-up method: n / d == (n · mul >> 32) >> shr for
// 0 <= n < 2^31 and 2 <= d < 2^31; (0, 0) for d = 1 (div_by returns n).
inline void division_magic(unsigned d, unsigned* mul, int* shr) {
  if (d <= 1) {
    *mul = 0;
    *shr = 0;
    return;
  }
  int log2 = 0;  // ceil(log2 d)
  while ((1ull << log2) < d) ++log2;
  const int p = 31 + log2;
  *mul = (unsigned)(((1ull << p) + d - 1) / d);
  *shr = p - 32;
}

__device__ __forceinline__ int div_by(int n, unsigned mul, int shr, int d) {
  return d == 1 ? n : (int)(__umulhi((unsigned)n, mul) >> shr);
}

inline int gcd(int a, int b) {
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// The plan for rows of V elements of `elt` bytes (2, 4 or 8), `align` the
// largest power of two (at most 16) dividing the base address in bytes.
inline Plan plan(int V, int elt, int align) {
  Plan p{kWarpMode, kWarpRows, align % 16 == 0 ? 16 / elt : 1, 0u, 0, kWarp, V};
  division_magic((unsigned)V, &p.mul, &p.shr);
  if (V > kTileMaxV) return p;
  int r = kThreads * kVecsPerThread * p.vec / V;
  if (r > kMaxTileRows) r = kMaxTileRows;
  r -= r % (p.vec / gcd(V, p.vec));  // rows·V % vec == 0: every tile starts aligned
  if (r < 1) return p;
  int g = 1;
  while (g < kWarp && 2 * g * kGroupBytes <= V * elt) g *= 2;
  int m = (V + g - 1) / g;
  if (g < kWarp && m % 2 == 0) ++m;
  return Plan{kTile, r, p.vec, p.mul, p.shr, g, m * g};
}

// Element bytes of a type code of common.cuh, 0 for an unknown code.
inline int elt_size(int dtype) {
  switch (dtype) {
    case kF32: return 4;
    case kF64: return 8;
    case kBF16:
    case kF16: return 2;
    default: return 0;
  }
}

// The largest power of two, at most 16, that divides the address: the
// `align` of plan().
inline int alignment(const void* p) {
  int a = 16;
  while ((reinterpret_cast<unsigned long long>(p) % a) != 0) a /= 2;
  return a;
}

// True when `p` fits the bodies' limits for rows of V elements of `elt`
// bytes: the planner's invariants, checked for plans that come from outside.
inline bool plan_ok(const Plan& p, int V, int elt) {
  if (V < 1 || (p.vec != 1 && p.vec * elt != 16)) return false;
  if (p.mode == kWarpMode) return p.rows == kWarpRows;
  const bool pow2 = p.group >= 1 && p.group <= kWarp && (p.group & (p.group - 1)) == 0;
  return p.mode == kTile && p.rows >= 1 && p.rows <= kMaxTileRows &&
         (long long)p.rows * V % p.vec == 0 &&
         (long long)p.rows * V <= (long long)kThreads * kVecsPerThread * p.vec && pow2 &&
         p.stride >= V && p.stride % p.group == 0 &&
         (p.group == kWarp || (p.stride / p.group) % 2 == 1);
}

// Dynamic shared memory of a tile launch: the rows at their stride, then a
// value a row.
inline size_t smem_bytes(const Plan& p, size_t acc) {
  return p.mode == kTile ? (size_t)p.rows * (p.stride + 1) * acc : 0;
}

// A row's elements in shared memory (already in Tacc) or in device memory.
template <typename Tacc>
struct SharedRow {
  const Tacc* p;
  __device__ __forceinline__ Tacc operator()(int c) const { return p[c]; }
};
template <typename Tin, typename Tacc>
struct DeviceRow {
  const Tin* p;
  __device__ __forceinline__ Tacc operator()(int c) const {
    return static_cast<Tacc>(to_acc(p[c]));
  }
};

// Combine over aligned groups of g lanes (g a power of two up to a warp);
// every lane of the warp must take part.
template <typename T>
__device__ __forceinline__ T group_max(T x, int g) {
  for (int o = g / 2; o > 0; o >>= 1) {
    const T y = __shfl_xor_sync(0xffffffffu, x, o);
    x = y > x ? y : x;
  }
  return x;
}
template <typename T>
__device__ __forceinline__ T group_sum(T x, int g) {
  for (int o = g / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int VEC, class Op>
__device__ __forceinline__ void tile_body(const Op& op) {
  using Tin = typename Op::Tin;
  using Tacc = typename Op::Tacc;
  extern __shared__ __align__(16) unsigned char smem[];
  const Plan& p = op.plan;
  const int R = p.rows, V = op.V, S = p.stride;
  Tacc* sx = reinterpret_cast<Tacc*>(smem);
  Tacc* sd = sx + R * S;
  const long long row0 = (long long)blockIdx.x * R;
  const int nrows = (int)min((long long)R, op.rows - row0);
  const Tin* x = op.acts + row0 * V;
  constexpr int kRowsPerThread = kMaxTileRows / kThreads;
  typename Op::Stage st[kRowsPerThread];
  if (!op.reduce) {
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = threadIdx.x + i * kThreads;
      if (r < nrows) st[i] = op.stage((int)row0 + r);
    }
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = threadIdx.x + i * kThreads;
      if (r < nrows)
        op.emit((int)row0 + r, Tacc(0), DeviceRow<Tin, Tacc>{x + (long long)r * V}, st[i]);
    }
    return;
  }
  const int n = nrows * V, nv = n / VEC * VEC;
  Pack<Tin, VEC> in[kVecsPerThread];
#pragma unroll
  for (int i = 0; i < kVecsPerThread; ++i) {  // every load before any use
    const int e = (threadIdx.x + i * kThreads) * VEC;
    if (e < nv) in[i] = rows::load<Tin, VEC>(x + e);
  }
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {  // the rows' scalars, while the loads fly
    const int r = threadIdx.x + i * kThreads;
    if (r < nrows) st[i] = op.stage((int)row0 + r);
  }
#pragma unroll
  for (int i = 0; i < kVecsPerThread; ++i) {
    const int e = (threadIdx.x + i * kThreads) * VEC;
    if (e >= nv) break;
    int r = div_by(e, p.mul, p.shr, V), col = e - r * V;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      sx[r * S + col] = static_cast<Tacc>(to_acc(in[i].v[j]));
      if (++col == V) {
        col = 0;
        ++r;
      }
    }
  }
  {
    const int e = nv + threadIdx.x;  // the scalar tail, fewer than VEC elements
    if (e < n) {
      const int r = div_by(e, p.mul, p.shr, V);
      sx[r * S + e - r * V] = static_cast<Tacc>(to_acc(x[e]));
    }
  }
  __syncthreads();
  // A group a row; every thread runs every round, so the shuffles see the
  // whole warp.
  const int G = p.group, q = threadIdx.x / G, g = threadIdx.x % G, groups = kThreads / G;
  for (int base = 0; base < nrows; base += groups) {
    const int r = base + q;
    const Tacc* xr = sx + (r < nrows ? r : 0) * S;
    Tacc m = lowest<Tacc>();
    for (int c = g; c < V; c += G) m = xr[c] > m ? xr[c] : m;
    m = group_max(m, G);
    Tacc s = Tacc(0);
    for (int c = g; c < V; c += G) s += ex(xr[c] - m);
    s = group_sum(s, G);
    if (r < nrows && g == 0) sd[r] = -(m + lg(s));
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = threadIdx.x + i * kThreads;
    if (r < nrows) op.emit((int)row0 + r, sd[r], SharedRow<Tacc>{sx + r * S}, st[i]);
  }
}

// One element into a lane's online (max, sum-exp) pair.
template <typename Tacc>
__device__ __forceinline__ void online(Tacc& m, Tacc& s, Tacc x) {
  if (x > m) {
    s = s * ex(m - x) + Tacc(1);
    m = x;
  } else {
    s += ex(x - m);
  }
}

template <int VEC, class Op>
__device__ __forceinline__ void warp_body(const Op& op) {
  using Tin = typename Op::Tin;
  using Tacc = typename Op::Tacc;
  const int V = op.V, lane = threadIdx.x % kWarp;
  const long long ri = (long long)blockIdx.x * kWarpRows + threadIdx.x / kWarp;
  if (ri >= op.rows) return;  // whole warps only
  const long long base = ri * V;
  const Tin* x = op.acts + base;
  typename Op::Stage st{};
  if (lane == 0) st = op.stage((int)ri);
  Tacc d = Tacc(0);
  if (op.reduce) {
    Tacc m = lowest<Tacc>(), s = Tacc(0);
    // Elements before the first one aligned to VEC (the base is aligned).
    const int head = (int)min((long long)V, (VEC - base % VEC) % VEC);
    if (lane < head) online(m, s, static_cast<Tacc>(to_acc(x[lane])));
    const int nvec = (V - head) / VEC;
    const Tin* xv = x + head;
    for (int v0 = lane; v0 < nvec; v0 += kUnroll * kWarp) {
      Pack<Tin, VEC> in[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int vi = v0 + k * kWarp;
        if (vi < nvec) in[k] = rows::load<Tin, VEC>(xv + vi * VEC);
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        if (v0 + k * kWarp >= nvec) break;
        Tacc pm = lowest<Tacc>();  // the vector's max, then one rescale
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const Tacc v = static_cast<Tacc>(to_acc(in[k].v[j]));
          pm = v > pm ? v : pm;
        }
        if (pm > m) {
          s *= ex(m - pm);
          m = pm;
        }
#pragma unroll
        for (int j = 0; j < VEC; ++j) s += ex(static_cast<Tacc>(to_acc(in[k].v[j])) - m);
      }
    }
    for (int c = head + nvec * VEC + lane; c < V; c += kWarp)
      online(m, s, static_cast<Tacc>(to_acc(x[c])));
    const Tacc row_max = warp_max(m);
    d = -(row_max + lg(warp_sum(s * ex(m - row_max))));
  }
  if (lane == 0) op.emit((int)ri, d, DeviceRow<Tin, Tacc>{x}, st);
}

// Launch with the kernel the plan names: tile<VEC> or warp<VEC>, VEC the
// plan's vector width (1, or 16 bytes of elements).
template <class Op, typename Kernel>
int launch(const Op& op, Kernel tile1, Kernel tile_vec, Kernel warp1, Kernel warp_vec,
           cudaStream_t stream) {
  const bool tile = op.plan.mode == kTile;
  const Kernel k = tile ? (op.plan.vec > 1 ? tile_vec : tile1)
                        : (op.plan.vec > 1 ? warp_vec : warp1);
  const long long per_block = tile ? op.plan.rows : kWarpRows;
  const long long blocks = (op.rows + per_block - 1) / per_block;
  const size_t smem = op.reduce ? smem_bytes(op.plan, sizeof(typename Op::Tacc)) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  k<<<(unsigned)blocks, kThreads, smem, stream>>>(op);
  return (int)cudaGetLastError();
}

}  // namespace reduce
}  // namespace wtt
