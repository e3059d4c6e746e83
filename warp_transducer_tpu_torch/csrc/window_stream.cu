// Pending-window lattice kernel: the alpha and beta recursions of the
// duration-arc losses (multi-blank, TDT) over the T rows of each
// utterance's (T, U) lattice, t-major.
//
// Replaces: warp_transducer_tpu/ops/pallas/window_stream.py:104
// (_window_kernel, called through _run_window_kernel), which steps
// (B_pad, U_pad) tiles of the whole batch through a (T, C, B_pad, U_pad)
// panel streamed into VMEM in double-buffered chunks, with W rows unrolled
// per iteration so that every ring slot is static. None of that TPU layout
// is carried over: the inputs stay (B, T, U) and (B, T, U, C) as the callers
// have them, and one block walks one utterance's rows.
//
// Mathematics (ops/window.py::forward_backward; the JAX package's
// ops/multiblank.py:123 and ops/tdt.py:128). A channel is one per-cell
// log-weight (0: lpb, 1: lpe, 2 + k: extra[..., k]); an arc's weight is the
// sum of its one to three channels. Blank arcs go (t, u) -> (t+m, u), emit
// arcs (t, u) -> (t+m, u+1), m >= 1; the chain is the within-row arc
// (t, u) -> (t, u+1), solved in prefix form
//   α(t, u) = c(u) + LSE_{j ≤ u}(ne(j) - c(j)),  c(u) = Σ_{k<u} max(w(k), -1e4),
// with ne the arrivals from earlier rows (beta: the mirror, a suffix
// log-sum-exp). Without a chain arc no chain is solved: α row = arrivals.
// A blank arc with t + m == T_b at u = U_b-1 ends the path: it is folded
// into ll_forward (which starts at NEG) and seeds beta. Cells outside
// (t < T_b) & (u < U_b) hold NEG. ll_backward = β(0, 0).
//
// Bound on this card: the chain of T_b dependent rows, not bytes. The kernel
// moves (2 + C)·B·T·U values in and 2·B·T·U out, which the card would
// stream in microseconds; but row t needs the W rows before it, and each
// row is two block-wide scans (a barrier each) and one log-sum-exp per arc,
// so what a row costs is the latency of its dependent steps. What the
// design does about it:
// * alpha and beta run side by side (grid (B, 2));
// * the W pending rows stay in shared memory as a ring (slot = row mod W),
//   so a row reads device memory only for its own channels;
// * those are loaded as one batch of independent loads, one per channel,
//   and, when one thread owns one u (U <= 512), a row ahead: the loads of
//   row t+1 are requested before row t's scans and first touched (clamped,
//   summed into arc weights) at row t+1;
// * a log-sum-exp over many terms is kept as a pair (m, s) standing for
//   m + log(s): a scan step or a further term costs one exp, and one log is
//   taken at the end — in the block scans and in beta's sum over arcs;
// * rows t >= T_b and columns u >= U_b are written NEG without a load.
//
// Layout: grid (B, 2) with blockIdx.y choosing alpha (0) or beta (1), or
// (B, 1) for score-only use. Thread i owns u = i, i + blockDim, ...: every
// ring column is read and written by its own thread, except that an emit
// arc moves one u: in alpha thread u adds it to column u+1 of the ring, in
// a phase of its own between two barriers; in beta thread u reads the ring
// at u+1, and the row's write waits behind a barrier. The alpha slot of row
// t is cleared before the arcs of row t are sent: an arc with m = W lands on
// row t+W, which is the same slot. Shared memory: (W + 1)·U values and 192
// scan totals.
#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 512;
constexpr int kMaxArcs = 9;         // the standard blank and eight big blanks
constexpr int kMaxArcChannels = 3;  // an arc sums at most three channels
constexpr int kMaxChannels = 10;    // lpb, lpe and eight extra channels
// Row-chain sentinel of the prefix sums (ops/band.py::CLAMP).
constexpr double kClamp = -1.0e4;

struct Arc {
  int m;          // rows advanced (unused for the chain)
  unsigned mask;  // bit c set: channel c is part of the weight
};

struct WindowArcs {
  int W;  // the longest duration
  int has_chain;
  int n_blank;
  int n_emit;
  Arc chain;
  Arc blank[kMaxArcs];
  Arc emit[kMaxArcs];
};

// The value m + log(s) of a log-sum-exp in progress; s = 0 is the empty sum.
template <typename T>
struct LogSum {
  T m, s;
  __device__ __forceinline__ T value() const { return m + wtt::lg(s); }
};

template <typename T>
struct SumOp {
  using V = T;
  static constexpr int kTotals = 0;  // where its totals start, in units of T
  static __device__ __forceinline__ V id() { return T(0); }
  static __device__ __forceinline__ V ap(V a, V b) { return a + b; }
};
template <typename T>
struct LseOp {
  using V = LogSum<T>;
  static constexpr int kTotals = 2 * wtt::kWarp;
  static __device__ __forceinline__ V id() { return {T(wtt::kNeg), T(0)}; }
  static __device__ __forceinline__ V ap(V a, V b) {
    const T d = a.m - b.m;
    const T e = wtt::ex(d > T(0) ? -d : d);
    if (d > T(0)) return {a.m, a.s + b.s * e};
    return {b.m, a.s * e + b.s};
  }
};
// One term of a log-sum-exp.
template <typename T>
__device__ __forceinline__ LogSum<T> term(T x) { return {x, T(1)}; }

template <typename T>
__device__ __forceinline__ T shfl(T v, int n, int mode) {
  return mode == 0 ? __shfl_sync(kFull, v, n)
                   : mode > 0 ? __shfl_up_sync(kFull, v, n) : __shfl_down_sync(kFull, v, n);
}
template <typename T>
__device__ __forceinline__ LogSum<T> shfl(LogSum<T> v, int n, int mode) {
  return {shfl(v.m, n, mode), shfl(v.s, n, mode)};
}

// max(x, kClamp) that keeps a NaN, as torch.clamp_min does.
template <typename T>
__device__ __forceinline__ T clamp_chain(T x) {
  return x < T(kClamp) ? T(kClamp) : x;
}

// Inclusive Hillis–Steele scan over the first `width` lanes of a warp, in
// lane order or (kRev) against it. Every lane of the warp calls.
template <typename Op, bool kRev>
__device__ __forceinline__ typename Op::V warp_scan(typename Op::V x, int lane, int width) {
  for (int sh = 1; sh < width; sh <<= 1) {
    const typename Op::V y = shfl(x, sh, kRev ? -1 : 1);
    if (kRev ? lane + sh < width : lane >= sh) x = Op::ap(x, y);
  }
  return x;
}

// Inclusive scan over the block's threads in thread order (kRev: against
// it), continued from `carry` (the scan of the chunks already done), which
// is advanced over this chunk. Warp scans, the warps' totals through shared
// memory, one barrier. `before` receives the scan value just ahead of the
// calling thread's warp. Each Op has two sets of 32 totals in `tot`, and
// `phase` alternates between them from call to call (of any Op), so that
// the barrier of one call separates the reads of the call before from the
// writes of the call after. Every thread of the block calls.
template <typename T, typename Op, bool kRev>
__device__ __forceinline__ typename Op::V block_scan(typename Op::V x, typename Op::V& carry,
                                                     T* tot, int& phase,
                                                     typename Op::V& before) {
  using V = typename Op::V;
  const int lane = threadIdx.x % wtt::kWarp;
  const int warp = threadIdx.x / wtt::kWarp;
  const int nwarps = blockDim.x / wtt::kWarp;
  V* my_tot = reinterpret_cast<V*>(tot + Op::kTotals) + (phase & 1) * wtt::kWarp;
  phase ^= 1;
  x = warp_scan<Op, kRev>(x, lane, wtt::kWarp);
  if (lane == (kRev ? 0 : wtt::kWarp - 1)) my_tot[warp] = x;
  __syncthreads();
  V wt = lane < nwarps ? my_tot[lane] : Op::id();
  wt = warp_scan<Op, kRev>(wt, lane, nwarps);
  const int nbr = kRev ? warp + 1 : warp - 1;  // the warp just ahead in scan order
  const bool has_nbr = nbr >= 0 && nbr < nwarps;
  const V ahead = shfl(wt, has_nbr ? nbr : 0, 0);
  const V total = shfl(wt, kRev ? 0 : nwarps - 1, 0);
  before = has_nbr ? Op::ap(carry, ahead) : carry;
  carry = Op::ap(carry, total);
  return Op::ap(before, x);
}

// Exclusive prefix sum over the block's threads: the inclusive scan shifted
// by one thread, never the inclusive sum minus the element.
template <typename T>
__device__ __forceinline__ T block_excl_sum(T x, T& carry, T* tot, int& phase) {
  T before;
  const T incl = block_scan<T, SumOp<T>, false>(x, carry, tot, phase, before);
  const T prev = __shfl_up_sync(kFull, incl, 1);
  return threadIdx.x % wtt::kWarp == 0 ? before : prev;
}

// The channels of one cell, as loaded (`fetch`) and clamped at NEG
// (`clamped`); an arc's weight is the sum of its channels, in channel order.
template <typename T>
struct Cell {
  T ch[kMaxChannels];

  __device__ __forceinline__ void fetch(const T* __restrict__ lpb, const T* __restrict__ lpe,
                                        const T* __restrict__ extra, int C, long long cell) {
#pragma unroll
    for (int c = 0; c < kMaxChannels; ++c)
      if (c < 2 + C) ch[c] = c == 0 ? lpb[cell] : c == 1 ? lpe[cell] : extra[cell * C + (c - 2)];
  }
  __device__ __forceinline__ Cell clamped() const {
    Cell out;
#pragma unroll
    for (int c = 0; c < kMaxChannels; ++c) out.ch[c] = wtt::clamp_neg(ch[c]);
    return out;
  }
  __device__ __forceinline__ T weight(const Arc& arc) const {
    T w = T(0);
#pragma unroll
    for (int c = 0; c < kMaxChannels; ++c)
      if (arc.mask >> c & 1u) w = w + ch[c];
    return w;
  }
};

__device__ __forceinline__ int ring_slot(int slot, int m, int W) {
  const int s = slot + m;  // m <= W
  return s >= W ? s - W : s;
}

// kOne: blockDim >= U, one thread owns one u, and the next row's channels
// are loaded a row ahead; otherwise a thread walks u = i, i + blockDim, ...
// and loads as it goes.
template <typename T, bool kOne>
__global__ void __launch_bounds__(kMaxThreads)
window_kernel(const T* __restrict__ lpb, const T* __restrict__ lpe, const T* __restrict__ extra,
              int C, const __grid_constant__ WindowArcs arcs,
              const int* __restrict__ input_lengths,
              const int* __restrict__ label_lengths, T* __restrict__ alphas,
              T* __restrict__ betas, T* __restrict__ ll_forward, T* __restrict__ ll_backward,
              int Tmax, int U) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int W = arcs.W;
  T* ring = reinterpret_cast<T*>(smem_raw);  // W rows of U
  T* scratch = ring + (size_t)W * U;         // one row: see its uses below
  T* tot = scratch + U;                      // 64 totals of sums, 64 (m, s) pairs
  const T neg = T(wtt::kNeg);
  const int b = blockIdx.x;
  const int Tb = input_lengths[b];
  const int Ub = label_lengths[b] + 1;
  const int Tv = min(max(Tb, 0), Tmax);  // rows with valid cells
  const int Uv = min(max(Ub, 0), U);     // columns with valid cells
  const long long base = (long long)b * Tmax * U;
  const T* pb = lpb + base;
  const T* pe = lpe + base;
  const T* px = extra + base * C;
  const int nchunks = (U + blockDim.x - 1) / blockDim.x;
  const int step = blockIdx.y == 0 ? 1 : -1;  // the direction the rows are walked in
  int phase = 0;

  for (int u = threadIdx.x; u < W * U; u += blockDim.x) ring[u] = neg;
  __syncthreads();

  // The channels of row t at u, clamped; nothing is loaded outside the valid
  // columns. With kOne the row was requested a row ago (`ahead`) and the
  // next one, in the direction `step`, is requested now.
  Cell<T> ahead = {}, cur = {};
  auto fetch = [&](int t, int u, Cell<T>& cell) {
    if (u < Uv) cell.fetch(pb, pe, px, C, (long long)t * U + u);
  };
  auto load_row = [&](int t, int u) {
    if (kOne) {
      cur = ahead.clamped();
      if (t + step >= 0 && t + step < Tv) fetch(t + step, u, ahead);
    } else {
      fetch(t, u, cur);
      cur = cur.clamped();
    }
  };

  if (blockIdx.y == 0) {
    // ---- alpha, rows ascending; ring[r % W] collects the arrivals of row r ----
    T* out = alphas + base;
    T llf = neg;
    if (kOne && Tv > 0) fetch(0, threadIdx.x, ahead);
    for (int t = 0; t < Tv; ++t) {
      const int slot = t % W;
      T carry_c = T(0);
      LogSum<T> carry_z = LseOp<T>::id();
      T a = neg;
      for (int k = 0; k < nchunks; ++k) {
        const int u = k * blockDim.x + threadIdx.x;
        const bool inside = u < U, act = u < Uv;
        load_row(t, u);
        a = inside ? ring[slot * U + u] : neg;
        if (t == 0 && u == 0) a = T(0);
        if (arcs.has_chain) {
          const T c = block_excl_sum<T>(act ? clamp_chain(cur.weight(arcs.chain)) : T(0),
                                        carry_c, tot, phase);
          LogSum<T> before;
          const LogSum<T> z = block_scan<T, LseOp<T>, false>(
              inside ? term(a - c) : LseOp<T>::id(), carry_z, tot, phase, before);
          if (inside) a = c + z.value();
        }
        if (!act) a = neg;
        if (inside) {
          out[(long long)t * U + u] = a;
          ring[slot * U + u] = neg;  // before the arcs: one with m = W lands on this slot
          if (!kOne && arcs.n_emit > 0) scratch[u] = a;  // for the emit arcs below
        }
        if (act) {
          for (int i = 0; i < arcs.n_blank; ++i) {
            const int m = arcs.blank[i].m;
            const T dep = a + cur.weight(arcs.blank[i]);
            T* cell = ring + ring_slot(slot, m, W) * U + u;
            *cell = wtt::lse(*cell, dep);
            // the arc that lands exactly on T_b from the last label ends the path
            if (t + m == Tb && u == Ub - 1) llf = wtt::lse(llf, dep);
          }
        }
      }
      if (arcs.n_emit > 0) {
        // An emit arc lands one column over, which another thread owns: a
        // phase of its own, after every column's slot of this row was read
        // and cleared and its blank arcs were sent, and before the next row.
        __syncthreads();
        for (int k = 0; k < nchunks; ++k) {
          const int u = k * blockDim.x + threadIdx.x;
          if (!kOne) {  // with kOne, `a` and `cur` are still this row's
            fetch(t, u, cur);
            cur = cur.clamped();
            a = u < U ? scratch[u] : neg;
          }
          if (u < Uv && u + 1 < U) {
            for (int i = 0; i < arcs.n_emit; ++i) {
              T* cell = ring + ring_slot(slot, arcs.emit[i].m, W) * U + u + 1;
              *cell = wtt::lse(*cell, a + cur.weight(arcs.emit[i]));
            }
          }
        }
        __syncthreads();
      }
    }
    for (long long i = (long long)Tv * U + threadIdx.x; i < (long long)Tmax * U; i += blockDim.x)
      out[i] = neg;
    // The thread that owns u = U_b - 1 holds the terminal arcs' sum.
    if (Ub >= 1 && Ub <= U) {
      if ((int)threadIdx.x == (Ub - 1) % (int)blockDim.x) ll_forward[b] = llf;
    } else if (threadIdx.x == 0) {
      ll_forward[b] = neg;
    }
  } else {
    // ---- beta, rows descending; ring[r % W] holds beta row r ----
    T* out = betas + base;
    for (long long i = (long long)Tv * U + threadIdx.x; i < (long long)Tmax * U; i += blockDim.x)
      out[i] = neg;
    if (Tv == 0 && threadIdx.x == 0) ll_backward[b] = neg;
    if (kOne && Tv > 0) fetch(Tv - 1, threadIdx.x, ahead);
    for (int r = Tv - 1; r >= 0; --r) {
      const int slot = r % W;
      if (arcs.has_chain && !kOne) {  // the exclusive prefix, ascending chunks
        T carry_c = T(0);
        for (int k = 0; k < nchunks; ++k) {
          const int u = k * blockDim.x + threadIdx.x;
          load_row(r, u);
          const T c = block_excl_sum<T>(u < Uv ? clamp_chain(cur.weight(arcs.chain)) : T(0),
                                        carry_c, tot, phase);
          if (u < U) scratch[u] = c;
        }
      }
      LogSum<T> carry_p = LseOp<T>::id();
      for (int k = nchunks - 1; k >= 0; --k) {  // the arcs and the suffix chain, descending
        const int u = k * blockDim.x + threadIdx.x;
        const bool inside = u < U, act = u < Uv;
        load_row(r, u);
        // The row's arrivals as one log-sum-exp over the arcs (and NEG, where
        // the plain sum starts): the largest term first, then the sum of
        // exps below it. A blank arc that lands exactly on T_b from the last
        // label ends the path and adds its bare weight.
        const bool last = u == Ub - 1;
        const bool has_next = u + 1 < U;
        T top = neg;
        if (act) {
          for (int i = 0; i < arcs.n_blank; ++i) {
            const int m = arcs.blank[i].m;
            const T w = cur.weight(arcs.blank[i]);
            top = fmax(top, w + ring[ring_slot(slot, m, W) * U + u]);
            top = fmax(top, (last && r + m == Tb) ? w : neg);
          }
          for (int i = 0; i < arcs.n_emit; ++i) {
            const T next = has_next ? ring[ring_slot(slot, arcs.emit[i].m, W) * U + u + 1] : neg;
            top = fmax(top, cur.weight(arcs.emit[i]) + next);
          }
        }
        LogSum<T> v = {top, wtt::ex(neg - top)};
        if (act) {
          for (int i = 0; i < arcs.n_blank; ++i) {
            const int m = arcs.blank[i].m;
            const T w = cur.weight(arcs.blank[i]);
            v.s += wtt::ex(w + ring[ring_slot(slot, m, W) * U + u] - top);
            v.s += wtt::ex(((last && r + m == Tb) ? w : neg) - top);
          }
          for (int i = 0; i < arcs.n_emit; ++i) {
            const T next = has_next ? ring[ring_slot(slot, arcs.emit[i].m, W) * U + u + 1] : neg;
            v.s += wtt::ex(cur.weight(arcs.emit[i]) + next - top);
          }
        }
        T bv;
        if (arcs.has_chain) {
          T c;
          if (kOne) {
            T carry_c = T(0);
            c = block_excl_sum<T>(act ? clamp_chain(cur.weight(arcs.chain)) : T(0), carry_c, tot,
                                  phase);
          } else {
            c = inside ? scratch[u] : T(0);
          }
          v.m += c;
          LogSum<T> before;
          const LogSum<T> p = block_scan<T, LseOp<T>, true>(inside ? v : LseOp<T>::id(), carry_p,
                                                            tot, phase, before);
          bv = inside ? p.value() - c : neg;
        } else {
          bv = v.value();
        }
        if (!act) bv = neg;
        if (inside) {
          out[(long long)r * U + u] = bv;
          scratch[u] = bv;
        }
        if (r == 0 && u == 0) ll_backward[b] = bv;
      }
      // Row r takes the slot of row r+W, which the emit arcs of this row read
      // at u+1: every read comes before the write, every write before the
      // next row's reads.
      if (arcs.n_emit > 0) __syncthreads();
      for (int u = threadIdx.x; u < U; u += blockDim.x) ring[slot * U + u] = scratch[u];
      if (arcs.n_emit > 0) __syncthreads();
    }
  }
}

template <typename T>
int launch(const void* lpb, const void* lpe, const void* extra, int C, const WindowArcs& arcs,
           const int* input_lengths, const int* label_lengths, void* alphas, void* betas,
           void* ll_forward, void* ll_backward, int B, int Tmax, int U, int compute_betas,
           cudaStream_t stream) {
  const size_t smem = ((size_t)(arcs.W + 1) * U + 6 * wtt::kWarp) * sizeof(T);
  const bool one = U <= kMaxThreads;
  auto kernel = one ? window_kernel<T, true> : window_kernel<T, false>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = one ? ((U + wtt::kWarp - 1) / wtt::kWarp) * wtt::kWarp : kMaxThreads;
  dim3 grid(B, compute_betas ? 2 : 1);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(lpb), static_cast<const T*>(lpe), static_cast<const T*>(extra), C,
      arcs, input_lengths, label_lengths, static_cast<T*>(alphas), static_cast<T*>(betas),
      static_cast<T*>(ll_forward), static_cast<T*>(ll_backward), Tmax, U);
  return (int)cudaGetLastError();
}

// One arc from five host ints (m, n, ch0, ch1, ch2); false unless it sums
// 1..3 distinct channels that lie inside [0, 2 + C) and (when `moves`)
// advances at least one row.
bool read_arc(const int* row, int C, bool moves, Arc* out) {
  out->m = row[0];
  out->mask = 0;
  const int n = row[1];
  if (n < 1 || n > kMaxArcChannels || (moves && out->m < 1)) return false;
  for (int i = 0; i < n; ++i) {
    const int c = row[2 + i];
    if (c < 0 || c >= 2 + C || (out->mask >> c & 1u)) return false;
    out->mask |= 1u << c;
  }
  return true;
}

}  // namespace

extern "C" {

// lpb, lpe: (B,T,U) f32 or f64 (`dtype`); extra: (B,T,U,C) of the same type,
// C <= 8 (unused and may be null when C == 0); lengths: (B,) int32; alphas,
// betas: (B,T,U) (betas and ll_backward unused and may be null when
// compute_betas == 0); ll_forward, ll_backward: (B,). arc_table: a host
// array of 1 + n_blank + n_emit rows of five ints (m, n, ch0, ch1, ch2): the
// chain first (n == 0: the lattice has none), then the blank arcs, then the
// emit arcs. Returns the launch's cudaError_t.
int wtt_window_stream(const void* lpb, const void* lpe, const void* extra, int dtype, int C,
                      const int* arc_table, int n_blank, int n_emit, const int* input_lengths,
                      const int* label_lengths, void* alphas, void* betas, void* ll_forward,
                      void* ll_backward, int B, int T, int U, int compute_betas, void* stream) {
  if (B == 0) return 0;
  if (T < 1 || U < 1 || C < 0 || C > kMaxChannels - 2 || arc_table == nullptr || n_blank < 1 ||
      n_blank > kMaxArcs || n_emit < 0 || n_emit > kMaxArcs)
    return (int)cudaErrorInvalidValue;
  WindowArcs arcs = {};
  arcs.has_chain = arc_table[1] != 0;
  if (arcs.has_chain && !read_arc(arc_table, C, false, &arcs.chain))
    return (int)cudaErrorInvalidValue;
  arcs.n_blank = n_blank;
  arcs.n_emit = n_emit;
  for (int i = 0; i < n_blank + n_emit; ++i) {
    Arc* arc = i < n_blank ? &arcs.blank[i] : &arcs.emit[i - n_blank];
    if (!read_arc(arc_table + 5 * (1 + i), C, true, arc)) return (int)cudaErrorInvalidValue;
    arcs.W = arc->m > arcs.W ? arc->m : arcs.W;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case wtt::kF32:
      return launch<float>(lpb, lpe, extra, C, arcs, input_lengths, label_lengths, alphas, betas,
                           ll_forward, ll_backward, B, T, U, compute_betas, s);
    case wtt::kF64:
      return launch<double>(lpb, lpe, extra, C, arcs, input_lengths, label_lengths, alphas,
                            betas, ll_forward, ll_backward, B, T, U, compute_betas, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
