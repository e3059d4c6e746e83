// Lattice kernel: the RNN-T alpha and beta recursions over the T+U-1
// anti-diagonals of each utterance's (T, U) lattice.
//
// Replaces: warp_transducer_tpu/ops/pallas/wavefront_stream.py:49
// (_stream_kernel, the TPU path) and warp_transducer_tpu/ops/pallas/
// wavefront.py:72 (_kernel, the batch-tiled variant). Both step one whole
// diagonal of a skewed (N, B, U) panel per iteration; here the warps of a
// block walk the diagonals of one utterance in place.
//
// Bound on this card: neither bytes nor operations but the dependency
// chain. The kernel moves 4·B·T·U values (lpb, lpe in; alphas, betas out)
// and does about ten operations per cell, which the card would finish in
// microseconds; but diagonal n needs diagonal n-1, so each lattice runs
// N_b = T_b+U_b-1 steps in sequence, and the floor is that count times the
// latency of one step. Two things made a step slow in the earlier design (a
// thread a cell, a block a lattice, ~1 µs a diagonal): a barrier across the
// whole diagonal, and memory access along it. A diagonal's cells lie in as
// many rows as it has cells, so a warp that reads or writes a diagonal of
// the (B, T, U) arrays touches 32 cache lines an instruction, and with two
// loads and a store a cell that took most of a step.
//
// The design: a lattice's columns are cut into bands of 32, a warp a band
// (lane l holds u = c0 + l, c0 = 32·band), and the warps of a lattice step
// through the diagonals together.
// * Rows in, rows out. A band needs row t of lpb and lpe from diagonal
//   t + c0 (its lane 0) to t + c0 + 31 (lane 31). So the warp copies each
//   row's 32 values of its band into a ring of kRing rows in shared memory
//   with one coalesced cp.async a field, kAhead diagonals before lane 0
//   needs it; a lane only ever reads the words it copied itself, so a wait
//   on its own copies (cp.async.wait_group) is the only synchronisation.
//   A lane then parks each result over the lpb word it has just used, and
//   once the band's row is complete (lane 31's cell, or lane 0's for beta)
//   every lane writes its word of that row: a coalesced store.
// * One shuffle and one barrier a diagonal. The neighbour within the band
//   comes by __shfl_up_sync (alpha) / __shfl_down_sync (beta); lane 0 (31)
//   takes the neighbouring band's edge from a double-buffered word in shared
//   memory, behind a named barrier (bar.sync id, 32·bands) among that
//   lattice's warps only. A lattice of one band needs no barrier.
// * Only the recursion on a step's critical path: its inputs are read at
//   the end of the step before, the row it writes out was complete a step
//   earlier, its copies are issued while the log-sum-exp is in flight, and
//   nothing in the loop branches. f32 takes exp and log1p(x) = log(1 + x)
//   of the log-sum-exp on the SFU (ex2.approx, lg2.approx): about 1e-7
//   absolute a step, below the rounding of |alpha| >= 1; f64 keeps wtt::lse.
// * Each lattice stops at its own N_b, and bands beyond U_b do not walk.
//   The cells outside (t < T_b) & (u < U_b) get NEG afterwards, row by row
//   (coalesced), which only bands with such cells do.
// * Several lattices a block where the batch is large and U small (up to
//   four; alpha and beta of one utterance side by side), so that they spread
//   over the SMs.
// What bounds it now is the step's latency: a shuffle, the log-sum-exp's
// chain of about ten dependent instructions with two SFU round trips, and
// for several bands the barrier and the edge word; the warp issues about 90
// instructions a step (scripts/sass_count.sh wavefront).
//
// The rings take 2·kRing·32 values a band: 10 KB in f32, 20 KB in f64. Above
// 16 bands (f32, U > 512) or 11 (f64, U > 352) they no longer fit a block,
// and the block kernel below (the earlier design: a block per lattice, a
// thread per cell, the previous diagonal in shared memory and one
// __syncthreads a diagonal) takes over. The band kernel indexes a lattice
// with 32-bit offsets; for T·U near 2^31 the block kernel takes over too.
//
// The plan (bands, lattices a block, the switch) is `plan` below, mirrored
// by ops/cuda/wavefront.py::plan; wtt_wavefront_plan lets a card test hold
// the two equal, and tests/test_torch_wavefront_plan.py replays the band
// kernel's schedule in numpy on the CPU.
//
// Semantics (as ops/lattice.py and the Pallas kernels): inputs clamped to
// >= NEG; valid cells (t < T_b) & (u < U_b); alpha(0,0) = 0;
// ll_forward = alpha + lpb at (T_b-1, U_b-1); beta seeded there by a masked
// overwrite; ll_backward = beta(0,0). Every cell of alphas/betas is
// written, invalid ones with NEG. No atomics: two calls give the same bits.
#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxLatticesPerBlock = 4;
constexpr int kMaxBands = 16;
constexpr int kMaxWarps = 16;  // a block: up to 128 registers a thread
// Rows of lpb/lpe copied ahead of lane 0's need; the input ring holds a
// band's rows from that copy to lane 31's last use: 32 + kAhead rows.
constexpr int kAhead = 8;
constexpr int kRing = 32 + kAhead;
constexpr int kSmemMax = 232448;  // a block's shared memory on sm_90
// The band kernel indexes a lattice with 32-bit offsets, up to (T + U + 2·kRing)·U.
constexpr long long kMaxOffset = 0x7fffffffLL;

// Shared memory of one band (warp): the rings of lpb and lpe.
constexpr int band_bytes(int elt) { return 2 * kRing * wtt::kWarp * elt; }
// The edge words the bands trade, static: [lattice][parity][band], in the
// largest type.
constexpr int kEdgeBytes = kMaxLatticesPerBlock * 2 * kMaxBands * 8;
constexpr int max_bands(int elt) {
  const int n = (kSmemMax - kEdgeBytes) / band_bytes(elt);
  return n < kMaxBands ? n : kMaxBands;
}

struct Plan {
  int band_mode;  // 1: the band kernel; 0: the block kernel
  int bands;      // warps a lattice (band mode)
  int per_block;  // lattices a block
  int blocks;
  int threads;
  int smem;       // dynamic shared memory a block
};

Plan plan(int B, int T, int U, int elt, int dirs, int n_sm) {
  Plan p{};
  const int lattices = B * dirs;
  const int bands = (U + wtt::kWarp - 1) / wtt::kWarp;
  const bool small = (long long)(T + U + 2 * kRing) * U <= kMaxOffset;
  if (small && bands >= 1 && bands <= max_bands(elt)) {
    int cap = kMaxLatticesPerBlock;
    cap = cap < kMaxWarps / bands ? cap : kMaxWarps / bands;
    cap = cap < max_bands(elt) / bands ? cap : max_bands(elt) / bands;
    const int spread = (lattices + n_sm - 1) / n_sm;
    p.band_mode = 1;
    p.bands = bands;
    p.per_block = spread < 1 ? 1 : (spread > cap ? cap : spread);
    p.blocks = (lattices + p.per_block - 1) / p.per_block;
    p.threads = wtt::kWarp * bands * p.per_block;
    p.smem = band_bytes(elt) * bands * p.per_block;
  } else {
    p.per_block = 1;
    p.blocks = lattices;
    p.threads = U < 1024 ? ((U + wtt::kWarp - 1) / wtt::kWarp) * wtt::kWarp : 1024;
    p.smem = 2 * U * elt;
  }
  return p;
}

// One lattice's extent inside the (T, U) arrays.
struct Extent {
  int Tv, Uv;     // T_b and U_b, clamped to the arrays
  int steps;      // N_b = Tv + Uv - 1 diagonals, 0 without a frame
  bool terminal;  // (T_b - 1, U_b - 1) lies inside the arrays
};

__device__ __forceinline__ Extent extent(int Tb, int Ub, int Tmax, int U) {
  Extent e;
  e.Tv = min(max(Tb, 0), Tmax);
  e.Uv = min(max(Ub, 0), U);
  e.steps = e.Tv > 0 && e.Uv > 0 ? e.Tv + e.Uv - 1 : 0;
  e.terminal = Tb >= 1 && Tb <= Tmax && Ub >= 1 && Ub <= U;
  return e;
}

// The log-sum-exp of a step: f64 wtt::lse; f32 the same formula with exp2
// and log2 on the SFU (ex2.approx.ftz, lg2.approx.ftz), branch-free.
__device__ __forceinline__ double step_lse(double a, double b) { return wtt::lse(a, b); }
__device__ __forceinline__ float step_lse(float a, float b) {
  float e, l;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(fabsf(a - b) * -1.4426950408889634f));
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(l) : "f"(1.0f + e));
  return fmaf(l, 0.6931471805599453f, fmaxf(a, b));
}

// Copy one value from device memory into shared memory (at the shared
// address dst), asynchronously.
template <typename T>
__device__ __forceinline__ void copy_async(unsigned dst, const T* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst), "l"(src),
               "n"((int)sizeof(T)));
}
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// Whether row r lies in [0, n).
__device__ __forceinline__ bool in_rows(int r, int n) { return (unsigned)r < (unsigned)n; }
__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// After a step's commit: wait until the copies of kAhead - 1 steps back,
// which the next step reads, have landed.
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kAhead - 1) : "memory");
}
__device__ __forceinline__ void copy_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void band_barrier(int id, int bands) {
  if (bands > 1) asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(bands * wtt::kWarp) : "memory");
}

__device__ __forceinline__ int wrap(int x, int n) {  // x mod n for x > -n
  return x < 0 ? x + n : x;
}

// What a band (warp) of a lattice works with.
template <typename T>
struct Band {
  const T* pb;  // the lattice's lpb, lpe, (T, U)
  const T* pe;
  T* out;       // its alphas or betas
  T* ring_b;    // [kRing][32] rows of lpb, each word then its cell's result
  T* ring_e;    // [kRing][32] rows of lpe
  T* edge;      // [2][kMaxBands] the lattice's edge words
  Extent e;
  int Tmax, U, band, bands, barrier, lane, u;
};

// Alpha over diagonals 1 .. N_b-1 from alpha(0, 0); ll_forward at the
// terminal cell. Lane l at diagonal n holds cell (t, u) = (n - c0 - l, c0 + l)
// and reads lpb(t-1, u), lpe(t, u-1): slot r of the input ring holds lpe of
// row r at column u-1 and lpb of row r-1 at column u, copied at step
// r + c0 - kAhead; row r of the results is complete at step r + c0 + 31 and
// written out at step r + c0 + 32.
template <typename T>
__device__ void alpha_walk(const Band<T>& s, T* __restrict__ llf) {
  const T neg = T(wtt::kNeg);
  const Extent& e = s.e;
  const int c0 = s.band * wtt::kWarp, lane = s.lane, u = s.u, U = s.U;
  const bool pe_col = u >= 1 && u - 1 < e.Uv, in_col = u < e.Uv;
  const bool left_band = lane == 0 && s.band > 0;
  // Row r's copies: lpe of row r (column u-1), lpb of row r-1 (column u),
  // into a slot of the rings; the sources of the walk's copies move down a
  // row a step.
  const unsigned ring_e0 = smem_addr(s.ring_e + lane), ring_b0 = smem_addr(s.ring_b + lane);
  constexpr unsigned kSlot = wtt::kWarp * sizeof(T);
  auto copy_row = [&](int r, int slot, const T* src_e, const T* src_b) {
    if (pe_col && in_rows(r, e.Tv)) copy_async(ring_e0 + slot * kSlot, src_e);
    if (in_col && in_rows(r - 1, e.Tv)) copy_async(ring_b0 + slot * kSlot, src_b);
  };
  T a = u == 0 ? T(0) : neg;
  for (int r = 0; r <= kAhead - c0; ++r)  // band 0: rows 0 .. kAhead
    copy_row(r, r, s.pe + (r * U + u - 1), s.pb + ((r - 1) * U + u));
  copy_commit();
  copy_wait_all();
  if (u == 0) s.ring_b[lane] = a;  // row 0's result
  if (lane == wtt::kWarp - 1) s.edge[s.band] = a;
  band_barrier(s.barrier, s.bands);
  int rc = 1 + kAhead - c0, sc = wrap(rc % kRing, kRing);  // the step's copy: row, slot
  int t = 1 - c0 - lane, sl = wrap(t % kRing, kRing);      // the lane's cell: row, slot
  int ro = 1 - c0 - wtt::kWarp, so = wrap(ro % kRing, kRing);  // the row written out
  const T* src_e = s.pe + (rc * U + u - 1);
  const T* src_b = s.pb + ((rc - 1) * U + u);
  T* dst = s.out + (ro * U + u);
  T edge = left_band ? s.edge[s.band - 1] : neg;
  T lpb_v = s.ring_b[sl * wtt::kWarp + lane], lpe_v = s.ring_e[sl * wtt::kWarp + lane];
  for (int n = 1; n < e.steps; ++n) {
    // alpha(t, u-1): the left lane's, or the left band's edge, of diagonal n-1.
    T left = __shfl_up_sync(kFull, a, 1);
    left = lane == 0 ? edge : left;
    const T done = s.ring_b[so * wtt::kWarp + lane];
    const T no_emit = t >= 1 ? a + wtt::clamp_neg(lpb_v) : neg;
    const T emit = u >= 1 ? left + wtt::clamp_neg(lpe_v) : neg;
    const T x = step_lse(no_emit, emit);
    copy_row(rc, sc, src_e, src_b);
    copy_commit();
    a = in_rows(t, e.Tv) && in_col ? x : neg;
    s.ring_b[sl * wtt::kWarp + lane] = x;  // over the lpb it used; read only where valid
    if (in_rows(ro, e.Tv) && in_col) *dst = done;
    src_e += U;
    src_b += U;
    dst += U;
    ++rc;
    sc = sc + 1 == kRing ? 0 : sc + 1;
    ++t;
    sl = sl + 1 == kRing ? 0 : sl + 1;
    ++ro;
    so = so + 1 == kRing ? 0 : so + 1;
    copy_wait();
    lpb_v = s.ring_b[sl * wtt::kWarp + lane];
    lpe_v = s.ring_e[sl * wtt::kWarp + lane];
    if (lane == wtt::kWarp - 1) s.edge[(n & 1) * kMaxBands + s.band] = a;
    band_barrier(s.barrier, s.bands);
    edge = left_band ? s.edge[(n & 1) * kMaxBands + s.band - 1] : neg;
  }
  // The rows completed at the last diagonals.
  for (; ro < e.Tv; ++ro)
    if (ro >= 0 && in_col) s.out[ro * U + u] = s.ring_b[wrap(ro % kRing, kRing) * wtt::kWarp + lane];
  if (e.terminal && u == e.Uv - 1)
    *llf = a + wtt::clamp_neg(s.pb[(e.Tv - 1) * U + u]);
  else if (!e.terminal && u == 0)
    *llf = neg;
}

// Beta over diagonals N_b-1 .. 0, seeded at the terminal cell (the only
// cell of diagonal N_b-1 inside the lattice, set before the walk);
// ll_backward = beta(0, 0). Lane l at diagonal n reads lpb(t, u), lpe(t, u)
// of its own cell: slot r of the input ring, copied at step
// r + c0 + 31 + kAhead (the walk goes down); row r of the results is
// complete at step r + c0 and written out at step r + c0 - 1.
template <typename T>
__device__ void beta_walk(const Band<T>& s, T* __restrict__ llb) {
  const T neg = T(wtt::kNeg);
  const Extent& e = s.e;
  const int c0 = s.band * wtt::kWarp, lane = s.lane, u = s.u, U = s.U;
  const bool in_col = u < e.Uv;
  const bool right_band = lane == wtt::kWarp - 1 && s.band + 1 < s.bands;
  // Row r's copies: lpb and lpe of row r (column u), into a slot of the
  // rings; the sources of the walk's copies move up a row a step.
  const unsigned ring_e0 = smem_addr(s.ring_e + lane), ring_b0 = smem_addr(s.ring_b + lane);
  constexpr unsigned kSlot = wtt::kWarp * sizeof(T);
  auto copy_row = [&](int r, int slot, int offset) {
    if (in_col && in_rows(r, e.Tv)) {
      copy_async(ring_b0 + slot * kSlot, s.pb + offset);
      copy_async(ring_e0 + slot * kSlot, s.pe + offset);
    }
  };
  T bv = neg;
  int first = e.steps - 1;  // the first diagonal the walk computes
  if (e.terminal) {
    if (u == e.Uv - 1) bv = wtt::clamp_neg(s.pb[(e.Tv - 1) * U + u]);
    --first;
  }
  int rc = first - c0 - (wtt::kWarp - 1) - kAhead;  // the first step's copy
  for (int r = rc + 1; r <= first - c0; ++r) copy_row(r, wrap(r % kRing, kRing), r * U + u);
  copy_commit();
  copy_wait_all();
  if (e.terminal && u == e.Uv - 1) s.ring_b[((e.Tv - 1) % kRing) * wtt::kWarp + lane] = bv;
  if (lane == 0) s.edge[((first + 1) & 1) * kMaxBands + s.band] = bv;
  band_barrier(s.barrier, s.bands);
  int sc = wrap(rc % kRing, kRing);
  int t = first - c0 - lane, sl = wrap(t % kRing, kRing);
  int ro = first - c0 + 1, so = wrap(ro % kRing, kRing);
  int src = rc * U + u;
  T* dst = s.out + (ro * U + u);
  T edge = right_band ? s.edge[((first + 1) & 1) * kMaxBands + s.band + 1] : neg;
  T lpb_v = s.ring_b[sl * wtt::kWarp + lane], lpe_v = s.ring_e[sl * wtt::kWarp + lane];
  for (int n = first; n >= 0; --n) {
    // beta(t, u+1): the right lane's, or the right band's edge, of diagonal n+1.
    T right = __shfl_down_sync(kFull, bv, 1);
    right = lane == wtt::kWarp - 1 ? edge : right;
    const T done = s.ring_b[so * wtt::kWarp + lane];
    const T no_emit = t + 1 < s.Tmax ? bv + wtt::clamp_neg(lpb_v) : neg;
    const T emit = u + 1 < U ? right + wtt::clamp_neg(lpe_v) : neg;
    const T x = step_lse(no_emit, emit);
    copy_row(rc, sc, src);
    copy_commit();
    bv = in_rows(t, e.Tv) && in_col ? x : neg;
    s.ring_b[sl * wtt::kWarp + lane] = x;  // over the lpb it used; read only where valid
    if (in_rows(ro, e.Tv) && in_col) *dst = done;
    src -= U;
    dst -= U;
    --rc;
    sc = sc == 0 ? kRing - 1 : sc - 1;
    --t;
    sl = sl == 0 ? kRing - 1 : sl - 1;
    --ro;
    so = so == 0 ? kRing - 1 : so - 1;
    copy_wait();
    lpb_v = s.ring_b[sl * wtt::kWarp + lane];
    lpe_v = s.ring_e[sl * wtt::kWarp + lane];
    if (lane == 0) s.edge[(n & 1) * kMaxBands + s.band] = bv;
    band_barrier(s.barrier, s.bands);
    edge = right_band ? s.edge[(n & 1) * kMaxBands + s.band + 1] : neg;
  }
  // The rows completed at the last diagonals (band 0's row 0).
  for (; ro >= 0; --ro)
    if (ro < e.Tv && in_col) s.out[ro * U + u] = s.ring_b[(ro % kRing) * wtt::kWarp + lane];
  if (u == 0) *llb = bv;
}

// NEG into the band's cells outside (t < Tv) & (u < Uv), a row at a time.
template <typename T>
__device__ void fill_invalid(const Band<T>& s) {
  const T neg = T(wtt::kNeg);
  const int c0 = s.band * wtt::kWarp;
  const bool full = min(c0 + wtt::kWarp, s.U) <= s.e.Uv;  // no column beyond Uv
  if (s.u >= s.U) return;
  for (int t = full ? s.e.Tv : 0; t < s.Tmax; ++t)
    if (t >= s.e.Tv || s.u >= s.e.Uv) s.out[t * s.U + s.u] = neg;
}

// Grid: a block of `per_block` lattices, `bands` warps each; lattice i is
// utterance i / dirs, alpha (i % dirs == 0) or beta.
template <typename T>
__global__ void __launch_bounds__(kMaxWarps * wtt::kWarp)
    wavefront_band_kernel(const T* __restrict__ lpb, const T* __restrict__ lpe,
                          const int* __restrict__ input_lengths,
                          const int* __restrict__ label_lengths, T* __restrict__ alphas,
                          T* __restrict__ betas, T* __restrict__ ll_forward,
                          T* __restrict__ ll_backward, int B, int Tmax, int U, int dirs,
                          int bands, int per_block) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) unsigned char edge_raw[kEdgeBytes];
  const int warp = threadIdx.x / wtt::kWarp;
  const int slot = warp / bands;  // the lattice's place in the block
  const int lattice = blockIdx.x * per_block + slot;
  if (lattice >= B * dirs) return;  // all warps of this lattice
  const int b = lattice / dirs;
  Band<T> s;
  s.e = extent(input_lengths[b], label_lengths[b] + 1, Tmax, U);
  s.band = warp % bands;
  s.lane = threadIdx.x % wtt::kWarp;
  s.u = s.band * wtt::kWarp + s.lane;
  s.U = U;
  s.Tmax = Tmax;
  s.bands = (s.e.Uv + wtt::kWarp - 1) / wtt::kWarp;  // the bands that walk
  s.barrier = 1 + slot;
  const long long base = (long long)b * Tmax * U;
  s.pb = lpb + base;
  s.pe = lpe + base;
  const bool is_beta = lattice % dirs == 1;
  s.out = (is_beta ? betas : alphas) + base;
  T* ring = reinterpret_cast<T*>(smem_raw) + (size_t)warp * 2 * kRing * wtt::kWarp;
  s.ring_b = ring;
  s.ring_e = ring + kRing * wtt::kWarp;
  s.edge = reinterpret_cast<T*>(edge_raw) + slot * 2 * kMaxBands;
  if (s.band < s.bands && s.e.steps > 0) {
    if (is_beta)
      beta_walk(s, ll_backward + b);
    else
      alpha_walk(s, ll_forward + b);
  } else if (s.band == 0) {  // no frame or no label column: nothing walks
    (is_beta ? ll_backward : ll_forward)[b] = T(wtt::kNeg);
  }
  fill_invalid(s);
}

// The block kernel, for U above the band kernel's cap: grid (B, 2) with
// blockIdx.y choosing alpha (0) or beta (1), or (B, 1) for the scoring
// path; thread i handles u = i, i + blockDim, ...; the previous diagonal in
// shared memory, double-buffered, one barrier a diagonal.
template <typename T>
__global__ void wavefront_block_kernel(const T* __restrict__ lpb, const T* __restrict__ lpe,
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


int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n < 1)
    return 1;
  return n;
}

template <typename T>
int launch(const void* lpb, const void* lpe, const int* input_lengths,
           const int* label_lengths, void* alphas, void* betas, void* ll_forward,
           void* ll_backward, int B, int Tmax, int U, int compute_betas,
           cudaStream_t stream) {
  const int dirs = compute_betas ? 2 : 1;
  const Plan p = plan(B, Tmax, U, sizeof(T), dirs, sm_count());
  const T* pb = static_cast<const T*>(lpb);
  const T* pe = static_cast<const T*>(lpe);
  T* al = static_cast<T*>(alphas);
  T* be = static_cast<T*>(betas);
  T* lf = static_cast<T*>(ll_forward);
  T* lb = static_cast<T*>(ll_backward);
  if (p.smem > 48 * 1024) {
    cudaError_t err = p.band_mode
                          ? cudaFuncSetAttribute(wavefront_band_kernel<T>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 p.smem)
                          : cudaFuncSetAttribute(wavefront_block_kernel<T>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 p.smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (p.band_mode)
    wavefront_band_kernel<T><<<p.blocks, p.threads, p.smem, stream>>>(
        pb, pe, input_lengths, label_lengths, al, be, lf, lb, B, Tmax, U, dirs, p.bands,
        p.per_block);
  else
    wavefront_block_kernel<T><<<dim3(B, dirs), p.threads, p.smem, stream>>>(
        pb, pe, input_lengths, label_lengths, al, be, lf, lb, Tmax, U);
  return (int)cudaGetLastError();
}

template <typename T>
int attrs(int U, int* regs, int* local_bytes) {
  cudaFuncAttributes a;
  const cudaError_t err = plan(1, 1, U, sizeof(T), 2, 1).band_mode
                              ? cudaFuncGetAttributes(&a, wavefront_band_kernel<T>)
                              : cudaFuncGetAttributes(&a, wavefront_block_kernel<T>);
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}

int elt_size(int dtype) {
  return dtype == wtt::kF32 ? 4 : (dtype == wtt::kF64 ? 8 : 0);
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

// The launch plan for B utterances of T frames and U labels, on a card of
// n_sm SMs: out = {band kernel (1) or block kernel (0), bands (warps) a
// lattice, lattices a block, blocks, threads a block, dynamic shared memory a
// block}; all -1 for an unknown dtype.
void wtt_wavefront_plan(int B, int T, int U, int dtype, int compute_betas, int n_sm, int* out) {
  const int elt = elt_size(dtype);
  if (elt == 0 || n_sm < 1) {
    for (int i = 0; i < 6; ++i) out[i] = -1;
    return;
  }
  const Plan p = plan(B, T, U, elt, compute_betas ? 2 : 1, n_sm);
  const int v[6] = {p.band_mode, p.bands, p.per_block, p.blocks, p.threads, p.smem};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
}

// Registers and local (spill) bytes a thread of the kernel that a lattice
// of U labels runs, as ptxas compiled it.
int wtt_wavefront_attrs(int U, int dtype, int* regs, int* local_bytes) {
  switch (dtype) {
    case wtt::kF32: return attrs<float>(U, regs, local_bytes);
    case wtt::kF64: return attrs<double>(U, regs, local_bytes);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
