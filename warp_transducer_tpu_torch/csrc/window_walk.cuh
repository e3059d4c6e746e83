// Pending-window lattice kernel: the alpha and beta recursions of the
// duration-arc losses (multi-blank, TDT) over the T rows of each
// utterance's (T, U) lattice, t-major.
//
// Replaces: warp_transducer_tpu/ops/pallas/window_stream.py:104
// (_window_kernel, called through _run_window_kernel), which steps
// (B_pad, U_pad) tiles of the whole batch through a (T, C, B_pad, U_pad)
// panel streamed into VMEM in double-buffered chunks, with W rows unrolled
// per iteration so that every ring slot is static. None of that TPU layout
// is carried over: the inputs stay (B, T, U) and (B, T, U, Cx) as the
// callers have them.
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
// moves (2 + Cx)·B·T·U values in and 2·B·T·U out, which the card streams in
// microseconds; but row t needs the W rows before it, so a lattice costs
// T_b times the latency of one row step.
//
// The design (window_warp_kernel): G warps walk one lattice (an utterance
// and a direction) row by row, and a block holds a few lattices; no row
// step has a block barrier.
// * Warp g owns the columns g·P … g·P + P - 1 (P = 32·C) and its lane l the
//   C consecutive ones from g·P + l·C, C odd (a template parameter, up to
//   max_cells), so that rows stored in natural order in shared memory are
//   read at a lane stride of C words, which no two lanes share a bank at.
//   G is 4 or 2 where U is long and the lattices are few (long_t: 32
//   lattices, G = 4, C = 3), else 1; where that G cannot run (C past
//   max_cells, or rings past a block), the plan takes 4 warps, or 2.
// * The chain's log-sum-exp scan of a row is a local scan of the lane's C
//   cells as (max, sum) pairs, one 5-step __shfl_up_sync (alpha) /
//   __shfl_down_sync (beta) scan of the lane totals, one shuffle for the
//   exclusive carry and a fix-up of each cell, independent across cells. A
//   pair (m, s) stands for m + log(s); joining two costs one exp, and a cell
//   takes one log at the end. With G > 1 the warps of a lattice trade their
//   row totals through shared memory behind one named barrier a row
//   (bar.sync id, 32·G), and a second where emit arcs cross a warp's edge
//   (without a chain, only that one).
// * The chain's prefix c(u) depends on the row's inputs only: the next
//   row's is scanned in the same loop as this row's log-sum-exp, so that the
//   two chains of shuffles overlap.
// * Alpha gathers its arrivals instead of scattering arcs into a ring: each
//   arc keeps a ring of the departures α(t, u) + w(t, u) of its last W + 1
//   rows, and row t reads the departure of row t - m at u (blank) or u - 1
//   (emit). Beta keeps its own last W + 1 rows. The rings are slices of the
//   lattice's shared memory, W + 1 rows deep so that a row's writes never
//   meet the reads of the same row (an arc with m = W reads the slot that
//   the next row takes); one __syncwarp a row orders them within a warp.
// * Each row's channels (lpb, lpe, the Cx extras, contiguous in u) are
//   copied by coalesced cp.async, each warp its columns, into a ring kAhead
//   rows ahead of their use; each row waits for its own copies
//   (cp.async.wait_group) and then the warp's __syncwarp.
// * An arc's weight is two channel loads and an add (a one-channel arc's
//   second load reads a zero word), with no branch between them.
// * f32 takes exp and log on the SFU (ex2.approx.ftz, lg2.approx.ftz);
//   f64 keeps exp and log.
// * Each warp stops at its own T_b. Alpha's rows go out through a staged
//   row in shared memory and beta's through its ring, a row late and
//   coalesced; rows T_b … T-1 get NEG after the walk.
// What bounds it now (clock64 marks in one lattice, NVIDIA H100 80GB HBM3,
// 700 W, long_t multi-blank, four warps; PERF.md §6): ≈ 2500 cycles a
// row, of which the issue of the row's cp.async copies ≈ 400, the arcs
// (arrivals, departures) ≈ 600–900, the scans ≈ 400 and the exchange's
// barrier ≈ 300–450; the SFU is not what a row waits on.
//
// Two instances of each C (kWide). The narrow one is the walk above, as the
// main shapes run it: G <= 4, arcs of one or two channels, 32-bit offsets
// inside a lattice, one pass. The wide one takes every other lattice:
// * G up to 16 warps (a block of 512 threads; 8 where the instance's
//   registers do not fit 128 a thread), the exchange sized for them;
// * arcs of three channels (three loads and two adds a weight);
// * 64-bit offsets inside a lattice;
// * passes: where a lattice's rings do not fit a block at any G, its
//   columns are cut into passes of P = 32·G·C, walked one after another by
//   the same warps (alpha left to right, beta right to left), each pass all
//   T_b rows. Between two passes go, per row, through device memory: the
//   chain's log-sum-exp carry as a (max, sum) pair, and the edge column (the
//   departures of alpha's emit arcs at the pass's last column; beta at the
//   next pass's first column). The receiving pass copies its rows of them
//   into its copy ring with the channels, and one lane joins the carry into
//   its first cell (alpha) / last cell (beta) and writes the edge into a
//   column of the rings kept for it. Each pass solves its chain in its own
//   frame (c = 0 at the pass's first column): the carry moves to the next
//   frame by adding the chain total of the pass between the two frames'
//   starts (alpha: the sender's, beta: the receiver's), so that no pass
//   needs the chain sums of the columns before it.
// The plan (instance, warps a lattice, cells a lane, passes, lattices a
// block, shared memory, the device memory of the passes) is `plan` below,
// mirrored by ops/cuda/window.py::plan; wtt_window_plan lets a card test
// hold the two equal, and tests/test_torch_window_plan.py replays both
// instances' schedules in numpy on the CPU.
//
// No atomics: two calls give the same bits.
//
// A third kernel, window_table_kernel, takes every arc table past the
// narrow and wide instances' by-value one (more than kMaxArcs blank or emit
// arcs, more than kMaxChannels channels) and every window whose rings pass a
// block at every G and pass: the wide walk over the arcs of a table in
// device memory, copied into the block's shared memory as it starts and
// read in the walk's loops, 8 warps a block (kTableWarps). It comes in two
// forms (kPend), and the plan takes the one that measured faster:
// * the rings form: alpha keeps a ring of W + 1 rows of departures for
//   each arc, as the by-value instances do. Its row step gathers one
//   independent load an arc, so it is the faster form wherever its rings
//   take no more of the card's memory than the pending window does: K = 9,
//   TDT 0 … 8 at T = 150 and the 300-frame window (PERF.md §6).
// * the pending form: alpha keeps one pending window of arrivals, as the
//   TPU kernel does (window_stream.py:153-208), so that its memory does not
//   grow with the number of arcs. The plan takes it where, on the rings
//   form's warps and cells a lattice, that keeps the rings in shared memory
//   when the rings form's pass a block (TDT 0 … 8 at T = 1500, D = 33), or
//   fits more lattices a block (K = 16).
//   - W + 1 slots of the pass's UP columns, slot t mod (W + 1) gathering
//     the arrivals of row t; row t reads its slot into the chain scan
//     (where the by-value instances gather `ne`), then empties it for row
//     t + W + 1;
//   - row t then scatters its departures a group of one m at a time (the
//     host sorts the table into those groups): a lane joins a group's arcs
//     in registers (a blank arc's α(t, u) + w(t, u) at u, an emit arc's
//     moved on to u + 1: within the lane, to the next lane by a shuffle,
//     from lane 31 into its warp's entry after the slot's columns, which
//     the next warp's lane 0 reads behind the row's barrier, or, from the
//     last warp, which the pass hands on pre-joined as the next pass's
//     first column's arrival), then joins them into slot (t + m) mod
//     (W + 1): one read and one write a cell for each distinct m, not one
//     for each arc (TDT's blank and emit arc of one duration share a
//     group). Every cell has one writer, the lane that owns it, so only the
//     warps' entries need a barrier; W + 1 slots keep a row's scatter off
//     the slot that it empties. Each group's read waits for the store
//     before it (the slots may alias), so a row step is a chain of
//     dependent loads where the rings form's loads overlap;
//   - the slots hold (max, sum) pairs, the walk's own joins: a join is one
//     exp and no log, and the row reads its arrivals as the pairs its scans
//     take. Log values (one word a cell, a log at every store), timed on
//     this form beside the pairs where the plan takes it: 1.3% and 1.8%
//     slower at TDT 0 … 8 at T = 1500 and D = 33, 2.3% faster at K = 16
//     (PERF.md §6);
//   - ll_forward's terminal blank arcs are summed as they are sent, in a
//     register of the lane that owns column U_b - 1 (the pending slot of
//     row T_b mixes them with other arrivals).
// Beta keeps its ring of W + 1 rows in both. Where the rings pass a block
// they lie in device memory. The by-value instances keep their code: the
// table instance is an instantiation of its own.
//
// The walk's code (this header) is built in four files, so that they
// compile in parallel: window_stream.cu (the narrow instances, the plan and
// the launches), window_stream_wide.cu (the wide instances),
// window_stream_table.cu (the table instance's rings form) and
// window_stream_pending.cu (its pending form).
#pragma once

#include <climits>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
// The arc table that the narrow and the wide instances take by value: up to
// kMaxArcs blank and kMaxArcs emit arcs over up to kMaxChannels channels
// (the standard blank and eight big blanks; lpb, lpe and eight extra
// channels). Past these the table instance takes the arcs from device
// memory, any number of them over any number of channels.
constexpr int kMaxArcs = 9;
constexpr int kMaxArcChannels = 3;  // an arc sums at most three channels
constexpr int kMaxChannels = 10;
// Row-chain sentinel of the prefix sums (ops/band.py::CLAMP).
constexpr double kClamp = -1.0e4;

// Rows of channels are copied kAhead rows ahead into a ring of kCopyRows.
constexpr int kAhead = 3;
constexpr int kCopyRows = kAhead + 1;
constexpr int kSmemMax = 232448;  // a block's shared memory on sm_90
constexpr int max_cells(int elt) { return elt == 4 ? 17 : 9; }
// The table instance's pending form's: f64 stops at 7 (its scatter's pairs
// spilled at 9).
constexpr int pending_max_cells(int elt) { return elt == 4 ? 17 : 7; }
// Values after beta's ring that an emit arc's load at the last padded column
// may touch (its value is selected away).
constexpr int kSlack = 32;
// Words after a copied row's channels; the first holds 0.
constexpr int kRowPad = 4;

// What differs between the two instances: warps a lattice (kMaxG),
// channels an arc, the offsets' type. The exchange of a lattice's warps: two
// slots (row parity) of kMaxG warps' (total m, total s, chain total, unused).
template <bool kWide>
struct Shape {
  static constexpr int kMaxG = kWide ? 16 : 4;
  static constexpr int kArcCh = kWide ? 3 : 2;
  static constexpr int kXchWords = 2 * kMaxG * 4;
  using Off = typename std::conditional<kWide, long long, int>::type;
};
// Warps a block: 8 in the narrow instance; in the wide one of C cells a
// lane of `elt`-byte values 16 where a thread's registers fit 128 (a
// 512-thread block), else 8 (ptxas spills f32 C >= 15 and f64 C >= 3 at 128).
constexpr int kNarrowWarps = 8;
constexpr int wide_warps(int elt, int C) { return (elt == 4 ? C <= 13 : C <= 1) ? 16 : 8; }
// The table instance: at most 8 warps a block at every C (its arc loops
// and table take registers past 128 a thread where 16 warps share an SM).
constexpr int kTableWarps = 8;
// Values a row that the pending form's passes hand on: the chain's carry
// as a pair, then (alpha) the arrivals of the next pass's first column as a
// pair, (beta) the edge column. The rings form hands on 2 + n_arcs, as the
// wide instance does.
constexpr int kPendHand = 4;
template <typename T, int C, bool kWide>
constexpr int block_threads() {
  return (kWide ? wide_warps(sizeof(T), C) : kNarrowWarps) * wtt::kWarp;
}

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

// An arc as the kernel reads it: channel k of cell u lies at word base[k] +
// u·stride[k] of a copied row. An arc of fewer than N channels points the
// rest at the row's zero word (stride 0), so that its weight is always N
// loads and N - 1 adds, with no branch between them.
template <int N>
struct SlotArc {
  int m, n;
  int base[N];
  int stride[N];
};

template <int N>
struct SlotArcs {
  static constexpr bool kPend = false;
  int W, has_chain, n_blank, n_emit;
  SlotArc<N> chain;
  SlotArc<N> arc[2 * kMaxArcs];  // the blank arcs, then the emit arcs
};

// The arcs of one duration m in the pending form's sorted copy: `n` arcs
// from `first`, the `n_blank` blank arcs before the emit arcs.
struct Group {
  int m, first, n_blank, n;
};

// The table instance's arcs: the chain by value, the blank arcs and then the
// emit arcs in the block's shared memory (copied there from device memory
// as the kernel starts), read in loops at run time; the pending form
// (kPend) also keeps the same arcs sorted by (m, blank before emit, table
// order) and their groups of one m (alpha's scatter), as the host sorted
// them.
template <int N, bool P>
struct TableArcs {
  static constexpr bool kPend = P;
  int W, has_chain, n_blank, n_emit;
  SlotArc<N> chain;
  const SlotArc<N>* arc;
  const SlotArc<N>* sorted;
  const Group* group;
  int n_groups;
};

// An arc row of the device table (m, n, ch0, ch1, ch2) as the walk reads
// it, for copied rows of UP values of lpb and of lpe, then UP·Cx extras
// interleaved by cell, then the zero word. The channels are summed in the
// row's order, as the plain version sums them.
template <int N>
__device__ __forceinline__ SlotArc<N> table_arc(const int* row, int up, int Cx) {
  SlotArc<N> a;
  a.m = row[0];
  a.n = row[1];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int c = row[2 + k];
    const bool used = k < a.n;
    a.base[k] = !used ? (2 + Cx) * up : c == 0 ? 0 : c == 1 ? up : 2 * up + (c - 2);
    a.stride[k] = !used ? 0 : c < 2 ? 1 : Cx;
  }
  return a;
}

// max(x, kClamp) that keeps a NaN, as torch.clamp_min does.
template <typename T>
__device__ __forceinline__ T clamp_chain(T x) {
  return x < T(kClamp) ? T(kClamp) : x;
}

// exp(x) for x <= 0 and log(x) for x >= 1 in a row step: f32 on the SFU
// (about 2^-22 relative), f64 exact.
__device__ __forceinline__ float fast_exp(float x) {
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(x * 1.4426950408889634f));
  return e;
}
__device__ __forceinline__ double fast_exp(double x) { return exp(x); }
__device__ __forceinline__ float fast_log(float x) {
  float l;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(l) : "f"(x));
  return l * 0.6931471805599453f;
}
__device__ __forceinline__ double fast_log(double x) { return log(x); }

// m + log(s): a log-sum-exp in progress. The identity (lowest, 0) joins
// with anything to give it back; a real term has s >= 1.
template <typename T>
struct Pair {
  T m, s;
};
template <typename T>
__device__ __forceinline__ Pair<T> identity() {
  return {wtt::lowest<T>(), T(0)};
}
template <typename T>
__device__ __forceinline__ T value(Pair<T> p) {
  return p.m + fast_log(p.s);
}
// a ⊕ b, one exp; a NaN on either side comes out in s.
template <typename T>
__device__ __forceinline__ Pair<T> join(Pair<T> a, Pair<T> b) {
  const T d = a.m - b.m;
  const T e = fast_exp(-fabs(d));
  if (d >= T(0)) return {a.m, fma(b.s, e, a.s)};
  return {b.m, fma(a.s, e, b.s)};
}
template <typename T>
__device__ __forceinline__ Pair<T> shfl_up(Pair<T> p, int d) {
  return {__shfl_up_sync(kFull, p.m, d), __shfl_up_sync(kFull, p.s, d)};
}
template <typename T>
__device__ __forceinline__ Pair<T> shfl_down(Pair<T> p, int d) {
  return {__shfl_down_sync(kFull, p.m, d), __shfl_down_sync(kFull, p.s, d)};
}

template <typename T>
__device__ __forceinline__ void copy_async(unsigned dst, const T* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst), "l"(src),
               "n"((int)sizeof(T)));
}
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// Wait until at most n of this lane's newest copy groups are in flight.
template <int n>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}
// Whether row r lies in [0, n).
__device__ __forceinline__ bool in_rows(int r, int n) { return (unsigned)r < (unsigned)n; }

// What a warp of one lattice works with. The lattice's G warps split its
// columns: warp g owns u = g·P … g·P + P - 1 (P = 32·C), lane l of it the C
// cells from u0 = g·P + l·C. In the wide instance the columns are those of
// the pass (from `start`), and u, U, U_b count from there.
template <typename T>
struct Walk {
  const T* pb;  // the utterance's lpb, lpe (T, U) and extra (T, U, Cx), from the pass's start
  const T* pe;
  const T* px;
  T* out;       // its alphas or betas
  T* copy;      // [kCopyRows][slot_words]: rows of lpb, lpe (UP each), extra (UP·Cx), the pad
                // and (wide) the incoming pass's hw values
  T* ring;      // alpha: [n_arcs][R][RS] departures (the pending form: its
                // window, [R][2][UP + G]); beta: [R][RS] rows of beta
  T* stage;     // alpha: [2][UP], rows on their way out
  T* xch;       // [2][kMaxG][4]: each warp's row total (m, s) and chain total
  int Tv, Uv, Tb, Ub, U, Cx, R, UP, slot_words, lane, g, G, bar, u0;
  // The wide instance: the row stride (the lattice's U), the columns from
  // the pass's start to the lattice's end, the pass's first column, the
  // values a row of the passes' device memory, where they lie in a copied
  // row, the rows the previous pass handed on (or null) and those this one
  // hands on (or null).
  int ld, Ur, start, hw, hbase;
  const T* hin;
  T* hout;
  bool dev_ring;  // the pending form: its rings lie in device memory
};

// The G warps of a lattice meet (bar.sync id, 32·G); a lattice of one warp
// needs no barrier.
template <typename T>
__device__ __forceinline__ void lattice_barrier(const Walk<T>& s) {
  if (s.G > 1) asm volatile("bar.sync %0, %1;\n" ::"r"(s.bar), "r"(s.G * wtt::kWarp) : "memory");
}

// Copy row r of the channels of the warp's columns into its slot of the
// copy ring, coalesced; no copy for a row outside [0, Tv). A warp reads only
// the words it copied. (Copies of 16 bytes from the rows' 16-byte lines,
// with the bounds checks at the tensors' ends, made a row slower.) Wide: the
// warp that receives the previous pass's row (`takes`) copies it too, a
// value a lane (kTable: in a loop, for a row of more than 32 values).
template <typename T, int C, bool kWide, bool kTable = false>
__device__ __forceinline__ void copy_row(const Walk<T>& s, int r, bool takes) {
  using Off = typename Shape<kWide>::Off;
  if (!in_rows(r, s.Tv)) return;
  constexpr int kP = wtt::kWarp * C;
  const int ld = kWide ? s.ld : s.U;
  const unsigned dst = smem_addr(s.copy + (r % kCopyRows) * s.slot_words);
  const T* pb = s.pb + (Off)r * ld;
  const T* pe = s.pe + (Off)r * ld;
  const int first = s.g * kP;
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int w = first + s.lane + k * wtt::kWarp;
    if (w < s.U) {
      copy_async(dst + w * sizeof(T), pb + w);
      copy_async(dst + (s.UP + w) * sizeof(T), pe + w);
    }
  }
  const int end = min(first + kP, s.U) * s.Cx;
  const T* px = s.px + (Off)r * ld * s.Cx;
#pragma unroll 4
  for (int w = first * s.Cx + s.lane; w < end; w += wtt::kWarp)
    copy_async(dst + (2 * s.UP + w) * sizeof(T), px + w);
  if constexpr (kTable) {
    if (takes)
      for (int i = s.lane; i < s.hw; i += wtt::kWarp)
        copy_async(dst + (s.hbase + i) * sizeof(T), s.hin + (Off)r * s.hw + i);
  } else if constexpr (kWide) {
    if (takes && s.lane < s.hw)
      copy_async(dst + (s.hbase + s.lane) * sizeof(T), s.hin + (Off)r * s.hw + s.lane);
  }
}

// max(x, NEG) that keeps a NaN (wtt::clamp_neg), in f32 one max.NaN.
__device__ __forceinline__ float clamp_row(float x) {
  float y;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(y) : "f"(x), "f"(float(wtt::kNeg)));
  return y;
}
__device__ __forceinline__ double clamp_row(double x) { return wtt::clamp_neg(x); }

// An arc's weights at the lane's cells u0 … u0 + C - 1 of a copied row: its
// channels, each clamped at NEG, summed in channel order (the zero word
// adds nothing: x + 0 = x). The cells beyond U read words of the row's
// padding (never copied) and come out as garbage that the callers select
// away; every cell loop here and below is straight-line code, so that the
// compiler schedules across cells.
template <typename T, int C, int N>
__device__ __forceinline__ void arc_weights(const T* row, const SlotArc<N>& a, int u0, T (&w)[C]) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int st = a.stride[k];
    const T* src = row + a.base[k] + u0 * st;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const T x = clamp_row(src[j * st]);
      w[j] = k == 0 ? x : w[j] + x;
    }
  }
}

// The arcs loop: f(i, arc i) for i = 0 … n - 1, arc 0 apart and the rest
// rolled (unrolled, by two or all, a row got slower).
template <typename A, typename F>
__device__ __forceinline__ void for_arcs(const A* arc, int n, F&& f) {
  f(0, arc[0]);
#pragma unroll 1
  for (int i = 1; i < n; ++i) f(i, arc[i]);
}

// The chain's weights of a copied row at the lane's cells, clamped at the
// chain's sentinel; 0 beyond U.
template <typename T, int C, int N>
__device__ __forceinline__ void chain_weights(const Walk<T>& s, const SlotArc<N>& chain,
                                              const T* row, T (&w)[C]) {
  arc_weights<T, C, N>(row, chain, s.u0, w);
#pragma unroll
  for (int j = 0; j < C; ++j) w[j] = s.u0 + j < s.U ? clamp_chain(w[j]) : T(0);
}

// Local exclusive sums of the chain weights: c[j] the sum before cell j;
// returns the lane's total.
template <typename T, int C>
__device__ __forceinline__ T local_prefix(const T (&w)[C], T (&c)[C]) {
  T run = T(0);
#pragma unroll
  for (int j = 0; j < C; ++j) {
    c[j] = run;
    run += w[j];
  }
  return run;
}

// The chain's exclusive prefix c(u) of a copied row within the warp's
// columns: local exclusive sums, then the lane totals' exclusive warp scan
// (inclusive, shifted by one lane). Returns the lane's inclusive sum (lane
// 31: the warp's total); the warps before it add theirs later. (In the row
// loop the same scan runs interleaved with the log-sum-exp scan.)
template <typename T, int C, int N>
__device__ __forceinline__ T chain_prefix(const Walk<T>& s, const SlotArc<N>& chain, const T* row,
                                          T (&c)[C]) {
  T w[C];
  chain_weights<T, C, N>(s, chain, row, w);
  T incl = local_prefix<T, C>(w, c);
#pragma unroll
  for (int sh = 1; sh < wtt::kWarp; sh <<= 1) {
    const T o = __shfl_up_sync(kFull, incl, sh);
    incl += s.lane >= sh ? o : T(0);
  }
  T ex = __shfl_up_sync(kFull, incl, 1);
  ex = s.lane == 0 ? T(0) : ex;
#pragma unroll
  for (int j = 0; j < C; ++j) c[j] += ex;
  return incl;
}

// The sum of the chain totals that the warps before this one published in
// exchange slot `par`: the offset of this warp's prefixes.
template <typename T, int kMaxG>
__device__ __forceinline__ T chain_offset(const Walk<T>& s, int par) {
  T off = T(0);
#pragma unroll
  for (int g = 0; g < kMaxG - 1; ++g)
    if (g < s.g) off += s.xch[(par * kMaxG + g) * 4 + 2];
  return off;
}

// The join of the row totals that the warps `lo` … `hi` - 1 published in
// exchange slot `par`, in warp order.
template <typename T, int kMaxG>
__device__ __forceinline__ Pair<T> warp_totals(const Walk<T>& s, int par, int lo, int hi) {
  Pair<T> acc = identity<T>();
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
    if (g >= lo && g < hi) {
      const T* x = s.xch + (par * kMaxG + g) * 4;
      acc = join(acc, Pair<T>{x[0], x[1]});
    }
  return acc;
}

// The pending form's departures of row t (values a at the lane's cells),
// scattered into the pending window `pend`: for each group of one m its
// arcs joined in registers (a blank arc's α(t, u) + w(t, u) at u; an emit
// arc's moved on to u + 1: within the lane, by a shuffle to the next lane,
// from lane 31 into its warp's entry after the slot's columns), then joined
// into slot (t + m) mod R, one read and one write a cell for each m. The
// terminal blank arcs (t + m = T_b, once a lattice) add their departure at
// column U_b - 1 to ll_forward's running sum `lf` of the lane that owns it.
// A row step is a chain of dependent loads and joins, a group after
// another. Where C cells of pairs leave registers to spare (f32 C <= 7, f64
// C <= 3: the main shapes), the loop over a group's arcs has no branch
// (each arc joins into every cell, blank or emit by a select; an emit arc's
// cell 0 and a blank arc's `last` join the empty pair, and a group without
// emit arcs shuffles it too) and the slot's loads (and lane 31's entry) go
// out before the arcs' sums: of the forms tried, the shortest row step
// (PERF.md §6; an entry loaded as it is joined cost the 300-frame
// window, whose window lies in device memory, 8%). Past
// them, blank and emit arcs take loops of their own and the slot is loaded
// as it is joined, so that no instance spills.
template <typename T, int C, int N, class Arcs>
__device__ __forceinline__ void scatter(const Walk<T>& s, const Arcs& arcs, T* pend, const T* row,
                                        const T (&a)[C], int t, int st, T& lf) {
  constexpr bool kSmall = C * sizeof(T) <= 28;
  const int lane = s.lane, u0 = s.u0, UP = s.UP, R = s.R, RSP = UP + s.G, uf = s.Ub - 1;
  const bool edge_out = lane == wtt::kWarp - 1 && (s.g + 1 < s.G || s.hout != nullptr);
  const int xo = UP + s.g;  // the warp's entry
  const T lo = wtt::lowest<T>();
#pragma unroll 1
  for (int k = 0; k < arcs.n_groups; ++k) {
    const Group gr = arcs.group[k];
    T* const dst = pend + (st + gr.m >= R ? st + gr.m - R : st + gr.m) * 2 * RSP;
    const int nb = gr.first + gr.n_blank, ne = gr.first + gr.n;
    Pair<T> old[C], olde, d[C], last = identity<T>();
#pragma unroll
    for (int j = 0; j < C; ++j) d[j] = identity<T>();
    if constexpr (kSmall) {
#pragma unroll
      for (int j = 0; j < C; ++j) old[j] = Pair<T>{dst[u0 + j], dst[RSP + u0 + j]};
      olde = Pair<T>{dst[edge_out ? xo : u0], dst[RSP + (edge_out ? xo : u0)]};
#pragma unroll 1
      for (int i = gr.first; i < ne; ++i) {
        T w[C];
        arc_weights<T, C, N>(row, arcs.sorted[i], u0, w);
        const bool emit = i >= nb;
#pragma unroll
        for (int j = 0; j < C; ++j) {
          const bool to = !(emit && j == 0);
          const T x = emit ? (j > 0 ? a[j - 1] + w[j - 1] : lo) : a[j] + w[j];
          d[j] = join(d[j], Pair<T>{x, to ? T(1) : T(0)});
        }
        last = join(last, Pair<T>{emit ? a[C - 1] + w[C - 1] : lo, emit ? T(1) : T(0)});
      }
    } else {
#pragma unroll 1
      for (int i = gr.first; i < nb; ++i) {
        T w[C];
        arc_weights<T, C, N>(row, arcs.sorted[i], u0, w);
#pragma unroll
        for (int j = 0; j < C; ++j) d[j] = join(d[j], Pair<T>{a[j] + w[j], T(1)});
      }
#pragma unroll 1
      for (int i = nb; i < ne; ++i) {
        T w[C];
        arc_weights<T, C, N>(row, arcs.sorted[i], u0, w);
#pragma unroll
        for (int j = 0; j + 1 < C; ++j) d[j + 1] = join(d[j + 1], Pair<T>{a[j] + w[j], T(1)});
        last = join(last, Pair<T>{a[C - 1] + w[C - 1], T(1)});
      }
    }
    if (kSmall || ne > nb) {  // small: a group without emit arcs shuffles an empty pair
      const Pair<T> in = shfl_up(last, 1);
      const Pair<T> d0 = join(d[0], in);
      d[0].m = lane > 0 ? d0.m : d[0].m;
      d[0].s = lane > 0 ? d0.s : d[0].s;
      if (edge_out) {
        if constexpr (!kSmall) olde = Pair<T>{dst[xo], dst[RSP + xo]};
        const Pair<T> o = join(olde, last);
        dst[xo] = o.m;
        dst[RSP + xo] = o.s;
      }
    }
#pragma unroll
    for (int j = 0; j < C; ++j) {
      if constexpr (!kSmall) old[j] = Pair<T>{dst[u0 + j], dst[RSP + u0 + j]};
      const Pair<T> o = join(old[j], d[j]);
      dst[u0 + j] = o.m;
      dst[RSP + u0 + j] = o.s;
    }
    if (t + gr.m == s.Tb && u0 <= uf && uf < u0 + C) {
#pragma unroll 1
      for (int i = gr.first; i < nb; ++i) {
        T w[C];
        arc_weights<T, C, N>(row, arcs.sorted[i], u0, w);
        T xf = a[0] + w[0];
#pragma unroll
        for (int j = 1; j < C; ++j) xf = u0 + j == uf ? a[j] + w[j] : xf;
        lf = wtt::lse(lf, xf);
      }
    }
  }
}

// Alpha over rows 0 .. Tv-1; ll_forward from the departures of the
// terminal blank arcs.
template <typename T, int C, bool kWide, class Arcs = SlotArcs<Shape<kWide>::kArcCh>>
__device__ void alpha_walk(const Walk<T>& s, const Arcs& arcs, T* __restrict__ llf) {
  using Sh = Shape<kWide>;
  using Off = typename Sh::Off;
  constexpr int N = Sh::kArcCh;
  constexpr int kMaxG = Sh::kMaxG;
  constexpr int kP = wtt::kWarp * C;
  constexpr bool kTab = !std::is_same<Arcs, SlotArcs<N>>::value;  // the table instance
  constexpr bool kPend = Arcs::kPend;  // its pending form
  // Wide: the rings keep column -1 (the previous pass's edge) before the
  // pass's columns.
  constexpr int ro = kWide ? 1 : 0;
  const T neg = T(wtt::kNeg);
  const int lane = s.lane, u0 = s.u0, U = s.U, R = s.R, UP = s.UP;
  const int ld = kWide ? s.ld : U;
  const int RS = UP + ro;
  const bool first_pass = !kWide || s.start == 0;
  // Wide: lane 0 of warp 0 takes the previous pass's rows (rx); lane 31 of
  // the last warp hands this pass's on (tx).
  const bool takes = kWide && s.hin != nullptr && s.g == 0;
  const bool rx = takes && lane == 0;
  const bool tx = kWide && s.hout != nullptr && s.g == s.G - 1 && lane == wtt::kWarp - 1;
  const int n_arcs = arcs.n_blank + arcs.n_emit;
  // With several warps and emit arcs, a second barrier a row: an emit arc
  // reads the previous warp's last column of an earlier row (the pending
  // form: the previous warp's entry of the pending window).
  const bool cross = s.G > 1 && arcs.n_emit > 0;
  // The pending form's window: R slots of RSP (max, sum) pairs,
  // the m values of a slot then its s values; a slot's UP columns, then one
  // entry a warp g (the emit departures of its last column, for the next
  // warp's first column or, from the last warp, the next pass's). Each lane
  // empties its own cells, lane 31 its warp's entry; the barrier orders
  // that before any warp sends.
  [[maybe_unused]] const int RSP = UP + s.G;
  if constexpr (kPend) {
    for (int r = 0; r < R; ++r) {
      T* pm = s.ring + r * 2 * RSP;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        pm[u0 + j] = wtt::lowest<T>();
        pm[RSP + u0 + j] = T(0);
      }
      if (lane == wtt::kWarp - 1) {
        pm[UP + s.g] = wtt::lowest<T>();
        pm[RSP + UP + s.g] = T(0);
      }
    }
    lattice_barrier(s);
  }
  // ll_forward's column, and (the pending form) the running sum of the
  // terminal blank arcs' departures there, in the lane that owns it.
  const int uf = s.Ub - 1;
  T lf = neg;
  for (int r = 0; r < kAhead; ++r) {
    copy_row<T, C, kWide, kTab>(s, r, takes);
    copy_commit();
  }
  T c_cur[C], c_nxt[C];
#pragma unroll
  for (int j = 0; j < C; ++j) c_nxt[j] = T(0);
  // Wide: the pass's chain total of rows t and t + 1 (meaningful at tx).
  T tot_cur = T(0), tot_nxt = T(0);
  copy_wait<kAhead - 1>();  // row 0
  __syncwarp();
  if (arcs.has_chain && s.Tv > 0) {
    const T total = chain_prefix<T, C, N>(s, arcs.chain, s.copy, c_nxt);
    tot_nxt = total;
    if (s.G > 1) {  // the offsets of row 0, through exchange slot 1
      if (lane == wtt::kWarp - 1) s.xch[(kMaxG + s.g) * 4 + 2] = total;
      lattice_barrier(s);
      const T off = chain_offset<T, kMaxG>(s, 1);
#pragma unroll
      for (int j = 0; j < C; ++j) c_nxt[j] += off;
      tot_nxt += off;
    }
  }
  int st = 0;  // t mod R
  for (int t = 0; t < s.Tv; ++t) {
#pragma unroll
    for (int j = 0; j < C; ++j) c_cur[j] = c_nxt[j];
    tot_cur = tot_nxt;
    copy_wait<kAhead - 2>();  // rows t and t + 1
    __syncwarp();             // every lane's copies and the rings' last row
    copy_row<T, C, kWide, kTab>(s, t + kAhead, takes);
    copy_commit();
    const T* row = s.copy + (t % kCopyRows) * s.slot_words;
    // The chain's weights of row t + 1, for its prefix, scanned below beside
    // this row's log-sum-exp (after the last row: a slot no one uses).
    T cw[C];
    if (arcs.has_chain)
      chain_weights<T, C, N>(s, arcs.chain, s.copy + ((t + 1) % kCopyRows) * s.slot_words, cw);
    if (t > 0) {  // row t - 1 goes out
      const T* st_row = s.stage + ((t - 1) & 1) * UP + s.g * kP;
      T* dst = s.out + (Off)(t - 1) * ld + s.g * kP;
#pragma unroll
      for (int k = 0; k < C; ++k) {
        const int u = lane + k * wtt::kWarp;
        const T v = st_row[u];
        if (s.g * kP + u < U) dst[u] = v;
      }
    }
    // The arrivals: the departures of row t - m at u (blank arcs, the first
    // of which starts each cell's sum) or u - 1 (emit arcs; at a warp's
    // first column, the warp before's last one; at a pass's, the edge
    // column). The loads are unconditional: every address lies in the
    // lattice's rings. Cells beyond U read padding garbage, which a prefix
    // scan carries only into cells beyond U (masked below); the emit arcs'
    // read at u = 0 is the one word selected away. A NEG term joins exactly.
    Pair<T> p[C];
    if constexpr (kPend) {
      // The pending form reads them from row t's slot of the pending
      // window, every arc's departures joined as they were sent, and empties
      // its cells for row t + R: the lane's own, at a warp's first column
      // the warp before's entry, at a pass's the previous pass's (handed on
      // in the copied row); the pass's last column's entry goes on to the
      // next pass.
      auto arrivals = [&](T* pend) {
        T* pm = pend + st * 2 * RSP;
#pragma unroll
        for (int j = 0; j < C; ++j) {
          p[j] = Pair<T>{pm[u0 + j], pm[RSP + u0 + j]};
          pm[u0 + j] = wtt::lowest<T>();
          pm[RSP + u0 + j] = T(0);
        }
        if (s.g > 0 && lane == 0) {
          const int x = UP + s.g - 1;
          p[0] = join(Pair<T>{pm[x], pm[RSP + x]}, p[0]);
          pm[x] = wtt::lowest<T>();
          pm[RSP + x] = T(0);
        }
        if (rx) p[0] = join(Pair<T>{row[s.hbase + 2], row[s.hbase + 3]}, p[0]);
        if (tx) {
          const int x = UP + s.G - 1;
          s.hout[(Off)t * s.hw + 2] = pm[x];
          s.hout[(Off)t * s.hw + 3] = pm[RSP + x];
          pm[x] = wtt::lowest<T>();
          pm[RSP + x] = T(0);
        }
      };
      // In shared memory through a pointer the compiler sees to be shared
      // (shared-memory loads and stores, not generic ones).
      if (s.dev_ring)
        arrivals(s.ring);
      else
        arrivals(s.copy + kCopyRows * s.slot_words);
    } else {
      for_arcs(arcs.arc, n_arcs, [&](int i, const SlotArc<N>& arc) {
        const int m = arc.m;
        const bool emit = i >= arcs.n_blank;
        const T* src = s.ring + (i * R + (st - m < 0 ? st - m + R : st - m)) * RS + ro + u0 -
                       (emit ? 1 : 0);
        const bool has = t >= m, first = emit && u0 == 0 && first_pass;
#pragma unroll
        for (int j = 0; j < C; ++j) {
          const T x = has && !(j == 0 && first) ? src[j] : neg;
          p[j] = i == 0 ? Pair<T>{x, T(1)} : join(p[j], Pair<T>{x, T(1)});
        }
      });
    }
    // The plain sum starts at NEG: a sum below it is NEG.
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const bool below = p[j].m < neg;
      p[j].m = below ? neg : p[j].m;
      p[j].s = below ? T(1) : p[j].s;
    }
    if (t == 0 && first_pass) {  // the start, α(0, 0) = 0
      p[0].m = u0 == 0 ? T(0) : p[0].m;
      p[0].s = u0 == 0 ? T(1) : p[0].s;
    }
    T a[C];
    if (arcs.has_chain) {
      // Local inclusive scan of (ne - c) over the lane's cells, and the next
      // row's local chain sums.
      T incl = local_prefix<T, C>(cw, c_nxt);
      p[0].m -= c_cur[0];
      if constexpr (kWide) {  // the previous passes' carry, in this pass's frame
        if (s.hin != nullptr) {
          const Pair<T> h =
              rx ? Pair<T>{row[s.hbase], row[s.hbase + 1]} : identity<T>();
          p[0] = join(h, p[0]);
        }
      }
#pragma unroll
      for (int j = 1; j < C; ++j) {
        p[j].m -= c_cur[j];
        p[j] = join(p[j - 1], p[j]);
      }
      // The two warp scans side by side.
      Pair<T> tot = p[C - 1];
#pragma unroll
      for (int sh = 1; sh < wtt::kWarp; sh <<= 1) {
        const T oc = __shfl_up_sync(kFull, incl, sh);
        const Pair<T> o = shfl_up(tot, sh);
        const Pair<T> jn = join(o, tot);
        const bool in = lane >= sh;
        incl += in ? oc : T(0);
        tot.m = in ? jn.m : tot.m;
        tot.s = in ? jn.s : tot.s;
      }
      T ex = __shfl_up_sync(kFull, incl, 1);
      Pair<T> carry = shfl_up(tot, 1);
      ex = lane == 0 ? T(0) : ex;
      carry.m = lane == 0 ? wtt::lowest<T>() : carry.m;
      carry.s = lane == 0 ? T(0) : carry.s;
#pragma unroll
      for (int j = 0; j < C; ++j) c_nxt[j] += ex;
      tot_nxt = incl;
      if (s.G > 1) {
        // Lane 31 hands on the warp's total and the next row's chain total;
        // the warps before this one give the carry of its first lane and the
        // offset of its next row.
        const int par = t & 1;
        if (lane == wtt::kWarp - 1) {
          T* x = s.xch + (par * kMaxG + s.g) * 4;
          x[0] = tot.m;
          x[1] = tot.s;
          x[2] = incl;
        }
        lattice_barrier(s);
        carry = join(warp_totals<T, kMaxG>(s, par, 0, s.g), carry);
        const T off = chain_offset<T, kMaxG>(s, par);
#pragma unroll
        for (int j = 0; j < C; ++j) c_nxt[j] += off;
        tot_nxt += off;
      }
#pragma unroll
      for (int j = 0; j < C; ++j) a[j] = c_cur[j] + value(join(carry, p[j]));
      if constexpr (kWide) {  // the carry, moved into the next pass's frame
        if (tx) {
          const Pair<T> h = join(carry, p[C - 1]);
          s.hout[(Off)t * s.hw] = h.m + tot_cur;
          s.hout[(Off)t * s.hw + 1] = h.s;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < C; ++j) a[j] = value(p[j]);
    }
    T* stage = s.stage + (t & 1) * UP + u0;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      a[j] = u0 + j < s.Uv ? a[j] : neg;
      stage[j] = a[j];
    }
    if constexpr (kPend) {  // the departures, into the pending window
      if (s.dev_ring)
        scatter<T, C, N>(s, arcs, s.ring, row, a, t, st, lf);
      else  // through a pointer the compiler sees to be shared, as the arrivals
        scatter<T, C, N>(s, arcs, s.copy + kCopyRows * s.slot_words, row, a, t, st, lf);
    } else {
      // The departures of row t; wide, an emit arc's at the pass's last
      // column go on to the next pass, and the previous pass's become this
      // ring's column -1.
      for_arcs(arcs.arc, n_arcs, [&](int i, const SlotArc<N>& arc) {
        T w[C];
        arc_weights<T, C, N>(row, arc, u0, w);
        T* dst = s.ring + (i * R + st) * RS + ro + u0;
#pragma unroll
        for (int j = 0; j < C; ++j) dst[j] = a[j] + w[j];
        if constexpr (kWide) {
          const int e = i - arcs.n_blank;
          if (e >= 0) {
            if (tx) s.hout[(Off)t * s.hw + 2 + e] = a[C - 1] + w[C - 1];
            if (rx) dst[-1] = row[s.hbase + 2 + e];
          }
        }
      });
    }
    if (cross) lattice_barrier(s);
    st = st + 1 == R ? 0 : st + 1;
  }
  __syncwarp();
  if (s.Tv > 0) {  // the last row goes out
    const T* st_row = s.stage + ((s.Tv - 1) & 1) * UP + s.g * kP;
    T* dst = s.out + (Off)(s.Tv - 1) * ld + s.g * kP;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int u = lane + k * wtt::kWarp;
      const T v = st_row[u];
      if (s.g * kP + u < U) dst[u] = v;
    }
  }
  // ll_forward: the blank arcs that land exactly on T_b from (t, U_b - 1),
  // rows ascending, arcs in order, starting at NEG; their departures are
  // still in the rings (the last W + 1 rows), in the column's own warp (and
  // pass). The pending form summed them as it sent them.
  const bool inside = kWide ? s.Ub + s.start >= 1 && s.Ub <= s.Ur : s.Ub >= 1 && s.Ub <= U;
  if (inside) {
    if (u0 <= uf && uf < u0 + C) {
      if constexpr (!kPend) {
        for (int t = max(s.Tb - arcs.W, 0); t < s.Tv; ++t)
          for (int i = 0; i < arcs.n_blank; ++i)
            if (t + arcs.arc[i].m == s.Tb)
              lf = wtt::lse(lf, s.ring[(i * R + t % R) * RS + ro + uf]);
      }
      *llf = lf;
    }
  } else if (u0 == 0 && first_pass) {
    *llf = neg;
  }
}

// Beta over rows Tv-1 .. 0; ll_backward = β(0, 0).
template <typename T, int C, bool kWide, class Arcs = SlotArcs<Shape<kWide>::kArcCh>>
__device__ void beta_walk(const Walk<T>& s, const Arcs& arcs, T* __restrict__ llb) {
  using Sh = Shape<kWide>;
  using Off = typename Sh::Off;
  constexpr int N = Sh::kArcCh;
  constexpr int kMaxG = Sh::kMaxG;
  constexpr int kP = wtt::kWarp * C;
  constexpr bool kTab = !std::is_same<Arcs, SlotArcs<N>>::value;  // the table instance
  const T neg = T(wtt::kNeg);
  const int lane = s.lane, u0 = s.u0, U = s.U, R = s.R, UP = s.UP;
  const int ld = kWide ? s.ld : U;
  // Wide: the ring keeps column UP (the next pass's first column) after the
  // pass's columns.
  const int RS = kWide ? UP + 1 : UP;
  const int Ur = kWide ? s.Ur : U;
  const bool first_pass = !kWide || s.start == 0;
  // Wide: lane 31 of the last warp takes the next pass's rows (rx); lane 0
  // of warp 0 hands this pass's on (tx).
  const bool takes = kWide && s.hin != nullptr && s.g == s.G - 1;
  const bool rx = takes && lane == wtt::kWarp - 1;
  const bool tx = kWide && s.hout != nullptr && s.g == 0 && lane == 0;
  const int n_arcs = arcs.n_blank + arcs.n_emit;
  // With several warps and emit arcs, a second barrier a row: an emit arc
  // reads the next warp's first column of a later row.
  const bool cross = s.G > 1 && arcs.n_emit > 0;
  for (int r = 0; r < kAhead; ++r) {
    copy_row<T, C, kWide, kTab>(s, s.Tv - 1 - r, takes);
    copy_commit();
  }
  T c_cur[C], c_nxt[C];
#pragma unroll
  for (int j = 0; j < C; ++j) c_nxt[j] = T(0);
  T tot_cur = T(0), tot_nxt = T(0);  // wide: the pass's chain total (meaningful at rx)
  copy_wait<kAhead - 1>();  // row Tv - 1
  __syncwarp();
  if (arcs.has_chain && s.Tv > 0) {
    const T total = chain_prefix<T, C, N>(
        s, arcs.chain, s.copy + ((s.Tv - 1) % kCopyRows) * s.slot_words, c_nxt);
    tot_nxt = total;
    if (s.G > 1) {  // the offsets of row Tv - 1, through exchange slot 1
      if (lane == wtt::kWarp - 1) s.xch[(kMaxG + s.g) * 4 + 2] = total;
      lattice_barrier(s);
      const T off = chain_offset<T, kMaxG>(s, 1);
#pragma unroll
      for (int j = 0; j < C; ++j) c_nxt[j] += off;
      tot_nxt += off;
    }
  }
  int sr = s.Tv > 0 ? (s.Tv - 1) % R : 0;  // r mod R
  for (int r = s.Tv - 1; r >= 0; --r) {
#pragma unroll
    for (int j = 0; j < C; ++j) c_cur[j] = c_nxt[j];
    tot_cur = tot_nxt;
    copy_wait<kAhead - 2>();  // rows r and r - 1
    __syncwarp();
    copy_row<T, C, kWide, kTab>(s, r - kAhead, takes);
    copy_commit();
    const T* row = s.copy + (r % kCopyRows) * s.slot_words;
    // The chain's weights of row r - 1 (for r = 0: a slot no one uses).
    T cw[C];
    if (arcs.has_chain)
      chain_weights<T, C, N>(s, arcs.chain,
                             s.copy + ((r + kCopyRows - 1) % kCopyRows) * s.slot_words, cw);
    if (r + 1 < s.Tv) {  // row r + 1 goes out
      const T* src = s.ring + (sr + 1 == R ? 0 : sr + 1) * RS + s.g * kP;
      T* dst = s.out + (Off)(r + 1) * ld + s.g * kP;
#pragma unroll
      for (int k = 0; k < C; ++k) {
        const int u = lane + k * wtt::kWarp;
        const T v = src[u];
        if (s.g * kP + u < U) dst[u] = v;
      }
    }
    // The arrivals: each arc's weight plus beta of row r + m at u (blank)
    // or u + 1 (emit; at a warp's last column, the next warp's first one;
    // at a pass's, the edge column), NEG beyond the walked rows or the
    // lattice's last column; a blank arc that lands exactly on T_b from
    // U_b - 1 ends the path and adds its bare weight. Garbage beyond U,
    // selected away below; an emit arc's load at the last padded column
    // reads the ring's slack word.
    Pair<T> p[C];
    for_arcs(arcs.arc, n_arcs, [&](int i, const SlotArc<N>& arc) {
      const int m = arc.m;
      const bool emit = i >= arcs.n_blank;
      const bool next = r + m < s.Tv;
      const bool end = !emit && r + m == s.Tb;
      const T* src = s.ring + (sr + m >= R ? sr + m - R : sr + m) * RS + u0 + (emit ? 1 : 0);
      T w[C];
      arc_weights<T, C, N>(row, arc, u0, w);
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const int u = u0 + j;
        const T b = src[j];
        const bool ok = next && (!emit || u + 1 < Ur);
        const T x = end && u == s.Ub - 1 ? w[j] : w[j] + (ok ? b : neg);
        p[j] = i == 0 ? Pair<T>{x, T(1)} : join(p[j], Pair<T>{x, T(1)});
      }
    });
    // The plain sum starts at NEG: a sum below it is NEG. Cells beyond U
    // add nothing to the suffix scan.
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const bool below = p[j].m < neg, beyond = u0 + j >= U;
      p[j].m = beyond ? wtt::lowest<T>() : below ? neg : p[j].m;
      p[j].s = beyond ? T(0) : below ? T(1) : p[j].s;
    }
    T bv[C];
    if (arcs.has_chain) {
      // Local inclusive suffix scan of (nb + c), cells descending, and the
      // next row's local chain sums.
      T incl = local_prefix<T, C>(cw, c_nxt);
      p[C - 1].m += c_cur[C - 1];
      if constexpr (kWide) {  // the later passes' carry, moved into this pass's frame
        if (s.hin != nullptr) {
          const Pair<T> h =
              rx ? Pair<T>{row[s.hbase] + tot_cur, row[s.hbase + 1]} : identity<T>();
          p[C - 1] = join(p[C - 1], h);
        }
      }
#pragma unroll
      for (int j = C - 2; j >= 0; --j) {
        p[j].m += c_cur[j];
        p[j] = join(p[j + 1], p[j]);
      }
      // The two warp scans side by side: the chain's up, beta's down.
      Pair<T> tot = p[0];
#pragma unroll
      for (int sh = 1; sh < wtt::kWarp; sh <<= 1) {
        const T oc = __shfl_up_sync(kFull, incl, sh);
        const Pair<T> o = shfl_down(tot, sh);
        const Pair<T> jn = join(o, tot);
        const bool in = lane + sh < wtt::kWarp;
        incl += lane >= sh ? oc : T(0);
        tot.m = in ? jn.m : tot.m;
        tot.s = in ? jn.s : tot.s;
      }
      T ex = __shfl_up_sync(kFull, incl, 1);
      Pair<T> carry = shfl_down(tot, 1);
      ex = lane == 0 ? T(0) : ex;
      carry.m = lane == wtt::kWarp - 1 ? wtt::lowest<T>() : carry.m;
      carry.s = lane == wtt::kWarp - 1 ? T(0) : carry.s;
#pragma unroll
      for (int j = 0; j < C; ++j) c_nxt[j] += ex;
      tot_nxt = incl;
      if (s.G > 1) {
        // Lane 0 hands on the warp's total and lane 31 the next row's chain
        // total; the warps after this one give the carry of its last lane.
        const int par = (s.Tv - 1 - r) & 1;  // the first row's slot is 0
        if (lane == 0) {
          T* xo = s.xch + (par * kMaxG + s.g) * 4;
          xo[0] = tot.m;
          xo[1] = tot.s;
        }
        if (lane == wtt::kWarp - 1) s.xch[(par * kMaxG + s.g) * 4 + 2] = incl;
        lattice_barrier(s);
        carry = join(warp_totals<T, kMaxG>(s, par, s.g + 1, s.G), carry);
        const T off = chain_offset<T, kMaxG>(s, par);
#pragma unroll
        for (int j = 0; j < C; ++j) c_nxt[j] += off;
        tot_nxt += off;
      }
#pragma unroll
      for (int j = 0; j < C; ++j) bv[j] = value(join(carry, p[j])) - c_cur[j];
      if constexpr (kWide) {  // the carry, in this pass's frame
        if (tx) {
          const Pair<T> h = join(carry, p[0]);
          s.hout[(Off)r * s.hw] = h.m;
          s.hout[(Off)r * s.hw + 1] = h.s;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < C; ++j) bv[j] = value(p[j]);
    }
    T* dst = s.ring + sr * RS + u0;
#pragma unroll
    for (int j = 0; j < C; ++j) dst[j] = u0 + j < s.Uv ? bv[j] : neg;
    if constexpr (kWide) {  // the edge column: β at the next pass's first column
      if (tx) s.hout[(Off)r * s.hw + 2] = u0 < s.Uv ? bv[0] : neg;
      if (rx) s.ring[sr * RS + UP] = row[s.hbase + 2];
    }
    if (cross) lattice_barrier(s);
    sr = sr == 0 ? R - 1 : sr - 1;
  }
  __syncwarp();
  if (s.Tv > 0) {  // row 0 goes out
    const T* src = s.ring + s.g * kP;
    T* dst = s.out + s.g * kP;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int u = lane + k * wtt::kWarp;
      const T v = src[u];
      if (s.g * kP + u < U) dst[u] = v;
    }
  }
  if (u0 == 0 && first_pass) *llb = s.Tv > 0 ? s.ring[0] : neg;
}

// Grid: a block of `per_block` lattices of G warps each; lattice i is
// utterance i / dirs, alpha (i % dirs == 0) or beta; each walks in its own
// slice of `lattice_words` values of shared memory. Wide: `passes` passes
// of P = 32·G·C columns each, `hand` the device memory they hand rows on
// through (two buffers of Tmax rows of `hw` values a lattice, or null with
// one pass).
template <typename T, int C, bool kWide>
__global__ void __launch_bounds__(block_threads<T, C, kWide>(), 1)
    window_warp_kernel(const T* __restrict__ lpb, const T* __restrict__ lpe,
                       const T* __restrict__ extra, int Cx,
                       const __grid_constant__ SlotArcs<Shape<kWide>::kArcCh> arcs,
                       const int* __restrict__ input_lengths,
                       const int* __restrict__ label_lengths, T* __restrict__ alphas,
                       T* __restrict__ betas, T* __restrict__ ll_forward,
                       T* __restrict__ ll_backward, int B, int Tmax, int U, int dirs, int G,
                       int per_block, int lattice_words, int passes, T* hand) {
  using Sh = Shape<kWide>;
  using Off = typename Sh::Off;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x / wtt::kWarp;
  const int slot = warp / G;
  const int lattice = blockIdx.x * per_block + slot;
  if (lattice >= B * dirs) return;  // every warp of the lattice
  const int b = lattice / dirs;
  const bool is_beta = lattice % dirs == 1;
  const int R = arcs.W + 1;
  const int n_arcs = arcs.n_blank + arcs.n_emit;
  Walk<T> s;
  s.lane = threadIdx.x % wtt::kWarp;
  s.g = warp % G;
  s.G = G;
  s.bar = 1 + slot;
  s.Tb = input_lengths[b];
  const int Ub = label_lengths[b] + 1;
  s.Tv = min(max(s.Tb, 0), Tmax);
  s.Cx = Cx;
  s.R = R;
  s.UP = G * wtt::kWarp * C;
  s.hw = kWide ? 2 + n_arcs : 0;
  s.hbase = (2 + Cx) * s.UP + kRowPad;
  s.slot_words = s.hbase + s.hw;
  s.u0 = s.g * wtt::kWarp * C + s.lane * C;
  const long long base = (long long)b * Tmax * U;
  T* mine = reinterpret_cast<T*>(smem_raw) + (size_t)slot * lattice_words;
  s.copy = mine;
  s.ring = mine + kCopyRows * s.slot_words;
  if (s.lane < kCopyRows) s.copy[s.lane * s.slot_words + (2 + Cx) * s.UP] = T(0);
  __syncwarp();
  s.stage = s.ring + n_arcs * R * (s.UP + (kWide ? 1 : 0));
  s.xch = mine + lattice_words - Sh::kXchWords;
  s.ld = U;
  const T neg = T(wtt::kNeg);
  const int P = wtt::kWarp * C;
  T* const hand_mine = kWide && passes > 1 ? hand + (long long)lattice * 2 * Tmax * s.hw : nullptr;
  for (int q = 0; q < (kWide ? passes : 1); ++q) {
    // The pass: alpha's left to right, beta's right to left; the narrow
    // instance's one pass holds every column (constants, so that its walk
    // compiles as it did before the passes).
    const int k = kWide ? (is_beta ? passes - 1 - q : q) : 0;
    s.start = k * s.UP;
    s.U = kWide ? min(s.UP, U - s.start) : U;
    s.Ur = U - s.start;
    s.Ub = Ub - s.start;
    s.Uv = min(max(s.Ub, 0), s.U);
    s.pb = lpb + base + s.start;
    s.pe = lpe + base + s.start;
    s.px = extra + (base + s.start) * Cx;
    s.out = (is_beta ? betas : alphas) + base + s.start;
    s.hin = q > 0 ? hand_mine + (long long)((q - 1) & 1) * Tmax * s.hw : nullptr;
    s.hout = q + 1 < passes ? hand_mine + (long long)(q & 1) * Tmax * s.hw : nullptr;
    if (is_beta)
      beta_walk<T, C, kWide>(s, arcs, ll_backward + b);
    else
      alpha_walk<T, C, kWide>(s, arcs, ll_forward + b);
    // The rows beyond T_b, coalesced, each warp its columns.
    for (int t = s.Tv; t < Tmax; ++t) {
#pragma unroll
      for (int kk = 0; kk < C; ++kk) {
        const int u = s.g * P + s.lane + kk * wtt::kWarp;
        if (u < s.U) s.out[(Off)t * U + u] = neg;
      }
    }
    if constexpr (kWide) {  // the next pass reuses the shared memory and reads the rows handed on
      if (q + 1 < passes) {
        __threadfence_block();
        __syncwarp();
        lattice_barrier(s);
      }
    }
  }
}

// The table instance: the wide walk (G up to 16, three-channel arcs, 64-bit
// offsets, passes) over arcs of any number and channels of any count, in
// its rings form or (kPend) its pending form. The arc table comes from
// device memory (`table`: rows of five ints, the chain first, then the
// n_blank blank arcs, then the n_emit emit arcs; then, which the pending
// form reads, the same arcs sorted by (m, blank before emit, table order)
// and one row (m, first, n_blank, n, 0) for each of the n_groups groups of
// one m), copied into the block's shared memory after its lattices' slices
// as the block starts and read there in the walk's loops. The rings form's
// alpha keeps a ring of departures for each arc, the pending form's one
// pending window of arrivals (its size does not depend on the number of
// arcs); beta keeps its ring of W + 1 rows. Where they do not fit a block
// (`rings` not null) they lie in device memory, `ring_words` values a
// lattice, and the lattice's shared memory keeps its copy ring, staged rows
// and exchange: the walk reads and writes them through the same pointers,
// ordered by the same __syncwarp and barriers. The passes hand on 2 +
// n_arcs values a row (the rings form, as the wide instance) or kPendHand:
// the chain's carry and the pre-joined emit arrivals of the next pass's
// first column (beta: the carry and its edge column).
template <typename T, int C, bool kPend>
__global__ void __launch_bounds__(kTableWarps * wtt::kWarp, 1)
    window_table_kernel(const T* __restrict__ lpb, const T* __restrict__ lpe,
                        const T* __restrict__ extra, int Cx, const int* __restrict__ table,
                        int n_blank, int n_emit, int n_groups, int W,
                        const int* __restrict__ input_lengths,
                        const int* __restrict__ label_lengths, T* __restrict__ alphas,
                        T* __restrict__ betas, T* __restrict__ ll_forward,
                        T* __restrict__ ll_backward, int B, int Tmax, int U, int dirs, int G,
                        int per_block, int lattice_words, int passes, T* hand, T* rings,
                        long long ring_words) {
  using Sh = Shape<true>;
  using Off = typename Sh::Off;
  constexpr int N = Sh::kArcCh;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n_arcs = n_blank + n_emit;
  const int UP = G * wtt::kWarp * C;
  // After the lattices' slices: the arcs in table order (the chain first);
  // the pending form's sorted arcs and groups after them.
  SlotArc<N>* sarc = reinterpret_cast<SlotArc<N>*>(
      smem_raw + (size_t)per_block * lattice_words * sizeof(T));
  SlotArc<N>* sorted = sarc + n_arcs + 1;
  Group* group = reinterpret_cast<Group*>(sorted + n_arcs);
  for (int i = threadIdx.x; i <= n_arcs; i += blockDim.x)
    sarc[i] = table_arc<N>(table + 5 * i, UP, Cx);
  if constexpr (kPend) {
    for (int i = threadIdx.x; i < n_arcs; i += blockDim.x)
      sorted[i] = table_arc<N>(table + 5 * (1 + n_arcs + i), UP, Cx);
    for (int k = threadIdx.x; k < n_groups; k += blockDim.x) {
      const int* row = table + 5 * (1 + 2 * n_arcs + k);
      group[k] = Group{row[0], row[1], row[2], row[3]};
    }
  }
  __syncthreads();  // the only block barrier: every thread is here
  const int warp = threadIdx.x / wtt::kWarp;
  const int slot = warp / G;
  const int lattice = blockIdx.x * per_block + slot;
  if (lattice >= B * dirs) return;  // every warp of the lattice
  const TableArcs<N, kPend> arcs{W,        table[1] != 0, n_blank, n_emit, sarc[0],
                                 sarc + 1, sorted,        group,   n_groups};
  const int b = lattice / dirs;
  const bool is_beta = lattice % dirs == 1;
  const int R = W + 1;
  Walk<T> s;
  s.lane = threadIdx.x % wtt::kWarp;
  s.g = warp % G;
  s.G = G;
  s.bar = 1 + slot;
  s.Tb = input_lengths[b];
  const int Ub = label_lengths[b] + 1;
  s.Tv = min(max(s.Tb, 0), Tmax);
  s.Cx = Cx;
  s.R = R;
  s.UP = UP;
  s.hw = kPend ? kPendHand : 2 + n_arcs;
  s.hbase = (2 + Cx) * s.UP + kRowPad;
  s.slot_words = s.hbase + s.hw;
  s.u0 = s.g * wtt::kWarp * C + s.lane * C;
  const long long base = (long long)b * Tmax * U;
  T* mine = reinterpret_cast<T*>(smem_raw) + (size_t)slot * lattice_words;
  s.copy = mine;
  if (s.lane < kCopyRows) s.copy[s.lane * s.slot_words + (2 + Cx) * s.UP] = T(0);
  __syncwarp();
  T* after_copy = mine + kCopyRows * s.slot_words;
  // Alpha: its rings (n_arcs × R rows of UP + 1) or its pending window (R
  // slots of 2·(UP + G) values), and two staged rows; beta: its ring of R
  // rows of UP + 1 and the slack.
  s.dev_ring = rings != nullptr;
  if (s.dev_ring) {
    s.ring = rings + (long long)lattice * ring_words;
    s.stage = after_copy;
  } else {
    s.ring = after_copy;
    s.stage = s.ring + (kPend ? 2 * R * (s.UP + G) : n_arcs * R * (s.UP + 1));
  }
  s.xch = mine + lattice_words - Sh::kXchWords;
  s.ld = U;
  const T neg = T(wtt::kNeg);
  const int P = wtt::kWarp * C;
  T* const hand_mine = passes > 1 ? hand + (long long)lattice * 2 * Tmax * s.hw : nullptr;
  for (int q = 0; q < passes; ++q) {
    // The pass: alpha's left to right, beta's right to left.
    const int k = is_beta ? passes - 1 - q : q;
    s.start = k * s.UP;
    s.U = min(s.UP, U - s.start);
    s.Ur = U - s.start;
    s.Ub = Ub - s.start;
    s.Uv = min(max(s.Ub, 0), s.U);
    s.pb = lpb + base + s.start;
    s.pe = lpe + base + s.start;
    s.px = extra + (base + s.start) * Cx;
    s.out = (is_beta ? betas : alphas) + base + s.start;
    s.hin = q > 0 ? hand_mine + (long long)((q - 1) & 1) * Tmax * s.hw : nullptr;
    s.hout = q + 1 < passes ? hand_mine + (long long)(q & 1) * Tmax * s.hw : nullptr;
    if (is_beta)
      beta_walk<T, C, true, TableArcs<N, kPend>>(s, arcs, ll_backward + b);
    else
      alpha_walk<T, C, true, TableArcs<N, kPend>>(s, arcs, ll_forward + b);
    // The rows beyond T_b, coalesced, each warp its columns.
    for (int t = s.Tv; t < Tmax; ++t) {
#pragma unroll
      for (int kk = 0; kk < C; ++kk) {
        const int u = s.g * P + s.lane + kk * wtt::kWarp;
        if (u < s.U) s.out[(Off)t * U + u] = neg;
      }
    }
    if (q + 1 < passes) {  // the next pass reuses the rings and reads the rows handed on
      __threadfence_block();
      __syncwarp();
      lattice_barrier(s);
    }
  }
}

// The kernel instance of C cells a lane: C = C0, C0 + 2, ... up to kMax.
template <typename T, int C, int kMax, bool kWide>
const void* warp_kernel_of(int cells) {
  if (cells == C) return reinterpret_cast<const void*>(window_warp_kernel<T, C, kWide>);
  if constexpr (C + 2 <= kMax) return warp_kernel_of<T, C + 2, kMax, kWide>(cells);
  return nullptr;
}
template <typename T, int C, int kMax, bool kPend>
const void* table_kernel_of(int cells) {
  if (cells == C) return reinterpret_cast<const void*>(window_table_kernel<T, C, kPend>);
  if constexpr (C + 2 <= kMax) return table_kernel_of<T, C + 2, kMax, kPend>(cells);
  return nullptr;
}

}  // namespace

namespace wtt_window {
// The wide instance of `cells` cells a lane for `elt`-byte values, or null
// (window_stream_wide.cu).
const void* wide_kernel(int elt, int cells);
// The table instance's rings form of `cells` cells a lane, or null
// (window_stream_table.cu).
const void* table_kernel(int elt, int cells);
// Its pending form, or null (window_stream_pending.cu).
const void* pending_kernel(int elt, int cells);
}  // namespace wtt_window
