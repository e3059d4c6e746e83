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
//   G is 4 or 2 where a chain is solved, U is long and the lattices are few
//   (long_t: 32 lattices, G = 4, C = 3), else 1.
// * The chain's log-sum-exp scan of a row is a local scan of the lane's C
//   cells as (max, sum) pairs, one 5-step __shfl_up_sync (alpha) /
//   __shfl_down_sync (beta) scan of the lane totals, one shuffle for the
//   exclusive carry and a fix-up of each cell, independent across cells. A
//   pair (m, s) stands for m + log(s); joining two costs one exp, and a cell
//   takes one log at the end. With G > 1 the warps of a lattice trade their
//   row totals through shared memory behind one named barrier a row
//   (bar.sync id, 32·G), and a second where emit arcs cross a warp's edge.
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
// Above max_cells (f32 U > 544, f64 U > 288 with one warp), where a
// lattice's rings do not fit a block (many arcs, W large), or for an arc of
// three channels, the earlier design takes over: window_block_kernel, a
// block per lattice and direction, a thread a column, two block-wide scans
// a row. The plan (warps a lattice, cells a lane, lattices a block, shared
// memory, the switch) is `plan` below, mirrored by ops/cuda/window.py::plan;
// wtt_window_plan lets a card test hold the two equal, and
// tests/test_torch_window_plan.py replays the warp kernel's schedule in
// numpy on the CPU.
//
// No atomics: two calls give the same bits.
#include <climits>

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 512;
constexpr int kMaxArcs = 9;         // the standard blank and eight big blanks
constexpr int kMaxArcChannels = 3;  // an arc sums at most three channels
constexpr int kMaxChannels = 10;    // lpb, lpe and eight extra channels
// Row-chain sentinel of the prefix sums (ops/band.py::CLAMP).
constexpr double kClamp = -1.0e4;

// The warp kernel: rows of channels copied kAhead rows ahead into a ring of
// kCopyRows; at most kMaxWarps warps (lattices) a block.
constexpr int kAhead = 3;
constexpr int kCopyRows = kAhead + 1;
constexpr int kMaxWarps = 8;
constexpr int kSmemMax = 232448;  // a block's shared memory on sm_90
constexpr int max_cells(int elt) { return elt == 4 ? 17 : 9; }
// Values after beta's ring that an emit arc's load at the last padded column
// may touch (its value is selected away).
constexpr int kSlack = 32;
// Warps a lattice, at most; the exchange of a lattice's warps: two slots
// (row parity) of kMaxG warps' (total m, total s, chain total, unused).
constexpr int kMaxG = 4;
constexpr int kXchWords = 2 * kMaxG * 4;

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

// An arc as the warp kernel reads it: channel k of cell u lies at word
// base[k] + u·stride[k] of a copied row. The warp kernel takes arcs of one
// or two channels (those of the multi-blank and TDT lattices; an arc table
// with a three-channel arc takes the block kernel); an arc of one channel
// points the other at the row's zero word (stride 0), so that its weight is
// always two loads and an add, with no branch between them.
constexpr int kWarpArcChannels = 2;
struct SlotArc {
  int m, n;
  int base[kWarpArcChannels];
  int stride[kWarpArcChannels];
};
// Words after a copied row's channels; the first holds 0.
constexpr int kRowPad = 4;

struct SlotArcs {
  int W, has_chain, n_blank, n_emit;
  SlotArc chain;
  SlotArc arc[2 * kMaxArcs];  // the blank arcs, then the emit arcs
};

// max(x, kClamp) that keeps a NaN, as torch.clamp_min does.
template <typename T>
__device__ __forceinline__ T clamp_chain(T x) {
  return x < T(kClamp) ? T(kClamp) : x;
}

// ---------------------------------------------------------------------------
// The warp kernel.

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
// cells from u0 = g·P + l·C.
template <typename T>
struct Walk {
  const T* pb;  // the utterance's lpb, lpe (T, U) and extra (T, U, Cx)
  const T* pe;
  const T* px;
  T* out;       // its alphas or betas
  T* copy;      // [kCopyRows][slot_words]: rows of lpb, lpe (UP each), extra (UP·Cx)
  T* ring;      // alpha: [n_arcs][R][UP] departures; beta: [R][UP] rows of beta
  T* stage;     // alpha: [2][UP], rows on their way out
  T* xch;       // [2][kMaxG][4]: each warp's row total (m, s) and chain total
  int Tv, Uv, Tb, Ub, U, Cx, R, UP, slot_words, lane, g, G, bar, u0;
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
// with the bounds checks at the tensors' ends, made a row slower.)
template <typename T, int C>
__device__ __forceinline__ void copy_row(const Walk<T>& s, int r) {
  if (!in_rows(r, s.Tv)) return;
  constexpr int kP = wtt::kWarp * C;
  const unsigned dst = smem_addr(s.copy + (r % kCopyRows) * s.slot_words);
  const T* pb = s.pb + r * s.U;
  const T* pe = s.pe + r * s.U;
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
  const T* px = s.px + r * s.U * s.Cx;
#pragma unroll 4
  for (int w = first * s.Cx + s.lane; w < end; w += wtt::kWarp)
    copy_async(dst + (2 * s.UP + w) * sizeof(T), px + w);
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
template <typename T, int C>
__device__ __forceinline__ void arc_weights(const T* row, const SlotArc& a, int u0, T (&w)[C]) {
#pragma unroll
  for (int k = 0; k < kWarpArcChannels; ++k) {
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
template <typename F>
__device__ __forceinline__ void for_arcs(const SlotArc* arc, int n, F&& f) {
  f(0, arc[0]);
#pragma unroll 1
  for (int i = 1; i < n; ++i) f(i, arc[i]);
}

// The chain's weights of a copied row at the lane's cells, clamped at the
// chain's sentinel; 0 beyond U.
template <typename T, int C>
__device__ __forceinline__ void chain_weights(const Walk<T>& s, const SlotArc& chain,
                                              const T* row, T (&w)[C]) {
  arc_weights<T, C>(row, chain, s.u0, w);
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
template <typename T, int C>
__device__ __forceinline__ T chain_prefix(const Walk<T>& s, const SlotArc& chain, const T* row,
                                          T (&c)[C]) {
  T w[C];
  chain_weights<T, C>(s, chain, row, w);
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
template <typename T>
__device__ __forceinline__ T chain_offset(const Walk<T>& s, int par) {
  T off = T(0);
#pragma unroll
  for (int g = 0; g < kMaxG - 1; ++g)
    if (g < s.g) off += s.xch[(par * kMaxG + g) * 4 + 2];
  return off;
}

// The join of the row totals that the warps `lo` … `hi` - 1 published in
// exchange slot `par`, in warp order.
template <typename T>
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

// Alpha over rows 0 .. Tv-1; ll_forward from the departures of the
// terminal blank arcs.
template <typename T, int C>
__device__ void alpha_walk(const Walk<T>& s, const SlotArcs& arcs, T* __restrict__ llf) {
  constexpr int kP = wtt::kWarp * C;
  const T neg = T(wtt::kNeg);
  const int lane = s.lane, u0 = s.u0, U = s.U, R = s.R, UP = s.UP;
  const int n_arcs = arcs.n_blank + arcs.n_emit;
  // With several warps and emit arcs, a second barrier a row: an emit arc
  // reads the previous warp's last column of an earlier row.
  const bool cross = s.G > 1 && arcs.n_emit > 0;
  for (int r = 0; r < kAhead; ++r) {
    copy_row<T, C>(s, r);
    copy_commit();
  }
  T c_cur[C], c_nxt[C];
#pragma unroll
  for (int j = 0; j < C; ++j) c_nxt[j] = T(0);
  copy_wait<kAhead - 1>();  // row 0
  __syncwarp();
  if (arcs.has_chain && s.Tv > 0) {
    const T total = chain_prefix<T, C>(s, arcs.chain, s.copy, c_nxt);
    if (s.G > 1) {  // the offsets of row 0, through exchange slot 1
      if (lane == wtt::kWarp - 1) s.xch[(kMaxG + s.g) * 4 + 2] = total;
      lattice_barrier(s);
      const T off = chain_offset(s, 1);
#pragma unroll
      for (int j = 0; j < C; ++j) c_nxt[j] += off;
    }
  }
  int st = 0;  // t mod R
  for (int t = 0; t < s.Tv; ++t) {
#pragma unroll
    for (int j = 0; j < C; ++j) c_cur[j] = c_nxt[j];
    copy_wait<kAhead - 2>();  // rows t and t + 1
    __syncwarp();             // every lane's copies and the rings' last row
    copy_row<T, C>(s, t + kAhead);
    copy_commit();
    const T* row = s.copy + (t % kCopyRows) * s.slot_words;
    // The chain's weights of row t + 1, for its prefix, scanned below beside
    // this row's log-sum-exp (after the last row: a slot no one uses).
    T cw[C];
    if (arcs.has_chain) chain_weights<T, C>(s, arcs.chain, s.copy + ((t + 1) % kCopyRows) *
                                                             s.slot_words, cw);
    if (t > 0) {  // row t - 1 goes out
      const T* st_row = s.stage + ((t - 1) & 1) * UP + s.g * kP;
      T* dst = s.out + (t - 1) * U + s.g * kP;
#pragma unroll
      for (int k = 0; k < C; ++k) {
        const int u = lane + k * wtt::kWarp;
        const T v = st_row[u];
        if (s.g * kP + u < U) dst[u] = v;
      }
    }
    // The arrivals: the departures of row t - m at u (blank arcs, the first
    // of which starts each cell's sum) or u - 1 (emit arcs; at a warp's
    // first column, the warp before's last one). The loads are
    // unconditional: every address lies in the lattice's rings. Cells beyond
    // U read padding garbage, which a prefix scan carries only into cells
    // beyond U (masked below); the emit arcs' read at u = 0 is the one word
    // selected away. A NEG term joins exactly.
    Pair<T> p[C];
    for_arcs(arcs.arc, n_arcs, [&](int i, const SlotArc& arc) {
      const int m = arc.m;
      const bool emit = i >= arcs.n_blank;
      const T* src = s.ring + (i * R + (st - m < 0 ? st - m + R : st - m)) * UP + u0 -
                     (emit ? 1 : 0);
      const bool has = t >= m, first = emit && u0 == 0;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const T x = has && !(j == 0 && first) ? src[j] : neg;
        p[j] = i == 0 ? Pair<T>{x, T(1)} : join(p[j], Pair<T>{x, T(1)});
      }
    });
    // The plain sum starts at NEG: a sum below it is NEG.
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const bool below = p[j].m < neg;
      p[j].m = below ? neg : p[j].m;
      p[j].s = below ? T(1) : p[j].s;
    }
    if (t == 0) {  // the start, α(0, 0) = 0
      p[0].m = u0 == 0 ? T(0) : p[0].m;
      p[0].s = u0 == 0 ? T(1) : p[0].s;
    }
    T a[C];
    if (arcs.has_chain) {
      // Local inclusive scan of (ne - c) over the lane's cells, and the next
      // row's local chain sums.
      T incl = local_prefix<T, C>(cw, c_nxt);
      p[0].m -= c_cur[0];
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
        carry = join(warp_totals(s, par, 0, s.g), carry);
        const T off = chain_offset(s, par);
#pragma unroll
        for (int j = 0; j < C; ++j) c_nxt[j] += off;
      }
#pragma unroll
      for (int j = 0; j < C; ++j) a[j] = c_cur[j] + value(join(carry, p[j]));
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
    // The departures of row t.
    for_arcs(arcs.arc, n_arcs, [&](int i, const SlotArc& arc) {
      T w[C];
      arc_weights<T, C>(row, arc, u0, w);
      T* dst = s.ring + (i * R + st) * UP + u0;
#pragma unroll
      for (int j = 0; j < C; ++j) dst[j] = a[j] + w[j];
    });
    if (cross) lattice_barrier(s);
    st = st + 1 == R ? 0 : st + 1;
  }
  __syncwarp();
  if (s.Tv > 0) {  // the last row goes out
    const T* st_row = s.stage + ((s.Tv - 1) & 1) * UP + s.g * kP;
    T* dst = s.out + (s.Tv - 1) * U + s.g * kP;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int u = lane + k * wtt::kWarp;
      const T v = st_row[u];
      if (s.g * kP + u < U) dst[u] = v;
    }
  }
  // ll_forward: the blank arcs that land exactly on T_b from (t, U_b - 1),
  // rows ascending, arcs in order, starting at NEG; their departures are
  // still in the rings (the last W + 1 rows), in the column's own warp.
  const int uf = s.Ub - 1;
  if (s.Ub >= 1 && s.Ub <= U) {
    if (u0 <= uf && uf < u0 + C) {
      T l = neg;
      for (int t = max(s.Tb - arcs.W, 0); t < s.Tv; ++t)
        for (int i = 0; i < arcs.n_blank; ++i)
          if (t + arcs.arc[i].m == s.Tb) l = wtt::lse(l, s.ring[(i * R + t % R) * UP + uf]);
      *llf = l;
    }
  } else if (u0 == 0) {
    *llf = neg;
  }
}

// Beta over rows Tv-1 .. 0; ll_backward = β(0, 0).
template <typename T, int C>
__device__ void beta_walk(const Walk<T>& s, const SlotArcs& arcs, T* __restrict__ llb) {
  constexpr int kP = wtt::kWarp * C;
  const T neg = T(wtt::kNeg);
  const int lane = s.lane, u0 = s.u0, U = s.U, R = s.R, UP = s.UP;
  const int n_arcs = arcs.n_blank + arcs.n_emit;
  // With several warps and emit arcs, a second barrier a row: an emit arc
  // reads the next warp's first column of a later row.
  const bool cross = s.G > 1 && arcs.n_emit > 0;
  for (int r = 0; r < kAhead; ++r) {
    copy_row<T, C>(s, s.Tv - 1 - r);
    copy_commit();
  }
  T c_cur[C], c_nxt[C];
#pragma unroll
  for (int j = 0; j < C; ++j) c_nxt[j] = T(0);
  copy_wait<kAhead - 1>();  // row Tv - 1
  __syncwarp();
  if (arcs.has_chain && s.Tv > 0) {
    const T total = chain_prefix<T, C>(s, arcs.chain,
                                       s.copy + ((s.Tv - 1) % kCopyRows) * s.slot_words, c_nxt);
    if (s.G > 1) {  // the offsets of row Tv - 1, through exchange slot 1
      if (lane == wtt::kWarp - 1) s.xch[(kMaxG + s.g) * 4 + 2] = total;
      lattice_barrier(s);
      const T off = chain_offset(s, 1);
#pragma unroll
      for (int j = 0; j < C; ++j) c_nxt[j] += off;
    }
  }
  int sr = s.Tv > 0 ? (s.Tv - 1) % R : 0;  // r mod R
  for (int r = s.Tv - 1; r >= 0; --r) {
#pragma unroll
    for (int j = 0; j < C; ++j) c_cur[j] = c_nxt[j];
    copy_wait<kAhead - 2>();  // rows r and r - 1
    __syncwarp();
    copy_row<T, C>(s, r - kAhead);
    copy_commit();
    const T* row = s.copy + (r % kCopyRows) * s.slot_words;
    // The chain's weights of row r - 1 (for r = 0: a slot no one uses).
    T cw[C];
    if (arcs.has_chain)
      chain_weights<T, C>(s, arcs.chain, s.copy + ((r + kCopyRows - 1) % kCopyRows) *
                                                      s.slot_words, cw);
    if (r + 1 < s.Tv) {  // row r + 1 goes out
      const T* src = s.ring + (sr + 1 == R ? 0 : sr + 1) * UP + s.g * kP;
      T* dst = s.out + (r + 1) * U + s.g * kP;
#pragma unroll
      for (int k = 0; k < C; ++k) {
        const int u = lane + k * wtt::kWarp;
        const T v = src[u];
        if (s.g * kP + u < U) dst[u] = v;
      }
    }
    // The arrivals: each arc's weight plus beta of row r + m at u (blank)
    // or u + 1 (emit; at a warp's last column, the next warp's first one),
    // NEG beyond the walked rows or the last column; a blank arc that lands
    // exactly on T_b from U_b - 1 ends the path and adds its bare weight.
    // Garbage beyond U, selected away below; an emit arc's load at the last
    // padded column reads the ring's slack word.
    Pair<T> p[C];
    for_arcs(arcs.arc, n_arcs, [&](int i, const SlotArc& arc) {
      const int m = arc.m;
      const bool emit = i >= arcs.n_blank;
      const bool next = r + m < s.Tv;
      const bool end = !emit && r + m == s.Tb;
      const T* src = s.ring + (sr + m >= R ? sr + m - R : sr + m) * UP + u0 + (emit ? 1 : 0);
      T w[C];
      arc_weights<T, C>(row, arc, u0, w);
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const int u = u0 + j;
        const T b = src[j];
        const bool ok = next && (!emit || u + 1 < U);
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
        carry = join(warp_totals(s, par, s.g + 1, s.G), carry);
        const T off = chain_offset(s, par);
#pragma unroll
        for (int j = 0; j < C; ++j) c_nxt[j] += off;
      }
#pragma unroll
      for (int j = 0; j < C; ++j) bv[j] = value(join(carry, p[j])) - c_cur[j];
    } else {
#pragma unroll
      for (int j = 0; j < C; ++j) bv[j] = value(p[j]);
    }
    T* dst = s.ring + sr * UP + u0;
#pragma unroll
    for (int j = 0; j < C; ++j) dst[j] = u0 + j < s.Uv ? bv[j] : neg;
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
  if (u0 == 0) *llb = s.Tv > 0 ? s.ring[0] : neg;
}

// Grid: a block of `per_block` lattices of G warps each; lattice i is
// utterance i / dirs, alpha (i % dirs == 0) or beta; each walks in its own
// slice of `lattice_words` values of shared memory.
template <typename T, int C>
__global__ void __launch_bounds__(kMaxWarps * wtt::kWarp, 1)
    window_warp_kernel(const T* __restrict__ lpb, const T* __restrict__ lpe,
                       const T* __restrict__ extra, int Cx, const __grid_constant__ SlotArcs arcs,
                       const int* __restrict__ input_lengths,
                       const int* __restrict__ label_lengths, T* __restrict__ alphas,
                       T* __restrict__ betas, T* __restrict__ ll_forward,
                       T* __restrict__ ll_backward, int B, int Tmax, int U, int dirs, int G,
                       int per_block, int lattice_words) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x / wtt::kWarp;
  const int slot = warp / G;
  const int lattice = blockIdx.x * per_block + slot;
  if (lattice >= B * dirs) return;  // every warp of the lattice
  const int b = lattice / dirs;
  const bool is_beta = lattice % dirs == 1;
  const int R = arcs.W + 1;
  Walk<T> s;
  s.lane = threadIdx.x % wtt::kWarp;
  s.g = warp % G;
  s.G = G;
  s.bar = 1 + slot;
  s.Tb = input_lengths[b];
  s.Ub = label_lengths[b] + 1;
  s.Tv = min(max(s.Tb, 0), Tmax);
  s.Uv = min(max(s.Ub, 0), U);
  s.U = U;
  s.Cx = Cx;
  s.R = R;
  s.UP = G * wtt::kWarp * C;
  s.slot_words = (2 + Cx) * s.UP + kRowPad;
  s.u0 = s.g * wtt::kWarp * C + s.lane * C;
  const long long base = (long long)b * Tmax * U;
  s.pb = lpb + base;
  s.pe = lpe + base;
  s.px = extra + base * Cx;
  s.out = (is_beta ? betas : alphas) + base;
  T* mine = reinterpret_cast<T*>(smem_raw) + (size_t)slot * lattice_words;
  s.copy = mine;
  s.ring = mine + kCopyRows * s.slot_words;
  if (s.lane < kCopyRows) s.copy[s.lane * s.slot_words + s.slot_words - kRowPad] = T(0);
  __syncwarp();
  s.stage = s.ring + (arcs.n_blank + arcs.n_emit) * R * s.UP;
  s.xch = mine + lattice_words - kXchWords;
  if (is_beta)
    beta_walk<T, C>(s, arcs, ll_backward + b);
  else
    alpha_walk<T, C>(s, arcs, ll_forward + b);
  // The rows beyond T_b, coalesced, each warp its columns.
  const T neg = T(wtt::kNeg);
  const int P = wtt::kWarp * C;
  for (int t = s.Tv; t < Tmax; ++t) {
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int u = s.g * P + s.lane + k * wtt::kWarp;
      if (u < U) s.out[t * U + u] = neg;
    }
  }
}

// ---------------------------------------------------------------------------
// The block kernel (above the warp kernel's cap): a block per lattice and
// direction, thread i owns u = i, i + blockDim, ...; every ring column is
// read and written by its own thread, except that an emit arc moves one u:
// in alpha thread u adds it to column u+1 of the ring, in a phase of its
// own between two barriers; in beta thread u reads the ring at u+1, and the
// row's write waits behind a barrier. The alpha slot of row t is cleared
// before the arcs of row t are sent: an arc with m = W lands on row t+W,
// which is the same slot. Each row is two block-wide scans (a barrier
// each). Shared memory: (W + 1)·U values and 192 scan totals.

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
window_block_kernel(const T* __restrict__ lpb, const T* __restrict__ lpe, const T* __restrict__ extra,
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
int launch_block(const void* lpb, const void* lpe, const void* extra, int C, const WindowArcs& arcs,
           const int* input_lengths, const int* label_lengths, void* alphas, void* betas,
           void* ll_forward, void* ll_backward, int B, int Tmax, int U, int compute_betas,
           cudaStream_t stream) {
  const size_t smem = ((size_t)(arcs.W + 1) * U + 6 * wtt::kWarp) * sizeof(T);
  const bool one = U <= kMaxThreads;
  auto kernel = one ? window_block_kernel<T, true> : window_block_kernel<T, false>;
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


// ---------------------------------------------------------------------------
// The plan and the launches.

struct Plan {
  int warp_mode;      // 1: the warp kernel; 0: the block kernel
  int warps;          // G, warps a lattice (warp mode)
  int cells;          // C, cells a lane (warp mode)
  int per_block;      // lattices a block (warp mode)
  int blocks;
  int threads;        // a block
  int smem;           // dynamic shared memory a block, bytes
  int lattice_words;  // shared memory of a lattice, values (warp mode)
};

// C for a warp of n columns: the least odd number with 32·C >= n.
int cells_for(int n) {
  const int c = (n + wtt::kWarp - 1) / wtt::kWarp;
  return c + 1 - c % 2;
}

// Shared memory of a lattice of G warps, C cells a lane: the copy ring, then
// alpha's departure rings and staged rows (beta: its ring and slack), then
// the exchange; the larger of the two where the block holds both.
long long lattice_words(int G, int C, int W, int n_arcs, int Cx, int dirs) {
  const long long up = (long long)G * wtt::kWarp * C, R = W + 1;
  const long long copy = kCopyRows * ((2LL + Cx) * up + kRowPad);
  const long long alpha = copy + n_arcs * R * up + 2 * up + kXchWords;
  const long long beta = copy + R * up + kSlack + kXchWords;
  return dirs == 2 && beta > alpha ? beta : alpha;
}

// B utterances of T frames and U labels, `elt`-byte values, a longest
// duration W, n_arcs blank and emit arcs, Cx extra channels, with or
// without a chain, alpha only (dirs 1) or alpha and beta (dirs 2), on a
// card of n_sm SMs; `force` warps a lattice, or 0 for the rule: with a
// chain, 4 or 2 warps where each gets more than 64 columns and the
// lattices' warps stay within two an SM, else one.
Plan plan(int B, int T, int U, int elt, int W, int n_arcs, int Cx, int has_chain, int dirs,
          int n_sm, int force) {
  Plan p{};
  const long long lattices = (long long)B * dirs;
  int G = 1;
  if (force > 0) {
    G = force;
  } else if (has_chain) {
    for (int g = kMaxG; g > 1; g /= 2)
      if (U > 2 * wtt::kWarp * g && lattices * g <= 2LL * n_sm) {
        G = g;
        break;
      }
  }
  int C = cells_for((U + G - 1) / G);
  long long bytes = lattice_words(G, C, W, n_arcs, Cx, dirs) * elt;
  if (force == 0 && G > 1 && (C > max_cells(elt) || bytes > kSmemMax)) {
    G = 1;
    C = cells_for(U);
    bytes = lattice_words(G, C, W, n_arcs, Cx, dirs) * elt;
  }
  // 32-bit offsets inside a lattice: rows of U·Cx extras up to T + kAhead.
  const bool small = (long long)(T + kAhead) * U * (Cx > 1 ? Cx : 1) <= INT_MAX;
  if (small && U >= 1 && G <= kMaxG && (has_chain || G == 1) && C <= max_cells(elt) &&
      bytes <= kSmemMax) {
    long long cap = kMaxWarps / G;
    cap = cap < kSmemMax / bytes ? cap : kSmemMax / bytes;
    const long long spread = (lattices + n_sm - 1) / n_sm;
    p.warp_mode = 1;
    p.warps = G;
    p.cells = C;
    p.per_block = (int)(spread < 1 ? 1 : (spread > cap ? cap : spread));
    p.blocks = (int)((lattices + p.per_block - 1) / p.per_block);
    p.threads = wtt::kWarp * G * p.per_block;
    p.smem = (int)(bytes * p.per_block);
    p.lattice_words = (int)(bytes / elt);
  } else {
    p.per_block = 1;
    p.blocks = B;
    p.threads = U <= kMaxThreads ? ((U + wtt::kWarp - 1) / wtt::kWarp) * wtt::kWarp : kMaxThreads;
    p.smem = (int)(((long long)(W + 1) * U + 6 * wtt::kWarp) * elt);
  }
  return p;
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n < 1)
    return 1;
  return n;
}

// The warp kernel's arcs: each channel's place in a copied row of UP values
// of lpb and of lpe, then U·Cx extras interleaved by cell, then the zero
// word, where the slot beyond a one-channel arc's channel points.
SlotArc slot_arc(const Arc& a, int up, int Cx) {
  SlotArc s{};
  s.m = a.m;
  for (int c = 0; c < kMaxChannels && s.n < kWarpArcChannels; ++c) {
    if (!(a.mask >> c & 1u)) continue;
    s.base[s.n] = c == 0 ? 0 : c == 1 ? up : 2 * up + (c - 2);
    s.stride[s.n] = c < 2 ? 1 : Cx;
    ++s.n;
  }
  for (int k = s.n; k < kWarpArcChannels; ++k) s.base[k] = (2 + Cx) * up;  // stride 0
  return s;
}

// The kernel instance of C cells a lane: C = C0, C0 + 2, ... up to kMax.
template <typename T, int C, int kMax>
const void* warp_kernel_of(int cells) {
  if (cells == C) return reinterpret_cast<const void*>(window_warp_kernel<T, C>);
  if constexpr (C + 2 <= kMax) return warp_kernel_of<T, C + 2, kMax>(cells);
  return nullptr;
}
template <typename T>
const void* warp_kernel(int cells) {
  return warp_kernel_of<T, 1, max_cells(sizeof(T))>(cells);
}

// Whether an arc sums three channels (the warp kernel takes one or two).
bool wide_arcs(const WindowArcs& arcs) {
  auto wide = [](const Arc& a) { return __builtin_popcount(a.mask) > kWarpArcChannels; };
  bool any = arcs.has_chain && wide(arcs.chain);
  for (int i = 0; i < arcs.n_blank; ++i) any = any || wide(arcs.blank[i]);
  for (int i = 0; i < arcs.n_emit; ++i) any = any || wide(arcs.emit[i]);
  return any;
}

template <typename T>
int launch(const void* lpb, const void* lpe, const void* extra, int Cx, const WindowArcs& arcs,
           const int* input_lengths, const int* label_lengths, void* alphas, void* betas,
           void* ll_forward, void* ll_backward, int B, int Tmax, int U, int compute_betas,
           int force, cudaStream_t stream) {
  const int dirs = compute_betas ? 2 : 1;
  const Plan p = plan(B, Tmax, U, sizeof(T), arcs.W, arcs.n_blank + arcs.n_emit, Cx,
                      arcs.has_chain, dirs, sm_count(), force);
  if (!p.warp_mode || wide_arcs(arcs)) {
    if (force > 0) return (int)cudaErrorInvalidValue;
    return launch_block<T>(lpb, lpe, extra, Cx, arcs, input_lengths, label_lengths, alphas,
                           betas, ll_forward, ll_backward, B, Tmax, U, compute_betas, stream);
  }
  const int up = p.warps * wtt::kWarp * p.cells;
  SlotArcs sa{};
  sa.W = arcs.W;
  sa.has_chain = arcs.has_chain;
  sa.n_blank = arcs.n_blank;
  sa.n_emit = arcs.n_emit;
  if (arcs.has_chain) sa.chain = slot_arc(arcs.chain, up, Cx);
  for (int i = 0; i < arcs.n_blank; ++i) sa.arc[i] = slot_arc(arcs.blank[i], up, Cx);
  for (int i = 0; i < arcs.n_emit; ++i) sa.arc[arcs.n_blank + i] = slot_arc(arcs.emit[i], up, Cx);
  const void* kernel = warp_kernel<T>(p.cells);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  if (p.smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return (int)err;
  }
  const T* pb = static_cast<const T*>(lpb);
  const T* pe = static_cast<const T*>(lpe);
  const T* px = static_cast<const T*>(extra);
  T* al = static_cast<T*>(alphas);
  T* be = static_cast<T*>(betas);
  T* lf = static_cast<T*>(ll_forward);
  T* lb = static_cast<T*>(ll_backward);
  int n_b = B, t = Tmax, u = U, d = dirs, g = p.warps, per = p.per_block, lw = p.lattice_words,
      cx = Cx;
  void* args[] = {&pb, &pe, &px, &cx, &sa, (void*)&input_lengths, (void*)&label_lengths,
                  &al, &be, &lf, &lb, &n_b, &t, &u, &d, &g, &per, &lw};
  const cudaError_t err =
      cudaLaunchKernel(kernel, dim3(p.blocks), dim3(p.threads), args, (size_t)p.smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int attrs(int cells, int U, int* regs, int* local_bytes) {
  cudaFuncAttributes a;
  cudaError_t err;
  if (cells > 0) {
    const void* kernel = warp_kernel<T>(cells);
    if (kernel == nullptr) return (int)cudaErrorInvalidValue;
    err = cudaFuncGetAttributes(&a, kernel);
  } else {
    err = cudaFuncGetAttributes(&a, U <= kMaxThreads ? window_block_kernel<T, true>
                                                     : window_block_kernel<T, false>);
  }
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}

int elt_size(int dtype) { return dtype == wtt::kF32 ? 4 : (dtype == wtt::kF64 ? 8 : 0); }

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

int wtt_window_stream_warps(const void* lpb, const void* lpe, const void* extra, int dtype,
                            int C, const int* arc_table, int n_blank, int n_emit,
                            const int* input_lengths, const int* label_lengths, void* alphas,
                            void* betas, void* ll_forward, void* ll_backward, int B, int T, int U,
                            int compute_betas, int warps, void* stream) {
  if (B == 0) return 0;
  if (T < 1 || U < 1 || C < 0 || C > kMaxChannels - 2 || arc_table == nullptr || n_blank < 1 ||
      n_blank > kMaxArcs || n_emit < 0 || n_emit > kMaxArcs || warps < 0 || warps > kMaxG)
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
                           ll_forward, ll_backward, B, T, U, compute_betas, warps, s);
    case wtt::kF64:
      return launch<double>(lpb, lpe, extra, C, arcs, input_lengths, label_lengths, alphas,
                            betas, ll_forward, ll_backward, B, T, U, compute_betas, warps, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// lpb, lpe: (B,T,U) f32 or f64 (`dtype`); extra: (B,T,U,C) of the same type,
// C <= 8 (unused and may be null when C == 0); lengths: (B,) int32; alphas,
// betas: (B,T,U) (betas and ll_backward unused and may be null when
// compute_betas == 0); ll_forward, ll_backward: (B,). arc_table: a host
// array of 1 + n_blank + n_emit rows of five ints (m, n, ch0, ch1, ch2): the
// chain first (n == 0: the lattice has none), then the blank arcs, then the
// emit arcs. Returns the launch's cudaError_t. (wtt_window_stream_warps:
// the same with the warps a lattice forced, for the measurement scripts; 0
// is the plan's own choice.)
int wtt_window_stream(const void* lpb, const void* lpe, const void* extra, int dtype, int C,
                      const int* arc_table, int n_blank, int n_emit, const int* input_lengths,
                      const int* label_lengths, void* alphas, void* betas, void* ll_forward,
                      void* ll_backward, int B, int T, int U, int compute_betas, void* stream) {
  return wtt_window_stream_warps(lpb, lpe, extra, dtype, C, arc_table, n_blank, n_emit,
                                 input_lengths, label_lengths, alphas, betas, ll_forward,
                                 ll_backward, B, T, U, compute_betas, 0, stream);
}

// The launch plan for B utterances of T frames and U labels, a longest
// duration W, n_arcs blank and emit arcs, C extra channels, with or without
// a chain, on a card of n_sm SMs, `warps` a lattice forced (0: the plan's
// rule): out = {warp kernel (1) or block kernel (0), warps a lattice, cells
// a lane, lattices a block, blocks, threads a block, dynamic shared memory a
// block, values of a lattice's shared memory}; all -1 for an unknown dtype.
void wtt_window_plan(int B, int T, int U, int dtype, int W, int n_arcs, int C, int has_chain,
                     int compute_betas, int n_sm, int warps, int* out) {
  const int elt = elt_size(dtype);
  if (elt == 0 || n_sm < 1) {
    for (int i = 0; i < 8; ++i) out[i] = -1;
    return;
  }
  const Plan p = plan(B, T, U, elt, W, n_arcs, C, has_chain, compute_betas ? 2 : 1, n_sm, warps);
  const int v[8] = {p.warp_mode, p.warps, p.cells, p.per_block,
                    p.blocks,    p.threads, p.smem, p.lattice_words};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
}

// Registers and local (spill) bytes a thread of the warp kernel of `cells`
// cells a lane, or (cells 0) of the block kernel for U labels, as ptxas
// compiled it.
int wtt_window_attrs(int cells, int U, int dtype, int* regs, int* local_bytes) {
  switch (dtype) {
    case wtt::kF32: return attrs<float>(cells, U, regs, local_bytes);
    case wtt::kF64: return attrs<double>(cells, U, regs, local_bytes);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
