// The plan and the launches of the pending-window lattice kernel, the
// counterpart of warp_transducer_tpu/ops/pallas/window_stream.py:104
// (_window_kernel, called through _run_window_kernel); the kernel, its walk
// and its design are csrc/window_walk.cuh, its wide instances built in
// window_stream_wide.cu and its table instance's two forms in
// window_stream_table.cu (rings) and window_stream_pending.cu (pending).
#include "window_walk.cuh"

namespace {

// ---------------------------------------------------------------------------
// The plan and the launches.

// The instances: the narrow and the wide one take the arc table by value
// (at most kMaxArcs blank and emit arcs over kMaxChannels channels); the
// table instance takes any table from device memory, in its rings form or
// its pending form, its rings in shared memory or, where they pass a block,
// in device memory.
enum Kind { kNarrow = 0, kWideKind = 1, kTable = 2, kPending = 3 };

struct Plan {
  int wide;           // the instance (Kind): 1 wide, 2 the table one's rings form, 3 pending
  int warps;          // G, warps a lattice
  int cells;          // C, cells a lane
  int passes;         // column passes of 32·G·C a lattice (wide)
  int per_block;      // lattices a block
  int blocks;
  int threads;        // a block
  int smem;           // dynamic shared memory a block, bytes
  int lattice_words;  // shared memory of a lattice, values
  long long hand;     // device memory the passes hand rows on through, values (0: one pass)
  long long rings;    // device memory of the rings, values (0: in shared memory)
};

// C for a warp of n columns: the least odd number with 32·C >= n.
int cells_for(int n) {
  const int c = (n + wtt::kWarp - 1) / wtt::kWarp;
  return c + 1 - c % 2;
}

// The most cells a lane of the instance `wide`.
int kind_max_cells(int wide, int elt) {
  return wide == kPending ? pending_max_cells(elt) : max_cells(elt);
}

// Values of alpha's rings of a lattice of G warps, C cells a lane: the
// departure rings of the narrow, the wide and the rings form, n_arcs ×
// (W + 1) rows (wide: of one more column, the edge); the pending form's
// window, W + 1 slots of UP + G (max, sum) pairs whatever the number of
// arcs.
long long alpha_ring_words(int G, int C, int W, int n_arcs, int wide) {
  const long long up = (long long)G * wtt::kWarp * C, R = W + 1;
  return wide == kPending ? 2 * R * (up + G) : n_arcs * R * (up + (wide ? 1 : 0));
}

// Shared memory of a lattice of G warps, C cells a lane: the copy ring
// (wide: with the 2 + n_arcs values a row the passes hand on, the pending
// form kPendHand), then alpha's rings and staged rows (beta: its ring and
// slack), then the exchange; the larger of the two where the block holds
// both. The wide rings keep one more column a row (the edge).
long long lattice_words(int G, int C, int W, int n_arcs, int Cx, int dirs, int wide,
                        int dev_rings = 0) {
  const long long up = (long long)G * wtt::kWarp * C, R = W + 1, rs = up + (wide ? 1 : 0);
  const long long hand = wide == kPending ? kPendHand : wide ? 2 + n_arcs : 0;
  const long long copy = kCopyRows * ((2LL + Cx) * up + kRowPad + hand);
  const long long xch = wide ? Shape<true>::kXchWords : Shape<false>::kXchWords;
  if (dev_rings) return copy + 2 * up + xch;  // alpha's staged rows; beta keeps less
  const long long alpha = copy + alpha_ring_words(G, C, W, n_arcs, wide) + 2 * up + xch;
  const long long beta = copy + R * rs + kSlack + xch;
  return dirs == 2 && beta > alpha ? beta : alpha;
}

// Values of a lattice's rings in device memory (the table instance's form
// `wide`): the larger of alpha's rings or window and beta's ring with its
// slack.
long long ring_words(int G, int C, int W, int n_arcs, int wide) {
  const long long rs = (long long)G * wtt::kWarp * C + 1, R = W + 1;
  const long long alpha = alpha_ring_words(G, C, W, n_arcs, wide), beta = R * rs + kSlack;
  return alpha > beta ? alpha : beta;
}

// Bytes of the table instance's arc table in a block's shared memory, in
// 32-byte units: the chain and the n_arcs arcs (SlotArcs of 32 bytes); the
// pending form's sorted arcs and its groups (at most n_arcs, 16 bytes each)
// after them.
long long table_bytes(int n_arcs, int wide) {
  static_assert(sizeof(SlotArc<Shape<true>::kArcCh>) == 32 && sizeof(Group) == 16, "");
  return (wide == kPending ? 2LL * n_arcs + 1 + (n_arcs + 1) / 2 : n_arcs + 1LL) * 32;
}

// B utterances of T frames and U labels, `elt`-byte values, a longest
// duration W, n_arcs blank and emit arcs, Cx extra channels, with or
// without a chain, alpha only (dirs 1) or alpha and beta (dirs 2), arcs of
// up to `arc_channels` channels, on a card of n_sm SMs; `force` warps a
// lattice, or 0 for the rule; `form` the table instance's form forced, or 0
// for the rule. The rule: G0 = 4 or 2 where each warp gets more than 64
// columns and the lattices' warps stay within two an SM, else 1; the
// narrow instance at G0, else at 4 … 2·G0, the first that runs; else the
// wide one at G0 … 16 in one pass; else the fewest passes that run on some
// G. Where the arcs pass the table by value (`by_value` 0: more than
// kMaxArcs blank or emit arcs, or more than kMaxChannels channels), or
// where none of those runs (a window whose rings pass a block at every G
// and pass), the table instance, each form at G0 … 16 in one pass with its
// rings in shared memory, else with its rings in device memory, else in
// the fewest passes that run with them there: the pending form where it
// runs the rings form's warps and cells a lattice in no more blocks and
// either keeps its rings in shared memory where the rings form's pass a
// block or takes fewer blocks, else the rings form (the faster where both
// take as many blocks in the same memory, or where the pending form needs
// other warps and cells: PERF.md §6). No plan (warps 0) only
// where even one warp's copy ring of a 32-column pass does not fit
// (thousands of channels).
Plan plan(int B, int T, int U, int elt, int W, int n_arcs, int Cx, int has_chain, int dirs,
          int n_sm, int force, int arc_channels, int by_value, int form = 0) {
  const long long lattices = (long long)B * dirs;
  int G0 = 1;
  if (force > 0) {
    G0 = force;
  } else {
    for (int g = 4; g > 1; g /= 2)
      if (U > 2 * wtt::kWarp * g && lattices * g <= 2LL * n_sm) {
        G0 = g;
        break;
      }
  }
  const bool narrow = by_value && arc_channels <= Shape<false>::kArcCh &&
                      (long long)(T + kAhead) * U * (Cx > 1 ? Cx : 1) <= INT_MAX;
  // Whether the instance `wide` runs at G warps, C cells a lane, its rings
  // in device memory where `dev`.
  auto runs = [&](int G, int C, int wide, int dev) {
    const long long extra = wide >= kTable ? table_bytes(n_arcs, wide) : 0;
    const int most = wide >= kTable ? kTableWarps : wide_warps(elt, C);
    return C <= kind_max_cells(wide, elt) && (!wide || G <= most) &&
           lattice_words(G, C, W, n_arcs, Cx, dirs, wide, dev) * elt + extra <= kSmemMax;
  };
  // The launch of the instance `wide` at G warps, C cells a lane, in
  // `passes` passes, its rings in device memory where `dev`.
  auto finish = [&](int wide, int G, int C, int passes, int dev) {
    Plan p{};
    const long long extra = wide >= kTable ? table_bytes(n_arcs, wide) : 0;
    const long long bytes = lattice_words(G, C, W, n_arcs, Cx, dirs, wide, dev) * elt;
    const int max_warps =
        wide >= kTable ? kTableWarps : wide ? wide_warps(elt, C) : kNarrowWarps;
    long long cap = max_warps / G;
    cap = cap < (kSmemMax - extra) / bytes ? cap : (kSmemMax - extra) / bytes;
    const long long spread = (lattices + n_sm - 1) / n_sm;
    p.wide = wide;
    p.warps = G;
    p.cells = C;
    p.passes = passes;
    p.per_block = (int)(spread < 1 ? 1 : (spread > cap ? cap : spread));
    p.blocks = (int)((lattices + p.per_block - 1) / p.per_block);
    p.threads = wtt::kWarp * G * p.per_block;
    p.smem = (int)(bytes * p.per_block + extra);
    p.lattice_words = (int)(bytes / elt);
    p.hand = passes > 1 ? lattices * 2 * T * (wide == kPending ? kPendHand : 2LL + n_arcs) : 0;
    p.rings = dev ? lattices * ring_words(G, C, W, n_arcs, wide) : 0;
    return p;
  };
  // The fewest passes of the instance `kind` that run on some G.
  auto in_passes = [&](int kind, int dev) {
    for (int n = 2; (U + n - 2) / (n - 1) > wtt::kWarp; ++n) {
      const int cols = (U + n - 1) / n;
      for (int g = G0; g <= Shape<true>::kMaxG; g *= 2) {
        const int c = cells_for((cols + g - 1) / g);
        if (runs(g, c, kind, dev))
          return finish(kind, g, c, (U + g * wtt::kWarp * c - 1) / (g * wtt::kWarp * c), dev);
        if (force > 0) break;
      }
    }
    return Plan{};
  };
  for (int w = 0; w < 2 && by_value; ++w) {
    if (w == 0 && !narrow) continue;
    // The narrow instance at G0, then at 4 warps down to 2·G0 (more warps a
    // lattice walk a row sooner: PERF.md §6); the wide one at G0 up
    // to 16.
    int cand[5], n = 0;
    cand[n++] = G0;
    if (force == 0) {
      if (w == 0)
        for (int g = Shape<false>::kMaxG; g > G0; g /= 2) cand[n++] = g;
      else
        for (int g = 2 * G0; g <= Shape<true>::kMaxG; g *= 2) cand[n++] = g;
    }
    const int top = w ? Shape<true>::kMaxG : Shape<false>::kMaxG;
    for (int i = 0; i < n; ++i) {
      const int g = cand[i];
      const int c = cells_for((U + g - 1) / g);
      if (g <= top && runs(g, c, w, 0)) return finish(w, g, c, 1, 0);
    }
  }
  if (by_value) {
    const Plan p = in_passes(kWideKind, 0);
    if (p.warps > 0) return p;
  }
  // The table instance's form `kind` in one pass, its rings in shared
  // memory, then in device memory; then in passes, its rings in device
  // memory.
  auto table = [&](int kind) {
    for (int dev = 0; dev < 2; ++dev)
      for (int g = G0; g <= Shape<true>::kMaxG; g *= 2) {
        const int c = cells_for((U + g - 1) / g);
        if (runs(g, c, kind, dev)) return finish(kind, g, c, 1, dev);
        if (force > 0) break;
      }
    return in_passes(kind, 1);
  };
  if (form >= kTable) return table(form);
  const Plan r = table(kTable), q = table(kPending);
  const bool same = q.warps == r.warps && q.cells == r.cells && q.blocks <= r.blocks;
  const bool shared = q.rings == 0 && r.rings > 0, fewer = q.blocks < r.blocks;
  const bool pending = q.warps > 0 && (r.warps == 0 || (same && (shared || fewer)));
  return pending ? q : r;
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n < 1)
    return 1;
  return n;
}

// The kernel's arcs: each channel's place in a copied row of UP values of
// lpb and of lpe, then U·Cx extras interleaved by cell, then the zero word,
// where the slots beyond an arc's channels point.
template <int N>
SlotArc<N> slot_arc(const Arc& a, int up, int Cx) {
  SlotArc<N> s{};
  s.m = a.m;
  for (int c = 0; c < kMaxChannels && s.n < N; ++c) {
    if (!(a.mask >> c & 1u)) continue;
    s.base[s.n] = c == 0 ? 0 : c == 1 ? up : 2 * up + (c - 2);
    s.stride[s.n] = c < 2 ? 1 : Cx;
    ++s.n;
  }
  for (int k = s.n; k < N; ++k) s.base[k] = (2 + Cx) * up;  // stride 0
  return s;
}

// The kernel instance of C cells a lane; the wide instances are built in
// window_stream_wide.cu, the table ones in window_stream_table.cu (the rings
// form) and window_stream_pending.cu (the pending form).
template <typename T>
const void* warp_kernel(int cells, int wide) {
  if (wide == kTable) return wtt_window::table_kernel(sizeof(T), cells);
  if (wide == kPending) return wtt_window::pending_kernel(sizeof(T), cells);
  return wide ? wtt_window::wide_kernel(sizeof(T), cells)
              : warp_kernel_of<T, 1, max_cells(sizeof(T)), false>(cells);
}

template <int N>
SlotArcs<N> slot_arcs(const WindowArcs& arcs, int up, int Cx) {
  SlotArcs<N> sa{};
  sa.W = arcs.W;
  sa.has_chain = arcs.has_chain;
  sa.n_blank = arcs.n_blank;
  sa.n_emit = arcs.n_emit;
  if (arcs.has_chain) sa.chain = slot_arc<N>(arcs.chain, up, Cx);
  for (int i = 0; i < arcs.n_blank; ++i) sa.arc[i] = slot_arc<N>(arcs.blank[i], up, Cx);
  for (int i = 0; i < arcs.n_emit; ++i) sa.arc[arcs.n_blank + i] = slot_arc<N>(arcs.emit[i], up, Cx);
  return sa;
}

// What the launches know of the arcs: W, whether there is a chain, the
// counts, the number of distinct m (the pending form's groups), the most
// channels an arc sums, and whether the table fits the narrow and wide
// instances' by-value table (`arcs` is then filled).
struct ArcsInfo {
  int W, has_chain, n_blank, n_emit, n_groups, arc_channels, by_value;
  WindowArcs arcs;
};

template <typename T>
int launch(const void* lpb, const void* lpe, const void* extra, int Cx, const ArcsInfo& a,
           const int* table, const int* input_lengths, const int* label_lengths, void* alphas,
           void* betas, void* ll_forward, void* ll_backward, int B, int Tmax, int U,
           int compute_betas, int force, int form, void* hand, void* rings,
           cudaStream_t stream) {
  const int dirs = compute_betas ? 2 : 1;
  const int n_arcs = a.n_blank + a.n_emit;
  const Plan p = plan(B, Tmax, U, sizeof(T), a.W, n_arcs, Cx, a.has_chain, dirs, sm_count(),
                      force, a.arc_channels, a.by_value, form);
  if (p.warps == 0 || (p.hand > 0 && hand == nullptr) || (p.rings > 0 && rings == nullptr) ||
      (p.wide >= kTable && table == nullptr))
    return (int)cudaErrorInvalidValue;
  const void* kernel = warp_kernel<T>(p.cells, p.wide);
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
  T* hd = static_cast<T*>(hand);
  int n_b = B, t = Tmax, u = U, d = dirs, g = p.warps, per = p.per_block, lw = p.lattice_words,
      cx = Cx, passes = p.passes;
  cudaError_t err;
  if (p.wide >= kTable) {
    T* rg = static_cast<T*>(rings);
    long long rw = p.rings > 0 ? ring_words(p.warps, p.cells, a.W, n_arcs, p.wide) : 0;
    int nb = a.n_blank, ne = a.n_emit, ng = a.n_groups, w = a.W;
    void* args[] = {&pb, &pe, &px, &cx, (void*)&table, &nb, &ne, &ng, &w, (void*)&input_lengths,
                    (void*)&label_lengths, &al, &be, &lf, &lb, &n_b, &t, &u, &d, &g, &per,
                    &lw, &passes, &hd, &rg, &rw};
    err = cudaLaunchKernel(kernel, dim3(p.blocks), dim3(p.threads), args, (size_t)p.smem,
                           stream);
  } else {
    const int up = p.warps * wtt::kWarp * p.cells;
    SlotArcs<Shape<false>::kArcCh> narrow{};
    SlotArcs<Shape<true>::kArcCh> wide{};
    if (p.wide)
      wide = slot_arcs<Shape<true>::kArcCh>(a.arcs, up, Cx);
    else
      narrow = slot_arcs<Shape<false>::kArcCh>(a.arcs, up, Cx);
    void* args[] = {&pb, &pe, &px, &cx, p.wide ? (void*)&wide : (void*)&narrow,
                    (void*)&input_lengths, (void*)&label_lengths, &al, &be, &lf, &lb, &n_b, &t,
                    &u, &d, &g, &per, &lw, &passes, &hd};
    err = cudaLaunchKernel(kernel, dim3(p.blocks), dim3(p.threads), args, (size_t)p.smem,
                           stream);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int attrs(int cells, int wide, int* regs, int* local_bytes) {
  const void* kernel = warp_kernel<T>(cells, wide);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}

int elt_size(int dtype) { return dtype == wtt::kF32 ? 4 : (dtype == wtt::kF64 ? 8 : 0); }

// Whether five host ints (m, n, ch0, ch1, ch2) are an arc that sums 1..3
// distinct channels inside [0, 2 + C) and (when `moves`) advances at least
// one row; any C.
bool arc_ok(const int* row, int C, bool moves) {
  const int n = row[1];
  if (n < 1 || n > kMaxArcChannels || (moves && row[0] < 1)) return false;
  for (int i = 0; i < n; ++i) {
    const int c = row[2 + i];
    if (c < 0 || c >= 2 + C) return false;
    for (int j = 0; j < i; ++j)
      if (row[2 + j] == c) return false;
  }
  return true;
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

int wtt_window_stream_warps(const void* lpb, const void* lpe, const void* extra, int dtype,
                            int C, const int* arc_table, int n_blank, int n_emit,
                            const int* table, const int* input_lengths,
                            const int* label_lengths, void* alphas, void* betas,
                            void* ll_forward, void* ll_backward, int B, int T, int U,
                            int compute_betas, int warps, int form, void* hand, void* rings,
                            void* stream) {
  if (B == 0) return 0;
  if (T < 1 || U < 1 || C < 0 || arc_table == nullptr || n_blank < 1 || n_emit < 0 ||
      warps < 0 || warps > Shape<true>::kMaxG || (form != 0 && form != kTable && form != kPending))
    return (int)cudaErrorInvalidValue;
  ArcsInfo a = {};
  a.has_chain = arc_table[1] != 0;
  if (a.has_chain && !arc_ok(arc_table, C, false)) return (int)cudaErrorInvalidValue;
  a.n_blank = n_blank;
  a.n_emit = n_emit;
  a.arc_channels = a.has_chain ? arc_table[1] : 1;
  for (int i = 0; i < n_blank + n_emit; ++i) {
    const int* row = arc_table + 5 * (1 + i);
    if (!arc_ok(row, C, true)) return (int)cudaErrorInvalidValue;
    a.W = row[0] > a.W ? row[0] : a.W;
    a.arc_channels = row[1] > a.arc_channels ? row[1] : a.arc_channels;
    bool seen = false;
    for (int j = 0; j < i && !seen; ++j) seen = arc_table[5 * (1 + j)] == row[0];
    a.n_groups += seen ? 0 : 1;
  }
  a.by_value = C <= kMaxChannels - 2 && n_blank <= kMaxArcs && n_emit <= kMaxArcs;
  if (a.by_value) {
    WindowArcs& w = a.arcs;
    w.W = a.W;
    w.has_chain = a.has_chain;
    w.n_blank = n_blank;
    w.n_emit = n_emit;
    if (a.has_chain) read_arc(arc_table, C, false, &w.chain);
    for (int i = 0; i < n_blank + n_emit; ++i)
      read_arc(arc_table + 5 * (1 + i), C, true, i < n_blank ? &w.blank[i] : &w.emit[i - n_blank]);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case wtt::kF32:
      return launch<float>(lpb, lpe, extra, C, a, table, input_lengths, label_lengths, alphas,
                           betas, ll_forward, ll_backward, B, T, U, compute_betas, warps, form,
                           hand, rings, s);
    case wtt::kF64:
      return launch<double>(lpb, lpe, extra, C, a, table, input_lengths, label_lengths, alphas,
                            betas, ll_forward, ll_backward, B, T, U, compute_betas, warps, form,
                            hand, rings, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// lpb, lpe: (B,T,U) f32 or f64 (`dtype`); extra: (B,T,U,C) of the same type,
// any C (unused and may be null when C == 0); lengths: (B,) int32; alphas,
// betas: (B,T,U) (betas and ll_backward unused and may be null when
// compute_betas == 0); ll_forward, ll_backward: (B,); hand: the plan's
// `hand` values of the same type (may be null when the plan has one pass);
// rings: the plan's `rings` values of the same type (may be null when they
// are 0). arc_table: a host array of 1 + n_blank + n_emit rows of five ints
// (m, n, ch0, ch1, ch2): the chain first (n == 0: the lattice has none),
// then the blank arcs, then the emit arcs, any number of them; table: the
// same rows as an int32 array in device memory, followed by the arcs sorted
// by (m, blank before emit, table order) and one row (m, first, n_blank, n,
// 0) for each group of one m in order of m (the first sorted arc of the
// group, its blank arcs, its arcs), which the table instance reads (may be
// null where the plan takes another). Returns the launch's cudaError_t
// (cudaErrorInvalidValue where no plan runs).
// (wtt_window_stream_warps: the same with the warps a lattice and the
// table instance's form (2 rings, 3 pending) forced, for the measurement
// scripts; 0 is the plan's own choice.)
int wtt_window_stream(const void* lpb, const void* lpe, const void* extra, int dtype, int C,
                      const int* arc_table, int n_blank, int n_emit, const int* table,
                      const int* input_lengths, const int* label_lengths, void* alphas,
                      void* betas, void* ll_forward, void* ll_backward, int B, int T, int U,
                      int compute_betas, void* hand, void* rings, void* stream) {
  return wtt_window_stream_warps(lpb, lpe, extra, dtype, C, arc_table, n_blank, n_emit, table,
                                 input_lengths, label_lengths, alphas, betas, ll_forward,
                                 ll_backward, B, T, U, compute_betas, 0, 0, hand, rings, stream);
}

// The launch plan for B utterances of T frames and U labels, a longest
// duration W, n_arcs blank and emit arcs, C extra channels, with or without
// a chain, arcs of up to `arc_channels` channels, `by_value` 1 where the
// arcs fit the narrow and wide instances' table, on a card of n_sm SMs,
// `warps` a lattice and `form` the table instance's form forced (0: the
// plan's rule): out = {instance (0 narrow, 1 wide, 2 the table instance's
// rings form, 3 its pending form), warps a lattice (0: no plan), cells a lane,
// passes, lattices a block, blocks, threads a block, dynamic shared memory
// a block, values of a lattice's shared memory, the passes' device memory
// in values (low and high 31 bits), the rings' device memory in values
// (low and high 31 bits)}; all -1 for an unknown dtype.
void wtt_window_plan(int B, int T, int U, int dtype, int W, int n_arcs, int C, int has_chain,
                     int compute_betas, int n_sm, int warps, int arc_channels, int by_value,
                     int form, int* out) {
  const int elt = elt_size(dtype);
  if (elt == 0 || n_sm < 1) {
    for (int i = 0; i < 13; ++i) out[i] = -1;
    return;
  }
  const Plan p = plan(B, T, U, elt, W, n_arcs, C, has_chain, compute_betas ? 2 : 1, n_sm, warps,
                      arc_channels, by_value, form);
  const int v[13] = {p.wide,    p.warps,   p.cells, p.passes,
                     p.per_block, p.blocks, p.threads, p.smem,
                     p.lattice_words, (int)(p.hand & 0x7fffffff), (int)(p.hand >> 31),
                     (int)(p.rings & 0x7fffffff), (int)(p.rings >> 31)};
  for (int i = 0; i < 13; ++i) out[i] = v[i];
}

// Registers and local (spill) bytes a thread of the kernel instance of
// `cells` cells a lane (`wide`: 0 narrow, 1 wide, 2 and 3 the table
// instance's rings and pending forms) takes, as ptxas compiled it.
int wtt_window_attrs(int cells, int wide, int dtype, int* regs, int* local_bytes) {
  switch (dtype) {
    case wtt::kF32: return attrs<float>(cells, wide, regs, local_bytes);
    case wtt::kF64: return attrs<double>(cells, wide, regs, local_bytes);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
