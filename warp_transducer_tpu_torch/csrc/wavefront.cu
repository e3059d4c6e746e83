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
// The rings take 2·kRing·32 values a band: 10 KB in f32, 20 KB in f64, so
// one block holds the rings of at most 16 bands (f32, 512 columns) or 11
// (f64, 352). A wider lattice is cut into stripes of at most that many
// bands (as even as the count allows), each stripe a block, and the stripes
// of a lattice are the CTAs of a thread-block cluster (wavefront_stripe_
// kernel, at most kMaxCluster, the portable size):
// * Inside a stripe the bands step as above. Its first band takes its
//   outer edge (alpha: column c0 - 1 of the stripe to the left; beta:
//   column c1 of the stripe to the right) from a ring of kHandRows words in
//   its own shared memory, which the neighbouring stripe's outer band fills
//   a row at a time through distributed shared memory: st.async, whose
//   bytes complete a transaction count on one of kChunks mbarriers there, a
//   chunk of kChunk rows each (the receiver arms it with an arrive that
//   expects the chunk's bytes). No fence or barrier of the sender waits for
//   these stores. The receiving warp waits on that mbarrier (try_wait,
//   acquire), never polls a word; once it has read a chunk it frees the
//   slot with a remote arrive on the sender's "empty" mbarrier, which the
//   sender waits on before it reuses the slot. So a stripe runs a chunk or more behind the
//   one before it, within the skew its first band has anyway (it starts at
//   diagonal c0, the stripe before it at c0 - 32·bands).
// * A stripe walks only the diagonals that hold its cells, from its first
//   column's row 0 to its last cell (T_b - 1, c1 - 1), and hands over each
//   row of its outer column once: T_b words a stripe boundary.
// * Beyond one cluster's reach (8 stripes: 4096 columns in f32, 2816 in
//   f64) the cluster's CTAs take stripe k + 8 after stripe k, in passes.
//   The edge column between passes (from the last CTA of pass p to the
//   first of pass p + 1) goes through device memory: the sender writes each
//   row and publishes, a chunk at a time, how many rows it has written with
//   a release store of a counter; the receiver reads the counter with an
//   acquire load where it has not yet seen the row it needs, and issues the
//   row's load a step before it needs the value.
// So a lattice has no limit on U; each lattice is indexed from its own
// 64-bit base, with 64-bit row offsets, so T·U has none either.
//
// The plan (bands a stripe, stripes, the cluster, passes, lattices a
// block) is `plan` below, mirrored by ops/cuda/wavefront.py::plan;
// wtt_wavefront_plan lets a card test hold the two equal, and
// tests/test_torch_wavefront_plan.py replays both kernels' schedules (the
// handoff's chunks, mbarrier phases and passes included) in numpy on the
// CPU.
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
// Stripes: CTAs a cluster (the portable size), and the handoff of an edge
// column between two of them: chunks of kChunk rows, kChunks in flight.
constexpr int kMaxCluster = 8;
constexpr int kChunk = 16;
constexpr int kChunks = 4;
constexpr int kHandRows = kChunk * kChunks;

// Shared memory of one band (warp): the rings of lpb and lpe.
constexpr int band_bytes(int elt) { return 2 * kRing * wtt::kWarp * elt; }
// The edge words the bands trade, static: [lattice][parity][band], in the
// largest type.
constexpr int kEdgeBytes = kMaxLatticesPerBlock * 2 * kMaxBands * 8;
// The stripe kernel's handoff, static: its ring of rows (in the largest
// type) and its full and empty mbarriers.
constexpr int kHandBytes = kHandRows * 8 + 2 * kChunks * 8;
constexpr int max_bands(int elt) {
  const int n = (kSmemMax - kEdgeBytes - kHandBytes) / band_bytes(elt);
  return n < kMaxBands ? n : kMaxBands;
}

struct Plan {
  int bands;      // warps a lattice (one stripe) or a stripe
  int per_block;  // lattices a block
  int blocks;
  int threads;
  int smem;       // dynamic shared memory a block
  int stripes;    // stripes a lattice: 1, the band kernel; more, the stripe kernel
  int cluster;    // CTAs a cluster (the stripe kernel), else 1
  int passes;     // the cluster's passes over the stripes
  int wide;       // the band kernel with 64-bit offsets: (T + U + 2·kRing)·U beyond an int
};

int cdiv(int a, int b) { return (a + b - 1) / b; }

// Offsets within a lattice, up to (T + U + 2·kRing)·U, in an int.
constexpr long long kMaxOffset = 0x7fffffffLL;

Plan plan(int B, int T, int U, int elt, int dirs, int n_sm) {
  Plan p{};
  const int lattices = B * dirs;
  const int bands = U > wtt::kWarp ? cdiv(U, wtt::kWarp) : 1;
  const int cap_bands = max_bands(elt);
  p.bands = cdiv(bands, cdiv(bands, cap_bands));  // as even as the count allows
  p.stripes = cdiv(bands, p.bands);
  if (p.stripes == 1) {
    int cap = kMaxLatticesPerBlock;
    cap = cap < kMaxWarps / bands ? cap : kMaxWarps / bands;
    cap = cap < cap_bands / bands ? cap : cap_bands / bands;
    const int spread = (lattices + n_sm - 1) / n_sm;
    p.per_block = spread < 1 ? 1 : (spread > cap ? cap : spread);
    p.cluster = 1;
    p.passes = 1;
    p.wide = (long long)(T + U + 2 * kRing) * U > kMaxOffset;
  } else {
    p.per_block = 1;
    p.cluster = p.stripes < kMaxCluster ? p.stripes : kMaxCluster;
    p.passes = cdiv(p.stripes, p.cluster);
  }
  p.blocks = p.stripes == 1 ? cdiv(lattices, p.per_block) : lattices * p.cluster;
  p.threads = wtt::kWarp * p.bands * p.per_block;
  p.smem = band_bytes(elt) * p.bands * p.per_block;
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

// ---- the cluster: distributed shared memory and mbarriers ------------------

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ unsigned cluster_size() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ unsigned cluster_id() {
  unsigned r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return r;
}
// Every thread of the cluster: its shared memory writes (and mbarrier
// inits) before the barrier are seen by every thread after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n"
               ::: "memory");
}
// The address of the same shared-memory word in CTA `rank` of the cluster.
__device__ __forceinline__ unsigned map_rank(unsigned addr, unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
// A store into another CTA's shared memory through the async proxy: it
// counts its bytes off that CTA's mbarrier `bar` (mapped there) when it
// lands, and no barrier or fence of this thread waits for it.
__device__ __forceinline__ void st_async(unsigned addr, float v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
               ::"r"(addr), "r"(__float_as_uint(v)), "r"(bar) : "memory");
}
__device__ __forceinline__ void st_async(unsigned addr, double v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, [%2];\n"
               ::"r"(addr), "l"(__double_as_longlong(v)), "r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}
// This CTA's arrive on its own mbarrier, expecting `bytes` more to land.
__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// An arrive on an mbarrier of another CTA of the cluster (`bar` mapped there),
// ordered after this thread's earlier writes and reads.
__device__ __forceinline__ void mbar_arrive_remote(unsigned bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// Wait for the completion of the mbarrier's phase of this parity, with
// acquire semantics at cluster scope (its arrivals come from another CTA).
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// The handoff of a stripe's outer edge column, T_b rows, in the order the
// walk produces them (alpha: row 0 first; beta: row T_b - 1 first): row
// number i of that order. Where: 0 none, 1 the neighbouring CTA of the
// cluster (its ring and mbarriers), 2 device memory (between two passes).
template <typename T>
struct Hand {
  int recv, send;
  T* ring;                  // the ring [kHandRows] of this CTA
  unsigned full, empty;     // [kChunks] mbarriers each (shared addresses, this CTA's)
  unsigned up, down;        // the cluster ranks received from and sent to
  unsigned chunk_in, chunk_out;  // chunks received and sent in earlier passes
  const T* x_in;            // device memory: the edge column received,
  T* x_out;                 // and the one sent, T_max rows each,
  const unsigned* flag_in;  // with the count of rows written so far
  unsigned* flag_out;
  unsigned avail;           // rows of x_in known to be written
  int rows;                 // T_b
};

// Row i of the order (row `row` of the column), received by the warp of
// the stripe's outer band, every lane: lane `me` gets it (the others NEG)
// and, from the cluster's ring, frees its slot at the end of a chunk. A
// chunk's full mbarrier completes on lane me's arrive, which expects the
// chunk's bytes, and on those bytes landing (the sender's async stores).
template <typename T>
__device__ __forceinline__ T hand_recv(Hand<T>& h, int i, int row, int lane, int me) {
  T v = T(wtt::kNeg);
  if (h.recv == 1) {
    const unsigned c = h.chunk_in + i / kChunk, slot = c % kChunks;
    if (i % kChunk == 0) {
      if (lane == me) mbar_expect(h.full + 8 * slot, min(kChunk, h.rows - i) * sizeof(T));
      mbar_wait(h.full + 8 * slot, (c / kChunks) & 1);
    }
    if (lane == me) {
      v = h.ring[slot * kChunk + i % kChunk];
      if (i % kChunk == kChunk - 1 || i == h.rows - 1)
        mbar_arrive_remote(map_rank(h.empty + 8 * slot, h.up));
    }
  } else {
    while (h.avail <= (unsigned)i) {
      h.avail = ld_acquire(h.flag_in);
      if (h.avail <= (unsigned)i) __nanosleep(32);
    }
    if (lane == me) v = __ldcg(h.x_in + row);
  }
  return v;
}

// Row i of the order (row `row` of the column), sent by the warp of the
// stripe's outer band, every lane: lane `me` holds the value.
template <typename T>
__device__ __forceinline__ void hand_send(Hand<T>& h, int i, int row, T v, int lane, int me) {
  if (h.send == 1) {
    const unsigned c = h.chunk_out + i / kChunk, slot = c % kChunks;
    if (i % kChunk == 0 && c >= kChunks) mbar_wait(h.empty + 8 * slot, (c / kChunks - 1) & 1);
    if (lane == me)
      st_async(map_rank(smem_addr(h.ring + slot * kChunk + i % kChunk), h.down), v,
               map_rank(h.full + 8 * slot, h.down));
  } else if (lane == me) {
    h.x_out[row] = v;
    if (i % kChunk == kChunk - 1 || i == h.rows - 1) st_release(h.flag_out, (unsigned)i + 1);
  }
}

// What a band (warp) of a lattice works with.
template <typename T>
struct Band {
  const T* pb;  // the lattice's lpb, lpe, (T, U)
  const T* pe;
  T* out;       // its alphas or betas
  T* ring_b;    // [kRing][32] rows of lpb, each word then its cell's result
  T* ring_e;    // [kRing][32] rows of lpe
  T* edge;      // [2][kMaxBands] the edge words of the lattice's (stripe's) bands
  Extent e;
  int Tmax, U, band, lane, u;
  int local;    // the band's place in its stripe
  int bands;    // the stripe's bands that walk
  int barrier;  // the named barrier of the stripe's bands
  int c0s, c1;  // the stripe's first column, and the end of its columns inside U_b
};

// The band kernel's walks (one stripe a lattice). The stripe kernel's
// below are the same walks with a stripe's bounds and its handoff; the band
// kernel keeps these, whose bounds the compiler knows: sharing the stripe
// kernel's walks cost its step 4-20% on an H100. Off is the type of a
// lattice's offsets: int where (T + U + 2·kRing)·U fits it, which the plan
// picks (64-bit offsets cost the step 3-19%), else long long.
// Alpha over diagonals 1 .. N_b-1 from alpha(0, 0); ll_forward at the
// terminal cell. Lane l at diagonal n holds cell (t, u) = (n - c0 - l, c0 + l)
// and reads lpb(t-1, u), lpe(t, u-1): slot r of the input ring holds lpe of
// row r at column u-1 and lpb of row r-1 at column u, copied at step
// r + c0 - kAhead; row r of the results is complete at step r + c0 + 31 and
// written out at step r + c0 + 32.
template <typename T, typename Off>
__device__ void band_alpha_walk(const Band<T>& s, T* __restrict__ llf) {
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
    if (ro >= 0 && in_col)
      s.out[(Off)ro * U + u] = s.ring_b[wrap(ro % kRing, kRing) * wtt::kWarp + lane];
  if (e.terminal && u == e.Uv - 1)
    *llf = a + wtt::clamp_neg(s.pb[(Off)(e.Tv - 1) * U + u]);
  else if (!e.terminal && u == 0)
    *llf = neg;
}

// Beta over diagonals N_b-1 .. 0, seeded at the terminal cell (the only
// cell of diagonal N_b-1 inside the lattice, set before the walk);
// ll_backward = beta(0, 0). Lane l at diagonal n reads lpb(t, u), lpe(t, u)
// of its own cell: slot r of the input ring, copied at step
// r + c0 + 31 + kAhead (the walk goes down); row r of the results is
// complete at step r + c0 and written out at step r + c0 - 1.
template <typename T, typename Off>
__device__ void band_beta_walk(const Band<T>& s, T* __restrict__ llb) {
  const T neg = T(wtt::kNeg);
  const Extent& e = s.e;
  const int c0 = s.band * wtt::kWarp, lane = s.lane, u = s.u, U = s.U;
  const bool in_col = u < e.Uv;
  const bool right_band = lane == wtt::kWarp - 1 && s.band + 1 < s.bands;
  // Row r's copies: lpb and lpe of row r (column u), into a slot of the
  // rings; the sources of the walk's copies move up a row a step.
  const unsigned ring_e0 = smem_addr(s.ring_e + lane), ring_b0 = smem_addr(s.ring_b + lane);
  constexpr unsigned kSlot = wtt::kWarp * sizeof(T);
  auto copy_row = [&](int r, int slot, Off offset) {
    if (in_col && in_rows(r, e.Tv)) {
      copy_async(ring_b0 + slot * kSlot, s.pb + offset);
      copy_async(ring_e0 + slot * kSlot, s.pe + offset);
    }
  };
  T bv = neg;
  int first = e.steps - 1;  // the first diagonal the walk computes
  if (e.terminal) {
    if (u == e.Uv - 1) bv = wtt::clamp_neg(s.pb[(Off)(e.Tv - 1) * U + u]);
    --first;
  }
  int rc = first - c0 - (wtt::kWarp - 1) - kAhead;  // the first step's copy
  for (int r = rc + 1; r <= first - c0; ++r) copy_row(r, wrap(r % kRing, kRing), (Off)r * U + u);
  copy_commit();
  copy_wait_all();
  if (e.terminal && u == e.Uv - 1) s.ring_b[((e.Tv - 1) % kRing) * wtt::kWarp + lane] = bv;
  if (lane == 0) s.edge[((first + 1) & 1) * kMaxBands + s.band] = bv;
  band_barrier(s.barrier, s.bands);
  int sc = wrap(rc % kRing, kRing);
  int t = first - c0 - lane, sl = wrap(t % kRing, kRing);
  int ro = first - c0 + 1, so = wrap(ro % kRing, kRing);
  Off src = (Off)rc * U + u;
  T* dst = s.out + ((Off)ro * U + u);
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

// Alpha over the stripe's diagonals from alpha(0, 0) (the first stripe) or
// from diagonal c0s (the others, whose cells before it lie outside);
// ll_forward at the terminal cell. Lane l at diagonal n holds cell
// (t, u) = (n - c0 - l, c0 + l) and reads lpb(t-1, u), lpe(t, u-1): slot r
// of the input ring holds lpe of row r at column u-1 and lpb of row r-1 at
// column u, copied at step r + c0 - kAhead; row r of the results is
// complete at step r + c0 + 31 and written out at step r + c0 + 32. With
// stripes, the first band's lane 0 takes alpha(t, c0s - 1) from the stripe
// to the left, and the last band's lane 31 gives alpha(t, c1 - 1) to the
// stripe to the right.
template <typename T>
__device__ void stripe_alpha_walk(const Band<T>& s, Hand<T>& h, T* __restrict__ llf) {
  const T neg = T(wtt::kNeg);
  const Extent& e = s.e;
  const int c0 = s.band * wtt::kWarp, lane = s.lane, u = s.u, U = s.U;
  const bool pe_col = u >= 1 && u - 1 < e.Uv, in_col = u < e.Uv;
  const bool left_band = lane == 0 && s.local > 0;
  const bool takes = s.local == 0 && h.recv;  // warp-uniform
  const bool gives = s.local == s.bands - 1 && h.send;
  const int n0 = s.c0s > 0 ? s.c0s : 1;  // the first diagonal computed
  const int n_end = e.Tv + s.c1 - 1;     // past the stripe's last cell
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
  for (int r = 0; r <= n0 - 1 + kAhead - c0; ++r)  // the stripe's first band: rows 0 ..
    copy_row(r, r, s.pe + (r * U + u - 1), s.pb + ((r - 1) * U + u));
  copy_commit();
  copy_wait_all();
  if (u == 0) s.ring_b[lane] = a;  // row 0's result
  const int p0 = ((n0 - 1) & 1) * kMaxBands;  // the edge words of diagonal n0 - 1
  if (lane == wtt::kWarp - 1) s.edge[p0 + s.local] = a;
  band_barrier(s.barrier, s.bands);
  int rc = n0 + kAhead - c0, sc = wrap(rc % kRing, kRing);       // the step's copy: row, slot
  int t = n0 - c0 - lane, sl = wrap(t % kRing, kRing);           // the lane's cell: row, slot
  int ro = n0 - c0 - wtt::kWarp, so = wrap(ro % kRing, kRing);   // the row written out
  const T* src_e = s.pe + ((long long)rc * U + u - 1);
  const T* src_b = s.pb + ((long long)(rc - 1) * U + u);
  T* dst = s.out + ((long long)ro * U + u);
  int r_in = n0 - s.c0s, r_out = n0 - s.c1 + 1;  // the rows taken and given at step n0
  T edge = left_band ? s.edge[p0 + s.local - 1] : neg;
  if (takes && in_rows(r_in, e.Tv)) {
    const T v = hand_recv(h, r_in, r_in, lane, 0);
    if (lane == 0) edge = v;
  }
  T lpb_v = s.ring_b[sl * wtt::kWarp + lane], lpe_v = s.ring_e[sl * wtt::kWarp + lane];
  for (int n = n0; n < n_end; ++n) {
    // The left stripe's edge for the next step, asked for first.
    T next = neg;
    if (takes && in_rows(r_in + 1, e.Tv)) next = hand_recv(h, r_in + 1, r_in + 1, lane, 0);
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
    if (lane == wtt::kWarp - 1) s.edge[(n & 1) * kMaxBands + s.local] = a;
    band_barrier(s.barrier, s.bands);
    // after the barrier, so that it does not wait on the remote store
    if (gives && in_rows(r_out, e.Tv)) hand_send(h, r_out, r_out, a, lane, wtt::kWarp - 1);
    edge = left_band ? s.edge[(n & 1) * kMaxBands + s.local - 1] : neg;
    if (takes) edge = next;
    ++r_in;
    ++r_out;
  }
  // The rows completed at the last diagonals (dst is row ro's word).
  for (; ro < e.Tv; ++ro, dst += U)
    if (ro >= 0 && in_col) *dst = s.ring_b[wrap(ro % kRing, kRing) * wtt::kWarp + lane];
  if (e.terminal && u == e.Uv - 1)
    *llf = a + wtt::clamp_neg(s.pb[(long long)(e.Tv - 1) * U + u]);
  else if (!e.terminal && u == 0)
    *llf = neg;
}

// Beta over the stripe's diagonals down to c0s, seeded at the terminal
// cell where the stripe holds it (the only cell of diagonal N_b-1 inside
// the lattice, set before the walk); ll_backward = beta(0, 0). Lane l at
// diagonal n reads lpb(t, u), lpe(t, u) of its own cell: slot r of the
// input ring, copied at step r + c0 + 31 + kAhead (the walk goes down); row
// r of the results is complete at step r + c0 and written out at step
// r + c0 - 1. With stripes, the last band's lane 31 takes beta(t, c1) from
// the stripe to the right, and the first band's lane 0 gives beta(t, c0s)
// to the stripe to the left.
template <typename T>
__device__ void stripe_beta_walk(const Band<T>& s, Hand<T>& h, T* __restrict__ llb) {
  const T neg = T(wtt::kNeg);
  const Extent& e = s.e;
  const int c0 = s.band * wtt::kWarp, lane = s.lane, u = s.u, U = s.U;
  const bool in_col = u < e.Uv;
  const bool right_band = lane == wtt::kWarp - 1 && s.local + 1 < s.bands;
  const bool takes = s.local == s.bands - 1 && h.recv;  // warp-uniform
  const bool gives = s.local == 0 && h.send;
  const int last_row = e.Tv - 1;
  // Row r's copies: lpb and lpe of row r (column u), into a slot of the
  // rings; the sources of the walk's copies move up a row a step.
  const unsigned ring_e0 = smem_addr(s.ring_e + lane), ring_b0 = smem_addr(s.ring_b + lane);
  constexpr unsigned kSlot = wtt::kWarp * sizeof(T);
  auto copy_row = [&](int r, int slot, long long offset) {
    if (in_col && in_rows(r, e.Tv)) {
      copy_async(ring_b0 + slot * kSlot, s.pb + offset);
      copy_async(ring_e0 + slot * kSlot, s.pe + offset);
    }
  };
  T bv = neg;
  int first = e.Tv + s.c1 - 2;  // the stripe's last cell's diagonal: the first the walk computes
  const bool seeded = e.terminal && s.c1 == e.Uv;
  if (seeded) {
    if (u == e.Uv - 1) bv = wtt::clamp_neg(s.pb[(long long)(e.Tv - 1) * U + u]);
    --first;
  }
  int rc = first - c0 - (wtt::kWarp - 1) - kAhead;  // the first step's copy
  for (int r = rc + 1; r <= first - c0; ++r)
    copy_row(r, wrap(r % kRing, kRing), (long long)r * U + u);
  copy_commit();
  copy_wait_all();
  if (seeded && u == e.Uv - 1) s.ring_b[((e.Tv - 1) % kRing) * wtt::kWarp + lane] = bv;
  const int p0 = ((first + 1) & 1) * kMaxBands;  // the edge words of diagonal first + 1
  if (lane == 0) s.edge[p0 + s.local] = bv;
  int r_out = first + 1 - s.c0s, r_in = first + 1 - s.c1;  // given and taken before the walk
  if (gives && in_rows(r_out, e.Tv)) hand_send(h, last_row - r_out, r_out, bv, lane, 0);
  band_barrier(s.barrier, s.bands);
  int sc = wrap(rc % kRing, kRing);
  int t = first - c0 - lane, sl = wrap(t % kRing, kRing);
  int ro = first - c0 + 1, so = wrap(ro % kRing, kRing);
  long long src = (long long)rc * U + u;
  T* dst = s.out + ((long long)ro * U + u);
  T edge = right_band ? s.edge[p0 + s.local + 1] : neg;
  if (takes && in_rows(r_in, e.Tv)) {
    const T v = hand_recv(h, last_row - r_in, r_in, lane, wtt::kWarp - 1);
    if (lane == wtt::kWarp - 1) edge = v;
  }
  T lpb_v = s.ring_b[sl * wtt::kWarp + lane], lpe_v = s.ring_e[sl * wtt::kWarp + lane];
  for (int n = first; n >= s.c0s; --n) {
    --r_out;
    --r_in;
    // The right stripe's edge for the next step, asked for first.
    T next = neg;
    if (takes && in_rows(r_in, e.Tv))
      next = hand_recv(h, last_row - r_in, r_in, lane, wtt::kWarp - 1);
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
    if (lane == 0) s.edge[(n & 1) * kMaxBands + s.local] = bv;
    band_barrier(s.barrier, s.bands);
    if (gives && in_rows(r_out, e.Tv)) hand_send(h, last_row - r_out, r_out, bv, lane, 0);
    edge = right_band ? s.edge[(n & 1) * kMaxBands + s.local + 1] : neg;
    if (takes) edge = next;
  }
  // The rows completed at the last diagonals (the stripe's first band's row 0).
  for (; ro >= 0; --ro)
    if (ro < e.Tv && in_col)
      s.out[(long long)ro * U + u] = s.ring_b[(ro % kRing) * wtt::kWarp + lane];
  if (u == 0) *llb = bv;
}

// NEG into the band's cells outside (t < Tv) & (u < Uv), a row at a time.
template <typename T, typename Off>
__device__ void fill_invalid(const Band<T>& s) {
  const T neg = T(wtt::kNeg);
  const int c0 = s.band * wtt::kWarp;
  const bool full = min(c0 + wtt::kWarp, s.U) <= s.e.Uv;  // no column beyond Uv
  if (s.u >= s.U) return;
  for (int t = full ? s.e.Tv : 0; t < s.Tmax; ++t)
    if (t >= s.e.Tv || s.u >= s.e.Uv) s.out[(Off)t * s.U + s.u] = neg;
}

// Grid: a block of `per_block` lattices, `bands` warps each; lattice i is
// utterance i / dirs, alpha (i % dirs == 0) or beta. One stripe a lattice.
template <typename T, typename Off>
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
      band_beta_walk<T, Off>(s, ll_backward + b);
    else
      band_alpha_walk<T, Off>(s, ll_forward + b);
  } else if (s.band == 0) {  // no frame or no label column: nothing walks
    (is_beta ? ll_backward : ll_forward)[b] = T(wtt::kNeg);
  }
  fill_invalid<T, Off>(s);
}

// Grid: `cluster` CTAs a lattice, one cluster each; lattice i is utterance
// i / dirs, alpha (i % dirs == 0) or beta. The lattice's `stripes` stripes
// of `bands` bands are its chain, alpha from the left, beta from the right:
// position k is stripe k (alpha) or stripes - 1 - k (beta), and CTA r of
// the cluster walks positions r, r + cluster, ... in passes. xedge
// [lattice][pass boundary][T_max] and xflag [lattice][pass boundary] (zero
// on entry) carry the edge columns between passes.
template <typename T>
__global__ void __launch_bounds__(kMaxWarps * wtt::kWarp)
    wavefront_stripe_kernel(const T* __restrict__ lpb, const T* __restrict__ lpe,
                            const int* __restrict__ input_lengths,
                            const int* __restrict__ label_lengths, T* __restrict__ alphas,
                            T* __restrict__ betas, T* __restrict__ ll_forward,
                            T* __restrict__ ll_backward, int Tmax, int U, int dirs, int bands,
                            int stripes, T* __restrict__ xedge, unsigned* __restrict__ xflag) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) T edge_words[2 * kMaxBands];
  __shared__ __align__(8) T hand_ring[kHandRows];
  __shared__ __align__(8) unsigned long long hand_bars[2 * kChunks];  // full, then empty
  const unsigned C = cluster_size(), rank = cluster_rank();
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 * kChunks; ++i) mbar_init(smem_addr(hand_bars + i));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // every CTA's mbarriers ready before any remote arrive
  const int lattice = (int)cluster_id();
  const int b = lattice / dirs;
  const bool is_beta = lattice % dirs == 1;
  const int warp = threadIdx.x / wtt::kWarp;
  const Extent e = extent(input_lengths[b], label_lengths[b] + 1, Tmax, U);
  const int passes = (stripes + (int)C - 1) / (int)C;
  // The stripes that walk (those with a column inside U_b), a prefix of
  // the alpha chain and a suffix of the beta chain.
  const int walking = e.steps > 0 ? ((e.Uv + wtt::kWarp - 1) / wtt::kWarp + bands - 1) / bands : 0;
  auto walks = [&](int k) {
    return k >= 0 && k < stripes && (is_beta ? stripes - 1 - k : k) < walking;
  };
  const long long base = (long long)b * Tmax * U;
  Hand<T> h{};
  h.ring = hand_ring;
  h.full = smem_addr(hand_bars);
  h.empty = smem_addr(hand_bars + kChunks);
  h.up = rank - 1;
  h.down = rank + 1;
  h.rows = e.Tv;
  const unsigned per_pass = (e.Tv + kChunk - 1) / kChunk;  // chunks a handoff
  for (int pass = 0; pass < passes; ++pass) {
    const int k = pass * (int)C + (int)rank;
    if (k >= stripes) break;  // the whole CTA
    const int stripe = is_beta ? stripes - 1 - k : k;
    const bool walk = walks(k);
    h.recv = walk && walks(k - 1) ? (rank > 0 ? 1 : 2) : 0;
    h.send = walk && walks(k + 1) ? (rank + 1 < C ? 1 : 2) : 0;
    const long long boundary = (long long)lattice * (passes - 1);
    if (h.recv == 2) {
      h.x_in = xedge + (boundary + pass - 1) * Tmax;
      h.flag_in = xflag + boundary + pass - 1;
      h.avail = 0;
    }
    if (h.send == 2) {
      h.x_out = xedge + (boundary + pass) * Tmax;
      h.flag_out = xflag + boundary + pass;
    }
    Band<T> s;
    s.e = e;
    s.local = warp;
    s.band = stripe * bands + warp;
    s.lane = threadIdx.x % wtt::kWarp;
    s.u = s.band * wtt::kWarp + s.lane;
    s.U = U;
    s.Tmax = Tmax;
    s.c0s = stripe * bands * wtt::kWarp;
    s.c1 = min(s.c0s + bands * wtt::kWarp, e.Uv);
    s.bands = walk ? (s.c1 - s.c0s + wtt::kWarp - 1) / wtt::kWarp : 0;
    s.barrier = 1;
    s.pb = lpb + base;
    s.pe = lpe + base;
    s.out = (is_beta ? betas : alphas) + base;
    T* ring = reinterpret_cast<T*>(smem_raw) + (size_t)warp * 2 * kRing * wtt::kWarp;
    s.ring_b = ring;
    s.ring_e = ring + kRing * wtt::kWarp;
    s.edge = edge_words;
    if (warp < s.bands) {
      if (is_beta)
        stripe_beta_walk(s, h, ll_backward + b);
      else
        stripe_alpha_walk(s, h, ll_forward + b);
    } else if (s.band == 0) {  // no frame or no label column: nothing walks
      (is_beta ? ll_backward : ll_forward)[b] = T(wtt::kNeg);
    }
    fill_invalid<T, long long>(s);
    if (h.recv == 1) h.chunk_in += per_pass;
    if (h.send == 1) h.chunk_out += per_pass;
    __syncthreads();  // the edge words and rings of this pass are done with
  }
  cluster_sync();  // no CTA leaves while another may still reach its shared memory
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
           void* ll_backward, void* xedge, unsigned* xflag, int B, int Tmax, int U,
           int compute_betas, cudaStream_t stream) {
  const int dirs = compute_betas ? 2 : 1;
  const Plan p = plan(B, Tmax, U, sizeof(T), dirs, sm_count());
  const T* pb = static_cast<const T*>(lpb);
  const T* pe = static_cast<const T*>(lpe);
  T* al = static_cast<T*>(alphas);
  T* be = static_cast<T*>(betas);
  T* lf = static_cast<T*>(ll_forward);
  T* lb = static_cast<T*>(ll_backward);
  if (p.stripes == 1) {
    auto kernel = p.wide ? wavefront_band_kernel<T, long long> : wavefront_band_kernel<T, int>;
    if (p.smem > 48 * 1024) {
      const cudaError_t err =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
      if (err != cudaSuccess) return (int)err;
    }
    kernel<<<p.blocks, p.threads, p.smem, stream>>>(pb, pe, input_lengths, label_lengths, al, be,
                                                    lf, lb, B, Tmax, U, dirs, p.bands,
                                                    p.per_block);
    return (int)cudaGetLastError();
  }
  if (p.passes > 1 && (xedge == nullptr || xflag == nullptr)) return (int)cudaErrorInvalidValue;
  if (p.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        wavefront_stripe_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.blocks);
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, wavefront_stripe_kernel<T>, pb, pe,
                                             input_lengths, label_lengths, al, be, lf, lb, Tmax,
                                             U, dirs, p.bands, p.stripes, static_cast<T*>(xedge),
                                             xflag);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int attrs(int U, int* regs, int* local_bytes) {
  cudaFuncAttributes a;
  const cudaError_t err = plan(1, 1, U, sizeof(T), 2, 1).stripes == 1
                              ? cudaFuncGetAttributes(&a, wavefront_band_kernel<T, int>)
                              : cudaFuncGetAttributes(&a, wavefront_stripe_kernel<T>);
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
// compute_betas == 0); ll_forward, ll_backward: (B,); xedge, xflag: the
// edge columns between a cluster's passes, (lattices, passes - 1, T) of
// `dtype` and (lattices, passes - 1) int32 zeros (the plan's passes; may be
// null with one pass). Returns the launch's cudaError_t.
int wtt_wavefront(const void* lpb, const void* lpe, int dtype, const int* input_lengths,
                  const int* label_lengths, void* alphas, void* betas, void* ll_forward,
                  void* ll_backward, void* xedge, void* xflag, int B, int T, int U,
                  int compute_betas, void* stream) {
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned* flags = static_cast<unsigned*>(xflag);
  switch (dtype) {
    case wtt::kF32:
      return launch<float>(lpb, lpe, input_lengths, label_lengths, alphas, betas,
                           ll_forward, ll_backward, xedge, flags, B, T, U, compute_betas, s);
    case wtt::kF64:
      return launch<double>(lpb, lpe, input_lengths, label_lengths, alphas, betas,
                            ll_forward, ll_backward, xedge, flags, B, T, U, compute_betas, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The launch plan for B utterances of T frames and U labels, on a card of
// n_sm SMs: out = {bands (warps) a lattice or stripe, lattices a block,
// blocks, threads a block, dynamic shared memory a block, stripes a
// lattice, CTAs a cluster, passes, 64-bit offsets}; all -1 for an unknown
// dtype.
void wtt_wavefront_plan(int B, int T, int U, int dtype, int compute_betas, int n_sm, int* out) {
  const int elt = elt_size(dtype);
  if (elt == 0 || n_sm < 1) {
    for (int i = 0; i < 9; ++i) out[i] = -1;
    return;
  }
  const Plan p = plan(B, T, U, elt, compute_betas ? 2 : 1, n_sm);
  const int v[9] = {p.bands, p.per_block, p.blocks, p.threads, p.smem, p.stripes, p.cluster,
                    p.passes, p.wide};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
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
