// Band lattice kernels: the pruned RNN-T alpha and beta recursions over the
// T rows of each utterance's (T, S) band, t-major.
//
// Replaces: warp_transducer_tpu/ops/pallas/band_stream.py:115
// (_band_kernel, called through stream_panels), which steps (S_pad, B_pad)
// panels of the whole batch, streamed through VMEM in double-buffered
// chunks, with the per-utterance row shift as an unrolled S-way roll
// select. None of that TPU layout is carried over: here one warp walks one
// utterance's rows in one direction.
//
// Mathematics (ops/band.py::forward_backward; the JAX package's
// ops/pruned.py:247-336). Band cell (t, s) is lattice cell
// u = ranges[t] + s. Row t of alpha takes its no-emit term from row t-1 at
// s + δ(t), δ(t) = ranges[t] - ranges[t-1] ∈ [0, S), and solves the emit
// chain within the row in prefix form
//   α(t, s) = c(s) + LSE_{j ≤ s}(ne(j) - c(j)),  c(s) = Σ_{k<s} max(lpe, -1e4),
// beta is the mirror (suffix log-sum-exp, no-emit term from row t+1 at
// s - δ(t+1)), seeded with lpb at the terminal cell. Cells outside
// (t < T_b) & (u < U_b) hold NEG. ll_forward = α + lpb at row T_b-1,
// s* = U_b-1-ranges[T_b-1], and NEG when s* falls outside [0, S) (the
// infeasible band); ll_backward = β(0, 0).
//
// Bound on this card: the chain of T_b dependent rows, not bytes. The
// kernel moves about 4·B·T·S values, which the card streams in
// microseconds, but row t needs row t-1 (alpha) or t+1 (beta).
//
// The row walk (band_row_kernel, S <= 32): a warp a lattice and direction,
// lane s holding band cell s, alpha and beta of one utterance in one block.
// A row step is only its dependent chain; everything else is off it:
// * Inputs two tiles ahead. The rows of lpb, lpe and ranges are
//   contiguous, so a tile of kTileRows rows is one run of R·S floats (R
//   ints). The warp copies each tile by coalesced cp.async (16 bytes where
//   both ends are aligned, 4 at the edges; a tile's words keep their
//   address modulo 16 in shared memory) into a ring of kSlots tiles, as the
//   walk enters the tile kAheadTiles before it; cp.async.wait_group and one
//   __syncwarp a tile are the only synchronisation. No row waits on device
//   memory.
// * What depends only on the inputs is computed ahead, in the row step's
//   one basic block, where it fills the chain's stalls: each step reads the
//   next step's inputs (its lpb, the next range, the lpe of the row after
//   next) and scans that lpe into the exclusive prefix c, by a Hillis–
//   Steele warp scan shifted by one lane (never cumsum - x); δ; the clamps.
//   Beta needs no second pass through shared memory.
// * The chain of a row, in the plain version's order of adds (so that the
//   two round alike where |α| runs into thousands): alpha, the prefix
//   log-sum-exp scan from its second level (z), α = c + z, + lpb, two
//   __shfl_sync by δ that bring cells s and s-1 of the next row's ne (NEG
//   outside the band), - c, and their log-sum-exp, the next row's first
//   scan level; beta the mirror (suffix scan, β = z - c, cells s and s+1 by
//   δ, + lpb, + c). The log-sum-exp is max + log1p(exp(-|a - b|)) with
//   exp2 and log2 on the SFU (ex2/lg2.approx). The scan's steps are
//   unrolled (a kernel instance per ceil(log2 S)), every lane computes each
//   step and a select keeps it, and nothing in the row step branches.
// * Outputs a tile behind. A row parks its results over the lpb words it
//   has consumed (one predicated store); as the walk enters the next tile
//   the warp writes the finished one out with coalesced stores, before its
//   ring slot takes a new copy.
// * Each lattice walks its own T_b rows: alpha stops at T_b - 1, beta
//   starts there; the rows beyond are filled with NEG by coalesced stores.
// What bounds it now is the chain's latency: three shuffles and three
// log-sum-exps of two SFU round trips each, in series, at S = 5
// (scripts/sass_count.sh band_stream: the row steps' instructions).
//
// Numerics: the SFU's log-sum-exp differs from the plain version's
// log1p(exp()) by about 1e-7 absolute a step, below the rounding of |α| >=
// 1, so the two agree to f32 rounding, not bit for bit.
//
// The cells walk (band_cells_kernel: S > 32, or a band past the row walk's
// 32-bit offsets): a block per lattice (utterance and direction), G warps,
// lane l of warp g holding the C consecutive cells from g·32·C + l·C, C odd
// (a template parameter, up to kMaxCells) so that rows read from shared
// memory at a lane stride of C words meet no bank twice. One warp while
// C <= kMaxCells (S <= 544), else G doubled up to kMaxCellWarps; past
// 8·32·17 cells a row goes in chunks of 32·G·C, left to right (alpha) or
// right to left (beta). A step (a row, or a chunk of one):
// * the chain's prefix c within the warp: local sums of the lane's clamped
//   lpe and a 5-step shuffle scan of the lane totals (every warp in its own
//   frame, c = 0 at its first cell);
// * the no-emit terms from the last row, kept in shared memory (two rows of
//   S, device memory past what a block holds), at s + δ (alpha) or s - δ
//   (beta), which may lie in any lane or warp;
// * the log-sum-exp as (max, sum) pairs: a local scan of the lane's C
//   cells, the warp scan of the lane totals, the exclusive carry; with G > 1
//   the warps trade their (pair, chain total) behind one barrier a step,
//   and a pair moves from a warp's frame into the next one's by the chain
//   total between them (the same for the carry between chunks), so that no
//   warp waits on another's prefix; then the fix-up of each cell;
// * one barrier (one warp: __syncwarp) a row, after its values went to the
//   row buffer.
// A step's inputs (lpb, lpe, ranges) are loaded two steps ahead into
// registers; exp and log take the SFU (ex2/lg2.approx) as the row walk's do.
// The plan (the switch, tile rows, warps, cells, chunks, offsets, where the
// rows lie) is `plan` below, mirrored by ops/cuda/band.py::plan;
// wtt_band_plan lets a card test hold the two equal, and
// tests/test_torch_band_plan.py replays both walks' schedules in numpy.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
// Row-chain sentinel of the emit prefix sums (ops/band.py::CLAMP).
constexpr float kClamp = -1.0e4f;

// max(x, kClamp) that keeps a NaN, as torch.clamp_min does.
__device__ __forceinline__ float clamp_chain(float x) { return x < kClamp ? kClamp : x; }

// ---------------------------------------------------------------------------
// The row walk.

constexpr int kMaxRowS = 32;    // the row walk's widest band: a lane a cell
constexpr int kTileRows = 32;   // R, rows a tile (a power of two, a multiple of 4)
constexpr int kAheadTiles = 2;  // tile k + kAheadTiles is copied as the walk enters tile k
constexpr int kSlots = kAheadTiles + 1;
constexpr int kRowLattices = 2;  // a block: alpha and beta of one utterance
// The walk indexes a lattice with 32-bit offsets.
constexpr long long kMaxOffset = 0x7fffffffLL;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Words of one array of a ring slot: n values at a shift of up to 3 words
// (the source's address modulo 16), rounded up to 16 bytes.
__host__ __device__ constexpr int arr_words(int n) { return (n + 6) / 4 * 4; }
// A slot: one tile's lpb (then its results), lpe and ranges.
__host__ __device__ constexpr int slot_words(int S) {
  return 2 * arr_words(kTileRows * S) + arr_words(kTileRows);
}
__host__ __device__ constexpr int lattice_words(int S) { return kSlots * slot_words(S); }

// The cells walk: at most kMaxCellWarps warps a lattice and kMaxCells
// (odd) cells a lane; the exchange of a lattice's warps: two slots (parity)
// of kMaxCellWarps warps' (total m, total s, chain total, unused).
constexpr int kMaxCellWarps = 8;
constexpr int kMaxCells = 17;
constexpr int kCellXch = 2 * kMaxCellWarps * 4;
constexpr int kSmemMax = 232448;  // a block's shared memory on sm_90

struct Plan {
  int row_mode;     // 1: the row walk; 0: the cells walk
  int tile_rows;    // rows a tile (row mode)
  int slots;        // ring slots, tiles (row mode)
  int ahead;        // copy distance, tiles (row mode)
  int per_block;    // lattices a block
  int blocks;
  int threads;
  int smem;         // dynamic shared memory a block, bytes
  int warps;        // G, warps a lattice (cells walk)
  int cells;        // C, cells a lane (cells walk)
  int chunks;       // chunks of 32·G·C cells a row (cells walk)
  int offsets64;    // 64-bit offsets inside a lattice (cells walk)
  int rows_device;  // the two rows of a lattice in device memory, 2·S values (cells walk)
};

// C for n cells a warp: the least odd number with 32·C >= n.
int cells_for(int n) {
  const int c = (n + wtt::kWarp - 1) / wtt::kWarp;
  return c + 1 - c % 2;
}

// The row walk where S <= 32 and its 32-bit offsets reach; else the cells
// walk: one warp while C <= kMaxCells, else G doubled up to kMaxCellWarps,
// past which a row goes in chunks of 32·G·kMaxCells cells; its two rows in
// shared memory where they fit, else in device memory.
Plan plan(int B, int T, int S) {
  Plan p{};
  if (S <= kMaxRowS && (long long)(T + 2 * kTileRows) * S <= kMaxOffset) {
    p.row_mode = 1;
    p.tile_rows = kTileRows;
    p.slots = kSlots;
    p.ahead = kAheadTiles;
    p.per_block = kRowLattices;
    p.blocks = B;
    p.threads = kRowLattices * wtt::kWarp;
    p.smem = kRowLattices * lattice_words(S) * (int)sizeof(float);
    return p;
  }
  int G = 1, C = cells_for(S);
  while (C > kMaxCells && G < kMaxCellWarps) {
    G *= 2;
    C = cells_for((S + G - 1) / G);
  }
  C = C < kMaxCells ? C : kMaxCells;
  const long long rows = 2LL * S + kCellXch;
  p.per_block = 1;
  p.blocks = 2 * B;
  p.threads = G * wtt::kWarp;
  p.warps = G;
  p.cells = C;
  p.chunks = (S + G * wtt::kWarp * C - 1) / (G * wtt::kWarp * C);
  p.offsets64 = (long long)(T + 2) * S > kMaxOffset;
  p.rows_device = rows * (long long)sizeof(float) > kSmemMax;
  p.smem = (int)((p.rows_device ? kCellXch : rows) * sizeof(float));
  return p;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void copy4(const void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void copy16(const void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// Every copy but those of the newest kAheadTiles - 1 tiles has landed.
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kAheadTiles - 1) : "memory");
}
__device__ __forceinline__ void copy_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Words from the start of p to its next 16-byte boundary, at most n.
__device__ __forceinline__ int head_words(const void* p, int n) {
  return min(n, (int)(((16u - ((unsigned)(uintptr_t)p & 15u)) & 15u) >> 2));
}
__device__ __forceinline__ bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// The warp copies n 4-byte words src[0, n) (device) to dst[0, n) (shared):
// 16 bytes a lane where both sides are aligned, else a word.
template <typename W>
__device__ __forceinline__ void copy_words(W* dst, const W* src, int n, int lane) {
  int head = head_words(src, n);
  if (!aligned16(dst + head)) head = n;
  const int body = (n - head) & ~3;
#pragma unroll 1
  for (int i = lane; i < head; i += wtt::kWarp) copy4(dst + i, src + i);
#pragma unroll 1
  for (int i = head + 4 * lane; i < head + body; i += 4 * wtt::kWarp) copy16(dst + i, src + i);
#pragma unroll 1
  for (int i = head + body + lane; i < n; i += wtt::kWarp) copy4(dst + i, src + i);
}

// The warp stores n words src[0, n) (shared) to dst[0, n) (device), 16
// bytes a lane where both sides are aligned.
__device__ __forceinline__ void store_words(float* dst, const float* src, int n, int lane) {
  int head = head_words(dst, n);
  if (!aligned16(src + head)) head = n;
  const int body = (n - head) & ~3;
#pragma unroll 1
  for (int i = lane; i < head; i += wtt::kWarp) dst[i] = src[i];
#pragma unroll 1
  for (int i = head + 4 * lane; i < head + body; i += 4 * wtt::kWarp)
    *reinterpret_cast<float4*>(dst + i) = *reinterpret_cast<const float4*>(src + i);
#pragma unroll 1
  for (int i = head + body + lane; i < n; i += wtt::kWarp) dst[i] = src[i];
}

// The warp fills dst[0, n) (device) with NEG.
__device__ __forceinline__ void fill_neg(float* dst, int n, int lane) {
  const float neg = float(wtt::kNeg);
  const int head = head_words(dst, n);
  const int body = (n - head) & ~3;
#pragma unroll 1
  for (int i = lane; i < head; i += wtt::kWarp) dst[i] = neg;
#pragma unroll 1
  for (int i = head + 4 * lane; i < head + body; i += 4 * wtt::kWarp)
    *reinterpret_cast<float4*>(dst + i) = make_float4(neg, neg, neg, neg);
#pragma unroll 1
  for (int i = head + body + lane; i < n; i += wtt::kWarp) dst[i] = neg;
}

// log(exp(a) + exp(b)) for finite inputs (NEG-level ones included) in the
// plain version's form, max + log1p(exp(-|a - b|)), with exp2 and log2 on
// the SFU (ex2.approx, lg2.approx), branch-free.
__device__ __forceinline__ float lse(float a, float b) {
  float e, l;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(fabsf(a - b) * -kLog2e));
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(l) : "f"(1.0f + e));
  return fmaf(l, kLn2, fmaxf(a, b));
}

// Inclusive prefix (lanes < S) and suffix (lanes < S) log-sum-exp scans,
// Hillis–Steele: steps first .. L2 - 1 of the ceil(log2 S).
// Every lane computes each step's log-sum-exp, and a select keeps it: a
// conditional around the SFU calls would be a divergent branch a step.
template <int L2, int first = 0>
__device__ __forceinline__ float scan_up(float y, int lane) {
#pragma unroll
  for (int i = first; i < L2; ++i) {
    const float z = lse(y, __shfl_up_sync(kFull, y, 1 << i));
    y = lane >= (1 << i) ? z : y;
  }
  return y;
}
template <int L2, int first = 0>
__device__ __forceinline__ float scan_down(float y, int lane, int S) {
#pragma unroll
  for (int i = first; i < L2; ++i) {
    const float z = lse(y, __shfl_down_sync(kFull, y, 1 << i));
    y = lane + (1 << i) < S ? z : y;
  }
  return y;
}

// Exclusive prefix sum over the lanes (x = 0 beyond the band): the
// inclusive Hillis–Steele scan shifted by one lane, 0 at lane 0.
template <int L2>
__device__ __forceinline__ float excl_sum(float x, int lane) {
#pragma unroll
  for (int i = 0; i < L2; ++i) {
    const float z = x + __shfl_up_sync(kFull, x, 1 << i);
    x = lane >= (1 << i) ? z : x;
  }
  const float c = __shfl_up_sync(kFull, x, 1);
  return lane == 0 ? 0.f : c;
}

// A store to shared memory by the lanes where `on`, as one predicated
// instruction (a conditional store would be a branch in the row step). The
// "memory" clobber keeps the compiler from moving loads of the ring across
// it (write_tile reads these words after a __syncwarp).
__device__ __forceinline__ void store_if(float* p, float v, bool on) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n @p st.shared.f32 [%0], %1;\n}\n" ::"r"(
          smem_addr(p)),
      "f"(v), "r"((int)on)
      : "memory");
}

// One lattice (utterance and direction) and its ring of tiles.
struct Walk {
  const float* pb;  // the lattice's lpb, lpe (T, S), ranges (T,)
  const float* pe;
  const int* pr;
  float* out;       // its alphas or betas
  float* ring;      // kSlots slots of slot_words(S)
  int T, S, Tb, Ub, Tw;  // Tw = min(max(T_b, 0), T), the rows walked
  int shb, she, shr;     // the sources' word offsets modulo 16 bytes

  __device__ int slot(int tile) const { return (int)((unsigned)tile % kSlots) * slot_words(S); }
  // Word offsets in the ring of tile `tile`'s lpb (then results), lpe and ranges.
  __device__ int b_base(int tile) const { return slot(tile) + shb; }
  __device__ int e_base(int tile) const { return slot(tile) + arr_words(kTileRows * S) + she; }
  __device__ int r_base(int tile) const {
    return slot(tile) + 2 * arr_words(kTileRows * S) + shr;
  }
  __device__ int tile_rows(int tile) const { return min(kTileRows, Tw - tile * kTileRows); }
  // Copy tile `tile`'s rows below Tw into its slot (one commit group).
  __device__ void copy_tile(int tile, int lane) const {
    const int t0 = tile * kTileRows, n = tile_rows(tile);
    copy_words(ring + b_base(tile), pb + t0 * S, n * S, lane);
    copy_words(ring + e_base(tile), pe + t0 * S, n * S, lane);
    copy_words(reinterpret_cast<int*>(ring) + r_base(tile), pr + t0, n, lane);
  }
  // Write out the results parked in tile `tile`'s slot.
  __device__ void write_tile(int tile, int lane) const {
    store_words(out + tile * kTileRows * S, ring + b_base(tile), tile_rows(tile) * S, lane);
  }
};

// Alpha over rows 0 .. Tw-1; ll_forward at the terminal cell. Row t's
// inputs (its lpb, ranges[t+1], the lpe of row t+2) are read in the step
// before, so that no shared-memory latency stands before the chain. The
// chain adds in the plain version's order (α = c + z, α + lpb, shifted,
// - c), so that the two round alike at the magnitudes of long bands.
template <int L2>
__device__ void alpha_walk(const Walk& w, int lane, float* __restrict__ llf) {
  const int S = w.S, sc = min(lane, S - 1);
  const bool cell = lane < S;
  const float neg = float(wtt::kNeg);
  const int tiles = (w.Tw + kTileRows - 1) / kTileRows;
  float* const ring = w.ring;
  const int* const iring = reinterpret_cast<const int*>(w.ring);
  w.copy_tile(0, lane);
  copy_commit();
  w.copy_tile(1, lane);
  copy_commit();
  float y = 0.f;             // the chain: row t's ne - c after the scan's first level
  float c0 = 0.f, c1 = 0.f;  // c of rows t and t+1
  int r0 = 0, r1 = 0;        // ranges[t], ranges[t+1]
  float b = 0.f, e2 = 0.f;   // lpb of row t, lpe of row t+2, as read
  float a_last = neg, b_last = 0.f;
  int r_last = 0;
  for (int k = 0; k < tiles; ++k) {
    if (k > 0) {
      __syncwarp();
      w.write_tile(k - 1, lane);
      __syncwarp();
    }
    if (k + kAheadTiles < tiles) w.copy_tile(k + kAheadTiles, lane);
    copy_commit();
    copy_wait();  // tiles k and k+1 have landed
    __syncwarp();
    // Row kR + i of tile k, or of tile k+1 for i >= R.
    const int bk = w.b_base(k), bn = w.b_base(k + 1) - kTileRows * S;
    const int ek = w.e_base(k), en = w.e_base(k + 1) - kTileRows * S;
    const int qk = w.r_base(k), qn = w.r_base(k + 1) - kTileRows;
    auto lpb_at = [&](int i) { return (i < kTileRows ? bk : bn) + i * S; };
    auto lpe_at = [&](int i) { return (i < kTileRows ? ek : en) + i * S; };
    auto range_at = [&](int i) { return iring[(i < kTileRows ? qk : qn) + i]; };
    if (k == 0) {
      r0 = range_at(0);
      r1 = range_at(1);
      c0 = excl_sum<L2>(cell ? clamp_chain(ring[lpe_at(0) + sc]) : 0.f, lane);
      c1 = excl_sum<L2>(cell ? clamp_chain(ring[lpe_at(1) + sc]) : 0.f, lane);
      b = ring[lpb_at(0) + sc];
      e2 = ring[lpe_at(2) + sc];
      // Row 0: ne = 0 at s = 0, NEG elsewhere; its first scan level.
      y = scan_up<(L2 > 0 ? 1 : 0)>((lane == 0 ? 0.f : neg) - c0, lane);
    }
    const int n = w.tile_rows(k);
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      // Off the chain: the neighbour's c of row t+1 (its first scan level
      // takes cells s and s-1).
      const float c1m = __shfl_up_sync(kFull, c1, 1);
      const float bc = wtt::clamp_neg(b);
      const int d1 = r1 - r0;  // δ(t+1)
      // The chain: the scan's levels from 1, α = c + z, + lpb, the shuffle
      // by δ of cells s and s-1 of row t+1, - c, their log-sum-exp.
      const float a = c0 + scan_up<L2, 1>(y, lane);
      const float p = a + bc;
      const float n0 = __shfl_sync(kFull, p, lane + d1);
      const float n1 = __shfl_sync(kFull, p, lane + d1 - 1);
      // Off the chain: the cell's alpha, parked over its lpb; the prefix of
      // row t+2; the next step's inputs.
      store_if(ring + lpb_at(i) + lane, r0 + lane < w.Ub ? a : neg, cell);
      a_last = r0 + lane < w.Ub ? a : neg;
      b_last = bc;
      r_last = r0;
      const float c2 = excl_sum<L2>(cell ? clamp_chain(e2) : 0.f, lane);
      b = ring[lpb_at(i + 1) + sc];
      const int r2 = range_at(i + 2);
      e2 = ring[lpe_at(i + 3) + sc];
      y = (lane + d1 < S ? n0 : neg) - c1;
      if (L2 > 0) y = lse(y, (lane >= 1 && lane + d1 - 1 < S ? n1 : neg) - c1m);
      c0 = c1;
      c1 = c2;
      r0 = r1;
      r1 = r2;
    }
  }
  __syncwarp();
  if (tiles > 0) w.write_tile(tiles - 1, lane);
  fill_neg(w.out + w.Tw * S, (w.T - w.Tw) * S, lane);
  // ll_forward: alpha + lpb at s* of row T_b - 1, NEG for an infeasible band.
  const int s_star = w.Ub - 1 - r_last;
  const bool feasible = w.Tw > 0 && w.Tb == w.Tw && s_star >= 0 && s_star < S;
  const float ll = __shfl_sync(kFull, a_last + b_last, s_star & (wtt::kWarp - 1));
  if (lane == 0) *llf = feasible ? ll : neg;
  copy_wait_all();
}

// Beta over rows Tw-1 .. 0, seeded at the terminal cell; ll_backward =
// β(0, 0). Row t's inputs (the lpb and range of row t-1, the lpe of row
// t-2) are read in the step before; the chain adds in the plain version's
// order (β = z - c, shifted, + lpb, + c).
template <int L2>
__device__ void beta_walk(const Walk& w, int lane, float* __restrict__ llb) {
  const int S = w.S, sc = min(lane, S - 1);
  const bool cell = lane < S;
  const float neg = float(wtt::kNeg);
  const int tiles = (w.Tw + kTileRows - 1) / kTileRows, top = tiles - 1;
  float* const ring = w.ring;
  const int* const iring = reinterpret_cast<const int*>(w.ring);
  if (tiles > 0) w.copy_tile(top, lane);
  copy_commit();
  if (top >= 1) w.copy_tile(top - 1, lane);
  copy_commit();
  float y = 0.f;             // the chain: row t's ne + c after the scan's first level
  float c0 = 0.f, c1 = 0.f;  // c of rows t and t-1
  int r0 = 0, r1 = 0;        // ranges[t], ranges[t-1]
  float b1 = 0.f, e2 = 0.f;  // lpb of row t-1, lpe of row t-2, as read
  float b00 = neg;
  for (int k = top; k >= 0; --k) {
    if (k < top) {
      __syncwarp();
      w.write_tile(k + 1, lane);
      __syncwarp();
    }
    if (k - kAheadTiles >= 0) w.copy_tile(k - kAheadTiles, lane);
    copy_commit();
    copy_wait();  // tiles k and k-1 have landed
    __syncwarp();
    // Row kR + i of tile k, or of tile k-1 for i < 0 (row 0 below tile 0).
    const int bk = w.b_base(k), bp = k > 0 ? w.b_base(k - 1) + kTileRows * S : bk;
    const int ek = w.e_base(k), ep = k > 0 ? w.e_base(k - 1) + kTileRows * S : ek;
    const int qk = w.r_base(k), qp = k > 0 ? w.r_base(k - 1) + kTileRows : qk;
    const int lo = k > 0 ? -kTileRows : 0;
    auto lpb_at = [&](int i) { return i >= 0 ? bk + i * S : bp + max(i, lo) * S; };
    auto lpe_at = [&](int i) { return i >= 0 ? ek + i * S : ep + max(i, lo) * S; };
    auto range_at = [&](int i) { return iring[i >= 0 ? qk + i : qp + max(i, lo)]; };
    const int n = w.tile_rows(k);
    if (k == top) {
      const int i = n - 1;  // row Tw - 1
      r0 = range_at(i);
      r1 = range_at(i - 1);
      c0 = excl_sum<L2>(cell ? clamp_chain(ring[lpe_at(i) + sc]) : 0.f, lane);
      c1 = excl_sum<L2>(cell ? clamp_chain(ring[lpe_at(i - 1) + sc]) : 0.f, lane);
      // No row below the walk: ne = NEG + lpb, and lpb at the terminal cell,
      // if it lies in this row; then the first scan level.
      const float bt = wtt::clamp_neg(ring[lpb_at(i) + sc]);
      const bool seed = w.Tb == w.Tw && lane == w.Ub - 1 - r0;
      y = scan_down<(L2 > 0 ? 1 : 0)>((seed ? bt : neg + bt) + c0, lane, S);
      b1 = ring[lpb_at(i - 1) + sc];
      e2 = ring[lpe_at(i - 2) + sc];
    }
#pragma unroll 1
    for (int i = n - 1; i >= 0; --i) {
      // Off the chain: row t-1's lpb and c, and those of the cell to the
      // right (its first scan level takes cells s and s+1).
      const float bc1 = wtt::clamp_neg(b1);
      const float bc1n = __shfl_down_sync(kFull, bc1, 1);
      const float c1n = __shfl_down_sync(kFull, c1, 1);
      const int d = r0 - r1;  // δ(t)
      // The chain: the scan's levels from 1, β = z - c, the shuffle by δ
      // of cells s and s+1 of row t-1, + lpb, + c, their log-sum-exp.
      const float bv = scan_down<L2, 1>(y, lane, S) - c0;
      const float n0 = __shfl_sync(kFull, bv, lane - d);
      const float n1 = __shfl_sync(kFull, bv, lane + 1 - d);
      // Off the chain: the cell's beta, parked over its lpb (read two steps
      // ago); the prefix of row t-2; the next step's inputs.
      const float out = r0 + lane < w.Ub ? bv : neg;
      store_if(ring + lpb_at(i) + lane, out, cell);
      b00 = out;
      const float c2 = excl_sum<L2>(cell ? clamp_chain(e2) : 0.f, lane);
      b1 = ring[lpb_at(i - 2) + sc];
      const int r2 = range_at(i - 2);
      e2 = ring[lpe_at(i - 3) + sc];
      y = ((lane - d >= 0 ? n0 : neg) + bc1) + c1;
      if (L2 > 0) y = lse(y, ((lane + 1 < S && lane + 1 - d >= 0 ? n1 : neg) + bc1n) + c1n);
      c0 = c1;
      c1 = c2;
      r0 = r1;
      r1 = r2;
    }
  }
  __syncwarp();
  if (tiles > 0) w.write_tile(0, lane);
  fill_neg(w.out + w.Tw * S, (w.T - w.Tw) * S, lane);
  if (lane == 0) *llb = b00;  // row 0's cell 0, NEG where invalid or nothing walked
  copy_wait_all();
}

// Grid: a block per utterance, warp 0 alpha, warp 1 beta.
template <int L2>
__global__ void __launch_bounds__(kRowLattices * wtt::kWarp, 1)
    band_row_kernel(const float* __restrict__ lpb, const float* __restrict__ lpe,
                    const int* __restrict__ ranges, const int* __restrict__ input_lengths,
                    const int* __restrict__ label_lengths, float* __restrict__ alphas,
                    float* __restrict__ betas, float* __restrict__ ll_forward,
                    float* __restrict__ ll_backward, int T, int S) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / wtt::kWarp, lane = threadIdx.x % wtt::kWarp;
  const int b = blockIdx.x;
  const long long base = (long long)b * T * S;
  Walk w;
  w.pb = lpb + base;
  w.pe = lpe + base;
  w.pr = ranges + (long long)b * T;
  w.out = (warp == 0 ? alphas : betas) + base;
  w.ring = smem + warp * lattice_words(S);
  w.T = T;
  w.S = S;
  w.Tb = input_lengths[b];
  w.Ub = label_lengths[b] + 1;
  w.Tw = min(max(w.Tb, 0), T);
  w.shb = (int)(((uintptr_t)w.pb >> 2) & 3);
  w.she = (int)(((uintptr_t)w.pe >> 2) & 3);
  w.shr = (int)(((uintptr_t)w.pr >> 2) & 3);
  if (warp == 0)
    alpha_walk<L2>(w, lane, ll_forward + b);
  else
    beta_walk<L2>(w, lane, ll_backward + b);
}

// ---------------------------------------------------------------------------
// The cells walk: band_cells_kernel, a block per lattice (utterance and
// direction), G warps, C cells a lane (the file's header says how it walks).

__device__ __forceinline__ float fast_exp(float x) {
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(x * kLog2e));
  return e;
}
__device__ __forceinline__ float fast_log(float x) {
  float l;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(l) : "f"(x));
  return l * kLn2;
}

// m + log(s): a log-sum-exp in progress; (lowest, 0) is the empty sum and
// joins with anything to give it back.
struct Pair {
  float m, s;
};
__device__ __forceinline__ Pair empty() { return {-FLT_MAX, 0.f}; }
__device__ __forceinline__ float value(Pair p) { return p.m + fast_log(p.s); }
// a ⊕ b, one exp.
__device__ __forceinline__ Pair join(Pair a, Pair b) {
  const float d = a.m - b.m;
  const float e = fast_exp(-fabsf(d));
  if (d >= 0.f) return {a.m, fmaf(b.s, e, a.s)};
  return {b.m, fmaf(a.s, e, b.s)};
}
// A pair moved into a frame whose chain starts `by` later (m + by).
__device__ __forceinline__ Pair shift(Pair p, float by) { return {p.m + by, p.s}; }
__device__ __forceinline__ Pair pick(bool c, Pair a, Pair b) {
  return {c ? a.m : b.m, c ? a.s : b.s};
}
__device__ __forceinline__ Pair shfl_up(Pair p, int d) {
  return {__shfl_up_sync(kFull, p.m, d), __shfl_up_sync(kFull, p.s, d)};
}
__device__ __forceinline__ Pair shfl_down(Pair p, int d) {
  return {__shfl_down_sync(kFull, p.m, d), __shfl_down_sync(kFull, p.s, d)};
}
__device__ __forceinline__ Pair shfl(Pair p, int lane) {
  return {__shfl_sync(kFull, p.m, lane), __shfl_sync(kFull, p.s, lane)};
}

// One lattice of the cells walk: its inputs and outputs from the
// utterance's first row, offsets inside it of type Off.
template <typename Off>
struct CellWalk {
  const float* pb;  // lpb, lpe (T, S), ranges (T,)
  const float* pe;
  const int* pr;
  float* out;   // its alphas or betas
  float* rows;  // [2][S]: the last two rows (shared memory, or device memory past it)
  float* xch;   // [2][kMaxCellWarps][4], shared
  int T, S, Tb, Ub, Tw, G, g, lane, u0, CW, nch;
};

// The inputs of one step (row t, chunk k) at the lane's cells: lpb and lpe
// (0 beyond the band) and ranges[t]; nothing is read for t outside [0, Tw).
template <int C>
struct Inputs {
  float b[C], e[C];
  int r;
};
template <int C, typename Off>
__device__ __forceinline__ void load_inputs(const CellWalk<Off>& w, int t, int k, Inputs<C>& in) {
  if (t < 0 || t >= w.Tw) return;
  const int s0 = k * w.CW + w.u0;
  const Off row = (Off)t * w.S;
#pragma unroll
  for (int j = 0; j < C; ++j) {
    const bool on = s0 + j < w.S;
    in.b[j] = on ? w.pb[row + s0 + j] : 0.f;
    in.e[j] = on ? w.pe[row + s0 + j] : 0.f;
  }
  in.r = w.pr[t];
}

// The lattice's warps meet (a lattice of one warp: its __syncwarp); the
// rows written before are visible after.
template <typename Off>
__device__ __forceinline__ void lattice_sync(const CellWalk<Off>& w) {
  if (w.G > 1)
    __syncthreads();
  else
    __syncwarp();
}

// The chain's exclusive prefix c within the warp (the warp's frame: c = 0
// at its first cell): local sums of the clamped lpe (0 beyond the band),
// then the lane totals' exclusive Hillis–Steele warp scan (the inclusive
// scan shifted by one lane). Returns the warp's chain total on every lane.
template <int C>
__device__ __forceinline__ float warp_chain(const float (&e)[C], int s0, int S, int lane,
                                            float (&c)[C]) {
  float run = 0.f;
#pragma unroll
  for (int j = 0; j < C; ++j) {
    c[j] = run;
    run += s0 + j < S ? clamp_chain(e[j]) : 0.f;
  }
  float incl = run;
#pragma unroll
  for (int sh = 1; sh < wtt::kWarp; sh <<= 1) {
    const float o = __shfl_up_sync(kFull, incl, sh);
    incl += lane >= sh ? o : 0.f;
  }
  const float ex = __shfl_up_sync(kFull, incl, 1);
#pragma unroll
  for (int j = 0; j < C; ++j) c[j] += lane == 0 ? 0.f : ex;
  return __shfl_sync(kFull, incl, wtt::kWarp - 1);
}

// Alpha over rows 0 .. Tw-1, each row in chunks of CW cells, left to right.
template <int C, typename Off>
__device__ void cells_alpha(const CellWalk<Off>& w, float* __restrict__ llf) {
  const float neg = float(wtt::kNeg);
  const int S = w.S, lane = w.lane, n = w.Tw * w.nch;
  Inputs<C> in0, in1;
  load_inputs<C>(w, 0, 0, in0);
  load_inputs<C>(w, 1 / w.nch, 1 % w.nch, in1);
  Pair chunk = empty();  // the row's earlier chunks, in this chunk's frame
  int r_row = 0, delta = 0;
  float ll_val = neg;
  bool owner = false;
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    const int t = i / w.nch, k = i - t * w.nch;
    const Inputs<C> in = in0;
    in0 = in1;
    load_inputs<C>(w, (i + 2) / w.nch, (i + 2) % w.nch, in1);  // two steps ahead
    if (k == 0) {
      if (t > 0) lattice_sync(w);  // row t - 1 is in w.rows
      delta = t > 0 ? in.r - r_row : 0;
      r_row = in.r;
      chunk = empty();
    }
    const float* prev = w.rows + ((t + 1) & 1) * S;
    float* next = w.rows + (t & 1) * S;
    const int s0 = k * w.CW + w.u0;
    float c[C];
    const float ctot = warp_chain<C>(in.e, s0, S, lane, c);
    // The terms ne - c: the no-emit arrival from row t - 1 at s + δ (NEG
    // outside the band; row 0 starts at s = 0), and their local inclusive
    // scan.
    Pair p[C];
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int s = s0 + j, src = s + delta;
      const float ne = t == 0 ? (s == 0 ? 0.f : neg) : (src < S ? prev[src] : neg);
      p[j] = {ne - c[j], 1.f};
      if (j > 0) p[j] = join(p[j - 1], p[j]);
    }
    // The lane totals' inclusive warp scan, the exclusive carry.
    Pair tot = p[C - 1];
#pragma unroll
    for (int sh = 1; sh < wtt::kWarp; sh <<= 1) tot = pick(lane >= sh, join(shfl_up(tot, sh), tot), tot);
    Pair carry = pick(lane == 0, empty(), shfl_up(tot, 1));
    const Pair wtot = shfl(tot, wtt::kWarp - 1);
    // The earlier chunks and warps, moved into this warp's frame (warp h's
    // total reaches the next warp's frame shifted by h's chain total); the
    // next chunk's carry.
    Pair before = chunk;
    if (w.G > 1) {
      const int par = i & 1;
      if (lane == wtt::kWarp - 1) {
        float* x = w.xch + (par * kMaxCellWarps + w.g) * 4;
        x[0] = wtot.m;
        x[1] = wtot.s;
        x[2] = ctot;
      }
      __syncthreads();
      Pair acc = chunk;
      for (int h = 0; h < w.G; ++h) {
        const float* x = w.xch + (par * kMaxCellWarps + h) * 4;
        if (h == w.g) before = acc;
        acc = shift(join(acc, Pair{x[0], x[1]}), x[2]);
      }
      chunk = acc;
    } else {
      chunk = shift(join(chunk, wtot), ctot);
    }
    carry = join(before, carry);
    // α = c + LSE; band cells outside the lattice hold NEG; the row goes
    // out and, with its lpb, into w.rows for the next row.
    const Off row = (Off)t * S;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int s = s0 + j;
      const float a = c[j] + value(join(carry, p[j]));
      const float av = in.r + s < w.Ub ? a : neg;
      const float bc = wtt::clamp_neg(in.b[j]);
      if (s < S) {
        w.out[row + s] = av;
        next[s] = av + bc;
      }
      if (s < S && t == w.Tb - 1 && in.r + s == w.Ub - 1) {
        ll_val = av + bc;
        owner = true;
      }
    }
  }
  // ll_forward: α + lpb at s* of row T_b - 1, NEG for an infeasible band.
  const int s_star = w.Ub - 1 - r_row;
  const bool feasible = w.Tw > 0 && w.Tb == w.Tw && s_star >= 0 && s_star < S;
  if (feasible ? owner : (w.g == 0 && lane == 0)) *llf = feasible ? ll_val : neg;
}

// Beta over rows Tw-1 .. 0, each row in chunks of CW cells, right to left;
// seeded by lpb at the terminal cell; ll_backward = β(0, 0).
template <int C, typename Off>
__device__ void cells_beta(const CellWalk<Off>& w, float* __restrict__ llb) {
  const float neg = float(wtt::kNeg);
  const int S = w.S, lane = w.lane, n = w.Tw * w.nch, nch = w.nch;
  // Step i: row Tw - 1 - i / nch, chunk nch - 1 - i % nch.
  Inputs<C> in0, in1;
  load_inputs<C>(w, w.Tw - 1, nch - 1, in0);
  load_inputs<C>(w, w.Tw - 1 - 1 / nch, nch - 1 - 1 % nch, in1);
  Pair chunk = empty();  // the row's later chunks, in the next chunk's frame
  int r_row = 0, delta = 0;
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    const int t = w.Tw - 1 - i / nch, k = nch - 1 - i % nch;
    const Inputs<C> in = in0;
    in0 = in1;
    load_inputs<C>(w, w.Tw - 1 - (i + 2) / nch, nch - 1 - (i + 2) % nch, in1);
    const bool has_next = t + 1 < w.Tw;
    if (k == nch - 1) {
      if (i > 0) lattice_sync(w);  // row t + 1 is in w.rows
      delta = has_next ? r_row - in.r : 0;  // δ(t + 1)
      r_row = in.r;
      chunk = empty();
    }
    const float* prev = w.rows + ((t + 1) & 1) * S;
    float* next = w.rows + (t & 1) * S;
    const int s0 = k * w.CW + w.u0;
    float c[C];
    const float ctot = warp_chain<C>(in.e, s0, S, lane, c);
    // The terms nb + c: β of row t + 1 at s - δ(t + 1) (NEG outside the
    // band and below the walk) plus lpb, the bare lpb at the terminal cell;
    // nothing beyond the band; their local inclusive suffix scan.
    Pair p[C];
#pragma unroll
    for (int j = C - 1; j >= 0; --j) {
      const int s = s0 + j, src = s - delta;
      const float bc = wtt::clamp_neg(in.b[j]);
      float nb = (has_next && src >= 0 && src < S ? prev[src] : neg) + bc;
      nb = t == w.Tb - 1 && in.r + s == w.Ub - 1 ? bc : nb;
      p[j] = s < S ? Pair{nb + c[j], 1.f} : empty();
      if (j < C - 1) p[j] = join(p[j + 1], p[j]);
    }
    Pair tot = p[0];
#pragma unroll
    for (int sh = 1; sh < wtt::kWarp; sh <<= 1)
      tot = pick(lane + sh < wtt::kWarp, join(shfl_down(tot, sh), tot), tot);
    Pair carry = pick(lane == wtt::kWarp - 1, empty(), shfl_down(tot, 1));
    const Pair wtot = shfl(tot, 0);
    // The later warps and chunks, moved into this warp's frame (a pair
    // moves into the frame of the warp before by that warp's chain total);
    // the carry of the chunk before, in this chunk's frame.
    Pair after = shift(chunk, ctot);
    if (w.G > 1) {
      const int par = i & 1;
      if (lane == 0) {
        float* x = w.xch + (par * kMaxCellWarps + w.g) * 4;
        x[0] = wtot.m;
        x[1] = wtot.s;
        x[2] = ctot;
      }
      __syncthreads();
      Pair acc = chunk;
      for (int h = w.G - 1; h >= 0; --h) {
        const float* x = w.xch + (par * kMaxCellWarps + h) * 4;
        acc = shift(acc, x[2]);
        if (h == w.g) after = acc;
        acc = join(acc, Pair{x[0], x[1]});
      }
      chunk = acc;
    } else {
      chunk = join(after, wtot);
    }
    carry = join(after, carry);
    const Off row = (Off)t * S;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int s = s0 + j;
      const float bv = value(join(carry, p[j])) - c[j];
      const float out = in.r + s < w.Ub ? bv : neg;
      if (s < S) {
        w.out[row + s] = out;
        next[s] = out;
      }
      if (t == 0 && s == 0) *llb = out;
    }
  }
  if (w.Tw == 0 && w.g == 0 && lane == 0) *llb = neg;
}

// Grid: a block per lattice, 2·B: utterance i / 2, alpha (even) or beta;
// G warps a block. `rows`: device memory for the lattices' two rows where
// they do not fit the block's shared memory (2·S values a lattice), else
// null.
template <int C, typename Off>
__global__ void __launch_bounds__(kMaxCellWarps * wtt::kWarp, 1)
    band_cells_kernel(const float* __restrict__ lpb, const float* __restrict__ lpe,
                      const int* __restrict__ ranges, const int* __restrict__ input_lengths,
                      const int* __restrict__ label_lengths, float* __restrict__ alphas,
                      float* __restrict__ betas, float* __restrict__ ll_forward,
                      float* __restrict__ ll_backward, int T, int S, int G, float* rows) {
  extern __shared__ __align__(16) float smem[];
  const int lattice = blockIdx.x, b = lattice / 2;
  const bool is_beta = lattice % 2 == 1;
  const long long base = (long long)b * T * S;
  CellWalk<Off> w;
  w.pb = lpb + base;
  w.pe = lpe + base;
  w.pr = ranges + (long long)b * T;
  w.out = (is_beta ? betas : alphas) + base;
  w.xch = smem;
  w.rows = rows != nullptr ? rows + (long long)lattice * 2 * S : smem + kCellXch;
  w.T = T;
  w.S = S;
  w.Tb = input_lengths[b];
  w.Ub = label_lengths[b] + 1;
  w.Tw = min(max(w.Tb, 0), T);
  w.G = G;
  w.g = threadIdx.x / wtt::kWarp;
  w.lane = threadIdx.x % wtt::kWarp;
  w.u0 = w.g * wtt::kWarp * C + w.lane * C;
  w.CW = G * wtt::kWarp * C;
  w.nch = (S + w.CW - 1) / w.CW;
  if (is_beta)
    cells_beta<C, Off>(w, ll_backward + b);
  else
    cells_alpha<C, Off>(w, ll_forward + b);
  // The rows beyond T_b, coalesced.
  const float neg = float(wtt::kNeg);
  for (Off x = (Off)w.Tw * S + threadIdx.x; x < (Off)T * S; x += blockDim.x) w.out[x] = neg;
}

// ---------------------------------------------------------------------------
// Launch.

using RowKernel = void (*)(const float*, const float*, const int*, const int*, const int*,
                          float*, float*, float*, float*, int, int);
using CellsKernel = void (*)(const float*, const float*, const int*, const int*, const int*,
                             float*, float*, float*, float*, int, int, int, float*);

// The row walk's instance for a band of S <= kMaxRowS: ceil(log2 S) scan steps.
RowKernel row_kernel(int S) {
  int steps = 0;
  while ((1 << steps) < S) ++steps;
  switch (steps) {
    case 0: return band_row_kernel<0>;
    case 1: return band_row_kernel<1>;
    case 2: return band_row_kernel<2>;
    case 3: return band_row_kernel<3>;
    case 4: return band_row_kernel<4>;
    default: return band_row_kernel<5>;
  }
}

// The cells walk's instance of C cells a lane: C = C0, C0 + 2, ... up to
// kMaxCells.
template <int C, typename Off>
CellsKernel cells_kernel_of(int cells) {
  if (cells == C) return band_cells_kernel<C, Off>;
  if constexpr (C + 2 <= kMaxCells) return cells_kernel_of<C + 2, Off>(cells);
  return nullptr;
}
CellsKernel cells_kernel(const Plan& p) {
  return p.offsets64 ? cells_kernel_of<1, long long>(p.cells) : cells_kernel_of<1, int>(p.cells);
}

}  // namespace

extern "C" {

// lpb, lpe: (B,T,S) f32; ranges: (B,T) int32; lengths: (B,) int32;
// alphas, betas: (B,T,S) f32; ll_forward, ll_backward: (B,) f32; rows:
// 4·B·S f32 where the plan keeps the rows in device memory, else unused
// (may be null). T, S >= 1. Returns the launch's cudaError_t.
int wtt_band_stream(const void* lpb, const void* lpe, const int* ranges,
                    const int* input_lengths, const int* label_lengths, void* alphas,
                    void* betas, void* ll_forward, void* ll_backward, int B, int T, int S,
                    void* rows, void* stream) {
  if (B == 0) return 0;
  if (T < 1 || S < 1) return (int)cudaErrorInvalidValue;
  const Plan p = plan(B, T, S);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* pb = static_cast<const float*>(lpb);
  const float* pe = static_cast<const float*>(lpe);
  float* al = static_cast<float*>(alphas);
  float* be = static_cast<float*>(betas);
  float* lf = static_cast<float*>(ll_forward);
  float* lb = static_cast<float*>(ll_backward);
  const void* k = p.row_mode ? reinterpret_cast<const void*>(row_kernel(S))
                             : reinterpret_cast<const void*>(cells_kernel(p));
  if (k == nullptr || (p.rows_device && rows == nullptr)) return (int)cudaErrorInvalidValue;
  if (p.smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (p.row_mode) {
    row_kernel(S)<<<p.blocks, p.threads, p.smem, st>>>(pb, pe, ranges, input_lengths,
                                                       label_lengths, al, be, lf, lb, T, S);
  } else {
    cells_kernel(p)<<<p.blocks, p.threads, p.smem, st>>>(
        pb, pe, ranges, input_lengths, label_lengths, al, be, lf, lb, T, S, p.warps,
        p.rows_device ? static_cast<float*>(rows) : nullptr);
  }
  return (int)cudaGetLastError();
}

// The launch plan for B utterances of T frames and a band of S: out =
// {row walk (1) or cells walk (0), tile rows, ring slots, copy distance
// (tiles), lattices a block, blocks, threads a block, dynamic shared memory
// a block, warps a lattice, cells a lane, chunks a row, 64-bit offsets,
// rows in device memory}.
void wtt_band_plan(int B, int T, int S, int* out) {
  const Plan p = plan(B, T, S);
  const int v[13] = {p.row_mode, p.tile_rows, p.slots,  p.ahead,     p.per_block,
                     p.blocks,   p.threads,   p.smem,   p.warps,     p.cells,
                     p.chunks,   p.offsets64, p.rows_device};
  for (int i = 0; i < 13; ++i) out[i] = v[i];
}

// Registers and local (spill) bytes a thread of the kernel instance that a
// band of T rows and S cells runs, as ptxas compiled it.
int wtt_band_attrs(int T, int S, int* regs, int* local_bytes) {
  const Plan p = plan(1, T, S);
  const void* k = p.row_mode ? reinterpret_cast<const void*>(row_kernel(S))
                             : reinterpret_cast<const void*>(cells_kernel(p));
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, k);
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}

}  // extern "C"
