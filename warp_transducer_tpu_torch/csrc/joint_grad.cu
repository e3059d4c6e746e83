// Fused joint gradient kernels: the gradients of the fused joint+loss to e,
// p, W and bias from the (B, T, U) coefficient fields, without the
// (B, T, U, V) logits or their gradient ever reaching device memory.
//
// Replaces: warp_transducer_tpu/ops/pallas/joint_fused.py::_grad_kernel
// (called through fused_grad and fused_grad_chunked; with its extra_cols
// through fused_grad_mb, the multi-blank loss; with its with_dur through
// fused_grad_tdt, the TDT loss).
//
// Per valid row r = (b, t, u), recomputing h = tanh(e[b,t] + p[b,u]) and each
// tile of logits = h·W + bias:
//   g = coef·exp(logits + denom) − cb·[v = blank] − ce·[v = label]
//       − Σ_k cx[r, k]·[v = col_k]
// in f32, every subtraction before any rounding of g (coef·p_label − ce is
// a difference of two O(1) terms). Then dh = g·Wᵀ, dW = hᵀ·g, db = Σ_rows g,
// and with d = dh·(1 − h²): de[b,t] = Σ_u d, dp[b,u] = Σ_t d. With a duration
// head, its cotangent g_dur (B, T, U, D) joins dh as g_dur·Wdᵀ before the
// (1 − h²), and dWd = hᵀ·g_dur. Rows outside (t < T_b) & (u < U_b) have zero
// coefficients and are never visited (joint.cuh numbers the valid rows only).
// K and D are run-time numbers (0: none), at most 8 each; the rows' K fields
// and D cotangents sit in shared memory beside cb and ce.
//
// Types as joint_prep.cu: e, p, bias and the fields in f32; W f32 or bf16.
// With bf16 W, h and g are rounded to bf16 before the three products (db
// sums the unrounded g, tanh' uses the unrounded h), which run on the
// tensor cores with f32 accumulators; g is formed in f32 from the f32
// accumulator and rounded only after every subtraction. With f32 W each
// product is the three-TF32 split of joint.cuh (Mma<float>): f32 accuracy on
// the tensor cores. The duration head's two products take the unrounded h,
// f32 Wd and f32 g_dur in both cases.
//
// Bound on this card: operations, 3 · 2·R·H·V over the tensor cores' rate.
// The kernels do four such products (the logits twice).
//
// Design. The TPU kernel's grid runs in order on one core and carries dW and
// db across every step and dp across the T tiles of one b. Here blocks run in
// parallel and nothing carries over, and one H × V partial of dW per row
// tile would be billions of atomics. So the work is split into two kernels
// that each own what they sum, at the price of computing the logits twice
// (four products in place of three); neither writes a (R, V) tensor of g or
// logits to device memory:
//
// Both run a chunk of the valid rows at a time (the wrapper's loop): the row
// kernel fills each row tile's h once and writes it to a buffer of the chunk
// (bf16 rounded, or f32; a few tens of MB), which the column kernel copies
// where it would otherwise compute h again for each of its V/BN stripes.
//
// * joint_grad_rows_kernel — row-parallel. A block owns a tile of 16·TM
//   valid rows (TM = 4, 2, 1 for H ≤ 256, 512, above) with its h tile in
//   shared memory, and walks V in tiles of BN columns (joint.cuh::RowTiles).
//   Up to H = kPassH (1024) each W tile (Hp × BN, H padded to a multiple of
//   128) comes whole into shared memory by cp.async, one at a time so that
//   two blocks share a multiprocessor (with bf16 W); the warps multiply h by
//   it once, form g in f32 on the accumulator fragments and store it
//   (rounded with bf16 W) as a BM × BN tile, and then every warp multiplies
//   that g tile by the same W tile, read the other way round, into its share
//   of dh (16 rows × Hp/(8/TM) columns, at most 64 accumulators a lane). At
//   the end d = dh·(1 − h²) goes through shared memory (over the W tile);
//   one thread per k sums the runs of rows that share (b, t) and adds each
//   run to de with one atomicAdd (a run is cut only at a tile edge, so with
//   U_b ≤ the tile's rows at most two blocks add to an element and the sum
//   does not depend on their order), and adds every row to dp with an
//   atomicAdd (T_b terms per element, in an order that varies from run to
//   run). Above kPassH (kSliced, TM = 1) the block takes dh in passes of
//   kPassH columns, each of which owns dh, d and the de/dp adds of its
//   columns only (so the de property holds pass by pass); a pass walks V
//   again, streaming W through a two-stage ring in k-slices of kSliceRows
//   rows (256; 128 with f32 W, whose V tiles are then 64 wide as bf16's):
//   all of Hp for the tile's logits (the accumulators carried across the
//   slices), then the pass's own rows for its dh product. A warp's n8 tiles
//   of dh interleave with the other warps' ((j·8 + warp)·8 from the pass's
//   first column), so that every k-slice of the pass holds four (f32: two)
//   tiles of every warp. At H = 2048 that is three products where one pass would
//   take two; the alternative, 16 warps a block so that a lane keeps its 64
//   accumulators of all of H, was not taken (PERF.md).
// * joint_grad_cols_kernel (joint_grad_cols.cu, a source of its own so that
//   the two compile side by side) — column-parallel. A block owns a stripe of V
//   (16·TM columns) and keeps W's stripe in shared memory and its Hp ×
//   stripe slice of dW (mma accumulators, 64 a lane) and its slice of db in
//   registers. It walks every `nsplit`-th row tile (16·TM rows) of the
//   chunk, copies its h, recomputes the logits of its stripe, forms g and
//   accumulates hᵀ·g with the h tile read transposed by ldmatrix.trans.
//   Slices go, with no atomics, into one of `nsplit` partial buffers (written
//   by the first chunk, added to by the later ones, one launch after
//   another), which sum_parts_kernel adds in a fixed order: dW and db are
//   deterministic. The wrapper takes nsplit so that the grid is one wave of
//   the kernel's occupancy.
// * joint_grad_dwd_kernel — dWd (H, D), with a duration head only. It is a sum
//   over every valid row, like dW, but of the unrounded h, which neither
//   kernel above holds when W is bf16, and H·D is 1,024 addresses: an
//   atomicAdd a block would be thousands of blocks contending for them, in an
//   order that changes from run to run. So a third, light kernel
//   (joint.cuh::dur_grad_tiles) walks the row tiles once more with the
//   unrounded h tile, a few hundred blocks each owning one partial of dWd in
//   registers, and sum_parts_kernel adds the partials in a fixed order: dWd is
//   deterministic too, at the price of R·H more tanh (the products are 2·R·H·D
//   operations beside the token head's 8·R·H·V).
#include "joint.cuh"

namespace {

using namespace wtt::joint;

// ---- rows: dh, de, dp -------------------------------------------------------

// Two blocks a multiprocessor up to kPassH (with bf16 W their tiles fit
// twice); above it the h tile and the W stages fill one, which may then
// spend up to 255 registers a thread.
template <typename TW, int TM, bool kSliced>
__global__ void __launch_bounds__(kThreads, kSliced ? 1 : 2)
joint_grad_rows_kernel(const float* __restrict__ e, const float* __restrict__ p,
                       const TW* __restrict__ W, const float* __restrict__ bias,
                       const int* __restrict__ lab_full, Rows rows,
                       const float* __restrict__ denom, const float* __restrict__ coef,
                       const float* __restrict__ cb, const float* __restrict__ ce,
                       const float* __restrict__ cx, const wtt::ExtraCols cols,
                       const float* __restrict__ Wd, const float* __restrict__ g_dur, int D,
                       float* __restrict__ de, float* __restrict__ dp, long long row_begin,
                       TW* __restrict__ h_out, int H, int V, int blank, bool w_async,
                       int hcols) {
  using G = GradRows<TW, TM, kSliced>;
  using M = Mma<TW>;
  using T = typename G::T;
  constexpr int BM = G::BM, BN = G::BN, NI = G::NI, WM = G::WM, WN = G::WN;
  constexpr int WH = G::WH, NIH = G::NIH;
  constexpr int S = kSliced ? 2 : 1;                        // W stages
  constexpr int kSliceTiles = kSliceRows<TW> / (8 * WH);     // a warp's dh tiles in a k-slice
  constexpr int kPassSlices = kPassH / kSliceRows<TW>;       // k-slices of a pass
  const long long first = row_begin + (long long)blockIdx.x * BM;
  if (first >= rows.offsets[rows.B]) return;
  const int Hp = padded_h(H);
  const int ks = kSliced ? kSliceRows<TW> : Hp;
  const int nsl = kSliced ? (Hp + ks - 1) / ks : 1;             // k-slices of the logits
  const int npass = kSliced ? (Hp + kPassH - 1) / kPassH : 1;  // passes over dh
  const bool h_whole = !kSliced || hcols == Hp;  // else the h tile is the step's slice
  // The epilogue reads the f32 h tile, or recomputes tanh (bf16: the tile
  // holds rounded h) and then stages d over the h tile as well.
  const bool d_over_h = sizeof(T) == 2 || !h_whole;
  const int hc = kSliced ? hcols : Hp, ldh = G::ldh(hc);
  const int dcols = kSliced ? kPassH : Hp;
  extern __shared__ __align__(16) unsigned char tile_smem[];
  Carve c{tile_smem};
  T* hs = c.take<T>((size_t)BM * ldh);
  unsigned char* ring_raw = c.take<unsigned char>(G::ring_bytes(hc, ks, S, dcols, d_over_h));
  T* ring = reinterpret_cast<T*>(ring_raw);
  // At the end of a pass: d[kl·(BM+1) + m], over the ring (and the h tile).
  float* ds = reinterpret_cast<float*>(d_over_h ? static_cast<void*>(hs)
                                                : static_cast<void*>(ring_raw));
  T* gs = c.take<T>((size_t)BM * G::LDG);          // g[m·LDG + n] of the V tile
  float* s_den = c.take<float>((4 + 2 * kPanel) * BM);
  float* s_coef = s_den + BM;
  float* s_cb = s_coef + BM;
  float* s_ce = s_cb + BM;
  float* s_cx = s_ce + BM;           // BM × kPanel extra fields
  float* s_gd = s_cx + BM * kPanel;  // BM × kPanel duration cotangents
  int* s_b = c.take<int>(4 * BM);
  int* s_t = s_b + BM;
  int* s_u = s_t + BM;
  int* s_lab = s_u + BM;

  const int tid = threadIdx.x, lane = tid % wtt::kWarp, warp = tid / wtt::kWarp;
  const int gr = lane >> 2, tq = lane & 3;
  const int wm = warp % WM, wn = warp / WM;  // also (rows, H share) of the dh product
  const int ntiles = (V + BN - 1) / BN;
  // Step i of a pass (spt steps a V tile): the logits' k-slices k < nsl of
  // all of Hp, then the dh product's slices of the pass's rows hp0 .. hp0 +
  // hpn − 1 (none up to kPassH: the logits' W tile serves both).
  auto issue = [&](int i, int spt, int hp0, int hpn, T* dst) {
    const int k = i % spt;
    const int k0 = k < nsl ? k * ks : hp0 + (k - nsl) * ks;
    const int kend = k < nsl ? Hp : hp0 + hpn;
    load_w_rows<BN>(dst, G::LDW, W, k0, min(ks, kend - k0), H, V, i / spt * BN, w_async);
  };
  // Wait for step i's W rows (the next step's asked for first where two
  // stages hold them); returns them.
  auto begin = [&](int i, int nsteps, int spt, int hp0, int hpn) -> const T* {
    if constexpr (S == 2) {
      if (i + 1 < nsteps) {
        issue(i + 1, spt, hp0, hpn, ring + (size_t)((i + 1) & 1) * ks * G::LDW);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      return ring + (size_t)(i & 1) * ks * G::LDW;
    } else {
      if (i > 0) {  // the first W tile was asked for before the rows were placed
        issue(i, spt, hp0, hpn, ring);
        cp_async_commit();
      }
      cp_async_wait<0>();
      return ring;
    }
  };
  const int hpn0 = kSliced ? min(kPassH, Hp) : Hp;
  issue(0, nsl + (kSliced ? (hpn0 + ks - 1) / ks : 0), 0, hpn0, ring);
  cp_async_commit();
  place_rows<BM>(rows, first, s_b, s_t, s_u);
  __syncthreads();
  load_panel<BM>(s_cx, cx, cols.n, s_b, s_t, s_u, rows.T, rows.U);
  load_panel<BM>(s_gd, g_dur, D, s_b, s_t, s_u, rows.T, rows.U);
  if (tid < BM) {
    const int b = s_b[tid];
    const bool on = b >= 0;
    const long long cell = on ? ((long long)b * rows.T + s_t[tid]) * rows.U + s_u[tid] : 0;
    s_lab[tid] = on ? lab_full[(long long)b * rows.U + s_u[tid]] : -1;
    s_den[tid] = on ? denom[cell] : 0.f;
    s_coef[tid] = on ? coef[cell] : 0.f;
    s_cb[tid] = on ? cb[cell] : 0.f;
    s_ce[tid] = on ? ce[cell] : 0.f;
  }
  // The tile's h, and the same to the chunk buffer for the column kernel,
  // which reads it instead of filling its own for every stripe of V.
  if (h_whole) {
    fill_h_rows<BM>(hs, ldh, e, p, s_b, s_t, s_u, rows.T, rows.U, H, 0, Hp);
    __syncthreads();
    store_h_rows<BM>(hs, ldh, h_out, first - row_begin, Hp, 0, Hp);
  } else {
    for (int k0 = 0; k0 < Hp; k0 += ks) {
      const int nk = min(ks, Hp - k0);
      fill_h_rows<BM>(hs, ldh, e, p, s_b, s_t, s_u, rows.T, rows.U, H, k0, nk);
      __syncthreads();
      store_h_rows<BM>(hs, ldh, h_out, first - row_begin, Hp, k0, nk);
      __syncthreads();
    }
  }

  const bool active = warp < WM * WN;  // has a share of the logits tile
  const int row0 = 16 * wm + gr;       // this lane's rows: row0, row0 + 8
  const int n0 = wn * NI * 8;          // its columns in the V tile: n0 + 8j + 2tq + q
  // Its dh tiles j, from the pass's first column: h0 + 8j up to kPassH,
  // (j·WH + wn)·8 above.
  const int h0 = kSliced ? wn * 8 : wn * (Hp / WH);
  for (int pass = 0; pass < npass; ++pass) {
    const int hp0 = pass * kPassH, hpn = kSliced ? min(kPassH, Hp - hp0) : Hp;
    const int nds = kSliced ? (hpn + ks - 1) / ks : 0;
    const int spt = nsl + nds, nsteps = ntiles * spt;
    const int nih = hpn / WH / 8;  // this warp's dh tiles in the pass
    if (pass > 0) {
      __syncthreads();  // the last pass's d tile scattered
      issue(0, spt, hp0, hpn, ring);
      cp_async_commit();
      if (h_whole && d_over_h) fill_h_rows<BM>(hs, ldh, e, p, s_b, s_t, s_u, rows.T, rows.U, H,
                                               0, Hp);
    }
    float dh[1][NIH][4] = {};
    float acc[1][NI][4];
    int i = 0;  // the pass's step
    for (int it = 0; it < ntiles; ++it) {
      const int v0 = it * BN;
      for (int k = 0; k < nsl; ++k, ++i) {  // the V tile's logits, a k-slice a step
        const int k0 = k * ks, nk = min(ks, Hp - k0);
        const T* wt = begin(i, nsteps, spt, hp0, hpn);
        if (!h_whole) fill_h_rows<BM>(hs, ldh, e, p, s_b, s_t, s_u, rows.T, rows.U, H, k0, nk);
        __syncthreads();  // the W piece in; on the first step also h and the fields
        if (active) {
          if (k == 0) {
#pragma unroll
            for (int j = 0; j < NI; ++j)
#pragma unroll
              for (int x = 0; x < 4; ++x) acc[0][j][x] = 0.f;
          }
          warp_product<TW, 1, NI, false, true>(acc, hs + (h_whole ? k0 : 0), ldh, 16 * wm, wt,
                                               G::LDW, n0, nk, lane);
        }
        if (active && k == nsl - 1) {  // the logits complete: g
          const bool extras_here = has_extra(cols, v0 + n0, NI * 8);
#pragma unroll
          for (int j = 0; j < NI; ++j)
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const int n = n0 + 8 * j + 2 * tq + q, v = v0 + n;
              const float bv = v < V ? bias[v] : 0.f;
              const int xk = extras_here ? extra_index(cols, v) : -1;
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                const int m = row0 + 8 * r;
                float g = 0.f;
                if (v < V)  // rows beyond the end have zero coefficients
                  g = grad_element(acc[0][j][2 * r + q] + bv, s_den[m], s_coef[m], s_cb[m],
                                   s_ce[m], v, blank, s_lab[m], s_cx + m * kPanel, xk);
                gs[m * G::LDG + n] = M::cast(g);  // bf16: rounded after every subtraction
              }
            }
        }
        if constexpr (!kSliced) {
          __syncthreads();  // the g tile complete
          // dh[m][k] += Σ_n g[m][n] · W[k][v0 + n], W read from the tile in
          // place, four n8 tiles of dh a product. Each sums the V tile in the
          // mma accumulators and adds it to dh by a rounded f32 add (the
          // tensor cores' accumulator truncates; over all of V it would
          // drift, see the column kernel).
          constexpr int kGroup = 4;
#pragma unroll
          for (int j0 = 0; j0 < NIH; j0 += kGroup) {
            if (j0 >= nih) break;
            float part[1][kGroup][4] = {};
            warp_product<TW, 1, kGroup, false, false>(part, gs, G::LDG, 16 * wm, wt, G::LDW,
                                                      h0 + 8 * j0, BN, lane, 1, nih - j0);
#pragma unroll
            for (int jj = 0; jj < kGroup; ++jj)
#pragma unroll
              for (int x = 0; x < 4; ++x) dh[0][j0 + jj][x] += part[0][jj][x];
          }
        }
        __syncthreads();  // the W piece and g consumed before they are refilled
      }
      if constexpr (kSliced) {
        // The pass's rows of W, a k-slice a step: its kSliceTiles tiles of
        // each warp's dh, summed as above.
#pragma unroll
        for (int d = 0; d < kPassSlices; ++d) {
          if (d >= nds) break;
          const T* wt = begin(i, nsteps, spt, hp0, hpn);
          __syncthreads();  // the W slice in
          const int cnt = min(kSliceTiles, nih - d * kSliceTiles);
          float part[1][kSliceTiles][4] = {};
          warp_product<TW, 1, kSliceTiles, false, false, 16, 8 * WH>(
              part, gs, G::LDG, 16 * wm, wt, G::LDW, h0, BN, lane, 1, cnt);
#pragma unroll
          for (int jj = 0; jj < kSliceTiles; ++jj)
#pragma unroll
            for (int x = 0; x < 4; ++x) dh[0][d * kSliceTiles + jj][x] += part[0][jj][x];
          __syncthreads();  // the W slice consumed before its slot is refilled
          ++i;
        }
      }
    }

    // d = (dh + g_dur·Wdᵀ) · (1 − h²) with the unrounded h (the f32 tile, or
    // tanh recomputed where the tile holds bf16 or a slice), staged as
    // d[kl·(BM+1) + m] for the pass's columns k = hp0 + kl.
#pragma unroll
    for (int j = 0; j < NIH; ++j) {
      if (j >= nih) break;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int m = row0 + 8 * r, b = s_b[m];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int kl = (kSliced ? h0 + 8 * WH * j : h0 + 8 * j) + 2 * tq + q, k = hp0 + kl;
          float d = 0.f;
          if (b >= 0 && k < H) {
            float h;
            if (sizeof(T) == 4 && !d_over_h) {
              h = M::value(hs[m * ldh + k]);
            } else {
              h = tanhf(e[((long long)b * rows.T + s_t[m]) * H + k] +
                        p[((long long)b * rows.U + s_u[m]) * H + k]);
            }
            float dh_k = dh[0][j][2 * r + q];
            for (int cc = 0; cc < D; ++cc) dh_k = fmaf(s_gd[m * kPanel + cc], Wd[k * D + cc], dh_k);
            d = dh_k * (1.f - h * h);
          }
          ds[kl * (BM + 1) + m] = d;
        }
      }
    }
    __syncthreads();
    scatter_de_dp<BM>(ds, BM + 1, s_b, s_t, s_u, rows, H, hp0, min(H, hp0 + hpn), de, dp);
  }
}

// ---- dWd ---------------------------------------------------------------------

template <int TM>
__global__ void __launch_bounds__(kThreads)
joint_grad_dwd_kernel(const float* __restrict__ e, const float* __restrict__ p,
                      const float* __restrict__ g_dur, Rows rows, float* __restrict__ dWd_part,
                      int H, int D) {
  extern __shared__ float smem[];
  dur_grad_tiles<kDim * TM>(e, p, g_dur, rows, dWd_part, H, D, smem);
}

// ---- launches ---------------------------------------------------------------

// What the row kernel takes beside GradArgs.
struct RowsArgs {
  const float *Wd, *g_dur;
  int D;
  float *de, *dp;
  long long row_begin, row_end;
  void* h_out;
};

template <typename TW, int TM, bool kSliced>
int launch_rows_tm(const GradArgs& a, const RowsArgs& r) {
  auto kernel = joint_grad_rows_kernel<TW, TM, kSliced>;
  const Plan q = plan<TW>(a.H);
  const size_t bytes = (size_t)q.rows_smem;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (r.row_end - r.row_begin + kDim * TM - 1) / (kDim * TM);
  kernel<<<(unsigned)blocks, kThreads, bytes, a.stream>>>(
      a.e, a.p, static_cast<const TW*>(a.W), a.bias, a.lab_full, a.rows, a.denom, a.coef, a.cb,
      a.ce, a.cx, a.cols, r.Wd, r.g_dur, r.D, r.de, r.dp, r.row_begin, static_cast<TW*>(r.h_out),
      a.H, a.V, a.blank, w_aligned<TW>(a.W, a.V), q.rows_hcols);
  return (int)cudaGetLastError();
}

template <typename TW>
int launch_rows(const GradArgs& a, const RowsArgs& r) {
  switch (tile_param(a.H)) {
    case 4: return launch_rows_tm<TW, 4, false>(a, r);
    case 2: return launch_rows_tm<TW, 2, false>(a, r);
    default:
      return padded_h(a.H) > kPassH ? launch_rows_tm<TW, 1, true>(a, r)
                                    : launch_rows_tm<TW, 1, false>(a, r);
  }
}

template <typename TW, int TM, bool kSliced>
int attrs_tm(int* regs, int* local_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, joint_grad_rows_kernel<TW, TM, kSliced>);
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return (int)err;
}

template <typename TW>
int attrs(int H, int* regs, int* local_bytes) {
  switch (tile_param(H)) {
    case 4: return attrs_tm<TW, 4, false>(regs, local_bytes);
    case 2: return attrs_tm<TW, 2, false>(regs, local_bytes);
    default:
      return padded_h(H) > kPassH ? attrs_tm<TW, 1, true>(regs, local_bytes)
                                  : attrs_tm<TW, 1, false>(regs, local_bytes);
  }
}

template <int TM>
int launch_dwd(const float* e, const float* p, const float* g_dur, Rows rows, float* dWd,
               float* dWd_part, int nsplit, int H, int D, cudaStream_t stream) {
  auto kernel = joint_grad_dwd_kernel<TM>;
  const size_t bytes = dur_grad_smem_bytes(H, kDim * TM);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<nsplit, kThreads, bytes, stream>>>(e, p, g_dur, rows, dWd_part, H, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)sum_parts(dWd_part, dWd, (long long)H * D, nsplit, stream);
}

}  // namespace

extern "C" {

// The plan of the fused joint kernels at this H and W type (w_dtype as
// below), for the mirror in ops/cuda/joint.py: out = {tm, hp, sliced, ks,
// slices, passes, prep_hcols, prep_stages, rows_hcols, prep_smem, rows_smem,
// cols_smem} (joint.cuh::Plan), then the rows of a chunk of the gradient
// whose h buffer takes at most chunk_bytes (a whole number of row tiles, at
// least one). Returns the cudaError_t of the query.
int wtt_joint_plan(int H, int w_dtype, long long chunk_bytes, long long* out) {
  if (H < 1 || chunk_bytes < 0) return (int)cudaErrorInvalidValue;
  Plan q;
  size_t elt;
  switch (w_dtype) {
    case wtt::kF32: q = plan<float>(H); elt = sizeof(float); break;
    case wtt::kBF16: q = plan<__nv_bfloat16>(H); elt = sizeof(__nv_bfloat16); break;
    default: return (int)cudaErrorInvalidValue;
  }
  const long long tile = kDim * q.tm;
  const long long rows = chunk_bytes / (long long)(q.hp * elt) / tile * tile;
  const long long v[] = {q.tm, q.hp, q.sliced, q.ks, q.slices, q.passes, q.prep_hcols,
                         q.prep_stages, q.rows_hcols, q.prep_smem, q.rows_smem, q.cols_smem,
                         rows > tile ? rows : tile};
  for (int i = 0; i < 13; ++i) out[i] = v[i];
  return 0;
}

// Dynamic shared memory the row kernel asks for at this H (the larger of
// the two W types).
long long wtt_joint_grad_rows_smem(int H) {
  const long long f = plan<float>(H).rows_smem, b = plan<__nv_bfloat16>(H).rows_smem;
  return f > b ? f : b;
}

// Dynamic shared memory the dWd kernel asks for at this H.
long long wtt_joint_grad_dwd_smem(int H) {
  return (long long)dur_grad_smem_bytes(H, kDim * tile_param(H));
}

// Registers a thread and local (spill) bytes of the row kernel the wrapper
// launches at this H and W type, as ptxas compiled it. Returns the
// cudaError_t of the query.
int wtt_joint_grad_rows_attrs(int H, int w_dtype, int* regs, int* local_bytes) {
  if (H < 1) return (int)cudaErrorInvalidValue;
  switch (w_dtype) {
    case wtt::kF32: return attrs<float>(H, regs, local_bytes);
    case wtt::kBF16: return attrs<__nv_bfloat16>(H, regs, local_bytes);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The inputs of wtt_joint_prep plus denom, coef, cb, ce: (B,T,U) f32, and
// cx: (B,T,U,K) f32 for the K columns extra_cols (a host array; K = 0: cx
// unused). Wd: (H,D) f32 and g_dur: (B,T,U,D) f32, zero outside the lattice
// (D = 0: both unused). de: (B,T,H) f32 and dp: (B,U,H) f32, both zeroed by
// the caller (the kernel adds into them). The launch covers the valid rows
// row_begin .. row_end - 1 (row_begin a multiple of the row tile, 16 ·
// tile_param(H)) and writes their h, in W's type and H padded to a multiple
// of 128 with zeros, to h_out: (row_end - row_begin, Hp), 16-byte aligned.
// Returns the launch's cudaError_t.
int wtt_joint_grad_rows(const void* e, const void* p, const void* W, int w_dtype,
                        const void* bias, const int* lab_full, const void* offsets,
                        const int* label_lengths, const void* denom, const void* coef,
                        const void* cb, const void* ce, const void* cx, const int* extra_cols,
                        int K, const void* Wd, const void* g_dur, int D, void* de, void* dp,
                        long long row_begin, long long row_end, void* h_out, int B, int T,
                        int U, int H, int V, int blank, void* stream) {
  if ((long long)B * T * U == 0 || V == 0 || H == 0 || row_end <= row_begin) return 0;
  if (D < 0 || D > kPanel || (D > 0 && (Wd == nullptr || g_dur == nullptr)) ||
      h_out == nullptr || row_begin % (kDim * tile_param(H)) != 0)
    return (int)cudaErrorInvalidValue;
  GradArgs a;
  if (!make_grad_args(&a, e, p, W, bias, lab_full, offsets, label_lengths, denom, coef, cb, ce,
                      cx, extra_cols, K, B, T, U, H, V, blank, stream))
    return (int)cudaErrorInvalidValue;
  const RowsArgs r{static_cast<const float*>(Wd), static_cast<const float*>(g_dur), D,
                   static_cast<float*>(de), static_cast<float*>(dp), row_begin, row_end, h_out};
  if (w_dtype == wtt::kF32) return launch_rows<float>(a, r);
  if (w_dtype == wtt::kBF16) return launch_rows<__nv_bfloat16>(a, r);
  return (int)cudaErrorInvalidValue;
}

// dWd: (H,D) f32 = hᵀ·g_dur with the unrounded h, written whole. e, p,
// offsets, label_lengths as above; g_dur: (B,T,U,D) f32, zero outside the
// lattice; dWd_part: (nsplit,H,D) f32 scratch, one partial a block. Returns
// the launches' cudaError_t.
int wtt_joint_grad_dwd(const void* e, const void* p, const void* offsets,
                       const int* label_lengths, const void* g_dur, void* dWd, void* dWd_part,
                       int nsplit, int B, int T, int U, int H, int D, void* stream) {
  if (H == 0 || D == 0) return 0;
  if (D < 0 || D > kPanel || nsplit < 1) return (int)cudaErrorInvalidValue;
  const Rows rows{static_cast<const long long*>(offsets), label_lengths, B, T, U};
  const float* ef = static_cast<const float*>(e);
  const float* pf = static_cast<const float*>(p);
  const float* gd = static_cast<const float*>(g_dur);
  float* o = static_cast<float*>(dWd);
  float* part = static_cast<float*>(dWd_part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile_param(H)) {
    case 4: return launch_dwd<4>(ef, pf, gd, rows, o, part, nsplit, H, D, s);
    case 2: return launch_dwd<2>(ef, pf, gd, rows, o, part, nsplit, H, D, s);
    default: return launch_dwd<1>(ef, pf, gd, rows, o, part, nsplit, H, D, s);
  }
}

}  // extern "C"
