// Fused joint gradient, its column kernel: dW and db of the fused
// joint+loss (joint_grad.cu has the row kernel, the dWd kernel and the note
// on the arithmetic, the types and the split into two kernels).
//
// Replaces, with joint_grad.cu: warp_transducer_tpu/ops/pallas/
// joint_fused.py::_grad_kernel (fused_grad, fused_grad_mb, fused_grad_tdt).
//
// Bound on this card: operations, 2 · 2·R·H·V (the logits of its stripe
// and hᵀ·g) over the tensor cores' rate.
#include "joint.cuh"

namespace {

using namespace wtt::joint;

// ---- columns: dW, db --------------------------------------------------------

// A block owns a stripe of BN = 16·TM columns of V and walks row tiles of BM
// = 16·TM rows (joint.cuh::GradCols). Every block meets every row tile (its
// stripe is one of V/BN), so it does not compute h: the row kernel wrote
// each tile's h, once, to a buffer of a chunk of rows, and the block copies
// it by cp.async.
// * Up to H = kPassH (1024): the block keeps W's stripe (Hp × BN) in shared
//   memory for the whole launch and its Hp × BN slice of dW (mma
//   accumulators, 64 a lane) and its slice of db in registers. The next
//   tile's rows are placed while this tile's logits are multiplied and,
//   where two h tiles fit (kHBuf), its h arrives while this tile's dW
//   product runs.
// * Above (kSliced, TM = 1): a block owns a stripe and a pass of kPassH rows
//   of dW (grid z), the pass's 64 accumulators a lane in registers, and
//   walks row tiles of 128 rows (kColsSlicedRM), all eight warps on the
//   logits. For every row tile it streams W's stripe and the h tile through
//   a two-stage ring in k-slices of kSliceRows rows for the logits (all of Hp,
//   the accumulators carried across the slices), forms g, then streams the
//   pass's k-slices of h once more for its dW product. A warp's m16 tiles of
//   dW interleave with the other warps' ((i·8 + warp)·16 from the pass's
//   first row), so that each k-slice holds two (f32: one) of every warp's. db belongs
//   to the first pass's blocks.

// Rows first .. first + BM - 1 of the valid rows into one set of the
// column kernel's row buffers, each thread tid < BM its own row: (b, t, u,
// label) in `ib` (b = -1 beyond the end; with kClip also at or beyond `end`,
// the launch's last row: a 64-row tile above kPassH may reach into the next
// chunk, whose rows are not this launch's), (denom, coef, cb, ce, K extra
// fields) in `fb`.
template <int BM, bool kClip>
__device__ __forceinline__ void cols_rows(const Rows& rows, long long first, long long end,
                                          const int* __restrict__ lab_full,
                                          const float* __restrict__ denom,
                                          const float* __restrict__ coef,
                                          const float* __restrict__ cb,
                                          const float* __restrict__ ce,
                                          const float* __restrict__ cx, int K, int* ib,
                                          float* fb) {
  const int m = threadIdx.x;
  if (m >= BM) return;
  int b = -1, t = 0, u = 0;
  if ((kClip && first + m >= end) || !locate(rows, first + m, b, t, u)) b = -1;
  const bool on = b >= 0;
  const long long cell = on ? ((long long)b * rows.T + t) * rows.U + u : 0;
  ib[m] = b;
  ib[BM + m] = t;
  ib[2 * BM + m] = u;
  ib[3 * BM + m] = on ? lab_full[(long long)b * rows.U + u] : -1;
  fb[m] = on ? denom[cell] : 0.f;
  fb[BM + m] = on ? coef[cell] : 0.f;
  fb[2 * BM + m] = on ? cb[cell] : 0.f;
  fb[3 * BM + m] = on ? ce[cell] : 0.f;
#pragma unroll
  for (int k = 0; k < kPanel; ++k)
    fb[4 * BM + m * kPanel + k] = on && k < K ? cx[cell * K + k] : 0.f;
}

template <typename TW, int TM, bool kSliced>
using ColsTiles = GradCols<TW, TM, kSliced ? kColsSlicedRM : TM>;

template <typename TW, int TM, bool kSliced>
__global__ void __launch_bounds__(kThreads, kSliced ? 1 : GradCols<TW, TM>::kBlocks)
joint_grad_cols_kernel(const TW* __restrict__ h_in, const TW* __restrict__ W,
                       const float* __restrict__ bias,
                       const int* __restrict__ lab_full, Rows rows,
                       const float* __restrict__ denom, const float* __restrict__ coef,
                       const float* __restrict__ cb, const float* __restrict__ ce,
                       const float* __restrict__ cx, const wtt::ExtraCols cols,
                       float* __restrict__ dW_part, float* __restrict__ db_part,
                       long long row_begin, long long row_end, bool accumulate, int H, int V,
                       int blank, bool w_async) {
  using G = ColsTiles<TW, TM, kSliced>;
  using M = Mma<TW>;
  using T = typename G::T;
  constexpr int BM = G::BM, BN = G::BN, NI = G::NI, WM = G::WM, WN = G::WN;
  constexpr int MI = G::MI, NJ = G::NJ, HB = G::kHBuf, NF = G::kFields;
  constexpr int KS = kSliceRows<TW>;                  // rows of a k-slice above kPassH
  constexpr int kSliceTiles = KS / (16 * kWarps);      // a warp's dW tiles in a k-slice
  constexpr int kPassSlices = kPassH / KS;             // k-slices of a pass
  const int Hp = padded_h(H);
  const int ldh = G::ldh(kSliced ? KS : Hp);
  extern __shared__ __align__(16) unsigned char tile_smem[];
  Carve c{tile_smem};
  // W's stripe (wst[k·LDW + n]) and the h tiles (hs[m·ldh + k]); above
  // kPassH two stages of a W slice and an h slice, the second after the first.
  T* wst = c.take<T>(kSliced ? G::kStage * 2 / sizeof(T) : (size_t)Hp * G::LDW);
  T* hbuf = kSliced ? wst + round16(sizeof(T) * KS * G::LDW) / sizeof(T)
                    : c.take<T>((size_t)HB * BM * ldh);
  T* gs = c.take<T>((size_t)BM * G::LDG);        // gs[m·LDG + n]
  float* fbuf = c.take<float>(2 * NF * BM);      // two sets of row fields
  float* s_red = c.take<float>(WM * BN);         // for db
  int* ibuf = c.take<int>(2 * 4 * BM);           // two sets of (b, t, u, label)
  float* s_bias = c.take<float>(BN);             // bias of each column of the stripe
  int* s_xk = c.take<int>(BN);                   // the extra column it is, or -1

  const int tid = threadIdx.x, lane = tid % wtt::kWarp, warp = tid / wtt::kWarp;
  const int gr = lane >> 2, tq = lane & 3;
  const int wm = warp % WM, wn = warp / WM;
  const bool active = warp < WM * WN;
  const int row0 = 16 * wm + gr, n0 = wn * NI * 8;
  const int v0 = blockIdx.x * BN;
  const int split = blockIdx.y, nsplit = gridDim.y;
  // The pass of dW rows this block owns (one, all of Hp, up to kPassH).
  const int hr0 = kSliced ? blockIdx.z * kPassH : 0;
  const int hrn = kSliced ? min(kPassH, Hp - hr0) : Hp;
  // This warp's first dW row: its m16 tiles i at m0 + 16i up to kPassH, at
  // hr0 + (i·8 + warp)·16 above.
  const int m0 = kSliced ? hr0 + 16 * warp : warp * (Hp / kWarps);
  const int mi = hrn / (16 * kWarps);  // dW's m16 tiles of each warp
  if (!kSliced) {
    load_w_rows<BN>(wst, G::LDW, W, 0, Hp, H, V, v0, w_async);
    cp_async_commit();
  }
  if (tid < BN) {
    const int v = v0 + tid;
    s_bias[tid] = v < V ? bias[v] : 0.f;
    s_xk[tid] = extra_index(cols, v);
  }
  const long long total = rows.offsets[rows.B];
  const long long end = total < row_end ? total : row_end;
  auto load_h = [&](long long tile, int hb) {
    load_h_rows<BM>(hbuf + (size_t)hb * BM * ldh, ldh, h_in, tile, row_begin, end, Hp, 0, Hp);
    cp_async_commit();
  };

  float dW[MI][NJ][4] = {};
  float db[NI][2] = {};
  const long long stride = (long long)nsplit * BM;
  long long first = row_begin + (long long)split * BM;
  // g and db of the tile's logits in acc, from the row fields of `set`.
  auto form_g = [&](const float (&acc)[1][NI][4], int set) {
    const int* s_lab = ibuf + set * 4 * BM + 3 * BM;
    const float* fb = fbuf + set * NF * BM;
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int n = n0 + 8 * j + 2 * tq + q, v = v0 + n;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int m = row0 + 8 * r;
          float g = 0.f;
          if (v < V) {  // rows beyond the end have zero coefficients
            g = grad_element(acc[0][j][2 * r + q] + s_bias[n], fb[m], fb[BM + m],
                             fb[2 * BM + m], fb[3 * BM + m], v, blank, s_lab[m],
                             fb + 4 * BM + m * kPanel, s_xk[n]);
            db[j][q] += g;  // db sums the unrounded g
          }
          gs[m * G::LDG + n] = M::cast(g);
        }
      }
  };

  if constexpr (!kSliced) {
    if (first < end) {
      cols_rows<BM, kSliced>(rows, first, end, lab_full, denom, coef, cb, ce, cx, cols.n, ibuf,
                             fbuf);
      load_h(first, 0);
    }
    cp_async_wait<0>();  // W's stripe and the first h tile
    __syncthreads();
    for (int set = 0; first < end; first += stride, set ^= 1) {
      const long long next = first + stride;
      const int hb = HB == 2 ? set : 0;  // this tile's h
      const T* hs = hbuf + (size_t)hb * BM * ldh;
      // The next tile's rows, into the other set, while the logits run.
      if (next < end)
        cols_rows<BM, kSliced>(rows, next, end, lab_full, denom, coef, cb, ce, cx, cols.n,
                               ibuf + (set ^ 1) * 4 * BM, fbuf + (set ^ 1) * NF * BM);
      if (active) {
        float acc[1][NI][4] = {};
        warp_product<TW, 1, NI, false, true>(acc, hs, ldh, 16 * wm, wst, G::LDW, n0, Hp, lane);
        form_g(acc, set);
      }
      __syncthreads();  // the g tile and the next tile's rows complete
      if (HB == 2 && next < end) load_h(next, set ^ 1);
      // dW[k][n] += Σ_m h[m][k] · g[m][n]. With f32 W the tile's share is
      // summed in the mma accumulators and added to dW by a rounded f32 add:
      // the tensor cores' accumulator truncates as it aligns its addends, and
      // a sum over every row tile kept inside it drifts (5e-4 of dW's norm at
      // the fused shape, where the tolerance is 1e-4). With bf16 W (tolerance
      // 2e-2) dW stays in the accumulators, which keeps 32 registers free.
      if constexpr (sizeof(T) == 2) {
        warp_product<TW, MI, NJ, true, true>(dW, hs, ldh, m0, gs, G::LDG, 0, BM, lane, mi);
      } else {
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          if (i >= mi) break;
          float part[1][NJ][4] = {};
          warp_product<TW, 1, NJ, true, true>(part, hs, ldh, m0 + 16 * i, gs, G::LDG, 0, BM,
                                              lane);
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int x = 0; x < 4; ++x) dW[i][j][x] += part[0][j][x];
        }
      }
      cp_async_wait<0>();
      __syncthreads();  // h and g consumed; with two h tiles the next one in
      if (HB == 1 && next < end) {
        load_h(next, 0);
        cp_async_wait<0>();
        __syncthreads();
      }
    }
  } else {
    // Steps of a row tile: the logits' k-slices k < nsl of all of Hp (a W
    // slice and an h slice each), then the pass's k-slices of h for dW. The
    // row tiles of this block: first + t·stride < end.
    const int nsl = (Hp + KS - 1) / KS, nds = (hrn + KS - 1) / KS;
    const int spt = nsl + nds;
    const long long tiles = first < end ? (end - first + stride - 1) / stride : 0;
    const long long nsteps = tiles * spt;
    auto issue = [&](long long i) {
      const long long tile = first + i / spt * stride;
      const int k = (int)(i % spt), stage = (int)(i & 1);
      T* ws = wst + (size_t)stage * G::kStage / sizeof(T);
      T* hsl = hbuf + (size_t)stage * G::kStage / sizeof(T);
      if (k < nsl) {
        const int k0 = k * KS, nk = min(KS, Hp - k0);
        load_w_rows<BN>(ws, G::LDW, W, k0, nk, H, V, v0, w_async);
        load_h_rows<BM>(hsl, ldh, h_in, tile, row_begin, end, Hp, k0, nk);
      } else {
        const int k0 = hr0 + (k - nsl) * KS;
        load_h_rows<BM>(hsl, ldh, h_in, tile, row_begin, end, Hp, k0, min(KS, hr0 + hrn - k0));
      }
      cp_async_commit();
    };
    // Wait for step i's slices (the next step's asked for first); returns its stage.
    auto begin = [&](long long i) -> int {
      if (i + 1 < nsteps) {
        issue(i + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      return (int)(i & 1);
    };
    if (nsteps > 0) issue(0);
    long long i = 0;
    for (long long t = 0; t < tiles; ++t) {
      float acc[1][NI][4] = {};
      for (int k = 0; k < nsl; ++k, ++i) {  // the logits, a k-slice a step
        const int stage = begin(i);
        if (k == 0)  // the tile's rows, read by form_g after the syncs between
          cols_rows<BM, kSliced>(rows, first + t * stride, end, lab_full, denom, coef, cb,
                                 ce, cx, cols.n, ibuf, fbuf);
        __syncthreads();  // the slices in
        const T* ws = wst + (size_t)stage * G::kStage / sizeof(T);
        const T* hsl = hbuf + (size_t)stage * G::kStage / sizeof(T);
        if (active)
          warp_product<TW, 1, NI, false, true>(acc, hsl, ldh, 16 * wm, ws, G::LDW, n0,
                                               min(KS, Hp - k * KS), lane);
        if (active && k == nsl - 1) form_g(acc, 0);
        __syncthreads();  // the slices consumed (and at the last one the g tile complete)
      }
      // dW's k-slices of this pass: each warp's kSliceTiles m16 tiles of it.
#pragma unroll
      for (int d = 0; d < kPassSlices; ++d) {
        if (d >= nds) break;
        const int stage = begin(i);
        __syncthreads();  // the h slice in
        const T* hsl = hbuf + (size_t)stage * G::kStage / sizeof(T);
        const int cnt = min(kSliceTiles, mi - d * kSliceTiles);
        float part[kSliceTiles][NJ][4] = {};
        warp_product<TW, kSliceTiles, NJ, true, true, 16 * kWarps>(part, hsl, ldh, 16 * warp, gs,
                                                                   G::LDG, 0, BM, lane, cnt);
#pragma unroll
        for (int ii = 0; ii < kSliceTiles; ++ii)
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int x = 0; x < 4; ++x) dW[d * kSliceTiles + ii][j][x] += part[ii][j][x];
        __syncthreads();  // the h slice consumed before its slot is refilled
        ++i;
      }
    }
  }

  float* out = dW_part + (size_t)split * H * V;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    if (i >= mi) break;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int k = m0 + (kSliced ? 16 * kWarps : 16) * i + gr + 8 * r,
                    v = v0 + 8 * j + 2 * tq + q;
          if (k < H && v < V) {
            float* o = out + (long long)k * V + v;
            *o = accumulate ? *o + dW[i][j][2 * r + q] : dW[i][j][2 * r + q];
          }
        }
  }
  if (kSliced && blockIdx.z > 0) return;  // db: the first pass's blocks
  // db: the 8 lanes of a column (one tq) over their rows, then the WM warps
  // of a column share in the order of wm.
  if (active) {
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float s = db[j][q];
        for (int o = 4; o < wtt::kWarp; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        if (gr == 0) s_red[wm * BN + n0 + 8 * j + 2 * tq + q] = s;
      }
  }
  __syncthreads();
  if (tid < BN && v0 + tid < V) {
    float s = 0.f;
    for (int w = 0; w < WM; ++w) s += s_red[w * BN + tid];
    float* o = db_part + (size_t)split * V + v0 + tid;
    *o = accumulate ? *o + s : s;
  }
}

// ---- launches ---------------------------------------------------------------

// Blocks of the column kernel that fit a multiprocessor at this H, after
// its shared memory is allowed; 0 on an error.
template <typename TW, int TM, bool kSliced>
int cols_occupancy_tm(int H) {
  auto kernel = joint_grad_cols_kernel<TW, TM, kSliced>;
  const size_t bytes = (size_t)plan<TW>(H).cols_smem;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes) !=
      cudaSuccess)
    return 0;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, bytes) != cudaSuccess)
    return 0;
  return n;
}

template <typename TW>
int cols_occupancy(int H) {
  switch (tile_param(H)) {
    case 4: return cols_occupancy_tm<TW, 4, false>(H);
    case 2: return cols_occupancy_tm<TW, 2, false>(H);
    default:
      return padded_h(H) > kPassH ? cols_occupancy_tm<TW, 1, true>(H)
                                  : cols_occupancy_tm<TW, 1, false>(H);
  }
}

// What the column kernel takes beside GradArgs.
struct ColsArgs {
  float *dW, *db, *dW_part, *db_part;
  int nsplit;
  long long row_begin, row_end;
  const void* h_in;
  bool accumulate;
};

template <typename TW, int TM, bool kSliced>
int launch_cols_tm(const GradArgs& a, const ColsArgs& c) {
  auto kernel = joint_grad_cols_kernel<TW, TM, kSliced>;
  const Plan q = plan<TW>(a.H);
  const size_t bytes = (size_t)q.cols_smem;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int stripes = (a.V + kDim * TM - 1) / (kDim * TM);
  // With one split the slices are the results themselves.
  const bool split = c.nsplit > 1;
  kernel<<<dim3(stripes, c.nsplit, q.passes), kThreads, bytes, a.stream>>>(
      static_cast<const TW*>(c.h_in), static_cast<const TW*>(a.W), a.bias, a.lab_full, a.rows,
      a.denom, a.coef, a.cb, a.ce, a.cx, a.cols, split ? c.dW_part : c.dW,
      split ? c.db_part : c.db, c.row_begin, c.row_end, c.accumulate, a.H, a.V, a.blank,
      w_aligned<TW>(a.W, a.V));
  err = cudaGetLastError();
  if (err != cudaSuccess || !split) return (int)err;
  err = sum_parts(c.dW_part, c.dW, (long long)a.H * a.V, c.nsplit, a.stream);
  if (err != cudaSuccess) return (int)err;
  return (int)sum_parts(c.db_part, c.db, a.V, c.nsplit, a.stream);
}

template <typename TW>
int launch_cols(const GradArgs& a, const ColsArgs& c) {
  switch (tile_param(a.H)) {
    case 4: return launch_cols_tm<TW, 4, false>(a, c);
    case 2: return launch_cols_tm<TW, 2, false>(a, c);
    default:
      return padded_h(a.H) > kPassH ? launch_cols_tm<TW, 1, true>(a, c)
                                    : launch_cols_tm<TW, 1, false>(a, c);
  }
}

template <typename TW, int TM, bool kSliced>
int attrs_tm(int* regs, int* local_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, joint_grad_cols_kernel<TW, TM, kSliced>);
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

}  // namespace

extern "C" {

// Dynamic shared memory the column kernel asks for at this H (the larger
// of the two W types).
long long wtt_joint_grad_cols_smem(int H) {
  const long long f = plan<float>(H).cols_smem, b = plan<__nv_bfloat16>(H).cols_smem;
  return f > b ? f : b;
}

// Registers a thread and local (spill) bytes of the column kernel the wrapper
// launches at this H and W type, as ptxas compiled it. Returns the
// cudaError_t of the query.
int wtt_joint_grad_cols_attrs(int H, int w_dtype, int* regs, int* local_bytes) {
  if (H < 1) return (int)cudaErrorInvalidValue;
  switch (w_dtype) {
    case wtt::kF32: return attrs<float>(H, regs, local_bytes);
    case wtt::kBF16: return attrs<__nv_bfloat16>(H, regs, local_bytes);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Blocks of the column kernel a multiprocessor holds at this H and W type
// (w_dtype as below), for the wrapper's choice of row splits; 0 on an error.
int wtt_joint_grad_cols_occupancy(int H, int w_dtype) {
  if (H < 1) return 0;
  if (w_dtype == wtt::kF32) return cols_occupancy<float>(H);
  if (w_dtype == wtt::kBF16) return cols_occupancy<__nv_bfloat16>(H);
  return 0;
}

// dW: (H,V) f32 and db: (V,) f32. dW_part: (nsplit,H,V) f32 and db_part:
// (nsplit,V) f32, the partial slices, unused when nsplit == 1. The launch
// covers the valid rows row_begin .. row_end - 1, whose h the row kernel
// wrote to h_in; with `accumulate` it adds into the slices (the rows of
// earlier chunks), else it writes them, and dW and db are then the sum of
// the slices so far, in a fixed order. Above H = 1024 the grid holds a block
// for each pass of 1024 rows of dW as well (joint.cuh::Plan::passes).
// Returns the launches' cudaError_t.
int wtt_joint_grad_cols(const void* W, int w_dtype, const void* bias, const int* lab_full,
                        const void* offsets, const int* label_lengths, const void* denom,
                        const void* coef, const void* cb, const void* ce, const void* cx,
                        const int* extra_cols, int K, void* dW, void* db, void* dW_part,
                        void* db_part, int nsplit, long long row_begin, long long row_end,
                        const void* h_in, int accumulate, int B, int T, int U, int H, int V,
                        int blank, void* stream) {
  if (V == 0 || H == 0) return 0;
  if (nsplit < 1 || h_in == nullptr || row_begin % (kDim * tile_param(H)) != 0)
    return (int)cudaErrorInvalidValue;
  GradArgs a;
  if (!make_grad_args(&a, nullptr, nullptr, W, bias, lab_full, offsets, label_lengths, denom,
                      coef, cb, ce, cx, extra_cols, K, B, T, U, H, V, blank, stream))
    return (int)cudaErrorInvalidValue;
  const ColsArgs c{static_cast<float*>(dW), static_cast<float*>(db), static_cast<float*>(dW_part),
                   static_cast<float*>(db_part), nsplit, row_begin, row_end, h_in,
                   accumulate != 0};
  if (w_dtype == wtt::kF32) return launch_cols<float>(a, c);
  if (w_dtype == wtt::kBF16) return launch_cols<__nv_bfloat16>(a, c);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
