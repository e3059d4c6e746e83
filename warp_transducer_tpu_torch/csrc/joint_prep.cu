// Fused joint prep kernel: from the projected encoder and prediction
// activations straight to the three (B, T, U) lattice inputs, without the
// (B, T, U, V) logits ever reaching device memory.
//
// Replaces: warp_transducer_tpu/ops/pallas/joint_fused.py::_prep_kernel
// (called through fused_prep and fused_prep_chunked; with its extra_cols
// through fused_prep_mb, the multi-blank loss; with its with_dur through
// fused_prep_tdt, the TDT loss).
//
// Per valid row r = (b, t, u): h = tanh(e[b,t] + p[b,u]) (H values, f32),
// logits = h·W + bias over all V, an online (max, sum-exp) gives
// denom = -(m + log s), lpb = logits[blank] + denom, and
// lpe = logits[label] + denom, or NEG where the row has no label (u = U-1,
// or a label outside [0, V)). With K extra columns (the big blanks),
// lpx[r, k] = logits[col_k] + denom. With a duration head (Wd (H, D), bias_d),
// dlog[r] = h·Wd + bias_d, the raw duration logits. Rows outside (t < T_b) &
// (u < U_b) are not touched: the wrapper pre-fills lpb, lpe and lpx with NEG
// and denom and dlog with 0, as the plain version
// (ops/fused_joint.py::fused_prep) writes them. K and D are run-time numbers
// (0: none), at most 8 each: the kernel is not instantiated per K or D.
//
// Types: e, p and bias arrive in f32. W is f32 or bf16. With bf16 W, h is
// rounded to bf16 before the product, as the JAX package rounds it, and the
// product runs on the tensor cores with f32 accumulators (joint.cuh, Mma).
// With f32 W the product is the three-TF32 split, f32 accuracy on the
// tensor cores. The duration head takes the unrounded h and f32 Wd in both
// cases: a warp per row recomputes tanh from e and p (joint.cuh::dur_row;
// H·D FMAs a row beside the token head's H·V), which keeps a second,
// unrounded h tile out of shared memory.
//
// Bound on this card: operations, 2·R·H·V over the tensor cores' rate
// (R = valid rows). The bytes are e, p, W and three (B, T, U) fields, far
// less.
//
// Design: a block owns a tile of 16·TM consecutive valid rows (TM = 4, 2, 1
// for H ≤ 256, 512, above) and builds its h tile once in shared memory,
// H padded with zeros to a multiple of 128. It then walks V in tiles of BN
// columns (joint.cuh::RowTiles), each W tile copied by cp.async into a
// ring (the next piece loads while this one is multiplied, where two
// stages fit), each warp holding a 16 × (8·NI) piece of the logits in mma
// accumulators. Up to H = kPassH (1024) a W tile comes whole, one step a
// V tile; above it (kSliced) in k-slices of kSliceRows rows (256, or 128 of
// the f32 W tile, then 64 wide as the bf16 one so that all eight warps
// share the logits), two stages, a step a slice, the accumulators carried
// across a tile's slices; where the h tile does not fit whole beside them
// (f32 W above H = 2304, bf16 above 2688), each step refills the h slice
// it multiplies from e and p. The
// online (max, sum-exp) runs on the accumulator fragments after a tile's
// last slice: a lane holds two rows and two columns of each n8 tile; the
// four lanes of a quad combine with shuffles at the end, the warps of a row
// through shared memory. The blank and the label logits are picked up as
// the V loop passes their columns, so the label logit is the very value the
// loop produced and no gathered W[:, labels] tensor exists. The K extra
// logits go the same way but through lpx itself: the lane that meets column
// col_k writes the bare logit there, and the row's thread adds denom at the
// end. W streams from device memory for any H·V (it stays in the 50 MB L2
// at these sizes), so one launch covers all of V.
#include "joint.cuh"

namespace {

using namespace wtt::joint;

template <typename TW, int TM, bool kSliced>
__global__ void __launch_bounds__(kThreads)
joint_prep_kernel(const float* __restrict__ e, const float* __restrict__ p,
                  const TW* __restrict__ W, const float* __restrict__ bias,
                  const int* __restrict__ lab_full, Rows rows, float* __restrict__ lpb,
                  float* __restrict__ lpe, float* __restrict__ denom, float* __restrict__ lpx,
                  const wtt::ExtraCols cols, const float* __restrict__ Wd,
                  const float* __restrict__ bias_d, float* __restrict__ dlog, int D, int H, int V,
                  int blank, bool w_async, int hcols) {
  using P = Prep<TW, TM, kSliced>;
  using T = typename P::T;
  constexpr int BM = P::BM, BN = P::BN, NI = P::NI, WM = P::WM, WN = P::WN;
  constexpr int S = kSliced ? 2 : P::kStages;
  const long long first = (long long)blockIdx.x * BM;
  if (first >= rows.offsets[rows.B]) return;
  const int Hp = padded_h(H);
  // A step multiplies the h tile by rows k0 .. k0 + ks − 1 of a W tile:
  // one step a V tile (ks = Hp) up to kPassH, nsl k-slices above.
  const int ks = kSliced ? kSliceRows<TW> : Hp;
  const int nsl = kSliced ? (Hp + ks - 1) / ks : 1;
  const bool h_whole = !kSliced || hcols == Hp;  // else the h tile is the step's slice
  const int ldh = P::ldh(kSliced ? hcols : Hp);
  extern __shared__ __align__(16) unsigned char tile_smem[];
  Carve c{tile_smem};
  T* hs = c.take<T>((size_t)BM * ldh);
  T* ring = c.take<T>((size_t)S * ks * P::LDW);
  float* s_bl = c.take<float>(2 * BM);  // blank logit per row
  float* s_le = s_bl + BM;              // label logit per row
  float* s_red = c.take<float>(2 * WN * BM);
  int* s_b = c.take<int>(4 * BM);
  int* s_t = s_b + BM;
  int* s_u = s_t + BM;
  int* s_lab = s_u + BM;

  const int tid = threadIdx.x, lane = tid % wtt::kWarp, warp = tid / wtt::kWarp;
  const int gr = lane >> 2, tq = lane & 3;
  const int wm = warp % WM, wn = warp / WM;
  const int ntiles = (V + BN - 1) / BN;
  const int nsteps = ntiles * nsl;
  auto issue = [&](int i, T* dst) {  // step i's W rows: V tile i / nsl, k-slice i % nsl
    const int k0 = i % nsl * ks;
    load_w_rows<BN>(dst, P::LDW, W, k0, min(ks, Hp - k0), H, V, i / nsl * BN, w_async);
  };
  issue(0, ring);
  cp_async_commit();
  place_rows<BM>(rows, first, s_b, s_t, s_u);
  __syncthreads();
  if (tid < BM) {
    const int b = s_b[tid];
    s_lab[tid] = b >= 0 ? lab_full[(long long)b * rows.U + s_u[tid]] : -1;
    s_bl[tid] = float(wtt::kNeg);
    s_le[tid] = float(wtt::kNeg);
  }
  if (h_whole) fill_h_rows<BM>(hs, ldh, e, p, s_b, s_t, s_u, rows.T, rows.U, H, 0, Hp);
  if (D > 0) {  // the duration head: a warp a row, the rows dealt round robin
    for (int m = warp; m < BM; m += kWarps) {
      const int b = s_b[m];
      if (b < 0) break;
      float out[kPanel];
      dur_row(e + ((long long)b * rows.T + s_t[m]) * H, p + ((long long)b * rows.U + s_u[m]) * H,
              Wd, H, D, lane, out);
      store_dur_row(dlog + (((long long)b * rows.T + s_t[m]) * rows.U + s_u[m]) * D, out, bias_d,
                    D, lane);
    }
  }
  __syncthreads();

  // This lane's two rows of the warp's 16 (r = 0: row gr, r = 1: gr + 8).
  const bool active = warp < WM * WN;
  const int row0 = 16 * wm + gr;
  const int lab[2] = {s_lab[row0], s_lab[row0 + 8]};
  float run_m[2] = {-FLT_MAX, -FLT_MAX}, run_s[2] = {0.f, 0.f};
  const int n0 = wn * NI * 8;
  float acc[1][NI][4];
  for (int i = 0; i < nsteps; ++i) {
    const int s = i % nsl, v0 = i / nsl * BN, k0 = s * ks, nk = min(ks, Hp - k0);
    const T* wt = ring + (size_t)(S == 2 ? (i & 1) : 0) * ks * P::LDW;
    if (S == 2 && i + 1 < nsteps) {
      issue(i + 1, ring + (size_t)((i + 1) & 1) * ks * P::LDW);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      if (S == 1 && i > 0) {
        issue(i, ring);
        cp_async_commit();
      }
      cp_async_wait<0>();
    }
    if (!h_whole) fill_h_rows<BM>(hs, ldh, e, p, s_b, s_t, s_u, rows.T, rows.U, H, k0, nk);
    __syncthreads();
    if (active) {
      if (s == 0) {
#pragma unroll
        for (int j = 0; j < NI; ++j)
#pragma unroll
          for (int x = 0; x < 4; ++x) acc[0][j][x] = 0.f;
      }
      warp_product<TW, 1, NI, false, true>(acc, hs + (h_whole ? k0 : 0), ldh, 16 * wm, wt,
                                           P::LDW, n0, nk, lane);
    }
    if (active && s == nsl - 1) {  // the V tile's logits complete
      const bool extras_here = has_extra(cols, v0 + n0, NI * 8);
      float tile_max[2] = {-FLT_MAX, -FLT_MAX};
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int v = v0 + n0 + 8 * j + 2 * tq + q;
          const float bv = v < V ? bias[v] : 0.f;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float& x = acc[0][j][2 * r + q];
            x += bv;
            if (v < V) {
              const int m = row0 + 8 * r;
              tile_max[r] = fmaxf(tile_max[r], x);
              if (v == blank) s_bl[m] = x;
              if (v == lab[r]) s_le[m] = x;
              if (extras_here) {
                const int xk = extra_index(cols, v);
                if (xk >= 0 && s_b[m] >= 0)
                  lpx[(((long long)s_b[m] * rows.T + s_t[m]) * rows.U + s_u[m]) * cols.n + xk] = x;
              }
            }
          }
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(run_m[r], tile_max[r]);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < NI; ++j)
#pragma unroll
          for (int q = 0; q < 2; ++q)
            if (v0 + n0 + 8 * j + 2 * tq + q < V) sum += expf(acc[0][j][2 * r + q] - m_new);
        run_s[r] = run_s[r] * expf(run_m[r] - m_new) + sum;
        run_m[r] = m_new;
      }
    }
    __syncthreads();  // the W piece (and an h slice) consumed before its slot is refilled
  }

  // The four lanes of a quad share a row: combine them, then the WN warps
  // of a row through shared memory.
  if (active) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float m = run_m[r];
      for (int o = 1; o < 4; o <<= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      float s = run_s[r] * expf(run_m[r] - m);
      for (int o = 1; o < 4; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (tq == 0) {
        s_red[(wn * BM + row0 + 8 * r) * 2] = m;
        s_red[(wn * BM + row0 + 8 * r) * 2 + 1] = s;
      }
    }
  }
  __syncthreads();  // s_red, s_bl, s_le and lpx written
  if (tid < BM && s_b[tid] >= 0) {
    float m = -FLT_MAX;
    for (int w = 0; w < WN; ++w) m = fmaxf(m, s_red[(w * BM + tid) * 2]);
    float s = 0.f;
    for (int w = 0; w < WN; ++w)
      s += s_red[(w * BM + tid) * 2 + 1] * expf(s_red[(w * BM + tid) * 2] - m);
    const long long cell = ((long long)s_b[tid] * rows.T + s_t[tid]) * rows.U + s_u[tid];
    const float d = -(m + logf(s));
    denom[cell] = d;
    lpb[cell] = s_bl[tid] + d;
    lpe[cell] = s_le[tid] > float(wtt::kNeg) / 2 ? s_le[tid] + d : float(wtt::kNeg);
    for (int k = 0; k < cols.n; ++k) lpx[cell * cols.n + k] += d;
  }
}

// What a launch takes beside the kernel's type parameters.
struct Args {
  const float *e, *p;
  const void* W;
  const float* bias;
  const int* lab_full;
  Rows rows;
  float *lpb, *lpe, *denom, *lpx;
  wtt::ExtraCols cols;
  const float *Wd, *bias_d;
  float* dlog;
  int D, H, V, blank;
  cudaStream_t stream;
};

template <typename TW, int TM, bool kSliced>
int launch_tm(const Args& a) {
  constexpr int BM = Prep<TW, TM, kSliced>::BM;
  auto kernel = joint_prep_kernel<TW, TM, kSliced>;
  const Plan q = plan<TW>(a.H);
  const size_t bytes = (size_t)q.prep_smem;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const long long cells = (long long)a.rows.B * a.rows.T * a.rows.U;
  const long long blocks = (cells + BM - 1) / BM;
  kernel<<<(unsigned)blocks, kThreads, bytes, a.stream>>>(
      a.e, a.p, static_cast<const TW*>(a.W), a.bias, a.lab_full, a.rows, a.lpb, a.lpe, a.denom,
      a.lpx, a.cols, a.Wd, a.bias_d, a.dlog, a.D, a.H, a.V, a.blank, w_aligned<TW>(a.W, a.V),
      q.prep_hcols);
  return (int)cudaGetLastError();
}

template <typename TW>
int launch(const Args& a) {
  switch (tile_param(a.H)) {
    case 4: return launch_tm<TW, 4, false>(a);
    case 2: return launch_tm<TW, 2, false>(a);
    default:
      return padded_h(a.H) > kPassH ? launch_tm<TW, 1, true>(a) : launch_tm<TW, 1, false>(a);
  }
}

template <typename TW, int TM, bool kSliced>
int attrs_tm(int* regs, int* local_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, joint_prep_kernel<TW, TM, kSliced>);
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

// Registers a thread and local (spill) bytes of the kernel the wrapper
// launches at this H and W type, as ptxas compiled it. Returns the
// cudaError_t of the query.
int wtt_joint_prep_attrs(int H, int w_dtype, int* regs, int* local_bytes) {
  if (H < 1) return (int)cudaErrorInvalidValue;
  switch (w_dtype) {
    case wtt::kF32: return attrs<float>(H, regs, local_bytes);
    case wtt::kBF16: return attrs<__nv_bfloat16>(H, regs, local_bytes);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory the kernel asks for at this H (the larger of the two
// W types: the wrapper checks it against the card's limit).
long long wtt_joint_prep_smem(int H) {
  const long long f = plan<float>(H).prep_smem, b = plan<__nv_bfloat16>(H).prep_smem;
  return f > b ? f : b;
}

// e: (B,T,H) f32; p: (B,U,H) f32; W: (H,V) f32 (w_dtype 0) or bf16 (2);
// bias: (V,) f32; lab_full: (B,U) int32, -1 where the row has no label;
// offsets: (B+1) int64 running sums of T_b·U_b; label_lengths: (B,) int32;
// lpb, lpe, denom: (B,T,U) f32, pre-filled. lpx: (B,T,U,K) f32, pre-filled,
// for the K columns extra_cols (a host array, each inside [0, V); K <= 8;
// K = 0: lpx unused). Wd: (H,D) f32, bias_d: (D,) f32, dlog: (B,T,U,D) f32,
// pre-filled (D <= 8; D = 0: all three unused). Returns the launch's
// cudaError_t.
int wtt_joint_prep(const void* e, const void* p, const void* W, int w_dtype, const void* bias,
                   const int* lab_full, const void* offsets, const int* label_lengths, void* lpb,
                   void* lpe, void* denom, void* lpx, const int* extra_cols, int K,
                   const void* Wd, const void* bias_d, void* dlog, int D, int B, int T, int U,
                   int H, int V, int blank, void* stream) {
  if ((long long)B * T * U == 0 || V == 0) return 0;
  if (H < 0 || D < 0 || D > kPanel) return (int)cudaErrorInvalidValue;
  if ((K > 0 && lpx == nullptr) ||
      (D > 0 && (Wd == nullptr || bias_d == nullptr || dlog == nullptr)))
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const float*>(e), static_cast<const float*>(p), W,
         static_cast<const float*>(bias), lab_full,
         Rows{static_cast<const long long*>(offsets), label_lengths, B, T, U},
         static_cast<float*>(lpb), static_cast<float*>(lpe), static_cast<float*>(denom),
         static_cast<float*>(lpx), wtt::ExtraCols{}, static_cast<const float*>(Wd),
         static_cast<const float*>(bias_d), static_cast<float*>(dlog), D, H, V, blank,
         static_cast<cudaStream_t>(stream)};
  if (!wtt::extra_cols(extra_cols, K, V, &a.cols)) return (int)cudaErrorInvalidValue;
  switch (w_dtype) {
    case wtt::kF32: return launch<float>(a);
    case wtt::kBF16: return launch<__nv_bfloat16>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
