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
// Types: e, p and bias arrive in f32. W is f32 or bf16. With f32 W every
// product is a full-f32 FMA. With bf16 W, h is rounded to bf16 before the
// product, as the JAX package rounds it; a product of two bf16 values is
// exact in f32 and the sum is kept in f32, which is what a bf16 tensor-core
// product with f32 accumulation computes, in another order. The duration
// head takes the unrounded h and f32 Wd in both cases: a warp per row
// recomputes tanh from e and p (joint.cuh::dur_row; H·D FMAs a row beside
// the token head's H·V), which keeps a second, unrounded h tile out of
// shared memory.
//
// Bound on this card: operations, 2·R·H·V over the float32 rate (R = valid
// rows). The bytes are e, p, W and three (B, T, U) fields, far less.
//
// Design: a block owns a tile of 64 consecutive valid rows (joint.cuh; 32
// or 16 rows for H above 256 or 512) and builds its h tile once in dynamic
// shared memory (64 × H f32: 65 KB at H = 256; the wrapper checks the size
// against the card's limit and H against 1024). It then walks V in tiles
// of 128 columns, streaming W through shared memory in chunks of 16 × 128,
// each thread holding a 4 × 8 micro-tile of logits in registers, and folds
// each tile into a per-thread running (max, sum-exp) for its rows; the 16
// threads that share a row combine once, at the end, with shuffles. The
// blank and the label logits are picked up as the V loop passes their
// columns, so the label logit is the very value the loop produced and no
// gathered W[:, labels] tensor exists. The K extra logits go the same way
// but through lpx itself: the thread that meets column col_k writes the bare
// logit there, and the row's lane k adds denom at the end. Shared memory and
// registers are spent on nothing that K = 0 and D = 0 do not need: at H = 256
// three blocks fit a multiprocessor only just (3 × 75 KB, at most 85
// registers a thread: the launch bounds below). W streams from device memory for any
// H·V (it stays in the 50 MB L2 at these sizes), so one launch covers all
// of V: there are no V chunks and no partial outputs to merge.
#include "joint.cuh"

namespace {

using namespace wtt::joint;

constexpr int kTN = 8;
constexpr int kBN = kDim * kTN;  // 128 columns

// kTM = 4, 2, 1 (tiles of 64, 32, 16 rows) for H <= 256, 512, 1024, so that
// the h tile stays near 64 KB. Three blocks a multiprocessor fit by shared
// memory at each of them, so the registers are held to three blocks too (85
// a thread): left alone, the duration head's and the extra columns' code
// takes the kTM = 4 kernel to 118, two blocks, and K = 0, D = 0 pays for it.
template <typename TW, bool kRound, int kTM>
__global__ void __launch_bounds__(kThreads, 3)
joint_prep_kernel(const float* __restrict__ e, const float* __restrict__ p,
                  const TW* __restrict__ W, const float* __restrict__ bias,
                  const int* __restrict__ lab_full, Rows rows, float* __restrict__ lpb,
                  float* __restrict__ lpe, float* __restrict__ denom, float* __restrict__ lpx,
                  const wtt::ExtraCols cols, const float* __restrict__ Wd,
                  const float* __restrict__ bias_d, float* __restrict__ dlog, int D, int H, int V,
                  int blank) {
  constexpr int kBM = kDim * kTM;
  const long long first = (long long)blockIdx.x * kBM;
  if (first >= rows.offsets[rows.B]) return;
  const int Hp = (H + kBK - 1) / kBK * kBK;
  const int ldh = kBM + 1;
  extern __shared__ float smem[];
  float* hs = smem;                     // Hp × ldh
  float* ws = hs + Hp * ldh;            // kBK × (kBN + 1)
  float* s_bl = ws + kBK * (kBN + 1);   // blank logit per row
  float* s_le = s_bl + kBM;             // label logit per row
  int* s_b = reinterpret_cast<int*>(s_le + kBM);
  int* s_t = s_b + kBM;
  int* s_u = s_t + kBM;
  int* s_lab = s_u + kBM;

  const int tid = threadIdx.x, tx = tid % kDim, ty = tid / kDim;
  place_rows<kBM>(rows, first, s_b, s_t, s_u);
  __syncthreads();
  if (tid < kBM) {
    const int b = s_b[tid];
    s_lab[tid] = b >= 0 ? lab_full[(long long)b * rows.U + s_u[tid]] : -1;
    s_bl[tid] = float(wtt::kNeg);
    s_le[tid] = float(wtt::kNeg);
  }
  fill_h<kBM>(hs, ldh, e, p, s_b, s_t, s_u, rows.T, rows.U, H, Hp, kRound);
  if (D > 0) {  // the duration head: a warp a row, the rows dealt round robin
    const int warp = tid / wtt::kWarp, lane = tid % wtt::kWarp;
    for (int m = warp; m < kBM; m += kThreads / wtt::kWarp) {
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

  int lab[kTM];
  float run_m[kTM], run_s[kTM];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    lab[i] = s_lab[ty + kDim * i];
    run_m[i] = -FLT_MAX;
    run_s[i] = 0.f;
  }

  for (int v0 = 0; v0 < V; v0 += kBN) {
    float acc[kTM][kTN] = {};
    for (int k0 = 0; k0 < Hp; k0 += kBK) {
      load_w_chunk<kBN>(ws, W, H, V, k0, v0);
      __syncthreads();
      mma_tile<kTM, kTN>(acc, hs + k0 * ldh, ldh, ws, kBN + 1, kBK, ty, tx);
      __syncthreads();
    }
    float bv[kTN];
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int v = v0 + tx + kDim * j;
      bv[j] = v < V ? bias[v] : 0.f;
    }
    const bool extras_here = has_extra(cols, v0, kBN);
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      float tile_max = -FLT_MAX;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int v = v0 + tx + kDim * j;
        acc[i][j] += bv[j];
        if (v < V) {
          tile_max = fmaxf(tile_max, acc[i][j]);
          if (v == blank) s_bl[ty + kDim * i] = acc[i][j];
          if (v == lab[i]) s_le[ty + kDim * i] = acc[i][j];
          if (extras_here) {
            const int row = ty + kDim * i, xk = extra_index(cols, v);
            if (xk >= 0 && s_b[row] >= 0)
              lpx[(((long long)s_b[row] * rows.T + s_t[row]) * rows.U + s_u[row]) * cols.n + xk] =
                  acc[i][j];
          }
        }
      }
      const float m_new = fmaxf(run_m[i], tile_max);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kTN; ++j)
        if (v0 + tx + kDim * j < V) sum += expf(acc[i][j] - m_new);
      run_s[i] = run_s[i] * expf(run_m[i] - m_new) + sum;
      run_m[i] = m_new;
    }
  }

  __syncthreads();  // s_bl, s_le, lpx written by the threads that met the columns
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    // The 16 tx lanes of one row sit in one half of a warp.
    float m = run_m[i];
    for (int o = kDim / 2; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float s = run_s[i] * expf(run_m[i] - m);
    for (int o = kDim / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const int row = ty + kDim * i;
    // Every lane of the row holds m and s; lane 0 writes the three fields,
    // lane k < K extra column k.
    if (s_b[row] >= 0 && (tx == 0 || tx < cols.n)) {
      const long long cell = ((long long)s_b[row] * rows.T + s_t[row]) * rows.U + s_u[row];
      const float d = -(m + logf(s));
      if (tx == 0) {
        denom[cell] = d;
        lpb[cell] = s_bl[row] + d;
        lpe[cell] = s_le[row] > float(wtt::kNeg) / 2 ? s_le[row] + d : float(wtt::kNeg);
      }
      if (tx < cols.n) lpx[cell * cols.n + tx] += d;
    }
  }
}

size_t smem_bytes(int H) {
  const int kBM = kDim * tile_param(H);
  const int Hp = (H + kBK - 1) / kBK * kBK;
  return sizeof(float) * ((size_t)Hp * (kBM + 1) + kBK * (kBN + 1) + 2 * kBM) +
         sizeof(int) * 4 * kBM;
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

template <typename TW, bool kRound, int kTM>
int launch_tm(const Args& a) {
  constexpr int kBM = kDim * kTM;
  auto kernel = joint_prep_kernel<TW, kRound, kTM>;
  const size_t bytes = smem_bytes(a.H);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const long long cells = (long long)a.rows.B * a.rows.T * a.rows.U;
  const long long blocks = (cells + kBM - 1) / kBM;
  kernel<<<(unsigned)blocks, kThreads, bytes, a.stream>>>(
      a.e, a.p, static_cast<const TW*>(a.W), a.bias, a.lab_full, a.rows, a.lpb, a.lpe, a.denom,
      a.lpx, a.cols, a.Wd, a.bias_d, a.dlog, a.D, a.H, a.V, a.blank);
  return (int)cudaGetLastError();
}

template <typename TW, bool kRound>
int launch(const Args& a) {
  switch (tile_param(a.H)) {
    case 4: return launch_tm<TW, kRound, 4>(a);
    case 2: return launch_tm<TW, kRound, 2>(a);
    default: return launch_tm<TW, kRound, 1>(a);
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory the kernel asks for at this H, for the wrapper's
// check against the card's limit.
long long wtt_joint_prep_smem(int H) { return (long long)smem_bytes(H); }

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
  if (H > kMaxH || D < 0 || D > kPanel) return (int)cudaErrorInvalidValue;
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
    case wtt::kF32: return launch<float, false>(a);
    case wtt::kBF16: return launch<__nv_bfloat16, true>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
