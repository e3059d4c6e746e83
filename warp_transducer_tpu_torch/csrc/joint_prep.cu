// Fused joint prep kernel: from the projected encoder and prediction
// activations straight to the three (B, T, U) lattice inputs, without the
// (B, T, U, V) logits ever reaching device memory.
//
// Replaces: warp_transducer_tpu/ops/pallas/joint_fused.py::_prep_kernel
// (called through fused_prep and fused_prep_chunked).
//
// Per valid row r = (b, t, u): h = tanh(e[b,t] + p[b,u]) (H values, f32),
// logits = h·W + bias over all V, an online (max, sum-exp) gives
// denom = -(m + log s), lpb = logits[blank] + denom, and
// lpe = logits[label] + denom, or NEG where the row has no label (u = U-1,
// or a label outside [0, V)). Rows outside (t < T_b) & (u < U_b) are not
// touched: the wrapper pre-fills lpb and lpe with NEG and denom with 0, as
// the plain version (ops/fused_joint.py::fused_prep) writes them.
//
// Types: e, p and bias arrive in f32. W is f32 or bf16. With f32 W every
// product is a full-f32 FMA. With bf16 W, h is rounded to bf16 before the
// product, as the JAX package rounds it; a product of two bf16 values is
// exact in f32 and the sum is kept in f32, which is what a bf16 tensor-core
// product with f32 accumulation computes, in another order.
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
// gathered W[:, labels] tensor exists. W streams from device memory for any
// H·V (it stays in the 50 MB L2 at these sizes), so one launch covers all
// of V: there are no V chunks and no partial outputs to merge.
#include "joint.cuh"

namespace {

using namespace wtt::joint;

constexpr int kTN = 8;
constexpr int kBN = kDim * kTN;  // 128 columns

// kTM = 4, 2, 1 (tiles of 64, 32, 16 rows) for H <= 256, 512, 1024, so that
// the h tile stays near 64 KB.
template <typename TW, bool kRound, int kTM>
__global__ void __launch_bounds__(kThreads)
joint_prep_kernel(const float* __restrict__ e, const float* __restrict__ p,
                  const TW* __restrict__ W, const float* __restrict__ bias,
                  const int* __restrict__ lab_full, Rows rows, float* __restrict__ lpb,
                  float* __restrict__ lpe, float* __restrict__ denom, int H, int V, int blank) {
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

  __syncthreads();  // s_bl, s_le written by the threads that met the columns
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    // The 16 tx lanes of one row sit in one half of a warp.
    float m = run_m[i];
    for (int o = kDim / 2; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float s = run_s[i] * expf(run_m[i] - m);
    for (int o = kDim / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const int row = ty + kDim * i;
    if (tx == 0 && s_b[row] >= 0) {
      const long long cell = ((long long)s_b[row] * rows.T + s_t[row]) * rows.U + s_u[row];
      const float d = -(m + logf(s));
      denom[cell] = d;
      lpb[cell] = s_bl[row] + d;
      lpe[cell] = s_le[row] > float(wtt::kNeg) / 2 ? s_le[row] + d : float(wtt::kNeg);
    }
  }
}

size_t smem_bytes(int H) {
  const int kBM = kDim * tile_param(H);
  const int Hp = (H + kBK - 1) / kBK * kBK;
  return sizeof(float) * ((size_t)Hp * (kBM + 1) + kBK * (kBN + 1) + 2 * kBM) +
         sizeof(int) * 4 * kBM;
}

template <typename TW, bool kRound, int kTM>
int launch_tm(const float* e, const float* p, const void* W, const float* bias,
           const int* lab_full, Rows rows, float* lpb, float* lpe, float* denom, int H, int V,
           int blank, cudaStream_t stream) {
  constexpr int kBM = kDim * kTM;
  auto kernel = joint_prep_kernel<TW, kRound, kTM>;
  const size_t bytes = smem_bytes(H);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const long long cells = (long long)rows.B * rows.T * rows.U;
  const long long blocks = (cells + kBM - 1) / kBM;
  kernel<<<(unsigned)blocks, kThreads, bytes, stream>>>(e, p, static_cast<const TW*>(W), bias,
                                                        lab_full, rows, lpb, lpe, denom, H, V,
                                                        blank);
  return (int)cudaGetLastError();
}

template <typename TW, bool kRound>
int launch(const float* e, const float* p, const void* W, const float* bias,
           const int* lab_full, Rows rows, float* lpb, float* lpe, float* denom, int H, int V,
           int blank, cudaStream_t stream) {
  switch (tile_param(H)) {
    case 4:
      return launch_tm<TW, kRound, 4>(e, p, W, bias, lab_full, rows, lpb, lpe, denom, H, V,
                                      blank, stream);
    case 2:
      return launch_tm<TW, kRound, 2>(e, p, W, bias, lab_full, rows, lpb, lpe, denom, H, V,
                                      blank, stream);
    default:
      return launch_tm<TW, kRound, 1>(e, p, W, bias, lab_full, rows, lpb, lpe, denom, H, V,
                                      blank, stream);
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
// lpb, lpe, denom: (B,T,U) f32, pre-filled. Returns the launch's cudaError_t.
int wtt_joint_prep(const void* e, const void* p, const void* W, int w_dtype, const void* bias,
                   const int* lab_full, const void* offsets, const int* label_lengths, void* lpb,
                   void* lpe, void* denom, int B, int T, int U, int H, int V, int blank,
                   void* stream) {
  if ((long long)B * T * U == 0 || V == 0) return 0;
  if (H > kMaxH) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Rows rows{static_cast<const long long*>(offsets), label_lengths, B, T, U};
  const float* ef = static_cast<const float*>(e);
  const float* pf = static_cast<const float*>(p);
  const float* bf = static_cast<const float*>(bias);
  float* o1 = static_cast<float*>(lpb);
  float* o2 = static_cast<float*>(lpe);
  float* o3 = static_cast<float*>(denom);
  switch (w_dtype) {
    case wtt::kF32:
      return launch<float, false>(ef, pf, W, bf, lab_full, rows, o1, o2, o3, H, V, blank, s);
    case wtt::kBF16:
      return launch<__nv_bfloat16, true>(ef, pf, W, bf, lab_full, rows, o1, o2, o3, H, V, blank,
                                         s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
