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
// (0: none), with no cap: the kernel is not instantiated per K or D. Up to 8
// of either, the columns come by value and the duration head in one warp
// pass a row; past 8, the instance of its own (kMany) looks the columns up
// in a device table (in the V tiles that their range reaches) and takes the
// duration head in groups of 8 columns, a warp pass a group.
//
// Types: e, p and bias arrive in f32. W is f32 or bf16. With bf16 W, h is
// rounded to bf16 before the product, as the JAX package rounds it, and the
// product runs on the tensor cores with f32 sums. With f32 W the product is
// three TF32 products of the split operands (joint.cuh, Op<float>): f32
// accuracy on the tensor cores. The duration head takes the unrounded h and
// f32 Wd in both cases: a warp per row recomputes tanh from e and p
// (joint.cuh::dur_row; H·D FMAs a row beside the token head's H·V).
//
// Bound on this card: operations, 2·R·H·V over the tensor cores' rate
// (R = valid rows; 989 TFLOP/s bf16, 495 / 3 with f32 W's three TF32
// products). The bytes are e, p, W and three (B, T, U) fields, far less.
//
// Design. Three kernels a call, on the product engine of joint.cuh:
// * joint_w_kernel lays W out once a call as Wᵀ (Vp × Hp, K-major for the
//   logits' B; with f32 W split into its tf32 hi and lo), in the tiles the
//   engine's ring copies whole, through 32 × 32 tiles in shared memory; the
//   gradient's first chunk also lays out W itself (Hp × Vp, for dh = g·Wᵀ).
// * joint_h_kernel writes h of a chunk of valid rows (chunk × Hp, bf16 or
//   split f32, in tiles; zeros past H and past the last row of the last
//   tile), and with the gradient also hᵀ (Hp × chunk).
// * joint_prep_kernel: a block owns 128 consecutive valid rows of the chunk
//   and walks V in tiles of 128 columns, each tile's logits (two
//   warpgroups' m64n128 accumulators) summed over the k-slices of Hp that
//   stream through the ring, the ring running ahead across the V tiles. On
//   the last slice of a tile, the epilogue adds the bias and takes the online
//   (max, sum-exp) on the accumulator fragments (a lane holds two rows and
//   two columns of each n8 tile; the four lanes of a quad share a row and
//   combine at the end), and picks up the blank, label and K extra logits as
//   the loop passes their columns, so the label logit is the very value the
//   loop produced. No H-wide sum is held, so there are no passes at any H.
//   Each ring step is bound by the latency of its copies (a block's h tile
//   kept resident across the V tiles halved the bytes but, at one block a
//   multiprocessor, ran slower, PERF.md §6).
#include "joint.cuh"

namespace {

using namespace wtt::joint;

// ---- the layouts ---------------------------------------------------------------

// Wᵀ to wt (Vp rows, Hp columns) and, with `wp`, W to wp (Hp rows, Vp
// columns), both stored in tiles (joint.cuh::tiled) in the operand type,
// zero outside H × V (an f32 operand's lo array Hp·Vp elements after its
// hi). A block a 32 × 32 tile through shared memory; plain loads, so W needs
// no alignment.
template <typename TW>
__global__ void __launch_bounds__(kThreads)
joint_w_kernel(const TW* __restrict__ W, int H, int V, typename Op<TW>::T* __restrict__ wt,
               typename Op<TW>::T* __restrict__ wp) {
  using O = Op<TW>;
  __shared__ float tile[32][33];
  const int Hp = pad128(H), Vp = pad128(V);
  const long long n = (long long)Hp * Vp;
  const int k0 = blockIdx.y * 32, v0 = blockIdx.x * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int r = ty; r < 32; r += kThreads / 32) {
    const int k = k0 + r, v = v0 + tx;
    const float x = k < H && v < V ? O::from(W[(long long)k * V + v]) : 0.f;
    tile[r][tx] = x;
    if (wp != nullptr) O::put(wp, n, tiled<TW>(k, v, Vp), x);
  }
  __syncthreads();
  for (int r = ty; r < 32; r += kThreads / 32)
    O::put(wt, n, tiled<TW>(v0 + r, k0 + tx, Hp), tile[tx][r]);
}

// h of the chunk's rows row_begin + [0, chunk) to h (chunk rows, Hp
// columns) and, with `ht`, to ht (Hp rows, chunk columns), both in tiles,
// for the 128-row tiles that hold a valid row (zeros past the last row and
// past H); tiles past the end are left alone (nothing reads them). A block a
// tile's 32 columns; a warp writes 8 rows × 4 pieces a step, whole core
// matrices.
template <typename TW>
__global__ void __launch_bounds__(kThreads)
joint_h_kernel(const float* __restrict__ e, const float* __restrict__ p, Rows rows,
               long long row_begin, int chunk, int H, typename Op<TW>::T* __restrict__ h,
               typename Op<TW>::T* __restrict__ ht) {
  using O = Op<TW>;
  constexpr int E = O::kE, P = 32 / E;  // pieces of a row's 32 columns
  __shared__ float tile[kBM][33];
  __shared__ int s_b[kBM], s_t[kBM], s_u[kBM];
  const long long first = row_begin + (long long)blockIdx.x * kBM;
  if (first >= rows.offsets[rows.B]) return;
  const int Hp = pad128(H), k0 = blockIdx.y * 32;
  const long long n = (long long)chunk * Hp;
  place_rows<kBM>(rows, first, s_b, s_t, s_u);
  __syncthreads();
  h_tile(tile, e, p, s_b, s_t, s_u, rows.T, rows.U, H, k0);
  __syncthreads();
  const long long m0 = first - row_begin;
  for (int idx = threadIdx.x; idx < kBM * P; idx += kThreads) {
    const int rr = idx & 7, c = (idx >> 3) % P, m = (idx >> 3) / P * 8 + rr;
    float x[E];
#pragma unroll
    for (int q = 0; q < E; ++q) x[q] = tile[m][c * E + q];
    O::put_piece(h, n, tiled<TW>(m0 + m, k0 + c * E, Hp), x);
  }
  if (ht == nullptr) return;
  for (int idx = threadIdx.x; idx < 32 * (kBM / E); idx += kThreads) {
    const int rr = idx & 7, c = (idx >> 3) % (kBM / E), kk = (idx >> 3) / (kBM / E) * 8 + rr;
    float x[E];
#pragma unroll
    for (int q = 0; q < E; ++q) x[q] = tile[c * E + q][kk];
    O::put_piece(ht, n, tiled<TW>(k0 + kk, (int)m0 + c * E, chunk), x);
  }
}

// ---- the prep -------------------------------------------------------------------

template <typename TW, bool kMany = false>
__global__ void __launch_bounds__(kThreads, 1)
joint_prep_kernel(const typename Op<TW>::T* __restrict__ h, const typename Op<TW>::T* __restrict__ wt,
                  int chunk, const float* __restrict__ bias, const int* __restrict__ lab_full,
                  Rows rows, long long row_begin, float* __restrict__ lpb,
                  float* __restrict__ lpe, float* __restrict__ denom, float* __restrict__ lpx,
                  const wtt::ExtraCols cols, const float* __restrict__ e,
                  const float* __restrict__ p, const float* __restrict__ Wd,
                  const float* __restrict__ bias_d, float* __restrict__ dlog, int D, int H, int V,
                  int blank, const ManyCols many) {
  using O = Op<TW>;
  using T = typename O::T;
  constexpr int KS = O::kKS;
  const long long first = row_begin + (long long)blockIdx.x * kBM;
  if (first >= rows.offsets[rows.B]) return;
  const int Hp = pad128(H), Vp = pad128(V);
  extern __shared__ __align__(128) unsigned char joint_smem[];
  unsigned char* ring = joint_smem;
  uint64_t* bars = reinterpret_cast<uint64_t*>(joint_smem + kRingBytes<TW>);
  float* s_bl = reinterpret_cast<float*>(joint_smem + kRingBytes<TW> + kBars);  // blank logit a row
  float* s_le = s_bl + kBM;                                            // label logit a row
  float* s_red = s_le + kBM;                                           // (max, sum) a row
  int* s_b = reinterpret_cast<int*>(s_red + 2 * kBM);
  int* s_t = s_b + kBM;
  int* s_u = s_t + kBM;
  int* s_lab = s_u + kBM;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  place_rows<kBM>(rows, first, s_b, s_t, s_u);
  __syncthreads();
  if (tid < kBM) {
    const int b = s_b[tid];
    s_lab[tid] = b >= 0 ? lab_full[(long long)b * rows.U + s_u[tid]] : -1;
    s_bl[tid] = float(wtt::kNeg);
    s_le[tid] = float(wtt::kNeg);
  }
  if (D > 0) {  // the duration head: a warp a row, the rows dealt round robin
    for (int m = warp; m < kBM; m += kWarps) {
      const int b = s_b[m];
      if (b < 0) break;
      float out[kPanel];
      const float* e_row = e + ((long long)b * rows.T + s_t[m]) * H;
      const float* p_row = p + ((long long)b * rows.U + s_u[m]) * H;
      float* dst = dlog + (((long long)b * rows.T + s_t[m]) * rows.U + s_u[m]) * D;
      if constexpr (kMany) {  // a group of kPanel columns a pass
        for (int d0 = 0; d0 < D; d0 += kPanel) {
          dur_row_group(e_row, p_row, Wd, H, D, d0, min(kPanel, D - d0), lane, out);
          store_dur_row(dst + d0, out, bias_d + d0, min(kPanel, D - d0), lane);
        }
      } else {
        dur_row(e_row, p_row, Wd, H, D, lane, out);
        store_dur_row(dst, out, bias_d, D, lane);
      }
    }
  }
  __syncthreads();  // s_lab (the ring's first step synchronises again)

  const Frag f;
  const int lab[2] = {s_lab[f.row0], s_lab[f.row0 + 8]};
  float run_m[2] = {-FLT_MAX, -FLT_MAX}, run_s[2] = {0.f, 0.f};
  float acc[64], part[64];
  const int nk = Hp / KS;  // k-slices a V tile
  const Src<T> a = row_tile<TW>(h, (first - row_begin) / kBM, Hp, (long long)chunk * Hp);
  const Src<T> b = row_tile<TW>(wt, 0, Hp, (long long)Vp * Hp);
  run_ring<kStageBytes<TW>>(
      Vp / kBN * nk, ring, bars,
      [&](int i, unsigned char* stage, uint32_t bar) {
        load_stage<TW>(stage, bar, a, i % nk, b, i);  // B: V tile i / nk, k-slice i % nk
      },
      [&](int i, uint32_t stage) {
        mma_step<TW>(acc, part, stage, f.wg, i % nk == 0);
        if (i % nk != nk - 1) return;
        // The V tile's logits complete.
        const int v0 = i / nk * kBN;
        // (a kMany launch for a wide duration head may carry K <= kPanel by value)
        const bool by_table = kMany && cols.n > kPanel;
        const bool extras_here = by_table ? has_extra(many, v0, kBN) : has_extra(cols, v0, kBN);
        float tile_max[2] = {-FLT_MAX, -FLT_MAX};
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int v = v0 + 8 * j + f.tq2 + q;
            const float bv = v < V ? bias[v] : 0.f;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              float& x = acc[4 * j + 2 * r + q];
              x += bv;
              if (v < V) {
                const int m = f.row0 + 8 * r;
                tile_max[r] = fmaxf(tile_max[r], x);
                if (v == blank) s_bl[m] = x;
                if (v == lab[r]) s_le[m] = x;
                if (extras_here) {
                  const int xk = by_table ? extra_index(many, cols.n, v) : extra_index(cols, v);
                  if (xk >= 0 && s_b[m] >= 0)
                    lpx[(((long long)s_b[m] * rows.T + s_t[m]) * rows.U + s_u[m]) * cols.n + xk] =
                        x;
                }
              }
            }
          }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float m_new = fmaxf(run_m[r], tile_max[r]);
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < 16; ++j)
#pragma unroll
            for (int q = 0; q < 2; ++q)
              if (v0 + 8 * j + f.tq2 + q < V) sum += expf(acc[4 * j + 2 * r + q] - m_new);
          run_s[r] = run_s[r] * expf(run_m[r] - m_new) + sum;
          run_m[r] = m_new;
        }
      });

  // The four lanes of a quad share a row: combine them.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float m = run_m[r];
    for (int o = 1; o < 4; o <<= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float s = run_s[r] * expf(run_m[r] - m);
    for (int o = 1; o < 4; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (f.tq2 == 0) {
      s_red[(f.row0 + 8 * r) * 2] = m;
      s_red[(f.row0 + 8 * r) * 2 + 1] = s;
    }
  }
  __syncthreads();  // s_red, s_bl, s_le and lpx written
  if (tid < kBM && s_b[tid] >= 0) {
    const long long cell = ((long long)s_b[tid] * rows.T + s_t[tid]) * rows.U + s_u[tid];
    const float d = -(s_red[tid * 2] + logf(s_red[tid * 2 + 1]));
    denom[cell] = d;
    lpb[cell] = s_bl[tid] + d;
    lpe[cell] = s_le[tid] > float(wtt::kNeg) / 2 ? s_le[tid] + d : float(wtt::kNeg);
    for (int k = 0; k < cols.n; ++k) lpx[cell * cols.n + k] += d;
  }
}

// ---- launches -------------------------------------------------------------------

template <typename TW>
int weights(const void* W, int H, int V, void* wt, void* wp, cudaStream_t stream) {
  using T = typename Op<TW>::T;
  const dim3 grid(pad128(V) / 32, pad128(H) / 32);
  joint_w_kernel<TW><<<grid, kThreads, 0, stream>>>(static_cast<const TW*>(W), H, V,
                                                     static_cast<T*>(wt), static_cast<T*>(wp));
  return (int)cudaGetLastError();
}

template <typename TW>
int h_chunk(const float* e, const float* p, const Rows& rows, long long row_begin, int chunk,
            int H, void* h, void* ht, cudaStream_t stream) {
  using T = typename Op<TW>::T;
  const dim3 grid(chunk / kBM, pad128(H) / 32);
  joint_h_kernel<TW><<<grid, kThreads, 0, stream>>>(e, p, rows, row_begin, chunk, H,
                                                     static_cast<T*>(h), static_cast<T*>(ht));
  return (int)cudaGetLastError();
}

struct Args {
  const float *e, *p;
  const void* W;
  const float* bias;
  const int* lab_full;
  Rows rows;
  float *lpb, *lpe, *denom, *lpx;
  wtt::ExtraCols cols;
  ManyCols many;  // K > kPanel: the device table and its range
  const float *Wd, *bias_d;
  float* dlog;
  int D, H, V, blank;
  void *wt, *h;
  int chunk;
  cudaStream_t stream;
};

template <typename TW>
int launch_prep(const Args& a) {
  using T = typename Op<TW>::T;
  int err = weights<TW>(a.W, a.H, a.V, a.wt, nullptr, a.stream);
  if (err != 0) return err;
  const Plan q = plan<TW>(a.H, a.V, 0);
  const long long cells = (long long)a.rows.B * a.rows.T * a.rows.U;
  for (long long r0 = 0; r0 < cells; r0 += a.chunk) {
    err = h_chunk<TW>(a.e, a.p, a.rows, r0, a.chunk, a.H, a.h, nullptr, a.stream);
    if (err != 0) return err;
    // Past kPanel extra or duration columns, the kMany instance.
    auto kernel = a.cols.n > kPanel || a.D > kPanel ? joint_prep_kernel<TW, true>
                                                    : joint_prep_kernel<TW, false>;
    err = (int)launch(kernel, dim3(a.chunk / kBM), (size_t)q.prep_smem, a.stream,
                      static_cast<const T*>(a.h), static_cast<const T*>(a.wt), a.chunk, a.bias,
                      a.lab_full, a.rows, r0, a.lpb, a.lpe, a.denom, a.lpx, a.cols, a.e, a.p, a.Wd,
                      a.bias_d, a.dlog, a.D, a.H, a.V, a.blank, a.many);
    if (err != 0) return err;
  }
  return 0;
}

template <typename TW>
int attrs(int which, int* regs, int* local_bytes) {
  switch (which) {
    case 0: return kernel_attrs(joint_w_kernel<TW>, regs, local_bytes);
    case 1: return kernel_attrs(joint_h_kernel<TW>, regs, local_bytes);
    default: return kernel_attrs(joint_prep_kernel<TW>, regs, local_bytes);
  }
}

}  // namespace

extern "C" {

// The plan of the fused joint kernels at this H, V and W type (w_dtype as
// below), for the mirror in ops/cuda/joint.py: out = {hp, vp, ks, stages,
// prep_smem, g_smem, dh_smem, dw_smem, prep_rows, grad_rows}
// (joint.cuh::Plan), the chunks' buffers at most chunk_bytes. Returns the
// cudaError_t of the query.
int wtt_joint_plan(int H, int V, int w_dtype, long long chunk_bytes, long long* out) {
  if (H < 1 || V < 1 || chunk_bytes < 0) return (int)cudaErrorInvalidValue;
  Plan q;
  switch (w_dtype) {
    case wtt::kF32: q = plan<float>(H, V, chunk_bytes); break;
    case wtt::kBF16: q = plan<__nv_bfloat16>(H, V, chunk_bytes); break;
    default: return (int)cudaErrorInvalidValue;
  }
  const long long v[] = {q.hp, q.vp, q.ks, q.stages, q.prep_smem, q.g_smem, q.dh_smem,
                         q.dw_smem, q.prep_rows, q.grad_rows};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
  return 0;
}

// Registers a thread and local (spill) bytes of joint_w_kernel (which = 0),
// joint_h_kernel (1) or joint_prep_kernel (2) with W of this type, as ptxas
// compiled it. Returns the cudaError_t of the query.
int wtt_joint_prep_attrs(int which, int w_dtype, int* regs, int* local_bytes) {
  switch (w_dtype) {
    case wtt::kF32: return attrs<float>(which, regs, local_bytes);
    case wtt::kBF16: return attrs<__nv_bfloat16>(which, regs, local_bytes);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory the prep kernel asks for at this H (the larger of
// the two W types: the wrapper checks it against the card's limit).
long long wtt_joint_prep_smem(int H) {
  const long long f = plan<float>(H, 1, 0).prep_smem, b = plan<__nv_bfloat16>(H, 1, 0).prep_smem;
  return f > b ? f : b;
}

// W: (H,V) f32 (w_dtype 0) or bf16 (2), any alignment, to wt: Wᵀ (Vp, Hp)
// and, unless null, wp: W (Hp, Vp), H and V padded to multiples of 128 with
// zeros, bf16, or f32 as two arrays (tf32 hi, then lo). Returns the launch's
// cudaError_t.
int wtt_joint_weights(const void* W, int w_dtype, int H, int V, void* wt, void* wp,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (w_dtype) {
    case wtt::kF32: return weights<float>(W, H, V, wt, wp, s);
    case wtt::kBF16: return weights<__nv_bfloat16>(W, H, V, wt, wp, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// h of the valid rows row_begin .. row_begin + chunk − 1 (row_begin and
// chunk multiples of 128) to h: (chunk, Hp) and, unless null, ht: (Hp,
// chunk), in W's operand type (w_dtype as above). Returns the launch's
// cudaError_t.
int wtt_joint_h(const void* e, const void* p, const void* offsets, const int* label_lengths,
                int B, int T, int U, int H, long long row_begin, int chunk, int w_dtype, void* h,
                void* ht, void* stream) {
  if (chunk % kBM != 0 || row_begin % kBM != 0) return (int)cudaErrorInvalidValue;
  const Rows rows{static_cast<const long long*>(offsets), label_lengths, B, T, U};
  const float* ef = static_cast<const float*>(e);
  const float* pf = static_cast<const float*>(p);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (w_dtype) {
    case wtt::kF32: return h_chunk<float>(ef, pf, rows, row_begin, chunk, H, h, ht, s);
    case wtt::kBF16: return h_chunk<__nv_bfloat16>(ef, pf, rows, row_begin, chunk, H, h, ht, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// e: (B,T,H) f32; p: (B,U,H) f32; W: (H,V) f32 (w_dtype 0) or bf16 (2);
// bias: (V,) f32; lab_full: (B,U) int32, -1 where the row has no label;
// offsets: (B+1) int64 running sums of T_b·U_b; label_lengths: (B,) int32;
// lpb, lpe, denom: (B,T,U) f32, pre-filled. lpx: (B,T,U,K) f32, pre-filled,
// for the K columns extra_cols (a host array, each inside [0, V); any K;
// K = 0: lpx unused); table: the same columns as an int32 array in device
// memory, read past 8 of them (may be null up to that). Wd: (H,D) f32,
// bias_d: (D,) f32, dlog: (B,T,U,D) f32, pre-filled (any D; D = 0: all
// three unused). Scratch: wt, Wᵀ as
// wtt_joint_weights writes it, and h, a chunk's h as wtt_joint_h writes it,
// for chunks of `chunk` rows (a multiple of 128). The launches run chunk by
// chunk over all B·T·U cells. Returns the launches' cudaError_t.
int wtt_joint_prep(const void* e, const void* p, const void* W, int w_dtype, const void* bias,
                   const int* lab_full, const void* offsets, const int* label_lengths, void* lpb,
                   void* lpe, void* denom, void* lpx, const int* extra_cols, int K,
                   const int* table, const void* Wd, const void* bias_d, void* dlog, int D,
                   void* wt, void* h, int chunk, int B, int T, int U, int H, int V, int blank,
                   void* stream) {
  if ((long long)B * T * U == 0 || V == 0) return 0;
  if (H < 1 || D < 0 || chunk < kBM || chunk % kBM != 0) return (int)cudaErrorInvalidValue;
  if ((K > 0 && lpx == nullptr) ||
      (D > 0 && (Wd == nullptr || bias_d == nullptr || dlog == nullptr)))
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const float*>(e), static_cast<const float*>(p), W,
         static_cast<const float*>(bias), lab_full,
         Rows{static_cast<const long long*>(offsets), label_lengths, B, T, U},
         static_cast<float*>(lpb), static_cast<float*>(lpe), static_cast<float*>(denom),
         static_cast<float*>(lpx), wtt::ExtraCols{}, ManyCols{},
         static_cast<const float*>(Wd), static_cast<const float*>(bias_d),
         static_cast<float*>(dlog), D, H, V, blank, wt, h, chunk,
         static_cast<cudaStream_t>(stream)};
  if (!read_cols(extra_cols, K, table, V, &a.cols, &a.many)) return (int)cudaErrorInvalidValue;
  switch (w_dtype) {
    case wtt::kF32: return launch_prep<float>(a);
    case wtt::kBF16: return launch_prep<__nv_bfloat16>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
