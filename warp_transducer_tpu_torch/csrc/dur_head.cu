// Duration-head kernels of the fused TDT loss: the second, narrow projection
// (D columns, any D) of the joint features h = tanh(e ⊕ p), on its own, without
// the (B, T, U, H) features ever reaching device memory. They go with the
// fused joint kernels of the token head alone (joint_prep.cu, joint_grad.cu
// without their duration head): the composed route of ops/tdt_fused.py.
//
// Replaces: warp_transducer_tpu/ops/pallas/joint_fused.py::_dur_prep_kernel
// (:824, called through dur_head_prep) and ::_dur_grad_kernel (:837,
// dur_head_grad).
//
// Prep, per valid cell (b, t, u): dlog = h·Wd + bias_d, the raw duration
// logits. Gradient, from the cotangent g_dur (B, T, U, D), zero outside the
// lattice: d = (g_dur·Wdᵀ)·(1 − h²), de2[b,t] = Σ_u d, dp2[b,u] = Σ_t d,
// dWd = hᵀ·g_dur. These add to the token head's de and dp, since dh enters
// the (1 − h²) linearly. e, p, Wd, bias_d and g_dur are f32 and h is never
// rounded. Only cells with t < T_b and u < U_b are computed; the prep's
// wrapper pre-fills dlog with zeros, the gradient writes the zeros of de2 and
// dp2 outside the lattice itself.
//
// Bound on this card. The bytes are few (e, p, g_dur read once, dlog or de2
// and dp2 written once: 13 MB at B=64, T=150, U=21, H=256, D=4); what costs
// is the R·H tanh of the R valid cells (30.3M there), each 2 MUFU results
// (EX2, RCP) at 16 a clock per SM and 9 FP32-pipe instructions at 128
// (scripts/sass_count.sh), beside the head's own D + 1 (prep) or 2·D + 5
// (gradient) FP32 instructions. At D = 4 the MUFU term binds the prep
// (≈ 0.015 ms there), the FP32 pipe the gradient (≈ 0.02 ms). The design
// spends nothing on what the arithmetic does not need: no search for a
// row's place, no shuffles, no atomics, no FMA slots for columns beyond D
// (D is a template parameter, 1..8). Past 8 columns the kernels run in
// groups of 8 (instances of their own, kGroup): blockIdx.z takes columns
// 8·z … 8·z + 7 of a head of D, at run time, with the D = 8 instance's
// registers; the gradient's groups write partials of de2 and dp2 (their dh
// is the group's share of g_dur·Wdᵀ, and d enters both linearly) and their
// own columns of dWd's partials, all added in a fixed order afterwards.
//
// Design.
// * dur_prep_kernel — a tile of cells a block, a thread a cell. The block
//   reads its utterance's T_b and U_b and takes tt frames × ut labels (ut =
//   min(U_b, 256), tt = 256 / ut; beyond 256 labels the u range splits).
//   e[b, t0 : t0 + tt] and p[b, u0 : u0 + ut] go to shared memory a chunk of
//   32 k at a time, each row padded to 36 words so that a quarter-warp's
//   16-byte reads of 8 neighbouring p rows fall on distinct banks (the e rows
//   are shared by the threads of a frame: broadcasts). Wd's chunk sits
//   beside them and is read as broadcast float4. Each of e and p is read
//   from device memory once a tile instead of once a cell. Tiles beyond T_b
//   leave at once; the grid is sized from T and U on the host, and a block of
//   a shorter utterance covers more frames, so no lengths are read there.
// * dur_grad_kernel — split along k, not along cells. Column k of de2, dp2
//   and dWd depends only on column k of e, p and Wd and on the cells'
//   g_dur, so a block owns (b, 32 columns of k, one of two shares of the
//   frames): lane = k, four warps deal the share's frames t < T_b round
//   robin two at a time, p[b, u, k] of a chunk of up to 32 labels in shared
//   memory, Wd[k, :D] in registers. A warp stages the g_dur rows of its two
//   frames (coalesced) in its own shared memory and reads a cell's D values
//   as broadcast float4; e[b,t,k] sits in a register. The inner step takes
//   two labels × two frames, four independent tanh chains, so the MUFU and
//   FMA latencies overlap, and at most 64 registers let eight blocks share
//   an SM. de2[b,t,k] is a register sum over u and a plain store (its owner
//   adds the later u chunks to it); dp2 sums go to a per-warp slot in shared
//   memory, are added across warps in a fixed order into the share's
//   partial; each block writes its partial of dWd; dur_sums_kernel adds the
//   partials of both in a fixed order, in one launch. No
//   atomics: de2, dp2 and dWd are bit-reproducible.
#include "joint.cuh"

namespace {

using namespace wtt::joint;

// ---- the plan (mirrored by ops/cuda/joint.py, held equal on the card) --------

constexpr int kPrepThreads = 256;             // a cell a thread
constexpr int kPrepKC = 32;                   // k a chunk
constexpr int kPrepLd = kPrepKC + 4;          // words a row in shared memory
constexpr int kPrepRows = kPrepThreads + 1;   // tt + ut <= 257 rows of a tile
constexpr int kGradWarps = 4;
constexpr int kGradThreads = kGradWarps * wtt::kWarp;
constexpr int kGradKS = wtt::kWarp;           // columns of k a block
constexpr int kGradUC = 32;                   // labels a chunk
constexpr int kGradTF = 2;                    // frames a warp takes at once
constexpr int kGradSplits = 2;                // blocks that share an utterance's frames

// Labels and frames of a prep tile for an utterance of U_b >= 1 labels.
__host__ __device__ inline int prep_ut(int Ub) { return Ub < kPrepThreads ? Ub : kPrepThreads; }
__host__ __device__ inline int prep_tt(int Ub) { return kPrepThreads / prep_ut(Ub); }

constexpr size_t kPrepSmem = sizeof(float) * ((size_t)kPrepRows * kPrepLd + kPrepKC * kPanel);
// The gradient's dynamic part (its warps' g_dur rows) at D, and the whole at
// its largest.
__host__ __device__ constexpr size_t grad_g_smem(int D) {
  return sizeof(float) * (size_t)kGradWarps * kGradTF * kGradUC * ((D + 3) / 4 * 4);
}
constexpr size_t kGradSmem =
    sizeof(float) * (size_t)(1 + kGradWarps) * kGradUC * kGradKS + grad_g_smem(kPanel);

// T_b and U_b of utterance b, from the running sums of T_b·U_b.
__device__ __forceinline__ void lattice(const Rows& rows, int b, int& Tb, int& Ub) {
  Ub = min(max(rows.label_lengths[b] + 1, 0), rows.U);
  const long long cells = rows.offsets[b + 1] - rows.offsets[b];
  Tb = Ub > 0 ? (int)(cells / Ub) : 0;
}

// ---- prep --------------------------------------------------------------------

// grid (B, tiles_t · tiles_u): blockIdx.y = it · tiles_u + iu.
// kGroup: D = 8 columns of a head of Dfull, the group blockIdx.z.
template <int D, bool kGroup = false>
__global__ void __launch_bounds__(kPrepThreads)
dur_prep_kernel(const float* __restrict__ e, const float* __restrict__ p,
                const float* __restrict__ Wd, const float* __restrict__ bias_d, Rows rows,
                float* __restrict__ dlog, int H, int tiles_u, int Dfull = D) {
  constexpr int DP = (D + 3) / 4 * 4;  // Wd's row in shared memory: whole float4
  const int ld = kGroup ? Dfull : D;   // Wd's and dlog's row
  const int d0 = kGroup ? (int)blockIdx.z * D : 0;
  const int nd = kGroup ? min(D, Dfull - d0) : D;
  __shared__ __align__(16) float s_ep[kPrepRows * kPrepLd];
  __shared__ __align__(16) float s_wd[kPrepKC * DP];
  const int b = blockIdx.x;
  int Tb, Ub;
  lattice(rows, b, Tb, Ub);
  if (Tb == 0) return;  // also U_b = 0
  const int ut = prep_ut(Ub), tt = prep_tt(Ub);
  const int t0 = (int)(blockIdx.y / tiles_u) * tt, u0 = (int)(blockIdx.y % tiles_u) * ut;
  if (t0 >= Tb || u0 >= Ub) return;
  const int nt = min(tt, Tb - t0), nu = min(ut, Ub - u0);
  const int tid = threadIdx.x, tl = tid / nu, ul = tid % nu;
  const bool active = tl < nt;
  const float* e_t = e + ((long long)b * rows.T + t0) * H;
  const float* p_u = p + ((long long)b * rows.U + u0) * H;
  const bool vec =
      H % 4 == 0 && (reinterpret_cast<uintptr_t>(e) | reinterpret_cast<uintptr_t>(p)) % 16 == 0;
  // Rows 0 .. nt-1 hold e's frames, nt .. nt+nu-1 p's labels.
  const float* er = s_ep + (active ? tl : 0) * kPrepLd;
  const float* pr = s_ep + (nt + ul) * kPrepLd;
  constexpr int kQ = kPrepKC / 4;
  const int pieces = (nt + nu) * kQ;

  float acc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) acc[c] = 0.f;
  for (int k0 = 0; k0 < H; k0 += kPrepKC) {
    __syncthreads();  // the last chunk consumed
    for (int idx = tid; idx < pieces; idx += kPrepThreads) {
      const int r = idx / kQ, q = (idx % kQ) * 4, k = k0 + q;
      const float* src = r < nt ? e_t + (long long)r * H : p_u + (long long)(r - nt) * H;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (vec) {
        if (k < H) v = *reinterpret_cast<const float4*>(src + k);  // H % 4 == 0
      } else {
        float a[4] = {0.f, 0.f, 0.f, 0.f};
        for (int x = 0; x < 4 && k + x < H; ++x) a[x] = src[k + x];
        v = make_float4(a[0], a[1], a[2], a[3]);
      }
      *reinterpret_cast<float4*>(s_ep + r * kPrepLd + q) = v;
    }
    for (int idx = tid; idx < kPrepKC * DP; idx += kPrepThreads) {
      const int k = k0 + idx / DP, c = idx % DP;
      s_wd[idx] = k < H && c < nd ? Wd[k * ld + d0 + c] : 0.f;
    }
    __syncthreads();
    // Beyond H both e and p are zero, and tanh(0) = 0.
#pragma unroll
    for (int q = 0; q < kPrepKC; q += 4) {
      const float4 ev = *reinterpret_cast<const float4*>(er + q);
      const float4 pv = *reinterpret_cast<const float4*>(pr + q);
      const float h[4] = {tanhf(ev.x + pv.x), tanhf(ev.y + pv.y), tanhf(ev.z + pv.z),
                          tanhf(ev.w + pv.w)};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int c4 = 0; c4 < DP; c4 += 4) {
          const float4 w = *reinterpret_cast<const float4*>(s_wd + (q + j) * DP + c4);
          const float wc[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (c4 + c < D) acc[c4 + c] = fmaf(h[j], wc[c], acc[c4 + c]);
        }
      }
    }
  }
  if (!active) return;
  float* dst = dlog + (((long long)b * rows.T + t0 + tl) * rows.U + u0 + ul) * ld + d0;
  if constexpr (kGroup) {
#pragma unroll
    for (int c = 0; c < D; ++c)
      if (c < nd) dst[c] = acc[c] + bias_d[d0 + c];
  } else if constexpr (D % 4 == 0) {
#pragma unroll
    for (int c = 0; c < D; c += 4)
      *reinterpret_cast<float4*>(dst + c) = make_float4(
          acc[c] + bias_d[c], acc[c + 1] + bias_d[c + 1], acc[c + 2] + bias_d[c + 2],
          acc[c + 3] + bias_d[c + 3]);
  } else {
#pragma unroll
    for (int c = 0; c < D; ++c) dst[c] = acc[c] + bias_d[c];
  }
}

// ---- gradient ----------------------------------------------------------------

// grid (B, ceil(H / 32), kGradSplits): block (b, j, z) owns k = 32·j + lane
// of utterance b for the frames of split z, and writes split z's partials of
// dp2 and dWd.
// kGroup: D = 8 columns of a head of Dfull, the group blockIdx.z /
// kGradSplits (and the split blockIdx.z % kGradSplits); `de` is then the
// group's partial of de2 and dp_part holds a partial a group and split.
template <int D, bool kGroup = false>
__global__ void __launch_bounds__(kGradThreads, D <= 6 ? 8 : 7)
dur_grad_kernel(const float* __restrict__ e, const float* __restrict__ p,
                const float* __restrict__ Wd, const float* __restrict__ g_dur, Rows rows,
                float* __restrict__ de, float* __restrict__ dp_part,
                float* __restrict__ dWd_part, int H, int Dfull = D) {
  constexpr int DP = (D + 3) / 4 * 4;  // a cell's g_dur in shared memory: whole float4
  constexpr int kG = kGradTF * kGradUC * DP;  // a warp's g_dur rows
  constexpr int kL = (kGradUC * D + wtt::kWarp - 1) / wtt::kWarp;  // of a frame, a lane's
  __shared__ float s_p[kGradUC][kGradKS];
  __shared__ float s_dp[kGradWarps][kGradUC][kGradKS];
  extern __shared__ __align__(16) float s_g[];  // kGradWarps × kG
  const int b = blockIdx.x, lane = threadIdx.x % wtt::kWarp, w = threadIdx.x / wtt::kWarp;
  const int z = kGroup ? (int)blockIdx.z % kGradSplits : (int)blockIdx.z;
  const int ld = kGroup ? Dfull : D;  // Wd's, g_dur's and dWd's row
  const int d0 = kGroup ? (int)blockIdx.z / kGradSplits * D : 0;
  const int nd = kGroup ? min(D, Dfull - d0) : D;
  const int k = blockIdx.y * kGradKS + lane;
  const bool kin = k < H;
  const int T = rows.T, U = rows.U;
  int Tb, Ub;
  lattice(rows, b, Tb, Ub);
  float wd[D], acc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) {
    wd[c] = kin && c < nd ? Wd[k * ld + d0 + c] : 0.f;
    acc[c] = 0.f;
  }
  const long long eb = (long long)b * T * H + k;  // e[b, 0, k], de[b, 0, k]
  const long long pb = (long long)b * U * H + k;  // p[b, 0, k]
  if (kGroup) de += (long long)(blockIdx.z / kGradSplits) * rows.B * T * H;  // the group's
  // This split's partial of dp2 (with groups: this group's and split's).
  float* dp = dp_part + (long long)(kGroup ? (int)blockIdx.z : z) * rows.B * U * H;
  float* g_w = s_g + w * kG;

  for (int u0 = 0; u0 < Ub; u0 += kGradUC) {
    // Labels go two at a time: the chunk's last odd one has a zero partner
    // (p and g_dur zero, so it adds nothing anywhere).
    const int nu = min(kGradUC, Ub - u0), nu2 = (nu + 1) & ~1;
    for (int ul = w; ul < nu2; ul += kGradWarps) {
      s_p[ul][lane] = kin && ul < nu ? p[pb + (long long)(u0 + ul) * H] : 0.f;
#pragma unroll
      for (int x = 0; x < kGradWarps; ++x) s_dp[x][ul][lane] = 0.f;
    }
    __syncthreads();
    float* part = &s_dp[w][0][lane];
    // A warp takes frames t0 .. t0 + kGradTF - 1 a step; g_dur of a frame at
    // or beyond T_b is staged as zeros, so it adds nothing. The next step's
    // e and g_dur are loaded into registers while this one computes.
    const int step = kGradTF * kGradWarps * kGradSplits;
    float e_next[kGradTF], g_next[kGradTF][kL];
    auto fetch = [&](int first) {
#pragma unroll
      for (int f = 0; f < kGradTF; ++f) {
        const int t = first + f;
        e_next[f] = kin && t < Tb ? e[eb + (long long)t * H] : 0.f;
        const float* g = g_dur + (((long long)b * T + t) * U + u0) * ld + d0;
#pragma unroll
        for (int i = 0; i < kL; ++i) {
          const int idx = lane + i * wtt::kWarp;
          if constexpr (kGroup)  // the group's columns of each cell
            g_next[f][i] = t < Tb && idx < nu * D && idx % D < nd
                               ? __ldg(g + (long long)(idx / D) * ld + idx % D)
                               : 0.f;
          else
            g_next[f][i] = t < Tb && idx < nu * D ? __ldg(g + idx) : 0.f;
        }
      }
    };
    int t0 = kGradTF * (z * kGradWarps + w);
    if (t0 < Tb) fetch(t0);
    for (; t0 < Tb; t0 += step) {
      float ev[kGradTF];
      __syncwarp();  // the last step's g_dur consumed
#pragma unroll
      for (int f = 0; f < kGradTF; ++f) {
        ev[f] = e_next[f];
#pragma unroll
        for (int i = 0; i < kL; ++i) {
          const int idx = lane + i * wtt::kWarp;
          if (idx < nu2 * D) g_w[f * kGradUC * DP + idx / D * DP + idx % D] = g_next[f][i];
        }
      }
      __syncwarp();
      if (t0 + step < Tb) fetch(t0 + step);
      float de_t[kGradTF];
#pragma unroll
      for (int f = 0; f < kGradTF; ++f) de_t[f] = 0.f;
      for (int ul = 0; ul < nu; ul += 2) {
        const float pv[2] = {s_p[ul][lane], s_p[ul + 1][lane]};
        float gv[2][kGradTF][DP];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int f = 0; f < kGradTF; ++f)
#pragma unroll
            for (int c = 0; c < DP; c += 4) {
              const float4 x =
                  *reinterpret_cast<const float4*>(g_w + (f * kGradUC + ul + j) * DP + c);
              gv[j][f][c] = x.x; gv[j][f][c + 1] = x.y; gv[j][f][c + 2] = x.z;
              gv[j][f][c + 3] = x.w;
            }
        float dsum[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int f = 0; f < kGradTF; ++f) {
            const float h = tanhf(ev[f] + pv[j]);
            float dh = gv[j][f][0] * wd[0];
#pragma unroll
            for (int c = 1; c < D; ++c) dh = fmaf(gv[j][f][c], wd[c], dh);
            const float d = dh * (1.f - h * h);
            de_t[f] += d;
            dsum[j] += d;
#pragma unroll
            for (int c = 0; c < D; ++c) acc[c] = fmaf(h, gv[j][f][c], acc[c]);
          }
        part[ul * kGradKS] += dsum[0];
        part[(ul + 1) * kGradKS] += dsum[1];
      }
#pragma unroll
      for (int f = 0; f < kGradTF; ++f) {
        if (kin && t0 + f < Tb) {
          float* dst = de + eb + (long long)(t0 + f) * H;
          *dst = u0 == 0 ? de_t[f] : *dst + de_t[f];
        }
      }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < nu * kGradKS; idx += kGradThreads) {
      const int ul = idx / kGradKS, l = idx % kGradKS;
      float s = s_dp[0][ul][l];
#pragma unroll
      for (int x = 1; x < kGradWarps; ++x) s += s_dp[x][ul][l];
      if (blockIdx.y * kGradKS + l < H)
        dp[(long long)b * U * H + (long long)(u0 + ul) * H + blockIdx.y * kGradKS + l] = s;
    }
    __syncthreads();  // s_p and s_dp consumed before the next chunk
  }
  // Outside the lattice: zeros (every frame when the utterance has no
  // label); each split zeroes its partial of dp2, the first one de2.
  if (kin) {
    if (z == 0)
      for (int t = (Ub > 0 ? Tb : 0) + w; t < T; t += kGradWarps) de[eb + (long long)t * H] = 0.f;
    for (int u = Ub + w; u < U; u += kGradWarps) dp[pb + (long long)u * H] = 0.f;
  }
  // The warps' partials of dWd, added in the order of the warps.
  float* red = &s_dp[0][0][0];  // kGradWarps × 32 × D words
#pragma unroll
  for (int c = 0; c < D; ++c) red[(w * kGradKS + lane) * D + c] = acc[c];
  __syncthreads();
  if (w == 0 && kin) {
#pragma unroll
    for (int c = 0; c < D; ++c) {
      float s = red[lane * D + c];
#pragma unroll
      for (int x = 1; x < kGradWarps; ++x) s += red[(x * kGradKS + lane) * D + c];
      if (c < nd) dWd_part[(((long long)z * rows.B + b) * H + k) * ld + d0 + c] = s;
    }
  }
}

template <int D>
int launch_prep(const float* e, const float* p, const float* Wd, const float* bias_d, Rows rows,
                float* dlog, int H, cudaStream_t stream) {
  const int ut = prep_ut(rows.U), tt = prep_tt(rows.U);
  const int tiles_u = (rows.U + ut - 1) / ut;
  const long long tiles = (long long)((rows.T + tt - 1) / tt) * tiles_u;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  dur_prep_kernel<D><<<dim3(rows.B, (unsigned)tiles), kPrepThreads, 0, stream>>>(
      e, p, Wd, bias_d, rows, dlog, H, tiles_u);
  return (int)cudaGetLastError();
}

// The gradient's partials, added in a fixed order, in one launch: blocks
// below dp_blocks take dp2 (a thread an entry, its kGradSplits partials in
// order), the others dWd (a block 32 entries, its 8 warps each a fixed eighth
// of the B·kGradSplits partials in order, then the eight sums in order).
constexpr int kSumThreads = 256;
constexpr int kSumGroups = kSumThreads / wtt::kWarp;

__global__ void __launch_bounds__(kSumThreads)
dur_sums_kernel(const float* __restrict__ dp_part, float* __restrict__ dp, long long n_dp,
                const float* __restrict__ dWd_part, float* __restrict__ dWd, int n_dwd,
                int n_parts, int dp_blocks) {
  if ((int)blockIdx.x < dp_blocks) {
    const long long i = (long long)blockIdx.x * kSumThreads + threadIdx.x;
    if (i >= n_dp) return;
    float s = dp_part[i];
#pragma unroll
    for (int z = 1; z < kGradSplits; ++z) s += dp_part[z * n_dp + i];
    dp[i] = s;
    return;
  }
  __shared__ float s_sum[kSumGroups][wtt::kWarp];
  const int lane = threadIdx.x % wtt::kWarp, q = threadIdx.x / wtt::kWarp;
  const int i = ((int)blockIdx.x - dp_blocks) * wtt::kWarp + lane;
  float s = 0.f;
  if (i < n_dwd) {
#pragma unroll 4
    for (int k = q; k < n_parts; k += kSumGroups) s += dWd_part[(long long)k * n_dwd + i];
  }
  s_sum[q][lane] = s;
  __syncthreads();
  if (q == 0 && i < n_dwd) {
#pragma unroll
    for (int x = 1; x < kSumGroups; ++x) s += s_sum[x][lane];
    dWd[i] = s;
  }
}

template <int D>
int launch_grad(const float* e, const float* p, const float* Wd, const float* g_dur, Rows rows,
                float* de, float* dp, float* dWd, float* part, int H, cudaStream_t stream) {
  const long long n_dp = (long long)rows.B * rows.U * H;
  float* dp_part = part;                             // kGradSplits × (B, U, H)
  float* dWd_part = part + kGradSplits * n_dp;       // kGradSplits × (B, H, D)
  if (rows.B > 0) {
    const dim3 grid(rows.B, (H + kGradKS - 1) / kGradKS, kGradSplits);
    dur_grad_kernel<D><<<grid, kGradThreads, grad_g_smem(D), stream>>>(
        e, p, Wd, g_dur, rows, de, dp_part, dWd_part, H);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int dp_blocks = (int)((n_dp + kSumThreads - 1) / kSumThreads);
  const int dwd_blocks = (H * D + wtt::kWarp - 1) / wtt::kWarp;
  dur_sums_kernel<<<dp_blocks + dwd_blocks, kSumThreads, 0, stream>>>(
      dp_part, dp, n_dp, dWd_part, dWd, H * D, kGradSplits * rows.B, dp_blocks);
  return (int)cudaGetLastError();
}

// Past 8 columns: groups of 8 (the kGroup instances of D = 8). The prep's
// grid takes a third dimension of groups; the gradient's partials (part, as
// dur_part_floats counts them): dp2 a group and split, de2 a group, dWd a
// split and utterance (each group its columns), added in that order.
constexpr int kGroupD = 8;
inline int groups(int D) { return (D + kGroupD - 1) / kGroupD; }

long long dur_part_floats(int B, int T, int U, int H, int D) {
  const long long bh = (long long)B * H;
  if (D <= kPanel) return kGradSplits * (bh * U + bh * D);
  return groups(D) * (kGradSplits * bh * U + bh * T) + kGradSplits * bh * D;
}

int launch_prep_groups(const float* e, const float* p, const float* Wd, const float* bias_d,
                       Rows rows, float* dlog, int H, int D, cudaStream_t stream) {
  const int ut = prep_ut(rows.U), tt = prep_tt(rows.U);
  const int tiles_u = (rows.U + ut - 1) / ut;
  const long long tiles = (long long)((rows.T + tt - 1) / tt) * tiles_u;
  if (tiles > 65535 || groups(D) > 65535) return (int)cudaErrorInvalidValue;
  dur_prep_kernel<kGroupD, true>
      <<<dim3(rows.B, (unsigned)tiles, groups(D)), kPrepThreads, 0, stream>>>(
          e, p, Wd, bias_d, rows, dlog, H, tiles_u, D);
  return (int)cudaGetLastError();
}

int launch_grad_groups(const float* e, const float* p, const float* Wd, const float* g_dur,
                       Rows rows, float* de, float* dp, float* dWd, float* part, int H, int D,
                       cudaStream_t stream) {
  const int ng = groups(D);
  const long long n_dp = (long long)rows.B * rows.U * H, n_de = (long long)rows.B * rows.T * H;
  float* dp_part = part;                                // (group, split) × (B, U, H)
  float* de_part = dp_part + (long long)ng * kGradSplits * n_dp;  // group × (B, T, H)
  float* dWd_part = de_part + ng * n_de;                // (split, b) × (H, D)
  if (rows.B > 0) {
    if ((long long)ng * kGradSplits > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid(rows.B, (H + kGradKS - 1) / kGradKS, ng * kGradSplits);
    dur_grad_kernel<kGroupD, true><<<grid, kGradThreads, grad_g_smem(kGroupD), stream>>>(
        e, p, Wd, g_dur, rows, de_part, dp_part, dWd_part, H, D);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  cudaError_t err = sum_parts(dp_part, dp, n_dp, ng * kGradSplits, stream);
  if (err == cudaSuccess) err = sum_parts(de_part, de, n_de, ng, stream);
  if (err == cudaSuccess)
    err = sum_parts(dWd_part, dWd, (long long)H * D, kGradSplits * rows.B, stream);
  return (int)err;
}

// The switch over D = 1..8 of the two launches.
template <template <int> class F, typename... A>
int by_d(int D, A... a) {
  switch (D) {
    case 1: return F<1>::run(a...);
    case 2: return F<2>::run(a...);
    case 3: return F<3>::run(a...);
    case 4: return F<4>::run(a...);
    case 5: return F<5>::run(a...);
    case 6: return F<6>::run(a...);
    case 7: return F<7>::run(a...);
    case 8: return F<8>::run(a...);
    default: return (int)cudaErrorInvalidValue;
  }
}
template <int D> struct PrepByD {
  template <typename... A> static int run(A... a) { return launch_prep<D>(a...); }
};
template <int D> struct GradByD {
  template <typename... A> static int run(A... a) { return launch_grad<D>(a...); }
};

}  // namespace

extern "C" {

// Shared memory of a block of the larger of the two kernels (at D = 8, as
// the groups of a larger head take; it does not depend on H or U), for the
// mirror in ops/cuda/joint.py.
long long wtt_dur_head_smem() {
  return (long long)(kPrepSmem > kGradSmem ? kPrepSmem : kGradSmem);
}

// The plan at T frames, U labels, H columns: out = {ut, tt, prep tiles an
// utterance, gradient blocks an utterance (column slices × frame splits)},
// for the mirror in ops/cuda/joint.py.
void wtt_dur_head_plan(int T, int U, int H, int* out) {
  const int ut = prep_ut(U), tt = prep_tt(U);
  out[0] = ut;
  out[1] = tt;
  out[2] = (T + tt - 1) / tt * ((U + ut - 1) / ut);
  out[3] = (H + kGradKS - 1) / kGradKS * kGradSplits;
}

// e: (B,T,H) f32; p: (B,U,H) f32; Wd: (H,D) f32; bias_d: (D,) f32; offsets:
// (B+1) int64 running sums of T_b·U_b; label_lengths: (B,) int32; dlog:
// (B,T,U,D) f32, pre-filled with zeros. Any D >= 1 (past 8 in groups of 8).
// Returns the launch's cudaError_t.
int wtt_dur_head_prep(const void* e, const void* p, const void* Wd, const void* bias_d,
                      const void* offsets, const int* label_lengths, void* dlog, int B, int T,
                      int U, int H, int D, void* stream) {
  if ((long long)B * T * U == 0) return 0;
  if (D < 1) return (int)cudaErrorInvalidValue;
  const Rows rows{static_cast<const long long*>(offsets), label_lengths, B, T, U};
  if (D > kPanel)
    return launch_prep_groups(static_cast<const float*>(e), static_cast<const float*>(p),
                              static_cast<const float*>(Wd), static_cast<const float*>(bias_d),
                              rows, static_cast<float*>(dlog), H, D,
                              static_cast<cudaStream_t>(stream));
  return by_d<PrepByD>(D, static_cast<const float*>(e), static_cast<const float*>(p),
                    static_cast<const float*>(Wd), static_cast<const float*>(bias_d), rows,
                    static_cast<float*>(dlog), H, static_cast<cudaStream_t>(stream));
}

// The inputs of wtt_dur_head_prep with g_dur: (B,T,U,D) f32, zero outside
// the lattice, in place of bias_d. de: (B,T,H) f32 and dp: (B,U,H) f32,
// written whole (zeros outside the lattice); dWd: (H,D) f32, written whole;
// part: f32 scratch of wtt_dur_head_part_floats values (D <= 8:
// 2·B·(U·H + H·D), a partial of dp and of dWd an utterance and frame split;
// past 8, the groups' partials too). Every base 16-byte aligned. Returns the
// launches' cudaError_t.
int wtt_dur_head_grad(const void* e, const void* p, const void* Wd, const void* g_dur,
                      const void* offsets, const int* label_lengths, void* de, void* dp,
                      void* dWd, void* part, int B, int T, int U, int H, int D,
                      void* stream) {
  if (H == 0) return 0;
  if (D < 1) return (int)cudaErrorInvalidValue;
  const Rows rows{static_cast<const long long*>(offsets), label_lengths, B, T, U};
  if (D > kPanel)
    return launch_grad_groups(static_cast<const float*>(e), static_cast<const float*>(p),
                              static_cast<const float*>(Wd), static_cast<const float*>(g_dur),
                              rows, static_cast<float*>(de), static_cast<float*>(dp),
                              static_cast<float*>(dWd), static_cast<float*>(part), H, D,
                              static_cast<cudaStream_t>(stream));
  return by_d<GradByD>(D, static_cast<const float*>(e), static_cast<const float*>(p),
                    static_cast<const float*>(Wd), static_cast<const float*>(g_dur), rows,
                    static_cast<float*>(de), static_cast<float*>(dp), static_cast<float*>(dWd),
                    static_cast<float*>(part), H, static_cast<cudaStream_t>(stream));
}

// Values of the gradient's f32 scratch `part` at these sizes.
long long wtt_dur_head_part_floats(int B, int T, int U, int H, int D) {
  return dur_part_floats(B, T, U, H, D);
}

}  // extern "C"
