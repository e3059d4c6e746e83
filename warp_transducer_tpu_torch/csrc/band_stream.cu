// Band lattice kernel: the pruned RNN-T alpha and beta recursions over the
// T rows of each utterance's (T, S) band, t-major.
//
// Replaces: warp_transducer_tpu/ops/pallas/band_stream.py:115
// (_band_kernel, called through stream_panels), which steps (S_pad, B_pad)
// panels of the whole batch, streamed through VMEM in double-buffered
// chunks, with the per-utterance row shift as an unrolled S-way roll
// select. None of that TPU layout is carried over: here one warp walks one
// utterance's rows.
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
// Bound on this card: the chain of T dependent rows, not bytes. The kernel
// moves about 4·B·T·S values, which the card would stream in microseconds,
// but row t needs row t-1 (alpha) or t+1 (beta), and each row is two warp
// scans of ceil(log2 S) shuffle steps plus a shared-memory exchange. What
// the design does about it: alpha and beta run side by side (grid (B, 2),
// one warp each); the neighbour row stays in shared memory, so a row reads
// device memory only for its lpb, lpe and band start, and those of row t+1
// (alpha) or t-1 (beta) are loaded before row t's chain starts, as they do
// not depend on it.
//
// Layout: lane s holds band cell s. The two prefix scans are Hillis–Steele
// warp scans (shuffles), the order in which the plain version adds, so for
// S <= 32 the two agree bit for bit. For S > 32 the warp walks the row in
// 32-lane chunks and carries the prefix (sum and log-sum-exp) from one
// chunk to the next; beta first writes the row's exclusive prefix to
// shared memory in ascending chunks, then runs the suffix scan in
// descending chunks. Shared memory: three rows of S floats.
#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
// Row-chain sentinel of the emit prefix sums (ops/band.py::CLAMP).
constexpr float kClamp = -1.0e4f;

// max(x, kClamp) that keeps a NaN, as torch.clamp_min does.
__device__ __forceinline__ float clamp_chain(float x) { return x < kClamp ? kClamp : x; }

// Inclusive prefix sum over lanes [0, width), Hillis–Steele.
__device__ __forceinline__ float scan_sum(float x, int lane, int width) {
  for (int sh = 1; sh < width; sh <<= 1) {
    const float y = __shfl_up_sync(kFull, x, sh);
    if (lane >= sh) x = x + y;
  }
  return x;
}

// Inclusive prefix log-sum-exp over lanes [0, width), Hillis–Steele.
__device__ __forceinline__ float scan_lse(float x, int lane, int width) {
  for (int sh = 1; sh < width; sh <<= 1) {
    const float y = __shfl_up_sync(kFull, x, sh);
    if (lane >= sh) x = wtt::lse(x, y);
  }
  return x;
}

// Inclusive suffix log-sum-exp over lanes [0, width), Hillis–Steele.
__device__ __forceinline__ float scan_lse_rev(float x, int lane, int width) {
  for (int sh = 1; sh < width; sh <<= 1) {
    const float y = __shfl_down_sync(kFull, x, sh);
    if (lane + sh < width) x = wtt::lse(x, y);
  }
  return x;
}

// Exclusive prefix sum of chunk k's values (lanes [0, width)): the
// inclusive scan shifted by one lane, never the inclusive sum minus the
// element. `carry` holds the sum of the earlier chunks and is advanced.
__device__ __forceinline__ float excl_prefix(float x, int lane, int width, int k,
                                             float& carry) {
  float incl = scan_sum(x, lane, width);
  if (k > 0) incl = carry + incl;
  float c = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) c = carry;
  carry = __shfl_sync(kFull, incl, wtt::kWarp - 1);
  return c;
}

__global__ void band_kernel(const float* __restrict__ lpb, const float* __restrict__ lpe,
                            const int* __restrict__ ranges, const int* __restrict__ input_lengths,
                            const int* __restrict__ label_lengths, float* __restrict__ alphas,
                            float* __restrict__ betas, float* __restrict__ ll_forward,
                            float* __restrict__ ll_backward, int T, int S) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  const int Tb = input_lengths[b];
  const int Ub = label_lengths[b] + 1;
  const long long base = (long long)b * T * S;
  const float* pb = lpb + base;
  const float* pe = lpe + base;
  const int* r = ranges + (long long)b * T;
  const float neg = float(wtt::kNeg);
  const int nchunks = (S + wtt::kWarp - 1) / wtt::kWarp;
  const int last = nchunks - 1;
  float* nbr = smem;        // the neighbour row: α + lpb of row t-1, or β of row t+1
  float* cur = smem + S;    // the row being written
  float* pre = smem + 2 * S;  // beta: the row's exclusive prefix
  for (int s = lane; s < S; s += wtt::kWarp) nbr[s] = neg;
  __syncwarp();

  // Lane's element of chunk k of row t (0 beyond the row).
  auto load = [&](const float* p, int t, int k) -> float {
    const int s = k * wtt::kWarp + lane;
    return s < S ? p[(long long)t * S + s] : 0.f;
  };

  if (blockIdx.y == 0) {
    // ---- alpha, rows ascending ----
    float llf = neg;
    int r_prev = r[0];
    int pf_r = r[0];
    float pf_b = load(pb, 0, 0), pf_e = load(pe, 0, 0);
    for (int t = 0; t < T; ++t) {
      const int rt = pf_r;
      const int da = t > 0 ? rt - r_prev : 0;
      r_prev = rt;
      const float b0 = pf_b, e0 = pf_e;
      if (t + 1 < T) {  // next row's inputs, independent of this row's chain
        pf_r = r[t + 1];
        pf_b = load(pb, t + 1, 0);
        pf_e = load(pe, t + 1, 0);
      }
      float carry_c = 0.f, carry_z = neg;
      for (int k = 0; k < nchunks; ++k) {
        const int s = k * wtt::kWarp + lane;
        const int width = min(wtt::kWarp, S - k * wtt::kWarp);
        const bool in = s < S;
        const float lpb_v = in ? wtt::clamp_neg(k == 0 ? b0 : load(pb, t, k)) : neg;
        const float lpe_c = in ? clamp_chain(k == 0 ? e0 : load(pe, t, k)) : 0.f;
        const float c = excl_prefix(lpe_c, lane, width, k, carry_c);
        const int src = s + da;
        float ne = (in && src >= 0 && src < S) ? nbr[src] : neg;
        if (t == 0 && s == 0) ne = 0.f;
        float z = scan_lse(ne - c, lane, width);
        if (k > 0) z = wtt::lse(z, carry_z);
        carry_z = __shfl_sync(kFull, z, wtt::kWarp - 1);
        const bool valid = in && t < Tb && rt + s < Ub;
        const float a = valid ? c + z : neg;
        if (in) {
          alphas[base + (long long)t * S + s] = a;
          cur[s] = a + lpb_v;
        }
        if (t == Tb - 1) {  // the terminal row: read ll at s*, if it is in the band
          const unsigned hit = __ballot_sync(kFull, valid && rt + s == Ub - 1);
          if (hit) llf = __shfl_sync(kFull, a + lpb_v, __ffs(hit) - 1);
        }
      }
      __syncwarp();
      float* tmp = nbr;
      nbr = cur;
      cur = tmp;
    }
    if (lane == 0) ll_forward[b] = llf;
  } else {
    // ---- beta, rows descending ----
    float llb = neg;
    int r_next = 0;
    int pf_r = r[T - 1];
    float pf_e = load(pe, T - 1, 0), pf_b = load(pb, T - 1, last);
    for (int t = T - 1; t >= 0; --t) {
      const int rt = pf_r;
      const int db = t + 1 < T ? r_next - rt : 0;
      r_next = rt;
      const float e0 = pf_e, bl = pf_b;
      if (t > 0) {  // next row's inputs, independent of this row's chain
        pf_r = r[t - 1];
        pf_e = load(pe, t - 1, 0);
        pf_b = load(pb, t - 1, last);
      }
      float carry_c = 0.f;
      for (int k = 0; k < nchunks; ++k) {  // exclusive prefix, ascending chunks
        const int s = k * wtt::kWarp + lane;
        const int width = min(wtt::kWarp, S - k * wtt::kWarp);
        const bool in = s < S;
        const float lpe_c = in ? clamp_chain(k == 0 ? e0 : load(pe, t, k)) : 0.f;
        const float c = excl_prefix(lpe_c, lane, width, k, carry_c);
        if (in) pre[s] = c;
      }
      __syncwarp();
      float carry_p = neg;
      for (int k = last; k >= 0; --k) {  // suffix log-sum-exp, descending chunks
        const int s = k * wtt::kWarp + lane;
        const int width = min(wtt::kWarp, S - k * wtt::kWarp);
        const bool in = s < S;
        const float lpb_v = in ? wtt::clamp_neg(k == last ? bl : load(pb, t, k)) : neg;
        const float c = in ? pre[s] : 0.f;
        const int src = s - db;
        float ne = ((in && src >= 0 && src < S) ? nbr[src] : neg) + lpb_v;
        if (t == Tb - 1 && rt + s == Ub - 1) ne = lpb_v;  // the terminal cell seeds beta
        float p = scan_lse_rev(ne + c, lane, width);
        if (k < last) p = wtt::lse(p, carry_p);
        carry_p = __shfl_sync(kFull, p, 0);
        const bool valid = in && t < Tb && rt + s < Ub;
        const float bv = valid ? p - c : neg;
        if (in) {
          betas[base + (long long)t * S + s] = bv;
          cur[s] = bv;
        }
        if (t == 0 && k == 0) llb = __shfl_sync(kFull, bv, 0);
      }
      __syncwarp();
      float* tmp = nbr;
      nbr = cur;
      cur = tmp;
    }
    if (lane == 0) ll_backward[b] = llb;
  }
}

}  // namespace

extern "C" {

// lpb, lpe: (B,T,S) f32; ranges: (B,T) int32; lengths: (B,) int32;
// alphas, betas: (B,T,S) f32; ll_forward, ll_backward: (B,) f32. T, S >= 1.
// Returns the launch's cudaError_t.
int wtt_band_stream(const void* lpb, const void* lpe, const int* ranges,
                    const int* input_lengths, const int* label_lengths, void* alphas,
                    void* betas, void* ll_forward, void* ll_backward, int B, int T, int S,
                    void* stream) {
  if (B == 0) return 0;
  if (T < 1 || S < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = 3 * (size_t)S * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        band_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(B, 2);
  band_kernel<<<grid, wtt::kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lpb), static_cast<const float*>(lpe), ranges, input_lengths,
      label_lengths, static_cast<float*>(alphas), static_cast<float*>(betas),
      static_cast<float*>(ll_forward), static_cast<float*>(ll_backward), T, S);
  return (int)cudaGetLastError();
}

}  // extern "C"
