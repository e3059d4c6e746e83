// Shared pieces of the fused joint+loss kernels (joint_prep.cu,
// joint_grad.cu, joint_grad_cols.cu, dur_head.cu): the compacted list of
// valid lattice rows, the h = tanh(e ⊕ p) tiles in shared memory, the
// tensor-core tiles of the token head's products (Mma, warp_product, the W
// tile loads by cp.async), the per-row panels of the extra coefficient
// fields and of the duration head's cotangent, and the duration head's own
// products (D <= 8 columns: a warp's dot products going in, one thread per
// k coming back).
//
// Rows. A row is a lattice cell (b, t, u); only the cells inside each
// utterance's lattice, t < T_b and u < U_b, carry work. They are numbered
// b-major, then t, then u, through `offsets` (B+1 running sums of T_b·U_b),
// and a block takes a tile of consecutive numbers, so no block spends
// products on padding. The grid is sized for all B·T·U cells, since the
// host never reads the lengths; blocks beyond the last valid tile leave at
// once.
//
// Threads. 256 threads a block, 8 warps. The token head's kernels give each
// warp m16 × n8 mma tiles (see the tensor-core section); the duration
// head's gradient (dur_grad_tiles) gives each thread its k = k0 + tid + 256·q
// of a pass.
//
// Any H. Up to kPassH (H padded to a multiple of 128) a kernel holds the
// whole W tile in shared memory and a thread keeps its share of an H-wide
// result (dh, dW, dWd) in registers. Above it the same templates, with
// kSliced, stream W through shared memory in k-slices of kSliceRows rows and
// take the H-wide results in passes of kPassH columns (see the plan below).
#pragma once

#include <cstdint>

#include "common.cuh"

namespace wtt {
namespace joint {

constexpr int kThreads = 256;
constexpr int kDim = 16;  // rows of a row tile (and columns of a stripe) per unit of TM
constexpr int kBK = 16;   // H is padded to a multiple of this in dur_grad_tiles
// Columns of dh (the row kernel), rows of dW (the column kernel) and k of
// dWd (the dWd kernel) that one pass owns: a thread keeps 64 accumulators of
// it in registers at TM = 1.
constexpr int kPassH = 1024;
// Rows of W (and columns of h) of a k-slice above kPassH: 256 with bf16 W,
// 128 with f32 (whose tiles take twice the bytes), so that two stages fit
// beside the whole h tile at H = 2048. A slice holds kSliceRows / (8 · 8) of
// every warp's n8 tiles of dh (row kernel) and kSliceRows / (16 · 8) of its
// m16 tiles of dW (column kernel).
template <typename TW>
constexpr int kSliceRows = sizeof(TW) == 2 ? 256 : 128;
// Dynamic shared memory a block may use on sm_90 (227 KB).
constexpr size_t kSmemMax = 232448;
// Width of a per-row panel in shared memory: the K extra coefficient fields
// or the D duration columns of a row, padded with zeros.
constexpr int kPanel = wtt::kMaxExtraCols;

// Tile parameter by H, shared by the three kernels: 4, 2 or 1 sixteens of
// rows (or of columns, for the column kernel) a block, so that a thread
// keeps 64 accumulators of an H-wide result in registers and the h tile
// stays near 64 KB of shared memory.
inline __host__ __device__ int tile_param(int H) { return H <= 256 ? 4 : H <= 512 ? 2 : 1; }

struct Rows {
  const long long* offsets;  // (B+1) running sums of valid cells
  const int* label_lengths;  // (B,)
  int B, T, U;
};

// Row number r -> (b, t, u); false when r is beyond the last valid row.
__device__ __forceinline__ bool locate(const Rows& rows, long long r, int& b, int& t, int& u) {
  if (r >= rows.offsets[rows.B]) return false;
  int lo = 0, hi = rows.B;  // offsets[lo] <= r < offsets[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (rows.offsets[mid] <= r) lo = mid; else hi = mid;
  }
  const int Ub = min(max(rows.label_lengths[lo] + 1, 0), rows.U);
  const long long local = r - rows.offsets[lo];
  b = lo;
  t = (int)(local / Ub);
  u = (int)(local % Ub);
  return true;
}

// The first BM threads place the tile's rows: s_b[m] = -1 beyond the end.
template <int BM>
__device__ __forceinline__ void place_rows(const Rows& rows, long long first, int* s_b, int* s_t,
                                           int* s_u) {
  if (threadIdx.x < BM) {
    int b = -1, t = 0, u = 0;
    if (!locate(rows, first + threadIdx.x, b, t, u)) b = -1;
    s_b[threadIdx.x] = b;
    s_t[threadIdx.x] = t;
    s_u[threadIdx.x] = u;
  }
}

// hs[(k − k0)·ldh + m] = tanh(e[b,t,k] + p[b,u,k]) in f32 for the tile's
// rows and k0 <= k < k0 + nk (the duration head's unrounded h), zero for
// k >= H and for rows beyond the end. The lanes run along k, so the reads of
// e and p are contiguous.
template <int BM>
__device__ __forceinline__ void fill_h(float* hs, int ldh, const float* __restrict__ e,
                                       const float* __restrict__ p, const int* s_b,
                                       const int* s_t, const int* s_u, int T, int U, int H,
                                       int k0, int nk) {
  for (int idx = threadIdx.x; idx < BM * nk; idx += kThreads) {
    const int m = idx / nk, kl = idx % nk, k = k0 + kl;
    float h = 0.f;
    const int b = s_b[m];
    if (b >= 0 && k < H) {
      h = tanhf(e[((long long)b * T + s_t[m]) * H + k] + p[((long long)b * U + s_u[m]) * H + k]);
    }
    hs[kl * ldh + m] = h;
  }
}

// ---- tensor-core tiles of the token head (joint_prep.cu, joint_grad.cu) ----
//
// The three products of the token head (logits = h·W, dh = g·Wᵀ, dW = hᵀ·g)
// run on the tensor cores through mma.sync, a warp at a time, from tiles in
// shared memory:
// * bf16 W: the tiles hold bf16 (h rounded, g rounded after its
//   subtractions), m16n8k16 with f32 accumulators, fragments by ldmatrix
//   (.trans where the tile is stored the other way round);
// * f32 W: the tiles hold f32 and each product is split in three TF32
//   products, x = hi + lo with hi = tf32(x), lo = tf32(x − hi), and
//   a·b ≈ lo·hi + hi·lo + hi·hi (m16n8k8, the small terms first), which
//   keeps about 22 bits of each product: f32 accuracy, where plain TF32 keeps
//   11. Fragments by 32-bit loads (ldmatrix moves 16-bit elements).
// Accumulator fragment of a m16 × n8 tile at (m0, n0), lane = 4·gr + tq:
// c[0], c[1] at row m0 + gr, columns n0 + 2·tq, +1; c[2], c[3] at row
// m0 + gr + 8, the same columns.
//
// What wgmma would add (sm_90a): a 64-row product of a warpgroup issued
// asynchronously from shared memory with no fragment loads in the warps
// (here ldmatrix traffic bounds the small warp tiles), and TMA loads of W
// into an mbarrier ring; later work.

constexpr int kWarps = kThreads / wtt::kWarp;
// H is padded to a multiple of this in the products' tiles (zeros), so that
// every warp's share of an H-wide result is a whole number of 16-wide tiles.
constexpr int kHAlign = 128;
inline __host__ __device__ int padded_h(int H) { return (H + kHAlign - 1) / kHAlign * kHAlign; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// Operand traits by the type of W: the tile element, the depth of one mma,
// the padding of a tile row (elements; keeps the fragment loads free of or
// low in bank conflicts), the fragments, their loads and the product.
// Tile storage: "mk" rows along the product's M (or N) with K contiguous,
// "km" rows along K.
template <typename TW> struct Mma;

template <> struct Mma<__nv_bfloat16> {
  using T = __nv_bfloat16;
  static constexpr int kK = 16;
  static constexpr int kPadH = 8, kPadW = 8, kPadG = 8;
  struct A { uint32_t r[4]; };
  struct B { uint32_t r[2]; };
  static __device__ __forceinline__ T cast(float x) { return __float2bfloat16(x); }
  static __device__ __forceinline__ float value(T x) { return __bfloat162float(x); }
  // A (m16 × k16) at (m0, k0) of a tile stored [m][k] / [k][m].
  static __device__ __forceinline__ void load_a_mk(A& a, const T* t, int ld,
                                                   int m0, int k0, int lane) {
    ldsm_x4(a.r, t + (m0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
  }
  static __device__ __forceinline__ void load_a_km(A& a, const T* t, int ld,
                                                   int m0, int k0, int lane) {
    const int j = lane >> 3;
    ldsm_x4_t(a.r, t + (k0 + (lane & 7) + 8 * (j >> 1)) * ld + m0 + 8 * (j & 1));
  }
  // B (k16 × n8) at (k0, n0) of a tile stored [k][n] / [n][k].
  static __device__ __forceinline__ void load_b_kn(B& b, const T* t, int ld,
                                                   int k0, int n0, int lane) {
    ldsm_x2_t(b.r, t + (k0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * ld + n0);
  }
  static __device__ __forceinline__ void load_b_nk(B& b, const T* t, int ld,
                                                   int k0, int n0, int lane) {
    ldsm_x2(b.r, t + (n0 + (lane & 7)) * ld + k0 + 8 * ((lane >> 3) & 1));
  }
  static __device__ __forceinline__ void mma(float (&c)[4], const A& a, const B& b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "r"(b.r[0]), "r"(b.r[1]));
  }
};

template <> struct Mma<float> {
  using T = float;
  static constexpr int kK = 8;
  // h and g tiles read as A along rows (gr·ld + tq): ld ≡ 4 mod 32; W tiles
  // read as B along rows (tq·ld + gr): ld ≡ 8 or 24 mod 32.
  static constexpr int kPadH = 4, kPadW = 8, kPadG = 4;
  struct A { uint32_t hi[4], lo[4]; };
  struct B { uint32_t hi[2], lo[2]; };
  static __device__ __forceinline__ T cast(float x) { return x; }
  static __device__ __forceinline__ float value(T x) { return x; }
  static __device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
    hi = to_tf32(x);
    lo = to_tf32(x - __uint_as_float(hi));
  }
  // A fragment of m16n8k8: (gr, tq), (gr + 8, tq), (gr, tq + 4), (gr + 8, tq + 4).
  static __device__ __forceinline__ void load_a_mk(A& a, const T* t, int ld,
                                                   int m0, int k0, int lane) {
    const T* p = t + (m0 + (lane >> 2)) * ld + k0 + (lane & 3);
    split(p[0], a.hi[0], a.lo[0]);
    split(p[8 * ld], a.hi[1], a.lo[1]);
    split(p[4], a.hi[2], a.lo[2]);
    split(p[8 * ld + 4], a.hi[3], a.lo[3]);
  }
  static __device__ __forceinline__ void load_a_km(A& a, const T* t, int ld,
                                                   int m0, int k0, int lane) {
    const T* p = t + (k0 + (lane & 3)) * ld + m0 + (lane >> 2);
    split(p[0], a.hi[0], a.lo[0]);
    split(p[8], a.hi[1], a.lo[1]);
    split(p[4 * ld], a.hi[2], a.lo[2]);
    split(p[4 * ld + 8], a.hi[3], a.lo[3]);
  }
  // B fragment: (k = tq, n = gr), (k = tq + 4, n = gr).
  static __device__ __forceinline__ void load_b_kn(B& b, const T* t, int ld,
                                                   int k0, int n0, int lane) {
    const T* p = t + (k0 + (lane & 3)) * ld + n0 + (lane >> 2);
    split(p[0], b.hi[0], b.lo[0]);
    split(p[4 * ld], b.hi[1], b.lo[1]);
  }
  static __device__ __forceinline__ void load_b_nk(B& b, const T* t, int ld,
                                                   int k0, int n0, int lane) {
    const T* p = t + (n0 + (lane >> 2)) * ld + k0 + (lane & 3);
    split(p[0], b.hi[0], b.lo[0]);
    split(p[4], b.hi[1], b.lo[1]);
  }
  static __device__ __forceinline__ void mma1(float (&c)[4], const uint32_t (&a)[4],
                                              const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  static __device__ __forceinline__ void mma(float (&c)[4], const A& a, const B& b) {
    mma1(c, a.lo, b.hi);
    mma1(c, a.hi, b.lo);
    mma1(c, a.hi, b.hi);
  }
};

// acc[i][j] += Σ_k A(m0 + MS·i + ·, k) · B(k, n0 + NS·j + ·) over k in [0, K),
// a warp's m16 × n8 tiles i < MI, j < NI (those with i < mi_count, j <
// nj_count: the tiles beyond them would read past the operands). kAkm /
// kBkn: how A and B are stored (see Mma). MS, NS: the strides of the tiles
// (16, 8: side by side; wider where the warps' tiles interleave).
template <typename TW, int MI, int NI, bool kAkm, bool kBkn, int MS = 16, int NS = 8>
__device__ __forceinline__ void warp_product(float (&acc)[MI][NI][4],
                                             const typename Mma<TW>::T* As, int lda, int m0,
                                             const typename Mma<TW>::T* Bs, int ldb, int n0, int K,
                                             int lane, int mi_count = MI, int nj_count = NI) {
  using M = Mma<TW>;
  for (int k0 = 0; k0 < K; k0 += M::kK) {
    typename M::A a[MI];
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      if (i >= mi_count) break;
      if (kAkm) M::load_a_km(a[i], As, lda, m0 + MS * i, k0, lane);
      else M::load_a_mk(a[i], As, lda, m0 + MS * i, k0, lane);
    }
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      if (j >= nj_count) break;
      typename M::B b;
      if (kBkn) M::load_b_kn(b, Bs, ldb, k0, n0 + NS * j, lane);
      else M::load_b_nk(b, Bs, ldb, k0, n0 + NS * j, lane);
#pragma unroll
      for (int i = 0; i < MI; ++i)
        if (i < mi_count) M::mma(acc[i][j], a[i], b);
    }
  }
}

// ---- the W tile ring ---------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage W[k0 : k0 + nk, v0 : v0 + BN] as ws[(k − k0)·ldw + n], zero for
// k >= H and v >= V. With `async` (W's rows 16-byte aligned: the wrapper
// checks the base, the kernel V) by cp.async in 16-byte pieces, which the
// caller commits and waits for; else by plain loads and stores.
template <int BN, typename TW>
__device__ __forceinline__ void load_w_rows(TW* ws, int ldw, const TW* __restrict__ W, int k0,
                                            int nk, int H, int V, int v0, bool async) {
  constexpr int kVec = 16 / sizeof(TW);  // elements of a 16-byte piece
  constexpr int kPieces = BN / kVec;
  if (async) {
    for (int idx = threadIdx.x; idx < nk * kPieces; idx += kThreads) {
      const int k = idx / kPieces, n = (idx % kPieces) * kVec;
      const bool in = k0 + k < H && v0 + n < V;  // V % kVec == 0: a piece is all in or all out
      cp_async16(ws + k * ldw + n, in ? W + (long long)(k0 + k) * V + v0 + n : W, in);
    }
  } else {
    for (int idx = threadIdx.x; idx < nk * BN; idx += kThreads) {
      const int k = idx / BN, n = idx % BN;
      ws[k * ldw + n] = (k0 + k < H && v0 + n < V) ? W[(long long)(k0 + k) * V + v0 + n]
                                                   : Mma<TW>::cast(0.f);
    }
  }
}

// hs[m·ldh + k − k0] = tanh(e[b,t,k] + p[b,u,k]) in the tile's type (bf16:
// the rounded h) for k0 <= k < k0 + nk (nk a multiple of 4: all of Hp, or a
// k-slice), zero for k >= H and for rows beyond the end. A thread takes four
// neighbouring k a step (16-byte loads where H and the bases allow), and
// issues the loads of kBatch steps before any tanh: the fill is bound by the
// latency of those loads, not by their bytes.
template <int BM, typename T>
__device__ __forceinline__ void fill_h_rows(T* hs, int ldh, const float* __restrict__ e,
                                            const float* __restrict__ p, const int* s_b,
                                            const int* s_t, const int* s_u, int T_, int U, int H,
                                            int k0, int nk) {
  constexpr int kBatch = 4;
  const bool vec =
      H % 4 == 0 && (reinterpret_cast<uintptr_t>(e) | reinterpret_cast<uintptr_t>(p)) % 16 == 0;
  const int q4 = nk / 4, n = BM * q4;
  for (int base = threadIdx.x; base < n; base += kThreads * kBatch) {
    float4 ev[kBatch], pv[kBatch];
#pragma unroll
    for (int s = 0; s < kBatch; ++s) {
      const int idx = base + s * kThreads;
      ev[s] = pv[s] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (idx >= n) continue;
      const int m = idx / q4, k = k0 + (idx % q4) * 4, b = s_b[m];
      if (b < 0 || k >= H) continue;
      const float* er = e + ((long long)b * T_ + s_t[m]) * H + k;
      const float* pr = p + ((long long)b * U + s_u[m]) * H + k;
      if (vec) {
        ev[s] = *reinterpret_cast<const float4*>(er);
        pv[s] = *reinterpret_cast<const float4*>(pr);
      } else {
        float ea[4] = {0.f, 0.f, 0.f, 0.f}, pa[4] = {0.f, 0.f, 0.f, 0.f};
        for (int x = 0; x < 4 && k + x < H; ++x) {
          ea[x] = er[x];
          pa[x] = pr[x];
        }
        ev[s] = make_float4(ea[0], ea[1], ea[2], ea[3]);
        pv[s] = make_float4(pa[0], pa[1], pa[2], pa[3]);
      }
    }
#pragma unroll
    for (int s = 0; s < kBatch; ++s) {
      const int idx = base + s * kThreads;
      if (idx >= n) continue;
      // Outside the lattice or beyond H both are zero, and tanh(0) = 0.
      T* dst = hs + (idx / q4) * ldh + (idx % q4) * 4;
      dst[0] = Mma<T>::cast(tanhf(ev[s].x + pv[s].x));
      dst[1] = Mma<T>::cast(tanhf(ev[s].y + pv[s].y));
      dst[2] = Mma<T>::cast(tanhf(ev[s].z + pv[s].z));
      dst[3] = Mma<T>::cast(tanhf(ev[s].w + pv[s].w));
    }
  }
}

// Columns k0 .. k0 + nk − 1 of the h tile's BM rows (held from column k0)
// to rows h0 .. h0 + BM - 1 of a chunk buffer in device memory, Hp wide
// (16-byte stores; Hp, k0 and nk are multiples of 128).
template <int BM, typename T>
__device__ __forceinline__ void store_h_rows(const T* hs, int ldh, T* __restrict__ out,
                                             long long h0, int Hp, int k0, int nk) {
  constexpr int kVec = 16 / sizeof(T);
  const int pieces = nk / kVec;
  for (int idx = threadIdx.x; idx < BM * pieces; idx += kThreads) {
    const int m = idx / pieces, k = (idx % pieces) * kVec;
    *reinterpret_cast<uint4*>(out + (h0 + m) * Hp + k0 + k) =
        *reinterpret_cast<const uint4*>(hs + m * ldh + k);
  }
}

// Columns k0 .. k0 + nk − 1 of the h tile of rows first .. first + BM - 1
// from a chunk buffer (Hp wide) whose row 0 is valid row `base`, to
// hs[m·ldh + k − k0], by cp.async (the caller commits and waits); rows at or
// beyond `end` (past the last valid row: never written) are zeros.
template <int BM, typename T>
__device__ __forceinline__ void load_h_rows(T* hs, int ldh, const T* __restrict__ in,
                                            long long first, long long base, long long end,
                                            int Hp, int k0, int nk) {
  constexpr int kVec = 16 / sizeof(T);
  const int pieces = nk / kVec;
  for (int idx = threadIdx.x; idx < BM * pieces; idx += kThreads) {
    const int m = idx / pieces, k = (idx % pieces) * kVec;
    const bool on = first + m < end;
    cp_async16(hs + m * ldh + k, on ? in + (first + m - base) * Hp + k0 + k : in, on);
  }
}

// The tiling of the kernels that walk V for a tile of rows (joint_prep.cu,
// the row kernel of joint_grad.cu), by W's type and TM = tile_param(H):
// BM = 16·TM rows; V in tiles of BN columns, each W tile held whole (Hp ×
// BN) in shared memory up to kPassH, where both the logits product and the
// dh product read it, and in k-slices above (kSliced; there BN is 128 with
// bf16 W, so that a warp's two n8 tiles share each A fragment, and 64 with
// f32). The warps stand WM × WN over the BM × BN logits tile, NI n8 tiles
// each (with f32 W at TM = 1 and one slice only two of the eight warps have
// a share: a whole f32 W tile 64 wide would not fit), and TM × 8/TM over
// the BM × Hp dh (a pass of it above kPassH; 16 n8 tiles each at most).
template <typename TW, int TM, bool kSliced = false>
struct RowTiles {
  using T = typename Mma<TW>::T;
  static constexpr int BM = kDim * TM;
  static constexpr int HMAX = kPassH / TM;
  static constexpr int BN = sizeof(TW) == 2 ? (kSliced ? 128 : 64) : kSliced ? 64 : kDim * TM;
  static constexpr int WM = TM;
  static constexpr int WN = kWarps / TM < BN / 8 ? kWarps / TM : BN / 8;
  static constexpr int NI = BN / (8 * WN);
  static constexpr int WH = kWarps / TM;              // warps along H in the dh product
  static constexpr int NIH = HMAX / (8 * WH);         // their n8 tiles at most (16)
  static constexpr int LDW = BN + Mma<TW>::kPadW;
  static constexpr int LDG = BN + Mma<TW>::kPadG;
  static __host__ __device__ int ldh(int Hp) { return Hp + Mma<TW>::kPadH; }
};

__host__ __device__ constexpr size_t round16(size_t bytes) { return (bytes + 15) / 16 * 16; }

// Consecutive 16-byte aligned regions of dynamic shared memory; the host's
// size functions add the same round16 terms.
struct Carve {
  unsigned char* p;
  template <typename X>
  __device__ X* take(size_t n) {
    X* r = reinterpret_cast<X*>(p);
    p += round16(n * sizeof(X));
    return r;
  }
};

// ---- the plan: tiles, k-slices, passes and shared memory by H and W's type
// (mirrored by ops/cuda/joint.py::joint_plan, held equal on the card) ------

// joint_prep.cu: the h tile (hcols columns: all of Hp, or a k-slice that
// each step refills), the ring of W stages (wrows rows each), the blank and
// label logit of each row, the warps' (max, sum) and the rows' (b, t, u,
// label).
template <typename TW, int TM, bool kSliced = false>
struct Prep : RowTiles<TW, TM, kSliced> {
  using R = RowTiles<TW, TM, kSliced>;
  using T = typename R::T;
  static __host__ __device__ size_t bytes(int hcols, int wrows, int stages) {
    return round16(sizeof(T) * R::BM * R::ldh(hcols)) +
           round16(sizeof(T) * stages * wrows * R::LDW) +
           round16(sizeof(float) * 2 * R::BM) +             // blank, label logit a row
           round16(sizeof(float) * 2 * R::WN * R::BM) +     // (max, sum) a warp column and row
           round16(sizeof(int) * 4 * R::BM);
  }
  // Two stages of a whole W tile where they fit at the largest H of this TM.
  static constexpr int kStages =
      round16(sizeof(T) * R::BM * (R::HMAX + Mma<TW>::kPadH)) +
                  round16(sizeof(T) * 2 * R::HMAX * R::LDW) + 4096 <= kSmemMax
          ? 2 : 1;
};

// joint_grad.cu's row kernel: the h tile, the W stages (one whole tile up to
// kPassH, so that two blocks share a multiprocessor with bf16 W; two
// k-slices above), the g tile, the rows' fields and (b, t, u, label). At the
// end of a pass its f32 d tile (dcols × (BM+1)) takes the place of the W
// stages and, where the epilogue recomputes h (bf16 W, or an h slice), of
// the h tile too.
template <typename TW, int TM, bool kSliced = false>
struct GradRows : RowTiles<TW, TM, kSliced> {
  using R = RowTiles<TW, TM, kSliced>;
  using T = typename R::T;
  static __host__ __device__ size_t h_bytes(int hcols) {
    return round16(sizeof(T) * R::BM * R::ldh(hcols));
  }
  static __host__ __device__ size_t ring_bytes(int hcols, int wrows, int stages, int dcols,
                                               bool d_over_h) {
    const size_t ring = sizeof(T) * stages * wrows * R::LDW;
    const size_t d = sizeof(float) * dcols * (R::BM + 1);
    const size_t need = d_over_h ? (d > h_bytes(hcols) ? d - h_bytes(hcols) : 0) : d;
    return ring > need ? ring : need;
  }
  static __host__ __device__ size_t bytes(int hcols, int wrows, int stages, int dcols,
                                          bool d_over_h) {
    return h_bytes(hcols) + round16(ring_bytes(hcols, wrows, stages, dcols, d_over_h)) +
           round16(sizeof(T) * R::BM * R::LDG) +
           round16(sizeof(float) * (4 + 2 * kPanel) * R::BM) + round16(sizeof(int) * 4 * R::BM);
  }
};

// Row tiles of the column kernel above kPassH, in sixteens: 128 rows (8 × 1
// warps over the 128 × 16 logits tile, a warp's two n8 tiles sharing each A
// fragment), so that all eight warps share each k-slice's logits and one W
// slice serves 128 rows.
constexpr int kColsSlicedRM = 8;

// joint_grad_cols.cu: a block owns a stripe of BN = 16·TM columns of V and
// walks row tiles of BM = 16·RM rows (RM = TM up to kPassH, kColsSlicedRM
// above). Warps stand WM × WN over the BM × BN logits tile (NI n8 tiles
// each; at TM = RM = 2 and 1 some warps have no share) and 8 × 1 over the
// Hp × BN slice of dW (MI m16 tiles at most × BN/8 n8 tiles each, 16), a
// pass of kPassH rows of it above kPassH.
template <typename TW, int TM, int RM = TM>
struct GradCols {
  using T = typename Mma<TW>::T;
  static constexpr int BM = kDim * RM, BN = kDim * TM;
  static constexpr int HMAX = kPassH / TM;
  static constexpr int WM = RM;
  static constexpr int WN = kWarps / RM < BN / 8 ? kWarps / RM : BN / 8;
  static constexpr int NI = BN / (8 * WN);
  static constexpr int MI = HMAX / (16 * kWarps);  // dW's m16 tiles a warp, at most
  static constexpr int NJ = BN / 8;
  static constexpr int LDW = BN + Mma<TW>::kPadW;
  static constexpr int LDG = BN + Mma<TW>::kPadW;  // g read as B along rows, like W
  static constexpr int kFields = 4 + kPanel;       // den, coef, cb, ce, the K extra fields
  static __host__ __device__ constexpr int ldh(int Hp) { return Hp + Mma<TW>::kPadH; }
  // Besides the tiles: two sets of row fields and of (b, t, u, label), the
  // db partials, the bias and the extra-column index of each column.
  static constexpr size_t kSmall = round16(sizeof(float) * 2 * kFields * BM) +
                                   round16(sizeof(float) * WM * BN) +
                                   round16(sizeof(int) * 2 * 4 * BM) +
                                   round16(sizeof(float) * BN) + round16(sizeof(int) * BN);
  static size_t bytes(int Hp, int hbuf) {
    return round16(sizeof(T) * Hp * LDW) + round16(sizeof(T) * hbuf * BM * ldh(Hp)) +
           round16(sizeof(T) * BM * LDG) + kSmall;
  }
  // Blocks a multiprocessor: two with bf16 W (the registers held to 128;
  // one h tile, so that two blocks fit 227 KB), one with f32 W, whose tiles
  // fill it; then two h tiles where they fit at the largest H of this TM.
  // Above kPassH (kSliced) the launch bound asks for one block, whose
  // registers then hold a pass's dW, the slices' partials and the step's
  // addresses without spilling; the occupancy query says how many fit.
  static constexpr int kBlocks = sizeof(T) == 2 ? 2 : 1;
  static constexpr int kHBuf =
      kBlocks == 1 &&
              round16(sizeof(T) * HMAX * LDW) +
                      round16(sizeof(T) * 2 * BM * (HMAX + Mma<TW>::kPadH)) +
                      round16(sizeof(T) * BM * LDG) + kSmall <=
                  kSmemMax
          ? 2 : 1;
  // Above kPassH: two stages of a W slice (kSliceRows × LDW) and an h slice
  // (BM × kSliceRows), streamed for every row tile.
  static constexpr size_t kStage = round16(sizeof(T) * kSliceRows<TW> * LDW) +
                                   round16(sizeof(T) * BM * ldh(kSliceRows<TW>));
  static constexpr size_t kSlicedBytes = 2 * kStage + round16(sizeof(T) * BM * LDG) + kSmall;
};

struct Plan {
  int tm;           // tile_param(H): a row tile is 16·tm rows
  int hp;           // H padded to a multiple of kHAlign
  int sliced;       // 0: one k-slice (all of hp) and one pass; 1: above kPassH
  int ks;           // rows of W (and columns of h) of a k-slice of the prep and row kernel
  int slices;       // k-slices of hp
  int passes;       // passes over H of the row kernel's dh and the column kernel's dW
  int prep_hcols;   // columns of the prep's h tile: hp (whole) or ks (refilled each step)
  int prep_stages;  // W stages of the prep's ring
  int rows_hcols;   // columns of the row kernel's h tile: hp or ks
  long long prep_smem, rows_smem, cols_smem;  // dynamic shared memory of a block
};

template <typename TW, int TM>
inline Plan plan_tm(int H) {
  using P = Prep<TW, TM>;
  using G = GradRows<TW, TM>;
  using C = GradCols<TW, TM>;
  constexpr bool bf16 = sizeof(typename Mma<TW>::T) == 2;
  Plan q{};
  q.tm = TM;
  q.hp = padded_h(H);
  if (q.hp <= kPassH) {
    q.sliced = 0;
    q.ks = q.hp;
    q.slices = q.passes = 1;
    q.prep_hcols = q.rows_hcols = q.hp;
    q.prep_stages = P::kStages;
    q.prep_smem = (long long)P::bytes(q.hp, q.hp, P::kStages);
    q.rows_smem = (long long)G::bytes(q.hp, q.hp, 1, q.hp, bf16);
    q.cols_smem = (long long)C::bytes(q.hp, C::kHBuf);
    return q;
  }
  using PS = Prep<TW, TM, true>;
  using GS = GradRows<TW, TM, true>;
  const int ks = kSliceRows<TW>;
  q.sliced = 1;
  q.ks = ks;
  q.slices = (q.hp + ks - 1) / ks;
  q.passes = (q.hp + kPassH - 1) / kPassH;
  q.prep_stages = 2;
  // The h tile whole where it fits beside the ring, else a k-slice.
  const size_t prep_whole = PS::bytes(q.hp, ks, 2);
  q.prep_hcols = prep_whole <= kSmemMax ? q.hp : ks;
  q.prep_smem = (long long)PS::bytes(q.prep_hcols, ks, 2);
  const size_t rows_whole = GS::bytes(q.hp, ks, 2, kPassH, bf16);
  q.rows_hcols = rows_whole <= kSmemMax ? q.hp : ks;
  q.rows_smem = (long long)GS::bytes(q.rows_hcols, ks, 2, kPassH,
                                     bf16 || q.rows_hcols != q.hp);
  q.cols_smem = (long long)GradCols<TW, TM, kColsSlicedRM>::kSlicedBytes;
  return q;
}

template <typename TW>
inline Plan plan(int H) {
  switch (tile_param(H)) {
    case 4: return plan_tm<TW, 4>(H);
    case 2: return plan_tm<TW, 2>(H);
    default: return plan_tm<TW, 1>(H);
  }
}

// The extra column that equals v, as its index k, or -1. Unrolled over the
// by-value table with constant indices, so the table stays in the
// parameter bank (its unused entries hold -1).
__device__ __forceinline__ int extra_index(const wtt::ExtraCols& cols, int v) {
  int k = -1;
#pragma unroll
  for (int i = 0; i < wtt::kMaxExtraCols; ++i)
    if (v == cols.col[i]) k = i;
  return k;
}

// Whether any extra column lies in [v0, v0 + width): the same answer for
// every thread of a block, so that the tiles without one (all but K of
// them) skip the per-column search.
__device__ __forceinline__ bool has_extra(const wtt::ExtraCols& cols, int v0, int width) {
  bool any = false;
#pragma unroll
  for (int i = 0; i < wtt::kMaxExtraCols; ++i)
    any |= cols.col[i] >= v0 && cols.col[i] < v0 + width;
  return any;
}

// One element of the dense gradient, formed in f32 before any rounding:
// coef·softmax(v) − cb·[v = blank] − ce·[v = label] − cx[xk] where column v
// is extra column xk (xk = -1: none). cx: the row's panel of extra fields.
__device__ __forceinline__ float grad_element(float logit, float denom, float coef, float cb,
                                              float ce, int v, int blank, int lab,
                                              const float* cx, int xk) {
  float g = coef * expf(logit + denom);
  if (v == blank) g -= cb;
  if (v == lab) g -= ce;
  if (xk >= 0) g -= cx[xk];
  return g;
}

// panel[m·kPanel + c] = src[cell(m)·C + c] for the tile's rows and c < C,
// zero for c >= C, for rows beyond the end and where src is null.
// src: (B, T, U, C).
template <int BM>
__device__ __forceinline__ void load_panel(float* panel, const float* __restrict__ src, int C,
                                           const int* s_b, const int* s_t, const int* s_u, int T,
                                           int U) {
  for (int idx = threadIdx.x; idx < BM * kPanel; idx += kThreads) {
    const int m = idx / kPanel, c = idx % kPanel;
    const int b = s_b[m];
    float x = 0.f;
    if (src != nullptr && b >= 0 && c < C)
      x = src[(((long long)b * T + s_t[m]) * U + s_u[m]) * C + c];
    panel[idx] = x;
  }
}

// d[(k − k0)·ldh + m] of the tile's rows, k0 <= k < k1, into de and dp. One
// thread per k sums the runs of rows that share (b, t) and adds each run to
// de with one atomicAdd (a run is cut only at a tile edge), and adds every
// row to dp.
template <int BM>
__device__ __forceinline__ void scatter_de_dp(const float* ds, int ldh, const int* s_b,
                                              const int* s_t, const int* s_u, const Rows& rows,
                                              int H, int k0, int k1, float* __restrict__ de,
                                              float* __restrict__ dp) {
  for (int k = k0 + threadIdx.x; k < k1; k += kThreads) {
    float run = 0.f;
    for (int m = 0; m < BM; ++m) {
      const int b = s_b[m];
      if (b < 0) break;
      const float d = ds[(k - k0) * ldh + m];
      atomicAdd(dp + ((long long)b * rows.U + s_u[m]) * H + k, d);
      run += d;
      const bool last = m + 1 == BM || s_b[m + 1] != b || s_t[m + 1] != s_t[m];
      if (last) {
        atomicAdd(de + ((long long)b * rows.T + s_t[m]) * H + k, run);
        run = 0.f;
      }
    }
  }
}

// The duration head of one row, by the calling warp:
// out[d] = Σ_k tanh(e_row[k] + p_row[k]) · Wd[k·D + d] for d < D, with the
// unrounded f32 h whatever the type of W (the token head's products round h
// to bf16 when W is bf16; this one never does). The lanes run along k;
// every lane returns every sum.
__device__ __forceinline__ void dur_row(const float* __restrict__ e_row,
                                        const float* __restrict__ p_row,
                                        const float* __restrict__ Wd, int H, int D, int lane,
                                        float (&out)[kPanel]) {
#pragma unroll
  for (int d = 0; d < kPanel; ++d) out[d] = 0.f;
  for (int k = lane; k < H; k += wtt::kWarp) {
    const float h = tanhf(e_row[k] + p_row[k]);
#pragma unroll
    for (int d = 0; d < kPanel; ++d)
      if (d < D) out[d] = fmaf(h, Wd[k * D + d], out[d]);
  }
#pragma unroll
  for (int d = 0; d < kPanel; ++d)
    if (d < D) out[d] = wtt::warp_sum(out[d]);
}

// dst[cell·D + d] = out[d] + bias_d[d], lane d writing column d (a select:
// no indexed copy of `out`).
__device__ __forceinline__ void store_dur_row(float* __restrict__ dst, const float (&out)[kPanel],
                                              const float* __restrict__ bias_d, int D, int lane) {
#pragma unroll
  for (int d = 0; d < kPanel; ++d)
    if (lane == d && d < D) dst[d] = out[d] + bias_d[d];
}

// Columns of dur_grad_tiles' h tile: H padded to a multiple of kBK, at most
// a pass.
inline __host__ __device__ int dur_grad_cols(int H) {
  const int Hp = (H + kBK - 1) / kBK * kBK;
  return Hp < kPassH ? Hp : kPassH;
}

// Shared memory of dur_grad_tiles at this H and tile height.
inline size_t dur_grad_smem_bytes(int H, int BM) {
  return sizeof(float) * ((size_t)dur_grad_cols(H) * (BM + 1) + (size_t)BM * kPanel) +
         sizeof(int) * 3 * BM;
}

// dWd of the duration head (joint_grad.cu's joint_grad_dwd_kernel), the body
// of a block that walks every gridDim.x-th tile of BM valid rows, once for
// each pass of kPassH columns of k. With the unrounded h of the tile and the
// pass in shared memory it accumulates its partial of
// dWd[k][d] = Σ_rows h[k]·g_dur[d] (thread tid owns k = k0 + tid + 256·q of
// pass k0, in registers across the tiles). The block's partial is written
// whole to dWd_part[blockIdx.x] (H × D), zeros when it met no tile;
// sum_parts_kernel adds the partials in a fixed order, so dWd does not
// depend on the order in which blocks ran. e, p: f32; g_dur: (B, T, U, D),
// zero outside the lattice.
template <int BM>
__device__ __forceinline__ void dur_grad_tiles(const float* __restrict__ e,
                                               const float* __restrict__ p,
                                               const float* __restrict__ g_dur, const Rows& rows,
                                               float* __restrict__ dWd_part, int H, int D,
                                               float* smem) {
  constexpr int KQ = kPassH / kThreads;
  const int cols = dur_grad_cols(H);
  const int ldh = BM + 1;
  float* hs = smem;                                 // cols × ldh
  float* s_gd = hs + (size_t)cols * ldh;            // BM × kPanel
  int* s_b = reinterpret_cast<int*>(s_gd + BM * kPanel);
  int* s_t = s_b + BM;
  int* s_u = s_t + BM;
  const int tid = threadIdx.x;
  const long long total = rows.offsets[rows.B];
  float* out = dWd_part + (size_t)blockIdx.x * H * D;

  for (int k0 = 0; k0 < H; k0 += kPassH) {
    float acc[KQ][kPanel] = {};
    for (long long first = (long long)blockIdx.x * BM; first < total;
         first += (long long)gridDim.x * BM) {
      __syncthreads();  // the last tile consumed
      place_rows<BM>(rows, first, s_b, s_t, s_u);
      __syncthreads();
      load_panel<BM>(s_gd, g_dur, D, s_b, s_t, s_u, rows.T, rows.U);
      fill_h<BM>(hs, ldh, e, p, s_b, s_t, s_u, rows.T, rows.U, H, k0, cols);
      __syncthreads();
#pragma unroll
      for (int q = 0; q < KQ; ++q) {
        const int kl = tid + q * kThreads;
        if (k0 + kl >= H) continue;
        for (int m = 0; m < BM; ++m) {
          const float h = hs[kl * ldh + m];
#pragma unroll
          for (int d = 0; d < kPanel; ++d) acc[q][d] = fmaf(h, s_gd[m * kPanel + d], acc[q][d]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < KQ; ++q) {
      const int k = k0 + tid + q * kThreads;
      if (k >= H) continue;
#pragma unroll
      for (int d = 0; d < kPanel; ++d)
        if (d < D) out[k * D + d] = acc[q][d];
    }
  }
}

// out[i] = Σ_s part[s·n + i], added in the order of s.
static __global__ void sum_parts_kernel(const float* __restrict__ part, float* __restrict__ out,
                                        long long n, int nsplit) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < nsplit; ++k) s += part[(size_t)k * n + i];
  out[i] = s;
}

// Launch sum_parts_kernel over n elements; returns the launch's error.
inline cudaError_t sum_parts(const float* part, float* out, long long n, int nsplit,
                             cudaStream_t stream) {
  sum_parts_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(part, out, n, nsplit);
  return cudaGetLastError();
}

// ---- what the gradient kernels' launches share (joint_grad.cu,
// joint_grad_cols.cu) ----------------------------------------------------------

// W's rows are 16-byte aligned, so the tiles can take them by cp.async.
template <typename TW>
inline bool w_aligned(const void* W, int V) {
  return reinterpret_cast<uintptr_t>(W) % 16 == 0 && (V * sizeof(TW)) % 16 == 0;
}

struct GradArgs {
  const float *e, *p;
  const void* W;
  const float* bias;
  const int* lab_full;
  Rows rows;
  const float *denom, *coef, *cb, *ce, *cx;
  wtt::ExtraCols cols;
  int H, V, blank;
  cudaStream_t stream;
};

// The common arguments of the gradient kernels' entries; false when the
// extra columns are not K <= 8 indices inside [0, V) with their fields.
inline bool make_grad_args(GradArgs* a, const void* e, const void* p, const void* W,
                           const void* bias, const int* lab_full, const void* offsets,
                           const int* label_lengths, const void* denom, const void* coef,
                           const void* cb, const void* ce, const void* cx, const int* extra_cols,
                           int K, int B, int T, int U, int H, int V, int blank, void* stream) {
  *a = GradArgs{static_cast<const float*>(e), static_cast<const float*>(p), W,
                static_cast<const float*>(bias), lab_full,
                Rows{static_cast<const long long*>(offsets), label_lengths, B, T, U},
                static_cast<const float*>(denom), static_cast<const float*>(coef),
                static_cast<const float*>(cb), static_cast<const float*>(ce),
                static_cast<const float*>(cx), wtt::ExtraCols{}, H, V, blank,
                static_cast<cudaStream_t>(stream)};
  return wtt::extra_cols(extra_cols, K, V, &a->cols) && (K == 0 || cx != nullptr);
}

}  // namespace joint
}  // namespace wtt
