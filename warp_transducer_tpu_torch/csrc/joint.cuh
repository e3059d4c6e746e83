// Shared pieces of the fused joint+loss kernels (joint_prep.cu,
// joint_grad.cu, joint_grad_cols.cu, dur_head.cu): the compacted list of
// valid lattice rows, the product engine of the token head (warpgroup MMA
// from a ring of bulk copies in shared memory), the layouts of its operands
// in device memory, the per-row panels of the extra coefficient fields and of
// the duration head's cotangent, and the duration head's own products (a
// warp's dot products going in, one thread per k coming back). Up to 8 extra
// columns or duration columns ride in the panels and the by-value column
// table; past 8 (no cap) the kernels' instances of their own (kMany) read the
// columns from a device table and the fields from device memory, and take
// the duration head in groups of 8 columns.
//
// Rows. A row is a lattice cell (b, t, u); only the cells inside each
// utterance's lattice, t < T_b and u < U_b, carry work. They are numbered
// b-major, then t, then u, through `offsets` (B+1 running sums of T_b·U_b),
// and a block takes a tile of consecutive numbers, so no block spends
// products on padding. The grid is sized for all B·T·U cells, since the
// host never reads the lengths; blocks beyond the last valid tile leave at
// once.
//
// The product engine. Every product of the token head (logits = h·W,
// dh = g·Wᵀ, dW = hᵀ·g) is C = A·Bᵀ over a shared depth K, with A (M × K)
// and B (N × K) both K-major (K contiguous) in device memory: the wrappers
// lay out W and Wᵀ, and the kernels write h, hᵀ, g and gᵀ of a chunk of rows,
// in the layout each product reads. A block owns a 128 × 128 tile of C: two
// consumer warpgroups of 64 rows each issue wgmma (m64n128, sm_90a) from
// shared memory, with the sums in registers. A and B come through a ring of
// kStages stages of k-slices (16 KB a 128-row tile a part). The operands are
// stored in device memory in the very order of wgmma's shared-memory layout
// (core matrices of 8 rows × 16 bytes, no swizzle, the next core matrix along
// K 128 bytes on and the next 8 rows kChunks·128 bytes on), so one thread
// fills a stage with one bulk copy (cp.async.bulk) a tile, which completes on
// the stage's mbarrier: no thread computes an address a piece, and the
// copies, like wgmma's reads, go through the async proxy, so no proxy fence
// waits on the copies in flight.
// * bf16 W: the operands are bf16 (h rounded, g rounded after its
//   subtractions), m64n128k16 with f32 sums.
// * f32 W: each operand is held as two tf32 arrays, x = hi + lo with
//   hi = tf32(x), lo = tf32(x − hi), split once where the array is written
//   (never again by the warps that read it), and each product is three
//   m64n128k8 tf32 products, lo·hi + hi·lo + hi·hi (the small terms first),
//   which keeps about 22 bits of each product: f32 accuracy, where plain TF32
//   keeps 11. wgmma takes tf32 operands K-major only, which is why every
//   operand has its K-major copy.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace wtt {
namespace joint {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / wtt::kWarp;
// Width of a per-row panel in shared memory: the K extra coefficient fields
// or the D duration columns of a row, padded with zeros; K or D past it run
// in the kMany instances.
constexpr int kPanel = wtt::kMaxExtraCols;

// K > kPanel extra columns (the kMany instances): their indices in device
// memory, the least and the largest of them, and whether they run lo, lo + 1,
// … in the order of k (the default big blanks: found without the table).
struct ManyCols {
  const int* table;
  int lo, hi, contiguous;
};

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

__host__ __device__ constexpr size_t round16(size_t bytes) { return (bytes + 15) / 16 * 16; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// ---- the operands' layouts in device memory ---------------------------------
//
// Tiles are 128 rows and 128 columns: H and V are padded with zeros to
// multiples of 128 in every operand (Hp, Vp), and a chunk of rows is a whole
// number of 128-row tiles. An operand of R rows and Kp columns is stored as
// the ring reads it: a sequence of 16 KB tiles of 128 rows × kKS columns
// (128 bytes of each row), row tile by row tile and along K within a row
// tile, each tile in the order of wgmma's core matrices (8 rows × 16 bytes,
// the 8 pieces of a row's 128 bytes one after the other for each 8 rows).
// A ring stage then fills with one bulk copy a tile.
constexpr int kBM = 128;  // rows of a block's tile of C (two warpgroups of 64)
constexpr int kBN = 128;  // columns of a block's tile of C (wgmma n128)
constexpr int kChunks = 8;                // 16-byte pieces of a tile row
constexpr size_t kTileBytes = 128 * 128;  // 128 rows × 128 bytes: one part of A or B
inline __host__ __device__ int pad128(long long n) { return (int)((n + 127) / 128 * 128); }

// The operand type by the type of W: its element, how many arrays hold an
// operand (bf16: one; f32: hi and lo, each `n` elements after the other),
// the depth of a ring stage, and how 16-byte pieces of f32 values are stored.
template <typename TW> struct Op;

template <> struct Op<__nv_bfloat16> {
  using T = __nv_bfloat16;
  static constexpr int kParts = 1;
  static constexpr int kKS = 64;  // k of a stage: 128 bytes of a row
  static constexpr int kE = 8;    // elements of a 16-byte piece
  static __device__ __forceinline__ void put(T* dst, long long n, long long i, float x) {
    dst[i] = __float2bfloat16(x);
  }
  static __device__ __forceinline__ void put_piece(T* dst, long long n, long long i,
                                                   const float (&x)[kE]) {
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int q = 0; q < 4; ++q) h[q] = __floats2bfloat162_rn(x[2 * q], x[2 * q + 1]);
    *reinterpret_cast<uint4*>(dst + i) = v;
  }
  static __device__ __forceinline__ float from(__nv_bfloat16 x) { return __bfloat162float(x); }
};

template <> struct Op<float> {
  using T = float;
  static constexpr int kParts = 2;
  static constexpr int kKS = 32;  // k of a stage: 128 bytes of a row
  static constexpr int kE = 4;
  static __device__ __forceinline__ void split(float x, float& hi, float& lo) {
    hi = __uint_as_float(to_tf32(x));
    lo = __uint_as_float(to_tf32(x - hi));
  }
  static __device__ __forceinline__ void put(T* dst, long long n, long long i, float x) {
    split(x, dst[i], dst[n + i]);
  }
  static __device__ __forceinline__ void put_piece(T* dst, long long n, long long i,
                                                   const float (&x)[kE]) {
    float hi[4], lo[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) split(x[q], hi[q], lo[q]);
    *reinterpret_cast<float4*>(dst + i) = make_float4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<float4*>(dst + n + i) = make_float4(lo[0], lo[1], lo[2], lo[3]);
  }
  static __device__ __forceinline__ float from(float x) { return x; }
};

// Elements of a 16 KB tile.
template <typename TW>
constexpr long long kTileElems = 128LL * Op<TW>::kKS;

// The element index of (r, k) in an operand of Kp columns stored in tiles.
template <typename TW>
__host__ __device__ __forceinline__ long long tiled(long long r, int k, int Kp) {
  constexpr int KS = Op<TW>::kKS, E = Op<TW>::kE;
  return ((r >> 7) * (Kp / KS) + k / KS) * kTileElems<TW> +
         ((((r & 127) >> 3) * kChunks + (k % KS) / E) * 8 + (r & 7)) * E + k % E;
}

// Row tile `rt` of an operand of Kp columns: its first tile, and the offset
// of an f32 operand's lo array.
template <typename T>
struct Src {
  const T* base;
  long long n;
};
template <typename TW>
__device__ __forceinline__ Src<typename Op<TW>::T> row_tile(const typename Op<TW>::T* a,
                                                             long long rt, int Kp, long long n) {
  return Src<typename Op<TW>::T>{a + rt * (Kp / Op<TW>::kKS) * kTileElems<TW>, n};
}

// ---- the ring: bulk copies signalled through mbarriers -------------------------

constexpr int kStages = 3;
template <typename TW>
constexpr size_t kStageBytes = Op<TW>::kParts * 2 * kTileBytes;  // [A hi][B hi]([A lo][B lo])
template <typename TW>
constexpr size_t kRingBytes = kStages * kStageBytes<TW>;

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// `bytes` from global `src` to shared `dst`, completing on mbarrier `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// K-tile kt of the operands' current row tiles into a stage: A's and B's
// tile, and with f32 their lo tiles 2·kTileBytes further on. Thread 0 only.
template <typename TW>
__device__ __forceinline__ void load_stage(unsigned char* stage, uint32_t bar,
                                           const Src<typename Op<TW>::T>& a, long long a_kt,
                                           const Src<typename Op<TW>::T>& b, long long b_kt) {
  mbar_expect(bar, (uint32_t)kStageBytes<TW>);
#pragma unroll
  for (int q = 0; q < Op<TW>::kParts; ++q) {
    bulk_copy(stage + q * 2 * kTileBytes, a.base + q * a.n + a_kt * kTileElems<TW>,
              (uint32_t)kTileBytes, bar);
    bulk_copy(stage + q * 2 * kTileBytes + kTileBytes, b.base + q * b.n + b_kt * kTileElems<TW>,
              (uint32_t)kTileBytes, bar);
  }
}

// ---- warpgroup MMA ------------------------------------------------------------

// The matrix descriptor of a K-major tile without swizzle at shared address
// `addr`: LBO (the next core matrix along K) 128 bytes, SBO (the next 8 rows)
// kChunks·128 bytes.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(kChunks * 128 >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous products.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WTT_F2(i) "+f"(d[i]), "+f"(d[i + 1])
#define WTT_F8(i) WTT_F2(i), WTT_F2(i + 2), WTT_F2(i + 4), WTT_F2(i + 6)
#define WTT_F64                                                                             \
  WTT_F8(0), WTT_F8(8), WTT_F8(16), WTT_F8(24), WTT_F8(32), WTT_F8(40), WTT_F8(48), WTT_F8(56)
#define WTT_D64                                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "  \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "    \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "    \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "

// d (64 × 128 of the warpgroup, f32) = A·Bᵀ (+ d unless `zero`) over k16
// (bf16) or k8 (tf32). Fragment: warp w of the warpgroup holds rows 16w + gr
// (d[4j + q]) and 16w + gr + 8 (d[4j + 2 + q]), columns 8j + 2tq + q.
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t a, uint64_t b, int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WTT_D64
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : WTT_F64
      : "l"(a), "l"(b), "r"(scale));
}
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t a, uint64_t b, int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " WTT_D64
      "%64, %65, p, 1, 1;\n}\n"
      : WTT_F64
      : "l"(a), "l"(b), "r"(scale));
}
#undef WTT_F2
#undef WTT_F8
#undef WTT_F64
#undef WTT_D64

// The products of one ring stage (kKS of depth; its tiles [A hi][B hi]
// ([A lo][B lo])) into the accumulators of warpgroup `wg` (its 64 rows of
// A), issued, not waited for; `zero` starts the sums afresh. With f32 W:
// lo·hi + hi·lo + hi·hi a k8 step.
template <typename TW>
__device__ __forceinline__ void stage_product(float (&d)[64], uint32_t stage, int wg, bool zero) {
  const uint32_t a = stage + wg * 8 * kChunks * 128, b = stage + (uint32_t)kTileBytes;
#pragma unroll
  for (int j = 0; j < kChunks / 2; ++j) {
    const uint32_t o = j * 2 * 128;  // two core matrices along K a step
    const int scale = zero && j == 0 ? 0 : 1;
    if constexpr (Op<TW>::kParts == 1) {
      wgmma_bf16(d, gmma_desc(a + o), gmma_desc(b + o), scale);
    } else {
      constexpr uint32_t lo = 2 * kTileBytes;
      wgmma_tf32(d, gmma_desc(a + lo + o), gmma_desc(b + o), scale);
      wgmma_tf32(d, gmma_desc(a + o), gmma_desc(b + lo + o), 1);
      wgmma_tf32(d, gmma_desc(a + o), gmma_desc(b + o), 1);
    }
  }
}

// One step of a product, waited for. With bf16 W the stage's products go
// into acc. With f32 W they are summed in `part` and added to acc by an f32
// add: the tensor cores' accumulator truncates as it aligns its addends, and
// a sum over thousands of terms kept inside it drifts by more than f32's
// tolerance (the logits at H = 6000 missed the plain version by more than
// 1e-5); a stage's 32 terms do not. bf16's tolerance is far above that
// drift, and its kernels keep `part` out of their registers.
template <typename TW>
__device__ __forceinline__ void mma_step(float (&acc)[64], float (&part)[64], uint32_t stage,
                                         int wg, bool zero) {
  if constexpr (Op<TW>::kParts == 1) {
    fence_acc(acc);
    wgmma_fence();
    stage_product<TW>(acc, stage, wg, zero);
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(acc);
  } else {
    wgmma_fence();
    stage_product<TW>(part, stage, wg, true);
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(part);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = zero ? part[i] : acc[i] + part[i];
  }
}

// Steps 0 .. n − 1 through the ring of stages of SB bytes, kStages − 1
// ahead: load(i, stage, bar), run by thread 0, issues step i's bulk copies on mbarrier `bar`
// (load_stage); step(i, stage address) multiplies them (mma_step) and runs
// whatever follows the step. A stage is refilled only after every warp has
// passed the step that read it (the __syncthreads at the top of the next
// step; each warpgroup waits for its own products inside the step). The
// copies write shared memory through the async proxy, which wgmma reads, so
// no proxy fence stands between a stage's arrival and its products. `bars`:
// kStages mbarriers outside the ring. Shared memory outside the ring is free
// throughout; the ring itself is free after the return.
template <size_t SB, typename Load, typename Step>
__device__ __forceinline__ void run_ring(int n, unsigned char* ring, uint64_t* bars, Load load,
                                         Step step) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) mbar_init(smem_addr(bars + s));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int i = 0; i < kStages - 1 && i < n; ++i) load(i, ring + i * SB, smem_addr(bars + i));
  for (int i = 0; i < n; ++i) {
    const int slot = i % kStages;
    if (i > 0) __syncthreads();  // every warp is past step i − 1: its stage is free
    const int nx = i + kStages - 1;
    if (threadIdx.x == 0 && nx < n)
      load(nx, ring + (nx % kStages) * SB, smem_addr(bars + nx % kStages));
    mbar_wait(smem_addr(bars + slot), (uint32_t)(i / kStages) & 1);
    step(i, smem_addr(ring + slot * SB));
  }
  __syncthreads();
}

// This thread's place in a block's 128 × 128 tile of C: its warpgroup, and
// the first of its two rows (row0, row0 + 8) and its column within each n8
// tile (n = 8j + tq2 + q).
struct Frag {
  int wg, row0, tq2;
  __device__ Frag() {
    const int tid = threadIdx.x, lane = tid & 31;
    wg = tid >> 7;
    row0 = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
    tq2 = (lane & 3) * 2;
  }
};

// ---- h, and the weights' layouts -------------------------------------------

// h = tanh(e[b,t] + p[b,u]) of 128 consecutive valid rows (a tile of a chunk)
// and 32 columns k0 .. k0 + 31 (zero at k >= H and beyond the last row) in
// f32, into tile[m][kk] (33 floats a row). The lanes run along k.
__device__ __forceinline__ void h_tile(float (*tile)[33], const float* __restrict__ e,
                                       const float* __restrict__ p, const int* s_b,
                                       const int* s_t, const int* s_u, int T_, int U, int H,
                                       int k0) {
  for (int idx = threadIdx.x; idx < kBM * 32; idx += kThreads) {
    const int m = idx >> 5, kk = idx & 31, k = k0 + kk, b = s_b[m];
    float h = 0.f;
    if (b >= 0 && k < H)
      h = tanhf(e[((long long)b * T_ + s_t[m]) * H + k] + p[((long long)b * U + s_u[m]) * H + k]);
    tile[m][kk] = h;
  }
}

// ---- the extra columns, the gradient's element, the panels -------------------

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

// The kMany forms of the two: the range first, then a loop over the table
// at run time (the last match, as extra_index gives it).
__device__ __forceinline__ int extra_index(const ManyCols& mc, int n, int v) {
  if (v < mc.lo || v > mc.hi) return -1;
  if (mc.contiguous) return v - mc.lo;
  int k = -1;
  for (int i = 0; i < n; ++i)
    if (__ldg(mc.table + i) == v) k = i;
  return k;
}
__device__ __forceinline__ bool has_extra(const ManyCols& mc, int v0, int width) {
  return mc.hi >= v0 && mc.lo < v0 + width;
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

// panel[m·kPanel + c] = src[cell(m)·ld + c0 + c] for the tile's rows and
// c < nc (<= kPanel), zero elsewhere: columns c0 … c0 + nc − 1 of a
// (B, T, U, ld) src, a group of a head wider than a panel.
template <int BM>
__device__ __forceinline__ void load_panel_cols(float* panel, const float* __restrict__ src,
                                                int ld, int c0, int nc, const int* s_b,
                                                const int* s_t, const int* s_u, int T, int U) {
  for (int idx = threadIdx.x; idx < BM * kPanel; idx += kThreads) {
    const int m = idx / kPanel, c = idx % kPanel;
    const int b = s_b[m];
    float x = 0.f;
    if (b >= 0 && c < nc) x = src[(((long long)b * T + s_t[m]) * U + s_u[m]) * ld + c0 + c];
    panel[idx] = x;
  }
}

// ---- the duration head --------------------------------------------------------

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

// dur_row for columns d0 … d0 + nd − 1 (nd <= kPanel) of a head of ld
// columns: a group of a head wider than a panel.
__device__ __forceinline__ void dur_row_group(const float* __restrict__ e_row,
                                              const float* __restrict__ p_row,
                                              const float* __restrict__ Wd, int H, int ld, int d0,
                                              int nd, int lane, float (&out)[kPanel]) {
#pragma unroll
  for (int d = 0; d < kPanel; ++d) out[d] = 0.f;
  for (int k = lane; k < H; k += wtt::kWarp) {
    const float h = tanhf(e_row[k] + p_row[k]);
#pragma unroll
    for (int d = 0; d < kPanel; ++d)
      if (d < nd) out[d] = fmaf(h, Wd[(long long)k * ld + d0 + d], out[d]);
  }
#pragma unroll
  for (int d = 0; d < kPanel; ++d)
    if (d < nd) out[d] = wtt::warp_sum(out[d]);
}

// dst[cell·D + d] = out[d] + bias_d[d], lane d writing column d (a select:
// no indexed copy of `out`).
__device__ __forceinline__ void store_dur_row(float* __restrict__ dst, const float (&out)[kPanel],
                                              const float* __restrict__ bias_d, int D, int lane) {
#pragma unroll
  for (int d = 0; d < kPanel; ++d)
    if (lane == d && d < D) dst[d] = out[d] + bias_d[d];
}

// The dWd kernel (joint_grad.cu): row tiles of 16·dwd_tile(H) rows, k in
// passes of kDwdPass columns, H padded to a multiple of kBK in its h tile.
constexpr int kDim = 16;
constexpr int kBK = 16;
constexpr int kDwdPass = 1024;
inline __host__ __device__ int dwd_tile(int H) { return H <= 256 ? 4 : H <= 512 ? 2 : 1; }

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

// Columns of dur_grad_tiles' h tile: H padded to a multiple of kBK, at most
// a pass.
inline __host__ __device__ int dur_grad_cols(int H) {
  const int Hp = (H + kBK - 1) / kBK * kBK;
  return Hp < kDwdPass ? Hp : kDwdPass;
}

// Shared memory of dur_grad_tiles at this H and tile height.
inline size_t dur_grad_smem_bytes(int H, int BM) {
  return sizeof(float) * ((size_t)dur_grad_cols(H) * (BM + 1) + (size_t)BM * kPanel) +
         sizeof(int) * 3 * BM;
}

// dWd of the duration head (joint_grad.cu's joint_grad_dwd_kernel), the body
// of a block that walks every gridDim.x-th tile of BM valid rows, once for
// each pass of kDwdPass columns of k. With the unrounded h of the tile and
// the pass in shared memory it accumulates its partial of
// dWd[k][d] = Σ_rows h[k]·g_dur[d] (thread tid owns k = k0 + tid + 256·q of
// pass k0, in registers across the tiles). The block's partial is written
// whole to dWd_part[blockIdx.x] (H × D), zeros when it met no tile;
// sum_parts_kernel adds the partials in a fixed order, so dWd does not
// depend on the order in which blocks ran. e, p: f32; g_dur: (B, T, U, D),
// zero outside the lattice.
// kGroups: a head wider than a panel, walked once for each group of kPanel
// columns (the kMany instance).
template <int BM, bool kGroups = false>
__device__ __forceinline__ void dur_grad_tiles(const float* __restrict__ e,
                                               const float* __restrict__ p,
                                               const float* __restrict__ g_dur, const Rows& rows,
                                               float* __restrict__ dWd_part, int H, int D,
                                               float* smem) {
  constexpr int KQ = kDwdPass / kThreads;
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

  for (int d0 = 0; d0 < (kGroups ? D : 1); d0 += kPanel) {
  const int nd = kGroups ? min(kPanel, D - d0) : D;
  for (int k0 = 0; k0 < H; k0 += kDwdPass) {
    float acc[KQ][kPanel] = {};
    for (long long first = (long long)blockIdx.x * BM; first < total;
         first += (long long)gridDim.x * BM) {
      __syncthreads();  // the last tile consumed
      place_rows<BM>(rows, first, s_b, s_t, s_u);
      __syncthreads();
      if constexpr (kGroups)
        load_panel_cols<BM>(s_gd, g_dur, D, d0, nd, s_b, s_t, s_u, rows.T, rows.U);
      else
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
        if (d < nd) out[k * D + d0 + d] = acc[q][d];
    }
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

// ---- the plan: layouts, chunks and shared memory by H, V and W's type
// (mirrored by ops/cuda/joint.py::joint_plan, held equal on the card) ------

// Besides the ring, each engine kernel keeps its kStages mbarriers, and: the
// prep its rows' blank and label logit, (max, sum) and (b, t, u, label); the
// g kernel its rows' (denom, coef, cb, ce), K extra fields and (b, t, u,
// label) and its columns' bias and extra index. The g kernel's epilogue
// stages its 128 × 132 f32 tile of g over the ring.
constexpr size_t kBars = round16(sizeof(uint64_t) * kStages);
constexpr size_t kPrepSmall = round16(sizeof(float) * 4 * kBM) + round16(sizeof(int) * 4 * kBM);
constexpr size_t kGSmall = round16(sizeof(float) * (4 + kPanel) * kBM) +
                           round16(sizeof(int) * 4 * kBM) + round16(sizeof(float) * kBN) +
                           round16(sizeof(int) * kBN);
constexpr int kGLd = kBN + 4;  // floats a row of the g kernel's staged tile
static_assert(sizeof(float) * kBM * kGLd <= kStages * 2 * kTileBytes, "g stage fits the ring");

struct Plan {
  int hp, vp;               // H and V padded to multiples of 128
  int ks, stages;           // k of a ring stage (64 bf16, 32 f32), stages
  long long prep_smem, g_smem, dh_smem, dw_smem;  // dynamic shared memory of a block
  long long prep_rows;      // rows of a chunk of the prep (its h buffer)
  long long grad_rows;      // rows of a chunk of the gradient (h, hᵀ, g, gᵀ, dh, db partials)
};

// The chunks: whole 128-row tiles whose buffers take at most chunk_bytes, at
// least one tile.
template <typename TW>
inline Plan plan(int H, int V, long long chunk_bytes) {
  using O = Op<TW>;
  const long long elt = (long long)sizeof(typename O::T) * O::kParts;
  Plan q{};
  q.hp = pad128(H);
  q.vp = pad128(V);
  q.ks = O::kKS;
  q.stages = kStages;
  const long long ring = (long long)(kRingBytes<TW> + kBars);
  q.prep_smem = ring + (long long)kPrepSmall;
  q.g_smem = ring + (long long)kGSmall;
  q.dh_smem = q.dw_smem = ring;
  // Bytes a row: the prep's h; the gradient's h, hᵀ, g, gᵀ, one f32 partial
  // of dh and db's partials (a split of dh's sum over V takes another Hp f32
  // a row, the wrapper's choice).
  const long long prep_row = elt * q.hp;
  const long long grad_row = elt * 2 * (q.hp + q.vp) + 4LL * q.hp + q.vp / 32;
  const long long pr = chunk_bytes / prep_row / kBM * kBM, gr = chunk_bytes / grad_row / kBM * kBM;
  q.prep_rows = pr > kBM ? pr : kBM;
  q.grad_rows = gr > kBM ? gr : kBM;
  return q;
}

// ---- what the kernels' launches share -------------------------------------------

struct GradArgs {
  const float *e, *p;
  const void* W;
  const float* bias;
  const int* lab_full;
  Rows rows;
  const float *denom, *coef, *cb, *ce, *cx;
  wtt::ExtraCols cols;
  ManyCols many;  // K > kPanel: the device table and its range
  int H, V, blank;
  cudaStream_t stream;
};

// The extra columns of an entry: up to kPanel by value (`cols`), past that
// from the device table (cols.n = K and `many`); false when they are not
// indices inside [0, V), or past kPanel without a table.
inline bool read_cols(const int* extra_cols, int K, const int* table, int V,
                      wtt::ExtraCols* cols, ManyCols* many) {
  *many = ManyCols{table, 0, -1, 0};
  if (K <= kPanel) return wtt::extra_cols(extra_cols, K, V, cols);
  if (table == nullptr || !wtt::cols_inside(extra_cols, K, V)) return false;
  *cols = wtt::many_cols(K);
  many->lo = many->hi = extra_cols[0];
  many->contiguous = 1;
  for (int k = 1; k < K; ++k) {
    many->lo = extra_cols[k] < many->lo ? extra_cols[k] : many->lo;
    many->hi = extra_cols[k] > many->hi ? extra_cols[k] : many->hi;
    many->contiguous &= extra_cols[k] == extra_cols[0] + k;
  }
  return true;
}

// The common arguments of the gradient kernels' entries; false when the
// extra columns are not indices inside [0, V) with their fields (and, past
// kPanel of them, their device table).
inline bool make_grad_args(GradArgs* a, const void* e, const void* p, const void* W,
                           const void* bias, const int* lab_full, const void* offsets,
                           const int* label_lengths, const void* denom, const void* coef,
                           const void* cb, const void* ce, const void* cx, const int* extra_cols,
                           int K, const int* table, int B, int T, int U, int H, int V, int blank,
                           void* stream) {
  *a = GradArgs{static_cast<const float*>(e), static_cast<const float*>(p), W,
                static_cast<const float*>(bias), lab_full,
                Rows{static_cast<const long long*>(offsets), label_lengths, B, T, U},
                static_cast<const float*>(denom), static_cast<const float*>(coef),
                static_cast<const float*>(cb), static_cast<const float*>(ce),
                static_cast<const float*>(cx), wtt::ExtraCols{}, ManyCols{}, H, V, blank,
                static_cast<cudaStream_t>(stream)};
  return read_cols(extra_cols, K, table, V, &a->cols, &a->many) && (K == 0 || cx != nullptr);
}

// Set a kernel's dynamic shared memory and launch it; returns the error.
template <typename Kernel, typename... Args>
inline cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream,
                          Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// Registers a thread and local (spill) bytes of a kernel, as ptxas compiled it.
template <typename Kernel>
inline int kernel_attrs(Kernel kernel, int* regs, int* local_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return (int)err;
}

}  // namespace joint
}  // namespace wtt
