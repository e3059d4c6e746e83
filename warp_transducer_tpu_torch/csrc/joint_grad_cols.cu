// Fused joint gradient, its column launch: dW and db of the fused
// joint+loss (joint_grad.cu has the row launch, the dWd kernel and the note
// on the arithmetic, the types and the chunks).
//
// Replaces, with joint_grad.cu: warp_transducer_tpu/ops/pallas/
// joint_fused.py::_grad_kernel (fused_grad, fused_grad_mb, fused_grad_tdt).
//
// Bound on this card: operations, 2·R·H·V (hᵀ·g) over the tensor cores'
// rate (989 TFLOP/s bf16; 495 / 3 with f32 W).
//
// Design. joint_grad_dw_kernel: a block owns a 128 × 128 tile of dW (rows of
// Hp, columns of Vp) and sums hᵀ·g over the chunk's valid row tiles (or a
// span of them, where the tiles of dW are too few to fill the card) on the
// wgmma engine of joint.cuh (A = hᵀ, B = gᵀ, both K-major along the chunk's
// rows, as the row launch wrote them), then adds the chunk's sum to dW or to
// its split's slice of dW (the first chunk writes it); after the last chunk
// sum_parts_kernel adds the slices in a fixed order. With f32 W each stage's sum is added to the
// running sum by an f32 add (joint.cuh::mma_step). joint_grad_db_kernel adds the
// chunk's db partials (one a row tile, written by joint_grad_g_kernel) in
// tile order, a thread a column. Every element of dW (or of a slice) and of
// db is owned by one thread of one block in each chunk's launch and the
// chunks run in order, so both are sums in a fixed order: the same bits on
// every call.
#include "joint.cuh"

namespace {

using namespace wtt::joint;

// Rows of the chunk that hold valid rows, rounded up to whole row tiles.
__device__ __forceinline__ int chunk_rows(const Rows& rows, long long row_begin, int chunk) {
  const long long left = rows.offsets[rows.B] - row_begin;
  return left <= 0 ? 0 : left >= chunk ? chunk : pad128(left);
}

// A block: the 128 × 128 tile of dW at rows k0 .. k0 + 127 of Hp
// (blockIdx.x) and columns v0 .. v0 + 127 of Vp (blockIdx.y), summed over
// the chunk's valid row tiles of its split (blockIdx.z: the chunk's row
// tiles in gridDim.z spans), added to (or, without `accumulate`, written
// to) its slice dW_out[z] (H × V).
template <typename TW>
__global__ void __launch_bounds__(kThreads, 1)
joint_grad_dw_kernel(const typename Op<TW>::T* __restrict__ ht,
                     const typename Op<TW>::T* __restrict__ gt, int chunk, Rows rows,
                     long long row_begin, float* __restrict__ dW_out, bool accumulate, int H,
                     int V) {
  using O = Op<TW>;
  using T = typename O::T;
  constexpr int KT = kBM / O::kKS;  // k-slices a row tile
  const int Hp = pad128(H), Vp = pad128(V), k0 = blockIdx.x * kBM, v0 = blockIdx.y * kBN;
  const int span = (chunk / kBM + gridDim.z - 1) / gridDim.z;  // row tiles a split
  const int t0 = blockIdx.z * span, t1 = min(chunk_rows(rows, row_begin, chunk) / kBM, t0 + span);
  extern __shared__ __align__(128) unsigned char joint_smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(joint_smem + kRingBytes<TW>);
  const Frag f;
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;  // a split with no tiles writes zeros
  const Src<T> a = row_tile<TW>(ht, blockIdx.x, chunk, (long long)Hp * chunk);
  const Src<T> b = row_tile<TW>(gt, blockIdx.y, chunk, (long long)Vp * chunk);
  auto load = [&](int i, unsigned char* stage, uint32_t bar) {
    load_stage<TW>(stage, bar, a, t0 * KT + i, b, t0 * KT + i);
  };
  const int n = t1 > t0 ? (t1 - t0) * KT : 0;
  run_ring<kStageBytes<TW>>(n, joint_smem, bars, load, [&](int i, uint32_t stage) {
    mma_step<TW>(acc, part, stage, f.wg, i == 0);
  });
  float* out = dW_out + (long long)blockIdx.z * H * V;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int k = k0 + f.row0 + 8 * r, v = v0 + 8 * j + f.tq2 + q;
        if (k < H && v < V) {
          float* o = out + (long long)k * V + v;
          *o = accumulate ? *o + acc[4 * j + 2 * r + q] : acc[4 * j + 2 * r + q];
        }
      }
}

__global__ void __launch_bounds__(kThreads)
joint_grad_db_kernel(const float* __restrict__ db_part, int chunk, Rows rows,
                     long long row_begin, float* __restrict__ db, bool accumulate, int V) {
  const int v = blockIdx.x * kThreads + threadIdx.x;
  if (v >= V) return;
  const int tiles = chunk_rows(rows, row_begin, chunk) / kBM, Vp = pad128(V);
  float s = 0.f;
  for (int t = 0; t < tiles; ++t) s += db_part[(long long)t * Vp + v];
  db[v] = accumulate ? db[v] + s : s;
}

// What the column launch takes: the chunk's buffers, dW (or its slices)
// and db, and the splits of dW's sum over the chunk's rows.
struct ColsArgs {
  const void *ht, *gt;
  const float* db_part;
  float *dW, *dW_part, *db;
  int chunk, dw_split;
  long long row_begin;
  bool accumulate, finish;
};

template <typename TW>
int launch_cols(const ColsArgs& c, const Rows& rows, int H, int V, cudaStream_t stream) {
  using T = typename Op<TW>::T;
  const Plan q = plan<TW>(H, V, 0);
  // One split writes dW itself; more write their slices, which the last
  // chunk's launch adds in a fixed order.
  float* out = c.dw_split > 1 ? c.dW_part : c.dW;
  int err = (int)launch(joint_grad_dw_kernel<TW>, dim3(q.hp / kBM, q.vp / kBN, c.dw_split),
                        (size_t)q.dw_smem, stream, static_cast<const T*>(c.ht),
                        static_cast<const T*>(c.gt), c.chunk, rows, c.row_begin, out,
                        c.accumulate, H, V);
  if (err != 0) return err;
  joint_grad_db_kernel<<<(V + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      c.db_part, c.chunk, rows, c.row_begin, c.db, c.accumulate, V);
  err = (int)cudaGetLastError();
  if (err != 0 || !c.finish || c.dw_split == 1) return err;
  return (int)sum_parts(c.dW_part, c.dW, (long long)H * V, c.dw_split, stream);
}

}  // namespace

extern "C" {

// Dynamic shared memory the dW kernel asks for at this H (the larger of the
// two W types).
long long wtt_joint_grad_cols_smem(int H) {
  const long long f = plan<float>(H, 1, 0).dw_smem, b = plan<__nv_bfloat16>(H, 1, 0).dw_smem;
  return f > b ? f : b;
}

// Registers a thread and local (spill) bytes of joint_grad_dw_kernel with W
// of this type, as ptxas compiled it. Returns the cudaError_t of the query.
int wtt_joint_grad_cols_attrs(int w_dtype, int* regs, int* local_bytes) {
  switch (w_dtype) {
    case wtt::kF32: return kernel_attrs(joint_grad_dw_kernel<float>, regs, local_bytes);
    case wtt::kBF16:
      return kernel_attrs(joint_grad_dw_kernel<__nv_bfloat16>, regs, local_bytes);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dW: (H,V) f32 and db: (V,) f32 over the valid rows row_begin .. row_begin +
// chunk − 1, from the chunk's ht (Hp, chunk), gt (Vp, chunk) and db_part
// (chunk / 128, Vp) as wtt_joint_grad_rows wrote them (w_dtype: W's type);
// with `accumulate` added to dW and db (the rows of earlier chunks), else
// written. With dw_split > 1 the chunk's row tiles go in dw_split spans,
// each summed into its slice of dW_part (dw_split, H, V) f32, and with
// `finish` (the last chunk) the slices are added into dW in a fixed order.
// offsets, label_lengths as there. Returns the launches' cudaError_t.
int wtt_joint_grad_cols(const void* offsets, const int* label_lengths, int w_dtype,
                        const void* ht, const void* gt, const void* db_part, void* dW,
                        void* dW_part, void* db, long long row_begin, int chunk, int dw_split,
                        int accumulate, int finish, int B, int T, int U, int H, int V,
                        void* stream) {
  if (V == 0 || H == 0) return 0;
  if (chunk < kBM || chunk % kBM != 0 || row_begin % kBM != 0 || dw_split < 1 ||
      (dw_split > 1 && dW_part == nullptr))
    return (int)cudaErrorInvalidValue;
  const Rows rows{static_cast<const long long*>(offsets), label_lengths, B, T, U};
  const ColsArgs c{ht, gt, static_cast<const float*>(db_part), static_cast<float*>(dW),
                   static_cast<float*>(dW_part), static_cast<float*>(db), chunk, dw_split,
                   row_begin, accumulate != 0, finish != 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_dtype == wtt::kF32) return launch_cols<float>(c, rows, H, V, s);
  if (w_dtype == wtt::kBF16) return launch_cols<__nv_bfloat16>(c, rows, H, V, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
