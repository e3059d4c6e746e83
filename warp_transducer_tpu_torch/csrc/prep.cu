// Prep kernel: per (b, t, u) row of the (B, T, U, V) activations, the
// log-softmax denominator and the blank and label log-probs.
//
// Replaces: warp_transducer_tpu/ops/pallas/prep_fused.py:31 (_kernel), the
// TPU's one-read prep, there gated to V >= 512 by the TPU's (8, 128) lane
// tiling. Here it is the prep at every V.
//
// Bound on this card: bytes. Every activation is read once (B·T·U·V
// elements in their own type) and three (B,T,U) fields are written; the
// arithmetic (a compare, a subtract and an exp per element) is far below
// the 67 TFLOP/s float32 rate at 3.35 TB/s.
//
// Design: the tiled row reductions of reduce.cuh. At small V (the
// reference's V = 28 and 50) a row is a few hundred bytes and a warp a row
// spends its time on latency: a lane reads one element, then the warp
// shuffles ten times and one lane divides and loads the label. So a block
// takes a tile of rows, rows·V contiguous elements, with 16-byte loads
// across row boundaries all in flight at once, reduces each row from
// shared memory with a few threads, and a thread a row emits the row's
// outputs, coalesced across the tile, reading x[blank], x[y_u] and the
// extra columns from shared memory. Above reduce.cuh's switch point a
// warp takes a row, by vectors, kUnroll of them a lane in flight. The
// label's row (b, u) comes from two multiply-high divisions by magic
// numbers made on the host. bf16/f16 are read natively and accumulate in
// f32, f64 in f64. With log_probs_input nothing is reduced and the row is
// read only at the columns it emits.
//
// Outputs per row: lpb = x[blank] + d, lpe = x[y_u] + d (NEG at u = U-1 or
// for a label outside [0, V)), denom = d = −logsumexp(x), and, for the K
// extra columns (the big blanks of the multi-blank loss; the JAX package's
// prep.onepass_stats(extra_cols=...)), extras[row, k] = x[cols[k]] + d.
// Every row is computed; the kernel takes no lengths. K has no cap: up to
// 8 columns come by value, unrolled (the instances the main shapes run);
// past 8 the kernels of their own (prep_many_tile_kernel and
// prep_many_warp_kernel raw, prep_many_lp_kernel on log-probs) read the
// columns from a table and emit the extras with the whole block
// (ManyPrepOp). A thread a row looping over K columns had made each row a
// chain: nothing was __restrict__, so a column load could not rise above
// the store before it (K dependent round trips to device memory a row on
// log-probs, where the row is not in shared memory), the table was read
// from device memory in every row, and the K outputs left at a stride of K
// words across a warp. Here the block's rows·K extras are one contiguous
// run that its threads take 16-byte vectors of, each vector's loads in
// flight before its store; raw in a tile whose warps of rows times K are
// few, a thread a row still (many_by_row), its row in shared memory.
#include <cstdint>

#include "reduce.cuh"

namespace {

namespace red = wtt::reduce;

template <typename TIn, typename TAcc>
struct PrepOp {
  using Tin = TIn;
  using Tacc = TAcc;
  const Tin* acts;
  const int* labels;  // (B, U)
  Tacc *lpb, *lpe, *denom, *extras;
  wtt::ExtraCols cols;
  long long rows;
  int T, U, V, blank;
  bool reduce;
  red::Plan plan;
  unsigned u_mul, tu_mul;  // division by U and by T·U
  int u_shr, tu_shr;

  // A row's label and whether it is in the last column (u = U-1).
  struct Stage {
    int lab, last;
  };
  __device__ __forceinline__ Stage stage(int row) const {
    const int bt = red::div_by(row, u_mul, u_shr, U), u = row - bt * U;
    const int b = red::div_by(row, tu_mul, tu_shr, T * U);
    return Stage{labels[b * U + u], u == U - 1};
  }
  template <class Read>
  __device__ __forceinline__ void emit(int row, Tacc d, const Read& x, const Stage& st) const {
    const int lab = st.lab;
    const Tacc xe = (lab >= 0 && lab < V) ? x(lab) : Tacc(wtt::kNeg);
    lpb[row] = x(blank) + d;
    lpe[row] = st.last ? Tacc(wtt::kNeg) : xe + d;
    if (denom != nullptr) denom[row] = d;
#pragma unroll
    for (int k = 0; k < wtt::kMaxExtraCols; ++k)
      if (k < cols.n) extras[(long long)row * cols.n + k] = x(cols.col[k]) + d;
  }
};

// K > kMaxExtraCols extra columns (cols.n = K). Raw activations: the rows'
// own fields by a thread a row, as above; then the block emits its rows' K
// extras as one run (reduce.cuh's kRun): nrows·K contiguous values, each
// thread taking 16-byte vectors of the run, kUnroll of them at once, so
// that all of their values' loads are in flight before its stores (from
// the tile in shared memory, or from device memory in the warp mode),
// before the first boundary and after the last a value a thread. The table
// of columns is read into shared memory once a block, while the block's
// first loads fly (its first kSharedCols entries; a longer one is read from
// device memory past them). On log-probs nothing is reduced and nothing
// goes through reduce.cuh's bodies: prep_many_lp_kernel stages a block's
// rows' labels and the table, has its rows' blank and label values and its
// run's values in flight at once, then stores them, so that a block waits
// for device memory twice. Mirrored by ops/cuda/rows.py (RUN_SHARED_COLS,
// reduce_run_smem).
//
// kByRow: raw in a tile where a thread a row emits its row's K extras
// itself, a column at a time from the table in device memory, after the
// row's fields (many_by_row). The run's extras leave after the block's
// reads, while a row's own thread writes them beside the other blocks'
// reads: on an H100 (scripts/tune_prep.py --many, f32) a thread a row
// was the faster where its warps' steps, the tile's warps of rows times
// K, are few (V = 50 up to K = 12, V = 100 up to 16, V = 200 up to 24),
// the run elsewhere (V = 12 and 28 from K = 9, V = 50 from K = 16, V =
// 100 at K = 24).
constexpr int kSharedCols = 4096;
constexpr int kRowSteps = 40;

inline bool many_by_row(const red::Plan& p, int K) {
  return p.mode == red::kTile && (p.rows + wtt::kWarp - 1) / wtt::kWarp * K <= kRowSteps;
}

template <typename TIn, typename TAcc, bool kByRow = false>
struct ManyPrepOp : PrepOp<TIn, TAcc> {
  using Tin = TIn;
  using Tacc = TAcc;
  using Stage = typename PrepOp<TIn, TAcc>::Stage;
  static constexpr bool kRun = !kByRow;
  static constexpr int kVec = 16 / (int)sizeof(Tacc);  // values a 16-byte store
  static constexpr int kUnroll = 2;                     // vectors a thread has in flight
  const int* table;  // (K,) int32 in device memory
  unsigned k_mul;    // division by K
  int k_shr;

  template <class Read>
  __device__ __forceinline__ void emit(int row, Tacc d, const Read& x, const Stage& st) const {
    const int lab = st.lab;
    const Tacc xe = (lab >= 0 && lab < this->V) ? x(lab) : Tacc(wtt::kNeg);
    this->lpb[row] = x(this->blank) + d;
    this->lpe[row] = st.last ? Tacc(wtt::kNeg) : xe + d;
    if (this->denom != nullptr) this->denom[row] = d;
    if constexpr (kByRow) {
      const int K = this->cols.n;
      Tacc* out = this->extras + (long long)row * K;
      for (int k = 0; k < K; ++k) out[k] = x(__ldg(table + k)) + d;
    }
  }

  size_t run_smem() const {
    return red::round16(sizeof(int) * (size_t)min(this->cols.n, kSharedCols));
  }

  __device__ __forceinline__ void load_table(unsigned char* smem) const {
    int* s_cols = reinterpret_cast<int*>(smem);
    const int kt = min(this->cols.n, kSharedCols);
    for (int k = threadIdx.x; k < kt; k += red::kThreads) s_cols[k] = __ldg(table + k);
  }

  // Value i of the block's run: row i / K, column table[i % K].
  template <class Rows>
  __device__ __forceinline__ Tacc value(int r, int k, const Rows& x, const int* s_cols) const {
    return x(r, k < kSharedCols ? s_cols[k] : __ldg(table + k));
  }

  template <class Rows>
  __device__ __forceinline__ void emit_run(long long row0, int nrows, const Rows& x,
                                           unsigned char* smem) const {
    const int K = this->cols.n, total = nrows * K;
    const int* s_cols = reinterpret_cast<const int*>(smem);
    Tacc* dst = this->extras + row0 * K;
    // Values before dst's first 16-byte boundary, then whole vectors, then
    // fewer than kVec values.
    const int lead = (int)(reinterpret_cast<uintptr_t>(dst) / sizeof(Tacc) % kVec);
    const int head = min(total, (kVec - lead) % kVec);
    const int nv = (total - head) / kVec, tail = head + nv * kVec;
    for (int i = threadIdx.x; i < head; i += red::kThreads) {
      const int r = red::div_by(i, k_mul, k_shr, K);
      dst[i] = value(r, i - r * K, x, s_cols);
    }
    for (int q0 = threadIdx.x; q0 < nv; q0 += kUnroll * red::kThreads) {
      Tacc v[kUnroll][kVec];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {  // every load before any store
        const int q = q0 + u * red::kThreads;
        if (q < nv) {
          const int i = head + q * kVec;
          int r = red::div_by(i, k_mul, k_shr, K), k = i - r * K;
#pragma unroll
          for (int c = 0; c < kVec; ++c) {
            v[u][c] = value(r, k, x, s_cols);
            if (++k == K) {
              k = 0;
              ++r;
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int q = q0 + u * red::kThreads;
        if (q < nv) {
          if constexpr (kVec == 4)
            *reinterpret_cast<float4*>(dst + head + q * kVec) =
                make_float4(v[u][0], v[u][1], v[u][2], v[u][3]);
          else
            *reinterpret_cast<double2*>(dst + head + q * kVec) = make_double2(v[u][0], v[u][1]);
        }
      }
    }
    for (int i = tail + threadIdx.x; i < total; i += red::kThreads) {
      const int r = red::div_by(i, k_mul, k_shr, K);
      dst[i] = value(r, i - r * K, x, s_cols);
    }
  }
};

template <typename Tin, typename Tacc, int VEC>
__global__ void __launch_bounds__(red::kThreads) prep_tile_kernel(const PrepOp<Tin, Tacc> op) {
  red::tile_body<VEC>(op);
}
template <typename Tin, typename Tacc, int VEC>
__global__ void __launch_bounds__(red::kThreads) prep_warp_kernel(const PrepOp<Tin, Tacc> op) {
  red::warp_body<VEC>(op);
}

template <typename Tin, typename Tacc, int VEC, bool kByRow>
__global__ void __launch_bounds__(red::kThreads)
    prep_many_tile_kernel(const ManyPrepOp<Tin, Tacc, kByRow> op) {
  red::tile_body<VEC>(op);
}
template <typename Tin, typename Tacc, int VEC>
__global__ void __launch_bounds__(red::kThreads)
    prep_many_warp_kernel(const ManyPrepOp<Tin, Tacc> op) {
  red::warp_body<VEC>(op);
}

// Log-probs past kMaxExtraCols columns: `per_block` rows a block (the plan's
// tile, or kWarpRows), a thread a row for the rows' own fields.
template <typename Tin, typename Tacc>
__global__ void __launch_bounds__(red::kThreads)
    prep_many_lp_kernel(const ManyPrepOp<Tin, Tacc> op, int per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kRows = red::kMaxTileRows / red::kThreads;
  const long long row0 = (long long)blockIdx.x * per_block;
  const int nrows = (int)min((long long)per_block, op.rows - row0), V = op.V;
  const Tin* x = op.acts + row0 * V;
  typename ManyPrepOp<Tin, Tacc>::Stage st[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = threadIdx.x + i * red::kThreads;
    if (r < nrows) st[i] = op.stage((int)row0 + r);
  }
  op.load_table(smem);
  __syncthreads();
  Tacc xb[kRows], xl[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = threadIdx.x + i * red::kThreads;
    if (r < nrows) {
      const Tin* row = x + (long long)r * V;
      const int lab = st[i].lab;
      xb[i] = static_cast<Tacc>(wtt::to_acc(__ldg(row + op.blank)));
      xl[i] = lab >= 0 && lab < V ? static_cast<Tacc>(wtt::to_acc(__ldg(row + lab)))
                                  : Tacc(wtt::kNeg);
    }
  }
  op.emit_run(row0, nrows,
              [=](int r, int c) {
                return static_cast<Tacc>(wtt::to_acc(__ldg(x + (long long)r * V + c))) + Tacc(0);
              },
              smem);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = threadIdx.x + i * red::kThreads;
    if (r < nrows) {
      op.lpb[row0 + r] = xb[i] + Tacc(0);
      op.lpe[row0 + r] = st[i].last ? Tacc(wtt::kNeg) : xl[i] + Tacc(0);
    }
  }
}

// The instances past kMaxExtraCols columns: raw, the plan's body with the
// run, or in a tile a thread a row (many_by_row); on log-probs,
// prep_many_lp_kernel.
template <typename Tin, typename Tacc>
int launch_many(const PrepOp<Tin, Tacc>& few, const int* table, cudaStream_t stream) {
  constexpr int V16 = 16 / (int)sizeof(Tin);
  if (few.reduce && many_by_row(few.plan, few.cols.n)) {
    ManyPrepOp<Tin, Tacc, true> op;
    static_cast<PrepOp<Tin, Tacc>&>(op) = few;
    op.table = table;
    const auto kernel = few.plan.vec > 1 ? prep_many_tile_kernel<Tin, Tacc, V16, true>
                                         : prep_many_tile_kernel<Tin, Tacc, 1, true>;
    const long long blocks = (few.rows + few.plan.rows - 1) / few.plan.rows;
    kernel<<<(unsigned)blocks, red::kThreads, red::smem_bytes(few.plan, sizeof(Tacc)), stream>>>(
        op);
    return (int)cudaGetLastError();
  }
  ManyPrepOp<Tin, Tacc> op;
  static_cast<PrepOp<Tin, Tacc>&>(op) = few;
  op.table = table;
  red::division_magic((unsigned)few.cols.n, &op.k_mul, &op.k_shr);
  if (!op.reduce) {
    const int per_block = op.plan.mode == red::kTile ? op.plan.rows : red::kWarpRows;
    const long long blocks = (op.rows + per_block - 1) / per_block;
    prep_many_lp_kernel<Tin, Tacc>
        <<<(unsigned)blocks, red::kThreads, op.run_smem(), stream>>>(op, per_block);
    return (int)cudaGetLastError();
  }
  return red::launch(op, prep_many_tile_kernel<Tin, Tacc, 1, false>,
                     prep_many_tile_kernel<Tin, Tacc, V16, false>,
                     prep_many_warp_kernel<Tin, Tacc, 1>, prep_many_warp_kernel<Tin, Tacc, V16>,
                     stream);
}

template <typename Tin, typename Tacc>
int launch(const void* acts, const int* labels, void* lpb, void* lpe, void* denom,
           void* extras, const wtt::ExtraCols& cols, const int* table, long long rows, int T,
           int U, int V, int blank, int log_probs_input, const red::Plan& plan,
           cudaStream_t stream) {
  PrepOp<Tin, Tacc> op;
  op.acts = static_cast<const Tin*>(acts);
  op.labels = labels;
  op.lpb = static_cast<Tacc*>(lpb);
  op.lpe = static_cast<Tacc*>(lpe);
  op.denom = static_cast<Tacc*>(denom);
  op.extras = static_cast<Tacc*>(extras);
  op.cols = cols;
  op.rows = rows;
  op.T = T;
  op.U = U;
  op.V = V;
  op.blank = blank;
  op.reduce = log_probs_input == 0;
  op.plan = plan;
  red::division_magic((unsigned)U, &op.u_mul, &op.u_shr);
  red::division_magic((unsigned)(T * U), &op.tu_mul, &op.tu_shr);
  if (cols.n > wtt::kMaxExtraCols) return launch_many(op, table, stream);
  constexpr int V16 = 16 / (int)sizeof(Tin);
  return red::launch(op, prep_tile_kernel<Tin, Tacc, 1>, prep_tile_kernel<Tin, Tacc, V16>,
                     prep_warp_kernel<Tin, Tacc, 1>, prep_warp_kernel<Tin, Tacc, V16>, stream);
}

int prep(const void* acts, int dtype, const int* labels, void* lpb, void* lpe, void* denom,
         void* extras, const int* extra_cols, int K, const int* table, long long rows, int T,
         int U, int V, int blank, int log_probs_input, const red::Plan& plan, void* stream) {
  if (rows == 0) return 0;
  wtt::ExtraCols cols;
  // Up to kMaxExtraCols columns by value; past that, from the device table.
  const bool cols_ok = K > wtt::kMaxExtraCols
                           ? wtt::cols_inside(extra_cols, K, V) && table != nullptr
                           : wtt::extra_cols(extra_cols, K, V, &cols);
  if (K > wtt::kMaxExtraCols) cols = wtt::many_cols(K);
  // The reductions' row math is 32-bit: every row index below 2^31.
  if (!cols_ok || rows >= (1LL << 31) || !red::plan_ok(plan, V, red::elt_size(dtype)) ||
      (plan.vec > 1 && red::alignment(acts) < 16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case wtt::kF32:
      return launch<float, float>(acts, labels, lpb, lpe, denom, extras, cols, table,
          rows, T, U, V, blank, log_probs_input, plan, s);
    case wtt::kF64:
      return launch<double, double>(acts, labels, lpb, lpe, denom, extras, cols, table,
          rows, T, U, V, blank, log_probs_input, plan, s);
    case wtt::kBF16:
      return launch<__nv_bfloat16, float>(acts, labels, lpb, lpe, denom, extras, cols, table,
          rows, T, U, V, blank, log_probs_input, plan, s);
    case wtt::kF16:
      return launch<__half, float>(acts, labels, lpb, lpe, denom, extras, cols, table,
          rows, T, U, V, blank, log_probs_input, plan, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// acts: (B,T,U,V) of type `dtype`; labels: (B,U) int32 (column U-1 unused);
// lpb, lpe, denom: (B,T,U) f32, or f64 for f64 acts; denom may be null
// (log_probs_input); extras: (B,T,U,K) of the same type for the K columns
// extra_cols (a host array, each inside [0, V); any K); table: the same K
// columns as an int32 array in device memory, read past
// wtt::kMaxExtraCols of them (may be null up to that).
// The plan is reduce.cuh's for V, the type and acts' alignment. Returns
// the launch's cudaError_t.
int wtt_prep(const void* acts, int dtype, const int* labels, void* lpb, void* lpe,
             void* denom, void* extras, const int* extra_cols, int K, const int* table,
             long long rows, int T, int U, int V, int blank, int log_probs_input,
             void* stream) {
  const int elt = red::elt_size(dtype);
  if (elt == 0 || V < 1) return (int)cudaErrorInvalidValue;
  return prep(acts, dtype, labels, lpb, lpe, denom, extras, extra_cols, K, table, rows, T, U, V,
              blank, log_probs_input, red::plan(V, elt, red::alignment(acts)), stream);
}

// wtt_prep with a plan from the caller (seven unsigned, as wtt_reduce_plan
// gives them): both modes at one V, for the card tests and
// scripts/tune_prep.py. A plan outside the bodies' limits is refused.
int wtt_prep_planned(const void* acts, int dtype, const int* labels, void* lpb, void* lpe,
                     void* denom, void* extras, const int* extra_cols, int K,
                     const int* table, long long rows, int T, int U, int V, int blank,
                     int log_probs_input, const unsigned* plan_host, void* stream) {
  const unsigned* h = plan_host;
  red::Plan plan{(int)h[0], (int)h[1], (int)h[2], h[3], (int)h[4], (int)h[5], (int)h[6]};
  red::division_magic((unsigned)V, &plan.mul, &plan.shr);  // not taken from the caller
  return prep(acts, dtype, labels, lpb, lpe, denom, extras, extra_cols, K, table, rows, T, U, V,
              blank, log_probs_input, plan, stream);
}

// reduce.cuh's plan for rows of V elements of `elt` bytes at base
// alignment `align`, into out[7]; the card tests hold it against
// ops/cuda/rows.py::reduce_plan.
void wtt_reduce_plan(int V, int elt, int align, unsigned* out) {
  const red::Plan p = red::plan(V, elt, align);
  const unsigned v[7] = {(unsigned)p.mode, (unsigned)p.rows, (unsigned)p.vec, p.mul,
                         (unsigned)p.shr, (unsigned)p.group, (unsigned)p.stride};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
}

const char* wtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
