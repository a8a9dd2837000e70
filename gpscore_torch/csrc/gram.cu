// ARD-RBF Gram kernels, forward and backward, hand-written for Hopper (sm_90a).
//
// What they replace: gpscore/ops/gram_pallas.py::_gram_kernel (the fused Pallas
// Gram tile that _pallas_gram_scaled launches) and ::_bwd (its custom-VJP
// backward, gram_pallas.py:116-133). As there, the inputs arrive pre-scaled by
// the inverse lengthscale (gpscore_torch/ops/gram_cuda.py), so one kernel
// serves the ARD and the isotropic parameterization:
//
//     K_ij = sig * exp(-1/2 sum_k (xs_ik - xps_jk)^2)
//
// Common to all three:
// - Direct-difference form, not the cross-term 2 x.x' - |x|^2 - |x'|^2. With
//   d <= 64 it costs the same FMAs without tensor cores (so there is no TF32
//   question: the port computes in IEEE fp32, and wgmma has no IEEE fp32
//   mode), it has no cancellation, and it gives an exactly symmetric K(u, u)
//   and an exact sig diagonal: every d2 is summed with fmaf in ascending k.
// - The backward keeps K and W = g * K out of device memory: it recomputes K,
//   forms W on the fly and reduces in a fixed order, so the result is
//   bitwise the same from run to run. No float is ever added atomically.
// - Each kernel has its own note on what bounds it and what its design does
//   about it. The grids come from the wrappers' plans (ops/gram_cuda.py:
//   fwd_plan, bwd_rows_plan, bwd_cols_plan), which size them from the card's
//   SM count; every call is one launch.
//
// All arrays are row-major, contiguous fp32 (gram_fwd's output may also be
// bfloat16 or float16); sig is a device scalar, so no launch needs a host
// sync. Every entry point launches on the caller's stream and returns
// cudaGetLastError().
//
// The batch axis (a sweep's restarts or replicates; gpscore_torch/parallel/
// sweeps.py): every kernel takes B independent Grams in one launch, the batch
// on blockIdx.z (at most 65,535), and each array its batch stride in
// elements (struct Batch; 0 for an input that every batch shares). Each
// kernel has a batched instantiation (kBatched), launched for B > 1, whose
// blocks offset their pointers by blockIdx.z times the strides and then run
// the unbatched code unchanged; B = 1 launches the unbatched one, whose code
// is the kernel's without a batch axis (the offsets, though zero, cost the
// fp32 forward 5% at 8192^2 and the column kernel 20% at 9700 x 20 x 8 on an
// NVIDIA H100 80GB HBM3 at 700 W, measured beside the unbatched build in one
// call). So batch b's output is bitwise what an unbatched launch on b's
// inputs writes under the same plan (K under any plan; the
// backward's sums follow the plan's tiling, which counts every batch's tiles
// when it fills the card, ops/gram_cuda.py). Tickets and scratch are per
// (batch, tile): batch b's tickets follow its gridDim.x row or column tiles,
// its scratch its gridDim.y chunks, so no two batches share either, and the
// last block of every (batch, tile) sets its own ticket back to 0.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMaxD = 64;
constexpr int kWarpsPerBlock = 8;                // every kernel: 8 warps a block
constexpr int kThreads = 32 * kWarpsPerBlock;
constexpr int kColsTile = 32;                    // gram_bwd_cols: columns per block, one per lane
constexpr int kColsStageRows = 64;               // gram_bwd_cols: rows per shared-memory stage
constexpr int kSumBatch = 32;                    // both backward kernels: chunk partials loaded at once
constexpr int kFwdColsPerThread = 4;             // gram_fwd: one float4 of a row per thread
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Batch strides in elements, one per array (0: the array is shared by every
// batch). out0 and out1 are the kernel's outputs in its argument order
// (gram_fwd: K; gram_bwd_rows: d_xs, rowsum; gram_bwd_cols: d_xps).
struct Batch {
  long long xs, xps, sig, g, out0, out1;
};

// Copy count contiguous floats to shared memory, every thread of the block
// taking a share; dst is 16-byte aligned.
__device__ __forceinline__ void stage_span(float* dst, const float* src, int count) {
  int e = threadIdx.x;
  if (aligned16(src)) {
    for (int v = threadIdx.x; v < count / 4; v += kThreads) cp_async16(dst + 4 * v, src + 4 * v);
    e += count & ~3;
  }
  for (; e < count; e += kThreads) cp_async4(dst + e, src + e);
}

// Copy the g tile rows [i0, i0 + rows) x columns [j0, j0 + w) to dst with row
// pitch kColsTile. With m % 4 == 0 every row starts 16-byte aligned (j0 is a
// multiple of 4) and w is a multiple of 4.
__device__ __forceinline__ void stage_g(float* dst, const float* g, int i0, int rows, int j0,
                                        int w, int m) {
  const float* src = g + (size_t)i0 * m + j0;
  if ((m & 3) == 0 && aligned16(src)) {
    const int per_row = w / 4;
    for (int v = threadIdx.x; v < rows * per_row; v += kThreads) {
      const int r = v / per_row;
      const int c = 4 * (v - r * per_row);
      cp_async16(dst + r * kColsTile + c, src + (size_t)r * m + c);
    }
  } else {
    for (int e = threadIdx.x; e < rows * w; e += kThreads) {
      const int r = e / w;
      const int c = e - r * w;
      cp_async4(dst + r * kColsTile + c, src + (size_t)r * m + c);
    }
  }
}

// Copy a tile of `rows` rows x `cols` floats (row pitches src_pitch and
// dst_pitch) to shared memory through L1 (cp.async.ca): 16 bytes a copy when
// vec (cols, both pitches and both bases 16-byte aligned), 4 otherwise. Every
// block of a row tile of gram_bwd_rows reads the same xps rows; through L1
// the blocks that share an SM fetch them from L2 once (with cp.async.cg,
// which bypasses L1, 500 x 500 x 8 took 8.2 us instead of 5.2).
__device__ __forceinline__ void stage_tile(float* dst, int dst_pitch, const float* src,
                                           size_t src_pitch, int rows, int cols, bool vec) {
  if (vec) {
    const int per_row = cols / 4;
    for (int v = threadIdx.x; v < rows * per_row; v += kThreads) {
      const int r = v / per_row;
      const int c = 4 * (v - r * per_row);
      const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(dst + r * dst_pitch + c));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(sa),
                   "l"(src + r * src_pitch + c) : "memory");
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += kThreads) {
      const int r = e / cols;
      const int c = e - r * cols;
      cp_async4(dst + r * dst_pitch + c, src + r * src_pitch + c);
    }
  }
}

// ---- gram_fwd ----------------------------------------------------------------
//
// K_ij = sig * exp(-1/2 |xs_i - xps_j|^2): gram_pallas.py:_gram_kernel (:40-53).
//
// What bounds it on this card: the n * m * 4 bytes it writes, each once. At
// 8192 x 8192 x 8 that is 268 MB, 80 us at 3.35 TB/s, against ~1.8 GFLOP
// (3d + 3 per output, 27 us at 67 TFLOP/s fp32). At the main path's shapes
// (500 x 20, 20 x 20, 500 x 500, 9700 x 20) a call writes 1.6 KB to 1 MB,
// under a microsecond at that rate, so it is bound by the launch.
//
// What the design does about it:
// - A block of 256 threads is col_threads x (256 / col_threads); a thread owns
//   four neighbouring columns and RT rows (rows ty, ty + 256 / col_threads,
//   ...), so it keeps 4 * RT sums of squares in registers and writes each
//   row's four outputs as one 16-byte store when m % 4 == 0 (scalar stores
//   masked at the ragged edge otherwise). Neighbouring threads write
//   neighbouring 16 bytes: the stores coalesce. At 8192 x 8192 a block writes
//   32 rows x 256 columns, 32 KB.
// - The plan (ops/gram_cuda.py::fwd_plan) takes the narrowest column tile
//   that covers m (so m = 20 leaves 3 of 8 column threads idle, not 12 of 32
//   lanes), and the most rows per thread that still leaves two blocks per SM:
//   RT = 8 where the output is megabytes, RT = 1 at the main path's shapes.
// - The block's xs rows (contiguous, 16-byte cp.async) and its xps columns,
//   transposed to [k][column] (one 4-byte cp.async per value, thread j taking
//   column j, no division) are staged in shared memory. The k loop reads one
//   float4 of xps (four columns, conflict-free) and RT xs values, which every
//   lane of a warp reads at one address (a broadcast), and does 8 * RT FP
//   operations with them.
// - Summed over k in ascending order with fmaf of (xs - xps): the same k
//   order and operand order as before, so K(u, u) stays exactly symmetric
//   with an exact diagonal.
//
// What bounds it now (H100 SXM, 700 W, chip_smoke.py phase 3): at 8192 x 8192
// x 8 the bytes, 97 us against the 80 us bound (the first version took 295);
// at the main path's shapes the launch, 1.6-2.7 us of device time.
//
// The output type OutT is float, or a 2-byte storage type (__nv_bfloat16,
// __half) for the large-n cores' reduced-precision modes, where K_hat is
// written straight into the 2-byte n x n buffer (the semantics of the JAX
// package's _gram_khat_full, potri_inplace.py:274-290: an fp32 Gram, the noise
// added, rounded once to the storage type). Each value is computed in fp32 as
// for the float output, diag (a device scalar; null for none) is added with
// one IEEE fp32 add where the global row equals the global column, and the
// sum is rounded once to nearest. The four outputs of a row go out as one
// store of 4 * sizeof(OutT) bytes where aligned: 16 bytes for float, 8 for
// the 2-byte types. The output bytes halve, so does the bound at 30720^2.
template <typename OutT>
struct Out4;

template <>
struct Out4<float> {
  static constexpr bool kDiag = false;  // an fp32 K takes its diagonal after the launch
  __device__ __forceinline__ static float one(float v) { return v; }
  __device__ __forceinline__ static void store(float* o, const float* v) {
    *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Out4<__nv_bfloat16> {
  static constexpr bool kDiag = true;
  __device__ __forceinline__ static __nv_bfloat16 one(float v) { return __float2bfloat16_rn(v); }
  __device__ __forceinline__ static void store(__nv_bfloat16* o, const float* v) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 u;
    u.x = *reinterpret_cast<unsigned*>(&lo);
    u.y = *reinterpret_cast<unsigned*>(&hi);
    *reinterpret_cast<uint2*>(o) = u;
  }
};

template <>
struct Out4<__half> {
  static constexpr bool kDiag = true;
  __device__ __forceinline__ static __half one(float v) { return __float2half_rn(v); }
  __device__ __forceinline__ static void store(__half* o, const float* v) {
    __half2 lo = __floats2half2_rn(v[0], v[1]);
    __half2 hi = __floats2half2_rn(v[2], v[3]);
    uint2 u;
    u.x = *reinterpret_cast<unsigned*>(&lo);
    u.y = *reinterpret_cast<unsigned*>(&hi);
    *reinterpret_cast<uint2*>(o) = u;
  }
};

template <int RT, typename OutT, bool kBatched>
__global__ void __launch_bounds__(kThreads)
gram_fwd_kernel(const float* __restrict__ xs, const float* __restrict__ xps,
                const float* __restrict__ sig, const float* __restrict__ diag,
                OutT* __restrict__ out, int n, int m, int d, int col_threads, Batch bs) {
  extern __shared__ __align__(16) float smem[];
  if constexpr (kBatched) {
    const long long b = blockIdx.z;
    xs += b * bs.xs;
    xps += b * bs.xps;
    sig += b * bs.sig;
    out += b * bs.out0;
  }
  const int row_groups = kThreads / col_threads;
  const int rows_tile = row_groups * RT;
  const int col_tile = kFwdColsPerThread * col_threads;
  const int i0 = blockIdx.y * rows_tile;
  const int j0 = blockIdx.x * col_tile;
  const int rows = min(rows_tile, n - i0);
  const int w = min(col_tile, m - j0);
  float* xs_s = smem;                      // [rows_tile][d]
  float* xpt_s = smem + rows_tile * d;     // [d][col_tile]: xps transposed
  stage_span(xs_s, xs + (size_t)i0 * d, rows * d);
  if (threadIdx.x < w) {
    const float* src = xps + (size_t)(j0 + threadIdx.x) * d;
    for (int k = 0; k < d; ++k) cp_async4(xpt_s + k * col_tile + threadIdx.x, src + k);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int tx = threadIdx.x & (col_threads - 1);  // col_threads is a power of two
  const int ty = threadIdx.x >> (__ffs(col_threads) - 1);
  const int c = kFwdColsPerThread * tx;
  if (c >= w) return;
  float d2[RT][kFwdColsPerThread];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
#pragma unroll
    for (int q = 0; q < kFwdColsPerThread; ++q) d2[r][q] = 0.f;
  }
  // Columns of the tile past w and rows past `rows` read shared memory that
  // was not filled; their sums are never stored.
  for (int k = 0; k < d; ++k) {
    const float4 xp = *reinterpret_cast<const float4*>(xpt_s + k * col_tile + c);
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const float xi = xs_s[(ty + r * row_groups) * d + k];
      float t = xi - xp.x;
      d2[r][0] = fmaf(t, t, d2[r][0]);
      t = xi - xp.y;
      d2[r][1] = fmaf(t, t, d2[r][1]);
      t = xi - xp.z;
      d2[r][2] = fmaf(t, t, d2[r][2]);
      t = xi - xp.w;
      d2[r][3] = fmaf(t, t, d2[r][3]);
    }
  }
  const float s = *sig;
  const bool vec = (m & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & (kFwdColsPerThread * sizeof(OutT) - 1)) == 0;
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int ri = ty + r * row_groups;
    if (ri >= rows) break;
    float v[kFwdColsPerThread];
#pragma unroll
    for (int q = 0; q < kFwdColsPerThread; ++q) v[q] = s * expf(-0.5f * d2[r][q]);
    if constexpr (Out4<OutT>::kDiag) {
      if (diag != nullptr) {
        const int q = i0 + ri - (j0 + c);  // the column of this row's diagonal, if it is ours
        if (q >= 0 && q < kFwdColsPerThread) {
#pragma unroll
          for (int u = 0; u < kFwdColsPerThread; ++u) {
            if (u == q) v[u] = __fadd_rn(v[u], *diag);
          }
        }
      }
    }
    OutT* o = out + (size_t)(i0 + ri) * m + j0 + c;
    if (vec) {  // then w % 4 == 0, so all four columns are in the tile
      Out4<OutT>::store(o, v);
    } else {
#pragma unroll
      for (int q = 0; q < kFwdColsPerThread; ++q) {
        if (c + q < w) o[q] = Out4<OutT>::one(v[q]);
      }
    }
  }
}

__host__ __device__ constexpr int fwd_smem_floats(int rows_tile, int col_tile, int d) {
  return (rows_tile + col_tile) * d;
}

// ---- gram_bwd_rows -------------------------------------------------------------
//
// d_xs_i = sum_j W_ij (xps_j - xs_i) and rowsum_i = sum_j W_ij, W = g * K
// recomputed, never stored: the row half of gram_pallas.py:_bwd (d_xs =
// W xps - rowsum(W) xs and the rowsum that d_log_sig sums, :116-125).
//
// What bounded the first version (one warp per row, walking all m columns):
// at the exact K_ff (500 x 500 x 8) that was 63 blocks on 132 SMs, each warp
// making 16 dependent trips whose g and xps loads went to global memory with
// nothing in flight: 10.8 us of device time for 1.05 MB, bound by memory
// latency on too few warps (the bytes take 0.31 us at 3.35 TB/s).
//
// What this one does about it:
// - A 2-D grid, row tiles x column chunks. L lanes share a row, neighbouring
//   lanes on neighbouring columns, so a warp holds 32 / L rows; the block's
//   8 warps split the columns into `slices`, and a thread takes columns
//   slice * L + lane % L + t * L * slices. The plan (ops/gram_cuda.py::
//   bwd_rows_plan) sizes L * slices so that the row tiles fill the card:
//   500 x 500: 16 lanes x 8 slices, 2 rows a block, 250 blocks; 9700 x 20:
//   4 lanes, 64 rows a block, 152 blocks. It cuts the columns into chunks
//   only where the row tiles leave SMs idle and a chunk still has thousands
//   of columns (20 x 8192: 5 chunks), so every call of the main path is one
//   chunk and its blocks write d_xs and rowsum directly, with no scratch.
// - The block's xs rows, and each column stage's xps rows and g tile, are
//   copied to shared memory with cp.async.ca (stage_tile), all in flight
//   together; 16-byte copies where alignment allows. A block that walks several stages
//   double-buffers them. At the main path's shapes a chunk is one stage: one
//   load round trip, then arithmetic on shared memory. No read conflicts:
//   g rows at a pitch of L mod 32 (the warp's 32 / L rows x L columns hit 32
//   banks), xps and xs rows at an odd number of float4s (read 16 bytes at
//   a time) or of floats.
// - Reduction in a fixed order: a thread over its columns in order, the L
//   lanes of a row in a butterfly of log2(L) shuffle levels, the slices in
//   slice order through shared memory. With several chunks each block writes
//   its rows' partials to scratch[chunk, n, d + 1]; the last block of a row
//   tile to finish, elected by an int ticket that it sets back to 0, sums
//   them in chunk order. No float is added atomically, the result is bitwise
//   the same from run to run, and a call is one launch at every shape.
// - __launch_bounds__ asks for 2 blocks an SM at d <= 16 and 1 above: no
//   bucket spills (a thread holds 3 * DMAX floats: the sums, the column's xps
//   row and, at d <= 16, its row's xs). With 4 at d <= 8, ptxas capped the
//   kernel at 64 registers and 9700 x 20 x 8 took 3.9-4.3 us instead of 3.65.
//
// What bounds it now (H100 SXM, 700 W; device time per call, bench_gram.py):
// at the main path's shapes the launch, the staged round trip (cp.async,
// wait, barrier) and, with slices, two more barriers: 2.9 us at 20 x 20 and
// 500 x 20, 4.8 us at 500 x 500 (10.8 before), 3.7-3.9 us at 9700 x 20 (7.6
// before). A first version that staged xps with cp.async.cg (L2 only) took
// 8.2 us at 500 x 500, every block pulling the same 16 KB. At 8192 x 8192 x
// 8, 254 us (1,000-1,090 before) against 80 us of bytes: the dependent
// per-element chains (d2, exp, sums) on 16 warps an SM.

// Pitch of a staged xps row: an odd number of float4s when rows are copied
// and read 16 bytes at a time, an odd number of floats otherwise.
__host__ __device__ constexpr int rows_xps_pitch(int d, bool vec) {
  return vec ? (((d + 3) / 4) | 1) * 4 : (d | 1);
}

__host__ __device__ constexpr int round4(int v) { return (v + 3) & ~3; }

// Shared memory of gram_bwd_rows, in floats: the block's xs rows, then
// `buffers` stages of (xps rows, g tile), or, after the column loop, the
// slices' partials in their place.
struct RowsSmem {
  int xs_pitch, xps_pitch, g_pitch;  // row pitches
  int xs, xps, stage, total;         // region sizes
};

__host__ __device__ inline RowsSmem rows_smem(int d, int rows_tile, int lanes, int slices,
                                             int stage_cols, int buffers, bool vec) {
  RowsSmem s;
  s.xs_pitch = rows_xps_pitch(d, (d & 3) == 0);
  s.xps_pitch = rows_xps_pitch(d, vec);
  s.g_pitch = stage_cols + (lanes < 32 ? lanes : 0);
  s.xs = round4(rows_tile * s.xs_pitch);
  s.xps = round4(stage_cols * s.xps_pitch);
  s.stage = s.xps + round4(rows_tile * s.g_pitch);
  const int part = slices > 1 ? slices * rows_tile * (d + 1) : 0;
  s.total = s.xs + (buffers * s.stage > part ? buffers * s.stage : part);
  return s;
}

template <int DMAX, bool kBatched>
__global__ void __launch_bounds__(kThreads, DMAX <= 16 ? 2 : 1)
gram_bwd_rows_kernel(const float* __restrict__ xs, const float* __restrict__ xps,
                     const float* __restrict__ sig, const float* __restrict__ g,
                     float* __restrict__ d_xs, float* __restrict__ rowsum,
                     float* __restrict__ scratch, int* __restrict__ ticket,
                     int n, int m, int d, int lanes_per_row, int slices, int stage_cols,
                     int chunk_cols, Batch bs) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int is_last;
  bool vec_base = true;
  if constexpr (kBatched) {
    // Decided on the batch's base pointer, as the launch sizes shared memory.
    vec_base = aligned16(xps) && (bs.xps & 3) == 0;
    const long long b = blockIdx.z;
    xs += b * bs.xs;
    xps += b * bs.xps;
    sig += b * bs.sig;
    g += b * bs.g;
    d_xs += b * bs.out0;
    rowsum += b * bs.out1;
    scratch += b * gridDim.y * (long long)n * (d + 1);
    ticket += b * gridDim.x;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int log_l = __ffs(lanes_per_row) - 1;  // both counts are powers of two
  const int log_s = __ffs(slices) - 1;
  const int rows_tile = kThreads >> (log_l + log_s);
  const int i0 = blockIdx.x * rows_tile;
  const int rows = min(rows_tile, n - i0);
  const int sl = warp & (slices - 1);
  const int r = ((warp >> log_s) << (5 - log_l)) + (lane >> log_l);  // this lane's row, in the block
  const int cl = lane & (lanes_per_row - 1);
  const bool row_ok = r < rows;
  const int chunk = blockIdx.y;
  const int col0 = chunk * chunk_cols;
  const int col_end = min(m, col0 + chunk_cols);
  const int stages = (max(col_end - col0, 0) + stage_cols - 1) / stage_cols;
  const bool vec = (d & 3) == 0 && (kBatched ? vec_base : aligned16(xps));
  const RowsSmem lay = rows_smem(d, rows_tile, lanes_per_row, slices, stage_cols,
                                 chunk_cols > stage_cols ? 2 : 1, vec);
  // With m and stage_cols multiples of 4, every stage's g rows start 16-byte
  // aligned and are a multiple of 4 wide.
  const bool g_vec = (m & 3) == 0 && (stage_cols & 3) == 0 && (lay.g_pitch & 3) == 0 &&
                     aligned16(g);
  float* xs_s = smem;                  // [rows_tile][xs_pitch]
  float* stage_s = smem + lay.xs;      // buffers x ([stage_cols][xps_pitch], [rows_tile][g_pitch])
  float* part_s = stage_s;             // [slices][rows_tile][d + 1], after the column loop
  // Loaded before the copies are issued: the asm of cp.async orders every
  // later load after it, and this one would wait out a round trip of its own.
  const float s = *sig;

  const auto load_stage = [&](int st) {
    const int j0 = col0 + st * stage_cols;
    const int w = min(stage_cols, col_end - j0);
    float* buf = stage_s + (st & 1) * lay.stage;
    stage_tile(buf, lay.xps_pitch, xps + (size_t)j0 * d, d, w, d, vec);
    stage_tile(buf + lay.xps, lay.g_pitch, g + (size_t)i0 * m + j0, m, rows, w, g_vec);
  };
  stage_tile(xs_s, lay.xs_pitch, xs + (size_t)i0 * d, d, rows, d, (d & 3) == 0 && aligned16(xs));
  if (stages > 0) load_stage(0);
  cp_async_commit();

  constexpr bool kXsInRegisters = DMAX <= 16;
  float xi_r[kXsInRegisters ? DMAX : 1];
  // Rows past `rows` read shared memory that was not filled, with g taken
  // as 0; their sums are never stored.
  const float* xi_s = xs_s + r * lay.xs_pitch;  // the L lanes of a row read one address
  const auto xi = [&](int k) {
    if constexpr (kXsInRegisters) return xi_r[k];
    else return xi_s[k];
  };
  const int step = lanes_per_row * slices;
  float acc[DMAX];
  float rs = 0.f;
#pragma unroll
  for (int k = 0; k < DMAX; ++k) acc[k] = 0.f;
  for (int st = 0; st < stages; ++st) {
    if (st + 1 < stages) {
      load_stage(st + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (kXsInRegisters) {
      if (st == 0) {
#pragma unroll
        for (int k = 0; k < DMAX; ++k) xi_r[k] = k < d ? xi_s[k] : 0.f;
      }
    }
    const float* xb = stage_s + (st & 1) * lay.stage;
    const float* gb = xb + lay.xps + r * lay.g_pitch;
    const int w = min(stage_cols, col_end - (col0 + st * stage_cols));
    for (int j = sl * lanes_per_row + cl; j < w; j += step) {
      const float* xp = xb + j * lay.xps_pitch;
      float xj[DMAX];
      if (vec) {
#pragma unroll
        for (int k = 0; k < DMAX; k += 4) {
          if (k < d) {
            const float4 v = *reinterpret_cast<const float4*>(xp + k);
            xj[k] = v.x;
            xj[k + 1] = v.y;
            xj[k + 2] = v.z;
            xj[k + 3] = v.w;
          }
        }
      } else {
#pragma unroll
        for (int k = 0; k < DMAX; ++k) xj[k] = k < d ? xp[k] : 0.f;
      }
      const float gj = row_ok ? gb[j] : 0.f;
      float d2 = 0.f;
#pragma unroll
      for (int k = 0; k < DMAX; ++k) {
        if (k < d) {
          const float t = xi(k) - xj[k];  // same operand order as the forward
          d2 = fmaf(t, t, d2);
        }
      }
      const float wv = gj * (s * expf(-0.5f * d2));
      rs += wv;
#pragma unroll
      for (int k = 0; k < DMAX; ++k) {
        if (k < d) acc[k] = fmaf(wv, xj[k] - xi(k), acc[k]);
      }
    }
    if (st + 1 < stages) __syncthreads();  // the next iteration refills the buffer just read
  }
  cp_async_wait<0>();  // with no stage (m == 0) the xs copy is still in flight

  // The L lanes of a row: a butterfly inside the lane group.
  for (int off = lanes_per_row >> 1; off > 0; off >>= 1) {
    rs += __shfl_xor_sync(kFullMask, rs, off);
#pragma unroll
    for (int k = 0; k < DMAX; ++k) {
      if (k < d) acc[k] += __shfl_xor_sync(kFullMask, acc[k], off);
    }
  }

  // This block's sums of its rows over the chunk: d_xs and rowsum with one
  // chunk, else this chunk's slot of scratch.
  const int width = d + 1;
  const bool one_chunk = gridDim.y == 1;
  const auto emit = [&](int row, int k, float v) {
    const int i = i0 + row;
    if (!one_chunk) scratch[((size_t)chunk * n + i) * width + k] = v;
    else if (k < d) d_xs[(size_t)i * d + k] = v;
    else rowsum[i] = v;
  };
  if (slices == 1) {
    if (cl == 0 && row_ok) {
#pragma unroll
      for (int k = 0; k < DMAX; ++k) {
        if (k < d) emit(r, k, acc[k]);
      }
      emit(r, d, rs);
    }
  } else {
    // The slices' sums through shared memory (over the stage buffers, once
    // every thread is done with them), added in slice order.
    __syncthreads();
    if (cl == 0) {
      float* p = part_s + (sl * rows_tile + r) * width;
#pragma unroll
      for (int k = 0; k < DMAX; ++k) {
        if (k < d) p[k] = acc[k];
      }
      p[d] = rs;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < rows * width; e += kThreads) {
      float v = part_s[e];
      for (int q = 1; q < slices; ++q) v += part_s[q * rows_tile * width + e];
      const int row = e / width;
      emit(row, e - row * width, v);
    }
  }
  if (one_chunk) return;

  // Grid level: the last block of this row tile sums the chunks in order.
  __threadfence();  // this block's scratch writes are visible before its ticket
  __syncthreads();
  if (threadIdx.x == 0) {
    is_last = atomicAdd(ticket + blockIdx.x, 1) == static_cast<int>(gridDim.y) - 1;
    if (is_last) ticket[blockIdx.x] = 0;  // every block of the tile has drawn
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const float* parts = scratch + (size_t)i0 * width;
  const size_t chunk_stride = (size_t)n * width;
  const int n_chunks = gridDim.y;
  for (int e = threadIdx.x; e < rows * width; e += kThreads) {
    // As in gram_bwd_cols: loads in batches, adds in chunk order, from L2.
    float v = 0.f;
    for (int q0 = 0; q0 < n_chunks; q0 += kSumBatch) {
      float batch[kSumBatch];
#pragma unroll
      for (int u = 0; u < kSumBatch; ++u) {
        batch[u] = q0 + u < n_chunks ? __ldcg(parts + (q0 + u) * chunk_stride + e) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kSumBatch; ++u) {
        if (q0 + u < n_chunks) v += batch[u];
      }
    }
    const int row = e / width;
    const int k = e - row * width;
    if (k < d) d_xs[(size_t)(i0 + row) * d + k] = v;
    else rowsum[i0 + row] = v;
  }
}

// ---- gram_bwd_cols -----------------------------------------------------------
//
// d_xps_j = sum_i W_ij (xs_i - xps_j), W = g * K recomputed, never stored: the
// column half of gram_pallas.py:_bwd (d_xps = W^T xs - colsum(W) xps, :124-126).
//
// What bounded the first version (one warp per column, walking all n rows):
// at the FITC Gram K_fu of the 9700-row pool (n x m x d = 9700 x 20 x 8) that is
// 20 warps on 3 of the 132 SMs, each making 304 dependent trips of a loop
// whose g loads touch 32 sectors for 128 useful bytes. It moved ~1.1 MB in
// 0.18 ms: bound by memory latency on too few warps, not by bandwidth
// (~0.3 us at 3.35 TB/s) or FLOPs (~6 MFLOP).
//
// What this one does about it:
// - A 2-D grid, column tiles x row chunks. A block takes kColsTile columns
//   (lane = column) and chunk_rows rows (a multiple of kColsStageRows); its 8
//   warps split each stage's rows. The wrapper's plan (ops/gram_cuda.py
//   bwd_cols_plan) picks the chunk so that a tall-skinny call fills the card:
//   152 blocks at 9700 x 20, one block per 64 rows.
// - Each stage's g tile (rows x columns, neighbouring lanes on neighbouring
//   columns) and xs rows, and the block's xps rows, are copied to shared memory
//   with cp.async: 16-byte copies where the pitch and alignment allow, 4-byte
//   ones otherwise. A block that walks several stages double-buffers them.
// - Two-level reduction in a fixed order. In a block, each thread sums its
//   rows in order, then the 8 warps' partials are added in warp order through
//   shared memory. Across chunks, each block writes its partial to
//   scratch[chunk, m, d]; the last block of a column tile to finish sums the
//   chunks in chunk order into d_xps. So the result does not depend on which
//   block finishes when: it is bitwise the same from run to run.
// - "Last to finish" is decided by an integer ticket per column tile: each
//   block fences its scratch writes and takes a ticket with an int atomicAdd;
//   the block that draws n_chunks - 1 does the final sum and sets the ticket
//   back to 0 for the next launch. That int atomic is the only atomic; no
//   float is ever added atomically. With one chunk (the 20 x 20 K_uu) the
//   block writes d_xps directly and neither scratch nor ticket is touched.
//   Either way a call is one launch.
// - No tensor cores: W^T xs has depth n and width d <= 64, the port computes
//   in IEEE fp32 ("highest"), and wgmma has no IEEE fp32 mode. The kernel is
//   bound by latency and parallelism, not FLOPs.
//
// What bounds it now (H100 SXM, 700 W, torch.profiler): ~10 us of device time
// at 9700 x 20 x 8, half of it the last block's sum over the 152 partials,
// which only starts when every block has written its own; a block that walks
// several stages takes ~2 us a stage, one cp.async round trip each.

// Shared memory of gram_bwd_cols, in floats: the block's xps rows, then either
// two stages (g tile and xs rows each) or, after the row loop, the 8 warps'
// partials with an odd row pitch (bank-conflict free stores).
__host__ __device__ constexpr int bwd_cols_smem_floats(int d) {
  return kColsTile * d + (2 * kColsStageRows * (kColsTile + d) > kWarpsPerBlock * kColsTile * (d | 1)
                              ? 2 * kColsStageRows * (kColsTile + d)
                              : kWarpsPerBlock * kColsTile * (d | 1));
}

// minBlocksPerSM = 1: without it ptxas aims at 64 registers and spills at
// d <= 8; the grids here put one or two blocks on an SM.
template <int DMAX, bool kBatched>
__global__ void __launch_bounds__(kThreads, 1)
gram_bwd_cols_kernel(const float* __restrict__ xs, const float* __restrict__ xps,
                     const float* __restrict__ sig, const float* __restrict__ g,
                     float* __restrict__ d_xps, float* __restrict__ scratch,
                     int* __restrict__ ticket, int n, int m, int d, int chunk_rows, Batch bs) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int is_last;
  if constexpr (kBatched) {
    const long long b = blockIdx.z;
    xs += b * bs.xs;
    xps += b * bs.xps;
    sig += b * bs.sig;
    g += b * bs.g;
    d_xps += b * bs.out0;
    scratch += b * gridDim.y * (long long)m * d;
    ticket += b * gridDim.x;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int j0 = blockIdx.x * kColsTile;
  const int w = min(kColsTile, m - j0);
  const int chunk = blockIdx.y;
  const int row0 = chunk * chunk_rows;
  const int row_end = min(n, row0 + chunk_rows);
  const int stages = (max(row_end - row0, 0) + kColsStageRows - 1) / kColsStageRows;

  float* xps_s = smem;                                  // [w][d]
  float* g_s = smem + kColsTile * d;                    // 2 x [kColsStageRows][kColsTile]
  float* xs_s = g_s + 2 * kColsStageRows * kColsTile;   // 2 x [kColsStageRows][d]
  float* part_s = g_s;                                  // [8][kColsTile][d | 1], after the loop

  const auto load_stage = [&](int st) {
    const int i0 = row0 + st * kColsStageRows;
    const int rows = min(kColsStageRows, row_end - i0);
    const int buf = st & 1;
    stage_g(g_s + buf * kColsStageRows * kColsTile, g, i0, rows, j0, w, m);
    stage_span(xs_s + buf * kColsStageRows * d, xs + (size_t)i0 * d, rows * d);
  };
  stage_span(xps_s, xps + (size_t)j0 * d, w * d);
  if (stages > 0) load_stage(0);
  cp_async_commit();

  const bool has_col = lane < w;
  const float s = *sig;
  float xj[DMAX];
  float acc[DMAX];
#pragma unroll
  for (int k = 0; k < DMAX; ++k) acc[k] = 0.f;
  for (int st = 0; st < stages; ++st) {
    if (st + 1 < stages) {
      load_stage(st + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (st == 0) {
#pragma unroll
      for (int k = 0; k < DMAX; ++k) xj[k] = (has_col && k < d) ? xps_s[lane * d + k] : 0.f;
    }
    const float* gb = g_s + (st & 1) * kColsStageRows * kColsTile;
    const float* xb = xs_s + (st & 1) * kColsStageRows * d;
    const int rows = min(kColsStageRows, row_end - (row0 + st * kColsStageRows));
    if (has_col) {
      for (int r = warp; r < rows; r += kWarpsPerBlock) {
        const float* xi = xb + r * d;  // one address for the whole warp: a broadcast
        float d2 = 0.f;
#pragma unroll
        for (int k = 0; k < DMAX; ++k) {
          if (k < d) {
            const float t = xi[k] - xj[k];  // same operand order as the forward
            d2 = fmaf(t, t, d2);
          }
        }
        const float wv = gb[r * kColsTile + lane] * (s * expf(-0.5f * d2));
#pragma unroll
        for (int k = 0; k < DMAX; ++k) {
          if (k < d) acc[k] = fmaf(wv, xi[k] - xj[k], acc[k]);
        }
      }
    }
    __syncthreads();  // the next iteration refills the buffer just read
  }
  cp_async_wait<0>();  // with no stage (n == 0) the xps copy is still in flight
  __syncthreads();

  // Block level: the 8 warps' partials, added in warp order.
  const int pitch = d | 1;
  if (has_col) {
#pragma unroll
    for (int k = 0; k < DMAX; ++k) {
      if (k < d) part_s[(warp * kColsTile + lane) * pitch + k] = acc[k];
    }
  }
  __syncthreads();
  const bool one_chunk = gridDim.y == 1;
  float* out = one_chunk ? d_xps + (size_t)j0 * d : scratch + ((size_t)chunk * m + j0) * d;
  for (int e = threadIdx.x; e < w * d; e += kThreads) {
    const int j = e / d;
    const int k = e - j * d;
    float p = part_s[j * pitch + k];
#pragma unroll
    for (int q = 1; q < kWarpsPerBlock; ++q) p += part_s[(q * kColsTile + j) * pitch + k];
    out[e] = p;
  }
  if (one_chunk) return;

  // Grid level: the last block of this column tile sums the chunks in order.
  __threadfence();  // this block's scratch writes are visible before its ticket
  __syncthreads();
  if (threadIdx.x == 0) {
    is_last = atomicAdd(ticket + blockIdx.x, 1) == static_cast<int>(gridDim.y) - 1;
    if (is_last) ticket[blockIdx.x] = 0;  // every block of the tile has drawn
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const float* parts = scratch + (size_t)j0 * d;
  const size_t chunk_stride = (size_t)m * d;
  const int n_chunks = gridDim.y;
  for (int e = threadIdx.x; e < w * d; e += kThreads) {
    // Loads in batches of kSumBatch, all in flight before the first add (an
    // add per load would wait out one L2 latency per chunk); the adds stay in
    // chunk order. __ldcg reads L2, not a possibly stale L1 line.
    float v = 0.f;
    for (int q0 = 0; q0 < n_chunks; q0 += kSumBatch) {
      float batch[kSumBatch];
#pragma unroll
      for (int u = 0; u < kSumBatch; ++u) {
        batch[u] = q0 + u < n_chunks ? __ldcg(parts + (q0 + u) * chunk_stride + e) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kSumBatch; ++u) {
        if (q0 + u < n_chunks) v += batch[u];
      }
    }
    d_xps[(size_t)j0 * d + e] = v;
  }
}

// Dynamic shared memory above 48 KB is only granted when asked for.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int RT, typename OutT>
cudaError_t launch_fwd(const float* xs, const float* xps, const float* sig, const float* diag,
                       void* out, int n, int m, int d, int col_threads, int batch,
                       const Batch& bs, cudaStream_t stream) {
  const int rows_tile = kThreads / col_threads * RT;
  const int col_tile = kFwdColsPerThread * col_threads;
  const size_t smem = fwd_smem_floats(rows_tile, col_tile, d) * sizeof(float);
  const auto kernel = batch > 1 ? gram_fwd_kernel<RT, OutT, true>
                                : gram_fwd_kernel<RT, OutT, false>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((m + col_tile - 1) / col_tile, (n + rows_tile - 1) / rows_tile, batch);
  kernel<<<grid, kThreads, smem, stream>>>(xs, xps, sig, diag, static_cast<OutT*>(out), n, m, d,
                                           col_threads, bs);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t launch_fwd_rt(int rows_per_thread, const float* xs, const float* xps,
                          const float* sig, const float* diag, void* out, int n, int m, int d,
                          int col_threads, int batch, const Batch& bs, cudaStream_t stream) {
  switch (rows_per_thread) {
    case 1: return launch_fwd<1, OutT>(xs, xps, sig, diag, out, n, m, d, col_threads, batch, bs,
                                       stream);
    case 2: return launch_fwd<2, OutT>(xs, xps, sig, diag, out, n, m, d, col_threads, batch, bs,
                                       stream);
    case 4: return launch_fwd<4, OutT>(xs, xps, sig, diag, out, n, m, d, col_threads, batch, bs,
                                       stream);
    case 8: return launch_fwd<8, OutT>(xs, xps, sig, diag, out, n, m, d, col_threads, batch, bs,
                                       stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int DMAX>
cudaError_t launch_bwd_rows(const float* xs, const float* xps, const float* sig, const float* g,
                            float* d_xs, float* rowsum, float* scratch, int* ticket, int n, int m,
                            int d, int lanes_per_row, int slices, int stage_cols, int chunk_cols,
                            int n_chunks, int batch, const Batch& bs, cudaStream_t stream) {
  const int rows_tile = kThreads / (lanes_per_row * slices);
  // As the kernel decides it.
  const bool vec = (d & 3) == 0 && aligned16(xps) && (batch == 1 || (bs.xps & 3) == 0);
  const size_t smem = rows_smem(d, rows_tile, lanes_per_row, slices, stage_cols,
                                chunk_cols > stage_cols ? 2 : 1, vec).total * sizeof(float);
  const auto kernel = batch > 1 ? gram_bwd_rows_kernel<DMAX, true>
                                : gram_bwd_rows_kernel<DMAX, false>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + rows_tile - 1) / rows_tile, n_chunks, batch);
  kernel<<<grid, kThreads, smem, stream>>>(xs, xps, sig, g, d_xs, rowsum, scratch, ticket, n, m,
                                           d, lanes_per_row, slices, stage_cols, chunk_cols, bs);
  return cudaGetLastError();
}

template <int DMAX>
cudaError_t launch_bwd_cols(const float* xs, const float* xps, const float* sig, const float* g,
                            float* d_xps, float* scratch, int* ticket, int n, int m, int d,
                            int chunk_rows, int n_chunks, int batch, const Batch& bs,
                            cudaStream_t stream) {
  const auto kernel = batch > 1 ? gram_bwd_cols_kernel<DMAX, true>
                                : gram_bwd_cols_kernel<DMAX, false>;
  const cudaError_t err = allow_smem(kernel, bwd_cols_smem_floats(DMAX) * sizeof(float));
  if (err != cudaSuccess) return err;
  const dim3 grid((m + kColsTile - 1) / kColsTile, n_chunks, batch);
  const size_t smem = bwd_cols_smem_floats(d) * sizeof(float);
  kernel<<<grid, kThreads, smem, stream>>>(xs, xps, sig, g, d_xps, scratch, ticket, n, m, d,
                                           chunk_rows, bs);
  return cudaGetLastError();
}

bool bad_shape(int n, int m, int d) { return n < 0 || m < 0 || d < 1 || d > kMaxD; }

bool bad_batch(int batch, const Batch& bs) {
  return batch < 0 || batch > 65535 || bs.xs < 0 || bs.xps < 0 || bs.sig < 0 || bs.g < 0 ||
         bs.out0 < 0 || bs.out1 < 0;
}

}  // namespace

extern "C" {

// out[b, n, m] = sig_b * exp(-1/2 |xs_bi - xps_bj|^2) (+ *diag where i == j,
// when diag is not null), rounded once to the output type out_type: 0 float,
// 1 bfloat16, 2 float16, for b < batch. xs [n, d], xps [m, d], sig [1] and
// out [n, m] per batch, at batch strides xs_bs, xps_bs, sig_bs and out_bs
// (elements; 0 for a shared input); diag [1] or null, shared, and only with
// a 2-byte output (the float instantiation carries no diagonal code, so an
// fp32 K adds its diagonal after the launch). col_threads (8, 16, 32 or 64)
// and rows_per_thread (1, 2, 4 or 8) are the plan's
// (ops/gram_cuda.py::fwd_plan).
int gram_fwd(const float* xs, const float* xps, const float* sig, const float* diag, void* out,
             int n, int m, int d, int col_threads, int rows_per_thread, int out_type, int batch,
             long long xs_bs, long long xps_bs, long long sig_bs, long long out_bs,
             void* stream) {
  const Batch bs{xs_bs, xps_bs, sig_bs, 0, out_bs, 0};
  if (bad_shape(n, m, d) || bad_batch(batch, bs) ||
      (col_threads != 8 && col_threads != 16 && col_threads != 32 && col_threads != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || m == 0 || batch == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (out_type) {
    case 0:
      if (diag != nullptr) return static_cast<int>(cudaErrorInvalidValue);
      return static_cast<int>(launch_fwd_rt<float>(rows_per_thread, xs, xps, sig, diag, out, n,
                                                   m, d, col_threads, batch, bs, st));
    case 1:
      return static_cast<int>(launch_fwd_rt<__nv_bfloat16>(rows_per_thread, xs, xps, sig, diag,
                                                           out, n, m, d, col_threads, batch, bs,
                                                           st));
    case 2:
      return static_cast<int>(launch_fwd_rt<__half>(rows_per_thread, xs, xps, sig, diag, out, n,
                                                    m, d, col_threads, batch, bs, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// d_xs[n, d] = sum_j W_ij (xps_j - xs_i), rowsum[n] = sum_j W_ij, W = g * K,
// g [n, m] the cotangent of K, in one launch. lanes_per_row (1, 2, ..., 32),
// slices (1, 2, 4, 8), stage_cols (the columns a shared-memory stage holds)
// and chunk_cols (the columns of K a block reduces, a multiple of stage_cols)
// are the plan's (ops/gram_cuda.py::bwd_rows_plan). With more than one
// chunk, scratch holds [batch, ceil(m / chunk_cols), n, d + 1] floats and
// ticket one int per (batch, row tile), 0 at the launch and 0 again after it;
// calls that share a ticket array must be ordered (one stream). The batch
// strides of xs, xps, sig, g, d_xs and rowsum as in gram_fwd.
int gram_bwd_rows(const float* xs, const float* xps, const float* sig, const float* g,
                  float* d_xs, float* rowsum, float* scratch, int* ticket, int n, int m, int d,
                  int lanes_per_row, int slices, int stage_cols, int chunk_cols, int batch,
                  long long xs_bs, long long xps_bs, long long sig_bs, long long g_bs,
                  long long d_xs_bs, long long rowsum_bs, void* stream) {
  const Batch bs{xs_bs, xps_bs, sig_bs, g_bs, d_xs_bs, rowsum_bs};
  const bool pow2 = lanes_per_row > 0 && (lanes_per_row & (lanes_per_row - 1)) == 0 &&
                    slices > 0 && (slices & (slices - 1)) == 0;
  if (bad_shape(n, m, d) || bad_batch(batch, bs) || !pow2 ||
      lanes_per_row > 32 || slices > kWarpsPerBlock || stage_cols < 1 ||
      chunk_cols < stage_cols || chunk_cols % stage_cols != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || batch == 0) return static_cast<int>(cudaSuccess);
  const int n_chunks = m > 0 ? (m - 1) / chunk_cols + 1 : 1;
  if (n_chunks > 65535 || (n_chunks > 1 && (scratch == nullptr || ticket == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto launch = d <= 8 ? launch_bwd_rows<8>
                      : d <= 16 ? launch_bwd_rows<16>
                      : d <= 32 ? launch_bwd_rows<32>
                      : launch_bwd_rows<64>;
  return static_cast<int>(launch(xs, xps, sig, g, d_xs, rowsum, scratch, ticket, n, m, d,
                                 lanes_per_row, slices, stage_cols, chunk_cols, n_chunks, batch,
                                 bs, static_cast<cudaStream_t>(stream)));
}

// d_xps[m, d] = sum_i W_ij (xs_i - xps_j), W = g * K, in one launch.
// chunk_rows (a multiple of 64) is the rows of K a block reduces. With more
// than one chunk, scratch holds [batch, ceil(n / chunk_rows), m, d] floats and
// ticket batch * ceil(m / 32) ints that are 0 at the launch and are 0 again
// after it; calls that share a ticket array must be ordered (one stream). The
// batch strides of xs, xps, sig, g and d_xps as in gram_fwd.
int gram_bwd_cols(const float* xs, const float* xps, const float* sig, const float* g,
                  float* d_xps, float* scratch, int* ticket, int n, int m, int d,
                  int chunk_rows, int batch, long long xs_bs, long long xps_bs,
                  long long sig_bs, long long g_bs, long long d_xps_bs, void* stream) {
  const Batch bs{xs_bs, xps_bs, sig_bs, g_bs, d_xps_bs, 0};
  if (bad_shape(n, m, d) || bad_batch(batch, bs) || chunk_rows < 1 ||
      chunk_rows % kColsStageRows != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0 || batch == 0) return static_cast<int>(cudaSuccess);
  const int n_chunks = n > 0 ? (n - 1) / chunk_rows + 1 : 1;
  if (n_chunks > 65535 || (n_chunks > 1 && (scratch == nullptr || ticket == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto launch = d <= 8 ? launch_bwd_cols<8>
                      : d <= 16 ? launch_bwd_cols<16>
                      : d <= 32 ? launch_bwd_cols<32>
                      : launch_bwd_cols<64>;
  return static_cast<int>(launch(xs, xps, sig, g, d_xps, scratch, ticket, n, m, d, chunk_rows,
                                 n_chunks, batch, bs, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
