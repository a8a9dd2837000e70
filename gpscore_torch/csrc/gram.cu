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
// All arrays are row-major and contiguous, of one element type T: fp32
// (gram_fwd's output may then also be bfloat16 or float16), or fp64 through
// the *_f64 entry points, whose instantiations are the same kernels on 8-byte
// elements (16-byte cp.async copies of 2 doubles, shared-memory stages sized
// in bytes by the wrappers' plans, fma and exp in double; no 2-byte output).
// sig is a device scalar, so no launch needs a host sync. Every entry point
// launches on the caller's stream and returns cudaGetLastError().
//
// Any d: the instantiations above keep their d buckets (gram_fwd any d that
// its shared memory holds, the backward DMAX of 8 to kMaxD; in fp64 to
// kMaxD / 2). Past them (Elem<T>::kDChunk: 64 floats, 32 doubles) a call
// takes the d-chunked kernels: gram_fwd_kernel_dchunk (entry point
// gram_fwd_dchunk) stages the features of a tile's rows in as many stages
// as shared memory needs and sums each pair's squared distance over them in
// ascending k, as the unchunked one does, so K is bitwise what a wide
// unchunked build would give (its own note below); the backward's d-chunked
// kernels (gram_bwd_rows_kernel_dchunk,
// gram_bwd_cols_kernel_dchunk, one body, entry point gram_bwd_dchunk) stage
// each chunk of a tile of pairs in shared memory, sum the same distance over
// every chunk into registers, form W = g * K once per pair into a shared
// tile, and walk the chunks again to add W times the differences into the
// owned rows' sums (their own note below).
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
#include <type_traits>

namespace {

constexpr int kMaxD = 64;                        // widest d of the unchunked fp32 backward
constexpr int kWarpsPerBlock = 8;                // every kernel: 8 warps a block
constexpr int kThreads = 32 * kWarpsPerBlock;
constexpr int kColsTile = 32;                    // gram_bwd_cols: columns per block, one per lane
constexpr int kColsStageRows = 64;               // gram_bwd_cols: rows per shared-memory stage
constexpr int kSumBatch = 32;                    // both backward kernels: chunk partials loaded at once
constexpr int kFwdColsPerThread = 4;             // gram_fwd: one float4 of a row per thread
constexpr unsigned kFullMask = 0xffffffffu;

// Per element type: kVec elements a 16-byte copy; kDChunk the d-chunk of the
// chunked instantiations (256 bytes); kMaxDT the widest d of the unchunked
// backward (its acc and xj registers: 2 * kMaxD * 4 bytes a thread).
template <typename T>
struct Elem {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  static constexpr int kDChunk = kMaxD * 4 / static_cast<int>(sizeof(T));
  static constexpr int kMaxDT = kMaxD * 4 / static_cast<int>(sizeof(T));
};

__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ float exp_t(float v) { return expf(v); }
__device__ __forceinline__ double exp_t(double v) { return exp(v); }

// 16 bytes of shared memory (16-byte aligned) into registers.
__device__ __forceinline__ void load16(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void load16(const double* p, double* v) {
  const double2 q = *reinterpret_cast<const double2*>(p);
  v[0] = q.x;
  v[1] = q.y;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

// One element: cp_async4 for a float, an 8-byte copy for a double.
__device__ __forceinline__ void cp_async_elem(float* dst, const float* src) { cp_async4(dst, src); }
__device__ __forceinline__ void cp_async_elem(double* dst, const double* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
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

// Copy count contiguous elements to shared memory, every thread of the block
// taking a share; dst is 16-byte aligned.
template <typename T>
__device__ __forceinline__ void stage_span(T* dst, const T* src, int count) {
  constexpr int V = Elem<T>::kVec;
  int e = threadIdx.x;
  if (aligned16(src)) {
    for (int v = threadIdx.x; v < count / V; v += kThreads) cp_async16(dst + V * v, src + V * v);
    e += count & ~(V - 1);
  }
  for (; e < count; e += kThreads) cp_async_elem(dst + e, src + e);
}

// Copy the g tile rows [i0, i0 + rows) x columns [j0, j0 + w) to dst with row
// pitch kColsTile. With m % 4 == 0 (fp64: m % 2 == 0) every row starts
// 16-byte aligned (j0 is a multiple of 32) and w is a multiple of 4 (2).
template <typename T>
__device__ __forceinline__ void stage_g(T* dst, const T* g, int i0, int rows, int j0,
                                        int w, int m) {
  constexpr int V = Elem<T>::kVec;
  const T* src = g + (size_t)i0 * m + j0;
  if ((m & (V - 1)) == 0 && aligned16(src)) {
    const int per_row = w / V;
    for (int v = threadIdx.x; v < rows * per_row; v += kThreads) {
      const int r = v / per_row;
      const int c = V * (v - r * per_row);
      cp_async16(dst + r * kColsTile + c, src + (size_t)r * m + c);
    }
  } else {
    for (int e = threadIdx.x; e < rows * w; e += kThreads) {
      const int r = e / w;
      const int c = e - r * w;
      cp_async_elem(dst + r * kColsTile + c, src + (size_t)r * m + c);
    }
  }
}

// Copy a tile of `rows` rows x `cols` elements (row pitches src_pitch and
// dst_pitch) to shared memory through L1 (cp.async.ca): 16 bytes a copy when
// vec (cols, both pitches and both bases 16-byte aligned), one element otherwise. Every
// block of a row tile of gram_bwd_rows reads the same xps rows; through L1
// the blocks that share an SM fetch them from L2 once (with cp.async.cg,
// which bypasses L1, 500 x 500 x 8 took 8.2 us instead of 5.2).
template <typename T>
__device__ __forceinline__ void stage_tile(T* dst, int dst_pitch, const T* src,
                                           size_t src_pitch, int rows, int cols, bool vec) {
  constexpr int V = Elem<T>::kVec;
  if (vec) {
    const int per_row = cols / V;
    for (int v = threadIdx.x; v < rows * per_row; v += kThreads) {
      const int r = v / per_row;
      const int c = V * (v - r * per_row);
      const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(dst + r * dst_pitch + c));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(sa),
                   "l"(src + r * src_pitch + c) : "memory");
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += kThreads) {
      const int r = e / cols;
      const int c = e - r * cols;
      cp_async_elem(dst + r * dst_pitch + c, src + r * src_pitch + c);
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
//
// In fp64 (T = OutT = double) the same kernel on 8-byte elements: the k loop
// reads the four columns of xps as two 16-byte loads, the output goes out as
// two 16-byte stores, and sums and exp are double. The bound is the fp64
// rate, 34 TFLOP/s without tensor cores, past a few inputs.
//
// It takes d up to Elem<T>::kDChunk (64 floats, 32 doubles); past that,
// gram_fwd_kernel_dchunk (its own note below).
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
struct Out4<double> {
  static constexpr bool kDiag = false;
  __device__ __forceinline__ static double one(double v) { return v; }
  __device__ __forceinline__ static void store(double* o, const double* v) {
    reinterpret_cast<double2*>(o)[0] = make_double2(v[0], v[1]);
    reinterpret_cast<double2*>(o)[1] = make_double2(v[2], v[3]);
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

template <typename T, int RT, typename OutT, bool kBatched>
__global__ void __launch_bounds__(kThreads)
gram_fwd_kernel(const T* __restrict__ xs, const T* __restrict__ xps,
                const T* __restrict__ sig, const T* __restrict__ diag,
                OutT* __restrict__ out, int n, int m, int d, int col_threads, Batch bs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
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
  T* xs_s = smem;                     // [rows_tile][d]
  T* xpt_s = smem + rows_tile * d;    // [d][col_tile]: xps transposed

  const int tx = threadIdx.x & (col_threads - 1);  // col_threads is a power of two
  const int ty = threadIdx.x >> (__ffs(col_threads) - 1);
  const int c = kFwdColsPerThread * tx;
  T d2[RT][kFwdColsPerThread];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
#pragma unroll
    for (int q = 0; q < kFwdColsPerThread; ++q) d2[r][q] = T(0);
  }
  // Columns of the tile past w and rows past `rows` read shared memory that
  // was not filled; their sums are never stored.
  stage_span(xs_s, xs + (size_t)i0 * d, rows * d);
  if (threadIdx.x < w) {
    const T* src = xps + (size_t)(j0 + threadIdx.x) * d;
    for (int k = 0; k < d; ++k) cp_async_elem(xpt_s + k * col_tile + threadIdx.x, src + k);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (c >= w) return;
  for (int k = 0; k < d; ++k) {
    T xp[kFwdColsPerThread];
#pragma unroll
    for (int q = 0; q < kFwdColsPerThread; q += Elem<T>::kVec)
      load16(xpt_s + k * col_tile + c + q, xp + q);
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const T xi = xs_s[(ty + r * row_groups) * d + k];
#pragma unroll
      for (int q = 0; q < kFwdColsPerThread; ++q) {
        const T t = xi - xp[q];
        d2[r][q] = fma_t(t, t, d2[r][q]);
      }
    }
  }
  const T s = *sig;
  const bool vec = (m & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & (kFwdColsPerThread * sizeof(OutT) - 1)) == 0;
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int ri = ty + r * row_groups;
    if (ri >= rows) break;
    T v[kFwdColsPerThread];
#pragma unroll
    for (int q = 0; q < kFwdColsPerThread; ++q) v[q] = s * exp_t(T(-0.5) * d2[r][q]);
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

// The same in fp64: an odd number of 16-byte pairs of doubles.
template <typename T>
__host__ __device__ constexpr int rows_xps_pitch_t(int d, bool vec) {
  return sizeof(T) == 4 ? rows_xps_pitch(d, vec) : (vec ? (((d + 1) / 2) | 1) * 2 : (d | 1));
}

// Elements rounded up to 16 bytes.
template <typename T>
__host__ __device__ constexpr int round16(int v) {
  return (v + Elem<T>::kVec - 1) & ~(Elem<T>::kVec - 1);
}

// Shared memory of gram_bwd_rows, in elements: the block's xs rows, then
// `buffers` stages of (xps rows, g tile), or, after the column loop, the
// slices' partials in their place.
struct RowsSmem {
  int xs_pitch, xps_pitch, g_pitch;  // row pitches
  int xs, xps, stage, total;         // region sizes
};

template <typename T>
__host__ __device__ inline RowsSmem rows_smem(int d, int rows_tile, int lanes, int slices,
                                             int stage_cols, int buffers, bool vec) {
  RowsSmem s;
  s.xs_pitch = rows_xps_pitch_t<T>(d, (d & (Elem<T>::kVec - 1)) == 0);
  s.xps_pitch = rows_xps_pitch_t<T>(d, vec);
  s.g_pitch = stage_cols + (lanes < 32 ? lanes : 0);
  s.xs = round16<T>(rows_tile * s.xs_pitch);
  s.xps = round16<T>(stage_cols * s.xps_pitch);
  s.stage = s.xps + round16<T>(rows_tile * s.g_pitch);
  const int part = slices > 1 ? slices * rows_tile * (d + 1) : 0;
  s.total = s.xs + (buffers * s.stage > part ? buffers * s.stage : part);
  return s;
}

// In fp64 (T = double) DMAX goes to 32 (acc and xj stay 2 * 32 doubles a
// thread) and every build asks for one block an SM.
template <typename T, int DMAX, bool kBatched>
__global__ void __launch_bounds__(kThreads, DMAX <= 16 && sizeof(T) == 4 ? 2 : 1)
gram_bwd_rows_kernel(const T* __restrict__ xs, const T* __restrict__ xps,
                     const T* __restrict__ sig, const T* __restrict__ g,
                     T* __restrict__ d_xs, T* __restrict__ rowsum,
                     T* __restrict__ scratch, int* __restrict__ ticket,
                     int n, int m, int d, int lanes_per_row, int slices, int stage_cols,
                     int chunk_cols, Batch bs) {
  constexpr int V = Elem<T>::kVec;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  __shared__ int is_last;
  bool vec_base = true;
  if constexpr (kBatched) {
    // Decided on the batch's base pointer, as the launch sizes shared memory.
    vec_base = aligned16(xps) && (bs.xps & (V - 1)) == 0;
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
  const bool vec = (d & (V - 1)) == 0 && (kBatched ? vec_base : aligned16(xps));
  const RowsSmem lay = rows_smem<T>(d, rows_tile, lanes_per_row, slices, stage_cols,
                                    chunk_cols > stage_cols ? 2 : 1, vec);
  // With m and stage_cols multiples of 4 (fp64: 2), every stage's g rows
  // start 16-byte aligned and are a multiple of 16 bytes wide.
  const bool g_vec = (m & (V - 1)) == 0 && (stage_cols & (V - 1)) == 0 &&
                     (lay.g_pitch & (V - 1)) == 0 && aligned16(g);
  T* xs_s = smem;                  // [rows_tile][xs_pitch]
  T* stage_s = smem + lay.xs;      // buffers x ([stage_cols][xps_pitch], [rows_tile][g_pitch])
  T* part_s = stage_s;             // [slices][rows_tile][d + 1], after the column loop
  // Loaded before the copies are issued: the asm of cp.async orders every
  // later load after it, and this one would wait out a round trip of its own.
  const T s = *sig;

  const auto load_stage = [&](int st) {
    const int j0 = col0 + st * stage_cols;
    const int w = min(stage_cols, col_end - j0);
    T* buf = stage_s + (st & 1) * lay.stage;
    stage_tile(buf, lay.xps_pitch, xps + (size_t)j0 * d, d, w, d, vec);
    stage_tile(buf + lay.xps, lay.g_pitch, g + (size_t)i0 * m + j0, m, rows, w, g_vec);
  };
  stage_tile(xs_s, lay.xs_pitch, xs + (size_t)i0 * d, d, rows, d,
             (d & (V - 1)) == 0 && aligned16(xs));
  if (stages > 0) load_stage(0);
  cp_async_commit();

  constexpr bool kXsInRegisters = DMAX <= 16;
  T xi_r[kXsInRegisters ? DMAX : 1];
  // Rows past `rows` read shared memory that was not filled, with g taken
  // as 0; their sums are never stored.
  const T* xi_s = xs_s + r * lay.xs_pitch;  // the L lanes of a row read one address
  const auto xi = [&](int k) {
    if constexpr (kXsInRegisters) return xi_r[k];
    else return xi_s[k];
  };
  const int step = lanes_per_row * slices;
  T acc[DMAX];
  T rs = T(0);
#pragma unroll
  for (int k = 0; k < DMAX; ++k) acc[k] = T(0);
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
        for (int k = 0; k < DMAX; ++k) xi_r[k] = k < d ? xi_s[k] : T(0);
      }
    }
    const T* xb = stage_s + (st & 1) * lay.stage;
    const T* gb = xb + lay.xps + r * lay.g_pitch;
    const int w = min(stage_cols, col_end - (col0 + st * stage_cols));
    for (int j = sl * lanes_per_row + cl; j < w; j += step) {
      const T* xp = xb + j * lay.xps_pitch;
      T xj[DMAX];
      if (vec) {
#pragma unroll
        for (int k = 0; k < DMAX; k += V) {
          if (k < d) load16(xp + k, xj + k);
        }
      } else {
#pragma unroll
        for (int k = 0; k < DMAX; ++k) xj[k] = k < d ? xp[k] : T(0);
      }
      const T gj = row_ok ? gb[j] : T(0);
      T d2 = T(0);
#pragma unroll
      for (int k = 0; k < DMAX; ++k) {
        if (k < d) {
          const T t = xi(k) - xj[k];  // same operand order as the forward
          d2 = fma_t(t, t, d2);
        }
      }
      const T wv = gj * (s * exp_t(T(-0.5) * d2));
      rs += wv;
#pragma unroll
      for (int k = 0; k < DMAX; ++k) {
        if (k < d) acc[k] = fma_t(wv, xj[k] - xi(k), acc[k]);
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
  const auto emit = [&](int row, int k, T v) {
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
      T* p = part_s + (sl * rows_tile + r) * width;
#pragma unroll
      for (int k = 0; k < DMAX; ++k) {
        if (k < d) p[k] = acc[k];
      }
      p[d] = rs;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < rows * width; e += kThreads) {
      T v = part_s[e];
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
  const T* parts = scratch + (size_t)i0 * width;
  const size_t chunk_stride = (size_t)n * width;
  const int n_chunks = gridDim.y;
  for (int e = threadIdx.x; e < rows * width; e += kThreads) {
    // As in gram_bwd_cols: loads in batches, adds in chunk order, from L2.
    T v = T(0);
    for (int q0 = 0; q0 < n_chunks; q0 += kSumBatch) {
      T batch[kSumBatch];
#pragma unroll
      for (int u = 0; u < kSumBatch; ++u) {
        batch[u] = q0 + u < n_chunks ? __ldcg(parts + (q0 + u) * chunk_stride + e) : T(0);
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

// Shared memory of gram_bwd_cols, in elements: the block's xps rows, then either
// two stages (g tile and xs rows each) or, after the row loop, the 8 warps'
// partials with an odd row pitch (bank-conflict free stores).
__host__ __device__ constexpr int bwd_cols_smem_floats(int d) {
  return kColsTile * d + (2 * kColsStageRows * (kColsTile + d) > kWarpsPerBlock * kColsTile * (d | 1)
                              ? 2 * kColsStageRows * (kColsTile + d)
                              : kWarpsPerBlock * kColsTile * (d | 1));
}

// minBlocksPerSM = 1: without it ptxas aims at 64 registers and spills at
// d <= 8; the grids here put one or two blocks on an SM. In fp64 DMAX goes
// to 32 (xj and acc: 2 * 32 doubles a thread).
template <typename T, int DMAX, bool kBatched>
__global__ void __launch_bounds__(kThreads, 1)
gram_bwd_cols_kernel(const T* __restrict__ xs, const T* __restrict__ xps,
                     const T* __restrict__ sig, const T* __restrict__ g,
                     T* __restrict__ d_xps, T* __restrict__ scratch,
                     int* __restrict__ ticket, int n, int m, int d, int chunk_rows, Batch bs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
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

  T* xps_s = smem;                                  // [w][d]
  T* g_s = smem + kColsTile * d;                    // 2 x [kColsStageRows][kColsTile]
  T* xs_s = g_s + 2 * kColsStageRows * kColsTile;   // 2 x [kColsStageRows][d]
  T* part_s = g_s;                                  // [8][kColsTile][d | 1], after the loop

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
  const T s = *sig;
  T xj[DMAX];
  T acc[DMAX];
#pragma unroll
  for (int k = 0; k < DMAX; ++k) acc[k] = T(0);
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
      for (int k = 0; k < DMAX; ++k) xj[k] = (has_col && k < d) ? xps_s[lane * d + k] : T(0);
    }
    const T* gb = g_s + (st & 1) * kColsStageRows * kColsTile;
    const T* xb = xs_s + (st & 1) * kColsStageRows * d;
    const int rows = min(kColsStageRows, row_end - (row0 + st * kColsStageRows));
    if (has_col) {
      for (int r = warp; r < rows; r += kWarpsPerBlock) {
        const T* xi = xb + r * d;  // one address for the whole warp: a broadcast
        T d2 = T(0);
#pragma unroll
        for (int k = 0; k < DMAX; ++k) {
          if (k < d) {
            const T t = xi[k] - xj[k];  // same operand order as the forward
            d2 = fma_t(t, t, d2);
          }
        }
        const T wv = gb[r * kColsTile + lane] * (s * exp_t(T(-0.5) * d2));
#pragma unroll
        for (int k = 0; k < DMAX; ++k) {
          if (k < d) acc[k] = fma_t(wv, xi[k] - xj[k], acc[k]);
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
  T* out = one_chunk ? d_xps + (size_t)j0 * d : scratch + ((size_t)chunk * m + j0) * d;
  for (int e = threadIdx.x; e < w * d; e += kThreads) {
    const int j = e / d;
    const int k = e - j * d;
    T p = part_s[j * pitch + k];
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
  const T* parts = scratch + (size_t)j0 * d;
  const size_t chunk_stride = (size_t)m * d;
  const int n_chunks = gridDim.y;
  for (int e = threadIdx.x; e < w * d; e += kThreads) {
    // Loads in batches of kSumBatch, all in flight before the first add (an
    // add per load would wait out one L2 latency per chunk); the adds stay in
    // chunk order. __ldcg reads L2, not a possibly stale L1 line.
    T v = T(0);
    for (int q0 = 0; q0 < n_chunks; q0 += kSumBatch) {
      T batch[kSumBatch];
#pragma unroll
      for (int u = 0; u < kSumBatch; ++u) {
        batch[u] = q0 + u < n_chunks ? __ldcg(parts + (q0 + u) * chunk_stride + e) : T(0);
      }
#pragma unroll
      for (int u = 0; u < kSumBatch; ++u) {
        if (q0 + u < n_chunks) v += batch[u];
      }
    }
    d_xps[(size_t)j0 * d + e] = v;
  }
}

// ---- the d-chunked backward --------------------------------------------------
//
// gram_bwd_rows and gram_bwd_cols past the unchunked kernels' widest d
// (Elem<T>::kMaxDT: 64 floats, 32 doubles), in fp32 and fp64: the row and
// column halves of gram_pallas.py:_bwd (:116-133), d_xs_i = sum_j W_ij (xps_j
// - xs_i) with rowsum_i = sum_j W_ij, and d_xps_j = sum_i W_ij (xs_i - xps_j),
// W = g * K recomputed, never stored. One body serves both: a block owns a
// tile of rows of xs (kCols false; the walked side is xps) or of xps (kCols
// true; it walks xs), and both sums read sum_a W_oa (x_walked_a - x_owned_o).
//
// What bounds them: the operations, past a few hundred pairs. A pair costs
// 6d + 6 FLOP (d differences and d FMAs for the distance, d more of each for
// the output), against the 4d + 1 bytes of its g and its share of the rows:
// at 2048 x 30720 x 90 (a large-n backward block) 34 GFLOP, 513 us at the
// fp32 rate, 0.47 ms of it the FP32 pipe's issue of the 4d instructions. At
// the FITC path's small Grams (500 x 20 x 90, 20 x 20 x 90) the launch and a
// few staged round trips. The first d-chunked kernels recomputed the
// distance once per 64-feature chunk of the output, staged nothing (every
// pair read its d features through L1) and gave a tall-skinny column call
// one block per few columns: 91-941 us at 500 x 500 x 65 and 9700 x 20 x 130.
//
// What this design does about it:
// - Tiles. A block owns RO * TY rows (the owned tile) and walks a chunk of
//   the other side in stages of RA * TX rows. The thread tile RO x RA is
//   kDcRO x kVec ("wide": large Grams, where every staged element serves
//   several pairs from a register) or 1 x 1 (one pair a thread: small Grams,
//   whose time is a thread's chain of instructions, 16 times shorter so).
//   The tile, TX and TY are the plan's (ops/gram_cuda.py::dchunk_plan).
// - Staging. Each 256-byte d-chunk of the owned tile and of the stage's
//   walked rows is copied with cp.async as the 16-byte blocks that hold it,
//   whatever d (a copy of 4 bytes an element, which rows of d = 65, 90, 130
//   or 385 floats would need, ran at a few cycles an element and took most
//   of the first version of this design's time), into a raw stage that keeps
//   each row's alignment; the block then repacks it into the stage the
//   passes read, at a row pitch of 17 16-byte units (odd: the 16-byte reads
//   of neighbouring rows hit different banks). The next step's copies run
//   under this step's arithmetic. The stage's g tile comes as g lays it out.
// - W formed once per pair. Pass A: TX x TY threads each hold the distance
//   of their RO x RA pairs in registers and add every chunk of d to it, in
//   ascending k, with fma of (x_walked - x_owned)^2: the forward's squares,
//   so W is bitwise g times gram_fwd's K. After the last chunk a thread
//   forms its W = g * (sig * exp(-d2 / 2)) into a shared W tile (in the g
//   tile's place), 0 outside the Gram. Pass B walks the group's chunks
//   again: an item of RO owned rows x one 16-byte vector of features adds
//   W_oa (x_walked_a - x_owned_o) over the stage's walked rows, in ascending
//   a, into the owned tile's accumulators in shared memory (and, for the row
//   kernel, the row sums with the first chunk). Where a chunk has fewer
//   items than the block has threads (its last chunk of features, a
//   tall-skinny call's small owned tile), S neighbouring lanes split an
//   item's walked rows and a butterfly of shuffles adds their sums. W is formed once
//   per pair up to kDcGroupBytes of features (2048 floats, 1024 doubles);
//   past that the features are cut into groups on the grid's y axis and
//   each group forms W once.
// - A grid that fills the card: owned tiles x walked chunks (x groups) x
//   the batch, planned from the SM count. With more than one chunk each
//   block writes its partial to scratch[chunk, owned, d (+1)]; the last block
//   of an owned tile, elected by an int ticket that it sets back to 0, sums
//   them in chunk order; past 16 chunks, the last block of each of
//   ceil(sqrt(chunks)) groups of consecutive chunks sums its group, and the
//   last of those the groups (dc_sum_groups). A tall-skinny column call
//   (TX > 16, an owned tile of 4 or 8 columns) runs blocks of 256 threads,
//   for its pass B and for those sums.
// - No float atomics, one launch a call, bitwise the same from run to run;
//   tickets and scratch per (batch, tile) as the other kernels'. No tensor
//   cores: the differences are cancellation-critical and stay IEEE fp32
//   ("highest"), which wgmma has no mode for; the fp64 build is the same
//   body on doubles.
//
// What bounds them now (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py phase 3):
// at 2048 x 30720 x 90 the FP32 pipe and the staging around it, 2.17 ms a
// call, 0.24 of the operations bound (the first d-chunked kernels: 29.4 ms);
// where blocks are few, a block's serial steps: 500 x 20 x 90 16-20 us,
// 500 x 500 x 65 34-38 us, 9700 x 20 x 130 46 us (rows) and 52 us (columns:
// 4 serial steps a block, then the sum over 76 chunks in 9 groups), under
// the plain version's 49 and 54; 9700 x 20 x 385 205 / 145 us, over its 95
// and 82.
constexpr int kDcRO = 4;            // owned rows a thread (pass A's pairs, pass B's outputs)
constexpr int kDcMaxTX = 64;        // walked threads of pass A (a stage: kVec * TX rows)
constexpr int kDcMaxTY = 16;        // owned threads of pass A (a tile: kDcRO * TY rows)
constexpr int kDcGroupBytes = 8192; // widest feature group of one W pass, bytes of a row
constexpr int kDcSmemMax = 231424;  // dynamic shared memory a block may take (226 KB)

// The d-chunks of a width w of features: 256-byte chunks (Elem<T>::kDChunk
// elements); with `merge`, a remainder of up to 16 bytes past two chunks or
// more rides with the last full chunk (d = 130: 64 + 66, not 64 + 64 + 2; a
// chunk of a few features costs a whole step's copies, barriers and pass-B
// walk). The kernel merges where a 17-vector chunk's pass-B items fit its
// block's threads in one round.
template <typename T>
__host__ __device__ constexpr int dc_chunks(int w, bool merge) {
  constexpr int DC = Elem<T>::kDChunk;
  return merge && w > 2 * DC && (w - 1) % DC < Elem<T>::kVec ? w / DC : (w + DC - 1) / DC;
}

// The groups a tile's chunk partials are summed in: one up to 16 chunks
// (the last block of the tile sums them all), else ceil(sqrt(chunks)) groups
// of consecutive chunks, whose last blocks sum their group into a second
// level of scratch that the last of them sums (a block reads ~128 bytes a
// thread per L2 round trip: the columns at 9700 x 20 x 130, 76 chunks, took
// 58 us with one summing block a tile and 52 with 9 groups, bench_gram on an
// NVIDIA H100 80GB HBM3 at 700 W).
__host__ __device__ constexpr int dc_sum_groups(int n_chunks) {
  int g = 1;
  while (n_chunks > 16 && g * g < n_chunks) ++g;
  return g;
}

// Shared memory of the d-chunked backward, in elements: the owned tile's
// accumulators [TO][gw] and row sums; the g tile as g lays it out ([TA][TO]
// for the columns, [TO][TA] for the rows), which the W tile [TA][TO]
// (transposed, so that pass B reads kDcRO owned rows as 16 bytes) replaces
// once a stage's W is formed; the step's owned and walked rows as the
// passes read them ([TO + TA][P], P = 272 bytes, 17 16-byte units) and the
// next step's as copied ([TO + TA][P + 16 bytes]: a chunk of up to 272 bytes
// at any alignment).
struct DcSmem {
  int acc_pitch, w_pitch, g_pitch;  // row pitches
  int acc, rs, wg, stage, raw, total;
};

template <typename T>
__host__ __device__ inline DcSmem dc_smem(bool cols, int to, int ta, int gw) {
  constexpr int V = Elem<T>::kVec;
  constexpr int P = Elem<T>::kDChunk + V;
  DcSmem s;
  s.acc_pitch = round16<T>(gw);
  s.w_pitch = to + V;
  s.g_pitch = cols ? to + V : ta + V;
  s.acc = to * s.acc_pitch;
  s.rs = round16<T>(to);
  s.wg = round16<T>(max(ta * s.w_pitch, (cols ? ta : to) * s.g_pitch));
  s.stage = (to + ta) * P;
  s.raw = (to + ta) * (P + V);
  s.total = s.acc + s.rs + s.wg + s.stage + s.raw;
  return s;
}

// Copy a rows x cols tile (row pitches src_pitch, dst_pitch) to shared memory
// with cp.async through L1, the block's nthr threads taking a share: 16 bytes
// a copy when vec (cols, both pitches and both bases 16-byte aligned), one
// element otherwise.
template <typename T>
__device__ __forceinline__ void dc_stage(T* dst, int dst_pitch, const T* src, size_t src_pitch,
                                         int rows, int cols, bool vec, int tid, int nthr) {
  constexpr int V = Elem<T>::kVec;
  if (vec) {
    const int per_row = cols / V;
    for (int v = tid; v < rows * per_row; v += nthr) {
      const int r = v / per_row;
      const int c = V * (v - r * per_row);
      const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(dst + r * dst_pitch + c));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(sa),
                   "l"(src + r * src_pitch + c) : "memory");
    }
  } else {
    for (int e = tid; e < rows * cols; e += nthr) {
      const int r = e / cols;
      const int c = e - r * cols;
      cp_async_elem(dst + r * dst_pitch + c, src + r * src_pitch + c);
    }
  }
}

__device__ __forceinline__ void store16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(double* p, const double* v) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}

// Element gi of x's misalignment, in elements, from the 16-byte block that holds it.
template <typename T>
__device__ __forceinline__ int misalign_elems(const T* x, long long gi) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(x + gi) & 15) / sizeof(T));
}

// Rows row0 .. row0 + rows - 1 of x [., d], features [k0, k0 + kw), into a
// raw stage of row pitch `pitch` (elements, a multiple of 16 bytes): each row's
// span as the 16-byte blocks that hold it (cp.async through L1, 16 bytes a
// copy whatever d: a copy of 4 or 8 bytes an element ran at a few cycles an
// element), at most nb blocks a row, so that element j of the span lands at
// dst[r * pitch + s + j], s the row's misalignment (misalign_elems). Blocks
// that reach outside x's limit elements are copied element by element,
// within it. The block's nthr threads take a share each.
template <typename T>
__device__ __forceinline__ void copy_row_spans(T* dst, int pitch, int nb, const T* x, int d,
                                               int row0, int rows, int k0, int kw,
                                               long long limit, int tid, int nthr) {
  constexpr int V = Elem<T>::kVec;
  for (int v = tid; v < rows * nb; v += nthr) {
    const int r = v / nb;
    const int bv = (v - r * nb) * V;
    const long long gi = (long long)(row0 + r) * d + k0;
    const int s = misalign_elems(x, gi);
    if (bv >= s + kw) continue;  // past the span
    const long long e0 = gi - s + bv;
    T* dd = dst + r * pitch + bv;
    if (e0 >= 0 && e0 + V <= limit) {
      cp_async16(dd, x + e0);
    } else {
      for (int q = 0; q < V; ++q) {
        if (e0 + q >= 0 && e0 + q < limit) cp_async_elem(dd + q, x + e0 + q);
      }
    }
  }
}

template <typename T, bool kCols, bool kBatched, int RO, int RA>
__device__ __forceinline__ void bwd_dchunk_body(const T* __restrict__ xs,
                                                const T* __restrict__ xps,
                                                const T* __restrict__ sig,
                                                const T* __restrict__ g, T* __restrict__ out,
                                                T* __restrict__ rowsum, T* __restrict__ scratch,
                                                int* __restrict__ ticket, int n, int m, int d,
                                                int tx_n, int ty_n, int chunk, int groups,
                                                int gw, const Batch& bs) {
  constexpr int V = Elem<T>::kVec;
  constexpr int DC = Elem<T>::kDChunk;
  constexpr int P = DC + V;         // the passes' row pitch: 272 bytes
  constexpr int PR = P + V;         // the raw rows' pitch: a chunk's 16-byte blocks
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  __shared__ int is_last;
  const int n_own = kCols ? m : n;
  const int n_walk = kCols ? n : m;
  const int width = kCols ? d : d + 1;  // a scratch row: the features (and the row sum)
  const int n_chunks = gridDim.y / groups;
  const int n_sum = dc_sum_groups(n_chunks);     // the chunks' sum groups
  const int n_levels2 = n_sum > 1 ? n_sum : 0;  // second-level partials and tickets a tile
  if constexpr (kBatched) {
    const long long b = blockIdx.z;
    xs += b * bs.xs;
    xps += b * bs.xps;
    sig += b * bs.sig;
    g += b * bs.g;
    out += b * bs.out0;
    if constexpr (!kCols) rowsum += b * bs.out1;
    scratch += b * (n_chunks + n_levels2) * (long long)n_own * width;
    ticket += b * gridDim.x * (n_levels2 + 1);
  }
  const T* xo_g = kCols ? xps : xs;  // the owned rows
  const T* xa_g = kCols ? xs : xps;  // the walked rows
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int to = RO * ty_n;
  const int ta = RA * tx_n;
  const int o0 = blockIdx.x * to;
  const int rows_o = min(to, n_own - o0);
  const int chunk_i = blockIdx.y / groups;
  const int grp = blockIdx.y - chunk_i * groups;
  const int a_begin = chunk_i * chunk;
  const int a_end = min(n_walk, a_begin + chunk);
  const int stages = a_end > a_begin ? (a_end - a_begin + ta - 1) / ta : 0;
  const int k_begin = grp * gw;
  const int k_end = min(d, k_begin + gw);
  // A merged chunk's 17 vectors of pass-B items fit the block in one round.
  const bool merge = (to + RO - 1) / RO * (P / V) <= nthr;
  const int n_a = dc_chunks<T>(d, merge);                // pass A's chunks: all of d (two or more)
  const int n_b = dc_chunks<T>(k_end - k_begin, merge);  // pass B's: the group's features
  const int per_stage = n_a + n_b;
  const DcSmem lay = dc_smem<T>(kCols, to, ta, gw);
  T* acc_s = smem;                // [to][acc_pitch]
  T* rs_s = acc_s + lay.acc;      // [to]
  T* g_s = rs_s + lay.rs;         // [ta][g_pitch] (columns) or [to][g_pitch] (rows), then
  T* w_s = g_s;                   // [ta][w_pitch] in its place
  T* buf_s = g_s + lay.wg;        // 2 x ([to][P], [ta][P])
  const bool vec_g = (m & (V - 1)) == 0;  // every row of g starts as its first does
  // Loaded before the copies are issued: the asm of cp.async orders every
  // later load after it.
  const T s = *sig;
  for (int e = tid; e < lay.acc + lay.rs; e += nthr) acc_s[e] = T(0);

  // A row's chunk [k0, k0 + kw) is copied as the 16-byte blocks that hold
  // it into a raw stage at pitch PR that keeps the span's alignment
  // (copy_row_spans).
  constexpr int NB = PR / V;  // 16-byte blocks of a chunk's span, at most
  const auto copy_rows = [&](T* dst, const T* x, int row0, int rows, int k0, int kw,
                             long long limit) {
    copy_row_spans(dst, PR, NB, x, d, row0, rows, k0, kw, limit, tid, nthr);
  };
  // The raw rows into the stage that the passes read, aligned at pitch P,
  // zeros from kw to a whole 16-byte vector (pass A reads whole vectors).
  const auto repack = [&](T* dst, const T* raw, const T* x, int row0, int rows, int k0, int kw) {
    const int nv = round16<T>(kw) / V;
    for (int v = tid; v < rows * nv; v += nthr) {
      const int r = v / nv;
      const int j0 = (v - r * nv) * V;
      const int s = misalign_elems(x, (long long)(row0 + r) * d + k0);
      T q[V];
#pragma unroll
      for (int u = 0; u < V; ++u) q[u] = j0 + u < kw ? raw[r * PR + s + j0 + u] : T(0);
      store16(dst + r * P + j0, q);
    }
  };
  // Step st of the block's schedule: stage st / per_stage, whose n_a >= 2
  // pass-A chunks of d come first, then its n_b pass-B chunks of the group.
  const auto step_at = [&](int st, int& a0, int& w_a, int& k0, int& kw) {
    const int sg = st / per_stage;
    const int p = st - sg * per_stage;
    a0 = a_begin + sg * ta;
    w_a = min(ta, a_end - a0);
    const bool a = p < n_a;
    const int c = a ? p : p - n_a;
    k0 = (a ? 0 : k_begin) + c * DC;
    kw = c + 1 < (a ? n_a : n_b) ? DC : (a ? d : k_end) - k0;
    return p;
  };
  T* raw_s = buf_s + lay.stage;  // [to + ta][PR]: the next step's rows, as copied
  // The stage's g tile, once the last stage's pass B is done with the W tile
  // in its place: 16-byte copies where the tile's rows start aligned, are
  // whole vectors and land at a pitch of whole vectors (a one-pair tile of
  // 6 owned columns has a pitch of 10 floats).
  const auto stage_g_tile = [&](int a0, int w_a) {
    const T* src = g + (kCols ? (size_t)a0 * m + o0 : (size_t)o0 * m + a0);
    const int cols = kCols ? rows_o : w_a;
    const bool vec = vec_g && aligned16(src) && (cols & (V - 1)) == 0 &&
                     (lay.g_pitch & (V - 1)) == 0;
    dc_stage(g_s, lay.g_pitch, src, m, kCols ? w_a : rows_o, cols, vec, tid, nthr);
  };
  // It comes with the stage's second pass-A chunk.
  const auto issue = [&](int st) {
    int a0, w_a, k0, kw;
    const int p = step_at(st, a0, w_a, k0, kw);
    copy_rows(raw_s, xo_g, o0, rows_o, k0, kw, (long long)n_own * d);
    copy_rows(raw_s + to * PR, xa_g, a0, w_a, k0, kw, (long long)n_walk * d);
    if (p == 1) stage_g_tile(a0, w_a);
  };

  const bool active = tid < tx_n * ty_n;  // pass A's threads
  const int tx = active ? tid % tx_n : 0;
  const int ty = active ? tid / tx_n : 0;
  T d2[RO][RA];
#pragma unroll
  for (int i = 0; i < RO; ++i) {
#pragma unroll
    for (int j = 0; j < RA; ++j) d2[i][j] = T(0);
  }
  const int total = stages * per_stage;
  if (total > 0) issue(0);
  cp_async_commit();
  const T* bo = buf_s;  // the step's owned rows [to][P], then its walked rows [ta][P]
  const T* ba = buf_s + to * P;
  for (int st = 0; st < total; ++st) {
    cp_async_wait<0>();
    __syncthreads();  // this step's copies (and the g tile) are in; the last step is done
    int a0, w_a, k0, kw;
    const int p = step_at(st, a0, w_a, k0, kw);
    repack(buf_s, raw_s, xo_g, o0, rows_o, k0, kw);
    repack(buf_s + to * P, raw_s + to * PR, xa_g, a0, w_a, k0, kw);
    __syncthreads();  // the stage is in place; the raw rows are free
    if (st + 1 < total) issue(st + 1);
    cp_async_commit();
    if (p < n_a) {
      // Pass A: this chunk's terms of the distance.
      const int kwv = round16<T>(kw);
      if (active) {
        for (int k = 0; k < kwv; k += V) {
          T xo[RO][V];
          T xa[RA][V];
#pragma unroll
          for (int i = 0; i < RO; ++i) load16(bo + (ty + ty_n * i) * P + k, xo[i]);
#pragma unroll
          for (int j = 0; j < RA; ++j) load16(ba + (tx + tx_n * j) * P + k, xa[j]);
#pragma unroll
          for (int u = 0; u < V; ++u) {
#pragma unroll
            for (int i = 0; i < RO; ++i) {
#pragma unroll
              for (int j = 0; j < RA; ++j) {
                const T t = xa[j][u] - xo[i][u];  // -(xs - xps) for the rows: the same square
                d2[i][j] = fma_t(t, t, d2[i][j]);
              }
            }
          }
        }
      }
      if (p == n_a - 1) {  // every chunk is in: W = g * K, 0 outside the Gram
        T gv[RO][RA];
#pragma unroll
        for (int i = 0; i < RO; ++i) {
#pragma unroll
          for (int j = 0; j < RA; ++j) {
            const int o = ty + ty_n * i;
            const int a = tx + tx_n * j;
            gv[i][j] = active && o < rows_o && a < w_a
                           ? (kCols ? g_s[a * lay.g_pitch + o] : g_s[o * lay.g_pitch + a])
                           : T(0);
          }
        }
        __syncthreads();  // every g read: the W tile takes its place
        if (active) {
#pragma unroll
          for (int i = 0; i < RO; ++i) {
#pragma unroll
            for (int j = 0; j < RA; ++j) {
              const int o = ty + ty_n * i;
              const int a = tx + tx_n * j;
              const bool in = o < rows_o && a < w_a;
              w_s[a * lay.w_pitch + o] = in ? gv[i][j] * (s * exp_t(T(-0.5) * d2[i][j])) : T(0);
              d2[i][j] = T(0);
            }
          }
        }
      }
    } else {
      // Pass B: W times this chunk's differences, into the owned tile; k0
      // from here on counts from k_begin. An item is RO owned rows x one
      // 16-byte vector of the chunk's features; its walked rows are split
      // into S slices on S neighbouring lanes (S the largest power of two,
      // up to a warp, that the block's threads allow), whose sums a
      // butterfly of shuffles adds in a fixed order.
      k0 -= k_begin;
      const bool first = !kCols && grp == 0 && k0 == 0;  // this chunk also sums the rows
      const int nkg = (kw + V - 1) / V;
      const int items = (rows_o + RO - 1) / RO * nkg;
      int S = 1;
      while (S < 32 && items * S * 2 <= nthr) S *= 2;
      const int span = (w_a + S - 1) / S;
      for (int u0 = 0; u0 < items * S; u0 += nthr) {  // one round when S > 1
        const int u = u0 + tid;
        const int item = u / S;
        const int sl = u - item * S;
        const bool valid = item < items;
        const int ob = valid ? item / nkg * RO : 0;
        const int kk = valid ? (item - item / nkg * nkg) * V : 0;
        const bool sums = first && kk == 0;
        T acc[RO][V];
        T xo[RO][V];
        T rs[RO];
#pragma unroll
        for (int i = 0; i < RO; ++i) {
          load16(bo + (ob + i) * P + kk, xo[i]);
          if (sl == 0 && valid) {
            load16(acc_s + (ob + i) * lay.acc_pitch + k0 + kk, acc[i]);
            rs[i] = rs_s[ob + i];
          } else {
#pragma unroll
            for (int q = 0; q < V; ++q) acc[i][q] = T(0);
            rs[i] = T(0);
          }
        }
        const int hi = valid ? min(w_a, (sl + 1) * span) : 0;
        for (int a = sl * span; a < hi; ++a) {
          T w4[RO];
          T xa[V];
          if constexpr (RO % V == 0) {
#pragma unroll
            for (int q = 0; q < RO; q += V) load16(w_s + a * lay.w_pitch + ob + q, w4 + q);
          } else {
#pragma unroll
            for (int q = 0; q < RO; ++q) w4[q] = w_s[a * lay.w_pitch + ob + q];
          }
          load16(ba + a * P + kk, xa);
#pragma unroll
          for (int i = 0; i < RO; ++i) {
            if (sums) rs[i] += w4[i];
#pragma unroll
            for (int q = 0; q < V; ++q) acc[i][q] = fma_t(w4[i], xa[q] - xo[i][q], acc[i][q]);
          }
        }
        // An item's S lanes are neighbours in one warp (S divides 32), and
        // with S > 1 every lane of the block takes part.
        for (int off = 1; off < S; off <<= 1) {
#pragma unroll
          for (int i = 0; i < RO; ++i) {
            rs[i] += __shfl_xor_sync(kFullMask, rs[i], off);
#pragma unroll
            for (int q = 0; q < V; ++q) acc[i][q] += __shfl_xor_sync(kFullMask, acc[i][q], off);
          }
        }
        if (sl == 0 && valid) {
#pragma unroll
          for (int i = 0; i < RO; ++i) {
            store16(acc_s + (ob + i) * lay.acc_pitch + k0 + kk, acc[i]);
            if (sums) rs_s[ob + i] = rs[i];
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the accumulators (zero with no stage) are final

  // This block's sums over its chunk: the output with one chunk, else this
  // chunk's slot of scratch; the group's features, and in group 0 the rows'
  // sums.
  const bool one_chunk = n_chunks == 1;
  const int gk = k_end - k_begin;
  for (int e = tid; e < rows_o * gk; e += nthr) {
    const int r = e / gk;
    const int k = k_begin + e - r * gk;
    const T v = acc_s[r * lay.acc_pitch + k - k_begin];
    if (one_chunk) out[(size_t)(o0 + r) * d + k] = v;
    else scratch[((size_t)chunk_i * n_own + o0 + r) * width + k] = v;
  }
  if constexpr (!kCols) {
    if (grp == 0) {
      for (int r = tid; r < rows_o; r += nthr) {
        if (one_chunk) rowsum[o0 + r] = rs_s[r];
        else scratch[((size_t)chunk_i * n_own + o0 + r) * width + d] = rs_s[r];
      }
    }
  }
  if (one_chunk) return;

  // Grid level, in a fixed order: the last block of the tile (with one sum
  // group), else of each group of consecutive chunks and then of the groups,
  // elected by int tickets that they set back to 0, sums the partials.
  const size_t chunk_stride = (size_t)n_own * width;
  const T* parts = scratch + (size_t)o0 * width;
  int* tk = ticket + blockIdx.x * (n_levels2 + 1);  // the tile's ticket, then its groups'
  const auto last_of = [&](int* t, int count) {
    __threadfence();  // this block's scratch writes are visible before its ticket
    __syncthreads();
    if (tid == 0) {
      is_last = atomicAdd(t, 1) == count - 1;
      if (is_last) *t = 0;  // every block of the count has drawn
    }
    __syncthreads();
    if (is_last) __threadfence();
    return is_last;
  };
  // Partials c0 .. c0 + count - 1 of the tile's rows, added in order (loads
  // in batches, from L2, as gram_bwd_cols), each element to store(e, sum).
  const auto sum_parts = [&](const T* base, int count, auto store) {
    for (int e = tid; e < rows_o * width; e += nthr) {
      T v = T(0);
      for (int q0 = 0; q0 < count; q0 += kSumBatch) {
        T batch[kSumBatch];
#pragma unroll
        for (int u = 0; u < kSumBatch; ++u) {
          batch[u] = q0 + u < count ? __ldcg(base + (q0 + u) * chunk_stride + e) : T(0);
        }
#pragma unroll
        for (int u = 0; u < kSumBatch; ++u) {
          if (q0 + u < count) v += batch[u];
        }
      }
      store(e, v);
    }
  };
  const auto store_out = [&](int e, T v) {
    const int r = e / width;
    const int k = e - r * width;
    if (kCols || k < d) out[(size_t)(o0 + r) * d + k] = v;
    else rowsum[o0 + r] = v;
  };
  if (n_sum == 1) {
    if (!last_of(tk, static_cast<int>(gridDim.y))) return;
    sum_parts(parts, n_chunks, store_out);
    return;
  }
  const int per = (n_chunks + n_sum - 1) / n_sum;  // chunks a group
  const int n_grp = (n_chunks + per - 1) / per;   // groups that hold chunks
  const int sg = chunk_i / per;
  const int c0 = sg * per;
  const int cn = min(per, n_chunks - c0);
  if (!last_of(tk + 1 + sg, cn * groups)) return;
  T* level2 = scratch + (size_t)n_chunks * chunk_stride + (size_t)o0 * width;
  sum_parts(parts + c0 * chunk_stride, cn,
            [&](int e, T v) { level2[sg * chunk_stride + e] = v; });
  if (!last_of(tk, n_grp)) return;
  sum_parts(level2, n_grp, store_out);
}

// The thread tile: kWide, kDcRO owned x kVec walked pairs a thread (large
// Grams: every staged element serves several pairs from a register); else
// one pair a thread (small Grams, whose time is the latency of a thread's
// chain of instructions, 16 times shorter so). fp32 takes at most 128
// registers a thread, two blocks of 256 threads an SM; fp64 at most 255.
template <typename T, bool kBatched, bool kWide>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 2 : 1)
gram_bwd_rows_kernel_dchunk(const T* __restrict__ xs, const T* __restrict__ xps,
                            const T* __restrict__ sig, const T* __restrict__ g,
                            T* __restrict__ d_xs, T* __restrict__ rowsum, T* __restrict__ scratch,
                            int* __restrict__ ticket, int n, int m, int d, int tx_n, int ty_n,
                            int chunk, int groups, int gw, Batch bs) {
  bwd_dchunk_body<T, false, kBatched, kWide ? kDcRO : 1, kWide ? Elem<T>::kVec : 1>(
      xs, xps, sig, g, d_xs, rowsum, scratch, ticket, n, m, d, tx_n, ty_n, chunk, groups, gw, bs);
}

template <typename T, bool kBatched, bool kWide>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 2 : 1)
gram_bwd_cols_kernel_dchunk(const T* __restrict__ xs, const T* __restrict__ xps,
                            const T* __restrict__ sig, const T* __restrict__ g,
                            T* __restrict__ d_xps, T* __restrict__ scratch,
                            int* __restrict__ ticket, int n, int m, int d, int tx_n, int ty_n,
                            int chunk, int groups, int gw, Batch bs) {
  bwd_dchunk_body<T, true, kBatched, kWide ? kDcRO : 1, kWide ? Elem<T>::kVec : 1>(
      xs, xps, sig, g, d_xps, nullptr, scratch, ticket, n, m, d, tx_n, ty_n, chunk, groups, gw,
      bs);
}

// ---- gram_fwd, d-chunked -------------------------------------------------------
//
// K_ij = sig * exp(-1/2 |xs_i - xps_j|^2), gram_pallas.py:_gram_kernel
// (:40-53), past gram_fwd_kernel's widest d (Elem<T>::kDChunk: 64 floats, 32
// doubles): the song set's d = 90, the slice set's 385.
//
// What bounds it: the operations. A pair costs d differences and d FMAs, two
// FP32-pipe instructions a feature: the distance stays in IEEE direct
// differences (it is cancellation-critical, and wgmma has no IEEE fp32
// mode), so the Pallas kernel's cross-term dot is not carried over. At
// 30720 x 30720 x 90 (all of K_hat at n = 30,720) the FP32 pipe's issue of
// those instructions takes 5.07 ms at the card's boost clock, over the 3.8 ms
// of the roofline's 3d + 3 FLOP a pair and the 1.1 ms of K's bytes. At the
// FITC path's Grams (500 x 20 x 90, 20 x 20 x 90), a launch and a copy round
// trip. The first d-chunked build (a loop around gram_fwd_kernel's body,
// NVIDIA H100 80GB HBM3 at 700 W) took 17.4 ms at 30720^2 x 90 and 22 us at
// 500 x 500 x 65: 4-byte copies of rows 260-1540 bytes apart, two serial
// barriers a 256-byte chunk, and a 32 x 256 tile that staged xps 960 times.
//
// What this design does about it:
// - A thread tile of RT rows x CT columns (kFdRows, kFdCols): 8 x 8 (at 16 x
//   16 threads a 128 x 128 tile: xps is staged n / 128 times, and a feature
//   costs a thread 4 shared loads of 16 bytes for 64 pairs), 4 x 4 (16 sums
//   in flight a thread where the 8 x 8 tile leaves too few blocks), 1 x 4
//   (tall-skinny Grams) or 1 x 1 (small Grams, whose time is a thread's
//   chain). Rows come in groups of min(RT, 4) neighbours, group g of thread
//   ty at row g * 4 * TY + 4 * ty; columns likewise, so that a group is one
//   16-byte load of the transposed stage. TX, TY and the tile are the plan's
//   (ops/gram_cuda.py::fwd_dchunk_plan).
// - Staging in 16-byte blocks: each row's span of a stage's features is
//   copied as the 16-byte blocks that hold it, whatever d (fd_copy_rows, the
//   d-chunked backward's copies), then transposed to [feature][row]: a warp
//   takes 4 rows x 8 features at a time over the whole tile and stage width
//   (uniform bounds, no branch an element), kFdBatch loads before their
//   stores; at a transposed pitch 4 floats past a multiple of 32 and a raw
//   pitch 8 past a multiple of 16 its stores hit 32 banks and its loads at
//   most two a bank. A tile of one row a thread sums its xs row straight
//   from the raw stage and transposes xps alone.
// - A pipeline, one barrier a stage: three raw stages (four where xs is read
//   raw) and two transposed ones in a ring. After stage c's barrier the
//   block transposes stage c, issues the copies of stage c + 2 and sums
//   stage c - 1, so two stages' copies are in flight while one is summed. A
//   stage holds as many features as shared memory allows for two blocks an
//   SM (the plan's kc): where the tile's rows and all of d fit, all of d is
//   one stage.
// - Each pair's squared distance is one thread's sum in ascending k, with fma
//   of (xs - xps): K is bitwise what the d-chunked backward's pass A
//   recomputes, and K(u, u) is exactly symmetric with an exact sig diagonal.
//   The epilogue is gram_fwd_kernel's (OutT, diag, 16-byte stores where m %
//   4 == 0), column group by column group.
//
// What bounds it now (NVIDIA H100 80GB HBM3, 700 W; bench_gram --chunked):
// at 30720 x 30720 x 90 9.18 ms, 0.42 of the operations bound; built without
// its copies and transposes (experiments/bench_fwd_stages.py) 6.72 ms, 0.75 of
// the FP32 pipe's issue floor; 30720 x 2048 x 90 0.64 ms (0.40); where
// blocks are few, a thread's chain and a copy round trip: 3.4-3.9 us at the
// FITC-20 Grams, 6.4 us at 500 x 500 x 65, 12.4 us at 9700 x 20 x 130.
constexpr int kFdTiles = 4;                      // thread tiles, by index
constexpr int kFdRows[kFdTiles] = {1, 1, 8, 4};  // rows a thread
constexpr int kFdCols[kFdTiles] = {1, 4, 8, 4};  // columns a thread
constexpr int kFdBatch = 4;                      // a transposing thread's loads in flight

// Shared memory of the d-chunked forward, in elements: nraw raw stages of
// the tile's rows as copied ([rt4 + ct4][pr]: nb 16-byte blocks a row, at
// any alignment; the row counts rounded up to 4), then ntr transposed stages
// ([kc][ps] for xs, [kc][px] for xps). A call of one stage takes one of
// each; of two, two raw stages.
struct FdSmem {
  int nb, pr, ps, px;  // blocks of a raw row; the raw, xs^T and xps^T pitches
  int nraw, ntr, raw, tr, total;
};

template <typename T>
__host__ __device__ inline FdSmem fd_smem(int rt, int ct, int kc, int d, bool xs_raw) {
  constexpr int V = Elem<T>::kVec;
  constexpr int E = static_cast<int>(sizeof(T));
  FdSmem s;
  const int stages = (d + kc - 1) / kc;
  s.nb = (kc + 2 * V - 2) / V;
  s.pr = s.nb * V;
  while (s.pr * E % 64 != 32) s.pr += V;
  s.ps = (rt + 3) / 4 * 4;
  while (s.ps * E % 128 != 16) s.ps += V;
  s.px = (ct + 3) / 4 * 4;
  while (s.px * E % 128 != 16) s.px += V;
  // A stage's raw xs rows are read until the stage after next has been issued
  // where they are summed from there (xs_raw): four raw stages then.
  const int ring = xs_raw ? 4 : 3;
  s.nraw = stages < ring ? stages : ring;
  s.ntr = stages < 2 ? stages : 2;
  s.raw = ((rt + 3) / 4 + (ct + 3) / 4) * 4 * s.pr;
  s.tr = kc * ((xs_raw ? 0 : s.ps) + s.px);
  s.total = s.nraw * s.raw + s.ntr * s.tr;
  return s;
}

// copy_row_spans for the forward: the same copies, stepped from one to the
// next without a division, and, where every row's blocks lie inside x (all
// but a call's first and last rows, as a rule), by a loop without the
// per-block limit check. On an NVIDIA H100 80GB HBM3 the forward took ~5%
// longer with copy_row_spans (30720 x 30720 x 90: 9.63 ms against 9.18), the
// backward ~1.2% longer with this loop (its large-n block), so each keeps its
// own.
template <typename T>
__device__ __forceinline__ void fd_copy_rows(T* dst, int pitch, int nb, const T* x, int d,
                                             int row0, int rows, int k0, int kw,
                                             long long limit, int tid, int nthr) {
  constexpr int V = Elem<T>::kVec;
  const long long first = (long long)row0 * d + k0;  // the first row's span
  const long long last = first + (long long)(rows - 1) * d;
  const int s_last = misalign_elems(x, last);
  const bool inside = first - misalign_elems(x, first) >= 0 &&
                      last - s_last + (s_last + kw + V - 1) / V * V <= limit;
  // Copy v = tid + i * nthr is block b of row r, v = r * nb + b.
  const int step_r = nthr / nb;
  const int step_b = nthr - step_r * nb;
  const auto walk = [&](auto checked) {
    int r = tid / nb;
    int b = tid - r * nb;
    for (; r < rows; r += step_r, b += step_b) {
      if (b >= nb) {
        b -= nb;
        ++r;
        if (r >= rows) break;
      }
      const int bv = b * V;
      const long long gi = first + (long long)r * d;
      const int s = misalign_elems(x, gi);
      if (bv >= s + kw) continue;  // past the span
      const long long e0 = gi - s + bv;
      T* dd = dst + r * pitch + bv;
      if (!decltype(checked)::value || (e0 >= 0 && e0 + V <= limit)) {
        cp_async16(dd, x + e0);
      } else {
        for (int q = 0; q < V; ++q) {
          if (e0 + q >= 0 && e0 + q < limit) cp_async_elem(dd + q, x + e0 + q);
        }
      }
    }
  };
  if (inside) walk(std::false_type{});
  else walk(std::true_type{});
}

// The rt4 rows (rt rounded up to 4) of a raw stage (pitch pr, each row at its
// misalignment as copy_row_spans leaves it) into dst[k * p + r] for k < kc:
// a warp takes 4 rows x 8 features at a time, lane l row l % 4 and feature
// l / 4, kFdBatch of them at once, their loads before their stores: kAlongK,
// a row group's features k, k + 8, ... (a one-stage call's long rows); else
// row groups g, g + warps, ... (a stage's many short rows), feature after
// feature. A batch past the last group or feature repeats that one, load and
// store alike. Row r's misalignment is (mis + r * d) mod the elements of 16
// bytes, mis that of the stage's first element (x / sizeof(T) + row0 * d +
// k0, mod 2^32). Cells past the Gram's rows or the stage's kw features take
// what the raw stage holds there, and are never read. (One element at a
// time, each load waited behind the store before it: the two stages share
// one shared array, so the compiler keeps a load after the store before it.)
template <bool kAlongK, typename T>
__device__ __forceinline__ void fd_transpose(T* dst, int p, const T* raw, int pr, unsigned mis,
                                             int d, int rt, int kc, int tid, int nthr) {
  constexpr unsigned V = Elem<T>::kVec;
  const int lane = tid & 31;
  const int rl = lane & 3;
  const int kl = lane >> 2;
  const int groups = (rt + 3) >> 2;  // of 4 rows
  const int nw = nthr >> 5;
  const auto at = [&](int r) {
    return r * pr + static_cast<int>((mis + unsigned(r) * unsigned(d)) & (V - 1));
  };
  if constexpr (kAlongK) {
    for (int g = tid >> 5; g < groups; g += nw) {
      const int r = 4 * g + rl;
      const T* src = raw + at(r);
      for (int k0 = kl; k0 < kc; k0 += 8 * kFdBatch) {
        T v[kFdBatch];
#pragma unroll
        for (int u = 0; u < kFdBatch; ++u) v[u] = src[min(k0 + 8 * u, kc - 1)];
#pragma unroll
        for (int u = 0; u < kFdBatch; ++u) dst[min(k0 + 8 * u, kc - 1) * p + r] = v[u];
      }
    }
  } else {
    for (int g0 = tid >> 5; g0 < groups; g0 += kFdBatch * nw) {
      int r[kFdBatch];
      int src[kFdBatch];
#pragma unroll
      for (int u = 0; u < kFdBatch; ++u) {
        r[u] = 4 * min(g0 + u * nw, groups - 1) + rl;
        src[u] = at(r[u]);
      }
      for (int k = kl; k < kc; k += 8) {
        T v[kFdBatch];
#pragma unroll
        for (int u = 0; u < kFdBatch; ++u) v[u] = raw[src[u] + k];
#pragma unroll
        for (int u = 0; u < kFdBatch; ++u) dst[k * p + r[u]] = v[u];
      }
    }
  }
}

// W neighbouring elements of shared memory (16-byte aligned when W > 1).
template <int W, typename T>
__device__ __forceinline__ void load_w(const T* p, T* v) {
  if constexpr (W == 1) {
    v[0] = *p;
  } else {
#pragma unroll
    for (int u = 0; u < W; u += Elem<T>::kVec) load16(p + u, v + u);
  }
}

// fp32 takes at most 128 registers a thread for the 8 x 8 tile (two blocks
// of 256 threads an SM), 64 for the others; fp64 twice that.
template <typename T, int RT, int CT, typename OutT, bool kBatched>
__global__ void __launch_bounds__(kThreads, (sizeof(T) == 4 ? 2 : 1) * (RT * CT >= 16 ? 1 : 2))
gram_fwd_kernel_dchunk(const T* __restrict__ xs, const T* __restrict__ xps,
                       const T* __restrict__ sig, const T* __restrict__ diag,
                       OutT* __restrict__ out, int n, int m, int d, int tx_n, int ty_n, int kc,
                       Batch bs) {
  constexpr int RW = RT < 4 ? RT : 4;  // rows of a group
  constexpr int CW = CT < 4 ? CT : 4;  // columns of a group
  constexpr int RG = RT / RW;
  constexpr int CG = CT / CW;
  // Features a thread's loop takes at once: enough loads in flight to hide
  // their latency where a feature is a few instructions.
  constexpr int kUnroll = RT * CT >= 64 ? 2 : 8;
  // One row a thread: it sums its xs row from the raw stage (one element a
  // feature at any alignment), and only xps is transposed.
  constexpr bool kXsRaw = RT == 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  if constexpr (kBatched) {
    const long long b = blockIdx.z;
    xs += b * bs.xs;
    xps += b * bs.xps;
    sig += b * bs.sig;
    out += b * bs.out0;
  }
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int rt = RT * ty_n;  // the block's tile
  const int ct = CT * tx_n;
  const int rt4 = (rt + 3) / 4 * 4;  // the tile's rows in the raw stages
  // Row tiles on x (up to 2^31 - 1), column tiles on y.
  const int i0 = blockIdx.x * rt;
  const int j0 = blockIdx.y * ct;
  const int rows = min(rt, n - i0);
  const int cols = min(ct, m - j0);
  const int stages = (d + kc - 1) / kc;
  const FdSmem lay = fd_smem<T>(rt, ct, kc, d, kXsRaw);
  T* raw_s = smem;                       // nraw x [rt4 + ct4][pr]
  T* tr_s = smem + lay.nraw * lay.raw;   // ntr x ([kc][ps] unless kXsRaw, [kc][px])
  const int pso = kXsRaw ? 0 : lay.ps;   // xps^T's offset in a transposed stage, in rows of ps
  // Loaded before the copies are issued: the asm of cp.async orders every
  // later load after it.
  const T s = *sig;
  const auto issue = [&](int c) {
    const int k0 = c * kc;
    const int kw = min(kc, d - k0);
    T* raw = raw_s + (c % lay.nraw) * lay.raw;
    fd_copy_rows(raw, lay.pr, lay.nb, xs, d, i0, rows, k0, kw, (long long)n * d, tid, nthr);
    fd_copy_rows(raw + rt4 * lay.pr, lay.pr, lay.nb, xps, d, j0, cols, k0, kw, (long long)m * d,
                 tid, nthr);
  };
  // The first rows' misalignment in elements, mod 2^32 (fd_transpose).
  const unsigned mis_s = static_cast<unsigned>(reinterpret_cast<uintptr_t>(xs) / sizeof(T)) +
                         unsigned(i0) * unsigned(d);
  const unsigned mis_p = static_cast<unsigned>(reinterpret_cast<uintptr_t>(xps) / sizeof(T)) +
                         unsigned(j0) * unsigned(d);
  const bool active = tid < tx_n * ty_n;
  const int tx = tid % tx_n;
  const int ty = tid / tx_n;
  T d2[RT][CT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
#pragma unroll
    for (int j = 0; j < CT; ++j) d2[i][j] = T(0);
  }
  issue(0);
  cp_async_commit();
  if (stages > 1) issue(1);
  cp_async_commit();
  // Rows past `rows` and columns past `cols` sum what their transposed
  // cells hold; their sums are never stored.
  for (int c = 0; c <= stages; ++c) {
    if (c < stages) cp_async_wait<1>();  // stage c's copies; c + 1's may fly on
    __syncthreads();  // stage c is in; stage c - 1 is transposed; c - 2 summed
    if (c < stages) {
      const unsigned k0 = unsigned(c * kc);
      const T* raw = raw_s + (c % lay.nraw) * lay.raw;
      T* tb = tr_s + (c & 1) * lay.tr;
      if constexpr (!kXsRaw) fd_transpose<false>(tb, lay.ps, raw, lay.pr, mis_s + k0, d, rt, kc, tid,
                                                 nthr);
      fd_transpose<kXsRaw>(tb + kc * pso, lay.px, raw + rt4 * lay.pr, lay.pr, mis_p + k0, d, ct,
                           kc, tid, nthr);
      if (c + 2 < stages) issue(c + 2);  // into the raw stage that c - 1 left
      cp_async_commit();
    }
    if (c > 0 && active) {
      const int kw = min(kc, d - (c - 1) * kc);
      // kXsRaw: this thread's row where stage c - 1's raw copy put it.
      const T* xt = kXsRaw ? raw_s + ((c - 1) % lay.nraw) * lay.raw + ty * lay.pr +
                                 static_cast<int>((mis_s + unsigned((c - 1) * kc) +
                                                   unsigned(ty) * unsigned(d)) &
                                                  (Elem<T>::kVec - 1))
                           : tr_s + ((c - 1) & 1) * lay.tr + RW * ty;
      const T* pt = tr_s + ((c - 1) & 1) * lay.tr + kc * pso + CW * tx;
#pragma unroll kUnroll
      for (int k = 0; k < kw; ++k) {
        T a[RT];
        T b[CT];
#pragma unroll
        for (int g = 0; g < RG; ++g) {
          if constexpr (kXsRaw) a[0] = xt[k];
          else load_w<RW>(xt + k * lay.ps + g * RW * ty_n, a + g * RW);
        }
#pragma unroll
        for (int h = 0; h < CG; ++h) load_w<CW>(pt + k * lay.px + h * CW * tx_n, b + h * CW);
#pragma unroll
        for (int i = 0; i < RT; ++i) {
#pragma unroll
          for (int j = 0; j < CT; ++j) {
            const T t = a[i] - b[j];
            d2[i][j] = fma_t(t, t, d2[i][j]);
          }
        }
      }
    }
  }
  if (!active) return;
  const bool vec = CW == kFwdColsPerThread && (m & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & (kFwdColsPerThread * sizeof(OutT) - 1)) == 0;
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int ri = (i / RW) * RW * ty_n + RW * ty + i % RW;
    if (ri >= rows) continue;
#pragma unroll
    for (int h = 0; h < CG; ++h) {
      const int c0 = h * CW * tx_n + CW * tx;
      if (c0 >= cols) continue;
      T v[CW];
#pragma unroll
      for (int q = 0; q < CW; ++q) v[q] = s * exp_t(T(-0.5) * d2[i][h * CW + q]);
      if constexpr (Out4<OutT>::kDiag) {
        if (diag != nullptr) {
          const int q = i0 + ri - (j0 + c0);  // the column of this row's diagonal, if it is ours
          if (q >= 0 && q < CW) {
#pragma unroll
            for (int u = 0; u < CW; ++u) {
              if (u == q) v[u] = __fadd_rn(v[u], *diag);
            }
          }
        }
      }
      OutT* o = out + (size_t)(i0 + ri) * m + j0 + c0;
      if constexpr (CW == kFwdColsPerThread) {
        if (vec) {  // then cols % 4 == 0, so all four columns are in the tile
          Out4<OutT>::store(o, v);
          continue;
        }
      }
#pragma unroll
      for (int q = 0; q < CW; ++q) {
        if (c0 + q < cols) o[q] = Out4<OutT>::one(v[q]);
      }
    }
  }
}

// Dynamic shared memory above 48 KB is only granted when asked for.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// One launch of the d-chunked backward under the plan (tx, ty, chunk, groups,
// gw, threads) of ops/gram_cuda.py::dchunk_plan: a grid of owned tiles x
// (walked chunks x feature groups) x batch, blocks of `threads` threads,
// whole warps, at least tx * ty (the rest stage rows and sum the chunks).
template <typename T>
cudaError_t launch_bwd_dchunk(bool cols, bool wide, const T* xs, const T* xps, const T* sig,
                              const T* g, T* out, T* rowsum, T* scratch, int* ticket, int n, int m,
                              int d, int tx, int ty, int chunk, int groups, int gw, int threads,
                              int batch, const Batch& bs, cudaStream_t stream) {
  const int own = cols ? m : n;
  const int walk = cols ? n : m;
  const int ro = wide ? kDcRO : 1;
  const int to = ro * ty;
  const int n_chunks = walk > 0 ? (walk - 1) / chunk + 1 : 1;
  const size_t smem = dc_smem<T>(cols, to, (wide ? Elem<T>::kVec : 1) * tx, gw).total * sizeof(T);
  if (smem > kDcSmemMax || (long long)n_chunks * groups > 65535 ||
      (n_chunks > 1 && (scratch == nullptr || ticket == nullptr)))
    return cudaErrorInvalidValue;
  const dim3 grid((own + to - 1) / to, n_chunks * groups, batch);
  if (cols) {
    const auto kernel = batch > 1 ? (wide ? gram_bwd_cols_kernel_dchunk<T, true, true>
                                          : gram_bwd_cols_kernel_dchunk<T, true, false>)
                                  : (wide ? gram_bwd_cols_kernel_dchunk<T, false, true>
                                          : gram_bwd_cols_kernel_dchunk<T, false, false>);
    const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, threads, smem, stream>>>(xs, xps, sig, g, out, scratch, ticket, n, m, d, tx,
                                            ty, chunk, groups, gw, bs);
  } else {
    const auto kernel = batch > 1 ? (wide ? gram_bwd_rows_kernel_dchunk<T, true, true>
                                          : gram_bwd_rows_kernel_dchunk<T, true, false>)
                                  : (wide ? gram_bwd_rows_kernel_dchunk<T, false, true>
                                          : gram_bwd_rows_kernel_dchunk<T, false, false>);
    const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, threads, smem, stream>>>(xs, xps, sig, g, out, rowsum, scratch, ticket, n, m,
                                            d, tx, ty, chunk, groups, gw, bs);
  }
  return cudaGetLastError();
}

// gram_fwd with its element type T deduced from the pointers (d up to
// Elem<T>::kDChunk; past it gram_fwd_dchunk).
template <int RT, typename OutT, typename T>
cudaError_t launch_fwd(const T* xs, const T* xps, const T* sig, const T* diag,
                       void* out, int n, int m, int d, int col_threads, int batch,
                       const Batch& bs, cudaStream_t stream) {
  const int rows_tile = kThreads / col_threads * RT;
  const int col_tile = kFwdColsPerThread * col_threads;
  const size_t smem = fwd_smem_floats(rows_tile, col_tile, d) * sizeof(T);
  const auto kernel = batch > 1 ? gram_fwd_kernel<T, RT, OutT, true>
                                : gram_fwd_kernel<T, RT, OutT, false>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((m + col_tile - 1) / col_tile, (n + rows_tile - 1) / rows_tile, batch);
  kernel<<<grid, kThreads, smem, stream>>>(xs, xps, sig, diag, static_cast<OutT*>(out), n, m, d,
                                           col_threads, bs);
  return cudaGetLastError();
}

template <typename OutT, typename T>
cudaError_t launch_fwd_rt(int rows_per_thread, const T* xs, const T* xps,
                          const T* sig, const T* diag, void* out, int n, int m, int d,
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

// One launch of the d-chunked forward under the plan (tile, tx, ty, threads,
// kc) of ops/gram_cuda.py::fwd_dchunk_plan: a grid of row tiles x column
// tiles x batch, blocks of `threads` threads (whole warps, at least tx * ty;
// the rest copy and transpose).
template <typename T, int RT, int CT, typename OutT>
cudaError_t launch_fwd_dchunk(const T* xs, const T* xps, const T* sig, const T* diag, void* out,
                              int n, int m, int d, int tx, int ty, int threads, int kc, int batch,
                              const Batch& bs, cudaStream_t stream) {
  const int rt = RT * ty;
  const int ct = CT * tx;
  const size_t smem = fd_smem<T>(rt, ct, kc, d, RT == 1).total * sizeof(T);
  const int col_tiles = (m + ct - 1) / ct;
  if (smem > kDcSmemMax || col_tiles > 65535) return cudaErrorInvalidValue;
  const auto kernel = batch > 1 ? gram_fwd_kernel_dchunk<T, RT, CT, OutT, true>
                                : gram_fwd_kernel_dchunk<T, RT, CT, OutT, false>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + rt - 1) / rt, col_tiles, batch);
  kernel<<<grid, threads, smem, stream>>>(xs, xps, sig, diag, static_cast<OutT*>(out), n, m, d,
                                          tx, ty, kc, bs);
  return cudaGetLastError();
}

template <typename OutT, typename T>
cudaError_t launch_fwd_dchunk_tile(int tile, const T* xs, const T* xps, const T* sig,
                                   const T* diag, void* out, int n, int m, int d, int tx, int ty,
                                   int threads, int kc, int batch, const Batch& bs,
                                   cudaStream_t stream) {
  switch (tile) {
    case 0:
      return launch_fwd_dchunk<T, kFdRows[0], kFdCols[0], OutT>(
          xs, xps, sig, diag, out, n, m, d, tx, ty, threads, kc, batch, bs, stream);
    case 1:
      return launch_fwd_dchunk<T, kFdRows[1], kFdCols[1], OutT>(
          xs, xps, sig, diag, out, n, m, d, tx, ty, threads, kc, batch, bs, stream);
    case 2:
      return launch_fwd_dchunk<T, kFdRows[2], kFdCols[2], OutT>(
          xs, xps, sig, diag, out, n, m, d, tx, ty, threads, kc, batch, bs, stream);
    case 3:
      return launch_fwd_dchunk<T, kFdRows[3], kFdCols[3], OutT>(
          xs, xps, sig, diag, out, n, m, d, tx, ty, threads, kc, batch, bs, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int DMAX>
cudaError_t launch_bwd_rows(const T* xs, const T* xps, const T* sig, const T* g,
                            T* d_xs, T* rowsum, T* scratch, int* ticket, int n, int m,
                            int d, int lanes_per_row, int slices, int stage_cols, int chunk_cols,
                            int n_chunks, int batch, const Batch& bs, cudaStream_t stream) {
  constexpr int V = Elem<T>::kVec;
  const int rows_tile = kThreads / (lanes_per_row * slices);
  // As the kernel decides it.
  const bool vec = (d & (V - 1)) == 0 && aligned16(xps) && (batch == 1 || (bs.xps & (V - 1)) == 0);
  const size_t smem = rows_smem<T>(d, rows_tile, lanes_per_row, slices, stage_cols,
                                   chunk_cols > stage_cols ? 2 : 1, vec).total * sizeof(T);
  const auto kernel = batch > 1 ? gram_bwd_rows_kernel<T, DMAX, true>
                                : gram_bwd_rows_kernel<T, DMAX, false>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + rows_tile - 1) / rows_tile, n_chunks, batch);
  kernel<<<grid, kThreads, smem, stream>>>(xs, xps, sig, g, d_xs, rowsum, scratch, ticket, n, m,
                                           d, lanes_per_row, slices, stage_cols, chunk_cols, bs);
  return cudaGetLastError();
}

template <typename T, int DMAX>
cudaError_t launch_bwd_cols(const T* xs, const T* xps, const T* sig, const T* g,
                            T* d_xps, T* scratch, int* ticket, int n, int m, int d,
                            int chunk_rows, int n_chunks, int batch, const Batch& bs,
                            cudaStream_t stream) {
  const auto kernel = batch > 1 ? gram_bwd_cols_kernel<T, DMAX, true>
                                : gram_bwd_cols_kernel<T, DMAX, false>;
  const cudaError_t err = allow_smem(kernel, bwd_cols_smem_floats(DMAX) * sizeof(T));
  if (err != cudaSuccess) return err;
  const dim3 grid((m + kColsTile - 1) / kColsTile, n_chunks, batch);
  const size_t smem = bwd_cols_smem_floats(d) * sizeof(T);
  kernel<<<grid, kThreads, smem, stream>>>(xs, xps, sig, g, d_xps, scratch, ticket, n, m, d,
                                           chunk_rows, bs);
  return cudaGetLastError();
}

bool bad_shape(int n, int m, int d) { return n < 0 || m < 0 || d < 1; }

bool bad_batch(int batch, const Batch& bs) {
  return batch < 0 || batch > 65535 || bs.xs < 0 || bs.xps < 0 || bs.sig < 0 || bs.g < 0 ||
         bs.out0 < 0 || bs.out1 < 0;
}

bool bad_col_threads(int col_threads) {
  return col_threads != 8 && col_threads != 16 && col_threads != 32 && col_threads != 64;
}

template <typename T>
int bwd_rows_entry(const T* xs, const T* xps, const T* sig, const T* g, T* d_xs, T* rowsum,
                   T* scratch, int* ticket, int n, int m, int d, int lanes_per_row, int slices,
                   int stage_cols, int chunk_cols, int batch, const Batch& bs, void* stream) {
  const bool pow2 = lanes_per_row > 0 && (lanes_per_row & (lanes_per_row - 1)) == 0 &&
                    slices > 0 && (slices & (slices - 1)) == 0;
  if (bad_shape(n, m, d) || bad_batch(batch, bs) || !pow2 ||
      lanes_per_row > 32 || slices > kWarpsPerBlock || stage_cols < 1 ||
      chunk_cols < stage_cols || chunk_cols % stage_cols != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || batch == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d > Elem<T>::kMaxDT) return static_cast<int>(cudaErrorInvalidValue);  // gram_bwd_dchunk
  const int n_chunks = m > 0 ? (m - 1) / chunk_cols + 1 : 1;
  if (n_chunks > 65535 || (n_chunks > 1 && (scratch == nullptr || ticket == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  // The DMAX buckets: 8, 16, 32 and (fp32) kMaxD; fp64 has no kMaxD build.
  auto launch = launch_bwd_rows<T, 8>;
  if (d > 8) launch = launch_bwd_rows<T, 16>;
  if (d > 16) launch = launch_bwd_rows<T, 32>;
  if constexpr (Elem<T>::kMaxDT == kMaxD) {
    if (d > 32) launch = launch_bwd_rows<T, kMaxD>;
  }
  return static_cast<int>(launch(xs, xps, sig, g, d_xs, rowsum, scratch, ticket, n, m, d,
                                 lanes_per_row, slices, stage_cols, chunk_cols, n_chunks, batch,
                                 bs, st));
}

template <typename T>
int bwd_cols_entry(const T* xs, const T* xps, const T* sig, const T* g, T* d_xps, T* scratch,
                   int* ticket, int n, int m, int d, int chunk_rows, int batch, const Batch& bs,
                   void* stream) {
  if (bad_shape(n, m, d) || bad_batch(batch, bs) || chunk_rows < 1 ||
      chunk_rows % kColsStageRows != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0 || batch == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d > Elem<T>::kMaxDT) return static_cast<int>(cudaErrorInvalidValue);  // gram_bwd_dchunk
  const int n_chunks = n > 0 ? (n - 1) / chunk_rows + 1 : 1;
  if (n_chunks > 65535 || (n_chunks > 1 && (scratch == nullptr || ticket == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  // The DMAX buckets: 8, 16, 32 and (fp32) kMaxD; fp64 has no kMaxD build.
  auto launch = launch_bwd_cols<T, 8>;
  if (d > 8) launch = launch_bwd_cols<T, 16>;
  if (d > 16) launch = launch_bwd_cols<T, 32>;
  if constexpr (Elem<T>::kMaxDT == kMaxD) {
    if (d > 32) launch = launch_bwd_cols<T, kMaxD>;
  }
  return static_cast<int>(launch(xs, xps, sig, g, d_xps, scratch, ticket, n, m, d, chunk_rows,
                                 n_chunks, batch, bs, st));
}

template <typename T>
int fwd_dchunk_entry(const T* xs, const T* xps, const T* sig, const T* diag, void* out, int n,
                     int m, int d, int tile, int tx, int ty, int threads, int kc, int out_type,
                     int batch, const Batch& bs, void* stream) {
  if (bad_shape(n, m, d) || d <= Elem<T>::kDChunk || bad_batch(batch, bs) || tile < 0 ||
      tile >= kFdTiles || tx < 1 || ty < 1 || tx * ty > kThreads || threads % 32 != 0 ||
      threads < tx * ty || threads > kThreads || kc < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || m == 0 || batch == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (sizeof(T) == 8) {
    if (out_type != 0 || diag != nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_fwd_dchunk_tile<double>(tile, xs, xps, sig, diag, out, n, m,
                                                           d, tx, ty, threads, kc, batch, bs, st));
  } else {
    switch (out_type) {
      case 0:
        if (diag != nullptr) return static_cast<int>(cudaErrorInvalidValue);
        return static_cast<int>(launch_fwd_dchunk_tile<float>(tile, xs, xps, sig, diag, out, n,
                                                              m, d, tx, ty, threads, kc, batch,
                                                              bs, st));
      case 1:
        return static_cast<int>(launch_fwd_dchunk_tile<__nv_bfloat16>(
            tile, xs, xps, sig, diag, out, n, m, d, tx, ty, threads, kc, batch, bs, st));
      case 2:
        return static_cast<int>(launch_fwd_dchunk_tile<__half>(
            tile, xs, xps, sig, diag, out, n, m, d, tx, ty, threads, kc, batch, bs, st));
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
}

template <typename T>
int bwd_dchunk_entry(int cols, int wide, const T* xs, const T* xps, const T* sig, const T* g,
                     T* out, T* rowsum, T* scratch, int* ticket, int n, int m, int d, int tx,
                     int ty, int chunk, int groups, int gw, int threads, int batch,
                     const Batch& bs, void* stream) {
  constexpr int DC = Elem<T>::kDChunk;
  if (bad_shape(n, m, d) || d <= DC || bad_batch(batch, bs) || (cols != 0 && cols != 1) ||
      (wide != 0 && wide != 1) || tx < 1 || tx > kDcMaxTX || (tx > 16 && tx % 16 != 0) ||
      ty < 1 || ty > kDcMaxTY || tx * ty > kThreads ||
      (!wide && tx > 16) || threads % 32 != 0 ||
      threads < tx * ty || threads > kThreads ||
      chunk < 1 || chunk % ((wide ? Elem<T>::kVec : 1) * tx) != 0 || groups < 1 ||
      gw < 1 || (groups > 1 && gw % DC != 0) || (long long)gw * groups < d ||
      (long long)gw * (groups - 1) >= d || (long long)gw * sizeof(T) > kDcGroupBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((cols ? m : n) == 0 || batch == 0) return static_cast<int>(cudaSuccess);
  return static_cast<int>(launch_bwd_dchunk<T>(cols == 1, wide == 1, xs, xps, sig, g, out,
                                               rowsum, scratch, ticket, n, m, d, tx, ty, chunk,
                                               groups, gw, threads, batch, bs,
                                               static_cast<cudaStream_t>(stream)));
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
// (ops/gram_cuda.py::fwd_plan). d from 1 to 64: past it gram_fwd_dchunk.
int gram_fwd(const float* xs, const float* xps, const float* sig, const float* diag, void* out,
             int n, int m, int d, int col_threads, int rows_per_thread, int out_type, int batch,
             long long xs_bs, long long xps_bs, long long sig_bs, long long out_bs,
             void* stream) {
  const Batch bs{xs_bs, xps_bs, sig_bs, 0, out_bs, 0};
  if (bad_shape(n, m, d) || d > Elem<float>::kDChunk || bad_batch(batch, bs) ||
      bad_col_threads(col_threads))
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

// gram_fwd on fp64 inputs: K in fp64 (out_type 0, the only one; no diag).
// d from 1 to 32: past it gram_fwd_dchunk_f64.
int gram_fwd_f64(const double* xs, const double* xps, const double* sig, const double* diag,
                 void* out, int n, int m, int d, int col_threads, int rows_per_thread,
                 int out_type, int batch, long long xs_bs, long long xps_bs, long long sig_bs,
                 long long out_bs, void* stream) {
  const Batch bs{xs_bs, xps_bs, sig_bs, 0, out_bs, 0};
  if (bad_shape(n, m, d) || d > Elem<double>::kDChunk || bad_batch(batch, bs) ||
      bad_col_threads(col_threads) || out_type != 0 || diag != nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || m == 0 || batch == 0) return static_cast<int>(cudaSuccess);
  return static_cast<int>(launch_fwd_rt<double>(rows_per_thread, xs, xps, sig, diag, out, n, m,
                                                d, col_threads, batch, bs,
                                                static_cast<cudaStream_t>(stream)));
}

// gram_fwd past 64 floats (gram_fwd_dchunk) or 32 doubles (gram_fwd_dchunk_f64):
// the same arrays, output types, diag and batch strides; tile (0: 1 x 1, 1: 1
// x 4, 2: 8 x 8 rows x columns a thread), tx and ty (column and row threads,
// tx * ty <= 256), threads (the block, whole warps, at least tx * ty) and kc
// (features a shared-memory stage) are the plan's
// (ops/gram_cuda.py::fwd_dchunk_plan). The fp64 build writes fp64 only, no
// diag.
int gram_fwd_dchunk(const float* xs, const float* xps, const float* sig, const float* diag,
                    void* out, int n, int m, int d, int tile, int tx, int ty, int threads, int kc,
                    int out_type, int batch, long long xs_bs, long long xps_bs, long long sig_bs,
                    long long out_bs, void* stream) {
  const Batch bs{xs_bs, xps_bs, sig_bs, 0, out_bs, 0};
  return fwd_dchunk_entry<float>(xs, xps, sig, diag, out, n, m, d, tile, tx, ty, threads, kc,
                                 out_type, batch, bs, stream);
}

int gram_fwd_dchunk_f64(const double* xs, const double* xps, const double* sig,
                        const double* diag, void* out, int n, int m, int d, int tile, int tx,
                        int ty, int threads, int kc, int out_type, int batch, long long xs_bs,
                        long long xps_bs, long long sig_bs, long long out_bs, void* stream) {
  const Batch bs{xs_bs, xps_bs, sig_bs, 0, out_bs, 0};
  return fwd_dchunk_entry<double>(xs, xps, sig, diag, out, n, m, d, tile, tx, ty, threads, kc,
                                  out_type, batch, bs, stream);
}

// d_xs[n, d] = sum_j W_ij (xps_j - xs_i), rowsum[n] = sum_j W_ij, W = g * K,
// g [n, m] the cotangent of K, in one launch. lanes_per_row (1, 2, ..., 32),
// slices (1, 2, 4, 8), stage_cols (the columns a shared-memory stage holds)
// and chunk_cols (the columns of K a block reduces, a multiple of stage_cols)
// are the plan's (ops/gram_cuda.py::bwd_rows_plan). With more than one
// chunk, scratch holds [batch, ceil(m / chunk_cols), n, d + 1] floats and
// ticket one int per (batch, row tile), 0 at the launch and 0 again after it;
// calls that share a ticket array must be ordered (one stream). The batch
// strides of xs, xps, sig, g, d_xs and rowsum as in gram_fwd. Past d = 64
// it refuses the call: gram_bwd_dchunk takes it.
int gram_bwd_rows(const float* xs, const float* xps, const float* sig, const float* g,
                  float* d_xs, float* rowsum, float* scratch, int* ticket, int n, int m, int d,
                  int lanes_per_row, int slices, int stage_cols, int chunk_cols, int batch,
                  long long xs_bs, long long xps_bs, long long sig_bs, long long g_bs,
                  long long d_xs_bs, long long rowsum_bs, void* stream) {
  const Batch bs{xs_bs, xps_bs, sig_bs, g_bs, d_xs_bs, rowsum_bs};
  return bwd_rows_entry<float>(xs, xps, sig, g, d_xs, rowsum, scratch, ticket, n, m, d,
                               lanes_per_row, slices, stage_cols, chunk_cols, batch, bs, stream);
}

// gram_bwd_rows on fp64 arrays (scratch fp64 too); past d = 32 gram_bwd_dchunk_f64.
int gram_bwd_rows_f64(const double* xs, const double* xps, const double* sig, const double* g,
                      double* d_xs, double* rowsum, double* scratch, int* ticket, int n, int m,
                      int d, int lanes_per_row, int slices, int stage_cols, int chunk_cols,
                      int batch, long long xs_bs, long long xps_bs, long long sig_bs,
                      long long g_bs, long long d_xs_bs, long long rowsum_bs, void* stream) {
  const Batch bs{xs_bs, xps_bs, sig_bs, g_bs, d_xs_bs, rowsum_bs};
  return bwd_rows_entry<double>(xs, xps, sig, g, d_xs, rowsum, scratch, ticket, n, m, d,
                                lanes_per_row, slices, stage_cols, chunk_cols, batch, bs, stream);
}

// d_xps[m, d] = sum_i W_ij (xs_i - xps_j), W = g * K, in one launch.
// chunk_rows (a multiple of 64) is the rows of K a block reduces. With more
// than one chunk, scratch holds [batch, ceil(n / chunk_rows), m, d] floats and
// ticket batch * ceil(m / 32) ints that are 0 at the launch and are 0 again
// after it; calls that share a ticket array must be ordered (one stream). The
// batch strides of xs, xps, sig, g and d_xps as in gram_fwd. Past d = 64 it
// refuses the call: gram_bwd_dchunk takes it.
int gram_bwd_cols(const float* xs, const float* xps, const float* sig, const float* g,
                  float* d_xps, float* scratch, int* ticket, int n, int m, int d,
                  int chunk_rows, int batch, long long xs_bs, long long xps_bs,
                  long long sig_bs, long long g_bs, long long d_xps_bs, void* stream) {
  const Batch bs{xs_bs, xps_bs, sig_bs, g_bs, d_xps_bs, 0};
  return bwd_cols_entry<float>(xs, xps, sig, g, d_xps, scratch, ticket, n, m, d, chunk_rows,
                               batch, bs, stream);
}

// gram_bwd_cols on fp64 arrays (scratch fp64 too); past d = 32 gram_bwd_dchunk_f64.
int gram_bwd_cols_f64(const double* xs, const double* xps, const double* sig, const double* g,
                      double* d_xps, double* scratch, int* ticket, int n, int m, int d,
                      int chunk_rows, int batch, long long xs_bs, long long xps_bs,
                      long long sig_bs, long long g_bs, long long d_xps_bs, void* stream) {
  const Batch bs{xs_bs, xps_bs, sig_bs, g_bs, d_xps_bs, 0};
  return bwd_cols_entry<double>(xs, xps, sig, g, d_xps, scratch, ticket, n, m, d, chunk_rows,
                                batch, bs, stream);
}

// The d-chunked backward (d past 64 floats, 32 doubles: d > 256 bytes):
// cols 0, the row half, out = d_xs [n, d] and rowsum [n]; cols 1, the column
// half, out = d_xps [m, d] (rowsum null). wide, tx, ty, chunk, groups, gw and
// threads are the plan's (ops/gram_cuda.py::dchunk_plan):
// - wide: the thread tile, 1 for 4 owned x 16 / sizeof(T) walked pairs, 0
//   for one pair;
// - tx, ty: pass A's walked and owned threads (tx <= 16 or a multiple of 16
//   up to 64; ty <= 16; tx * ty <= 256). With one pair a thread, tx <= 16;
// - chunk: the walked rows a block reduces, whole stages of tx walked rows
//   a thread's;
// - groups, gw: feature groups of gw features (gw * sizeof(T) <= 8192; a
//   multiple of the 256-byte chunk when there are several);
// - threads: the block, whole warps, at least tx * ty.
// With more than one chunk, scratch holds [batch, chunks + L, owned, d + 1
// (rows) or d (columns)] elements and ticket 1 + L ints per (batch, owned
// tile), L = dc_sum_groups(chunks) past 16 chunks (else 0), all 0 at the
// launch and 0 again after it; calls that share a ticket array must be
// ordered (one stream). The batch strides as in gram_bwd_rows
// (out_bs: out's).
int gram_bwd_dchunk(int cols, int wide, const float* xs, const float* xps, const float* sig,
                    const float* g, float* out, float* rowsum, float* scratch, int* ticket, int n,
                    int m, int d, int tx, int ty, int chunk, int groups, int gw, int threads,
                    int batch, long long xs_bs, long long xps_bs, long long sig_bs,
                    long long g_bs, long long out_bs, long long rowsum_bs, void* stream) {
  const Batch bs{xs_bs, xps_bs, sig_bs, g_bs, out_bs, rowsum_bs};
  return bwd_dchunk_entry<float>(cols, wide, xs, xps, sig, g, out, rowsum, scratch, ticket, n, m,
                                 d, tx, ty, chunk, groups, gw, threads, batch, bs, stream);
}

// gram_bwd_dchunk on fp64 arrays (scratch fp64 too).
int gram_bwd_dchunk_f64(int cols, int wide, const double* xs, const double* xps,
                        const double* sig, const double* g, double* out, double* rowsum,
                        double* scratch, int* ticket, int n, int m, int d, int tx, int ty,
                        int chunk, int groups, int gw, int threads, int batch, long long xs_bs,
                        long long xps_bs, long long sig_bs, long long g_bs, long long out_bs,
                        long long rowsum_bs, void* stream) {
  const Batch bs{xs_bs, xps_bs, sig_bs, g_bs, out_bs, rowsum_bs};
  return bwd_dchunk_entry<double>(cols, wide, xs, xps, sig, g, out, rowsum, scratch, ticket, n,
                                  m, d, tx, ty, chunk, groups, gw, threads, batch, bs, stream);
}

}  // extern "C"
