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
// kMaxD / 2). Past them a call takes the d-chunked instantiations, which
// walk d in chunks of 256 bytes (Elem<T>::kDChunk: 64 floats, 32 doubles)
// in their own bodies: gram_fwd stages one chunk of xs and xps at a time and
// sums the squared distance over every chunk before the exp, in ascending k
// as the unchunked one does, so K is bitwise what a wide unchunked build
// would give; the backward's chunked kernels (gram_bwd_rows_kernel_dchunk,
// gram_bwd_cols_kernel_dchunk) form W = g * K from the whole distance and
// write d_xs / d_xps one chunk of d at a time, recomputing the distance per
// chunk.
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

// Copy rows x cols elements at row pitches src_pitch and dst_pitch, one
// element a copy (the chunked gram_fwd's slices of xs rows).
template <typename T>
__device__ __forceinline__ void stage_elems(T* dst, int dst_pitch, const T* src, size_t src_pitch,
                                            int rows, int cols) {
  for (int e = threadIdx.x; e < rows * cols; e += kThreads) {
    const int r = e / cols;
    const int c = e - r * cols;
    cp_async_elem(dst + r * dst_pitch + c, src + r * src_pitch + c);
  }
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
// kChunk (d past Elem<T>::kDChunk): shared memory holds one chunk of d of
// the block's xs rows and xps columns at a time; the block stages chunk
// after chunk, each thread adding each chunk's terms to its sums in
// ascending k, and the exp comes once every chunk is in. Threads with no
// columns stay for the barriers of every chunk.
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

template <typename T, int RT, typename OutT, bool kBatched, bool kChunk>
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
  const int dw = kChunk ? Elem<T>::kDChunk : d;  // the d of one stage
  T* xs_s = smem;                      // [rows_tile][dw]
  T* xpt_s = smem + rows_tile * dw;    // [dw][col_tile]: xps transposed

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
  const auto accumulate = [&](int kw) {
    for (int k = 0; k < kw; ++k) {
      T xp[kFwdColsPerThread];
#pragma unroll
      for (int q = 0; q < kFwdColsPerThread; q += Elem<T>::kVec)
        load16(xpt_s + k * col_tile + c + q, xp + q);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const T xi = xs_s[(ty + r * row_groups) * dw + k];
#pragma unroll
        for (int q = 0; q < kFwdColsPerThread; ++q) {
          const T t = xi - xp[q];
          d2[r][q] = fma_t(t, t, d2[r][q]);
        }
      }
    }
  };
  if constexpr (!kChunk) {
    stage_span(xs_s, xs + (size_t)i0 * d, rows * d);
    if (threadIdx.x < w) {
      const T* src = xps + (size_t)(j0 + threadIdx.x) * d;
      for (int k = 0; k < d; ++k) cp_async_elem(xpt_s + k * col_tile + threadIdx.x, src + k);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (c >= w) return;
    accumulate(d);
  } else {
    for (int k0 = 0; k0 < d; k0 += dw) {
      const int kw = min(dw, d - k0);
      stage_elems(xs_s, dw, xs + (size_t)i0 * d + k0, d, rows, kw);
      if (threadIdx.x < w) {
        const T* src = xps + (size_t)(j0 + threadIdx.x) * d + k0;
        for (int k = 0; k < kw; ++k) cp_async_elem(xpt_s + k * col_tile + threadIdx.x, src + k);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      if (c < w) accumulate(kw);
      __syncthreads();  // the next chunk refills the stage just read
    }
    if (c >= w) return;
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
// (Elem<T>::kMaxDT: 64 floats, 32 doubles), in fp32 and fp64: the same sums,
// d_xs_i = sum_j W_ij (xps_j - xs_i) with rowsum_i = sum_j W_ij, and d_xps_j =
// sum_i W_ij (xs_i - xps_j), W = g * K recomputed.
//
// A simple kernel, right first: a group of `group` threads (a power of two,
// 32 to 256: the walked side's length rounded up, at most the block) owns one
// row (kCols false) or one column (kCols true) and walks the other side with
// a stride of the group. For each chunk of Elem<T>::kDChunk features it
// forms every W_ij from the whole distance (summed over all d in ascending k,
// xs - xps, as the forward does, read through L1 from device memory) and
// adds W_ij times the chunk's differences to kDChunk sums in registers; the
// group then reduces them in a fixed order (a butterfly in each warp, the
// warps in order through shared memory) and writes the chunk of d_xs or
// d_xps, and with the first chunk the rowsum. So the distance is recomputed
// once a chunk, no float is added atomically, a call is one launch and
// bitwise the same from run to run. Nothing is staged: what bounds it is the
// d loads of every (i, j) pair from L1 and, at tall-skinny column calls, a
// grid of one block a few columns (ROADMAP: a staged, chunked design).
template <typename T, bool kCols, bool kBatched>
__device__ __forceinline__ void bwd_dchunk_body(const T* __restrict__ xs,
                                                const T* __restrict__ xps,
                                                const T* __restrict__ sig,
                                                const T* __restrict__ g, T* __restrict__ out,
                                                T* __restrict__ rowsum, int n, int m, int d,
                                                int group, const Batch& bs) {
  constexpr int DC = Elem<T>::kDChunk;
  __shared__ T part_s[kWarpsPerBlock][DC + 1];
  if constexpr (kBatched) {
    const long long b = blockIdx.z;
    xs += b * bs.xs;
    xps += b * bs.xps;
    sig += b * bs.sig;
    g += b * bs.g;
    out += b * bs.out0;
    if constexpr (!kCols) rowsum += b * bs.out1;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int own = blockIdx.x * (kThreads / group) + threadIdx.x / group;
  const int t = threadIdx.x & (group - 1);
  const int n_own = kCols ? m : n;
  const int n_walk = kCols ? n : m;
  const bool ok = own < n_own;
  const T* xo = (kCols ? xps : xs) + (size_t)(ok ? own : 0) * d;  // the owned input row
  const T* xw = kCols ? xs : xps;                                  // the walked rows
  const T s = *sig;
  const int warp0 = (threadIdx.x / group) * (group >> 5);  // the group's first warp
  for (int k0 = 0; k0 < d; k0 += DC) {
    const int kw = min(DC, d - k0);
    T acc[DC];
    T rs = T(0);
#pragma unroll
    for (int k = 0; k < DC; ++k) acc[k] = T(0);
    if (ok) {
      for (int j = t; j < n_walk; j += group) {
        const T* xj = xw + (size_t)j * d;
        T d2 = T(0);
        for (int k = 0; k < d; ++k) {
          const T u = kCols ? xj[k] - xo[k] : xo[k] - xj[k];  // xs - xps, as the forward
          d2 = fma_t(u, u, d2);
        }
        const T gv = kCols ? g[(size_t)j * m + own] : g[(size_t)own * m + j];
        const T wv = gv * (s * exp_t(T(-0.5) * d2));
        rs += wv;
#pragma unroll
        for (int k = 0; k < DC; ++k) {
          if (k < kw) acc[k] = fma_t(wv, xj[k0 + k] - xo[k0 + k], acc[k]);
        }
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      rs += __shfl_xor_sync(kFullMask, rs, off);
#pragma unroll
      for (int k = 0; k < DC; ++k) {
        if (k < kw) acc[k] += __shfl_xor_sync(kFullMask, acc[k], off);
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < DC; ++k) {
        if (k < kw) part_s[warp][k] = acc[k];
      }
      part_s[warp][DC] = rs;
    }
    __syncthreads();
    if (ok) {
      for (int e = t; e <= kw; e += group) {
        const int slot = e < kw ? e : DC;
        T v = part_s[warp0][slot];
        for (int q = 1; q < (group >> 5); ++q) v += part_s[warp0 + q][slot];
        if (e < kw) out[(size_t)own * d + k0 + e] = v;
        else if (!kCols && k0 == 0) rowsum[own] = v;
      }
    }
    __syncthreads();  // the next chunk rewrites part_s
  }
}

template <typename T, bool kBatched>
__global__ void __launch_bounds__(kThreads)
gram_bwd_rows_kernel_dchunk(const T* __restrict__ xs, const T* __restrict__ xps,
                            const T* __restrict__ sig, const T* __restrict__ g,
                            T* __restrict__ d_xs, T* __restrict__ rowsum, int n, int m, int d,
                            int group, Batch bs) {
  bwd_dchunk_body<T, false, kBatched>(xs, xps, sig, g, d_xs, rowsum, n, m, d, group, bs);
}

template <typename T, bool kBatched>
__global__ void __launch_bounds__(kThreads)
gram_bwd_cols_kernel_dchunk(const T* __restrict__ xs, const T* __restrict__ xps,
                            const T* __restrict__ sig, const T* __restrict__ g,
                            T* __restrict__ d_xps, int n, int m, int d, int group, Batch bs) {
  bwd_dchunk_body<T, true, kBatched>(xs, xps, sig, g, d_xps, nullptr, n, m, d, group, bs);
}

// The chunked kernels' group: the walked side's length rounded up to a power
// of two, from 32 to kThreads.
int dchunk_group(int walked) {
  int gsize = 32;
  while (gsize < kThreads && gsize < walked) gsize *= 2;
  return gsize;
}

template <typename T>
cudaError_t launch_bwd_dchunk(bool cols, const T* xs, const T* xps, const T* sig, const T* g,
                              T* out, T* rowsum, int n, int m, int d, int batch,
                              const Batch& bs, cudaStream_t stream) {
  const int group = dchunk_group(cols ? n : m);
  const int owned = cols ? m : n;
  const int per_block = kThreads / group;
  const dim3 grid((owned + per_block - 1) / per_block, 1, batch);
  if (cols) {
    const auto kernel = batch > 1 ? gram_bwd_cols_kernel_dchunk<T, true>
                                  : gram_bwd_cols_kernel_dchunk<T, false>;
    kernel<<<grid, kThreads, 0, stream>>>(xs, xps, sig, g, out, n, m, d, group, bs);
  } else {
    const auto kernel = batch > 1 ? gram_bwd_rows_kernel_dchunk<T, true>
                                  : gram_bwd_rows_kernel_dchunk<T, false>;
    kernel<<<grid, kThreads, 0, stream>>>(xs, xps, sig, g, out, rowsum, n, m, d, group, bs);
  }
  return cudaGetLastError();
}

// Dynamic shared memory above 48 KB is only granted when asked for.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// gram_fwd with its element type T deduced from the pointers; d past
// Elem<T>::kDChunk takes the chunked instantiation, whose stages hold one chunk.
template <int RT, typename OutT, typename T>
cudaError_t launch_fwd(const T* xs, const T* xps, const T* sig, const T* diag,
                       void* out, int n, int m, int d, int col_threads, int batch,
                       const Batch& bs, cudaStream_t stream) {
  const int rows_tile = kThreads / col_threads * RT;
  const int col_tile = kFwdColsPerThread * col_threads;
  const bool chunk = d > Elem<T>::kDChunk;
  const size_t smem =
      fwd_smem_floats(rows_tile, col_tile, chunk ? Elem<T>::kDChunk : d) * sizeof(T);
  const auto kernel = chunk ? (batch > 1 ? gram_fwd_kernel<T, RT, OutT, true, true>
                                         : gram_fwd_kernel<T, RT, OutT, false, true>)
                            : (batch > 1 ? gram_fwd_kernel<T, RT, OutT, true, false>
                                         : gram_fwd_kernel<T, RT, OutT, false, false>);
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
  if (d > Elem<T>::kMaxDT)
    return static_cast<int>(launch_bwd_dchunk<T>(false, xs, xps, sig, g, d_xs, rowsum, n, m, d,
                                                 batch, bs, st));
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
  if (d > Elem<T>::kMaxDT)
    return static_cast<int>(launch_bwd_dchunk<T>(true, xs, xps, sig, g, d_xps, nullptr, n, m, d,
                                                 batch, bs, st));
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
// (ops/gram_cuda.py::fwd_plan). Any d >= 1: past 64 the chunked build.
int gram_fwd(const float* xs, const float* xps, const float* sig, const float* diag, void* out,
             int n, int m, int d, int col_threads, int rows_per_thread, int out_type, int batch,
             long long xs_bs, long long xps_bs, long long sig_bs, long long out_bs,
             void* stream) {
  const Batch bs{xs_bs, xps_bs, sig_bs, 0, out_bs, 0};
  if (bad_shape(n, m, d) || bad_batch(batch, bs) || bad_col_threads(col_threads))
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
// Past 32 features the chunked build.
int gram_fwd_f64(const double* xs, const double* xps, const double* sig, const double* diag,
                 void* out, int n, int m, int d, int col_threads, int rows_per_thread,
                 int out_type, int batch, long long xs_bs, long long xps_bs, long long sig_bs,
                 long long out_bs, void* stream) {
  const Batch bs{xs_bs, xps_bs, sig_bs, 0, out_bs, 0};
  if (bad_shape(n, m, d) || bad_batch(batch, bs) || bad_col_threads(col_threads) ||
      out_type != 0 || diag != nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || m == 0 || batch == 0) return static_cast<int>(cudaSuccess);
  return static_cast<int>(launch_fwd_rt<double>(rows_per_thread, xs, xps, sig, diag, out, n, m,
                                                d, col_threads, batch, bs,
                                                static_cast<cudaStream_t>(stream)));
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
// the chunked kernel, which takes no plan, scratch or ticket.
int gram_bwd_rows(const float* xs, const float* xps, const float* sig, const float* g,
                  float* d_xs, float* rowsum, float* scratch, int* ticket, int n, int m, int d,
                  int lanes_per_row, int slices, int stage_cols, int chunk_cols, int batch,
                  long long xs_bs, long long xps_bs, long long sig_bs, long long g_bs,
                  long long d_xs_bs, long long rowsum_bs, void* stream) {
  const Batch bs{xs_bs, xps_bs, sig_bs, g_bs, d_xs_bs, rowsum_bs};
  return bwd_rows_entry<float>(xs, xps, sig, g, d_xs, rowsum, scratch, ticket, n, m, d,
                               lanes_per_row, slices, stage_cols, chunk_cols, batch, bs, stream);
}

// gram_bwd_rows on fp64 arrays (scratch fp64 too); past d = 32 the chunked kernel.
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
// batch strides of xs, xps, sig, g and d_xps as in gram_fwd. Past d = 64 the
// chunked kernel, which takes no plan, scratch or ticket.
int gram_bwd_cols(const float* xs, const float* xps, const float* sig, const float* g,
                  float* d_xps, float* scratch, int* ticket, int n, int m, int d,
                  int chunk_rows, int batch, long long xs_bs, long long xps_bs,
                  long long sig_bs, long long g_bs, long long d_xps_bs, void* stream) {
  const Batch bs{xs_bs, xps_bs, sig_bs, g_bs, d_xps_bs, 0};
  return bwd_cols_entry<float>(xs, xps, sig, g, d_xps, scratch, ticket, n, m, d, chunk_rows,
                               batch, bs, stream);
}

// gram_bwd_cols on fp64 arrays (scratch fp64 too); past d = 32 the chunked kernel.
int gram_bwd_cols_f64(const double* xs, const double* xps, const double* sig, const double* g,
                      double* d_xps, double* scratch, int* ticket, int n, int m, int d,
                      int chunk_rows, int batch, long long xs_bs, long long xps_bs,
                      long long sig_bs, long long g_bs, long long d_xps_bs, void* stream) {
  const Batch bs{xs_bs, xps_bs, sig_bs, g_bs, d_xps_bs, 0};
  return bwd_cols_entry<double>(xs, xps, sig, g, d_xps, scratch, ticket, n, m, d, chunk_rows,
                                batch, bs, stream);
}

}  // extern "C"
