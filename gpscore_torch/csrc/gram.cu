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
// What bounds them on this card: at the main path's Grams (500 x 20 and
// 20 x 20, d = 8) a launch has ~10^4 outputs, far too little work to fill 132
// SMs, so they are bound by launch latency. At large n the forward is bound by
// the n * m * 4 bytes it writes; each output is written exactly once.
//
// What the design does about it:
// - Direct-difference form, not the cross-term 2 x.x' - |x|^2 - |x'|^2. With
//   d <= 64 it costs the same FMAs without tensor cores (so there is no TF32
//   question), it has no cancellation, and it gives an exactly symmetric
//   K(u, u) and an exact sig diagonal.
// - The backward keeps K and W = g * K out of device memory: it recomputes K,
//   forms W on the fly and reduces in a fixed order, so the result is
//   bitwise the same from run to run. gram_bwd_rows gives each row of K a
//   warp and reduces with warp shuffles; gram_bwd_cols has its own note below.
//
// All arrays are row-major, contiguous fp32; sig is a device scalar, so no
// launch needs a host sync. Every entry point launches on the caller's stream
// and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMaxD = 64;
constexpr int kTile = 32;                        // forward output tile, kTile x kTile
constexpr int kBlockRows = 8;                    // forward block is kTile x kBlockRows threads
constexpr int kWarpsPerBlock = 8;                // backward: one warp per row / row group
constexpr int kThreads = 32 * kWarpsPerBlock;
constexpr int kColsTile = 32;                    // gram_bwd_cols: columns per block, one per lane
constexpr int kColsStageRows = 64;               // gram_bwd_cols: rows per shared-memory stage
constexpr int kSumBatch = 32;                    // gram_bwd_cols: chunk partials loaded at once
constexpr unsigned kFullMask = 0xffffffffu;

__global__ void __launch_bounds__(kTile * kBlockRows)
gram_fwd_kernel(const float* __restrict__ xs, const float* __restrict__ xps,
                const float* __restrict__ sig, float* __restrict__ out,
                int n, int m, int d) {
  extern __shared__ float smem[];
  // Odd row stride: the 32 threads of a warp read 32 different xps rows at
  // the same k, and an odd stride puts them in 32 different banks.
  const int stride = d | 1;
  float* sx = smem;                     // [kTile][stride] rows of xs
  float* sxp = smem + kTile * stride;   // [kTile][stride] rows of xps
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  const int tid = threadIdx.y * kTile + threadIdx.x;
  for (int e = tid; e < kTile * d; e += kTile * kBlockRows) {
    const int r = e / d;
    const int k = e - r * d;
    const int i = row0 + r;
    const int j = col0 + r;
    sx[r * stride + k] = (i < n) ? xs[(size_t)i * d + k] : 0.f;
    sxp[r * stride + k] = (j < m) ? xps[(size_t)j * d + k] : 0.f;
  }
  __syncthreads();
  const int j = col0 + threadIdx.x;
  if (j >= m) return;
  const float s = *sig;
  const float* xpj = sxp + threadIdx.x * stride;
  for (int r = threadIdx.y; r < kTile; r += kBlockRows) {
    const int i = row0 + r;
    if (i >= n) break;
    const float* xi = sx + r * stride;
    float d2 = 0.f;
    for (int k = 0; k < d; ++k) {
      const float t = xi[k] - xpj[k];
      d2 = fmaf(t, t, d2);
    }
    // Neighbouring threads write neighbouring columns: coalesced stores.
    out[(size_t)i * m + j] = s * expf(-0.5f * d2);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

// One warp per row i of K: d_xs_i = sum_j W_ij (xps_j - xs_i) and
// rowsum_i = sum_j W_ij, with W_ij = g_ij K_ij recomputed, never stored.
// DMAX is d rounded up to a register-array bucket.
template <int DMAX>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
gram_bwd_rows_kernel(const float* __restrict__ xs, const float* __restrict__ xps,
                     const float* __restrict__ sig, const float* __restrict__ g,
                     float* __restrict__ d_xs, float* __restrict__ rowsum,
                     int n, int m, int d) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (i >= n) return;  // uniform across the warp: the shuffles below stay full-warp
  const float s = *sig;
  float xi[DMAX];
  float acc[DMAX];
#pragma unroll
  for (int k = 0; k < DMAX; ++k) {
    xi[k] = (k < d) ? xs[(size_t)i * d + k] : 0.f;
    acc[k] = 0.f;
  }
  float rs = 0.f;
  for (int j = lane; j < m; j += 32) {
    const float* xpj = xps + (size_t)j * d;
    float d2 = 0.f;
#pragma unroll
    for (int k = 0; k < DMAX; ++k) {
      if (k < d) {
        const float t = xi[k] - xpj[k];
        d2 = fmaf(t, t, d2);
      }
    }
    const float w = g[(size_t)i * m + j] * (s * expf(-0.5f * d2));
    rs += w;
#pragma unroll
    for (int k = 0; k < DMAX; ++k) {
      if (k < d) acc[k] = fmaf(w, xpj[k] - xi[k], acc[k]);
    }
  }
  rs = warp_sum(rs);
#pragma unroll
  for (int k = 0; k < DMAX; ++k) {
    if (k < d) acc[k] = warp_sum(acc[k]);
  }
  if (lane == 0) {
    rowsum[i] = rs;
#pragma unroll
    for (int k = 0; k < DMAX; ++k) {
      if (k < d) d_xs[(size_t)i * d + k] = acc[k];
    }
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

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

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
template <int DMAX>
__global__ void __launch_bounds__(kThreads, 1)
gram_bwd_cols_kernel(const float* __restrict__ xs, const float* __restrict__ xps,
                     const float* __restrict__ sig, const float* __restrict__ g,
                     float* __restrict__ d_xps, float* __restrict__ scratch,
                     int* __restrict__ ticket, int n, int m, int d, int chunk_rows) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int is_last;
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

template <int DMAX>
void launch_bwd_rows(const float* xs, const float* xps, const float* sig, const float* g,
                     float* d_xs, float* rowsum, int n, int m, int d, cudaStream_t stream) {
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  gram_bwd_rows_kernel<DMAX><<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(
      xs, xps, sig, g, d_xs, rowsum, n, m, d);
}

template <int DMAX>
cudaError_t launch_bwd_cols(const float* xs, const float* xps, const float* sig, const float* g,
                            float* d_xps, float* scratch, int* ticket, int n, int m, int d,
                            int chunk_rows, int n_chunks, cudaStream_t stream) {
  constexpr int kMaxSmem = bwd_cols_smem_floats(DMAX) * static_cast<int>(sizeof(float));
  if (kMaxSmem > 48 * 1024) {  // above 48 KB only when asked for (the d > 32 bucket)
    const cudaError_t err = cudaFuncSetAttribute(
        gram_bwd_cols_kernel<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((m + kColsTile - 1) / kColsTile, n_chunks);
  const size_t smem = bwd_cols_smem_floats(d) * sizeof(float);
  gram_bwd_cols_kernel<DMAX><<<grid, kThreads, smem, stream>>>(
      xs, xps, sig, g, d_xps, scratch, ticket, n, m, d, chunk_rows);
  return cudaGetLastError();
}

bool bad_shape(int n, int m, int d) { return n < 0 || m < 0 || d < 1 || d > kMaxD; }

}  // namespace

extern "C" {

// out[n, m] = sig * exp(-1/2 |xs_i - xps_j|^2); xs [n, d], xps [m, d], sig [1].
int gram_fwd(const float* xs, const float* xps, const float* sig, float* out,
             int n, int m, int d, void* stream) {
  if (bad_shape(n, m, d)) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || m == 0) return static_cast<int>(cudaSuccess);
  const dim3 block(kTile, kBlockRows);
  const dim3 grid((m + kTile - 1) / kTile, (n + kTile - 1) / kTile);
  const size_t smem = 2 * kTile * (d | 1) * sizeof(float);
  gram_fwd_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      xs, xps, sig, out, n, m, d);
  return static_cast<int>(cudaGetLastError());
}

// d_xs[n, d] = sum_j W_ij (xps_j - xs_i), rowsum[n] = sum_j W_ij, W = g * K;
// g [n, m] is the cotangent of K.
int gram_bwd_rows(const float* xs, const float* xps, const float* sig, const float* g,
                  float* d_xs, float* rowsum, int n, int m, int d, void* stream) {
  if (bad_shape(n, m, d)) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 8) launch_bwd_rows<8>(xs, xps, sig, g, d_xs, rowsum, n, m, d, s);
  else if (d <= 16) launch_bwd_rows<16>(xs, xps, sig, g, d_xs, rowsum, n, m, d, s);
  else if (d <= 32) launch_bwd_rows<32>(xs, xps, sig, g, d_xs, rowsum, n, m, d, s);
  else launch_bwd_rows<64>(xs, xps, sig, g, d_xs, rowsum, n, m, d, s);
  return static_cast<int>(cudaGetLastError());
}

// d_xps[m, d] = sum_i W_ij (xs_i - xps_j), W = g * K, in one launch.
// chunk_rows (a multiple of 64) is the rows of K a block reduces. With more
// than one chunk, scratch holds [ceil(n / chunk_rows), m, d] floats and ticket
// ceil(m / 32) ints that are 0 at the launch and are 0 again after it; calls
// that share a ticket array must be ordered (one stream).
int gram_bwd_cols(const float* xs, const float* xps, const float* sig, const float* g,
                  float* d_xps, float* scratch, int* ticket, int n, int m, int d,
                  int chunk_rows, void* stream) {
  if (bad_shape(n, m, d) || chunk_rows < 1 || chunk_rows % kColsStageRows != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return static_cast<int>(cudaSuccess);
  const int n_chunks = n > 0 ? (n - 1) / chunk_rows + 1 : 1;
  if (n_chunks > 65535 || (n_chunks > 1 && (scratch == nullptr || ticket == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto launch = d <= 8 ? launch_bwd_cols<8>
                      : d <= 16 ? launch_bwd_cols<16>
                      : d <= 32 ? launch_bwd_cols<32>
                      : launch_bwd_cols<64>;
  return static_cast<int>(launch(xs, xps, sig, g, d_xps, scratch, ticket, n, m, d, chunk_rows,
                                 n_chunks, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
