// The small SPD factor-and-solve and its VJP, hand-written for Hopper (sm_90a).
//
// What they replace: no TPU kernel. The JAX package leaves the FITC model's
// m x m Choleskys and their solves to XLA (gpscore/models/fitc.py), and the
// port first left them to cuSOLVER and cuBLAS: chol_factor's cholesky_ex,
// where, cast, multiply and tril, a solve_triangular, and autograd's
// backward nodes of each, 37 to 54 device ops on an H100 for each of the
// three (factor, solve) pairs of a FITC step with its backward (L_uu with V,
// L_M with W, the k-fold L_Mf with its mean solve). At m = 20 each of them is
// a launch with almost no work, so the chain's time is its launches. These
// two kernels do a pair's forward in one launch and its backward in one more.
//
// chol_small_fwd_kernel: for each of a batch of SPD A [m, m] (lower triangle
// read) and B^T [k, m] (B's k columns as rows), L = chol(A) and X^T [k, m]
// with X = L^-1 B or, with `full`, X = A^-1 B = L^-T L^-1 B.
// chol_small_bwd_kernel: from L, X^T and the cotangents L_bar (or none) and
// X_bar^T (or none), B_bar^T and A_bar in closed form, with S = B_bar X^T:
//
//     B_bar = L^-T X_bar                (full: L^-T L^-1 X_bar)
//     G     = tril(L_bar) - tril(S)     (full: tril(L_bar))
//     Y     = L^-T Phi(tril(L^T G)) L^-1,   Phi: the diagonal halved
//     A_bar = (Y + Y^T) / 2             (full: minus (S + S^T) / 2)
//
// which is PyTorch's cholesky backward of L_bar plus the triangular solves'
// adjoints folded into it; A_bar is exactly symmetric.
//
// What bounds them: latency. A FITC-20 pair is 400 elements of A, and B of
// 20 x 500: ~0.2 MFLOP and ~80 KB, under a microsecond of the card's rates;
// every step of a factor or a substitution depends on the one before. So
// one block does one matrix's whole chain on chip, with no device round
// trip between its stages, and each chain is kept short:
// - a row being solved lives in registers and the substitutions go by
//   columns: x_j is final, then leaves its part in every later x_i at once,
//   the update and a shift of the row's registers one FMA each, so a chain
//   is ~2 m steps long, the loop over columns stays rolled and every
//   register index is static. (Each kernel runs its code once a launch:
//   fully unrolled bodies, tens of KB of straight-line code, ran slower
//   from the instruction fetch than these loops; a guard on each update
//   cost a basic block, and a load's latency, an update.) The factor is
//   kept in the orders the solves read it (C, R below), zero-padded to MB =
//   m rounded up to 8, so a column's or a row's entries come by 16-byte
//   loads at fixed offsets, and a division is a multiply by the diagonal's
//   reciprocal, kept with them;
// - the factor is right-looking in one warp (m <= kCsMaxM = 32), lane i
//   holding row i in registers, column j passed through C; the rest of the
//   block waits at one barrier;
// - the substitutions take B's k columns in parallel, one thread a column,
//   in tiles of tile_rows columns staged in shared memory by coalesced
//   copies. The forward spreads a matrix's tiles over blocks (grid.x),
//   each factoring its own copy of A (bitwise the same factor; block 0
//   writes L), so a fit's one 20 x 500 solve is 2 blocks and not 2 trips;
// - the backward's S = B_bar X^T sums over k in one block (tile by tile,
//   each entry (i, l) by one thread into shared memory, in ascending column
//   order in four interleaved partial sums), so its order, and A_bar, are
//   fixed: two launches on the same inputs give the same bits, and a CUDA
//   graph replays them.
// Both keep the shared-memory pitch odd (m + 1 or m + 2), so a warp's
// threads on rows i..i+31 of one column hit distinct banks (fp32).
//
// Precision: IEEE fp32 (or fp64) throughout: fma, correctly rounded sqrt
// and reciprocal (no fast-math), nothing stored in fewer bits; nothing runs
// on the tensor cores (no TF32 question).
//
// Failure, as chol_factor (ops/linalg.py) and jnp.linalg.cholesky: a matrix
// whose pivot is not > 0 (or NaN) gets a factor of NaN on and below the
// diagonal and 0 above, and an X of NaN; its backward is NaN (every
// substitution multiplies by the NaN diagonal's reciprocal). Its neighbours
// in the batch are untouched.
//
// Layout: every array row-major and contiguous, one matrix after another
// (A and L at a stride of m * m, B^T and X^T of k * m); the batch on grid.y
// (at most 65,535 a launch; ops/linalg.py chunks a larger one). Every entry
// point launches on the caller's stream and returns cudaGetLastError().

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kCsMaxM = 32;       // largest m the kernels take: a warp's lanes own the rows
constexpr int kCsThreads = 256;   // threads a block, both kernels
constexpr size_t kCsMaxSmem = 232448;  // a block's shared memory on an H100
constexpr unsigned kCsLanes = 0xffffffffu;

__host__ __device__ inline int cs_pitch(int m) { return m + 1 + (m & 1); }
__host__ __device__ inline int cs_bucket(int m) { return (m + 7) / 8 * 8; }  // MB

template <typename T>
__device__ inline T cs_nan();
template <>
__device__ inline float cs_nan<float>() { return __int_as_float(0x7fffffff); }
template <>
__device__ inline double cs_nan<double>() { return __longlong_as_double(0x7fffffffffffffffLL); }

__device__ inline float cs_rcp(float x) { return __frcp_rn(x); }
__device__ inline double cs_rcp(double x) { return __drcp_rn(x); }

template <typename T>
struct CsVec;
template <>
struct CsVec<float> {
  using type = float4;
};
template <>
struct CsVec<double> {
  using type = double2;
};

// v <- src[0, MB), src 16-byte aligned: 16-byte loads.
template <typename T, int MB>
__device__ inline void cs_get_vec(T (&v)[MB], const T* src) {
  using V = typename CsVec<T>::type;
  constexpr int n = sizeof(V) / sizeof(T);
#pragma unroll
  for (int q = 0; q < MB; q += n) {
    const V w = *reinterpret_cast<const V*>(src + q);
    v[q] = w.x;
    v[q + 1] = w.y;
    if constexpr (n == 4) {
      v[q + 2] = w.z;
      v[q + 3] = w.w;
    }
  }
}

// Shared memory of each kernel, in elements. Both start with the factor in
// the orders its solves read it, rows of MB = cs_bucket(m) elements, 0 past
// the triangle:
//   C[j] = (1 / L_jj, L_{j+1,j}, L_{j+2,j}, ...), column j from the diagonal down;
//   R[i] = (1 / L_ii, L_{i,i-1}, L_{i,i-2}, ...), row i from the diagonal left;
//   D = (L_00, L_11, ...) in one row more.
// Then the forward's tile of columns (pitch p), or the backward's S (m rows
// of pitch p) and its two tiles (X_bar^T solved in place into B_bar^T, and
// X^T) while it sums S, and two m x m buffers (G, Phi) in their space after.
inline size_t cs_fwd_elems(int m, int tile_rows) {
  const size_t mb = cs_bucket(m);
  return mb * (2 * m + 1) + static_cast<size_t>(cs_pitch(m)) * tile_rows;
}
inline size_t cs_bwd_elems(int m, int tile_rows) {
  const size_t mb = cs_bucket(m), p = cs_pitch(m);
  const size_t tiles = 2 * p * tile_rows, mats = 2 * p * m;
  return mb * (2 * m + 1) + p * m + (tiles > mats ? tiles : mats);
}

// f(e, r, c) for the elements e = r * m + c of `rows` rows of m, the block's
// threads at a stride of blockDim.x, (r, c) stepped without a division.
template <typename F>
__device__ inline void cs_each(int rows, int m, F&& f) {
  const int dr = blockDim.x / m, dc = blockDim.x - dr * m;
  int r = threadIdx.x / m, c = threadIdx.x - r * m;
  for (int e = threadIdx.x; e < rows * m; e += blockDim.x) {
    f(e, r, c);
    r += dr;
    c += dc;
    if (c >= m) {
      c -= m;
      ++r;
    }
  }
}

// Copy `rows` rows of a [*, m] array into a tile of pitch p by asynchronous
// copies (cp.async), all in flight at once, which cs_wait_loads completes for
// the block; and back, by plain stores.
template <typename T>
__device__ inline void cs_load_tile(T* tile, const T* src, int rows, int m, int p) {
  cs_each(rows, m, [&](int e, int r, int c) {
    __pipeline_memcpy_async(tile + r * p + c, src + e, sizeof(T));
  });
}
__device__ inline void cs_wait_loads() {
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
}
template <typename T>
__device__ inline void cs_store_tile(T* dst, const T* tile, int rows, int m, int p, bool nan) {
  cs_each(rows, m, [&](int e, int r, int c) { dst[e] = nan ? cs_nan<T>() : tile[r * p + c]; });
}

// Factor A's lower triangle (device memory) into C, R and D (zeroed before),
// with warp 0, lane i holding row i in registers; returns, to every thread of
// the block, whether a pivot failed. At column j, a[q] holds the lane's
// entry in column j + q: the pivot comes by a shuffle from lane j, the lanes
// below it scale their entry by its reciprocal and write it to C and R, and,
// column j read back from C, the rank-1 update of column j + q and the shift
// to a[q - 1] are one FMA. So every entry's sum runs in ascending j.
template <typename T, int MB>
__device__ bool cs_factor(const T* A, T* C, T* R, T* D, int m, int* flag) {
  if (threadIdx.x < 32) {
    const int i = threadIdx.x;
    const bool mine = i < m;
    T a[MB];
#pragma unroll
    for (int q = 0; q < MB; ++q) a[q] = (mine && q <= i) ? A[i * m + q] : T(0);
    bool bad = false;
    for (int j = 0; j < m; ++j) {
      const T d = __shfl_sync(kCsLanes, a[0], j);
      bad |= !(d > T(0));
      const T piv = sqrt(d);
      const T rp = cs_rcp(piv);
      const T lij = i > j ? a[0] * rp : T(0);
      if (mine && i > j) {
        C[j * MB + i - j] = lij;
        R[i * MB + i - j] = lij;
      } else if (i == j) {
        C[j * MB] = rp;
        R[j * MB] = rp;
        D[j] = piv;
      }
      __syncwarp();
      T c[MB];
      cs_get_vec(c, C + j * MB);
#pragma unroll
      for (int q = 1; q < MB; ++q) a[q - 1] = fma(-lij, c[q], a[q]);
    }
    if (i == 0) *flag = bad;
  }
  __syncthreads();
  return *flag != 0;
}

// x <- L^-1 x (forward substitution) by columns, x a row or column of a
// shared-memory array (stride `stride`), held in registers: at column j,
// y[q] holds x[j + q]; x_j = y[0] / L_jj is final and written back, and its
// part leaves every later entry at once, each update and its shift one FMA.
template <typename T, int MB>
__device__ inline void cs_lower_solve(const T* C, int m, T* x, int stride = 1) {
  T y[MB];
#pragma unroll
  for (int q = 0; q < MB; ++q) y[q] = q < m ? x[q * stride] : T(0);
  for (int j = 0; j < m; ++j) {
    T c[MB];
    cs_get_vec(c, C + j * MB);
    const T xj = y[0] * c[0];
    x[j * stride] = xj;
#pragma unroll
    for (int q = 1; q < MB; ++q) y[q - 1] = fma(-c[q], xj, y[q]);
  }
}

// x <- L^-T x (back substitution) by columns of L^T from the last: at row
// i, y[q] holds x[i - q].
template <typename T, int MB>
__device__ inline void cs_upper_solve(const T* R, int m, T* x, int stride = 1) {
  T y[MB];
#pragma unroll
  for (int q = 0; q < MB; ++q) y[q] = q < m ? x[(m - 1 - q) * stride] : T(0);
  for (int i = m - 1; i >= 0; --i) {
    T r[MB];
    cs_get_vec(r, R + i * MB);
    const T xi = y[0] * r[0];
    x[i * stride] = xi;
#pragma unroll
    for (int q = 1; q < MB; ++q) y[q - 1] = fma(-r[q], xi, y[q]);
  }
}

// Block (x, y): matrix y's columns [x * tile_rows, (x + 1) * tile_rows) of B.
template <typename T, int MB>
__global__ void __launch_bounds__(kCsThreads)
chol_small_fwd_kernel(const T* __restrict__ A, const T* __restrict__ Bt, T* __restrict__ L,
                      T* __restrict__ Xt, int m, int k, int full, int tile_rows) {
  extern __shared__ __align__(16) unsigned char cs_fwd_smem[];
  __shared__ int flag;
  const int p = cs_pitch(m);
  T* C = reinterpret_cast<T*>(cs_fwd_smem);
  T* R = C + m * MB;
  T* D = R + m * MB;
  T* tile = D + MB;
  const size_t mat = blockIdx.y;
  A += mat * m * m;
  L += mat * m * m;
  const int c0 = blockIdx.x * tile_rows;
  const int rows = min(tile_rows, k - c0);  // < 1 only where k == 0
  const size_t off = (mat * k + c0) * m;
  if (rows > 0) cs_load_tile(tile, Bt + off, rows, m, p);
  for (int e = threadIdx.x; e < 2 * m * MB; e += blockDim.x) C[e] = T(0);  // C and R
  __syncthreads();
  const bool failed = cs_factor<T, MB>(A, C, R, D, m, &flag);
  cs_wait_loads();
  if (blockIdx.x == 0) {
    cs_each(m, m, [&](int e, int i, int j) {
      L[e] = j > i ? T(0) : failed ? cs_nan<T>() : i == j ? D[i] : C[j * MB + i - j];
    });
  }
  if (rows <= 0) return;
  if (threadIdx.x < rows) {
    T* x = tile + threadIdx.x * p;
    cs_lower_solve<T, MB>(C, m, x);
    if (full) cs_upper_solve<T, MB>(R, m, x);
  }
  __syncthreads();
  cs_store_tile(Xt + off, tile, rows, m, p, failed);
}

// Entry e of the lower triangle, row by row: (i, l) with e = i (i + 1) / 2 + l.
__device__ inline void cs_tri_index(int e, int& i, int& l) {
  i = static_cast<int>((sqrtf(8.0f * e + 1.0f) - 1.0f) * 0.5f);
  while (i * (i + 1) / 2 > e) --i;
  while ((i + 1) * (i + 2) / 2 <= e) ++i;
  l = e - i * (i + 1) / 2;
}

// Block y: matrix y's whole backward (see the note at the top).
template <typename T, int MB>
__global__ void __launch_bounds__(kCsThreads)
chol_small_bwd_kernel(const T* __restrict__ L, const T* __restrict__ Xt,
                      const T* __restrict__ Lbar, const T* __restrict__ Xbart,
                      T* __restrict__ Abar, T* __restrict__ Bbart, int m, int k, int full,
                      int tile_rows) {
  extern __shared__ __align__(16) unsigned char cs_bwd_smem[];
  const int p = cs_pitch(m);
  const size_t mp = static_cast<size_t>(m) * p;
  T* C = reinterpret_cast<T*>(cs_bwd_smem);
  T* R = C + m * MB;
  T* D = R + m * MB;
  T* Sm = D + MB;       // S = B_bar X^T, summed tile by tile
  T* region = Sm + mp;  // the two tiles, then G and Phi
  const size_t mat = blockIdx.y;
  L += mat * m * m;
  Abar += mat * m * m;
  if (Lbar != nullptr) Lbar += mat * m * m;
  for (int e = threadIdx.x; e < m * MB; e += blockDim.x) {
    const int j = e / MB, q = e - j * MB;
    const T diag = L[j * (m + 1)];
    C[e] = q == 0 ? cs_rcp(diag) : j + q < m ? L[(j + q) * m + j] : T(0);
    R[e] = q == 0 ? cs_rcp(diag) : q <= j ? L[j * m + j - q] : T(0);
    if (q == 0) D[j] = diag;
  }
  cs_each(m, m, [&](int, int i, int j) { Sm[i * p + j] = T(0); });
  __syncthreads();

  // The entries of S summed: its lower triangle, or (full) all of it; each
  // entry by one thread, over the columns in ascending order, in four
  // interleaved partial sums (rows r, r + 4 in one).
  const int npairs = full ? m * m : m * (m + 1) / 2;
  if (Xbart != nullptr) {
    T* tb = region;                                       // X_bar^T, solved into B_bar^T
    T* tx = region + static_cast<size_t>(tile_rows) * p;  // X^T
    for (int c0 = 0; c0 < k; c0 += tile_rows) {
      const int rows = min(tile_rows, k - c0);
      const size_t off = (mat * k + c0) * m;
      cs_load_tile(tb, Xbart + off, rows, m, p);
      cs_load_tile(tx, Xt + off, rows, m, p);
      cs_wait_loads();
      if (threadIdx.x < rows) {
        T* x = tb + threadIdx.x * p;
        if (full) cs_lower_solve<T, MB>(C, m, x);
        cs_upper_solve<T, MB>(R, m, x);
      }
      __syncthreads();
      cs_store_tile(Bbart + off, tb, rows, m, p, false);
      for (int e = threadIdx.x; e < npairs; e += blockDim.x) {
        int i, l;
        if (full) {
          i = e / m;
          l = e - i * m;
        } else {
          cs_tri_index(e, i, l);
        }
        const T* bi = tb + i;
        const T* xl = tx + l;
        T s0 = T(0), s1 = T(0), s2 = T(0), s3 = T(0);
        int r = 0;
        for (; r + 8 <= rows; r += 8) {
          const T* b = bi + r * p;
          const T* x = xl + r * p;
          s0 = fma(b[0], x[0], s0);
          s1 = fma(b[p], x[p], s1);
          s2 = fma(b[2 * p], x[2 * p], s2);
          s3 = fma(b[3 * p], x[3 * p], s3);
          s0 = fma(b[4 * p], x[4 * p], s0);
          s1 = fma(b[5 * p], x[5 * p], s1);
          s2 = fma(b[6 * p], x[6 * p], s2);
          s3 = fma(b[7 * p], x[7 * p], s3);
        }
        for (; r < rows; ++r) s0 = fma(bi[r * p], xl[r * p], s0);
        Sm[i * p + l] += (s0 + s1) + (s2 + s3);
      }
      __syncthreads();
    }
  }

  T* G = region;  // tril(L_bar) - tril(S), or (full) tril(L_bar)
  T* P = G + mp;  // Phi(tril(L^T G)), then Z, then Y
  cs_each(m, m, [&](int e, int i, int j) {
    T g = (j <= i && Lbar != nullptr) ? Lbar[e] : T(0);
    if (j <= i && !full) g -= Sm[i * p + j];
    G[i * p + j] = g;
  });
  __syncthreads();
  // Phi(tril(L^T G)): (i, j), i >= j, sums L[r][i] G[r][j] over r >= i
  // (column i of L is D[i] and C[i] past its head).
  cs_each(m, m, [&](int, int i, int j) {
    T s = T(0);
    if (j <= i) {
      const T* c = C + i * MB;
      s = D[i] * G[i * p + j];
      for (int q = 1; i + q < m; ++q) s = fma(c[q], G[(i + q) * p + j], s);
      if (i == j) s = s * T(0.5);
    }
    P[i * p + j] = s;
  });
  __syncthreads();
  // Z = Phi L^-1, row i by thread i: each row is L^-T applied to it (Z is
  // lower triangular: the entries past i stay 0), in place.
  if (threadIdx.x < m) cs_upper_solve<T, MB>(R, m, P + threadIdx.x * p);
  __syncthreads();
  // Y = L^-T Z, column c by thread c, in place.
  if (threadIdx.x < m) cs_upper_solve<T, MB>(R, m, P + threadIdx.x, p);
  __syncthreads();
  cs_each(m, m, [&](int e, int i, int j) {
    T a = T(0.5) * (P[i * p + j] + P[j * p + i]);
    if (full) a -= T(0.5) * (Sm[i * p + j] + Sm[j * p + i]);
    Abar[e] = a;
  });
}

template <typename Kernel>
cudaError_t cs_allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

bool cs_bad(int m, int k, int full, int tile_rows, int batch) {
  return m < 1 || m > kCsMaxM || k < 0 || (full != 0 && full != 1) || tile_rows < 1 ||
         tile_rows > kCsThreads || batch < 0 || batch > 65535;
}

template <typename T>
int fwd_entry(const T* A, const T* Bt, T* L, T* Xt, int m, int k, int full, int tile_rows,
              int batch, void* stream) {
  const size_t smem = cs_fwd_elems(m, tile_rows) * sizeof(T);
  if (cs_bad(m, k, full, tile_rows, batch) || smem > kCsMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return static_cast<int>(cudaSuccess);
  const auto kernel = m <= 8 ? chol_small_fwd_kernel<T, 8>
                      : m <= 16 ? chol_small_fwd_kernel<T, 16>
                      : m <= 24 ? chol_small_fwd_kernel<T, 24>
                                : chol_small_fwd_kernel<T, 32>;
  const cudaError_t err = cs_allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(k > 0 ? (k + tile_rows - 1) / tile_rows : 1, batch);
  kernel<<<grid, kCsThreads, smem, static_cast<cudaStream_t>(stream)>>>(A, Bt, L, Xt, m, k, full,
                                                                         tile_rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd_entry(const T* L, const T* Xt, const T* Lbar, const T* Xbart, T* Abar, T* Bbart, int m,
              int k, int full, int tile_rows, int batch, void* stream) {
  const size_t smem = cs_bwd_elems(m, tile_rows) * sizeof(T);
  if (cs_bad(m, k, full, tile_rows, batch) || smem > kCsMaxSmem ||
      (Xbart == nullptr) != (Bbart == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return static_cast<int>(cudaSuccess);
  const auto kernel = m <= 8 ? chol_small_bwd_kernel<T, 8>
                      : m <= 16 ? chol_small_bwd_kernel<T, 16>
                      : m <= 24 ? chol_small_bwd_kernel<T, 24>
                                : chol_small_bwd_kernel<T, 32>;
  const cudaError_t err = cs_allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(1, batch), kCsThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      L, Xt, Lbar, Xbart, Abar, Bbart, m, k, full, tile_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// L [batch, m, m] = chol(A) of the lower triangle of A [batch, m, m], and
// Xt [batch, k, m] = (L^-1 B)^T, or with full = 1 (A^-1 B)^T, from
// Bt [batch, k, m] = B^T. 1 <= m <= 32; tile_rows (1 to 256) columns of B a
// block, as ops/linalg.py::chol_small_tile_rows picks them.
int chol_small_fwd(const float* A, const float* Bt, float* L, float* Xt, int m, int k, int full,
                   int tile_rows, int batch, void* stream) {
  return fwd_entry<float>(A, Bt, L, Xt, m, k, full, tile_rows, batch, stream);
}

int chol_small_fwd_f64(const double* A, const double* Bt, double* L, double* Xt, int m, int k,
                       int full, int tile_rows, int batch, void* stream) {
  return fwd_entry<double>(A, Bt, L, Xt, m, k, full, tile_rows, batch, stream);
}

// Abar [batch, m, m] and Bbart [batch, k, m] = B_bar^T from the forward's L
// and Xt and the cotangents Lbar [batch, m, m] (null: zero) and Xbart
// [batch, k, m] = X_bar^T (null: zero; Bbart is then null too and not
// written). The same m, k, full and tile_rows as chol_small_fwd's.
int chol_small_bwd(const float* L, const float* Xt, const float* Lbar, const float* Xbart,
                   float* Abar, float* Bbart, int m, int k, int full, int tile_rows, int batch,
                   void* stream) {
  return bwd_entry<float>(L, Xt, Lbar, Xbart, Abar, Bbart, m, k, full, tile_rows, batch, stream);
}

int chol_small_bwd_f64(const double* L, const double* Xt, const double* Lbar,
                       const double* Xbart, double* Abar, double* Bbart, int m, int k, int full,
                       int tile_rows, int batch, void* stream) {
  return bwd_entry<double>(L, Xt, Lbar, Xbart, Abar, Bbart, m, k, full, tile_rows, batch,
                           stream);
}

}  // extern "C"
