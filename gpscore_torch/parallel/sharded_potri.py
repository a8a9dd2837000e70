"""In-place mesh-sharded Gram -> K_hat^-1 (potri) and the streamed ARD
backward (port of `gpscore/parallel/sharded_potri.py`).

The out-of-place distributed stack (:mod:`~gpscore_torch.parallel.sharded_loo`)
holds K_hat, L, L^-1 and K_hat^-1 as separate [n/p, n] arrays and its
backward K_bar beside them: ~3 n^2/p a rank. Here one [n/p, n] buffer per
rank carries K_hat -> L -> L^-1 -> K_hat^-1, the single-device in-place
pipeline (:mod:`gpscore_torch.ops.potri_inplace`) on the row shard, and the
backward streams the parameter contraction over global row blocks into O(d)
sums (:func:`gpscore_torch.ops.loo_fused._stream_param_grads` on a rank's
columns). Peak a rank: n^2/p + O(n * block).

Rank q of 'data' holds rows R_q = [q n/p, (q + 1) n/p) of the buffer W.
The stages, each a Python loop over the column panels of width ``block``
that updates views of W in place; every rank issues every collective of a
panel in the same order, also a rank with no rows left to update:

1. :func:`_gram_rows`: K_hat's rows, the Gram kernel on the local rows; a
   2-byte W takes [block, n] panels, each rounded once from the kernel's
   fp32 value plus the noise (``gram_fwd``'s ``diag_add``).
2. :func:`_chol`: the left-looking Cholesky. Per pivot panel, the owner of
   its rows **broadcasts** their L left of the panel (the band [b, kb]);
   every rank takes the left update of its rows at or below the panel, one
   GEMM per earlier panel (the single-device rule: one fp32 GEMM over all
   earlier columns lost an order of magnitude against float64), into an
   fp32 panel; the owner **broadcasts** the pivot block [b, b], every rank
   factors it (cuSOLVER), solves its rows and stores them once.
3. :func:`_tri_inv`: L^-1, right to left. Per panel the column strip of L
   is **all-gathered** ([n/p, b] a rank -> [n, b]) before any rank
   overwrites it; each rank sums X[r, c] L[c, s] over the nonzero column
   panels c of its rows below the panel, one GEMM per panel, and stores
   -acc X_ss once.
4. :func:`_lauum`: K_hat^-1 = L^-T L^-1. Per panel each rank adds its rows'
   X[r, s:e]^T X[r, s:] to B^T [b, n - s] (rows at or below the panel, one
   GEMM per row block), the partial sums are **all-reduced**, and each rank
   writes its rows of the lower column panel and the owner the mirrored row
   band.

FLOPs are exact: rows above a panel are skipped, not masked. JAX runs the
stages as ``fori`` loops over [b, b] blocks to bound its trace
(`sharded_potri.py:37-45`); on a card those would be ~k^3/6 tiny launches a
stage (k = n/b), so each product here is as wide as the rank's active rows.
A stage at p = 1 issues its collectives on the one-rank group as at any p.

The backward (:func:`make_streamed_ard_bwd`) forms, per global row block B
of ``block`` rows, the block's columns R_q of K_hat_bar ([b, n/p]) on each
rank: the LOO and k-fold sandwich terms as this rank's partial sum over its
rows of K^-1 ([b, n]) **reduce-scattered** to the column owners, the NLML
term straight off the local rows (K^-1 is symmetric). Each [b, n/p] block is
the cotangent of K(x_B, x_loc), which the two Gram backward kernels contract
(``gram_cuda.gram_bwd``) in ``_stream_param_grads``, and the O(d) sums are
all-reduced once at the end.

Storage: ``storage`` float32 (default), bfloat16 or float16, as in
:mod:`gpscore_torch.ops.potri_inplace`: every stored block rounded once
from an fp32 accumulator, the leaf factors and solves fp32, the bands and
strips sent in the storage dtype, B^T summed in fp32.
"""

from __future__ import annotations

import torch

from gpscore_torch.ops import gram_cuda, linalg
from gpscore_torch.ops.loo_fused import _param_grads, _stream_param_grads, _w
from gpscore_torch.ops.potri_inplace import _storage
from gpscore_torch.parallel.mesh import (Mesh, all_reduce_sum, broadcast, gather_rows,
                                         reduce_scatter_sum)
from gpscore_torch.utils.precision import TWO_BYTE, acc_dtype, addmm_, matmul, matmul_acc32, upcast


def _check_divisible(n: int, p: int, block: int) -> int:
    """Rows a rank: n must divide by p * block (JAX's message)."""
    rows_per = n // p
    if n % p or rows_per % block:
        raise ValueError(f"n={n} must be divisible by devices*block={p}*{block}")
    return rows_per


def _gram_rows(xs, row0: int, rows_per: int, sig, noise, st, block: int):
    """Stage 1: this rank's rows of K_hat = K(x, x) + noise I, [rows_per, n]
    in ``st``, from the scaled inputs ``xs`` [n, d]."""
    xs_loc = xs[row0:row0 + rows_per]
    if st == torch.float32:
        W = gram_cuda.gram_fwd(xs_loc, xs, sig)
        W.diagonal(offset=row0).add_(noise)
        return W
    W = xs.new_empty((rows_per, xs.shape[0]), dtype=st)
    for s in range(0, rows_per, block):
        g0 = row0 + s
        xb = xs[g0:g0 + block]
        # Against xps = xs[g0:] the kernel's i == j is the global diagonal.
        W[s:s + block, g0:] = gram_cuda.gram_fwd(xb, xs[g0:], sig, out_dtype=st, diag_add=noise)
        if g0:
            W[s:s + block, :g0] = gram_cuda.gram_fwd(xb, xs[:g0], sig, out_dtype=st)
    return W


def _chol(W, row0: int, mesh: Mesh, axis: str, block: int):
    """Stage 2: W (this rank's rows of K_hat) <- its rows of L, strict upper
    zero; returns the half log-det (the same on every rank)."""
    rows_per, n = W.shape
    stored = W.dtype in TWO_BYTE
    me = mesh.index(axis)
    hld = W.new_zeros((), dtype=acc_dtype(W.dtype))
    for kb in range(0, n, block):
        e = kb + block
        owner, off = divmod(kb, rows_per)
        lo = min(max(kb - row0, 0), rows_per)  # the first local row at or below the panel
        if kb:  # the pivot rows' L left of the panel
            band = (W[off:off + block, :kb].contiguous() if me == owner
                    else W.new_empty((block, kb)))
            broadcast(band, owner, mesh, axis)
        P = upcast(W[lo:, kb:e])  # a view of an fp32 W; an fp32 copy of a 2-byte one
        for c in range(0, kb, block):
            addmm_(P, W[lo:, c:c + block], band[:, c:c + block].T, alpha=-1.0, crit=True)
        D = P[:block].contiguous() if me == owner else P.new_empty((block, block))
        Lkk = linalg.chol_factor(broadcast(D, owner, mesh, axis))
        hld = hld + torch.sum(torch.log(torch.diagonal(Lkk)))
        below = P[block:] if me == owner else P
        if below.shape[0]:  # L[below, kb:e] = P L_kk^-T
            if stored:
                torch.linalg.solve_triangular(Lkk.T, below, upper=True, left=False, out=below)
            else:
                below[:] = torch.linalg.solve_triangular(Lkk.T, below, upper=True, left=False)
        if me == owner:
            P[:block] = Lkk
        if stored:
            W[lo:, kb:e] = P  # the panel's one rounding
        W[:lo, kb:e].zero_()
    return hld


def _tri_inv(W, row0: int, mesh: Mesh, axis: str, block: int) -> None:
    """Stage 3: W: L's rows (lower) -> L^-1's rows, right to left:
    X[t:, s:t] = -X[t:, t:] L[t:, s:t] X_ss, summed one panel at a time."""
    rows_per, n = W.shape
    stored = W.dtype in TWO_BYTE
    me = mesh.index(axis)
    end = row0 + rows_per
    for s in reversed(range(0, n, block)):
        t = s + block
        owner, off = divmod(s, rows_per)
        strip = gather_rows(W[:, s:t], mesh, axis)  # L[:, s:t], before it is overwritten
        Lss = upcast(strip[s:t])
        eye = torch.eye(block, dtype=Lss.dtype, device=W.device)
        Xss = torch.linalg.solve_triangular(Lss, eye, upper=False).tril_()
        lo = min(max(t - row0, 0), rows_per)  # the first local row below the panel
        if lo < rows_per:
            acc = W.new_zeros((rows_per - lo, block), dtype=acc_dtype(W.dtype))
            # Column panel c of X is nonzero in the rows at or below row c only.
            for c in range(t, end, block):
                r = max(c - row0, lo)
                addmm_(acc[r - lo:], W[r:, c:c + block], strip[c:c + block])
            if stored:
                W[lo:, s:t] = matmul(acc, Xss).neg_()  # one rounding
            else:
                addmm_(W[lo:, s:t], acc, Xss, beta=0.0, alpha=-1.0)
        if me == owner:
            W[off:off + block, s:t] = Xss


def _lauum(W, row0: int, mesh: Mesh, axis: str, block: int) -> None:
    """Stage 4: W: L^-1's rows -> K_hat^-1's rows, full symmetric. Panel s
    reads only rows and columns >= s (still L^-1) and writes the lower
    column panel and the row band s right of it: regions no later panel
    reads."""
    rows_per, n = W.shape
    me = mesh.index(axis)
    for s in range(0, n, block):
        e = s + block
        owner, off = divmod(s, rows_per)
        lo = min(max(s - row0, 0), rows_per)
        # B^T [b, n - s]: B^T[c, j] = sum_r X[r, s + c] X[r, s + j], r >= s.
        BT = W.new_zeros((block, n - s), dtype=acc_dtype(W.dtype))
        for r0 in range(lo, rows_per, block):
            g1 = row0 + r0 + block  # row block r0's X is zero right of column g1
            addmm_(BT[:, :g1 - s], W[r0:r0 + block, s:e].T, W[r0:r0 + block, s:g1])
        all_reduce_sum(BT, mesh, axis)
        if lo < rows_per:
            W[lo:, s:e] = BT[:, row0 + lo - s:row0 + rows_per - s].T  # in a 2-byte W, one rounding
        if me == owner:
            # The diagonal block's upper triangle from its lower: the ranks'
            # partial sums reach the two in different orders at p > 2.
            D = BT[:, :block].T.tril()
            W[off:off + block, s:e] = D + D.tril(-1).T
            if e < n:
                W[off:off + block, e:] = BT[:, e - s:]


def ard_gram_inverse_inplace_sharded(log_signal_sq, log_length, log_noise_sq, x, mesh: Mesh,
                                     axis: str = "data", block: int = 256, storage=None):
    """(K_hat^-1's rows [n/p, n] on this rank, half log-det of K_hat) for
    K_hat = K_ard(x) + noise I, x [n, d] and the parameters replicated: the
    distributed twin of
    :func:`gpscore_torch.ops.potri_inplace.ard_gram_inverse_inplace` (module
    docstring). The inverse is full symmetric, both triangles written, in
    ``storage`` (None: float32; bfloat16 or float16); the half log-det is
    fp32 and the same on every rank. Raises ``ValueError`` unless n divides
    by p * block. Not differentiable: the fused sharded steps pair it with
    :func:`make_streamed_ard_bwd`."""
    n = x.shape[0]
    rows_per = _check_divisible(n, mesh.size(axis), block)
    row0 = mesh.index(axis) * rows_per
    st = _storage(storage)
    with torch.no_grad():
        xs = gram_cuda.scale_inputs(x, log_length)
        W = _gram_rows(xs, row0, rows_per, torch.exp(log_signal_sq), torch.exp(log_noise_sq), st,
                       block)
        hld = _chol(W, row0, mesh, axis, block)
        _tri_inv(W, row0, mesh, axis, block)
        _lauum(W, row0, mesh, axis, block)
    return W, hld


def sharded_diag(Kinv_local, mesh: Mesh, axis: str = "data"):
    """This rank's block [n/p] of diag(M) for the row-sharded square M
    (``Kinv_local`` its rows [n/p, n]), in M's dtype: no collective."""
    return Kinv_local.diagonal(offset=mesh.index(axis) * Kinv_local.shape[0]).clone()


def _reduce_grads(parts, mesh: Mesh, axis: str):
    """The passes' partial sums, all-reduced over ``axis`` in one message."""
    sig_bar, len_bar, trace = parts
    packed = torch.cat([sig_bar.reshape(1), trace.reshape(1), len_bar])
    all_reduce_sum(packed, mesh, axis)
    return packed[0], packed[2:], packed[1]


def _scatter_cols(T, mesh: Mesh, axis: str):
    """This rank's columns [b, n/p] of the sum over ranks of T [b, n]: one
    reduce-scatter of T laid out column block by column block."""
    b, n = T.shape
    p = mesh.size(axis)
    return reduce_scatter_sum(T.view(b, p, n // p).transpose(0, 1).reshape(p * b, n // p), mesh,
                              axis)


def make_streamed_ard_bwd(mesh: Mesh, mode: str, fold_k=None, axis: str = "data",
                          block: int = 256):
    """The streamed parameter-cotangent contraction off the row-sharded K^-1.

    Returns ``bwd(Kinv_local, a, x, log_signal_sq, log_length, log_noise_sq,
    cot) -> (s_bar, l_bar, n_bar, w)`` (a [n], x [n, d] replicated; every
    output replicated), per ``mode`` the cotangents of the fused cores'
    math (:mod:`gpscore_torch.ops.loo_fused`):

    - ``"loo"``: cot = (a_bar, d_bar); K_hat_bar = -w a^T - K^-1 D K^-1,
      w = K^-1 a_bar, D = diag(d_bar). ``w`` is y's cotangent.
    - ``"kfold"``: cot = (a_bar, A_bar [fold_k, nf, nf]); the sandwich is
      -K^-1 blockdiag(A_bar) K^-1. ``w`` is y's cotangent. A rank's rows
      must tile the folds (nf % (n/p) == 0, the rank's rows inside one fold,
      whose column strip is all-gathered; or (n/p) % nf == 0, whole folds
      on the rank), else ``ValueError``.
    - ``"nlml"``: cot = v_bar (a scalar); K_hat_bar = v_bar (K^-1 - a a^T)/2,
      read off the local rows with no collective, w = (v_bar / 2) a. y's
      cotangent is v_bar a (the caller's).

    Per global row block the sandwich's local columns are one reduce-scatter
    of [b, n] -> [b, n/p] (module docstring); the O(d) sums are all-reduced
    once at the end. No n x n temporary exists on a rank."""
    if mode not in ("loo", "kfold", "nlml"):
        raise ValueError(f"unknown mode {mode!r}")
    if mode == "kfold" and not fold_k:
        raise ValueError("mode='kfold' needs fold_k")
    p = mesh.size(axis)

    def bwd(Kinv_local, a, x, log_signal_sq, log_length, log_noise_sq, cot):
        n = x.shape[0]
        rows_per = _check_divisible(n, p, block)
        row0 = mesh.index(axis) * rows_per
        st = Kinv_local.dtype
        if mode == "kfold":
            nf = n // fold_k
            if nf % rows_per == 0:
                within_fold = True  # this rank's rows inside fold row0 // nf
            elif rows_per % nf == 0:
                within_fold = False  # whole folds on this rank
            else:
                raise ValueError(f"fold size {nf} and device rows {rows_per} must tile each other")
        xs = gram_cuda.scale_inputs(x, log_length)
        xs_loc = xs[row0:row0 + rows_per]
        sig = torch.exp(log_signal_sq)

        if mode == "nlml":
            half = 0.5 * cot
            w = half * a
        else:
            w = gather_rows(_w(Kinv_local, cot[0]), mesh, axis)
            if mode == "loo":
                d_bar_loc = cot[1][row0:row0 + rows_per]
            else:
                A_bar = cot[1]

        def cols_of(s, _):
            colsl = Kinv_local[:, s:s + block]  # K^-1[R_q, B] = K^-1[B, R_q]^T
            if mode == "nlml":
                return half * upcast(colsl).T
            if mode == "loo":  # this rank's rows of the inner sum, rounded to the storage
                M = (colsl.T * d_bar_loc[None, :]).to(st)
            elif within_fold:  # M[:, R_q] = K^-1[B, fold] A_bar[fold][:, R_q]
                f = row0 // nf
                K_fold = gather_rows(colsl, mesh, axis)[f * nf:(f + 1) * nf]
                A_sl = A_bar[f][:, row0 - f * nf:row0 - f * nf + rows_per]
                M = matmul(upcast(K_fold).T, A_sl).to(st)
            else:
                m, f0 = rows_per // nf, row0 // nf
                M = torch.einsum("bmi,mij->bmj", upcast(colsl).T.reshape(block, m, nf),
                                 A_bar[f0:f0 + m]).reshape(block, rows_per).to(st)
            return _scatter_cols(matmul_acc32(M, Kinv_local), mesh, axis).neg_()

        parts = _stream_param_grads(cols_of, w, a[row0:row0 + rows_per], xs, sig, block, xs_loc,
                                    row0)
        s_bar, len_bar, trace = _reduce_grads(parts, mesh, axis)
        return (*_param_grads((s_bar, len_bar, trace), sig, log_length, log_noise_sq), w)

    return bwd
