"""Distributed blocked Cholesky over the mesh 'data' axis (port of
`gpscore/parallel/sharded_cholesky.py`).

A row-sharded n x n matrix: rank i of 'data' holds rows [i n/p, (i + 1) n/p).
The right-looking panel factorization, one panel of width ``block`` at a
time, each collective written out:

  for each panel k (columns [kb, kb + b)):
    1. the owner of the panel's rows broadcasts its [b, b] diagonal block,
    2. every rank factors it redundantly (``torch.linalg.cholesky_ex``; a
       failed factor is NaN, as ``jnp.linalg.cholesky`` gives),
    3. every rank solves its own rows of the panel's column strip,
    4. the [n, b] strip is assembled with one all-gather of the ranks' strips,
    5. every rank updates the trailing columns of its own rows (the Schur
       update, cancellation-critical: ``precision.addmm_`` with ``crit``,
       ``matmul_crit``'s product, in place).

Communication is n^2 / 2 elements of strips over the whole factorization,
compute the O(n^3 / p) trailing products per rank. The panels never straddle
a rank's rows: n must divide by p * block, as in JAX (``ValueError``).
The factorization runs in place on a copy of the caller's rows.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from gpscore_torch.ops.linalg import chol_factor
from gpscore_torch.parallel.mesh import Mesh, gather_rows
from gpscore_torch.utils.precision import addmm_, matmul


def _layout(A_local, mesh: Mesh, axis: str, block: int):
    """(n, p, rows per rank, this rank's first row), after JAX's shape check."""
    p = mesh.size(axis)
    rows_per, n = A_local.shape[0], A_local.shape[-1]
    if n % p != 0 or rows_per * p != n or rows_per % block != 0:
        raise ValueError(f"n={n} must be divisible by devices*block={p}*{block}")
    return n, p, rows_per, mesh.index(axis) * rows_per


def _bcast(t, owner: int, mesh: Mesh, axis: str):
    """``t`` (contiguous) from coordinate ``owner`` of ``axis`` to every rank of it."""
    assert t.is_contiguous()
    dist.broadcast(t, src=mesh.global_rank(axis, owner), group=mesh.group(axis))
    return t


def sharded_cholesky_(A_local, mesh: Mesh, axis: str = "data", block: int = 256):
    """:func:`sharded_cholesky` in place on ``A_local``: the factor's rows
    overwrite the matrix's (no n x n / p copy)."""
    n, p, rows_per, row0 = _layout(A_local, mesh, axis, block)
    me = mesh.index(axis)
    L = A_local
    for k in range(n // block):
        kb = k * block
        owner, off = divmod(kb, rows_per)
        # (1) the owner's updated diagonal block, (2) factored on every rank.
        D = (L[off:off + block, kb:kb + block].contiguous() if me == owner
             else L.new_empty((block, block)))
        L_kk = chol_factor(_bcast(D, owner, mesh, axis))
        # (3) this rank's rows of the strip, C L_kk^-T; rows above the panel
        # are final L (their strip entries are upper-triangle zeros).
        lo = min(max(kb - row0, 0), rows_per)
        part = L.new_zeros((rows_per, block))
        if lo < rows_per:
            part[lo:] = torch.linalg.solve_triangular(L_kk.mT, L[lo:, kb:kb + block], upper=True,
                                                      left=False)
            L[lo:, kb:kb + block] = part[lo:]
        # (4) the whole strip L[:, kb:kb + b], (5) the trailing update of the
        # rows below the panel, columns right of it.
        strip = gather_rows(part, mesh, axis)
        lo2 = min(max(kb + block - row0, 0), rows_per)
        if lo2 < rows_per and kb + block < n:
            addmm_(L[lo2:, kb + block:], part[lo2:], strip[kb + block:].mT, alpha=-1.0,
                   crit=True)
    return L.tril_(diagonal=row0)


def sharded_cholesky(A_local, mesh: Mesh, axis: str = "data", block: int = 256):
    """Lower Cholesky factor of SPD A [n, n], rows sharded over ``axis``:
    ``A_local`` is this rank's [n/p, n] rows; returns the factor's same rows
    (upper triangle zero). n must divide by p * block."""
    return sharded_cholesky_(A_local.clone(), mesh, axis, block)


class _AddNoise(torch.autograd.Function):
    """K_local + noise_sq on the global diagonal, in place on K_local (the
    Gram's rows, which nothing else reads): its gradient passes K's cotangent
    through uncopied and sums its diagonal entries for noise_sq."""

    @staticmethod
    def forward(ctx, K_local, noise_sq, row0: int):
        ctx.mark_dirty(K_local)
        ctx.row0 = row0
        K_local.diagonal(offset=row0).add_(noise_sq)
        return K_local

    @staticmethod
    def backward(ctx, g):
        return g, g.diagonal(offset=ctx.row0).sum().reshape(()), None


def add_noise_sharded(k_ff, noise_sq, mesh: Mesh, axis: str = "data"):
    """K + noise_sq I on this rank's rows ``k_ff`` [n/p, n], the identity's
    rows formed locally (JAX forms them inside a row-sharded program for the
    same reason: no n x n identity on one device). In place on ``k_ff``, which
    the caller hands over (a Gram's output); differentiable in both."""
    row0 = mesh.index(axis) * k_ff.shape[0]
    noise = torch.as_tensor(noise_sq, dtype=k_ff.dtype, device=k_ff.device)
    if torch.is_grad_enabled() and (k_ff.requires_grad or noise.requires_grad):
        return _AddNoise.apply(k_ff, noise, row0)
    k_ff.diagonal(offset=row0).add_(noise)
    return k_ff


def sharded_half_logdet(L_sharded, mesh: Mesh, axis: str = "data"):
    """0.5 log det A from a row-sharded factor: each rank sums the logs of its
    own diagonal entries; one scalar all-reduce. Replicated."""
    row0 = mesh.index(axis) * L_sharded.shape[0]
    out = torch.sum(torch.log(L_sharded.diagonal(offset=row0))).reshape(1)
    dist.all_reduce(out, group=mesh.group(axis))
    return out[0]


def sharded_tri_solve_lower(L_sharded, b, mesh: Mesh, axis: str = "data", block: int = 256):
    """Forward substitution L x = b, L row-sharded over ``axis``, b [n]
    replicated. Panel recurrence x_k = L_kk^-1 (b_k - L[kb:kb+b, :kb] x[:kb]):
    the owner of panel k holds the rows it needs, solves the block and
    broadcasts it (O(b) a panel, O(n) in all). Returns x [n], replicated."""
    n, p, rows_per, row0 = _layout(L_sharded, mesh, axis, block)
    me = mesh.index(axis)
    b = b.reshape(n)
    x = b.new_zeros(n)
    for k in range(n // block):
        kb = k * block
        owner, off = divmod(kb, rows_per)
        if me == owner:
            rows = L_sharded[off:off + block]
            s = matmul(rows[:, :kb], x[:kb, None])[:, 0] if kb else b.new_zeros(block)
            x_k = torch.linalg.solve_triangular(rows[:, kb:kb + block],
                                                (b[kb:kb + block] - s)[:, None],
                                                upper=False)[:, 0].contiguous()
        else:
            x_k = b.new_empty(block)
        x[kb:kb + block] = _bcast(x_k, owner, mesh, axis)
    return x


def sharded_nlml(k_ff, y, noise_sq, mesh: Mesh, axis: str = "data", block: int = 256):
    """Distributed exact-GP NLML: row-sharded Cholesky, distributed forward
    substitution and the sharded half log-determinant,

        NLML = 0.5 n log 2pi + sum log diag(L) + 0.5 ||L^-1 y||^2

    (reference `SIMPLE-DATA FULL-comapre.py:292-296`). ``k_ff`` is this
    rank's [n/p, n] rows (copied, not modified), y [n] replicated.
    Forward-only; a replicated scalar."""
    n = k_ff.shape[-1]
    L = sharded_cholesky_(add_noise_sharded(k_ff.detach().clone(), noise_sq, mesh, axis),
                          mesh, axis, block)
    w = sharded_tri_solve_lower(L, y.reshape(n), mesh, axis, block)
    return (0.5 * n * math.log(2.0 * math.pi) + sharded_half_logdet(L, mesh, axis)
            + 0.5 * torch.sum(w * w))


def sharded_tri_inverse_lower(L_sharded, mesh: Mesh, axis: str = "data", block: int = 256):
    """This rank's rows of L^-1 for the row-sharded lower factor L: forward
    substitution against I with the panel structure of the factorization
    (JAX gets L^-1 from GSPMD over ``block_cholesky.tri_inverse_lower``; a
    solve on the local rows alone cannot give it). Every rank starts from its
    rows of I; for each panel k the owner solves X_k = L_kk^-1 B_k over the
    columns [0, kb + b) that are not yet zero and broadcasts the [b, kb + b]
    block, and every rank takes L[i, panel] X_k off its rows below the panel
    (``precision.addmm_``). n^2 / 2 elements of broadcasts; [n/p, n] a rank."""
    n, p, rows_per, row0 = _layout(L_sharded, mesh, axis, block)
    me = mesh.index(axis)
    X = L_sharded.new_zeros((rows_per, n))
    X.diagonal(offset=row0).fill_(1.0)
    for k in range(n // block):
        kb = k * block
        w = kb + block
        owner, off = divmod(kb, rows_per)
        if me == owner:
            X_k = torch.linalg.solve_triangular(L_sharded[off:off + block, kb:w],
                                                X[off:off + block, :w], upper=False).contiguous()
            X[off:off + block, :w] = X_k
        else:
            X_k = X.new_empty((block, w))
        _bcast(X_k, owner, mesh, axis)
        lo = min(max(w - row0, 0), rows_per)
        if lo < rows_per:
            addmm_(X[lo:, :w], L_sharded[lo:, kb:w], X_k, alpha=-1.0)
    return X


def sharded_inverse_from_linv(Linv_sharded, mesh: Mesh, axis: str = "data"):
    """This rank's rows of A^-1 = L^-T L^-1 from the ranks' rows X_r of L^-1:
    row block t of A^-1 is sum_r X_r[:, block t]^T X_r, one sum-reduce onto
    rank t per target block, so a rank holds a few [n/p, n] arrays, never
    n x n. X_r is zero right of rank r's last row, so rank r's term for t
    is zero when t > r and spans its first (r + 1) n/p columns otherwise."""
    rows_per, n = Linv_sharded.shape
    p, me = mesh.size(axis), mesh.index(axis)
    hi = (me + 1) * rows_per
    mine = None
    for t in range(p):
        cols = slice(t * rows_per, (t + 1) * rows_per)
        if p == 1:
            term = matmul(Linv_sharded[:, cols].mT, Linv_sharded)
        else:
            term = Linv_sharded.new_zeros((rows_per, n))
            if t <= me:
                term[:, :hi] = matmul(Linv_sharded[:, cols].mT, Linv_sharded[:, :hi])
            dist.reduce(term, dst=mesh.global_rank(axis, t), group=mesh.group(axis))
        if t == me:
            mine = term
        del term
    return mine
