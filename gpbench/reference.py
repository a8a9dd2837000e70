"""The plain reference: the objectives of the cells in float64, written from
their definitions with plain ``torch`` operations.

It imports nothing of the program and takes nothing the program made: the
inputs and the initial parameters come from :mod:`gpbench.frozen.data`, and
the program's outputs are only read by :mod:`gpbench.check` to judge them.

Definitions (the paper's and the reference scripts' formulas):

- Kernel: K(a, b)_ij = exp(ls) exp(-|a_i / l - b_j / l|^2 / 2), l = exp(log_length).
- FITC-20 (dense, n x n): Q = K_fu (K_uu + 1e-3 I)^-1 K_uf and
  B = Q + diag(k_ff - q_ff + noise), so B_ii = k_ff,ii + noise.
- Exact GP: K_hat = K(x, x) + noise I.
- Leave-one-out (crps, logs): mu_i = y_i - [C^-1 y]_i / [C^-1]_ii, var_i =
  1 / [C^-1]_ii for C = B or K_hat; crps and logs are means over the sites.
- nlml: n/2 log 2pi + 1/2 log det C + 1/2 y^T C^-1 y.
- k folds of contiguous rows (dss, kc): A_f = [C^-1]_ff, a = C^-1 y, e_f =
  A_f^-1 a_f; dss = sum_f nb/2 log 2pi - 1/2 log det A_f + 1/2 a_f . e_f;
  kc = sum_f mean crps(y_f - e_f, diag(A_f^-1), y_f).

FITC objectives are differentiated by autograd (n = 500). The exact GP at
large n is differentiated by hand, in row blocks, so that only K_hat^-1 and
its factor are n x n: with a_bar and S the gradients of the loss with respect
to a and to the entries of C^-1 that it reads (diag for LOO, the fold blocks
for dss), M = dL/dK_hat = -(K^-1 a_bar) a^T - K^-1 S K^-1, and

    d ls = sum M o K,   d log l_k = sum_ij M_ij K_ij (xs_ik - xs_jk)^2,
    d log noise = noise * trace(M).
"""

from __future__ import annotations

import math

import torch

KUU_JITTER = 1e-3
_SQRT2 = math.sqrt(2.0)
_INV_SQRT_PI = 1.0 / math.sqrt(math.pi)
_LOG_2PI = math.log(2.0 * math.pi)
LEAVES = ("log_signal_sq", "log_length", "log_noise_sq", "inducing")


def crps_sites(mean, var, y):
    sigma = torch.sqrt(var)
    z = (y - mean) / sigma
    cdf = 0.5 * (1.0 + torch.erf(z / _SQRT2))
    pdf = torch.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)
    return sigma * (z * (2.0 * cdf - 1.0) + 2.0 * pdf - _INV_SQRT_PI)


def sqdist(a, b):
    """|a_i - b_j|^2 [..., n, m] by differences (exact for small sizes)."""
    diff = a[..., :, None, :] - b[..., None, :, :]
    return torch.sum(diff * diff, dim=-1)


def _lead(t, k):
    """t [R] -> [R, 1, ...] with k trailing ones (scalars stay)."""
    return t.reshape(*t.shape, *([1] * k))


# ---- FITC-20, dense, autograd ----------------------------------------------

def fitc_cov(p, x):
    """(B [..., n, n], noise [...], k_ff diagonal [..., n]) for leaves ``p``
    (a leading [R] or none) and x [n, d]."""
    inv_l = torch.exp(-p["log_length"])[..., None, :]
    xs = x * inv_l
    us = p["inducing"] * inv_l
    sig = torch.exp(p["log_signal_sq"])
    noise = torch.exp(p["log_noise_sq"])
    m = us.shape[-2]
    kuu = _lead(sig, 2) * torch.exp(-0.5 * sqdist(us, us))
    kuu = kuu + KUU_JITTER * torch.eye(m, dtype=x.dtype, device=x.device)
    kfu = _lead(sig, 2) * torch.exp(-0.5 * sqdist(xs, us))
    luu = torch.linalg.cholesky(kuu)
    v = torch.linalg.solve_triangular(luu, kfu.mT, upper=False)  # [..., m, n]
    q = v.mT @ v
    n = x.shape[-2]
    kff = _lead(sig, 1) * torch.ones(n, dtype=x.dtype, device=x.device)
    diag = kff + _lead(noise, 1)
    b = q - torch.diag_embed(torch.diagonal(q, dim1=-2, dim2=-1)) + torch.diag_embed(diag)
    return b, noise, kff


def _folds(v, k):
    return v.reshape(*v.shape[:-1], k, v.shape[-1] // k)


def fitc_loss(rule, p, x, y, fold_k=4):
    """The FITC objective ``rule`` at leaves ``p``: a scalar, or [R]."""
    b, noise, kff = fitc_cov(p, x)
    L = torch.linalg.cholesky(b)
    binv = torch.cholesky_inverse(L)
    a = (binv @ y[:, None])[..., 0]
    n = y.shape[-1]
    if rule in ("crps", "logs"):
        dg = torch.diagonal(binv, dim1=-2, dim2=-1)
        mean, var = y - a / dg, 1.0 / dg
        if rule == "crps":
            return torch.mean(crps_sites(mean, var, y), dim=-1)
        var = var + _lead(noise, 1) - (kff + _lead(noise, 1)) + kff  # the reference's literal form
        return torch.mean((y - mean) ** 2 / (2.0 * var) + 0.5 * torch.log(var) + 0.5 * _LOG_2PI,
                          dim=-1)
    if rule == "nlml":
        half_logdet = torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)
        return 0.5 * n * _LOG_2PI + half_logdet + 0.5 * torch.sum(y * a, dim=-1)
    nb = n // fold_k
    blocks = torch.stack([binv[..., f * nb:(f + 1) * nb, f * nb:(f + 1) * nb]
                          for f in range(fold_k)], dim=-3)  # [..., k, nb, nb]
    return fold_loss(rule, blocks, _folds(a, fold_k), _folds(y, fold_k))


def fold_loss(rule, blocks, a_f, y_f):
    """dss or kc from the fold precision blocks [..., k, nb, nb], a_f and
    y_f [..., k, nb]: a sum over folds."""
    La = torch.linalg.cholesky(blocks)
    h = torch.linalg.solve_triangular(La, a_f[..., None], upper=False)
    e = torch.linalg.solve_triangular(La.mT, h, upper=True)[..., 0]
    nb = y_f.shape[-1]
    if rule == "dss":
        half_logdet = torch.sum(torch.log(torch.diagonal(La, dim1=-2, dim2=-1)), dim=-1)
        per = 0.5 * nb * _LOG_2PI - half_logdet + 0.5 * torch.sum(a_f * e, dim=-1)
        return torch.sum(per, dim=-1)
    if rule == "kc":
        eye = torch.eye(nb, dtype=blocks.dtype, device=blocks.device)
        var = torch.sum(torch.linalg.solve_triangular(La, eye, upper=False) ** 2, dim=-2)
        return torch.sum(torch.mean(crps_sites(y_f - e, var, y_f), dim=-1), dim=-1)
    raise ValueError(f"no fold rule {rule!r}")


def fitc_value_grad(rule, p, x, y, fold_k=4):
    """(loss, {leaf: gradient}) in float64; a batch of R restarts gives [R]
    losses and each restart's own gradients."""
    leaves = {k: v.detach().clone().requires_grad_() for k, v in p.items()}
    loss = fitc_loss(rule, leaves, x, y, fold_k)
    grads = torch.autograd.grad(loss.sum(), list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


# ---- Exact GP at large n, blocked, by hand ---------------------------------

def _kernel_rows(xs, r0, r1, sig):
    a = xs[r0:r1]
    sq = (torch.sum(a * a, dim=1)[:, None] + torch.sum(xs * xs, dim=1)[None, :]
          - 2.0 * (a @ xs.T))
    return sig * torch.exp(-0.5 * torch.clamp(sq, min=0.0))


def exact_value_grad(rule, p, x, y, fold_k=4, block=2048, want_grad=True):
    """(loss, {leaf: gradient} or None) of the exact objective ``rule``
    ("crps" by LOO or "dss" by k folds) at leaves ``p``, all float64."""
    n = x.shape[0]
    sig, noise = torch.exp(p["log_signal_sq"]), torch.exp(p["log_noise_sq"])
    xs = x * torch.exp(-p["log_length"])[None, :]
    K = torch.empty((n, n), dtype=x.dtype, device=x.device)
    for r0 in range(0, n, block):
        K[r0:r0 + block] = _kernel_rows(xs, r0, min(r0 + block, n), sig)
    K.diagonal().add_(noise)
    L = torch.linalg.cholesky(K)
    del K
    half_logdet = torch.sum(torch.log(torch.diagonal(L)))
    kinv = torch.cholesky_inverse(L)
    del L
    kinv = 0.5 * (kinv + kinv.T)
    a = kinv @ y
    a_ = a.clone().requires_grad_()
    if rule in ("crps", "logs"):
        dg = torch.diagonal(kinv).clone().requires_grad_()
        mean, var = y - a_ / dg, 1.0 / dg
        if rule == "crps":
            loss = torch.mean(crps_sites(mean, var, y))
        else:
            loss = torch.mean((y - mean) ** 2 / (2.0 * var) + 0.5 * torch.log(var)
                              + 0.5 * _LOG_2PI)
        inputs = [a_, dg]
    elif rule == "nlml":
        loss = 0.5 * n * _LOG_2PI + half_logdet + 0.5 * torch.dot(y, a_)
        inputs = [a_]
    else:
        nb = n // fold_k
        blocks = torch.stack([kinv[f * nb:(f + 1) * nb, f * nb:(f + 1) * nb]
                              for f in range(fold_k)]).requires_grad_()
        loss = fold_loss(rule, blocks, _folds(a_, fold_k), _folds(y, fold_k))
        inputs = [a_, blocks]
    if not want_grad:
        return loss.detach(), None
    cots = torch.autograd.grad(loss, inputs)
    a_bar = cots[0]
    w = kinv @ a_bar
    if rule == "nlml":
        # d(1/2 log det K_hat) = 1/2 K^-1: no S, the log-det's own term.
        extra = 0.5
    s_bar = None if rule == "nlml" else cots[1]
    del cots
    d = x.shape[1]
    g_sig = torch.zeros((), dtype=x.dtype, device=x.device)
    rows = torch.zeros((n,), dtype=x.dtype, device=x.device)
    cols = torch.zeros((n,), dtype=x.dtype, device=x.device)
    wx = torch.zeros((n, d), dtype=x.dtype, device=x.device)
    trace = torch.zeros((), dtype=x.dtype, device=x.device)
    for r0 in range(0, n, block):
        r1 = min(r0 + block, n)
        M = -torch.outer(w[r0:r1], a)
        if rule in ("crps", "logs"):
            M -= (kinv[r0:r1] * s_bar[None, :]) @ kinv
        elif rule == "nlml":
            M += extra * kinv[r0:r1]
        else:
            nb = n // fold_k
            for f in range(fold_k):
                s = slice(f * nb, (f + 1) * nb)
                M -= (kinv[r0:r1, s] @ s_bar[f]) @ kinv[s]
        trace = trace + torch.sum(torch.diagonal(M[:, r0:r1]))
        W = M * _kernel_rows(xs, r0, r1, sig)
        del M
        g_sig = g_sig + torch.sum(W)
        rows[r0:r1] = torch.sum(W, dim=1)
        cols += torch.sum(W, dim=0)
        wx[r0:r1] = W @ xs
        del W
    x2 = xs * xs
    g_len = x2.T @ rows + x2.T @ cols - 2.0 * torch.sum(xs * wx, dim=0)
    grads = {"log_signal_sq": g_sig, "log_length": g_len, "log_noise_sq": noise * trace}
    return loss.detach(), grads
