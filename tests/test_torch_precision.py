"""The port's precision modes (gpscore_torch.utils.precision) and what they
reach: the products of each mode, the 2-byte Gram, the in-place pipeline at
bf16/f16 storage, the streamed K_hat V, the fused LOO/k-fold/NLML cores in
every mode, and the storage-aware large-n predictive, against gpscore under
the same ``matmul_mode``.

JAX runs on the CPU here, where its precision flags change nothing: its
"high" and "fast" products are fp32, while the port's CPU forms emulate the
card's TF32 passes (operands rounded to TF32). Its 2-byte modes store and
round as on its chip. Inputs are made with numpy from a seed.

Tolerances:
- products: "highest", and matmul_crit in "high" and "fast", bitwise
  torch.matmul; "high" within 1e-6 of float64 relative to the product of the
  operands' magnitudes (|A| |B|), "fast" within 2.5e-3 (JAX's documented
  one-pass grade); matmul_acc32 of 2-byte
  operands fp32, within 3e-2 (`tests/test_potri_inplace.py:294-307`);
- the pipeline at bf16/f16 storage: below 0.1 and 0.02 of max|K_hat^-1|
  (`tests/test_potri_inplace.py:116-139`), in the storage dtype;
- the cores: "high" value rtol 1e-5, gradients rtol 2e-4, atol 1e-5
  (`:110-114`); "fast", "bf16", "f16" value rtol 2e-2 and gradient cosine
  > 0.999 per leaf (`:141-173`);
- the streamed K_hat V rtol 1e-5; the predictive at f16 storage plain within
  2e-2 of the dense one, refined (8 iterations) within 2e-4 (`:309-380`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpscore.ops.loo_fused as jloo
from gpscore.models.exact import exact_predictive as jax_exact_predictive
from gpscore.models.exact import exact_predictive_diag_large as jax_predictive_large
from gpscore.ops.kernels import ard_gram as jax_ard_gram
from gpscore.ops.potri_inplace import ard_gram_chol_inplace as jax_chol_inplace
from gpscore.ops.potri_inplace import ard_gram_inverse_inplace as jax_inverse_inplace
from gpscore.ops.potri_inplace import ard_khat_matmul_streamed as jax_khat_matmul
from gpscore.ops.potri_inplace import pad_rows
from gpscore.utils.precision import matmul_acc32 as jax_matmul_acc32
from gpscore.utils.precision import matmul_mode as jax_matmul_mode
from gpscore_torch.models import exact as texact
from gpscore_torch.ops import gram_cuda
from gpscore_torch.ops import loo_fused as tloo
from gpscore_torch.ops import potri_inplace as tpotri
from gpscore_torch.utils import precision
from torch_parity import close, jax_params, t, torch_params

MODES = ["highest", "high", "fast", "bf16", "f16"]
STORAGE = {"bf16": (torch.bfloat16, jnp.bfloat16), "f16": (torch.float16, jnp.float16)}
SIZES = [(64, 16), (52, 16)]  # a multiple of the block, and a ragged last panel


def _problem(seed, n, d=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = np.sin(x.sum(axis=1)).astype(np.float32)
    p = {"log_signal_sq": np.float32(0.3),
         "log_length": (0.3 * rng.standard_normal(d)).astype(np.float32),
         "log_noise_sq": np.float32(-1.2), "inducing": None}
    return x, y, p


def _jax_args(p):
    return [jnp.asarray(p[f]) for f in ("log_signal_sq", "log_length", "log_noise_sq")]


def _torch_args(p, requires_grad=False):
    return [torch.tensor(p[f], requires_grad=requires_grad)
            for f in ("log_signal_sq", "log_length", "log_noise_sq")]


def _padded(x, block):
    return pad_rows(jnp.asarray(x), -(-x.shape[0] // block) * block)


def _operands(seed, shape_a, shape_b):
    rng = np.random.default_rng(seed)
    return (torch.tensor(rng.standard_normal(shape_a).astype(np.float32)),
            torch.tensor(rng.standard_normal(shape_b).astype(np.float32)))


def _err_vs_f64(c, a, b):
    """max |c - a b| over max (|a| |b|), in float64."""
    exact = a.double() @ b.double()
    scale = (a.double().abs() @ b.double().abs()).max()
    return float((c.double() - exact).abs().max() / scale)


def _cosine(g, w):
    g, w = np.ravel(np.asarray(g, np.float64)), np.ravel(np.asarray(w, np.float64))
    return float(np.dot(g, w) / (np.linalg.norm(g) * np.linalg.norm(w) + 1e-30))


# ---- the mode switch ---------------------------------------------------------


def test_modes_set_read_and_restore():
    assert precision.MODES == tuple(MODES)
    assert precision.get_matmul_mode() == "highest"
    for mode in MODES:
        with precision.matmul_mode(mode):
            assert precision.get_matmul_mode() == mode
            assert precision.storage_dtype() == (STORAGE[mode][0] if mode in STORAGE
                                                 else torch.float32)
            # TF32 is on only inside a product, never left on.
            precision.matmul(*_operands(0, (8, 8), (8, 8)))
            assert not torch.backends.cuda.matmul.allow_tf32
            assert torch.get_float32_matmul_precision() == "highest"
    assert precision.get_matmul_mode() == "highest"
    with pytest.raises(ValueError):
        precision.set_matmul_mode("tf32")


# ---- the products ------------------------------------------------------------


@pytest.mark.parametrize("shapes", [((37, 29), (29, 41)), ((3, 12, 7), (3, 7, 5)),
                                    ((16, 9), (9, 1))])
def test_highest_is_bitwise_torch_matmul(shapes):
    a, b = _operands(1, *shapes)
    for fn in (precision.matmul, precision.matmul_crit, precision.matmul_acc32):
        assert torch.equal(fn(a, b), torch.matmul(a, b))
    if a.dim() == 2:
        c0 = torch.randn(a.shape[0], b.shape[1])
        want = c0.clone().addmm_(a, b, beta=0.5, alpha=-2.0)
        assert torch.equal(precision.addmm_(c0.clone(), a, b, alpha=-2.0, beta=0.5), want)


def test_tf32_split_is_exact():
    a = torch.tensor(np.random.default_rng(2).standard_normal(4096).astype(np.float32) * 1e3)
    hi, lo = precision.tf32_split(a)
    assert torch.equal(hi + lo, a)
    # a_hi keeps 11 significant bits: the low 13 mantissa bits are zero.
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert float((lo / a).abs().max()) <= 2.0 ** -11
    special = torch.tensor([float("nan"), float("inf"), -float("inf"), 0.0, -0.0])
    got = precision.tf32_round(special)
    assert torch.isnan(got[0]) and torch.equal(got[1:], special[1:])


@pytest.mark.parametrize("shapes", [((300, 200), (200, 150)), ((2, 40, 64), (2, 64, 33))])
def test_reduced_fp32_modes_against_float64(monkeypatch, shapes):
    monkeypatch.setattr(precision, "_SPLIT_MIN_K", 0)  # "high" splits at every size
    a, b = _operands(3, *shapes)
    with precision.matmul_mode("high"):
        high = _err_vs_f64(precision.matmul(a, b), a, b)
        crit = [torch.equal(precision.matmul_crit(a, b), torch.matmul(a, b))]
    with precision.matmul_mode("fast"):
        fast = _err_vs_f64(precision.matmul(a, b), a, b)
        crit.append(torch.equal(precision.matmul_crit(a, b), torch.matmul(a, b)))
    assert high <= 1e-6, high
    assert 1e-5 < fast <= 2.5e-3, fast  # one TF32 pass: rounded, within its grade
    assert all(crit)  # the critical products stay IEEE in both


def test_split_panels_and_matvecs(monkeypatch):
    """The 3 x TF32 product in row panels and inner chunks is as close to
    float64 as the one without, the differentiable form agrees with it; a
    matrix-vector product stays IEEE (bitwise torch.matmul)."""
    a, b = _operands(4, (50, 70), (70, 45))
    v = b[:, :1]
    with precision.matmul_mode("high"):
        # Under an inner dimension of _SPLIT_MIN_K "high" is IEEE.
        assert torch.equal(precision.matmul(a, b), torch.matmul(a, b))
        monkeypatch.setattr(precision, "_SPLIT_MIN_K", 70)
        whole = precision.matmul(a, b)
        assert not torch.equal(whole, torch.matmul(a, b))
        monkeypatch.setattr(precision, "_SPLIT_ROWS", 16)
        monkeypatch.setattr(precision, "_SPLIT_K", 16)
        panels = precision.matmul(a, b)
        assert _err_vs_f64(whole, a, b) <= 1e-6 and _err_vs_f64(panels, a, b) <= 1e-6
        traced = precision.matmul(a.clone().requires_grad_(), b)
        assert _err_vs_f64(traced.detach(), a, b) <= 1e-6
        assert torch.equal(precision.matmul(a, v), torch.matmul(a, v))
        c = torch.full((50, 45), float("nan"))
        precision.addmm_(c, a, b, beta=0.0, alpha=-1.0)
        assert torch.equal(c, -panels)
    with precision.matmul_mode("fast"):
        assert torch.equal(precision.matmul(a.T[:1], a), torch.matmul(a.T[:1], a))


@pytest.mark.parametrize("mode", precision.MODES)
def test_matmul_split_k_chunks_only_ieee_products(monkeypatch, mode):
    """matmul_split_k: where the mode's product of fp32 operands is IEEE
    ("highest"; "high" below its split), the inner dimension summed one
    _SPLIT_K chunk at a time, bitwise the chunks added in turn and within
    1e-6 of float64; in every other case bitwise matmul_acc32."""
    monkeypatch.setattr(precision, "_SPLIT_K", 16)
    a, b = _operands(6, (20, 70), (70, 30))
    with precision.matmul_mode(mode):
        st = precision.storage_dtype()
        a_, b_ = (a.to(st), b.to(st)) if st in precision.TWO_BYTE else (a, b)
        got = precision.matmul_split_k(a_, b_)
        if mode not in ("highest", "high"):
            assert torch.equal(got, precision.matmul_acc32(a_, b_))
            return
        want = a[:, :16] @ b[:16]
        for k0 in range(16, 70, 16):
            want.addmm_(a[:, k0:k0 + 16], b[k0:k0 + 16])
        assert torch.equal(got, want)
        assert _err_vs_f64(got, a, b) <= 1e-6
        monkeypatch.setattr(precision, "_SPLIT_MIN_K", 70)
        if mode == "high":  # from the split on, the 3 x TF32 product chunks itself
            assert torch.equal(precision.matmul_split_k(a, b), precision.matmul_acc32(a, b))


@pytest.mark.parametrize("mode", ["bf16", "f16"])
def test_matmul_acc32_reads_2_byte_operands(mode):
    """fp32 out and accumulation off 2-byte operands, against the JAX
    package's matmul_acc32 on the same stored values."""
    st, jst = STORAGE[mode]
    a, b = _operands(5, (12, 8), (8, 5))
    want = (a @ b).numpy()
    got = precision.matmul_acc32(a.to(st), b.to(st))
    assert got.dtype == torch.float32
    close(got, want, 3e-2, 3e-2)
    close(got, jax_matmul_acc32(jnp.asarray(a.numpy()).astype(jst),
                                jnp.asarray(b.numpy()).astype(jst)), 1e-6, 1e-6)
    c = torch.ones(12, 5)
    precision.addmm_(c, a.to(st), b.to(st), alpha=-1.0)
    close(c, 1.0 - got.numpy(), 1e-6, 1e-6)
    with pytest.raises(TypeError):
        precision.matmul_acc32(a.to(st), b)


# ---- the 2-byte Gram ---------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("n,m", [(37, 37), (20, 13)])
def test_plain_2_byte_gram_is_the_rounded_fp32_one(dtype, n, m):
    rng = np.random.default_rng(6)
    xs = torch.tensor(rng.uniform(-1, 1, (n, 4)).astype(np.float32))
    xps = xs if n == m else torch.tensor(rng.uniform(-1, 1, (m, 4)).astype(np.float32))
    sig, noise = torch.tensor(1.7), torch.tensor(0.3)
    K = gram_cuda.gram_fwd_plain(xs, xps, sig)
    K.diagonal().add_(noise)
    got = gram_cuda.gram_fwd(xs, xps, sig, out_dtype=dtype, diag_add=noise)
    assert got.dtype == dtype and torch.equal(got, K.to(dtype))
    assert torch.equal(gram_cuda.gram_fwd(xs, xps, sig), gram_cuda.gram_fwd_plain(xs, xps, sig))
    # The roofline counts the 2-byte output (and the diagonal's scalar).
    full, half = (gram_cuda.roofline("gram_fwd", n, m, 4, out_bytes=b, diag=b == 2)
                  for b in (4, 2))
    assert full.bytes - half.bytes == 2 * n * m - 4 and full.flops == half.flops
    with pytest.raises(ValueError, match="CUDA"):
        gram_cuda.gram_fwd_cuda(xs, xps, sig, out_dtype=dtype, diag_add=noise)


# ---- the in-place pipeline at 2-byte storage ---------------------------------


@pytest.mark.parametrize("mode,tol", [("bf16", 0.1), ("f16", 0.02)])
@pytest.mark.parametrize("n,block", SIZES)
def test_inplace_pipeline_at_2_byte_storage_matches_jax(n, block, mode, tol):
    st, jst = STORAGE[mode]
    x, _, p = _problem(1, n)
    inverse = jax.jit(jax_inverse_inplace, static_argnums=(4, 5), static_argnames="storage")
    want = np.asarray(inverse(*_jax_args(p), _padded(x, block), n, block))[:n, :n]
    jax_st = np.asarray(inverse(*_jax_args(p), _padded(x, block), n, block,
                                storage=jst).astype(jnp.float32))[:n, :n]
    got, hld = tpotri.ard_gram_inverse_inplace(*_torch_args(p), t(x), block,
                                               return_half_logdet=True, storage=st)
    assert got.dtype == st and hld.dtype == torch.float32 and got.shape == (n, n)
    scale = np.abs(want).max()
    assert np.abs(got.float().numpy() - want).max() / scale < tol
    assert np.abs(got.float().numpy() - jax_st).max() / scale < tol / 10
    assert torch.equal(got, got.T)
    L, hld_c = tpotri.ard_gram_chol_inplace(*_torch_args(p), t(x), block, storage=st)
    Lj, hld_j = jax.jit(jax_chol_inplace, static_argnums=(4, 5), static_argnames="storage")(
        *_jax_args(p), _padded(x, block), n, block, storage=jst)
    Lj = np.asarray(Lj.astype(jnp.float32))[:n, :n]
    assert L.dtype == st and torch.equal(L, L.tril())
    assert np.abs(L.float().numpy() - Lj).max() / np.abs(Lj).max() < tol / 10
    close(hld_c, float(hld_j), 1e-3)
    with pytest.raises(TypeError):
        tpotri.ard_gram_inverse_inplace(*_torch_args(p), t(x), block, storage=torch.float64)


@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_blocked_triangular_solve_of_a_stored_factor(dtype, trans):
    """L^-1 B and L^-T B by blocked substitution against one fp32 solve with
    the same (stored, upcast) factor."""
    x, _, p = _problem(2, 52)
    L, _ = tpotri.ard_gram_chol_inplace(*_torch_args(p), t(x), 16, storage=dtype)
    B = torch.tensor(np.random.default_rng(3).standard_normal((52, 5)).astype(np.float32))
    got = tpotri.tri_solve_stored(L, B, 16, trans=trans)
    Lf = L.float()
    want = torch.linalg.solve_triangular(Lf.T if trans else Lf, B, upper=trans)
    close(got, want.numpy(), 1e-5, 1e-5)


@pytest.mark.parametrize("n,block", [(64, 16), (48, 16)])
def test_khat_matmul_streamed_matches_jax(n, block):
    x, _, p = _problem(3, n)
    V = np.random.default_rng(4).standard_normal((n, 6)).astype(np.float32)
    want = jax_khat_matmul(*_jax_args(p), jnp.asarray(x), n, jnp.asarray(V), block)
    got = tpotri.ard_khat_matmul_streamed(*_torch_args(p), t(x), t(V), block)
    close(got, want, 1e-5, 1e-5)


# ---- the fused cores in every mode --------------------------------------------


def _jax_core(core, x, block):
    xj = jnp.asarray(x)
    if core == "loo":
        def f(s, ell, nu, y):
            a, dg = jloo.ard_loo_solve_diag(s, ell, nu, xj, y, block, True)
            return jnp.sum(jnp.sin(a) * dg) + jnp.sum(jnp.sqrt(dg))
    elif core == "kfold":
        def f(s, ell, nu, y):
            a, A = jloo.ard_kfold_solve_blocks(s, ell, nu, xj, y, 4, block, True)
            return jnp.sum(jnp.sin(a)) + jnp.sum(jnp.cos(A.astype(jnp.float32)))
    else:
        def f(s, ell, nu, y):
            return jloo.ard_nlml(s, ell, nu, xj, y, block, True)
    return f


def _torch_core(core, x, block):
    xt = t(x)
    if core == "loo":
        def f(s, ell, nu, y):
            a, dg = tloo.ard_loo_solve_diag(s, ell, nu, xt, y, block)
            return torch.sum(torch.sin(a) * dg) + torch.sum(torch.sqrt(dg))
    elif core == "kfold":
        def f(s, ell, nu, y):
            a, A = tloo.ard_kfold_solve_blocks(s, ell, nu, xt, y, 4, block)
            return torch.sum(torch.sin(a)) + torch.sum(torch.cos(A))
    else:
        def f(s, ell, nu, y):
            return tloo.ard_nlml(s, ell, nu, xt, y, block)
    return f


def held_to_mode(mode, got, want, grads, want_grads):
    """The value and gradients at the mode's tolerance (module docstring)."""
    if mode == "high":
        close(got, float(want), 1e-5)
        for g, w in zip(grads, want_grads):
            close(g, w, 2e-4, 1e-5)
        return
    close(got, float(want), 2e-2)
    for g, w in zip(grads, want_grads):
        assert _cosine(g, w) > 0.999, (mode, _cosine(g, w))


@pytest.mark.parametrize("mode", MODES[1:])
@pytest.mark.parametrize("core", ["loo", "kfold", "nlml"])
def test_fused_cores_in_each_mode_match_jax(monkeypatch, core, mode):
    monkeypatch.setattr(precision, "_SPLIT_MIN_K", 0)  # "high" splits at every size
    n, block = 52, 16  # a ragged last panel
    x, y, p = _problem(4, n)
    jargs = _jax_args(p) + [jnp.asarray(y)]
    with jax_matmul_mode(mode):  # read when jax.jit traces
        want, want_g = jax.jit(jax.value_and_grad(_jax_core(core, x, block),
                                                  argnums=(0, 1, 2, 3)))(*jargs)
    targs = _torch_args(p, requires_grad=True) + [torch.tensor(y, requires_grad=True)]
    with precision.matmul_mode(mode):
        got = _torch_core(core, x, block)(*targs)
        grads = torch.autograd.grad(got, targs)
        if core == "nlml":  # the value alone: the Cholesky and one solve
            with torch.no_grad():
                value_only = _torch_core(core, x, block)(*targs)
    assert got.dtype == torch.float32 and all(g.dtype == torch.float32 for g in grads)
    held_to_mode(mode, got, want, grads, want_g)
    if core == "nlml":
        close(value_only, float(want), 1e-5 if mode == "high" else 2e-2)


def test_auto_block_counts_the_storage_bytes():
    """At the JAX package's budget, per storage dtype: the 2-byte buffer
    leaves room for wider panels at the fp32 ceiling's sizes."""
    for n in (61440, 62464, 86016, 90112):
        for nbytes in (4, 2):
            assert tloo.auto_block(n, budget_bytes=jloo._HBM_BYTES,
                                   storage_bytes=nbytes) == jloo.auto_block(n, nbytes), n
    with precision.matmul_mode("f16"):
        assert tloo.auto_block(86016, budget_bytes=jloo._HBM_BYTES) == jloo.auto_block(86016, 2)


# ---- the storage-aware predictive -----------------------------------------------


@pytest.mark.parametrize("n,nt", [(64, 16), (52, 23)])
def test_predictive_at_f16_storage_plain_and_refined(n, nt):
    x, y, p = _problem(7, n)
    p["log_length"] = p["log_length"] + np.float32(1.0)  # longer lengths: a larger kappa
    xt = np.random.default_rng(8).standard_normal((nt, 3)).astype(np.float32)
    jp = jax_params(p)
    s, ell, nu = _jax_args(p)
    xj, xtj = jnp.asarray(x), jnp.asarray(xt)
    dense = jax_exact_predictive(jax_ard_gram(xtj, xj, s, ell), jax_ard_gram(xj, xj, s, ell),
                                 jax_ard_gram(xtj, xtj, s, ell), jnp.asarray(y), jnp.exp(nu))
    wm, wv = np.asarray(dense.mean), np.asarray(jnp.diagonal(dense.cov))

    def errs(pred):
        return (float(np.abs(pred.mean.numpy() - wm).max()),
                float(np.abs(pred.cov.numpy() - wv).max()))

    tp = torch_params(p)
    plain = texact.exact_predictive_diag_large(t(x), t(y), t(xt), tp, block=16, chunk=16,
                                               storage=torch.float16)
    refined = texact.exact_predictive_diag_large(t(x), t(y), t(xt), tp, block=16, chunk=16,
                                                 storage=torch.float16, refine=8)
    jax_refined = jax.jit(jax_predictive_large,
                          static_argnames=("block", "chunk", "storage", "refine"))(
        xj, jnp.asarray(y), xtj, jp, block=16, chunk=16, storage=jnp.float16, refine=8)
    em_p, ev_p = errs(plain)
    em_r, ev_r = errs(refined)
    assert max(em_p, ev_p) < 2e-2, (em_p, ev_p)
    assert em_r < 2e-4 and ev_r < 2e-4, (em_r, ev_r)
    assert em_r < 0.2 * max(em_p, 1e-6) or em_p < 2e-4
    close(refined.mean, jax_refined.mean, 2e-4, 2e-4)
    close(refined.cov, jax_refined.cov, 2e-4, 2e-4)
    # Without storage, refine changes nothing (the JAX function ignores it too).
    fp32 = texact.exact_predictive_diag_large(t(x), t(y), t(xt), tp, block=16, chunk=16)
    again = texact.exact_predictive_diag_large(t(x), t(y), t(xt), tp, block=16, chunk=16,
                                               refine=8)
    assert torch.equal(fp32.mean, again.mean) and torch.equal(fp32.cov, again.cov)
