"""The fused small factor-and-solve (``linalg.chol_solve_small``) on the CPU.

``linalg.CholSolveSmall`` on CPU tensors is the emulation of the two CUDA
kernels (``csrc/chol_small.cu``): its forward is the library chain, its
backward the kernels' closed-form formulas in torch. Here it is held against
the library chain (``chol_factor`` with ``tri_solve`` or
``chol_solve_from_factor``) and its autograd in float64, values and
gradients, in both modes; the failure semantics, the cotangents that do not
reach a loss, and the dispatch rule and counter are pinned. The kernels
themselves are held against the emulation on the card
(tests/test_torch_cuda.py). Nothing here imports JAX.
"""

import re
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gpscore_torch.ops import linalg
from gpscore_torch.utils import profiling

F64 = torch.float64
CSRC = Path(linalg.__file__).resolve().parent.parent / "csrc" / "chol_small.cu"


def _spd(m, lead, seed, dtype=F64):
    g = torch.Generator().manual_seed(seed)
    v = torch.randn((*lead, m, m), generator=g, dtype=dtype)
    return v @ v.mT / m + torch.eye(m, dtype=dtype)


def _rhs(m, k, lead, seed, dtype=F64):
    return torch.randn((*lead, m, k), generator=torch.Generator().manual_seed(seed), dtype=dtype)


def _library(A, B, full):
    L = linalg.chol_factor(A)
    return L, linalg.chol_solve_from_factor(L, B) if full else linalg.tri_solve(L, B)


def _sym(A):
    """The factor reads A's lower triangle: a symmetric parameterization makes
    the numerical Jacobian the analytic one's."""
    return 0.5 * (A + A.mT)


CASES = [(m, k, lead) for m in (1, 2, 20, 33) for k in (1, 125, 500)
         for lead in ((), (4,), (3, 4))]


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("m,k,lead", CASES)
def test_emulation_matches_the_library_chain_and_its_autograd(m, k, lead, full):
    """Values to 1e-12 and the VJP of random cotangents on L and X to 1e-10
    of their scale, float64."""
    A = _spd(m, lead, seed=m + k).requires_grad_()
    B = _rhs(m, k, lead, seed=m * k + 1).requires_grad_()
    L, X = linalg.CholSolveSmall.apply(A, B, full)
    Lw, Xw = _library(A, B, full)
    assert X.shape == Xw.shape == (*lead, m, k)
    torch.testing.assert_close(L, Lw, rtol=0, atol=1e-12)
    torch.testing.assert_close(X, Xw, rtol=1e-12, atol=1e-12 * float(Xw.detach().abs().max()))
    g = torch.Generator().manual_seed(7)
    cL, cX = (torch.randn(t.shape, generator=g, dtype=F64) for t in (L, X))
    got = torch.autograd.grad((L * cL).sum() + (X * cX).sum(), (A, B))
    want = torch.autograd.grad((Lw * cL).sum() + (Xw * cX).sum(), (A, B))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-10 * float(b.abs().max()))
    torch.testing.assert_close(got[0], got[0].mT, rtol=0, atol=0)  # A_bar exactly symmetric


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("m,k,lead", [(1, 1, ()), (2, 3, (4,)), (20, 125, ()), (33, 500, (4,)),
                                      (20, 1, (3, 4))])
def test_emulation_passes_gradcheck(m, k, lead, full):
    A = _spd(m, lead, seed=3 * m + k).requires_grad_()
    B = _rhs(m, k, lead, seed=k).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda a, b: linalg.CholSolveSmall.apply(_sym(a), b, full), (A, B), fast_mode=True)


@pytest.mark.parametrize("full", [False, True])
def test_a_non_spd_matrix_is_nan_and_its_neighbours_are_not(full):
    """A failed factor gives what chol_factor gives: NaN on and below the
    diagonal, 0 above, X NaN and the gradient NaN; only for that matrix."""
    A = _spd(20, (4,), seed=1)
    A[2, 5, 5] = -3.0
    A.requires_grad_()
    B = _rhs(20, 125, (4,), seed=2).requires_grad_()
    L, X = linalg.CholSolveSmall.apply(A, B, full)
    Lw, Xw = _library(A, B, full)
    tri = torch.ones(20, 20, dtype=torch.bool).tril()
    assert torch.isnan(L[2][tri]).all() and (L[2][~tri] == 0).all() and torch.isnan(X[2]).all()
    torch.testing.assert_close(L, Lw, equal_nan=True, rtol=0, atol=1e-12)
    torch.testing.assert_close(X, Xw, equal_nan=True, rtol=1e-12, atol=1e-10)
    gA, gB = torch.autograd.grad(linalg.half_logdet(L).sum() + X.sum(), (A, B))
    ok = [0, 1, 3]
    assert torch.isnan(gA[2]).all() and torch.isnan(gB[2]).all()
    assert torch.isfinite(gA[ok]).all() and torch.isfinite(gB[ok]).all()


@pytest.mark.parametrize("full", [False, True])
def test_a_cotangent_that_does_not_reach_the_loss_is_zero(full):
    """A loss of L alone (X_bar = 0) and one of X alone (L_bar = 0) against
    the library chain's gradients; the backward given explicit zeros
    equals the one given None."""
    A = _spd(20, (4,), seed=5).requires_grad_()
    B = _rhs(20, 125, (4,), seed=6).requires_grad_()
    L, X = linalg.CholSolveSmall.apply(A, B, full)
    Lw, Xw = _library(A, B, full)
    for loss, loss_w in ((linalg.half_logdet(L).sum(), linalg.half_logdet(Lw).sum()),
                         ((X * X).sum(), (Xw * Xw).sum())):
        got = torch.autograd.grad(loss, (A, B), allow_unused=True, retain_graph=True)
        want = torch.autograd.grad(loss_w, (A, B), allow_unused=True, retain_graph=True)
        for a, b in zip(got, want):
            if b is None:
                assert a is None or (a == 0).all()
            else:
                torch.testing.assert_close(a, b, rtol=0, atol=1e-10 * float(b.abs().max()))
    L0, X0 = L.detach(), X.detach()
    cL, cX = torch.randn_like(L0), torch.randn_like(X0)
    for c in ((cL, None), (None, cX)):
        zeros = tuple(torch.zeros_like(t) if v is None else v for v, t in zip(c, (L0, X0)))
        a = linalg._chol_small_bwd_plain(L0, X0.mT, c[0], None if c[1] is None else c[1].mT,
                                         full)
        b = linalg._chol_small_bwd_plain(L0, X0.mT, zeros[0], zeros[1].mT, full)
        torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)
        if c[1] is not None:
            torch.testing.assert_close(a[1], b[1], rtol=0, atol=0)


def _fake(device, dtype, shape):
    return SimpleNamespace(device=torch.device(device), dtype=dtype, shape=torch.Size(shape))


def test_the_dispatch_rule():
    """CPU: the library chain; CUDA float32 / float64 up to CHOL_SMALL_MAX_M,
    B of A's leading dimensions: the kernels; past it, another dtype or
    leading dimensions to broadcast: the library chain."""
    assert linalg.CHOL_SMALL_MAX_M == 32
    M = linalg.CHOL_SMALL_MAX_M
    f32 = torch.float32
    for device, dtype, m, b_lead, want in [
            ("cpu", f32, 20, (4,), "library"), ("cpu", F64, 1, (4,), "library"),
            ("cuda", f32, 20, (4,), "fused"), ("cuda", F64, M, (4,), "fused"),
            ("cuda", f32, 1, (4,), "fused"), ("cuda", f32, M + 1, (4,), "library"),
            ("cuda", f32, 256, (4,), "library"), ("cuda", torch.float16, 20, (4,), "library"),
            ("cuda", f32, 20, (), "library"), ("cuda", f32, 20, (3, 4), "library")]:
        A, B = _fake(device, dtype, (4, m, m)), _fake(device, dtype, (*b_lead, m, 500))
        assert linalg.chol_small_path(A, B) == want, (device, dtype, m, b_lead)


def test_calls_are_counted_by_path_and_are_spans():
    before = dict(linalg.CHOL_SMALL)
    A, B = _spd(6, (3,), seed=0), _rhs(6, 4, (3,), seed=1)
    start = profiling._LOG.next_id
    with profile(activities=[ProfilerActivity.CPU]):
        L, X = linalg.chol_solve_small(A, B)
        linalg.chol_solve_small(A[0], B, full=True)
    assert linalg.CHOL_SMALL == {"fused": before["fused"], "library": before["library"] + 2}
    recs = [r for r in profiling.spans()[0] if r.id >= start and r.name == "chol.small"]
    assert [r.attrs for r in recs] == [
        {"path": "library", "m": 6, "k": 4, "batch": 3, "full": False},
        {"path": "library", "m": 6, "k": 4, "batch": None, "full": True}]
    # The CPU path is the library chain, bit for bit.
    Lw, Xw = _library(A, B, False)
    assert torch.equal(L, Lw) and torch.equal(X, Xw)


def test_tile_rows_and_constants_match_the_source():
    src = CSRC.read_text()

    def const(name):
        return int(re.search(rf"constexpr \w+ {name} = (\d+);", src).group(1))

    assert const("kCsMaxM") == linalg.CHOL_SMALL_MAX_M
    assert const("kCsThreads") == linalg.CHOL_SMALL_THREADS
    assert [linalg.chol_small_tile_rows(k) for k in (0, 1, 32, 33, 125, 500, 9700)] == \
        [32, 32, 32, 64, 128, 256, 256]


def test_a_call_imports_nothing_heavy():
    """The dispatcher's first call imports no sympy (torch.broadcast_shapes
    would, ~4 s of a fit's set-up)."""
    import subprocess
    import sys

    code = ("import sys, torch\n"
            "from gpscore_torch.ops import linalg\n"
            "A = torch.eye(3) + torch.zeros(2, 3, 3)\n"
            "L, X = linalg.chol_solve_small(A, torch.ones(2, 3, 5))\n"
            "assert X.shape == (2, 3, 5)\n"
            "print('sympy' in sys.modules)\n")
    root = Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=300)
    assert out.stdout.strip() == "False", out.stdout + out.stderr
