"""The port's CUDA kernels on the card. Every test here needs a CUDA device and
skips without one; on a machine with a card and no JAX, run them with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: tests/conftest.py sets JAX up). Nothing here imports JAX.
"""

import numpy as np
import pytest
import torch

from gpscore_torch.data import kin40k_fitc20_init, kin40k_replicate_split, load_kin40k
from gpscore_torch.fit import SCHEDULES, fit_gd, make_objective
from gpscore_torch.ops import _build, gram_cuda
from gpscore_torch.ops.kernels import gram

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the gpscore_torch kernels have no CPU mode")
    return torch.device("cuda", 0)


def _scaled(seed, n, m, d, dev):
    rng = np.random.default_rng(seed)
    xs = torch.tensor(rng.uniform(-1, 1, (n, d)).astype(np.float32), device=dev)
    xps = torch.tensor(rng.uniform(-1, 1, (m, d)).astype(np.float32), device=dev)
    g = torch.tensor(rng.standard_normal((n, m)).astype(np.float32), device=dev)
    return xs, xps, torch.tensor(1.7, device=dev), g


@pytest.mark.parametrize("n,m,d", [(500, 20, 8), (20, 20, 8), (257, 33, 1), (1031, 70, 17),
                                   (64, 9, 64)])
def test_gram_kernels_match_plain(dev, n, m, d):
    """Forward (atol 2e-5: the plain cross-term form's cancellation) and
    backward (1e-5 + 1e-4 * max|ref|: fp32 sums in another order)."""
    xs, xps, sig, g = _scaled(n + m + d, n, m, d, dev)
    K = gram_cuda.gram_fwd_cuda(xs, xps, sig)
    assert (K - gram_cuda.gram_fwd_plain(xs, xps, sig)).abs().max() <= 2e-5
    for a, b in zip(gram_cuda.gram_bwd_cuda(xs, xps, sig, g),
                    gram_cuda.gram_bwd_plain(xs, xps, sig, g)):
        assert (a - b).abs().max() <= 1e-5 + 1e-4 * b.abs().max()


def test_gram_kernel_square_is_exactly_symmetric_with_exact_diagonal(dev):
    xs, _, sig, _ = _scaled(1, 20, 20, 8, dev)
    K = gram_cuda.gram_fwd_cuda(xs, xs, sig)
    assert torch.equal(K, K.T)
    assert torch.equal(torch.diagonal(K), sig.expand(20))


def test_ard_gram_grads_on_cuda_match_cpu(dev):
    rng = np.random.default_rng(2)
    host = [rng.standard_normal((40, 3)), rng.standard_normal((7, 3)), np.float64(0.3),
            0.2 * rng.standard_normal(3)]
    g = torch.tensor(rng.standard_normal((40, 7)), dtype=torch.float32)
    grads = {}
    for where in ("cpu", dev):
        args = [torch.tensor(a, dtype=torch.float32, device=where, requires_grad=True)
                for a in host]
        K = gram(*args)
        grads[str(where)] = torch.autograd.grad(torch.sum(K * g.to(where)), args)
    for a, b in zip(grads[str(dev)], grads["cpu"]):
        assert torch.allclose(a.cpu(), b, rtol=1e-4, atol=1e-5)


def test_gram_on_cuda_launches_and_counts(dev):
    gram_cuda.reset_launches()
    u = torch.rand(20, 8, device=dev, requires_grad=True)
    gram(u, u, torch.tensor(0.0, device=dev), torch.zeros(8, device=dev)).sum().backward()
    assert gram_cuda.LAUNCHES == {"fwd": 1, "bwd_rows": 1, "bwd_cols": 1}


def test_gram_on_cuda_raises_when_the_library_cannot_be_built(dev, monkeypatch):
    def broken():
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "build", broken)
    u = torch.rand(5, 2, device=dev)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        gram(u, u, 0.0, torch.zeros(2, device=dev))


def test_kernel_rejects_non_contiguous_cuda_input(dev):
    xs = torch.rand(8, 5, device=dev).T
    with pytest.raises(ValueError):
        gram_cuda.gram_fwd_cuda(xs, torch.rand(3, 8, device=dev), torch.tensor(1.0, device=dev))


def test_fit_steps_on_cuda_match_cpu_at_the_same_parameters(dev):
    """Five crps GD steps on CUDA; the loss at every recorded point agrees
    with the CPU's at the same parameters (rtol 1e-4)."""
    data = load_kin40k()
    gpu, cpu = kin40k_replicate_split(data, 0, device=dev), kin40k_replicate_split(data, 0)
    sched = SCHEDULES[("kin40k_fitc", "crps")]
    loss = make_objective("crps", model="fitc")
    res = fit_gd(loss, kin40k_fitc20_init(dev), gpu.train_x, gpu.train_y, 5, sched.lr,
                 sched.lr_inducing, record_params=True)
    p_cpu = kin40k_fitc20_init()
    for i in range(5):
        at = {f: t[i].cpu() for f, t in res.param_history.leaves().items()}
        want = loss(p_cpu.replace(**at), cpu.train_x, cpu.train_y)
        assert abs(float(res.loss_history[i]) - float(want)) <= 1e-4 * abs(float(want))
