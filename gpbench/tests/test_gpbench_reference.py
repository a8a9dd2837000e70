"""The plain reference agrees with the program's CPU path at tiny sizes, in
float64. The comparison lives here: the reference imports nothing of the
program."""

import pytest
import torch

from gpbench import reference
from gpbench.frozen import data as gen
from gpbench.tests.helpers import fused_from


def _port_value_grad(rule, model, leaves, x, y, **kw):
    from gpscore_torch.fit import make_objective
    from gpscore_torch.utils.params import GPParams

    q = {k: v.clone().requires_grad_() for k, v in leaves.items()}
    loss = make_objective(rule, model=model, **kw)(GPParams(**q), x, y)
    grads = torch.autograd.grad(loss.sum(), list(q.values()))
    return loss.detach(), dict(zip(q, grads))


def _close(ref, port, rtol):
    (rv, rg), (pv, pg) = ref, port
    torch.testing.assert_close(rv, pv, rtol=rtol, atol=0.0)
    for k in rg:
        scale = rg[k].abs().max()
        assert (rg[k] - pg[k]).abs().max() <= rtol * scale, k


@pytest.mark.parametrize("rule", ["crps", "nlml", "logs", "dss", "kc"])
@pytest.mark.parametrize("batch", [None, 3])
def test_fitc_reference_matches_the_port(rule, batch):
    X, Y = gen.synthesize_kin40k_like(7)
    x, y = gen.kin40k_replicate_split(X, Y, 0, n_subsample=96, n_va=20)
    x, y = torch.tensor(x, dtype=torch.float64), torch.tensor(y, dtype=torch.float64)
    g = torch.Generator().manual_seed(11)
    leaves = gen.init_rand_params(g, 8, 6, unit_scalars=batch is None, batch=batch)
    leaves = {k: v.double() for k, v in leaves.items()}
    ref = reference.fitc_value_grad(rule, leaves, x, y, fold_k=4)
    _close(ref, _port_value_grad(rule, "fitc", leaves, x, y), 1e-9)


@pytest.mark.parametrize("rule", ["crps", "dss", "nlml", "kc"])
def test_exact_reference_matches_the_fused_cores(rule):
    x, y = gen.large_n_data(192, 3, 5)
    x, y = x.double(), y.double()
    leaves = {"log_signal_sq": torch.tensor(0.2, dtype=torch.float64),
              "log_length": torch.tensor([0.3, 0.6, 0.9], dtype=torch.float64),
              "log_noise_sq": torch.tensor(-2.0, dtype=torch.float64)}
    ref = reference.exact_value_grad(rule, leaves, x, y, fold_k=4, block=40)
    with fused_from(128):
        port = _port_value_grad(rule, "exact", leaves, x, y, block=64)
    _close(ref, port, 1e-8)


def test_exact_value_without_gradient():
    x, y = gen.large_n_data(64, 2, 1)
    leaves = {k: v.double() for k, v in gen.unit_params(2).items()}
    v, g = reference.exact_value_grad("crps", leaves, x.double(), y.double(), want_grad=False)
    assert g is None and torch.isfinite(v)
