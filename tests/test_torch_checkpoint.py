"""The port's checkpoints (gpscore_torch.utils.checkpoint) against
gpscore.utils.checkpoint: round trips, the leaf order of jax.tree_util, and
files that cross between the packages leaf for leaf, bitwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpscore.fit.train import FitResult as JaxFitResult
from gpscore.utils import checkpoint as jckpt
from gpscore.utils.params import GPParams as JaxParams
from gpscore_torch.data import sample_synthetic_1d
from gpscore_torch.fit import FitResult, fit_gd, make_objective
from gpscore_torch.utils import checkpoint as tckpt
from gpscore_torch.utils.params import (GPParams, init_unit_params, params_from_checkpoint,
                                        save_params_checkpoint)


def _arrays(seed, R=None, d=3, m=None, iters=None):
    rng = np.random.default_rng(seed)
    lead = () if R is None else (R,)
    lead = lead if iters is None else (iters, *lead)
    a = {"log_signal_sq": rng.standard_normal(lead).astype(np.float32),
         "log_length": rng.standard_normal((*lead, d)).astype(np.float32),
         "log_noise_sq": rng.standard_normal(lead).astype(np.float32)}
    if m is not None:
        a["inducing"] = rng.standard_normal((*lead, m, d)).astype(np.float32)
    return a


def _tp(a):
    return GPParams(**{k: torch.from_numpy(v.copy()) for k, v in a.items()})


def _jp(a):
    return JaxParams(**{k: jnp.asarray(v) for k, v in a.items()})


def _fit_result(make_params, conv, seed=0, iters=5):
    rng = np.random.default_rng(seed + 100)
    return (make_params(_arrays(seed, m=4)), conv(rng.standard_normal(iters).astype(np.float32)),
            conv(np.array(True)), make_params(_arrays(seed + 1, m=4, iters=iters)),
            conv(np.array(0, np.int32)))


def _structures(kind):
    """The same trees as the port builds them (kind "torch") and as the JAX
    package builds them ("jax")."""
    if kind == "torch":
        conv, params, result = (lambda v: torch.from_numpy(np.array(v))), _tp, FitResult
    else:
        conv, params, result = jnp.asarray, _jp, JaxFitResult
    return {
        "params": params(_arrays(1, m=5)),
        "batched_no_inducing": params(_arrays(2, R=4)),
        "fit_result": result(*_fit_result(params, conv)),
        "nested": {"z": [conv(np.arange(3, dtype=np.float32)), (conv(np.float32(2.5)), None)],
                   "a": (params(_arrays(3)), {"k2": conv(np.int32(7)),
                                              "k1": conv(np.ones((2, 2), np.float32))})},
    }


def _np_leaves(tree):
    return [np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
            for v in tckpt.tree_leaves(tree)]


@pytest.mark.parametrize("name", ["params", "batched_no_inducing", "fit_result", "nested"])
def test_leaf_order_is_jax_tree_utils(name):
    want = jax.tree_util.tree_leaves(_structures("jax")[name])
    got = _np_leaves(_structures("torch")[name])
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("name", ["params", "batched_no_inducing", "fit_result", "nested"])
def test_round_trip_is_bitwise(tmp_path, name):
    tree = _structures("torch")[name]
    path = str(tmp_path / "tree.npz")
    tckpt.save_pytree(path, tree)
    back = tckpt.load_pytree(path, tree)
    assert type(back) is type(tree)
    for a, b in zip(tckpt.tree_leaves(back), tckpt.tree_leaves(tree)):
        assert isinstance(a, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    if name == "batched_no_inducing":
        assert back.inducing is None and back.log_length.shape == (4, 3)
    if name == "fit_result":
        assert back.param_history.inducing.shape == (5, 4, 3)
    if name == "nested":
        assert back["z"][1][1] is None and list(back["a"][1]) == ["k1", "k2"]


@pytest.mark.parametrize("name", ["params", "batched_no_inducing", "fit_result", "nested"])
def test_jax_files_load_in_the_port_and_back(tmp_path, name):
    jtree, ttree = _structures("jax")[name], _structures("torch")[name]
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "torch.npz")
    jckpt.save_pytree(jpath, jtree)
    tckpt.save_pytree(tpath, ttree)
    from_jax = tckpt.load_pytree(jpath, ttree)
    for a, b in zip(_np_leaves(from_jax), jax.tree_util.tree_leaves(jtree)):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))
    from_port = jckpt.load_pytree(tpath, jtree)
    for a, b in zip(jax.tree_util.tree_leaves(from_port), _np_leaves(ttree)):
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), b)


def test_a_fits_result_with_its_parameter_history_round_trips(tmp_path):
    d = sample_synthetic_1d(torch.Generator().manual_seed(0), num_train=24, num_test=4,
                            num_va=4)
    p0 = init_unit_params(d=1, isotropic=False, inducing=torch.linspace(-2, 2, 4)[:, None])
    res = fit_gd(make_objective("crps", model="fitc"), p0, d.train_x, d.train_y, iters=6,
                 lr=0.5, record_params=True)
    path = str(tmp_path / "fit.npz")
    tckpt.save_pytree(path, res)
    back = tckpt.load_pytree(path, res)
    assert isinstance(back, FitResult) and back.param_history.inducing.shape == (6, 4, 1)
    assert all(torch.equal(a, b) for a, b in zip(tckpt.tree_leaves(back),
                                                  tckpt.tree_leaves(res)))


def test_load_refuses_a_template_of_another_leaf_count(tmp_path):
    path = str(tmp_path / "p.npz")
    tckpt.save_pytree(path, _tp(_arrays(0, m=3)))
    with pytest.raises(ValueError, match="4 leaves; template expects 3"):
        tckpt.load_pytree(path, _tp(_arrays(0)))


def test_params_checkpoints_keep_their_layout(tmp_path):
    """save_params_checkpoint is save_pytree of a GPParams: JAX reads it as
    such, and params_from_checkpoint reads JAX's."""
    p = _tp(_arrays(4, R=2, m=3))
    path = str(tmp_path / "p.npz")
    save_params_checkpoint(path, p)
    with np.load(path) as z:
        assert sorted(z.files) == ["__meta__", "leaf_0", "leaf_1", "leaf_2", "leaf_3"]
    back = jckpt.load_pytree(path, _jp(_arrays(0, R=2, m=3)))
    np.testing.assert_array_equal(np.asarray(back.inducing), p.inducing.numpy())
    jckpt.save_pytree(path, _jp(_arrays(5)))
    q = params_from_checkpoint(path)
    assert q.inducing is None
    np.testing.assert_array_equal(q.log_length.numpy(), _arrays(5)["log_length"])


def test_save_metrics_takes_tensors(tmp_path):
    m = {"crps": {"mse": torch.tensor(0.5), "series": torch.arange(3.0),
                  "np": np.float32(0.25)}, "n": 2, "pair": (torch.tensor([1, 2]), 3.0)}
    path = str(tmp_path / "m.json")
    tckpt.save_metrics(path, m)
    for got in (tckpt.load_metrics(path), jckpt.load_metrics(path)):
        assert got == {"crps": {"mse": 0.5, "series": [0.0, 1.0, 2.0], "np": 0.25}, "n": 2,
                       "pair": [[1, 2], 3.0]}
