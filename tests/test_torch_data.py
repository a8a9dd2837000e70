"""The port's data, schedules, parameters and package boundary against gpscore's."""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpscore.data import kin40k as jkin
from gpscore.fit.schedules import SCHEDULES as JAX_SCHEDULES
from gpscore_torch.data import kin40k as tkin
from gpscore_torch.fit.schedules import SCHEDULES, get_schedule, rules_for
from gpscore_torch.utils import params as tparams
from gpscore_torch.utils import precision

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def data():
    return jkin.synthesize_kin40k_like(), tkin.synthesize_kin40k_like()


def test_stand_in_data_is_the_jax_packages(data):
    jd, td = data
    for a, b in zip(jd, td):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("replicate,n_subsample", [(0, 500), (3, 500), (0, 9700)])
def test_replicate_split_rows_equal_jax(data, replicate, n_subsample):
    jd, td = data
    want = jkin.kin40k_replicate_split(jd, replicate, n_subsample=n_subsample)
    got = tkin.kin40k_replicate_split(td, replicate, n_subsample=n_subsample)
    for f in want._fields:
        g = getattr(got, f)
        assert isinstance(g, torch.Tensor) and g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(getattr(want, f)))
    assert got.train_x.shape == (n_subsample, 8)


def test_load_kin40k_reads_npz_and_csv_like_jax(tmp_path, data):
    _, td = data
    small = tkin.Kin40k(td.train_x[:40], td.train_y[:40], td.test_x[:10], td.test_y[:10])
    npz = tmp_path / "k.npz"
    np.savez(npz, trainx=small.train_x, trainy=small.train_y, testx=small.test_x,
             testy=small.test_y)
    csv_dir = tmp_path / "csv"
    csv_dir.mkdir()
    for name, arr in zip(["trainx", "trainy", "testx", "testy"], small):
        np.savetxt(csv_dir / f"{name}.csv", arr, delimiter=",")
    for path in (str(npz), str(csv_dir)):
        for a, b in zip(tkin.load_kin40k(path), jkin.load_kin40k(path)):
            np.testing.assert_array_equal(a, b)
    xlsx = tmp_path / "k.xlsx"
    xlsx.write_bytes(b"")
    with pytest.raises(NotImplementedError):
        tkin.load_kin40k(str(xlsx))
    parquet = tmp_path / "k.parquet"
    parquet.write_bytes(b"")
    with pytest.raises(ValueError):
        tkin.load_kin40k(str(parquet))


def test_schedules_equal_jax():
    assert SCHEDULES.keys() == JAX_SCHEDULES.keys()
    for k, s in SCHEDULES.items():
        assert dataclasses.astuple(s) == dataclasses.astuple(JAX_SCHEDULES[k])
    assert rules_for("kin40k_fitc") == ["crps", "nlml", "logs", "dss", "kc", "interval"]
    assert get_schedule("kin40k_fitc", "crps").iters == 2000
    with pytest.raises(KeyError):
        get_schedule("kin40k_fitc", "es")


def test_committed_init_equals_the_bench_draw():
    """gpscore_torch/data/kin40k_fitc20_init.json holds the draw of bench.py:50-57."""
    key = jax.random.PRNGKey(0)
    k_l, k_u = jax.random.split(key)
    want = {
        "log_signal_sq": np.ones((), np.float32),
        "log_length": np.asarray(jax.random.uniform(k_l, (8,))),
        "log_noise_sq": np.ones((), np.float32),
        "inducing": np.asarray(jax.random.uniform(k_u, (20, 8))),
    }
    got = tparams.params_to_numpy(tkin.kin40k_fitc20_init())
    for f, w in want.items():
        assert got[f].dtype == np.float32
        np.testing.assert_array_equal(got[f], w)


def test_params_round_trip_and_helpers():
    p = {"log_signal_sq": np.float32(0.5), "log_length": np.arange(3, dtype=np.float32),
         "log_noise_sq": np.float32(-1.0), "inducing": None}
    tp = tparams.params_from_numpy(p)
    assert tp.inducing is None and set(tp.leaves()) == {"log_signal_sq", "log_length",
                                                        "log_noise_sq"}
    back = tparams.params_to_numpy(tp)
    for f in ("log_signal_sq", "log_length", "log_noise_sq"):
        np.testing.assert_array_equal(back[f], p[f])
    assert float(tp.signal_sq) == pytest.approx(np.exp(0.5))
    assert float(tp.noise_sq) == pytest.approx(np.exp(-1.0))
    assert tp.replace(log_noise_sq=torch.tensor(2.0)).log_noise_sq == 2.0
    u = tparams.init_unit_params(d=4, isotropic=False, inducing=torch.zeros(3, 4))
    assert u.log_length.shape == (4,) and float(u.log_signal_sq) == 1.0
    assert tparams.init_unit_params().log_length.shape == ()


def test_precision_is_ieee_fp32_and_reduced_modes_raise():
    assert precision.get_matmul_mode() == "highest"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
    precision.set_matmul_mode("highest")
    for mode in ("high", "fast", "bf16", "f16"):
        with pytest.raises(NotImplementedError):
            precision.set_matmul_mode(mode)
    with pytest.raises(ValueError):
        precision.set_matmul_mode("tf32")


def test_import_pulls_in_neither_jax_nor_gpscore_nor_triton():
    # The package, and the modules that `import gpscore_torch` does not load.
    code = ("import sys, gpscore_torch, gpscore_torch.ops.potri_inplace, "
            "gpscore_torch.ops.loo_fused, gpscore_torch.ops.fold_stream, "
            "gpscore_torch.experiments.large_n, "
            "gpscore_torch.experiments.bench_ceiling, gpscore_torch.bench_gram; "
            "bad = [m for m in ('jax', 'gpscore', 'triton') if m in sys.modules]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_init_json_is_plain_float32_values():
    with open(tkin._FITC20_INIT) as f:
        raw = json.load(f)
    assert np.asarray(raw["inducing"]).shape == (20, 8)
    assert np.asarray(raw["log_length"]).shape == (8,)
    for f in ("log_length", "inducing"):
        arr = np.asarray(raw[f], np.float64)
        np.testing.assert_array_equal(arr, arr.astype(np.float32).astype(np.float64))
    assert raw["log_signal_sq"] == raw["log_noise_sq"] == 1.0
