"""The port's Gram (gpscore_torch.ops) against gpscore.ops, forward and backward.

On the CPU the Gram kernel's wrapper runs its plain version; the CUDA kernels
themselves are checked by the ``cuda``-marked test (and by chip_smoke.py).
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from gpscore.ops.gram_pallas import ard_gram_pallas
from gpscore.ops.kernels import ard_gram as jax_ard_gram
from gpscore.ops.kernels import rbf_gram as jax_rbf_gram
from gpscore_torch.ops import _build, gram_cuda
from gpscore_torch.ops.gram_cuda import ArdGram
from gpscore_torch.ops.kernels import ard_gram, gram, kernel_diag, rbf_gram
from torch_parity import close, t


def _inputs(seed, n, m, d):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    xp = rng.standard_normal((m, d)).astype(np.float32)
    ll = (0.2 * rng.standard_normal(d)).astype(np.float32)
    g = rng.standard_normal((n, m)).astype(np.float32)
    return x, xp, ll, g


@pytest.mark.parametrize("n,m,d", [(40, 30, 3), (128, 8, 3), (17, 11, 1), (64, 6, 8)])
def test_gram_fwd_matches_jax_and_pallas(n, m, d):
    """gram() (ArdGram, plain on CPU) vs jnp ard_gram and the Pallas kernel in
    interpret mode, atol 1e-5 as tests/test_kernels.py holds Pallas to jnp."""
    x, xp, ll, _ = _inputs(n + m + d, n, m, d)
    got = gram(t(x), t(xp), 0.3, t(ll))
    close(got, jax_ard_gram(jnp.asarray(x), jnp.asarray(xp), 0.3, jnp.asarray(ll)), 0, 1e-5)
    close(got, ard_gram_pallas(jnp.asarray(x), jnp.asarray(xp), 0.3, jnp.asarray(ll)), 0, 1e-5)
    close(got, oracle.ard_gram(x, xp, 0.3, ll), 0, 1e-5)


def test_plain_ard_and_rbf_grams_match_jax():
    x, xp, ll, _ = _inputs(1, 37, 23, 2)
    close(ard_gram(t(x), t(xp), 0.2, t(ll)),
          jax_ard_gram(jnp.asarray(x), jnp.asarray(xp), 0.2, jnp.asarray(ll)), 0, 1e-5)
    close(rbf_gram(t(x), t(xp), 0.2, -0.4),
          jax_rbf_gram(jnp.asarray(x), jnp.asarray(xp), 0.2, -0.4), 0, 1e-5)


def test_gram_rbf_rides_the_ard_kernel():
    """kind="rbf" (log squared length b) equals ARD with b/2 in every dim."""
    x, xp, _, _ = _inputs(2, 30, 9, 3)
    got = gram(t(x), t(xp), 0.1, torch.tensor(-0.4), kind="rbf")
    close(got, jax_rbf_gram(jnp.asarray(x), jnp.asarray(xp), 0.1, -0.4), 0, 1e-5)
    close(got, oracle.rbf_gram(x, xp, 0.1, -0.4), 0, 1e-5)
    with pytest.raises(ValueError):
        gram(t(x), t(xp), 0.1, torch.tensor(-0.4), kind="matern")


def test_kernel_diag():
    x, _, _, _ = _inputs(3, 11, 1, 2)
    close(kernel_diag(t(x), 0.7), np.full(11, np.exp(0.7), np.float32), 1e-6)


@pytest.mark.parametrize("case", ["cross", "same", "scalar_length"])
def test_ard_gram_grads_match_jax(case):
    """ArdGram's four gradients vs jax.grad of jnp ard_gram, at the tolerance
    of tests/test_kernels.py (rtol/atol 3e-4)."""
    x, xp, ll, _ = _inputs(4, 17, 11, 3)
    if case == "same":
        xp = x
    if case == "scalar_length":
        x, xp = x[:, :1].copy(), xp[:, :1].copy()
        ll = np.float32(0.25)
    g = np.random.default_rng(5).standard_normal((x.shape[0], xp.shape[0])).astype(np.float32)

    def loss_jax(x, xp, sig, ll):
        return jnp.sum(jax_ard_gram(x, xp, sig, ll) * g)

    want = jax.grad(loss_jax, argnums=(0, 1, 2, 3))(
        jnp.asarray(x), jnp.asarray(xp), jnp.float32(0.4), jnp.asarray(ll))
    args = [t(a).clone().requires_grad_() for a in (x, xp, np.float32(0.4), ll)]
    got = torch.autograd.grad(torch.sum(ArdGram.apply(*args) * t(g)), args)
    for a, b in zip(got, want):
        close(a, b, 3e-4, 3e-4)


def test_ard_gram_grads_same_tensor_sum_into_one():
    """K(u, u) with one leaf: both input gradients land on u."""
    x, _, ll, _ = _inputs(6, 9, 1, 3)
    g = np.random.default_rng(7).standard_normal((9, 9)).astype(np.float32)

    def loss_jax(u, ll):
        return jnp.sum(jax_ard_gram(u, u, 0.2, ll) * g)

    want = jax.grad(loss_jax, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(ll))
    u, lt = t(x).requires_grad_(), t(ll).requires_grad_()
    got = torch.autograd.grad(torch.sum(gram(u, u, 0.2, lt) * t(g)), [u, lt])
    for a, b in zip(got, want):
        close(a, b, 3e-4, 3e-4)


def test_ard_gram_gradcheck_float64():
    rng = np.random.default_rng(8)
    args = [
        torch.tensor(rng.standard_normal((7, 3)), dtype=torch.float64, requires_grad=True),
        torch.tensor(rng.standard_normal((5, 3)), dtype=torch.float64, requires_grad=True),
        torch.tensor(0.3, dtype=torch.float64, requires_grad=True),
        torch.tensor(0.2 * rng.standard_normal(3), dtype=torch.float64, requires_grad=True),
    ]
    assert torch.autograd.gradcheck(ArdGram.apply, args)


def test_transposed_cotangent_is_made_contiguous():
    """The FITC terms hand the Gram a transposed cotangent (V = solve(L, K^T)^T);
    the result equals the one from a contiguous copy."""
    x, xp, ll, g = _inputs(9, 20, 6, 3)
    gt = t(g.T.copy()).T  # non-contiguous view of the same values
    assert not gt.is_contiguous()
    xs = [t(x).requires_grad_(), t(xp).requires_grad_()]
    a = torch.autograd.grad(torch.sum(gram(*xs, 0.1, t(ll)) * gt), xs)
    b = torch.autograd.grad(torch.sum(gram(*xs, 0.1, t(ll)) * t(g)), xs)
    for u, v in zip(a, b):
        close(u, v.numpy(), 1e-6, 1e-7)


def test_plain_bwd_matches_autograd_of_plain_fwd():
    """gram_bwd_plain (the kernels' oracle) is the VJP of gram_fwd_plain."""
    x, xp, _, g = _inputs(10, 13, 7, 4)
    xs, xps = t(x).double().requires_grad_(), t(xp).double().requires_grad_()
    sig = torch.tensor(1.3, dtype=torch.float64)
    K = gram_cuda.gram_fwd_plain(xs, xps, sig)
    want = torch.autograd.grad(torch.sum(K * t(g).double()), [xs, xps])
    d_xs, d_xps, row = gram_cuda.gram_bwd_plain(xs.detach(), xps.detach(), sig, t(g).double())
    close(d_xs, want[0], 1e-10, 1e-12)
    close(d_xps, want[1], 1e-10, 1e-12)
    close(row, (K.detach() * t(g).double()).sum(1), 1e-10, 1e-12)


def test_cpu_path_launches_no_kernel():
    before = dict(gram_cuda.LAUNCHES)
    x, xp, ll, _ = _inputs(11, 8, 4, 2)
    xs = t(x).requires_grad_()
    gram(xs, t(xp), 0.0, t(ll)).sum().backward()
    assert gram_cuda.LAUNCHES == before


@pytest.mark.parametrize(
    "bad",
    ["dtype", "contiguity", "d_mismatch", "sig_shape", "cotangent_shape"],
)
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(bad):
    xs, xps, sig = torch.zeros(5, 3), torch.zeros(4, 3), torch.tensor(1.0)
    g = torch.zeros(5, 4)
    if bad == "dtype":  # float16 inputs: the kernels take float32 or float64
        xs, xps, sig, g = xs.half(), xps.half(), sig.half(), g.half()
    elif bad == "contiguity":
        xs = torch.zeros(3, 5).T
    elif bad == "d_mismatch":
        xps = torch.zeros(4, 2)
    elif bad == "sig_shape":
        sig = torch.ones(2)
    elif bad == "cotangent_shape":
        g = torch.zeros(4, 5)
    with pytest.raises((TypeError, ValueError)):
        gram_cuda._check(xs, xps, sig, g)


@pytest.mark.parametrize("case", ["d65", "float64", "float64_d130", "mixed_dtypes"])
def test_kernel_wrapper_accepts_any_d_and_float64(case):
    """Past 64 features the kernels walk d in chunks, and they have float64
    builds: _check passes both (a call mixing the two dtypes still raises)."""
    d = {"d65": 65, "float64_d130": 130}.get(case, 3)
    dt = torch.float32 if case == "d65" else torch.float64
    xs, xps, g = (torch.zeros(shape, dtype=dt) for shape in ((5, d), (4, d), (5, 4)))
    sig = torch.tensor(1.0, dtype=dt)
    if case == "mixed_dtypes":
        with pytest.raises(TypeError):
            gram_cuda._check(xs, xps.float(), sig, g)
        return
    assert gram_cuda._check(xs, xps, sig, g) is None
    assert gram_cuda._check(xs[None].contiguous(), xps, sig, g[None].contiguous()) == 1


def _wide(seed, n, m, d, dtype):
    """Inputs at d features, squared lengths ~ d / 10, so that the exponent
    is ~10 and K spans a range, not all ~0 or ~sig."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(dtype)
    xp = rng.standard_normal((m, d)).astype(dtype)
    ll = (0.5 * np.log(d / 10) + 0.2 * rng.standard_normal(d)).astype(dtype)
    g = rng.standard_normal((n, m)).astype(dtype)
    return x, xp, ll, g


@pytest.mark.parametrize("d", [65, 130])
def test_wide_d_gram_and_grads_match_jax(d):
    """At d past the kernels' 64-feature chunk: gram() (ArdGram, plain on the
    CPU) and its four gradients against jnp ard_gram and jax.grad, fp32,
    1e-5 relative (the gradients relative to each one's largest entry: the
    two sides sum W x over the columns in other orders)."""
    x, xp, ll, g = _wide(d, 24, 17, d, np.float32)

    def loss_jax(x, xp, sig, ll):
        return jnp.sum(jax_ard_gram(x, xp, sig, ll) * g)

    jargs = (jnp.asarray(x), jnp.asarray(xp), jnp.float32(0.3), jnp.asarray(ll))
    args = [t(a).clone().requires_grad_() for a in (x, xp, np.float32(0.3), ll)]
    K = ArdGram.apply(*args)
    want_K = np.asarray(jax_ard_gram(*jargs))
    assert want_K.min() < 0.1 * want_K.max()
    close(K, want_K, 1e-5, 1e-7)
    got = torch.autograd.grad(torch.sum(K * t(g)), args)
    for a, b in zip(got, jax.grad(loss_jax, argnums=(0, 1, 2, 3))(*jargs)):
        close(a, b, 1e-5, 1e-5 * float(np.abs(np.asarray(b)).max()))


@pytest.mark.parametrize("d", [3, 65, 130])
def test_float64_gram_matches_the_fp64_oracle_and_gradcheck(d):
    """float64 through gram() against tests/oracle.py's fp64 NumPy Gram at
    1e-12 relative, and ArdGram's float64 gradient by gradcheck."""
    x, xp, ll, _ = _wide(d + 1, 20, 13, d, np.float64)
    got = gram(t(x), t(xp), 0.3, t(ll))
    assert got.dtype == torch.float64
    close(got, oracle.ard_gram(x, xp, 0.3, ll), 1e-12, 1e-300)
    args = [t(a[:5]).clone().requires_grad_() for a in (x, xp)] + [
        torch.tensor(0.3, dtype=torch.float64, requires_grad=True),
        t(ll).clone().requires_grad_()]
    assert torch.autograd.gradcheck(ArdGram.apply, args)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernel entry points take CUDA tensors only; they never fall back."""
    xs, xps, sig = torch.zeros(5, 3), torch.zeros(4, 3), torch.tensor(1.0)
    with pytest.raises(ValueError):
        gram_cuda.gram_fwd_cuda(xs, xps, sig)
    with pytest.raises(ValueError):
        gram_cuda.gram_bwd_cuda(xs, xps, sig, torch.zeros(5, 4))


def test_build_raises_without_nvcc(monkeypatch):
    """With no compiler the kernels cannot be built, and that raises."""
    if shutil.which("nvcc"):
        pytest.skip("nvcc is present: the build would run")
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "library_path", lambda: _build.BUILD_DIR / "absent.so")
    monkeypatch.setattr("torch.utils.cpp_extension.CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load_library()


def test_build_key_covers_the_sources():
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR
    assert [p.name for p in _build._sources()] == ["chol_small.cu", "gram.cu"]


@pytest.mark.parametrize("batch,chunks", [
    (0, [(0, 0)]),                    # no Grams: one empty chunk, which launches nothing
    (1, [(0, 1)]),
    (65535, [(0, 65535)]),            # the grid's z limit: still one launch
    (65536, [(0, 65535), (65535, 1)]),
    (200000, [(0, 65535), (65535, 65535), (131070, 65535), (196605, 3395)]),
])
def test_batch_chunks_cut_a_call_at_the_grids_z_limit(batch, chunks):
    """A call of more than 65,535 Grams launches in consecutive chunks that
    cover the batch once, in order; up to the limit it is one launch."""
    assert _build.MAX_BATCH == 65535
    got = _build.batch_chunks(batch)
    assert got == chunks
    assert sum(size for _, size in got) == batch
    assert all(s == prev + size for (prev, size), (s, _) in zip(got, got[1:]))


@pytest.mark.parametrize("case,batch,stride,chunks", [
    ("unbatched", 1, 0, [(0, 1)]),
    ("shared", 3, 2, [(0, 3)]),
    ("past_max_batch", 65535 + 2, 2, [(0, 65535), (65535, 2)]),
    ("error", 1, 0, [(0, 1)]),
])
def test_launch_calls_the_entry_once_a_chunk(case, batch, stride, chunks):
    """_build.launch, the one loop that calls a C entry point, with a fake
    entry that records its arguments: one call a chunk of batch_chunks, each
    Batched array's pointer at its chunk's first entry (a shared one, stride
    0, whole every time), the chunk's size where the arguments put it, the
    stream last; a nonzero code raises with the entry's name."""
    calls = []

    def fake_entry(*args):
        calls.append(args)
        return 700 if case == "error" else 0

    xs, sig = torch.zeros(batch, 2), torch.ones(())
    args = lambda size: (_build.Batched(xs, stride), _build.Batched(sig, 0), None, 9, size)
    if case == "error":
        with pytest.raises(RuntimeError, match="fake_entry kernel launch failed: CUDA error 700"):
            _build.launch(fake_entry, batch, args, 5)
        assert len(calls) == 1
        return
    assert _build.launch(fake_entry, batch, args, 5) == len(chunks)
    assert calls == [(xs.data_ptr() + 4 * stride * start, sig.data_ptr(), None, 9, size, 5)
                     for start, size in chunks]


@pytest.mark.parametrize("d,dtype", [(8, torch.float32), (90, torch.float32),
                                     (8, torch.float64), (40, torch.float64)])
def test_launch_plan_gives_each_plan_its_entrys_arguments(monkeypatch, d, dtype):
    """gram_cuda._launch_plan on CPU tensors and a fake library: each plan
    (the forward and both backward halves, unchunked at d = 8, d-chunked
    past max_unchunked_d) calls the entry point it names, for the dtype, with
    the arguments csrc declares (_build.SIGNATURES, each taken by its ctypes
    type), xs's pointer where the entry reads it, and one launch under the
    plan's LAUNCHES key."""
    calls = []

    class FakeLib:
        def __getattr__(self, name):
            def entry(*args):
                calls.append((name, args))
                return 0
            entry.__name__ = name
            return entry

    monkeypatch.setattr(gram_cuda, "LAUNCHES", dict.fromkeys(gram_cuda.LAUNCHES, 0))
    monkeypatch.setattr(gram_cuda, "_WORKSPACES", {})
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    n, m, elem = 20, 16, torch.tensor([], dtype=dtype).element_size()
    xs, xps, g = (torch.zeros(shape, dtype=dtype) for shape in ((n, d), (m, d), (n, m)))
    sig, out, row = (torch.ones(s, dtype=dtype) for s in ((), (n, m), (n,)))
    launches = [(gram_cuda.fwd_plan, (xs, xps, sig, None, out), 4),
                (gram_cuda.bwd_rows_plan, (xs, xps, sig, g, xs.clone(), row), 6),
                (gram_cuda.bwd_cols_plan, (xs, xps, sig, g, xps.clone(), None), 6)]
    for planner, arrays, k in launches:
        plan = planner(n, m, d, 132, elem=elem)
        gram_cuda._launch_plan(FakeLib(), 0, [plan], arrays, [0] * k, n, m, d)
        name, args = calls[-1]
        assert name == plan.entry + ("_f64" if dtype == torch.float64 else "")
        assert len(args) == len(_build.SIGNATURES[name])
        for argtype, a in zip(_build.SIGNATURES[name], args):
            argtype.from_param(a)
        first = 2 if plan.entry == "gram_bwd_dchunk" else 0
        assert args[first] == xs.data_ptr() and args[-1] == 0
    chunked = gram_cuda.chunked(d, elem)
    assert gram_cuda.LAUNCHES == {"fwd": int(not chunked), "fwd_dchunk": int(chunked),
                                  "bwd_rows": 1, "bwd_cols": 1}


# ---- the batch axis ----------------------------------------------------------


def _batched_inputs(seed, B, n, m, d):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((B, n, d)).astype(np.float32)
    xps = rng.standard_normal((B, m, d)).astype(np.float32)
    sig = rng.uniform(0.5, 2.0, B).astype(np.float32)
    g = rng.standard_normal((B, n, m)).astype(np.float32)
    return t(xs), t(xps), t(sig), t(g)


@pytest.mark.parametrize("B,n,m,d", [(3, 17, 11, 3), (4, 20, 20, 8), (1, 9, 5, 1)])
def test_batched_plain_versions_equal_a_loop_of_unbatched_calls(B, n, m, d):
    """The plain versions the kernels are held against, batched: each batch
    as the unbatched call on its inputs (rtol 1e-6, atol 1e-6 of the largest
    entry: batched and unbatched products sum in other orders)."""
    xs, xps, sig, g = _batched_inputs(B + n, B, n, m, d)
    K = gram_cuda.gram_fwd_plain(xs, xps, sig)
    d_xs, d_xps, row = gram_cuda.gram_bwd_plain(xs, xps, sig, g)
    assert K.shape == (B, n, m) and d_xs.shape == (B, n, d) and row.shape == (B, n)
    for b in range(B):
        one = (gram_cuda.gram_fwd_plain(xs[b], xps[b], sig[b]),
               *gram_cuda.gram_bwd_plain(xs[b], xps[b], sig[b], g[b]))
        for got, want in zip((K, d_xs, d_xps, row), one):
            close(got[b], want, 1e-6, 1e-6 * float(want.abs().max()))


def test_batched_plain_takes_a_shared_input():
    """xs [n, d] and one sig shared by every batch: as if repeated."""
    xs, xps, _, g = _batched_inputs(5, 3, 12, 7, 2)
    sig = torch.tensor(1.4)
    got = gram_cuda.gram_bwd_plain(xs[0], xps, sig, g)
    want = gram_cuda.gram_bwd_plain(xs[0].expand(3, 12, 2), xps, sig, g)
    for a, b in zip(got, want):
        close(a, b, 1e-6, 1e-7)


def test_batched_ard_gram_gradcheck_float64():
    """ArdGram with batched leaves (log_signal_sq [B], log_length [B, d],
    inducing [B, m, d]) and x [n, d] shared: gradcheck in float64."""
    rng = np.random.default_rng(12)

    def leaf(a):
        return torch.tensor(a, dtype=torch.float64, requires_grad=True)

    args = [leaf(rng.standard_normal((6, 3))), leaf(rng.standard_normal((2, 4, 3))),
            leaf(0.3 * rng.standard_normal(2)), leaf(0.2 * rng.standard_normal((2, 3)))]
    assert ArdGram.apply(*args).shape == (2, 6, 4)
    assert torch.autograd.gradcheck(ArdGram.apply, args)


@pytest.mark.parametrize("kind", ["ard", "rbf"])
def test_batched_gram_equals_the_unbatched_grams(kind):
    """gram() of batched leaves (rbf: one squared length [B]) on x shared:
    each batch's K and gradients are its unbatched call's; the shared x's
    gradient is the sum over the batch."""
    rng = np.random.default_rng(13)
    x = t(rng.standard_normal((9, 3)).astype(np.float32)).requires_grad_()
    u = t(rng.standard_normal((3, 4, 3)).astype(np.float32)).requires_grad_()
    lss = t(rng.standard_normal(3).astype(np.float32)).requires_grad_()
    ll = t((0.2 * rng.standard_normal((3,) if kind == "rbf" else (3, 3))).astype(
        np.float32)).requires_grad_()
    w = t(rng.standard_normal((3, 9, 4)).astype(np.float32))
    K = gram(x, u, lss, ll, kind=kind)
    grads = torch.autograd.grad(torch.sum(K * w), [x, u, lss, ll])
    x_sum = torch.zeros_like(x)
    for b in range(3):
        leaves = [x.detach().clone().requires_grad_(), u[b].detach().clone().requires_grad_(),
                  lss[b].detach().clone().requires_grad_(),
                  ll[b].detach().clone().requires_grad_()]
        Kb = gram(*leaves, kind=kind)
        close(K[b], Kb.detach(), 1e-6, 1e-7)
        gb = torch.autograd.grad(torch.sum(Kb * w[b]), leaves)
        x_sum += gb[0]
        for got, want in zip(grads[1:], gb[1:]):
            close(got[b], want, 1e-5, 1e-6 * float(want.abs().max()))
    close(grads[0], x_sum, 1e-5, 1e-6 * float(x_sum.abs().max()))


@pytest.mark.parametrize("bad", ["batches_differ", "sig_count", "cotangent_batch", "rank4"])
def test_kernel_wrapper_rejects_a_bad_batch(bad):
    xs, xps, sig, g = torch.zeros(3, 5, 2), torch.zeros(3, 4, 2), torch.ones(3), None
    if bad == "batches_differ":
        xps = torch.zeros(2, 4, 2)
    elif bad == "sig_count":
        sig = torch.ones(2)
    elif bad == "cotangent_batch":
        g = torch.zeros(2, 5, 4)
    elif bad == "rank4":
        xs = torch.zeros(1, 3, 5, 2)
    with pytest.raises(ValueError):
        gram_cuda._check(xs, xps, sig, g)


def test_kernel_wrapper_accepts_batched_and_shared_inputs():
    assert gram_cuda._check(torch.zeros(5, 2), torch.zeros(4, 2), torch.ones(())) is None
    assert gram_cuda._check(torch.zeros(3, 5, 2), torch.zeros(4, 2), torch.ones(()),
                            torch.zeros(3, 5, 4)) == 3
    assert gram_cuda._check(torch.zeros(5, 2), torch.zeros(3, 4, 2), torch.ones(3)) == 3
    # Batch strides: a batched tensor's leading stride, 0 for a shared one.
    assert gram_cuda._bstride(torch.zeros(3, 5, 2), 3) == 10
    assert gram_cuda._bstride(torch.zeros(5, 2), 3) == 0
    assert gram_cuda._bstride(torch.ones(3), 3) == 1 and gram_cuda._bstride(torch.ones(()), 3) == 0
    with pytest.raises(ValueError):
        gram_cuda.gram_fwd_cuda(torch.zeros(3, 5, 2), torch.zeros(3, 4, 2), torch.ones(3))
