"""Device (jitted) TT-cross tests — fixed-rank MaxVol as one XLA program."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ttnx.cross.device import (
    evaluate_tt_indices,
    index_evaluator,
    maxvol_cross_device,
    maxvol_fixed,
    tt_cross_device,
)
from ttnx.cross.maxvol import maxvol as maxvol_host


def test_maxvol_fixed_dominance(rng):
    """The jitted maxvol satisfies the dominance contract: every entry of
    a @ inv(a[rows]) is <= tol (same contract as the host maxvol)."""
    for n, r in ((40, 5), (100, 12), (17, 16)):
        a = rng.standard_normal((n, r))
        rows = np.asarray(maxvol_fixed(jnp.asarray(a), 1.05, maxiter=200))
        assert len(np.unique(rows)) == r
        B = a @ np.linalg.inv(a[rows])
        assert np.max(np.abs(B)) <= 1.05 + 1e-8
        rows_h = maxvol_host(a, 1.05, 200)
        Bh = a @ np.linalg.inv(a[rows_h])
        # equal quality (pivot sets may differ; the volume class must match)
        assert np.max(np.abs(B)) <= np.max(np.abs(Bh)) * 1.05 + 1e-8


def test_maxvol_fixed_short_matrix():
    a = jnp.asarray(np.eye(3))
    rows = np.asarray(maxvol_fixed(a, 1.05))
    assert np.array_equal(np.sort(rows), [0, 1, 2])


def test_evaluate_tt_indices_matches_host(rng):
    from ttnx.cross.cross import _evaluate_tt

    cores = [jnp.asarray(rng.standard_normal((1, 4, 3))),
             jnp.asarray(rng.standard_normal((3, 5, 2))),
             jnp.asarray(rng.standard_normal((2, 4, 1)))]
    idx = np.stack([rng.integers(0, 4, 50), rng.integers(0, 5, 50),
                    rng.integers(0, 4, 50)], axis=1)
    got = np.asarray(evaluate_tt_indices(cores, jnp.asarray(idx)))
    ref = _evaluate_tt([np.asarray(c) for c in cores], idx)
    assert np.allclose(got, ref, atol=1e-12)


def test_device_cross_separable_gaussian():
    g = np.linspace(-1, 1, 12)

    def f(X):
        return jnp.exp(-jnp.sum(X ** 2, axis=1))

    tt, eps = tt_cross_device(f, [g] * 4, rank=3, n_iters=3, n_val=300)
    from ttnx.core.decomp import ttv_to_tensor

    xs = np.stack(np.meshgrid(*[g] * 4, indexing="ij"), axis=-1)
    expect = np.exp(-np.sum(xs ** 2, axis=-1))
    got = np.asarray(ttv_to_tensor(tt))
    assert np.linalg.norm(got - expect) / np.linalg.norm(expect) < 1e-8
    assert eps[-1] < 1e-8


def test_device_cross_wishart_5d():
    """The jitted fixed-rank cross reaches the reference accuracy contract
    on the 5-D Wishart Laplace transform (rel-L2 < 1e-4,
    /root/reference/test/test_tt_cross_interpolation.jl:147-186)."""
    d = 5
    nu = d + 2
    p = nu / 2
    Sigma = np.array([
        [1.0, 0.3, 0.2, 0.1, 0.18],
        [0.3, 1.2, 0.25, 0.15, 0.22],
        [0.2, 0.25, 0.9, 0.2, 0.28],
        [0.1, 0.15, 0.2, 1.1, 0.19],
        [0.18, 0.22, 0.28, 0.19, 1.05],
    ])
    sigma = jnp.asarray(2 * Sigma)

    def f(X):
        M = jnp.eye(d)[None] + sigma[None] * X[:, None, :]
        return jnp.linalg.det(M) ** (-p)

    domain = [np.linspace(0.0, 2.0, 8)] * d
    tt, eps = tt_cross_device(f, domain, rank=8, n_iters=4, n_val=1500,
                              seed=2026)
    rng = np.random.default_rng(2027)
    idx = np.stack([rng.integers(0, 8, 200) for _ in range(d)], axis=1)
    coords = np.stack([domain[k][idx[:, k]] for k in range(d)], axis=1)
    ys = np.asarray(f(jnp.asarray(coords)))
    yhat = np.asarray(evaluate_tt_indices(tt.cores, jnp.asarray(idx)))
    rel_l2 = np.linalg.norm(ys - yhat) / np.linalg.norm(ys)
    assert rel_l2 < 1e-4, rel_l2


def test_device_cross_vmap_parameter_sweep():
    """vmap over a parameter axis = batched cross sweep (BASELINE config 5):
    the batched result matches per-parameter sequential runs exactly."""
    g = np.linspace(0.2, 1.5, 10)
    Is = [10] * 3
    thetas = jnp.asarray([0.5, 1.0, 2.0])
    grids = jnp.asarray(g)

    def make_fidx(theta):
        def f_idx(indices):
            coords = jnp.take(grids, indices)  # (m, 3)
            return jnp.exp(-theta * jnp.sum(coords ** 2, axis=1))
        return f_idx

    def run_one(theta, key):
        fn = maxvol_cross_device(make_fidx(theta), Is, rank=2, n_iters=2,
                                 n_val=100)
        return fn(key)

    key = jax.random.PRNGKey(7)
    batched = jax.jit(jax.vmap(run_one, in_axes=(0, None)))
    cores_b, eps_b = batched(thetas, key)
    for k, th in enumerate(np.asarray(thetas)):
        cores_1, eps_1 = jax.jit(lambda t, k2: run_one(t, k2))(th, key)
        for cb, c1 in zip(cores_b, cores_1):
            assert np.allclose(np.asarray(cb[k]), np.asarray(c1), atol=1e-10)
        assert eps_b[k, -1] < 1e-10 and eps_1[-1] < 1e-10


def test_device_dmrg_cross_separable_gaussian():
    g = np.linspace(-1, 1, 12)

    def f(X):
        return jnp.exp(-jnp.sum(X ** 2, axis=1))

    tt, eps = tt_cross_device(f, [g] * 4, rank=3, n_iters=3, n_val=300,
                              method="dmrg")
    from ttnx.core.decomp import ttv_to_tensor

    xs = np.stack(np.meshgrid(*[g] * 4, indexing="ij"), axis=-1)
    expect = np.exp(-np.sum(xs ** 2, axis=-1))
    got = np.asarray(ttv_to_tensor(tt))
    assert np.linalg.norm(got - expect) / np.linalg.norm(expect) < 1e-8
    assert eps[-1] < 1e-8


def test_device_dmrg_cross_wishart_5d():
    d = 5
    nu = d + 2
    p = nu / 2
    Sigma = np.array([
        [1.0, 0.3, 0.2, 0.1, 0.18],
        [0.3, 1.2, 0.25, 0.15, 0.22],
        [0.2, 0.25, 0.9, 0.2, 0.28],
        [0.1, 0.15, 0.2, 1.1, 0.19],
        [0.18, 0.22, 0.28, 0.19, 1.05],
    ])
    sigma = jnp.asarray(2 * Sigma)

    def f(X):
        M = jnp.eye(d)[None] + sigma[None] * X[:, None, :]
        return jnp.linalg.det(M) ** (-p)

    domain = [np.linspace(0.0, 2.0, 8)] * d
    tt, eps = tt_cross_device(f, domain, rank=8, n_iters=3, n_val=1500,
                              seed=2026, method="dmrg")
    rng = np.random.default_rng(2027)
    idx = np.stack([rng.integers(0, 8, 200) for _ in range(d)], axis=1)
    coords = np.stack([domain[k][idx[:, k]] for k in range(d)], axis=1)
    ys = np.asarray(f(jnp.asarray(coords)))
    yhat = np.asarray(evaluate_tt_indices(tt.cores, jnp.asarray(idx)))
    rel_l2 = np.linalg.norm(ys - yhat) / np.linalg.norm(ys)
    assert rel_l2 < 1e-4, rel_l2


def test_device_dmrg_cross_vmap():
    """vmapped batched DMRG-cross matches per-parameter runs."""
    from ttnx.cross.device import dmrg_cross_device

    g = np.linspace(0.2, 1.5, 10)
    Is = [10] * 3
    thetas = jnp.asarray([0.5, 1.5])
    grids = jnp.asarray(g)

    def make_fidx(theta):
        def f_idx(indices):
            coords = jnp.take(grids, indices)
            return jnp.exp(-theta * jnp.sum(coords ** 2, axis=1))
        return f_idx

    def run_one(theta, key):
        return dmrg_cross_device(make_fidx(theta), Is, rank=2, n_iters=2,
                                 n_val=100)(key)

    key = jax.random.PRNGKey(3)
    cores_b, eps_b = jax.jit(jax.vmap(run_one, in_axes=(0, None)))(thetas,
                                                                   key)
    for k in range(2):
        cores_1, eps_1 = jax.jit(lambda t, k2: run_one(t, k2))(thetas[k],
                                                               key)
        for cb, c1 in zip(cores_b, cores_1):
            assert np.allclose(np.asarray(cb[k]), np.asarray(c1), atol=1e-10)
        assert eps_b[k, -1] < 1e-10


def test_device_cross_adaptive_rank_escalation():
    """tt_cross_device_adaptive stops at the first stage meeting tol: a
    separable Gaussian (true ranks 1) stops at the first schedule entry; a
    tighter-than-reachable tol escalates to the last."""
    from ttnx.cross.device import tt_cross_device_adaptive

    g = np.linspace(-1, 1, 10)

    def f(X):
        return jnp.exp(-jnp.sum(X ** 2, axis=1))

    tt, eps, rank = tt_cross_device_adaptive(f, [g] * 3, tol=1e-8,
                                             rank_schedule=(2, 4, 8))
    assert rank == 2 and eps[-1] < 1e-8

    def f2(X):  # genuinely coupled: needs higher rank
        return jnp.exp(-jnp.sum(X ** 2, axis=1)) / (
            1.1 + jnp.prod(jnp.sin(3 * X), axis=1))

    tt2, eps2, rank2 = tt_cross_device_adaptive(f2, [g] * 3, tol=1e-12,
                                                rank_schedule=(2, 4))
    assert rank2 == 4
    assert eps2[-1] < 0.5  # usable approximation at the small cap


class TestGramSVDSubstitute:
    """The DMRG-cross factor helpers: orthonormal factors whose product
    with the scaled complement reproduces the superblock exactly."""

    def test_matches_svd_both_orientations(self, rng):
        from ttnx.cross import device as dev

        for shape in ((12, 7), (7, 12), (9, 9)):
            A = jnp.asarray(rng.standard_normal(shape))
            s_ref = np.linalg.svd(np.asarray(A), compute_uv=False)
            r = min(shape)
            # left factorization: u orthonormal, u @ svt == A exactly
            u, s, svt = dev._svd_left(A)
            assert np.allclose(np.asarray(s)[:r], s_ref, atol=1e-8)
            assert np.allclose(np.asarray(u.T @ u)[:r, :r], np.eye(r),
                               atol=1e-7)
            assert np.allclose(np.asarray(u @ svt), np.asarray(A),
                               atol=1e-7)
            # right factorization: v orthonormal, us @ v^T == A exactly
            v, s2, us = dev._svd_right(A)
            assert np.allclose(np.asarray(s2)[:r], s_ref, atol=1e-8)
            assert np.allclose(np.asarray(v.T @ v)[:r, :r], np.eye(r),
                               atol=1e-7)
            assert np.allclose(np.asarray(us @ v.T), np.asarray(A),
                               atol=1e-7)


def test_dmrg_cross_complex_integrand():
    """Complex black box through the device DMRG-cross: the R->L sweep's
    last projection is ``sb @ q`` (``sb @ conj(q)`` is wrong unless q is
    real), so the cross must reproduce a complex separable function."""
    from ttnx.cross.device import tt_cross_device

    grids = [np.linspace(0, 1, 6)] * 4

    def f(coords):
        return (jnp.exp(1j * jnp.sum(coords, axis=1))
                + 0.5j * jnp.prod(jnp.cos(coords + 0.3), axis=1))

    tt, eps = tt_cross_device(f, grids, rank=6, n_iters=3, n_val=400,
                              method="dmrg", dtype=jnp.complex128)
    assert float(eps[-1]) < 1e-8, eps
