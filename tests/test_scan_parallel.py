"""Scan-based padded ALS and the mesh/batch parallel layer (8 virtual CPU
devices via conftest)."""

import numpy as np

import jax
import jax.numpy as jnp

from ttnx import (
    function_to_qtt,
    id_tto,
    laplacian,
    qtt_sin,
    qtto_to_matrix,
    rand_tt,
    toeplitz_to_qtto,
    ttv_decomp,
    ttv_to_tensor,
)
from ttnx.parallel.batch import batched_als_linsolve, make_mesh
from ttnx.solvers.als_scan import als_linsolve_scan


def vec(tt):
    return np.asarray(ttv_to_tensor(tt)).reshape(-1)


class TestScanALS:
    def test_readme_quickstart_parity(self, key):
        d = 6
        A = id_tto(d)
        b = qtt_sin(d)
        x0 = rand_tt(key, (2,) * d, rmax=4, normalise=True)
        x = als_linsolve_scan(A, b, x0, sweep_count=4)
        rel = np.linalg.norm(vec(x) - vec(b)) / np.linalg.norm(vec(b))
        assert rel < 1e-12

    def test_matches_eager_als(self, key):
        from ttnx import als_linsolve

        d = 6
        A = laplacian(d)
        u = function_to_qtt(lambda t: np.sin(np.pi * t), d)
        bd = np.asarray(qtto_to_matrix(A)) @ vec(u)
        b = ttv_decomp(bd.reshape((2,) * d), tol=1e-14)
        x0 = rand_tt(key, (2,) * d, rmax=8, normalise=True)
        xs = als_linsolve_scan(A, b, x0, sweep_count=6)
        xe = als_linsolve(A, b, x0, sweep_count=6)
        assert np.linalg.norm(vec(xs) - vec(xe)) < 1e-10

    def test_jit_cache_reuse(self, key):
        # same shapes -> a second call must not retrace (compile cache hit)
        from ttnx.solvers.als_scan import als_sweeps

        d = 5
        A = id_tto(d)
        b = qtt_sin(d)
        k1, k2 = jax.random.split(key)
        x1 = rand_tt(k1, (2,) * d, rmax=4, normalise=True)
        x2 = rand_tt(k2, (2,) * d, rmax=4, normalise=True)
        n0 = als_sweeps._cache_size()
        als_linsolve_scan(A, b, x1, sweep_count=2)
        n1 = als_sweeps._cache_size()
        als_linsolve_scan(A, b, x2, sweep_count=2)
        n2 = als_sweeps._cache_size()
        assert n1 > n0
        assert n2 == n1

    def test_odd_sweep_count(self, key):
        d = 5
        A = id_tto(d)
        b = qtt_sin(d)
        x0 = rand_tt(key, (2,) * d, rmax=4, normalise=True)
        x = als_linsolve_scan(A, b, x0, sweep_count=3)
        rel = np.linalg.norm(vec(x) - vec(b)) / np.linalg.norm(vec(b))
        assert rel < 1e-10


class TestSolverOptions:
    def test_cg_local_solver_matches_lu(self, key):
        from ttnx import id_tto, laplacian
        from ttnx.core.canonical import orthogonalize
        from ttnx.solvers.als_scan import (
            als_sweeps, pack_op, pack_tt, rank_masks, unpack_tt)

        d = 6
        A = id_tto(d) + 1e-5 * laplacian(d)  # SPD, well-conditioned
        b = qtt_sin(d)
        x0 = orthogonalize(rand_tt(key, (2,) * d, rmax=4, normalise=True), 0)
        rks = x0.ranks
        args = (pack_op(A, max(A.ranks)), pack_tt(b, max(b.ranks)),
                pack_tt(x0, 4), rank_masks(rks, 4))
        x_lu = unpack_tt(als_sweeps(*args, 4, solver="lu"), rks)
        x_cg = unpack_tt(als_sweeps(*args, 4, solver="cg"), rks)
        assert np.linalg.norm(vec(x_lu) - vec(x_cg)) < 1e-10

    def test_polar_orth_well_conditioned(self, rng):
        import jax.numpy as jnp
        from ttnx.solvers.als_scan import polar_orth

        m = jnp.asarray(rng.standard_normal((32, 8)))
        q, r = polar_orth(m)
        assert float(jnp.linalg.norm(q.T @ q - jnp.eye(8))) < 1e-12
        assert float(jnp.linalg.norm(q @ r - m)) < 1e-12
        # padded zero columns stay exactly zero
        m2 = m.at[:, 5:].set(0.0)
        q2, _ = polar_orth(m2)
        assert float(jnp.abs(q2[:, 5:]).max()) == 0.0


class TestScanEigsolve:
    def test_heisenberg_ground_state(self, key):
        from ttnx import heisenberg_xyz_tto, qtto_to_matrix
        from ttnx.solvers.als_scan import als_eigsolve_scan

        d = 6
        H = heisenberg_xyz_tto(d)
        x0 = rand_tt(key, (2,) * d, rmax=8, normalise=True, orthogonal=True)
        E, x = als_eigsolve_scan(H, x0, n_sweeps=6)
        w = np.linalg.eigvalsh(np.asarray(qtto_to_matrix(H)))
        assert abs(E[-1] - w[0]) < 1e-6
        # variational: eigenvalue history bounded below by the true minimum
        assert all(e >= w[0] - 1e-10 for e in E)

    def test_energy_history_length(self, key):
        from ttnx import laplacian
        from ttnx.solvers.als_scan import als_eigsolve_scan

        d = 5
        A = laplacian(d)
        x0 = rand_tt(key, (2,) * d, rmax=4, normalise=True, orthogonal=True)
        E, x = als_eigsolve_scan(A, x0, n_sweeps=3)
        # (d-1) microsteps per half sweep, 2 half sweeps per sweep
        assert len(E) == 3 * 2 * (d - 1)


class TestParallel:
    def test_mesh_shapes(self):
        mesh = make_mesh(dp=4, tp=2)
        assert mesh.shape == {"dp": 4, "tp": 2}
        mesh1 = make_mesh()
        assert mesh1.shape["dp"] == len(jax.devices())

    def test_mesh_validation(self):
        import pytest

        with pytest.raises(ValueError):
            make_mesh(dp=3, tp=3)

    def test_batched_solve_matches_single(self, key):
        d = 6
        n_grid = 2 ** d
        h = 1.0 / (n_grid + 1)
        A = id_tto(d) + 1e-5 / h ** 2 * toeplitz_to_qtto(2.0, -1.0, -1.0, d)
        keys = jax.random.split(key, 4)
        bs = [qtt_sin(d, lam=k + 1) for k in range(4)]
        x0s = [rand_tt(keys[k], (2,) * d, rmax=6, normalise=True)
               for k in range(4)]
        mesh = make_mesh(dp=4, tp=2)
        outs = batched_als_linsolve(mesh, A, bs, x0s, sweep_count=4)
        # compare each against the single-problem scan solve
        for k in range(4):
            single = als_linsolve_scan(A, bs[k], x0s[k], sweep_count=4,
                                       rmax=6)
            assert np.linalg.norm(vec(outs[k]) - vec(single)) < 1e-9

    def test_batched_solve_accuracy(self, key):
        d = 6
        A = id_tto(d)
        keys = jax.random.split(key, 8)
        bs = [qtt_sin(d, lam=0.5 * (k + 1)) for k in range(8)]
        x0s = [rand_tt(keys[k], (2,) * d, rmax=4, normalise=True)
               for k in range(8)]
        mesh = make_mesh(dp=8, tp=1)
        outs = batched_als_linsolve(mesh, A, bs, x0s, sweep_count=4)
        for k in range(8):
            rel = np.linalg.norm(vec(outs[k]) - vec(bs[k])) / np.linalg.norm(
                vec(bs[k]))
            assert rel < 1e-11


def test_batched_cg_fused_matches_lu_gauge_invariant():
    """vmapped solver='cg' solves identically to 'lu' on the represented
    vectors (cores differ only in gauge)."""
    import numpy as np
    import jax.numpy as jnp
    import __graft_entry__
    from ttnx.core.decomp import ttv_to_tensor
    from ttnx.parallel.batch import batched_als_sweeps
    from ttnx.solvers.als_scan import unpack_tt

    A, b, x, masks = __graft_entry__._heat_problem(d=6, rmax=4,
                                                   dtype=jnp.float64)
    rks = [int(m.sum()) for m in np.asarray(masks)]

    def dense(stack):
        return np.asarray(ttv_to_tensor(unpack_tt(stack, rks))).reshape(-1)

    bb = jnp.broadcast_to(b, (3,) + b.shape)
    xb = jnp.broadcast_to(x, (3,) + x.shape)
    out_lu = batched_als_sweeps(A, bb, xb, masks, 2, solver="lu")
    out_cf = batched_als_sweeps(A, bb, xb, masks, 2, solver="cg")
    for k in range(3):
        v_lu, v_cf = dense(out_lu[k]), dense(out_cf[k])
        assert np.linalg.norm(v_cf - v_lu) / np.linalg.norm(v_lu) < 1e-10
