"""Jitted two-site DMRG with matrix-free Lanczos/CG local solves."""

import numpy as np
import jax

import jax.numpy as jnp

from ttnx import (
    function_to_qtt,
    heisenberg_xyz_tto,
    id_tto,
    laplacian,
    qtt_sin,
    qtto_to_matrix,
    rand_tt,
    ttv_decomp,
    ttv_to_tensor,
)
from ttnx.solvers.dmrg_scan import (
    cut_off_mask,
    dmrg_eigsolve_scan,
    dmrg_linsolve_scan,
    dmrg_sweep,
)


def vec(tt):
    return np.asarray(ttv_to_tensor(tt)).reshape(-1)


def _system(key, d=6):
    A = laplacian(d)
    u_true = function_to_qtt(lambda x: np.sin(np.pi * x), d)
    bd = np.asarray(qtto_to_matrix(A)) @ vec(u_true)
    b = ttv_decomp(bd.reshape((2,) * d), tol=1e-14)
    x0 = rand_tt(key, (2,) * d, rmax=4, normalise=True)
    return A, b, u_true, x0


def test_linsolve_spd(key):
    A, b, u_true, x0 = _system(key)
    x = dmrg_linsolve_scan(A, b, x0, tol=1e-12, rmax=16, n_sweeps=2,
                           cg_iters=64)
    rel = np.linalg.norm(vec(x) - vec(u_true)) / np.linalg.norm(vec(u_true))
    assert rel < 1e-9


def test_linsolve_identity_adapts_down(key):
    d = 6
    A = id_tto(d)
    b = qtt_sin(d)
    x0 = rand_tt(key, (2,) * d, rmax=4, normalise=True)
    x = dmrg_linsolve_scan(A, b, x0, tol=1e-12, rmax=8)
    rel = np.linalg.norm(vec(x) - vec(b)) / np.linalg.norm(vec(b))
    assert rel < 1e-10
    assert x.ranks == b.ranks


def test_eigsolve_heisenberg(key):
    d = 6
    H = heisenberg_xyz_tto(d)
    x0 = rand_tt(key, (2,) * d, rmax=2, normalise=True, orthogonal=True)
    E, x = dmrg_eigsolve_scan(H, x0, tol=1e-12, rmax=12, n_sweeps=4,
                              lanczos_iters=30)
    w = np.linalg.eigvalsh(np.asarray(qtto_to_matrix(H)))
    assert abs(E[-1] - w[0]) < 1e-9
    assert max(x.ranks) > 2
    # Lanczos Ritz values are variational upper bounds throughout
    assert all(e >= w[0] - 1e-8 for e in E)


def test_cutoff_mask_degeneracy():
    # a tol cut landing inside a degenerate pair must keep the whole pair
    s = jnp.asarray([1.0, 0.5, 0.5 - 1e-14, 1e-9, 1e-16])
    tol = 0.4  # relative cut between the two 0.5s without the degeneracy rule
    m = np.asarray(cut_off_mask(s, tol * 1.0 / float(jnp.linalg.norm(s)),
                                degen_tol=1e-10))
    # indices 0,1 kept by threshold; 2 rescued by degeneracy; 3,4 dropped
    assert m.tolist() == [1.0, 1.0, 1.0, 0.0, 0.0]


def test_single_compiled_program(key):
    A, b, _, x0 = _system(key)
    n0 = dmrg_sweep._cache_size()
    dmrg_linsolve_scan(A, b, x0, tol=1e-12, rmax=16, n_sweeps=3)
    n1 = dmrg_sweep._cache_size()
    assert n1 <= n0 + 1
    # tol / degen_tol are runtime data: changing them must not retrace
    dmrg_linsolve_scan(A, b, x0, tol=1e-6, degen_tol=1e-8, rmax=16)
    assert dmrg_sweep._cache_size() == n1


def test_eig_sweep_gram_split_matches_svd():
    """split='gram' (eigh-based) matches the SVD split on
    the Heisenberg ground state to solver accuracy."""
    import jax
    import numpy as np
    import ttnx
    from ttnx.solvers.dmrg_scan import dmrg_eigsolve_scan

    d = 6
    H = ttnx.heisenberg_xyz_tto(d, jx=1.0, jy=1.0, jz=1.0)
    x0 = ttnx.rand_tt(jax.random.PRNGKey(3), (2,) * d, rmax=6,
                      normalise=True, orthogonal=True)
    E_s, _ = dmrg_eigsolve_scan(H, x0, tol=1e-10, rmax=12, n_sweeps=3)
    E_g, _ = dmrg_eigsolve_scan(H, x0, tol=1e-10, rmax=12, n_sweeps=3,
                                split="gram")
    assert abs(float(E_s[-1]) - float(E_g[-1])) < 1e-8


def test_eig_sweep_f32_env_kernel_path():
    """The f32 eigsweep (XLA env scans, gram split) matches the energies of
    the f64 path."""
    import ttnx
    from ttnx.solvers.als_scan import pack_op, pack_tt, rank_masks
    from ttnx.solvers.dmrg_scan import dmrg_eig_sweep

    d, rmax = 6, 16
    H = ttnx.xxx_tto(d)
    x0 = ttnx.rand_tt(jax.random.PRNGKey(3), (2,) * d, rmax=4,
                      normalise=True, orthogonal=True)
    A64 = pack_op(H, max(H.ranks))
    xs64 = pack_tt(x0, rmax)
    ms64 = rank_masks(x0.ranks, rmax)
    xs, ms = xs64, ms64
    tol = jnp.float64(1e-8)
    for _ in range(4):
        xs, ms, E64 = dmrg_eig_sweep(A64, xs, ms, tol, tol)
    A32 = A64.astype(jnp.float32)
    xs32 = xs64.astype(jnp.float32)
    ms32 = ms64.astype(jnp.float32)
    tol32 = jnp.float32(1e-6)
    xs, ms = xs32, ms32
    for _ in range(4):
        xs, ms, E32 = dmrg_eig_sweep(A32, xs, ms, tol32, tol32,
                                     split="gram")
    assert abs(float(E32[-1]) - float(E64[-1])) < 1e-3, (
        float(E32[-1]), float(E64[-1]))
