"""Jitted 1-site TDVP tests (vs the eager reference-semantics implementation)."""

import numpy as np

import jax.numpy as jnp

from ttnx import id_tto, qtt_sin, toeplitz_to_qtto, ttv_to_tensor
from ttnx.core.algebra import dot
from ttnx.solvers.tdvp import tdvp
from ttnx.solvers.tdvp_scan import tdvp1_scan, tdvp1_step


def vec(tt):
    return np.asarray(ttv_to_tensor(tt)).reshape(-1)


def test_zero_hamiltonian_identity():
    d = 4
    out = tdvp1_scan(0.0 * id_tto(d), qtt_sin(d, lam=np.pi), [0.1],
                     normalize=False)
    ref = vec(qtt_sin(d, lam=np.pi))
    assert np.linalg.norm(vec(out) - ref) / np.linalg.norm(ref) < 1e-12


def test_scalar_hamiltonian_phase():
    d = 4
    u0 = qtt_sin(d, lam=np.pi)
    out = tdvp1_scan(0.5 * id_tto(d), u0, [0.05], normalize=False)
    expect = np.exp(-1j * 0.5 * 0.05) * vec(u0)
    assert np.linalg.norm(vec(out) - expect) / np.linalg.norm(expect) < 1e-12


def test_matches_eager_real_time():
    d = 4
    H = toeplitz_to_qtto(2.0, -1.0, -1.0, d)
    u0 = qtt_sin(d)
    eager = tdvp(H, u0, [0.01] * 3, normalize=False)
    scan = tdvp1_scan(H, u0, [0.01] * 3, normalize=False)
    rel = np.linalg.norm(vec(scan) - vec(eager)) / np.linalg.norm(vec(eager))
    assert rel < 1e-10


def test_matches_eager_imaginary_time():
    d = 4
    hg = 1.0 / (2 ** d + 1)
    A = (0.1 / hg ** 2) * toeplitz_to_qtto(-2.0, 1.0, 1.0, d)
    u0 = qtt_sin(d, a=hg, b=1 - hg)
    steps = [1e-3] * 5
    eager = tdvp(A, u0, steps, imaginary_time=True, normalize=False)
    scan = tdvp1_scan(A, u0, steps, imaginary_time=True, normalize=False)
    rel = np.linalg.norm(vec(scan) - np.real(vec(eager))) / np.linalg.norm(
        vec(eager))
    assert rel < 1e-12


def test_norm_conserved_real_time():
    # unitary evolution conserves the norm without renormalization
    d = 5
    H = toeplitz_to_qtto(2.0, -1.0, -1.0, d)
    u0 = qtt_sin(d)
    out = tdvp1_scan(H, u0, [0.02] * 4, normalize=False)
    n0 = np.linalg.norm(vec(u0))
    n1 = np.linalg.norm(vec(out))
    assert abs(n1 - n0) / n0 < 1e-10


def test_jit_cache_reuse():
    d = 4
    H = (0.3 * id_tto(d)).astype(jnp.complex128)
    from ttnx.solvers.als_scan import pack_op, pack_tt, rank_masks
    from ttnx.core.canonical import orthogonalize

    x = orthogonalize(qtt_sin(d), 0).astype(jnp.complex128)
    A_stack = pack_op(H, 1)
    masks = rank_masks(x.ranks, 4, dtype=jnp.float64).astype(jnp.complex128)
    xs = pack_tt(x, 4)
    n0 = tdvp1_step._cache_size()
    xs = tdvp1_step(A_stack, xs, masks, jnp.asarray(0.01, jnp.complex128))
    n1 = tdvp1_step._cache_size()
    xs = tdvp1_step(A_stack, xs, masks, jnp.asarray(0.02, jnp.complex128))
    assert tdvp1_step._cache_size() == n1 > n0


def test_lanczos_large_buffer_matches_eager():
    """rmax=32 buffer (M = 32*2*32 = 2048): the default Lanczos expm path
    never materializes the (RnR)^2 local operator and still matches the
    eager Krylov reference."""
    import jax
    from ttnx import increase_ranks
    from ttnx.core.algebra import norm, scale

    d = 5
    H = toeplitz_to_qtto(2.0, -1.0, -1.0, d)
    u0 = increase_ranks(qtt_sin(d), 8, noise=1e-3, key=jax.random.PRNGKey(1))
    u0 = scale(1.0 / float(norm(u0)), u0)
    eager = tdvp(H, u0, [0.01] * 2, normalize=False)
    scan = tdvp1_scan(H, u0, [0.01] * 2, normalize=False, rmax=32)
    rel = np.linalg.norm(vec(scan) - vec(eager)) / np.linalg.norm(vec(eager))
    assert rel < 1e-9, rel


def test_lanczos_matches_dense_expm():
    """expm='lanczos' and expm='dense' agree to near machine precision on the
    same jitted sweep (small rank where dense is tractable)."""
    d = 4
    H = toeplitz_to_qtto(2.0, -1.0, -1.0, d)
    u0 = qtt_sin(d)
    a = tdvp1_scan(H, u0, [0.02], normalize=False, expm="lanczos")
    b = tdvp1_scan(H, u0, [0.02], normalize=False, expm="dense")
    rel = np.linalg.norm(vec(a) - vec(b)) / np.linalg.norm(vec(b))
    assert rel < 1e-12, rel


def test_real_dtype_imaginary_time_matches_complex():
    """dtype=float64 imaginary-time TDVP (the real-arithmetic path)
    matches the complex128 path exactly."""
    d = 4
    hg = 1.0 / (2 ** d + 1)
    A = (0.1 / hg ** 2) * toeplitz_to_qtto(-2.0, 1.0, 1.0, d)
    u0 = qtt_sin(d, a=hg, b=1 - hg)
    steps = [1e-3] * 4
    cplx = tdvp1_scan(A, u0, steps, imaginary_time=True, normalize=False)
    real = tdvp1_scan(A, u0, steps, imaginary_time=True, normalize=False,
                      dtype=jnp.float64)
    rel = (np.linalg.norm(vec(real) - np.real(vec(cplx)))
           / np.linalg.norm(vec(cplx)))
    assert rel < 1e-12, rel
    import pytest
    with pytest.raises(ValueError):
        tdvp1_scan(A, u0, steps, imaginary_time=False, dtype=jnp.float64)
