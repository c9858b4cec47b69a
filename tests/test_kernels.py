"""Local-solve kernels and the plain XLA forms they are checked against
(the Triton kernel in interpret mode on CPU)."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp


def test_local_solve_cg_fused_matches_lu(rng):
    """The matrix-free 'cg' local solve agrees with the dense 'lu' path on
    an SPD masked local system. SPD by
    construction: identity MPO core with PSD left/right environments, so
    K = L (x) I_n (x) Renv is a Kronecker product of PSD factors."""
    from ttnx.solvers.als_scan import _local_solve_padded

    R, n, Rb = 5, 2, 3
    C = rng.standard_normal((R, R))
    D = rng.standard_normal((R, R))
    L = jnp.asarray((C @ C.T + np.eye(R))[:, None, :])       # (R, 1, R)
    Renv = jnp.asarray((D @ D.T + np.eye(R))[:, None, :])
    Ac = jnp.asarray(np.eye(n)[None, :, :, None])            # (1, n, n, 1)
    Lb = jnp.asarray(rng.standard_normal((R, Rb)))
    bc = jnp.asarray(rng.standard_normal((Rb, n, Rb)))
    Rb_env = jnp.asarray(rng.standard_normal((R, Rb)))
    m_l = jnp.ones((R,))
    m_r = jnp.ones((R,)).at[R - 1].set(0.0)  # one padded direction
    args = (L, Ac, Renv, Lb, bc, Rb_env, m_l, m_r)
    x_lu = _local_solve_padded(*args, solver="lu")
    x_fused = _local_solve_padded(*args, solver="cg", cg_iters=128)
    assert np.allclose(np.asarray(x_fused), np.asarray(x_lu), atol=1e-9)
    # padded direction stays exactly zero
    assert np.all(np.asarray(x_fused)[:, :, R - 1] == 0.0)


def test_als_sweeps_cg_fused_end_to_end():
    """Full scan-ALS with the matrix-free solver='cg' solves the README
    quick-start system. With A = I every local operator is the identity on
    its active block, so one CG iteration is exact; further iterations only
    feed roundoff into the rank-deficient directions of this rank-4 start
    (b has rank 2), which the ALS carries to ~1e-8 on every solver."""
    import jax
    import ttnx
    from ttnx.core.algebra import matvec, sub, norm
    from ttnx.core.canonical import orthogonalize
    from ttnx.solvers.als_scan import (als_sweeps, pack_op, pack_tt,
                                       rank_masks, unpack_tt)

    d = 6
    A = ttnx.id_tto(d)
    b = ttnx.qtt_sin(d)
    key = jax.random.PRNGKey(0)
    x0 = orthogonalize(ttnx.rand_tt(key, (2,) * d, rmax=4, normalise=True), 0)
    rks = x0.ranks
    rmax = 4
    A_stack = pack_op(A, max(A.ranks))
    b_stack = pack_tt(b, max(b.ranks))
    x_stack = pack_tt(x0, rmax)
    masks = rank_masks(rks, rmax)
    out = als_sweeps(A_stack, b_stack, x_stack, masks, 4, solver="cg",
                     cg_iters=1)
    x = unpack_tt(out, rks)
    rel = float(norm(sub(matvec(A, x), b)) / norm(b))
    assert rel < 1e-10


def test_als_sweeps_cg_fused_complex_falls_back():
    """Complex dtype through the matrix-free CG solves."""
    import jax
    import ttnx
    from ttnx.core.algebra import matvec, sub, norm
    from ttnx.core.canonical import orthogonalize
    from ttnx.solvers.als_scan import (als_sweeps, pack_op, pack_tt,
                                       rank_masks, unpack_tt)

    d = 4
    A = ttnx.id_tto(d).astype(jnp.complex128)
    b = ttnx.qtt_sin(d).astype(jnp.complex128)
    key = jax.random.PRNGKey(0)
    x0 = orthogonalize(
        ttnx.rand_tt(key, (2,) * d, rmax=3, normalise=True), 0
    ).astype(jnp.complex128)
    rks = x0.ranks
    A_stack = pack_op(A, max(A.ranks))
    b_stack = pack_tt(b, max(b.ranks))
    x_stack = pack_tt(x0, 3)
    masks = rank_masks(rks, 3)
    out = als_sweeps(A_stack, b_stack, x_stack, masks, 4, solver="cg")
    x = unpack_tt(out, rks)
    rel = float(norm(sub(matvec(A, x), b)) / norm(b))
    assert rel < 1e-8


def test_cn_step_bicgstab_fused_convection_diffusion():
    """End-to-end CN step on a NON-symmetric convection-diffusion generator:
    the matrix-free solver='bicgstab' matches 'lu' on the represented
    solution."""
    import jax
    import ttnx
    from ttnx.core.decomp import ttv_to_tensor
    from ttnx.solvers.round_scan import make_cn_step

    d, rmax = 6, 8
    n_grid = 2 ** d
    h_grid = 1.0 / (n_grid + 1)
    from ttnx.core.algebra import add_op, scale_op

    # kappa * Laplacian + c * central first derivative (non-symmetric)
    A = add_op(
        scale_op(-0.1 / h_grid ** 2,
                 ttnx.toeplitz_to_qtto(2.0, -1.0, -1.0, d)),
        scale_op(2.0 / (2 * h_grid),
                 ttnx.toeplitz_to_qtto(0.0, 1.0, -1.0, d)))
    u0 = ttnx.qtt_sin(d, a=h_grid, b=1 - h_grid)
    kwargs = dict(dims=(2,) * d, u_rks=(1,) + (rmax,) * (d - 1) + (1,),
                  dtype=jnp.float64, sweep_count=2)
    outs = {}
    for solver in ("lu", "bicgstab"):
        step_fn, pack, unpack = make_cn_step(A, 1e-5, rmax, solver=solver,
                                             cg_iters=96, **kwargs)
        outs[solver] = np.asarray(
            ttv_to_tensor(unpack(step_fn(pack(u0))))).reshape(-1)
    rel = (np.linalg.norm(outs["bicgstab"] - outs["lu"])
           / np.linalg.norm(outs["lu"]))
    assert rel < 1e-9, rel


def _dense_cn_reference(A, u0, h):
    """Exact dense CN step on the 2^d grid."""
    from ttnx.core.decomp import ttv_to_tensor
    from ttnx.ops.qtt import qtto_to_matrix

    Ad = np.asarray(qtto_to_matrix(A))
    ud = np.asarray(ttv_to_tensor(u0)).reshape(-1)
    eye = np.eye(Ad.shape[0])
    return np.linalg.solve(eye - h / 2 * Ad, (eye + h / 2 * Ad) @ ud)


def test_cn_step_bicgstab_fused_oversized_M_falls_back_matrix_free():
    """A buffer rank above the grid's full rank (M = R*n*R = 1152): the
    matrix-free BiCGStab still produces the exact CN step (d=4 is full-rank
    representable)."""
    import ttnx
    from ttnx.core.algebra import add_op, scale_op
    from ttnx.core.decomp import ttv_to_tensor
    from ttnx.solvers.round_scan import make_cn_step

    d, rmax = 4, 24
    n_grid = 2 ** d
    h_grid = 1.0 / (n_grid + 1)
    A = add_op(
        scale_op(-0.05 / h_grid ** 2,
                 ttnx.toeplitz_to_qtto(2.0, -1.0, -1.0, d)),
        scale_op(1.0 / (2 * h_grid),
                 ttnx.toeplitz_to_qtto(0.0, 1.0, -1.0, d)))
    u0 = ttnx.qtt_sin(d, a=h_grid, b=1 - h_grid)
    h = 1e-4
    step_fn, pack, unpack = make_cn_step(
        A, h, rmax, dims=(2,) * d, u_rks=(1,) + (rmax,) * (d - 1) + (1,),
        dtype=jnp.float64, sweep_count=4, solver="bicgstab",
        cg_iters=128)
    out = np.asarray(ttv_to_tensor(unpack(step_fn(pack(u0))))).reshape(-1)
    expect = _dense_cn_reference(A, u0, h)
    rel = np.linalg.norm(out - expect) / np.linalg.norm(expect)
    assert rel < 1e-9, rel


def test_cn_step_bicgstab_fused_complex_falls_back_matrix_free():
    """Matrix-free complex BiCGStab matches the dense CN step of a
    Schrodinger-type (anti-Hermitian) generator."""
    import ttnx
    from ttnx.core.algebra import scale_op
    from ttnx.core.decomp import ttv_to_tensor
    from ttnx.solvers.round_scan import make_cn_step

    d, rmax = 4, 6
    n_grid = 2 ** d
    h_grid = 1.0 / (n_grid + 1)
    A = scale_op(-0.05j / h_grid ** 2,
                 ttnx.toeplitz_to_qtto(2.0, -1.0, -1.0, d))
    u0 = ttnx.qtt_sin(d, a=h_grid, b=1 - h_grid).astype(jnp.complex128)
    h = 1e-4
    step_fn, pack, unpack = make_cn_step(
        A, h, rmax, dims=(2,) * d, u_rks=(1,) + (rmax,) * (d - 1) + (1,),
        dtype=jnp.complex128, sweep_count=4, solver="bicgstab",
        cg_iters=128)
    out = np.asarray(ttv_to_tensor(unpack(step_fn(pack(u0))))).reshape(-1)
    expect = _dense_cn_reference(A, u0, h)
    rel = np.linalg.norm(out - expect) / np.linalg.norm(expect)
    assert rel < 1e-9, rel


def test_dmrg_eigsolve_scan_fused_heisenberg():
    """dmrg_eigsolve_scan (matrix-free Lanczos) reaches the dense
    ground-state energy on the Heisenberg chain (config 3 workload)."""
    import jax
    import ttnx
    from ttnx.solvers.dmrg_scan import dmrg_eigsolve_scan

    d = 6
    H = ttnx.heisenberg_xyz_tto(d, jx=1.0, jy=1.0, jz=1.0)
    x0 = ttnx.rand_tt(jax.random.PRNGKey(3), (2,) * d, rmax=6,
                      normalise=True, orthogonal=True)
    E, psi = dmrg_eigsolve_scan(H, x0, tol=1e-10, rmax=12, n_sweeps=3)
    w = np.linalg.eigvalsh(np.asarray(ttnx.qtto_to_matrix(H)))
    assert abs(float(E[-1]) - w[0]) < 1e-7, (float(E[-1]), w[0])


def _spd_local_systems(R, B, n=2, RA=3, seed=0, dtype=jnp.float32):
    """B SPD masked local systems: PSD environments (identity on W=0 plus
    small symmetric terms) with a positive operator core."""
    rng = np.random.default_rng(seed)
    L = np.zeros((B, R, RA, R))
    Re = np.zeros((B, R, RA, R))
    for b in range(B):
        for W in range(RA):
            C = rng.standard_normal((R, R)) / np.sqrt(R)
            D = rng.standard_normal((R, R)) / np.sqrt(R)
            L[b, :, W, :] = (C @ C.T) * (0.2 if W else 1.0) \
                + (np.eye(R) if W == 0 else 0.0)
            Re[b, :, W, :] = (D @ D.T) * (0.2 if W else 1.0) \
                + (np.eye(R) if W == 0 else 0.0)
    Ac = np.zeros((RA, n, n, RA))
    for W in range(RA):
        Ac[W, :, :, W] = np.eye(n) * (1.0 if W == 0 else 0.1)
    m_l = np.ones(R)
    m_l[R - 3:] = 0.0
    m_r = np.ones(R)
    m_r[R - 2:] = 0.0
    mask = m_l[:, None, None] * m_r[None, None, :] * np.ones((1, n, 1))
    rhs = rng.standard_normal((B, R, n, R)) * mask
    x0 = 0.1 * rng.standard_normal((B, R, n, R))
    cast = lambda a: jnp.asarray(a, dtype)
    return cast(L), cast(Ac), cast(Re), cast(rhs), cast(mask), cast(x0)


class TestMatrixFreeCG:
    """The Triton local CG (ttnx.kernels.cg_triton) in interpret mode
    against the XLA matrix-free CG it replaces on the card."""

    @pytest.mark.parametrize("R,warm", [(16, True), (16, False),
                                        (32, True), (32, False)])
    def test_matches_xla_cg(self, R, warm):
        from ttnx.kernels.cg_triton import cg_matfree_batched
        from ttnx.solvers.als_scan_batched import _b_cg

        L, Ac, Re, rhs, mask, x0 = _spd_local_systems(R, 2)
        x0 = x0 if warm else None
        with jax.default_matmul_precision("highest"):
            got = cg_matfree_batched(L, Ac, Re, rhs, mask, x0, iters=8,
                                     interpret=True)
            want = _b_cg(L, Ac, Re, rhs, mask, x0, 8)
        rel = float(jnp.max(jnp.abs(got - want)) / jnp.max(jnp.abs(want)))
        assert rel < 1e-5, rel

    def test_padded_directions_stay_zero(self):
        from ttnx.kernels.cg_triton import cg_matfree_batched

        L, Ac, Re, rhs, mask, x0 = _spd_local_systems(16, 2)
        got = np.asarray(cg_matfree_batched(L, Ac, Re, rhs, mask, x0,
                                            iters=4, interpret=True))
        assert np.all(got * (1.0 - np.asarray(mask))[None] == 0.0)

    def test_batch_grid_matches_per_problem_calls(self):
        """Each program of the batch grid solves its own problem."""
        from ttnx.kernels.cg_triton import cg_matfree_batched

        L, Ac, Re, rhs, mask, x0 = _spd_local_systems(16, 3, seed=5)
        got = cg_matfree_batched(L, Ac, Re, rhs, mask, x0, iters=6,
                                 interpret=True)
        for b in range(3):
            one = cg_matfree_batched(L[b:b + 1], Ac, Re[b:b + 1],
                                     rhs[b:b + 1], mask, x0[b:b + 1],
                                     iters=6, interpret=True)
            assert np.allclose(np.asarray(one[0]), np.asarray(got[b]),
                               rtol=1e-5, atol=1e-6)

    def test_converges_to_dense_solution(self):
        """Enough iterations reach the dense solve of the masked system."""
        from ttnx.kernels.cg_triton import cg_matfree_batched

        R, n = 16, 2
        L, Ac, Re, rhs, mask, _ = _spd_local_systems(R, 1, seed=2,
                                                     dtype=jnp.float64)
        K = np.einsum("aWb,WiJw,cwd->aicbJd", np.asarray(L[0]),
                      np.asarray(Ac), np.asarray(Re[0])).reshape(
                          R * n * R, R * n * R)
        m = np.asarray(mask).reshape(-1)
        K = K * m[:, None] * m[None, :] + np.diag(1.0 - m)
        want = np.linalg.solve(K, np.asarray(rhs[0]).reshape(-1))
        got = cg_matfree_batched(*(a.astype(jnp.float32) for a in
                                   (L, Ac, Re, rhs, mask)), None, iters=60,
                                 interpret=True)
        got = np.asarray(got[0], np.float64).reshape(-1)
        assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-4

    @pytest.mark.parametrize("backend,dtype,R,expect", [
        ("gpu", jnp.float32, 16, True),
        ("gpu", jnp.float32, 32, False),
        ("gpu", jnp.float32, 64, False),
        ("gpu", jnp.float32, 8, False),
        ("gpu", jnp.float64, 16, False),
        ("gpu", jnp.complex64, 16, False),
        ("cpu", jnp.float32, 16, False),
    ])
    def test_gate(self, monkeypatch, backend, dtype, R, expect):
        from ttnx.kernels import dispatch

        monkeypatch.setattr(dispatch.jax, "default_backend", lambda: backend)
        assert dispatch.use_triton_cg(dtype, R) is expect

    def _als_setup(self, rmax):
        import ttnx
        from ttnx.core.algebra import add_op, scale_op
        from ttnx.core.canonical import tt_round
        from ttnx.core.tt import id_tto, r_and_d_to_rks
        from ttnx.solvers.als_scan import pack_op, pack_tt, rank_masks

        d = 6
        hg = 1.0 / (2 ** d + 1)
        A = ((-1.0 / hg ** 2) * ttnx.toeplitz_to_qtto(2.0, -1.0, -1.0, d)
             ).astype(jnp.float32)
        lhs = add_op(id_tto(d, dtype=jnp.float32), scale_op(-5e-7, A))
        lhs_stack = pack_op(lhs, max(lhs.ranks))
        u_rks = r_and_d_to_rks((1,) + (rmax,) * (d - 1) + (1,), (2,) * d,
                               rmax=rmax)
        masks = rank_masks(u_rks, rmax, dtype=jnp.float32)
        u0 = ttnx.qtt_sin(d, a=hg, b=1 - hg)
        us = pack_tt(tt_round(u0, max_bond=rmax).astype(jnp.float32), rmax)
        return lhs_stack, us, masks, u_rks

    def _route_to_interpreted_kernel(self, monkeypatch):
        from ttnx.kernels import cg_triton, dispatch

        monkeypatch.setattr(dispatch, "use_triton_cg", lambda dtype, R: True)
        monkeypatch.setattr(cg_triton, "cg_matfree_batched", functools.partial(
            cg_triton.cg_matfree_batched, interpret=True))

    def test_als_kernel_path_matches_cg(self, monkeypatch):
        """solver='cg' with the kernel admitted (interpret mode on CPU)
        represents the same solution as the XLA form."""
        from ttnx.core.decomp import ttv_to_tensor
        from ttnx.solvers.als_scan import als_sweeps, unpack_tt

        lhs_stack, us, masks, u_rks = self._als_setup(16)
        out_c = als_sweeps(lhs_stack, us, us, masks, 2, solver="cg",
                           cg_iters=12)
        self._route_to_interpreted_kernel(monkeypatch)
        with jax.default_matmul_precision("highest"):
            out_k = als_sweeps(lhs_stack, us, us, masks, 2, solver="cg",
                               cg_iters=12)
        vk = np.asarray(ttv_to_tensor(unpack_tt(out_k, u_rks))).reshape(-1)
        vc = np.asarray(ttv_to_tensor(unpack_tt(out_c, u_rks))).reshape(-1)
        rel = np.linalg.norm(vk - vc) / np.linalg.norm(vc)
        assert rel < 1e-5, rel

    def test_cg_takes_xla_cg_off_gpu(self, monkeypatch):
        """Where the dispatch rejects the kernel (here: the CPU backend at
        rank 16, which a GPU would send to it), solver='cg' never traces
        the kernel, single-problem or batched."""
        from ttnx.kernels import cg_triton
        from ttnx.solvers.als_scan import als_sweeps
        from ttnx.solvers.als_scan_batched import als_sweeps_b

        def refuse(*a, **k):
            raise AssertionError("kernel traced off the GPU")

        monkeypatch.setattr(cg_triton, "cg_matfree_batched", refuse)
        lhs_stack, us, masks, _ = self._als_setup(16)
        out = als_sweeps(lhs_stack, us, us, masks, 2, solver="cg",
                         cg_iters=8)
        outb = als_sweeps_b(lhs_stack, us[None], us[None], masks, 2,
                            cg_iters=8)
        assert np.all(np.isfinite(np.asarray(out)))
        assert np.all(np.isfinite(np.asarray(outb)))


def test_batched_dmrg_f32_r16_smoke(key):
    """The batched DMRG wrapper at f32 rank 16 under vmap."""
    import ttnx
    from ttnx.parallel.batch import batched_dmrg_eig_sweeps
    from ttnx.solvers.als_scan import pack_op, pack_tt, rank_masks
    from ttnx.solvers.dmrg_scan import dmrg_eig_sweep

    d, rmax = 5, 16
    H = ttnx.heisenberg_xyz_tto(d, jx=1.0, jy=1.0, jz=1.0
                                ).astype(jnp.float32)
    A_stack = pack_op(H, max(H.ranks))
    keys = jax.random.split(key, 2)
    xs, ms = [], []
    for k in keys:
        x = ttnx.rand_tt(k, (2,) * d, rmax=4, normalise=True,
                         orthogonal=True).astype(jnp.float32)
        xs.append(pack_tt(x, rmax))
        ms.append(rank_masks(x.ranks, rmax, dtype=jnp.float32))
    x_batch, m_batch = jnp.stack(xs), jnp.stack(ms)
    tol = jnp.float32(1e-7)
    xb, mb, Eb = batched_dmrg_eig_sweeps(A_stack, x_batch, m_batch,
                                         tol, tol, n_sweeps=4)
    from ttnx.core.decomp import tto_to_tensor

    Hd = np.asarray(tto_to_tensor(H.astype(jnp.float64))
                    ).reshape(2 ** d, 2 ** d)
    E0 = np.linalg.eigvalsh(Hd)[0]
    for i in range(2):
        # converged batched energy vs dense oracle (f32 class)
        assert abs(float(Eb[i][-1]) - E0) < 1e-3, (i, Eb[i][-1], E0)
        # and parity with the per-problem loop at convergence
        x, m = x_batch[i], m_batch[i]
        for _ in range(4):
            x, m, E = dmrg_eig_sweep(A_stack, x, m, tol, tol)
        assert abs(float(Eb[i][-1]) - float(E[-1])) < 1e-3


def _chain_reference(x, A, b, left):
    """Environment stacks by explicit per-site numpy contraction, in the
    dtype's own precision: the eager reference for the XLA scans."""
    d, R, n, _ = x.shape
    RA, Rb = A.shape[1], b.shape[1]
    e = np.zeros((R, RA, R), x.dtype)
    e[0, 0, 0] = 1.0
    eb = np.zeros((R, Rb), x.dtype)
    eb[0, 0] = 1.0
    envs, envs_b = [e], [eb]
    sites = range(d) if left else range(d - 1, -1, -1)
    for k in sites:
        xc, Ac, bc = x[k], A[k], b[k]
        if left:
            e = np.einsum("aic,aWb,Wijw,bjd->cwd", xc.conj(), e, Ac, xc)
            eb = np.einsum("aip,au,uiv->pv", xc.conj(), eb, bc)
        else:
            e = np.einsum("aip,Wijw,bjq,pwq->aWb", xc.conj(), Ac, xc, e)
            eb = np.einsum("aip,uiv,pv->au", xc.conj(), bc, eb)
        envs.append(e)
        envs_b.append(eb)
    if not left:
        envs, envs_b = envs[::-1], envs_b[::-1]
    return np.stack(envs), np.stack(envs_b)


_CHAIN_TOL = {jnp.float32: 1e-5, jnp.float64: 1e-12, jnp.complex128: 1e-12}


def _chain_inputs(dtype, d=5, R=6, seed=7):
    rng = np.random.default_rng(seed)
    RA, Rb, n = 3, 4, 2
    x = rng.standard_normal((d, R, n, R))
    A = rng.standard_normal((d, RA, n, n, RA))
    b = rng.standard_normal((d, Rb, n, Rb))
    if jnp.issubdtype(dtype, jnp.complexfloating):
        x = x + 1j * rng.standard_normal(x.shape)
        A = A + 1j * rng.standard_normal(A.shape)
    x[0, 1:] = 0.0                 # boundary ranks are 1
    x[-1, :, :, 1:] = 0.0
    np_dt = np.dtype(jnp.dtype(dtype).name)
    return x.astype(np_dt), A.astype(np_dt), b.astype(np_dt)


class TestXlaChains:
    """The XLA scans that took over from the removed chain kernels, against
    an eager per-site reference in f32, f64 and c128."""

    @pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64,
                                       jnp.complex128])
    @pytest.mark.parametrize("left", [False, True])
    def test_env_chain_matches_eager(self, dtype, left):
        from ttnx.solvers.als_scan import _left_env_stack, _right_env_stack

        x, A, b = _chain_inputs(dtype)
        d, R = x.shape[0], x.shape[1]
        masks = jnp.ones((d, R), jnp.zeros((), dtype).real.dtype)
        stack = _left_env_stack if left else _right_env_stack
        with jax.default_matmul_precision("highest"):
            got, gotb = stack(jnp.asarray(x), jnp.asarray(A), jnp.asarray(b),
                              masks)
        ref, refb = _chain_reference(x, A, b, left)
        tol = _CHAIN_TOL[dtype]
        scale = np.max(np.abs(ref))
        assert np.max(np.abs(np.asarray(got) - ref)) < tol * scale
        assert np.max(np.abs(np.asarray(gotb) - refb)) < tol * max(
            1.0, np.max(np.abs(refb)))

    @pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64,
                                       jnp.complex128])
    def test_gram_chain_matches_eager(self, dtype):
        from ttnx.solvers.round_scan import _gram_chain_xla

        y, _, _ = _chain_inputs(dtype, R=8, seed=3)
        with jax.default_matmul_precision("highest"):
            got = np.asarray(_gram_chain_xla(jnp.asarray(y)))
        d, R = y.shape[0], y.shape[1]
        G = np.zeros((R, R), y.dtype)
        G[0, 0] = 1.0
        ref = [G]
        for k in range(d - 1, 0, -1):
            G = sum(y[k][:, i, :] @ G @ y[k][:, i, :].conj().T
                    for i in range(y.shape[2]))
            ref.append(G)
        ref = np.stack(ref[::-1])          # ref[k] = G_{k+1}
        assert got.shape == ref.shape
        assert np.max(np.abs(got - ref)) < _CHAIN_TOL[dtype] * np.max(
            np.abs(ref))
