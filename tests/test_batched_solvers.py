"""Batched (vmap/dp) DMRG eigensolve and TDVP evolution — the parameter-sweep
tier of BASELINE configs 3-4 (reference workloads:
/root/reference/examples/heisenberg_xyz_dmrg.jl,
/root/reference/examples/tdvp_example.jl, run as a batch of couplings /
step sizes). Parity vs the per-problem loop, physics vs dense oracles, and
dp-sharded equality on the virtual mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import ttnx
from ttnx.core.decomp import ttv_to_tensor
from ttnx.parallel.batch import (
    batched_dmrg_eig_sweeps,
    batched_tdvp1_steps,
    batched_tdvp2_steps,
    make_mesh,
    shard_batch,
)
from ttnx.solvers.als_scan import pack_op, pack_tt, rank_masks, unpack_tt
from ttnx.solvers.dmrg_scan import dmrg_eig_sweep
from ttnx.solvers.tdvp_scan import tdvp1_step, tdvp2_step

D = 6
LAMS = (0.0, 0.4, 0.9)


def _heis_batch():
    """Batch of Heisenberg XXZ Hamiltonians over a field sweep (shared
    shapes: the rank-5 MPO structure is field-independent)."""
    ops = [ttnx.heisenberg_xyz_tto(D, jx=1.0, jy=1.0, jz=0.5, lam=lam,
                                   field="z") for lam in LAMS]
    RA = max(ops[0].ranks)
    return jnp.stack([pack_op(H, RA) for H in ops]), ops


def _state_batch(key, rmax=8, batch=len(LAMS)):
    keys = jax.random.split(key, batch)
    xs, ms = [], []
    for k in keys:
        x = ttnx.rand_tt(k, (2,) * D, rmax=4, normalise=True,
                         orthogonal=True)
        xs.append(pack_tt(x, rmax))
        ms.append(rank_masks(x.ranks, rmax))
    return jnp.stack(xs), jnp.stack(ms)


class TestBatchedDMRG:
    def test_parity_vs_loop_and_dense_oracle(self, key):
        A_batch, ops = _heis_batch()
        x_batch, m_batch = _state_batch(key)
        tol = jnp.float64(1e-10)
        xb, mb, Eb = batched_dmrg_eig_sweeps(A_batch, x_batch, m_batch,
                                             tol, tol, n_sweeps=3)
        for i, H in enumerate(ops):
            # parity with the unbatched sweep, problem by problem
            x, m = x_batch[i], m_batch[i]
            for _ in range(3):
                x, m, E = dmrg_eig_sweep(A_batch[i], x, m, tol, tol)
            assert np.allclose(np.asarray(Eb[i][-len(E):]), np.asarray(E),
                               atol=1e-9)
            # physics: ground-state energy vs dense diagonalization
            from ttnx.core.decomp import tto_to_tensor

            Hd = np.asarray(tto_to_tensor(H)).reshape(2 ** D, 2 ** D)
            E0 = np.linalg.eigvalsh(Hd)[0]
            assert abs(float(Eb[i][-1]) - E0) < 1e-8, (i, Eb[i][-1], E0)

    def test_shared_operator_broadcast(self, key):
        A_batch, ops = _heis_batch()
        x_batch, m_batch = _state_batch(key)
        tol = jnp.float64(1e-10)
        # one shared operator (5-D stack) across the batch
        xb, mb, Eb = batched_dmrg_eig_sweeps(A_batch[0], x_batch, m_batch,
                                             tol, tol, n_sweeps=2)
        assert Eb.shape[0] == x_batch.shape[0]
        x, m = x_batch[1], m_batch[1]
        for _ in range(2):
            x, m, E = dmrg_eig_sweep(A_batch[0], x, m, tol, tol)
        assert np.allclose(np.asarray(Eb[1][-len(E):]), np.asarray(E),
                           atol=1e-9)

    def test_dp_sharded_equals_unsharded(self, key):
        A_batch, _ = _heis_batch()
        # pad the batch to 8 problems for the dp mesh
        x_batch, m_batch = _state_batch(key, batch=8)
        A8 = jnp.concatenate([A_batch, A_batch, A_batch[:2]], axis=0)
        tol = jnp.float64(1e-10)
        ref = batched_dmrg_eig_sweeps(A8, x_batch, m_batch, tol, tol,
                                      n_sweeps=1)
        mesh = make_mesh(dp=8, tp=1)
        A_sh, x_sh, m_sh = shard_batch(mesh, A8, x_batch, m_batch)
        with mesh:
            out = jax.jit(lambda A, x, m: batched_dmrg_eig_sweeps(
                A, x, m, tol, tol, n_sweeps=1))(A_sh, x_sh, m_sh)
        # compare energies and masks: the cores are gauge/degeneracy-
        # sensitive (sharded compilation reorders reductions; Lanczos
        # amplifies eps-level input differences inside degenerate subspaces)
        assert np.allclose(np.asarray(ref[2]), np.asarray(out[2]),
                           atol=1e-8)
        assert np.allclose(np.asarray(ref[1]), np.asarray(out[1]))


class TestBatchedTDVP:
    def _heat(self, rmax=8):
        from ttnx.core.canonical import orthogonalize

        hg = 1.0 / (2 ** D + 1)
        A = (-1.0 / hg ** 2) * ttnx.toeplitz_to_qtto(2.0, -1.0, -1.0, D)
        u0 = ttnx.qtt_sin(D, a=hg, b=1 - hg)
        A_stack = pack_op(A, max(A.ranks))
        # the TDVP step contract: state packed in site-0 canonical form
        x = pack_tt(orthogonalize(u0, 0), rmax)
        m = rank_masks(ttnx.core.tt.r_and_d_to_rks(u0.ranks, (2,) * D,
                                                   rmax=rmax), rmax)
        return A_stack, x, m, u0, hg

    def test_tdvp1_vector_h_parity_and_decay(self):
        A_stack, x, m, u0, hg = self._heat()
        batch = 4
        hs = jnp.asarray([1e-5, 2e-5, 4e-5, 8e-5])
        xb = jnp.broadcast_to(x, (batch,) + x.shape)
        mb = jnp.broadcast_to(m, (batch,) + m.shape)
        out = batched_tdvp1_steps(A_stack, xb, mb, hs, n_steps=2,
                                  krylov_dim=8, imag_real=True)
        mu1 = (2 - 2 * np.cos(np.pi * hg)) / hg ** 2
        u0_dense = np.asarray(ttv_to_tensor(u0)).reshape(-1)
        rks = ttnx.core.tt.r_and_d_to_rks(u0.ranks, (2,) * D, rmax=8)
        for i, h in enumerate(np.asarray(hs)):
            got = np.asarray(ttv_to_tensor(unpack_tt(out[i], rks))
                             ).reshape(-1)
            expect = u0_dense * np.exp(-mu1 * 2 * h)
            rel = np.linalg.norm(got - expect) / np.linalg.norm(expect)
            assert rel < 1e-8, (i, rel)
            # parity with the unbatched step
            v = x
            for _ in range(2):
                v = tdvp1_step(A_stack, v, m, jnp.float64(h),
                               krylov_dim=8, imag_real=True)
            assert np.allclose(np.asarray(out[i]), np.asarray(v),
                               atol=1e-12)

    def test_tdvp2_parity_vs_loop(self):
        A_stack, x, m, u0, hg = self._heat()
        batch = 3
        xb = jnp.broadcast_to(x, (batch,) + x.shape)
        mb = jnp.broadcast_to(m, (batch,) + m.shape)
        h = jnp.float64(1e-5)
        out_x, out_m = batched_tdvp2_steps(A_stack, xb, mb, h,
                                           truncerr=0.0, max_bond=8,
                                           n_steps=1, krylov_dim=8,
                                           imag_real=True)
        v, vm = tdvp2_step(A_stack, x, m, h, jnp.float64(0.0),
                           jnp.int32(8), krylov_dim=8, imag_real=True)
        for i in range(batch):
            assert np.allclose(np.asarray(out_x[i]), np.asarray(v),
                               atol=1e-12)
            assert np.allclose(np.asarray(out_m[i]), np.asarray(vm))


class TestHermitianGuard:
    def test_lanczos_rejects_non_hermitian(self):
        from ttnx.solvers.tdvp_scan import tdvp1_scan

        grad = ttnx.toeplitz_to_qtto(0.0, 1.0, -1.0, 4)  # antisymmetric
        u0 = ttnx.qtt_sin(4)
        with pytest.raises(ValueError, match="Hermitian"):
            tdvp1_scan(grad, u0, [1e-3], imaginary_time=False)

    def test_lanczos_accepts_hermitian(self):
        from ttnx.solvers.tdvp_scan import tdvp1_scan

        lap = ttnx.toeplitz_to_qtto(2.0, -1.0, -1.0, 4)
        u0 = ttnx.qtt_sin(4)
        out = tdvp1_scan(lap, u0, [1e-3], imaginary_time=True)
        assert np.isfinite(np.asarray(ttv_to_tensor(out))).all()


class TestFlopsUtil:
    def test_einsum_flops_matmul_convention(self):
        from ttnx.utils.flops import einsum_flops

        assert einsum_flops("ik,kj->ij", (7, 3), (3, 5)) == 2 * 7 * 3 * 5
        # pairwise decomposition must beat the naive 4-term contraction
        f = einsum_flops("aWb,WiJw,cwd,bJd->aic",
                         (64, 4, 64), (4, 2, 2, 4), (64, 4, 64), (64, 2, 64))
        assert f < 0.1 * (2 * 64 ** 3 * 4 ** 2 * 2 ** 2 * 64)

    def test_cn_step_flops_scaling(self):
        from ttnx.utils.flops import cn_step_flops

        f32 = cn_step_flops(12, 32, 4, 4)
        f64 = cn_step_flops(12, 64, 4, 4)
        # contraction cost grows ~R^3: doubling R costs 6-8x
        assert 5.0 < f64 / f32 < 9.0


class TestExplicitBatchALS:
    """als_sweeps_b — the explicit-batch twin of vmap(als_sweeps): same
    algorithm with the B axis written into the einsums.
    Cores may differ by QR sign gauge; the represented vectors must match."""

    def test_matches_vmap_als(self, key):
        from ttnx.core.algebra import add_op, scale_op
        from ttnx.core.canonical import tt_round
        from ttnx.core.decomp import ttv_to_tensor
        from ttnx.core.tt import id_tto, r_and_d_to_rks
        from ttnx.solvers.als_scan import als_sweeps
        from ttnx.solvers.als_scan_batched import als_sweeps_b

        d, rmax = 6, 8
        hg = 1.0 / (2 ** d + 1)
        A = (-1.0 / hg ** 2) * ttnx.toeplitz_to_qtto(2.0, -1.0, -1.0, d)
        lhs = add_op(id_tto(d), scale_op(-5e-7, A))
        lhs_stack = pack_op(lhs, max(lhs.ranks))
        u_rks = r_and_d_to_rks((1,) + (rmax,) * (d - 1) + (1,), (2,) * d,
                               rmax=rmax)
        masks = rank_masks(u_rks, rmax)
        u0 = (ttnx.qtt_sin(d, a=hg, b=1 - hg)
              + 0.3 * ttnx.qtt_sin(d, a=hg, b=1 - hg, lam=3.0))
        us = pack_tt(tt_round(u0, max_bond=rmax), rmax)
        B = 3
        bb = jnp.stack([(1.0 + 0.2 * i) * us for i in range(B)])
        xb = jnp.broadcast_to(us, (B,) + us.shape)
        out = als_sweeps_b(lhs_stack, bb, xb, masks, 2, cg_iters=60)
        ref = jax.vmap(lambda b, x: als_sweeps(
            lhs_stack, b, x, masks, 2, solver="cg", cg_iters=60))(bb, xb)
        for i in range(B):
            vo = np.asarray(ttv_to_tensor(unpack_tt(out[i], u_rks))
                            ).reshape(-1)
            vr = np.asarray(ttv_to_tensor(unpack_tt(ref[i], u_rks))
                            ).reshape(-1)
            rel = np.linalg.norm(vo - vr) / np.linalg.norm(vr)
            assert rel < 1e-12, (i, rel)

    def test_cg_fused_kernel_path_matches_cg(self, key):
        """f32 at rank 32: the explicitly batched ALS represents the same
        solutions as the vmapped scan ALS, both with matrix-free CG."""
        from ttnx.core.algebra import add_op, scale_op
        from ttnx.core.canonical import tt_round
        from ttnx.core.decomp import ttv_to_tensor
        from ttnx.core.tt import id_tto, r_and_d_to_rks
        from ttnx.solvers.als_scan import als_sweeps
        from ttnx.solvers.als_scan_batched import als_sweeps_b

        d, rmax = 6, 32
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
        B = 3
        bb = jnp.stack([(1.0 + 0.2 * i) * us for i in range(B)])
        out_k = als_sweeps_b(lhs_stack, bb, bb, masks, 2, cg_iters=24)
        out_c = jax.vmap(lambda b, x: als_sweeps(
            lhs_stack, b, x, masks, 2, solver="cg", cg_iters=24))(bb, bb)
        for i in range(B):
            vk = np.asarray(ttv_to_tensor(unpack_tt(out_k[i], u_rks))
                            ).reshape(-1)
            vc = np.asarray(ttv_to_tensor(unpack_tt(out_c[i], u_rks))
                            ).reshape(-1)
            rel = np.linalg.norm(vk - vc) / np.linalg.norm(vc)
            assert rel < 1e-4, (i, rel)
