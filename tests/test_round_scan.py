"""Jitted contraction+rounding pipeline and the fully-jitted CN step."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ttnx import id_tto, qtt_sin, rand_tt, toeplitz_to_qtto, ttv_to_tensor
from ttnx.core.algebra import add_op, matvec, scale_op
from ttnx.core.canonical import orthogonalize, tt_round
from ttnx.core.tt import r_and_d_to_rks
from ttnx.solvers.als_scan import pack_op, pack_tt, rank_masks
from ttnx.solvers.round_scan import (
    make_cn_step,
    matvec_padded,
    round_masks,
    tt_round_scan,
)


def vec(tt):
    return np.asarray(ttv_to_tensor(tt)).reshape(-1)


def padded_to_vec(stack):
    p = stack[0][0:1].reshape(2, -1)
    for k in range(1, stack.shape[0]):
        r = stack.shape[1]
        p = (p @ stack[k].reshape(r, -1)).reshape(-1, r)
    return np.asarray(p[:, 0])


def _setup(d=5, rmax=4):
    A = add_op(id_tto(d), scale_op(0.1, toeplitz_to_qtto(-2.0, 1.0, 1.0, d)))
    u = orthogonalize(qtt_sin(d), 0)
    RA = max(A.ranks)
    dims = (2,) * d
    u_rks = r_and_d_to_rks((1,) + (rmax,) * (d - 1) + (1,), dims, rmax=rmax)
    masks_u = rank_masks(u_rks, rmax)
    masks_A = np.zeros((d + 1, RA))
    for i, r in enumerate(A.ranks):
        masks_A[i, :r] = 1.0
    mu = np.asarray(masks_u)
    masks_big = jnp.asarray(np.stack(
        [np.outer(masks_A[i], mu[i]).reshape(-1) for i in range(d + 1)]))
    return A, u, RA, dims, u_rks, masks_big


class TestMatvecPadded:
    def test_matches_eager_matvec(self):
        A, u, RA, dims, u_rks, _ = _setup()
        big = matvec_padded(pack_op(A, RA), pack_tt(u, 4))
        ref = vec(matvec(A, u))
        assert np.allclose(padded_to_vec(big), ref, atol=1e-12)


class TestRoundScan:
    def test_matches_eager_round(self):
        A, u, RA, dims, u_rks, masks_big = _setup()
        rmax = 4
        big = matvec_padded(pack_op(A, RA), pack_tt(u, rmax))
        big_rks = [min(a * b, RA * rmax) for a, b in zip(A.ranks, u_rks)]
        out_rks = round_masks(big_rks, rmax, dims)
        rounded = tt_round_scan(big, masks_big, rmax, rank_masks(out_rks, rmax))
        ref = vec(tt_round(matvec(A, u), max_bond=rmax))
        assert np.allclose(padded_to_vec(rounded), ref, atol=1e-10)

    def test_padding_stays_clean(self):
        A, u, RA, dims, u_rks, masks_big = _setup()
        rmax = 4
        big = matvec_padded(pack_op(A, RA), pack_tt(u, rmax))
        big_rks = [min(a * b, RA * rmax) for a, b in zip(A.ranks, u_rks)]
        out_rks = round_masks(big_rks, rmax, dims)
        rounded = np.asarray(
            tt_round_scan(big, masks_big, rmax, rank_masks(out_rks, rmax)))
        for k in range(len(dims)):
            rl, rr = out_rks[k], out_rks[k + 1]
            assert np.all(rounded[k, rl:, :, :] == 0)
            assert np.all(rounded[k, :, :, rr:] == 0)


class TestJittedCN:
    @pytest.mark.parametrize("d", [8, 12])
    def test_heat_equation_machine_precision(self, d):
        n = 2 ** d
        hg = 1.0 / (n + 1)
        A = (1.0 / hg ** 2) * toeplitz_to_qtto(-2.0, 1.0, 1.0, d)
        u0 = qtt_sin(d, a=hg, b=1 - hg)
        dt = 1e-8
        lam = -4.0 / hg ** 2 * np.sin(np.pi * hg / 2) ** 2
        step, pack, unpack = make_cn_step(
            A, dt, rmax=4, dims=(2,) * d,
            u_rks=(1,) + (4,) * (d - 1) + (1,), sweep_count=6)
        u = pack(u0)
        n_steps = 3
        for _ in range(n_steps):
            u = step(u)
        out = unpack(u)
        g = (1 + dt * lam / 2) / (1 - dt * lam / 2)
        expect = g ** n_steps * vec(u0)
        rel = np.linalg.norm(vec(out) - expect) / np.linalg.norm(expect)
        # BASELINE config-2 target is 1e-12; the jitted pipeline reaches ~1e-15
        assert rel < 1e-12

    def test_single_compiled_program(self):
        # repeated steps reuse the compiled cn_step (no retracing)
        from ttnx.solvers.round_scan import cn_step

        d = 6
        A = toeplitz_to_qtto(-2.0, 1.0, 1.0, d)
        step, pack, unpack = make_cn_step(
            A, 1e-6, rmax=4, dims=(2,) * d,
            u_rks=(1,) + (4,) * (d - 1) + (1,))
        u = pack(qtt_sin(d))
        n0 = cn_step._cache_size()
        u = step(u)
        n1 = cn_step._cache_size()
        u = step(u)
        assert cn_step._cache_size() == n1 > n0


class TestGramRounding:
    """method='gram' — eigh/matmul rounding."""

    def test_gram_matches_svd_rounding(self):
        A, u, RA, dims, u_rks, masks_big = _setup()
        big = matvec_padded(pack_op(A, RA), pack_tt(u, 4))
        big_rks = [min(a * b, RA * 4) for a, b in zip(A.ranks, u_rks)]
        out_rks = round_masks(big_rks, 4, dims)
        masks_out = rank_masks(out_rks, 4)
        ys = tt_round_scan(big, masks_big, 4, masks_out, method="svd")
        yg = tt_round_scan(big, masks_big, 4, masks_out, method="gram")
        assert np.allclose(padded_to_vec(yg), padded_to_vec(ys), atol=1e-10)

    def test_gram_handles_rank_deficient_chain(self):
        # MPO-apply output: early bonds have true rank << mask rank — the
        # exact case that breaks naive CholeskyQR (NaNs); the pseudo-inverted
        # square root must stay finite and exact
        d = 7
        A = add_op(id_tto(d), scale_op(0.05, toeplitz_to_qtto(2.0, -1.0, -1.0, d)))
        u = orthogonalize(qtt_sin(d), 0)
        RA = max(A.ranks)
        rmax = 6
        dims = (2,) * d
        u_rks = r_and_d_to_rks(u.ranks, dims, rmax=rmax)
        masks_u = rank_masks(u_rks, rmax)
        masks_A = np.zeros((d + 1, RA))
        for i, r in enumerate(A.ranks):
            masks_A[i, :r] = 1.0
        mu = np.asarray(masks_u)
        masks_big = jnp.asarray(np.stack(
            [np.outer(masks_A[i], mu[i]).reshape(-1) for i in range(d + 1)]))
        big = matvec_padded(pack_op(A, RA), pack_tt(u, rmax))
        big_rks = [min(a * b, RA * rmax) for a, b in zip(A.ranks, u_rks)]
        out_rks = round_masks(big_rks, rmax, dims)
        masks_out = rank_masks(out_rks, rmax)
        yg = tt_round_scan(big, masks_big, rmax, masks_out, method="gram")
        got = padded_to_vec(yg)
        assert np.all(np.isfinite(got))
        ref = vec(tt_round(matvec(A, u), max_bond=rmax))
        assert np.allclose(got, ref, atol=1e-10)

    def test_cn_step_gram_machine_precision(self):
        d, rmax = 8, 8
        h_grid = 1.0 / (2 ** d + 1)
        A = (-1.0 / h_grid ** 2) * toeplitz_to_qtto(2.0, -1.0, -1.0, d)
        step_fn, pack, unpack = make_cn_step(
            A, 1e-7, rmax=rmax, dims=(2,) * d,
            u_rks=(1,) + (rmax,) * (d - 1) + (1,), sweep_count=3,
            round_method="gram")
        u0 = qtt_sin(d, a=h_grid, b=1 - h_grid)
        u = pack(u0)
        for _ in range(5):
            u = step_fn(u)
        lam1 = (2 - 2 * np.cos(np.pi / (2 ** d + 1))) / h_grid ** 2
        got = vec(unpack(u))
        expect = vec(u0) * np.exp(-lam1 * 5e-7)
        rel = np.linalg.norm(got - expect) / np.linalg.norm(expect)
        assert rel < 1e-12


def test_make_cn_evolve_matches_stepping():
    """The fused-trajectory fori_loop program equals repeated single steps."""
    import numpy as np
    import jax.numpy as jnp
    import ttnx
    from ttnx.solvers.round_scan import make_cn_evolve, make_cn_step

    d, rmax = 6, 8
    h_grid = 1.0 / (2 ** d + 1)
    A = (-1.0 / h_grid ** 2) * ttnx.toeplitz_to_qtto(2.0, -1.0, -1.0, d)
    u0 = ttnx.qtt_sin(d, a=h_grid, b=1 - h_grid)
    kwargs = dict(dims=(2,) * d, u_rks=(1,) + (rmax,) * (d - 1) + (1,),
                  dtype=jnp.float64, sweep_count=2)
    step_fn, pack, _ = make_cn_step(A, 1e-6, rmax, **kwargs)
    evolve_fn, pack2, _ = make_cn_evolve(A, 1e-6, rmax, n_steps=3, **kwargs)
    u = pack(u0)
    u_loop = u
    for _ in range(3):
        u_loop = step_fn(u_loop)
    u_fused = evolve_fn(pack2(u0))
    assert np.allclose(np.asarray(u_fused), np.asarray(u_loop), atol=1e-12)


class TestGramChainRounding:
    """round_method='gram_chain' — backward pure-matmul Gram sweep, then a
    single eigh per bond."""

    def test_gram_chain_matches_svd_rounding(self):
        from ttnx.solvers.round_scan import tt_round_gram

        A, u, RA, dims, u_rks, masks_big = _setup()
        big = matvec_padded(pack_op(A, RA), pack_tt(u, 4))
        big_rks = [min(a * b, RA * 4) for a, b in zip(A.ranks, u_rks)]
        out_rks = round_masks(big_rks, 4, dims)
        masks_out = rank_masks(out_rks, 4)
        ys = tt_round_scan(big, masks_big, 4, masks_out, method="svd")
        yg = tt_round_gram(big, 4, masks_out)
        assert np.allclose(padded_to_vec(yg), padded_to_vec(ys), atol=1e-10)

    def test_gram_chain_vmap_takes_xla_path(self):
        """`jax.vmap` of tt_round_gram (batched CN steps): the rounded
        chains must represent the same vectors as the per-problem loop."""
        from ttnx.solvers.round_scan import tt_round_gram

        A, u, RA, dims, u_rks, masks_big = _setup()
        big = matvec_padded(pack_op(A, RA).astype(jnp.float32),
                            pack_tt(u, 4).astype(jnp.float32))
        big_b = jnp.stack([big, 1.5 * big, 0.5 * big])
        big_rks = [min(a * b, RA * 4) for a, b in zip(A.ranks, u_rks)]
        masks_out = rank_masks(round_masks(big_rks, 4, dims), 4,
                               dtype=jnp.float32)
        out_v = jax.vmap(lambda y: tt_round_gram(y, 4, masks_out))(big_b)
        for i in range(3):
            # the represented vector is gauge-invariant: internal eigh sign
            # flips cancel between the isometry and the carried transfer
            ref = padded_to_vec(tt_round_gram(big_b[i], 4, masks_out))
            got = padded_to_vec(out_v[i])
            rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
            assert rel < 1e-4, (i, rel)

    def test_gram_chain_rank_deficient(self):
        from ttnx.solvers.round_scan import tt_round_gram

        d = 7
        A = add_op(id_tto(d),
                   scale_op(0.05, toeplitz_to_qtto(2.0, -1.0, -1.0, d)))
        u = orthogonalize(qtt_sin(d), 0)
        RA = max(A.ranks)
        rmax = 6
        dims = (2,) * d
        u_rks = r_and_d_to_rks(u.ranks, dims, rmax=rmax)
        big = matvec_padded(pack_op(A, RA), pack_tt(u, rmax))
        big_rks = [min(a * b, RA * rmax) for a, b in zip(A.ranks, u_rks)]
        out_rks = round_masks(big_rks, rmax, dims)
        masks_out = rank_masks(out_rks, rmax)
        yg = tt_round_gram(big, rmax, masks_out)
        got = padded_to_vec(yg)
        assert np.all(np.isfinite(got))
        ref = vec(tt_round(matvec(A, u), max_bond=rmax))
        assert np.allclose(got, ref, atol=1e-10)

    def test_gram_chain_complex_xla_path(self):
        from ttnx.solvers.round_scan import tt_round_gram

        A, u, RA, dims, u_rks, masks_big = _setup()
        big = matvec_padded(pack_op(A.astype(jnp.complex128), RA),
                            pack_tt(u.astype(jnp.complex128), 4))
        big = big * jnp.exp(0.3j)
        big_rks = [min(a * b, RA * 4) for a, b in zip(A.ranks, u_rks)]
        out_rks = round_masks(big_rks, 4, dims)
        masks_out = rank_masks(out_rks, 4)
        ys = tt_round_scan(big, masks_big, 4, masks_out, method="svd")
        yg = tt_round_gram(big, 4, masks_out)
        assert np.allclose(padded_to_vec(yg), padded_to_vec(ys), atol=1e-10)

    def test_cn_step_gram_chain_machine_precision(self):
        d, rmax = 8, 8
        h_grid = 1.0 / (2 ** d + 1)
        A = (-1.0 / h_grid ** 2) * toeplitz_to_qtto(2.0, -1.0, -1.0, d)
        step_fn, pack, unpack = make_cn_step(
            A, 1e-7, rmax=rmax, dims=(2,) * d,
            u_rks=(1,) + (rmax,) * (d - 1) + (1,), sweep_count=3,
            round_method="gram_chain")
        u0 = qtt_sin(d, a=h_grid, b=1 - h_grid)
        u = pack(u0)
        for _ in range(5):
            u = step_fn(u)
        lam1 = (2 - 2 * np.cos(np.pi / (2 ** d + 1))) / h_grid ** 2
        got = vec(unpack(u))
        expect = vec(u0) * np.exp(-lam1 * 5e-7)
        rel = np.linalg.norm(got - expect) / np.linalg.norm(expect)
        assert rel < 1e-12
