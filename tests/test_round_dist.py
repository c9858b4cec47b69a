"""Distributed (tp-sharded) TT rounding on the 8-device virtual CPU mesh:
parity with the single-device gram rounding / eager tt_round, sharding
layout preservation, and the tp-sharded CN step (SURVEY §2.9 distributed
SVD/QR panel obligation)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import ttnx
from ttnx import qtt_sin, toeplitz_to_qtto, ttv_to_tensor
from ttnx.core.algebra import add_op, matvec, scale_op
from ttnx.core.canonical import orthogonalize, tt_round
from ttnx.core.tt import id_tto, r_and_d_to_rks
from ttnx.parallel.batch import make_mesh
from ttnx.parallel.round_dist import (gram_round_dist, make_cn_step_dist,
                                      shard_chain)
from ttnx.solvers.als_scan import pack_op, pack_tt, rank_masks, unpack_tt
from ttnx.solvers.round_scan import matvec_padded, round_masks, tt_round_scan


def _problem(d=8, rmax=8):
    A = add_op(id_tto(d),
               scale_op(0.05, toeplitz_to_qtto(2.0, -1.0, -1.0, d)))
    u = orthogonalize(qtt_sin(d), 0)
    RA = max(A.ranks)
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
    return A, u, big, masks_big, out_rks, masks_out, rmax, dims


class TestGramRoundDist:
    def test_matches_eager_round_tensor(self):
        A, u, big, masks_big, out_rks, masks_out, rmax, dims = _problem()
        mesh = make_mesh(dp=1, tp=8)
        y_sh = shard_chain(big, mesh, "tp")
        assert y_sh.sharding.spec == P(None, None, None, "tp")
        with mesh:
            got = jax.jit(lambda y: gram_round_dist(
                y, masks_big, rmax, masks_out, mesh))(y_sh)
        v_got = np.asarray(ttv_to_tensor(unpack_tt(got, out_rks))).reshape(-1)
        v_ref = np.asarray(ttv_to_tensor(
            tt_round(matvec(A, u), max_bond=rmax))).reshape(-1)
        rel = np.linalg.norm(v_got - v_ref) / np.linalg.norm(v_ref)
        assert rel < 1e-10, rel

    def test_device_count_independent(self):
        # tp=2 and tp=8 must agree on the rounded TENSOR (gauge may differ
        # from single-device eigh order, but the represented state may not)
        _, _, big, masks_big, out_rks, masks_out, rmax, dims = _problem()
        vals = []
        for tp in (2, 8):
            mesh = make_mesh(dp=8 // tp, tp=tp)
            y_sh = shard_chain(big, mesh, "tp")
            with mesh:
                got = jax.jit(lambda y, m=mesh: gram_round_dist(
                    y, masks_big, rmax, masks_out, m))(y_sh)
            vals.append(np.asarray(
                ttv_to_tensor(unpack_tt(got, out_rks))).reshape(-1))
        assert np.allclose(vals[0], vals[1], atol=1e-10)

    def test_rejects_indivisible_rank(self):
        _, _, big, masks_big, out_rks, masks_out, rmax, dims = _problem()
        mesh = make_mesh(dp=2, tp=4)
        bad = big[:, : big.shape[1] - 2]  # rank not divisible by 4
        with pytest.raises(ValueError):
            gram_round_dist(bad[:, :, :, : bad.shape[1]], masks_big, rmax,
                            masks_out, mesh)


class TestCNStepDist:
    def test_matches_single_device_cn(self):
        d, rmax = 8, 8
        h_grid = 1.0 / (2 ** d + 1)
        A = (-1.0 / h_grid ** 2) * toeplitz_to_qtto(2.0, -1.0, -1.0, d)
        u0 = qtt_sin(d, a=h_grid, b=1 - h_grid)
        u_rks = (1,) + (rmax,) * (d - 1) + (1,)
        mesh = make_mesh(dp=1, tp=8)
        from ttnx.solvers.round_scan import make_cn_step

        with mesh:
            sfd, packd, unpackd = make_cn_step_dist(
                A, 1e-7, rmax, (2,) * d, u_rks, mesh, sweep_count=3,
                force_tp=True)
            ud = packd(u0)
            for _ in range(3):
                ud = sfd(ud)
        sf, pack, unpack = make_cn_step(
            A, 1e-7, rmax=rmax, dims=(2,) * d, u_rks=u_rks, sweep_count=3,
            round_method="gram")
        u = pack(u0)
        for _ in range(3):
            u = sf(u)
        vd = np.asarray(ttv_to_tensor(unpackd(ud))).reshape(-1)
        v = np.asarray(ttv_to_tensor(unpack(u))).reshape(-1)
        assert np.linalg.norm(vd - v) / np.linalg.norm(v) < 1e-12


class TestGramChainDist:
    """Distributed Gram-chain rounding (the Amdahl-free tp formulation):
    parity with the single-device tt_round_gram on the virtual mesh."""

    def _chain(self, d=5, rmax=3):
        from ttnx import id_tto, qtt_sin, toeplitz_to_qtto
        from ttnx.core.algebra import add_op, scale_op
        from ttnx.core.canonical import orthogonalize
        from ttnx.core.tt import r_and_d_to_rks
        from ttnx.solvers.round_scan import matvec_padded, round_masks
        from ttnx.solvers.als_scan import pack_op, pack_tt, rank_masks

        A = add_op(id_tto(d),
                   scale_op(0.1, toeplitz_to_qtto(-2.0, 1.0, 1.0, d)))
        u = orthogonalize(qtt_sin(d), 0)
        RA = max(A.ranks)
        dims = (2,) * d
        u_rks = r_and_d_to_rks((1,) + (rmax,) * (d - 1) + (1,), dims,
                               rmax=rmax)
        big = matvec_padded(pack_op(A, RA), pack_tt(u, rmax))
        out_rks = round_masks(
            [min(a * b, RA * rmax) for a, b in zip(A.ranks, u_rks)],
            rmax, dims)
        masks_out = rank_masks(out_rks, rmax)
        return big, rmax, masks_out

    @pytest.mark.parametrize("tp", [2, 4])
    def test_matches_single_device(self, tp):
        from ttnx.parallel.batch import make_mesh
        from ttnx.parallel.round_dist import gram_chain_round_dist
        from ttnx.solvers.round_scan import tt_round_gram

        big, rmax, masks_out = self._chain()
        ref = tt_round_gram(big, rmax, masks_out)
        mesh = make_mesh(dp=8 // tp, tp=tp)
        with mesh:
            got = gram_chain_round_dist(big, rmax, masks_out, mesh)
        # gauge-free comparison: both are left-canonical with identical
        # eigh-based gauges, so the stacks should agree directly
        assert np.allclose(np.asarray(got), np.asarray(ref), atol=1e-10)

    def test_indivisible_rank_raises(self):
        from ttnx.parallel.batch import make_mesh
        from ttnx.parallel.round_dist import gram_chain_round_dist

        big, rmax, masks_out = self._chain(d=5, rmax=3)  # R = 4*3 = 12
        mesh = make_mesh(dp=1, tp=8)  # 12 % 8 != 0
        with pytest.raises(ValueError):
            with mesh:
                gram_chain_round_dist(big, rmax, masks_out, mesh)


def test_cn_step_dist_gram_chain_matches_single_device():
    """make_cn_step_dist(round_method='gram_chain', force_tp=True) matches
    the single-device gram_chain CN step stack-for-stack (same gauges)."""
    import ttnx
    from ttnx.parallel.batch import make_mesh
    from ttnx.parallel.round_dist import make_cn_step_dist
    from ttnx.solvers.round_scan import make_cn_step

    d, rmax = 6, 2
    hg = 1.0 / (2 ** d + 1)
    A = (-1.0 / hg ** 2) * ttnx.toeplitz_to_qtto(2.0, -1.0, -1.0, d)
    u_rks = (1,) + (rmax,) * (d - 1) + (1,)
    u0 = ttnx.qtt_sin(d, a=hg, b=1 - hg)
    mesh = make_mesh(dp=4, tp=2)
    with mesh:
        sfd, packd, _ = make_cn_step_dist(
            A, 1e-7, rmax, (2,) * d, u_rks, mesh, sweep_count=2,
            force_tp=True, round_method="gram_chain")
        ud = sfd(packd(u0))
    sf, pack, _ = make_cn_step(
        A, 1e-7, rmax=rmax, dims=(2,) * d, u_rks=u_rks, sweep_count=2,
        round_method="gram_chain")
    us = sf(pack(u0))
    assert float(jnp.max(jnp.abs(ud - us))) < 1e-8


class TestPipelinedPairRounding:
    """Pair-pipelined tp rounding (collective/compute overlap structure):
    must equal two independent gram_chain_round_dist
    calls on the virtual mesh."""

    def test_pair_matches_two_singles(self, key):
        import ttnx
        from ttnx.parallel.batch import make_mesh
        from ttnx.parallel.round_dist import (gram_chain_round_dist,
                                              gram_chain_round_dist_pair,
                                              shard_chain)
        from ttnx.solvers.als_scan import pack_tt, rank_masks
        from ttnx.solvers.round_scan import round_masks

        # small shapes: the tp=4 d=6 R=16 form compiled 49 s on the CPU
        # mesh (suite budget); tp=2 exercises the same interleaved
        # collective structure (the dryrun runs the pair kernel too)
        d, R, R_out = 5, 8, 4
        k1, k2 = jax.random.split(key)
        ys = []
        for kk in (k1, k2):
            x = ttnx.rand_tt(kk, (2,) * d, rmax=R, normalise=True)
            ys.append(pack_tt(x, R))
        y_pair = jnp.stack(ys)
        out_rks = round_masks([1] + [R] * (d - 1) + [1], R_out, (2,) * d)
        masks_out = rank_masks(out_rks, R_out)
        mesh = make_mesh(dp=1, tp=2, devices=jax.devices()[:2])
        with mesh:
            got = gram_chain_round_dist_pair(
                jax.device_put(y_pair), R_out, masks_out, mesh)
            refs = [gram_chain_round_dist(shard_chain(ys[q], mesh), R_out,
                                          masks_out, mesh)
                    for q in range(2)]
        for q in range(2):
            assert np.allclose(np.asarray(got[q]), np.asarray(refs[q]),
                               atol=1e-12), q
