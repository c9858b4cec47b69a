"""Device-resident TT-cross: the whole fixed-rank MaxVol sweep as ONE
jittable program (SURVEY §7.3's "fixed-size pivot
buffers + rank masks" design).

The host path (:func:`ttnx.cross.cross.tt_cross`) drives rank-adaptive
sweeps from NumPy — semantically complete, but every QR/maxvol/TT-eval runs
on the host cores. This module is the device path for *jittable* black
boxes: ranks are static (feasibility-clamped at trace time), pivot buffers
are fixed-size, the maxvol row-swap iteration is a ``lax.while_loop`` with
rank-1 updates, and the alternating sweep is a Python loop over sites
unrolled at trace time — so one compiled XLA program performs the entire
cross, and ``vmap`` over a parameter axis gives the batched cross parameter
sweep of BASELINE config 5 (no reference counterpart: the reference's cross
is single-problem host code, /root/reference/src/tt_cross_interpolation.jl:189-317).

The black box is an INDEX evaluator ``f_idx(indices: i32[m, N]) -> [m]``
(use :func:`index_evaluator` to wrap a coordinate function + domain grids).
Non-jittable ``f`` stays on the host path.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Sequence

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["maxvol_fixed", "evaluate_tt_indices", "index_evaluator",
           "maxvol_cross_device", "dmrg_cross_device", "tt_cross_device",
           "tt_cross_device_adaptive"]


def _svd_left(sb):
    """``(u, s, svt)`` with descending singular values and ``svt =
    diag(s) @ vt = u^H @ sb``."""
    u, s, vt = jnp.linalg.svd(sb, full_matrices=False)
    return u, s, s[:, None].astype(sb.dtype) * vt


def _svd_right(sb):
    """Mirror of :func:`_svd_left` for the R->L sweep: ``(v, s, us)``
    with ``v`` the orthonormal right singular vectors (columns) and
    ``us = u @ diag(s) = sb @ v``."""
    u, s, vt = jnp.linalg.svd(sb, full_matrices=False)
    return jnp.conj(vt).T, s, u * s[None, :].astype(sb.dtype)


@partial(jax.jit, static_argnames=("maxiter",))
def maxvol_fixed(a, tol: float = 1.05, maxiter: int = 100):
    """Jittable quasi-maxvol: row indices of an ``r x r`` dominant submatrix
    of the tall ``a (n, r)``. Same Goreinov–Tyrtyshnikov swap iteration as
    :func:`ttnx.cross.maxvol.maxvol`, with a fixed-size pivot buffer and a
    ``lax.while_loop`` (early exit when every |B| entry <= tol)."""
    n, r = a.shape
    if n <= r:
        return jnp.arange(n, dtype=jnp.int32)
    # LU partial-pivot initialization (rectangular LU: permutation rows)
    _, _, perm = lax.linalg.lu(a)
    rows = jnp.sort(perm[:r].astype(jnp.int32))
    # pinv-based start matrix: robust to a singular a[rows] (host path
    # catches LinAlgError -> pinv; jnp.linalg.solve would silently NaN)
    B = a @ jnp.linalg.pinv(a[rows])

    def cond(state):
        rows, B, k = state
        return jnp.logical_and(k < maxiter,
                               jnp.max(jnp.abs(B)) > tol)

    def body(state):
        rows, B, k = state
        flat = jnp.argmax(jnp.abs(B))
        i = (flat // r).astype(jnp.int32)
        j = (flat % r).astype(jnp.int32)
        bj = B[:, j]
        bi = B[i, :].at[j].add(-1.0)
        B = B - jnp.outer(bj, bi) / B[i, j]
        rows = rows.at[j].set(i)
        return rows, B, k + 1

    rows, _, _ = lax.while_loop(cond, body, (rows, B, jnp.int32(0)))
    return rows


def evaluate_tt_indices(cores, indices):
    """Jittable batched TT evaluation at index rows ``indices (m, N)`` for
    ``cores`` a list of ``(r_l, n, r_r)`` arrays (device analog of the host
    ``_evaluate_tt``; reference tt_cross_interpolation.jl:128-142)."""
    m = indices.shape[0]
    state = jnp.ones((m, 1), dtype=cores[0].dtype)
    for d, core in enumerate(cores):
        slices = jnp.take(core, indices[:, d], axis=1)   # (r_l, m, r_r)
        state = jnp.einsum("pl,lpr->pr", state, slices)
    return state[:, 0]


def index_evaluator(f, domain: Sequence, dtype=jnp.float64) -> Callable:
    """Wrap a jittable coordinate function ``f(coords (m, N)) -> (m,)`` and
    per-dimension grids into an index evaluator ``f_idx(indices) -> (m,)``."""
    grids = [jnp.asarray(g, dtype=dtype) for g in domain]

    def f_idx(indices):
        coords = jnp.stack(
            [jnp.take(grids[d], indices[:, d]) for d in range(len(grids))],
            axis=1)
        return f(coords)

    return f_idx


def _fiber_indices_jax(lset, rset, site_dim: int, j: int, N: int):
    """(rl * n * rr, N) index rows: left major, site middle, right minor —
    same C-order contract as the host `_fiber_indices`."""
    rl = lset.shape[0]
    rr = rset.shape[0]
    n = site_dim
    li = jnp.repeat(jnp.arange(rl, dtype=jnp.int32), n * rr)
    si = jnp.tile(jnp.repeat(jnp.arange(n, dtype=jnp.int32), rr), rl)
    ri = jnp.tile(jnp.arange(rr, dtype=jnp.int32), rl * n)
    parts = []
    if j > 0:
        parts.append(lset[li])
    parts.append(si[:, None])
    if N - j - 1 > 0:
        parts.append(rset[ri])
    return jnp.concatenate(parts, axis=1)


def _cap_ranks_static(Rs, Is, rmax):
    N = len(Is)
    Rs = list(Rs)
    for n in range(1, N):
        Rs[n] = min(Rs[n - 1] * Is[n - 1], Rs[n], Is[n] * Rs[n + 1], rmax)
    for n in range(N - 2, -1, -1):
        Rs[n + 1] = min(Rs[n] * Is[n], Rs[n + 1], Is[n + 1] * Rs[n + 2], rmax)
    return Rs


def maxvol_cross_device(f_idx, Is: Sequence[int], rank: int,
                        n_iters: int = 3, pivot_tol: float = 1.05,
                        pivot_maxiter: int = 100, dtype=jnp.float64,
                        n_val: int = 0):
    """The full fixed-rank alternating MaxVol cross as one jittable function.

    Returns ``fn(key) -> (cores, val_eps)``: ``cores`` the list of
    ``(R_j, I_j, R_{j+1})`` TT cores (static feasibility-clamped ranks),
    ``val_eps`` the per-iteration validation errors on ``n_val`` random
    points (shape ``(n_iters,)``; all-zero when ``n_val == 0``). Fixed trip
    count — no data-dependent convergence break (jit discipline); pick
    ``n_iters`` from the host path or telemetry. ``jax.vmap(fn)`` over keys
    (or over a closed-over parameter of ``f_idx``) batches independent
    crosses — the BASELINE config 5 parameter sweep.
    """
    Is = [int(i) for i in Is]
    N = len(Is)
    Rs = _cap_ranks_static([1] + [int(rank)] * (N - 1) + [1], Is, int(rank))

    def run(key):
        keys = jax.random.split(key, N + 1)
        # nested right index sets: rsets[j] (Rs[j+1], N-j-1)
        rsets = [None] * N
        for j in range(N - 1):
            cols = [jax.random.randint(keys[c], (Rs[j + 1],), 0, Is[c],
                                       dtype=jnp.int32)
                    for c in range(j + 1, N)]
            rsets[j] = jnp.stack(cols, axis=1)
        rsets[N - 1] = jnp.zeros((1, 0), dtype=jnp.int32)
        lsets = [jnp.zeros((1, 0), dtype=jnp.int32)] + [None] * (N - 1)
        cores = [None] * N
        if n_val:
            vkey = jax.random.split(keys[N], N)
            Xv = jnp.stack([jax.random.randint(vkey[d], (n_val,), 0, Is[d],
                                               dtype=jnp.int32)
                            for d in range(N)], axis=1)
            yv = f_idx(Xv)
        eps_hist = []

        for _ in range(n_iters):
            # L -> R: maxvol pivots of the left fiber unfolding
            for j in range(N - 1):
                idx = _fiber_indices_jax(lsets[j], rsets[j], Is[j], j, N)
                V = f_idx(idx).reshape(Rs[j] * Is[j], Rs[j + 1])
                q, _ = jnp.linalg.qr(V)
                piv = maxvol_fixed(q, pivot_tol, maxiter=pivot_maxiter)
                G = q @ jnp.linalg.inv(q[piv])
                cores[j] = G.reshape(Rs[j], Is[j], Rs[j + 1])
                lsets[j + 1] = jnp.concatenate(
                    [lsets[j][piv // Is[j]], (piv % Is[j])[:, None]], axis=1)
            # R -> L: mirrored
            for j in range(N - 1, 0, -1):
                idx = _fiber_indices_jax(lsets[j], rsets[j], Is[j], j, N)
                V = f_idx(idx).reshape(Rs[j], Is[j] * Rs[j + 1])
                q, _ = jnp.linalg.qr(V.T)
                piv = maxvol_fixed(q, pivot_tol, maxiter=pivot_maxiter)
                G = q @ jnp.linalg.inv(q[piv])
                cores[j] = jnp.transpose(
                    G.reshape(Is[j], Rs[j + 1], Rs[j]), (2, 0, 1))
                rsets[j - 1] = jnp.concatenate(
                    [(piv // Rs[j + 1])[:, None], rsets[j][piv % Rs[j + 1]]],
                    axis=1)
            idx = _fiber_indices_jax(lsets[0], rsets[0], Is[0], 0, N)
            cores[0] = f_idx(idx).reshape(1, Is[0], Rs[1])
            if n_val:
                yhat = evaluate_tt_indices(cores, Xv)
                eps_hist.append(jnp.linalg.norm(yv - yhat)
                                / jnp.maximum(jnp.linalg.norm(yv), 1e-300))
            else:
                eps_hist.append(jnp.zeros((), dtype=jnp.zeros(
                    (), dtype=dtype).real.dtype))
        return cores, jnp.stack(eps_hist)

    return run


def _superblock_indices_jax(Il, Ig, s1: int, s2: int, k: int, N: int):
    """(rl * s1 * s2 * rg, N) superblock index rows (C-order; same contract
    as the host `_superblock_indices`)."""
    rl = Il.shape[0]
    rg = Ig.shape[0]
    a = jnp.repeat(jnp.arange(rl, dtype=jnp.int32), s1 * s2 * rg)
    b = jnp.tile(jnp.repeat(jnp.arange(s1, dtype=jnp.int32), s2 * rg), rl)
    c = jnp.tile(jnp.repeat(jnp.arange(s2, dtype=jnp.int32), rg), rl * s1)
    d = jnp.tile(jnp.arange(rg, dtype=jnp.int32), rl * s1 * s2)
    parts = []
    if k > 0:
        parts.append(Il[a])
    parts.append(b[:, None])
    parts.append(c[:, None])
    if N - k - 2 > 0:
        parts.append(Ig[d])
    return jnp.concatenate(parts, axis=1)


def dmrg_cross_device(f_idx, Is: Sequence[int], rank: int,
                      n_iters: int = 3, pivot_tol: float = 1.05,
                      pivot_maxiter: int = 100, dtype=jnp.float64,
                      n_val: int = 0):
    """Fixed-rank two-site DMRG-cross as one jittable function (device twin
    of the host ``DMRGCross`` path, reference
    tt_cross_interpolation.jl:523-658): superblock sampling, truncated SVD
    to the STATIC target rank, maxvol pivots on the orthonormal factor,
    nested index-set updates — all inside jit; ``vmap`` batches parameter
    sweeps like :func:`maxvol_cross_device`. Returns ``fn(key) -> (cores,
    val_eps)``."""
    Is = [int(i) for i in Is]
    N = len(Is)
    if N < 2:
        raise ValueError("dmrg_cross_device needs N >= 2 dimensions")
    Rs = _cap_ranks_static([1] + [int(rank)] * (N - 1) + [1], Is, int(rank))

    def run(key):
        keys = jax.random.split(key, 2 * N + 1)
        # one key per (row-set, column): a shared per-k key would make every
        # column of an initial index row-set identical (constant tuples for
        # uniform dims -> rank-deficient first-sweep superblocks)
        Il = [jnp.zeros((1, 0), dtype=jnp.int32)] + [
            jnp.stack([jax.random.randint(jax.random.fold_in(keys[k], j),
                                          (Rs[k],), 0, Is[j],
                                          dtype=jnp.int32)
                       for j in range(k)], axis=1)
            for k in range(1, N)]
        Ig = [jnp.stack([jax.random.randint(
                  jax.random.fold_in(keys[N + k], j), (Rs[k + 1],), 0,
                  Is[k + 1 + j], dtype=jnp.int32)
                         for j in range(N - 1 - k)], axis=1)
              for k in range(N - 1)] + [jnp.zeros((1, 0), dtype=jnp.int32)]
        cores = [None] * N
        if n_val:
            vkey = jax.random.split(keys[2 * N], N)
            Xv = jnp.stack([jax.random.randint(vkey[d], (n_val,), 0, Is[d],
                                               dtype=jnp.int32)
                            for d in range(N)], axis=1)
            yv = f_idx(Xv)
        eps_hist = []

        def superblock(k):
            rl, rg = Rs[k], Rs[k + 2]
            idx = _superblock_indices_jax(Il[k], Ig[k + 1], Is[k],
                                          Is[k + 1], k, N)
            sb = f_idx(idx).reshape(rl * Is[k], Is[k + 1] * rg)
            return sb, rl, rg

        for _ in range(n_iters):
            for k in range(N - 1):  # L -> R superblock sweep
                sb, rl, rg = superblock(k)
                r = Rs[k + 1]
                u, s, _svt = _svd_left(sb)
                u_r = u[:, :r]
                if k < N - 2:
                    piv = maxvol_fixed(u_r, pivot_tol, maxiter=pivot_maxiter)
                    cores[k] = (u_r @ jnp.linalg.inv(u_r[piv])).reshape(
                        rl, Is[k], r)
                    rows = jnp.arange(rl * Is[k], dtype=jnp.int32)
                    combined = jnp.concatenate(
                        [Il[k][rows // Is[k]],
                         (rows % Is[k])[:, None]], axis=1)
                    Il[k + 1] = combined[piv]
                else:
                    cores[k] = u_r.reshape(rl, Is[k], r)
                    # exact projection of sb onto span(u_r)
                    cores[k + 1] = (jnp.conj(u_r).T @ sb).reshape(
                        r, Is[k + 1], rg)
            for k in range(N - 2, -1, -1):  # R -> L superblock sweep
                sb, rl, rg = superblock(k)
                r = Rs[k + 1]
                v, s, _us = _svd_right(sb)
                q = v[:, :r]                             # (s2*rg, r)
                if k > 0:
                    piv = maxvol_fixed(q, pivot_tol, maxiter=pivot_maxiter)
                    cores[k + 1] = jnp.conj(
                        q @ jnp.linalg.inv(q[piv])).T.reshape(
                            r, Is[k + 1], rg)
                    rows = jnp.arange(Is[k + 1] * rg, dtype=jnp.int32)
                    combined = jnp.concatenate(
                        [(rows // rg)[:, None], Ig[k + 1][rows % rg]],
                        axis=1)
                    Ig[k] = combined[piv]
                else:
                    # sb ~= (sb q) q^H: the projection onto span(q)
                    cores[k] = (sb @ q).reshape(rl, Is[k], r)
                    cores[k + 1] = jnp.conj(q).T.reshape(
                        r, Is[k + 1], rg)
            if n_val:
                yhat = evaluate_tt_indices(cores, Xv)
                eps_hist.append(jnp.linalg.norm(yv - yhat)
                                / jnp.maximum(jnp.linalg.norm(yv), 1e-300))
            else:
                eps_hist.append(jnp.zeros((), dtype=jnp.zeros(
                    (), dtype=dtype).real.dtype))
        return cores, jnp.stack(eps_hist)

    return run


def tt_cross_device(f, domain, rank: int, n_iters: int = 3,
                    pivot_tol: float = 1.05, dtype=jnp.float64,
                    n_val: int = 0, seed: int = 0, method: str = "maxvol"):
    """Convenience driver: jit + run the device cross (``method='maxvol'``
    alternating-fiber or ``'dmrg'`` two-site superblock) on coordinate
    grids with a jittable ``f``; returns ``(TTVector, val_eps)``."""
    from ttnx.core.tt import TTVector

    f_idx = index_evaluator(f, domain, dtype=dtype)
    Is = [len(np.asarray(g)) for g in domain]
    maker = {"maxvol": maxvol_cross_device,
             "dmrg": dmrg_cross_device}[method]
    run = jax.jit(maker(f_idx, Is, rank, n_iters=n_iters,
                        pivot_tol=pivot_tol, dtype=dtype, n_val=n_val))
    cores, eps = run(jax.random.PRNGKey(seed))
    return TTVector([jnp.asarray(c) for c in cores]), np.asarray(eps)


def tt_cross_device_adaptive(f, domain, tol: float = 1e-10,
                             rank_schedule=(2, 4, 8, 16), n_iters: int = 3,
                             n_val: int = 1000, seed: int = 0,
                             method: str = "maxvol", dtype=jnp.float64,
                             pivot_tol: float = 1.05):
    """Rank-adaptive device cross: a host loop over STATIC-rank jitted
    stages (the jit-discipline analog of the host path's kickrank growth —
    ranks are compile-time constants per stage, the validation eps decides
    whether to escalate). Each stage is one compiled program; stages with
    the same (shape, rank) hit the jit cache across calls. Returns
    ``(TTVector, eps, rank_used)``."""
    from ttnx.core.tt import TTVector

    f_idx = index_evaluator(f, domain, dtype=dtype)
    Is = [len(np.asarray(g)) for g in domain]
    maker = {"maxvol": maxvol_cross_device,
             "dmrg": dmrg_cross_device}[method]
    key = jax.random.PRNGKey(seed)
    cores = eps = None
    rank_used = None
    for rank in rank_schedule:
        run = jax.jit(maker(f_idx, Is, int(rank), n_iters=n_iters,
                            pivot_tol=pivot_tol, dtype=dtype, n_val=n_val))
        cores, eps = run(key)
        rank_used = int(rank)
        if float(eps[-1]) < tol:
            break
    return (TTVector([jnp.asarray(c) for c in cores]), np.asarray(eps),
            rank_used)
