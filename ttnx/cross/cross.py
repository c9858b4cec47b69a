"""TT-cross black-box approximation: MaxVol, Greedy, and DMRG-cross
algorithms plus Gauss–Legendre TT quadrature.

Reference: /root/reference/src/tt_cross_interpolation.jl. Host-driven control
flow (ranks and pivots are data-dependent); the parallel work is the *batched*
black-box evaluations ``f(coords: (m, N)) -> (m,)`` — on a device, ``f`` is a
jitted function over large coordinate batches.

Config dataclasses replace the reference's ``Ref`` globals
(tt_cross_interpolation.jl:8-12); randomness is controlled by an explicit
``seed`` instead of a global RNG.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np
import jax.numpy as jnp

from ttnx.core.tt import TTVector
from ttnx.cross.maxvol import maxvol

__all__ = [
    "MaxVolPivot",
    "RandomPivot",
    "MaxVol",
    "Greedy",
    "DMRGCross",
    "tt_cross",
    "tt_integrate",
    "gauss_legendre",
]

CROSS_MAXITER = 50
CROSS_TOL = 1e-10
CROSS_RMAX = 500
CROSS_KICKRANK = 5
MAXVOL_TOL = 1.05


@dataclass(frozen=True)
class MaxVolPivot:
    """(reference MaxVolPivot tt_cross_interpolation.jl:14-21)"""
    tol: float = MAXVOL_TOL
    maxiter: int = 100


@dataclass(frozen=True)
class RandomPivot:
    """(reference RandomPivot tt_cross_interpolation.jl:23-30)"""
    nsamples: int = 1000
    seed: int | None = None


@dataclass(frozen=True)
class MaxVol:
    """Alternating maxvol cross (reference MaxVol tt_cross_interpolation.jl:32-50)."""
    maxiter: int = CROSS_MAXITER
    tol: float = CROSS_TOL
    rmax: int = CROSS_RMAX
    kickrank: int | None = CROSS_KICKRANK
    verbose: bool = False
    pivot: MaxVolPivot = field(default_factory=MaxVolPivot)


@dataclass(frozen=True)
class Greedy:
    """Greedy residual-pivot cross (reference Greedy tt_cross_interpolation.jl:52-70)."""
    maxiter: int = CROSS_MAXITER
    tol: float = CROSS_TOL
    rmax: int = CROSS_RMAX
    verbose: bool = False
    nsamples: int = 1000
    pivot: RandomPivot = field(default_factory=RandomPivot)


@dataclass(frozen=True)
class DMRGCross:
    """Two-site superblock cross (reference DMRG tt_cross_interpolation.jl:72-90).

    Named ``DMRGCross`` to avoid clashing with the DMRG sweep solvers; exported
    also as ``ttnx.cross.DMRG`` for reference-name parity.
    """
    maxiter: int = CROSS_MAXITER
    tol: float = CROSS_TOL
    rmax: int = CROSS_RMAX
    kickrank: int | None = CROSS_KICKRANK
    verbose: bool = False
    pivot: MaxVolPivot = field(default_factory=MaxVolPivot)


DMRG = DMRGCross  # reference export name (tt_cross module scope)


# ---------------------------------------------------------------------------
# Shared helpers
# ---------------------------------------------------------------------------


def _normalize_domain(domain):
    if isinstance(domain, tuple) or (
            isinstance(domain, (list, np.ndarray))
            and len(domain) > 0 and np.isscalar(domain[0])):
        return [np.arange(1.0, float(d) + 1.0) for d in domain]
    # complex coordinate grids are first-class (reference complex-domain
    # support, test_tt_cross_interpolation.jl:214-241)
    return [np.asarray(d) if np.iscomplexobj(d)
            else np.asarray(d, dtype=float) for d in domain]


def _cap_ranks(Rs, Is, rmax):
    """Feasibility clamp of the rank vector
    (reference _cap_ranks! tt_cross_interpolation.jl:106-115)."""
    N = len(Is)
    Rs = list(Rs)
    for n in range(1, N):
        Rs[n] = min(Rs[n - 1] * Is[n - 1], Rs[n], Is[n] * Rs[n + 1], rmax)
    for n in range(N - 2, -1, -1):
        Rs[n + 1] = min(Rs[n] * Is[n], Rs[n + 1], Is[n + 1] * Rs[n + 2], rmax)
    return Rs


def _evaluate_on_domain(f, domain, indices: np.ndarray) -> np.ndarray:
    """Map 0-based index rows to coordinates and batch-evaluate ``f``
    (reference tt_cross_interpolation.jl:117-126 — the only external boundary)."""
    coords = np.stack(
        [np.asarray(domain[d])[indices[:, d]] for d in range(len(domain))],
        axis=1)
    return np.asarray(f(coords)).reshape(-1)


class _CachedEvaluator:
    """Memoizing wrapper for the black-box ``f``: every distinct grid index
    is evaluated exactly once. This gives the greedy sweep the evaluation
    economy of the reference's incremental rank-1 cross updates
    (tt_cross_interpolation.jl:419-476) without maintaining mid_inv_L/U:
    re-requested fibers and cross matrices hit the cache, and only the new
    pivot row/column slices reach ``f``.
    """

    def __init__(self, f, domain):
        self._f = f
        self._domain = domain
        self._cache: dict = {}
        self.n_evals = 0

    def __call__(self, indices: np.ndarray) -> np.ndarray:
        keys = list(map(tuple, np.asarray(indices, dtype=int)))
        miss = [k for k in set(keys) if k not in self._cache]
        if miss:
            vals = _evaluate_on_domain(
                self._f, self._domain, np.asarray(miss, dtype=int))
            self.n_evals += len(miss)
            self._cache.update(zip(miss, vals))
        return np.asarray([self._cache[k] for k in keys])


def _evaluate_tt(cores, indices: np.ndarray) -> np.ndarray:
    """Batched evaluation of a TT (cores in (r_l, n, r_r) layout) at index
    rows (reference _evaluate_tt tt_cross_interpolation.jl:128-142)."""
    n_points = indices.shape[0]
    state = np.ones((n_points, 1), dtype=np.asarray(cores[0]).dtype)
    for d, core in enumerate(cores):
        c = np.asarray(core)
        slices = c[:, indices[:, d], :]  # (r_l, m, r_r)
        state = np.einsum("pl,lpr->pr", state, slices)
    return state[:, 0]


def _svdtrunc_rel(a: np.ndarray, max_bond: int, truncerr: float):
    """Relative-tail-norm truncated SVD — intentionally different from the
    absolute-threshold rule in ttnx.core.canonical.svdtrunc (see reference
    comment tt_cross_interpolation.jl:144-148)."""
    u, s, vt = np.linalg.svd(a, full_matrices=False)
    r = s.size
    if truncerr > 0 and r > 0:
        nrm = np.linalg.norm(s)
        tails = np.sqrt(np.cumsum(s[::-1] ** 2))[::-1]  # tails[i] = |s[i:]|
        above = np.nonzero(tails > truncerr * nrm)[0]
        r = int(above[-1]) + 1 if above.size else 1
    r = max(1, min(r, max_bond))
    return u[:, :r], s[:r], vt[:r, :]


def _validation_set(rng, Is, val_size):
    return np.stack([rng.integers(0, Is[d], val_size) for d in range(len(Is))],
                    axis=1)


def _infer_value_dtype(f, domain):
    probe = np.zeros((1, len(domain)), dtype=int)
    return np.asarray(_evaluate_on_domain(f, domain, probe)).dtype


# ---------------------------------------------------------------------------
# MaxVol cross
# ---------------------------------------------------------------------------


def _fiber_indices(lset, rset, site_dim, N, j):
    """All (left multi-index, site index, right multi-index) combinations,
    C-order rows: left major, site middle, right minor
    (reference _build_fiber_indices tt_cross_interpolation.jl:168-181)."""
    rl = lset.shape[0]
    rr = rset.shape[0]
    n = site_dim
    out = np.empty((rl * n * rr, N), dtype=int)
    li = np.repeat(np.arange(rl), n * rr)
    si = np.tile(np.repeat(np.arange(n), rr), rl)
    ri = np.tile(np.arange(rr), rl * n)
    if lset.shape[1]:
        out[:, : j] = lset[li]
    out[:, j] = si
    if rset.shape[1]:
        out[:, j + 1:] = rset[ri]
    return out


def _maxvol_cross(f, domain, alg: MaxVol, ranks, val_size, seed):
    """(reference tt_cross MaxVol method tt_cross_interpolation.jl:189-317)"""
    N = len(domain)
    Is = [len(d) for d in domain]
    rng = np.random.default_rng(seed)
    dtype = _infer_value_dtype(f, domain)

    if isinstance(ranks, int):
        Rs = [1] + [ranks] * (N - 1) + [1]
    else:
        Rs = [1] + list(ranks) + [1]
    Rs = _cap_ranks(Rs, Is, alg.rmax)

    cores = [rng.standard_normal((Rs[n], Is[n], Rs[n + 1])).astype(dtype)
             for n in range(N)]

    lsets = [np.zeros((1, 0), dtype=int)] + [None] * (N - 1)
    rsets = [None] * (N - 1) + [np.zeros((1, 0), dtype=int)]
    for n in range(N - 1):
        rsets[n] = np.stack(
            [rng.integers(0, Is[c], Rs[n + 1]) for c in range(n + 1, N)],
            axis=1) if n + 1 < N else np.zeros((Rs[n + 1], 0), dtype=int)

    Xs_val = _validation_set(rng, Is, val_size)
    ys_val = _evaluate_on_domain(f, domain, Xs_val)
    norm_val = max(np.linalg.norm(ys_val), alg.tol)

    converged = False
    val_eps = np.inf
    for it in range(alg.maxiter):
        # L -> R: update lsets by maxvol pivots of the fiber unfolding
        for j in range(N - 1):
            idx = _fiber_indices(lsets[j], rsets[j], Is[j], N, j)
            V = _evaluate_on_domain(f, domain, idx).reshape(
                Rs[j] * Is[j], Rs[j + 1])
            q, _ = np.linalg.qr(V)
            piv = maxvol(q, alg.pivot.tol, alg.pivot.maxiter)
            G = q @ np.linalg.inv(q[piv])
            cores[j] = G.reshape(Rs[j], Is[j], len(piv)).astype(dtype)
            merged = np.concatenate(
                [lsets[j][piv // Is[j]], (piv % Is[j])[:, None]], axis=1)
            lsets[j + 1] = merged
            Rs[j + 1] = len(piv)

        # R -> L: update rsets
        for j in range(N - 1, 0, -1):
            idx = _fiber_indices(lsets[j], rsets[j], Is[j], N, j)
            V = _evaluate_on_domain(f, domain, idx).reshape(
                Rs[j], Is[j] * Rs[j + 1])
            q, _ = np.linalg.qr(V.T)
            piv = maxvol(q, alg.pivot.tol, alg.pivot.maxiter)
            G = q @ np.linalg.inv(q[piv])
            cores[j] = G.reshape(Is[j], Rs[j + 1], len(piv)).transpose(
                2, 0, 1).astype(dtype)
            merged = np.concatenate(
                [(piv // Rs[j + 1])[:, None], rsets[j][piv % Rs[j + 1]]],
                axis=1)
            rsets[j - 1] = merged
            Rs[j] = len(piv)

        idx = _fiber_indices(lsets[0], rsets[0], Is[0], N, 0)
        cores[0] = _evaluate_on_domain(f, domain, idx).reshape(
            1, Is[0], Rs[1]).astype(dtype)

        val_eps = np.linalg.norm(
            ys_val - _evaluate_tt(cores, Xs_val)) / norm_val
        if alg.verbose:
            print(f"MaxVol cross iter {it + 1}: eps={val_eps:.3e} "
                  f"max_rank={max(Rs)}")
        if val_eps < alg.tol:
            converged = True
            break

        if alg.kickrank is not None:
            newRs = list(Rs)
            for n in range(1, N):
                newRs[n] = min(newRs[n] + alg.kickrank, alg.rmax)
            newRs = _cap_ranks(newRs, Is, alg.rmax)
            for n in range(N - 1):
                grow = newRs[n + 1] - Rs[n + 1]
                if grow > 0 and n + 1 < N:
                    extra = np.stack(
                        [rng.integers(0, Is[c], grow)
                         for c in range(n + 1, N)], axis=1)
                    rsets[n] = np.concatenate([rsets[n], extra], axis=0)
            Rs = newRs

    if alg.verbose and not converged:
        print(f"MaxVol cross: max iterations reached, eps={val_eps:.3e}")
    return TTVector([jnp.asarray(c) for c in cores])


# ---------------------------------------------------------------------------
# DMRG cross
# ---------------------------------------------------------------------------


def _superblock_indices(Il, Ig, s1, s2, N, k):
    rl, rg = Il.shape[0], Ig.shape[0]
    total = rl * s1 * s2 * rg
    out = np.empty((total, N), dtype=int)
    a = np.repeat(np.arange(rl), s1 * s2 * rg)
    b = np.tile(np.repeat(np.arange(s1), s2 * rg), rl)
    c = np.tile(np.repeat(np.arange(s2), rg), rl * s1)
    d = np.tile(np.arange(rg), rl * s1 * s2)
    if Il.shape[1]:
        out[:, :k] = Il[a]
    out[:, k] = b
    out[:, k + 1] = c
    if Ig.shape[1]:
        out[:, k + 2:] = Ig[d]
    return out


def _dmrg_cross(f, domain, alg: DMRGCross, ranks, val_size, seed):
    """(reference tt_cross DMRG method tt_cross_interpolation.jl:562-658)"""
    N = len(domain)
    Is = [len(d) for d in domain]
    rng = np.random.default_rng(seed)
    dtype = _infer_value_dtype(f, domain)

    if N == 1:
        vals = np.asarray(f(np.asarray(domain[0]).reshape(-1, 1))).reshape(-1)
        return TTVector([jnp.asarray(vals.reshape(1, Is[0], 1))])

    if isinstance(ranks, int):
        Rs = [1] + [ranks] * (N - 1) + [1]
    else:
        Rs = [1] + list(ranks) + [1]
    Rs = _cap_ranks(Rs, Is, alg.rmax)

    I_l = [np.zeros((1, 0), dtype=int)] + [
        np.stack([rng.integers(0, Is[j], Rs[k]) for j in range(k)], axis=1)
        for k in range(1, N)]
    I_g = [np.stack([rng.integers(0, Is[k + 1 + j], Rs[k + 1])
                     for j in range(N - 1 - k)], axis=1)
           for k in range(N - 1)] + [np.zeros((1, 0), dtype=int)]

    cores = [rng.standard_normal((Rs[n], Is[n], Rs[n + 1])).astype(dtype)
             for n in range(N)]

    Xs_val = _validation_set(rng, Is, val_size)
    ys_val = _evaluate_on_domain(f, domain, Xs_val)
    norm_val = max(np.linalg.norm(ys_val), alg.tol)

    converged = False
    val_eps = np.inf
    for it in range(alg.maxiter):
        for k in range(N - 1):  # L -> R superblock sweep
            idx = _superblock_indices(I_l[k], I_g[k + 1], Is[k], Is[k + 1], N, k)
            sb = _evaluate_on_domain(f, domain, idx).reshape(
                I_l[k].shape[0], Is[k], Is[k + 1], I_g[k + 1].shape[0])
            rl, s1, s2, rg = sb.shape
            u, s, vt = _svdtrunc_rel(sb.reshape(rl * s1, s2 * rg),
                                     alg.rmax, alg.tol)
            r = s.size
            if k < N - 2:
                q, _ = np.linalg.qr(u)
                piv = maxvol(q, alg.pivot.tol, alg.pivot.maxiter)
                combined = np.concatenate(
                    [I_l[k][np.arange(rl * s1) // s1],
                     (np.arange(rl * s1) % s1)[:, None]], axis=1)
                I_l[k + 1] = combined[piv]
                Rs[k + 1] = len(piv)
                cores[k] = (q @ np.linalg.inv(q[piv])).reshape(
                    rl, s1, Rs[k + 1]).astype(dtype)
            else:
                cores[k] = u.reshape(rl, s1, r).astype(dtype)
                cores[k + 1] = (s[:, None] * vt).reshape(r, s2, rg).astype(dtype)
                Rs[k + 1] = r

        val_eps = np.linalg.norm(
            ys_val - _evaluate_tt(cores, Xs_val)) / norm_val
        if alg.verbose:
            print(f"DMRG cross sweep {2 * it + 1} (L->R): eps={val_eps:.3e} "
                  f"max_rank={max(Rs)}")
        if val_eps < alg.tol:
            converged = True
            break

        for k in range(N - 2, -1, -1):  # R -> L superblock sweep
            idx = _superblock_indices(I_l[k], I_g[k + 1], Is[k], Is[k + 1], N, k)
            sb = _evaluate_on_domain(f, domain, idx).reshape(
                I_l[k].shape[0], Is[k], Is[k + 1], I_g[k + 1].shape[0])
            rl, s1, s2, rg = sb.shape
            u, s, vt = _svdtrunc_rel(sb.reshape(rl * s1, s2 * rg),
                                     alg.rmax, alg.tol)
            r = s.size
            if k > 0:
                q, _ = np.linalg.qr(vt.conj().T)
                piv = maxvol(q, alg.pivot.tol, alg.pivot.maxiter)
                combined = np.concatenate(
                    [(np.arange(s2 * rg) // rg)[:, None],
                     I_g[k + 1][np.arange(s2 * rg) % rg]], axis=1)
                I_g[k] = combined[piv]
                Rs[k + 1] = len(piv)
                cores[k + 1] = (q @ np.linalg.inv(q[piv])).conj().T.reshape(
                    Rs[k + 1], s2, rg).astype(dtype)
            else:
                cores[k] = (u * s[None, :]).reshape(rl, s1, r).astype(dtype)
                cores[k + 1] = vt.reshape(r, s2, rg).astype(dtype)
                Rs[k + 1] = r

        val_eps = np.linalg.norm(
            ys_val - _evaluate_tt(cores, Xs_val)) / norm_val
        if alg.verbose:
            print(f"DMRG cross sweep {2 * it + 2} (R->L): eps={val_eps:.3e} "
                  f"max_rank={max(Rs)}")
        if val_eps < alg.tol:
            converged = True
            break

        if alg.kickrank is not None:
            # Random index enrichment between iterations. The reference only
            # enriches in the MaxVol method (tt_cross_interpolation.jl:297-310)
            # and its DMRG cross relies on lucky random initialization; here
            # the two-site superblock can lock at a deficient rank when every
            # nested pivot pins a degenerate slice (e.g. a zero of a factor),
            # so kickrank rows are appended to both nested sets — a documented
            # robustness improvement (docs/design.md).
            for k in range(1, N):
                grow = min(alg.kickrank, alg.rmax - I_l[k].shape[0])
                if grow > 0:
                    extra = np.stack(
                        [rng.integers(0, Is[j], grow) for j in range(k)],
                        axis=1)
                    I_l[k] = np.unique(
                        np.concatenate([I_l[k], extra], axis=0), axis=0)
            for k in range(N - 1):
                grow = min(alg.kickrank, alg.rmax - I_g[k].shape[0])
                if grow > 0:
                    extra = np.stack(
                        [rng.integers(0, Is[k + 1 + j], grow)
                         for j in range(N - 1 - k)], axis=1)
                    I_g[k] = np.unique(
                        np.concatenate([I_g[k], extra], axis=0), axis=0)

    if alg.verbose and not converged:
        print(f"DMRG cross: max iterations reached, eps={val_eps:.3e}")
    return TTVector([jnp.asarray(c) for c in cores])


# ---------------------------------------------------------------------------
# Greedy cross
# ---------------------------------------------------------------------------


def _merge_left(lset, n):
    """All (left multi-index, site index) rows, left-major."""
    rl = lset.shape[0]
    out = np.concatenate(
        [lset[np.repeat(np.arange(rl), n)],
         np.tile(np.arange(n), rl)[:, None]], axis=1)
    return out


def _merge_right(n, rset):
    """All (site index, right multi-index) rows, site-major."""
    rr = rset.shape[0]
    out = np.concatenate(
        [np.repeat(np.arange(n), rr)[:, None],
         rset[np.tile(np.arange(rr), n)]], axis=1)
    return out


def _greedy_cross(f, domain, alg: Greedy, val_size, seed):
    """Greedy residual-pivot cross with per-bond cross-matrix inverses and
    stall fallback to DMRG-cross (reference tt_cross Greedy method
    tt_cross_interpolation.jl:334-521; the rank-1 inverse updates are replaced
    by direct cross-matrix (pseudo)inverses for clarity at equal math)."""
    N = len(domain)
    Is = [len(d) for d in domain]
    seed_eff = alg.pivot.seed if alg.pivot.seed is not None else seed
    rng = np.random.default_rng(seed_eff)
    budget = min(alg.nsamples, alg.pivot.nsamples)
    ev = _CachedEvaluator(f, domain)

    # index sets per bond: Jl[i] (Rs[i], i), Jr[i] (Rs[i], N-i)
    Jl = [np.zeros((1, 0), dtype=int) for _ in range(N + 1)]
    Jr = [np.zeros((1, 0), dtype=int) for _ in range(N + 1)]
    Rs = [1] * (N + 1)

    # rank-1 initialization at max-|domain| pivots (reference lines 372-381);
    # at this point every index set has one row, so the candidate row count
    # equals Is[i] and the domain argmax is a valid row.
    for i in range(N - 1):
        cand = _merge_left(Jl[i], Is[i])
        row = int(np.argmax(np.abs(np.asarray(domain[i]))))
        Jl[i + 1] = cand[[row]]
    for i in range(N - 1, 0, -1):
        cand = _merge_right(Is[i], Jr[i + 1])
        row = int(np.argmax(np.abs(np.asarray(domain[i]))))
        Jr[i] = cand[[row]]

    def fiber(i):
        """y_i = f on (Jl[i] x site x Jr[i+1]) as (Rs[i], Is[i], Rs[i+1])."""
        idx = _fiber_indices(Jl[i], Jr[i + 1], Is[i], N, i)
        return ev(idx).reshape(
            Jl[i].shape[0], Is[i], Jr[i + 1].shape[0])

    # C_i^{-1} cache, keyed by bond: (rank, inverse). Pivot additions grow
    # the cross matrix by one bordered row/column, so the inverse is updated
    # by the Schur-complement block formula in O(r^2) instead of a fresh
    # O(r^3) pinv (the reference's rank-1 mid_inv_L/U updates,
    # tt_cross_interpolation.jl:448-470, recast as a direct inverse update).
    _cinv_cache = {}

    def _cross_matrix(i, rows, cols):
        idx = np.concatenate(
            [Jl[i][np.repeat(rows, len(cols))],
             Jr[i][np.tile(cols, len(rows))]], axis=1)
        return ev(idx).reshape(len(rows), len(cols))

    def cross_inv(i):
        """C_i^{-1} with C_i = f(Jl[i] x Jr[i]) at bond i."""
        r = Jl[i].shape[0]
        if Jl[i].shape[1] + Jr[i].shape[1] == 0:
            return np.ones((1, 1))
        cached = _cinv_cache.get(i)
        if cached is not None and cached[0] == r:
            return cached[1]
        if cached is not None and cached[0] == r - 1:
            # bordered update: C' = [[C, c], [b^T, g]] with known C^{-1}
            Ainv = cached[1]
            c = _cross_matrix(i, np.arange(r - 1), np.array([r - 1]))
            bT = _cross_matrix(i, np.array([r - 1]), np.arange(r - 1))
            g = _cross_matrix(i, np.array([r - 1]), np.array([r - 1]))
            u = Ainv @ c                       # (r-1, 1)
            vT = bT @ Ainv                     # (1, r-1)
            s = g[0, 0] - (bT @ u)[0, 0]       # Schur complement
            if abs(s) > 1e-13 * max(1.0, abs(g[0, 0])):
                inv = np.empty((r, r), dtype=np.result_type(Ainv, g))
                inv[:-1, :-1] = Ainv + (u @ vT) / s
                inv[:-1, -1:] = -u / s
                inv[-1:, :-1] = -vT / s
                inv[-1, -1] = 1.0 / s
                _cinv_cache[i] = (r, inv)
                return inv
            # near-singular Schur complement: fall through to dense pinv
        inv = np.linalg.pinv(_cross_matrix(i, np.arange(r), np.arange(r)))
        _cinv_cache[i] = (r, inv)
        return inv

    # pivot refinement by fiber argmax — avoids zero pivots when the domain
    # argmax lands on a zero of f (the reference's "zero-lock" fix,
    # tt_cross_interpolation.jl:383-417)
    for i in range(N - 1, 0, -1):
        y = fiber(i).reshape(Jl[i].shape[0], -1)  # cols = (site, right)
        best = int(np.argmax(np.abs(y[0])))
        Jr[i] = _merge_right(Is[i], Jr[i + 1])[[best]]
    for i in range(N - 1):
        y = fiber(i).reshape(-1, Jr[i + 1].shape[0])  # rows = (left, site)
        best = int(np.argmax(np.abs(y[:, 0])))
        Jl[i + 1] = _merge_left(Jl[i], Is[i])[[best]]

    Xs_val = _validation_set(rng, Is, val_size)
    ys_val = ev(Xs_val)
    norm_val = max(np.linalg.norm(ys_val), alg.tol)

    def assemble():
        cores = []
        for i in range(N):
            yi = fiber(i)
            r1 = Jr[i + 1].shape[0]
            if i < N - 1:
                yi = yi.reshape(-1, r1) @ cross_inv(i + 1)
            cores.append(yi.reshape(Jl[i].shape[0], Is[i], r1))
        return cores

    converged = False
    val_eps = np.inf
    for swp in range(alg.maxiter):
        max_dx = 0.0
        for i in range(N - 1):
            J1 = _merge_left(Jl[i], Is[i])       # rows for bond i+1 "rows"
            J2 = _merge_right(Is[i + 1], Jr[i + 2])  # cols for bond i+1
            n1, n2 = J1.shape[0], J2.shape[0]
            # complement of existing pivots
            def row_key(mat):
                return set(map(tuple, mat))
            used_rows = row_key(Jl[i + 1])
            used_cols = row_key(Jr[i + 1])
            cind1 = [p for p in range(n1) if tuple(J1[p]) not in used_rows]
            cind2 = [q for q in range(n2) if tuple(J2[q]) not in used_cols]
            if not cind1 or not cind2:
                continue
            testsz = min(len(cind1), len(cind2), budget)
            t1 = rng.choice(cind1, testsz)
            t2 = rng.choice(cind2, testsz)

            y1 = fiber(i).reshape(n1, Rs[i + 1])
            y2 = fiber(i + 1).reshape(Rs[i + 1], n2)
            Cinv = cross_inv(i + 1)
            e1 = y1 @ Cinv  # (n1, r)

            crt = ev(np.concatenate([J1[t1], J2[t2]], axis=1))
            approx = np.einsum("pr,rp->p", e1[t1], y2[:, t2])
            res = crt - approx
            maxy = max(np.max(np.abs(crt)), 1e-300)
            q_best = t2[int(np.argmax(np.abs(res)))]

            col_idx = np.concatenate(
                [J1[cind1], np.repeat(J2[[q_best]], len(cind1), axis=0)],
                axis=1)
            crt_col = ev(col_idx)
            res_col = crt_col - e1[cind1] @ y2[:, q_best]
            best_local = int(np.argmax(np.abs(res_col)))
            emax = np.abs(res_col[best_local])
            p_best = cind1[best_local]
            dx = emax / maxy
            max_dx = max(max_dx, dx)

            if dx > alg.tol and Rs[i + 1] < alg.rmax:
                Jl[i + 1] = np.concatenate([Jl[i + 1], J1[[p_best]]], axis=0)
                Jr[i + 1] = np.concatenate([Jr[i + 1], J2[[q_best]]], axis=0)
                Rs[i + 1] += 1

        cores = assemble()
        val_eps = np.linalg.norm(
            ys_val - _evaluate_tt(cores, Xs_val)) / norm_val
        if alg.verbose:
            print(f"Greedy cross sweep {swp + 1}: eps={val_eps:.3e} "
                  f"max_dx={max_dx:.3e} max_rank={max(Rs)}")
        if val_eps < alg.tol:
            converged = True
            break

    fallback_tol = max(np.sqrt(alg.tol), 10 * alg.tol)
    if not converged and (not np.isfinite(val_eps) or val_eps > fallback_tol):
        # stall fallback (reference tt_cross_interpolation.jl:512-518)
        if alg.verbose:
            print(f"Greedy cross stalled (eps={val_eps:.3e}); "
                  "retrying with DMRG cross")
        # the reference passes kickrank=nothing here (jl:516) and relies on
        # lucky random init; keep enrichment on so the fallback cannot inherit
        # the same degenerate-slice lock that stalled Greedy (docs/design.md)
        dmrg_alg = DMRGCross(maxiter=max(alg.maxiter, 10), tol=alg.tol,
                             rmax=alg.rmax, verbose=alg.verbose)
        return _dmrg_cross(f, domain, dmrg_alg, min(max(Rs), alg.rmax),
                           val_size, seed)

    return TTVector([jnp.asarray(c) for c in assemble()])


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def tt_cross(f: Callable, domain, alg=None, ranks=2, val_size: int = 1000,
             seed: int = 0) -> TTVector:
    """Black-box TT approximation of ``f`` on a product grid
    (reference tt_cross /root/reference/src/tt_cross_interpolation.jl:92-104).

    ``domain`` is either a list of per-dimension coordinate vectors or a
    dims tuple (then the grid is ``1..n`` per dimension). ``f`` is batched:
    it receives an ``(m, N)`` coordinate matrix and returns ``m`` values.
    """
    if alg is None:
        alg = MaxVol()
    dom = _normalize_domain(domain)
    if isinstance(alg, MaxVol):
        return _maxvol_cross(f, dom, alg, ranks, val_size, seed)
    if isinstance(alg, DMRGCross):
        return _dmrg_cross(f, dom, alg, ranks, val_size, seed)
    if isinstance(alg, Greedy):
        return _greedy_cross(f, dom, alg, val_size, seed)
    raise TypeError(f"Unknown cross algorithm: {alg!r}")


def gauss_legendre(n: int, a: float = -1.0, b: float = 1.0):
    """Gauss–Legendre nodes/weights by Golub–Welsch
    (reference _gauss_legendre tt_cross_interpolation.jl:695-700)."""
    import scipy.linalg

    k = np.arange(1, n)
    beta = k / np.sqrt(4.0 * k ** 2 - 1.0)
    lam, V = scipy.linalg.eigh_tridiagonal(np.zeros(n), beta)
    nodes = (b - a) / 2 * lam + (a + b) / 2
    weights = (b - a) * V[0, :] ** 2
    return nodes, weights


def tt_integrate(f: Callable, lower, upper=None, alg=None, nquad: int = 20,
                 **kwargs):
    """Gauss–Legendre TT quadrature: cross-approximate the integrand on the
    tensor quadrature grid, then contract with the weights
    (reference tt_integrate tt_cross_interpolation.jl:660-693)."""
    if alg is None:
        alg = MaxVol()
    if isinstance(lower, int) and upper is None:
        d = lower
        lower = np.zeros(d)
        upper = np.ones(d)
    lower = np.asarray(lower, dtype=float)
    upper = np.asarray(upper, dtype=float)
    if lower.shape != upper.shape:
        raise ValueError("lower and upper bounds must have the same length")
    d = lower.size
    nodes, weights = [], []
    for k in range(d):
        x, w = gauss_legendre(nquad, lower[k], upper[k])
        nodes.append(x)
        weights.append(w)
    tt = tt_cross(f, nodes, alg, **kwargs)
    result = np.ones(1)
    for k in range(d):
        core = np.asarray(tt.cores[k])
        contracted = np.einsum("i,lir->lr", weights[k], core)
        result = result @ contracted
    return float(result[0]) if np.isrealobj(result) else complex(result[0])
