"""MALS (modified ALS): two-site sweeps with bond-adaptive rank truncation.

Reference: TensorTrainNumerics.jl src/solvers/mals.jl. The formulation reuses
the symmetric three-leg environments of :mod:`ttnx.solvers.als`; each two-site
local operator is a single einsum chain. Rank adaptation uses the reference's
relative discarded-weight criterion (mals.jl:42-56).
"""

from __future__ import annotations

import math
import time

import numpy as np
import jax.numpy as jnp

from ttnx.core.algebra import matvec, norm, sub
from ttnx.core.canonical import orthogonalize
from ttnx.core.tt import TTOperator, TTVector
from ttnx.solvers.als import (
    _ones_env,
    _ones_env2,
    init_right_envs,
    init_right_envs_b,
    update_left_env,
    update_left_env_b,
    update_right_env,
    update_right_env_b,
)

__all__ = ["mals_linsolve", "mals_eigsolve", "sv_trunc_count"]


def sv_trunc_count(s: np.ndarray, tol: float) -> int:
    """Number of singular values kept by the relative discarded-weight rule:
    drop the largest trailing block whose squared weight stays strictly below
    ``tol * ||s||^2`` (/root/reference/src/solvers/mals.jl:42-56)."""
    if tol == 0.0:
        return s.size
    norm2 = float((s ** 2).sum())
    tails = np.cumsum(s[::-1] ** 2)  # tails[k-1] = sum of smallest k squares
    discard = int(np.searchsorted(tails, tol * norm2, side="left"))
    return max(s.size - discard, 1)


def _local2_matrix(L, Ai, Aj, R):
    """Dense two-site operator ``K[(a,i,j,c),(b,I,J,d)]``
    (reference K_full_mals mals.jl:148-157)."""
    k = jnp.einsum("aWb,WiIw,wjJv,cvd->aijcbIJd", L, Ai, Aj, R, optimize=True)
    m = k.shape[0] * k.shape[1] * k.shape[2] * k.shape[3]
    return k.reshape(m, m)


def _local2_rhs(Lb, bi, bj, Rb):
    return jnp.einsum("au,uiv,vjw,cw->aijc", Lb, bi, bj, Rb, optimize=True)


def _split_right(V, tol, rmax):
    """SVD split of the two-site solution moving right: site i left-orthogonal,
    S*Vt absorbed right (reference right_core_move_mals mals.jl:121-146)."""
    rl, n1, n2, rr = V.shape
    u, s, vt = jnp.linalg.svd(V.reshape(rl * n1, n2 * rr), full_matrices=False)
    keep = min(sv_trunc_count(np.asarray(s), tol), rmax)
    ci = u[:, :keep].reshape(rl, n1, keep)
    cj = (s[:keep, None] * vt[:keep, :]).reshape(keep, n2, rr)
    return ci, cj


def _split_left(V, tol, rmax):
    """(reference left_core_move_mals mals.jl:94-119)"""
    rl, n1, n2, rr = V.shape
    u, s, vt = jnp.linalg.svd(V.reshape(rl * n1, n2 * rr), full_matrices=False)
    keep = min(sv_trunc_count(np.asarray(s), tol), rmax)
    ci = (u[:, :keep] * s[None, :keep]).reshape(rl, n1, keep)
    cj = vt[:keep, :].reshape(keep, n2, rr)
    return ci, cj


def _default_rmax(dims) -> int:
    return int(round(math.sqrt(float(np.prod(dims)))))


def mals_linsolve(A: TTOperator, b: TTVector, x0: TTVector, tol: float = 1e-12,
                  rmax: int | None = None, return_info: bool = False,
                  config=None, telemetry=None):
    """Solve ``A x = b`` with one forward + one backward two-site sweep, bond
    ranks adapting to ``tol`` under the ``rmax`` cap
    (reference mals_linsolve /root/reference/src/solvers/mals.jl:240-309).

    ``config`` (:class:`ttnx.config.MALSConfig`) overrides the option
    defaults; ``telemetry`` collects residual/rank history and wall time."""
    if config is not None:
        tol = config.tol
        rmax = config.rmax
        return_info = config.return_info
    t_start = time.perf_counter()
    d = A.N
    if rmax is None:
        rmax = _default_rmax(x0.dims)
    x = orthogonalize(x0, 0)
    dt = jnp.result_type(A.dtype, b.dtype, x.dtype)
    x = x.astype(dt) if x.dtype != dt else x
    A = A.astype(dt) if A.dtype != dt else A
    b = b.astype(dt) if b.dtype != dt else b
    cores = list(x.cores)

    R = init_right_envs(x, A)
    Rb = init_right_envs_b(x, b)
    L = [None] * (d + 1)
    L[0] = _ones_env(dt)
    Lb = [None] * (d + 1)
    Lb[0] = _ones_env2(dt)

    for i in range(d - 1):  # forward half sweep
        K = _local2_matrix(L[i], A.cores[i], A.cores[i + 1], R[i + 2])
        pb = _local2_rhs(Lb[i], b.cores[i], b.cores[i + 1], Rb[i + 2])
        V = jnp.linalg.solve(K, pb.reshape(-1)).reshape(pb.shape)
        cores[i], cores[i + 1] = _split_right(V, tol, rmax)
        L[i + 1] = update_left_env(L[i], cores[i], A.cores[i])
        Lb[i + 1] = update_left_env_b(Lb[i], cores[i], b.cores[i])
        if telemetry is not None:
            telemetry.local_solves += 1
            telemetry.record_sweep(max_rank=max(TTVector(cores).ranks))

    for i in range(d - 2, -1, -1):  # backward half sweep
        K = _local2_matrix(L[i], A.cores[i], A.cores[i + 1], R[i + 2])
        pb = _local2_rhs(Lb[i], b.cores[i], b.cores[i + 1], Rb[i + 2])
        V = jnp.linalg.solve(K, pb.reshape(-1)).reshape(pb.shape)
        cores[i], cores[i + 1] = _split_left(V, tol, rmax)
        R[i + 1] = update_right_env(R[i + 2], cores[i + 1], A.cores[i + 1])
        Rb[i + 1] = update_right_env_b(Rb[i + 2], cores[i + 1], b.cores[i + 1])
        if telemetry is not None:
            telemetry.local_solves += 1
            telemetry.record_sweep(max_rank=max(TTVector(cores).ranks))

    out = TTVector(cores)
    if telemetry is not None:
        res = float(norm(sub(matvec(A, out), b)) / jnp.maximum(
            norm(b), jnp.finfo(dt).eps))
        telemetry.record_sweep(residual=res)
        telemetry.wall_seconds += time.perf_counter() - t_start
    if return_info:
        res = float(norm(sub(matvec(A, out), b)) / jnp.maximum(
            norm(b), jnp.finfo(dt).eps))
        return out, {"residual": res}
    return out


def _local2_eigmin(L, Ai, Aj, R, v0, it_solver=False, itslv_thresh=256,
                   maxiter=200, tol=1e-8):
    """Two-site smallest eigenpair (reference K_eigmin_mals mals.jl:171-218)."""
    shape = v0.shape
    m = int(np.prod(shape))
    K = _local2_matrix(L, Ai, Aj, R)
    K = 0.5 * (K + K.conj().T)
    if (it_solver or m > itslv_thresh) and m > 4:
        from jax.experimental.sparse.linalg import lobpcg_standard

        if jnp.issubdtype(v0.dtype, jnp.complexfloating):
            # real symmetric embedding [[A,-B],[B,A]] of K = A + iB (same as
            # ttnx.solvers.als._local_eigmin; reference LOBPCG is complex-
            # native, /root/reference/src/solvers/mals.jl:171-218)
            Kr = jnp.block([[K.real, -K.imag], [K.imag, K.real]])
            w0 = jnp.concatenate([v0.reshape(m).real, v0.reshape(m).imag])
            sigma = jnp.linalg.norm(Kr, ord=1)
            shifted = sigma * jnp.eye(2 * m, dtype=Kr.dtype) - Kr
            theta, U, _ = lobpcg_standard(shifted, w0[:, None], m=maxiter,
                                          tol=tol)
            x = U[:m, 0] + 1j * U[m:, 0]
            x = x / jnp.linalg.norm(x)
            return ((sigma - theta[0]).astype(v0.real.dtype),
                    x.astype(v0.dtype).reshape(shape))
        sigma = jnp.linalg.norm(K, ord=1)
        shifted = sigma * jnp.eye(m, dtype=K.dtype) - K
        theta, U, _ = lobpcg_standard(shifted, v0.reshape(m, 1), m=maxiter,
                                      tol=tol)
        return sigma - theta[0], U[:, 0].reshape(shape)
    w, U = jnp.linalg.eigh(K)
    return w[0], U[:, 0].reshape(shape)


def mals_eigsolve(A: TTOperator, x0: TTVector, tol: float = 1e-12,
                  sweep_schedule=None, rmax_schedule=None,
                  it_solver: bool = False, linsolv_maxiter: int = 200,
                  linsolv_tol: float | None = None, itslv_thresh: int = 256,
                  telemetry=None):
    """Smallest eigenpair by two-site MALS with bond-adaptive ranks; returns
    ``(E, x, r_hist)`` (reference mals_eigsolve
    /root/reference/src/solvers/mals.jl:335-425)."""
    if sweep_schedule is None:
        sweep_schedule = [2]
    if rmax_schedule is None:
        rmax_schedule = [_default_rmax(x0.dims)]
    if len(rmax_schedule) != len(sweep_schedule):
        raise ValueError("Sweep schedule error")
    if linsolv_tol is None:
        linsolv_tol = max(math.sqrt(tol), 1e-8)

    t_start = time.perf_counter()
    d = A.N
    x = orthogonalize(x0, 0)
    dt = jnp.result_type(A.dtype, x.dtype)
    x = x.astype(dt) if x.dtype != dt else x
    A = A.astype(dt) if A.dtype != dt else A
    cores = list(x.cores)
    E: list[float] = []
    r_hist: list[int] = []

    R = init_right_envs(x, A)
    L = [None] * (d + 1)
    L[0] = _ones_env(dt)

    def guess(i):
        return jnp.einsum("anb,bmc->anmc", cores[i], cores[i + 1])

    nsweeps = 0
    i_schedule = 0
    while i_schedule < len(sweep_schedule):
        nsweeps += 1
        if nsweeps == sweep_schedule[i_schedule]:
            i_schedule += 1
            if i_schedule >= len(sweep_schedule):
                if telemetry is not None:
                    telemetry.wall_seconds += time.perf_counter() - t_start
                return np.asarray(E), TTVector(cores), np.asarray(r_hist)
        rmax = rmax_schedule[i_schedule]

        for i in range(d - 1):  # forward
            lam, V = _local2_eigmin(L[i], A.cores[i], A.cores[i + 1], R[i + 2],
                                    guess(i), it_solver=it_solver,
                                    itslv_thresh=itslv_thresh,
                                    maxiter=linsolv_maxiter, tol=linsolv_tol)
            E.append(float(jnp.real(lam)))
            cores[i], cores[i + 1] = _split_right(V, tol, rmax)
            r_hist.append(max(TTVector(cores).ranks))
            if telemetry is not None:
                telemetry.local_solves += 1
                telemetry.record_sweep(energy=E[-1], max_rank=r_hist[-1])
            L[i + 1] = update_left_env(L[i], cores[i], A.cores[i])

        for i in range(d - 2, -1, -1):  # backward
            lam, V = _local2_eigmin(L[i], A.cores[i], A.cores[i + 1], R[i + 2],
                                    guess(i), it_solver=it_solver,
                                    itslv_thresh=itslv_thresh,
                                    maxiter=linsolv_maxiter, tol=linsolv_tol)
            E.append(float(jnp.real(lam)))
            cores[i], cores[i + 1] = _split_left(V, tol, rmax)
            r_hist.append(max(TTVector(cores).ranks))
            if telemetry is not None:
                telemetry.local_solves += 1
                telemetry.record_sweep(energy=E[-1], max_rank=r_hist[-1])
            R[i + 1] = update_right_env(R[i + 2], cores[i + 1], A.cores[i + 1])

    if telemetry is not None:
        telemetry.wall_seconds += time.perf_counter() - t_start
    return np.asarray(E), TTVector(cores), np.asarray(r_hist)
