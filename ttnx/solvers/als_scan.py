"""Scan-based padded-rank ALS — the jitted/batched/shardable solver path.

This is the jitted formulation of :func:`ttnx.solvers.als.als_linsolve`
(reference semantics: /root/reference/src/solvers/als.jl:161-225), designed per
the padded-rank discipline:

* Cores are stacked dense arrays ``x: f[d, R, n, R]`` padded to a uniform
  ``rmax``; TT ranks are *static* per problem and enter only through 0/1
  masks baked in at trace time. Truncation/feasibility never changes buffer
  shapes, so one compiled program serves the whole solve.
* Environments are carried through ``lax.scan`` over the site axis; every
  sweep is three scans (right-env build, forward solve, backward solve) with
  all per-site contractions expressed as single einsums.
* The whole solver is a pure jittable function of stacked arrays — ``vmap``
  over a leading problem axis gives continuous batching of independent QTT
  solves, and the batch/rank axes can be sharded over a device mesh
  (see ttnx.parallel).

Padding invariant: every padded region of every array is exactly zero; the
local operator gets an identity block on the padded diagonal so the dense
solve stays well-posed and returns zeros there.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ttnx.core.canonical import orthogonalize
from ttnx.core.tt import TTOperator, TTVector, r_and_d_to_rks

__all__ = [
    "pack_tt",
    "pack_op",
    "unpack_tt",
    "rank_masks",
    "als_sweeps",
    "als_linsolve_scan",
    "als_eigsolve_sweeps",
    "als_eigsolve_scan",
]


# ---------------------------------------------------------------------------
# Packing between list-of-cores and stacked padded arrays
# ---------------------------------------------------------------------------


def rank_masks(rks, R: int, dtype=jnp.float64):
    """0/1 masks ``[d+1, R]`` for a static rank vector."""
    rks = list(rks)
    m = np.zeros((len(rks), R))
    for i, r in enumerate(rks):
        m[i, :r] = 1.0
    return jnp.asarray(m, dtype=dtype)


def pack_tt(x: TTVector, R: int):
    """Stack TT cores into ``[d, R, n, R]`` (zero padding)."""
    d = x.N
    n = x.dims[0]
    assert all(m == n for m in x.dims), "padded packing needs uniform dims"
    out = np.zeros((d, R, n, R), dtype=np.asarray(x.cores[0]).dtype)
    for i, c in enumerate(x.cores):
        rl, _, rr = c.shape
        out[i, :rl, :, :rr] = np.asarray(c)
    return jnp.asarray(out)


def pack_op(A: TTOperator, RA: int):
    """Stack MPO cores into ``[d, RA, n, n, RA]`` (zero padding)."""
    d = A.N
    n = A.dims[0]
    out = np.zeros((d, RA, n, n, RA), dtype=np.asarray(A.cores[0]).dtype)
    for i, c in enumerate(A.cores):
        rl, _, _, rr = c.shape
        out[i, :rl, :, :, :rr] = np.asarray(c)
    return jnp.asarray(out)


def unpack_tt(stack, rks) -> TTVector:
    """Slice the active blocks back out into a list-of-cores TT."""
    cores = []
    d = stack.shape[0]
    for i in range(d):
        cores.append(stack[i, : rks[i], :, : rks[i + 1]])
    return TTVector(cores)


def _boundary_env(R, RA, dtype):
    e = jnp.zeros((R, RA, R), dtype=dtype)
    return e.at[0, 0, 0].set(1.0)


def _boundary_env_b(R, Rb, dtype):
    e = jnp.zeros((R, Rb), dtype=dtype)
    return e.at[0, 0].set(1.0)


# ---------------------------------------------------------------------------
# One ALS sweep as three lax.scans
# ---------------------------------------------------------------------------


def _right_env_stack(x, A, b, mask_r):
    """Backward scan building all right environments.

    Returns ``Renv[i] = env of sites i..d-1`` stacked as ``[d+1, R, RA, R]``
    (and the b-env ``[d+1, R, Rb]``).
    """
    d, R, n, _ = x.shape
    RA = A.shape[1]
    Rb = b.shape[1]
    dt = x.dtype
    init = (_boundary_env(R, RA, dt), _boundary_env_b(R, Rb, dt))

    def step(carry, inp):
        Renv, Rb_env = carry
        xc, Ac, bc, mr = inp
        xc = xc * mr[None, None, :]
        new = jnp.einsum("aip,Wijw,bjq,pwq->aWb", jnp.conj(xc), Ac, xc, Renv,
                         optimize=True)
        new_b = jnp.einsum("aip,uiv,pv->au", jnp.conj(xc), bc, Rb_env,
                           optimize=True)
        return (new, new_b), (new, new_b)

    (_, _), (envs, envs_b) = lax.scan(
        step, init, (x, A, b, mask_r), reverse=True)
    # envs[i] corresponds to env of sites i..d-1; append the boundary at d
    envs = jnp.concatenate([envs, init[0][None]], axis=0)
    envs_b = jnp.concatenate([envs_b, init[1][None]], axis=0)
    return envs, envs_b


def _local_solve_padded(L, Ac, Renv, Lb, bc, Rb_env, m_l, m_r, v0=None,
                        solver: str = "lu", cg_iters: int = 48):
    """Masked local solve. ``solver='lu'`` assembles the dense operator;
    ``solver='cg'`` runs fixed-iteration conjugate gradients with a
    matrix-free masked apply (SPD local operators only, e.g. implicit time
    stepping) — as one Triton kernel (:mod:`ttnx.kernels.cg_triton`) where
    :mod:`ttnx.kernels.dispatch` admits the shape and backend, as XLA
    elsewhere; ``solver='bicgstab'`` is the matrix-free non-symmetric
    analog of 'cg'."""
    R = L.shape[0]
    n = Ac.shape[1]
    M = R * n * R
    maskv3 = (m_l[:, None, None] * m_r[None, None, :]
              * jnp.ones((1, n, 1), dtype=m_l.dtype))
    rhs = jnp.einsum("au,uiv,cv->aic", Lb, bc, Rb_env,
                     optimize=True) * maskv3
    if solver == "cg":
        from ttnx.kernels.dispatch import use_triton_cg

        if use_triton_cg(L.dtype, R):
            from ttnx.kernels.cg_triton import cg_matfree_batched

            x0 = None if v0 is None else v0[None]
            return cg_matfree_batched(L[None], Ac, Renv[None], rhs[None],
                                      maskv3, x0, iters=cg_iters)[0]
    if solver in ("cg", "bicgstab"):
        def apply_k(v):
            out = jnp.einsum("aWb,WiJw,cwd,bJd->aic", L, Ac, Renv,
                             v * maskv3, optimize=True)
            return out * maskv3 + (1.0 - maskv3) * v

        if solver == "cg":
            if v0 is None:
                x = jnp.zeros_like(rhs)
                r = rhs
            else:
                x = v0 * maskv3
                r = rhs - apply_k(x)
            p = r
            rs = jnp.vdot(r, r)

            def body(_, state):
                x, r, p, rs = state
                ap = apply_k(p)
                denom = jnp.vdot(p, ap)
                alpha = jnp.where(jnp.abs(denom) > 0, rs / denom, 0.0)
                x = x + alpha * p
                r = r - alpha * ap
                rs_new = jnp.vdot(r, r)
                beta = jnp.where(jnp.abs(rs) > 0, rs_new / rs, 0.0)
                p = r + beta * p
                return (x, r, p, rs_new)

            x, _, _, _ = lax.fori_loop(0, cg_iters, body, (x, r, p, rs))
            return x

        # matrix-free BiCGStab (non-symmetric local operators: convection,
        # OU drift), with conjugated inner products for complex dtypes
        def safe_div(a, c):
            ok = jnp.abs(c) > 0
            return jnp.where(ok, a / jnp.where(ok, c, 1.0), 0.0)

        x = jnp.zeros_like(rhs)
        r = rhs
        rhat = rhs
        rho = jnp.vdot(rhat, r)
        p = r
        v = jnp.zeros_like(rhs)

        def body(_, state):
            x, r, p, v, rho = state
            v = apply_k(p)
            alpha = safe_div(rho, jnp.vdot(rhat, v))
            s = r - alpha * v
            t = apply_k(s)
            omega = safe_div(jnp.vdot(t, s), jnp.vdot(t, t))
            x = x + alpha * p + omega * s
            r = s - omega * t
            rho_new = jnp.vdot(rhat, r)
            beta = safe_div(rho_new, rho) * safe_div(alpha, omega)
            p = r + beta * (p - omega * v)
            return (x, r, p, v, rho_new)

        x, _, _, _, _ = lax.fori_loop(0, cg_iters, body, (x, r, p, v, rho))
        return x
    K, maskv = _assemble_K_padded(L, Ac, Renv, maskv3)
    V = jnp.linalg.solve(K, rhs.reshape(M))
    return V.reshape(R, n, R)


def _assemble_K_padded(L, Ac, Renv, maskv3):
    """Dense masked local operator: identity on the padded diagonal; a tiny
    ridge on the active diagonal keeps the solve finite when the state is
    rank-deficient relative to its mask (zero environment directions -> zero
    rows with zero rhs -> zero output)."""
    M = maskv3.size
    K = jnp.einsum("aWb,WiJw,cwd->aicbJd", L, Ac, Renv,
                   optimize=True).reshape(M, M)
    maskv = maskv3.reshape(M)
    K = (K * maskv[:, None] * maskv[None, :] + jnp.diag(1.0 - maskv)
         + 1e-100 * jnp.diag(maskv))
    return K, maskv


def polar_orth(m, iters: int = 14):
    """Matmul-only orthonormalization via quintic Newton–Schulz iteration for
    the polar factor: returns ``(q, r)`` with ``q`` having orthonormal columns
    spanning range(m) and ``m = q @ r`` (``r = q^H m``, not triangular).

    A QR alternative made of pure matmuls. Zero (padded)
    columns stay exactly zero. The quintic coefficients (3.4445, -4.7750,
    2.0315) inflate small singular values far faster than the cubic
    iteration; a few cubic steps then polish toward machine precision.

    CAVEAT: like every fixed-iteration polynomial method this produces only
    LOOSE orthogonality in directions with singular values below ~1e-6 of
    the norm — fine for optimizer-style updates, NOT for precision TT
    orthogonalization of near-rank-deficient cores. Default paths use QR;
    select ``orth='polar'`` only for throughput experiments.
    """
    k = m.shape[1]
    scale = jnp.sqrt(jnp.sum(jnp.abs(m) ** 2)) + 1e-30
    y = m / scale
    eye = jnp.eye(k, dtype=m.dtype)

    def quintic(_, y):
        z = y.conj().T @ y
        zy = 3.4445 * eye - 4.7750 * z + 2.0315 * (z @ z)
        return y @ zy

    def cubic(_, y):
        z = y.conj().T @ y
        return 0.5 * y @ (3.0 * eye - z)

    y = lax.fori_loop(0, iters, quintic, y)
    y = lax.fori_loop(0, 8, cubic, y)
    r = y.conj().T @ m
    return y, r


def _forward_half_sweep(x, A, b, Renvs, Rb_envs, masks, solver="lu",
                        orth="qr", cg_iters=48):
    """Solve sites 0..d-2 moving right; returns new cores and the pending
    triangular factor for the last site."""
    d, R, n, _ = x.shape
    dt = x.dtype
    RA = A.shape[1]
    Rb = b.shape[1]
    L0 = _boundary_env(R, RA, dt)
    Lb0 = _boundary_env_b(R, Rb, dt)
    T0 = jnp.zeros((R, R), dtype=dt).at[0, 0].set(1.0)

    def step(carry, inp):
        L, Lb, T = carry
        Ac, bc, Renv, Rb_env, m_l, m_r, xc = inp
        # warm start: the CURRENT iterate's core = T @ x_old[k]; halves
        # the CG iterations at equal residual
        warm = jnp.einsum("ab,bnc->anc", T, xc)
        V = _local_solve_padded(L, Ac, Renv, Lb, bc, Rb_env, m_l, m_r,
                                v0=warm, solver=solver, cg_iters=cg_iters)
        if orth == "polar":
            q, r = polar_orth(V.reshape(R * n, R))
        else:
            q, r = jnp.linalg.qr(V.reshape(R * n, R))
        q = q * m_r[None, :]
        r = r * m_r[:, None]
        core = q.reshape(R, n, R)
        L_new = jnp.einsum("aic,aWb,Wijw,bjd->cwd", jnp.conj(core), L, Ac,
                           core, optimize=True)
        Lb_new = jnp.einsum("aip,au,uiv->pv", jnp.conj(core), Lb, bc,
                            optimize=True)
        return (L_new, Lb_new, r), core

    inputs = (A[:-1], b[:-1], Renvs[1:d], Rb_envs[1:d],
              masks[:-2], masks[1:-1], x[:-1])
    (L, Lb, T), new_cores = lax.scan(step, (L0, Lb0, T0), inputs)
    last = jnp.einsum("ab,bnc->anc", T, x[d - 1])
    x_new = jnp.concatenate([new_cores, last[None]], axis=0)
    return x_new


def _backward_half_sweep(x, A, b, Lenvs, Lb_envs, masks, solver="lu",
                         orth="qr", cg_iters=48):
    """Solve sites d-1..1 moving left; site 0 absorbs the final factor."""
    d, R, n, _ = x.shape
    dt = x.dtype
    RA = A.shape[1]
    Rb = b.shape[1]
    R0 = _boundary_env(R, RA, dt)
    Rb0 = _boundary_env_b(R, Rb, dt)
    T0 = jnp.zeros((R, R), dtype=dt).at[0, 0].set(1.0)

    def step(carry, inp):
        Renv, Rb_env, T = carry
        Ac, bc, Lenv, Lb_env, m_l, m_r, xc = inp
        # warm start: the CURRENT iterate's core = x_mid[k] @ T
        warm = jnp.einsum("anb,bc->anc", xc, T)
        V = _local_solve_padded(Lenv, Ac, Renv, Lb_env, bc, Rb_env, m_l, m_r,
                                v0=warm, solver=solver, cg_iters=cg_iters)
        if orth == "polar":
            qt, rt = polar_orth(V.reshape(R, n * R).T)
        else:
            qt, rt = jnp.linalg.qr(V.reshape(R, n * R).T)
        q = (qt.T * 1.0).reshape(R, n, R) * m_l[:, None, None]
        t = rt.T * m_l[None, :]
        core = q
        R_new = jnp.einsum("aip,Wijw,bjq,pwq->aWb", jnp.conj(core), Ac, core,
                           Renv, optimize=True)
        Rb_new = jnp.einsum("aip,uiv,pv->au", jnp.conj(core), bc, Rb_env,
                            optimize=True)
        return (R_new, Rb_new, t), core

    inputs = (A[1:], b[1:], Lenvs[1:d], Lb_envs[1:d], masks[1:-1], masks[2:],
              x[1:])
    (Renv, Rb_env, T), new_cores = lax.scan(
        step, (R0, Rb0, T0), inputs, reverse=True)
    first = jnp.einsum("anb,bc->anc", x[0], T)
    x_new = jnp.concatenate([first[None], new_cores], axis=0)
    return x_new


def _left_env_stack(x, A, b, mask_r):
    """Forward scan of left environments from current (left-orthogonal) cores;
    ``Lenv[i]`` covers sites 0..i-1. Stacked ``[d+1, R, RA, R]``."""
    d, R, n, _ = x.shape
    RA = A.shape[1]
    Rb = b.shape[1]
    dt = x.dtype
    init = (_boundary_env(R, RA, dt), _boundary_env_b(R, Rb, dt))

    def step(carry, inp):
        L, Lb = carry
        xc, Ac, bc, mr = inp
        xc = xc * mr[None, None, :]
        L_new = jnp.einsum("aic,aWb,Wijw,bjd->cwd", jnp.conj(xc), L, Ac, xc,
                           optimize=True)
        Lb_new = jnp.einsum("aip,au,uiv->pv", jnp.conj(xc), Lb, bc,
                            optimize=True)
        return (L_new, Lb_new), (L_new, Lb_new)

    (_, _), (envs, envs_b) = lax.scan(step, init, (x, A, b, mask_r))
    envs = jnp.concatenate([init[0][None], envs], axis=0)
    envs_b = jnp.concatenate([init[1][None], envs_b], axis=0)
    return envs, envs_b


@partial(jax.jit, static_argnames=("sweep_count", "solver", "orth",
                                   "cg_iters"))
def als_sweeps(A_stack, b_stack, x_stack, masks, sweep_count: int = 2,
               solver: str = "lu", orth: str = "qr", cg_iters: int = 48):
    """Run ``sweep_count`` ALS half-sweeps (reference counting semantics:
    2 = forward + backward) as one compiled XLA program."""
    if solver not in ("lu", "cg", "bicgstab"):
        raise ValueError(
            f"solver must be 'lu', 'cg' or 'bicgstab', got {solver!r}")
    if orth not in ("qr", "polar"):
        raise ValueError(f"orth must be 'qr' or 'polar', got {orth!r}")
    x = x_stack
    half = 0
    while half < sweep_count:
        Renvs, Rb_envs = _right_env_stack(x, A_stack, b_stack, masks[1:])
        x = _forward_half_sweep(x, A_stack, b_stack, Renvs, Rb_envs, masks,
                                solver=solver, orth=orth, cg_iters=cg_iters)
        half += 1
        if half >= sweep_count:
            break
        Lenvs, Lb_envs = _left_env_stack(x, A_stack, b_stack, masks[1:])
        x = _backward_half_sweep(x, A_stack, b_stack, Lenvs, Lb_envs, masks,
                                 solver=solver, orth=orth, cg_iters=cg_iters)
        half += 1
    return x


def _local_eig_padded(L, Ac, Renv, m_l, m_r):
    """Smallest eigenpair of the masked local operator. Padded directions get
    a diagonal just above the spectral range — a huge constant (1e12) would
    cost ~|pad|*eps of eigh accuracy and break the variational bound."""
    R = L.shape[0]
    n = Ac.shape[1]
    M = R * n * R
    K = jnp.einsum("aWb,WiJw,cwd->aicbJd", L, Ac, Renv,
                   optimize=True).reshape(M, M)
    maskv = (m_l[:, None, None] * m_r[None, None, :]
             * jnp.ones((1, n, 1), dtype=m_l.dtype)).reshape(M)
    Km = K * maskv[:, None] * maskv[None, :]
    pad = jnp.linalg.norm(Km) + 1.0  # > lambda_max of the active block
    K = Km + jnp.diag(pad * (1.0 - maskv))
    K = 0.5 * (K + K.conj().T)
    w, U = jnp.linalg.eigh(K)
    return w[0], U[:, 0].reshape(R, n, R)


def _forward_eig_half_sweep(x, A, Renvs, masks):
    d, R, n, _ = x.shape
    dt = x.dtype
    RA = A.shape[1]
    L0 = _boundary_env(R, RA, dt)
    T0 = jnp.zeros((R, R), dtype=dt).at[0, 0].set(1.0)

    def step(carry, inp):
        L, _T = carry
        Ac, Renv, m_l, m_r = inp
        lam, V = _local_eig_padded(L, Ac, Renv, m_l, m_r)
        q, r = jnp.linalg.qr(V.reshape(R * n, R))
        q = q * m_r[None, :]
        r = r * m_r[:, None]
        core = q.reshape(R, n, R)
        L_new = jnp.einsum("aic,aWb,Wijw,bjd->cwd", jnp.conj(core), L, Ac,
                           core, optimize=True)
        return (L_new, r), (core, lam)

    inputs = (A[:-1], Renvs[1:d], masks[:-2], masks[1:-1])
    (L, T), (new_cores, lams) = lax.scan(step, (L0, T0), inputs)
    last = jnp.einsum("ab,bnc->anc", T, x[d - 1])
    return jnp.concatenate([new_cores, last[None]], axis=0), lams


def _backward_eig_half_sweep(x, A, Lenvs, masks):
    d, R, n, _ = x.shape
    dt = x.dtype
    RA = A.shape[1]
    R0 = _boundary_env(R, RA, dt)
    T0 = jnp.zeros((R, R), dtype=dt).at[0, 0].set(1.0)

    def step(carry, inp):
        Renv, _T = carry
        Ac, Lenv, m_l, m_r = inp
        lam, V = _local_eig_padded(Lenv, Ac, Renv, m_l, m_r)
        qt, rt = jnp.linalg.qr(V.reshape(R, n * R).T)
        core = qt.T.reshape(R, n, R) * m_l[:, None, None]
        t = rt.T * m_l[None, :]
        R_new = jnp.einsum("aip,Wijw,bjq,pwq->aWb", jnp.conj(core), Ac, core,
                           Renv, optimize=True)
        return (R_new, t), (core, lam)

    inputs = (A[1:], Lenvs[1:d], masks[1:-1], masks[2:])
    (Renv, T), (new_cores, lams) = lax.scan(step, (R0, T0), inputs,
                                            reverse=True)
    first = jnp.einsum("anb,bc->anc", x[0], T)
    return jnp.concatenate([first[None], new_cores], axis=0), lams


def _right_env_stack_A(x, A, mask_r):
    d, R, n, _ = x.shape
    RA = A.shape[1]
    dt = x.dtype
    init = _boundary_env(R, RA, dt)

    def step(carry, inp):
        xc, Ac, mr = inp
        xc = xc * mr[None, None, :]
        new = jnp.einsum("aip,Wijw,bjq,pwq->aWb", jnp.conj(xc), Ac, xc, carry,
                         optimize=True)
        return new, new

    _, envs = lax.scan(step, init, (x, A, mask_r), reverse=True)
    return jnp.concatenate([envs, init[None]], axis=0)


def _left_env_stack_A(x, A, mask_r):
    d, R, n, _ = x.shape
    RA = A.shape[1]
    dt = x.dtype
    init = _boundary_env(R, RA, dt)

    def step(carry, inp):
        xc, Ac, mr = inp
        xc = xc * mr[None, None, :]
        new = jnp.einsum("aic,aWb,Wijw,bjd->cwd", jnp.conj(xc), carry, Ac, xc,
                         optimize=True)
        return new, new

    _, envs = lax.scan(step, init, (x, A, mask_r))
    return jnp.concatenate([init[None], envs], axis=0)


@partial(jax.jit, static_argnames=("n_sweeps",))
def als_eigsolve_sweeps(A_stack, x_stack, masks, n_sweeps: int = 2):
    """Jitted fixed-rank ALS eigensolver: ``n_sweeps`` full (forward +
    backward) sweeps; returns ``(x_stack, energies)`` with the per-microstep
    eigenvalue history (scan outputs replacing the reference's push!,
    /root/reference/src/solvers/als.jl:305,315)."""
    x = x_stack
    all_lams = []
    for _ in range(n_sweeps):
        Renvs = _right_env_stack_A(x, A_stack, masks[1:])
        x, lams_f = _forward_eig_half_sweep(x, A_stack, Renvs, masks)
        Lenvs = _left_env_stack_A(x, A_stack, masks[1:])
        x, lams_b = _backward_eig_half_sweep(x, A_stack, Lenvs, masks)
        all_lams.append(jnp.concatenate([lams_f, lams_b[::-1]]))
    return x, jnp.concatenate(all_lams)


def als_eigsolve_scan(A: TTOperator, x0: TTVector, n_sweeps: int = 2,
                      rmax: int | None = None):
    """Drop-in jitted fixed-rank ALS eigensolve; returns ``(E, x)`` like the
    eager :func:`ttnx.solvers.als.als_eigsolve` (single rank stage)."""
    x = orthogonalize(x0, 0)
    rks = x.ranks
    if rmax is None:
        rmax = max(max(rks), 2)
    dt = jnp.result_type(A.dtype, x.dtype)
    A_stack = pack_op(A.astype(dt), max(A.ranks))
    x_stack = pack_tt(x.astype(dt), rmax)
    real_dt = jnp.zeros((), dt).real.dtype
    masks = rank_masks(rks, rmax, dtype=real_dt)
    out, lams = als_eigsolve_sweeps(A_stack, x_stack, masks, n_sweeps)
    return np.asarray(jnp.real(lams)), unpack_tt(out, rks)


def als_linsolve_scan(A: TTOperator, b: TTVector, x0: TTVector,
                      sweep_count: int = 2, rmax: int | None = None):
    """Drop-in scan-based ALS linear solve: pack, run the jitted sweeps,
    unpack. Ranks are those of ``x0`` (feasibility-clamped), like the eager
    ALS."""
    x = orthogonalize(x0, 0)
    rks = x.ranks
    if rmax is None:
        rmax = max(max(rks), 2)
    dt = jnp.result_type(A.dtype, b.dtype, x.dtype)
    A_stack = pack_op(A.astype(dt), max(A.ranks))
    b_stack = pack_tt(b.astype(dt), max(b.ranks))
    x_stack = pack_tt(x.astype(dt), rmax)
    real_dt = jnp.zeros((), dt).real.dtype
    masks = rank_masks(rks, rmax, dtype=real_dt)
    out = als_sweeps(A_stack, b_stack, x_stack, masks, sweep_count)
    return unpack_tt(out, rks)
