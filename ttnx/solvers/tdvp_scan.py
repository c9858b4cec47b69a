"""Jitted 1-site TDVP: the whole symmetric sweep as lax.scans.

1-site TDVP preserves ranks, so the padded-rank discipline applies with
*static* masks and the full time step compiles to one XLA program —
`vmap` gives batched evolution of independent states (the config-4 workload).
Local exponentials use dense ``expm`` of the masked effective Hamiltonians
(padded diagonal = 0 ⇒ identity evolution on padding, which zero-padded
states never populate).

Reference semantics: /root/reference/src/solvers/tdvp.jl:45-203.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import jax.scipy.linalg
from jax import lax

from ttnx.core.canonical import orthogonalize
from ttnx.core.tt import TTOperator, TTVector
from ttnx.solvers.als_scan import (
    _boundary_env,
    pack_op,
    pack_tt,
    rank_masks,
    unpack_tt,
)

__all__ = ["tdvp1_step", "tdvp1_scan", "tdvp2_step", "tdvp2_scan"]


def _k1_masked(L, Ac, Renv, m_l, m_r):
    R = L.shape[0]
    n = Ac.shape[1]
    M = R * n * R
    K = jnp.einsum("aWb,WiJw,cwd->aicbJd", L, Ac, Renv,
                   optimize=True).reshape(M, M)
    maskv = (m_l[:, None, None] * m_r[None, None, :]
             * jnp.ones((1, n, 1), dtype=m_l.dtype)).reshape(M)
    return K * maskv[:, None] * maskv[None, :]


def _k0_masked(L, Renv, m):
    R = L.shape[0]
    K = jnp.einsum("aWb,cWd->acbd", L, Renv, optimize=True).reshape(R * R,
                                                                    R * R)
    maskv = (m[:, None] * m[None, :]).reshape(R * R)
    return K * maskv[:, None] * maskv[None, :]


def _expmv(K, t, v):
    return (jax.scipy.linalg.expm(t * K) @ v.reshape(-1)).reshape(v.shape)


def _k1_apply(L, Ac, Renv, m_l, m_r):
    """Matrix-free masked 1-site effective-Hamiltonian apply (never
    materializes the (RnR)^2 matrix; reference
    comparator: KrylovKit exponentiate matvecs,
    /root/reference/src/solvers/tdvp.jl:73-75)."""
    n = Ac.shape[1]
    maskv3 = (m_l[:, None, None] * m_r[None, None, :]
              * jnp.ones((1, n, 1), dtype=m_l.dtype))

    def apply(v):
        out = jnp.einsum("aWb,WiJw,cwd,bJd->aic", L, Ac, Renv, v * maskv3,
                         optimize=True)
        return out * maskv3

    return apply


def _k0_apply(L, Renv, m):
    mask2 = m[:, None] * m[None, :]

    def apply(C):
        out = jnp.einsum("aWb,cWd,bd->ac", L, Renv, C * mask2, optimize=True)
        return out * mask2

    return apply


def _k2_apply(L, Ai, Aj, Renv, m_l, m_r):
    n = Ai.shape[1]
    maskv4 = (m_l[:, None, None, None] * m_r[None, None, None, :]
              * jnp.ones((1, n, n, 1), dtype=m_l.dtype))

    def apply(v):
        out = jnp.einsum("aWb,WiIw,wjJv,cvd,bIJd->aijc", L, Ai, Aj, Renv,
                         v * maskv4, optimize=True)
        return out * maskv4

    return apply


def _lanczos_expmv(apply_fn, t, v, krylov_dim: int = 20):
    """``exp(t K) v`` for a HERMITIAN masked operator given only its apply —
    fixed-iteration Lanczos with two-pass full reorthogonalization (same
    pattern as :func:`ttnx.solvers.dmrg_scan._lanczos_eigmin`), so the jitted
    TDVP tier never materializes the (R n R)^2 local matrix. Breakdown
    (Krylov space exhausted, e.g. rank-deficient padded states) zeroes the
    offending beta, which exactly terminates the recurrence. Requires
    Hermitian H (like KrylovKit's Lanczos `exponentiate` in the reference);
    use ``expm='dense'`` for non-Hermitian generators."""
    shape = v.shape
    v0 = v.reshape(-1)
    N = v0.shape[0]
    nrm = jnp.linalg.norm(v0)
    nrm_safe = jnp.where(nrm > 0, nrm, 1.0)
    real_dt = nrm.dtype
    eps = jnp.finfo(real_dt).eps
    Q = jnp.zeros((krylov_dim, N), v0.dtype).at[0].set(v0 / nrm_safe)
    alphas = []
    betas = []
    scale = jnp.zeros((), real_dt)
    for j in range(krylov_dim):
        w = apply_fn(Q[j].reshape(shape)).reshape(-1)
        alpha = jnp.real(jnp.vdot(Q[j], w))
        alphas.append(alpha)
        scale = jnp.maximum(scale, jnp.abs(alpha))
        if j == krylov_dim - 1:
            break
        for _ in range(2):  # two-pass full reorthogonalization (2 matmuls)
            c = jnp.conj(Q) @ w           # rows > j are zero -> no-op
            w = w - Q.T @ c
        beta = jnp.linalg.norm(w)
        scale = jnp.maximum(scale, beta)
        ok = beta > 64.0 * eps * scale
        betas.append(jnp.where(ok, beta, 0.0))
        qn = jnp.where(ok, 1.0, 0.0) * w / jnp.where(ok, beta, 1.0)
        Q = Q.at[j + 1].set(qn.astype(v0.dtype))
    T = jnp.diag(jnp.stack(alphas))
    if krylov_dim > 1:
        b = jnp.stack(betas)
        T = T + jnp.diag(b, 1) + jnp.diag(b, -1)
    lam, V = jnp.linalg.eigh(T)           # T real symmetric tridiagonal
    phase = jnp.exp(t * lam.astype(v0.dtype))
    y = V.astype(v0.dtype) @ (phase * V[0].astype(v0.dtype))
    return (nrm * (y @ Q)).reshape(shape)


def _right_env_stack_A(x, A, mask_r):
    d, R, n, _ = x.shape
    init = _boundary_env(R, A.shape[1], x.dtype)

    def step(carry, inp):
        xc, Ac, mr = inp
        xc = xc * mr[None, None, :]
        new = jnp.einsum("aip,Wijw,bjq,pwq->aWb", jnp.conj(xc), Ac, xc, carry,
                         optimize=True)
        return new, new

    _, envs = lax.scan(step, init, (x, A, mask_r), reverse=True)
    return jnp.concatenate([envs, init[None]], axis=0)


@partial(jax.jit, static_argnames=("expm", "krylov_dim", "imag_real"))
def tdvp1_step(A_stack, x_stack, masks, dt, expm: str = "lanczos",
               krylov_dim: int = 20, imag_real: bool = False):
    """One symmetric 1-site TDVP sweep (L->R then R->L) for time step ``dt``
    on ``i dpsi/dt = H psi`` (pass ``dt = -1j*h_imag`` for imaginary time).
    All arrays complex; returns the updated stack.

    ``expm='lanczos'`` (default) evolves each site/bond with matrix-free
    Lanczos exponentiation (Hermitian H); ``'dense'`` materializes the
    masked local operator and calls ``jax.scipy.linalg.expm`` (any H, but
    O((RnR)^2) memory — small ranks only)."""
    d, R, n, _ = x_stack.shape
    dtc = x_stack.dtype
    Renvs = _right_env_stack_A(x_stack, A_stack, masks[1:])
    L0 = _boundary_env(R, A_stack.shape[1], dtc)

    if imag_real:
        # REAL imaginary-time evolution (real arithmetic only):
        # dt is the real step h, site evolution exp(+h K), bond exp(-h K)
        t1 = dt
        t0 = -dt
    else:
        t1 = -1j * dt
        t0 = +1j * dt

    def exp1(L, Ac, Renv, m_l, m_r, t, v):
        if expm == "dense":
            return _expmv(_k1_masked(L, Ac, Renv, m_l, m_r), t, v)
        return _lanczos_expmv(_k1_apply(L, Ac, Renv, m_l, m_r), t, v,
                              krylov_dim)

    def exp0(L, Renv, m, t, v):
        if expm == "dense":
            return _expmv(_k0_masked(L, Renv, m), t, v)
        return _lanczos_expmv(_k0_apply(L, Renv, m), t, v, krylov_dim)

    def renorm(v, lg):
        """Imaginary-time transient control: exp(+h K0) bond back-evolution
        amplifies high modes by up to e^{h*||A||} per bond; the factors
        cancel site-to-site but the running product overflows f32 within a
        few bonds at stiff h*||A|| (measured: d=10 heat at h=1e-4 ->
        h*lambda_max = 42, inf by site 4). Carrying the scale in log space
        is exact: the total is folded back into the final center core."""
        if not imag_real:
            return v, lg
        nv = jnp.linalg.norm(v)
        nv = jnp.where(nv > 0, nv, 1.0)
        return v / nv, lg + jnp.log(nv)

    def fwd(carry, inp):
        L, C, lg = carry
        core, Ac, Renv, m_l, m_r = inp
        AC = jnp.einsum("ab,bnc->anc", C, core)
        AC = exp1(L, Ac, Renv, m_l, m_r, t1, AC)
        AC, lg = renorm(AC, lg)
        q, r = jnp.linalg.qr(AC.reshape(R * n, R))
        q = q * m_r[None, :]
        r = r * m_r[:, None]
        new_core = q.reshape(R, n, R)
        L_new = jnp.einsum("aic,aWb,Wijw,bjd->cwd", jnp.conj(new_core), L, Ac,
                           new_core, optimize=True)
        C_new = exp0(L_new, Renv, m_r, t0, r)
        C_new, lg = renorm(C_new, lg)
        return (L_new, C_new, lg), new_core

    C0 = jnp.zeros((R, R), dtype=dtc).at[0, 0].set(1.0)
    lg0 = jnp.zeros((), jnp.zeros((), dtc).real.dtype)
    inputs = (x_stack[:-1], A_stack[:-1], Renvs[1:d], masks[:-2], masks[1:-1])
    (L, C, lg), fwd_cores = lax.scan(fwd, (L0, C0, lg0), inputs)

    # full step at the last site
    AC = jnp.einsum("ab,bnc->anc", C, x_stack[d - 1])
    AC = exp1(L, A_stack[d - 1], Renvs[d], masks[d - 1], masks[d], t1, AC)
    AC, lg = renorm(AC, lg)

    # backward sweep: sites d-1 .. 1 give right-orthogonal cores; their bond
    # back-evolution feeds the previous site, ending with the center at site 0
    Lenvs = _left_env_stack_from(fwd_cores, A_stack, masks)

    def bwd(carry, inp):
        Renv, AC, lg = carry
        core_left, Ac, Ac_left, Lenv, Lenv_left, m_l, m_ll, m_r = inp
        qt, rt = jnp.linalg.qr(AC.reshape(R, n * R).T)
        new_core = qt.T.reshape(R, n, R) * m_l[:, None, None]
        t = rt.T * m_l[None, :]
        R_new = jnp.einsum("aip,Wijw,bjq,pwq->aWb", jnp.conj(new_core), Ac,
                           new_core, Renv, optimize=True)
        C = exp0(Lenv, R_new, m_l, t0, t)
        C, lg = renorm(C, lg)
        AC_prev = jnp.einsum("anb,bc->anc", core_left, C)
        AC_prev = exp1(Lenv_left, Ac_left, R_new, m_ll, m_l, t1, AC_prev)
        AC_prev, lg = renorm(AC_prev, lg)
        return (R_new, AC_prev, lg), new_core

    Rb0 = _boundary_env(R, A_stack.shape[1], dtc)
    inputs_b = (fwd_cores, A_stack[1:], A_stack[:-1], Lenvs[1:d],
                Lenvs[0:d - 1], masks[1:-1], masks[:-2], masks[2:])
    (Renv, AC0, lg), bwd_cores = lax.scan(bwd, (Rb0, AC, lg), inputs_b,
                                          reverse=True)
    if imag_real:
        AC0 = AC0 * jnp.exp(lg).astype(dtc)
    return jnp.concatenate([AC0[None], bwd_cores], axis=0)


def _left_env_stack_from(cores_left, A, masks):
    """Left envs from the forward-written left-orthogonal cores 0..d-2;
    Lenvs[i] covers sites 0..i-1 (length d)."""
    d_minus_1, R, n, _ = cores_left.shape
    init = _boundary_env(R, A.shape[1], cores_left.dtype)

    def step(carry, inp):
        xc, Ac = inp
        new = jnp.einsum("aic,aWb,Wijw,bjd->cwd", jnp.conj(xc), carry, Ac, xc,
                         optimize=True)
        return new, new

    _, envs = lax.scan(step, init, (cores_left, A[:-1]))
    return jnp.concatenate([init[None], envs], axis=0)


def _k2_masked(L, Ai, Aj, Renv, m_l, m_r):
    R = L.shape[0]
    n = Ai.shape[1]
    M = R * n * n * R
    K = jnp.einsum("aWb,WiIw,wjJv,cvd->aijcbIJd", L, Ai, Aj, Renv,
                   optimize=True).reshape(M, M)
    maskv = (m_l[:, None, None, None] * m_r[None, None, None, :]
             * jnp.ones((1, n, n, 1), dtype=m_l.dtype)).reshape(M)
    return K * maskv[:, None] * maskv[None, :]


def _keep_mask_tdvp(s, truncerr, max_keep, R):
    """Absolute-threshold keep mask capped at ``max_keep`` (the reference
    tdvp2 uses _svdtrunc's absolute rule, tdvp.jl:250-253). Numerically-zero
    padded singular values are always dropped so reported ranks stay honest."""
    idx = jnp.arange(R)
    floor = jnp.maximum(truncerr, s[0] * 1e-15)
    keep = (s[:R] >= floor) & (idx < max_keep)
    keep = keep.at[0].set(True)
    return keep.astype(s.dtype)


def _svd2_masked(Vm, method):
    """(u, s, vt) of the merged two-site matrix; ``method='gram'`` replaces
    the in-scan SVD with an eigh of the Gram (small-singular-value rows of vt
    are zeroed by the pseudo-inverse scaling — they are below the truncation
    floor anyway)."""
    if method == "gram":
        B = Vm @ jnp.conj(Vm).T
        w, U = jnp.linalg.eigh(0.5 * (B + jnp.conj(B).T))
        s = jnp.sqrt(jnp.maximum(w[::-1].real, 0.0))
        u = U[:, ::-1]
        svt = jnp.conj(u).T @ Vm
        s_inv = jnp.where(s > jnp.finfo(s.dtype).eps * Vm.shape[0]
                          * jnp.max(s), 1.0 / jnp.maximum(s, 1e-300), 0.0)
        vt = s_inv[:, None].astype(svt.dtype) * svt
        return u, s, vt
    return jnp.linalg.svd(Vm, full_matrices=False)


@partial(jax.jit, static_argnames=("expm", "krylov_dim", "imag_real",
                                  "split"))
def tdvp2_step(A_stack, x_stack, mask_stack, dt, truncerr, max_keep,
               expm: str = "lanczos", krylov_dim: int = 20,
               imag_real: bool = False, split: str = "svd"):
    """One 2-site TDVP sweep (L->R then R->L) with half time steps and
    dynamic rank masks (jitted analog of the eager tdvp2sweep). ``expm`` as
    in :func:`tdvp1_step` (default matrix-free Lanczos, Hermitian H);
    ``imag_real``/``split='gram'`` select the real-dtype, SVD-free device
    forms."""
    d, R, n, _ = x_stack.shape
    dtc = x_stack.dtype
    Renvs = _right_env_stack_A(x_stack, A_stack, mask_stack[1:])
    if imag_real:
        t2 = dt / 2
        t1 = -dt / 2
    else:
        t2 = -1j * dt / 2
        t1 = +1j * dt / 2
    L0 = _boundary_env(R, A_stack.shape[1], dtc)

    def exp2(L, Ai, Aj, Renv, m_l, m_r, t, v):
        if expm == "dense":
            return _expmv(_k2_masked(L, Ai, Aj, Renv, m_l, m_r), t, v)
        return _lanczos_expmv(_k2_apply(L, Ai, Aj, Renv, m_l, m_r), t, v,
                              krylov_dim)

    def exp1(L, Ac, Renv, m_l, m_r, t, v):
        if expm == "dense":
            return _expmv(_k1_masked(L, Ac, Renv, m_l, m_r), t, v)
        return _lanczos_expmv(_k1_apply(L, Ac, Renv, m_l, m_r), t, v,
                              krylov_dim)

    def renorm(v, lg):
        # see tdvp1_step.renorm: log-space scale carry kills the f32
        # transient overflow of stiff imaginary-time bond back-evolutions
        if not imag_real:
            return v, lg
        nv = jnp.linalg.norm(v)
        nv = jnp.where(nv > 0, nv, 1.0)
        return v / nv, lg + jnp.log(nv)

    def fwd(carry, inp):
        L, AC, m_l, lg = carry
        core_next, Ai, Aj, Renv, m_r, is_last = inp
        AAC = jnp.einsum("asg,gtb->astb", AC, core_next)
        AAC = exp2(L, Ai, Aj, Renv, m_l, m_r, t2, AAC)
        AAC, lg = renorm(AAC, lg)
        u, s, vt = _svd2_masked(AAC.reshape(R * n, n * R), split)
        keep = _keep_mask_tdvp(jnp.abs(s[:R]), truncerr, max_keep, R)
        core = (u[:, :R] * keep[None, :]).reshape(R, n, R)
        AC_new = ((s[:R, None] * vt[:R, :]) * keep[:, None]).reshape(R, n, R)
        L_new = jnp.einsum("aic,aWb,Wijw,bjd->cwd", jnp.conj(core), L, Ai,
                           core, optimize=True)
        # skip the 1-site back-evolution on the last forward bond (expm(0)=I;
        # the Lanczos form reproduces the identity exactly: y = e1)
        AC_new = exp1(L_new, Aj, Renv, keep, m_r, t1 * (1.0 - is_last),
                      AC_new)
        AC_new, lg = renorm(AC_new, lg)
        return (L_new, AC_new, keep, lg), (core, keep)

    m0 = mask_stack[0]
    lg0 = jnp.zeros((), jnp.zeros((), dtc).real.dtype)
    inputs = (x_stack[1:], A_stack[:-1], A_stack[1:], Renvs[2:],
              mask_stack[2:],
              jnp.arange(d - 1) == d - 2)
    (L, AC, m_last, lg), (fwd_cores, fwd_masks) = lax.scan(
        fwd, (L0, x_stack[0], m0, lg0), inputs)
    x_mid = jnp.concatenate([fwd_cores, AC[None]], axis=0)
    masks_mid = jnp.concatenate(
        [mask_stack[0][None], fwd_masks, mask_stack[d][None]], axis=0)

    Lenvs = _left_env_stack_from(x_mid[:-1], A_stack, masks_mid)
    R0 = _boundary_env(R, A_stack.shape[1], dtc)

    def bwd(carry, inp):
        Renv, AC, m_r, lg = carry
        core_prev, Ai, Aj, Lenv, m_l, is_first = inp
        AAC = jnp.einsum("asg,gtb->astb", core_prev, AC)
        AAC = exp2(Lenv, Ai, Aj, Renv, m_l, m_r, t2, AAC)
        AAC, lg = renorm(AAC, lg)
        u, s, vt = _svd2_masked(AAC.reshape(R * n, n * R), split)
        keep = _keep_mask_tdvp(jnp.abs(s[:R]), truncerr, max_keep, R)
        core = (vt[:R, :] * keep[:, None]).reshape(R, n, R)
        AC_new = ((u[:, :R] * s[None, :R]) * keep[None, :]).reshape(R, n, R)
        R_new = jnp.einsum("aip,Wijw,bjq,pwq->aWb", jnp.conj(core), Aj, core,
                           Renv, optimize=True)
        AC_new = exp1(Lenv, Ai, R_new, m_l, keep, t1 * (1.0 - is_first),
                      AC_new)
        AC_new, lg = renorm(AC_new, lg)
        return (R_new, AC_new, keep, lg), (core, keep)

    inputs_b = (x_mid[:-1], A_stack[:-1], A_stack[1:], Lenvs[: d - 1],
                masks_mid[: d - 1], jnp.arange(d - 1) == 0)
    (Renv, AC0, m_first, lg), (bwd_cores, bwd_masks) = lax.scan(
        bwd, (R0, x_mid[d - 1], mask_stack[d], lg), inputs_b, reverse=True)
    if imag_real:
        AC0 = AC0 * jnp.exp(lg).astype(dtc)
    x_out = jnp.concatenate([AC0[None], bwd_cores], axis=0)
    masks_out = jnp.concatenate(
        [mask_stack[0][None], bwd_masks, mask_stack[d][None]], axis=0)
    return x_out, masks_out


def _check_hermitian_for_lanczos(H: TTOperator, expm: str) -> None:
    """Guard for ``expm='lanczos'``: Lanczos exponentiation silently assumes
    a Hermitian generator — a non-Hermitian H (convection, OU drift) would
    produce quietly wrong dynamics. Probabilistic host-side check:
    ``<x, H y> == conj(<y, H x>)`` for random rank-2 TT vectors; fails with a
    pointer to ``expm='dense'`` (which handles any generator)."""
    if expm != "lanczos":
        return
    from ttnx.core.algebra import dot, matvec
    from ttnx.core.tt import rand_tt

    k1, k2 = jax.random.split(jax.random.PRNGKey(17))
    dt = H.dtype
    x = rand_tt(k1, H.dims, rmax=2, normalise=True).astype(dt)
    y = rand_tt(k2, H.dims, rmax=2, normalise=True).astype(dt)
    a = complex(dot(x, matvec(H, y)))
    b = complex(dot(y, matvec(H, x)))
    scale = max(abs(a), abs(b), 1e-30)
    tol = float(jnp.finfo(jnp.zeros((), dt).real.dtype).eps) ** 0.5 * 100
    if abs(a - b.conjugate()) / scale > tol:
        raise ValueError(
            "expm='lanczos' requires a Hermitian generator, but "
            f"<x,Hy>={a:.3e} vs conj(<y,Hx>)={b.conjugate():.3e} "
            f"(rel dev {abs(a - b.conjugate()) / scale:.1e}); use "
            "expm='dense' for non-Hermitian H")


def tdvp2_scan(H: TTOperator, u0: TTVector, steps, imaginary_time=False,
               normalize=True, rmax: int | None = None, truncerr: float = 0.0,
               max_bond: int | None = None, expm: str = "lanczos",
               krylov_dim: int = 20, dtype=None, split: str = "svd"):
    """Jitted 2-site TDVP driver with dynamic rank masks. A REAL ``dtype``
    selects the real imaginary-time device path (requires
    ``imaginary_time=True``); ``split='gram'`` replaces the in-scan SVD
    with the eigh form."""
    from ttnx.core.algebra import norm, scale

    _check_hermitian_for_lanczos(H, expm)
    x = orthogonalize(u0, 0)
    if rmax is None:
        rmax = max(2 * max(x.ranks), 4)
    if max_bond is None:
        max_bond = rmax
    dtc = jnp.complex128 if dtype is None else jnp.dtype(dtype)
    real_path = not jnp.issubdtype(dtc, jnp.complexfloating)
    if real_path and not imaginary_time:
        raise ValueError("real-dtype TDVP2 requires imaginary_time=True")
    real_dt = jnp.zeros((), dtc).real.dtype
    A_stack = pack_op(H.astype(dtc), max(H.ranks))
    x_stack = pack_tt(x.astype(dtc), rmax)
    d = x.N
    mask_np = np.zeros((d + 1, rmax))
    for i, r in enumerate(x.ranks):
        mask_np[i, :r] = 1.0
    masks = jnp.asarray(mask_np, dtype=real_dt)
    te = jnp.asarray(truncerr, real_dt)
    mk = jnp.asarray(min(max_bond, rmax), jnp.int32)
    for h in np.atleast_1d(steps):
        if real_path:
            x_stack, masks = tdvp2_step(A_stack, x_stack, masks,
                                        jnp.asarray(h, dtc), te, mk,
                                        expm=expm, krylov_dim=krylov_dim,
                                        imag_real=True, split=split)
        else:
            dt = (1j * h) if imaginary_time else jnp.asarray(h, dtc)
            x_stack, masks = tdvp2_step(A_stack, x_stack, masks,
                                        jnp.asarray(dt, dtc), te, mk,
                                        expm=expm, krylov_dim=krylov_dim,
                                        split=split)
        if normalize:
            rks = [int(v) for v in np.asarray(jnp.sum(jnp.real(masks),
                                                      axis=1))]
            out = unpack_tt(x_stack, rks)
            out = scale(1.0 / float(norm(out)), out)
            x_stack = pack_tt(out, rmax)
    rks = [int(v) for v in np.asarray(jnp.sum(jnp.real(masks), axis=1))]
    return unpack_tt(x_stack, rks)


def tdvp1_scan(H: TTOperator, u0: TTVector, steps, imaginary_time=False,
               normalize=True, rmax: int | None = None, expm: str = "lanczos",
               krylov_dim: int = 20, dtype=None):
    """Driver: jitted 1-site TDVP over ``steps`` (eager normalization between
    steps, mirroring the reference driver tdvp.jl:154-203).

    ``dtype`` defaults to complex128 (reference parity). A REAL dtype
    (float32/float64) selects the real imaginary-time path: requires
    ``imaginary_time=True`` and a real symmetric ``H``.

    STIFFNESS LIMIT (any dtype, worst for f32): the symmetric TDVP
    splitting decays modes by ``e^{-h*lambda}`` at the site step and
    re-amplifies them by ``e^{+h*lambda}`` at the bond back-evolution; once
    ``e^{-h*lambda_max}`` falls below the dtype's epsilon the decayed
    information is roundoff and the re-amplification manufactures noise —
    keep ``h * ||A|| < ~16`` for f32 (~36 for f64). Inside that region the
    carried log-scale renormalization (``imag_real`` path) keeps transients
    finite; measured f32 d=10 heat: rel err 7e-6 at h*lmax=0.8, 2.6e-5 at
    h*lmax=17, destroyed at 42."""
    from ttnx.core.algebra import norm, scale

    _check_hermitian_for_lanczos(H, expm)
    x = orthogonalize(u0, 0)
    rks = x.ranks
    if rmax is None:
        rmax = max(max(rks), 2)
    dtc = jnp.complex128 if dtype is None else jnp.dtype(dtype)
    real_path = not jnp.issubdtype(dtc, jnp.complexfloating)
    if real_path and not imaginary_time:
        raise ValueError("real-dtype TDVP requires imaginary_time=True")
    real_dt = jnp.zeros((), dtc).real.dtype
    A_stack = pack_op(H.astype(dtc), max(H.ranks))
    masks = rank_masks(rks, rmax, dtype=real_dt)
    x_stack = pack_tt(x.astype(dtc), rmax)
    for h in np.atleast_1d(steps):
        if real_path:
            x_stack = tdvp1_step(A_stack, x_stack, masks,
                                 jnp.asarray(h, dtc), expm=expm,
                                 krylov_dim=krylov_dim, imag_real=True)
        else:
            # imaginary time: dt_eff = +i*h makes the site evolution
            # exp(+h*K), matching the reference driver (tdvp.jl:179)
            dt = (1j * h) if imaginary_time else jnp.asarray(h, dtc)
            x_stack = tdvp1_step(A_stack, x_stack, masks,
                                 jnp.asarray(dt, dtc), expm=expm,
                                 krylov_dim=krylov_dim)
        if normalize:
            out = unpack_tt(x_stack, rks)
            out = scale(1.0 / float(norm(out)), out)
            x_stack = pack_tt(out, rmax)
    return unpack_tt(x_stack, rks)
