"""ttnx benchmark sections, each gated by an independent oracle.

Every section builds its problem at the sizes given, calls it once (trace,
compile and one run: ``compile_s``), then times one window of calls that
ends in ``jax.block_until_ready`` (``run_s``), checks its accuracy gates and
returns one record::

    {"phase", "compile_s", "run_s", "gate": {name: value},
     "limit": {name: limit}, "precision", "peak_bytes", ...}

A gate that fails (or is not finite) raises ``RuntimeError``. ``peak_bytes``
is ``device.memory_stats()["peak_bytes_in_use"]`` after the section: the
process's high-water mark so far, ``None`` on a backend without memory stats.

``chip_smoke.py`` runs the sections on the card. ``python bench.py`` runs
them in one process and prints one JSON line with the device it ran on.
"""

import json
import os
import time
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.abspath(__file__))


def enable_compile_cache() -> str:
    """Keep JAX's persistent compile cache where ``JAX_COMPILATION_CACHE_DIR``
    says (JAX reads that variable itself) or, when it is unset, at the fixed
    path ``<repo>/.jax_cache``. Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(REPO, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def device_info() -> dict:
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def _peak_bytes():
    stats = jax.devices()[0].memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def _timed(fn):
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


def _record(phase, compile_s, run_s, gate, limit, precision, **extra):
    for name, value in gate.items():
        if not np.isfinite(value) or value > limit[name]:
            raise RuntimeError(
                f"{phase}: gate {name}={value:.3e} exceeds {limit[name]:.0e}")
    return {"phase": phase, "compile_s": compile_s, "run_s": run_s,
            "gate": gate, "limit": limit, "precision": precision,
            "peak_bytes": _peak_bytes(), **extra}


# ---------------------------------------------------------------------------
# Oracles (numpy, independent of the code under test)
# ---------------------------------------------------------------------------


def _dense_xxx_groundstate(d: int) -> float:
    """Ground energy of the open XXX chain in the Pauli convention (sum of
    sx.sx + sy.sy + sz.sz over bonds), built by Kronecker products
    (reference cross-check pattern:
    TensorTrainNumerics.jl examples/heisenberg_xyz_dmrg.jl:16-22)."""
    sx = np.array([[0.0, 1.0], [1.0, 0.0]])
    sy_i = np.array([[0.0, -1.0], [1.0, 0.0]])  # sy = i * sy_i
    sz = np.diag([1.0, -1.0])
    H = np.zeros((2 ** d, 2 ** d))
    for i in range(d - 1):
        for P, sgn in ((sx, 1.0), (sy_i, -1.0), (sz, 1.0)):
            op = np.array([[1.0]])
            for j in range(d):
                op = np.kron(op, P if j in (i, i + 1) else np.eye(2))
            H += sgn * op  # (i*sy_i)(x)(i*sy_i) = -(sy_i x sy_i)
    return float(np.linalg.eigvalsh(H)[0])


def _three_mode_state(d, hg):
    """Multi-mode Dirichlet eigenstate on the interior grid (rank 6): the
    qtt_sin grid nodes are exactly j*hg, so each term is an exact
    eigenvector of the tridiagonal Laplacian — the whole CN evolution has a
    closed form to gate against."""
    import ttnx

    return (ttnx.qtt_sin(d, a=hg, b=1 - hg, lam=1.0)
            + 0.5 * ttnx.qtt_sin(d, a=hg, b=1 - hg, lam=3.0)
            + 0.25 * ttnx.qtt_sin(d, a=hg, b=1 - hg, lam=9.0))


def _cn_analytic(d, hg, h_step, steps):
    j = np.arange(1, 2 ** d + 1)
    out = np.zeros(2 ** d)
    for k, amp in ((1, 1.0), (3, 0.5), (9, 0.25)):
        mu = (2 - 2 * np.cos(k * np.pi * hg)) / hg ** 2
        rho = (1 - h_step / 2 * mu) / (1 + h_step / 2 * mu)
        out += amp * rho ** steps * np.sin(k * np.pi * j * hg)
    return out


def _tridiag(v):
    out = 2 * v
    out[:-1] -= v[1:]
    out[1:] -= v[:-1]
    return out


def _cn_residual(u_next, u_prev, hg, h_step):
    """Implicit-solve residual ||L u+ - R u|| / ||R u|| with the exact
    tridiagonal operators in f64 numpy — gates the ALS solve itself."""
    c = h_step / (2 * hg ** 2)
    lhs = u_next + c * _tridiag(u_next)
    rhs = u_prev - c * _tridiag(u_prev)
    return float(np.linalg.norm(lhs - rhs) / np.linalg.norm(rhs))


def _implicit_residual(x, u, hg, h_step):
    """||(I - h/2 A) x - u|| / ||u|| for the exact tridiagonal A."""
    c = h_step / (2 * hg ** 2)
    return float(np.linalg.norm(x + c * _tridiag(x) - u) / np.linalg.norm(u))


def _dense(stack, rks):
    from ttnx.core.decomp import ttv_to_tensor
    from ttnx.solvers.als_scan import unpack_tt

    return np.asarray(ttv_to_tensor(unpack_tt(np.asarray(stack), rks)),
                      np.float64).reshape(-1)


def _wishart_f_idx(d=5, n_grid=8):
    """Index evaluator of the 5-D Wishart Laplace-transform integrand
    ``det(I + theta * sqrt(D) S sqrt(D))^(-p)`` on a uniform grid
    (reference workload:
    TensorTrainNumerics.jl test/test_tt_cross_interpolation.jl:147-186)."""
    p = (d + 2) / 2
    Sigma = np.array([
        [1.0, 0.3, 0.2, 0.1, 0.18],
        [0.3, 1.2, 0.25, 0.15, 0.22],
        [0.2, 0.25, 0.9, 0.2, 0.28],
        [0.1, 0.15, 0.2, 1.1, 0.19],
        [0.18, 0.22, 0.28, 0.19, 1.05],
    ])[:d, :d]
    sigma = jnp.asarray(2 * Sigma, jnp.float32)
    grid = jnp.linspace(0.0, 2.0, n_grid).astype(jnp.float32)

    def f_idx(theta, indices):
        coords = jnp.take(grid, indices)
        s = jnp.sqrt(jnp.maximum(coords, 0.0))
        Msym = (jnp.eye(d, dtype=jnp.float32)[None]
                + theta * s[:, :, None] * sigma[None] * s[:, None, :])
        w = jnp.linalg.eigvalsh(Msym)
        return jnp.prod(w, axis=1) ** (-p)

    return f_idx


def _heat_lhs(d, h_step, dtype=jnp.float32):
    """Packed ``I - h/2 A`` for the Dirichlet heat generator
    ``A = -T / hg^2`` on the 2^d interior grid."""
    import ttnx
    from ttnx.core.algebra import add_op, scale_op
    from ttnx.core.tt import id_tto
    from ttnx.solvers.als_scan import pack_op

    hg = 1.0 / (2 ** d + 1)
    A = ((-1.0 / hg ** 2) * ttnx.toeplitz_to_qtto(2.0, -1.0, -1.0, d)
         ).astype(dtype)
    lhs = add_op(id_tto(d, dtype=dtype), scale_op(-h_step / 2, A))
    return pack_op(lhs, max(lhs.ranks)), hg


# ---------------------------------------------------------------------------
# Sections
# ---------------------------------------------------------------------------


def eager_f64(d: int = 6, sweep_count: int = 4):
    """README quick-start #3 through the eager f64 tier:
    ``als_linsolve(id_tto(d), qtt_sin(d), x0)``, relative error of A x
    against b."""
    import ttnx
    from ttnx.core.algebra import matvec, norm, sub

    A = ttnx.id_tto(d)
    b = ttnx.qtt_sin(d)
    x0 = ttnx.rand_tt(jax.random.PRNGKey(0), (2,) * d, rmax=4,
                      normalise=True)
    run = lambda: ttnx.als_linsolve(A, b, x0, sweep_count=sweep_count)
    _, t_first = _timed(run)
    x, t_run = _timed(run)
    rel = float(norm(sub(matvec(A, x), b)) / norm(b))
    return _record("eager_f64", t_first, t_run, {"rel_err": rel},
                   {"rel_err": 1e-12}, "float64", d=d)


def cn_problem(rmax: int = 16, d: int = 12, cg_iters: int = 16,
               h_step: float = 1e-6):
    """``(step_fn, u_stack, hg)``: the jitted f32 Crank–Nicolson step of
    the Dirichlet heat equation on 2^d points at bond rank ``rmax`` and the
    packed 3-mode eigenstate it starts from."""
    import ttnx
    from ttnx.solvers.round_scan import make_cn_step

    hg = 1.0 / (2 ** d + 1)
    A = (-1.0 / hg ** 2) * ttnx.toeplitz_to_qtto(2.0, -1.0, -1.0, d)
    step_fn, pack, _ = make_cn_step(
        A, h_step, rmax=rmax, dims=(2,) * d,
        u_rks=(1,) + (rmax,) * (d - 1) + (1,), dtype=jnp.float32,
        sweep_count=2, solver="cg", round_method="gram_chain",
        precision="highest", cg_iters=cg_iters)
    return step_fn, pack(_three_mode_state(d, hg)), hg


def cn_step(rmax: int = 16, d: int = 12, steps: int = 8, cg_iters: int = 16,
            h_step: float = 1e-6):
    """The jitted Crank–Nicolson step (padded MPO apply + Gram-chain
    rounding + warm-started CG ALS), f32 ``precision='highest'``, ``steps``
    chained steps from a 3-mode eigenstate. Gated against the closed-form
    CN evolution and the last step's implicit-solve residual."""
    from ttnx.core.tt import r_and_d_to_rks

    step_fn, us, hg = cn_problem(rmax, d, cg_iters, h_step)
    u_rks = (1,) + (rmax,) * (d - 1) + (1,)

    def chain():
        prev, v = us, us
        for _ in range(steps):
            prev, v = v, step_fn(v)
        return prev, v

    _, t_first = _timed(lambda: step_fn(us))
    (prev, last), t_run = _timed(chain)
    rks = r_and_d_to_rks(u_rks, (2,) * d, rmax=rmax)
    d_prev, d_last = _dense(prev, rks), _dense(last, rks)
    exact = _cn_analytic(d, hg, h_step, steps)
    rel = float(np.linalg.norm(d_last - exact) / np.linalg.norm(exact))
    res = _cn_residual(d_last, d_prev, hg, h_step)
    return _record(f"cn_d{d}_r{rmax}", t_first, t_run,
                   {"rel_analytic": rel, "residual": res},
                   {"rel_analytic": 1e-3, "residual": 1e-2}, "highest",
                   steps=steps,
                   ms_per_step=t_run / steps * 1e3)


def batched_als(d: int = 12, rmax: int = 64, batch: int = 512,
                impl: str = "vmap", cg_iters: int = 16, h_step: float = 1e-6):
    """``batch`` independent implicit solves ``(I - h/2 A) x = u0`` with
    the scan-tier ALS (two half-sweeps, warm-started matrix-free CG), f32
    ``precision='highest'``: ``impl='vmap'`` is ``jax.vmap(als_sweeps)``,
    ``impl='explicit'`` is :func:`als_sweeps_b`. Gated by the implicit-solve
    residual of the first and last problem."""
    from ttnx.core.canonical import tt_round
    from ttnx.core.decomp import ttv_to_tensor
    from ttnx.core.tt import r_and_d_to_rks
    from ttnx.solvers.als_scan import als_sweeps, pack_tt, rank_masks
    from ttnx.solvers.als_scan_batched import als_sweeps_b

    lhs_stack, hg = _heat_lhs(d, h_step)
    u_rks = r_and_d_to_rks((1,) + (rmax,) * (d - 1) + (1,), (2,) * d,
                           rmax=rmax)
    masks = rank_masks(u_rks, rmax, dtype=jnp.float32)
    u0 = _three_mode_state(d, hg)
    us = pack_tt(tt_round(u0, max_bond=rmax).astype(jnp.float32), rmax)
    bb = jnp.broadcast_to(us, (batch,) + us.shape)
    if impl == "vmap":
        fn = jax.jit(lambda b, x: jax.vmap(
            lambda b1, x1: als_sweeps(lhs_stack, b1, x1, masks, 2,
                                      solver="cg", cg_iters=cg_iters))(b, x))
    else:
        fn = jax.jit(lambda b, x: als_sweeps_b(lhs_stack, b, x, masks, 2,
                                               cg_iters=cg_iters))

    def run():
        with jax.default_matmul_precision("highest"):
            return fn(bb, bb)

    _, t_first = _timed(run)
    out, t_run = _timed(run)
    u0d = np.asarray(ttv_to_tensor(u0)).reshape(-1)
    res = max(_implicit_residual(_dense(out[k], u_rks), u0d, hg, h_step)
              for k in (0, batch - 1))
    return _record(f"batched_als_d{d}_r{rmax}_b{batch}", t_first, t_run,
                   {"residual": res}, {"residual": 1e-2}, "highest",
                   impl=impl,
                   solves_per_s=batch / t_run)


def dmrg(d: int = 10, rmax: int = 16, sweeps: int = 8,
         lanczos_iters: int = 8):
    """Jitted two-site DMRG eigsweeps on the open XXX chain, f32
    ``precision='highest'``, ``sweeps`` chained sweeps; gated against the
    dense ground-state energy."""
    import ttnx
    from ttnx.solvers.als_scan import pack_op, pack_tt, rank_masks
    from ttnx.solvers.dmrg_scan import dmrg_eig_sweep

    H = ttnx.heisenberg_xyz_tto(d, jx=1.0, jy=1.0, jz=1.0).astype(jnp.float32)
    x0 = ttnx.rand_tt(jax.random.PRNGKey(3), (2,) * d, rmax=4,
                      normalise=True, orthogonal=True).astype(jnp.float32)
    A_stack = pack_op(H, max(H.ranks))
    x_stack = pack_tt(x0, rmax)
    masks = rank_masks(x0.ranks, rmax, dtype=jnp.float32)
    tol = jnp.float32(1e-8)

    def sweep(xs, ms):
        with jax.default_matmul_precision("highest"):
            return dmrg_eig_sweep(A_stack, xs, ms, tol, tol,
                                  lanczos_iters=lanczos_iters, split="gram")

    def chain():
        xs, ms = x_stack, masks
        for _ in range(sweeps):
            xs, ms, lam = sweep(xs, ms)
        return lam

    _, t_first = _timed(lambda: sweep(x_stack, masks))
    lam, t_run = _timed(chain)
    E = float(np.asarray(lam)[-1])
    E0 = _dense_xxx_groundstate(d)
    return _record(f"dmrg_d{d}_r{rmax}", t_first, t_run,
                   {"rel_energy": abs(E - E0) / abs(E0)},
                   {"rel_energy": 1e-5}, "highest", sweeps=sweeps,
                   ms_per_sweep=t_run / sweeps * 1e3)


def _heat_tdvp_setup(d, rmax):
    import ttnx
    from ttnx.core.canonical import orthogonalize
    from ttnx.solvers.als_scan import pack_op, pack_tt

    hg = 1.0 / (2 ** d + 1)
    A = ((0.1 / hg ** 2) * ttnx.toeplitz_to_qtto(-2.0, 1.0, 1.0, d)
         ).astype(jnp.float32)
    u0 = ttnx.qtt_sin(d, a=hg, b=1 - hg)
    x_stack = pack_tt(orthogonalize(u0, 0).astype(jnp.float32), rmax)
    lam1 = 0.1 * (2 - 2 * np.cos(np.pi * hg)) / hg ** 2
    return pack_op(A, max(A.ranks)), x_stack, u0, lam1


def _decay_gate(got, u0, lam1, t):
    from ttnx.core.decomp import ttv_to_tensor

    expect = np.asarray(ttv_to_tensor(u0)).reshape(-1) * np.exp(-lam1 * t)
    return float(np.linalg.norm(got - expect) / np.linalg.norm(expect))


def tdvp1(d: int = 10, rmax: int = 8, steps: int = 16, h_step: float = 1e-5):
    """Jitted 1-site TDVP imaginary-time trajectory (real f32,
    ``precision='highest'``) on the heat generator, one program for all
    ``steps``; gated against the analytic eigenmode decay."""
    from ttnx.core.tt import r_and_d_to_rks
    from ttnx.solvers.als_scan import rank_masks
    from ttnx.solvers.tdvp_scan import tdvp1_step

    A_stack, x_stack, u0, lam1 = _heat_tdvp_setup(d, rmax)
    masks = rank_masks(r_and_d_to_rks(u0.ranks, (2,) * d, rmax=rmax), rmax,
                       dtype=jnp.float32)
    h = jnp.float32(h_step)

    @jax.jit
    def traj(xs):
        with jax.default_matmul_precision("highest"):
            def body(x, _):
                return tdvp1_step(A_stack, x, masks, h, krylov_dim=8,
                                  imag_real=True), 0.0
            return jax.lax.scan(body, xs, None, length=steps)[0]

    _, t_first = _timed(lambda: traj(x_stack))
    v, t_run = _timed(lambda: traj(x_stack))
    rel = _decay_gate(_dense(v, u0.ranks), u0, lam1, steps * h_step)
    return _record(f"tdvp1_d{d}_r{rmax}", t_first, t_run,
                   {"rel_decay": rel}, {"rel_decay": 1e-3}, "highest",
                   steps=steps, ms_per_step=t_run / steps * 1e3)


def tdvp2(d: int = 10, rmax: int = 8, steps: int = 8, h_step: float = 1e-5):
    """Jitted rank-adaptive 2-site TDVP imaginary-time trajectory (real
    f32, gram split, ``precision='highest'``); gated against the analytic
    eigenmode decay."""
    from ttnx.solvers.tdvp_scan import tdvp2_step

    A_stack, x_stack, u0, lam1 = _heat_tdvp_setup(d, rmax)
    mask_np = np.zeros((d + 1, rmax), np.float32)
    for i, r in enumerate(u0.ranks):
        mask_np[i, :r] = 1.0
    masks = jnp.asarray(mask_np)
    h, te, mk = jnp.float32(h_step), jnp.float32(0.0), jnp.int32(rmax)

    @jax.jit
    def traj(xs0, ms0):
        with jax.default_matmul_precision("highest"):
            def body(carry, _):
                x, m = tdvp2_step(A_stack, *carry, h, te, mk, krylov_dim=10,
                                  imag_real=True, split="gram")
                return (x, m), 0.0
            return jax.lax.scan(body, (xs0, ms0), None, length=steps)[0]

    _, t_first = _timed(lambda: traj(x_stack, masks))
    (xs, ms), t_run = _timed(lambda: traj(x_stack, masks))
    rks = tuple(int(v) for v in np.asarray(ms).sum(axis=1))
    rel = _decay_gate(_dense(xs, rks), u0, lam1, steps * h_step)
    return _record(f"tdvp2_d{d}_r{rmax}", t_first, t_run,
                   {"rel_decay": rel}, {"rel_decay": 1e-3}, "highest",
                   steps=steps, ms_per_step=t_run / steps * 1e3)


def cross(method: str = "maxvol", batch: int = 16, rank: int = 8,
          n_iters: int = 3):
    """Batched device TT-cross (``method='maxvol'`` alternating fibers or
    ``'dmrg'`` two-site superblocks) of the 5-D Wishart integrand over a
    ``batch`` of parameters, one jitted program; gated on the largest
    500-point validation error."""
    from ttnx.cross.device import dmrg_cross_device, maxvol_cross_device

    maker = {"maxvol": maxvol_cross_device, "dmrg": dmrg_cross_device}[method]
    f_idx = _wishart_f_idx()
    thetas = jnp.linspace(0.5, 1.5, batch).astype(jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(2), batch)

    def run_one(theta, key):
        return maker(partial(f_idx, theta), [8] * 5, rank=rank,
                     n_iters=n_iters, dtype=jnp.float32, n_val=500)(key)

    @jax.jit
    def bfn(thetas, keys):
        with jax.default_matmul_precision("highest"):
            return jax.vmap(run_one)(thetas, keys)

    _, t_first = _timed(lambda: bfn(thetas, keys))
    (_, eps), t_run = _timed(lambda: bfn(thetas, keys))
    return _record(f"cross_{method}_b{batch}", t_first, t_run,
                   {"val_eps": float(jnp.max(eps[:, -1]))},
                   {"val_eps": 1e-3}, "highest", per_s=batch / t_run)


def _local_systems(R: int, batch: int, d: int = 12, h_step: float = 1e-6,
                   seed: int = 0):
    """``batch`` SPD local systems of the implicit heat solve at bond rank
    ``R``: environments of a random orthonormal rank-R TT at its middle
    site, one random right-hand side and warm start per problem."""
    import ttnx
    from ttnx.core.canonical import orthogonalize
    from ttnx.solvers.als_scan import (_left_env_stack, _right_env_stack,
                                       pack_tt, rank_masks)

    lhs_stack, _ = _heat_lhs(d, h_step)
    k = d // 2
    x = orthogonalize(ttnx.rand_tt(jax.random.PRNGKey(seed), (2,) * d,
                                   rmax=R), k).astype(jnp.float32)
    xs = pack_tt(x, R)
    masks = rank_masks(x.ranks, R, dtype=jnp.float32)
    b1 = xs[:, :1, :, :1]                   # any rank-1 stack: envs only
    Lenv = _left_env_stack(xs, lhs_stack, b1, masks[1:])[0][k]
    Renv = _right_env_stack(xs, lhs_stack, b1, masks[1:])[0][k + 1]
    n = xs.shape[2]
    mask = masks[k][:, None, None] * masks[k + 1][None, None, :] \
        * jnp.ones((1, n, 1), jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(seed + 1), 2)
    rhs = jax.random.normal(keys[0], (batch, R, n, R), jnp.float32) * mask
    x0 = 0.1 * jax.random.normal(keys[1], (batch, R, n, R), jnp.float32)
    L = jnp.broadcast_to(Lenv, (batch,) + Lenv.shape)
    Re = jnp.broadcast_to(Renv, (batch,) + Renv.shape)
    return L, lhs_stack[k], Re, rhs, mask, x0


def cg_kernel(R: int = 64, batch: int = 512, iters: int = 32,
              interpret: bool = False):
    """The Triton local CG (:mod:`ttnx.kernels.cg_triton`) against the XLA
    matrix-free CG on the same ``batch`` local systems at bond rank ``R``,
    both in IEEE f32. Gated on their largest relative difference and on
    each one's relative residual."""
    from ttnx.kernels.cg_triton import cg_matfree_batched
    from ttnx.solvers.als_scan_batched import _b_cg

    L, Ac, Re, rhs, mask, x0 = _local_systems(R, batch)
    tri = jax.jit(lambda *a: cg_matfree_batched(*a, iters=iters,
                                                interpret=interpret))
    xla = jax.jit(lambda L, Ac, Re, rhs, mask, x0: _b_cg(
        L, Ac, Re, rhs, mask, x0, iters))

    def run(fn):
        with jax.default_matmul_precision("highest"):
            return fn(L, Ac, Re, rhs, mask, x0)

    _, c_tri = _timed(lambda: run(tri))
    _, c_xla = _timed(lambda: run(xla))
    x_tri, t_tri = _timed(lambda: run(tri))
    x_xla, t_xla = _timed(lambda: run(xla))

    def residual(x):
        with jax.default_matmul_precision("highest"):
            kx = jnp.einsum("BaWb,WiJw,Bcwd,BbJd->Baic", L, Ac, Re, x * mask)
        r = (kx - rhs) * mask
        return float(jnp.max(jnp.linalg.norm(r.reshape(batch, -1), axis=1)
                             / jnp.linalg.norm(rhs.reshape(batch, -1),
                                               axis=1)))

    diff = float(jnp.max(jnp.abs(x_tri - x_xla)) / jnp.max(jnp.abs(x_xla)))
    return _record(f"cg_kernel_r{R}_b{batch}", c_tri + c_xla, t_tri + t_xla,
                   {"rel_diff": diff, "residual_triton": residual(x_tri),
                    "residual_xla": residual(x_xla)},
                   {"rel_diff": 1e-5, "residual_triton": 1e-4,
                    "residual_xla": 1e-4}, "highest (IEEE f32)",
                   iters=iters, triton_s=t_tri, xla_s=t_xla,
                   triton_compile_s=c_tri, xla_compile_s=c_xla)


# ---------------------------------------------------------------------------
# Four cards
# ---------------------------------------------------------------------------


def _spread(arr, n_dev):
    """Devices holding a piece of ``arr``; a sharded stage must touch all."""
    used = {s.device for s in arr.addressable_shards}
    if len(used) < n_dev:
        raise RuntimeError(f"output lives on {len(used)} of {n_dev} devices")
    return len(used)


def multichip_batched_als(n_dev: int = 4, d: int = 12, rmax: int = 64,
                          batch: int = 512, cg_iters: int = 16,
                          h_step: float = 1e-6):
    """The batched ALS of :func:`batched_als` with the batch sharded over a
    ``dp=n_dev`` mesh, against the same solve on one device."""
    from ttnx.core.canonical import tt_round
    from ttnx.core.tt import r_and_d_to_rks
    from ttnx.parallel.batch import (batched_als_sweeps, make_mesh,
                                     shard_batched_problem)
    from ttnx.solvers.als_scan import pack_tt, rank_masks

    lhs_stack, hg = _heat_lhs(d, h_step)
    u_rks = r_and_d_to_rks((1,) + (rmax,) * (d - 1) + (1,), (2,) * d,
                           rmax=rmax)
    masks = rank_masks(u_rks, rmax, dtype=jnp.float32)
    u0 = _three_mode_state(d, hg)
    us = pack_tt(tt_round(u0, max_bond=rmax).astype(jnp.float32), rmax)
    # distinct problems: scaled right-hand sides
    scale = jnp.linspace(0.5, 1.5, batch, dtype=jnp.float32)
    bb = us[None] * scale[:, None, None, None, None]
    step = jax.jit(lambda A, b, x, m: batched_als_sweeps(
        A, b, x, m, sweep_count=2, solver="cg"))
    mesh = make_mesh(dp=n_dev, tp=1, devices=jax.devices()[:n_dev])
    sharded = shard_batched_problem(mesh, lhs_stack, bb, bb, masks)
    one = jax.device_put((lhs_stack, bb, bb, masks), jax.devices()[0])

    def run(args):
        with jax.default_matmul_precision("highest"):
            return step(*args)

    _, c_one = _timed(lambda: run(one))
    ref, t_one = _timed(lambda: run(one))
    with mesh:
        _, c_sh = _timed(lambda: run(sharded))
        out, t_sh = _timed(lambda: run(sharded))
    used = _spread(out, n_dev)
    err = max(float(np.linalg.norm(_dense(out[k], u_rks)
                                   - _dense(ref[k], u_rks))
                    / np.linalg.norm(_dense(ref[k], u_rks)))
              for k in (0, batch // 2, batch - 1))
    return _record(f"mc_batched_als_dp{n_dev}", c_sh + c_one, t_sh,
                   {"rel_vs_one_device": err}, {"rel_vs_one_device": 1e-6},
                   "highest", one_device_s=t_one, devices_used=used,
                   solves_per_s=batch / t_sh)


def multichip_cn_tp(n_dev: int = 4, d: int = 12, rmax: int = 16,
                    h_step: float = 1e-6):
    """One f64 CN step with the rounding tp-sharded over a
    ``(dp=n_dev/2, tp=2)`` mesh (:func:`make_cn_step_dist`, gram and
    Gram-chain rounding), against its one-device twin
    :func:`make_cn_step`, at ``dryrun_multichip``'s f64 tolerance. The
    state is a random TT of full rank ``rmax``: on a rank-deficient state
    the gram rounding itself is inaccurate, sharded or not (ROADMAP D10)."""
    import ttnx
    from ttnx.core.canonical import orthogonalize
    from ttnx.core.tt import r_and_d_to_rks
    from ttnx.parallel.batch import make_mesh
    from ttnx.parallel.round_dist import make_cn_step_dist
    from ttnx.solvers.round_scan import make_cn_step

    hg = 1.0 / (2 ** d + 1)
    A = (-1.0 / hg ** 2) * ttnx.toeplitz_to_qtto(2.0, -1.0, -1.0, d)
    u_rks = (1,) + (rmax,) * (d - 1) + (1,)
    rks = r_and_d_to_rks(u_rks, (2,) * d, rmax=rmax)
    u0 = orthogonalize(ttnx.rand_tt(jax.random.PRNGKey(1), (2,) * d,
                                    rmax=rmax, normalise=True), 0)
    mesh = make_mesh(dp=n_dev // 2, tp=2, devices=jax.devices()[:n_dev])
    gate, times, compile_s = {}, {}, 0.0
    for method in ("gram", "gram_chain"):
        kw = dict(dtype=jnp.float64, sweep_count=2, solver="cg",
                  round_method=method)
        with mesh:
            sfd, packd, _ = make_cn_step_dist(A, h_step, rmax, (2,) * d,
                                              u_rks, mesh, force_tp=True,
                                              **kw)
            ud = packd(u0)
            _, c_sh = _timed(lambda: sfd(ud))
            out, t_sh = _timed(lambda: sfd(ud))
        used = _spread(out, n_dev)
        sf, pack, _ = make_cn_step(A, h_step, rmax=rmax, dims=(2,) * d,
                                   u_rks=u_rks, **kw)
        us = pack(u0)
        _, c_one = _timed(lambda: sf(us))
        ref, t_one = _timed(lambda: sf(us))
        gate[f"{method}_rel_vs_one_device"] = float(
            np.linalg.norm(_dense(out, rks) - _dense(ref, rks))
            / np.linalg.norm(_dense(ref, rks)))
        times[f"{method}_tp_s"] = t_sh
        times[f"{method}_one_device_s"] = t_one
        compile_s += c_sh + c_one
    return _record(f"mc_cn_tp2_d{d}_r{rmax}", compile_s,
                   times["gram_chain_tp_s"], gate,
                   {k: 1e-6 for k in gate}, "float64", devices_used=used,
                   **times)


def multichip_tsqr(n_dev: int = 4, rows_per_device: int = 4096,
                   cols: int = 64):
    """Row-sharded f64 TSQR and TSVD of a tall matrix over ``dp=n_dev``,
    against the one-device factorization, at ``dryrun_multichip``'s
    tolerance."""
    from ttnx.parallel.batch import make_mesh
    from ttnx.parallel.tsqr import tsqr, tsvd

    mesh = make_mesh(dp=n_dev, tp=1, devices=jax.devices()[:n_dev])
    rng = np.random.default_rng(3)
    a_np = rng.standard_normal((rows_per_device * n_dev, cols))
    a = jnp.asarray(a_np)

    def run():
        with mesh:
            return tsqr(a, mesh, axis="dp"), tsvd(a, mesh, axis="dp")

    _, c = _timed(run)
    ((q, r), (u, s, vt)), t = _timed(run)
    used = _spread(q, n_dev)
    s_ref = np.linalg.svd(a_np, compute_uv=False)
    gate = {"qr_err": float(jnp.max(jnp.abs(q @ r - a))),
            "svd_err": float(jnp.max(jnp.abs((u * s[None, :]) @ vt - a))),
            "sv_err": float(np.max(np.abs(np.asarray(s) - s_ref)))}
    return _record(f"mc_tsqr_dp{n_dev}", c, t, gate,
                   {k: 1e-5 for k in gate}, "float64", devices_used=used)


def main():
    enable_compile_cache()
    records = [eager_f64(), cn_step(16), cn_step(64), batched_als(),
               batched_als(impl="explicit"), dmrg(), tdvp1(), tdvp2(),
               cross("maxvol"), cross("dmrg", batch=8)]
    print(json.dumps({"device": device_info(), "sections": records}))


if __name__ == "__main__":
    main()
