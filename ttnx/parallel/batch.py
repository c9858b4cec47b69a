"""Mesh/sharding layer: continuous batching of independent QTT solves plus
rank-axis sharding over a device mesh.

The reference is a single-process library (no distributed backend — SURVEY §2.9
documents the absence); this layer batches independent solves over a ``dp``
axis and shards padded rank axes over ``tp``, letting XLA insert the
collectives.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ttnx.core.tt import TTOperator, TTVector
from ttnx.solvers.als_scan import als_sweeps, pack_op, pack_tt, rank_masks

__all__ = [
    "make_mesh",
    "batched_als_sweeps",
    "batched_als_linsolve",
    "batched_dmrg_eig_sweeps",
    "batched_tdvp1_steps",
    "batched_tdvp2_steps",
    "shard_batched_problem",
    "shard_batch",
]


def make_mesh(dp: int | None = None, tp: int = 1, devices=None) -> Mesh:
    """A ``(dp, tp)`` device mesh: data-parallel batch axis x tensor-parallel
    rank axis. Defaults to all devices on ``dp``."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp*tp must equal device count ({dp}*{tp} != {n})")
    dev_array = np.array(devices).reshape(dp, tp)
    return Mesh(dev_array, axis_names=("dp", "tp"))


def batched_als_sweeps(A_stack, b_batch, x_batch, masks, sweep_count: int = 2,
                       solver: str = "lu"):
    """vmap of the scan-based ALS over a leading problem axis: one operator,
    a batch of right-hand sides and initial guesses. Where ``solver='cg'``
    runs the Triton local CG, vmap adds a grid dimension to the kernel."""
    fn = jax.vmap(
        lambda b, x: als_sweeps(A_stack, b, x, masks, sweep_count,
                                solver=solver),
        in_axes=(0, 0))
    return fn(b_batch, x_batch)


def _op_axis(A):
    """0 when the operator stack carries a leading batch axis (parameter
    sweep: one operator per problem, ``[B, d, RA, n, n, RA]``), else None
    (one shared operator)."""
    if A.ndim == 6:
        return 0
    if A.ndim == 5:
        return None
    raise ValueError(f"operator stack must be 5-D or 6-D, got {A.ndim}-D")


def batched_dmrg_eig_sweeps(A, x_batch, mask_batch, tol, degen_tol,
                            n_sweeps: int = 1, lanczos_iters: int = 24,
                            split: str = "svd"):
    """vmap of the jitted two-site DMRG eigsweep over a leading problem
    axis — the parameter-sweep workload of BASELINE config 3 (reference
    example: /root/reference/examples/heisenberg_xyz_dmrg.jl, run for a
    batch of couplings/fields at once).

    ``A`` is either one shared operator stack ``[d, RA, n, n, RA]`` or a
    batch ``[B, d, RA, n, n, RA]`` (one Hamiltonian per problem, e.g. a
    field sweep). ``x_batch``/``mask_batch`` carry the leading batch axis;
    masks are runtime data, so rank adaptation stays per-problem. Returns
    ``(x_batch, mask_batch, energies[B, ...])``.
    """
    from ttnx.solvers.dmrg_scan import dmrg_eig_sweep

    def one(A_stack, x, m):
        Es = []
        for _ in range(n_sweeps):
            x, m, E = dmrg_eig_sweep(A_stack, x, m, tol, degen_tol,
                                     lanczos_iters=lanczos_iters,
                                     split=split)
            Es.append(E)
        return x, m, jnp.concatenate(Es)

    return jax.vmap(one, in_axes=(_op_axis(A), 0, 0))(A, x_batch, mask_batch)


def batched_tdvp1_steps(A, x_batch, mask_batch, h, n_steps: int = 1,
                        expm: str = "lanczos", krylov_dim: int = 20,
                        imag_real: bool = False):
    """vmap of the jitted 1-site TDVP step over a leading problem axis
    (BASELINE config 4 as a parameter sweep; reference workload:
    /root/reference/examples/tdvp_example.jl). ``A`` shared or batched as in
    :func:`batched_dmrg_eig_sweeps`; ``h`` is a scalar step or a length-B
    vector (one step size per problem). Returns the evolved ``x_batch``."""
    from ttnx.solvers.tdvp_scan import tdvp1_step

    h = jnp.asarray(h)
    h_axis = 0 if h.ndim == 1 else None

    def one(A_stack, x, m, hh):
        for _ in range(n_steps):
            x = tdvp1_step(A_stack, x, m, hh, expm=expm,
                           krylov_dim=krylov_dim, imag_real=imag_real)
        return x

    return jax.vmap(one, in_axes=(_op_axis(A), 0, 0, h_axis))(
        A, x_batch, mask_batch, h)


def batched_tdvp2_steps(A, x_batch, mask_batch, h, truncerr, max_bond,
                        n_steps: int = 1, expm: str = "lanczos",
                        krylov_dim: int = 20, imag_real: bool = False,
                        split: str = "svd"):
    """vmap of the jitted 2-site (rank-adaptive) TDVP step; masks are
    runtime data so each problem adapts its own ranks inside the shared
    padded buffers. Returns ``(x_batch, mask_batch)``."""
    from ttnx.solvers.tdvp_scan import tdvp2_step

    h = jnp.asarray(h)
    h_axis = 0 if h.ndim == 1 else None
    te = jnp.asarray(truncerr, x_batch.real.dtype)
    mk = jnp.asarray(max_bond, jnp.int32)

    def one(A_stack, x, m, hh):
        for _ in range(n_steps):
            x, m = tdvp2_step(A_stack, x, m, hh, te, mk, expm=expm,
                              krylov_dim=krylov_dim, imag_real=imag_real,
                              split=split)
        return x, m

    return jax.vmap(one, in_axes=(_op_axis(A), 0, 0, h_axis))(
        A, x_batch, mask_batch, h)


def shard_batch(mesh: Mesh, *arrays):
    """Place batched arrays (leading problem axis) on the ``dp`` mesh axis,
    everything else replicated — the generic dp placement for the batched
    DMRG/TDVP tiers."""
    return tuple(
        jax.device_put(a, NamedSharding(mesh, P("dp"))) for a in arrays)


def shard_batched_problem(mesh: Mesh, A_stack, b_batch, x_batch, masks):
    """Place a batched problem on the mesh: batch axis over ``dp``, the
    trailing padded rank axis over ``tp``; operator and masks replicated."""
    A_sh = jax.device_put(A_stack, NamedSharding(mesh, P()))
    b_sh = jax.device_put(b_batch, NamedSharding(mesh, P("dp")))
    x_sh = jax.device_put(
        x_batch, NamedSharding(mesh, P("dp", None, None, None, "tp")))
    m_sh = jax.device_put(masks, NamedSharding(mesh, P()))
    return A_sh, b_sh, x_sh, m_sh


def batched_als_linsolve(mesh: Mesh, A: TTOperator, bs: list[TTVector],
                         x0s: list[TTVector], sweep_count: int = 2,
                         rmax: int | None = None, solver: str = "lu"):
    """Solve many independent ``A x = b_k`` problems across the mesh.

    All problems must share dims and the rank profile of ``x0s[0]`` (pad your
    guesses to a common ``rmax`` first). Returns a list of TTVectors.
    """
    from ttnx.core.canonical import orthogonalize
    from ttnx.solvers.als_scan import unpack_tt

    x0s = [orthogonalize(x, 0) for x in x0s]
    rks = x0s[0].ranks
    if rmax is None:
        rmax = max(rks)
    dt = jnp.result_type(A.dtype, *[b.dtype for b in bs])
    A_stack = pack_op(A.astype(dt), max(A.ranks))
    Rb = max(max(b.ranks) for b in bs)
    b_batch = jnp.stack([pack_tt(b.astype(dt), Rb) for b in bs])
    x_batch = jnp.stack([pack_tt(x.astype(dt), rmax) for x in x0s])
    real_dt = jnp.zeros((), dt).real.dtype
    masks = rank_masks(rks, rmax, dtype=real_dt)

    A_sh, b_sh, x_sh, m_sh = shard_batched_problem(
        mesh, A_stack, b_batch, x_batch, masks)
    with mesh:
        out = batched_als_sweeps(A_sh, b_sh, x_sh, m_sh, sweep_count,
                                 solver=solver)
    return [unpack_tt(out[k], rks) for k in range(len(bs))]
