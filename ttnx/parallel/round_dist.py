"""Distributed TT rounding: the padded-rank gram rounding of
``ttnx.solvers.round_scan`` with every site unfolding column-sharded over a
``tp`` mesh axis.

This is the "distributed SVD/QR panel factorization" obligation (SURVEY
§2.9, BASELINE north star) wired into the production rounding path: the
O(R^2 * nR) Gram accumulations and basis applications — the FLOPs of
rounding — run sharded over ``tp``, with one ``reduce_scatter`` + one
``psum`` per site over the interconnect, while the tiny eigendecompositions
stay replicated.

Sharding layout (per site, ``R`` = padded input rank, ``p`` = tp size):

    right-orth sweep  cm = (R, n*R)     columns sharded -> Gram psum (R, R)
    truncation sweep  cm = (R_out*n, R) columns sharded -> Gram psum (tiny)
                       t_k all-gathered (k x R, ~16 KB) to carry the sweep

The mathematics is identical to ``tt_round_scan(..., method='gram')`` —
tests assert agreement with the single-device path on the 8-device CPU
mesh and that the sharded intermediate layout is preserved site to site.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

__all__ = ["gram_round_dist", "gram_chain_round_dist",
           "gram_chain_round_dist_pair", "shard_chain",
           "make_cn_step_dist", "tp_rounding_worthwhile"]


def _gram_sqrt_apply(cm_loc, axis):
    """Local columns of ``cm``: return ``(q_loc, T)`` with ``cm = T @ q``
    (T = (cm cm^H)^{1/2} PSD, replicated; q column-sharded, orthonormal
    rows on the row space). One psum of the Gram matrix over ``axis``."""
    R = cm_loc.shape[0]
    G = jax.lax.psum(cm_loc @ jnp.conj(cm_loc).T, axis)
    w, V = jnp.linalg.eigh(G)
    s = jnp.sqrt(jnp.maximum(w.real, 0.0))
    cutoff = jnp.finfo(s.dtype).eps * R * jnp.max(s)
    keep = s > cutoff
    s_inv = jnp.where(keep, 1.0 / jnp.where(keep, s, 1.0), 0.0)
    s_kept = jnp.where(keep, s, 0.0)
    q_loc = (V * s_inv[None, :].astype(V.dtype)) @ (jnp.conj(V).T @ cm_loc)
    T = (V * s_kept[None, :].astype(V.dtype)) @ jnp.conj(V).T
    return q_loc, T


def _round_kernel(y_loc, masks_y, masks_out, *, R_out: int, axis: str):
    """shard_map body: ``y_loc (d, R, n, R/p)`` — this device's column block
    of every site. Returns the rounded chain ``(d, R_out, n, R_out)``
    replicated (R_out is small; the sharded work is the R-sized sweeps)."""
    d, R, n, R_loc = y_loc.shape
    idx = jax.lax.axis_index(axis)

    # ---- right-orthogonalization sweep (sites d-1 .. 1) -----------------
    cores_loc = [None] * d
    T = jnp.zeros((R, R), dtype=y_loc.dtype).at[0, 0].set(1.0)
    for i in range(d - 1, 0, -1):
        # c[a,n,c'] = sum_b core[a,n,b] T[b,c']: b is this site's sharded
        # column axis -> local partial, then reduce_scatter re-shards the
        # fresh c' columns in the same collective
        T_rows = jax.lax.dynamic_slice_in_dim(T, idx * R_loc, R_loc, axis=0)
        c_part = jnp.einsum("anb,bc->anc", y_loc[i], T_rows)
        c_loc = jax.lax.psum_scatter(c_part, axis, scatter_dimension=2,
                                     tiled=True)            # (R, n, R/p)
        m_l = masks_y[i]
        q_loc, T = _gram_sqrt_apply(c_loc.reshape(R, n * R_loc), axis)
        cores_loc[i] = q_loc.reshape(R, n, R_loc) * m_l[:, None, None]
        T = T * m_l[None, :]
    T_rows = jax.lax.dynamic_slice_in_dim(T, idx * R_loc, R_loc, axis=0)
    c_part = jnp.einsum("anb,bc->anc", y_loc[0], T_rows)
    cores_loc[0] = jax.lax.psum_scatter(c_part, axis, scatter_dimension=2,
                                        tiled=True)

    # ---- truncation sweep (sites 0 .. d-2) -------------------------------
    out = [None] * d
    k = min(R_out, R)
    T2 = jnp.zeros((R_out, R), dtype=y_loc.dtype).at[0, 0].set(1.0)
    for i in range(d - 1):
        # c = T2 @ core: contraction over the FULL left rank axis — local;
        # the result inherits the core's sharded right axis
        c_loc = jnp.einsum("ob,bnc->onc", T2, cores_loc[i])  # (R_out,n,R/p)
        cm_loc = c_loc.reshape(R_out * n, R_loc)
        m_r = masks_out[i + 1]
        G = jax.lax.psum(cm_loc @ jnp.conj(cm_loc).T, axis)  # tiny
        w, V = jnp.linalg.eigh(G)
        u_k = V[:, ::-1][:, :k] * m_r[None, :k].astype(V.dtype)
        t_loc = jnp.conj(u_k).T @ cm_loc                     # (k, R/p)
        pad = jnp.zeros((R_out * n, R_out - k), dtype=cm_loc.dtype)
        out[i] = jnp.concatenate([u_k, pad], axis=1).reshape(R_out, n, R_out)
        # carry: gather the sharded columns — the next site's left axis is
        # full, so T2 must be replicated (k x R, tiny)
        t_full = jax.lax.all_gather(t_loc, axis, axis=1, tiled=True)
        t_full = t_full * m_r[:k, None].astype(t_full.dtype)
        T2 = jnp.concatenate(
            [t_full, jnp.zeros((R_out - k, R), dtype=t_full.dtype)], axis=0)
    # last site: absorb the transfer; the global boundary column 0 lives in
    # device 0's block
    c_loc = jnp.einsum("ob,bnc->onc", T2, cores_loc[d - 1])
    last_col = c_loc[:, :, 0:1] * (idx == 0).astype(c_loc.dtype)
    last_col = jax.lax.psum(last_col, axis)                  # (R_out, n, 1)
    out[d - 1] = jnp.pad(last_col, ((0, 0), (0, 0), (0, R_out - 1)))
    return jnp.stack(out)


def _gram_chain_kernel_dist(y_loc, masks_out, *, R_out: int, axis: str):
    """shard_map body for the distributed GRAM-CHAIN rounding: ``y_loc
    (d, R, n, R/p)`` is this device's column block of every site.

    Unlike the orthogonalize-first form (:func:`_round_kernel`), every
    factorization here is a tiny ``(R_out*n)^2`` eigh — the O(R^3) work is
    all matmuls sharded 1/p, so there is no Amdahl wall (the measured
    0.56 replicated fraction of the gram form; docs/design.md).

    Collectives per site: backward Gram sweep — one ``psum_scatter``
    (re-shard the Y_i G partial products onto this device's column block)
    + one ``psum`` of the (R, R) Gram; forward truncation sweep — one
    ``psum`` of the (R_out*n, R) half-product, one tiny ``psum`` of B, one
    ``all_gather`` of the (R_out, R) transfer.
    """
    d, R, n, R_loc = y_loc.shape
    idx = jax.lax.axis_index(axis)
    dt = y_loc.dtype

    # ---- backward Gram sweep: Gs[k] = G_{k+1}, pure matmuls ------------
    G = jnp.zeros((R, R), dtype=dt).at[0, 0].set(1.0)
    Gs = [None] * d
    Gs[d - 1] = G
    for k in range(d - 1, 0, -1):
        G_rows = jax.lax.dynamic_slice_in_dim(G, idx * R_loc, R_loc, axis=0)
        # partial over this device's b block: t_i = Y_i @ G, then re-shard
        # the b' columns so the second contraction is local
        t_part = jnp.einsum("anb,bc->anc", y_loc[k], G_rows)   # (R, n, R)
        t_loc = jax.lax.psum_scatter(t_part, axis, scatter_dimension=2,
                                     tiled=True)               # (R, n, R/p)
        G_part = jnp.einsum("anc,bnc->ab", t_loc, jnp.conj(y_loc[k]))
        G = jax.lax.psum(G_part, axis)                          # (R, R)
        Gs[k - 1] = G

    # ---- forward truncation sweep: tiny eighs, sharded matmuls ---------
    out = [None] * d
    T2 = jnp.zeros((R_out, R), dtype=dt).at[0, 0].set(1.0)
    for k in range(d - 1):
        Gk = Gs[k]
        c_loc = jnp.einsum("ob,bnc->onc", T2, y_loc[k])         # local: full
        # left axis is replicated in T2; columns stay sharded
        cm_loc = c_loc.reshape(R_out * n, R_loc)
        G_rows = jax.lax.dynamic_slice_in_dim(Gk, idx * R_loc, R_loc, axis=0)
        t_half = jax.lax.psum(cm_loc @ G_rows, axis)            # (R_out*n, R)
        t_cols = jax.lax.dynamic_slice_in_dim(t_half, idx * R_loc, R_loc,
                                              axis=1)
        B = jax.lax.psum(t_cols @ jnp.conj(cm_loc).T, axis)     # tiny
        B = 0.5 * (B + jnp.conj(B).T)
        m_r = masks_out[k + 1]
        w, V = jnp.linalg.eigh(B)
        u_k = V[:, ::-1][:, :R_out] * m_r[None, :R_out].astype(V.dtype)
        out[k] = u_k.reshape(R_out, n, R_out)
        t2_loc = jnp.conj(u_k).T @ cm_loc                       # (R_out, R/p)
        T2 = jax.lax.all_gather(t2_loc, axis, axis=1, tiled=True)
        T2 = T2 * m_r[:R_out, None].astype(T2.dtype)
    # last site: absorb the transfer; global boundary column 0 lives in
    # device 0's block
    c_loc = jnp.einsum("ob,bnc->onc", T2, y_loc[d - 1])
    last_col = c_loc[:, :, 0:1] * (idx == 0).astype(dt)
    last_col = jax.lax.psum(last_col, axis)
    out[d - 1] = jnp.pad(last_col, ((0, 0), (0, 0), (0, R_out - 1)))
    return jnp.stack(out)


def _gram_chain_kernel_dist_pipe(y2_loc, masks_out, *, R_out: int,
                                 axis: str):
    """Pair-pipelined twin of :func:`_gram_chain_kernel_dist`, structured
    for collective/compute overlap. The Gram recurrence is strictly
    sequential WITHIN a chain — every op at site k-1 consumes the site-k
    psum — so the only honest
    overlap source is an INDEPENDENT problem: this kernel rounds TWO
    chains with their site loops interleaved, so in program order every
    collective of chain A is followed by chain B's independent partial
    products (and vice versa). XLA's async collectives (start/done pairs)
    can then hide each psum/psum_scatter/all_gather behind the other
    chain's matmuls; the virtual CPU mesh serializes collectives, so
    there the structure is only parity-tested. ``y2_loc (2, d, R, n,
    R/p)``."""
    P2, d, R, n, R_loc = y2_loc.shape
    idx = jax.lax.axis_index(axis)
    dt = y2_loc.dtype

    # ---- backward Gram sweeps, interleaved ------------------------------
    G = [jnp.zeros((R, R), dtype=dt).at[0, 0].set(1.0) for _ in range(P2)]
    Gs = [[None] * d for _ in range(P2)]
    for q in range(P2):
        Gs[q][d - 1] = G[q]
    for k in range(d - 1, 0, -1):
        # stage 1: local partials (compute) then re-shards (collective) —
        # chain q's psum_scatter is adjacent to chain q+1's einsum
        t_loc = [None] * P2
        for q in range(P2):
            G_rows = jax.lax.dynamic_slice_in_dim(G[q], idx * R_loc, R_loc,
                                                  axis=0)
            t_part = jnp.einsum("anb,bc->anc", y2_loc[q, k], G_rows)
            t_loc[q] = jax.lax.psum_scatter(t_part, axis,
                                            scatter_dimension=2, tiled=True)
        # stage 2: Gram partials + psums, likewise interleaved
        for q in range(P2):
            G_part = jnp.einsum("anc,bnc->ab", t_loc[q],
                                jnp.conj(y2_loc[q, k]))
            G[q] = jax.lax.psum(G_part, axis)
            Gs[q][k - 1] = G[q]

    # ---- forward truncation sweeps, interleaved -------------------------
    out = [[None] * d for _ in range(P2)]
    T2 = [jnp.zeros((R_out, R), dtype=dt).at[0, 0].set(1.0)
          for _ in range(P2)]
    for k in range(d - 1):
        cm_loc = [None] * P2
        t_half = [None] * P2
        for q in range(P2):
            c_loc = jnp.einsum("ob,bnc->onc", T2[q], y2_loc[q, k])
            cm_loc[q] = c_loc.reshape(R_out * n, R_loc)
            G_rows = jax.lax.dynamic_slice_in_dim(Gs[q][k], idx * R_loc,
                                                  R_loc, axis=0)
            t_half[q] = jax.lax.psum(cm_loc[q] @ G_rows, axis)
        m_r = masks_out[k + 1]
        for q in range(P2):
            t_cols = jax.lax.dynamic_slice_in_dim(t_half[q], idx * R_loc,
                                                  R_loc, axis=1)
            B = jax.lax.psum(t_cols @ jnp.conj(cm_loc[q]).T, axis)
            B = 0.5 * (B + jnp.conj(B).T)
            w, V = jnp.linalg.eigh(B)
            u_k = V[:, ::-1][:, :R_out] * m_r[None, :R_out].astype(V.dtype)
            out[q][k] = u_k.reshape(R_out, n, R_out)
            t2_loc = jnp.conj(u_k).T @ cm_loc[q]
            T2[q] = jax.lax.all_gather(t2_loc, axis, axis=1, tiled=True)
            T2[q] = T2[q] * m_r[:R_out, None].astype(T2[q].dtype)
    for q in range(P2):
        c_loc = jnp.einsum("ob,bnc->onc", T2[q], y2_loc[q, d - 1])
        last_col = c_loc[:, :, 0:1] * (idx == 0).astype(dt)
        last_col = jax.lax.psum(last_col, axis)
        out[q][d - 1] = jnp.pad(last_col, ((0, 0), (0, 0),
                                           (0, R_out - 1)))
    return jnp.stack([jnp.stack(o) for o in out])


def gram_chain_round_dist_pair(y_pair, R_out: int, masks_out, mesh: Mesh,
                               axis: str = "tp"):
    """Round TWO padded chains ``y_pair (2, d, R, n, R)`` with the
    pair-pipelined tp-sharded Gram-chain kernel (collective/compute
    overlap structure; see :func:`_gram_chain_kernel_dist_pipe`). Parity:
    equals two independent :func:`gram_chain_round_dist` calls."""
    _, d, R, n, _ = y_pair.shape
    p = mesh.shape[axis]
    if R % p != 0:
        raise ValueError(f"padded rank {R} not divisible by {axis}={p}")
    kernel = partial(_gram_chain_kernel_dist_pipe, R_out=R_out, axis=axis)
    fn = shard_map(
        kernel, mesh=mesh,
        in_specs=(P(None, None, None, None, axis), P()),
        out_specs=P(),
        check_vma=False)
    return fn(y_pair, masks_out)


def gram_chain_round_dist(y, R_out: int, masks_out, mesh: Mesh,
                          axis: str = "tp"):
    """Distributed :func:`ttnx.solvers.round_scan.tt_round_gram`: the
    Gram-chain rounding with every O(R^3) matmul column-sharded over
    ``mesh[axis]`` and only tiny ``(R_out*n)^2`` eighs replicated — the
    tp formulation WITHOUT the Amdahl wall of :func:`gram_round_dist`
    (design.md "tp-sharded rounding"). ``R`` must divide by the axis size;
    returns the rounded ``(d, R_out, n, R_out)`` chain replicated."""
    d, R, n, _ = y.shape
    p = mesh.shape[axis]
    if R % p != 0:
        raise ValueError(f"padded rank {R} not divisible by {axis}={p}")
    kernel = partial(_gram_chain_kernel_dist, R_out=R_out, axis=axis)
    fn = shard_map(
        kernel, mesh=mesh,
        in_specs=(P(None, None, None, axis), P()),
        out_specs=P(),
        check_vma=False)
    return fn(y, masks_out)


def shard_chain(y, mesh: Mesh, axis: str = "tp"):
    """Place a padded chain ``(d, R, n, R)`` with the last rank axis sharded
    over ``mesh[axis]``."""
    return jax.device_put(
        y, NamedSharding(mesh, P(None, None, None, axis)))


def gram_round_dist(y, masks_y, R_out: int, masks_out, mesh: Mesh,
                    axis: str = "tp"):
    """Distributed :func:`ttnx.solvers.round_scan.tt_round_scan`
    (``method='gram'``): ``y (d, R, n, R)`` column-sharded over
    ``mesh[axis]``, rounded to buffer rank ``R_out`` (returned replicated).

    ``R`` must be divisible by the axis size."""
    d, R, n, _ = y.shape
    p = mesh.shape[axis]
    if R % p != 0:
        raise ValueError(f"padded rank {R} not divisible by {axis}={p}")
    kernel = partial(_round_kernel, R_out=R_out, axis=axis)
    fn = shard_map(
        kernel, mesh=mesh,
        in_specs=(P(None, None, None, axis), P(), P()),
        out_specs=P(),
        check_vma=False)
    return fn(y, masks_y, masks_out)


def tp_rounding_worthwhile(RA: int, rmax: int, p: int,
                           overhead_x: float = 2.0) -> bool:
    """Auto-select predicate: is tp-sharding the gram rounding expected to
    beat replicated execution?

    Basis: the per-site eigh of the (R, R) Gram is
    replicated and its cost scales with the SAME O(R^3) as the sharded
    matmuls (cm is (R, 2R)), so the replicated fraction is a constant
    ~0.56 at every rank — Amdahl caps the ideal tp speedup at 1.28x (p=2)
    / 1.49x (p=4) regardless of rank, so the shard_map overhead would have
    to stay below ~1.3x to break even. Verdict: tp-sharding THIS algorithm
    never pays; the predicate returns False for every feasible (RA*rmax,
    p) so the auto path keeps rounding replicated, and the sharded kernel
    remains available for explicit scale-out experiments
    (``force_tp=True``). The path forward for a genuinely tp-profitable
    rounding is the Gram-chain algorithm (``round_method='gram_chain'``),
    whose only eighs are the tiny (2*R_out)^2 truncation ones.
    """
    R = RA * rmax
    ideal = 1.0 / (0.56 + 0.44 / p)
    return ideal > overhead_x and R >= 512


def make_cn_step_dist(A, h: float, rmax: int, dims, u_rks, mesh: Mesh,
                      dtype=jnp.float64, sweep_count: int = 4,
                      solver: str = "lu", axis: str = "tp",
                      force_tp: bool | None = None,
                      round_method: str = "gram"):
    """Crank–Nicolson step with the rounding stage tp-sharded: the
    distributed twin of :func:`ttnx.solvers.round_scan.make_cn_step`
    (``round_method='gram'``). The MPO application and ALS solve run at the
    small target rank (replicated); the R = R_A * rmax sized rounding sweeps
    run column-sharded over ``mesh[axis]`` via :func:`gram_round_dist`.
    Returns ``(step_fn, pack, unpack)``.

    ``force_tp=None`` (auto) consults :func:`tp_rounding_worthwhile` —
    which, per the measured Amdahl bound, currently always selects the
    REPLICATED rounding — so the auto path is the measured-fastest one and
    the sharded kernel runs only on request (``force_tp=True``, used by the
    multichip dryrun to exercise the collective path).

    ``round_method='gram'`` (default) matches
    ``make_cn_step(round_method='gram')`` gauge-for-gauge;
    ``'gram_chain'`` uses the Amdahl-free Gram-chain formulation
    (:func:`gram_chain_round_dist` when sharded, ``tt_round_gram``
    replicated) — the flagship rounding and the designated basis for real
    multi-chip rank sharding.
    """
    import numpy as np

    from ttnx.core.algebra import add_op, scale_op
    from ttnx.core.tt import id_tto, r_and_d_to_rks
    from ttnx.solvers.als_scan import (als_sweeps, pack_op, pack_tt,
                                       rank_masks, unpack_tt)
    from ttnx.solvers.round_scan import matvec_padded, round_masks

    d = len(dims)
    A = A.astype(dtype)
    eye = id_tto(d, dtype=dtype)
    lhs = add_op(eye, scale_op(-h / 2, A))
    rhs = add_op(eye, scale_op(h / 2, A))
    RA = max(rhs.ranks)
    lhs_stack = pack_op(lhs, max(lhs.ranks))
    rhs_stack = pack_op(rhs, RA)

    u_rks = r_and_d_to_rks(u_rks, dims, rmax=rmax)
    real_dt = jnp.zeros((), dtype).real.dtype
    masks_u = rank_masks(u_rks, rmax, dtype=real_dt)
    masks_A = np.zeros((d + 1, RA))
    for i, r in enumerate(rhs.ranks):
        masks_A[i, :r] = 1.0
    mu = np.asarray(masks_u)
    masks_big = jnp.asarray(np.stack(
        [np.outer(masks_A[i], mu[i]).reshape(-1) for i in range(d + 1)]),
        dtype=real_dt)
    big_rks = [min(a * b, RA * rmax) for a, b in zip(rhs.ranks, u_rks)]
    out_rks = round_masks(big_rks, rmax, dims)
    masks_out = rank_masks(out_rks, rmax, dtype=real_dt)

    rng = np.random.default_rng(0)
    noise_np = np.zeros((d, rmax, 2, rmax))
    for i in range(d):
        noise_np[i, : u_rks[i], :, : u_rks[i + 1]] = (
            1e-3 * rng.standard_normal((u_rks[i], 2, u_rks[i + 1])))
    guess_noise = jnp.asarray(noise_np, dtype=dtype)

    if round_method not in ("gram", "gram_chain"):
        raise ValueError("round_method must be 'gram' or 'gram_chain', "
                         f"got {round_method!r}")
    p = mesh.shape[axis]
    use_tp = (tp_rounding_worthwhile(RA, rmax, p) if force_tp is None
              else bool(force_tp)) and p > 1

    @jax.jit
    def step_fn(u_stack):
        big = matvec_padded(rhs_stack, u_stack)
        if use_tp:
            big = jax.lax.with_sharding_constraint(
                big, NamedSharding(mesh, P(None, None, None, axis)))
            if round_method == "gram_chain":
                b = gram_chain_round_dist(big, rmax, masks_out, mesh, axis)
            else:
                b = gram_round_dist(big, masks_big, rmax, masks_out, mesh,
                                    axis)
        elif round_method == "gram_chain":
            from ttnx.solvers.round_scan import tt_round_gram

            b = tt_round_gram(big, rmax, masks_out)
        else:
            from ttnx.solvers.round_scan import tt_round_scan

            b = tt_round_scan(big, masks_big, rmax, masks_out, method="gram")
        return als_sweeps(lhs_stack, b, u_stack + guess_noise, masks_u,
                          sweep_count, solver=solver)

    def pack(u):
        from ttnx.core.canonical import tt_round

        if max(u.ranks) > rmax:
            u = tt_round(u, max_bond=rmax)
        return pack_tt(u.astype(dtype), rmax)

    unpack = lambda s: unpack_tt(s, u_rks)
    return step_fn, pack, unpack
