"""Distributed tall-skinny QR (TSQR) over a device mesh.

The panel factorization behind distributed TT orthogonalization/rounding
(SURVEY §2.9: distributed SVD/QR panel factorization). The unfolded TT core
``(r*n, r')`` is row-sharded over the mesh; each device QRs its block, the small ``R`` factors are all-gathered
and reduced by one more QR, and the final thin-Q factors multiply
back locally — the only communication is the ``p * r'^2`` R-factor gather.

Sign convention: R's diagonal is made non-negative so the factorization is
unique and device-count independent.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

__all__ = ["tsqr", "tsvd", "cholesky_qr2", "distributed_orthogonalize_core",
           "distributed_truncate_bond"]


def _signfix(q, r):
    s = jnp.sign(jnp.diagonal(r))
    s = jnp.where(s == 0, 1.0, s)
    return q * s[None, :], r * s[:, None]


def tsqr(a, mesh: Mesh, axis: str = "dp"):
    """QR of a row-sharded tall matrix ``a: (m, k)`` with ``m`` sharded over
    ``mesh[axis]``. Returns ``(q, r)`` with ``q`` sharded the same way and
    ``r`` replicated.
    """
    m, k = a.shape
    p = mesh.shape[axis]
    if m % p != 0 or m // p < k:
        raise ValueError(
            f"TSQR needs each local block tall: m={m} over {p} devices gives "
            f"{m // p} rows per block < k={k}")

    def kernel(a_blk):
        q1, r1 = jnp.linalg.qr(a_blk)      # local block QR
        q1, r1 = _signfix(q1, r1)
        # gather every device's small R: (p*k, k)
        r_all = jax.lax.all_gather(r1, axis, tiled=True)
        q2, r2 = jnp.linalg.qr(r_all)      # reduce on every device (replicated)
        q2, r2 = _signfix(q2, r2)
        idx = jax.lax.axis_index(axis)
        q2_blk = jax.lax.dynamic_slice_in_dim(q2, idx * k, k, axis=0)
        return q1 @ q2_blk, r2

    spec_in = P(axis, None)
    # r2 is bitwise identical on every device (same all-gathered input), but
    # shard_map cannot prove that statically -> check_vma=False
    fn = shard_map(kernel, mesh=mesh, in_specs=(spec_in,),
                   out_specs=(spec_in, P(None, None)), check_vma=False)
    return fn(a)


def cholesky_qr2(a, mesh: Mesh, axis: str = "dp"):
    """QR of a row-sharded matrix ``a: (m, k)`` by two rounds of CholeskyQR —
    a matmul-only panel factorization: each round is one local Gram
    matmul, one ``psum``, one tiny replicated Cholesky, and one
    local triangular solve. Unlike :func:`tsqr` it has **no per-block
    tallness requirement** (works whenever ``m >= k`` globally, e.g. a
    ``(r*n, r)`` TT-core unfolding with ``n=2`` sharded over 8 devices), and
    it is pure matmul + elementwise work — no Householder panel on the
    critical path.

    The second round repairs the first round's ``kappa(a)^2 * eps``
    orthogonality loss (standard CholeskyQR2); callers factorizing
    ill-conditioned panels (kappa >~ 1e7 in f64) should use :func:`tsqr`.
    Returns ``(q, r)``, ``q`` sharded like ``a``, ``r`` replicated with a
    non-negative diagonal.
    """
    m, k = a.shape

    def kernel(a_blk):
        def cqr(x_blk):
            g = jax.lax.psum(
                jnp.einsum("mi,mj->ij", jnp.conj(x_blk), x_blk), axis)
            # tiny shift keeps the Cholesky on the safe side of roundoff
            # without perturbing R beyond eps * ||a||^2
            eps = jnp.finfo(x_blk.real.dtype).eps
            shift = 11 * (m * k + k * (k + 1)) * eps * jnp.trace(g).real / k
            r = jnp.linalg.cholesky(
                g + shift * jnp.eye(k, dtype=g.dtype), upper=True)
            q_blk = jax.scipy.linalg.solve_triangular(
                r.T, x_blk.T, lower=True).T
            return q_blk, r
        q1, r1 = cqr(a_blk)
        q2, r2 = cqr(q1)
        r = r2 @ r1
        s = jnp.sign(jnp.diagonal(r).real)
        s = jnp.where(s == 0, 1.0, s)
        return q2 * s[None, :], r * s[:, None]

    spec_in = P(axis, None)
    fn = shard_map(kernel, mesh=mesh, in_specs=(spec_in,),
                   out_specs=(spec_in, P(None, None)), check_vma=False)
    return fn(a)


def tsvd(a, mesh: Mesh, axis: str = "dp"):
    """Thin SVD of a row-sharded tall matrix ``a: (m, k)`` via TSQR: the only
    collective is the ``p * k^2`` R-factor gather inside :func:`tsqr`; the
    ``k x k`` SVD runs replicated and ``U = Q @ U_R`` is a purely local,
    sharding-preserving matmul. Returns ``(u, s, vt)`` with ``u`` sharded
    like ``a`` and ``s``/``vt`` replicated.

    This is the distributed panel factorization behind TT rounding
    (reference two-site truncation: /root/reference/src/tt_tools.jl:737-789),
    where the merged bond matrix is tall: ``m = R*n`` rows vs ``k`` kept
    singular directions.

    Panel method is picked by block shape: TSQR when every local block is
    tall (``m/p >= k``), CholeskyQR2 otherwise (the ``(r*n, r)`` unfolding
    with ``n=2`` over 8 devices lands here).
    """
    m, k = a.shape
    p = mesh.shape[axis]
    if m % p == 0 and m // p >= k:
        q, r = tsqr(a, mesh, axis)
    else:
        q, r = cholesky_qr2(a, mesh, axis)
    u_r, s, vt = jnp.linalg.svd(r, full_matrices=False)
    # sign convention: first row of vt non-negative -> device-count
    # independent factors (svd of the replicated R is already identical on
    # every device; this also pins the per-singular-vector sign)
    sgn = jnp.sign(vt[:, 0])
    sgn = jnp.where(sgn == 0, 1.0, sgn)
    return q @ (u_r * sgn[None, :]), s, vt * sgn[:, None]


def distributed_truncate_bond(theta, mesh: Mesh, rel_tol: float = 0.0,
                              max_bond: int | None = None, axis: str = "dp"):
    """Truncated factorization of a row-sharded bond matrix
    ``theta: (m, k)`` -> ``(left, right, keep)`` with ``left = U*S`` masked
    (sharded like ``theta``), ``right = Vt`` masked (replicated), and
    ``keep`` the 0/1 mask over the ``k`` singular directions. Shapes are
    static: truncation is the mask, never a reshape.

    Keep rule = the reference rounding criterion (relative discarded-weight
    tail, /root/reference/src/solvers/mals.jl:42-56): drop the largest tail
    with ``sum(tail^2) <= rel_tol^2 * ||s||^2``, capped at ``max_bond``.
    """
    k = theta.shape[1]
    u, s, vt = tsvd(theta, mesh, axis)
    tail = jnp.cumsum(jnp.flip(s * s))
    tol2 = (rel_tol * rel_tol) * jnp.sum(s * s)
    keep = jnp.flip(tail > tol2).astype(s.dtype)
    if max_bond is not None and max_bond < k:
        keep = keep * (jnp.arange(k) < max_bond).astype(s.dtype)
    keep = keep.at[0].set(1.0)  # never drop everything
    left = u * (s * keep)[None, :]
    right = vt * keep[:, None]
    return left, right, keep


def distributed_orthogonalize_core(core, mesh: Mesh, axis: str = "dp"):
    """Left-orthogonalize one padded TT core ``(R, n, R')`` with the
    ``(R*n, R')`` unfolding row-sharded over the mesh. Returns
    ``(q_core, transfer)`` — the orthogonal core (same sharding) and the
    triangular transfer matrix to absorb into the next core (replicated)."""
    Rl, n, Rr = core.shape
    mat = core.reshape(Rl * n, Rr)
    q, r = tsqr(mat, mesh, axis)
    return q.reshape(Rl, n, Rr), r
