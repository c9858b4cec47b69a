"""Analytic FLOP accounting for the production solve pipelines.

Counts the *executed* (padded-shape) contraction FLOPs of the jitted
programs — the number the device actually performs and therefore the honest
numerator for fraction-of-roofline reporting (BASELINE's primary metric is
"rank-64 core-contraction throughput ≥70% of roofline"; reference hot
kernel: /root/reference/src/tt_operations.jl:101-111).

Conventions:

* Each einsum is costed by replaying ``np.einsum_path``'s optimal pairwise
  path with the standard ``2 * prod(dims)`` multiply-add convention
  (a matmul ``(m,k)@(k,n)`` counts ``2*m*n*k``).
* Dense factorization FLOPs (eigh, QR) are EXCLUDED — they are a few
  percent of the totals at the ranks of interest and excluding them only
  *understates* the reported GFLOP/s. Elementwise masking is ignored.
* Padded shapes, not masked-true-rank shapes: the device executes the
  padded matmuls regardless of the rank masks, so utilization must be
  measured against them.
"""

from __future__ import annotations

import numpy as np

__all__ = ["einsum_flops", "als_sweeps_flops", "cn_step_flops",
           "gram_chain_flops", "round_gram_flops"]


def einsum_flops(expr: str, *shapes) -> float:
    """FLOPs of ``np.einsum(expr, ...)`` along the optimal pairwise path.

    Every pairwise contraction is costed ``2 * prod(union-of-index dims)``
    (multiply + add); our einsums all contract at least one index.
    """
    arrs = [np.lib.stride_tricks.as_strided(np.zeros(1), s, (0,) * len(s))
            for s in shapes]
    # unlimited intermediate memory: np's default caps intermediates at the
    # largest input and then refuses to decompose; jnp.einsum decomposes
    # pairwise, which is what the compiled programs actually execute
    path, _ = np.einsum_path(expr, *arrs, optimize=("optimal", 1e30))
    assert path[0] == "einsum_path"
    inputs, _ = expr.replace(" ", "").split("->")
    terms = inputs.split(",")
    dims: dict[str, int] = {}
    for t, s in zip(terms, shapes):
        for c, d in zip(t, s):
            dims[c] = d
    total = 0.0
    for contraction in path[1:]:
        picked = [terms[i] for i in contraction]
        for i in sorted(contraction, reverse=True):
            terms.pop(i)
        union = set("".join(picked))
        total += 2.0 * float(np.prod([dims[c] for c in union]))
        # result term keeps indices still needed downstream
        keep = union & (set("".join(terms)) | set(expr.split("->")[1]))
        terms.append("".join(sorted(keep)))
    return total


def als_sweeps_flops(d: int, R: int, RA: int, Rb: int, n: int = 2,
                     sweep_count: int = 2, cg_iters: int = 32) -> float:
    """Contraction FLOPs of one :func:`ttnx.solvers.als_scan.als_sweeps`
    call with the matrix-free CG local solver."""
    env_A = einsum_flops("aip,Wijw,bjq,pwq->aWb",
                         (R, n, R), (RA, n, n, RA), (R, n, R), (R, RA, R))
    env_b = einsum_flops("aip,uiv,pv->au", (R, n, R), (Rb, n, Rb), (R, Rb))
    rhs = einsum_flops("au,uiv,cv->aic", (R, Rb), (Rb, n, Rb), (R, Rb))
    apply_k = einsum_flops("aWb,WiJw,cwd,bJd->aic",
                           (R, RA, R), (RA, n, n, RA), (R, RA, R), (R, n, R))
    absorb = einsum_flops("ab,bnc->anc", (R, R), (R, n, R))
    env_build = d * (env_A + env_b)          # right or left env stack
    half = ((d - 1) * (rhs + cg_iters * apply_k + env_A + env_b)
            + absorb)                         # one half sweep
    return sweep_count * (env_build + half)


def gram_chain_flops(d: int, RB: int, n: int = 2) -> float:
    """Backward right-Gram sweep of a padded ``(d, RB, n, RB)`` chain
    (:func:`ttnx.solvers.round_scan._gram_chain_xla`): per site,
    ``n`` pairs of ``(RB,RB)@(RB,RB)`` matmuls."""
    return (d - 1) * n * 2 * (2.0 * RB ** 3)


def round_gram_flops(d: int, RB: int, R_out: int, n: int = 2) -> float:
    """Contraction FLOPs of :func:`ttnx.solvers.round_scan.tt_round_gram`
    on a ``(d, RB, n, RB)`` chain truncated to ``R_out`` (eigh excluded)."""
    absorb = einsum_flops("ab,bnc->anc", (R_out, RB), (RB, n, RB))
    B_asm = einsum_flops("ab,bc,xc->ax",
                         (R_out * n, RB), (RB, RB), (R_out * n, RB))
    T_new = 2.0 * R_out * (R_out * n) * RB
    return (gram_chain_flops(d, RB, n)
            + (d - 1) * (absorb + B_asm + T_new) + absorb)


def cn_step_flops(d: int, R: int, RA_lhs: int, RA_rhs: int, n: int = 2,
                  sweep_count: int = 2, cg_iters: int = 32) -> float:
    """Contraction FLOPs of one production Crank–Nicolson step
    (:func:`ttnx.solvers.round_scan.cn_step` with ``round_method=
    'gram_chain'`` and the matrix-free CG ALS solver): padded MPO apply +
    Gram-chain rounding + ``sweep_count`` ALS half-sweeps."""
    RB = RA_rhs * R
    matvec = einsum_flops("kaijb,kcjd->kacibd",
                          (d, RA_rhs, n, n, RA_rhs), (d, R, n, R))
    return (matvec + round_gram_flops(d, RB, R, n)
            + als_sweeps_flops(d, R, RA_lhs, R, n, sweep_count, cg_iters))
