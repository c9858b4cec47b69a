"""Interpolative QTT construction (Lagrange / multiscale bridge).

Replacement for the external ``InterpolativeQTT.jl`` package the
reference bridges to (``ext/TensorTrainNumericsInterpolativeQTTExt``,
``/root/reference/examples/highly_oscillatory.jl``): build a QTT of a 1-D
function WITHOUT sampling the full ``2^d`` grid, by Chebyshev–Lagrange
interpolation of the dyadic tail.

With ``x = 0.sigma_1 sigma_2 ...`` and tail ``t_k = 0.sigma_{k+1}...``, the
recursion ``t_{k-1} = (sigma_k + t_k) / 2`` turns barycentric interpolation
``f(x) ~ sum_a l_a(t) f(node_a)`` into an exact TT of rank N:

    core 1  [1, s, b] = f((s + c_b) / 2)          (scaled to [a, b])
    core k  [a, s, b] = l_a((s + c_b) / 2)
    core d  [a, s, 1] = l_a(s / 2)

— the same cascade as the quantics DFT cores (``ops/fourier.py``). Cost is
``O(d * N^2)`` evaluations of the Lagrange basis plus ``2N`` evaluations of
``f``; rank N resolves any function whose Chebyshev interpolant on N nodes
does (for multiscale/oscillatory f choose N above the local oscillation
count).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import jax.numpy as jnp

from ttnx.core.tt import TTVector
from ttnx.ops.fourier import _lagrange_eval_matrix, cheb_lobatto_lagrange

__all__ = ["interpolating_qtt", "lagrange_rank_revealing"]


def interpolating_qtt(f: Callable, num_cores: int, N: int,
                      a: float = 0.0, b: float = 1.0) -> TTVector:
    """Rank-N QTT of ``f`` on the dyadic grid ``x_i = a + (b-a) * i / 2^d``
    via Chebyshev–Lobatto Lagrange interpolation (InterpolativeQTT's
    ``interpolating_qtt``; see module docstring for the construction)."""
    if num_cores < 2:
        raise ValueError("num_cores must be >= 2")
    if N < 2:
        raise ValueError("N (number of interpolation nodes) must be >= 2")
    grid, w = cheb_lobatto_lagrange(N - 1)           # N nodes on [0, 1]
    sigma = np.array([0.0, 1.0])
    xs = 0.5 * (sigma[:, None] + grid[None, :])      # (2, N)

    fvals = np.asarray(f(a + (b - a) * xs))          # (2, N)
    first = fvals[None]                              # (1, 2, N)
    Lmid = _lagrange_eval_matrix(grid, w, xs.reshape(-1)).reshape(N, 2, N)
    Llast = _lagrange_eval_matrix(grid, w, 0.5 * sigma).reshape(N, 2, 1)

    cores = [jnp.asarray(first)]
    cores.extend(jnp.asarray(Lmid) for _ in range(num_cores - 2))
    cores.append(jnp.asarray(Llast))
    return TTVector(cores)


def lagrange_rank_revealing(f: Callable, num_cores: int, N: int,
                            a: float = 0.0, b: float = 1.0,
                            rel_tol: float = 1e-12,
                            max_bond: int | None = None) -> TTVector:
    """Interpolative QTT followed by rank-revealing truncation
    (InterpolativeQTT's ``lagrange_rank_revealing``): the Lagrange cascade
    is built at full rank N, then ``tt_round`` exposes the true numerical
    ranks of ``f`` under ``rel_tol``."""
    from ttnx.core.canonical import tt_round

    tt = interpolating_qtt(f, num_cores, N, a=a, b=b)
    return tt_round(tt, max_bond=max_bond, rel_tol=rel_tol)
