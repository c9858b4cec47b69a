"""The one place that decides which backend runs a hand-written kernel.

Decisions are made at trace time from static shapes, dtypes and the default
backend, so a jitted solver bakes in exactly one path. Everything not named
here runs as plain XLA on every backend.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["use_triton_cg"]


def use_triton_cg(dtype, R: int) -> bool:
    """True where the ALS local CG runs as the Triton kernel
    (:mod:`ttnx.kernels.cg_triton`): on a GPU, in real f32, at bond rank
    16. On an H100 the kernel beat the XLA CG end to end at R=16 (the d=12
    CN step) and lost from R=32 up, where one program per problem is too
    slow a unit of work (PERF.md, Kernel findings)."""
    return (jax.default_backend() == "gpu"
            and jnp.dtype(dtype) == jnp.float32
            and R == 16)
