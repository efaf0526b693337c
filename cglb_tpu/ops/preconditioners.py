"""Preconditioners for the kernel-system CG solve.

Nystrom/Woodbury preconditioner ``P = (Qff + sigma^2 I)^-1`` applied as
``P r = (r - A^T (L_B L_B^T)^-1 A r) / sigma^2`` where ``A = L^-1 Kuf / sigma`` and
``L_B = chol(A A^T + I)`` — two [M, .] triangular solves and two [M, N] matmuls, no
N x N work (reference semantics: cglb/backend/tensorflow/preconditioners.py:36-89,
cglb/backend/pytorch/conjugate_gradient.py:89-113).

Represented as pytree dataclasses so they can live inside jitted/while_loop'd code.
``mat_vec`` operates on row-stacked vectors r of shape [B, N] and returns
``(P r, per-column r^T P r)``.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl

from ..struct import pytree_dataclass

__all__ = ["IdentityPreconditioner", "NystromPreconditioner", "mat_vec"]


@pytree_dataclass
class IdentityPreconditioner:
    pass


@pytree_dataclass
class NystromPreconditioner:
    A: jnp.ndarray        # [M, N]
    LB: jnp.ndarray       # [M, M], lower
    sigma_sq: jnp.ndarray  # []
    # optional LB^-1: when present, every apply is matmul-only (no [M, M]
    # triangular solve inside the CG loop).  Forward error is eps*kappa(B)
    # either way (a backward-stable trisolve has the same FORWARD envelope),
    # and the sum-of-squares rz below is nonnegative by construction
    # regardless.
    Ci: jnp.ndarray = None


def mat_vec(precond, r: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Apply the preconditioner to row-vectors r [B, N].

    Returns (z, rz) with z = P r (shape [B, N]) and rz[b] = r_b^T P r_b (shape [B]).

    The apply runs in A's dtype: constructing the preconditioner with
    f32-cast A/LB halves the bytes the per-CG-iteration [M, N] contractions
    read — preconditioning quality and the stopping/error terms tolerate
    1e-7 relative noise.  Every product asks for HIGHEST, so an f32 apply
    never runs in TF32.  Inputs/outputs stay in r's dtype.
    """
    if isinstance(precond, IdentityPreconditioner):
        return r, jnp.sum(r * r, axis=-1)
    if isinstance(precond, NystromPreconditioner):
        A, LB, sigma_sq = precond.A, precond.LB, precond.sigma_sq
        hi = jax.lax.Precision.HIGHEST
        rt = r.astype(A.dtype).T  # [N, B]
        Ar = jnp.dot(A, rt, precision=hi)  # [M, B]
        if precond.Ci is not None:
            u = jnp.dot(precond.Ci, Ar, precision=hi)
            w = jnp.dot(precond.Ci.T, u, precision=hi)
        else:
            u = jsl.solve_triangular(LB, Ar, lower=True)
            w = jsl.solve_triangular(LB.T, u, lower=False)
        rv = rt - jnp.dot(A.T, w, precision=hi)  # [N, B]
        # r^T Qhat^-1 r via the sum-of-squares identity: with w = B^-1 A r and
        # rv = r - A^T w one has A rv = Ar - (B - I) w = w, hence
        #   r^T Qhat^-1 r = (rv^T Qhat rv)/sigma^4 = (||rv||^2 + ||w||^2)/s2.
        # The naive sum(rv * rt) is a catastrophic cancellation when r lies
        # mostly in Qhat's range (||P r|| << ||r||): its fp error ~eps ||r||^2
        # went hugely NEGATIVE at line-search extremes, short-circuiting CG's
        # stopping rule and exploding the error-bound term (caught end-to-end
        # on snelson1d).  This form is exact and nonnegative by construction.
        rz = jnp.sum(rv * rv, axis=0) + jnp.sum(w * w, axis=0)  # [B]
        z = rv.T.astype(r.dtype) / sigma_sq
        return z, rz.astype(r.dtype) / sigma_sq
    raise NotImplementedError(type(precond))


def inv_mat_vec(precond: NystromPreconditioner, r: jnp.ndarray) -> jnp.ndarray:
    """(Qff + sigma^2 I) r for row-vectors r [B, N] (the inverse operator of
    mat_vec; reference: preconditioners.py:79-84)."""
    A, sigma_sq = precond.A, precond.sigma_sq
    hi = jax.lax.Precision.HIGHEST
    rt = r.T * sigma_sq
    Ar = jnp.dot(A, rt, precision=hi)
    return (jnp.dot(A.T, Ar, precision=hi) + rt).T


def sqrt_factor_mat_vec(precond: NystromPreconditioner, w: jnp.ndarray
                        ) -> jnp.ndarray:
    """Action of a square-root factor S of (Qff + sigma^2 I) = S S^T, with
    S = sigma [A^T | I]  of shape [N, M+N]:  w [B, M+N] -> (S w^T)^T [B, N].

    (The reference sketches this as `inv_sqrt_mat_vec` at
    preconditioners.py:86-89 but that code is unreachable and shape-
    inconsistent; this is the corrected operation, useful for sampling from
    the Nystrom-approximate prior.)"""
    A, sigma_sq = precond.A, precond.sigma_sq
    sigma = jnp.sqrt(sigma_sq)
    m = A.shape[0]
    w_m, w_n = w[:, :m], w[:, m:]
    return sigma * (w_m @ A + w_n)
