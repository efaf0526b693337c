"""Fused Cholesky primitives whose backward passes are pure matmuls.

Factor once, invert once, and never solve again:

    chol_inv(P)        -> (L, C)   L = chol(P), C = L^-1
    chol_inv_retry(P,j) -> (L, C)  same, with the 1000x-jitter retry folded
                                   into ONE cholesky instance (lax.while_loop)

With the explicit triangular inverse C in hand, every downstream "solve with
L" is a matmul (C @ rhs), and — the key part — the Cholesky VJP itself needs
only matmuls:

    P_bar = 0.5 C^T (Phi + Phi^T) C,   Phi = phi(L^T L_bar),

(phi = lower triangle with halved diagonal; Murray 2016, "Differentiation
of the Cholesky decomposition", eq. 8 — the L^-1 factors usually applied by
trisolves are exactly C).  The inverse output's cotangent folds in as
L_bar += -C^T C_bar C^T.  So each fused call costs one factorization and one
triangular solve in the forward and none in the backward.  The forward is
XLA's native ``cholesky`` / ``triangular_solve`` (cuSOLVER on the GPU).

Numerics: C carries eps*kappa(L) relative error (backward-stable solve
against I), so C-based products inherit the same eps*kappa^2 envelope as
the trisolve sandwich they replace (models/sgpr._gram_terms docstring);
with the 1e-6 jitter floor that is <=1e-10 relative on AAT in fp64 —
asserted against the trisolve path in tests/test_chol64.py.

Gradient convention: ``jnp.linalg.cholesky`` reads only the lower triangle
but JAX's JVP symmetrizes the tangent, making the VJP cotangent symmetric;
we return the symmetrized P_bar, which matches ``jax.grad`` of the native
op to roundoff for symmetric inputs (asserted in tests).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl
from jax import lax

__all__ = ["chol_inv", "chol_inv_retry"]


def _tri_inv(L):
    return jsl.solve_triangular(
        L, jnp.eye(L.shape[0], dtype=L.dtype), lower=True
    )


def _phi(X):
    """Lower triangle with halved diagonal (the Cholesky-derivative mask)."""
    return jnp.tril(X) - 0.5 * jnp.diag(jnp.diagonal(X))


def _chol_bwd_matmul(L, C, dL, dC):
    """Shared backward: cotangents (dL, dC) -> symmetric dP, matmuls only.

    Every product asks for Precision.HIGHEST: for f32 inputs (the
    preconditioner's factorization, models/cglb._make_precond) a default-
    precision product runs in TF32 on the GPU, and the backward sandwiches
    the cotangent between C = L^-1 twice, amplifying that error with
    kappa(P).  fp64 products are unaffected by the setting."""
    mm = lambda a, b: jnp.dot(a, b, precision=lax.Precision.HIGHEST)
    # C = L^-1: <dC, -C dL C> = <-C^T dC C^T, dL>
    gL = dL - mm(C.T, mm(dC, C.T))
    Phi = _phi(mm(L.T, gL))
    return mm(C.T, mm(0.5 * (Phi + Phi.T), C))


@jax.custom_vjp
def chol_inv(P):
    """(chol(P), chol(P)^-1) with a matmul-only VJP.

    The inverse is computed by ONE triangular-solve pass; callers that only
    consume L (no grad) get it DCE'd by XLA."""
    L = jnp.linalg.cholesky(P)
    return L, _tri_inv(L)


def _chol_inv_fwd(P):
    out = chol_inv(P)
    return out, out


def _chol_inv_bwd(res, cot):
    L, C = res
    dL, dC = cot
    return (_chol_bwd_matmul(L, C, dL, dC),)


chol_inv.defvjp(_chol_inv_fwd, _chol_inv_bwd)


def chol_inv_retry(P, jitter: float):
    """(L, C) for chol(P + jitter*I), retrying once at 1000x jitter if the
    factorization goes non-finite (clustered inducing points mid-
    optimization; same two-attempt policy as models/sgpr._kuu_chol had).

    The retry lives in a ``lax.while_loop`` so the graph contains exactly
    ONE cholesky instead of two cond branches.  custom_vjp makes
    the while_loop reverse-differentiable: the gradient is that of a single
    factorization at the jitter that was actually used (the same as the old
    cond-based gradient through the selected branch)."""
    return _chol_inv_retry(P, float(jitter))


@partial(jax.custom_vjp, nondiff_argnums=(1,))
def _chol_inv_retry(P, jitter):
    eye = jnp.eye(P.shape[0], dtype=P.dtype)

    def body(carry):
        jmul, _ = carry
        L = jnp.linalg.cholesky(P + (jmul * jitter) * eye)
        ok = jnp.all(jnp.isfinite(jnp.diagonal(L)))
        # negative jmul marks success; cond() then exits
        return jnp.where(ok, -jmul, jmul * 1000.0), L

    def cond(carry):
        jmul = carry[0]
        return (jmul > 0) & (jmul <= 1000.0)

    _, L = lax.while_loop(
        cond, body, (jnp.asarray(1.0, P.dtype), jnp.zeros_like(P))
    )
    return L, _tri_inv(L)


def _chol_inv_retry_fwd(P, jitter):
    out = _chol_inv_retry(P, jitter)
    return out, out


def _chol_inv_retry_bwd(jitter, res, cot):
    L, C = res
    dL, dC = cot
    return (_chol_bwd_matmul(L, C, dL, dC),)


_chol_inv_retry.defvjp(_chol_inv_retry_fwd, _chol_inv_retry_bwd)
