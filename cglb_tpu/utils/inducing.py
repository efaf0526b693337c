"""Greedy ConditionalVariance inducing-point selection.

First-party replacement for robustgp.ConditionalVariance (consumed by the
reference at cglb/backend/config.py:62-65 through a numpy kernel bridge,
cglb/backend/pytorch/interface.py:278-288).  Greedily picks the point with the
largest conditional (posterior) variance given the points chosen so far —
equivalent to pivoted Cholesky on K(X, X) with greedy pivoting.

Two implementations:
- ``conditional_variance_numpy``: host-side oracle, mirrors the classic algorithm.
- ``conditional_variance``: device version — the per-step kernel-column evaluation
  and rank-1 variance update run under jit with a ``lax.fori_loop`` carry, so the
  O(N M^2) scoring runs on the device (the reference's is all-host; SURVEY.md flags it as
  a setup-time bottleneck at large N).

Both permute the inputs with the process seed first (the upstream algorithm does;
argmax ties then break randomly rather than by index).
"""

from __future__ import annotations

from typing import Callable, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["conditional_variance", "conditional_variance_numpy"]


def conditional_variance_numpy(
    X: np.ndarray,
    M: int,
    kernel_diag: Callable[[np.ndarray], np.ndarray],
    kernel_cross: Callable[[np.ndarray, np.ndarray], np.ndarray],
    seed: int = 0,
    jitter: float = 1e-12,
) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy max-conditional-variance selection (host-side).

    Args:
        X: [N, D] candidate points.
        kernel_diag: X -> diag K(X, X), shape [N].
        kernel_cross: (X, z[1,D]) -> K(X, z), shape [N, 1].
    Returns:
        (Z [M, D], indices into the original X [M])
    """
    N = X.shape[0]
    rng = np.random.default_rng(seed)
    perm = rng.permutation(N)
    Xp = X[perm]

    indices = np.zeros(M, dtype=np.int64)
    di = np.asarray(kernel_diag(Xp), dtype=np.float64) + jitter
    indices[0] = int(np.argmax(di))
    ci = np.zeros((M - 1, N), dtype=np.float64)
    for m in range(M - 1):
        j = int(indices[m])
        dj = np.sqrt(di[j])
        cj = ci[:m, j]
        Lcol = np.array(kernel_cross(Xp, Xp[j : j + 1]), dtype=np.float64)[:, 0]
        Lcol[j] += jitter
        ei = (Lcol - cj @ ci[:m]) / dj
        ci[m, :] = ei
        di = np.clip(di - ei * ei, 0.0, None)
        indices[m + 1] = int(np.argmax(di))
    Z = Xp[indices]
    return Z, perm[indices]


def conditional_variance(
    X,
    M: int,
    kernel,
    seed: int = 0,
    jitter: float = 1e-12,
) -> Tuple[np.ndarray, np.ndarray]:
    """Device-accelerated greedy selection for a cglb_tpu kernel pytree.

    The whole selection (M steps of column evaluation + rank-1 downdate + argmax)
    runs as one jitted fori_loop; memory is the O(M N) pivot matrix in HBM.
    """
    from ..ops import kernels as _k

    X = np.asarray(X)
    N = X.shape[0]
    rng = np.random.default_rng(seed)
    perm = rng.permutation(N)
    Xp = jnp.asarray(X[perm])

    def _select(Xp, kernel):
        di0 = _k.kdiag(kernel, Xp) + jitter
        idx0 = jnp.zeros((M,), dtype=jnp.int32).at[0].set(
            jnp.argmax(di0).astype(jnp.int32)
        )
        ci0 = jnp.zeros((M - 1, N), dtype=Xp.dtype)

        def body(m, carry):
            di, ci, indices = carry
            j = indices[m]
            xj = jax.lax.dynamic_slice(
                Xp, (j, jnp.zeros((), dtype=j.dtype)), (1, Xp.shape[1])
            )
            Lcol = _k.K(kernel, Xp, xj)[:, 0]
            Lcol = Lcol.at[j].add(jitter)
            cj = ci[:, j]  # rows >= m are zero, so the dot spans only chosen rows
            dj = jnp.sqrt(di[j])
            ei = (Lcol - cj @ ci) / dj
            ci = ci.at[m].set(ei)
            di = jnp.clip(di - ei * ei, 0.0, None)
            indices = indices.at[m + 1].set(jnp.argmax(di).astype(jnp.int32))
            return (di, ci, indices)

        _, _, indices = jax.lax.fori_loop(0, M - 1, body, (di0, ci0, idx0))
        return indices

    indices = np.asarray(jax.jit(_select)(Xp, kernel))
    Z = X[perm][indices]
    return Z, perm[indices]
