"""Iterative exact-GP regression: CG quadratic term + stochastic Lanczos
quadrature log-det, on streaming kernel matvecs.

The reference's "Iterative GP" baseline is gpytorch's ExactGP marginal
log-likelihood — internally CG + Lanczos with Hutchinson trace estimation on
KeOps matvecs (consumed at cglb/backend/pytorch/interface.py:326-442; the
machinery itself lives in gpytorch, SURVEY.md section 2.9).  This module is
the first-party equivalent:

    lml ~= -0.5 y^T alpha - 0.5 logdet_SLQ - N/2 log 2pi
    alpha      : CG solve of (K + s2 I) alpha = y        (streaming matvec)
    logdet_SLQ : (N/P) sum_i e1^T log(T_i) e1            (batched Lanczos)

Gradients use the detached-solve surrogate (the same construction gpytorch
uses): with alpha and probe solves W = K^-1 Z detached,

    d lml / dtheta = 0.5 alpha^T dK alpha - 0.5 (1/P) sum_i w_i^T dK z_i

realized by assembling differentiable surrogate terms from the streaming
matvec and offsetting their values so the forward number comes from SLQ.

Prediction: posterior mean via a CG solve; posterior variance via the
rank-t Lanczos (LOVE-style) approximation K^-1 ~= Q T^-1 Q^T, i.e.
var(s) ~= k_ss - || T^{-1/2} Q^T k_sf ||^2 (gpytorch fast_pred_var analogue,
reference: pytorch/interface.py:582).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ..struct import pytree_dataclass, static_field
from ..ops import cg as _cg
from ..ops import kernels as _k
from ..ops import operators as _op
from ..ops import preconditioners as _pc
from .gaussian import mean_apply, predict_log_density
from .gpr import GPRParams

__all__ = ["IterGPConfig", "iterative_lml", "iterative_loss", "lanczos",
           "slq_logdet", "predict_f_iterative"]


@pytree_dataclass
class IterGPConfig:
    """Knobs for the iterative objective (gpytorch-ish defaults)."""

    num_probes: int = static_field(default=10)
    lanczos_steps: int = static_field(default=25)
    cg_tolerance: float = static_field(default=1e-4)
    max_cg_iters: int = static_field(default=200)
    pred_lanczos_steps: int = static_field(default=64)


def lanczos(matvec: Callable, V0: jnp.ndarray, steps: int,
            reorth: bool = False
            ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Batched Lanczos tridiagonalization of the SPD operator.

    V0: [P, N] start vectors (need not be normalized).
    Returns (alphas [P, t], betas [P, t-1], Q [t, P, N]) with
    K ~= Q^T T Q per probe.

    reorth=True does full reorthogonalization against all stored vectors —
    required when t approaches the operator's effective rank (the LOVE-style
    variance path); plain three-term recurrence suffices for SLQ log-dets.
    """
    P, N = V0.shape
    t = steps
    norms = jnp.linalg.norm(V0, axis=1, keepdims=True)
    q = V0 / norms

    def body(carry, idx):
        Qbuf, q_prev, q_cur, beta_prev = carry
        Qbuf = Qbuf.at[idx].set(q_cur)
        w = matvec(q_cur)  # [P, N]
        alpha = jnp.sum(w * q_cur, axis=1)  # [P]
        w = w - alpha[:, None] * q_cur - beta_prev[:, None] * q_prev
        if reorth:
            # project out every stored vector (rows past idx are zero)
            coeffs = jnp.einsum("tpn,pn->tp", Qbuf, w)
            w = w - jnp.einsum("tp,tpn->pn", coeffs, Qbuf)
        beta = jnp.linalg.norm(w, axis=1)  # [P]
        q_next = w / jnp.maximum(beta, 1e-300)[:, None]
        return (Qbuf, q_cur, q_next, beta), (alpha, beta)

    Qbuf0 = jnp.zeros((t, P, N), dtype=V0.dtype)
    init = (Qbuf0, jnp.zeros_like(q), q, jnp.zeros((P,), dtype=V0.dtype))
    (Qbuf, _, _, _), (alphas, betas) = jax.lax.scan(
        body, init, jnp.arange(t)
    )
    # alphas [t, P] -> [P, t]; betas likewise (last beta unused)
    return alphas.T, betas[:-1].T, Qbuf


def _tridiag_logquad(alphas, betas):
    """e1^T log(T) e1 per probe via eigendecomposition of the t x t tridiag."""
    P, t = alphas.shape

    def per_probe(a, b):
        T = jnp.diag(a) + jnp.diag(b, 1) + jnp.diag(b, -1)
        evals, evecs = jnp.linalg.eigh(T)
        evals = jnp.maximum(evals, 1e-300)
        w = evecs[0, :] ** 2
        return jnp.sum(w * jnp.log(evals))

    return jax.vmap(per_probe)(alphas, betas)  # [P]


def slq_logdet(matvec: Callable, N: int, key, num_probes: int,
               steps: int, dtype) -> jnp.ndarray:
    """Stochastic Lanczos quadrature estimate of log|K| (Rademacher probes)."""
    Z = jax.random.rademacher(key, (num_probes, N), dtype=dtype)
    alphas, betas, _ = lanczos(matvec, Z, steps)
    quads = _tridiag_logquad(alphas, betas)  # e1^T log(T) e1, unit start
    # ||z||^2 = N for Rademacher probes
    return jnp.mean(quads) * N


class IterAux(NamedTuple):
    alpha: jnp.ndarray       # [D, N] solve of (K+s2I) alpha = err^T
    cg_steps: jnp.ndarray
    logdet: jnp.ndarray


def iterative_lml(params: GPRParams, X, Y, key,
                  cfg: IterGPConfig = IterGPConfig()
                  ) -> Tuple[jnp.ndarray, IterAux]:
    """Estimated exact-GP log marginal likelihood with surrogate gradients."""
    N, D = Y.shape
    sigma_sq = params.noise_variance.value
    err = Y - mean_apply(params.mean, X)
    err_t = err.T  # [D, N]
    matvec = _op.make_dense_operator(params.kernel, X, sigma_sq) \
        if N <= 4096 else None
    if matvec is None:
        from ..ops import matvec_pallas as _mvp

        matvec = _mvp.make_streaming_operator(params.kernel, X, sigma_sq)

    # ---- detached solves ----
    sg_matvec = lambda p: jax.lax.stop_gradient(matvec(jax.lax.stop_gradient(p)))
    alpha, stats = _cg.preconditioned_cg(
        sg_matvec, err_t, jnp.zeros_like(err_t), _pc.IdentityPreconditioner(),
        max_error=cfg.cg_tolerance, max_iters=cfg.max_cg_iters,
    )
    key_z, _ = jax.random.split(key)
    Z = jax.random.rademacher(key_z, (cfg.num_probes, N), dtype=X.dtype)
    W, _ = _cg.preconditioned_cg(
        sg_matvec, Z, jnp.zeros_like(Z), _pc.IdentityPreconditioner(),
        max_error=cfg.cg_tolerance, max_iters=cfg.max_cg_iters,
    )
    logdet_val = jax.lax.stop_gradient(
        slq_logdet(sg_matvec, N, key_z, cfg.num_probes, cfg.lanczos_steps,
                   X.dtype)
    )

    # ---- differentiable surrogates (detached solves, live kernel) ----
    # quad: value = 2 y^T a - a^T K a ~= y^T K^-1 y ; grad = -a^T dK a
    Kalpha = matvec(alpha)
    quad_sur = 2.0 * jnp.sum(err_t * alpha) - jnp.sum(alpha * Kalpha)
    # logdet: value offset to the SLQ estimate; grad = (1/P) sum w^T dK z
    KZ = matvec(Z)
    tr_sur = jnp.mean(jnp.sum(W * KZ, axis=1)) * 1.0
    logdet_sur = logdet_val + (tr_sur - jax.lax.stop_gradient(tr_sur))

    lml = -0.5 * quad_sur - 0.5 * D * logdet_sur \
        - 0.5 * N * D * math.log(2.0 * math.pi)
    aux = IterAux(alpha=alpha, cg_steps=stats.steps, logdet=logdet_val)
    return lml, aux


def iterative_loss(params: GPRParams, X, Y, key,
                   cfg: IterGPConfig = IterGPConfig()):
    lml, aux = iterative_lml(params, X, Y, key, cfg)
    return -lml, aux


def predict_f_iterative(params: GPRParams, X, Y, Xnew,
                        cfg: IterGPConfig = IterGPConfig(),
                        key=None) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Posterior mean via CG; variance via rank-t Lanczos (LOVE-style)."""
    from ..ops import matvec_pallas as _mvp

    N, D = Y.shape
    sigma_sq = params.noise_variance.value
    err = Y - mean_apply(params.mean, X)
    big = N > 4096
    if big:
        matvec = _mvp.make_streaming_operator(params.kernel, X, sigma_sq)
        cross = lambda p: _mvp.kernel_cross_matvec(params.kernel, X, Xnew, p)
    else:
        matvec = _op.make_dense_operator(params.kernel, X, sigma_sq)
        Ksf_d = _k.K(params.kernel, Xnew, X)
        cross = lambda p: p @ Ksf_d.T

    alpha, _ = _cg.preconditioned_cg(
        matvec, err.T, jnp.zeros_like(err.T), _pc.IdentityPreconditioner(),
        max_error=cfg.cg_tolerance * 1e-2, max_iters=cfg.max_cg_iters,
    )
    f_mean = cross(alpha).T + mean_apply(params.mean, Xnew)  # [S, D]

    # LOVE-style variance: K^-1 ~= Q^T T^-1 Q from a single Lanczos run
    # started at the (normalized) training error direction.
    t = min(cfg.pred_lanczos_steps, N)
    v0 = err.T[:1]
    alphas, betas, Qs = lanczos(matvec, v0, t, reorth=True)
    a, b = alphas[0], betas[0]
    T = jnp.diag(a) + jnp.diag(b, 1) + jnp.diag(b, -1)
    evals, evecs = jnp.linalg.eigh(T)
    evals = jnp.maximum(evals, 1e-12)
    Q = Qs[:, 0, :]  # [t, N]
    # R = T^{-1/2} Q : var(s) = kss - || R ksf ||^2
    Rm = (evecs / jnp.sqrt(evals)[None, :]).T @ Q  # [t, N]
    RK = cross(Rm)  # [t, S]
    kss = _k.kdiag(params.kernel, Xnew)
    var = jnp.maximum(kss - jnp.sum(RK * RK, axis=0), 1e-12)
    var = jnp.tile(var[:, None], (1, D))
    return f_mean, var


def iterative_predict_log_density(params: GPRParams, X, Y, Xnew, Ynew,
                                  cfg: IterGPConfig = IterGPConfig()):
    f_mean, f_var = predict_f_iterative(params, X, Y, Xnew, cfg)
    return predict_log_density(f_mean, f_var, params.noise_variance.value, Ynew)
