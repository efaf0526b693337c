"""CGLB: lower bound on the GP log marginal likelihood via preconditioned CG.

Implements the objective of Artemev, Burt & van der Wilk (ICML 2021) as pure,
jittable functions (reference semantics: cglb/backend/tensorflow/models.py:31-350,
cglb/backend/pytorch/models.py:104-286):

    bound = -0.5 N D log 2pi                                 (constant)
          + logdet_bound                                     (Jensen / NM2 / N2M)
          - ub                                               (CG quad-form bound)

    quad:  v* ~= (K + sigma^2 I)^-1 err via warm-started preconditioned CG,
           lb = sum v (r + 0.5 K v),  ub = lb + 0.5 r^T P r,
           with v detached (implicit treatment: gradients only flow through the
           differentiable re-assembly, formalizing tf.stop_gradient /
           torch.no_grad in the reference).

Functional state: the CG warm start ``v0`` ([D, N]) is an explicit input/output
instead of a mutable model variable (reference mutates self.v0 at models.py:172);
training loops thread it through their carry.  This keeps every feval a pure
function — XLA compiles it once and reuses it across all L-BFGS evaluations.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import jax.numpy as jnp
import jax.scipy.linalg as jsl

from ..struct import pytree_dataclass, static_field
from ..ops import kernels as _k
from ..ops import cg as _cg
from ..ops import operators as _op
from ..ops import preconditioners as _pc
from .gaussian import mean_apply, predict_log_density
from .sgpr import (SGPRParams, CommonTerms, common_terms,
                   REMAT_THRESHOLD_ELEMENTS)

__all__ = ["CGLBConfig", "CGLBAux", "loss", "bound", "predict_f",
           "cglb_predict_log_density", "init_v0", "PredictCache",
           "predict_prepare", "predict_from_cache"]

LOGDET_VARIANTS = ("jensen", "n2m", "nm2")


@pytree_dataclass
class CGLBConfig:
    """Static CGLB knobs (reference defaults: tensorflow/models.py:32-56,
    pytorch/conjugate_gradient.py:37-39, config.py:110-121)."""

    max_error: float = static_field(default=1.0)
    max_cg_iters: int = static_field(default=100)
    restart_cg_iters: int = static_field(default=40)
    joint_optimization: bool = static_field(default=False)
    vzero: bool = static_field(default=False)
    logdet_variant: str = static_field(default="jensen")
    # dtype of the Nystrom preconditioner apply inside CG: float32 halves the
    # bytes of the per-iteration [M, N] contractions; preconditioning
    # tolerates the 1e-7 noise.  Set "float64" for bitwise-fp64 paths.
    precond_dtype: str = static_field(default="float32")
    # "mixed" (default): fp64 distance assembly + two-float-f32 kernel profile
    # (ops/df32, ~1e-11/entry) + gram-form fp64 matmuls in place of the
    # [M, N] trisolve (models/sgpr._gram_terms).  "float64": all-fp64
    # (chunked at scale), for bitwise reference semantics.
    common_dtype: str = static_field(default="mixed")

    @property
    def v_is_external(self) -> bool:
        """True when v is not produced by CG (vzero or jointly-optimized v)."""
        return self.joint_optimization or self.vzero


class CGLBAux(NamedTuple):
    v: jnp.ndarray               # [D, N] new warm start
    cg_steps: jnp.ndarray        # int32 []
    cg_residual_error: jnp.ndarray  # []


def init_v0(N: int, output_dim: int = 1, dtype=None) -> jnp.ndarray:
    from .. import config as _config

    return jnp.zeros((output_dim, N), dtype=dtype or _config.default_float())


def _logdet_bound(params: SGPRParams, ct: CommonTerms, X, Y,
                  variant: str) -> jnp.ndarray:
    """Upper bounds on 0.5 log|K + sigma^2 I| (negated), three variants."""
    N, D = Y.shape
    sigma_sq = params.noise_variance.value
    kd = _k.kdiag(params.kernel, X)
    # residual trace  tr(K - Q)/sigma^2  >= 0 mathematically; as Q -> K (large
    # M, well-fit inducing points) the subtraction cancels catastrophically and
    # can go slightly negative, turning log(1 + trace/N) into NaN mid-training.
    # Clamping at 0 keeps the bound valid (true trace >= 0).
    trace = jnp.maximum(jnp.sum(kd) / sigma_sq - jnp.trace(ct.AAT), 0.0)
    logdiag_LB = jnp.sum(jnp.log(jnp.diagonal(ct.LB)))

    if variant == "jensen":
        # log|K+s2I| <= log|Q+s2I| + N log(1 + tr(K-Q)/(s2 N))
        # (reference: tensorflow/models.py:77-105)
        log_det = -D * logdiag_LB
        log_det -= 0.5 * N * D * jnp.log(sigma_sq)
        log_det -= 0.5 * D * N * jnp.log(1.0 + trace / N)
        return log_det
    if variant == "nm2":
        # log|Q| + tr(K-Q)/sigma^2   (reference: models.py:270-308)
        log_det_q = logdiag_LB + 0.5 * N * jnp.log(sigma_sq)
        return -(log_det_q + 0.5 * trace)
    if variant == "n2m":
        # log|Q| + n log(tr(Q^-1 K)/n)  (reference: models.py:310-350); O(N^2).
        kff_s = _k.K(params.kernel, X) + sigma_sq * jnp.eye(N, dtype=X.dtype)
        C = jsl.solve_triangular(ct.LB, ct.A, lower=True)
        trace_kff = jnp.trace(kff_s)
        trace_qrest = jnp.trace((C @ kff_s) @ C.T)
        # trace_kff - trace_qrest >= N sigma^2 mathematically (K >= Qff);
        # clamp at that true minimum so catastrophic cancellation at large M
        # can neither NaN the log nor blow the N-scaled term up to inf
        log_trace = N * (
            jnp.log(jnp.maximum(trace_kff - trace_qrest, N * sigma_sq))
            - math.log(N) - jnp.log(sigma_sq)
        )
        log_det_q = logdiag_LB + 0.5 * N * jnp.log(sigma_sq)
        return -(log_det_q + 0.5 * log_trace)
    raise ValueError(f"unknown logdet variant {variant!r}")


def _make_precond(ct: CommonTerms, sigma_sq, cfg: CGLBConfig,
                  consistent_ct: bool = False):
    """Nystrom preconditioner in cfg.precond_dtype.

    LB is re-derived from the SAME cast A the preconditioner applies, not
    taken from ct: the Woodbury identity (I - A^T (A A^T + I)^-1 A)/s2 is
    only guaranteed positive when both factors describe the same A.  Mixing
    the fp64-accurate ct.LB with a lower-precision A made the quadratic form
    r^T P^-1 r go (hugely) negative at trained hyperparameters, silently
    short-circuiting CG's stopping rule — caught driving the CLI end-to-end.
    One extra [M, N]x[N, M] matmul + [M, M] cholesky per objective, outside
    the CG loop.

    consistent_ct: the caller vouches that ct.LB was computed as
    chol(ct.A @ ct.A^T + I) from EXACTLY this A (true for the _kuf_terms
    fp64 path, false for the gram path whose LB comes from the
    L^-1 G L^-T sandwich) — only then, and only with matching dtype, is
    ct.LB reused instead of re-derived.  Dtype equality alone is not
    enough: a gram-path run with precond_dtype='float64' has fp64 A and
    fp64 LB that differ at eps64*kappa(L)^2, which the Woodbury identity
    amplifies by 1/sigma^2 at noise collapse."""
    import jax

    from ..ops.chol64 import chol_inv as _chol_inv

    pd = jnp.dtype(cfg.precond_dtype)
    if consistent_ct and ct.A.dtype == pd and ct.LB.dtype == pd:
        # ct.LBi (fp64 LB^-1 from the fused chol_inv) is consistent with
        # this LB by construction; it turns every CG-loop apply into matmuls
        return _pc.NystromPreconditioner(A=ct.A, LB=ct.LB, sigma_sq=sigma_sq,
                                         Ci=ct.LBi)
    A = ct.A.astype(pd)
    M = A.shape[0]
    # precision=HIGHEST: at the default precision an f32 matmul runs in TF32
    # on the GPU (~1e-3 relative), which would reintroduce the LB/A mismatch
    # this function exists to eliminate — with ||AAT|| ~ 1/sigma^2 the TF32
    # error exceeds the +I shift at small noise and the cholesky / Woodbury
    # identity breaks down (CPU runs compute f32 products in full precision
    # and cannot catch this).
    AAT = jnp.dot(A, A.T, precision=jax.lax.Precision.HIGHEST)
    # fused chol+inverse: matmul-only VJP, and Ci makes every CG-loop
    # preconditioner apply matmul-only (see NystromPreconditioner.Ci)
    LB, Ci = _chol_inv(AAT + jnp.eye(M, dtype=pd))
    return _pc.NystromPreconditioner(A=A, LB=LB, sigma_sq=sigma_sq, Ci=Ci)


def _quad_form_bound(params: SGPRParams, ct: CommonTerms, X, Y, v0,
                     cfg: CGLBConfig, matvec=None, max_error=None,
                     consistent_ct: bool = False
                     ) -> Tuple[jnp.ndarray, CGLBAux]:
    """-ub on 0.5 err^T (K+s2I)^-1 err, plus the new warm start.

    reference: tensorflow/models.py:150-173.
    """
    sigma_sq = params.noise_variance.value
    err = Y - mean_apply(params.mean, X)
    err_t = err.T  # [D, N]
    if matvec is None:
        matvec = _op.make_dense_operator(params.kernel, X, sigma_sq)
    P = _make_precond(ct, sigma_sq, cfg, consistent_ct=consistent_ct)

    if cfg.v_is_external:
        v = v0  # gradient may flow (joint optimization) or v0 is fixed zeros
        stats = _cg.CGStats(steps=jnp.asarray(0, jnp.int32),
                            residual_error=jnp.zeros((), dtype=X.dtype))
    else:
        me = cfg.max_error if max_error is None else max_error
        v, stats = _cg.preconditioned_cg(
            matvec, err_t, v0, P, me, cfg.max_cg_iters, cfg.restart_cg_iters
        )
        # preconditioned_cg already stop-gradients its result.

    Kv = matvec(v)
    r = err_t - Kv
    _, rz = _pc.mat_vec(P, r)
    error_bound = jnp.sum(rz)
    lb = jnp.sum(v * (r + 0.5 * Kv))
    ub = lb + 0.5 * error_bound
    aux = CGLBAux(v=v, cg_steps=stats.steps, cg_residual_error=stats.residual_error)
    return -ub, aux


# REMAT_THRESHOLD_ELEMENTS is re-exported from .sgpr (defined beside the
# chunked builders it gates) for existing callers of this module.


def bound(params: SGPRParams, X, Y, v0, cfg: CGLBConfig = CGLBConfig(),
          jitter: float = None, matvec: Optional[Callable] = None,
          remat_common_terms: Optional[bool] = None,
          max_error: Optional[jnp.ndarray] = None
          ) -> Tuple[jnp.ndarray, CGLBAux]:
    """The CGLB lower bound on log p(Y|X).  Returns (bound, aux).

    reference: tensorflow/models.py:175-192.
    max_error: optional TRACED override of cfg.max_error (a scalar jit
    argument), letting callers tighten the CG stopping tolerance at runtime
    without recompiling — the adaptive-tolerance optimizer schedule
    (utils/training.scipy_tol_minimize) rides on this.

    remat_common_terms: rematerialize Kuf/A/AAT in the backward pass instead
    of storing the O(N M) intermediates.  Default (None) decides by size
    (sgpr.REMAT_THRESHOLD_ELEMENTS): storing beats recomputing when it fits,
    and the gram-form mixed path stores little enough that kin40k-scale
    problems fit comfortably.
    Applied at the CHUNK level (jax.checkpoint on the lax.map body inside
    _gram_terms/_kuf_terms, which is always engaged above this threshold):
    a whole-function checkpoint is not enough, because its backward re-runs
    the chunked forward and then stores the full [M, N]-aggregate scan
    residuals anyway — the very allocation that OOMs at houseelectric scale.
    """
    N, D = Y.shape
    if remat_common_terms is None:
        remat_common_terms = N * params.num_inducing > REMAT_THRESHOLD_ELEMENTS
    mixed = cfg.common_dtype == "mixed"
    # the n2m logdet ablation consumes full-precision A [M, N]; the gram fast
    # path only materializes A in the preconditioner dtype
    gram = mixed and cfg.logdet_variant != "n2m"
    ct = common_terms(params, X, jitter, mixed=mixed, gram=gram,
                      a_dtype=jnp.dtype(cfg.precond_dtype),
                      remat=remat_common_terms)
    b = -0.5 * N * D * math.log(2.0 * math.pi)
    b += _logdet_bound(params, ct, X, Y, cfg.logdet_variant)
    quad, aux = _quad_form_bound(params, ct, X, Y, v0, cfg, matvec,
                                 consistent_ct=not gram, max_error=max_error)
    b += quad
    return b, aux


def loss(params: SGPRParams, X, Y, v0, cfg: CGLBConfig = CGLBConfig(),
         jitter: float = None, matvec: Optional[Callable] = None,
         max_error: Optional[jnp.ndarray] = None
         ) -> Tuple[jnp.ndarray, CGLBAux]:
    """Training loss = -bound; aux carries the CG warm start + stats."""
    b, aux = bound(params, X, Y, v0, cfg, jitter, matvec,
                   max_error=max_error)
    return -b, aux


class PredictCache(NamedTuple):
    """Batch-independent prediction state (PredictCG-cache parity: the
    reference caches common terms and the CG solution across metric
    evaluations and prediction batches — cglb/backend/pytorch/models.py:
    289-354 ``use_cache``/``cached_v_vec``, consumed at interface.py:607-658).
    One CG solve + one common-terms build serve every prediction batch."""

    v: jnp.ndarray   # [D, N] CG solution at the prediction tolerance
    c: jnp.ndarray   # [M, D] LB^-1 (A @ res) / sigma  (res = err - (K+s2)v)
    L: jnp.ndarray   # [M, M] chol(Kuu + jitter I)
    LB: jnp.ndarray  # [M, M]
    # optional inverses (mixed path): per-batch solves run as matmuls (see
    # models/sgpr.SGPRPredictCache)
    Li: jnp.ndarray = None
    LBi: jnp.ndarray = None


def predict_prepare(params: SGPRParams, X, Y, v0,
                    cfg: CGLBConfig = CGLBConfig(),
                    cg_tolerance: Optional[float] = 1e-3,
                    jitter: float = None,
                    matvec: Optional[Callable] = None,
                    mixed: bool = False) -> PredictCache:
    """Run the batch-independent prediction work ONCE: common terms, the CG
    solve at ``cg_tolerance`` (1e-3 default; None / vzero / joint reuse v0
    as-is), and the [M, D] residual projection.

    mixed=True keeps the O(N M^2) work off the fp64 [M, N] trisolve at
    scale (gram-form AAT/LB + a chunked df32 Kuf pass for A @ res — both
    fp64-grade; see models/sgpr.py)."""
    sigma_sq = params.noise_variance.value
    sigma = jnp.sqrt(sigma_sq)
    err = Y - mean_apply(params.mean, X)
    if mixed:
        ct = common_terms(params, X, jitter, mixed=True)
    else:
        ct = common_terms(params, X, jitter)
    if matvec is None:
        matvec = _op.make_dense_operator(params.kernel, X, sigma_sq)

    if cg_tolerance is None or cfg.v_is_external:
        v = v0
    else:
        P = _make_precond(ct, sigma_sq, cfg, consistent_ct=not mixed)
        v, _ = _cg.preconditioned_cg(
            matvec, err.T, v0, P, cg_tolerance, cfg.max_cg_iters,
            cfg.restart_cg_iters
        )

    res = err - matvec(v).T  # [N, D]
    if mixed:
        from .sgpr import kuf_weighted

        Ares = kuf_weighted(params, ct.L, X, res, sigma, Cinv=ct.Li)
    else:
        Ares = ct.A @ res
    if ct.LBi is not None:
        import jax

        c = jnp.dot(ct.LBi, Ares,
                    precision=jax.lax.Precision.HIGHEST) / sigma
    else:
        c = jsl.solve_triangular(ct.LB, Ares, lower=True) / sigma
    return PredictCache(v=v, c=c, L=ct.L, LB=ct.LB, Li=ct.Li, LBi=ct.LBi)


def predict_from_cache(params: SGPRParams, cache: PredictCache, X, Xnew,
                       full_cov: bool = False,
                       cross_matvec: Optional[Callable] = None
                       ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-batch prediction from a PredictCache: only O(S M + S N) work —
    no CG, no [M, N] solve (reference per-batch path:
    pytorch/models.py:307-354 with use_cache=True).

    cross_matvec: optional p [B, N] -> p K(X, Xnew) [B, S] closure — at
    scale the streaming version avoids materializing the [S, N] cross
    kernel in device memory)."""
    Z = params.inducing_Z.value
    v, c = cache.v, cache.c
    if cross_matvec is not None:
        cg_mean = cross_matvec(v).T  # [S, D]
    else:
        Ksf = _k.K(params.kernel, Xnew, X)  # [S, N]
        cg_mean = Ksf @ v.T  # [S, D]

    Kus = _k.K(params.kernel, Z, Xnew)
    from .sgpr import _cache_solves

    tmp1, tmp2 = _cache_solves(cache, Kus)
    sgpr_mean = tmp2.T @ c
    D = v.shape[0]
    if full_cov:
        # tile the shared covariance over the output dim like the reference
        # ([P, S, S]; tensorflow/models.py:238) so both branches are per-output
        var = _k.K(params.kernel, Xnew) + tmp2.T @ tmp2 - tmp1.T @ tmp1
        var = jnp.tile(var[None], (D, 1, 1))
    else:
        var = (
            _k.kdiag(params.kernel, Xnew)
            + jnp.sum(jnp.square(tmp2), axis=0)
            - jnp.sum(jnp.square(tmp1), axis=0)
        )
        var = jnp.tile(var[:, None], (1, D))
    return sgpr_mean + cg_mean + mean_apply(params.mean, Xnew), var


def predict_f(params: SGPRParams, X, Y, v0, Xnew, cfg: CGLBConfig = CGLBConfig(),
              cg_tolerance: Optional[float] = 1e-3, full_cov: bool = False,
              jitter: float = None, matvec: Optional[Callable] = None,
              cross_matvec: Optional[Callable] = None,
              mixed: bool = False) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """CGLB posterior: m(x*) = SGPR-mean-on-residual + Ks,f v.

    With v = 0 this is the SGPR mean; with exact v it is the exact GP mean
    (reference: tensorflow/models.py:194-246).  Composition of
    predict_prepare + predict_from_cache (batched callers hoist the prepare
    out of the batch loop).

    mixed=True routes the one-time common terms through the gram-form
    df32 build, whose temporaries stay [M, chunk]-sized at scale (the
    non-mixed path materializes the [M, N] trisolve)."""
    cache = predict_prepare(params, X, Y, v0, cfg, cg_tolerance, jitter,
                            matvec, mixed=mixed)
    return predict_from_cache(params, cache, X, Xnew, full_cov=full_cov,
                              cross_matvec=cross_matvec)


def cglb_predict_log_density(params: SGPRParams, X, Y, v0, Xnew, Ynew,
                             cfg: CGLBConfig = CGLBConfig(),
                             cg_tolerance: float = 1e-6,
                             jitter: float = None) -> jnp.ndarray:
    """Predictive log density at a tighter CG tolerance (1e-6; reference:
    tensorflow/models.py:248-267)."""
    f_mean, f_var = predict_f(
        params, X, Y, v0, Xnew, cfg, cg_tolerance=cg_tolerance, jitter=jitter
    )
    return predict_log_density(f_mean, f_var, params.noise_variance.value, Ynew)
