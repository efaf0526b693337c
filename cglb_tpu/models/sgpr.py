"""SGPR: Titsias ELBO, Titsias upper bound, posterior prediction, and the SGPRN2M
variant.

First-party replacement for the GPflow SGPR internals the reference inherits
(reference: gpflow SGPR elbo/upper_bound used as the metric bracket at
cglb/backend/tensorflow/interface.py:398-427; the N2M-log-trace variant at
cglb/backend/tensorflow/models.py:353-413).

The "common terms" here are shared with the CGLB objective and the Nystrom
preconditioner (reference: cglb/backend/tensorflow/models.py:58-75):

    L  = chol(Kuu + jitter I)                [M, M]
    A  = L^-1 Kuf / sigma                    [M, N]
    B  = A A^T + I,  LB = chol(B)            [M, M]

Kuf is [M, N] with N large; A is produced by one triangular solve (O(N M^2),
matmul-bound).  Everything M x M is small and replicated; for the sharded path
the N-axis of Kuf/A is row-sharded and AAT/Aerr become psum reductions (see
cglb_tpu/parallel/).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl

from ..struct import pytree_dataclass
from ..transforms import Param
from ..ops import kernels as _k
from ..ops.chol64 import chol_inv, chol_inv_retry
from .gaussian import ConstantMean, mean_apply, predict_log_density

__all__ = [
    "SGPRParams",
    "CommonTerms",
    "common_terms",
    "kuf_weighted",
    "elbo",
    "upper_bound",
    "predict_f",
    "predict_prepare",
    "predict_from_cache",
    "sgpr_predict_log_density",
    "elbo_n2m",
]


@pytree_dataclass
class SGPRParams:
    kernel: object
    inducing_Z: Param  # [M, D]
    noise_variance: Param
    mean: ConstantMean
    # CGLB joint optimization (--vjoint): v0 promoted to a trainable leaf so
    # the optimizer updates it directly instead of CG (reference makes v0 a
    # trainable Parameter when joint_optimization and not vzero:
    # cglb/backend/tensorflow/models.py:44-46).  None for all other models.
    v0: Param = None

    @staticmethod
    def create(kernel, Z, noise_variance: float = 1.0, output_dim: int = 1,
               dtype=None, variance_lower: float = None,
               trainable_inducing: bool = True) -> "SGPRParams":
        from .. import config as _config

        dtype = dtype or _config.default_float()
        lower = (
            variance_lower
            if variance_lower is not None
            else _config.positive_lower_bound(dtype)
        )
        return SGPRParams(
            kernel=kernel,
            inducing_Z=Param.create(jnp.asarray(Z, dtype=dtype),
                                    trainable=trainable_inducing),
            noise_variance=Param.positive(
                jnp.asarray(noise_variance, dtype=dtype), lower=lower
            ),
            mean=ConstantMean.create(output_dim, dtype=dtype),
        )

    @property
    def num_inducing(self) -> int:
        return self.inducing_Z.raw.shape[0]


class CommonTerms(NamedTuple):
    A: jnp.ndarray     # [M, N]  L^-1 Kuf / sigma
    AAT: jnp.ndarray   # [M, M]
    B: jnp.ndarray     # [M, M]  AAT + I
    LB: jnp.ndarray    # [M, M]  chol(B)
    L: jnp.ndarray     # [M, M]  chol(Kuu + jitter I)
    # LB^-1, a free byproduct of the fused chol_inv (ops/chol64): consumed
    # by the Nystrom preconditioner so its per-CG-iteration applies are
    # matmuls instead of [M, M] trisolve expander instances
    LBi: jnp.ndarray = None
    # L^-1 (mixed/gram path only): lets the prediction path run its
    # per-batch [M, S] "solves" as matmuls too (predict_from_cache)
    Li: jnp.ndarray = None


def _kuu_chol(params: SGPRParams, jitter: float):
    """chol(Kuu + jitter I), with a 1000x-jitter retry if the factorization
    produces non-finite values (clustered inducing points mid-optimization;
    the reference relies on gpflow's default jitter and scipy's line-search
    backoff for the same failure mode)."""
    import jax

    Z = params.inducing_Z.value
    M = Z.shape[0]
    kuu = _k.K(params.kernel, Z)
    eye = jnp.eye(M, dtype=Z.dtype)
    L1 = jnp.linalg.cholesky(kuu + jitter * eye)
    ok = jnp.all(jnp.isfinite(jnp.diagonal(L1)))
    return jax.lax.cond(
        ok,
        lambda: L1,
        lambda: jnp.linalg.cholesky(kuu + (1000.0 * jitter) * eye),
    )


def _kuu_chol_inv(params: SGPRParams, jitter: float):
    """(L, L^-1) for chol(Kuu + jitter I) with the same 1000x-jitter retry as
    _kuu_chol, via the fused ops/chol64 primitive: ONE cholesky, a
    matmul-only backward, and the explicit inverse that lets the gram path
    replace every downstream fp64 trisolve with a matmul.  The mixed/gram
    paths use this; the common_dtype='float64' reference-parity path keeps
    _kuu_chol's native autodiff."""
    kuu = _k.K(params.kernel, params.inducing_Z.value)
    return chol_inv_retry(kuu, jitter)


# above this many Kuf elements the chunked path kicks in automatically, so the
# [M, N]-sized temporaries of the kernel build and the solves stay bounded.
# The value is conservative for an 80 GB card; re-deriving it from measured
# peak memory is open work (ROADMAP.md).
CHUNK_THRESHOLD_ELEMENTS = 32 * 1024 * 1024

# above this many Kuf elements the chunked builders' backward is
# rematerialized per chunk (jax.checkpoint on the lax.map body): stored scan
# residuals run ~30-40 bytes/element (fp64 Kuf + d2 + f32 A + df32
# intermediates), so 128M elements ~ 4-5 GB.  Below it, storing beats
# recomputing.  Conservative for an 80 GB card, like the chunk threshold.
REMAT_THRESHOLD_ELEMENTS = 128 * 1024 * 1024


def _kuf_terms(params: SGPRParams, L, X, sigma_scale, W=None,
               chunk_size: int = None, kernel_df32: bool = False,
               remat: bool = False):
    """A = L^-1 Kuf / sigma_scale, AAT = A A^T, and optionally AW = A @ W —
    computed in column chunks under ``lax.map`` when N*M is large, so every
    fp64 contraction stays at [M, chunk] (exact fp64 either way).

    W: optional [N, D] right factor folded into the same chunked pass (e.g.
    the training-error matrix for the ELBO quad term).
    remat: checkpoint the chunk body so the lax.map backward recomputes
    per-chunk instead of storing [M, N]-aggregate residuals (see
    _gram_terms)."""
    import jax

    Z = params.inducing_Z.value
    M = Z.shape[0]
    N = X.shape[0]

    if chunk_size is None and N * M > CHUNK_THRESHOLD_ELEMENTS:
        chunk_size = max(CHUNK_THRESHOLD_ELEMENTS // M, 1024)

    def kuf_block(xc):
        if kernel_df32:
            return _kuf_block_df32(params, Z, xc)
        return _k.K(params.kernel, Z, xc)

    if chunk_size is None or N <= chunk_size:
        kuf = kuf_block(X)  # [M, N]
        A = jsl.solve_triangular(L, kuf, lower=True) / sigma_scale
        AAT = A @ A.T
        AW = None if W is None else A @ W
        return A, AAT, AW

    n_chunks = -(-N // chunk_size)
    n_pad = n_chunks * chunk_size
    Xp = jnp.pad(X, ((0, n_pad - N), (0, 0)), mode="edge")
    Xc = Xp.reshape(n_chunks, chunk_size, X.shape[1])
    # zero out the padded (repeated) columns so reductions are exact
    col_ids = jnp.arange(n_pad).reshape(n_chunks, chunk_size)
    masks = (col_ids < N).astype(X.dtype)
    if W is not None:
        Wp = jnp.pad(W, ((0, n_pad - N), (0, 0)))
        Wc = Wp.reshape(n_chunks, chunk_size, W.shape[1])
    else:
        Wc = jnp.zeros((n_chunks, chunk_size, 1), dtype=X.dtype)

    def per_chunk(args):
        xc, mask, wc = args
        kuf_c = kuf_block(xc)
        a_c = jsl.solve_triangular(L, kuf_c, lower=True) / sigma_scale
        a_c = a_c * mask[None, :]
        # per-chunk partials keep every fp64 matmul at [M, chunk]
        return a_c, a_c @ a_c.T, a_c @ wc

    per_chunk_fn = jax.checkpoint(per_chunk) if remat else per_chunk
    A_stack, AAT_parts, AW_parts = jax.lax.map(per_chunk_fn, (Xc, masks, Wc))
    A = jnp.moveaxis(A_stack, 0, 1).reshape(M, n_pad)[:, :N]
    AAT = jnp.sum(AAT_parts, axis=0)
    AW = None if W is None else jnp.sum(AW_parts, axis=0)
    return A, AAT, AW


def _kuf_block_df32(params: SGPRParams, Z, Xc):
    """Kuf block at fp64-grade accuracy without fp64 transcendentals.

    The squared distance is assembled exactly in fp64 (one small-D matmul +
    O(NM) adds), and the profile rho(d2) is evaluated in compensated
    two-float f32 arithmetic (ops/df32): ~1e-11 relative per entry.  A
    plain-f32 build (1e-7 per entry) loses ~3e-4 on the bound because the
    L^-1 trisolve amplifies entry errors by kappa(Kuu) — df32 keeps the
    amplified error below 1e-8.  Under a mesh GSPMD partitions these ops
    row-wise like any other XLA op."""
    from ..ops import df32 as _df

    ls = params.kernel.lengthscales.value
    var = params.kernel.variance.value
    # d2 stays EXACT fp64: the norm-expansion cancellation must happen at
    # fp64 (a df32 assembly loses ~3.5 digits on uncentered / small-
    # lengthscale data where zn + xn >> d2); only the transcendental profile
    # runs in df32.
    d2 = _k.scaled_sq_dist(Z, Xc, ls)
    if isinstance(params.kernel, _k.SquaredExponential):
        rho = _df.rbf_unit(d2)
    else:
        rho = _df.matern32_unit(d2)
    return var * rho


def _aat_sandwich(L, G, sigma_scale):
    """AAT = L^-1 G L^-T / sigma_scale^2 via two [M, M] trisolves,
    symmetrized (the two solves round differently above/below the
    diagonal).  Shared by the single-device gram path and the sharded one
    (parallel/sharded.py) so the numerics cannot drift apart."""
    T1 = jsl.solve_triangular(L, G, lower=True)
    AAT = jsl.solve_triangular(L, T1.T, lower=True) / (
        sigma_scale * sigma_scale
    )
    return 0.5 * (AAT + AAT.T)


def _gram_terms(params: SGPRParams, L, X, sigma_scale, W=None,
                chunk_size: int = None, a_dtype=jnp.float32,
                with_a: bool = True, Cinv=None, mesh=None,
                data_axis: str = "data", remat: bool = False):
    """Mixed-mode fast path: the O(N M^2) work runs as matmuls, never as an
    fp64 [M, N] triangular solve.

    Accumulate the fp64 Gram matrix G = Kuf Kuf^T (and U = Kuf @ W) over
    column chunks — matmuls only — then form

        AAT = L^-1 G L^-T / sigma^2     (two [M, M] fp64 trisolves, ~1/20 N/M
        AW  = L^-1 U / sigma            of the big-solve cost)

    A itself is materialized only in ``a_dtype`` (default f32, via an f32
    trisolve — backward-stable, unlike an explicit inverse whose
    eps32*kappa(L) error made the Woodbury preconditioner indefinite in an
    early version): its sole consumer in the training loss is the Nystrom
    preconditioner, which casts to f32 anyway (models/cglb.py precond_dtype;
    the preconditioner re-derives its own LB from this A so its Woodbury
    identity stays self-consistent).  Error note: the AAT sandwich inherits
    ~eps64 kappa(L)^2 instead of the trisolve's eps64 kappa(L); with the
    1e-6 jitter floor that is <=1e-10 relative on AAT — validated against
    the trisolve path in tests.

    Cinv: optional fp64 L^-1 (from _kuu_chol_inv).  When given, every
    triangular solve here becomes a matmul against Cinv: AAT = Cinv G
    Cinv^T (same eps64 kappa(L)^2 envelope as the sandwich — Cinv is the
    backward-stable solve against I), AW = Cinv U, and A = (Cinv @ kuf) in
    a_dtype at HIGHEST precision (error eps32 ||Cinv|| ||Kuf|| <= the f32
    trisolve's eps32 kappa(L) ||A|| bound, because Cinv itself is fp64-
    accurate — unlike the f32-computed explicit inverse that once made the
    Woodbury preconditioner indefinite).

    mesh: optional jax.sharding.Mesh.  When given, every chunk is
    constrained to span ALL devices of the mesh's ``data_axis`` (rows of
    each X chunk sharded), so the ``lax.map`` steps run data-parallel and
    the per-chunk Gram partials psum across devices; G/AAT come out
    replicated and A column-sharded.  This is the large-N sharded
    common-terms path (parallel/sharded.py); chunking keeps the per-device
    [M, chunk] temporaries bounded.

    remat: checkpoint the per-chunk body, so the lax.map backward
    recomputes each chunk's Kuf/d2/A instead of storing the stacked
    residuals (which are [M, N]-sized in aggregate: fp64 kuf_c alone is
    10.5 GiB at houseelectric scale — the chunked FORWARD is bounded but
    an un-rematted backward is not).  Callers engage it by size
    (REMAT_THRESHOLD_ELEMENTS); below the threshold storing beats
    recomputing.
    """
    import jax

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as _P

        def _cst(x, *spec):
            return jax.lax.with_sharding_constraint(
                x, NamedSharding(mesh, _P(*spec)))
    else:
        def _cst(x, *spec):
            return x

    Z = params.inducing_Z.value
    M = Z.shape[0]
    N = X.shape[0]

    if chunk_size is None and N * M > CHUNK_THRESHOLD_ELEMENTS:
        chunk_size = max(CHUNK_THRESHOLD_ELEMENTS // M, 1024)
        if mesh is not None:
            # each chunk spans every device of the data axis, so the
            # per-device slice is chunk/n_dev: scale the auto chunk up to
            # keep per-device temporaries at the single-device budget.  An
            # explicit chunk_size is honored as-is.
            chunk_size = chunk_size * mesh.shape[data_axis]

    L_cast = (Cinv if Cinv is not None else L).astype(a_dtype)
    sigma_cast = sigma_scale.astype(a_dtype)
    d_w = W.shape[1] if W is not None else 1

    def chunk_part(xc, mask, wc):
        # a_t chunks come out TRANSPOSED [chunk, M]: stacking + reshaping
        # [n_chunks, chunk, M] -> [n_pad, M] is then a zero-copy bitcast and
        # the final A = A_t.T is a view whose consumers are all dots (the
        # preconditioner), into which XLA folds the transpose.  The previous
        # moveaxis(stack, 0, 1).reshape(M, -1) materialized a full [M, N]
        # layout copy, an extra [M, N] buffer live next to A itself.
        xc = _cst(xc, data_axis, None)
        kuf_c = _cst(_kuf_block_df32(params, Z, xc) * mask[None, :],
                     None, data_axis)
        if with_a and Cinv is not None:
            a_t = jnp.dot(kuf_c.astype(a_dtype).T, L_cast.T,
                          precision=jax.lax.Precision.HIGHEST) / sigma_cast
        elif with_a:
            a_t = (jsl.solve_triangular(
                L_cast, kuf_c.astype(a_dtype), lower=True
            ) / sigma_cast).T
        else:
            a_t = jnp.zeros((kuf_c.shape[1], 0), dtype=a_dtype)
        # Under a mesh the Gram/U partials contract over the sharded column
        # axis — constraining them replicated makes XLA emit the psum.
        return (
            _cst(kuf_c @ kuf_c.T),
            _cst(kuf_c @ wc),
            _cst(a_t, data_axis, None) if with_a else a_t,
        )

    if chunk_size is None or N <= chunk_size:
        W_full = W if W is not None else jnp.zeros((N, 1), dtype=X.dtype)
        G, U, A_t = chunk_part(X, jnp.ones((N,), dtype=X.dtype), W_full)
        A = A_t.T if with_a else None
    else:
        n_chunks = -(-N // chunk_size)
        n_pad = n_chunks * chunk_size
        Xp = jnp.pad(X, ((0, n_pad - N), (0, 0)), mode="edge")
        Xc = _cst(Xp.reshape(n_chunks, chunk_size, X.shape[1]),
                  None, data_axis, None)
        col_ids = jnp.arange(n_pad).reshape(n_chunks, chunk_size)
        masks = _cst((col_ids < N).astype(X.dtype), None, data_axis)
        if W is not None:
            Wp = jnp.pad(W, ((0, n_pad - N), (0, 0)))
            Wc = Wp.reshape(n_chunks, chunk_size, d_w)
        else:
            Wc = jnp.zeros((n_chunks, chunk_size, 1), dtype=X.dtype)
        Wc = _cst(Wc, None, data_axis, None)
        chunk_fn = jax.checkpoint(chunk_part) if remat else chunk_part
        G_parts, U_parts, At_stack = jax.lax.map(
            lambda args: chunk_fn(*args), (Xc, masks, Wc)
        )
        G = jnp.sum(G_parts, axis=0)
        U = jnp.sum(U_parts, axis=0)
        # [n_chunks, chunk, M] -> [n_pad, M] is a bitcast; .T is a view
        A = _cst(At_stack.reshape(-1, M)[:N], data_axis, None).T \
            if with_a else None

    if Cinv is not None:
        AAT = (Cinv @ G @ Cinv.T) / (
            sigma_scale * sigma_scale
        )
        AAT = 0.5 * (AAT + AAT.T)
    else:
        AAT = _aat_sandwich(L, G, sigma_scale)
    AW = None
    if W is not None:
        if Cinv is not None:
            AW = (Cinv @ U) / sigma_scale
        else:
            AW = jsl.solve_triangular(L, U, lower=True) / sigma_scale
    if not with_a:
        A = None
    return A, AAT, AW


def kuf_weighted(params: SGPRParams, L, X, W, sigma_scale,
                 chunk_size: int = None, Cinv=None):
    """AW = L^-1 (Kuf @ W) / sigma_scale at fp64-grade without the [M, N]
    fp64 trisolve: df32 Kuf blocks + fp64 matmuls in one chunked
    pass, then one small [M, D] solve — or a matmul against ``Cinv``
    (= L^-1, from the fused chol_inv) when the caller has it.  Serves the
    prediction cache's residual projection at scale (models/cglb.py
    predict_prepare)."""
    import jax

    Z = params.inducing_Z.value
    M = Z.shape[0]
    N = X.shape[0]
    if chunk_size is None and N * M > CHUNK_THRESHOLD_ELEMENTS:
        chunk_size = max(CHUNK_THRESHOLD_ELEMENTS // M, 1024)
    if chunk_size is None or N <= chunk_size:
        U = _kuf_block_df32(params, Z, X) @ W
    else:
        n_chunks = -(-N // chunk_size)
        n_pad = n_chunks * chunk_size
        Xp = jnp.pad(X, ((0, n_pad - N), (0, 0)), mode="edge")
        Xc = Xp.reshape(n_chunks, chunk_size, X.shape[1])
        Wp = jnp.pad(W, ((0, n_pad - N), (0, 0)))
        Wc = Wp.reshape(n_chunks, chunk_size, W.shape[1])
        # padded X rows repeat real points but their W rows are zero, so the
        # partial products are exact without a mask
        U = jnp.sum(
            jax.lax.map(
                lambda args: _kuf_block_df32(params, Z, args[0]) @ args[1],
                (Xc, Wc),
            ),
            axis=0,
        )
    if Cinv is not None:
        return jnp.dot(Cinv, U,
                       precision=jax.lax.Precision.HIGHEST) / sigma_scale
    return jsl.solve_triangular(L, U, lower=True) / sigma_scale


def common_terms(params: SGPRParams, X, jitter: float = None,
                 chunk_size: int = None, mixed: bool = False,
                 gram: bool = None, a_dtype=jnp.float32,
                 remat: bool = False) -> CommonTerms:
    """Reference semantics: cglb/backend/tensorflow/models.py:58-75.

    For large N the fp64 path runs the O(N M) solve in column chunks under
    ``lax.map`` so the [M, N]-sized fp64 temporaries stay bounded (exact fp64
    math either way).

    ``mixed=True`` evaluates the kernel profile in df32 (two-float f32,
    ~1e-11 per entry — see _kuf_block_df32) and, with ``gram`` (defaults to
    ``mixed``), restructures the O(N M^2) contractions into Gram-matrix
    matmuls so no fp64 trisolve touches the [M, N] block (see
    _gram_terms); A is then materialized in ``a_dtype`` (f32 default — its
    only training-loss consumer is the f32 Nystrom preconditioner).  Paths
    needing exact fp64 A at scale (the N2M ablation, prediction) pass
    gram=False.
    """
    from .. import config as _config

    jitter = jitter if jitter is not None else _config.default_jitter()
    Z = params.inducing_Z.value
    M = Z.shape[0]
    sigma = jnp.sqrt(params.noise_variance.value)
    gram = mixed if gram is None else gram
    if mixed and gram:
        # fused chol+inverse (ops/chol64): matmul-only backward, and Cinv
        # turns every downstream trisolve into a matmul
        L, Cinv = _kuu_chol_inv(params, jitter)
        A, AAT, _ = _gram_terms(params, L, X, sigma, chunk_size=chunk_size,
                                a_dtype=a_dtype, Cinv=Cinv, remat=remat)
        B = AAT + jnp.eye(M, dtype=Z.dtype)
        LB, LBi = chol_inv(B)
        Li = Cinv
    else:
        # fp64 chunked solves/AAT (df32 kernel build when mixed).  Full-f32
        # solves were tried and go unstable when sigma^2 shrinks
        # (||AAT|| ~ 1/sigma^2 makes the f32 accumulation noise exceed B's
        # unit eigenvalues -> NaN cholesky); plain-f32 kernel values lose
        # ~3e-4 on the bound (round 1).
        L = _kuu_chol(params, jitter)
        A, AAT, _ = _kuf_terms(params, L, X, sigma, chunk_size=chunk_size,
                               kernel_df32=mixed, remat=remat)
        B = AAT + jnp.eye(M, dtype=Z.dtype)
        LB = jnp.linalg.cholesky(B)
        # the exact path keeps backward-stable trisolves downstream
        # (reference semantics): no inverses are materialized
        LBi = Li = None
    return CommonTerms(A=A, AAT=AAT, B=B, LB=LB, L=L, LBi=LBi, Li=Li)


def elbo(params: SGPRParams, X, Y, jitter: float = None,
         mixed: bool = False, remat: bool = None) -> jnp.ndarray:
    """Titsias (2009) collapsed ELBO, the reference's `elbo` metric.

    mixed=True uses the df32/gram fast path (fp64-grade, no fp64
    [M, N] trisolve — the same trade as the CGLB training default; A itself
    is never needed here so the f32 solve is skipped entirely).
    remat: per-chunk backward rematerialization (None = by size; matters
    only when this is trained/differentiated — metric evaluation stores
    no residuals)."""
    from .. import config as _config

    jitter = jitter if jitter is not None else _config.default_jitter()
    err = Y - mean_apply(params.mean, X)
    N, D = Y.shape
    M = params.num_inducing
    if remat is None:
        remat = N * M > REMAT_THRESHOLD_ELEMENTS
    sigma_sq = params.noise_variance.value
    sigma = jnp.sqrt(sigma_sq)
    # A, AAT, and A@err in one chunked pass (bounded fp64 temps at scale)
    if mixed:
        L, Ci = _kuu_chol_inv(params, jitter)
        _, AAT, Aerr = _gram_terms(params, L, X, sigma, W=err, with_a=False,
                                   Cinv=Ci, remat=remat)
        LB, CB = chol_inv(AAT + jnp.eye(M, dtype=X.dtype))
        c = (CB @ Aerr) / sigma
    else:
        L = _kuu_chol(params, jitter)
        _, AAT, Aerr = _kuf_terms(params, L, X, sigma, W=err, remat=remat)
        LB = jnp.linalg.cholesky(AAT + jnp.eye(M, dtype=X.dtype))
        c = jsl.solve_triangular(LB, Aerr, lower=True) / sigma

    bound = -0.5 * N * D * math.log(2.0 * math.pi)
    bound -= D * jnp.sum(jnp.log(jnp.diagonal(LB)))
    bound -= 0.5 * N * D * jnp.log(sigma_sq)
    bound -= 0.5 * jnp.sum(jnp.square(err)) / sigma_sq
    bound += 0.5 * jnp.sum(jnp.square(c))
    # trace correction: -0.5 D (sum kdiag / sigma^2 - tr(AAT))
    kd = _k.kdiag(params.kernel, X)
    bound -= 0.5 * D * (jnp.sum(kd) / sigma_sq - jnp.trace(AAT))
    return bound


def upper_bound(params: SGPRParams, X, Y, jitter: float = None,
                mixed: bool = False) -> jnp.ndarray:
    """Titsias trace upper bound on the LML (first-party equivalent of gpflow
    SGPR.upper_bound, consumed by the reference as the `titsias_upper_bound`
    metric at cglb/backend/tensorflow/interface.py:404-405, 424-425)."""
    from .. import config as _config

    jitter = jitter if jitter is not None else _config.default_jitter()
    Z = params.inducing_Z.value
    M = Z.shape[0]
    N = X.shape[0]
    sigma_sq = params.noise_variance.value
    eye_m = jnp.eye(M, dtype=Z.dtype)

    err = Y - mean_apply(params.mean, X)
    one = jnp.ones((), dtype=X.dtype)
    remat = N * M > REMAT_THRESHOLD_ELEMENTS
    if mixed:
        L, Ci = _kuu_chol_inv(params, jitter)
        _, AAT0, A0err = _gram_terms(params, L, X, one, W=err, with_a=False,
                                     Cinv=Ci, remat=remat)
        LB, _ = chol_inv(eye_m + AAT0 / sigma_sq)
    else:
        L = _kuu_chol(params, jitter)
        _, AAT0, A0err = _kuf_terms(params, L, X, one, W=err, remat=remat)
        LB = jnp.linalg.cholesky(eye_m + AAT0 / sigma_sq)

    # Trace slack: c = tr(Kff) - tr(Qff) >= 0 inflates the noise.  The
    # subtraction cancels catastrophically as Q -> K at large M (the same
    # regime that NaN'd the sibling trace terms; models/cglb.py:92-124) and
    # can go slightly negative, which would silently invalidate the bound
    # (corrected_noise < sigma^2) and NaN the cholesky below once
    # corrected_noise <= 0.  Clamp at the true minimum 0.
    cslack = jnp.maximum(
        jnp.sum(_k.kdiag(params.kernel, X)) - jnp.trace(AAT0), 0.0
    )
    corrected_noise = sigma_sq + cslack

    const = -0.5 * N * jnp.log(2.0 * math.pi * sigma_sq)
    logdet = -jnp.sum(jnp.log(jnp.diagonal(LB)))

    if mixed:
        _, CC = chol_inv(eye_m + AAT0 / corrected_noise)
        v = CC @ (A0err / corrected_noise)
    else:
        LC = jnp.linalg.cholesky(eye_m + AAT0 / corrected_noise)
        v = jsl.solve_triangular(LC, A0err / corrected_noise, lower=True)
    quad = -0.5 * jnp.sum(jnp.square(err)) / corrected_noise + 0.5 * jnp.sum(
        jnp.square(v)
    )
    return const + logdet + quad


class SGPRPredictCache(NamedTuple):
    """Batch-independent SGPR prediction state: one common-terms build
    serves every prediction batch (same caching idea as the CGLB
    PredictCache; reference batches SGPR predictions without re-deriving
    the posterior per batch)."""

    c: jnp.ndarray   # [M, D] LB^-1 (A @ err) / sigma
    L: jnp.ndarray
    LB: jnp.ndarray
    # optional L^-1 / LB^-1 (mixed path): per-batch solves become matmuls
    Li: jnp.ndarray = None
    LBi: jnp.ndarray = None


def predict_prepare(params: SGPRParams, X, Y, jitter: float = None,
                    mixed: bool = False) -> SGPRPredictCache:
    """The batch-independent half of predict_f.  mixed=True keeps the
    O(N M^2) work off the fp64 [M, N] trisolve at scale (gram path)."""
    from .. import config as _config

    jitter = jitter if jitter is not None else _config.default_jitter()
    err = Y - mean_apply(params.mean, X)
    sigma = jnp.sqrt(params.noise_variance.value)
    M = params.num_inducing
    if mixed:
        L, Ci = _kuu_chol_inv(params, jitter)
        _, AAT, Aerr = _gram_terms(params, L, X, sigma, W=err, with_a=False,
                                   Cinv=Ci)
        LB, CB = chol_inv(AAT + jnp.eye(M, dtype=X.dtype))
        c = (CB @ Aerr) / sigma
        return SGPRPredictCache(c=c, L=L, LB=LB, Li=Ci, LBi=CB)
    L = _kuu_chol(params, jitter)
    _, AAT, Aerr = _kuf_terms(params, L, X, sigma, W=err)
    LB = jnp.linalg.cholesky(AAT + jnp.eye(M, dtype=X.dtype))
    c = jsl.solve_triangular(LB, Aerr, lower=True) / sigma
    return SGPRPredictCache(c=c, L=L, LB=LB)


def _cache_solves(cache, Kus):
    """tmp1 = L^-1 Kus, tmp2 = LB^-1 tmp1 — matmuls against the cached
    inverses when available (mixed path), trisolves otherwise.  HIGHEST
    keeps the f32-model case out of TF32; fp64 is unaffected."""
    hi = jax.lax.Precision.HIGHEST
    if cache.Li is not None:
        tmp1 = jnp.dot(cache.Li, Kus, precision=hi)
    else:
        tmp1 = jsl.solve_triangular(cache.L, Kus, lower=True)
    if cache.LBi is not None:
        tmp2 = jnp.dot(cache.LBi, tmp1, precision=hi)
    else:
        tmp2 = jsl.solve_triangular(cache.LB, tmp1, lower=True)
    return tmp1, tmp2


def predict_from_cache(params: SGPRParams, cache: SGPRPredictCache, Xnew,
                       full_cov: bool = False
                       ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-batch SGPR posterior from a cache: O(S M^2) only."""
    Z = params.inducing_Z.value
    Kus = _k.K(params.kernel, Z, Xnew)  # [M, S]
    tmp1, tmp2 = _cache_solves(cache, Kus)
    f_mean = tmp2.T @ cache.c + mean_apply(params.mean, Xnew)
    D = cache.c.shape[1]
    if full_cov:
        # [P, S, S], tiled over outputs (reference tensorflow/models.py:238)
        var = _k.K(params.kernel, Xnew) + tmp2.T @ tmp2 - tmp1.T @ tmp1
        var = jnp.tile(var[None], (D, 1, 1))
    else:
        var = (
            _k.kdiag(params.kernel, Xnew)
            + jnp.sum(jnp.square(tmp2), axis=0)
            - jnp.sum(jnp.square(tmp1), axis=0)
        )
        var = jnp.tile(var[:, None], (1, D))
    return f_mean, var


def predict_f(params: SGPRParams, X, Y, Xnew, full_cov: bool = False,
              jitter: float = None) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """SGPR posterior at Xnew (the q(f*) of the collapsed bound)."""
    cache = predict_prepare(params, X, Y, jitter)
    return predict_from_cache(params, cache, Xnew, full_cov=full_cov)


def sgpr_predict_log_density(params: SGPRParams, X, Y, Xnew, Ynew,
                             jitter: float = None) -> jnp.ndarray:
    f_mean, f_var = predict_f(params, X, Y, Xnew, jitter=jitter)
    return predict_log_density(f_mean, f_var, params.noise_variance.value, Ynew)


def elbo_n2m(params: SGPRParams, X, Y, jitter: float = None) -> jnp.ndarray:
    """SGPRN2M: the SGPR bound with the trace term replaced by the N^2M log-trace
    term  -0.5 n log(tr(Q^-1 K)/n)  (reference: cglb/backend/tensorflow/
    models.py:353-413).  Materializes Kff: O(N^2) memory, ablation-only."""
    ct = common_terms(params, X, jitter)
    err = Y - mean_apply(params.mean, X)
    N, D = Y.shape
    sigma_sq = params.noise_variance.value
    sigma = jnp.sqrt(sigma_sq)
    Aerr = ct.A @ err
    c = jsl.solve_triangular(ct.LB, Aerr, lower=True) / sigma

    bound = -0.5 * N * D * math.log(2.0 * math.pi)
    bound -= D * jnp.sum(jnp.log(jnp.diagonal(ct.LB)))
    bound -= 0.5 * N * D * jnp.log(sigma_sq)
    bound -= 0.5 * jnp.sum(jnp.square(err)) / sigma_sq
    bound += 0.5 * jnp.sum(jnp.square(c))

    kff_s = _k.K(params.kernel, X) + sigma_sq * jnp.eye(N, dtype=X.dtype)
    C = jsl.solve_triangular(ct.LB, ct.A, lower=True)
    trace_kff = jnp.trace(kff_s)
    trace_qrest = jnp.trace((C @ kff_s) @ C.T)
    # trace_kff - trace_qrest = sigma^2 tr(Q^-1 (K+s2 I)) >= N sigma^2
    # mathematically (K >= Qff in the Loewner order), but the subtraction
    # cancels catastrophically as Q -> K at large M mid-training and can go
    # negative in fp64.  Clamping at the true minimum N sigma^2 keeps the
    # bound finite AND valid (log_trace >= 0); same guard as the CGLB n2m
    # logdet variant (models/cglb.py _logdet_bound).
    log_trace = N * (
        jnp.log(jnp.maximum(trace_kff - trace_qrest, N * sigma_sq))
        - math.log(N) - jnp.log(sigma_sq)
    )
    bound -= 0.5 * log_trace
    return bound
