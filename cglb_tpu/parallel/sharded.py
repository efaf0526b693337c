"""Data-sharded CGLB/SGPR computation over a device mesh.

Replacement for the reference's MultiDeviceKernel data parallelism
(cglb/backend/pytorch/interface.py:241-244,291-295) and the missing multi-node
story (SURVEY.md section 5.8): everything N-sized is sharded along the mesh's
data axis with GSPMD sharding constraints, everything M-sized is replicated,
and XLA inserts all_gather/psum collectives (NCCL on GPUs).

Layout:
    X            [N, D]   sharded rows      (data)
    Y, err       [N, 1]   sharded rows
    Kuf, A       [M, N]   sharded columns  -> AAT = A A^T is a psum
    K(X,X)+s2I   [N, N]   sharded columns   (dense path; N^2/devices each)
    v, r, p      [B, N]   sharded columns inside CG; scalar reductions psum

The CG while_loop body is identical to the single-device one (ops/cg.py) — only
the matvec closure and the common-terms builder change, which is the point of
the operator abstraction.  For N beyond device memory the dense column block is
replaced by the streaming Pallas matvec per shard (ops/matvec_pallas.py) — same
sharding, no K materialization.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models import cglb as _cglb
from ..models import sgpr as _sgpr
from ..ops import chol64 as _chol64
from ..models.cglb import CGLBAux, CGLBConfig
from ..ops import kernels as _k
from .mesh import DATA_AXIS

__all__ = ["shard_data", "sharded_cglb_loss", "make_sharded_operator",
           "sharded_train_step"]


def _cshard(mesh, x, spec):
    return jax.lax.with_sharding_constraint(x, NamedSharding(mesh, spec))


def shard_data(mesh: Mesh, X, Y):
    """Place data on the mesh: row-sharded when N divides the mesh size,
    replicated otherwise (device_put with an explicit sharding is strict
    about divisibility, but the with_sharding_constraint annotations inside
    the losses tolerate uneven shapes — GSPMD pads internally — so compute
    still distributes; only the initial placement differs)."""
    n_dev = mesh.shape[DATA_AXIS]
    spec = P(DATA_AXIS, None) if X.shape[0] % n_dev == 0 else P()
    xs = jax.device_put(X, NamedSharding(mesh, spec))
    ys = jax.device_put(Y, NamedSharding(mesh, spec))
    return xs, ys


def make_sharded_operator(mesh: Mesh, kernel, X, sigma_sq):
    """Column-sharded dense operator: K + s2 I lives sharded over the data axis;
    matvec keeps p replicated in, result replicated out (XLA all-gathers)."""
    N = X.shape[0]
    Kmat = _k.K(kernel, X) + sigma_sq * jnp.eye(N, dtype=X.dtype)
    Kmat = _cshard(mesh, Kmat, P(None, DATA_AXIS))

    def matvec(p):
        out = p @ Kmat  # [B, N] sharded on last axis
        return _cshard(mesh, out, P())

    return matvec


def _sharded_common_terms(mesh: Mesh, params: _sgpr.SGPRParams, X,
                          jitter: float, mixed: bool = False,
                          gram: bool = None, a_dtype=jnp.float32,
                          chunk_size: int = None,
                          remat: bool = False) -> _sgpr.CommonTerms:
    """Common terms with Kuf/A column-sharded; M x M results replicated.

    Mirrors models/sgpr.common_terms' knobs: ``mixed`` selects the df32
    kernel profiles, ``gram`` (defaults to ``mixed``) restructures the
    O(N M^2) contraction as the Gram matrix G = Kuf Kuf^T (per-shard
    partials, psum across devices) with AAT = Cinv G Cinv^T — the same fused
    chol+inverse primitive as the single-device gram path (ops/chol64,
    models/sgpr._kuu_chol_inv), so the fp64 [M, N] trisolve never runs and
    the numerics cannot drift between layouts.  A is materialized in a_dtype for
    the preconditioner only.  The n2m ablation passes gram=False (needs
    full-precision A) while keeping the df32 build."""
    Z = params.inducing_Z.value
    M = Z.shape[0]
    gram = mixed if gram is None else gram
    sigma = jnp.sqrt(params.noise_variance.value)
    if mixed and gram:
        # Delegate to the single-device gram builder in mesh mode: df32 Kuf
        # is built per N-chunk under lax.map with every chunk row-sharded
        # over the data axis (the chunk Gram partials psum across devices),
        # so no [M, N]-scale temporary materializes.  Same code as the
        # single-device path, so numerics/gradients are layout-invariant.
        L, Cinv = _sgpr._kuu_chol_inv(params, jitter)
        A, AAT, _ = _sgpr._gram_terms(
            params, L, X, sigma, a_dtype=a_dtype, Cinv=Cinv,
            chunk_size=chunk_size, mesh=mesh, data_axis=DATA_AXIS,
            remat=remat,
        )
        B = AAT + jnp.eye(M, dtype=Z.dtype)
        LB, LBi = _chol64.chol_inv(B)
    else:
        if mixed:
            # GSPMD partitions the XLA build row-wise (sgpr._kuf_block_df32)
            kuf = _sgpr._kuf_block_df32(params, Z, X)  # [M, N]
        else:
            kuf = _k.K(params.kernel, Z, X)
        kuf = _cshard(mesh, kuf, P(None, DATA_AXIS))
        kuu = _k.K(params.kernel, Z) + jitter * jnp.eye(M, dtype=Z.dtype)
        L = jnp.linalg.cholesky(kuu)
        A = jax.scipy.linalg.solve_triangular(L, kuf, lower=True) / sigma
        AAT = _cshard(mesh, A @ A.T, P())  # psum over shards
        A = _cshard(mesh, A, P(None, DATA_AXIS))
        B = AAT + jnp.eye(M, dtype=Z.dtype)
        LB, LBi = _chol64.chol_inv(B)
    return _sgpr.CommonTerms(A=A, AAT=AAT, B=B, LB=LB, L=L, LBi=LBi)


def sharded_cglb_loss(params, X, Y, v0, cfg: CGLBConfig, mesh: Mesh,
                      jitter: float = None, matvec: str = "dense",
                      block: int = None, max_error=None,
                      chunk_size: int = None) -> Tuple[jnp.ndarray, CGLBAux]:
    """CGLB loss with all N-sized tensors sharded over the mesh's data axis.

    Same math and CG as models.cglb.loss, honoring cfg.common_dtype the same
    way (the default "mixed" runs df32 profiles + gram-form contractions);
    only the layout differs.  Call under jit with the mesh's devices visible.

    matvec: "dense" materializes K column-sharded ([N, N/devices] per
    device); "streaming" runs the Pallas kernel per column shard (K never
    stored — the multi-device large-N path, SURVEY.md 5.7/5.8).
    block: streaming block size (None = the kernel's default).
    max_error: optional TRACED override of cfg.max_error (scalar jit
    argument), mirroring models.cglb.loss — one compiled program serves
    every level of the adaptive-tolerance schedule (-o scipy_tol) on the
    sharded path too.
    """
    from .. import config as _config
    from . import streaming as _streaming

    jitter = jitter if jitter is not None else _config.default_jitter()
    N, D = Y.shape
    mixed = cfg.common_dtype == "mixed"
    gram = mixed and cfg.logdet_variant != "n2m"
    # chunk-level remat above the same size threshold as models/cglb.bound:
    # per-device memory scales with N/devices, but the stacked scan residuals
    # an un-rematted backward stores are [M, N]-aggregate across the mesh
    remat = (N * params.num_inducing
             > _cglb.REMAT_THRESHOLD_ELEMENTS * mesh.shape[DATA_AXIS])
    ct = _sharded_common_terms(mesh, params, X, jitter, mixed=mixed,
                               gram=gram,
                               a_dtype=jnp.dtype(cfg.precond_dtype),
                               chunk_size=chunk_size, remat=remat)
    sigma_sq = params.noise_variance.value

    import math

    b = -0.5 * N * D * math.log(2.0 * math.pi)
    b += _cglb._logdet_bound(params, ct, X, Y, cfg.logdet_variant)

    if matvec == "streaming":
        blocks = () if block is None else (block, block)
        mv = _streaming.make_sharded_streaming_operator(
            mesh, params.kernel, X, sigma_sq, *blocks)
    elif matvec == "dense":
        mv = make_sharded_operator(mesh, params.kernel, X, sigma_sq)
    else:
        raise ValueError(f"unknown sharded matvec mode {matvec!r}")
    quad, aux = _cglb._quad_form_bound(params, ct, X, Y, v0, cfg, mv,
                                       max_error=max_error,
                                       consistent_ct=not gram)
    b += quad
    return -b, aux


def sharded_train_step(mesh: Mesh, cfg: CGLBConfig, optimizer,
                       matvec: str = "dense", block: int = None):
    """Build a jitted full training step over the mesh: value_and_grad of the
    sharded CGLB loss + optimizer update, CG warm start in the carry."""
    import optax

    from ..utils import flatten as _fl

    def step(params, opt_state, v0, X, Y):
        def loss_fn(p):
            return sharded_cglb_loss(p, X, Y, v0, cfg, mesh,
                                     matvec=matvec, block=block)

        (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        grads = _fl.mask_untrainable_grads(params, grads)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, aux, loss

    return jax.jit(step, donate_argnums=(0, 1, 2))
