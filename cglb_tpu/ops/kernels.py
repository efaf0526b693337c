"""Stationary GP kernels (ARD).

Covers the reference's kernel zoo: SquaredExponential (RBF) and Matern32 with ARD
lengthscales and a positive variance (reference: cglb/backend/tensorflow/
interface.py:178-197, cglb/backend/config.py:72-81).

Design notes:
- Cross-covariances are computed through the matmul form of squared distances,
  ``||a||^2 + ||b||^2 - 2 a.b``, so the O(N*M*D) work is one matmul instead of a
  broadcast-subtract (which would materialize an [N, M, D] intermediate).  The
  matmul runs at Precision.HIGHEST: an f32 product at the default precision
  runs in TF32 on the GPU, and the cancellation in the expansion would turn its
  ~1e-3 relative error into distance errors of the order of the norms.
- All functions are pure; kernels are pytree dataclasses of Params, so they flow
  through jit/grad/vmap/shard_map directly.
- The streaming Pallas matvec (ops/matvec_pallas.py) re-implements the same math
  block by block; `K` here is the dense oracle it is tested against.
"""

from __future__ import annotations

import math
from functools import singledispatch
from typing import Optional

import jax
import jax.numpy as jnp

from ..struct import pytree_dataclass
from ..transforms import Param

__all__ = [
    "SquaredExponential",
    "Matern32",
    "K",
    "kdiag",
    "scaled_sq_dist",
    "make_kernel",
    "KERNELS",
]

_HIGHEST = jax.lax.Precision.HIGHEST


@pytree_dataclass
class SquaredExponential:
    """k(x, z) = variance * exp(-0.5 * ||(x - z) / lengthscales||^2)"""

    variance: Param
    lengthscales: Param


@pytree_dataclass
class Matern32:
    """k(x, z) = variance * (1 + sqrt(3) r) exp(-sqrt(3) r), r = ||(x-z)/ls||"""

    variance: Param
    lengthscales: Param


def scaled_sq_dist(X, Z, lengthscales):
    """Pairwise squared distances of lengthscale-scaled inputs, [N, M].

    Uses the matmul expansion so the dominant cost is one [N,D]x[D,M] matmul
    (at HIGHEST, see the module notes). Clamped at zero against cancellation.
    """
    Xs = X / lengthscales
    Zs = Z / lengthscales
    xn = jnp.sum(jnp.square(Xs), axis=-1)[:, None]
    zn = jnp.sum(jnp.square(Zs), axis=-1)[None, :]
    cross = jnp.dot(Xs, Zs.T, precision=_HIGHEST)
    d2 = xn + zn - 2.0 * cross
    return jnp.maximum(d2, 0.0)


def _sq_dist_self(X, lengthscales):
    Xs = X / lengthscales
    xn = jnp.sum(jnp.square(Xs), axis=-1)
    d2 = xn[:, None] + xn[None, :] - 2.0 * jnp.dot(Xs, Xs.T, precision=_HIGHEST)
    d2 = jnp.maximum(d2, 0.0)
    # exact zeros on the diagonal (guards Matern's sqrt grad at r=0)
    return d2 * (1.0 - jnp.eye(X.shape[0], dtype=X.dtype))


@singledispatch
def K(kernel, X, Z: Optional[jnp.ndarray] = None):
    """Dense covariance K(X, Z) ([N, M]); Z=None means K(X, X)."""
    raise NotImplementedError(type(kernel))


@singledispatch
def kdiag(kernel, X):
    """Diagonal of K(X, X), shape [N]."""
    raise NotImplementedError(type(kernel))


@K.register
def _k_rbf(kernel: SquaredExponential, X, Z=None):
    ls = kernel.lengthscales.value
    var = kernel.variance.value
    d2 = _sq_dist_self(X, ls) if Z is None else scaled_sq_dist(X, Z, ls)
    return var * jnp.exp(-0.5 * d2)


@K.register
def _k_mat32(kernel: Matern32, X, Z=None):
    ls = kernel.lengthscales.value
    var = kernel.variance.value
    d2 = _sq_dist_self(X, ls) if Z is None else scaled_sq_dist(X, Z, ls)
    r = jnp.sqrt(d2 + 1e-36)  # tiny guard: grad of sqrt at 0
    s3r = math.sqrt(3.0) * r
    return var * (1.0 + s3r) * jnp.exp(-s3r)


@kdiag.register
def _kdiag_rbf(kernel: SquaredExponential, X):
    var = kernel.variance.value
    return jnp.full((X.shape[0],), 1.0, dtype=X.dtype) * var


@kdiag.register
def _kdiag_mat32(kernel: Matern32, X):
    var = kernel.variance.value
    return jnp.full((X.shape[0],), 1.0, dtype=X.dtype) * var


KERNELS = {
    "SquaredExponential": SquaredExponential,
    "Matern32": Matern32,
    # reference aliases (cglb/backend/config.py:152-158)
    "rbf": SquaredExponential,
    "mat32": Matern32,
}


def make_kernel(
    name_or_cls,
    input_dim: int,
    variance: float = 1.0,
    lengthscales=1.0,
    dtype=None,
    lower: float = None,
) -> object:
    """Build a kernel with reference-default init: variance=1, ARD lengthscales=1
    (reference: cglb/backend/config.py:73-76), shifted-softplus positive transforms
    with the dtype-dependent lower bound (tensorflow/interface.py:167-197)."""
    from .. import config as _config

    cls = KERNELS[name_or_cls] if isinstance(name_or_cls, str) else name_or_cls
    dtype = dtype or _config.default_float()
    lower = lower if lower is not None else _config.positive_lower_bound(dtype)
    ls = jnp.broadcast_to(jnp.asarray(lengthscales, dtype=dtype), (input_dim,))
    return cls(
        variance=Param.positive(jnp.asarray(variance, dtype=dtype), lower=lower),
        lengthscales=Param.positive(ls, lower=lower),
    )
