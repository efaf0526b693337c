"""The Kuf builder of the mixed path (models/sgpr._kuf_block_df32: exact fp64
distances, df32 kernel profile) vs a host numpy fp64 oracle — values and
gradients, both kernel families, on one device and under a mesh.

The contract under test: fp64-grade values (~1e-11 relative per entry) and
gradients w.r.t. (Z, lengthscales, variance, X) that match central finite
differences of the oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cglb_tpu.models import sgpr as sgpr_mod
from cglb_tpu.ops import kernels as k
from cglb_tpu.transforms import Param

FAMILIES = ["Matern32", "SquaredExponential"]


def _setup(rng, family, m=48, n=160, d=5, ls=0.7):
    kern = k.make_kernel(family, d, variance=1.3, lengthscales=ls,
                         dtype=np.float64)
    Z = jnp.asarray(rng.normal(size=(m, d)))
    X = jnp.asarray(rng.normal(size=(n, d)))
    params = sgpr_mod.SGPRParams.create(kern, Z, noise_variance=0.3,
                                        dtype=np.float64)
    return params, Z, X


def _oracle(family, Z, X, ls, var):
    """Kuf in host fp64 by direct differences."""
    Z, X, ls = (np.asarray(a, np.float64) for a in (Z, X, ls))
    d2 = np.sum(((Z[:, None, :] - X[None, :, :]) / ls) ** 2, axis=-1)
    if family == "Matern32":
        r = np.sqrt(3.0 * d2)
        return float(var) * (1.0 + r) * np.exp(-r)
    return float(var) * np.exp(-0.5 * d2)


def _with_kernel(params, kern):
    return type(params)(kernel=kern, inducing_Z=params.inducing_Z,
                        noise_variance=params.noise_variance,
                        mean=params.mean, v0=params.v0)


def _fd(f, x, h=1e-6):
    """Central finite differences of a scalar host function."""
    x = np.asarray(x, np.float64)
    g = np.zeros_like(x)
    for i in np.ndindex(x.shape):
        e = np.zeros_like(x)
        e[i] = h
        g[i] = (f(x + e) - f(x - e)) / (2 * h)
    return g


@pytest.mark.parametrize("family", FAMILIES)
def test_forward_matches_dense_oracle(rng, family):
    params, Z, X = _setup(rng, family)
    got = sgpr_mod._kuf_block_df32(params, Z, X)
    want = _oracle(family, Z, X, params.kernel.lengthscales.value,
                   params.kernel.variance.value)
    err = np.max(np.abs(np.asarray(got) - want)) / np.max(np.abs(want))
    assert err < 1e-10, err


def test_coincident_and_far_points(rng):
    """d2 = 0 columns (Z points duplicated into X) stay finite and exact;
    far-apart points underflow the profile to 0 like the fp64 build."""
    params, Z, X = _setup(rng, "Matern32", m=16, n=32, d=3)
    X = X.at[:16].set(Z)                       # exact duplicates
    X = X.at[16:20].set(X[16:20] + 1e4)        # far away: rho -> 0
    got = sgpr_mod._kuf_block_df32(params, Z, X)
    assert bool(jnp.all(jnp.isfinite(got)))
    var = params.kernel.variance.value
    np.testing.assert_allclose(np.diag(np.asarray(got[:, :16])),
                               float(var), rtol=1e-12)
    assert float(jnp.max(jnp.abs(got[:, 16:20]))) < 1e-30


@pytest.mark.parametrize("family", FAMILIES)
def test_grads_match_xla_path(rng, family):
    """Kernel-parameter cotangents (ls, var) of the df32 route under a
    generic weighted-sum loss vs finite differences of the fp64 oracle."""
    params, Z, X = _setup(rng, family, m=32, n=96, d=4)
    W = rng.normal(size=(params.num_inducing, X.shape[0]))
    ls0 = np.asarray(params.kernel.lengthscales.value)
    var0 = float(params.kernel.variance.value)

    def loss(ls, var):
        kern = type(params.kernel)(
            variance=Param.positive(var, lower=1e-6),
            lengthscales=Param.positive(ls, lower=1e-6))
        return jnp.sum(W * sgpr_mod._kuf_block_df32(
            _with_kernel(params, kern), Z, X))

    g_ls, g_var = jax.grad(loss, argnums=(0, 1))(jnp.asarray(ls0),
                                                 jnp.asarray(var0))
    fd_ls = _fd(lambda ls: np.sum(W * _oracle(family, Z, X, ls, var0)), ls0)
    fd_var = np.sum(W * _oracle(family, Z, X, ls0, 1.0))
    np.testing.assert_allclose(np.asarray(g_ls), fd_ls, rtol=0,
                               atol=2e-5 * np.max(np.abs(fd_ls)))
    np.testing.assert_allclose(float(g_var), fd_var, rtol=2e-5)


def test_grad_wrt_z(rng):
    """dZ of the df32 route vs finite differences of the fp64 oracle."""
    params, Z, X = _setup(rng, "Matern32", m=24, n=64, d=3)
    W = rng.normal(size=(24, 64))
    ls = params.kernel.lengthscales.value
    var = params.kernel.variance.value
    g_got = jax.grad(lambda Zv: jnp.sum(
        W * sgpr_mod._kuf_block_df32(params, Zv, X)))(Z)
    g_want = _fd(lambda Zv: np.sum(W * _oracle("Matern32", Zv, X, ls, var)),
                 Z)
    np.testing.assert_allclose(np.asarray(g_got), g_want, rtol=0,
                               atol=2e-5 * np.max(np.abs(g_want)))


def test_x_cotangent_matches_oracle(rng):
    """The route is plain XLA, so X is differentiable too: its cotangent
    matches finite differences of the fp64 oracle."""
    params, Z, X = _setup(rng, "SquaredExponential", m=16, n=24, d=3)
    W = rng.normal(size=(16, 24))
    ls = params.kernel.lengthscales.value
    var = params.kernel.variance.value
    g_got = jax.grad(lambda Xv: jnp.sum(
        W * sgpr_mod._kuf_block_df32(params, Z, Xv)))(X)
    g_want = _fd(lambda Xv: np.sum(
        W * _oracle("SquaredExponential", Z, Xv, ls, var)), X)
    np.testing.assert_allclose(np.asarray(g_got), g_want, rtol=0,
                               atol=2e-5 * np.max(np.abs(g_want)))


def test_sharded_build_matches_xla_route():
    """Under an 8-device CPU mesh (X row-sharded, GSPMD partitioning the
    XLA route): the value matches the fp64 oracle, and the replicated
    inputs' cotangents (Z, ls, var) match the single-device ones."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from cglb_tpu.parallel import mesh as mesh_mod
    from cglb_tpu.parallel.mesh import DATA_AXIS

    rng = np.random.default_rng(7)
    mesh = mesh_mod.data_mesh(8)
    params, Z, X = _setup(rng, "Matern32", m=16, n=64, d=3)
    Xs = jax.device_put(X, NamedSharding(mesh, P(DATA_AXIS, None)))
    W = jnp.asarray(rng.normal(size=(16, 64)))

    build = jax.jit(lambda p, Zv, Xv: sgpr_mod._kuf_block_df32(p, Zv, Xv))
    got = build(params, Z, Xs)
    want = _oracle("Matern32", Z, X, params.kernel.lengthscales.value,
                   params.kernel.variance.value)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=1e-11)

    def loss(p, Zv, Xv):
        return jnp.sum(W * sgpr_mod._kuf_block_df32(p, Zv, Xv))

    g_sh = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, Z, Xs)
    g_one = jax.grad(loss, argnums=(0, 1))(params, Z, X)
    for a, b in zip(jax.tree_util.tree_leaves(g_sh),
                    jax.tree_util.tree_leaves(g_one)):
        scale = max(float(jnp.max(jnp.abs(b))), 1e-8)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=0, atol=1e-12 * scale)
