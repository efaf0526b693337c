"""Sharded streaming matvec on the virtual 8-device CPU mesh (the Pallas kernel
in interpret mode inside shard_map)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cglb_tpu.ops import kernels as k
from cglb_tpu.parallel import mesh as mesh_mod
from cglb_tpu.parallel.streaming import make_sharded_streaming_operator


@pytest.fixture(scope="module")
def mesh8():
    return mesh_mod.data_mesh(8)


def test_sharded_streaming_matches_dense(mesh8, rng):
    n, d = 8 * 64, 3  # N = mesh * block multiple
    X = jnp.asarray(rng.normal(size=(n, d)))
    p = jnp.asarray(rng.normal(size=(1, n)))
    kern = k.make_kernel("Matern32", d, dtype=np.float64)
    sigma_sq = jnp.asarray(0.25)
    op = make_sharded_streaming_operator(
        mesh8, kern, X, sigma_sq, block_i=64, block_j=64
    )
    got = np.asarray(op(p))
    want = np.asarray(p @ (k.K(kern, X) + 0.25 * jnp.eye(n)))
    scale = np.max(np.abs(want))
    np.testing.assert_allclose(got, want, atol=5e-5 * scale, rtol=5e-5)


@pytest.mark.parametrize("n,B,blocks", [(8 * 64 - 37, 1, (64, 64)),
                                         (300, 3, (32, 64)),
                                         (8 * 16 + 5, 2, (64, 16))])
def test_sharded_streaming_ragged_multi_rhs(mesh8, rng, n, B, blocks):
    """Ragged N (padding up to mesh * block) with B > 1 and unequal row and
    column blocks: value and gradients match the dense fp64 form."""
    d = 3
    X = jnp.asarray(rng.normal(size=(n, d)))
    p = jnp.asarray(rng.normal(size=(B, n)))
    w = jnp.asarray(rng.normal(size=(B, n)))
    kern = k.make_kernel("Matern32", d, lengthscales=0.9, dtype=np.float64)
    sigma_sq = jnp.asarray(0.25)

    def f_sharded(kern, p):
        op = make_sharded_streaming_operator(mesh8, kern, X, sigma_sq,
                                             *blocks)
        return op(p)

    def f_dense(kern, p):
        return p @ (k.K(kern, X) + sigma_sq * jnp.eye(n))

    got, want = f_sharded(kern, p), f_dense(kern, p)
    assert got.shape == (B, n)
    scale = float(jnp.max(jnp.abs(want)))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=1e-5 * scale)
    gs = jax.grad(lambda kk, p: jnp.sum(f_sharded(kk, p) * w),
                  argnums=(0, 1))(kern, p)
    gd = jax.grad(lambda kk, p: jnp.sum(f_dense(kk, p) * w),
                  argnums=(0, 1))(kern, p)
    for a, b in zip(jax.tree_util.tree_leaves(gs),
                    jax.tree_util.tree_leaves(gd)):
        a, b = np.asarray(a), np.asarray(b)
        assert np.max(np.abs(a - b)) <= 1e-4 * np.max(np.abs(b))


def test_sharded_streaming_gradients(mesh8, rng):
    n, d = 8 * 64, 2
    X = jnp.asarray(rng.normal(size=(n, d)))
    p = jnp.asarray(rng.normal(size=(1, n)))
    w = jnp.asarray(rng.normal(size=(1, n)))
    kern = k.make_kernel("rbf", d, dtype=np.float64)
    sigma_sq = jnp.asarray(0.1)

    def f_sharded(kern, p):
        op = make_sharded_streaming_operator(
            mesh8, kern, X, sigma_sq, 64, 64
        )
        return jnp.sum(op(p) * w)

    def f_dense(kern, p):
        return jnp.sum((p @ (k.K(kern, X) + sigma_sq * jnp.eye(n))) * w)

    gs = jax.grad(f_sharded, argnums=(0, 1))(kern, p)
    gd = jax.grad(f_dense, argnums=(0, 1))(kern, p)
    np.testing.assert_allclose(
        float(gs[0].variance.raw), float(gd[0].variance.raw), rtol=2e-4
    )
    np.testing.assert_allclose(
        np.asarray(gs[0].lengthscales.raw), np.asarray(gd[0].lengthscales.raw),
        rtol=5e-4, atol=1e-6,
    )
    np.testing.assert_allclose(
        np.asarray(gs[1]), np.asarray(gd[1]), rtol=1e-4,
        atol=1e-6 * float(jnp.max(jnp.abs(gd[1]))),
    )


def test_sharded_streaming_cg_solves(mesh8, rng):
    """Full CG on the sharded streaming operator converges to the dense solve."""
    from cglb_tpu.ops import cg as cg_mod
    from cglb_tpu.ops import preconditioners as pc

    n, d, m = 8 * 32, 2, 12
    X = jnp.asarray(rng.normal(size=(n, d)))
    kern = k.make_kernel("Matern32", d, dtype=np.float64)
    sigma_sq = jnp.asarray(0.5)
    b = jnp.asarray(rng.normal(size=(1, n)))
    op = make_sharded_streaming_operator(
        mesh8, kern, X, sigma_sq, 32, 32
    )
    v, stats = cg_mod.preconditioned_cg(
        op, b, jnp.zeros_like(b), pc.IdentityPreconditioner(),
        max_error=1e-10, max_iters=400,
    )
    Kmat = np.asarray(k.K(kern, X)) + 0.5 * np.eye(n)
    want = np.linalg.solve(Kmat, np.asarray(b)[0])
    np.testing.assert_allclose(np.asarray(v)[0], want, rtol=2e-3, atol=2e-4)
