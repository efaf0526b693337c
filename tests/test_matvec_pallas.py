"""Streaming Pallas matvec vs the dense fp64 oracle (interpret mode on CPU),
plus its route choice, block rules and gradient rule."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cglb_tpu.ops import kernels as k
from cglb_tpu.ops import matvec_pallas as mv
from cglb_tpu.transforms import Param


def _kern(name, d, rng):
    kern = k.make_kernel(name, d, dtype=np.float64)
    # non-trivial hyperparameters
    return dataclasses.replace(
        kern,
        variance=Param.positive(1.7, lower=1e-6),
        lengthscales=Param.positive(
            jnp.asarray(rng.uniform(0.5, 2.0, size=(d,))), lower=1e-6
        ),
    )


def _rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


# true-f32 products and sums: ~1e-7 relative; 1e-5 is the on-card bar
TOL = 1e-5


@pytest.mark.parametrize("family", ["rbf", "mat32"])
def test_streaming_matches_dense(rng, family):
    n, d = 300, 5  # not a multiple of block size: exercises padding
    X = jnp.asarray(rng.normal(size=(n, d)))
    p = jnp.asarray(rng.normal(size=(1, n)))
    kern = _kern(family, d, rng)
    dense = np.asarray(p @ k.K(kern, X))
    got = np.asarray(mv.kernel_matvec(kern, X, p, block_i=128, block_j=64))
    assert _rel_err(got, dense) < TOL


@pytest.mark.parametrize("shape", ["divisible", "ragged", "rectangular"])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("family", ["rbf", "mat32"])
def test_kernel_matches_dense_fp64(rng, family, B, shape):
    """Every (family, batch, shape) cell against p @ K in fp64: N a block
    multiple, N ragged (padding), and a rectangular K(X_rows, X_cols)."""
    d = 4
    n_rows = {"divisible": 256, "ragged": 201, "rectangular": 150}[shape]
    X = jnp.asarray(rng.normal(size=(n_rows, d)))
    p = jnp.asarray(rng.normal(size=(B, n_rows)))
    kern = _kern(family, d, rng)
    if shape == "rectangular":
        Xc = jnp.asarray(rng.normal(size=(90, d)))
        got = mv.kernel_cross_matvec(kern, X, Xc, p, 32, 64)
        want = p @ k.K(kern, X, Xc)
    else:
        got = mv.kernel_matvec(kern, X, p, 32, 64)
        want = p @ k.K(kern, X)
    assert got.shape == want.shape
    assert _rel_err(got, want) < TOL


def test_streaming_operator_includes_noise(rng):
    n, d = 200, 3
    X = jnp.asarray(rng.normal(size=(n, d)))
    p = jnp.asarray(rng.normal(size=(1, n)))
    kern = _kern("rbf", d, rng)
    sigma_sq = jnp.asarray(0.37)
    op = mv.make_streaming_operator(kern, X, sigma_sq, 64, 64)
    dense = np.asarray(p @ (k.K(kern, X) + 0.37 * np.eye(n)))
    got = np.asarray(op(p))
    scale = np.max(np.abs(dense))
    np.testing.assert_allclose(got, dense, atol=3e-6 * scale, rtol=1e-5)


def _ls_grad_dense(kern, Xr, Xc, p, g):
    """d/d(ls) of sum(g * (p @ K(Xr, Xc))) by fp64 autodiff."""
    def f(ls):
        kk = dataclasses.replace(kern, lengthscales=Param.positive(
            ls, lower=1e-6))
        return jnp.sum(g * (p @ k.K(kk, Xr, Xc)))

    return jax.grad(f)(kern.lengthscales.value)


@pytest.mark.parametrize("family", ["rbf", "mat32"])
def test_ls_grad_partials_per_column_block(rng, family):
    """The gradient kernel writes one [D] partial per column block (nothing
    accumulates across the grid); their sum, scaled as in the custom_vjp,
    is the dense lengthscale gradient."""
    d, nr, nc, B = 3, 150, 200, 2
    bi, bj = 32, 64
    kern = _kern(family, d, rng)
    ls = kern.lengthscales.value
    var = kern.variance.value
    Xr = jnp.asarray(rng.normal(size=(nr, d)))
    Xc = jnp.asarray(rng.normal(size=(nc, d)))
    p = jnp.asarray(rng.normal(size=(B, nr)))
    g = jnp.asarray(rng.normal(size=(B, nc)))
    spec = mv._Spec(family=family, block_i=bi, block_j=bj)
    rows = mv._prepare(Xr, ls, family, 64)
    cols = mv._prepare(Xc, ls, family, 64)
    partials = mv._ls_grad_partials(spec, rows, cols, p, g, interpret=True)
    assert partials.shape == (cols.shape[1] // bj, d)
    dls = (jnp.sum(partials, axis=0) * (-2.0 * var / (mv._GAMMA[family] * ls)))
    assert _rel_err(dls, _ls_grad_dense(kern, Xr, Xc, p, g)) < 1e-4


@pytest.mark.parametrize("B", [2, 3])
@pytest.mark.parametrize("family", ["rbf", "mat32"])
def test_custom_vjp_gradients_multi_rhs(rng, family, B):
    """custom_vjp with B > 1: d/dvar from the forward, d/dls from the
    gradient kernel, d/dp from the swapped-role matvec — all vs fp64
    autodiff of the dense form."""
    n, d = 180, 3
    X = jnp.asarray(rng.normal(size=(n, d)))
    p = jnp.asarray(rng.normal(size=(B, n)))
    w = jnp.asarray(rng.normal(size=(B, n)))
    kern = _kern(family, d, rng)
    gs = jax.grad(lambda kk, p: jnp.sum(mv.kernel_matvec(kk, X, p, 64, 32)
                                        * w), argnums=(0, 1))(kern, p)
    gd = jax.grad(lambda kk, p: jnp.sum((p @ k.K(kk, X)) * w),
                  argnums=(0, 1))(kern, p)
    for a, b in zip(jax.tree_util.tree_leaves(gs),
                    jax.tree_util.tree_leaves(gd)):
        assert _rel_err(a, b) < 1e-4


@pytest.mark.parametrize("family", ["rbf", "mat32"])
def test_streaming_gradients_match_dense(rng, family):
    """Gradients of a scalar functional of the matvec w.r.t. kernel params and
    p must match the dense-path autodiff."""
    n, d = 160, 4
    X = jnp.asarray(rng.normal(size=(n, d)))
    p = jnp.asarray(rng.normal(size=(1, n)))
    w = jnp.asarray(rng.normal(size=(1, n)))
    kern = _kern(family, d, rng)

    def f_stream(kern, p):
        out = mv.kernel_matvec(kern, X, p, 64, 64)
        return jnp.sum(out * w)

    def f_dense(kern, p):
        return jnp.sum((p @ k.K(kern, X)) * w)

    gs = jax.grad(f_stream, argnums=(0, 1))(kern, p)
    gd = jax.grad(f_dense, argnums=(0, 1))(kern, p)

    g_var_s = float(gs[0].variance.raw)
    g_var_d = float(gd[0].variance.raw)
    np.testing.assert_allclose(g_var_s, g_var_d, rtol=2e-4)

    g_ls_s = np.asarray(gs[0].lengthscales.raw)
    g_ls_d = np.asarray(gd[0].lengthscales.raw)
    np.testing.assert_allclose(g_ls_s, g_ls_d, rtol=5e-4, atol=1e-6)

    np.testing.assert_allclose(
        np.asarray(gs[1]), np.asarray(gd[1]), rtol=1e-4,
        atol=1e-6 * float(jnp.max(jnp.abs(gd[1]))),
    )


@pytest.mark.parametrize("platform,interpret", [
    ("gpu", False), ("cuda", False), ("cpu", True)])
def test_route_choice(platform, interpret):
    assert mv.interpret_for(platform) is interpret


@pytest.mark.parametrize("platform", ["rocm", "metal"])
def test_route_choice_other_platform_raises(platform):
    with pytest.raises(ValueError, match="no streaming-matvec route"):
        mv.interpret_for(platform)


def _lowered_text(platform):
    X = jnp.ones((256, 3))
    p = jnp.ones((1, 256))
    kern = k.make_kernel("mat32", 3, dtype=np.float64)
    f = jax.jit(lambda kk, p: mv.kernel_matvec(kk, X, p, 64, 64))
    return f.trace(kern, p).lower(lowering_platforms=(platform,)).as_text()


def test_lowering_picks_triton_for_cuda_and_interpreter_for_cpu():
    """The route follows the platform the program is lowered for: a CUDA
    lowering carries the compiled Triton kernel, a CPU lowering none."""
    assert "__gpu$xla.gpu.triton" in _lowered_text("cuda")
    assert "triton" not in _lowered_text("cpu")


@pytest.mark.parametrize("blocks", [(96, 64), (64, 48), (0, 64)])
def test_blocks_must_be_powers_of_two(rng, blocks):
    X = jnp.asarray(rng.normal(size=(64, 2)))
    kern = _kern("rbf", 2, rng)
    with pytest.raises(ValueError, match="powers of two"):
        mv.make_streaming_operator(kern, X, 0.1, *blocks)


@pytest.mark.parametrize("n,multiple,n_pad", [(100, 64, 128), (128, 64, 128),
                                              (1, 32, 32)])
def test_prepare_layout_and_padding(rng, n, multiple, n_pad):
    """Prepared coordinates: [D, N_pad] f32, lengthscale- and gamma-scaled,
    zero in the padded columns."""
    X = jnp.asarray(rng.normal(size=(n, 3)))
    ls = jnp.asarray([0.5, 1.0, 2.0])
    prep = mv._prepare(X, ls, "mat32", multiple)
    assert prep.shape == (3, n_pad) and prep.dtype == jnp.float32
    want = np.asarray(X / ls).T * np.sqrt(3.0)
    np.testing.assert_allclose(np.asarray(prep[:, :n]), want, rtol=1e-6)
    assert not np.any(np.asarray(prep[:, n:]))


def test_cglb_loss_with_streaming_operator_matches_dense(rng):
    """Full CGLB loss evaluated with the streaming matvec agrees with the dense
    path to streaming precision."""
    from cglb_tpu.models import cglb as cglb_mod
    from cglb_tpu.models import sgpr as sgpr_mod

    n, d, m = 192, 3, 12
    X = rng.normal(size=(n, d))
    Y = np.sin(X[:, :1]) + 0.05 * rng.normal(size=(n, 1))
    kern = k.make_kernel("Matern32", d, dtype=np.float64)
    Z = X[rng.choice(n, m, replace=False)]
    params = sgpr_mod.SGPRParams.create(kern, Z, noise_variance=0.5,
                                        dtype=np.float64)
    Xj, Yj = jnp.asarray(X), jnp.asarray(Y)
    cfg = cglb_mod.CGLBConfig(max_error=0.01)
    v0 = cglb_mod.init_v0(n)

    l_dense, aux_d = cglb_mod.loss(params, Xj, Yj, v0, cfg)
    op = mv.make_streaming_operator(params.kernel, Xj,
                                    params.noise_variance.value, 64, 64)
    l_stream, aux_s = cglb_mod.loss(params, Xj, Yj, v0, cfg, matvec=op)
    np.testing.assert_allclose(float(l_stream), float(l_dense), rtol=1e-5)


def test_cross_matvec_matches_dense(rng):
    """Rectangular streaming contraction vs dense cross-kernel product."""
    nr, nc, d = 150, 90, 4
    Xr = jnp.asarray(rng.normal(size=(nr, d)))
    Xc = jnp.asarray(rng.normal(size=(nc, d)))
    p = jnp.asarray(rng.normal(size=(1, nr)))
    kern = _kern("mat32", d, rng)
    got = np.asarray(mv.kernel_cross_matvec(kern, Xr, Xc, p, 64, 64))
    want = np.asarray(p @ k.K(kern, Xr, Xc))
    assert _rel_err(got, want) < TOL


def test_cglb_predict_with_cross_matvec_matches_dense(rng):
    from cglb_tpu.models import cglb as cglb_mod
    from cglb_tpu.models import sgpr as sgpr_mod

    n, d, m, s = 160, 3, 10, 40
    X = rng.normal(size=(n, d))
    Y = np.sin(X[:, :1]) + 0.05 * rng.normal(size=(n, 1))
    Xs = jnp.asarray(rng.normal(size=(s, d)))
    kern = k.make_kernel("Matern32", d, dtype=np.float64)
    params = sgpr_mod.SGPRParams.create(kern, X[:m], noise_variance=0.5,
                                        dtype=np.float64)
    Xj, Yj = jnp.asarray(X), jnp.asarray(Y)
    cfg = cglb_mod.CGLBConfig()
    v0 = cglb_mod.init_v0(n)
    mean_d, var_d = cglb_mod.predict_f(params, Xj, Yj, v0, Xs, cfg,
                                       cg_tolerance=1e-8)
    op = mv.make_streaming_operator(params.kernel, Xj,
                                    params.noise_variance.value, 64, 64)
    cross = lambda v: mv.kernel_cross_matvec(params.kernel, Xj, Xs, v, 64, 64)
    mean_s, var_s = cglb_mod.predict_f(params, Xj, Yj, v0, Xs, cfg,
                                       cg_tolerance=1e-8, matvec=op,
                                       cross_matvec=cross)
    np.testing.assert_allclose(np.asarray(mean_s), np.asarray(mean_d),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(var_s), np.asarray(var_d),
                               rtol=1e-4, atol=1e-8)


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["rbf", "mat32"])
def test_compiled_kernel_matches_dense_on_gpu(gpu, family):
    """The compiled Triton kernel (no interpreter) at a moderate width."""
    rng = np.random.default_rng(1)
    n, d = 8192, 8
    X = jnp.asarray(rng.normal(size=(n, d)))
    p = jnp.asarray(rng.normal(size=(4, n)))
    kern = _kern(family, d, rng)
    got = jax.jit(mv.kernel_matvec)(kern, X, p)
    want = jax.jit(lambda kk, X, p: p @ k.K(kk, X))(kern, X, p)
    assert _rel_err(got, want) < TOL
