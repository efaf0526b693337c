import math

import jax
import jax.numpy as jnp
import numpy as np

from cglb_tpu.ops import kernels as k
from cglb_tpu.models import gpr, sgpr
from cglb_tpu.models.gaussian import mean_apply


def _setup(rng, n=64, d=3, m=12):
    X = rng.normal(size=(n, d))
    w = rng.normal(size=(d, 1))
    Y = np.tanh(X @ w) + 0.1 * rng.normal(size=(n, 1))
    kern = k.make_kernel("Matern32", d, variance=1.4, lengthscales=0.9,
                         dtype=np.float64)
    Z = X[rng.choice(n, m, replace=False)]
    return X, Y, kern, Z


def _naive_lml(K, sigma_sq, err):
    n = K.shape[0]
    Ky = K + sigma_sq * np.eye(n)
    sign, logdet = np.linalg.slogdet(Ky)
    quad = float(err.T @ np.linalg.solve(Ky, err))
    return -0.5 * (n * math.log(2 * math.pi) + logdet + quad)


def test_gpr_lml_matches_numpy_oracle(rng):
    X, Y, kern, _ = _setup(rng)
    params = gpr.GPRParams.create(kern, noise_variance=0.8, dtype=np.float64)
    got = float(gpr.log_marginal_likelihood(params, jnp.asarray(X), jnp.asarray(Y)))
    Kxx = np.asarray(k.K(kern, jnp.asarray(X)))
    sigma_sq = float(params.noise_variance.value)
    err = Y - np.asarray(mean_apply(params.mean, jnp.asarray(X)))
    want = _naive_lml(Kxx, sigma_sq, err)
    np.testing.assert_allclose(got, want, rtol=1e-9)


def test_gpr_predict_matches_closed_form(rng):
    X, Y, kern, _ = _setup(rng, n=40)
    Xs = rng.normal(size=(7, 3))
    params = gpr.GPRParams.create(kern, noise_variance=0.5, dtype=np.float64)
    mean, var = gpr.predict_f(params, jnp.asarray(X), jnp.asarray(Y), jnp.asarray(Xs))
    Kxx = np.asarray(k.K(kern, jnp.asarray(X)))
    Ksx = np.asarray(k.K(kern, jnp.asarray(Xs), jnp.asarray(X)))
    Kss = np.asarray(k.kdiag(kern, jnp.asarray(Xs)))
    sigma_sq = float(params.noise_variance.value)
    Ky = Kxx + sigma_sq * np.eye(40)
    want_mean = Ksx @ np.linalg.solve(Ky, Y)
    want_var = Kss - np.sum(Ksx * np.linalg.solve(Ky, Ksx.T).T, axis=1)
    np.testing.assert_allclose(np.asarray(mean), want_mean, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(np.asarray(var)[:, 0], want_var, rtol=1e-6, atol=1e-9)


def test_sgpr_elbo_against_dense_oracle(rng):
    """ELBO = log N(y | 0, Qff + s2 I) - 1/(2 s2) tr(K - Q), computed densely."""
    X, Y, kern, Z = _setup(rng)
    params = sgpr.SGPRParams.create(kern, Z, noise_variance=0.7, dtype=np.float64)
    got = float(sgpr.elbo(params, jnp.asarray(X), jnp.asarray(Y), jitter=0.0))

    Kuf = np.asarray(k.K(kern, jnp.asarray(Z), jnp.asarray(X)))
    Kuu = np.asarray(k.K(kern, jnp.asarray(Z)))
    Qff = Kuf.T @ np.linalg.solve(Kuu, Kuf)
    sigma_sq = float(params.noise_variance.value)
    err = Y
    lml_q = _naive_lml(Qff, sigma_sq, err)
    kd = np.asarray(k.kdiag(kern, jnp.asarray(X)))
    trace_term = (np.sum(kd) - np.trace(Qff)) / (2.0 * sigma_sq)
    want = lml_q - trace_term
    np.testing.assert_allclose(got, want, rtol=1e-8)


def test_sgpr_bracket_elbo_lml_upper(rng):
    """ELBO <= exact LML <= Titsias upper bound (the reference's de-facto
    integration test, SURVEY.md section 4)."""
    X, Y, kern, Z = _setup(rng)
    sp = sgpr.SGPRParams.create(kern, Z, noise_variance=0.6, dtype=np.float64)
    gp = gpr.GPRParams.create(kern, noise_variance=0.6, dtype=np.float64)
    Xj, Yj = jnp.asarray(X), jnp.asarray(Y)
    e = float(sgpr.elbo(sp, Xj, Yj))
    u = float(sgpr.upper_bound(sp, Xj, Yj))
    l = float(gpr.log_marginal_likelihood(gp, Xj, Yj))
    assert e <= l + 1e-8
    assert l <= u + 1e-8


def test_sgpr_equals_gpr_when_inducing_is_full_data(rng):
    X, Y, kern, _ = _setup(rng, n=30)
    sp = sgpr.SGPRParams.create(kern, X, noise_variance=0.5, dtype=np.float64)
    gp = gpr.GPRParams.create(kern, noise_variance=0.5, dtype=np.float64)
    Xj, Yj = jnp.asarray(X), jnp.asarray(Y)
    e = float(sgpr.elbo(sp, Xj, Yj, jitter=1e-10))
    l = float(gpr.log_marginal_likelihood(gp, Xj, Yj))
    np.testing.assert_allclose(e, l, rtol=1e-5)
    # predictions agree too
    Xs = jnp.asarray(np.random.default_rng(1).normal(size=(5, 3)))
    m1, v1 = sgpr.predict_f(sp, Xj, Yj, Xs, jitter=1e-10)
    m2, v2 = gpr.predict_f(gp, Xj, Yj, Xs)
    np.testing.assert_allclose(np.asarray(m1), np.asarray(m2), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(v1), np.asarray(v2), rtol=1e-3, atol=1e-6)


def test_sgpr_n2m_is_lower_bound(rng):
    X, Y, kern, Z = _setup(rng)
    sp = sgpr.SGPRParams.create(kern, Z, noise_variance=0.6, dtype=np.float64)
    gp = gpr.GPRParams.create(kern, noise_variance=0.6, dtype=np.float64)
    Xj, Yj = jnp.asarray(X), jnp.asarray(Y)
    b = float(sgpr.elbo_n2m(sp, Xj, Yj))
    l = float(gpr.log_marginal_likelihood(gp, Xj, Yj))
    assert b <= l + 1e-8


def test_elbo_gradients_finite(rng):
    X, Y, kern, Z = _setup(rng, n=32, m=8)
    sp = sgpr.SGPRParams.create(kern, Z, noise_variance=0.9, dtype=np.float64)
    g = jax.grad(lambda p: sgpr.elbo(p, jnp.asarray(X), jnp.asarray(Y)))(sp)
    leaves = jax.tree_util.tree_leaves(g)
    assert all(np.isfinite(np.asarray(leaf)).all() for leaf in leaves)


def test_common_terms_chunked_matches_unchunked(rng):
    """Column-chunked common terms (the large-N fp64 memory path) are exact."""
    X, Y, kern, Z = _setup(rng, n=123, m=9)
    params = sgpr.SGPRParams.create(kern, Z, noise_variance=0.7, dtype=np.float64)
    ct1 = sgpr.common_terms(params, jnp.asarray(X))
    ct2 = sgpr.common_terms(params, jnp.asarray(X), chunk_size=32)
    np.testing.assert_allclose(np.asarray(ct1.A), np.asarray(ct2.A),
                               rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(np.asarray(ct1.AAT), np.asarray(ct2.AAT),
                               rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(np.asarray(ct1.LB), np.asarray(ct2.LB),
                               rtol=1e-12, atol=1e-13)


def test_sgprn2m_stable_in_sigma_collapse(rng):
    """The n2m log-trace term cancels catastrophically as Q -> K with tiny
    noise; the N*sigma^2 clamp must keep the bound AND a short optimization
    run finite (VERDICT r1 weak #4)."""
    import jax

    n, d = 128, 2
    X = rng.normal(size=(n, d))
    Y = np.sin(X[:, :1])
    # M = N inducing points at the data + huge signal variance + collapsed
    # noise: trace_kff - trace_qrest goes negative in fp64 without the clamp
    kern = k.make_kernel("Matern32", d, dtype=np.float64, variance=1e6)
    params = sgpr.SGPRParams.create(kern, X, noise_variance=1e-10,
                                    dtype=np.float64, variance_lower=1e-12)
    Xj, Yj = jnp.asarray(X), jnp.asarray(Y)
    val = float(sgpr.elbo_n2m(params, Xj, Yj))
    assert np.isfinite(val), f"clamped elbo_n2m not finite: {val}"
    g = jax.grad(lambda p: -sgpr.elbo_n2m(p, Xj, Yj))(params)
    assert np.isfinite(float(g.noise_variance.raw))

    # 30 optimization steps through the training loop stay finite
    from cglb_tpu.utils import training as tr

    def loss_fn(p, state, Xa, Ya):
        return -sgpr.elbo_n2m(p, Xa, Ya), state

    res = tr.lbfgs_minimize(loss_fn, params, None, 30, data=(Xj, Yj))
    assert np.isfinite(res.final_loss)


def test_elbo_upper_mixed_match_fp64(rng):
    """The df32/gram fast path for the metric bracket (elbo/upper_bound)
    matches the fp64 path to fp64-grade accuracy, chunked and unchunked."""
    from cglb_tpu.ops import kernels as k
    from cglb_tpu.models import sgpr

    n, d, m = 700, 4, 48
    X = rng.normal(size=(n, d))
    w = rng.normal(size=(d, 1))
    Y = np.tanh(X @ w) + 0.1 * rng.normal(size=(n, 1))
    kern = k.make_kernel("Matern32", d, variance=1.4, lengthscales=0.9,
                         dtype=np.float64)
    Z = X[rng.choice(n, m, replace=False)]
    params = sgpr.SGPRParams.create(kern, Z, noise_variance=0.05,
                                    dtype=np.float64)
    Xj, Yj = jnp.asarray(X), jnp.asarray(Y)

    e64 = float(sgpr.elbo(params, Xj, Yj))
    emx = float(sgpr.elbo(params, Xj, Yj, mixed=True))
    np.testing.assert_allclose(emx, e64, rtol=1e-9)
    u64 = float(sgpr.upper_bound(params, Xj, Yj))
    umx = float(sgpr.upper_bound(params, Xj, Yj, mixed=True))
    np.testing.assert_allclose(umx, u64, rtol=1e-9)

    # gradients agree (the sgpr kind trains on elbo with mixed by default);
    # the bound VALUE is fp64-grade (asserted above at 1e-9).
    g64 = jax.grad(lambda p: sgpr.elbo(p, Xj, Yj))(params)
    gmx = jax.grad(lambda p: sgpr.elbo(p, Xj, Yj, mixed=True))(params)
    for a, b in zip(jax.tree_util.tree_leaves(g64),
                    jax.tree_util.tree_leaves(gmx)):
        a, b = np.asarray(a), np.asarray(b)
        scale = max(np.max(np.abs(a)), 1e-12)
        np.testing.assert_allclose(b / scale, a / scale, atol=1e-5)


def test_gram_terms_chunked_matches_unchunked(rng):
    """The chunked gram path (lax.map accumulation of G/U/A — the branch
    that actually runs at production scale) must agree with the unchunked
    branch and the trisolve path, including the W factor and with_a=False."""
    from cglb_tpu.ops import kernels as k
    from cglb_tpu.models import sgpr

    n, d, m = 500, 3, 24
    X = jnp.asarray(rng.normal(size=(n, d)))
    W = jnp.asarray(rng.normal(size=(n, 2)))
    kern = k.make_kernel("Matern32", d, dtype=np.float64)
    Z = np.asarray(X)[rng.choice(n, m, replace=False)]
    params = sgpr.SGPRParams.create(kern, Z, noise_variance=0.2,
                                    dtype=np.float64)
    L = sgpr._kuu_chol(params, 1e-6)
    sigma = jnp.sqrt(params.noise_variance.value)

    A_u, AAT_u, AW_u = sgpr._gram_terms(params, L, X, sigma, W=W)
    A_c, AAT_c, AW_c = sgpr._gram_terms(params, L, X, sigma, W=W,
                                        chunk_size=128)
    np.testing.assert_allclose(np.asarray(AAT_c), np.asarray(AAT_u),
                               rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(np.asarray(AW_c), np.asarray(AW_u),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np.asarray(A_c), np.asarray(A_u),
                               rtol=1e-5, atol=1e-6)  # f32 A

    # vs the fp64 trisolve path
    A64, AAT64, AW64 = sgpr._kuf_terms(params, L, X, sigma, W=W)
    np.testing.assert_allclose(np.asarray(AAT_c), np.asarray(AAT64),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(np.asarray(AW_c), np.asarray(AW64),
                               rtol=1e-9, atol=1e-10)

    # with_a=False skips A on both branches
    A_n, AAT_n, _ = sgpr._gram_terms(params, L, X, sigma, W=W, with_a=False,
                                     chunk_size=128)
    assert A_n is None
    np.testing.assert_allclose(np.asarray(AAT_n), np.asarray(AAT_c),
                               rtol=1e-12)


def test_upper_bound_stable_in_sigma_collapse(rng):
    """upper_bound's trace slack cslack = tr(K) - tr(Q) cancels
    catastrophically as Q -> K at large M; un-clamped it goes negative,
    silently invalidating the bound (corrected_noise < sigma^2) and NaN-ing
    the cholesky once corrected_noise <= 0 (VERDICT r2 weak #5)."""
    n, d = 128, 2
    X = rng.normal(size=(n, d))
    Y = np.sin(X[:, :1])
    # inducing points == data + huge variance + collapsed noise: the slack
    # is mathematically 0 and numerically ~ +/- eps64 * n * variance
    kern = k.make_kernel("Matern32", d, dtype=np.float64, variance=1e6)
    params = sgpr.SGPRParams.create(kern, X, noise_variance=1e-10,
                                    dtype=np.float64, variance_lower=1e-12)
    Xj, Yj = jnp.asarray(X), jnp.asarray(Y)
    for mixed in (False, True):
        ub = float(sgpr.upper_bound(params, Xj, Yj, mixed=mixed))
        assert np.isfinite(ub), f"upper_bound (mixed={mixed}) not finite: {ub}"
        # the bound must still sit above the (finite) ELBO
        el = float(sgpr.elbo(params, Xj, Yj, mixed=mixed))
        if np.isfinite(el):
            assert ub >= el - 1e-6


def test_chunk_remat_matches_stored_backward(rng):
    """Chunk-level remat (jax.checkpoint on the lax.map body — the
    houseelectric-scale memory fix: stored scan residuals are [M, N]-
    aggregate) must leave the end-to-end CGLB loss AND its gradients
    bit-comparable on both the gram and the exact-fp64 chunked paths."""
    from cglb_tpu.models import cglb as cglb_mod
    from cglb_tpu.models import sgpr

    n, d, m = 320, 3, 16
    X = jnp.asarray(rng.normal(size=(n, d)))
    Y = jnp.asarray(np.sin(np.asarray(X[:, :1]))
                    + 0.1 * rng.normal(size=(n, 1)))
    kern = k.make_kernel("Matern32", d, dtype=np.float64)
    Z = np.asarray(X)[rng.choice(n, m, replace=False)]
    params = sgpr.SGPRParams.create(kern, Z, noise_variance=0.2,
                                    dtype=np.float64)
    L = sgpr._kuu_chol(params, 1e-6)
    Lf, Ci = sgpr._kuu_chol_inv(params, 1e-6)
    sigma = jnp.sqrt(params.noise_variance.value)
    W = jnp.asarray(rng.normal(size=(n, 2)))

    # unit level: values identical with/without remat, both chunked paths
    for fn in (
        lambda r: sgpr._gram_terms(params, Lf, X, sigma, W=W, Cinv=Ci,
                                   chunk_size=96, remat=r),
        lambda r: sgpr._kuf_terms(params, L, X, sigma, W=W,
                                  chunk_size=96, remat=r),
    ):
        out0, out1 = fn(False), fn(True)
        for a, b in zip(out0, out1):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # end to end: loss + grads with the remat flag forced on and chunking
    # forced by a lowered auto threshold (the production trigger), default
    # mixed/gram config
    cfg = cglb_mod.CGLBConfig(max_error=0.01)
    v0 = cglb_mod.init_v0(n)

    def loss_of(p, remat):
        b, _ = cglb_mod.bound(p, X, Y, v0, cfg, remat_common_terms=remat)
        return -b

    saved = sgpr.CHUNK_THRESHOLD_ELEMENTS
    sgpr.CHUNK_THRESHOLD_ELEMENTS = 1024  # 320*16 > 1024 -> chunked
    try:
        l0, g0 = jax.value_and_grad(lambda p: loss_of(p, False))(params)
        l1, g1 = jax.value_and_grad(lambda p: loss_of(p, True))(params)
    finally:
        sgpr.CHUNK_THRESHOLD_ELEMENTS = saved
    np.testing.assert_allclose(float(l1), float(l0), rtol=1e-12)
    for a, b in zip(jax.tree.leaves(g0), jax.tree.leaves(g1)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   rtol=1e-7, atol=1e-12)
