"""ops/chol64: fused chol+inverse with matmul-only VJPs.

Correctness bar: values and gradients must match the native
jnp.linalg.cholesky / solve_triangular composition to roundoff and a numpy
fp64 oracle across conditioning, and the Cinv-based gram path must stay
inside the documented eps64*kappa(L)^2 envelope of the trisolve sandwich it
replaces.
"""

import jax
import jax.flatten_util
import jax.numpy as jnp
import jax.scipy.linalg as jsl
import numpy as np
import pytest

from cglb_tpu.ops.chol64 import chol_inv, chol_inv_retry
from cglb_tpu.models import sgpr
from cglb_tpu.ops import kernels as k


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def _native(P):
    L = jnp.linalg.cholesky(P)
    C = jsl.solve_triangular(L, jnp.eye(P.shape[0], dtype=P.dtype),
                             lower=True)
    return L, C


def test_chol_inv_values(rng):
    W = jnp.asarray(rng.normal(size=(16, 30)))
    P = W @ W.T + jnp.eye(16)
    (L1, C1), (L2, C2) = _native(P), chol_inv(P)
    np.testing.assert_allclose(L1, L2, rtol=0, atol=0)
    np.testing.assert_allclose(C1, C2, rtol=0, atol=0)


def test_chol_inv_grads_match_native(rng):
    """VJP through BOTH outputs == native autodiff, to fp64 roundoff."""
    W = jnp.asarray(rng.normal(size=(12, 24)))

    def f(make):
        def g(W):
            P = W @ W.T + jnp.eye(12)
            L, C = make(P)
            return (jnp.sum(jnp.log(jnp.diagonal(L)))
                    + jnp.sum(jnp.sin(C) * jnp.cos(C.T)))
        return g

    v1, g1 = jax.value_and_grad(f(_native))(W)
    v2, g2 = jax.value_and_grad(f(chol_inv))(W)
    assert abs(float(v1 - v2)) == 0.0
    np.testing.assert_allclose(g1, g2, rtol=1e-13, atol=1e-14)


def test_chol_inv_retry_matches_single_attempt_when_finite(rng):
    W = jnp.asarray(rng.normal(size=(10, 20)))

    def via_retry(W):
        L, C = chol_inv_retry(W @ W.T, 1.0)
        return jnp.sum(jnp.log(jnp.diagonal(L))) + jnp.sum(C * C)

    def via_native(W):
        L, C = _native(W @ W.T + jnp.eye(10))
        return jnp.sum(jnp.log(jnp.diagonal(L))) + jnp.sum(C * C)

    v1, g1 = jax.value_and_grad(via_retry)(W)
    v2, g2 = jax.value_and_grad(via_native)(W)
    assert abs(float(v1 - v2)) == 0.0
    np.testing.assert_allclose(g1, g2, rtol=1e-13, atol=1e-14)


def test_chol_inv_retry_escalates_jitter():
    """Eigenvalue -1e-5: base jitter 1e-6 fails, the 1000x retry succeeds."""
    P = jnp.diag(jnp.asarray([1.0, -1e-5, 2.0]))
    L, C = jax.jit(lambda p: chol_inv_retry(p, 1e-6))(P)
    assert bool(jnp.all(jnp.isfinite(L))) and bool(jnp.all(jnp.isfinite(C)))
    # the middle pivot reflects the escalated jitter
    np.testing.assert_allclose(float(L[1, 1]) ** 2, -1e-5 + 1e-3, rtol=1e-12)


def test_chol_inv_retry_gives_up_like_two_attempt_policy():
    """Too indefinite for 1000x jitter -> non-finite result (the caller's
    NaN handling takes over), matching the old 2-attempt _kuu_chol."""
    P = jnp.diag(jnp.asarray([1.0, -1.0, 2.0]))
    L, _ = chol_inv_retry(P, 1e-6)
    assert not bool(jnp.all(jnp.isfinite(L)))


def _spd(rng, M, kappa=None):
    W = rng.normal(size=(M, 2 * M))
    P = W @ W.T / (2 * M) + np.eye(M)
    if kappa is not None:
        # stretch the spectrum to the requested condition number
        w, V = np.linalg.eigh(P)
        w = np.geomspace(1.0 / kappa, 1.0, M)
        P = (V * w) @ V.T
        P = 0.5 * (P + P.T)
    return jnp.asarray(P)


@pytest.mark.parametrize("kappa", [1e1, 1e3, 1e5])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("M", [16, 96])
def test_chol_inv_and_backward_vs_numpy(rng, M, dtype, kappa):
    """chol_inv values and its matmul-only backward vs a numpy fp64 oracle
    across M, dtype and conditioning (random row scaling on top of the
    stretched spectrum).  d/dP of sum(log diag L) = 0.5 logdet P is
    0.5 P^-1; errors scale with eps(dtype) * kappa."""
    P64 = np.asarray(_spd(rng, M, kappa=kappa))
    d = np.exp(0.5 * rng.normal(size=M))
    P64 = P64 * d[:, None] * d[None, :]
    P = jnp.asarray(P64.astype(dtype))
    Pq = np.asarray(P).astype(np.float64)  # the matrix actually factored
    eps = float(np.finfo(dtype).eps)
    kap = np.linalg.cond(Pq)

    L, C = jax.jit(chol_inv)(P)
    assert L.dtype == dtype and C.dtype == dtype
    L, C = np.asarray(L, np.float64), np.asarray(C, np.float64)
    L_ref = np.linalg.cholesky(Pq)
    rec = np.max(np.abs(L @ L.T - Pq)) / np.max(np.abs(Pq))
    assert rec < 50 * M * eps, rec
    assert (np.max(np.abs(L - L_ref)) / np.max(np.abs(L_ref))
            < 50 * M * eps * np.sqrt(kap))
    C_ref = np.linalg.inv(L_ref)
    assert (np.max(np.abs(C - C_ref)) / np.max(np.abs(C_ref))
            < 50 * M * eps * kap)

    g = jax.grad(lambda q: jnp.sum(jnp.log(jnp.diagonal(chol_inv(q)[0]))))(P)
    g_ref = 0.5 * np.linalg.inv(Pq)
    err = (np.max(np.abs(np.asarray(g, np.float64) - g_ref))
           / np.max(np.abs(g_ref)))
    assert err < 50 * M * eps * kap, err


def test_chol_inv_f32_backward_runs_at_highest(rng):
    """The backward's products ask for Precision.HIGHEST, so the f32
    preconditioner factorization is never differentiated in TF32 on the
    GPU."""
    P = _spd(rng, 16).astype(jnp.float32)
    jx = jax.make_jaxpr(jax.grad(
        lambda q: jnp.sum(chol_inv(q)[1])))(P).jaxpr
    precisions = []
    stack = [jx]
    while stack:
        j = stack.pop()
        for eqn in j.eqns:
            if eqn.primitive.name == "dot_general":
                precisions.append(eqn.params["precision"])
            for v in eqn.params.values():
                inner = getattr(v, "jaxpr", None)
                if inner is not None:
                    stack.append(inner)
    assert precisions
    hi = jax.lax.Precision.HIGHEST
    assert all(p == (hi, hi) for p in precisions), precisions


def _params(rng, M=24, D=3):
    kern = k.make_kernel("Matern32", D, variance=1.3, lengthscales=0.9,
                         dtype=np.float64)
    Z = rng.normal(size=(M, D))
    return sgpr.SGPRParams.create(kern, Z, noise_variance=0.3,
                                  dtype=np.float64)


def test_gram_terms_cinv_matches_trisolve_path(rng):
    """The Cinv (matmul) form of _gram_terms == the trisolve sandwich form
    within the documented eps64*kappa^2 envelope; A within f32 grade."""
    params = _params(rng)
    X = jnp.asarray(rng.normal(size=(200, 3)))
    W = jnp.asarray(rng.normal(size=(200, 2)))
    sigma = jnp.sqrt(params.noise_variance.value)
    L, Ci = sgpr._kuu_chol_inv(params, 1e-6)

    A1, AAT1, AW1 = sgpr._gram_terms(params, L, X, sigma, W=W)
    A2, AAT2, AW2 = sgpr._gram_terms(params, L, X, sigma, W=W, Cinv=Ci)
    np.testing.assert_allclose(AAT1, AAT2, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(AW1, AW2, rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(A1, A2, rtol=2e-5, atol=2e-5)  # both f32

    # chunked == unchunked on the Cinv path
    A3, AAT3, AW3 = sgpr._gram_terms(params, L, X, sigma, W=W, Cinv=Ci,
                                     chunk_size=64)
    # chunk partials sum in a different order: fp64 reorder noise only
    np.testing.assert_allclose(AAT2, AAT3, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(AW2, AW3, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(A2, A3, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("chunk_size", [None, 48])
@pytest.mark.parametrize("variance", [1e-3, 1.0, 1e3])
def test_gram_terms_match_host_fp64(rng, variance, chunk_size):
    """The gram-form products (G = Kuf Kuf^T, AAT = Cinv G Cinv^T,
    AW = Cinv Kuf W) vs a host numpy fp64 oracle across entry scales,
    chunked and unchunked."""
    D = 3
    kern = k.make_kernel("Matern32", D, variance=variance, lengthscales=0.9,
                         dtype=np.float64)
    Z = rng.normal(size=(24, D))
    params = sgpr.SGPRParams.create(kern, Z, noise_variance=0.3,
                                    dtype=np.float64)
    X = rng.normal(size=(150, D))
    W = rng.normal(size=(150, 2))
    sigma = np.sqrt(0.3)
    L, Ci = sgpr._kuu_chol_inv(params, 1e-6)
    _, AAT, AW = sgpr._gram_terms(params, L, jnp.asarray(X),
                                  jnp.asarray(sigma), W=jnp.asarray(W),
                                  Cinv=Ci, chunk_size=chunk_size)

    def kmat(A, B):
        r = np.sqrt(3.0 * np.sum(((A[:, None] - B[None]) / 0.9) ** 2, -1))
        return variance * (1.0 + r) * np.exp(-r)

    Lh = np.linalg.cholesky(kmat(Z, Z) + 1e-6 * np.eye(24))
    Ah = np.linalg.solve(Lh, kmat(Z, X)) / sigma
    for got, want in ((AAT, Ah @ Ah.T), (AW, Ah @ W)):
        err = np.max(np.abs(np.asarray(got) - want)) / np.max(np.abs(want))
        assert err < 1e-9, err


def test_mixed_loss_grad_matches_fp64_path(rng):
    """End-to-end: gradients of the mixed (chol64-based) CGLB loss match the
    all-fp64 reference-parity path on a small problem."""
    from cglb_tpu.models import cglb

    params = _params(rng, M=16)
    X = jnp.asarray(rng.normal(size=(120, 3)))
    Y = jnp.asarray(rng.normal(size=(120, 1)))
    v0 = jnp.zeros((1, 120))

    def loss_of(common_dtype):
        cfg = cglb.CGLBConfig(common_dtype=common_dtype)

        def f(p):
            val, _ = cglb.loss(p, X, Y, v0, cfg)
            return val

        return jax.value_and_grad(f)(params)

    v_mixed, g_mixed = loss_of("mixed")
    v_f64, g_f64 = loss_of("float64")
    assert abs(float(v_mixed - v_f64)) < 1e-7 * abs(float(v_f64))
    flat_m = jax.flatten_util.ravel_pytree(g_mixed)[0]
    flat_f = jax.flatten_util.ravel_pytree(g_f64)[0]
    scale = float(jnp.max(jnp.abs(flat_f))) + 1e-30
    np.testing.assert_allclose(flat_m / scale, flat_f / scale,
                               rtol=0, atol=5e-6)
