"""Two-float (double-f32) elementwise transcendentals.

Why this exists (SURVEY.md section 7 "hard parts"): the O(N M) kernel-matrix
build is elementwise sqrt/exp over ~1e8 entries.  fp64 transcendentals run
in software at a fraction of the f32 rate; in plain f32 the ~1e-7 per-entry
rounding is amplified by the condition number of the Kuu Cholesky trisolve
(kappa ~ 1/sqrt(jitter)) into ~1e-4 relative error on the bound.

The middle path implemented here: every value is carried as an unevaluated
f32 pair (hi, lo) with hi + lo accurate to ~2^-45 relative (double-f32 /
"df32"), and sqrt/exp are evaluated with compensated f32 arithmetic only.
All ops are plain f32 jnp primitives, giving fp64-grade (~1e-12) kernel
entries at close to f32 cost.  Whether this beats native fp64 on a given
card is a measurement (PERF.md, "Kuf routes").

Techniques are the classic double-double building blocks (Dekker 1971,
Knuth TAOCP 4.2.2, and the QD library of Hida-Li-Bailey) instantiated for
f32 pairs without FMA:
  - two_sum / quick_two_sum: exact error of f32 addition
  - two_prod via Veltkamp splitting (f32 split constant 2^12 + 1)
  - df32 sqrt by one exactly-corrected Newton step
  - df32 exp by argument reduction x = k ln2 + t and a compensated Taylor
    series in t, |t| <= ln2/2

The consumer is the "mixed" CGLB common-terms path (models/sgpr.py): the
squared distance d2 is assembled exactly in fp64 (cheap: one small-D matmul
plus O(NM) adds), split into a df32 pair, and the Matern-3/2 / RBF profile is
evaluated here.  Reference semantics being reproduced: the fp64 kernel
builds at cglb/backend/tensorflow/models.py:58-75 (gpflow Kuf) and
cglb/backend/pytorch/models.py:176-213.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["DF", "df_from_f64", "df_to_f64", "df_sqrt", "df_recip",
           "df_exp", "matern32_unit", "rbf_unit"]

# module-level constants stay numpy scalars: jnp constants created at import
# time would become tracers when the import is triggered inside a traced
# function (e.g. under jax.checkpoint)
_SPLIT = np.float32(4097.0)  # 2^12 + 1, Veltkamp split constant for f32
_F32 = np.float32


class DF(NamedTuple):
    """Unevaluated f32 sum: value = hi + lo, |lo| <= ulp(hi)/2."""

    hi: jnp.ndarray
    lo: jnp.ndarray


def _two_sum(a, b) -> DF:
    """Knuth two-sum: a + b = s + e exactly (6 flops)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return DF(s, e)


def _quick_two_sum(a, b) -> DF:
    """Two-sum assuming |a| >= |b| (3 flops)."""
    s = a + b
    e = b - (s - a)
    return DF(s, e)


def _split(a) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Veltkamp: a = hi + lo with hi, lo having <= 12 mantissa bits each."""
    t = _SPLIT * a
    hi = t - (t - a)
    lo = a - hi
    return hi, lo


def _two_prod(a, b) -> DF:
    """a * b = p + e exactly (Dekker, no FMA; 17 flops)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return DF(p, e)


def df_add(x: DF, y: DF) -> DF:
    """df32 + df32 (accurate variant; ~20 flops)."""
    s = _two_sum(x.hi, y.hi)
    t = _two_sum(x.lo, y.lo)
    lo = s.lo + t.hi
    r = _quick_two_sum(s.hi, lo)
    lo = r.lo + t.lo
    return _quick_two_sum(r.hi, lo)


def df_add_f(x: DF, f) -> DF:
    """df32 + f32."""
    s = _two_sum(x.hi, f)
    return _quick_two_sum(s.hi, s.lo + x.lo)


def df_mul(x: DF, y: DF) -> DF:
    """df32 * df32 (~25 flops)."""
    p = _two_prod(x.hi, y.hi)
    e = p.lo + (x.hi * y.lo + x.lo * y.hi)
    return _quick_two_sum(p.hi, e)


def df_mul_f(x: DF, f) -> DF:
    """df32 * f32 (f exactly representable in f32, e.g. a power of two)."""
    p = _two_prod(x.hi, f)
    return _quick_two_sum(p.hi, p.lo + x.lo * f)


def df_mul_c(x: DF, c: float) -> DF:
    """df32 * python-float constant, carrying the constant's f32
    representation error (c = chi + clo): without clo the product picks up
    the ~3e-8 relative rounding of f32(c) — measured as the dominant error
    of an early version of df_exp."""
    chi = _F32(c)
    clo = _F32(c - float(chi))
    p = _two_prod(x.hi, chi)
    e = p.lo + (x.lo * chi + x.hi * clo)
    return _quick_two_sum(p.hi, e)


def df_neg(x: DF) -> DF:
    return DF(-x.hi, -x.lo)


# clamp limit sits well below f32max: _two_prod's Veltkamp split multiplies
# by 4097 (overflows above ~8.3e34) and df_sqrt squares its Newton iterate.
# 1e34 leaves headroom for every df op chain; all kernel profiles are
# identically 0 (underflowed exp) far below this.
_F32_MAX = 1e34


def df_from_f64(x) -> DF:
    """Split an fp64 array into a df32 pair (exact to f32-pair precision).

    Inputs beyond the f32-finite range are clamped: |x| > f32max would make
    hi = inf and every subsequent df op NaN (inf - inf inside two_sum),
    where the pure-fp64 kernel profiles return exactly 0.  Clamping is
    value-safe for the profile consumers — rho(3.4e38) underflows to 0
    anyway — and keeps extreme line-search probes finite."""
    x = jnp.clip(x, -_F32_MAX, _F32_MAX)
    hi = x.astype(_F32)
    lo = (x - hi.astype(x.dtype)).astype(_F32)
    return DF(hi, lo)


def df_to_f64(x: DF):
    return x.hi.astype(jnp.float64) + x.lo.astype(jnp.float64)


def df_sqrt(x: DF) -> DF:
    """sqrt of a non-negative df32 via one exactly-corrected Newton step:
    r = r0 + (x - r0^2) / (2 r0), with r0^2 expanded by two_prod so the
    residual is computed without cancellation loss."""
    r0 = jnp.sqrt(x.hi)
    # guard r0 == 0 (d2 == 0 diagonal entries): sqrt(0) = 0 exactly
    safe = jnp.where(r0 > 0, r0, _F32(1.0))
    p = _two_prod(safe, safe)
    # residual = (x.hi - p.hi) - p.lo + x.lo : x.hi - p.hi is exact (Sterbenz)
    res = (x.hi - p.hi) - p.lo + x.lo
    corr = res / (2.0 * safe)
    out = _quick_two_sum(safe, corr)
    zero = jnp.zeros_like(r0)
    return DF(jnp.where(r0 > 0, out.hi, zero), jnp.where(r0 > 0, out.lo, zero))


def df_recip(y: DF) -> DF:
    """1 / y at df32 grade: two Newton corrections on the f32 seed.

    r1 = r0 + r0 * e with e = 1 - y * r0 squares the seed's 2^-24 relative
    error to ~2^-48; the second (df-arithmetic) correction mops up the
    truncation of the first so the result holds the full pair precision.
    y == 0 or negative-zero diagonals are the caller's concern: the seed
    division produces inf/NaN and every downstream op propagates it (the
    Cholesky leaf kernel, ops/chol_pallas, relies on exactly that for the
    non-PD -> jitter-retry signal)."""
    r0 = _F32(1.0) / y.hi
    e = df_add_f(df_neg(df_mul_f(y, r0)), _F32(1.0))
    r = df_add_f(df_mul_f(e, r0), r0)
    e2 = df_add_f(df_neg(df_mul(y, r)), _F32(1.0))
    return df_add(r, df_mul(e2, r))


# ln2 and 1/ln2 as df32 constants (from fp64)
_LN2_HI = _F32(math.log(2.0))
_LN2_LO = _F32(math.log(2.0) - float(_LN2_HI))
_INV_LN2 = _F32(1.0 / math.log(2.0))

# Taylor 1/k! coefficients for the f32 tail of exp(t) starting at degree 5,
# |t| <= ln2/2 (see df_exp)
_INV_FACT = [1.0 / math.factorial(k) for k in range(5, 13)]


def df_exp(x: DF) -> DF:
    """exp(x) for x <= ~0 (kernel profiles use exp of a negative distance).

    Argument reduction: x = k ln2 + t, |t| <= ln2/2, k integer; exp(x) =
    2^k exp(t).  exp(t) = 1 + t + ... + t^4/24 + t^5 P(t) with terms through
    degree 4 in df32 arithmetic and the tail polynomial P in plain f32 —
    |t^5| <= 5.1e-3 bounds the tail's f32 rounding at ~2e-12 absolute.
    2^k is exact (ldexp).  Inputs below exp-underflow are clamped; for
    x < ~-70 the lo half of 2^k exp(t) goes subnormal and relative accuracy
    decays toward plain f32 — harmless here because such kernel entries are
    < 1e-30 against unit-scale diagonals.  Measured max relative error for
    x in (-50, 0]: 7e-10 (dominated by the two_prod split chain)."""
    xhi = jnp.clip(x.hi, -87.0, 87.0)
    xlo = jnp.where(x.hi == xhi, x.lo, _F32(0.0))
    k = jnp.round(xhi * _INV_LN2)
    # t = x - k*ln2 in df32: k*LN2_HI by exact two_prod, then compensated sums
    p = _two_prod(k, _LN2_HI)
    t = _two_sum(xhi, -p.hi)            # near-cancellation: exact
    tlo = t.lo - p.lo - k * _LN2_LO + xlo
    t = _quick_two_sum(t.hi, tlo)       # |t| <= ln2/2 + eps

    # tail P(t) = 1/5! + t/6! + ... + t^7/12!  in f32 (Horner)
    ptail = _F32(_INV_FACT[-1])
    for c in _INV_FACT[-2::-1]:
        ptail = ptail * t.hi + _F32(c)
    t2 = df_mul(t, t)
    t3 = df_mul(t2, t)
    t4 = df_mul(t2, t2)
    t5 = t4.hi * t.hi  # tail only needs f32
    # e = 1 + t + t^2/2 + t^3/6 + t^4/24 + t^5 * P
    e = df_add_f(df_add(t, df_mul_f(t2, _F32(0.5))), _F32(1.0))
    e = df_add(e, df_mul_c(t3, 1.0 / 6.0))
    e = df_add(e, df_mul_c(t4, 1.0 / 24.0))
    e = df_add_f(e, t5 * ptail)

    # exact power of two by direct exponent-bit construction ((k+127)<<23
    # bitcast to f32) — bit-identical to jnp.ldexp for k in [-126, 127]
    # (guaranteed by the +-87 clamp above: |k| <= 126), and it also lowers
    # inside Pallas kernel bodies, where jnp.ldexp's gather-based lowering
    # does not.  XLA's exp2 is a polynomial approximation (~1e-6 relative),
    # hence bit manipulation rather than 2.0**k.
    ki = k.astype(jnp.int32)
    scale = jax.lax.bitcast_convert_type((ki + 127) << 23, jnp.float32)
    return DF(e.hi * scale, e.lo * scale)


def _matern32_df(d2: DF) -> DF:
    """(1 + sqrt(3) r) exp(-sqrt(3) r), r = sqrt(d2), in df32."""
    r = df_sqrt(d2)
    s3r = df_mul_c(r, math.sqrt(3.0))
    e = df_exp(df_neg(s3r))
    return df_mul(df_add_f(s3r, _F32(1.0)), e)


def _rbf_df(d2: DF) -> DF:
    """exp(-d2 / 2) in df32."""
    return df_exp(df_neg(df_mul_f(d2, _F32(0.5))))


@jax.custom_jvp
def matern32_unit(d2):
    """Unit-variance Matern-3/2 profile rho(d2), fp64 in/out, evaluated in
    df32 (~1e-13 relative; XLA's emulated-fp64 exp never runs).  d2 >= 0."""
    out = _matern32_df(df_from_f64(d2))
    return df_to_f64(out).astype(d2.dtype)


@matern32_unit.defjvp
def _matern32_jvp(primals, tangents):
    (d2,), (d2_dot,) = primals, tangents
    df2 = df_from_f64(d2)
    r = df_sqrt(df2)
    s3r = df_mul_c(r, math.sqrt(3.0))
    e = df_exp(df_neg(s3r))
    rho = df_to_f64(df_mul(df_add_f(s3r, _F32(1.0)), e)).astype(d2.dtype)
    # d rho / d d2 = -1.5 exp(-sqrt(3) r)  (exact: the (1+s3r) product rule
    # cancels the 1/r singularity of dr/dd2)
    drho = -1.5 * df_to_f64(e).astype(d2.dtype)
    return rho, drho * d2_dot


@jax.custom_jvp
def rbf_unit(d2):
    """Unit-variance squared-exponential profile exp(-d2/2), fp64 in/out,
    evaluated in df32."""
    out = _rbf_df(df_from_f64(d2))
    return df_to_f64(out).astype(d2.dtype)


@rbf_unit.defjvp
def _rbf_jvp(primals, tangents):
    (d2,), (d2_dot,) = primals, tangents
    rho = rbf_unit(d2)
    return rho, (-0.5 * rho) * d2_dot
