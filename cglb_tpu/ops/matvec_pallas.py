"""Streaming kernel matvec: fused distance -> kernel -> contract Pallas kernel.

The KeOps replacement (reference consumes lazy ``kernel(x).add_diag(s2)``
operators in the CG loop at cglb/backend/pytorch/models.py:251-252 and
conjugate_gradient.py:57-66; KeOps JIT-generates a CUDA reduction that keeps
each K entry in registers).  Here the same streaming computation is a Pallas
kernel on the Triton route:

    out[b, j] = sum_i p[b, i] * k(x_i, x_j)        (K never in device memory)

Layout: each program owns one column block of ``block_j`` points and loops
over the row blocks inside the kernel, so the [B, block_j] sums stay in
registers and blocks never share state (they run in no order).  Coordinates
are stored transposed ([D, N], f32, lengthscale-scaled, with the family
constant folded in), so a row or column block of one coordinate is one
contiguous load.  The squared distance comes from direct differences over
the small D on the CUDA cores; every product and sum is elementwise f32 (no
tensor-core dot, hence no TF32), and the sum over row blocks is Kahan-
compensated.

Route: a computation lowered for CUDA gets the compiled Triton kernel; one
lowered for the CPU runs the same kernel in the Pallas interpreter (tests and
CPU runs).  The choice is made when the program is lowered, from the platform
it is compiled for (``lax.platform_dependent``), never from a process
default; any other platform fails to lower.

Differentiability (custom_vjp):
    d/dp            = g K^T                (the same kernel, rows and columns
                                            swapped)
    d/dvariance     = <out, g> / variance  (free from the forward residual)
    d/dlengthscales = a second kernel that writes one [D] partial per column
                      block, sum_ij p_i g_j (dk/dd2)_ij d(d2)/d(ls); XLA sums
                      the partials.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from . import kernels as _k

__all__ = ["kernel_matvec", "kernel_cross_matvec", "make_streaming_operator",
           "BLOCK_I", "BLOCK_J"]

# Row block (the in-kernel loop step) and column block (one program each).
BLOCK_I = 128
BLOCK_J = 32
NUM_WARPS = 4
NUM_STAGES = 2

# family constant folded into the stored coordinates: the kernel's distance
# tile is t = gamma * d2, so the profile needs no per-entry rescale.
_GAMMA = {"rbf": 0.5, "mat32": 3.0}


class _Spec(NamedTuple):
    """Static kernel/tiling description (hashable; nondiff custom_vjp arg)."""

    family: str     # "rbf" | "mat32"
    block_i: int
    block_j: int


def interpret_for(platform: str) -> bool:
    """Whether the kernel runs interpreted on ``platform``: the compiled
    Triton kernel on a GPU, the Pallas interpreter on the CPU.  Any other
    platform has no route."""
    if platform in ("gpu", "cuda"):
        return False
    if platform == "cpu":
        return True
    raise ValueError(f"no streaming-matvec route for platform {platform!r}")


def _check_blocks(block_i: int, block_j: int) -> None:
    """The Triton route loads and stores power-of-two blocks only."""
    for b in (block_i, block_j):
        if b < 1 or b & (b - 1):
            raise ValueError(
                f"block sizes ({block_i}, {block_j}) must be powers of two")


def _on_platform(fn, *args):
    """fn(*args, interpret=...) with the route of the lowering platform."""
    return jax.lax.platform_dependent(
        *args,
        cpu=functools.partial(fn, interpret=interpret_for("cpu")),
        cuda=functools.partial(fn, interpret=interpret_for("cuda")),
    )


def _compiler_params():
    return pl_triton.CompilerParams(num_warps=NUM_WARPS,
                                    num_stages=NUM_STAGES)


def _tile_t(xr_ref, xc, rows):
    """gamma * d2 tile [bi, bj] by direct differences over D."""
    t = None
    for d, xc_d in enumerate(xc):
        diff = xr_ref[d, rows][:, None] - xc_d[None, :]
        t = diff * diff if t is None else t + diff * diff
    return t


def _tile_rho(family: str, t):
    """Unit-variance kernel tile from t = gamma * d2."""
    if family == "rbf":
        return jnp.exp(-t)          # t = d2 / 2
    s = jnp.sqrt(t)                 # t = 3 d2  =>  s = sqrt(3) r
    return (1.0 + s) * jnp.exp(-s)


def _tile_drho_dd2(family: str, t):
    """d(rho)/d(d2) tile from t = gamma * d2."""
    if family == "rbf":
        return -0.5 * jnp.exp(-t)
    return -1.5 * jnp.exp(-jnp.sqrt(t))


def _matvec_kernel(spec: _Spec, n_row_blocks: int, p_ref, xr_ref, xc_ref,
                   out_ref):
    bi, bj = spec.block_i, spec.block_j
    B = p_ref.shape[0]
    cols = pl.ds(pl.program_id(0) * bj, bj)
    xc = [xc_ref[d, cols] for d in range(xc_ref.shape[0])]

    def body(i, carry):
        acc, comp = carry
        rows = pl.ds(i * bi, bi)
        kt = _tile_rho(spec.family, _tile_t(xr_ref, xc, rows))
        new_acc, new_comp = [], []
        for b in range(B):
            contrib = jnp.sum(p_ref[b, rows][:, None] * kt, axis=0)
            # Kahan-compensated sum over row blocks
            y = contrib - comp[b]
            s = acc[b] + y
            new_comp.append((s - acc[b]) - y)
            new_acc.append(s)
        return tuple(new_acc), tuple(new_comp)

    zeros = tuple(jnp.zeros((bj,), jnp.float32) for _ in range(B))
    acc, _ = jax.lax.fori_loop(0, n_row_blocks, body, (zeros, zeros))
    for b in range(B):
        out_ref[b, cols] = acc[b]


def _ls_grad_kernel(spec: _Spec, n_row_blocks: int, p_ref, g_ref, xr_ref,
                    xc_ref, out_ref):
    bi, bj = spec.block_i, spec.block_j
    B = p_ref.shape[0]
    D = xc_ref.shape[0]
    j = pl.program_id(0)
    cols = pl.ds(j * bj, bj)
    xc = [xc_ref[d, cols] for d in range(D)]
    gc = [g_ref[b, cols] for b in range(B)]

    def body(i, acc):
        rows = pl.ds(i * bi, bi)
        kp = _tile_drho_dd2(spec.family, _tile_t(xr_ref, xc, rows))
        # m_ij = (sum_b p_bi g_bj) rho'_ij
        w = None
        for b in range(B):
            outer = p_ref[b, rows][:, None] * gc[b][None, :]
            w = outer if w is None else w + outer
        m = w * kp
        new = []
        for d in range(D):
            diff = xr_ref[d, rows][:, None] - xc[d][None, :]
            new.append(acc[d] + jnp.sum(m * (diff * diff), axis=0))
        return tuple(new)

    acc = jax.lax.fori_loop(
        0, n_row_blocks, body,
        tuple(jnp.zeros((bj,), jnp.float32) for _ in range(D)))
    for d in range(D):
        out_ref[j, d] = jnp.sum(acc[d])


def _padded(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def _pad_cols(a, n_pad):
    return a if a.shape[1] == n_pad else jnp.pad(
        a, ((0, 0), (0, n_pad - a.shape[1])))


def _prepare(X, ls, family: str, multiple: int):
    """[D, N_pad] f32 coordinates X / ls * sqrt(gamma), zero-padded to a
    multiple of ``multiple`` points.  Runs once per operator construction,
    outside the CG loop."""
    Xg = (X / ls) * math.sqrt(_GAMMA[family])
    return _pad_cols(Xg.T.astype(jnp.float32), _padded(X.shape[0], multiple))


def _matvec_from_prep(spec: _Spec, rows, cols, p, *, interpret: bool):
    """Unit-variance streaming matvec from prepared coordinates:
    p [B, Ni] -> p @ rho(Xi, Xj) [B, Nj_pad] (f32).  The row space (summed
    over, where p lives) and the column space (output) may differ — the
    prediction cross-covariance and the sharded operator's per-device
    column slices."""
    ni_pad = rows.shape[1]
    nj_pad = cols.shape[1]
    assert ni_pad % spec.block_i == 0 and nj_pad % spec.block_j == 0
    B = p.shape[0]
    pf = _pad_cols(p.astype(jnp.float32), ni_pad)
    return pl.pallas_call(
        functools.partial(_matvec_kernel, spec, ni_pad // spec.block_i),
        out_shape=jax.ShapeDtypeStruct((B, nj_pad), jnp.float32),
        grid=(nj_pad // spec.block_j,),
        compiler_params=_compiler_params(),
        interpret=interpret,
        name=f"streaming_matvec_{spec.family}",
    )(pf, rows, cols)


def _ls_grad_partials(spec: _Spec, rows, cols, p, g, *, interpret: bool):
    """[n_col_blocks, D] partials of sum_ij m_ij (xg_id - xg_jd)^2 with
    m = (p^T g) * rho'(d2) — one row per column block, summed by XLA."""
    ni_pad = rows.shape[1]
    nj_pad = cols.shape[1]
    D = rows.shape[0]
    n_col_blocks = nj_pad // spec.block_j
    pf = _pad_cols(p.astype(jnp.float32), ni_pad)
    gf = _pad_cols(g.astype(jnp.float32), nj_pad)
    return pl.pallas_call(
        functools.partial(_ls_grad_kernel, spec, ni_pad // spec.block_i),
        out_shape=jax.ShapeDtypeStruct((n_col_blocks, D), jnp.float32),
        grid=(n_col_blocks,),
        compiler_params=_compiler_params(),
        interpret=interpret,
        name=f"streaming_ls_grad_{spec.family}",
    )(pf, gf, rows, cols)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0, 1))
def _streaming_matvec(spec: _Spec, n_out: int, rows, cols, var, ls, p):
    """Differentiable streaming matvec p [B, Ni] -> p @ K(Xi, Xj) [B, n_out].

    The prepared coordinates carry the lengthscale dependence; their
    cotangents are zeroed and the true d/dls comes from the gradient kernel,
    so gradients are correct as long as rows/cols == _prepare(X, ls) (the
    public wrappers guarantee it)."""
    out = _on_platform(functools.partial(_matvec_from_prep, spec),
                       rows, cols, p)
    return var * out[:, :n_out].astype(p.dtype)


def _streaming_fwd(spec, n_out, rows, cols, var, ls, p):
    out = _streaming_matvec(spec, n_out, rows, cols, var, ls, p)
    return out, (rows, cols, var, ls, p, out)


def _streaming_bwd(spec, n_out, res, gout):
    rows, cols, var, ls, p, out = res
    dvar = jnp.sum(out * gout) / var
    # dp = g K^T: the same kernel with the row and column spaces swapped
    dp = var * _on_platform(functools.partial(_matvec_from_prep, spec),
                            cols, rows, gout)[:, :p.shape[1]].astype(p.dtype)
    partials = _on_platform(functools.partial(_ls_grad_partials, spec),
                            rows, cols, p, gout)
    # d(d2)/d(ls_d) = -(2/ls_d)(xs_id - xs_jd)^2 and the kernel summed over
    # gamma-scaled coordinates with the unit-variance rho'
    gamma = _GAMMA[spec.family]
    dls = jnp.sum(partials, axis=0).astype(ls.dtype) * (-2.0 * var / (gamma * ls))
    return jnp.zeros_like(rows), jnp.zeros_like(cols), dvar, dls, dp


_streaming_matvec.defvjp(_streaming_fwd, _streaming_bwd)


def _family_of(kernel) -> str:
    if isinstance(kernel, _k.SquaredExponential):
        return "rbf"
    if isinstance(kernel, _k.Matern32):
        return "mat32"
    raise NotImplementedError(type(kernel))


def _spec_for(kernel, block_i: int, block_j: int) -> _Spec:
    _check_blocks(block_i, block_j)
    return _Spec(family=_family_of(kernel), block_i=block_i, block_j=block_j)


def kernel_matvec(kernel, X, p, block_i: int = BLOCK_I,
                  block_j: int = BLOCK_J) -> jnp.ndarray:
    """p [B, N] -> p @ K(X, X) [B, N], K streamed block by block.

    Convenience wrapper that prepares X per call; hot loops use
    make_streaming_operator (preparation hoisted out of the CG iterations).
    Differentiable w.r.t. kernel parameters and p (custom_vjp)."""
    spec = _spec_for(kernel, block_i, block_j)
    prep = _prepare(X, kernel.lengthscales.value, spec.family,
                    max(block_i, block_j))
    return _streaming_matvec(spec, X.shape[0], prep, prep,
                             kernel.variance.value, kernel.lengthscales.value,
                             p)


def kernel_cross_matvec(kernel, X_rows, X_cols, p, block_i: int = BLOCK_I,
                        block_j: int = BLOCK_J) -> jnp.ndarray:
    """Rectangular streaming contraction: p [B, Nr] -> p @ K(X_rows, X_cols)
    [B, Nc], K streamed block by block.

    Covers the prediction cross-covariance products (e.g. the CGLB posterior
    mean correction K(s,f) v — reference tensorflow/models.py:222) without
    materializing the [S, N] kernel matrix."""
    spec = _spec_for(kernel, block_i, block_j)
    ls = kernel.lengthscales.value
    multiple = max(block_i, block_j)
    rows = _prepare(X_rows, ls, spec.family, multiple)
    cols = _prepare(X_cols, ls, spec.family, multiple)
    return _streaming_matvec(spec, X_cols.shape[0], rows, cols,
                             kernel.variance.value, ls, p)


def make_streaming_operator(kernel, X, sigma_sq, block_i: int = BLOCK_I,
                            block_j: int = BLOCK_J):
    """Matvec closure for (K + sigma^2 I): streaming K + exact diagonal.

    The coordinate preparation runs ONCE here, outside the CG while_loop."""
    spec = _spec_for(kernel, block_i, block_j)
    var = kernel.variance.value
    ls = kernel.lengthscales.value
    prep = _prepare(X, ls, spec.family, max(block_i, block_j))
    n = X.shape[0]

    def matvec(p):
        return _streaming_matvec(spec, n, prep, prep, var, ls, p) + (
            sigma_sq * p)

    return matvec
