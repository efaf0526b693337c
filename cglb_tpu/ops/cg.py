"""Preconditioned conjugate gradients under jit.

The reference runs CG two ways: a tf.while_loop compiled by XLA (cglb/backend/
tensorflow/models.py:107-148) and a host-side Python loop over KeOps matvecs with a
cuda-sync per iteration (cglb/backend/pytorch/conjugate_gradient.py:41-86).  This
design is the former, generalized: ``jax.lax.while_loop`` with a static
state pytree, a caller-supplied matvec (dense XLA, Pallas streaming, or shard_map
row-sharded), dynamic stopping on the preconditioner-norm error, and periodic
residual restarts.

Semantics (matching the reference exactly for B=1):
- stop when  0.5 * sum(rz) <= max_error  or  i >= max_iters
- every `restart_iters` steps recompute r = b - v K from scratch (drift control)
- the returned solution carries NO gradient paths; callers wrap in stop_gradient
  (the bound is re-assembled differentiably from the detached v, formalizing
  tf.stop_gradient at models.py:145 / torch.no_grad() at pytorch/models.py:262).

Everything is shape-static: v, r, p are [B, N]; rz is [B]; iteration count is a
traced scalar — no retracing across L-BFGS fevals.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from . import preconditioners as _pc

__all__ = ["CGStats", "CGCarry", "preconditioned_cg", "cg_init", "cg_advance"]

MatVec = Callable[[jnp.ndarray], jnp.ndarray]  # [B, N] -> [B, N]


class CGStats(NamedTuple):
    steps: jnp.ndarray           # int32 []
    residual_error: jnp.ndarray  # []  final 0.5 * sum(rz)


class _CGState(NamedTuple):
    i: jnp.ndarray
    v: jnp.ndarray
    r: jnp.ndarray
    p: jnp.ndarray
    rz: jnp.ndarray


class CGCarry(NamedTuple):
    """Resumable CG solve state: `cg_advance` continues EXACTLY the iterate
    sequence `preconditioned_cg` would have run, so a solve can be cut into
    bounded device dispatches (parallel/dispatch.py) with no algorithmic
    difference — same directions, same restart phase, same stopping rule."""

    state: _CGState
    err_cap: jnp.ndarray  # [] divergence cutoff, fixed at init


def preconditioned_cg(
    matvec: MatVec,
    b: jnp.ndarray,
    v0: jnp.ndarray,
    precond,
    max_error,
    max_iters: int,
    restart_iters: int = 40,
) -> Tuple[jnp.ndarray, CGStats]:
    """Solve v K = b (row-vector convention, K symmetric) approximately.

    Args:
        matvec: computes p -> p K for row-stacked vectors p of shape [B, N].
        b: right-hand side [B, N].
        v0: warm-start solution [B, N].
        precond: preconditioner pytree (see ops/preconditioners.py).
        max_error: stop when 0.5 * r^T P r < max_error (traced or static scalar).
        max_iters: maximum CG iterations (static).
        restart_iters: recompute the residual from scratch every this many steps.

    Returns:
        (v, CGStats).  No gradients flow out of this function's loop; the caller
        is expected to stop_gradient the result (done by models/cglb.py).
    """
    carry = cg_init(matvec, b, v0, precond)
    carry, stats = cg_advance(matvec, b, precond, carry, max_error,
                              max_iters, restart_iters)
    return carry.state.v, stats


def _total_err(rz):
    return 0.5 * jnp.sum(rz)


def cg_init(matvec: MatVec, b: jnp.ndarray, v0: jnp.ndarray,
            precond) -> CGCarry:
    """Warm-start sanitation + initial residual/direction; one matvec."""
    # Sanitize the warm start: a non-finite v0 (e.g. from a diverged feval at
    # an extreme L-BFGS line-search probe) would otherwise poison every later
    # evaluation — NaN < max_error is False, so CG "converges" in 0 steps and
    # returns the NaN v forever, making the whole optimization unrecoverable
    # even after the optimizer backtracks to sane parameters (observed on a
    # kin40k-scale run).
    v0 = jnp.where(jnp.isfinite(v0), v0, jnp.zeros_like(v0))
    r0 = b - matvec(v0)
    z0, rz0 = _pc.mat_vec(precond, r0)
    # Never start WORSE than cold: a finite-but-garbage warm start (carried
    # from a diverged evaluation) can sit so far from the solution that
    # max_iters cannot pull it back, making the loss at GOOD parameters look
    # terrible and misleading the line search.  Cold start costs no extra
    # matvec (K @ 0 = 0), only one preconditioner apply on b.  Decided
    # PER COLUMN (multi-output keeps its good warm columns), and phrased as
    # NOT (warm <= cold) so a NaN/Inf warm residual — huge mixed-sign v0
    # overflowing the matvec — also falls back to cold (plain `cold < warm`
    # is False against NaN, which kept exactly the worst warm starts).
    zb, rzb = _pc.mat_vec(precond, b)
    use_cold = jnp.logical_not(rz0 <= rzb)  # [B]
    col = use_cold[:, None]
    v0 = jnp.where(col, jnp.zeros_like(v0), v0)
    r0 = jnp.where(col, b, r0)
    z0 = jnp.where(col, zb, z0)
    rz0 = jnp.where(use_cold, rzb, rz0)
    state0 = _CGState(i=jnp.asarray(0, jnp.int32), v=v0, r=r0, p=z0, rz=rz0)

    # divergence cutoff: preconditioned CG on an effectively indefinite
    # system (f32 preconditioner/operator noise exceeding sigma^2 at extreme
    # line-search probes) grows the residual geometrically — measured 0.65 ->
    # 1e24 within one 100-iteration solve.  1e6x the starting error is far
    # beyond any transient non-monotonicity of healthy preconditioned CG
    # (restarts bound that at ~10x); beyond it, iterating only burns matvecs
    # on a solve whose huge error bound already dooms the step.
    err_cap = 1e6 * (_total_err(rz0) + 1.0)
    return CGCarry(state=state0, err_cap=err_cap)


def cg_advance(
    matvec: MatVec,
    b: jnp.ndarray,
    precond,
    carry: CGCarry,
    max_error,
    max_iters,
    restart_iters: int = 40,
) -> Tuple[CGCarry, CGStats]:
    """Iterate from ``carry`` until err <= max_error, i >= max_iters, or
    divergence.  ``max_iters`` is the ABSOLUTE iteration cap (the carry's
    ``i`` counts from the original cg_init), and may be a traced scalar —
    a host driver raises it chunk by chunk to bound each device dispatch
    (see the watchdog rationale in parallel/dispatch.py) while the restart
    phase ``i % restart_iters`` stays aligned with the monolithic solve."""
    max_error = jnp.asarray(max_error, dtype=b.dtype)
    total_err = _total_err
    err_cap = carry.err_cap

    def cond_fn(s: _CGState):
        err = total_err(s.rz)
        healthy = jnp.logical_and(jnp.isfinite(err), err < err_cap)
        return jnp.logical_and(
            jnp.logical_and(err > max_error, s.i < max_iters), healthy
        )

    def body_fn(s: _CGState):
        Ap = matvec(s.p)
        denom = jnp.sum(s.p * Ap, axis=-1)  # [B]
        gamma = s.rz / denom  # [B]
        v = s.v + gamma[:, None] * s.p
        restart = (s.i % restart_iters) == (restart_iters - 1)
        r = jax.lax.cond(
            restart,
            lambda: b - matvec(v),
            lambda: s.r - gamma[:, None] * Ap,
        )
        z, new_rz = _pc.mat_vec(precond, r)
        p = jax.lax.cond(
            restart,
            lambda: z,
            lambda: z + (new_rz / s.rz)[:, None] * s.p,
        )
        return _CGState(i=s.i + 1, v=v, r=r, p=p, rz=new_rz)

    final = jax.lax.while_loop(cond_fn, body_fn, carry.state)
    final = jax.tree_util.tree_map(jax.lax.stop_gradient, final)
    stats = CGStats(steps=final.i, residual_error=total_err(final.rz))
    return CGCarry(state=final, err_cap=err_cap), stats
