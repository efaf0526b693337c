"""Training loops: scipy L-BFGS-B bridge, pure-JAX L-BFGS, and Adam.

Three optimizers, mirroring the reference's surface:

- ``scipy``: host scipy.optimize L-BFGS-B driving a jitted value_and_grad, with
  the reference's restart-on-early-stop semantics — scipy sometimes terminates
  before the step budget, so minimize is re-invoked with the remaining budget
  (2 sequential attempts; reference: cglb/backend/tensorflow/interface.py:309-337,
  4 attempts with inducing freezing on the torch side interface.py:445-543).
- ``lbfgs``: optax.lbfgs with zoom linesearch — fully on-device (no
  host<->device parameter round-trip per feval).
- ``adam_<lr>``: optax.adam loop (reference: tensorflow/interface.py:339-355).

The CG warm-start v0 is threaded through every path as explicit carry state
(the reference mutates model.v0 instead; tensorflow/models.py:172).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
import scipy.optimize

from . import flatten as _fl
from .logging import Logger

__all__ = ["scipy_minimize", "adam_minimize", "lbfgs_minimize",
           "native_lbfgs_minimize", "OptimizeResult"]

# loss_fn(params, carry_state, *data) -> (loss, new_carry_state).
# carry may be None.  `data` carries large arrays (X, Y, ...) explicitly so
# they cross the jit boundary as parameters instead of being embedded into the
# compiled program as constants (embedding a multi-GB kernel matrix literal
# breaks compilation at scale).
LossFn = Callable[..., Tuple[jnp.ndarray, Any]]


class OptimizeResult(NamedTuple):
    params: Any
    state: Any          # final carry (e.g. CGLB aux with warm-start v)
    num_iters: int
    final_loss: float
    # optimizer-specific diagnostics (scipy: per-attempt status/message/nit/
    # nfev + penalty-feval count) — surfaced into results.json so early
    # terminations of L-BFGS-B are observable from run artifacts
    info: dict = {}


def _jit_value_and_grad(loss_fn: LossFn):
    def wrapped(params, state, *data):
        loss, new_state = loss_fn(params, state, *data)
        return loss, new_state

    return jax.jit(jax.value_and_grad(wrapped, has_aux=True))


def _freeze_inducing(params):
    """Re-partition: inducing points become non-trainable (the torch-backend
    restart schedule freezes them after the 2nd attempt,
    reference: cglb/backend/pytorch/interface.py:507-543)."""
    from ..struct import replace as _replace
    from ..transforms import Param

    z = getattr(params, "inducing_Z", None)
    if z is None or not z.trainable:
        return params
    return _replace(
        params,
        inducing_Z=Param(raw=z.raw, transform=z.transform, trainable=False),
    )


def scipy_minimize(
    loss_fn: LossFn,
    params,
    state,
    num_steps: int,
    logger: Optional[Logger] = None,
    attempts: int = 2,
    ftol: float = 0.0,
    gtol: float = 0.0,
    feval_stats_fn: Callable[[Any], dict] = None,
    data: tuple = (),
    freeze_inducing_after: Optional[int] = None,
    sync_fn: Callable[[Any, Any], None] = None,
    vg: Callable = None,
    _reset_timer: bool = True,
) -> OptimizeResult:
    """L-BFGS-B on the host, jitted loss+grad on device.

    Parameters are flattened to one fp64 vector (reference:
    pytorch/optimizer.py:20-98); each feval ships the vector to device, runs the
    compiled value_and_grad once, and ships loss+grad back.  The carry state
    (CG warm start) is updated on every feval, including line-search evals —
    TF-backend semantics (v0.assign inside the objective, models.py:172).

    attempts: scipy sometimes stops before the step budget; minimize is
    re-invoked with the remaining budget (reference TF backend uses 2
    attempts: tensorflow/interface.py:327-337).  Each attempt deliberately
    gets maxiter=remaining (NOT an even split): the restarts are a
    workaround for scipy L-BFGS-B's early-stop bug and only engage when an
    attempt terminates before its budget — identical to the reference's
    schedule (pytorch/interface.py:507-543), where a first attempt that
    runs the full budget simply ends the optimization.
    freeze_inducing_after: attempt index at which inducing points become
    non-trainable (the torch backend's 4-attempt schedule freezes them after
    the 2nd: pytorch/interface.py:507-543).
    vg: optional pre-jitted value_and_grad of loss_fn — callers invoking
    this bridge repeatedly (scipy_tol_minimize's tolerance levels) pass one
    shared instance so every level hits the SAME in-memory executable cache.
    _reset_timer: False keeps the logger's wall-clock running across calls
    (multi-level schedules are ONE run for metric-vs-time purposes).
    """
    vg = vg if vg is not None else _jit_value_and_grad(loss_fn)

    holder = {
        "params": params,
        "state": state,
        "loss": np.inf,
        "unflatten": _fl.make_unflatten(params),
        "x": None,
        "x_good": None,  # last finite-loss iterate (penalty-bowl center)
        "nfev": 0,
        "penalty_fevals": 0,
    }

    # Non-finite losses (extreme line-search probes: CG divergence, cholesky
    # NaN) are returned to L-BFGS-B as a smooth finite penalty bowl centered
    # at the last good iterate instead of raw NaN.  scipy's dcsrch line
    # search handles NaN by blind repeated halving (~12 wasted fevals per
    # probe episode); a finite value with an informative slope lets its
    # polynomial interpolation back off in 1-2 evaluations.
    _PENALTY = 1e12

    def fun(x):
        holder["nfev"] += 1
        p = holder["unflatten"](x)
        (loss, new_state), grads = vg(p, holder["state"], *data)
        holder["params"] = p
        holder["state"] = new_state
        holder["x"] = np.array(x, copy=True)
        if logger is not None and feval_stats_fn is not None:
            logger.log_for_feval(**feval_stats_fn(new_state))
        loss_f = float(loss)
        if not np.isfinite(loss_f):
            holder["penalty_fevals"] += 1
            xg = holder["x_good"]
            dx = x - xg if xg is not None else np.zeros_like(x)
            f = _PENALTY * (1.0 + float(dx @ dx))
            g = (2.0 * _PENALTY) * dx
            return f, np.asarray(g, dtype=np.float64)
        holder["loss"] = loss_f
        holder["x_good"] = np.array(x, copy=True)
        g = _fl.flatten_grads_like(p, grads)
        return loss_f, np.asarray(g, dtype=np.float64)

    def callback(xk):
        # publish the accepted iterate BEFORE the logger fires: the logger's
        # metric closures read live state from the model object, and without
        # this every mid-run holdout metric silently evaluated at the INITIAL
        # parameters (caught end-to-end: flat metric-vs-time curves).
        if sync_fn is not None:
            sync_fn(holder["unflatten"](xk), holder["state"])
        if logger is not None:
            logger(None)

    if logger is not None and _reset_timer:
        logger.timer.reset()
        logger.timer.start()

    total_iters = 0
    remaining = num_steps
    attempt_log = []
    for attempt in range(attempts):
        if remaining <= 0:
            break
        if freeze_inducing_after is not None and attempt == freeze_inducing_after:
            holder["params"] = _freeze_inducing(holder["params"])
            holder["unflatten"] = _fl.make_unflatten(holder["params"])
            # partition changed; vector space differs
            holder["x"] = None
            holder["x_good"] = None
        res = scipy.optimize.minimize(
            fun,
            _fl.flatten_trainable(holder["params"]),
            jac=True,
            method="L-BFGS-B",
            options=dict(maxiter=remaining, ftol=ftol, gtol=gtol),
            callback=callback,
        )
        total_iters += int(res.nit)
        remaining -= int(res.nit)
        attempt_log.append({
            "status": int(res.status),
            "message": str(res.message),
            "nit": int(res.nit),
            "nfev": int(res.nfev),
        })
        # refresh loss/state at the accepted point — but only when scipy's
        # final feval wasn't already there (an extra timed objective
        # evaluation per attempt is wasted wall-clock otherwise)
        if holder["x"] is None or not np.array_equal(res.x, holder["x"]):
            holder["params"] = holder["unflatten"](res.x)
            (loss, new_state), _ = vg(holder["params"], holder["state"], *data)
            holder["state"] = new_state
            holder["loss"] = float(loss)

    return OptimizeResult(
        params=holder["params"],
        state=holder["state"],
        num_iters=total_iters,
        final_loss=holder["loss"],
        info={
            "opt/num_iters": total_iters,
            "opt/num_fevals": holder["nfev"],
            "opt/penalty_fevals": holder["penalty_fevals"],
            "opt/attempts": attempt_log,
        },
    )


def scipy_tol_minimize(
    loss_fn: LossFn,
    loss_fn_tol: Callable,
    params,
    state,
    num_steps: int,
    logger: Optional[Logger] = None,
    tol_start: float = 1.0,
    tol_floor: float = 1e-2,
    tol_factor: float = 0.1,
    attempts_per_level: int = 1,
    feval_stats_fn: Callable[[Any], dict] = None,
    data: tuple = (),
    sync_fn: Callable[[Any, Any], None] = None,
    on_level: Callable[[float], None] = None,
    tol_resume: float = None,
) -> OptimizeResult:
    """Adaptive CG-tolerance L-BFGS schedule (first-party improvement).

    on_level: called with the live tolerance at each level start — the
    backend checkpoints it so ``--resume`` can re-enter the schedule at
    the level a killed run died in (``tol_resume``) instead of re-walking
    the loose levels the iterate already escaped.

    Fixed-tolerance CGLB training stalls once true per-iteration
    improvements fall below the CG stopping slack's objective jitter
    (O(max_error) absolute through the warm-start carry): L-BFGS-B's line
    search then correctly reports zero reduction against noise, far from
    the model's attainable loss.
    The reference runs a fixed max_error=1.0 throughout and shares the
    stall (cglb_experiments/xpert-main.toml:15-35 protocol).

    This schedule runs the standard bridge at ``tol_start`` first (the
    cheap-CG-tier program plain scipy uses — shared compile cache), then,
    each time scipy converges with budget left, multiplies the tolerance by
    ``tol_factor`` and restarts L-BFGS from the solution using
    ``loss_fn_tol`` — the tolerance rides as a TRACED scalar argument, so
    every tightened level reuses ONE compiled program.  Tightening shrinks
    the jitter floor under the line search 10x per level until the step
    budget or ``tol_floor`` is reached.  The CGLB bound stays valid at
    every level (it is a lower bound for ANY v; tighter CG only raises it).

    attempts_per_level defaults to 1 (not scipy_minimize's 2): under this
    schedule every level transition IS a restart, so same-tolerance
    re-attempts would only spend budget re-confirming the stall the next
    level is about to break.  A spurious L-BFGS-B early stop (the bug the
    2-attempt default works around) simply tightens one level early, which
    costs nothing — the tightened level restarts from the same point.
    The FLOOR level has no next level to restart into, so it alone runs
    with the standard 2-attempt early-stop workaround.

    Contract: ``loss_fn`` is the tol_start-level objective — its baked-in
    CG tolerance must equal ``tol_start`` (the backend call site passes
    ``run_cfg.max_error`` for both).  Level 0 runs it unchanged so the
    plain-scipy compiled program (cheap CG tier) is reused; only tightened
    levels pay the loss_fn_tol compile.
    """
    total = 0
    remaining = num_steps
    levels = []
    fevals = 0
    penalty = 0
    vg_tol = _jit_value_and_grad(loss_fn_tol)
    me = float(tol_start)
    res = None
    first = True
    if tol_resume is not None:
        me = float(tol_resume)
        # loss_fn is only valid at tol_start (see contract above); a
        # resumed mid-schedule level must run the tol-parameterized program
        first = me >= float(tol_start) * (1.0 - 1e-12)
    while remaining > 0:
        at_floor = me <= tol_floor * (1.0 + 1e-12)
        if on_level is not None:
            on_level(me)
        # the floor level is the last: give it the 2-attempt early-stop
        # workaround the intermediate levels get from their next level
        att = max(attempts_per_level, 2) if at_floor else attempts_per_level
        if first:
            res = scipy_minimize(
                loss_fn, params, state, remaining, logger,
                attempts=att, feval_stats_fn=feval_stats_fn,
                data=data, sync_fn=sync_fn,
            )
        else:
            # model dtype (fp32 runs must not smuggle in an x64 scalar)
            me_arr = jnp.asarray(
                me, dtype=data[0].dtype if data else None)
            res = scipy_minimize(
                loss_fn_tol, params, state, remaining, logger,
                attempts=att, feval_stats_fn=feval_stats_fn,
                data=tuple(data) + (me_arr,), sync_fn=sync_fn, vg=vg_tol,
                _reset_timer=False,
            )
        total += res.num_iters
        remaining -= res.num_iters
        fevals += res.info["opt/num_fevals"]
        penalty += res.info["opt/penalty_fevals"]
        levels.append({
            "max_error": me,
            "nit": res.num_iters,
            "final_loss": res.final_loss,
            "attempts": res.info["opt/attempts"],
        })
        params, state = res.params, res.state
        if at_floor:
            break
        me = max(me * tol_factor, tol_floor)
        first = False

    return OptimizeResult(
        params=params,
        state=state,
        num_iters=total,
        final_loss=res.final_loss if res is not None else float("nan"),
        info={
            "opt/num_iters": total,
            "opt/num_fevals": fevals,
            "opt/penalty_fevals": penalty,
            "opt/levels": levels,
        },
    )


def adam_minimize(
    loss_fn: LossFn,
    params,
    state,
    num_steps: int,
    learning_rate: float = 0.01,
    logger: Optional[Logger] = None,
    data: tuple = (),
    sync_fn: Callable[[Any, Any], None] = None,
) -> OptimizeResult:
    """On-device Adam loop.

    Two jits per step, not one fused graph: the value_and_grad graph is the
    SAME program the scipy bridge compiles (one compilation serves both
    optimizers), and the optimizer update is a tiny second dispatch."""
    opt = optax.adam(learning_rate)
    opt_state = opt.init(params)
    vg = _jit_value_and_grad(loss_fn)

    @jax.jit
    def apply_update(params, opt_state, grads):
        grads = _fl.mask_untrainable_grads(params, grads)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    if logger is not None:
        logger.timer.reset()
        logger.timer.start()

    loss = np.inf
    for i in range(num_steps):
        (loss, state), grads = vg(params, state, *data)
        params, opt_state = apply_update(params, opt_state, grads)
        if logger is not None:
            if sync_fn is not None:
                sync_fn(params, state)
            logger(i)
    return OptimizeResult(params=params, state=state, num_iters=num_steps,
                         final_loss=float(loss))


def bounded_adam_minimize(
    step,
    optimizer,
    params,
    state,
    num_steps: int,
    logger: Optional[Logger] = None,
    feval_stats_fn: Callable[[Any], dict] = None,
    data: tuple = (),
    sync_fn: Callable[[Any, Any], None] = None,
) -> OptimizeResult:
    """Adam loop over a dispatch-bounded training step
    (parallel/dispatch.bounded_train_step, built by backend.Model.
    bounded_step): each optimizer step runs as a handful of short device
    dispatches instead of one feval-long dispatch, so full-depth CG
    survives per-dispatch wall-time limits at N>=1M (CLI
    --dispatch-bound)."""
    opt_state = optimizer.init(params)

    if logger is not None:
        logger.timer.reset()
        logger.timer.start()

    loss = np.inf
    for i in range(num_steps):
        v0 = getattr(state, "v", state)  # carry is CGLBAux after step 0
        params, opt_state, state, loss = step(params, opt_state, v0, *data)
        if logger is not None:
            if feval_stats_fn is not None:
                logger.log_for_feval(**feval_stats_fn(state))
            if sync_fn is not None:
                sync_fn(params, state)
            logger(i)
    return OptimizeResult(params=params, state=state, num_iters=num_steps,
                          final_loss=float(loss))


def native_lbfgs_minimize(
    loss_fn: LossFn,
    params,
    state,
    num_steps: int,
    logger: Optional[Logger] = None,
    history: int = 15,
    feval_stats_fn: Callable[[Any], dict] = None,
    data: tuple = (),
    sync_fn: Callable[[Any, Any], None] = None,
) -> OptimizeResult:
    """First-party C++ L-BFGS driver (native/lbfgs.cpp) with strong-Wolfe line
    search: replaces scipy's Fortran L-BFGS-B in the same host-driver role
    (device computes value+grad; host computes the O(n*history) update)."""
    from .native import NativeLBFGS

    vg = _jit_value_and_grad(loss_fn)
    unflatten = _fl.make_unflatten(params)
    x = _fl.flatten_trainable(params)
    opt = NativeLBFGS(len(x), history=history)

    holder = {"params": params, "state": state, "loss": np.inf}

    def evaluate(xv):
        p = unflatten(xv)
        (loss, new_state), grads = vg(p, holder["state"], *data)
        holder["params"] = p
        holder["state"] = new_state
        holder["loss"] = float(loss)
        if logger is not None and feval_stats_fn is not None:
            logger.log_for_feval(**feval_stats_fn(new_state))
        return float(loss), _fl.flatten_grads_like(p, grads)

    if logger is not None:
        logger.timer.reset()
        logger.timer.start()

    iters = 0
    max_fevals = max(num_steps * 12, num_steps + 10)
    fevals = 0
    while iters < num_steps and fevals < max_fevals:
        f, g = evaluate(x)
        fevals += 1
        status, x = opt.step(x, f, g)
        if status == NativeLBFGS.ACCEPTED:
            iters += 1
            if sync_fn is not None:
                sync_fn(holder["params"], holder["state"])
            if logger is not None:
                logger(iters)
        elif status in (NativeLBFGS.CONVERGED, NativeLBFGS.FAIL):
            break

    best_x = opt.best_x if iters > 0 else x
    holder["params"] = unflatten(best_x)
    (loss, new_state), _ = vg(holder["params"], holder["state"], *data)
    holder["state"] = new_state
    return OptimizeResult(
        params=holder["params"],
        state=holder["state"],
        num_iters=iters,
        final_loss=float(loss),
    )


def staged_gpr_optimize(
    loss_fn: LossFn,
    params,
    X,
    Y,
    num_steps: int,
    logger: Optional[Logger] = None,
    subset_size: int = 10_000,
    warmup_lbfgs_iters: int = 10,
    warmup_adam_iters: int = 10,
    adam_lr: float = 0.1,
    sync_fn: Callable[[Any, Any], None] = None,
) -> OptimizeResult:
    """The reference's exact-GP baseline training schedule (pytorch/
    interface.py:326-442): L-BFGS on a <=10k subset, a few Adam steps on the
    subset, then `num_steps` Adam steps on the full data.

    loss_fn has the standard (params, state, X, Y) signature; the data slice
    is swapped per phase through the `data` argument."""
    n = X.shape[0]
    ns = min(n, subset_size)
    sub_data = (X[:ns], Y[:ns])
    full_data = (X, Y)

    if logger is not None:
        logger.timer.reset()
        logger.timer.start()

    # phase 1: L-BFGS warmup on the subset (reference uses FullBatchLBFGS)
    res = lbfgs_minimize(loss_fn, params, None, warmup_lbfgs_iters,
                         logger=None, data=sub_data)
    params = res.params
    # phase 2: short Adam on the subset
    res = adam_minimize(loss_fn, params, None, warmup_adam_iters,
                        learning_rate=adam_lr, logger=None, data=sub_data)
    params = res.params
    # phase 3: Adam on the full data
    res = adam_minimize(loss_fn, params, None, num_steps,
                        learning_rate=adam_lr, logger=logger, data=full_data,
                        sync_fn=sync_fn)
    return res


def lbfgs_minimize(
    loss_fn: LossFn,
    params,
    state,
    num_steps: int,
    logger: Optional[Logger] = None,
    memory_size: int = 15,
    feval_stats_fn: Callable[[Any], dict] = None,
    data: tuple = (),
    sync_fn: Callable[[Any, Any], None] = None,
) -> OptimizeResult:
    """Pure-JAX L-BFGS with zoom linesearch (optax.lbfgs) — everything on device.

    The linesearch re-evaluates the loss at trial points; the CG warm start is
    updated from the accepted step's aux, replicating the reference's
    reuse-v-during-linesearch caching (pytorch/models.py:263-278) functionally.
    """
    opt = optax.lbfgs(memory_size=memory_size)

    @jax.jit
    def step(params, opt_state, carry, *data_):
        def f(p):
            return loss_fn(p, carry, *data_)[0]

        (loss, new_carry), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, carry, *data_
        )
        grads = _fl.mask_untrainable_grads(params, grads)
        updates, opt_state = opt.update(
            grads, opt_state, params, value=loss, grad=grads, value_fn=f
        )
        params = optax.apply_updates(params, updates)
        return params, opt_state, new_carry, loss

    opt_state = opt.init(params)
    if logger is not None:
        logger.timer.reset()
        logger.timer.start()

    loss = np.inf
    for i in range(num_steps):
        params, opt_state, state, loss = step(params, opt_state, state, *data)
        if logger is not None:
            if sync_fn is not None:
                sync_fn(params, state)
            if feval_stats_fn is not None:
                logger.log_for_feval(**feval_stats_fn(state))
            logger(i)
        if not np.isfinite(float(loss)):
            break
    return OptimizeResult(params=params, state=state, num_iters=num_steps,
                         final_loss=float(loss))
