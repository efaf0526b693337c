"""Dispatch-bounded CGLB training step: host-orchestrated, watchdog-safe.

The monolithic training step (models/cglb.loss under one jit, or
parallel/sharded.sharded_train_step) runs the ENTIRE feval — common terms,
a full preconditioned-CG solve, bound assembly, backward, optimizer update —
as ONE device dispatch.  At houseelectric-class N (>=1M rows) each CG
iteration is a multi-second streaming matvec, so one dispatch can run many
minutes.  Environments that bound device-dispatch wall time (workers with
liveness watchdogs, preemptible fleets where a long dispatch widens the
non-checkpointable window) kill it.

This module splits the SAME step — same math, same iterate sequence — into
host-orchestrated dispatches, each individually short:

    init      1 dispatch   common terms, preconditioner, CG state (1 matvec)
    advance   k dispatches up to ``iters_per_dispatch`` CG iterations each,
                           resuming the exact monolithic iterate sequence
                           (ops/cg.cg_advance carries i/v/r/p/rz across cuts,
                           so restart phase and stopping rule are identical)
    finalize  1 dispatch   value_and_grad of the bound at the solved v
                           (sound because CGLB detaches v: the bound is valid
                           and differentiable for ANY fixed v — models/cglb
                           stop-gradients the CG result even monolithically,
                           so splitting here changes NOTHING about gradients)
    update    folded into finalize (optax apply)

Between dispatches every tensor stays device-resident; the host sees only
scalar CG stats (one sync per chunk, the same sync cadence as the
reference's torch host-loop CG, cglb/backend/pytorch/conjugate_gradient.py:
41-86 — but per CHUNK, not per iteration).  Extra cost vs monolithic: the
common terms forward runs twice (init + inside finalize's value_and_grad);
at large N the CG matvecs dominate and the overhead measures <15%.

A second dividend: the CG carry is an ordinary pytree, so a run can be
checkpointed MID-SOLVE between dispatches — the failure-recovery window
shrinks from "one whole feval" to "one CG chunk".
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .. import struct as _struct
from ..models import cglb as _cglb
from ..models import sgpr as _sgpr
from ..ops import cg as _cg
from ..ops import operators as _op
from ..utils import flatten as _fl
from .mesh import DATA_AXIS

__all__ = ["bounded_train_step"]


def bounded_train_step(cfg: _cglb.CGLBConfig, optimizer, *, mesh=None,
                       matvec: str = "streaming", block: int = None,
                       iters_per_dispatch: int = 8):
    """Build ``step(params, opt_state, v0, X, Y) -> (params, opt_state,
    CGLBAux, loss)`` — drop-in for ``sharded_train_step``'s compiled step,
    but cut into bounded dispatches (see module docstring).

    mesh=None runs the single-device path (models/cglb.loss semantics);
    with a mesh it mirrors parallel/sharded.sharded_cglb_loss.  block: the
    streaming kernel's block size (None = its default).
    """
    import optax

    if cfg.v_is_external:
        raise ValueError("bounded_train_step needs the CG path "
                         "(vzero/joint configs have no solve to bound)")
    mixed = cfg.common_dtype == "mixed"
    gram = mixed and cfg.logdet_variant != "n2m"
    a_dtype = jnp.dtype(cfg.precond_dtype)
    blocks = () if block is None else (block, block)
    cfg_fixed_v = _struct.replace(cfg, vzero=True)

    def _build_matvec(params, X):
        """The (K + s2 I) operator for this params/X, traced."""
        sigma_sq = params.noise_variance.value
        if matvec == "streaming":
            if mesh is None:
                from ..ops import matvec_pallas as _mvp

                return _mvp.make_streaming_operator(
                    params.kernel, X, sigma_sq, *blocks)
            from . import streaming as _streaming

            return _streaming.make_sharded_streaming_operator(
                mesh, params.kernel, X, sigma_sq, *blocks)
        if matvec == "dense":
            if mesh is None:
                return _op.make_dense_operator(params.kernel, X, sigma_sq)
            from .sharded import make_sharded_operator

            return make_sharded_operator(mesh, params.kernel, X, sigma_sq)
        raise ValueError(f"unknown matvec mode {matvec!r}")

    def _precond_err(params, X, Y):
        """Preconditioner + rhs, traced — the exact construction the
        monolithic loss performs (models/cglb.bound -> _make_precond /
        parallel/sharded.sharded_cglb_loss)."""
        N = X.shape[0]
        scale = 1 if mesh is None else mesh.shape[DATA_AXIS]
        remat = (N * params.num_inducing
                 > _sgpr.REMAT_THRESHOLD_ELEMENTS * scale)
        from .. import config as _config

        jitter = _config.default_jitter()
        if mesh is None:
            ct = _sgpr.common_terms(params, X, jitter, mixed=mixed,
                                    gram=gram, a_dtype=a_dtype, remat=remat)
        else:
            from .sharded import _sharded_common_terms

            ct = _sharded_common_terms(mesh, params, X, jitter, mixed=mixed,
                                       gram=gram, a_dtype=a_dtype,
                                       remat=remat)
        P = _cglb._make_precond(ct, params.noise_variance.value, cfg,
                                consistent_ct=not gram)
        err_t = (Y - _cglb.mean_apply(params.mean, X)).T
        return P, err_t

    @jax.jit
    def _init(params, X, Y, v0):
        P, err_t = _precond_err(params, X, Y)
        carry = _cg.cg_init(_build_matvec(params, X), err_t, v0, P)
        return carry, P, err_t

    @jax.jit
    def _advance(params, X, carry, P, err_t, max_error, cap):
        return _cg.cg_advance(_build_matvec(params, X), err_t, P, carry,
                              max_error, cap, cfg.restart_cg_iters)

    @partial(jax.jit, donate_argnums=(0, 1))
    def _finalize(params, opt_state, X, Y, v):
        def loss_fn(p):
            if mesh is None:
                return _cglb.loss(p, X, Y, v, cfg_fixed_v,
                                  matvec=_build_matvec(p, X))
            from .sharded import sharded_cglb_loss

            return sharded_cglb_loss(p, X, Y, v, cfg_fixed_v, mesh,
                                     matvec=matvec, block=block)

        (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        grads = _fl.mask_untrainable_grads(params, grads)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    def step(params, opt_state, v0, X, Y,
             max_error: Optional[float] = None, chunk_callback=None):
        me = np.asarray(cfg.max_error if max_error is None else max_error,
                        dtype=np.dtype(Y.dtype))
        carry, P, err_t = _init(params, X, Y, v0)
        steps_done = 0
        while True:
            cap = min(cfg.max_cg_iters,
                      steps_done + int(iters_per_dispatch))
            carry, stats = _advance(params, X, carry, P, err_t, me,
                                    np.int32(cap))
            steps_done = int(stats.steps)  # absolute count; host sync point
            if chunk_callback is not None:
                # per-dispatch observability: called at the host sync point
                # after each bounded CG chunk (profiling / liveness pings)
                chunk_callback(steps_done, stats)
            if steps_done < cap or steps_done >= cfg.max_cg_iters:
                break
        v = carry.state.v
        # Free the preconditioner before the finalize dispatch: P.A is the
        # one [M, N]-sized buffer this driver keeps alive across dispatches
        # (4 GiB at N=1M/M=1024 f32), and finalize's common-terms rebuild
        # peaks device memory on its own — holding both can exceed a card
        # that the monolithic step (where XLA frees A before the backward)
        # fits.
        for leaf in jax.tree_util.tree_leaves(P):
            if hasattr(leaf, "delete"):
                leaf.delete()
        new_params, opt_state, loss = _finalize(params, opt_state, X, Y, v)
        aux = _cglb.CGLBAux(v=v, cg_steps=jnp.asarray(steps_done, jnp.int32),
                            cg_residual_error=stats.residual_error)
        return new_params, opt_state, aux, loss

    return step
