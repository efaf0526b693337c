"""Single-backend facade: the reference's Backend ABC + interface layer, unified.

The reference exposes a Backend ABC with TF and Torch implementations selected
from a registry (cglb/backend/backend.py:34-115) and singledispatch interface
modules per backend (tensorflow/interface.py, pytorch/interface.py).  This
framework has exactly one backend — JAX/XLA — so those layers collapse
into: a ``Model`` wrapper (stateful convenience shell over the pure functional
core, holding params + data + the CG warm-start state) and a ``Jax`` backend
class with the same verbs (create_kernel/create_model/optimize/save/load/
metrics_fn), keeping CLI and user code shaped like the reference.
"""

from __future__ import annotations

import warnings
from typing import Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import config as _config
from . import configs as _cfgs
from .models import cglb as _cglb
from .models import gpr as _gpr
from .models import gpr_iterative as _itgp
from .models import sgpr as _sgpr
from .models.cglb import CGLBConfig as _RunCfg
from .models.gaussian import predict_log_density as _pld
from .ops import kernels as _k
from .utils import flatten as _fl
from .utils import metrics as _metrics
from .utils import serialization as _ser
from .utils import training as _training
from .utils.logging import Logger

__all__ = ["Model", "Jax", "BACKENDS", "get_backend"]

_CGLB_KINDS = {"cglb": "jensen", "cglbn2m": "n2m", "cglbnm2": "nm2"}


class Model:
    """Stateful shell over the functional core.

    Holds the parameter pytree, the training data, and — for CGLB models — the
    CG warm-start vector ``v0`` plus last CG stats (the reference keeps these as
    mutable model variables: tensorflow/models.py:47-56)."""

    # streaming matvec kicks in above this N when matvec mode is "auto"
    STREAMING_THRESHOLD = 8192

    def __init__(self, kind: str, params, data, run_cfg: Optional[_RunCfg] = None,
                 matvec: str = "auto", mesh=None, common_dtype: str = None,
                 dispatch_bound: int = 0):
        self.kind = kind
        self.params = params
        X, Y = data
        self.data = (jnp.asarray(X), jnp.asarray(Y))
        self.run_cfg = run_cfg
        self.matvec_mode = matvec
        # >0: on-device-optimizer training runs the dispatch-bounded step
        # (parallel/dispatch.py) with this many CG iterations per device
        # dispatch — full CG depth under per-dispatch wall-time limits
        # (preemption windows at N>=1M)
        self.dispatch_bound = int(dispatch_bound)
        # metric evaluations reuse the training precision policy: "mixed"
        # selects the df32/gram fast paths for elbo/upper at scale
        if common_dtype is None:
            common_dtype = (run_cfg.common_dtype if run_cfg is not None
                            else "mixed")
        self.common_dtype = common_dtype
        # multi-device: a 1-D data mesh — CGLB losses run column-sharded with
        # XLA collectives (parallel/sharded.py); every optimizer works
        # unchanged because only loss_fn's internals change
        self.mesh = mesh
        if mesh is not None:
            from .parallel.sharded import shard_data

            self.data = shard_data(mesh, *self.data)
        if kind in _CGLB_KINDS:
            self.v0 = _cglb.init_v0(
                self.data[0].shape[0], self.data[1].shape[1],
                dtype=self.data[0].dtype,
            )
            if run_cfg is not None and run_cfg.joint_optimization and (
                not run_cfg.vzero
            ):
                # --vjoint: v0 becomes a trainable leaf in the params pytree
                # (reference: tensorflow/models.py:44-46 trainable Parameter)
                from .struct import replace as _replace
                from .transforms import Param as _Param

                self.params = _replace(
                    self.params, v0=_Param(raw=self.v0, trainable=True)
                )
        else:
            self.v0 = None
        self.cg_steps = 0
        self.cg_residual_error = 0.0
        self._jit_cache: Dict[str, Callable] = {}

    # -- loss fn in the (params, carry, X, Y) -> (loss, carry) training form.
    # X/Y are explicit jit arguments, NOT closure constants: closed-over
    # concrete arrays get embedded into the compiled program as literals,
    # which breaks compilation once N is large.

    def loss_fn(self) -> _training.LossFn:
        kind = self.kind
        if kind == "gpr":
            def fn(params, state, X, Y):
                return -_gpr.log_marginal_likelihood(params, X, Y), state
        elif kind == "exactgp":
            # stochastic iterative objective: the PRNG key rides in the carry
            itcfg = _itgp.IterGPConfig()
            def fn(params, carry, X, Y):
                key = carry if carry is not None else jax.random.PRNGKey(0)
                key, sub = jax.random.split(key)
                loss, _ = _itgp.iterative_loss(params, X, Y, sub, itcfg)
                return loss, key
        elif kind == "sgpr":
            mixed = self.common_dtype == "mixed"

            def fn(params, state, X, Y):
                return -_sgpr.elbo(params, X, Y, mixed=mixed), state
        elif kind == "sgprn2m":
            def fn(params, state, X, Y):
                return -_sgpr.elbo_n2m(params, X, Y), state
        elif kind in _CGLB_KINDS:
            cfg = self.run_cfg
            joint = cfg.joint_optimization and not cfg.vzero
            if self.mesh is not None:
                from .parallel.sharded import sharded_cglb_loss

                mesh = self.mesh
                mode = self.matvec_mode
                if mode == "auto":
                    n = self.data[0].shape[0]
                    mode = ("streaming" if n >= self.STREAMING_THRESHOLD
                            else "dense")

                def fn(params, carry, X, Y):
                    v0 = carry.v if isinstance(carry, _cglb.CGLBAux) else carry
                    if joint and params.v0 is not None:
                        v0 = params.v0.value
                    return sharded_cglb_loss(params, X, Y, v0, cfg, mesh,
                                             matvec=mode)
            else:
                make_op = self._matvec_factory()

                def fn(params, carry, X, Y):
                    # carry is either the raw v0 array or last feval's CGLBAux
                    v0 = carry.v if isinstance(carry, _cglb.CGLBAux) else carry
                    if joint and params.v0 is not None:
                        # trainable v: read from the params pytree so gradients
                        # flow into it through the bound assembly
                        v0 = params.v0.value
                    matvec = None
                    if make_op is not None:
                        matvec = make_op(params.kernel, X,
                                         params.noise_variance.value)
                    return _cglb.loss(params, X, Y, v0, cfg, matvec=matvec)
        else:
            raise NotImplementedError(kind)
        return fn

    def loss_fn_tol(self) -> _training.LossFn:
        """CGLB loss with the CG stopping tolerance as a TRACED argument:
        ``fn(params, carry, X, Y, max_error) -> (loss, aux)``.

        One compiled program serves every tolerance level of the adaptive
        schedule (utils/training.scipy_tol_minimize; ``-o scipy_tol``)."""
        if self.kind not in _CGLB_KINDS:
            raise ValueError("adaptive CG tolerance requires a CGLB model")
        cfg = self.run_cfg
        joint = cfg.joint_optimization and not cfg.vzero
        if self.mesh is not None:
            # sharded variant: same traced-tolerance threading
            from .parallel.sharded import sharded_cglb_loss

            mesh = self.mesh
            mode = self.matvec_mode
            if mode == "auto":
                n = self.data[0].shape[0]
                mode = ("streaming" if n >= self.STREAMING_THRESHOLD
                        else "dense")

            def fn(params, carry, X, Y, max_error):
                v0 = carry.v if isinstance(carry, _cglb.CGLBAux) else carry
                if joint and params.v0 is not None:
                    v0 = params.v0.value
                return sharded_cglb_loss(params, X, Y, v0, cfg, mesh,
                                         matvec=mode, max_error=max_error)

            return fn
        make_op = self._matvec_factory()

        def fn(params, carry, X, Y, max_error):
            v0 = carry.v if isinstance(carry, _cglb.CGLBAux) else carry
            if joint and params.v0 is not None:
                v0 = params.v0.value
            matvec = None
            if make_op is not None:
                matvec = make_op(params.kernel, X,
                                 params.noise_variance.value)
            return _cglb.loss(params, X, Y, v0, cfg, matvec=matvec,
                              max_error=max_error)

        return fn

    def bounded_step(self, optimizer):
        """Dispatch-bounded training step for this model's configuration
        (parallel/dispatch.bounded_train_step): same math as the monolithic
        step, cut into <= self.dispatch_bound CG iterations per device
        dispatch.  CGLB kinds with an internal CG solve only."""
        if self.kind not in _CGLB_KINDS or self.run_cfg.v_is_external:
            raise ValueError("dispatch-bounded training needs a CGLB model "
                             "with the internal CG solve")
        from .parallel.dispatch import bounded_train_step

        mode = self.matvec_mode
        if mode == "auto":
            n = self.data[0].shape[0]
            mode = ("streaming" if n >= self.STREAMING_THRESHOLD
                    else "dense")
        return bounded_train_step(self.run_cfg, optimizer, mesh=self.mesh,
                                  matvec=mode,
                                  iters_per_dispatch=self.dispatch_bound)

    def _matvec_factory(self):
        """None -> dense K materialization (reference TF backend behavior);
        else the (kernel, X, sigma_sq) -> matvec builder of the streaming
        Pallas operator (the KeOps replacement; reference --keops)."""
        mode = self.matvec_mode
        n = self.data[0].shape[0]
        if mode == "dense":
            return None
        if mode == "auto" and n < self.STREAMING_THRESHOLD:
            return None
        from .ops import matvec_pallas as _mvp

        return _mvp.make_streaming_operator

    def _carry_in(self):
        if self.kind in _CGLB_KINDS:
            return self.v0
        if self.kind == "exactgp":
            if not hasattr(self, "_key") or self._key is None:
                self._key = jax.random.PRNGKey(_config.settings.seed)
            return self._key
        return None

    def _carry_out(self, state):
        if self.kind == "exactgp" and state is not None:
            self._key = state
            return
        if self.kind in _CGLB_KINDS and state is not None:
            if isinstance(state, _cglb.CGLBAux):
                self.v0 = state.v
                self.cg_steps = int(state.cg_steps)
                self.cg_residual_error = float(state.cg_residual_error)
            else:
                self.v0 = state
            pv = getattr(self.params, "v0", None)
            if pv is not None:
                # joint mode: the optimized v lives in the params pytree
                self.v0 = pv.value

    # -- metric evaluations (jitted lazily, cached per model instance) --

    def _jit(self, name: str, fn: Callable) -> Callable:
        if name not in self._jit_cache:
            self._jit_cache[name] = jax.jit(fn)
        return self._jit_cache[name]

    def loss_value(self) -> float:
        fn = self._jit("loss", self.loss_fn())
        loss, state = fn(self.params, self._carry_in(), *self.data)
        self._carry_out(state)
        return float(loss)

    def elbo(self) -> float:
        mixed = self.common_dtype == "mixed"
        fn = self._jit("elbo",
                       lambda p, X, Y: _sgpr.elbo(p, X, Y, mixed=mixed))
        return float(fn(self.params, *self.data))

    def upper_bound(self) -> float:
        mixed = self.common_dtype == "mixed"
        fn = self._jit(
            "upper", lambda p, X, Y: _sgpr.upper_bound(p, X, Y, mixed=mixed)
        )
        return float(fn(self.params, *self.data))

    def lml(self) -> float:
        fn = self._jit(
            "lml", lambda p, X, Y: _gpr.log_marginal_likelihood(p, X, Y)
        )
        return float(fn(self.params, *self.data))

    def predict_f(self, Xnew, cg_tolerance: Optional[float] = 1e-3):
        Xnew = jnp.asarray(Xnew)
        if self.kind == "exactgp":
            fn = self._jit(
                "predict",
                lambda p, X, Y, xs: _itgp.predict_f_iterative(p, X, Y, xs),
            )
            return fn(self.params, *self.data, Xnew)
        if self.kind == "gpr":
            fn = self._jit(
                "predict", lambda p, X, Y, xs: _gpr.predict_f(p, X, Y, xs)
            )
            return fn(self.params, *self.data, Xnew)
        if self.kind in ("sgpr", "sgprn2m"):
            fn = self._jit(
                "predict", lambda p, X, Y, xs: _sgpr.predict_f(p, X, Y, xs)
            )
            return fn(self.params, *self.data, Xnew)
        cfg = self.run_cfg
        make_op = self._matvec_factory()
        key = f"predict_tol{cg_tolerance}"
        joint = cfg.joint_optimization and not cfg.vzero

        mixed = self.common_dtype == "mixed"

        def _predict(p, v0, X, Y, xs):
            if joint and p.v0 is not None:
                v0 = p.v0.value  # the jointly-optimized v
            matvec = None
            cross_matvec = None
            if make_op is not None:
                from .ops import matvec_pallas as _mvp

                matvec = make_op(p.kernel, X, p.noise_variance.value)
                cross_matvec = lambda v: _mvp.kernel_cross_matvec(
                    p.kernel, X, xs, v
                )
            # mixed follows the training setting: the non-mixed path
            # materializes the [M, N] fp64 trisolve
            return _cglb.predict_f(
                p, X, Y, v0, xs, cfg, cg_tolerance=cg_tolerance, matvec=matvec,
                cross_matvec=cross_matvec, mixed=mixed,
            )

        fn = self._jit(key, _predict)
        return fn(self.params, self.v0, *self.data, Xnew)

    def _default_predict_batch(self) -> int:
        """Memory-aware prediction batch: the per-batch Kus build makes
        ~[8, M, B] f32 temporaries (df32 split matmul), so B scales as 1/M,
        targeting ~1 GiB per temp buffer — conservative for an 80 GB card;
        re-deriving it from measured peak memory is open work (ROADMAP.md).
        Reference batching role: pytorch/interface.py:580,637."""
        m = int(getattr(self.params, "num_inducing", 0) or 0)
        if m <= 0:
            return 100_000
        return max(4096, min(100_000, (1 << 30) // (32 * m)))

    def predict_f_batched(self, Xnew, batch_size: Optional[int] = None,
                          cg_tolerance: Optional[float] = 1e-3):
        """Batched posterior prediction (reference batches at 1e5/1e6 rows:
        pytorch/interface.py:580,637).  Pads the last batch so one compiled
        program serves every batch.  batch_size=None uses the memory-aware
        default (see _default_predict_batch).

        PredictCG-cache parity (reference pytorch/models.py:289-354): for
        CGLB/SGPR models the batch-independent work — common terms and the
        CG solve — runs EXACTLY ONCE per call and is reused by every batch;
        only the O(S) per-batch projections repeat."""
        if batch_size is None:
            batch_size = self._default_predict_batch()
        Xnew = jnp.asarray(Xnew)
        n = Xnew.shape[0]
        if n <= batch_size:
            return self.predict_f(Xnew, cg_tolerance=cg_tolerance)

        batch_fn = None
        if self.kind in _CGLB_KINDS:
            cfg = self.run_cfg
            make_op = self._matvec_factory()
            mixed = self.common_dtype == "mixed"
            joint = cfg.joint_optimization and not cfg.vzero

            def _prep(p, v0, X, Y):
                if joint and p.v0 is not None:
                    v0 = p.v0.value
                matvec = None
                if make_op is not None:
                    matvec = make_op(p.kernel, X, p.noise_variance.value)
                return _cglb.predict_prepare(
                    p, X, Y, v0, cfg, cg_tolerance=cg_tolerance,
                    matvec=matvec, mixed=mixed,
                )

            def _batch(p, cache, X, xs):
                cross_matvec = None
                if make_op is not None:
                    from .ops import matvec_pallas as _mvp

                    cross_matvec = lambda v: _mvp.kernel_cross_matvec(
                        p.kernel, X, xs, v
                    )
                return _cglb.predict_from_cache(p, cache, X, xs,
                                                cross_matvec=cross_matvec)

            prep_fn = self._jit(f"predict_prep_tol{cg_tolerance}", _prep)
            cache = prep_fn(self.params, self.v0, *self.data)
            fn = self._jit("predict_batch", _batch)
            batch_fn = lambda chunk: fn(self.params, cache, self.data[0],
                                        chunk)
        elif self.kind in ("sgpr", "sgprn2m"):
            prep_fn = self._jit(
                "predict_prep", lambda p, X, Y: _sgpr.predict_prepare(p, X, Y)
            )
            cache = prep_fn(self.params, *self.data)
            fn = self._jit(
                "predict_batch",
                lambda p, cache, xs: _sgpr.predict_from_cache(p, cache, xs),
            )
            batch_fn = lambda chunk: fn(self.params, cache, chunk)

        means, vars_ = [], []
        for start in range(0, n, batch_size):
            chunk = Xnew[start : start + batch_size]
            pad = batch_size - chunk.shape[0]
            if pad:
                chunk = jnp.pad(chunk, ((0, pad), (0, 0)), mode="edge")
            if batch_fn is not None:
                m, v = batch_fn(chunk)
            else:
                m, v = self.predict_f(chunk, cg_tolerance=cg_tolerance)
            if pad:
                m, v = m[:-pad], v[:-pad]
            means.append(m)
            vars_.append(v)
        return jnp.concatenate(means, 0), jnp.concatenate(vars_, 0)

    def predict_log_density(self, data, cg_tolerance: float = 1e-6):
        Xs, Ys = (jnp.asarray(a) for a in data)
        f_mean, f_var = self.predict_f(
            Xs, cg_tolerance=cg_tolerance if self.kind in _CGLB_KINDS else None
        ) if self.kind in _CGLB_KINDS else self.predict_f(Xs)
        return _pld(f_mean, f_var, self.params.noise_variance.value, Ys)

    def parameter_dict(self) -> Dict[str, np.ndarray]:
        return _fl.parameter_dict(self.params)


class Jax:
    """Backend facade with the reference Backend ABC's verbs
    (reference: cglb/backend/backend.py:34-91)."""

    name = "jax"
    matvec_mode = "auto"  # "auto" | "dense" | "streaming" (CLI --matvec)
    mesh_size = 0  # 0/1 = single device; >1 or -1 ("all") = 1-D data mesh
    # "mixed" (default: df32 kernel profile + fp64 solves, fp64-grade; see
    # models/sgpr._kuf_block_df32) | "float64" (all-fp64, CLI --common-dtype)
    common_dtype = "mixed"
    # CG iteration cap (reference hardcodes 100, tensorflow/models.py:36-38;
    # CLI --max-cg-iters exposes it — at N>=1M each CG iteration is a multi-
    # second streaming matvec, so bounding it bounds per-dispatch time)
    max_cg_iters = 100
    # >0: adam-family training drives the dispatch-bounded step with this
    # many CG iterations per dispatch (CLI --dispatch-bound; full CG depth
    # under per-dispatch watchdogs — parallel/dispatch.py)
    dispatch_bound = 0

    @classmethod
    def configure_backend(cls, **kwargs):
        if "matvec" in kwargs and kwargs["matvec"]:
            cls.matvec_mode = kwargs["matvec"]
        if "common_dtype" in kwargs and kwargs["common_dtype"]:
            cls.common_dtype = kwargs["common_dtype"]
        if "mesh" in kwargs and kwargs["mesh"] is not None:
            cls.mesh_size = int(kwargs["mesh"])
        if kwargs.get("max_cg_iters"):
            cls.max_cg_iters = int(kwargs["max_cg_iters"])
        if kwargs.get("dispatch_bound") is not None:
            # 0 must RESET (class attr persists across CLI invocations in
            # one process, e.g. the sweep runner's in-process fallbacks)
            cls.dispatch_bound = int(kwargs["dispatch_bound"])

    @classmethod
    def _make_mesh(cls):
        """1-D data mesh from the configured size (None = single device).

        -1 means all visible devices; sizes beyond the device count raise
        (jax would otherwise silently truncate)."""
        size = cls.mesh_size
        if not size or size == 1:
            return None
        from .parallel.mesh import data_mesh, maybe_initialize_distributed

        # multi-host pods: bootstrap jax.distributed (env-gated no-op
        # otherwise) BEFORE counting devices, so --mesh all spans every host
        maybe_initialize_distributed()
        avail = len(jax.devices())
        if size == -1:
            size = avail
        if size > avail:
            raise ValueError(
                f"--mesh {size} requested but only {avail} devices visible"
            )
        return data_mesh(size)

    @classmethod
    def set_default_float(cls, float_type: str):
        _config.set_default_float(float_type)

    @classmethod
    def set_default_jitter(cls, value):
        _config.set_default_jitter(value)

    @classmethod
    def set_seed(cls, seed: int):
        _config.set_default_seed(seed)

    # -- factories --

    @classmethod
    def create_kernel(cls, kernel_cfg: _cfgs.KernelConfig, data):
        p = kernel_cfg.params(data)
        name = (
            "Matern32"
            if isinstance(kernel_cfg, _cfgs.Matern32Config)
            else "SquaredExponential"
        )
        return _k.make_kernel(
            name, data[0].shape[-1], variance=p["variance"],
            lengthscales=p["lengthscales"],
        )

    @classmethod
    def create_model(cls, model_cfg: _cfgs.ModelConfig, data, seed: int = None
                     ) -> Model:
        seed = seed if seed is not None else _config.settings.seed
        dtype = _config.default_float()
        X = np.asarray(data[0], dtype=dtype)
        Y = np.asarray(data[1], dtype=dtype)
        kernel = cls.create_kernel(model_cfg.kernel, (X, Y))
        p = model_cfg.params((X, Y))
        if isinstance(model_cfg, _cfgs.GPRConfig):
            params = _gpr.GPRParams.create(
                kernel, noise_variance=p["noise_variance"],
                output_dim=Y.shape[1], dtype=dtype,
            )
            kind = (
                "exactgp" if isinstance(model_cfg, _cfgs.ExactGPConfig)
                else "gpr"
            )
            return Model(kind, params, (X, Y), matvec=cls.matvec_mode,
                         mesh=cls._make_mesh(), common_dtype=cls.common_dtype)

        Z = p["inducing_variable"](kernel, seed=seed)
        params = _sgpr.SGPRParams.create(
            kernel, Z, noise_variance=p["noise_variance"],
            output_dim=Y.shape[1], dtype=dtype,
        )
        if isinstance(model_cfg, _cfgs.SGPRN2MConfig):
            return Model("sgprn2m", params, (X, Y), matvec=cls.matvec_mode,
                         mesh=cls._make_mesh(), common_dtype=cls.common_dtype)
        if isinstance(model_cfg, _cfgs.CGLBConfig):
            kind = {
                _cfgs.CGLBN2MConfig: "cglbn2m",
                _cfgs.CGLBNM2Config: "cglbnm2",
            }.get(type(model_cfg), "cglb")
            run_cfg = _RunCfg(
                max_error=p["max_error"],
                joint_optimization=p["joint_optimization"],
                vzero=p["vzero"],
                logdet_variant=_CGLB_KINDS[kind],
                common_dtype=cls.common_dtype,
                max_cg_iters=cls.max_cg_iters,
            )
            return Model(kind, params, (X, Y), run_cfg,
                         matvec=cls.matvec_mode, mesh=cls._make_mesh(),
                         common_dtype=cls.common_dtype,
                         dispatch_bound=cls.dispatch_bound)
        return Model("sgpr", params, (X, Y), matvec=cls.matvec_mode,
                     mesh=cls._make_mesh(), common_dtype=cls.common_dtype)

    # -- persistence --

    @classmethod
    def model_parameters(cls, model: Model) -> Dict[str, np.ndarray]:
        return model.parameter_dict()

    @classmethod
    def save(cls, model: Model, logdir):
        _ser.save_model_params(model.parameter_dict(), logdir)

    @classmethod
    def save_checkpoint(cls, model: Model, logdir, extra: Dict = None):
        """Full-state checkpoint (params + CG warm start) — resume without
        the cold-start CG cost the reference pays (SURVEY.md 5.4)."""
        _ser.save_checkpoint(
            logdir,
            model.parameter_dict(),
            v0=model.v0,
            extra={"kind": model.kind, **(extra or {})},
        )

    @classmethod
    def load_checkpoint(cls, model: Model, filepath) -> Model:
        state = _ser.load_checkpoint(filepath)
        have = set(model.parameter_dict().keys())
        model.params = _fl.assign_parameters(
            model.params,
            {k: v for k, v in state["params"].items() if k in have},
        )
        if state.get("v0") is not None and model.v0 is not None:
            model.v0 = jnp.asarray(state["v0"], dtype=model.v0.dtype)
        # resume metadata (e.g. iters_done) for callers that track budget
        model.last_checkpoint_extra = state.get("extra", {}) or {}
        model._jit_cache.clear()
        return model

    @classmethod
    def load(cls, model: Model, filepath) -> Model:
        loaded = _ser.load_model_params(filepath)
        have = set(model.parameter_dict().keys())
        extra = set(loaded.keys()) - have
        if extra:
            warnings.warn(f"Ignoring unknown parameters: {sorted(extra)}")
        model.params = _fl.assign_parameters(
            model.params, {k: v for k, v in loaded.items() if k in have}
        )
        model._jit_cache.clear()
        return model

    # -- training --

    @classmethod
    def optimize(cls, model: Model, datasets, num_steps: int,
                 logger: Optional[Logger] = None, optimizer: str = None,
                 checkpoint_every: int = 0, checkpoint_dir=None,
                 checkpoint_offset: int = 0, resume_extra: Dict = None):
        """checkpoint_every > 0 (with checkpoint_dir): write a full-state
        checkpoint every that-many accepted iterations, so a killed
        protocol-length run resumes (CLI --ckpt-every/--resume) instead of
        restarting — failure recovery the reference lacks (SURVEY.md 5.4).
        checkpoint_offset: iterations already done before this call (resume
        bookkeeping; recorded as extra["iters_done"]).
        resume_extra: the loaded checkpoint's extra dict — optimizer state
        that must survive a kill (scipy_tol's live tolerance level)."""
        loss_fn = model.loss_fn()
        carry = model._carry_in()
        live_extra: Dict = {}

        def feval_stats(state):
            if isinstance(state, _cglb.CGLBAux):
                return {
                    "cg/steps": int(state.cg_steps),
                    "cg/error": float(state.cg_residual_error),
                }
            return {}

        stats_fn = feval_stats if model.kind in _CGLB_KINDS else None
        data = model.data

        _iters = {"n": checkpoint_offset}

        def sync_fn(params, state):
            # publish the live iterate so the Logger's metric closures (which
            # read from the model object) evaluate at CURRENT parameters —
            # matches the reference, where params are assigned into the live
            # model on every feval (pytorch/optimizer.py:42-46, gpflow Scipy)
            model.params = params
            model._carry_out(state)
            if checkpoint_every and checkpoint_dir is not None:
                _iters["n"] += 1
                if _iters["n"] % checkpoint_every == 0:
                    cls.save_checkpoint(
                        model, checkpoint_dir,
                        extra={"iters_done": _iters["n"], **live_extra})

        if optimizer is None or optimizer == "scipy":
            res = _training.scipy_minimize(
                loss_fn, model.params, carry, num_steps, logger,
                feval_stats_fn=stats_fn, data=data, sync_fn=sync_fn,
            )
        elif optimizer == "scipy4":
            # torch-backend schedule: 4 restarts, inducing points frozen
            # after the 2nd (reference: pytorch/interface.py:507-543)
            res = _training.scipy_minimize(
                loss_fn, model.params, carry, num_steps, logger,
                attempts=4, freeze_inducing_after=2,
                feval_stats_fn=stats_fn, data=data, sync_fn=sync_fn,
            )
        elif optimizer == "scipy_tol":
            if model.kind not in _CGLB_KINDS or model.run_cfg.v_is_external:
                # no CG in the loss (non-CGLB, or vzero/vjoint where v is
                # external): the tolerance has no effect — plain bridge
                res = _training.scipy_minimize(
                    loss_fn, model.params, carry, num_steps, logger,
                    feval_stats_fn=stats_fn, data=data, sync_fn=sync_fn,
                )
            else:
                # adaptive CG-tolerance schedule (first-party; no reference
                # equivalent): tighten max_error 10x each time scipy
                # converges with budget left — fixed-tolerance runs stall
                # once line-search progress falls below the CG-slack
                # objective jitter
                res = _training.scipy_tol_minimize(
                    loss_fn, model.loss_fn_tol(), model.params, carry,
                    num_steps, logger, tol_start=model.run_cfg.max_error,
                    feval_stats_fn=stats_fn, data=data, sync_fn=sync_fn,
                    # live level rides into every checkpoint; a resumed run
                    # re-enters the schedule where the killed one died
                    on_level=lambda m: live_extra.update(max_error=m),
                    tol_resume=(resume_extra or {}).get("max_error"),
                )
        elif optimizer == "lbfgs":
            res = _training.lbfgs_minimize(
                loss_fn, model.params, carry, num_steps, logger,
                feval_stats_fn=stats_fn, data=data, sync_fn=sync_fn,
            )
        elif optimizer == "lbfgs_native":
            res = _training.native_lbfgs_minimize(
                loss_fn, model.params, carry, num_steps, logger,
                feval_stats_fn=stats_fn, data=data, sync_fn=sync_fn,
            )
        elif optimizer == "staged" and model.kind in ("gpr", "exactgp"):
            # reference exact-GP baseline schedule (pytorch/interface.py:
            # 326-442) — the schedule the reference applies to its
            # iterative ("exactgp") arm; dense gpr accepts it too
            X, Y = model.data
            res = _training.staged_gpr_optimize(
                loss_fn, model.params, X, Y, num_steps, logger,
                sync_fn=sync_fn,
            )
        elif optimizer.startswith("adam"):
            lr = float(optimizer.split("_", maxsplit=1)[1])
            if model.kind in ("gpr", "exactgp"):
                # reference parity: the torch backend routes EVERY adam_*
                # request on a GPR model through the staged exact-GP
                # schedule with that lr (pytorch/interface.py:326-330 —
                # `adam_lr = float(optimizer.split("_")[1])`); `-o staged`
                # above is the alias with the schedule's default lr
                X, Y = model.data
                res = _training.staged_gpr_optimize(
                    loss_fn, model.params, X, Y, num_steps, logger,
                    adam_lr=lr, sync_fn=sync_fn,
                )
            elif (model.dispatch_bound > 0 and model.kind in _CGLB_KINDS
                    and not model.run_cfg.v_is_external):
                import optax

                opt = optax.adam(lr)
                res = _training.bounded_adam_minimize(
                    model.bounded_step(opt), opt, model.params, carry,
                    num_steps, logger, feval_stats_fn=stats_fn, data=data,
                    sync_fn=sync_fn,
                )
            else:
                res = _training.adam_minimize(
                    loss_fn, model.params, carry, num_steps, lr, logger,
                    data=data, sync_fn=sync_fn,
                )
        else:
            raise NotImplementedError(optimizer)
        model.params = res.params
        model._carry_out(res.state)
        model._jit_cache.clear()
        return res

    # -- metrics --

    @classmethod
    def metrics_fn(cls, model: Model, datasets) -> Callable[[], Dict[str, float]]:
        train, test = datasets
        Xtr, Ytr = (jnp.asarray(a) for a in train)
        Xte, Yte = (jnp.asarray(a) for a in test)

        def err_and_logdensity():
            X = jnp.concatenate([Xtr, Xte], axis=0)
            Y = jnp.concatenate([Ytr, Yte], axis=0)
            mean, var = model.predict_f_batched(X)
            err = Y - mean
            logden = _pld(mean, var, model.params.noise_variance.value, Y)
            n = Xtr.shape[0]
            return (err[:n], err[n:]), (logden[:n], logden[n:])

        rmse_lpd = _metrics.rmse_and_lpd_fn(err_and_logdensity)

        if model.kind == "gpr":
            def core():
                lml = model.lml()
                return {"lml": lml, "loss": -lml}
        elif model.kind == "exactgp":
            def core():
                loss = model.loss_value()
                return {"lml": -loss, "loss": loss}
        elif model.kind in ("sgpr", "sgprn2m"):
            def core():
                # loss = -elbo (variant-specific: sgprn2m reports its own bound
                # as `elbo`, matching the reference's overridden elbo()).
                loss = model.loss_value()
                return {
                    "elbo": -loss,
                    "titsias_upper_bound": model.upper_bound(),
                    "loss": loss,
                }
        else:
            def core():
                cg_lb = -model.loss_value()
                return {
                    "elbo": model.elbo(),
                    "titsias_upper_bound": model.upper_bound(),
                    "cg_lower_bound": cg_lb,
                    "loss": -cg_lb,
                    "cg/steps": model.cg_steps,
                    "cg/error": model.cg_residual_error,
                }

        return lambda: _metrics.call_metric_fns(core, rmse_lpd)


BACKENDS = {"jax": Jax, "xla": Jax}


def get_backend(name: str):
    if name not in BACKENDS:
        raise KeyError(f"Unknown backend {name!r}; available: {list(BACKENDS)}")
    return BACKENDS[name]
